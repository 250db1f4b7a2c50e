#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``).

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, in order; any failure exits nonzero:

1. environment: the card's name and power limit, torch/CUDA versions,
   TF32 off for matmul and cuDNN;
2. build: every hand-written kernel compiled from ``mxnet_tpu_torch/csrc``
   with nvcc for sm_90a;
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes and at ragged ones, with the tolerance each
   case states; ``fused_fc_epilogue`` with x and W in float16 and in
   bfloat16 (``FC_HALF_CASES``: fc6 and fc7 at M 8, 1 and 33, every act,
   no bias, a ragged K and N, and K % 8 != 0 and a 2-byte-aligned view on
   the SIMT route; ``kernel check half fc`` lines), each on the route the
   case names (``fc_route``: the launcher's workspace, 786,432 bytes at
   fc6 and fc7), within one unit in the last place of the float32
   instance on the upcast inputs, rounded, and of the plain version, two
   calls bitwise equal, and int8 codes from 16-bit operands equal to the
   plain version's; kernel, plain version and one library call timed;
   then
   the int8 route (``torch._int_mm``, with im2col for convolutions)
   bitwise against its float64 plain version at VGG-16's conv1_1, conv5_3
   and fc6 and at codes near +127 whose sums pass 2^24, and timed against
   float32 ``F.conv2d``/``addmm`` at every VGG-16 layer shape;
4. serve VGG-16 at full width (224x224x3, 1000 classes, 138 M float32
   parameters from a numpy seed): checkpoint pair -> ServeEngine with the
   fused serving pipeline on the default device -> 32 requests (uint8
   images normalized on the host) from 4 client threads, each answer held
   against an unfused Predictor, the kernels' launch counts read around
   exactly this run;
5. the same checkpoint and images on the uint8 wire through three more
   engines, each 32 requests from 4 threads with requests/s, p50/p99, the
   launch and int8-route counts read around the run and a profile of a
   bucket-8 forward: ``quantize="int8"`` calibrated on the card over 16
   images (13 + 2 fused int8 nodes, out_scale on 9, 0 fc kernel
   launches; the int8 outputs of two samples bitwise equal to the CPU's
   run of the same table), ``quantize={"calib": table, "skip":
   ("fc6",)}`` (one fc kernel launch a batch, its int8 codes against
   requantize() of its float output and against the plain version), and
   ``quantize="float16"`` (finite answers); top-1 agreement with phase 4
   printed, not gated;
6. paged_attention against its plain version at the LLM path's shapes
   (16 slots, 12 heads of 64, 16-token blocks, C = 1, 9, 32, contexts
   over 1..1024, scattered page tables), at ragged ones, at the edges
   of the split-K partitions and in decode at D 128, 32 and 10; bitwise
   layout invariance and two calls bitwise equal at C = 1, 9, 32 (and at
   C = 1 for D 128, 32, 10); kernel (split-K and one pass), plain version
   and gather + SDPA timed;
7. serve an LM at GPT-2-small geometry (vocab 50257, dim 768, 12 heads,
   12 layers, context 1024; 124 M float32 parameters from a numpy seed)
   through PagedDecodeEngine on the default device: 32 mixed-length
   streams from 4 client threads through the paged engine, the
   dense-stripe engine and the speculative engine (1-layer draft),
   streams held equal; teacher-forced logits of the kernel against the
   plain version; launch counts read around each engine run; a profile
   of one chunk-width step and one decode step;
8. flash_attention against its plain version at the kernel search's shape
   (B 4, T 1024, H 12, D 64; GPT-2 small's attention geometry), causal and
   not, at ragged T and D in {10, 16, 32, 64, 128}, and for every compiled
   tile instance at D in {16, 32, 64, 128}; bitwise repeatability;
9. the kernel search path: ``mx.autotune.kernelsearch.search_flash(4, 1024,
   12, 64, causal=True)`` into a fresh store (every candidate gated, the
   shortlist measured, the winner persisted), a second identical search (a
   store hit: zero gate, featurize and measure calls, zero launches), then
   ``flash_attention`` under MXNET_KERNEL_SEARCH=1 resolving the winner,
   bitwise equal to the explicit-tile call; the launch count read around
   this path; kernel, plain version and F.scaled_dot_product_attention
   timed, and every tile;
10. correlation against its plain version at FlowNetC's stage (N 8, C 256,
   48x64, max displacement 20, stride2 2: 441 displacements), PWC-Net's
   cost volume (N 8, C 64, 56x128, 4, 1) and ragged shapes, both
   is_multiply; kernel and plain version timed;
11. FlowNetC's correlation stage (Siamese conv tower sharing its weights,
   correlation, conv_redir, concat, conv3_1; 2.1 M float32 parameters from a
   numpy seed) as a checkpoint pair through ``Predictor`` on the default
   device at 8 x 384x512 image pairs: correlation launches equal to the
   forwards, output held against the port's CPU run of the same checkpoint,
   a profile of one forward;
12. integer max pooling with padding on the card, equal to the CPU run;
13. training through ``Module`` on the card, the fused train step (forward,
   backward, SGD with momentum, BatchNorm's aux updates) captured as one
   CUDA graph: LeNet through ``Module.fit`` for 10 steps from one
   checkpoint (3 eager warm-up steps, 1 capture, 7 replays) held against
   the port's CPU run and the card's classic path; ResNet-50 at 224 with
   1000 classes, batch 128, 25.6 M float32 parameters from a seed: 3
   warm-up steps, 1 capture, 20 replays across an lr-scheduler change
   (no recapture), the last replay against the same step run eagerly
   from the same state, the 23 steps against the classic path's; the
   step's img/s with batches on the card, its wall and device time, busy
   share and device time by kernel group and by part of the step, peak
   memory, the loss, and ``Module.fit``'s img/s over an ``NDArrayIter``;
   0 launches of the four hand kernels on the train path;
14. the PTB LSTM (``lstm_unroll``: 2 layers of 200, vocab 10,000, 32
   steps, Xavier from a seed, SGD lr 0.1 with momentum 0.9, ids from a
   seed) trained on the card: through ``Module`` at batch 2048, 3 eager
   warm-up steps, 1 capture, 20 replays, the last replay against the same
   step eager from the same state, the 23 steps (with the embedding's
   dense update, ``MXNET_EMBED_SPARSE=0``, as the classic path's) bitwise
   against the classic path's under deterministic algorithms, 5 steps
   with the default lazy table update against 5 classic steps at
   momentum 0 (where the two updates agree), tokens/s, profile and peak
   memory, the same with the table dense, ``embed_report()`` sampling
   the ids staged on the card without a host sync; the same step at
   2x1024 batch 512 and at batch 32;
   ``lstm_unroll_scan`` (the ``RNN`` op) against the unrolled form from
   one checkpoint (output 1e-4, gradients 1e-3 relative) and its captured
   step's tokens/s; ``BucketingModule.fit`` over buckets 10/20/30/40 at
   batch 32 (wd 1e-5, 2 epochs of 8 seeded batches) on the card and the
   CPU: 4 bucket modules on one parameter storage, the card's params
   against the CPU's (rtol 1e-3, atol 1e-4), tokens/s and the busy share
   of a classic step; 0 launches of the four hand kernels on these paths;
15. the image zoo trained on the card (TF32 off), each network held to
   the port's CPU run of one numpy-seeded checkpoint: DCGAN's adversarial
   loop (example/gan/dcgan.py) at ngf = ndf = 64, code 100, batch 128,
   Adam lr 2e-4 beta1 0.5, 20 iterations, the first 2 against the CPU
   run from the card's state (gradients within relative L2 1e-2, params
   after Adam's first step apart only where the gradient is noise);
   Fast R-CNN with the VGG-16 trunk to conv4_3 on 2 images of 600x800
   and 128 ROIs, 5 classic steps, the first step's gradients against the
   CPU (relative L2 1e-2), ROIPooling at that shape against the CPU with
   its time and peak memory; AlexNet at 224 (batch 128) and Inception-v3 at
   299 (batch 32) through the fused step, 3 warm-up steps, 1 capture, 10
   replays, the last replay against the same step eager, an eval
   forward against the CPU; FCN-32s at 1x3x512x512 with 21 classes, 3
   classic steps, an eval forward against the CPU; SpatialTransformer,
   L2Normalization and IdentityAttachKLSparseReg against the CPU; a
   Monitor on a LeNet Module (stat names equal the CPU run's, no capture
   while installed); rates, busy shares, kernel groups and peak memory;
   0 launches of the four hand kernels on these paths;
16. the engines' requests/s and p50/p99;
17. serving operations: (a) a ``DecodeEngine`` built without a context
   (so on the card) over one decode step of the PTB LSTM (``lstm_cell``,
   2 layers of 200, embed 200, vocab 10,000; 4,653,200 parameters from
   a numpy seed; state ``l{0,1}_{c,h}``), 16 slots, 32 streams of 1..32
   prompt tokens and 64 new ones from 4 threads, every stream held
   against the port's CPU DecodeEngine on the same checkpoint under
   phase 7's top-2 margin rule, tokens/s and a step's wall and device
   time, then a hot reload mid-flood (each stream one version's from end
   to end); (b) a ``ServeRouter`` over 2 ``PagedDecodeEngine`` replicas
   at phase 7's geometry and checkpoint: phase 7's 32 prompts from 4
   threads, streams equal to phase 7's under the same rule, then a
   second flood with ``rolling_restart()`` in the middle (0 dropped, 0
   errors), paged_attention's launches equal to 12 x the replicas'
   target forwards around each flood, tokens/s beside phase 7's; (c) a
   ``ModelMultiplexer`` of phase 4's fused VGG-16 ``ServeEngine``, (a)'s
   LSTM and (b)'s LM under a byte budget from their ``device_bytes()``
   that cannot hold VGG-16 and the LM together: 7 interleaved waves
   force swap-ins and LRU evictions, every answer held against that
   model's standalone answer, ``torch.cuda.memory_allocated()`` falling
   by at least each evicted engine's ``device_bytes()`` (1 MiB
   tolerance), the launches of both kernels on the path counted;
18. the rest of training on the card, TF32 off: (a) the superstep at
   bench_lstm.py:118's leg (PTB LSTM 2x200, vocab 10,000, batch 32, 32
   steps, SGD lr 0.1 momentum 0.9, cross-entropy over the time-major
   rows, Xavier from a seed): ``fit(superstep=8)`` against K=1 over 2
   epochs of 16 seeded batches under deterministic algorithms, params,
   momentum and the metric bitwise; tokens/s of the second epoch, metric
   drains per step, graph captures and replays, busy share of a
   superstep and of a K=1 step; (b) ``FeedForward.fit`` against
   ``Module.fit`` at ResNet-50 (batch 128, SGD lr 0.05 momentum 0.9, 2
   epochs of 4 host batches, cuDNN deterministic), both on the fused
   step: params bitwise, img/s of the second epoch, ``predict``'s argmax
   equal to ``Module.predict``'s; (c) ``Module(context=[gpu(0),
   gpu(0)])`` with kvstore ``device`` and ``local`` (2 classic steps;
   ``local`` auto-selects ``local_update_cpu``) and ``work_load_list=[1,
   3]`` (one step), each within relative L2 1e-5 of a plain write-out of
   v0.7's data parallelism (two ``simple_bind`` executors, gradients
   summed in context order, the same updater where the store updates),
   img/s beside one context's classic step; (d) ``fit(checkpoint=,
   checkpoint_every=2)`` over 6 batches with ``do_checkpoint(module=)``
   at the epoch end, a fresh module resumed from step 4: params, aux and
   momentum bitwise to the uninterrupted run; bytes per save, pinned
   host bytes, the train thread's stall and the writer's commit wall;
   one SIGTERM round of a LeNet fit in a child process on the card; (e)
   ``ServeEngine.from_checkpoint_dir`` on (d)'s directory bitwise to a
   ``Predictor`` on the legacy pair of the same step, then
   ``reload_from_checkpoint_dir`` mid-flood with 0 dropped and 0 errors;
   (f) the model-parallel LSTM (``ctx_groups``) bound with every group
   on gpu(0), outputs and gradients bitwise to the ungrouped bind; 0
   hand-kernel launches on (a)-(d);
19. routed MoE and the sparse embedding engine, TF32 off: (a)
   Switch-Base-8's MoE FFN (d_model 768, d_ff 3072, 8 ReLU experts,
   top-1, capacity factor 1.25; 37,787,138 parameters from a seed) ->
   FC(2) -> SoftmaxOutput with the aux loss, 8,192 tokens a batch
   (capacity 1,280), SGD lr 0.1 momentum 0.9 through the captured fused
   step under deterministic algorithms: ``route`` on the card against
   the CPU on the same logits (slots, counts, hits equal), the last
   replay bitwise against the same step eager, each parameter's change
   over the first 2 steps against the port's CPU run's (relative L2,
   and a router frozen on the card failing that gate), the aux loss's
   router gradient against the CPU's, step times against
   bench_moe.py's FLOP-matched dense block (FC 24,576 -> relu -> FC
   768) in interleaved windows, ``moe_report()``'s imbalance; (b)
   routed decode: tok -> Embedding(32128, 768) -> the same block
   (capacity pinned to 0 by ``MoEServeParityPass``) -> FC(32128),
   87,166,336 parameters, ``DecodeEngine`` with 16 slots and
   ``moe_hits_state``: one stream alone (the routed count equals k x
   slots x steps), then 32 streams of 1..29 prompt tokens and 64 new
   ones from 4 threads held against the port's CPU engine under phase
   7's top-2 margin rule, tokens/s and a step's wall and device time;
   (c) bench_embed.py's step leg (200,000 x 32 table, 512 x 8 ids a
   batch from 410 hot ids, unique cap 512, tower 64 -> 2, SGD lr 0.1
   momentum 0.9) and the same with a 4,000,000 x 64 table, each sparse
   (the default) and with ``MXNET_EMBED_SPARSE=0``, captured: rows and
   momentum no batch names bitwise unchanged, the last replay bitwise
   against the same step eager, one capture each, the 200k table's
   first 4 steps against the CPU, step times in interleaved windows,
   peak memory, ``embed_report()``'s dedup ratio; (d) bench_embed.py's
   serve leg (10,000 x 32, 16 ids a request, tower 64 -> 8) through
   ``ServeEngine(embed_dedup=True)``, 8 threads x 25 requests: every
   answer against the tower in numpy (padded ids reading zero rows),
   the unpadded ones against a serial batch-1 ``Predictor`` too,
   ``fused_fc_epilogue`` once
   a batch, 0 dropped, requests/s and p50/p99; (e) kvstore
   ``device_embed`` with a 200,000 x 64 sparse key: ``row_sparse_pull``
   and two lazy pushes against the CPU store; 0 hand-kernel launches
   on (a), (b), (c) and (e);
20. the input pipeline (``feed/``, ``recordio``), its data written at run
   time: (a) ResNet-50 trained from 1,280 raw CHW uint8 records at
   3x256x256 (im2rec --resize 256's envelope, 252 MB, a numpy seed,
   written by the port's ``recordio`` into a temporary directory) through
   ``feed.record_pipeline(batch 128, 3x224x224, resize 256, random crop
   and mirror, ImageNet's mean, device_augment=True)`` and
   ``Module.fit(prefetch_to_device=True)``, 3 epochs of 10 batches: the
   first batch's augmented input, read back from the card, bitwise
   ``augment_batch_host`` of the same uint8 batch with the same draws;
   one capture for the uint8 shape and a replay per batch after the
   warm-up; img/s of epoch 2 against phase 13's ``fit``, the busy share
   of epoch 3 (its kernels and copies over its own wall),
   ``feed_report()``'s stalls per stage, host-to-device bytes per batch;
   then speculation on the same wire: outputs read before ``update()``
   run a step early, a new forward discards it, and the step run again
   (an eager one and a replay) leaves the augmented inputs, params and
   momentum bitwise a straight run's; (b) a mid-epoch resume through the feed cursor with
   4 reader processes (forked with the card's context up) under
   deterministic cuDNN: saved at step 4, a fresh module trains the
   uninterrupted run's remaining labels and ends on its params bitwise;
   the reader's decode rate and feed headroom (feed img/s / train img/s);
   (c) phase 18's superstep leg through ``fit(prefetch_to_device=True)``:
   K=8 over prefetch-staged megabatches bitwise K=1, tokens/s and busy
   shares beside phase 18's, then epochs of 64 batches: K=1, K=8 staging
   inside each superstep and K=8 staged before each drain; (d) bench_embed.py's step leg (200,000 x
   32) from ids with ~10 % of rows padded with ``PAD_ID`` through
   ``feed.ids_pipeline`` + ``fit(prefetch_to_device=True)``: bitwise the
   same fit over an ``NDArrayIter``, the last row and unnamed rows
   untouched; 0 hand-kernel launches on (a)-(d); the ``feed result``
   line;
21. scale-out (``dist/``, ``parallel/``, the dist kvstores): (a) a mesh
   of one rank (NCCL, world 1): ``Module.fit(mesh=make_mesh("dp=1"))``
   and ``DPTrainStep`` on ResNet-50 at batch 128 (bench.py's SGD) over 4
   seeded batches under deterministic cuDNN, bitwise to ``fit`` without
   a mesh, one capture holding the step's collectives, the captured
   steps' img/s and busy share beside phase 13's; (b)-(d) two ranks
   sharing gpu(0) (gloo by the backend rule, started with the
   launcher's envs): ``fit(kvstore="dist_sync")`` and ``fit(mesh=dp=2)``
   on the same batches, bitwise to each other, each against (a) under
   the one-ulp nudge's drift (first step and after 4), img/s and the
   collectives' share of a step; ring and Ulysses attention at sp=2,
   H 12, D 64, B 1, T 16,384, causal and not, each rank's shard against
   the flash kernel over the whole sequence, the gradient at T 2,048
   against ``attention_reference``'s; ``GPipeTrainStep`` at pp=2 over two
   768 -> 3072 -> 768 tanh stages, 8 microbatches of 8 x 1,024 tokens,
   against the stages in sequence; (e) ``dist_async`` through
   ``tools/launch.py -n 2 -s 1``: the nightly MLP on the card to 0.90,
   one init/push/pull round of ResNet-50's parameters; the ``scale-out
   result`` line;
22. model state sharded over a mesh (``sharded:`` lines): VGG-16 at
   dp=1 x tp=2 on two ranks of gpu(0), the save restored three ways,
   Switch-Base-8 at dp=1 x ep=2, the tp=2 ``ServeEngine``; the
   ``sharded result`` line;
23. the rest of scale-out: (a) data parallelism's two repairs on two
   gloo ranks of gpu(0): an MLP with Dropout at dp=2 against one process
   with the same seed (one mask over the global batch), and
   tests/test_embed.py's rec model at dp=2 on the lazy row update
   against one process's lazy fit (its rtol 2e-5, atol 1e-6); (b)
   bench_embed.py's rec tower with a 4,000,000 x 64 table row-sharded at
   dp=2 (each rank 2,000,000 rows and their momentum), 4 fused steps
   against one process's, the untouched rows bitwise, the ranks' save
   restored into one process bitwise; (c) a ``FleetSupervisor`` of two
   ranks on the tower at 200,000 x 32 (a commit every step), with a
   ``dist.host`` crash on rank 1: the final params bitwise the
   fault-free fleet's, ``recovery_s``; (d) a ``ServeRouter`` over two
   ``RpcReplica``s, each a child process serving the fused float32
   VGG-16 on gpu(0) (each child holds ``fused_fc_epilogue`` against its
   plain version on fc6 and counts its launches): 32 requests, a
   SIGKILL of one child mid-flood, a draining restart of the other, 0
   dropped, every answer against the in-process engine's; (e)
   ResNet-50 from a .rec over ``fit(mesh="dp=2",
   prefetch_to_device=True)``: each rank copies half the global batch's
   bytes, bitwise the run whose ``make_batch`` cuts the global batch;
   the ``scale-out rest result`` line;
24. compile and tuning (``cold-start``, ``tuning``, ``resnet`` lines):
   (a) three fresh processes serve a small MLP through the fused
   ``fused_fc_epilogue`` over one ``MXNET_COMPILE_CACHE`` directory made
   at run time: nvcc runs once in the first, zero times in the second,
   and once in a third that meets a planted truncated entry (warned,
   rebuilt, the same answers); each one's wall to its first answer and
   the store's entries and bytes; (b) ``search_fc`` at VGG-16's fc6 and
   fc7 at bucket 8 and ``search_paged`` at GPT-2 small's class (bt 16,
   D 64, causal, 16 slots, C 1): every candidate's gate and time, the
   winner against the default, a second search a store hit with zero
   calls; under MXNET_KERNEL_SEARCH=1 the winners launch, phase 6's
   layout gates and phase 7's paged == dense-stripe streams hold; (c)
   ``tune_superstep`` and ``tune_fit_joint`` on phase 18's PTB LSTM at
   batch 32 leave the train state bitwise, ``fit(autotune=True)`` and
   ``("joint")`` load the winners, tokens/s against K=1; (d) ResNet-50
   at batch 128 under deterministic cuDNN: the first step's wall with
   and without ``prepare()``, 0 captures in the loop after it, the state
   after it bitwise, the step time and peak memory with
   ``MXNET_BACKWARD_DO_MIRROR=1`` against without (its first step within
   relative L2 1e-5), and eight small modules prepared by eight threads
   bitwise those prepared by one; the compile report; the ``compile and
   tuning result`` line;
25. trace/, the rest of mx.profiler, the shard search and online/
   (``p25 (a)``..``(e)`` lines, PERF.md section 6 PR 19); the ``trace,
   search and online result`` line;
26. users' kernels, Python ops, WarpCTC and the torch bridge (``p26 (a)``
   ..``(f)`` lines): (a) the original ``ndarray_softmax`` bodies (the
   softmax over rows, ``y - onehot(l)``) compiled through ``mx.rtc.Rtc``
   with nvcc and launched on gpu(0) at 100 x 10 and 37 x 1000 against
   plain PyTorch (atol 1e-6), a second ``Rtc`` of the same source running
   nvcc 0 times, a body with a syntax error raising with nvcc's log; (b)
   example/numpy-ops' 784-128-64-10 MLP at batch 100 from one checkpoint,
   20 steps through ``fit`` with a ``NumpyOp``, an ``NDArrayOp`` (its
   kernels (a)'s), a ``CustomOp`` and a ``SoftmaxOutput`` head: the
   Python-op runs eager (0 captures, 20 eager steps) and within atol 1e-5
   of the captured ``SoftmaxOutput`` run; (c) a graph with a ``Custom``
   node between fc1 and fc2 trained 5 steps, saved, served through
   ``ServeEngine(fuse=True)``: 32 requests from 4 threads against an
   unfused ``Predictor``, ``fused_fc_epilogue`` launched twice a batch;
   (d) LSTM-OCR at example/warpctc/lstm_ocr.py's defaults (T 80, 30
   features, 100 hidden, batch 32, 4 labels, 11 classes) through ``fit``:
   captured, the first update against the port's CPU run, two runs under
   deterministic algorithms bitwise equal, tokens/s; (e) ``mx.th`` on the
   card; (f) a child with ``MXNET_LOCK_CHECK=1`` serving (c)'s graph from
   4 threads, saving a checkpoint and dumping a trace: no lock-order
   cycle; the ``user kernels and plugins result`` line;
27. the native layer (``p27 ...`` lines; its g++ builds start beside
   phase 2's nvcc builds): the probe (``jpeglib.h``, ``Python.h``, a
   shared ``libpython``, whether this interpreter links it, g++), whose
   findings the phase then requires; (a) a seeded workload of host
   closures on ``mx.engine`` over 4 vars holding ResNet-50 batches on
   the card, bitwise the same closures run serially, closures/s, the
   host cost of a push, ``NativeStorage``'s pool hits; (b) 1,024 records
   from the port's ``NativeRecordWriter`` (JPEG where libjpeg was found,
   else raw CHW at 256 x 256, and then a JPEG record must raise naming
   libjpeg) through ``mx.io.ImageRecordIter`` at ResNet-50's settings (a
   ``NativeImageRecordIter``, its 8-thread batches bitwise a 1-thread
   run's, img/s alone) into ResNet-50's ``Module.fit`` (img/s, the
   loader's share, finite loss, 0 kernel launches); (c) VGG-16's fused
   serving graph at batch 8 through the predict-only library opened in
   this process: 20 forwards bitwise the Python ``Predictor``'s,
   ``fused_fc_epilogue`` twice a forward, the output on (2, 0), ms a
   forward against ``Predictor``; (d) ``tests/data/capi_card_client.cc``
   built against ``cpp-package/include`` and the C ABI library, training
   the 784-128-64-10 MLP on Context(2, 0) through ``MXExecutor*`` and
   ``MXOptimizerUpdate``: its first update against the port's Python
   Executor, its accuracy gate, steps/s against the fused ``fit``; (e)
   ``MXRtcCreate``/``MXRtcPush`` with phase 26's softmax on NDArrays
   made through the ABI against ``torch.softmax``, one launch counted;
   the ``native layer result`` line;
28. float16 and bfloat16 in ``paged_attention``, ``flash_attention``,
   ``correlation`` and ``fused_fc_epilogue`` (``kernel check half``,
   ``flownetc``, ``vgg16``, ``search (c)``, ``search (d)``, ``pool (d)``
   lines): (a) each 16-bit instance at the
   main paths' shapes and ragged ones against the float32 instance on
   the upcast inputs, rounded (correlation's ``|a - b|`` bitwise; flash,
   paged and correlation's products, whose 16-bit products run on the
   tensor cores, within one unit in the last place), within one unit in
   the last place of its plain version,
   two calls bitwise equal, paged's page layouts bitwise equal, mixed
   dtypes bitwise the float32 instance's output cast; (b) FlowNetC's
   stage through ``Predictor`` bound in float16 and ``simple_bind`` in
   bfloat16, the kernel once a forward in that dtype, held on the
   captured inputs, the stage against phase 11's float32 output; (c)
   ``search_flash`` in float16 and bfloat16, each winner under its
   dtype's class, a store hit, call-time resolution; (d)
   ``search_paged`` in bfloat16 and ``paged_attention`` over
   ``KVBlockPool.add_view(dtype=)`` views at the page table's capacity;
   (e) each half instance timed beside the float32 instance, its plain
   version and the library call, correlation also at PWC-Net's shape,
   and ``fused_fc_epilogue``'s tensor-core instance in float16 and
   bfloat16 at fc6 + fc7 (bucket 8) beside ``addmm`` + ``relu_`` in that
   dtype, with the launches on (f)'s path; (f) VGG-16
   at full width with the serving pipeline's fusion, bound at bucket 8
   in float16 through ``Predictor(type_dict=)`` and in bfloat16 through
   ``simple_bind(type_dict=)``: 4 forwards each, ``fused_fc_epilogue``
   twice a forward in the dtype, held on fc6's captured inputs, the
   logits within ``VGG_HALF_RTOL`` of the float32 fused forward's; the
   ``half precision result`` line;
   then the whole script's wall, the ``kernels`` JSON line (all four
   kernels and their float16 and bfloat16 instances), then the
   ``{"ok": true, ...}`` line.
"""
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM published peaks at 700 W (NVIDIA data sheet): HBM3 bandwidth,
# float32 outside the tensor cores, dense TF32 on the tensor cores
# (flash_attention's products: 3 TF32 products per float32 product) and
# dense float16/bfloat16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
FLASH_PEAK = "3xTF32: 3 TF32 products per float32 product at 495 TFLOP/s"
# dense float16/bfloat16 on the tensor cores (float32 accumulate)
PEAK_HALF_FLOPS = 989e12
HALF_FLASH_PEAK = ("q.k one 16-bit product (exact), p.v two (a float32 p "
                   "split in two 16-bit parts), all at 989 TFLOP/s")


def half_attention_flops_ms(flops, q_size):
    """Least time for attention's 4·D flops a (row, key) pair over 16-bit
    K and V, half in q·k and half in p·v, on the tensor cores, counted as
    the products the function needs at its accuracy: with a 16-bit q, q·k
    in one 16-bit product (exact) and p·v in two (a float32 p split into
    two 16-bit parts), all at the float16/bfloat16 rate; with a float32
    q, q·k in 2 TF32 products (q split in two, k exact in TF32) and p·v in
    2 TF32 products (p split in two, v exact in TF32)."""
    if q_size == 2:
        return 1e3 * 1.5 * flops / PEAK_HALF_FLOPS
    return 1e3 * 2 * flops / PEAK_TF32_FLOPS

# The redesigned kernels' times before their tensor-core, split-K designs:
# quoted, not measured by this script.  kernel_ab.py timed the earlier
# kernels with time_ms below on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
# Findings): flash_attention at the search shape with its best tile, and
# paged_attention at the time rows' cases, by C.  Printed in the time rows
# beside the measured times, never in the kernels line.
EARLIER_FLASH_MS = 0.3174
EARLIER_PAGED_MS = {1: 0.1114, 9: 0.1529, 32: 0.1588}
EARLIER_FROM = "quoted: PERF.md Findings (kernel_ab.py), not this run"
# The 16-bit instances before their m16n8k16, 16-bit-stage designs
# (float32 arithmetic over float32 stages filled through registers), timed
# by phase 28 (e) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, Findings):
# flash at the search shape with its dtype's winner, paged C=1 + C=32,
# correlation at FlowNetC's shape (multiply).  Quoted in the time rows,
# never in the kernels line.
EARLIER_HALF_MS = {"flash_attention": {"float16": 0.1918, "bfloat16": 0.1920},
                   "paged_attention": {"float16": 0.1905, "bfloat16": 0.1925},
                   "correlation": {"float16": 0.4713, "bfloat16": 0.4731},
                   # fc6 + fc7 (bucket 8, relu) on the SIMT instance
                   "fused_fc_epilogue": {"float16": 0.6263,
                                         "bfloat16": 0.6253}}
EARLIER_HALF_FROM = "quoted: PERF.md Findings (phase 28 (e)), not this run"
# correlation before its register-blocked design, at FlowNetC's shape
# (multiply), timed by chip_smoke.py the same way (PERF.md, Findings)
EARLIER_CORR_MS = {"flownetc": 0.6855}

# the uint8 wire of the int8 and float16 VGG-16 engines (ImageNet's mean
# and spread of 8-bit pixels, roughly): x = (u8 - 117) / 58 in the graph
U8_WIRE = {"mean": 117.0, "scale": 1 / 58.0, "hwc": True}

REPLACES = {"fused_fc_epilogue": "mxnet_tpu/ops/pallas_kernels.py:347",
            "paged_attention": "mxnet_tpu/ops/pallas_kernels.py:262",
            "flash_attention": "mxnet_tpu/ops/pallas_kernels.py:121",
            "correlation": "mxnet_tpu/ops/pallas_kernels.py:417"}


def fail(msg):
    raise RuntimeError("chip_smoke: " + msg)


def ptxas_instances(log):
    """[(kernel instance, registers, spill bytes)] from ``-Xptxas -v``
    output: one entry per compiled entry function, named by its kernel,
    its element type where that is the first template argument, and its
    integer and bool template arguments."""
    found, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            cur = m.group(1)
            found.setdefault(cur, [0, 0])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            found[cur][1] = max(int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            found[cur][0] = int(m.group(1))
    out = []
    dtypes = {"f": "float", "6__half": "half", "13__nv_bfloat16": "bf16"}
    for name, (regs, spill) in found.items():
        base = re.search(r"([a-z][a-z_]*_kernel)I(f|6__half|13__nv_bfloat16)?",
                         name)
        args = re.findall(r"L[bi](\d+)E", name)
        if base and base.group(2):
            args.insert(0, dtypes[base.group(2)])
        out.append(("%s<%s>" % (base.group(1), ",".join(args)) if base
                    else name[:60], regs, spill))
    return out


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# cycles of a device-side spin queued ahead of each timed call: 0.2 ms at
# the H100's clocks, longer than any wrapper's host work, so the card is
# still busy when the timed launches arrive and no host gap enters the span
SPIN_CYCLES = 400000


def time_ms(torch, fn, flush, iters=20):
    """Median device time of fn() in ms, CUDA events around each call.
    Before each call (outside the timed span) a read of a 256 MB buffer
    leaves the 50 MB L2 holding clean, unrelated lines: the weights
    arrive cold, as they do in a forward pass; then a spin kernel keeps
    the card busy while the host enqueues the start event and fn()'s
    launches."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def fc_bound_ms(x, w, b, out):
    """Least time for x · wᵀ + b: each input read once and the output
    written once at the HBM rate, or the flops at the float32 rate (the
    16-bit instance's products at the tensor cores' 16-bit rate)."""
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, out)) \
        + (b.numel() * b.element_size() if b is not None else 0)
    flops = 2.0 * x.shape[0] * w.shape[0] * x.shape[1]
    half = x.element_size() == 2 and w.dtype == x.dtype
    return 1e3 * max(nbytes / PEAK_BYTES_PER_S,
                     flops / (PEAK_HALF_FLOPS if half else PEAK_F32_FLOPS))


def fc_serving_inputs(torch, dev):
    """VGG-16's fc6 and fc7 at bucket 8 as the time rows take them: [(x,
    w, b)] in float32, U(-1, 1) x, U(-1, 1) / sqrt(K) W, U(-0.1, 0.1) b
    from one generator seeded 1234."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    out = []
    for k in (25088, 4096):
        x = torch.rand((8, k), generator=gen, device=dev) * 2 - 1
        w = (torch.rand((4096, k), generator=gen, device=dev) * 2 - 1) \
            / math.sqrt(k)
        b = (torch.rand((4096,), generator=gen, device=dev) * 2 - 1) * 0.1
        out.append((x, w, b))
    return out


def fc_half_time_row(torch, ck, dev, flush, dt):
    """fused_fc_epilogue at fc6 + fc7 (bucket 8, relu) with x and W in
    ``dt`` and the bias in float32 as the kernel reads it: the kernel
    (``layer_ms`` by layer, ``route`` its operands'), the float32
    instance, the plain version, ``addmm`` + ``relu_`` in ``dt`` and the
    bound, each summed over the two layers."""
    row = dict(ms=0.0, f32_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0)
    layer_ms, routes = {}, set()
    for layer, (x, w, b) in zip(("fc6", "fc7"),
                                fc_serving_inputs(torch, dev)):
        xh, wh, bh = x.to(dt), w.to(dt), b.to(dt)
        out = ck.fused_fc_epilogue(xh, wh, b, "relu")
        layer_ms[layer] = time_ms(torch, lambda: ck.fused_fc_epilogue(
            xh, wh, b, "relu"), flush)
        row["ms"] += layer_ms[layer]
        routes.add(fc_route(ck, xh, wh))
        row["f32_ms"] += time_ms(torch, lambda: ck.fused_fc_epilogue(
            x, w, b, "relu"), flush)
        row["plain_ms"] += time_ms(
            torch, lambda: ck.fused_fc_epilogue_reference(
                xh, wh, b, "relu"), flush)
        row["library_ms"] += time_ms(torch, lambda: torch.relu_(
            torch.addmm(bh, xh, wh.t())), flush)
        row["bound_ms"] += fc_bound_ms(xh, wh, b, out)
        del x, w, xh, wh, out
    row.update(shape="fc6 + fc7, M=8, relu", bound_by="bytes",
               library="addmm + relu_ in %s" % str(dt).split(".")[-1],
               layer_ms=layer_ms, route=" + ".join(sorted(routes)))
    return row


# ---------------------------------------------------------------------------
# phase 3: fused_fc_epilogue against its plain version

def kernel_phase(torch, ck):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)

    def uniform(shape, scale, dtype=torch.float32):
        t = torch.rand(shape, generator=gen, device=dev) * 2 - 1
        return (t * scale).to(dtype)

    def inputs(m, k, n, dtype=torch.float32, bias=True):
        x = uniform((m, k), 1.0, dtype)
        w = uniform((n, k), 1.0 / math.sqrt(k), dtype)
        b = uniform((n,), 0.1) if bias else None
        return x, w, b

    # Float tolerances.  The kernel and the plain version both sum K
    # float32 products, in different orders (per-lane strided partial sums
    # and a warp tree in the kernel, cuBLAS's own split in the plain
    # version); the difference grows like sqrt(K) * 2^-24 times the
    # partial sums, which are O(1) here: under 1e-5 at K = 25088.  float32
    # outputs: 1e-4 * max(1, max|plain|).  16-bit outputs: that float32
    # difference can flip the last bit of the rounded result, so one ulp of
    # the largest output: 2^-7 * max(1, max|plain|) for bfloat16 (8-bit
    # mantissa), 2^-10 for float16.
    tol_rel = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7,
               torch.float16: 2.0 ** -10}
    cases = [("fc6", 8, 25088, 4096, "relu", torch.float32, True),
             ("fc7", 8, 4096, 4096, "relu", torch.float32, True),
             ("m1", 1, 4096, 4096, "relu", torch.float32, True)]
    cases += [("ragged-" + act, 3, 784, 10, act, torch.float32, True)
              for act in ("none", "relu", "sigmoid", "tanh", "softrelu")]
    cases += [("scalar-path", 5, 1001, 37, "tanh", torch.float32, True),
              ("no-bias", 8, 4096, 512, "relu", torch.float32, False),
              ("bf16", 8, 4096, 4096, "relu", torch.bfloat16, True),
              ("fp16", 8, 4096, 4096, "sigmoid", torch.float16, True)]
    main_err = 0.0
    for name, m, k, n, act, dtype, bias in cases:
        x, w, b = inputs(m, k, n, dtype, bias)
        out = ck.fused_fc_epilogue(x, w, b, act)
        ref = ck.fused_fc_epilogue_reference(x, w, b, act)
        torch.cuda.synchronize()
        if out.dtype != ref.dtype or out.shape != ref.shape:
            fail("%s: kernel gave %s %s, plain %s %s" % (
                name, out.dtype, tuple(out.shape), ref.dtype,
                tuple(ref.shape)))
        err = (out.float() - ref.float()).abs().max().item()
        tol = tol_rel[dtype] * max(1.0, ref.float().abs().max().item())
        print("kernel check %-16s M=%-2d K=%-5d N=%-4d %-8s %-14s "
              "max_abs_err=%.3g tol=%.3g" % (name, m, k, n, act, dtype,
                                             err, tol))
        if not err <= tol:
            fail("%s: max_abs_err %.3g > tol %.3g" % (name, err, tol))
        if name in ("fc6", "fc7"):
            main_err = max(main_err, err)

    # int8 requantize: small integer x and W make every float32 sum exact,
    # and out_scale 2 puts odd sums on .5 ties; the codes must be equal
    # (multiply by the float32 reciprocal, round half to even, clamp),
    # also at scales whose reciprocal is inexact (0.7, 3)
    for act, scale in (("none", 2.0), ("relu", 2.0), ("none", 0.7),
                       ("relu", 3.0)):
        gi = torch.Generator(device=dev).manual_seed(7)
        x = torch.randint(-3, 4, (8, 512), generator=gi, device=dev).float()
        w = torch.randint(-2, 3, (64, 512), generator=gi, device=dev).float()
        b = torch.randint(-5, 6, (64,), generator=gi, device=dev).float()
        q = ck.fused_fc_epilogue(x, w, b, act, out_scale=scale)
        qr = ck.fused_fc_epilogue_reference(x, w, b, act, out_scale=scale)
        torch.cuda.synchronize()
        sums = torch.matmul(x.double(), w.double().t()) + b.double()
        ties = int((sums.remainder(scale) == scale / 2).sum().item())
        same = bool(torch.equal(q, qr)) and q.dtype == torch.int8
        print("kernel check int8-%-4s scale %-4g codes equal=%s (%d of %d "
              "sums on a .5 tie, %d codes clamped)" % (
                  act, scale, same, ties, q.numel(),
                  int((qr.abs() == 127).sum().item())))
        if not same:
            fail("int8 %s: codes differ at %d places" % (
                act, int((q != qr).sum().item())))

    half_err = fc_half_checks(torch, ck, dev, inputs)

    # timing at the serving path's shapes (bucket 8, float32, relu)
    flush = torch.zeros(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    rows = []
    for name, k in (("fc6", 25088), ("fc7", 4096)):
        x, w, b = inputs(8, k, 4096)
        out = ck.fused_fc_epilogue(x, w, b, "relu")
        row = {
            "shape": name, "M": 8, "K": k, "N": 4096,
            "ms": time_ms(torch, lambda: ck.fused_fc_epilogue(
                x, w, b, "relu"), flush),
            "plain_ms": time_ms(torch, lambda: ck.fused_fc_epilogue_reference(
                x, w, b, "relu"), flush),
            "library_ms": time_ms(torch, lambda: torch.relu_(
                torch.addmm(b, x, w.t())), flush),
            "bound_ms": fc_bound_ms(x, w, b, out),
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print("kernel time %s: %s" % (name, json.dumps(row)))
        rows.append(row)
    del flush
    return {"max_abs_err": main_err, "half_err": half_err,
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "library_ms": sum(r["library_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "rows": rows}


# 16-bit fused_fc_epilogue cases: (label, M, K, N, act, bias, the route
# fc_route must give, operands 2-byte aligned).  fc6 and fc7 at buckets 8,
# 1 and 33; every act and no bias; a ragged K and N; the SIMT route's
# shapes (K % 8 != 0, a view off 16 bytes)
FC_HALF_CASES = (
    [("fc6", 8, 25088, 4096, "relu", True, "tensor_core", False),
     ("fc7", 8, 4096, 4096, "relu", True, "tensor_core", False),
     ("fc6-m1", 1, 25088, 4096, "relu", True, "tensor_core", False),
     ("fc7-m1", 1, 4096, 4096, "relu", True, "tensor_core", False),
     ("fc6-m33", 33, 25088, 4096, "relu", True, "tensor_core", False),
     ("fc7-m33", 33, 4096, 4096, "relu", True, "tensor_core", False)]
    + [("ragged-" + act, 3, 784, 10, act, True, "tensor_core", False)
       for act in ("none", "relu", "sigmoid", "tanh", "softrelu")]
    + [("no-bias", 8, 4096, 512, "relu", False, "tensor_core", False),
       ("ragged-k1000-n37", 5, 1000, 37, "tanh", True, "tensor_core", False),
       ("simt-k1001", 5, 1001, 37, "tanh", True, "simt", False),
       ("simt-2-byte-aligned", 8, 4096, 512, "sigmoid", True, "simt",
        True)])


# the tensor-core route's workspace at fc6 and fc7, buckets 1..8: 256
# column tiles x 6 pieces x 512 bytes (tests/test_torch_fc_half.py's plan)
FC_HALF_WORKSPACE = 786432


def fc_route(ck, x, w):
    """The route a CUDA call of fused_fc_epilogue on x and w takes, as
    its launcher plans it: ``tensor_core`` where it needs a workspace."""
    return "tensor_core" if ck.fc_workspace_bytes(x, w) else "simt"


def fc_half_checks(torch, ck, dev, inputs):
    """Phase 3's 16-bit cases (FC_HALF_CASES) in float16 and bfloat16:
    each on the route the case names (fc_route; FC_HALF_WORKSPACE at fc6
    and fc7, buckets 8 and 1), within one unit in the last place of the
    float32 instance on the upcast inputs, rounded, and of the plain
    version, two calls bitwise equal (hold_half); then int8 codes from
    16-bit operands equal to the plain version's, two calls bitwise
    equal.  -> {dtype name: max abs error at fc6 and fc7, bucket 8}."""
    main = {}
    for name in HALF_NAMES:
        dt = getattr(torch, name)
        main[name] = 0.0
        for label, m, k, n, act, bias, route, odd in FC_HALF_CASES:
            x, w, b = half_args(torch, inputs(m, k, n, bias=bias), dt, odd)
            if b is not None:
                b = b.float()
            got = fc_route(ck, x, w)
            if got != route:
                fail("fc half %s %s: route %s, want %s" % (label, name, got,
                                                          route))
            ws = ck.fc_workspace_bytes(x, w)
            if label in ("fc6", "fc7", "fc6-m1", "fc7-m1") and \
                    ws != FC_HALF_WORKSPACE:
                fail("fc half %s %s: workspace %d bytes, want %d"
                     % (label, name, ws, FC_HALF_WORKSPACE))
            err = hold_half(
                torch, ck, "fc %s M=%d K=%d N=%d %s %s" % (
                    label, m, k, n, act, route),
                lambda *a: ck.fused_fc_epilogue(*a, act),
                lambda *a: ck.fused_fc_epilogue_reference(*a, act),
                [x, w, b], dt, exact=False)
            if label in ("fc6", "fc7"):
                main[name] = max(main[name], err)
        # int8 codes from 16-bit operands: small integers are exact in both
        # dtypes and their float32 sums exact on the tensor cores; scale 2
        # puts odd sums on .5 ties, 0.7 has an inexact reciprocal
        gi = torch.Generator(device=dev).manual_seed(11)
        x = torch.randint(-3, 4, (8, 512), generator=gi, device=dev).to(dt)
        w = torch.randint(-2, 3, (64, 512), generator=gi, device=dev).to(dt)
        b = torch.randint(-5, 6, (64,), generator=gi, device=dev).float()
        for act, scale in (("none", 2.0), ("relu", 2.0), ("none", 0.7)):
            q = ck.fused_fc_epilogue(x, w, b, act, out_scale=scale)
            again = ck.fused_fc_epilogue(x, w, b, act, out_scale=scale)
            qr = ck.fused_fc_epilogue_reference(x, w, b, act,
                                                out_scale=scale)
            torch.cuda.synchronize()
            same = bool(torch.equal(q, qr) and torch.equal(q, again)) and \
                q.dtype == torch.int8
            print("kernel check half fc int8-%-4s %-14s scale %-4g route %s "
                  "codes equal=%s" % (act, dt, scale, fc_route(ck, x, w),
                                      same))
            if not same:
                fail("fc int8 %s %s: codes differ at %d places from the "
                     "plain version's, at %d from a second call's" % (
                         name, act, int((q != qr).sum().item()),
                         int((q != again).sum().item())))
    return main


# ---------------------------------------------------------------------------
# phase 4: serve VGG-16

def xavier_params(sym, shapes, seed):
    """Uniform weights at Xavier(factor_type='in', magnitude=6) scale,
    sqrt(6 / fan_in), which keeps the activation scale through the relu
    stack; biases U(-0.01, 0.01) so the bias epilogue does work."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        scale = 0.01 if len(shape) == 1 else \
            math.sqrt(6.0 / float(np.prod(shape[1:])))
        # (u * 2 - 1) * scale in float32, in place
        a = rng.random(shape, dtype=np.float32)
        a *= 2
        a -= 1
        a *= np.float32(scale)
        params[name] = a
    return params


def wire_to_nchw(u8):
    """A uint8 HWC wire image normalized on the host as the u8 wire
    prologue normalizes it in the graph: float32 (x - mean) * scale, then
    CHW."""
    x = (u8.astype(np.float32) - np.float32(U8_WIRE["mean"])) * \
        np.float32(U8_WIRE["scale"])
    return np.ascontiguousarray(x.transpose(2, 0, 1))


def serve_phase(torch, mt, ck, tmp, image=224, classes=1000, n_requests=32,
                n_threads=4, seed=0):
    sym = mt.models.get_vgg(num_classes=classes)
    shapes = {"data": (1, 3, image, image), "softmax_label": (1,)}
    t0 = time.perf_counter()
    params = xavier_params(sym, shapes, seed)
    n_params = sum(v.size for v in params.values())
    print("serve: VGG-16 %dx%dx3, %d classes, %d parameters made in %.1f s"
          % (image, image, classes, n_params, time.perf_counter() - t0))
    # requests are uint8 HWC images; this float32 engine gets them
    # normalized on the host, the int8/float16 engines of the next phase
    # get the same images on the uint8 wire
    rng = np.random.default_rng(seed + 1)
    wire = [rng.integers(0, 256, (image, image, 3), dtype=np.uint8)
            for _ in range(n_requests)]
    items = [wire_to_nchw(u) for u in wire]
    prefix = os.path.join(tmp, "vgg16")
    t0 = time.perf_counter()
    mt.model.save_checkpoint(
        prefix, 0, sym,
        {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}, {})
    print("serve: checkpoint pair written in %.1f s"
          % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    engine = mt.serve.ServeEngine.from_checkpoint(prefix, 0, shapes,
                                                  fuse=True)
    try:
        print("serve: engine built and warmed (buckets %s) in %.1f s"
              % (engine.buckets, time.perf_counter() - t0))
        fused = [n["op"] for n in json.loads(
            engine._predictor.symbol.tojson())["nodes"]]
        if fused.count("_fused_FullyConnected") != 2:
            fail("serving graph has %d _fused_FullyConnected nodes, want 2"
                 % fused.count("_fused_FullyConnected"))
        answers = [None] * n_requests
        errors = []

        def client(idx):
            try:
                futs = [(i, engine.submit(items[i]))
                        for i in range(idx, n_requests, n_threads)]
                for i, f in futs:
                    answers[i] = f.result(timeout=120)
            except Exception as e:          # reported below, fails the run
                errors.append(repr(e))

        batches_before = engine.stats.report()["batches"]
        ck.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        if errors or any(t.is_alive() for t in threads):
            fail("client errors: %s" % errors)
        report = engine.stats.report()
    finally:
        engine.close()
    batches = report["batches"] - batches_before
    print("serve: %d requests in %.3f s = %.2f req/s; latency p50 %.3f ms "
          "p99 %.3f ms; %d batches, bucket hits %s, occupancy %.3f, pad "
          "waste %.3f" % (n_requests, wall, n_requests / wall,
                          report["latency_p50_ms"], report["latency_p99_ms"],
                          batches, report["bucket_hits"],
                          report["batch_occupancy"],
                          report["pad_waste_frac"]))
    print("serve: launches %s over %d batches" % (launches, batches))
    if batches < 1 or launches["fused_fc_epilogue"] != 2 * batches:
        fail("fused_fc_epilogue launched %d times for %d batches, want 2 "
             "per batch" % (launches["fused_fc_epilogue"], batches))

    # reference: the same parameters, no pass pipeline, on the card, so
    # fc6/fc7 + relu run as torch.matmul + add + relu
    ref_pred = mt.Predictor(sym.tojson(), params,
                            {"data": (8, 3, image, image),
                             "softmax_label": (8,)})
    refs = []
    for i in range(0, n_requests, 8):
        refs.extend(ref_pred.predict(np.stack(items[i:i + 8])))
    del ref_pred
    # Tolerance: both sides compute in float32 (TF32 off) but in other
    # orders: the fc kernel's K split against cuBLAS, and cuDNN's algorithm
    # per batch size (1..8 in the engine, 8 in the reference); float32
    # rounding differences stay near 1e-6 relative through 16 layers, so
    # rtol 1e-3, atol 1e-6 on the softmax output holds every answer while
    # any wrong layer moves the logits by far more.
    worst = 0.0
    for i, (a, r) in enumerate(zip(answers, refs)):
        if a is None or a.shape != (classes,) or not np.all(np.isfinite(a)):
            fail("answer %d malformed: %r" % (i, a))
        if not np.allclose(a, r, rtol=1e-3, atol=1e-6):
            fail("answer %d differs from the unfused reference: max abs "
                 "err %.3g" % (i, np.abs(a - r).max()))
        worst = max(worst, float(np.abs(a - r).max()))
    top = [int(np.argmax(a)) for a in answers]
    same_top = sum(int(t == int(np.argmax(r))) for t, r in zip(top, refs))
    print("serve: all %d answers match the unfused reference (max abs err "
          "%.3g, top-1 equal %d/%d, top-1 prob max %.4f)"
          % (n_requests, worst, same_top, n_requests,
             max(float(np.max(a)) for a in answers)))
    profile_forward(torch, engine._predictor,
                    {"data": (8, 3, image, image), "softmax_label": (8,)},
                    np.stack(items[:8]))
    return {"launches": launches, "batches": batches, "prefix": prefix,
            "answers": answers, "wire": wire, "rps": n_requests / wall,
            "p50": report["latency_p50_ms"], "p99": report["latency_p99_ms"]}


def device_profile(torch, step, reps=3, by_op=None):
    """Wall time of step() (synchronized, no profiler) and its device time
    by kernel from torch.profiler, per step: (wall_ms, device_ms, rows of
    (ms, kernel name, launches)).  A dict ``by_op`` is filled with the
    device time per step of each top-level host op (the kernels it
    launched, its nested ops' included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    # host ops are recorded only for ``by_op``: the rows are the kernels'
    # own events, and parsing every host op of a training step's trace
    # took most of the profiler's cost
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if by_op is not None else [])
    with profile(activities=activities) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue                  # host ops: their kernels are listed
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0:
            rows.append((t / 1e3 / reps, e.key, e.count // reps))
    rows.sort(reverse=True)
    if by_op is not None:
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.cpu_parent is None:
                by_op[e.name] = by_op.get(e.name, 0.0) + \
                    e.device_time_total / 1e3 / reps
    return wall, sum(t for t, _, _ in rows), rows


def print_groups(rows, device, classify, width=12):
    groups = {}
    for t, key, _ in rows:
        group = classify(key.lower())
        groups[group] = groups.get(group, 0.0) + t
    for group, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("profile: group %-*s %8.3f ms  %5.1f%%"
              % (width, group, t, 100.0 * t / device if device else 0.0))
    return groups


def conv_group(name):
    return ("convolution" if any(s in name for s in (
        "fprop", "fft", "conv", "pointwise_mult_and_sum", "xmma",
        "implicit_gemm")) else
            "pooling" if "pool" in name else
            "elementwise" if "elementwise" in name else "other")


# top-level host ops of a serving forward -> what their kernels do: the
# int8 route's im2col is a strided view copied by reshape, after
# F.pad and a channels-last contiguous copy
OP_GROUPS = {"aten::_int_mm": "int8 gemm",
             "aten::reshape": "im2col+pad", "aten::contiguous": "im2col+pad",
             "aten::pad": "im2col+pad", "aten::constant_pad_nd": "im2col+pad",
             "aten::to": "dtype conversions",
             "aten::_to_copy": "dtype conversions",
             "aten::addcmul": "epilogue", "aten::mul": "epilogue",
             "aten::add": "epilogue", "aten::sub": "epilogue",
             "aten::relu": "epilogue", "aten::round": "epilogue",
             "aten::clamp": "epilogue", "aten::full_like": "epilogue",
             "aten::max_pool2d": "pooling", "aten::softmax": "other",
             "aten::conv2d": "convolution", "aten::matmul": "matmul",
             "aten::addmm": "matmul", "aten::linear": "matmul"}


def int8_group(name):
    """Kernel groups of an int8 forward: cuBLASLt's int8 GEMMs behind
    torch._int_mm, the copies of the im2col route (patches, padding,
    layouts), then the float groups."""
    if "fc_epilogue" in name:
        return "fc_epilogue"
    if any(s in name for s in ("s8", "i8", "int8", "imma", "igemm")) and \
            any(s in name for s in ("gemm", "xmma", "cutlass", "kernel")):
        return "int8 gemm"
    if "copy" in name or "pad" in name or "fill" in name:
        return "copies"
    return conv_group(name)


def profile_forward(torch, predictor, shapes, data, reps=3,
                    label="bucket-8 forward", classify=None):
    """Where one bucket-8 forward of a serving graph spends its time:
    wall per forward (synchronized), device time by kernel from
    torch.profiler, and the device's busy share of the wall time."""
    predictor.reshape(shapes)
    predictor.set_input("data", data)
    by_op = {}
    wall, device, rows = device_profile(torch, predictor.forward, reps,
                                        by_op)
    print("profile: %s %.3f ms wall (no profiler); device time %.3f ms per "
          "forward, busy share %.3f"
          % (label, wall, device, device / wall if wall else 0.0))
    for t, key, n in rows[:12]:
        print("profile:   %8.3f ms  %5.1f%%  x%-3d %s"
              % (t, 100.0 * t / device if device else 0.0, n, key[:90]))
    groups = print_groups(rows, device, classify or (lambda name: (
        "fc_epilogue" if "fc_epilogue" in name else conv_group(name))))
    ops = {}
    for name, t in by_op.items():
        group = OP_GROUPS.get(name, "other")
        ops[group] = ops.get(group, 0.0) + t
    print("profile: by host op: %s" % ", ".join(
        "%s %.3f ms" % kv for kv in sorted(ops.items(), key=lambda kv: -kv[1])
        if kv[1] > 0))
    gflop = conv_gflop(predictor.symbol, shapes)
    conv_ms = groups.get("convolution", 0.0)
    if conv_ms:
        print("profile: convolutions %.1f GFLOP per forward, %.1f TFLOP/s "
              "over their device time (peaks: float32 67, float16 dense "
              "989)" % (gflop, gflop / conv_ms))


def conv_gflop(symbol, shapes):
    """Convolution work of one forward: 2 * output elements * (C/g*kh*kw)."""
    internals = symbol.get_internals()
    _, outs, _ = internals.infer_shape(**shapes)
    args = dict(zip(symbol.list_arguments(), symbol.infer_shape(**shapes)[0]))
    total = 0.0
    for (node, _i), oshape in zip(internals._heads, outs):
        if node.op is not None and node.op.name in (
                "Convolution", "_fused_Convolution"):
            wshape = args[node.inputs[1][0].name]
            total += 2.0 * np.prod(oshape) * np.prod(wshape[1:])
    return total / 1e9


# ---------------------------------------------------------------------------
# phase 3 (continued), int8 route: torch._int_mm (and im2col) against its float64 plain version

# VGG-16's convolutions at 224x224: (name, C, H=W, O)
VGG_CONVS = [("conv1_1", 3, 224, 64), ("conv1_2", 64, 224, 64),
             ("conv2_1", 64, 112, 128), ("conv2_2", 128, 112, 128),
             ("conv3_1", 128, 56, 256), ("conv3_2", 256, 56, 256),
             ("conv3_3", 256, 56, 256), ("conv4_1", 256, 28, 512),
             ("conv4_2", 512, 28, 512), ("conv4_3", 512, 28, 512),
             ("conv5_1", 512, 14, 512), ("conv5_2", 512, 14, 512),
             ("conv5_3", 512, 14, 512)]
VGG_FCS = [("fc6", 25088, 4096), ("fc7", 4096, 4096)]


def int8_route_phase(torch, i8, batch=8):
    """The int8 route (ops/int8.py) on the card, bitwise against its
    float64 plain version: VGG-16's conv1_1 (K 27, padded to 32) and
    conv5_3 (K 4608) at bucket 8, fc6 at M 1 and 8, and an adversarial
    case of codes near +127 whose sums pass 2^24, where float32 sums
    are not exact.  Then the route against float32 F.conv2d / addmm (TF32
    off) at every VGG-16 layer shape, bucket 8."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(77)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)

    conv_args = ((1, 1), (1, 1), (1, 1))
    cases = []
    for name, c, hw, o in (VGG_CONVS[0], VGG_CONVS[-1]):
        cases.append(("conv", name, codes((batch, c, hw, hw)),
                      codes((o, c, 3, 3))))
    for m in (1, batch):
        cases.append(("fc", "fc6-M%d" % m, codes((m, 25088)),
                      codes((4096, 25088))))
    # adversarial: 80 % of the codes are +127, the rest random, so the
    # sums reach 5e7 > 2^24 with odd low bits
    near = []
    for shape in ((batch, 512, 14, 14), (512, 512, 3, 3)):
        t = torch.full(shape, 127, dtype=torch.int8, device=dev)
        mask = torch.rand(shape, generator=gen, device=dev) < 0.2
        t[mask] = codes(shape)[mask]
        near.append(t)
    cases.append(("conv", "all-127-past-2^24", near[0], near[1]))
    for kind, name, x, w in cases:
        i8.reset_route_calls()
        got = i8.int8_conv2d(x, w, *conv_args) if kind == "conv" else \
            i8.int8_matmul(x, w)
        calls = dict(i8.ROUTE_CALLS)
        want = i8.int8_conv2d_reference(x, w, *conv_args) if kind == "conv" \
            else i8.int8_matmul_reference(x, w)
        torch.cuda.synchronize()
        same = got.dtype == torch.int32 and bool(torch.equal(got, want))
        peak = int(want.abs().max().item())
        extra = ""
        if name.startswith("all-127"):
            f32 = torch.nn.functional.conv2d(x.float(), w.float(), padding=1)
            extra = ", float32 F.conv2d differs at %d of %d outputs" % (
                int((f32.double() != want.double()).sum().item()),
                want.numel())
            if peak <= 2 ** 24:
                fail("int8 route: the adversarial case stays below 2^24")
        print("int8 route check %-18s %s x %s: equal to float64=%s, "
              "max |sum| %d (2^24 = %d), route calls %s%s"
              % (name, tuple(x.shape), tuple(w.shape), same, peak, 2 ** 24,
                 calls, extra))
        if not same:
            fail("int8 route %s differs from its float64 plain version at "
                 "%d places" % (name, int((got != want).sum().item())))
        if calls["int_mm"] < 1:
            fail("int8 route %s did not call torch._int_mm" % name)
    del cases, near

    flush = torch.zeros(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    rows = []
    for name, c, hw, o in VGG_CONVS:
        x, w = codes((batch, c, hw, hw)), codes((o, c, 3, 3))
        xf, wf = x.float(), w.float()
        rows.append({
            "layer": name, "M": batch * hw * hw, "K": 9 * c, "N": o,
            "route_ms": time_ms(torch, lambda: i8.int8_conv2d(
                x, w, *conv_args), flush),
            "float32_ms": time_ms(torch, lambda: torch.nn.functional.conv2d(
                xf, wf, padding=1), flush)})
    for name, k, n in VGG_FCS:
        x, w = codes((batch, k)), codes((n, k))
        xf, wf = x.float(), w.float()
        bias = torch.zeros(n, device=dev)
        rows.append({
            "layer": name, "M": batch, "K": k, "N": n,
            "route_ms": time_ms(torch, lambda: i8.int8_matmul(x, w), flush),
            "float32_ms": time_ms(torch, lambda: torch.addmm(
                bias, xf, wf.t()), flush)})
    del flush
    for r in rows:
        print("int8 route time %s" % json.dumps(r))
    total = {k: sum(r[k] for r in rows) for k in ("route_ms", "float32_ms")}
    print("int8 route time: all 13 convolutions and fc6 + fc7 at bucket 8: "
          "route %.3f ms, float32 %.3f ms" % (total["route_ms"],
                                              total["float32_ms"]))
    return rows


# ---------------------------------------------------------------------------
# phase 5: int8 and float16 VGG-16 serving (quantize, then fuse)

def serve_burst(engine, items, n_threads=4):
    """items from n_threads client threads; -> (answers, wall seconds)."""
    answers = [None] * len(items)
    errors = []

    def client(idx):
        try:
            futs = [(i, engine.submit(items[i]))
                    for i in range(idx, len(items), n_threads)]
            for i, f in futs:
                answers[i] = f.result(timeout=300)
        except Exception as e:              # reported below, fails the run
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail("client errors: %s" % errors)
    return answers, wall


def graph_census(symbol):
    """(op counts, {weight name: out_scale} of the fused matmul/conv
    nodes with an int8 epilogue, the fused nodes)."""
    nodes = json.loads(symbol.tojson())["nodes"]
    ops = {}
    for n in nodes:
        if n["op"] != "null":
            ops[n["op"]] = ops.get(n["op"], 0) + 1
    fused = [n for n in nodes if n["op"].startswith("_fused_") and
             n["op"] != "_fused_elemwise"]
    scaled = {nodes[n["inputs"][1][0]]["name"]: float(n["param"]["out_scale"])
              for n in fused if "out_scale" in n["param"]}
    return ops, scaled, fused


def run_internals(mt, symbol, params, data, ctx):
    """Bind the internals of ``symbol`` on ``ctx`` (every param at its
    dtype, uint8 data), forward ``data``; -> {output name: CPU tensor}."""
    internals = symbol.get_internals()
    td = {k: np.dtype(v.dtype) for k, v in params.items()}
    td["data"] = np.uint8
    ex = internals.simple_bind(ctx, grad_req="null", type_dict=td,
                               data=data.shape,
                               softmax_label=(data.shape[0],))
    ex.copy_params_from(params, {}, allow_extra_params=True)
    ex.arg_dict["data"][:] = data
    outs = ex.forward(is_train=False)
    return {name: o._get().cpu() for name, o in
            zip(internals.list_outputs(), outs)}


def report_engine(name, engine, n, wall, batches, launches, routes, smi):
    rep = engine.stats.report()
    print("quant %s: %d requests in %.3f s = %.2f req/s; latency p50 %.3f "
          "ms p99 %.3f ms; %d batches, bucket hits %s; launches %s; int8 "
          "route calls %s; card %s"
          % (name, n, wall, n / wall, rep["latency_p50_ms"],
             rep["latency_p99_ms"], batches, rep["bucket_hits"], launches,
             routes, smi))
    return {"rps": n / wall, "p50": rep["latency_p50_ms"],
            "p99": rep["latency_p99_ms"], "batches": batches,
            "launches": launches, "routes": routes}


def top1_agreement(answers, f32_answers):
    agree = sum(int(np.argmax(a) == np.argmax(r))
                for a, r in zip(answers, f32_answers))
    err = max(float(np.abs(a - r).max()) for a, r in zip(answers,
                                                         f32_answers))
    return agree, err


def quantized_serve_phase(torch, mt, ck, i8, served, tmp, smi, image=224,
                          n_threads=4, n_fp16=32, seed=0):
    """Phase 5: the same VGG-16 checkpoint through three more engines on
    the uint8 wire: int8 (every conv and fc6/fc7), int8 with fc6 left
    float (its fused fc kernel then emits the int8 codes fc7 reads), and
    float16.  The int8 engines share one calibration table, computed by
    the first on the card and saved."""
    prefix, wire = served["prefix"], served["wire"]
    n = len(wire)
    shapes = {"data": (1, image, image, 3), "softmax_label": (1,)}
    rng = np.random.default_rng(seed + 2)
    calib = np.stack([rng.integers(0, 256, (image, image, 3),
                                   dtype=np.uint8) for _ in range(16)])
    results = {}

    # (a) int8-default
    t0 = time.perf_counter()
    engine = mt.serve.ServeEngine.from_checkpoint(
        prefix, 0, shapes, quantize="int8", calib_data=calib,
        u8_wire=U8_WIRE, fuse=True)
    try:
        qpass = [p for p in engine.pipeline.passes
                 if p.name == "quantize"][0]
        table = qpass.calib
        table_path = os.path.join(tmp, "vgg16-calib.json")
        table.save(table_path)
        print("quant int8-default: engine built, calibrated on the card "
              "(%d tensors, %d batches of %d) and warmed in %.1f s; table "
              "saved (digest %s)" % (len(table), table.num_batches,
                                     engine.max_batch_size,
                                     time.perf_counter() - t0,
                                     table.digest()[:16]))
        ops, scaled, _fused = graph_census(engine._predictor.symbol)
        print("quant int8-default: serving graph ops %s" % json.dumps(ops))
        print("quant int8-default: int8 epilogues (out_scale) on %s"
              % sorted(k[:-len("_weight")] for k in scaled))
        want_scaled = ["conv1_1", "conv2_1", "conv3_1", "conv3_2", "conv4_1",
                       "conv4_2", "conv5_1", "conv5_2", "fc6"]
        if ops.get("_fused_quantized_Convolution") != 13 or \
                ops.get("_fused_quantized_FullyConnected") != 2 or \
                ops.get("FullyConnected") != 1:
            fail("int8-default graph: want 13 + 2 fused int8 nodes and fc8 "
                 "float, got %s" % ops)
        if sorted(k[:-len("_weight")] for k in scaled) != want_scaled:
            fail("int8-default graph: out_scale on %s, want %s"
                 % (sorted(scaled), want_scaled))
        before = engine.stats.report()["batches"]
        ck.reset_launches()
        i8.reset_route_calls()
        answers, wall = serve_burst(engine, wire, n_threads)
        launches, routes = dict(ck.LAUNCHES), dict(i8.ROUTE_CALLS)
        batches = engine.stats.report()["batches"] - before
        results["int8-default"] = report_engine(
            "int8-default", engine, n, wall, batches, launches, routes, smi)
        if launches["fused_fc_epilogue"] != 0:
            fail("int8-default launched fused_fc_epilogue %d times: no fc "
                 "layer there is float with an int8 epilogue"
                 % launches["fused_fc_epilogue"])
        if routes != {"int_mm": 15 * batches, "im2col": 13 * batches}:
            fail("int8-default: route calls %s for %d batches, want 15 "
                 "_int_mm and 13 im2col a batch" % (routes, batches))
        print("quant int8-default: route calls per batch: %d _int_mm (13 "
              "conv + 2 fc), %d im2col; fused_fc_epilogue 0 (fc8 is float "
              "FullyConnected, and no float fc layer feeds an int8 one)"
              % (routes["int_mm"] // batches, routes["im2col"] // batches))
        for a in answers:
            if a is None or a.shape != (1000,) or not np.all(np.isfinite(a)):
                fail("int8-default answer malformed: %r" % (a,))
        agree, err = top1_agreement(answers, served["answers"])
        print("quant int8-default: top-1 equal to the float32 engine's on "
              "%d/%d (not gated: random weights), max abs softmax diff %.3g"
              % (agree, n, err))

        # codes: two samples at batch 1, card against CPU, one table
        cpu_pipe = mt.passes.build_serving_pipeline(
            quantize={"calib": mt.passes.CalibrationTable.load(table_path),
                      "ops": ("FullyConnected", "Convolution")},
            u8_wire=U8_WIRE, fuse=True, ctx=mt.cpu())
        sym_json, params = mt.predictor.load_checkpoint_pair(prefix, 0)
        t0 = time.perf_counter()
        cpu_sym, cpu_params = cpu_pipe.run(mt.sym.load_json(sym_json),
                                           params)
        card_sym = engine._predictor.symbol
        a_doc, b_doc = (json.loads(s.tojson()) for s in (card_sym, cpu_sym))
        a_doc["attrs"].pop("__passes__")
        b_doc["attrs"].pop("__passes__")
        if a_doc != b_doc:
            fail("int8-default: the CPU pipeline's graph differs from the "
                 "card's")
        card_params = dict(engine._predictor._arg_params)
        int8_nodes = [nm + "_output" for nm, nd in
                      ((x["name"], x) for x in a_doc["nodes"])
                      if nd["op"].startswith("_fused_quantized")]
        n_int8 = n_float = 0
        float_diff = 0.0
        for i in range(2):
            x = wire[i][None]
            got = run_internals(mt, card_sym, card_params, x, mt.gpu(0))
            want = run_internals(mt, cpu_sym, cpu_params, x, mt.cpu())
            for name in int8_nodes:
                g, w_ = got[name], want[name]
                if g.dtype == torch.int8:
                    n_int8 += 1
                    if not torch.equal(g, w_):
                        fail("int8-default sample %d: %s codes differ from "
                             "the CPU run at %d places" % (
                                 i, name, int((g != w_).sum().item())))
                else:
                    n_float += 1
                    float_diff = max(float_diff, float(
                        (g.double() - w_.double()).abs().max().item()))
            g, w_ = got["softmax_output"].numpy(), \
                want["softmax_output"].numpy()
            if not np.allclose(g, w_, rtol=1e-3, atol=1e-6) or \
                    not np.allclose(answers[i], w_[0], rtol=1e-3, atol=1e-6):
                fail("int8-default sample %d: softmax differs from the CPU "
                     "run (max abs %.3g, served %.3g)" % (
                         i, np.abs(g - w_).max(),
                         np.abs(answers[i] - w_[0]).max()))
        print("quant int8-default check: 2 samples at batch 1, card against "
              "CPU with one table: %d int8 outputs of _fused_quantized_* "
              "nodes bitwise equal; %d float outputs max abs diff %.3g; "
              "softmax and served answers within rtol 1e-3 atol 1e-6 "
              "(%.1f s)" % (n_int8, n_float, float_diff,
                            time.perf_counter() - t0))
        del cpu_params, got, want
        profile_forward(
            torch, engine._predictor,
            {"data": (8, image, image, 3), "softmax_label": (8,)},
            np.stack(wire[:8]), label="int8-default bucket-8 forward",
            classify=int8_group)
    finally:
        engine.close()

    # (b) int8-skip-fc6: fc6 float, its fused fc kernel emits fc7's codes
    t0 = time.perf_counter()
    engine = mt.serve.ServeEngine.from_checkpoint(
        prefix, 0, shapes, u8_wire=U8_WIRE, fuse=True,
        quantize={"calib": mt.passes.CalibrationTable.load(table_path),
                  "skip": ("fc6",)})
    try:
        print("quant int8-skip-fc6: engine built and warmed in %.1f s"
              % (time.perf_counter() - t0))
        ops, scaled, fused = graph_census(engine._predictor.symbol)
        print("quant int8-skip-fc6: serving graph ops %s" % json.dumps(ops))
        fc_nodes = [f for f in fused if f["op"] == "_fused_FullyConnected"]
        if len(fc_nodes) != 1 or "out_scale" not in fc_nodes[0]["param"]:
            fail("int8-skip-fc6 graph: want one _fused_FullyConnected with "
                 "out_scale, got %s" % [f["param"] for f in fc_nodes])
        before = engine.stats.report()["batches"]
        ck.reset_launches()
        i8.reset_route_calls()
        answers, wall = serve_burst(engine, wire, n_threads)
        launches, routes = dict(ck.LAUNCHES), dict(i8.ROUTE_CALLS)
        batches = engine.stats.report()["batches"] - before
        results["int8-skip-fc6"] = report_engine(
            "int8-skip-fc6", engine, n, wall, batches, launches, routes, smi)
        if launches["fused_fc_epilogue"] != batches:
            fail("int8-skip-fc6: fused_fc_epilogue launched %d times for %d "
                 "batches, want 1 per batch" % (launches["fused_fc_epilogue"],
                                                batches))
        agree, err = top1_agreement(answers, served["answers"])
        print("quant int8-skip-fc6: top-1 equal to the float32 engine's on "
              "%d/%d (not gated), max abs softmax diff %.3g"
              % (agree, n, err))
        fc6_int8_check(torch, mt, ck, engine, fc_nodes[0],
                       np.stack(wire[:8]))
        profile_forward(
            torch, engine._predictor,
            {"data": (8, image, image, 3), "softmax_label": (8,)},
            np.stack(wire[:8]), label="int8-skip-fc6 bucket-8 forward",
            classify=int8_group)
    finally:
        engine.close()

    # (c) float16
    t0 = time.perf_counter()
    engine = mt.serve.ServeEngine.from_checkpoint(
        prefix, 0, shapes, quantize="float16", u8_wire=U8_WIRE, fuse=True)
    try:
        ops, _scaled, _fused = graph_census(engine._predictor.symbol)
        print("quant float16: engine built and warmed in %.1f s; serving "
              "graph ops %s" % (time.perf_counter() - t0, json.dumps(ops)))
        before = engine.stats.report()["batches"]
        ck.reset_launches()
        i8.reset_route_calls()
        answers, wall = serve_burst(engine, wire[:n_fp16], n_threads)
        launches, routes = dict(ck.LAUNCHES), dict(i8.ROUTE_CALLS)
        batches = engine.stats.report()["batches"] - before
        results["float16"] = report_engine(
            "float16", engine, n_fp16, wall, batches, launches, routes, smi)
        bad = [i for i, a in enumerate(answers)
               if a is None or a.shape != (1000,) or
               not np.all(np.isfinite(a))]
        if bad:
            fail("float16: answers %s are not finite" % bad)
        agree, err = top1_agreement(answers, served["answers"])
        print("quant float16: all %d answers finite; top-1 equal to the "
              "float32 engine's on %d/%d, max abs softmax diff %.3g"
              % (n_fp16, agree, n_fp16, err))
        profile_forward(
            torch, engine._predictor,
            {"data": (8, image, image, 3), "softmax_label": (8,)},
            np.stack(wire[:8]), label="float16 bucket-8 forward")
    finally:
        engine.close()
    return results


def fc6_int8_check(torch, mt, ck, engine, node, data8):
    """fc6's int8 epilogue on the path: the codes of the fused fc kernel
    at bucket 8 against requantize() of its own float output (bitwise:
    the same sums, then the same multiply and rounding) and against the
    plain version (float32 sums in cuBLAS's order: a code may move by one
    only where the value sits within the float tolerance of a rounding
    tie).  Then the int8 epilogue's time beside the float one."""
    sym = engine._predictor.symbol
    nodes = json.loads(sym.tojson())["nodes"]
    src = nodes[node["inputs"][0][0]]
    in_name = src["name"] + ("_output" if src["op"] != "null" else "")
    params = dict(engine._predictor._arg_params)
    outs = run_internals(mt, sym, params, data8, mt.gpu(0))
    dev = torch.device("cuda", 0)
    x = outs[in_name].to(dev).reshape(data8.shape[0], -1).contiguous()
    codes = outs[node["name"] + "_output"].to(dev)
    w = params["fc6_weight"]._get().to(dev)
    b = params["fc6_bias"]._get().to(dev)
    s = float(node["param"]["out_scale"])
    again = ck.fused_fc_epilogue(x, w, b, "relu", s)
    y = ck.fused_fc_epilogue(x, w, b, "relu")
    plain = ck.fused_fc_epilogue_reference(x, w, b, "relu", s)
    y_plain = ck.fused_fc_epilogue_reference(x, w, b, "relu")
    torch.cuda.synchronize()
    if not (torch.equal(again, codes) and
            torch.equal(ck.requantize(y, s), codes)):
        fail("fc6 int8 epilogue: the kernel's codes differ from "
             "requantize() of its float output")
    diff = (codes.int() - plain.int()).abs()
    # float tolerance of phase 3: 1e-4 * max(1, max|plain|), in code units
    tol = 1e-4 * max(1.0, float(y_plain.abs().max().item())) * \
        ck.reciprocal_f32(s)
    frac = (y_plain.double() * ck.reciprocal_f32(s)).remainder(1.0)
    near_tie = (frac - 0.5).abs() <= tol
    moved = diff > 0
    print("quant int8-skip-fc6 check: fc6 at M=%d K=%d N=%d, out_scale %.6g:"
          " kernel codes equal requantize(kernel float output) bitwise; "
          "against the plain version %d of %d codes equal, %d differ by 1 "
          "(each within %.3g code units of a tie), max |d| %d"
          % (x.shape[0], x.shape[1], w.shape[0], s,
             int((~moved).sum().item()), codes.numel(),
             int(moved.sum().item()), tol, int(diff.max().item())))
    if int(diff.max().item()) > 1 or bool((moved & ~near_tie).any()):
        fail("fc6 int8 epilogue: codes differ from the plain version away "
             "from a rounding tie")
    flush = torch.zeros(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    row = {"shape": "fc6", "M": x.shape[0], "K": x.shape[1], "N": w.shape[0],
           "float_ms": time_ms(torch, lambda: ck.fused_fc_epilogue(
               x, w, b, "relu"), flush),
           "int8_ms": time_ms(torch, lambda: ck.fused_fc_epilogue(
               x, w, b, "relu", s), flush),
           "plain_int8_ms": time_ms(torch, lambda: ck.fused_fc_epilogue_reference(
               x, w, b, "relu", s), flush),
           "bound_int8_ms": fc_bound_ms(x, w, b, codes)}
    del flush
    print("kernel time fc6 int8 epilogue: %s" % json.dumps(row))


# ---------------------------------------------------------------------------
# phase 6: paged_attention against its plain version

def engine_positions(np_lengths, c):
    """q_pos as the engine builds it: each slot's last min(c, length)
    positions, the rows past them at position 0."""
    q_pos = np.zeros((len(np_lengths), c), np.int32)
    for i, n in enumerate(np_lengths):
        nv = min(c, int(n))
        q_pos[i, :nv] = n - nv + np.arange(nv)
    return q_pos


def paged_case(torch, dev, seed, lengths, c, h=12, d=64, bt=16, b=64,
               blocks=None, scatter=True):
    """A paged-KV scenario on the card: pools of ``blocks`` real blocks
    plus the sentinel scratch row (filled with large finite values, which
    the lengths must mask), each slot's blocks assigned from a permutation
    (scatter) or as stripes, unassigned entries at the sentinel."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    s = len(lengths)
    need = [-(-int(n) // bt) for n in lengths]
    blocks = blocks or max(sum(need), 1)
    pages = np.full((s, b), blocks, np.int32)
    order = rng.permutation(blocks) if scatter else np.arange(blocks)
    nxt = 0
    for i, n in enumerate(need):
        pages[i, :n] = order[nxt:nxt + n]
        nxt += n
    gen = torch.Generator(device=dev).manual_seed(seed)
    k_pool = torch.randn((blocks + 1, bt, h, d), generator=gen, device=dev)
    v_pool = torch.randn((blocks + 1, bt, h, d), generator=gen, device=dev)
    k_pool[blocks] = 1e4
    v_pool[blocks] = 1e4
    q = torch.randn((s, c, h, d), generator=gen, device=dev)
    q_pos = engine_positions(lengths, c)
    return {"q": q, "k_pool": k_pool, "v_pool": v_pool,
            "pages": torch.from_numpy(pages).to(dev),
            "lengths": torch.from_numpy(lengths).to(dev),
            "q_pos": torch.from_numpy(q_pos).to(dev),
            "np_lengths": lengths, "np_q_pos": q_pos}


def paged_args(case):
    return (case["q"], case["k_pool"], case["v_pool"], case["pages"],
            case["lengths"], case["q_pos"])


def paged_bound_ms(case, causal=True):
    """Least time for the work this case's data needs: each slot's
    visible keys' K and V read once (a key is visible to some row when
    it lies below the length and, causally, at or below that row's
    position), q read, out written, each at its element size; 4·D flops
    per (row, visible key, head), at float32's rate over float32 pools and
    as half_attention_flops_ms says over 16-bit ones."""
    q = case["q"]
    s, c, h, d = q.shape
    lengths, q_pos = case["np_lengths"], case["np_q_pos"]
    cap = case["pages"].shape[1] * case["k_pool"].shape[1]
    seen = np.minimum(lengths[:, None], cap)
    if causal:
        seen = np.minimum(seen, q_pos + 1)
    seen = np.maximum(seen, 0)
    keys_read = seen.max(axis=1).sum()
    kv_size, q_size = case["k_pool"].element_size(), q.element_size()
    nbytes = (2 * keys_read * h * d * kv_size + 2 * q.numel() * q_size
              + case["pages"].numel() * 4 + lengths.size * 4 + q_pos.size * 4)
    flops = 4.0 * h * d * float(seen.sum())
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_flops = 1e3 * flops / PEAK_F32_FLOPS if kv_size == 4 else \
        half_attention_flops_ms(flops, q_size)
    return max(by_bytes, by_flops), ("bytes" if by_bytes >= by_flops
                                     else "operations")


def sdpa_library(torch, case, causal=True):
    """The same function as one library attention call after a gather:
    page-table gather + F.scaled_dot_product_attention with a boolean
    mask.  A yardstick only (rows with no visible key give NaN there)."""
    import torch.nn.functional as F
    q, kp, vp, pages, lengths, q_pos = paged_args(case)
    s, c, h, d = q.shape
    n, bt = kp.shape[0], kp.shape[1]
    b = pages.shape[1]
    safe = pages.long().clamp(0, n - 1)
    k_idx = torch.arange(b * bt, device=q.device)
    mask = (k_idx[None, :] < lengths.long()[:, None])[:, None, None, :]
    if causal:
        mask = mask & (k_idx[None, None, :]
                       <= q_pos.long()[:, :, None])[:, None]

    def call():
        kg = kp[safe].reshape(s, b * bt, h, d).transpose(1, 2)
        vg = vp[safe].reshape(s, b * bt, h, d).transpose(1, 2)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kg, vg,
                                              attn_mask=mask)
    return call


# the LLM path's contexts: 16 slots from 1 to 1024 keys
PAGED_SPREAD = np.linspace(1, 1024, 16).round().astype(np.int32)


def paged_time_case(torch, dev, c):
    """The case each ``kernel time paged_attention`` row times at C = c
    (kernel_ab.py times the same)."""
    return paged_case(torch, dev, 30 + c, PAGED_SPREAD, c, blocks=1100)


def paged_layout_checks(torch, ck, dev, spread=PAGED_SPREAD, dtype=None):
    """Bitwise layout invariance on the card: the same logical cache as
    stripes and scattered gives identical floats; two calls give
    identical floats.  At the path's shape for each C, and at C = 1 for
    the decode kernel's other head-dim buckets.  Phase 6 runs it with the
    default partitions, phase 24 with the searched winner loaded, phase
    28 with q and the pools in ``dtype`` (float16, bfloat16), where C > 1
    also runs at D 128 and 32."""
    layouts = [(c, spread, {}) for c in (1, 9, 32)] + [
        (1, spread, dict(h=4, d=128)), (1, spread, dict(h=6, d=32)),
        (1, np.minimum(spread, 512), dict(h=3, d=10, b=32))]
    if dtype is not None:
        layouts += [(9, spread, dict(h=4, d=128)),
                    (32, spread, dict(h=6, d=32))]
    for c, lens, kw in layouts:
        dense = paged_case(torch, dev, 21, lens, c, scatter=False, **kw)
        if dtype is not None:
            for key in ("q", "k_pool", "v_pool"):
                dense[key] = dense[key].to(dtype)
        nb = dense["k_pool"].shape[0] - 1          # the sentinel block last
        perm = torch.randperm(nb, generator=torch.Generator().manual_seed(
            c)).to(dev)
        moved = dict(dense)
        moved["k_pool"] = dense["k_pool"].clone()
        moved["v_pool"] = dense["v_pool"].clone()
        moved["k_pool"][perm] = dense["k_pool"][:nb]
        moved["v_pool"][perm] = dense["v_pool"][:nb]
        pages = dense["pages"].long()
        moved["pages"] = torch.where(pages < nb,
                                     perm[pages.clamp(max=nb - 1)],
                                     pages).to(torch.int32).contiguous()
        a = ck.paged_attention(*paged_args(dense))
        b = ck.paged_attention(*paged_args(moved))
        a2 = ck.paged_attention(*paged_args(dense))
        torch.cuda.synchronize()
        same = bool(torch.equal(a, b))
        again = bool(torch.equal(a, a2))
        d = dense["q"].shape[3]
        print("kernel check paged layout-invariance C=%d D=%d %s: stripes "
              "and scattered bitwise equal=%s; two calls bitwise equal=%s"
              % (c, d, a.dtype, same, again))
        if not same:
            fail("paged_attention output depends on the page layout "
                 "(C=%d D=%d, max diff %.3g)"
                 % (c, d, (a - b).abs().max().item()))
        if not again:
            fail("paged_attention is not bitwise repeatable (C=%d D=%d)"
                 % (c, d))


def paged_kernel_phase(torch, ck):
    dev = torch.device("cuda", 0)
    # Tolerance: the kernel walks keys in chunks with an online softmax
    # (running max, rescaled sums), the plain version takes one global
    # max and sums in einsum's order; both in float32 over at most 1024
    # keys of 64-wide dot products, so they differ by a few ulps of the
    # O(1) outputs: 1e-5 * max(1, max|plain|).
    tol_rel = 1e-5
    spread = PAGED_SPREAD
    cases = []
    for c in (1, 9, 32):
        cases.append(("main-C%d" % c, dict(seed=c, lengths=spread, c=c,
                                           blocks=1100), True, True))
    ragged = np.array([0, 1, 7, 15, 16, 17, 31, 33, 100, 257, 511, 513,
                       999, 1023, 1024, 5], np.int32)
    # the split-K partitions' edges: lengths of exactly P, P - 1, P + 1;
    # a causal window straddling a boundary (P + 4 at C = 9, 2P + 10 and
    # 3P + 16 at C = 32); an empty slot beside one at the page table's
    # full width (64 blocks x 16 = 1024 keys)
    part = ck.PAGED_PARTITION_KEYS
    edges = np.array([part, part - 1, part + 1, 0, 1024, part + 4,
                      2 * part + 10, 3 * part + 16], np.int32)
    for c in (1, 9, 32):
        cases.append(("part-edges-C%d" % c, dict(seed=40 + c, lengths=edges,
                                                 c=c), True, False))
    cases.append(("part-edges-full", dict(seed=49, lengths=edges, c=9),
                  False, False))
    # decode (C = 1) at each head-dim bucket of its kernel, over several
    # partitions and the merge: D 128 (two warps a block), D 32, and D 10
    # through the scalar copies, on a 512-key page table
    half = np.array([part, part - 1, part + 1, 0, 512, part + 4, 511, 1],
                    np.int32)
    cases += [
        ("C1-D128", dict(seed=17, lengths=edges, c=1, h=4, d=128), True,
         False),
        ("C1-D32", dict(seed=18, lengths=edges, c=1, h=6, d=32), True, False),
        ("C1-D10", dict(seed=19, lengths=half, c=1, h=3, d=10, b=32), True,
         False),
    ]
    cases += [
        ("ragged-C1", dict(seed=11, lengths=ragged, c=1), True, False),
        ("ragged-C32", dict(seed=12, lengths=ragged, c=32), True, False),
        ("ragged-full", dict(seed=13, lengths=ragged, c=9), False, False),
        ("C>len", dict(seed=14, lengths=[3, 0, 2, 40], c=32), True, False),
        ("bt8-D128", dict(seed=15, lengths=[9, 200, 64], c=9, h=4, d=128,
                          bt=8, b=32), True, False),
        ("D10-scalar", dict(seed=16, lengths=[5, 77, 33], c=4, h=3, d=10,
                            bt=16, b=8), True, False),
    ]
    main_err = 0.0
    for name, kw, causal, main in cases:
        case = paged_case(torch, dev, **kw)
        out = ck.paged_attention(*paged_args(case), causal=causal)
        ref = ck.paged_attention_reference(*paged_args(case), causal=causal)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = tol_rel * max(1.0, ref.abs().max().item())
        empty = case["np_lengths"] == 0
        zeros = bool((out[torch.from_numpy(empty).to(dev)] == 0).all())
        print("kernel check paged %-12s S=%-2d C=%-2d H=%-2d D=%-3d bt=%-2d "
              "causal=%d max_abs_err=%.3g tol=%.3g finite=%s empty-zero=%s"
              % (name, out.shape[0], out.shape[1], out.shape[2],
                 out.shape[3], case["k_pool"].shape[1], causal, err, tol,
                 bool(torch.isfinite(out).all()), zeros))
        if not (err <= tol and torch.isfinite(out).all() and zeros):
            fail("paged %s: max_abs_err %.3g > tol %.3g, or non-finite, "
                 "or an empty slot not zero" % (name, err, tol))
        if main:
            main_err = max(main_err, err)

    paged_layout_checks(torch, ck, dev)

    flush = torch.zeros(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    rows = []
    for c in (1, 9, 32):
        case = paged_time_case(torch, dev, c)
        bound, bound_by = paged_bound_ms(case)
        cap = case["pages"].shape[1] * case["k_pool"].shape[1]
        n_part = ck.paged_partitions(c, cap)
        row = {
            "shape": "S=16 C=%d H=12 D=64 bt=16 ctx=1..1024" % c, "C": c,
            "partitions": n_part,
            "ms": time_ms(torch, lambda: ck.paged_attention(
                *paged_args(case)), flush),
            "earlier_ms": EARLIER_PAGED_MS[c], "earlier_from": EARLIER_FROM,
            "plain_ms": time_ms(torch, lambda: ck.paged_attention_reference(
                *paged_args(case)), flush),
            "library_ms": time_ms(torch, sdpa_library(torch, case), flush),
            "bound_ms": bound, "bound_by": bound_by,
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print("kernel time paged_attention %s" % json.dumps(row))
        rows.append(row)
        # does split-K pay at this C: the kernel with P-key partitions
        # against one pass per (slot, head, row tile), in turns
        split = [-(-cap // ck.PAGED_PARTITION_KEYS), 1]
        ab = {}
        for n in split + split[::-1]:
            ab.setdefault(n, []).append(time_ms(
                torch, lambda: ck._launch_paged(*paged_args(case), True, n),
                flush))
        print("kernel time paged_attention split-K C=%d: %s" % (c, json.dumps(
            {"partitions=%d" % n: ts for n, ts in ab.items()})))
    del flush
    timed = [r for r in rows if r["C"] in (1, 32)]
    by_bytes = sum(r["bound_ms"] for r in timed if r["bound_by"] == "bytes")
    return {"max_abs_err": main_err,
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "library_ms": sum(r["library_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": "bytes" if 2 * by_bytes >= sum(
                r["bound_ms"] for r in timed) else "operations",
            "rows": rows}


# ---------------------------------------------------------------------------
# phase 7: serve an LM at GPT-2-small geometry through PagedDecodeEngine

# GPT-2 small's published geometry (openai-community/gpt2 config.json:
# n_embd 768, n_head 12, n_layer 12, n_positions 1024, vocab_size 50257);
# the layers are the repo's (RMSNorm, no biases, tanh GELU, tied unembed)
LM_GEOMETRY = dict(vocab=50257, dim=768, heads=12, layers=12,
                   max_context=1024)
LM_SLOTS = 16
LM_BLOCK_TOKENS = 16
LM_POOL_BLOCKS = 512            # half the dense equivalent, 16 * 64
LM_CHUNK = 32
LM_SPEC_K = 8
LM_MAX_NEW = 64
LM_STREAMS = 32
LM_THREADS = 4
# bench_llm.py's chat/document mix stretched over the 1024 context
LM_PROMPT_LENS = (4, 134, 410, 58, 640, 211, 13, 96, 512, 38, 307, 77,
                  900, 26, 160, 9)
# Logits tolerance: the kernel and the plain version differ by a few ulps
# in each layer's attention output (see paged_kernel_phase); 12 layers of
# float32 GEMMs (K <= 3072) carry that into logits of magnitude ~1 as
# differences near 1e-6 relative, so 1e-4 * max(1, max|logits|) holds a
# right kernel while a wrong mask or page moves logits by far more.
LOGIT_TOL_REL = 1e-4


def run_streams(ck, engine, prompts):
    """32 streams from 4 client threads through one engine; the kernels'
    launch counts and the engine's forward counts read around exactly
    this run."""
    answers = [None] * len(prompts)
    errors = []

    def client(idx):
        try:
            futs = [(i, engine.submit(prompts[i], max_new_tokens=LM_MAX_NEW))
                    for i in range(idx, len(prompts), LM_THREADS)]
            for i, f in futs:
                answers[i] = f.result(timeout=300)
        except Exception as e:              # reported below, fails the run
            errors.append(repr(e))

    before = dict(engine.forward_counts)
    ck.reset_launches()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(LM_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    after = dict(engine.forward_counts)
    if errors or any(t.is_alive() for t in threads):
        fail("LM client errors: %s" % errors)
    return {"streams": answers, "wall": wall, "launches": launches,
            "target_steps": after["target"] - before["target"],
            "draft_steps": after["draft"] - before["draft"],
            "report": engine.stats.report(),
            "kv_bytes": engine.pool.device_bytes()}


def top2_margin(torch, pdev, cfg, prompt, stream, i, dev):
    """Replay prompt + stream[:i] teacher-forced through the plain model
    (whole-sequence causal attention) and return the top-2 margin of the
    logits that choose token i, with the logits tolerance there."""
    from mxnet_tpu_torch.serve.paged import causal_attend, lm_forward
    seq = np.concatenate([prompt, np.asarray(stream[:i], np.int64)])
    tokens = torch.from_numpy(seq[None]).to(dev)
    positions = torch.arange(len(seq), device=dev)[None]
    with torch.no_grad():
        logits = lm_forward(pdev, tokens, positions, causal_attend,
                            cfg)[0, -1]
    top = torch.topk(logits, 2).values
    return ((top[0] - top[1]).item(),
            LOGIT_TOL_REL * max(1.0, logits.abs().max().item()))


def teacher_forced_phase(torch, ck, pdev, cfg, dev):
    """paged_forward with the kernel and with the plain version on cloned
    pools, for one prefill-chunk window (C=32) and one decode window
    (C=1), after contexts spread over 0..880 tokens were prefilled through
    the kernel path into a 512-block pool whose blocks interleave across
    slots as the engine assigns them.  Returns each window's arguments
    and pool state, for the profile."""
    from mxnet_tpu_torch.serve.paged import KVBlockPool, paged_forward
    s, bt, c = LM_SLOTS, LM_BLOCK_TOKENS, LM_CHUNK
    ctx = np.linspace(0, 880, s).round().astype(np.int64)
    pool = KVBlockPool(s, cfg.max_context // bt, num_blocks=LM_POOL_BLOCKS,
                       block_tokens=bt, device=dev)
    pool.add_view("target", cfg.layers, cfg.heads, cfg.head_dim)
    rng = np.random.default_rng(5)
    for i in range(s):
        if not pool.reserve(i, pool.blocks_for(ctx[i] + c + 1)):
            fail("teacher-forced contexts do not fit the pool")
    seqs = [rng.integers(0, cfg.vocab, size=int(ctx[i]) + c + 1)
            for i in range(s)]
    kv_k, kv_v = pool.view("target")

    def window(starts, widths, width):
        tokens = np.zeros((s, width), np.int32)
        positions = np.zeros((s, width), np.int32)
        for i in range(s):
            nv = int(widths[i])
            tokens[i, :nv] = seqs[i][starts[i]:starts[i] + nv]
            positions[i, :nv] = starts[i] + np.arange(nv)
        n_valid = np.asarray(widths, np.int32)
        lengths = (np.asarray(starts) + n_valid).astype(np.int32)
        for i in range(s):          # blocks interleave across slots
            pool.ensure(i, int(lengths[i]))
        return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
                (tokens, pool.page_table(), positions, n_valid, lengths)]

    done = np.zeros(s, np.int64)
    with torch.no_grad():
        while (done < ctx).any():
            widths = np.minimum(c, ctx - done)
            paged_forward(pdev, kv_k, kv_v, *window(done, widths, c),
                          cfg=cfg, use_kernel=True)
            done += widths
        windows = {}
        for label, width in (("prefill-chunk", c), ("decode", 1)):
            widths = np.full(s, width)
            args = window(done, widths, width)
            kk, vk = kv_k.clone(), kv_v.clone()
            kp, vp = kv_k.clone(), kv_v.clone()
            windows[width] = (args, kv_k.clone(), kv_v.clone())
            a = paged_forward(pdev, kk, vk, *args, cfg=cfg, use_kernel=True)
            b = paged_forward(pdev, kp, vp, *args, cfg=cfg, use_kernel=False)
            torch.cuda.synchronize()
            err = (a - b).abs().max().item()
            tol = LOGIT_TOL_REL * max(1.0, b.abs().max().item())
            top = torch.topk(b, 2, dim=-1).values
            decided = (top[..., 0] - top[..., 1]) > tol
            same = (a.argmax(-1) == b.argmax(-1)) | ~decided
            print("teacher-forced %-13s C=%-2d contexts %d..%d: logits "
                  "max_abs_err=%.3g tol=%.3g (max|logits| %.3f); argmax "
                  "equal at %d of %d decided rows (%d rows within tol)"
                  % (label, width, int(done.min()), int(done.max()), err,
                     tol, b.abs().max().item(),
                     int(((a.argmax(-1) == b.argmax(-1)) & decided).sum()),
                     int(decided.sum()), int((~decided).sum())))
            if not (err <= tol and bool(same.all())
                    and bool(torch.isfinite(a).all())):
                fail("teacher-forced %s: kernel logits differ from the "
                     "plain version's (err %.3g, tol %.3g)" % (label, err,
                                                               tol))
            kv_k.copy_(kk)
            kv_v.copy_(vk)
            done += widths
    return windows


def profile_step(torch, pdev, cfg, window, reps=3):
    """Where one step of the 12-layer model over ``window`` (16 slots of
    C tokens) spends its device time, by kernel group, and its wall time
    without the profiler (ending in the host copy of the tokens, as the
    engine's step does)."""
    from mxnet_tpu_torch.serve.paged import paged_step
    args, kv_k, kv_v = window
    c = args[0].shape[1]

    def step():
        return paged_step(pdev, kv_k, kv_v, *args, cfg=cfg,
                          use_kernel=True).cpu()

    with torch.no_grad():
        wall, device, rows = device_profile(torch, step, reps)
    print("profile: LM step C=%d (16 slots x %d tokens, 12 layers) %.3f ms "
          "wall (no profiler); device time %.3f ms per step, busy share "
          "%.3f" % (c, c, wall, device, device / wall if wall else 0.0))
    for t, key, n in rows[:8]:
        print("profile:   %8.3f ms  %5.1f%%  x%-3d %s"
              % (t, 100.0 * t / device if device else 0.0, n, key[:80]))
    groups = print_groups(rows, device, lambda name: (
        "paged_attention" if "paged_attention" in name else
        "gemm" if any(w in name for w in (
            "gemm", "cutlass", "xmma", "gemv")) else
        "index/gather/scatter" if any(w in name for w in (
            "index", "gather", "scatter")) else
        "reduce/argmax" if "reduce" in name or "argmax" in name
        else "elementwise" if "elementwise" in name else "other"), 22)
    return {"wall_ms": wall, "device_ms": device, "groups": groups}


def llm_phase(torch, ck):
    from mxnet_tpu_torch.convert import convert_lm_params
    from mxnet_tpu_torch.serve import (LMConfig, PagedDecodeEngine,
                                       init_lm_params)
    dev = torch.device("cuda", 0)
    cfg = LMConfig(**LM_GEOMETRY)
    draft_cfg = cfg._replace(layers=1)
    t0 = time.perf_counter()
    params = init_lm_params(cfg, seed=0, scale=0.005)
    # bench_llm.py's draft: one layer sharing the embedding and positions
    draft = init_lm_params(draft_cfg, seed=1, scale=0.005,
                           embed=params["embed"])
    draft["pos"] = params["pos"].copy()
    print("llm: LMConfig%s, %d float32 parameters (draft %d) made in %.1f s"
          % (tuple(cfg), sum(v.size for v in params.values()),
             sum(v.size for v in draft.values()), time.perf_counter() - t0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=LM_PROMPT_LENS[
        i % len(LM_PROMPT_LENS)]).astype(np.int64)
        for i in range(LM_STREAMS)]
    runs = {}
    for label, kw in (
            ("paged", dict(num_blocks=LM_POOL_BLOCKS)),
            ("dense", dict(paged=False)),
            ("spec", dict(num_blocks=LM_POOL_BLOCKS, draft_params=draft,
                          draft_cfg=draft_cfg, spec_k=LM_SPEC_K,
                          chunk_tokens=LM_SPEC_K + 1))):
        kw.setdefault("chunk_tokens", LM_CHUNK)
        t0 = time.perf_counter()
        eng = PagedDecodeEngine(params, cfg, num_slots=LM_SLOTS,
                                block_tokens=LM_BLOCK_TOKENS,
                                max_new_tokens=LM_MAX_NEW,
                                name="llm-" + label, **kw)
        try:
            if not eng.use_kernel:
                fail("the engine on %s does not use the kernel" % eng.device)
            built = time.perf_counter() - t0
            run = run_streams(ck, eng, prompts)
        finally:
            eng.close()
        del eng
        torch.cuda.empty_cache()
        rep = run["report"]
        tokens = sum(len(x) for x in run["streams"])
        want = cfg.layers * run["target_steps"] + \
            draft_cfg.layers * run["draft_steps"]
        got = run["launches"]["paged_attention"]
        print("llm %-5s: built+warmed %.2f s; %d streams, %d tokens in "
              "%.3f s = %.1f tokens/s; inter-token p50 %.3f ms p99 %.3f ms; "
              "stream latency p50 %.1f ms p99 %.1f ms; %d steps (%d target "
              "+ %d draft forwards), %d prefill tokens; kv pool %d blocks, "
              "peak use %.4f; spec %d/%d accepted (%.4f); dropped %d"
              % (label, built, LM_STREAMS, tokens, run["wall"],
                 tokens / run["wall"], rep["inter_token_p50_ms"],
                 rep["inter_token_p99_ms"], rep["latency_p50_ms"],
                 rep["latency_p99_ms"], rep["steps"], run["target_steps"],
                 run["draft_steps"], rep["prefill_tokens"], rep["kv_blocks"],
                 rep["kv_utilization_peak"], rep["spec_accepted"],
                 rep["spec_proposed"], rep["spec_accept_rate"],
                 rep["dropped_streams"]))
        print("llm %-5s: paged_attention launches %d, want %d layers x %d "
              "target + %d layer x %d draft forwards = %d"
              % (label, got, cfg.layers, run["target_steps"],
                 draft_cfg.layers, run["draft_steps"], want))
        if got != want or got < 1:
            fail("%s: paged_attention launched %d times, want %d"
                 % (label, got, want))
        if rep["dropped_streams"] or rep["completed"] != LM_STREAMS \
                or rep["failed"]:
            fail("%s: %d dropped, %d of %d completed, %d failed" % (
                label, rep["dropped_streams"], rep["completed"],
                LM_STREAMS, rep["failed"]))
        for i, st in enumerate(run["streams"]):
            if st is None or st.dtype != np.int32 or len(st) != LM_MAX_NEW \
                    or st.min() < 0 or st.max() >= cfg.vocab:
                fail("%s: stream %d malformed: %r" % (label, i, st))
        runs[label] = run

    # (a) paged == dense stripes, bitwise
    for i, (a, b) in enumerate(zip(runs["paged"]["streams"],
                                   runs["dense"]["streams"])):
        if not np.array_equal(a, b):
            fail("paged stream %d differs from the dense-stripe stream "
                 "at token %d" % (i, int(np.argmax(a != b))))
    print("llm check: all %d paged streams equal the dense-stripe streams "
          "bitwise" % LM_STREAMS)
    pdev = convert_lm_params(params, dev)
    # (b) speculative == plain, up to a logit tie at the first difference
    ties = 0
    for i, (a, b) in enumerate(zip(runs["paged"]["streams"],
                                   runs["spec"]["streams"])):
        if np.array_equal(a, b):
            continue
        j = int(np.argmax(a != b))
        margin, tol = top2_margin(torch, pdev, cfg, prompts[i], a, j, dev)
        print("llm check: spec stream %d differs at token %d (plain %d, "
              "spec %d); plain top-2 margin there %.3g, tol %.3g"
              % (i, j, a[j], b[j], margin, tol))
        if not margin < tol:
            fail("spec stream %d differs from plain decode at token %d "
                 "where the top-2 margin %.3g exceeds tol %.3g"
                 % (i, j, margin, tol))
        ties += 1
    print("llm check: %d of %d speculative streams equal plain decode "
          "(%d differ after a logit tie)" % (LM_STREAMS - ties, LM_STREAMS,
                                             ties))
    # (c) teacher-forced logits, kernel vs plain version
    windows = teacher_forced_phase(torch, ck, pdev, cfg, dev)
    paged_bytes = runs["paged"]["kv_bytes"]
    dense_bytes = runs["dense"]["kv_bytes"]
    prep = runs["paged"]["report"]
    gen = sum(len(x) for x in runs["paged"]["streams"])
    print("llm result: %.1f generated tokens/s (paged, %d tokens in %.3f s); "
          "inter-token p50 %.3f ms p99 %.3f ms; peak KV-pool use %.4f of %d "
          "blocks; KV bytes per stream paged %d vs dense %d (%.4f); spec "
          "%.1f tokens/s at acceptance %.4f"
          % (gen / runs["paged"]["wall"], gen, runs["paged"]["wall"],
             prep["inter_token_p50_ms"], prep["inter_token_p99_ms"],
             prep["kv_utilization_peak"], prep["kv_blocks"],
             paged_bytes // LM_SLOTS, dense_bytes // LM_SLOTS,
             paged_bytes / dense_bytes,
             gen / runs["spec"]["wall"],
             runs["spec"]["report"]["spec_accept_rate"]))
    for c in (LM_CHUNK, 1):
        profile_step(torch, pdev, cfg, windows[c])
    return {"launches": sum(r["launches"]["paged_attention"]
                            for r in runs.values()),
            "cfg": cfg, "params": params, "prompts": prompts,
            "streams": runs["paged"]["streams"],
            "tokens_s": gen / runs["paged"]["wall"]}


# ---------------------------------------------------------------------------
# phase 8: flash_attention against its plain version

# the kernel search's shape: GPT-2 small's attention geometry
# (openai-community/gpt2 config.json: n_head 12, n_embd 768 -> D 64,
# n_positions 1024) at batch 4
FLASH_SHAPE = (4, 1024, 12, 64)
# Tolerance: the kernel walks the keys in tiles with an online softmax
# (running max, rescaled sums, per-lane partial dot products), the plain
# version takes one global max and sums in einsum's order; both in float32
# over at most 1024 keys of products of unit-normal values scaled by
# 1/sqrt(D), so they differ by a few ulps of outputs that are weighted means
# of unit-normal V rows: absolute 2e-5, the JAX package's own tolerance for
# its flash kernel (tests/test_pallas.py).
FLASH_ATOL = 2e-5


def flash_inputs(torch, dev, seed, b, t, h, d):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, t, h, d), generator=gen, device=dev)
            for _ in range(3)]


def flash_bound_ms(b, t, h, d, causal, esize=4):
    """Least time for the work: q, k, v read once and out written once,
    ``esize`` bytes an element; 4·D flops (q·k and p·v) per (row, visible
    key) pair of every head, each float32 product taken as 3 TF32 products
    on the tensor cores as the kernel computes it (FLASH_PEAK).  With
    16-bit operands as half_attention_flops_ms says (HALF_FLASH_PEAK)."""
    pairs = t * (t + 1) / 2.0 if causal else float(t * t)
    flops = 4.0 * d * b * h * pairs
    nbytes = esize * 4 * b * t * h * d
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_flops = 1e3 * 3 * flops / PEAK_TF32_FLOPS if esize == 4 else \
        half_attention_flops_ms(flops, esize)
    return max(by_bytes, by_flops), ("bytes" if by_bytes >= by_flops
                                     else "operations")


def flash_kernel_phase(torch, ck):
    dev = torch.device("cuda", 0)
    b, t, h, d = FLASH_SHAPE
    cases = [("main-causal", FLASH_SHAPE, True, None),
             ("main-full", FLASH_SHAPE, False, None)]
    for tt, dd in ((1, 64), (7, 16), (33, 32), (100, 64), (129, 128),
                   (1000, 64), (77, 10)):
        for causal in (False, True):
            cases.append(("ragged-T%d-D%d" % (tt, dd), (2, tt, 3, dd),
                          causal, None))
    for dd in (16, 32, 64, 128):
        for tile in ck.FLASH_TILES:
            cases.append(("tile-%dx%d-D%d" % (tile + (dd,)), (1, 300, 2, dd),
                          True, tile))
    main_err = 0.0
    for seed, (name, shape, causal, tile) in enumerate(cases):
        q, k, v = flash_inputs(torch, dev, 100 + seed, *shape)
        bq, bk = tile if tile else (None, None)
        out = ck.flash_attention(q, k, v, causal=causal, block_q=bq,
                                 block_k=bk)
        ref = ck.flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        if name.startswith("main") or tile is None:
            print("kernel check flash %-16s B=%d T=%-4d H=%-2d D=%-3d causal=%d "
                  "tile=%s max_abs_err=%.3g tol=%.3g finite=%s"
                  % ((name,) + shape + (causal, ck.flash_tiles(
                      shape[1], shape[3], causal, q.dtype, dev, bq, bk),
                      err, FLASH_ATOL, finite)))
        if not (err <= FLASH_ATOL and finite):
            fail("flash %s: max_abs_err %.3g > tol %.3g, or non-finite"
                 % (name, err, FLASH_ATOL))
        if name.startswith("main"):
            main_err = max(main_err, err)
    n_tiles = sum(1 for c in cases if c[3] is not None)
    print("kernel check flash: all %d compiled tiles x D in (16, 32, 64, 128) "
          "at B=1 T=300 H=2 causal within tol (%d cases)"
          % (len(ck.FLASH_TILES), n_tiles))
    # bitwise repeatable: no atomics, a fixed order per tile
    q, k, v = flash_inputs(torch, dev, 7, *FLASH_SHAPE)
    a = ck.flash_attention(q, k, v, causal=True)
    a2 = ck.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    if not torch.equal(a, a2):
        fail("flash_attention is not bitwise repeatable")
    print("kernel check flash: two calls bitwise equal")
    return {"max_abs_err": main_err}


# ---------------------------------------------------------------------------
# phase 9: the kernel search at GPT-2-small attention geometry

def flash_search_phase(torch, mt, ck, trials=2):
    """search_flash into a fresh store, a second identical search (a store
    hit), then call-time resolution under MXNET_KERNEL_SEARCH=1; the
    kernel's launch count is read around exactly this path."""
    ks = mt.autotune.kernelsearch
    dev = torch.device("cuda", 0)
    b, t, h, d = FLASH_SHAPE
    saved = {k: os.environ.get(k) for k in ("MXNET_AUTOTUNE_DIR",
                                            "MXNET_KERNEL_SEARCH")}
    with tempfile.TemporaryDirectory() as store:
        os.environ["MXNET_AUTOTUNE_DIR"] = store
        os.environ.pop("MXNET_KERNEL_SEARCH", None)
        try:
            fails0 = ks.parity_fail_total()
            ck.reset_launches()
            t0 = time.perf_counter()
            win = ks.search_flash(b, t, h, d, causal=True, trials=trials)
            wall1 = time.perf_counter() - t0
            first = mt.autotune.recent_stats()[-1].report()
            after1 = ck.LAUNCHES["flash_attention"]
            t0 = time.perf_counter()
            win2 = ks.search_flash(b, t, h, d, causal=True, trials=trials)
            wall2 = time.perf_counter() - t0
            second = mt.autotune.recent_stats()[-1].report()
            after2 = ck.LAUNCHES["flash_attention"]
            os.environ["MXNET_KERNEL_SEARCH"] = "1"
            q, k, v = flash_inputs(torch, dev, 42, *FLASH_SHAPE)
            tiles = ck.flash_tiles(t, d, True, q.dtype, dev)
            via_winner = ck.flash_attention(q, k, v, causal=True)
            explicit = ck.flash_attention(q, k, v, causal=True,
                                          block_q=win["block_q"],
                                          block_k=win["block_k"])
            torch.cuda.synchronize()
            launches = ck.LAUNCHES["flash_attention"]
        finally:
            for key, val in saved.items():
                if val is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = val
    cands = ks.flash_candidates(t)
    print("search: search_flash(%d, %d, %d, %d, causal=True) on %s: %d "
          "candidates, wall %.3f s, calls %s, winner %s"
          % (b, t, h, d, torch.cuda.get_device_name(0), len(cands), wall1,
             first["calls"], win))
    for cfg, cost in first["trials"]:
        print("search:   %-70s %s" % (
            json.dumps({k: v for k, v in sorted(cfg.items())
                        if k != "_feat"}),
            "%.6f s" % cost if cost > 0 else "not measured"))
    print("search: second search %s in %.4f s, calls %s, kernel launches %d"
          % (second["source"], wall2, second["calls"], after2 - after1))
    fails = ks.parity_fail_total() - fails0
    if fails or first["calls"]["gate"] != len(cands):
        fail("search gate: %d parity failures, %d of %d candidates gated"
             % (fails, first["calls"]["gate"], len(cands)))
    if first["source"] != "measured" or first["calls"]["measure"] < 1 \
            or win not in cands:
        fail("first search did not measure a winner among the candidates: "
             "%s" % first)
    if win2 != win or second["source"] != "cache" \
            or any(second["calls"].values()) or after2 != after1:
        fail("second search was not a store hit with zero gate, featurize "
             "and measure calls: %s, %d launches" % (second,
                                                     after2 - after1))
    # a measured candidate: one launch off the clock, then trials x reps
    runs = 1 + trials * ks.FLASH_MEASURE_REPS
    want = first["calls"]["gate"] + first["calls"]["measure"] * runs
    if after1 != want:
        fail("search launched the kernel %d times, want %d gates + %d "
             "measured x %d runs = %d" % (after1, first["calls"]["gate"],
                                          first["calls"]["measure"], runs,
                                          want))
    same = bool(torch.equal(via_winner, explicit))
    ref = ck.flash_attention_reference(q, k, v, causal=True)
    err = (via_winner - ref).abs().max().item()
    print("search: call-time tiles under MXNET_KERNEL_SEARCH=1 %s; output "
          "bitwise equal to the explicit-tile call=%s; max_abs_err vs plain "
          "%.3g" % (tiles, same, err))
    if tiles != (win["block_q"], win["block_k"]) or not same \
            or not err <= FLASH_ATOL:
        fail("call-time winner: tiles %s, bitwise equal %s, err %.3g"
             % (tiles, same, err))
    print("search: flash_attention launches on the search path %d (search "
          "%d, store hit %d, call-time %d)" % (launches, after1,
                                               after2 - after1,
                                               launches - after2))

    # times at the search shape, causal, with the winning tile
    import torch.nn.functional as F
    flush = torch.zeros(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    bq, bk = win["block_q"], win["block_k"]
    bound, bound_by = flash_bound_ms(b, t, h, d, True)
    row = {
        "shape": "B=%d T=%d H=%d D=%d causal tile=%dx%d" % (b, t, h, d, bq,
                                                            bk),
        "ms": time_ms(torch, lambda: ck.flash_attention(
            q, k, v, causal=True, block_q=bq, block_k=bk), flush),
        "plain_ms": time_ms(torch, lambda: ck.flash_attention_reference(
            q, k, v, causal=True), flush),
        "earlier_ms": EARLIER_FLASH_MS, "earlier_from": EARLIER_FROM,
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True), flush),
        "bound_ms": bound, "bound_by": bound_by, "bound_peak": FLASH_PEAK,
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print("kernel time flash_attention %s" % json.dumps(row))
    others = {}
    for tile in ck.FLASH_TILES:
        others["%dx%d" % tile] = time_ms(torch, lambda: ck.flash_attention(
            q, k, v, causal=True, block_q=tile[0], block_k=tile[1]), flush,
            iters=10)
    print("kernel time flash_attention every tile (causal, ms): %s"
          % json.dumps(others))
    del flush
    return dict(row, launches=launches, search_wall_s=wall1)


# ---------------------------------------------------------------------------
# phase 10: correlation against its plain version

# FlowNetC's correlation stage (Dosovitskiy et al., FlowNet, ICCV 2015, sec.
# 3 and Fig. 2; the released FlowNetC prototxt): 384x512 images through
# three stride-2 convolutions give 48x64 maps of 256 channels, compared over
# displacements up to 20 pixels in steps of 2 (21 x 21 = 441)
FLOWNETC = dict(n=8, c=256, h=48, w=64, m=20, s2=2)
# PWC-Net's cost volume (Sun et al., CVPR 2018): 4-pixel displacements in
# steps of 1 (9 x 9 = 81) over 64-channel features
PWCNET = dict(n=8, c=64, h=56, w=128, m=4, s2=1)
# Tolerance: both sum C float32 products (or absolute differences) of
# unit-normal values, in channel order in the kernel and in torch's
# reduction order in the plain version, then divide by C; outputs are O(1),
# so they differ by a few ulps: 1e-5 * max(1, max|plain|).
CORR_TOL_REL = 1e-5


def corr_inputs(torch, dev, seed, n, c, h, w):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((n, c, h, w), generator=gen, device=dev)
            for _ in range(2)]


def corr_bound_ms(n, c, h, w, m, s2, esize=4, is_multiply=True):
    """Least time: a and b read once, the output written once, ``esize``
    bytes an element; 2 flops (multiply and add, or subtract and add) per
    channel of each output, at float32's rate, or for 16-bit products
    (multiply) at the tensor cores' float16/bfloat16 rate with a float32
    accumulate."""
    d2 = 2 * (m // s2) + 1
    nbytes = esize * (2 * n * c * h * w + n * d2 * d2 * h * w)
    flops = 2.0 * n * d2 * d2 * h * w * c
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    rate = PEAK_HALF_FLOPS if esize == 2 and is_multiply else PEAK_F32_FLOPS
    by_flops = 1e3 * flops / rate
    return max(by_bytes, by_flops), ("bytes" if by_bytes >= by_flops
                                     else "operations")


# The kernel checks: stride2 1, and stride2 2 at W % 4 == 0, take the
# register-blocked instance, the others the general one
CORR_CASES = [("flownetc", FLOWNETC), ("pwcnet", PWCNET),
              ("ragged-m3s2", dict(n=3, c=5, h=7, w=45, m=3, s2=2)),
              ("ragged-s2-w44", dict(n=2, c=19, h=13, w=44, m=5, s2=2)),
              ("s2-not-dividing", dict(n=1, c=3, h=33, w=31, m=4, s2=3)),
              ("m1", dict(n=2, c=16, h=9, w=70, m=1, s2=1)),
              ("m0", dict(n=2, c=7, h=5, w=5, m=0, s2=1)),
              ("d2-21-s1", dict(n=1, c=8, h=20, w=40, m=10, s2=1)),
              ("c1-tall", dict(n=1, c=1, h=67, w=3, m=2, s2=1)),
              # windows over 1024 floats a channel: the general instance's
              # runtime stride, with 16-byte and with 4-byte staging
              ("wide-window", dict(n=2, c=10, h=21, w=44, m=8, s2=8)),
              ("wide-odd-w", dict(n=1, c=5, h=19, w=45, m=12, s2=4))]


def correlation_kernel_phase(torch, ck):
    dev = torch.device("cuda", 0)
    main_err = 0.0
    for seed, (name, g) in enumerate(CORR_CASES):
        a, b = corr_inputs(torch, dev, 200 + seed, g["n"], g["c"], g["h"],
                           g["w"])
        for mult in (True, False):
            out = ck.correlation(a, b, g["m"], g["s2"], mult)
            ref = ck.correlation_reference(a, b, g["m"], g["s2"], mult)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = CORR_TOL_REL * max(1.0, ref.abs().max().item())
            print("kernel check corr %-16s N=%d C=%-3d %dx%-3d m=%-2d s2=%d "
                  "D2^2=%-3d multiply=%d max_abs_err=%.3g tol=%.3g"
                  % (name, g["n"], g["c"], g["h"], g["w"], g["m"], g["s2"],
                     out.shape[1], mult, err, tol))
            if out.shape != ref.shape or not err <= tol \
                    or not bool(torch.isfinite(out).all()):
                fail("correlation %s multiply=%s: max_abs_err %.3g > tol "
                     "%.3g, or shape %s != %s" % (name, mult, err, tol,
                                                  tuple(out.shape),
                                                  tuple(ref.shape)))
            if name == "flownetc":
                main_err = max(main_err, err)

    flush = torch.zeros(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    rows = []
    for name, g in (("flownetc", FLOWNETC), ("pwcnet", PWCNET)):
        a, b = corr_inputs(torch, dev, 300, g["n"], g["c"], g["h"], g["w"])
        for mult in (True, False):
            bound, bound_by = corr_bound_ms(g["n"], g["c"], g["h"], g["w"],
                                            g["m"], g["s2"])
            row = {"shape": "%s N=%d C=%d %dx%d m=%d s2=%d multiply=%d" % (
                       name, g["n"], g["c"], g["h"], g["w"], g["m"], g["s2"],
                       mult),
                   "ms": time_ms(torch, lambda: ck.correlation(
                       a, b, g["m"], g["s2"], mult), flush),
                   "plain_ms": time_ms(torch, lambda: ck.correlation_reference(
                       a, b, g["m"], g["s2"], mult), flush, iters=5),
                   "library_ms": None,
                   "bound_ms": bound, "bound_by": bound_by}
            if mult and name in EARLIER_CORR_MS:
                row.update(earlier_ms=EARLIER_CORR_MS[name],
                           earlier_from=EARLIER_FROM)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            print("kernel time correlation %s" % json.dumps(row))
            rows.append(row)
    del flush
    main = rows[0]
    return dict(main, max_abs_err=main_err, rows=rows)


# ---------------------------------------------------------------------------
# phase 11: FlowNetC's correlation stage through Predictor

FLOWNETC_IMAGE = (384, 512)
# Tolerance of the served output against the same graph run by the port on
# the CPU (where the correlation wrapper takes its plain version): both in
# float32 (TF32 off), five convolution layers summing up to 4257 products in
# cuDNN's order and in the CPU's, and the correlation in the kernel's order
# and torch's; those differences stay near 1e-6 relative, so 1e-4 *
# max(1, max|cpu|) holds a right path while a wrong displacement, channel
# order or weight moves outputs at the scale of max|cpu|.
FLOWNETC_TOL_REL = 1e-4


def flownetc_symbol(sym, widths=(64, 128, 256), redir=32, out=256,
                    max_displacement=20, stride2=2):
    """FlowNetC up to conv3_1 (Dosovitskiy et al., ICCV 2015, Fig. 2; the
    released FlowNetC prototxt): a Siamese tower (conv1 7x7/2, conv2 5x5/2,
    conv3 5x5/2, each with LeakyReLU 0.1) whose weights both images share,
    the correlation of the two towers (kernel 1, stride1 1, pad = max
    displacement), conv_redir 1x1 on tower 1, their concatenation, conv3_1
    3x3.  Every layer is followed by LeakyReLU 0.1 as in the prototxt.
    ``sym`` is either package's symbol module."""
    shared = {}

    def tower(x, tag):
        for i, (f, k) in enumerate(zip(widths, (7, 5, 5)), 1):
            name = "conv%d" % i
            if name not in shared:
                shared[name] = (sym.Variable(name + "_weight"),
                                sym.Variable(name + "_bias"))
            w, b = shared[name]
            x = sym.Convolution(data=x, weight=w, bias=b, kernel=(k, k),
                                stride=(2, 2), pad=(k // 2, k // 2),
                                num_filter=f, name=name + tag)
            x = sym.LeakyReLU(data=x, act_type="leaky", slope=0.1,
                              name="relu%d%s" % (i, tag))
        return x

    a = tower(sym.Variable("img1"), "a")
    b = tower(sym.Variable("img2"), "b")
    corr = sym.Correlation(data1=a, data2=b, kernel_size=1,
                           max_displacement=max_displacement, stride1=1,
                           stride2=stride2, pad_size=max_displacement,
                           name="corr")
    corr = sym.LeakyReLU(data=corr, act_type="leaky", slope=0.1,
                         name="corr_relu")
    rd = sym.Convolution(data=a, kernel=(1, 1), num_filter=redir,
                         name="conv_redir")
    rd = sym.LeakyReLU(data=rd, act_type="leaky", slope=0.1,
                       name="redir_relu")
    cat = sym.Concat(rd, corr, dim=1, name="concat_redir_corr")
    x = sym.Convolution(data=cat, kernel=(3, 3), pad=(1, 1), num_filter=out,
                        name="conv3_1")
    return sym.LeakyReLU(data=x, act_type="leaky", slope=0.1, name="relu3_1")


def flownetc_inputs(mt, n, forwards, seed):
    """FlowNetC's symbol, input shapes, float32 weights and ``forwards``
    frame pairs, from numpy seeds: -> (sym, shapes, params, frames)."""
    sym = flownetc_symbol(mt.sym)
    hh, ww = FLOWNETC_IMAGE
    shapes = {"img1": (n, 3, hh, ww), "img2": (n, 3, hh, ww)}
    params = xavier_params(sym, shapes, seed)
    rng = np.random.default_rng(seed + 1)
    frames = []
    for _ in range(forwards):
        img1 = rng.random((n, 3, hh, ww), dtype=np.float32)
        # the second frame: the first moved by (8, 16) pixels, plus noise
        img2 = np.roll(img1, (8, 16), axis=(2, 3)) + np.float32(0.05) * \
            rng.standard_normal((n, 3, hh, ww), dtype=np.float32)
        frames.append((img1, img2.astype(np.float32)))
    return sym, shapes, params, frames


def flownetc_phase(torch, mt, ck, n=8, forwards=4, n_check=2, seed=0):
    sym, shapes, params, frames = flownetc_inputs(mt, n, forwards, seed)
    hh, ww = FLOWNETC_IMAGE
    n_params = sum(v.size for v in params.values())
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "flownetc")
        mt.model.save_checkpoint(
            prefix, 0, sym,
            {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}, {})
        t0 = time.perf_counter()
        pred = mt.Predictor(prefix + "-symbol.json", prefix + "-0000.params",
                            input_shapes=shapes)
        built = time.perf_counter() - t0
        cpu_pred = mt.Predictor(
            prefix + "-symbol.json", prefix + "-0000.params",
            input_shapes={k: (n_check,) + v[1:] for k, v in shapes.items()},
            dev_type="cpu")
    print("flownetc: %d float32 parameters (seed %d), inputs 2 x %s, "
          "Predictor on %s built in %.2f s"
          % (n_params, seed, shapes["img1"], pred.ctx, built))

    def forward(img1, img2):
        pred.set_input("img1", img1)
        pred.set_input("img2", img2)
        pred.forward()
        return pred.get_output(0)

    forward(*frames[0])                   # cuDNN picks its algorithms
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    outs = [forward(*f) for f in frames]
    wall = (time.perf_counter() - t0) * 1e3 / forwards
    launches = dict(ck.LAUNCHES)
    print("flownetc: %d forwards, %.3f ms each (wall, ending in the output "
          "copy); launches %s" % (forwards, wall, launches))
    if launches["correlation"] != forwards or any(
            v for k, v in launches.items() if k != "correlation"):
        fail("flownetc: correlation launched %d times for %d forwards "
             "(launches %s)" % (launches["correlation"], forwards, launches))
    want_shape = (n, 256, hh // 8, ww // 8)
    for i, o in enumerate(outs):
        if o.shape != want_shape or not np.all(np.isfinite(o)):
            fail("flownetc output %d malformed: %s" % (i, o.shape))
    # the same graph and checkpoint on the CPU, first samples of each batch
    worst, tol = 0.0, 0.0
    for (img1, img2), o in zip(frames[:2], outs[:2]):
        cpu_pred.set_input("img1", img1[:n_check])
        cpu_pred.set_input("img2", img2[:n_check])
        cpu_pred.forward()
        ref = cpu_pred.get_output(0)
        err = float(np.abs(o[:n_check] - ref).max())
        tol = max(tol, FLOWNETC_TOL_REL * max(1.0, float(np.abs(ref).max())))
        worst = max(worst, err)
        if not err <= tol:
            fail("flownetc output differs from the CPU run of the same "
                 "graph: max abs err %.3g > tol %.3g" % (err, tol))
    print("flownetc check: output %s finite; the first %d samples of 2 "
          "batches within tol of the port's CPU run of the same checkpoint "
          "(max abs err %.3g, tol %.3g, max|out| %.3f)"
          % (want_shape, n_check, worst, tol, float(np.abs(outs[0]).max())))

    pred.set_input("img1", frames[0][0])
    pred.set_input("img2", frames[0][1])
    dwall, device, rows = device_profile(torch, pred.forward)
    print("profile: FlowNetC forward (batch %d, %dx%d) %.3f ms wall (no "
          "profiler); device time %.3f ms per forward, busy share %.3f"
          % (n, hh, ww, dwall, device, device / dwall if dwall else 0.0))
    for t, key, cnt in rows[:10]:
        print("profile:   %8.3f ms  %5.1f%%  x%-2d %s"
              % (t, 100.0 * t / device if device else 0.0, cnt, key[:80]))
    print_groups(rows, device, lambda name: (
        "correlation" if "correlation" in name else
        "concat" if "cat" in name else conv_group(name)))
    return {"launches": launches["correlation"], "forwards": forwards,
            "wall_ms": wall, "device_ms": device, "out0": outs[0]}


# ---------------------------------------------------------------------------
# phase 12: integer max pooling with padding

def int_pool_phase(torch):
    """Pooling(max) pads integer inputs with the type's least value, as
    the JAX package does; the card must give the CPU's answer, in the
    input's dtype."""
    from mxnet_tpu_torch.ops import get_op
    from mxnet_tpu_torch.ops.registry import OpContext
    op = get_op("Pooling")
    p = op.parse_params({"kernel": (3, 3), "pad": (1, 1), "stride": (2, 2)})
    x = torch.from_numpy(np.random.RandomState(5).randint(
        -1000, 1000, (2, 3, 9, 8)).astype(np.int32))
    ctx = OpContext(is_train=False)
    want = op.forward(p, [x], [], ctx)[0]
    got = op.forward(p, [x.cuda()], [], ctx)[0]
    torch.cuda.synchronize()
    print("int pooling check: int32 %s -> %s on %s, %s, equal to the CPU: %s"
          % (tuple(x.shape), tuple(got.shape), got.device, got.dtype,
             torch.equal(got.cpu(), want)))
    if got.dtype != torch.int32 or not torch.equal(got.cpu(), want):
        fail("int32 max pooling on the card differs from the CPU run")


# ---------------------------------------------------------------------------
# phase 13: training through Module on the card, the fused step captured

# SGD at bench.py's settings.  TF32 is off for matmul and cuDNN (phase 1),
# so every product in training is float32.
TRAIN_OPT = {"learning_rate": 0.05, "momentum": 0.9}
LENET_BATCH, LENET_STEPS = 64, 10
# LeNet, card against the port's CPU run of the same 10 steps: cuDNN's
# convolution algorithms (FFT or Winograd are allowed for the 5x5
# kernels) and the CPU's sum in other orders, ~1e-6 relative a layer,
# and momentum carries each step's difference on; fused against classic
# on the card: the same kernels, but cuDNN's weight gradients may use
# atomics and the classic updater folds lr * wd in float64
LENET_CPU_RTOL, LENET_CPU_ATOL = 1e-3, 1e-4
LENET_PATH_RTOL, LENET_PATH_ATOL = 1e-4, 1e-5
RESNET_BATCH, RESNET_WARMUP, RESNET_REPLAYS = 128, 3, 20
RESNET_LR_STEP = 12            # the scheduler halves lr after 12 updates
# one replay against the same step run eagerly from the same state: the
# same kernels on the same inputs, apart from cuDNN's atomics
REPLAY_RTOL, REPLAY_ATOL = 1e-4, 1e-6
# 23 captured steps against 23 eager classic steps: with cuDNN
# deterministic the same arithmetic (equal up to DET_RTOL, atol 0); in
# cuDNN's default mode its weight gradients use atomics, the relus after
# BatchNorm gate the last-bit differences apart, and a second classic run
# drifts from the first by a relative L2 of the same order as the
# captured run does: the captured steps may drift from the classic ones
# at most DRIFT_RATIO times as far as the classic path from itself
DET_RTOL, DRIFT_RATIO = 1e-6, 2.0


def host_params(mod):
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def worst_rel(got, want, atol):
    """The smallest rtol at which every tensor of ``got`` is allclose to
    ``want``'s with this atol: max over elements of (|g - w| - atol) /
    |w|."""
    worst = 0.0
    for g, w in zip(got, want):
        for k in w:
            excess = np.abs(g[k] - w[k]) - atol
            worst = max(worst, float(np.max(excess / np.maximum(
                np.abs(w[k]), 1e-30))))
    return worst


def params_close(got, want, rtol, atol):
    return all(np.allclose(g[k], w[k], rtol=rtol, atol=atol)
               for g, w in zip(got, want) for k in w)


def rel_l2(got, want):
    """Relative L2 distance over every tensor of the params and aux."""
    num = sum(float(((g[k] - w[k]) ** 2).sum())
              for g, w in zip(got, want) for k in w)
    den = sum(float((w[k] ** 2).sum()) for w in want for k in w)
    return math.sqrt(num / den)


class fused_train_env:
    """MXNET_FUSED_TRAIN set for one module's life (0: the classic path)."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.old = os.environ.get("MXNET_FUSED_TRAIN")
        os.environ["MXNET_FUSED_TRAIN"] = "1" if self.on else "0"

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("MXNET_FUSED_TRAIN", None)
        else:
            os.environ["MXNET_FUSED_TRAIN"] = self.old


class env_set:
    """An environment variable set for one block (None: unset)."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.get(self.name)
        if self.value is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.old


def lenet_train(torch, mt, tmp, smi):
    """(a) LeNet: 10 steps through Module.fit from one checkpoint on the
    card (fused: 3 eager warm-up steps, then one capture and 7 replays),
    on the CPU, and on the card's classic path."""
    b, n = LENET_BATCH, LENET_STEPS
    sym = mt.models.get_lenet()
    shapes = {"data": (b, 1, 28, 28), "softmax_label": (b,)}
    prefix = os.path.join(tmp, "lenet")
    mt.model.save_checkpoint(
        prefix, 0, sym, {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in
                         xavier_params(sym, shapes, 7).items()}, {})
    rng = np.random.default_rng(8)
    x = rng.random((b * n, 1, 28, 28), dtype=np.float32)
    y = rng.integers(0, 10, b * n).astype(np.float32)

    def run(ctx, fused):
        with fused_train_env(fused):
            s, arg, aux = mt.model.load_checkpoint(prefix, 0, ctx=mt.cpu())
            mod = mt.mod.Module(s, context=ctx)
            accs = []
            mod.fit(mt.io.NDArrayIter(x, y, batch_size=b), num_epoch=1,
                    optimizer="sgd", optimizer_params=dict(TRAIN_OPT),
                    arg_params=arg, aux_params=aux, eval_metric="acc",
                    batch_end_callback=lambda p: accs.append(
                        p.eval_metric.get()[1]))
        stats = mod._fused.stats.report() if mod._fused is not None \
            else None
        return host_params(mod), accs, stats

    card, card_acc, stats = run(mt.gpu(0), True)
    cpu, cpu_acc, _ = run(mt.cpu(), True)
    classic, classic_acc, classic_stats = run(mt.gpu(0), False)
    want = {"captures": 1, "replays": n - RESNET_WARMUP,
            "eager_steps": RESNET_WARMUP}
    print("train: lenet %d steps of batch %d on %s: fused step %s; accuracy "
          "card %s cpu %s classic %s" % (n, b, smi, stats, card_acc[-1],
                                         cpu_acc[-1], classic_acc[-1]))
    cpu_err = worst_rel(card, cpu, LENET_CPU_ATOL)
    path_err = worst_rel(card, classic, LENET_PATH_ATOL)
    print("train: lenet card vs cpu: smallest rtol at atol %g: %.3g (gate "
          "%g); fused vs classic on the card: %.3g at atol %g (gate %g)"
          % (LENET_CPU_ATOL, cpu_err, LENET_CPU_RTOL, path_err,
             LENET_PATH_ATOL, LENET_PATH_RTOL))
    if stats != want or classic_stats is not None:
        fail("lenet fused step counts %s (want %s), classic module fused: "
             "%s" % (stats, want, classic_stats))
    if not params_close(card, cpu, LENET_CPU_RTOL, LENET_CPU_ATOL):
        fail("lenet params on the card differ from the CPU run")
    if not params_close(card, classic, LENET_PATH_RTOL, LENET_PATH_ATOL):
        fail("lenet fused params differ from the classic path's")
    if card_acc != cpu_acc or card_acc != classic_acc:
        fail("lenet accuracy differs: card %s cpu %s classic %s"
             % (card_acc, cpu_acc, classic_acc))
    return {"cpu_rtol": cpu_err, "path_rtol": path_err, "stats": stats}


def clone_state(torch, state):
    def c(v):
        if v is None:
            return None
        if isinstance(v, (tuple, list)):
            return tuple(c(e) for e in v)
        return v.detach().clone()
    return {k: ({n: c(t) for n, t in v.items()} if isinstance(v, dict)
                else c(v)) for k, v in state.items()}


def restore_state(torch, state, snap):
    def r(dst, src):
        if dst is None:
            return
        if isinstance(dst, (tuple, list)):
            for d, s in zip(dst, src):
                r(d, s)
            return
        dst.copy_(src)
    with torch.no_grad():
        for k, v in state.items():
            if isinstance(v, dict):
                for n, t in v.items():
                    r(t, snap[k][n])
            else:
                r(v, snap[k])


def state_params(state):
    """Host copies of the fused step's params and aux states."""
    def host(t):
        return t.detach().cpu().numpy().copy()
    return ({n: host(t) for n, t in
             list(state["params"].items()) + list(state["fixed"].items())},
            {n: host(t) for n, t in state["aux"].items()})


def train_group(name):
    """Kernel groups of a training step."""
    if "wgrad" in name:
        return "conv bwd weight"
    if "dgrad" in name:
        return "conv bwd data"
    if "batch_norm" in name or "bn_fw" in name or "bn_bw" in name or \
            "batchnorm" in name:
        return "batchnorm"
    if conv_group(name) == "convolution":
        return "conv fwd"
    if "pool" in name:
        return "pooling"
    if "gemm" in name or "cublas" in name:
        return "matmul"
    if "reduce" in name:
        return "reduction"
    if "elementwise" in name or "vectorized" in name:
        return "elementwise"
    return "other"


def resnet_train(torch, mt, smi):
    """(b) ResNet-50 at 224 with 1000 classes, batch 128, on numpy-seeded
    data pre-staged on the card as bench.py stages it: 3 eager warm-up
    steps, one capture, 20 replays with an lr change between them; the
    last replay against the same step run eagerly from the same state;
    the step's img/s and profile; the 23 steps against the classic
    path's; Module.fit's img/s over an NDArrayIter."""
    b = RESNET_BATCH
    gpu = mt.gpu(0)
    sym = mt.models.get_resnet50(1000)
    t0 = time.perf_counter()
    init = mt.mod.Module(sym, context=mt.cpu())
    init.bind([("data", (1, 3, 224, 224))], [("softmax_label", (1,))])
    mt.random.seed(0)
    init.init_params(mt.init.Xavier(factor_type="in", magnitude=2.34))
    arg0, aux0 = init.get_params()
    del init
    n_params = sum(v.size for v in arg0.values())
    rng = np.random.default_rng(9)
    host_batches = [(rng.random((b, 3, 224, 224), dtype=np.float32),
                     rng.integers(0, 1000, b).astype(np.float32))
                    for _ in range(4)]
    staged = [mt.io.DataBatch(data=[mt.nd.array(xb, ctx=gpu)],
                              label=[mt.nd.array(yb, ctx=gpu)])
              for xb, yb in host_batches]
    print("train: resnet50 %d parameters (Xavier in, 2.34), %d aux, 4 "
          "batches of %dx3x224x224 staged on the card in %.1f s"
          % (n_params, len(aux0), b, time.perf_counter() - t0))
    steps = RESNET_WARMUP + RESNET_REPLAYS

    def module(fused):
        with fused_train_env(fused):
            mod = mt.mod.Module(sym, context=gpu)
            mod.bind([("data", (b, 3, 224, 224))], [("softmax_label", (b,))])
            mod.init_params(arg_params=arg0, aux_params=aux0)
            sched = mt.lr_scheduler.MultiFactorScheduler([RESNET_LR_STEP],
                                                         0.5)
            mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
                TRAIN_OPT, lr_scheduler=sched))
        if (mod._fused is not None) != fused:
            fail("MXNET_FUSED_TRAIN=%d: fused step %s"
                 % (fused, mod._fused is not None))
        return mod

    def one_step(mod, batch):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()

    def loss_of(mod, batch):
        p = mod.get_outputs()[0]._get()
        lab = batch.label[0]._get().long()
        return float(-torch.log(p[torch.arange(b, device=p.device), lab]
                                + 1e-12).mean())

    def trained(fused):
        """A module on the card after the 23 steps; -> (its host params,
        its losses)."""
        mod = module(fused)
        losses = []
        for i in range(steps):
            one_step(mod, staged[i % len(staged)])
            losses.append(loss_of(mod, staged[i % len(staged)]))
        out = host_params(mod), losses
        del mod
        torch.cuda.empty_cache()
        return out

    # the captured steps, cuDNN in its default (nondeterministic) mode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mod = module(True)
    fused = mod._fused
    losses, lrs = [], []
    for i in range(steps):
        batch = staged[i % len(staged)]
        if i == steps - 1:
            snap = clone_state(torch, fused.state)
        one_step(mod, batch)
        losses.append(loss_of(mod, batch))
        lrs.append(float(fused.state["lr"]))
    stats = fused.stats.report()
    peak = torch.cuda.max_memory_allocated()
    replayed = clone_state(torch, fused.state)
    got = state_params(fused.state)
    # the last replay against the same step run eagerly from its state
    restore_state(torch, fused.state, snap)
    fused._body(fused.make_batch(staged[(steps - 1) % len(staged)]))
    eager = state_params(fused.state)
    restore_state(torch, fused.state, replayed)
    del snap, replayed
    replay_err = worst_rel(got, eager, REPLAY_ATOL)
    print("train: resnet50 %d steps of batch %d: %s; lr %s -> %s (after "
          "update %d); loss %.4f -> %.4f; peak memory %.2f GiB"
          % (steps, b, stats, lrs[0], lrs[-1], RESNET_LR_STEP, losses[0],
             losses[-1], peak / 2**30))
    print("train: resnet50 last replay vs the same step eager from the "
          "same state: smallest rtol at atol %g: %.3g (gate %g)"
          % (REPLAY_ATOL, replay_err, REPLAY_RTOL))
    counts = {"captures": 1, "replays": RESNET_REPLAYS,
              "eager_steps": RESNET_WARMUP}
    if stats != counts:
        fail("resnet50 fused step counts %s, want %s (one capture across "
             "the lr change)" % (stats, counts))
    if lrs[-1] != 0.5 * lrs[0]:
        fail("resnet50 lr did not change: %s" % lrs)
    if not all(math.isfinite(v) for v in losses):
        fail("resnet50 loss not finite: %s" % losses)
    if not params_close(got, eager, REPLAY_RTOL, REPLAY_ATOL):
        fail("resnet50 replay differs from the eager step")

    # the step alone, the batch on the card (bench.py's measure)
    iters = 20
    one_step(mod, staged[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        one_step(mod, staged[0])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters
    wall, device, rows = device_profile(
        torch, lambda: one_step(mod, staged[0]), reps=3)
    print("train: resnet50 step (one replay, batch on the card): %.3f ms "
          "wall = %.1f img/s; profile: %.3f ms wall, device %.3f ms, busy "
          "share %.3f; captures %d (no recapture)"
          % (step_s * 1e3, b / step_s, wall, device,
             device / wall if wall else 0.0, fused.stats.captures))
    for t, key, n in rows[:10]:
        print("profile:   %8.3f ms  %5.1f%%  x%-3d %s"
              % (t, 100.0 * t / device if device else 0.0, n, key[:90]))
    groups = print_groups(rows, device, train_group, width=16)
    # the same body run eagerly, by part: the profiler's ranges of the
    # parts are rows of their own, left out of the kernels' sum
    by_op = {}
    _, _, erows = device_profile(
        torch, lambda: fused._body(fused.make_batch(staged[0])), reps=2,
        by_op=by_op)
    edevice = sum(t for t, key, _ in erows if not key.startswith("fused:"))
    parts = {"forward": by_op.get("fused:forward", 0.0),
             "backward": sum(t for k, t in by_op.items()
                             if k.startswith("autograd::engine")),
             "update": by_op.get("fused:update", 0.0)}
    parts["other"] = max(0.0, edevice - sum(parts.values()))
    print("train: resnet50 eager step (the same body, not captured), "
          "device %.3f ms by part: %s"
          % (edevice, ", ".join("%s %.3f ms" % kv for kv in parts.items())))
    if fused.stats.captures != 1:
        fail("resnet50 recaptured: %s" % fused.stats.report())
    del mod, fused
    torch.cuda.empty_cache()

    # the captured steps against the classic path's eager steps.  With
    # cuDNN deterministic (set for this check only) they are the same
    # arithmetic; in the default mode cuDNN's weight gradients use
    # atomics, relus after BatchNorm amplify the last bits, and the
    # classic path drifts from itself as far
    torch.backends.cudnn.deterministic = True
    try:
        (det_f, _), (det_c, _) = trained(True), trained(False)
    finally:
        torch.backends.cudnn.deterministic = False
    det_err = worst_rel(det_f, det_c, 0.0)
    (c1, closses), (c2, _) = trained(False), trained(False)
    drift, self_drift = rel_l2(got, c1), rel_l2(c2, c1)
    print("train: resnet50 captured vs classic eager, %d steps: cuDNN "
          "deterministic: smallest rtol at atol 0: %.3g (gate %g); default "
          "cuDNN: relative L2 %.3g, against the classic path's own "
          "run-to-run %.3g (gate %g x); loss classic %.4f -> %.4f"
          % (steps, det_err, DET_RTOL, drift, self_drift, DRIFT_RATIO,
             closses[0], closses[-1]))
    if not params_close(det_f, det_c, DET_RTOL, 0.0):
        fail("resnet50 captured steps differ from the classic eager steps "
             "under deterministic cuDNN")
    if drift > DRIFT_RATIO * self_drift:
        fail("resnet50 captured steps drift from the classic eager steps "
             "further than the classic path from itself")

    # Module.fit over an NDArrayIter: host batches copied in each step;
    # the second epoch timed, between the ends of its first and last batch
    n_fit = 8
    rng = np.random.default_rng(10)
    xs = rng.random((b * n_fit, 3, 224, 224), dtype=np.float32)
    ys = rng.integers(0, 1000, b * n_fit).astype(np.float32)
    marks = []

    def mark(p):
        if p.epoch == 1 and p.nbatch in (0, n_fit - 1):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
    fmod = mt.mod.Module(sym, context=gpu)
    fmod.fit(mt.io.NDArrayIter(xs, ys, batch_size=b), num_epoch=2,
             optimizer="sgd", optimizer_params=dict(TRAIN_OPT),
             arg_params=arg0, aux_params=aux0, eval_metric="acc",
             batch_end_callback=mark)
    fit_stats = fmod._fused.stats.report()
    fit_rate = b * (n_fit - 1) / (marks[1] - marks[0])
    print("train: resnet50 Module.fit over an NDArrayIter (host batches): "
          "%.1f img/s over epoch 2's last %d batches; fused step %s"
          % (fit_rate, n_fit - 1, fit_stats))
    if fit_stats["captures"] != 1 or \
            fit_stats["replays"] != 2 * n_fit - RESNET_WARMUP:
        fail("resnet50 fit made %s" % fit_stats)
    del fmod, xs
    torch.cuda.empty_cache()
    return {"img_s": b / step_s, "fit_img_s": fit_rate, "wall": wall,
            "device": device, "groups": groups, "parts": parts,
            "stats": stats, "peak_gib": peak / 2**30, "drift": drift,
            "self_drift": self_drift, "replay_rtol": replay_err,
            "det_rtol": det_err}


def train_phase(torch, mt, ck, smi):
    print("train: TF32 allow_tf32 matmul=%s cudnn=%s (float32 products "
          "throughout); card %s" % (torch.backends.cuda.matmul.allow_tf32,
                                    torch.backends.cudnn.allow_tf32, smi))
    ck.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        lenet = lenet_train(torch, mt, tmp, smi)
    resnet = resnet_train(torch, mt, smi)
    launches = dict(ck.LAUNCHES)
    print("train: hand-kernel launches on the train path: %s" % launches)
    if any(launches.values()):
        fail("the train path launched hand kernels: %s" % launches)
    return {"lenet": lenet, "resnet": resnet, "launches": launches}


# ---------------------------------------------------------------------------
# phase 14: the PTB LSTM trained on the card

# bench_lstm.py's model and example/rnn/lstm_bucketing.py's settings: 2
# layers of 200, a 200-wide embedding, PTB's 10,000-word vocabulary, 32
# steps, SGD lr 0.1 with momentum 0.9.  The PTB text is not in the
# repository: token ids come from a numpy seed, staged as float32 as
# bench_lstm.py stages them, the labels the next ids.
LSTM_LAYERS, LSTM_HIDDEN, LSTM_VOCAB, LSTM_SEQ = 2, 200, 10000, 32
LSTM_OPT = {"learning_rate": 0.1, "momentum": 0.9}
LSTM_BATCH = 2048                # bench.py's headline leg
# bench.py's two other legs: (name, hidden = embed, batch)
LSTM_LEGS = [("h1024-b512", 1024, 512), ("h200-b32", 200, 32)]
LSTM_REPLAYS = 20
# lstm_unroll_scan (the RNN op) against lstm_unroll from one checkpoint:
# tests/test_rnn_op.py's relative differences, output and gradients
SCAN_OUT_TOL, SCAN_GRAD_TOL = 1e-4, 1e-3
# example/rnn/lstm_bucketing.py: buckets, batch 32, weight decay 1e-5
BUCKETS = (10, 20, 30, 40)
BUCKET_BATCH, BUCKET_BATCHES, BUCKET_EPOCHS = 32, 8, 2
BUCKET_OPT = dict(LSTM_OPT, wd=1e-5)


def lstm_states(batch, hidden, order=sorted):
    """The init-state inputs, bench_lstm.py's sorted order by default."""
    names = order(["l%d_init_c" % i for i in range(LSTM_LAYERS)]
                  + ["l%d_init_h" % i for i in range(LSTM_LAYERS)])
    return [(n, (batch, hidden)) for n in names]


def lstm_params(mt, hidden, seed):
    """Xavier (sqrt(6 / fan_in)) host params of lstm_unroll at this width
    from a numpy seed; both forms and every bucket share their names."""
    sym = mt.models.lstm_unroll(LSTM_LAYERS, LSTM_SEQ, LSTM_VOCAB, hidden,
                                hidden, LSTM_VOCAB)
    shapes = dict([("data", (1, LSTM_SEQ)), ("softmax_label", (1, LSTM_SEQ))]
                  + lstm_states(1, hidden))
    return {k: mt.nd.array(v, ctx=mt.cpu())
            for k, v in xavier_params(sym, shapes, seed).items()}


def lstm_module(mt, model_fn, hidden, batch, arg0, fused, ctx=None,
                opt=LSTM_OPT):
    sym = model_fn(LSTM_LAYERS, LSTM_SEQ, LSTM_VOCAB, hidden, hidden,
                  LSTM_VOCAB)
    states = lstm_states(batch, hidden)
    with fused_train_env(fused):
        mod = mt.mod.Module(sym, data_names=["data"] + [n for n, _ in states],
                            label_names=["softmax_label"],
                            context=ctx or mt.gpu(0))
        mod.bind([("data", (batch, LSTM_SEQ))] + states,
                 [("softmax_label", (batch, LSTM_SEQ))])
        mod.init_params(arg_params=arg0, aux_params={})
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(opt))
    if (mod._fused is not None) != fused:
        fail("MXNET_FUSED_TRAIN=%d: LSTM fused step %s"
             % (fused, mod._fused is not None))
    return mod


def token_batch(mt, rng, ctx, batch, seq, hidden, states_order=sorted):
    """Ids from ``rng`` as float32 data and next-id labels, zero states."""
    ids = rng.integers(0, LSTM_VOCAB, (batch, seq + 1))
    states = lstm_states(batch, hidden, states_order)
    return mt.io.DataBatch(
        data=[mt.nd.array(ids[:, :-1].astype(np.float32), ctx=ctx)]
        + [mt.nd.zeros(sh, ctx=ctx) for _, sh in states],
        label=[mt.nd.array(ids[:, 1:].astype(np.float32), ctx=ctx)],
        bucket_key=seq,
        provide_data=[("data", (batch, seq))] + states,
        provide_label=[("softmax_label", (batch, seq))])


def train_step(mod, batch):
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()


def lstm_loss(torch, mod, batch):
    """Mean next-token cross-entropy of the last step's outputs (time-major
    rows, as the labels are flattened)."""
    p = mod.get_outputs()[0]._get()
    lab = batch.label[0]._get().t().reshape(-1).long()
    return float(-torch.log(p[torch.arange(p.shape[0], device=p.device),
                              lab] + 1e-12).mean())


def lstm_group(name):
    """Kernel groups of an LSTM training step."""
    if "gemm" in name or "cublas" in name or "cutlass" in name or \
            "xmma" in name:
        return "matmul"
    if "softmax" in name:
        return "softmax"
    if any(s in name for s in ("index", "sort", "scatter", "gather")):
        return "embedding/index"
    if "catarray" in name or "copy" in name or "memcpy" in name or \
            "memset" in name:
        return "copy/concat"
    if "reduce" in name:
        return "reduction"
    if "elementwise" in name or "vectorized" in name:
        return "elementwise"
    return "other"


def lstm_rate(torch, name, mod, batch, tokens, smi, iters=LSTM_REPLAYS):
    """tokens/s of one train step (batch on the card), its profile and
    kernel groups; -> dict."""
    train_step(mod, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        train_step(mod, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters
    wall, device, rows = device_profile(torch, lambda: train_step(mod, batch),
                                        reps=3)
    print("lstm: %s step: %.3f ms wall = %.0f tokens/s; profile: %.3f ms "
          "wall, device %.3f ms, busy share %.3f (card %s)"
          % (name, step_s * 1e3, tokens / step_s, wall, device,
             device / wall if wall else 0.0, smi))
    for t, key, n in rows[:6]:
        print("profile:   %8.3f ms  %5.1f%%  x%-4d %s"
              % (t, 100.0 * t / device if device else 0.0, n, key[:90]))
    groups = print_groups(rows, device, lstm_group, width=16)
    return {"tokens_s": tokens / step_s, "step_ms": step_s * 1e3,
            "wall": wall, "device": device, "groups": groups}


def lstm_headline(torch, mt, arg0, smi):
    """(a) lstm_unroll through Module at batch 2048: 3 eager warm-up
    steps, 1 capture, 20 replays; the last replay against the same step
    eager from the same state; the 23 steps bitwise against the classic
    path's with deterministic algorithms; tokens/s and profile, and the
    same with the table trained densely (MXNET_EMBED_SPARSE=0); the lazy
    update against the classic path's dense one at momentum 0."""
    b, gpu = LSTM_BATCH, mt.gpu(0)
    rng = np.random.default_rng(21)
    staged = [token_batch(mt, rng, gpu, b, LSTM_SEQ, LSTM_HIDDEN) for _ in range(2)]
    steps = RESNET_WARMUP + LSTM_REPLAYS
    build = mt.models.lstm_unroll

    def trained(fused, opt=LSTM_OPT, steps=steps):
        mod = lstm_module(mt, build, LSTM_HIDDEN, b, arg0, fused, opt=opt)
        for i in range(steps):
            train_step(mod, staged[i % 2])
        out = host_params(mod)
        del mod
        torch.cuda.empty_cache()
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mod = lstm_module(mt, build, LSTM_HIDDEN, b, arg0, True)
    fused = mod._fused
    losses = []
    for i in range(steps):
        if i == steps - 1:
            snap = clone_state(torch, fused.state)
        train_step(mod, staged[i % 2])
        if i in (0, steps - 1):
            losses.append(lstm_loss(torch, mod, staged[i % 2]))
    stats = fused.stats.report()
    peak = torch.cuda.max_memory_allocated()
    replayed = clone_state(torch, fused.state)
    got = state_params(fused.state)
    restore_state(torch, fused.state, snap)
    fused._body(fused.make_batch(staged[(steps - 1) % 2]))
    eager = state_params(fused.state)
    restore_state(torch, fused.state, replayed)
    del snap, replayed
    replay_err = worst_rel(got, eager, REPLAY_ATOL)
    print("lstm: %dx%d batch %d seq %d vocab %d, %d steps: %s; loss %.4f -> "
          "%.4f; peak memory %.2f GiB (card %s)"
          % (LSTM_LAYERS, LSTM_HIDDEN, b, LSTM_SEQ, LSTM_VOCAB, steps, stats,
             losses[0], losses[-1], peak / 2**30, smi))
    print("lstm: last replay vs the same step eager from the same state: "
          "smallest rtol at atol %g: %.3g (gate %g)"
          % (REPLAY_ATOL, replay_err, REPLAY_RTOL))
    if stats != {"captures": 1, "replays": LSTM_REPLAYS,
                 "eager_steps": RESNET_WARMUP}:
        fail("lstm fused step counts %s" % stats)
    if not all(math.isfinite(v) for v in losses):
        fail("lstm loss not finite: %s" % losses)
    if not params_close(got, eager, REPLAY_RTOL, REPLAY_ATOL):
        fail("lstm replay differs from the eager step")
    rate = lstm_rate(torch, "headline b%d" % b, mod, staged[0],
                     b * LSTM_SEQ, smi)
    if fused.stats.captures != 1:
        fail("lstm recaptured: %s" % fused.stats.report())
    # the ids staged on the card reach embed_report() through a
    # non-blocking copy, read a batch later
    sampled = sum(d["lookups"] for d in
                  fused.embed_stats.report()["tables"].values())
    print("lstm: embed_report sampled %d of %d batches staged on the card, "
          "dedup ratio %.3f" % (sampled, fused._embed_stats_n,
                                fused.embed_stats.dedup_ratio()))
    if not sampled:
        fail("lstm: no batch staged on the card reached embed_report")
    del mod, fused, got, eager
    torch.cuda.empty_cache()
    with env_set("MXNET_EMBED_SPARSE", "0"):
        mod = lstm_module(mt, build, LSTM_HIDDEN, b, arg0, True)
    for i in range(RESNET_WARMUP + 1):
        train_step(mod, staged[i % 2])
    dense_rate = lstm_rate(torch, "headline b%d, table dense "
                           "(MXNET_EMBED_SPARSE=0)" % b, mod, staged[0],
                           b * LSTM_SEQ, smi)
    del mod
    torch.cuda.empty_cache()

    # the captured steps against the classic path's eager steps, both
    # with deterministic algorithms (Embedding's weight gradient is an
    # index_put_ with accumulation, sorted; cuBLAS keeps one workspace).
    # The classic path trains the embedding densely; the fused step's
    # default is the lazy row update (phase 19), which leaves the rows a
    # batch misses where they are: both dense here
    torch.use_deterministic_algorithms(True)
    try:
        with env_set("MXNET_EMBED_SPARSE", "0"):
            det_f = trained(True)
        det_c = trained(False)
    finally:
        torch.use_deterministic_algorithms(False)
    det_err = worst_rel(det_f, det_c, 0.0)
    bitwise = all(np.array_equal(g[k], w[k])
                  for g, w in zip(det_f, det_c) for k in w)
    print("lstm: %d captured steps (MXNET_EMBED_SPARSE=0) vs %d classic "
          "eager steps, deterministic algorithms: bitwise equal %s "
          "(smallest rtol at atol 0: %.3g)"
          % (steps, steps, bitwise, det_err))
    if not bitwise:
        fail("lstm captured steps differ from the classic eager steps under "
             "deterministic algorithms")
    # the default lazy update against the classic path's dense one where
    # the two agree: momentum 0 and no weight decay leave an untouched
    # row where it is in both (captured: 3 eager steps, the capture, a
    # replay)
    zero = dict(LSTM_OPT, momentum=0.0)
    torch.use_deterministic_algorithms(True)
    try:
        lazy_f = trained(True, zero, RESNET_WARMUP + 2)
        dense_c = trained(False, zero, RESNET_WARMUP + 2)
    finally:
        torch.use_deterministic_algorithms(False)
    lazy_err = worst_rel(lazy_f, dense_c, REPLAY_ATOL)
    lazy_bitwise = all(np.array_equal(g[k], w[k])
                       for g, w in zip(lazy_f, dense_c) for k in w)
    print("lstm: %d captured steps with the lazy table update (the default) "
          "vs %d classic steps, momentum 0: bitwise %s, smallest rtol at "
          "atol %g: %.3g (gate %g)" % (
              RESNET_WARMUP + 2, RESNET_WARMUP + 2, lazy_bitwise,
              REPLAY_ATOL, lazy_err, REPLAY_RTOL))
    if not params_close(lazy_f, dense_c, REPLAY_RTOL, REPLAY_ATOL):
        fail("lstm lazy table update departs from the classic dense one at "
             "momentum 0")
    return {"rate": rate, "dense_rate": dense_rate, "stats": stats,
            "peak_gib": peak / 2**30, "losses": losses,
            "replay_rtol": replay_err, "bitwise": bitwise,
            "lazy_rtol": lazy_err}


def lstm_leg(torch, mt, name, hidden, batch, smi, seed):
    """bench.py's other legs: the same step at another width or batch."""
    arg = lstm_params(mt, hidden, seed)
    rng = np.random.default_rng(seed + 1)
    staged = token_batch(mt, rng, mt.gpu(0), batch, LSTM_SEQ, hidden)
    mod = lstm_module(mt, mt.models.lstm_unroll, hidden, batch, arg, True)
    for _ in range(RESNET_WARMUP + 1):
        train_step(mod, staged)
    rate = lstm_rate(torch, name, mod, staged, batch * LSTM_SEQ, smi)
    loss = lstm_loss(torch, mod, staged)
    stats = mod._fused.stats.report()
    print("lstm: %s fused step %s, loss %.4f" % (name, stats, loss))
    if stats["captures"] != 1 or not math.isfinite(loss):
        fail("lstm %s: %s, loss %s" % (name, stats, loss))
    del mod
    torch.cuda.empty_cache()
    return rate


def scan_phase(torch, mt, arg0, smi):
    """(b) lstm_unroll_scan (the RNN op) against lstm_unroll from one
    checkpoint at batch 2048 (output and gradients), then its captured
    step's tokens/s."""
    b, gpu = LSTM_BATCH, mt.gpu(0)
    batch = token_batch(mt, np.random.default_rng(23), gpu, b, LSTM_SEQ,
                        LSTM_HIDDEN)
    shapes = dict([("data", (b, LSTM_SEQ)), ("softmax_label", (b, LSTM_SEQ))]
                  + lstm_states(b, LSTM_HIDDEN))
    res = []
    for build in (mt.models.lstm_unroll, mt.models.lstm_unroll_scan):
        sym = build(LSTM_LAYERS, LSTM_SEQ, LSTM_VOCAB, LSTM_HIDDEN,
                    LSTM_HIDDEN, LSTM_VOCAB)
        exe = sym.simple_bind(gpu, grad_req="write", **shapes)
        exe.copy_params_from(arg0)
        exe.arg_dict["data"][:] = batch.data[0]
        exe.arg_dict["softmax_label"][:] = batch.label[0]
        exe.forward(is_train=True)
        exe.backward()
        res.append((exe.outputs[0]._get(),
                    {n: exe.grad_dict[n]._get().clone() for n in arg0}))
        del exe

    def reldiff(a, b_):
        return float((a.double() - b_.double()).abs().sum()
                     / (a.double().abs().sum() + 1e-12))
    out_rel = reldiff(res[0][0], res[1][0])
    grad_rel = {n: reldiff(res[0][1][n], res[1][1][n]) for n in arg0}
    worst = max(grad_rel, key=grad_rel.get)
    print("lstm scan: RNN-op form vs unrolled, batch %d, one checkpoint: "
          "output relative difference %.3g (gate %g), gradients worst %.3g "
          "at %s (gate %g)" % (b, out_rel, SCAN_OUT_TOL, grad_rel[worst],
                               worst, SCAN_GRAD_TOL))
    del res
    torch.cuda.empty_cache()
    if out_rel >= SCAN_OUT_TOL or grad_rel[worst] >= SCAN_GRAD_TOL:
        fail("lstm_unroll_scan differs from lstm_unroll")
    mod = lstm_module(mt, mt.models.lstm_unroll_scan, LSTM_HIDDEN, b, arg0, True)
    for _ in range(RESNET_WARMUP + 1):
        train_step(mod, batch)
    rate = lstm_rate(torch, "scan b%d" % b, mod, batch, b * LSTM_SEQ, smi)
    stats = mod._fused.stats.report()
    loss = lstm_loss(torch, mod, batch)
    print("lstm scan: fused step %s, loss %.4f" % (stats, loss))
    if stats["captures"] != 1 or not math.isfinite(loss):
        fail("lstm scan step: %s, loss %s" % (stats, loss))
    del mod
    torch.cuda.empty_cache()
    return {"out_rel": out_rel, "grad_rel": grad_rel[worst], "rate": rate}


class BucketBatches:
    """A seeded plan of batches over the buckets with the surface of
    example/rnn/bucket_io.py's BucketSentenceIter (host arrays; the init
    states in the example's order)."""

    def __init__(self, mt, seed):
        rng = np.random.default_rng(seed)
        keys = rng.permutation(np.repeat(BUCKETS, BUCKET_BATCHES
                                         // len(BUCKETS)))
        self.batches = [token_batch(mt, rng, mt.cpu(), BUCKET_BATCH, int(k),
                                    LSTM_HIDDEN, states_order=list)
                        for k in keys]
        self.batch_size = BUCKET_BATCH
        self.default_bucket_key = max(BUCKETS)
        self.provide_data = [("data", (BUCKET_BATCH, max(BUCKETS)))] + \
            lstm_states(BUCKET_BATCH, LSTM_HIDDEN, list)
        self.provide_label = [("softmax_label",
                               (BUCKET_BATCH, max(BUCKETS)))]
        self.tokens = sum(BUCKET_BATCH * b.bucket_key for b in self.batches)
        self._pos = 0

    def reset(self):
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._pos == len(self.batches):
            raise StopIteration
        self._pos += 1
        return self.batches[self._pos - 1]


def bucketing_phase(torch, mt, arg0, smi):
    """(c) BucketingModule.fit at lstm_bucketing.py's settings: 2 epochs
    over 8 seeded batches across buckets 10/20/30/40 on the card and on
    the CPU; 4 bucket modules sharing one parameter storage; the card's
    params against the CPU's; tokens/s and busy share of the classic
    eager step."""
    it = BucketBatches(mt, 31)
    names = [n for n, _ in lstm_states(BUCKET_BATCH, LSTM_HIDDEN, list)]

    def sym_gen(seq_len):
        sym = mt.models.lstm_unroll(LSTM_LAYERS, seq_len, LSTM_VOCAB,
                                    LSTM_HIDDEN, LSTM_HIDDEN, LSTM_VOCAB)
        return sym, tuple(["data"] + names), ("softmax_label",)

    def fit(ctx, marks=None):
        def mark(p):
            if marks is not None and p.epoch == BUCKET_EPOCHS - 1:
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
        mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=max(BUCKETS),
                                     context=ctx)
        it.reset()
        mod.fit(it, num_epoch=BUCKET_EPOCHS, eval_metric="ce",
                optimizer="sgd", optimizer_params=dict(BUCKET_OPT),
                arg_params=arg0, aux_params={}, batch_end_callback=mark)
        return mod

    marks = []
    t0 = time.perf_counter()
    card = fit(mt.gpu(0), marks)
    card_s = time.perf_counter() - t0
    card_params = host_params(card)
    t0 = time.perf_counter()
    cpu_params = host_params(fit(mt.cpu()))
    cpu_s = time.perf_counter() - t0
    mods = card._buckets
    shared = all(len({m._exec_group.execs[0].arg_dict[n]._get().data_ptr()
                      for m in mods.values()}) == 1
                 for n in mods[max(BUCKETS)]._param_names)
    fused_off = all(m._fused is None for m in mods.values())
    tokens = it.tokens - BUCKET_BATCH * it.batches[0].bucket_key
    rate = tokens / (marks[-1] - marks[0])
    err = worst_rel(card_params, cpu_params, LENET_CPU_ATOL)
    print("lstm bucketing: %d epochs x %d batches, buckets %s at batch %d: "
          "fit %.1f s on the card, %.1f s on the CPU; %d bucket modules, one "
          "parameter storage %s, all classic %s; card vs cpu smallest rtol at "
          "atol %g: %.3g (gate %g)"
          % (BUCKET_EPOCHS, len(it.batches), BUCKETS, BUCKET_BATCH, card_s,
             cpu_s, len(mods), shared, fused_off, LENET_CPU_ATOL, err,
             LENET_CPU_RTOL))
    if sorted(mods) != sorted(BUCKETS) or not shared or not fused_off:
        fail("bucketing: buckets %s, shared storage %s, classic %s"
             % (sorted(mods), shared, fused_off))
    if not params_close(card_params, cpu_params, LENET_CPU_RTOL,
                        LENET_CPU_ATOL):
        fail("bucketing params on the card differ from the CPU run")
    # one classic step of the longest bucket, as fit runs it (the batch
    # copied in, the cross-entropy on the host)
    b40 = next(b for b in it.batches if b.bucket_key == max(BUCKETS))
    metric = mt.metric.create("ce")

    def step():
        card.forward(b40, is_train=True)
        card.backward()
        card.update()
        card.update_metric(metric, b40.label)
    wall, device, rows = device_profile(torch, step, reps=3)
    print("lstm bucketing: fit %.0f tokens/s over epoch %d's last %d "
          "batches; a bucket-%d step %.3f ms wall, device %.3f ms, busy "
          "share %.3f (card %s)"
          % (rate, BUCKET_EPOCHS, len(it.batches) - 1, max(BUCKETS), wall,
             device, device / wall if wall else 0.0, smi))
    groups = print_groups(rows, device, lstm_group, width=16)
    del card
    torch.cuda.empty_cache()
    return {"tokens_s": rate, "wall": wall, "device": device,
            "groups": groups, "rtol": err}


def lstm_phase(torch, mt, ck, smi):
    print("lstm: TF32 allow_tf32 matmul=%s cudnn=%s (float32 products "
          "throughout); card %s" % (torch.backends.cuda.matmul.allow_tf32,
                                    torch.backends.cudnn.allow_tf32, smi))
    ck.reset_launches()
    t0 = time.perf_counter()
    arg0 = lstm_params(mt, LSTM_HIDDEN, 20)
    print("lstm: %d parameters (Xavier, seed 20)"
          % sum(v.size for v in arg0.values()))
    head = lstm_headline(torch, mt, arg0, smi)
    legs = {name: lstm_leg(torch, mt, name, hidden, batch, smi, 40 + i)
            for i, (name, hidden, batch) in enumerate(LSTM_LEGS)}
    scan = scan_phase(torch, mt, arg0, smi)
    bucket = bucketing_phase(torch, mt, arg0, smi)
    launches = dict(ck.LAUNCHES)
    print("lstm: hand-kernel launches on the LSTM paths: %s; phase %.1f s"
          % (launches, time.perf_counter() - t0))
    if any(launches.values()):
        fail("the LSTM paths launched hand kernels: %s" % launches)
    return {"headline": head, "legs": legs, "scan": scan,
            "bucketing": bucket, "launches": launches}


# ---------------------------------------------------------------------------
# phase 15: the image zoo trained on the card
#
# DCGAN's adversarial loop (example/gan/dcgan.py:186-227) at the
# published width (Radford et al. 2015, section 4): ngf = ndf = 64, a
# 100-wide code, 64x64x3 images, batch 128, Normal(0.02) weights, Adam
# with lr 2e-4 and beta1 0.5.  Images and codes come from a numpy seed.
DCGAN = dict(ngf=64, ndf=64, code=100, batch=128)
DCGAN_OPT = {"learning_rate": 2e-4, "beta1": 0.5, "wd": 0.0}
DCGAN_ITERS, DCGAN_CHECKED = 20, 2
# card against the port's CPU run, teacher-forced: each of the first 2
# iterations runs on the CPU from the card's state before it, and G's pass
# runs through the card's D after D's step (Adam's first steps move each
# element by about lr * sign(g), so an element whose gradient sits at
# float noise may land 2 lr apart, and a D that differs there would
# carry that into G's gradient).  D's outputs within 1e-3 of their
# largest value.  Gradients of both nets: per tensor, a relative L2
# difference within 1e-2: cuDNN and the CPU sum the convolutions in other
# orders (~1e-6 relative), and a relu (G) or leaky relu (D) after
# BatchNorm whose input lies within that noise of 0 takes the other side
# on one of the two (G's BatchNorms make 15 M outputs an iteration at
# batch 128), which moves that channel's gradients through BatchNorm's
# backward (measured on an H100 80GB HBM3 at 700 W: up to 2.7e-3
# relative L2, 9e-3 of a tensor's largest value, at iteration 2).
# Params after the first step: the elements that land more than lr/100
# apart are at most DCGAN_FLIP_SHARE of all, and each has a gradient
# below 1e-2 of its tensor's largest: Adam's sign, not the arithmetic.
# After the second step Adam's ratio m/sqrt(v) is sensitive wherever the
# two gradients nearly cancel, so those params are reported, not gated
# (its gradients are)
DCGAN_GRAD_REL, DCGAN_OUT_REL = 1e-2, 1e-3
DCGAN_FLIP_SHARE = 1e-2


def dcgan_params(mx, ngf, ndf, code, seed):
    """Normal(0.02) weights for the generator and the discriminator from a
    numpy seed, BatchNorm gamma 1 and beta 0, moving mean 0 and variance
    1 (the reference initializer's rules for those names)."""
    rng = np.random.default_rng(seed)
    out = []
    for sym, shapes in ((mx.models.make_generator(ngf=ngf, code_dim=code),
                         {"rand": (1, code, 1, 1)}),
                        (mx.models.make_discriminator(ndf=ndf),
                         {"data": (1, 3, 64, 64), "label": (1,)})):
        arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
        arg = {}
        for name, shape in zip(sym.list_arguments(), arg_shapes):
            if name in shapes:
                continue
            arg[name] = np.ones(shape, np.float32) if name.endswith(
                "_gamma") else np.zeros(shape, np.float32) if \
                name.endswith("_beta") else rng.normal(
                    0.0, 0.02, shape).astype(np.float32)
        aux = {name: (np.ones if name.endswith("_var") else np.zeros)(
            shape, np.float32) for name, shape in
            zip(sym.list_auxiliary_states(), aux_shapes)}
        out.append((arg, aux))
    return out


def dcgan_modules(mx, ctx, ngf, ndf, code, batch, params):
    """The generator and discriminator modules of example/gan/dcgan.py,
    bound on ``ctx`` from host params; works with either package."""
    def nd(d):
        return {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in d.items()}
    (garg, gaux), (darg, daux) = params
    mod_g = mx.mod.Module(mx.models.make_generator(ngf=ngf, code_dim=code),
                          data_names=("rand",), label_names=None,
                          context=ctx)
    mod_g.bind(data_shapes=[("rand", (batch, code, 1, 1))],
               label_shapes=None, for_training=True)
    mod_g.init_params(arg_params=nd(garg), aux_params=nd(gaux))
    mod_g.init_optimizer(optimizer="adam", optimizer_params=dict(DCGAN_OPT))
    mod_d = mx.mod.Module(mx.models.make_discriminator(ndf=ndf),
                          data_names=("data",), label_names=("label",),
                          context=ctx)
    mod_d.bind(data_shapes=[("data", (batch, 3, 64, 64))],
               label_shapes=[("label", (batch,))], for_training=True,
               inputs_need_grad=True)
    mod_d.init_params(arg_params=nd(darg), aux_params=nd(daux))
    mod_d.init_optimizer(optimizer="adam", optimizer_params=dict(DCGAN_OPT))
    return mod_g, mod_d


def dcgan_iteration(mx, mod_g, mod_d, rand, real, label, grads=None,
                    after_d_update=None):
    """One iteration of example/gan/dcgan.py's loop: D on fake keeps its
    gradients, D on real adds its own and steps, then G steps through
    D's input gradients.  A dict ``grads`` gets host copies of D's summed
    gradients and G's gradients before their updates;
    ``after_d_update()`` runs between D's step and G's pass.  -> D's
    outputs on fake, on real, and on fake after D's step, as numpy."""
    batch = mx.io.DataBatch
    mod_g.forward(batch(data=[rand], label=None), is_train=True)
    out_g = mod_g.get_outputs()
    label[:] = 0
    mod_d.forward(batch(data=out_g, label=[label]), is_train=True)
    mod_d.backward()
    fake = mod_d.get_outputs()[0].asnumpy()
    grad_d = [[g.copy() for g in gs] for gs in mod_d._exec_group.grad_arrays]
    label[:] = 1
    mod_d.forward(batch(data=[real], label=[label]), is_train=True)
    mod_d.backward()
    real_out = mod_d.get_outputs()[0].asnumpy()
    for gs_r, gs_f in zip(mod_d._exec_group.grad_arrays, grad_d):
        for gr, gf in zip(gs_r, gs_f):
            if gr is not None:
                gr[:] = gr + gf
    if grads is not None:
        for n, gs in zip(mod_d._param_names, mod_d._exec_group.grad_arrays):
            grads["d:" + n] = gs[0].asnumpy()
    mod_d.update()
    if after_d_update is not None:
        after_d_update()
    label[:] = 1
    mod_d.forward(batch(data=out_g, label=[label]), is_train=True)
    mod_d.backward()
    fooled = mod_d.get_outputs()[0].asnumpy()
    mod_g.backward(mod_d.get_input_grads())
    if grads is not None:
        for n, gs in zip(mod_g._param_names, mod_g._exec_group.grad_arrays):
            grads["g:" + n] = gs[0].asnumpy()
    mod_g.update()
    return fake, real_out, fooled


def dcgan_data(code, batch, iters, seed):
    """Codes N(0, 1) and images in [-1, 1] (the generator's tanh range)
    from a numpy seed, one pair an iteration."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, code, 1, 1), dtype=np.float32),
             (rng.random((batch, 3, 64, 64), dtype=np.float32) * 2 - 1))
            for _ in range(iters)]


def gan_entropy(fake, real, fooled):
    """Binary cross-entropies of the iteration: D's loss on fake (label
    0) and real (label 1), G's loss (fake judged with label 1)."""
    def bce(p, y):
        p = np.clip(p.reshape(-1), 1e-12, 1 - 1e-12)
        return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())
    return bce(fake, 0.0) + bce(real, 1.0), bce(fooled, 1.0)


def both_params(mod_g, mod_d):
    return ({"g:" + k: v for k, v in host_params(mod_g)[0].items()},
            {"d:" + k: v for k, v in host_params(mod_d)[0].items()})


def max_rel_diff(got, want):
    """max |got - want| over max |want| (0 when both are all zero)."""
    scale = float(np.abs(want).max())
    diff = float(np.abs(got - want).max())
    return diff / scale if scale else (0.0 if diff == 0 else math.inf)


def rel_l2_diff(got, want):
    """||got - want|| over ||want|| (0 when both are all zero)."""
    scale = float(np.linalg.norm(want))
    diff = float(np.linalg.norm(got - want))
    return diff / scale if scale else (0.0 if diff == 0 else math.inf)


def gan_group(name):
    """Kernel groups of a DCGAN iteration: cuDNN runs a transposed
    convolution's forward as a data-gradient (dgrad) kernel and its data
    gradient as a forward (fprop) kernel."""
    group = train_group(name)
    return {"conv bwd data": "dgrad (deconv fwd, conv bwd data)",
            "conv fwd": "fprop (conv fwd, deconv bwd data)"}.get(group, group)


def adam_apart(after, want, grads, lr):
    """Elements of ``after`` more than lr/100 from ``want``: (their share,
    the largest |grad| / max |grad| of its tensor among them)."""
    moved, total, worst = 0, 0, 0.0
    for k in want:
        apart = np.abs(after[k] - want[k]) > lr / 100
        moved += int(apart.sum())
        total += apart.size
        scale = float(np.abs(grads[k]).max())
        if apart.any() and scale:
            worst = max(worst, float(np.abs(grads[k][apart]).max()) / scale)
    return moved / float(total), worst


def dcgan_phase(torch, mt, smi):
    """(a) DCGAN's adversarial loop at the published width on the card,
    20 iterations; the first 2 against the port's CPU run, teacher-forced
    from the card's state."""
    c, b = DCGAN, DCGAN["batch"]
    lr = DCGAN_OPT["learning_rate"]
    params = dcgan_params(mt, c["ngf"], c["ndf"], c["code"], seed=50)
    data = dcgan_data(c["code"], b, DCGAN_ITERS, seed=51)
    n_g = sum(v.size for v in params[0][0].values())
    n_d = sum(v.size for v in params[1][0].values())

    def setup(ctx):
        mod_g, mod_d = dcgan_modules(mt, ctx, c["ngf"], c["ndf"], c["code"],
                                     b, params)
        return mod_g, mod_d, mt.nd.zeros((b,), ctx=ctx)

    def feed(ctx, i):
        return (mt.nd.array(data[i][0], ctx=ctx),
                mt.nd.array(data[i][1], ctx=ctx))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gpu = mt.gpu(0)
    mod_g, mod_d, label = setup(gpu)
    feeds = [feed(gpu, i) for i in range(DCGAN_ITERS)]
    card, losses, marks = [], [], []
    for i in range(DCGAN_ITERS):
        rec = {}
        if i < DCGAN_CHECKED:
            rec["before"] = (host_params(mod_g), host_params(mod_d))
            rec["grads"] = {}

            def keep_d(rec=rec):
                rec["d_after"] = host_params(mod_d)
        out = dcgan_iteration(mt, mod_g, mod_d, feeds[i][0], feeds[i][1],
                              label, rec.get("grads"),
                              keep_d if i < DCGAN_CHECKED else None)
        marks.append(time.perf_counter())
        losses.append(gan_entropy(*out))
        if i < DCGAN_CHECKED:
            rec["g_after"] = host_params(mod_g)
            rec["out"] = out
            card.append(rec)
    peak = torch.cuda.max_memory_allocated()
    # iterations 4..20: each ends in D's outputs read on the host
    rate = (DCGAN_ITERS - 3) / (marks[-1] - marks[2])
    wall, device, rows = device_profile(
        torch, lambda: dcgan_iteration(mt, mod_g, mod_d, feeds[0][0],
                                       feeds[0][1], label), reps=3)
    print("zoo: dcgan ngf=ndf=%d, code %d, 64x64x3, batch %d: G %d and D %d "
          "parameters (Normal(0.02), seed 50), Adam lr %g beta1 %g; %d "
          "iterations: %.2f it/s (%.1f img/s) over iterations 4..%d; "
          "losses D %.4f -> %.4f, G %.4f -> %.4f; peak memory %.2f GiB; "
          "card %s" % (c["ngf"], c["code"], b, n_g, n_d, lr,
                       DCGAN_OPT["beta1"], DCGAN_ITERS, rate, rate * b,
                       DCGAN_ITERS, losses[0][0], losses[-1][0],
                       losses[0][1], losses[-1][1], peak / 2**30, smi))
    print("zoo: dcgan iteration profile: %.3f ms wall, device %.3f ms, busy "
          "share %.3f; G fused step %s, D fused step %s (the classic path: "
          "G takes D's input gradients, D keeps its own)"
          % (wall, device, device / wall if wall else 0.0,
             mod_g._fused is not None, mod_d._fused is not None))
    groups = print_groups(rows, device, gan_group, width=34)
    for t, key, n in rows[:6]:
        print("profile:   %8.3f ms  %5.1f%%  x%-3d %s"
              % (t, 100.0 * t / device if device else 0.0, n, key[:90]))
    del mod_g, mod_d, feeds
    torch.cuda.empty_cache()

    # the port's CPU run of each checked iteration from the card's state
    t0 = time.perf_counter()
    cpu = mt.cpu()
    mod_g, mod_d, label = setup(cpu)
    checks = []
    for i, rec in enumerate(card):
        if i:
            for mod, (arg, aux) in zip((mod_g, mod_d), rec["before"]):
                mod.set_params({k: mt.nd.array(v, ctx=cpu)
                                for k, v in arg.items()},
                               {k: mt.nd.array(v, ctx=cpu)
                                for k, v in aux.items()})
        grads, mine = {}, {}

        def force_d(rec=rec, mine=mine):
            mine["d_after"] = host_params(mod_d)
            mod_d.set_params({k: mt.nd.array(v, ctx=cpu)
                              for k, v in rec["d_after"][0].items()},
                             {k: mt.nd.array(v, ctx=cpu)
                              for k, v in rec["d_after"][1].items()})
        out = dcgan_iteration(mt, mod_g, mod_d, *feed(cpu, i), label, grads,
                              force_d)
        worst = max(((rel_l2_diff(rec["grads"][k], grads[k]), k)
                     for k in grads), key=lambda kv: kv[0])
        peak_err = max(max_rel_diff(rec["grads"][k], grads[k])
                       for k in grads)
        o_err = max(max_rel_diff(g, w) for g, w in zip(rec["out"], out))
        d_share, d_grad = adam_apart(rec["d_after"][0],
                                     mine["d_after"][0],
                                     {k[2:]: v for k, v in grads.items()
                                      if k.startswith("d:")}, lr)
        g_share, g_grad = adam_apart(host_params(mod_g)[0],
                                     rec["g_after"][0],
                                     {k[2:]: v for k, v in grads.items()
                                      if k.startswith("g:")}, lr)
        checks.append((i + 1, worst, peak_err, o_err, d_share, d_grad,
                       g_share, g_grad))
    cpu_s = time.perf_counter() - t0
    for it, worst, peak_err, o_err, d_share, d_grad, g_share, g_grad in \
            checks:
        print("zoo: dcgan iteration %d card vs cpu (teacher-forced, %.1f s "
              "on the CPU): gradients' largest relative L2 difference %.3g "
              "(%s; gate %g), largest max|diff|/max|cpu| %.3g; D's outputs "
              "%.3g (gate %g); params more than lr/100 apart after the "
              "step: D %.3g, G %.3g of elements (gate %g after step 1), "
              "their largest |grad|/max|grad| D %.3g, G %.3g (gate 1e-2 "
              "after step 1)"
              % (it, cpu_s, worst[0], worst[1], DCGAN_GRAD_REL, peak_err,
                 o_err, DCGAN_OUT_REL, d_share, g_share, DCGAN_FLIP_SHARE,
                 d_grad, g_grad))
        if worst[0] > DCGAN_GRAD_REL or o_err > DCGAN_OUT_REL:
            fail("dcgan iteration %d on the card differs from the CPU run"
                 % it)
        if it == 1 and (max(d_share, g_share) > DCGAN_FLIP_SHARE
                        or max(d_grad, g_grad) > 1e-2):
            fail("dcgan params after iteration %d differ from the CPU run "
                 "beyond Adam's sign at noise-level gradients" % it)
    if not all(math.isfinite(v) for pair in losses for v in pair):
        fail("dcgan losses not finite: %s" % losses)
    return {"it_s": rate, "img_s": rate * b, "wall": wall, "device": device,
            "groups": groups, "peak_gib": peak / 2**30, "checks": checks,
            "losses": losses[-1]}


# Fast R-CNN at the repo's full trunk (VGG-16 conv1_1..conv4_3, stride 8):
# Fast R-CNN's scale 600 (600x800 images), 2 images and 128 ROIs a batch,
# 64 an image; SGD lr 1e-3, momentum 0.9, wd 5e-4 (Girshick 2015, 2.3).
RCNN = dict(images=2, height=600, width=800, rois=128, classes=21)
RCNN_OPT = {"learning_rate": 1e-3, "momentum": 0.9, "wd": 5e-4}
RCNN_STEPS = 5
# card against the CPU: the first step's gradients, per tensor a relative
# L2 difference within 1e-2: cuDNN and the CPU sum the convolutions in
# other orders (~1e-6 relative), and the trunk's ten relus and three max
# pools at 600x800 route a gradient the other way wherever a
# pre-activation or a near-tie lies within that noise (measured on an
# H100 80GB HBM3 at 700 W: conv1_1_weight 2.9e-3, the head behind
# ROIPooling 1.4e-6).  ROIPooling's output equal and its data gradient
# within rtol 1e-5, atol 1e-6 (its float32 sums of tie shares run in
# another order)
RCNN_GRAD_REL = 1e-2


def rcnn_batch(rng, c):
    n, r, k = c["images"], c["rois"], c["classes"]
    data = rng.standard_normal((n, 3, c["height"], c["width"]),
                               dtype=np.float32)
    x1 = rng.uniform(0, c["width"] - 32, r)
    y1 = rng.uniform(0, c["height"] - 32, r)
    w = rng.uniform(16, c["width"] / 2, r)
    h = rng.uniform(16, c["height"] / 2, r)
    rois = np.stack([np.repeat(np.arange(n), r // n), x1, y1,
                     np.minimum(x1 + w, c["width"] - 1),
                     np.minimum(y1 + h, c["height"] - 1)],
                    1).astype(np.float32)
    label = rng.integers(0, k, r).astype(np.float32)
    target = (rng.standard_normal((r, 4 * k)) * 0.1).astype(np.float32)
    weight = np.zeros((r, 4 * k), np.float32)
    for i, lab in enumerate(label.astype(int)):
        if lab > 0:
            weight[i, 4 * lab:4 * lab + 4] = 1.0
    return [data, rois], [label, target, weight]


def roi_pool_check(torch, mt, rois, smi, seed=60):
    """ROIPooling at the Fast R-CNN path's shape (2 x 512 x 75 x 100 conv4_3
    features, 128 ROIs, 7x7 bins): card against CPU, timed, and its peak
    memory against the JAX formulation's mask."""
    from mxnet_tpu_torch.ops.special import _ROIPool
    c = RCNN
    shape = (c["images"], 512, c["height"] // 8, c["width"] // 8)
    rng = np.random.default_rng(seed)
    feat = np.maximum(rng.standard_normal(shape, dtype=np.float32), 0)
    head = rng.standard_normal((c["rois"], 512, 7, 7), dtype=np.float32)

    def run(dev):
        x = torch.from_numpy(feat).to(dev).requires_grad_(True)
        out = _ROIPool.apply(x, torch.from_numpy(rois).to(dev), (7, 7),
                             0.125)
        out.backward(torch.from_numpy(head).to(dev))
        return out.detach().cpu().numpy(), x.grad.cpu().numpy()
    dev = torch.device("cuda", 0)
    run(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got, got_g = run(dev)
    peak = torch.cuda.max_memory_allocated() - base
    want, want_g = run(torch.device("cpu"))
    x = torch.from_numpy(feat).to(dev).requires_grad_(True)
    r = torch.from_numpy(rois).to(dev)
    g = torch.from_numpy(head).to(dev)
    fwd = time_ms(torch, lambda: _ROIPool.apply(x.detach(), r, (7, 7), 0.125),
                  torch.empty(64 * 2**20, dtype=torch.float32, device=dev),
                  iters=10)

    def fwd_bwd():
        out = _ROIPool.apply(x, r, (7, 7), 0.125)
        torch.autograd.grad(out, x, g)
    both = time_ms(torch, fwd_bwd, torch.empty(64 * 2**20,
                                               dtype=torch.float32,
                                               device=dev), iters=10)
    mask = c["rois"] * 512 * 49 * shape[2] * shape[3] * 4
    ok = np.array_equal(got, want) and np.allclose(got_g, want_g, rtol=1e-5,
                                                   atol=1e-6)
    print("zoo: rcnn ROIPooling at %s, %d ROIs, 7x7: card == cpu forward "
          "%s, data gradient max|diff| %.3g (rtol 1e-5, atol 1e-6); forward "
          "%.3f ms, forward+backward %.3f ms; peak memory of the op %.1f MiB "
          "(the JAX formulation's mask alone: %.1f GiB, not built); card %s"
          % (shape, c["rois"], np.array_equal(got, want),
             float(np.abs(got_g - want_g).max()), fwd, both, peak / 2**20,
             mask / 2**30, smi))
    if not ok:
        fail("ROIPooling on the card differs from the CPU run")
    return {"fwd_ms": fwd, "fwd_bwd_ms": both, "peak_mib": peak / 2**20,
            "mask_gib": mask / 2**30}


def rcnn_phase(torch, mt, smi):
    """(b) Fast R-CNN with the full trunk: 5 classic steps through Module
    on the card, the first step's gradients against the CPU's, and
    ROIPooling at the path's shape."""
    c = RCNN
    sym = mt.models.get_fast_rcnn(num_classes=c["classes"],
                                  pooled_size=(7, 7), spatial_scale=0.125,
                                  small=False)
    data_names, label_names = ["data", "rois"], \
        ["label", "bbox_target", "bbox_weight"]
    rng = np.random.default_rng(61)
    batches = [rcnn_batch(rng, c) for _ in range(RCNN_STEPS)]
    shapes = dict(zip(data_names + label_names,
                      [a.shape for a in batches[0][0] + batches[0][1]]))
    params = xavier_params(sym, shapes, 62)

    def module(ctx):
        with fused_train_env(False):
            mod = mt.mod.Module(sym, data_names=data_names,
                                label_names=label_names, context=ctx)
            mod.bind([(n, shapes[n]) for n in data_names],
                     [(n, shapes[n]) for n in label_names])
            mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                        for k, v in params.items()})
            mod.init_optimizer(optimizer="sgd",
                               optimizer_params=dict(RCNN_OPT))
        return mod

    def feed(ctx, b):
        return mt.io.DataBatch(data=[mt.nd.array(a, ctx=ctx) for a in b[0]],
                               label=[mt.nd.array(a, ctx=ctx) for a in b[1]])

    def grads_of(mod):
        return {n: g[0].asnumpy() for n, g in
                zip(mod._param_names, mod._exec_group.grad_arrays)}

    gpu = mt.gpu(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mod = module(gpu)
    staged = [feed(gpu, b) for b in batches]
    losses, times, first = [], [], None
    for i, batch in enumerate(staged):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        if i == 0:
            first = grads_of(mod)
        mod.update()
        cls, box = [o.asnumpy() for o in mod.get_outputs()]
        times.append(time.perf_counter() - t0)
        lab = batches[i][1][0].astype(int)
        losses.append((float(-np.log(cls[np.arange(len(lab)), lab]
                                     + 1e-12).mean()),
                       float(box.sum() / c["images"])))
    peak = torch.cuda.max_memory_allocated()
    wall, device, rows = device_profile(
        torch, lambda: (mod.forward_backward(staged[0]), mod.update()),
        reps=2)
    n_params = sum(v.size for v in params.values())
    step_ms = 1e3 * float(np.median(times[1:]))
    print("zoo: rcnn Fast R-CNN (VGG-16 trunk to conv4_3, stride 8), %d "
          "parameters, %d images of 3x%dx%d, %d ROIs, %d classes: %d classic "
          "steps, median step %.1f ms (%.2f img/s); loss cls %.4f -> %.4f, "
          "bbox %.4f -> %.4f; peak memory %.2f GiB; profile %.3f ms wall, "
          "device %.3f ms, busy share %.3f"
          % (n_params, c["images"], c["height"], c["width"], c["rois"],
             c["classes"], RCNN_STEPS, step_ms, c["images"] * 1e3 / step_ms,
             losses[0][0], losses[-1][0], losses[0][1], losses[-1][1],
             peak / 2**30, wall, device, device / wall if wall else 0.0))
    groups = print_groups(rows, device, train_group, width=16)
    for t, key, n in rows[:8]:
        print("profile:   %8.3f ms  %5.1f%%  x%-3d %s"
              % (t, 100.0 * t / device if device else 0.0, n, key[:90]))
    del mod, staged
    torch.cuda.empty_cache()
    pool = roi_pool_check(torch, mt, batches[0][0][1], smi)
    t0 = time.perf_counter()
    cmod = module(mt.cpu())
    cmod.forward_backward(feed(mt.cpu(), batches[0]))
    want = grads_of(cmod)
    cpu_s = time.perf_counter() - t0
    del cmod
    l2 = {k: rel_l2_diff(first[k], want[k]) for k in want}
    worst = max(l2.items(), key=lambda kv: kv[1])
    print("zoo: rcnn first step's gradients, card vs cpu (%.1f s on the "
          "CPU): largest relative L2 difference %.3g (%s; gate %g), largest "
          "max|diff|/max|cpu| %.3g; by tensor: %s"
          % (cpu_s, worst[1], worst[0], RCNN_GRAD_REL,
             max(max_rel_diff(first[k], want[k]) for k in want),
             ", ".join("%s %.2g" % kv for kv in l2.items())))
    if worst[1] > RCNN_GRAD_REL:
        fail("Fast R-CNN gradients on the card differ from the CPU's")
    if not all(math.isfinite(v) for pair in losses for v in pair):
        fail("Fast R-CNN losses not finite: %s" % losses)
    return {"step_ms": step_ms, "peak_gib": peak / 2**30, "wall": wall,
            "device": device, "groups": groups, "grad_rel": worst[1],
            "roi_pool": pool, "params": n_params}


# AlexNet at 224 (batch 128) and Inception-v3 at 299 (batch 32), 1000
# classes, through Module's fused step (SGD lr 0.01, momentum 0.9): 3
# warm-up steps, 1 capture, 10 replays; the last replay against the same step run eagerly from the
# same state and generator state (Dropout draws the same masks); an eval
# forward of 4 images of the checkpoint against the CPU within rtol
# 1e-4, atol 1e-6 (probabilities of 1000 classes)
CAPTURED = [("alexnet", "get_alexnet", 224, 128),
            ("inception-v3", "get_inception_v3", 299, 32)]
CAPTURED_REPLAYS = 10
CAPTURED_OPT = {"learning_rate": 0.01, "momentum": 0.9}   # AlexNet's
EVAL_RTOL, EVAL_ATOL = 1e-4, 1e-6


def captured_net(torch, mt, smi, name, builder, image, batch, seed):
    gpu = mt.gpu(0)
    sym = getattr(mt.models, builder)(num_classes=1000)
    shapes = {"data": (batch, 3, image, image), "softmax_label": (batch,)}
    arg0 = {k: mt.nd.array(v, ctx=mt.cpu())
            for k, v in xavier_params(sym, shapes, seed).items()}
    _, _, aux_shapes = sym.infer_shape(**shapes)
    aux0 = {k: mt.nd.array((np.ones if k.endswith("_var") else np.zeros)(
        sh, np.float32), ctx=mt.cpu())
        for k, sh in zip(sym.list_auxiliary_states(), aux_shapes)}
    n_params = sum(v.size for v in arg0.values())
    rng = np.random.default_rng(seed + 1)
    host = [(rng.random((batch, 3, image, image), dtype=np.float32),
             rng.integers(0, 1000, batch).astype(np.float32))
            for _ in range(4)]
    staged = [mt.io.DataBatch(data=[mt.nd.array(x, ctx=gpu)],
                              label=[mt.nd.array(y, ctx=gpu)])
              for x, y in host]

    def one_step(mod, b):
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mod = mt.mod.Module(sym, context=gpu)
    mod.bind([("data", shapes["data"])], [("softmax_label", (batch,))])
    mod.init_params(arg_params=arg0, aux_params=aux0)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(CAPTURED_OPT))
    fused = mod._fused
    gen = mt.random.generator(gpu)
    steps = RESNET_WARMUP + CAPTURED_REPLAYS
    losses = []
    for i in range(steps):
        if i == steps - 1:
            snap, rng_state = clone_state(torch, fused.state), gen.get_state()
        one_step(mod, staged[i % 4])
        p = mod.get_outputs()[0].asnumpy()
        lab = host[i % 4][1].astype(int)
        losses.append(float(-np.log(p[np.arange(batch), lab] + 1e-12)
                            .mean()))
    stats = fused.stats.report()
    peak = torch.cuda.max_memory_allocated()
    got = state_params(fused.state)
    replayed = clone_state(torch, fused.state)
    restore_state(torch, fused.state, snap)
    after_state = gen.get_state()
    gen.set_state(rng_state)
    fused._body(fused.make_batch(staged[(steps - 1) % 4]))
    gen.set_state(after_state)
    eager = state_params(fused.state)
    restore_state(torch, fused.state, replayed)
    del snap, replayed
    replay_err = worst_rel(got, eager, REPLAY_ATOL)
    iters = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        one_step(mod, staged[0])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters
    wall, device, rows = device_profile(torch, lambda: one_step(
        mod, staged[0]), reps=3)
    print("zoo: %s %d parameters, batch %d at %dx%d, 1000 classes: %s; "
          "step %.3f ms = %.1f img/s; profile %.3f ms wall, device %.3f ms, "
          "busy share %.3f; loss %.4f -> %.4f; peak memory %.2f GiB; last "
          "replay vs the same step eager: smallest rtol at atol %g: %.3g "
          "(gate %g); card %s"
          % (name, n_params, batch, image, image, stats, step_s * 1e3,
             batch / step_s, wall, device, device / wall if wall else 0.0,
             losses[0], losses[-1], peak / 2**30, REPLAY_ATOL, replay_err,
             REPLAY_RTOL, smi))
    groups = print_groups(rows, device, train_group, width=16)
    del mod, fused, staged
    torch.cuda.empty_cache()
    # an eval forward of the checkpoint, card against CPU
    outs = []
    for ctx in (gpu, mt.cpu()):
        emod = mt.mod.Module(sym, context=ctx)
        emod.bind([("data", (4, 3, image, image))],
                  [("softmax_label", (4,))], for_training=False)
        emod.init_params(arg_params=arg0, aux_params=aux0)
        emod.forward(mt.io.DataBatch(data=[mt.nd.array(host[0][0][:4],
                                                       ctx=ctx)],
                                     label=None), is_train=False)
        outs.append(emod.get_outputs()[0].asnumpy())
        del emod
    eval_err = worst_rel([{"p": outs[0]}], [{"p": outs[1]}], EVAL_ATOL)
    print("zoo: %s eval forward of the checkpoint, 4 images, card vs cpu: "
          "smallest rtol at atol %g: %.3g (gate %g)"
          % (name, EVAL_ATOL, eval_err, EVAL_RTOL))
    if stats != {"captures": 1, "replays": CAPTURED_REPLAYS,
                 "eager_steps": RESNET_WARMUP}:
        fail("%s fused step counts %s" % (name, stats))
    if replay_err > REPLAY_RTOL:
        fail("%s replay differs from the eager step" % name)
    if eval_err > EVAL_RTOL:
        fail("%s eval forward on the card differs from the CPU's" % name)
    if not all(math.isfinite(v) for v in losses):
        fail("%s loss not finite: %s" % (name, losses))
    return {"img_s": batch / step_s, "wall": wall, "device": device,
            "groups": groups, "peak_gib": peak / 2**30, "stats": stats,
            "replay_rtol": replay_err, "eval_rtol": eval_err,
            "params": n_params}


def bilinear_kernel(channels, scale):
    """The FCN upsampling weight (C, 1, k, k), k = 2 scale - scale % 2: the
    bilinear filter of tests/test_operator.py's UpSampling case."""
    k = 2 * scale - scale % 2
    f = int(np.ceil(k / 2.0))
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    i = np.arange(k)
    w1 = 1 - np.abs(i / f - c)
    return np.tile((w1[:, None] * w1[None, :]).astype(np.float32),
                   (channels, 1, 1, 1))


FCN = dict(image=512, classes=21, steps=3)
FCN_OPT = {"learning_rate": 1e-4, "momentum": 0.9}


def fcn_phase(torch, mt, smi):
    """(e) FCN-32s at 1x3x512x512, 21 classes: 3 classic steps on the
    card, an eval forward against the CPU's."""
    c = FCN
    sym = mt.models.get_fcn32s(num_classes=c["classes"])
    shapes = {"data": (1, 3, c["image"], c["image"]),
              "softmax_label": (1, c["image"], c["image"])}
    params = xavier_params(sym, shapes, 70)
    params["upsample32_weight"] = bilinear_kernel(c["classes"], 32)
    arg = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}
    rng = np.random.default_rng(71)
    x = rng.standard_normal(shapes["data"], dtype=np.float32)
    y = rng.integers(0, c["classes"], shapes["softmax_label"]) \
        .astype(np.float32)
    y[:, :32] = 255.0              # ignored pixels, as VOC's borders
    gpu = mt.gpu(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with fused_train_env(False):
        mod = mt.mod.Module(sym, context=gpu)
        mod.bind([("data", shapes["data"])],
                 [("softmax_label", shapes["softmax_label"])])
        mod.init_params(arg_params=arg)
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(FCN_OPT))
    batch = mt.io.DataBatch(data=[mt.nd.array(x, ctx=gpu)],
                            label=[mt.nd.array(y, ctx=gpu)])
    losses, times = [], []
    keep = y[0] != 255
    for _ in range(c["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        p = mod.get_outputs()[0].asnumpy()[0]
        times.append(time.perf_counter() - t0)
        lab = y[0].astype(int)
        pix = np.take_along_axis(p, np.where(keep, lab, 0)[None], 0)[0]
        losses.append(float(-np.log(pix[keep] + 1e-12).mean()))
    peak = torch.cuda.max_memory_allocated()
    wall, device, rows = device_profile(
        torch, lambda: (mod.forward_backward(batch), mod.update()), reps=2)
    n_params = sum(v.size for v in params.values())
    print("zoo: fcn32s %d parameters, 1x3x%dx%d, %d classes (255 ignored): "
          "%d classic steps, step %.1f ms; loss %.4f -> %.4f; peak memory "
          "%.2f GiB; profile %.3f ms wall, device %.3f ms, busy share %.3f"
          % (n_params, c["image"], c["image"], c["classes"], c["steps"],
             1e3 * float(np.median(times[1:])), losses[0], losses[-1],
             peak / 2**30, wall, device, device / wall if wall else 0.0))
    groups = print_groups(rows, device, train_group, width=16)
    del mod, batch
    torch.cuda.empty_cache()
    outs = []
    for ctx in (gpu, mt.cpu()):
        emod = mt.mod.Module(sym, context=ctx)
        emod.bind([("data", shapes["data"])],
                  [("softmax_label", shapes["softmax_label"])],
                  for_training=False)
        emod.init_params(arg_params=arg)
        emod.forward(mt.io.DataBatch(data=[mt.nd.array(x, ctx=ctx)],
                                     label=None), is_train=False)
        outs.append(emod.get_outputs()[0].asnumpy())
        del emod
    eval_err = worst_rel([{"p": outs[0]}], [{"p": outs[1]}], EVAL_ATOL)
    print("zoo: fcn32s eval forward, card vs cpu: smallest rtol at atol %g: "
          "%.3g (gate %g)" % (EVAL_ATOL, eval_err, EVAL_RTOL))
    if eval_err > EVAL_RTOL:
        fail("FCN-32s eval forward on the card differs from the CPU's")
    if not all(math.isfinite(v) for v in losses):
        fail("FCN-32s loss not finite: %s" % losses)
    return {"step_ms": 1e3 * float(np.median(times[1:])),
            "peak_gib": peak / 2**30, "wall": wall, "device": device,
            "groups": groups, "eval_rtol": eval_err, "params": n_params}


def op_on(mt, ctx, build, values, head, aux=None):
    """One op's train forward and backward through Executor on ``ctx``;
    -> (outputs, grads, aux) as numpy."""
    sym = build(mt.sym)
    exe = sym.simple_bind(ctx, grad_req="write",
                          **{n: v.shape for n, v in values.items()})
    for n, v in values.items():
        exe.arg_dict[n][:] = v
    for n, v in (aux or {}).items():
        exe.aux_dict[n][:] = v
    outs = [o.asnumpy() for o in exe.forward(is_train=True)]
    exe.backward([mt.nd.array(head, ctx=ctx)])
    return outs, {n: g.asnumpy() for n, g in exe.grad_dict.items()}, \
        {n: a.asnumpy() for n, a in exe.aux_dict.items()}


def image_op_checks(mt):
    """SpatialTransformer, L2Normalization and IdentityAttachKLSparseReg
    on the card against the CPU: outputs, every gradient and aux within
    1e-5 of each tensor's largest value."""
    rng = np.random.default_rng(80)

    def op(name, inputs, **kw):
        return lambda s: getattr(s, name)(*[s.Variable(n) for n in inputs],
                                          name="op", **kw)
    loc = np.tile(np.array([0.9, 0.1, 0.05, -0.1, 0.8, 0.02], np.float32),
                  (8, 1)) + rng.normal(0, 0.05, (8, 6)).astype(np.float32)
    cases = [
        ("SpatialTransformer", op("SpatialTransformer", ("data", "loc"),
                                  target_shape=(32, 48)),
         {"data": rng.standard_normal((8, 16, 40, 56), dtype=np.float32),
          "loc": loc}, (8, 16, 32, 48), None),
        ("L2Normalization", op("L2Normalization", ("data",)),
         {"data": rng.standard_normal((64, 256, 7, 7), dtype=np.float32)},
         (64, 256, 7, 7), None),
        ("IdentityAttachKLSparseReg",
         op("IdentityAttachKLSparseReg", ("data",), sparseness_target=0.1,
            penalty=0.01),
         {"data": rng.random((128, 1024), dtype=np.float32)}, (128, 1024),
         {"op_moving_avg": np.array([0.3], np.float32)}),
    ]
    worst = {}
    for name, build, values, out_shape, aux in cases:
        head = rng.standard_normal(out_shape, dtype=np.float32)
        got = op_on(mt, mt.gpu(0), build, values, head, aux)
        want = op_on(mt, mt.cpu(), build, values, head, aux)
        errs = [max_rel_diff(g, w) for g, w in zip(got[0], want[0])]
        errs += [max_rel_diff(got[1][k], want[1][k]) for k in want[1]]
        errs += [max_rel_diff(got[2][k], want[2][k]) for k in want[2]]
        worst[name] = max(errs)
        print("zoo: op %s on the card vs cpu: outputs, gradients (%s) and "
              "aux: worst max|diff|/max|cpu| %.3g (gate 1e-5)"
              % (name, ", ".join(sorted(want[1])), worst[name]))
        if worst[name] > 1e-5:
            fail("%s on the card differs from the CPU" % name)
    return worst


def monitor_check(torch, mt, smi):
    """A Monitor on a LeNet Module on the card: its stat names equal the
    CPU run's, the values within 1e-3, and no fused step (0 captures)
    while it is installed."""
    b = 64
    sym = mt.models.get_lenet()
    shapes = {"data": (b, 1, 28, 28), "softmax_label": (b,)}
    arg = {k: mt.nd.array(v, ctx=mt.cpu())
           for k, v in xavier_params(sym, shapes, 90).items()}
    rng = np.random.default_rng(91)
    x = rng.random((2 * b, 1, 28, 28), dtype=np.float32)
    y = rng.integers(0, 10, 2 * b).astype(np.float32)
    rows = {}
    for where, ctx in (("card", mt.gpu(0)), ("cpu", mt.cpu())):
        mod = mt.mod.Module(sym, context=ctx)
        mod.bind([("data", shapes["data"])], [("softmax_label", (b,))])
        mod.init_params(arg_params=arg)
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(TRAIN_OPT))
        mon = mt.Monitor(1)
        mod.install_monitor(mon)
        res = []
        for i in range(2):
            mon.tic()
            mod.forward_backward(mt.io.DataBatch(
                data=[mt.nd.array(x[i * b:(i + 1) * b], ctx=ctx)],
                label=[mt.nd.array(y[i * b:(i + 1) * b], ctx=ctx)]))
            mod.update()
            res.extend(mon.toc())
        rows[where] = (res, mod._fused)
    card, fused = rows["card"]
    cpu, _ = rows["cpu"]
    names_equal = [(n, k) for n, k, _ in card] == [(n, k) for n, k, _ in cpu]
    err = max(abs(float(a) - float(b_)) / max(abs(float(b_)), 1e-12)
              for (_, _, a), (_, _, b_) in zip(card, cpu))
    print("zoo: monitor on LeNet (card %s): %d stats over 2 batches, names "
          "and order equal the CPU run's: %s (%s ... %s); values within "
          "%.3g relative (gate 1e-3); fused step while installed: %s "
          "(captures 0)" % (smi, len(card), names_equal, card[0][1],
                            card[-1][1], err, fused))
    if not names_equal or err > 1e-3 or fused is not None:
        fail("monitor on the card differs from the CPU run")
    return {"stats": len(card), "rel": err}


def zoo_phase(torch, mt, ck, smi):
    print("zoo: TF32 allow_tf32 matmul=%s cudnn=%s (float32 products "
          "throughout); card %s" % (torch.backends.cuda.matmul.allow_tf32,
                                    torch.backends.cudnn.allow_tf32, smi))
    ck.reset_launches()
    t0 = time.perf_counter()
    out = {"dcgan": dcgan_phase(torch, mt, smi),
           "rcnn": rcnn_phase(torch, mt, smi)}
    for i, (name, builder, image, batch) in enumerate(CAPTURED):
        out[name] = captured_net(torch, mt, smi, name, builder, image, batch,
                                 100 + 10 * i)
    out["fcn32s"] = fcn_phase(torch, mt, smi)
    out["ops"] = image_op_checks(mt)
    out["monitor"] = monitor_check(torch, mt, smi)
    launches = dict(ck.LAUNCHES)
    print("zoo: hand-kernel launches on the zoo paths: %s; phase %.1f s"
          % (launches, time.perf_counter() - t0))
    if any(launches.values()):
        fail("the zoo paths launched hand kernels: %s" % launches)
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 17: serving operations: the dense DecodeEngine at the PTB LSTM's
# width, a ServeRouter over two paged LM replicas, a ModelMultiplexer of
# three models on one card

DEC_SLOTS, DEC_STREAMS, DEC_MAX_NEW, DEC_THREADS = 16, 32, 64, 4
DEC_PROMPT_MAX = 32
DEC_STATES = ("l0_c", "l0_h", "l1_c", "l1_h")
# an evicted engine's bytes must leave torch.cuda.memory_allocated():
# its device_bytes() less 1 MiB for the allocator's 512-byte rounding of
# the blocks it counts and any block the factory allocates first
MUX_MEM_TOL = 1 << 20


def lstm_step_symbol(mt):
    """One decode step of bench_lstm.py's model from models/lstm.py's
    ``lstm_cell``: token ids -> the 200-wide embedding -> 2 LSTM layers
    of 200 -> logits over the 10,000 words; outputs the logits and the
    next value of each layer's c and h.  Argument names are
    ``lstm_unroll``'s, so its checkpoint serves this step."""
    from mxnet_tpu_torch.models.lstm import LSTMParam, LSTMState, lstm_cell
    sym = mt.sym
    x = sym.Embedding(data=sym.Variable("data"), input_dim=LSTM_VOCAB,
                      weight=sym.Variable("embed_weight"),
                      output_dim=LSTM_HIDDEN, name="embed")
    nexts = []
    for i in range(LSTM_LAYERS):
        param = LSTMParam(*[sym.Variable("l%d_%s" % (i, n)) for n in (
            "i2h_weight", "i2h_bias", "h2h_weight", "h2h_bias")])
        state = LSTMState(c=sym.Variable("l%d_c" % i),
                          h=sym.Variable("l%d_h" % i))
        nxt = lstm_cell(LSTM_HIDDEN, x, state, param, 0, i)
        nexts += [nxt.c, nxt.h]
        x = nxt.h
    logits = sym.FullyConnected(data=x, num_hidden=LSTM_VOCAB,
                                weight=sym.Variable("cls_weight"),
                                bias=sym.Variable("cls_bias"), name="pred")
    return sym.Group([logits] + nexts)


def lstm_decode_engine(mt, sym, params, **kw):
    return mt.serve.DecodeEngine(
        sym, params, state_shapes={n: (LSTM_HIDDEN,) for n in DEC_STATES},
        state_outputs={n: i + 1 for i, n in enumerate(DEC_STATES)},
        num_slots=DEC_SLOTS, max_new_tokens=DEC_MAX_NEW, **kw)


def flood(submit, n, n_threads, wave=None, started=None, timeout=900):
    """``n`` requests from ``n_threads`` client threads, ``submit(i)`` ->
    Future.  Each thread submits its share ``wave`` at a time (all at
    once by default) and waits for them; ``started`` is set once every
    thread has requests in flight.  -> (answers, wall, errors)."""
    answers = [None] * n
    errors = []
    in_flight = threading.Barrier(n_threads + 1) if started else None

    def client(idx):
        try:
            mine = list(range(idx, n, n_threads))
            step = wave or len(mine)
            for k in range(0, len(mine), step):
                futs = [(i, submit(i)) for i in mine[k:k + step]]
                if k == 0 and in_flight is not None:
                    in_flight.wait(timeout)
                for i, f in futs:
                    answers[i] = f.result(timeout=timeout)
        except Exception as e:              # reported below, fails the run
            errors.append(repr(e))
            if in_flight is not None:
                in_flight.abort()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    if in_flight is not None:
        try:
            in_flight.wait(timeout)
        except threading.BrokenBarrierError:
            pass
        started()
    for t in threads:
        t.join(timeout=timeout)
    if any(t.is_alive() for t in threads):
        errors.append("a client thread outlived %d s" % timeout)
    return answers, time.perf_counter() - t0, errors


def first_difference(a, b):
    """Index of the first token where streams a and b differ, or None."""
    a, b = np.asarray(a), np.asarray(b)
    n = min(len(a), len(b))
    diff = np.nonzero(a[:n] != b[:n])[0]
    if len(diff):
        return int(diff[0])
    return None if len(a) == len(b) else n


def lstm_margin(mt, sym, params, prompt, stream, j):
    """Replay prompt + stream[:j] teacher-forced through the step on the
    CPU (one slot, states carried) and return the top-2 margin of the
    logits that choose token j, with phase 7's logits tolerance there."""
    states = {n: (1, LSTM_HIDDEN) for n in DEC_STATES}
    pred = mt.Predictor(sym.tojson(), params, dict(data=(1,), **states),
                        dev_type="cpu", type_dict={"data": np.int32})
    seq = list(prompt) + [int(t) for t in stream[:j]]
    for tok in seq:
        pred.set_input("data", np.asarray([tok], np.int32))
        pred.forward()
        for k, n in enumerate(DEC_STATES):
            pred.set_input(n, pred.get_output(k + 1))
    logits = np.sort(pred.get_output(0)[0])
    return (float(logits[-1] - logits[-2]),
            LOGIT_TOL_REL * max(1.0, float(np.abs(logits).max())))


def same_under_margin(label, got, want, margin_of):
    """Streams equal, or first apart where the reference's top-2 margin
    is within the logits tolerance (phase 7's rule).  -> True for a tie
    flip, False when equal; fails the run otherwise."""
    if got is None or got.dtype != np.int32:
        fail("%s: malformed stream %r" % (label, got))
    j = first_difference(got, want)
    if j is None:
        return False
    if j >= min(len(got), len(want)):
        fail("%s: stream lengths %d and %d" % (label, len(got), len(want)))
    margin, tol = margin_of(j)
    print("serving ops: %s differs at token %d (got %d, want %d); top-2 "
          "margin there %.3g, tol %.3g" % (label, j, got[j], want[j],
                                           margin, tol))
    if not margin < tol:
        fail("%s differs at token %d where the top-2 margin %.3g exceeds "
             "tol %.3g" % (label, j, margin, tol))
    return True


def cuda_device_ms(torch, fn):
    """Device time of the CUDA kernels fn() launches, from any thread,
    summed by torch.profiler; -> (fn's result, device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return out, total / 1e3


def decode_ops_phase(torch, mt, smi):
    """(a) DecodeEngine at the PTB LSTM's width, 32 streams from 4
    threads, held against the port's CPU DecodeEngine on the same
    checkpoint; a hot reload mid-flood."""
    sym = lstm_step_symbol(mt)
    versions = [lstm_params(mt, LSTM_HIDDEN, seed) for seed in (20, 21)]
    n_params = sum(v.size for v in versions[0].values())
    if n_params != 4653200:
        fail("LSTM decode step has %d parameters, want 4653200" % n_params)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, LSTM_VOCAB, size=int(rng.integers(
        1, DEC_PROMPT_MAX + 1))) for _ in range(DEC_STREAMS)]
    print("decode: PTB LSTM step (2x200, embed 200, vocab 10000, %d "
          "parameters), %d slots, %d streams of %d..%d prompt tokens and "
          "%d new tokens from %d threads" % (
              n_params, DEC_SLOTS, DEC_STREAMS, min(map(len, prompts)),
              max(map(len, prompts)), DEC_MAX_NEW, DEC_THREADS))
    cpu = []
    for v, params in enumerate(versions):
        eng = lstm_decode_engine(mt, sym, params, dev_type="cpu",
                                 name="lstm-cpu-v%d" % v)
        try:
            got, _, errors = flood(lambda i: eng.submit(prompts[i]),
                                   DEC_STREAMS, DEC_THREADS)
        finally:
            eng.close()
        if errors:
            fail("CPU decode errors: %s" % errors)
        cpu.append(got)
    margin = {v: (lambda i, s, v=v: (lambda j: lstm_margin(
        mt, sym, versions[v], prompts[i], s, j))) for v in (0, 1)}

    t0 = time.perf_counter()
    eng = lstm_decode_engine(mt, sym, versions[0], name="lstm-decode")
    built = time.perf_counter() - t0
    try:
        if eng.device.type != "cuda":
            fail("DecodeEngine built without a context runs on %s"
                 % eng.device)
        steps0 = eng.stats.report()["steps"]
        streams, wall, errors = flood(lambda i: eng.submit(prompts[i]),
                                      DEC_STREAMS, DEC_THREADS)
        if errors:
            fail("decode client errors: %s" % errors)
        steps = eng.stats.report()["steps"] - steps0
        ties = sum(same_under_margin("decode stream %d" % i, s, cpu[0][i],
                                     margin[0](i, s))
                   for i, s in enumerate(streams))
        tokens = sum(len(s) for s in streams)
        print("decode: built+warmed %.2f s; %d streams, %d tokens in %.3f s "
              "= %.1f tokens/s; %d steps, %.3f ms a step (wall); all "
              "streams equal the CPU engine's (%d after a logit tie)"
              % (built, DEC_STREAMS, tokens, wall, tokens / wall, steps,
                 1e3 * wall / steps, ties))
        # device time of a step: the kernels of a second flood, summed
        steps0 = eng.stats.report()["steps"]
        (_, pwall, _), device = cuda_device_ms(torch, lambda: flood(
            lambda i: eng.submit(prompts[i]), DEC_STREAMS, DEC_THREADS))
        psteps = eng.stats.report()["steps"] - steps0
        step_wall = 1e3 * wall / steps
        step_device = device / psteps if device > 0 else None
        if step_device is None:
            print("decode: a step %.3f ms of wall; device time not "
                  "measured (the profiler saw no kernels of the decode "
                  "thread); card %s" % (step_wall, smi))
        else:
            print("decode: a step %.3f ms of wall, %.3f ms of device time, "
                  "busy share %.3f (card %s)" % (
                      step_wall, step_device, step_device / step_wall, smi))
        # the hot reload mid-flood: each stream one version's, end to end
        reloads = []
        got2, wall2, errors = flood(
            lambda i: eng.submit(prompts[i]), DEC_STREAMS, DEC_THREADS,
            wave=2, started=lambda: reloads.append(
                eng.reload(versions[1], timeout=600)))
        if errors or reloads != [1]:
            fail("decode reload flood: errors %s, versions %s"
                 % (errors, reloads))
        counts = [0, 0]
        for i, s in enumerate(got2):
            v = 0 if first_difference(s, cpu[0][i]) is None else \
                1 if first_difference(s, cpu[1][i]) is None else None
            if v is None:       # a tie flip under one of the versions
                j0 = first_difference(s, cpu[0][i])
                j1 = first_difference(s, cpu[1][i])
                v = 0 if j0 > j1 else 1
                same_under_margin("reload stream %d (v%d)" % (i, v), s,
                                  cpu[v][i], margin[v](i, s))
            counts[v] += 1
        print("decode: hot reload mid-flood: %d streams under the old "
              "weights, %d under the new, none mixed; %.3f s"
              % (counts[0], counts[1], wall2))
        dev_bytes = eng.device_bytes()
    finally:
        eng.close()
    return {"sym": sym, "params": versions[0], "prompts": prompts,
            "streams": streams, "tokens_s": tokens / wall,
            "step_wall_ms": step_wall, "step_device_ms": step_device,
            "device_bytes": dev_bytes}


def paged_replica(mt, params, cfg, name):
    """Phase 7's paged engine configuration."""
    return mt.serve.PagedDecodeEngine(
        params, cfg, num_slots=LM_SLOTS, block_tokens=LM_BLOCK_TOKENS,
        num_blocks=LM_POOL_BLOCKS, chunk_tokens=LM_CHUNK,
        max_new_tokens=LM_MAX_NEW, name=name)


def router_ops_phase(torch, mt, ck, llm, smi):
    """(b) ServeRouter over 2 PagedDecodeEngine replicas at phase 7's
    geometry and checkpoint: phase 7's 32 prompts from 4 threads, then a
    second flood with rolling_restart() in the middle."""
    from mxnet_tpu_torch.convert import convert_lm_params
    cfg, params, prompts, want = (llm["cfg"], llm["params"],
                                  llm["prompts"], llm["streams"])
    dev = torch.device("cuda", 0)
    pdev = convert_lm_params(params, dev)
    counts = []                     # every replica's forward counts

    def factory(i):
        eng = paged_replica(mt, params, cfg, "router-rep%d" % i)
        counts.append(eng.forward_counts)
        return eng

    def check(label, streams):
        ties = sum(same_under_margin(
            "%s stream %d" % (label, i), s, want[i],
            lambda j, i=i, s=s: top2_margin(torch, pdev, cfg, prompts[i],
                                            want[i], j, dev))
            for i, s in enumerate(streams))
        return ties

    def around(run):
        before = [c["target"] for c in counts]
        ck.reset_launches()
        out = run()
        launches = ck.LAUNCHES["paged_attention"]
        steps = sum(c["target"] for c in counts) - sum(before)
        if launches < 1 or launches != cfg.layers * steps:
            fail("router: paged_attention launched %d times for %d target "
                 "forwards of %d layers" % (launches, steps, cfg.layers))
        return out, launches, steps

    t0 = time.perf_counter()
    router = mt.serve.ServeRouter(factory, replicas=2, name="llm-router")
    try:
        print("router: 2 paged replicas (phase 7's engine and checkpoint) "
              "built in %.2f s, %d device bytes each"
              % (time.perf_counter() - t0, router.replica(0).device_bytes()))
        lm_bytes = router.replica(0).device_bytes()
        submit = lambda i: router.submit(prompts[i],       # noqa: E731
                                         max_new_tokens=LM_MAX_NEW)
        (streams, wall, errors), l1, s1 = around(
            lambda: flood(submit, LM_STREAMS, LM_THREADS))
        if errors:
            fail("router client errors: %s" % errors)
        ties = check("router", streams)
        tokens = sum(len(s) for s in streams)
        per = [row["dispatched"] for row in
               router.stats.report()["per_replica"].values()]
        print("router: %d streams, %d tokens in %.3f s = %.1f tokens/s "
              "(phase 7's single engine %.1f tokens/s); dispatched %s; "
              "paged_attention launches %d = %d layers x %d target "
              "forwards; streams equal phase 7's (%d after a logit tie); "
              "card %s" % (LM_STREAMS, tokens, wall, tokens / wall,
                           llm["tokens_s"], per, l1, cfg.layers, s1, ties,
                           smi))
        restarted = []
        (streams2, wall2, errors), l2, s2 = around(lambda: flood(
            submit, LM_STREAMS, LM_THREADS, wave=2,
            started=lambda: restarted.append(router.rolling_restart(
                timeout=600))))
        rep = router.stats.report()
        rows = rep["per_replica"].values()
        dropped = sum(r["engine"]["dropped_streams"] for r in rows)
        if errors or restarted != [None] or rep["failed"] or dropped \
                or any(s is None for s in streams2) \
                or [r["restarts"] for r in rows] != [1, 1]:
            fail("router rolling restart: errors %s, failed %d, dropped "
                 "%d, restarts %s" % (errors, rep["failed"], dropped,
                                      [r["restarts"] for r in rows]))
        ties2 = check("router restart", streams2)
        print("router: rolling_restart mid-flood: %d streams in %.3f s, 0 "
              "dropped, 0 errors, restarts %s, %d retried; paged_attention "
              "launches %d = %d layers x %d target forwards (warm-ups of "
              "the rebuilt replicas included); streams equal phase 7's (%d "
              "after a logit tie)" % (LM_STREAMS, wall2,
                                      [r["restarts"] for r in rows],
                                      rep["retried"], l2, cfg.layers, s2,
                                      ties2))
    finally:
        router.close()
    del router, counts
    torch.cuda.empty_cache()
    return {"launches": l1 + l2, "tokens_s": tokens / wall,
            "lm_bytes": lm_bytes, "pdev": pdev}


def mux_ops_phase(torch, mt, ck, served, dec, llm, router, prefix, smi):
    """(c) ModelMultiplexer of VGG-16 (phase 4's fused ServeEngine), the
    LSTM DecodeEngine of (a) and the GPT-2-small PagedDecodeEngine of
    (b) on one card, under a byte budget that cannot hold VGG-16 and the
    LM together."""
    cfg, prompts, lm_want = llm["cfg"], llm["prompts"], llm["streams"]
    dev = torch.device("cuda", 0)
    vgg_shapes = {"data": (1, 3, 224, 224), "softmax_label": (1,)}
    probe = mt.serve.ServeEngine.from_checkpoint(
        prefix, 0, vgg_shapes, fuse=True, warmup=False, name="vgg-probe")
    vgg_bytes = probe.device_bytes()
    probe.close()
    del probe
    gc.collect()
    torch.cuda.empty_cache()
    sizes = {"vgg16": vgg_bytes, "lstm": dec["device_bytes"],
             "lm": router["lm_bytes"]}
    budget = max(sizes["vgg16"], sizes["lm"]) + sizes["lstm"]
    if budget >= sizes["vgg16"] + sizes["lm"]:
        fail("mux budget %d would hold VGG-16 and the LM together" % budget)
    swaps = []                              # (model, build wall s, mem)
    live_bytes = {}                         # model -> its engine's bytes
    lm_counts = []                          # the LM engines' forward counts

    def timed(name, make):
        def factory():
            # the multiplexer has closed this swap-in's victims already
            mem = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            eng = make()
            swaps.append((name, time.perf_counter() - t0, mem))
            live_bytes[name] = eng.device_bytes()
            if name == "lm":
                lm_counts.append(eng.forward_counts)
            return eng
        return factory

    # the hints are the measured sizes, so a swap-in evicts before it
    # builds and the live set never holds VGG-16 and the LM together
    mux = mt.serve.ModelMultiplexer(budget_bytes=budget, name="card-mux")
    mux.add_model("vgg16", timed("vgg16", lambda: (
        mt.serve.ServeEngine.from_checkpoint(prefix, 0, vgg_shapes,
                                             fuse=True, name="mux-vgg16"))),
        bytes_hint=sizes["vgg16"])
    mux.add_model("lstm", timed("lstm", lambda: lstm_decode_engine(
        mt, dec["sym"], dec["params"], name="mux-lstm")),
        bytes_hint=sizes["lstm"])
    mux.add_model("lm", timed("lm", lambda: paged_replica(
        mt, llm["params"], cfg, "mux-lm")), bytes_hint=sizes["lm"])
    vgg_warm_launches = 2 * len(mt.serve.default_buckets(8))
    items = [wire_to_nchw(u) for u in served["wire"]]
    lstm_margin_of = {}
    checks = {"vgg16": 0, "lstm": 0, "lm": 0}
    launches = {"fused_fc_epilogue": 0, "paged_attention": 0}

    def wave(model, idx):
        kw = {} if model == "vgg16" else {"max_new_tokens": DEC_MAX_NEW
                                          if model == "lstm" else LM_MAX_NEW}
        src = {"vgg16": items, "lstm": dec["prompts"], "lm": prompts}[model]
        live0 = set(mux.live_models())
        bytes0 = {m: live_bytes[m] for m in live0}
        mem0 = torch.cuda.memory_allocated()
        n_swaps = len(swaps)
        steps0 = sum(c["target"] for c in lm_counts)
        batches0 = sum(r["batches"] for k, r in mt.profiler.serve_report()
                       .items() if k.startswith("mux-vgg16#"))
        ck.reset_launches()
        got, wall, errors = flood(lambda i: mux.submit(model, src[idx[i]],
                                                       **kw),
                                  len(idx), 4)
        got_launches = dict(ck.LAUNCHES)
        if errors:
            fail("mux %s wave errors: %s" % (model, errors))
        evicted = sorted(live0 - set(mux.live_models()))
        if evicted:
            if len(swaps) != n_swaps + 1:
                fail("mux: %s evicted without a swap-in" % evicted)
            freed = mem0 - swaps[-1][2]
            need = sum(bytes0[m] for m in evicted)
            print("mux: swap-in of %s evicted %s: memory_allocated fell by "
                  "%d bytes before the build, their device_bytes() %d (tol "
                  "%d)" % (model, evicted, freed, need, MUX_MEM_TOL))
            if freed < need - MUX_MEM_TOL:
                fail("mux: evicting %s freed %d bytes, want >= %d"
                     % (evicted, freed, need - MUX_MEM_TOL))
        for k in launches:
            launches[k] += got_launches[k]
        swapped = len(swaps) - n_swaps
        if model == "vgg16":
            batches = sum(r["batches"] for k, r in mt.profiler.serve_report()
                          .items() if k.startswith("mux-vgg16#")) - batches0
            # 2 a batch, and a swap-in's warm-up runs every bucket once
            want = 2 * batches + vgg_warm_launches * swapped
            if got_launches["fused_fc_epilogue"] != want:
                fail("mux vgg16: fused_fc_epilogue launched %d times for %d "
                     "batches and %d swap-ins, want %d" % (
                         got_launches["fused_fc_epilogue"], batches,
                         swapped, want))
            for i, a in zip(idx, got):
                r = served["answers"][i]
                if not np.allclose(a, r, rtol=1e-3, atol=1e-6):
                    fail("mux vgg16 answer %d differs from phase 4's: max "
                         "abs err %.3g" % (i, np.abs(a - r).max()))
        elif model == "lstm":
            for i, s in zip(idx, got):
                same_under_margin("mux lstm stream %d" % i, s,
                                  dec["streams"][i], lambda j, i=i, s=s:
                                  lstm_margin(mt, dec["sym"], dec["params"],
                                              dec["prompts"][i], s, j))
        else:
            steps = sum(c["target"] for c in lm_counts) - steps0
            paged = got_launches["paged_attention"]
            if paged < 1 or paged != cfg.layers * steps:
                fail("mux lm: paged_attention launched %d times for %d "
                     "target forwards" % (paged, steps))
            for i, s in zip(idx, got):
                same_under_margin("mux lm stream %d" % i, s, lm_want[i],
                                  lambda j, i=i: top2_margin(
                                      torch, router["pdev"], cfg, prompts[i],
                                      lm_want[i], j, dev))
        checks[model] += len(idx)
        print("mux: %-6s %2d requests in %.3f s; live %s; launches %s"
              % (model, len(idx), wall, sorted(mux.live_models()),
                 {k: v for k, v in got_launches.items() if v}))

    plan = [("vgg16", range(0, 8)), ("lstm", range(0, 8)),
            ("lm", range(0, 8)), ("lstm", range(8, 16)),
            ("vgg16", range(8, 16)), ("lm", range(8, 16)),
            ("vgg16", range(16, 24))]
    try:
        print("mux: device_bytes vgg16 %d, lstm %d, lm %d; budget %d "
              "(VGG-16 and the LM cannot both be live)" % (
                  sizes["vgg16"], sizes["lstm"], sizes["lm"], budget))
        for model, idx in plan:
            wave(model, list(idx))
        for model in list(mux.live_models()):
            mem0 = torch.cuda.memory_allocated()
            nbytes = live_bytes[model]
            if not mux.evict(model):
                fail("mux: could not evict idle %s" % model)
            freed = mem0 - torch.cuda.memory_allocated()
            print("mux: evict(%s): memory_allocated fell by %d bytes, its "
                  "device_bytes() %d" % (model, freed, nbytes))
            if freed < nbytes - MUX_MEM_TOL:
                fail("mux: evict(%s) freed %d bytes, want >= %d"
                     % (model, freed, nbytes - MUX_MEM_TOL))
        rep = mux.stats.report()
    finally:
        mux.close()
    print("mux: %d swap-ins, %d evictions, %d rejected; swap-in wall %s; "
          "answers checked %s; card %s" % (
              rep["swap_ins"], rep["evictions"], rep["rejected"],
              ["%s %.2f s" % (m, w) for m, w, _ in swaps], checks, smi))
    if rep["evictions"] < 2 or rep["swap_ins"] != len(swaps):
        fail("mux: %d swap-ins, %d evictions" % (rep["swap_ins"],
                                                 rep["evictions"]))
    return {"launches": launches, "swap_ins": rep["swap_ins"],
            "evictions": rep["evictions"]}


def serving_ops_phase(torch, mt, ck, served, llm, prefix, smi):
    t0 = time.perf_counter()
    dec = decode_ops_phase(torch, mt, smi)
    router = router_ops_phase(torch, mt, ck, llm, smi)
    mux = mux_ops_phase(torch, mt, ck, served, dec, llm, router, prefix,
                        smi)
    print("serving ops result (card %s): %s; phase %.1f s" % (smi, json.dumps({
        "decode-lstm-tokens_s": round(dec["tokens_s"], 1),
        "decode-step_wall_ms": round(dec["step_wall_ms"], 3),
        "decode-step_device_ms": None if dec["step_device_ms"] is None
        else round(dec["step_device_ms"], 3),
        "router-tokens_s": round(router["tokens_s"], 1),
        "single-engine-tokens_s": round(llm["tokens_s"], 1),
        "mux-swap_ins": mux["swap_ins"],
        "mux-evictions": mux["evictions"]}), time.perf_counter() - t0))
    return {"paged_launches": router["launches"]
            + mux["launches"]["paged_attention"],
            "fc_launches": mux["launches"]["fused_fc_epilogue"]}


# ---------------------------------------------------------------------------
# phase 18: the rest of training on the card
#
# (a) the superstep at bench_lstm.py:118's leg (PTB LSTM 2x200, vocab
# 10,000, batch 32, 32 steps, SGD with momentum, cross-entropy); (b)
# FeedForward.fit against Module.fit at ResNet-50, batch 128; (c) two
# contexts on the one card ([gpu(0), gpu(0)]) against a plain write-out
# of v0.7's data parallelism; (d) checkpoint and resume; (e) serving
# from the checkpoint directory; (f) group2ctx.
SUPER_K, SUPER_BATCH, SUPER_BATCHES = 8, 32, 16
FF_BATCHES = 4
FF_OPT = {"learning_rate": 0.05, "momentum": 0.9}
MULTI_REL_L2 = 1e-5            # (c): relative L2 to the write-out
CKPT_EVERY, CKPT_BATCHES, CKPT_RESUME_AT = 2, 6, 4
SERVE_FLOOD, SERVE_THREADS = 48, 4


def batch_iter(mt, batches, provide_data, provide_label):
    """A DataIter over a fixed list of DataBatch."""
    class BatchList(mt.io.DataIter):
        def __init__(self):
            super().__init__()
            self.batch_size = provide_data[0][1][0]
            self.provide_data = provide_data
            self.provide_label = provide_label
            self.pos = 0

        def reset(self):
            self.pos = 0

        def next(self):
            if self.pos >= len(batches):
                raise StopIteration
            self.pos += 1
            return batches[self.pos - 1]
    return BatchList()


def time_major_ce(mt):
    """Cross-entropy over the LSTM's time-major rows (the graph transposes
    its (batch, seq) labels; so does this metric), host and device
    forms."""
    class TimeMajorCE(mt.metric.CrossEntropy):
        def _score(self, label, pred):
            return super()._score(label.T, pred)

        def _device_score(self, label, pred):
            return super()._device_score(label.t(), pred)
    return TimeMajorCE()


def opt_leaves(torch, state):
    out = {}
    for n, v in state["opt"].items():
        for i, t in enumerate(v if isinstance(v, (tuple, list)) else [v]):
            if t is not None:
                out["%s/%d" % (n, i)] = t.detach().cpu().numpy()
    return out


def bitwise(a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)


def superstep_leg(torch, mt, smi):
    """(a) fit(superstep=8) against K=1 over 2 epochs of 16 seeded
    batches: params, momentum and the metric bitwise; tokens/s of the
    second epoch, metric drains per step, captures and replays, busy
    share of one superstep and of one K=1 step."""
    arg0 = lstm_params(mt, LSTM_HIDDEN, 30)
    rng = np.random.default_rng(31)
    batches = [token_batch(mt, rng, mt.cpu(), SUPER_BATCH, LSTM_SEQ,
                           LSTM_HIDDEN) for _ in range(SUPER_BATCHES)]
    states = lstm_states(SUPER_BATCH, LSTM_HIDDEN)
    pd = [("data", (SUPER_BATCH, LSTM_SEQ))] + states
    pl = [("softmax_label", (SUPER_BATCH, LSTM_SEQ))]
    sym = mt.models.lstm_unroll(LSTM_LAYERS, LSTM_SEQ, LSTM_VOCAB,
                                LSTM_HIDDEN, LSTM_HIDDEN, LSTM_VOCAB)
    tokens = SUPER_BATCHES * SUPER_BATCH * LSTM_SEQ

    def run(k):
        mt.random.seed(5)
        mod = mt.mod.Module(sym, data_names=["data"] + [n for n, _ in
                                                        states],
                            label_names=["softmax_label"], context=mt.gpu(0))
        metric = time_major_ce(mt)
        marks, values = [], []

        def epoch_end(epoch, s, a, x):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), mt.metric.host_syncs()))
            values.append(metric.get())
        t0 = time.perf_counter()
        mod.fit(batch_iter(mt, batches, pd, pl), num_epoch=2,
                eval_metric=metric, optimizer="sgd",
                optimizer_params=dict(LSTM_OPT), arg_params=arg0,
                aux_params={}, superstep=k, epoch_end_callback=epoch_end)
        wall = time.perf_counter() - t0
        (ta, sa), (tb, sb) = marks
        return {"mod": mod, "metric": metric, "values": values,
                "tokens_s": tokens / (tb - ta), "fit_s": wall,
                "drains_per_step": (sb - sa) / SUPER_BATCHES}

    torch.use_deterministic_algorithms(True)
    try:
        one, sup = run(1), run(SUPER_K)
    finally:
        torch.use_deterministic_algorithms(False)
    p1 = host_params(one["mod"])[0]
    pk = host_params(sup["mod"])[0]
    same_params = bitwise(p1, pk)
    same_mom = bitwise(opt_leaves(torch, one["mod"]._fused.state),
                       opt_leaves(torch, sup["mod"]._fused.state))
    same_metric = one["values"] == sup["values"]
    stats = sup["mod"]._superstep_stats.report()
    graphs = sup["mod"]._fused.stats.report()
    metric_graphs = sum(1 for e in sup["mod"]._fused._metric_graphs.values()
                        if e[0] is not None)
    print("superstep: PTB LSTM 2x%d vocab %d, batch %d x %d steps, SGD lr "
          "%g momentum %g, %d batches x 2 epochs; K=%d against K=1: params "
          "bitwise %s, momentum bitwise %s, metric %s vs %s equal %s "
          "(gate: all bitwise)" % (
              LSTM_HIDDEN, LSTM_VOCAB, SUPER_BATCH, LSTM_SEQ,
              LSTM_OPT["learning_rate"], LSTM_OPT["momentum"], SUPER_BATCHES,
              SUPER_K, same_params, same_mom, sup["values"], one["values"],
              same_metric))
    if not (same_params and same_mom and same_metric):
        fail("superstep K=%d differs from K=1" % SUPER_K)
    if stats["supersteps"] != 2 * SUPER_BATCHES // SUPER_K:
        fail("superstep ran %d supersteps, want %d"
             % (stats["supersteps"], 2 * SUPER_BATCHES // SUPER_K))
    mod, metric = sup["mod"], sup["metric"]
    group = batches[:SUPER_K]
    wall_k, dev_k, _ = device_profile(
        torch, lambda: mod.superstep_train(group, metric), reps=3)

    def k1_step():
        one["mod"].forward_backward(batches[0])
        one["mod"].update()
        one["mod"].update_metric(one["metric"], batches[0].label)
    wall_1, dev_1, _ = device_profile(torch, k1_step, reps=3)
    print("superstep: tokens/s (2nd epoch) K=1 %.1f, K=%d %.1f (x%.3f); "
          "metric drains per step K=1 %.4f, K=%d %.4f; step graph %s, "
          "metric graphs captured %d; superstep counters %s; busy share "
          "K=1 step %.3f (wall %.3f ms, device %.3f ms), K=%d superstep "
          "%.3f (wall %.3f ms, device %.3f ms); card %s" % (
              one["tokens_s"], SUPER_K, sup["tokens_s"],
              sup["tokens_s"] / one["tokens_s"], one["drains_per_step"],
              SUPER_K, sup["drains_per_step"], graphs, metric_graphs,
              json.dumps(stats), dev_1 / wall_1, wall_1, dev_1, SUPER_K,
              dev_k / wall_k, wall_k, dev_k, smi))
    out = {"tokens_s_k1": one["tokens_s"], "tokens_s_k": sup["tokens_s"],
           "drains_k1": one["drains_per_step"],
           "drains_k": sup["drains_per_step"], "graphs": graphs,
           "busy_k1": dev_1 / wall_1, "busy_k": dev_k / wall_k,
           "wall_k1_ms": wall_1, "wall_k_ms": wall_k}
    del one, sup, mod
    gc.collect()
    torch.cuda.empty_cache()
    return out


def resnet_setup(mt, n_batches, seed):
    """ResNet-50's symbol, Xavier host params from a seed and
    ``n_batches`` host batches of 128."""
    sym = mt.models.get_resnet50(1000)
    init = mt.mod.Module(sym, context=mt.cpu())
    init.bind([("data", (1, 3, 224, 224))], [("softmax_label", (1,))])
    mt.random.seed(seed)
    init.init_params(mt.init.Xavier(factor_type="in", magnitude=2.34))
    arg0, aux0 = init.get_params()
    arg0 = {k: v.copy() for k, v in arg0.items()}
    aux0 = {k: v.copy() for k, v in aux0.items()}
    rng = np.random.default_rng(seed + 1)
    b = RESNET_BATCH
    batches = [mt.io.DataBatch(
        data=[mt.nd.array(rng.random((b, 3, 224, 224), dtype=np.float32),
                          ctx=mt.cpu())],
        label=[mt.nd.array(rng.integers(0, 1000, b).astype(np.float32),
                           ctx=mt.cpu())], pad=0)
        for _ in range(n_batches)]
    pd = [("data", (b, 3, 224, 224))]
    pl = [("softmax_label", (b,))]
    return sym, arg0, aux0, batches, pd, pl


def feedforward_leg(torch, mt, smi, res):
    """(b) FeedForward.fit against Module.fit, 2 epochs of 4 host batches
    on the fused step under deterministic cuDNN: params bitwise; img/s of
    the second epoch; predict's argmax against Module.predict's."""
    sym, arg0, aux0, batches, pd, pl = res
    b = RESNET_BATCH

    def timer(last_nbatch):
        marks = []

        def cb(param):
            if param.nbatch == last_nbatch:
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
        return marks, cb

    marks_ff, cb_ff = timer(FF_BATCHES)       # FeedForward counts from 1
    ff = mt.model.FeedForward(sym, ctx=mt.gpu(0), num_epoch=2,
                              arg_params=arg0, aux_params=aux0, **FF_OPT)
    ff.fit(batch_iter(mt, batches, pd, pl), batch_end_callback=cb_ff)
    ff_fused = ff._module._fused.stats.report()
    ffp = {k: v.asnumpy() for k, v in ff.arg_params.items()}
    ffa = {k: v.asnumpy() for k, v in ff.aux_params.items()}
    ff._module = None
    torch.cuda.empty_cache()
    marks_m, cb_m = timer(FF_BATCHES - 1)     # fit counts from 0
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.fit(batch_iter(mt, batches, pd, pl), num_epoch=2,
            optimizer_params=dict(FF_OPT), arg_params=arg0, aux_params=aux0,
            batch_end_callback=cb_m)
    mp, ma = host_params(mod)
    same = bitwise(ffp, mp) and bitwise(ffa, ma)
    ff_img_s = FF_BATCHES * b / (marks_ff[1] - marks_ff[0])
    mod_img_s = FF_BATCHES * b / (marks_m[1] - marks_m[0])
    x0 = batches[0].data[0].asnumpy()
    y0 = batches[0].label[0].asnumpy()
    ff_pred = ff.predict(mt.io.NDArrayIter(x0, y0, batch_size=b))
    mod_pred = mod.predict(mt.io.NDArrayIter(x0, y0, batch_size=b)).asnumpy()
    same_argmax = np.array_equal(ff_pred.argmax(1), mod_pred.argmax(1))
    print("feedforward: ResNet-50 batch %d, SGD lr %g momentum %g, TF32 "
          "off, cuDNN deterministic, 2 epochs of %d host batches: "
          "FeedForward.fit fused step %s, Module.fit fused step %s; params "
          "and aux bitwise %s (gate); img/s (2nd epoch) FeedForward.fit "
          "%.1f, Module.fit %.1f; predict argmax equal to Module.predict's "
          "%s (gate), max |diff| %.3g; card %s" % (
              b, FF_OPT["learning_rate"], FF_OPT["momentum"], FF_BATCHES,
              ff_fused, mod._fused.stats.report(), same, ff_img_s, mod_img_s,
              same_argmax, float(np.abs(ff_pred - mod_pred).max()), smi))
    if not same:
        fail("FeedForward.fit differs from Module.fit")
    if not same_argmax:
        fail("FeedForward.predict's argmax differs from Module.predict's")
    del mod, ff
    gc.collect()
    torch.cuda.empty_cache()
    return {"ff_img_s": ff_img_s, "mod_img_s": mod_img_s}


def v07_write_out(torch, mt, sym, arg0, aux0, batches, fractions, steps,
                  update_ctx):
    """v0.7's data parallelism written out: one simple_bind executor per
    share of the batch on gpu(0), the gradients summed in context order,
    moved to ``update_ctx`` and updated there by the optimizer's updater,
    the weights copied back to every executor; -> host (args, aux
    averaged over the executors)."""
    b = RESNET_BATCH
    names = [n for n in sym.list_arguments()
             if n not in ("data", "softmax_label")]
    slices = mt.executor_manager._split_input_slice(b, fractions)
    req = {n: ("write" if n in names else "null")
           for n in sym.list_arguments()}
    execs = [sym.simple_bind(mt.gpu(0), grad_req=req,
                             data=(s.stop - s.start, 3, 224, 224),
                             softmax_label=(s.stop - s.start,))
             for s in slices]
    for e in execs:
        e.copy_params_from(arg0, aux0)
    opt = mt.optimizer.create("sgd", rescale_grad=1.0 / b,
                              param_idx2name=dict(enumerate(names)),
                              sym=sym, **FF_OPT)
    updater = mt.optimizer.get_updater(opt)
    master = {n: arg0[n].copyto(update_ctx) for n in names}
    for i in range(steps):
        bt = batches[i % len(batches)]
        for e, s in zip(execs, slices):
            e.arg_dict["data"][:] = bt.data[0][s.start:s.stop]
            e.arg_dict["softmax_label"][:] = bt.label[0][s.start:s.stop]
            e.forward(is_train=True)
            e.backward()
        for idx, n in enumerate(names):
            g = execs[0].grad_dict[n]._get()
            for e in execs[1:]:
                g = g + e.grad_dict[n]._get()
            g = mt.nd.NDArray(g.to(update_ctx.torch_device()))
            updater(idx, g, master[n])
            for e in execs:
                master[n].copyto(e.arg_dict[n])
    args = {n: master[n].asnumpy() for n in names}
    aux = {n: np.mean([e.aux_dict[n].asnumpy() for e in execs], axis=0,
                      dtype=np.float32) for n in sym.list_auxiliary_states()}
    del execs
    torch.cuda.empty_cache()
    return args, aux


def multi_context_leg(torch, mt, smi, res):
    """(c) Module(context=[gpu(0), gpu(0)]) with kvstore 'device' and
    'local' (2 classic steps each) and work_load_list [1, 3] (one step),
    each against the plain write-out; img/s beside one context's classic
    step."""
    sym, arg0, aux0, batches, pd, pl = res
    b = RESNET_BATCH

    def module(ctx, kv, wl=None, steps=2):
        mod = mt.mod.Module(sym, context=ctx, work_load_list=wl)
        mod.bind(pd, pl)
        mod.init_params(arg_params=arg0, aux_params=aux0)
        mod.init_optimizer(kvstore=kv, optimizer="sgd",
                           optimizer_params=dict(FF_OPT))
        for i in range(steps):
            train_step(mod, batches[i % len(batches)])
        return mod

    results = {}
    for name, kv, wl, steps, update_ctx in (
            ("device", "device", None, 2, mt.gpu(0)),
            ("local", "local", None, 2, mt.cpu()),
            ("device-wl-1-3", "device", [1, 3], 1, mt.gpu(0))):
        mod = module([mt.gpu(0), mt.gpu(0)], kv, wl, steps)
        if mod._fused is not None or len(mod._exec_group.execs) != 2:
            fail("two contexts on one card did not take the classic path")
        got = host_params(mod)
        kv_type = mod._kvstore.type
        del mod
        torch.cuda.empty_cache()
        want = v07_write_out(torch, mt, sym, arg0, aux0, batches,
                             wl or [1, 1], steps, update_ctx)
        err = rel_l2(got, want)
        results[name] = {"rel_l2": err, "kvstore": kv_type}
        print("multi-context: ResNet-50 batch %d on [gpu(0), gpu(0)], "
              "kvstore %r (store type %s), work_load_list %s, %d classic "
              "steps: relative L2 to the v0.7 write-out %.3g (gate %g)"
              % (b, kv, kv_type, wl or [1, 1], steps, err, MULTI_REL_L2))
        if err > MULTI_REL_L2:
            fail("two contexts (kvstore %s) differ from the write-out" % kv)
    # img/s: two contexts (kvstore device) against one context's classic
    rates = {}
    for name, ctx in (("1ctx", [mt.gpu(0)]), ("2ctx", [mt.gpu(0),
                                                       mt.gpu(0)])):
        with fused_train_env(False):
            mod = module(ctx, "device", steps=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(3):
            train_step(mod, batches[i % len(batches)])
        torch.cuda.synchronize()
        rates[name] = 3 * b / (time.perf_counter() - t0)
        del mod
        torch.cuda.empty_cache()
    print("multi-context: classic step img/s one context %.1f, two "
          "contexts (kvstore device) %.1f; kvstore 'local' auto-selected "
          "%s (largest parameter %d elements); card %s" % (
              rates["1ctx"], rates["2ctx"], results["local"]["kvstore"],
              max(v.size for v in arg0.values()), smi))
    results["rates"] = rates
    gc.collect()
    return results


_SIGTERM_CHILD = r"""
import sys, time
sys.path.insert(0, sys.argv[3])
import numpy as np
import mxnet_tpu_torch as mx
store, ready = sys.argv[1], sys.argv[2]
rng = np.random.default_rng(0)
it = mx.io.NDArrayIter(rng.random((640, 1, 28, 28), dtype=np.float32),
                       rng.integers(0, 10, 640).astype(np.float32),
                       batch_size=64)
mod = mx.mod.Module(mx.models.get_lenet(), context=mx.gpu(0))
mgr = mx.checkpoint.CheckpointManager(store, keep_last_n=None)
mgr.install_preemption_handler()

def on_batch(param):
    if param.nbatch == 1:
        open(ready, "w").write("ok")
    time.sleep(0.05)

mod.fit(it, num_epoch=10000, optimizer_params={"learning_rate": 0.05},
        checkpoint=mgr, batch_end_callback=on_batch)
print("LATEST", mgr.latest_step())
sys.exit(7 if mgr.latest_step() is not None else 8)
"""


def sigterm_round(root, tmp):
    """A LeNet fit in a child process on the card, SIGTERM after its
    second batch: it snapshots at the next batch boundary and exits 7."""
    import signal
    store = os.path.join(tmp, "sigterm-store")
    ready = os.path.join(tmp, "sigterm-ready")
    script = os.path.join(tmp, "sigterm_child.py")
    with open(script, "w") as f:
        f.write(_SIGTERM_CHILD)
    proc = subprocess.Popen([sys.executable, script, store, ready, root],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        deadline = time.time() + 180
        while not os.path.exists(ready):
            if proc.poll() is not None or time.time() > deadline:
                fail("SIGTERM child never reached batch 1: %s"
                     % proc.communicate()[1][-2000:])
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, out.strip(), store


def checkpoint_leg(torch, mt, smi, res, root, tmp):
    """(d) fit(checkpoint=, checkpoint_every=2) over 6 batches (with
    do_checkpoint(module=) at the epoch end), then a fresh module resumed
    from step 4: params and momentum bitwise against the uninterrupted
    run; bytes per save, the train thread's stall, the writer's commit
    wall, the pinned bytes; a SIGTERM round in a child process."""
    import shutil
    sym, arg0, aux0, batches, pd, pl = res
    full = os.path.join(tmp, "ckpt-full")
    prefix = os.path.join(tmp, "resnet")
    marks = []

    def cb(param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mgr = mt.checkpoint.CheckpointManager(full, keep_last_n=None,
                                          name="resnet50-full")
    mod.fit(batch_iter(mt, batches[:CKPT_BATCHES], pd, pl), num_epoch=1,
            optimizer_params=dict(FF_OPT), arg_params=arg0,
            aux_params=aux0, checkpoint=mgr, checkpoint_every=CKPT_EVERY,
            batch_end_callback=cb,
            epoch_end_callback=mt.callback.do_checkpoint(prefix,
                                                         module=mod))
    stats = dict(mgr.stats._c)
    mgr.close()
    steps = mt.checkpoint.all_steps(full)
    ref_p, ref_a = host_params(mod)
    ref_m = opt_leaves(torch, mod._fused.state)
    # batch-end marks: [k] follows batch k (steps 1-3 eager warm-up, 4
    # the capture, 5 and 6 replays); the save at step 4 runs between
    # marks[3] and marks[4] with step 5's replay, step 6's replay alone
    # between marks[4] and marks[5]
    with_save = marks[4] - marks[3]
    plain = marks[5] - marks[4]
    del mod
    torch.cuda.empty_cache()
    resume_dir = os.path.join(tmp, "ckpt-resume")
    shutil.copytree(full, resume_dir)
    for s in steps:
        if s > CKPT_RESUME_AT:
            shutil.rmtree(os.path.join(resume_dir,
                                       mt.checkpoint.step_dir_name(s)))
    mod2 = mt.mod.Module(sym, context=mt.gpu(0))
    seen = []
    with mt.checkpoint.CheckpointManager(resume_dir,
                                         keep_last_n=None) as mgr2:
        mod2.fit(batch_iter(mt, batches[:CKPT_BATCHES], pd, pl),
                 num_epoch=1, optimizer_params=dict(FF_OPT),
                 checkpoint=mgr2, resume=True,
                 batch_end_callback=lambda p: seen.append(p.nbatch))
    got_p, got_a = host_params(mod2)
    same = bitwise(ref_p, got_p) and bitwise(ref_a, got_a) and \
        bitwise(ref_m, opt_leaves(torch, mod2._fused.state))
    n_params = sum(v.size for v in arg0.values())
    print("checkpoint: ResNet-50 (%d params + momentum) fit over %d "
          "batches with checkpoint_every=%d: committed steps %s; resumed "
          "from step %d on batch %s: params, aux and momentum bitwise to "
          "the uninterrupted run %s (gate)" % (
              n_params, CKPT_BATCHES, CKPT_EVERY, steps, CKPT_RESUME_AT,
              seen[:1], same))
    if not same or seen[:1] != [CKPT_RESUME_AT]:
        fail("checkpoint resume differs from the uninterrupted run")
    print("checkpoint: bytes per save %d, pinned host bytes %d, train-"
          "thread time of save() %.6f s (last), synchronized step with a "
          "save %.6f s - without %.6f s = stall %.6f s, writer's commit "
          "wall %.6f s (last; %.1f MB/s); card %s" % (
              stats["last_bytes"], stats["last_pinned_bytes"],
              stats["last_overhead_s"], with_save, plain, with_save - plain,
              stats["last_save_s"], stats["last_bytes_per_s"] / 1e6, smi))
    rc, out, store = sigterm_round(os.path.dirname(os.path.abspath(
        __file__)), tmp)
    latest = mt.checkpoint.latest_step(store)
    print("checkpoint: SIGTERM round (LeNet on the card in a child "
          "process): exit code %s (want 7), %r, newest committed step %s"
          % (rc, out, latest))
    if rc != 7 or latest is None:
        fail("the SIGTERM round did not snapshot and exit")
    del mod2
    gc.collect()
    torch.cuda.empty_cache()
    return {"full": full, "prefix": prefix, "stats": stats,
            "stall_s": with_save - plain, "sym": sym,
            "epoch_steps": CKPT_BATCHES}


def serve_dir_leg(torch, mt, ck, smi, ckpt, batches):
    """(e) ServeEngine.from_checkpoint_dir on (d)'s directory, answers
    bitwise to a Predictor on the legacy pair do_checkpoint(module=)
    wrote at the same step; reload_from_checkpoint_dir mid-flood."""
    sym, full, prefix = ckpt["sym"], ckpt["full"], ckpt["prefix"]
    x = batches[0].data[0].asnumpy()[:8]
    ck.reset_launches()
    eng = mt.serve.ServeEngine.from_checkpoint_dir(
        full, sym, {"data": (1, 3, 224, 224)})
    pred = mt.Predictor(prefix + "-symbol.json", prefix + "-0001.params",
                        {"data": (1, 3, 224, 224)})
    try:
        same = True
        for i in range(len(x)):
            got = eng.predict(x[i])
            pred.set_input("data", x[i:i + 1])
            pred.forward()
            same = same and np.array_equal(got, pred.get_output(0)[0])
        print("serve-dir: ServeEngine.from_checkpoint_dir(step %d) against "
              "Predictor on %s-0001.params, %d single requests: bitwise %s "
              "(gate)" % (mt.checkpoint.latest_step(full),
                          os.path.basename(prefix), len(x), same))
        if not same:
            fail("ServeEngine.from_checkpoint_dir differs from Predictor")
        versions = []
        answers, wall, errors = flood(
            lambda i: eng.submit(x[i % len(x)]), SERVE_FLOOD, SERVE_THREADS,
            wave=4, started=lambda: versions.append(
                eng.reload_from_checkpoint_dir(full, step=CKPT_RESUME_AT)))
        rep = eng.stats.report()
    finally:
        eng.close()
    dropped = rep["submitted"] - rep["completed"]
    launches = dict(ck.LAUNCHES)
    print("serve-dir: reload_from_checkpoint_dir(step %d) mid-flood of %d "
          "requests from %d threads: weights version %s, %d completed, %d "
          "dropped, %d failed, %d errors, %.1f req/s; hand-kernel launches "
          "%s; card %s" % (CKPT_RESUME_AT, SERVE_FLOOD, SERVE_THREADS,
                           versions, rep["completed"], dropped,
                           rep["failed"], len(errors), SERVE_FLOOD / wall,
                           launches, smi))
    if errors or dropped or rep["failed"] or versions != [1] or \
            any(a is None for a in answers):
        fail("reload mid-flood dropped or failed requests: %s" % errors)
    return {"launches": launches}


def group2ctx_leg(torch, mt, smi):
    """(f) the model-parallel LSTM (lstm_unroll with ctx_groups) bound
    with every group on gpu(0): outputs and gradients bitwise to the
    ungrouped bind, under deterministic algorithms."""
    net = mt.models.lstm_unroll(LSTM_LAYERS, LSTM_SEQ, LSTM_VOCAB,
                                LSTM_HIDDEN, LSTM_HIDDEN, LSTM_VOCAB,
                                ctx_groups=["g0", "g1"])
    b = SUPER_BATCH
    shapes = dict([("data", (b, LSTM_SEQ)), ("softmax_label", (b, LSTM_SEQ))]
                  + lstm_states(b, LSTM_HIDDEN))
    params = lstm_params(mt, LSTM_HIDDEN, 50)
    rng = np.random.default_rng(51)
    ids = rng.integers(0, LSTM_VOCAB, (b, LSTM_SEQ + 1)).astype(np.float32)
    outs = []
    torch.use_deterministic_algorithms(True)
    try:
        for group2ctx in ({"g0": mt.gpu(0), "g1": mt.gpu(0)}, None):
            ex = net.simple_bind(mt.gpu(0), group2ctx=group2ctx, **shapes)
            ex.copy_params_from(params, {}, allow_extra_params=True)
            ex.arg_dict["data"][:] = ids[:, :-1]
            ex.arg_dict["softmax_label"][:] = ids[:, 1:]
            ex.forward(is_train=True)
            ex.backward()
            outs.append([ex.outputs[0].asnumpy()]
                        + [ex.grad_dict[n].asnumpy()
                           for n in sorted(params)])
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(np.array_equal(a, c) for a, c in zip(*outs))
    print("group2ctx: lstm_unroll with ctx_groups g0/g1 both on gpu(0), "
          "batch %d: outputs and %d gradients bitwise to the ungrouped "
          "bind %s (gate); card %s" % (b, len(params), same, smi))
    if not same:
        fail("group2ctx bind differs from the ungrouped bind")


def rest_of_training_phase(torch, mt, ck, smi):
    print("phase 18: the rest of training; TF32 matmul=%s cudnn=%s; card "
          "%s" % (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32, smi))
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmpdir = tempfile.TemporaryDirectory()
    ck.reset_launches()
    sup = superstep_leg(torch, mt, smi)
    res = resnet_setup(mt, max(FF_BATCHES, CKPT_BATCHES), 60)
    torch.backends.cudnn.deterministic = True
    try:
        ff = feedforward_leg(torch, mt, smi, res)
        multi = multi_context_leg(torch, mt, smi, res)
        ckpt = checkpoint_leg(torch, mt, smi, res, root, tmpdir.name)
    finally:
        torch.backends.cudnn.deterministic = False
    launches = dict(ck.LAUNCHES)
    print("phase 18: hand-kernel launches on (a)-(d): %s" % launches)
    if any(launches.values()):
        fail("the training paths launched hand kernels: %s" % launches)
    served = serve_dir_leg(torch, mt, ck, smi, ckpt, res[3])
    group2ctx_leg(torch, mt, smi)
    tmpdir.cleanup()
    print("rest of training result (card %s): %s; phase %.1f s" % (
        smi, json.dumps({
            "superstep-tokens_s-k1": sup["tokens_s_k1"],
            "superstep-tokens_s-k%d" % SUPER_K: sup["tokens_s_k"],
            "feedforward-img_s": ff["ff_img_s"],
            "module-fit-img_s": ff["mod_img_s"],
            "two-ctx-img_s": multi["rates"]["2ctx"],
            "one-ctx-classic-img_s": multi["rates"]["1ctx"],
            "ckpt-bytes": ckpt["stats"]["last_bytes"],
            "ckpt-stall_s": ckpt["stall_s"],
            "ckpt-commit_s": ckpt["stats"]["last_save_s"]}),
        time.perf_counter() - t0))
    return {"superstep": sup, "feedforward": ff, "multi": multi,
            "checkpoint": ckpt, "serve": served}


# -- phase 19: routed MoE and the sparse embedding engine --------------------
# (a), (b): Switch-Base-8 (Fedus et al. 2021, Switch Transformer): d_model
# 768, d_ff 3072, ReLU experts, top-1 routing over 8 experts, capacity
# factor 1.25; the batch cut from Switch's 65,536 tokens to 8,192
# (C = ceil(1.25 * 8192 / 8) = 1,280); the decode vocab is T5's 32,128
SW_D, SW_H, SW_E, SW_K, SW_CF = 768, 3072, 8, 1, 1.25
SW_TOKENS = 8192
SW_VOCAB = 32128
SW_OPT = {"learning_rate": 0.1, "momentum": 0.9}
MOE_REPLAYS = 8
MOE_WINDOWS, MOE_WINDOW_STEPS = 3, 5
MOE_CPU_STEPS = 2
# (a) card against the CPU after MOE_CPU_STEPS steps from one
# checkpoint: for each parameter, the relative L2 of its change (cuBLAS
# and the CPU sum the gate's and the experts' products in other orders;
# an expert pre-activation within rounding of 0 lands on the other side
# of the relu, which puts the first expert layer at ~3e-4 where the
# other leaves sit at 1e-5 or below; a token that a router logit tie
# sends to another expert moves ~1/30 of that expert's gradient and
# fails it, as does a router that does not train, at 1.0)
MOE_LEAF_L2 = 1e-3
# (a) the router gate's gradient from the aux loss alone, card against
# CPU: relative L2 (float32 sums over 8,192 tokens in other orders)
MOE_AUX_GRAD_L2 = 1e-5
# route on the card against route on the CPU, the same logits: slots,
# counts and hits equal (tokens after a top-2 gate gap below this count
# as ties, phase 7's rule), combine weights and aux within rtol
ROUTE_TIE, ROUTE_RTOL = 1e-6, 1e-5
MOE_DEC_SLOTS, MOE_DEC_STREAMS, MOE_DEC_NEW, MOE_DEC_PROMPT = 16, 32, 64, 29
MOE_DEC_THREADS = 4
MOE_STATS_EVERY = 16
# (c): bench_embed.py's step leg (200,000 x 32, 512 x 8 ids a batch drawn
# from 410 hot ids, unique cap 512, tower 64 -> 2), and the same with a
# 4,000,000 x 64 table (1.02 GB, far past the 50 MB L2)
EMB_TABLES = [("200k x 32", 200_000, 32), ("4M x 64", 4_000_000, 64)]
EMB_B, EMB_L, EMB_HOT, EMB_CAP, EMB_HIDDEN = 512, 8, 410, 512, 64
EMB_OPT = {"learning_rate": 0.1, "momentum": 0.9}
EMB_BATCHES = 4
EMB_STEPS = RESNET_WARMUP + 8              # warm-up, then 8 replays
EMB_WINDOWS, EMB_WINDOW_STEPS = 3, 10
# (c) card against the CPU after EMB_BATCHES steps (200k x 32): float32
# gradient sums in other orders, carried on by momentum
EMB_CPU_RTOL, EMB_CPU_ATOL = 1e-4, 1e-5
# (d): bench_embed.py's serve leg
REC_VOCAB, REC_DIM, REC_L, REC_HIDDEN, REC_CLASSES = 10_000, 32, 16, 64, 8
REC_THREADS, REC_REQS = 8, 25
# (d) engine answers (softmax probabilities) against a serial batch-1
# Predictor: fused_fc_epilogue against cuBLAS's addmm for rfc1
REC_RTOL, REC_ATOL = 1e-4, 1e-6
# (e) device_embed on the card against the store on the CPU
KV_VOCAB, KV_DIM, KV_IDS = 200_000, 64, 4096
KV_RTOL, KV_ATOL = 1e-5, 1e-6


def switch_block(mt):
    return mt.moe.MoEFeedForward(mt.sym.Variable("data"), num_hidden=SW_H,
                                 num_experts=SW_E, k=SW_K,
                                 capacity_factor=SW_CF, name="moe")


def switch_symbol(mt):
    net = mt.sym.FullyConnected(switch_block(mt), num_hidden=2, name="head")
    return mt.moe.with_aux_loss(mt.sym.SoftmaxOutput(net, name="softmax"))


def dense_matched_symbol(mt):
    """bench_moe.py:52-63's FLOP-matched dense block: FC(E*H) -> relu ->
    FC(D), then the same head."""
    net = mt.sym.FullyConnected(mt.sym.Variable("data"),
                                num_hidden=SW_E * SW_H, name="d1")
    net = mt.sym.Activation(net, act_type="relu")
    net = mt.sym.FullyConnected(net, num_hidden=SW_D, name="d2")
    net = mt.sym.FullyConnected(net, num_hidden=2, name="head")
    return mt.sym.SoftmaxOutput(net, name="softmax")


def fan_in_params(sym, shapes, seed, scale=1.0):
    """U(-s, s) with s = scale * sqrt(6 / fan_in), fan_in the reduced
    axis of each product (the last axis of a 2-D weight, axis 1 of a
    stacked (E, in, out) expert weight); biases U(-0.01, 0.01)."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("bias"):
            s = 0.01
        else:
            fan = shape[1] if len(shape) == 3 else shape[-1]
            s = scale * math.sqrt(6.0 / fan)
        params[name] = (rng.random(shape, dtype=np.float32) * 2 - 1) * \
            np.float32(s)
    return params


def nd_batches(mt, xs, ys, ctx):
    return [mt.io.DataBatch(data=[mt.nd.array(x, ctx=ctx)],
                            label=[mt.nd.array(y, ctx=ctx)])
            for x, y in zip(xs, ys)]


def plain_module(mt, sym, ctx, data_shape, arg0, opt, data_name="data",
                 fixed=None):
    mod = mt.mod.Module(sym, data_names=(data_name,), context=ctx,
                        fixed_param_names=fixed)
    mod.bind([(data_name, data_shape)], [("softmax_label",
                                          (data_shape[0],))])
    mod.init_params(arg_params={k: v if isinstance(v, mt.nd.NDArray)
                                else mt.nd.array(v, ctx=mt.cpu())
                                for k, v in arg0.items()}, aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(opt))
    if mod._fused is None:
        fail("%s: the module took the classic path" % sym.list_outputs())
    return mod


def replay_vs_eager(torch, fused, steps, batches, step_fn):
    """Run ``steps`` steps (batch i % len), the last from a snapshot;
    -> (host params after the last replay, the same step eager from the
    snapshot, both bitwise equal, host opt leaves of each)."""
    for i in range(steps):
        if i == steps - 1:
            snap = clone_state(torch, fused.state)
        step_fn(batches[i % len(batches)])
    replayed = clone_state(torch, fused.state)
    got, got_opt = state_params(fused.state), opt_leaves(torch, fused.state)
    restore_state(torch, fused.state, snap)
    fused._body(fused.make_batch(batches[(steps - 1) % len(batches)]))
    eager, eager_opt = state_params(fused.state), \
        opt_leaves(torch, fused.state)
    restore_state(torch, fused.state, replayed)
    del snap, replayed
    same = bitwise(got[0], eager[0]) and bitwise(got_opt, eager_opt)
    return got, eager, same


def route_check(torch, mt, cap, seed=42):
    """route() on the card against route() on the CPU for one set of
    (T, E) logits."""
    route = mt.moe.route
    logits = np.random.default_rng(seed).standard_normal(
        (SW_TOKENS, SW_E)).astype(np.float32)
    cpu = route(torch.as_tensor(logits), SW_K, cap)
    card = route(torch.as_tensor(logits).cuda(), SW_K, cap)
    torch.cuda.synchronize()
    gates = np.sort(torch.softmax(torch.as_tensor(logits), -1).numpy(), -1)
    gap = gates[:, -1] - gates[:, -2]
    slot_c, slot_g = cpu.slot.numpy(), card.slot.cpu().numpy()
    diff = np.nonzero((slot_c != slot_g).any(axis=1))[0]
    same = {f: np.array_equal(getattr(cpu, f).numpy(),
                              getattr(card, f).cpu().numpy())
            for f in ("slot", "counts", "hits", "dropped")}
    keep = np.ones(SW_TOKENS, bool)
    keep[diff] = False
    w_c, w_g = cpu.weight.numpy()[keep], card.weight.cpu().numpy()[keep]
    w_err = float(np.max(np.abs(w_c - w_g) / np.maximum(np.abs(w_c),
                                                        1e-30)))
    a_err = abs(float(cpu.aux) - float(card.aux)) / abs(float(cpu.aux))
    print("moe: route on the card vs the CPU, %d x %d logits, k %d, "
          "capacity %d: %s; combine weights worst relative %.3g, aux %.3g "
          "(gate %g); dropped %d; tokens apart %d" % (
              SW_TOKENS, SW_E, SW_K, cap, same, w_err, a_err, ROUTE_RTOL,
              int(cpu.dropped), len(diff)))
    if len(diff) and gap[diff[0]] >= ROUTE_TIE:
        fail("route on the card differs from the CPU at token %d, top-2 "
             "gate gap %.3g (tie below %g)" % (diff[0], gap[diff[0]],
                                               ROUTE_TIE))
    if not len(diff) and not all(same.values()):
        fail("route's counts or hits differ on the card: %s" % same)
    if w_err > ROUTE_RTOL or a_err > ROUTE_RTOL:
        fail("route's weights or aux differ on the card")
    return {"same": all(same.values()), "apart": len(diff)}


def aux_gate_grad(mt, ctx, x, wg):
    """The router gate's gradient from the aux loss alone: MakeLoss over
    the Switch block's aux head, one forward and backward on ``ctx``."""
    loss = mt.sym.MakeLoss(mt.moe.aux_loss_symbols(switch_block(mt))[0])
    grad = mt.nd.zeros(wg.shape, ctx=ctx)
    ex = loss.bind(ctx, {"data": mt.nd.array(x, ctx=ctx),
                         "moe_gate_weight": mt.nd.array(wg, ctx=ctx)},
                   args_grad={"moe_gate_weight": grad},
                   grad_req={"data": "null", "moe_gate_weight": "write"})
    ex.forward(is_train=True)
    ex.backward()
    return grad.asnumpy()


def leaf_change_l2(got, want, start):
    """Per parameter: the relative L2 of ``got``'s change from ``start``
    against ``want``'s, ||got - want|| / ||want - start|| in float64."""
    out = {}
    for k, s in start.items():
        num = float(np.linalg.norm((got[k].astype(np.float64)
                                    - want[k]).ravel()))
        den = float(np.linalg.norm((want[k].astype(np.float64)
                                    - s).ravel()))
        out[k] = num / den if den else (0.0 if num == 0.0 else math.inf)
    return out


def moe_train_leg(torch, mt, smi):
    """(a) Switch-Base-8's MoE FFN trained through the captured fused
    step under deterministic algorithms: route card vs CPU, the last
    replay bitwise against the same step eager, each parameter's change
    over the first steps against the CPU's (and a frozen router failing
    that gate), the aux loss's router gradient against the CPU's, step
    times against the FLOP-matched dense block in interleaved windows,
    moe_report()'s imbalance."""
    t, d, h, e = SW_TOKENS, SW_D, SW_H, SW_E
    gpu = mt.gpu(0)
    sym = switch_symbol(mt)
    shapes = {"data": (t, d), "softmax_label": (t,)}
    arg0 = fan_in_params(sym, shapes, 40)
    n_params = sum(v.size for v in arg0.values())
    cap = mt.moe.resolve_capacity(SW_CF, t, e, SW_K)
    flops = 2 * 2 * e * cap * d * h
    print("moe: Switch-Base-8 FFN (d_model %d, d_ff %d, %d experts, top-%d, "
          "cf %g): %d parameters, %d tokens a batch, capacity %d; expert "
          "products %.1f GFLOP a forward (dense block %.1f)" % (
              d, h, e, SW_K, SW_CF, n_params, t, cap, flops / 1e9,
              2 * 2 * t * d * e * h / 1e9))
    if n_params != 37787138:
        fail("Switch-Base-8 block has %d parameters, want 37787138"
             % n_params)
    route = route_check(torch, mt, cap)
    rng = np.random.default_rng(41)
    xs = [rng.standard_normal((t, d), dtype=np.float32) for _ in range(2)]
    ys = [(x[:, :16].sum(axis=1) > 0).astype(np.float32) for x in xs]
    staged = nd_batches(mt, xs, ys, gpu)
    steps = RESNET_WARMUP + MOE_REPLAYS
    was_det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        mod = plain_module(mt, sym, gpu, (t, d), arg0, SW_OPT)
        fused = mod._fused
        early = []

        def step(b):
            train_step(mod, b)
            if len(early) < MOE_CPU_STEPS:
                early.append(state_params(fused.state)[0])
        got, eager, same = replay_vs_eager(torch, fused, steps, staged,
                                           step)
        # a planted fault: the router frozen (as if its gradient were
        # zero), the same steps
        frozen = plain_module(mt, sym, gpu, (t, d), arg0, SW_OPT,
                              fixed=["moe_gate_weight"])
        for i in range(MOE_CPU_STEPS):
            train_step(frozen, staged[i % 2])
        planted = state_params(frozen._fused.state)[0]
        del frozen
    finally:
        torch.use_deterministic_algorithms(was_det)
    stats = fused.stats.report()
    outs = [o.asnumpy() for o in mod.get_outputs()]
    aux_v = float(outs[1].reshape(-1)[0])
    print("moe: %d steps of the fused step under deterministic algorithms: "
          "%s; last replay vs the same step eager: bitwise %s; aux loss "
          "%.4f, outputs finite %s" % (steps, stats, same, aux_v,
                                       all(np.isfinite(o).all()
                                           for o in outs)))
    want = {"captures": 1, "replays": MOE_REPLAYS,
            "eager_steps": RESNET_WARMUP}
    if stats != want or not same:
        fail("moe fused step: %s (want %s), replay bitwise %s"
             % (stats, want, same))
    if not all(np.isfinite(o).all() for o in outs):
        fail("moe outputs not finite")
    # each parameter's change over the first steps against the port's
    # CPU run of the same checkpoint
    cpu_mod = plain_module(mt, sym, mt.cpu(), (t, d), arg0, SW_OPT)
    host = nd_batches(mt, xs, ys, mt.cpu())
    for i in range(MOE_CPU_STEPS):
        train_step(cpu_mod, host[i % 2])
    cpu_p = state_params(cpu_mod._fused.state)[0]
    leaves = leaf_change_l2(early[-1], cpu_p, arg0)
    worst = max(leaves, key=leaves.get)
    planted_l2 = leaf_change_l2(planted, cpu_p, arg0)["moe_gate_weight"]
    print("moe: card vs CPU after %d steps from one checkpoint: relative L2 "
          "of each parameter's change %s, worst %s %.3g (gate %g); the "
          "router frozen on the card (a planted fault): moe_gate_weight "
          "%.3g" % (MOE_CPU_STEPS, {k: float("%.3g" % v)
                                    for k, v in leaves.items()},
                    worst, leaves[worst], MOE_LEAF_L2, planted_l2))
    if not leaves[worst] < MOE_LEAF_L2:
        fail("moe trajectory on the card departs from the CPU's at %s"
             % worst)
    if not planted_l2 > MOE_LEAF_L2:
        fail("the per-parameter gate passes a frozen router")
    # the router's gradient from the aux loss alone, card against CPU
    # (the aux term is ~1e-5 of the router's change in a step: no
    # trajectory gate sees it)
    g_card = aux_gate_grad(mt, gpu, xs[0], arg0["moe_gate_weight"])
    g_cpu = aux_gate_grad(mt, mt.cpu(), xs[0], arg0["moe_gate_weight"])
    aux_l2 = rel_l2([{"g": g_card}], [{"g": g_cpu}])
    print("moe: the aux loss's gradient of moe_gate_weight, card vs CPU: "
          "relative L2 %.3g (gate %g), norm %.4g" % (
              aux_l2, MOE_AUX_GRAD_L2, float(np.linalg.norm(g_cpu))))
    if not aux_l2 < MOE_AUX_GRAD_L2:
        fail("the aux loss's router gradient on the card departs from the "
             "CPU's")
    del cpu_mod, host, early, got, eager, planted
    # routed vs FLOP-matched dense, interleaved windows
    dsym = dense_matched_symbol(mt)
    dmod = plain_module(mt, dsym, gpu, (t, d), fan_in_params(
        dsym, shapes, 43), SW_OPT)
    for _ in range(RESNET_WARMUP + 1):
        train_step(dmod, staged[0])
    times = {"moe": [], "dense": []}
    for _ in range(MOE_WINDOWS):
        for name, m in (("moe", mod), ("dense", dmod)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(MOE_WINDOW_STEPS):
                train_step(m, staged[i % 2])
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3
                               / MOE_WINDOW_STEPS)
    moe_ms, dense_ms = min(times["moe"]), min(times["dense"])
    if fused.stats.captures != 1:
        fail("moe recaptured: %s" % fused.stats.report())
    wall, dev, rows = device_profile(
        torch, lambda: train_step(mod, staged[0]), reps=3)
    busy = dev / wall
    print("moe: a step profiled: %.3f ms wall, %.3f ms device, busy "
          "share %.3f" % (wall, dev, busy))
    for tm, key, n in rows[:5]:
        print("profile:   %8.3f ms  %5.1f%%  x%-4d %s"
              % (tm, 100.0 * tm / dev if dev else 0.0, n, key[:90]))
    # the trained router's traffic on a batch, into moe_report()
    with torch.no_grad():
        wg = fused.state["params"]["moe_gate_weight"]
        x = staged[0].data[0]._get()
        plan = mt.moe.route(x @ wg.t(), SW_K, cap)
        fused.moe_stats.note_counts("moe_dispatch", plan.counts.cpu().numpy(),
                                    float(plan.dropped))
    rep = fused.moe_stats.report()["blocks"]["moe_dispatch"]
    print("moe: step %.3f ms (%.0f tokens/s) against the dense block's "
          "%.3f ms (%.0f tokens/s): x%.3f; windows moe %s dense %s; "
          "moe_report: imbalance %.3f, dropped %.4f of %d token-choices, "
          "hits %s; card %s" % (
              moe_ms, t / moe_ms * 1e3, dense_ms, t / dense_ms * 1e3,
              dense_ms / moe_ms, [round(v, 3) for v in times["moe"]],
              [round(v, 3) for v in times["dense"]], rep["imbalance"],
              rep["drop_frac"], t * SW_K, rep["hits"], smi))
    del mod, dmod, fused, staged
    gc.collect()
    torch.cuda.empty_cache()
    return {"moe_ms": moe_ms, "dense_ms": dense_ms, "stats": stats,
            "imbalance": rep["imbalance"], "drop_frac": rep["drop_frac"],
            "leaf_l2": leaves, "aux_grad_l2": aux_l2, "route": route,
            "busy": busy, "params": n_params}


def switch_decode_symbol(mt):
    tok = mt.sym.Variable("data")
    hits = mt.sym.Variable("moe_hits")
    emb = mt.sym.Flatten(mt.sym.Embedding(tok, input_dim=SW_VOCAB,
                                          output_dim=SW_D, name="emb"))
    net = mt.moe.MoEFeedForward(emb, num_hidden=SW_H, num_experts=SW_E,
                                k=SW_K, capacity_factor=SW_CF, name="dmoe")
    logits = mt.sym.FullyConnected(net, num_hidden=SW_VOCAB, name="out")
    return mt.sym.Group([logits, hits + mt.moe.hit_symbols(logits)[0]])


def moe_decode_engine(mt, sym, params, **kw):
    return mt.serve.DecodeEngine(
        sym, params, state_shapes={"moe_hits": (SW_E,)},
        num_slots=MOE_DEC_SLOTS, max_new_tokens=MOE_DEC_NEW,
        pipeline=mt.passes.default_inference_pipeline(),
        moe_hits_state="moe_hits", moe_stats_every=MOE_STATS_EVERY, **kw)


def moe_stats_caught_up(eng, steps, timeout=60):
    """Wait until the engine sampled its hits at step ``steps`` (the last
    stream resolves inside the step, before the step's sample)."""
    deadline = time.monotonic() + timeout
    want = steps // MOE_STATS_EVERY
    while time.monotonic() < deadline:
        blk = eng.moe_stats.report()["blocks"].get("moe_hits")
        if blk is not None and blk["steps"] >= want:
            return blk
        time.sleep(0.005)
    fail("the decode engine sampled its hits %s times, want %d"
         % (eng.moe_stats.report(), want))


def moe_decode_leg(torch, mt, smi):
    """(b) routed decode at Switch-Base-8 widths through DecodeEngine
    with moe_hits_state: 32 streams held against the port's CPU engine,
    the routed count against the tokens processed, tokens/s."""
    e, streams = SW_E, MOE_DEC_STREAMS
    sym = switch_decode_symbol(mt)
    params = fan_in_params(sym, {"data": (MOE_DEC_SLOTS,),
                                 "moe_hits": (MOE_DEC_SLOTS, e)}, 44,
                           scale=2.0)
    params["emb_weight"] = np.random.default_rng(45).standard_normal(
        (SW_VOCAB, SW_D), dtype=np.float32)
    n_params = sum(v.size for v in params.values())
    if n_params != 87166336:
        fail("the routed decode model has %d parameters, want 87166336"
             % n_params)
    rng = np.random.default_rng(46)
    prompts = [rng.integers(0, SW_VOCAB, size=int(rng.integers(
        1, MOE_DEC_PROMPT + 1))) for _ in range(streams)]
    print("moe decode: tok -> Embedding(%d, %d) -> Switch-Base-8 FFN (cf "
          "%g, pinned to 0 by MoEServeParityPass) -> FC(%d): %d parameters; "
          "%d slots, %d streams of %d..%d prompt tokens and %d new ones "
          "from %d threads" % (SW_VOCAB, SW_D, SW_CF, SW_VOCAB, n_params,
                               MOE_DEC_SLOTS, streams,
                               min(map(len, prompts)),
                               max(map(len, prompts)), MOE_DEC_NEW,
                               MOE_DEC_THREADS))
    cpu_eng = moe_decode_engine(mt, sym, params, dev_type="cpu",
                                name="moe-decode-cpu")
    try:
        want, _, errors = flood(lambda i: cpu_eng.submit(prompts[i]),
                                streams, MOE_DEC_THREADS)
    finally:
        cpu_eng.close()
    if errors:
        fail("CPU routed decode errors: %s" % errors)
    pred = mt.Predictor(sym.tojson(), params, {"data": (1,),
                                               "moe_hits": (1, e)},
                        dev_type="cpu", type_dict={"data": np.int32},
                        pipeline=mt.passes.default_inference_pipeline())

    def margin_of(i, s):
        def at(j):
            # the step is stateless but for the hits: token j's logits
            # depend on the token fed at that step only
            seq = list(prompts[i]) + [int(x) for x in s[:j]]
            pred.set_input("data", np.asarray([seq[-1]], np.int32))
            pred.forward()
            lg = np.sort(pred.get_output(0)[0])
            return (float(lg[-1] - lg[-2]),
                    LOGIT_TOL_REL * max(1.0, float(np.abs(lg).max())))
        return at

    t0 = time.perf_counter()
    eng = moe_decode_engine(mt, sym, params, name="moe-decode")
    built = time.perf_counter() - t0
    try:
        if eng.device.type != "cuda":
            fail("DecodeEngine built without a context runs on %s"
                 % eng.device)
        # one stream alone: every step routes k choices for every slot
        s0 = eng.stats.report()["steps"]
        eng.generate(prompts[0][:1], timeout=600,
                     max_new_tokens=MOE_DEC_NEW)
        probe_steps = eng.stats.report()["steps"] - s0
        blk = moe_stats_caught_up(eng, probe_steps)
        routed_want = SW_K * MOE_DEC_SLOTS * probe_steps
        print("moe decode: one stream alone, %d steps: moe_report routed "
              "%d, want k x slots x steps = %d; dropped %d" % (
                  probe_steps, blk["routed"], routed_want, blk["dropped"]))
        if blk["routed"] != routed_want or blk["dropped"] != 0:
            fail("the routed count differs from the tokens processed")
        s0 = eng.stats.report()["steps"]
        got, wall, errors = flood(lambda i: eng.submit(prompts[i]),
                                  streams, MOE_DEC_THREADS)
        if errors:
            fail("routed decode errors: %s" % errors)
        steps = eng.stats.report()["steps"] - s0
        ties = sum(same_under_margin("moe decode stream %d" % i, s, want[i],
                                     margin_of(i, s))
                   for i, s in enumerate(got))
        tokens = sum(len(s) for s in got)
        rep = eng.moe_stats.report()["blocks"]["moe_hits"]
        print("moe decode: built+warmed %.2f s; %d streams, %d tokens in "
              "%.3f s = %.1f tokens/s; %d steps, %.3f ms a step (wall); all "
              "streams equal the CPU engine's (%d after a logit tie); hits "
              "imbalance %.3f" % (built, streams, tokens, wall, tokens / wall,
                                  steps, 1e3 * wall / steps, ties,
                                  rep["imbalance"]))
        step_wall = 1e3 * wall / steps
        s0 = eng.stats.report()["steps"]
        _, device = cuda_device_ms(torch, lambda: flood(
            lambda i: eng.submit(prompts[i]), streams, MOE_DEC_THREADS))
        psteps = eng.stats.report()["steps"] - s0
        step_device = device / psteps if device > 0 else None
        if step_device is None:
            print("moe decode: a step %.3f ms of wall; device time not "
                  "measured; card %s" % (step_wall, smi))
        else:
            print("moe decode: a step %.3f ms of wall, %.3f ms of device "
                  "time, busy share %.3f (card %s)" % (
                      step_wall, step_device, step_device / step_wall, smi))
    finally:
        eng.close()
    return {"tokens_s": tokens / wall, "step_wall_ms": step_wall,
            "step_device_ms": step_device, "params": n_params, "ties": ties}


def hot_ids(rng, n, hot, vocab):
    pool = rng.choice(vocab, hot, replace=False)
    return pool[rng.integers(0, hot, n)].astype(np.int32)


def rec_symbol(mt, vocab, dim, hidden, classes, unique_cap=None):
    """bench_embed.py's rec model: ids -> Embedding -> Flatten -> rfc1 +
    relu -> rfc2 -> SoftmaxOutput."""
    attr = {"__embed_unique__": str(unique_cap)} if unique_cap else None
    w = mt.sym.Variable("embed_weight", attr=attr)
    net = mt.sym.Embedding(mt.sym.Variable("ids"), weight=w,
                           input_dim=vocab, output_dim=dim, name="embed")
    net = mt.sym.Flatten(net)
    net = mt.sym.FullyConnected(net, num_hidden=hidden, name="rfc1")
    net = mt.sym.Activation(net, act_type="relu")
    net = mt.sym.FullyConnected(net, num_hidden=classes, name="rfc2")
    return mt.sym.SoftmaxOutput(net, name="softmax")


def embed_table_leg(torch, mt, smi, label, vocab, dim, cpu_check):
    """(c) one table: the fused step sparse (the default) and with
    MXNET_EMBED_SPARSE=0, captured; untouched rows and momentum bitwise,
    the last replay bitwise against the same step eager, one capture,
    step times in interleaved windows, peak memory, the dedup ratio."""
    gpu = mt.gpu(0)
    dev = gpu.torch_device()
    sym = rec_symbol(mt, vocab, dim, EMB_HIDDEN, 2, unique_cap=EMB_CAP)
    rng = np.random.default_rng(50)
    X = hot_ids(rng, EMB_BATCHES * EMB_B * EMB_L, EMB_HOT, vocab).reshape(
        EMB_BATCHES * EMB_B, EMB_L).astype(np.float32)
    y = (X.sum(axis=1) % 2).astype(np.float32)
    host = nd_batches(mt, np.split(X, EMB_BATCHES), np.split(y, EMB_BATCHES),
                      mt.cpu())
    tower = fan_in_params(rec_symbol(mt, 16, dim, EMB_HIDDEN, 2),
                          {"ids": (EMB_B, EMB_L), "softmax_label": (EMB_B,)},
                          51)
    tower.pop("embed_weight")
    gen = torch.Generator(device=dev)
    gen.manual_seed(52)
    table = (torch.rand((vocab, dim), generator=gen, device=dev) * 2 - 1) \
        * 0.05
    table_nd = mt.nd.NDArray(table)
    arg0 = dict(tower, embed_weight=table_nd)
    res = {}
    mods = {}
    for sparse in (True, False):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with env_set("MXNET_EMBED_SPARSE", "1" if sparse else "0"):
            mod = plain_module(mt, sym, gpu, (EMB_B, EMB_L), arg0, EMB_OPT,
                               data_name="ids")
        fused = mod._fused
        if bool(fused.sparse_embeds) != sparse:
            fail("MXNET_EMBED_SPARSE=%d: sparse tables %s"
                 % (sparse, fused.sparse_embeds))
        early, peak = [], [0]

        def step(b):
            train_step(mod, b)
            if sparse and len(early) < EMB_BATCHES:
                early.append(state_params(fused.state)[0])
            if fused.stats.eager_steps == RESNET_WARMUP \
                    and not fused.stats.captures:
                # the module's peak over its eager steps, above what was
                # there before it: what it holds (the bound executor's
                # arrays, the fused state) and what a step allocates (a
                # replay allocates nothing the allocator sees: its pool
                # was taken at capture)
                torch.cuda.synchronize()
                peak[0] = torch.cuda.max_memory_allocated() - base
        got, _eager, same = replay_vs_eager(torch, fused, EMB_STEPS, host,
                                            step)
        stats = fused.stats.report()
        peak = peak[0]
        want = {"captures": 1, "replays": EMB_STEPS - RESNET_WARMUP,
                "eager_steps": RESNET_WARMUP}
        if stats != want or not same:
            fail("embed %s sparse=%s: fused step %s (want %s), replay "
                 "bitwise %s" % (label, sparse, stats, want, same))
        res[sparse] = {"stats": stats, "peak": peak, "same": same}
        if sparse:
            named = torch.zeros(vocab, dtype=torch.bool, device=dev)
            named[torch.as_tensor(np.unique(X.astype(np.int64)),
                                  device=dev)] = True
            w = fused.state["params"]["embed_weight"]
            mom = fused.state["opt"]["embed_weight"]
            frozen = bool(torch.equal(w[~named], table[~named])) and \
                bool((mom[~named] == 0).all())
            moved = not torch.equal(w[named], table[named])
            res[sparse]["frozen"] = frozen
            ratio = fused.embed_stats.dedup_ratio()
            res[sparse]["dedup_ratio"] = ratio
            print("embed %s: sparse: %d of %d rows named; untouched rows "
                  "and momentum bitwise %s, named rows moved %s; dedup "
                  "ratio %.3f (embed_report)" % (
                      label, int(named.sum()), vocab, frozen, moved, ratio))
            if not (frozen and moved):
                fail("embed %s: the lazy update touched rows no batch "
                     "names (or none moved)" % label)
            if cpu_check:
                cpu_mod = plain_module(mt, sym, mt.cpu(), (EMB_B, EMB_L),
                                       dict(tower, embed_weight=table.cpu()
                                            .numpy()), EMB_OPT,
                                       data_name="ids")
                for b in host:
                    train_step(cpu_mod, b)
                cpu_p = state_params(cpu_mod._fused.state)[0]
                err = worst_rel([early[-1]], [cpu_p], EMB_CPU_ATOL)
                print("embed %s: card vs CPU after %d sparse steps: "
                      "smallest rtol at atol %g: %.3g (gate %g)" % (
                          label, EMB_BATCHES, EMB_CPU_ATOL, err,
                          EMB_CPU_RTOL))
                if not params_close([early[-1]], [cpu_p], EMB_CPU_RTOL,
                                    EMB_CPU_ATOL):
                    fail("embed %s: the card's sparse steps depart from "
                         "the CPU's" % label)
                res[sparse]["cpu_rtol"] = err
                del cpu_mod
        mods[sparse] = mod
        del early, got
    times = {True: [], False: []}
    for _ in range(EMB_WINDOWS):
        for sparse in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(EMB_WINDOW_STEPS):
                train_step(mods[sparse], host[i % EMB_BATCHES])
            torch.cuda.synchronize()
            times[sparse].append((time.perf_counter() - t0) * 1e3
                                 / EMB_WINDOW_STEPS)
    for sparse in (True, False):
        res[sparse]["step_ms"] = min(times[sparse])
        if mods[sparse]._fused.stats.captures != 1:
            fail("embed %s recaptured" % label)
    print("embed %s: step sparse %.3f ms, dense (MXNET_EMBED_SPARSE=0) "
          "%.3f ms: x%.3f; windows sparse %s dense %s; peak memory over "
          "the eager steps above the memory before the module, sparse "
          "%.3f GiB, dense %.3f GiB; one capture each; card %s" % (
              label, res[True]["step_ms"], res[False]["step_ms"],
              res[False]["step_ms"] / res[True]["step_ms"],
              [round(v, 4) for v in times[True]],
              [round(v, 4) for v in times[False]], res[True]["peak"] / 2**30,
              res[False]["peak"] / 2**30, smi))
    del mods, table, table_nd, arg0
    gc.collect()
    torch.cuda.empty_cache()
    return res


def rec_reference(params, ids):
    """The rec tower in float64 with numpy, a padded (out-of-range) id
    reading a zero row as ``_sparse_embedding`` does; -> probabilities."""
    table = params["embed_weight"].astype(np.float64)
    ok = (ids >= 0) & (ids < table.shape[0])
    x = np.where(ok[..., None], table[np.where(ok, ids, 0)], 0.0)
    x = x.reshape(ids.shape[0], -1)
    h = np.maximum(x @ params["rfc1_weight"].T.astype(np.float64)
                   + params["rfc1_bias"], 0.0)
    o = h @ params["rfc2_weight"].T.astype(np.float64) + params["rfc2_bias"]
    o = np.exp(o - o.max(axis=1, keepdims=True))
    return o / o.sum(axis=1, keepdims=True)


def rec_serve_leg(torch, mt, ck, smi):
    """(d) bench_embed.py's serve leg through ServeEngine(embed_dedup=
    True): every answer against the tower in numpy (padded ids reading
    zero rows), the unpadded ones against a serial batch-1 Predictor too,
    fused_fc_epilogue launched once a batch, 0 dropped, requests/s,
    p50/p99."""
    rng = np.random.default_rng(60)
    net = rec_symbol(mt, REC_VOCAB, REC_DIM, REC_HIDDEN, REC_CLASSES)
    params = {
        "embed_weight": (rng.standard_normal((REC_VOCAB, REC_DIM)) * 0.1
                         ).astype(np.float32),
        "rfc1_weight": (rng.standard_normal((REC_HIDDEN, REC_L * REC_DIM))
                        * 0.05).astype(np.float32),
        "rfc1_bias": np.zeros(REC_HIDDEN, np.float32),
        "rfc2_weight": (rng.standard_normal((REC_CLASSES, REC_HIDDEN))
                        * 0.1).astype(np.float32),
        "rfc2_bias": np.zeros(REC_CLASSES, np.float32)}
    n = REC_THREADS * REC_REQS
    reqs = hot_ids(rng, n * REC_L, EMB_HOT, REC_VOCAB).reshape(n, REC_L)
    reqs[::7, -3:] = -1                     # padded id lists
    padded = (reqs < 0).any(axis=1)
    tdict = {"ids": np.int32}
    eng = mt.serve.ServeEngine(net, dict(params),
                               {"ids": (REC_THREADS, REC_L),
                                "softmax_label": (REC_THREADS,)},
                               type_dict=dict(tdict), embed_dedup=True,
                               max_delay_ms=2.0, deadline_ms=30000.0,
                               name="rec-serve")
    try:
        eng.predict(reqs[0], timeout=600)          # warm
        # the serial batch-1 Predictor reads NaN at a padded id (the
        # plain Embedding's lookup), so it answers the unpadded ones
        pred = mt.Predictor(net.tojson(), dict(params),
                            {"ids": (1, REC_L), "softmax_label": (1,)},
                            type_dict=dict(tdict))
        serial = {}
        for i in np.nonzero(~padded)[0]:
            pred.set_input("ids", reqs[i:i + 1])
            pred.forward()
            serial[i] = np.array(pred.get_output(0)[0])
        ck.reset_launches()
        b0 = eng.stats.report()["batches"]
        got, wall, errors = flood(lambda i: eng.submit(reqs[i]), n,
                                  REC_THREADS, wave=1)
        rep = eng.stats.report()
        batches = rep["batches"] - b0
        launches = ck.LAUNCHES.get("fused_fc_epilogue", 0)
    finally:
        eng.close()
    if errors:
        fail("rec serving errors: %s" % errors)
    ref = rec_reference(params, reqs)

    def rtol_at_atol(a, b):
        return float(np.max((np.abs(a - b) - REC_ATOL)
                            / np.maximum(np.abs(b), 1e-30)))
    worst = {"padded": 0.0, "unpadded": 0.0, "serial": 0.0}
    for i in range(n):
        kind = "padded" if padded[i] else "unpadded"
        worst[kind] = max(worst[kind], rtol_at_atol(got[i], ref[i]))
        if not np.allclose(got[i], ref[i], rtol=REC_RTOL, atol=REC_ATOL):
            fail("rec serving: %s answer %d differs from the tower in "
                 "numpy" % (kind, i))
        if i in serial:
            worst["serial"] = max(worst["serial"],
                                  rtol_at_atol(got[i], serial[i]))
            if not np.allclose(got[i], serial[i], rtol=REC_RTOL,
                               atol=REC_ATOL):
                fail("rec serving: answer %d differs from serial predict"
                     % i)
    dropped = rep["overloaded"] + rep["expired"] + rep["failed"] + \
        rep["cancelled"]
    passes = [p.name for p in eng.pipeline.passes]
    print("rec serve: %d x %d table, %d ids a request, tower %d -> %d, "
          "ServeEngine(embed_dedup=True) passes %s; %d requests (%d padded) "
          "from %d threads in %.3f s = %.1f requests/s, p50 %.3f ms, p99 "
          "%.3f ms; %d batches, fused_fc_epilogue launches %d (want one a "
          "batch); dropped %d; smallest rtol at atol %g (gate %g): padded "
          "answers vs the tower in numpy with zero rows %.3g, unpadded "
          "%.3g, unpadded vs a serial batch-1 Predictor %.3g; card %s" % (
              REC_VOCAB, REC_DIM, REC_L, REC_HIDDEN, REC_CLASSES, passes, n,
              int(padded.sum()), REC_THREADS, wall, n / wall,
              rep["latency_p50_ms"], rep["latency_p99_ms"], batches,
              launches, dropped, REC_ATOL, REC_RTOL, worst["padded"],
              worst["unpadded"], worst["serial"], smi))
    if "sparse_embed" not in passes or "fuse_epilogue" not in passes:
        fail("rec serving pipeline lacks a pass: %s" % passes)
    if launches != batches:
        fail("fused_fc_epilogue launched %d times for %d batches"
             % (launches, batches))
    if dropped:
        fail("rec serving dropped %d requests" % dropped)
    return {"rps": n / wall, "p50": rep["latency_p50_ms"],
            "p99": rep["latency_p99_ms"], "launches": launches,
            "batches": batches}


def kv_embed_leg(torch, mt, smi):
    """(e) kvstore device_embed with a sparse key: row_sparse_pull, then
    pushes through the optimizer's lazy update, against the CPU store."""
    rng = np.random.default_rng(70)
    W = (rng.standard_normal((KV_VOCAB, KV_DIM)) * 0.05).astype(np.float32)
    ids = hot_ids(rng, KV_IDS, EMB_HOT, KV_VOCAB)
    ids[::11] = -1
    grads = [rng.standard_normal((KV_IDS, KV_DIM)).astype(np.float32)
             for _ in range(2)]
    out = {}
    for name, c in (("card", mt.gpu(0)), ("cpu", mt.cpu())):
        kv = mt.kv.create("device_embed", ctx=c)
        kv.init("emb", mt.nd.array(W, ctx=mt.cpu()), sparse=True)
        pulled = mt.nd.zeros((KV_IDS, KV_DIM), ctx=mt.cpu())
        kv.row_sparse_pull("emb", out=pulled, row_ids=ids)
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.1, momentum=0.9))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g in grads:
            kv.push("emb", (ids, g))
        torch.cuda.synchronize()
        push_ms = (time.perf_counter() - t0) * 1e3 / len(grads)
        full = kv.table("emb").as_numpy()
        out[name] = (pulled.asnumpy(), full, push_ms,
                     kv.table("emb").device)
    (p_g, f_g, ms_g, dev_g), (p_c, f_c, _, _) = out["card"], out["cpu"]
    named = np.unique(ids[ids >= 0])
    untouched = np.setdiff1d(np.arange(KV_VOCAB), named)
    pull_same = np.array_equal(p_g, p_c)
    close = np.allclose(f_g, f_c, rtol=KV_RTOL, atol=KV_ATOL)
    frozen = np.array_equal(f_g[untouched], W[untouched])
    print("kv device_embed: %d x %d sparse key on %s; row_sparse_pull of "
          "%d ids (pads included) equal to the CPU store's %s; 2 pushes "
          "with SGD momentum 0.9 (lazy rows) %.3f ms each; table against "
          "the CPU store allclose rtol %g atol %g: %s; untouched rows "
          "bitwise %s; card %s" % (KV_VOCAB, KV_DIM, dev_g, KV_IDS,
                                   pull_same, ms_g, KV_RTOL, KV_ATOL, close,
                                   frozen, smi))
    if dev_g.type != "cuda":
        fail("device_embed on gpu(0) keeps its table on %s" % dev_g)
    if not (pull_same and close and frozen):
        fail("device_embed on the card differs from the CPU store")
    return {"push_ms": ms_g}


def moe_embed_phase(torch, mt, ck, smi):
    """Phase 19: (a) MoE training, (b) routed decode, (c) sparse
    embedding training, (d) rec serving, (e) kvstore device_embed."""
    print("phase 19: routed MoE and the sparse embedding engine; TF32 "
          "matmul=%s cudnn=%s; card %s" % (
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32, smi))
    t0 = time.perf_counter()
    ck.reset_launches()
    moe = moe_train_leg(torch, mt, smi)
    dec = moe_decode_leg(torch, mt, smi)
    emb = {label: embed_table_leg(torch, mt, smi, label, vocab, dim,
                                  cpu_check=i == 0)
           for i, (label, vocab, dim) in enumerate(EMB_TABLES)}
    kv = kv_embed_leg(torch, mt, smi)
    launches = dict(ck.LAUNCHES)
    print("phase 19: hand-kernel launches on (a), (b), (c), (e): %s"
          % launches)
    if any(launches.values()):
        fail("the MoE and embedding paths launched hand kernels: %s"
             % launches)
    rec = rec_serve_leg(torch, mt, ck, smi)
    print("moe and embed result (card %s): %s; phase %.1f s" % (
        smi, json.dumps({
            "moe-step_ms": moe["moe_ms"], "dense-step_ms": moe["dense_ms"],
            "moe-imbalance": moe["imbalance"],
            "moe-decode-tokens_s": dec["tokens_s"],
            **{"embed-%s-sparse-step_ms" % k: v[True]["step_ms"]
               for k, v in emb.items()},
            **{"embed-%s-dense-step_ms" % k: v[False]["step_ms"]
               for k, v in emb.items()},
            "rec-serve-rps": rec["rps"], "rec-serve-p99_ms": rec["p99"],
            "kv-push_ms": kv["push_ms"]}), time.perf_counter() - t0))
    return {"moe": moe, "decode": dec, "embed": emb, "rec": rec, "kv": kv}


# ---------------------------------------------------------------------------
# phase 20: the input pipeline on the card
#
# (a) ResNet-50 from a .rec through Module.fit: 1,280 raw CHW-packed
# uint8 records at 3x256x256 (im2rec --resize 256's envelope), written
# at run time from a numpy seed by the port's recordio (252 MB in a
# temporary directory); record_pipeline(batch 128, 3x224x224, resize
# 256, random crop and mirror, ImageNet's mean, device_augment=True) ->
# fit(prefetch_to_device=True) with phase 13's optimizer, 3 epochs of 10
# batches (the second timed, the third profiled); (b) a mid-epoch resume
# through the feed cursor, under deterministic cuDNN as phase 18's resume
# leg, with 4 reader processes forked after the card's context is up;
# (c) phase 18's superstep leg (PTB LSTM, batch 32, K=8) with megabatch
# prefetch; (d) bench_embed.py's step leg from padded ids through
# ids_pipeline.
FEED_RECORDS, FEED_SIDE, FEED_CROP = 1280, 256, 224
FEED_MEAN = (123.68, 116.78, 103.94)       # ImageNet's RGB mean
FEED_EPOCHS = 3
FEED_RESUME_EVERY, FEED_PROCS = 4, 4
IDS_BATCHES, IDS_EPOCHS, IDS_PAD_SHARE = 4, 3, 0.1
SUPER_REPEAT = 4                           # (c)'s longer epochs
SPEC_STEPS, SPEC_AT = 6, (1, 4)            # speculation: steps, where


class ProfileWindow:
    """torch.profiler (device activity) over a window opened and closed
    from callbacks, and the wall of that same window (both ends
    synchronized): the device ms of its kernels, of its copies (memcpy/
    memset, which on the feed's copy stream overlap the kernels), and its
    busy share: the union of the intervals in which the card ran either,
    over the window's wall.  Every busy share of phase 20 that comes from
    a window is this one, copies included."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        from torch.autograd import DeviceType
        self.torch.cuda.synchronize()
        self.wall = (time.perf_counter() - self.t0) * 1e3
        self.prof.__exit__(None, None, None)
        self.device, self.copies, spans = 0.0, 0.0, []
        for e in self.prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            t = e.time_range.elapsed_us() / 1e3
            if e.name.lower().startswith(("memcpy", "memset")):
                self.copies += t
            else:
                self.device += t
        busy, end = 0.0, None
        for a, b in sorted(spans):
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        self.busy = busy / 1e3 / self.wall
        self.prof = None
        return self.device


def write_feed_rec(mt, path, n=FEED_RECORDS, side=FEED_SIDE, seed=70):
    """``n`` raw CHW-packed uint8 records of 3 x side x side, labels in
    [0, 1000), from a numpy seed; -> the labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 1000, n)
    w = mt.recordio.MXRecordIO(path, "w")
    for i in range(n):
        img = rng.integers(0, 256, (3, side, side), dtype=np.uint8)
        w.write(mt.recordio.pack(mt.recordio.IRHeader(
            0, float(labels[i]), i, 0), img.tobytes()))
    w.close()
    return labels


def resnet_feed(mt, rec, **kw):
    args = dict(batch_size=RESNET_BATCH,
                data_shape=(3, FEED_CROP, FEED_CROP), resize=FEED_SIDE,
                rand_crop=True, rand_mirror=True, mean_rgb=FEED_MEAN,
                device_augment=True, max_epochs=FEED_EPOCHS)
    args.update(kw)
    return mt.feed.record_pipeline(rec, **args)


def feed_stalls(report):
    """{pipeline/stage: (stall_in_s, stall_out_s)} of a feed_report()."""
    return {"%s/%s" % (key.split("#")[0], stage): (
        round(row["stall_in_s"], 3), round(row["stall_out_s"], 3))
        for key, stages in report.items() for stage, row in stages.items()}


def feed_resnet_leg(torch, mt, smi, rec, res, fit13_img_s):
    """(a) ResNet-50 trained from the .rec through fit(prefetch_to_device
    =True) on the uint8 wire; the gates: the first batch's augmented
    input (read back from the card) bitwise augment_batch_host of the
    same uint8 batch with the same draws, one capture and a replay for
    every batch after the warm-up."""
    sym, arg0, aux0 = res
    gpu = mt.gpu(0)
    it = resnet_feed(mt, rec)
    spec = it.augment_spec
    mod = mt.mod.Module(sym, context=gpu)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=arg0, aux_params=aux0)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(TRAIN_OPT))
    fused = mod._fused
    fused.augment_probe = []
    n = FEED_RECORDS // RESNET_BATCH
    marks, probe, window, report = [], [], ProfileWindow(torch), {}

    def cb(p):
        if p.epoch == 0 and p.nbatch == 0:
            probe.append(fused.augment_probe[0])
            fused.augment_probe = None
        if p.epoch == 1 and p.nbatch in (0, n - 1):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        if p.epoch == 2 and p.nbatch == 0:
            window.start()
        if p.epoch == 2 and p.nbatch == n - 1:
            window.stop()
            report.update(mt.profiler.feed_report())
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=FEED_EPOCHS, optimizer="sgd",
            optimizer_params=dict(TRAIN_OPT), eval_metric="acc",
            batch_end_callback=cb, prefetch_to_device=True)
    fit_s = time.perf_counter() - t0
    stats = fused.stats.report()
    x, draws, out = probe[0]
    want = mt.feed.augment_batch_host(x.cpu().numpy(),
                                      tuple(d.cpu() for d in draws), spec,
                                      True)
    got = out.detach().cpu().numpy()
    first = np.frombuffer(open(rec, "rb").read(8 + 24 + 3 * FEED_SIDE ** 2)
                          [8 + 24:], np.uint8).reshape(
                              3, FEED_SIDE, FEED_SIDE).transpose(1, 2, 0)
    same_input = bool(np.array_equal(x[0].cpu().numpy(), first))
    same_aug = bool(np.array_equal(got, want))
    flips = int(draws[2].sum())
    h2d = it.pipeline.stats.report()["h2d"]
    # the data's bytes: the batch's less its float32 labels
    bytes_per_batch = h2d["bytes"] * RESNET_BATCH // h2d["items"] \
        - RESNET_BATCH * 4
    f32_bytes = RESNET_BATCH * 3 * FEED_CROP ** 2 * 4
    img_s = RESNET_BATCH * (n - 1) / (marks[1] - marks[0])
    wall = (marks[1] - marks[0]) * 1e3
    print("feed: resnet50 from %d raw 3x%dx%d records through "
          "record_pipeline(device_augment=True) + fit(prefetch_to_device="
          "True), %d epochs of %d batches in %.1f s: fused step %s; first "
          "batch's uint8 input equal to record 0 %s, augmented input read "
          "back from the card bitwise augment_batch_host with the same "
          "draws %s (gate; %d of %d flipped, crops dy %d..%d)"
          % (FEED_RECORDS, FEED_SIDE, FEED_SIDE, FEED_EPOCHS, n, fit_s,
             stats, same_input, same_aug, flips, RESNET_BATCH,
             int(draws[0].min()), int(draws[0].max())))
    print("feed: resnet50 fit from the .rec %.1f img/s (epoch 2's last %d "
          "batches, %.3f ms) against phase 13's fit over host float32 "
          "batches %.1f img/s (x%.3f); the same batches of epoch 3 under "
          "the profiler: %.3f ms of wall, kernels %.3f ms and copies %.3f "
          "ms of device time, busy share %.3f (the card's busy union over "
          "that wall); host-to-device data bytes per batch %d uint8 (the "
          "256x256 envelope) against %d float32 (x%.3f); card %s"
          % (img_s, n - 1, wall, fit13_img_s, img_s / fit13_img_s,
             window.wall, window.device, window.copies, window.busy,
             bytes_per_batch, f32_bytes, f32_bytes / bytes_per_batch, smi))
    stalls = feed_stalls(report)
    print("feed: feed_report() stall_in/stall_out s per stage at the end "
          "of epoch 3: %s" % json.dumps(stalls))
    want_stats = {"captures": 1, "replays": FEED_EPOCHS * n - RESNET_WARMUP,
                  "eager_steps": RESNET_WARMUP}
    if not (same_input and same_aug):
        fail("the augmented batch on the card differs from "
             "augment_batch_host")
    if stats != want_stats:
        fail("resnet50 from the feed: fused step %s, want %s"
             % (stats, want_stats))
    it.close()
    del mod, fused, probe, x, out
    gc.collect()
    torch.cuda.empty_cache()
    return {"img_s": img_s, "busy": window.busy, "wall_ms": wall,
            "device_ms": window.device, "bytes": bytes_per_batch,
            "f32_bytes": f32_bytes, "stalls": stalls, "stats": stats}


def feed_speculation_leg(torch, mt, smi, rec, res):
    """(a) continued: speculation on the uint8 wire.  SPEC_STEPS of (a)'s
    batches through forward/update under deterministic cuDNN, once
    straight and once with, at the steps SPEC_AT (an eager warm-up step
    and a replay), the outputs read before update() (the step runs
    early), then a new forward of the same batch (the early step is
    discarded and the state from before it put back, the generator's
    included) and the step again.  The gate: the eager steps' augmented
    inputs and the params, aux and momentum after the last step bitwise
    the straight run's, so the step run again drew the discarded step's
    numbers."""
    sym, arg0, aux0 = res
    it = resnet_feed(mt, rec, max_epochs=1)
    spec, shapes = it.augment_spec, (it.provide_data, it.provide_label)
    batches = [it.next() for _ in range(SPEC_STEPS)]
    it.close()

    def run(speculate):
        mt.random.seed(9)
        mod = mt.mod.Module(sym, context=mt.gpu(0))
        mod.bind(*shapes)
        mod.init_params(arg_params=arg0, aux_params=aux0)
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(TRAIN_OPT))
        mod.apply_augment_spec(spec)
        fused = mod._fused
        fused.augment_probe = []
        early, steps = 0, []

        def probed(i):
            # the step index of each augmented input an eager step probed
            steps.extend([i] * (len(fused.augment_probe) - len(steps)))
        for i, b in enumerate(batches):
            mod.forward(b, is_train=True)
            if speculate and i in SPEC_AT:
                mod.get_outputs()                 # the step runs early
                early += mod._fused_next is not None
                probed(i)
                mod.forward(b, is_train=True)     # ... and is discarded
            mod.update()
            probed(i)
        torch.cuda.synchronize()
        out = {"params": host_params(mod), "opt": opt_leaves(torch,
                                                             fused.state),
               "probe": [(i, o.cpu().numpy()) for i, (_, _, o) in
                         zip(steps, fused.augment_probe)],
               "stats": fused.stats.report(), "early": early}
        del mod, fused
        gc.collect()
        torch.cuda.empty_cache()
        return out

    torch.backends.cudnn.deterministic = True
    try:
        want, got = run(False), run(True)
    finally:
        torch.backends.cudnn.deterministic = False
    # each eager step's augmented input against the straight run's of
    # that step; an early step of the warm-up is probed twice (the
    # discarded run and the run again), and the two warm-up runs it takes
    # bring the capture a step forward
    want_probe = dict(want["probe"])
    twice = [i for i in SPEC_AT
             if [j for j, _ in got["probe"]].count(i) == 2]
    same_probe = bool(twice) and all(
        i in want_probe and np.array_equal(o, want_probe[i])
        for i, o in got["probe"])
    same = bitwise(want["params"][0], got["params"][0]) and bitwise(
        want["params"][1], got["params"][1]) and bitwise(want["opt"],
                                                         got["opt"])
    print("feed: speculation on the uint8 wire, resnet50 batch %d, %d "
          "steps: %d early steps (outputs read before update at steps %s) "
          "discarded by a new forward and run again; fused step %s against "
          "the straight run's %s; the augmented inputs of eager steps %s "
          "(steps %s probed twice) bitwise the straight run's %s "
          "and params, aux and momentum bitwise %s (gates; cuDNN "
          "deterministic); card %s"
          % (RESNET_BATCH, SPEC_STEPS, got["early"], list(SPEC_AT),
             got["stats"], want["stats"], [i for i, _ in got["probe"]],
             twice, same_probe,
             same, smi))
    if got["early"] != len(SPEC_AT):
        fail("speculation: %d early steps ran, want %d"
             % (got["early"], len(SPEC_AT)))
    if not (same_probe and same):
        fail("a discarded early step drew other numbers when run again")
    return {"early": got["early"], "stats": got["stats"]}


def feed_resume_leg(torch, mt, smi, rec, res, train_img_s):
    """(b) fit over the 4-process reader, saving every 4 batches; a fresh
    module and pipeline resumed from step 4 train the remaining batches
    with their labels and end on params bitwise the uninterrupted run's.
    Then the same reader drained alone: feed img/s and headroom."""
    import shutil
    sym, arg0, aux0 = res
    n = FEED_RECORDS // RESNET_BATCH
    tmp = tempfile.mkdtemp()
    full, part = os.path.join(tmp, "full"), os.path.join(tmp, "part")

    def run(store, resume):
        it = resnet_feed(mt, rec, reader_procs=FEED_PROCS, max_epochs=1)
        mod = mt.mod.Module(sym, context=mt.gpu(0))
        seen = []
        with mt.checkpoint.CheckpointManager(store, keep_last_n=None) as mgr:
            mod.fit(it, num_epoch=1, optimizer="sgd",
                    optimizer_params=dict(TRAIN_OPT), arg_params=arg0,
                    aux_params=aux0, checkpoint=mgr,
                    checkpoint_every=FEED_RESUME_EVERY, resume=resume,
                    prefetch_to_device=True,
                    batch_end_callback=lambda p: seen.append(
                        p.locals["data_batch"].label[0].asnumpy()))
        report = it.pipeline.stats.report()
        it.close()
        out = host_params(mod), opt_leaves(torch, mod._fused.state)
        del mod
        gc.collect()
        torch.cuda.empty_cache()
        return seen, out, report

    torch.backends.cudnn.deterministic = True
    try:
        want_seen, (want_p, want_m), report = run(full, False)
        shutil.copytree(full, part)
        for s in mt.checkpoint.all_steps(part):
            if s > FEED_RESUME_EVERY:
                shutil.rmtree(os.path.join(part,
                                           mt.checkpoint.step_dir_name(s)))
        with mt.checkpoint.CheckpointManager(part) as mgr:
            cursor = mgr.restore(step=FEED_RESUME_EVERY)[1].get("feed")
        got_seen, (got_p, got_m), _ = run(part, True)
    finally:
        torch.backends.cudnn.deterministic = False
    same_labels = len(got_seen) == n - FEED_RESUME_EVERY and all(
        np.array_equal(a, b) for a, b in zip(got_seen,
                                             want_seen[FEED_RESUME_EVERY:]))
    same = bitwise(want_p[0], got_p[0]) and bitwise(want_p[1], got_p[1]) \
        and bitwise(want_m, got_m)
    reader = report["reader"]
    workers = reader.get("workers", {})
    decode_img_s = sum(w["items"] / w["busy_s"] for w in workers.values()
                       if w["busy_s"] > 0)
    inner = cursor.get("inner", {})
    print("feed: resume: %d reader processes, saved at step %d with cursor "
          "batch %s (inner: epoch %s, batch %s, samples %s, reader workers "
          "%s); the resumed run trained %d batches with the uninterrupted "
          "run's labels %s and ends on its params, aux and momentum bitwise "
          "%s (gate; cuDNN deterministic)"
          % (FEED_PROCS, FEED_RESUME_EVERY, cursor.get("batch"),
             inner.get("epoch"), inner.get("batch"), inner.get("samples"),
             json.dumps(inner.get("reader", {}).get("workers")),
             len(got_seen), same_labels, same))
    if not (same_labels and same):
        fail("the resume through the feed cursor differs from the "
             "uninterrupted run")
    # the same reader drained onto the card alone: what the feed can give
    it = resnet_feed(mt, rec, reader_procs=FEED_PROCS, max_epochs=2)
    for _ in it:
        pass                      # epoch 1: workers up, caches warm
    it.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = 0
    for b in it:
        got += b.data[0].shape[0]
    torch.cuda.synchronize()
    feed_img_s = got / (time.perf_counter() - t0)
    it.close()
    shutil.rmtree(tmp)
    print("feed: %d reader processes: decode %.1f img/s summed over the "
          "workers (items / busy s: %s), the pipeline drained onto the card "
          "alone %.1f img/s, feed headroom %.3f (feed img/s / (a)'s train "
          "img/s %.1f; bench_io.py's definition); restarts %d; card %s"
          % (FEED_PROCS, decode_img_s, {k: (w["items"], w["busy_s"])
                                        for k, w in workers.items()},
             feed_img_s, feed_img_s / train_img_s, train_img_s,
             reader.get("restarts", 0), smi))
    return {"decode_img_s": decode_img_s, "feed_img_s": feed_img_s,
            "headroom": feed_img_s / train_img_s}


def feed_superstep_leg(torch, mt, smi, sup18):
    """(c) phase 18's superstep leg through fit(prefetch_to_device=True):
    K=8 from prefetch-staged megabatches against K=1, params and momentum
    bitwise; tokens/s of epoch 2, the busy share of epoch 3 (a
    ProfileWindow), one superstep over a staged megabatch
    (device_profile, as phase 18 measures its own); then
    epochs of 64 batches, K=1 and K=8 staged inside each superstep or
    before each drain."""
    arg0 = lstm_params(mt, LSTM_HIDDEN, 30)
    rng = np.random.default_rng(31)
    batches = [token_batch(mt, rng, mt.cpu(), SUPER_BATCH, LSTM_SEQ,
                           LSTM_HIDDEN) for _ in range(SUPER_BATCHES)]
    states = lstm_states(SUPER_BATCH, LSTM_HIDDEN)
    pd = [("data", (SUPER_BATCH, LSTM_SEQ))] + states
    pl = [("softmax_label", (SUPER_BATCH, LSTM_SEQ))]
    sym = mt.models.lstm_unroll(LSTM_LAYERS, LSTM_SEQ, LSTM_VOCAB,
                                LSTM_HIDDEN, LSTM_HIDDEN, LSTM_VOCAB)
    tokens = SUPER_BATCHES * SUPER_BATCH * LSTM_SEQ

    def run(k, prefetch, repeat=1, profiled=True):
        """3 epochs of the batches ``repeat`` times over: epoch 2 timed,
        epoch 3 profiled (the profiler's processing of a 64-batch epoch,
        ~100,000 LSTM kernels, takes tens of seconds: the longer epochs
        are timed only)."""
        mt.random.seed(5)
        mod = mt.mod.Module(sym, data_names=["data"] + [n for n, _ in
                                                        states],
                            label_names=["softmax_label"], context=mt.gpu(0))
        metric = time_major_ce(mt)
        marks, window = [], ProfileWindow(torch)

        def epoch_end(epoch, s, a, x):
            if epoch == 2 and profiled:
                window.stop()
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if epoch == 1 and profiled:
                window.start()
        mod.fit(batch_iter(mt, batches * repeat, pd, pl), num_epoch=3,
                eval_metric=metric, optimizer="sgd",
                optimizer_params=dict(LSTM_OPT), arg_params=arg0,
                aux_params={}, superstep=k, prefetch_to_device=prefetch,
                epoch_end_callback=epoch_end)
        return {"mod": mod, "metric": metric,
                "tokens_s": tokens * repeat / (marks[1] - marks[0]),
                "busy": window.busy if profiled else None,
                "walls": ((marks[1] - marks[0]) * 1e3,
                          window.wall if profiled else None)}

    torch.use_deterministic_algorithms(True)
    try:
        one, sup = run(1, False), run(SUPER_K, True)
    finally:
        torch.use_deterministic_algorithms(False)
    same = bitwise(host_params(one["mod"])[0], host_params(sup["mod"])[0]) \
        and bitwise(opt_leaves(torch, one["mod"]._fused.state),
                    opt_leaves(torch, sup["mod"]._fused.state))
    # the same with epochs of 4 x 16 batches: 8 supersteps an epoch, so
    # the staging of all but the epoch's first megabatch can overlap
    longer = {(k, pf): run(k, pf, repeat=SUPER_REPEAT, profiled=False)
              for k, pf in ((1, False), (SUPER_K, False), (SUPER_K, True))}
    mod, metric = sup["mod"], sup["metric"]
    stats = mod._superstep_stats.report()
    staged = mod.prefetch_to_device(batch_iter(mt, batches, pd, pl),
                                    megabatch=SUPER_K).next()
    wall_k, dev_k, _ = device_profile(
        torch, lambda: mod.superstep_train(staged, metric), reps=3)
    print("feed: superstep K=%d from megabatches staged by fit(prefetch_to_"
          "device=True) against K=1, 3 epochs of %d batches: params and "
          "momentum bitwise %s (gate); superstep counters %s"
          % (SUPER_K, SUPER_BATCHES, same, json.dumps(stats)))
    print("feed: superstep tokens/s (epoch 2) K=1 %.1f, K=%d with prefetch "
          "%.1f (x%.3f); phase 18 in this run: K=1 %.1f, K=%d %.1f; busy "
          "share of epoch 3 (the card's busy union over its wall, copies "
          "included) K=1 %.3f, K=%d with prefetch %.3f (epoch 3's wall under "
          "the profiler %.3f and %.3f ms against epoch 2's %.3f and %.3f "
          "ms: the profiler's cost on the host); one superstep over "
          "a staged megabatch (device_profile: kernels and copies over the "
          "unprofiled wall) %.3f ms wall, %.3f ms device, busy %.3f (phase "
          "18's, staging its host batches inside, the same definition: "
          "%.3f); card %s"
          % (one["tokens_s"], SUPER_K, sup["tokens_s"],
             sup["tokens_s"] / one["tokens_s"], sup18["tokens_s_k1"],
             SUPER_K, sup18["tokens_s_k"], one["busy"], SUPER_K,
             sup["busy"], one["walls"][1], sup["walls"][1],
             one["walls"][0], sup["walls"][0], wall_k, dev_k,
             dev_k / wall_k, sup18["busy_k"],
             smi))
    print("feed: superstep over epochs of %d batches (the 16 repeated): "
          "tokens/s (epoch 2) K=1 %.1f, K=%d staging inside the superstep "
          "%.1f, K=%d with prefetch (staged before each drain) %.1f (x%.3f "
          "of the former, x%.3f of K=1); card %s"
          % (SUPER_BATCHES * SUPER_REPEAT, longer[1, False]["tokens_s"],
             SUPER_K, longer[SUPER_K, False]["tokens_s"], SUPER_K,
             longer[SUPER_K, True]["tokens_s"],
             longer[SUPER_K, True]["tokens_s"]
             / longer[SUPER_K, False]["tokens_s"],
             longer[SUPER_K, True]["tokens_s"] / longer[1, False]["tokens_s"],
             smi))
    if not same:
        fail("superstep K=%d over prefetched megabatches differs from K=1"
             % SUPER_K)
    out = {"tokens_s_k1": one["tokens_s"], "tokens_s_k": sup["tokens_s"],
           "busy_k1": one["busy"], "busy_k": sup["busy"],
           "busy_one_superstep": dev_k / wall_k,
           "long_tokens_s": {"k1": longer[1, False]["tokens_s"],
                             "k_inside": longer[SUPER_K, False]["tokens_s"],
                             "k_prefetch": longer[SUPER_K, True]["tokens_s"]}}
    del one, sup, mod, staged, longer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def feed_ids_leg(torch, mt, smi):
    """(d) bench_embed.py's step leg from padded ids: ids_pipeline +
    fit(prefetch_to_device=True) against the same batches from an
    NDArrayIter, params bitwise; the table's last row and every row no
    batch names bitwise unchanged."""
    vocab, dim = EMB_TABLES[0][1], EMB_TABLES[0][2]
    gpu = mt.gpu(0)
    dev = gpu.torch_device()
    rng = np.random.default_rng(80)
    n = IDS_BATCHES * EMB_B
    ids = hot_ids(rng, n * EMB_L, EMB_HOT, vocab - 1).reshape(n, EMB_L)
    short = np.flatnonzero(rng.random(n) < IDS_PAD_SHARE)
    for r, keep in zip(short, rng.integers(1, EMB_L, len(short))):
        ids[r, keep:] = mt.feed.PAD_ID
    y = (np.where(ids >= 0, ids, 0).sum(axis=1) % 2).astype(np.float32)
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "ids.rec")
    mt.feed.write_ids_record(path, [(y[r], ids[r][ids[r] >= 0])
                                    for r in range(n)])
    sym = rec_symbol(mt, vocab, dim, EMB_HIDDEN, 2, unique_cap=EMB_CAP)
    tower = fan_in_params(rec_symbol(mt, 16, dim, EMB_HIDDEN, 2),
                          {"ids": (EMB_B, EMB_L), "softmax_label": (EMB_B,)},
                          81)
    tower.pop("embed_weight")
    gen = torch.Generator(device=dev)
    gen.manual_seed(82)
    table = (torch.rand((vocab, dim), generator=gen, device=dev) * 2 - 1) \
        * 0.05
    res = {}
    for tag in ("feed", "host"):
        if tag == "feed":
            it = mt.feed.ids_pipeline(path, batch_size=EMB_B, max_len=EMB_L,
                                      max_epochs=IDS_EPOCHS, data_name="ids")
        else:
            it = mt.io.NDArrayIter({"ids": ids}, y, batch_size=EMB_B)
        mod = mt.mod.Module(sym, data_names=("ids",), context=gpu)
        marks = []

        def cb(p):
            if p.epoch == IDS_EPOCHS - 1 and p.nbatch in (0, IDS_BATCHES - 1):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
        mod.fit(it, num_epoch=IDS_EPOCHS, optimizer="sgd",
                optimizer_params=dict(EMB_OPT), prefetch_to_device=tag ==
                "feed", arg_params=dict({k: mt.nd.array(v, ctx=mt.cpu())
                                         for k, v in tower.items()},
                                        embed_weight=mt.nd.NDArray(table)),
                batch_end_callback=cb)
        if tag == "feed":
            it.close()
        res[tag] = {"params": host_params(mod)[0],
                    "stats": mod._fused.stats.report(),
                    "step_ms": (marks[1] - marks[0]) * 1e3
                    / (IDS_BATCHES - 1),
                    "sparse": bool(mod._fused.sparse_embeds)}
        del mod
        gc.collect()
    named = np.zeros(vocab, bool)
    named[np.unique(ids[ids >= 0])] = True
    w = res["feed"]["params"]["embed_weight"]
    t0 = table.cpu().numpy()
    frozen = bool(np.array_equal(w[~named], t0[~named]))
    last = bool(np.array_equal(w[vocab - 1], t0[vocab - 1]))
    same = bitwise(res["feed"]["params"], res["host"]["params"])
    print("feed: ids %d x %d, %d batches of %d x %d from %d hot ids, %d "
          "rows padded with PAD_ID (%d ids), through ids_pipeline + "
          "fit(prefetch_to_device=True) against an NDArrayIter: params "
          "bitwise %s, the last row bitwise %s and %d unnamed rows bitwise "
          "%s (gates); lazy update %s; fused step %s; fit's wall a batch "
          "(epoch %d) %.3f ms from the feed, %.3f ms from the NDArrayIter; "
          "card %s"
          % (vocab, dim, IDS_BATCHES, EMB_B, EMB_L, EMB_HOT, len(short),
             int((ids < 0).sum()), same, last, int((~named).sum()), frozen,
             res["feed"]["sparse"], res["feed"]["stats"], IDS_EPOCHS,
             res["feed"]["step_ms"], res["host"]["step_ms"], smi))
    import shutil
    shutil.rmtree(tmp)
    if not (same and last and frozen and res["feed"]["sparse"]):
        fail("padded ids through the feed differ from the host batches "
             "(or touched rows no batch names)")
    del table
    torch.cuda.empty_cache()
    return {"step_ms": res["feed"]["step_ms"],
            "host_step_ms": res["host"]["step_ms"]}


def feed_phase(torch, mt, ck, smi, fit13_img_s, sup18):
    print("phase 20: the input pipeline; TF32 matmul=%s cudnn=%s; card %s"
          % (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, smi))
    t0 = time.perf_counter()
    ck.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "imagenet-raw256.rec")
        t1 = time.perf_counter()
        write_feed_rec(mt, rec)
        print("feed: wrote %d records (%d bytes) with the port's recordio "
              "in %.1f s" % (FEED_RECORDS, os.path.getsize(rec),
                             time.perf_counter() - t1))
        sym, arg0, aux0, _, _, _ = resnet_setup(mt, 0, 70)
        res = (sym, arg0, aux0)
        a = feed_resnet_leg(torch, mt, smi, rec, res, fit13_img_s)
        a["speculation"] = feed_speculation_leg(torch, mt, smi, rec, res)
        b = feed_resume_leg(torch, mt, smi, rec, res, a["img_s"])
    c = feed_superstep_leg(torch, mt, smi, sup18)
    d = feed_ids_leg(torch, mt, smi)
    launches = dict(ck.LAUNCHES)
    print("phase 20: hand-kernel launches on (a)-(d): %s; phase %.1f s"
          % (launches, time.perf_counter() - t0))
    if any(launches.values()):
        fail("the input pipeline's paths launched hand kernels: %s"
             % launches)
    return {"resnet": a, "resume": b, "superstep": c, "ids": d}


# ---------------------------------------------------------------------------
# phase 21: scale-out on the card (ROADMAP queue 1 item 10's first part)
#
# (a) one rank, an NCCL world of 1 on gpu(0): Module.fit(mesh=
# make_mesh("dp=1")) and DPTrainStep on ResNet-50 at batch 128 (bench.py's
# SGD, lr 0.05, momentum 0.9) over SCALE_STEPS seeded batches, against
# Module.fit without a mesh (phase 13's fused step) on the same batches
# under deterministic cuDNN; the captured step's NCCL all-reduce profiled
# in a replay.  (b)-(d) two ranks sharing gpu(0) (gloo by the backend
# rule: NCCL refuses two ranks on one card), started as tools/launch.py's
# workers are (dist.spawn: the launcher's envs): (b) Module.fit(kvstore=
# "dist_sync") (64 rows a rank) and fit(mesh=make_mesh("dp=2")) (each
# rank fed the 128-row batch) on the same batches against (a)'s one-rank
# run; (c) ring and Ulysses attention at sp=2 at GPT-2-small's attention
# geometry (H 12, D 64, float32), B 1, T 16,384, causal and not, each
# rank's output shard against the flash kernel over the whole sequence,
# and the gradient at T 2,048 against attention_reference's autograd;
# (d) GPipeTrainStep at pp=2 over two GPT-2-small MLP stages (768 ->
# 3072 -> 768, tanh), M = 8 microbatches of 8 x 1,024 tokens, outputs and
# gradients against the two stages run in sequence on one rank.  (e)
# dist_async through tools/launch.py -n 2 -s 1: the nightly MLP on the
# card through the parameter server, then one init/push/pull round of
# ResNet-50's 25.5 M parameters.

SCALE_STEPS = 4
# (b): 2 ranks of 64 rows against 1 rank of 128 differ in arithmetic
# only: cuDNN picks algorithms per batch size, BatchNorm's global
# statistics and the gradients are summed from two halves, and cuDNN's
# default weight gradients use atomics.  The relus and max-pool ties
# after BatchNorm carry such noise on, and ResNet-50 at init with lr
# 0.05 amplifies it from the first step: after 4 steps the data nudged
# by one ulp (np.nextafter, the JAX package's own drift rule for
# BatchNorm nets, tests/test_torch_zoo.py) moves the params as far as
# the 4 steps' update itself, so the 4-step params and moving
# statistics are printed as readings, not held to a gate.  The gates
# are (b)'s first step: its update (params after one step less the
# initial ones) and its moving statistics' change against (a)'s first
# step, relative L2, each at most SCALE_RATIO times the one-ulp nudge's
# first-step difference; the two ranks' params and moving statistics
# equal after 4 steps; and the two routes of (b) over the same rows,
# dist_sync (each rank fed its 64 rows) and fit(mesh=dp=2) (each rank
# fed the 128 and keeping its 64), under deterministic cuDNN, bitwise.
# What planted faults read against these gates is in PERF.md.
SCALE_RATIO = 10.0
RING_T, RING_GRAD_T, ATTN_H, ATTN_D = 16384, 2048, 12, 64
# the gradient through ring/Ulysses against attention_reference's, both
# float32 einsums: relative to the largest gradient element
ATTN_GRAD_RTOL = 1e-4
PIPE_M, PIPE_ROWS, PIPE_WIDTH, PIPE_HIDDEN = 8, 8 * 1024, 768, 3072
# pipeline against the sequence of stages: the same float32 products,
# cuBLAS may tile 8,192-row and 65,536-row GEMMs differently; relative to
# the largest element
PIPE_RTOL = 1e-4
ASYNC_ACC = 0.90      # tests/nightly/dist_async_mlp.py's bound


def first_step_l2(got, want, init):
    """Relative L2 of one step's change: (got - init) against (want -
    init), over every tensor of the dicts."""
    return rel_l2([{k: got[k] - init[k] for k in init}],
                  [{k: want[k] - init[k] for k in init}])


def fit_readings(ranks, name, one, one_first, init):
    """(b)'s route ``name`` against (a)'s one-rank run: the first step's
    update and moving-statistics change (relative L2, and the three
    tensors of the update furthest off), the params and moving
    statistics after the last step, and whether the two ranks agree."""
    r0 = ranks[0][name]
    first = [first_step_l2(r0["first"][i], one_first[i], init[i])
             for i in (0, 1)]
    worst = sorted((first_step_l2({k: r0["first"][0][k]},
                                  {k: one_first[0][k]}, {k: init[0][k]}), k)
                   for k in init[0]
                   if np.any(one_first[0][k] != init[0][k]))[-3:]
    steps = [rel_l2([r0["params"][i]], [one[i]]) for i in (0, 1)]
    same = ranks[0][name]["digest"] == ranks[1][name]["digest"]
    return {"first": first, "worst": worst, "steps": steps, "same": same}


def param_digest(params):
    return {k: float(np.abs(v.astype(np.float64)).sum())
            for d in params for k, v in d.items()}


def scaleout_one_rank(torch, mt, ck, smi, res, r13):
    """(a): -> the 4-step params of fit(mesh=dp=1) (host arg, aux)."""
    from mxnet_tpu_torch.dist import boot
    from mxnet_tpu_torch.module.fused import WARMUP_STEPS
    from mxnet_tpu_torch.parallel import collectives as C
    sym, arg0, aux0, batches, pd, pl = res
    b = RESNET_BATCH
    mesh = mt.parallel.make_mesh("dp=1")
    mesh.axis("dp")
    print("scaleout: (a) %s" % boot.describe())
    if boot.backend() != "nccl":
        fail("one rank with a card of its own must take NCCL")
    ck.reset_launches()
    torch.backends.cudnn.deterministic = True
    try:
        first = []

        def fit(m, feed=batches):
            mod = mt.mod.Module(sym, context=mt.gpu(0))
            mod.fit(batch_iter(mt, feed, pd, pl), num_epoch=1,
                    optimizer_params=dict(TRAIN_OPT), arg_params=arg0,
                    aux_params=aux0, mesh=m, batch_end_callback=lambda p:
                    first.append(host_params(mod)) if p.nbatch == 0
                    else None)
            return mod
        nudged = [mt.io.DataBatch(
            data=[mt.nd.array(np.nextafter(bt.data[0].asnumpy(),
                                           np.float32(np.inf)),
                              ctx=mt.cpu())],
            label=bt.label, pad=0) for bt in batches]
        mn = fit(None, nudged)
        pn = host_params(mn)
        pn_first = first[-1]
        del mn
        m13 = fit(None)
        p13 = host_params(m13)
        nudge = [rel_l2([pn[i]], [p13[i]]) for i in (0, 1)]
        C.reset_stats()
        m21 = fit(mesh)
        p21_first = first[-1]
        init = ({k: v.asnumpy() for k, v in arg0.items()},
                {k: v.asnumpy() for k, v in aux0.items()})
        nudge_first = [first_step_l2(pn_first[i], p21_first[i], init[i])
                       for i in (0, 1)]
        coll = dict(C.STATS)
        stats = m21._fused.stats.report()
        p21 = host_params(m21)
        same = bitwise(p13[0], p21[0]) and bitwise(p13[1], p21[1])
        step = mt.parallel.DPTrainStep(
            sym, mesh, learning_rate=TRAIN_OPT["learning_rate"],
            momentum=TRAIN_OPT["momentum"], weight_decay=0.0,
            ctx=mt.gpu(0))
        state = step.init({k: v.asnumpy() for k, v in arg0.items()},
                          {k: v.asnumpy() for k, v in aux0.items()})
        for bt in batches:
            state, outs = step(state, step.shard_batch(
                {"data": bt.data[0].asnumpy(),
                 "softmax_label": bt.label[0].asnumpy()}))
        pdp = (step.params_numpy(state),
               {k: v.cpu().numpy() for k, v in state["aux"].items()})
        dp_same = bitwise(pdp[0], p13[0]) and bitwise(pdp[1], p13[1])
        dp_err = worst_rel(pdp, p13, 0.0)
        del state, step, outs
        # the captured steps: a replay of each, profiled
        rates = {}
        for name, mod in (("fit", m13), ("fit-mesh-dp1", m21)):
            bufs = mod._fused.make_batch(batches[0])
            wall, device, rows = device_profile(
                torch, lambda: mod._fused.step(bufs), reps=5)
            nccl = [(t, k, n) for t, k, n in rows if "nccl" in k.lower()]
            rates[name] = {"img_s": b / (wall / 1e3), "wall": wall,
                           "device": device, "busy": device / wall,
                           "nccl_ms": sum(t for t, _, _ in nccl),
                           "nccl_launches": sum(n for _, _, n in nccl)}
    finally:
        torch.backends.cudnn.deterministic = False
    launches = dict(ck.LAUNCHES)
    print("scaleout: (a) ResNet-50 batch %d, %d steps, cuDNN deterministic: "
          "fit(mesh=dp=1) fused step %s; collectives issued while Python "
          "ran the step (3 eager steps and the capture) %d, %d bytes; "
          "params and aux bitwise to fit without a mesh (phase 13's fused "
          "step) %s (gate); DPTrainStep (eager) bitwise %s, smallest rtol "
          "at atol 0 %.3g (gate %g, phase 13's deterministic rule); the "
          "data nudged by one ulp moves the first step's update and "
          "moving-statistics change by %.3g, %.3g and the %d steps' params "
          "and moving statistics by %.3g, %.3g (relative L2); card %s"
          % (b, SCALE_STEPS, stats, coll["calls"], coll["bytes"], same,
             dp_same, dp_err, DET_RTOL, nudge_first[0], nudge_first[1],
             SCALE_STEPS, nudge[0], nudge[1], smi))
    for name, r in rates.items():
        print("scaleout: (a) %-12s captured step (cuDNN deterministic) "
              "%.3f ms wall = %.1f img/s, device %.3f ms, busy %.3f, NCCL "
              "kernels in a replay %d (%.3f ms; an in-place all-reduce over "
              "one rank launches none)" % (
                  name, r["wall"], r["img_s"], r["device"], r["busy"],
                  r["nccl_launches"], r["nccl_ms"]))
    if r13 is not None:
        print("scaleout: (a) phase 13 in this run: step %.1f img/s, busy "
              "%.3f, fit %.1f img/s; card %s" % (
                  r13["img_s"], r13["device"] / r13["wall"],
                  r13["fit_img_s"], smi))
    print("scaleout: (a) hand-kernel launches: %s" % launches)
    if not same:
        fail("fit(mesh=dp=1) differs from fit without a mesh")
    if stats != {"captures": 1, "replays": SCALE_STEPS - WARMUP_STEPS,
                 "eager_steps": WARMUP_STEPS}:
        fail("fit(mesh=dp=1) made %s" % stats)
    # the capture ran the step's Python once: its gradient all-reduce and
    # output all-gather went into the graph as they went into each eager
    # step; the replays run no Python
    if coll["calls"] != 2 * (WARMUP_STEPS + 1):
        fail("the mesh step issued %d collectives in %d eager steps and "
             "the capture" % (coll["calls"], WARMUP_STEPS))
    if not dp_same and dp_err > DET_RTOL:
        fail("DPTrainStep differs from the fused step")
    if any(launches.values()):
        fail("the scale-out path launched hand kernels: %s" % launches)
    del m13, m21
    gc.collect()
    torch.cuda.empty_cache()
    return p21, rates, nudge, p21_first, nudge_first


def scaleout_fits(seed):
    """(b) on one of two ranks sharing gpu(0): fit(kvstore="dist_sync")
    and fit(mesh=dp=2) on ResNet-50 under deterministic cuDNN; -> their
    results by name."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.dist import boot
    from mxnet_tpu_torch.parallel import collectives as C
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    rank = boot.rank()
    out = {}
    sym, arg0, aux0, batches, pd, pl = resnet_setup(mt, SCALE_STEPS, seed)
    half = RESNET_BATCH // 2
    local = [mt.io.DataBatch(
        data=[mt.nd.array(bt.data[0].asnumpy()[rank * half:(rank + 1)
                                               * half], ctx=mt.cpu())],
        label=[mt.nd.array(bt.label[0].asnumpy()[rank * half:(rank + 1)
                                                 * half], ctx=mt.cpu())],
        pad=0) for bt in batches]
    lpd = [("data", (half, 3, 224, 224))]
    lpl = [("softmax_label", (half,))]
    first = []
    for name, kv, mesh, feed, d, l in (
            ("dist_sync", "dist_sync", None, local, lpd, lpl),
            ("mesh-dp2", "local", mt.parallel.make_mesh("dp=2"), batches,
             pd, pl)):
        marks = []

        def mark(param):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), C.STATS["seconds"]))
            if param.nbatch == 0:
                first.append(host_params(mod))
                torch.cuda.synchronize()
                marks[-1] = (time.perf_counter(), C.STATS["seconds"])
        mod = mt.mod.Module(sym, context=mt.gpu(0))
        mod.fit(batch_iter(mt, feed, d, l), num_epoch=1, kvstore=kv,
                mesh=mesh, optimizer_params=dict(TRAIN_OPT),
                arg_params=arg0, aux_params=aux0, batch_end_callback=mark)
        params = host_params(mod)
        wall = marks[-1][0] - marks[0][0]
        out[name] = {
            "params": params if rank == 0 else None,
            "first": first[-1] if rank == 0 else None,
            "digest": param_digest(params),
            "stats": mod._fused.stats.report(),
            "rescale": mod._optimizer.rescale_grad,
            "img_s": RESNET_BATCH * (len(marks) - 1) / wall,
            "coll_share": (marks[-1][1] - marks[0][1]) / wall,
            "step_ms": 1e3 * wall / (len(marks) - 1)}
        del mod
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return out


def scaleout_rank(seed):
    """(b)-(d) on one of two ranks sharing gpu(0); -> results."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.dist import boot
    from mxnet_tpu_torch.parallel import collectives as C
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"boot": boot.describe(), "backend": boot.backend()}
    dev = torch.device("cuda", 0)
    out.update(scaleout_fits(seed))
    # (c)
    mesh = mt.parallel.make_mesh("sp=2")
    ax = mesh.axis("sp")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    q, k, v = (torch.randn((1, RING_T, ATTN_H, ATTN_D), generator=gen,
                           device=dev) for _ in range(3))
    tl = RING_T // 2
    sl = slice(ax.index * tl, (ax.index + 1) * tl)
    for impl in ("ring", "ulysses"):
        fn = mt.parallel.ring_attention if impl == "ring" \
            else mt.parallel.ulysses_attention
        for causal in (False, True):
            with torch.no_grad():
                fn(q[:, sl], k[:, sl], v[:, sl], ax, causal=causal)
                C.barrier(ax)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o = fn(q[:, sl], k[:, sl], v[:, sl], ax, causal=causal)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                ref = ck.flash_attention(q, k, v, causal=causal)[:, sl]
                err = float((o - ref).abs().max())
                finite = bool(torch.isfinite(o).all())
            out["attn", impl, causal] = {"ms": ms, "err": err,
                                         "finite": finite}
            del o, ref
            torch.cuda.empty_cache()
    del q, k, v
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    q, k, v, w = (torch.randn((1, RING_GRAD_T, ATTN_H, ATTN_D),
                              generator=gen, device=dev) for _ in range(4))
    tl = RING_GRAD_T // 2
    sl = slice(ax.index * tl, (ax.index + 1) * tl)
    full = [x.clone().requires_grad_(True) for x in (q, k, v)]
    (mt.parallel.attention_reference(*full, causal=True) * w).sum() \
        .backward()
    for impl in ("ring", "ulysses"):
        fn = mt.parallel.ring_attention if impl == "ring" \
            else mt.parallel.ulysses_attention
        leaves = [x[:, sl].clone().requires_grad_(True) for x in (q, k, v)]
        (fn(*leaves, ax, causal=True) * w[:, sl]).sum().backward()
        out["grad", impl] = max(
            float((x.grad - f.grad[:, sl]).abs().max())
            / float(f.grad[:, sl].abs().max())
            for x, f in zip(leaves, full))
    del q, k, v, w, full, leaves
    torch.cuda.empty_cache()
    # (d)
    rng = np.random.default_rng(seed + 7)
    S, Wd, Hd = 2, PIPE_WIDTH, PIPE_HIDDEN
    stages = {
        "w1": (rng.standard_normal((S, Wd, Hd)) / math.sqrt(Wd))
        .astype(np.float32),
        "b1": (rng.standard_normal((S, Hd)) * 0.1).astype(np.float32),
        "w2": (rng.standard_normal((S, Hd, Wd)) / math.sqrt(Hd))
        .astype(np.float32),
        "b2": (rng.standard_normal((S, Wd)) * 0.1).astype(np.float32)}
    tail = {"w": (rng.standard_normal((Wd, 1)) / math.sqrt(Wd))
            .astype(np.float32)}
    X = rng.standard_normal((PIPE_M * PIPE_ROWS, Wd)).astype(np.float32)
    y = rng.standard_normal(PIPE_M * PIPE_ROWS).astype(np.float32)

    def stage_fn(p, x):
        return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    def loss_fn(t, h, lab):
        return ((h @ t["w"])[:, 0] - lab).pow(2).mean()
    pmesh = mt.parallel.make_mesh("pp=2")
    step = mt.parallel.GPipeTrainStep(stage_fn, loss_fn, pmesh,
                                      num_micro=PIPE_M, learning_rate=0.01,
                                      ctx=mt.gpu(0))
    st = step.init(stages, tail)
    step.loss_and_grads(st, X, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = step.loss_and_grads(st, X, y)
    torch.cuda.synchronize()
    pipe_ms = 1e3 * (time.perf_counter() - t0)
    with torch.no_grad():
        gst = {kk: torch.as_tensor(vv, device=dev)
               for kk, vv in stages.items()}
        xd = torch.as_tensor(X, device=dev)
        outs = mt.parallel.pipeline_apply(
            stage_fn, pmesh, gst,
            xd.reshape(PIPE_M, PIPE_ROWS, Wd)).reshape(-1, Wd)
    seq = {kk: vv.clone().requires_grad_(True) for kk, vv in gst.items()}
    tw = torch.as_tensor(tail["w"], device=dev).requires_grad_(True)
    h = xd
    for s in range(S):
        h = stage_fn({kk: vv[s] for kk, vv in seq.items()}, h)
    ref_loss = loss_fn({"w": tw}, h, torch.as_tensor(y, device=dev))
    ref_loss.backward()

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())
    r = ax.index
    out["pipe"] = {
        "ms": pipe_ms,
        "out": rel(outs, h.detach()),
        "loss": abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)),
        "grads": max([rel(grads["stages"][kk], seq[kk].grad[r])
                      for kk in seq] + [rel(grads["tail"]["w"], tw.grad)])}
    return out


def async_worker(out_dir):
    """(e), one worker of tools/launch.py -n 2 -s 1: the nightly MLP on
    the card through the parameter server, then one init/push/pull
    round of ResNet-50's parameters; writes its numbers to out_dir."""
    import torch
    import mxnet_tpu_torch as mt
    kv = mt.kv.create("dist_async")
    rank, nworker = kv.rank, kv.num_workers
    centers = np.random.RandomState(1234).randn(4, 10) * 3

    def blobs(n, seed):
        r = np.random.RandomState(seed)
        ys = r.randint(4, size=n)
        return ((centers[ys] + r.randn(n, 10) * 0.5).astype(np.float32),
                ys.astype(np.float32))
    X, y = blobs(800, 0)
    shard = len(X) // nworker
    it = mt.io.NDArrayIter(X[rank * shard:(rank + 1) * shard],
                           y[rank * shard:(rank + 1) * shard],
                           batch_size=50, shuffle=True)
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=32,
                                name="fc1")
    net = mt.sym.Activation(net, act_type="relu")
    net = mt.sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = mt.sym.SoftmaxOutput(net, name="softmax")
    mod = mt.mod.Module(net, context=mt.gpu(0))
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=6, kvstore=kv,
            optimizer_params={"learning_rate": 0.3})
    fit_s = time.perf_counter() - t0
    Xv, yv = blobs(400, 99)
    acc = mod.score(mt.io.NDArrayIter(Xv, yv, batch_size=50), "acc")[0][1]
    sym = mt.models.get_resnet50(1000)
    shapes, _, _ = sym.infer_shape(data=(1, 3, 224, 224),
                                   softmax_label=(1,))
    names = [n for n in sym.list_arguments()
             if n not in ("data", "softmax_label")]
    shape_of = dict(zip(sym.list_arguments(), shapes))
    vals = [mt.nd.ones(shape_of[n], ctx=mt.gpu(0)) for n in names]
    keys = [1000 + i for i in range(len(names))]
    n_params = sum(v.size for v in vals)
    kv.barrier()
    t0 = time.perf_counter()
    kv.init(keys, vals)
    t_init = time.perf_counter() - t0
    kv.barrier()
    t0 = time.perf_counter()
    kv.push(keys, vals)
    outs = [mt.nd.zeros(shape_of[n], ctx=mt.gpu(0)) for n in names]
    kv.pull(keys, out=outs)
    torch.cuda.synchronize()
    t_round = time.perf_counter() - t0
    finite = all(np.isfinite(o.asnumpy()).all() for o in outs)
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump({"rank": rank, "acc": float(acc), "fit_s": fit_s,
                   "params": int(n_params), "keys": len(keys),
                   "init_ms": 1e3 * t_init, "round_ms": 1e3 * t_round,
                   "bytes": 4 * int(n_params), "finite": bool(finite),
                   "fused": mod._fused is not None}, f)
    kv.barrier()
    kv.close()


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def scaleout_phase(torch, mt, ck, smi, r13=None):
    print("phase 21: scale-out on the card; TF32 matmul=%s cudnn=%s; card "
          "%s" % (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32, smi))
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    res = resnet_setup(mt, SCALE_STEPS, 21)
    one, rates, nudge, one_first, nudge_first = scaleout_one_rank(
        torch, mt, ck, smi, res, r13)
    init = ({k: v.asnumpy() for k, v in res[1].items()},
            {k: v.asnumpy() for k, v in res[2].items()})
    update = [rel_l2([init[i]], [one[i]]) for i in (0, 1)]
    del res
    gc.collect()
    # (b)-(d): two ranks on gpu(0)
    from mxnet_tpu_torch.dist.spawn import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(os.path.join(root, "chip_smoke.py") + ":scaleout_rank",
                      2, args=(21,), timeout=420)
    print("scaleout: (b)-(d) two ranks on gpu(0) in %.1f s; %s; %s" % (
        time.perf_counter() - t0, ranks[0]["boot"], ranks[1]["boot"]))
    if any(r["backend"] != "gloo" for r in ranks):
        fail("two ranks sharing one card must take gloo")
    for name in ("dist_sync", "mesh-dp2"):
        r0 = ranks[0][name]
        rd = fit_readings(ranks, name, one, one_first, init)
        d_first, err, same = rd["first"], rd["steps"], rd["same"]
        print("scaleout: (b) %-9s ResNet-50 batch %d (%d a rank), fused "
              "step %s, rescale_grad %.6g, cuDNN deterministic: the first "
              "step's update and moving-statistics change against (a)'s, "
              "relative L2 %.3g, %.3g (gates %.3g, %.3g: %g x the one-ulp "
              "nudge's; largest tensors %s); ranks' params and moving "
              "statistics equal after %d steps %s (gate); reading, not a "
              "gate: after %d steps, params %.3g, moving statistics %.3g "
              "(the one-ulp nudge's %.3g, %.3g; the 4 steps' update itself "
              "%.3g, %.3g); %.1f img/s, %.1f ms a step, collectives "
              "(host-staged, gloo) %.3f of the step; card %s" % (
                  name, RESNET_BATCH, RESNET_BATCH // 2, r0["stats"],
                  r0["rescale"], d_first[0], d_first[1],
                  SCALE_RATIO * nudge_first[0], SCALE_RATIO * nudge_first[1],
                  SCALE_RATIO, ["%s %.3g" % (k, v) for v, k in rd["worst"]],
                  SCALE_STEPS, same, SCALE_STEPS, err[0], err[1], nudge[0],
                  nudge[1], update[0], update[1], r0["img_s"],
                  r0["step_ms"], r0["coll_share"], smi))
        if d_first[0] > SCALE_RATIO * nudge_first[0] or \
                d_first[1] > SCALE_RATIO * nudge_first[1]:
            fail("(b) %s: the first step differs from one rank's: %s"
                 % (name, d_first))
        if not same:
            fail("(b) %s: the two ranks' params or moving statistics "
                 "differ" % name)
        if r0["stats"]["captures"] or not r0["stats"]["eager_steps"]:
            fail("(b) %s on gloo must run eagerly: %s" % (name, r0["stats"]))
    routes = bitwise(ranks[0]["dist_sync"]["params"][0],
                     ranks[0]["mesh-dp2"]["params"][0]) and \
        bitwise(ranks[0]["dist_sync"]["params"][1],
                ranks[0]["mesh-dp2"]["params"][1])
    print("scaleout: (b) dist_sync and fit(mesh=dp=2) over the same rows, "
          "cuDNN deterministic: params and moving statistics bitwise %s "
          "(gate)" % routes)
    if not routes:
        fail("(b) dist_sync and fit(mesh=dp=2) differ")
    for impl in ("ring", "ulysses"):
        for causal in (False, True):
            c = [r["attn", impl, causal] for r in ranks]
            err = max(x["err"] for x in c)
            print("scaleout: (c) %-7s causal=%d B=1 T=%d H=%d D=%d at sp=2: "
                  "each rank's shard against flash_attention over the whole "
                  "sequence max_abs_err %.3g (tol %g), %.1f ms a call "
                  "(ranks %s); card %s" % (
                      impl, causal, RING_T, ATTN_H, ATTN_D, err, FLASH_ATOL,
                      max(x["ms"] for x in c),
                      ["%.1f" % x["ms"] for x in c], smi))
            if err > FLASH_ATOL or not all(x["finite"] for x in c):
                fail("(c) %s causal=%d: %.3g" % (impl, causal, err))
    for impl in ("ring", "ulysses"):
        err = max(r["grad", impl] for r in ranks)
        print("scaleout: (c) %-7s gradient at T=%d causal: q, k, v against "
              "attention_reference's autograd, max abs error / largest "
              "element %.3g (tol %g)" % (impl, RING_GRAD_T, err,
                                         ATTN_GRAD_RTOL))
        if err > ATTN_GRAD_RTOL:
            fail("(c) %s gradient %.3g" % (impl, err))
    p = [r["pipe"] for r in ranks]
    worst = max(max(x["out"], x["loss"], x["grads"]) for x in p)
    print("scaleout: (d) GPipeTrainStep pp=2, stages 768 -> 3072 -> 768 "
          "tanh, M=%d microbatches of %d tokens: outputs %.3g, loss %.3g, "
          "gradients %.3g against the stages in sequence on one rank "
          "(relative to the largest element; tol %g); forward + backward "
          "%.1f ms (ranks %s); card %s" % (
              PIPE_M, PIPE_ROWS, max(x["out"] for x in p),
              max(x["loss"] for x in p), max(x["grads"] for x in p),
              PIPE_RTOL, max(x["ms"] for x in p),
              ["%.1f" % x["ms"] for x in p], smi))
    if worst > PIPE_RTOL:
        fail("(d) pipeline differs from the sequence of stages: %.3g"
             % worst)
    # (e) dist_async: scheduler, 1 server, 2 workers on the card
    with tempfile.TemporaryDirectory() as tmp:
        cmd = ("%s -c \"import sys; sys.path.insert(0, %r); import "
               "mxnet_tpu_torch; from mxnet_tpu_torch.dist.spawn import "
               "load_target; load_target(%r)(%r)\"" % (
                   sys.executable, root,
                   os.path.join(root, "chip_smoke.py") + ":async_worker",
                   tmp))
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "tools", "launch.py"),
             "-n", "2", "-s", "1", "--port", str(free_port()), cmd],
            env=env, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail("(e) dist_async job exited %d: %s %s" % (
                proc.returncode, proc.stdout[-2000:], proc.stderr[-3000:]))
        ws = []
        for r in range(2):
            with open(os.path.join(tmp, "rank%d.json" % r)) as f:
                ws.append(json.load(f))
    print("scaleout: (e) dist_async, scheduler + 1 server + 2 workers on "
          "the card (tools/launch.py -n 2 -s 1, %.1f s): nightly MLP "
          "accuracy %s (gate %.2f), fit %s s, fused step %s; ResNet-50's "
          "%d parameters as %d keys: init %.1f ms (rank 0 sends), one push "
          "+ pull round %s ms a worker, %d bytes each way, finite %s; card "
          "%s" % (wall, [round(w["acc"], 4) for w in ws], ASYNC_ACC,
                  [round(w["fit_s"], 2) for w in ws],
                  [w["fused"] for w in ws], ws[0]["params"], ws[0]["keys"],
                  ws[0]["init_ms"], [round(w["round_ms"], 1) for w in ws],
                  ws[0]["bytes"], all(w["finite"] for w in ws), smi))
    if min(w["acc"] for w in ws) < ASYNC_ACC or \
            not all(w["finite"] for w in ws):
        fail("(e) dist_async: %s" % ws)
    from mxnet_tpu_torch.dist import boot
    boot.shutdown()
    took = time.perf_counter() - t_phase
    print("phase 21: %.1f s" % took)
    return {"rates": rates, "b": {n: {k: ranks[0][n][k] for k in
                                      ("img_s", "step_ms", "coll_share")}
                                  for n in ("dist_sync", "mesh-dp2")},
            "attn_ms": {"%s-%s" % (i, "causal" if c else "full"):
                        max(r["attn", i, c]["ms"] for r in ranks)
                        for i in ("ring", "ulysses") for c in (False, True)},
            "pipe_ms": max(x["ms"] for x in p),
            "async": {"init_ms": ws[0]["init_ms"],
                      "round_ms": max(w["round_ms"] for w in ws),
                      "bytes": ws[0]["bytes"]},
            "seconds": took}


# -- phase 22: model state sharded over a mesh
#
# Two ranks sharing gpu(0) (gloo, as phase 21 (b)-(d)), one spawn:
# (a) VGG-16 (configuration D of Simonyan & Zisserman 2014) at 224 x 224,
# batch 32, trained by fit(mesh="dp=1,tp=2") with fc6 cut on its output
# features (column-parallel: each rank (2048, 25088) of the 411 MB weight)
# and fc7 on its inputs (row-parallel: partial sums, one all-reduce),
# against the same fit in one process (the main one).  (d) That run saves
# after its first step, each rank its own shards; the step is restored
# into one process (the main one), onto dp=2 and into a fresh tp=2 run,
# each bitwise.  (c) PR 13's Switch-Base-8 block (phase 19's sizes) over
# dp=1 x ep=2, each rank 4 experts, against one process; and the global
# routing of 8,192 tokens cut over dp=2 against routing them in one call.
# (b) ServeEngine(mesh="tp=2", param_specs=...), fused, float32, over
# 32 requests on buckets (1, 8) against a one-device engine; the fc
# kernel runs on each rank's shard (fc6's (2048, 25088) with the whole
# epilogue, fc7's (4096, 2048) partial product), counted and checked
# there; a reload keeps the layout and the answers.
TP_BATCH, TP_STEPS = 32, 4
TP_MESH = "dp=1,tp=2"
TP_SPECS = {"fc6_weight": ("tp", None), "fc6_bias": ("tp",),
            "fc7_weight": (None, "tp")}
TP_SERVE_N, TP_SERVE_BUCKETS, TP_SERVE_THREADS = 32, (1, 8), 4
EP_MESH = "dp=1,ep=2"


def tp_specs(mt, specs=TP_SPECS):
    P = mt.parallel.PartitionSpec
    return {k: P(*v) for k, v in specs.items()}


def vgg_setup(mt, seed, batch=TP_BATCH, steps=TP_STEPS):
    """VGG-16's symbol, Xavier params and ``steps`` batches (host arrays)
    and the first batch nudged by one ulp."""
    sym = mt.models.get_vgg(num_classes=1000)
    shapes = {"data": (batch, 3, 224, 224), "softmax_label": (batch,)}
    arg0 = xavier_params(sym, shapes, seed)
    rng = np.random.default_rng(seed + 1)
    xs = [rng.standard_normal(shapes["data"], dtype=np.float32)
          for _ in range(steps)]
    ys = [rng.integers(0, 1000, batch).astype(np.float32)
          for _ in range(steps)]
    nudged = np.nextafter(xs[0], np.float32(np.inf))
    return sym, arg0, xs, ys, nudged


def vgg_batches(mt, xs, ys):
    b = [mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu())],
                         label=[mt.nd.array(y, ctx=mt.cpu())], pad=0)
         for x, y in zip(xs, ys)]
    return batch_iter(mt, b, [("data", xs[0].shape)],
                      [("softmax_label", ys[0].shape)])


def sha_of(arrays):
    import hashlib
    return {k: hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in arrays.items()}


def opt_host(torch, mod):
    """The momentum of every parameter, gathered whole (a collective
    under a mesh: every rank calls it)."""
    st = mod._fused.gathered_state()["opt"]
    return {k: v.detach().cpu().numpy() for k, v in st.items()
            if isinstance(v, torch.Tensor)}


def timed_fit(torch, mt, mod, it, **kw):
    """fit with a synchronized mark after each batch; -> (host params
    after the first batch, ms of each later step)."""
    marks, first = [], []
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)

    def mark(param):
        sync()
        marks.append(time.perf_counter())
        if param.nbatch == 0 and not first:
            first.append(host_params(mod))
            sync()
            marks[-1] = time.perf_counter()
    mod.fit(it, batch_end_callback=mark, optimizer_params=dict(TRAIN_OPT),
            **kw)
    return first[0] if first else None, \
        [1e3 * (b - a) for a, b in zip(marks, marks[1:])]


def switch_ep_symbol(mt):
    net = mt.moe.MoEFeedForward(mt.sym.Variable("data"), num_hidden=SW_H,
                                num_experts=SW_E, k=SW_K,
                                capacity_factor=SW_CF, name="moe",
                                expert_axis="ep")
    net = mt.sym.FullyConnected(net, num_hidden=2, name="head")
    return mt.moe.with_aux_loss(mt.sym.SoftmaxOutput(net, name="softmax"))


def switch_setup(mt, seed, tokens=SW_TOKENS):
    sym = switch_ep_symbol(mt)
    arg0 = fan_in_params(sym, {"data": (tokens, SW_D),
                               "softmax_label": (tokens,)}, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((tokens, SW_D), dtype=np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    return sym, arg0, x, y


def switch_fit(torch, mt, sym, arg0, x, y, mesh=None, steps=1, ctx=None,
               first=None):
    """``steps`` fused steps of the Switch block on one batch; -> the
    module and its host params after them (after the first into the
    list ``first``)."""
    mod = mt.mod.Module(sym, context=ctx or mt.gpu(0))
    it = batch_iter(mt, [mt.io.DataBatch(
        data=[mt.nd.array(x, ctx=mt.cpu())],
        label=[mt.nd.array(y, ctx=mt.cpu())], pad=0)] * steps,
        [("data", x.shape)], [("softmax_label", y.shape)])
    mod.fit(it, num_epoch=1, mesh=mesh, optimizer_params=dict(SW_OPT),
            batch_end_callback=None if first is None else
            lambda p: first.append(host_params(mod)[0])
            if p.nbatch == 0 else None,
            eval_metric=mt.metric.CompositeEvalMetric(
                [mt.metric.OutputSlice("acc", 0, 1),
                 mt.metric.OutputMean(1, name="moe_aux")]),
            arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in arg0.items()})
    return mod, host_params(mod)[0]


def sharded_rank(tmp, seed, logits):
    """(a)-(d) on one of two ranks sharing gpu(0); -> results."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.dist import boot
    from mxnet_tpu_torch.parallel import collectives as C
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    rank = boot.rank()
    out = {"backend": boot.backend()}
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)          # the context, before its counters
    # (a) with (d)'s save after the first step
    sym, arg0, xs, ys, _ = vgg_setup(mt, seed)
    C.reset_stats()
    torch.cuda.reset_peak_memory_stats(dev)
    mt.random.seed(seed)
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    ckdir = os.path.join(tmp, "tp-ck")
    t0 = time.perf_counter()
    timed_fit(torch, mt, mod, vgg_batches(mt, xs[:1], ys[:1]), num_epoch=1,
              mesh=TP_MESH, sharding=tp_specs(mt), checkpoint=ckdir,
              arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                          for k, v in arg0.items()})
    save_s = time.perf_counter() - t0
    stats_first = {k: dict(v) for k, v in C.STATS["by_op"].items()}
    _, step_ms = timed_fit(torch, mt, mod, vgg_batches(mt, xs[1:], ys[1:]),
                           begin_epoch=1, num_epoch=2)
    st = mod._fused.state
    out["a"] = {
        "shapes": {k: tuple(st["params"][k].shape)
                   for k in ("fc6_weight", "fc6_bias", "fc7_weight",
                             "fc8_weight")},
        "mom_shape": tuple(st["opt"]["fc6_weight"].shape),
        "stats_first": stats_first,
        "stats": {k: dict(v) for k, v in C.STATS["by_op"].items()},
        "calls": C.STATS["calls"], "bytes": C.STATS["bytes"],
        "coll_s": C.STATS["seconds"],
        "step_ms": step_ms, "first_s": save_s,
        "fused": mod._fused.stats.report(),
        "peak": torch.cuda.max_memory_allocated(dev),
        "digest": sha_of(host_params(mod)[0])}
    del mod, st
    gc.collect()
    torch.cuda.empty_cache()
    # (d): the first step's save restored into a fresh tp=2 run, then
    # onto dp=2
    for name, mesh, specs in (("tp2", TP_MESH, tp_specs(mt)),
                              ("dp2", "dp=2", None)):
        mod = mt.mod.Module(sym, context=mt.gpu(0))
        mod.set_mesh(mesh, sharding=specs)
        it = vgg_batches(mt, xs[:1], ys[:1])
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                    for k, v in arg0.items()})
        mod.init_optimizer(optimizer_params=dict(TRAIN_OPT))
        t0 = time.perf_counter()
        with mt.checkpoint.CheckpointManager(ckdir, keep_last_n=None) as m:
            mt.checkpoint.restore_module(m, mod)
        torch.cuda.synchronize()
        out["d", name] = {
            "s": time.perf_counter() - t0, "t": mod._fused_t,
            "params": sha_of(host_params(mod)[0]),
            "opt": sha_of(opt_host(torch, mod)),
            "fc6": tuple(mod._fused.state["params"]["fc6_weight"].shape)}
        del mod
        gc.collect()
        torch.cuda.empty_cache()
    out["d", "files"] = sorted(os.listdir(os.path.join(
        ckdir, mt.checkpoint.step_dir_name(
            mt.checkpoint.latest_step(ckdir)))))
    del arg0, xs, ys
    gc.collect()
    # (c)
    ssym, sarg, sx, sy = switch_setup(mt, seed + 2)
    mod, first = switch_fit(torch, mt, ssym, sarg, sx, sy, EP_MESH)
    out["c"] = {"experts": tuple(
        mod._fused.state["params"]["moe_experts_i2h_weight"].shape),
        "first": first if rank == 0 else None,
        "digest": sha_of(first)}
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    ax = mt.parallel.make_mesh("dp=2").axis("dp")
    n = logits.shape[0] // 2
    cap = mt.moe.resolve_capacity(SW_CF, logits.shape[0], SW_E, SW_K)
    plan = mt.moe.route(torch.as_tensor(
        logits[ax.index * n:(ax.index + 1) * n], device=dev), SW_K, cap,
        dp=ax)
    out["c"]["slot"] = C.all_gather(plan.slot, ax).cpu().numpy()
    out["c"]["dropped"] = float(plan.dropped)
    out["c"]["counts"] = plan.counts.cpu().numpy()
    # (b)
    prefix = os.path.join(tmp, "vgg-serve")
    items = tp_serve_items(seed)
    ck.reset_launches()
    answers = [None] * len(items)
    t0 = time.perf_counter()
    with mt.serve.ServeEngine.from_checkpoint(
            prefix, 0, {"data": (1, 3, 224, 224), "softmax_label": (1,)},
            batch_buckets=TP_SERVE_BUCKETS, fuse=True, mesh="tp=2",
            param_specs=tp_specs(mt), name="serve-tp2") as eng:
        build_s = time.perf_counter() - t0
        ex = eng._predictor._exec
        fused_ops = [nd["op"] for nd in json.loads(
            eng._predictor.symbol.tojson())["nodes"]]
        shard = {k: tuple(ex.arg_dict[k].shape)
                 for k in ("fc6_weight", "fc6_bias", "fc7_weight")}
        wall = 0.0
        if rank == 0:
            errors = []

            def client(idx):
                try:
                    futs = [(i, eng.submit(items[i])) for i in
                            range(idx, len(items), TP_SERVE_THREADS)]
                    for i, f in futs:
                        answers[i] = f.result(timeout=300)
                except Exception as e:      # reported below
                    errors.append(repr(e))
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(TP_SERVE_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            if errors:
                fail("(b) client errors: %s" % errors)
        version = eng.reload_from_checkpoint(prefix, 0)
        shard2 = tuple(ex.arg_dict["fc6_weight"].shape)
        again = [eng.predict(x) for x in items[:8]] if rank == 0 else None
        report = eng.stats.report() if rank == 0 else None
        w6 = ex.arg_dict["fc6_weight"]._get()
        b6 = ex.arg_dict["fc6_bias"]._get()
    launches = dict(ck.LAUNCHES)
    # the kernel on this rank's fc6 shard against its plain version (after
    # the count was read: these launches are not the path's)
    gen = torch.Generator(device=dev).manual_seed(seed + rank)
    x6 = torch.randn((8, w6.shape[1]), generator=gen, device=dev)
    y = ck.fused_fc_epilogue(x6, w6, b6, "relu")
    ref = ck.fused_fc_epilogue_reference(x6, w6, b6, "relu")
    torch.cuda.synchronize()
    out["b"] = {"answers": answers if rank == 0 else None,
                "again": again, "version": version, "shard": shard,
                "shard_after_reload": shard2, "launches": launches,
                "fused_ops": fused_ops.count("_fused_FullyConnected"),
                "report": report, "wall": wall, "build_s": build_s,
                "kernel_err": float((y - ref).abs().max()),
                "kernel_tol": 1e-4 * max(1.0, float(ref.abs().max()))}
    torch.backends.cudnn.deterministic = False
    return out


def tp_serve_items(seed):
    rng = np.random.default_rng(seed + 3)
    return [wire_to_nchw(rng.integers(0, 256, (224, 224, 3), dtype=np.uint8))
            for _ in range(TP_SERVE_N)]


def sharded_phase(torch, mt, ck, smi):
    print("phase 22: model state sharded over a mesh; TF32 matmul=%s "
          "cudnn=%s; card %s" % (torch.backends.cuda.matmul.allow_tf32,
                                 torch.backends.cudnn.allow_tf32, smi))
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    seed = 22
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    tmpdir = tempfile.TemporaryDirectory()
    tmp = tmpdir.name
    torch.backends.cudnn.deterministic = True
    # (a)'s one-process run: the first step clean and nudged, then the
    # other steps; the peak memory of its process from here
    sym, arg0, xs, ys, nudged = vgg_setup(mt, seed)
    init = {k: v for k, v in arg0.items()}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    mt.random.seed(seed)
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    one_first, one_ms = timed_fit(
        torch, mt, mod, vgg_batches(mt, xs, ys), num_epoch=1,
        arg_params={k: mt.nd.array(v, ctx=mt.cpu()) for k, v in arg0.items()})
    one_peak = torch.cuda.max_memory_allocated(dev) - base
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    mt.random.seed(seed)
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    nudge_first, _ = timed_fit(
        torch, mt, mod, vgg_batches(mt, [nudged], ys[:1]), num_epoch=1,
        arg_params={k: mt.nd.array(v, ctx=mt.cpu()) for k, v in arg0.items()})
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    nudge_l2 = first_step_l2(nudge_first[0], one_first[0], init)
    # (c)'s one-process run and routing in one call
    ssym, sarg, sx, sy = switch_setup(mt, seed + 2)
    _, s_first = switch_fit(torch, mt, ssym, sarg, sx, sy)
    _, s_nudge = switch_fit(torch, mt, ssym, sarg,
                            np.nextafter(sx, np.float32(np.inf)), sy)
    s_nudge_l2 = first_step_l2(s_nudge, s_first, sarg)
    logits = (sx @ sarg["moe_gate_weight"].T).astype(np.float32)
    cap = mt.moe.resolve_capacity(SW_CF, SW_TOKENS, SW_E, SW_K)
    plan = mt.moe.route(torch.as_tensor(logits, device=dev), SW_K, cap)
    one_slot = plan.slot.cpu().numpy()
    one_dropped = float(plan.dropped)
    del plan
    gc.collect()
    torch.cuda.empty_cache()
    # (b)'s checkpoint pair and one-device engine
    prefix = os.path.join(tmp, "vgg-serve")
    mt.model.save_checkpoint(prefix, 0, sym, {
        k: mt.nd.array(v, ctx=mt.cpu()) for k, v in arg0.items()}, {})
    items = tp_serve_items(seed)
    with mt.serve.ServeEngine.from_checkpoint(
            prefix, 0, {"data": (1, 3, 224, 224), "softmax_label": (1,)},
            batch_buckets=TP_SERVE_BUCKETS, fuse=True,
            name="serve-one") as eng:
        t0 = time.perf_counter()
        refs = [f.result(timeout=300) for f in eng.submit_many(items)]
        one_wall = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = False
    # the two ranks
    from mxnet_tpu_torch.dist.spawn import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(os.path.join(root, "chip_smoke.py") + ":sharded_rank",
                      2, args=(tmp, seed, logits), timeout=600)
    spawn_s = time.perf_counter() - t0
    if any(r["backend"] != "gloo" for r in ranks):
        fail("two ranks sharing one card must take gloo")
    a = [r["a"] for r in ranks]
    # (a): the first step from the checkpoint (d) wrote after it
    with mt.checkpoint.CheckpointManager(os.path.join(tmp, "tp-ck"),
                                         keep_last_n=None) as m:
        tree, meta = m.restore()
    tp_first = {k: np.asarray(v) for k, v in tree["params"].items()}
    first_l2 = first_step_l2(tp_first, one_first[0], init)
    worst = sorted((first_step_l2({k: tp_first[k]}, {k: one_first[0][k]},
                                  {k: init[k]}), k) for k in init
                   if np.any(one_first[0][k] != init[k]))[-3:]
    same = a[0]["digest"] == a[1]["digest"]
    print("phase 22: two ranks on gpu(0) in %.1f s (backend %s)" % (
        spawn_s, ranks[0]["backend"]))
    print("sharded: (a) VGG-16 224x224 batch %d, fit(mesh=%r, sharding=%s) "
          "on two ranks: live shards %s, fc6 momentum %s; fused step %s; "
          "the first step's update against one process's, relative L2 "
          "%.3g (gate %.3g: %g x the one-ulp nudge's %.3g; largest tensors "
          "%s); the ranks' params equal after %d steps %s (gate); steps "
          "%s ms (one process %s ms); collectives %d calls, %d bytes, %.3f "
          "s host; card %s" % (
              TP_BATCH, TP_MESH, TP_SPECS, a[0]["shapes"], a[0]["mom_shape"],
              a[0]["fused"], first_l2, SCALE_RATIO * nudge_l2, SCALE_RATIO,
              nudge_l2, ["%s %.3g" % (k, v) for v, k in worst], TP_STEPS,
              same, ["%.1f" % v for v in a[0]["step_ms"]],
              ["%.1f" % v for v in one_ms[1:]], a[0]["calls"], a[0]["bytes"],
              a[0]["coll_s"], smi))
    print("sharded: (a) redistributions per op, first step: %s; all %d "
          "steps: %s" % (json.dumps(a[0]["stats_first"]), TP_STEPS,
                         json.dumps(a[0]["stats"])))
    print("sharded: (a) peak memory allocated: ranks %s MB, one process %.1f "
          "MB (its growth from this phase's start); card %s" % (
              ["%.1f" % (r["peak"] / 2 ** 20) for r in a],
              one_peak / 2 ** 20, smi))
    if a[0]["shapes"]["fc6_weight"] != (2048, 25088) or \
            a[0]["shapes"]["fc7_weight"] != (4096, 2048) or \
            a[0]["mom_shape"] != (2048, 25088):
        fail("(a) the ranks do not hold their shards: %s" % a[0]["shapes"])
    if first_l2 > SCALE_RATIO * nudge_l2:
        fail("(a) the first step differs from one process's: %.3g > %.3g"
             % (first_l2, SCALE_RATIO * nudge_l2))
    if not same:
        fail("(a) the ranks' params differ")
    # (d)
    files = ranks[0]["d", "files"]
    split = {p: sum(1 for f in files if f.endswith(".npy")
                    and f.split(".")[-3] == p) for p in ("p0", "p1")}
    want = sha_of(tp_first)
    want_opt = sha_of({k: np.asarray(v) for k, v in tree["opt"].items()
                       if not isinstance(v, (tuple, list))})
    mt.random.seed(seed)
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    it = vgg_batches(mt, xs[:1], ys[:1])
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in arg0.items()})
    mod.init_optimizer(optimizer_params=dict(TRAIN_OPT))
    t0 = time.perf_counter()
    with mt.checkpoint.CheckpointManager(os.path.join(tmp, "tp-ck"),
                                         keep_last_n=None) as m:
        mt.checkpoint.restore_module(m, mod)
    one_restore_s = time.perf_counter() - t0
    one_ok = sha_of(host_params(mod)[0]) == want and \
        sha_of(opt_host(torch, mod)) == want_opt
    del mod, tree
    gc.collect()
    torch.cuda.empty_cache()
    d_ok = {n: all(r["d", n]["params"] == want and r["d", n]["opt"] == want_opt
                   and r["d", n]["t"] == 1 for r in ranks)
            for n in ("tp2", "dp2")}
    print("sharded: (d) the save after the first step: process_count %s, "
          "%d files, p0 %d / p1 %d shard files (fc6 and fc7 and their "
          "momentum cut, the rest written once by p0); %.1f s for the "
          "first step with its save; restored bitwise (params and "
          "momentum) into one process %s (%.1f s), onto dp=2 %s (%.1f s, "
          "fc6 %s), into a fresh tp=2 run %s (%.1f s, fc6 %s); card %s" % (
              meta.get("process_count", 2), len(files), split["p0"],
              split["p1"], a[0]["first_s"], one_ok, one_restore_s,
              d_ok["dp2"], ranks[0]["d", "dp2"]["s"],
              ranks[0]["d", "dp2"]["fc6"], d_ok["tp2"],
              ranks[0]["d", "tp2"]["s"], ranks[0]["d", "tp2"]["fc6"], smi))
    if not (one_ok and d_ok["tp2"] and d_ok["dp2"]) or not split["p1"]:
        fail("(d) a restore is not bitwise, or p1 wrote nothing: %s %s %s"
             % (one_ok, d_ok, split))
    # (c)
    c = [r["c"] for r in ranks]
    s_l2 = first_step_l2(c[0]["first"], s_first, sarg)
    slots_ok = all(np.array_equal(r["slot"], one_slot) and
                   r["dropped"] == one_dropped for r in c)
    print("sharded: (c) Switch-Base-8 block (d_model %d, d_ff %d, %d "
          "experts, top-%d, capacity factor %g, %d tokens) at %s: each rank "
          "holds experts %s; the first step's update against one "
          "process's, relative L2 %.3g (gate %.3g: %g x the nudge's %.3g); "
          "ranks equal %s; routing %d tokens cut over dp=2 against one call "
          "on the card: slots and drops (%d) bitwise %s; card %s" % (
              SW_D, SW_H, SW_E, SW_K, SW_CF, SW_TOKENS, EP_MESH,
              c[0]["experts"], s_l2, SCALE_RATIO * s_nudge_l2, SCALE_RATIO,
              s_nudge_l2, c[0]["digest"] == c[1]["digest"], SW_TOKENS,
              int(one_dropped), slots_ok, smi))
    if c[0]["experts"] != (SW_E // 2, SW_D, SW_H) or \
            s_l2 > SCALE_RATIO * s_nudge_l2 or \
            c[0]["digest"] != c[1]["digest"] or not slots_ok:
        fail("(c) expert parallelism: experts %s, first step %.3g, slots %s"
             % (c[0]["experts"], s_l2, slots_ok))
    # (b)
    b = [r["b"] for r in ranks]
    answers, again, report = b[0]["answers"], b[0]["again"], b[0]["report"]
    worst_b = 0.0
    for i, (got, ref) in enumerate(zip(answers, refs)):
        tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(got - ref).max()) if got is not None else 1e30
        if got is None or not np.all(np.isfinite(got)) or err > tol:
            fail("(b) answer %d against the one-device engine: %.3g" % (i, err))
        worst_b = max(worst_b, err)
    for i, (got, ref) in enumerate(zip(again, answers[:8])):
        if float(np.abs(got - ref).max()) > 1e-4 * max(
                1.0, float(np.abs(ref).max())):
            fail("(b) answer %d after the reload differs" % i)
    served = report["batches"] + len(TP_SERVE_BUCKETS)
    fc_launches = [r["launches"]["fused_fc_epilogue"] for r in b]
    print("sharded: (b) ServeEngine(mesh='tp=2', param_specs=%s), fused "
          "(%d _fused_FullyConnected), buckets %s: each rank holds %s; %d "
          "requests in %.3f s (%.2f req/s; one device %.3f s), latency p50 "
          "%.3f ms p99 %.3f ms, %d batches; every answer within 1e-4 x "
          "max(1, max|y|) of the one-device engine (max abs err %.3g); "
          "reload to version %d keeps the shards %s and the answers; "
          "fused_fc_epilogue launched %s times on the ranks (2 a batch "
          "over %d batches incl. %d warm-up: fc6's column shard with its "
          "epilogue, fc7's row shard's partial product); on each rank's "
          "fc6 shard (8 x 25088 x 2048) against its plain version "
          "max_abs_err %s (tol %s); card %s" % (
              TP_SPECS, b[0]["fused_ops"], TP_SERVE_BUCKETS, b[0]["shard"],
              TP_SERVE_N, b[0]["wall"], TP_SERVE_N / b[0]["wall"], one_wall,
              report["latency_p50_ms"], report["latency_p99_ms"],
              report["batches"], worst_b, b[0]["version"],
              [r["shard_after_reload"] for r in b], fc_launches, served,
              len(TP_SERVE_BUCKETS),
              ["%.3g" % r["kernel_err"] for r in b],
              ["%.3g" % r["kernel_tol"] for r in b], smi))
    if b[0]["shard"]["fc6_weight"] != (2048, 25088) or \
            any(r["shard_after_reload"] != (2048, 25088) for r in b):
        fail("(b) the engine's fc6 is not cut: %s" % b[0]["shard"])
    if any(n != 2 * served for n in fc_launches):
        fail("(b) fused_fc_epilogue launched %s times, want 2 x %d on each "
             "rank" % (fc_launches, served))
    if any(r["kernel_err"] > r["kernel_tol"] for r in b):
        fail("(b) the fc kernel on a shard disagrees with its plain version")
    tmpdir.cleanup()
    took = time.perf_counter() - t_phase
    print("phase 22: %.1f s" % took)
    return {"fc_launches": sum(fc_launches), "step_ms": a[0]["step_ms"],
            "one_ms": one_ms[1:], "peak": [r["peak"] for r in a],
            "one_peak": one_peak, "serve_rps": TP_SERVE_N / b[0]["wall"],
            "seconds": took}


# -- phase 23: data parallelism's repairs, row-sharded tables, the fleet,
# replicas in other processes, a rank's rows staged ------------------------

P23_SEED = 230
P23_MLP_IN, P23_MLP_HID, P23_MLP_BATCH = 32, 64, 16
P23_DROP_ATOL = 1e-5                 # float32 sums of 8 rows + 8 against 16
P23_REC_VOCAB, P23_REC_DIM = 48, 8   # tests/test_embed.py's rec model
P23_REC_RTOL, P23_REC_ATOL = 2e-5, 1e-6    # its own tolerance (:335)
P23_REC_OPT = {"learning_rate": 0.5, "momentum": 0.9}
ROWS_VOCAB, ROWS_DIM, ROWS_BATCHES = 4_000_000, 64, 4
FLEET_VOCAB, FLEET_DIM, FLEET_BATCHES, FLEET_EPOCHS = 200_000, 32, 4, 2
FLEET_CHAOS = "points=dist.host@rank1,kinds=crash,after=5,max=1,attempts=0"
RPC_KEY = "chip-smoke-rpc"
RPC_REQUESTS = 32
ROUTER_KEYS = ("retried", "downs", "drains", "probes", "reinstated")
# a SIGKILL'd replica's requests wait this long for their admission ack
# before the router retries them (the reference's default is 30 s)
RPC_TIMEOUT_S = "5"
RPC_SHAPES = {"data": (1, 3, 224, 224), "softmax_label": (1,)}
P23_FEED_RECORDS, P23_FEED_BATCH = 256, 64


def p23_dropout_fit(mt, mesh=None):
    """An MLP with Dropout(0.5) between its FCs, 2 epochs of 4 batches
    of 16 on gpu(0) from a seed; -> host params."""
    net = mt.sym.FullyConnected(mt.sym.Variable("data"),
                                num_hidden=P23_MLP_HID, name="fc1")
    net = mt.sym.Dropout(mt.sym.Activation(net, act_type="relu"), p=0.5)
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        net, num_hidden=2, name="fc2"), name="softmax")
    arg0 = fan_in_params(net, {"data": (P23_MLP_BATCH, P23_MLP_IN),
                               "softmax_label": (P23_MLP_BATCH,)}, P23_SEED)
    rng = np.random.default_rng(P23_SEED + 1)
    X = rng.standard_normal((64, P23_MLP_IN)).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    mt.random.seed(P23_SEED + 2)
    mod = mt.mod.Module(net, context=mt.gpu(0))
    mod.fit(mt.io.NDArrayIter(X, y, batch_size=P23_MLP_BATCH), num_epoch=2,
            optimizer_params=dict(EMB_OPT), mesh=mesh,
            arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in arg0.items()})
    return host_params(mod)[0]


def p23_rec_fit(mt, mesh=None, sparse=True):
    """tests/test_embed.py's rec model (vocab 48, dim 8, batch 16, 3
    epochs, lr 0.5, momentum 0.9) on gpu(0); -> (host params, the fused
    step's sparse tables)."""
    sym = rec_symbol(mt, P23_REC_VOCAB, P23_REC_DIM, 16, 2)
    arg0 = fan_in_params(sym, {"ids": (16, 4), "softmax_label": (16,)},
                         P23_SEED + 3)
    rng = np.random.default_rng(P23_SEED + 4)
    arg0["embed_weight"] = (rng.standard_normal(
        (P23_REC_VOCAB, P23_REC_DIM)) * 0.5).astype(np.float32)
    X = rng.integers(0, P23_REC_VOCAB, (64, 4)).astype(np.float32)
    y = (X.sum(axis=1) % 2).astype(np.float32)
    with env_set("MXNET_EMBED_SPARSE", "1" if sparse else "0"):
        mod = mt.mod.Module(sym, data_names=("ids",), context=mt.gpu(0))
        mod.fit(mt.io.NDArrayIter(X, y, batch_size=16, data_name="ids"),
                num_epoch=3, optimizer_params=dict(P23_REC_OPT), mesh=mesh,
                arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                            for k, v in arg0.items()})
    return host_params(mod)[0], sorted(mod._fused.sparse_embeds)


def p23_rows_setup(torch, mt, vocab, dim, batches, seed):
    """bench_embed.py's rec tower (ids -> Embedding -> rfc1 + relu ->
    rfc2) over a vocab x dim table made on the card from a seed, and
    ``batches`` batches of 512 x 8 ids from 410 hot ids."""
    sym = rec_symbol(mt, vocab, dim, EMB_HIDDEN, 2, unique_cap=EMB_CAP)
    rng = np.random.default_rng(seed)
    X = hot_ids(rng, batches * EMB_B * EMB_L, EMB_HOT, vocab).reshape(
        batches * EMB_B, EMB_L).astype(np.float32)
    y = (X.sum(axis=1) % 2).astype(np.float32)
    tower = fan_in_params(rec_symbol(mt, 16, dim, EMB_HIDDEN, 2),
                          {"ids": (EMB_B, EMB_L), "softmax_label": (EMB_B,)},
                          seed + 1)
    tower.pop("embed_weight")
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    table = (torch.rand((vocab, dim), generator=gen, device="cuda") * 2
             - 1) * 0.05
    return sym, X, y, tower, table


def p23_rows_fit(torch, mt, mesh=None, sharding=None, checkpoint=None,
                 resume=False):
    """(b): the 4M x 64 tower, one epoch of 4 fused steps; -> the rows
    the batches name, the tower, a digest of every param, whether every
    other row kept its value, and the bytes of this rank's table and
    slots."""
    sym, X, y, tower, table = p23_rows_setup(
        torch, mt, ROWS_VOCAB, ROWS_DIM, ROWS_BATCHES, P23_SEED + 10)
    arg0 = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in tower.items()}
    arg0["embed_weight"] = mt.nd.NDArray(table)
    mod = mt.mod.Module(sym, data_names=("ids",), context=mt.gpu(0))
    t0 = time.perf_counter()
    mod.fit(mt.io.NDArrayIter(X, y, batch_size=EMB_B, data_name="ids"),
            num_epoch=1, optimizer_params=dict(EMB_OPT), mesh=mesh,
            sharding=sharding, arg_params=arg0, checkpoint=checkpoint,
            resume=resume)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fused = mod._fused
    mine = fused.state["params"]["embed_weight"]
    slots = [t for t in flatten_leaves(fused.state["opt"]["embed_weight"])]
    params = host_params(mod)[0]
    named = np.unique(X.astype(np.int64))
    keep = np.ones(ROWS_VOCAB, bool)
    keep[named] = False
    w = params["embed_weight"]
    untouched = bool(np.array_equal(w[keep], table.cpu().numpy()[keep]))
    out = {"named": w[named], "tower": {k: v for k, v in params.items()
                                        if k != "embed_weight"},
           "digest": sha_of(params), "untouched": untouched,
           "sparse": sorted(fused.sparse_embeds),
           "rows": tuple(mine.shape),
           "table_bytes": mine.numel() * mine.element_size(),
           "slot_bytes": sum(t.numel() * t.element_size() for t in slots),
           "wall_s": wall, "fused": fused.stats.report()}
    del mod, fused, mine, slots, params, w, table
    gc.collect()
    torch.cuda.empty_cache()
    return out


def flatten_leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in flatten_leaves(x)]
    return [tree]


def p23_feed_fit(torch, mt, rec, prefetch):
    """(e): ResNet-50 at batch 64 from ``rec`` (uint8 wire, cropped and
    mirrored on the card) over dp=2, one epoch of 4 steps; -> (digest of
    the params, bytes the prefetcher copied to the card, rows it staged,
    batches)."""
    sym, arg0, aux0, _b, _pd, _pl = resnet_setup(mt, 0, P23_SEED + 20)
    it = resnet_feed(mt, rec, batch_size=P23_FEED_BATCH, max_epochs=1,
                     to_device=False)
    seen = []
    mt.random.seed(P23_SEED + 21)
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    wrap = mod.prefetch_to_device

    def keep(*a, **kw):
        seen.append(wrap(*a, **kw))
        return seen[-1]
    mod.prefetch_to_device = keep
    try:
        mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.05,
                                                   "momentum": 0.9},
                mesh="dp=2", prefetch_to_device=prefetch,
                arg_params=arg0, aux_params=aux0)
    finally:
        it.close()
    h2d = seen[0].stats.report()["h2d"] if seen else {}
    out = (sha_of(host_params(mod)[0]), h2d.get("bytes", 0),
           h2d.get("items", 0), mod._fused.stats.report())
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    return out


def p23_rank(tmp, rec):
    """(a), (b) and (e) on one of two gloo ranks sharing gpu(0)."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.dist import boot
    from mxnet_tpu_torch.parallel import PartitionSpec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros(1, device="cuda")
    out = {"backend": boot.backend(), "rank": boot.rank()}
    out["dropout"] = p23_dropout_fit(mt, "dp=2")
    out["rec"] = p23_rec_fit(mt, "dp=2")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out["rows"] = p23_rows_fit(
        torch, mt, "dp=2", {"embed_weight": PartitionSpec("dp", None)},
        checkpoint=os.path.join(tmp, "rows-ck"))
    out["rows"]["peak"] = torch.cuda.max_memory_allocated() - base
    torch.backends.cudnn.deterministic = True
    out["feed_cut"] = p23_feed_fit(torch, mt, rec, True)
    out["feed_whole"] = p23_feed_fit(torch, mt, rec, False)
    return out


def fleet_worker(ckpt):
    """One rank of phase 23 (c): the 200k x 32 tower row-sharded over
    ``dp=-1`` on gpu(0), a checkpoint every step, ``resume=True``; writes
    the digest of its final params, then leaves after a barrier."""
    import hashlib
    import torch
    import mxnet_tpu_torch as mt          # joins the fleet's group
    from mxnet_tpu_torch.dist import boot
    from mxnet_tpu_torch.parallel import PartitionSpec, collectives, \
        make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    sym, X, y, tower, table = p23_rows_setup(
        torch, mt, FLEET_VOCAB, FLEET_DIM, FLEET_BATCHES, P23_SEED + 30)
    arg0 = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in tower.items()}
    arg0["embed_weight"] = mt.nd.NDArray(table)
    mesh = make_mesh([("dp", -1)])
    mt.random.seed(P23_SEED + 31)
    mod = mt.mod.Module(sym, data_names=("ids",), context=mt.gpu(0))
    mod.fit(mt.io.NDArrayIter(X, y, batch_size=EMB_B, data_name="ids"),
            num_epoch=FLEET_EPOCHS, optimizer_params=dict(EMB_OPT),
            mesh=mesh, sharding={"embed_weight": PartitionSpec("dp", None)},
            arg_params=arg0, checkpoint=ckpt, checkpoint_every=1,
            resume=True)
    params = host_params(mod)[0]
    h = hashlib.sha256()
    for n in sorted(params):
        h.update(n.encode())
        h.update(np.ascontiguousarray(params[n]).tobytes())
    with open(os.path.join(ckpt, "final_rank%d.txt" % boot.rank()),
              "w") as f:
        f.write("%s %d" % (h.hexdigest(),
                           mod._fused.state["params"]["embed_weight"]
                           .shape[0]))
    collectives.barrier(mesh.axis("dp"))
    boot.shutdown()


def fleet_run(mt, root, ckpt, faults=None):
    """A FleetSupervisor of two fleet_worker ranks; -> (report, finals)."""
    os.makedirs(ckpt, exist_ok=True)
    env = {"PYTHONPATH": root}
    if faults:
        env["MXNET_FAULTS"] = faults
    sup = mt.dist.FleetSupervisor(
        [sys.executable, os.path.join(root, "chip_smoke.py"),
         "--fleet-worker", ckpt], nworkers=2, checkpoint_dir=ckpt,
        timeout_s=300, env=env,
        backoff=mt.faults.Backoff(base_s=0.1, jitter=0.0))
    t0 = time.perf_counter()
    rc = sup.run()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail("fleet %s ended with rc %s" % (ckpt, rc))
    kinds = sorted({v["kind"] for v in mt.profiler.faults_report().values()})
    finals = {}
    for r in range(2):
        with open(os.path.join(ckpt, "final_rank%d.txt" % r)) as f:
            digest, rows = f.read().split()
        finals[r] = (digest, int(rows))
    return dict(sup.stats.report(), report_kinds=kinds), finals, wall


def rpc_child(prefix, count_path):
    """A cross-process replica of phase 23 (d): the fused float32 VGG-16
    ServeEngine on gpu(0) behind serve_engine.  It holds
    fused_fc_epilogue against its plain version on fc6, then counts its
    launches from 0, writing the count to ``count_path`` at each launch,
    and the engine's batches there when closed over the wire."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.dist.rpc import serve_engine
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ck.build()
    eng = mt.serve.ServeEngine.from_checkpoint(prefix, 0, RPC_SHAPES,
                                               fuse=True, name="rpc-vgg")
    saved = mt.nd.load("%s-0000.params" % prefix)
    w = saved["arg:fc6_weight"]._get().to("cuda")
    b = saved["arg:fc6_bias"]._get().to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(P23_SEED + 40)
    x = torch.rand((8, w.shape[1]), generator=gen, device="cuda") * 2 - 1
    got = ck.fused_fc_epilogue(x, w, b, "relu")
    want = ck.fused_fc_epilogue_reference(x, w, b, "relu")
    err = (got - want).abs().max().item()
    tol = 1e-4 * max(1.0, want.abs().max().item())
    print("rpc child %d: fc6 kernel check (8 x %d x %d, relu) max_abs_err "
          "%.3g tol %.3g" % (os.getpid(), w.shape[1], w.shape[0], err, tol),
          flush=True)
    if not err <= tol:
        print("rpc child: fc6 check failed", flush=True)
        sys.exit(3)
    del saved, w, b, x, got, want
    count = ck._count

    def write(text):
        with open(count_path + ".tmp", "w") as f:
            f.write(text)
        os.replace(count_path + ".tmp", count_path)

    def counted(name):
        count(name)
        write("%d" % ck.LAUNCHES["fused_fc_epilogue"])
    ck.reset_launches()
    ck._count = counted
    warm = eng.stats.report()["batches"]       # the buckets' warm-ups
    server = serve_engine(eng)
    print("RPC_READY %d" % server.port, flush=True)
    server.join()
    write("%d %d" % (ck.LAUNCHES["fused_fc_epilogue"],
                     eng.stats.report()["batches"] - warm))


def rpc_spawn(root, prefix, count_path, log_path):
    env = dict(os.environ, MXNET_DIST_RPC_AUTHKEY=RPC_KEY, PYTHONPATH=root)
    log = open(log_path, "w")
    proc = subprocess.Popen([sys.executable,
                             os.path.join(root, "chip_smoke.py"),
                             "--rpc-child", prefix, count_path],
                            stdout=log, stderr=subprocess.STDOUT, env=env)
    log.close()
    return proc


def rpc_ready(proc, log_path, timeout=300):
    """-> the child's port once it prints RPC_READY (fails if it dies)."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        with open(log_path) as f:
            text = f.read()
        for line in text.splitlines():
            if line.startswith("RPC_READY"):
                return int(line.split()[1]), text
        if proc.poll() is not None:
            fail("rpc child exited with %s:\n%s" % (proc.returncode,
                                                     text[-3000:]))
        time.sleep(0.2)
    fail("rpc child not ready in %d s" % timeout)


def rpc_flood(router, items, n_threads=4, during=None, after=8):
    """``items`` through ``router`` from client threads; ``during()``
    runs once ``after`` answers are in.  -> (answers, errors, wall)."""
    answers = [None] * len(items)
    errors = []
    done = threading.Semaphore(0)

    def client(idx):
        for i in range(idx, len(items), n_threads):
            try:
                answers[i] = router.submit(items[i]).result(timeout=300)
            except Exception as e:          # a dropped request
                errors.append(repr(e))
            done.release()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    if during is not None:
        for _ in range(after):
            done.acquire(timeout=300)
        during()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        fail("rpc flood: client threads still waiting")
    return answers, errors, time.perf_counter() - t0


def router_line(router):
    rep = router.stats.report()
    out = {k: rep[k] for k in ROUTER_KEYS}
    out["dispatched"] = [row["dispatched"]
                         for _i, row in sorted(rep["per_replica"].items())]
    return out


def rpc_phase(torch, mt, root, tmp, procs, smi):
    """(d): a ServeRouter over two RpcReplicas of the fused VGG-16."""
    from mxnet_tpu_torch.dist.rpc import RpcReplica
    prefix = os.path.join(tmp, "vgg16")
    ports = [rpc_ready(p, os.path.join(tmp, "rpc%d.log" % i))
             for i, p in enumerate(procs)]
    for i, (_port, text) in enumerate(ports):
        for line in text.splitlines():
            if "fc6 kernel check" in line:
                print("rpc: child %d: %s" % (i, line.split(": ", 1)[1]))
    rng = np.random.default_rng(P23_SEED + 41)
    items = [wire_to_nchw(rng.integers(0, 256, (224, 224, 3),
                                       dtype=np.uint8))
             for _ in range(RPC_REQUESTS)]
    with mt.serve.ServeEngine.from_checkpoint(prefix, 0, RPC_SHAPES,
                                              fuse=True,
                                              name="rpc-ref") as eng:
        refs, _ = serve_burst(eng, items)

    def connect(i):
        return RpcReplica(("127.0.0.1", ports[i][0]),
                          authkey=RPC_KEY.encode())
    router = mt.serve.ServeRouter(lambda i: connect(i), replicas=2,
                                  name="rpc-vgg", unhealthy_after=2,
                                  probe_after_s=0)
    worst, dropped = 0.0, 0
    walls = {}
    try:
        def check(label, answers, errors):
            nonlocal worst, dropped
            dropped += len(errors)
            for i, (a, r) in enumerate(zip(answers, refs)):
                if a is None:
                    continue
                if a.shape != r.shape or not np.allclose(a, r, rtol=1e-3,
                                                         atol=1e-6):
                    fail("rpc %s: answer %d differs from the in-process "
                         "engine's (max abs err %.3g)"
                         % (label, i, np.abs(a - r).max()))
                worst = max(worst, float(np.abs(a - r).max()))
            print("rpc %s: %d answered, %d dropped %s; replicas %s; "
                  "router %s" % (label, sum(a is not None for a in answers),
                                 len(errors), errors[:2],
                                 router.replica_states(),
                                 router_line(router)))
        answers, errors, walls["flood"] = rpc_flood(router, items)
        check("flood", answers, errors)

        def kill():
            t0 = time.perf_counter()
            procs[0].kill()
            procs[0].wait(timeout=120)
            walls["sigkill_to_exit"] = time.perf_counter() - t0
        answers, errors, walls["kill"] = rpc_flood(router, items,
                                                   during=kill)
        check("SIGKILL of child 0 mid-flood", answers, errors)
        if router.replica_states()[0] != "down":
            fail("rpc: the killed replica is %s, want down"
                 % router.replica_states()[0])
        router.restart(0, factory=lambda i: connect(2), timeout=300)

        def drain():
            router.restart(1, factory=lambda i: connect(3), timeout=300)
        answers, errors, walls["restart"] = rpc_flood(router, items,
                                                      during=drain)
        check("draining restart of replica 1 mid-flood", answers, errors)
        if router.replica_states() != ["live", "live"]:
            fail("rpc: replicas %s after the restarts"
                 % router.replica_states())
        stats = router_line(router)
    finally:
        router.close()
    for p in procs:
        try:
            p.wait(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    counts = []
    for i in range(len(procs)):
        with open(os.path.join(tmp, "rpc%d.count" % i)) as f:
            counts.append([int(v) for v in f.read().split()])
    launches = sum(c[0] for c in counts)
    for i, c in enumerate(counts):
        if i != 0 and (len(c) != 2 or c[0] != 2 * c[1]):
            fail("rpc child %d: %s fused_fc_epilogue launches and batches, "
                 "want 2 a batch" % (i, c))
    if dropped:
        fail("rpc: %d requests dropped" % dropped)
    print("rpc: 3 floods of %d requests, 0 dropped, answers within %.3g of "
          "the in-process engine's (rtol 1e-3, atol 1e-6); walls %s s "
          "(MXNET_DIST_RPC_TIMEOUT_S=%s); "
          "router %s; fused_fc_epilogue launches in the children %s "
          "(launches, batches; child 0 SIGKILL'd: its last count) = %d; "
          "card %s" % (RPC_REQUESTS, worst,
                       {k: round(v, 3) for k, v in walls.items()},
                       RPC_TIMEOUT_S,
                       stats,
                       counts, launches, smi))
    return {"launches": launches, "walls": walls, "worst": worst}


def p23_phase(torch, mt, ck, smi):
    print("phase 23: data parallelism's repairs, row-sharded tables, the "
          "fleet, replicas in other processes, a rank's rows staged; TF32 "
          "matmul=%s cudnn=%s; card %s" % (
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32, smi))
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmpdir = tempfile.TemporaryDirectory()
    tmp = tmpdir.name
    # (d)'s replicas start first: they build while the ranks run
    sym = mt.models.get_vgg(num_classes=1000)
    mt.model.save_checkpoint(
        os.path.join(tmp, "vgg16"), 0, sym,
        {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in xavier_params(
            sym, RPC_SHAPES, 0).items()}, {})
    procs = [rpc_spawn(root, os.path.join(tmp, "vgg16"),
                       os.path.join(tmp, "rpc%d.count" % i),
                       os.path.join(tmp, "rpc%d.log" % i)) for i in range(4)]
    try:
        out = p23_body(torch, mt, ck, smi, root, tmp, procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tmpdir.cleanup()
    out["wall_s"] = time.perf_counter() - t_phase
    print("phase 23: %.1f s" % out["wall_s"])
    return out


def p23_body(torch, mt, ck, smi, root, tmp, procs):
    rec = os.path.join(tmp, "feed.rec")
    write_feed_rec(mt, rec, n=P23_FEED_RECORDS)
    # the one-process runs on this process's card
    one_drop = p23_dropout_fit(mt)
    one_rec, one_sparse = p23_rec_fit(mt)
    dense_rec, _ = p23_rec_fit(mt, sparse=False)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    one_rows = p23_rows_fit(torch, mt)
    one_rows["peak"] = torch.cuda.max_memory_allocated() - base
    from mxnet_tpu_torch.dist.spawn import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(os.path.join(root, "chip_smoke.py") + ":p23_rank", 2,
                      args=(tmp, rec), timeout=900)
    ranks_s = time.perf_counter() - t0
    if any(r["backend"] != "gloo" for r in ranks):
        fail("two ranks sharing one card must take gloo")
    # (a) the repairs
    drop_err = max(float(np.abs(r["dropout"][k] - one_drop[k]).max())
                   for r in ranks for k in one_drop)
    print("repairs (a): Dropout at dp=2 against one process with the same "
          "seed: max abs diff %.3g (gate %g)" % (drop_err, P23_DROP_ATOL))
    if not drop_err <= P23_DROP_ATOL:
        fail("Dropout over dp=2 draws another mask than one device")
    rec_worst = worst_rel([r["rec"][0] for r in ranks], [one_rec, one_rec],
                          P23_REC_ATOL)
    dense_gap = max(float(np.abs(dense_rec[k] - one_rec[k]).max())
                    for k in one_rec)
    print("repairs (a): the rec model at dp=2 trains %s lazily, within "
          "rtol %.3g at atol %g of one process's lazy fit (gate rtol %g); "
          "the dense update (MXNET_EMBED_SPARSE=0, what dp=2 trained "
          "before) is %.3g away" % (ranks[0]["rec"][1], rec_worst,
                                    P23_REC_ATOL, P23_REC_RTOL, dense_gap))
    if not all(r["rec"][1] == ["embed_weight"] for r in ranks) or \
            one_sparse != ["embed_weight"] or \
            not params_close([r["rec"][0] for r in ranks],
                             [one_rec, one_rec], P23_REC_RTOL, P23_REC_ATOL):
        fail("the rec model over dp=2 is not one device's lazy fit")
    # (b) the row-sharded 4M x 64 table
    rows = [r["rows"] for r in ranks]
    for r in rows:
        if r["sparse"] != ["embed_weight"] or \
                r["rows"] != (ROWS_VOCAB // 2, ROWS_DIM) or \
                not r["untouched"]:
            fail("row-sharded table: %s" % {k: r[k] for k in (
                "sparse", "rows", "untouched")})
    rows_worst = worst_rel(
        [dict(r["tower"], named=r["named"]) for r in rows],
        [dict(one_rows["tower"], named=one_rows["named"])] * 2,
        P23_REC_ATOL)
    if not params_close([dict(r["tower"], named=r["named"]) for r in rows],
                        [dict(one_rows["tower"], named=one_rows["named"])]
                        * 2, P23_REC_RTOL, P23_REC_ATOL):
        fail("row-sharded 4M x 64 steps depart from one process's")
    if rows[0]["digest"] != rows[1]["digest"]:
        fail("the two ranks gathered different params")
    # the ranks' save restored into one process, bitwise
    restored = p23_rows_fit(torch, mt, checkpoint=os.path.join(
        tmp, "rows-ck"), resume=True)
    if restored["digest"] != rows[0]["digest"]:
        fail("the row-sharded save restored into one process is not "
             "bitwise the ranks' state")
    print("rows (b): 4M x 64 row-sharded at dp=2: each rank holds %s rows, "
          "%d table bytes + %d slot bytes (one process %d + %d); %d steps "
          "within rtol %.3g at atol %g of one process's (gate rtol %g), "
          "untouched rows bitwise; fused %s; the save restored into one "
          "process bitwise; peak memory above the memory before the leg %.1f "
          "MB a rank against %.1f MB; fit wall "
          "%.2f s a rank against %.2f s; card %s" % (
              rows[0]["rows"], rows[0]["table_bytes"], rows[0]["slot_bytes"],
              one_rows["table_bytes"], one_rows["slot_bytes"], ROWS_BATCHES,
              rows_worst, P23_REC_ATOL, P23_REC_RTOL, rows[0]["fused"],
              max(r["peak"] for r in rows) / 2 ** 20,
              one_rows["peak"] / 2 ** 20, max(r["wall_s"] for r in rows),
              one_rows["wall_s"], smi))
    # (e) a rank's rows staged
    cut, whole = [r["feed_cut"] for r in ranks], [r["feed_whole"]
                                                  for r in ranks]
    global_bytes = P23_FEED_BATCH * FEED_SIDE * FEED_SIDE * 3 + \
        P23_FEED_BATCH * 4
    batches = P23_FEED_RECORDS // P23_FEED_BATCH
    for c, w in zip(cut, whole):
        if c[0] != w[0]:
            fail("a rank's rows staged by the feed change the trajectory")
        if c[1] * 2 != global_bytes * batches or \
                c[2] * 2 != P23_FEED_RECORDS:
            fail("feed (e): a rank staged %d bytes and %d rows, want half "
                 "of %d bytes and %d rows" % (c[1], c[2],
                                              global_bytes * batches,
                                              P23_FEED_RECORDS))
    print("feed (e): ResNet-50 from a .rec at batch %d over dp=2: each rank "
          "copied %d bytes a batch to the card (the global batch's %d), "
          "%d rows of %d; trajectory bitwise the one of make_batch cutting "
          "the global batch; fused %s" % (
              P23_FEED_BATCH, cut[0][1] // batches, global_bytes,
              cut[0][2], P23_FEED_RECORDS, cut[0][3]))
    print("ranks (a, b, e): %.1f s" % ranks_s)
    # (c) the fleet
    ok, ok_finals, ok_wall = fleet_run(mt, root, os.path.join(tmp, "ok"))
    chaos, finals, chaos_wall = fleet_run(mt, root, os.path.join(
        tmp, "chaos"), faults=FLEET_CHAOS)
    if ok["restarts"] != 0 or chaos["restarts"] < 1 or \
            chaos["lost_hosts"] < 1:
        fail("fleet: fault-free %s, chaos %s" % (ok, chaos))
    if not (finals[0][0] == finals[1][0] == ok_finals[0][0]
            == ok_finals[1][0]):
        fail("fleet: the recovered run is not bitwise the fault-free one: "
             "%s vs %s" % (finals, ok_finals))
    print("fleet (c): 200k x 32 tower row-sharded (%d rows a rank) over 2 "
          "ranks, %d steps, a commit every step; %s on rank 1: %d restart, "
          "%d lost host, recovery_s %.3f, final params bitwise the "
          "fault-free run's; walls %.1f s fault-free, %.1f s with the "
          "crash; faults_report kinds %s" % (
              finals[0][1], FLEET_BATCHES * FLEET_EPOCHS, FLEET_CHAOS,
              chaos["restarts"], chaos["lost_hosts"], chaos["recovery_s"],
              ok_wall, chaos_wall, chaos["report_kinds"]))
    # (d) replicas in other processes
    with env_set("MXNET_DIST_RPC_TIMEOUT_S", RPC_TIMEOUT_S):
        rpc = rpc_phase(torch, mt, root, tmp, procs, smi)
    return {"rpc": rpc, "fleet": chaos, "rows": rows, "one_rows": one_rows,
            "feed": cut, "drop_err": drop_err, "rec_worst": rec_worst}


# ---------------------------------------------------------------------------
# phase 24: compile and tuning
#
# (a) cold start: three fresh processes serve a small MLP whose fc1 runs
#     fused_fc_epilogue, over one MXNET_COMPILE_CACHE directory made here:
#     the first builds the library (one nvcc), the second loads it (zero),
#     the third meets a truncated entry planted in a copy of the store,
#     warns, rebuilds and answers the same;
# (b) search_fc at VGG-16's fc6 and fc7 at bucket 8 and search_paged at
#     GPT-2 small's class (bt 16, D 64, causal; 16 slots, C 1), every
#     candidate gated and measured, a second search a store hit, then the
#     winners at call time under MXNET_KERNEL_SEARCH=1 with phase 6's
#     layout gates and phase 7's paged == dense-stripe streams;
# (c) fit(autotune=True) and ("joint") on phase 18's PTB LSTM at batch 32:
#     the tuners leave the train state bitwise, the K chosen and the
#     tokens/s of the winner and of K=1;
# (d) ResNet-50 at batch 128: the first step's wall with and without
#     prepare(), captures in the loop after prepare() (0), the state after
#     prepare() bitwise, the step time and peak memory under
#     MXNET_BACKWARD_DO_MIRROR=1 against without, its first step within
#     P24_REMAT_REL_L2; eight small modules prepared by eight threads
#     against one thread, bitwise.

P24_MLP = (64, 256, 10)                 # the cold children's MLP widths
P24_FC = {"fc6": (8, 25088, 4096), "fc7": (8, 4096, 4096)}
P24_PAGED = dict(s=16, c=1, h=12, d=64, n_blocks=16 * 64 + 1, bt=16)
P24_LM_STREAMS, P24_LM_NEW = 8, 16
P24_RESNET_STEPS = 6
# ResNet-50's first step with the forward rematerialized against without,
# both under deterministic cuDNN: the same kernels on the same inputs
P24_REMAT_REL_L2 = 1e-5
P24_THREADS = 8


def cold_child(store):
    """``chip_smoke.py --cold-child``: serve a first answer from the MLP
    through ServeEngine(fuse=True) on gpu(0) with the compile cache at
    MXNET_COMPILE_CACHE; print one JSON line."""
    t0 = time.perf_counter()
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    d_in, hid, out = P24_MLP
    sym = mt.sym.Variable("data")
    sym = mt.sym.FullyConnected(sym, num_hidden=hid, name="fc1")
    sym = mt.sym.Activation(sym, act_type="relu", name="relu1")
    sym = mt.sym.FullyConnected(sym, num_hidden=out, name="fc2")
    sym = mt.sym.SoftmaxOutput(sym, name="softmax")
    rng = np.random.RandomState(24)
    params = {"fc1_weight": rng.randn(hid, d_in) * 0.1,
              "fc1_bias": rng.randn(hid) * 0.1,
              "fc2_weight": rng.randn(out, hid) * 0.1,
              "fc2_bias": rng.randn(out) * 0.1}
    params = {k: mt.nd.array(v.astype(np.float32), ctx=mt.cpu())
              for k, v in params.items()}
    x = rng.randn(d_in).astype(np.float32)
    eng = mt.serve.ServeEngine(sym, params, {"data": (1, d_in),
                                             "softmax_label": (1,)},
                               batch_buckets=(1, 2), fuse=True)
    try:
        ans = eng.predict(x, timeout=300)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        eng.close()
    rep = mt.profiler.compile_report()
    print("COLD " + json.dumps({
        "wall_s": wall, "nvcc_runs": ck.NVCC_RUNS,
        "nvcc_s": ck.BUILD_WALLS.get("fused_fc_epilogue"),
        "answer": [float(v) for v in np.asarray(ans).ravel()],
        "fc_launches": ck.LAUNCHES["fused_fc_epilogue"],
        "kernel": rep["per_program"].get("kernel:fused_fc_epilogue"),
        "cache": rep.get("cache")}))


def cold_run(root, store, label):
    env = dict(os.environ, MXNET_COMPILE_CACHE=store, PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.join(
        root, "chip_smoke.py"), "--cold-child", store], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, t0, label


def cold_wait(run):
    proc, t0, label = run
    out, err = proc.communicate(timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or "COLD " not in out:
        fail("cold child %s exited %d: %s" % (label, proc.returncode,
                                               err[-3000:]))
    res = json.loads(out.split("COLD ", 1)[1].splitlines()[0])
    res["process_s"] = wall
    res["warned"] = "unreadable" in err
    return res


def cold_start(root, tmp, smi):
    """(a): -> the three children's results."""
    from mxnet_tpu_torch.compile_cache.store import CacheStore
    store = os.path.join(tmp, "cc")
    first = cold_wait(cold_run(root, store, "first"))
    st = CacheStore(store, 2048)
    entries, nbytes = st.entry_count(), st.disk_bytes()
    # a copy of the store with the library's blob cut in half
    import shutil
    bad = os.path.join(tmp, "cc-truncated")
    shutil.copytree(store, bad)
    exes = [n for n in os.listdir(bad) if n.endswith(".exe")]
    for n in exes:
        path = os.path.join(bad, n)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    second, third = (cold_wait(r) for r in (
        cold_run(root, store, "second"), cold_run(root, bad, "truncated")))
    for label, r in (("first", first), ("second", second),
                     ("truncated", third)):
        print("cold-start (a) %-9s wall to first answer %.2f s (process "
              "%.2f s), nvcc invocations %d (library %s), fc launches %d, "
              "warned %s; store %s" % (
                  label, r["wall_s"], r["process_s"], r["nvcc_runs"],
                  "%.2f s nvcc" % r["nvcc_s"] if r["nvcc_s"] else
                  "from the store", r["fc_launches"], r["warned"],
                  json.dumps(r["cache"])))
    print("cold-start (a): store after the first child: %d entries, %d "
          "bytes (%d library blobs); card %s" % (entries, nbytes, len(exes),
                                                  smi))
    if first["nvcc_runs"] != 1 or second["nvcc_runs"] != 0:
        fail("cold start: nvcc ran %d and %d times in the first and second "
             "child, want 1 and 0" % (first["nvcc_runs"],
                                      second["nvcc_runs"]))
    if third["nvcc_runs"] != 1 or not third["warned"]:
        fail("cold start: the truncated entry was not warned about and "
             "rebuilt (nvcc %d, warned %s)" % (third["nvcc_runs"],
                                               third["warned"]))
    if not (first["answer"] == second["answer"] == third["answer"]) or \
            min(r["fc_launches"] for r in (first, second, third)) < 1:
        fail("cold start: answers differ or fc kernel not launched")
    return {"children": [first, second, third], "entries": entries,
            "bytes": nbytes,
            "fc_launches": sum(r["fc_launches"]
                               for r in (first, second, third))}


def search_report(mt, label, cls):
    r = mt.autotune.recent_stats()[-1].report()
    for cfg, cost in r["trials"]:
        print("tuning (b) %s candidate %-40s gate %s, %s" % (
            label, json.dumps({k: v for k, v in sorted(cfg.items())
                               if k not in ("_feat", "est_s", "parity",
                                            "shortlisted")}),
            "failed" if cfg.get("parity") is False else "passed",
            "%.6f ms" % (cost * 1e3) if cost > 0 else "not measured"))
    return r


def searches(torch, mt, ck, smi):
    """(b): -> the winners, their times and the call-time launches."""
    ks = mt.autotune.kernelsearch
    dev = torch.device("cuda", 0)
    out = {"winners": {}, "launches": {}}
    fails0 = ks.parity_fail_total()
    for name, (m, k, n) in P24_FC.items():
        t0 = time.perf_counter()
        win = ks.search_fc(m, k, n, act_type="relu",
                           shortlist=len(ck.FC_TILES))
        wall = time.perf_counter() - t0
        r = search_report(mt, name, None)
        costs = {c["block_n"]: s for c, s in r["trials"] if s > 0}
        win2 = ks.search_fc(m, k, n, act_type="relu",
                            shortlist=len(ck.FC_TILES))
        r2 = mt.autotune.recent_stats()[-1].report()
        print("tuning (b) search_fc %s (M %d, K %d, N %d, relu, float32) in "
              "%.2f s: winner %s at %.4f ms against the default tile %d at "
              "%.4f ms; second search %s with calls %s; card %s" % (
                  name, m, k, n, wall, win, costs[win["block_n"]] * 1e3,
                  ck.FC_DEFAULT_TILE, costs[ck.FC_DEFAULT_TILE] * 1e3,
                  r2["source"], r2["calls"], smi))
        if r2["source"] != "cache" or any(r2["calls"].values()) or \
                win2 != win or len(costs) != len(ck.FC_TILES):
            fail("search_fc %s: second search not a store hit, or a "
                 "candidate unmeasured: %s" % (name, r2))
        out["winners"][name] = dict(win, ms=costs[win["block_n"]] * 1e3,
                                    times_ms={b: c * 1e3 for b, c in
                                              costs.items()})
    p = P24_PAGED
    t0 = time.perf_counter()
    win = ks.search_paged(p["s"], p["c"], p["h"], p["d"],
                          n_blocks=p["n_blocks"], bt=p["bt"], causal=True,
                          shortlist=len(ck.PAGED_PART_KEYS))
    wall = time.perf_counter() - t0
    r = search_report(mt, "paged", None)
    costs = {c["part_keys"]: s for c, s in r["trials"] if s > 0}
    win2 = ks.search_paged(p["s"], p["c"], p["h"], p["d"],
                           n_blocks=p["n_blocks"], bt=p["bt"], causal=True)
    r2 = mt.autotune.recent_stats()[-1].report()
    print("tuning (b) search_paged (S %d, C %d, H %d, D %d, bt %d, causal) "
          "in %.2f s: winner %s at %.4f ms against the default %d keys at "
          "%.4f ms; second search %s with calls %s" % (
              p["s"], p["c"], p["h"], p["d"], p["bt"], wall, win,
              costs[win["part_keys"]] * 1e3, ck.PAGED_PARTITION_KEYS,
              costs[ck.PAGED_PARTITION_KEYS] * 1e3, r2["source"],
              r2["calls"]))
    if r2["source"] != "cache" or any(r2["calls"].values()) or \
            win2 != win or len(costs) != len(ck.PAGED_PART_KEYS):
        fail("search_paged: second search not a store hit, or a candidate "
             "unmeasured: %s" % r2)
    out["winners"]["paged"] = dict(win, ms=costs[win["part_keys"]] * 1e3,
                                   times_ms=costs and {
                                       pk: c * 1e3 for pk, c in
                                       costs.items()})
    if ks.parity_fail_total() != fails0:
        fail("a candidate failed its gate")

    out["tile_ms"] = tile_times(torch, ck, smi)
    tm, pw = out["tile_ms"], win["part_keys"]
    print("tuning (b) the winners at the kernel rows' clock (time_ms): fc6 "
          "+ fc7 %.4f ms at fc6's block_n %d, %.4f at fc7's %d, %.4f at the "
          "default %d; paged C=1 %.4f ms at part_keys %d against %.4f at "
          "the default %d" % (
              tm["fc"][out["winners"]["fc6"]["block_n"]],
              out["winners"]["fc6"]["block_n"],
              tm["fc"][out["winners"]["fc7"]["block_n"]],
              out["winners"]["fc7"]["block_n"],
              tm["fc"][ck.FC_DEFAULT_TILE], ck.FC_DEFAULT_TILE,
              tm["paged"]["C1/%d" % pw], pw,
              tm["paged"]["C1/%d" % ck.PAGED_PARTITION_KEYS],
              ck.PAGED_PARTITION_KEYS))

    # call time: the winners launch
    os.environ["MXNET_KERNEL_SEARCH"] = "1"
    ks._best_cache.clear()
    ck.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(24)
    for name, (m, k, n) in P24_FC.items():
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev) * 0.01
        b = torch.randn((n,), generator=gen, device=dev)
        tile = ck.fc_tile(x, w, "relu", False)
        y = ck.fused_fc_epilogue(x, w, b, "relu")
        y0 = ck.fused_fc_epilogue(x, w, b, "relu",
                                  block_n=ck.FC_DEFAULT_TILE)
        torch.cuda.synchronize()
        print("tuning (b) %s at call time: block_n %d (winner %d), output "
              "bitwise equal to the default tile's %s" % (
                  name, tile, out["winners"][name]["block_n"],
                  torch.equal(y, y0)))
        if tile != out["winners"][name]["block_n"] or not torch.equal(y, y0):
            fail("%s: the winner was not resolved or changed the output"
                 % name)
    cap = (p["n_blocks"] - 1) // p["s"] * p["bt"]
    pk = ck.paged_part_keys(p["bt"], p["d"], True, torch.float32, cap, dev)
    if pk != win["part_keys"]:
        fail("paged: call time resolved %d, the winner is %d"
             % (pk, win["part_keys"]))
    print("tuning (b) paged at call time: part_keys %d (0: one pass); "
          "phase 6's layout gates with the winner loaded:" % pk)
    paged_layout_checks(torch, ck, dev)
    lm_streams_with_winner(torch, ck)
    out["launches"] = dict(ck.LAUNCHES)
    print("tuning (b) launches under MXNET_KERNEL_SEARCH=1: %s"
          % json.dumps(out["launches"]))
    return out


def tile_times(torch, ck, smi):
    """Every candidate timed as phase 3 and phase 6 time the kernels
    (``time_ms``: CUDA events, L2 flushed): fc6 + fc7 of one bucket-8
    batch per block_n, and the C = 1 and C = 9 time cases per partition
    length."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.zeros(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    fcs = []
    for k in (25088, 4096):
        x = (torch.rand((8, k), generator=gen, device=dev) * 2 - 1)
        w = (torch.rand((4096, k), generator=gen, device=dev) * 2 - 1) / \
            math.sqrt(k)
        b = (torch.rand((4096,), generator=gen, device=dev) * 2 - 1) * 0.1
        fcs.append((x, w, b))
    out = {"fc": {}, "paged": {}}
    for bn in ck.FC_TILES:
        out["fc"][bn] = time_ms(torch, lambda: [ck.fused_fc_epilogue(
            x, w, b, "relu", block_n=bn) for x, w, b in fcs], flush)
    for c in (1, 9):
        case = paged_time_case(torch, dev, c)
        for pk in ck.PAGED_PART_KEYS:
            out["paged"]["C%d/%d" % (c, pk)] = time_ms(
                torch, lambda: ck.paged_attention(*paged_args(case),
                                                  part_keys=pk), flush)
        del case
    del flush
    print("tuning (b) kernel time fc6 + fc7 (bucket 8) by block_n, ms: %s; "
          "paged_attention at phase 6's C=1 and C=9 cases by part_keys (0: "
          "one pass), ms: %s; card %s" % (
              json.dumps({str(k): round(v, 4) for k, v in
                          out["fc"].items()}),
              json.dumps({k: round(v, 4) for k, v in out["paged"].items()}),
              smi))
    return out


def lm_streams_with_winner(torch, ck):
    """Phase 7's gate, paged streams bitwise the dense-stripe streams, at
    P24_LM_STREAMS streams of P24_LM_NEW tokens, one client submitting."""
    from mxnet_tpu_torch.serve import (LMConfig, PagedDecodeEngine,
                                       init_lm_params)
    cfg = LMConfig(**LM_GEOMETRY)
    params = init_lm_params(cfg, seed=0, scale=0.005)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=LM_PROMPT_LENS[i]).astype(
        np.int64) for i in range(P24_LM_STREAMS)]
    streams = {}
    for label, kw in (("paged", dict(num_blocks=LM_POOL_BLOCKS)),
                      ("dense", dict(paged=False))):
        eng = PagedDecodeEngine(params, cfg, num_slots=LM_SLOTS,
                                block_tokens=LM_BLOCK_TOKENS,
                                max_new_tokens=P24_LM_NEW,
                                chunk_tokens=LM_CHUNK, name="p24-" + label,
                                **kw)
        try:
            futs = [eng.submit(pr, max_new_tokens=P24_LM_NEW)
                    for pr in prompts]
            streams[label] = [f.result(timeout=300) for f in futs]
        finally:
            eng.close()
        del eng
        torch.cuda.empty_cache()
    same = all(np.array_equal(a, b) for a, b in zip(streams["paged"],
                                                    streams["dense"]))
    print("tuning (b) llm: %d paged streams of %d tokens equal the "
          "dense-stripe streams bitwise %s" % (P24_LM_STREAMS, P24_LM_NEW,
                                              same))
    if not same:
        fail("with the paged winner loaded the paged streams differ from "
             "the dense-stripe streams")


def state_digest(torch, fused):
    """The train state as host arrays (params, fixed, aux, optimizer
    slots, t) and the card generator's state."""
    from mxnet_tpu_torch.module.fused import flatten_tensors
    out = {}
    for g in ("params", "fixed", "aux", "opt"):
        for n, v in fused.state[g].items():
            for i, t in enumerate(flatten_tensors(v)):
                if isinstance(t, torch.Tensor):
                    out["%s/%s/%d" % (g, n, i)] = t.detach().cpu().numpy()
    out["t"] = fused.state["t"].cpu().numpy()
    out["rng"] = torch.cuda.get_rng_state().numpy()
    return out


def fit_tuning(torch, mt, smi):
    """(c): the tuners on the PTB LSTM at batch 32 leave the state
    bitwise; fit(autotune=...) loads the winners; tokens/s of the winner
    and of K=1."""
    arg0 = lstm_params(mt, LSTM_HIDDEN, 30)
    rng = np.random.default_rng(31)
    batches = [token_batch(mt, rng, mt.cpu(), SUPER_BATCH, LSTM_SEQ,
                           LSTM_HIDDEN) for _ in range(SUPER_BATCHES)]
    states = lstm_states(SUPER_BATCH, LSTM_HIDDEN)
    pd = [("data", (SUPER_BATCH, LSTM_SEQ))] + states
    pl = [("softmax_label", (SUPER_BATCH, LSTM_SEQ))]
    sym = mt.models.lstm_unroll(LSTM_LAYERS, LSTM_SEQ, LSTM_VOCAB,
                                LSTM_HIDDEN, LSTM_HIDDEN, LSTM_VOCAB)
    tokens = SUPER_BATCHES * SUPER_BATCH * LSTM_SEQ

    def module():
        mt.random.seed(5)
        mod = mt.mod.Module(sym, data_names=["data"] + [n for n, _ in
                                                        states],
                            label_names=["softmax_label"], context=mt.gpu(0))
        mod.bind(pd, pl)
        mod.init_params(arg_params=arg0, aux_params={})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=dict(LSTM_OPT))
        return mod

    def fit(mod, **kw):
        metric = time_major_ce(mt)
        marks = []

        def epoch_end(epoch, s, a, x):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        mod.fit(batch_iter(mt, batches, pd, pl), num_epoch=2,
                eval_metric=metric, optimizer="sgd",
                optimizer_params=dict(LSTM_OPT), epoch_end_callback=epoch_end,
                **kw)
        return tokens / (marks[1] - marks[0])

    out = {}
    for mode, tune in (("measure", mt.autotune.tune_superstep),
                       ("joint", mt.autotune.tune_fit_joint)):
        mod = module()
        before = state_digest(torch, mod._fused)
        t0 = time.perf_counter()
        cfg = tune(mod, viable=lambda k, _m=mod: _m._superstep_blockers(
            time_major_ce(mt), k))
        wall = time.perf_counter() - t0
        after = state_digest(torch, mod._fused)
        same = bitwise(before, after)
        r = mt.autotune.recent_stats()[-1].report()
        k = cfg if isinstance(cfg, int) else cfg["superstep"]
        print("tuning (c) %s: %s chose %s in %.2f s (%d measured); state "
              "after tuning bitwise the state before %s" % (
                  mode, r["tuner"], cfg, wall, r["calls"]["measure"]
                  if mode == "joint" else len(r["trials"]), same))
        for c, cost in r["trials"]:
            if cost > 0:
                print("tuning (c) %s   %-50s %.4f ms a step" % (
                    mode, json.dumps({a: v for a, v in sorted(c.items())
                                      if a not in ("_feat", "est_s")}),
                    cost * 1e3))
        if not same:
            fail("tuning (%s) changed the train state" % mode)
        del mod
        mod = module()
        rate = fit(mod, autotune=True if mode == "measure" else "joint")
        r2 = mt.autotune.recent_stats()[-1].report()
        if r2["source"] != "cache":
            fail("fit(autotune=%s) did not load the stored winner" % mode)
        out[mode] = {"k": k, "tokens_s": rate, "cfg": cfg,
                     "remat": bool(mod._fused._remat)}
        del mod
    rate1 = fit(module(), superstep=1)
    print("tuning (c) fit tokens/s (2nd epoch): autotune=True K=%d %.1f, "
          "autotune=\"joint\" K=%d (remat %s) %.1f, K=1 %.1f; card %s" % (
              out["measure"]["k"], out["measure"]["tokens_s"],
              out["joint"]["k"], out["joint"]["remat"],
              out["joint"]["tokens_s"], rate1, smi))
    out["k1_tokens_s"] = rate1
    gc.collect()
    torch.cuda.empty_cache()
    return out


def resnet_prepare_remat(torch, mt, smi):
    """(d): -> walls, captures, step times and peaks."""
    sym, arg0, aux0, batches, pd, pl = resnet_setup(mt, 2, 24)
    staged = [mt.io.DataBatch(
        data=[mt.nd.array(b.data[0].asnumpy(), ctx=mt.gpu(0))],
        label=[mt.nd.array(b.label[0].asnumpy(), ctx=mt.gpu(0))])
        for b in batches]

    def module():
        mod = mt.mod.Module(sym, context=mt.gpu(0))
        mod.bind(pd, pl)
        mod.init_params(arg_params=arg0, aux_params=aux0)
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(TRAIN_OPT))
        return mod

    def step(mod, b):
        mod.forward(b, is_train=True)
        mod.update()

    def run(remat=False, prepare=False):
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if remat:
            os.environ["MXNET_BACKWARD_DO_MIRROR"] = "1"
        try:
            mod = module()
        finally:
            os.environ.pop("MXNET_BACKWARD_DO_MIRROR", None)
        res = {"remat": bool(mod._fused._remat)}
        if prepare:
            before = state_digest(torch, mod._fused)
            t0 = time.perf_counter()
            mod.prepare()
            torch.cuda.synchronize()
            res["prepare_s"] = time.perf_counter() - t0
            res["prepare_bitwise"] = bitwise(before,
                                             state_digest(torch, mod._fused))
        captures0 = mod._fused.stats.captures
        t0 = time.perf_counter()
        step(mod, staged[0])
        torch.cuda.synchronize()
        res["first_step_s"] = time.perf_counter() - t0
        res["after_first"] = host_params(mod)
        for i in range(1, P24_RESNET_STEPS):
            step(mod, staged[i % 2])
        torch.cuda.synchronize()
        res["captures_in_loop"] = mod._fused.stats.captures - captures0
        t0 = time.perf_counter()
        for i in range(4):
            step(mod, staged[i % 2])
        torch.cuda.synchronize()
        res["step_ms"] = (time.perf_counter() - t0) * 1e3 / 4
        res["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        res["stats"] = mod._fused.stats.report()
        del mod
        return res

    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = run()
        prepared = run(prepare=True)
        remat = run(remat=True)
    finally:
        torch.backends.cudnn.deterministic = cudnn
    d = rel_l2(remat["after_first"], plain["after_first"])
    same_first = rel_l2(prepared["after_first"], plain["after_first"])
    print("resnet (d) first step wall: without prepare() %.3f s (an eager "
          "warm-up step), after prepare() %.3f s (a replay; prepare took "
          "%.2f s and left the state bitwise %s); captures inside the loop "
          "after prepare() %d; its first step against the plain run's: "
          "relative L2 %.3g" % (
              plain["first_step_s"], prepared["first_step_s"],
              prepared["prepare_s"], prepared["prepare_bitwise"],
              prepared["captures_in_loop"], same_first))
    print("resnet (d) MXNET_BACKWARD_DO_MIRROR=1 (the whole loss under "
          "torch.utils.checkpoint): step %.2f ms against %.2f ms, peak "
          "memory allocated %.1f MB against %.1f MB (module, warm-up, "
          "capture and %d steps, deterministic cuDNN); first step's params "
          "and aux against the plain run's: relative L2 %.3g (gate %g); "
          "graph stats %s; card %s" % (
              remat["step_ms"], plain["step_ms"],
              remat["peak_bytes"] / 2 ** 20, plain["peak_bytes"] / 2 ** 20,
              P24_RESNET_STEPS + 4, d, P24_REMAT_REL_L2,
              json.dumps(remat["stats"]), smi))
    if prepared["captures_in_loop"] != 0 or not prepared["prepare_bitwise"]:
        fail("prepare(): %d captures in the loop, state bitwise %s"
             % (prepared["captures_in_loop"], prepared["prepare_bitwise"]))
    if not remat["remat"] or not d <= P24_REMAT_REL_L2:
        fail("remat: on %s, first step relative L2 %.3g > %g"
             % (remat["remat"], d, P24_REMAT_REL_L2))
    gc.collect()
    torch.cuda.empty_cache()
    return {"plain": plain, "prepared": prepared, "remat": remat,
            "remat_rel_l2": d}


def threaded_prepares(torch, mt):
    """(d'): eight small fused modules prepared by eight warm-up threads
    (their captures serialized by the device's capture lock) against the
    same prepared by one thread: two steps each, params bitwise."""
    from mxnet_tpu_torch.compile_cache import parallel_warm
    sym = mt.sym.Variable("data")
    sym = mt.sym.FullyConnected(sym, num_hidden=256, name="fc1")
    sym = mt.sym.Activation(sym, act_type="relu", name="relu1")
    sym = mt.sym.FullyConnected(sym, num_hidden=10, name="fc2")
    sym = mt.sym.SoftmaxOutput(sym, name="softmax")
    rng = np.random.RandomState(8)
    x = mt.nd.array(rng.randn(32, 64).astype(np.float32), ctx=mt.cpu())
    y = mt.nd.array(rng.randint(0, 10, 32).astype(np.float32), ctx=mt.cpu())
    batch = mt.io.DataBatch(data=[x], label=[y])

    def modules(threads):
        mods = []
        for i in range(P24_THREADS):
            mod = mt.mod.Module(sym, context=mt.gpu(0))
            mod.bind([("data", (32, 64))], [("softmax_label", (32,))])
            args = {"fc1_weight": rng_for(i).randn(256, 64) * 0.1,
                    "fc1_bias": np.zeros(256), "fc2_weight":
                    rng_for(i).randn(10, 256) * 0.1, "fc2_bias": np.zeros(10)}
            mod.init_params(arg_params={
                k: mt.nd.array(v.astype(np.float32), ctx=mt.cpu())
                for k, v in args.items()}, aux_params={})
            mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
            mods.append(mod)
        t0 = time.perf_counter()
        parallel_warm([("module %d" % i, m.prepare)
                       for i, m in enumerate(mods)], threads=threads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for m in mods:
            for _ in range(2):
                m.forward(batch, is_train=True)
                m.update()
        return [host_params(m) for m in mods], wall, \
            sum(m._fused.stats.captures for m in mods)

    def rng_for(i):
        return np.random.RandomState(100 + i)
    many, wall8, caps8 = modules(P24_THREADS)
    one, wall1, caps1 = modules(1)
    same = all(bitwise(a[0], b[0]) for a, b in zip(many, one))
    print("resnet (d') %d small modules prepared by %d threads in %.2f s "
          "(%d captures) against one thread in %.2f s (%d captures): params "
          "after two steps each bitwise %s" % (
              P24_THREADS, P24_THREADS, wall8, caps8, wall1, caps1, same))
    if not same or caps8 != P24_THREADS or caps1 != P24_THREADS:
        fail("threaded prepare differs from one thread's")


def p24_phase(torch, mt, ck, smi, root):
    """Phase 24; -> what main() reports."""
    t_phase = time.perf_counter()
    print("phase 24: compile and tuning (compile_cache, prepare, "
          "rematerialization, autotune, the fc and paged searches)")
    saved = {k: os.environ.get(k) for k in ("MXNET_AUTOTUNE_DIR",
                                            "MXNET_KERNEL_SEARCH",
                                            "MXNET_COMPILE_CACHE")}
    tmpdir = tempfile.TemporaryDirectory()
    try:
        os.environ["MXNET_AUTOTUNE_DIR"] = os.path.join(tmpdir.name, "at")
        os.environ.pop("MXNET_KERNEL_SEARCH", None)
        out = {"cold": cold_start(root, tmpdir.name, smi)}
        out["search"] = searches(torch, mt, ck, smi)
        os.environ.pop("MXNET_KERNEL_SEARCH", None)
        mt.autotune.kernelsearch._best_cache.clear()
        out["fit"] = fit_tuning(torch, mt, smi)
        out["resnet"] = resnet_prepare_remat(torch, mt, smi)
        threaded_prepares(torch, mt)
        print("compile report:\n%s" % mt.profiler.compile_report_str())
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
        mt.autotune.kernelsearch._best_cache.clear()
        tmpdir.cleanup()
    out["wall_s"] = time.perf_counter() - t_phase
    print("phase 24: %.1f s" % out["wall_s"])
    return out


# Phase 25: the trace runtime and the rest of mx.profiler on the card,
# the shard search, one online round.
# (a) phase 18's PTB LSTM fused step (batch 32): replays with tracing
#     off, then on; the captures, steady rebuilds and synchronize calls
#     the same, one fused:dispatch span a replay.
# (b) phase 4's fused VGG-16 ServeEngine and phase 7's PagedDecodeEngine
#     (GPT-2-small geometry), requests one at a time (so the batches and
#     steps, and with them the launches, do not depend on timing),
#     untraced then traced: each request's flow opens and closes once,
#     one serve:paged_step span a step, the same launches.
# (c) the device timeline: profiler_set_state("run") around a few paged
#     steps and one VGG-16 batch; the Chrome trace names the hand kernels
#     on the CUDA lanes.
# (d) sharding="auto" for VGG-16 at dp=1 x tp=2 over two gloo ranks on
#     the card, shortlist 2, 2 steps; the winner's first step against
#     one process's (phase 22's gate, SCALE_RATIO x the one-ulp nudge);
#     a second pair of ranks resolves from the store with no trial; the
#     card's memory around the search.
# (e) one online round: a ServeRouter over two fused VGG-16 replicas
#     with CaptureWriter(sample=1.0), an OnlineTrainer epoch on the
#     sealed shards, a gated promotion under 4 submitting threads.
P25_REPLAYS = 200
P25_SERVE_N = 32
P25_LM_PROMPTS = (5, 17, 40, 3, 64, 9, 28, 12)
P25_LM_NEW = 12
P25_TP_BATCH = 8
P25_ONLINE_N = 64
P25_ONLINE_BATCH = 8
P25_ONLINE_OPT = {"learning_rate": 0.001, "momentum": 0.9}
P25_MEM_TOL = 0.05
P25_SERVE_SHAPES = {"data": (1, 3, 224, 224), "softmax_label": (1,)}


def p25_events(mt, tmp, name):
    path = mt.profiler.dump_trace(os.path.join(tmp, name))
    with open(path) as f:
        doc = json.load(f)
    return [e for e in doc["traceEvents"] if e.get("ph") != "M"]


def p25_flows(evs, name):
    """{async id: [begins, ends]} of one async span name."""
    out = {}
    for e in evs:
        if e.get("name") == name and e["ph"] in ("b", "e"):
            out.setdefault(e["id"], [0, 0])[e["ph"] == "e"] += 1
    return out


def p25_train(torch, mt, smi):
    """(a)."""
    from mxnet_tpu_torch.compile_cache import get_stats
    arg0 = lstm_params(mt, LSTM_HIDDEN, 30)
    mod = lstm_module(mt, mt.models.lstm_unroll, LSTM_HIDDEN, SUPER_BATCH,
                      arg0, True)
    rng = np.random.default_rng(31)
    fused = mod._fused
    bufs = fused.make_batch(token_batch(mt, rng, mt.cpu(), SUPER_BATCH,
                                        LSTM_SEQ, LSTM_HIDDEN))
    for _ in range(8):                      # warm-up and capture
        fused.step(bufs)
    torch.cuda.synchronize()
    syncs = [0]
    real_sync = torch.cuda.synchronize

    def counted(*a, **kw):
        syncs[0] += 1
        return real_sync(*a, **kw)
    out = {}
    torch.cuda.synchronize = counted
    try:
        for label, on in (("off", False), ("on", True)):
            mt.trace.reset()
            mt.trace.set_enabled(on)
            g0 = fused.stats.report()
            r0 = get_stats().report()["totals"]["steady_rebuilds"]
            real_sync()
            s0 = syncs[0]
            t0 = time.perf_counter()
            for _ in range(P25_REPLAYS):
                fused.step(bufs)
            real_sync()
            wall = time.perf_counter() - t0
            g1 = fused.stats.report()
            out[label] = {
                "replays_s": P25_REPLAYS / wall, "syncs": syncs[0] - s0,
                "graphs": {k: g1[k] - g0[k] for k in g1},
                "rebuilds": get_stats().report()["totals"][
                    "steady_rebuilds"] - r0,
                "dispatch": len(mt.trace.span_events(
                    names=("fused:dispatch",)))}
    finally:
        torch.cuda.synchronize = real_sync
        mt.trace.set_enabled(True)
    del mod, fused, bufs
    gc.collect()
    torch.cuda.empty_cache()
    off, on = out["off"], out["on"]
    ratio = on["replays_s"] / off["replays_s"]
    print("p25 (a): PTB LSTM 2x%d batch %d, %d replays: tracing off %.1f "
          "replays/s, on %.1f replays/s (ratio %.4f); synchronize calls "
          "off %d on %d; graphs off %s on %s; steady rebuilds off %d on %d; "
          "fused:dispatch spans off %d on %d; card %s" % (
              LSTM_HIDDEN, SUPER_BATCH, P25_REPLAYS, off["replays_s"],
              on["replays_s"], ratio, off["syncs"], on["syncs"],
              off["graphs"], on["graphs"], off["rebuilds"], on["rebuilds"],
              off["dispatch"], on["dispatch"], smi))
    if off["graphs"] != on["graphs"] or on["graphs"]["replays"] != \
            P25_REPLAYS or on["graphs"]["captures"]:
        fail("(a) tracing changed the graphs: %s against %s"
             % (on["graphs"], off["graphs"]))
    if off["rebuilds"] != on["rebuilds"]:
        fail("(a) tracing changed the steady rebuilds")
    if on["syncs"] != off["syncs"]:
        fail("(a) the traced run added %d synchronize calls"
             % (on["syncs"] - off["syncs"]))
    if on["dispatch"] != P25_REPLAYS or off["dispatch"]:
        fail("(a) %d fused:dispatch spans for %d replays (untraced %d)"
             % (on["dispatch"], P25_REPLAYS, off["dispatch"]))
    return {"ratio": ratio, "off": off, "on": on}


def p25_serve(torch, mt, ck, tmp, smi, sym, params):
    """(b) and (c)."""
    from mxnet_tpu_torch.serve import LMConfig, init_lm_params
    cfg = LMConfig(**LM_GEOMETRY)
    lm = init_lm_params(cfg, seed=0, scale=0.005)
    rng = np.random.default_rng(25)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int64)
               for n in P25_LM_PROMPTS]
    items = [wire_to_nchw(rng.integers(0, 256, (224, 224, 3),
                                       dtype=np.uint8))
             for _ in range(P25_SERVE_N)]
    eng = mt.serve.ServeEngine(sym, dict(params), P25_SERVE_SHAPES,
                               fuse=True, batch_buckets=(1, 8),
                               name="p25-vgg")
    paged = paged_replica(mt, lm, cfg, "p25-paged")
    runs = {}
    try:
        for label, on in (("untraced", False), ("traced", True)):
            mt.trace.reset()
            mt.trace.set_enabled(on)
            steps0 = paged.stats.report()["steps"]
            ck.reset_launches()
            answers = [eng.submit(x).result(timeout=120) for x in items]
            streams = [paged.submit(p, max_new_tokens=P25_LM_NEW).result(
                timeout=300) for p in prompts]
            launches = dict(ck.LAUNCHES)
            steps = paged.stats.report()["steps"] - steps0
            evs = p25_events(mt, tmp, "serve-%s.json" % label)
            runs[label] = {"launches": launches, "steps": steps,
                           "evs": evs, "answers": answers,
                           "streams": [s.tolist() for s in streams]}
        mt.trace.set_enabled(True)
        # (c): the card's own timeline around a few paged steps and one
        # VGG-16 batch of 8
        mt.profiler.profiler_set_config(filename=os.path.join(tmp, "dev"))
        torch.cuda.synchronize()
        mt.profiler.profiler_set_state("run")
        with mt.profiler.scope("p25:device-timeline"):
            paged.submit(prompts[0], max_new_tokens=4).result(timeout=120)
            futs = eng.submit_many(items[:8])
            for f in futs:
                f.result(timeout=120)
            torch.cuda.synchronize()
        mt.profiler.profiler_set_state("stop")
    finally:
        mt.trace.set_enabled(True)
        eng.close()
        paged.close()
    del eng, paged, lm
    gc.collect()
    torch.cuda.empty_cache()
    un, tr = runs["untraced"], runs["traced"]
    req = p25_flows(tr["evs"], "serve:request")
    dec = p25_flows(tr["evs"], "serve:decode_request")
    step_spans = sum(1 for e in tr["evs"] if e["name"] == "serve:paged_step")
    print("p25 (b): %d VGG-16 requests and %d GPT-2-small streams one at a "
          "time; launches untraced %s traced %s; paged steps %d / %d, "
          "serve:paged_step spans %d; serve:request flows %d, "
          "serve:decode_request flows %d, %d events dumped; card %s" % (
              P25_SERVE_N, len(prompts), un["launches"], tr["launches"],
              un["steps"], tr["steps"], step_spans, len(req), len(dec),
              len(tr["evs"]), smi))
    for k in ("fused_fc_epilogue", "paged_attention"):
        if tr["launches"].get(k) != un["launches"].get(k) or \
                not tr["launches"].get(k):
            fail("(b) %s launched %s times traced, %s untraced"
                 % (k, tr["launches"].get(k), un["launches"].get(k)))
    if un["evs"]:
        fail("(b) the untraced run recorded %d events" % len(un["evs"]))
    if len(req) != P25_SERVE_N or any(v != [1, 1] for v in req.values()):
        fail("(b) serve:request flows not one begin and one end each: %s"
             % req)
    if len(dec) != len(prompts) or any(v != [1, 1] for v in dec.values()):
        fail("(b) serve:decode_request flows not one begin and one end "
             "each: %s" % dec)
    if step_spans != tr["steps"]:
        fail("(b) %d serve:paged_step spans for %d steps"
             % (step_spans, tr["steps"]))
    if un["streams"] != tr["streams"]:
        fail("(b) the traced streams differ from the untraced")
    for a, b in zip(un["answers"], tr["answers"]):
        if not np.array_equal(a, b):
            fail("(b) a traced answer differs from the untraced")
    # (c)
    path = os.path.join(tmp, "dev", "device.%d.trace.json" % os.getpid())
    with open(path) as f:
        dev_evs = json.load(f)["traceEvents"]
    kern = {}
    for e in dev_evs:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        for key, sub in (("fused_fc_epilogue", "fc_epilogue_kernel"),
                         ("paged_attention", "paged_attention_kernel")):
            if sub in e.get("name", ""):
                kern.setdefault(key, []).append(float(e["dur"]) / 1e3)
    scope = [e for e in dev_evs if e.get("name") == "p25:device-timeline"]
    print("p25 (c): device trace %s, %d events, %.1f MB; kernels on the "
          "CUDA lanes: %s; scope events %d; card %s" % (
              os.path.basename(path), len(dev_evs),
              os.path.getsize(path) / 2 ** 20,
              {k: {"launches": len(v), "ms_mean": round(float(np.mean(v)),
                                                        4),
                   "ms_max": round(max(v), 4)} for k, v in kern.items()},
              len(scope), smi))
    print("p25 (c): PERF.md section 6 times (quoted, not this run): "
          "fused_fc_epilogue fc6 + fc7 at bucket 8 0.2672 ms, "
          "paged_attention C=1 0.0405 ms")
    for k in ("fused_fc_epilogue", "paged_attention"):
        if not kern.get(k):
            fail("(c) the device trace names no %s kernel" % k)
    return {"launches": {k: un["launches"].get(k, 0)
                         + tr["launches"].get(k, 0)
                         for k in ("fused_fc_epilogue", "paged_attention")},
            "device_launches": {k: len(v) for k, v in kern.items()},
            "device_ms": {k: float(np.mean(v)) for k, v in kern.items()}}


def p25_search_rank(store, seed, second):
    """(d) on one of two ranks sharing gpu(0)."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.dist import boot
    from mxnet_tpu_torch.dist import shardsearch as ss
    os.environ["MXNET_AUTOTUNE_DIR"] = store
    os.environ["MXNET_DIST_SHARDSEARCH_SHORTLIST"] = "2"
    # one timed step a shortlisted candidate: the script's time limit
    # (the two candidates' steps differ 2.6x on an H100)
    os.environ["MXNET_DIST_SHARDSEARCH_STEPS"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    # cuBLAS's and cuBLASLt's workspaces come from the caching allocator
    # on their first use: make them before the reading the search is
    # held to
    a = torch.ones((64, 64), device=dev)
    torch.addmm(a, a, a)
    torch.nn.functional.linear(a, a, a[0])
    torch.nn.functional.conv2d(torch.ones((1, 3, 8, 8), device=dev),
                               torch.ones((4, 3, 3, 3), device=dev))
    del a
    torch.cuda.synchronize()
    sym, arg0, xs, ys, _ = vgg_setup(mt, seed, batch=P25_TP_BATCH, steps=1)
    mem = {}
    real = ss.resolve_auto

    def resolve(module, mesh):
        gc.collect()
        torch.cuda.synchronize()
        mem["before"] = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        out = real(module, mesh)
        gc.collect()
        torch.cuda.synchronize()
        mem["after"] = torch.cuda.memory_allocated(dev)
        mem["s"] = time.perf_counter() - t0
        return out
    ss.resolve_auto = resolve
    mt.random.seed(seed)
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    first = None
    if second:
        mod.bind([("data", xs[0].shape)], [("softmax_label", ys[0].shape)])
        mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                    for k, v in arg0.items()})
        mod.set_mesh(TP_MESH, sharding="auto")
        mod.init_optimizer(optimizer_params=dict(TRAIN_OPT))
    else:
        first, _ = timed_fit(
            torch, mt, mod, vgg_batches(mt, xs, ys), num_epoch=1,
            mesh=TP_MESH, sharding="auto",
            arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in arg0.items()})
    return {"rank": boot.rank(), "backend": boot.backend(),
            "specs": {k: list(v) for k, v in
                      mod._fused.param_specs.items()},
            "counts": dict(ss.COUNTS), "mem": mem,
            "first": first[0] if first is not None and boot.rank() == 0
            else None}


def p25_search(torch, mt, tmp, smi, root):
    """(d)."""
    from mxnet_tpu_torch.dist.spawn import run_ranks
    seed = 25
    store = os.path.join(tmp, "autotune")
    sym, arg0, xs, ys, nudged = vgg_setup(mt, seed, batch=P25_TP_BATCH,
                                          steps=1)
    torch.backends.cudnn.deterministic = True
    try:
        firsts = []
        for x in (xs[0], nudged):
            mt.random.seed(seed)
            mod = mt.mod.Module(sym, context=mt.gpu(0))
            first, _ = timed_fit(
                torch, mt, mod, vgg_batches(mt, [x], ys), num_epoch=1,
                arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                            for k, v in arg0.items()})
            firsts.append(first[0])
            del mod
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    nudge_l2 = first_step_l2(firsts[1], firsts[0], arg0)
    target = os.path.join(root, "chip_smoke.py") + ":p25_search_rank"
    t0 = time.perf_counter()
    ranks = run_ranks(target, 2, args=(store, seed, False), timeout=600)
    search_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = run_ranks(target, 2, args=(store, seed, True), timeout=600)
    again_s = time.perf_counter() - t0
    os.environ["MXNET_AUTOTUNE_DIR"] = store
    try:
        from mxnet_tpu_torch.autotune import store as st
        docs = [st.load_config(k) for k in st.list_configs()
                if k.startswith("shardsearch-")]
    finally:
        os.environ.pop("MXNET_AUTOTUNE_DIR", None)
    if len(docs) != 1:
        fail("(d) %d shard-search records in the store, want 1"
             % len(docs))
    log = docs[0]["log"]
    winner = docs[0]["config"]["specs"]
    first_l2 = first_step_l2(ranks[0]["first"], firsts[0], arg0)
    for cfg, s in log:
        print("p25 (d): candidate %-4s estimate %.4g s, measured %s; specs "
              "on %d params" % (cfg["strategy"], cfg["est_s"],
                                "%.4f s/step" % s if s >= 0
                                else "(not shortlisted)",
                                len(cfg["specs"])))
    print("p25 (d): VGG-16 batch %d, %s over two ranks (%s): winner %s "
          "(specs on %s); first step against one process's relative L2 "
          "%.3g (gate %.3g = %g x the nudge's %.3g); search pair %.1f s "
          "(resolve %s s), store pair %.1f s (resolve %s s), trials %s / "
          "%s, eager feature steps %s; memory around the search %s MB; "
          "card %s" % (
              P25_TP_BATCH, TP_MESH, ranks[0]["backend"],
              [c["strategy"] for c, _ in log
               if c["specs"] == winner][0], sorted(winner), first_l2,
              SCALE_RATIO * nudge_l2, SCALE_RATIO, nudge_l2, search_s,
              [round(r["mem"]["s"], 1) for r in ranks], again_s,
              [round(r["mem"]["s"], 2) for r in again],
              [r["counts"]["trials"] for r in ranks],
              [r["counts"]["trials"] for r in again],
              [r["counts"]["feature_steps"] for r in ranks],
              [(round(r["mem"]["before"] / 2 ** 20, 1),
                round(r["mem"]["after"] / 2 ** 20, 1)) for r in ranks], smi))
    if ranks[0]["specs"] != ranks[1]["specs"] or \
            ranks[0]["specs"] != again[0]["specs"] or \
            again[0]["specs"] != again[1]["specs"]:
        fail("(d) the ranks installed different specs")
    if first_l2 > SCALE_RATIO * nudge_l2:
        fail("(d) the winner's first step differs from one process's: "
             "%.3g > %.3g" % (first_l2, SCALE_RATIO * nudge_l2))
    if any(r["counts"]["trials"] for r in again):
        fail("(d) the store pair built trials: %s"
             % [r["counts"] for r in again])
    ncand = len(log)
    for r in ranks:
        if r["counts"] != {"trials": ncand + min(2, ncand),
                           "feature_steps": ncand}:
            fail("(d) rank %d: %s for %d candidates"
                 % (r["rank"], r["counts"], ncand))
        m0, m1 = r["mem"]["before"], r["mem"]["after"]
        if abs(m1 - m0) > P25_MEM_TOL * max(m0, 1):
            fail("(d) rank %d: the card's memory %d bytes before the "
                 "search, %d after" % (r["rank"], m0, m1))
    return {"winner": winner, "log": log, "first_l2": first_l2,
            "gate": SCALE_RATIO * nudge_l2, "search_s": search_s,
            "again_s": again_s}


def p25_online(torch, mt, ck, tmp, smi, sym, params):
    """(e)."""
    capdir = os.path.join(tmp, "capture")
    ckdir = os.path.join(tmp, "online-ck")
    rng = np.random.default_rng(250)
    items = [wire_to_nchw(rng.integers(0, 256, (224, 224, 3),
                                       dtype=np.uint8))
             for _ in range(P25_ONLINE_N)]
    hold = np.stack(items[:8])
    writer = mt.online.CaptureWriter(
        capdir, sample=1.0, shard_items=16, fresh=True,
        transform=lambda d, o: (d, np.argmax(o)))

    def factory(i):
        return mt.serve.ServeEngine(sym, dict(params), P25_SERVE_SHAPES,
                                    fuse=True, batch_buckets=(1, 8),
                                    name="p25-rep%d" % i)
    t0 = time.perf_counter()
    router = mt.serve.ServeRouter(factory, replicas=2, capture=writer,
                                  name="p25-router")
    built_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        _, _, errors = flood(lambda i: router.submit(items[i]),
                             P25_ONLINE_N, 4)
        if errors:
            fail("(e) client errors: %s" % errors)
        router.capture_sync(timeout=300)
        writer.flush()
        serve_s = time.perf_counter() - t0
        shards = mt.online.sealed_shards(capdir)
        cap = writer.report()
        if cap["kept"] != P25_ONLINE_N or len(shards) != 4:
            fail("(e) captured %s into %d shards" % (cap, len(shards)))
        t0 = time.perf_counter()
        trainer = mt.online.OnlineTrainer(
            sym, capdir, ckdir, batch_size=P25_ONLINE_BATCH,
            optimizer_params=dict(P25_ONLINE_OPT),
            arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in params.items()},
            checkpoint_every=P25_ONLINE_N // P25_ONLINE_BATCH,
            context=mt.gpu(0))
        rnd = trainer.round(num_epoch=1, shards=shards)
        train_s = time.perf_counter() - t0
        from mxnet_tpu_torch.serve.engine import load_checkpoint_dir_params
        cand_params, _meta = load_checkpoint_dir_params(ckdir)
        cand_params = {k: np.asarray(v) for k, v in cand_params.items()}
        pred = mt.Predictor(sym.tojson(), cand_params,
                            {"data": (8, 3, 224, 224),
                             "softmax_label": (8,)})
        cand_scores = pred.predict(hold)
        live_scores = np.stack([router.submit(x).result(timeout=120)
                                for x in hold])
        labels = np.argmax(live_scores, axis=1)
        gate = mt.online.PromotionGate(min_improve=-1.0, max_drift=1.0)
        decision = gate.decide(live_scores, cand_scores, labels)
        stop = threading.Event()
        tally = {"done": 0, "dropped": 0}
        lock = threading.Lock()

        def traffic(k):
            j = k
            while not stop.is_set():
                try:
                    router.submit(items[j % P25_ONLINE_N]).result(
                        timeout=120)
                    key = "done"
                except Exception:
                    key = "dropped"
                with lock:
                    tally[key] += 1
                j += 4
        threads = [threading.Thread(target=traffic, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        try:
            record = gate.apply(decision, router, ckdir, timeout=300)
        finally:
            promote_s = time.perf_counter() - t0
            stop.set()
            for t in threads:
                t.join(timeout=300)
        ck.reset_launches()
        after = np.stack([router.submit(x).result(timeout=120)
                          for x in hold])
        launches = dict(ck.LAUNCHES)
        rep = router.stats.report()
    finally:
        router.close()
    del router, pred
    gc.collect()
    torch.cuda.empty_cache()
    worst = float(np.abs(after - cand_scores).max())
    print("p25 (e): router over two fused VGG-16 replicas built in %.1f s; "
          "%d requests captured %s in %.1f s; OnlineTrainer round %s in "
          "%.1f s; gate %s; promotion %s in %.1f s with %d requests "
          "served and %d dropped by 4 threads; answers after it against a "
          "fresh Predictor of the promoted step: max abs err %.3g; "
          "launches after it %s; router %s; card %s" % (
              built_s, P25_ONLINE_N, cap, serve_s, rnd, train_s,
              {k: decision[k] for k in ("promote", "live_acc", "cand_acc",
                                        "drift")},
              record["action"], promote_s, tally["done"], tally["dropped"],
              worst, launches,
              {k: rep.get(k) for k in ("completed", "captured",
                                       "capture_errors")}, smi))
    if tally["dropped"] or record["action"] != "promote":
        fail("(e) %d requests dropped through the promotion (record %s)"
             % (tally["dropped"], record))
    if not np.allclose(after, cand_scores, rtol=1e-3, atol=1e-6):
        fail("(e) answers after the promotion differ from the promoted "
             "checkpoint's: max abs err %.3g" % worst)
    if launches.get("fused_fc_epilogue", 0) < 2:
        fail("(e) the promoted replicas launched fused_fc_epilogue %s times"
             % launches.get("fused_fc_epilogue"))
    return {"launches": launches.get("fused_fc_epilogue", 0),
            "served_during": tally["done"], "worst": worst}


def p25_phase(torch, mt, ck, smi, root):
    print("phase 25: trace/, the rest of mx.profiler, the shard search, "
          "online/; TF32 matmul=%s cudnn=%s; card %s" % (
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32, smi))
    t_phase = time.perf_counter()
    tmpdir = tempfile.TemporaryDirectory()
    tmp = tmpdir.name
    try:
        walls = {}
        t0 = time.perf_counter()
        a = p25_train(torch, mt, smi)
        walls["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sym = mt.models.get_vgg(num_classes=1000)
        params = xavier_params(sym, P25_SERVE_SHAPES, 4)
        b = p25_serve(torch, mt, ck, tmp, smi, sym, params)
        walls["b+c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        d = p25_search(torch, mt, tmp, smi, root)
        walls["d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        e = p25_online(torch, mt, ck, tmp, smi, sym, params)
        walls["e"] = time.perf_counter() - t0
    finally:
        tmpdir.cleanup()
        mt.trace.reset()
    wall = time.perf_counter() - t_phase
    print("p25: walls %s s, phase %.1f s; card %s" % (
        {k: round(v, 1) for k, v in walls.items()}, wall, smi))
    return {"a": a, "b": b, "d": d, "e": e, "wall_s": wall,
            "launches": {
                "fused_fc_epilogue": b["launches"]["fused_fc_epilogue"]
                + b["device_launches"].get("fused_fc_epilogue", 0)
                + e["launches"],
                "paged_attention": b["launches"]["paged_attention"]
                + b["device_launches"].get("paged_attention", 0)}}


# ---------------------------------------------------------------------------
# phase 26: users' kernels, Python ops, WarpCTC and the torch bridge
# (operator.py, rtc.py, plugins/; ROADMAP item 13), and the lock order

# (a) the original ndarray_softmax kernels (example/numpy-ops), as CUDA
# bodies for mx.rtc.Rtc: the softmax over each row (one block a row, a
# shared-memory tree for the max and the sum; blockDim a power of two)
# and its gradient y - onehot(l)
RTC_SOFTMAX = r"""
  __shared__ float red[1024];
  const int n = x_dims[1];
  const float* xr = x + blockIdx.x * n;
  float* yr = y + blockIdx.x * n;
  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += blockDim.x) m = fmaxf(m, xr[j]);
  red[threadIdx.x] = m;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  m = red[0];
  __syncthreads();
  float sum = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float e = expf(xr[j] - m);
    yr[j] = e;
    sum += e;
  }
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) yr[j] /= red[0];
"""
# rtc.pallas_call's form: a whole source with one __global__ function
RTC_AXPY = r"""
extern "C" __global__ void axpy(const float* a, float* o) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 1000) o[i] = 2.f * a[i] + 1.f;
}
"""
RTC_SOFTMAX_GRAD = r"""
  const int n = y_dims[1];
  const int lab = (int)l[blockIdx.x];
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    dx[blockIdx.x * n + j] = y[blockIdx.x * n + j] - (j == lab ? 1.f : 0.f);
"""
# the card's expf and division against torch.softmax: a few float32 ulps
P26_RTC_ATOL = 1e-6
P26_RTC_SHAPES = ((100, 10, 32), (37, 1000, 256))   # rows, classes, block
# (b) example/numpy-ops' MLP at batch 100, 20 steps from one checkpoint
P26_BATCH, P26_STEPS = 100, 20
P26_LR = {"learning_rate": 0.05, "momentum": 0.9}
# the Python heads compute the softmax and its gradient on the host (or
# in the user's kernels) and SoftmaxOutput on the card: ~1e-7 apart a
# step, carried on by momentum over 20 steps
P26_FIT_ATOL = 1e-5
# (c) the Custom graph served: phase 4's tolerance
P26_SERVE_RTOL, P26_SERVE_ATOL = 1e-3, 1e-6
P26_REQUESTS, P26_THREADS = 32, 4
# (d) LSTM-OCR at example/warpctc/lstm_ocr.py's defaults
OCR_T, OCR_FEAT, OCR_HIDDEN, OCR_BATCH, OCR_LABELS, OCR_CLASSES = \
    80, 30, 100, 32, 4, 11
OCR_OPT = {"learning_rate": 0.001, "momentum": 0.9, "wd": 1e-5}
# the first step's update, card against the port's CPU run: 80 LSTM steps
# of float32 products in cuBLAS's and the CPU's orders, then the CTC
# recursion's log-sum-exps (relative L2 of the update)
OCR_FIRST_RTOL = 1e-4


def p26_ops(mt):
    """The example/numpy-ops heads in the port (NumpySoftmax,
    NDArraySoftmax over (a)'s Rtc kernels, CustomSoftmax registered as
    "p26_softmax") and a scaling Custom op ("p26_scale", factor=)."""
    import torch

    class NumpySoftmax(mt.operator.NumpyOp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]]

        def forward(self, in_data, out_data):
            x, y = in_data[0], out_data[0]
            y[:] = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)

        def backward(self, out_grad, in_data, out_data, in_grad):
            lab = in_data[1].astype(int)
            dx = in_grad[0]
            dx[:] = out_data[0]
            dx[np.arange(lab.shape[0]), lab] -= 1.0

    class NDArraySoftmax(mt.operator.NDArrayOp):
        """The original ndarray_softmax.py: its kernels are CUDA bodies
        pushed through mx.rtc on the op's device."""

        def __init__(self):
            super().__init__(False)
            self.fwd_kernel = self.bwd_kernel = None

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]]

        def forward(self, in_data, out_data):
            x, y = in_data[0], out_data[0]
            xa = mt.nd.array(x)
            if self.fwd_kernel is None:
                self.fwd_kernel = mt.rtc.Rtc("softmax", [("x", xa)],
                                             [("y", xa)], RTC_SOFTMAX)
            yout = mt.nd.empty(y.shape)
            self.fwd_kernel.push([xa], [yout], (x.shape[0], 1, 1),
                                 (32, 1, 1))
            y[:] = yout.asnumpy()

        def backward(self, out_grad, in_data, out_data, in_grad):
            label, y, dx = in_data[1], out_data[0], in_grad[0]
            ya, la = mt.nd.array(y), mt.nd.array(label)
            if self.bwd_kernel is None:
                self.bwd_kernel = mt.rtc.Rtc(
                    "softmax_grad", [("y", ya), ("l", la)], [("dx", ya)],
                    RTC_SOFTMAX_GRAD)
            dxout = mt.nd.empty(dx.shape)
            self.bwd_kernel.push([ya, la], [dxout], (y.shape[0], 1, 1),
                                 (32, 1, 1))
            dx[:] = dxout.asnumpy()

    class CustomSoftmaxOp(mt.operator.CustomOp):
        """Softmax and its gradient on the op's own device (the port's
        NDArrays on the card): no host round trip."""

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]._get()
            self.assign(out_data[0], req[0], torch.softmax(x, dim=1))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]._get().clone()
            lab = in_data[1]._get().to(torch.int64)
            y[torch.arange(lab.shape[0], device=y.device), lab] -= 1.0
            self.assign(in_grad[0], req[0], y)

    @mt.operator.register("p26_softmax")
    class CustomSoftmaxProp(mt.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return CustomSoftmaxOp()

    class ScaleOp(mt.operator.CustomOp):
        def __init__(self, factor):
            self.factor = factor

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * self.factor)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * self.factor)

    @mt.operator.register("p26_scale")
    class ScaleProp(mt.operator.CustomOpProp):
        def __init__(self, factor="1.0"):
            super().__init__(need_top_grad=True)
            self.factor = float(factor)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return ScaleOp(self.factor)

    return NumpySoftmax, NDArraySoftmax


def p26_mlp(mt, ops, head):
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = mt.sym.Activation(net, act_type="relu", name="relu1")
    net = mt.sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = mt.sym.Activation(net, act_type="relu", name="relu2")
    net = mt.sym.FullyConnected(net, num_hidden=10, name="fc3")
    label = mt.sym.Variable("softmax_label")
    if head == "numpy":
        return ops[0]()(data=net, label=label, name="softmax")
    if head == "ndarray":
        return ops[1]()(data=net, label=label, name="softmax")
    if head == "custom":
        return mt.sym.Custom(net, label, op_type="p26_softmax",
                             name="softmax")
    return mt.sym.SoftmaxOutput(net, name="softmax")


def p26_custom_mid(mt):
    """fc1(128)+relu -> Custom(p26_scale) -> fc2(64)+relu -> fc3(10) ->
    SoftmaxOutput: a one-input Custom op a Predictor binds from the data
    shape alone."""
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = mt.sym.Activation(net, act_type="relu", name="relu1")
    net = mt.sym.Custom(net, op_type="p26_scale", factor=0.5, name="scale")
    net = mt.sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = mt.sym.Activation(net, act_type="relu", name="relu2")
    net = mt.sym.FullyConnected(net, num_hidden=10, name="fc3")
    return mt.sym.SoftmaxOutput(net, name="softmax")


def p26_rtc(torch, mt, smi):
    """(a): the ndarray_softmax kernels through Rtc on gpu(0)."""
    from mxnet_tpu_torch import rtc
    dev = torch.device("cuda", 0)
    flush = torch.zeros(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(26)
    out = {"cases": []}
    runs0 = rtc.NVCC_RUNS
    t_build = 0.0
    for rows, cols, block in P26_RTC_SHAPES:
        x = torch.from_numpy(rng.standard_normal((rows, cols),
                                                 dtype=np.float32)).to(dev)
        lab = torch.from_numpy(rng.integers(0, cols, rows).astype(
            np.float32)).to(dev)
        xa, la = mt.nd.NDArray(x), mt.nd.NDArray(lab)
        y, dx = mt.nd.zeros((rows, cols)), mt.nd.zeros((rows, cols))
        fwd = mt.rtc.Rtc("softmax", [("x", xa)], [("y", xa)], RTC_SOFTMAX)
        bwd = mt.rtc.Rtc("softmax_grad", [("y", xa), ("l", la)],
                         [("dx", xa)], RTC_SOFTMAX_GRAD)
        t0 = time.perf_counter()
        fwd.push([xa], [y], (rows, 1, 1), (block, 1, 1))
        bwd.push([y, la], [dx], (rows, 1, 1), (block, 1, 1))
        torch.cuda.synchronize()
        t_build += time.perf_counter() - t0
        want_y = torch.softmax(x, dim=1)
        want_dx = want_y - torch.nn.functional.one_hot(
            lab.to(torch.int64), cols).to(torch.float32)
        err = max(float((y._get() - want_y).abs().max()),
                  float((dx._get() - want_dx).abs().max()))
        fwd_ms = time_ms(torch, lambda: fwd.push([xa], [y], (rows, 1, 1),
                                                 (block, 1, 1)), flush)
        bwd_ms = time_ms(torch, lambda: bwd.push([y, la], [dx],
                                                 (rows, 1, 1), (block, 1, 1)),
                         flush)
        plain_ms = time_ms(torch, lambda: torch.softmax(x, dim=1), flush)
        print("p26 (a): rtc softmax %dx%d block %d: max_abs_err %.3g (atol "
              "%g), softmax %.4f ms, softmax_grad %.4f ms, torch.softmax "
              "%.4f ms (card %s)" % (rows, cols, block, err, P26_RTC_ATOL,
                                     fwd_ms, bwd_ms, plain_ms, smi))
        if not err <= P26_RTC_ATOL:
            fail("rtc softmax %dx%d: max_abs_err %g > %g"
                 % (rows, cols, err, P26_RTC_ATOL))
        out["cases"].append({"shape": [rows, cols], "err": err,
                             "fwd_ms": fwd_ms, "bwd_ms": bwd_ms})
    built = rtc.NVCC_RUNS - runs0
    # the same sources again: built in this process, no nvcc
    runs1 = rtc.NVCC_RUNS
    rows, cols, block = P26_RTC_SHAPES[0]
    xa = mt.nd.zeros((rows, cols))
    again = mt.rtc.Rtc("softmax", [("x", xa)], [("y", xa)], RTC_SOFTMAX)
    again.push([xa], [mt.nd.zeros((rows, cols))], (rows, 1, 1),
               (block, 1, 1))
    torch.cuda.synchronize()
    rebuilt = rtc.NVCC_RUNS - runs1
    print("p26 (a): %d nvcc runs built %d kernels in %.1f s (first pushes "
          "included); a second Rtc of the same source ran nvcc %d times"
          % (built, 2 * len(P26_RTC_SHAPES), t_build, rebuilt))
    if built != 2 * len(P26_RTC_SHAPES) or rebuilt != 0:
        fail("rtc builds: %d nvcc runs for %d sources, %d for a rebuilt "
             "one" % (built, 2 * len(P26_RTC_SHAPES), rebuilt))
    bad = mt.rtc.Rtc("broken", [("x", xa)], [("y", xa)],
                     "  y[0] = x[0] +;  // a syntax error")
    try:
        bad.push([xa], [mt.nd.zeros((rows, cols))], (1, 1, 1), (1, 1, 1))
    except mt.MXNetError as e:
        msg = str(e)
    else:
        fail("a kernel body with a syntax error built and launched")
    if "nvcc failed" not in msg or "error" not in msg.split("\n", 1)[1]:
        fail("a failed build raised without nvcc's log: %r" % msg[:300])
    print("p26 (a): a body with a syntax error raises with nvcc's log: %r"
          % msg.split("\n", 2)[1][:160])
    call = mt.rtc.pallas_call(RTC_AXPY, ((1000,), np.float32), grid=(4,),
                              block=(256,))
    a = torch.from_numpy(rng.standard_normal(1000, dtype=np.float32)).to(dev)
    n0 = rtc.LAUNCHES.get("axpy", 0)
    o = call(a)
    torch.cuda.synchronize()
    err = float((o - (2 * a + 1)).abs().max())
    print("p26 (a): rtc.pallas_call axpy over 1000: max_abs_err %.3g, %d "
          "launch counted" % (err, rtc.LAUNCHES["axpy"] - n0))
    if not err <= P26_RTC_ATOL or rtc.LAUNCHES["axpy"] - n0 != 1:
        fail("rtc.pallas_call: err %g, %d launches"
             % (err, rtc.LAUNCHES["axpy"] - n0))
    out["build_s"] = t_build
    out["fwd_kernel"] = RTC_SOFTMAX
    return out


def p26_marks(torch):
    """A batch_end_callback marking each step's end on a drained card,
    and -> steps/s over the steps after the warm-up and the capture (the
    fused step's steady state, eager or replayed)."""
    from mxnet_tpu_torch.module.fused import WARMUP_STEPS
    marks = []

    def mark(_param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    def rate():
        tail = marks[WARMUP_STEPS:]
        return (len(tail) - 1) / (tail[-1] - tail[0])
    return mark, rate


def p26_fit(torch, mt, ops, head, x, y, arg):
    mod = mt.mod.Module(p26_mlp(mt, ops, head), context=mt.gpu(0))
    it = mt.io.NDArrayIter(x, y, batch_size=P26_BATCH)
    mark, rate = p26_marks(torch)
    mod.fit(it, num_epoch=1, optimizer="sgd", arg_params=arg,
            optimizer_params=dict(P26_LR), batch_end_callback=mark)
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return params, mod._fused, rate()


def p26_python_ops_fit(torch, mt, ops, smi):
    """(b): four 20-step fits of the MLP from one checkpoint."""
    from mxnet_tpu_torch.module.fused import WARMUP_STEPS
    rng = np.random.default_rng(261)
    n = P26_BATCH * P26_STEPS
    x = rng.uniform(-1, 1, (n, 784)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.float32)
    sym = p26_mlp(mt, ops, "softmax")
    arg = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in xavier_params(
        sym, {"data": (P26_BATCH, 784), "softmax_label": (P26_BATCH,)},
        262).items()}
    runs = {}
    for head in ("softmax", "numpy", "ndarray", "custom"):
        params, fused, rate = p26_fit(torch, mt, ops, head, x, y, arg)
        stats = fused.stats.report()
        runs[head] = {"params": params, "stats": stats, "steps_s": rate,
                      "reason": fused.capture_reason()}
        print("p26 (b): %-8s head: %.1f steps/s (after the warm-up and "
              "capture steps), graphs %s, capture "
              "reason %r (card %s)" % (head, rate, stats,
                                      fused.capture_reason(), smi))
    want = {"captures": 1, "replays": P26_STEPS - WARMUP_STEPS,
            "eager_steps": WARMUP_STEPS}
    if runs["softmax"]["stats"] != want:
        fail("SoftmaxOutput fit: graphs %s, want %s"
             % (runs["softmax"]["stats"], want))
    ref = runs["softmax"]["params"]
    for head in ("numpy", "ndarray", "custom"):
        got = runs[head]
        if got["stats"] != {"captures": 0, "replays": 0,
                            "eager_steps": P26_STEPS}:
            fail("%s-head fit: graphs %s, want 0 captures and %d eager "
                 "steps" % (head, got["stats"], P26_STEPS))
        err = max(float(np.abs(got["params"][k] - ref[k]).max())
                  for k in ref)
        got["max_abs_diff"] = err
        print("p26 (b): %-8s head params vs SoftmaxOutput's after %d steps: "
              "max_abs_diff %.3g (atol %g)" % (head, P26_STEPS, err,
                                               P26_FIT_ATOL))
        if not err <= P26_FIT_ATOL:
            fail("%s-head fit drifted %g from SoftmaxOutput's" % (head, err))
    return runs


def p26_serve(torch, mt, ck, ops, tmp, smi):
    """(c): the Custom graph trained 5 steps, saved and served."""
    rng = np.random.default_rng(263)
    n = P26_BATCH * 5
    x = rng.uniform(-1, 1, (n, 784)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.float32)
    sym = p26_custom_mid(mt)
    arg = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in xavier_params(
        sym, {"data": (P26_BATCH, 784), "softmax_label": (P26_BATCH,)},
        264).items()}
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=P26_BATCH), num_epoch=1,
            optimizer="sgd", arg_params=arg, optimizer_params=dict(P26_LR))
    if mod._fused.stats.report()["captures"]:
        fail("the Custom graph's fit captured a graph")
    prefix = os.path.join(tmp, "p26-custom")
    mod.save_checkpoint(prefix, 0)
    shapes = {"data": (1, 784), "softmax_label": (1,)}
    items = [rng.uniform(-1, 1, 784).astype(np.float32)
             for _ in range(P26_REQUESTS)]
    engine = mt.serve.ServeEngine.from_checkpoint(prefix, 0, shapes,
                                                  fuse=True)
    try:
        ops_ = [nd["op"] for nd in json.loads(
            engine._predictor.symbol.tojson())["nodes"]]
        if ops_.count("Custom") != 1 or \
                ops_.count("_fused_FullyConnected") != 2:
            fail("served graph holds %d Custom and %d _fused_FullyConnected "
                 "nodes, want 1 and 2" % (ops_.count("Custom"),
                                          ops_.count("_fused_FullyConnected")))
        batches0 = engine.stats.report()["batches"]
        ck.reset_launches()
        answers, wall = serve_burst(engine, items, P26_THREADS)
        launches = ck.LAUNCHES["fused_fc_epilogue"]
        batches = engine.stats.report()["batches"] - batches0
    finally:
        engine.close()
    print("p26 (c): %d requests from %d threads in %.3f s = %.1f req/s, %d "
          "batches, fused_fc_epilogue launched %d times (card %s)"
          % (P26_REQUESTS, P26_THREADS, wall, P26_REQUESTS / wall, batches,
             launches, smi))
    if batches < 1 or launches != 2 * batches:
        fail("fused_fc_epilogue launched %d times for %d batches, want 2 "
             "a batch" % (launches, batches))
    sym_json, params = mt.predictor.load_checkpoint_pair(prefix, 0)
    ref = mt.Predictor(sym_json, params, {"data": (8, 784),
                                          "softmax_label": (8,)})
    refs = []
    for i in range(0, P26_REQUESTS, 8):
        refs.extend(ref.predict(np.stack(items[i:i + 8])))
    worst = max(float(np.abs(a - r).max()) for a, r in zip(answers, refs))
    for i, (a, r) in enumerate(zip(answers, refs)):
        if a is None or a.shape != (10,) or not np.all(np.isfinite(a)) or \
                not np.allclose(a, r, rtol=P26_SERVE_RTOL,
                                atol=P26_SERVE_ATOL):
            fail("served answer %d differs from the unfused Predictor's"
                 % i)
    print("p26 (c): answers vs an unfused Predictor: max_abs_diff %.3g "
          "(rtol %g, atol %g)" % (worst, P26_SERVE_RTOL, P26_SERVE_ATOL))
    return {"prefix": prefix, "launches": launches, "batches": batches,
            "rps": P26_REQUESTS / wall}


def p26_ocr_symbol(mt):
    """example/warpctc/lstm.py's lstm_unroll in the port."""
    from mxnet_tpu_torch.models.lstm import LSTMParam, LSTMState, lstm_cell
    param = LSTMParam(i2h_weight=mt.sym.Variable("l0_i2h_weight"),
                      i2h_bias=mt.sym.Variable("l0_i2h_bias"),
                      h2h_weight=mt.sym.Variable("l0_h2h_weight"),
                      h2h_bias=mt.sym.Variable("l0_h2h_bias"))
    state = LSTMState(c=mt.sym.Variable("l0_init_c"),
                      h=mt.sym.Variable("l0_init_h"))
    frames = mt.sym.Reshape(mt.sym.Variable("data"),
                            shape=(OCR_BATCH, OCR_T, OCR_FEAT))
    steps = mt.sym.SliceChannel(frames, num_outputs=OCR_T, axis=1,
                                squeeze_axis=True)
    cls_w, cls_b = mt.sym.Variable("cls_weight"), mt.sym.Variable("cls_bias")
    scores = []
    for t in range(OCR_T):
        state = lstm_cell(OCR_HIDDEN, indata=steps[t], prev_state=state,
                          param=param, seqidx=t, layeridx=0)
        scores.append(mt.sym.FullyConnected(
            data=state.h, weight=cls_w, bias=cls_b, num_hidden=OCR_CLASSES,
            name="t%d_cls" % t))
    return mt.sym.WarpCTC(data=mt.sym.Concat(*scores, dim=0),
                          label=mt.sym.Variable("label"),
                          label_length=OCR_LABELS, input_length=OCR_T)


def p26_ocr_fit(torch, mt, ctx, arg, data, label, steps):
    mod = mt.mod.Module(p26_ocr_symbol(mt), context=ctx,
                        data_names=["data", "l0_init_c", "l0_init_h"],
                        label_names=["label"])
    zeros = np.zeros((len(data), OCR_HIDDEN), np.float32)
    it = mt.io.NDArrayIter({"data": data[:steps * OCR_BATCH],
                            "l0_init_c": zeros[:steps * OCR_BATCH],
                            "l0_init_h": zeros[:steps * OCR_BATCH]},
                           {"label": label[:steps * OCR_BATCH]},
                           batch_size=OCR_BATCH)
    first = []
    mark, rate = p26_marks(torch) if ctx.device_type == "gpu" \
        else (lambda _p: None, None)

    def on_batch(p):
        if p.nbatch == 0 and not first:
            first.append({k: v.asnumpy()
                          for k, v in mod.get_params()[0].items()})
        mark(p)
    # example/warpctc/lstm_ocr.py's metric: CTC greedy decode, exact
    # string accuracy, on the host
    mod.fit(it, num_epoch=1, optimizer="sgd", arg_params=arg,
            optimizer_params=dict(OCR_OPT), batch_end_callback=on_batch,
            eval_metric=mt.metric.np(p26_ocr_accuracy))
    last = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return first[0], last, mod._fused.stats.report(), \
        rate() if rate is not None else None


def p26_ocr_accuracy(label, pred):
    """example/warpctc/lstm_ocr.py's Accuracy: greedy CTC decode of each
    sequence (collapse repeats, drop blanks) against its label."""
    path = pred.reshape(OCR_T, -1, pred.shape[1]).argmax(axis=2)
    hit = 0
    for i in range(path.shape[1]):
        dec, prev = [], 0
        for c in path[:, i]:
            if c != 0 and c != prev:
                dec.append(int(c))
            prev = c
        hit += dec == [int(v) for v in label[i] if v != 0]
    return hit / path.shape[1]


def p26_warpctc(torch, mt, smi):
    """(d): LSTM-OCR with WarpCTC through fit on the card."""
    from mxnet_tpu_torch.module.fused import WARMUP_STEPS
    rng = np.random.default_rng(265)
    n = OCR_BATCH * P26_STEPS
    data = rng.standard_normal((n, OCR_T * OCR_FEAT), dtype=np.float32)
    label = np.zeros((n, OCR_LABELS), np.float32)
    for i in range(n):
        w = 3 + i % 2                                   # 3 or 4 digits
        label[i, :w] = 1 + rng.integers(0, 10, w)
    sym = p26_ocr_symbol(mt)
    shapes = {"data": (OCR_BATCH, OCR_T * OCR_FEAT),
              "l0_init_c": (OCR_BATCH, OCR_HIDDEN),
              "l0_init_h": (OCR_BATCH, OCR_HIDDEN),
              "label": (OCR_BATCH, OCR_LABELS)}
    arg = {k: mt.nd.array(v, ctx=mt.cpu())
           for k, v in xavier_params(sym, shapes, 266).items()}
    first_cpu, _, _, _ = p26_ocr_fit(torch, mt, mt.cpu(), arg, data, label,
                                     1)
    runs = []
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            runs.append(p26_ocr_fit(torch, mt, mt.gpu(0), arg, data, label,
                                    P26_STEPS))
    finally:
        torch.use_deterministic_algorithms(prev)
    first, last, stats, steps_s = runs[0]
    num = sum(float(((first[k] - first_cpu[k]) ** 2).sum()) for k in first)
    den = sum(float(((first_cpu[k] - arg[k].asnumpy()) ** 2).sum())
              for k in first)
    rel = math.sqrt(num / den)
    want = {"captures": 1, "replays": P26_STEPS - WARMUP_STEPS,
            "eager_steps": WARMUP_STEPS}
    bitwise = all(np.array_equal(last[k], runs[1][1][k]) for k in last)
    finite = all(np.all(np.isfinite(v)) for v in last.values())
    tokens_s = steps_s * OCR_BATCH * OCR_T
    print("p26 (d): LSTM-OCR T %d feat %d hidden %d batch %d, %d labels, %d "
          "classes: %d steps through fit, graphs %s, %.1f tokens/s (the "
          "replays' steady state); first "
          "update vs the port's CPU run: relative L2 %.3g (rtol %g); two "
          "deterministic runs bitwise equal: %s (card %s)"
          % (OCR_T, OCR_FEAT, OCR_HIDDEN, OCR_BATCH, OCR_LABELS, OCR_CLASSES,
             P26_STEPS, stats, tokens_s, rel, OCR_FIRST_RTOL, bitwise, smi))
    if stats != want:
        fail("WarpCTC fit: graphs %s, want %s" % (stats, want))
    if not rel <= OCR_FIRST_RTOL:
        fail("WarpCTC first update differs from the CPU's: %g" % rel)
    if not bitwise or not finite:
        fail("WarpCTC fit: two deterministic runs differ, or non-finite")
    return {"tokens_s": tokens_s, "first_rel_l2": rel, "stats": stats}


def p26_torch_bridge(torch, mt, smi):
    """(e): mx.th on the card."""
    a = mt.nd.array(np.random.default_rng(267).standard_normal(
        (64, 32), dtype=np.float32), ctx=mt.gpu(0))
    t = mt.th.to_torch(a)
    if t.data_ptr() != a._get().data_ptr() or not t.is_cuda:
        fail("to_torch of a gpu(0) NDArray is not its tensor")
    torch.manual_seed(268)
    lin = torch.nn.Linear(32, 16)
    g = mt.nd.array(np.ones((64, 16), np.float32), ctx=mt.gpu(0))
    res = {}
    for dev in ("cpu", "cuda"):
        lin_d = torch.nn.Linear(32, 16).to(dev)
        lin_d.load_state_dict(lin.state_dict())
        tm = mt.th.TorchModule(lin_d)
        ctx = mt.gpu(0) if dev == "cuda" else mt.cpu()
        y = tm.forward(a.as_in_context(ctx))
        dx = tm.backward(g.as_in_context(ctx))[0]
        res[dev] = (y.asnumpy(), dx.asnumpy(),
                    lin_d.weight.grad.detach().cpu().numpy())
    err = max(float(np.abs(c - h).max())
              for c, h in zip(res["cuda"], res["cpu"]))
    print("p26 (e): to_torch shares the gpu(0) NDArray's storage; "
          "TorchModule(nn.Linear) forward and backward on the card vs the "
          "CPU: max_abs_diff %.3g (atol 1e-5) (card %s)" % (err, smi))
    if not err <= 1e-5:
        fail("TorchModule on the card differs from the CPU by %g" % err)
    return {"err": err}


def p26_lock_child(prefix):
    """(f)'s child, run with MXNET_LOCK_CHECK=1: (c)'s engine with 4
    client threads, a checkpoint save and a trace dump; prints the lock
    order report as JSON."""
    import tempfile as _tf
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.analysis import lockcheck
    p26_ops(mt)
    mt.trace.set_enabled(True)
    rng = np.random.default_rng(269)
    items = [rng.uniform(-1, 1, 784).astype(np.float32)
             for _ in range(P26_REQUESTS)]
    engine = mt.serve.ServeEngine.from_checkpoint(
        prefix, 0, {"data": (1, 784), "softmax_label": (1,)}, fuse=True)
    try:
        answers, _ = serve_burst(engine, items, P26_THREADS)
    finally:
        engine.close()
    with _tf.TemporaryDirectory() as d:
        mgr = mt.checkpoint.CheckpointManager(os.path.join(d, "ckpt"))
        _s, arg, _a = mt.model.load_checkpoint(prefix, 0, ctx=mt.gpu(0))
        mgr.save(1, {k: v._get() for k, v in arg.items()})
        mgr.wait()
        mgr.close()
        mt.trace.dump_trace(os.path.join(d, "trace.json"))
    rep = lockcheck.lock_order_report()
    print(json.dumps({"enabled": rep["enabled"], "edges": rep["edges"],
                      "cycles": rep["cycles"],
                      "answers": sum(a is not None for a in answers)}))


def p26_lock_order(prefix, smi):
    """(f): the lock order of (c)'s engine in a child process."""
    env = dict(os.environ, MXNET_LOCK_CHECK="1")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--p26-lock-child", prefix], env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail("lock-order child failed (%d): %s" % (proc.returncode,
                                                   proc.stderr[-2000:]))
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    print("p26 (f): MXNET_LOCK_CHECK=1 child (engine, 4 clients, %d "
          "answers, a checkpoint save, a trace dump) in %.1f s: %d lock "
          "order edges, %d cycles: %s (card %s)"
          % (rep["answers"], time.perf_counter() - t0, len(rep["edges"]),
             len(rep["cycles"]), rep["edges"], smi))
    if not rep["enabled"] or rep["cycles"] or \
            rep["answers"] != P26_REQUESTS:
        fail("lock-order child: %s" % rep)
    return rep


def p26_phase(torch, mt, ck, smi):
    print("phase 26: users' kernels (rtc), Python ops in fit and serving, "
          "WarpCTC, the torch bridge, the lock order")
    t0 = time.perf_counter()
    walls = {}
    ops = p26_ops(mt)
    with tempfile.TemporaryDirectory() as tmp:
        mark = time.perf_counter()
        out = {"a": p26_rtc(torch, mt, smi)}
        walls["a"] = time.perf_counter() - mark
        mark = time.perf_counter()
        out["b"] = p26_python_ops_fit(torch, mt, ops, smi)
        walls["b"] = time.perf_counter() - mark
        mark = time.perf_counter()
        out["c"] = p26_serve(torch, mt, ck, ops, tmp, smi)
        walls["c"] = time.perf_counter() - mark
        mark = time.perf_counter()
        out["d"] = p26_warpctc(torch, mt, smi)
        walls["d"] = time.perf_counter() - mark
        mark = time.perf_counter()
        out["e"] = p26_torch_bridge(torch, mt, smi)
        walls["e"] = time.perf_counter() - mark
        mark = time.perf_counter()
        out["f"] = p26_lock_order(out["c"]["prefix"], smi)
        walls["f"] = time.perf_counter() - mark
    out["wall_s"] = time.perf_counter() - t0
    print("p26: walls %s s, phase %.1f s; card %s" % (
        json.dumps({k: round(v, 1) for k, v in walls.items()}),
        out["wall_s"], smi))
    return out


# ---------------------------------------------------------------------------
# phase 27: the native layer — the port's C++ engine and storage, its
# native I/O into ResNet-50, the predict ABI in this process, the C ABI
# from a C++ process, rtc through the ABI
#
# (a) a seeded dependency workload of host closures over 4 vars holding
#     ResNet-50 batches on the card: every final tensor and every read's
#     checksum bitwise those of the same closures run serially in push
#     order; the per-push host overhead over P27_PUSHES trivial pushes;
#     NativeStorage's pool hits for a block-size sequence (gated exactly)
# (b) P27_RECORDS records written with the port's NativeRecordWriter (JPEG
#     from tests/data/native_jpegs where libjpeg was found, else raw CHW
#     at 256 x 256, the same geometry) -> mx.io.ImageRecordIter at
#     ResNet-50's settings (a NativeImageRecordIter, gated) -> Module.fit;
#     the 8-thread batches bitwise a 1-thread run's; 0 kernel launches
# (c) VGG-16 through the fused serving pipeline, served by the port's
#     predict-only library opened in this process: outputs bitwise the
#     Python Predictor's, fused_fc_epilogue twice a forward
# (d) tests/data/capi_card_client.cc against the port's C ABI library:
#     the first update within P27_UPDATE_ATOL of the port's Python
#     Executor from the same init, the client's accuracy gate
# (e) MXRtcCreate/MXRtcPush with phase 26's softmax on gpu NDArrays made
#     through the ABI, within P26_RTC_ATOL of torch.softmax, one launch
#     counted

P27_VARS, P27_OPS = 4, 96
P27_PUSHES = 5000
P27_BLOCKS = (77070336, 4 << 20, 1 << 20, 4 << 20)   # bytes, four rounds
P27_RECORDS, P27_SIDE, P27_CROP, P27_THREADS = 1024, 256, 224, 8
P27_FIT_EPOCHS = 2
P27_VGG_BATCH, P27_FORWARDS = 8, 20
P27_MLP_STEPS = 300
# the ABI's device type for the card (1 would be the host)
P27_DEV_TYPE = 2
# the client's first update against the Python Executor's: the same
# float32 ops on the same card (cuBLAS picks per shape, not per caller)
P27_UPDATE_ATOL = 1e-6


def p27_probe():
    """What the card's machine offers the native layer; the phase then
    requires every piece found here."""
    import sysconfig
    from mxnet_tpu_torch import native_build
    inc = os.path.join(sysconfig.get_paths()["include"], "Python.h")
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    so = os.path.join(libdir, "libpython%s.so"
                      % sysconfig.get_config_var("LDVERSION"))
    with open("/proc/self/maps") as f:
        linked = "libpython" in f.read()
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True)
    probe = {"jpeglib.h": native_build.have_jpeg(),
             "Python.h": os.path.exists(inc),
             "libpython": so if os.path.exists(so) else None,
             "Py_ENABLE_SHARED": sysconfig.get_config_var("Py_ENABLE_SHARED"),
             "interpreter_links_libpython": linked,
             "g++": gxx.stdout.splitlines()[0] if gxx.returncode == 0
             else None}
    print("p27 probe: %s" % json.dumps(probe))
    missing = [k for k in ("Python.h", "libpython", "g++") if not probe[k]]
    if missing:
        fail("the native layer needs %s on this machine" % missing)
    return probe


def p27_engine(torch, mt, smi):
    """(a): host closures on the port's native engine against the same
    closures run serially."""
    from mxnet_tpu_torch import native_engine
    dev = torch.device("cuda", 0)
    shape = (RESNET_BATCH, 3, 224, 224)
    rng = np.random.default_rng(27)
    host = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .pin_memory() for _ in range(P27_VARS)]
    rs = np.random.RandomState(27)
    plan = []
    for _ in range(P27_OPS):
        k = int(rs.randint(1, 3))
        vs = [int(v) for v in rs.choice(P27_VARS, k, replace=False)]
        if rs.rand() < 0.6:
            plan.append(("w", vs, int(rs.randint(P27_VARS)),
                         float(rs.uniform(0.1, 1.0))))
        else:
            plan.append(("r", vs, None, None))

    def run(eng):
        accs = [torch.zeros(shape, device=dev) for _ in range(P27_VARS)]
        sums = [None] * len(plan)

        def write(vs, src, coef):
            x = host[src].to(dev, non_blocking=True)
            for v in vs:
                accs[v].mul_(0.5).add_(x, alpha=coef)

        def read(i, vs):
            sums[i] = torch.stack([accs[v].sum() for v in vs])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if eng is None:
            for i, (kind, vs, src, coef) in enumerate(plan):
                (write(vs, src, coef) if kind == "w" else read(i, vs))
            torch.cuda.synchronize()
        else:
            for i, (kind, vs, src, coef) in enumerate(plan):
                if kind == "w":
                    eng.push(lambda vs=vs, src=src, coef=coef:
                             write(vs, src, coef),
                             mutable_vars=[vvars[v] for v in vs])
                else:
                    eng.push(lambda i=i, vs=vs: read(i, vs),
                             const_vars=[vvars[v] for v in vs])
            eng.wait_for_all()
        return accs, sums, time.perf_counter() - t0

    eng = mt.engine.engine()
    vvars = [eng.new_var() for _ in range(P27_VARS)]
    run(None)               # warm: the allocator's blocks, first copies
    serial = run(None)
    pushed = run(eng)
    same = all(torch.equal(a, b) for a, b in zip(serial[0], pushed[0])) \
        and all((a is None and b is None) or torch.equal(a, b)
                for a, b in zip(serial[1], pushed[1]))
    nw = sum(1 for p in plan if p[0] == "w")
    out = {"closures_s": len(plan) / pushed[2],
           "serial_closures_s": len(plan) / serial[2]}
    print("p27 (a): %d closures (%d writes of a pinned %s float32 batch "
          "into the var's card tensor, %d checksum reads) over %d vars: "
          "engine %.1f closures/s (%.3f s), the same closures serially "
          "%.1f/s; final tensors and checksums bitwise the serial run's %s "
          "(gate); card %s"
          % (len(plan), nw, "x".join(map(str, shape)), len(plan) - nw,
             P27_VARS, out["closures_s"], pushed[2],
             out["serial_closures_s"], same, smi))
    if not same:
        fail("closures on the native engine differ from the serial run")
    del serial, pushed, host
    # the host cost of a push: trivial closures on the same vars
    t0 = time.perf_counter()
    for i in range(P27_PUSHES):
        eng.push(lambda: None, mutable_vars=[vvars[i % P27_VARS]])
    push_s = time.perf_counter() - t0
    eng.wait_for_all()
    drain_s = time.perf_counter() - t0
    for v in vvars:
        eng.delete_var(v)
    out["push_us"] = 1e6 * push_s / P27_PUSHES
    st = native_engine.NativeStorage()
    rounds = 4
    for _ in range(rounds):
        ptrs = [st.alloc(n) for n in P27_BLOCKS]
        for p in ptrs:
            st.free(p)
    out["hits"], allocs = st.pool_hits, st.num_allocs
    st.release_all()
    want_hits = (rounds - 1) * len(P27_BLOCKS)
    print("p27 (a): %d trivial pushes: %.2f us a push on the host (%.3f s "
          "to drain); NativeStorage over %d rounds of blocks %s: %d pool "
          "hits (want %d), %d allocations" % (
              P27_PUSHES, out["push_us"], drain_s, rounds,
              list(P27_BLOCKS), out["hits"], want_hits, allocs))
    if out["hits"] != want_hits:
        fail("NativeStorage pool hits %d, want %d" % (out["hits"],
                                                      want_hits))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def p27_write_rec(mt, path, jpeg):
    """P27_RECORDS records with the port's NativeRecordWriter, labels in
    [0, 1000) from a numpy seed: the committed JPEGs in turn, or raw CHW
    uint8 at P27_SIDE x P27_SIDE with the (h, w) uint16 prefix the loader
    crops from."""
    rng = np.random.default_rng(271)
    labels = rng.integers(0, 1000, P27_RECORDS)
    w = mt.native_io.NativeRecordWriter(path)
    if jpeg:
        import glob
        files = sorted(glob.glob(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tests", "data",
            "native_jpegs", "*.jpg")))
        blobs = [open(f, "rb").read() for f in files]
        for i in range(P27_RECORDS):
            w.write_image(float(labels[i]), i, blobs[i % len(blobs)])
    else:
        prefix = bytes([P27_SIDE & 255, P27_SIDE >> 8] * 2)
        for i in range(P27_RECORDS):
            img = rng.integers(0, 256, (3, P27_SIDE, P27_SIDE),
                               dtype=np.uint8)
            w.write_image(float(labels[i]), i, prefix + img.tobytes())
    w.close()


class TimedIter:
    """A data iterator that adds the wall of each ``next()`` to
    ``seconds`` (the loader's share of a fit)."""

    def __init__(self, it):
        self.it = it
        self.seconds = 0.0
        self.batch_size = it.batch_size
        self.provide_data = it.provide_data
        self.provide_label = it.provide_label

    def reset(self):
        self.it.reset()

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        t0 = time.perf_counter()
        try:
            return self.it.next()
        finally:
            self.seconds += time.perf_counter() - t0


def p27_io(torch, mt, ck, smi, tmp, jpeg):
    """(b): the native loader into ResNet-50."""
    rec = os.path.join(tmp, "p27.rec")
    t0 = time.perf_counter()
    p27_write_rec(mt, rec, jpeg)
    print("p27 (b): %d %s records written by the port's NativeRecordWriter "
          "(%d bytes) in %.1f s" % (
              P27_RECORDS, "JPEG" if jpeg else "raw CHW 3x%dx%d" % (
                  P27_SIDE, P27_SIDE), os.path.getsize(rec),
              time.perf_counter() - t0))
    if not mt.native_io.jpeg_available():
        # this machine's I/O library has no JPEG path: a JPEG record
        # raises naming libjpeg, never decodes into garbage
        jrec = os.path.join(tmp, "p27-jpeg.rec")
        w = mt.native_io.NativeRecordWriter(jrec)
        w.write_image(1.0, 0, open(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tests", "data",
            "native_jpegs", "img00.jpg"), "rb").read())
        w.close()
        try:
            mt.native_io.NativeBatchLoader(jrec, 1, (3, 224, 224),
                                           resize=256).next()
        except RuntimeError as e:
            msg = str(e)
        else:
            fail("a JPEG record decoded without libjpeg")
        if "libjpeg" not in msg:
            fail("the JPEG error does not name libjpeg: %r" % msg)
        print("p27 (b): a JPEG record raises without libjpeg: %r" % msg)
    kw = dict(path_imgrec=rec, data_shape=(3, P27_CROP, P27_CROP),
              batch_size=RESNET_BATCH, resize=P27_SIDE, rand_crop=True,
              rand_mirror=True, mean_r=FEED_MEAN[0], mean_g=FEED_MEAN[1],
              mean_b=FEED_MEAN[2], seed=27)
    it = mt.io.ImageRecordIter(preprocess_threads=P27_THREADS, **kw)
    if type(it).__name__ != "NativeImageRecordIter":
        fail("ImageRecordIter at ResNet-50's settings is %s, not the native "
             "loader" % type(it).__name__)
    t0 = time.perf_counter()
    batches = list(it)
    load_s = time.perf_counter() - t0
    one = list(mt.io.ImageRecordIter(preprocess_threads=1, **kw))
    same = len(one) == len(batches) == P27_RECORDS // RESNET_BATCH and all(
        a.pad == b.pad and np.array_equal(a.data[0].asnumpy(),
                                          b.data[0].asnumpy())
        and np.array_equal(a.label[0].asnumpy(), b.label[0].asnumpy())
        for a, b in zip(batches, one))
    img_s = P27_RECORDS / load_s
    print("p27 (b): ImageRecordIter(%s) -> %s: one epoch of %d batches of "
          "%d alone %.1f img/s at %d threads; batches bitwise a 1-thread "
          "run's %s (gate)" % (
              ", ".join("%s=%s" % kv for kv in sorted(kw.items())
                        if kv[0] != "path_imgrec"),
              type(it).__name__, len(batches), RESNET_BATCH, img_s,
              P27_THREADS, same))
    if not same:
        fail("the native loader's 8-thread batches differ from 1 thread's")
    del batches, one
    sym, arg0, aux0, _, _, _ = resnet_setup(mt, 0, 27)
    timed = TimedIter(mt.io.ImageRecordIter(preprocess_threads=P27_THREADS,
                                            **kw))
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    n = P27_RECORDS // RESNET_BATCH
    marks, loads, losses = [], [], []

    def cb(p):
        if p.epoch == P27_FIT_EPOCHS - 1 and p.nbatch in (0, n - 1):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            loads.append(timed.seconds)
        if p.nbatch == n - 1:
            losses.append(float(p.eval_metric.get_name_value()[0][1]))
    ck.reset_launches()
    t0 = time.perf_counter()
    mod.fit(timed, num_epoch=P27_FIT_EPOCHS, arg_params=arg0,
            aux_params=aux0, optimizer="sgd",
            optimizer_params=dict(TRAIN_OPT), eval_metric="ce",
            batch_end_callback=cb)
    fit_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    stats = mod._fused.stats.report()
    wall = marks[1] - marks[0]
    fit_img_s = RESNET_BATCH * (n - 1) / wall
    share = (loads[1] - loads[0]) / wall
    print("p27 (b): ResNet-50 Module.fit from the native iterator, %d "
          "epochs of %d batches in %.1f s: fused step %s; the last epoch's "
          "last %d steps %.1f img/s, the loader's next() %.3f of that wall; "
          "cross-entropy after each epoch %s; hand-kernel launches %s; "
          "card %s" % (P27_FIT_EPOCHS, n, fit_s, stats, n - 1, fit_img_s,
                       share, [round(x, 4) for x in losses], launches, smi))
    if not all(math.isfinite(x) for x in losses):
        fail("ResNet-50 from the native loader: loss %s" % losses)
    if sum(launches.values()) != 0:
        fail("hand kernels launched while training ResNet-50: %s"
             % launches)
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    return {"loader_img_s": img_s, "fit_img_s": fit_img_s,
            "loader_share": share, "loss": losses[-1], "jpeg": jpeg}


def p27_abi(mt, name):
    """The port's in-process ABI library ``name`` (no -lpython: its
    Python symbols resolve from this interpreter), with MXGetLastError
    typed, and a checker that raises with it."""
    import ctypes
    lib = mt.native_build.load(name)
    lib.MXGetLastError.restype = ctypes.c_char_p

    def ok(rc, what):
        if rc != 0:
            fail("%s through %s: %s" % (what, name,
                                        lib.MXGetLastError().decode()))
    return lib, ok


def p27_predict(torch, mt, ck, smi, tmp):
    """(c): VGG-16's fused serving graph through MXPred* in this
    process against the Python Predictor with the same pipeline."""
    import ctypes
    sym = mt.models.get_vgg(num_classes=1000)
    b = P27_VGG_BATCH
    shapes = {"data": (b, 3, 224, 224), "softmax_label": (b,)}
    params = xavier_params(sym, {"data": (1, 3, 224, 224),
                                 "softmax_label": (1,)}, 27)
    pipeline = mt.passes.build_serving_pipeline(fuse=True, ctx=mt.gpu(0))
    fsym, fparams = pipeline.run(sym, {k: mt.nd.array(v, ctx=mt.cpu())
                                       for k, v in params.items()})
    nfused = [n["op"] for n in json.loads(fsym.tojson())["nodes"]].count(
        "_fused_FullyConnected")
    path = os.path.join(tmp, "vgg16-fused.params")
    mt.nd.save(path, {"arg:" + k: v if isinstance(v, mt.nd.NDArray)
                      else mt.nd.array(v, ctx=mt.cpu())
                      for k, v in fparams.items()})
    blob = open(path, "rb").read()
    js = fsym.tojson().encode()
    lib, ok = p27_abi(mt, "predict_inproc")
    keys = (ctypes.c_char_p * 2)(b"data", b"softmax_label")
    indptr = (ctypes.c_uint * 3)(0, 4, 5)
    dims = (ctypes.c_uint * 5)(b, 3, 224, 224, b)
    h = ctypes.c_void_p()
    ok(lib.MXPredCreate(js, blob, len(blob), P27_DEV_TYPE, 0, 2, keys,
                        indptr, dims, ctypes.byref(h)), "MXPredCreate")
    sdata, sdim = ctypes.POINTER(ctypes.c_uint)(), ctypes.c_uint()
    ok(lib.MXPredGetOutputShape(h, 0, ctypes.byref(sdata),
                                ctypes.byref(sdim)), "MXPredGetOutputShape")
    oshape = tuple(sdata[i] for i in range(sdim.value))
    ref = mt.Predictor(sym.tojson(), params, shapes,
                       {1: "cpu", 2: "gpu"}[P27_DEV_TYPE], 0,
                       pipeline=pipeline)
    rng = np.random.default_rng(272)
    xs = [np.stack([wire_to_nchw(rng.integers(0, 256, (224, 224, 3),
                                              dtype=np.uint8))
                    for _ in range(b)]) for _ in range(P27_FORWARDS)]
    fp = ctypes.POINTER(ctypes.c_float)

    def abi_forward(x):
        x = np.ascontiguousarray(x, np.float32)
        ok(lib.MXPredSetInput(h, b"data", x.ctypes.data_as(fp), x.size),
           "MXPredSetInput")
        ok(lib.MXPredForward(h), "MXPredForward")
        y = np.empty(oshape, np.float32)
        ok(lib.MXPredGetOutput(h, 0, y.ctypes.data_as(fp), y.size),
           "MXPredGetOutput")
        return y

    def py_forward(x):
        ref.set_input("data", x)
        ref.forward()
        return np.asarray(ref.get_output(0))

    abi_forward(xs[0])                      # warm: binds, cuDNN picks
    py_forward(xs[0])
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    got = [abi_forward(x) for x in xs]
    abi_s = time.perf_counter() - t0
    abi_launches = ck.LAUNCHES["fused_fc_epilogue"]
    ck.reset_launches()
    t0 = time.perf_counter()
    want = [py_forward(x) for x in xs]
    py_s = time.perf_counter() - t0
    py_launches = ck.LAUNCHES["fused_fc_epilogue"]
    same = all(np.array_equal(a, c) for a, c in zip(got, want))
    finite = all(np.isfinite(a).all() for a in got)
    worst = max(float(np.abs(a - c).max()) for a, c in zip(got, want))
    # the bridge's predictor holds its outputs on the card: read their
    # context through the full ABI (MXNDArrayGetContext)
    from mxnet_tpu_torch import capi_bridge
    capi, cok = p27_abi(mt, "capi_inproc")
    pred = capi_bridge._get(h.value)
    oh = capi_bridge._put(pred._exec.outputs[0])
    dt, di = ctypes.c_int(), ctypes.c_int()
    cok(capi.MXNDArrayGetContext(ctypes.c_void_p(oh), ctypes.byref(dt),
                                 ctypes.byref(di)), "MXNDArrayGetContext")
    capi_bridge.free_handle(oh)
    ok(lib.MXPredFree(h), "MXPredFree")
    print("p27 (c): VGG-16 %dx3x224x224 through the fused serving pipeline "
          "(%d _fused_FullyConnected nodes), %d forwards through the "
          "in-process predict library (MXPredCreate dev_type=%d): outputs %s "
          "bitwise the Python Predictor's %s (gate; max abs diff %.3g), "
          "finite %s; fused_fc_epilogue launches %d through the ABI and %d "
          "through Python (want %d each); MXNDArrayGetContext of the "
          "output (%d, %d); %.3f ms a forward through the ABI (%.1f MB in, "
          "%d floats out) against %.3f ms through Predictor (x%.3f); card %s"
          % (b, nfused, P27_FORWARDS, P27_DEV_TYPE, oshape, same, worst,
             finite,
             abi_launches, py_launches, 2 * P27_FORWARDS, dt.value, di.value,
             1e3 * abi_s / P27_FORWARDS, xs[0].nbytes / 1e6,
             int(np.prod(oshape)), 1e3 * py_s / P27_FORWARDS, abi_s / py_s,
             smi))
    if nfused != 2:
        fail("the fused VGG-16 graph has %d fused FC nodes" % nfused)
    if not (same and finite):
        fail("the predict ABI's outputs differ from Predictor's (max abs "
             "diff %g)" % worst)
    if abi_launches != 2 * P27_FORWARDS or py_launches != 2 * P27_FORWARDS:
        fail("fused_fc_epilogue launched %d / %d times in %d forwards"
             % (abi_launches, py_launches, P27_FORWARDS))
    if (dt.value, di.value) != (P27_DEV_TYPE, 0):
        fail("the predictor's output context is (%d, %d), not the card"
             % (dt.value, di.value))
    del ref, pred
    gc.collect()
    torch.cuda.empty_cache()
    return {"abi_ms": 1e3 * abi_s / P27_FORWARDS,
            "py_ms": 1e3 * py_s / P27_FORWARDS,
            "launches": abi_launches + py_launches}


def client_first_update(mt, out_dir, ctx):
    """Replay the C++ client's first update (tests/data/capi_card_client.cc)
    with the port's Python Executor on ``ctx``: the same init, the first
    batch, forward/backward and the bridge's SGD (momentum 0.9,
    rescale_grad 1/100, lr 0.1).  -> (max abs difference from the client's
    step1.bin, the number of parameters)."""
    batch, dim = 100, 784
    raw = np.fromfile(os.path.join(out_dir, "data.bin"), np.float32)
    n = raw.size // (dim + 1)
    x, y = raw[:n * dim].reshape(n, dim), raw[n * dim:]
    net = mt.sym.Variable("data")
    for i, hid in enumerate((128, 64), 1):
        net = mt.sym.Activation(mt.sym.FullyConnected(
            net, num_hidden=hid, name="fc%d" % i), act_type="relu",
            name="relu%d" % i)
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        net, num_hidden=10, name="fc3"), name="softmax")
    exe = net.simple_bind(ctx, data=(batch, dim), softmax_label=(batch,))
    names = net.list_arguments()
    init = np.fromfile(os.path.join(out_dir, "init.bin"), np.float32)
    want = np.fromfile(os.path.join(out_dir, "step1.bin"), np.float32)
    off = 0
    for nm in names:
        if nm in ("data", "softmax_label"):
            continue
        a = exe.arg_dict[nm]
        a[:] = init[off:off + a.size].reshape(a.shape)
        off += a.size
    exe.arg_dict["data"][:] = x[:batch]
    exe.arg_dict["softmax_label"][:] = y[:batch]
    exe.forward(is_train=True)
    exe.backward()
    opt = mt.optimizer.Optimizer.create_optimizer(
        "sgd", momentum=0.9, rescale_grad=1.0 / batch)
    opt.lr, opt.wd = 0.1, 0.0
    got = []
    for i, nm in enumerate(names):
        if nm in ("data", "softmax_label"):
            continue
        w, g = exe.arg_dict[nm], exe.grad_dict[nm]
        opt.update(i, w, g, opt.create_state(i, w))
        got.append(w.asnumpy().ravel())
    got = np.concatenate(got)
    return float(np.abs(got - want).max()), int(got.size)


def p27_client(torch, mt, smi, tmp, root):
    """(d): the C ABI from a C++ process on the card."""
    src = os.path.join(root, "tests", "data", "capi_card_client.cc")
    lib = mt.native_build.path("capi")
    binary = os.path.join(tmp, "capi_card_client")
    t0 = time.perf_counter()
    subprocess.run(["g++", "-O1", "-std=c++17", src, "-o", binary, lib,
                    "-Wl,-rpath," + os.path.dirname(lib)], check=True)
    build_s = time.perf_counter() - t0
    out_dir = os.path.join(tmp, "client")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run([binary, out_dir, str(P27_DEV_TYPE),
                          str(P27_MLP_STEPS)],
                         env=mt.native_build.embed_env(),
                         capture_output=True, text=True, timeout=600)
    run_s = time.perf_counter() - t0
    if res.returncode != 0 or "CAPI CARD CLIENT PASSED" not in res.stdout:
        fail("the C++ client failed (exit %d): %s %s" % (
            res.returncode, res.stdout[-1500:], res.stderr[-1500:]))
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("CLIENT ")][0].split()
    steps_s, acc = float(line[4]), float(line[6])
    err, nparams = client_first_update(mt, out_dir, mt.gpu(0))
    # the same MLP through the Python fused step (Module.fit), for scale
    raw = np.fromfile(os.path.join(out_dir, "data.bin"), np.float32)
    n = raw.size // 785
    it = mt.io.NDArrayIter(raw[:n * 784].reshape(n, 784), raw[n * 784:],
                           batch_size=100)
    net = mt.sym.Variable("data")
    for i, hid in enumerate((128, 64), 1):
        net = mt.sym.Activation(mt.sym.FullyConnected(
            net, num_hidden=hid, name="fc%d" % i), act_type="relu")
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        net, num_hidden=10, name="fc3"), name="softmax")
    mod = mt.mod.Module(net, context=mt.gpu(0))
    per_epoch = n // 100
    epochs = P27_MLP_STEPS // per_epoch
    marks = []

    def mark(p):
        if (p.epoch, p.nbatch) in ((0, 0), (epochs - 1, per_epoch - 1)):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            batch_end_callback=mark)
    py_steps_s = (epochs * per_epoch - 1) / (marks[1] - marks[0])
    print("p27 (d): tests/data/capi_card_client.cc built against "
          "cpp-package/include and %s in %.1f s; %d steps of the "
          "784-128-64-10 MLP at batch 100 on Context(2, 0) through "
          "MXExecutor* and MXOptimizerUpdate: %.1f steps/s, training "
          "accuracy %.4f (gate 0.9), the process %.1f s; the first update "
          "against the port's Python Executor on gpu(0) from the same init: "
          "max abs diff %.3g over %d parameters (gate %g); the same MLP "
          "through Module.fit's fused step %.1f steps/s; card %s"
          % (os.path.basename(lib), build_s, P27_MLP_STEPS, steps_s, acc,
             run_s, err, nparams, P27_UPDATE_ATOL, py_steps_s, smi))
    if not err <= P27_UPDATE_ATOL:
        fail("the C++ client's first update differs from the Python "
             "Executor's by %g" % err)
    return {"steps_s": steps_s, "accuracy": acc, "first_update_err": err,
            "py_steps_s": py_steps_s}


def p27_rtc(torch, mt, smi):
    """(e): phase 26's softmax through MXRtcCreate/MXRtcPush on gpu
    NDArrays made through the ABI."""
    import ctypes
    from mxnet_tpu_torch import rtc
    lib, ok = p27_abi(mt, "capi_inproc")
    rows, cols, block = P26_RTC_SHAPES[1]
    x = np.random.default_rng(273).standard_normal(
        (rows, cols), dtype=np.float32)
    shape = (ctypes.c_uint * 2)(rows, cols)
    hx, hy = ctypes.c_void_p(), ctypes.c_void_p()
    ok(lib.MXNDArrayCreate(shape, 2, P27_DEV_TYPE, 0, 0, ctypes.byref(hx)),
       "MXNDArrayCreate")
    ok(lib.MXNDArrayCreate(shape, 2, P27_DEV_TYPE, 0, 0, ctypes.byref(hy)),
       "MXNDArrayCreate")
    fp = ctypes.POINTER(ctypes.c_float)
    ok(lib.MXNDArraySyncCopyFromCPU(hx, x.ctypes.data_as(fp), x.size),
       "MXNDArraySyncCopyFromCPU")
    names_in = (ctypes.c_char_p * 1)(b"x")
    names_out = (ctypes.c_char_p * 1)(b"y")
    ins = (ctypes.c_void_p * 1)(hx.value)
    outs = (ctypes.c_void_p * 1)(hy.value)
    hr = ctypes.c_void_p()
    ok(lib.MXRtcCreate(b"softmax", 1, 1, names_in, names_out, ins, outs,
                       RTC_SOFTMAX.encode(), ctypes.byref(hr)),
       "MXRtcCreate")
    n0 = rtc.LAUNCHES.get("softmax", 0)
    ok(lib.MXRtcPush(hr, 1, 1, ins, outs, rows, 1, 1, block, 1, 1),
       "MXRtcPush")
    launched = rtc.LAUNCHES.get("softmax", 0) - n0
    y = np.empty((rows, cols), np.float32)
    ok(lib.MXNDArraySyncCopyToCPU(hy, y.ctypes.data_as(fp), y.size),
       "MXNDArraySyncCopyToCPU")
    dt, di = ctypes.c_int(), ctypes.c_int()
    ok(lib.MXNDArrayGetContext(hy, ctypes.byref(dt), ctypes.byref(di)),
       "MXNDArrayGetContext")
    want = torch.softmax(torch.from_numpy(x).cuda(), dim=1).cpu().numpy()
    err = float(np.abs(y - want).max())
    for hnd in (hx, hy):
        ok(lib.MXNDArrayFree(hnd), "MXNDArrayFree")
    ok(lib.MXRtcFree(hr), "MXRtcFree")
    print("p27 (e): MXRtcCreate/MXRtcPush with phase 26's softmax at %dx%d "
          "block %d on NDArrays made through the ABI on (%d, %d): max_abs_err "
          "%.3g against torch.softmax (atol %g), rtc.LAUNCHES counted %d "
          "push; card %s" % (rows, cols, block, dt.value, di.value, err,
                             P26_RTC_ATOL, launched, smi))
    if not err <= P26_RTC_ATOL or launched != 1 or dt.value != P27_DEV_TYPE:
        fail("rtc through the ABI: err %g, %d launches, device type %d"
             % (err, launched, dt.value))
    return {"err": err, "launches": launched}


def p27_phase(torch, mt, ck, smi, root, native_build_thread):
    print("phase 27: the native layer (the port's C++ engine, storage and "
          "loader, the C ABI and predict libraries)")
    t0 = time.perf_counter()
    probe = p27_probe()
    native_build_thread.join()
    if native_build_thread.error is not None:
        raise native_build_thread.error
    nb = mt.native_build
    print("p27 build: %d g++ runs in this process (%s), started with the "
          "kernels' nvcc builds; walls %s s" % (
              nb.GXX_RUNS, sorted(nb.OBJECTS),
              json.dumps({k: round(v, 1) for k, v in
                          nb.BUILD_WALLS.items()})))
    walls = {}
    out = {"probe": probe}
    with tempfile.TemporaryDirectory() as tmp:
        for leg, fn in (("a", lambda: p27_engine(torch, mt, smi)),
                        ("b", lambda: p27_io(torch, mt, ck, smi, tmp,
                                             probe["jpeglib.h"])),
                        ("c", lambda: p27_predict(torch, mt, ck, smi, tmp)),
                        ("d", lambda: p27_client(torch, mt, smi, tmp, root)),
                        ("e", lambda: p27_rtc(torch, mt, smi))):
            mark = time.perf_counter()
            out[leg] = fn()
            walls[leg] = time.perf_counter() - mark
    out["wall_s"] = time.perf_counter() - t0
    print("p27: walls %s s, phase %.1f s; card %s" % (
        json.dumps({k: round(v, 1) for k, v in walls.items()}),
        out["wall_s"], smi))
    return out


# ---------------------------------------------------------------------------
# phase 28: float16 and bfloat16 in paged_attention, flash_attention,
# correlation and fused_fc_epilogue (its 16-bit cases are in phase 3)
#
# (a) each kernel's float16 and bfloat16 instances at the main paths'
#     shapes and at ragged ones (T no multiple of the tile, an odd head dim
#     or width, every head-dim bucket, operands only 2-byte aligned, an
#     empty slot), each held to the float32 instance on the same values
#     upcast, then rounded to the dtype: correlation's |a - b| bitwise (it
#     converts at the shared-memory read and keeps the float32
#     arithmetic), flash, paged and correlation's products within one unit
#     in the last place of it (their 16-bit products on the tensor cores
#     sum in another order, and two float32 results a few ulps apart can
#     round to neighbouring 16-bit values); each within one
#     unit in the last place of its plain version (ck.HALF_ULP, phase 3's
#     16-bit rule); two calls bitwise equal; paged's stripes and scattered
#     pages bitwise equal in both dtypes; a call with mixed float dtypes,
#     a float32 q over 16-bit pools among them, bitwise the float32
#     instance's output cast to q's dtype;
# (b) FlowNetC's correlation stage (phase 11's geometry, weights and
#     frames) through Predictor bound in float16 (type_dict) and through
#     simple_bind in bfloat16 (the port's Predictor types its inputs with
#     numpy, which has no bfloat16 without ml_dtypes): the correlation
#     kernel once a forward in the stage's dtype, the Correlation node's
#     inputs captured (a monitor callback) and the kernel held on them as
#     in (a), the stage within FLOWNETC_HALF_RTOL of phase 11's float32
#     stage;
# (c) search_flash at the search shape in float16 and in bfloat16: each
#     winner stored under its dtype's class, a second search a store hit
#     with 0 launches, flash_attention on tensors of the dtype resolving
#     the winner under MXNET_KERNEL_SEARCH=1;
# (d) search_paged in bfloat16 at phase 24's shapes (GPT-2 small's
#     heads), then paged_attention over bfloat16 and float16 views of a
#     KVBlockPool (add_view(dtype=)) with every slot at the page table's
#     capacity, causal and not, the bfloat16 calls resolving the winner;
# (e) each half instance timed beside the float32 instance, its plain
#     version and one library call in its dtype (gather + SDPA for paged,
#     SDPA for flash, none for correlation), its bound at 2 bytes an
#     element, and the earlier design's time, quoted (EARLIER_HALF_MS);
#     correlation also at PWC-Net's shape; fused_fc_epilogue's float16
#     and bfloat16 tensor-core instance at fc6 + fc7 (bucket 8), at every
#     tile, beside addmm + relu_ in the dtype, with the launches on (f)'s
#     path;
# (f) VGG-16 at full width (phase 4's checkpoint, 138,357,544 parameters)
#     with the serving pipeline's fusion and no quantize (fc6 and fc7
#     become _fused_FullyConnected with relu), bound at bucket 8 in
#     float16 through Predictor(type_dict=float16, pipeline=) and in
#     bfloat16 through simple_bind(type_dict=bfloat16) on the fused graph:
#     4 forwards each on phase 4's wire images, fused_fc_epilogue launched
#     2 times a forward in the dtype, fc6's inputs captured (a monitor
#     callback) and the kernel held on them as in phase 3, the logits
#     (fc8's output) within VGG_HALF_RTOL of the float32 fused forward's
#     on the same images.  (Phase 5's float16 engine launches the kernel 0
#     times: its Cast sandwich leaves FullyConnected unfused, as the JAX
#     package's does.)

HALF_NAMES = ("float16", "bfloat16")
# FlowNetC's stage in a 16-bit dtype against the float32 stage, relative
# L2: float16 keeps 11 significant bits (unit roundoff 2^-11), so the
# rounded images, weights and activations of five convolutions and the
# correlation leave the stage near 1e-3 apart: 5e-3 holds a right path,
# while a wrong dtype path, channel order or displacement moves it by
# O(1).  bfloat16 keeps 8 bits (2^-8, 8x float16's): 8 x 5e-3.
FLOWNETC_HALF_RTOL = {"float16": 5e-3, "bfloat16": 4e-2}
# VGG-16's logits in a 16-bit dtype against the float32 fused forward's,
# relative L2, derived as FLOWNETC_HALF_RTOL: float16's unit roundoff
# 2^-11 ~ 4.9e-4 enters at the rounded images, weights and activations of
# 16 layers, about 16 x that if the errors added up in step and 4 x at
# random: 1e-2 holds a right path, while a wrong dtype path, weight
# layout or fragment order moves the logits by O(1).  bfloat16 keeps 8
# bits (2^-8, 8x float16's): 8e-2.
VGG_HALF_RTOL = {"float16": 1e-2, "bfloat16": 8e-2}


def odd_offset(torch, x):
    """x's values in a contiguous tensor that starts one element past an
    aligned one: 16-bit operands only 2-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def half_args(torch, args, dtype, odd=False):
    """args with every float tensor cast to ``dtype`` (at an odd element
    offset with ``odd``); other arguments as they are."""
    out = []
    for a in args:
        if torch.is_tensor(a) and a.is_floating_point():
            a = a.to(dtype)
            if odd:
                a = odd_offset(torch, a)
        out.append(a)
    return out


def upcast(torch, args):
    return [a.float() if torch.is_tensor(a) and a.is_floating_point() else a
            for a in args]


def hold_half(torch, ck, label, kernel, plain, args, dtype, zero_rows=None,
              exact=True):
    """kernel(*args) in a 16-bit dtype against the float32 instance on the
    upcast arguments, rounded to ``dtype``: bitwise with ``exact`` (the
    instance keeps the float32 arithmetic), else within HALF_ULP[dtype] *
    max(1, max|that|) (the instance's own 16-bit products: two float32
    results a few ulps apart can round to neighbouring 16-bit values);
    within HALF_ULP[dtype] * max(1, max|plain|) of plain(*args); two calls
    bitwise equal; finite; ``zero_rows`` (a mask of output rows) all zero.
    -> max abs error against the plain version."""
    half = kernel(*args)
    again = kernel(*args)
    want = kernel(*upcast(torch, args)).to(dtype)
    ref = plain(*args)
    torch.cuda.synchronize()
    f32_err = (half.float() - want.float()).abs().max().item()
    f32_tol = 0.0 if exact else \
        ck.HALF_ULP[dtype] * max(1.0, want.float().abs().max().item())
    near = half.dtype == dtype and (torch.equal(half, want) if exact
                                    else f32_err <= f32_tol)
    repeat = torch.equal(half, again)
    err = (half.float() - ref.float()).abs().max().item()
    tol = ck.HALF_ULP[dtype] * max(1.0, ref.float().abs().max().item())
    finite = bool(torch.isfinite(half).all())
    zeros = zero_rows is None or bool((half[zero_rows] == 0).all())
    print("kernel check half %-30s %-14s %s float32 instance rounded: %s "
          "err=%.3g tol=%.3g; max_abs_err=%.3g tol=%.3g repeat=%s finite=%s "
          "empty-zero=%s" % (label, dtype, tuple(half.shape),
                             "bitwise" if exact else "within",
                             f32_err, f32_tol, err, tol, repeat, finite,
                             zeros))
    if not (near and repeat and err <= tol and finite and zeros):
        fail("half %s %s: against the float32 instance %.3g (tol %.3g), "
             "max_abs_err %.3g (tol %.3g), two calls equal %s, finite %s, "
             "empty rows zero %s" % (label, dtype, f32_err, f32_tol, err,
                                     tol, repeat, finite, zeros))
    return err


def hold_mixed(torch, label, kernel, args):
    """A call with mixed float dtypes: bitwise the float32 instance on the
    upcast arguments, cast to the first operand's dtype."""
    got = kernel(*args)
    want = kernel(*upcast(torch, args)).to(args[0].dtype)
    torch.cuda.synchronize()
    same = got.dtype == args[0].dtype and torch.equal(got, want)
    print("kernel check mixed %-29s %s -> %s bitwise the float32 instance "
          "cast=%s" % (label, [str(a.dtype) for a in args[:3]
                               if torch.is_tensor(a)
                               and a.is_floating_point()], got.dtype, same))
    if not same:
        fail("mixed %s: not the float32 instance's output cast" % label)


def p28_kernel_checks(torch, ck):
    """(a): -> {kernel: {dtype name: max abs error at the main shapes}}."""
    dev = torch.device("cuda", 0)
    part = ck.PAGED_PARTITION_KEYS
    edges = np.array([part, part - 1, part + 1, 0, 1024, part + 4,
                      2 * part + 10, 3 * part + 16], np.int32)
    paged_cases = [("main-C%d" % c, dict(seed=c, lengths=PAGED_SPREAD, c=c,
                                         blocks=1100), True, False, True)
                   for c in (1, 9, 32)]
    paged_cases += [
        ("part-edges-C9-full", dict(seed=49, lengths=edges, c=9), False,
         False, False),
        ("C1-D128", dict(seed=17, lengths=edges, c=1, h=4, d=128), True,
         False, False),
        ("odd-D9", dict(seed=16, lengths=[5, 77, 0, 33], c=4, h=3, d=9,
                        bt=16, b=8), True, False, False),
        ("C9-D128", dict(seed=13, lengths=edges, c=9, h=4, d=128), True,
         False, False),
        ("C32-D32", dict(seed=14, lengths=edges, c=32, h=6, d=32), True,
         False, False),
        ("2-byte-aligned-C1", dict(seed=19, lengths=edges, c=1), True, True,
         False),
        ("2-byte-aligned-C32", dict(seed=12, lengths=edges, c=32), True,
         True, False)]
    flash_cases = [("main-causal", FLASH_SHAPE, True, False, True),
                   ("main-full", FLASH_SHAPE, False, False, True),
                   ("ragged-T77", (2, 77, 3, 64), True, False, False),
                   ("ragged-T77-full", (2, 77, 3, 64), False, False, False),
                   ("odd-D9", (2, 100, 3, 9), True, False, False),
                   ("D32", (2, 200, 3, 32), True, False, False),
                   ("D128", (1, 300, 2, 128), True, False, False),
                   ("2-byte-aligned", (2, 129, 3, 64), True, True, False)]
    corr_cases = [("flownetc", FLOWNETC, True, False, True),
                  ("flownetc-abs", FLOWNETC, False, False, False),
                  ("pwcnet", PWCNET, True, False, True),
                  ("ragged-w45", dict(n=3, c=5, h=7, w=45, m=3, s2=2), True,
                   False, False),
                  ("s2-w44", dict(n=2, c=19, h=13, w=44, m=5, s2=2), True,
                   False, False),
                  ("2-byte-aligned-s2-w44", dict(n=2, c=19, h=13, w=44, m=5,
                                                 s2=2), False, True, False),
                  ("odd-c7-s1", dict(n=1, c=7, h=20, w=40, m=10, s2=1), True,
                   True, False),
                  # the tensor-core instance with its window 3 columns off
                  # its 16-byte copies; a width those copies cannot stage
                  # and a window wider than its 8 n-tiles, both on the
                  # SIMT instance
                  ("shift3-s1", dict(n=2, c=40, h=11, w=64, m=5, s2=1), True,
                   False, False),
                  ("w70-s1", dict(n=1, c=9, h=6, w=70, m=2, s2=1), True,
                   False, False),
                  ("wide-m30-s2", dict(n=1, c=24, h=10, w=64, m=30, s2=2),
                   True, False, False)]
    main = {k: {n: 0.0 for n in HALF_NAMES}
            for k in ("paged_attention", "flash_attention", "correlation")}
    for name in HALF_NAMES:
        dt = getattr(torch, name)
        for label, kw, causal, odd, is_main in paged_cases:
            case = paged_case(torch, dev, **kw)
            args = half_args(torch, paged_args(case), dt, odd)
            empty = torch.from_numpy(case["np_lengths"] == 0).to(dev)
            err = hold_half(
                torch, ck, "paged %s causal=%d" % (label, causal),
                lambda *a: ck.paged_attention(*a, causal=causal),
                lambda *a: ck.paged_attention_reference(*a, causal=causal),
                args, dt, zero_rows=empty, exact=False)
            if is_main:
                main["paged_attention"][name] = max(
                    main["paged_attention"][name], err)
        for seed, (label, shape, causal, odd, is_main) in enumerate(
                flash_cases):
            args = half_args(torch, flash_inputs(torch, dev, 500 + seed,
                                                 *shape), dt, odd)
            err = hold_half(
                torch, ck, "flash %s %s causal=%d" % (label, shape, causal),
                lambda *a: ck.flash_attention(*a, causal=causal),
                lambda *a: ck.flash_attention_reference(*a, causal=causal),
                args, dt, exact=False)
            if is_main:
                main["flash_attention"][name] = max(
                    main["flash_attention"][name], err)
        # correlation's products run on the tensor cores, 16 channels a
        # step, so they are held within one ulp of the float32 instance,
        # as flash and paged are; |a - b| keeps the float32 arithmetic
        # after a 16-bit stage and stays bitwise
        for seed, (label, g, mult, odd, is_main) in enumerate(corr_cases):
            args = half_args(torch, corr_inputs(
                torch, dev, 600 + seed, g["n"], g["c"], g["h"], g["w"]), dt,
                odd)
            err = hold_half(
                torch, ck, "corr %s m=%d s2=%d multiply=%d" % (
                    label, g["m"], g["s2"], mult),
                lambda *a: ck.correlation(*a, g["m"], g["s2"], mult),
                lambda *a: ck.correlation_reference(*a, g["m"], g["s2"],
                                                    mult),
                args, dt, exact=not mult)
            if is_main:
                main["correlation"][name] = max(main["correlation"][name],
                                                err)
        # the same logical 16-bit cache as stripes and scattered
        paged_layout_checks(torch, ck, dev, dtype=dt)
    # mixed float dtypes: the float32 instance on the upcast operands
    h16, b16 = torch.float16, torch.bfloat16
    q, k, v = flash_inputs(torch, dev, 520, 2, 77, 3, 64)
    hold_mixed(torch, "flash T77 causal",
               lambda *a: ck.flash_attention(*a, causal=True),
               [q.to(h16), k.to(b16), v])
    # paged: q of another dtype than its 16-bit pools runs the instance
    # that reads a float32 q over them; pools of two dtypes run float32's
    for c in (1, 9):
        case = paged_case(torch, dev, 46 + c, edges, c)
        pq, pk, pv, pages, lengths, q_pos = paged_args(case)
        for qt, kt, vt in ((b16, h16, h16), (torch.float32, b16, b16),
                           (torch.float32, h16, h16), (h16, b16, b16),
                           (torch.float32, b16, h16)):
            hold_mixed(torch, "paged part-edges C%d" % c,
                       lambda *a: ck.paged_attention(*a),
                       [pq.to(qt), pk.to(kt), pv.to(vt), pages, lengths,
                        q_pos])
    a, b = corr_inputs(torch, dev, 620, 2, 19, 13, 44)
    hold_mixed(torch, "corr m5 s2", lambda *x: ck.correlation(*x, 5, 2),
               [a.to(h16), b])
    return main


def p28_flownetc(torch, mt, ck, smi, f32_out, n=8, forwards=2, seed=0):
    """(b): -> {dtype name: {launches, rel_l2, wall_ms, err}}."""
    sym, shapes, params, frames = flownetc_inputs(mt, n, 4, seed)
    frames = frames[:forwards]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "flownetc")
        mt.model.save_checkpoint(
            prefix, 0, sym,
            {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}, {})
        for name in HALF_NAMES:
            dt = getattr(torch, name)
            captured = {}

            def monitor(node, arr):
                if node in ("relu3a_output", "relu3b_output"):
                    captured[node] = arr._get()
            if name == "float16":
                pred = mt.Predictor(
                    prefix + "-symbol.json", prefix + "-0000.params",
                    input_shapes=shapes,
                    type_dict={a: np.float16 for a in sym.list_arguments()})
                ex, route = pred._exec, "Predictor(type_dict=float16)"

                def forward(img1, img2):
                    pred.set_input("img1", img1)
                    pred.set_input("img2", img2)
                    pred.forward()
                    return pred.get_output(0).astype(np.float32)
            else:
                _sym, args, aux = mt.model.load_checkpoint(prefix, 0,
                                                           ctx=mt.cpu())
                ex = sym.simple_bind(
                    mt.gpu(0), grad_req="null",
                    type_dict={a: name for a in sym.list_arguments()},
                    **shapes)
                ex.copy_params_from(args, aux, allow_extra_params=True)
                route = "simple_bind(type_dict=bfloat16)"

                def forward(img1, img2):
                    ex.arg_dict["img1"][:] = img1
                    ex.arg_dict["img2"][:] = img2
                    o = ex.forward(is_train=False)[0]._get()
                    return o.float().cpu().numpy()
            ex.set_monitor_callback(monitor)
            forward(*frames[0])               # cuDNN picks its algorithms
            torch.cuda.synchronize()
            ck.reset_launches()
            t0 = time.perf_counter()
            outs = [forward(*f) for f in frames]
            wall = (time.perf_counter() - t0) * 1e3 / len(frames)
            launches = dict(ck.LAUNCHES)
            a, b = captured["relu3a_output"], captured["relu3b_output"]
            if launches["correlation"] != len(frames) or any(
                    v for k, v in launches.items() if k != "correlation") \
                    or a.dtype != dt or b.dtype != dt:
                fail("flownetc %s: correlation launched %d times for %d "
                     "forwards (launches %s), its inputs %s %s"
                     % (name, launches["correlation"], len(frames),
                        launches, a.dtype, b.dtype))
            rel = rel_l2_diff(outs[0], f32_out)
            finite = all(np.all(np.isfinite(o)) for o in outs)
            print("flownetc %s: %d forwards through %s on gpu(0), %.3f ms "
                  "each; correlation launches %d in %s; output %s finite=%s; "
                  "relative L2 to phase 11's float32 stage %.3g (tol %g)"
                  % (name, len(frames), route, wall,
                     launches["correlation"], a.dtype, outs[0].shape,
                     finite, rel, FLOWNETC_HALF_RTOL[name]))
            if not (finite and rel <= FLOWNETC_HALF_RTOL[name]) or \
                    outs[0].shape != f32_out.shape:
                fail("flownetc %s: relative L2 %.3g > %g, or not finite"
                     % (name, rel, FLOWNETC_HALF_RTOL[name]))
            err = hold_half(
                torch, ck, "corr flownetc captured inputs",
                lambda *x: ck.correlation(*x, FLOWNETC["m"], FLOWNETC["s2"]),
                lambda *x: ck.correlation_reference(*x, FLOWNETC["m"],
                                                    FLOWNETC["s2"]),
                [a.contiguous(), b.contiguous()], dt, exact=False)
            out[name] = {"launches": launches["correlation"], "rel_l2": rel,
                         "wall_ms": wall, "err": err, "route": route}
            del ex
    return out


def p28_vgg_half(torch, mt, ck, smi, prefix, wire, batch=8, forwards=4):
    """(f): -> {dtype name: {launches, forwards, rel_l2, err, route,
    wall_ms}} and ``wall_s``."""
    from mxnet_tpu_torch.passes.quantize import build_serving_pipeline
    t_phase = time.perf_counter()
    shapes = {"data": (batch, 3) + tuple(wire[0].shape[:2]),
              "softmax_label": (batch,)}
    batches = [np.stack([wire_to_nchw(u)
                         for u in wire[i * batch:(i + 1) * batch]])
               for i in range(forwards)]
    sym_file, params_file = prefix + "-symbol.json", prefix + "-0000.params"

    def pipeline():
        return build_serving_pipeline(fuse=True, ctx=mt.gpu(0))

    def watch(ex, seen):
        def monitor(node, arr):
            if node in ("flatten_output", "fc8_output"):
                seen.setdefault(node, []).append(arr._get().clone())
        ex.set_monitor_callback(monitor)

    # the float32 fused forward's logits on the same images
    pred = mt.Predictor(sym_file, params_file, shapes, pipeline=pipeline())
    fused = [n["op"] for n in json.loads(pred.symbol.tojson())["nodes"]]
    if fused.count("_fused_FullyConnected") != 2:
        fail("(f): the fused VGG-16 graph has %d _fused_FullyConnected "
             "nodes, want 2" % fused.count("_fused_FullyConnected"))
    seen32 = {}
    watch(pred._exec, seen32)
    for x in batches:
        pred.set_input("data", x)
        pred.forward()
    torch.cuda.synchronize()
    want = [t.float().cpu().numpy() for t in seen32["fc8_output"]]
    del pred, seen32
    out = {}
    for name in HALF_NAMES:
        dt = getattr(torch, name)
        seen = {}
        if name == "float16":
            pred = mt.Predictor(
                sym_file, params_file, shapes, pipeline=pipeline(),
                type_dict={a: np.float16 for a in
                           mt.sym.load(sym_file).list_arguments()})
            ex, route = pred._exec, "Predictor(type_dict=float16)"

            def forward(x):
                pred.set_input("data", x)
                pred.forward()
        else:
            pred = None
            sym = mt.sym.load(sym_file)
            _sym, args, aux = mt.model.load_checkpoint(prefix, 0,
                                                       ctx=mt.cpu())
            fsym, fargs = pipeline().run(sym, args)
            ex = fsym.simple_bind(
                mt.gpu(0), grad_req="null",
                type_dict={a: name for a in fsym.list_arguments()},
                **shapes)
            ex.copy_params_from(dict(fargs), aux, allow_extra_params=True)
            route = "simple_bind(type_dict=bfloat16) on the fused graph"

            def forward(x):
                ex.arg_dict["data"][:] = x
                ex.forward(is_train=False)
        forward(batches[0])               # cuDNN picks its algorithms
        torch.cuda.synchronize()
        watch(ex, seen)
        ck.reset_launches()
        t0 = time.perf_counter()
        for x in batches:
            forward(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / forwards
        launches = dict(ck.LAUNCHES)
        x6 = seen["flatten_output"][-1]
        w6 = ex.arg_dict["fc6_weight"]._get()
        b6 = ex.arg_dict["fc6_bias"]._get()
        if launches["fused_fc_epilogue"] != 2 * forwards or any(
                v for k, v in launches.items() if k != "fused_fc_epilogue") \
                or x6.dtype != dt or w6.dtype != dt:
            fail("(f) %s: fused_fc_epilogue launched %d times for %d "
                 "forwards, want 2 a forward (launches %s), fc6's inputs "
                 "%s %s" % (name, launches["fused_fc_epilogue"], forwards,
                            launches, x6.dtype, w6.dtype))
        got = [t.float().cpu().numpy() for t in seen["fc8_output"]]
        rel = max(rel_l2_diff(g, w_) for g, w_ in zip(got, want))
        finite = all(np.all(np.isfinite(g)) for g in got)
        x6 = x6.reshape(x6.shape[0], -1).contiguous()
        if fc_route(ck, x6, w6) != "tensor_core":
            fail("(f) %s: fc6's captured inputs take the %s route"
                 % (name, fc_route(ck, x6, w6)))
        err = hold_half(
            torch, ck, "fc (f) fc6 captured inputs",
            lambda *a: ck.fused_fc_epilogue(*a, "relu"),
            lambda *a: ck.fused_fc_epilogue_reference(*a, "relu"),
            [x6, w6, b6], dt, exact=False)
        print("vgg16 %s: %d forwards at bucket %d through %s on gpu(0), "
              "%.3f ms each; fused_fc_epilogue launches %d (2 a forward) "
              "in %s; logits %s finite=%s, relative L2 to the float32 "
              "fused forward %.3g (tol %g)"
              % (name, forwards, batch, route, wall,
                 launches["fused_fc_epilogue"], x6.dtype, got[0].shape,
                 finite, rel, VGG_HALF_RTOL[name]))
        if not (finite and rel <= VGG_HALF_RTOL[name]) or \
                got[0].shape != want[0].shape:
            fail("(f) %s: logits' relative L2 %.3g > %g, or not finite"
                 % (name, rel, VGG_HALF_RTOL[name]))
        out[name] = {"launches": launches["fused_fc_epilogue"],
                     "forwards": forwards, "rel_l2": rel, "err": err,
                     "route": route, "wall_ms": wall}
        del ex, pred, seen
    out["wall_s"] = time.perf_counter() - t_phase
    print("vgg16 half (f): %.1f s; card %s" % (out["wall_s"], smi))
    return out


def p28_flash_search(torch, mt, ck, name, trials=2):
    """(c) for one dtype: -> {winner, launches, wall_s}."""
    ks = mt.autotune.kernelsearch
    dev = torch.device("cuda", 0)
    dt = getattr(torch, name)
    b, t, h, d = FLASH_SHAPE
    os.environ.pop("MXNET_KERNEL_SEARCH", None)
    fails0 = ks.parity_fail_total()
    ck.reset_launches()
    t0 = time.perf_counter()
    win = ks.search_flash(b, t, h, d, causal=True, dtype=dt, trials=trials)
    wall = time.perf_counter() - t0
    first = mt.autotune.recent_stats()[-1].report()
    after1 = ck.LAUNCHES["flash_attention"]
    win2 = ks.search_flash(b, t, h, d, causal=True, dtype=name,
                           trials=trials)
    second = mt.autotune.recent_stats()[-1].report()
    after2 = ck.LAUNCHES["flash_attention"]
    cls = ks.flash_class(t, d, True, dt)
    stored = ks.best_config(cls, device=dev)
    os.environ["MXNET_KERNEL_SEARCH"] = "1"
    q, k, v = half_args(torch, flash_inputs(torch, dev, 42, *FLASH_SHAPE),
                        dt)
    tiles = ck.flash_tiles(t, d, True, q.dtype, dev)
    via = ck.flash_attention(q, k, v, causal=True)
    explicit = ck.flash_attention(q, k, v, causal=True,
                                  block_q=win["block_q"],
                                  block_k=win["block_k"])
    torch.cuda.synchronize()
    launches = ck.LAUNCHES["flash_attention"]
    os.environ.pop("MXNET_KERNEL_SEARCH", None)
    print("search (c) search_flash(%d, %d, %d, %d, causal=True, dtype=%s) "
          "in %.3f s: winner %s, calls %s, %d launches; stored under %s; "
          "second search %s, calls %s, %d launches; call-time tiles %s, "
          "bitwise the explicit-tile call=%s"
          % (b, t, h, d, name, wall, win, first["calls"], after1, cls,
             second["source"], second["calls"], after2 - after1, tiles,
             torch.equal(via, explicit)))
    if ks.parity_fail_total() != fails0 or first["source"] != "measured" \
            or cls[1] != name or stored != win:
        fail("search_flash %s: a gate failed, nothing measured, or the "
             "winner %s not stored under %s (%s)" % (name, win, cls,
                                                    stored))
    if win2 != win or second["source"] != "cache" \
            or any(second["calls"].values()) or after2 != after1:
        fail("search_flash %s: the second search was no store hit with 0 "
             "launches: %s" % (name, second))
    if tiles != (win["block_q"], win["block_k"]) or via.dtype != dt \
            or not torch.equal(via, explicit):
        fail("flash %s: call time resolved %s, the winner is %s"
             % (name, tiles, win))
    hold_half(torch, ck, "flash at the winner %dx%d" % tiles,
              lambda *a: ck.flash_attention(*a, causal=True),
              lambda *a: ck.flash_attention_reference(*a, causal=True),
              [q, k, v], dt, exact=False)
    return {"winner": win, "launches": launches, "wall_s": wall}


def p28_paged(torch, mt, ck, smi):
    """(d): -> {winner, launches by dtype name, wall_s}."""
    ks = mt.autotune.kernelsearch
    dev = torch.device("cuda", 0)
    p = P24_PAGED
    bf16 = torch.bfloat16
    os.environ.pop("MXNET_KERNEL_SEARCH", None)
    fails0 = ks.parity_fail_total()
    ck.reset_launches()
    t0 = time.perf_counter()
    win = ks.search_paged(p["s"], p["c"], p["h"], p["d"],
                          n_blocks=p["n_blocks"], bt=p["bt"], causal=True,
                          dtype=bf16, shortlist=len(ck.PAGED_PART_KEYS))
    wall = time.perf_counter() - t0
    first = mt.autotune.recent_stats()[-1].report()
    win2 = ks.search_paged(p["s"], p["c"], p["h"], p["d"],
                           n_blocks=p["n_blocks"], bt=p["bt"], causal=True,
                           dtype="bfloat16")
    second = mt.autotune.recent_stats()[-1].report()
    searched = ck.LAUNCHES["paged_attention"]
    cap = (p["n_blocks"] - 1) // p["s"] * p["bt"]
    cls = ks.paged_cap_class(p["bt"], p["d"], True, bf16, cap)
    os.environ["MXNET_KERNEL_SEARCH"] = "1"
    pk = ck.paged_part_keys(p["bt"], p["d"], True, bf16, cap, dev)
    print("search (d) search_paged(S %d, C %d, H %d, D %d, bt %d, causal, "
          "dtype=bfloat16) in %.3f s: winner %s, calls %s, %d launches; "
          "class %s; second search %s, calls %s; call-time part_keys %d"
          % (p["s"], p["c"], p["h"], p["d"], p["bt"], wall, win,
             first["calls"], searched, cls, second["source"],
             second["calls"], pk))
    if ks.parity_fail_total() != fails0 or first["source"] != "measured" \
            or cls[1] != "bfloat16" or pk != win["part_keys"] \
            or win2 != win or second["source"] != "cache" \
            or any(second["calls"].values()):
        fail("search_paged bfloat16: a gate failed, the second search was "
             "no store hit, or call time resolved %d for the winner %s"
             % (pk, win))
    # pool views at the searched capacity: 16 slots x 64 blocks of 16
    launches = {"bfloat16": searched}
    slots, per_slot = p["s"], cap // p["bt"]
    for name in ("bfloat16", "float16"):
        dt = getattr(torch, name)
        pool = mt.serve.KVBlockPool(slots, per_slot, block_tokens=p["bt"],
                                    device=dev)
        pool.add_view("lm", 1, p["h"], p["d"], dtype=dt)
        for s in range(slots):
            if not pool.reserve(s, per_slot):
                fail("pool: slot %d could not reserve %d blocks"
                     % (s, per_slot))
            pool.ensure(s, per_slot * p["bt"])
        kv_k, kv_v = pool.view("lm")
        gen = torch.Generator(device=dev).manual_seed(28)
        kv_k.copy_(torch.randn(kv_k.shape, generator=gen, device=dev))
        kv_v.copy_(torch.randn(kv_v.shape, generator=gen, device=dev))
        kv_k[:, pool.sentinel] = 1e4        # masked: past every length
        kv_v[:, pool.sentinel] = 1e4
        pages = torch.from_numpy(pool.page_table().copy()).to(dev)
        lens = np.full(slots, per_slot * p["bt"], np.int32)
        lengths = torch.from_numpy(lens).to(dev)
        calls = []
        for c in (1, 9):
            q = torch.randn((slots, c, p["h"], p["d"]), generator=gen,
                            device=dev).to(dt)
            q_pos = torch.from_numpy(engine_positions(lens, c)).to(dev)
            for causal in (True, False):
                calls.append((c, causal, [q, kv_k[0], kv_v[0], pages,
                                          lengths, q_pos]))
        ck.reset_launches()
        for c, causal, args in calls:       # the path, counted
            ck.paged_attention(*args, causal=causal)
        torch.cuda.synchronize()
        path = ck.LAUNCHES["paged_attention"]
        launches[name] = launches.get(name, 0) + path
        for c, causal, args in calls:       # the checks
            hold_half(torch, ck, "paged pool view C=%d causal=%d" % (
                c, causal), lambda *a: ck.paged_attention(*a, causal=causal),
                lambda *a: ck.paged_attention_reference(*a, causal=causal),
                args, dt, exact=False)
        # a float32 q over the view: the pools are read as they are, so
        # the call allocates its output and split-K scratch, not a copy.
        # Its partition length resolves under the pools' dtype (the
        # bfloat16 winner) and the upcast call's under float32, so the
        # bitwise check passes the view's to both: the arithmetic is held,
        # not the two classes' winners
        args = [calls[0][2][0].float()] + calls[0][2][1:]
        view_pk = ck.paged_part_keys(p["bt"], p["d"], True, dt, cap, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ck.paged_attention(*args)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated(dev) - base
        hold_mixed(torch, "paged pool view float32 q C=1 part_keys=%d"
                   % view_pk,
                   lambda *a: ck.paged_attention(*a, part_keys=view_pk),
                   args)
        print("pool (d) KVBlockPool.add_view(dtype=%s): %d slots at %d keys "
              "(the page table's capacity), %d bytes on %s; %d "
              "paged_attention launches; a float32 q over it allocated %d "
              "bytes (one pool %d)" % (
                  name, slots, per_slot * p["bt"], pool.device_bytes(), smi,
                  path, extra, kv_k[0].nbytes))
        if extra >= kv_k[0].nbytes // 4:
            fail("pool %s: a float32 q allocated %d bytes, a copy of the "
                 "pools' %d" % (name, extra, kv_k[0].nbytes))
        del pool, kv_k, kv_v, calls
    os.environ.pop("MXNET_KERNEL_SEARCH", None)
    return {"winner": win, "launches": launches, "wall_s": wall}


def p28_times(torch, ck, flash_wins, vgg_half):
    """(e): -> {kernel: {dtype name: row}}, each row with the half
    instance's, the float32 instance's, the upcast path's (the operands
    upcast to float32, the float32 instance, the output cast back; not
    for fused_fc_epilogue), the plain version's and the library call's
    times and the bound; ``correlation pwcnet`` at PWC-Net's shape;
    ``fused_fc_epilogue`` with each layer's time, its route and the
    launches on (f)'s path (``vgg_half``, p28_vgg_half's result)."""
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    flush = torch.zeros(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    rows = {k: {} for k in ("paged_attention", "flash_attention",
                            "correlation", "correlation pwcnet",
                            "fused_fc_epilogue")}
    cases = {c: paged_time_case(torch, dev, c) for c in (1, 32)}
    for name in HALF_NAMES:
        dt = getattr(torch, name)
        row = dict(ms=0.0, f32_ms=0.0, upcast_ms=0.0, plain_ms=0.0,
                   library_ms=0.0, bound_ms=0.0, by_bytes=0.0)
        for c, case in cases.items():
            half = dict(case)
            half.update(q=case["q"].to(dt), k_pool=case["k_pool"].to(dt),
                        v_pool=case["v_pool"].to(dt))
            bound, by = paged_bound_ms(half)
            row["ms"] += time_ms(torch, lambda: ck.paged_attention(
                *paged_args(half)), flush)
            row["f32_ms"] += time_ms(torch, lambda: ck.paged_attention(
                *paged_args(case)), flush)
            row["upcast_ms"] += time_ms(torch, lambda: ck.paged_attention(
                *upcast(torch, paged_args(half))).to(dt), flush)
            row["plain_ms"] += time_ms(
                torch, lambda: ck.paged_attention_reference(
                    *paged_args(half)), flush)
            row["library_ms"] += time_ms(torch, sdpa_library(torch, half),
                                         flush)
            row["bound_ms"] += bound
            row["by_bytes"] += bound if by == "bytes" else 0.0
        row["bound_by"] = "bytes" if 2 * row.pop("by_bytes") >= \
            row["bound_ms"] else "operations"
        row["shape"] = "C=1 + C=32, S=16 H=12 D=64 bt=16 ctx=1..1024"
        row.update(earlier_ms=EARLIER_HALF_MS["paged_attention"][name],
                   earlier_from=EARLIER_HALF_FROM)
        rows["paged_attention"][name] = row

        b, t, h, d = FLASH_SHAPE
        bq, bk = flash_wins[name]["block_q"], flash_wins[name]["block_k"]
        q, k, v = flash_inputs(torch, dev, 42, *FLASH_SHAPE)
        qh, kh, vh = q.to(dt), k.to(dt), v.to(dt)
        bound, by = flash_bound_ms(b, t, h, d, True, esize=2)
        rows["flash_attention"][name] = {
            "shape": "B=%d T=%d H=%d D=%d causal tile=%dx%d" % (b, t, h, d,
                                                                bq, bk),
            "ms": time_ms(torch, lambda: ck.flash_attention(
                qh, kh, vh, causal=True, block_q=bq, block_k=bk), flush),
            "f32_ms": time_ms(torch, lambda: ck.flash_attention(
                q, k, v, causal=True, block_q=bq, block_k=bk), flush),
            "upcast_ms": time_ms(torch, lambda: ck.flash_attention(
                qh.float(), kh.float(), vh.float(), causal=True, block_q=bq,
                block_k=bk).to(dt), flush),
            "plain_ms": time_ms(torch, lambda: ck.flash_attention_reference(
                qh, kh, vh, causal=True), flush),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
                is_causal=True), flush),
            "bound_ms": bound, "bound_by": by, "bound_peak": HALF_FLASH_PEAK,
            "earlier_ms": EARLIER_HALF_MS["flash_attention"][name],
            "earlier_from": EARLIER_HALF_FROM}

        for cname, g in (("flownetc", FLOWNETC), ("pwcnet", PWCNET)):
            a, bb = corr_inputs(torch, dev, 300, g["n"], g["c"], g["h"],
                                g["w"])
            ah, bh = a.to(dt), bb.to(dt)
            bound, by = corr_bound_ms(g["n"], g["c"], g["h"], g["w"],
                                      g["m"], g["s2"], esize=2)
            row = {
                "shape": "%s N=%d C=%d %dx%d m=%d s2=%d multiply=1" % (
                    cname, g["n"], g["c"], g["h"], g["w"], g["m"], g["s2"]),
                "ms": time_ms(torch, lambda: ck.correlation(
                    ah, bh, g["m"], g["s2"]), flush),
                "f32_ms": time_ms(torch, lambda: ck.correlation(
                    a, bb, g["m"], g["s2"]), flush),
                "upcast_ms": time_ms(torch, lambda: ck.correlation(
                    ah.float(), bh.float(), g["m"], g["s2"]).to(dt), flush),
                "plain_ms": time_ms(
                    torch, lambda: ck.correlation_reference(
                        ah, bh, g["m"], g["s2"]), flush, iters=5),
                "library_ms": None, "bound_ms": bound, "bound_by": by}
            if cname == "flownetc":
                row.update(earlier_ms=EARLIER_HALF_MS["correlation"][name],
                           earlier_from=EARLIER_HALF_FROM)
                rows["correlation"][name] = row
            else:
                rows["correlation pwcnet"][name] = row

        row = fc_half_time_row(torch, ck, dev, flush, dt)
        row.update(earlier_ms=EARLIER_HALF_MS["fused_fc_epilogue"][name],
                   earlier_from=EARLIER_HALF_FROM,
                   launches_on_paths=vgg_half[name]["launches"],
                   paths="phase 28 (f): " + vgg_half[name]["route"])
        rows["fused_fc_epilogue"][name] = row
    del flush
    for kernel, by_dt in rows.items():
        for name, row in by_dt.items():
            row["bound_share"] = row["bound_ms"] / row["ms"]
            print("kernel time %s %s %s" % (kernel, name, json.dumps(row)))
    return rows


def p28_phase(torch, mt, ck, smi, f32_flow, served):
    print("phase 28: float16 and bfloat16 in paged_attention, "
          "flash_attention, correlation and fused_fc_epilogue; card %s"
          % smi)
    t0 = time.perf_counter()
    out = {"main_err": p28_kernel_checks(torch, ck)}
    out["flownetc"] = p28_flownetc(torch, mt, ck, smi, f32_flow)
    out["vgg"] = p28_vgg_half(torch, mt, ck, smi, served["prefix"],
                              served["wire"])
    saved = {k: os.environ.get(k) for k in ("MXNET_AUTOTUNE_DIR",
                                            "MXNET_KERNEL_SEARCH")}
    with tempfile.TemporaryDirectory() as store:
        os.environ["MXNET_AUTOTUNE_DIR"] = store
        try:
            out["flash"] = {name: p28_flash_search(torch, mt, ck, name)
                            for name in HALF_NAMES}
            out["paged"] = p28_paged(torch, mt, ck, smi)
        finally:
            for key, val in saved.items():
                if val is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = val
    out["times"] = p28_times(torch, ck, {n: out["flash"][n]["winner"]
                                         for n in HALF_NAMES}, out["vgg"])
    out["wall_s"] = time.perf_counter() - t0
    print("phase 28: %.1f s" % out["wall_s"])
    return out


def half_kernel_entries(ck, p28, fc_half_err):
    """The kernels line's entries of the 16-bit instances: launches on
    phase 28's paths ((b) FlowNetC, (c) the flash searches and their
    call-time use, (d) the bfloat16 paged search and the pool views, (f)
    VGG-16); fused_fc_epilogue's max_abs_err from phase 3's 16-bit fc6
    and fc7 (``fc_half_err``)."""
    launches = {
        "paged_attention": p28["paged"]["launches"],
        "flash_attention": {n: p28["flash"][n]["launches"]
                            for n in HALF_NAMES},
        "correlation": {n: p28["flownetc"][n]["launches"]
                        for n in HALF_NAMES},
        "fused_fc_epilogue": {n: p28["vgg"][n]["launches"]
                              for n in HALF_NAMES}}
    entries = []
    for kernel in ("paged_attention", "flash_attention", "correlation",
                   "fused_fc_epilogue"):
        for name in HALF_NAMES:
            row = p28["times"][kernel][name]
            entry = {
                "name": "%s[%s]" % (kernel, name), "route": "cuda",
                "source": "mxnet_tpu_torch/csrc/" + ck.SOURCES[kernel],
                "replaces": REPLACES[kernel],
                "launches": launches[kernel][name],
                "max_abs_err": (fc_half_err if kernel == "fused_fc_epilogue"
                                else p28["main_err"][kernel])[name],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "f32_ms": row["f32_ms"]}
            if "upcast_ms" in row:
                entry["upcast_ms"] = row["upcast_ms"]
            if "bound_peak" in row:
                entry["bound_peak"] = row["bound_peak"]
            entries.append(entry)
    return entries


class NativeBuild(threading.Thread):
    """The native objects' g++ builds, run beside the kernels' nvcc
    builds; an error is kept for phase 27 to raise."""

    def __init__(self, mt):
        super().__init__(daemon=True)
        self.mt = mt
        self.error = None

    def run(self):
        try:
            self.mt.native_build.build()
        except Exception as e:          # raised by phase 27
            self.error = e


def main():
    t_script = time.perf_counter()
    # cuBLAS under deterministic algorithms (phase 14) needs a fixed
    # workspace, chosen before the process's first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import mxnet_tpu_torch as mt
        from mxnet_tpu_torch.ops import cuda_kernels as ck
        from mxnet_tpu_torch.ops import int8 as i8
    except ImportError as e:
        print("chip_smoke: cannot import mxnet_tpu_torch (%s); run it from "
              "the root of a checkout" % e, file=sys.stderr)
        return 2

    # phase 1: environment
    smi = nvidia_smi_line()
    print("card: %s" % smi)
    print("torch %s, CUDA %s, python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul=%s cudnn=%s" % (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32))
    # each phase's wall, printed before the kernels line
    walls = {}
    last = [time.perf_counter()]

    def mark(phase):
        now = time.perf_counter()
        walls[phase] = round(now - last[0], 1)
        last[0] = now

    # phase 2: build (the native layer's g++ builds run beside nvcc's)
    native = NativeBuild(mt)
    native.start()
    t0 = time.perf_counter()
    logs = ck.build()
    print("build: %s in %.1f s" % (sorted(ck.SOURCES),
                                   time.perf_counter() - t0))
    for name, log in logs.items():
        regs = [int(w) for line in log.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt.startswith("registers")]
        spills = [int(w) for line in log.splitlines() if "spill" in line
                  for w, nxt in zip(line.split(), line.split()[1:])
                  if nxt == "bytes"]
        print("build %s: %d kernel instantiations, registers max %d, "
              "spill/stack bytes max %d" % (name, len(regs), max(regs or [0]),
                                            max(spills or [0])))
        for inst, nreg, spill in ptxas_instances(log):
            if name != "fused_fc_epilogue" or "_tc_" in inst:
                print("build %s:   %-40s registers %3d, spill bytes %d"
                      % (name, inst, nreg, spill))

    # phase 3: kernels against their plain versions, and the int8 route
    fc = kernel_phase(torch, ck)
    int8_route_phase(torch, i8)
    mark('2-3')

    # the checkpoints of phases 4 and 5, kept for phase 17's multiplexer
    # and phase 28 (f)
    tmpdir = tempfile.TemporaryDirectory()
    tmp = tmpdir.name

    # phase 4: the VGG-16 serving path
    served = serve_phase(torch, mt, ck, tmp)
    mark('4')

    # phase 5: int8 and float16 VGG-16 serving on the uint8 wire
    quant = quantized_serve_phase(torch, mt, ck, i8, served, tmp, smi)
    mark('5')

    # phase 6: paged_attention against its plain version
    paged = paged_kernel_phase(torch, ck)
    mark('6')

    # phase 7: the LLM serving path
    llm = llm_phase(torch, ck)
    mark('7')

    # phase 8: flash_attention against its plain version
    flash = flash_kernel_phase(torch, ck)
    mark('8')

    # phase 9: the kernel search path
    search = flash_search_phase(torch, mt, ck)
    mark('9')

    # phase 10: correlation against its plain version
    corr = correlation_kernel_phase(torch, ck)
    mark('10')

    # phase 11: FlowNetC's correlation stage through Predictor
    flow = flownetc_phase(torch, mt, ck)
    mark('11')

    # phase 12: integer max pooling with padding, card against CPU
    int_pool_phase(torch)
    mark('12')

    # phase 13: training through Module, the fused step as a CUDA graph
    train = train_phase(torch, mt, ck, smi)
    mark('13')

    # phase 14: the PTB LSTM through Module and BucketingModule
    lstm = lstm_phase(torch, mt, ck, smi)
    mark('14')
    print("lstm result (card %s): %s" % (smi, json.dumps({
        "h200-b2048": round(lstm["headline"]["rate"]["tokens_s"], 1),
        "h200-b2048-dense-table": round(
            lstm["headline"]["dense_rate"]["tokens_s"], 1),
        **{k: round(v["tokens_s"], 1) for k, v in lstm["legs"].items()},
        "scan-h200-b2048": round(lstm["scan"]["rate"]["tokens_s"], 1),
        "bucketing-fit": round(lstm["bucketing"]["tokens_s"], 1)})))

    # phase 15: the image zoo trained on the card
    zoo = zoo_phase(torch, mt, ck, smi)
    mark('15')
    print("zoo result (card %s): %s" % (smi, json.dumps({
        "dcgan-it_s": round(zoo["dcgan"]["it_s"], 3),
        "rcnn-step_ms": round(zoo["rcnn"]["step_ms"], 1),
        "rcnn-roi_pool_ms": round(zoo["rcnn"]["roi_pool"]["fwd_bwd_ms"], 3),
        "alexnet-img_s": round(zoo["alexnet"]["img_s"], 1),
        "inception-v3-img_s": round(zoo["inception-v3"]["img_s"], 1),
        "fcn32s-step_ms": round(zoo["fcn32s"]["step_ms"], 1)})))

    # phase 16: results
    engines = {"float32": served, **quant}
    print("serve engines (VGG-16 224x224, 32 uint8 requests from 4 "
          "threads, buckets 1..8; card %s): %s" % (smi, json.dumps(
              {k: {m: v[m] for m in ("rps", "p50", "p99")}
               for k, v in engines.items()})))

    # phase 17: serving operations: DecodeEngine, ServeRouter,
    # ModelMultiplexer
    ops = serving_ops_phase(torch, mt, ck, served, llm, served["prefix"],
                            smi)
    mark('17')

    # phase 18: the rest of training: superstep, FeedForward, several
    # contexts, checkpoints, serving from a checkpoint directory, group2ctx
    rest = rest_of_training_phase(torch, mt, ck, smi)
    mark('18')

    # phase 19: routed MoE and the sparse embedding engine
    sparse = moe_embed_phase(torch, mt, ck, smi)
    mark('19')

    # phase 20: the input pipeline: .rec -> feed -> fit on the card
    fed = feed_phase(torch, mt, ck, smi, train["resnet"]["fit_img_s"],
                     rest["superstep"])
    mark('20')
    print("feed result (card %s): %s" % (smi, json.dumps({
        "resnet50-rec-fit-img_s": round(fed["resnet"]["img_s"], 1),
        "resnet50-host-fit-img_s": round(train["resnet"]["fit_img_s"], 1),
        "resnet50-rec-fit-busy": round(fed["resnet"]["busy"], 3),
        "h2d-bytes-u8": fed["resnet"]["bytes"],
        "h2d-bytes-f32": fed["resnet"]["f32_bytes"],
        "reader4-feed-img_s": round(fed["resume"]["feed_img_s"], 1),
        "reader4-decode-img_s": round(fed["resume"]["decode_img_s"], 1),
        "feed-headroom": round(fed["resume"]["headroom"], 3),
        "superstep-prefetch-tokens_s-k1": round(
            fed["superstep"]["tokens_s_k1"], 1),
        "superstep-prefetch-tokens_s-k%d" % SUPER_K: round(
            fed["superstep"]["tokens_s_k"], 1),
        "superstep-prefetch-busy-k%d" % SUPER_K: round(
            fed["superstep"]["busy_k"], 3),
        "superstep-64-tokens_s-k1": round(
            fed["superstep"]["long_tokens_s"]["k1"], 1),
        "superstep-64-tokens_s-k%d" % SUPER_K: round(
            fed["superstep"]["long_tokens_s"]["k_inside"], 1),
        "superstep-64-prefetch-tokens_s-k%d" % SUPER_K: round(
            fed["superstep"]["long_tokens_s"]["k_prefetch"], 1),
        "ids-step_ms": round(fed["ids"]["step_ms"], 3)})))

    # phase 21: scale-out: a mesh of one rank (NCCL), two ranks sharing
    # the card (gloo), the parameter server
    scale = scaleout_phase(torch, mt, ck, smi, train["resnet"])
    mark('21')
    print("scale-out result (card %s): %s" % (smi, json.dumps({
        "fit-mesh-dp1-img_s": round(scale["rates"]["fit-mesh-dp1"]["img_s"],
                                    1),
        "fit-img_s": round(scale["rates"]["fit"]["img_s"], 1),
        "fit-mesh-dp1-busy": round(scale["rates"]["fit-mesh-dp1"]["busy"],
                                   3),
        "dist_sync-2ranks-img_s": round(scale["b"]["dist_sync"]["img_s"], 1),
        "mesh-dp2-2ranks-img_s": round(scale["b"]["mesh-dp2"]["img_s"], 1),
        "dist_sync-collective-share": round(
            scale["b"]["dist_sync"]["coll_share"], 3),
        **{"sp2-%s-ms" % k: round(v, 1)
           for k, v in scale["attn_ms"].items()},
        "gpipe-pp2-ms": round(scale["pipe_ms"], 1),
        "async-round-ms": round(scale["async"]["round_ms"], 1),
        "async-round-bytes": scale["async"]["bytes"]})))

    # phase 22: model state sharded over a mesh: tp training and serving,
    # expert parallelism, multi-process checkpoints
    shard = sharded_phase(torch, mt, ck, smi)
    mark('22')
    print("sharded result (card %s): %s" % (smi, json.dumps({
        "vgg16-tp2-step_ms": [round(v, 1) for v in shard["step_ms"]],
        "vgg16-one-step_ms": [round(v, 1) for v in shard["one_ms"]],
        "vgg16-tp2-peak_mb": [round(v / 2 ** 20, 1) for v in shard["peak"]],
        "vgg16-one-peak_mb": round(shard["one_peak"] / 2 ** 20, 1),
        "serve-tp2-rps": round(shard["serve_rps"], 2)})))

    # phase 23: data parallelism's repairs, row-sharded tables, the
    # fleet, cross-process replicas, a rank's rows staged
    p23 = p23_phase(torch, mt, ck, smi)
    mark('23')
    print("scale-out rest result (card %s): %s" % (smi, json.dumps({
        "dropout-dp2-max_abs_diff": p23["drop_err"],
        "rec-dp2-rtol": p23["rec_worst"],
        "rows-4Mx64-dp2-table_bytes_a_rank": p23["rows"][0]["table_bytes"],
        "rows-4Mx64-dp2-slot_bytes_a_rank": p23["rows"][0]["slot_bytes"],
        "fleet-recovery_s": p23["fleet"]["recovery_s"],
        "rpc-walls_s": {k: round(v, 3) for k, v in
                        p23["rpc"]["walls"].items()},
        "rpc-fc_launches": p23["rpc"]["launches"],
        "feed-dp2-bytes_a_batch_a_rank": p23["feed"][0][1] // (
            P23_FEED_RECORDS // P23_FEED_BATCH)})))
    # phase 24: compile and tuning: the compile cache's cold start, the fc
    # and paged searches, fit(autotune=), prepare() and rematerialization
    p24 = p24_phase(torch, mt, ck, smi, root)
    mark('24')
    print("compile and tuning result (card %s): %s" % (smi, json.dumps({
        "cold-first-answer_s": [round(c["wall_s"], 3)
                                for c in p24["cold"]["children"]],
        "cold-nvcc_runs": [c["nvcc_runs"] for c in p24["cold"]["children"]],
        "store-entries": p24["cold"]["entries"],
        "store-bytes": p24["cold"]["bytes"],
        "fc6-winner": p24["search"]["winners"]["fc6"]["block_n"],
        "fc7-winner": p24["search"]["winners"]["fc7"]["block_n"],
        "paged-winner-part_keys":
            p24["search"]["winners"]["paged"]["part_keys"],
        "lstm-autotune-K": p24["fit"]["measure"]["k"],
        "lstm-joint-K": p24["fit"]["joint"]["k"],
        "resnet50-first-step_s-plain":
            round(p24["resnet"]["plain"]["first_step_s"], 3),
        "resnet50-first-step_s-prepared":
            round(p24["resnet"]["prepared"]["first_step_s"], 3),
        "resnet50-step_ms-remat": round(p24["resnet"]["remat"]["step_ms"],
                                        2),
        "resnet50-step_ms-plain": round(p24["resnet"]["plain"]["step_ms"],
                                        2),
        "resnet50-peak_mb-remat": round(
            p24["resnet"]["remat"]["peak_bytes"] / 2 ** 20, 1),
        "resnet50-peak_mb-plain": round(
            p24["resnet"]["plain"]["peak_bytes"] / 2 ** 20, 1),
        "wall_s": round(p24["wall_s"], 1)})))
    # phase 25: trace/, the rest of mx.profiler, the shard search,
    # online/
    p25 = p25_phase(torch, mt, ck, smi, root)
    mark('25')
    print("trace, search and online result (card %s): %s" % (
        smi, json.dumps({
            "lstm-replays_s-untraced": round(p25["a"]["off"]["replays_s"],
                                             1),
            "lstm-replays_s-traced": round(p25["a"]["on"]["replays_s"], 1),
            "lstm-traced-ratio": round(p25["a"]["ratio"], 4),
            "device-trace-ms": {k: round(v, 4) for k, v in
                                p25["b"]["device_ms"].items()},
            "vgg16-tp2-winner": sorted(p25["d"]["winner"]),
            "vgg16-tp2-first-step-rel_l2": p25["d"]["first_l2"],
            "online-served-during-promotion": p25["e"]["served_during"],
            "wall_s": round(p25["wall_s"], 1)})))
    # phase 26: users' kernels, Python ops in fit and serving, WarpCTC,
    # the torch bridge, the lock order
    p26 = p26_phase(torch, mt, ck, smi)
    mark('26')
    print("user kernels and plugins result (card %s): %s" % (
        smi, json.dumps({
            "rtc-softmax-ms": {"%dx%d" % tuple(c["shape"]):
                               [round(c["fwd_ms"], 4), round(c["bwd_ms"], 4)]
                               for c in p26["a"]["cases"]},
            "fit-steps_s": {k: round(v["steps_s"], 1)
                            for k, v in p26["b"].items()},
            "custom-serve-rps": round(p26["c"]["rps"], 1),
            "lstm-ocr-warpctc-tokens_s": round(p26["d"]["tokens_s"], 1),
            "lock-order-edges": len(p26["f"]["edges"]),
            "wall_s": round(p26["wall_s"], 1)})))
    # phase 27: the native layer: the port's engine and storage, native
    # I/O into ResNet-50, the predict ABI in this process, the C ABI from
    # a C++ process, rtc through the ABI
    p27 = p27_phase(torch, mt, ck, smi, root, native)
    mark('27')
    print("native layer result (card %s): %s" % (smi, json.dumps({
        "engine-closures_s": round(p27["a"]["closures_s"], 1),
        "engine-serial-closures_s": round(p27["a"]["serial_closures_s"], 1),
        "engine-push_us": round(p27["a"]["push_us"], 2),
        "storage-pool_hits": p27["a"]["hits"],
        "loader-img_s": round(p27["b"]["loader_img_s"], 1),
        "resnet50-native-fit-img_s": round(p27["b"]["fit_img_s"], 1),
        "resnet50-loader-share": round(p27["b"]["loader_share"], 3),
        "records": "jpeg" if p27["b"]["jpeg"] else "raw",
        "vgg16-abi-forward_ms": round(p27["c"]["abi_ms"], 3),
        "vgg16-predictor-forward_ms": round(p27["c"]["py_ms"], 3),
        "mlp-abi-steps_s": round(p27["d"]["steps_s"], 1),
        "mlp-fused-fit-steps_s": round(p27["d"]["py_steps_s"], 1),
        "mlp-first-update-max-diff": p27["d"]["first_update_err"],
        "rtc-abi-err": p27["e"]["err"],
        "wall_s": round(p27["wall_s"], 1)})))
    # phase 28: float16 and bfloat16 in paged_attention, flash_attention,
    # correlation and fused_fc_epilogue: the kernels, FlowNetC, the
    # searches, a pool's views, VGG-16's fused fc6 and fc7
    p28 = p28_phase(torch, mt, ck, smi, flow["out0"], served)
    tmpdir.cleanup()
    mark('28')
    print("half precision result (card %s): %s" % (smi, json.dumps({
        "flownetc-rel_l2": {n: p28["flownetc"][n]["rel_l2"]
                            for n in HALF_NAMES},
        "flownetc-forward_ms": {n: round(p28["flownetc"][n]["wall_ms"], 3)
                                for n in HALF_NAMES},
        "flash-winners": {n: p28["flash"][n]["winner"] for n in HALF_NAMES},
        "paged-bfloat16-winner": p28["paged"]["winner"],
        "vgg16-logits-rel_l2": {n: p28["vgg"][n]["rel_l2"]
                                for n in HALF_NAMES},
        "ms": {k: {n: round(r["ms"], 4) for n, r in v.items()}
               for k, v in p28["times"].items()},
        "wall_s": round(p28["wall_s"], 1)})))
    kernels = [{
        "name": "fused_fc_epilogue", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/" + ck.SOURCES["fused_fc_epilogue"],
        "replaces": REPLACES["fused_fc_epilogue"],
        "launches": served["launches"]["fused_fc_epilogue"]
        + quant["int8-skip-fc6"]["launches"]["fused_fc_epilogue"]
        + ops["fc_launches"]
        + rest["serve"]["launches"]["fused_fc_epilogue"]
        + sparse["rec"]["launches"] + shard["fc_launches"]
        + p23["rpc"]["launches"] + p24["cold"]["fc_launches"]
        + p24["search"]["launches"]["fused_fc_epilogue"]
        + p25["launches"]["fused_fc_epilogue"]
        + p26["c"]["launches"] + p27["c"]["launches"],
        "max_abs_err": fc["max_abs_err"],
        "ms": fc["ms"], "plain_ms": fc["plain_ms"],
        "bound_ms": fc["bound_ms"], "bound_by": "bytes",
        "library_ms": fc["library_ms"],
    }, {
        "name": "paged_attention", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/" + ck.SOURCES["paged_attention"],
        "replaces": REPLACES["paged_attention"],
        "launches": llm["launches"] + ops["paged_launches"]
        + p24["search"]["launches"]["paged_attention"]
        + p25["launches"]["paged_attention"],
        "max_abs_err": paged["max_abs_err"],
        "ms": paged["ms"], "plain_ms": paged["plain_ms"],
        "bound_ms": paged["bound_ms"], "bound_by": paged["bound_by"],
        "library_ms": paged["library_ms"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/" + ck.SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"],
        "launches": search["launches"],
        "max_abs_err": flash["max_abs_err"],
        "ms": search["ms"], "plain_ms": search["plain_ms"],
        "bound_ms": search["bound_ms"], "bound_by": search["bound_by"],
        "bound_peak": search["bound_peak"],
        "library_ms": search["library_ms"],
    }, {
        "name": "correlation", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/" + ck.SOURCES["correlation"],
        "replaces": REPLACES["correlation"],
        "launches": flow["launches"],
        "max_abs_err": corr["max_abs_err"],
        "ms": corr["ms"], "plain_ms": corr["plain_ms"],
        "bound_ms": corr["bound_ms"], "bound_by": corr["bound_by"],
        "library_ms": None,
    }] + half_kernel_entries(ck, p28, fc["half_err"])
    missing = [k for k in ck.SOURCES
               if k not in [e["name"] for e in kernels]]
    if missing:
        fail("kernels not held against their plain versions: %s" % missing)
    idle = [e["name"] for e in kernels if e["launches"] < 1]
    if idle:
        fail("kernels not launched on their paths: %s" % idle)
    print("kernel times: fused_fc_epilogue is one bucket-8 batch's fc6 + "
          "fc7 launches (float32 out), its launches those of the float32 "
          "VGG-16 run (2 a batch) plus the int8-skip-fc6 run (fc6 with the "
          "int8 epilogue, 1 a batch; the int8-default run launches it 0 "
          "times) plus the multiplexer's VGG-16 waves (2 a batch and 8 a "
          "swap-in's warm-up) plus phase 19's rec serving (rfc1, 1 a "
          "batch) plus phase 22's tp=2 serving on both ranks (fc6's and "
          "fc7's shards, 2 a batch a rank) plus phase 23's RpcReplica "
          "children (2 a batch, counted in each child) plus phase 24's "
          "cold-start children (fc1, 1 a batch, counted in each child) and "
          "its call-time winners at fc6 and fc7 plus phase 25's "
          "traced and untraced VGG-16 requests, its device-timeline batch "
          "and the promoted replicas' answers plus phase 26's Custom graph "
          "served (fc1 and fc2, 2 a batch) plus phase 27's VGG-16 forwards "
          "through the predict ABI and through Predictor (2 a forward); "
          "paged_attention "
          "is one C=1 "
          "plus one C=32 "
          "launch at 16 slots x 12 heads x 64, contexts 1..1024; its "
          "launches are those of the paged, dense-stripe and speculative "
          "LM runs, the router's two floods and the multiplexer's LM "
          "waves and phase 24's calls with the searched winner (layout "
          "gates, paged and dense-stripe LM streams) and phase 25's "
          "traced, untraced and device-timeline streams; "
          "flash_attention is one causal launch at B=4 T=1024 H=12 D=64 "
          "with the searched tile, its launches those of the search, the "
          "store hit and the call-time use, its bound at the tensor cores' "
          "TF32 peak, 3 TF32 products per float32 product; correlation "
          "is one launch at "
          "FlowNetC's stage (N=8 C=256 48x64, 441 displacements, "
          "multiply), its launches those of the FlowNetC forwards; no "
          "single PyTorch call computes the correlation, so its "
          "library_ms is null; the [float16] and [bfloat16] entries are "
          "those instances at the same shapes (paged and flash with the "
          "dtype's library call, flash with its dtype's searched tile; "
          "f32_ms the float32 instance in the same phase, upcast_ms the "
          "operands upcast, the float32 instance and the output cast "
          "back; bounds at 2 "
          "bytes an element), their launches those of phase 28's paths: "
          "paged the bfloat16 search and the pool views, flash each "
          "dtype's search, store hit and call-time use, correlation "
          "FlowNetC's forwards in each dtype, fused_fc_epilogue (its "
          "tensor-core instance, fc6 + fc7 at bucket 8, max_abs_err from "
          "phase 3's 16-bit fc6 and fc7) (f)'s VGG-16 forwards in each "
          "dtype (2 a forward)")
    print("phase walls (s): %s" % json.dumps(walls))
    print("chip_smoke: the whole script took %.1f s" % (
        time.perf_counter() - t_script))
    print(json.dumps({"kernels": kernels}))
    print("card: %s" % smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--fleet-worker" in sys.argv:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        fleet_worker(sys.argv[sys.argv.index("--fleet-worker") + 1])
        sys.exit(0)
    if "--cold-child" in sys.argv:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        cold_child(sys.argv[sys.argv.index("--cold-child") + 1])
        sys.exit(0)
    if "--p26-lock-child" in sys.argv:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        p26_lock_child(sys.argv[sys.argv.index("--p26-lock-child") + 1])
        sys.exit(0)
    if "--rpc-child" in sys.argv:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        i = sys.argv.index("--rpc-child")
        rpc_child(sys.argv[i + 1], sys.argv[i + 2])
        sys.exit(0)
    sys.exit(main())
