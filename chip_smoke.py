#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``cxxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA.  Imports nothing of JAX or ``cxxnet_tpu``.
Phases; any failure ends the run with a non-zero exit and no result:

1. The card's name and power limit (``nvidia-smi``), then the build of
   every kernel of the port from ``cxxnet_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and its wall time; the
   conv block's kernel functions' registers, spills, dynamic shared
   memory and tensor-core instructions (``conv_block build:`` lines),
   failing unless the wgmma kernel has HGMMA and no spills at each of
   its five tile widths; the same for the int8 GEMM's wgmma kernel at
   its two widths (``int8_gemm build:`` lines).
2. Each kernel against its plain PyTorch version on the card, at every
   shape GoogLeNet's b128 training step gives it (read off the net's
   shape inference and its parameters), in float32 and bfloat16 (the
   SGD step: float32, over all 116 parameter tensors in one
   multi-tensor launch, bit-equal): max abs/rel error against the
   stated tolerance, the kernel's time, the plain version's time, one
   PyTorch library call's time as a yardstick the port never calls, and
   the bound: the larger of bytes over 3.35 TB/s and operations over the
   peak rate for their type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
   float32 without them).  The conv block in bf16 must take its wgmma
   kernel at each of the nine shapes, with relu and without the bias
   too, and its mma.sync edge kernel (reached by its C entry) must agree
   there as well; the two and ``torch.addmm`` are timed in turns.  The
   edge path at a ragged shape (K and O off the main path's rule), f32
   and bf16, with and without bias and relu.  The max-pool kernels
   must take their channel-vector main paths, f32 and bf16: the
   forward (K1) at all 13 pools, the backward (K2) at the four stride-2
   pools and the stride-1 backward (K3) at the nine inception pools; in
   bf16 each old scalar kernel (the edge path, reached by its C entry)
   must be bit-equal too, and the main path, the edge kernel and the
   library call (``F.max_pool2d``, aten's backward) are timed in turns,
   device time.  The LRN kernels (K4, K5) must take their one-pass
   channel-vector main paths at both LRNs, f32 and bf16; in bf16 each
   old scalar kernel (the edge path, reached by its C entry) must agree
   too, and the main path, the edge kernel and the library call
   (``F.local_response_norm``, its autograd backward) are timed in
   turns, device time.  The LRN edge paths at C 70 and at a view one
   element off 16-byte alignment, f32 and bf16, both directions; the
   main path's power route against float64 (within 8 ulp), beside the
   edge kernel's powf and the plain version's pow.  The SGD step's
   multi launch, the old per-tensor loop of one-tensor launches and the
   fused ``torch.optim.SGD`` in turns.
3. The serving path at full width: GoogLeNet from
   ``example/ImageNet/googlenet.conf`` (3x224x224, 1000 classes, every
   inception module, ``compute_dtype = bfloat16``) with seeded random
   weights, written to a checkpoint by ``save_model`` and served by
   ``Engine(model_in=...)`` behind the HTTP server on an ephemeral port:
   ``GET /healthz``, then ``POST /predict`` with 1, 7, 32 and 128 rows,
   each twice.  Every forward must launch the max-pool kernel 13 times,
   all on its vector kernel, the LRN kernel twice, on its vector kernel,
   and the conv-block GEMM 9 times, all on its wgmma kernel; the counts
   are set to 0 just before these requests and read just after them.
   Then the binary wire beside JSON on kept-alive connections: ``CXB1``
   scores frames of 1, 7, 32 and 64 rows and the same rows as JSON,
   twice each, every request launching what a forward launches, each
   binary reply bit-equal to the JSON one; 128 rows as two 64-row frames
   on two connections, the second sent once the first has reached the
   engine, which must run as one b128 forward
   and be bit-equal to the 128-row JSON reply; one 128-row frame
   (77,070,336 payload bytes, over the 64 MiB cap) answered 400
   ``oversize_shape`` with no launch; the warm latency of each row count
   on both wires, with the card's name and power limit, and the
   engine's wire counters.  Then
   the 8-row bucket runs again in float32 with TF32 off and is held
   against the same checkpoint served on the CPU (the plain versions),
   and the bfloat16 answers are held against the float32 ones.
4. Quantized serving from the same checkpoint: the int8 GEMM kernel
   (K7) against its plain version at the 11 shapes one quantized b128
   forward gives it (``conv2_reduce``, the 9 pool projections and the
   classifier, read off the net's shape inference) and at a ragged
   shape, in float32 and bfloat16, with and without the bias and with
   relu, and at the forward's shapes its times (kernel, plain, the
   library yardstick ``F.linear`` over weights dequantized ahead, and
   the bound).  In bf16 every forward shape must take the wgmma main
   path and the ragged one the mma.sync edge path, the edge kernel must
   agree at the forward's shapes too, and the wgmma kernel, the edge
   kernel and ``F.linear`` are timed in turns in device time and per
   call (host included); where a forward shape's output tiles are fewer
   than the SMs (the classifier and the two (6272, 832, 128) layers)
   the wgmma kernel with K cut into 1, 2, 4 and 8 parts is held against
   the plain version and timed in turns, device time;
   ``task=export_quant`` through ``LearnTask`` on a
   ``synthetic`` eval section of 2 x 128 rows (``quant_calib_batches =
   2``; if the 0.99 gate rejects the random-weight model, again with
   ``quant_min_agreement = 0``), its verdict logged; the artifact
   served by ``Engine(model_in=..., quant = int8)`` over HTTP at 1, 7,
   32 and 128 rows, each twice, every forward launching K1 13, K4 2, K6
   9 and K7 11 times less the layers the gate demoted (K1 on its vector
   kernel, K6 and K7 on their wgmma kernels only), and no training
   kernel (counts at 0 just before, read just after); ``/healthz``
   naming the ``.quant.model`` and ``int8``, ``/statsz``'s weight bytes
   at least 3.5 times under dense f32; the int8 model's top-1 against
   the f32 model's served answers (logged); the int8 model in float32
   (TF32 off) on the card against the CPU; the b128 bf16 forward of
   the f32 and the int8 model on device-resident input (synchronised,
   median of 5) with their device bytes at rest, and one int8 forward
   under the profiler (K7's device time and share; every K7 launch on
   the wgmma kernel).
5. The training path at full width: ``python -m cxxnet_tpu_torch``'s
   ``LearnTask`` run in-process, ``task=train`` on a temporary conf (a
   ``synthetic`` data section of 512 rows with ``threadbuffer``, a
   256-row eval section, then ``googlenet.conf``'s netconfig and
   globals with ``dev=gpu``, ``num_round=2``, its learning rates scaled
   by ``LR_SCALE``): 2 rounds of 4 steps at batch 128 in bfloat16.  The counts are set to 0 just before the run
   and read just after it; every step must launch K1 13 (all on the
   vector gather, no edge), K4 2 (on its vector kernel, no edge), K6 9
   (all wgmma, no edge), K2 4 and K3 9 (all on their vector gathers, no
   edge), K5 2 times (on its vector kernel, no edge) and the SGD
   kernel once (the 116 parameter tensors in
   one multi-tensor launch); every loss must be finite; the last round's checkpoint is served by ``Engine``
   and answers one ``/predict``.
6. Training parity on the card, from the run's first checkpoint and one
   8-row batch, dropout off: one float32 step with TF32 off against the
   same step on the CPU (plain versions), and one bfloat16 step against
   the float32 one, each tensor's update compared (limits below).
7. Three steps at ``googlenet.conf``'s own learning rates from the
   first checkpoint (their losses, informational).  The training rate:
   10 ``update()`` steps at b128 bfloat16 on
   device-resident batches after 3 warm-up steps, timed with CUDA
   events, with the peak device memory; then one step under
   ``torch.profiler``: device time by kernel and the busy share.  Every
   profiled GoogLeNet forward or step (here, in phase 3 and in phase 4)
   must launch K1-K7 on their main paths only.
   Before the rate, the divergence guard at googlenet.conf's own rates:
   ``task=train continue=1`` through ``LearnTask`` from a copy of the
   training run's seeded ``0000.model`` (from its later rounds the
   conf's rates train), one round of 8 b128 bf16 steps on
   synthetic rows, ``divergence_policy = rollback`` with
   ``divergence_lr_backoff = 0.1``, ``divergence_max_retries = 3`` and
   ``divergence_loss_ratio = 50``, nothing injected: at least one trip
   on a loss the card computed; each rollback's fresh trainer holding
   that round's checkpoint bit for bit, with zero momentum; every
   completed step launching K1-K6 and K8 as in phase 5; the run ending
   with finite weights, a new checkpoint and an lr scale of at most 0.1.
   Then ``abort`` at the same rates: ``LearnTask.run`` raises (the CLI
   exits 1) on a non-finite loss or a spike, and no checkpoint follows
   the last good round.  Then the guard's cost: b128 bf16 steps with
   the guard on and off, in turns (host clock).
8. The flash-attention kernels (K9 forward, K10 backward): first each
   kernel function's registers and spills (this run's ``nvcc -Xptxas
   -v``), the dynamic shared memory its launcher requests and its HMMA
   instructions (``cuobjdump -sass`` of the built library), failing if
   a bf16 (tensor-core) kernel has no HMMA or spills; then each against
   its plain version on the card: float32 at (2, 512, 8, 64) causal and
   not, cross lengths (T 512 / Tk 384 and T 384 / Tk 512), offsets
   through the LSE entry with fully masked rows (whose output must be 0
   and LSE -1e30), float32 at (2, 2048, 8, 64) causal, and bfloat16 at
   the LM step's (8, 2048, 8, 64) causal, these two with q, k and v
   slices of one fused (B, T, 3, H, D) tensor as the attention layer
   hands them over; dQ, dK and dV against the plain backward from the
   same inputs, with an LSE cotangent in the offset cases.  At the LM
   shape the kernels' times and the library yardstick's
   (``scaled_dot_product_attention``: forward, and its backward through
   autograd) in turns (K9, sdpa, K10, sdpa backward, then the reverse),
   each per launch with its TFLOP/s of the least work (K9 two products,
   K10 five); the plain versions' times, sdpa forward+backward, and the
   bounds.
9. The language model at ``bench.py --lm``'s width:
   ``transformer_lm_conf(seq_len=2048, dim=512, nhead=8, nlayer=4,
   batch_size=8, compute_dtype=bfloat16)`` (Adam) on a corpus made of
   ``SURVEY.md`` and ``doc/*.md``, trained ``task=train`` through
   ``LearnTask`` for 2 rounds; the counts are set to 0 just before the
   run and read just after it, and every step must launch K9 and K10 4
   times each (one per block) and no other kernel; the losses must be
   finite and fall.  Then 10 steps on a device-resident batch with
   ``eval_train = 0`` (CUDA events: step ms, tokens/s, peak memory) and
   one step under the profiler (busy share, device ms by kernel, and 4
   launches each of the forward's and the backward's bf16 C entries,
   their tensor-core kernels, by the wrappers' counts; the trace's count
   of the forward, dQ and dK/dV kernels beside them).
10. LM parity from the run's first checkpoint, 1 row: a float32 step on
   the card with TF32 off against the CPU (the loss; per tensor the Adam
   moments, and the update where the gradient is resolved), and a
   bfloat16 step against the float32 one (cosines).
11. ``task=generate`` from the last checkpoint through ``LearnTask``:
   the KV-cache path for 256 bytes (no flash launch) and the windowed
   path for 8 bytes (4 K9 launches a byte), each with the counts set to
   0 just before and read just after; the bytes per second of each
   path; and the card's probability rows against the CPU's on the same
   tokens, in float32, on both paths.
12. A small LM at head dim 128 (d 256, 2 heads, T 256, 2 blocks, batch
   4, bf16), which the flash kernels are not built for: 2 training steps
   under ``attn_impl = auto`` and ``xla`` through the dense ``mha``, no
   kernel launched (counts at 0 just before, read just after), finite
   losses; under ``pallas`` the step raises, naming the head dim.
13. ResNet-50's kernels at its shapes: K6 at its four bias-free
   sibling-1x1 groups at b128 ((M, K, O) = (401408, 64, 320), (100352,
   256, 640), (25088, 512, 1280), (6272, 1024, 2560); three of them
   stride 2 in the net) in bf16, on its wgmma kernel, against the plain
   version, the edge kernel beside it, timed in turns with ``torch.mm``;
   K8 over its 161 f32 parameter tensors in one launch, bit-equal, timed
   against fused ``torch.optim.SGD``.  K1 and K2 at its stem pool are
   GoogLeNet's (128, 112, 112, 64) k3 s2 pool, held and timed in phase 2.
14. Serving ResNet-50 at full width from ``example/ImageNet/resnet50.conf``
   (3x224x224, 1000 classes, 53 ``batch_norm`` layers under ``bn_eval =
   batch``, bf16) with seeded random weights: ``task=serve``'s
   ``Engine`` behind the HTTP server, 1, 7, 32 and 128 rows each twice;
   every forward launches K1 once and K6 four times on their main paths
   and nothing else (counts at 0 just before, read just after); the
   binary wire as in phase 3; warm latency per bucket, the forward alone per bucket and the device time
   of the smallest and largest bucket's forward by kind (our kernels,
   cuBLAS/cuDNN, elementwise, reductions); then the 7-row request's
   bucket (8) in float32 with TF32 off against the CPU at that bucket,
   and the bf16 answers against the float32 ones (the limits of phase
   3; ``pool`` features).  Under ``bn_eval = batch`` a bucket's padded
   rows enter the statistics, so answers are compared at equal buckets.
15. Training ResNet-50: ``task=train`` on ``resnet50.conf`` as it stands
   (its 512 synthetic rows, 2 rounds, batch 128, bf16, ``bn_stats =
   onepass``, ``scan_steps = 8``, at the conf's own rates, which do not
   diverge) through ``LearnTask``; counts at 0 just before, read just
   after; every step launches K1, K2 and K8 once (the 161 tensors in one
   multi-tensor launch) and K6 four times, the routed ones on their main
   paths, and nothing else; every loss finite.  Then parity from the
   run's first checkpoint at ``PARITY_ROWS`` rows under ``bn_eval =
   batch`` and ``running``: a float32 step on the card (TF32 off)
   against the CPU and a bf16 step against the float32 one, each
   tensor's update and (``running``) each running statistic; then the
   rate: 10 steps on device-resident batches (CUDA events), img/s, peak
   memory, their launches by C entry (K1, K2 and K8 once, K6 four times
   a step; GoogLeNet's rate in phase 7 holds its own counts the same
   way), and one profiled step (device time by kind, busy share).
16. One step of each of ``nag``, ``rmsprop``, ``adagrad``, ``lars`` and
   ``lamb`` over ResNet-50's 161 tensors on the card against the CPU.
17. A ``resnet50_kernels`` JSON line: K1, K2, K6 and K8 with the ResNet
   training run's launches (the serving run's beside K1 and K6), one
   step's launches, the max error at ResNet's shapes and one step's
   launches' times summed (K1 and K2 timed at GoogLeNet's identical
   stem pool).
17a. Hot reload at ResNet-50's full width: ``resnet50.conf`` with
   ``bn_eval = running`` and ``integrity_probe = 1`` (TF32 off, cuDNN
   deterministic, restored after), round 1 written by a card trainer
   through the CLI's ``_save_model`` (its manifest's probe block), served
   by ``Engine(model_dir=...)`` behind ``serve_forever`` with a 0.5 s
   reload poll; buckets 1, 32 and 128 warmed on the binary wire (65
   rows for bucket 128, whose 128-row frame passes the 64 MiB cap).
   While a client thread sends 1- and 32-row frames (``pool``
   features), the trainer writes round 2: no request fails, each answer
   is bit-equal to round 1's or round 2's, and after the swap buckets 1,
   32 and 128 are bit-equal to a fresh ``Engine(model_in=0002.model)``
   and take no cache miss; the reload's load and warm time and the
   slowest request of the swap against the steady p50.  Three more
   rounds swap in and ``torch.cuda.memory_allocated`` stays within one
   model's weight bytes.  A CRC-valid garbage round 6 fails two polls,
   the breaker opens, ``/healthz`` reports ``degraded`` with
   ``reload_breaker_open`` and round 5 answers as before; round 7 swaps
   through the half-open trial (``last_reload_ok`` true after every good
   round) and ``POST /reloadz`` answers ``swapped: false``.  The canary
   runs 20 times under traffic, all clean (the golden's source logged);
   an injected drift degrades ``/healthz`` with ``integrity_failed`` and
   the next run clears it.  A ``quant = int8`` engine serves round 7
   quantized on load; ``task=export_quant`` (gate at 0.99 over 2 x 128
   rows under ``bn_eval = running``, else ungated) writes
   ``0007.quant.model`` and the next poll swaps onto it in the same
   round; one b128 forward (counts at 0 just before, read just after)
   launches K1 once, K6 four times and K7 once per int8 1x1 layer
   (29 less the demoted), all on their main paths, each K7 launch
   named by its (M, K, O); top-1 agreement with the f32 engine at b128
   (at least 0.9 when the gate passed) and weight bytes at rest at
   least 3.5 times under f32.  Then K7 at each distinct shape of that
   forward, held and timed as in phase 4 (``check_int8``), and a
   ``reload`` and a ``resnet50_int8_k7`` JSON line.
18. The MNIST nets' kernels: K1 and K2 at ``MNIST_CONV.conf``'s pool
   (100, 14, 14, 32) k3 s2 (7x7 out, the last window partial) and
   ``digits_conv.conf``'s (50, 8, 8, 32) and (50, 4, 4, 64) k2 s2, in
   float32 and bfloat16, on their vector entries and bit-equal to their
   plain versions; K8 over the two nets' 6 and 8 tensors in one launch,
   bit-equal; each timed against its plain version and library call,
   with its bound.
19. ``MNIST_CONV.conf`` as it stands (batch 100, 28x28, float32, ``dev
   = tpu``) through ``LearnTask`` on seeded idx files the port writes
   (6000 train and 1000 test rows drawn around ten class templates):
   ``task=train`` 2 rounds, every step launching K1, K2 and K8 once on
   their f32 entries and nothing else, each evaluation forward K1 once;
   then from the round-2 model ``task=pred``, ``pred_raw``, ``extract``
   (fc1's node) and ``summary``, each forward K1 once (counts at 0 just
   before each task, read just after), the outputs' shapes, ``pred`` the
   argmax of ``pred_raw``, and ``pred_raw`` on the card against the
   CPU; ``task=finetune`` one round (every layer copied; K1, K2, K8
   once a step); one round at ``update_period = 2`` (K8 on every second
   step, half as many launches as steps); 20 batches at ``update_period
   = 2`` with dropout off, the card's weights against the CPU's.
19a. The guard's injected faults on ``MNIST_CONV.conf`` (2 rounds,
   ``divergence_policy = rollback``): ``inject_nan_step = 70`` and,
   with ``divergence_loss_ratio = 1000``, ``inject_spike_step = 70``, on
   the card and on the CPU; the printed rollback round and lr scale
   equal.  A ``guard`` JSON line (this and phase 7's).
20. ``digits_conv.conf`` as it stands with ``dev = tpu``, on the UCI
   digits that ``cxxnet_tpu_torch/tools/make_digits_idx.py`` writes, cuDNN
   deterministic: 15 rounds, every step launching K1 and K2 twice and K8
   once on their f32 entries, each round's test error printed; the last
   at most 5 %.  An
   ``mnist_kernels`` JSON line (the launches of phases 19 and 20, the
   rows of phase 18) and a ``wire_warm_latency_ms`` line (phases 3 and
   14).
20a. The imgbin chain (``iter = imgbin``): 300 raw-pixel records of
   3x256x256 float32 (128 + N(0, 1), labels in 0..999) written from a
   seed, 160 in a CXBP shard and 140 in the reference's 64 MiB
   ``BinaryPage`` layout, and 128 eval records in CXBP (~360 MB, removed
   at the end); ``task=train`` through ``LearnTask`` on
   ``googlenet.conf``'s own train and eval sections with only the paths
   changed (the eval section reads the mean image the train section
   makes, under the ``.npz`` name ``np.savez`` gives it), ``raw_pixels =
   1`` on both and ``num_decode_workers = 4`` on the train section, its
   ``rand_crop``, ``rand_mirror``, ``image_mean`` and ``threadbuffer``
   kept, ``dev=gpu``, 2 rounds, phase 5's ``LR_SCALE``: each round three
   steps (the third with 84 rows of padding), each launching K1 13, K2 4,
   K3 9, K4 2, K5 2, K6 9 on their main paths and K8 once (counts at 0
   just before, read just after), every loss finite, the mean image
   made once, both rounds evaluated; each round's samples/s beside phase
   5's synthetic rounds.  The chain against itself: round 1's batches
   bit-equal at 1 and 4 decode workers, with and without
   ``threadbuffer`` and after a mid-epoch rewind, and a resumed round 2
   equal to the uninterrupted one.  The chain alone at 1 and 4 workers,
   img/s (median of ``IMGBIN_PASSES`` passes, host clock).  ``task=pred_raw`` with
   ``bowl.conf``'s net and ``pred.conf``'s section (``imgbin`` +
   ``threadbuffer``, batch 64) over 200 raw 3x40x40 records from a
   seeded ``save_model`` checkpoint, float32 with TF32 off: 200 rows of
   121 probabilities, the padding trimmed, K1 three times a forward on
   its f32 vector entry and nothing else, within ``F32_PROB_ATOL`` of
   the CPU; K1 and K2 (phase 22c trains this net) at its three pools
   against their plain versions, bit-equal, timed (``bowl_kernels``).  JPEG records: without PIL a ``raw_pixels = 0`` chain must
   refuse at ``init()`` naming ``raw_pixels``; with PIL, 32 JPEG records
   go through the chain.  An ``imgbin`` JSON line.
22a. The conv rewrites at full width (run before phase 21's closing
   lines): ``googlenet.conf``'s net, b128 bf16, ``dev=gpu``, phase 5's
   ``LR_SCALE``, through ``LearnTask`` ``task=train`` on one synthetic
   batch cached by ``iter = membuffer`` (``max_nbatch = 1``), three
   steps each direct, ``conv_s2d = 1``, ``conv_wino = 1`` (F(4x4)) and
   ``conv_wino = 2`` (F(2x2)): every step K1 13, K2 4, K3 9, K4 2, K5 2,
   K6 9 on their main paths and K8 once (counts at 0 just before each
   run), the rewrites' uses (``layers.conv.REWRITE_USES``) exactly the
   sites shape inference gives once a step (s2d the stem alone;
   Winograd each 3x3 stride-1 ungrouped conv over at least 8 channels),
   every loss finite.  Each rewritten conv against the direct conv on
   its own input from an f32 forward of 8 rows on the direct run's
   weights (limits below); the four trainers' b128 steps in turns.
22b. ``digits_conv.conf`` under ``compute_dtype = bfloat16`` with
   ``conv_wino = 1`` and ``2``, 15 rounds each on the UCI digits, cuDNN
   deterministic: every step K1 2 and K2 2 on their bf16 main paths and
   K8 once, Winograd on ``cv2`` (32 channels in) only; round 15's test
   error at most 6 % and the best of rounds 13-15 at most 4 % (the JAX
   test's bounds), printed beside the CPU A/B log's figures.
22c. ``bowl.conf``'s net at full width (3x40x40, batch 64, 121
   classes) with its relus replaced by ``xelu`` (b 5.5; a ``torch:``
   ``Conv2d`` in place of conv4), ``prelu`` (slope jitter 0.1; the last
   pool a ``pairtest-max_pooling-insanity_max_pooling``) and
   ``insanity`` (lb 3, ub 8, its calm window inside the run; the pools
   ``insanity_max_pooling``, keep 0.9), a 2-wide side feature per row
   (``extra_data_num = 1``) through ``fixconn`` -> ``bias`` ->
   ``softplus`` joined to the flatten output before fc1; 640 seeded rows
   through ``iter = csv`` -> ``attachtxt`` -> ``membuffer``, two rounds:
   every step K1 3 and K2 3 on the f32 vector entries and K8 once, every
   loss finite; each random layer in training on the card bit-equal to
   its plain formula on the same on-card draws; each variant's eval
   forward (f32, TF32 off) card against CPU within ``F32_PROB_ATOL``;
   the ``torch:`` layer's ``blob`` tags trained and through
   ``save_model``; the pairtest's ``compare`` 0 in eval.  A ``layers``
   JSON line.
23. The library API, the C ABI and the observability plane (run
   before phase 21's closing lines).  The port's host sources
   (``csrc/host``, g++/gcc) build into ``build/host/``: the C ABI's
   library and C host must build; the native page reader builds, or
   fails for want of ``jpeglib.h`` and nothing else (each outcome
   printed).
23a. ``wrapper.DataIter`` over 512 JPEG records (256^2, made with PIL,
   low contrast: ``LIB_JPEG_AMP``) from googlenet.conf's own data
   section with ``native_decoder = 1`` (the reader it runs printed, with
   why where it is the Python one); ``wrapper.train(cfg, data, 1, ...,
   dev="gpu")`` at GoogLeNet's full width (b128 bf16, ``LR_SCALE``):
   every step K1 13, K2 4, K3 9, K4 2, K5 2, K6 9 on the main paths and
   K8 once (counts at 0 just before); ``Net.predict`` on 100 raw rows
   (bucket 128) equal to ``trainer.predict``; conv1's ``wmat`` view and
   its ``set_weight``/``get_weight`` round trip bit-equal;
   ``update_scan`` with K = 4 against four ``update()`` steps from one
   checkpoint (cuDNN deterministic), losses and every tensor within
   ``LIB_SCAN_REL``; the wrapper's step against the CLI's
   (``trainer.update``) in turns; the chain's img/s by reader.
23b. ResNet-50 at full width (b128 bf16; one block a stage,
   ``_resnet_vehicle``) through the port's C ABI
   loaded by ``ctypes`` into this process: ``CXNNetCreate("gpu")``,
   init, three ``CXNNetUpdateBatch`` (each K1 1, K2 1, K6 4 on the main
   paths, K8 1), ``CXNNetPredictBatch`` bit-equal to ``Net.predict`` on
   the saved weights, a conv1 ``wmat`` round trip, the error path
   through ``CXNGetLastError``, ``CXNNetUpdateBatch`` (a 77 MB f32
   batch marshalled) against ``trainer.update`` in turns; then the C
   host (``capi_smoke gpu``) in a subprocess: ``all checks passed``.
23c. ResNet-50 (one block a stage) served with ``event_log``, ``trace_dir`` and two
   ``alert=`` rules on ``xla_device_memory_bytes`` (one must fire, one
   must not): JSON and ``CXB1`` requests, ``/metricsz`` parsed as
   Prometheus text, its request counters equal to the requests sent,
   its ``peak_bytes_in_use`` equal to ``torch.cuda.max_memory_allocated()``
   read at the same moment, ``/alertz`` and ``/healthz`` showing the
   firing rule, a ``/reloadz`` swap writing ``serve.reload``; a short
   GoogLeNet ``task=train`` with ``device_sample_every = 1`` and
   ``save_model``: ``train.start``, ``checkpoint.save`` and ``train.end``
   in the event log, ``train_step_device_seconds`` counting the steps,
   the trace JSON's spans under ``train.round``; the step with obs armed
   against unarmed in turns; the time to render ``/metricsz``.  A
   ``library_obs`` JSON line.
24. The utilities beside the trainer, the integrity plane and the tuner
   (run before phase 21's closing lines):
24a. ``task=train`` on googlenet.conf's own data sections (b128 bf16,
   256 raw-pixel records in two shards, 4 decode workers, two rounds of
   two steps) with ``telemetry``, ``profile`` (steps 2 and 3),
   ``compile_cache_dir``, ``integrity_every = 1``, ``integrity_shadow =
   1``, ``event_log``, ``controller = 1`` and a seeded ``device.state``
   bitflip: every step K1 13, K2 4, K3 9, K4 2, K5 2, K6 9 (main paths)
   and K8 1, every shadow leg the same without K8, ``integrity.clean``
   each round (the legs bitwise equal), the flipped element one bit
   off its old value and the leaf's digest changed and equal to the
   host oracle's, the vote clean (one process), one telemetry record a
   round with every key and non-zero stage timers, the JAX package's
   round and ``pipeline:`` lines, the kernels' symbols (K1-K6, K8) in
   the Chrome trace; the ten kernels built under ``<dir>/kernels`` by one
   fresh process and loaded by a second without a build; then
   ``inject_shadow_mismatch = 1`` must stop the run with
   ``IntegrityError`` (kind ``shadow``) before the round is saved.  The
   digest sweep, the shadow audit against a step and the step with the
   profiler window open against closed, in turns.
24b. ResNet-50 (one block a stage) served at full width (b128 bf16)
   with ``controller = 1``
   (``tune_period_s = 0.25``), ``serve.batch`` latency and
   ``serve.reload`` I/O errors armed at low probability and a reload
   attempt every 0.25 s: ~10 s of JSON (1-2 rows) and ``CXB1`` (1-64
   rows) traffic from four client threads; every request answered,
   each answer the slice of its coalesced batch's output, sampled
   batches equal to ``trainer.predict`` on the same rows at the same
   bucket; ``tune_effective`` in ``/metricsz`` equal to the engine's
   live knobs; a ``tune.adjust``; every ``tune.prewarm`` naming a
   bucket; the reload breaker counting the injected failures; the
   first batch after a prewarm within 1.1x its engine's warm median
   (the median over 8 engines at 5 buckets), and a cold first batch at
   least 1.5x as far above it (medians).
24c. ResNet-50's checkpoint (one block a stage; f32 and ``ust:``) saved
   under
   ``diskio.recording``: every prefix of the journal replayed in the
   ``sync`` variant loads round 0 or round 1 through
   ``find_latest_valid``, never a torn model; ``checkpoint.write``
   ENOSPC aborts the save atomically; the save through ``diskio``
   against a plain-``os`` atomic write, in turns; ResNet-50's digest
   sweep.  A ``utilities`` JSON line.
25. The closed loop and the data service (run before phase 21's
   closing lines), over 256 raw-pixel train records in two shards and
   128 eval records through googlenet.conf's own data sections (b128,
   bf16, 0.01x its rates); in 25a and 25b every forward (served batches,
   warm-ups, evaluations) must launch K1 13, K4 2, K6 9 and every
   fine-tune step K1 13, K2 4, K3 9, K4 2, K5 2, K6 9, K8 1, all on the
   main paths (the counts at 0 just before each run, read just after):
25a. ``task=serve_train`` through ``LearnTask`` on a ``model_dir``
   holding a seeded ``0000.model`` (``loop_rounds_per_cycle = 1``,
   ``loop_replay_ratio = 0.5``, ``loop_min_records = 64``,
   ``loop_max_records = 128``, ``loop_max_cycles = 1``,
   ``capture_predict = 1``, ``publish_metric = error``): 8 labelled
   rows through JSON ``/feedback``, then four clients' ``CXB1``
   ``/predict`` frames of 1-32 rows (every one captured and answered)
   until the cycle resolves.  Run 1 (``publish_min_delta = 1``) must
   reject, roll the trainer back to round 0, move the cursor and leave
   round 0 served; run 2 (same directories, ``publish_min_delta = -1``)
   must read run 1's recorded baseline (no evaluation before its cycle),
   publish round 1 with ``PUBLISHED.json``'s lineage equal to the ids
   of the pages its cycle consumed, hot-reload it and answer 32 rows
   (bucket 32) bit-equal to ``trainer.predict`` of that checkpoint.
   Each run must print ``serve_train: shutdown complete``.  Printed: the
   cycle's seconds and steps, the loop thread's first step against its
   others, served rows/s while the cycle trains against before it.
25b. ``task=loop_fleet`` with tenants ``a`` and ``b`` (their own
   ``model_dir`` and seed, ``publish_min_delta = -1``): a request naming
   no model takes ``a``, an unknown model gets 404 ``unknown_model``;
   64 captured rows to each tenant in turn; each must publish its round
   1 while the other's ``/healthz`` round stays where its own publishes
   left it; both ``tenant_rounds`` knobs in ``/metricsz``.
25c. ``python -m cxxnet_tpu_torch <conf> task=data_service`` in a
   process of its own over the data section (4 decode workers, a ready
   file); ``task=train`` (2 rounds of 2 steps, cuDNN deterministic) fed
   by ``iter = service`` with three ``dataservice.rpc`` I/O errors
   injected, the server SIGKILLed as round 2 begins and replaced on the
   same port, against the same run fed by the local chain: every
   batch's digest and every checkpoint's CRC equal, at least one
   reconnect; a second client reading the same two epochs beside it,
   bit-equal, and a cache hit rate above 0 before the kill; each step
   K1-K6 and K8 on the main paths.  Printed: img/s of the training
   rounds and of one epoch read alone (service misses, hits, local
   chain).  A ``closed_loop`` JSON line.
26. The serving fleet and branch-embed fusion (run before phase 21's
   closing lines), over one seeded GoogLeNet (googlenet.conf, full
   width, bf16) saved as round 1; the smoke's allocator cache is
   emptied before each fleet starts.  A replica's launch counts live in
   its own process, which exports them in its ``/metricsz``
   (``kernel_launches_total{kernel,name}``, by C entry); the smoke
   reads every replica's around each checked frame and around each
   run of traffic.  Each frame must launch one forward's K1 13, K4 2,
   K6 9 (and on the int8 canary K7 11), all on the main C entries, in
   one replica, and answer bit-equal, at the same bucket, to an
   in-process ``Engine`` on the same checkpoint (its own counts held to
   the same); each replica's launches under traffic must be a whole
   number (>= 1) of such forwards and nothing else:
26a. ``python -m cxxnet_tpu_torch googlenet.conf task=serve replicas=3
   serve_reload_period=1`` in a process of its own: its start to
   ``fleet: serving 3/3``; ``CXB1`` frames of 1, 8 and 32 rows to the
   router and to each replica, the fleet idle, each one forward in one
   replica and bit-equal to the in-process engine; four clients' JSON (1-4 rows) and ``CXB1`` (1-32
   rows) ``/predict`` requests, ``priority`` interactive and batch, for
   ``FLEET_TRAFFIC_S``; replica 1 SIGKILLed (its pid from ``/statsz``)
   ``FLEET_KILL_AT_S`` in (its launches read just before): ``/healthz``
   must degrade, the replica restart and probe healthy and ``/healthz``
   return to ``ok`` (all read from the front door's ``/statsz`` and
   ``/healthz``, sampled every 0.1 s); then a
   perturbed round 2 written under the traffic: every replica on round
   2, reached one at a time in rotation order (``/statsz`` sampled
   every 0.1 s); every answer a 200 or an admission 429; the buckets
   again at round 2 against an engine on round 2; rows/s through the
   router against replica 0 directly, in turns, and the router's added
   latency at bucket 1 over ``FLEET_PAIRS`` pairs (host clock); each
   replica's caching allocator from its ``/metricsz``.  SIGTERM must end
   the fleet with exit 0.
26b. Round 1 again in a second ``model_dir``, its classifier centred
   (``_centre_classifier``: a random net's mean features alone set every
   image's class); ``task=export_quant`` (ungated) writes its
   ``.quant.model``; ``replicas=2 canary=int8
   canary_replicas=1``: the canary's buckets bit-equal to an in-process
   int8 engine, the baseline's to a bf16 one on the same checkpoint; JSON traffic of
   ``CANARY_ROWS`` rows a request, every request fresh seeded rows (so
   every compared row a distinct image), until the controller decides
   (the classes the answers predict counted): promoted at or above
   ``canary_min_agreement``,
   rolled back below, with ``PUBLISHED.json`` naming the canary's
   artifact or the baseline's model (a rolled-back canary relaunched as
   a serving member); the agreement and the latency ratio.
26c. GoogLeNet's b128 bf16 forward with ``conv_branch_embed`` 0 and 1
   (nine fused groups): K1 13, K4 2, K6 9 a forward both ways, the
   probabilities within ``EMBED_PROB_ATOL``, the features before the
   classifier within ``BF16_FEAT_REL`` of their largest and the logits
   the classifier makes of them within ``BF16_LOGIT_REL``, the two timed
   in turns (device time); two b128 steps under each from round 1
   (dropout off): each step K1-K6 and K8 on their main paths, the
   losses within ``EMBED_LOSS_REL``, each tensor's update at cosine >=
   ``UPDATE_COS``, the median >= ``UPDATE_COS_MEDIAN``.  A ``fleet``
   JSON line.
27. MoE, the block stacks and ``remat`` (run before phase 21's closing
   lines), each part in a temporary directory of its own:
27a. The LM at ``LM_*`` widths (bf16, ``attn_impl = pallas``) through
   ``task=train`` on a generated text file (``P27_WINDOWS`` windows,
   two steps a round, ``LM_ROUNDS`` rounds) under ``remat = 0`` and
   ``1``, seeded alike (their ``0000.model`` must hold equal params):
   each step K9 ``2 x LM_LAYERS`` times and K10 ``LM_LAYERS`` under
   remat, both ``LM_LAYERS`` without, nothing else; the two runs'
   updates within ``LM_UPDATE_REL`` of each tensor's largest (median
   ``LM_UPDATE_REL_MEDIAN``), bit-equality reported; one step's device
   time both ways in turns (CUDA events) and its peak memory.
27b. The same LM with each block's ``fullc:b{i}_fc1`` swapped for
   ``moe:b{i}_moe`` (``MOE_EXPERTS`` experts of the fc1's width,
   top-``MOE_TOPK``), ``remat = 1``, one round through ``task=train``
   (K9 twice, K10 once per block a step); from its ``0000.model`` one
   f32 step on the card against the CPU's by the LM rule's relative
   error, and bf16 against f32 on the card by its cosines with the gates
   unmasked (``topk = 0``; under top-2, bf16 against f32 moves whole
   tokens between experts where a gate rounds past its neighbour:
   logged, not held).
27c. ``transformer_conf(pipeline_parallel=1)`` at the LM's widths
   (causal, b8): the stack's forward (dense ``mha``, no kernel) against
   the per-block net (K9 once a block) on the same weights restacked,
   f32 (TF32 off) within ``PIPE_F32_REL`` and bf16 within
   ``PIPE_BF16_REL`` of the largest change the stack makes to its input;
   ``REMAT_STEPS`` bf16 steps under ``remat = 0`` and ``1`` (K8 once a
   step, nothing else), their updates by the LM rule, the peak memory.
27d. ``REMAT_STEPS`` b128 bf16 steps of googlenet.conf (rates times
   ``LR_SCALE``, dropout on) from one seeded checkpoint under ``remat =
   0`` (``PER_STEP`` and K8 once) and ``1`` (K1, K4 and K6 again in the
   recompute, K2, K3, K5 at least as often, K8 once): each update at
   cosine >= ``REMAT_COS``.  A ``moe_pipe_remat`` JSON line.
28. Data parallelism (``parallel/``, ``data_parallel_phase``): two rank
   processes (``python chip_smoke.py --dp-rank SPEC R``) share the card
   over gloo (``dev = gpu:0`` on both).  28a: googlenet.conf (rates
   times ``LR_SCALE``, dropout on: the ranks draw the global batch's
   mask) from one seeded checkpoint, ``DP_STEPS`` steps of 128 seeded
   rows, 64 a rank, against the one-rank run of the same batches, cuDNN
   deterministic on both sides: f32 (TF32 off) each tensor's first
   update within ``UPDATE_REL`` (median ``UPDATE_REL_MEDIAN``) and the
   ``DP_STEPS`` steps' within ``DP_F32_REL`` (``DP_F32_REL_MEDIAN``),
   bf16 each update at cosine >= ``UPDATE_COS`` (median
   ``UPDATE_COS_MEDIAN``); the ranks' weights bit-equal; every step of
   every rank launches K1-K6 and K8 as one rank does
   (``IMGBIN_PER_STEP``); each rank's step ms, img/s against one rank,
   and host ms inside the collectives; ``det_reduce = 1`` (the dropout
   layers out) twice: the same bits; then ``task=train`` through the
   CLI (``dist_num_proc = 2``, ``test_on_server = 1``, ``DP_CLI_ROWS``
   rows): both ranks' weight-sync lines, the ranks' checkpoint CRCs
   compared before rank 0 writes.  28b (ResNet-50 under ``zero = 3``)
   runs in phase 33a's rank job.  28c:
   ``example/MNIST/dist.conf`` (``update_on_server = 1``) with a test
   section on the UCI digits (``input_shape = 1,1,64``),
   ``DP_DIGITS_ROUNDS`` rounds, two ranks started by hand
   (``CXN_PROC_ID``) against one: the weights after every round within
   ``DP_DIGITS_REL`` of the one-rank update's size, the rank-summed
   test error within one image, the one-rank error off chance
   (< ``DP_DIGITS_LEARNED``); then a bit flipped on rank 1 only: both ranks stop with
   ``INTEGRITY:`` before the round is saved.  NCCL runs where the host
   has two cards (not on one: logged).  A ``data_parallel`` JSON line.
32. The elastic pod (``parallel/elastic.py``, ``elastic_phase``), every
   process on the card over gloo.  32a: googlenet.conf's net at full
   width less its dropout layer (bf16, global batch ``EL_BATCH``,
   ``det_reduce = 1``, ``save_ustate = 1``, ``EL_ROWS`` synthetic rows
   a rank, cuDNN deterministic) through the CLI (``python chip_smoke.py
   --el-rank SPEC TAG``), ``EL_ROUNDS`` rounds, two runs at once: run A
   on 3 ranks, rank 2 SIGKILLed mid-round once ``0002.model`` is
   durable, the survivors rebuilt on 2, an ``elastic_join = 1`` process
   admitted at the coordinator's boundary (3 again); run B the same
   schedule planned (``elastic_drop_at``, ``elastic_join_at``), no kill.
   Every checkpoint's CRC equal between the runs; every step of every
   process K1-K6 and K8 on their main entries, in every generation; the
   seconds from the kill to the survivors' ``mesh.rebuild_start``, each
   rebuild's wall time and rank 0's img/s by round logged.  32b: 28c's
   digits job on 3 ranks with ``elastic = 1``, ``integrity_every = 1``
   and the flip on rank 1: exits ``[0, 41, 0]``, the survivors resumed
   at the last verified round + 1, every later vote clean, every round
   saved.  32a's and 32b's 11 processes run together, after phase 31
   and beside no other phase (the parent launches no kernel for them;
   they count their own).  An ``elastic`` JSON line.
33. (k5), two rank processes sharing the card over gloo, cuDNN
   deterministic.  33a (with 28b's checks): resnet50.conf (``bn_eval =
   running``) b128 = 2 x 64, ``Z3_STEPS`` steps from one checkpoint,
   ``zero = 3`` gathering each layer (each K6 group) at use: in bf16
   bit-equal to ``zero = 0`` on the same ranks, the loss within
   ``DP_RN_LOSS_REL`` and the classifier's update cosines at
   ``RESNET_BF16_CLS_COS`` of one rank (the others logged), the running
   statistics within ``DP_AUX_BF16_REL``; in f32 the updates' cosines at
   ``RESNET_F32_COS`` and the statistics within ``DP_AUX_REL``; every
   step K1, K2, K6 and K8 on their main entries, K8 over slices; a
   rank's train-state bytes <= ``DP_SHARD_LIMIT`` of one replica, its
   most whole-weight bytes alive at once (``zero_gathered_peak_bytes``)
   <= ``Z3_PEAK_GROUPS`` x the largest group and below the whole net's,
   the sharded gradients reduce-scattered (the all-reduce's bytes fewer
   by twice the reduce-scatter's); ``max_memory_allocated``, the step
   ms and the host ms in the collectives, ``zero = 3`` beside ``zero =
   0``.  33b: ``lars`` in f32 under ``zero = 1`` against ``zero = 0``: a
   rank's updater state <= ``Z3_STATE_LIMIT`` of a replica's, the
   weights within ``Z3_LARS_ULPS`` units of the last place.  33c:
   googlenet.conf (bf16, full width) through the CLI on two ranks
   (``python chip_smoke.py --rr-rank SPEC R``): ``task = pred_raw`` on
   ``RANGE_ROWS`` rows against one process's file, then ``task =
   serve``: ``CXB1`` frames of ``RANGE_FRAMES`` rows (bucket 128, 64 a
   rank) against one process's engine, both within ``BF16_LOGIT_REL``;
   each rank launches K1, K4 and K6 on their main entries, 64 rows a
   forward; SIGTERM to rank 0 ends both.  A ``zero_range`` JSON line.
   Then a ``phase_s`` JSON line: the seconds of every phase.
21. A ``kernels`` JSON line (per kernel: launches on its main path's
   run — GoogLeNet training for K1-K8, with the serving run's for the
   forward kernels; the LM training run for K9 and K10, with the
   windowed generation run's; the int8 serving run for K7; beside them
   phase 25's, ``launches_closed_loop`` (25a's two runs and 25b's) and
   ``launches_data_service`` (25c's service-fed run), and phase 26's,
   ``launches_fleet`` (26a's and 26b's replicas, from their own
   ``/metricsz``: the checked frames and the traffic),
   ``launches_fleet_reference`` (the in-process engines those frames
   were held against) and ``launches_branch_embed`` (26c), and phase
   27's, ``launches_remat_lm`` (27a's ``remat = 1`` run),
   ``launches_moe_lm`` (27b), ``launches_pipe`` (27c's ``remat = 1``
   steps) and ``launches_remat_googlenet`` (27d's ``remat = 1`` steps),
   and phase 28's ``launches_dp`` (28a's ranks, summed) and phase
   33's ``launches_zero_range`` (33a's ``zero = 3`` steps and 33c's
   forwards, both ranks) —
   max error,
   and the times of one training step's launches summed: GoogLeNet b128
   bf16, or the LM step's 4 launches of K9 and of K10, or K7's 11
   launches of one quantized b128 forward; K6 and K7 also the mma.sync
   design's time at the same shapes, K1-K5 their old scalar kernels',
   K8 the per-tensor loop's), the
   ``nvidia-smi`` line again, and last the result line ``{"ok": true,
   "device": {...}}``.

Tolerances (reasons in PERF.md):

* max pool forward and both backwards: bit-equal (a max selects one of
  its inputs; the backwards add in f32 in the plain version's order);
* LRN forward and backward: rtol = atol = 1e-5 in float32 (the main
  path's exp2/log2 power, the edge path's ``powf``, against PyTorch's
  pow), 1e-2 in bfloat16 (one bf16 rounding of the output);
* conv-block GEMM: rtol = atol = 1e-4 in float32 (summation order),
  2e-2 in bfloat16 (one bf16 rounding of an f32 accumulator), both
  bf16 kernels;
* SGD step: bit-equal (rounded intrinsics in the plain version's order);
* int8 GEMM, each row's largest error over that row's largest plain
  magnitude: 1e-5 in float32 (summation order), 8e-3 in bfloat16 (one
  bf16 rounding of the output, at most 2**-8 of the row's largest);
* float32 card vs CPU, the f32 model and the int8 one: probabilities
  atol 1e-4; ``pool5`` features within 1e-4 of their largest magnitude
  (cuDNN against oneDNN, 57 convolutions deep);
* bfloat16 vs float32 on the card: ``pool5`` features, and the logits
  the classifier makes of them, within 0.05 of their largest magnitude
  (bf16 activations through the whole net); the served top-1 class
  equal on every row whose float32 top-2 logit gap is wider than twice
  the measured logit error plus one logit.  Random weights give logits
  whose largest magnitude is in the hundreds (printed below), so the
  softmax is near one-hot and the probabilities themselves say little.
* training: float32 card vs CPU, each tensor's update within 1e-2 of
  its largest CPU update and the median tensor within 1e-3; bfloat16
  vs float32, each tensor's update at cosine >= 0.9 and the median
  tensor >= 0.99 (the readings that set these limits: PERF.md);
* flash attention, each row's largest error within a share of that
  row's largest plain magnitude: the forward 1e-5 in float32 and 1e-2
  in bfloat16 (P is rounded against the kernel's running max, the
  plain version's against the row's final max); the backward 1e-6 in
  float32 and 2e-2 in bfloat16 (p and dS rounded to bf16 on both sides
  from f32 values that differ in their last bits, sums in another
  order, then one bf16 rounding of the output; each row's scale at
  least 1e-3 of the tensor's largest, since a query that sees one key
  has dQ = 0 exactly and both sides hold only noise); the LSE within
  1e-5;
* LM training: float32 card vs CPU, each tensor's Adam moments and
  resolved update within 1e-3 of the tensor's largest and the median
  tensor within 1e-4, the losses within 1e-4 relatively; bfloat16 vs
  float32, each tensor's cosines >= 0.98 and the median >= 0.999;
* generation: float32 probability rows within 1e-5, card against CPU
  and cached against windowed;
* the binary wire: each reply bit-equal to the JSON reply of the same
  rows at the same bucket;
* the conv rewrites, per layer: f32 (TF32 off) s2d within
  ``S2D_F32_REL`` of the layer's largest output (summation order),
  Winograd within ``WINO_F32_ATOL`` of max(1, that largest)
  (``tests/test_layers.py:533``); bf16 Winograd's error against the f32
  direct conv within ``WINO_BF16_FACTOR`` times the bf16 direct conv's
  plus 1e-3 of max(1, that largest) (``tests/test_layers.py:578``);
* MNIST (``MNIST_*`` below): ``pred_raw``'s printed probabilities, card
  (TF32 off) against CPU, within ``MNIST_PROB_ATOL``; the weights after
  ``update_period = 2`` batches within ``MNIST_PERIOD_REL`` of each
  tensor's largest CPU weight;
* ResNet-50 (``RESNET_*`` below, from the readings in PERF.md): served
  float32 as GoogLeNet; bf16 features within ``RESNET_BF16_FEAT_REL``
  and logits within ``RESNET_BF16_LOGIT_REL`` of their largest float32
  magnitude.  Training parity, float32 card vs CPU: each tensor's update
  at cosine >= ``RESNET_F32_COS``, the median >=
  ``RESNET_F32_COS_MEDIAN``, the loss within ``RESNET_F32_LOSS_REL``,
  each running statistic within ``RESNET_AUX_REL`` of its largest; bf16
  vs float32: the loss within ``RESNET_BF16_LOSS_REL``, the classifier's
  update at cosine >= ``RESNET_BF16_CLS_COS``, the running statistics
  within ``RESNET_AUX_BF16_REL``.  The updaters on the card within
  ``RESNET_UPDATER_REL`` of each tensor's largest CPU value.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
CONF = os.path.join(REPO, "example", "ImageNet", "googlenet.conf")
SEED = 0
BATCH = 128
REQUEST_ROWS = (1, 7, 32, 128)
REPEATS = 2  # each request size is sent this many times
# a JSON body of this many rows or more is sent once: it is the
# comparison's reference, and its repeat only timed the host's JSON work
# (a 128-row body takes ~5 s of the host's JSON work a request)
JSON_ONCE_ROWS = 32
PER_FORWARD = {"maxpool_fwd": 13, "lrn_fwd": 2, "conv_block_gemm": 9}
# launches of one training step; the SGD kernel's are the step's tensors
# over the multi-tensor launch's capacity (one launch for GoogLeNet's 116)
PER_STEP = {**PER_FORWARD, "maxpool_bwd": 4, "maxpool_bwd_s1": 9,
            "lrn_bwd": 2}
# K6 in bf16 has two kernels (ops/kernels/conv_block.py): every GoogLeNet
# group takes the wgmma main path, none the mma.sync edge path, which is
# checked at a shape off every tile and off the main path's rule
CONV_RAGGED = (1001, 203, 77)  # M, K, O; K and O not multiples of 8
# K4's and K5's edge paths, checked at (NHWC shape, offset into its
# buffer): C off the 16-byte vector, and a view one element off 16-byte
# alignment; at GoogLeNet's LRN parameters (nsize, alpha, beta, knorm)
LRN_EDGE = (((8, 28, 28, 70), 0), ((8, 28, 28, 64), 1))
LRN_EDGE_ARGS = (5, 1e-4, 0.75, 1.0)
# K4's power route against float64 (``check_lrn_power``): y = x *
# (x^2)^-beta (nsize 1, alpha 1, knorm 0) over x from 1e-3 to 1e3, the
# main path within this many ulp of y at beta 0.5, 0.75 and 1
LRN_ROUTE_ULPS = 8.0
TRAIN_ROWS, EVAL_ROWS, ROUNDS = 512, 256, 2
# googlenet.conf's learning rates (eta, wmat:lr, bias:lr) are scaled by
# this in the training run: from the conf's seeded init on synthetic
# N(0, 1) images, the activations grow to ~1e3 at pool5 and one step at
# the conf's rates sends the loss past 1e10 and then to NaN, in the JAX
# package as in the port (PERF.md); every other updater setting stays
LR_SCALE = 0.01
# the divergence guard at googlenet.conf's own rates: one round of 8 b128
# steps from the training run's seeded 0000.model, its back-off, retries and
# spike ratio; the guard's cost in turns (blocks of steps each way); the
# update at which MNIST_CONV's injected faults land (60 updates a round)
GUARD_ROWS = 1024
GUARD_BACKOFF, GUARD_RETRIES, GUARD_RATIO = 0.1, 3, 50
GUARD_COST_BLOCKS, GUARD_COST_STEPS = 2, 3
MNIST_GUARD_STEP = 70
# the spike gate's ratio there: far above the real losses' spread once
# the net has learnt (a batch at 50x the median of losses near 0.01 is
# ordinary), far below the injected spike (1e6 x max(loss, 1))
MNIST_GUARD_RATIO = 1000
PARITY_ROWS = 8
# quantized serving: K7 runs once per lone 1x1 conv (conv2_reduce and the
# 9 pool projections) and once for the classifier; the export gate scores
# QUANT_CALIB_BATCHES eval batches of 128; the served int8 model's weight
# bytes must be at least QUANT_MIN_RATIO times smaller than dense f32
INT8_PER_FORWARD = 11
INT8_RAGGED = (1001, 203, 77)  # M, K, O off the 64x64x32 tiles; K % 8 != 0
QUANT_CALIB_BATCHES = 2
QUANT_MIN_RATIO = 3.5
RATE_WARMUP, RATE_STEPS = 3, 6

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16_tensor": 989e12, "f32": 67e12}

TOL = {  # (rtol, atol) of each kernel against its plain version
    ("maxpool_fwd", "float32"): (0.0, 0.0),
    ("maxpool_fwd", "bfloat16"): (0.0, 0.0),
    ("lrn_fwd", "float32"): (1e-5, 1e-5),
    ("lrn_fwd", "bfloat16"): (1e-2, 1e-2),
    ("conv_block_gemm", "float32"): (1e-4, 1e-4),
    ("conv_block_gemm", "bfloat16"): (2e-2, 2e-2),
    ("maxpool_bwd", "float32"): (0.0, 0.0),
    ("maxpool_bwd", "bfloat16"): (0.0, 0.0),
    ("maxpool_bwd_s1", "float32"): (0.0, 0.0),
    ("maxpool_bwd_s1", "bfloat16"): (0.0, 0.0),
    ("lrn_bwd", "float32"): (1e-5, 1e-5),
    ("lrn_bwd", "bfloat16"): (1e-2, 1e-2),
    ("sgd_update", "float32"): (0.0, 0.0),
}
# K7 against its plain version, per row (``_row_rel_err``): f32 differs
# by summation order only; bf16 by one rounding of the output, at most
# 2**-8 of the row's largest value
INT8_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
F32_PROB_ATOL, F32_FEAT_REL = 1e-4, 1e-4
BF16_LOGIT_REL, BF16_FEAT_REL = 0.05, 0.05
# the language model: bench.py --lm's width (transformer_lm_conf at
# T 2048, d 512, 8 heads, 4 blocks, batch 8, bf16, adam), trained on the
# repository's own prose for LM_ROUNDS rounds, then sampled
LM_T, LM_DIM, LM_HEADS, LM_LAYERS, LM_BATCH, LM_ROUNDS = 2048, 512, 8, 4, 8, 2
LM_PARITY_ROWS = 1
GEN_PROMPT = "The port runs"
GEN_CACHED, GEN_WINDOWED, GEN_PARITY = 256, 8, 24
# flash kernels against their plain versions, per row (``_row_rel_err``:
# the row's largest error over its largest plain magnitude), set from
# the readings in PERF.md.  K9 in f32: expf and summation order; in
# bf16: P rounded to bf16 against the running max (the plain version
# against the row's final max), then one bf16 rounding of the output.
# K10 in f32 reads bit-equal: held to a few f32 ulps.  K10 in bf16 sums
# on the tensor cores in another order than the plain version, and p and
# dS, rounded to bf16 on both sides from f32 values that differ in their
# last bits (exp2 against exp, sums in another order), can round to
# either side of a bf16 boundary: that, then the output's own bf16
# rounding, read up to 1.18e-2 (2**-7 = 7.8e-3 is one ulp).  Each row's
# scale is floored at FLASH_ROW_FLOOR of the tensor's largest: a query
# that sees one key has dQ = 0 exactly (dS = p (dO.v - dO.o), o = v), so
# both sides hold only f32 noise there.  The LSE (f32 in both dtypes)
# absolutely.
FLASH_TOL = {("flash_fwd", "float32"): 1e-5,
             ("flash_fwd", "bfloat16"): 1e-2,
             ("flash_bwd", "float32"): 1e-6,
             ("flash_bwd", "bfloat16"): 2e-2}
FLASH_ROW_FLOOR = {"float32": 0.0, "bfloat16": 1e-3}
LSE_ATOL = 1e-5
# LM parity limits, set from the readings in PERF.md (f32 worst 7.95e-5,
# median 1.75e-5; bf16 worst cosine 0.9922, median 0.9997): f32 card vs
# CPU, the worst of the Adam moments' and the resolved update's error
# relative to the tensor's largest; bf16 vs f32, the lower of the
# cosines of m1 and of the resolved update
LM_UPDATE_REL, LM_UPDATE_REL_MEDIAN = 1e-3, 1e-4
LM_UPDATE_COS, LM_UPDATE_COS_MEDIAN = 0.98, 0.999
GEN_PROB_ATOL = 1e-5
# an LM whose head dim (HD_DIM / HD_HEADS = 128) the flash kernels are
# not built for: it trains through the dense mha on the card
HD_T, HD_DIM, HD_HEADS, HD_LAYERS, HD_BATCH, HD_STEPS = 256, 256, 2, 2, 4, 2
# training parity limits, set from the readings in PERF.md: the max-pool
# backward is discontinuous (an activation whose sign or tie the two
# sides' rounding decides differently moves a window's gradient), and
# conv1's update, the deepest, reads 2.2e-3 and cosine 0.923; the median
# tensor holds the tighter limit
UPDATE_REL, UPDATE_REL_MEDIAN = 1e-2, 1e-3
UPDATE_COS, UPDATE_COS_MEDIAN = 0.9, 0.99
# ResNet-50 (phases 13-17): resnet50.conf as it stands; one forward
# launches K1 once and K6 four times (its bias-free sibling groups, at
# RESNET_GROUPS' (M, K, O) at b128), a step also K2 once and K8 once
RESNET_CONF = os.path.join(REPO, "example", "ImageNet", "resnet50.conf")
RESNET_PER_FORWARD = {"maxpool_fwd": 1, "conv_block_gemm": 4}
RESNET_PER_STEP = {**RESNET_PER_FORWARD, "maxpool_bwd": 1, "sgd_update": 1}
RESNET_GROUPS = ((401408, 64, 320, False), (100352, 256, 640, False),
                 (25088, 512, 1280, False), (6272, 1024, 2560, False))
RESNET_TENSORS, RESNET_TRAIN_ROWS = 161, 512
RESNET_STEM_POOL = "x(128, 112, 112, 64) k3 s2 p0"
RESNET_UPDATERS = ("nag", "rmsprop", "adagrad", "lars", "lamb")
# ResNet-50 parity limits, set from the readings in PERF.md.  From the
# random init at 8 rows a step's updates are ill-conditioned in both
# packages (tools/resnet_conditioning.py, CPU, 64x64): the port's float32
# updates move by up to 0.40 of a tensor's largest (median 0.04; cosine
# >= 0.9983) when the input moves by 1e-6, and the JAX package's bf16
# step's updates have a median cosine of 0.24 with its own float32
# step's.  So the float32 card-vs-CPU step is held by each tensor's
# cosine, and the bf16 step by its loss, its classifier's update and its
# running statistics; the bf16 forward's pool features read 0.44 of
# their largest off float32 in both packages there.  Card readings at
# 224x224, 8 rows: update
# cosine worst 0.99943, median 0.9997; loss 7.1e-8; running statistics
# 1.5e-5; bf16: loss 5.8e-3, classifier cosine 0.9943, running
# statistics 0.087; served bf16 features 0.246, logits 0.118
RESNET_F32_COS, RESNET_F32_COS_MEDIAN = 0.995, 0.999
RESNET_F32_LOSS_REL, RESNET_BF16_LOSS_REL = 1e-5, 2e-2
RESNET_BF16_CLS_COS = 0.98
RESNET_AUX_REL, RESNET_AUX_BF16_REL = 1e-4, 0.2
RESNET_BF16_FEAT_REL, RESNET_BF16_LOGIT_REL = 0.5, 0.25
RESNET_UPDATER_REL = 1e-5
# the binary wire (CXB1/CXR1) beside JSON on the serving engines: frames
# of these row counts, each bit-equal to the JSON reply; 128 rows go as
# two 64-row frames on two kept-alive connections at once, which the
# micro-batcher coalesces into one b128 forward (its window held at
# WIRE_PAIR_WINDOW_S so that the second frame's body is read in time; a
# full batch runs at once); one frame of 128 rows at 3x224x224 is
# 77,070,336 payload bytes, over the 64 MiB cap: 400 oversize_shape
# hot reload: ResNet-50 served by bucket (rows a frame: 65 rows pad to
# bucket 128, whose 128-row frame would pass the 64 MiB frame cap), the
# traffic's buckets, the poll period, the steady time around a swap, the
# canary runs under traffic, K7's layers in an int8 forward, and the top-1
# agreement a gated int8 model must keep with the f32 one at b128
RESNET_BATCH = 128
RELOAD_BUCKETS = {1: 1, 32: 32, 128: 65}
RELOAD_TRAFFIC = (1, 32)
# the answers held bit-equal through a swap: the pooled features (from
# a random init the classifier's softmax saturates, so two rounds can
# give the same probabilities)
RELOAD_NODE = "pool"
RELOAD_PERIOD_S, RELOAD_STEADY_S = 0.5, 1.0
CANARY_RUNS = 10
RESNET_INT8_LAYERS = 29
RESNET_INT8_MIN_AGREE = 0.9
WIRE_ROWS = (1, 7, 32, 64)
WIRE_PAIR_WINDOW_S = 1.0
# MNIST at full width: example/MNIST/MNIST_CONV.conf as it stands (batch
# 100, 28x28, f32) on seeded idx files the port writes (6000 train,
# 1000 test rows drawn around ten class templates), 2 rounds, then the
# other tasks from the round-2 model, a finetune round and a round at
# update_period = 2; digits_conv.conf for 15 rounds on the UCI digits
MNIST_CONF = os.path.join(REPO, "example", "MNIST", "MNIST_CONV.conf")
DIGITS_CONF = os.path.join(REPO, "example", "MNIST", "digits_conv.conf")
MNIST_TRAIN_ROWS, MNIST_TEST_ROWS, MNIST_BATCH = 6000, 1000, 100
MNIST_PER_STEP = {"maxpool_fwd": 1, "maxpool_bwd": 1, "sgd_update": 1}
DIGITS_PER_STEP = {"maxpool_fwd": 2, "maxpool_bwd": 2, "sgd_update": 1}
MNIST_TENSORS, DIGITS_TENSORS = 6, 8
# MNIST_CONV.conf numbers its nodes: fc1 writes node "4" (the JAX
# package resolves extract_node_name the same way)
MNIST_FEATURE_NODE = "4"
# (x, kh, kw, s, py, px): MNIST_CONV's pool (7x7 out, its last window
# partial) and digits_conv's two
MNIST_POOLS = (((100, 14, 14, 32), 3, 3, 2, 0, 0),
               ((50, 8, 8, 32), 2, 2, 2, 0, 0),
               ((50, 4, 4, 64), 2, 2, 2, 0, 0))
# the digits fixture's bar (example/README.md)
DIGITS_MAX_TEST_ERROR = 0.05
# pred_raw's printed probabilities ({v:g}), card (TF32 off) vs CPU
MNIST_PROB_ATOL = 1e-5
# update_period = 2 from the round-2 model over MNIST_PERIOD_BATCHES
# batches, dropout off, f32 with TF32 off: each tensor of the card's
# weights within this share of the CPU weights' largest magnitude
MNIST_PERIOD_BATCHES = 20
MNIST_PERIOD_REL = 1e-5
# the imgbin chain (phase 20a): googlenet.conf's own data sections over
# raw-pixel pages written from a seed: the train set's records in a CXBP
# shard and a BinaryPage shard, the eval set's in one CXBP shard; the
# pixels are 128 + N(0, 1), so that after the conf's mean image the net
# sees phase 5's N(0, 1) inputs (the conf sets no divideby)
IMGBIN_TRAIN = (160, 140)
IMGBIN_EVAL = 128
IMGBIN_SIDE = 256
IMGBIN_WORKERS = 4
IMGBIN_PADD = 84  # the third batch of a round: 300 = 2 x 128 + 44
IMGBIN_PASSES = 2
IMGBIN_PER_STEP = {**PER_STEP, "sgd_update": 1}  # K8: 116 tensors, 1 launch
BOWL_CONF = os.path.join(REPO, "example", "kaggle_bowl", "bowl.conf")
BOWL_PRED_CONF = os.path.join(REPO, "example", "kaggle_bowl", "pred.conf")
BOWL_ROWS, BOWL_SIDE, BOWL_CLASSES = 200, 40, 121
BOWL_PER_FORWARD = {"maxpool_fwd": 3}
# (x, kh, kw, s, py, px): bowl.conf's three pools at pred.conf's batch,
# the shapes its pred_raw forward gives K1 (f32)
BOWL_POOLS = (((64, 40, 40, 32), 3, 3, 2, 0, 0),
              ((64, 20, 20, 64), 3, 3, 2, 0, 0),
              ((64, 10, 10, 128), 3, 3, 2, 0, 0))
# the JPEG shard: as many 3x256x256 records as the raw train set, each a
# smooth picture (8x8 random colours, bilinear) with N(0, JPEG_NOISE)
# pixel noise, quality 90
JPEG_NOISE = 16.0
CONF_SIDE = 224


class SmokeError(RuntimeError):
    """A phase failed."""


def log(*args) -> None:
    print(*args, flush=True)


def gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise SmokeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# timing and bounds


# cycles of device sleep ahead of a device-time measurement: ~20 ms at
# 1.98 GHz, longer than the host takes to enqueue the timed calls
DEVICE_SLEEP = 40_000_000


def time_ms(fn, reps: int = 3, inner: int = 3, device: bool = False) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, timed with CUDA events.  With ``device``, the card first
    sleeps ``DEVICE_SLEEP`` cycles so that the host enqueues every call
    before the first event runs: the time of the launched work alone,
    without the host's cost of the calls (which bounds a call of a few
    tens of microseconds)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device:
            torch.cuda._sleep(DEVICE_SLEEP)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def time_turns(fns, rounds: int = 2, device: bool = False):
    """``time_ms`` of each named function in turns, the order reversed
    every round (a, b, b, a), so that a drift of the card's clocks falls
    on all alike; returns each name's times in call order."""
    times = {n: [] for n in fns}
    order = list(fns.items())
    for r in range(rounds):
        for n, fn in (order if r % 2 == 0 else order[::-1]):
            times[n].append(time_ms(fn, device=device))
    return times


def bound(nbytes: float, ops: float, op_kind: str):
    """(bound ms, "bytes" | "operations"): the least time for the work."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[op_kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ----------------------------------------------------------------------
# phase 2: each kernel against its plain version


def step_calls(batch: int, n_model: int = 1):
    """The kernel calls of one GoogLeNet training step at ``batch`` rows,
    read off the port's own shape inference and parameters:
    ``{kernel: {args: count}}``; the SGD kernel's one entry holds every
    parameter tensor's ``(shape, lr, momentum, wd, clip)`` at step 0.
    Over a model axis of ``n_model`` ranks (phase 31) a rank's calls:
    K6 on its slice of each group whose members' ``cout`` all divide
    (``MeshPlan.model_dim``), K8 over its slices of the tensors."""
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.layers.conv import LRNLayer, MaxPoolingLayer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops.maxpool import same_size_s1
    from cxxnet_tpu_torch.parallel.mesh import MeshPlan

    plan = MeshPlan(device=torch.device("cpu"), n_model=n_model)

    tr = NetTrainer()
    tr.set_params(cfgmod.parse_file(CONF) + [("dev", "cpu"),
                                             ("batch_size", str(batch))])
    tr.init_model()
    net, g = tr.net, tr.graph
    shapes = net.infer_shapes(batch)
    groups, _ = net._sibling_1x1_groups()
    calls = {k: {} for k in PER_STEP}

    def add(kernel, key):
        calls[kernel][key] = calls[kernel].get(key, 0) + 1

    for i, spec in enumerate(g.layers):
        lay = net.layer_objs[i]
        xin = shapes[spec.nindex_in[0]]
        if type(lay) is MaxPoolingLayer:
            p = lay.param
            geom = (p.kernel_height, p.kernel_width, p.stride, p.pad_y,
                    p.pad_x)
            add("maxpool_fwd", (xin,) + geom)
            add("maxpool_bwd_s1" if same_size_s1(*geom) else "maxpool_bwd",
                (xin,) + geom)
        elif type(lay) is LRNLayer:
            key = (xin, lay.nsize, lay.alpha, lay.beta, lay.knorm)
            add("lrn_fwd", key)
            add("lrn_bwd", key)
        elif i in groups:
            n, oh, ow, _ = shapes[spec.nindex_out[0]]
            couts = [net.layer_objs[j].param.num_channel for j in groups[i]]
            if all(c % n_model == 0 for c in couts):
                couts = [c // n_model for c in couts]
            add("conv_block_gemm", (n * oh * ow, xin[3], sum(couts)))
    for k, n in PER_STEP.items():
        if sum(calls[k].values()) != n:
            raise SmokeError(f"GoogLeNet's training step makes "
                             f"{sum(calls[k].values())} {k} calls, not {n}")
    tensors = []
    for (key, tag), up in tr.updaters.items():
        pu = up.param
        shape = list(tr.params[key][tag].shape)
        d = plan.model_dim(shape)
        if d is not None:
            shape[d] //= n_model
        tensors.append((tuple(shape),
                        float(pu.learning_rate(0)), float(pu.momentum_at(0)),
                        pu.wd, pu.clip_gradient))
    calls["sgd_update"] = {tuple(tensors): 1}
    return calls


def _err(got, ref):
    d = (got.float() - ref.float()).abs()
    rel = d / ref.float().abs().clamp_min(1e-6)
    return float(d.max()), float(rel.max())


def check_kernel(kernel: str, key, dtype, dev, gen,
                 device_times: bool = False, require_main: bool = True):
    """One kernel at one shape and dtype: agreement with its plain
    version, and the four times (with ``device_times``, in device time,
    the calls' times beside).  Without ``require_main`` the wrapper may
    take either of its C entries (the row names it: ``entry``), and the
    turns against the other entry are skipped."""
    import torch
    import torch.nn.functional as F

    from cxxnet_tpu_torch.ops import lrn, maxpool
    from cxxnet_tpu_torch.ops.kernels import conv_block

    if kernel == "sgd_update":
        return check_sgd(key, dev, gen)
    esz = torch.empty((), dtype=dtype).element_size()
    op_kind = "bf16_tensor" if dtype == torch.bfloat16 else "f32"

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def relu_randn(*shape):  # relu zeros: the ties of a real net
        return torch.randn(*shape, generator=gen).clamp_min(0).to(dev, dtype)

    if kernel == "maxpool_fwd":
        shape, kh, kw, s, py, px = key
        x = randn(*shape)
        args = (x, kh, kw, s, py, px)
        run = lambda: maxpool.maxpool_fwd(*args)  # noqa: E731
        plain = lambda: maxpool.maxpool_plain(*args)  # noqa: E731
        xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view
        library = lambda: F.max_pool2d(  # noqa: E731
            xc, (kh, kw), s, (py, px), ceil_mode=True)
        ops_per_out, op_kind = kh * kw, "f32"  # one compare per tap
        nbytes_in = x.numel() * esz
        label = f"x{tuple(shape)} k{kh} s{s} p{py}"
    elif kernel in ("maxpool_bwd", "maxpool_bwd_s1"):
        shape, kh, kw, s, py, px = key
        x = relu_randn(*shape)
        y = maxpool.maxpool_fwd(x, kh, kw, s, py, px)
        g = randn(*y.shape)
        if kernel == "maxpool_bwd":
            args = (x, y, g, kh, kw, s, py, px)
            run = lambda: maxpool.maxpool_bwd(*args)  # noqa: E731
            plain = lambda: maxpool.maxpool_bwd_plain(*args)  # noqa: E731
            taps = (-(-kh // s)) * (-(-kw // s))
        else:
            args = (x, y, g, kh, py)
            run = lambda: maxpool.maxpool_bwd_s1(*args)  # noqa: E731
            plain = lambda: maxpool.maxpool_bwd_s1_plain(  # noqa: E731
                *args)
            taps = kh * kw
        xc = x.permute(0, 3, 1, 2)
        yt, idx = torch.ops.aten.max_pool2d_with_indices(
            xc, [kh, kw], [s, s], [py, px], [1, 1], True)
        gt = torch.randn(yt.shape, generator=gen).to(dev, dtype).contiguous(
            memory_format=torch.channels_last)
        library = lambda: (  # noqa: E731
            torch.ops.aten.max_pool2d_with_indices_backward(
                gt, xc, [kh, kw], [s, s], [py, px], [1, 1], True, idx))
        ops_per_out, op_kind = 2 * taps, "f32"  # compare and add per tap
        nbytes_in = (x.numel() + y.numel() + g.numel()) * esz
        label = f"x{tuple(shape)} k{kh} s{s} p{py}"
    elif kernel in ("lrn_fwd", "lrn_bwd"):
        shape, n, alpha, beta, knorm = key
        xc_grad = None
        if kernel == "lrn_fwd":
            x = randn(*shape)
            args = (x, n, alpha, beta, knorm)
            run = lambda: lrn.lrn_fwd(*args)  # noqa: E731
            plain = lambda: lrn.lrn_plain(*args)  # noqa: E731
            xc = x.permute(0, 3, 1, 2)
            library = lambda: F.local_response_norm(  # noqa: E731
                xc, n, alpha, beta, knorm)
            # the window's squares and adds, then the scale, pow, product
            ops_per_out = 2 * n + 4
            nbytes_in = x.numel() * esz
        else:
            x = relu_randn(*shape)
            g = randn(*shape)
            args = (x, g, n, alpha, beta, knorm)
            run = lambda: lrn.lrn_bwd(*args)  # noqa: E731
            plain = lambda: lrn.lrn_bwd_plain(*args)  # noqa: E731
            xc_grad = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
            yl = F.local_response_norm(xc_grad, n, alpha, beta, knorm)
            gc = g.permute(0, 3, 1, 2)
            library = lambda: torch.autograd.grad(  # noqa: E731
                yl, xc_grad, gc, retain_graph=True)
            # two window sums (squares, then t), two pows, ~10 more flops
            ops_per_out = 4 * n + 12
            nbytes_in = 2 * x.numel() * esz
        op_kind = "f32"
        label = f"x{tuple(shape)} n{n}"
    else:  # (M, K, O), or (M, K, O, False) for a bias-free group
        m, k, o, *biased = key
        x = randn(m, k)
        w = randn(k, o, scale=k ** -0.5)
        b = randn(o, scale=0.1) if biased in ([], [True]) else None
        run = lambda: conv_block.conv_block_gemm(x, w, b)  # noqa: E731
        plain = lambda: conv_block.conv_block_plain(x, w, b)  # noqa: E731
        library = ((lambda: torch.addmm(b, x, w)) if b is not None
                   else (lambda: torch.mm(x, w)))
        ops_per_out = 2 * k
        nbytes_in = (x.numel() + w.numel() + (o if b is not None else 0)
                     ) * esz
        label = f"M{m} K{k} O{o}" + ("" if b is not None else " no bias")

    # K6 in bf16 and K1-K5 must take their main paths (the C entry by
    # name)
    sfx = "bf16" if dtype == torch.bfloat16 else "f32"
    vector = kernel.startswith(("maxpool", "lrn"))
    main = f"{kernel}_{sfx}" if vector else (
        conv_block.WGMMA if (kernel, dtype) == ("conv_block_gemm",
                                                torch.bfloat16) else None)
    owner = {"conv_block_gemm": conv_block.KERNEL,
             "maxpool_fwd": maxpool.KERNEL, "maxpool_bwd": maxpool.BWD_KERNEL,
             "maxpool_bwd_s1": maxpool.BWD_S1_KERNEL,
             "lrn_fwd": lrn.KERNEL, "lrn_bwd": lrn.BWD_KERNEL}.get(kernel)
    symbols = dict(owner.by_symbol) if owner else {}
    got = run()
    ref = plain()
    torch.cuda.synchronize()
    took = _symbol_delta(owner, symbols) if owner else {}
    if not require_main:
        main = None
    if main is not None:
        if took != {main: 1}:
            raise SmokeError(f"{kernel} {label} {dtype} launched {took}, "
                             f"not the main path ({main}) once")
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise SmokeError(f"{kernel} {label}: {got.shape}/{got.dtype} vs "
                         f"plain {ref.shape}/{ref.dtype}")
    rtol, atol = TOL[(kernel, str(dtype).split(".")[1])]
    abs_err, rel_err = _err(got, ref)
    if rtol == 0 and atol == 0:
        ok = bool(torch.equal(got, ref))
    else:
        ok = bool(torch.isclose(got.float(), ref.float(), rtol=rtol,
                                atol=atol).all())
    if not bool(torch.isfinite(got.float()).all()):
        ok = False
    bound_ms, bound_by = bound(nbytes_in + got.numel() * esz,
                               got.numel() * ops_per_out, op_kind)
    row = {
        "kernel": kernel, "shape": label, "dtype": str(dtype).split(".")[1],
        "max_abs_err": abs_err, "max_rel_err": rel_err, "rtol": rtol,
        "atol": atol, "ok": ok,
        "ms": time_ms(run, device=device_times),
        "plain_ms": time_ms(plain, device=device_times),
        "library_ms": time_ms(library, device=device_times),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if device_times:
        row["call_ms"] = time_ms(run)
        row["library_call_ms"] = time_ms(library)
    if not require_main:
        row["entry"] = sorted(took)
        del got, ref
        return row
    if vector and dtype == torch.bfloat16:
        row["call_ms"], row["library_call_ms"] = row["ms"], row["library_ms"]
        row.update(_edge_turns(kernel, args, ref, run, library, rtol, atol))
        row["ok"] = row["ok"] and row["edge_ok"]
    del got, ref
    if kernel == "conv_block_gemm" and dtype == torch.bfloat16:
        row["call_ms"], row["library_call_ms"] = row["ms"], row["library_ms"]
        row.update(_conv_block_turns(x, w, b, run, library, rtol, atol))
        row["ok"] = row["ok"] and row["relu_ok"] and row["mma_sync_ok"]
    return row


def _edge_turns(kernel, args, ref, run, library, rtol, atol):
    """K1-K5 bf16 at one main-path shape, beyond the wrapper's launch:
    the old scalar kernel (the edge path), reached by its C entry,
    against the plain version (K1-K3 bit-equal, K4 and K5 within their
    tolerance); then the main path, the edge kernel and the library call
    (``F.max_pool2d``, aten's max-pool backward,
    ``F.local_response_norm`` or its autograd backward) timed in turns,
    device time."""
    import torch

    from cxxnet_tpu_torch.ops import lrn, maxpool

    launch = {"maxpool_fwd": maxpool.launch_fwd,
              "maxpool_bwd": maxpool.launch_bwd,
              "maxpool_bwd_s1": maxpool.launch_bwd_s1,
              "lrn_fwd": lrn.launch_fwd, "lrn_bwd": lrn.launch_bwd}[kernel]
    edge = lambda: launch(f"{kernel}_bf16_edge", *args)  # noqa: E731
    got = edge()
    if rtol == 0 and atol == 0:
        edge_ok = bool(torch.equal(got, ref))
    else:
        edge_ok = bool(torch.isclose(got.float(), ref.float(), rtol=rtol,
                                     atol=atol).all())
    edge_ok = edge_ok and bool(torch.isfinite(got.float()).all())
    del got
    times = time_turns({"vector": run, "edge": edge, "aten": library},
                       device=True)
    return {"edge_ok": edge_ok,
            "ms": statistics.mean(times["vector"]),
            "edge_ms": statistics.mean(times["edge"]),
            "library_ms": statistics.mean(times["aten"]),
            "turns": times}


def _conv_block_turns(x, w, b, run, library, rtol, atol):
    """K6 bf16 at one main-path shape, beyond the product the wrapper
    ran: the wgmma kernel with relu and no bias, and the mma.sync edge
    kernel (reached by its C entry) against the plain version; then the
    wgmma kernel, the edge kernel and ``torch.addmm`` (``torch.mm`` for
    a bias-free group) timed in turns, device time (the calls' host cost
    left out: tens of microseconds a call, which would bound these 10-60
    us kernels)."""
    import torch

    from cxxnet_tpu_torch.ops.kernels import conv_block

    def close(got, ref):
        return bool(torch.isclose(got.float(), ref.float(), rtol=rtol,
                                  atol=atol).all()) and bool(
            torch.isfinite(got.float()).all())

    relu_ok = close(conv_block.conv_block_gemm(x, w, None, True),
                    conv_block.conv_block_plain(x, w, None, True))
    edge = lambda: conv_block.launch(  # noqa: E731
        conv_block.EDGE, x, w, b, False)
    edge_ok = close(edge(), conv_block.conv_block_plain(x, w, b))
    times = time_turns({"wgmma": run, "mma_sync": edge, "library": library},
                       device=True)
    return {"relu_ok": relu_ok, "mma_sync_ok": edge_ok,
            "ms": statistics.mean(times["wgmma"]),
            "mma_sync_ms": statistics.mean(times["mma_sync"]),
            "library_ms": statistics.mean(times["library"]),
            "turns": times}


def check_conv_block_edge(dev, gen):
    """K6's edge path at ``CONV_RAGGED`` (K and O off the main path's
    rule), float32 and bfloat16, with and without the bias and relu:
    the mma.sync and f32 kernels against the plain version, and the
    wrapper's choice of them."""
    import torch

    from cxxnet_tpu_torch.ops.kernels import conv_block

    m, k, o = CONV_RAGGED
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        x = torch.randn(m, k, generator=gen).to(dev, dtype)
        w = (torch.randn(k, o, generator=gen) * k ** -0.5).to(dev, dtype)
        b = (torch.randn(o, generator=gen) * 0.1).to(dev, dtype)
        rtol, atol = TOL[("conv_block_gemm", name)]
        abs_err, ok = 0.0, True
        want = conv_block.EDGE if dtype == torch.bfloat16 else \
            "conv_block_gemm_f32"
        for bias, relu in ((b, False), (None, True), (b, True)):
            before = conv_block.KERNEL.by_symbol.get(want, 0)
            got = conv_block.conv_block_gemm(x, w, bias, relu)
            ref = conv_block.conv_block_plain(x, w, bias, relu)
            torch.cuda.synchronize()
            ok = ok and conv_block.KERNEL.by_symbol.get(want, 0) == before + 1
            ok = ok and bool(torch.isclose(got.float(), ref.float(),
                                           rtol=rtol, atol=atol).all())
            abs_err = max(abs_err, _err(got, ref)[0])
        rows.append({"kernel": "conv_block_gemm", "dtype": name,
                     "shape": f"ragged M{m} K{k} O{o} ({want})",
                     "max_abs_err": abs_err, "ok": ok, "per_step": 0})
        log(f"kernel conv_block_gemm  {name:8s} ragged M{m} K{k} O{o} "
            f"through {want}: abs {abs_err:.3g} (rtol {rtol:g} atol "
            f"{atol:g}) {'ok' if ok else 'MISMATCH'}")
    return rows


def check_lrn_edge(dev, gen):
    """K4's and K5's edge paths at ``LRN_EDGE`` (C 70, and a view one
    element off 16-byte alignment), float32 and bfloat16: the scalar
    kernels against the plain versions, and the wrappers' choice of
    them (their C entries' counts)."""
    import math

    import torch

    from cxxnet_tpu_torch.ops import lrn

    rows = []
    for shape, offset in LRN_EDGE:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            sfx = "bf16" if dtype == torch.bfloat16 else "f32"
            buf = torch.randn(math.prod(shape) + offset, generator=gen)
            x = buf.to(dev, dtype)[offset:].view(shape)
            g = torch.randn(shape, generator=gen).to(dev, dtype)
            for kernel, owner, run, plain in (
                    ("lrn_fwd", lrn.KERNEL,
                     lambda: lrn.lrn_fwd(x, *LRN_EDGE_ARGS),
                     lambda: lrn.lrn_plain(x, *LRN_EDGE_ARGS)),
                    ("lrn_bwd", lrn.BWD_KERNEL,
                     lambda: lrn.lrn_bwd(x, g, *LRN_EDGE_ARGS),
                     lambda: lrn.lrn_bwd_plain(x, g, *LRN_EDGE_ARGS))):
                before = dict(owner.by_symbol)
                got = run()
                ref = plain()
                torch.cuda.synchronize()
                want = {f"{kernel}_{sfx}_edge": 1}
                took = _symbol_delta(owner, before)
                rtol, atol = TOL[(kernel, name)]
                ok = took == want and bool(torch.isclose(
                    got.float(), ref.float(), rtol=rtol, atol=atol).all())
                ok = ok and bool(torch.isfinite(got.float()).all())
                abs_err = _err(got, ref)[0]
                label = f"edge {shape} offset {offset}"
                rows.append({"kernel": kernel, "dtype": name,
                             "shape": label, "max_abs_err": abs_err,
                             "ok": ok, "per_step": 0})
                log(f"kernel {kernel:16s} {name:8s} {label} through {took}: "
                    f"abs {abs_err:.3g} (rtol {rtol:g} atol {atol:g}) "
                    f"{'ok' if ok else 'MISMATCH'}")
    return rows


def check_lrn_power(dev):
    """K4's main path's power route against float64 on the card, beside
    the edge kernel's powf and the plain version's pow: the largest
    error of y = x * (x^2)^-beta in ulp of y (the main path within
    ``LRN_ROUTE_ULPS``); then K5 at knorm 0 and alpha 1e-2, where dx
    cancels two terms near 1e3: each side's largest error from float64
    past rtol = atol = 1e-5 (informational: why the card tests hold
    knorm 0 at alpha = nsize)."""
    import torch

    from cxxnet_tpu_torch.ops import lrn

    def ulps(got, true):
        t32 = true.float().abs()
        ulp = (torch.nextafter(t32, torch.full_like(t32, float("inf")))
               - t32).double()
        return float(((got.double() - true).abs() / ulp).max())

    x = torch.logspace(-3, 3, 1 << 20, device=dev).view(-1, 8)
    worst = 0.0
    for beta in (0.5, 0.75, 1.0):
        true = x.double() * (x * x).double().pow(-beta)
        args = (1, 1.0, beta, 0.0)
        read = {"main": ulps(lrn.lrn_fwd(x, *args), true),
                "edge powf": ulps(lrn.launch_fwd("lrn_fwd_f32_edge", x,
                                                 *args), true),
                "plain pow": ulps(lrn.lrn_plain(x, *args), true)}
        worst = max(worst, read["main"])
        log(f"lrn power: K4 beta {beta}, x 1e-3..1e3: ulp of y from "
            "float64: " + ", ".join(f"{k} {v:.3f}" for k, v in read.items()))
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(5, 7, 9, 64, generator=gen).to(dev)
    g = torch.randn(x.shape, generator=gen).to(dev)
    args = (5, 1e-2, 0.75, 0.0)
    lo, hi = lrn.window_offsets(5)
    xd, gd = x.double(), g.double()
    norm = lrn._norm(xd, 5, 1e-2, 0.0)
    back = lrn._shifted_sum(gd * xd * norm.pow(-1.75), -hi, -lo)
    true = gd * norm.pow(-0.75) - (2 * 1e-2 / 5 * 0.75 * xd) * back
    past = {name: float(((got.double() - true).abs() - 1e-5
                         - 1e-5 * true.abs()).max())
            for name, got in (("main", lrn.lrn_bwd(x, g, *args)),
                              ("plain", lrn.lrn_bwd_plain(x, g, *args)))}
    log(f"lrn power: K5 knorm 0 alpha 1e-2 {tuple(x.shape)}: largest |g p| "
        f"{float((gd * norm.pow(-0.75)).abs().max()):.4g}; error from "
        "float64 past rtol = atol = 1e-5: "
        + ", ".join(f"{k} {v:.3g}" for k, v in past.items()))
    if worst > LRN_ROUTE_ULPS:
        raise SmokeError(f"K4's power route {worst:.2f} ulp from float64, "
                         f"over {LRN_ROUTE_ULPS}")


def check_sgd(tensors, dev, gen):
    """The SGD kernel over every parameter tensor of the step in one
    multi-tensor launch, in place: bit-equality with the plain version,
    and the times of the whole set against the per-tensor loop of
    one-tensor launches and ``torch.optim.SGD(fused=True).step()``."""
    import torch

    from cxxnet_tpu_torch.ops.kernels import update_step

    def make(shape):
        return torch.randn(*shape, generator=gen).to(dev)

    ws = [make(t[0]) for t in tensors]
    gs = [make(t[0]) for t in tensors]
    ms = [make(t[0]) for t in tensors]
    ws2 = [w.clone() for w in ws]
    ms2 = [m.clone() for m in ms]
    hyper = list(zip(*(t[1:] for t in tensors)))  # lrs, moms, wds, clips

    def run(ws=ws, ms=ms):
        update_step.sgd_update_multi(ws, gs, ms, *hyper)

    def per_tensor(ws=ws, ms=ms):
        for w, g, m, (_, lr, mom, wd, clip) in zip(ws, gs, ms, tensors):
            update_step.sgd_update(w, g, m, lr, mom, wd, clip)

    def plain(ws=ws2, ms=ms2):
        for w, g, m, (_, lr, mom, wd, clip) in zip(ws, gs, ms, tensors):
            update_step.sgd_update_plain(w, g, m, lr, mom, wd, clip)

    n0 = update_step.KERNEL.launches
    run()
    launches = update_step.KERNEL.launches - n0
    plain()
    torch.cuda.synchronize()
    want = -(-len(tensors) // update_step.MAX_TENSORS)
    ok = launches == want
    ok = ok and all(torch.equal(a, b) for a, b in zip(ws + ms, ws2 + ms2))
    ok = ok and all(bool(torch.isfinite(w).all()) for w in ws)
    abs_err = max(float((a - b).abs().max()) for a, b in
                  zip(ws + ms, ws2 + ms2))
    # the library yardstick: one fused SGD step over the same tensors,
    # grouped by weight decay
    groups = {}
    for w, g, (_, lr, mom, wd, _c) in zip(ws, gs, tensors):
        p = w.clone().requires_grad_(True)
        p.grad = g
        groups.setdefault((lr, wd), []).append(p)
    opt = torch.optim.SGD(
        [{"params": ps, "lr": lr, "weight_decay": wd}
         for (lr, wd), ps in groups.items()],
        lr=tensors[0][1], momentum=tensors[0][2], fused=True)
    n = sum(w.numel() for w in ws)
    bound_ms, bound_by = bound(20.0 * n, 5.0 * n, "f32")
    fns = {"multi": run, "per_tensor": per_tensor, "fused_sgd": opt.step}
    times = time_turns(fns, device=True)
    calls = time_turns(fns)
    log(f"sgd: {len(tensors)} tensors in {launches} launch(es) of "
        f"sgd_update_multi_f32 (want {want}); in turns, device ms: "
        + ", ".join(f"{k} {[round(v, 4) for v in t]}"
                    for k, t in times.items())
        + "; ms a call, host included: "
        + ", ".join(f"{k} {[round(v, 4) for v in t]}"
                    for k, t in calls.items()))
    row = {
        "kernel": "sgd_update", "dtype": "float32",
        "shape": f"{len(tensors)} tensors, {n} values",
        "max_abs_err": abs_err, "max_rel_err": 0.0, "rtol": 0.0,
        "atol": 0.0, "ok": ok, "launches_per_step": launches,
        "ms": statistics.mean(times["multi"]),
        "per_tensor_ms": statistics.mean(times["per_tensor"]),
        "plain_ms": time_ms(plain),
        "library_ms": statistics.mean(times["fused_sgd"]),
        "call_ms": statistics.mean(calls["multi"]),
        "per_tensor_call_ms": statistics.mean(calls["per_tensor"]),
        "library_call_ms": statistics.mean(calls["fused_sgd"]),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    return row


def check_kernels(dev):
    import torch

    gen = torch.Generator().manual_seed(SEED)
    rows = []
    for kernel, keys in step_calls(BATCH).items():
        for key, count in keys.items():
            dtypes = ((torch.float32,) if kernel == "sgd_update"
                      else (torch.float32, torch.bfloat16))
            for dtype in dtypes:
                r = check_kernel(kernel, key, dtype, dev, gen)
                r["per_step"] = count
                rows.append(r)
                log(f"kernel {r['kernel']:16s} {r['dtype']:8s} "
                    f"{r['shape']:34s} x{count}  "
                    f"abs {r['max_abs_err']:.3g} rel {r['max_rel_err']:.3g} "
                    f"(rtol {r['rtol']:g} atol {r['atol']:g}) "
                    f"{'ok' if r['ok'] else 'MISMATCH'}  "
                    f"ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
                    f"library {r['library_ms']:.4f} bound {r['bound_ms']:.4f}"
                    f" ({r['bound_by']})"
                    + (f" mma_sync {r['mma_sync_ms']:.4f}"
                       if "mma_sync_ms" in r else "")
                    + (f" edge {r['edge_ms']:.4f}" if "edge_ms" in r
                       else "")
                    + (f" per-tensor loop {r['per_tensor_ms']:.4f}"
                       if "per_tensor_ms" in r else ""))
    rows += check_conv_block_edge(dev, gen)
    rows += check_lrn_edge(dev, gen)
    check_lrn_power(dev)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise SmokeError(f"{len(bad)} kernel check(s) out of tolerance: "
                         + "; ".join(f"{r['kernel']} {r['dtype']} "
                                     f"{r['shape']}" for r in bad))
    return rows


# ----------------------------------------------------------------------
# phase 3: the serving path


def _request(port: int, path: str, body=None, timeout: float = 600.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _rows(n: int, side: int, seed: int):
    """``n`` input rows of values k/8, k in [-8, 8] (short JSON), flat."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return (rng.randint(-8, 9, size=(n, side * side * 3)) / 8).astype(
        np.float32)


#: the JSON text of three values k/8 as ``json.dumps`` writes them in a
#: list, for the 17^3 triples there are
_TRIPLES = [f"{a}, {b}, {c}" for a in (repr(k / 8) for k in range(-8, 9))
            for b in (repr(k / 8) for k in range(-8, 9))
            for c in (repr(k / 8) for k in range(-8, 9))]


def _json_body(x) -> bytes:
    """``json.dumps({"data": x.tolist(), "raw": True}).encode()``, byte
    for byte, for rows of ``_rows``' values, from a table of their
    triples (a 128-row body in a quarter of ``json.dumps``'s time);
    other arrays go through ``json.dumps``."""
    import numpy as np

    k = np.rint(x * 8).astype(np.int64) + 8
    if (x.ndim != 2 or x.shape[1] % 3
            or not np.array_equal((k - 8) / 8, x)):
        return json.dumps({"data": x.tolist(), "raw": True}).encode()
    idx = (k[:, 0::3] * 17 + k[:, 1::3]) * 17 + k[:, 2::3]
    rows = ", ".join("[" + ", ".join(map(_TRIPLES.__getitem__, r)) + "]"
                     for r in idx.tolist())
    return ('{"data": [' + rows + '], "raw": true}').encode()


def _drive_requests(port: int, bodies, per_forward, tag: str):
    """The main path of a serving run: ``POST /predict`` with each body,
    ``REPEATS`` times (once from ``JSON_ONCE_ROWS`` rows), the launch
    counts set to 0 just before and read
    just after; every request must launch ``per_forward`` and no other
    kernel, K6 and K7 on their wgmma kernels only.  Returns the answers
    by size and the launches by kernel."""
    import numpy as np

    from cxxnet_tpu_torch.ops import KERNELS

    encoded = {n: _json_body(x) for n, x in bodies.items()}
    want = {**{k.name: 0 for k in KERNELS}, **per_forward}
    want_paths = _main_paths(per_forward)
    for k in KERNELS:
        k.reset_counts()
    answers = {}
    forwards = 0
    for n in bodies:
        lat = []
        for _ in range(_json_repeats(n)):
            forwards += 1
            before = {k.name: k.launches for k in KERNELS}
            paths_before = _by_symbol()
            t0 = time.perf_counter()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=encoded[n],
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                ans = json.loads(r.read())
            lat.append((time.perf_counter() - t0) * 1e3)
            delta = {k.name: k.launches - before[k.name] for k in KERNELS}
            if delta != want:
                raise SmokeError(f"{tag}: {n}-row request launched {delta}, "
                                 f"expected {want}")
            paths = _paths_since(paths_before)
            if paths != want_paths:
                raise SmokeError(f"{tag}: {n}-row request launched "
                                 f"{paths} by C entry, expected "
                                 f"{want_paths}")
        scores = np.asarray(ans["scores"], np.float32)
        if scores.shape != (n, 1000) or not np.isfinite(scores).all():
            raise SmokeError(f"{tag}: {n}-row answer: shape {scores.shape}, "
                             "or values not finite")
        if np.abs(scores.sum(1) - 1).max() > 1e-2:
            raise SmokeError(f"{tag}: {n}-row answer rows do not sum to 1")
        answers[n] = scores
        log(f"{tag}: POST /predict {n:4d} rows (bucket "
            f"{1 << (n - 1).bit_length()}): latency ms cold "
            f"{lat[0]:.1f} warm "
            + (f"{statistics.median(lat[1:]):.1f}" if lat[1:] else "-"))
    launches = {k.name: k.launches for k in KERNELS}
    log(f"{tag}: launches {launches} over {forwards} forwards; by C "
        f"entry {_by_symbol()}")
    for name, per in want.items():
        if launches[name] != per * forwards:
            raise SmokeError(f"{tag}: {name}: {launches[name]} launches, "
                             f"expected {per * forwards}")
    return answers, {k: launches[k] for k in per_forward}


def _json_repeats(n: int) -> int:
    """How many times a JSON body of ``n`` rows is sent."""
    return 1 if n >= JSON_ONCE_ROWS else REPEATS


def _routed():
    """The kernels with a main and an edge path in bf16, each with its
    main path's C entry: K6 and K7 (wgmma), K1-K3 (the vector gathers)
    and K4, K5 (the one-pass vector kernels)."""
    from cxxnet_tpu_torch.ops import lrn, maxpool
    from cxxnet_tpu_torch.ops.kernels import conv_block, int8_gemm

    return ((conv_block.KERNEL, conv_block.WGMMA),
            (maxpool.KERNEL, "maxpool_fwd_bf16"),
            (maxpool.BWD_KERNEL, "maxpool_bwd_bf16"),
            (maxpool.BWD_S1_KERNEL, "maxpool_bwd_s1_bf16"),
            (lrn.KERNEL, "lrn_fwd_bf16"),
            (lrn.BWD_KERNEL, "lrn_bwd_bf16"),
            (int8_gemm.KERNEL, int8_gemm.WGMMA))


def _main_paths(per):
    """The launches by C entry that ``per`` (launches by kernel, of one
    bf16 forward or step) must make of the routed kernels: all on the
    main path, none on the edge path."""
    return {k.name: ({main: per[k.name]} if per.get(k.name) else {})
            for k, main in _routed()}


def _symbol_delta(kernel, before):
    """A kernel's launches by C entry since ``before``, zeros left out."""
    return {n: c - before.get(n, 0) for n, c in kernel.by_symbol.items()
            if c != before.get(n, 0)}


def _by_symbol():
    """The routed kernels' launches by C entry, to diff against."""
    return {k.name: dict(k.by_symbol) for k, _ in _routed()}


def _paths_since(before):
    """The routed kernels' launches by C entry since ``before``."""
    return {k.name: _symbol_delta(k, before[k.name]) for k, _ in _routed()}


def _post_on(conn, path: str, body: bytes, ctype: str):
    """POST ``body`` on a kept-alive ``http.client`` connection:
    ``(status, reply bytes)``; the connection must stay open."""
    conn.request("POST", path, body=body, headers={"Content-Type": ctype})
    r = conn.getresponse()
    data = r.read()
    if r.will_close:
        raise SmokeError(f"the server closed a kept-alive connection "
                         f"after a {ctype} request ({r.status})")
    return r.status, data


def drive_wire(port: int, eng, bodies, json_answers, per_forward, tag: str,
               side: int, card: str):
    """The binary wire beside JSON on the engine of a serving phase, on
    kept-alive connections: for each of ``WIRE_ROWS`` a ``CXB1`` scores
    frame and the same rows as JSON, ``REPEATS`` times each (a JSON body
    of ``JSON_ONCE_ROWS`` rows or more once, and not again where the main
    path sent it: ``json_answers`` holds its reply), every
    request launching ``per_forward`` on the main paths and nothing
    else, the binary reply bit-equal to the JSON one; 128 rows as two
    concurrent 64-row frames on two connections (the second sent once
    the first has reached the engine), coalesced into one b128 forward
    and bit-equal to the JSON reply of 128 rows
    (``json_answers[128]``); one 128-row frame refused 400
    ``oversize_shape`` with no launch.  Logs the warm latency per row
    count on both wires and the engine's wire counters; returns
    ``{rows: {"json": ms, "binary": ms}}``."""
    import http.client

    import numpy as np

    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.serve import wire

    want = {**{k.name: 0 for k in KERNELS}, **per_forward}
    want_paths = _main_paths(per_forward)

    def checked(n, send):
        before = {k.name: k.launches for k in KERNELS}
        paths_before = _by_symbol()
        t0 = time.perf_counter()
        out = send()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k.name: k.launches - before[k.name] for k in KERNELS}
        paths = _paths_since(paths_before)
        if delta != want or paths != want_paths:
            raise SmokeError(f"{tag}: {n}-row wire request launched {delta}"
                             f" by C entry {paths}; expected {want}, "
                             f"{want_paths}")
        return out, ms

    rows = {n: bodies[n] if n in bodies else _rows(n, side, SEED + 300 + n)
            for n in WIRE_ROWS}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    lat = {}
    try:
        for n, x in rows.items():
            sends = {"json": (_json_body(x), "application/json"),
                     "binary": (bytes(wire.encode_request(x, kind="scores")),
                                wire.CONTENT_TYPE)}
            sent = n >= JSON_ONCE_ROWS and n in json_answers
            if sent:  # the main path's one send of these rows
                del sends["json"]
            replies, times = {}, {"json": [None]}
            for w, (body, ctype) in sends.items():
                times[w] = []
                for _ in range(REPEATS if w == "binary"
                               else _json_repeats(n)):
                    (status, data), ms = checked(
                        n, lambda: _post_on(conn, "/predict", body, ctype))
                    if status != 200:
                        raise SmokeError(f"{tag}: {n}-row {w} request: "
                                         f"{status} {data[:200]!r}")
                    times[w].append(ms)
                replies[w] = data
            j = (np.asarray(json_answers[n], np.float32) if sent else
                 np.asarray(json.loads(replies["json"])["scores"],
                            np.float32))
            kind, _rid, b = wire.decode_response(replies["binary"])
            if kind != "scores" or b.shape != j.shape or \
                    b.tobytes() != j.tobytes():
                raise SmokeError(f"{tag}: {n}-row binary reply {b.shape} is "
                                 f"not bit-equal to the JSON reply {j.shape}")
            lat[n] = {w: None if sent and w == "json" else
                      statistics.median(t[1:] or t) for w, t in times.items()}
            j_ms = ("- (the main path's send)" if sent else
                    f"{lat[n]['json']:.1f} (cold {times['json'][0]:.1f})")
            log(f"{tag}: wire {n:4d} rows: warm latency ms JSON {j_ms} "
                f"binary {lat[n]['binary']:.1f} (cold "
                f"{times['binary'][0]:.1f}); binary bit-equal to JSON "
                f"({card})")
        # 128 rows: two 64-row frames at once on two kept-alive sockets
        x = bodies[128]
        frames = [bytes(wire.encode_request(h, kind="scores"))
                  for h in (x[:64], x[64:])]
        conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=600)
                 for _ in frames]
        window = eng.batcher.batch_timeout
        eng.batcher.batch_timeout = WIRE_PAIR_WINDOW_S
        try:
            times = []
            for _ in range(REPEATS):
                got = [None] * len(frames)

                def send(i):
                    got[i] = _post_on(conns[i], "/predict", frames[i],
                                      wire.CONTENT_TYPE)

                def pair():
                    # the second frame goes once the first has reached the
                    # engine, so the batch holds the rows in x's order
                    # (batch norm's statistics sum them in that order)
                    ths = [threading.Thread(target=send, args=(i,))
                           for i in range(len(frames))]
                    n0 = eng.stats.requests
                    ths[0].start()
                    while eng.stats.requests == n0 and ths[0].is_alive():
                        time.sleep(0.0005)
                    ths[1].start()
                    for t in ths:
                        t.join(timeout=600)
                    return list(got)

                b0, r0 = eng.stats.batches, eng.stats.bucket_rows
                replies, ms = checked(128, pair)
                if (eng.stats.batches - b0, eng.stats.bucket_rows - r0) != (
                        1, 128):
                    raise SmokeError(
                        f"{tag}: the two 64-row frames ran as "
                        f"{eng.stats.batches - b0} batch(es) of "
                        f"{eng.stats.bucket_rows - r0} bucket rows, not one "
                        "b128 forward")
                times.append(ms)
        finally:
            eng.batcher.batch_timeout = window
            for c in conns:
                c.close()
        parts = []
        for status, data in replies:
            if status != 200:
                raise SmokeError(f"{tag}: 64-row frame: {status} {data[:200]!r}")
            parts.append(wire.decode_response(data)[2])
        both = np.concatenate(parts)
        if both.tobytes() != np.asarray(json_answers[128], np.float32
                                        ).tobytes():
            raise SmokeError(f"{tag}: two 64-row frames are not bit-equal "
                             "to the 128-row JSON reply")
        lat[128] = {"binary": statistics.median(times[1:])}
        log(f"{tag}: wire 128 rows as two concurrent 64-row frames: one "
            f"b128 forward, warm latency ms {lat[128]['binary']:.1f} (cold "
            f"{times[0]:.1f}), bit-equal to the 128-row JSON reply ({card})")
        # one 128-row frame: over the 64 MiB payload cap
        big = bytes(wire.encode_request(x, kind="scores"))
        before = {k.name: k.launches for k in KERNELS}
        status, data = _post_on(conn, "/predict", big, wire.CONTENT_TYPE)
        reason = json.loads(data).get("reason") if status == 400 else None
        if reason != "oversize_shape" or any(
                k.launches != before[k.name] for k in KERNELS):
            raise SmokeError(f"{tag}: a 128-row frame ({len(big)} bytes) "
                             f"got {status} {data[:200]!r}, not 400 "
                             "oversize_shape without a launch")
        log(f"{tag}: wire 128-row frame ({len(big)} bytes, payload over "
            f"{wire.MAX_PAYLOAD_BYTES}): 400 oversize_shape")
    finally:
        conn.close()
    st = eng.snapshot_stats()
    log(f"{tag}: wire counters requests {json.dumps(st['wire_requests'])} "
        f"bytes {json.dumps(st['wire_bytes'])}")
    return lat


def serve_phase(tmp: str):
    """Drive the serving path from a seeded checkpoint written to
    ``tmp``, on both wires; returns the kernels' launch counts, the
    checkpoint's path, the served answers by request size and the warm
    latencies of ``drive_wire``."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import Engine, make_server

    cfg = cfgmod.parse_file(CONF) + [("dev", "gpu"), ("seed", str(SEED)),
                                     ("silent", "1")]
    side = int(dict(cfg)["input_shape"].split(",")[1])
    t0 = time.perf_counter()
    tr = NetTrainer()
    tr.set_params(cfg)
    tr.init_model()
    path = os.path.join(tmp, "0001.model")
    tr.save_model(path, round_=1)
    del tr
    log(f"serve: init_model + save_model {time.perf_counter() - t0:.2f}s")

    eng = Engine(cfg=cfg, model_in=path, max_batch_size=max(REQUEST_ROWS))
    httpd = make_server(eng, port=0)
    th = threading.Thread(target=httpd.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    try:
        port = httpd.server_port
        h = _request(port, "/healthz")
        log(f"serve: healthz {json.dumps(h)}")
        if h["status"] != "ok" or h["round"] != 1:
            raise SmokeError(f"unhealthy engine: {h}")
        if not h["device"].startswith("cuda"):
            raise SmokeError(f"engine runs on {h['device']}")
        bodies = {n: _rows(n, side, SEED + n) for n in REQUEST_ROWS}
        answers, launches = _drive_requests(port, bodies, PER_FORWARD,
                                            "serve")
        wire_lat = drive_wire(port, eng, bodies, answers, PER_FORWARD,
                              "serve", side, gpu_line())
        x8 = bodies[REQUEST_ROWS[1]]
        feats16 = eng.extract(x8, "pool5")
        probs16 = answers[x8.shape[0]]
        forward_breakdown(eng.trainer, bodies)
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
        eng.close()

    # the 8-row bucket in float32, TF32 off, against the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = [("compute_dtype", "float32")]
    ref = {}
    for name, dev in (("card", "gpu"), ("cpu", "cpu")):
        with Engine(cfg=cfg + f32 + [("dev", dev)], model_in=path,
                    max_batch_size=max(REQUEST_ROWS)) as e:
            ref[name] = (e.scores(x8), e.extract(x8, "pool5"))
            params = e.trainer.params
    cls = next(v for k, v in params.items()
               if k.endswith("_loss3_classifier"))
    _hold_served("serve", ref, feats16, probs16, cls, "pool5")
    return launches, path, answers, wire_lat


def _hold_served(tag, ref, feats16, probs16, cls, node,
                 bf16_limits=(BF16_FEAT_REL, BF16_LOGIT_REL)):
    """The served answers of one bucket held as the module docstring
    states: ``ref`` the float32 ``(scores, node features)`` of the card
    (``card``) and the CPU (``cpu``), ``feats16``/``probs16`` the bf16
    model's, ``cls`` the classifier's f32 params (fullc, wmat (nout,
    nin)) that make logits of the features, ``bf16_limits`` the bf16
    features' and logits' limits."""
    import numpy as np

    wmat = cls["wmat"].cpu().double().numpy()
    bias = cls["bias"].cpu().double().numpy()
    (p_card, f_card), (p_cpu, f_cpu) = ref["card"], ref["cpu"]

    def logits(feats):  # the classifier (fullc, wmat (nout, nin)) in f64
        return feats.reshape(len(feats), -1).astype(np.float64) @ wmat.T + bias

    l16, l32 = logits(feats16), logits(f_card)
    checks = {
        "f32_card_vs_cpu_prob_abs": float(np.abs(p_card - p_cpu).max()),
        "f32_card_vs_cpu_feat_rel": float(np.abs(f_card - f_cpu).max()
                                          / np.abs(f_cpu).max()),
        "bf16_vs_f32_feat_rel": float(np.abs(feats16 - f_card).max()
                                      / np.abs(f_card).max()),
        "bf16_vs_f32_logit_rel": float(np.abs(l16 - l32).max()
                                       / np.abs(l32).max()),
    }
    limits = {
        "f32_card_vs_cpu_prob_abs": F32_PROB_ATOL,
        "f32_card_vs_cpu_feat_rel": F32_FEAT_REL,
        "bf16_vs_f32_feat_rel": bf16_limits[0],
        "bf16_vs_f32_logit_rel": bf16_limits[1],
    }
    for key, val in checks.items():
        log(f"{tag}: {key} {val:.3g} (limit {limits[key]:g})")
    log(f"{tag}: f32 logits max |l| {np.abs(l32).max():.3f}, bf16 max abs "
        f"logit error {np.abs(l16 - l32).max():.3f} ({node} features)")
    # the served top-1 class must hold on every row whose f32 top-2 gap
    # is wider than twice the measured logit error plus one logit for the
    # bf16 rounding of the served classifier itself (half an ulp is at
    # most 0.5 below |logit| 256)
    top2 = np.sort(l32, axis=1)[:, -2:]
    wide = (top2[:, 1] - top2[:, 0]) > 2 * np.abs(l16 - l32).max() + 1
    agree = probs16.argmax(1) == p_card.argmax(1)
    log(f"{tag}: bf16/f32 top-1 agreement {int(agree.sum())}/{len(agree)} "
        f"rows; {int(wide.sum())} rows with a top-2 gap wider than the "
        f"margin, {int(agree[wide].sum())} of them agree")
    bad = [k for k, v in checks.items() if not v <= limits[k]]
    if not agree[wide].all():
        bad.append("bf16_vs_f32_top1")
    if bad:
        raise SmokeError(f"{tag}: served scores out of tolerance: {bad}")


def forward_breakdown(tr, bodies, per=PER_FORWARD, model="GoogLeNet"):
    """The forward alone per bucket (no HTTP, no JSON; host clock around
    a synchronised call, median of 5), and where the device time of the
    smallest and the largest bucket's forward goes (``torch.profiler``,
    one forward each, launching ``per`` on the main paths)."""
    import numpy as np
    import torch

    f = tr.predict_fn()
    row_shape = tr.net.input_node_shape(1)[1:]
    runs = {}
    for n, x in bodies.items():
        b = 1 << (n - 1).bit_length()
        data = np.zeros((b, x.shape[1]), np.float32)
        data[:n] = x
        data = data.reshape((b,) + row_shape)

        def run(data=data):
            f(tr.params, tr.aux, data, ())
            torch.cuda.synchronize()

        run()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            ts.append((time.perf_counter() - t0) * 1e3)
        runs[b] = run
        log(f"forward: {model} bucket {b:4d} {statistics.median(ts):.2f} ms "
            f"(host clock, synchronised, median of 5)")
    for b in sorted({min(runs), max(runs)}):
        _profile(runs[b], f"{model} bucket {b}", "forward", per)


def _profile(run, what: str, span: str, per=None):
    """Device time by kernel name over one call of ``run`` (a ``span``:
    forward or step), and the busy share; returns ``{kernel: ms}`` for
    the port's kernels and the totals.  With ``per`` (launches by
    kernel of one bf16 forward or step), the routed kernels' launches
    in the call must be ``_main_paths(per)``: all on the main path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    paths_before = _by_symbol()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
    if per is not None and _paths_since(paths_before) != _main_paths(per):
        raise SmokeError(f"profile: {what}: {span} launched "
                         f"{_paths_since(paths_before)} by C entry, "
                         f"expected {_main_paths(per)}")
    by_name, counts = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        by_name[e.key] = by_name.get(e.key, 0.0) + t / 1e3
        counts[e.key] = counts.get(e.key, 0) + e.count
    busy = sum(by_name.values())
    tag = f"profile: {what}:"
    log(f"{tag} {span} {wall:.2f} ms wall under the profiler, "
        f"{busy:.2f} ms of device time ({busy / wall if wall else 0:.3f} "
        f"busy)")
    # K7 first: K6's kernel names are substrings of K7's
    ours = {"int8_gemm": ("int8_gemm_wgmma_kernel", "int8_gemm_bf16_kernel",
                          "int8_gemm_f32_kernel", "int8_gemm_reduce_kernel"),
            "maxpool_fwd": ("maxpool_fwd_kernel", "maxpool_fwd_vec_kernel"),
            "lrn_fwd": ("lrn_fwd_kernel", "lrn_fwd_vec_kernel"),
            "conv_block_gemm": ("conv_block_wgmma_kernel",
                                "gemm_bf16_kernel", "gemm_f32_kernel"),
            "maxpool_bwd": ("maxpool_bwd_kernel", "maxpool_bwd_vec_kernel"),
            "maxpool_bwd_s1": ("maxpool_bwd_s1_kernel",
                               "maxpool_bwd_s1_vec_kernel"),
            "lrn_bwd": ("lrn_bwd_kernel", "lrn_bwd_vec_kernel"),
            "sgd_update": ("sgd_update_multi_kernel",),
            "flash_fwd": ("flash_fwd_",),  # the f32 and the _mma_ kernels
            "flash_bwd": ("flash_dq_", "flash_dkv_")}
    out = {"wall_ms": wall, "device_ms": busy, "counts": counts,
           "by_name": by_name}
    mine = set()
    for name, frags in ours.items():
        hits = {k for k in by_name
                if k not in mine and any(f in k for f in frags)}
        mine |= hits
        out[name] = sum(by_name[k] for k in hits)
        if out[name]:
            log(f"{tag} {name} {out[name]:.3f} ms")
    # the rest by kind: library GEMMs and convs, elementwise, reductions
    kinds = {"cuBLAS/cuDNN": ("nvjet", "gemm", "xmma", "cutlass", "cudnn",
                              "fprop", "dgrad", "wgrad", "sm90_", "sm80_"),
             "elementwise": ("elementwise",), "reduce": ("reduce",),
             "memcpy": ("Memcpy", "Memset")}
    rest = {k: v for k, v in by_name.items() if k not in mine}
    split = {"our kernels": busy - sum(rest.values())}
    for kind, frags in kinds.items():
        hits = [k for k in rest if any(f in k for f in frags)]
        split[kind] = sum(rest.pop(k) for k in hits)
    split["other"] = sum(rest.values())
    log(f"{tag} device ms by kind: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    out["by_kind"] = split
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"{tag} {v:8.3f} ms  {k[:100]}")
    return out


# ----------------------------------------------------------------------
# phase 4: quantized serving (K7)


def int8_calls(tr, want=INT8_PER_FORWARD, model="GoogLeNet"):
    """K7's calls in one quantized forward of ``model`` at ``BATCH``
    rows, read off the port's shape inference: ``{param key: (M, K,
    O)}`` for each 1x1 / pad-0 / ungrouped conv outside a sibling group
    and each 2-D fullc (the layers ``ops/quant.py`` routes to K7); there
    must be ``want``."""
    from cxxnet_tpu_torch.layers.conv import ConvolutionLayer
    from cxxnet_tpu_torch.layers.linear import FullConnectLayer

    net = tr.net
    shapes = net.infer_shapes(BATCH)
    member = net._sibling_1x1_groups()[1]
    calls = {}
    for i, spec in enumerate(tr.graph.layers):
        lay = net.layer_objs[i]
        xin, out = shapes[spec.nindex_in[0]], shapes[spec.nindex_out[0]]
        if type(lay) is ConvolutionLayer and i not in member:
            p = lay.param
            if (p.kernel_height, p.kernel_width, p.pad_y, p.pad_x,
                    p.num_group) == (1, 1, 0, 0, 1):
                n, oh, ow, o = out
                calls[net.param_key[i]] = (n * oh * ow, xin[3], o)
        elif type(lay) is FullConnectLayer and len(xin) == 2:
            calls[net.param_key[i]] = (xin[0], xin[1], out[1])
    if len(calls) != want:
        raise SmokeError(f"{len(calls)} K7 layers in {model}, not "
                         f"{want}: {sorted(calls)}")
    return calls


def check_int8(calls, dev, ragged=True):
    """K7 against its plain version at every call of the forward and
    (with ``ragged``) at ``INT8_RAGGED``: float32 (TF32 off) and bfloat16, with and without
    the bias, with relu; per row (``_row_rel_err``) within
    ``INT8_TOL``.  In bf16 the forward's calls must take the wgmma main
    path and the ragged one the mma.sync edge path; at the forward's
    calls the edge kernel (reached by its C entry) must agree too.
    There, bf16 with bias (the layers' own case) is timed: the wgmma
    kernel, the edge kernel and the library yardstick ``F.linear`` over
    weights dequantized ahead (a call the port never makes) in turns,
    in device time and per call (host included), the plain version, and
    the bound."""
    import torch
    import torch.nn.functional as F

    from cxxnet_tpu_torch.ops.kernels import int8_gemm

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    cases = [(key, mko) for key, mko in calls.items()]
    if ragged:
        cases.append(("ragged", INT8_RAGGED))
    rows = []
    for key, (m, k, o) in cases:
        x32 = torch.randn(m, k, generator=gen, device=dev)
        q = torch.randint(-127, 128, (o, k), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand(o, generator=gen, device=dev) * 0.02 / k ** 0.5
        bias = torch.randn(o, generator=gen, device=dev) * 0.1
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            name = str(dtype).split(".")[1]
            err = 0.0
            abs_err = 0.0
            want = {"float32": "int8_gemm_f32",
                    "bfloat16": int8_gemm.EDGE if key == "ragged"
                    else int8_gemm.WGMMA}[name]
            for b, relu in ((bias, False), (None, True), (bias, True)):
                before = dict(int8_gemm.KERNEL.by_symbol)
                got = int8_gemm.int8_gemm_rescale(x, q, scale, b, relu)
                ref = int8_gemm.int8_gemm_plain(x, q, scale, b, relu)
                torch.cuda.synchronize()
                took = _symbol_delta(int8_gemm.KERNEL, before)
                if took != {want: 1}:
                    raise SmokeError(f"int8_gemm {key} {name} launched "
                                     f"{took}, not {want} once")
                if got.dtype != dtype or got.shape != (m, o) or not bool(
                        torch.isfinite(got.float()).all()):
                    raise SmokeError(f"int8_gemm {key} {name}: "
                                     f"{got.shape}/{got.dtype} or not finite")
                err = max(err, _row_rel_err(got, ref))
                abs_err = max(abs_err, float((got.float() - ref.float())
                                             .abs().max()))
                del got, ref
            row = {"kernel": "int8_gemm", "layer": key, "dtype": name,
                   "shape": f"M{m} K{k} O{o}", "row_rel_err": err,
                   "max_abs_err": abs_err, "limit": INT8_TOL[name],
                   "ok": err <= INT8_TOL[name], "timed": False}
            if dtype == torch.bfloat16 and key != "ragged":
                run = lambda: int8_gemm.int8_gemm_rescale(  # noqa: E731
                    x, q, scale, bias)
                edge = lambda: int8_gemm.launch(  # noqa: E731
                    int8_gemm.EDGE, x, q, scale, bias, False)
                edge_err = _row_rel_err(
                    edge(), int8_gemm.int8_gemm_plain(x, q, scale, bias))
                w16 = (q.float() * scale[:, None]).to(dtype)
                b16 = bias.to(dtype)
                esz = x.element_size()
                bound_ms, bound_by = bound(
                    m * k * esz + o * k + 8 * o + m * o * esz,
                    2.0 * m * k * o, "bf16_tensor")
                fns = {"wgmma": run, "mma_sync": edge,
                       "linear": lambda: F.linear(x, w16, b16)}
                times = time_turns(fns, device=True)
                calls_ms = time_turns(fns)
                row.update(
                    timed=True, ok=row["ok"] and edge_err <= INT8_TOL[name],
                    edge_row_rel_err=edge_err,
                    ms=statistics.mean(times["wgmma"]),
                    mma_sync_ms=statistics.mean(times["mma_sync"]),
                    library_ms=statistics.mean(times["linear"]),
                    call_ms=statistics.mean(calls_ms["wgmma"]),
                    mma_sync_call_ms=statistics.mean(calls_ms["mma_sync"]),
                    library_call_ms=statistics.mean(calls_ms["linear"]),
                    plain_ms=time_ms(lambda: int8_gemm.int8_gemm_plain(
                        x, q, scale, bias)),
                    bound_ms=bound_ms, bound_by=bound_by)
                row.update(_int8_splits(x, q, scale, bias))
                row["ok"] = row["ok"] and row["split_row_rel_err"] <= \
                    INT8_TOL[name]
            rows.append(row)
            log(f"kernel int8_gemm {name:8s} {key:24s} {row['shape']:22s} "
                f"row rel {err:.3g} (limit {row['limit']:g}) through {want} "
                f"{'ok' if row['ok'] else 'MISMATCH'}"
                + (f"; mma_sync edge row rel {row['edge_row_rel_err']:.3g}; "
                   f"device ms wgmma {row['ms']:.4f} mma_sync "
                   f"{row['mma_sync_ms']:.4f} F.linear "
                   f"{row['library_ms']:.4f}; ms a call, host included, "
                   f"{row['call_ms']:.4f}, {row['mma_sync_call_ms']:.4f}, "
                   f"{row['library_call_ms']:.4f}; plain "
                   f"{row['plain_ms']:.4f} bound {row['bound_ms']:.4f} "
                   f"({row['bound_by']}); splits of K {row['splits']}"
                   + "".join(f", device ms at {n} {t:.4f}"
                             for n, t in row["split_ms"].items())
                   if row["timed"] else ""))
        del x32, q
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise SmokeError(f"{len(bad)} int8_gemm check(s) out of tolerance: "
                         + "; ".join(f"{r['layer']} {r['dtype']}"
                                     for r in bad))
    return rows


def _int8_splits(x, q, scale, bias):
    """K7's split of K at one forward shape: the count ``k_splits``
    picks and, where the output tiles are fewer than the SMs (the
    classifier and the two (6272, 832, 128) layers), the main path
    forced to 1, 2, 4 and 8 parts (as many as K has 64-deep slices),
    each held against the plain version and timed in turns, device
    time: the readings behind the rule."""
    import torch

    from cxxnet_tpu_torch.ops.kernels import int8_gemm

    (m, k), o = x.shape, q.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    out = {"splits": int8_gemm.k_splits(m, k, o, sms), "split_ms": {},
           "split_row_rel_err": 0.0}
    if -(-m // 128) * -(-o // 64) >= sms:
        return out
    ref = int8_gemm.int8_gemm_plain(x, q, scale, bias)
    fns = {}
    for n in (1, 2, 4, 8):
        if n > -(-k // 64):
            continue
        fns[n] = (lambda n=n: int8_gemm.launch(  # noqa: E731
            int8_gemm.WGMMA, x, q, scale, bias, False, n))
        out["split_row_rel_err"] = max(out["split_row_rel_err"],
                                       _row_rel_err(fns[n](), ref))
    times = time_turns(fns, device=True)
    out["split_ms"] = {n: statistics.mean(t) for n, t in times.items()}
    return out


def _export_quant(conf: str, path: str, *extra):
    """``task=export_quant`` through ``LearnTask``, in-process: returns
    its exit code and the JSON verdict line it prints."""
    import contextlib
    import io

    from cxxnet_tpu_torch.cli import LearnTask

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = LearnTask().run([conf, "task=export_quant", f"model_in={path}",
                              "dev=gpu", "silent=1",
                              f"quant_calib_batches={QUANT_CALIB_BATCHES}",
                              *extra])
    verdict = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"quant: export {' '.join(extra) or '(gated at 0.99)'}: exit {rc} in "
        f"{time.perf_counter() - t0:.1f}s; ok {verdict['ok']}, agreement "
        f"{verdict['agreement']} over {verdict['eval_rows']} rows, "
        f"{verdict['int8_layers']} int8 + {verdict['bf16_layers']} bf16 "
        f"layers, fallbacks {verdict['fallbacks']}, bytes ratio "
        f"{verdict['bytes_ratio']:.3f} ({verdict['weight_bytes']} of "
        f"{verdict['weight_bytes_f32']} f32 bytes)")
    if rc != (0 if verdict["ok"] else 3):
        raise SmokeError(f"task=export_quant exited {rc} on verdict ok="
                         f"{verdict['ok']}")
    return verdict


def _at_rest(load):
    """``(trainer, bytes)``: the trainer ``load`` returns, and the device
    bytes it added (``torch.cuda.memory_allocated``)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    tr = load()
    torch.cuda.synchronize()
    return tr, torch.cuda.memory_allocated() - before


def quant_phase(tmp: str, path: str, f32_answers):
    """Export the seeded checkpoint at ``path`` with ``task=export_quant``
    and serve the artifact with ``quant = int8``: K7 against its plain
    version, the export's verdict, the served main path's launches, the
    card against the CPU, the forward's time and the bytes at rest.
    Returns the K7 rows and the serving run's launches."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.nnet.quant import quant_artifact_path
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops.kernels import int8_gemm
    from cxxnet_tpu_torch.serve import Engine, make_server

    cfg = cfgmod.parse_file(CONF) + [("dev", "gpu"), ("silent", "1")]
    qcfg = cfg + [("quant", "int8")]
    side = int(dict(cfg)["input_shape"].split(",")[1])
    probe = NetTrainer()
    probe.set_params(cfg + [("dev", "cpu")])
    probe.init_model()
    calls = int8_calls(probe)
    del probe
    rows = check_int8(calls, torch.device("cuda:0"))

    conf = _synthetic_conf(tmp, "googlenet_quant.conf",
                           (("eval", "val", EVAL_ROWS, False),), 1.0)
    verdict = _export_quant(conf, path)
    if not verdict["ok"]:
        log("quant: the gate rejected (random weights; ROADMAP C); "
            "exporting ungated (quant_min_agreement=0)")
        verdict = _export_quant(conf, path, "quant_min_agreement=0")
    qpath = quant_artifact_path(path)
    if verdict["path"] != qpath or not os.path.exists(qpath):
        raise SmokeError(f"no artifact at {qpath}: {verdict['path']}")
    demoted = [key for key in verdict["fallbacks"] if key in calls]
    per_forward = {**PER_FORWARD,
                   "int8_gemm": INT8_PER_FORWARD - len(demoted)}
    log(f"quant: K7 layers demoted to bf16: {demoted}; expecting "
        f"{per_forward} per forward")

    with Engine(cfg=qcfg, model_in=path,
                max_batch_size=max(REQUEST_ROWS)) as eng:
        httpd = make_server(eng, port=0)
        th = threading.Thread(target=httpd.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
        th.start()
        try:
            port = httpd.server_port
            h = _request(port, "/healthz")
            log(f"quant: healthz {json.dumps(h)}")
            if (h["status"] != "ok" or h["quant"] != "int8"
                    or h["model"] != qpath
                    or not h["device"].startswith("cuda")):
                raise SmokeError(f"the engine does not serve {qpath} in "
                                 f"int8 on the card: {h}")
            bodies = {n: _rows(n, side, SEED + n) for n in REQUEST_ROWS}
            answers, launches = _drive_requests(port, bodies, per_forward,
                                                "quant serve")
            st = _request(port, "/statsz")["model"]
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=30)
    ratio = st["weight_bytes_f32"] / st["weight_bytes"]
    log(f"quant: /statsz weight bytes {st['weight_bytes']} of "
        f"{st['weight_bytes_f32']} f32: ratio {ratio:.3f} (at least "
        f"{QUANT_MIN_RATIO})")
    if not ratio >= QUANT_MIN_RATIO:
        raise SmokeError(f"weight-bytes ratio {ratio:.3f} < "
                         f"{QUANT_MIN_RATIO}")
    for n in REQUEST_ROWS:
        agree = answers[n].argmax(1) == f32_answers[n].argmax(1)
        log(f"quant: {n}-row request, int8 vs f32 model (both bf16) served "
            f"top-1 agreement {int(agree.sum())}/{n}")

    # the int8 model in float32 (TF32 off): the card against the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x8 = bodies[REQUEST_ROWS[1]]
    ref = {}
    for name, dev in (("card", "gpu"), ("cpu", "cpu")):
        with Engine(cfg=qcfg + [("compute_dtype", "float32"), ("dev", dev)],
                    model_in=path, max_batch_size=max(REQUEST_ROWS)) as e:
            if e.model_path != qpath:
                raise SmokeError(f"{name}: served {e.model_path}")
            ref[name] = (e.scores(x8), e.extract(x8, "pool5"))
    (p_card, f_card), (p_cpu, f_cpu) = ref["card"], ref["cpu"]
    prob = float(np.abs(p_card - p_cpu).max())
    feat = float(np.abs(f_card - f_cpu).max() / np.abs(f_cpu).max())
    log(f"quant: int8 model f32, card vs CPU: probabilities max abs "
        f"{prob:.3g} (limit {F32_PROB_ATOL:g}), pool5 {feat:.3g} of its "
        f"largest (limit {F32_FEAT_REL:g})")
    if not (prob <= F32_PROB_ATOL and feat <= F32_FEAT_REL):
        raise SmokeError("int8 model: card and CPU disagree in float32")

    # the b128 forward, bf16, device-resident input; the bytes at rest
    def load(extra, model):
        def f():
            tr = NetTrainer()
            tr.set_params(cfg + extra)
            tr.load_model(model)
            return tr
        return f

    tr32, rest32 = _at_rest(load([], path))
    tr8, rest8 = _at_rest(load([("quant", "int8")], qpath))
    if tr8.params[next(iter(calls))]["wmat_q8"].dtype != torch.int8:
        raise SmokeError("the int8 codes are not int8 on the card")
    gen = torch.Generator(device=tr8.device).manual_seed(SEED)
    x = torch.randn(tr8.net.input_node_shape(BATCH), device=tr8.device,
                    generator=gen)
    timing = {}
    for name, tr, rest in (("f32", tr32, rest32), ("int8", tr8, rest8)):
        f = tr.predict_fn()

        def run(f=f, tr=tr):
            f(tr.params, tr.aux, x, ())
            torch.cuda.synchronize()

        before = torch.cuda.memory_allocated()
        run()
        prepared = torch.cuda.memory_allocated() - before
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            ts.append((time.perf_counter() - t0) * 1e3)
        timing[name] = (statistics.median(ts), run)
        log(f"quant: {name} model, b{BATCH} bf16 forward "
            f"{timing[name][0]:.2f} ms (device-resident input, synchronised, "
            f"median of 5); device bytes at rest {rest} after load, "
            f"{prepared} more held by the prepared operands")
    before = dict(int8_gemm.KERNEL.by_symbol)
    k7 = _profile(timing["int8"][1], f"int8 b{BATCH} bf16", "forward",
                  per_forward)
    took = _symbol_delta(int8_gemm.KERNEL, before)
    # the trace's own count beside the wrapper's: a trace can miss
    # records (one run's held 10 of the 11 launches and a quarter less
    # device time), so the wrapper's count is the one held to
    traced = {kind: sum(c for kname, c in k7["counts"].items()
                        if fn in kname)
              for kind, fn in (("wgmma", "int8_gemm_wgmma_kernel"),
                               ("edge", "int8_gemm_bf16_kernel"))}
    reduce_ms = sum(t for kname, t in k7["by_name"].items()
                    if "int8_gemm_reduce_kernel" in kname)
    log(f"quant: K7 {k7['int8_gemm']:.3f} ms of {k7['device_ms']:.3f} ms "
        f"device time in one int8 forward ({k7['int8_gemm'] / k7['device_ms']:.3f}"
        f" share; its split of K's second pass {reduce_ms:.4f} ms), launches "
        f"{took} (traced {traced})")
    want = {int8_gemm.WGMMA: per_forward["int8_gemm"]}
    if took != want or traced["edge"]:
        raise SmokeError(f"the profiled int8 forward launched K7 {took} "
                         f"(traced {traced}), expected {want}")
    return rows, launches


# ----------------------------------------------------------------------


def kernels_line(rows, serve_launches, train_launches, flash_rows,
                 lm_launches, gen_launches, int8_rows, quant_launches,
                 loop_out, fleet_out, p27, p28, p2930, p31, p32, p33):
    """Per kernel: the launches of its main path (GoogLeNet training for
    K1-K8, with the serving run's for the forward kernels; the LM
    training run for K9 and K10, with the windowed generation run's; the
    int8 serving run for K7; beside them phase 25's: the closed loop's
    two ``serve_train`` runs and its ``loop_fleet`` run summed, and the
    service-fed training run; phase 26's: the in-process engines of 26a
    and 26b, and 26c; phase 27's: 27a's ``remat = 1`` LM run, 27b's MoE
    LM run, 27c's ``remat = 1`` pipe steps and 27d's ``remat = 1``
    GoogLeNet steps; phase 28's two ranks; phase 29's async step and
    phase 30's ring and all-to-all steps, the two ranks summed; phase
    31's three runs on the model axis, the two ranks summed, with K6's
    and K8's calls at a rank's sliced shapes; phase 32a's eight
    processes, summed), the max error over every
    check, and one
    training step's launches' times summed (GoogLeNet b128 bf16; the SGD
    kernel's f32 row covers all its launches; the LM step's 4 launches of
    K9 and of K10), or for K7 one b128 bf16 forward's 11 launches."""
    from cxxnet_tpu_torch.ops import KERNELS

    step_flash = next(r for r in flash_rows if r["per_step"])
    out = []
    for k in KERNELS:
        if k.name == "int8_gemm":
            fwd = [r for r in int8_rows if r["timed"]]
            by_bytes = sum(r["bound_ms"] for r in fwd
                           if r["bound_by"] == "bytes")
            by_ops = sum(r["bound_ms"] for r in fwd) - by_bytes
            out.append({
                "name": k.name, "route": "cuda",
                "source": os.path.relpath(k.source, REPO),
                "replaces": k.replaces.split()[0],
                "launches": quant_launches[k.name],
                "max_abs_err": max(r["max_abs_err"] for r in int8_rows),
                **{f: sum(r[f] for r in fwd)
                   for f in ("ms", "plain_ms", "bound_ms", "library_ms",
                             "mma_sync_ms", "call_ms", "mma_sync_call_ms",
                             "library_call_ms")},
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            })
            continue
        if k.name in ("flash_fwd", "flash_bwd"):
            pre = k.name.split("_")[1]
            names = ("o",) if pre == "fwd" else ("dq", "dk", "dv")
            n = step_flash["per_step"]
            b_ms, b_by = step_flash[f"{pre}_bound"]
            hops = [{"label": r["label"], "shape": r["shape"],
                     "offsets": r["offsets"],
                     "launches_per_rank_step": r["per_step"],
                     "ms": r[f"{pre}_ms"], "plain_ms": r[f"{pre}_plain_ms"],
                     "bound_ms": r[f"{pre}_bound"][0],
                     "bound_by": r[f"{pre}_bound"][1],
                     "library_ms": r[f"{pre}_library_ms"]}
                    for r in p2930["hops"]]
            out.append({
                "name": k.name, "route": "cuda",
                "source": os.path.relpath(k.source, REPO),
                "replaces": k.replaces.split()[0],
                "launches": lm_launches[k.name],
                "max_abs_err": max(r["errors"][m][0]
                                   for r in [*flash_rows, *p2930["hops"]]
                                   for m in names),
                "seq_parallel_calls": hops,
                "ms": n * step_flash[f"{pre}_ms"],
                "plain_ms": n * step_flash[f"{pre}_plain_ms"],
                "bound_ms": n * b_ms, "bound_by": b_by,
                "library_ms": n * step_flash[f"{pre}_library_ms"],
                "launches_generate": gen_launches[k.name],
            })
            continue
        mine = [r for r in rows if r["kernel"] == k.name]
        step_dtype = "float32" if k.name == "sgd_update" else "bfloat16"
        step = [r for r in mine if r["dtype"] == step_dtype
                and r["per_step"]]

        def total(field):
            return sum(r[field] * r["per_step"] for r in step)

        by_bytes = sum(r["per_step"] * r["bound_ms"] for r in step
                       if r["bound_by"] == "bytes")
        by_ops = total("bound_ms") - by_bytes
        sliced = [r for r in p31["kernels"] if r["kernel"] == k.name]
        row = {
            "name": k.name, "route": "cuda",
            "source": os.path.relpath(k.source, REPO),
            "replaces": k.replaces.split()[0],
            "launches": train_launches[k.name],
            "max_abs_err": max(r["max_abs_err"] for r in mine + sliced),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": total("library_ms"),
        }
        if k.name in serve_launches:
            row["launches_serving"] = serve_launches[k.name]
        if k.name == "conv_block_gemm":  # the mma.sync design, same run
            row["mma_sync_ms"] = total("mma_sync_ms")
        vector = k.name.startswith(("maxpool", "lrn"))
        if vector:  # the old kernel
            row["edge_ms"] = total("edge_ms")
        if k.name == "sgd_update":  # one launch per tensor, same run
            row["per_tensor_ms"] = total("per_tensor_ms")
        if vector or k.name in ("conv_block_gemm", "sgd_update"):
            # "ms" and "library_ms" are device times; a call's, host
            # included, beside them
            row.update({f: total(f) for f in ("call_ms", "library_call_ms")})
        if sliced:  # phase 31a: a rank's calls on its model slices
            row["model_axis_calls"] = [
                {"shape": r["shape"], "entry": r.get("entry", "main"),
                 "launches_per_rank_step": r["per_step"],
                 **{f: r[f] for f in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}}
                for r in sliced]
        out.append(row)
    loop_runs = [*loop_out["serve_train"], loop_out["loop_fleet"]]
    for row in out:
        row["launches_closed_loop"] = sum(r["launches"].get(row["name"], 0)
                                          for r in loop_runs)
        row["launches_data_service"] = loop_out["data_service"][
            "launches"].get(row["name"], 0)
        # phase 26: the replicas' own launches (their /metricsz), the
        # in-process engines their frames were held against, and 26c's
        # forwards and steps
        for col, src in (("launches_fleet", "fleet"),
                         ("launches_fleet_reference", "reference")):
            row[col] = sum(fleet_out[p]["launches"][src].get(row["name"], 0)
                           for p in ("serve", "canary"))
        row["launches_branch_embed"] = sum(
            d.get(row["name"], 0)
            for d in fleet_out["branch_embed"]["launches"].values())
        row["launches_remat_lm"] = p27["remat_lm"]["launches"][1][
            row["name"]]
        row["launches_moe_lm"] = p27["moe_lm"]["launches"][row["name"]]
        row["launches_pipe"] = sum(
            d.get(row["name"], 0)
            for d in p27["pipe"]["train"][1]["launches"])
        row["launches_remat_googlenet"] = REMAT_STEPS * p27[
            "remat_googlenet"]["remat"][1]["launches"][row["name"]]
        # phase 28: the two ranks' launches summed (28a's GoogLeNet steps
        # in f32 and bf16 and 28b's ResNet-50 step, each rank's own)
        row["launches_dp"] = p28["googlenet_resnet"]["launches_dp"].get(
            row["name"], 0)
        # phases 29 and 30: the two ranks' launches summed (29's first
        # async step; 30's ring and all-to-all steps)
        row["launches_async"] = p2930["launches"]["async"].get(
            row["name"], 0)
        row["launches_seq_parallel"] = p2930["launches"][
            "seq_parallel"].get(row["name"], 0)
        # phase 31: the two ranks' launches summed (31a's GoogLeNet, 31b's
        # pipe stages and 31c's MoE LM steps)
        row["launches_model_axis"] = p31["launches"].get(row["name"], 0)
        # phase 32: 32a's eight processes' launches summed (runs A and B,
        # every generation, the joiners')
        row["launches_elastic"] = p32["launches"].get(row["name"], 0)
        # phase 33: 33a's zero = 3 steps and 33c's range forwards, both
        # ranks' launches summed
        row["launches_zero_range"] = p33["launches"].get(row["name"], 0)
    return {"kernels": out}


# ----------------------------------------------------------------------
# phases 4-6: the training path


def _train_conf(tmp: str) -> str:
    """The training run's conf (``_synthetic_conf``), its learning rates
    scaled by ``LR_SCALE``."""
    return _synthetic_conf(tmp, "googlenet_synthetic.conf",
                           (("data", "train", TRAIN_ROWS, True),
                            ("eval", "val", EVAL_ROWS, False)), LR_SCALE)


#: the smoke's synthetic draws: settings -> (data, label), the last
#: ``_DRAWS_KEEP`` sets of this process (``_keep_synthetic_draws``)
_DRAWS: dict = {}
_DRAWS_KEEP = 4


def _draw_key(it) -> tuple:
    """The settings that shape a ``SyntheticIterator``'s draw."""
    rank = it.dist_worker_rank if it.dist_num_worker > 1 else 0
    return (it.seed, it.nsample, tuple(it.input_shape), it.nclass,
            it.label_width, it.layout, rank)


def _keep_synthetic_draws() -> None:
    """Let this process draw each synthetic set once: the teacher of a
    224x224x3 input and 1000 classes is 150 million normal draws, seconds
    of host time, and the smoke's in-process tasks make the same sets
    again and again.  ``SyntheticIterator.init`` then hands a set it
    already drew (or one in ``_DRAWS`` from the parent, 33c's ranks) out
    as copies: the same values, set-up the smoke does not measure."""
    from cxxnet_tpu_torch.io.synth import SyntheticIterator

    if getattr(SyntheticIterator.init, "_kept", False):
        return
    init = SyntheticIterator.init

    def kept_init(self):
        key = _draw_key(self)
        if key in _DRAWS and self.batch_size > 0:
            data, label = _DRAWS.pop(key)
        else:
            init(self)
            data, label = self._data.copy(), self._label.copy()
        _DRAWS[key] = (data, label)  # the newest last
        while len(_DRAWS) > _DRAWS_KEEP:
            _DRAWS.pop(next(iter(_DRAWS)))
        self._data, self._label = data.copy(), label.copy()

    kept_init._kept = True
    SyntheticIterator.init = kept_init


def _synthetic_conf(tmp: str, name: str, sections, lr_scale: float) -> str:
    """A conf file: ``synthetic`` sections (kind, tag, rows, with a
    ``threadbuffer``), then the netconfig and globals of googlenet.conf
    (its imgbin sections dropped), its learning rates times
    ``lr_scale``."""
    from cxxnet_tpu_torch import config as cfgmod

    shape = dict(cfgmod.parse_file(CONF))["input_shape"]
    lines = []
    for kind, tag, rows, tb in sections:
        lines += [f"{kind} = {tag}", "iter = synthetic",
                  f"  nsample = {rows}", f"  input_shape = {shape}",
                  "  nclass = 1000"]
        lines += ["iter = threadbuffer"] if tb else []
        lines += ["iter = end"]
    split = cfgmod.split_sections(cfgmod.parse_file(CONF))
    lines += [f"{n} = {v}" for n, v in split.global_entries]
    lines += [f"{n} = {float(v) * lr_scale:g}" for n, v in
              split.global_entries if n in ("eta", "lr", "wmat:lr",
                                            "bias:lr")]
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _run_train_task(argv, on_divergence=None):
    """Run ``LearnTask`` on ``argv`` in-process with a trainer that
    records each step's launches, loss and end time; returns ``(task,
    trainer, steps, losses, marks)``.  The launch counts are set to 0
    just before the run.  ``on_divergence(task, error, resumed)`` is
    called after each response to a divergence-guard trip; a rollback's
    fresh trainer records into the same lists (``trainer.paths`` too)."""
    from cxxnet_tpu_torch.cli import LearnTask
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS

    steps, losses, marks, paths = [], [], [], []

    class RecordingTrainer(NetTrainer):
        """Records each step's launches (the routed kernels' also by C
        entry), loss and end time."""

        def start_round(self, round_):
            marks.append(("round", round_, time.perf_counter(), len(steps)))
            super().start_round(round_)

        def update(self, batch):
            before = {k.name: k.launches for k in KERNELS}
            paths_before = _by_symbol()
            super().update(batch)
            steps.append({k.name: k.launches - before[k.name]
                          for k in KERNELS})
            self.paths.append(_paths_since(paths_before))
            losses.append(float(self.last_loss))
            marks.append(("step", None, time.perf_counter(), len(steps)))

    class SmokeTask(LearnTask):
        def _create_trainer(self):
            tr = RecordingTrainer()
            tr.paths = paths
            tr.set_params(self.cfg)
            self.trainer_for_smoke = tr
            return tr

        def _handle_divergence(self, e):
            resumed = super()._handle_divergence(e)
            if on_divergence is not None:
                on_divergence(self, e, resumed)
            return resumed

    task = SmokeTask()
    for k in KERNELS:
        k.reset_counts()
    task.run(argv)
    return task, task.trainer_for_smoke, steps, losses, marks


def _round_rates(marks, batch: int, unit: str):
    """Each CLI round's rate: round start to its last step (host feed,
    metric fetch included); returns them in round order."""
    rounds = [m for m in marks if m[0] == "round"]
    rates = []
    for (_, r, ts, n0), nxt in zip(rounds, rounds[1:] + [None]):
        ends = [m for m in marks if m[0] == "step" and m[3] > n0
                and (nxt is None or m[3] <= nxt[3])]
        if ends:
            dt = ends[-1][2] - ts
            rates.append(len(ends) * batch / dt)
            log(f"train: CLI round {r - 1}: {len(ends)} steps, "
                f"{rates[-1]:.1f} {unit}/s (host clock, "
                "host feed and metric fetch included)")
    return rates


def train_phase(tmp: str):
    """Drive ``task=train`` through the CLI's ``LearnTask``; returns the
    training run's launch counts, its checkpoint directory and conf."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.ops.kernels import update_step
    from cxxnet_tpu_torch.serve import Engine, make_server

    conf = _train_conf(tmp)
    mdir = os.path.join(tmp, "models")
    argv = [conf, "task=train", "dev=gpu", f"num_round={ROUNDS}",
            f"max_round={ROUNDS}", f"model_dir={mdir}", f"seed={SEED}",
            "print_step=0"]
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts at 0 just before, read just after
    t0 = time.perf_counter()
    _, tr, steps, losses, marks = _run_train_task(argv)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_tensors = sum(len(tags) for tags in tr.params.values())
    want = {**{k.name: 0 for k in KERNELS}, **PER_STEP,
            "sgd_update": -(-n_tensors // update_step.MAX_TENSORS)}
    want_paths = _main_paths(PER_STEP)
    log(f"train: {len(steps)} steps of {tr.batch_size} rows in {wall:.1f}s "
        f"(CLI run, data set-up included); {n_tensors} parameter tensors; "
        f"peak device memory {peak:.2f} GiB")
    log(f"train: launches {launches}")
    log(f"train: losses {[round(v, 4) for v in losses]}")
    n_steps = ROUNDS * (TRAIN_ROWS // tr.batch_size)
    if len(steps) != n_steps:
        raise SmokeError(f"task=train ran {len(steps)} steps, not {n_steps}")
    for i, d in enumerate(steps):
        if d != want:
            raise SmokeError(f"training step {i} launched {d}, expected "
                             f"{want}")
    for i, d in enumerate(tr.paths):
        if d != want_paths:
            raise SmokeError(f"training step {i} launched {d} by C entry, "
                             f"expected {want_paths}")
    log(f"train: the routed kernels by C entry each step {tr.paths[0]}")
    for name, per in want.items():
        if launches[name] < per * n_steps:
            raise SmokeError(f"{name}: {launches[name]} launches in the "
                             f"training run, fewer than {per * n_steps}")
    if not all(np.isfinite(losses)):
        raise SmokeError(f"non-finite training loss: {losses}")
    rates = _round_rates(marks, tr.batch_size, "img")
    saved = sorted(f for f in os.listdir(mdir) if f.endswith(".model"))
    want_files = [f"{r:04d}.model" for r in range(ROUNDS + 1)]
    if saved != want_files:
        raise SmokeError(f"checkpoints {saved}, expected {want_files}")
    cfg = cfgmod.parse_file(conf) + [("dev", "gpu"), ("silent", "1")]
    last = os.path.join(mdir, want_files[-1])
    with Engine(cfg=cfg, model_in=last) as eng:
        httpd = make_server(eng, port=0)
        th = threading.Thread(target=httpd.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
        th.start()
        try:
            side = int(dict(cfg)["input_shape"].split(",")[1])
            ans = _request(httpd.server_port, "/predict",
                           {"data": _rows(2, side, SEED).tolist(),
                            "raw": True})
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=30)
    scores = np.asarray(ans["scores"], np.float32)
    if scores.shape != (2, 1000) or not np.isfinite(scores).all():
        raise SmokeError(f"trained model's answer: shape {scores.shape}, "
                         "or values not finite")
    log(f"train: {want_files[-1]} served by Engine; /predict answered "
        f"{scores.shape}")
    return launches, mdir, cfg, rates


def _update_of(cfg, ckpt: str, x, y, dev: str, dtype: str):
    """Each tensor's update by one step of a trainer loaded from
    ``ckpt``, as f64 numpy (CPU), where the step's forward was exactly
    zero (a bool array per node; the out node left out), the layer state
    after the step (f64 numpy) and the step's loss."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    tr = NetTrainer()
    tr.set_params(cfg + [("dev", dev), ("compute_dtype", dtype),
                         ("batch_size", str(len(x)))])
    tr.load_model(ckpt)
    w0 = {(k, t): w.detach().cpu().double().numpy().copy()
          for k, tags in tr.params.items() for t, w in tags.items()}
    with torch.no_grad():
        nodes, _ = tr.net.forward_train(
            tr.params, torch.as_tensor(x, device=tr.device),
            torch.as_tensor(y, device=tr.device), None, None)
    out = tr.net.out_node_index()
    zeros = [None if v is None or i == out else (v == 0).cpu().numpy()
             for i, v in enumerate(nodes)]
    del nodes
    tr.update_all(x, y)
    aux = {(k, t): a.cpu().double().numpy() for k, tags in tr.aux.items()
           for t, a in tags.items()}
    return ({kt: tr.params[kt[0]][kt[1]].detach().cpu().double().numpy()
             - w for kt, w in w0.items()}, zeros, aux, float(tr.last_loss))


def parity_phase(cfg, mdir: str):
    """One float32 step on the card against the CPU, and one bfloat16
    step against the float32 one, from the run's first checkpoint."""
    import numpy as np
    import torch

    # dropout off: the card's Philox and the CPU's generator draw
    # different masks
    cfg = [(n, "0.0" if n == "threshold" else v) for n, v in cfg]
    ckpt = os.path.join(mdir, "0000.model")
    side = int(dict(cfg)["input_shape"].split(",")[1])
    rng = np.random.RandomState(SEED + 11)
    x = rng.randn(PARITY_ROWS, side, side, 3).astype(np.float32)
    y = rng.randint(0, 1000, (PARITY_ROWS, 1)).astype(np.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    d_card, z_card, _, _ = _update_of(cfg, ckpt, x, y, "gpu", "float32")
    d_cpu, z_cpu, _, _ = _update_of(cfg, ckpt, x, y, "cpu", "float32")
    d_bf16, _, _, _ = _update_of(cfg, ckpt, x, y, "gpu", "bfloat16")
    flips = sum(int((a != b).sum()) for a, b in zip(z_card, z_cpu)
                if a is not None)
    n_zero = sum(int(a.sum()) for a in z_cpu if a is not None)
    log(f"parity: f32 forwards, card vs CPU: {flips} activations exactly "
        f"zero on one side only, of {n_zero} zeros on the CPU")
    rel = {kt: float(np.abs(d_card[kt] - d).max() / np.abs(d).max())
           for kt, d in d_cpu.items()}
    cos = {kt: float((d * d_card[kt]).sum()
                     / (np.linalg.norm(d) * np.linalg.norm(d_card[kt])))
           for kt, d in d_bf16.items()}
    worst_rel = max(rel, key=rel.get)
    worst_cos = min(cos, key=cos.get)
    log(f"parity: {PARITY_ROWS}-row steps in {time.perf_counter() - t0:.1f}s")
    log(f"parity: f32 card vs CPU update, max|d_card - d_cpu| / max|d_cpu|:"
        f" worst {rel[worst_rel]:.3g} at {'/'.join(worst_rel)} (limit "
        f"{UPDATE_REL:g}), median {statistics.median(rel.values()):.3g} "
        f"(limit {UPDATE_REL_MEDIAN:g})")
    log(f"parity: bf16 vs f32 card update cosine: worst {cos[worst_cos]:.5f}"
        f" at {'/'.join(worst_cos)} (limit {UPDATE_COS:g}), median "
        f"{statistics.median(cos.values()):.5f} (limit "
        f"{UPDATE_COS_MEDIAN:g})")
    for name, vals, rev in (("f32 card vs CPU rel", rel, True),
                            ("bf16 vs f32 cosine", cos, False)):
        worst = sorted(vals.items(), key=lambda kv: kv[1], reverse=rev)[:5]
        log(f"parity: {name}, worst 5: "
            + ", ".join(f"{'/'.join(kt)} {v:.4g}" for kt, v in worst))
    bad = [kt for kt, v in rel.items() if not v <= UPDATE_REL]
    bad += [kt for kt, v in cos.items() if not v >= UPDATE_COS]
    if not statistics.median(rel.values()) <= UPDATE_REL_MEDIAN:
        bad.append(("median", "f32 card vs CPU"))
    if not statistics.median(cos.values()) >= UPDATE_COS_MEDIAN:
        bad.append(("median", "bf16 vs f32 cosine"))
    if bad:
        raise SmokeError(f"training parity out of tolerance for {len(bad)} "
                         f"tensor(s): {bad[:8]}")


def conf_rates_phase(cfg, mdir: str):
    """Three b128 bf16 steps at googlenet.conf's own learning rates from
    the run's first checkpoint, each on a fresh device-resident batch:
    the losses that made the training run scale the rates
    (informational)."""
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    rates = [(n, v) for n, v in cfgmod.parse_file(CONF)
             if n in ("eta", "lr", "wmat:lr", "bias:lr")]
    tr = NetTrainer()
    tr.set_params(cfg + rates)
    tr.load_model(os.path.join(mdir, "0000.model"))
    shape = tr.net.input_node_shape(tr.batch_size)
    gen = torch.Generator(device=tr.device).manual_seed(SEED + 1)
    losses = []
    for _ in range(3):
        tr.update(DataBatch(
            data=torch.randn(shape, generator=gen, device=tr.device),
            label=torch.randint(0, 1000, (shape[0], 1), generator=gen,
                                device=tr.device).float()))
        losses.append(float(tr.last_loss))
    log(f"rates: at googlenet.conf's own rates {dict(rates)}, three steps "
        f"from 0000.model on fresh N(0, 1) batches: losses {losses}")


def _guard_run(tmp: str, mdir: str, name: str, policy: str):
    """``task=train continue=1`` through ``LearnTask`` at googlenet.conf's
    own rates, one round of ``GUARD_ROWS`` synthetic rows from a copy of
    the training run's ``0000.model`` (the seeded init: from the run's
    later rounds those rates train), under ``policy``.  Returns the
    run's model directory, exit code, trips, rollbacks, task, steps,
    losses and the printed text."""
    import shutil

    import numpy as np

    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.checkpoint import DivergenceError

    conf = _synthetic_conf(tmp, "googlenet_guard.conf",
                           (("data", "train", GUARD_ROWS, True),), 1.0)
    gdir = os.path.join(tmp, name)
    os.makedirs(gdir)
    for f in ("0000.model", "0000.model.manifest.json"):
        shutil.copy(os.path.join(mdir, f), gdir)
    trips, rollbacks = [], []

    def on_divergence(task, e, resumed):
        trips.append(str(e))
        if not resumed:
            return
        # the fresh trainer holds the checkpoint's weights bit for bit,
        # zero momentum and the backed-off rates
        path = os.path.join(gdir, f"{task.start_counter - 1:04d}.model")
        _, raw, _, _ = NetTrainer._read_model_file(path)
        tr = task.net_trainer
        same = all(np.array_equal(tr.params[k][t].cpu().numpy(), w)
                   for k, tags in raw.items() for t, w in tags.items())
        zero = all(not bool(s.any()) for tags in tr.ustates.values()
                   for slots in tags.values() for s in slots.values())
        rollbacks.append({"round": task.start_counter - 1,
                          "lr_scale": task._lr_scale,
                          "bit_equal": same, "momentum_zero": zero})

    argv = [conf, "task=train", "dev=gpu", "continue=1", "num_round=1",
            "max_round=1",
            f"model_dir={gdir}", f"seed={SEED}", "print_step=0",
            f"divergence_policy={policy}",
            f"divergence_lr_backoff={GUARD_BACKOFF}",
            f"divergence_max_retries={GUARD_RETRIES}",
            f"divergence_loss_ratio={GUARD_RATIO}"]
    t0 = time.perf_counter()
    rc, task, tr, steps, losses = 0, None, None, [], []
    with _Tee("stdout") as tee:
        try:
            task, tr, steps, losses, _ = _run_train_task(argv, on_divergence)
        except DivergenceError as e:
            # what python -m cxxnet_tpu_torch does with it: exit 1
            rc = 1
            log(f"guard: {name}: LearnTask.run raised {type(e).__name__}: "
                f"{e}")
    log(f"guard: {name}: {time.perf_counter() - t0:.1f}s, exit {rc}, "
        f"{len(trips)} trip(s), rollbacks {rollbacks}")
    return gdir, rc, trips, rollbacks, task, tr, steps, losses, \
        "".join(tee.text)


def guard_phase(tmp: str, mdir: str, cfg):
    """The divergence guard on GoogLeNet at its own rates, from the
    training run's checkpoints: ``rollback`` must trip on a loss the
    card computed (nothing injected), reload each round's checkpoint bit
    for bit, end with finite weights at an lr scale of at most
    ``GUARD_BACKOFF``; ``abort`` must stop with a non-finite loss or a
    spike and write nothing after the last good round.  Then the guard's
    cost: b128 bf16 steps with the guard on and off, in turns.  Returns
    the ``guard`` line's numbers."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.ops.kernels import update_step

    out = {}
    gdir, rc, trips, rollbacks, task, tr, steps, losses, text = _guard_run(
        tmp, mdir, "guard_rollback", "rollback")
    n_tensors = sum(len(tags) for tags in tr.params.values())
    want = {**{k.name: 0 for k in KERNELS}, **PER_STEP,
            "sgd_update": -(-n_tensors // update_step.MAX_TENSORS)}
    for i, (d, p) in enumerate(zip(steps, tr.paths)):
        if d != want or p != _main_paths(PER_STEP):
            raise SmokeError(f"guard: step {i} launched {d}, by C entry {p}")
    finite = tr.weights_finite()
    log(f"guard: rollback: {len(steps)} completed steps, each launching "
        f"{ {k: v for k, v in want.items() if v} } on the main paths; "
        f"losses {[f'{v:.4g}' for v in losses]}; trips {trips}")
    saved = sorted(f for f in os.listdir(gdir) if f.endswith(".model"))
    if (rc != 0 or not trips or not rollbacks or not finite
            or not all(r["bit_equal"] and r["momentum_zero"]
                       for r in rollbacks)
            or task._lr_scale > GUARD_BACKOFF
            or "inject_" in " ".join(n for n, _ in task.cfg)
            or saved != ["0000.model", "0001.model"]):
        raise SmokeError(f"guard: rollback run: exit {rc}, trips {trips}, "
                         f"rollbacks {rollbacks}, weights finite {finite}, "
                         f"lr scale {task._lr_scale}, checkpoints {saved}")
    log(f"guard: rollback recovered after {len(rollbacks)} rollback(s) to "
        f"an lr scale of {task._lr_scale:g} (GoogLeNet trains at "
        f"{LR_SCALE:g} in the training run); {saved[-1]} written, weights "
        "finite")
    out.update(trips=trips, rollbacks=rollbacks, lr_scale=task._lr_scale,
               guarded_steps=len(steps))
    del task, tr

    gdir, rc, trips, _, _, _, _, _, text = _guard_run(
        tmp, mdir, "guard_abort", "abort")
    saved = sorted(f for f in os.listdir(gdir) if f.endswith(".model"))
    if (rc == 0 or saved != ["0000.model"] or not any(
            w in text for w in ("non-finite loss", "finite loss spike"))):
        raise SmokeError(f"guard: abort run: exit {rc}, checkpoints {saved}")
    log(f"guard: abort: exit {rc} on {trips}; checkpoints {saved}")
    out["abort_trip"] = trips[-1]

    # the guard's cost: its one read-back a step, on and off in turns
    tr = NetTrainer()
    tr.set_params(cfg)
    tr.load_model(os.path.join(mdir, f"{ROUNDS:04d}.model"))
    shape = tr.net.input_node_shape(tr.batch_size)
    gen = torch.Generator(device=tr.device).manual_seed(SEED + 5)
    batch = DataBatch(
        data=torch.randn(shape, generator=gen, device=tr.device),
        label=torch.randint(0, 1000, (shape[0], 1), generator=gen,
                            device=tr.device).float())
    for _ in range(RATE_WARMUP):
        tr.update(batch)
    times = {"off": [], "on": []}
    for i in range(GUARD_COST_BLOCKS):
        for policy in (("", "abort") if i % 2 == 0 else ("abort", "")):
            tr.divergence_policy = policy
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GUARD_COST_STEPS):
                tr.update(batch)
            torch.cuda.synchronize()
            times["on" if policy else "off"].append(
                (time.perf_counter() - t0) * 1e3 / GUARD_COST_STEPS)
    if not np.isfinite(float(tr.last_loss)):
        raise SmokeError("guard: the cost run's loss is not finite")
    out["step_ms"] = {k: statistics.median(v) for k, v in times.items()}
    out["step_ms_blocks"] = times
    log(f"guard: GoogLeNet b{tr.batch_size} bf16 step, host clock over "
        f"{GUARD_COST_BLOCKS} blocks of {GUARD_COST_STEPS} each way in "
        f"turns (synchronised at each block's ends): guard off "
        f"{out['step_ms']['off']:.2f} ms, on {out['step_ms']['on']:.2f} ms "
        f"(median of blocks; all {json.dumps(times)})")
    return out


def mnist_guard_phase(tmp: str, card: str):
    """``MNIST_CONV.conf`` on the MNIST phase's idx files (in ``tmp``),
    2 rounds under ``divergence_policy = rollback`` with an injected NaN
    and, with ``divergence_loss_ratio = MNIST_GUARD_RATIO``, an injected
    spike at update ``MNIST_GUARD_STEP``, on the card and on the CPU: the
    printed rollback round and lr scale must be equal."""
    cwd = os.getcwd()
    os.chdir(tmp)
    lines = {}
    try:
        for inject in ("inject_nan_step", "inject_spike_step"):
            for dev in ("gpu", "cpu"):
                mdir = f"guard_{inject}_{dev}"
                argv = [MNIST_CONF, "task=train", f"dev={dev}", "num_round=2",
                        "max_round=2", f"model_dir={mdir}", "print_step=0",
                        "divergence_policy=rollback",
                        f"{inject}={MNIST_GUARD_STEP}"]
                if inject == "inject_spike_step":
                    argv.append(f"divergence_loss_ratio={MNIST_GUARD_RATIO}")
                with _Tee("stdout") as tee:
                    _run_train_task(argv)
                lines[(inject, dev)] = [
                    line.replace(mdir, "<dir>")
                    for line in "".join(tee.text).splitlines()
                    if line.startswith("divergence: rolled back")]
    finally:
        os.chdir(cwd)
    for inject in ("inject_nan_step", "inject_spike_step"):
        card_l, cpu_l = lines[(inject, "gpu")], lines[(inject, "cpu")]
        log(f"guard: MNIST_CONV {inject}={MNIST_GUARD_STEP}: card {card_l}, "
            f"CPU {cpu_l} ({card})")
        if card_l != cpu_l or len(card_l) != 1:
            raise SmokeError(f"guard: MNIST_CONV {inject}: the card printed "
                             f"{card_l}, the CPU {cpu_l}")
    return lines


def rate_phase(cfg, mdir: str, per=PER_STEP, model="GoogLeNet"):
    """``RATE_STEPS`` b128 bf16 steps on device-resident batches after
    ``RATE_WARMUP`` warm-up steps (CUDA events), the peak memory, then
    one step under the profiler (launching ``per`` on the main paths)."""
    import torch

    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS

    tr = NetTrainer()
    tr.set_params(cfg)
    tr.load_model(os.path.join(mdir, f"{ROUNDS:04d}.model"))
    shape = tr.net.input_node_shape(tr.batch_size)
    gen = torch.Generator(device=tr.device).manual_seed(SEED)
    batch = DataBatch(
        data=torch.randn(shape, generator=gen, device=tr.device),
        label=torch.randint(0, 1000, (shape[0], 1), generator=gen,
                            device=tr.device).float())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(RATE_WARMUP):
        tr.update(batch)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    kernels = [k for k in KERNELS if k.name in per]
    before = {k.name: dict(k.by_symbol) for k in kernels}
    a.record()
    for _ in range(RATE_STEPS):
        tr.update(batch)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / RATE_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    took = {k.name: _symbol_delta(k, before[k.name]) for k in kernels}
    log(f"rate: {model} b{tr.batch_size} bf16 training step {ms:.2f} ms, "
        f"{tr.batch_size / ms * 1e3:.1f} img/s ({RATE_STEPS} steps after "
        f"{RATE_WARMUP} warm-up, CUDA events, device-resident batches); "
        f"peak device memory {peak:.2f} GiB; launches by C entry over the "
        f"{RATE_STEPS} steps {json.dumps(took)}")
    for k in kernels:
        if sum(took[k.name].values()) != per[k.name] * RATE_STEPS:
            raise SmokeError(f"rate: {model}: {k.name} launched "
                             f"{took[k.name]} in {RATE_STEPS} steps, not "
                             f"{per[k.name]} a step")

    def step():
        tr.update(batch)
        torch.cuda.synchronize()

    return _profile(step, f"{model} train b{tr.batch_size} bf16", "step",
                    per)


# ----------------------------------------------------------------------
# phases 8-11: the language model (K9, K10)


def _visible_pairs(t: int, tk: int, causal: bool, q_off: int,
                   k_off: int) -> int:
    """(query, key) pairs the attention must compute: all of them, or
    under ``causal`` those with ``q_off + i >= k_off + j``."""
    if not causal:
        return t * tk
    return sum(min(max(q_off + i - k_off + 1, 0), tk) for i in range(t))


def _live_rows(t: int, tk: int, causal: bool, q_off: int,
               k_off: int) -> tuple:
    """(query rows that see at least one key, key rows that at least one
    query sees): the rows whose inputs the attention must read.  A
    query row that sees no key comes out o = 0, lse = -1e30 whatever
    its inputs, and so does its gradient's share."""
    if not causal:
        return t, tk
    return (t - min(max(k_off - q_off, 0), t),
            min(max(q_off + t - k_off, 0), tk))


def flash_cases():
    """(label, dtype, B, T, Tk, H, D, causal, q_off, k_off, through the
    LSE entry, q/k/v as slices of one fused (B, T, 3, H, D) tensor,
    launches per LM training step): the float32 checks at (2, 512, 8,
    64) and around it, float32 at T 2048 (32 key tiles), and the LM
    step's own shape and layout last."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    h, d = LM_HEADS, LM_DIM // LM_HEADS
    return [
        ("causal", f32, 2, 512, 512, h, d, True, 0, 0, False, False, 0),
        ("non-causal", f32, 2, 512, 512, h, d, False, 0, 0, False, False,
         0),
        ("cross T512 Tk384", f32, 2, 512, 384, h, d, False, 0, 0, False,
         False, 0),
        ("cross causal T384 Tk512", f32, 2, 384, 512, h, d, True, 0, 0,
         False, False, 0),
        ("lse q_off 0 k_off 200 (200 dead rows)", f32, 2, 512, 512, h, d,
         True, 0, 200, True, False, 0),
        ("lse q_off 300 k_off 0", f32, 2, 512, 512, h, d, True, 300, 0,
         True, False, 0),
        ("causal T2048, fused qkv", f32, 2, LM_T, LM_T, h, d, True, 0, 0,
         False, True, 0),
        ("LM step, fused qkv", bf16, LM_BATCH, LM_T, LM_T, h, d, True, 0, 0,
         False, True, LM_LAYERS),
    ]


def _row_rel_err(got, ref, floor: float = 0.0) -> float:
    """The worst row's largest error over that row's largest plain
    magnitude, a row being one (batch, position, head) vector of D: a
    late causal row's output is ~30x smaller than row 0's, so a limit
    on the tensor's largest magnitude would not see it.  A row's scale
    is at least ``floor`` times the tensor's largest; with no floor, a
    row that is 0 in the plain result must be 0 in the kernel's."""
    err = (got.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1)
    scale = scale.clamp_min(max(floor * float(scale.max()), 1e-30))
    return float((err / scale).max())


def _flash_smem(name: str, d: int) -> int:
    """The dynamic shared memory the launchers in ``csrc/flash_*.cu``
    request for a kernel at head dim ``d``: f32 tiles of 64 rows (the
    scalar kernels), or bf16 tiles of 64 rows at a pitch of d + 8 (the
    tensor-core kernels: Q and K, V double-buffered; Q, dO and K, V
    double-buffered; K, V and Q, dO double-buffered with their lse and
    dl rows)."""
    sp, tile = 68, 64 * (d + 8) * 2
    return {"flash_fwd_kernel": (3 * d * 64 + 64 * sp + 3 * 64) * 4,
            "flash_dq_kernel": (5 * d * 64 + 64 * sp + 2 * 64) * 4,
            "flash_dkv_kernel": (6 * d * 64 + 2 * 64 * sp + 2 * 64) * 4,
            "flash_fwd_mma_kernel": 5 * tile,
            "flash_dq_mma_kernel": 6 * tile,
            "flash_dkv_mma_kernel": 6 * tile + 4 * 64 * 4}[name]


def _build_report(k, name_re):
    """Per kernel function of ``k``'s library whose mangled name
    ``name_re`` matches (the key: the regex's groups): registers and
    spill bytes (``nvcc -Xptxas -v`` of this run's build) and the
    tensor-core instructions in its SASS (``cuobjdump -sass``): HMMA
    (``mma.sync``) and HGMMA (``wgmma``)."""
    import re

    from cxxnet_tpu_torch.ops import _build

    if not k.build_log:
        raise SmokeError(f"{k.name} was not built by this run (no ptxas "
                         "log); remove build/kernels and run again")

    def key_of(mangled):
        m = name_re.search(mangled)
        return m and tuple(g for g in m.groups() if g is not None)

    report, fn = {}, None
    for line in k.build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = key_of(m.group(1))
            if fn:
                report[fn] = {"spill": 0, "hmma": 0, "hgmma": 0}
            continue
        if not fn:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            report[fn]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[fn]["registers"] = int(m.group(1))
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", k.library_path()],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        raise SmokeError(f"cuobjdump -sass {k.name}: {sass.stderr}")
    fn = None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = key_of(m.group(1))
        elif fn in report and "HGMMA" in line:
            report[fn]["hgmma"] += 1
        elif fn in report and "HMMA" in line:
            report[fn]["hmma"] += 1
    return report


def flash_build_report():
    """Per flash kernel function and head dim: registers and spill bytes,
    the dynamic shared memory its launcher requests, and its HMMA
    (tensor-core) instructions.  Fails if a bf16 (tensor-core) flash
    kernel has no HMMA or spills."""
    import re

    from cxxnet_tpu_torch.ops import flash

    name_re = re.compile(r"(flash_[a-z]+(?:_mma)?_kernel)ILi(\d+)E")
    report, bad = {}, []
    for k in (flash.FWD_KERNEL, flash.BWD_KERNEL):
        for (name, d), r in _build_report(k, name_re).items():
            report[(name, int(d))] = r
    for (name, d), r in sorted(report.items()):
        mma = "_mma_" in name
        log(f"flash build: {name}<{d}> {r.get('registers', '?')} registers, "
            f"{_flash_smem(name, d)} bytes dynamic shared memory, "
            f"{r['spill']} bytes spilled, {r['hmma']} HMMA instructions "
            f"({'bf16, tensor cores' if mma else 'f32, CUDA cores'})")
        if mma and (r["hmma"] == 0 or r["spill"]):
            bad.append(f"{name}<{d}>")
    kinds = {name for name, _ in report}
    if len(report) != 18 or len(kinds) != 6:
        raise SmokeError(f"expected 6 flash kernels at 3 head dims in the "
                         f"ptxas log, found {sorted(report)}")
    if bad:
        raise SmokeError(f"tensor-core flash kernels without HMMA or with "
                         f"spills: {bad}")
    return report


def _wgmma_smem(bn: int) -> int:
    """The dynamic shared memory ``csrc/conv_block_gemm.cu`` requests
    for its wgmma kernel at tile width ``bn`` (``WTile``): 1024 bytes of
    alignment slack, the ring (a 128 x 64 X box and ceil(bn / 64)
    64 x 64 W boxes a stage, up to 6 stages), the output tile's 128 x bn
    bf16 staging, the two f32 bias rows and the stages' mbarriers."""
    stage = 128 * 64 * 2 + -(-bn // 64) * 64 * 64 * 2
    epi, bias = 128 * bn * 2, 2 * bn * 4
    stages = min(6, (232448 - 1024 - epi - bias - 96) // stage)
    return 1024 + stages * stage + epi + bias + 16 * stages


def conv_block_build_report():
    """K6's kernel functions: registers, spills, dynamic shared memory and
    tensor-core instructions.  Fails unless every width of the bf16
    main-path (wgmma) kernel has HGMMA instructions and no spills."""
    import re

    from cxxnet_tpu_torch.ops.kernels import conv_block

    name_re = re.compile(r"(conv_block_wgmma_kernel)ILi(\d+)E|"
                         r"(gemm_bf16_kernel|gemm_f32_kernel)")
    report = _build_report(conv_block.KERNEL, name_re)
    bad = []
    for key, r in sorted(report.items()):
        wgmma = key[0] == "conv_block_wgmma_kernel"
        label = f"{key[0]}<{key[1]}>" if wgmma else key[0]
        smem = (f"{_wgmma_smem(int(key[1]))} bytes dynamic shared memory, "
                if wgmma else "")
        log(f"conv_block build: {label} {r.get('registers', '?')} "
            f"registers, {smem}{r['spill']} bytes spilled, {r['hgmma']} "
            f"HGMMA and {r['hmma']} HMMA instructions")
        if wgmma and (r["hgmma"] == 0 or r["spill"]):
            bad.append(label)
    widths = sorted(int(key[1]) for key in report
                    if key[0] == "conv_block_wgmma_kernel")
    if widths != [128, 160, 192, 224, 256] or len(report) != 7:
        raise SmokeError(f"expected the wgmma kernel at widths 128 to 256 "
                         f"by 32 and the two mma.sync/f32 kernels in the "
                         f"ptxas log, found {sorted(report)}")
    if bad:
        raise SmokeError(f"K6 main-path kernels without HGMMA or with "
                         f"spills: {bad}")
    return report


def int8_build_report():
    """K7's kernel functions: registers, spills and tensor-core
    instructions.  Fails unless the wgmma kernel has HGMMA instructions
    and no spills at both its tile widths (32 and 64)."""
    import re

    from cxxnet_tpu_torch.ops.kernels import int8_gemm

    name_re = re.compile(r"(int8_gemm_wgmma_kernel)ILi(\d+)E|"
                         r"(int8_gemm_bf16_kernel|int8_gemm_f32_kernel)")
    report = _build_report(int8_gemm.KERNEL, name_re)
    bad = []
    for key, r in sorted(report.items()):
        wgmma = key[0] == "int8_gemm_wgmma_kernel"
        label = f"{key[0]}<{key[1]}>" if wgmma else key[0]
        log(f"int8_gemm build: {label} {r.get('registers', '?')} registers, "
            f"{r['spill']} bytes spilled, {r['hgmma']} HGMMA and "
            f"{r['hmma']} HMMA instructions")
        if wgmma and (r["hgmma"] == 0 or r["spill"]):
            bad.append(label)
    widths = sorted(int(key[1]) for key in report
                    if key[0] == "int8_gemm_wgmma_kernel")
    if widths != [32, 64] or len(report) != 4:
        raise SmokeError(f"expected the wgmma kernel at widths 32 and 64 "
                         f"and the mma.sync/f32 kernels in the ptxas log, "
                         f"found {sorted(report)}")
    if bad:
        raise SmokeError(f"K7 main-path kernels without HGMMA or with "
                         f"spills: {bad}")
    return report


def check_flash(dev, cases=None, timed=False):
    """K9 and K10 against their plain versions on every case
    (``flash_cases``, after the build report; or ``cases``); at the LM
    step's shape (or on every case with ``timed``) also the times:
    kernel, plain, the library yardstick (``scaled_dot_product_attention``
    with ``is_causal`` where the mask is the diagonal's, without a mask
    where the offsets differ, forward, and its backward through
    autograd), and the bounds."""
    import torch
    import torch.nn.functional as F

    from cxxnet_tpu_torch.ops import flash

    if cases is None:
        flash_build_report()
        cases = flash_cases()
    gen = torch.Generator().manual_seed(SEED + 5)
    rows = []
    for (label, dtype, b, t, tk, h, d, causal, q_off, k_off, lse_path,
         fused, per_step) in cases:
        if fused:  # the attention layer's layout: slices of its projection
            qkv = torch.randn(b, t, 3, h, d, generator=gen).to(dev, dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            do = torch.randn(b, t, h, d, generator=gen).to(dev, dtype)
        else:
            q, k, v, do = (torch.randn(b, n, h, d, generator=gen).to(
                dev, dtype) for n in (t, tk, tk, t))
        dlse = (torch.randn(b, h, t, generator=gen).to(dev) if lse_path
                else torch.zeros(b, h, t, device=dev))
        fwd = lambda: flash.flash_fwd(q, k, v, causal, q_off,  # noqa: E731
                                      k_off)
        fwd_plain = lambda: flash.flash_fwd_plain(  # noqa: E731
            q, k, v, causal, q_off, k_off)
        o, lse = fwd()
        o_ref, lse_ref = fwd_plain()
        # K10 from the same inputs on both sides; dl = delta - dlse
        dl = ((do.float() * o_ref.float()).sum(-1).permute(0, 2, 1)
              - dlse).contiguous()
        bwd = lambda: flash.flash_bwd(q, k, v, do, lse_ref,  # noqa: E731
                                      dl, causal, q_off, k_off)
        bwd_plain = lambda: flash.flash_bwd_plain(  # noqa: E731
            q, k, v, do, lse_ref, dl, causal, q_off, k_off)
        grads, grads_ref = bwd(), bwd_plain()
        torch.cuda.synchronize()
        dname = str(dtype).split(".")[1]
        tol = {"o": FLASH_TOL[("flash_fwd", dname)],
               "dq": FLASH_TOL[("flash_bwd", dname)]}
        tol["dk"] = tol["dv"] = tol["dq"]
        errs = {}  # name: (max abs error, worst row-relative error)
        for name, got, ref in (("o", o, o_ref),
                               *zip(("dq", "dk", "dv"), grads, grads_ref)):
            floor = FLASH_ROW_FLOOR[dname] if name != "o" else 0.0
            errs[name] = (float((got.float() - ref.float()).abs().max()),
                          _row_rel_err(got, ref, floor))
        lse_err = float((lse - lse_ref).abs().max())
        ok = all(rel <= tol[n] for n, (_, rel) in errs.items())
        ok = ok and lse_err <= LSE_ATOL and all(
            bool(torch.isfinite(x.float()).all()) for x in (o, *grads))
        if lse_path:  # the dead rows: o = 0 and lse = -1e30 exactly
            dead = (q_off + torch.arange(t, device=dev)) < k_off
            ok = ok and bool((o[:, dead] == 0).all()) and bool(
                (lse[:, :, dead] == -1e30).all())
        esz = torch.empty((), dtype=dtype).element_size()
        pairs = _visible_pairs(t, tk, causal, q_off, k_off)
        live_q, live_k = _live_rows(t, tk, causal, q_off, k_off)
        kind = "bf16_tensor" if dtype == torch.bfloat16 else "f32"
        bh = b * h
        # K9 reads the live rows of q, k, v and writes every row of o and
        # lse; two products (s, P.V)
        fwd_work = ((live_q + 2 * live_k + t) * b * h * d * esz + 4 * bh * t,
                    4.0 * bh * pairs * d)
        # K10 reads the live rows of q, dO, lse, dl, k and v and writes
        # every row of dq, dk, dv; the least work is five products (s,
        # dO.v, dq, dk, dv)
        bwd_work = ((2 * live_q + 2 * live_k + t + 2 * tk) * b * h * d * esz
                    + 8 * bh * live_q, 10.0 * bh * pairs * d)
        fwd_bound = bound(*fwd_work, kind)
        bwd_bound = bound(*bwd_work, kind)
        row = {"label": label, "dtype": dname, "shape": (b, t, tk, h, d),
               "causal": causal, "offsets": (q_off, k_off),
               "errors": errs, "lse_err": lse_err, "tol": tol, "ok": ok,
               "per_step": per_step, "fwd_bound": fwd_bound,
               "bwd_bound": bwd_bound}
        if per_step or timed:
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                          for x in (q, k, v))
            gt = do.transpose(1, 2).contiguous()
            lib_causal = causal and q_off == k_off
            lib_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=lib_causal)
            with torch.enable_grad():
                lib_out = lib_fwd()
            lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
                lib_out, (qt, kt, vt), gt, retain_graph=True)

            def lib_both():
                with torch.enable_grad():
                    out = lib_fwd()
                    torch.autograd.grad(out, (qt, kt, vt), gt)

            # kernels and library in turns (K, L, L, K over two rounds)
            turns = time_turns({"fwd_ms": fwd, "fwd_library_ms": lib_fwd,
                                "bwd_ms": bwd, "bwd_library_ms": lib_bwd})
            row.update({n: statistics.mean(ts) for n, ts in turns.items()})
            row.update(fwd_plain_ms=time_ms(fwd_plain),
                       bwd_plain_ms=time_ms(bwd_plain),
                       library_fwd_bwd_ms=time_ms(lib_both), turns=turns)
            del lib_out, qt, kt, vt, gt
        rows.append(row)
        err_txt = " ".join(f"{n} {e:.3g}/{rel:.3g}" for n, (e, rel) in
                           errs.items())
        log(f"flash: {dname:8s} {label:38s} (B,T,Tk,H,D)={row['shape']} "
            f"max err/worst row-relative err {err_txt}; lse {lse_err:.3g} "
            f"(row-relative limits K9 {tol['o']:g}, K10 {tol['dq']:g}; "
            f"lse {LSE_ATOL:g}) {'ok' if ok else 'MISMATCH'}")
        if per_step or timed:
            for name, (nbytes, ops) in (("K9", fwd_work), ("K10", bwd_work)):
                log(f"flash: {name} bound: {nbytes / 1e6:.1f} MB in "
                    f"{nbytes / PEAK_BYTES_S * 1e3:.4f} ms at 3.35 TB/s, "
                    f"{ops / 1e9:.1f} GFLOP in "
                    f"{ops / PEAK_OPS_S[kind] * 1e3:.4f} ms at the {kind} "
                    "peak")
            log(f"flash: K9 forward {row['fwd_ms']:.4f} ms (plain "
                f"{row['fwd_plain_ms']:.4f}, sdpa {row['fwd_library_ms']:.4f}"
                f", bound {fwd_bound[0]:.4f} {fwd_bound[1]}); K10 backward "
                f"{row['bwd_ms']:.4f} ms (plain {row['bwd_plain_ms']:.4f}, "
                f"sdpa backward {row['bwd_library_ms']:.4f}, bound "
                f"{bwd_bound[0]:.4f} {bwd_bound[1]}); sdpa forward+backward "
                f"{row['library_fwd_bwd_ms']:.4f} ms")
            # per launch, in turns; TFLOP/s of the least work (K9 two
            # products, K10 five), whatever the kernel itself runs
            for name, pre, ops in (("K9", "fwd", fwd_work[1]),
                                   ("K10", "bwd", bwd_work[1])):
                k_ts, l_ts = row["turns"][f"{pre}_ms"], row["turns"][
                    f"{pre}_library_ms"]
                log(f"flash: {name} per launch, in turns: kernel "
                    f"{' '.join(f'{t:.4f}' for t in k_ts)} ms, sdpa "
                    f"{' '.join(f'{t:.4f}' for t in l_ts)} ms; kernel "
                    f"{ops / row[f'{pre}_ms'] / 1e9:.1f} TFLOP/s, sdpa "
                    f"{ops / row[f'{pre}_library_ms'] / 1e9:.1f} TFLOP/s "
                    f"({ops / 1e9:.1f} GFLOP); kernel / sdpa "
                    f"{row[f'{pre}_ms'] / row[f'{pre}_library_ms']:.2f}x; "
                    f"{per_step} launches {per_step * row[f'{pre}_ms']:.4f}"
                    " ms")
        del q, k, v, do, o, o_ref, grads, grads_ref
        if fused:
            del qkv
    torch.cuda.empty_cache()
    bad = [r["label"] + " " + r["dtype"] for r in rows if not r["ok"]]
    if bad:
        raise SmokeError(f"flash kernel check(s) out of tolerance: {bad}")
    return rows


def _lm_corpus(tmp: str) -> str:
    """The repository's own prose, ``SURVEY.md`` then ``doc/*.md``, in
    one file."""
    path = os.path.join(tmp, "corpus.txt")
    srcs = [os.path.join(REPO, "SURVEY.md")] + sorted(
        os.path.join(REPO, "doc", f) for f in os.listdir(
            os.path.join(REPO, "doc")) if f.endswith(".md"))
    with open(path, "wb") as out:
        for src in srcs:
            with open(src, "rb") as f:
                out.write(f.read())
    return path


def lm_train_phase(tmp: str):
    """``task=train`` on the LM conf through ``LearnTask``: every step
    must launch K9 and K10 once per block and nothing else; returns the
    run's launch counts, its checkpoint directory and conf."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.models import transformer_lm_conf
    from cxxnet_tpu_torch.ops import KERNELS

    corpus = _lm_corpus(tmp)
    conf = os.path.join(tmp, "lm.conf")
    with open(conf, "w") as f:
        f.write(transformer_lm_conf(
            seq_len=LM_T, dim=LM_DIM, nhead=LM_HEADS, nlayer=LM_LAYERS,
            text_file=corpus, batch_size=LM_BATCH, num_round=LM_ROUNDS,
            dev="gpu", compute_dtype="bfloat16"))
    mdir = os.path.join(tmp, "lm_models")
    argv = [conf, "task=train", "dev=gpu", f"model_dir={mdir}",
            f"seed={SEED}", "print_step=0", "silent=1"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the main path: counts at 0 just before, read just after
    _, tr, steps, losses, marks = _run_train_task(argv)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    size = os.path.getsize(corpus)
    windows = len(range(0, size - LM_T, LM_T))
    per_round = -(-windows // LM_BATCH)
    log(f"lm: corpus {size} bytes, {windows} windows of {LM_T + 1} bytes; "
        f"{len(steps)} steps of {LM_BATCH} x {LM_T} tokens in {wall:.1f}s "
        f"(CLI run, data set-up included); peak device memory "
        f"{peak:.2f} GiB")
    log(f"lm: launches {launches}")
    log(f"lm: losses {[round(v, 4) for v in losses]}")
    want = {k.name: 0 for k in KERNELS}
    want.update(flash_fwd=LM_LAYERS, flash_bwd=LM_LAYERS)
    if len(steps) != LM_ROUNDS * per_round:
        raise SmokeError(f"LM task=train ran {len(steps)} steps, not "
                         f"{LM_ROUNDS * per_round}")
    for i, d in enumerate(steps):
        if d != want:
            raise SmokeError(f"LM training step {i} launched {d}, expected "
                             f"{want}")
    if not all(np.isfinite(losses)):
        raise SmokeError(f"non-finite LM training loss: {losses}")
    # the last full batch against the first (a round's last batch may be
    # padded, and padded rows add nothing to the loss)
    last_full = -2 if windows % LM_BATCH else -1
    if not losses[last_full] < losses[0]:
        raise SmokeError(f"the LM's loss did not fall: {losses}")
    _round_rates(marks, LM_BATCH * LM_T, "token")
    saved = sorted(f for f in os.listdir(mdir) if f.endswith(".model"))
    want_files = [f"{r:04d}.model" for r in range(LM_ROUNDS + 1)]
    if saved != want_files:
        raise SmokeError(f"LM checkpoints {saved}, expected {want_files}")
    return launches, mdir, conf, cfgmod.parse_file(conf) + [("dev", "gpu")]


def lm_rate_phase(cfg, mdir: str):
    """``RATE_STEPS`` LM steps on a device-resident batch after
    ``RATE_WARMUP`` warm-up steps, ``eval_train = 0`` (the metric of
    ``bench.py --lm``), CUDA events; the peak memory; one step under the
    profiler, which must launch 4 times each the bf16 (tensor-core) C
    entries of the forward and of the backward (its dQ and dK/dV
    kernels)."""
    import torch

    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import flash

    tr = NetTrainer()
    tr.set_params(cfg + [("eval_train", "0")])
    tr.load_model(os.path.join(mdir, f"{LM_ROUNDS:04d}.model"))
    gen = torch.Generator(device=tr.device).manual_seed(SEED)
    shape = (LM_BATCH, LM_T)
    batch = DataBatch(
        data=torch.randint(0, 256, shape, generator=gen,
                           device=tr.device).float(),
        label=torch.randint(0, 256, shape, generator=gen,
                            device=tr.device).float())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(RATE_WARMUP):
        tr.update(batch)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(RATE_STEPS):
        tr.update(batch)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / RATE_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"lm rate: b{LM_BATCH} T{LM_T} d{LM_DIM} L{LM_LAYERS} bf16 training "
        f"step {ms:.2f} ms, {LM_BATCH * LM_T / ms * 1e3:.0f} tokens/s "
        f"({RATE_STEPS} steps after {RATE_WARMUP} warm-up, CUDA events, "
        f"device-resident batch, eval_train 0); peak device memory "
        f"{peak:.2f} GiB")

    def step():
        tr.update(batch)
        torch.cuda.synchronize()

    kernels = (flash.FWD_KERNEL, flash.BWD_KERNEL)
    before = {k.name: dict(k.by_symbol) for k in kernels}
    prof = _profile(step, f"lm b{LM_BATCH} bf16", "step")
    took = {k.name: _symbol_delta(k, before[k.name]) for k in kernels}
    per_kernel = {n: sum(c for k, c in prof["counts"].items() if n in k)
                  for n in ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                            "flash_dkv_mma_kernel")}
    log(f"lm rate: launches by C entry in the profiled step {took} "
        f"(traced by kernel name {per_kernel})")
    # the wrappers' counts are held to, the trace's beside them: a trace
    # can miss records (one H100 run held 3 of the 4 forward
    # launches); the bf16 C entries launch the tensor-core kernels
    want = {"flash_fwd": {"flash_fwd_bf16": LM_LAYERS},
            "flash_bwd": {"flash_bwd_bf16": LM_LAYERS}}
    if took != want or any(c > LM_LAYERS for c in per_kernel.values()):
        raise SmokeError(f"the profiled LM step ran {took} (traced "
                         f"{per_kernel}), expected {want}")
    prof["step_ms"] = ms
    return prof


def _lm_update_of(cfg, ckpt: str, x, y, dev: str, dtype: str):
    """One LM step from ``ckpt``: per tensor the update and the two Adam
    moments after it, as f64 numpy."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    tr = NetTrainer()
    tr.set_params(cfg + [("dev", dev), ("compute_dtype", dtype),
                         ("batch_size", str(len(x))), ("eval_train", "0")])
    tr.load_model(ckpt)
    w0 = {(k, t): w.detach().cpu().double().numpy().copy()
          for k, tags in tr.params.items() for t, w in tags.items()}
    tr.update_all(x, y)
    out = {}
    for (k, t), w in w0.items():
        st = tr.ustates[k][t]
        out[(k, t)] = tuple(
            a.detach().cpu().double().numpy() for a in
            (tr.params[k][t], st["m1"], st["m2"]))
        out[(k, t)] = (out[(k, t)][0] - w,) + out[(k, t)][1:]
    return out, float(tr.last_loss)


def lm_parity_phase(cfg, mdir: str):
    """One float32 LM step on the card (TF32 off) against the CPU, and
    one bfloat16 step against the float32 one, from the run's first
    checkpoint, ``LM_PARITY_ROWS`` rows (``_lm_parity``)."""
    _lm_parity(cfg, os.path.join(mdir, "0000.model"), "lm parity")


def _lm_parity(cfg, ckpt: str, tag: str, bf16_cfg=None):
    """One float32 LM step from ``ckpt`` on the card (TF32 off) against
    the CPU, and one bfloat16 step against the float32 one, on the card,
    ``LM_PARITY_ROWS`` rows.  With ``bf16_cfg`` (a MoE net's conf with
    ``topk = 0``) the bf16-vs-f32 pair runs that conf and the pair under
    ``cfg`` is logged, not held: top-k routing is discontinuous, so a
    gate that bf16 rounds past its neighbour sends a token to another
    expert, and bf16 against f32 moves whole tokens.  Compared per
    tensor: the Adam moments (linear in the gradient), and the update
    over the elements whose gradient is at least 1e-3 of the tensor's
    largest (Adam's first step ``~ g / (0.032 |g| + 1e-8)`` turns a
    near-zero gradient's rounding into a change of sign).  Returns the
    worst readings."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED + 13)
    x = rng.randint(0, 256, (LM_PARITY_ROWS, LM_T)).astype(np.float32)
    y = rng.randint(0, 256, (LM_PARITY_ROWS, LM_T)).astype(np.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card, loss_card = _lm_update_of(cfg, ckpt, x, y, "gpu", "float32")
    cpu, loss_cpu = _lm_update_of(cfg, ckpt, x, y, "cpu", "float32")
    bf16, loss_bf16 = _lm_update_of(cfg, ckpt, x, y, "gpu", "bfloat16")
    pairs = [(bf16, card)]
    if bf16_cfg is not None:
        pairs.insert(0, tuple(
            _lm_update_of(bf16_cfg, ckpt, x, y, "gpu", dt)[0]
            for dt in ("bfloat16", "float32")))
    log(f"{tag}: {LM_PARITY_ROWS}-row steps in "
        f"{time.perf_counter() - t0:.1f}s; losses f32 card {loss_card:.6f}"
        f" cpu {loss_cpu:.6f} bf16 card {loss_bf16:.6f}")

    def rel(a, b, sel=None):
        d = np.abs(a - b)
        return float((d if sel is None else d[sel]).max() / np.abs(b).max())

    def cos(a, b):
        return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))

    def cosines(b16_run, f32_run):
        out = {}
        for kt, (d_r, m1_r, _) in f32_run.items():
            d_b, m1_b, _ = b16_run[kt]
            sel = np.abs(m1_r) >= 1e-3 * np.abs(m1_r).max()
            out[kt] = min(cos(m1_b, m1_r), cos(d_b[sel], d_r[sel]))
        return out

    f32 = {}
    for kt, (d_cpu, m1_cpu, m2_cpu) in cpu.items():
        d_card, m1_card, m2_card = card[kt]
        sel = np.abs(m1_cpu) >= 1e-3 * np.abs(m1_cpu).max()
        f32[kt] = max(rel(m1_card, m1_cpu), rel(m2_card, m2_cpu),
                      rel(d_card, d_cpu, sel))
    b16 = cosines(*pairs[0])
    shown = [("f32 card vs CPU, worst relative error of m1, m2, resolved "
              "update", f32, True),
             ("bf16 vs f32 card" + (", topk = 0" if bf16_cfg else "")
              + ", worst cosine of m1 and resolved update", b16, False)]
    if bf16_cfg is not None:
        shown.append(("bf16 vs f32 card (not held), worst cosine",
                      cosines(*pairs[1]), False))
    for name, vals, rev in shown:
        worst = sorted(vals.items(), key=lambda kv: kv[1], reverse=rev)[:5]
        log(f"{tag}: {name}: median "
            f"{statistics.median(vals.values()):.4g}; worst 5: "
            + ", ".join(f"{'/'.join(kt)} {v:.4g}" for kt, v in worst))
    bad = [kt for kt, v in f32.items() if not v <= LM_UPDATE_REL]
    bad += [kt for kt, v in b16.items() if not v >= LM_UPDATE_COS]
    if not statistics.median(f32.values()) <= LM_UPDATE_REL_MEDIAN:
        bad.append(("median", "f32 card vs CPU"))
    if not statistics.median(b16.values()) >= LM_UPDATE_COS_MEDIAN:
        bad.append(("median", "bf16 vs f32 cosine"))
    if abs(loss_card - loss_cpu) > 1e-4 * abs(loss_cpu):
        bad.append(("loss", "f32 card vs CPU"))
    if bad:
        raise SmokeError(f"{tag}: LM training parity out of tolerance: "
                         f"{bad[:8]}")
    return {"f32_worst_rel": max(f32.values()),
            "f32_median_rel": statistics.median(f32.values()),
            "bf16_worst_cos": min(b16.values()),
            "bf16_median_cos": statistics.median(b16.values()),
            "loss_f32_card": loss_card, "loss_f32_cpu": loss_cpu}


def lm_generate_phase(conf: str, mdir: str, tmp: str):
    """``task=generate`` from the trained checkpoint through
    ``LearnTask``: the KV-cache path for ``GEN_CACHED`` bytes (no flash
    launch: the decode attention is plain torch) and the windowed path
    for ``GEN_WINDOWED`` bytes (``LM_LAYERS`` K9 launches a byte); then
    the card's probability rows against the CPU's on the same tokens, in
    float32 with TF32 off; returns the windowed run's launch counts."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.cli import LearnTask
    from cxxnet_tpu_torch.nnet import generate as gen
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS

    last = os.path.join(mdir, f"{LM_ROUNDS:04d}.model")
    cwd = os.getcwd()
    runs = {}
    os.chdir(tmp)
    try:
        for name, n, cache in (("cached", GEN_CACHED, 1),
                               ("windowed", GEN_WINDOWED, 0)):
            argv = [conf, "task=generate", f"model_in={last}", "dev=gpu",
                    f"gen_prompt={GEN_PROMPT}", f"gen_len={n}",
                    f"gen_cache={cache}", "silent=1"]
            # each path: counts at 0 just before, read just after
            for k in KERNELS:
                k.reset_counts()
            t0 = time.perf_counter()
            LearnTask().run(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.name: k.launches for k in KERNELS}
            with open("pred.txt", "rb") as f:
                text = f.read()
            runs[name] = launches
            log(f"lm generate: {name} path, {n} bytes in {wall:.2f}s "
                f"(CLI run, model load included): {text[:80]!r}")
            log(f"lm generate: {name} launches {launches}")
            want = {k.name: 0 for k in KERNELS}
            if not cache:
                want["flash_fwd"] = LM_LAYERS * n
            if launches != want:
                raise SmokeError(f"{name} generation launched {launches}, "
                                 f"expected {want}")
            if not text:
                raise SmokeError(f"{name} generation wrote nothing")
    finally:
        os.chdir(cwd)

    # tokens per second of each path, on a loaded trainer (host clock)
    cfg = cfgmod.parse_file(conf)
    tr = NetTrainer()
    tr.set_params(cfg + [("dev", "gpu"), ("silent", "1")])
    tr.load_model(last)
    for name, n, cache in (("cached", GEN_CACHED, True),
                           ("windowed", GEN_WINDOWED, False)):
        gen.generate(tr, GEN_PROMPT, gen_len=4, cache=cache)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.generate(tr, GEN_PROMPT, gen_len=n, cache=cache)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"lm generate: {name} path {n / dt:.1f} bytes/s ({n} bytes, "
            f"bf16, batch 1, host clock)")
    # one step of each path under the profiler: busy share, device time
    dec = gen._decode_twin(tr)
    aux = dec.net.init_aux(1, dec.device)
    prompt = list(GEN_PROMPT.encode())
    for pos, tok in enumerate(prompt):
        gen.decode_step(dec, aux, tok, pos)
    _profile(lambda: gen.decode_step(dec, aux, ord(" "), len(prompt)),
             "lm generate cached", "step")
    _profile(lambda: gen.window_probs(tr, prompt), "lm generate windowed",
             "step")

    # the card's rows against the CPU's, float32, the same tokens
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tokens = list(GEN_PROMPT.encode()) + list(
        gen.generate(tr, GEN_PROMPT, gen_len=GEN_PARITY).encode())
    tokens = tokens[:len(GEN_PROMPT) + GEN_PARITY]
    rows = {}
    for dev in ("gpu", "cpu"):
        t = NetTrainer()
        t.set_params(cfg + [("dev", dev), ("compute_dtype", "float32"),
                            ("silent", "1")])
        t.load_model(last)
        dec = gen._decode_twin(t)
        aux = dec.net.init_aux(1, dec.device)
        cached = np.stack([gen.decode_step(dec, aux, tok, pos)
                           for pos, tok in enumerate(tokens)])
        windowed = np.stack([gen.window_probs(t, tokens[:n])
                             for n in (1, len(tokens))])
        rows[dev] = (cached, windowed)
    err_c = float(np.abs(rows["gpu"][0] - rows["cpu"][0]).max())
    err_w = float(np.abs(rows["gpu"][1] - rows["cpu"][1]).max())
    # the windowed rows at the same positions as the cached ones
    err_cw = float(np.abs(rows["gpu"][1][-1] - rows["gpu"][0][-1]).max())
    log(f"lm generate: f32 card vs CPU probability rows over "
        f"{len(tokens)} tokens: cached path max abs {err_c:.3g}, windowed "
        f"{err_w:.3g} (limit {GEN_PROB_ATOL:g}); card cached vs windowed "
        f"at the last position {err_cw:.3g}")
    if not max(err_c, err_w, err_cw) <= GEN_PROB_ATOL:
        raise SmokeError("generation rows out of tolerance")
    return runs["windowed"]


def lm_head_dim_phase():
    """A small LM at head dim 128 (outside ``flash.HEAD_DIMS``) on the
    card: ``HD_STEPS`` bf16 training steps under ``attn_impl = auto``
    and ``xla``, each through the dense ``mha`` (no K9 or K10 launch,
    counts at 0 just before and read just after), to finite losses; and
    under ``attn_impl = pallas`` the step raises, naming the head dim."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.models import transformer_lm_conf
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS

    def trainer(impl):
        tr = NetTrainer()
        tr.set_params(cfgmod.parse_pairs(transformer_lm_conf(
            seq_len=HD_T, dim=HD_DIM, nhead=HD_HEADS, nlayer=HD_LAYERS,
            batch_size=HD_BATCH, dev="gpu", compute_dtype="bfloat16",
            attn_impl=impl)) + [("seed", str(SEED)), ("silent", "1")])
        tr.init_model()
        return tr

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shape = (HD_BATCH, HD_T)
    batch = DataBatch(
        data=torch.randint(0, 256, shape, generator=gen,
                           device="cuda").float(),
        label=torch.randint(0, 256, shape, generator=gen,
                            device="cuda").float())
    for impl in ("auto", "xla"):
        tr = trainer(impl)
        for k in KERNELS:
            k.reset_counts()
        losses = []
        for _ in range(HD_STEPS):
            tr.update(batch)
            losses.append(float(tr.last_loss))
        launches = {k.name: k.launches for k in KERNELS if k.launches}
        log(f"lm head dim {HD_DIM // HD_HEADS}: attn_impl={impl} "
            f"{HD_STEPS} steps, losses {[round(v, 4) for v in losses]}, "
            f"launches {launches}")
        if launches or not all(np.isfinite(losses)):
            raise SmokeError(f"head dim {HD_DIM // HD_HEADS} under "
                             f"attn_impl={impl}: launches {launches}, "
                             f"losses {losses}")
        del tr
    tr = trainer("pallas")
    try:
        tr.update(batch)
    except NotImplementedError as e:
        if str(HD_DIM // HD_HEADS) not in str(e):
            raise SmokeError(f"attn_impl=pallas raised without the head "
                             f"dim: {e}") from e
        log(f"lm head dim {HD_DIM // HD_HEADS}: attn_impl=pallas raises: "
            f"{e}")
    else:
        raise SmokeError(f"attn_impl=pallas trained at head dim "
                         f"{HD_DIM // HD_HEADS}")


# ----------------------------------------------------------------------
# phases 13-17: ResNet-50 (batch_norm; K1, K2, K6 and K8 at its shapes)


def resnet_kernels(dev, rows):
    """K6 at ResNet-50's four bias-free sibling groups (bf16, b128) and
    K8 over its 161 parameter tensors, each against its plain version
    and timed against its library call (``check_kernel``); K1 and K2 at
    the stem pool are GoogLeNet's (128, 112, 112, 64) k3 s2 pool, held
    and timed there (their rows in ``rows``).  Returns the rows."""
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    tr = NetTrainer()
    tr.set_params(cfgmod.parse_file(RESNET_CONF) + [("dev", "cpu"),
                                                    ("batch_size", "1")])
    tr.init_model()
    net = tr.net
    shapes = net.infer_shapes(BATCH)
    groups, _ = net._sibling_1x1_groups()
    keys = []
    for leader, idxs in groups.items():
        spec = net.graph.layers[leader]
        n, oh, ow, _ = shapes[spec.nindex_out[0]]
        o = sum(net.layer_objs[j].param.num_channel for j in idxs)
        keys.append((n * oh * ow, shapes[spec.nindex_in[0]][3], o, False))
    if sorted(keys) != sorted(RESNET_GROUPS):
        raise SmokeError(f"ResNet-50's sibling groups are {keys}, not "
                         f"{RESNET_GROUPS}")
    tensors = []
    for (key, tag), up in tr.updaters.items():
        pu = up.param
        tensors.append((tuple(tr.params[key][tag].shape),
                        float(pu.learning_rate(0)), float(pu.momentum_at(0)),
                        pu.wd, pu.clip_gradient))
    if len(tensors) != RESNET_TENSORS:
        raise SmokeError(f"ResNet-50 has {len(tensors)} parameter tensors, "
                         f"not {RESNET_TENSORS}")
    gen = torch.Generator().manual_seed(SEED + 50)
    out = [check_kernel("conv_block_gemm", k, torch.bfloat16, dev, gen)
           for k in keys]
    out.append(check_kernel("sgd_update", tuple(tensors), torch.float32, dev,
                            gen))
    for r in out:
        r["per_step"] = 1
        log(f"resnet kernel {r['kernel']:16s} {r['dtype']:8s} "
            f"{r['shape']:34s} abs {r['max_abs_err']:.3g} rel "
            f"{r['max_rel_err']:.3g} (rtol {r['rtol']:g} atol {r['atol']:g})"
            f" {'ok' if r['ok'] else 'MISMATCH'}  ms {r['ms']:.4f} plain "
            f"{r['plain_ms']:.4f} library {r['library_ms']:.4f} bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']})"
            + (f" mma_sync {r['mma_sync_ms']:.4f}" if "mma_sync_ms" in r
               else "")
            + (f" per-tensor loop {r['per_tensor_ms']:.4f}"
               if "per_tensor_ms" in r else ""))
    bad = [r["shape"] for r in out if not r["ok"]]
    if bad:
        raise SmokeError(f"ResNet kernel check(s) out of tolerance: {bad}")
    stem = [r for r in rows if r["kernel"] in ("maxpool_fwd", "maxpool_bwd")
            and r["dtype"] == "bfloat16" and r["shape"] == RESNET_STEM_POOL]
    if len(stem) != 2:
        raise SmokeError(f"GoogLeNet's checks hold no bf16 row of the stem "
                         f"pool {RESNET_STEM_POOL} for K1 and K2")
    log(f"resnet kernel K1, K2 at the stem pool {RESNET_STEM_POOL}: held "
        "and timed in GoogLeNet's checks (the same shape)")
    return out + [dict(r, per_step=1) for r in stem]


def resnet_serve_phase(tmp: str):
    """Serve ResNet-50 from a seeded checkpoint of ``resnet50.conf`` over
    HTTP (1, 7, 32 and 128 rows, each twice: K1 once and K6 four times a
    forward, on their main paths, nothing else), the forward's device
    time by kind per bucket, then the 7-row request's bucket (8) in
    float32 on the card against the CPU and in bf16 against float32;
    the binary wire beside JSON (``drive_wire``).  Returns the launches
    by kernel and the wire's warm latencies."""
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import Engine, make_server

    cfg = cfgmod.parse_file(RESNET_CONF) + [("dev", "gpu"),
                                            ("seed", str(SEED)),
                                            ("silent", "1")]
    side = int(dict(cfg)["input_shape"].split(",")[1])
    t0 = time.perf_counter()
    tr = NetTrainer()
    tr.set_params(cfg)
    tr.init_model()
    path = os.path.join(tmp, "0001.model")
    tr.save_model(path, round_=1)
    del tr
    log(f"resnet serve: init_model + save_model "
        f"{time.perf_counter() - t0:.2f}s")
    eng = Engine(cfg=cfg, model_in=path, max_batch_size=max(REQUEST_ROWS))
    httpd = make_server(eng, port=0)
    th = threading.Thread(target=httpd.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    try:
        port = httpd.server_port
        h = _request(port, "/healthz")
        if h["status"] != "ok" or not h["device"].startswith("cuda"):
            raise SmokeError(f"resnet serve: unhealthy engine: {h}")
        bodies = {n: _rows(n, side, SEED + 100 + n) for n in REQUEST_ROWS}
        answers, launches = _drive_requests(port, bodies, RESNET_PER_FORWARD,
                                            "resnet serve")
        wire_lat = drive_wire(port, eng, bodies, answers, RESNET_PER_FORWARD,
                              "resnet serve", side, gpu_line())
        x8 = bodies[REQUEST_ROWS[1]]
        feats16 = eng.extract(x8, "pool")
        probs16 = answers[x8.shape[0]]
        forward_breakdown(eng.trainer, bodies, RESNET_PER_FORWARD,
                          "ResNet-50")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
        eng.close()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = {}
    for name, dev in (("card", "gpu"), ("cpu", "cpu")):
        with Engine(cfg=cfg + [("compute_dtype", "float32"), ("dev", dev)],
                    model_in=path, max_batch_size=max(REQUEST_ROWS)) as e:
            ref[name] = (e.scores(x8), e.extract(x8, "pool"))
            params = e.trainer.params
    cls = next(v for k, v in params.items() if k.endswith("_fc1000"))
    _hold_served("resnet serve", ref, feats16, probs16, cls, "pool",
                 (RESNET_BF16_FEAT_REL, RESNET_BF16_LOGIT_REL))
    return launches, wire_lat


def resnet_train_phase(tmp: str):
    """``task=train`` on ``resnet50.conf`` through ``LearnTask``: 2
    rounds of its 512 synthetic rows at batch 128, bf16, at the conf's
    own rates, ``scan_steps = 8`` taken as it stands.  Every step must
    launch K1, K2 and K8 once and K6 four times (the routed ones on
    their main paths) and nothing else, and every loss be finite.
    Returns the run's launches, its model directory and conf."""
    import numpy as np

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.ops import KERNELS

    mdir = os.path.join(tmp, "models")
    argv = [RESNET_CONF, "task=train", f"num_round={ROUNDS}",
            f"max_round={ROUNDS}", f"model_dir={mdir}", f"seed={SEED}",
            "print_step=0"]
    t0 = time.perf_counter()
    _, tr, steps, losses, marks = _run_train_task(argv)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    n_tensors = sum(len(tags) for tags in tr.params.values())
    want = {**{k.name: 0 for k in KERNELS}, **RESNET_PER_STEP}
    log(f"resnet train: {len(steps)} steps of {tr.batch_size} rows in "
        f"{wall:.1f}s (CLI run, data set-up and 3 checkpoints included); "
        f"{n_tensors} parameter tensors; device {tr.device}")
    log(f"resnet train: launches {launches}; by C entry "
        + json.dumps({k.name: dict(k.by_symbol) for k in KERNELS
                      if k.name in RESNET_PER_STEP}))
    log(f"resnet train: losses {[round(v, 4) for v in losses]}")
    n_steps = ROUNDS * (RESNET_TRAIN_ROWS // tr.batch_size)
    if len(steps) != n_steps or n_tensors != RESNET_TENSORS:
        raise SmokeError(f"resnet task=train ran {len(steps)} steps over "
                         f"{n_tensors} tensors, not {n_steps} over "
                         f"{RESNET_TENSORS}")
    for i, (d, paths) in enumerate(zip(steps, tr.paths)):
        if d != want or paths != _main_paths(RESNET_PER_STEP):
            raise SmokeError(f"resnet training step {i} launched {d}, by C "
                             f"entry {paths}; expected {want}, "
                             f"{_main_paths(RESNET_PER_STEP)}")
    if not all(np.isfinite(losses)):
        raise SmokeError(f"resnet: non-finite training loss: {losses}")
    _round_rates(marks, tr.batch_size, "img")
    cfg = cfgmod.parse_file(RESNET_CONF) + [("dev", "gpu"), ("silent", "1")]
    return launches, mdir, cfg


def resnet_parity_phase(cfg, mdir: str):
    """From the run's first checkpoint, ``PARITY_ROWS`` rows, under
    ``bn_eval = batch`` and ``running``: one float32 step on the card
    (TF32 off) against the CPU (each tensor's update by cosine, the
    loss, the running statistics), and one bf16 step against the float32
    one (the loss, the classifier's update, the running statistics; the
    other tensors' cosines are logged: from ResNet-50's random init a
    bf16 step's updates are not the float32 step's in the JAX package
    either, see ``RESNET_*`` above)."""
    import numpy as np
    import torch

    ckpt = os.path.join(mdir, "0000.model")
    side = int(dict(cfg)["input_shape"].split(",")[1])
    rng = np.random.RandomState(SEED + 12)
    x = rng.randn(PARITY_ROWS, side, side, 3).astype(np.float32)
    y = rng.randint(0, 1000, (PARITY_ROWS, 1)).astype(np.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def cosines(a, b):
        return {kt: float((d * a[kt]).sum() / (np.linalg.norm(d)
                                               * np.linalg.norm(a[kt])))
                for kt, d in b.items()}

    def rels(a, b):
        return {kt: float(np.abs(a[kt] - d).max() / np.abs(d).max())
                for kt, d in b.items()}

    bad = []
    for mode in ("batch", "running"):
        mcfg = cfg + [("bn_eval", mode)]
        t0 = time.perf_counter()
        d_card, z_card, a_card, l_card = _update_of(mcfg, ckpt, x, y, "gpu",
                                                    "float32")
        d_cpu, z_cpu, a_cpu, l_cpu = _update_of(mcfg, ckpt, x, y, "cpu",
                                                "float32")
        d_bf16, _, a_bf16, l_bf16 = _update_of(mcfg, ckpt, x, y, "gpu",
                                               "bfloat16")
        tag = f"resnet parity bn_eval={mode}:"
        flips = sum(int((a != b).sum()) for a, b in zip(z_card, z_cpu)
                    if a is not None)
        log(f"{tag} {PARITY_ROWS}-row steps in "
            f"{time.perf_counter() - t0:.1f}s; losses f32 card {l_card!r}, "
            f"CPU {l_cpu!r}, bf16 card {l_bf16!r}; {flips} activations "
            "exactly zero on one side only (f32 card vs CPU)")
        cls = [kt for kt in d_cpu if kt[0].endswith("_fc1000")]
        cos16 = cosines(d_bf16, d_card)
        checks = [  # (name, values, lower is better, limit, median limit)
            ("f32 card vs CPU update cosine", cosines(d_card, d_cpu),
             False, RESNET_F32_COS, RESNET_F32_COS_MEDIAN),
            ("f32 card vs CPU update rel (logged)", rels(d_card, d_cpu),
             True, None, None),
            ("f32 card vs CPU loss rel",
             {("loss",): abs(l_card - l_cpu) / abs(l_cpu)}, True,
             RESNET_F32_LOSS_REL, None),
            ("aux f32 card vs CPU rel", rels(a_card, a_cpu), True,
             RESNET_AUX_REL, None),
            ("bf16 vs f32 loss rel",
             {("loss",): abs(l_bf16 - l_card) / abs(l_card)}, True,
             RESNET_BF16_LOSS_REL, None),
            ("bf16 vs f32 classifier update cosine",
             {kt: cos16[kt] for kt in cls}, False, RESNET_BF16_CLS_COS,
             None),
            ("bf16 vs f32 update cosine (logged)", cos16, False, None,
             None),
            ("aux bf16 vs f32 rel", rels(a_bf16, a_card), True,
             RESNET_AUX_BF16_REL, None),
        ]
        for name, vals, lower, lim, lim_med in checks:
            if not vals:
                continue
            worst = sorted(vals.items(), key=lambda kv: kv[1],
                           reverse=lower)[:5]
            med = statistics.median(vals.values())
            log(f"{tag} {name}: worst {worst[0][1]:.5g}"
                + (f" (limit {lim:g})" if lim is not None else "")
                + f", median {med:.5g}"
                + (f" (limit {lim_med:g})" if lim_med is not None else "")
                + "; worst 5: " + ", ".join(f"{'/'.join(kt)} {v:.4g}"
                                           for kt, v in worst))
            if lim is None:
                continue
            over = [kt for kt, v in vals.items()
                    if not (v <= lim if lower else v >= lim)]
            if lim_med is not None and not (med <= lim_med if lower
                                            else med >= lim_med):
                over.append(("median",))
            bad += [(mode, name) + tuple(kt) for kt in over]
        if (mode == "running") != bool(a_cpu):
            bad.append((mode, "running statistics present"))
    if bad:
        raise SmokeError(f"resnet training parity out of tolerance: "
                         f"{bad[:8]}")


def resnet_updater_phase(dev):
    """One step of each of ``nag``, ``rmsprop``, ``adagrad``, ``lars``
    and ``lamb`` over ResNet-50's 161 tensors (the conf's updater keys,
    seeded weights and gradients), on the card against the CPU; the
    card's step time (CUDA events)."""
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.updater import apply_all

    base = cfgmod.parse_file(RESNET_CONF) + [("batch_size", "1")]
    bad = []
    for name in RESNET_UPDATERS:
        trs = {}
        for where, dev_key in (("card", "gpu"), ("cpu", "cpu")):
            tr = NetTrainer()
            tr.set_params(base + [("updater", name), ("dev", dev_key)])
            tr.init_model()
            trs[where] = tr
        gen = torch.Generator().manual_seed(SEED + 60)
        grads = {kt: torch.randn(tuple(trs["cpu"].params[kt[0]][kt[1]].shape),
                                 generator=gen) * 1e-2
                 for kt in trs["cpu"].updaters}
        for tr in trs.values():
            items = [(up, tr.params[k][t], grads[(k, t)].to(tr.device),
                      tr.ustates[k][t]) for (k, t), up in tr.updaters.items()]
            apply_all(items, 0)
        card, cpu = trs["card"], trs["cpu"]
        worst = 0.0
        for (k, t) in cpu.updaters:
            pairs = [(card.params[k][t], cpu.params[k][t])]
            pairs += [(card.ustates[k][t][sl], s)
                      for sl, s in cpu.ustates[k][t].items()]
            for a, b in pairs:
                scale = float(b.abs().max()) or 1.0
                worst = max(worst, float((a.cpu() - b).abs().max()) / scale)
        items = [(up, card.params[k][t], grads[(k, t)].to(dev),
                  card.ustates[k][t]) for (k, t), up in card.updaters.items()]
        ms = time_ms(lambda: apply_all(items, 1), reps=3, inner=1)
        log(f"resnet updater {name}: {len(items)} tensors, card vs CPU "
            f"worst error {worst:.3g} of the tensor's largest (limit "
            f"{RESNET_UPDATER_REL:g}); a step on the card {ms:.3f} ms "
            "(CUDA events, host included)")
        if not worst <= RESNET_UPDATER_REL:
            bad.append(name)
        del trs, card, cpu, items
    if bad:
        raise SmokeError(f"updaters out of tolerance on the card: {bad}")


# ----------------------------------------------------------------------
# hot reload: ResNet-50 at full width behind the poll thread


def _wire_scores(conn, rows, node: str = ""):
    """One ``CXB1`` frame of ``rows`` on a kept-alive connection, scores
    (``/predict``) or with ``node`` that node's features (``/extract``):
    the reply's rows (any failure raises)."""
    from cxxnet_tpu_torch.serve import wire

    frame = (wire.encode_request(rows, kind="extract", node=node) if node
             else wire.encode_request(rows, kind="scores"))
    st, data = _post_on(conn, "/extract" if node else "/predict",
                        bytes(frame), wire.CONTENT_TYPE)
    if st != 200:
        raise SmokeError(f"reload: a {rows.shape[0]}-row frame got {st}: "
                         f"{data[:200]!r}")
    return wire.decode_response(data)[2]


def _wait(cond, what: str, timeout: float = 120.0, poll: float = 0.02):
    """Poll ``cond()`` until it holds; raise after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise SmokeError(f"reload: timed out waiting for {what}")
        time.sleep(poll)


def _swapped(eng, n: int):
    """Wait until ``eng``'s poll thread has completed its ``n``-th swap
    (the old model released, the canary rebased)."""
    _wait(lambda: eng.snapshot_stats()["reload_swaps"] >= n,
          f"swap {n} to complete")
    if eng.snapshot_stats()["reload_swaps"] != n:
        raise SmokeError(f"reload: more than {n} swaps")


class _Traffic:
    """A client thread sending ``CXB1`` frames of each of ``bodies`` in
    turn (``RELOAD_NODE``'s features) on its own kept-alive connection
    until stopped: each request's start, latency, bucket and answer, and
    every failure."""

    def __init__(self, port: int, bodies):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=600)
        self.bodies = bodies
        self.log, self.errors = [], []
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            for n, x in self.bodies.items():
                t0 = time.perf_counter()
                try:
                    out = _wire_scores(self.conn, x, RELOAD_NODE)
                except Exception as e:  # noqa: BLE001 - counted, reported
                    self.errors.append(f"{type(e).__name__}: {e}")
                    return
                self.log.append((t0, (time.perf_counter() - t0) * 1e3, n,
                                 out))

    def __enter__(self):
        self._th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join(timeout=600)
        self.conn.close()
        if self._th.is_alive():
            raise SmokeError("reload: the traffic thread did not stop")


def _publish(task, tr, round_: int, steps: int, gen):
    """``steps`` b128 training steps of ``tr`` on fresh device-resident
    N(0, 1) batches, then ``round_`` written through the CLI's own
    ``_save_model`` (its manifest carrying the canary's probe block)."""
    import torch

    from cxxnet_tpu_torch.io import DataBatch

    shape = tr.net.input_node_shape(tr.batch_size)
    for _ in range(steps):
        tr.update(DataBatch(
            data=torch.randn(shape, generator=gen, device=tr.device),
            label=torch.randint(0, 1000, (shape[0], 1), generator=gen,
                                device=tr.device).float()))
    task.net_trainer, task.start_counter = tr, round_
    if not task._save_model():
        raise SmokeError(f"reload: round {round_} was not written")
    return os.path.join(task.name_model_dir, f"{round_:04d}.model")


def _serving(eng, period: float):
    """``serve_forever(eng, reload_period_s=period)`` on a thread:
    ``(httpd, thread, box)``; ``box["ret"]`` holds its return value."""
    from cxxnet_tpu_torch.serve import serve_forever

    box = {}
    th = threading.Thread(target=lambda: box.update(ret=serve_forever(
        eng, port=0, reload_period_s=period, drain_timeout_s=10.0,
        ready_fn=lambda h: box.update(httpd=h))), daemon=True)
    th.start()
    _wait(lambda: "httpd" in box, "the server to bind", 60)
    return box["httpd"], th, box


def _stop_serving(httpd, th, box, eng):
    """Shut the server of ``_serving`` down, its poll thread with it."""
    httpd.shutdown()
    th.join(timeout=120)
    eng.close()
    reloader = box.get("ret", (None, None))[1]
    if th.is_alive() or (reloader is not None and reloader.is_alive()):
        raise SmokeError("reload: the server or its poll thread did not stop")


def reload_phase(tmp: str, card: str):
    """Hot reload of ResNet-50 (``resnet50.conf`` with ``bn_eval =
    running`` and ``integrity_probe = 1``) behind ``serve_forever``'s
    poll thread: the swap under traffic, warm and memory, the breaker,
    the canary, the same-round int8 sibling swap and K7 at ResNet-50's
    int8 shapes.  Returns the ``reload`` line's numbers and K7's rows.
    A ``serve: warmup failed`` line fails the phase."""
    import torch

    # the canary holds a forward to its bits: fix the math before the
    # golden is recorded and leave it alone until the phase ends
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with _Tee("stdout") as tee:
            out = _reload_phase(tmp, card)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    printed = "".join(tee.text)
    if "serve: warmup failed" in printed:
        raise SmokeError("reload: a warmup failed (the serve: warmup failed "
                         "line above)")
    return out


def _reload_phase(tmp: str, card: str):
    """The body of ``reload_phase``, under its math settings."""
    import gc
    import http.client

    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.cli import LearnTask
    from cxxnet_tpu_torch.nnet.quant import quant_artifact_path
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.ops.kernels import int8_gemm
    from cxxnet_tpu_torch.serve import Engine
    from cxxnet_tpu_torch.utils import checkpoint as ckpt

    cfg = cfgmod.parse_file(RESNET_CONF) + [
        ("bn_eval", "running"), ("integrity_probe", "1"), ("dev", "gpu"),
        ("seed", str(SEED)), ("silent", "1")]
    side = int(dict(cfg)["input_shape"].split(",")[1])
    mdir = os.path.join(tmp, "models")
    tr = NetTrainer()
    tr.set_params(cfg)
    tr.init_model()
    gen = torch.Generator(device=tr.device).manual_seed(SEED + 300)
    task = LearnTask()
    task.integrity_probe, task.name_model_dir, task.silent = 1, mdir, 1
    _publish(task, tr, 1, 1, gen)
    man = ckpt.read_manifest(os.path.join(mdir, "0001.model"))
    log(f"reload: round 1 written with the probe block {man['probe']}")

    eng = Engine(cfg=cfg, model_dir=mdir, max_batch_size=RESNET_BATCH,
                 silent=False, reload_breaker_threshold=2,
                 reload_breaker_cooldown_s=3600.0)
    httpd, th, box = _serving(eng, RELOAD_PERIOD_S)
    out = {"card": card}
    try:
        port = httpd.server_port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        bodies = {b: _rows(n, side, SEED + 400 + n)
                  for b, n in RELOAD_BUCKETS.items()}
        big = max(bodies)

        def answers():
            return {b: _wire_scores(conn, x, RELOAD_NODE)
                    for b, x in bodies.items()}

        ans1 = answers()  # the warm-up of buckets 1, 32 and 128
        ans1 = answers()
        # traffic through the swap: round 2 lands while 1- and 32-row
        # frames keep coming
        traffic = {b: bodies[b] for b in RELOAD_TRAFFIC}
        with _Traffic(port, traffic) as cl:
            time.sleep(RELOAD_STEADY_S)
            t_pub = time.perf_counter()
            _publish(task, tr, 2, 2, gen)
            _wait(lambda: eng.round == 2, "round 2 to swap in")
            t_swap = time.perf_counter()
            _swapped(eng, 1)
            time.sleep(RELOAD_STEADY_S)
        if cl.errors:
            raise SmokeError(f"reload: requests failed through the swap: "
                             f"{cl.errors}")
        ans2 = answers()
        if not all(np.isfinite(a).all() for a in (*ans1.values(),
                                                   *ans2.values())):
            raise SmokeError("reload: rounds 1 and 2 answer non-finite scores")
        olds = news = 0
        for _, _, b, got in cl.log:
            if np.array_equal(got, ans1[b]):
                olds += 1
            elif np.array_equal(got, ans2[b]):
                news += 1
            else:
                raise SmokeError(
                    f"reload: a {b}-bucket answer through the swap is neither"
                    f" round 1's nor round 2's (max abs difference "
                    f"{float(np.abs(got - ans1[b]).max()):.3g} and "
                    f"{float(np.abs(got - ans2[b]).max()):.3g})")
        steady = [ms for t0, ms, _, _ in cl.log if t0 < t_pub]
        window = [ms for t0, ms, _, _ in cl.log
                  if t_pub <= t0 <= t_swap + RELOAD_PERIOD_S]
        out.update(reload_s=eng.last_reload_s, requests=len(cl.log),
                   answers_round1=olds, answers_round2=news,
                   steady_p50_ms=statistics.median(steady),
                   swap_max_ms=max(window) if window else None,
                   publish_to_swap_s=t_swap - t_pub)
        log(f"reload: round 2 swapped in {t_swap - t_pub:.3f}s after its "
            f"write (load and warm {eng.last_reload_s:.3f}s); "
            f"{len(cl.log)} requests through it, none failed, {olds} "
            f"answered by round 1 and {news} by round 2, bit-equal; steady "
            f"p50 {out['steady_p50_ms']:.2f} ms, slowest in the swap window "
            f"{out['swap_max_ms']} ms ({card})")
        if not (olds and news):
            raise SmokeError("reload: the traffic did not straddle the swap")
        with Engine(cfg=cfg, model_in=os.path.join(mdir, "0002.model"),
                    max_batch_size=RESNET_BATCH) as fresh:
            for b, x in bodies.items():
                if not np.array_equal(fresh.extract(x, RELOAD_NODE), ans2[b]):
                    raise SmokeError(f"reload: bucket {b} after the swap is "
                                     "not bit-equal to Engine(model_in="
                                     "0002.model)")
        log("reload: buckets 1, 32 and 128 after the swap bit-equal to a "
            "fresh Engine(model_in=0002.model)")
        cc = eng.snapshot_stats()["compile_cache"]
        answers()
        cc2 = eng.snapshot_stats()["compile_cache"]
        log(f"reload: the cache after the swap {cc}, after one request a "
            f"bucket {cc2}")
        if cc2["misses"] != cc["misses"]:
            raise SmokeError("reload: a warmed bucket missed after the swap")

        # memory: three more reloads, each releasing its predecessor; read
        # under the engine's reload lock, so that no canary forward on the
        # poll thread (its activations, cuDNN's workspace) is in flight
        def resident():
            with eng._reload_lock:
                gc.collect()
                torch.cuda.synchronize()
                return torch.cuda.memory_allocated()

        model_bytes = eng.snapshot_stats()["model"]["weight_bytes"]
        mem = [resident()]
        for r in (3, 4, 5):
            _publish(task, tr, r, 1, gen)
            _swapped(eng, r - 1)
            mem.append(resident())
        out.update(memory_bytes=mem, model_bytes=model_bytes)
        log(f"reload: torch.cuda.memory_allocated after rounds 2-5 {mem} "
            f"(one model's weights {model_bytes} bytes)")
        if max(abs(m - mem[0]) for m in mem) > model_bytes:
            raise SmokeError("reload: device memory grew by more than one "
                             "model over three reloads")
        st = eng.snapshot_stats()
        if not (st["last_reload_ok"] is True and st["reload_swaps"] == 4):
            raise SmokeError(f"reload: /statsz after the good rounds "
                             f"{ {k: st[k] for k in ('reload_attempts', 'reload_failures', 'reload_swaps', 'last_reload_ok')} }")

        # the breaker: a CRC-valid garbage round fails two polls
        ans5 = answers()
        if not all(np.isfinite(a).all() for a in ans5.values()):
            raise SmokeError("reload: round 5 answers non-finite features")
        ckpt.write_checkpoint(os.path.join(mdir, "0006.model"),
                              b"not a model" * 4096, round_=6)
        _wait(lambda: eng.reload_breaker.state == "open",
              "the breaker to open")
        h = _request(port, "/healthz")
        st = _request(port, "/statsz")
        log(f"reload: garbage round 6: healthz {h['status']} "
            f"{h['reasons']}, breaker {st['reload_breaker']}, "
            f"reload_failures {st['reload_failures']}")
        if (h["status"] != "degraded" or h["reasons"] != [
                "reload_breaker_open"] or h["round"] != 5
                or st["reload_failures"] != 2):
            raise SmokeError(f"reload: the breaker did not open as "
                             f"expected: {h}")
        diff = {b: float(np.abs(a - ans5[b]).max())
                for b, a in answers().items()}
        if any(diff.values()):
            raise SmokeError(f"reload: round 5 changed its answers while the "
                             f"breaker was open (max abs difference by "
                             f"bucket {diff})")
        _publish(task, tr, 7, 1, gen)
        eng.reload_breaker.cooldown_s = 0.0
        _swapped(eng, 5)
        h = _request(port, "/healthz")
        st = _request(port, "/statsz")
        z = json.loads(_post_on(conn, "/reloadz", b"", "application/json")[1])
        log(f"reload: round 7 through the half-open trial: healthz "
            f"{h['status']} {h['reasons']}, last_reload_ok "
            f"{st['last_reload_ok']}; POST /reloadz {z}")
        if (h["status"] != "ok" or h["reasons"] or st["last_reload_ok"]
                is not True or z["swapped"] or z["round"] != 7
                or z["breaker"] != "closed"):
            raise SmokeError("reload: no recovery through the half-open trial")

        # the canary under traffic
        with _Traffic(port, traffic) as cl:
            clean = [eng.check_canary() for _ in range(CANARY_RUNS)]
        integ = eng.snapshot_stats()["integrity"]
        if cl.errors or not all(clean) or integ["failed"]:
            raise SmokeError(f"reload: canary under traffic {clean}, "
                             f"{integ}, errors {cl.errors}")
        # the poll thread runs the canary too: hold the reload lock so it
        # cannot take the injected fault or clear the latch in between
        with eng._reload_lock:
            eng.inject_canary_mismatch = 1
            tripped = eng.check_canary()
            h_bad = _request(port, "/healthz")
        cleared = eng.check_canary()
        h_ok = _request(port, "/healthz")
        out.update(canary_src=integ["golden_src"], canary_runs=integ["runs"])
        log(f"reload: canary {CANARY_RUNS} runs under {len(cl.log)} "
            f"requests, all clean; golden {integ['golden_crc32']:#010x} "
            f"src {integ['golden_src']}; injected drift -> {h_bad['status']}"
            f" {h_bad['reasons']}; next run clean -> {h_ok['status']}")
        if (tripped or h_bad["reasons"] != ["integrity_failed"]
                or h_bad["status"] != "degraded" or not cleared
                or h_ok["status"] != "ok"):
            raise SmokeError("reload: the canary's drift did not degrade and "
                             "clear /healthz")
        f32_big = eng.scores(bodies[big])
        conn.close()
    finally:
        _stop_serving(httpd, th, box, eng)

    # the same-round int8 sibling swap
    path7 = os.path.join(mdir, "0007.model")
    qeng = Engine(cfg=cfg + [("quant", "int8")], model_dir=mdir,
                  max_batch_size=RESNET_BATCH, silent=False)
    httpd, th, box = _serving(qeng, RELOAD_PERIOD_S)
    try:
        if (qeng.model_path, qeng.quant_scheme) != (path7, "int8"):
            raise SmokeError(f"reload: the int8 engine serves "
                             f"{qeng.model_path} {qeng.quant_scheme}")
        port = httpd.server_port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        _wire_scores(conn, bodies[big])  # the largest bucket, quantized
        verdict = _export_quant(RESNET_CONF, path7, "bn_eval=running")
        if not verdict["ok"]:
            log("reload: the gate rejected (random weights); exporting "
                "ungated (quant_min_agreement=0)")
            verdict = _export_quant(RESNET_CONF, path7, "bn_eval=running",
                                    "quant_min_agreement=0")
        qpath = quant_artifact_path(path7)
        _wait(lambda: qeng.model_path == qpath, "the int8 sibling to swap in")
        if qeng.round != 7:
            raise SmokeError(f"reload: the sibling swap moved the round to "
                             f"{qeng.round}")
        probe = NetTrainer()
        probe.set_params(cfg + [("dev", "cpu"), ("batch_size", "1")])
        probe.init_model()
        calls = int8_calls(probe, RESNET_INT8_LAYERS, "ResNet-50")
        del probe
        demoted = [k for k in verdict["fallbacks"] if k in calls]
        want = sorted(mko for k, mko in calls.items() if k not in demoted)
        per = {**RESNET_PER_FORWARD, "int8_gemm": len(want)}
        seen = []
        rescale = int8_gemm.int8_gemm_rescale

        def named(x, q, *a, **k):
            seen.append((x.shape[0], x.shape[1], q.shape[0]))
            return rescale(x, q, *a, **k)

        # the main path: counts at 0 just before, read just after
        int8_gemm.int8_gemm_rescale = named
        try:
            for k in KERNELS:
                k.reset_counts()
            paths0 = _by_symbol()
            q_big = _wire_scores(conn, bodies[big])
            launches = {k.name: k.launches for k in KERNELS}
            paths = _paths_since(paths0)
        finally:
            int8_gemm.int8_gemm_rescale = rescale
        log(f"reload: int8 b{big} forward after the sibling swap: launches "
            f"{launches}; by C entry {paths}; K7 by shape (M, K, O) "
            f"{sorted(seen)}")
        if (launches != {**{k.name: 0 for k in KERNELS}, **per}
                or paths != _main_paths(per) or sorted(seen) != want):
            raise SmokeError(f"reload: the int8 forward launched {launches} "
                             f"{paths}, K7 at {sorted(seen)}; expected "
                             f"{per}, K7 at {want}")
        agree = float((q_big.argmax(1) == f32_big.argmax(1)).mean())
        st = _request(port, "/statsz")["model"]
        ratio = st["weight_bytes_f32"] / st["weight_bytes"]
        out.update(int8_top1_agreement=agree, int8_bytes_ratio=ratio,
                   int8_k7_launches=len(seen), int8_gated=verdict["ok"])
        log(f"reload: int8 sibling of round 7 ({verdict['int8_layers']} int8"
            f" + {verdict['bf16_layers']} bf16 layers): top-1 agreement with "
            f"the f32 engine at b{big} {agree:.4f}; weight bytes at rest "
            f"{st['weight_bytes']} of {st['weight_bytes_f32']} f32, ratio "
            f"{ratio:.3f}; /statsz last_reload_ok "
            f"{_request(port, '/statsz')['last_reload_ok']}")
        if not (ratio >= QUANT_MIN_RATIO and np.isfinite(q_big).all()
                and q_big.shape == (RELOAD_BUCKETS[big], 1000)):
            raise SmokeError(f"reload: int8 bytes ratio {ratio:.3f} or "
                             "answers out of shape")
        if verdict["ok"] and agree < RESNET_INT8_MIN_AGREE:
            raise SmokeError(f"reload: a gated int8 model agrees {agree} with "
                             f"the f32 one, under {RESNET_INT8_MIN_AGREE}")
        conn.close()
    finally:
        _stop_serving(httpd, th, box, qeng)

    # K7 at ResNet-50's int8 shapes, each distinct shape once
    distinct = {}
    for key, mko in calls.items():
        distinct.setdefault(mko, key)
    rows = check_int8({key: mko for mko, key in distinct.items()},
                      torch.device("cuda:0"), ragged=False)
    k7 = []
    for r in rows:
        if r["dtype"] != "bfloat16":
            continue
        m, k, o = (int(v[1:]) for v in r["shape"].split())
        n = sum(1 for mko in want if mko == (m, k, o))
        k7.append({"shape": r["shape"], "layers": n,
                   "launches_per_forward": n, "ms": r["ms"],
                   "library_ms": r["library_ms"], "plain_ms": r["plain_ms"],
                   "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                   "max_abs_err": r["max_abs_err"],
                   "mma_sync_ms": r["mma_sync_ms"], "splits": r["splits"]})
    out["k7_forward_ms"] = sum(r["ms"] * r["layers"] for r in k7)
    out["k7_library_ms"] = sum(r["library_ms"] * r["layers"] for r in k7)
    out["k7_bound_ms"] = sum(r["bound_ms"] * r["layers"] for r in k7)
    log(f"reload: K7 over one int8 b{BATCH} forward's {len(want)} launches "
        f"{out['k7_forward_ms']:.4f} ms (F.linear {out['k7_library_ms']:.4f}"
        f", bound {out['k7_bound_ms']:.4f}) ({card})")
    return out, k7


# ----------------------------------------------------------------------
# MNIST: MNIST_CONV.conf at full width, its tasks, digits to accuracy


def _mnist_digits(n: int, seed: int):
    """``n`` seeded 28x28 uint8 images drawn around ten class templates
    (a learnable stand-in for the absent MNIST files) and their labels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    templates = np.random.RandomState(SEED + 99).randint(0, 256,
                                                         (10, 28, 28))
    labels = rng.randint(0, 10, n)
    noise = rng.randint(-60, 61, (n, 28, 28))
    return (np.clip(templates[labels] + noise, 0, 255).astype(np.uint8),
            labels)


def _f32_paths(per):
    """The launches by C entry of the routed kernels that ``per``
    (launches by kernel of one f32 step or forward) must make: all on
    the f32 vector entries."""
    return {k.name: ({f"{k.name}_f32": per[k.name]} if per.get(k.name)
                     else {}) for k, _ in _routed()}


def _hold_steps(tag, steps, paths, per, pattern=None):
    """Every step of a recorded run launched ``per`` (the SGD kernel by
    ``pattern[i % len(pattern)]`` where given) on the f32 entries."""
    from cxxnet_tpu_torch.ops import KERNELS

    want = {**{k.name: 0 for k in KERNELS}, **per}
    for i, (d, p) in enumerate(zip(steps, paths)):
        w = dict(want)
        if pattern is not None:
            w["sgd_update"] = pattern[i % len(pattern)]
        if d != w or p != _f32_paths(per):
            raise SmokeError(f"{tag}: step {i} launched {d}, by C entry {p};"
                             f" expected {w}, {_f32_paths(per)}")


def _counted(run):
    """``run()`` with every count at 0 just before; returns its result
    and the launches by kernel and by C entry just after."""
    from cxxnet_tpu_torch.ops import KERNELS

    for k in KERNELS:
        k.reset_counts()
    out = run()
    return out, ({k.name: k.launches for k in KERNELS if k.launches},
                 {k.name: dict(k.by_symbol) for k in KERNELS if k.launches})


def _sgd_tensors(conf: str):
    """The SGD kernel's tensors of a conf's net at step 0: ``(shape, lr,
    momentum, wd, clip)`` each, as ``step_calls`` reads them."""
    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    tr = NetTrainer()
    tr.set_params(cfgmod.parse_file(conf) + [("dev", "cpu")])
    tr.init_model()
    return tuple((tuple(tr.params[key][tag].shape),
                  float(up.param.learning_rate(0)),
                  float(up.param.momentum_at(0)), up.param.wd,
                  up.param.clip_gradient)
                 for (key, tag), up in tr.updaters.items())


def mnist_kernels(dev):
    """K1 and K2 at the MNIST nets' pools (``MNIST_POOLS``), float32 and
    bfloat16, on their vector entries and bit-equal to their plain
    versions, and K8 over MNIST_CONV's 6 and digits_conv's 8 tensors in
    one launch each (``check_kernel``: device times against the plain
    version and the library call, the calls' times beside, and the
    bound; ``_held``).  Returns the rows."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 70)
    rows = []
    for key in MNIST_POOLS:
        for kernel in ("maxpool_fwd", "maxpool_bwd"):
            for dtype in (torch.float32, torch.bfloat16):
                # bf16 takes device times from _edge_turns
                rows.append(check_kernel(
                    kernel, key, dtype, dev, gen,
                    device_times=dtype == torch.float32))
    for conf, n in ((MNIST_CONF, MNIST_TENSORS), (DIGITS_CONF, DIGITS_TENSORS)):
        tensors = _sgd_tensors(conf)
        if len(tensors) != n:
            raise SmokeError(f"{os.path.basename(conf)} has {len(tensors)} "
                             f"parameter tensors, not {n}")
        rows.append(check_kernel("sgd_update", tensors, torch.float32, dev,
                                 gen))
        rows[-1]["conf"] = os.path.basename(conf)
    return _held("MNIST", rows)


def _held(tag: str, rows):
    """Log ``check_kernel``'s rows and fail if one is out of tolerance;
    returns the rows."""
    for r in rows:
        log(f"{tag} kernel {r['kernel']:16s} {r['dtype']:8s} "
            f"{r['shape']:34s} abs {r['max_abs_err']:.3g} "
            f"{'ok' if r['ok'] else 'MISMATCH'}  ms {r['ms']:.4f} plain "
            f"{r['plain_ms']:.4f} library {r['library_ms']:.4f} bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}); device time"
            + (f", calls {r['call_ms']:.4f} / library "
               f"{r['library_call_ms']:.4f}" if "call_ms" in r else "")
            + (f" edge {r['edge_ms']:.4f}" if "edge_ms" in r else ""))
    bad = [f"{r['kernel']} {r['dtype']} {r['shape']}" for r in rows
           if not r["ok"]]
    if bad:
        raise SmokeError(f"{tag} kernel check(s) out of tolerance: {bad}")
    return rows


def bowl_kernels(dev):
    """K1 at bowl.conf's three pools (``BOWL_POOLS``), float32 as its
    ``pred_raw`` forward runs them, and K2 there as phase 22c's training
    steps run it: on the f32 vector entries, bit-equal to the plain
    versions, device times against the plain versions and
    ``F.max_pool2d`` (aten's backward), the calls' times beside, and the
    bound."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 71)
    return _held("bowl", [
        check_kernel(kernel, key, torch.float32, dev, gen,
                     device_times=True)
        for kernel in ("maxpool_fwd", "maxpool_bwd") for key in BOWL_POOLS])


_PRED_SECTION = """
pred = {out}
iter = mnist
  path_img = ./data/t10k-images-idx3-ubyte
  path_label = ./data/t10k-labels-idx1-ubyte
  input_flat = 0
iter = end
"""


class _Tee:
    """``sys.stderr`` (the CLI's evaluation lines) or ``sys.stdout`` (the
    engine's and the CLI's printed lines) and a copy of what is written
    to it."""

    def __init__(self, stream: str = "stderr"):
        self.text = []
        self._name = stream
        self._orig = getattr(sys, stream)

    def write(self, s):
        self.text.append(s)
        return self._orig.write(s)

    def flush(self):
        self._orig.flush()

    def __enter__(self):
        setattr(sys, self._name, self)
        return self

    def __exit__(self, *exc):
        setattr(sys, self._name, self._orig)


def _eval_errors(text: str):
    """``[(round, test-error)]`` from the CLI's ``[N]\t...`` lines."""
    out = []
    for line in text.splitlines():
        if line.startswith("[") and "test-error:" in line:
            out.append((int(line[1:line.index("]")]),
                        float(line.split("test-error:")[1].split()[0])))
    return out


def mnist_phase(tmp: str, card: str):
    """``MNIST_CONV.conf`` as it stands through ``LearnTask`` on seeded
    idx files, in ``tmp``: ``task=train`` 2 rounds (every step K1, K2
    and K8 once, on the f32 vector entries), then from the round-2 model
    ``pred``, ``pred_raw``, ``extract`` (node ``MNIST_FEATURE_NODE``,
    fc1), ``summary`` (each forward K1 once, nothing else) and a
    ``finetune`` round (every layer copied; K1, K2, K8 a step); the
    card's ``pred_raw`` against the CPU's; a round at ``update_period =
    2`` (K8 on every second step), and ``MNIST_PERIOD_BATCHES`` batches at
    ``update_period = 2`` with dropout off on the card against the CPU.
    Returns the launch counts for the ``mnist_kernels`` line."""
    import contextlib
    import io

    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.cli import LearnTask
    from cxxnet_tpu_torch.io.data import DataBatch, create_iterator
    from cxxnet_tpu_torch.io.mnist import write_idx_images, write_idx_labels
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(os.path.join(tmp, "data"))
    for name, n, seed in (("train", MNIST_TRAIN_ROWS, SEED + 1),
                          ("t10k", MNIST_TEST_ROWS, SEED + 2)):
        imgs, labels = _mnist_digits(n, seed)
        write_idx_images(os.path.join(tmp, "data",
                                      f"{name}-images-idx3-ubyte"), imgs)
        write_idx_labels(os.path.join(tmp, "data",
                                      f"{name}-labels-idx1-ubyte"), labels)
    text = open(MNIST_CONF).read()

    def conf(out):
        path = os.path.join(tmp, f"mnist_conv_{out}.conf")
        with open(path, "w") as f:
            f.write(text + _PRED_SECTION.format(out=out))
        return path

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        counts = {}
        steps_per_round = MNIST_TRAIN_ROWS // MNIST_BATCH
        forwards = MNIST_TEST_ROWS // MNIST_BATCH
        t0 = time.perf_counter()
        _, tr, steps, losses, marks = _run_train_task(
            [conf("pred.txt"), "task=train", "num_round=2", "max_round=2",
             "model_dir=models", "print_step=0"])
        launches = {k.name: k.launches for k in KERNELS if k.launches}
        log(f"mnist train: {len(steps)} steps of {tr.batch_size} rows in "
            f"{time.perf_counter() - t0:.1f}s (CLI run, evaluation and 3 "
            f"checkpoints included) on {tr.device}; launches {launches}; "
            f"losses first {losses[0]:.4f} last {losses[-1]:.4f}")
        if len(steps) != 2 * steps_per_round or not all(np.isfinite(losses)):
            raise SmokeError(f"mnist: {len(steps)} steps, losses finite "
                             f"{bool(np.isfinite(losses).all())}")
        _hold_steps("mnist train", steps, tr.paths, MNIST_PER_STEP)
        # each round's evaluation: one K1 launch a test batch
        if launches.get("maxpool_fwd") != len(steps) + 2 * forwards:
            raise SmokeError(f"mnist train: {launches} (K1 {len(steps)} "
                             f"steps + {2 * forwards} eval forwards)")
        _round_rates(marks, tr.batch_size, "img")
        counts["train"] = {"steps": len(steps), "launches": launches,
                           "per_step": _f32_paths(MNIST_PER_STEP)}
        model = os.path.join("models", f"{2:04d}.model")

        outs = {}
        for task, extra, out in (
                ("pred", [], "pred.txt"), ("pred_raw", [], "raw.txt"),
                ("extract", [f"extract_node_name={MNIST_FEATURE_NODE}"],
                 "fc1.txt"), ("summary", [], "unused.txt")):
            buf = io.StringIO()

            def run():
                with contextlib.redirect_stdout(buf):
                    return LearnTask().run([conf(out), f"task={task}",
                                            f"model_in={model}", *extra])

            rc, (got, by) = _counted(run)
            want = {} if task == "summary" else {"maxpool_fwd": forwards}
            want_by = ({} if task == "summary" else
                       {"maxpool_fwd": {"maxpool_fwd_f32": forwards}})
            if rc != 0 or got != want or by != want_by:
                raise SmokeError(f"mnist task={task}: rc {rc}, launches "
                                 f"{got} by C entry {by}; expected {want}")
            outs[task] = (out, buf.getvalue())
            counts[task] = {"launches": got, "by_c_entry": by}
            log(f"mnist task={task}: launches {got} by C entry {by}")
        preds = open("pred.txt").read().split("\n")[:-1]
        raw = np.array([[float(v) for v in line.split()]
                        for line in open("raw.txt")])
        feats = np.array([[float(v) for v in line.split()]
                          for line in open("fc1.txt")])
        meta = open("fc1.txt.meta").read()
        summary = outs["summary"][1]
        log("mnist task=summary:\n" + summary.rstrip())
        if (len(preds) != MNIST_TEST_ROWS or raw.shape != (MNIST_TEST_ROWS, 10)
                or feats.shape != (MNIST_TEST_ROWS, 100)
                or meta != f"{MNIST_TEST_ROWS},100,1,1\n"
                or not np.isfinite(raw).all() or not np.isfinite(feats).all()
                or np.abs(raw.sum(1) - 1).max() > 1e-4
                or "total parameters: 158,230" not in summary):
            raise SmokeError(f"mnist tasks wrote {len(preds)} preds, raw "
                             f"{raw.shape}, features {feats.shape}, meta "
                             f"{meta!r}")
        if [f"{v:g}" for v in raw.argmax(1)] != preds:
            raise SmokeError("mnist: task=pred is not pred_raw's argmax")
        # the same checkpoint's pred_raw on the CPU
        with contextlib.redirect_stdout(io.StringIO()):
            LearnTask().run([conf("raw_cpu.txt"), "task=pred_raw",
                             f"model_in={model}", "dev=cpu"])
        raw_cpu = np.array([[float(v) for v in line.split()]
                            for line in open("raw_cpu.txt")])
        labels = np.array(
            [int(b) for b in open("data/t10k-labels-idx1-ubyte", "rb"
                                  ).read()[8:]])
        err = float(np.abs(raw - raw_cpu).max())
        acc = float((raw.argmax(1) == labels).mean())
        log(f"mnist pred_raw card vs CPU: max abs {err:.3g} (limit "
            f"{MNIST_PROB_ATOL:g}); test accuracy of the round-2 model "
            f"{acc:.4f}; extract node {MNIST_FEATURE_NODE} (fc1) features "
            f"{feats.shape}, meta {meta.strip()} ({card})")
        if not err <= MNIST_PROB_ATOL:
            raise SmokeError(f"mnist pred_raw card vs CPU {err:.3g}")

        # finetune one round from the round-2 model
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, ft, fsteps, flosses, _ = _run_train_task(
                [conf("pred.txt"), "task=finetune", f"model_in={model}",
                 "num_round=0", "model_dir=models_ft", "print_step=0"])
        copied = [l for l in buf.getvalue().splitlines()
                  if l.startswith("Copying layer")]
        if copied != ["Copying layer cv1", "Copying layer fc1",
                      "Copying layer fc2"] or len(fsteps) != steps_per_round \
                or ft.epoch_counter != steps_per_round \
                or not all(np.isfinite(flosses)):
            raise SmokeError(f"mnist finetune: {copied}, {len(fsteps)} "
                             f"steps, epoch {ft.epoch_counter}")
        _hold_steps("mnist finetune", fsteps, ft.paths, MNIST_PER_STEP)
        counts["finetune"] = {"steps": len(fsteps), "copied": len(copied)}
        log(f"mnist task=finetune: {copied}; {len(fsteps)} steps, K1, K2, "
            "K8 once a step on the f32 entries")

        # a round at update_period = 2
        _, up, usteps, ulosses, _ = _run_train_task(
            [conf("pred.txt"), "task=train", f"model_in={model}",
             "num_round=3", "max_round=1", "update_period=2",
             "model_dir=models_up", "print_step=0"])
        k8 = sum(d["sgd_update"] for d in usteps)
        _hold_steps("mnist update_period=2", usteps, up.paths,
                    MNIST_PER_STEP, pattern=(0, 1))
        if len(usteps) != steps_per_round or 2 * k8 != len(usteps) \
                or up.epoch_counter != 2 * steps_per_round + k8:
            raise SmokeError(f"mnist update_period=2: {len(usteps)} steps, "
                             f"{k8} K8 launches, epoch {up.epoch_counter}")
        counts["update_period_2"] = {"steps": len(usteps),
                                     "sgd_update": k8}
        log(f"mnist update_period=2: {len(usteps)} steps, {k8} K8 launches "
            "(one a second step), K1 and K2 every step")

        # update_period = 2, dropout off: the card against the CPU
        base = cfgmod.parse_pairs(text.replace("threshold = 0.5",
                                               "threshold = 0.0"))
        trs = {}
        for name, d in (("card", "gpu"), ("cpu", "cpu")):
            t = NetTrainer()
            t.set_params(base + [("update_period", "2"), ("dev", d),
                                 ("silent", "1")])
            t.load_model(model)
            trs[name] = t
        it = create_iterator(cfgmod.split_sections(cfgmod.parse_file(
            conf("pred.txt"))).find("data")[0].entries + [
                ("batch_size", str(MNIST_BATCH)), ("silent", "1")])
        it.init()
        it.before_first()
        for _ in range(MNIST_PERIOD_BATCHES):
            if not it.next():
                raise SmokeError("mnist: the data section ran out")
            b = it.value()
            for t in trs.values():
                t.update(DataBatch(data=b.data.copy(), label=b.label.copy()))
        worst = 0.0
        for key, tags in trs["cpu"].params.items():
            for tag, w in tags.items():
                a = trs["card"].params[key][tag].cpu()
                worst = max(worst, float((a - w).abs().max())
                            / float(w.abs().max()))
        log(f"mnist update_period=2 card vs CPU after "
            f"{MNIST_PERIOD_BATCHES} batches ({MNIST_PERIOD_BATCHES // 2} "
            f"updates, dropout off, TF32 off): worst tensor {worst:.3g} of "
            f"its largest weight (limit {MNIST_PERIOD_REL:g})")
        if not worst <= MNIST_PERIOD_REL or any(
                t.epoch_counter != 2 * steps_per_round
                + MNIST_PERIOD_BATCHES // 2 for t in trs.values()):
            raise SmokeError(f"mnist update_period=2 parity {worst:.3g}")
    finally:
        os.chdir(cwd)
    return counts


def digits_phase(tmp: str, card: str):
    """``digits_conv.conf`` as it stands (15 rounds, batch 50, f32) with
    ``dev = tpu`` on the UCI digits the port's tool writes, cuDNN in its
    deterministic mode (so the figure repeats from run to run): every step
    launches K1 and K2 twice and K8 once on the f32 entries, and the last
    round's test error is at most ``DIGITS_MAX_TEST_ERROR``.  Returns
    each round's test error and the run's counts."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.tools.make_digits_idx import write_digits_idx

    write_digits_idx(os.path.join(tmp, "data"))
    cwd = os.getcwd()
    os.chdir(tmp)
    # with TF32 off (phase 3 on) cuDNN picks backward algorithms that
    # add with atomics, and 15 rounds carry their last bits into the
    # test error (1.2-4.0 % over six runs); deterministic ones make the
    # figure reproducible
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        with _Tee() as tee:
            _, tr, steps, losses, marks = _run_train_task(
                [DIGITS_CONF, "dev=tpu", "print_step=0"])
        wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
        os.chdir(cwd)
    errors = _eval_errors("".join(tee.text))
    launches = {k.name: k.launches for k in KERNELS if k.launches}
    _hold_steps("digits_conv", steps, tr.paths, DIGITS_PER_STEP)
    log(f"digits_conv: {len(steps)} steps in {wall:.1f}s on {tr.device}; "
        f"launches {launches}; test error by round "
        + ", ".join(f"[{r}] {e:g}" for r, e in errors) + f" ({card})")
    if (len(errors) != 15 or not all(np.isfinite(losses))
            or not errors[-1][1] <= DIGITS_MAX_TEST_ERROR):
        raise SmokeError(f"digits_conv: test errors {errors} (bar "
                         f"{DIGITS_MAX_TEST_ERROR})")
    return {"steps": len(steps), "launches": launches,
            "per_step": _f32_paths(DIGITS_PER_STEP),
            "test_error": [e for _, e in errors]}


def mnist_line(rows, mnist_counts, digits_counts, card: str):
    """The MNIST nets' line: MNIST_CONV's launches (training, the tasks,
    finetune, update_period = 2), digits_conv's, and K1, K2 and K8 at
    their shapes (max error, kernel, plain and library times, bound)."""
    keep = ("kernel", "dtype", "shape", "max_abs_err", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "call_ms",
            "library_call_ms", "conf")
    return {"mnist_kernels": {
        "card": card, "MNIST_CONV": mnist_counts,
        "digits_conv": digits_counts,
        "rows": [{k: r[k] for k in keep if k in r} for r in rows]}}


def resnet_line(krows, serve_launches, train_launches):
    """ResNet-50's line: per kernel of its path (K1, K2, K6, K8) the
    launches of the ResNet training run (and of the ResNet serving run),
    one step's launches, the max error at ResNet's shapes, and one
    training step's launches' times summed (bf16 b128; K8 the f32
    multi-tensor launch over the 161 tensors)."""
    from cxxnet_tpu_torch.ops import KERNELS

    out = []
    for k in KERNELS:
        if k.name not in RESNET_PER_STEP:
            continue
        mine = [r for r in krows if r["kernel"] == k.name]
        by_bytes = sum(r["bound_ms"] for r in mine
                       if r["bound_by"] == "bytes")
        row = {
            "name": k.name, "route": "cuda",
            "source": os.path.relpath(k.source, REPO),
            "replaces": k.replaces.split()[0],
            "launches": train_launches[k.name],
            "launches_per_step": RESNET_PER_STEP[k.name],
            "shapes": [r["shape"] for r in mine],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            **{f: sum(r[f] for r in mine)
               for f in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": ("bytes" if 2 * by_bytes >= sum(
                r["bound_ms"] for r in mine) else "operations"),
        }
        if k.name in serve_launches:
            row["launches_serving"] = serve_launches[k.name]
        if k.name.startswith("maxpool"):
            row["timed_at"] = "GoogLeNet's identical stem pool"
        out.append(row)
    return {"resnet50_kernels": out}


# ----------------------------------------------------------------------
# phase 20a: the imgbin chain


def _write_raw_shard(path: str, n: int, side: int, seed: int, first: int,
                     nclass: int, ref: bool = False) -> None:
    """``path``.bin (CXBP, or the reference's BinaryPage with ``ref``) and
    ``path``.lst: ``n`` raw-pixel records of ``side`` x ``side`` x 3
    float32, 128 + N(0, 1), seeded labels in 0..nclass-1, indices from
    ``first``."""
    import numpy as np

    from cxxnet_tpu_torch.io.imgbin import (BinPageWriter, RefBinPageWriter,
                                            encode_raw)

    rng = np.random.RandomState(seed)
    labels = rng.randint(0, nclass, n)
    w = RefBinPageWriter(path + ".bin") if ref else BinPageWriter(
        path + ".bin")
    with open(path + ".lst", "w") as f:
        for i in range(n):
            img = (128.0 + rng.standard_normal((side, side, 3))).astype(
                np.float32)
            w.push(encode_raw(img))
            f.write(f"{first + i}\t{labels[i]}\trec{first + i}.raw\n")
    w.close()


def _imgbin_conf(tmp: str) -> str:
    """googlenet.conf with its own data sections: the paths change (the
    train set in two shards), plus ``raw_pixels = 1`` on both sections
    and ``num_decode_workers`` on the train section; then its learning
    rates times ``LR_SCALE``.  One path edit changes behaviour: the eval
    section's ``image_mean`` names the file the train section saves
    (``np.savez`` appends ``.npz``), so the eval set is normalised with
    the train set's mean.  As the conf is written, the eval section
    would not find that file and would make a second mean image over
    the eval data (ROADMAP.md §C); the smoke does not drive that pass."""
    from cxxnet_tpu_torch import config as cfgmod

    a, b, v = (os.path.join(tmp, n) for n in ("train_a", "train_b", "val"))
    mean = os.path.join(tmp, "image_mean.bin")
    text = open(CONF).read()
    edits = (
        ("  image_list = ./shards/train_001.lst\n"
         "  image_bin = ./shards/train_001.bin\n",
         f"  image_list = {a}.lst\n  image_bin = {a}.bin\n"
         f"  image_list = {b}.lst\n  image_bin = {b}.bin\n"
         f"  raw_pixels = 1\n  num_decode_workers = {IMGBIN_WORKERS}\n"),
        ("  image_list = ./shards/val_001.lst\n"
         "  image_bin = ./shards/val_001.bin\n",
         f"  image_list = {v}.lst\n  image_bin = {v}.bin\n"
         "  raw_pixels = 1\n"),
        ("image_mean = ./models/image_mean.bin", f"image_mean = {mean}"),
        ("image_mean = ./models/image_mean.bin",
         f"image_mean = {mean}.npz"))
    for old, new in edits:
        if old not in text:
            raise SmokeError(f"googlenet.conf: {old.strip()!r} not found")
        text = text.replace(old, new, 1)
    split = cfgmod.split_sections(cfgmod.parse_file(CONF))
    text += "\n" + "".join(
        f"{n} = {float(val) * LR_SCALE:g}\n" for n, val in
        split.global_entries if n in ("eta", "lr", "wmat:lr", "bias:lr"))
    path = os.path.join(tmp, "googlenet_imgbin.conf")
    with open(path, "w") as f:
        f.write(text)
    return path


def _train_chain(conf: str, workers: int, buffered: bool,
                 shard: str = ""):
    """The conf's data section as ``create_iterator`` builds it, at
    ``workers`` decode workers, with or without its ``threadbuffer``,
    reading the mean image the training run made; with ``shard``, that
    shard's ``.lst``/``.bin`` in place of the train set and
    ``raw_pixels`` left at 0 (encoded images); ``init`` done."""
    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.io.data import create_iterator

    split = cfgmod.split_sections(cfgmod.parse_file(conf))
    entries = []
    for n, val in split.find("data")[0].entries:
        if n == "num_decode_workers":
            val = str(workers)
        elif n == "image_mean":
            val += ".npz"
        elif (n, val) == ("iter", "threadbuffer") and not buffered:
            continue
        elif shard and n in ("image_list", "image_bin", "raw_pixels"):
            continue
        entries.append((n, val))
        if shard and (n, val) == ("iter", "imgbin"):
            entries += [("image_list", shard + ".lst"),
                        ("image_bin", shard + ".bin")]
    it = create_iterator(entries)
    for n, val in split.global_entries + [("silent", "1")]:
        it.set_param(n, val)
    try:
        it.init()
    except BaseException:
        it.close()
        raise
    return it


def _chain_round(it, round_: int, stop: int = 0):
    """One round as the CLI drives it (the epoch anchored to the round,
    then the rewind): each batch's digest and padding, at most ``stop``
    batches; each batch must be finite, of the conf's shape."""
    import hashlib

    import numpy as np

    it.set_param("augment_epoch_next", str(round_))
    it.before_first()
    out = []
    while it.next():
        b = it.value()
        if (b.data.shape != (BATCH, CONF_SIDE, CONF_SIDE, 3)
                or not np.isfinite(b.data).all()):
            raise SmokeError(f"imgbin chain: a batch of shape "
                             f"{b.data.shape}, or not finite")
        h = hashlib.sha256(b.data.tobytes())
        h.update(b.label.tobytes())
        out.append((h.hexdigest(), b.num_batch_padd))
        if stop and len(out) == stop:
            break
    return out


def _chain_checks(conf: str) -> None:
    """Round 1's batches bit-equal at 1 and 4 workers, with and without
    threadbuffer, and after a mid-epoch rewind; a resumed round 2 equal
    to the uninterrupted one."""
    ref = _train_chain(conf, 1, False)
    try:
        r1, r2 = _chain_round(ref, 1), _chain_round(ref, 2)
    finally:
        ref.close()
    if [p for _, p in r1] != [0, 0, IMGBIN_PADD] or r1 == r2:
        raise SmokeError(f"imgbin chain: round 1 padding "
                         f"{[p for _, p in r1]}, round 2 equal to round 1: "
                         f"{r1 == r2}")
    cases = []
    for workers, buffered in ((IMGBIN_WORKERS, False), (1, True),
                              (IMGBIN_WORKERS, True)):
        it = _train_chain(conf, workers, buffered)
        try:
            got = [_chain_round(it, 1)]
            if workers > 1 and buffered:
                _chain_round(it, 1, stop=1)  # rewound mid-epoch
                got += [_chain_round(it, 1), _chain_round(it, 2)]
        finally:
            it.close()
        cases.append((f"{workers} workers, threadbuffer {buffered}", got))
    it = _train_chain(conf, IMGBIN_WORKERS, True)
    try:
        resumed = _chain_round(it, 2)
    finally:
        it.close()
    for tag, got in cases:
        want = [r1, r1, r2][:len(got)]
        if got != want:
            raise SmokeError(f"imgbin chain at {tag}: batches differ from "
                             "the serial chain's")
    if resumed != r2:
        raise SmokeError("imgbin chain: a resumed round 2 differs from the "
                         "uninterrupted round 2")
    log(f"imgbin chain: round 1 bit-equal at 1 and {IMGBIN_WORKERS} workers,"
        " with and without threadbuffer and after a mid-epoch rewind; a "
        "resumed round 2 equal to the uninterrupted one; padding "
        f"{[p for _, p in r1]}")


def _rate(fn, rows: int) -> float:
    """``rows`` over the median of ``IMGBIN_PASSES`` timings of ``fn``,
    host clock."""
    times = []
    for _ in range(IMGBIN_PASSES):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return rows / statistics.median(times)


def _drain(it) -> None:
    """One pass of an iterator (rewound first), its values untouched."""
    it.before_first()
    while it.next():
        pass


def _chain_rates(conf: str, card: str):
    """The chain alone (no step, no threadbuffer): records per second of
    one pass over the train set, median of ``IMGBIN_PASSES``, host
    clock: at 1 worker each stage added in turn (the page reader, the
    raw decode, the augmenter, the batch layer), then the whole chain at
    ``IMGBIN_WORKERS`` workers."""
    rows = sum(IMGBIN_TRAIN)

    def rate(fn):
        return _rate(fn, rows)

    def read(src):
        src.before_first()
        while src.next_raw() is not None:
            pass

    out = {}
    it = _train_chain(conf, 1, False)
    try:
        aug = it.base.aug
        stages = {"reader": lambda: read(aug.base),
                  "reader+decode": lambda: _drain(aug.base),
                  "reader+decode+augment": lambda: _drain(aug),
                  "1": lambda: _drain(it)}
        for name, fn in stages.items():
            out[name] = rate(fn)
    finally:
        it.close()
    it = _train_chain(conf, IMGBIN_WORKERS, False)
    try:
        out[str(IMGBIN_WORKERS)] = rate(lambda: _drain(it))
    finally:
        it.close()
    log(f"imgbin chain alone, img/s (median of {IMGBIN_PASSES} passes over "
        f"{rows} 3x{IMGBIN_SIDE}x{IMGBIN_SIDE} raw records, crop "
        f"{CONF_SIDE}, mirror, mean image; host clock; '1' and "
        f"'{IMGBIN_WORKERS}' the whole chain at that many workers, the "
        f"others its first stages at 1): "
        f"{json.dumps({k: round(v, 1) for k, v in out.items()})}; {card}")
    return out


def _bowl_pred_raw(tmp: str):
    """``task=pred_raw`` with bowl.conf's net and pred.conf's section
    (``imgbin`` + ``threadbuffer``, batch 64) over ``BOWL_ROWS`` raw
    records, float32 with TF32 off, on the card (counted: K1 three times
    a forward on its f32 vector entry, nothing else) and on the CPU;
    returns the largest difference."""
    import contextlib
    import io

    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.cli import LearnTask
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    d = os.path.join(tmp, "bowl")
    os.makedirs(d)
    _write_raw_shard(os.path.join(d, "test"), BOWL_ROWS, BOWL_SIDE, SEED + 23,
                     0, BOWL_CLASSES)
    pred = open(BOWL_PRED_CONF).read()
    pred = pred[pred.index("pred = "):]
    for old, new in (("./data/test.lst", os.path.join(d, "test.lst")),
                     ("./data/test.bin\n",
                      os.path.join(d, "test.bin") + "\n  raw_pixels = 1\n"),
                     ("./models/0100.model", os.path.join(d, "0000.model"))):
        if old not in pred:
            raise SmokeError(f"pred.conf: {old.strip()!r} not found")
        pred = pred.replace(old, new)
    text = open(BOWL_CONF).read() + "\n" + pred + f"seed = {SEED}\n"
    confs = {}
    for where, out in (("gpu", "test.txt"), ("cpu", "test_cpu.txt")):
        confs[where] = os.path.join(d, f"pred_{where}.conf")
        with open(confs[where], "w") as f:
            f.write(text.replace("pred = test.txt", f"pred = {out}"))
    tr = NetTrainer()
    tr.set_params(cfgmod.parse_file(confs["cpu"]) + [("dev", "cpu")])
    tr.init_model()
    tr.save_model(os.path.join(d, "0000.model"))
    forwards = -(-BOWL_ROWS // tr.batch_size)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cwd = os.getcwd()
    os.chdir(d)
    try:
        def run():
            with contextlib.redirect_stdout(io.StringIO()):
                return LearnTask().run([confs["gpu"]])

        rc, (got, by) = _counted(run)
        with contextlib.redirect_stdout(io.StringIO()):
            LearnTask().run([confs["cpu"], "dev=cpu"])
    finally:
        os.chdir(cwd)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    want = {k: v * forwards for k, v in BOWL_PER_FORWARD.items()}
    want_by = {k: v for k, v in _f32_paths(want).items() if v}
    if rc != 0 or got != want or by != want_by:
        raise SmokeError(f"bowl pred_raw: rc {rc}, launches {got} by C "
                         f"entry {by}; expected {want}, {want_by}")
    rows = {}
    for where, out in (("gpu", "test.txt"), ("cpu", "test_cpu.txt")):
        lines = open(os.path.join(d, out)).read().split("\n")[:-1]
        if not all(line.endswith(" ") for line in lines):
            raise SmokeError(f"bowl pred_raw ({where}): a row without the "
                             "trailing separator")
        rows[where] = np.array([[float(v) for v in line.split()]
                                for line in lines])
    card, cpu = rows["gpu"], rows["cpu"]
    err = float(np.abs(card - cpu).max()) if card.shape == cpu.shape else None
    log(f"bowl pred_raw: {card.shape[0]} rows of {card.shape[1]} on the card "
        f"({forwards} forwards of {tr.batch_size}, the last padded; "
        f"launches {got}, by C entry {by}); card vs CPU max abs {err}")
    if (card.shape != (BOWL_ROWS, BOWL_CLASSES) or err is None
            or not np.isfinite(card).all() or err > F32_PROB_ATOL
            or np.abs(card.sum(1) - 1).max() > 1e-4):
        raise SmokeError(f"bowl pred_raw: shape {card.shape}, card vs CPU "
                         f"{err} (limit {F32_PROB_ATOL})")
    return err, got


def _jpeg_check(tmp: str, conf: str, card: str):
    """JPEG records through the train section's chain.  Without PIL a
    ``raw_pixels = 0`` chain must refuse at ``init()`` naming the key.
    With PIL, as many JPEG records as the raw train set (``JPEG_NOISE``)
    go through it: round 1 bit-equal at 1 and ``IMGBIN_WORKERS``
    workers, then records per second of a pass at each, median of
    ``IMGBIN_PASSES``, host clock, as ``_chain_rates`` times raw pages."""
    import io

    import numpy as np

    from cxxnet_tpu_torch.io.imgbin import BinPageWriter

    path = os.path.join(tmp, "jpeg")
    rows = sum(IMGBIN_TRAIN)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    rng = np.random.RandomState(SEED + 29)
    nbytes = 0
    w = BinPageWriter(path + ".bin")
    with open(path + ".lst", "w") as f:
        for i in range(rows):
            if Image is None:
                blob = b"\xff\xd8 not decoded here"
            else:
                low = Image.fromarray(rng.randint(0, 256, (8, 8, 3),
                                                  dtype=np.uint8))
                img = np.asarray(low.resize((IMGBIN_SIDE, IMGBIN_SIDE),
                                            Image.BILINEAR), np.float32)
                img += rng.standard_normal(img.shape) * JPEG_NOISE
                buf = io.BytesIO()
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                    buf, "JPEG", quality=90)
                blob = buf.getvalue()
            nbytes += len(blob)
            w.push(blob)
            f.write(f"{i}\t{rng.randint(0, 1000)}\trec{i}.jpg\n")
    w.close()
    if Image is None:
        try:
            _train_chain(conf, IMGBIN_WORKERS, False, shard=path).close()
        except RuntimeError as e:
            if "raw_pixels" not in str(e):
                raise SmokeError(f"jpeg: the refusal does not name "
                                 f"raw_pixels: {e}") from e
            log(f"imgbin jpeg: no PIL on this machine; a raw_pixels = 0 "
                f"chain refused at init(): {e}")
            return {"pil": None, "refused_at_init": True}
        raise SmokeError("jpeg: no PIL here, yet a raw_pixels = 0 chain "
                         "initialised")
    import PIL

    digests, rates = {}, {}
    for workers in (1, IMGBIN_WORKERS):
        it = _train_chain(conf, workers, False, shard=path)
        try:
            digests[workers] = _chain_round(it, 1)
            rates[str(workers)] = _rate(lambda: _drain(it), rows)
        finally:
            it.close()
    pads = [p for _, p in digests[1]]
    if pads != [0, 0, IMGBIN_PADD]:
        raise SmokeError(f"jpeg: paddings {pads}")
    if digests[1] != digests[IMGBIN_WORKERS]:
        raise SmokeError(f"jpeg: round 1 differs between 1 and "
                         f"{IMGBIN_WORKERS} workers")
    log(f"imgbin jpeg: PIL {PIL.__version__} here; {rows} JPEG records "
        f"(3x{IMGBIN_SIDE}x{IMGBIN_SIDE}, quality 90, {nbytes / rows:.0f} "
        f"bytes each) through the train section's chain (crop "
        f"{CONF_SIDE}, mirror, mean image), round 1 bit-equal at 1 and "
        f"{IMGBIN_WORKERS} workers, paddings {pads}; img/s (median of "
        f"{IMGBIN_PASSES} passes, host clock) "
        f"{json.dumps({k: round(v, 1) for k, v in rates.items()})}; {card}")
    return {"pil": PIL.__version__, "records": rows,
            "bytes_per_record": nbytes / rows, "img_s": rates}


def imgbin_phase(tmp: str, card: str, synthetic_rates):
    """Phase 20a: ``task=train`` on googlenet.conf's own data sections
    over raw-pixel pages in both layouts, the chain against itself, its
    rate alone, K1 at bowl.conf's pools, ``pred_raw`` through imgbin on
    bowl.conf's net, JPEG records through the chain and their rate.
    Returns the ``imgbin`` JSON line's object."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch.io.augment import AugmentIterator
    from cxxnet_tpu_torch.ops import KERNELS

    t0 = time.perf_counter()
    na, nb = IMGBIN_TRAIN
    _write_raw_shard(os.path.join(tmp, "train_a"), na, IMGBIN_SIDE, SEED + 20,
                     0, 1000)
    _write_raw_shard(os.path.join(tmp, "train_b"), nb, IMGBIN_SIDE, SEED + 21,
                     na, 1000, ref=True)
    _write_raw_shard(os.path.join(tmp, "val"), IMGBIN_EVAL, IMGBIN_SIDE,
                     SEED + 22, 0, 1000)
    nbytes = sum(os.path.getsize(os.path.join(tmp, f)) for f in
                 os.listdir(tmp) if f.endswith(".bin"))
    log(f"imgbin: pages written in {time.perf_counter() - t0:.1f}s, "
        f"{nbytes / 1e6:.1f} MB ({na} records CXBP + {nb} BinaryPage train, "
        f"{IMGBIN_EVAL} CXBP eval)")
    conf = _imgbin_conf(tmp)
    mdir = os.path.join(tmp, "models")
    argv = [conf, "task=train", "dev=gpu", f"num_round={ROUNDS}",
            f"max_round={ROUNDS}", f"model_dir={mdir}", f"seed={SEED}",
            "print_step=0"]
    made = []
    create = AugmentIterator._create_mean_img

    def counted_mean(self):
        made.append(self.name_meanimg)
        return create(self)

    AugmentIterator._create_mean_img = counted_mean
    t0 = time.perf_counter()
    try:
        # the main path: counts at 0 just before, read just after
        with _Tee() as err:
            _, tr, steps, losses, marks = _run_train_task(argv)
    finally:
        AugmentIterator._create_mean_img = create
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    want = {**{k.name: 0 for k in KERNELS}, **IMGBIN_PER_STEP}
    want_paths = _main_paths(IMGBIN_PER_STEP)
    log(f"imgbin train: {len(steps)} steps of {tr.batch_size} rows in "
        f"{wall:.1f}s (CLI run, mean image and evaluation included); "
        f"launches {launches}; losses {[round(v, 4) for v in losses]}")
    n_steps = ROUNDS * -(-sum(IMGBIN_TRAIN) // BATCH)
    if len(steps) != n_steps:
        raise SmokeError(f"imgbin train ran {len(steps)} steps, not {n_steps}")
    for i, (d, p) in enumerate(zip(steps, tr.paths)):
        if d != want or p != want_paths:
            raise SmokeError(f"imgbin training step {i} launched {d}, by C "
                             f"entry {p}; expected {want}")
    if not all(np.isfinite(losses)):
        raise SmokeError(f"imgbin train: non-finite loss {losses}")
    if made != [os.path.join(tmp, "image_mean.bin")]:
        raise SmokeError(f"imgbin train: mean images made {made}, not one")
    evals = [line for line in "".join(err.text).splitlines()
             if line.startswith("[") and "val-" in line]
    if len(evals) != ROUNDS:
        raise SmokeError(f"imgbin train: eval lines {evals}")
    log(f"imgbin train: mean image made once ({made[0]}.npz), read by the "
        f"eval section; eval lines {evals}")
    rates = _round_rates(marks, tr.batch_size, "img")
    log(f"imgbin train: CLI round rates {[round(r, 1) for r in rates]} "
        f"samples/s beside phase 5's synthetic "
        f"{[round(r, 1) for r in synthetic_rates]}; {card}")
    _chain_checks(conf)
    chain = _chain_rates(conf, card)
    bowl_rows = bowl_kernels(torch.device("cuda:0"))
    err_bowl, bowl_launches = _bowl_pred_raw(tmp)
    jpeg = _jpeg_check(tmp, conf, card)
    return {"card": card, "steps": len(steps),
            "launches": {k: v for k, v in launches.items() if v},
            "per_step": want_paths,
            "cli_round_samples_s": rates,
            "synthetic_round_samples_s": synthetic_rates,
            "chain_img_s": chain, "pred_raw_max_abs_err": err_bowl,
            "pred_raw_launches": bowl_launches,
            "bowl_kernels": [{k: r[k] for k in (
                "kernel", "dtype", "shape", "max_abs_err", "ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "call_ms",
                "library_call_ms")} for r in bowl_rows],
            "jpeg": jpeg}


# ----------------------------------------------------------------------
# phase 22: the rest of the layer zoo, the conv rewrites and the text
# iterators (ROADMAP.md items (f) and (g))

# 22a: googlenet.conf's net (b128 bf16) under each conv rewrite, three
# SGD steps from one synthetic batch cached by membuffer; the rewrite's
# own check per conv layer on the direct run's weights and PARITY_ROWS
# rows: f32 (TF32 off) s2d within S2D_F32_REL of the layer's largest
# output (summation order), Winograd within WINO_F32_ATOL of max(1, that
# largest) (tests/test_layers.py:533); bf16 Winograd's error against the
# f32 direct conv within WINO_BF16_FACTOR x the direct bf16 conv's plus
# 1e-3 of max(1, that largest) (tests/test_layers.py:578)
REWRITES = {"direct": (), "conv_s2d": ("conv_s2d=1",),
            "wino_f4": ("conv_wino=1",), "wino_f2": ("conv_wino=2",)}
REWRITE_STEPS = 2
REWRITE_TIMED = 2  # steps a turn in the step-time turns
S2D_F32_REL = 1e-5
WINO_F32_ATOL = 2e-4
WINO_BF16_FACTOR = {1: 25.0, 2: 3.0}
# 22b: digits_conv.conf in bf16 under conv_wino = 1 and 2, held to the
# JAX test's bounds (tests/test_accuracy.py:97-99): the best of rounds
# 13-15 at most 4 %, round 15 at most 6 %; beside the CPU figures of
# example/MNIST/wino_bf16_ab.log (round 15: F(4x4) 2.8 %, F(2x2) 2.0 %,
# direct 0.8 %)
WINO_TAIL_ERROR, WINO_LAST_ERROR = 0.04, 0.06
WINO_AB_CPU = {"1": 0.028, "2": 0.020, "direct": 0.008}
# 22c: bowl.conf's net (3x40x40, batch 64, 121 classes) with its relus
# replaced, a 2-wide side feature per row (csv -> attachtxt -> membuffer)
# through fixconn -> bias -> softplus beside the flatten output; two
# rounds of the NDSB_ROWS rows; each step K1 3, K2 3 on the f32 vector
# entries and K8 once
NDSB_ROWS, NDSB_ROUNDS = 640, 2
NDSB_PER_STEP = {"maxpool_fwd": 3, "maxpool_bwd": 3, "sgd_update": 1}
NDSB_CALM = (5, 15)  # insanity's calm window, inside the run's 20 updates
NDSB_FIXCONN = "4 2 5\n0 0 1.5\n1 1 -0.5\n2 0 0.25\n2 1 2\n3 1 1\n"
NDSB_SIDE = """layer[in_1->side] = fixconn:side
  nhidden = 4
  fixconn_weight = {fix}
layer[side->side] = bias:side_bias
  init_bias = 0.1
layer[side->side] = softplus
layer[12,side->cat] = concat
layer[cat->13] = fullc:fc1"""
NDSB_VARIANTS = {
    # relu -> xelu, and a torch: layer in place of conv4
    "xelu": ((("= relu\n", "= xelu\n  b = 5.5\n"),
              ("layer[8->9] = conv:conv4\n",
               "layer[8->9] = torch:conv4\n  torch_op = \"torch.nn.Conv2d"
               "(128, 128, 3, padding=1)\"\n")), ()),
    # relu -> prelu (slope jitter 0.1), the last pool a pairtest
    "prelu": ((("= relu\n", "= prelu\n  random = 0.1\n"),
               ("layer[10->11] = max_pooling\n",
                "layer[10->11] = pairtest-max_pooling-insanity_max_pooling\n"
                "  keep = 0.9\n")), ()),
    # relu -> insanity (its interval closing over NDSB_CALM), the pools
    # -> insanity_max_pooling
    "insanity": ((("= relu\n", "= insanity\n  lb = 3\n  ub = 8\n"
                   f"  calm_start = {NDSB_CALM[0]}\n"
                   f"  calm_end = {NDSB_CALM[1]}\n"),
                  ("= max_pooling\n", "= insanity_max_pooling\n"
                   "  keep = 0.9\n")), ()),
}


def _rewrite_sites(tr):
    """``(s2d, wino)``: the conv layers each rewrite takes, read off the
    net's shape inference (s2d: stride > 1 and ngroup 1; Winograd: 3x3,
    stride 1, ngroup 1 and at least 8 input channels)."""
    shapes = tr.net.node_shapes
    s2d, wino = [], []
    for i, spec in enumerate(tr.graph.layers):
        if spec.type_name != "conv":
            continue
        p = tr.net.layer_objs[i].param
        cin = shapes[spec.nindex_in[0]][3]
        if p.stride > 1 and p.num_group == 1:
            s2d.append(i)
        if ((p.kernel_height, p.kernel_width, p.stride, p.num_group)
                == (3, 3, 1, 1) and cin >= 8):
            wino.append(i)
    return s2d, wino


def _set_rewrite(lay, how: str, variant: int = 0) -> None:
    lay.conv_s2d = int(how == "conv_s2d")
    lay.conv_wino = variant if how == "conv_wino" else 0


def _rewrite_parity(tr, dev, s2d, wino):
    """Each rewritten conv against the direct conv on its own input from
    an f32 forward of ``PARITY_ROWS`` rows on the direct run's weights
    (TF32 off): the f32 and bf16 errors, held to the limits above;
    returns the worst share of each limit used."""
    import torch

    net = tr.net
    side = net.input_node_shape(1)[1]
    x = torch.randn(PARITY_ROWS, side, side, 3,
                    generator=torch.Generator().manual_seed(SEED + 31)).to(dev)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cdt = net.compute_dtype
    worst = {}
    try:
        net.compute_dtype = torch.float32
        with torch.inference_mode():
            prep32 = net.prepare(tr.params)
            nodes = net.forward(prep32, x)
            for i in s2d + wino:
                lay, spec = net.layer_objs[i], tr.graph.layers[i]
                key = net.param_key[i]
                xin = nodes[spec.nindex_in[0]]
                p32 = prep32["layers"][key]
                p16 = lay.prepare(tr.params[key], torch.bfloat16)
                _set_rewrite(lay, "")
                ref = lay.apply(p32, [xin])[0]
                d16 = lay.apply(p16, [xin.bfloat16()])[0]
                scale = float(ref.abs().max())
                e_direct = float((d16.float() - ref).abs().max())
                cases = ([("conv_s2d", 0)] if i in s2d else [])
                cases += ([("conv_wino", 1), ("conv_wino", 2)]
                          if i in wino else [])
                for how, v in cases:
                    _set_rewrite(lay, how, v)
                    e32 = float((lay.apply(p32, [xin])[0] - ref).abs().max())
                    e16 = float((lay.apply(p16, [xin.bfloat16()])[0].float()
                                 - ref).abs().max())
                    _set_rewrite(lay, "")
                    if how == "conv_s2d":
                        tag, lim32 = "s2d", S2D_F32_REL * scale
                        lim16 = None
                    else:
                        tag = f"wino_f{4 if v == 1 else 2}"
                        lim32 = WINO_F32_ATOL * max(1.0, scale)
                        lim16 = (WINO_BF16_FACTOR[v] * e_direct
                                 + 1e-3 * max(1.0, scale))
                    name = tr.graph.layers[i].name
                    if e32 > lim32 or (lim16 is not None and e16 > lim16):
                        raise SmokeError(
                            f"{tag} at {name}: f32 error {e32:.3g} (limit "
                            f"{lim32:.3g}), bf16 {e16:.3g} (limit "
                            f"{lim16}; direct bf16 {e_direct:.3g}), largest "
                            f"output {scale:.3g}")
                    w = worst.setdefault(tag, {"f32": 0.0, "bf16": 0.0})
                    w["f32"] = max(w["f32"], e32 / lim32)
                    if lim16 is not None:
                        w["bf16"] = max(w["bf16"], e16 / lim16)
    finally:
        net.compute_dtype = cdt
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return worst


def _step_turns(trainers, batch, dev):
    """Each trainer's ``update`` step on one device-resident batch, in
    turns (the order reversed every round): host clock around
    ``REWRITE_TIMED`` steps, after a synchronised warm-up step; ms a
    step per round."""
    import torch

    times = {n: [] for n in trainers}
    order = list(trainers.items())
    for r in range(2):
        for n, tr in (order if r % 2 == 0 else order[::-1]):
            tr.update(batch)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(REWRITE_TIMED):
                tr.update(batch)
            torch.cuda.synchronize(dev)
            times[n].append((time.perf_counter() - t0) * 1e3 / REWRITE_TIMED)
    return times


def rewrite_phase(tmp: str, card: str):
    """22a: ``task=train`` on googlenet.conf's net, one synthetic batch
    of ``BATCH`` rows cached by ``membuffer`` (``max_nbatch = 1``), bf16,
    ``dev=gpu``, phase 5's ``LR_SCALE``, ``REWRITE_STEPS`` steps each:
    direct, ``conv_s2d = 1``, ``conv_wino = 1`` and ``conv_wino = 2``.
    Every step launches K1-K6 as in phase 5 on their main paths and K8
    once; the rewrites' uses are the sites shape inference gives (s2d
    the stem alone) once a step; every loss finite.  Then the rewrites'
    parity on the direct run's weights and the four trainers' step
    times in turns."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.layers import conv as tconv
    from cxxnet_tpu_torch.ops import KERNELS

    conf = _synthetic_conf(tmp, "googlenet_membuffer.conf",
                           (("data", "train", BATCH, False),), LR_SCALE)
    with open(conf) as f:
        text = f.read()
    with open(conf, "w") as f:
        f.write(text.replace("iter = end", "iter = membuffer\n"
                             "  max_nbatch = 1\niter = end", 1))
    want = {**{k.name: 0 for k in KERNELS}, **IMGBIN_PER_STEP}
    want_paths = _main_paths(PER_STEP)
    trainers, out = {}, {"losses": {}, "uses_per_step": {}, "wall_s": {}}
    for name, extra in REWRITES.items():
        tconv.REWRITE_USES.clear()
        t0 = time.perf_counter()
        _, tr, steps, losses, _ = _run_train_task(
            [conf, "task=train", "dev=gpu", f"num_round={REWRITE_STEPS}",
             f"max_round={REWRITE_STEPS}", "save_model=0",
             f"model_dir={os.path.join(tmp, name)}", f"seed={SEED}",
             "print_step=0", *extra])
        out["wall_s"][name] = round(time.perf_counter() - t0, 2)
        uses = dict(tconv.REWRITE_USES)
        s2d, wino = _rewrite_sites(tr)
        sites = {"direct": {}, "conv_s2d": {"conv_s2d": len(s2d)},
                 "wino_f4": {"conv_wino": len(wino)},
                 "wino_f2": {"conv_wino": len(wino)}}[name]
        if ([tr.graph.layers[i].name for i in s2d] != ["conv1"]
                or not wino):
            raise SmokeError(f"rewrite sites: s2d {s2d}, wino {wino}")
        if len(steps) != REWRITE_STEPS or any(d != want for d in steps) or any(
                p != want_paths for p in tr.paths):
            raise SmokeError(f"rewrites {name}: steps {steps}, by C entry "
                             f"{tr.paths}; expected {want}, {want_paths}")
        if uses != {k: v * REWRITE_STEPS for k, v in sites.items()}:
            raise SmokeError(f"rewrites {name}: uses {uses}, expected "
                             f"{sites} a step over {REWRITE_STEPS} steps")
        if not all(np.isfinite(losses)):
            raise SmokeError(f"rewrites {name}: losses {losses}")
        out["losses"][name] = list(losses)
        out["uses_per_step"][name] = sites
        trainers[name] = tr
        log(f"rewrites {name}: {len(steps)} steps, launches a step "
            f"{steps[0]}, rewrite uses {uses}, losses "
            f"{[round(v, 4) for v in losses]}")
    out["parity"] = _rewrite_parity(trainers["direct"], trainers[
        "direct"].device, *_rewrite_sites(trainers["direct"]))
    log(f"rewrites: parity, the worst share of each limit {out['parity']}")
    dev = trainers["direct"].device
    side = trainers["direct"].net.input_node_shape(1)[1]
    g = torch.Generator(device=dev).manual_seed(SEED + 32)
    batch = DataBatch(
        data=torch.randn(BATCH, side, side, 3, device=dev, generator=g),
        label=torch.randint(0, 1000, (BATCH, 1), device=dev,
                            generator=g).float())
    out["step_ms"] = _step_turns(trainers, batch, dev)
    log("rewrites: b128 bf16 step ms in turns (host clock, update() on a "
        f"device-resident batch) {json.dumps(out['step_ms'])} ({card})")
    return out


def wino_digits_phase(tmp: str, card: str):
    """22b: ``digits_conv.conf`` under ``compute_dtype = bfloat16`` with
    ``conv_wino = 1`` and ``2`` on the card, 15 rounds each, cuDNN in its
    deterministic mode: every step K1 2 and K2 2 on the bf16 main
    paths and K8 once; cv2 (32 channels in) takes Winograd, cv1 (1 in)
    does not; the test error held to the JAX test's bounds."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch.layers import conv as tconv
    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.tools.make_digits_idx import write_digits_idx

    write_digits_idx(os.path.join(tmp, "data"))
    want = {**{k.name: 0 for k in KERNELS}, **DIGITS_PER_STEP}
    want_paths = _main_paths(DIGITS_PER_STEP)
    out = {}
    cwd = os.getcwd()
    os.chdir(tmp)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for wino in ("1", "2"):
            tconv.REWRITE_USES.clear()
            t0 = time.perf_counter()
            with _Tee() as tee:
                _, tr, steps, losses, _ = _run_train_task(
                    [DIGITS_CONF, "dev=tpu", "print_step=0",
                     "compute_dtype=bfloat16", f"conv_wino={wino}"])
            wall = time.perf_counter() - t0
            errors = dict(_eval_errors("".join(tee.text)))
            uses = dict(tconv.REWRITE_USES)
            if (any(d != want for d in steps)
                    or any(p != want_paths for p in tr.paths)):
                raise SmokeError(f"digits wino {wino}: launches {steps[0]}, "
                                 f"by C entry {tr.paths[0]}; expected {want}")
            wino_layers = [tr.graph.layers[i].name for i in
                           _rewrite_sites(tr)[1]]
            if wino_layers != ["cv2"] or uses.get("conv_wino", 0) < len(steps):
                raise SmokeError(f"digits wino {wino}: sites {wino_layers}, "
                                 f"uses {uses} over {len(steps)} steps")
            tail = [errors.get(r, np.inf) for r in (13, 14, 15)]
            log(f"digits_conv bf16 conv_wino={wino}: {len(steps)} steps in "
                f"{wall:.1f}s; test error by round "
                + ", ".join(f"[{r}] {e:g}" for r, e in sorted(errors.items()))
                + f"; round 15 {tail[-1]:g} beside the CPU A/B's "
                f"{WINO_AB_CPU[wino]:g} (direct {WINO_AB_CPU['direct']:g}) "
                f"({card})")
            if (len(errors) != 15 or not all(np.isfinite(losses))
                    or min(tail) > WINO_TAIL_ERROR
                    or tail[-1] > WINO_LAST_ERROR):
                raise SmokeError(f"digits wino {wino}: test errors {errors}")
            out[f"conv_wino={wino}"] = {
                "steps": len(steps), "test_error": [
                    errors[r] for r in sorted(errors)],
                "cpu_round15": WINO_AB_CPU[wino], "wall_s": round(wall, 2)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
        os.chdir(cwd)
    return out


def _ndsb_data(d: str):
    """``NDSB_ROWS`` seeded rows of bowl.conf's shape as csv (label, then
    the CHW pixels), a 2-wide side feature per row (attachtxt's file),
    and fixconn's sparse 4x2 weight; returns the rows and features."""
    import numpy as np

    rs = np.random.RandomState(SEED + 40)
    x = rs.randn(NDSB_ROWS, 3 * BOWL_SIDE * BOWL_SIDE).astype(np.float32)
    y = rs.randint(0, BOWL_CLASSES, NDSB_ROWS)
    side = rs.randn(NDSB_ROWS, 2).astype(np.float32)
    np.savetxt(os.path.join(d, "train.csv"),
               np.concatenate([y[:, None].astype(np.float32), x], 1),
               fmt="%.5g", delimiter=",")
    with open(os.path.join(d, "side.txt"), "w") as f:
        f.writelines(f"{i} {a:.6g} {b:.6g}\n" for i, (a, b) in
                     enumerate(side))
    with open(os.path.join(d, "fix.txt"), "w") as f:
        f.write(NDSB_FIXCONN)
    rows = np.loadtxt(os.path.join(d, "train.csv"), delimiter=",",
                      dtype=np.float32)
    feats = np.loadtxt(os.path.join(d, "side.txt"), dtype=np.float32)[:, 1:]
    return rows, feats


def _ndsb_conf(d: str, variant: str) -> str:
    """bowl.conf's net and globals with the variant's substitutions and
    the side branch, over csv -> attachtxt -> membuffer."""
    text = open(BOWL_CONF).read()
    net = text[text.index("netconfig = start"):]
    for old, new in NDSB_VARIANTS[variant][0]:
        if old not in net:
            raise SmokeError(f"bowl.conf: {old.strip()!r} not found")
        net = net.replace(old, new)
    fc1 = "layer[12->13] = fullc:fc1"
    if fc1 not in net:
        raise SmokeError(f"bowl.conf: {fc1!r} not found")
    net = net.replace(fc1, NDSB_SIDE.format(fix=os.path.join(d, "fix.txt")))
    head = f"""extra_data_num = 1
extra_data_shape[0] = 1,1,2
data = train
iter = csv
  filename = {os.path.join(d, "train.csv")}
  silent = 1
iter = attachtxt
  attach_file = {os.path.join(d, "side.txt")}
  silent = 1
iter = membuffer
  silent = 1
iter = end
"""
    path = os.path.join(d, f"ndsb_{variant}.conf")
    with open(path, "w") as f:
        f.write(head + net + f"seed = {SEED}\n")
    return path


def _plain_random(lay, params, x, u, step):
    """The plain formula of a random layer in training on draws ``u``."""
    import torch

    from cxxnet_tpu_torch.ops import maxpool as ops_mp

    kind = lay.type_name
    if kind == "insanity":
        lb, ub = lay.interval(step)
        return torch.where(x > 0, x, x / (u * (ub - lb) + lb))
    if kind == "prelu":
        mask = torch.clamp(params["bias"] * (1.0 + (u * 2.0 - 1.0)
                                             * lay.random), 0.0, 1.0)
        return torch.where(x > 0, x, x * mask)
    n, h, w, c = x.shape
    i = torch.arange(h, device=x.device)
    j = torch.arange(w, device=x.device)
    up = x[:, (i - 1).clamp(min=0)]
    down = x[:, (i + 1).clamp(max=h - 1)]
    left = x[:, :, (j - 1).clamp(min=0)]
    right = x[:, :, (j + 1).clamp(max=w - 1)]
    k, d = lay.p_keep, (1.0 - lay.p_keep) / 4.0
    xj = torch.where(u < k, x, torch.where(u < k + d, up, torch.where(
        u < k + 2 * d, down, torch.where(u < k + 3 * d, left, right))))
    p = lay.param
    return ops_mp.maxpool_plain(xj, p.kernel_height, p.kernel_width,
                                p.stride, p.pad_y, p.pad_x)


def _random_checks(tr, dev):
    """Each random layer of ``tr``'s net in training on the card against
    its plain formula fed the same on-card draws (a generator of one
    seed twice); returns ``{layer: max abs error}``, each required 0."""
    import torch

    errs = {}
    for i, spec in enumerate(tr.graph.layers):
        lay = tr.net.layer_objs[i]
        kind = getattr(lay, "type_name", "")
        if kind not in ("insanity", "prelu", "insanity_max_pooling"):
            continue
        if kind == "prelu" and not lay.random:
            continue
        shape = tr.net.node_shapes[spec.nindex_in[0]]
        x = torch.randn(shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(i))
        key = tr.net.param_key[i]
        params = lay.prepare(tr.params[key], torch.float32) if (
            key in tr.params) else {}
        step = 0  # insanity's full interval (past the calm window the
        # slope is the midpoint's, as at eval)
        with torch.no_grad():
            got = lay.apply(params, [x], train=True, gen=torch.Generator(
                device=dev).manual_seed(SEED + i), step=step)[0]
            u = torch.rand(x.shape, device=dev, generator=torch.Generator(
                device=dev).manual_seed(SEED + i))
            plain = _plain_random(lay, params, x, u, step)
            still = lay.apply(params, [x], train=False, step=step)[0]
        name = f"{spec.name or kind}@{i}"
        errs[name] = float((got - plain).abs().max())
        if errs[name] != 0.0 or torch.equal(got, still):
            raise SmokeError(f"{name}: training output against its plain "
                             f"formula {errs[name]} (must be 0), or equal "
                             "to the eval output")
    return errs


def ndsb_phase(tmp: str, card: str):
    """22c: bowl.conf's net, relu replaced by xelu (b 5.5; a ``torch:``
    Conv2d for conv4), prelu (slope jitter 0.1; the last pool a
    ``pairtest-max_pooling-insanity_max_pooling``) and insanity (lb 3,
    ub 8, calm window inside the run; the pools insanity_max_pooling,
    keep 0.9); the side feature through fixconn -> bias -> softplus
    beside the flatten output; ``task=train`` 2 rounds of 10 steps from
    csv -> attachtxt -> membuffer.  Every step K1 3 and K2 3 on the f32
    vector entries and K8 once (counts at 0 just before each run); every
    loss finite; the random layers on the card against their plain
    formulas on the same draws; each variant's eval forward (f32, TF32
    off) card against CPU within ``F32_PROB_ATOL``; the torch: layer's
    blobs through ``save_model``; the pairtest's ``compare`` 0."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    d = os.path.join(tmp, "ndsb")
    os.makedirs(d)
    rows, feats = _ndsb_data(d)
    x = rows[:64, 1:].reshape(64, 3, BOWL_SIDE, BOWL_SIDE).transpose(
        0, 2, 3, 1).copy()
    extras = [feats[:64]]
    out = {}
    for variant in NDSB_VARIANTS:
        conf = _ndsb_conf(d, variant)
        mdir = os.path.join(d, f"m_{variant}")
        t0 = time.perf_counter()
        _, tr, steps, losses, marks = _run_train_task(
            [conf, "task=train", "dev=gpu", f"num_round={NDSB_ROUNDS}",
             f"max_round={NDSB_ROUNDS}", f"model_dir={mdir}",
             "print_step=0"])
        wall = time.perf_counter() - t0
        n_steps = NDSB_ROUNDS * NDSB_ROWS // tr.batch_size
        if len(steps) != n_steps or not all(np.isfinite(losses)):
            raise SmokeError(f"ndsb {variant}: {len(steps)} steps (want "
                             f"{n_steps}), losses {losses}")
        _hold_steps(f"ndsb {variant}", steps, tr.paths, NDSB_PER_STEP)
        dev = tr.device
        ends = [m[2] for m in marks if m[0] == "step"]
        step_ms = statistics.median(np.diff(ends)) * 1e3
        row = {"steps": len(steps), "per_step": steps[0],
               "loss_first_last": [losses[0], losses[-1]],
               "median_step_ms": step_ms, "wall_s": round(wall, 2),
               "random_layers": _random_checks(tr, dev)}
        last = os.path.join(mdir, f"{NDSB_ROUNDS:04d}.model")
        cfg = cfgmod.parse_file(conf)
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            probs = {}
            for where in ("gpu", "cpu"):
                ev = NetTrainer()
                ev.set_params(cfg + [("dev", where), ("silent", "1")])
                ev.load_model(last)
                probs[where] = ev.predict_fn()(ev.params, ev.aux, x,
                                               extras).cpu().numpy()
                if where == "gpu":
                    card_tr = ev
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        err = float(np.abs(probs["gpu"] - probs["cpu"]).max())
        row["card_vs_cpu_prob_abs"] = err
        if (probs["gpu"].shape != (64, BOWL_CLASSES) or err > F32_PROB_ATOL
                or not np.isfinite(probs["gpu"]).all()):
            raise SmokeError(f"ndsb {variant}: eval card vs CPU {err} "
                             f"(limit {F32_PROB_ATOL}), shape "
                             f"{probs['gpu'].shape}")
        if variant == "xelu":
            key = next(tr.net.param_key[i] for i, spec in
                       enumerate(tr.graph.layers) if spec.name == "conv4")
            blobs = tr.params[key]
            back = card_tr.params[key]
            first = NetTrainer._read_model_file(
                os.path.join(mdir, "0000.model"))[1][key]
            if (sorted(blobs) != ["blob0", "blob1"] or any(
                    not torch.equal(blobs[t], back[t]) for t in blobs)
                    or np.array_equal(first["blob0"],
                                      blobs["blob0"].cpu().numpy())):
                raise SmokeError("ndsb xelu: the torch: layer's blobs did not "
                                 "train or did not round-trip save_model")
            row["torch_blobs"] = {t: list(w.shape) for t, w in blobs.items()}
        if variant == "prelu":
            i = next(i for i, spec in enumerate(card_tr.graph.layers)
                     if spec.type_name.startswith("pairtest-"))
            net = card_tr.net
            with torch.inference_mode():
                nodes = net.forward(card_tr._prepared_for(card_tr.params),
                                    torch.from_numpy(x).to(dev),
                                    extras=[torch.from_numpy(e).to(dev)
                                            for e in extras])
                cmp = float(net.layer_objs[i].compare(
                    {}, [nodes[card_tr.graph.layers[i].nindex_in[0]]]))
            row["pairtest_compare"] = cmp
            if cmp != 0.0:
                raise SmokeError(f"ndsb prelu: pairtest compare {cmp}")
        if variant == "insanity":
            ins = next(lay for lay in tr.net.layer_objs
                       if getattr(lay, "type_name", "") == "insanity")
            row["insanity_interval"] = {
                s: ins.interval(s) for s in (0, 10, tr.epoch_counter)}
            if (ins.interval(0) != (3.0, 8.0)
                    or ins.interval(tr.epoch_counter) != (5.5, 5.5)):
                raise SmokeError(f"ndsb insanity: interval "
                                 f"{row['insanity_interval']}")
        log(f"ndsb {variant}: {json.dumps(row)}")
        out[variant] = row
    return out


# ----------------------------------------------------------------------
# phase 23: the library API, the C ABI and the observability plane

LIB_PER_STEP = IMGBIN_PER_STEP  # one GoogLeNet step: K1-K6 and K8 once
LIB_JPEG_ROWS = 4 * BATCH  # JPEG records of 23a: four steps a round
# the records' contrast: 128 + U{-2..2} upsampled, plus N(0, 1) noise.
# googlenet.conf's section subtracts the mean image and scales nothing,
# and from the seeded init at 0.01x the conf's rates an input of std ~50
# (the JPEG check's records) takes the loss to 1e12 and NaN in two steps
LIB_JPEG_AMP, LIB_JPEG_NOISE = 2, 1.0
LIB_PREDICT_ROWS = 100  # a raw array, bucket 128
LIB_SCAN_K = 4
# update_scan against K update() steps from one state (cuDNN
# deterministic): each tensor within LIB_SCAN_REL of its largest update,
# the losses within LIB_SCAN_REL relatively; both are the same calls
LIB_SCAN_REL = 1e-6
LIB_TIMED_STEPS = 2  # steps a turn in the step-time turns
CAPI_STEPS = 3  # CXNNetUpdateBatch steps on ResNet-50, counted
CAPI_HOST_DEV = "gpu"  # the C host's device (argv[1])
OBS_JSON_ROWS = (1, 7)
OBS_BINARY_ROWS = (1, 32)
OBS_TIMED_STEPS = 3
OBS_RENDERS = 10


def _jpeg_pages(path: str, rows: int, side: int, seed: int) -> float:
    """``path``.bin/.lst: ``rows`` JPEG records made with PIL (a seeded
    8x8 image of 128 + U{-LIB_JPEG_AMP..LIB_JPEG_AMP} upsampled to
    ``side``, plus N(0, LIB_JPEG_NOISE), quality 90), seeded labels;
    returns the mean bytes a record."""
    import io

    import numpy as np
    from PIL import Image

    from cxxnet_tpu_torch.io.imgbin import BinPageWriter

    rng = np.random.RandomState(seed)
    nbytes = 0
    w = BinPageWriter(path + ".bin")
    with open(path + ".lst", "w") as f:
        for i in range(rows):
            low = Image.fromarray((128 + rng.randint(
                -LIB_JPEG_AMP, LIB_JPEG_AMP + 1, (8, 8, 3))).astype(np.uint8))
            img = np.asarray(low.resize((side, side), Image.BILINEAR),
                             np.float32)
            img += rng.standard_normal(img.shape) * LIB_JPEG_NOISE
            buf = io.BytesIO()
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                buf, "JPEG", quality=90)
            nbytes += len(buf.getvalue())
            w.push(buf.getvalue())
            f.write(f"{i}\t{rng.randint(0, 1000)}\trec{i}.jpg\n")
    w.close()
    return nbytes / rows


def _data_section(shard: str, mean: str, native: int = 1) -> str:
    """googlenet.conf's own data section as text, its shard and mean
    image paths changed and ``native_decoder`` set, with the globals a
    ``DataIter`` reads."""
    text = open(CONF).read()
    start = text.index("data = train")
    sec = text[start:text.index("iter = end", start) + len("iter = end")]
    for old, new in (
            ("  image_list = ./shards/train_001.lst\n"
             "  image_bin = ./shards/train_001.bin\n",
             f"  image_list = {shard}.lst\n  image_bin = {shard}.bin\n"
             f"  native_decoder = {native}\n"),
            ("./models/image_mean.bin", mean)):
        if old not in sec:
            raise SmokeError(f"googlenet.conf: {old.strip()!r} not found")
        sec = sec.replace(old, new, 1)
    return (sec + f"\ninput_shape = 3,{CONF_SIDE},{CONF_SIDE}\n"
            f"batch_size = {BATCH}\nsilent = 1\n")


_VEHICLE: dict = {}


def _resnet_vehicle() -> str:
    """resnet50.conf with one bottleneck block a stage, at the same
    widths (written once, to a temporary file): phases 23 and 24 drive
    host machinery on it (the C ABI, obs, the tuner, the durable path).
    Each stage keeps its first block, whose projection shortcut and 1x1
    reduce read one node, so a step still launches K1, K2, four K6
    groups and K8 on the same C entries as ResNet-50's."""
    if "path" in _VEHICLE:
        return _VEHICLE["path"]
    with open(RESNET_CONF) as f:
        lines = f.read().splitlines()
    blocks = re.findall(r"\[\S*->(s(\d)b(\d+))\]", "\n".join(lines))
    last = {}
    for node, st, b in blocks:
        if node == f"s{st}b{b}":
            last[st] = max(last.get(st, 0), int(b))
    rename = {f"s{st}b{b}": f"s{st}b0" for st, b in last.items()}
    out, drop = [], False
    for line in lines:
        m = re.match(r"layer\[(\S+)->(\S+)\]", line)
        if m:
            drop = re.match(r"s\d+b(\d+)", m.group(2)) is not None and \
                re.match(r"s\d+b(\d+)", m.group(2)).group(1) != "0"
            if not drop:
                ins = ",".join(rename.get(n, n)
                               for n in m.group(1).split(","))
                line = f"layer[{ins}->{m.group(2)}]" + line[m.end():]
        elif line.startswith("netconfig"):
            drop = False
        if not drop:
            out.append(line)
    d = tempfile.mkdtemp(prefix="chip_smoke_vehicle_")
    _VEHICLE["dir"] = d
    _VEHICLE["path"] = os.path.join(d, "resnet_vehicle.conf")
    with open(_VEHICLE["path"], "w") as f:
        f.write("\n".join(out) + "\n")
    return _VEHICLE["path"]


def _net_text(conf: str, lr_scale: float = 1.0) -> str:
    """The conf's netconfig and globals as text, its data sections
    dropped, its learning rates times ``lr_scale``."""
    from cxxnet_tpu_torch import config as cfgmod

    split = cfgmod.split_sections(cfgmod.parse_file(conf))
    lines = [f"{n} = {v}" for n, v in split.global_entries]
    if lr_scale != 1.0:
        lines += [f"{n} = {float(v) * lr_scale:g}" for n, v in
                  split.global_entries if n in ("eta", "lr", "wmat:lr",
                                                "bias:lr")]
    return "\n".join(lines) + "\n"


def _imgbin_source(it):
    """The imgbin reader at the bottom of a chain."""
    while not hasattr(it, "reader"):
        it = it.aug if hasattr(it, "aug") else it.base
    return it


def host_builds():
    """Build the port's host sources (``csrc/host``, g++/gcc, no nvcc):
    the C ABI's library and C host must build; the native page reader
    builds, or fails for want of ``jpeglib.h`` and for nothing else.
    Prints each outcome; returns ``{target: path or reason}``."""
    from cxxnet_tpu_torch.ops import _build

    out = {}
    for name in ("libcxxnet_capi", "capi_smoke", "libcxxnet_io"):
        t0 = time.perf_counter()
        try:
            out[name] = _build.build_host(name)
            log(f"host build: {name} ok in {time.perf_counter() - t0:.2f}s "
                f"({os.path.relpath(out[name], REPO)})")
        except _build.HostBuildError as e:
            errors = [ln for ln in e.log.splitlines() if "error" in ln]
            only_jpeg = (name == "libcxxnet_io" and errors
                         and all("jpeglib.h" in ln for ln in errors))
            log(f"host build: {name} FAILED: {e}")
            if not only_jpeg:
                raise SmokeError(f"host build of {name} failed:\n{e.log}")
            out[name] = str(e)
            log("host build: libcxxnet_io fails for want of jpeglib.h "
                "alone (no libjpeg headers on this machine): imgbin reads "
                "JPEG pages with the Python reader here")
    return out


def _recording_update(net_cls, steps, paths):
    """A ``Net.update`` that records each step's launches by kernel and
    the routed kernels' by C entry."""
    from cxxnet_tpu_torch.ops import KERNELS

    orig = net_cls.update

    def update(self, data, label=None):
        before = {k.name: k.launches for k in KERNELS}
        pb = _by_symbol()
        orig(self, data, label)
        steps.append({k.name: k.launches - before[k.name] for k in KERNELS})
        paths.append(_paths_since(pb))

    return orig, update


def _hold_main_steps(tag, steps, paths, per):
    from cxxnet_tpu_torch.ops import KERNELS

    want = {**{k.name: 0 for k in KERNELS}, **per}
    for i, (d, p) in enumerate(zip(steps, paths)):
        if d != want or p != _main_paths(per):
            raise SmokeError(f"{tag}: step {i} launched {d}, by C entry {p};"
                             f" expected {want}, {_main_paths(per)}")


def _turn_ms(fns, steps: int, sync, rounds: int = 2):
    """Each function run ``steps`` times then ``sync()``, in turns (a, b,
    b, a), host clock, after one untimed call of each: ms a call, per
    function in call order."""
    out = {n: [] for n in fns}
    order = list(fns.items())
    for _, fn in order:
        fn()
    sync()
    for r in range(rounds):
        for n, fn in (order if r % 2 == 0 else order[::-1]):
            sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            sync()
            out[n].append((time.perf_counter() - t0) / steps * 1e3)
    return out


def library_phase(tmp: str, card: str, builds):
    """23a: ``wrapper.DataIter`` over JPEG pages from googlenet.conf's own
    data section (``native_decoder = 1``), ``wrapper.train`` at GoogLeNet's
    full width (b128 bf16, the conf's rates times ``LR_SCALE``), every
    step K1 13, K2 4, K3 9, K4 2, K5 2, K6 9 on the main paths and K8
    once; ``Net.predict`` on a raw array of 100 rows against
    ``trainer.predict``; a conv ``wmat`` round trip; ``update_scan``
    (K = 4) against four ``update`` steps; the wrapper's step against
    the CLI's, and the chain's img/s by reader."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch import wrapper
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.ops import KERNELS

    shard = os.path.join(tmp, "jpeg")
    t0 = time.perf_counter()
    per_rec = _jpeg_pages(shard, LIB_JPEG_ROWS, IMGBIN_SIDE, SEED + 31)
    log(f"library: {LIB_JPEG_ROWS} JPEG records ({IMGBIN_SIDE}^2, "
        f"{per_rec:.0f} bytes each) made with PIL in "
        f"{time.perf_counter() - t0:.1f}s")
    mean = os.path.join(tmp, "image_mean.bin")
    data = wrapper.DataIter(_data_section(shard, mean))
    src = _imgbin_source(data._iter)
    log(f"library: DataIter reader = {src.reader}"
        + (f" ({src.reader_why})" if src.reader_why else ""))
    native_ok = not str(builds["libcxxnet_io"]).startswith("host build")
    if (src.reader == "native") != native_ok:
        raise SmokeError(f"library: the reader is {src.reader}, but the "
                         f"native build gave {builds['libcxxnet_io']}")
    cfg = _net_text(CONF, LR_SCALE)
    steps, paths = [], []
    orig, update = _recording_update(wrapper.Net, steps, paths)
    wrapper.Net.update = update
    try:
        for k in KERNELS:
            k.reset_counts()
        t0 = time.perf_counter()
        net = wrapper.train(cfg, data, 1, {"seed": str(SEED)}, dev="gpu",
                            print_step=0)
        wall = time.perf_counter() - t0
    finally:
        wrapper.Net.update = orig
    totals = {k.name: k.launches for k in KERNELS if k.launches}
    log(f"library: wrapper.train 1 round, {len(steps)} steps of {BATCH} "
        f"JPEG rows in {wall:.1f}s (mean image pass included); launches "
        f"{totals}")
    if len(steps) != LIB_JPEG_ROWS // BATCH:
        raise SmokeError(f"library: train ran {len(steps)} steps")
    _hold_main_steps("library train", steps, paths, LIB_PER_STEP)
    tr = net.trainer
    if not np.isfinite(float(tr.last_loss)):
        raise SmokeError(f"library: loss {tr.last_loss}")
    # a raw array through the bucket cache against trainer.predict
    data.before_first()
    data.next()
    x = np.array(data.get_data()[:LIB_PREDICT_ROWS])
    got = net.predict(x)
    pad = np.concatenate([x, np.zeros((BATCH - len(x),) + x.shape[1:],
                                      np.float32)])
    ref = tr.predict(pad)[:LIB_PREDICT_ROWS]
    if got.shape != (LIB_PREDICT_ROWS,) or not np.array_equal(got, ref):
        raise SmokeError("library: Net.predict on 100 rows differs from "
                         "trainer.predict")
    # the conv wmat view, round trip
    w = net.get_weight("conv1", "wmat")
    hwio = tr.params[tr.net.param_key[0]]["wmat"].cpu().numpy()
    if w.shape != (64, 147) or not np.array_equal(
            w, hwio.transpose(3, 2, 0, 1).reshape(64, 147)):
        raise SmokeError(f"library: conv1 wmat view {w.shape}")
    net.set_weight(w * 0.5, "conv1", "wmat")
    back = net.get_weight("conv1", "wmat")
    net.set_weight(w, "conv1", "wmat")
    if not (np.array_equal(back, w * 0.5)
            and np.array_equal(net.get_weight("conv1", "wmat"), w)):
        raise SmokeError("library: conv1 wmat set/get round trip differs")
    log(f"library: Net.predict on {LIB_PREDICT_ROWS} raw rows (bucket "
        f"{BATCH}) equal to trainer.predict; conv1 wmat (64, 147) set/get "
        "bit-equal")
    # update_scan (K = 4) against four update() steps from one state
    xs, ys = [], []
    data.before_first()
    while data.next() and len(xs) < LIB_SCAN_K:
        xs.append(np.array(data.get_data()))
        ys.append(np.array(data.get_label()))
    stack, lstack = np.stack(xs), np.stack(ys)
    path = os.path.join(tmp, "lib.model")
    net.save_model(path)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        nets = []
        for _ in range(2):
            n = wrapper.Net(dev="gpu", cfg=cfg + "eval_train = 0\n")
            n.load_model(path)
            nets.append(n)
        scan, loop = nets
        w0 = {(k, t): v.clone() for k, tags in loop.trainer.params.items()
              for t, v in tags.items()}
        sl = scan.update_scan(stack, lstack)
        ll = []
        for i in range(LIB_SCAN_K):
            loop.update(stack[i], lstack[i])
            ll.append(float(loop.trainer.last_loss))
        ll = np.asarray(ll, np.float32)
        worst = 0.0
        for (k, t), v0 in w0.items():
            a = scan.trainer.params[k][t].float()
            b = loop.trainer.params[k][t].float()
            upd = float((b - v0).abs().max()) or 1.0
            worst = max(worst, float((a - b).abs().max()) / upd)
    finally:
        torch.backends.cudnn.deterministic = saved
    loss_rel = float(np.max(np.abs(sl - ll) / np.maximum(np.abs(ll), 1e-12)))
    log(f"library: update_scan K={LIB_SCAN_K} losses "
        f"{[round(float(v), 5) for v in sl]} vs update() {ll.tolist()}: "
        f"loss rel {loss_rel:.3g}, weights {worst:.3g} of each tensor's "
        f"largest update (limit {LIB_SCAN_REL:g})")
    if loss_rel > LIB_SCAN_REL or worst > LIB_SCAN_REL:
        raise SmokeError("library: update_scan differs from update()")
    # the wrapper's step against the CLI's (trainer.update on a batch)
    lt = loop.trainer
    bx, by = stack[0], lstack[0]
    times = _turn_ms({"wrapper": lambda: loop.update(bx, by),
                      "cli": lambda: lt.update(DataBatch(data=bx, label=by))},
                     LIB_TIMED_STEPS, lt.sync)
    log(f"library: step ms (b{BATCH}, {LIB_TIMED_STEPS} a turn, host clock)"
        f" {json.dumps({k: [round(v, 2) for v in t] for k, t in times.items()})}"
        f"; {card}")
    del scan, loop, nets
    # the chain's rate by reader: one pass, median of IMGBIN_PASSES
    rates = {src.reader: _rate(lambda: _drain(data), LIB_JPEG_ROWS)}
    data.close()
    if src.reader == "native":
        py = wrapper.DataIter(_data_section(shard, mean + ".npz", native=0))
        rates["python"] = _rate(lambda: _drain(py), LIB_JPEG_ROWS)
        py.close()
    log(f"library: chain img/s by reader (googlenet.conf's section, 1 "
        f"decode worker, host clock) "
        f"{json.dumps({k: round(v, 1) for k, v in rates.items()})}; {card}")
    return {"steps": len(steps), "launches": totals,
            "per_step": LIB_PER_STEP, "reader": src.reader,
            "reader_why": src.reader_why, "step_ms": times,
            "scan_loss_rel": loss_rel, "scan_weight_rel": worst,
            "chain_img_s": rates}


def _capi(path: str):
    """The port's C ABI library loaded into this process by ``ctypes``
    (it takes the Python C API from this interpreter), argtypes set."""
    import ctypes as C

    lib = C.CDLL(path)
    P, F, U = C.c_void_p, C.POINTER(C.c_float), C.c_uint
    sig = {
        "CXNGetLastError": (C.c_char_p, []),
        "CXNNetCreate": (P, [C.c_char_p, C.c_char_p]),
        "CXNNetSetParam": (C.c_int, [P, C.c_char_p, C.c_char_p]),
        "CXNNetInitModel": (C.c_int, [P]),
        "CXNNetSaveModel": (C.c_int, [P, C.c_char_p]),
        "CXNNetUpdateBatch": (C.c_int, [P, F, U * 4, F, U * 2]),
        "CXNNetPredictBatch": (F, [P, F, U * 4, C.POINTER(U)]),
        "CXNNetGetWeight": (F, [P, C.c_char_p, C.c_char_p, U * 2]),
        "CXNNetSetWeight": (C.c_int, [P, F, U, C.c_char_p, C.c_char_p]),
        "CXNNetFree": (None, [P]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def capi_phase(tmp: str, card: str, builds):
    """23b: ResNet-50 at full width, one block a stage
    (``_resnet_vehicle``), through the C ABI in this process:
    ``CXNNetCreate("gpu")``, init, three ``CXNNetUpdateBatch`` (each K1 1,
    K2 1, K6 4 on the main paths, K8 1), ``CXNNetPredictBatch`` bit-equal
    to ``Net.predict`` on the same weights, a weight round trip, the
    error path, ``CXNNetUpdateBatch`` against ``trainer.update`` in turns;
    then the C host in a subprocess on the card."""
    import ctypes as C

    import numpy as np
    import torch

    from cxxnet_tpu_torch import wrapper
    from cxxnet_tpu_torch.ops import KERNELS

    from cxxnet_tpu_torch import config as cfgmod

    lib = _capi(builds["libcxxnet_capi"])
    F = C.POINTER(C.c_float)
    cfg = _net_text(_resnet_vehicle())
    side = int(dict(cfgmod.parse_file(_resnet_vehicle()))["input_shape"].split(
        ",")[1])
    h = lib.CXNNetCreate(b"gpu", cfg.encode())
    if not h or lib.CXNNetSetParam(h, b"seed", str(SEED).encode()) != 0 \
            or lib.CXNNetInitModel(h) != 0:
        raise SmokeError(f"capi: create/init failed: {lib.CXNGetLastError()}")
    rng = np.random.RandomState(SEED + 41)
    x = rng.standard_normal((RESNET_BATCH, side, side, 3)).astype(np.float32)
    y = rng.randint(0, 1000, (RESNET_BATCH, 1)).astype(np.float32)
    xs, ys = (C.c_uint * 4)(*x.shape), (C.c_uint * 2)(*y.shape)
    xp, yp = x.ctypes.data_as(F), y.ctypes.data_as(F)

    def c_step():
        if lib.CXNNetUpdateBatch(h, xp, xs, yp, ys) != 0:
            raise SmokeError(f"capi: update failed: {lib.CXNGetLastError()}")

    steps, paths = [], []
    for k in KERNELS:
        k.reset_counts()
    for _ in range(CAPI_STEPS):
        before = {k.name: k.launches for k in KERNELS}
        pb = _by_symbol()
        c_step()
        steps.append({k.name: k.launches - before[k.name] for k in KERNELS})
        paths.append(_paths_since(pb))
    torch.cuda.synchronize()
    totals = {k.name: k.launches for k in KERNELS if k.launches}
    _hold_main_steps("capi", steps, paths, RESNET_PER_STEP)
    log(f"capi: {CAPI_STEPS} CXNNetUpdateBatch steps of ResNet-50 "
        "(one block a stage) b"
        f"{RESNET_BATCH} bf16 on the card; launches {totals}")
    path = os.path.join(tmp, "capi.model")
    if lib.CXNNetSaveModel(h, path.encode()) != 0:
        raise SmokeError(f"capi: save failed: {lib.CXNGetLastError()}")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        inet = wrapper.Net(dev="gpu", cfg=cfg)
        inet.load_model(path)
        n = C.c_uint()
        out = lib.CXNNetPredictBatch(h, xp, xs, C.byref(n))
        if not out:
            raise SmokeError(f"capi: predict: {lib.CXNGetLastError()}")
        got = np.ctypeslib.as_array(out, (n.value,)).copy()
        ref = inet.predict(x)
    finally:
        torch.backends.cudnn.deterministic = saved
    if not np.array_equal(got, ref):
        raise SmokeError(f"capi: CXNNetPredictBatch differs from Net.predict"
                         f" on {int((got != ref).sum())} of {len(ref)} rows")
    ws = (C.c_uint * 2)()
    w = lib.CXNNetGetWeight(h, b"conv1", b"wmat", ws)
    wv = np.ctypeslib.as_array(w, (ws[0], ws[1])).copy()
    new = wv * 0.5
    if lib.CXNNetSetWeight(h, new.ctypes.data_as(F), new.size, b"conv1",
                           b"wmat") != 0:
        raise SmokeError(f"capi: set weight: {lib.CXNGetLastError()}")
    w2 = lib.CXNNetGetWeight(h, b"conv1", b"wmat", ws)
    if (tuple(ws) != (64, 147) or not np.array_equal(
            np.ctypeslib.as_array(w2, (ws[0], ws[1])), new)
            or not np.array_equal(inet.get_weight("conv1", "wmat"), wv)):
        raise SmokeError("capi: conv1 wmat set/get round trip differs")
    miss = lib.CXNNetGetWeight(h, b"no_such_layer", b"wmat", ws)
    err1 = lib.CXNGetLastError().decode()
    bad = (C.c_uint * 4)(2, 8, 8, 3)
    small = np.zeros((2, 8, 8, 3), np.float32)
    out = lib.CXNNetPredictBatch(h, small.ctypes.data_as(F), bad, C.byref(n))
    err2 = lib.CXNGetLastError().decode()
    if miss or out or "no_such_layer" not in err1 \
            or not err2.startswith("net_predict_batch: "):
        raise SmokeError(f"capi: error path: {bool(miss)} {err1!r}, "
                         f"{bool(out)} {err2!r}")
    log(f"capi: CXNNetPredictBatch bit-equal to Net.predict ({len(ref)} "
        f"rows); conv1 wmat set/get bit-equal; errors {err1!r}, {err2!r}")
    it = inet.trainer
    from cxxnet_tpu_torch.io.data import DataBatch

    times = _turn_ms({"capi": c_step,
                      "trainer": lambda: it.update(DataBatch(data=x,
                                                             label=y))},
                     LIB_TIMED_STEPS, torch.cuda.synchronize)
    lib.CXNNetFree(h)
    del inet, it
    log(f"capi: step ms, CXNNetUpdateBatch ({x.nbytes} bytes f32 marshalled)"
        f" against trainer.update, {LIB_TIMED_STEPS} a turn, host clock "
        f"{json.dumps({k: [round(v, 2) for v in t] for k, t in times.items()})}"
        f"; {card}")
    env = dict(os.environ, CXXNET_TPU_HOME=REPO, TMPDIR=tmp,
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    t0 = time.perf_counter()
    r = subprocess.run([builds["capi_smoke"], CAPI_HOST_DEV],
                       capture_output=True,
                       text=True, timeout=600, env=env, cwd=tmp)
    if r.returncode != 0 or "all checks passed" not in r.stderr:
        raise SmokeError(f"capi: C host failed ({r.returncode}):\n"
                         f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    log(f"capi: C host on the card in {time.perf_counter() - t0:.1f}s: "
        + " | ".join(ln for ln in r.stderr.splitlines()
                     if ln.startswith(("capi_smoke", "eval"))))
    return {"steps": CAPI_STEPS, "launches": totals,
            "per_step": RESNET_PER_STEP, "step_ms": times,
            "batch_bytes": x.nbytes}


def _prometheus(text: str):
    """Parse Prometheus text (0.0.4): ``{sample: value}``; raises on a
    sample before its family's TYPE line, a bad name, label set or
    value, or a histogram whose buckets fall or whose +Inf bucket is not
    its count."""
    import re

    types, samples = {}, {}
    line_re = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
                         r'(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
                         r',?)*\})? (\S+)$')
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ", 3)
            types[name] = kind
            continue
        if not ln or ln.startswith("# HELP "):
            continue
        m = line_re.match(ln)
        if not m:
            raise SmokeError(f"/metricsz: bad line {ln!r}")
        name = m.group(1)
        fam = next((f for f in (name, re.sub(r"_(bucket|sum|count)$", "",
                                             name)) if f in types), None)
        if fam is None:
            raise SmokeError(f"/metricsz: {name} before its TYPE line")
        samples[name + (m.group(2) or "")] = float(m.group(3))
    for fam, kind in types.items():
        if kind != "histogram":
            continue
        groups = {}
        for key, v in samples.items():
            if key.startswith(fam + "_bucket{"):
                inner = key[len(fam) + len("_bucket{"):-1]
                le = re.search(r'le="([^"]+)"', inner).group(1)
                rest = re.sub(r',?le="[^"]+"', "", inner).strip(",")
                groups.setdefault(rest, []).append(
                    (float("inf") if le == "+Inf" else float(le), v))
        for rest, b in groups.items():
            vals = [v for _, v in sorted(b)]
            count = samples.get(fam + "_count"
                                + (f"{{{rest}}}" if rest else ""))
            if vals != sorted(vals) or vals[-1] != count:
                raise SmokeError(f"/metricsz: histogram {fam} buckets "
                                 f"{vals}, count {count}")
    return samples


def _get_text(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.read().decode(), r.headers.get("Content-Type", "")


def _events(path: str):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def obs_phase(tmp: str, card: str):
    """23c: ResNet-50 (one block a stage, ``_resnet_vehicle``) served at
    full width with ``event_log``,
    ``trace_dir`` and two ``alert=`` rules on ``xla_device_memory_bytes``
    (one must fire, one must not): JSON and CXB1 requests, ``/metricsz``
    parsed and its request counters, peak memory against
    ``torch.cuda.max_memory_allocated()``, ``/alertz`` and ``/healthz``,
    a ``/reloadz`` swap writing ``serve.reload``; a short GoogLeNet
    ``task=train`` with ``device_sample_every = 1``; the step with obs
    armed against unarmed; the time to render ``/metricsz``."""
    import http.client

    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch import obs
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import Engine, make_server, wire

    evlog = os.path.join(tmp, "serve_events.jsonl")
    rules = [("alert", 'hbm_peak:xla_device_memory_bytes{device="cuda:0",'
                       'stat="peak_bytes_in_use"}:>:1'),
             ("alert", 'hbm_full:xla_device_memory_bytes{device="cuda:0",'
                       'stat="bytes_in_use"}:>:1e15'),
             ("alert_period_s", "0.2")]
    cfg = cfgmod.parse_file(_resnet_vehicle()) + [
        ("dev", "gpu"), ("seed", str(SEED)), ("silent", "1"),
        ("event_log", evlog), ("trace_dir", os.path.join(tmp, "strace")),
        ("trace_steps", "1000")] + rules
    obs.configure(cfg)  # as the CLI does at startup
    mdir = os.path.join(tmp, "models")
    os.makedirs(mdir)
    tr = NetTrainer()
    tr.set_params(cfg)
    tr.init_model()
    tr.save_model(os.path.join(mdir, "0001.model"), round_=1)
    eng = Engine(cfg=cfg, model_dir=mdir, max_batch_size=RESNET_BATCH)
    httpd = make_server(eng, port=0)
    th = threading.Thread(target=httpd.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    side = int(dict(cfg)["input_shape"].split(",")[1])
    try:
        port = httpd.server_port
        before = _prometheus(_get_text(port, "/metricsz")[0])
        for n in OBS_JSON_ROWS:
            out = _request(port, "/predict",
                           {"data": _rows(n, side, SEED + n).tolist()})
            if len(out["pred"]) != n:
                raise SmokeError(f"obs: JSON reply of {len(out['pred'])}")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        for n in OBS_BINARY_ROWS:
            x = _rows(n, side, SEED + 50 + n).reshape(n, side, side, 3)
            st, body = _post_on(conn, "/predict",
                                bytes(wire.encode_request(x, kind="scores")),
                                wire.CONTENT_TYPE)
            if st != 200 or wire.decode_response(body)[2].shape[0] != n:
                raise SmokeError(f"obs: binary reply {st}")
        conn.close()
        text, ctype = _get_text(port, "/metricsz")
        peak_now = torch.cuda.max_memory_allocated(0)
        after = _prometheus(text)
        n_req = len(OBS_JSON_ROWS) + len(OBS_BINARY_ROWS)

        def delta(key):
            return after.get(key, 0.0) - before.get(key, 0.0)

        got = {"requests": delta("serve_requests_total"),
               "rows": delta("serve_request_rows_total"),
               "ok": delta('serve_request_outcomes_total{outcome="ok"}'),
               "json": delta('serve_wire_requests_total{wire="json"}'),
               "binary": delta('serve_wire_requests_total{wire="binary"}')}
        want = {"requests": n_req,
                "rows": sum(OBS_JSON_ROWS) + sum(OBS_BINARY_ROWS),
                "ok": n_req, "json": len(OBS_JSON_ROWS),
                "binary": len(OBS_BINARY_ROWS)}
        peak = after.get('xla_device_memory_bytes{device="cuda:0",'
                         'stat="peak_bytes_in_use"}')
        if (got != want or peak != peak_now
                or ctype != "text/plain; version=0.0.4; charset=utf-8"):
            raise SmokeError(f"obs: /metricsz counters {got} (want {want}),"
                             f" peak {peak} vs max_memory_allocated "
                             f"{peak_now}, Content-Type {ctype!r}")
        in_use = after.get('xla_device_memory_bytes{device="cuda:0",'
                           'stat="bytes_in_use"}')
        log(f"obs: /metricsz parses ({len(after)} samples), request "
            f"counters {got}, peak_bytes_in_use {peak:.0f} == "
            f"torch.cuda.max_memory_allocated(); bytes_in_use {in_use:.0f}")
        _wait(lambda: "hbm_peak" in obs.alerts.evaluator().firing(),
              "the hbm_peak alert", timeout=30)
        alertz = _request(port, "/alertz")
        health = _request(port, "/healthz")
        states = {r["name"]: r["state"] for r in alertz["rules"]}
        if (states != {"hbm_peak": "firing", "hbm_full": "ok"}
                or alertz["firing"] != ["hbm_peak"]
                or health["status"] != "degraded"
                or "alert:hbm_peak" not in health["reasons"]):
            raise SmokeError(f"obs: /alertz {alertz}, /healthz {health}")
        log(f"obs: /alertz {states}, {alertz['evaluations']} evaluations; "
            f"/healthz {health['status']} {health['reasons']}")
        tr.save_model(os.path.join(mdir, "0002.model"), round_=2)
        del tr
        rel = _request(port, "/reloadz", {})
        reloads = [e for e in _events(evlog) if e["kind"] == "serve.reload"]
        if not (rel["swapped"] and rel["round"] == 2 and reloads
                and reloads[-1]["ok"] and reloads[-1]["round"] == 2):
            raise SmokeError(f"obs: /reloadz {rel}, events {reloads}")
        render = []
        for _ in range(OBS_RENDERS):
            t0 = time.perf_counter()
            obs.registry().render_prometheus()
            render.append((time.perf_counter() - t0) * 1e3)
        scrape = []
        for _ in range(OBS_RENDERS // 2):
            t0 = time.perf_counter()
            _get_text(port, "/metricsz")
            scrape.append((time.perf_counter() - t0) * 1e3)
        spans = [s for s in obs.tracer().spans() if s.name == "serve.batch"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
        eng.close()
    serve_kinds = [e["kind"] for e in _events(evlog)]
    if not {"serve.start", "alert.firing", "serve.reload"} <= set(
            serve_kinds) or len(spans) < n_req:
        raise SmokeError(f"obs: serve events {serve_kinds}, {len(spans)} "
                         "serve.batch spans")
    log(f"obs: serve events {serve_kinds}; {len(spans)} serve.batch spans; "
        f"render {statistics.median(render):.3f} ms, GET /metricsz "
        f"{statistics.median(scrape):.3f} ms (medians, host clock, "
        f"{len(text)} bytes); {card}")
    obs.alerts.reset()
    obs.tracer().reset()
    # a short GoogLeNet task=train with obs armed
    tdir, evtrain = os.path.join(tmp, "trace"), os.path.join(tmp, "ev.jsonl")
    conf = _synthetic_conf(tmp, "googlenet_obs.conf",
                           (("data", "train", LIB_JPEG_ROWS, True),),
                           LR_SCALE)
    hist = "train_step_device_seconds"

    def sampled():
        return obs.registry().snapshot().get(hist, {}).get(hist + "_count",
                                                           0.0)

    n0 = sampled()
    argv = [conf, "task=train", "num_round=1", "max_round=1",
            f"model_dir={os.path.join(tmp, 'gmodels')}", "save_model=1",
            f"seed={SEED}", "print_step=0", f"event_log={evtrain}",
            f"trace_dir={tdir}", "trace_steps=1000",
            "device_sample_every=1"]
    _, gtr, steps, losses, _marks = _run_train_task(argv)
    n_steps = len(steps)  # the timed steps below record into it too
    kinds = [e["kind"] for e in _events(evtrain)]
    files = os.listdir(tdir) if os.path.isdir(tdir) else []
    events = (json.load(open(os.path.join(tdir, files[0])))["traceEvents"]
              if files else [])
    xs = [e for e in events if e.get("ph") == "X"]
    rounds = {e["args"]["span_id"] for e in xs if e["name"] == "train.round"}
    parents = {e["args"].get("parent_id") for e in xs
               if e["name"] in ("train.dispatch", "train.device_wait")}
    order = [k for k in kinds if k in ("train.start", "checkpoint.save",
                                       "train.end")]
    if (order[-3:] != ["train.start", "checkpoint.save", "train.end"]
            or sampled() - n0 != n_steps or not rounds
            or parents != rounds or not all(np.isfinite(losses))):
        raise SmokeError(f"obs: train events {kinds}, sampled "
                         f"{sampled() - n0} of {n_steps} steps, trace "
                         f"{files} rounds {rounds} parents {parents}")
    log(f"obs: task=train {n_steps} steps, events {kinds}; "
        f"{hist} counts {sampled() - n0:.0f}; trace {files[0]}: "
        f"{len(xs)} spans, {len(rounds)} train.round parent(s)")
    # a step with obs armed (a span a step, the sampled wait) or not
    rng = np.random.RandomState(SEED + 43)
    batch = DataBatch(
        data=rng.standard_normal((BATCH, CONF_SIDE, CONF_SIDE, 3)).astype(
            np.float32),
        label=rng.randint(0, 1000, (BATCH, 1)).astype(np.float32))

    def armed():
        obs.device.configure([("device_sample_every", "1")])
        obs.tracer().enable()
        with obs.span("train.dispatch", steps=1):
            gtr.update(batch)

    def unarmed():
        obs.device.configure([("device_sample_every", "0")])
        obs.tracer().enabled = False
        with obs.span("train.dispatch", steps=1):
            gtr.update(batch)

    times = _turn_ms({"armed": armed, "unarmed": unarmed}, OBS_TIMED_STEPS,
                     gtr.sync)
    obs.device.configure([("device_sample_every", "0")])
    obs.tracer().reset()
    obs.events.event_log().reset()
    log(f"obs: GoogLeNet b{BATCH} step ms, obs armed against unarmed, "
        f"{OBS_TIMED_STEPS} a turn, host clock "
        f"{json.dumps({k: [round(v, 2) for v in t] for k, t in times.items()})}"
        f"; {card}")
    return {"metricsz_render_ms": statistics.median(render),
            "metricsz_get_ms": statistics.median(scrape),
            "metricsz_bytes": len(text), "peak_bytes_in_use": peak,
            "serve_events": serve_kinds, "train_events": kinds,
            "train_steps": n_steps, "step_ms": times}


# ----------------------------------------------------------------------
# phase 24: the utilities beside the trainer (diskio, profiler, the
# build cache, telemetry), the integrity plane and the tuner (ROADMAP.md
# items (h1) and (h2))

UTIL_TRAIN = (128, 128)  # two shards: two b128 steps a round
UTIL_EVAL = 128
UTIL_ROUNDS = 2
UTIL_PROFILE = (2, 2)  # profile_start, profile_steps: the second round
UTIL_FAULT_SEED = 1  # device.state's draw: a mantissa bit of a weight
UTIL_TIMED = 2  # steps a turn in the armed/unarmed turns
UTIL_PER_LEG = PER_STEP  # a shadow leg: the step's launches but K8
UTIL_KEYS = ("ts", "round", "steps", "batches", "elapsed_s", "lr", "eval",
             "step", "stages", "device", "integrity")
UTIL_STAGES = ("decode", "augment", "batch", "h2d", "device_wait")
# K1-K6 and K8 by their CUDA kernel functions' names in a trace
UTIL_SYMBOLS = {"maxpool_fwd": "maxpool_fwd_vec_kernel",
                "maxpool_bwd": "maxpool_bwd_vec_kernel",
                "maxpool_bwd_s1": "maxpool_bwd_s1_vec_kernel",
                "lrn_fwd": "lrn_fwd_vec_kernel",
                "lrn_bwd": "lrn_bwd_vec_kernel",
                "conv_block_gemm": "conv_block_wgmma_kernel",
                "sgd_update": "sgd_update_multi_kernel"}
TUNE_TRAFFIC_S = 3.0  # each run's traffic (cut for phases 28-32's time)
TUNE_CLIENTS = 4
TUNE_JSON_ROWS = (1, 2)
TUNE_BINARY_ROWS = (1, 7, 16, 32, 64)
TUNE_VERIFY = 6  # coalesced batches recomputed through trainer.predict
TUNE_FAULTS = ("serve.batch:latency:0.05", "serve.reload:ioerror:0.3")
TUNE_WARM_REPS = 9
# the first-batch check: fresh prewarmed engines, and a cold one every
# TUNE_COLD_EVERY of them, in turns; each engine takes one first batch
# at each bucket of TUNE_FIRST_BUCKETS (a request of 3/4 of the bucket's
# rows, so it pads as traffic does).  A served ResNet-50 batch at these
# buckets is host-bound, and one batch on the card's shared host spreads
# widely against its engine's warm median (prewarmed first batches read
# 0.67x to 1.48x theirs, sd 0.16), so the check holds the median, over
# the 30 (engine, bucket) pairs, of the first
# batch over its engine's
# warm median at that bucket: ~2 % of spread, where the fastest of 5
# first batches against the fastest warm ones read 1.15x with no cost
# behind it.  A prewarm that leaves a cost on most first batches still
# shows in full.
TUNE_FIRST_TRIALS = 6
TUNE_COLD_EVERY = 4
TUNE_FIRST_BUCKETS = (2, 4, 8, 16, 32)
# that median may be at most this, and the cold engines' median ratio
# must be at least this many times the prewarmed one's (~3x), so that a
# prewarm that does nothing cannot pass
TUNE_PREWARMED_MAX = 1.1
TUNE_COLD_MIN = 1.5
DURABLE_TURNS = 1


def _cache_builds(cdir: str):
    """The ten kernels built by a fresh process with ``compile_cache_dir
    = cdir``, then loaded by a second fresh process from there: ``{"build_s",
    "built", "load_s", "rebuilt"}``; fails unless the first built every
    kernel under ``cdir/kernels`` and the second built none."""
    code = (
        "import json, sys, time\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from cxxnet_tpu_torch.utils import compile_cache\n"
        "from cxxnet_tpu_torch.ops import KERNELS, _build\n"
        "compile_cache.configure([('compile_cache_dir', sys.argv[2])])\n"
        "t0 = time.perf_counter()\n"
        "built = _build.build(KERNELS)\n"
        "for k in KERNELS:\n"
        "    k._load()\n"
        "print(json.dumps({'s': time.perf_counter() - t0,\n"
        "                  'built': sorted(built),\n"
        "                  'dir': _build.BUILD_DIR,\n"
        "                  'loaded': len(_build.LOADED)}))\n")
    out = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", code, REPO, cdir],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise SmokeError(f"compile cache: {r.stderr[-2000:]}")
        out.append(json.loads(r.stdout.strip().splitlines()[-1]))
    from cxxnet_tpu_torch.ops import KERNELS

    names = sorted(k.name for k in KERNELS)
    libs = sorted(f.rsplit("-", 1)[0] for f in
                  os.listdir(os.path.join(cdir, "kernels"))
                  if f.endswith(".so"))
    first, second = out
    if (first["built"] != names or second["built"] != []
            or libs != names or second["loaded"] != len(names)
            or first["dir"] != os.path.join(cdir, "kernels")):
        raise SmokeError(f"compile cache: first process {first}, second "
                         f"{second}, libraries {libs}")
    log(f"compile cache: {len(names)} kernels built under {cdir}/kernels "
        f"in {first['s']:.1f}s by a fresh process; a second process "
        f"loaded them in {second['s']:.2f}s without a build")
    return {"build_s": first["s"], "load_s": second["s"],
            "kernels": len(names)}


def _util_argv(conf: str, tmp: str, mdir: str, *extra):
    return [conf, "task=train", "dev=gpu", f"num_round={UTIL_ROUNDS}",
            f"max_round={UTIL_ROUNDS}", f"model_dir={mdir}", f"seed={SEED}",
            "print_step=0", "integrity_every=1", "integrity_shadow=1",
            *extra]


def utilities_train_phase(tmp: str, card: str):
    """24a (see the module docstring); returns its part of the
    ``utilities`` line."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch import obs
    from cxxnet_tpu_torch.integrity import (IntegrityError, digest_array,
                                            digest_tensor)
    from cxxnet_tpu_torch.integrity.plane import check_state
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS, _build
    from cxxnet_tpu_torch.utils import compile_cache, faults
    from cxxnet_tpu_torch.utils.profiler import TraceController

    cdir = os.path.join(tmp, "cache")
    cache = _cache_builds(cdir)
    na, nb = UTIL_TRAIN
    _write_raw_shard(os.path.join(tmp, "train_a"), na, IMGBIN_SIDE,
                     SEED + 60, 0, 1000)
    _write_raw_shard(os.path.join(tmp, "train_b"), nb, IMGBIN_SIDE,
                     SEED + 61, na, 1000, ref=True)
    _write_raw_shard(os.path.join(tmp, "val"), UTIL_EVAL, IMGBIN_SIDE,
                     SEED + 62, 0, 1000)
    conf = _imgbin_conf(tmp)
    tel, ev = os.path.join(tmp, "telemetry.jsonl"), os.path.join(
        tmp, "events.jsonl")
    pdir = os.path.join(tmp, "profile")
    argv = _util_argv(conf, tmp, os.path.join(tmp, "models"),
                      "telemetry=1", f"telemetry_path={tel}", "profile=1",
                      f"profile_dir={pdir}",
                      f"profile_start={UTIL_PROFILE[0]}",
                      f"profile_steps={UTIL_PROFILE[1]}",
                      f"compile_cache_dir={cdir}", f"event_log={ev}",
                      f"fault_seed={UTIL_FAULT_SEED}",
                      "fault_inject=device.state:bitflip:1:1", "controller=1",
                      "tune_period_s=0.25")
    legs, flips = [], []
    leg, flip = NetTrainer._shadow_leg, NetTrainer.inject_bitflip

    def counted_leg(self, *a):
        before = {k.name: k.launches for k in KERNELS}
        paths = _by_symbol()
        out = leg(self, *a)
        legs.append(({k.name: k.launches - before[k.name] for k in KERNELS},
                     _paths_since(paths)))
        return out

    def watched_flip(self, rng):
        old = {f"{k}/{t}": w.clone() for k, tags in self.params.items()
               for t, w in tags.items()}
        d = flip(self, rng)
        key, tag = d["tensor"].rsplit("/", 1)
        w, was = self.params[key][tag], old[d["tensor"]]
        x = (w.reshape(-1).view(torch.int32)
             ^ was.reshape(-1).view(torch.int32))
        nz = x.nonzero().reshape(-1).tolist()
        flips.append(dict(d, changed=nz, xor=int(x[d["elem"]]) & 0xFFFFFFFF,
                          old=float(was.reshape(-1)[d["elem"]]),
                          new=float(w.reshape(-1)[d["elem"]]),
                          digest_old=digest_tensor(was),
                          digest_new=digest_tensor(w),
                          digest_host=digest_array(w.cpu().numpy())))
        return d

    NetTrainer._shadow_leg, NetTrainer.inject_bitflip = counted_leg, \
        watched_flip
    t0 = time.perf_counter()
    try:
        # the main path: counts at 0 just before, read just after
        with _Tee("stdout") as out:
            task, tr, steps, losses, _marks = _run_train_task(argv)
    finally:
        NetTrainer._shadow_leg, NetTrainer.inject_bitflip = leg, flip
        _build.set_cache_root(_build.DEFAULT_CACHE_ROOT)
        compile_cache._enabled_dir = None
        faults.reset()
    wall = time.perf_counter() - t0
    eff = obs.registry().snapshot().get("tune_effective", {})
    want_step = {**{k.name: 0 for k in KERNELS}, **IMGBIN_PER_STEP}
    want_leg = {**{k.name: 0 for k in KERNELS}, **UTIL_PER_LEG}
    n_steps = UTIL_ROUNDS * -(-sum(UTIL_TRAIN) // BATCH)
    if len(steps) != n_steps or len(legs) != 2 * UTIL_ROUNDS:
        raise SmokeError(f"utilities: {len(steps)} steps, {len(legs)} "
                         f"shadow legs")
    for i, (d, p) in enumerate(zip(steps, tr.paths)):
        if d != want_step or p != _main_paths(IMGBIN_PER_STEP):
            raise SmokeError(f"utilities: step {i} launched {d}, by C entry"
                             f" {p}; expected {want_step}")
    for i, (d, p) in enumerate(legs):
        if d != want_leg or p != _main_paths(UTIL_PER_LEG):
            raise SmokeError(f"utilities: shadow leg {i} launched {d}, by "
                             f"C entry {p}; expected {want_leg}")
    log(f"utilities: {len(steps)} steps in {wall:.1f}s (CLI run), each "
        f"{ {k: v for k, v in want_step.items() if v} } on the main paths;"
        f" {len(legs)} shadow legs, each "
        f"{ {k: v for k, v in want_leg.items() if v} }")
    events = _events(ev)
    clean = [e["round"] for e in events if e["kind"] == "integrity.clean"]
    if clean != list(range(UTIL_ROUNDS)) or any(
            e["kind"] == "integrity.detect" for e in events):
        raise SmokeError(f"utilities: integrity events "
                         f"{[e['kind'] for e in events]}")
    if len(flips) != 1:
        raise SmokeError(f"utilities: {len(flips)} bitflips")
    f = flips[0]
    if (f["changed"] != [f["elem"]] or f["xor"] != 1 << f["bit"]
            or f["digest_new"] == f["digest_old"]
            or f["digest_new"] != f["digest_host"]):
        raise SmokeError(f"utilities: bitflip {f}")
    log(f"utilities: bitflip {f['tensor']} elem {f['elem']} bit {f['bit']}:"
        f" {f['old']!r} -> {f['new']!r}, one bit; digest_tensor "
        f"{f['digest_old']} -> {f['digest_new']} == digest_array of the "
        "host copy; the vote stayed clean (one process: single-replica "
        f"groups, as in the JAX package); integrity.clean rounds {clean}, "
        "each shadow audit's two legs bitwise equal")
    recs = [json.loads(x) for x in open(tel)]
    if len(recs) != UTIL_ROUNDS or any(
            set(r) != set(UTIL_KEYS) for r in recs) or any(
            not r["stages"][s]["count"] or not r["stages"][s]["total_s"]
            for r in recs for s in UTIL_STAGES):
        raise SmokeError(f"utilities: telemetry {recs}")
    text = "".join(out.text)
    import re

    plines = [ln for ln in text.splitlines()
              if re.match(r"round +\d+ pipeline: decode ", ln)]
    slines = [ln for ln in text.splitlines()
              if re.match(r"round +\d+: step [\d.]+ ms avg \(p50 [\d.]+, "
                          r"p99 [\d.]+\), [\d.]+ samples/sec$", ln)]
    if len(plines) != UTIL_ROUNDS or len(slines) != UTIL_ROUNDS:
        raise SmokeError(f"utilities: round lines {plines} {slines}")
    log(f"utilities: telemetry {len(recs)} records, keys {sorted(recs[0])};"
        f" stages ms {({s: round(recs[-1]['stages'][s]['total_s'] * 1e3, 2) for s in UTIL_STAGES})}")
    for ln in plines + slines:
        log(f"utilities: {ln}")
    traces = sorted(os.listdir(pdir)) if os.path.isdir(pdir) else []
    if len(traces) != 1:
        raise SmokeError(f"utilities: profile_dir holds {traces}")
    trace = json.load(open(os.path.join(pdir, traces[0])))
    knames = [e.get("name", "") for e in trace["traceEvents"]
              if e.get("cat") == "kernel"]
    seen = {k: sum(sym in n for n in knames)
            for k, sym in UTIL_SYMBOLS.items()}
    if not all(seen.values()):
        raise SmokeError(f"utilities: trace kernels {seen}")
    log(f"utilities: Chrome trace {traces[0]}: {len(knames)} CUDA kernel "
        f"events; the port's by symbol {seen}")
    tuned = {k: v for k, v in eff.items() if "decode" in k}
    adjusts = [e for e in events if e["kind"] == "tune.adjust"]
    log(f"utilities: tuner (train) settled {tuned}, "
        f"{len(adjusts)} tune.adjust")
    # the costs: the digest sweep, the shadow audit, the profiler window
    dev = tr.device
    tr.sync()
    sweep = []
    for _ in range(3):
        t1 = time.perf_counter()
        v = check_state(tr)
        tr.sync()
        sweep.append((time.perf_counter() - t1) * 1e3)
    n_vals = sum(w.numel() for tags in tr.params.values()
                 for w in tags.values())
    rng = np.random.RandomState(SEED + 63)
    batch = DataBatch(
        data=torch.as_tensor(rng.standard_normal(
            (BATCH, CONF_SIDE, CONF_SIDE, 3)).astype(np.float32), device=dev),
        label=torch.as_tensor(rng.randint(0, 1000, (BATCH, 1)).astype(
            np.float32), device=dev))
    turns = _turn_ms({"step": lambda: tr.update(batch),
                      "shadow_audit": lambda: tr.shadow_step(7)}, 1,
                     tr.sync)
    armed = {"profiled": [], "plain": []}
    for r in range(2):
        for mode in (("plain", "profiled") if r % 2 else
                     ("profiled", "plain")):
            tc = TraceController()
            tc.configure([("profile", "1" if mode == "profiled" else "0"),
                          ("profile_dir", os.path.join(tmp, "p2")),
                          ("profile_start", "0"),
                          ("profile_steps", "1000")])
            tc.step(0)
            tr.sync()
            t1 = time.perf_counter()
            for _ in range(UTIL_TIMED):
                tr.update(batch)
            tr.sync()
            armed[mode].append((time.perf_counter() - t1) / UTIL_TIMED * 1e3)
            tc.close()
    log(f"utilities: digest sweep of GoogLeNet ({len(v['findings'])} "
        f"findings, {sum(1 for _ in tr.params for _ in tr.params[_])} "
        f"tensors, {n_vals} values) {[round(x, 3) for x in sweep]} ms; "
        f"shadow audit against a step, ms, in turns "
        f"{json.dumps({k: [round(x, 2) for x in t] for k, t in turns.items()})};"
        f" a step with the profiler window open against closed, ms "
        f"{json.dumps({k: [round(x, 2) for x in t] for k, t in armed.items()})}"
        f"; {card}")
    # a shadow mismatch stops the run before the round is saved
    mdir2 = os.path.join(tmp, "models_mismatch")
    try:
        _run_train_task(_util_argv(conf, tmp, mdir2,
                                   "inject_shadow_mismatch=1"))
    except IntegrityError as e:
        if e.kind != "shadow":
            raise SmokeError(f"utilities: IntegrityError of kind {e.kind}")
        err = e
    else:
        raise SmokeError("utilities: inject_shadow_mismatch did not stop "
                         "the run")
    saved = sorted(n for n in os.listdir(mdir2) if n.endswith(".model"))
    if saved != ["0000.model"]:
        raise SmokeError(f"utilities: the failing round was saved: {saved}")
    log(f"utilities: inject_shadow_mismatch=1 stopped the run ({err}); "
        f"saved {saved}")
    obs.events.event_log().reset()
    return {"steps": n_steps, "shadow_legs": 2 * UTIL_ROUNDS,
            "per_step": _main_paths(IMGBIN_PER_STEP),
            "per_leg": _main_paths(UTIL_PER_LEG),
            "bitflip": {k: f[k] for k in ("tensor", "elem", "bit")},
            "telemetry_stage_ms": {s: recs[-1]["stages"][s]["total_s"] * 1e3
                                   for s in UTIL_STAGES},
            "trace_kernels": seen, "tuned": tuned,
            "digest_sweep_ms": sweep, "digest_values": n_vals,
            "shadow_vs_step_ms": turns, "profiled_vs_plain_ms": armed,
            "compile_cache": cache}


class _TuneClient:
    """A client thread on its own kept-alive connection, sending JSON
    requests of ``TUNE_JSON_ROWS`` rows and ``CXB1`` frames of
    ``TUNE_BINARY_ROWS`` rows in turn until stopped: each request's kind,
    rows and answer, and every failure."""

    def __init__(self, port: int, side: int, seed: int):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=600)
        self.side, self.seed = side, seed
        self.log, self.errors = [], []
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)

    def _one(self, i: int):
        from cxxnet_tpu_torch.serve import wire

        kinds = [("json", n) for n in TUNE_JSON_ROWS] + [
            ("binary", n) for n in TUNE_BINARY_ROWS]
        kind, n = kinds[i % len(kinds)]
        x = _rows(n, self.side, self.seed * 100003 + i)
        if kind == "json":
            body = json.dumps({"data": x.tolist()}).encode()
            st, raw = _post_on(self.conn, "/predict", body,
                               "application/json")
            ans = json.loads(raw)["pred"] if st == 200 else None
        else:
            st, raw = _post_on(self.conn, "/predict", bytes(
                wire.encode_request(x.reshape(n, self.side, self.side, 3),
                                    kind="scores")), wire.CONTENT_TYPE)
            ans = wire.decode_response(raw)[2] if st == 200 else None
        if st != 200:
            raise SmokeError(f"status {st}: {raw[:200]!r}")
        return kind, x, ans

    def _run(self):
        i = 0
        while not self._stop.is_set():
            try:
                self.log.append(self._one(i))
            except Exception as e:  # noqa: BLE001 - counted, reported
                self.errors.append(f"{type(e).__name__}: {e}")
                return
            i += 1

    def __enter__(self):
        self._th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join(timeout=600)
        self.conn.close()


def _row_key(row) -> bytes:
    """A request row's identity: its first 32 values (of 17 levels)."""
    return row.reshape(-1)[:32].tobytes()


def tuner_serve_phase(tmp: str, card: str):
    """24b (see the module docstring); returns its part of the
    ``utilities`` line."""
    import numpy as np

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch import obs
    from cxxnet_tpu_torch.cli import LearnTask
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.serve import Engine, make_server
    from cxxnet_tpu_torch.serve.cache import ShapeBucketCache, bucket_size
    from cxxnet_tpu_torch.utils import faults

    ev = os.path.join(tmp, "serve_events.jsonl")
    cfg = cfgmod.parse_file(_resnet_vehicle()) + [
        ("dev", "gpu"), ("seed", str(SEED)), ("silent", "1"),
        ("event_log", ev), ("controller", "1"), ("tune_period_s", "0.25"),
        ("fault_seed", str(SEED + 70))] + [
        ("fault_inject", spec) for spec in TUNE_FAULTS]
    obs.configure(cfg)  # as the CLI does at startup
    faults.configure(cfg)
    mdir = os.path.join(tmp, "models")
    os.makedirs(mdir)
    tr = NetTrainer()
    tr.set_params(cfg)
    tr.init_model()
    tr.save_model(os.path.join(mdir, "0001.model"), round_=1)
    batches, kept, forwards = [], [], [0]
    run = ShapeBucketCache._run

    def recorded(self, kind, node_id, data):
        out = run(self, kind, node_id, data)
        forwards[0] += 1
        if kind == "out" and data.shape[0] and data.any():
            batches.append(([_row_key(r) for r in data], out))
            if len(kept) < TUNE_VERIFY and data.shape[0] > 1:
                kept.append((np.array(data), out))
        return out

    ShapeBucketCache._run = recorded
    eng = Engine(cfg=cfg, model_dir=mdir, max_batch_size=RESNET_BATCH,
                 reload_breaker_cooldown_s=0.5)
    task = LearnTask()
    for n, v in cfg:
        task.set_param(n, v)
    side = int(dict(cfg)["input_shape"].split(",")[1])
    httpd = make_server(eng, port=0)
    th = threading.Thread(target=httpd.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    stop = threading.Event()

    def reloads():
        while not stop.wait(0.25):
            eng.try_reload()

    rth = threading.Thread(target=reloads, daemon=True)
    rth.start()
    ctrl, clients = None, []
    try:
        ctrl = task._start_serve_controller(eng)
        if ctrl is None:
            raise SmokeError("tuner: controller = 1 started no controller")
        marks = []
        # the main path: counts at 0 just before, read just after
        for k in KERNELS:
            k.reset_counts()
        forwards[0] = 0
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            clients += [stack.enter_context(_TuneClient(
                httpd.server_port, side, SEED + 71 + c))
                for c in range(TUNE_CLIENTS)]
            while time.perf_counter() - t0 < TUNE_TRAFFIC_S:
                marks.append((time.perf_counter(),
                              eng.stats.snapshot()["batch_rows"]))
                time.sleep(0.25)
        marks.append((time.perf_counter(),
                      eng.stats.snapshot()["batch_rows"]))
        ctrl.stop()
        launches = {k.name: k.launches for k in KERNELS}
        paths = _paths_since({k.name: {} for k, _ in _routed()})
        n_fwd = forwards[0]
        live = {"max_batch_size": eng.batcher.max_batch_size,
                "batch_timeout_ms": eng.batcher.batch_timeout * 1e3}
        metricsz = _prometheus(_get_text(httpd.server_port,
                                         "/metricsz")[0])
    finally:
        stop.set()
        rth.join(timeout=60)
        if ctrl is not None:
            ctrl.stop()
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
        eng.close()
        ShapeBucketCache._run = run
        fired = faults.injector().fire_counts()
        faults.reset()
    errors = [e for c in clients for e in c.errors]
    reqs = [r for c in clients for r in c.log]
    if errors or len(reqs) < 20:
        raise SmokeError(f"tuner: {len(reqs)} requests, errors {errors[:5]}")
    per = {k: v * n_fwd for k, v in RESNET_PER_FORWARD.items()}
    if (launches != {**{k.name: 0 for k in KERNELS}, **per}
            or paths != _main_paths(per)):
        raise SmokeError(f"tuner: {n_fwd} forwards launched {launches}, "
                         f"by C entry {paths}; expected {per}")
    index = {}
    for b, (keys, _out) in enumerate(batches):
        for j, k in enumerate(keys):
            index.setdefault(k, (b, j))
    kinds = {"json": 0, "binary": 0}
    for kind, x, ans in reqs:
        b, j = index[_row_key(x[0])]
        keys, out = batches[b]
        n = x.shape[0]
        if [_row_key(r) for r in x] != keys[j:j + n]:
            raise SmokeError("tuner: a request's rows are not contiguous "
                             "in its batch")
        part = out[j:j + n]
        ok = (np.array_equal(np.asarray(ans, np.float32),
                             tr.predict_from_scores(part)) if kind == "json"
              else np.array_equal(ans, part))
        if not ok:
            raise SmokeError(f"tuner: a {kind} answer of {n} rows is not "
                             "its batch's output")
        kinds[kind] += 1
    worst = 0.0
    for data, out in kept:
        n = data.shape[0]
        b = bucket_size(n)
        pad = np.concatenate([data, np.zeros((b - n,) + data.shape[1:],
                                             np.float32)])
        ref = tr.predict_fn()(tr.params, tr.aux, pad.reshape(
            (b,) + tr.net.input_node_shape(1)[1:]), ()).cpu().numpy()[:n]
        worst = max(worst, float(np.abs(ref - out).max()))
    if worst != 0.0 or len(kept) < 2:
        raise SmokeError(f"tuner: {len(kept)} batches against "
                         f"trainer.predict at their buckets: max abs err "
                         f"{worst}")
    log(f"tuner: {n_fwd} ResNet-50 (one block a stage) forwards launched "
        f"{per} on the main "
        f"paths; {len(reqs)} requests {kinds} from {TUNE_CLIENTS} clients "
        f"in {TUNE_TRAFFIC_S:g}s, every one answered with its slice of its"
        f" coalesced batch ({len(batches)} batches); {len(kept)} batches "
        f"equal to trainer.predict at their buckets (max abs err {worst})")
    gauges = {k: metricsz.get(f'tune_effective{{knob="{k}"}}')
              for k in live}
    events = _events(ev)
    adjusts = [e for e in events if e["kind"] == "tune.adjust"]
    prewarms = [e for e in events if e["kind"] == "tune.prewarm"]
    if (gauges != {k: float(v) for k, v in live.items()} or not adjusts
            or any(not isinstance(e.get("bucket"), int) for e in prewarms)):
        raise SmokeError(f"tuner: gauges {gauges} vs live {live}, "
                         f"{len(adjusts)} tune.adjust, prewarms {prewarms}")
    st = eng.stats.snapshot()
    if (st["reload_failures"] != fired.get("serve.reload:ioerror", 0)
            or not st["reload_failures"]):
        raise SmokeError(f"tuner: reload failures {st['reload_failures']},"
                         f" injected {fired}")

    def rate(a, b):
        return (b[1] - a[1]) / (b[0] - a[0])

    q = max(1, len(marks) // 5)
    before, after = rate(marks[0], marks[q]), rate(marks[-1 - q], marks[-1])
    log(f"tuner: /metricsz tune_effective {gauges} == the engine's live "
        f"knobs; {len(adjusts)} tune.adjust "
        f"{[(e['knob'], e['prev'], e['to']) for e in adjusts]}; "
        f"{len(prewarms)} tune.prewarm buckets "
        f"{[e['bucket'] for e in prewarms]}; served rows/s first "
        f"{before:.1f}, last {after:.1f} (host clock); faults fired "
        f"{fired}, reload failures {st['reload_failures']}; {card}")
    # the first batch after a prewarm, against a warm one and a cold one
    first = first_batch_verdict(_first_batch_times(cfg, mdir, side))
    log(f"tuner: first batches at buckets {list(TUNE_FIRST_BUCKETS)} "
        f"(host clock, {first['engines']} fresh engines in turns), each "
        f"over its engine's warm median at its bucket: median of "
        f"{len(first['ratios']['prewarmed'])} prewarmed "
        f"{first['ratio']['prewarmed']:.3f} (limit {TUNE_PREWARMED_MAX}), "
        f"of {len(first['ratios']['cold'])} cold "
        f"{first['ratio']['cold']:.3f} ({first['cold_over_prewarmed']:.2f}"
        f"x the prewarmed, at least {TUNE_COLD_MIN}x); bucket-32 first "
        f"batches ms {json.dumps(first['first_ms_32'])}; ratios "
        f"{json.dumps(first['ratios'])}")
    obs.events.event_log().reset()
    return {"requests": kinds, "batches": len(batches), "forwards": n_fwd,
            "launches": {k: v for k, v in launches.items() if v},
            "verified_batches": len(kept), "tune_effective": live,
            "adjusts": [(e["knob"], e["prev"], e["to"]) for e in adjusts],
            "prewarm_buckets": [e["bucket"] for e in prewarms],
            "rows_s_first": before, "rows_s_last": after,
            "faults_fired": fired, "reload_failures": st["reload_failures"],
            "first_batch": first}


def _first_batch_times(cfg, mdir: str, side: int) -> dict:
    """24b's first-batch check: ``TUNE_FIRST_TRIALS`` fresh prewarmed
    engines and a cold one every ``TUNE_COLD_EVERY`` of them, in turns,
    each over a fresh trainer loaded from ``mdir`` and a fresh batcher
    thread.  Each engine first serves one row (a serving engine: its
    batcher's thread has run a batch); then, bucket by bucket of
    ``TUNE_FIRST_BUCKETS``, a prewarmed one warms the bucket, and one
    request of 3/4 of its rows is timed, then ``TUNE_WARM_REPS`` more.
    Returns, by mode (``cold``, ``prewarmed``), one ``(bucket, first,
    [warm, ...])`` per engine and bucket, ms on the host clock, in run
    order."""
    import torch

    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import Engine

    xs = {b: _rows(b - b // 4, side, SEED + 90 + b)
          for b in TUNE_FIRST_BUCKETS}

    def timed(e2, x):
        t1 = time.perf_counter()
        e2.scores(x)
        return (time.perf_counter() - t1) * 1e3

    times = {"cold": [], "prewarmed": []}
    for i in range(TUNE_FIRST_TRIALS):
        modes = ["prewarmed"] + (["cold"] if i % TUNE_COLD_EVERY == 0
                                 else [])
        for mode in (modes if i % 2 == 0 else modes[::-1]):
            t2 = NetTrainer()
            t2.set_params(cfg)
            t2.load_model(os.path.join(mdir, "0001.model"))
            e2 = Engine(cfg=[(n, v) for n, v in cfg if n != "fault_inject"],
                        trainer=t2, max_batch_size=RESNET_BATCH)
            try:
                e2.scores(_rows(1, side, SEED + 91))
                for b, x in xs.items():
                    if mode == "prewarmed" and not e2._warm_bucket(
                            b, (side * side * 3,)):
                        raise SmokeError(f"tuner: the prewarm found bucket "
                                         f"{b} warm")
                    torch.cuda.synchronize()
                    first = timed(e2, x)
                    times[mode].append((b, first, [
                        timed(e2, x) for _ in range(TUNE_WARM_REPS)]))
            finally:
                e2.close()
    return times


def first_batch_verdict(times: dict) -> dict:
    """Hold ``_first_batch_times``'s readings to 24b's limits: the median,
    over the prewarmed (engine, bucket) pairs, of the first batch over
    its engine's warm median at that bucket at most
    ``TUNE_PREWARMED_MAX``, and the cold pairs' median at least
    ``TUNE_COLD_MIN`` times it.  Returns the readings and what was
    held."""
    ratios = {m: [round(first / statistics.median(warm), 4)
                  for _b, first, warm in times[m]] for m in times}
    ratio = {m: statistics.median(r) for m, r in ratios.items()}
    cold_x = ratio["cold"] / ratio["prewarmed"]
    out = {"engines": (TUNE_FIRST_TRIALS + len(times["cold"])
                       // len(TUNE_FIRST_BUCKETS)),
           "ratios": ratios, "ratio": ratio, "cold_over_prewarmed": cold_x,
           "first_ms_32": {m: [round(f, 2) for b, f, _ in times[m]
                               if b == 32] for m in times}}
    if ratio["prewarmed"] > TUNE_PREWARMED_MAX or cold_x < TUNE_COLD_MIN:
        raise SmokeError(
            f"tuner: the first batch after a prewarm must take at most "
            f"{TUNE_PREWARMED_MAX}x its engine's warm median at its bucket "
            f"(median over the engines and buckets), and a cold one at "
            f"least {TUNE_COLD_MIN}x as many: {out}")
    return out


def _plain_atomic_write(path: str, data: bytes) -> None:
    """The atomic write the port's checkpoints took before ``diskio``
    (plain ``os`` calls: temp file, fsync, rename, directory fsync), as
    the yardstick of the save's time through ``diskio``."""
    d = os.path.dirname(os.path.abspath(path))
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    fd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fingerprints_of(cfg, path: str):
    """The digests of every leaf of the checkpoint ``path`` loaded into a
    fresh trainer on the card."""
    from cxxnet_tpu_torch.integrity.plane import local_fingerprints
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    tr = NetTrainer()
    tr.set_params(cfg)
    tr.load_model(path)
    return local_fingerprints(tr)[0]


def durable_phase(tmp: str, card: str):
    """24c (see the module docstring); returns its part of the
    ``utilities`` line."""
    import errno
    import shutil

    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.integrity.plane import _leaves, check_state
    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils import checkpoint as ckpt
    from cxxnet_tpu_torch.utils import diskio, faults

    cfg = cfgmod.parse_file(_resnet_vehicle()) + [
        ("dev", "gpu"), ("seed", str(SEED)), ("silent", "1"),
        ("save_ustate", "1")]
    tr = NetTrainer()
    tr.set_params(cfg)
    tr.init_model()
    mdir = os.path.join(tmp, "models")
    os.makedirs(mdir)
    p0, p1 = (os.path.join(mdir, f"{r:04d}.model") for r in (0, 1))
    tr.save_model(p0, round_=0)
    gen = torch.Generator(device=tr.device).manual_seed(SEED + 80)
    shape = tr.net.input_node_shape(tr.batch_size)
    tr.update(DataBatch(
        data=torch.randn(shape, generator=gen, device=tr.device),
        label=torch.randint(0, 1000, (shape[0], 1), generator=gen,
                            device=tr.device).float()))
    sweep = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not check_state(tr)["clean"]:
            raise SmokeError("durable: the vote was not clean")
        sweep.append((time.perf_counter() - t0) * 1e3)
    n_leaves = len(list(_leaves(tr)))
    with diskio.recording(mdir) as rec:
        for p in (p0, ckpt.manifest_path(p0)):
            rec.ensure_known(p)
        t0 = time.perf_counter()
        tr.save_model(p1, round_=1)
        save_s = time.perf_counter() - t0
    ops = rec.ops
    nbytes = os.path.getsize(p1)
    picks, loaded = [], {}
    for k in range(len(ops) + 1):
        tree = diskio.simulate_crash(ops, k, "sync")
        state = os.path.join(tmp, f"state{k}")
        os.makedirs(state)
        diskio.write_tree(tree, state)
        found = ckpt.find_latest_valid(state, silent=True)
        if found is None or found[0] not in (0, 1):
            raise SmokeError(f"durable: crash state {k} of {len(ops)} "
                             f"holds no loadable round: {found}")
        picks.append(found[0])
        if found[0] not in loaded:
            loaded[found[0]] = _fingerprints_of(cfg, found[1])
        shutil.rmtree(state)
    ref = {r: _fingerprints_of(cfg, path) for r, path in ((0, p0), (1, p1))}
    if set(picks) != {0, 1} or any(loaded[r] != ref[r] for r in loaded):
        raise SmokeError(f"durable: crash states pick {picks}")
    log(f"durable: ResNet-50 (one block a stage) checkpoint {nbytes} "
        "bytes (f32 and ust:) saved"
        f" in {save_s:.3f}s under diskio.recording, {len(ops)} ops; every "
        f"one of {len(ops) + 1} sync crash states loads round 0 or 1 "
        f"(picks {picks}), each equal to its round's digests")
    faults.install("checkpoint.write:enospc:1:1")
    try:
        tr.save_model(os.path.join(mdir, "0002.model"), round_=2)
    except OSError as e:
        if e.errno != errno.ENOSPC:
            raise
    else:
        raise SmokeError("durable: the ENOSPC save did not raise")
    finally:
        faults.reset()
    left = sorted(os.listdir(mdir))
    found = ckpt.find_latest_valid(mdir, silent=True)
    if any(n.startswith(("0002", ".0002")) for n in left) or found[0] != 1:
        raise SmokeError(f"durable: after ENOSPC {left}, latest {found}")
    log(f"durable: checkpoint.write ENOSPC aborted the save atomically "
        f"(directory {left}; latest valid round {found[0]})")
    turns = {"diskio": [], "plain_os": []}
    plain = ckpt.atomic_write_bytes
    for r in range(DURABLE_TURNS):
        for mode in (("diskio", "plain_os") if r % 2 == 0
                     else ("plain_os", "diskio")):
            if mode == "plain_os":
                ckpt.atomic_write_bytes = _plain_atomic_write
            try:
                t0 = time.perf_counter()
                tr.save_model(os.path.join(mdir, f"t{r}{mode}.model"),
                              round_=3)
                turns[mode].append(time.perf_counter() - t0)
            finally:
                ckpt.atomic_write_bytes = plain
    log(f"durable: ResNet-50 (one block a stage) save, s, through diskio "
        f"against plain os calls in turns {json.dumps(turns)}; digest "
        "sweep of ResNet-50 "
        f"({n_leaves} leaves with ust:) {[round(x, 3) for x in sweep]} ms;"
        f" {card}")
    return {"checkpoint_bytes": nbytes, "journal_ops": len(ops),
            "crash_states": len(ops) + 1, "picks": picks,
            "save_s": turns, "digest_sweep_ms": sweep,
            "digest_leaves": n_leaves}


def utilities_phase(card: str):
    """Phase 24: 24a, 24b and 24c; returns the ``utilities`` line."""
    t0 = time.perf_counter()
    out = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_util_") as tmp:
        out["train"] = utilities_train_phase(tmp, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
        out["serve"] = tuner_serve_phase(tmp, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dur_") as tmp:
        out["durable"] = durable_phase(tmp, card)
    out["phase_s"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# phase 25: the closed loop and the data service

LOOP_TRAIN, LOOP_EVAL = (128, 128), 128  # raw records: two shards, eval
LOOP_CLIENTS = 4
LOOP_FRAME_ROWS = (1, 7, 16, 32)  # CXB1 /predict frames, all captured
LOOP_FEEDBACK_ROWS = 8  # labelled rows through JSON /feedback
LOOP_BUCKET = 32  # the bucket the published round is held at
LOOP_KEYS = ("loop_rounds_per_cycle=1", "loop_replay_ratio=0.5",
             "loop_min_records=64", "loop_max_records=128",
             "loop_max_cycles=1", "capture_predict=1",
             "loop_cycle_period_s=0.25", "publish_metric=error")
LOOP_TIMEOUT_S = 300.0  # a cycle must resolve within this
FLEET_ROWS = 32  # a tenant's CXB1 frames: 64 captured records, one cycle
SVC_ROUNDS = 2  # 2 rounds of 2 steps over LOOP_TRAIN's 256 records
SVC_FAULT = ("fault_seed=9", "fault_inject=dataservice.rpc:ioerror:0.3:3")
SVC_START_S = 120.0  # a data-service process must be ready within this
# the cache holds every block of two epochs (4 x 77 MB at b128)
SVC_SERVER_KEYS = ("silent=1", "data_service_cache_mb=1024")


class _LoopCounts:
    """Counts, across threads, every forward (``NetTrainer._forward_fn``:
    served batches, warm-ups, evaluations) and every training step
    (``NetTrainer.update``, with its host time to the card's idle, by
    thread), and every ``evaluate`` call, while installed."""

    def __init__(self):
        self.lock = threading.Lock()
        self.forwards = 0
        self.steps = []  # (thread name, start, seconds)
        self.evaluates = 0

    def __enter__(self):
        import torch

        from cxxnet_tpu_torch.nnet.trainer import NetTrainer

        self._saved = (NetTrainer._forward_fn, NetTrainer.update,
                       NetTrainer.evaluate)
        fwd, upd, ev = self._saved
        me = self

        def forward_fn(tr, node_id):
            f = fwd(tr, node_id)

            def counted(*a, **k):
                out = f(*a, **k)
                with me.lock:
                    me.forwards += 1
                return out

            return counted

        def update(tr, batch):
            t0 = time.perf_counter()
            upd(tr, batch)
            torch.cuda.synchronize()
            with me.lock:
                me.steps.append((threading.current_thread().name, t0,
                                 time.perf_counter() - t0))

        def evaluate(tr, it, name):
            with me.lock:
                me.evaluates += 1
            return ev(tr, it, name)

        NetTrainer._forward_fn, NetTrainer.update, NetTrainer.evaluate = \
            forward_fn, update, evaluate
        return self

    def __exit__(self, *exc):
        from cxxnet_tpu_torch.nnet.trainer import NetTrainer

        (NetTrainer._forward_fn, NetTrainer.update,
         NetTrainer.evaluate) = self._saved


def _hold_loop_launches(tag, counts):
    """The main-path check of a phase-25 run: every launch since the
    counts were set to 0 is one of its counted forwards' or steps'."""
    from cxxnet_tpu_torch.ops import KERNELS

    n_fwd, n_step = counts.forwards, len(counts.steps)
    want = {k: n_fwd * PER_FORWARD.get(k, 0)
            + n_step * IMGBIN_PER_STEP.get(k, 0)
            for k in {**PER_FORWARD, **IMGBIN_PER_STEP}}
    got = {k.name: k.launches for k in KERNELS}
    paths = _paths_since({k.name: {} for k, _ in _routed()})
    if (got != {**{k.name: 0 for k in KERNELS}, **want}
            or paths != _main_paths(want) or not n_step):
        raise SmokeError(f"{tag}: {n_fwd} forwards and {n_step} steps "
                         f"launched {got}, by C entry {paths}; expected "
                         f"{want}")
    return {k: v for k, v in got.items() if v}


def _step_split(counts, thread_prefix):
    """The steps of one thread: (first step s, median of the others s)."""
    mine = [dt for name, _t, dt in counts.steps
            if name.startswith(thread_prefix)]
    if not mine:
        return None, None
    rest = statistics.median(mine[1:]) if len(mine) > 1 else None
    return mine[0], rest


class _LoopClient:
    """A client thread on its own kept-alive connection sending ``CXB1``
    ``/predict`` frames of ``LOOP_FRAME_ROWS`` rows in turn (each answer
    logged with its completion time), optionally to one ``model``."""

    def __init__(self, port, side, seed, model=""):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=600)
        self.side, self.seed, self.model = side, seed, model
        self.log, self.errors = [], []
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        from cxxnet_tpu_torch.serve import wire

        i = 0
        while not self._stop.is_set():
            n = LOOP_FRAME_ROWS[i % len(LOOP_FRAME_ROWS)]
            x = _rows(n, self.side, self.seed * 100003 + i).reshape(
                n, self.side, self.side, 3)
            try:
                st, raw = _post_on(self.conn, "/predict", bytes(
                    wire.encode_request(x, kind="predict",
                                        model=self.model)),
                    wire.CONTENT_TYPE)
                if st != 200:
                    raise SmokeError(f"status {st}: {raw[:200]!r}")
                ans = wire.decode_response(raw)[2]
                if ans.shape[0] != n:
                    raise SmokeError(f"{ans.shape[0]} answers to {n} rows")
            except Exception as e:  # noqa: BLE001 - counted, reported
                self.errors.append(f"{type(e).__name__}: {e}")
                return
            self.log.append((time.perf_counter(), n))
            i += 1

    def __enter__(self):
        self._th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join(timeout=600)
        self.conn.close()


def _run_serving_task(argv, drive, tag):
    """``LearnTask().run(argv)`` of a serving task on this (the main)
    thread; once its server is bound, ``drive(httpd, engine)`` runs on a
    thread, and SIGTERM ends the task when it returns (or fails).
    Returns ``(drive's result, the task's stdout)``."""
    import signal

    from cxxnet_tpu_torch.cli import LearnTask

    box = {}

    def drive_then_stop(httpd, engine):
        try:
            box["out"] = drive(httpd, engine)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    class _Task(LearnTask):
        def _serve_until_signal(self, engine, name, on_ready, on_stop, **kw):
            def ready(httpd):
                on_ready(httpd)
                threading.Thread(target=drive_then_stop,
                                 args=(httpd, engine),
                                 daemon=True).start()

            return super()._serve_until_signal(engine, name, ready, on_stop,
                                               **kw)

    # the task installs its own handlers while it serves; ours catches
    # a SIGTERM that lands outside them (a task that failed early)
    prev = signal.signal(signal.SIGTERM, lambda *a: None)
    try:
        with _Tee("stdout") as tee:
            _Task().run(argv)
    finally:
        signal.signal(signal.SIGTERM, prev)
    text = "".join(tee.text)
    if "err" in box:
        raise SmokeError(f"{tag}: {type(box['err']).__name__}: "
                         f"{box['err']}") from box["err"]
    if "out" not in box:
        raise SmokeError(f"{tag}: the task returned before its server "
                         "was driven")
    return box["out"], text


def _cycles_hook():
    """Patch ``ContinuousLoop.run_cycle`` to record each trained cycle's
    ``(start, end, outcome, loop)``; returns ``(records, restore)``."""
    from cxxnet_tpu_torch.loop import continuous

    run = continuous.ContinuousLoop.run_cycle
    out = []

    def recorded(loop):
        t0 = time.perf_counter()
        outcome = run(loop)
        if outcome != "idle":
            out.append((t0, time.perf_counter(), outcome, loop))
        return outcome

    continuous.ContinuousLoop.run_cycle = recorded
    return out, lambda: setattr(continuous.ContinuousLoop, "run_cycle", run)


def _wait_cycle(cond, tag):
    """Wait up to ``LOOP_TIMEOUT_S`` for ``cond()``; the timeout names
    the loop's recent error events."""
    from cxxnet_tpu_torch import obs

    deadline = time.monotonic() + LOOP_TIMEOUT_S
    while not cond():
        if time.monotonic() > deadline:
            errs = [e for e in obs.recent(50)
                    if e["kind"].endswith("_error")]
            raise SmokeError(f"{tag}: no cycle resolved in "
                             f"{LOOP_TIMEOUT_S:g}s; errors {errs[-3:]}")
        time.sleep(0.05)


def _served_rates(clients, t0, t1):
    """Rows answered a second while ``[t0, t1]`` (a cycle trains) and
    before it (none does)."""
    done = sorted(e for c in clients for e in c.log)
    during = sum(n for t, n in done if t0 <= t <= t1)
    first = done[0][0] if done else t0
    before = sum(n for t, n in done if t < t0)
    return (during / (t1 - t0) if t1 > t0 else None,
            before / (t0 - first) if t0 > first else None)


def _seeded_model(cfg, path, seed):
    """A seeded GoogLeNet on the card, written as round 0 (f32)."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    tr = NetTrainer()
    tr.set_params(cfg + [("seed", str(seed))])
    tr.init_model()
    tr.save_model(path, round_=0)


def _serve_train_run(conf, mdir, ldir, ev, min_delta, side):
    """One ``task=serve_train`` run of 25a; returns what it checks."""
    import numpy as np

    from cxxnet_tpu_torch.loop import CursorFile
    from cxxnet_tpu_torch.ops import KERNELS

    fdir = os.path.join(ldir, "feedback")
    cursor0 = CursorFile(os.path.join(fdir, "cursor.json")).load()
    argv = [conf, "task=serve_train", "dev=gpu", f"model_dir={mdir}",
            f"loop_dir={ldir}", "serve_port=0", "silent=1",
            f"event_log={ev}", f"publish_min_delta={min_delta}", *LOOP_KEYS]
    cycles, restore = _cycles_hook()

    def drive(httpd, engine):
        port = httpd.server_port
        # (N, H, W, C): a record's shape fields are u16, so a flat
        # 3x224x224 row (150528 values) cannot be one
        x = _rows(LOOP_FEEDBACK_ROWS, side, SEED + 90).reshape(
            LOOP_FEEDBACK_ROWS, side, side, 3)
        labels = np.random.RandomState(SEED + 91).randint(
            0, 1000, LOOP_FEEDBACK_ROWS)
        fb = _request(port, "/feedback", {"data": x.tolist(),
                                          "label": labels.tolist()})
        if fb["appended"] != LOOP_FEEDBACK_ROWS:
            raise SmokeError(f"serve_train: /feedback answered {fb}")
        with contextlib.ExitStack() as stack:
            clients = [stack.enter_context(_LoopClient(port, side,
                                                       SEED + 92 + c))
                       for c in range(LOOP_CLIENTS)]
            _wait_cycle(lambda: cycles or any(c.errors for c in clients),
                        "serve_train")
        errors = [e for c in clients for e in c.errors]
        sent = sum(len(c.log) for c in clients)
        if errors or not cycles or sent < LOOP_CLIENTS:
            raise SmokeError(f"serve_train: {sent} requests answered, "
                             f"errors {errors[:5]}")
        t0, t1, outcome, loop = cycles[0]
        out = {"fb": fb, "requests": sent,
               "rows": sum(n for c in clients for _t, n in c.log),
               "outcome": outcome, "cycle_s": t1 - t0,
               "rows_s": _served_rates(clients, t0, t1),
               "round": engine.healthz()["round"],
               "cursor": loop.cursor_file.load(), "reload_s":
               engine.last_reload_s}
        if outcome == "published":
            _wait(lambda: engine.round == 1, "the hot reload", 120)
            rows = _rows(LOOP_BUCKET, side, SEED + 93).reshape(
                LOOP_BUCKET, side, side, 3)
            import http.client

            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=600)
            try:
                out["bucket_rows"] = rows
                out["bucket_scores"] = np.array(_wire_scores(conn, rows))
            finally:
                conn.close()
            out["round"] = engine.healthz()["round"]
        return out

    with _LoopCounts() as counts:
        for k in KERNELS:
            k.reset_counts()
        t0 = time.perf_counter()
        try:
            out, text = _run_serving_task(argv, drive, "serve_train")
        finally:
            restore()
        out["run_s"] = time.perf_counter() - t0
    out["launches"] = _hold_loop_launches("serve_train", counts)
    out["forwards"], out["steps"] = counts.forwards, len(counts.steps)
    out["evaluates"] = counts.evaluates
    out["step_s"] = _step_split(counts, "cxxnet-serve-train-loop")
    out["cursor0"] = cursor0
    for line in ("serve_train: serving model round 0",
                 "serve_train: shutdown complete"):
        if line not in text:
            raise SmokeError(f"serve_train: no {line!r} line")
    return out


def serve_train_phase(tmp, card, conf, side):
    """25a (see the module docstring); returns its part of the
    ``closed_loop`` line."""
    import numpy as np

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch import obs
    from cxxnet_tpu_torch.loop import feedback_log
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils import checkpoint as ckpt

    mdir, ldir = os.path.join(tmp, "st_models"), os.path.join(tmp, "st_loop")
    os.makedirs(mdir)
    cfg = cfgmod.parse_file(conf) + [("dev", "gpu")]
    _seeded_model(cfg, os.path.join(mdir, "0000.model"), SEED + 94)
    runs = []
    for i, delta in enumerate((1, -1)):
        ev = os.path.join(tmp, f"st_events_{i}.jsonl")
        runs.append(_serve_train_run(conf, mdir, ldir, ev, delta, side))
        runs[-1]["events"] = _events(ev)
        obs.events.event_log().reset()
    r1, r2 = runs
    kinds1 = [e["kind"] for e in r1["events"]]
    rb = [e for e in r1["events"] if e["kind"] == "loop.rollback"]
    if (r1["outcome"] != "rejected" or r1["round"] != 0
            or "loop.reject" not in kinds1 or not rb or not rb[0]["ok"]
            or rb[0]["round"] != 0 or r1["cursor"] == r1["cursor0"]):
        raise SmokeError(f"serve_train: run 1 {r1['outcome']}, round "
                         f"{r1['round']}, events {kinds1}, cursor "
                         f"{r1['cursor0']} -> {r1['cursor']}")
    base = [e for e in r2["events"] if e["kind"] == "loop.baseline"]
    ptr = ckpt.read_publish_pointer(mdir)
    # the ids of the pages the cycle consumed: from run 1's cursor to the
    # one run 2's cycle stored, read off the commit sidecars
    seqs = []
    c0, c1 = (r1["cursor"]["shard"], r1["cursor"]["off"]), (
        r2["cursor"]["shard"], r2["cursor"]["off"])
    for idx, path in feedback_log.list_shards(os.path.join(ldir,
                                                           "feedback")):
        for ent in feedback_log._read_commits(path):
            if c0 <= (idx, ent["off"]) and (idx, ent["off"]
                                            + ent["bytes"]) <= c1:
                seqs += range(ent["seq0"], ent["seq0"] + ent["nrec"])
    lineage = {"first_seq": min(seqs), "last_seq": max(seqs),
               "records": len(seqs), "cycles": 1}
    if (r2["outcome"] != "published" or r2["round"] != 1
            or [e["source"] for e in base] != ["recorded"]
            or r2["evaluates"] != 1 or ptr["round"] != 1
            or (ptr["prev"] or {}).get("round") != 0
            or ptr["lineage"] != lineage):
        raise SmokeError(f"serve_train: run 2 {r2['outcome']}, round "
                         f"{r2['round']}, baselines {base}, "
                         f"{r2['evaluates']} evaluations, pointer {ptr}, "
                         f"cycle's records {lineage}")
    tr = NetTrainer()
    tr.set_params(cfg)
    tr.load_model(ckpt.publish_path(mdir, 1))
    ref = tr.predict_fn()(tr.params, tr.aux, r2["bucket_rows"],
                          ()).cpu().numpy()
    if ref.tobytes() != r2["bucket_scores"].tobytes():
        raise SmokeError(
            f"serve_train: the reloaded round's {LOOP_BUCKET}-row answers "
            f"differ from trainer.predict of {ptr['path']}: max abs "
            f"{float(np.abs(ref - r2['bucket_scores']).max())}")
    del tr
    for i, r in enumerate(runs):
        first, rest = r["step_s"]
        during, before = r["rows_s"]
        log(f"serve_train run {i + 1}: {r['outcome']} in {r['cycle_s']:.2f}"
            f"s ({r['steps']} steps: the loop thread's first "
            f"{first:.3f}s, the others' median "
            f"{rest if rest is None else round(rest, 4)}s), "
            f"{r['requests']} requests ({r['rows']} rows, every one "
            f"answered), served rows/s while the cycle trains "
            f"{during if during is None else round(during, 1)} against "
            f"{before if before is None else round(before, 1)} before it "
            f"(host clock); {r['forwards']} forwards and {r['steps']} "
            f"steps launched {r['launches']} on the main paths; run "
            f"{r['run_s']:.1f}s; {card}")
    log(f"serve_train: run 1 rejected, rolled back to round 0 and moved "
        f"the cursor {r1['cursor0']} -> {r1['cursor']}; run 2 kept the "
        f"recorded baseline (no evaluation before its cycle), published "
        f"round 1 with lineage {ptr['lineage']} (this cycle's records) and "
        f"hot-reloaded it ({r2['reload_s']}s); its {LOOP_BUCKET}-row "
        "answers bit-equal to trainer.predict of the published checkpoint")
    return [{k: r[k] for k in ("outcome", "cycle_s", "steps", "forwards",
                               "requests", "rows", "rows_s", "step_s",
                               "launches", "run_s")} for r in runs]


def loop_fleet_phase(tmp, card, conf, side):
    """25b (see the module docstring); returns its part of the
    ``closed_loop`` line."""
    import http.client

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch import obs
    from cxxnet_tpu_torch.loop import publisher
    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.serve import wire

    cfg = cfgmod.parse_file(conf) + [("dev", "gpu")]
    mdirs = {}
    for i, name in enumerate(("a", "b")):
        mdirs[name] = os.path.join(tmp, f"fleet_{name}")
        os.makedirs(mdirs[name])
        _seeded_model(cfg, os.path.join(mdirs[name], "0000.model"),
                      SEED + 95 + i)
    ev = os.path.join(tmp, "fleet_events.jsonl")
    argv = [conf, "task=loop_fleet", "dev=gpu", "serve_port=0", "silent=1",
            f"loop_dir={os.path.join(tmp, 'fleet_loop')}", f"event_log={ev}",
            "publish_min_delta=-1", *LOOP_KEYS,
            "tenant=a", f"model_dir={mdirs['a']}", "tenant=end",
            "tenant=b", f"model_dir={mdirs['b']}", "tenant=end"]
    publishes, box = [], {}
    pub = publisher.EvalGatedPublisher._publish

    def rounds():
        return {n: m["round"] for n, m in json.loads(_get_text(
            box["port"], "/healthz")[0])["models"].items()}

    def watched(self, *a, **k):
        # every tenant's served round, read off /healthz as the publish
        # (and its synchronous hot reload) returns
        pub(self, *a, **k)
        publishes.append((self.tenant, rounds()))

    def drive(httpd, engine):
        port = box["port"] = httpd.server_port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        answered = 0
        try:
            st, raw = _post_on(conn, "/predict", json.dumps({
                "data": _rows(1, side, SEED + 96).reshape(
                    1, side, side, 3).tolist(),
                "model": "ghost"}).encode(), "application/json")
            if st != 404 or json.loads(raw)["reason"] != "unknown_model":
                raise SmokeError(f"loop_fleet: an unknown model got {st} "
                                 f"{raw[:200]!r}")
            st, raw = _post_on(conn, "/predict", json.dumps({
                "data": _rows(1, side, SEED + 97).reshape(
                    1, side, side, 3).tolist()}).encode(),
                "application/json")  # the default route: tenant a
            if st != 200:
                raise SmokeError(f"loop_fleet: a model-less request got "
                                 f"{st} {raw[:200]!r}")
            answered += 1
            for i, name in enumerate(("a", "b")):
                for j in range(2):  # 64 captured records: one cycle
                    x = _rows(FLEET_ROWS, side, SEED + 98 + 2 * i + j)
                    _wire_scores_as(conn, x.reshape(FLEET_ROWS, side,
                                                    side, 3), name)
                    answered += 1
                _wait_cycle(lambda: any(t == name for t, _r in publishes),
                            f"loop_fleet: tenant {name}")
            metricsz = _get_text(port, "/metricsz")[0]
            return {"answered": answered, "rounds": rounds(),
                    "knobs": [ln for ln in metricsz.splitlines()
                              if ln.startswith("tune_effective{knob="
                                               "\"tenant_rounds:")]}
        finally:
            conn.close()

    publisher.EvalGatedPublisher._publish = watched
    try:
        with _LoopCounts() as counts:
            for k in KERNELS:
                k.reset_counts()
            t0 = time.perf_counter()
            out, text = _run_serving_task(argv, drive, "loop_fleet")
            run_s = time.perf_counter() - t0
    finally:
        publisher.EvalGatedPublisher._publish = pub
    launches = _hold_loop_launches("loop_fleet", counts)
    events = _events(ev)
    obs.events.event_log().reset()
    # each tenant's round moves at its own publish only
    seen = {"a": 0, "b": 0}
    for tenant, rounds in publishes:
        seen[tenant] += 1
        if rounds != seen:
            raise SmokeError(f"loop_fleet: after {tenant}'s publish the "
                             f"rounds are {rounds}, expected {seen}")
    if (seen != {"a": 1, "b": 1} or out["rounds"] != {"a": 1, "b": 1}
            or len(out["knobs"]) != 2
            or "loop_fleet: shutdown complete" not in text):
        raise SmokeError(f"loop_fleet: publishes {publishes}, rounds "
                         f"{out['rounds']}, knobs {out['knobs']}")
    first, rest = _step_split(counts, "cxxnet-tenant-manager")
    kinds = [e["kind"] for e in events]
    log(f"loop_fleet: tenants a and b published round 1 each, each "
        f"tenant's /healthz round moving at its own publish only "
        f"{publishes}; unknown model 404 unknown_model; "
        f"{len(out['knobs'])} tenant_rounds knobs in /metricsz; "
        f"{out['answered']} requests answered; {counts.forwards} forwards "
        f"and {len(counts.steps)} steps launched {launches} on the main "
        f"paths; the scheduler thread's first step {first:.3f}s, the "
        f"others' median {rest if rest is None else round(rest, 4)}s; "
        f"{kinds.count('loop.publish')} loop.publish events; run "
        f"{run_s:.1f}s; {card}")
    return {"publishes": publishes, "launches": launches,
            "forwards": counts.forwards, "steps": len(counts.steps),
            "step_s": [first, rest], "run_s": run_s}


def _wire_scores_as(conn, rows, model):
    """A ``CXB1`` predict frame of ``rows`` to tenant ``model``."""
    from cxxnet_tpu_torch.serve import wire

    st, data = _post_on(conn, "/predict", bytes(wire.encode_request(
        rows, kind="predict", model=model)), wire.CONTENT_TYPE)
    if st != 200:
        raise SmokeError(f"loop_fleet: a frame to {model} got {st}: "
                         f"{data[:200]!r}")
    return wire.decode_response(data)[2]


def _start_service(conf, tmp, name, port=0):
    """``python -m cxxnet_tpu_torch conf task=data_service`` in a process
    of its own; waits for its ready file: ``(process, ready doc)``."""
    ready = os.path.join(tmp, f"{name}.ready.json")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch", conf,
         "task=data_service", f"data_service_port={port}",
         f"data_service_ready_file={ready}", *SVC_SERVER_KEYS],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    deadline = time.monotonic() + SVC_START_S
    while not os.path.exists(ready):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            raise SmokeError(f"data_service: not ready: "
                             f"{proc.communicate()[0][-2000:]}")
        time.sleep(0.05)
    with open(ready) as f:
        return proc, json.load(f)


def _service_section(port):
    return (f"data = train\niter = service\ndata_service_addr = "
            f"127.0.0.1:{port}\ndata_service_retry_delay_s = 0.2\n"
            "data_service_retries = 600\niter = end\n")


def data_service_phase(tmp, card, conf, side):
    """25c (see the module docstring); returns its part of the
    ``closed_loop`` line."""
    import signal
    import zlib

    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.io.augment import ANCHOR_KEY
    from cxxnet_tpu_torch.io.data import create_iterator
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils import checkpoint as ckpt
    from cxxnet_tpu_torch.utils import faults

    text = open(conf).read()
    data = text[text.index("data = train"):]
    data = data[:data.index("iter = end") + len("iter = end")] + "\n"
    net = _net_text(conf)
    svc_conf = os.path.join(tmp, "svc.conf")
    mean = os.path.join(tmp, "image_mean.bin")
    with open(svc_conf, "w") as f:  # the server's own mean image
        f.write(data.replace(mean, os.path.join(tmp, "svc_mean.bin")) + net)
    local_conf = os.path.join(tmp, "local.conf")
    with open(local_conf, "w") as f:
        f.write(data + net)
    digests = {}
    upd, start = NetTrainer.update, NetTrainer.start_round
    hook = {}

    def digest(b):
        return (zlib.crc32(np.ascontiguousarray(b.data).tobytes()),
                zlib.crc32(np.ascontiguousarray(b.label).tobytes()))

    def update(tr, batch):
        digests.setdefault(hook["run"], []).append(digest(batch))
        upd(tr, batch)

    def start_round(tr, round_):
        if round_ == 2 and "kill" in hook:
            hook.pop("kill")()
        start(tr, round_)

    def argv(c, mdir, *extra):
        return [c, "task=train", "dev=gpu", f"num_round={SVC_ROUNDS}",
                f"max_round={SVC_ROUNDS}", f"model_dir={mdir}",
                f"seed={SEED}", "print_step=0", "silent=1", *extra]

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    NetTrainer.update, NetTrainer.start_round = update, start_round
    procs = []
    try:
        # the local chain's run
        hook["run"] = "local"
        t0 = time.perf_counter()
        _task, tr_l, steps_l, _l, marks_l = _run_train_task(
            argv(local_conf, os.path.join(tmp, "m_local")))
        local_s = time.perf_counter() - t0
        rate_l = _round_rates(marks_l, BATCH, "img")
        # the service: a process of its own, 4 decode workers
        t0 = time.perf_counter()
        proc, ready = _start_service(svc_conf, tmp, "svc1")
        procs.append(proc)
        start1_s = time.perf_counter() - t0
        port = ready["port"]
        client_conf = os.path.join(tmp, "client.conf")
        with open(client_conf, "w") as f:
            f.write(_service_section(port) + net)
        second = {"digests": {}, "epoch1": threading.Event()}

        def second_client():
            try:
                split = cfgmod.split_sections(cfgmod.parse_file(client_conf))
                it = create_iterator(split.sections[0].entries)
                for n, v in split.global_entries:
                    it.set_param(n, v)
                it.init()
                try:
                    for epoch in range(1, SVC_ROUNDS + 1):
                        it.set_param(ANCHOR_KEY, str(epoch))
                        it.before_first()
                        while it.next():
                            second["digests"].setdefault(epoch, []).append(
                                digest(it.value()))
                        if epoch == 1:
                            second["epoch1"].set()
                    second["reconnects"] = it.reconnects
                finally:
                    it.close()
            except Exception as e:  # noqa: BLE001 - reported below
                second["err"] = f"{type(e).__name__}: {e}"
                second["epoch1"].set()

        def kill():
            # round 2 starts: the second client has read epoch 1 (its
            # blocks hits or misses against the trainer's), then SIGKILL
            # and a replacement on the same port
            second["epoch1"].wait(timeout=LOOP_TIMEOUT_S)
            hook["statsz"] = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{ready['http_port']}/statsz",
                timeout=60).read())
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
            hook["killed_at"] = time.perf_counter()
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cxxnet_tpu_torch", svc_conf,
                 "task=data_service", f"data_service_port={port}",
                 *SVC_SERVER_KEYS], cwd=tmp, env=dict(os.environ,
                                                 PYTHONPATH=REPO),
                stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT))

        hook["run"], hook["kill"] = "service", kill
        th = threading.Thread(target=second_client, daemon=True)
        th.start()
        t0 = time.perf_counter()
        task, tr_s, steps_s, _l, marks_s = _run_train_task(
            argv(client_conf, os.path.join(tmp, "m_svc"), *SVC_FAULT))
        svc_s = time.perf_counter() - t0
        th.join(timeout=LOOP_TIMEOUT_S)
        fired = faults.injector().fire_counts()
        faults.reset()
        rate_s = _round_rates(marks_s, BATCH, "img")
        reconnects = task.itr_train.reconnects
        # the data plane alone: one epoch read from the service (cache
        # misses, then hits), against the local chain, rows/s
        rates = {}
        for what, c, epoch in (("service_miss", client_conf, 3),
                               ("service_hit", client_conf, 3),
                               ("local", local_conf, 3)):
            split = cfgmod.split_sections(cfgmod.parse_file(c))
            it = create_iterator(split.sections[0].entries)
            for n, v in split.global_entries:
                it.set_param(n, v)
            it.init()
            try:
                t0 = time.perf_counter()
                it.set_param(ANCHOR_KEY, str(epoch))
                it.before_first()
                rows = 0
                while it.next():
                    rows += it.value().batch_size
                rates[what] = rows / (time.perf_counter() - t0)
            finally:
                it.close()
    finally:
        NetTrainer.update, NetTrainer.start_round = upd, start
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
        faults.reset()
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    if "err" in second:
        raise SmokeError(f"data_service: the second client: "
                         f"{second['err']}")
    n_steps = SVC_ROUNDS * -(-sum(LOOP_TRAIN) // BATCH)
    want = {**{k: 0 for k in steps_s[0]}, **IMGBIN_PER_STEP}
    for tag, steps, tr in (("local", steps_l, tr_l),
                           ("service", steps_s, tr_s)):
        if (len(steps) != n_steps or any(d != want for d in steps)
                or any(p != _main_paths(IMGBIN_PER_STEP) for p in tr.paths)):
            raise SmokeError(f"data_service: the {tag} run's steps "
                             f"launched {steps}, by C entry {tr.paths}; "
                             f"expected {want} each")
    crcs = {}
    for tag in ("local", "svc"):
        crcs[tag] = [ckpt.crc32_file(os.path.join(tmp, f"m_{tag}",
                                                  f"{r:04d}.model"))
                     for r in range(SVC_ROUNDS + 1)]
    per_epoch = -(-sum(LOOP_TRAIN) // BATCH)
    local = digests["local"]
    by_epoch = {e + 1: local[e * per_epoch:(e + 1) * per_epoch]
                for e in range(SVC_ROUNDS)}
    st1 = hook.get("statsz", {})
    hit_rate = st1.get("cache", {}).get("hit_rate", 0.0)
    if (digests["service"] != local or crcs["svc"] != crcs["local"]
            or second["digests"] != by_epoch or reconnects < 1
            or hit_rate <= 0 or not fired):
        raise SmokeError(
            f"data_service: batch digests equal {digests['service'] == local}"
            f", CRCs local {crcs['local']} service {crcs['svc']}, the second "
            f"client's digests equal {second['digests'] == by_epoch}, "
            f"reconnects {reconnects}, hit rate {hit_rate}, faults {fired}")
    log(f"data_service: a GoogLeNet run fed by iter = service ({SVC_ROUNDS}"
        f" rounds of {per_epoch} steps, 4 decode workers in the server) "
        f"equal to the local chain's: every batch's digest, every "
        f"checkpoint's CRC {[f'{c:08x}' for c in crcs['svc']]}; the server "
        f"SIGKILLed as round 2 began and replaced on the same port, "
        f"{reconnects} reconnects (with {fired} injected); a second client "
        f"read the same {SVC_ROUNDS} epochs bit-equal; hit rate {hit_rate:.3f}"
        f" before the kill; each step {IMGBIN_PER_STEP} on the main paths; "
        f"img/s: training rounds local {[round(r, 1) for r in rate_l]}, "
        f"service {[round(r, 1) for r in rate_s]}; one epoch read alone: "
        f"service {rates['service_miss']:.1f} (misses), "
        f"{rates['service_hit']:.1f} (hits), local chain "
        f"{rates['local']:.1f} (host clock); runs local {local_s:.1f}s, "
        f"service {svc_s:.1f}s, server start {start1_s:.1f}s; {card}")
    total = {k: v * len(steps_s) for k, v in IMGBIN_PER_STEP.items()}
    return {"crcs": crcs["svc"], "reconnects": reconnects,
            "hit_rate": hit_rate, "faults_fired": fired,
            "img_s": {"train_local": rate_l, "train_service": rate_s,
                      **rates},
            "launches": total, "steps": len(steps_s),
            "run_s": {"local": local_s, "service": svc_s,
                      "server_start": start1_s}}


def closed_loop_phase(card):
    """Phase 25: 25a, 25b and 25c over one set of raw imgbin pages;
    returns the ``closed_loop`` line."""
    import torch

    t0 = time.perf_counter()
    out = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as tmp:
        na, nb = LOOP_TRAIN
        _write_raw_shard(os.path.join(tmp, "train_a"), na, IMGBIN_SIDE,
                         SEED + 86, 0, 1000)
        _write_raw_shard(os.path.join(tmp, "train_b"), nb, IMGBIN_SIDE,
                         SEED + 87, na, 1000, ref=True)
        _write_raw_shard(os.path.join(tmp, "val"), LOOP_EVAL, IMGBIN_SIDE,
                         SEED + 88, 0, 1000)
        conf = _imgbin_conf(tmp)
        side = CONF_SIDE
        for name, fn in (("serve_train", serve_train_phase),
                         ("loop_fleet", loop_fleet_phase),
                         ("data_service", data_service_phase)):
            t1 = time.perf_counter()
            out[name] = fn(tmp, card, conf, side)
            out[f"{name}_s"] = time.perf_counter() - t1
            torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# phase 26: the serving fleet and branch-embed fusion

FLEET_REPLICAS = 3
FLEET_CLIENTS = 4
FLEET_JSON_ROWS = (1, 2, 4)  # JSON /predict rows (the router re-encodes)
FLEET_WIRE_ROWS = (1, 7, 16, 32)  # CXB1 /predict rows, relayed opaquely
FLEET_TRAFFIC_S = 8.0  # the clients' run before round 2 is written
FLEET_KILL_AT_S = 3.0  # SIGKILL of replica 1, this far into the traffic
FLEET_CHECK_ROWS = (1, 32)  # buckets held bit for bit, quiet fleet
FLEET_START_S = 180.0  # the fleet must serve k/k within this
FLEET_RECOVER_S = 120.0  # a killed replica must be healthy within this
FLEET_ROLLOUT_S = 120.0  # round 2 must reach every replica within this
FLEET_KEYS = ("silent=1", "fleet_probe_period_s=0.25",
              "fleet_probe_timeout_s=5", "fleet_restart_backoff_s=0.5",
              f"fleet_start_timeout_s={FLEET_START_S:g}",
              "batch_timeout_ms=2")
FLEET_DEV = "gpu"  # the fleets' (and so their replicas') dev: the card
FLEET_PAIRS = 10  # router vs direct bucket-1 pairs (host clock)
FLEET_RATE_S = 0.5  # each turn of the rows/s comparison
FLEET_RATE_ROWS = 32  # CXB1 frame rows of the rows/s comparison
FLEET_PERTURB = 0.01  # round 2: each weight + 0.01 x its std x N(0, 1)
CANARY_KEYS = ("canary=int8", "canary_replicas=1", "canary_slice=0.1",
               "canary_sample=1.0", "canary_min_requests=8",
               "canary_min_agreement=0.99", "canary_decision_period_s=0.5")
CANARY_ROWS = 4  # JSON rows a canary-phase request
CANARY_CENTRE_ROWS = 64  # rows whose mean features leave the classifier
CANARY_DECIDE_S = 120.0
# 26c: one bf16 path against another; the limits of bf16 against f32
# (BF16_FEAT_REL, BF16_LOGIT_REL, UPDATE_COS) hold here too.  The
# other two were set from two runs on
# the card (PERF.md): the softmax is saturated (max |diff| 1.19e-7, the
# f32 ulp at 1), and the worst step's loss differed by 1.18e-3
EMBED_PROB_ATOL = 1e-5  # the b128 forward's probabilities, fused vs plain
EMBED_LOSS_REL = 4e-3  # each step's loss, fused vs plain
EMBED_STEPS = 2


def _fleet_proc(conf, tmp, name, *keys):
    """``python -m cxxnet_tpu_torch <conf> task=serve`` with ``keys`` in a
    process of its own (its output in ``<tmp>/<name>.log``); returns
    ``(proc, front-door port, seconds to "fleet: serving k/k", log)``."""
    from cxxnet_tpu_torch.serve.fleet import free_port

    port = free_port()
    logf = os.path.join(tmp, f"{name}.log")
    n = next(int(k.split("=", 1)[1]) for k in keys
             if k.startswith("replicas="))
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    with open(logf, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cxxnet_tpu_torch", conf, "task=serve",
             f"dev={FLEET_DEV}", f"serve_port={port}", *FLEET_KEYS, *keys],
            cwd=tmp, env=env, stdout=out, stderr=subprocess.STDOUT)
    want = f"fleet: serving {n}/{n} replica(s)"
    while True:
        with open(logf) as f:
            text = f.read()
        if want in text:
            return proc, port, time.perf_counter() - t0, logf
        if proc.poll() is not None or time.perf_counter() - t0 > \
                FLEET_START_S + 30:
            _stop_fleet(proc, logf, "start", quiet=True)
            raise SmokeError(f"fleet {name}: no '{want}' (exit "
                             f"{proc.poll()}): {text[-3000:]}; "
                             f"{_fleet_logs(logf)}")
        time.sleep(0.2)


def _fleet_logs(logf):
    """The tails of the fleet's replica logs (``<model_dir>/fleet_logs``
    beside the fleet's own), for a failure's message."""
    import glob

    tails = []
    for f in sorted(glob.glob(os.path.join(os.path.dirname(logf),
                                           "models_*", "fleet_logs",
                                           "*.log"))):
        with open(f, errors="replace") as fh:
            tails.append(f"{os.path.basename(f)}: {fh.read()[-1500:]}")
    return " | ".join(tails)


def _stop_fleet(proc, logf, tag, quiet=False):
    """SIGTERM the fleet, which stops its replicas; must exit 0 with
    ``fleet: shutdown complete`` (unless ``quiet``: a failure is already
    on its way)."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise SmokeError(f"fleet {tag}: no exit 60 s after SIGTERM")
    with open(logf) as f:
        text = f.read()
    if quiet:
        return
    if proc.returncode != 0 or "fleet: shutdown complete" not in text:
        raise SmokeError(f"fleet {tag}: exit {proc.returncode}: "
                         f"{text[-3000:]}")


def _statsz(port):
    return json.loads(_get_text(port, "/statsz")[0])


def _healthz(port):
    return json.loads(_get_text(port, "/healthz")[0])


def _wire_scores_at(port, rows):
    """One ``CXB1`` scores frame of ``rows`` on a fresh connection:
    the reply's f32 rows."""
    import http.client

    from cxxnet_tpu_torch.serve import wire

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        st, raw = _post_on(conn, "/predict", bytes(wire.encode_request(
            rows, kind="scores")), wire.CONTENT_TYPE)
    finally:
        conn.close()
    if st != 200:
        raise SmokeError(f"fleet: a CXB1 frame to port {port} got {st} "
                         f"{raw[:200]!r}")
    return wire.decode_response(raw)[2]


def _engine_counted(eng, x, per, tag):
    """``eng.submit(x, kind="scores")`` with every launch counted: the
    one forward must launch ``per`` on the main paths and nothing else.
    Returns the scores and the launches."""
    import numpy as np

    from cxxnet_tpu_torch.ops import KERNELS

    before = {k.name: k.launches for k in KERNELS}
    paths = _by_symbol()
    out = np.asarray(eng.submit(x, kind="scores"))
    got = {k.name: k.launches - before[k.name] for k in KERNELS}
    want = {**{k.name: 0 for k in KERNELS}, **per}
    if got != want or _paths_since(paths) != _main_paths(per):
        raise SmokeError(f"{tag}: one forward launched {got}, by C entry "
                         f"{_paths_since(paths)}; expected {want}")
    return out, {k: v for k, v in got.items() if v}


def _replica_launches(port):
    """A replica's launches by kernel and C entry since its process
    began, from its own ``/metricsz`` (``kernel_launches_total``)."""
    out = {}
    for ln in _get_text(port, "/metricsz")[0].splitlines():
        if ln.startswith("kernel_launches_total{"):
            labels = dict(re.findall(r'(\w+)="([^"]*)"',
                                     ln[:ln.index("}")]))
            out.setdefault(labels["kernel"], {})[labels["name"]] = int(
                float(ln.split()[-1]))
    return out


def _launch_delta(after, before):
    """``after`` less ``before``, by kernel and C entry, zeros left out."""
    out = {}
    for k, syms in after.items():
        d = {s: n - before.get(k, {}).get(s, 0) for s, n in syms.items()}
        if any(d.values()):
            out[k] = {s: n for s, n in d.items() if n}
    return out


def _launch_sum(a, b):
    """Two launch readings by kernel and C entry, added."""
    out = {k: dict(v) for k, v in a.items()}
    for k, syms in b.items():
        for s, n in syms.items():
            out.setdefault(k, {})[s] = out.get(k, {}).get(s, 0) + n
    return out


def _whole_forwards(tag, delta, per, partial=False):
    """How many forwards (at least one) a replica's launches ``delta``
    are: every kernel of ``per`` on its main C entry at ``per[k]`` times
    one count, and nothing else launched; raises otherwise.  With
    ``partial`` (a reading taken under traffic) the last forward may be
    cut short, and the whole ones are counted."""
    want = {k: next(iter(v)) for k, v in _main_paths(per).items() if v}
    ratio = {delta.get(k, {}).get(s, 0) / per[k] for k, s in want.items()}
    f = min(ratio)
    whole = (max(ratio) - f < 1 if partial
             else len(ratio) == 1 and f.is_integer())
    if (not whole or f < 1 or set(delta) != set(want)
            or any(set(delta[k]) != {s} for k, s in want.items())):
        raise SmokeError(f"{tag}: the replica launched {delta}: not a "
                         f"whole number of forwards of {_main_paths(per)}")
    return int(f)


def _quiet_launches(reps, tag):
    """Each replica's launches (``reps``: name -> port) once two
    readings 0.2 s apart agree: no forward in flight."""
    prev, t0 = None, time.perf_counter()
    while True:
        now = {r: _replica_launches(p) for r, p in reps.items()}
        if now == prev:
            return now
        if time.perf_counter() - t0 > 30:
            raise SmokeError(f"{tag}: the replicas' launches still moving "
                             f"30 s after the traffic stopped: {now}")
        prev = now
        time.sleep(0.2)


def _add_launches(total, delta):
    """Add a reading by kernel and C entry into ``total`` by kernel."""
    for k, syms in delta.items():
        total[k] = total.get(k, 0) + sum(syms.values())


def _hold_buckets(tag, ports, eng, side, per, seed, launches, replicas):
    """At each of ``FLEET_CHECK_ROWS``: a ``CXB1`` scores frame of that
    many rows to every port in ``ports`` (the router or a replica, one
    at a time, the fleet otherwise idle: one batch at that bucket)
    bit-equal to the in-process engine's forward of the same rows (its
    launches counted into ``launches["reference"]``).  Each frame must
    launch one forward's kernels on their main C entries in one of
    ``replicas`` (name -> port: every replica of the fleet), read from
    the replicas' own ``/metricsz`` before and after it (in the one it
    was sent to, where that is a replica), into ``launches["fleet"]``."""
    import numpy as np

    for n in FLEET_CHECK_ROWS:
        x = _rows(n, side, seed + n).reshape(n, side, side, 3)
        ref, got = _engine_counted(eng, x, per, tag)
        for k, v in got.items():
            launches["reference"][k] = launches["reference"].get(k, 0) + v
        for name, port in ports.items():
            before = {r: _replica_launches(p) for r, p in replicas.items()}
            ans = _wire_scores_at(port, x)
            moved = {r: d for r, p in replicas.items()
                     if (d := _launch_delta(_replica_launches(p), before[r]))}
            where = f"{tag}: bucket {n} to {name}"
            if len(moved) != 1 or (name in replicas and name not in moved) \
                    or _whole_forwards(where, *moved.values(), per) != 1:
                raise SmokeError(f"{where} launched {moved} in the "
                                 f"replicas: not one forward in one replica")
            _add_launches(launches["fleet"], *moved.values())
            ref32 = ref.astype(np.float32)
            if ans.shape != ref32.shape:
                raise SmokeError(f"{where}: shape {ans.shape}, expected "
                                 f"{ref32.shape}")
            if not np.array_equal(ans.view(np.uint32), ref32.view(np.uint32)):
                raise SmokeError(
                    f"{where} is not bit-equal to the in-process engine "
                    f"(max |diff| {float(np.abs(ans - ref32).max()):.3g})")
    log(f"{tag}: buckets {FLEET_CHECK_ROWS} from {sorted(ports)} bit-equal "
        f"to the in-process engine, each one forward on the main paths in "
        f"one replica (its /metricsz)")


_EIGHTHS = [repr(k / 8) for k in range(-8, 9)]
_PIXELS = [f"[{a},{b},{c}]" for a in _EIGHTHS for b in _EIGHTHS
           for c in _EIGHTHS]


def _json_rows(n, side, seed, prio):
    """A JSON ``/predict`` body of ``_rows(n, side, seed)`` as [n][side]
    [side][3] lists, the text of each pixel taken from a table of the
    17^3 pixels there are (``json.dumps`` of the lists takes ~0.5 s a
    4-row body; this ~50 ms)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    k = rng.randint(-8, 9, size=(n, side * side * 3)).reshape(
        n, side, side, 3) + 8
    idx = (k[..., 0] * 17 + k[..., 1]) * 17 + k[..., 2]
    rows = ",".join("[" + ",".join(
        "[" + ",".join(map(_PIXELS.__getitem__, line)) + "]"
        for line in img) + "]" for img in idx.tolist())
    return f'{{"data": [{rows}], "priority": "{prio}"}}'.encode()


class _FleetClient(threading.Thread):
    """A client on its own kept-alive connection to the front door: JSON
    (``FLEET_JSON_ROWS``) and ``CXB1`` (``FLEET_WIRE_ROWS``) ``/predict``
    requests in a seeded mix, ``priority`` interactive or batch.  With
    ``fresh``, JSON requests of ``CANARY_ROWS`` rows only, each of new
    seeded rows (the canary's comparisons are all of distinct images),
    and each answer's ``pred`` kept in ``preds``.  Every answer is
    recorded as (status, kind, rows, seconds, why); a failure at the
    network layer as status 0."""

    def __init__(self, port, side, seed, stop, fresh=False):
        super().__init__(daemon=True, name=f"fleet-client-{seed}")
        import random

        from cxxnet_tpu_torch.serve import wire

        self.port, self.stop, self.side, self.seed = port, stop, side, seed
        self.fresh = fresh
        self.rng = random.Random(seed)
        self.results, self.preds = [], []
        self.bodies = []
        if fresh:
            return
        for n in FLEET_JSON_ROWS:
            for prio in ("interactive", "batch"):
                self.bodies.append(("json", n, _json_rows(
                    n, side, seed * 100 + n, prio), "application/json"))
        for n in FLEET_WIRE_ROWS:
            x = _rows(n, side, seed * 100 + 50 + n).reshape(n, side, side, 3)
            for prio in ("interactive", "batch"):
                self.bodies.append(("wire", n, bytes(wire.encode_request(
                    x, kind="scores", priority=prio)), wire.CONTENT_TYPE))

    def _next(self):
        if not self.fresh:
            return self.rng.choice(self.bodies)
        i = len(self.results)
        return ("json", CANARY_ROWS, _json_rows(
            CANARY_ROWS, self.side, self.seed * 1000 + i,
            ("interactive", "batch")[i % 2]), "application/json")

    def run(self):
        import http.client

        conn = None
        while not self.stop.is_set():
            kind, n, body, ctype = self._next()
            t0 = time.perf_counter()
            try:
                if conn is None:
                    conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                                      timeout=600)
                conn.request("POST", "/predict", body=body,
                             headers={"Content-Type": ctype})
                r = conn.getresponse()
                raw = r.read()
                st = r.status
                if r.will_close:
                    conn.close()
                    conn = None
            except (OSError, http.client.HTTPException) as e:
                st, raw = 0, repr(e).encode()
                if conn is not None:
                    conn.close()
                conn = None
            shed = st == 429 and b"load shed" in raw
            self.results.append((st, kind, n, time.perf_counter() - t0,
                                 None if st == 200 or shed else raw[:200]))
            if self.fresh and st == 200:
                self.preds.extend(json.loads(raw)["pred"])
        if conn is not None:
            conn.close()


def _failures(clients):
    """Every answer that is neither a 200 nor an admission 429."""
    return [(st, kind, n, why) for c in clients
            for st, kind, n, _dt, why in c.results
            if st != 200 and not (st == 429 and why is None)]


class _FleetWatch(threading.Thread):
    """Samples the front door's ``/statsz`` and ``/healthz`` every 0.1 s,
    and once more when stopped (a change just before the stop is seen):
    ``(t, health status, [(idx, state, round, restarts, pid)])``."""

    def __init__(self, port):
        super().__init__(daemon=True, name="fleet-watch")
        self.port, self.samples = port, []
        self.stop = threading.Event()

    def run(self):
        import http.client

        stopping = False
        while not stopping:
            stopping = self.stop.wait(0.1)
            try:
                st, h = _statsz(self.port), _healthz(self.port)
            except (OSError, ValueError, http.client.HTTPException):
                continue
            self.samples.append((time.perf_counter(), h["status"], [
                (r["idx"], r["state"], r["round"], r["restarts"], r["pid"])
                for r in st["replicas"]]))


def _round2(cfg, src, dst):
    """Round 2: round 1's weights, each tensor plus ``FLEET_PERTURB`` of
    its standard deviation times seeded normal noise, saved as round 2."""
    import torch

    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    tr = NetTrainer()
    tr.set_params(cfg)
    tr.load_model(src)
    gen = torch.Generator(device=tr.device).manual_seed(SEED + 260)
    with torch.no_grad():
        for tags in tr.params.values():
            for w in tags.values():
                if w.is_floating_point() and w.numel() > 1:
                    w.add_(torch.randn(w.shape, generator=gen,
                                       device=w.device, dtype=w.dtype)
                           * (FLEET_PERTURB * float(w.float().std())))
    tr.save_model(dst, round_=2)
    del tr


def _turns_rate(ports, side):
    """Rows/s of ``FLEET_CLIENTS`` threads of ``FLEET_RATE_ROWS``-row
    ``CXB1`` frames for ``FLEET_RATE_S`` through each port in turns
    (a, b, b, a); returns each name's rows/s in call order."""
    import http.client

    from cxxnet_tpu_torch.serve import wire

    x = _rows(FLEET_RATE_ROWS, side, SEED + 261).reshape(
        FLEET_RATE_ROWS, side, side, 3)
    frame = bytes(wire.encode_request(x, kind="scores"))
    out = {n: [] for n in ports}
    order = list(ports.items())
    for turn in (order, order[::-1]):
        for name, port in turn:
            done, stop = [], threading.Event()

            def client():
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=600)
                try:
                    while not stop.is_set():
                        st, _raw = _post_on(conn, "/predict", frame,
                                            wire.CONTENT_TYPE)
                        if st != 200:
                            raise SmokeError(f"fleet rate: {name} got {st}")
                        done.append(FLEET_RATE_ROWS)
                finally:
                    conn.close()

            ths = [threading.Thread(target=client, daemon=True)
                   for _ in range(FLEET_CLIENTS)]
            t0 = time.perf_counter()
            for t in ths:
                t.start()
            time.sleep(FLEET_RATE_S)
            stop.set()
            for t in ths:
                t.join(timeout=120)
            out[name].append(sum(done) / (time.perf_counter() - t0))
    return out


def _latency_pairs(router, direct, side):
    """``FLEET_PAIRS`` pairs of bucket-1 ``CXB1`` requests, one through the
    router and one to a replica directly, the order alternating; returns
    (median router ms, median direct ms, median of the pairs' router -
    direct ms, median of their ratios)."""
    import http.client

    from cxxnet_tpu_torch.serve import wire

    x = _rows(1, side, SEED + 262).reshape(1, side, side, 3)
    frame = bytes(wire.encode_request(x, kind="scores"))
    conns = {p: http.client.HTTPConnection("127.0.0.1", p, timeout=600)
             for p in (router, direct)}
    ms = {router: [], direct: []}
    try:
        for p in (router, direct):  # warm both connections
            _post_on(conns[p], "/predict", frame, wire.CONTENT_TYPE)
        for i in range(FLEET_PAIRS):
            for p in ((router, direct) if i % 2 == 0 else (direct, router)):
                t0 = time.perf_counter()
                st, _raw = _post_on(conns[p], "/predict", frame,
                                    wire.CONTENT_TYPE)
                ms[p].append((time.perf_counter() - t0) * 1e3)
                if st != 200:
                    raise SmokeError(f"fleet pairs: {st} from port {p}")
    finally:
        for c in conns.values():
            c.close()
    diffs = [a - b for a, b in zip(ms[router], ms[direct])]
    ratios = [a / b for a, b in zip(ms[router], ms[direct])]
    return (statistics.median(ms[router]), statistics.median(ms[direct]),
            statistics.median(diffs), statistics.median(ratios))


def _replica_memory(replicas):
    """Each replica's caching allocator as its own ``/metricsz`` reports
    it (``xla_device_memory_bytes``: in use, peak, the card's total).
    ``nvidia-smi --query-compute-apps`` cannot say this in a container:
    it lists every process as pid 1 with the card's whole use."""
    alloc = {}
    for rep in replicas:
        text = _get_text(rep["port"], "/metricsz")[0]
        alloc[f"replica{rep['idx']}"] = {
            ln.split('stat="')[1].split('"')[0]: float(ln.split()[-1])
            for ln in text.splitlines()
            if ln.startswith("xla_device_memory_bytes{")}
    return alloc


def fleet_serve_phase(tmp, card, mdir, eng1, side, cfg):
    """26a (see the module docstring); returns its part of the ``fleet``
    line."""
    import torch

    from cxxnet_tpu_torch.serve import Engine

    torch.cuda.empty_cache()
    out = {"launches": {"fleet": {}, "reference": {}}}
    proc, port, start_s, logf = _fleet_proc(
        CONF, tmp, "fleet_a", f"replicas={FLEET_REPLICAS}",
        f"model_dir={mdir}", "serve_reload_period=1")
    clients, watch, stop = [], None, threading.Event()
    try:
        st = _statsz(port)
        reps = {f"replica{r['idx']}": r["port"] for r in st["replicas"]}
        log(f"fleet: serving {FLEET_REPLICAS}/{FLEET_REPLICAS} in "
            f"{start_s:.1f}s (process start to the front door, replicas "
            f"{[(r['idx'], r['pid'], r['port']) for r in st['replicas']]});"
            f" {card}")
        _hold_buckets("fleet round 1", {"router": port, **reps}, eng1, side,
                      PER_FORWARD, SEED + 270, out["launches"], reps)
        clients = [_FleetClient(port, side, SEED + 271 + i, stop)
                   for i in range(FLEET_CLIENTS)]
        base = {r: _replica_launches(p) for r, p in reps.items()}
        watch = _FleetWatch(port)
        watch.start()
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        time.sleep(FLEET_KILL_AT_S)
        victim = _statsz(port)["replicas"][1]
        # the victim's last reading: what it launches between this and
        # the kill (one scrape's time) is not counted
        killed = _launch_delta(_replica_launches(victim["port"]),
                               base["replica1"])
        os.kill(victim["pid"], signal.SIGKILL)
        t_kill = time.perf_counter()
        degraded = back = None
        seen = 0
        while back is None and time.perf_counter() - t_kill < FLEET_RECOVER_S:
            time.sleep(0.1)
            for t, h, reps_ in watch.samples[seen:]:
                r = next(x for x in reps_ if x[0] == 1)
                if t < t_kill:
                    continue
                if degraded is None and h != "ok":
                    degraded = t - t_kill
                if (degraded is not None and r[3] >= 1
                        and r[1] == "healthy" and h == "ok"):
                    back = t - t_kill
                    break
            seen = len(watch.samples)
        if degraded is None or back is None:
            raise SmokeError(f"fleet: replica 1 (pid {victim['pid']}) "
                             f"killed: degraded after {degraded}, healthy "
                             f"again after {back}; {_statsz(port)}")
        states = {s for _t, _h, reps_ in watch.samples
                  for i, s, *_r in reps_ if i == 1}
        log(f"fleet: SIGKILL of replica 1 (pid {victim['pid']}) "
            f"{FLEET_KILL_AT_S:g}s into the traffic: /healthz degraded after "
            f"{degraded:.2f}s, replica 1 through states {sorted(states)}, "
            f"healthy again and /healthz ok {back:.2f}s after the kill (the "
            f"front door sampled every 0.1 s); {card}")
        rest = FLEET_TRAFFIC_S - (time.perf_counter() - t0)
        if rest > 0:
            time.sleep(rest)
        t_write = time.perf_counter()
        _round2(cfg, os.path.join(mdir, "0001.model"),
                os.path.join(mdir, "0002.model"))
        write_s = time.perf_counter() - t_write
        while True:
            st = _statsz(port)
            if all(r["round"] == 2 and r["state"] == "healthy"
                   for r in st["replicas"]):
                break
            if time.perf_counter() - t_write > FLEET_ROLLOUT_S:
                raise SmokeError(f"fleet: round 2 not on every replica "
                                 f"{FLEET_ROLLOUT_S:g}s after its write: "
                                 f"{st['replicas']}")
            time.sleep(0.1)
        rollout_s = time.perf_counter() - t_write
        stop.set()
        for c in clients:
            c.join(timeout=600)
        watch.stop.set()
        watch.join(timeout=10)
        # the replicas' own launches under the traffic, the kill and the
        # rollout: replica 1's killed process to its last reading, then
        # its new process from its start
        reps = {f"replica{r['idx']}": r["port"]
                for r in _statsz(port)["replicas"]}
        window = {}
        for name, now in _quiet_launches(reps, "fleet traffic").items():
            window[name] = (_launch_sum(killed, now) if name == "replica1"
                            else _launch_delta(now, base[name]))
        served = {r: _whole_forwards(f"fleet traffic: {r}", d, PER_FORWARD)
                  for r, d in window.items()}
        for d in window.values():
            _add_launches(out["launches"]["fleet"], d)
        # one replica at a time: in the watch's samples, each replica
        # first shows round 2 in index order, never two in one sample
        firsts = {}
        for t, _h, reps_ in watch.samples:
            for i, _s, rnd, *_r in reps_:
                if rnd == 2 and i not in firsts:
                    firsts[i] = t
        order = sorted(firsts, key=firsts.get)
        if (order != list(range(FLEET_REPLICAS))
                or len(set(firsts.values())) != FLEET_REPLICAS):
            raise SmokeError(f"fleet: the rollout reached the replicas in "
                             f"the order {order} at {firsts}: not one at a "
                             "time in rotation order")
        bad = _failures(clients)
        answered = [r for c in clients for r in c.results]
        by_kind = {}
        for st_, kind, n, _dt, _why in answered:
            by_kind.setdefault(f"{kind} {st_}", 0)
            by_kind[f"{kind} {st_}"] += 1
        if bad or len(answered) < 50:
            raise SmokeError(f"fleet: {len(bad)} non-shed failures of "
                             f"{len(answered)} answers: {bad[:5]}")
        metrics = _get_text(port, "/metricsz")[0]
        swapped = [ln for ln in metrics.splitlines()
                   if ln.startswith("fleet_reloads_total{")]
        failovers = [ln for ln in metrics.splitlines()
                     if ln.startswith("fleet_failovers_total")]
        log(f"fleet: {len(answered)} answers under the kill and the rollout"
            f" ({by_kind}), 0 non-shed failures; round 2 written in "
            f"{write_s:.2f}s, on all {FLEET_REPLICAS} replicas one at a time"
            f" (order {order}) {rollout_s:.2f}s after the write began; "
            f"{swapped}; {failovers}; {card}")
        log(f"fleet: forwards the replicas ran under the traffic, the kill "
            f"and the rollout, each a forward's K1 13, K4 2, K6 9 on the "
            f"main paths (their /metricsz; replica 1 its killed process and "
            f"its new one) {served}; {card}")
        with Engine(cfg=cfg, model_in=os.path.join(mdir, "0002.model"),
                    silent=True) as eng2:
            _hold_buckets("fleet round 2", {"router": port, **reps}, eng2,
                          side, PER_FORWARD, SEED + 280, out["launches"],
                          reps)
        rates = _turns_rate({"router": port, "replica0": reps["replica0"]},
                            side)
        r_ms, d_ms, diff_ms, ratio = _latency_pairs(port, reps["replica0"],
                                                    side)
        mem = _replica_memory(_statsz(port)["replicas"])
        log(f"fleet: rows/s of {FLEET_CLIENTS} clients of "
            f"{FLEET_RATE_ROWS}-row CXB1 frames, in turns: through the "
            f"router ({FLEET_REPLICAS} replicas) "
            f"{[round(v, 1) for v in rates['router']]}, "
            f"replica 0 directly "
            f"{[round(v, 1) for v in rates['replica0']]}; bucket 1 over "
            f"{FLEET_PAIRS} pairs (host clock): router {r_ms:.2f} ms, direct "
            f"{d_ms:.2f} ms, router's added latency (median of the pairs) "
            f"{diff_ms:.2f} ms, ratio {ratio:.3f}; {card}")
        log(f"fleet: each replica's allocator (bytes, its /metricsz) "
            f"{mem}; {card}")
        out.update({
            "start_s": start_s, "kill_degraded_s": degraded,
            "kill_to_healthy_s": back, "rollout_s": rollout_s,
            "answers": len(answered), "by_kind": by_kind,
            "rows_per_s": rates, "router_ms": r_ms, "direct_ms": d_ms,
            "router_added_ms": diff_ms, "router_ratio": ratio,
            "memory": mem, "forwards": served})
    except BaseException:
        stop.set()
        _stop_fleet(proc, logf, "a", quiet=True)
        raise
    stop.set()
    if watch is not None:
        watch.stop.set()
    t_stop = time.perf_counter()
    _stop_fleet(proc, logf, "a")
    out["stop_s"] = time.perf_counter() - t_stop
    return out


def fleet_canary_phase(tmp, card, mdir, eng1, side, cfg):
    """26b (see the module docstring); returns its part of the ``fleet``
    line."""
    import torch

    from cxxnet_tpu_torch.nnet.quant import quant_artifact_path
    from cxxnet_tpu_torch.serve import Engine
    from cxxnet_tpu_torch.utils import checkpoint as ckpt

    path = os.path.join(mdir, "0001.model")
    conf = _synthetic_conf(tmp, "googlenet_canary.conf",
                           (("eval", "val", EVAL_ROWS, False),), 1.0)
    verdict = _export_quant(conf, path, "quant_min_agreement=0")
    qpath = quant_artifact_path(path)
    if not os.path.exists(qpath):
        raise SmokeError(f"fleet canary: no artifact at {qpath}")
    if verdict["fallbacks"]:
        raise SmokeError(f"fleet canary: the ungated export demoted "
                         f"{verdict['fallbacks']}")
    per_q = {**PER_FORWARD, "int8_gemm": INT8_PER_FORWARD}
    torch.cuda.empty_cache()
    out = {"launches": {"fleet": {}, "reference": {}}}
    proc, port, start_s, logf = _fleet_proc(
        CONF, tmp, "fleet_b", "replicas=2", f"model_dir={mdir}",
        *CANARY_KEYS)
    stop = threading.Event()
    clients = []
    try:
        st = _statsz(port)
        roles = {r["role"]: r for r in st["replicas"]}
        log(f"fleet canary: serving 2/2 in {start_s:.1f}s, roles "
            f"{[(r['idx'], r['role'], r['port']) for r in st['replicas']]}"
            f"; {card}")
        reps = {"canary": roles["canary"]["port"],
                "baseline": roles["serve"]["port"]}
        with Engine(cfg=cfg + [("quant", "int8")], model_in=path,
                    silent=True) as engq:
            _hold_buckets("fleet canary int8", {"canary": reps["canary"]},
                          engq, side, per_q, SEED + 290, out["launches"],
                          reps)
        _hold_buckets("fleet canary baseline", {
            "baseline": reps["baseline"]}, eng1, side, PER_FORWARD,
            SEED + 291, out["launches"], reps)
        clients = [_FleetClient(port, side, SEED + 292 + i, stop, fresh=True)
                   for i in range(2)]
        base = last = {r: _replica_launches(p) for r, p in reps.items()}
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        while True:
            can = _statsz(port)["canary"]
            if can["state"] != "evaluating":
                break
            # the last readings before the decision (a rollback
            # relaunches the canary, and its count with it)
            last = {r: _replica_launches(p) for r, p in reps.items()}
            bad = _failures(clients)
            if bad:
                raise SmokeError(f"fleet canary: non-shed failures while "
                                 f"evaluating: {bad[:5]}")
            if time.perf_counter() - t0 > CANARY_DECIDE_S:
                raise SmokeError(f"fleet canary: no decision "
                                 f"{CANARY_DECIDE_S:g}s in: {can}")
            time.sleep(0.1)
        decide_s = time.perf_counter() - t0
        stop.set()
        for c in clients:
            c.join(timeout=600)
        # the decision's state is set first; its pointer (and, on a
        # rollback, the canary's relaunch) follow on the controller's
        # thread
        _wait(lambda: ckpt.read_publish_pointer(mdir) is not None and (
            can["state"] == "promoted" or _statsz(port)["replicas"][
                roles["canary"]["idx"]]["restarts"] >= 1),
            "fleet canary: the decision's pointer", timeout=60.0)
        # promoted: every mirror answered, read the quiet replicas;
        # rolled back: the readings under traffic, the last forward of
        # each perhaps cut short
        partial = can["state"] != "promoted"
        if not partial:
            last = _quiet_launches(reps, "fleet canary")
        window = {r: _launch_delta(last[r], base[r]) for r in reps}
        served = {r: _whole_forwards(f"fleet canary traffic: {r}", window[r],
                                     per_q if r == "canary" else PER_FORWARD,
                                     partial) for r in reps}
        for d in window.values():
            _add_launches(out["launches"]["fleet"], d)
        bad = _failures(clients)
        answered = sum(len(c.results) for c in clients)
        if bad:
            raise SmokeError(f"fleet canary: {len(bad)} non-shed failures "
                             f"of {answered}: {bad[:5]}")
        sent = sum(n for c in clients for _s, _k, n, _d, _w in c.results)
        classes = len({p for c in clients for p in c.preds})
        metrics = _get_text(port, "/metricsz")[0]
        gauges = {ln.split()[0]: float(ln.split()[1])
                  for ln in metrics.splitlines()
                  if ln.startswith(("canary_agreement ",
                                    "canary_latency_ratio "))}
        ptr = ckpt.read_publish_pointer(mdir)
        agreement, want = can["agreement"], (
            "promoted" if can["agreement"] >= can["min_agreement"]
            else "rolled_back")
        st = _statsz(port)
        min_req = int(dict(k.split("=", 1) for k in CANARY_KEYS)[
            "canary_min_requests"])
        if can["compared"] < min_req or can["state"] != want or ptr is None \
                or ptr["round"] != 1:
            raise SmokeError(f"fleet canary: {can}, pointer {ptr}: the "
                             f"decision does not follow its rule ({want})")
        if want == "promoted" and ptr["path"] != qpath:
            raise SmokeError(f"fleet canary: promoted, but the pointer "
                             f"names {ptr['path']}, not {qpath}")
        if want == "rolled_back":
            r = st["replicas"][roles["canary"]["idx"]]
            if ptr["path"] != path or r["role"] != "serve" \
                    or r["restarts"] < 1:
                raise SmokeError(f"fleet canary: rolled back, but the "
                                 f"pointer names {ptr['path']} and the "
                                 f"canary replica is {r}")
        log(f"fleet canary: {can['compared']} rows compared over "
            f"{answered} JSON requests of fresh rows ({sent} distinct rows "
            f"sent, so every compared row a distinct image; the answered "
            f"rows' predictions cover {classes} classes) in "
            f"{decide_s:.1f}s; agreement {agreement:.4f} against "
            f"{can['min_agreement']:g}: {can['state']} ({can['reason']}), "
            f"the pointer names {ptr['path']}; gauges {gauges}; forwards "
            f"under the traffic (the replicas' /metricsz, to the decision) "
            f"{served}; {card}")
        out.update({"start_s": start_s, "state": can["state"],
                    "agreement": agreement, "compared": can["compared"],
                    "rows_sent": sent, "classes": classes,
                    "latency_ratio": gauges.get("canary_latency_ratio"),
                    "pointer": ptr["path"], "decide_s": decide_s,
                    "forwards": served, "int8_per_forward": per_q})
    except BaseException:
        stop.set()
        _stop_fleet(proc, logf, "b", quiet=True)
        raise
    stop.set()
    t_stop = time.perf_counter()
    _stop_fleet(proc, logf, "b")
    out["stop_s"] = time.perf_counter() - t_stop
    return out


def branch_embed_phase(tmp, card, mdir, side):
    """26c (see the module docstring); returns its part of the ``fleet``
    line."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS

    conf = _synthetic_conf(tmp, "googlenet_embed.conf", (), LR_SCALE)
    # dropout off: the two nets' steps must see the same activations
    cfg = [(n, "0.0" if n == "threshold" else v)
           for n, v in cfgmod.parse_file(conf)] + [("dev", "gpu")]
    path = os.path.join(mdir, "0001.model")
    trs = {}
    for v in (0, 1):
        tr = NetTrainer()
        tr.set_params(cfg + [("conv_branch_embed", str(v))])
        tr.load_model(path)
        trs[v] = tr
    preps = {v: tr._prepared_for(tr.params) for v, tr in trs.items()}
    if (len(trs[1].net._branch_embed_plan()[1]) != 9
            or len(preps[1]["embed"]) != 9 or preps[0]["embed"]):
        raise SmokeError("branch-embed: = 1 does not prepare GoogLeNet's "
                         "nine block kernels, or = 0 prepares some")
    dev = trs[0].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 300)
    x = torch.randn((BATCH, side, side, 3), generator=gen, device=dev)
    fc = max(i for i, s in enumerate(trs[0].graph.layers)
             if s.type_name == "fullc")
    feat_node = trs[0].graph.layers[fc].nindex_in[0]
    # the softmax runs in place on the classifier's node: the logits are
    # the classifier over each forward's features, in f32
    cls = trs[0].params[trs[0].net.param_key[fc]]
    cls = (cls["wmat"].float(), cls["bias"].float())
    outs, launches = {}, {}
    for v, tr in trs.items():
        prep = tr._prepared_for(tr.params)
        with torch.no_grad():
            for k in KERNELS:
                k.reset_counts()
            paths = _by_symbol()
            nodes = tr.net.forward(prep, x)
            torch.cuda.synchronize()
            got = {k.name: k.launches for k in KERNELS if k.launches}
            if got != PER_FORWARD or _paths_since(paths) != \
                    _main_paths(PER_FORWARD):
                raise SmokeError(f"branch-embed = {v}: a forward launched "
                                 f"{got}, by C entry {_paths_since(paths)}")
            launches[f"forward_{v}"] = got
        feat = nodes[feat_node].float()
        outs[v] = (nodes[tr.net.out_node_index()].float(), feat,
                   torch.nn.functional.linear(feat.flatten(1), *cls))
        del nodes
    prob_err = float((outs[1][0] - outs[0][0]).abs().max())
    feat_rel, logit_rel = (float((outs[1][i] - outs[0][i]).abs().max()
                                 / outs[0][i].abs().max()) for i in (1, 2))
    top1 = float((outs[1][0].argmax(1) == outs[0][0].argmax(1)).float()
                 .mean())
    if not (prob_err <= EMBED_PROB_ATOL and feat_rel <= BF16_FEAT_REL
            and logit_rel <= BF16_LOGIT_REL):
        raise SmokeError(f"branch-embed: the fused b{BATCH} forward against "
                         f"the plain one: probabilities max |diff| "
                         f"{prob_err:.3g} (limit {EMBED_PROB_ATOL:g}), "
                         f"features {feat_rel:.3g} and logits "
                         f"{logit_rel:.3g} of their largest (limits "
                         f"{BF16_FEAT_REL:g}, {BF16_LOGIT_REL:g})")

    def fwd(tr):
        prep = tr._prepared_for(tr.params)

        def run():
            with torch.no_grad():
                tr.net.forward(prep, x)
        return run

    times = time_turns({"plain": fwd(trs[0]), "fused": fwd(trs[1])},
                       device=True)
    log(f"branch-embed: GoogLeNet b{BATCH} bf16 forward, conv_branch_embed "
        f"0 against 1 in turns (device time, ms): plain "
        f"{[round(t, 3) for t in times['plain']]}, fused "
        f"{[round(t, 3) for t in times['fused']]}; fused vs plain: "
        f"probabilities max |diff| {prob_err:.3g}, features {feat_rel:.3g} "
        f"and logits {logit_rel:.3g} of their largest, top-1 agreement "
        f"{top1:.4f}; launches "
        f"{launches}; {card}")
    del outs

    rng = np.random.RandomState(SEED + 301)
    batches = [(rng.randn(BATCH, side, side, 3).astype(np.float32),
                rng.randint(0, 1000, (BATCH, 1)).astype(np.float32))
               for _ in range(EMBED_STEPS)]
    w0 = {(k, t): w.detach().float().clone()
          for k, tags in trs[0].params.items() for t, w in tags.items()}
    losses = {0: [], 1: []}
    step_per = IMGBIN_PER_STEP  # K1-K6, and K8 once over the 116 tensors
    for v, tr in trs.items():
        tr._invalidate_prepared()
        for k in KERNELS:
            k.reset_counts()
        paths = _by_symbol()
        for bx, by in batches:
            tr.update_all(bx, by)
            losses[v].append(float(tr.last_loss))
        torch.cuda.synchronize()
        got = {k.name: k.launches for k in KERNELS if k.launches}
        want = {k: n * EMBED_STEPS for k, n in step_per.items()}
        if got != want or _paths_since(paths) != _main_paths(want):
            raise SmokeError(f"branch-embed = {v}: {EMBED_STEPS} steps "
                             f"launched {got}, by C entry "
                             f"{_paths_since(paths)}; expected {want}")
        launches[f"steps_{v}"] = got
    cos = {}
    for kt, w in w0.items():
        d0 = trs[0].params[kt[0]][kt[1]].float() - w
        d1 = trs[1].params[kt[0]][kt[1]].float() - w
        cos[kt] = float((d0 * d1).sum() / (d0.norm() * d1.norm()))
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(losses[0], losses[1]))
    worst = min(cos, key=cos.get)
    med = statistics.median(cos.values())
    log(f"branch-embed: {EMBED_STEPS} b{BATCH} bf16 steps under 1 against "
        f"0 from round 1: losses {losses[1]} against {losses[0]} (worst "
        f"rel {loss_rel:.3g}, limit {EMBED_LOSS_REL:g}); update cosine "
        f"worst {cos[worst]:.5f} at {'/'.join(worst)} (limit "
        f"{UPDATE_COS:g}), median {med:.5f} (limit {UPDATE_COS_MEDIAN:g}); "
        f"{card}")
    if not (loss_rel <= EMBED_LOSS_REL and cos[worst] >= UPDATE_COS
            and med >= UPDATE_COS_MEDIAN):
        raise SmokeError("branch-embed: training under = 1 is out of "
                         "tolerance against = 0 (above)")
    del trs
    torch.cuda.empty_cache()
    return {"forward_ms": times, "prob_max_diff": prob_err,
            "feat_rel": feat_rel, "logit_rel": logit_rel, "top1": top1, "loss_rel": loss_rel,
            "update_cos_worst": cos[worst], "update_cos_median": med,
            "launches": launches}


def _centre_classifier(tr, side):
    """26b's round 1: ``tr``'s classifier with the direction of the mean
    pool features over ``CANARY_CENTRE_ROWS`` rows like the clients'
    taken out of every class's weights.  A random GoogLeNet's features
    share one large mean, which alone sets the top-1 class (every image
    one class: a canary's top-1 agreement is then 1 whatever int8 does);
    centred, each image's class follows what sets it apart."""
    import torch

    fc = max(i for i, s in enumerate(tr.graph.layers)
             if s.type_name == "fullc")
    x = torch.as_tensor(_rows(CANARY_CENTRE_ROWS, side, SEED + 266).reshape(
        CANARY_CENTRE_ROWS, side, side, 3), device=tr.device)
    with torch.no_grad():
        f = tr.net.forward(tr._prepared_for(tr.params), x)[
            tr.graph.layers[fc].nindex_in[0]].float().flatten(1)
        m = f.mean(0)
        w = tr.params[tr.net.param_key[fc]]["wmat"]
        w.sub_(((w.float() @ m)[:, None] * m[None, :] / (m @ m)).to(w.dtype))
    tr._invalidate_prepared()


def fleet_phase(card):
    """Phase 26: 26a, 26b and 26c over one seeded GoogLeNet (round 1);
    returns the ``fleet`` line."""
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.serve import Engine

    t0 = time.perf_counter()
    out = {"card": card}
    cfg = cfgmod.parse_file(CONF) + [("dev", "gpu"), ("silent", "1")]
    side = CONF_SIDE
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        mdirs = {n: os.path.join(tmp, f"models_{n}") for n in "ab"}
        for d in mdirs.values():
            os.makedirs(d)
        from cxxnet_tpu_torch.nnet.trainer import NetTrainer

        tr = NetTrainer()
        tr.set_params(cfg + [("seed", str(SEED + 265))])
        tr.init_model()
        tr.save_model(os.path.join(mdirs["a"], "0001.model"), round_=1)
        _centre_classifier(tr, side)
        tr.save_model(os.path.join(mdirs["b"], "0001.model"), round_=1)
        del tr
        for name, fn in (("serve", fleet_serve_phase),
                         ("canary", fleet_canary_phase)):
            mdir = mdirs["a" if name == "serve" else "b"]
            with Engine(cfg=cfg, model_in=os.path.join(mdir, "0001.model"),
                        silent=True) as eng1:
                t1 = time.perf_counter()
                out[name] = fn(tmp, card, mdir, eng1, side, cfg)
                out[f"{name}_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out["branch_embed"] = branch_embed_phase(tmp, card, mdirs["a"], side)
        out["branch_embed_s"] = time.perf_counter() - t1
    out["phase_s"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# phase 27: moe, pipe stacks, remat
#
# 27a and 27b train on a generated text file of P27_WINDOWS windows (two
# steps a round at LM_BATCH); 27b's LM swaps each block's fc1 for a MoE
# layer of MOE_EXPERTS experts of the fc1's width, top-MOE_TOPK routed;
# 27c's stack is transformer_conf at the LM's widths with a
# PIPE_CLASSES-way head; 27d takes REMAT_STEPS b128 steps of GoogLeNet
P27_WINDOWS = 2 * LM_BATCH
MOE_EXPERTS, MOE_TOPK = 8, 2
PIPE_CLASSES = 16
REMAT_STEPS = 2
REMAT_TIMED = 3  # steps a turn in 27a's remat 0/1 turns (2 turns each)
# 27c: the pipe stack (dense mha) against the per-block net (K9) on the
# same weights, the largest difference of the stack's output: in f32
# (TF32 off) over the largest change the stack makes to its input (the
# two attentions differ by exp and summation order, 1e-5 of a row each,
# FLASH_TOL, through four blocks); in bf16 over the output's largest
# magnitude, since the residual stream is rounded to bf16 at the scale
# of the input after every block (one ulp, 2^-8 of it, where the two
# sides' sums fall either side of a rounding boundary, up to four
# blocks' worth, and K9's P rounded against the running max)
PIPE_F32_REL, PIPE_BF16_REL = 1e-4, 2e-2
REMAT_COS = 0.99  # 27d: each update, remat 1 against remat 0


def _text_file(tmp: str, name: str, windows: int, seed: int) -> str:
    """``windows`` LM windows of seeded printable bytes."""
    import numpy as np

    path = os.path.join(tmp, name)
    data = np.random.RandomState(seed).randint(32, 127, windows * LM_T + 1)
    with open(path, "wb") as f:
        f.write(data.astype(np.uint8).tobytes())
    return path


def _lm_text(corpus: str, remat: int, rounds: int, moe: bool = False) -> str:
    """The smoke's LM conf (``LM_*`` widths, bf16, ``attn_impl =
    pallas``) on ``corpus`` with ``remat``; under ``moe`` each block's
    ``fullc:b{i}_fc1`` becomes ``moe:b{i}_moe`` of the same width."""
    from cxxnet_tpu_torch.models import transformer_lm_conf

    text = transformer_lm_conf(
        seq_len=LM_T, dim=LM_DIM, nhead=LM_HEADS, nlayer=LM_LAYERS,
        text_file=corpus, batch_size=LM_BATCH, num_round=rounds,
        dev="gpu", compute_dtype="bfloat16", attn_impl="pallas")
    for i in range(LM_LAYERS if moe else 0):
        old = f"= fullc:b{i}_fc1\n"
        if old not in text:
            raise SmokeError(f"the LM conf has no {old.strip()}")
        text = text.replace(old, f"= moe:b{i}_moe\n  nexpert = {MOE_EXPERTS}"
                            f"\n  topk = {MOE_TOPK}\n")
    return text + f"remat = {remat}\n"


def _lm_run(tmp: str, name: str, text: str, want: dict, rounds: int):
    """``task=train`` on ``text`` through ``LearnTask``: every step must
    launch ``want`` (zeros elsewhere); returns the run's launches, its
    checkpoint directory, conf pairs and losses."""
    import numpy as np

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.ops import KERNELS

    conf = os.path.join(tmp, f"{name}.conf")
    with open(conf, "w") as f:
        f.write(text)
    mdir = os.path.join(tmp, name)
    argv = [conf, "task=train", "dev=gpu", f"model_dir={mdir}",
            f"seed={SEED}", "print_step=0", "silent=1"]
    # the main path: counts at 0 just before, read just after
    _, _, steps, losses, _ = _run_train_task(argv)
    launches = {k.name: k.launches for k in KERNELS}
    per_step = {k.name: 0 for k in KERNELS}
    per_step.update(want)
    n = rounds * (P27_WINDOWS // LM_BATCH)
    if len(steps) != n or any(d != per_step for d in steps):
        raise SmokeError(f"{name}: {len(steps)} steps (expected {n}) "
                         f"launched {steps}, expected {per_step} each")
    if not all(np.isfinite(losses)):
        raise SmokeError(f"{name}: non-finite loss {losses}")
    return launches, mdir, cfgmod.parse_file(conf), losses


def _params_of(path: str):
    """A checkpoint's params as f64 numpy, ``{(key, tag): array}``."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    _, params, _, _ = NetTrainer._read_model_file(path)
    return {(k, t): w.astype("float64") for k, tags in params.items()
            for t, w in tags.items()}


def _rel_err(got, ref) -> float:
    import numpy as np

    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _lm_turns(cfg, ckpt: str):
    """Step time and peak memory of one LM step under ``remat = 0`` and
    ``1``, from ``ckpt``, on one device-resident batch, ``eval_train =
    0``: two turns of ``REMAT_TIMED`` steps each way (CUDA events, after
    ``RATE_WARMUP`` warm-up steps), the peak over the resident state
    beside the absolute one, then one step each way under the profiler
    (device time, K9's and K10's share)."""
    import torch

    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    out, batch = {}, None
    for remat in (0, 1):
        tr = NetTrainer()
        tr.set_params(cfg + [("eval_train", "0"), ("remat", str(remat))])
        tr.load_model(ckpt)
        if batch is None:
            gen = torch.Generator(device=tr.device).manual_seed(SEED)
            shape = (LM_BATCH, LM_T)
            batch = DataBatch(
                data=torch.randint(0, 256, shape, generator=gen,
                                   device=tr.device).float(),
                label=torch.randint(0, 256, shape, generator=gen,
                                    device=tr.device).float())
        for _ in range(RATE_WARMUP):
            tr.update(batch)
        torch.cuda.synchronize()
        rest = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr.update(batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out[remat] = {"trainer": tr, "ms": [],
                      "peak_gib": peak / 2 ** 30,
                      "step_peak_over_rest_gib": (peak - rest) / 2 ** 30}
    for _ in range(2):
        for remat in (0, 1):
            tr = out[remat]["trainer"]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(REMAT_TIMED):
                tr.update(batch)
            b.record()
            b.synchronize()
            out[remat]["ms"].append(a.elapsed_time(b) / REMAT_TIMED)
    for remat in (0, 1):
        tr = out[remat]["trainer"]

        def step(tr=tr):
            tr.update(batch)
            torch.cuda.synchronize()

        prof = _profile(step, f"27a remat {remat}", "step")
        out[remat].update(device_ms=prof["device_ms"],
                          wall_ms=prof["wall_ms"],
                          flash_fwd_ms=prof["flash_fwd"],
                          flash_bwd_ms=prof["flash_bwd"],
                          by_kind=prof["by_kind"])
        del out[remat]["trainer"]
    return out


def remat_lm_phase(tmp: str, card: str):
    """27a: the LM at ``LM_*`` widths through ``task=train`` under
    ``remat = 0`` and ``1`` from one seeded checkpoint: K9 twice and K10
    once per block a step under remat, K9 and K10 once without; the two
    runs' updates by the LM rule; step device time and peak memory both
    ways, in turns."""
    import numpy as np

    corpus = _text_file(tmp, "remat.txt", P27_WINDOWS, SEED + 27)
    runs = {}
    for remat in (0, 1):
        want = {"flash_fwd": LM_LAYERS * (2 if remat else 1),
                "flash_bwd": LM_LAYERS}
        runs[remat] = _lm_run(tmp, f"lm_remat{remat}",
                              _lm_text(corpus, remat, LM_ROUNDS), want,
                              LM_ROUNDS)
    first = [_params_of(os.path.join(runs[r][1], "0000.model"))
             for r in (0, 1)]
    if any(not np.array_equal(first[0][kt], first[1][kt]) for kt in first[0]):
        raise SmokeError("27a: the two runs did not start from one "
                         "checkpoint")
    last = [_params_of(os.path.join(runs[r][1], f"{LM_ROUNDS:04d}.model"))
            for r in (0, 1)]
    d = [{kt: last[r][kt] - first[0][kt] for kt in first[0]} for r in (0, 1)]
    rel = {kt: _rel_err(d[1][kt], d[0][kt]) for kt in d[0]}
    equal = all(np.array_equal(last[0][kt], last[1][kt]) for kt in last[0])
    med = statistics.median(rel.values())
    log(f"27a remat: {len(d[0])} tensors' updates after {LM_ROUNDS} rounds, "
        f"remat 1 vs 0: bit-equal {equal}; worst rel "
        f"{max(rel.values()):.3g} (limit {LM_UPDATE_REL:g}), median "
        f"{med:.3g} (limit {LM_UPDATE_REL_MEDIAN:g}); losses remat 0 "
        f"{[round(v, 4) for v in runs[0][3]]}, remat 1 "
        f"{[round(v, 4) for v in runs[1][3]]}")
    if max(rel.values()) > LM_UPDATE_REL or med > LM_UPDATE_REL_MEDIAN:
        raise SmokeError(f"27a: remat changed the LM's updates: "
                         f"{sorted(rel.items(), key=lambda kv: -kv[1])[:5]}")
    turns = _lm_turns(runs[0][2] + [("dev", "gpu")],
                      os.path.join(runs[0][1], f"{LM_ROUNDS:04d}.model"))
    for remat, t in turns.items():
        log(f"27a remat {remat}: b{LM_BATCH} T{LM_T} d{LM_DIM} L{LM_LAYERS} "
            f"bf16 step {t['ms']} ms (CUDA events, {REMAT_TIMED} steps a "
            f"turn), {t['device_ms']:.3f} ms of device time (K9 "
            f"{t['flash_fwd_ms']:.3f}, K10 {t['flash_bwd_ms']:.3f}); peak "
            f"{t['peak_gib']:.3f} GiB, {t['step_peak_over_rest_gib']:.3f} "
            f"GiB over the resident state; {card}")
    return {"launches": {r: runs[r][0] for r in (0, 1)},
            "bit_equal": equal, "worst_rel": max(rel.values()),
            "median_rel": med, "turns": turns}


def moe_lm_phase(tmp: str, card: str):
    """27b: the LM with a MoE layer for each block's fc1, ``remat = 1``,
    one round through ``task=train`` (K9 twice and K10 once per block a
    step), then one f32 step from its first checkpoint on the card
    against the CPU, and bf16 against f32 on the card with the gates
    unmasked (``topk = 0``: ``_lm_parity``; top-2 routing moves whole
    tokens between bf16 and f32, logged beside it)."""
    corpus = _text_file(tmp, "moe.txt", P27_WINDOWS, SEED + 28)
    want = {"flash_fwd": 2 * LM_LAYERS, "flash_bwd": LM_LAYERS}
    launches, mdir, cfg, losses = _lm_run(
        tmp, "lm_moe", _lm_text(corpus, 1, 1, moe=True), want, 1)
    params = _params_of(os.path.join(mdir, "0001.model"))
    shapes = {kt: w.shape for kt, w in params.items() if "_moe" in kt[0]}
    if len(shapes) != 3 * LM_LAYERS or any(
            s != (MOE_EXPERTS, 4 * LM_DIM, LM_DIM)
            for (k, t), s in shapes.items() if t == "wmat"):
        raise SmokeError(f"27b: the MoE tensors are {shapes}")
    log(f"27b moe: {LM_LAYERS} MoE layers of {MOE_EXPERTS} x "
        f"({4 * LM_DIM}, {LM_DIM}), top-{MOE_TOPK}; losses "
        f"{[round(v, 4) for v in losses]}")
    dense = [(n, "0" if n == "topk" else v) for n, v in cfg]
    parity = _lm_parity(cfg + [("dev", "gpu")],
                        os.path.join(mdir, "0000.model"), "27b moe parity",
                        bf16_cfg=dense + [("dev", "gpu")])
    return {"launches": launches, "parity": parity}


def _restack(src, dst):
    """The pipe stack's ``(L, ...)`` params into the per-block net's
    layers (``transformer_conf``'s names), and the head, in place."""
    import torch

    blocks = src.params[src.net.param_key[src.graph.layer_index_of(
        "blocks")]]

    def key(tr, name):
        return tr.net.param_key[tr.graph.layer_index_of(name)]

    with torch.no_grad():
        for j in range(LM_LAYERS):
            for name, tags in ((f"b{j}_ln1", {"wmat": "ln1_w",
                                               "bias": "ln1_b"}),
                               (f"b{j}_attn", {"wmat": "wqkv",
                                               "bias": "bqkv",
                                               "wproj": "wproj",
                                               "bproj": "bproj"}),
                               (f"b{j}_ln2", {"wmat": "ln2_w",
                                              "bias": "ln2_b"}),
                               (f"b{j}_fc1", {"wmat": "wff1",
                                              "bias": "bff1"}),
                               (f"b{j}_fc2", {"wmat": "wff2",
                                              "bias": "bff2"})):
                for t, st in tags.items():
                    dst.params[key(dst, name)][t].copy_(blocks[st][j])
        for t, w in src.params[key(src, "head")].items():
            dst.params[key(dst, "head")][t].copy_(w)
    dst._invalidate_prepared()


def pipe_phase(tmp: str, card: str):
    """27c: ``transformer_conf(pipeline_parallel=1)`` at the LM's widths
    (causal, b8): its stack's forward (dense ``mha``, no kernel) against
    the per-block net (K9 once per block) on the same weights restacked,
    f32 (TF32 off) and bf16; then ``REMAT_STEPS`` steps under ``remat =
    0`` and ``1`` from one checkpoint, K8 once a step and nothing else,
    their updates equal by the LM rule, the peak memory both ways."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.models import transformer_conf
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS

    kw = dict(batch_size=LM_BATCH, seq_len=LM_T, dim=LM_DIM,
              nhead=LM_HEADS, nlayer=LM_LAYERS, num_class=PIPE_CLASSES,
              causal=1, dev="gpu", compute_dtype="float32")
    pipe_cfg = cfgmod.parse_pairs(transformer_conf(pipeline_parallel=1, **kw))
    ref_cfg = cfgmod.parse_pairs(transformer_conf(attn_impl="pallas", **kw))
    trp, trb = NetTrainer(), NetTrainer()
    trp.set_params(pipe_cfg + [("seed", str(SEED))])
    trp.init_model()
    trb.set_params(ref_cfg)
    trb.init_model()
    _restack(trp, trb)
    gen = torch.Generator(device=trp.device).manual_seed(SEED + 29)
    x = torch.randn((LM_BATCH, LM_T, LM_DIM), generator=gen,
                    device=trp.device)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fwd = {}
    try:
        for dtype, limit in (("float32", PIPE_F32_REL),
                             ("bfloat16", PIPE_BF16_REL)):
            ys, counts = [], []
            for tr, node in ((trp, "blocks"), (trb, f"b{LM_LAYERS - 1}_r2")):
                tr.net.compute_dtype = getattr(torch, dtype)
                for k in KERNELS:
                    k.reset_counts()
                with torch.no_grad():
                    nodes = tr.net.forward(tr.net.prepare(tr.params), x)
                    ys.append(nodes[tr.graph.node_index_of(node)].double())
                torch.cuda.synchronize()
                counts.append({k.name: k.launches for k in KERNELS
                               if k.launches})
                del nodes
            scale = ((ys[1] - x.double()) if dtype == "float32"
                     else ys[1]).abs().max()
            err = float((ys[0] - ys[1]).abs().max() / scale)
            fwd[dtype] = {"rel": err, "limit": limit, "launches": counts}
            log(f"27c pipe: {dtype} stack forward (dense mha) vs per-block "
                f"net (K9): max diff over the "
                f"{'stack' + chr(39) + 's largest change' if dtype == 'float32' else 'largest output'}"
                f" {err:.3g} (limit {limit:g}); launches pipe {counts[0]}, "
                f"per-block {counts[1]}")
            if not (counts[0] == {} and counts[1] == {"flash_fwd": LM_LAYERS}):
                raise SmokeError(f"27c: forward launches {counts}")
            if not err <= limit:
                raise SmokeError(f"27c: the pipe stack's {dtype} forward is "
                                 f"{err:.3g} off the per-block net's")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    del trb
    ckpt = os.path.join(tmp, "pipe.model")
    trp.save_model(ckpt)
    del trp
    rng = np.random.RandomState(SEED + 30)
    batches = [(rng.randn(LM_BATCH, LM_T, LM_DIM).astype(np.float32),
                rng.randint(0, PIPE_CLASSES, (LM_BATCH, 1)).astype(
                    np.float32)) for _ in range(REMAT_STEPS)]
    w0 = _params_of(ckpt)
    bf16_cfg = cfgmod.parse_pairs(transformer_conf(
        pipeline_parallel=1, **dict(kw, compute_dtype="bfloat16")))
    train = {}
    for remat in (0, 1):
        tr = NetTrainer()
        tr.set_params(bf16_cfg + [("remat", str(remat))])
        tr.load_model(ckpt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rest = torch.cuda.memory_allocated()
        steps, losses = [], []
        for xb, yb in batches:
            before = {k.name: k.launches for k in KERNELS}
            tr.update_all(xb, yb)
            losses.append(float(tr.last_loss))
            steps.append({k.name: k.launches - before[k.name]
                          for k in KERNELS if k.launches - before[k.name]})
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        d = {kt: tr.params[kt[0]][kt[1]].detach().double().cpu().numpy()
             - w for kt, w in w0.items()}
        train[remat] = {"launches": steps, "losses": losses, "d": d,
                        "peak_gib": peak / 2 ** 30,
                        "peak_over_rest_gib": (peak - rest) / 2 ** 30}
        del tr
        if steps != [{"sgd_update": 1}] * REMAT_STEPS:
            raise SmokeError(f"27c: remat {remat} steps launched {steps}")
        if not np.isfinite(losses).all():
            raise SmokeError(f"27c: remat {remat} losses {losses}")
        log(f"27c pipe: remat {remat}: {REMAT_STEPS} bf16 steps, losses "
            f"{[round(v, 4) for v in losses]}, launches {steps[0]} a step; "
            f"peak {peak / 2 ** 30:.3f} GiB, "
            f"{(peak - rest) / 2 ** 30:.3f} GiB over the resident state; "
            f"{card}")
    rel = {kt: _rel_err(train[1]["d"][kt], d0)
           for kt, d0 in train[0]["d"].items()}
    log(f"27c pipe: updates remat 1 vs 0: worst rel {max(rel.values()):.3g}"
        f" (limit {LM_UPDATE_REL:g})")
    if max(rel.values()) > LM_UPDATE_REL:
        raise SmokeError(f"27c: remat changed the pipe stack's updates: "
                         f"{sorted(rel.items(), key=lambda kv: -kv[1])[:5]}")
    for r in train.values():
        del r["d"]
    return {"forward": fwd, "train": train, "worst_rel": max(rel.values())}


def remat_googlenet_phase(tmp: str, card: str):
    """27d: ``REMAT_STEPS`` b128 bf16 steps of googlenet.conf (rates times
    ``LR_SCALE``, dropout on) from one seeded checkpoint under ``remat =
    0`` and ``1``: without remat each step launches ``PER_STEP`` and K8
    once; under remat the forward kernels (K1, K4, K6) run again in the
    backward's recompute and the others as often; each update at cosine
    >= ``REMAT_COS``; the peak memory both ways."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS

    cfg = cfgmod.parse_pairs(_net_text(CONF, LR_SCALE)) + [
        ("dev", "gpu"), ("silent", "1"), ("eval_train", "0")]
    side = int(dict(cfg)["input_shape"].split(",")[1])
    src = NetTrainer()
    src.set_params(cfg + [("seed", str(SEED))])
    src.init_model()
    ckpt = os.path.join(tmp, "googlenet.model")
    src.save_model(ckpt)
    del src
    w0 = _params_of(ckpt)
    rng = np.random.RandomState(SEED + 31)
    batches = [(rng.randn(BATCH, side, side, 3).astype(np.float32),
                rng.randint(0, 1000, (BATCH, 1)).astype(np.float32))
               for _ in range(REMAT_STEPS)]
    plain = {**{k.name: 0 for k in KERNELS}, **PER_STEP, "sgd_update": 1}
    out = {}
    for remat in (0, 1):
        tr = NetTrainer()
        tr.set_params(cfg + [("remat", str(remat))])
        tr.load_model(ckpt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rest = torch.cuda.memory_allocated()
        steps, losses = [], []
        for xb, yb in batches:
            before = {k.name: k.launches for k in KERNELS}
            tr.update_all(xb, yb)
            losses.append(float(tr.last_loss))
            steps.append({k.name: k.launches - before[k.name]
                          for k in KERNELS})
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        d = {kt: tr.params[kt[0]][kt[1]].detach().double().cpu().numpy()
             - w for kt, w in w0.items()}
        del tr
        out[remat] = {"launches": steps[0], "losses": losses, "d": d,
                      "peak_gib": peak / 2 ** 30,
                      "peak_over_rest_gib": (peak - rest) / 2 ** 30}
        log(f"27d googlenet: remat {remat}: {REMAT_STEPS} b{BATCH} bf16 "
            f"steps, losses {[round(v, 4) for v in losses]}, launches a "
            f"step {steps[0]}; peak {peak / 2 ** 30:.3f} GiB, "
            f"{(peak - rest) / 2 ** 30:.3f} GiB over the resident state; "
            f"{card}")
        if any(s != steps[0] for s in steps):
            raise SmokeError(f"27d: remat {remat} steps differ: {steps}")
        if not np.isfinite(losses).all():
            raise SmokeError(f"27d: remat {remat} losses {losses}")
    if out[0]["launches"] != plain:
        raise SmokeError(f"27d: a step launched {out[0]['launches']}, "
                         f"expected {plain}")
    rerun = {n: out[1]["launches"][n] - c for n, c in plain.items()}
    if not (all(v >= 0 for v in rerun.values())
            and all(rerun[n] > 0 for n in PER_FORWARD)
            and out[1]["launches"]["sgd_update"] == 1):
        raise SmokeError(f"27d: under remat a step launched "
                         f"{out[1]['launches']}, against {plain} without")
    cos = {kt: float((a * out[1]["d"][kt]).sum()
                     / (np.linalg.norm(a) * np.linalg.norm(out[1]["d"][kt])))
           for kt, a in out[0]["d"].items()}
    equal = all(np.array_equal(a, out[1]["d"][kt])
                for kt, a in out[0]["d"].items())
    worst = min(cos, key=cos.get)
    log(f"27d googlenet: updates remat 1 vs 0: bit-equal {equal}; worst "
        f"cosine {cos[worst]:.6f} at {'/'.join(worst)} (limit "
        f"{REMAT_COS:g}); launches rerun by the recompute {rerun}")
    if cos[worst] < REMAT_COS:
        raise SmokeError(f"27d: remat changed GoogLeNet's updates: "
                         f"{sorted(cos.items(), key=lambda kv: kv[1])[:5]}")
    for r in out.values():
        del r["d"]
    return {"remat": out, "bit_equal": equal, "worst_cos": cos[worst]}


def moe_pipe_remat_phase(card: str):
    """Phase 27: 27a-27d, each in one temporary directory, the device's
    allocator cache emptied between them; returns their readings."""
    import torch

    out = {"card": card}
    t0 = time.perf_counter()
    for name, fn in (("remat_lm", remat_lm_phase), ("moe_lm", moe_lm_phase),
                     ("pipe", pipe_phase),
                     ("remat_googlenet", remat_googlenet_phase)):
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as tmp:
            out[name] = fn(tmp, card)
        torch.cuda.empty_cache()
        out[name]["phase_s"] = time.perf_counter() - t1
    out["phase_s"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# phase 28: data parallelism (parallel/): two ranks on the card
DP_RANKS = 2
DP_DEV = "gpu:0"  # every rank's dev: the ranks share the card (gloo)
DP_STEPS = 2  # 28a's compared steps, each rank on its 64 of 128 rows
DP_TIMED = 1  # steps timed after them, each way
DP_DEADLINE_S = 420  # each rank process, start-up included
DP_SHARD_LIMIT = 0.55  # 28b: a rank's train-state bytes / one replica
DP_DET_STEPS = 2
DP_CLI_ROWS = 256  # 28a's CLI run: 2 global steps of 128 rows
# cuDNN's deterministic algorithms in 28a/28b's compared runs (both
# sides), so a difference is the batch split's, not an atomic add's
DP_DETERMINISTIC = True
# 28a's f32 updates after DP_STEPS steps, two ranks vs one, per tensor
# max|d2 - d1| / max|d1| and its median: from the conf's init GoogLeNet's
# first steps amplify rounding (loss 345 -> 118 -> 72), so that one rank
# against its own rerun with cuDNN's atomics read 8.8e-4 and 2.8e-4
# after 3 steps (3.2e-5 and 2.1e-7 after 1), and two ranks against one
# 4.7e-3 and 1.4e-3 (my chip runs, PR 20); after the first step the
# two-rank update is held at UPDATE_REL, UPDATE_REL_MEDIAN
DP_F32_REL, DP_F32_REL_MEDIAN = 2e-2, 5e-3
# 28b's batch norm running statistics (bn_eval = running), two ranks vs
# one, per tensor max|a2 - a1| / max|a1|: f32 (held with the updates'
# cosines at RESNET_F32_COS, RESNET_F32_COS_MEDIAN) and bf16 (with the
# loss and the classifier's update cosine at RESNET_BF16_CLS_COS; the
# other bf16 updates' cosines are logged: ResNet-50's bf16 step from its
# random init is ill-conditioned, ROADMAP.md section C, and read worst
# 0.142, median 0.486).  The bf16 statistics read worst 9.7e-3, median
# 1.4e-4 at b128 (my chip runs, PR 20)
DP_AUX_REL, DP_AUX_REL_MEDIAN = 1e-3, 1e-4
DP_AUX_BF16_REL, DP_AUX_BF16_REL_MEDIAN = 5e-2, 1e-3
DP_RN_LOSS_REL = 1e-3
# 28c: dist.conf's rounds (round 5 is the first off chance: the test
# error reads 0.94 for 4 rounds, then 0.79 and 0.535 on the CPU), the
# weights two ranks vs one after each round as max|w2 - w1| over the
# one-rank update's max|w1 - w0| (1.8e-6 on the CPU over 15 rounds), the
# test error within one image of the 200 evaluated (the test iterator
# drops the last partial batch of the 297), and the one-rank run's last
# test error, which must lie under chance (0.9) for the error check to
# see anything
DP_DIGITS_ROUNDS = 6
DP_DIGITS_REL = 1e-4
DP_DIGITS_ERR = 1 / 200
DP_DIGITS_LEARNED = 0.8
# seed 25 flips the sign bit of a weight of fc2 on rank 1; the flip run
# keeps the weights' updates whole (update_on_server = 0): under ZeRO-1
# each step rebuilds every weight from its owner's slice, which heals a
# flip in another rank's slice and copies one in rank 1's to every rank
DP_FLIP = ("fault_seed=25", "fault_inject=device.state:bitflip:1:1")
DIST_CONF = os.path.join(REPO, "example", "MNIST", "dist.conf")
# the digits' 8x8 images and their test set for dist.conf (written for
# the 28x28 MNIST files): the only keys 28c adds to the conf
DP_DIGITS_KEYS = ("input_shape=1,1,64", f"num_round={DP_DIGITS_ROUNDS}",
                  f"dev={DP_DEV}", "print_step=0")
DP_DIGITS_EVAL = """
eval = test
iter = mnist
    path_img = "./data/digits-t10k-images-idx3-ubyte"
    path_label = "./data/digits-t10k-labels-idx1-ubyte"
iter = end
"""


def _dp_batch(k: int, rows: int, side: int):
    """28a/28b's k-th global batch: seeded N(0, 1) images and labels."""
    import numpy as np

    rng = np.random.RandomState(SEED + 28 + k)
    return (rng.randn(rows, side, side, 3).astype(np.float32),
            rng.randint(0, 1000, (rows, 1)).astype(np.float32))


def _dp_steps(tr, steps: int, rows: slice, side: int, counted: bool):
    """``steps`` updates of ``tr`` on its ``rows`` of the global batches;
    with ``counted`` each step's launches (counts at 0 just before),
    host ms in the collectives, the losses, K8's elements a launch and
    the weights after the first step (``first``) are recorded."""
    import torch

    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.ops.kernels import update_step
    from cxxnet_tpu_torch.parallel import distributed as pdist

    k8 = []
    multi = update_step.sgd_update_multi

    def watched(ws, *args):
        k8.append(sum(w.numel() for w in ws))
        return multi(ws, *args)

    update_step.sgd_update_multi = watched
    out = {"launches": [], "collective_ms": [], "losses": [], "k8_elems": k8}
    try:
        for k in range(steps):
            x, y = _dp_batch(k, tr.batch_size, side)
            if counted:
                for kern in KERNELS:
                    kern.reset_counts()
            c0 = pdist.STATS["seconds"]
            tr.update_all(x[rows], y[rows])
            tr.sync()
            if counted:
                out["launches"].append({kern.name: kern.launches
                                        for kern in KERNELS})
            out["collective_ms"].append(
                (pdist.STATS["seconds"] - c0) * 1e3)
            out["losses"].append(float(tr.last_loss))
            if k == 0 and counted:
                out["first"] = _dp_params(tr)[0]
    finally:
        update_step.sgd_update_multi = multi
    return out


def _dp_time(tr, rows: slice, side: int):
    """Median ms of ``DP_TIMED`` steps on one device-resident batch (the
    host clock around a synchronized step) and the host ms a step spent
    inside the collectives."""
    import torch

    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.parallel import distributed as pdist

    x, y = _dp_batch(0, tr.batch_size, side)
    batch = DataBatch(data=torch.as_tensor(x[rows], device=tr.device),
                      label=torch.as_tensor(y[rows], device=tr.device))
    tr.update(batch)
    tr.sync()
    times, coll = [], []
    for _ in range(DP_TIMED):
        c0, t0 = pdist.STATS["seconds"], time.perf_counter()
        tr.update(batch)
        tr.sync()
        times.append((time.perf_counter() - t0) * 1e3)
        coll.append((pdist.STATS["seconds"] - c0) * 1e3)
    return statistics.median(times), statistics.median(coll)


def _dp_params(tr):
    """The whole weights and layer state as f64 numpy (collective under
    ``zero = 3``)."""
    return ({(k, t): w.detach().double().cpu().numpy()
             for k, tags in tr._full_params().items()
             for t, w in tags.items()},
            {(k, t): a.detach().double().cpu().numpy()
             for k, tags in tr.aux.items() for t, a in tags.items()})


def _dp_trainer(cfg, ckpt, dtype: str, dev: str):
    """A trainer of ``cfg`` on ``dev`` in ``dtype``, loaded from
    ``ckpt`` (None: drawn from the conf's seed)."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    tr = NetTrainer()
    tr.set_params(cfg + [("dev", dev), ("compute_dtype", dtype),
                         ("print_step", "0"), ("seed", str(SEED))])
    if ckpt is None:
        tr.init_model()
    else:
        tr.load_model(ckpt)
    return tr


def _dp_runs(spec):
    """The runs of 28a, each ``(name, cfg, checkpoint, dtype, steps,
    timed)``, in the order every process takes them (the NCCL job:
    ``spec["only"]``).  28b's ResNet-50 ``zero = 3`` runs are phase
    33a's rank job's (one job, not two)."""
    runs = [("gn_f32", spec["gn_cfg"], spec["gn_ckpt"], "float32",
             DP_STEPS, False),
            ("gn_bf16", spec["gn_cfg"], spec["gn_ckpt"], "bfloat16",
             DP_STEPS, True)]
    return [r for r in runs if r[0] in spec.get("only", [r[0]])]


def _dp_run_all(spec, rank: int, world: int, out_dir: str):
    """Every run of :func:`_dp_runs` on this process's rows (rank
    ``rank`` of ``world``), then 28a's ``det_reduce = 1`` pair; writes
    ``<out_dir>/<name>.r<rank>.npz`` (the weights, rank 0 only, and
    their CRCs) and returns the readings."""
    import zlib

    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = DP_DETERMINISTIC
    res = {}
    for name, cfg, ckpt, dtype, steps, timed in _dp_runs(spec):
        cfg = [tuple(p) for p in cfg]
        tr = _dp_trainer(cfg, ckpt, dtype, spec["dev"])
        side = int(dict(cfg)["input_shape"].split(",")[1])
        local = tr.batch_size // world
        rows = slice(rank * local, (rank + 1) * local)
        per, total = tr.state_shard_bytes()
        r = _dp_steps(tr, steps, rows, side, counted=True)
        r.update(shard_bytes=sum(per.values()), total_bytes=total)
        first = r.pop("first")
        params, aux = _dp_params(tr)
        r["crc"] = {"/".join(kt): zlib.crc32(w.tobytes())
                    for kt, w in sorted(params.items())}
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{name}.npz"),
                     **{"p:" + "/".join(kt): w for kt, w in params.items()},
                     **{"a:" + "/".join(kt): a for kt, a in aux.items()},
                     **{"f:" + "/".join(kt): w for kt, w in first.items()})
        if timed:
            r["step_ms"], r["timed_collective_ms"] = _dp_time(tr, rows, side)
        del tr, params, aux
        torch.cuda.empty_cache()
        res[name] = r
    if "only" in spec:
        return res
    # det_reduce = 1 on the net without its dropout layers (the JAX
    # package refuses random layers there), twice from the seed: the
    # same bits
    det_cfg, skip = [], False
    for n, v in (tuple(p) for p in spec["gn_cfg"]):
        if n.startswith("layer["):
            skip = v == "dropout"
        if not skip:
            det_cfg.append((n, v))
    det_cfg += [("det_reduce", "1")]
    crcs = []
    for _ in range(2):
        tr = _dp_trainer(det_cfg, None, "bfloat16", spec["dev"])
        side = int(dict(det_cfg)["input_shape"].split(",")[1])
        local = tr.batch_size // world
        _dp_steps(tr, DP_DET_STEPS, slice(rank * local, (rank + 1) * local),
                  side, counted=False)
        crcs.append(zlib.crc32(b"".join(
            w.tobytes() for _kt, w in sorted(_dp_params(tr)[0].items()))))
        del tr
        torch.cuda.empty_cache()
    res["det_crcs"] = crcs
    return res


def dp_rank_main(spec_path: str, rank: int) -> int:
    """One rank process of phase 28 (``python chip_smoke.py --dp-rank
    SPEC RANK``): joins the group, takes the runs, writes
    ``<out>/rank<rank>.json``."""
    sys.path.insert(0, REPO)
    with open(spec_path) as f:
        spec = json.load(f)
    # the parent's step counts (one module, one set of constants)
    globals().update(spec["consts"])
    from cxxnet_tpu_torch.parallel import distributed as pdist

    world = spec["world"]
    t0 = time.perf_counter()
    pdist.init_distributed(spec["coord"], world, rank, dev=spec["dev"],
                           timeout_s=spec["timeout_s"])
    join_s = time.perf_counter() - t0
    res = _dp_run_all(spec, rank, world, spec["out"])
    res.update(backend=pdist.backend(), join_s=join_s)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    pdist.shutdown_distributed()
    return 0


def _dp_start(argvs, cwd, tag, envs=None):
    """Start rank processes (their output in ``<cwd>/<tag>.r<i>.log``);
    returns ``(procs, logs)`` for :func:`_dp_finish`."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs, logs = [], []
    for i, argv in enumerate(argvs):
        logs.append(os.path.join(cwd, f"{tag}.r{i}.log"))
        with open(logs[-1], "w") as out:
            procs.append(subprocess.Popen(
                argv, cwd=cwd, env=dict(env, **(envs[i] if envs else {})),
                stdout=out, stderr=subprocess.STDOUT))
    return procs, logs


def _dp_finish(job, t0):
    """Wait for a :func:`_dp_start` job until ``DP_DEADLINE_S`` after
    ``t0``; every process still running then is killed.  Returns
    ``(codes, outputs)``."""
    procs, logs = job
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t0 + DP_DEADLINE_S - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for lf in logs:
        with open(lf, errors="replace") as f:
            outs.append(f.read())
    return [p.returncode for p in procs], outs


def _dp_spawn(argvs, cwd, tag, envs=None):
    """:func:`_dp_start` and :func:`_dp_finish`."""
    t0 = time.perf_counter()
    return _dp_finish(_dp_start(argvs, cwd, tag, envs), t0)


def _rel_updates(a, b, w0):
    """Per tensor ``max|da - db| / max|db|`` of the updates from ``w0``."""
    import numpy as np

    out = {}
    for kt, w in w0.items():
        da, db = a[kt] - w, b[kt] - w
        out[kt] = float(np.abs(da - db).max() / max(np.abs(db).max(), 1e-30))
    return out


def _cos_updates(a, b, w0):
    import numpy as np

    out = {}
    for kt, w in w0.items():
        da, db = (a[kt] - w).ravel(), (b[kt] - w).ravel()
        n = np.linalg.norm(da) * np.linalg.norm(db)
        # a zero update scores 1 only against a zero reference
        out[kt] = float(da @ db / n) if n > 0 else float(
            not da.any() and not db.any())
    return out


def _dp_check(tag, vals, limit, median_limit, lower_is_better,
              phase: str = "28"):
    """Log the worst five and fail past a limit."""
    ordered = sorted(vals.items(), key=lambda kv: kv[1],
                     reverse=lower_is_better)
    med = statistics.median(vals.values())
    log(f"{phase} {tag}: worst {ordered[0][1]:.4g} at "
        f"{'/'.join(ordered[0][0])} "
        f"(limit {limit:g}), median {med:.4g} (limit {median_limit:g}); "
        "worst 5: " + ", ".join(f"{'/'.join(kt)} {v:.4g}"
                                for kt, v in ordered[:5]))
    worse = ((lambda v, lim: not v <= lim) if lower_is_better
             else (lambda v, lim: not v >= lim))
    bad = [kt for kt, v in vals.items() if worse(v, limit)]
    if bad or worse(med, median_limit):
        raise SmokeError(f"{phase} {tag}: {len(bad)} tensor(s) past {limit:g} "
                         f"{bad[:6]} or median {med:.4g}")
    return ordered[0][1], med


def _dp_reference(spec):
    """28a/28b's one-rank runs in this process, on the card alone: each
    run's weights and layer state after its steps, its launches, and
    its timed step."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = DP_DETERMINISTIC
    ref = {}
    for name, cfg, ckpt, dtype, steps, timed in _dp_runs(spec):
        cfg = [tuple(p) for p in cfg]
        tr = _dp_trainer(cfg, ckpt, dtype, spec["dev"])
        side = int(dict(cfg)["input_shape"].split(",")[1])
        w0 = _dp_params(tr)[0]
        r = _dp_steps(tr, steps, slice(None), side, counted=True)
        r["params"], r["aux"] = _dp_params(tr)
        r["w0"] = w0
        if timed:
            r["step_ms"], _ = _dp_time(tr, slice(None), side)
        r["batch"] = tr.batch_size
        del tr
        torch.cuda.empty_cache()
        ref[name] = r
    return ref


def dp_googlenet_resnet_phase(tmp: str, card: str):
    """28a (GoogLeNet, bf16 and f32): the one-rank runs here, then two
    rank processes sharing the card over gloo (``dev = gpu:0`` on both),
    each on its 64 of every 128-row global batch, from the same
    checkpoint; returns the readings."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve.fleet import free_port

    gn_cfg = cfgmod.parse_file(_train_conf(tmp))
    tr = NetTrainer()
    tr.set_params(gn_cfg + [("dev", DP_DEV), ("seed", str(SEED))])
    tr.init_model()
    gn_ckpt = os.path.join(tmp, "dp_gn.model")
    tr.save_model(gn_ckpt)
    del tr
    out_dir = os.path.join(tmp, "dp_out")
    os.makedirs(out_dir, exist_ok=True)
    spec = {"gn_cfg": gn_cfg, "gn_ckpt": gn_ckpt, "world": DP_RANKS,
            "coord": f"127.0.0.1:{free_port()}", "timeout_s": 120.0,
            "out": out_dir, "dev": DP_DEV,
            "consts": {k: globals()[k] for k in (
                "DP_STEPS", "DP_TIMED", "DP_DET_STEPS", "DP_DETERMINISTIC",
                "SEED")}}
    t0 = time.perf_counter()
    ref = _dp_reference(spec)
    ref_s = time.perf_counter() - t0
    spec_path = os.path.join(tmp, "dp_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    codes, outs = _dp_spawn(
        [[sys.executable, os.path.abspath(__file__), "--dp-rank", spec_path,
          str(r)] for r in range(DP_RANKS)], tmp, "dp_rank")
    ranks_s = time.perf_counter() - t0
    if any(c != 0 for c in codes):
        raise SmokeError(f"28a/b: rank exits {codes}: "
                         + " | ".join(o[-2500:] for o in outs))
    got = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            got.append(json.load(f))
    log(f"28a/b: one-rank runs {ref_s:.1f}s; {DP_RANKS} ranks {ranks_s:.1f}s"
        f" (join {[round(g['join_s'], 1) for g in got]} s); backend "
        f"{got[0]['backend']}, collectives on the card's tensors")
    if got[0]["backend"] != "gloo":
        raise SmokeError(f"28: two ranks on one card ran {got[0]['backend']}")
    per_rank = {}
    for name, want in (("gn_f32", IMGBIN_PER_STEP),
                       ("gn_bf16", IMGBIN_PER_STEP)):
        d = np.load(os.path.join(out_dir, f"{name}.npz"))

        def part(pre):
            return {tuple(k[2:].split("/")): d[k].astype(np.float64)
                    for k in d.files if k.startswith(pre)}

        two_p, two_f = part("p:"), part("f:")
        r1 = ref[name]
        for r, g in enumerate(got):
            if g[name]["crc"] != got[0][name]["crc"]:
                diff = [k for k, v in g[name]["crc"].items()
                        if got[0][name]["crc"][k] != v]
                raise SmokeError(f"28 {name}: rank {r}'s weights differ from "
                                 f"rank 0's: {diff[:6]}")
            for s, launches in enumerate(g[name]["launches"]):
                miss = {k: v for k, v in want.items()
                        if launches.get(k, 0) != v}
                if miss:
                    raise SmokeError(f"28 {name}: rank {r} step {s} launched "
                                     f"{launches}, want {want}")
        cos = _cos_updates(two_p, r1["params"], r1["w0"])
        if name == "gn_f32":
            _dp_check("gn f32 2 ranks vs 1, first step's update rel",
                      _rel_updates(two_f, r1["first"], r1["w0"]),
                      UPDATE_REL, UPDATE_REL_MEDIAN, True)
            _dp_check(f"gn f32 2 ranks vs 1, {DP_STEPS} steps' update rel",
                      _rel_updates(two_p, r1["params"], r1["w0"]),
                      DP_F32_REL, DP_F32_REL_MEDIAN, True)
        else:
            _dp_check("gn bf16 2 ranks vs 1, update cosine", cos,
                      UPDATE_COS, UPDATE_COS_MEDIAN, False)
        g0 = got[0][name]
        row = {"launches_a_step": g0["launches"][0],
               "losses_2": g0["losses"], "losses_1": r1["losses"],
               "collective_ms_a_step": [g[name]["collective_ms"]
                                        for g in got],
               "k8_elements": [g[name]["k8_elems"][0] for g in got],
               "k8_elements_1": r1["k8_elems"][0],
               "shard_bytes": [g[name]["shard_bytes"] for g in got],
               "total_bytes": g0["total_bytes"]}
        if "step_ms" in g0:
            row.update(step_ms=[g[name]["step_ms"] for g in got],
                       timed_collective_ms=[g[name]["timed_collective_ms"]
                                            for g in got],
                       step_ms_1=r1["step_ms"],
                       img_s=r1["batch"] / max(
                           g[name]["step_ms"] for g in got) * 1e3,
                       img_s_1=r1["batch"] / r1["step_ms"] * 1e3)
        per_rank[name] = row
        log(f"28 {name}: per rank a step launches {g0['launches'][0]}; "
            f"K8 elements {row['k8_elements']} (one rank: "
            f"{row['k8_elements_1']}); losses 2 ranks {g0['losses']}, 1 rank"
            f" {r1['losses']}; collectives host ms a step "
            f"{[[round(v, 1) for v in c] for c in row['collective_ms_a_step']]}"
            + (f"; step ms {[round(v, 1) for v in row['step_ms']]} vs "
               f"{r1['step_ms']:.1f} one rank: {row['img_s']:.0f} img/s vs "
               f"{row['img_s_1']:.0f} ({card})" if "step_ms" in row else ""))
    dets = [g["det_crcs"] for g in got]
    log(f"28a: det_reduce=1, dropout layers out, two runs' weight CRCs by "
        "rank "
        f"{dets}")
    if any(d[0] != d[1] for d in dets) or len({d[0] for d in dets}) != 1:
        raise SmokeError(f"28a: det_reduce runs differ: {dets}")
    launches_dp = {}
    for g in got:
        for name in ("gn_f32", "gn_bf16"):
            for step in g[name]["launches"]:
                for k, v in step.items():
                    launches_dp[k] = launches_dp.get(k, 0) + v
    nccl = "not run: 1 card"
    if torch.cuda.device_count() >= DP_RANKS:
        nccl = _dp_nccl(spec, tmp, ref)
    log(f"28a: NCCL over {DP_RANKS} cards: {nccl}")
    return {"per_run": per_rank, "launches_dp": launches_dp,
            "backend": got[0]["backend"],
            "ranks_s": ranks_s, "reference_s": ref_s, "nccl": nccl}


def _dp_nccl(spec, tmp: str, ref):
    """The bf16 GoogLeNet run again with rank r on card r (``dev =
    gpu:0-1``: NCCL): the ranks agree bit for bit and the updates hold
    the one-rank run's cosines."""
    import numpy as np

    from cxxnet_tpu_torch.serve.fleet import free_port

    out_dir = os.path.join(tmp, "dp_nccl")
    os.makedirs(out_dir, exist_ok=True)
    spec = dict(spec, dev=f"gpu:0-{DP_RANKS - 1}", only=["gn_bf16"],
                coord=f"127.0.0.1:{free_port()}", out=out_dir)
    path = os.path.join(tmp, "dp_nccl.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    codes, outs = _dp_spawn(
        [[sys.executable, os.path.abspath(__file__), "--dp-rank", path,
          str(r)] for r in range(DP_RANKS)], tmp, "dp_nccl")
    if any(c != 0 for c in codes):
        raise SmokeError(f"28 NCCL: rank exits {codes}: "
                         + " | ".join(o[-2500:] for o in outs))
    got = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            got.append(json.load(f))
    if got[0]["backend"] != "nccl" or any(
            g["gn_bf16"]["crc"] != got[0]["gn_bf16"]["crc"] for g in got):
        raise SmokeError(f"28 NCCL: backend {got[0]['backend']} or the "
                         "ranks' weights differ")
    d = np.load(os.path.join(out_dir, "gn_bf16.npz"))
    two = {tuple(k[2:].split("/")): d[k].astype(np.float64)
           for k in d.files if k.startswith("p:")}
    r1 = ref["gn_bf16"]
    worst, med = _dp_check("gn bf16 NCCL 2 cards vs 1, update cosine",
                           _cos_updates(two, r1["params"], r1["w0"]),
                           UPDATE_COS, UPDATE_COS_MEDIAN, False)
    return {"backend": "nccl", "worst_cos": worst, "median_cos": med,
            "step_ms": [g["gn_bf16"]["step_ms"] for g in got]}


def dp_cli_digits_phase(tmp: str, card: str):
    """28a's ``task=train`` through the CLI and 28c, their rank processes
    started together (the card shared; none of their readings is a
    time).  28a's CLI run: two ranks (``dist_num_proc = 2``, ``dev =
    gpu:0``, ``test_on_server = 1``), 1 round of GoogLeNet on
    ``DP_CLI_ROWS`` rows: both ranks print the weight-sync line and the
    ``mesh:`` line naming gloo, and rank 0 writes the checkpoints after
    the ranks' CRCs agree, keeping the newest (``keep_latest = 1``).
    28c: ``example/MNIST/dist.conf``
    (``update_on_server = 1``) with a test section on the UCI digits,
    ``DP_DIGITS_ROUNDS`` rounds, two ranks by hand (``CXN_PROC_ID``)
    against this process's one-rank run of the conf without its
    ``dist_*`` lines: the weights within ``DP_DIGITS_REL`` of the
    one-rank update's size, the rank-summed test error within
    ``DP_DIGITS_ERR``, the one-rank run off chance; and a bit flipped on rank 1 only: the vote finds
    it and both ranks stop with ``INTEGRITY:`` before the round is
    saved."""
    import numpy as np

    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve.fleet import free_port
    from cxxnet_tpu_torch.tools.make_digits_idx import write_digits_idx

    conf = _synthetic_conf(tmp, "dp_cli.conf",
                           (("data", "train", DP_CLI_ROWS, True),
                            ("eval", "val", BATCH, False)), LR_SCALE)
    write_digits_idx(os.path.join(tmp, "data"))
    with open(DIST_CONF) as f:
        text = f.read() + DP_DIGITS_EVAL
    two = os.path.join(tmp, "dist_eval.conf")
    one = os.path.join(tmp, "one_eval.conf")
    with open(two, "w") as f:
        f.write(text)
    with open(one, "w") as f:
        f.write("\n".join(l for l in text.splitlines()
                          if not l.startswith("dist_")) + "\n")
    ports = [free_port() for _ in range(3)]
    by_hand = [{"CXN_PROC_ID": str(r)} for r in range(DP_RANKS)]
    t0 = time.perf_counter()
    cli = _dp_start(
        [[sys.executable, "-m", "cxxnet_tpu_torch", conf, "task=train",
          f"dev={DP_DEV}", "num_round=1", "max_round=1", f"seed={SEED}",
          "print_step=0", "test_on_server=1", "dist_num_proc=2",
          f"dist_proc_id={r}", f"dist_coordinator=127.0.0.1:{ports[0]}",
          "dist_timeout_s=120", f"model_dir={tmp}/dp_cli_models",
          "keep_latest=1"]
         for r in range(DP_RANKS)], tmp, "dp_cli")
    digits = _dp_start(
        [[sys.executable, "-m", "cxxnet_tpu_torch", two, *DP_DIGITS_KEYS,
          f"dist_coordinator=127.0.0.1:{ports[1]}", "dist_timeout_s=120",
          "model_dir=m2"]] * DP_RANKS, tmp, "dp_digits", envs=by_hand)
    flip = _dp_start(
        [[sys.executable, "-m", "cxxnet_tpu_torch", two, *DP_DIGITS_KEYS,
          "num_round=1", "integrity_every=1", "update_on_server=0",
          f"dist_coordinator=127.0.0.1:{ports[2]}", "dist_timeout_s=120",
          "model_dir=m3", *(DP_FLIP if r == 1 else ())]
         for r in range(DP_RANKS)], tmp, "dp_flip", envs=by_hand)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with _Tee() as tee:
            _run_train_task([one, *DP_DIGITS_KEYS, "model_dir=m1"])
        one_out = "".join(tee.text)
    finally:
        os.chdir(cwd)
    results = {name: _dp_finish(job, t0)
               for name, job in (("cli", cli), ("digits", digits),
                                 ("flip", flip))}
    wall = time.perf_counter() - t0
    for name in ("cli", "digits"):
        codes, outs = results[name]
        if any(c != 0 for c in codes):
            raise SmokeError(f"28 {name}: exits {codes}: "
                             + " | ".join(o[-2500:] for o in outs))
    # 28a's CLI run
    outs = results["cli"][1]
    for r, o in enumerate(outs):
        if ("weight-sync:max_dev=0 ok" not in o
                or "mesh: data=2 model=1 zero=0 processes=2 backend=gloo"
                not in o):
            raise SmokeError(f"28a CLI: rank {r} output {o[-2500:]}")
    saved = sorted(os.listdir(os.path.join(tmp, "dp_cli_models")))
    # keep_latest = 1 (ROADMAP C7): the newest round and its manifest
    if saved != ["0001.model", "0001.model.manifest.json"]:
        raise SmokeError(f"28a CLI: keep_latest=1 left {saved}")
    mesh = [line for line in outs[0].splitlines() if line.startswith("mesh:")]
    log(f"28a CLI: 2 ranks, 1 round: {mesh}; saved {saved}; weight-sync ok "
        f"on both ranks ({card})")
    # 28c

    def errs(o):
        return [float(l.split("test-error:")[1].split()[0])
                for l in o.splitlines() if "test-error:" in l]

    e1, e2 = errs(one_out), [errs(o) for o in results["digits"][1]]

    def params(run, r):
        return NetTrainer._read_model_file(
            os.path.join(tmp, run, f"{r:04d}.model"))[1]

    w0 = params("m1", 0)
    worst, upd = 0.0, {}
    for r in range(1, DP_DIGITS_ROUNDS + 1):
        a, b = params("m2", r), params("m1", r)
        for k in b:
            for t in b[k]:
                d1 = float(np.abs(b[k][t] - w0[k][t]).max())
                upd[f"{k}/{t}"] = d1
                worst = max(worst, float(np.abs(a[k][t] - b[k][t]).max())
                            / max(d1, 1e-30))
    log(f"28c dist.conf on the digits, {DP_DIGITS_ROUNDS} rounds: test error "
        f"by round, ranks {e2}, one rank {e1}; weights two ranks vs one "
        f"max|w2 - w1| / max|w1 - w0| {worst:.3g} (limit {DP_DIGITS_REL:g});"
        " the one-rank update max|w1 - w0| after the last round "
        + ", ".join(f"{k} {v:.3g}" for k, v in upd.items()))
    if (e2[0] != e2[1] or len(e1) != DP_DIGITS_ROUNDS
            or len(e2[0]) != DP_DIGITS_ROUNDS or worst > DP_DIGITS_REL
            or any(abs(a - b) > DP_DIGITS_ERR + 1e-12
                   for a, b in zip(e2[0], e1))):
        raise SmokeError(f"28c: 2 ranks vs 1: errors {e2} vs {e1}, weights "
                         f"rel {worst:g}")
    if not e1[-1] < DP_DIGITS_LEARNED:
        raise SmokeError(f"28c: the one-rank run stayed at chance: test "
                         f"errors {e1}")
    codes, outs = results["flip"]
    saved_flip = sorted(os.listdir(os.path.join(tmp, "m3")))
    verdicts = [next((l for l in o.splitlines() if l.startswith("INTEGRITY:")),
                     None) for o in outs]
    log(f"28c bitflip on rank 1: exits {codes}; {verdicts}; saved "
        f"{saved_flip}; the three jobs together {wall:.1f}s")
    if (any(c == 0 for c in codes) or None in verdicts
            or "0001.model" in saved_flip):
        raise SmokeError(f"28c: the flip was not stopped: {codes} "
                         f"{verdicts} {saved_flip}")
    return {"cli_saved": saved, "errors_2": e2[0], "errors_1": e1,
            "weights_rel": worst, "update_max_abs": upd, "wall_s": wall,
            "flip_verdict": verdicts[0]}


def data_parallel_phase(card: str):
    """Phase 28: 28a/28b (with NCCL over two cards where the host has
    them: logged as not run on one card), then the CLI's 28a run and 28c
    together, each part in a temporary directory."""
    import torch

    out = {"card": card}
    t0 = time.perf_counter()
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        for name, fn in (("googlenet_resnet", dp_googlenet_resnet_phase),
                         ("cli_digits", dp_cli_digits_phase)):
            t1 = time.perf_counter()
            with tempfile.TemporaryDirectory(
                    prefix=f"chip_smoke_dp_{name}_") as tmp:
                out[name] = fn(tmp, card)
            torch.cuda.empty_cache()
            out[name]["phase_s"] = time.perf_counter() - t1
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    out["phase_s"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# phases 29 and 30: the async parameter-server step (k3) and the model
# axis with sequence parallelism (k2a), on the LM at LM_* width over two
# rank processes sharing the card (gloo), as phase 28's ranks do
MP_STEPS = 2  # 29's compared steps a round, each rank on its 4 of 8 rows
MP_TIMED = 2  # 29's timed steps each way, one fence after them
# 30: the one-rank LM step against the two-rank model axis, both bf16
# from one checkpoint on the whole batch: the loss (the ring merges its
# hops' bf16 outputs in f32, the one-rank kernel keeps one f32 row
# state: rounding apart; read 4.9e-6 for the ring and 0 for the
# all-to-all on an H100 80GB HBM3 at 700 W), per tensor the lower of the cosines of m1
# and of the resolved update (LM_UPDATE_COS, LM_UPDATE_COS_MEDIAN), and
# per tensor the norm of m1 over the one-rank m1's: on Adam's first
# step m1 is (1 - beta1) g, so a gradient the model axis scales by m
# moves this ratio by m, where both cosines stay blind to a scale
SP_LOSS_REL = 1e-4
SP_M1_NORM_REL = 1e-2
SP_MODES = ("ring", "alltoall")


def ring_hop_cases():
    """K9 and K10 in the ring's calls at the LM's width over two model
    ranks, each a hop's (B, T/2, H, D) blocks with its offsets: the
    diagonal (every rank's hop 0), rank 0's hop 1 (keys 1024 ahead of
    every query: fully masked, o = 0 and lse = -1e30) and rank 1's hop
    1 (every key visible); and the all-to-all form's local call on half
    the heads over the whole sequence.  Each is LM_LAYERS launches a
    rank's step."""
    import torch

    bf16, h, d, tl = torch.bfloat16, LM_HEADS, LM_DIM // LM_HEADS, LM_T // 2
    return [
        ("ring hop (0, 0), the diagonal", bf16, LM_BATCH, tl, tl, h, d,
         True, 0, 0, True, False, LM_LAYERS),
        (f"ring hop (0, {tl}), fully masked", bf16, LM_BATCH, tl, tl, h, d,
         True, 0, tl, True, False, LM_LAYERS),
        (f"ring hop ({tl}, 0), all visible", bf16, LM_BATCH, tl, tl, h, d,
         True, tl, 0, True, False, LM_LAYERS),
        ("alltoall local, half the heads", bf16, LM_BATCH, LM_T, LM_T,
         h // 2, d, True, 0, 0, False, False, LM_LAYERS),
    ]


def _mp_conf(adam: bool, seq_parallel: int = 0):
    """The LM conf pairs at LM_* width, ``attn_impl = pallas``, bf16, its
    attention layers' ``seq_parallel``; the k3 runs take SGD (the fused
    SGD kernel is the async apply's)."""
    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.models import transformer_lm_conf

    text = transformer_lm_conf(
        seq_len=LM_T, dim=LM_DIM, nhead=LM_HEADS, nlayer=LM_LAYERS,
        batch_size=LM_BATCH, dev=DP_DEV, compute_dtype="bfloat16",
        attn_impl="pallas", seq_parallel=seq_parallel)
    if not adam:
        text = text.replace("updater = adam\n", "")
    return cfgmod.parse_pairs(text) + [("seed", str(SEED)),
                                       ("print_step", "0"),
                                       ("eval_train", "0")]


def _mp_batch(k: int):
    """29/30's k-th global batch: LM_BATCH seeded byte windows."""
    import numpy as np

    rng = np.random.RandomState(SEED + 29 + k)
    return (rng.randint(0, 256, (LM_BATCH, LM_T)).astype(np.float32),
            rng.randint(0, 256, (LM_BATCH, LM_T)).astype(np.float32))


def _mp_weights_crc(tr) -> int:
    """The CRC32 of every whole weight's bytes (gathered over the model
    axis: collective), in the sorted tree's order."""
    import zlib

    crc = 0
    params = tr._full_params()
    for k in sorted(params):
        for t in sorted(params[k]):
            crc = zlib.crc32(params[k][t].detach().cpu().numpy()
                             .tobytes(), crc)
    return crc


def _mp_whole(tr, slot: str = ""):
    """Every whole weight as f32 numpy by ``key/tag`` (gathered over the
    model axis: collective), or with ``slot`` that updater slot's whole
    state."""
    out = {}
    params = tr._full_params()
    for k in sorted(params):
        for t in sorted(params[k]):
            w = tr._full_ustate(k, t)[slot] if slot else params[k][t]
            out[f"{k}/{t}"] = w.detach().float().cpu().numpy().copy()
    return out


def _mp_step(tr, k: int, rows, launches=None):
    """One update on ``rows`` of the k-th batch; with ``launches`` the
    step's counts (at 0 just before) are appended."""
    from cxxnet_tpu_torch.ops import KERNELS

    x, y = _mp_batch(k)
    if launches is not None:
        for kern in KERNELS:
            kern.reset_counts()
    tr.update_all(x[rows], y[rows])
    tr.sync()
    if launches is not None:
        launches.append({kern.name: kern.launches for kern in KERNELS})
    return float(tr.last_loss)


def _mp_timed(tr, rows) -> float:
    """ms a step over ``MP_TIMED`` steps on one batch with one fence after
    them (the async step's own fence is its round end)."""
    x, y = _mp_batch(0)
    x, y = x[rows], y[rows]
    tr.sync()
    t0 = time.perf_counter()
    for _ in range(MP_TIMED):
        tr.update_all(x, y)
    if tr._async is not None:
        tr.async_round_end(0)
    tr.sync()
    return (time.perf_counter() - t0) * 1e3 / MP_TIMED


def _k3_runs(spec, rank: int, world: int):
    """Phase 29 on this rank: ``det_reduce = 1``, then ``async_overlap =
    1`` at ``staleness = 0`` over one round, from one checkpoint (their
    weights' CRCs, launches and step times); then ``staleness = 1,
    async_resync_period = 1`` over two rounds (finite weights, the CRC
    after the last drain, the async block)."""
    import math

    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    res = {}
    cfg = [tuple(p) for p in spec["k3_cfg"]]
    local = LM_BATCH // world
    rows = slice(rank * local, (rank + 1) * local)
    for name, extra, rounds in (
            ("det", [("det_reduce", "1")], 1),
            ("s0", [("async_overlap", "1")], 1),
            ("s1", [("async_overlap", "1"), ("staleness", "1"),
                    ("async_resync_period", "1")], 2)):
        tr = NetTrainer()
        tr.set_params(cfg + extra)
        tr.load_model(spec["k3_ckpt"])
        launches, losses = [], []
        for r in range(rounds):
            for k in range(MP_STEPS):
                losses.append(_mp_step(tr, k, rows, launches))
            tr.async_round_end(r + 1)
        out = {"crc": _mp_weights_crc(tr), "launches": launches,
               "losses": losses, "async": tr.async_snapshot(),
               "finite": tr.weights_finite()}
        if name != "s1":
            out["step_ms"] = _mp_timed(tr, rows)
            if tr._async is not None:
                out["overlap_fraction"] = tr._async.last_overlap_fraction
        if not all(math.isfinite(v) for v in losses):
            out["finite"] = False
        res[name] = out
        del tr
    return res


def _k2a_runs(spec, rank: int):
    """Phase 30 on this rank: ``model_parallel = 2`` with ``seq_parallel
    = ring`` then ``alltoall`` (every rank on the whole batch), one step
    each from one checkpoint: the loss, the launches, the weights' CRC,
    and on rank 0 each tensor's cosines and m1 norm ratio against the
    one-rank step the parent saved (``_sp_cosines``,
    ``_sp_m1_norm_ratios``)."""
    import numpy as np

    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    res = {}
    ref = dict(np.load(spec["k2a_ref"])) if rank == 0 else None
    for mode in SP_MODES:
        tr = NetTrainer()
        tr.set_params([tuple(p) for p in spec["k2a_cfgs"][mode]]
                      + [("model_parallel", "2")])
        tr.load_model(spec["k2a_ckpt"])
        w0 = _mp_whole(tr)
        launches = []
        loss = _mp_step(tr, 0, slice(None), launches)
        out = {"loss": loss, "launches": launches[0],
               "crc": _mp_weights_crc(tr),
               "mesh": [tr.mesh_plan.n_data, tr.mesh_plan.n_model,
                        tr.mesh_plan.model_index]}
        w1, m1 = _mp_whole(tr), _mp_whole(tr, "m1")
        if ref is not None:
            out["cos"] = _sp_cosines(w1, m1, w0, ref)
            out["m1_norm"] = _sp_m1_norm_ratios(m1, ref)
        res[mode] = out
        del tr
    return res


def _sp_cosines(w1, m1, w0, ref):
    """Per tensor the lower of the cosines of Adam's m1 and of the update
    ``w1 - w0`` over the elements whose one-rank m1 is at least 1e-3 of
    its largest (as ``_lm_parity``), against the one-rank steps in
    ``ref`` (whole tensors by ``key/tag``: ``_mp_whole``)."""
    import numpy as np

    def cos(a, b):
        n = np.linalg.norm(a) * np.linalg.norm(b)
        return float((a * b).sum() / n) if n > 0 else float(
            not a.any() and not b.any())

    out = {}
    for name, w in w0.items():
        d = w1[name] - w
        d_r, m1_r = ref["d:" + name], ref["m1:" + name]
        sel = np.abs(m1_r) >= 1e-3 * np.abs(m1_r).max()
        out[name] = min(cos(m1[name], m1_r), cos(d[sel], d_r[sel]))
    return out


def _sp_m1_norm_ratios(m1, ref):
    """Per tensor |m1| / |m1 of the one-rank steps in ``ref``| (1.0 where
    both are 0)."""
    import numpy as np

    out = {}
    for name, m in m1.items():
        a, b = np.linalg.norm(m), np.linalg.norm(ref["m1:" + name])
        out[name] = float(a / b) if b > 0 else (
            1.0 if a == 0 else float("inf"))
    return out


def mp_rank_main(spec_path: str, rank: int) -> int:
    """One rank process of phases 29 and 30 (``python chip_smoke.py
    --mp-rank SPEC RANK``): joins the group, takes 29's runs, then 30's,
    writes ``<out>/rank<rank>.json``."""
    sys.path.insert(0, REPO)
    with open(spec_path) as f:
        spec = json.load(f)
    globals().update(spec["consts"])
    import torch

    from cxxnet_tpu_torch.parallel import distributed as pdist

    torch.backends.cuda.matmul.allow_tf32 = False
    world = spec["world"]
    pdist.init_distributed(spec["coord"], world, rank, dev=DP_DEV,
                           timeout_s=spec["timeout_s"])
    t0 = time.perf_counter()
    res = {"k3": _k3_runs(spec, rank, world)}
    res["k3_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["k2a"] = _k2a_runs(spec, rank)
    res["k2a_s"] = time.perf_counter() - t0
    res["backend"] = pdist.backend()
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    pdist.shutdown_distributed()
    return 0


def _sp_reference(cfg, ckpt: str, out: str):
    """The one-rank bf16 LM step from ``ckpt`` on the whole first batch:
    its loss, and per tensor the update and Adam's m1 saved to ``out``
    (f32)."""
    import numpy as np

    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    tr = NetTrainer()
    tr.set_params(cfg)
    tr.load_model(ckpt)
    w0 = {f"{k}/{t}": w.detach().float().cpu().numpy().copy()
          for k, tags in tr.params.items() for t, w in tags.items()}
    loss = _mp_step(tr, 0, slice(None))
    arrays = {}
    for name, w in w0.items():
        k, t = name.rsplit("/", 1)
        w1 = tr.params[k][t].detach().float().cpu().numpy()
        arrays["d:" + name] = w1 - w
        arrays["m1:" + name] = tr.ustates[k][t]["m1"].detach().float().cpu(
        ).numpy()
    np.savez(out, **arrays)
    del tr
    return loss


def _mp_check_launches(tag, launches, want):
    """Every step's launches equal ``want`` (a kernel absent: 0)."""
    from cxxnet_tpu_torch.ops import KERNELS

    full = {k.name: 0 for k in KERNELS}
    full.update(want)
    bad = [(i, d) for i, d in enumerate(launches) if d != full]
    if bad:
        raise SmokeError(f"{tag}: step launches {bad[:2]}, expected {full}")


def async_seq_parallel_phase(card: str):
    """Phases 29 (k3) and 30 (k2a) in one job of two rank processes on
    the card (gloo), the LM at LM_* width (``attn_impl = pallas``, bf16).

    29: from one checkpoint (SGD), ``det_reduce = 1`` and ``async_overlap
    = 1, staleness = 0`` ``MP_STEPS`` steps each: the weights' CRCs
    equal, on each rank and across the ranks; each async step launches
    K8 once per group and K9/K10 once per block; then ``staleness = 1,
    async_resync_period = 1`` over two rounds: finite weights, the ranks
    bit-equal after the round's drain, nothing pending.  The step ms of
    ``det_reduce`` and of the async step (``MP_TIMED`` steps, one fence)
    and ``async_overlap_fraction`` are logged.

    30: ``model_parallel = 2`` with ``seq_parallel = ring`` and
    ``alltoall`` against this process's one-rank step from one
    checkpoint (Adam) on the whole batch: the loss within
    ``SP_LOSS_REL``, per tensor the cosines at ``LM_UPDATE_COS``
    (median ``LM_UPDATE_COS_MEDIAN``) and m1's norm within
    ``SP_M1_NORM_REL`` of the one rank's, the two model ranks' weights
    bit-equal; a ring step launches K9 and K10 twice per block (a hop
    each), the all-to-all step once.  K9 and K10 at the ring's hop
    shapes and offsets and at the all-to-all's local shape against their
    plain versions, timed beside ``scaled_dot_product_attention``
    (``ring_hop_cases``)."""
    import statistics as stats

    import torch

    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.serve.fleet import free_port

    t_phase = time.perf_counter()
    out = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as tmp:
        cfgs = {"k3": _mp_conf(adam=False), "k2a": _mp_conf(adam=True)}
        ckpts = {}
        for name, cfg in cfgs.items():
            tr = NetTrainer()
            tr.set_params(cfg)
            tr.init_model()
            ckpts[name] = os.path.join(tmp, f"{name}.model")
            tr.save_model(ckpts[name])
            del tr
        ref_path = os.path.join(tmp, "k2a_ref.npz")
        t0 = time.perf_counter()
        for kern in KERNELS:
            kern.reset_counts()
        ref_loss = _sp_reference(cfgs["k2a"], ckpts["k2a"], ref_path)
        ref_launches = {k.name: k.launches for k in KERNELS}
        torch.cuda.empty_cache()
        spec = {"world": DP_RANKS, "coord": f"127.0.0.1:{free_port()}",
                "timeout_s": 120, "out": tmp,
                "k3_cfg": cfgs["k3"], "k3_ckpt": ckpts["k3"],
                "k2a_cfgs": {m: _mp_conf(True, i + 1)
                             for i, m in enumerate(SP_MODES)},
                "k2a_ckpt": ckpts["k2a"],
                "k2a_ref": ref_path,
                # the parent's sizes (one module, one set of constants)
                "consts": {n: globals()[n] for n in (
                    "MP_STEPS", "MP_TIMED", "DP_DEV", "LM_T", "LM_DIM",
                    "LM_HEADS", "LM_LAYERS", "LM_BATCH")}}
        spec_path = os.path.join(tmp, "mp_spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        t1 = time.perf_counter()
        codes, outs = _dp_spawn(
            [[sys.executable, os.path.join(REPO, "chip_smoke.py"),
              "--mp-rank", spec_path, str(r)] for r in range(DP_RANKS)],
            tmp, "mp")
        out["ranks_s"] = time.perf_counter() - t1
        if any(c != 0 for c in codes):
            raise SmokeError(f"29/30: rank exits {codes}: "
                             + " | ".join(o[-3000:] for o in outs))
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    # 29
    k3 = [r["k3"] for r in ranks]
    groups = k3[0]["s0"]["async"]["groups"]
    for r, runs in enumerate(k3):
        _mp_check_launches(f"29 det rank {r}", runs["det"]["launches"],
                           {"flash_fwd": LM_LAYERS, "flash_bwd": LM_LAYERS,
                            "sgd_update": 1})
        # staleness 1's first step applies nothing: its second applies
        # the first's aggregate
        for name, step in (("s0", 0), ("s1", 1)):
            _mp_check_launches(f"29 {name} rank {r}",
                               runs[name]["launches"][step:step + 1],
                               {"flash_fwd": LM_LAYERS,
                                "flash_bwd": LM_LAYERS, "sgd_update": groups})
    crcs = {name: [runs[name]["crc"] for runs in k3]
            for name in ("det", "s0", "s1")}
    s1 = [runs["s1"] for runs in k3]
    log(f"29 k3 ({card}): LM at T {LM_T}, d {LM_DIM}, {LM_HEADS} heads, "
        f"{LM_LAYERS} blocks, {LM_BATCH // DP_RANKS} rows a rank; weight "
        f"CRCs det_reduce {crcs['det']}, staleness 0 {crcs['s0']}, "
        f"staleness 1 after 2 drained rounds {crcs['s1']}; {groups} groups "
        f"(snapshot {k3[0]['s0']['async']}); step launches "
        f"{k3[0]['s0']['launches'][0]}; step ms det_reduce "
        f"{[runs['det']['step_ms'] for runs in k3]} async "
        f"{[runs['s0']['step_ms'] for runs in k3]} (host clock, "
        f"{MP_TIMED} steps, one fence); async_overlap_fraction "
        f"{[runs['s0']['overlap_fraction'] for runs in k3]}; staleness 1 "
        f"async block {s1[0]['async']}")
    if not (crcs["det"] == crcs["s0"] and len(set(crcs["s0"])) == 1):
        raise SmokeError(f"29: staleness 0 is not det_reduce's bits: {crcs}")
    if not (len(set(crcs["s1"])) == 1 and all(x["finite"] for x in s1)
            and all(x["async"]["pending"] == [0] * groups for x in s1)):
        raise SmokeError(f"29: staleness 1: CRCs {crcs['s1']}, "
                         f"{[x['async'] for x in s1]}")
    out["k3"] = {"crcs": crcs, "groups": groups,
                 "step_ms": {n: [runs[n]["step_ms"] for runs in k3]
                             for n in ("det", "s0")},
                 "overlap_fraction": [runs["s0"]["overlap_fraction"]
                                      for runs in k3],
                 "s1_async": s1[0]["async"], "k3_s": ranks[0]["k3_s"],
                 "launches": {n: k3[0][n]["launches"][0]
                              for n in ("det", "s0")}}
    # 30
    out["k2a"] = {"reference_loss": ref_loss,
                  "reference_launches": ref_launches,
                  "k2a_s": ranks[0]["k2a_s"]}
    for mode in SP_MODES:
        runs = [r["k2a"][mode] for r in ranks]
        per_block = 2 if mode == "ring" else 1
        for r, run in enumerate(runs):
            _mp_check_launches(f"30 {mode} rank {r}", [run["launches"]],
                               {"flash_fwd": per_block * LM_LAYERS,
                                "flash_bwd": per_block * LM_LAYERS})
        cos = runs[0]["cos"]
        worst = sorted(cos.items(), key=lambda kv: kv[1])[:5]
        med = stats.median(cos.values())
        rel = [abs(run["loss"] - ref_loss) / abs(ref_loss) for run in runs]
        norm_dev = {n: abs(v - 1.0) for n, v in runs[0]["m1_norm"].items()}
        norm_worst = sorted(norm_dev.items(), key=lambda kv: -kv[1])[:3]
        log(f"30 k2a {mode} ({card}): mesh {[r['mesh'] for r in runs]}; "
            f"loss {[run['loss'] for run in runs]} against one rank "
            f"{ref_loss} (rel {max(rel):.3g}, limit {SP_LOSS_REL:g}); "
            f"cosines median {med:.5f} (limit {LM_UPDATE_COS_MEDIAN:g}), "
            f"worst 5 {[(n, round(v, 5)) for n, v in worst]} (limit "
            f"{LM_UPDATE_COS:g}); |m1| / |m1 one rank| - 1, worst 3 "
            f"{[(n, float(f'{v:.3g}')) for n, v in norm_worst]} (limit "
            f"{SP_M1_NORM_REL:g}); weight CRCs {[r['crc'] for r in runs]}; "
            f"step launches {runs[0]['launches']}")
        bad = [n for n, v in cos.items() if not v >= LM_UPDATE_COS]
        bad_norm = [n for n, v in norm_dev.items() if not v <= SP_M1_NORM_REL]
        if (bad or bad_norm or not med >= LM_UPDATE_COS_MEDIAN
                or not max(rel) <= SP_LOSS_REL
                or len({r["crc"] for r in runs}) != 1):
            raise SmokeError(f"30 {mode}: loss rel {rel}, cosines below "
                             f"{LM_UPDATE_COS}: {bad[:6]}, median {med}, "
                             f"m1 norms off by more than {SP_M1_NORM_REL}: "
                             f"{bad_norm[:6]}, "
                             f"CRCs {[r['crc'] for r in runs]}")
        out["k2a"][mode] = {"loss": [run["loss"] for run in runs],
                            "loss_rel": max(rel), "cos_worst": worst[0][1],
                            "cos_median": med,
                            "m1_norm_dev_worst": norm_worst[0][1],
                            "launches": runs[0]["launches"]}
    out["backend"] = ranks[0]["backend"]
    out["hops"] = check_flash(torch.device("cuda:0"), ring_hop_cases(),
                              timed=True)
    out["launches"] = {
        "async": {n: sum(r["k3"]["s0"]["launches"][0].get(n, 0)
                         for r in ranks) for n in ref_launches},
        "seq_parallel": {n: sum(r["k2a"][m]["launches"].get(n, 0)
                                for r in ranks for m in SP_MODES)
                         for n in ref_launches}}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------------
# phase 31: the rest of the model axis (k2b, k2c) at model_parallel = 2,
# over two rank processes sharing the card (gloo), as phase 30's ranks
# do: 31a GoogLeNet with every tensor cut over the two ranks (K6 on each
# rank's slices of the sibling groups, K8 over its slices), 31b the pipe
# stack as two GPipe stages, 31c the MoE LM with four experts a rank;
# each run from one seeded checkpoint against the one-rank run on the
# whole batch
MA_STEPS = 1  # each run's compared steps, every rank on the whole batch
MA_TIMED = 1  # 31b: steps timed after them, each way (31a: its second)
MA_MICROBATCH = 4  # 31b: T + S - 1 = 5 ticks over 2 stages, bubble 0.2
# 31a: a rank's params + updater state over one whole replica: JAX's
# rule cuts every GoogLeNet tensor in two (0.5)
MA_SHARD_LIMIT = 0.55
MA_RUNS = ("gn", "pipe", "moe0", "moe32")
# 31c runs the LM with its gates unmasked (topk = 0, "moe0") in bf16, as
# 27b holds bf16 against f32, and top-2 in float32 ("moe32"), as 27b
# holds top-2 card against CPU: from the random init the gates are near
# uniform, so the second and third largest of a token's gates nearly
# tie and a bf16 rounding apart (the ranks' partial outputs summed in
# f32, then rounded) sends tokens of a later block to other experts.
# bf16 top-2 read cosines 0.866-0.894 worst, 0.970-0.974 median on an
# H100 80GB HBM3 at 700 W, f32 top-2 0.99999 worst (PERF.md)
# the update cosines' limits (worst, median) by run; the LM rule
# (LM_UPDATE_COS) where none is named
MA_COS = {"gn": (UPDATE_COS, UPDATE_COS_MEDIAN), "moe32": (0.9999, 0.99999)}
# held beside the cosines, which a gradient the model axis scaled would
# leave as they are: every compared step's loss against the one-rank
# run's, relative (MA_LOSS_REL), and per tensor the norm of the update
# over the one-rank update's, and with Adam also m1's (phase 30's rule),
# within MA_NORM_REL of 1; a zero update against a nonzero one scores
# cosine 0.  Set from the readings on an H100 80GB HBM3 at 700 W
# (PERF.md): second-step losses 31a 125.0695 vs 126.1741 (8.8e-3),
# 31b 1.9e-5, 31c topk = 0 2.8e-6, f32 top-2 0; norms 31a 1.5e-2 (a
# bias), 31b 3.3e-4, 31c topk = 0 1.1e-2 (a gate's m1: the ranks'
# partial bf16 gate gradients summed), f32 top-2 2.6e-6; f32 top-2
# cosines worst 0.99999.  A gradient scaled by the axis's 2 moves a
# norm ratio by 1
MA_LOSS_REL = {"gn": 3e-2, "pipe": 2e-4, "moe0": 1e-4, "moe32": 1e-5}
MA_NORM_REL = {"gn": 5e-2, "pipe": 1e-2, "moe0": 5e-2, "moe32": 1e-4}


def _ma_confs(tmp: str):
    """Phase 31's runs: ``{name: (one-rank conf pairs, two-rank conf
    pairs, input side or None)}``."""
    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.models import transformer_conf

    common = [("print_step", "0"), ("eval_train", "0"), ("seed", str(SEED))]
    gn = cfgmod.parse_file(_train_conf(tmp)) + [
        ("dev", DP_DEV), ("compute_dtype", "bfloat16")] + common
    kw = dict(batch_size=LM_BATCH, seq_len=LM_T, dim=LM_DIM, nhead=LM_HEADS,
              nlayer=LM_LAYERS, num_class=PIPE_CLASSES, causal=1, dev=DP_DEV,
              compute_dtype="bfloat16", n_microbatch=MA_MICROBATCH)
    pipe1 = cfgmod.parse_pairs(transformer_conf(pipeline_parallel=1, **kw))
    pipe2 = cfgmod.parse_pairs(transformer_conf(pipeline_parallel=2, **kw))
    corpus = _text_file(tmp, "moe31.txt", P27_WINDOWS, SEED + 31)
    moe = cfgmod.parse_pairs(_lm_text(corpus, 0, 1, moe=True)) + [
        ("dev", DP_DEV)] + common
    moe0 = [(n, "0" if n == "topk" else v) for n, v in moe]
    moe32 = [(n, "float32" if n == "compute_dtype" else v) for n, v in moe]
    side = int(dict(gn)["input_shape"].split(",")[1])
    mp = [("model_parallel", "2")]
    return {"gn": (gn, gn + mp, side),
            "pipe": (pipe1 + common, pipe2 + common, None),
            "moe0": (moe0, moe0 + mp, None),
            "moe32": (moe32, moe32 + mp, None)}


def _ma_batch(name: str, k: int, side):
    """Run ``name``'s k-th global batch: 28's images, 30's byte windows,
    or seeded ``(LM_BATCH, LM_T, LM_DIM)`` rows for the pipe stack."""
    import numpy as np

    if name == "gn":
        return _dp_batch(k, BATCH, side)
    if name in ("moe0", "moe32"):
        return _mp_batch(k)
    rng = np.random.RandomState(SEED + 31 + k)
    return (rng.randn(LM_BATCH, LM_T, LM_DIM).astype(np.float32),
            rng.randint(0, PIPE_CLASSES, (LM_BATCH, 1)).astype(np.float32))


def _ma_run(name: str, cfg, ckpt: str, side, timed: bool):
    """One run of phase 31 in this process: ``MA_STEPS`` steps on the
    whole batches from ``ckpt``, each step's launches (counts at 0 just
    before, read just after) and K6's by C entry, and its loss; then
    the train state's bytes, the whole weights (and Adam's m1) gathered
    over the model axis, and with ``timed`` the median ms of
    ``MA_TIMED`` steps (host clock, synchronized, the compared steps
    their warm-up; each compared step's ms is kept too).  Returns
    ``(readings, whole, m1)``."""
    import torch

    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.parallel import distributed as pdist

    tr = NetTrainer()
    tr.set_params([tuple(p) for p in cfg])
    tr.load_model(ckpt)
    out = {"launches": [], "paths": [], "losses": [], "collective_ms": [],
           "steps_ms": []}
    for k in range(MA_STEPS):
        x, y = _ma_batch(name, k, side)
        for kern in KERNELS:
            kern.reset_counts()
        paths = _by_symbol()
        c0, t0 = pdist.STATS["seconds"], time.perf_counter()
        tr.update_all(x, y)
        tr.sync()
        out["steps_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append({kern.name: kern.launches for kern in KERNELS})
        out["paths"].append(_paths_since(paths))
        out["collective_ms"].append((pdist.STATS["seconds"] - c0) * 1e3)
        out["losses"].append(float(tr.last_loss))
    per, total = tr.state_shard_bytes()
    out.update(shard_bytes=sum(per.values()), total_bytes=total)
    whole = _mp_whole(tr)
    adam = any("m1" in slots for tags in tr.ustates.values()
               for slots in tags.values())
    m1 = _mp_whole(tr, "m1") if adam else {}
    if timed:
        x, y = _ma_batch(name, 0, side)
        batch = DataBatch(data=torch.as_tensor(x, device=tr.device),
                          label=torch.as_tensor(y, device=tr.device))
        times = []
        for _ in range(MA_TIMED):
            t0 = time.perf_counter()
            tr.update(batch)
            tr.sync()
            times.append((time.perf_counter() - t0) * 1e3)
        out["step_ms"] = statistics.median(times)
    del tr
    torch.cuda.empty_cache()
    return out, whole, m1


def ma_rank_main(spec_path: str, rank: int) -> int:
    """One rank process of phase 31 (``python chip_smoke.py --ma-rank
    SPEC RANK``): joins the group, takes 31a, 31b and 31c, writes
    ``<out>/rank<rank>.json`` and, on rank 0, each run's whole weights
    (and m1) to ``<out>/<run>.npz``."""
    sys.path.insert(0, REPO)
    with open(spec_path) as f:
        spec = json.load(f)
    globals().update(spec["consts"])
    import zlib

    import numpy as np
    import torch

    from cxxnet_tpu_torch.parallel import distributed as pdist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pdist.init_distributed(spec["coord"], spec["world"], rank, dev=DP_DEV,
                           timeout_s=spec["timeout_s"])
    res = {"backend": pdist.backend()}
    for name in MA_RUNS:
        t0 = time.perf_counter()
        run, whole, m1 = _ma_run(name, spec["cfgs"][name],
                                 spec["ckpts"][name], spec["side"],
                                 name == "pipe")
        run["crc"] = zlib.crc32(b"".join(whole[n].tobytes()
                                         for n in sorted(whole)))
        run["run_s"] = time.perf_counter() - t0
        if rank == 0:
            np.savez(os.path.join(spec["out"], f"{name}.npz"),
                     **{"w:" + n: w for n, w in whole.items()},
                     **{"m1:" + n: w for n, w in m1.items()})
        res[name] = run
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    pdist.shutdown_distributed()
    return 0


def _ma_cosines(two, one, w0, m1_two=None, m1_one=None):
    """Per tensor the cosine of the two-rank update against the one-rank
    one; with Adam's m1 the lower of m1's cosine and the update's over
    the elements whose one-rank m1 is at least 1e-3 of its largest
    (``_sp_cosines``)."""
    if m1_one:
        ref = {**{"d:" + n: one[n] - w for n, w in w0.items()},
               **{"m1:" + n: m for n, m in m1_one.items()}}
        return _sp_cosines(two, m1_two, w0, ref)
    return _cos_updates(two, one, w0)


def _ma_norm_devs(two, one, w0, m1_two, m1_one):
    """Per tensor ``|r - 1|`` of the ratio ``r`` of the two-rank update's
    norm to the one-rank one's (``d:``), and of m1's (``m1:``) where
    the runs hold Adam's m1: 0 where both are zero, inf where only the
    one-rank one is."""
    import numpy as np

    def dev(a, b):
        na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
        return abs(na / nb - 1.0) if nb > 0 else (0.0 if na == 0
                                                 else float("inf"))

    out = {"d:" + n: dev(two[n] - w, one[n] - w) for n, w in w0.items()}
    out.update(("m1:" + n, dev(m, m1_one[n])) for n, m in m1_two.items())
    return out


def model_axis_phase(card: str):
    """Phase 31: 31a ``googlenet.conf`` b128 bf16 (rates times
    ``LR_SCALE``) with every tensor cut over ``model_parallel = 2``,
    31b ``transformer_conf(pipeline_parallel = 2, n_microbatch =
    MA_MICROBATCH)`` at the LM's widths (27c's stack as two GPipe
    stages) against the one-rank ``pipeline_parallel = 1`` stack, and
    31c 27b's MoE LM (``remat = 0``) with ``MOE_EXPERTS / 2`` experts a
    rank, in bf16 with its gates unmasked and top-2 in float32:
    ``MA_STEPS`` steps each from one seeded checkpoint in two rank
    processes sharing the card (gloo), against the one-rank run here on
    the same batches.  Held: every step's launches on each rank (31a
    GoogLeNet's step, K6 on its sliced groups and K8 once over the
    slices; 31b K8 once; 31c K9 and K10 once a block), the ranks' whole
    weights equal, each update's cosine (31a at 28's ``UPDATE_COS``,
    31b and 31c by the LM rule, the f32 top-2 run tighter, 31c on Adam's
    m1 too: ``MA_COS``), every step's loss (``MA_LOSS_REL``), each
    update's norm, and 31c's m1 norms (``MA_NORM_REL``), 31a's state
    bytes a rank at most ``MA_SHARD_LIMIT`` of a replica; K6 at the
    sliced group shapes (either C entry) and K8 over the slices against
    their plain versions, timed.  Returns the readings."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.serve.fleet import free_port

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    out = {"card": card}
    gen = torch.Generator().manual_seed(SEED + 31)
    rows = []
    calls = step_calls(BATCH, n_model=2)
    for kernel in ("conv_block_gemm", "sgd_update"):
        dtype = torch.float32 if kernel == "sgd_update" else torch.bfloat16
        for key, count in calls[kernel].items():
            main = kernel == "sgd_update" or key[2] % 8 == 0
            r = check_kernel(kernel, key, dtype, dev, gen,
                             device_times=True, require_main=main)
            r["per_step"] = count
            rows.append(r)
            log(f"31a kernel {r['kernel']:16s} {r['dtype']:8s} "
                f"{r['shape']:34s} x{count} entry {r.get('entry', 'main')} "
                f"abs {r['max_abs_err']:.3g} (rtol {r['rtol']:g} atol "
                f"{r['atol']:g}) {'ok' if r['ok'] else 'MISMATCH'}  ms "
                f"{r['ms']:.4f} plain {r['plain_ms']:.4f} library "
                f"{r['library_ms']:.4f} bound {r['bound_ms']:.4f} "
                f"({r['bound_by']}); {card}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise SmokeError(f"31a: {len(bad)} kernel check(s) at the sliced "
                         "shapes out of tolerance: " + "; ".join(
                             f"{r['kernel']} {r['shape']}" for r in bad))
    out["kernels"] = rows
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ma_") as tmp:
        confs = _ma_confs(tmp)
        side = confs["gn"][2]
        ckpts, ref = {}, {}
        t0 = time.perf_counter()
        for name in MA_RUNS:
            tr = NetTrainer()
            tr.set_params(confs[name][0])
            tr.init_model()
            ckpts[name] = os.path.join(tmp, f"{name}.model")
            tr.save_model(ckpts[name])
            w0 = _mp_whole(tr)
            del tr
            run, whole, m1 = _ma_run(name, confs[name][0], ckpts[name], side,
                                     name == "pipe")
            ref[name] = dict(run, w0=w0, whole=whole, m1=m1)
        out["reference_s"] = time.perf_counter() - t0
        spec = {"world": DP_RANKS, "coord": f"127.0.0.1:{free_port()}",
                "timeout_s": 180, "out": tmp, "side": side, "ckpts": ckpts,
                "cfgs": {n: confs[n][1] for n in MA_RUNS},
                "consts": {n: globals()[n] for n in (
                    "MA_STEPS", "MA_TIMED", "DP_DEV", "LM_T", "LM_DIM",
                    "LM_HEADS", "LM_LAYERS", "LM_BATCH", "SEED", "BATCH",
                    "PIPE_CLASSES", "MA_RUNS")}}
        spec_path = os.path.join(tmp, "ma_spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        codes, outs = _dp_spawn(
            [[sys.executable, os.path.join(REPO, "chip_smoke.py"),
              "--ma-rank", spec_path, str(r)] for r in range(DP_RANKS)],
            tmp, "ma")
        out["ranks_s"] = time.perf_counter() - t1
        if any(c != 0 for c in codes):
            raise SmokeError(f"31: rank exits {codes}: "
                             + " | ".join(o[-3000:] for o in outs))
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        two = {}
        for name in MA_RUNS:
            z = np.load(os.path.join(tmp, f"{name}.npz"))
            two[name] = ({k[2:]: z[k] for k in z.files if k.startswith("w:")},
                         {k[3:]: z[k] for k in z.files if k.startswith("m1:")})
    if ranks[0]["backend"] != "gloo":
        raise SmokeError(f"31: two ranks on one card ran {ranks[0]['backend']}")
    flash = {"flash_fwd": LM_LAYERS, "flash_bwd": LM_LAYERS}
    want = {"gn": IMGBIN_PER_STEP, "pipe": {"sgd_update": 1},
            "moe0": flash, "moe32": flash}
    tags = {"gn": "31a googlenet", "pipe": "31b pipe stages",
            "moe0": "31c moe experts, topk = 0",
            "moe32": "31c moe experts, top-2, float32"}
    out["launches"] = {}
    for name in MA_RUNS:
        runs = [r[name] for r in ranks]
        for r, run in enumerate(runs):
            _mp_check_launches(f"{tags[name]} rank {r}", run["launches"],
                               want[name])
        if len({run["crc"] for run in runs}) != 1:
            raise SmokeError(f"{tags[name]}: the ranks' whole weights differ:"
                             f" {[run['crc'] for run in runs]}")
        one = ref[name]
        _mp_check_launches(f"{tags[name]} one rank", one["launches"],
                           want[name])
        cos = _ma_cosines(two[name][0], one["whole"], one["w0"],
                          two[name][1], one["m1"])
        lim = MA_COS.get(name, (LM_UPDATE_COS, LM_UPDATE_COS_MEDIAN))
        worst = sorted(cos.items(), key=lambda kv: kv[1])[:5]
        med = statistics.median(cos.values())
        rels = [abs(a - b) / abs(b)
                for a, b in zip(runs[0]["losses"], one["losses"])]
        norm = _ma_norm_devs(two[name][0], one["whole"], one["w0"],
                             two[name][1], one["m1"])
        norm_worst = sorted(norm.items(), key=lambda kv: -kv[1])[:3]
        frac = [run["shard_bytes"] / run["total_bytes"] for run in runs]
        line = (f"{tags[name]} ({card}): update cosines 2 ranks vs 1 after "
                f"{MA_STEPS} steps: "
                f"median {med:.5f} (limit {lim[1]:g}), "
                f"worst 5 {[(n, round(v, 5)) for n, v in worst]} (limit "
                f"{lim[0]:g}); losses 2 ranks {runs[0]['losses']} 1 rank "
                f"{one['losses']} (rel {[float(f'{v:.3g}') for v in rels]}, "
                f"limit {MA_LOSS_REL[name]:g}); update (and m1) "
                f"norm / one rank's - 1, worst 3 "
                f"{[(n, float(f'{v:.3g}')) for n, v in norm_worst]} (limit "
                f"{MA_NORM_REL[name]:g}); params+state bytes "
                f"a rank {[run['shard_bytes'] for run in runs]} of "
                f"{runs[0]['total_bytes']} ({[round(f, 4) for f in frac]}); "
                f"step launches {runs[0]['launches'][0]}; collectives host "
                f"ms a step {[[round(v, 1) for v in run['collective_ms']] for run in runs]}")
        if "step_ms" in one:
            line += (f"; step ms 2 ranks {[round(run['step_ms'], 1) for run in runs]}"
                     f" vs one rank {one['step_ms']:.1f}")
        else:
            line += (f"; compared steps' ms 2 ranks {[[round(v, 1) for v in run['steps_ms']] for run in runs]}"
                     f" vs one rank {[round(v, 1) for v in one['steps_ms']]}")
        if name == "gn":
            line += f"; K6 by C entry a step {runs[0]['paths'][0]}"
        if name == "pipe":
            ticks = MA_MICROBATCH + DP_RANKS - 1
            line += (f"; {MA_MICROBATCH} microbatches over {DP_RANKS} stages:"
                     f" {ticks} ticks, bubble {(DP_RANKS - 1) / ticks:.2f}")
        log(line)
        bad = [n for n, v in cos.items() if not v >= lim[0]]
        if bad or not med >= lim[1]:
            raise SmokeError(f"{tags[name]}: update cosines below {lim[0]:g}:"
                             f" {bad[:6]}, median {med:.5f}")
        bad_norm = [n for n, v in norm.items() if not v <= MA_NORM_REL[name]]
        if bad_norm or not max(rels) <= MA_LOSS_REL[name]:
            raise SmokeError(f"{tags[name]}: loss rel {rels} (limit "
                             f"{MA_LOSS_REL[name]:g}), norms off by more "
                             f"than {MA_NORM_REL[name]:g}: {bad_norm[:6]}")
        if name == "gn" and max(frac) > MA_SHARD_LIMIT:
            raise SmokeError(f"31a: params+state bytes a rank {frac} of a "
                             f"replica, limit {MA_SHARD_LIMIT}")
        out[name] = {"cos_worst": worst[0][1], "cos_median": med,
                     "losses_2": runs[0]["losses"],
                     "losses_1": one["losses"], "loss_rel": rels,
                     "norm_dev_worst": norm_worst[0][1],
                     "shard_fraction": frac,
                     "shard_bytes": [run["shard_bytes"] for run in runs],
                     "total_bytes": runs[0]["total_bytes"],
                     "launches": runs[0]["launches"][0],
                     "collective_ms": [run["collective_ms"] for run in runs],
                     "steps_ms_2": [run["steps_ms"] for run in runs],
                     "steps_ms_1": one["steps_ms"],
                     "run_s": [run["run_s"] for run in runs]}
        if "step_ms" in one:
            out[name].update(step_ms_2=[run["step_ms"] for run in runs],
                             step_ms_1=one["step_ms"])
        if name == "pipe":
            out[name].update(ticks=MA_MICROBATCH + DP_RANKS - 1,
                             bubble=(DP_RANKS - 1)
                             / (MA_MICROBATCH + DP_RANKS - 1))
        for kern in KERNELS:
            out["launches"][kern.name] = out["launches"].get(
                kern.name, 0) + sum(sum(step.get(kern.name, 0)
                                        for step in run["launches"])
                                    for run in runs)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------------
# phase 32: the elastic pod (k4), GoogLeNet on ranks that come and go
EL_RANKS = 3
EL_BATCH = 96  # global: 32 rows a rank on 3 ranks, 48 on 2
EL_ROWS = 192  # each rank's synthetic rows: 6 steps a round on 3, 4 on 2
EL_ROUNDS = 5
EL_KILL_AFTER = 2  # run A: rank 2 SIGKILLed once 0002.model is durable
EL_JOIN_AT = 4  # run A's joiner asks for this boundary
# run B plans what the coordinator gives run A: the shrink at the round
# the survivors resume (the kill's round), the grow at max(join_at, the
# newest reported round + 2) once a loss moved it (JAX's rule)
EL_DROP_AT = EL_KILL_AFTER + 1
EL_GROW_AT = max(EL_JOIN_AT, EL_DROP_AT + 2)
EL_KEYS = ("elastic=1", "elastic_min_replicas=2", "elastic_heartbeat_s=0.25",
           "elastic_timeout_s=3", "collective_timeout_s=30",
           "dist_timeout_s=120", "det_reduce=1", "save_ustate=1",
           "dist_shard=block", f"num_round={EL_ROUNDS}", "print_step=0",
           f"seed={SEED}", "telemetry=1", "event_log=events.jsonl")
EL_DEADLINE_S = 300
# 32b: the phase-28 digits job on 3 ranks with the flip on rank 1; a
# global batch that divides over 3 ranks and then over 2
EL_Q_ROUNDS = 3
EL_Q_BATCH = 96


def el_rank_main(spec_path: str, tag: str) -> int:
    """One process of phase 32a: the port's CLI (``LearnTask``) on the
    spec's argv, each step's launches (by kernel and by C entry), its
    rank, world and round appended to the spec's ``out`` file.  cuDNN
    deterministic, as phase 28's compared runs."""
    sys.path.insert(0, REPO)
    with open(spec_path) as f:
        spec = json.load(f)
    import torch

    from cxxnet_tpu_torch import cli
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.parallel.distributed import process_info

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = open(spec["out"], "a")

    class RecordingTrainer(NetTrainer):
        def update(self, batch):
            before = {k.name: k.launches for k in KERNELS}
            paths_before = _by_symbol()
            super().update(batch)
            rank, world = process_info()
            out.write(json.dumps({
                "tag": tag, "round": self.round, "rank": rank,
                "world": world, "device": str(self.device),
                "launches": {k.name: k.launches - before[k.name]
                             for k in KERNELS},
                "paths": _paths_since(paths_before),
                "loss": float(self.last_loss)}) + "\n")
            out.flush()

    class Task(cli.LearnTask):
        def _create_trainer(self):
            tr = RecordingTrainer()
            tr.set_params(self.cfg)
            return tr

    try:
        code = Task().run(spec["argv"])
    except BaseException:  # noqa: BLE001 - the parent reads the log
        traceback.print_exc()
        code = 1
    out.close()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # an elastic process ends without interpreter teardown


def _el_conf(tmp: str) -> str:
    """googlenet.conf's net at full width less its one dropout layer
    (``det_reduce = 1`` refuses a stochastic layer), bf16, on the
    phase-28 synthetic source, ``EL_ROWS`` rows a rank, global batch
    ``EL_BATCH``, rates times ``LR_SCALE``."""
    path = _synthetic_conf(tmp, "elastic.conf",
                           (("data", "train", EL_ROWS, False),), LR_SCALE)
    with open(path) as f:
        lines = f.read().splitlines()
    out, skip = [], False
    for line in lines:
        if line.replace(" ", "").endswith("=dropout"):
            skip = True  # the layer and its threshold
            continue
        if skip and line.strip().startswith("threshold"):
            continue
        skip = False
        out.append(line)
    if len(out) != len(lines) - 2:
        raise SmokeError("32: googlenet.conf's dropout layer not found")
    out.append(f"batch_size = {EL_BATCH}")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path


def _el_start(tmp, run, conf, model_dir, ranks, dist_port, el_port, extra,
              joiner_extra, started):
    """``ranks`` rank processes and one ``elastic_join = 1`` process of
    run ``run`` (``python chip_smoke.py --el-rank SPEC TAG``), each in
    ``<tmp>/<run>/<tag>`` and each appended to ``started``; returns
    ``(procs, dirs)``."""
    procs, dirs = [], []
    for i, tag in enumerate([f"r{r}" for r in range(ranks)] + ["j"]):
        d = os.path.join(tmp, run, tag)
        os.makedirs(d)
        argv = [conf, f"dev={DP_DEV}", f"model_dir={model_dir}", *EL_KEYS,
                f"elastic_coordinator=127.0.0.1:{el_port}"]
        if tag == "j":
            argv += ["elastic_join=1", "elastic_rejoin_s=240", *joiner_extra]
        else:
            argv += [f"dist_num_proc={ranks}", f"dist_proc_id={i}",
                     f"dist_coordinator=127.0.0.1:{dist_port}", *extra]
        spec = os.path.join(d, "spec.json")
        with open(spec, "w") as f:
            json.dump({"argv": argv, "out": os.path.join(d, "steps.jsonl")},
                      f)
        with open(os.path.join(d, "out.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, "chip_smoke.py"),
                 "--el-rank", spec, tag], cwd=d,
                env=dict(os.environ, PYTHONPATH=REPO), stdout=log,
                stderr=subprocess.STDOUT))
        started.append(procs[-1])
        dirs.append(d)
    return procs, dirs


def _el_ports(n: int) -> list:
    """``n`` distinct free ports, bound together and then released (a
    port drawn and closed one at a time may come back)."""
    import socket

    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _el_read(d: str, name: str) -> list:
    """A process's JSON lines (``steps.jsonl``, ``events.jsonl``,
    ``telemetry.jsonl``)."""
    try:
        with open(os.path.join(d, name)) as f:
            return [json.loads(line) for line in f if line.strip()]
    except (OSError, ValueError):
        return []


def _el_log(d: str) -> str:
    with open(os.path.join(d, "out.log"), errors="replace") as f:
        return f.read()


def _el_wait(procs, t0, kill=()):
    """Wait for ``procs`` until ``EL_DEADLINE_S`` after ``t0``; every
    process still running then is killed.  Returns the exit codes."""
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t0 + EL_DEADLINE_S - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs]


def _el_crcs(model_dir: str) -> dict:
    from cxxnet_tpu_torch.utils import checkpoint as ckpt

    return {r: ckpt.read_manifest(p)["crc32"]
            for r, p in ckpt.list_checkpoints(model_dir)}


def _el_generations(steps):
    """A process's steps cut where its (rank, world) changes: ``[(rank,
    world, first round, last round, steps)]``."""
    out = []
    for s in steps:
        key = (s["rank"], s["world"])
        if not out or tuple(out[-1][:2]) != key:
            out.append([*key, s["round"], s["round"], 0])
        out[-1][3] = s["round"]
        out[-1][4] += 1
    return [tuple(g) for g in out]


def elastic_googlenet_start(tmp: str, card: str, ports, started: list):
    """32a: run A (churn) and run B (planned) started together, 4
    processes each, all on the card (gloo), on ``ports`` (four), and a
    thread that SIGKILLs run A's rank 2 once ``0002.model`` is durable;
    the processes go to ``started``; returns a function that waits for
    them and checks."""
    from cxxnet_tpu_torch.utils import checkpoint as ckpt

    conf = _el_conf(tmp)
    models = {run: os.path.join(tmp, run, "models") for run in ("a", "b")}
    t0 = time.perf_counter()
    a, a_dirs = _el_start(tmp, "a", conf, models["a"], EL_RANKS, ports[0],
                          ports[1], (), [f"elastic_join_at={EL_JOIN_AT}"],
                          started)
    b, b_dirs = _el_start(tmp, "b", conf, models["b"], EL_RANKS, ports[2],
                          ports[3], [f"elastic_drop_at={EL_DROP_AT}"],
                          [f"elastic_join_at={EL_GROW_AT}"], started)
    want = ckpt.manifest_path(os.path.join(models["a"],
                                           f"{EL_KILL_AFTER:04d}.model"))
    kill = {}

    def watch():
        while time.perf_counter() - t0 < EL_DEADLINE_S:
            if os.path.exists(want):
                time.sleep(0.3)  # round 3 under way
                a[EL_RANKS - 1].send_signal(signal.SIGKILL)
                kill["ts"] = time.time()
                return
            if all(p.poll() is not None for p in a):
                return
            time.sleep(0.02)

    watcher = threading.Thread(target=watch, name="chip-smoke-el-kill",
                               daemon=True)
    watcher.start()
    return lambda: _el_googlenet_finish(card, t0, models, a, a_dirs, b,
                                        b_dirs, watcher, kill)


def _el_googlenet_finish(card, t0, models, a, a_dirs, b, b_dirs, watcher,
                         kill):
    """32a's holds and readings, once its processes ended."""
    from cxxnet_tpu_torch.ops import KERNELS

    codes_a = _el_wait(a, t0)
    codes_b = _el_wait(b, t0)
    watcher.join()
    wall = time.perf_counter() - t0
    kill_ts = kill.get("ts")
    logs = {f"a/{os.path.basename(d)}": _el_log(d) for d in a_dirs}
    logs.update({f"b/{os.path.basename(d)}": _el_log(d) for d in b_dirs})
    if kill_ts is None:
        raise SmokeError(f"32a: {EL_KILL_AFTER:04d}.model never appeared: "
                         + logs["a/r0"][-3000:])
    expect_a = [0] * (EL_RANKS - 1) + [-signal.SIGKILL, 0]
    if codes_a != expect_a or codes_b != [0] * (EL_RANKS + 1):
        raise SmokeError(f"32a: exits run A {codes_a} (want {expect_a}), run "
                         f"B {codes_b}: " + " | ".join(
                             f"{k}: {v[-1500:]}" for k, v in logs.items()))

    def resumed(log, reason):
        return [int(m) for m in re.findall(
            reason + r" -> rebuilding.*?\n.*?resuming at round (\d+)", log,
            re.S)]

    resume, grow = resumed(logs["a/r0"], "replica_lost"), resumed(
        logs["a/r0"], "grow")
    if (resume, grow) != ([EL_DROP_AT], [EL_GROW_AT]):
        raise SmokeError(f"32a: run A resumed at {resume} and grew at {grow};"
                         f" run B planned {EL_DROP_AT} and {EL_GROW_AT}")
    if (f"elastic: this rank left the mesh at round {EL_DROP_AT} (planned "
            "shrink); exiting clean") not in logs[f"b/r{EL_RANKS - 1}"]:
        raise SmokeError("32a: run B's dropped rank: "
                         + logs[f"b/r{EL_RANKS - 1}"][-2000:])
    crcs = {run: _el_crcs(m) for run, m in models.items()}
    if sorted(crcs["a"]) != list(range(EL_ROUNDS + 1)) or crcs["a"] != crcs[
            "b"]:
        raise SmokeError(f"32a: checkpoint CRCs run A {crcs['a']} != run B "
                         f"{crcs['b']}")
    # every step of every process: K1-K6 and K8 on their main entries, in
    # each generation it lived through
    want_paths = _main_paths(IMGBIN_PER_STEP)
    full = {k.name: IMGBIN_PER_STEP.get(k.name, 0) for k in KERNELS}
    want_dev = "cpu" if DP_DEV.startswith("cpu") else "cuda"
    launches = {k.name: 0 for k in KERNELS}
    gens = {}
    for run, dirs in (("a", a_dirs), ("b", b_dirs)):
        for d in dirs:
            name = f"{run}/{os.path.basename(d)}"
            steps = _el_read(d, "steps.jsonl")
            for i, s in enumerate(steps):
                if (s["launches"] != full or s["paths"] != want_paths
                        or not s["device"].startswith(want_dev)):
                    raise SmokeError(f"32a {name}: step {i} (round "
                                     f"{s['round']}, world {s['world']}) "
                                     f"launches {s['launches']}, paths "
                                     f"{s['paths']} on {s['device']}")
                for k, n in s["launches"].items():
                    launches[k] += n
            gens[name] = _el_generations(steps)
    want_gens = {"a/r0": [3, 2, 3], "a/r1": [3, 2, 3], "a/r2": [3],
                 "a/j": [3], "b/r0": [3, 2, 3], "b/r1": [3, 2, 3],
                 "b/r2": [3], "b/j": [3]}
    got_gens = {k: [g[1] for g in v] for k, v in gens.items()}
    if got_gens != want_gens:
        raise SmokeError(f"32a: generations by process {gens}")
    # the readings: the kill to the survivors' rebuild_start, each
    # rebuild's wall time, rank 0's img/s by round and world
    ev = {k: _el_read(d, "events.jsonl") for k, d in
          [(f"a/{os.path.basename(d)}", d) for d in a_dirs]
          + [(f"b/{os.path.basename(d)}", d) for d in b_dirs]}
    detect = {k: round(e["ts"] - kill_ts, 3) for k in ("a/r0", "a/r1")
              for e in ev[k] if e["kind"] == "mesh.rebuild_start"
              and e["reason"] == "replica_lost"}
    rebuilds = {k: [(e["reason"], e["num"], e["wall_s"]) for e in v
                    if e["kind"] == "mesh.rebuild_done"]
                for k, v in ev.items() if any(
                    e["kind"] == "mesh.rebuild_done" for e in v)}
    rates = {run: [(t["round"], t["elastic"]["processes"],
                    round(t["step"].get("samples_per_sec", 0.0), 1))
                   for t in _el_read(dirs[0], "telemetry.jsonl")]
             for run, dirs in (("a", a_dirs), ("b", b_dirs))}
    log(f"32a elastic GoogLeNet (det_reduce, bf16, batch {EL_BATCH}): run A "
        f"killed rank {EL_RANKS - 1} after {EL_KILL_AFTER:04d}.model, resumed"
        f" at round {resume[0]} on 2, grew back to 3 at {grow[0]} (joiner asked"
        f" for {EL_JOIN_AT}); run B shrank at {EL_DROP_AT}, grew at "
        f"{EL_GROW_AT}; checkpoint CRCs equal over rounds 0-{EL_ROUNDS}: "
        f"{ {r: hex(c) for r, c in crcs['a'].items()} }; generations "
        f"{gens}; both runs {wall:.1f}s ({card})")
    log(f"32a kill -> mesh.rebuild_start (s): {detect}; rebuilds (reason, "
        f"processes, wall s): {rebuilds}; rank 0's img/s by round (round, "
        f"processes, img/s; the card shared with 32b and the phases "
        f"run meanwhile): "
        f"{rates} ({card})")
    return {"crcs": {r: hex(c) for r, c in crcs["a"].items()},
            "resume_round": resume[0], "grow_round": grow[0],
            "kill_to_rebuild_start_s": detect, "rebuilds": rebuilds,
            "rates": rates, "generations": gens, "launches": launches,
            "wall_s": wall}


def elastic_quarantine_start(tmp: str, card: str, ports, started: list):
    """32b: the phase-28 digits job (``dist.conf`` on the UCI digits) on 3
    ranks with ``elastic = 1``, ``integrity_every = 1`` and ``DP_FLIP``
    on rank 1, on ``ports`` (two), the processes appended to ``started``;
    returns a function that waits and checks: exits ``[0, 41,
    0]``, the survivors rebuilt onto ``last_clean_round + 1`` and
    finished ``EL_Q_ROUNDS``, every vote after the rebuild clean (the two
    survivors' state digests equal each round) and each round's
    checkpoint written after the two ranks' CRCs agreed.
    ``test_on_server = 1`` stays off here: it runs inside the round,
    before the vote, so it would stop the flipped round itself."""
    from cxxnet_tpu_torch.tools.make_digits_idx import write_digits_idx

    d = os.path.join(tmp, "q")
    os.makedirs(d)
    write_digits_idx(os.path.join(d, "data"))
    with open(DIST_CONF) as f:
        text = f.read() + DP_DIGITS_EVAL
    conf = os.path.join(d, "dist_eval.conf")
    with open(conf, "w") as f:
        f.write(text)
    port, el_port = ports
    t0 = time.perf_counter()
    procs = _dp_start(
        [[sys.executable, "-m", "cxxnet_tpu_torch", conf, *DP_DIGITS_KEYS,
          f"num_round={EL_Q_ROUNDS}", f"batch_size={EL_Q_BATCH}",
          "integrity_every=1", "update_on_server=0", "dist_num_proc=3",
          f"dist_proc_id={r}", f"dist_coordinator=127.0.0.1:{port}",
          "dist_timeout_s=120", "model_dir=mq", "elastic=1",
          "elastic_min_replicas=2", "elastic_heartbeat_s=0.25",
          "elastic_timeout_s=3", f"elastic_coordinator=127.0.0.1:{el_port}",
          f"event_log=events.r{r}.jsonl",
          *(DP_FLIP if r == 1 else ())]
         for r in range(3)], d, "q")
    started.extend(procs[0])

    def finish():
        codes, outs = _dp_finish(procs, t0)
        wall = time.perf_counter() - t0
        if codes != [0, 41, 0]:
            raise SmokeError(f"32b: exits {codes}: "
                             + " | ".join(o[-2000:] for o in outs))
        out = {"codes": codes, "wall_s": wall}
        for r in (0, 2):
            ev = _el_read(d, f"events.r{r}.jsonl")
            (quar,) = [e for e in ev if e["kind"] == "integrity.quarantine"]
            (done,) = [e for e in ev if e["kind"] == "mesh.rebuild_done"]
            clean = [e["round"] for e in ev if e["kind"] == "integrity.clean"]
            if (quar["rank"] != 1 or done["num"] != 2
                    or done["resume_round"] != quar["last_clean_round"] + 1
                    or clean != list(range(EL_Q_ROUNDS))
                    or "updating end" not in outs[r]):
                raise SmokeError(f"32b rank {r}: quarantine {quar}, rebuild "
                                 f"{done}, clean votes {clean}: "
                                 + outs[r][-2000:])
            out[f"r{r}"] = {"last_clean_round": quar["last_clean_round"],
                            "resume_round": done["resume_round"],
                            "rebuild_s": done["wall_s"], "clean": clean}
        saved = sorted(n for n in os.listdir(os.path.join(d, "mq"))
                       if n.endswith(".model"))
        if saved != [f"{r:04d}.model" for r in range(EL_Q_ROUNDS + 1)]:
            raise SmokeError(f"32b: saved {saved}")
        if "self-quarantining (exit 41)" not in outs[1]:
            raise SmokeError("32b rank 1: " + outs[1][-2000:])
        log(f"32b quarantine: exits {codes}; the survivors "
            f"{ {r: out[f'r{r}'] for r in (0, 2)} }; saved {saved}; "
            f"{wall:.1f}s ({card})")
        return out

    return finish


def elastic_phase(card: str):
    """Phase 32: 32a's and 32b's 11 processes started together on the
    card, waited for and checked; returns the ``elastic`` line.  A
    process still running when a check fails is killed."""
    import shutil

    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    t0 = time.perf_counter()
    started = []
    try:
        ports = _el_ports(6)  # 32a's four, then 32b's two
        finish_a = elastic_googlenet_start(tmp, card, ports[:4], started)
        finish_q = elastic_quarantine_start(tmp, card, ports[4:], started)
        try:
            out = finish_a()
        finally:
            q = finish_q()
    finally:
        for p in started:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(quarantine=q, phase_s=time.perf_counter() - t0, card=card)
    return out


# ----------------------------------------------------------------------
# phase 33 (k5): ZeRO-3's gather at use and the reduce-scattered
# gradients on ResNet-50 (33a), lars's state cut under zero = 1 (33b),
# and the predicting and serving tasks over a device range on GoogLeNet
# (33c), each over two rank processes sharing the card (gloo)
Z3_STEPS = 1  # 33a's compared steps, each rank on its 64 of 128 rows
Z3_TIMED = 2  # 33a's steps timed after them, zero = 3 and zero = 0
Z3_PEAK_GROUPS = 2.0  # the gathered peak over the largest group, at most
# 33b: lars under zero = 1 against zero = 0 over the same two ranks, per
# tensor the largest difference of the f32 weights in units of the last
# place of zero = 0's largest (the trust ratio's squared norms are summed over
# the slices, so the momentum differs by rounding, and the weight by at
# most an ulp where w + m rounds the other way: on the CPU at 32x32 a
# 1e-8 update rounds a 0.05 weight, so the update's relative difference
# read 4.6e-4 where the weights were an ulp apart)
Z3_LARS_ULPS = 2.0
Z3_STATE_LIMIT = 0.55  # 33b: a rank's updater-state bytes / one replica's
# 33c, both sides the same bf16 net on the same rows: the largest
# difference over the largest magnitude.  Against one process at the
# ranks' own batch shape (64-row blocks, the same backend flags) the
# forwards are the same kernels on the same operands: RANGE_SAME_REL.
# Against one process at b128 (pred_raw) cuDNN picks its algorithms for
# another batch shape, so bf16 roundings differ: RANGE_REL, 5x pred_raw's
# 7.9e-4 reading on the card.  The served frames against one engine at
# bucket 128 stay at BF16_LOGIT_REL: the same batch-shape rounding
# moves a probability by up to 3.0e-2 where two classes nearly tie in a
# saturated softmax (largest probability 0.9999; the engine on the
# ranks' blocks is bit-equal to the ranks, my chip runs)
RANGE_SAME_REL = 1e-6
RANGE_REL = 4e-3
RANGE_ROWS = 128  # 33c's pred_raw rows: one b128 batch, 64 a rank
RANGE_FRAMES = (80, 100)  # 33c's CXB1 frames, bucket 128 (64 a rank)
RANGE_DEADLINE_S = 240  # each 33c rank process, start-up included


def _z3_run(tr, side: int, rows: slice, steps: int, counted: bool):
    """``steps`` updates of ``tr`` on its rows of phase 28's global
    batches, each step's launches (counts at 0 just before) and routed
    launches by C entry, its host ms inside the collectives and its
    collectives' bytes by kind; the loss bits."""
    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.ops.kernels import update_step
    from cxxnet_tpu_torch.parallel import distributed as pdist

    out = {"launches": [], "paths": [], "collective_ms": [], "by_op": [],
           "calls": [], "losses": [], "k8_elems": []}
    multi = update_step.sgd_update_multi

    def watched(ws, *args):
        out["k8_elems"].append(sum(w.numel() for w in ws))
        return multi(ws, *args)

    update_step.sgd_update_multi = watched
    try:
        for k in range(steps):
            x, y = _dp_batch(k, tr.batch_size, side)
            for kern in KERNELS:
                kern.reset_counts()
            paths0 = _by_symbol()
            pdist.reset_stats()
            tr.update_all(x[rows], y[rows])
            tr.sync()
            if counted:
                out["launches"].append({kern.name: kern.launches
                                        for kern in KERNELS})
                out["paths"].append(_paths_since(paths0))
            out["collective_ms"].append(pdist.STATS["seconds"] * 1e3)
            out["by_op"].append(dict(pdist.STATS["by_op"]))
            out["calls"].append(int(pdist.STATS["calls"]))
            out["losses"].append(float(tr.last_loss))
    finally:
        update_step.sgd_update_multi = multi
    return out


def _z3_state_bytes(tr) -> int:
    """The updater-state bytes this rank holds."""
    return sum(int(v.nbytes) for tags in tr.ustates.values()
               for st in tags.values() for v in st.values())


def z3_rank_main(spec_path: str, rank: int) -> int:
    """One rank process of phase 33a/33b (``python chip_smoke.py
    --z3-rank SPEC RANK``): ResNet-50 in bf16 under ``zero = 0`` and
    ``3``, ``zero = 3`` gathering the whole net at a step's start (the
    path the trainer keeps for a model axis, here made to run without
    one: ``z3_start``, for its memory), in f32 under ``zero = 3``, and in
    f32 under ``lars`` at ``zero = 0`` and ``1``, from one checkpoint;
    writes ``<out>/rank<rank>.json``."""
    import zlib

    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    with open(spec_path) as f:
        spec = json.load(f)
    globals().update(spec["consts"])
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.parallel import distributed as pdist

    world = spec["world"]
    pdist.init_distributed(spec["coord"], world, rank, dev=spec["dev"],
                           timeout_s=spec["timeout_s"])
    jit_gather = NetTrainer._jit_gather
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = DP_DETERMINISTIC
    res = {"backend": pdist.backend()}
    base = [tuple(p) for p in spec["rn_cfg"]] + [("bn_eval", "running")]
    card = torch.cuda.is_available()  # False only in a CPU rehearsal
    for name, extra, dtype in (
            ("z0", [], "bfloat16"), ("z3", [("zero", "3")], "bfloat16"),
            ("z3_start", [("zero", "3")], "bfloat16"),
            ("z3_f32", [("zero", "3")], "float32"),
            ("lars0", [("updater", "lars")], "float32"),
            ("lars1", [("updater", "lars"), ("zero", "1")], "float32")):
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        NetTrainer._jit_gather = ((lambda self: False)
                                  if name == "z3_start" else jit_gather)
        tr = _dp_trainer(base + extra, spec["rn_ckpt"], dtype, spec["dev"])
        side = int(dict(base)["input_shape"].split(",")[1])
        local = tr.batch_size // world
        rows = slice(rank * local, (rank + 1) * local)
        r = _z3_run(tr, side, rows, Z3_STEPS,
                    counted=name in ("z0", "z3", "z3_f32"))
        r["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                     if card else 0)
        r["state_bytes"] = _z3_state_bytes(tr)
        per, r["total_bytes"] = tr.state_shard_bytes()
        r["shard_bytes"] = sum(per.values())
        r["zero"] = tr.zero_snapshot()
        params, aux = _dp_params(tr)
        r["crc"] = zlib.crc32(b"".join(w.astype(np.float32).tobytes()
                                       for _kt, w in sorted(params.items())))
        if rank == 0 and name not in ("z0", "z3_start"):  # CRC enough
            np.savez(os.path.join(spec["out"], f"{name}.npz"),
                     **{"p:" + "/".join(kt): w.astype(np.float32)
                        for kt, w in params.items()},
                     **{"a:" + "/".join(kt): a.astype(np.float32)
                        for kt, a in aux.items()})
        del params, aux
        if name in ("z0", "z3", "z3_start"):
            r["step_ms"], r["timed_collective_ms"] = _dp_time(tr, rows, side)
        del tr
        NetTrainer._jit_gather = jit_gather
        res[name] = r
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    pdist.shutdown_distributed()
    return 0


def rr_rank_main(spec_path: str, rank: int) -> int:
    """One rank process of phase 33c (``python chip_smoke.py --rr-rank
    SPEC RANK``): the synthetic draws the parent saved kept first
    (``_keep_synthetic_draws``: the parent drew the same rows), then
    the port's CLI (``LearnTask``) on each of the spec's runs in turn,
    with this rank's ``dist_proc_id``, and after each its launches by
    kernel and, for the routed kernels, by C entry, to
    ``<out>/<tag>.rank<rank>.json``."""
    sys.path.insert(0, REPO)
    with open(spec_path) as f:
        spec = json.load(f)
    import numpy as np
    import torch

    from cxxnet_tpu_torch.cli import LearnTask
    from cxxnet_tpu_torch.ops import KERNELS

    _set_flags(torch, spec["flags"])
    _keep_synthetic_draws()
    with np.load(spec["draws"]) as d:
        for i in range(int(d["n"])):
            key = tuple(tuple(k) if isinstance(k, list) else k
                        for k in json.loads(str(d[f"k{i}"])))
            _DRAWS[key] = (d[f"d{i}"], d[f"l{i}"])
    code = 0
    for run in spec["runs"]:
        for k in KERNELS:
            k.reset_counts()
        paths0 = _by_symbol()
        code = LearnTask().run(run["argv"] + [f"dist_proc_id={rank}"])
        with open(os.path.join(spec["out"],
                               f"{run['tag']}.rank{rank}.json"), "w") as f:
            json.dump({"code": code,
                       "launches": {k.name: k.launches for k in KERNELS},
                       "paths": _paths_since(paths0)}, f)
        if code:
            break
    return code


def _z3_phase(tmp: str, card: str) -> dict:
    """33a (with 28b's checks) and 33b: the rank job of
    :func:`z3_rank_main`, 33a's one-rank references (bf16 and f32) here
    first."""
    import numpy as np

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve.fleet import free_port

    rn_cfg = cfgmod.parse_file(RESNET_CONF)
    tr = NetTrainer()
    tr.set_params(rn_cfg + [("dev", DP_DEV), ("seed", str(SEED))])
    tr.init_model()
    ckpt = os.path.join(tmp, "z3_rn.model")
    tr.save_model(ckpt)
    whole_bytes = sum(int(w.nbytes) for tags in tr.params.values()
                      for w in tags.values())
    del tr
    # the one-rank reference of 33a (phase 28's way): bf16, zero = 0
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = DP_DETERMINISTIC
    cfg1 = rn_cfg + [("bn_eval", "running")]
    side = int(dict(cfg1)["input_shape"].split(",")[1])
    ones = {}
    for name, dtype in (("z3", "bfloat16"), ("z3_f32", "float32")):
        tr = _dp_trainer(cfg1, ckpt, dtype, DP_DEV)
        w0 = _dp_params(tr)[0]
        r = _z3_run(tr, side, slice(None), Z3_STEPS, counted=False)
        r["params"], r["aux"] = _dp_params(tr)
        ones[name] = r
        del tr
        torch.cuda.empty_cache()
    one = ones["z3"]
    out_dir = os.path.join(tmp, "z3_out")
    os.makedirs(out_dir)
    spec = {"rn_cfg": rn_cfg, "rn_ckpt": ckpt, "world": DP_RANKS,
            "coord": f"127.0.0.1:{free_port()}", "timeout_s": 120.0,
            "out": out_dir, "dev": DP_DEV,
            "consts": {k: globals()[k] for k in (
                "Z3_STEPS", "DP_TIMED", "DP_DETERMINISTIC", "SEED")}}
    path = os.path.join(tmp, "z3_spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    codes, outs = _dp_spawn(
        [[sys.executable, os.path.abspath(__file__), "--z3-rank", path,
          str(r)] for r in range(DP_RANKS)], tmp, "z3_rank")
    ranks_s = time.perf_counter() - t0
    if any(c != 0 for c in codes):
        raise SmokeError(f"33a/b: rank exits {codes}: "
                         + " | ".join(o[-2500:] for o in outs))
    got = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            got.append(json.load(f))
    if got[0]["backend"] != "gloo":
        raise SmokeError(f"33: two ranks on one card ran {got[0]['backend']}")
    res = {"ranks_s": ranks_s}
    # 33a: every step of zero = 3 launches K1, K2, K6 and K8, in bf16 on
    # their main entries (f32 has its own entries)
    for r, g in enumerate(got):
        for name in ("z3", "z3_f32"):
            for s, (launches, paths) in enumerate(zip(g[name]["launches"],
                                                      g[name]["paths"])):
                if any(launches.get(k, 0) != v
                       for k, v in RESNET_PER_STEP.items()) or (
                        name == "z3"
                        and paths != _main_paths(RESNET_PER_STEP)):
                    raise SmokeError(f"33a {name}: rank {r} step {s} "
                                     f"launched {launches} by C entry "
                                     f"{paths}, want {RESNET_PER_STEP} on "
                                     "the main entries")
    # bit-equal to zero = 0 over the same two ranks, and the ranks agree
    runs = ("z0", "z3", "z3_start")
    crcs = {n: [g[n]["crc"] for g in got] for n in runs}
    losses = {n: [g[n]["losses"] for g in got] for n in runs}
    log(f"33a: weight CRCs {crcs}; losses {losses}")
    if len({c for n in runs for c in crcs[n]}) != 1 or any(
            losses[n] != losses["z0"] for n in runs):
        raise SmokeError(f"33a: zero=3 is not bit-equal to zero=0: {crcs} "
                         f"{losses}")
    for name in ("z3", "z3_f32"):
        d = np.load(os.path.join(out_dir, f"{name}.npz"))

        def part(pre, d=d):
            return {tuple(k[2:].split("/")): d[k].astype(np.float64)
                    for k in d.files if k.startswith(pre)}

        cos = _cos_updates(part("p:"), ones[name]["params"], w0)
        if name == "z3_f32":
            _dp_check("rn zero3 f32 2 ranks vs 1, update cosine", cos,
                      RESNET_F32_COS, RESNET_F32_COS_MEDIAN, False,
                      phase="33a")
        else:
            _dp_check("rn zero3 bf16 2 ranks vs 1, classifier update "
                      "cosine", {kt: c for kt, c in cos.items()
                                 if kt[0].endswith("_fc1000")},
                      RESNET_BF16_CLS_COS, RESNET_BF16_CLS_COS, False,
                      phase="33a")
            _dp_check("rn zero3 bf16 2 ranks vs 1, update cosine "
                      "(logged)", cos, -1.0, -1.0, False, phase="33a")
        ref_aux = ones[name]["aux"]
        aux_rel = {kt: float(np.abs(a - ref_aux[kt]).max()
                             / max(np.abs(ref_aux[kt]).max(), 1e-30))
                   for kt, a in part("a:").items()}
        lim = ((DP_AUX_REL, DP_AUX_REL_MEDIAN) if name == "z3_f32"
               else (DP_AUX_BF16_REL, DP_AUX_BF16_REL_MEDIAN))
        _dp_check(f"{name} running statistics 2 ranks vs 1, rel",
                  aux_rel, *lim, True, phase="33a")
    frac = max(g["z3"]["shard_bytes"] for g in got) / got[0]["z3"][
        "total_bytes"]
    k8 = [g["z3"]["k8_elems"][0] for g in got]
    k8_1 = sum(int(w.size) for w in w0.values())
    log(f"33a: zero=3 train-state bytes a rank "
        f"{[g['z3']['shard_bytes'] for g in got]} of "
        f"{got[0]['z3']['total_bytes']} ({frac:.3f}, limit "
        f"{DP_SHARD_LIMIT}); K8 on slices: {k8} elements a rank against "
        f"{k8_1} on one")
    if frac > DP_SHARD_LIMIT or not all(e < k8_1 for e in k8):
        raise SmokeError(f"33a: zero=3 bytes {frac:.3f} or K8 elements {k8} "
                         f"of {k8_1}")
    rel = abs(losses["z3"][0][0] - one["losses"][0]) / abs(one["losses"][0])
    log(f"33a bf16 loss 2 ranks vs 1: rel {rel:.3g} (limit "
        f"{DP_RN_LOSS_REL:g})")
    if not rel <= DP_RN_LOSS_REL:
        raise SmokeError(f"33a: bf16 loss rel {rel:g}")
    # the gathered peak, the card's memory, the step and its collectives
    zs = [g["z3"]["zero"] for g in got]
    peak = max(z["zero_gathered_peak_bytes"] for z in zs)
    group = zs[0]["largest_group_bytes"]
    rs = [g["z3"]["by_op"][0].get("reduce_scatter", 0) for g in got]
    ar0 = [g["z0"]["by_op"][0].get("all_reduce", 0) for g in got]
    ar3 = [g["z3"]["by_op"][0].get("all_reduce", 0) for g in got]
    res["z3"] = {
        "gathered_peak_bytes": [z["zero_gathered_peak_bytes"] for z in zs],
        "largest_group_bytes": group,
        "whole_weight_bytes": zs[0]["whole_weight_bytes"],
        "f32_master_bytes_one_replica": whole_bytes,
        "max_memory_allocated": {n: [g[n]["max_memory_allocated"]
                                     for g in got] for n in runs},
        "step_ms": {n: [g[n]["step_ms"] for g in got] for n in runs},
        "collective_ms": {n: [g[n]["timed_collective_ms"] for g in got]
                          for n in runs},
        "collective_calls_a_step": {n: [g[n]["calls"][0] for g in got]
                                    for n in runs},
        "bytes_by_op_a_step": {n: [g[n]["by_op"][0] for g in got]
                               for n in runs},
        "launches_a_step": got[0]["z3"]["launches"][0],
        "losses": losses["z3"], "loss_1": one["losses"]}
    log(f"33a: zero=3 gathered peak a rank "
        f"{res['z3']['gathered_peak_bytes']} bytes against the whole net's "
        f"{zs[0]['whole_weight_bytes']} and the largest group's {group} "
        f"(limit {Z3_PEAK_GROUPS:g}x); by run (z3_start: the whole net "
        f"gathered at the step's start) max_memory_allocated a rank "
        f"{res['z3']['max_memory_allocated']}; step ms "
        f"{res['z3']['step_ms']}, host ms in the collectives "
        f"{res['z3']['collective_ms']}, collective calls a step "
        f"{res['z3']['collective_calls_a_step']}; a step's bytes to the "
        f"backend by kind {res['z3']['bytes_by_op_a_step']} ({card})")
    if not 0 < peak <= Z3_PEAK_GROUPS * group or \
            peak >= zs[0]["whole_weight_bytes"]:
        raise SmokeError(f"33a: gathered peak {peak} against the largest "
                         f"group {group} and the whole net "
                         f"{zs[0]['whole_weight_bytes']}")
    mem = res["z3"]["max_memory_allocated"]
    if not all(a < b for a, b in zip(mem["z3"], mem["z3_start"])):
        raise SmokeError(f"33a: the gather at use held no less of the card "
                         f"than the step-start gather: {mem}")
    if not all(a0 - a3 == 2 * b for a0, a3, b in zip(ar0, ar3, rs)) or \
            not all(rs):
        raise SmokeError(f"33a: the sharded gradients were not "
                         f"reduce-scattered: all-reduce bytes zero=0 {ar0}, "
                         f"zero=3 {ar3}, reduce-scatter {rs}")
    # 33b: lars's state cut under zero = 1, its update against zero = 0
    whole_state = got[0]["lars0"]["state_bytes"]
    frac = [g["lars1"]["state_bytes"] / whole_state for g in got]
    d0 = np.load(os.path.join(out_dir, "lars0.npz"))
    d1 = np.load(os.path.join(out_dir, "lars1.npz"))
    ulps = {}
    leaves = [k for k in d0.files if k.startswith("p:")]
    for k in leaves:
        a, b = d1[k].astype(np.float32), d0[k].astype(np.float32)
        ulps[tuple(k[2:].split("/"))] = float(
            np.abs(a - b).max() / np.spacing(np.abs(b).max()))
    moved = sum(int((d0[k] != w0[tuple(k[2:].split("/"))]).any())
                for k in leaves)
    worst, med = _dp_check("lars zero=1 vs zero=0 2 ranks, f32 weights in "
                           "ulps", ulps, Z3_LARS_ULPS, Z3_LARS_ULPS, True,
                           phase="33b")
    if moved < len(leaves) // 2:
        raise SmokeError(f"33b: lars moved {moved} of {len(leaves)} "
                         "tensors")
    held = [g["lars1"]["state_bytes"] for g in got]
    log(f"33b: lars updater-state bytes a rank {held} of one replica's "
        f"{whole_state} ({[round(f, 4) for f in frac]}, limit "
        f"{Z3_STATE_LIMIT}); weight CRCs zero=1 "
        f"{[g['lars1']['crc'] for g in got]} ({card})")
    if max(frac) > Z3_STATE_LIMIT or got[0]["lars1"]["crc"] != \
            got[1]["lars1"]["crc"]:
        raise SmokeError(f"33b: lars state {frac} of a replica, or the ranks "
                         "differ")
    res["lars"] = {"state_bytes": [g["lars1"]["state_bytes"] for g in got],
                   "state_bytes_one_replica": whole_state,
                   "weights_ulps_worst": worst, "weights_ulps_median": med}
    launches = {}
    for g in got:
        for step in g["z3"]["launches"] + g["z3_f32"]["launches"]:
            for k, v in step.items():
                launches[k] = launches.get(k, 0) + v
    res["launches"] = launches
    return res


def _flags(torch) -> list:
    """The backend flags that pick the card's algorithms: cuDNN's
    ``deterministic``, ``benchmark`` and ``allow_tf32``, and the
    matmuls' ``allow_tf32``."""
    return [torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32]


def _set_flags(torch, flags) -> None:
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = (bool(f) for f in flags)


def _rr_start(tmp: str, runs, draws: str):
    """Two 33c rank processes of :func:`rr_rank_main` over ``runs``
    (``(tag, argv)``, each with a fresh coordinator), the draws of
    ``draws`` kept first and this process's backend flags set."""
    import torch

    from cxxnet_tpu_torch.serve.fleet import free_port

    spec = {"runs": [{"tag": tag, "argv": list(argv) + [
        f"dist_coordinator=127.0.0.1:{free_port()}",
        f"dist_num_proc={DP_RANKS}", "dist_timeout_s=120", f"dev={DP_DEV}"]}
        for tag, argv in runs], "out": tmp, "draws": draws,
        "flags": _flags(torch)}
    path = os.path.join(tmp, "rr_spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return _dp_start([[sys.executable, os.path.abspath(__file__),
                       "--rr-rank", path, str(r)] for r in range(DP_RANKS)],
                     tmp, "rr")


def _rr_counts(tmp: str, tag: str, forwards: int):
    """Each 33c rank's launches: ``forwards`` forwards of GoogLeNet's
    K1, K4 and K6 on their main entries and nothing else."""
    want = {k: v * forwards for k, v in PER_FORWARD.items()}
    got = []
    for r in range(DP_RANKS):
        with open(os.path.join(tmp, f"{tag}.rank{r}.json")) as f:
            d = json.load(f)
        launches = {k: v for k, v in d["launches"].items() if v}
        if launches != want or d["paths"] != _main_paths(want):
            raise SmokeError(f"33c {tag}: rank {r} launched {launches} by C "
                             f"entry {d['paths']}, want {want} on the main "
                             "entries")
        got.append(launches)
    return got


def _rr_close(one, two, what: str, limit: float) -> dict:
    """The largest difference of two score arrays over the largest
    magnitude (``rel``, held at ``limit``), the difference itself and
    that magnitude."""
    import numpy as np

    one, two = np.asarray(one, np.float64), np.asarray(two, np.float64)
    if one.shape != two.shape or not np.isfinite(two).all():
        raise SmokeError(f"33c {what}: shape {two.shape} vs {one.shape} or "
                         "values not finite")
    diff, top = float(np.abs(one - two).max()), float(np.abs(one).max())
    rel = diff / max(top, 1e-30)
    if not rel <= limit:
        raise SmokeError(f"33c {what}: two ranks vs one process rel "
                         f"{rel:g} (max abs {diff:g} of {top:g}; limit "
                         f"{limit})")
    return {"rel": rel, "max_abs": diff, "max_one": top}


def _blocks_forward(tr, x, ranks: int):
    """``x``'s scores as a serving range of ``ranks`` computes them, on
    one process: the request padded to its bucket, cut into one block of
    rows a rank, each block's forward at the block's rows (the ranks'
    batch shape), the blocks joined and trimmed."""
    import numpy as np

    from cxxnet_tpu_torch.serve.cache import bucket_size

    n = x.shape[0]
    per = bucket_size(n) // ranks
    x = x.reshape((n,) + tr.net.input_node_shape(1)[1:])
    f = tr.predict_fn()
    return np.concatenate([f(tr.params, tr.aux, x[lo:min(lo + per, n)], (),
                             pad_to=per).cpu().numpy()
                           for lo in range(0, per * ranks, per)])[:n]


def _range_phase(tmp: str, card: str) -> dict:
    """33c: GoogLeNet (googlenet.conf, bf16, full width) over two ranks
    sharing the card, one job: ``task = pred_raw`` on one b128 batch
    against one process's file, then ``task = serve``: ``CXB1`` frames at
    bucket 128 against one process's engine; each rank's launches."""
    import http.client

    import numpy as np

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.cli import LearnTask
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import Engine

    conf = _synthetic_conf(tmp, "range.conf",
                           (("pred", "range_raw.txt", RANGE_ROWS, False),),
                           1.0)
    cfg = cfgmod.parse_file(conf)
    tr = NetTrainer()
    tr.set_params(cfg + [("dev", "gpu"), ("seed", str(SEED + 33))])
    tr.init_model()
    model = os.path.join(tmp, "range.model")
    tr.save_model(model)
    del tr
    res = {}
    # pred_raw on one process here; its rows go to the ranks
    one_dir, two_dir = os.path.join(tmp, "one"), os.path.join(tmp, "two")
    for d in (one_dir, two_dir):
        os.makedirs(d)
    argv = [conf, f"model_in={model}", "silent=1"]
    cwd = os.getcwd()
    os.chdir(one_dir)
    try:
        t0 = time.perf_counter()
        LearnTask().run(argv + ["task=pred_raw", "dev=gpu"])
        one_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    kept = [(k, v) for k, v in _DRAWS.items() if k[1] == RANGE_ROWS]
    draws = os.path.join(tmp, "draws.npz")
    np.savez(draws, n=len(kept), **{
        f"{c}{i}": v for i, (k, (d, lab)) in enumerate(kept)
        for c, v in (("k", json.dumps(k)), ("d", d), ("l", lab))})
    # the two ranks: pred_raw, then serve until SIGTERM to rank 0
    t0 = time.perf_counter()
    job = _rr_start(two_dir, [("pred_raw", argv + ["task=pred_raw"]),
                              ("serve", argv + ["task=serve", "serve_port=0",
                                                "silent=0"])], draws)
    procs, logs = job
    try:
        port, deadline = None, time.perf_counter() + RANGE_DEADLINE_S
        while port is None and time.perf_counter() < deadline:
            if procs[0].poll() is not None:
                break
            with open(logs[0], errors="replace") as f:
                m = re.search(r"serving model .* at http://[^:]+:(\d+)",
                              f.read())
            port = int(m.group(1)) if m else None
            time.sleep(0.1)
        if port is None:
            raise SmokeError("33c: rank 0 never served")
        xs = [_rows(n, CONF_SIDE, SEED + 330 + n) for n in RANGE_FRAMES]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            got = [_wire_scores(conn, x) for x in xs]
        finally:
            conn.close()
    finally:
        if procs[0].poll() is None:
            procs[0].send_signal(signal.SIGTERM)
        codes, outs = _dp_finish(job, t0)
    two_s = time.perf_counter() - t0
    if any(c != 0 for c in codes):
        raise SmokeError(f"33c: rank exits {codes}: "
                         + " | ".join(o[-2500:] for o in outs))
    a = np.loadtxt(os.path.join(one_dir, "range_raw.txt"), ndmin=2)
    b = np.loadtxt(os.path.join(two_dir, "range_raw.txt"), ndmin=2)
    if a.shape != (RANGE_ROWS, 1000):
        raise SmokeError(f"33c pred_raw: one process wrote {a.shape}")
    close = _rr_close(a, b, "pred_raw", RANGE_REL)
    counts = _rr_counts(two_dir, "pred_raw", 1)
    res["pred_raw"] = {"rows": RANGE_ROWS, **close, "one_s": one_s,
                       "launches_a_rank": counts}
    log(f"33c pred_raw: {RANGE_ROWS} rows over 2 ranks (64 a rank) against "
        f"one process (b{RANGE_ROWS}): {close} (limit {RANGE_REL}); per "
        f"rank {counts[0]} on the main entries ({card})")
    m = re.search(r"serving range: rank 1 stopped after (\d+) forward",
                  outs[1])
    if m is None or int(m.group(1)) != len(RANGE_FRAMES):
        raise SmokeError(f"33c serve: the follower's forwards: "
                         f"{outs[1][-1500:]}")
    counts = _rr_counts(two_dir, "serve", len(RANGE_FRAMES))
    with Engine(cfg=cfg + [("dev", "gpu")], model_in=model,
                silent=True) as eng:
        ref = [eng.scores(x) for x in xs]
        blocks = [_blocks_forward(eng.trainer, x, DP_RANKS) for x in xs]
    same = [_rr_close(r1, r2, f"serve {x.shape[0]} rows, one process on "
                      "the ranks' blocks", RANGE_SAME_REL)
            for r1, r2, x in zip(blocks, got, xs)]
    whole = [_rr_close(r1, r2, f"serve {x.shape[0]} rows, one engine at "
                       "bucket 128", BF16_LOGIT_REL)
             for r1, r2, x in zip(ref, got, xs)]
    res["serve"] = {"frames": list(RANGE_FRAMES), "same_shape": same,
                    "one_engine": whole, "launches_a_rank": counts,
                    "two_ranks_s": two_s}
    log(f"33c serve: CXB1 frames of {list(RANGE_FRAMES)} rows at bucket 128 "
        f"over 2 ranks against one process on the same 64-row blocks "
        f"{same} (limit {RANGE_SAME_REL}) and against one engine at bucket "
        f"128 {whole} (limit {BF16_LOGIT_REL}); per rank {counts[0]} on the main "
        f"entries; SIGTERM to rank 0 ended both; the two ranks' job "
        f"{two_s:.1f}s, one process's pred_raw {one_s:.1f}s ({card})")
    launches = {}
    for c in counts + res["pred_raw"]["launches_a_rank"]:
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    res["launches"] = launches
    return res


def zero_range_phase(card: str) -> dict:
    """Phase 33: 33a and 33b (one rank job), then 33c."""
    import torch

    t0 = time.perf_counter()
    out = {"card": card}
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        for name, fn in (("zero", _z3_phase), ("range", _range_phase)):
            t1 = time.perf_counter()
            with tempfile.TemporaryDirectory(
                    prefix=f"chip_smoke_33_{name}_") as tmp:
                out[name] = fn(tmp, card)
            torch.cuda.empty_cache()
            out[name]["phase_s"] = time.perf_counter() - t1
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    out["launches"] = {k: out["zero"]["launches"].get(k, 0)
                       + out["range"]["launches"].get(k, 0)
                       for k in set(out["zero"]["launches"])
                       | set(out["range"]["launches"])}
    out["phase_s"] = time.perf_counter() - t0
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 2
    if not (os.path.isdir(os.path.join(REPO, "cxxnet_tpu_torch"))
            and all(os.path.exists(c) for c in (CONF, RESNET_CONF,
                                                MNIST_CONF, DIGITS_CONF,
                                                BOWL_CONF, BOWL_PRED_CONF,
                                                DIST_CONF))):
        print("chip_smoke: run it from the root of a cxxnet-tpu checkout "
              "(cxxnet_tpu_torch/, example/ImageNet/{googlenet,resnet50}"
              ".conf, example/MNIST/{MNIST_CONV,digits_conv}.conf and "
              "example/kaggle_bowl/{bowl,pred}.conf)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    _keep_synthetic_draws()
    phase_s, mark = {}, [time.perf_counter()]

    def lap(name):
        """The seconds since the last lap, as phase ``name``."""
        now = time.perf_counter()
        phase_s[name] = round(now - mark[0], 1)
        mark[0] = now

    try:
        card = gpu_line()
        log(card)
        from cxxnet_tpu_torch.ops import KERNELS, _build

        t0 = time.perf_counter()
        secs = _build.build(KERNELS)
        log(f"build: {len(secs)} kernel(s) in {time.perf_counter() - t0:.1f}s"
            f" wall {json.dumps({k: round(v, 2) for k, v in secs.items()})}")
        for k in KERNELS:
            for line in k.build_log.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"ptxas {k.name}: {line.strip()}")
        conv_block_build_report()
        int8_build_report()
        dev = torch.device("cuda:0")
        log(f"device: {torch.cuda.get_device_name(0)} "
            f"torch {torch.__version__} cuda {torch.version.cuda}")

        lap("1 build")
        rows = check_kernels(dev)
        lap("2 kernels")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serve_launches, path, answers, wire_gn = serve_phase(tmp)
            int8_rows, quant_launches = quant_phase(tmp, path, answers)
        lap("3-4 serve, int8")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
            train_launches, mdir, cfg, synthetic_rates = train_phase(tmp)
            parity_phase(cfg, mdir)
            conf_rates_phase(cfg, mdir)
            guard = guard_phase(tmp, mdir, cfg)
            rate_phase(cfg, mdir)
        lap("5-7 train")
        flash_rows = check_flash(dev)
        lap("8 flash")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
            lm_launches, mdir, conf, cfg = lm_train_phase(tmp)
            lm_rate_phase(cfg, mdir)
            lm_parity_phase(cfg, mdir)
            gen_launches = lm_generate_phase(conf, mdir, tmp)
        lm_head_dim_phase()
        lap("9-12 lm")
        rrows = resnet_kernels(dev, rows)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_rn_") as tmp:
            r_serve, wire_rn = resnet_serve_phase(tmp)
            r_train, mdir, cfg = resnet_train_phase(tmp)
            resnet_parity_phase(cfg, mdir)
            rate_phase(cfg, mdir, RESNET_PER_STEP, "ResNet-50")
        resnet_updater_phase(dev)
        log(json.dumps(resnet_line(rrows, r_serve, r_train)))
        lap("13-17 resnet50")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_reload_") as tmp:
            reload_out, k7_rows = reload_phase(tmp, card)
        log(json.dumps({"reload": reload_out}))
        log(json.dumps({"resnet50_int8_k7": {"card": card, "rows": k7_rows}}))
        lap("17a reload")
        mrows = mnist_kernels(dev)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mnist_") as tmp:
            m_counts = mnist_phase(tmp, card)
            guard["mnist_rollbacks"] = {
                k: v for (k, where), v in mnist_guard_phase(tmp, card).items()
                if where == "gpu"}
        log(json.dumps({"guard": dict(guard, card=card)}))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_digits_") as tmp:
            d_counts = digits_phase(tmp, card)
        log(json.dumps(mnist_line(mrows, m_counts, d_counts, card)))
        log(json.dumps({"wire_warm_latency_ms": {
            "card": card, "GoogLeNet": wire_gn, "ResNet-50": wire_rn}}))
        lap("18-20 mnist, digits")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_imgbin_") as tmp:
            imgbin_out = imgbin_phase(tmp, card, synthetic_rates)
        log(json.dumps({"imgbin": imgbin_out}))
        lap("20a imgbin")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
            zoo = {"card": card, "googlenet_rewrites": rewrite_phase(tmp, card),
                   "digits_wino_bf16": wino_digits_phase(tmp, card),
                   "ndsb": ndsb_phase(tmp, card)}
        log(json.dumps({"layers": zoo}))
        lap("22 layers")
        t23 = time.perf_counter()
        builds = host_builds()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_lib_") as tmp:
            lib_out = {"card": card, "host_builds": builds,
                       "wrapper": library_phase(tmp, card, builds),
                       "capi": capi_phase(tmp, card, builds),
                       "obs": obs_phase(tmp, card)}
        lib_out["phase_s"] = time.perf_counter() - t23
        log(json.dumps({"library_obs": lib_out}))
        lap("23 library, obs")
        log(json.dumps({"utilities": utilities_phase(card)}))
        lap("24 utilities")
        loop_out = closed_loop_phase(card)
        log(json.dumps({"closed_loop": loop_out}))
        lap("25 closed loop, data service")
        fleet_out = fleet_phase(card)
        log(json.dumps({"fleet": fleet_out}))
        lap("26 fleet, branch-embed")
        p27 = moe_pipe_remat_phase(card)
        log(json.dumps({"moe_pipe_remat": p27}))
        lap("27 moe, pipe, remat")
        p28 = data_parallel_phase(card)
        log(json.dumps({"data_parallel": p28}))
        lap("28 data parallel")
        p2930 = async_seq_parallel_phase(card)
        log(json.dumps({"async_seq_parallel": {
            k: v for k, v in p2930.items() if k != "hops"}}))
        lap("29-30 async, seq parallel")
        p31 = model_axis_phase(card)
        log(json.dumps({"model_axis": {k: v for k, v in p31.items()
                                       if k != "kernels"}}))
        lap("31 model axis")
        p32 = elastic_phase(card)
        log(json.dumps({"elastic": {k: v for k, v in p32.items()
                                    if k not in ("launches", "generations")}}))
        lap("32 elastic")
        p33 = zero_range_phase(card)
        log(json.dumps({"zero_range": p33}))
        lap("33 zero, range")
        line = kernels_line(rows, serve_launches, train_launches, flash_rows,
                            lm_launches, gen_launches, int8_rows,
                            quant_launches, loop_out, fleet_out, p27, p28,
                            p2930, p31, p32, p33)
        log(json.dumps({"phase_s": phase_s, "total_s": round(sum(
            phase_s.values()), 1), "card": card}))
        log(card)
        log(json.dumps(line))
    except Exception:  # noqa: BLE001 - every failure ends the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--dp-rank":
        sys.exit(dp_rank_main(sys.argv[2], int(sys.argv[3])))
    if len(sys.argv) == 4 and sys.argv[1] == "--mp-rank":
        sys.exit(mp_rank_main(sys.argv[2], int(sys.argv[3])))
    if len(sys.argv) == 4 and sys.argv[1] == "--ma-rank":
        sys.exit(ma_rank_main(sys.argv[2], int(sys.argv[3])))
    if len(sys.argv) == 4 and sys.argv[1] == "--el-rank":
        sys.exit(el_rank_main(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "--z3-rank":
        sys.exit(z3_rank_main(sys.argv[2], int(sys.argv[3])))
    if len(sys.argv) == 4 and sys.argv[1] == "--rr-rank":
        sys.exit(rr_rank_main(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
