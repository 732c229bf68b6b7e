#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA
card: Llama-3-8B inference and training through the hand-written
flash-attention kernels (forward, dQ, dK/dV; bf16 and f16 on the tensor
cores, f32 on the FMA pipes), Llama serving through
``mxnet_tpu_torch.serving.GenerativeServer`` (paged KV, continuous
batching, speculative verify, radix prefix reuse), and ResNet-50 v1
inference through the hand-written fused 1x1 conv + BatchNorm + ReLU
kernel (bf16 and f16 on the tensor cores, f32 on the FMA pipes), and its
training step; every optimizer update through the hand-written fused
multi-tensor kernel, and the CUDA graphs of ``hybridize()``,
``FusedTrainStep``, ``generate`` and the serving tick; ``.params`` files
and a checkpoint's round trip; BERT-base training under amp through the
flash kernels, and stateless serving through ``InferenceServer`` (a
ResNet-50 and a BERT-base classifier); the rest of the vision model zoo
(MobileNet, Inception v3, DenseNet, VGG, AlexNet, SqueezeNet) in f32
against the CPU, MobileNet v1, DenseNet-121 and Inception v3 inference
through the fused 1x1 kernel at 13, 58 and 40 launches a forward, and
Inception v3 training with RMSProp, the metrics and ``Speedometer``; and
the data plane: JPEG ``.rec`` shards through ``io.ImageRecordIter`` (the
native reader, built by g++), ``gluon.data.DataLoader`` and
``data.StreamingLoader`` with the CUDA-stream ``DevicePrefetcher`` into
ResNet-50 training and a hybridized eval pass, and packed Llama
pretraining (``segment_ids``, ``packed_lm_loss``); and synchronous
multi-GPU on a one-rank NCCL group: the ``dist_sync`` store, phase 9's
Llama step over a mesh of ``DTensor`` parameters, the ring and Ulysses
bodies at full width, and SyncBatchNorm; and the 1F1B pipeline over 4
stages on the card, ``FusedTrainStep`` and ``hybridize()`` graphs over
the mesh, serving on a mesh, and a sharded checkpoint; and Mixtral-8x7B
(MoE) inference and training at full width through the flash kernels,
its expert-parallel route, and the ``dist_async`` parameter server; and
int8 inference (the quantized ops, ``quantize_net`` on ResNet-50, int8
``InferenceServer`` and ``GenerativeServer``) and recurrent nets
(``nd.RNN``, an LSTM word language model, a BiLSTM with ``CTCLoss``);
and detection: the contrib ops, SSD-512, Faster R-CNN and YOLOv3
inference through the hand-written NMS scan kernel (``nms_keep``) and
SSD-512 training fed by ``ImageDetIter``; and sparse storage: the
row_sparse and CSR ops at the factorization machine's width, ``FMModel``
at Criteo width through ``LibSVMIter`` and the lazy Adam rows, the
sparse linear classification example, row-sparse values through the
``dist_sync`` and ``dist_async`` stores, and a profile of an FM step and
a ResNet-50 forward; and symbols and export: ResNet-50 as an ``mx.sym``
graph through ``Executor``, ``Module.fit`` and a ``BucketingModule``
LSTM, ResNet-50 and BERT-base exported as ``torch.export`` programs that
hold the flash forward and the fused 1x1 kernel as custom ops, served
through ``Predictor`` and ``InferenceServer(Predictor)``, BERT-base
through ``bert_to_symbol`` and ONNX, and the symbol quantizer; and the
NumPy front end and the Estimator: ``gluon.contrib.estimator.
Estimator.fit`` on a BERT-base classifier in np mode through the flash
kernels and the fused update, every name of ``mx.np`` on the card
against the CPU, ``nd.Custom`` and ``rtc.PallasKernel``, and the tools
(``Monitor`` on ResNet-50 through the fused 1x1 kernel, ``runtime``,
``test_utils.check_consistency``, ``visualization``); and memory as a
managed budget: the planner against the card's own figures, the remat
tiers on a 16-layer ``llama3_8b`` step, the full 32-layer ``llama3_8b``
trained under remat, and host-offloaded optimizer state
(``Trainer(offload="host")``).

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit.  Phases, each printed as a JSON line:

1. card: ``nvidia-smi`` name and power limit, torch, CUDA and nvcc, and
   the torch precision flags the package turns off at import (TF32 and
   the bf16/f16 reduced-precision split-K reductions);
2. build: every source in ``csrc/`` with nvcc for sm_90a, all at once;
3. kernel: the forward kernel against its plain PyTorch version at every
   shape of ``KERNEL_SHAPES`` (bf16 and f16 at each D, Tq < Tk, rows
   that see no key, f32), O held row by row and by its relative norm,
   with its time and TFLOP/s, the plain version's, torch SDPA's (a
   yardstick only, where Tq = Tk) and the card's bound; at the slice shape also the wrapper's host time and the
   kernel launched alone through its C entry point;
4. backward kernels: ``flash_attention_bwd`` (dQ and dK/dV) against the
   plain backward at every shape of ``BWD_SHAPES``, each gradient held
   row by row and by its relative norm, with each kernel's time and
   TFLOP/s, delta's, the plain version's, torch SDPA's backward (where
   Tq = Tk) and the bound; at the slice shape also each kernel's wrapper
   host time and its launch alone through its C entry point;
5. fused kernel: ``fused_matmul_affine_relu`` against its plain version
   at ResNet-50 v1's eight shapes (B=128) in bf16 and in f16, one f32
   and one ragged shape, with its design, time, TFLOP/s, the plain
   version's time, the library's (``addmm`` with the scale folded, then
   ``relu``), the eager cuDNN chain's and the bound, and the NCHW ->
   (M, K) copy's time; then one bf16 and one f16 forward's sums; and
   every distinct bf16 shape of MobileNet v1 1.0 (9 shapes, 13 launches
   a forward), Inception v3 (19, 40) and DenseNet-121 (58, 58) at B=128
   (read off a CPU forward), each against the plain version with its
   time, bound, plain time and ``addmm`` + ``relu``'s, and each net's
   forward summed over its launches beside its bound;
5b. multi-tensor update: ``csrc/multi_tensor_update.cu`` against its
   plain version (the optimizers' per-tensor rules) for SGD, SGD with
   momentum, NAG, Adam and AdamW in f32, bf16, bf16 with f32 masters and
   f16 at ragged lengths (weights within 1 ulp, f32 states within 2), and
   over the 147 tensors of the 16-layer Llama training slice: its time
   beside the 18.97 ms bound, the plain rule's and the
   ``torch._foreach_*`` chain's (the library yardstick);
6. f32 check: ``llama3_8b`` width at 2 layers, f32, ``net(ids)`` through
   the kernel against the KV-cache decoder's dense prefill;
7. f32 training check: the same net, one loss and backward through the
   kernels (``attn_mode="flash"``) against dense torch autograd
   (``"sdpa"``): the loss and every parameter's gradient;
7b. bf16 checks: the same widths at 2 layers in bf16, at three seeds,
   through the tensor-core kernels: ``net(ids)`` against the dense route,
   then one loss and backward against dense torch autograd, logits and
   every gradient held by relative norm; and the witness, both routes
   against the dense route in f32 on the same weights, the kernels' route
   no further from it than the dense route is (within a factor);
7d. ``FusedTrainStep`` at the same widths, 2 layers, f32, K=2: one
   captured CUDA graph of forward, loss, backward (the flash kernels) and
   the fused update, against two eager steps; then a checkpoint of its
   training state, resumed into a fresh net and trainer: the next step's
   loss and weights equal the uninterrupted run's;
7c. serving exactness: the same widths at 2 layers in f32, 8 prompts of
   64-1024 tokens (32 new tokens each; 4 slots, max_len 2048, blocks of
   16) through ``GenerativeServer`` in the paged mode, the slots mode,
   with speculative decoding (the net as its own draft, spec_k=3), and
   8 prompts sharing a 512-token prefix with the radix cache: every
   reply equal to ``LlamaDecoder.generate`` on its prompt alone, token
   for token;
8. the Llama inference slice: ``llama3_8b`` at full width and depth in
   bf16, weights drawn on the card from a seed: one prompt forward
   (T=2048), eagerly and then hybridized (a replayed CUDA graph, logits
   against the eager ones), and three greedy ``generate`` requests, whose
   decode steps replay a CUDA graph, against the eager decoder's tokens
   and tokens/s;
8b. the serving slice on phase 8's net: 8 requests of 64-1024 tokens in
   the paged mode, in two waves (2, then 6 that join in-flight decode),
   each reply fed back through ``net(ids)`` (the flash forward) and
   every generated token held to the argmax within 24 bf16 ulps, and
   at least 240 of the 256 tokens equal to the offline decoder's (its
   tokens fed back the same way and the dense route's argmax are read
   as witnesses); the serving path itself launches no kernel of the
   port; TTFT, decode step times, tokens/s, prefill batch times, KV
   blocks and memory;
9. the Llama training slice: ``llama3_8b`` at full width and 16 layers in
   bf16, B=1, T=2048, SGD with momentum through ``gluon.Trainer``: one
   warm-up step and three timed steps on one batch, the update one launch
   of the multi-tensor kernel, its time beside its bound;
10. ResNet f32 checks: ``resnet50_v1`` f32, B=2, 224x224, on the card
    (16 fused launches of the FMA design, no TF32) against the CPU (the
    plain version);
    ``resnet18_v1`` thumbnail, one f32 SGD-momentum step on the card
    against the CPU;
11. the ResNet inference slice: ``resnet50_v1`` bf16, 224x224, B=128 and
    B=4, 16 fused launches of the tensor-core design a forward, eagerly
    and hybridized (graph replays against the eager logits); the weights
    through a ``.params`` file and ``pretrained=True`` from it, the same
    forward;
12. the ResNet training slice: ``resnet50_v1`` bf16, B=128, 224x224,
    SGD (lr 0.1, momentum 0.9) and ``SoftmaxCrossEntropyLoss`` (bench.py's
    protocol, eager): one warm-up step and three timed steps on one batch,
    no fused conv launch (BatchNorm normalizes by the batch), one
    multi-tensor update launch a step;
12b. ``FusedTrainStep(net, trainer, forward_loss, steps_per_execution=8,
    batch_size=128)`` on phase 12's net and batch at lr 0.01: 8 falling
    losses against 8 eager steps, then ms a step and images/s of 8
    replays;
13. BERT checks: ``bert_base`` widths at 2 layers, f32, B=4, T=128,
    weights from a seed on the CPU: the unmasked forward through the
    flash kernel's FMA design and the ``valid_length`` forward through
    the masked route (no flash launch), each against the CPU; one MLM
    loss, backward and Adam step against the CPU; amp's bf16 forward
    (the tensor-core kernel) against the f32 route on the same weights;
13b. the BERT training slice: ``bert_base`` at full width and depth
    (12 layers, vocab 30522, 133.5 M parameters), B=64, T=128,
    ``bench.py``'s protocol (``amp.init("bfloat16")``,
    ``hybridize(static_alloc=True)``, Adam lr 1e-4, MLM loss, dropout
    0.1): one warm-up and three timed eager steps, 12 tensor-core
    launches of each flash kernel and one update launch a step, split
    into forward, backward and update beside the reckoned bound; then
    ``FusedTrainStep`` with K=8: ms a step, samples/s, graph pool, peak;
14. ResNet-50 bf16 through ``InferenceServer`` (hybridized, max_batch
    32, one length bucket at 224): 64 requests from 8 client threads in
    three waves, each reply against its solo forward, 16 fused launches a
    batch forward from the graphs, signatures within the ceiling;
    images/s, p50/p99 latency, batches;
14b. a BERT-base classifier (bf16, hybridized) through
    ``InferenceServer`` as a callable that builds ``valid_length`` from
    the padded ids: 64 requests of 16-128 tokens, three waves, each
    reply against its solo forward, no flash launch (the masked route);
    requests/s, p50/p99 latency;
15. zoo f32 checks: ``alexnet``, ``vgg16_bn``, ``squeezenet1.1``,
    ``densenet121``, ``inceptionv3`` (299x299), ``mobilenet1.0`` and
    ``mobilenetv2_1.0`` at full width in f32, B=2, weights from the seed
    on the CPU: the card's forward against the CPU's within 1e-3 of the
    largest logit, the fused kernel's FMA design launched 58, 40 and 13
    times in the three nets that fuse;
15b. the zoo inference slice: ``mobilenet1.0`` and ``densenet121`` at
    224x224 and ``inceptionv3`` at 299x299, bf16, B=128, eagerly and
    hybridized (replays against the eager logits): exactly 13, 58 and 40
    tensor-core launches of the fused kernel a forward, images/s, and
    the fused path's NCHW -> (M, K) copies (count and time, from a probe
    forward before the counted path);
15c. the zoo training slice: ``inceptionv3`` at full width, 299x299,
    bf16, B=128, ``SoftmaxCrossEntropyLoss``, ``gluon.Trainer`` with
    RMSProp (decay 0.9, epsilon 1.0, clip 2.0, lr 0.045), ``Accuracy``
    and ``TopKAccuracy(5)`` each step and ``Speedometer``: eight eager
    steps, then ``FusedTrainStep`` K=8 on a fresh net (the optimizer's
    own rule in the graph: no multi-tensor launch) against them, both
    falling; ms a step, images/s, graph pool, peak memory;
16. the image lane: 1,280 ImageNet-style JPEGs (quality 95, short side
    256, smooth random textures, label i % 1000) in ``train.rec``, the
    same records in four ``part*.rec`` shards, and 256 in ``val.rec``,
    written by ``recordio.pack_img``; the native library built by g++.
    ``io.ImageRecordIter`` (``rand_crop``, ``rand_mirror``, mean/std,
    one decode thread a host core) on the native reader against the
    Python reader (the same batches, bit for bit, on the card) and
    images/s of each; ``DataLoader(ImageRecordDataset(...)
    .transform_first(...), pin_memory=True)`` images/s with thread and
    process workers; ``resnet50_v1`` bf16 B=128 trained eagerly (lr 0.1)
    on a resident batch, from ``ImageRecordIter``, from the
    ``DataLoader`` and from ``ShardedRecordReader`` →
    ``StreamingLoader`` → ``DevicePrefetcher`` (its first batch equal to
    the host batch of the same draw; rows with other decode thread
    counts and a shorter switch interval), and as
    ``FusedTrainStep`` K=8 (lr 0.01) on a resident batch, on 8 new
    batches a call from ``ImageRecordIter`` and from the prefetcher: ms a
    step, images/s, each feed over the resident step, the prefetcher's
    waits and depth; then a hybridized eval pass over ``val.rec``
    (center crops): 16 tensor-core launches of the fused kernel a
    forward;
17. the packed-LLM lane: 512 token documents (lengths log-uniform over
    32-2048) in four ``.rec`` shards → ``ShardedRecordReader`` (8 a
    step) → ``StreamingLoader(packer=SequencePacker(1, 2048))`` →
    ``DevicePrefetcher`` → ``llama3_8b`` at 16 layers, bf16,
    ``net(tokens, segment_ids)`` (the dense segment-masked route: no
    flash launch) → ``packed_lm_loss`` → ``Trainer.step``: two warm-up
    and three timed steps split into forward, backward and update,
    tokens/s, packing efficiency, peak memory, the first batch against
    the host packing of its draw; then two sample-mode steps on the same
    documents (cut or padded to 2048, no segment ids: the flash kernels,
    16 tensor-core launches each a step) beside them;
18a. an NCCL group of one (``parallel.initialize`` on 127.0.0.1, a free
    port) and a ``{'dp': 1, 'tp': 1}`` mesh on the card: backend
    ``nccl``; ``all_sum``, ``KVStore.broadcast`` and the store's
    ``allreduce_grads`` return their inputs exactly;
18b. phase 9's net, seed and batch through ``Trainer(...,
    kvstore="dist_sync", partition_rules=LLAMA_RULES, mesh=...)`` (every
    parameter a DTensor, the kernels on each rank's local pieces): the
    losses step for step against phase 9's, #1-#3 launched as often a
    step, step ms, ``allreduce_grads`` ms and peak memory beside phase
    9's;
18c. ``llama3_8b``'s attention (B1·H32·T2048·D128, causal, bf16) cut
    into 4 sequence chunks: the ring and Ulysses bodies for each virtual
    rank over a local transport, forward and backward against one flash
    call; Ulysses launches #1-#3 once a virtual rank;
18d. ``resnet50_v1`` bf16 B=128 steps through ``Trainer(kvstore=
    "dist_sync")`` beside the ``device`` store's (losses equal, step
    times side by side), and ``SyncBatchNorm`` on the group against
    ``BatchNorm`` on the card;
19a. the pipeline: phase 9's net and optimizer, B=4 as 4 microbatches
    of 1 over 4 stages of 4 layers (``mesh={'pp': 4}``, every stage on
    the card): GPipe's forward against the plain one, the 1F1B step's
    loss and every gradient against the plain route's accumulated over
    the same microbatches, three ``Trainer`` steps of each route from
    the same weights, ms, tokens/s and peak beside phase 9's, and
    112/64/64 launches of #1-#3 a 1F1B step; the gradients parameter by
    parameter also against a plain route that ends in the 1F1B step's
    own loss (RMSNorm in f32 cast back to bf16, the head, log-softmax in
    f32), within 5e-3;
19b. graphs over a mesh: 18b's step under ``FusedTrainStep`` (K=4; the
    store's all-reduce in the graph) against 18b's losses and beside its
    eager step and the plain route's captured step; ResNet-50 bf16
    B=128 through ``dist_sync`` under ``FusedTrainStep`` K=8 beside 12b;
    a hybridized 2-layer block placed on the mesh, its replay against
    the eager logits;
19c. phase 8b's serving on ``GenerativeServer(mesh={'dp': 1, 'tp':
    1})``: TTFT and tick beside 8b's, and the replies of both servers,
    one prompt a prefill, equal;
19d. ``save_checkpoint(sharded=True)`` of 7d's configuration on the
    mesh with its trainer and ``resume`` into a fresh net: bit for bit,
    the next loss equal, seconds beside 7d's ``.params`` route; and
    ``drain_consensus()`` on the NCCL group of one;
20a. ``mixtral_8x7b`` widths at 1 layer in f32, B=1, T=256: logits on
    the card (#1's FMA design) against the same weights on the CPU (the
    plain versions), within 1e-3 of the largest logit; then layer 0's
    ``MoEMLP`` in bf16 at full width on the card against the CPU's f32
    run on the same bf16 values (relative norm 2e-2, aux within 1e-5);
20b. the Mixtral serving path: ``mixtral_8x7b`` at full width and 16
    layers in bf16 (23.22 B parameters; 32 layers need 93 GB): one
    warm-up and three prompt forwards at B=1, T=2048 (16 tensor-core
    launches of #1 each), ms beside the reckoned bound and peak memory;
    greedy ``generate`` of 8 tokens from a 128-token prompt on the
    oracle route, twice: ms a token, the two runs' tokens equal;
20c. Mixtral training: full width, 2 layers, bf16, B=1, T=2048, phase
    9's optimizer; ``with collect_aux()``: loss + 0.01·Σaux →
    ``backward`` → ``Trainer.step``, 2/2/2 launches of #1-#3 and one
    update launch a step, ms and peak; the same net without aux under
    ``FusedTrainStep`` (K=3) against three eager steps (1e-5 relative),
    and ``collect_aux`` inside the capture raises;
20d. the mesh and the store: 20c's steps through ``Trainer(kvstore=
    "dist_sync", partition_rules=MIXTRAL_RULES, mesh={'ep': 1})`` on the
    NCCL group of one, the losses against 20c's; the ep body over 4
    virtual ranks of 2 experts each (full width, bf16, T=2048), summed,
    against the unsharded layer; ``resnet18_v1`` f32 B=32, three steps
    through ``Trainer(kvstore=AsyncPSKVStore(...))`` against a
    ``dist_async`` server on 127.0.0.1 with a per-run secret, in lockstep
    with the ``device`` store on the same gradients: the losses and
    weights against the ``device`` store's and push+pull ms a step;
21a. the int8 ops (``ops/quantization.py``) on the card against the CPU
    route on the same inputs, int32 outputs equal: FC at K = 147 and at
    M <= 16, the uint8 FC path at its range row, int8 convs with stride,
    padding and dilation; the int8 product alone at ResNet-50's
    3x3x512 reduction, exact, with its time;
21b. ``contrib.quantization.quantize_net`` on ``resnet50_v1`` (f32
    weights from the seed, 224x224), calibrated on two batches of 128:
    the int8 forward at B=128 eagerly and hybridized (images/s, peak,
    the bound), top-1 agreement with the f32 net, no launch of #4; the
    card against the CPU at B=4;
21c. 21b's weights through ``InferenceServer(ServerConfig(int8=True,
    calib_data=...))`` with phase 14's traffic, beside phase 14;
21d. ``GenerativeServer(ServerConfig(int8=True))`` on phase 8's net
    (``llama3_8b``, 32 layers) with 8b's traffic: tick ms, tokens/s and
    peak beside 8b's, tokens equal to 8b's counted;
22a. ``nd.RNN`` in every mode, 2 layers, both directions, states in and
    out: outputs and gradients on the card against the CPU; an
    ``LSTMCell``'s ``unroll`` against the fused ``LSTM``;
22b. the LSTM word language model at the upstream Gluon example's
    widths (650, 2 layers, tied, bptt 35, batch 32, 33,278 words):
    eager steps with ``clip_global_norm`` and ``FusedTrainStep`` steps,
    step ms, tokens/s, launches a step and the bound, beside cuDNN's
    LSTM at the same shape;
22c. ``examples/train_ctc_ocr.py``'s BiLSTM + ``CTCLoss`` net at its
    shapes: eager and ``FusedTrainStep`` steps; ``ctc_loss`` on the card
    against the CPU and ``F.ctc_loss``, an infeasible label's ~1e30.

23a. the detection ops (``nd.contrib``) on the card against the CPU at
    the detectors' shapes: ``box_nms`` (SSD-512's 32 x 1,364 rows,
    class-aware, topk 400, exact), ``Proposal`` (Faster R-CNN's RPN map
    at 600x1000), ``ROIAlign`` forward and backward, ``MultiBoxTarget``,
    ``bipartite_matching``, ``BilinearResize2D``, deformable
    convolution, the control-flow ops eager and inside a CUDA graph;
    the ``nms_keep`` bitmask scan against its plain version bit for bit
    at n = 128 .. 11,200, with its device time, the plain version's, its
    launches a call and the bound (the larger of its bytes and its
    pairs' operations);
23b. ``ssd_512_resnet50_v1`` (20 classes, 512x512): f32 card vs CPU
    (pre-NMS rows; the CPU's NMS of the card's rows equal to the
    card's), bf16 at B=32 and B=1 eager and hybridized (the replay equal
    to the eager forward), 20 launches of #4 and one of ``nms_keep`` a
    forward;
23c. ``faster_rcnn_resnet50_v1`` at 600x1000, f32, B=1, the same (16
    launches of #4, two of ``nms_keep``), the check at 320x480;
23d. ``yolo3_darknet53`` at 416x416, bf16, B=16, the same (no #4, one
    ``nms_keep``), the check at B=2;
23e. SSD-512 bf16 training at B=16 fed by ``image.ImageDetIter`` over a
    ``.rec`` of synthetic JPEGs (crop, mirror), ``MultiBoxTarget`` with
    negative mining: eager steps, ``FusedTrainStep`` against them, and
    fed steps with the iterator's wait;
24a. the sparse ops at the factorization machine's width on the card
    against the CPU: every ``cast_storage`` pair, the union and
    intersection merges, ``retain``, and the CSR product (1,000 x
    1,000,000 with 39 nonzeros a row, times the 1,000,000 x 16 table)
    forward and transposed, each product's ms beside ``torch.sparse.mm``
    (cuSPARSE, a yardstick) and its bytes bound; and the product's kernel
    (``csrc/csr_dense_dot.cu``) at that shape in both directions, 20
    launches each bit-equal to its plain version on CPU copies, with its
    time, the plain version's on the card and the library's;
24b. the slice's main path: ``FMModel(1_000_000, 16)`` with a local store
    running Adam (the lazy row updates), fed by ``LibSVMIter(batch_size=
    1000)`` over a Criteo-shaped file of 64,000 rows written from the
    seed: 64 steps, the untouched rows of the tables and of Adam's state
    bit-equal after each, the loss falling, step 1 against the CPU and
    again on the card from the same state, bit-identical; the step split
    into iterator, forward, push+update and pull, samples/s, peak memory;
24c. ``examples/sparse_linear_classification.py``'s loop at its defaults,
    written against the port: the loss falls, the accuracy beats 0.5;
24d. 10 FM steps through ``local``, a one-rank NCCL ``dist_sync`` and
    ``dist_async`` over loopback TCP to a server process on the card, in
    lockstep: the tables equal, push+pull ms;
24e. ``mx.profiler`` with a ``torch.profiler`` device trace over one FM
    step and one ResNet-50 bf16 B=128 forward: device time split between
    the hand-written kernels, cuBLAS/cuDNN and the rest, the host share;
25a. ``resnet50_v1`` built with ``mx.sym`` (``resnet50_symbol``), the
    Gluon net's weights by structural name: the ``simple_bind`` forward
    at f32 B=32 against the Gluon forward, ``Module.fit`` (8 steps of SGD
    with momentum through the update kernel; step ms, images/s, the
    loss falling) and ``BucketingModule`` over a ``sym.RNN`` LSTM at two
    lengths sharing its parameters;
25b. ``resnet50_v1`` bf16 exported on the card (``HybridBlock.export``:
    a ``torch.export`` program whose 16 #4 nodes are custom ops), read
    back by ``SymbolBlock.imports`` and ``Predictor`` (16 launches a
    forward, outputs against the live hybridized block), and 64 requests
    from 8 clients through ``InferenceServer(Predictor)`` beside phase
    14's numbers;
25c. ``bert_base``: ``bert_to_symbol`` → ``Executor`` and
    ``export_bert_onnx`` → ``import_model`` → bind at f32 against
    ``BERTModel``'s forward; the bf16 export at B=64, T=128 (12 #1 nodes,
    12 launches a ``Predictor.forward``) against the live block;
25d. 25a's trained symbol through ``save_checkpoint`` →
    ``load_checkpoint`` → ``Predictor`` (the nnvm replay, a CUDA graph a
    signature), and ``quantize_model`` (naive) of it: the int8 graph on
    the card, and at B=2 against the CPU (int32 products equal);
26a. ``Estimator.fit`` on a ``bert_base`` classifier (2 classes) in np
    mode, amp bf16, Adam, B=32, T=128, 8 batches and 2 validation
    batches (#1 12 × 10 launches, #2 and #3 12 × 8, the update 8), with
    ``evaluate`` against a hand-written loop, the checkpoint's bit-equal
    reload, fit's ms a batch against a hand-written step loop and a
    device-trace split of one batch;
26b. every name of the ``mx.np`` table on the card against the CPU
    (elementwise, reductions and products at (4096, 4096), the sorts,
    statistics, index and shape families at (1024, 1024)),
    ``np.random``'s moments and ``np.linalg``'s reconstructions at
    (1024, 1024);
26c. ``nd.Custom`` eager, recorded and in a hybridized block on two
    inputs (eager every call, no stale replay), a capture that reaches it
    refused, and ``rtc.PallasKernel`` with its gradient;
26d. ``Monitor`` on an eager ResNet-50 bf16 B=32 forward (#4 launching
    16 times), ``runtime.Features()``, ``check_consistency([cpu, gpu])``
    on a BERT-base layer, ``visualization.print_summary``;
27a-27d. training telemetry: the Llama step's records, numerics taps and
    retrace sanitizer, ``Monitor`` inside a CUDA graph, memwatch, one
    timeline;
28a. phase 8b's server under full observability (tracing, capacity,
    the numerics taps inside the graphed tick, retrace, ``/metrics``, SLO
    goodput), an overloaded server's one flight dump, and a device-trace
    split of one graphed tick (run right after 19c, on phase 8's net);
28b. ``InferenceServer`` on BERT-base (#1) and ResNet-50 (#4) with
    observability off and on;
28c. the fleet watchdog on 27a's Llama training step on a one-rank NCCL
    group (the exchange, a retrace incident, NaN at layer 1 and its dump);
28d. 28a's first wave under the lock sanitizer;
29a. the memory planner on the card: a params-dominated MLP (8 x
    Dense(8192), f32) trained with Adam and with SGD + momentum, the
    plan's peak within 10% of memwatch's live bytes and of the
    allocator's; the budget is the card's memory; ``plan_kv_pool`` equals
    8b's engine's pool;
29b. the remat ladder on the training slice's configuration
    (``llama3_8b(scan_layers=True)``, 16 layers, f32, B=1, T=2048, SGD):
    three steps at each of "none", "dots" and "layer" from the same
    weights, the losses bit-equal across the tiers; each tier's step ms,
    peak, the planner's prediction and the launches a step;
29c. ``llama3_8b`` at all 32 layers, f32, ``set_remat("layer")``: two
    training steps through #1-#3, the peak against the planner's
    prediction, and "auto"'s pick with and without a measured hint;
29d. host offload: ``llama3_8b`` bf16 with SGD + momentum and f32
    masters, remat "layer": the deepest depth the host can pin (32
    layers wanted), then ``Trainer(offload="host")`` against the
    on-device trainer at 8 layers (weights bit-equal every step);
30a. graphed recorded forwards: BERT-base (amp bf16, B=64, T=128),
    ``llama3_8b`` at 4 layers and ResNet-50 (bf16, B=128) trained
    through ``hybridize()`` + ``record()`` against the same loop
    unhybridized from one state, ResNet-50 called twice before its
    backward, and a Dropout's fresh masks in the replays;
30b. the serving programs as graphs on phase 8's net: prefill buckets
    and verify timed eager and graphed, and five serving modes' tokens
    equal between the two; the paged, radix and int8 servers capture
    their whole bucket table when built, and the engines' graph memory
    (one pool and two arenas) is summed over it;
30c. the detectors exported (23b-23d's weights) and their programs run
    on the card bit-equal to the live blocks;
30d. ``Trainer(offload="host")`` over a one-rank NCCL mesh, 8 layers,
    bit-equal to the on-device mesh trainer;
30e. SSD-512's B=1 forward, the word-LM step and the FM step under
    ``engine.bulk(16)``, bit-equal to the same loops unbulked.

One card holds one rank: the card runs the NCCL route at world size 1;
multi-rank behaviour is held on the CPU in gloo groups
(``tests/test_torch_{parallel,partition,ring,kvstore_dist,
llama_parallel}.py``).

The launch counters are set to 0 just before each slice (8, 8b, 9, 11,
13b, 14, 14b, each net of 15b, the eval pass of 16, the sample-mode
steps of 17, 18b, 18c's Ulysses bodies, 19a's 1F1B steps, 19b's
captured mesh steps, 20b, 20c's eager steps, 20d's ep-route steps, 21b's
int8 forwards (#4 must launch 0 times there), each detector's forwards
of 23b-23d (#4 and ``nms_keep``), the served exported program of 25b,
the exported program's forwards of 25c, 26a's ``fit`` and 26d's
monitored forward; the update's in 9, 12, 12b, 13b, 16, 17, 18b, 18d,
19a, 19b, 20c, 22b, 22c, 23e, 25a and 26a, and in 24b, where it
must stay 0: the lazy row updates are not the update kernel's; the CSR
product's, forward and transposed, over 24b-24e; #1-#3's and the
update's in each step of 29b-29d; #1-#3's over 30a and 30d, the update's
over 30d, ``nms_keep``'s through 30c's programs and #4's and
``nms_keep``'s over 30e) and read just after,
and at the start of each check that counts them (6, 7, 7b, 13); the
bf16 slices must launch the tensor-core designs
(``launches_mma``), the f32 checks the FMA designs.  It exits non-zero on any failed check, and with no
result line when there is no CUDA card or the package is not beside it.
Its last line is ``{"ok": true, "device": {...}}``.
"""
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_BYTES = 3.35e12
# (name, B, H, Tq, Tk, D, causal, dtype); shapes that reach the edges of
# the tensor-core design: every D in bf16 and f16, ragged T, Tq < Tk
# (bottom-right alignment) and Tq > Tk (rows that see no key)
MMA_SHAPES = [
    ("d16_bf16", 2, 4, 200, 200, 16, True, "bfloat16"),
    ("d32_bf16", 2, 4, 333, 333, 32, True, "bfloat16"),
    ("d64_bf16", 2, 8, 512, 512, 64, False, "bfloat16"),
    ("d16_f16", 2, 4, 200, 200, 16, True, "float16"),
    ("d32_f16", 2, 4, 333, 333, 32, True, "float16"),
    ("d64_f16", 2, 8, 512, 512, 64, False, "float16"),
    ("bottom_right_bf16", 1, 8, 300, 700, 128, True, "bfloat16"),
    ("masked_rows_bf16", 1, 8, 700, 300, 128, True, "bfloat16"),
]
# the first is the Llama slice's shape, the second BERT-base's attention
# (phase 13b)
KERNEL_SHAPES = [
    ("slice", 1, 32, 2048, 2048, 128, True, "bfloat16"),
    ("bert", 64, 12, 128, 128, 64, False, "bfloat16"),
    ("ragged", 2, 32, 1000, 1000, 128, True, "bfloat16"),
    ("noncausal_f32", 2, 4, 256, 256, 64, False, "float32"),
    ("bottom_right", 1, 2, 4, 6, 32, True, "float32"),
    ("d16", 2, 4, 128, 128, 16, True, "float32"),
] + MMA_SHAPES
# f32: another summation order than the plain version; bf16: the kernel's
# output is rounded to 8 mantissa bits; lse is f32 in both
O_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}
LSE_TOL = 1e-3
# O is also held row by row, as the gradients are (``grad_errors``): each
# row's largest error within O_ROW_TOL of the row's largest reference
# value, so that the small outputs of late causal rows (|O| about 0.03 at
# T = 2048) are held as tightly as the large early ones; and the whole
# tensor by ||O - O_ref|| / ||O_ref|| <= O_NORM_TOL.  bf16/f16 (unit
# roundoff u = 2^-8 / 2^-11): the tensor-core kernel rounds P before P·V,
# which moves each term of a row's sum by at most u of itself, and rounds
# O, which moves each value by at most u: 2u.  f32: another summation
# order, as for the gradients
O_ROW_TOL = {"float32": 1e-4, "bfloat16": 2 * 2.0 ** -8,
             "float16": 2 * 2.0 ** -11}
O_NORM_TOL = {"float32": 1e-5, "bfloat16": 2 * 2.0 ** -8,
              "float16": 2 * 2.0 ** -11}
# (name, B, H, Tq, Tk, D, causal, dtype); the first is the Llama training
# slice's shape, the second BERT-base's
BWD_SHAPES = [
    ("slice", 1, 32, 2048, 2048, 128, True, "bfloat16"),
    ("bert", 64, 12, 128, 128, 64, False, "bfloat16"),
    ("ragged", 2, 32, 1000, 1000, 128, True, "bfloat16"),
    ("noncausal_f32", 2, 4, 256, 256, 64, False, "float32"),
    ("bottom_right", 1, 2, 4, 6, 32, True, "float32"),
    ("masked_rows", 1, 2, 6, 4, 32, True, "float32"),
    ("d16", 2, 4, 128, 128, 16, True, "float32"),
] + MMA_SHAPES
# Each gradient is held row by row (a row: one query's dq, one key's dk
# or dv): the row's largest error within ROW_TOL of the row's largest
# reference value, so that the small late rows of a causal gradient are
# held as tightly as the large early ones; and the whole tensor by
# ||g - r|| / ||r|| <= NORM_TOL.  f32: another summation order; bf16:
# the kernels' f32 results are rounded to 8 mantissa bits, at most 2^-8
# (3.9e-3) of each value
ROW_TOL = {"float32": 1e-4, "bfloat16": 1e-2, "float16": 2e-3}
NORM_TOL = {"float32": 1e-5, "bfloat16": 5e-3, "float16": 1e-3}
# f32 training check: every gradient within this share of the largest
# gradient of the same tensor; both routes are f32 (no TF32), the
# attention sums run in other orders and the difference propagates
# through two layers and the LM head
TRAIN_GRAD_TOL = 1e-3
# bf16 checks (2 layers): both routes run the same bf16 weights through the
# same bf16 matmuls and differ inside attention only, where each rounds to
# bf16 at other places (the kernels round P before it is normalised and
# keep dP in f32; the dense route rounds the normalised P and, under
# autograd, dP).  A rounding moves a value by at most u = 2^-8 of itself,
# so a layer's attention output differs by about u in relative norm; two
# layers carry that to the logits with little gain: logits by relative
# norm within 2u a layer (4u = 1.6e-2); each gradient, which the backward
# rounds at two more places (dS, dP), within 8u (3.1e-2)
BF16_LOGIT_TOL = 4 * 2.0 ** -8
BF16_GRAD_TOL = 8 * 2.0 ** -8
# the bf16 checks' witness: the same weights cast to f32 (exactly) through
# the dense route in f32 give a reference free of bf16 rounding; each bf16
# route's distance to it (relative norm) is that route's own rounding.
# The kernels' route must be as close to it as the dense route is, within
# this factor, for the logits and for every gradient.  On an H100 the
# ratio read 0.970-0.9994 over three seeds (logits and 21 gradients each;
# both routes 3.3-8.1u from the f32 route, the gap between them at most
# 6.3u: their roundings are largely shared, not independent), so a
# fault that adds 1% of the logits' norm to the kernels' route (ratio
# about 1.2) fails it
BF16_WITNESS_RATIO = 1.1
BF16_SEEDS = (SEED, SEED + 1, SEED + 2)
# the bf16 checks' readings at each seed of BF16_SEEDS when the bf16 dQ ran
# on the f32 FMA design (dS kept in f32; the forward and dK/dV on the
# tensor cores), printed beside this run's: (worst gradient's relative
# norm, worst witness ratio)
FMA_DQ_BF16_READINGS = {SEED: (0.024321584030985832, 0.9992440410578218),
                        SEED + 1: (0.02446492575109005, 0.9993867572421938),
                        SEED + 2: (0.024472074583172798, 0.9961660372186644)}
# the training slice's four losses (the same bits in every run) when its
# bf16 forward, dQ and dK/dV all ran on the f32 FMA designs, and when only
# dQ did, printed beside this run's: the tensor-core designs round P and dS
# to bf16, so they move
FMA_DESIGN_LOSSES = [12.569117546, 10.207187653, 8.730205536, 6.096673965]
FMA_DQ_LOSSES = [12.569450378, 10.208418846, 8.703302383, 6.157677650]
TRAIN_LAYERS = 16
TRAIN_LR = 0.1
REQUESTS = [(1, 100), (4, 512), (1, 1500)]  # (batch, prompt length)
# a bf16 graph replay against the eager forward: the same kernels on the
# same inputs, so the same bits are expected; held within one bf16 step
# (2^-8) of the largest eager value
GRAPH_BF16_TOL = 2.0 ** -8
NEW_TOKENS = 32


def design_name(design, dtype):
    """A kernel design as the ``kernels`` line names it, such as
    ``"mma.sync bf16"``."""
    names = {"mma": "mma.sync", "fma": "FMA"}
    short = {"float32": "f32", "float16": "f16", "bfloat16": "bf16"}
    return f"{names[design]} {short[dtype]}"


_T0 = time.perf_counter()


def emit(obj):
    """Print ``obj`` as one JSON line; a phase's line also carries the
    script's seconds so far (``t_s``)."""
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - _T0, 1))
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            obj["allocated_gb"] = round(torch.cuda.memory_allocated() / 1e9,
                                        2)
    print(json.dumps(obj), flush=True)


def run(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (out.stdout or out.stderr).strip()


def free_card(torch):
    """Release the card memory of the nets an earlier phase dropped: a
    Gluon net holds reference cycles (blocks, decoders), which only the
    cycle collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(torch, fn, iters, hide_host=False):
    """Mean device time of ``fn`` over ``iters`` back-to-back launches,
    after one warm-up call (CUDA events).  ``hide_host``: the window opens
    behind a device-side sleep of 2e8 cycles (about 0.1 s at the H100's
    1.98 GHz), so that the host has enqueued every call before the first
    one runs and the events see device time only (for calls whose host
    time exceeds their device time, such as torch autograd's backward)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters):
    """Host time of one ``fn`` call in us: ``iters`` calls enqueued back
    to back (no synchronisation between them), on the host's clock."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return us


def launch_only_ms(torch, lib_name, symbol, tensors, tail, iters):
    """Device time of a kernel launched through its C entry point alone,
    on the given (preallocated) tensors: no wrapper checks, no
    allocation.  ``tail``: the entry point's int and float arguments
    before the stream."""
    from mxnet_tpu_torch import _kernels

    lib = _kernels.load(lib_name)
    fn = getattr(lib, symbol)
    args = [t.data_ptr() for t in tensors] + list(tail) + \
        [torch.cuda.current_stream().cuda_stream]

    def launch():
        _kernels.check(lib, fn(*args), symbol)

    return time_ms(torch, launch, iters)


def visible_pairs(tq, tk, causal):
    """(query, key) pairs the mask keeps (bottom-right causal)."""
    if causal:
        return sum(min(tk, max(0, i + tk - tq + 1)) for i in range(tq))
    return tq * tk


def roofline_ms(flops, nbytes, dtype):
    """The larger of the operations over the dtype's peak and the bytes
    over the memory rate, in ms, and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


def bound_ms(b, h, tq, tk, d, causal, dtype, itemsize):
    """Least time for the forward on the card: q, k, v read once, O and
    lse written once; 2 products of 2·D flops per visible pair."""
    flops = 4.0 * d * visible_pairs(tq, tk, causal) * b * h
    nbytes = itemsize * b * h * d * (2 * tq + 2 * tk) + 4 * b * h * tq
    return roofline_ms(flops, nbytes, dtype)


def bwd_bound_ms(b, h, tq, tk, d, causal, dtype, itemsize, products,
                 reads_o, writes):
    """Least time for (part of) the backward: q, k, v, dO (and O, for δ)
    read once, lse and δ read once, ``writes`` rows of D values written
    once; ``products`` products of 2·D flops per visible pair."""
    flops = 2.0 * d * products * visible_pairs(tq, tk, causal) * b * h
    rows_read = 2 * tq + 2 * tk + (tq if reads_o else 0)
    nbytes = itemsize * b * h * d * (rows_read + writes) + \
        8 * b * h * tq
    return roofline_ms(flops, nbytes, dtype)


def kernel_phase(torch, fa, failures):
    """Phase 3: the kernel against the plain version at each shape."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = []
    for name, b, h, tq, tk, d, causal, dt in KERNEL_SHAPES:
        dtype = getattr(torch, dt)
        q = torch.randn(b, h, tq, d, generator=gen, device="cuda",
                        dtype=dtype)
        k = torch.randn(b, h, tk, d, generator=gen, device="cuda",
                        dtype=dtype)
        v = torch.randn(b, h, tk, d, generator=gen, device="cuda",
                        dtype=dtype)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        # the plain version's arithmetic is f32 whatever the input dtype;
        # it runs on f32 copies so its own output rounding is not counted
        o_ref, lse_ref = fa._fa_forward_plain(q.float(), k.float(),
                                              v.float(), causal, scale)
        err_o, share_o, norm_o = grad_errors(torch, o, o_ref)
        fin = torch.isfinite(lse_ref)
        fin_same = bool(torch.equal(fin, torch.isfinite(lse)))
        err_lse = (lse - lse_ref)[fin].abs().max().item() if fin.any() \
            else 0.0
        ok = (fin_same and math.isfinite(err_o) and err_o <= O_TOL[dt]
              and share_o <= O_ROW_TOL[dt] and norm_o <= O_NORM_TOL[dt]
              and err_lse <= LSE_TOL and bool(torch.isfinite(o).all()))
        iters = 20 if tq * tk * b * h > 1e7 else 100
        k_ms = time_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, causal, scale), iters)
        p_ms = time_ms(torch, lambda: fa._fa_forward_plain(
            q, k, v, causal, scale), max(iters // 4, 5))
        lib_ms = None
        if tq == tk:  # torch SDPA's is_causal is top-left: equal here only
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_ms = time_ms(torch, lambda: sdpa(q, k, v, is_causal=causal,
                                                 scale=scale), iters,
                             hide_host=True)
        bnd, by = bound_ms(b, h, tq, tk, d, causal, dt, q.element_size())
        flops = 4.0 * d * visible_pairs(tq, tk, causal) * b * h
        row = dict(phase="kernel", shape=name, B=b, H=h, Tq=tq, Tk=tk, D=d,
                   causal=causal, dtype=dt, design=fa._design(dtype),
                   max_abs_err_o=err_o, row_share_o=share_o,
                   rel_norm_o=norm_o,
                   max_abs_err_lse=err_lse, masked_rows_agree=fin_same,
                   tol_o=O_TOL[dt], row_tol_o=O_ROW_TOL[dt],
                   norm_tol_o=O_NORM_TOL[dt], tol_lse=LSE_TOL,
                   kernel_ms=k_ms,
                   tflops=flops / k_ms * 1e-9,
                   plain_ms=p_ms, library_ms=lib_ms, bound_ms=bnd,
                   bound_by=by, ok=ok)
        if not rows:  # the slice shape: the wrapper's own cost
            row["wrapper_host_us"] = host_us(torch, lambda: (
                fa.flash_attention_fwd(q, k, v, causal, scale)), iters)
            row["launch_only_ms"] = launch_only_ms(
                torch, "flash_attention_fwd",
                f"mxt_flash_attention_fwd_{fa._design(dtype)}",
                (q, k, v, o, lse), (b * h, tq, tk, d, fa._DTYPE_CODES[dtype],
                                    int(causal), scale), iters)
        emit(row)
        rows.append(row)
        if not ok:
            failures.append(f"kernel {name}: O err {err_o} (row share "
                            f"{share_o}, norm {norm_o}), lse err "
                            f"{err_lse}, masked rows agree {fin_same}")
    return rows


def dq_zero_row(causal, tq, tk):
    """The query that sees key 0 alone (causal, Tq >= Tk): there P = 1 and
    O = V_0, so dP - δ cancels and its dq is 0 in exact arithmetic; the
    kernel's and the plain version's are rounding noise of f32 sums taken
    in other orders."""
    return tq - tk if causal and tq >= tk else None


def grad_errors(torch, g, r, zero_row=None):
    """(max abs error, worst row share, relative norm) of a kernel's
    result ``g`` (an attention output or a gradient) against its f32
    reference ``r``; a row's share is its largest error
    over its largest reference value, or over ``g``'s dtype's smallest
    normal number where that is larger (f16 rounds smaller values to a
    fixed step; for bf16 and f32 a zero row must match exactly), as
    ``tests/test_torch_kernels_cuda.py`` holds it.  ``zero_row``
    (``dq_zero_row``) is shared over the tensor's largest reference
    value instead of its own."""
    diff = (g.float() - r).abs()
    floor = torch.finfo(g.dtype).tiny
    row_err, row_ref = diff.amax(-1), r.abs().amax(-1).clamp_min(floor)
    if zero_row is not None:
        row_ref[..., zero_row] = r.abs().max()
    share = row_err / row_ref
    norm = (torch.linalg.vector_norm(g.float() - r) /
            torch.linalg.vector_norm(r).clamp_min(1e-30))
    return diff.max().item(), share.max().item(), norm.item()


def backward_phase(torch, fa, failures):
    """Phase 4: ``flash_attention_bwd`` (δ, then the dQ and dK/dV kernels)
    against the plain backward at each shape (the plain version on f32
    copies of the same inputs and the kernel forward's O and lse); then
    each kernel and δ timed alone."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    rows = []
    for name, b, h, tq, tk, d, causal, dt in BWD_SHAPES:
        dtype = getattr(torch, dt)

        def rnd(t):
            return torch.randn(b, h, t, d, generator=gen, device="cuda",
                               dtype=dtype)

        q, k, v, do = rnd(tq), rnd(tk), rnd(tk), rnd(tq)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal, scale)
        torch.cuda.synchronize()
        ref = fa._fa_backward_plain(q.float(), k.float(), v.float(),
                                    o.float(), do.float(), lse, causal,
                                    scale)
        row = dict(phase="backward_kernels", shape=name, B=b, H=h, Tq=tq,
                   Tk=tk, D=d, causal=causal, dtype=dt,
                   row_tol=ROW_TOL[dt], norm_tol=NORM_TOL[dt])
        ok = True
        zero_rows = (dq_zero_row(causal, tq, tk), None, None)
        for key, g, r, zero_row in zip(("dq", "dk", "dv"), got, ref,
                                       zero_rows):
            err, share, norm = grad_errors(torch, g, r, zero_row)
            row[f"max_abs_err_{key}"] = err
            row[f"row_share_{key}"], row[f"rel_norm_{key}"] = share, norm
            ok = ok and share <= ROW_TOL[dt] and norm <= NORM_TOL[dt] and \
                bool(torch.isfinite(g).all())
        masked = tq - tk if causal and tq > tk else 0
        if masked:  # rows that see no key: dq exactly 0
            row["masked_rows_dq_zero"] = bool(
                (got[0][:, :, :masked] == 0).all())
            ok = ok and row["masked_rows_dq_zero"]
        delta = fa._delta(o, do)
        iters = 10 if tq * tk * b * h > 1e7 else 50
        row["delta_ms"] = time_ms(torch, lambda: fa._delta(o, do), iters)
        row["dq_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, causal, scale), iters)
        row["dkv_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, causal, scale), iters)
        row["plain_ms"] = time_ms(torch, lambda: fa._fa_backward_plain(
            q, k, v, o, do, lse, causal, scale), max(iters // 4, 3))
        row["library_ms"] = None
        if tq == tk:  # torch SDPA's is_causal is top-left: equal here only
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

            # its backward alone (all three gradients), on one retained
            # graph
            out = sdpa(qr, kr, vr, is_causal=causal, scale=scale)
            row["library_ms"] = time_ms(
                torch, lambda: torch.autograd.grad(out, (qr, kr, vr), do,
                                                   retain_graph=True),
                iters, hide_host=True)
            del out
        shape = (b, h, tq, tk, d, causal, dt, q.element_size())
        row["bound_ms"], row["bound_by"] = bwd_bound_ms(
            *shape, products=5, reads_o=True, writes=tq + 2 * tk)
        row["dq_bound_ms"], row["dq_bound_by"] = bwd_bound_ms(
            *shape, products=3, reads_o=False, writes=tq)
        row["dkv_bound_ms"], row["dkv_bound_by"] = bwd_bound_ms(
            *shape, products=4, reads_o=False, writes=2 * tk)
        pairs = visible_pairs(tq, tk, causal) * b * h
        design = fa._design(dtype)
        row["dq_design"] = row["dkv_design"] = design
        row["dkv_tflops"] = 8.0 * d * pairs / row["dkv_ms"] * 1e-9
        row["dq_tflops"] = 6.0 * d * pairs / row["dq_ms"] * 1e-9
        if not rows:  # the slice shape: the wrappers' own cost
            tail = (b * h, tq, tk, d, fa._DTYPE_CODES[dtype], int(causal),
                    scale)
            row["dq_wrapper_host_us"] = host_us(
                torch, lambda: fa.flash_attention_bwd_dq(
                    q, k, v, do, lse, delta, causal, scale), iters)
            row["dq_launch_only_ms"] = launch_only_ms(
                torch, "flash_attention_bwd",
                f"mxt_flash_attention_bwd_dq_{design}",
                (q, k, v, do, lse, delta, torch.empty_like(q)), tail, iters)
            row["dkv_wrapper_host_us"] = host_us(
                torch, lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, do, lse, delta, causal, scale), iters)
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            row["dkv_launch_only_ms"] = launch_only_ms(
                torch, "flash_attention_bwd",
                f"mxt_flash_attention_bwd_dkv_{design}",
                (q, k, v, do, lse, delta, dk, dv), tail, iters)
        row["ok"] = ok
        emit(row)
        rows.append(row)
        if not ok:
            failures.append(f"backward kernels {name}: {row}")
    return rows


def _lm_forward(mx, net, ids, labels):
    """Recorded forward and token cross entropy (summed, / tokens)."""
    vocab = net.config.vocab_size
    with mx.autograd.record():
        return mx.nd.softmax_cross_entropy(
            net(ids).reshape((-1, vocab)), labels.reshape((-1,))) / \
            labels.size


def _lm_loss(mx, net, ids, labels):
    """Forward, loss and backward; returns the loss as a float."""
    loss = _lm_forward(mx, net, ids, labels)
    loss.backward()
    return float(loss.asscalar())


def _counters(fa):
    return (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv)


def _mma_counts(fa):
    """Launches of the tensor-core designs: (forward, dQ, dK/dV); the f32
    FMA designs' are the rest of each kernel's ``.launches``."""
    return [c.launches_mma for c in _counters(fa)]


def _zero_counts(fa):
    """Every launch count of the flash kernels (total and per design)."""
    for c in _counters(fa):
        for key in [a for a in vars(c) if a.startswith("launches")]:
            setattr(c, key, 0)


def _rel_norm(torch, a, b):
    """||a - b|| / ||b|| in f32."""
    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm(a - b) /
            torch.linalg.vector_norm(b).clamp_min(1e-30)).item()


def _ids_labels(torch, mx, vocab, t, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = torch.randint(0, vocab, (1, t + 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    return mx.nd.array(tokens[:, :-1]), mx.nd.array(tokens[:, 1:])


def f32_train_phase(torch, mx, llama, fa, failures):
    """Phase 7: full width, 2 layers, f32, T=1024: one loss and backward
    through the kernels (flash) and through dense torch autograd (sdpa),
    same weights and batch; the loss and every gradient compared."""
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=2)
    net.initialize(ctx=mx.gpu(0))
    ids, labels = _ids_labels(torch, mx, net.config.vocab_size, 1024,
                              SEED + 4)
    params = net._collect_params_with_prefix()
    _zero_counts(fa)
    loss_flash = _lm_loss(mx, net, ids, labels)
    grads = {k: p.grad()._data.clone() for k, p in params.items()}
    net.config.attn_mode = "sdpa"
    loss_sdpa = _lm_loss(mx, net, ids, labels)
    launched = [c.launches for c in _counters(fa)]  # the FMA designs'
    mma = _mma_counts(fa)
    worst, worst_name = 0.0, None
    for k, p in params.items():
        ref = p.grad()._data
        share = ((grads[k] - ref).abs().max() /
                 ref.abs().max().clamp_min(1e-30)).item()
        if not share <= worst:
            worst, worst_name = share, k
    ok = launched == [2, 2, 2] and mma == [0, 0, 0] and \
        math.isfinite(loss_flash) and \
        abs(loss_flash - loss_sdpa) <= 1e-5 * abs(loss_sdpa) and \
        worst <= TRAIN_GRAD_TOL
    emit(dict(phase="f32_train_check", layers=2, T=1024,
              launches=dict(zip(("fwd", "dq", "dkv"), launched)),
              launches_mma=dict(zip(("fwd", "dq", "dkv"), mma)),
              loss_flash=loss_flash, loss_sdpa=loss_sdpa,
              params=len(params), worst_grad_err_share=worst,
              worst_param=worst_name, tol=TRAIN_GRAD_TOL, ok=ok))
    if not ok:
        failures.append(f"f32 training check: launches {launched} "
                        f"(tensor-core {mma}), loss "
                        f"{loss_flash} vs {loss_sdpa}, worst gradient "
                        f"{worst} ({worst_name})")
    del net, grads, params
    free_card(torch)


def _route(torch, mx, net, ids, labels, params, mode):
    """``net(ids)`` and one loss and backward through ``attn_mode=mode``:
    (logits, loss, {name: gradient})."""
    net.config.attn_mode = mode
    logits = net(ids)._data
    loss = _lm_loss(mx, net, ids, labels)
    return logits, loss, {k: p.grad()._data.clone()
                          for k, p in params.items()}


def bf16_phase(torch, mx, llama, fa, failures):
    """Phase 7b: full width, 2 layers, bf16, T=1024, at each seed of
    ``BF16_SEEDS``: ``net(ids)`` and one loss and backward through the
    tensor-core kernels, against the dense route (``attn_mode="sdpa"``)
    on the same weights, logits and every gradient held by relative norm;
    then the witness, both routes against the dense route in f32 on the
    same weights."""
    for seed in BF16_SEEDS:
        mx.random.seed(seed)
        net = llama.llama3_8b(num_layers=2)
        net.cast("bfloat16")
        net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
        ids, labels = _ids_labels(torch, mx, net.config.vocab_size, 1024,
                                  seed + 12)
        params = net._collect_params_with_prefix()
        _zero_counts(fa)
        flash = _route(torch, mx, net, ids, labels, params, "flash")
        launched = [c.launches for c in _counters(fa)] + _mma_counts(fa)
        dense = _route(torch, mx, net, ids, labels, params, "sdpa")
        net.cast("float32")
        ref = _route(torch, mx, net, ids, labels, params, "sdpa")
        launched_dense = [c.launches for c in _counters(fa)] + \
            _mma_counts(fa)
        # relative norms: kernels vs dense, kernels vs f32, dense vs f32
        gap = {"logits": _rel_norm(torch, flash[0], dense[0])}
        to_ref = {"logits": (_rel_norm(torch, flash[0], ref[0]),
                             _rel_norm(torch, dense[0], ref[0]))}
        for k in params:
            gap[k] = _rel_norm(torch, flash[2][k], dense[2][k])
            to_ref[k] = (_rel_norm(torch, flash[2][k], ref[2][k]),
                         _rel_norm(torch, dense[2][k], ref[2][k]))
        ratio = {k: f / max(d, 1e-30) for k, (f, d) in to_ref.items()}
        worst = max(params, key=gap.get)
        worst_ratio = max(ratio, key=ratio.get)
        loss_flash, loss_sdpa = flash[1], dense[1]
        # 4 forward launches (net(ids), then the loss), 2 dQ, 2 dK/dV, all
        # tensor-core; the dense and f32 routes launch none
        ok = launched == [4, 2, 2, 4, 2, 2] and launched_dense == launched \
            and math.isfinite(loss_flash) and \
            gap["logits"] <= BF16_LOGIT_TOL and \
            abs(loss_flash - loss_sdpa) <= BF16_LOGIT_TOL * abs(loss_sdpa) \
            and gap[worst] <= BF16_GRAD_TOL and \
            ratio[worst_ratio] <= BF16_WITNESS_RATIO
        fma_dq = FMA_DQ_BF16_READINGS.get(seed, (None, None))
        emit(dict(phase="bf16_check", seed=seed, layers=2, T=1024,
                  launches=dict(zip(("fwd", "dq", "dkv"), launched)),
                  launches_mma=dict(zip(("fwd", "dq", "dkv"), launched[3:])),
                  logit_rel_norm=gap["logits"], loss_flash=loss_flash,
                  loss_sdpa=loss_sdpa, loss_f32=ref[1], params=len(params),
                  worst_grad_rel_norm=gap[worst], worst_param=worst,
                  worst_grad_rel_norm_fma_dq=fma_dq[0],
                  tol_logits=BF16_LOGIT_TOL, tol_grads=BF16_GRAD_TOL,
                  witness_flash_dense_to_f32=to_ref,
                  worst_witness_ratio=ratio[worst_ratio],
                  worst_witness_param=worst_ratio,
                  worst_witness_ratio_fma_dq=fma_dq[1],
                  tol_witness_ratio=BF16_WITNESS_RATIO, ok=ok))
        if not ok:
            failures.append(
                f"bf16 check seed {seed}: launches {launched}, "
                f"{launched_dense}, logits {gap['logits']}, loss "
                f"{loss_flash} vs {loss_sdpa}, worst gradient {gap[worst]} "
                f"({worst}), witness ratio {ratio[worst_ratio]} "
                f"({worst_ratio})")
        del net, params, flash, dense, ref
        free_card(torch)


def train_phase(torch, mx, llama, fa, mt, failures):
    """Phase 9: llama3_8b at full width, 16 layers, bf16, B=1, T=2048,
    SGD with momentum — the training main path; the update is one launch
    of the fused multi-tensor kernel a step, printed beside its bound."""
    free_card(torch)
    t = time.perf_counter()
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=TRAIN_LAYERS)
    net.cast("bfloat16")
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": TRAIN_LR, "momentum": 0.9})
    torch.cuda.synchronize()
    emit(dict(phase="train_init", seconds=time.perf_counter() - t,
              layers=TRAIN_LAYERS, params=sum(
                  p.data().size for p in net.collect_params().values()),
              memory_allocated=torch.cuda.memory_allocated()))
    ids, labels = _ids_labels(torch, mx, net.config.vocab_size, 2048,
                              SEED + 5)
    _zero_counts(fa)  # the main path starts here
    losses, step_ms, peaks = [], [], []

    def phase_end(stamps, phase_peaks):
        """Wait for the card; note the clock and the phase's peak of
        allocated memory, and start the next phase's peak."""
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        phase_peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    mt.multi_tensor_update.launches = 0  # the update's main path starts
    for step in range(4):  # one warm-up, then three timed steps
        before = [c.launches for c in _counters(fa)]
        before_mma = _mma_counts(fa)
        stamps, step_peaks = [], []
        phase_end(stamps, [])
        loss_nd = _lm_forward(mx, net, ids, labels)
        phase_end(stamps, step_peaks)
        loss_nd.backward()
        phase_end(stamps, step_peaks)
        mt_before = mt.multi_tensor_update.launches
        trainer.step(1)
        phase_end(stamps, step_peaks)
        update_launches = mt.multi_tensor_update.launches - mt_before
        peaks.extend(step_peaks)
        loss = float(loss_nd.asscalar())
        fwd_ms, bwd_ms, update_ms = ((b - a) * 1e3 for a, b in
                                     zip(stamps, stamps[1:]))
        ms = (stamps[-1] - stamps[0]) * 1e3
        launched = [c.launches - n for c, n in zip(_counters(fa), before)]
        mma = [c - n for c, n in zip(_mma_counts(fa), before_mma)]
        losses.append(loss)
        if step:
            step_ms.append(ms)
        ok = math.isfinite(loss) and launched == [TRAIN_LAYERS] * 3 and \
            mma == [TRAIN_LAYERS] * 3 and update_launches == 1
        emit(dict(phase="train_step", step=step, warmup=step == 0,
                  loss=loss, ms=ms, tokens_per_s=2048 / ms * 1e3,
                  forward_ms=fwd_ms, backward_ms=bwd_ms,
                  update_ms=update_ms,
                  update_bound_ms=update_bound_ms(trainer),
                  update_launches=update_launches,
                  launches=dict(zip(("fwd", "dq", "dkv"), launched)),
                  launches_mma=dict(zip(("fwd", "dq", "dkv"), mma)),
                  max_memory_allocated=dict(zip(
                      ("forward", "backward", "update"), step_peaks)),
                  ok=ok))
        if not ok:
            failures.append(f"train step {step}: loss {loss}, launches "
                            f"{launched}, tensor-core launches {mma}, "
                            f"update launches {update_launches}")
    launches = [c.launches for c in _counters(fa)]  # the main path ends
    update_launches = mt.multi_tensor_update.launches  # ... ends
    kernel_ms, tensors = update_kernel_ms(torch, mt, trainer, 3)
    launches_mma = _mma_counts(fa)
    emit(dict(phase="train_memory", max_memory_allocated=max(peaks)))
    if not losses[-1] < losses[0]:
        failures.append(f"training loss did not fall: {losses}")
    if min(launches + launches_mma) == 0:
        failures.append(f"the training path left a kernel unlaunched: "
                        f"{launches}, tensor-core {launches_mma}")
    PLAIN9.update(losses=losses, step_ms=step_ms, peak=max(peaks),
                  launches_per_step=[TRAIN_LAYERS] * 3)
    emit(dict(phase="train_summary", losses=losses,
              losses_fma_design=FMA_DESIGN_LOSSES,
              losses_fma_dq=FMA_DQ_LOSSES,
              step_ms=step_ms,
              launches=dict(zip(("fwd", "dq", "dkv"), launches)),
              launches_mma=dict(zip(("fwd", "dq", "dkv"), launches_mma)),
              update_launches=update_launches,
              update_kernel_ms=kernel_ms, update_tensors=tensors,
              update_bound_ms=update_bound_ms(trainer),
              ok=losses[-1] < losses[0]))
    return launches, launches_mma, update_launches


def f32_phase(torch, mx, llama, fa, failures):
    """Phase 6: full width, 2 layers, f32: the flash forward against the
    decoder's dense prefill on the same ids."""
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=2)
    net.initialize(ctx=mx.gpu(0))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    ids = torch.randint(0, net.config.vocab_size, (1, 1024), generator=gen,
                        device="cuda", dtype=torch.int32)
    _zero_counts(fa)
    logits = net(mx.nd.array(ids))._data[:, -1].float()
    launched = fa.flash_attention_fwd.launches  # the FMA design's
    mma = fa.flash_attention_fwd.launches_mma
    dec = llama.LlamaDecoder(net, max_len=1024)
    with torch.no_grad():
        _, ref = dec._prefill_impl(dec._weights(), ids, 1024)
    err = (logits - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = launched == 2 and mma == 0 and err <= 1e-3 * scale and \
        math.isfinite(err)
    emit(dict(phase="f32_check", layers=2, T=1024, launches=launched,
              launches_mma=mma,
              max_abs_err=err, max_abs_logit=scale,
              tol=1e-3 * scale, ok=ok))
    if not ok:
        failures.append(f"f32 check: launches {launched} (tensor-core "
                        f"{mma}), err {err} vs "
                        f"{1e-3 * scale}")
    del net, dec, logits, ref
    free_card(torch)


SERVE_PROMPTS = 8
SERVE_NEW = 32
SERVE_MAX_LEN = 2048
SERVE_SLOTS = 4
SERVE_BLOCK = 16
SERVE_PREFIX = 512       # the radix mode's shared prefix
# phase 8b: near-argmax within this many bf16 ulps; the offline decoder
# and the dense route both read 19 at worst on this traffic (PERF.md)
SERVE_ULPS = 24
SERVE_SAME_MIN = 240     # phase 8b: of 256 tokens, at least this many
                         # equal to the offline decoder's (252 read)


def _serve_prompts(vocab):
    """The serving phases' traffic from the seed: 8 prompts of 64-1024
    tokens, and 8 more that share one 512-token prefix (suffixes of
    16-512 tokens)."""
    rs = np.random.RandomState(SEED + 20)
    lens = rs.randint(64, 1025, size=SERVE_PROMPTS)
    plain = [rs.randint(0, vocab, size=n).astype(np.int32) for n in lens]
    prefix = rs.randint(0, vocab, size=SERVE_PREFIX).astype(np.int32)
    shared = [np.concatenate([prefix, rs.randint(0, vocab, size=n)])
              .astype(np.int32)
              for n in rs.randint(16, 513, size=SERVE_PROMPTS)]
    return plain, shared


def _serve(serving, net, prompts, first_wave=None, mesh=None, **kw):
    """Serve ``prompts`` (SERVE_NEW tokens each) through a fresh
    ``GenerativeServer`` (on ``mesh``): all at once, or in two waves, the
    first ``first_wave`` prompts, then the rest once those are decoding.
    Returns (replies, server, stats, wall seconds from the first submit
    to the last reply)."""
    kw.setdefault("max_batch", SERVE_SLOTS)
    cfg = serving.ServerConfig(max_length=SERVE_MAX_LEN,
                               num_slots=SERVE_SLOTS,
                               block_size=SERVE_BLOCK,
                               queue_capacity=4 * SERVE_PROMPTS, **kw)
    srv = serving.GenerativeServer(net, cfg, mesh=mesh)
    cut = first_wave or len(prompts)
    with srv:
        t = time.perf_counter()
        futs = [srv.submit(p, max_new_tokens=SERVE_NEW)
                for p in prompts[:cut]]
        if cut < len(prompts):
            deadline = time.time() + 300
            while srv.engine.steps < 2 and time.time() < deadline:
                time.sleep(0.001)
            futs += [srv.submit(p, max_new_tokens=SERVE_NEW)
                     for p in prompts[cut:]]
        replies = [f.result(600) for f in futs]
        wall_s = time.perf_counter() - t
        stats = srv.stats()
    return replies, srv, stats, wall_s


def serving_f32_phase(torch, mx, llama, serving, failures):
    """Phase 7c: serving exactness.  llama3_8b widths at 2 layers, f32:
    the same 8 prompts served in the paged mode, the slots mode, with
    speculative decoding (the net as its own draft, spec_k=3), and 8
    prompts sharing a 512-token prefix with the radix cache; every reply
    must equal ``LlamaDecoder.generate`` on that prompt alone, token for
    token."""
    free_card(torch)
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=2)
    net.initialize(ctx=mx.gpu(0))
    plain, shared = _serve_prompts(net.config.vocab_size)
    dec = llama.LlamaDecoder(net, max_len=SERVE_MAX_LEN)
    t = time.perf_counter()
    ref = {id(p): dec.generate(p[None], SERVE_NEW)[0].cpu().numpy()
           for p in plain + shared}
    ref_s = time.perf_counter() - t
    modes = [("paged", plain, {}), ("slots", plain, {"kv_mode": "slots"}),
             ("speculative", plain, {"draft_net": net, "spec_k": 3}),
             ("radix", shared, {"radix_cache": True})]
    for mode, prompts, kw in modes:
        replies, srv, stats, wall_s = _serve(serving, net, prompts, **kw)
        wrong = [i for i, (p, r) in enumerate(zip(prompts, replies))
                 if not np.array_equal(r, ref[id(p)])]
        first_bad = None
        if wrong:
            p, r = prompts[wrong[0]], replies[wrong[0]]
            first_bad = int(np.argmax(r != ref[id(p)]) - len(p))
        row = dict(phase="serving_f32", mode=mode, layers=2,
                   prompts=[len(p) for p in prompts], new_tokens=SERVE_NEW,
                   replies_equal=len(prompts) - len(wrong),
                   wrong=wrong, first_wrong_token=first_bad,
                   wall_s=wall_s, reference_s=ref_s,
                   decode_ticks=len(srv.replicas[0].tick_ms)
                   if srv.replicas else stats["decode_steps"],
                   compiled_signatures=[list(s) for s in
                                        stats["compiled_signatures"]],
                   kv_blocks_peak=stats["kv_cache"].get(
                       "peak_blocks_in_use"))
        if mode == "speculative":
            row["speculative"] = stats["speculative"]
        if mode == "radix":
            row["radix"] = stats["radix_cache"]
            row["peak_shared_blocks"] = \
                stats["kv_cache"]["peak_shared_blocks"]
        ok = not wrong and stats["completed"] == len(prompts) and \
            stats["failed"] == 0
        if mode == "speculative":
            ok = ok and stats["speculative"]["accept_rate"] >= 0.6
        if mode == "radix":
            ok = ok and stats["radix_cache"]["hits"] >= 1 and \
                row["peak_shared_blocks"] >= SERVE_PREFIX // SERVE_BLOCK
        row["ok"] = ok
        emit(row)
        if not ok:
            failures.append(f"serving f32 {mode}: replies {wrong} differ "
                            f"from generate (first at token {first_bad})")
        del srv
    del net, dec
    free_card(torch)


def _bf16_ulp(torch, x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def serving_bf16_phase(torch, mx, llama, serving, fa, net, failures):
    """Phase 8b: serving at full size: phase 8's llama3_8b (32 layers,
    bf16), 8 requests (64-1024 tokens, 32 new each) in the paged mode,
    in two waves: 2 requests, then 6 once those are decoding, which fill
    the free slots of the in-flight batch.

    The check feeds each reply through ``net(ids)`` once (the flash
    forward, kernel #1) and reads, at every generated position, how far
    the server's token lies below the row's largest logit, in bf16 ulps
    of that logit.  Two witnesses read the same: the offline decoder
    (``LlamaDecoder.generate`` on each prompt alone, its own tokens fed
    through the flash forward) and the dense route (``attn_mode="sdpa"``
    on the server's ids: the argmax of the engine's own attention
    arithmetic, placed in the flash route's logits).  The server's worst
    gap must be within SERVE_ULPS, and at least SERVE_SAME_MIN of its
    tokens must equal the offline decoder's.  The serving path itself
    launches no kernel of the port (its attention is dense torch ops):
    its count must be 0, and the check's own launches are reported
    apart from it."""
    plain, _ = _serve_prompts(net.config.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fa)  # the serving path starts here
    replies, srv, stats, wall_s = _serve(serving, net, plain, first_wave=2)
    path_launches = sum(c.launches for c in _counters(fa))  # ... ends here
    rep = srv.replicas[0]
    recs = srv.request_records()
    peak = torch.cuda.max_memory_allocated()
    dec = llama.LlamaDecoder(net, max_len=SERVE_MAX_LEN)
    offline = [dec.generate(p[None], SERVE_NEW)[0].cpu().numpy()
               for p in plain]
    _zero_counts(fa)  # the check's own launches

    def logits_of(seq, t0, mode="flash"):
        ids = mx.nd.array(torch.from_numpy(seq[None, :-1].astype(np.int32))
                          .cuda())
        net.config.attn_mode = mode
        try:
            with torch.no_grad():
                return net(ids)._data[0, t0 - 1:].float()
        finally:
            net.config.attn_mode = "flash"

    def gaps(logits, toks):
        top = logits.max(dim=-1).values
        return ((top - logits.gather(1, toks[:, None])[:, 0]) /
                _bf16_ulp(torch, top)), top

    per = []
    top_abs = 0.0
    for p, r, o in zip(plain, replies, offline):
        t0 = len(p)
        lf = logits_of(r, t0)
        gap_srv, top = gaps(lf, torch.from_numpy(
            r[t0:].astype(np.int64)).cuda())
        ld = logits_of(r, t0, "sdpa")
        gap_dense, _ = gaps(lf, ld.argmax(dim=-1))
        lo = logits_of(o, t0)
        gap_off, _ = gaps(lo, torch.from_numpy(
            o[t0:].astype(np.int64)).cuda())
        top_abs = max(top_abs, top.abs().max().item())
        per.append(dict(server=gap_srv.tolist(), dense=gap_dense.tolist(),
                        offline=gap_off.tolist(),
                        same_as_offline=int((r[t0:] == o[t0:]).sum())))
        del lf, ld, lo
    launches = fa.flash_attention_fwd.launches
    launches_mma = fa.flash_attention_fwd.launches_mma
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")  # listed in .gitignore
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "serving_bf16_gaps.json"), "w") as f:
        json.dump(per, f)
    worst = {k: max(max(g[k]) for g in per)
             for k in ("server", "dense", "offline")}
    over = {k: sum(x > SERVE_ULPS for g in per for x in g[k])
            for k in ("server", "dense", "offline")}
    same = sum(g["same_as_offline"] for g in per)
    ticks = list(rep.tick_ms)
    decode_tokens = sum(rep.tick_slots)
    row = dict(
        phase="serving_bf16", layers=net.config.num_layers, mode="paged",
        waves=[2, len(plain) - 2], prompts=[len(p) for p in plain],
        new_tokens=SERVE_NEW, num_slots=SERVE_SLOTS,
        block_size=SERVE_BLOCK,
        ttft_ms=[r["ttft_ms"] for r in recs],
        queue_wait_ms=[r["queue_wait_ms"] for r in recs],
        joined_step=[r["joined_step"] for r in recs],
        done_step=[r["done_step"] for r in recs],
        decode_step_ms=ticks, decode_step_slots=list(rep.tick_slots),
        decode_step_ms_median=float(np.median(ticks)) if ticks else None,
        decode_tokens_per_s=decode_tokens / sum(ticks) * 1e3
        if ticks else None,
        overall_tokens_per_s=len(plain) * SERVE_NEW / wall_s,
        wall_s=wall_s, prefill_ms=list(rep.prefill_ms),
        kv_blocks_peak=stats["kv_cache"]["peak_blocks_in_use"],
        kv_num_blocks=stats["kv_cache"]["num_blocks"],
        kv_pool_bytes=srv.engine.kv_pool_bytes(),
        max_memory_allocated=peak, largest_top_logit=top_abs,
        worst_gap_ulps=worst, positions_over_tol=over,
        positions=len(plain) * SERVE_NEW, tol_ulps=SERVE_ULPS,
        tokens_same_as_offline=same, tokens_same_min=SERVE_SAME_MIN,
        path_launches=path_launches, check_launches=launches,
        check_launches_mma=launches_mma,
        step_graph_key=list(srv.engine._step_key),
        step_graph_pool_bytes=srv.engine._step_graph.pool_bytes,
        step_graph_replays=srv.engine._step_graph.replays,
        compiled_signatures=[list(k) for k in
                             srv.engine.compiled_signatures()])
    ok = worst["server"] <= SERVE_ULPS and same >= SERVE_SAME_MIN and \
        stats["completed"] == len(plain) and stats["failed"] == 0 and \
        path_launches == 0 and \
        launches == launches_mma == 2 * len(plain) * net.config.num_layers
    row["ok"] = ok
    cfg = net.config
    STASH["serve"] = dict(replies=replies, offline=offline,
                          ttft_ms=row["ttft_ms"],
                          decode_step_ms_median=row["decode_step_ms_median"],
                          kv_pool=dict(  # 29a's planner check
                              bytes=srv.engine.kv_pool_bytes(),
                              num_layers=cfg.num_layers,
                              num_kv_heads=cfg.num_kv_heads,
                              head_dim=cfg.head_dim,
                              num_blocks=srv.engine.num_blocks,
                              block_size=srv.engine.block_size,
                              dtype=str(srv.engine._pool[0][0].dtype)
                              .replace("torch.", "")))
    emit(row)
    if not ok:
        failures.append(f"serving bf16: a token {worst['server']} ulps off "
                        f"the flash forward's argmax (limit {SERVE_ULPS}; "
                        f"offline decoder {worst['offline']}, dense route "
                        f"{worst['dense']}); {same} tokens equal to the "
                        f"offline decoder's (at least {SERVE_SAME_MIN}); "
                        f"serving path launches {path_launches} (0 "
                        f"expected); check launches {launches} "
                        f"(tensor-core {launches_mma})")
    del srv, replies, dec


def slice_phase(torch, mx, llama, fa, failures):
    """Phase 8: llama3_8b, 32 layers, bf16 — the main path."""
    t = time.perf_counter()
    mx.random.seed(SEED)
    net = llama.llama3_8b()
    net.cast("bfloat16")
    net.initialize(ctx=mx.gpu(0))
    torch.cuda.synchronize()
    emit(dict(phase="init", seconds=time.perf_counter() - t,
              params=sum(p.data().size for p in
                         net.collect_params().values())))
    cfg = net.config
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fa)  # the main path starts here

    ids = mx.nd.array(torch.randint(0, cfg.vocab_size, (1, 2048),
                                    generator=gen, device="cuda",
                                    dtype=torch.int32))
    for run_i in range(2):  # the first call also warms up cuBLAS
        before = fa.flash_attention_fwd.launches
        before_mma = fa.flash_attention_fwd.launches_mma
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = net(ids)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launched = fa.flash_attention_fwd.launches - before
        mma = fa.flash_attention_fwd.launches_mma - before_mma
        finite = bool(torch.isfinite(logits._data).all())
        ok = launched == cfg.num_layers and mma == cfg.num_layers and \
            finite and logits.shape == (1, 2048, cfg.vocab_size)
        emit(dict(phase="prompt_forward", run=run_i, B=1, T=2048,
                  launches=launched, launches_mma=mma, finite=finite, ms=ms,
                  tokens_per_s=2048 / ms * 1e3, ok=ok))
        if not ok:
            failures.append(f"prompt forward: launches {launched}, "
                            f"tensor-core {mma}, finite {finite}")
    eager_logits = logits._data
    del logits
    # the same forward hybridized: the first call runs eagerly and
    # captures, the next ones replay the 32-layer graph
    net.hybridize(static_alloc=True, static_shape=True)
    for run_i in range(3):
        before = fa.flash_attention_fwd.launches
        before_mma = fa.flash_attention_fwd.launches_mma
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = net(ids)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launched = fa.flash_attention_fwd.launches - before
        mma = fa.flash_attention_fwd.launches_mma - before_mma
        diff = (logits._data.float() - eager_logits.float()).abs().max()
        tol = GRAPH_BF16_TOL * eager_logits.float().abs().max()
        identical = bool(torch.equal(logits._data, eager_logits))
        ok = launched == mma == cfg.num_layers and bool(diff <= tol)
        emit(dict(phase="prompt_forward_graph", run=run_i,
                  captured=run_i == 0, B=1, T=2048, ms=ms,
                  tokens_per_s=2048 / ms * 1e3, launches=launched,
                  launches_mma=mma, identical_to_eager=identical,
                  max_abs_diff=diff.item(), tol=tol.item(), ok=ok))
        if not ok:
            failures.append(f"prompt forward graph run {run_i}: launches "
                            f"{launched} (tensor-core {mma}), max diff "
                            f"{diff.item()} (tol {tol.item()})")
        del logits
    entry = next(iter(net._cached_op._graphs.values()))
    emit(dict(phase="prompt_forward_graph_cache",
              cache_stats=net.cache_stats(),
              graph_pool_bytes=entry[2].pool_bytes))
    net.hybridize(False)
    del eager_logits, entry
    free_card(torch)

    for b, t0 in REQUESTS:
        prompt = mx.nd.array(torch.randint(
            0, cfg.vocab_size, (b, t0), generator=gen, device="cuda",
            dtype=torch.int32))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = net.generate(prompt, max_new_tokens=NEW_TOKENS)  # captures
        torch.cuda.synchronize()
        first_call_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        out = net.generate(prompt, max_new_tokens=NEW_TOKENS)  # replays
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t) * 1e3
        # the prefill alone, on the decoder and padded shape generate used
        dec = next(d for m, d in sorted(net._kv_decoders.items())
                   if m >= t0 + NEW_TOKENS)
        lp = dec._prompt_len(t0, NEW_TOKENS)
        pad = torch.zeros((b, lp), dtype=torch.int32, device="cuda")
        pad[:, :t0] = prompt._data
        with torch.no_grad():
            w = dec._weights()
            prefill_ms = time_ms(torch, lambda: dec._prefill_impl(
                w, pad, t0), 1)
        first = out._data[:, t0]
        with torch.no_grad():
            ref_first = net(prompt)._data[:, -1].argmax(-1).to(torch.int32)
        # the eager decoder on the same prompt, in the same run
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine_type = mx.engine.engine_type()
        mx.engine.set_engine_type("NaiveEngine")  # eager decode steps
        try:
            eager = dec.generate(prompt._data, NEW_TOKENS)
        finally:
            mx.engine.set_engine_type(engine_type)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t) * 1e3
        same = bool(torch.equal(eager, out._data))
        ok = out.shape == (b, t0 + NEW_TOKENS) and same and \
            bool(torch.equal(out._data[:, :t0], prompt._data)) and \
            bool(((out._data >= 0) & (out._data < cfg.vocab_size)).all())
        decode_ms = total_ms - prefill_ms
        eager_decode_ms = eager_ms - prefill_ms
        graph, = dec._decode_states[b]["graphs"].values()
        emit(dict(phase="request", B=b, prompt=t0, new_tokens=NEW_TOKENS,
                  max_len=dec.max_len, prefill_len=lp,
                  first_call_ms=first_call_ms, total_ms=total_ms,
                  prefill_ms=prefill_ms,
                  decode_tokens_per_s=b * (NEW_TOKENS - 1) / decode_ms * 1e3
                  if decode_ms > 0 else None,
                  eager_total_ms=eager_ms,
                  eager_decode_tokens_per_s=b * (NEW_TOKENS - 1) /
                  eager_decode_ms * 1e3 if eager_decode_ms > 0 else None,
                  tokens_equal_to_eager=same,
                  decode_graph_pool_bytes=graph.pool_bytes,
                  # the static caches, tokens and positions of every batch
                  # size's graphs, and their pool, so far
                  decode_graph_bytes=dict(zip(("static", "pool"),
                                              dec.decode_graph_bytes())),
                  first_token_matches_forward_argmax=bool(
                      torch.equal(first, ref_first)), ok=ok))
        if not ok:
            failures.append(f"request B={b} t0={t0}: bad output or tokens "
                            f"unlike the eager decoder's ({same})")
        del out, w, eager
    launches = fa.flash_attention_fwd.launches  # the main path ends here
    launches_mma = fa.flash_attention_fwd.launches_mma
    emit(dict(phase="memory",
              max_memory_allocated=torch.cuda.max_memory_allocated()))
    if launches == 0 or launches_mma == 0:
        failures.append("the main path launched no flash_attention_fwd "
                        f"(tensor-core launches {launches_mma})")
    return launches, launches_mma, net


# The fused 1x1 conv + BN + ReLU kernel at ResNet-50 v1's shapes (B=128,
# 224x224): (name, B, H'=W', K, N, dtype, launches a forward); M = B·H'·W'.
# The first eight are the 16 launches of a bf16 forward; then one f32 shape
# and one ragged (B=1, M=49; K, N off the tile sizes).
FUSED_SHAPES = [
    ("s1_k64", 128, 56, 64, 64, "bfloat16", 1),
    ("s1_k256", 128, 56, 256, 64, "bfloat16", 2),
    ("s2_k256", 128, 28, 256, 128, "bfloat16", 1),
    ("s2_k512", 128, 28, 512, 128, "bfloat16", 3),
    ("s3_k512", 128, 14, 512, 256, "bfloat16", 1),
    ("s3_k1024", 128, 14, 1024, 256, "bfloat16", 5),
    ("s4_k1024", 128, 7, 1024, 512, "bfloat16", 1),
    ("s4_k2048", 128, 7, 2048, 512, "bfloat16", 2),
    ("f32", 8, 28, 512, 128, "float32", 0),
    ("ragged", 1, 7, 1000, 300, "bfloat16", 0),
]
# the same eight shapes in f16 (the f16 instance of the tensor-core
# design, the 16 launches of an f16 forward), and in bf16 at B=32, the
# batch bucket that phase 14 serves (M = 32·H'·W', e.g. 1568 at stage 4,
# leaves a partial M tile that B=128 never does)
FUSED_SHAPES += [("f16_" + name, b, h, k, n, "float16", per)
                 for name, b, h, k, n, dt, per in FUSED_SHAPES[:8]]
FUSED_SHAPES += [("b32_" + name, 32, h, k, n, dt, 0)
                 for name, b, h, k, n, dt, per in FUSED_SHAPES[:8]]
# kernel against its plain version on f32 copies: bf16, the kernel rounds
# its f32 result to 8 mantissa bits (2^-8 of each value) and sums in
# another order than cuBLAS (1e-4 of the largest value at K <= 2048); f32,
# only the summation order
FUSED_REL_TOL = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11,
                 "float32": 0.0}
FUSED_ABS_TOL = {"bfloat16": 1e-4, "float16": 1e-4,
                 "float32": 1e-5}  # x the largest value
RESNET_BATCHES = (128, 4)  # bench.py's batch, then __graft_entry__'s
RESNET_LR = 0.1


def fused_kernel_phase(torch, cbr, failures):
    """The fused kernel against its plain version at each shape, with its
    design, time, the plain version's, the library's (``addmm`` with the
    scale folded into w, then ``relu``), the eager NCHW chain's
    (``conv2d`` → ``batch_norm`` in eval → ``relu``), the card's bound and
    the NCHW → (M, K) copy the fused path makes before each launch."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    tnf = torch.nn.functional
    rows = []
    for name, b, h, k, n, dt, per_fwd in FUSED_SHAPES:
        dtype = getattr(torch, dt)
        m = b * h * h

        def rnd(*shape, lo=None, hi=None):
            if lo is None:
                return torch.randn(*shape, generator=gen, device="cuda")
            return torch.rand(*shape, generator=gen, device="cuda") * \
                (hi - lo) + lo

        x_nchw = rnd(b, k, h, h).to(dtype)
        wconv = (rnd(n, k, 1, 1) / math.sqrt(k)).to(dtype)
        gamma, beta = rnd(n, lo=0.5, hi=1.5), rnd(n, lo=-0.5, hi=0.5)
        mean, var = rnd(n, lo=-0.3, hi=0.3), rnd(n, lo=0.5, hi=1.5)
        t = time.perf_counter()
        x = x_nchw.permute(0, 2, 3, 1).reshape(m, k).contiguous()
        w, scale, bias = cbr.fold_bn(wconv, None, gamma, beta, mean, var,
                                     1e-5, False)
        got = cbr.fused_matmul_affine_relu(x, w, scale, bias)
        torch.cuda.synchronize()
        first_call_s = time.perf_counter() - t
        ref = cbr._fused_matmul_affine_relu_plain(x.float(), w.float(),
                                                  scale, bias)
        diff = (got.float() - ref).abs()
        largest = ref.abs().max().item()
        allowed = FUSED_REL_TOL[dt] * ref.abs() + \
            FUSED_ABS_TOL[dt] * largest
        err = diff.max().item()
        ok = bool((diff <= allowed).all()) and got.dtype == dtype and \
            got.shape == (m, n) and bool(torch.isfinite(got).all())
        iters = 20 if m * k * n > 1e9 else 100
        w_lib = (w.float() * scale).to(dtype)
        b_lib = bias.to(dtype)
        row = dict(
            phase="fused_kernel", shape=name, B=b, H=h, M=m, K=k, N=n,
            dtype=dt, design="fma" if dtype == torch.float32 else "mma",
            launches_per_forward=per_fwd, max_abs_err=err,
            max_abs_ref=largest,
            tol=f"{FUSED_REL_TOL[dt]}*|ref| + {FUSED_ABS_TOL[dt]}*max|ref|",
            first_call_s=first_call_s,
            kernel_ms=time_ms(torch, lambda: cbr.fused_matmul_affine_relu(
                x, w, scale, bias), iters),
            plain_ms=time_ms(torch, lambda: cbr._fused_matmul_affine_relu_plain(
                x, w, scale, bias), max(iters // 4, 5)),
            library_ms=time_ms(torch, lambda: torch.relu(torch.addmm(
                b_lib, x, w_lib)), iters),
            chain_ms=time_ms(torch, lambda: torch.relu(tnf.batch_norm(
                tnf.conv2d(x_nchw, wconv), mean, var, gamma, beta,
                training=False, eps=1e-5)), iters),
            # the fused path's layout copy (conv1x1_bn_relu), outside the
            # kernel
            nchw_to_mk_copy_ms=time_ms(
                torch, lambda: x_nchw.permute(0, 2, 3, 1).reshape(
                    m, k).contiguous(), iters))
        row["tflops"] = 2.0 * m * k * n / row["kernel_ms"] * 1e-9
        isz = x.element_size()
        row["bound_ms"], row["bound_by"] = roofline_ms(
            2.0 * m * k * n, isz * (m * k + k * n + m * n) + 8 * n, dt)
        row["ok"] = ok
        emit(row)
        rows.append(row)
        if not ok:
            failures.append(f"fused kernel {name}: max err {err} "
                            f"(largest {largest})")
        del x_nchw, x, got, ref, diff, allowed
    # one bf16 ResNet-50 forward's 16 launches: each time summed over
    # them; bound by what bounds most of the summed bound (and the same
    # for an f16 forward, on its own line)
    f16 = [r for r in rows
           if r["launches_per_forward"] and r["dtype"] == "float16"]
    emit(dict(phase="fused_kernel_forward_f16",
              launches=sum(r["launches_per_forward"] for r in f16),
              **{key: sum(r[key] * r["launches_per_forward"] for r in f16)
                 for key in ("kernel_ms", "bound_ms", "plain_ms",
                             "library_ms", "chain_ms")}))
    forward = [r for r in rows
               if r["launches_per_forward"] and r["dtype"] == "bfloat16"]
    # the served B=32 bucket's forward: each b32_ shape times the
    # launches its B=128 shape makes a forward
    per = {r["shape"]: r["launches_per_forward"] for r in forward}
    b32 = [(r, per[r["shape"][4:]]) for r in rows
           if r["shape"].startswith("b32_")]
    emit(dict(phase="fused_kernel_forward_b32",
              launches=sum(n for _, n in b32),
              max_abs_err=max(r["max_abs_err"] for r, _ in b32),
              **{key: sum(r[key] * n for r, n in b32)
                 for key in ("kernel_ms", "bound_ms", "plain_ms",
                             "library_ms", "chain_ms")}))
    total = dict(phase="fused_kernel_forward",
                 launches=sum(r["launches_per_forward"] for r in forward),
                 design=forward[0]["design"],
                 max_abs_err=max(r["max_abs_err"] for r in rows),
                 **{key: sum(r[key] * r["launches_per_forward"]
                             for r in forward)
                    for key in ("kernel_ms", "bound_ms", "plain_ms",
                                "library_ms", "chain_ms",
                                "nchw_to_mk_copy_ms")})
    total["tflops"] = sum(2.0 * r["M"] * r["K"] * r["N"] *
                          r["launches_per_forward"] for r in forward) / \
        total["kernel_ms"] * 1e-9
    by_bytes = sum(r["bound_ms"] * r["launches_per_forward"]
                   for r in forward if r["bound_by"] == "bytes")
    total["bound_by"] = "bytes" if 2 * by_bytes >= total["bound_ms"] \
        else "operations"
    emit(total)
    return total


def _resnet_arrays(torch, mx, net_fn, x_shape):
    """Weights for ``net_fn()`` on the CPU from the seed (Xavier), with
    moving means and variances drawn away from 0 and 1, as numpy arrays
    by structural name."""
    mx.random.seed(SEED)
    net = net_fn()
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    net(mx.nd.zeros(x_shape, ctx=mx.cpu()))  # resolve deferred shapes
    gen = torch.Generator().manual_seed(SEED + 7)
    arrays = {}
    for key, p in net._collect_params_with_prefix().items():
        a = p.data()._data.detach()
        if key.endswith("running_mean"):
            a = torch.randn(a.shape, generator=gen) * 0.1
        elif key.endswith("running_var"):
            a = torch.rand(a.shape, generator=gen) + 0.5
        arrays[key] = a.numpy().copy()
    return arrays


def resnet_f32_phase(torch, mx, vision, cbr, failures):
    """``resnet50_v1`` in f32, B=2, 224x224: the same weights on the card
    (the fused kernel, no TF32) and on the CPU (its plain version)."""
    from mxnet_tpu_torch.convert import load_numpy_params

    free_card(torch)
    shape = (2, 3, 224, 224)
    arrays = _resnet_arrays(torch, mx, vision.resnet50_v1, shape)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(SEED + 8))
    cpu_net, gpu_net = vision.resnet50_v1(), vision.resnet50_v1()
    load_numpy_params(cpu_net, arrays, ctx=mx.cpu())
    load_numpy_params(gpu_net, arrays, ctx=mx.gpu(0))
    fn = cbr.fused_matmul_affine_relu
    before = (fn.launches, fn.launches_mma)
    got = gpu_net(mx.nd.array(x, ctx=mx.gpu(0)))._data.float().cpu()
    launched = fn.launches - before[0]
    mma = fn.launches_mma - before[1]  # f32: the FMA design only
    ref = cpu_net(mx.nd.array(x, ctx=mx.cpu()))._data
    largest = ref.abs().max().item()
    share = (got - ref).abs().max().item() / largest
    ok = launched == 16 and mma == 0 and share <= 1e-3 and \
        got.shape == (2, 1000) and bool(torch.isfinite(got).all())
    emit(dict(phase="resnet_f32_check", B=2, image=224, launches=launched,
              launches_mma=mma, max_abs_logit=largest, max_err_share=share,
              tol=1e-3, ok=ok))
    if not ok:
        failures.append(f"resnet f32 check: launches {launched} "
                        f"(tensor-core {mma}), error share {share}")
    del cpu_net, gpu_net
    free_card(torch)


def resnet_infer_phase(torch, mx, vision, cbr, failures):
    """``resnet50_v1`` in bf16, 224x224, at B=128 and B=4: the inference
    main path through the fused kernel, 16 launches a forward, eagerly and
    then hybridized (CUDA graph replays against the eager logits); then
    the weights' round trip through a ``.params`` file."""
    free_card(torch)
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.cast("bfloat16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    inputs = {b: mx.nd.array(torch.rand(
        (b, 3, 224, 224), generator=gen, device="cuda").bfloat16())
        for b in RESNET_BATCHES}
    net(inputs[RESNET_BATCHES[-1]])  # resolve deferred shapes
    torch.cuda.synchronize()
    fn = cbr.fused_matmul_affine_relu
    fn.launches = fn.launches_mma = 0  # the main path starts here
    eager_out, eager_warm = {}, {}
    for b in RESNET_BATCHES:
        x = inputs[b]
        torch.cuda.reset_peak_memory_stats()
        ms, launched = [], []
        for _ in range(4):  # one warm-up, then three timed forwards
            before = (fn.launches, fn.launches_mma)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = net(x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            launched.append((fn.launches - before[0],
                             fn.launches_mma - before[1]))
        finite = bool(torch.isfinite(out._data).all())
        warm = sum(ms[1:]) / 3
        eager_out[b], eager_warm[b] = out._data, warm
        # 16 launches a forward, all of the tensor-core design
        ok = launched == [(16, 16)] * 4 and finite and \
            out.shape == (b, 1000) and out.dtype == torch.bfloat16
        emit(dict(phase="resnet_infer", B=b, image=224, dtype="bfloat16",
                  launches_per_forward=[n for n, _ in launched],
                  launches_mma_per_forward=[n for _, n in launched],
                  ms=ms, warm_ms=warm,
                  images_per_s=b / warm * 1e3, finite=finite,
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  ok=ok))
        if not ok:
            failures.append(f"resnet inference B={b}: launches (all, "
                            f"tensor-core) {launched}, finite {finite}")
        del out
    # hybridized: each batch's first call runs eagerly and captures its
    # graph, the next ones replay it (16 fused launches each)
    net.hybridize(static_alloc=True, static_shape=True)
    for b in RESNET_BATCHES:
        x = inputs[b]
        ms, launched = [], []
        for _ in range(4):
            before = (fn.launches, fn.launches_mma)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = net(x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            launched.append((fn.launches - before[0],
                             fn.launches_mma - before[1]))
        ref = eager_out[b]
        diff = (out._data.float() - ref.float()).abs().max().item()
        tol = GRAPH_BF16_TOL * ref.float().abs().max().item()
        warm = sum(ms[1:]) / 3
        sig = next(k for k in net._cached_op._graphs if k[0][0][0][0] == b)
        ok = launched == [(16, 16)] * 4 and diff <= tol and \
            out.shape == (b, 1000)
        emit(dict(phase="resnet_infer_graph", B=b, image=224,
                  dtype="bfloat16", ms=ms, warm_ms=warm,
                  eager_warm_ms=eager_warm[b],
                  images_per_s=b / warm * 1e3,
                  launches_per_forward=[n for n, _ in launched],
                  launches_mma_per_forward=[n for _, n in launched],
                  identical_to_eager=bool(torch.equal(out._data, ref)),
                  max_abs_diff=diff, tol=tol,
                  graph_pool_bytes=net._cached_op._graphs[sig][2].pool_bytes,
                  ok=ok))
        if not ok:
            failures.append(f"resnet inference graph B={b}: launches "
                            f"{launched}, max diff {diff} (tol {tol})")
        del out
    launches, launches_mma = fn.launches, fn.launches_mma  # the path ends
    emit(dict(phase="resnet_infer_graph_cache",
              cache_stats=net.cache_stats()))
    net.hybridize(False)
    if launches_mma == 0:
        failures.append("the ResNet inference path launched no "
                        "tensor-core fused_matmul_affine_relu")
    # the weights through a .params file: save_parameters, then
    # resnet50_v1(pretrained=True) from that local file, cast to bf16 (the
    # file holds the bf16 values as f32, exactly), the same forward bits
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="mxt_params_")
    try:
        t = time.perf_counter()
        net.save_parameters(os.path.join(root, "resnet50_v1.params"))
        save_s = time.perf_counter() - t
        size = os.path.getsize(os.path.join(root, "resnet50_v1.params"))
        loaded = vision.resnet50_v1(classes=1000, pretrained=True,
                                    root=root, ctx=mx.gpu(0))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    loaded.cast("bfloat16")
    x = inputs[RESNET_BATCHES[-1]]
    same = bool(torch.equal(loaded(x)._data, net(x)._data))
    emit(dict(phase="params_round_trip", net="resnet50_v1",
              dtype="bfloat16", file_bytes=size, save_s=save_s,
              identical_forward=same, ok=same))
    if not same:
        failures.append("resnet50_v1 .params round trip: the loaded net's "
                        "forward differs")
    del net, inputs, loaded
    free_card(torch)
    return launches, launches_mma


#: phase 9's losses, step times and peak memory, which phase 18b (the
#: same net and batch on the mesh route) is held to and printed beside
PLAIN9 = {}
# what later phases are held beside: phase 7d's checkpoint round trip, 8b's
# serving, 12b's fused ResNet-50 step, 18b's mesh route
STASH = {}


def _resnet_step(mx, net, trainer, loss_fn, x, y, stamps=None):
    """One recorded forward, backward and optimizer step; ``stamps``
    (a callable) marks the end of each phase.  Returns the mean loss."""
    mark = stamps or (lambda: None)
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    mark()
    loss.backward()
    mark()
    trainer.step(x.shape[0])
    mark()
    return float(loss.mean().asscalar())


def resnet18_f32_train_phase(torch, mx, vision, failures):
    """``resnet18_v1(classes=8, thumbnail=True)`` in f32, B=2, 16x16: one
    SGD-momentum step on the card and on the CPU from the same weights;
    the loss and every updated parameter within 1e-4 (of the largest
    value of the same tensor)."""
    from mxnet_tpu_torch.convert import load_numpy_params

    def make():
        return vision.resnet18_v1(classes=8, thumbnail=True)

    arrays = _resnet_arrays(torch, mx, make, (1, 3, 16, 16))
    x = torch.rand((2, 3, 16, 16),
                   generator=torch.Generator().manual_seed(SEED + 10))
    y = torch.tensor([1.0, 5.0])
    results = []
    for ctx in (mx.gpu(0), mx.cpu()):
        net = make()
        load_numpy_params(net, arrays, ctx=ctx)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05, "momentum": 0.9})
        loss = _resnet_step(mx, net, trainer,
                            mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                            mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx))
        results.append((loss, {k: p.data()._data.detach().float().cpu()
                               for k, p in
                               net._collect_params_with_prefix().items()}))
    (loss_gpu, p_gpu), (loss_cpu, p_cpu) = results
    worst, worst_name = 0.0, None
    for key, ref in p_cpu.items():
        share = ((p_gpu[key] - ref).abs().max() /
                 ref.abs().max().clamp_min(1e-30)).item()
        if not share <= worst:
            worst, worst_name = share, key
    ok = math.isfinite(loss_gpu) and \
        abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu) and worst <= 1e-4
    emit(dict(phase="resnet18_f32_train_check", B=2, image=16,
              loss_gpu=loss_gpu, loss_cpu=loss_cpu, params=len(p_cpu),
              worst_param_err_share=worst, worst_param=worst_name, tol=1e-4,
              ok=ok))
    if not ok:
        failures.append(f"resnet18 f32 training check: loss {loss_gpu} vs "
                        f"{loss_cpu}, worst parameter {worst} "
                        f"({worst_name})")


def resnet_train_phase(torch, mx, vision, cbr, mt, failures):
    """``resnet50_v1``, bf16 (``net.cast``), B=128, 224x224, SGD with
    momentum 0.9 and lr 0.1, ``SoftmaxCrossEntropyLoss`` — bench.py's
    protocol, eager: one warm-up step and three timed steps on one batch.
    BatchNorm normalizes by the batch, so the fused conv kernel never
    runs; the update is one launch of the multi-tensor kernel a step."""
    free_card(torch)
    t = time.perf_counter()
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.zeros((1, 3, 224, 224), ctx=mx.gpu(0)))  # resolve shapes
    net.cast("bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": RESNET_LR, "momentum": 0.9})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    b = RESNET_BATCHES[0]
    x = mx.nd.array(torch.rand((b, 3, 224, 224), generator=gen,
                               device="cuda").bfloat16())
    y = mx.nd.array(torch.randint(0, 1000, (b,), generator=gen,
                                  device="cuda").float())
    torch.cuda.synchronize()
    emit(dict(phase="resnet_train_init", seconds=time.perf_counter() - t,
              params=sum(p.data().size for p in
                         net.collect_params().values()),
              memory_allocated=torch.cuda.memory_allocated()))
    fused_before = cbr.fused_matmul_affine_relu.launches
    mt.multi_tensor_update.launches = 0  # the update's main path starts
    losses, step_ms = [], []
    for step in range(4):
        stamps, peaks = [], []

        def mark():
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

        mark()
        peaks.clear()
        mt_before = mt.multi_tensor_update.launches
        loss = _resnet_step(mx, net, trainer, loss_fn, x, y, mark)
        upd_launches = mt.multi_tensor_update.launches - mt_before
        fwd_ms, bwd_ms, upd_ms = ((b2 - a) * 1e3 for a, b2 in
                                  zip(stamps, stamps[1:]))
        ms = (stamps[-1] - stamps[0]) * 1e3
        losses.append(loss)
        if step:
            step_ms.append(ms)
        ok = math.isfinite(loss) and upd_launches == 1
        emit(dict(phase="resnet_train_step", step=step, warmup=step == 0,
                  B=b, loss=loss, ms=ms, images_per_s=b / ms * 1e3,
                  forward_ms=fwd_ms, backward_ms=bwd_ms, update_ms=upd_ms,
                  update_bound_ms=update_bound_ms(trainer),
                  update_launches=upd_launches,
                  max_memory_allocated=dict(zip(
                      ("forward", "backward", "update"), peaks)), ok=ok))
        if not ok:
            failures.append(f"resnet train step {step}: loss {loss}, "
                            f"update launches {upd_launches}")
    fused = cbr.fused_matmul_affine_relu.launches - fused_before
    update_launches = mt.multi_tensor_update.launches  # ... ends
    kernel_ms, tensors = update_kernel_ms(torch, mt, trainer, 20)
    ok = losses[-1] < losses[0] and fused == 0
    emit(dict(phase="resnet_train_summary", losses=losses, step_ms=step_ms,
              fused_launches=fused, update_launches=update_launches,
              update_kernel_ms=kernel_ms, update_tensors=tensors,
              update_bound_ms=update_bound_ms(trainer), ok=ok))
    if not ok:
        failures.append(f"resnet training: losses {losses}, fused launches "
                        f"{fused} (expected a falling loss and 0)")
    del net, trainer, x, y
    free_card(torch)
    return update_launches


# The fused multi-tensor update kernel (phase 5b): every rule code of the
# kernel at ragged tensor lengths (1 element up to three blocks and a bit)
# in f32, bf16, bf16 with an f32 master and f16, over three steps with an
# lr schedule, rescale, clipping and weight decay; weights within 1 ulp of
# their dtype, f32 states and masters within 2 f32 ulps (the kernel
# rounds where the plain rule's torch ops round).
MT_SIZES = [1, 7, 4097, 16389, 3 * 16384]
MT_RULES = [("sgd", {}), ("sgd", {"momentum": 0.9}),
            ("nag", {"momentum": 0.9}), ("adam", {}), ("adamw", {})]
MT_DTYPES = [("float32", False), ("bfloat16", False), ("bfloat16", True),
             ("float16", False)]
MT_WEIGHT_ULPS = 1
MT_STATE_ULPS = 2
# FusedTrainStep phases: ResNet-50 bf16 B=128, K=8 (bench.py's protocol);
# the 8 losses against 8 eager Trainer steps from the same weights, at an
# lr at which both fall (at phase 12's lr 0.1 the losses on one constant
# batch rise, and a trajectory that diverges hides a wrong update).  Step
# 0 runs the same kernels eagerly in both (it is the graph's warm-up);
# steps 1-7 replay the graph, whose cuDNN and cuBLAS calls may sum in
# another order than the eager calls do, and 8 steps of SGD in bf16 carry
# that: each loss within 2e-2 of the eager loss (relative)
FUSED_STEP_K = 8
FUSED_RESNET_LR = 0.01
FUSED_LOSS_RTOL = 2e-2
# the 2-layer f32 Llama: K=2 graph losses within 1e-5 (relative) of eager
# steps, the final weights within 1e-3 of the largest change the two
# eager steps made to the same tensor (f32; phase 7's 1e-3 share)
FUSED_LLAMA_K = 2


def _max_ulps(torch, got, ref, dtype, chunk=1 << 26):
    """Largest |got - ref| in units of ``dtype``'s spacing at ``ref`` (the
    smallest subnormal step below the normal range), chunk by chunk."""
    eps = torch.finfo(dtype).eps
    floor = torch.finfo(dtype).smallest_normal * eps
    g, r = got.reshape(-1), ref.reshape(-1)
    worst = 0.0
    for i in range(0, r.numel(), chunk):
        a, b = g[i:i + chunk].double(), r[i:i + chunk].double()
        _, e = torch.frexp(b)
        ulp = torch.ldexp(torch.full_like(b, eps), e - 1).clamp_min(floor)
        worst = max(worst, ((a - b).abs() / ulp).max().item())
    return worst


def update_bound_ms(trainer):
    """Least time of one optimizer update on the card: each live weight,
    state and master read and written once, each gradient read once, over
    3.35 TB/s."""
    from mxnet_tpu_torch import optimizer as topt

    nbytes = 0
    for p in trainer._params:
        if p.grad_req == "null" or p._data is None:
            continue
        w = p.data()._data
        nbytes += 3 * w.numel() * w.element_size()
        state = trainer._states[trainer._param2idx[p.name]]
        holders = [] if state is None else topt._state_holders(state)
        nbytes += sum(2 * h._data.numel() * h._data.element_size()
                      for h in holders)
    return nbytes / PEAK_BYTES * 1e3


def update_kernel_ms(torch, mt, trainer, iters):
    """Device time of the update kernel alone over the trainer's tensors:
    the launch of the plan its last step wrote (the pointers it holds are
    still live), ``iters`` times after one warm-up; and the tensor count.
    Run after the timed steps (it updates the weights again)."""
    live = trainer._live()
    device = trainer._params[live[0]].data()._data.device
    plan = mt._PLANS[(device, tuple(trainer._params[i].data().size
                                    for i in live))]
    return time_ms(torch, lambda: plan.launch(trainer._optimizer),
                   iters), len(live)


def multi_tensor_phase(torch, mx, llama, mt, failures):
    """Phase 5b: the fused multi-tensor update kernel against its plain
    version (the optimizer's per-tensor rule) for every rule and dtype at
    ragged lengths, then over the 147 tensors of the 16-layer Llama
    training slice (bf16 weights, SGD with f32 momentum): the check, the
    kernel's time (the launch alone, and the call with its table write),
    the plain version's, the ``torch._foreach_*`` chain's (the library
    yardstick) and the bound."""
    from mxnet_tpu_torch import optimizer as topt

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 20)
    for name, kw in MT_RULES:
        for dt, mp in MT_DTYPES:
            dtype = getattr(torch, dt)
            opt = topt.create(name, multi_precision=mp, rescale_grad=0.5,
                              clip_gradient=1.5, **kw)
            rule = opt._fused_rule()[0]
            n_states = mt._STATES[rule]
            sdt = dtype if rule == "nag_mom" and not mp else torch.float32
            ker = []
            for n in MT_SIZES:
                w = torch.randn(n, generator=gen, device="cuda").to(dtype)
                g = (2 * torch.randn(n, generator=gen, device="cuda")).to(
                    dtype)
                states = tuple((torch.rand(n, generator=gen, device="cuda")
                                * 0.1).to(sdt) for _ in range(n_states))
                ker.append(mt.UpdateItem(w, g, states,
                                         w.float() if mp else None,
                                         0.0, 0.0, 0))
            ref = [mt.UpdateItem(
                it.w.clone(), it.g, tuple(x.clone() for x in it.states),
                None if it.master is None else it.master.clone(), 0.0, 0.0,
                0) for it in ker]
            before = mt.multi_tensor_update.launches
            for step, lr in enumerate((0.1, 0.05, 0.025)):
                sched = [it._replace(lr=lr * (1 + j % 2), wd=0.01 * (j % 3),
                                     t=step + 1) for j, it in enumerate(ker)]
                mt.multi_tensor_update(opt, sched)
                mt._update_plain(opt, [r._replace(lr=x.lr, wd=x.wd, t=x.t)
                                       for r, x in zip(ref, sched)])
            torch.cuda.synchronize()
            launched = mt.multi_tensor_update.launches - before
            w_ulps = max(_max_ulps(torch, k.w, r.w, dtype)
                         for k, r in zip(ker, ref))
            s_ulps = max([_max_ulps(torch, a, b, sdt) for k, r in
                          zip(ker, ref) for a, b in zip(k.states, r.states)]
                         or [0.0])
            m_ulps = max(_max_ulps(torch, k.master, r.master,
                                   torch.float32)
                         for k, r in zip(ker, ref)) if mp else None
            s_tol = MT_STATE_ULPS if sdt == torch.float32 else MT_WEIGHT_ULPS
            ok = launched == 3 and w_ulps <= MT_WEIGHT_ULPS and \
                s_ulps <= s_tol and (m_ulps is None or
                                     m_ulps <= MT_STATE_ULPS)
            emit(dict(phase="multi_tensor", rule=rule, dtype=dt, master=mp,
                      sizes=MT_SIZES, steps=3, launches=launched,
                      weight_ulps=w_ulps, state_ulps=s_ulps,
                      master_ulps=m_ulps, tol_weight_ulps=MT_WEIGHT_ULPS,
                      tol_state_ulps=s_tol, ok=ok))
            if not ok:
                failures.append(f"multi-tensor {rule} {dt} master={mp}: "
                                f"launches {launched}, ulps weight {w_ulps} "
                                f"state {s_ulps} master {m_ulps}")
            del ker, ref
    # the 147 tensors of the training slice, at their shapes
    shapes = [p.shape for p in llama.llama3_8b(
        num_layers=TRAIN_LAYERS).collect_params().values()]
    opt = topt.create("sgd", learning_rate=TRAIN_LR, momentum=0.9)
    items = []
    for shape in shapes:
        w = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16)
        g = (torch.randn(shape, generator=gen, device="cuda") * 0.01).to(
            torch.bfloat16)
        m = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        items.append(mt.UpdateItem(w, g, (m,), None, TRAIN_LR, 0.0, 1))
    params = sum(it.w.numel() for it in items)
    ref = [it._replace(w=it.w.clone(), states=(it.states[0].clone(),))
           for it in items]
    before = mt.multi_tensor_update.launches
    mt.multi_tensor_update(opt, items)
    launched = mt.multi_tensor_update.launches - before
    mt._update_plain(opt, ref)
    torch.cuda.synchronize()
    w_ulps = max(_max_ulps(torch, k.w, r.w, torch.bfloat16)
                 for k, r in zip(items, ref))
    s_ulps = max(_max_ulps(torch, k.states[0], r.states[0], torch.float32)
                 for k, r in zip(items, ref))
    err = max((k.w.float() - r.w.float()).abs().max().item()
              for k, r in zip(items, ref))
    del ref
    free_card(torch)
    plan = mt.plan_for(items)
    ws = [it.w for it in items]
    gs = [it.g for it in items]
    ms = [it.states[0] for it in items]

    def foreach_chain():
        torch._foreach_mul_(ms, 0.9)
        torch._foreach_add_(ms, gs, alpha=-TRAIN_LR)
        torch._foreach_add_(ws, ms)

    bound, bound_by = roofline_ms(0.0, 14.0 * params, "bfloat16")
    row = dict(phase="multi_tensor_llama", tensors=len(items),
               params=params, rule="sgd_mom", dtype="bfloat16",
               launches=launched, weight_ulps=w_ulps, state_ulps=s_ulps,
               max_abs_err=err, blocks=plan.nblocks,
               kernel_ms=time_ms(torch, lambda: plan.launch(opt), 5),
               call_ms=time_ms(torch, lambda: mt.multi_tensor_update(
                   opt, items), 5),
               plain_ms=time_ms(torch, lambda: mt._update_plain(opt, items),
                                2),
               library_ms=time_ms(torch, foreach_chain, 3),
               bound_ms=bound, bound_by=bound_by)
    row["gbytes_per_s"] = 14.0 * params / row["kernel_ms"] * 1e-6
    row["ok"] = ok = launched == 1 and w_ulps <= MT_WEIGHT_ULPS and \
        s_ulps <= MT_STATE_ULPS
    emit(row)
    if not ok:
        failures.append(f"multi-tensor over the Llama slice's tensors: "
                        f"launches {launched}, ulps weight {w_ulps} state "
                        f"{s_ulps}")
    del items, plan, ws, gs, ms
    free_card(torch)
    return row


def fused_llama_phase(torch, mx, llama, fa, mt, checkpoint, failures):
    """Phase 7d: ``FusedTrainStep`` on ``llama3_8b`` widths at 2 layers in
    f32, T=1024, K=2 (SGD, momentum 0.9): the graph's losses and final
    weights against two eager ``Trainer.step``s from the same weights,
    with the flash forward, dQ and dK/dV launches counted through the
    replays; then the checkpoint round trip: ``save_checkpoint`` of the
    fused net's training state, one more step, and the same step after
    ``resume`` into a fresh net and trainer: the loss and the weights
    equal."""
    import shutil
    import tempfile

    kw = {"learning_rate": 0.01, "momentum": 0.9}

    def make():
        mx.random.seed(SEED)
        net = llama.llama3_8b(num_layers=2)
        net.initialize(ctx=mx.gpu(0))
        return net

    def lm_loss(n, a, b):
        vocab = n.config.vocab_size
        return mx.nd.softmax_cross_entropy(
            n(a).reshape((-1, vocab)), b.reshape((-1,))) / b.size

    net_e = make()
    ids, labels = _ids_labels(torch, mx, net_e.config.vocab_size, 1024,
                              SEED + 12)
    start = {k: p.data()._data.clone() for k, p in
             net_e._collect_params_with_prefix().items()}
    tr_e = mx.gluon.Trainer(net_e.collect_params(), "sgd", dict(kw))
    eager = []
    for _ in range(FUSED_LLAMA_K):
        with mx.autograd.record():
            loss = lm_loss(net_e, ids, labels)
        loss.backward()
        tr_e.step(1)
        eager.append(float(loss.asscalar()))
    net_f = make()
    tr_f = mx.gluon.Trainer(net_f.collect_params(), "sgd", dict(kw))
    fstep = mx.gluon.FusedTrainStep(net_f, tr_f, lm_loss,
                                    steps_per_execution=FUSED_LLAMA_K,
                                    batch_size=1)
    _zero_counts(fa)
    mt_before = mt.multi_tensor_update.launches
    torch.cuda.synchronize()
    t = time.perf_counter()
    fused = fstep(ids, labels).asnumpy().tolist()
    first_call_s = time.perf_counter() - t
    launched = [c.launches for c in _counters(fa)]
    mt_launched = mt.multi_tensor_update.launches - mt_before
    graph = next(iter(fstep._graphs.values()))["graph"]
    worst, worst_name = 0.0, None
    pe = net_e._collect_params_with_prefix()
    for k, p in net_f._collect_params_with_prefix().items():
        moved = (pe[k].data()._data - start[k]).abs().max().item()
        share = (p.data()._data - pe[k].data()._data).abs().max().item() / \
            max(moved, 1e-30)
        if share > worst:
            worst, worst_name = share, k
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fused, eager))
    per_step = 2 * FUSED_LLAMA_K  # 2 layers, K steps
    ok = launched == [per_step] * 3 and mt_launched == FUSED_LLAMA_K and \
        loss_rel <= 1e-5 and worst <= 1e-3
    emit(dict(phase="fused_step_llama", layers=2, T=1024, dtype="float32",
              K=FUSED_LLAMA_K, losses=fused, eager_losses=eager,
              max_loss_rel_err=loss_rel, worst_weight_err_share=worst,
              worst_param=worst_name,
              launches=dict(zip(("fwd", "dq", "dkv"), launched)),
              multi_tensor_launches=mt_launched,
              graph_replays=graph.replays, graph_pool_bytes=graph.pool_bytes,
              first_call_s=first_call_s, ok=ok))
    if not ok:
        failures.append(f"fused step (llama): losses {fused} vs {eager}, "
                        f"worst weight share {worst} ({worst_name}), "
                        f"launches {launched}, update launches "
                        f"{mt_launched}")
    del net_e, tr_e, start, pe, fstep, graph
    free_card(torch)

    # the checkpoint round trip from the fused net's state
    ckpt_dir = tempfile.mkdtemp(prefix="mxt_ckpt_")
    try:
        t = time.perf_counter()
        checkpoint.save_checkpoint(ckpt_dir, FUSED_LLAMA_K, net_f, tr_f)
        save_s = time.perf_counter() - t
        ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(ckpt_dir) for f in fs)

        def one_step(net, tr):
            with mx.autograd.record():
                loss = lm_loss(net, ids, labels)
            loss.backward()
            tr.step(1)
            return float(loss.asscalar())

        loss_a = one_step(net_f, tr_f)
        mx.random.seed(SEED + 1)
        net_r = llama.llama3_8b(num_layers=2)
        net_r.initialize(ctx=mx.gpu(0))  # other weights: all come from disk
        tr_r = mx.gluon.Trainer(net_r.collect_params(), "sgd", dict(kw))
        t = time.perf_counter()
        step, _ = checkpoint.resume(ckpt_dir, net_r, tr_r)
        resume_s = time.perf_counter() - t
        loss_b = one_step(net_r, tr_r)
        pr = net_r._collect_params_with_prefix()
        diff = max((p.data()._data - pr[k].data()._data).abs().max().item()
                   for k, p in net_f._collect_params_with_prefix().items())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ok = step == FUSED_LLAMA_K and loss_a == loss_b and diff == 0.0
    STASH["ckpt"] = dict(save_s=save_s, resume_s=resume_s,
                         bytes=ckpt_bytes)
    emit(dict(phase="checkpoint_round_trip", layers=2, dtype="float32",
              step=step, loss_uninterrupted=loss_a, loss_resumed=loss_b,
              max_abs_weight_diff=diff, checkpoint_bytes=ckpt_bytes,
              save_s=save_s, resume_s=resume_s, ok=ok))
    if not ok:
        failures.append(f"checkpoint round trip: step {step}, loss "
                        f"{loss_b} vs {loss_a}, weights differ by {diff}")
    del net_f, tr_f, net_r, tr_r, pr
    free_card(torch)


def fused_resnet_phase(torch, mx, vision, mt, failures):
    """Phase 12b: ``FusedTrainStep(net, trainer, forward_loss,
    steps_per_execution=8, batch_size=128)`` on ``resnet50_v1`` in bf16
    (bench.py's protocol; SGD lr ``FUSED_RESNET_LR``, momentum 0.9, one
    constant batch): the first call (step 0 eager, the capture, 7
    replays) against 8 eager ``Trainer.step``s from the same weights,
    both falling; then one timed call of 8 replays: ms a step and
    images/s, and the graph's pool bytes."""
    free_card(torch)
    b = RESNET_BATCHES[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    x = mx.nd.array(torch.rand((b, 3, 224, 224), generator=gen,
                               device="cuda").bfloat16())
    y = mx.nd.array(torch.randint(0, 1000, (b,), generator=gen,
                                  device="cuda").float())
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def make():
        mx.random.seed(SEED)
        net = vision.resnet50_v1(classes=1000)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net(mx.nd.zeros((1, 3, 224, 224), ctx=mx.gpu(0)))
        net.cast("bfloat16")
        return net, mx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": FUSED_RESNET_LR, "momentum": 0.9})

    net, tr = make()
    eager, eager_ms = [], []
    for _ in range(FUSED_STEP_K):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(b)
        eager.append(float(loss.sum().asscalar()))
        eager_ms.append((time.perf_counter() - t) * 1e3)
    del net, tr, loss
    free_card(torch)
    net, tr = make()
    fstep = mx.gluon.FusedTrainStep(
        net, tr, lambda n, a, c: loss_fn(n(a), c),
        steps_per_execution=FUSED_STEP_K, batch_size=b)
    mt.multi_tensor_update.launches = before = 0  # the main path starts
    torch.cuda.synchronize()
    t = time.perf_counter()
    fused = fstep(x, y).asnumpy().tolist()
    first_call_s = time.perf_counter() - t
    launched = mt.multi_tensor_update.launches - before
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    more = fstep(x, y).asnumpy()
    call_ms = (time.perf_counter() - t) * 1e3
    launched_all = mt.multi_tensor_update.launches  # ... and ends here
    graph = next(iter(fstep._graphs.values()))["graph"]
    rel = max(abs(a - c) / abs(c) for a, c in zip(fused, eager))
    falling = eager[-1] < eager[0] and fused[-1] < fused[0]
    ok = rel <= FUSED_LOSS_RTOL and falling and \
        launched == FUSED_STEP_K and \
        launched_all == 2 * FUSED_STEP_K and \
        bool(np.isfinite(more).all()) and len(fstep._graphs) == 1
    step_ms = call_ms / FUSED_STEP_K
    STASH["fused_resnet"] = dict(losses=fused, step_ms=step_ms)
    emit(dict(phase="fused_step_resnet", B=b, dtype="bfloat16",
              K=FUSED_STEP_K, lr=FUSED_RESNET_LR, losses=fused,
              eager_losses=eager, falling=falling,
              max_loss_rel_err=rel, tol=FUSED_LOSS_RTOL,
              eager_step_ms=eager_ms, first_call_s=first_call_s,
              call_ms=call_ms, step_ms=step_ms,
              images_per_s=b / step_ms * 1e3, next_losses=more.tolist(),
              multi_tensor_launches=launched_all,
              graph_replays=graph.replays, graph_pool_bytes=graph.pool_bytes,
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              ok=ok))
    if not ok:
        failures.append(f"fused step (resnet): losses {fused} vs eager "
                        f"{eager} (worst {rel}), update launches "
                        f"{launched}/{launched_all}")
    del net, tr, fstep, graph
    free_card(torch)
    return launched_all


# -- slice 8: BERT-base and stateless serving -------------------------------
BERT_VOCAB = 30522
BERT_B, BERT_T = 64, 128           # bench.py's _bench_bert protocol
BERT_LR = 1e-4
BERT_K = 8                          # bench.py's BENCH_STEPS_PER_EXEC
BERT_CHECK_B = 4
BERT_CHECK_LAYERS = 2
# phase 13 (f32, 2 layers, card against the CPU): each output within
# 1e-4 of its own largest value (two layers of f32 in other summation
# orders, no TF32); the loss within 1e-5 (relative) and every gradient
# within TRAIN_GRAD_TOL of its tensor's largest gradient, except the key
# projections' biases: their gradient is 0 in exact arithmetic (the bias
# adds the same q·b to every score of a query's row, which the softmax
# cancels), so both devices' values are rounding noise, held within
# TRAIN_GRAD_TOL of the same projection's weight gradient instead; after
# one Adam step every weight within 2.5 lr of the CPU's: Adam's first
# step moves a weight by lr·g/(|g| + eps), at most lr either way, and the
# sign of a noise gradient decides the direction
BERT_F32_TOL = 1e-4
BERT_LOSS_RTOL = 1e-5
# the bf16-amp forward against the f32 route on the same weights, each
# output by relative norm: bf16 rounding (u = 2^-8) of the products'
# operands and outputs through two layers, within 8u
BERT_AMP_NORM_TOL = 8 * 2.0 ** -8
# phases 14 and 14b: each bf16 reply against its request's solo forward
# (batch 1, unpadded, eager).  The batch runs other cuBLAS/cuDNN tile
# shapes, which round to bf16 at other places; through ResNet-50's 53
# layers or BERT-base's 12 that is held within 16u: the ResNet logits by
# relative norm, with the argmax equal or the reply's argmax class within
# 16u of the largest solo logit of the solo maximum; the BERT logits (two
# a request) each within 16u of the largest solo logit of the run (an
# argmax flip there is two close logits, and is counted)
SERVE_BF16_TOL = 16 * 2.0 ** -8
SERVE_REQUESTS = 64
SERVE_CLIENTS = 8
SERVE_MAX_BATCH = 32
SERVE_IMAGE = 224
# the first wave captures each bucket's graph it meets; the rates and
# latencies are read over the later eight (512 requests)
SERVE_WAVES = 9


def _bert_outputs(outs):
    return [o._data for o in (outs if isinstance(outs, tuple) else (outs,))]


def _share(torch, got, ref):
    """max |got - ref| over max |ref| (f32, on the CPU)."""
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).abs().max() /
            ref.abs().max().clamp_min(1e-30)).item()


def bert_check_phase(torch, mx, bert, fa, failures):
    """Phase 13: ``bert_base`` widths (units 768, ffn 3072, 12 heads,
    vocab 30522) at 2 layers, f32, B=4, T=128, dropout 0, weights from a
    seed on the CPU carried to the card: the unmasked forward through the
    flash kernel's FMA design and the ``valid_length`` forward through the
    masked route (no flash launch), both against the CPU; one MLM loss,
    backward and Adam step against the CPU; then amp's bf16 forward
    (the tensor-core kernel) against the f32 route on the same weights."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.convert import load_numpy_params

    free_card(torch)
    b, t = BERT_CHECK_B, BERT_T
    mx.random.seed(SEED)

    def make():
        return bert.bert_base(vocab_size=BERT_VOCAB,
                              num_layers=BERT_CHECK_LAYERS, dropout=0.0)

    gen = torch.Generator().manual_seed(SEED + 12)
    ids = torch.randint(0, BERT_VOCAB, (b, t), generator=gen,
                        dtype=torch.int32)
    seg = torch.randint(0, 2, (b, t), generator=gen, dtype=torch.int32)
    labels = torch.randint(0, BERT_VOCAB, (b, t), generator=gen,
                           dtype=torch.int32)
    lengths = torch.tensor([128.0, 77.0, 16.0, 1.0])
    cpu_net = make()
    cpu_net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    cpu_net(mx.nd.array(ids, ctx=mx.cpu()))
    arrays = {k: p.data().asnumpy() for k, p in
              cpu_net._collect_params_with_prefix().items()}
    gpu_net = make()
    load_numpy_params(gpu_net, arrays, ctx=mx.gpu(0))
    nets = {"gpu": (gpu_net, mx.gpu(0)), "cpu": (cpu_net, mx.cpu())}

    def inputs(ctx, with_length):
        out = [mx.nd.array(ids, ctx=ctx), mx.nd.array(seg, ctx=ctx)]
        return out + ([mx.nd.array(lengths, ctx=ctx)] if with_length else [])

    row = dict(phase="bert_check", net="bert_base", layers=BERT_CHECK_LAYERS,
               B=b, T=t, dtype="float32", tol=BERT_F32_TOL)
    ok = True
    for route, with_length in (("flash", False), ("masked", True)):
        outs = {}
        _zero_counts(fa)
        for key, (net, ctx) in nets.items():
            outs[key] = _bert_outputs(net(*inputs(ctx, with_length)))
        torch.cuda.synchronize()
        launches = [c.launches for c in _counters(fa)]
        mma = _mma_counts(fa)
        shares = [_share(torch, g, r) for g, r in zip(outs["gpu"],
                                                      outs["cpu"])]
        expect = [BERT_CHECK_LAYERS if route == "flash" else 0, 0, 0]
        finite = all(bool(torch.isfinite(o).all()) for o in outs["gpu"])
        good = finite and launches == expect and mma == [0, 0, 0] and \
            max(shares) <= BERT_F32_TOL
        row[f"{route}_output_err_shares"] = shares
        row[f"{route}_launches"] = launches
        ok = ok and good
        if route == "flash":
            f32_outs = outs["gpu"]
    # the bf16 amp forward (the tensor-core kernel) against f32, on the
    # same weights
    _zero_counts(fa)
    amp.init("bfloat16")
    try:
        amp_outs = _bert_outputs(gpu_net(*inputs(mx.gpu(0), False)))
        torch.cuda.synchronize()
    finally:
        amp.turn_off()
    norms = [_rel_norm(torch, a, r) for a, r in zip(amp_outs, f32_outs)]
    amp_mma = _mma_counts(fa)
    ok = ok and amp_mma == [BERT_CHECK_LAYERS, 0, 0] and \
        max(norms) <= BERT_AMP_NORM_TOL
    row.update(amp_bf16_rel_norms=norms, amp_tol=BERT_AMP_NORM_TOL,
               amp_launches_mma=amp_mma,
               amp_output_dtypes=[str(o.dtype) for o in amp_outs])
    # one MLM loss, backward and Adam step on each device
    losses, grads, weights = {}, {}, {}
    for key, (net, ctx) in nets.items():
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": BERT_LR})
        with mx.autograd.record():
            mlm = net(*inputs(ctx, False))[-1]
            loss = mx.nd.softmax_cross_entropy(
                mlm, mx.nd.array(labels, ctx=ctx)) / (b * t)
        loss.backward()
        losses[key] = float(loss.asscalar())
        params = net._collect_params_with_prefix()
        grads[key] = {k: p.grad()._data.detach().float().cpu()
                      for k, p in params.items()}
        trainer.step(1)
        weights[key] = {k: p.data()._data.detach().float().cpu()
                        for k, p in params.items()}
    def grad_share(k):
        g, ref = grads["gpu"][k], grads["cpu"][k]
        if not k.endswith("proj_key.bias"):
            return _share(torch, g, ref)
        scale = grads["cpu"][k[:-len("bias")] + "weight"]
        return ((g - ref).abs().max() / scale.abs().max()).item()

    grad_worst = max((grad_share(k), k) for k in grads["cpu"])
    weight_worst = max(((weights["gpu"][k] - w).abs().max().item(), k)
                       for k, w in weights["cpu"].items())
    loss_err = abs(losses["gpu"] - losses["cpu"]) / abs(losses["cpu"])
    ok = ok and loss_err <= BERT_LOSS_RTOL and \
        grad_worst[0] <= TRAIN_GRAD_TOL and \
        weight_worst[0] <= 2.5 * BERT_LR and math.isfinite(losses["gpu"])
    row.update(loss_gpu=losses["gpu"], loss_cpu=losses["cpu"],
               loss_rel_err=loss_err, loss_tol=BERT_LOSS_RTOL,
               worst_grad_err_share=grad_worst[0],
               worst_grad=grad_worst[1], grad_tol=TRAIN_GRAD_TOL,
               worst_weight_abs_err=weight_worst[0],
               worst_weight=weight_worst[1], weight_tol=2.5 * BERT_LR, ok=ok)
    emit(row)
    if not ok:
        failures.append(f"bert checks: {row}")
    del nets, gpu_net, cpu_net
    free_card(torch)


def bert_step_flops(net, b, t):
    """Operations of one BERT training step (forward and backward): 6 per
    matmul weight per token (the pooler and NSP head see one token a
    sequence), and the flash kernels' 7 products of 2·D a (query, key)
    pair a layer (forward 2, backward 5)."""
    tokens = b * t
    flops = 0.0
    for name, p in net._collect_params_with_prefix().items():
        if not name.endswith("weight") or "embed" in name or \
                name.endswith("position_weight"):
            continue
        per_seq = name.startswith(("pooler", "classifier"))
        flops += 6.0 * p.data().size * (b if per_seq else tokens)
    cells = list(net.encoder.transformer_cells)
    att = cells[0].attention
    d = att._units // att._num_heads
    flops += 7 * 2.0 * d * t * t * b * att._num_heads * len(cells)
    return flops


def bert_train_phase(torch, mx, bert, fa, mt, failures):
    """Phase 13b: the BERT training slice, ``bench.py``'s ``_bench_bert``
    protocol at full width and depth (``bert_base``, 12 layers, vocab
    30522, B=64, T=128, dropout 0.1): ``amp.init("bfloat16")``,
    ``hybridize(static_alloc=True)``, Adam at lr 1e-4, the MLM
    ``softmax_cross_entropy`` in a hybridized block.  One warm-up and
    three timed eager steps (``Trainer``), each 12 tensor-core launches of
    the forward, dQ and dK/dV kernels and one update launch, with the
    split into forward, backward and update beside the reckoned bound;
    then ``FusedTrainStep`` with K=8 (the capture, then a timed call of 8
    replays)."""
    from mxnet_tpu_torch import amp

    free_card(torch)
    t0 = time.perf_counter()
    b, t = BERT_B, BERT_T
    mx.random.seed(SEED)
    net = bert.bert_base(vocab_size=BERT_VOCAB)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    ids = mx.nd.array(torch.randint(0, BERT_VOCAB, (b, t), generator=gen,
                                    device="cuda", dtype=torch.int32))
    seg = mx.nd.zeros((b, t), ctx=mx.gpu(0), dtype="int32")
    labels = mx.nd.array(torch.randint(0, BERT_VOCAB, (b, t),
                                       generator=gen, device="cuda",
                                       dtype=torch.int32))
    net(ids, seg)  # resolve deferred shapes
    torch.cuda.synchronize()
    n_params = sum(p.data().size for p in net.collect_params().values())
    layers = len(net.encoder.transformer_cells)
    flops = bert_step_flops(net, b, t)
    bound = flops / PEAK_FLOPS["bfloat16"] * 1e3
    emit(dict(phase="bert_train_init", seconds=time.perf_counter() - t0,
              params=n_params, layers=layers, step_flops=flops,
              step_bound_ms=bound, memory_allocated=
              torch.cuda.memory_allocated()))

    class MLMLoss(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, mlm, lab):
            return F.softmax_cross_entropy(mlm, lab) / (b * t)

    amp.init("bfloat16")
    try:
        net.hybridize(static_alloc=True)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": BERT_LR})
        loss_fn = MLMLoss()
        loss_fn.hybridize()
        _zero_counts(fa)  # the main path starts here
        mt.multi_tensor_update.launches = 0
        losses, step_ms = [], []
        for step in range(4):
            stamps, peaks = [], []

            def mark():
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                peaks.append(torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()

            before = _mma_counts(fa) + [mt.multi_tensor_update.launches]
            mark()
            peaks.clear()
            with mx.autograd.record():
                loss = loss_fn(net(ids, seg)[-1], labels)
            mark()
            loss.backward()
            mark()
            trainer.step(1)
            mark()
            after = _mma_counts(fa) + [mt.multi_tensor_update.launches]
            launched = [a - c for a, c in zip(after, before)]
            fwd_ms, bwd_ms, upd_ms = ((s1 - s0) * 1e3 for s0, s1 in
                                      zip(stamps, stamps[1:]))
            ms = (stamps[-1] - stamps[0]) * 1e3
            value = float(loss.asscalar())
            losses.append(value)
            if step:
                step_ms.append(ms)
            good = math.isfinite(value) and \
                launched == [layers, layers, layers, 1]
            emit(dict(phase="bert_train_step", step=step, warmup=step == 0,
                      B=b, T=t, loss=value, ms=ms,
                      samples_per_s=b / ms * 1e3, forward_ms=fwd_ms,
                      backward_ms=bwd_ms, update_ms=upd_ms,
                      step_bound_ms=bound,
                      update_bound_ms=update_bound_ms(trainer),
                      launches_mma_fwd_dq_dkv_update=launched,
                      max_memory_allocated=dict(zip(
                          ("forward", "backward", "update"), peaks)),
                      ok=good))
            if not good:
                failures.append(f"bert train step {step}: loss {value}, "
                                f"launches {launched}")
        eager_counts = [c.launches for c in _counters(fa)]
        # the last eager loss holds its (freed) graph, and with it the
        # parameters' gradient accumulators, made on the eager stream: a
        # capture that meets them fails, so it goes first
        del loss
        # FusedTrainStep: K steps a call, one captured graph replayed
        fstep = mx.gluon.FusedTrainStep(
            net, trainer, lambda n, i, s, lab: loss_fn(n(i, s)[-1], lab),
            steps_per_execution=BERT_K, batch_size=1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        first = fstep(ids, seg, labels).asnumpy()
        first_s = time.perf_counter() - t1
        torch.cuda.reset_peak_memory_stats()
        before = [c.launches for c in _counters(fa)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        more = fstep(ids, seg, labels).asnumpy()
        call_ms = (time.perf_counter() - t1) * 1e3
        replayed = [c.launches - n for c, n in zip(_counters(fa), before)]
        peak = torch.cuda.max_memory_allocated()
        counts = [c.launches for c in _counters(fa)]  # ... and ends here
        mma = _mma_counts(fa)
        update_launches = mt.multi_tensor_update.launches
        graph = next(iter(fstep._graphs.values()))["graph"]
        kernel_ms, tensors = update_kernel_ms(torch, mt, trainer, 10)
    finally:
        amp.turn_off()
        net.hybridize(False)
    step = call_ms / BERT_K
    finite = bool(np.isfinite(first).all() and np.isfinite(more).all())
    good = finite and replayed == [BERT_K * layers] * 3 and \
        counts == mma and len(fstep._graphs) == 1 and \
        update_launches == 4 + 2 * BERT_K
    emit(dict(phase="bert_fused_step", B=b, T=t, K=BERT_K, lr=BERT_LR,
              losses=first.tolist(), next_losses=more.tolist(),
              eager_losses=losses, first_call_s=first_s, call_ms=call_ms,
              step_ms=step, samples_per_s=b / step * 1e3,
              eager_step_ms=step_ms, step_bound_ms=bound,
              launches_per_call=replayed, eager_launches=eager_counts,
              update_kernel_ms=kernel_ms, update_tensors=tensors,
              update_launches=update_launches,
              graph_replays=graph.replays, graph_pool_bytes=graph.pool_bytes,
              max_memory_allocated=peak, ok=good))
    if not good:
        failures.append(f"bert fused step: losses {first} {more}, "
                        f"launches a call {replayed}, all {counts} "
                        f"(tensor-core {mma}), update {update_launches}")
    del net, trainer, fstep, graph
    free_card(torch)
    return counts, mma, update_launches


def _percentile(values, q):
    v = sorted(values)
    return v[min(len(v) - 1, int(round(q / 100.0 * (len(v) - 1))))]


def _serve_waves(serving, model, config, requests, cache_stats,
                 waves=SERVE_WAVES, before_stop=None):
    """Serve ``requests`` (numpy arrays) through an ``InferenceServer``
    from SERVE_CLIENTS client threads, each submitting its share and then
    waiting for it, ``waves`` times over one live server; returns every
    wave's replies, each wave's timing and captures (``cache_stats()``'s
    misses in it), the rates and latencies over the waves after the
    first (and the rate over those of them that captured nothing), and
    the server's stats.  ``before_stop(server)`` runs after the last
    wave, while the server still runs."""
    import threading

    srv = serving.InferenceServer(model, config)
    replies_by_wave, stats, later_lat = [], [], []
    with srv:
        for w in range(waves):
            replies = [None] * len(requests)
            lat = [None] * len(requests)
            errors = []

            def client(ids):
                futs = []
                for i in ids:
                    t_sub = time.perf_counter()
                    f = srv.submit(requests[i])
                    f.add_done_callback(
                        lambda _f, i=i, t_sub=t_sub: lat.__setitem__(
                            i, (time.perf_counter() - t_sub) * 1e3))
                    futs.append((i, f))
                for i, f in futs:
                    try:
                        replies[i] = f.result(timeout=600)
                    except Exception as e:  # noqa: BLE001 - reported
                        errors.append(repr(e))

            before = srv.stats()["batches"]
            misses = cache_stats()["misses"]
            t = time.perf_counter()
            threads = [threading.Thread(
                target=client, args=(range(j, len(requests),
                                           SERVE_CLIENTS),))
                for j in range(SERVE_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(900)
            wall = time.perf_counter() - t
            done = [x for x in lat if x is not None]
            if w:
                later_lat += done
            replies_by_wave.append(replies)
            stats.append(dict(
                wall_s=wall, requests_per_s=len(requests) / wall,
                p50_ms=_percentile(done, 50), p99_ms=_percentile(done, 99),
                batches=srv.stats()["batches"] - before,
                captures=cache_stats()["misses"] - misses, errors=errors))
        if before_stop is not None:
            before_stop(srv)
    later = stats[1:]
    steady = [w for w in later if not w["captures"]]

    def rate(ws):
        return len(requests) * len(ws) / sum(w["wall_s"] for w in ws) \
            if ws else None

    summary = dict(
        requests=len(requests) * len(later), requests_per_s=rate(later),
        p50_ms=_percentile(later_lat, 50), p99_ms=_percentile(later_lat, 99),
        captures=sum(w["captures"] for w in later),
        waves_without_capture=len(steady),
        requests_per_s_without_capture=rate(steady))
    return replies_by_wave, stats, summary, srv.stats()


def resnet_serve_phase(torch, mx, vision, cbr, serving, failures):
    """Phase 14: ``resnet50_v1`` in bf16 (hybridized, 224x224) through
    ``InferenceServer``: 64 requests from 8 client threads, nine waves
    over one live server (the first captures a CUDA graph for each batch
    bucket it meets on the scheduler thread, the later ones replay them;
    the rate and latencies are read over the later eight),
    ``max_batch`` 32, one length bucket at 224.  Each reply against its
    request's solo forward (eager, batch 1, run before the server
    starts); 16 fused launches a batch forward; signatures within the
    policy's ceiling.  The model is a callable around the block: numpy,
    the request format, has no bfloat16, so it makes the batch a bf16
    array on the card and calls the hybridized net."""
    free_card(torch)
    gpu = mx.gpu(0)
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=gpu)
    net(mx.nd.zeros((1, 3, SERVE_IMAGE, SERVE_IMAGE), ctx=gpu))
    net.cast("bfloat16")
    rng = np.random.RandomState(SEED + 14)
    images = [rng.rand(3, SERVE_IMAGE, SERVE_IMAGE).astype(np.float32)
              for _ in range(SERVE_REQUESTS)]

    def forward(batch):
        return net(mx.nd.array(batch, ctx=gpu, dtype="bfloat16"))

    solo = [forward(x[None])._data.float().cpu()[0] for x in images]
    net.hybridize(static_alloc=True)
    config = serving.ServerConfig(
        max_batch=SERVE_MAX_BATCH, min_batch=1, max_length=SERVE_IMAGE,
        min_length=SERVE_IMAGE, length_axis=1, batch_window_ms=5.0,
        queue_capacity=SERVE_REQUESTS)
    fn = cbr.fused_matmul_affine_relu
    fn.launches = fn.launches_mma = 0  # the main path starts here
    replies, waves, rate, stats = _serve_waves(
        serving, lambda b: forward(b["data"]), config, images,
        net.cache_stats)
    launches, mma = fn.launches, fn.launches_mma  # ... and ends here
    cache = net.cache_stats()
    worst_norm, flips = 0.0, 0
    for got, ref in ((g, r) for wave in replies
                     for g, r in zip(wave, solo)):
        got = torch.from_numpy(np.asarray(got, np.float32))
        worst_norm = max(worst_norm, _rel_norm(torch, got, ref))
        top = int(got.argmax())
        if top != int(ref.argmax()):
            flips += 1
            if ref.max() - ref[top] > SERVE_BF16_TOL * ref.abs().max():
                worst_norm = float("inf")
    ceiling = len(config.policy.signatures())
    batches = stats["batches"]
    ok = all(r is not None for wave in replies for r in wave) and \
        not any(w["errors"] for w in waves) and \
        worst_norm <= SERVE_BF16_TOL and launches == 16 * batches and \
        mma == launches and cache["signatures"] <= ceiling and \
        cache["misses"] == cache["signatures"] and stats["failed"] == 0
    STASH["resnet_serve"] = dict(images_per_s=rate["requests_per_s"],
                                 p50_ms=rate["p50_ms"], p99_ms=rate["p99_ms"])
    emit(dict(phase="resnet_serve", net="resnet50_v1", dtype="bfloat16",
              image=SERVE_IMAGE, requests=SERVE_REQUESTS,
              clients=SERVE_CLIENTS,
              max_batch=SERVE_MAX_BATCH, waves=waves,
              images_per_s=rate["requests_per_s"], after_first_wave=rate,
              batches=batches, fused_launches=launches,
              fused_launches_mma=mma, cache_stats=cache,
              signature_ceiling=ceiling, worst_rel_norm=worst_norm,
              argmax_flips=flips, tol=SERVE_BF16_TOL, ok=ok))
    if not ok:
        failures.append(f"resnet serving: worst rel norm {worst_norm}, "
                        f"launches {launches} for {batches} batches, "
                        f"cache {cache}, errors "
                        f"{[w['errors'] for w in waves]}")
    net.hybridize(False)
    del net
    free_card(torch)
    return launches, mma


def bert_serve_phase(torch, mx, bert, fa, serving, failures):
    """Phase 14b: a BERT-base sequence classifier
    (``BERTClassifier(bert_base(...))``, pooler only, 2 classes) in bf16,
    hybridized, through ``InferenceServer`` as a callable that builds
    ``valid_length`` from the padded ids (pad id 0, as ``pad_batch``
    pads): 64 requests of 16-128 tokens (lengths from the seed), length
    buckets 16-128, nine waves (rate and latencies read over the later
    eight).  Each reply against its request's solo forward (eager,
    unpadded); the masked route launches no flash kernel."""
    free_card(torch)
    gpu = mx.gpu(0)
    mx.random.seed(SEED)
    net = bert.BERTClassifier(bert.bert_base(
        vocab_size=BERT_VOCAB, use_decoder=False, use_classifier=False),
        num_classes=2)
    net.initialize(mx.init.Xavier(), ctx=gpu)
    net(mx.nd.ones((1, 16), ctx=gpu, dtype="int32"))
    net.cast("bfloat16")
    rng = np.random.RandomState(SEED + 15)
    lengths = rng.randint(16, BERT_T + 1, SERVE_REQUESTS)
    requests = [rng.randint(1, BERT_VOCAB, n).astype(np.int32)
                for n in lengths]

    def classify(batch):
        ids = batch["data"]
        vl = (ids != 0).sum(axis=1).astype(np.float32)
        return net(mx.nd.array(ids, ctx=gpu, dtype="int32"), None,
                   mx.nd.array(vl, ctx=gpu))

    solo = [classify({"data": r[None]})._data.float().cpu()[0]
            for r in requests]
    net.hybridize(static_alloc=True)
    config = serving.ServerConfig(
        max_batch=SERVE_MAX_BATCH, min_batch=1, max_length=BERT_T,
        min_length=16, batch_window_ms=5.0, queue_capacity=SERVE_REQUESTS)
    _zero_counts(fa)  # the main path starts here
    replies, waves, rate, stats = _serve_waves(
        serving, classify, config, requests, net.cache_stats)
    flash = [c.launches for c in _counters(fa)]  # ... and ends here
    cache = net.cache_stats()
    scale = max(s.abs().max().item() for s in solo)
    worst, flips = 0.0, 0
    for got, ref in ((g, r) for wave in replies
                     for g, r in zip(wave, solo)):
        got = torch.from_numpy(np.asarray(got, np.float32))
        worst = max(worst, (got - ref).abs().max().item() / scale)
        if int(got.argmax()) != int(ref.argmax()):
            flips += 1
    ceiling = len(config.policy.signatures())
    ok = all(r is not None for wave in replies for r in wave) and \
        not any(w["errors"] for w in waves) and \
        worst <= SERVE_BF16_TOL and flash == [0, 0, 0] and \
        cache["signatures"] <= ceiling and \
        cache["misses"] == cache["signatures"] and stats["failed"] == 0
    emit(dict(phase="bert_serve", net="BERTClassifier(bert_base)",
              dtype="bfloat16", requests=SERVE_REQUESTS,
              clients=SERVE_CLIENTS, max_batch=SERVE_MAX_BATCH,
              lengths=[int(n) for n in lengths], waves=waves,
              requests_per_s=rate["requests_per_s"], after_first_wave=rate,
              batches=stats["batches"], flash_launches=flash,
              cache_stats=cache, signature_ceiling=ceiling,
              worst_err_share=worst, argmax_flips=flips,
              tol=SERVE_BF16_TOL, ok=ok))
    if not ok:
        failures.append(f"bert serving: worst {worst}, flash launches "
                        f"{flash}, cache {cache}, errors "
                        f"{[w['errors'] for w in waves]}")
    net.hybridize(False)
    del net
    free_card(torch)


# -- slice 9: the rest of the vision model zoo -------------------------------
# (net, image side, launches of the fused kernel a forward): the three nets
# whose 1x1 Conv2D -> BatchNorm -> ReLU runs fuse in inference
ZOO_FUSED = [("mobilenet1.0", 224, 13), ("inceptionv3", 299, 40),
             ("densenet121", 224, 58)]
ZOO_B = 128
# phase 15: every family at full width, f32, B=2, card against the CPU
ZOO_F32 = [("alexnet", 224, 0), ("vgg16_bn", 224, 0),
           ("squeezenet1.1", 224, 0), ("densenet121", 224, 58),
           ("inceptionv3", 299, 40), ("mobilenet1.0", 224, 13),
           ("mobilenetv2_1.0", 224, 0)]
ZOO_F32_TOL = 1e-3  # of the largest logit, as phase 10's ResNet-50
# phase 15c: the Inception-v3 paper's RMSProp (Szegedy et al. 2016, §8:
# decay 0.9, epsilon 1.0, gradients clipped at 2.0) at its lr 0.045
INCEPTION_LR = 0.045
INCEPTION_K = 8


def zoo_shapes(torch, mx, vision, cbr):
    """Each net of ``ZOO_FUSED``: its distinct fused (M, K, N) at B=1, with
    the number of launches of each in one forward, read off a forward on
    the CPU (the kernel's plain version) through a recording wrapper of
    ``fused_matmul_affine_relu`` that ``conv1x1_bn_relu`` looks up."""
    orig = cbr.fused_matmul_affine_relu
    seen = []

    def record(x, w, scale, bias):
        seen.append((x.shape[0], x.shape[1], w.shape[1]))
        return orig(x, w, scale, bias)

    out = {}
    cbr.fused_matmul_affine_relu = record
    try:
        for name, image, _ in ZOO_FUSED:
            seen.clear()
            net = vision.get_model(name)
            net.initialize(ctx=mx.cpu())
            net(mx.nd.zeros((1, 3, image, image), ctx=mx.cpu()))
            counts = {}
            for s in seen:
                counts[s] = counts.get(s, 0) + 1
            out[name] = sorted(counts.items())
    finally:
        cbr.fused_matmul_affine_relu = orig
    return out


def zoo_kernel_phase(torch, cbr, shapes, failures):
    """Phase 5 at the new shapes: the fused kernel against its plain
    version at every distinct bf16 shape of the three nets at B=128,
    with its time, bound, the plain version's and cuBLAS ``addmm`` +
    ``relu``'s (the scale folded into w), then each net's forward summed
    over its launches."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 20)
    dt = "bfloat16"
    nets = {}
    for name, _, per_net in ZOO_FUSED:
        rows = []
        for (m1, k, n), per_fwd in shapes[name]:
            m = m1 * ZOO_B
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            w = (torch.randn(k, n, generator=gen, device="cuda") /
                 math.sqrt(k)).bfloat16()
            scale = torch.rand(n, generator=gen, device="cuda") + 0.5
            bias = torch.rand(n, generator=gen, device="cuda") - 0.5
            got = cbr.fused_matmul_affine_relu(x, w, scale, bias)
            ref = cbr._fused_matmul_affine_relu_plain(x.float(), w.float(),
                                                      scale, bias)
            diff = (got.float() - ref).abs()
            largest = ref.abs().max().item()
            ok = bool((diff <= FUSED_REL_TOL[dt] * ref.abs() +
                       FUSED_ABS_TOL[dt] * largest).all()) and \
                got.shape == (m, n) and bool(torch.isfinite(got).all())
            err = diff.max().item()
            iters = 20 if m * k * n > 1e9 else 100
            w_lib = (w.float() * scale).bfloat16()
            b_lib = bias.bfloat16()
            row = dict(
                phase="fused_kernel_zoo", net=name, M=m, K=k, N=n,
                launches_per_forward=per_fwd, max_abs_err=err,
                max_abs_ref=largest,
                kernel_ms=time_ms(torch, lambda: cbr.fused_matmul_affine_relu(
                    x, w, scale, bias), iters),
                plain_ms=time_ms(
                    torch, lambda: cbr._fused_matmul_affine_relu_plain(
                        x, w, scale, bias), max(iters // 4, 5)),
                library_ms=time_ms(torch, lambda: torch.relu(torch.addmm(
                    b_lib, x, w_lib)), iters))
            row["bound_ms"], row["bound_by"] = roofline_ms(
                2.0 * m * k * n, 2 * (m * k + k * n + m * n) + 8 * n, dt)
            row["ok"] = ok
            emit(row)
            rows.append(row)
            if not ok:
                failures.append(f"fused kernel {name} ({m}, {k}, {n}): "
                                f"max err {err} (largest {largest})")
            del x, w, got, ref, diff
        total = dict(phase="fused_kernel_zoo_forward", net=name, B=ZOO_B,
                     dtype=dt, shapes=len(rows),
                     launches=sum(r["launches_per_forward"] for r in rows),
                     max_abs_err=max(r["max_abs_err"] for r in rows),
                     **{key: sum(r[key] * r["launches_per_forward"]
                                 for r in rows)
                        for key in ("kernel_ms", "bound_ms", "plain_ms",
                                    "library_ms")})
        total["gflop"] = sum(2.0 * r["M"] * r["K"] * r["N"] *
                             r["launches_per_forward"] for r in rows) * 1e-9
        by_bytes = sum(r["bound_ms"] * r["launches_per_forward"]
                       for r in rows if r["bound_by"] == "bytes")
        total["bound_by"] = "bytes" if 2 * by_bytes >= total["bound_ms"] \
            else "operations"
        total["shapes_losing_to_library"] = sum(
            r["kernel_ms"] > r["library_ms"] for r in rows)
        total["ok"] = total["launches"] == per_net
        emit(total)
        if not total["ok"]:
            failures.append(f"{name}: {total['launches']} fused launches a "
                            f"forward in the probe, expected {per_net}")
        nets[name] = total
    return nets


def zoo_f32_phase(torch, mx, vision, cbr, failures):
    """Phase 15: each family at full width in f32, B=2, weights drawn on
    the CPU from the seed: the card's forward (the fused kernel's FMA
    design where 1x1 runs fuse, no TF32) against the CPU's (the plain
    version)."""
    from mxnet_tpu_torch.convert import load_numpy_params

    fn = cbr.fused_matmul_affine_relu
    for name, image, expected in ZOO_F32:
        free_card(torch)
        shape = (2, 3, image, image)
        arrays = _resnet_arrays(torch, mx, lambda: vision.get_model(name),
                                shape)
        x = torch.rand(shape,
                       generator=torch.Generator().manual_seed(SEED + 21))
        cpu_net, gpu_net = vision.get_model(name), vision.get_model(name)
        load_numpy_params(cpu_net, arrays, ctx=mx.cpu())
        load_numpy_params(gpu_net, arrays, ctx=mx.gpu(0))
        before = (fn.launches, fn.launches_mma)
        got = gpu_net(mx.nd.array(x, ctx=mx.gpu(0)))._data.float().cpu()
        launched = fn.launches - before[0]
        mma = fn.launches_mma - before[1]
        ref = cpu_net(mx.nd.array(x, ctx=mx.cpu()))._data
        largest = ref.abs().max().item()
        share = (got - ref).abs().max().item() / largest
        ok = launched == expected and mma == 0 and \
            share <= ZOO_F32_TOL and got.shape == (2, 1000) and \
            bool(torch.isfinite(got).all())
        emit(dict(phase="zoo_f32_check", net=name, B=2, image=image,
                  params=sum(a.size for a in arrays.values()),
                  launches=launched, launches_mma=mma,
                  max_abs_logit=largest, max_err_share=share,
                  tol=ZOO_F32_TOL, ok=ok))
        if not ok:
            failures.append(f"{name} f32 check: launches {launched} "
                            f"(expected {expected}, tensor-core {mma}), "
                            f"error share {share}")
        del cpu_net, gpu_net, arrays
    free_card(torch)


def _copy_probe(torch, mx, net, x):
    """One forward of ``net`` on ``x`` through a wrapper of the fused
    path's ``conv1x1_bn_relu`` that times the NCHW -> (M, K) copy it
    makes where its input is not channels-last already: (calls, copies,
    summed copy ms)."""
    from mxnet_tpu_torch.gluon.nn import basic_layers

    orig = basic_layers.conv1x1_bn_relu
    stats = [0, 0, 0.0]

    def probe(x, weight, *rest):
        sh, sw = rest[-2]
        xs = x[:, :, ::sh, ::sw] if (sh, sw) != (1, 1) else x
        stats[0] += 1
        if not xs.permute(0, 2, 3, 1).is_contiguous():
            stats[1] += 1
            stats[2] += time_ms(torch, lambda: xs.permute(0, 2, 3, 1).reshape(
                -1, xs.shape[1]).contiguous(), 5)
        return orig(x, weight, *rest)

    basic_layers.conv1x1_bn_relu = probe
    try:
        net(x)
    finally:
        basic_layers.conv1x1_bn_relu = orig
    torch.cuda.synchronize()
    return tuple(stats)


def zoo_infer_phase(torch, mx, vision, cbr, failures):
    """Phase 15b: ``mobilenet1.0`` and ``densenet121`` at 224x224 and
    ``inceptionv3`` at 299x299, bf16, B=128: four eager forwards, then
    hybridized (the first call captures, the next replay), each forward
    launching the fused kernel's tensor-core design exactly 13, 58 and 40
    times; the replayed logits against the eager ones, images/s, and the
    NCHW -> (M, K) copies of the fused path (a probe forward before the
    counted path)."""
    fn = cbr.fused_matmul_affine_relu
    per_net = {}
    for name, image, expected in ZOO_FUSED:
        free_card(torch)
        mx.random.seed(SEED)
        net = vision.get_model(name)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net.cast("bfloat16")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 22)
        x = mx.nd.array(torch.rand((ZOO_B, 3, image, image), generator=gen,
                                   device="cuda").bfloat16())
        net(x[0:1])  # resolve deferred shapes
        calls, copies, copy_ms = _copy_probe(torch, mx, net, x)
        torch.cuda.synchronize()
        fn.launches = fn.launches_mma = 0  # this net's main path starts
        runs = {}
        for mode in ("eager", "graph"):
            if mode == "graph":
                net.hybridize(static_alloc=True, static_shape=True)
            torch.cuda.reset_peak_memory_stats()
            ms, launched = [], []
            for _ in range(4):
                before = (fn.launches, fn.launches_mma)
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = net(x)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                launched.append((fn.launches - before[0],
                                 fn.launches_mma - before[1]))
            runs[mode] = dict(out=out._data, ms=ms, launched=launched,
                              warm_ms=sum(ms[1:]) / 3,
                              peak=torch.cuda.max_memory_allocated())
            del out
        launches, launches_mma = fn.launches, fn.launches_mma  # ... ends
        eager, graph = runs["eager"], runs["graph"]
        diff = (graph["out"].float() - eager["out"].float()).abs().max()
        tol = GRAPH_BF16_TOL * eager["out"].float().abs().max().item()
        finite = bool(torch.isfinite(eager["out"]).all())
        ok = eager["launched"] == [(expected, expected)] * 4 and \
            graph["launched"] == [(expected, expected)] * 4 and \
            diff.item() <= tol and finite and \
            tuple(eager["out"].shape) == (ZOO_B, 1000)
        row = dict(phase="zoo_infer", net=name, B=ZOO_B, image=image,
                   dtype="bfloat16",
                   launches_per_forward=[n for n, _ in eager["launched"]],
                   launches_mma_per_forward=[
                       n for _, n in eager["launched"] + graph["launched"]],
                   eager_ms=eager["ms"], graph_ms=graph["ms"],
                   eager_images_per_s=ZOO_B / eager["warm_ms"] * 1e3,
                   graph_images_per_s=ZOO_B / graph["warm_ms"] * 1e3,
                   max_abs_diff_graph=diff.item(), tol=tol,
                   identical_to_eager=bool(torch.equal(graph["out"],
                                                       eager["out"])),
                   fused_calls=calls, nchw_to_mk_copies=copies,
                   nchw_to_mk_copy_ms=copy_ms,
                   eager_peak_bytes=eager["peak"],
                   graph_peak_bytes=graph["peak"],
                   cache_stats=net.cache_stats(), finite=finite, ok=ok)
        emit(row)
        if not ok:
            failures.append(f"{name} bf16 inference: launches (all, "
                            f"tensor-core) {eager['launched']} / "
                            f"{graph['launched']}, expected {expected} a "
                            f"forward; graph diff {diff.item()} (tol {tol})")
        per_net[name] = (launches, launches_mma)
        net.hybridize(False)
        del net, x, runs, eager, graph
    free_card(torch)
    return per_net


def inception_train_phase(torch, mx, vision, cbr, mt, failures):
    """Phase 15c: ``inceptionv3`` at full width, 299x299, bf16, B=128,
    through the image-classification loop: ``SoftmaxCrossEntropyLoss``,
    ``gluon.Trainer`` with RMSProp (decay 0.9, epsilon 1.0, gradients
    clipped at 2.0, lr ``INCEPTION_LR``), ``metric.Accuracy`` and
    ``TopKAccuracy(5)`` updated each step and ``callback.Speedometer``:
    eight eager steps on one batch (the first the warm-up), then
    ``FusedTrainStep`` with K=8 on a fresh net from the same seed: its
    eight losses against the eager eight, both falling, then one timed
    call.  RMSProp has no rule code of the fused update kernel, so no
    multi-tensor launch; BatchNorm normalizes by the batch while
    recording, so no fused conv launch either."""
    import logging

    free_card(torch)
    kw = {"learning_rate": INCEPTION_LR, "gamma1": 0.9, "epsilon": 1.0,
          "clip_gradient": 2.0}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 23)
    x = mx.nd.array(torch.rand((ZOO_B, 3, 299, 299), generator=gen,
                               device="cuda").bfloat16())
    y = mx.nd.array(torch.randint(0, 1000, (ZOO_B,), generator=gen,
                                  device="cuda").float())
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def make():
        mx.random.seed(SEED)
        net = vision.inception_v3(classes=1000)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net(mx.nd.zeros((1, 3, 299, 299), ctx=mx.gpu(0)))
        net.cast("bfloat16")
        return net, mx.gluon.Trainer(net.collect_params(), "rmsprop",
                                     dict(kw))

    logged = []

    class _Keep(logging.Handler):
        def emit(self, record):
            logged.append(record.getMessage())

    handler = _Keep(level=logging.INFO)
    root = logging.getLogger()
    old_level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    fn = cbr.fused_matmul_affine_relu
    fused_launches = 0  # while training (make()'s shape pass runs it)
    mt_before = mt.multi_tensor_update.launches
    try:
        net, tr = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = fn.launches
        metric = mx.metric.CompositeEvalMetric(
            [mx.metric.Accuracy(), mx.metric.TopKAccuracy(5)])
        speed = mx.callback.Speedometer(ZOO_B, frequent=1,
                                        auto_reset=False)
        eager, eager_ms = [], []
        for step in range(INCEPTION_K):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with mx.autograd.record():
                out = net(x)
                loss = loss_fn(out, y)
            loss.backward()
            tr.step(ZOO_B)
            metric.update([y], [out])
            speed(mx.callback.BatchEndParam(0, step, metric))
            eager.append(float(loss.sum().asscalar()))
            eager_ms.append((time.perf_counter() - t) * 1e3)
        names, values = metric.get()
        fused_launches += fn.launches - before
        eager_peak = torch.cuda.max_memory_allocated()
        del net, tr, out, loss
        free_card(torch)
        net, tr = make()
        fstep = mx.gluon.FusedTrainStep(
            net, tr, lambda n, a, c: loss_fn(n(a), c),
            steps_per_execution=INCEPTION_K, batch_size=ZOO_B)
        torch.cuda.synchronize()
        before = fn.launches
        t = time.perf_counter()
        fused = fstep(x, y).asnumpy().tolist()
        first_call_s = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        more = fstep(x, y).asnumpy()
        call_ms = (time.perf_counter() - t) * 1e3
        fused_launches += fn.launches - before
    finally:
        root.removeHandler(handler)
        root.setLevel(old_level)
    mt_launches = mt.multi_tensor_update.launches - mt_before
    graph = next(iter(fstep._graphs.values()))["graph"]
    rel = max(abs(a - c) / abs(c) for a, c in zip(fused, eager))
    falling = eager[-1] < eager[0] and fused[-1] < fused[0]
    step_ms = call_ms / INCEPTION_K
    warm = sum(eager_ms[1:4]) / 3
    ok = rel <= FUSED_LOSS_RTOL and falling and mt_launches == 0 and \
        fused_launches == 0 and bool(np.isfinite(more).all()) and \
        len(fstep._graphs) == 1 and len(logged) >= INCEPTION_K - 1
    emit(dict(phase="inception_train", B=ZOO_B, image=299,
              dtype="bfloat16", optimizer="rmsprop", **kw,
              K=INCEPTION_K, eager_losses=eager, fused_losses=fused,
              falling=falling, max_loss_rel_err=rel, tol=FUSED_LOSS_RTOL,
              eager_step_ms=eager_ms, eager_warm_ms=warm,
              eager_images_per_s=ZOO_B / warm * 1e3,
              metrics=dict(zip(names, values)),
              speedometer_lines=len(logged),
              speedometer_last=logged[-1] if logged else None,
              first_call_s=first_call_s, call_ms=call_ms, step_ms=step_ms,
              images_per_s=ZOO_B / step_ms * 1e3,
              next_losses=more.tolist(), graph_replays=graph.replays,
              graph_pool_bytes=graph.pool_bytes,
              eager_peak_bytes=eager_peak,
              replay_peak_bytes_outside_pool=torch.cuda.max_memory_allocated(),
              multi_tensor_launches=mt_launches,
              fused_conv_launches=fused_launches, ok=ok))
    if not ok:
        failures.append(f"inception training: eager {eager}, fused {fused} "
                        f"(worst {rel}), multi-tensor launches "
                        f"{mt_launches}, fused conv launches "
                        f"{fused_launches}, speedometer lines {len(logged)}")
    del net, tr, fstep, graph
    free_card(torch)


# -- slice 10: the data plane -------------------------------------------------
# The image lane (phase 16): ImageNet-style JPEG shards, the short side 256
# as ``im2rec --resize 256`` writes them, smooth random textures (so that
# the encoded sizes are realistic), quality 95; ``resnet50_v1`` bf16, B=128.
IMG_N = 1280                 # 10 batches of 128
IMG_VAL_N = 256              # the validation shard: two eval forwards
IMG_SHARDS = 4
IMG_B = 128
IMG_SHORT, IMG_LONG = 256, 384
IMG_QUALITY = 95
IMG_MEAN = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53,
                std_r=58.395, std_g=57.12, std_b=57.375)
IMG_LR = 0.01                # FusedTrainStep's (phase 12b); eager 0.1
IMG_STEPS = 4                # timed eager steps a feed (after 2 warm-ups)
IMG_CALLS = 3                # timed FusedTrainStep calls a feed (K=8)
IMG_SWITCH_S = 0.0005        # the interpreter's switch interval, one row
IMG_WORKER_ROWS = (2, 8)     # decode threads of the prefetcher rows beside
                             # the default (half the host's cores)
# The packed-LLM lane (phase 17): ``llama3_8b`` widths, 16 layers (the
# training slice's depth), bf16, B=1, T=2048; documents log-uniform over
# 32-2048 tokens, one a record, eight drawn a step.
PACK_LAYERS = 16
PACK_B, PACK_T = 1, 2048
PACK_DOCS = 512
PACK_DOCS_PER_STEP = 8
PACK_WARMUP = 2              # the first update makes the momentum
PACK_STEPS = 5               # states, so the second step still allocates


def _card():
    """The card's name and power limit, as ``nvidia-smi`` gives them
    (printed beside every data-plane measurement)."""
    return run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]


def _texture(cv2, i):
    """Image i of the lane: a coarse random field resized up (smooth
    shapes), plus a per-pixel grain; short side 256, long side 256-384,
    every third image portrait."""
    rng = np.random.RandomState(SEED * 7919 + i)
    long_side = int(rng.randint(IMG_SHORT, IMG_LONG + 1))
    h, w = (IMG_SHORT, long_side) if i % 3 else (long_side, IMG_SHORT)
    coarse = rng.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3))
    img = cv2.resize(coarse.astype(np.uint8), (w, h),
                     interpolation=cv2.INTER_CUBIC).astype(np.int16)
    img += rng.randint(-12, 13, (h, w, 1)).astype(np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_image_shards(mx, root):
    """``train.rec`` (1,280 images) for ``ImageRecordIter`` and
    ``ImageRecordDataset``, the same records in four ``part*.rec`` shards
    for ``ShardedRecordReader``, and ``val.rec`` (256); each with its
    ``.idx``.  Label i % 1000."""
    import cv2
    from concurrent.futures import ThreadPoolExecutor

    rio = mx.recordio

    def encode(i):
        return rio.pack_img((0, float(i % 1000), i, 0), _texture(cv2, i),
                            quality=IMG_QUALITY, img_fmt=".jpg")

    with ThreadPoolExecutor(os.cpu_count()) as ex:
        payloads = list(ex.map(encode, range(IMG_N + IMG_VAL_N)))

    def writer(name):
        return rio.MXIndexedRecordIO(os.path.join(root, name + ".idx"),
                                     os.path.join(root, name + ".rec"), "w")

    train, val = writer("train"), writer("val")
    parts = [writer(f"part{s}") for s in range(IMG_SHARDS)]
    for i, p in enumerate(payloads):
        if i < IMG_N:
            train.write_idx(i, p)
            parts[i % IMG_SHARDS].write_idx(i, p)
        else:
            val.write_idx(i, p)
    for w in [train, val] + parts:
        w.close()
    return float(np.mean([len(p) for p in payloads]))


def _record_iter(mx, path, train=True, **kw):
    return mx.io.ImageRecordIter(
        path_imgrec=path, data_shape=(3, 224, 224), batch_size=IMG_B,
        rand_crop=train, rand_mirror=train, shuffle=train, seed=SEED,
        preprocess_threads=os.cpu_count(), **IMG_MEAN, **kw)


def _endless(make):
    """Batches of an iterator made by ``make``, epoch after epoch."""
    it = make()
    while True:
        for b in it:
            yield b.data[0], b.label[0]
        it.reset()


def _resnet_for_lane(mx, vision, lr):
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.zeros((1, 3, 224, 224), ctx=mx.gpu(0)))
    net.cast("bfloat16")
    return net, mx.gluon.Trainer(net.collect_params(), "sgd",
                                 {"learning_rate": lr, "momentum": 0.9})


def _eager_feed_run(torch, mx, net, tr, loss_fn, feed, steps=None,
                    warm=2):
    """``warm`` + ``steps`` (default ``IMG_STEPS``) eager steps, each on
    the batch ``feed()`` gives (f32 or bf16 on the card); ms a timed step
    (host clock, the card drained at both ends) and the last loss."""
    steps = IMG_STEPS if steps is None else steps
    batch = feed()
    for i in range(warm + steps):
        if i == warm:
            torch.cuda.synchronize()
            t = time.perf_counter()
        x, y = batch
        with mx.autograd.record():
            loss = loss_fn(net(x.astype("bfloat16", copy=False)), y)
        loss.backward()
        tr.step(IMG_B)
        if i + 1 < warm + steps:
            batch = feed()  # the next batch while the card runs this step
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / steps
    return ms, float(loss.mean().asscalar())


def _fused_feed_run(torch, mx, net, tr, loss_fn, feed, stacked):
    """A ``FusedTrainStep`` (K=8): one call to capture, then
    ``IMG_CALLS`` timed calls, each call's batches fetched while the card
    runs the call before (the first timed call's before the clock starts).
    ``stacked``: each call takes 8 new batches from ``feed`` (a new batch
    a step); else each step reads the one batch ``feed()`` gives (the
    resident protocol).  Returns ms a step and every loss."""
    fstep = mx.gluon.FusedTrainStep(
        net, tr, lambda n, a, c: loss_fn(n(a), c),
        steps_per_execution=FUSED_STEP_K, batch_size=IMG_B,
        stacked_inputs=stacked)

    def args():
        if not stacked:
            x, y = feed()
            return x.astype("bfloat16", copy=False), y
        xs, ys = zip(*(feed() for _ in range(FUSED_STEP_K)))
        return (mx.nd.stack(*[x.astype("bfloat16", copy=False)
                              for x in xs]), mx.nd.stack(*ys))

    losses = [fstep(*args())]
    nxt = args()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for c in range(IMG_CALLS):
        losses.append(fstep(*nxt))
        if c + 1 < IMG_CALLS:
            nxt = args()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / (IMG_CALLS * FUSED_STEP_K)
    return ms, [v for nd_ in losses for v in nd_.asnumpy().tolist()], fstep


def image_lane_phase(torch, mx, vision, cbr, mt, failures):
    """Phase 16, the image lane: JPEG shards through ``io.ImageRecordIter``
    (the native reader and, for the check, the Python reader),
    ``gluon.data.DataLoader`` (thread and process workers) and
    ``data.ShardedRecordReader`` → ``StreamingLoader`` →
    ``DevicePrefetcher`` into ``resnet50_v1`` bf16 training, eager and
    ``FusedTrainStep`` (K=8), each beside the same step on one resident
    batch; then a hybridized eval pass over the validation shard (16
    launches of the fused kernel a forward).  Returns the eval pass's
    (launches, tensor-core launches) and the update's launches."""
    import shutil
    import tempfile

    from mxnet_tpu_torch import _native

    free_card(torch)
    cpus = os.cpu_count()
    t = time.perf_counter()
    build = _native.build(force=True)
    build_s = time.perf_counter() - t
    _native.lib()
    root = tempfile.mkdtemp(prefix="mxt_images_")
    try:
        t = time.perf_counter()
        mean_bytes = write_image_shards(mx, root)
        emit(dict(phase="image_data", images=IMG_N, val_images=IMG_VAL_N,
                  shards=IMG_SHARDS, codec="jpeg", quality=IMG_QUALITY,
                  short_side=IMG_SHORT, mean_record_bytes=mean_bytes,
                  write_s=time.perf_counter() - t, cpu_count=cpus,
                  native_build_s=build_s, native_build_log=build[-500:]))
        return _image_lane(torch, mx, vision, cbr, mt, root, failures)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _image_lane(torch, mx, vision, cbr, mt, root, failures):
    train = os.path.join(root, "train.rec")
    cpus = os.cpu_count()

    # the native and the Python reader give the same batches
    a, b = _record_iter(mx, train), _record_iter(mx, train, no_native=True)
    same = True
    for _ in range(2):
        ba, bb = next(a), next(b)
        same &= torch.equal(ba.data[0]._data, bb.data[0]._data) and \
            torch.equal(ba.label[0]._data, bb.label[0]._data)
        on_card = ba.data[0]._data.is_cuda and ba.label[0]._data.is_cuda
    a.close()
    b.close()
    if not (same and on_card):
        failures.append(f"ImageRecordIter: native batches equal to the "
                        f"Python reader's: {same}; on the card: {on_card}")

    # ImageRecordIter alone, one epoch on each reader
    rates = {}
    for name, kw in (("native", {}), ("no_native", {"no_native": True})):
        it = _record_iter(mx, train, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = sum(bt.data[0].shape[0] for bt in it)
        torch.cuda.synchronize()
        rates[name] = n / (time.perf_counter() - t)
        it.close()

    # DataLoader over ImageRecordDataset, thread and process workers
    T = mx.gluon.data.vision.transforms
    tf = T.Compose([T.RandomResizedCrop(224), T.RandomFlipLeftRight(),
                    T.ToTensor(),
                    T.Normalize((0.485, 0.456, 0.406),
                                (0.229, 0.224, 0.225))])
    ds = mx.gluon.data.vision.ImageRecordDataset(train).transform_first(tf)
    loader_rates = {}
    for wt in ("thread", "process"):
        loader = mx.gluon.data.DataLoader(
            ds, batch_size=IMG_B, shuffle=True, last_batch="discard",
            num_workers=cpus, pin_memory=True, worker_type=wt)
        t = time.perf_counter()
        it = iter(loader)
        x, y = next(it)
        first_s = time.perf_counter() - t
        pinned = x._data.is_pinned() and not x._data.is_cuda
        t = time.perf_counter()
        n = sum(xb.shape[0] for xb, _ in it)
        loader_rates[wt] = dict(images_per_s=n / (time.perf_counter() - t),
                                first_batch_s=first_s, pinned=pinned)
        loader.close()
        if not pinned:
            failures.append(f"DataLoader({wt}, pin_memory=True): batch "
                            "not in pinned host memory")
    emit(dict(phase="image_input", card=_card(), cpu_count=cpus,
              record_iter_images_per_s=rates,
              dataloader=loader_rates, native_equals_python=same,
              batches_on_card=on_card))

    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    xr = mx.nd.array(torch.rand((IMG_B, 3, 224, 224), generator=gen,
                                device="cuda").bfloat16())
    yr = mx.nd.array(torch.randint(0, 1000, (IMG_B,), generator=gen,
                                   device="cuda").float())
    mt.multi_tensor_update.launches = 0  # the update's main path starts
    rows = {}

    # eager, bench.py's lr 0.1: resident batch, then ImageRecordIter
    net, tr = _resnet_for_lane(mx, vision, RESNET_LR)
    rows["eager_resident"] = _eager_feed_run(torch, mx, net, tr, loss_fn,
                                             lambda: (xr, yr))
    feed = _endless(lambda: _record_iter(mx, train))
    rows["eager_record_iter"] = _eager_feed_run(
        torch, mx, net, tr, loss_fn, lambda: next(feed))
    del feed

    # DataLoader (thread workers) into the same step
    loader = mx.gluon.data.DataLoader(ds, batch_size=IMG_B, shuffle=True,
                                      last_batch="discard",
                                      num_workers=cpus, pin_memory=True)

    def epochs():
        while True:
            yield from loader

    dl_feed = epochs()

    def from_loader():
        xb, yb = next(dl_feed)
        return (xb.as_in_context(mx.gpu(0)), yb.as_in_context(mx.gpu(0)))

    rows["eager_dataloader"] = _eager_feed_run(
        torch, mx, net, tr, loss_fn, from_loader, steps=6)
    del dl_feed, loader

    # the sharded route: ShardedRecordReader -> StreamingLoader ->
    # DevicePrefetcher (the copy on its own stream), normalize on the card
    reader = mx.data.ShardedRecordReader(os.path.join(root, "part*.rec"),
                                         batch_size=IMG_B, seed=SEED)

    def decode(raw):
        header, payload = mx.recordio.unpack(raw)
        rng = np.random.RandomState(SEED + header.id)
        img = mx.image.augment_geom(mx.image.imdecode_raw(payload),
                                    (3, 224, 224), rng, rand_crop=True,
                                    rand_mirror=True)
        return np.ascontiguousarray(img), np.float32(header.label)

    n_stream = 2 * (2 + IMG_STEPS) + (1 + IMG_CALLS) * FUSED_STEP_K
    stream = mx.data.StreamingLoader(reader, transform=decode,
                                     num_workers=max(cpus // 2, 1),
                                     prefetch_depth=2, num_steps=n_stream)
    tr.attach_data_prefetcher(stream)
    mean = mx.nd.array(np.array([IMG_MEAN[k] for k in
                                 ("mean_r", "mean_g", "mean_b")], "f"))
    std = mx.nd.array(np.array([IMG_MEAN[k] for k in
                                ("std_r", "std_g", "std_b")], "f"))
    first = []

    def from_stream(src=None):
        u8, yb = (src or stream).get(timeout=120)
        if not first:
            first.append((u8._data.clone(), yb._data.clone()))
        if not (u8._data.is_cuda and yb._data.is_cuda):
            failures.append("a prefetched leaf is not on the card")
        x = ((u8.astype("float32") - mean) / std).transpose((0, 3, 1, 2))
        # the transpose is a view with NHWC strides: made contiguous, the
        # batch is the NCHW one ImageRecordIter gives
        return mx.nd.NDArray(x._data.contiguous()), yb

    rows["eager_prefetcher"] = _eager_feed_run(torch, mx, net, tr, loss_fn,
                                               from_stream)
    # the decode threads take the GIL back between images while the main
    # thread dispatches the eager step; a shorter switch interval hands it
    # over sooner
    interval = sys.getswitchinterval()
    sys.setswitchinterval(IMG_SWITCH_S)
    try:
        rows["eager_prefetcher_switch_0.5ms"] = _eager_feed_run(
            torch, mx, net, tr, loss_fn, from_stream)
    finally:
        sys.setswitchinterval(interval)
    # other decode thread counts: fewer starve the step of batches, more
    # contend with the main thread for the GIL and the host's cores.  The
    # stream is endless, so its threads decode during the timed steps (a
    # stream of only the steps a row takes is decoded before they run)
    for workers in IMG_WORKER_ROWS:
        few = mx.data.StreamingLoader(reader, transform=decode,
                                      num_workers=workers, prefetch_depth=2)
        rows[f"eager_prefetcher_{workers}_workers"] = _eager_feed_run(
            torch, mx, net, tr, loss_fn,
            lambda few=few: from_stream(src=few))
        few.close()
    host = [decode(reader.read(i)) for i in reader.batch_indices_for_step(0)]
    same_stream = torch.equal(
        first[0][0].cpu(), torch.from_numpy(np.stack([h[0] for h in host])))
    same_stream &= torch.equal(first[0][1].cpu(), torch.from_numpy(
        np.array([h[1] for h in host], np.float32)))
    if not same_stream:
        failures.append("StreamingLoader's first batch differs from the "
                        "host batch of the same draw")
    trainer_stats = tr.stats()
    del net, tr
    free_card(torch)

    # FusedTrainStep (K=8), lr 0.01: resident, ImageRecordIter, prefetcher
    fused = {}
    net, tr = _resnet_for_lane(mx, vision, IMG_LR)
    fused["fused_resident"] = _fused_feed_run(torch, mx, net, tr, loss_fn,
                                              lambda: (xr, yr), False)
    del net, tr
    free_card(torch)
    net, tr = _resnet_for_lane(mx, vision, IMG_LR)
    feed = _endless(lambda: _record_iter(mx, train))
    fused["fused_record_iter"] = _fused_feed_run(
        torch, mx, net, tr, loss_fn, lambda: next(feed), True)
    del feed, net, tr
    free_card(torch)
    net, tr = _resnet_for_lane(mx, vision, IMG_LR)
    fused["fused_prefetcher"] = _fused_feed_run(torch, mx, net, tr, loss_fn,
                                                from_stream, True)
    pf_stats = stream.stats()
    stream.close()
    for name, (ms, losses, _) in fused.items():
        rows[name] = (ms, losses[-1])
        if not all(math.isfinite(v) for v in losses):
            failures.append(f"image lane {name}: losses {losses}")
    update_launches = mt.multi_tensor_update.launches  # ... ends
    for name, (ms, loss) in rows.items():
        if not math.isfinite(loss):
            failures.append(f"image lane {name}: loss {loss}")
    res = {k: v[0] for k, v in rows.items()}
    emit(dict(phase="image_train", card=_card(), B=IMG_B,
              dtype="bfloat16",
              K=FUSED_STEP_K, cpu_count=cpus,
              step_ms=res,
              images_per_s={k: IMG_B / v * 1e3 for k, v in res.items()},
              data_over_resident={
                  "eager_record_iter": res["eager_record_iter"] /
                  res["eager_resident"],
                  "eager_prefetcher": res["eager_prefetcher"] /
                  res["eager_resident"],
                  "eager_dataloader": res["eager_dataloader"] /
                  res["eager_resident"],
                  "fused_record_iter": res["fused_record_iter"] /
                  res["fused_resident"],
                  "fused_prefetcher": res["fused_prefetcher"] /
                  res["fused_resident"]},
              losses={k: v[1] for k, v in rows.items()},
              prefetcher=dict(
                  wait_ms_p50=pf_stats["wait_ms_p50"],
                  wait_ms_p99=pf_stats["wait_ms_p99"],
                  wait_ms_total=pf_stats["wait_ms_total"],
                  depth_mean=pf_stats["depth_mean"],
                  batches=pf_stats["batches"],
                  trainer_depth_mean=trainer_stats[
                      "data_prefetch_depth_mean"],
                  trainer_depth_samples=trainer_stats[
                      "data_prefetch_depth_samples"]),
              stream_equals_host=same_stream,
              update_launches=update_launches))

    # the hybridized eval pass over the validation shard (center crops):
    # the fused 1x1 kernel, 16 launches a forward
    net.hybridize()
    val = _record_iter(mx, os.path.join(root, "val.rec"), train=False)
    k = cbr.fused_matmul_affine_relu
    k.launches = k.launches_mma = 0  # the eval pass's main path starts
    forwards, finite, ms = 0, True, []
    metric = mx.metric.Accuracy()
    for bt in val:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = net(bt.data[0].astype("bfloat16"))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        finite &= bool(torch.isfinite(out._data).all())
        metric.update([bt.label[0]], [out])
        forwards += 1
    launches, mma = k.launches, k.launches_mma  # ... and ends here
    val.close()
    ok = forwards == IMG_VAL_N // IMG_B and launches == 16 * forwards and \
        mma == launches and finite
    emit(dict(phase="image_eval", card=_card(), forwards=forwards,
              launches=launches,
              launches_mma=mma, launches_per_forward=launches / forwards,
              forward_ms=ms, accuracy=metric.get()[1], finite=finite,
              ok=ok))
    if not ok:
        failures.append(f"image eval: {forwards} forwards, {launches} "
                        f"fused launches ({mma} tensor-core), finite "
                        f"{finite}; expected 16 a forward")
    del net, tr, fused
    free_card(torch)
    return launches, mma, update_launches


def _write_docs(mx, root, vocab):
    """``PACK_DOCS`` token documents, lengths log-uniform over 32-2048,
    one a record, in four ``docs*.rec`` shards."""
    rng = np.random.RandomState(SEED + 17)
    lens = np.exp(rng.uniform(np.log(32), np.log(2048), PACK_DOCS))
    parts = [mx.recordio.MXIndexedRecordIO(
        os.path.join(root, f"docs{s}.idx"),
        os.path.join(root, f"docs{s}.rec"), "w") for s in range(4)]
    for i, n in enumerate(lens.astype(np.int64)):
        parts[i % 4].write_idx(i, rng.randint(1, vocab, int(n))
                               .astype(np.int32).tobytes())
    for p in parts:
        p.close()
    return float(lens.mean())


def _tokens(raw):
    return np.frombuffer(raw, dtype=np.int32)


def packed_llama_phase(torch, mx, llama, fa, failures):
    """Phase 17, the packed-LLM lane: ``.rec`` documents through
    ``ShardedRecordReader`` → ``StreamingLoader(packer=SequencePacker(1,
    2048))`` → ``DevicePrefetcher`` → ``LlamaForCausalLM(input_ids,
    segment_ids)`` (the dense segment-masked route: no flash launch) →
    ``packed_lm_loss`` → ``backward`` → ``Trainer.step``, at
    ``llama3_8b`` width, 16 layers, bf16; then one sample-mode step on
    the same documents (each cut or padded to 2048, no segment ids: the
    flash kernels).  Returns the sample-mode steps' flash launches
    (forward, dQ, dK/dV) and tensor-core launches, and the update's
    launches."""
    import shutil
    import tempfile

    free_card(torch)
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=PACK_LAYERS)
    net.cast("bfloat16")
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": TRAIN_LR, "momentum": 0.9})
    vocab = net.config.vocab_size
    root = tempfile.mkdtemp(prefix="mxt_docs_")
    try:
        mean_len = _write_docs(mx, root, vocab)
        return _packed_lane(torch, mx, llama, fa, net, tr, root, mean_len,
                            failures)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        del net, tr
        free_card(torch)


def _packed_lane(torch, mx, llama, fa, net, tr, root, mean_len, failures):
    from mxnet_tpu_torch.ops import multi_tensor as mt

    shards = os.path.join(root, "docs*.rec")
    reader = mx.data.ShardedRecordReader(shards, PACK_DOCS_PER_STEP,
                                         seed=SEED)
    packer = mx.data.SequencePacker(PACK_B, PACK_T)
    loader = mx.data.StreamingLoader(reader, packer=packer,
                                     tokenize=_tokens, num_workers=2,
                                     prefetch_depth=2, num_steps=PACK_STEPS)
    tr.attach_data_prefetcher(loader)
    _zero_counts(fa)
    mt.multi_tensor_update.launches = 0
    steps, first = [], None
    torch.cuda.reset_peak_memory_stats()
    for step in range(PACK_STEPS):
        stamps, peaks = [], []

        def mark():
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

        mark()
        peaks.clear()
        pb = loader.get(timeout=300)
        mark()
        if first is None:
            first = {f: getattr(pb, f).asnumpy() for f in
                     ("tokens", "segment_ids", "labels", "loss_mask")}
        leaves = (pb.tokens, pb.segment_ids, pb.labels, pb.loss_mask)
        on_card = all(v._data.is_cuda for v in leaves)
        with mx.autograd.record():
            logits = net(pb.tokens, pb.segment_ids)
            loss = llama.packed_lm_loss(logits, pb.labels, pb.loss_mask)
        mark()
        loss.backward()
        mark()
        tr.step(PACK_B)
        mark()
        del logits
        kept = int((pb.segment_ids._data > 0).sum())
        lv = float(loss.asscalar())
        get_ms, fwd_ms, bwd_ms, upd_ms = ((b - a) * 1e3 for a, b in
                                          zip(stamps, stamps[1:]))
        ms = fwd_ms + bwd_ms + upd_ms
        steps.append(dict(step=step, warmup=step < PACK_WARMUP, loss=lv,
                          ms=ms,
                          get_ms=get_ms, forward_ms=fwd_ms,
                          backward_ms=bwd_ms, update_ms=upd_ms,
                          tokens_kept=kept,
                          tokens_per_s=kept / ms * 1e3,
                          grid_tokens_per_s=PACK_B * PACK_T / ms * 1e3,
                          max_memory_allocated=dict(zip(
                              ("get", "forward", "backward", "update"),
                              peaks)), on_card=on_card))
        if not (on_card and math.isfinite(lv)):
            failures.append(f"packed step {step}: loss {lv}, leaves on "
                            f"the card {on_card}")
    flash = [c.launches for c in _counters(fa)]
    updates = mt.multi_tensor_update.launches
    pf = loader.stats()
    pstats = loader.packing_stats.as_dict()
    loader.close()
    # the loader's first batch is the host packing of step 0's draw
    check = mx.data.SequencePacker(PACK_B, PACK_T).pack(
        [_tokens(reader.read(i))
         for i in reader.global_indices_for_step(0)])
    same = all(np.array_equal(first[f], getattr(check, f)) for f in first)
    timed = [s["ms"] for s in steps[PACK_WARMUP:]]
    ok = same and flash == [0, 0, 0] and updates == PACK_STEPS
    emit(dict(phase="packed_llama", card=_card(), layers=PACK_LAYERS,
              B=PACK_B, T=PACK_T,
              dtype="bfloat16", docs=PACK_DOCS,
              docs_per_step=PACK_DOCS_PER_STEP, mean_doc_tokens=mean_len,
              steps=steps, step_ms=timed,
              tokens_per_s=float(np.median([s["tokens_per_s"]
                                            for s in
                                            steps[PACK_WARMUP:]])),
              packing=pstats, flash_launches=flash, update_launches=updates,
              prefetcher=dict(wait_ms_p50=pf["wait_ms_p50"],
                              wait_ms_p99=pf["wait_ms_p99"],
                              depth_mean=pf["depth_mean"]),
              trainer_stats=tr.stats(), batch_equals_host=same,
              max_memory_allocated=max(
                  max(s["max_memory_allocated"].values()) for s in steps),
              ok=ok))
    if not ok:
        failures.append(f"packed lane: batch equals host {same}, flash "
                        f"launches {flash} (expected 0), updates {updates}, "
                        f"losses {[s['loss'] for s in steps]}")

    # the sample-mode comparison: the same documents cut or padded to T,
    # no segment ids, so the flash route (kernels #1-#3)
    def cut(raw):
        toks = np.zeros(PACK_T + 1, np.int32)
        d = _tokens(raw)[:PACK_T + 1]
        toks[:len(d)] = d
        return toks

    sample = mx.data.StreamingLoader(
        mx.data.ShardedRecordReader(shards, PACK_B, seed=SEED),
        transform=cut, num_workers=1, num_steps=2)
    _zero_counts(fa)  # the sample-mode main path starts
    rows = []
    for step in range(2):
        batch = sample.get(timeout=300)
        ids, labels = batch[:, :-1], batch[:, 1:]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = _lm_forward(mx, net, ids, labels)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tr.step(PACK_B)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rows.append(dict(step=step, warmup=step == 0,
                         loss=float(loss.asscalar()),
                         ms=(t3 - t0) * 1e3, forward_ms=(t1 - t0) * 1e3,
                         backward_ms=(t2 - t1) * 1e3,
                         update_ms=(t3 - t2) * 1e3,
                         max_memory_allocated=
                         torch.cuda.max_memory_allocated()))
    sample.close()
    launches = [c.launches for c in _counters(fa)]  # ... and ends here
    mma = _mma_counts(fa)
    updates += mt.multi_tensor_update.launches - PACK_STEPS
    ok = launches == [2 * PACK_LAYERS] * 3 and mma == launches and \
        all(math.isfinite(r["loss"]) for r in rows)
    emit(dict(phase="packed_llama_sample_mode", card=_card(),
              steps=rows,
              dense_packed_over_flash=float(np.median(timed)) /
              rows[1]["ms"],
              launches=dict(zip(("fwd", "dq", "dkv"), launches)),
              launches_mma=dict(zip(("fwd", "dq", "dkv"), mma)), ok=ok))
    if not ok:
        failures.append(f"sample-mode step: flash launches {launches} "
                        f"({mma} tensor-core), losses "
                        f"{[r['loss'] for r in rows]}")
    return launches, mma, updates


# Phases 18a-18d: synchronous multi-GPU (slice 11).  One card holds one
# rank (NCCL puts no two ranks of a communicator on one device), so the
# card runs the NCCL route at world size 1 and the sequence-parallel
# bodies over local chunks; multi-rank behaviour is held on the CPU with
# gloo groups (tests/test_torch_{parallel,partition,ring,kvstore_dist,
# llama_parallel}.py).
MESH_LOSS_RTOL = 2e-2     # the mesh route's losses vs phase 9's (bf16)
SP_CHUNKS = 4             # 18c: virtual ranks on the sequence axis
SP_TOL = 2e-2             # 18c: relative norm vs one flash call (bf16)
SP_T, SP_H, SP_D = 2048, 32, 128
SYNC_BN_TOL = 1e-5        # 18d: SyncBatchNorm vs BatchNorm, f32, relative


def nccl_phase(torch, mx, parallel, failures):
    """Phase 18a: an NCCL group of one on 127.0.0.1 (a free port), a
    {'dp': 1, 'tp': 1} mesh on the card, and the collectives on card
    tensors: ``all_sum``, ``KVStore.broadcast`` and the store's
    ``allreduce_grads`` each return its input."""
    t = time.perf_counter()
    parallel.initialize(f"127.0.0.1:{parallel.free_port()}", 1, 0,
                        init_timeout=120)
    mesh = parallel.make_mesh({"dp": 1, "tp": 1})
    backend = torch.distributed.get_backend()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 18)
    x = mx.nd.array(torch.randn((1024, 257), generator=gen, device="cuda"))
    summed = parallel.all_sum([x.copy()])[0]
    kv = mx.kv.create("dist_tpu_sync")
    out = mx.nd.zeros(x.shape, ctx=mx.gpu(0))
    kv.broadcast("x", x, out=out)
    net = mx.gluon.nn.Dense(64, in_units=257)
    net.initialize(ctx=mx.gpu(0))
    with mx.autograd.record():
        loss = net(x).sum()
    loss.backward()
    before = [p.grad().asnumpy() for p in net.collect_params().values()]
    kv.allreduce_grads(list(net.collect_params().values()))
    after = [p.grad().asnumpy() for p in net.collect_params().values()]
    errs = dict(
        all_sum=float((summed._data - x._data).abs().max()),
        broadcast=float((out._data - x._data).abs().max()),
        allreduce_grads=max(float(np.abs(a - b).max())
                            for a, b in zip(after, before)))
    ok = backend == "nccl" and max(errs.values()) == 0.0 and \
        str(mesh.device_type) == "cuda"
    emit(dict(phase="nccl_group", backend=backend,
              world_size=parallel.world_size(),
              mesh=parallel.mesh_axes(mesh), mesh_device=mesh.device_type,
              seconds=time.perf_counter() - t, max_abs_err=errs, ok=ok))
    if not ok:
        failures.append(f"NCCL group of one: backend {backend}, "
                        f"errors {errs}")
    return mesh


def mesh_train_phase(torch, mx, llama, fa, mt, parallel, mesh, failures):
    """Phase 18b: phase 9's net (``llama3_8b`` width, 16 layers, bf16, the
    same seed, so the same weights) and batch through
    ``Trainer(..., kvstore="dist_sync", partition_rules=LLAMA_RULES,
    mesh={'dp': 1, 'tp': 1})``: every parameter a DTensor on the mesh,
    the flash kernels on each rank's local pieces, the store's NCCL
    all-reduce.  One warm-up and three timed steps, the losses step for
    step against phase 9's, #1-#3 launched as often a step, step ms, the
    store's ``allreduce_grads`` ms and peak memory beside phase 9's: at
    world size 1 the difference is the mesh machinery's own cost."""
    free_card(torch)
    t = time.perf_counter()
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=TRAIN_LAYERS)
    net.cast("bfloat16")
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    trainer = mx.gluon.Trainer(
        net.collect_params(), "sgd",
        {"learning_rate": TRAIN_LR, "momentum": 0.9}, kvstore="dist_sync",
        partition_rules=parallel.LLAMA_RULES, mesh=mesh)
    ids, labels = _ids_labels(torch, mx, net.config.vocab_size, 2048,
                              SEED + 5)
    ids = parallel.shard_batch(ids, mesh)
    labels = parallel.shard_batch(labels, mesh)
    torch.cuda.synchronize()
    emit(dict(phase="mesh_train_init", seconds=time.perf_counter() - t,
              placement=trainer.placement.summary(),
              memory_allocated=torch.cuda.memory_allocated()))
    _zero_counts(fa)  # the mesh route's main path starts here
    mt.multi_tensor_update.launches = 0
    losses, step_ms, ar_ms, peaks, per_step = [], [], [], [], []
    for step in range(4):
        before = [c.launches for c in _counters(fa)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss_nd = _lm_forward(mx, net, ids, labels)
        loss_nd.backward()
        # Trainer.step(1) is allreduce_grads() then update(1): the first
        # timed alone, the card synchronized on both sides of it
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.allreduce_grads()
        torch.cuda.synchronize()
        ar_ms.append((time.perf_counter() - t1) * 1e3)
        trainer.update(1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peaks.append(torch.cuda.max_memory_allocated())
        losses.append(float(loss_nd.asscalar()))
        launched = [c.launches - n for c, n in zip(_counters(fa), before)]
        per_step.append(launched)
        if step:
            step_ms.append(ms)
        emit(dict(phase="mesh_train_step", step=step, warmup=step == 0,
                  loss=losses[-1], plain_loss=PLAIN9["losses"][step],
                  ms=ms, allreduce_grads_ms=ar_ms[-1],
                  launches=dict(zip(("fwd", "dq", "dkv"), launched)),
                  max_memory_allocated=peaks[-1]))
    launches = [c.launches for c in _counters(fa)]  # ... ends
    launches_mma = _mma_counts(fa)
    updates = mt.multi_tensor_update.launches  # ... ends
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, PLAIN9["losses"])]
    ok = max(rel) <= MESH_LOSS_RTOL and \
        all(s == PLAIN9["launches_per_step"] for s in per_step) and \
        launches_mma == launches and updates == 4
    grads = [p.grad()._data for p in net.collect_params().values()
             if p.grad_req != "null"]
    STASH["mesh"] = dict(losses=losses, step_ms=step_ms)
    emit(dict(phase="mesh_train_summary", losses=losses,
              plain_losses=PLAIN9["losses"], max_rel_loss_diff=max(rel),
              step_ms=step_ms, plain_step_ms=PLAIN9["step_ms"],
              allreduce_grads_ms=ar_ms[1:], peak_memory=max(peaks),
              plain_peak_memory=PLAIN9["peak"],
              launches=dict(zip(("fwd", "dq", "dkv"), launches)),
              launches_mma=dict(zip(("fwd", "dq", "dkv"), launches_mma)),
              update_launches=updates,
              grad_placements=sorted({str(g.placements) for g in grads}),
              ok=ok))
    if not ok:
        failures.append(f"mesh route: losses {losses} vs {PLAIN9['losses']}"
                        f", launches a step {per_step}, update launches "
                        f"{updates}")
    del net, trainer, ids, labels, loss_nd, grads
    free_card(torch)
    return launches, launches_mma, updates


class _LocalRing:
    """The ring's transport for virtual ranks in one process: before
    step r, virtual rank ``idx`` holds chunk (idx - r) mod n, so a shift
    hands it chunk (idx - r - 1) mod n (the real transport receives the
    same chunk from rank idx - 1)."""

    def __init__(self, k_chunks, v_chunks, idx):
        self.k, self.v, self.idx = k_chunks, v_chunks, idx

    def __call__(self, _k, _v, r):
        j = (self.idx - r - 1) % len(self.k)
        return self.k[j], self.v[j]


class _LocalAllToAll:
    """Ulysses' transport for virtual rank ``idx`` in one process:
    ``to_heads`` gathers head group idx of every rank's sequence chunk
    (what the all-to-all delivers), ``to_seq`` keeps the head group over
    the whole sequence (the inverse all-to-all's input; the phase lays
    the groups side by side)."""

    def __init__(self, chunks, idx):
        self.chunks, self.idx = chunks, idx

    def to_heads(self, x):
        group = next(c for c in self.chunks if any(t is x for t in c))
        h = x.shape[2] // len(group)
        return __import__("torch").cat(
            [c[:, :, self.idx * h:(self.idx + 1) * h] for c in group],
            dim=1)

    @staticmethod
    def to_seq(x):
        return x


def sp_bodies_phase(torch, mx, fa, ring, failures):
    """Phase 18c: ``llama3_8b``'s attention (B1·H32·T2048·D128, causal,
    bf16, GQA already repeated) cut into 4 sequence chunks; the ring body
    and the Ulysses body run for each virtual rank over a local
    transport, forward and backward, against one flash call and its
    backward (relative norms).  Ulysses attends through ``sdpa_raw``:
    #1-#3 once per virtual rank (the counts are zeroed just before its
    bodies and read just after, apart from the reference flash call)."""
    free_card(torch)
    n, tc = SP_CHUNKS, SP_T // SP_CHUNKS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 19)
    full = [torch.randn((1, SP_T, SP_H, SP_D), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(3)]
    w = torch.randn((1, SP_T, SP_H, SP_D), generator=gen, device="cuda")
    scale = 1.0 / math.sqrt(SP_D)

    def leaves():
        return [t.detach().clone().requires_grad_(True) for t in full]

    # the reference: one flash call over the whole sequence
    q, k, v = leaves()
    ref = fa.flash_attention_raw(
        *(t.transpose(1, 2).contiguous() for t in (q, k, v)), True,
        scale).transpose(1, 2)
    (ref.float() * w).sum().backward()
    ref_grads = [q.grad, k.grad, v.grad]
    rows = {}
    for kind in ("ring", "ulysses"):
        q, k, v = leaves()
        chunks = [list(t.split(tc, dim=1)) for t in (q, k, v)]
        _zero_counts(fa)  # the bodies' launches start here
        t0 = time.perf_counter()
        outs = []
        for idx in range(n):
            qc, kc, vc = (c[idx] for c in chunks)
            if kind == "ring":
                outs.append(ring._ring_body(
                    qc, kc, vc, idx, n, True, scale,
                    _LocalRing(chunks[1], chunks[2], idx)))
            else:
                tr = _LocalAllToAll(chunks, idx)
                outs.append(ring._ulysses_body(qc, kc, vc, True, scale,
                                               tr.to_heads, tr.to_seq))
        out = torch.cat(outs, dim=1 if kind == "ring" else 2)
        (out.float() * w).sum().backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = [c.launches for c in _counters(fa)]  # ... ends
        mma = _mma_counts(fa)
        errs = dict(out=_rel_norm(torch, out, ref),
                    **{f"d{nm}": _rel_norm(torch, g, r) for nm, g, r in
                       zip("qkv", (q.grad, k.grad, v.grad), ref_grads)})
        want = [0, 0, 0] if kind == "ring" else [n] * 3
        # bf16: every launch the tensor-core design's
        ok = max(errs.values()) <= SP_TOL and launched == want and \
            mma == launched
        rows[kind] = dict(rel_err=errs, launches=launched, mma=mma, ms=ms,
                          ok=ok)
        emit(dict(phase="sp_bodies", kind=kind, chunks=n,
                  shape=[1, SP_H, SP_T, SP_D], rel_err=errs,
                  launches=dict(zip(("fwd", "dq", "dkv"), launched)),
                  launches_mma=dict(zip(("fwd", "dq", "dkv"), mma)),
                  host_ms=ms, ok=ok))
        if not ok:
            failures.append(f"{kind} body: relative errors {errs}, "
                            f"launches {launched} (want {want}), "
                            f"tensor-core {mma}")
        del q, k, v, chunks, outs, out
    free_card(torch)
    return rows["ulysses"]["launches"], rows["ulysses"]["mma"]


def classic_dp_phase(torch, mx, vision, mt, failures):
    """Phase 18d: ``resnet50_v1`` bf16 B=128 steps through
    ``Trainer(kvstore="dist_sync")`` on the group of one, beside the same
    steps through the ``device`` store (same seed, same batch): the
    losses agree and the step times stand side by side; then a
    ``SyncBatchNorm`` block on the group equals ``BatchNorm`` on the
    card (forward, backward, moving statistics; each within
    ``SYNC_BN_TOL`` of its largest value)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    b = RESNET_BATCHES[0]
    x = mx.nd.array(torch.rand((b, 3, 224, 224), generator=gen,
                               device="cuda").bfloat16())
    y = mx.nd.array(torch.randint(0, 1000, (b,), generator=gen,
                                  device="cuda").float())
    mt.multi_tensor_update.launches = 0  # the update's main path starts
    rows = {}
    for store in ("device", "dist_sync"):
        free_card(torch)
        mx.random.seed(SEED)
        net = vision.resnet50_v1(classes=1000)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net(mx.nd.zeros((1, 3, 224, 224), ctx=mx.gpu(0)))
        net.cast("bfloat16")
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": RESNET_LR,
                                    "momentum": 0.9}, kvstore=store)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        losses, step_ms = [], []
        for step in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(_resnet_step(mx, net, trainer, loss_fn, x, y))
            torch.cuda.synchronize()
            if step:
                step_ms.append((time.perf_counter() - t0) * 1e3)
        rows[store] = dict(losses=losses, step_ms=step_ms,
                           type=trainer._kvstore.type)
        del net, trainer
    updates = mt.multi_tensor_update.launches  # ... ends
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(rows["dist_sync"]["losses"], rows["device"]["losses"]))
    # SyncBatchNorm against BatchNorm on the card
    bx = torch.randn((32, 64, 28, 28), generator=gen, device="cuda")
    dy = torch.randn((32, 64, 28, 28), generator=gen, device="cuda")
    got = []
    for cls in ("BatchNorm", "SyncBatchNorm"):
        bn = getattr(mx.gluon.nn, cls)(in_channels=64, momentum=0.8)
        bn.initialize(ctx=mx.gpu(0))
        bn.gamma.set_data(torch.linspace(0.5, 1.5, 64))
        xx = mx.nd.array(bx)
        xx.attach_grad()
        with mx.autograd.record():
            yy = bn(xx)
        yy.backward(mx.nd.array(dy))
        got.append([yy._data, xx.grad._data, bn.gamma.grad()._data,
                    bn.beta.grad()._data, bn.running_mean.data()._data,
                    bn.running_var.data()._data])
    # relative to each tensor's largest value: the synchronized route sums
    # (x, x²) where BatchNorm takes a two-pass variance
    bn_err = max(float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(*(map(torch.Tensor.detach, g) for g in got)))
    ok = rel <= MESH_LOSS_RTOL and updates == 6 and bn_err <= SYNC_BN_TOL and \
        rows["dist_sync"]["type"] == "dist_tpu_sync"
    emit(dict(phase="classic_dp", B=b, stores=rows,
              max_rel_loss_diff=rel, update_launches=updates,
              sync_batch_norm_max_rel_err=bn_err, ok=ok))
    if not ok:
        failures.append(f"classic data parallelism: {rows}, loss diff {rel}"
                        f", update launches {updates}, SyncBatchNorm error "
                        f"{bn_err}")
    del x, y
    free_card(torch)
    return updates



# Phases 19a-19d: pipeline parallelism, graphs over a mesh, serving on a
# mesh and sharded checkpoints (slice 12).  One card: the pipeline's
# stages run over the local transport, the mesh is the NCCL group of one
# of 18a; multi-rank behaviour is held on the CPU in gloo groups
# (tests/test_torch_{pipeline,llama_pipeline,graph_mesh,serving_mesh,
# checkpoint_sharded}.py).
PP_B, PP_M, PP_S = 4, 4, 4   # 19a: batch, microbatches, stages
PP_STEPS = 3                 # 19a: Trainer steps of each route
PP_TOL = 2e-2                # 19a: relative norm / loss difference, bf16
PP_INLINE_TOL = 5e-3         # 19a: against the plain route with 1F1B's loss


def _pp_batch(torch, mx, vocab, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = torch.randint(0, vocab, (PP_B, 2049), generator=gen,
                           device="cuda", dtype=torch.int32)
    return mx.nd.array(tokens[:, :-1]), mx.nd.array(tokens[:, 1:])


def _plain_accumulated(mx, llama, net, ids, labels, inline=False):
    """The plain route's gradients of the mean token loss over the B·T
    tokens, accumulated over B microbatches of 1 (``grad_req="add"``) →
    the summed loss.  ``inline=True`` ends each microbatch with the 1F1B
    step's own loss (``llama._pipeline_loss_fn``: RMSNorm in f32 cast
    back to bf16, the head, log-softmax in f32) in place of the net's
    ``norm`` and ``lm_head`` and ``softmax_cross_entropy``."""
    from mxnet_tpu_torch.ops.registry import apply_op

    vocab = net.config.vocab_size
    loss_fn = llama._pipeline_loss_fn(float(net.config.rms_eps))
    total = 0.0
    for b in range(PP_B):
        with mx.autograd.record():
            if inline:
                h = net.model.embed_tokens(ids[b:b + 1])
                for layer in net.model.layers:
                    h = layer(h)
                loss = apply_op(
                    lambda hr, lr, nw, hw: loss_fn(hr, lr, (nw, hw)), h,
                    labels[b:b + 1], net.model.norm.weight.data(),
                    net.lm_head.weight.data(), name="pipeline_loss") / \
                    labels.size
            else:
                loss = mx.nd.softmax_cross_entropy(
                    net(ids[b:b + 1]).reshape((-1, vocab)),
                    labels[b:b + 1].reshape((-1,))) / labels.size
        loss.backward()
        total += float(loss.asscalar())
    return total


def _set_grad_req(net, req):
    for p in net.collect_params().values():
        if p.grad_req != "null":
            p.grad_req = req
            p.zero_grad()


def _grad_errors(torch, params, grads):
    """{parameter name: relative norm of its ``grad()`` against ``grads``
    (the 1F1B step's)}."""
    return {p.name: _rel_norm(torch, g, p.grad()._data)
            for p, g in zip(params, grads)}


def pipeline_phase(torch, mx, llama, fa, mt, failures):
    """Phase 19a: ``llama3_8b`` width at 16 layers, bf16 (phase 9's net,
    seed and optimizer), B=4 as M=4 microbatches of 1, T=2048, over 4
    stages of 4 layers on the local transport (``mesh={'pp': 4}``):
    GPipe's forward against the plain forward; the 1F1B step's loss and
    every gradient, parameter by parameter, against the plain route's
    accumulated over the same 4 microbatches, once ending in the net's
    norm, head and cross entropy (the worst parameter named) and once in
    the 1F1B step's own loss; three ``Trainer`` steps of each route from
    the same weights (losses side by side), ms and tokens/s a step, peak
    memory and #1-#3 launches a 1F1B step ((2L - L/S)·M, L·M, L·M: the
    last stage's forward leg only stashes its input).  The launch counts
    are set to 0 just before each 1F1B step and read just after it."""
    free_card(torch)
    t = time.perf_counter()
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=TRAIN_LAYERS)
    net.cast("bfloat16")
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    params = [p for p in net.collect_params().values()]
    trained = [p for p in params if p.grad_req != "null"]
    w0 = [p.data()._data.clone() for p in params]
    ids, labels = _pp_batch(torch, mx, net.config.vocab_size, SEED + 19)
    mesh = {"pp": PP_S}
    torch.cuda.synchronize()
    emit(dict(phase="pipeline_init", seconds=time.perf_counter() - t,
              stages=PP_S, microbatches=PP_M, batch=PP_B,
              memory_allocated=torch.cuda.memory_allocated()))
    # 1. GPipe's forward, not recorded, against the plain forward
    _zero_counts(fa)
    piped = llama.llama_pipeline_forward(net, ids, PP_M, mesh=mesh)._data
    gpipe_launches = [c.launches for c in _counters(fa)]
    plain = net(ids)._data
    gpipe_err = _rel_norm(torch, piped, plain)
    del piped, plain
    free_card(torch)
    # 2. the 1F1B step against both plain routes' accumulated gradients
    per_step, per_step_mma = [], []

    def pipeline_step():
        _zero_counts(fa)  # the pipeline's main path: each 1F1B step
        with mx.autograd.record():
            loss_nd = llama.llama_pipeline_train_step(net, ids, labels, PP_M,
                                                      mesh=mesh)
        loss_nd.backward()
        loss = float(loss_nd.asscalar())
        per_step.append([c.launches for c in _counters(fa)])
        per_step_mma.append(_mma_counts(fa))
        return loss

    _set_grad_req(net, "write")
    pp_loss = pipeline_step()
    pp_grads = [p.grad()._data.clone() for p in trained]
    _set_grad_req(net, "add")
    plain_loss = _plain_accumulated(mx, llama, net, ids, labels)
    grad_errs = _grad_errors(torch, trained, pp_grads)
    _set_grad_req(net, "add")
    inline_loss = _plain_accumulated(mx, llama, net, ids, labels,
                                     inline=True)
    inline_errs = _grad_errors(torch, trained, pp_grads)
    grad_err = max(grad_errs.values())
    inline_err = max(inline_errs.values())
    worst = max(grad_errs, key=grad_errs.get)
    del pp_grads
    free_card(torch)
    # 3. three Trainer steps of each route from the same weights
    routes = {}
    updates = 0
    for route in ("plain", "pipeline"):
        with torch.no_grad():
            for p, w in zip(params, w0):
                p.data()._data.copy_(w)
        if route == "pipeline":
            del w0
        _set_grad_req(net, "add" if route == "plain" else "write")
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": TRAIN_LR,
                                    "momentum": 0.9})
        losses, step_ms, peak = [], [], 0
        for step in range(PP_STEPS):
            free_card(torch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mt.multi_tensor_update.launches = 0
            t0 = time.perf_counter()
            if route == "plain":
                _set_grad_req(net, "add")
                losses.append(_plain_accumulated(mx, llama, net, ids,
                                                 labels))
            else:
                losses.append(pipeline_step())
            trainer.step(1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            peak = max(peak, torch.cuda.max_memory_allocated())
            if route == "pipeline":
                updates += mt.multi_tensor_update.launches
        routes[route] = dict(losses=losses, step_ms=step_ms, peak=peak)
        del trainer
        free_card(torch)
    launches = [sum(s[k] for s in per_step) for k in range(3)]
    launches_mma = [sum(s[k] for s in per_step_mma) for k in range(3)]
    lps = TRAIN_LAYERS // PP_S
    want = [(2 * TRAIN_LAYERS - lps) * PP_M, TRAIN_LAYERS * PP_M,
            TRAIN_LAYERS * PP_M]
    loss_rel = [abs(a - b) / abs(b) for a, b in
                zip(routes["pipeline"]["losses"], routes["plain"]["losses"])]
    tokens = PP_B * 2048
    ms = routes["pipeline"]["step_ms"]
    ok = gpipe_err <= PP_TOL and grad_err <= PP_TOL and \
        inline_err <= PP_INLINE_TOL and \
        abs(pp_loss - plain_loss) / abs(plain_loss) <= PP_TOL and \
        abs(pp_loss - inline_loss) / abs(inline_loss) <= PP_INLINE_TOL and \
        max(loss_rel) <= PP_TOL and all(s == want for s in per_step) and \
        launches_mma == launches and updates == PP_STEPS and \
        routes["pipeline"]["losses"][-1] < routes["pipeline"]["losses"][0]
    emit(dict(phase="pipeline_grads", rel_err=grad_errs,
              inline_rel_err=inline_errs))
    emit(dict(phase="pipeline_summary", gpipe_rel_err=gpipe_err,
              gpipe_launches=dict(zip(("fwd", "dq", "dkv"),
                                      gpipe_launches)),
              loss_1f1b=pp_loss, loss_plain=plain_loss,
              loss_plain_inline=inline_loss,
              max_grad_rel_err=grad_err, worst_grad=worst,
              max_grad_rel_err_inline=inline_err,
              worst_grad_inline=max(inline_errs, key=inline_errs.get),
              losses=routes["pipeline"]["losses"],
              plain_losses=routes["plain"]["losses"],
              max_rel_loss_diff=max(loss_rel), step_ms=ms,
              tokens_per_s=[tokens / m * 1e3 for m in ms],
              plain_step_ms=routes["plain"]["step_ms"],
              phase9_step_ms=PLAIN9.get("step_ms"),
              phase9_tokens_per_s=[2048 / m * 1e3 for m in
                                   PLAIN9.get("step_ms", [])],
              peak_memory=routes["pipeline"]["peak"],
              plain_peak_memory=routes["plain"]["peak"],
              phase9_peak_memory=PLAIN9.get("peak"),
              launches_per_step=per_step, predicted_per_step=want,
              launches_mma=dict(zip(("fwd", "dq", "dkv"), launches_mma)),
              update_launches=updates, tolerance=PP_TOL,
              inline_tolerance=PP_INLINE_TOL, ok=ok))
    if not ok:
        failures.append(f"pipeline: gpipe {gpipe_err}, grads {grad_err} "
                        f"(worst {worst}), inline {inline_err}, loss "
                        f"{pp_loss} vs {plain_loss} / {inline_loss}, losses "
                        f"{routes['pipeline']['losses']} vs "
                        f"{routes['plain']['losses']}, launches {per_step}")
    del net, params, trained
    free_card(torch)
    return launches, launches_mma, updates


def graph_mesh_phase(torch, mx, llama, vision, fa, mt, parallel, mesh,
                     failures):
    """Phase 19b: graphs over a mesh.  Phase 18b's step (``llama3_8b``
    width, 16 layers, bf16, the same seed and batch; ``Trainer(...,
    kvstore="dist_sync", partition_rules=LLAMA_RULES, mesh=...)``)
    captured by ``FusedTrainStep`` (K=4): its losses against 18b's eager
    mesh route step for step, then a call of 4 replays timed beside 18b's
    eager mesh step and beside the plain route's captured step (no mesh,
    the same net); ResNet-50 bf16 B=128 through ``dist_sync`` under
    ``FusedTrainStep`` K=8 beside 12b's ``device`` store; and a
    hybridized ``llama3_8b`` 2-layer bf16 block placed on the mesh
    (``shard_llama``): the replay's logits against the eager forward's.
    At world size 1 the collectives in the graphs are NCCL's no-op
    all-reduces; the question is the host cost the replay removes."""
    k = 4
    rows = {}
    updates = 0
    for route in ("mesh", "plain"):
        free_card(torch)
        mx.random.seed(SEED)
        net = llama.llama3_8b(num_layers=TRAIN_LAYERS)
        net.cast("bfloat16")
        net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
        kw = dict(kvstore="dist_sync", partition_rules=parallel.LLAMA_RULES,
                  mesh=mesh) if route == "mesh" else {}
        trainer = mx.gluon.Trainer(
            net.collect_params(), "sgd",
            {"learning_rate": TRAIN_LR, "momentum": 0.9}, **kw)
        ids, labels = _ids_labels(torch, mx, net.config.vocab_size, 2048,
                                  SEED + 5)
        if route == "mesh":
            ids = parallel.shard_batch(ids, mesh)
            labels = parallel.shard_batch(labels, mesh)

        def lm_loss(n, a, b):
            vocab = n.config.vocab_size
            return mx.nd.softmax_cross_entropy(
                n(a).reshape((-1, vocab)), b.reshape((-1,))) / b.size

        fstep = mx.gluon.FusedTrainStep(net, trainer, lm_loss,
                                        steps_per_execution=k, batch_size=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(fa)  # the mesh route's captured steps start here
        mt.multi_tensor_update.launches = 0
        t = time.perf_counter()
        losses = fstep(ids, labels).asnumpy().tolist()
        first_call_s = time.perf_counter() - t
        torch.cuda.synchronize()
        t = time.perf_counter()
        more = fstep(ids, labels).asnumpy().tolist()
        step_ms = (time.perf_counter() - t) * 1e3 / k
        got = [c.launches for c in _counters(fa)]  # ... and end here
        got_mma = _mma_counts(fa)
        if route == "mesh":
            launches, launches_mma = got, got_mma
            updates += mt.multi_tensor_update.launches
        graph = next(iter(fstep._graphs.values()))["graph"]
        rows[route] = dict(losses=losses, next_losses=more,
                           first_call_s=first_call_s, step_ms=step_ms,
                           launches=got, graph_pool_bytes=graph.pool_bytes,
                           peak=torch.cuda.max_memory_allocated())
        del net, trainer, fstep, graph, ids, labels
    ref = STASH.get("mesh", {})
    rel = [abs(a - b) / abs(b) for a, b in
           zip(rows["mesh"]["losses"], ref.get("losses", []))]
    plain_rel = [abs(a - b) / abs(b) for a, b in
                 zip(rows["plain"]["losses"], PLAIN9.get("losses", []))]
    want = [2 * k * TRAIN_LAYERS] * 3
    ok = len(rel) == k and max(rel) <= MESH_LOSS_RTOL and \
        len(plain_rel) == k and max(plain_rel) <= MESH_LOSS_RTOL and \
        rows["mesh"]["launches"] == want and launches_mma == launches
    mesh_ms = rows["mesh"]["step_ms"]
    emit(dict(phase="graph_mesh_llama", K=k, rows=rows,
              eager_mesh_losses=ref.get("losses"),
              eager_mesh_step_ms=ref.get("step_ms"),
              plain_eager_step_ms=PLAIN9.get("step_ms"),
              max_rel_loss_diff=max(rel) if rel else None,
              plain_max_rel_loss_diff=max(plain_rel) if plain_rel else None,
              replay_over_eager_mesh=[mesh_ms / m for m in
                                      ref.get("step_ms", [])],
              mesh_over_plain_replay=mesh_ms / rows["plain"]["step_ms"],
              ok=ok))
    if not ok:
        failures.append(f"graphs over a mesh (llama): {rows}, eager mesh "
                        f"losses {ref.get('losses')}")
    free_card(torch)

    # ResNet-50 through dist_sync under FusedTrainStep, beside 12b
    b = RESNET_BATCHES[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    x = mx.nd.array(torch.rand((b, 3, 224, 224), generator=gen,
                               device="cuda").bfloat16())
    y = mx.nd.array(torch.randint(0, 1000, (b,), generator=gen,
                                  device="cuda").float())
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.zeros((1, 3, 224, 224), ctx=mx.gpu(0)))
    net.cast("bfloat16")
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": FUSED_RESNET_LR, "momentum": 0.9},
        kvstore="dist_sync")
    fstep = mx.gluon.FusedTrainStep(
        net, tr, lambda n, a, c: loss_fn(n(a), c),
        steps_per_execution=FUSED_STEP_K, batch_size=b)
    mt.multi_tensor_update.launches = 0  # the dist_sync steps start here
    fused = fstep(x, y).asnumpy().tolist()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fstep(x, y).asnumpy()
    step_ms = (time.perf_counter() - t) * 1e3 / FUSED_STEP_K
    updates += mt.multi_tensor_update.launches  # ... and end here
    ref = STASH.get("fused_resnet", {})
    rrel = [abs(a - c) / abs(c) for a, c in zip(fused, ref.get("losses",
                                                              []))]
    ok = len(rrel) == FUSED_STEP_K and max(rrel) <= FUSED_LOSS_RTOL and \
        tr._kvstore.type == "dist_tpu_sync"
    emit(dict(phase="graph_mesh_resnet", B=b, K=FUSED_STEP_K,
              losses=fused, device_store_losses=ref.get("losses"),
              max_rel_loss_diff=max(rrel) if rrel else None,
              step_ms=step_ms, device_store_step_ms=ref.get("step_ms"),
              images_per_s=b / step_ms * 1e3, ok=ok))
    if not ok:
        failures.append(f"graphs over dist_sync (resnet): losses {fused} vs "
                        f"{ref.get('losses')}")
    del net, tr, fstep, x, y
    free_card(torch)

    # a hybridized block placed on the mesh: replays against eager
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=2)
    net.cast("bfloat16")
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    llama.shard_llama(net, mesh)
    ids, _ = _ids_labels(torch, mx, net.config.vocab_size, 2048, SEED + 6)
    from mxnet_tpu_torch.parallel.local import local

    with torch.no_grad():
        eager = local(net(ids)._data).clone()
        eager_ms = time_ms(torch, lambda: net(ids), 3)
        net.hybridize()
        _zero_counts(fa)
        net(ids)                      # the capture (its warm-up's result)
        replayed = local(net(ids)._data)  # a replay
        replay_ms = time_ms(torch, lambda: net(ids), 3)
        replay_launches = fa.flash_attention_fwd.launches
    err = (replayed.float() - eager.float()).abs().max().item()
    tol = GRAPH_BF16_TOL * eager.float().abs().max().item()
    stats = net.cache_stats()
    # the capture's warm-up, then five replays (one, and time_ms's 1 + 3)
    ok = err <= tol and stats["misses"] == 1 and stats["hits"] == 5 and \
        replay_launches == 2 * (1 + 5)
    emit(dict(phase="graph_mesh_hybridize", layers=2, dtype="bfloat16",
              T=2048, max_abs_err=err, tol=tol, eager_ms=eager_ms,
              replay_ms=replay_ms, cache=stats,
              flash_launches=replay_launches, ok=ok))
    if not ok:
        failures.append(f"hybridize over a mesh: error {err} (tol {tol}), "
                        f"cache {stats}, launches {replay_launches}")
    del net, eager, replayed
    free_card(torch)
    return launches, launches_mma, updates


def serving_mesh_phase(torch, mx, serving, net, failures):
    """Phase 19c: ``GenerativeServer(net, mesh={'dp': 1, 'tp': 1})`` on
    phase 8's net (``llama3_8b``, 32 layers, bf16) with phase 8b's 8
    requests in its two waves: TTFT and tick ms beside 8b's.  Then the
    token check: both servers, without a mesh and on it, admitting one
    prompt a prefill (``max_batch=1``), so that every request's programs
    have the same shapes in both runs whatever the lanes' timing (a
    prefill batch's shape decides its rounding; the decode tick's rows
    are independent): the replies equal, token for token."""
    mesh = {"dp": 1, "tp": 1}
    plain, _ = _serve_prompts(net.config.vocab_size)
    replies, srv, stats, wall_s = _serve(serving, net, plain, first_wave=2,
                                         mesh=mesh)
    recs = srv.request_records()
    ticks = list(srv.replicas[0].tick_ms)
    ref = STASH.get("serve", {})
    same_8b = sum(int(np.array_equal(a, b)) for a, b in
                  zip(replies, ref.get("replies", [])))
    mesh_ok = stats["completed"] == len(plain) and \
        stats["num_replicas"] == 1 and srv.engine.mesh is not None
    replica_mesh = repr(srv.engine.mesh)
    del srv, replies
    pair = [_serve(serving, net, plain, first_wave=2, mesh=m,
                   max_batch=1)[0] for m in (None, mesh)]
    same = sum(int(np.array_equal(a, b)) for a, b in zip(*pair))
    ok = mesh_ok and same == len(plain)
    emit(dict(phase="serving_mesh", mesh=mesh, replica_mesh=replica_mesh,
              replies_equal_one_prompt_a_prefill=same,
              replies_equal_8b=same_8b,
              ttft_ms=[r["ttft_ms"] for r in recs],
              ttft_ms_8b=ref.get("ttft_ms"),
              decode_step_ms_median=float(np.median(ticks)) if ticks
              else None,
              decode_step_ms_median_8b=ref.get("decode_step_ms_median"),
              wall_s=wall_s, ok=ok))
    if not ok:
        failures.append(f"serving on a mesh: {same} of {len(plain)} replies "
                        f"equal the server's without a mesh; stats {stats}")


def sharded_checkpoint_phase(torch, mx, llama, checkpoint, parallel, mesh,
                             failures):
    """Phase 19d: ``save_checkpoint(sharded=True)`` of phase 7d's
    checkpoint configuration (``llama3_8b`` width, 2 layers, f32, SGD
    momentum; 11.9 GB with its states) placed on the ``{'dp': 1, 'tp':
    1}`` mesh with its trainer (``dist_sync``), then ``resume`` into a
    fresh net: the restored weights bit for bit, the next step's loss
    equal to the uninterrupted run's; save and resume seconds beside 7d's
    ``.params`` route; ``drain_consensus()`` on the NCCL group of one."""
    import shutil
    import tempfile

    from mxnet_tpu_torch.gluon import trainer as trainer_mod

    kw = {"learning_rate": 0.01, "momentum": 0.9}

    def make(seed):
        mx.random.seed(seed)
        net = llama.llama3_8b(num_layers=2)
        net.initialize(ctx=mx.gpu(0))
        tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(kw),
                              kvstore="dist_sync",
                              partition_rules=parallel.LLAMA_RULES,
                              mesh=mesh)
        return net, tr

    def one_step(net, tr):
        vocab = net.config.vocab_size
        with mx.autograd.record():
            loss = mx.nd.softmax_cross_entropy(
                net(ids).reshape((-1, vocab)), labels.reshape((-1,))) / \
                labels.size
        loss.backward()
        tr.step(1)
        return float(loss.asscalar())

    free_card(torch)
    net, tr = make(SEED)
    ids, labels = _ids_labels(torch, mx, net.config.vocab_size, 1024,
                              SEED + 12)
    one_step(net, tr)
    saved = {k: p.data()._data.to_local().clone() for k, p in
             net._collect_params_with_prefix().items()}
    ckpt_dir = tempfile.mkdtemp(prefix="mxt_ckpt_sharded_")
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = checkpoint.save_checkpoint(ckpt_dir, 1, net, tr, sharded=True)
        save_s = time.perf_counter() - t
        ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(ckpt_dir) for f in fs)
        with open(os.path.join(path, "manifest.json")) as f:
            sharded = json.load(f).get("sharded")
        loss_a = one_step(net, tr)
        after_a = {k: p.data()._data.to_local().clone() for k, p in
                   net._collect_params_with_prefix().items()}
        del net, tr
        free_card(torch)
        net_r, tr_r = make(SEED + 1)  # other weights: all come from disk
        torch.cuda.synchronize()
        t = time.perf_counter()
        step, _ = checkpoint.resume(ckpt_dir, net_r, tr_r)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t
        exact = all(torch.equal(p.data()._data.to_local(), saved[k])
                    for k, p in net_r._collect_params_with_prefix().items())
        del saved
        loss_b = one_step(net_r, tr_r)
        diff = max((p.data()._data.to_local() - after_a[k]).abs().max()
                   .item() for k, p in
                   net_r._collect_params_with_prefix().items())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    before = trainer_mod.drain_consensus()
    trainer_mod.request_drain()
    after = trainer_mod.drain_consensus()
    trainer_mod.reset_drain()
    ref = STASH.get("ckpt", {})
    ok = sharded is True and step == 1 and exact and loss_a == loss_b and \
        diff == 0.0 and before is False and after is True and \
        torch.distributed.get_backend() == "nccl"
    emit(dict(phase="sharded_checkpoint", layers=2, dtype="float32",
              mesh=parallel.mesh_axes(mesh), step=step,
              restored_exact=exact, loss_uninterrupted=loss_a,
              loss_resumed=loss_b, max_abs_weight_diff=diff,
              checkpoint_bytes=ckpt_bytes, save_s=save_s, resume_s=resume_s,
              params_route_save_s=ref.get("save_s"),
              params_route_resume_s=ref.get("resume_s"),
              params_route_bytes=ref.get("bytes"),
              drain_consensus=[before, after], ok=ok))
    if not ok:
        failures.append(f"sharded checkpoint: step {step}, exact {exact}, "
                        f"loss {loss_b} vs {loss_a}, weights differ by "
                        f"{diff}, drain consensus {before}/{after}")
    del net_r, tr_r, after_a
    free_card(torch)



# Phases 20a-20d: Mixtral-8x7B (MoE) and the rest of multi-GPU (slice 13).
# 32 layers of mixtral_8x7b in bf16 hold 93 GB of weights: the serving
# path runs at 16 layers (46.44 GB of layers, 0.52 GB of embedding and
# head), the training path at 2.  The MoE dispatch, the expert bank and
# the combine are plain torch ops (the reference's are jnp); #1-#3 run on
# the attention.
MOE_CHECK_LAYERS = 1       # 20a: the f32 card-vs-CPU check's depth
MOE_SERVE_LAYERS = 16
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 3        # timed steps, after one warm-up
MOE_FUSED_K = 3
MOE_AUX_W = 0.01
MOE_PROMPT = 128           # 20b: the oracle generate's prompt
MOE_NEW = 8                # ... and its new tokens
MOE_BF16_TOL = 2e-2        # relative norm, bf16 against f32 or the CPU
MOE_EP_CHUNKS = 4          # 20d: virtual ep ranks, 2 experts each
PS_B = 32                  # 20d: resnet18_v1 f32 through dist_async
PS_STEPS = 3


def moe_check_phase(torch, mx, llama, moe, fa, failures):
    """Phase 20a: ``mixtral_8x7b`` widths at MOE_CHECK_LAYERS layers in
    f32, B=1, T=256:
    the weights drawn on the CPU from the seed and copied to the card;
    the logits on the card (#1's FMA design, a launch a layer) against the
    CPU's (the plain versions) within 1e-3 of the largest logit; then
    layer 0's ``MoEMLP`` alone in bf16 at full width on the card against
    the CPU's f32 run on the same bf16 values (the router is f32 on
    both, so the same tokens reach the same slots): the output by
    relative norm, the aux loss within 1e-5."""
    free_card(torch)
    t = time.perf_counter()
    mx.random.seed(SEED)
    cpu_net = llama.mixtral_8x7b(num_layers=MOE_CHECK_LAYERS)
    cpu_net.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    card_net = llama.mixtral_8x7b(num_layers=MOE_CHECK_LAYERS)
    card_net.initialize(mx.init.Zero(), ctx=mx.gpu(0))
    cpu_params = cpu_net._collect_params_with_prefix()
    for name, p in card_net._collect_params_with_prefix().items():
        p.set_data(cpu_params[name].data()._data.cuda())
    init_s = time.perf_counter() - t
    gen = torch.Generator().manual_seed(SEED + 20)
    ids = torch.randint(0, cpu_net.config.vocab_size, (1, 256),
                        generator=gen, dtype=torch.int32)
    _zero_counts(fa)
    got = card_net(mx.nd.array(ids.cuda()))._data.float().cpu()
    launched, mma = fa.flash_attention_fwd.launches, \
        fa.flash_attention_fwd.launches_mma
    t = time.perf_counter()
    ref = cpu_net(mx.nd.array(ids, ctx=mx.cpu()))._data
    cpu_ms = (time.perf_counter() - t) * 1e3
    largest = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    ok = launched == MOE_CHECK_LAYERS and mma == 0 and \
        err <= 1e-3 * largest and bool(torch.isfinite(got).all())
    emit(dict(phase="moe_f32_check", layers=MOE_CHECK_LAYERS, B=1, T=256,
              dtype="float32",
              launches=launched, launches_mma=mma, max_abs_err=err,
              max_abs_logit=largest, tol=1e-3 * largest, init_s=init_s,
              cpu_forward_ms=cpu_ms, ok=ok))
    if not ok:
        failures.append(f"moe f32 check: launches {launched} (tensor-core "
                        f"{mma}), err {err} vs {1e-3 * largest}")
    # layer 0's MoE layer alone: bf16 on the card; on the CPU its plain
    # f32 run on the same bf16 values (weights and input), the witness
    cpu_blk, card_blk = (n.model.layers[0].mlp for n in (cpu_net, card_net))
    del cpu_params, got, ref
    card_blk.cast("bfloat16")
    for p in cpu_blk.collect_params().values():
        p.set_data(p.data()._data.bfloat16().float())
    cfg = cpu_net.config
    x = torch.randn((1, 256, cfg.hidden_size), generator=gen).bfloat16()
    outs = []
    for blk, xx, ctx in ((cpu_blk, x.float(), mx.cpu()),
                         (card_blk, x.cuda(), mx.gpu(0))):
        with moe.collect_aux() as aux:
            y = blk(mx.nd.array(xx, ctx=ctx))
        outs.append((y._data.float().cpu(), aux[0]._data.cpu()))
    y_err = _rel_norm(torch, outs[1][0], outs[0][0])
    aux_err = abs(outs[1][1].item() - outs[0][1].item()) / \
        max(abs(outs[0][1].item()), 1e-30)
    ok = y_err <= MOE_BF16_TOL and aux_err <= 1e-5 and \
        bool(torch.isfinite(outs[1][0]).all())
    emit(dict(phase="moe_bf16_layer_check", B=1, T=256,
              hidden=cfg.hidden_size, intermediate=cfg.intermediate_size,
              experts=cfg.num_experts, capacity=moe.capacity(
                  256, cfg.num_experts_per_tok, cfg.capacity_factor,
                  cfg.num_experts), rel_err=y_err, aux=outs[1][1].item(),
              aux_cpu=outs[0][1].item(), aux_rel_err=aux_err,
              tol=MOE_BF16_TOL, ok=ok))
    if not ok:
        failures.append(f"moe bf16 layer: relative error {y_err}, aux "
                        f"{aux_err}")
    del cpu_net, card_net, cpu_blk, card_blk, outs
    free_card(torch)


def moe_flops(cfg, t, causal=True):
    """Forward FLOPs of one Mixtral layer at ``t`` tokens (B=1).  The
    work the function needs (``useful``, which the bounds read): the
    projections, the attention products and the k·t routed token rows
    through the expert bank.  Beside it, what the port's fixed-capacity
    formulation adds: the bank's padding to capacity (E·C − k·t rows)
    and the one-hot dispatch and combine einsums (``computed`` is all
    of it; ``PERF.md``'s reckoning)."""
    h, i, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    k = cfg.num_experts_per_tok
    kvd = cfg.num_kv_heads * cfg.head_dim
    c = min(max(1, math.ceil(t * k * cfg.capacity_factor / e)), t)
    proj = 2 * t * h * (2 * h + 2 * kvd)
    attn = 2 * 2 * visible_pairs(t, t, causal) * h
    bank = 3 * 2 * k * t * h * i
    padding = 3 * 2 * max(0, e * c - k * t) * h * i
    route = 2 * 2 * t * e * c * h
    useful = proj + attn + bank
    return dict(projections=proj, attention=attn, bank_routed_rows=bank,
                useful=useful, capacity_padding=padding,
                dispatch_combine=route, computed=useful + padding + route)


def mixtral_infer_phase(torch, mx, llama, fa, failures):
    """Phase 20b: ``mixtral_8x7b`` at full width and 16 layers in bf16
    (23.22 B parameters), weights drawn on the card from the seed: one
    warm-up and three prompt forwards at B=1, T=2048 (16 tensor-core
    launches of #1 each), ms beside the reckoned bound, peak memory;
    then greedy ``generate`` of 8 tokens from a 128-token prompt on the
    oracle route (an MoE net re-forwards the sequence a token), twice:
    ms a token and the tokens of the two runs equal.  The counts are set
    to 0 just before the forwards and read after the second generate."""
    free_card(torch)
    t = time.perf_counter()
    mx.random.seed(SEED)
    net = llama.mixtral_8x7b(num_layers=MOE_SERVE_LAYERS)
    net.cast("bfloat16")
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    torch.cuda.synchronize()
    cfg = net.config
    params = sum(p.data().size for p in net.collect_params().values())
    emit(dict(phase="moe_init", layers=MOE_SERVE_LAYERS,
              seconds=time.perf_counter() - t, params=params,
              memory_allocated=torch.cuda.memory_allocated()))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 21)
    ids = mx.nd.array(torch.randint(0, cfg.vocab_size, (1, 2048),
                                    generator=gen, device="cuda",
                                    dtype=torch.int32))
    fl = moe_flops(cfg, 2048)
    head = 2 * 2048 * cfg.hidden_size * cfg.vocab_size
    flops = MOE_SERVE_LAYERS * fl["useful"] + head
    bound = roofline_ms(flops, 2 * params, "bfloat16")[0]
    # what the fixed-capacity formulation computes besides, at that rate
    overhead_ms = {key: roofline_ms(MOE_SERVE_LAYERS * fl[key], 0,
                                    "bfloat16")[0]
                   for key in ("capacity_padding", "dispatch_combine")}
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fa)  # the main path starts here
    times, ok_all = [], True
    for run_i in range(4):  # the first warms up cuBLAS
        before = fa.flash_attention_fwd.launches
        before_mma = fa.flash_attention_fwd.launches_mma
        torch.cuda.synchronize()
        t = time.perf_counter()
        with mx.autograd.pause():
            logits = net(ids)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launched = fa.flash_attention_fwd.launches - before
        mma = fa.flash_attention_fwd.launches_mma - before_mma
        finite = bool(torch.isfinite(logits._data).all())
        ok = launched == mma == MOE_SERVE_LAYERS and finite and \
            logits.shape == (1, 2048, cfg.vocab_size)
        ok_all &= ok
        if run_i:
            times.append(ms)
        emit(dict(phase="moe_prompt_forward", run=run_i, warmup=run_i == 0,
                  B=1, T=2048, ms=ms, tokens_per_s=2048 / ms * 1e3,
                  bound_ms=bound, launches=launched, launches_mma=mma,
                  finite=finite, ok=ok))
        del logits
    peak_fwd = torch.cuda.max_memory_allocated()
    prompt = mx.nd.array(torch.randint(0, cfg.vocab_size, (1, MOE_PROMPT),
                                       generator=gen, device="cuda",
                                       dtype=torch.int32))
    runs = []
    for run_i in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = net.generate(prompt, max_new_tokens=MOE_NEW)
        torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t) * 1e3, out._data.clone()))
    launches = fa.flash_attention_fwd.launches  # the main path ends here
    launches_mma = fa.flash_attention_fwd.launches_mma
    same = bool(torch.equal(runs[0][1], runs[1][1]))
    want = MOE_SERVE_LAYERS * (4 + 2 * MOE_NEW)
    ok = ok_all and same and launches == launches_mma == want and \
        runs[1][1].shape == (1, MOE_PROMPT + MOE_NEW) and \
        not net.__dict__.get("_kv_decoders")
    # a token of the oracle route: one forward of the whole sequence
    token_bound = roofline_ms(
        MOE_SERVE_LAYERS * moe_flops(cfg, MOE_PROMPT)["useful"] + 2 *
        MOE_PROMPT * cfg.hidden_size * cfg.vocab_size, 2 * params,
        "bfloat16")[0]
    emit(dict(phase="moe_serving", layers=MOE_SERVE_LAYERS, params=params,
              prompt_forward_ms=times, forward_bound_ms=bound,
              forward_gflop=flops / 1e9,
              layer_gflop={k: v / 1e9 for k, v in fl.items()},
              overhead_ms_at_peak=overhead_ms,
              prompt=MOE_PROMPT, new_tokens=MOE_NEW,
              generate_ms=[r[0] for r in runs],
              ms_per_token=[r[0] / MOE_NEW for r in runs],
              weight_read_bound_ms_per_token=token_bound,
              tokens_equal_across_runs=same,
              tokens=runs[1][1][0, MOE_PROMPT:].tolist(),
              launches=launches, launches_mma=launches_mma,
              launches_expected=want,
              peak_forward_bytes=peak_fwd,
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              ok=ok))
    if not ok:
        failures.append(f"moe serving: launches {launches} (tensor-core "
                        f"{launches_mma}, want {want}), tokens equal "
                        f"{same}")
    del net, runs, out, ids, prompt
    free_card(torch)
    return launches, launches_mma


def _moe_net(mx, llama, layers):
    mx.random.seed(SEED)
    net = llama.mixtral_8x7b(num_layers=layers)
    net.cast("bfloat16")
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    return net


def _moe_step(mx, moe, net, trainer, ids, labels, aux_w=MOE_AUX_W):
    """One eager step of cross entropy + aux_w·Σaux → (loss, aux)."""
    with moe.collect_aux() as aux:
        loss = _lm_forward(mx, net, ids, labels)
        with mx.autograd.record():
            loss = loss + aux_w * sum(aux)
    loss.backward()
    trainer.step(1)
    return float(loss.asscalar()), [float(a.asscalar()) for a in aux]


def mixtral_train_phase(torch, mx, llama, moe, fa, mt, failures):
    """Phase 20c: ``mixtral_8x7b`` at full width and 2 layers in bf16,
    B=1, T=2048, phase 9's optimizer (SGD lr 0.1, momentum 0.9):
    ``with collect_aux()``: loss + 0.01·Σaux → ``backward`` →
    ``Trainer.step``, one warm-up and three timed steps, each 2/2/2
    tensor-core launches of #1-#3 and one update launch; ms and peak.
    Then the same net without aux under ``FusedTrainStep`` (K=3) against
    three eager steps from the same weights (phase 7d's 1e-5 relative),
    and ``collect_aux`` inside the capture raises."""
    free_card(torch)
    net = _moe_net(mx, llama, MOE_TRAIN_LAYERS)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": TRAIN_LR, "momentum": 0.9})
    ids, labels = _ids_labels(torch, mx, net.config.vocab_size, 2048,
                              SEED + 22)
    fl = moe_flops(net.config, 2048)
    head = 2 * 2048 * net.config.hidden_size * net.config.vocab_size
    step_flops = 3 * (MOE_TRAIN_LAYERS * fl["useful"] + head)
    nbytes = 2 * sum(p.data().size for p in net.collect_params().values())
    # the forward's and the backward's products (3x the forward), and the
    # weights read twice, the gradients written once, the momentum read
    # and written once
    bound = roofline_ms(step_flops, 5 * nbytes, "bfloat16")[0]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fa)  # the main path starts here
    mt.multi_tensor_update.launches = 0
    losses, auxes, step_ms = [], [], []
    for step in range(1 + MOE_TRAIN_STEPS):
        before = [c.launches for c in _counters(fa)]
        before_mma = _mma_counts(fa)
        mt_before = mt.multi_tensor_update.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, aux = _moe_step(mx, moe, net, trainer, ids, labels)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launched = [c.launches - n for c, n in zip(_counters(fa), before)]
        mma = [c - n for c, n in zip(_mma_counts(fa), before_mma)]
        upd = mt.multi_tensor_update.launches - mt_before
        losses.append(loss)
        auxes.append(aux)
        if step:
            step_ms.append(ms)
        ok = math.isfinite(loss) and launched == mma == \
            [MOE_TRAIN_LAYERS] * 3 and upd == 1 and len(aux) == 2
        emit(dict(phase="moe_train_step", step=step, warmup=step == 0,
                  loss=loss, aux=aux, ms=ms, tokens_per_s=2048 / ms * 1e3,
                  bound_ms=bound, launches=dict(zip(("fwd", "dq", "dkv"),
                                                     launched)),
                  launches_mma=dict(zip(("fwd", "dq", "dkv"), mma)),
                  update_launches=upd, ok=ok))
        if not ok:
            failures.append(f"moe train step {step}: loss {loss}, aux "
                            f"{aux}, launches {launched} (tensor-core "
                            f"{mma}), update launches {upd}")
    launches = [c.launches for c in _counters(fa)]  # the main path ends
    launches_mma = _mma_counts(fa)
    updates = mt.multi_tensor_update.launches
    peak = torch.cuda.max_memory_allocated()
    STASH["moe_train"] = dict(losses=losses, step_ms=step_ms)
    if not losses[-1] < losses[0]:
        failures.append(f"moe training loss did not fall: {losses}")
    del net, trainer
    free_card(torch)

    # the same net without aux: three eager steps, then FusedTrainStep
    def lm_loss(n, a, b):
        vocab = n.config.vocab_size
        return mx.nd.softmax_cross_entropy(
            n(a).reshape((-1, vocab)), b.reshape((-1,))) / b.size

    net = _moe_net(mx, llama, MOE_TRAIN_LAYERS)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": TRAIN_LR, "momentum": 0.9})
    eager = []
    for _ in range(MOE_FUSED_K):
        with mx.autograd.record():
            loss = lm_loss(net, ids, labels)
        loss.backward()
        tr.step(1)
        eager.append(float(loss.asscalar()))
    del net, tr, loss
    free_card(torch)
    net = _moe_net(mx, llama, MOE_TRAIN_LAYERS)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": TRAIN_LR, "momentum": 0.9})
    fstep = mx.gluon.FusedTrainStep(net, tr, lm_loss,
                                    steps_per_execution=MOE_FUSED_K,
                                    batch_size=1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fused = fstep(ids, labels).asnumpy().tolist()
    first_call_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    again = fstep(ids, labels).asnumpy().tolist()
    replay_ms = (time.perf_counter() - t) * 1e3 / MOE_FUSED_K
    graph = next(iter(fstep._graphs.values()))["graph"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(fused, eager))
    refused = ""
    try:
        with moe.collect_aux():
            mx.gluon.FusedTrainStep(net, tr, lm_loss, steps_per_execution=2,
                                    batch_size=1)(ids, labels)
    except mx.MXNetError as e:
        refused = str(e)
    ok = rel <= 1e-5 and "hybridize" in refused and \
        all(math.isfinite(v) for v in again)
    emit(dict(phase="moe_train", layers=MOE_TRAIN_LAYERS, B=1, T=2048,
              losses=losses, aux=auxes, step_ms=step_ms, bound_ms=bound,
              step_gflop=step_flops / 1e9,
              step_overhead_gflop={
                  key: 3 * MOE_TRAIN_LAYERS * fl[key] / 1e9
                  for key in ("capacity_padding", "dispatch_combine")},
              launches=dict(zip(("fwd", "dq", "dkv"), launches)),
              launches_mma=dict(zip(("fwd", "dq", "dkv"), launches_mma)),
              update_launches=updates, max_memory_allocated=peak,
              fused_losses=fused, eager_losses=eager,
              fused_max_rel_err=rel, fused_next_losses=again,
              fused_step_ms=replay_ms, fused_first_call_s=first_call_s,
              graph_pool_bytes=graph.pool_bytes,
              collect_aux_in_capture=refused, ok=ok))
    if not ok:
        failures.append(f"moe fused step: losses {fused} vs {eager} "
                        f"({rel}), collect_aux refusal {refused!r}")
    del net, tr, fstep, graph
    free_card(torch)
    return launches, launches_mma, updates



def moe_mesh_phase(torch, mx, llama, moe, fa, mt, parallel, vision,
                   failures):
    """Phase 20d: the mesh and the store.  (1) 20c's net, seed and batch
    through ``Trainer(kvstore="dist_sync", partition_rules=MIXTRAL_RULES,
    mesh={'ep': 1})`` on the NCCL group of one: the DTensor route with
    the banks replicated (a size-1 ``ep`` axis shards nothing, so the
    per-expert slicing of the ep route runs only in (2) and in the gloo
    tests; the placement is checked), the losses step for step against
    20c's, #1-#3 2/2/2 a step; (2) the ep body over 4
    virtual ranks of 2 experts each on the card (layer widths of
    ``mixtral_8x7b``, bf16, T=2048; as 18c cuts attention): each rank's
    experts on its bank slices, summed, against the unsharded layer, and
    the times of both; (3) ``resnet18_v1`` f32 B=32, three steps through
    ``Trainer(kvstore=dist_async)``, against a parameter server on
    127.0.0.1 with a per-run secret and in process (no wire), in
    lockstep with the ``device`` store's steps on the same gradients:
    the losses and the weights within 1e-5, each server's table on the
    card and updated there by the fused multi-tensor kernel, and
    push+pull ms a step."""
    import secrets

    from mxnet_tpu_torch.kvstore import dist_async

    # (1) the mesh route on the group of one (ep=1: banks replicated)
    free_card(torch)
    mesh = parallel.make_mesh({"ep": 1})
    net = _moe_net(mx, llama, MOE_TRAIN_LAYERS)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": TRAIN_LR, "momentum": 0.9},
                               kvstore="dist_sync",
                               partition_rules=parallel.MIXTRAL_RULES,
                               mesh=mesh)
    ids, labels = _ids_labels(torch, mx, net.config.vocab_size, 2048,
                              SEED + 22)
    _zero_counts(fa)  # the mesh route's main path starts here
    losses, step_ms = [], []
    for step in range(1 + MOE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(_moe_step(mx, moe, net, trainer, ids, labels)[0])
        torch.cuda.synchronize()
        if step:
            step_ms.append((time.perf_counter() - t) * 1e3)
    launches = [c.launches for c in _counters(fa)]  # ... ends
    launches_mma = _mma_counts(fa)
    want = STASH.get("moe_train", {})
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(losses, want.get("losses", [float("nan")])))
    placed = str(net.model.layers[0].mlp.gate_weight.data()._data
                 .placements)
    parallel.set_mesh(None)
    ok = rel <= 1e-5 and placed == "(Replicate(),)" and \
        launches == launches_mma == \
        [MOE_TRAIN_LAYERS * (1 + MOE_TRAIN_STEPS)] * 3
    emit(dict(phase="moe_mesh_ep1", mesh={"ep": 1},
              route="DTensor, banks replicated (ep=1 shards nothing)",
              losses=losses,
              losses_20c=want.get("losses"), max_rel_loss_diff=rel,
              step_ms=step_ms, step_ms_20c=want.get("step_ms"),
              bank_placements=placed,
              launches=dict(zip(("fwd", "dq", "dkv"), launches)),
              launches_mma=dict(zip(("fwd", "dq", "dkv"), launches_mma)),
              ok=ok))
    if not ok:
        failures.append(f"moe mesh ep=1: losses {losses} vs 20c's "
                        f"{want.get('losses')}, launches {launches}, "
                        f"bank placements {placed}")
    del net, trainer
    free_card(torch)

    # (2) the ep body over virtual ranks
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 23)
    widths = llama.LLAMA_CONFIGS["mixtral_8x7b"]
    h, i, e, t = (widths["hidden_size"], widths["intermediate_size"],
                  widths["num_experts"], 2048)

    def rnd(*shape, scale=0.02):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16) * scale

    x, rw = rnd(t, h, scale=1.0), rnd(e, h)
    gw, uw, dw = rnd(e, i, h), rnd(e, i, h), rnd(e, h, i)
    c = moe.capacity(t, 2, 1.25, e)
    with torch.no_grad():
        disp, comb, _ = moe.route(x, rw, e, 2, c, "topk")
        whole = moe.experts(x, disp, comb, gw, uw, dw)
        per = e // MOE_EP_CHUNKS

        def body():
            return sum(moe.experts(x, disp[:, r * per:(r + 1) * per],
                                   comb[:, r * per:(r + 1) * per],
                                   gw[r * per:(r + 1) * per],
                                   uw[r * per:(r + 1) * per],
                                   dw[r * per:(r + 1) * per])
                       for r in range(MOE_EP_CHUNKS))

        summed = body()
        err = _rel_norm(torch, summed, whole)
        whole_ms = time_ms(torch, lambda: moe.experts(
            x, disp, comb, gw, uw, dw), 5)
        body_ms = time_ms(torch, body, 5)
        route_ms = time_ms(torch, lambda: moe.route(x, rw, e, 2, c, "topk"),
                           5)
    kept = int(disp.sum().item())
    ok = err <= MOE_BF16_TOL and bool(torch.isfinite(summed).all())
    emit(dict(phase="moe_ep_body", virtual_ranks=MOE_EP_CHUNKS,
              experts_per_rank=per, T=t, capacity=c, tokens_kept=kept,
              tokens_routed=2 * t, rel_err=err, tol=MOE_BF16_TOL,
              unsharded_ms=whole_ms, summed_bodies_ms=body_ms,
              route_ms=route_ms, ok=ok))
    if not ok:
        failures.append(f"moe ep body: relative error {err}")
    del x, rw, gw, uw, dw, disp, comb, whole, summed
    free_card(torch)

    # (3) dist_async: a parameter server on 127.0.0.1, a per-run secret.
    # The two nets step in lockstep from the same weights, and the
    # dist_async net's gradients are replaced by the device net's before
    # each update: cuDNN's backward (and max pooling's) sums in no fixed
    # order, so two runs of one step differ in the last bits, and the
    # comparison is to hold the store alone
    gen.manual_seed(SEED + 24)
    xb = mx.nd.array(torch.rand((PS_B, 3, 224, 224), generator=gen,
                                device="cuda"))
    yb = mx.nd.array(torch.randint(0, 1000, (PS_B,), generator=gen,
                                   device="cuda").float())
    secret = secrets.token_hex(16)
    uri = f"127.0.0.1:{parallel.free_port()}"
    srv = dist_async.serve_forever(uri, secret=secret)
    free_card(torch)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    nets, trainers, rows = {}, {}, {}
    stores = {"device": lambda: "device",
              "dist_async": lambda: dist_async.AsyncPSKVStore(
                  root_uri=uri, secret=secret),
              "dist_async_in_process": dist_async.AsyncPSKVStore}
    try:
        for store, make_kv in stores.items():
            mx.random.seed(SEED)
            net = vision.resnet18_v1(classes=1000)
            net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
            net(mx.nd.zeros((1, 3, 224, 224), ctx=mx.gpu(0)))
            kv = make_kv()
            nets[store] = net
            trainers[store] = mx.gluon.Trainer(
                net.collect_params(), "sgd",
                {"learning_rate": 0.05, "momentum": 0.9}, kvstore=kv)
            rows[store] = dict(losses=[], step_update_ms=[],
                               update_launches=[])
        for _ in range(PS_STEPS):
            for store, net in nets.items():
                with mx.autograd.record():
                    loss = loss_fn(net(xb), yb).mean()
                loss.backward()
                rows[store]["losses"].append(float(loss.asscalar()))
            for store in ("dist_async", "dist_async_in_process"):
                for pd, pa in zip(nets["device"].collect_params().values(),
                                  nets[store].collect_params().values()):
                    if pd.grad_req != "null":
                        pa.grad()._data.copy_(pd.grad()._data)
            for store, tr in trainers.items():
                torch.cuda.synchronize()
                mt.multi_tensor_update.launches = 0  # this store's step
                t0 = time.perf_counter()
                tr.step(1)  # a dist_async step ends in its pulls
                torch.cuda.synchronize()
                rows[store]["step_update_ms"].append(
                    (time.perf_counter() - t0) * 1e3)
                rows[store]["update_launches"].append(
                    mt.multi_tensor_update.launches)  # ... ends
        for store, tr in trainers.items():
            rows[store].update(type=tr._kvstore.type,
                               update_on_kvstore=tr._update_on_kvstore)
        rows["dist_async"]["server_table_device"] = str(srv.ps.device)
        rows["dist_async_in_process"]["server_table_device"] = str(
            trainers["dist_async_in_process"]._kvstore._local.device)
        pdev = nets["device"]._collect_params_with_prefix()
        w_rel = max(_rel_norm(torch, p.data()._data, pdev[k].data()._data)
                    for store in ("dist_async", "dist_async_in_process")
                    for k, p in nets[store]
                    ._collect_params_with_prefix().items())
        for store in ("dist_async", "dist_async_in_process"):
            trainers[store]._kvstore.close()
    finally:
        srv.shutdown()
        srv.server_close()
    rel = max(abs(a - b) / abs(b)
              for store in ("dist_async", "dist_async_in_process")
              for a, b in zip(rows[store]["losses"],
                              rows["device"]["losses"]))
    ok = rel <= 1e-5 and w_rel <= 1e-5 and all(
        rows[store]["update_on_kvstore"] and
        rows[store]["type"] == "dist_async" and
        rows[store]["server_table_device"].startswith("cuda") and
        min(rows[store]["update_launches"]) >= 1
        for store in ("dist_async", "dist_async_in_process"))
    emit(dict(phase="dist_async", net="resnet18_v1", dtype="float32",
              B=PS_B, server=uri, signed=True, stores=rows,
              max_rel_loss_diff=rel, max_rel_weight_diff=w_rel, ok=ok))
    if not ok:
        failures.append(f"dist_async: {rows}, loss diff {rel}, weight "
                        f"diff {w_rel}")
    del nets, trainers
    free_card(torch)
    server_updates = sum(sum(rows[store]["update_launches"]) for store in
                         ("dist_async", "dist_async_in_process"))
    return launches, launches_mma, server_updates


# -- slice 14: int8 inference and recurrent nets ------------------------------
INT8_B = 128                 # 21b: bench.py's ResNet-50 batch
INT8_IMAGE = 224
INT8_CALIB_BATCHES = 2
INT8_CHECK_B = 4
# 21b's B=4 check: the card's int8 net against the CPU's on the same
# weights, each calibrated on the same batch.  Every int32 product is
# exact on both; the float steps between (dequantize, BatchNorm, ReLU)
# may round 1 ulp apart and move an element across a rounding edge of
# the next quantization (one int8 step, 1/127 of a layer's range): the
# logits within 2e-2 by relative norm
INT8_CPU_TOL = 2e-2
# 21b: the replayed graph against the eager int8 forward, relative norm
# (the same kernels on the same inputs)
INT8_GRAPH_TOL = 1e-5
# 21c: each served reply against its request's solo int8 forward, as 21b
INT8_SERVE_TOL = 2e-2
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 (data sheet, 700 W)
# 22a: nd.RNN on the card against the CPU, f32 (no TF32): every output
# and gradient within this share of its tensor's largest value (the same
# products summed in other orders through 2 layers and 24 steps)
RNN_TOL = 1e-4
RNN_T, RNN_N, RNN_C, RNN_H = 24, 8, 64, 128
# 22b: the LSTM word language model of the upstream MXNet Gluon example
# (example/gluon/word_language_model; its widths recalled, the upstream
# tree is not in this repository): embedding and hidden 650, 2 layers,
# dropout 0.5, tied weights, bptt 35, batch 32, WikiText-2's 33,278-word
# vocabulary, SGD lr 20, gradient clip 0.25
WLM_VOCAB = 33278
WLM_UNITS = 650
WLM_LAYERS = 2
WLM_DROPOUT = 0.5
WLM_BPTT = 35
WLM_B = 32
WLM_LR = 20.0
WLM_CLIP = 0.25
WLM_STEPS = 5                # timed eager steps, after 2 warm-ups
WLM_K = 5                    # FusedTrainStep steps a call
# 22c: the BiLSTM + CTC net of examples/train_ctc_ocr.py at its shapes
CTC_B, CTC_T, CTC_FEAT, CTC_HID = 32, 32, 8, 32
CTC_CLASSES, CTC_LABEL, CTC_STEPS = 10, 6, 5
CTC_TOL = 1e-5               # ctc_loss card vs CPU and vs F.ctc_loss (f32)


def _conv_macs(mx, net, x):
    """Multiply-adds of every ``Conv2D`` and ``Dense`` of ``net`` in one
    forward of ``x``, read off forward hooks (each output's size times
    its reduction length)."""
    nn = mx.gluon.nn
    macs, handles = [], []

    def hook(block, inputs, out):
        w = block.weight.shape
        per = math.prod(w[1:]) if isinstance(block, nn.Conv2D) else w[1]
        macs.append(math.prod(out.shape) * per)

    net.apply(lambda b: handles.append(b.register_forward_hook(hook))
              if isinstance(b, (nn.Conv2D, nn.Dense)) else None)
    net(x)
    for h in handles:
        h.detach()
    return sum(macs)


def _quantized_layers(mx, net):
    """(layers with the int8 chain, ``Conv2D`` and ``Dense`` layers)."""
    nn = mx.gluon.nn
    blocks = []
    net.apply(blocks.append)
    layers = [b for b in blocks if isinstance(b, (nn.Conv2D, nn.Dense))]
    return sum("hybrid_forward" in b.__dict__ for b in layers), len(layers)


def int8_ops_phase(torch, mx, failures):
    """Phase 21a: each quantized op on the card against the port's CPU
    route on the same inputs: the int32 and int8 outputs equal, the
    ranges within f32 rounding.  Covers K = 147 (ResNet's 7x7x3 stem, not
    a multiple of 8), M <= 16, int8 convs with stride, padding and
    dilation, and the uint8 FC path at its range row (the top of int32,
    where the cast saturates); then the int8 product alone at ResNet-50's
    3x3x512 reduction, exact, with its time."""
    from mxnet_tpu_torch.ops import quantization as q

    rs = np.random.RandomState(SEED + 21)
    rows = []

    def both(fn, *arrays):
        outs = []
        for ctx in (mx.gpu(0), mx.cpu()):
            res = fn(*[mx.nd.array(a, ctx=ctx) for a in arrays])
            outs.append([r._data.cpu() for r in res])
        return outs

    def same(name, outs):
        card, cpu = outs
        equal = all(torch.allclose(a, b, rtol=1e-6, atol=0)
                    if a.is_floating_point() else torch.equal(a, b)
                    for a, b in zip(card, cpu))
        top = max(int(r.long().abs().max()) for r in card
                  if not r.is_floating_point())
        rows.append(dict(case=name, shape=list(card[0].shape),
                         dtype=str(card[0].dtype).replace("torch.", ""),
                         equal=equal, largest_abs=top))
        if not equal:
            failures.append(f"int8 op {name}: the card differs from the CPU")

    def fc(data_type, m, k, n):
        x = rs.normal(0, 1, (m, k)).astype(np.float32)
        w = rs.normal(0, 0.2, (n, k)).astype(np.float32)

        def f(xa, wa):
            qd = mx.nd.quantize_v2(xa, out_type=data_type)
            qw = mx.nd.quantize_v2(wa)
            return mx.nd.quantized_fully_connected(
                qd[0], qw[0], qd[1], qd[2], qw[1], qw[2], no_bias=True,
                num_hidden=n)
        return both(f, x, w)

    for data_type, m, k, n in (("int8", 4, 147, 64), ("int8", 16, 2048, 1000),
                               ("int8", 128, 2048, 1000),
                               ("uint8", 9, 147, 13), ("uint8", 64, 512, 24)):
        same(f"fc_{data_type}_m{m}_k{k}_n{n}", fc(data_type, m, k, n))
    for name, xs, ws, stride, pad, dil in (
            ("stem_7x7_k147", (4, 3, 224, 224), (64, 3, 7, 7), 2, 3, 1),
            ("3x3_s1", (8, 64, 56, 56), (64, 64, 3, 3), 1, 1, 1),
            ("3x3_s2_dil2", (2, 32, 29, 31), (48, 32, 3, 3), 2, 2, 2),
            ("1x1_s2", (8, 256, 56, 56), (512, 256, 1, 1), 2, 0, 1),
            ("1x1_m9", (1, 512, 3, 3), (40, 512, 1, 1), 1, 0, 1)):
        x = rs.normal(0, 1, xs).astype(np.float32)
        w = rs.normal(0, 0.1, ws).astype(np.float32)

        def f(xa, wa, ws=ws, stride=stride, pad=pad, dil=dil):
            qd = mx.nd.quantize_v2(xa)
            qw = mx.nd.quantize_v2(wa)
            return mx.nd.quantized_conv(
                qd[0], qw[0], qd[1], qd[2], qw[1], qw[2], no_bias=True,
                kernel=ws[2:], stride=stride, pad=pad, dilate=dil,
                num_filter=ws[0])
        same(f"conv_{name}", both(f, x, w))

    def chain(xa):
        qd = mx.nd.quantize_v2(xa)
        mn = mx.nd.array([-4.0], ctx=xa.context)
        mx_ = mx.nd.array([4.0], ctx=xa.context)
        acc = mx.nd.array(qd[0]._data.int() * 3000, ctx=xa.context)
        r = mx.nd.requantize(acc, mn, mx_)
        return mx.nd.quantized_flatten(*mx.nd.quantized_pooling(
            *r, kernel=(2, 2), pool_type="max", stride=(2, 2)))

    same("requantize_pool_flatten", both(
        chain, rs.normal(0, 1, (8, 64, 28, 28)).astype(np.float32)))
    a = torch.randint(-127, 128, (6272, 4608), dtype=torch.int8,
                      device="cuda")
    w = torch.randint(-127, 128, (512, 4608), dtype=torch.int8,
                      device="cuda")
    exact = torch.equal(q._int8_matmul(a, w).cpu(),
                        q._int8_matmul(a.cpu(), w.cpu()))
    ms = time_ms(torch, lambda: q._int8_matmul(a, w), 20)
    # the same product with the weight copied K-major, (K, N) row-major
    # (cuBLASLt's "NN" int8 layout): a yardstick of the layout choice
    wkn = w.t().contiguous()
    nn_ms = time_ms(torch, lambda: torch._int_mm(a, wkn), 20)
    ops = 2 * 6272 * 4608 * 512
    ok = all(r["equal"] for r in rows) and exact
    emit(dict(phase="int8_ops", nvidia_smi=_card(), cases=rows,
              int_mm=dict(m=6272, k=4608, n=512, exact=exact, ms=ms,
                          tops=ops / ms / 1e9, nn_layout_ms=nn_ms,
                          bound_ms=ops / PEAK_INT8_OPS * 1e3), ok=ok))
    if not exact:
        failures.append("int8 product at 6272x4608x512: card != CPU")
    del a, w, wkn


def int8_resnet_phase(torch, mx, vision, cbr, failures):
    """Phase 21b: ``quantize_net`` on ``resnet50_v1`` (f32 weights from
    the seed, 224x224), calibrated on INT8_CALIB_BATCHES seeded batches
    of INT8_B; the int8 forward at B=INT8_B eagerly and hybridized, with
    images/s, peak memory and the bound (int8 operations at the dense
    int8 rate against the bytes at 3.35 TB/s), its top-1 agreement with
    the f32 net and the logits' relative distance; #4 launches 0 times
    (every 1x1 conv is rewritten, so none fuses).  Then the same weights
    on the card and on the CPU at B=INT8_CHECK_B, each calibrated on the
    same batch, within INT8_CPU_TOL."""
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.convert import load_numpy_params

    free_card(torch)
    gpu = mx.gpu(0)
    arrays = _resnet_arrays(torch, mx, vision.resnet50_v1,
                            (1, 3, INT8_IMAGE, INT8_IMAGE))
    STASH["int8_arrays"] = arrays
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 22)

    def batch(b):
        return mx.nd.array(torch.rand((b, 3, INT8_IMAGE, INT8_IMAGE),
                                      generator=gen, device="cuda"))

    calib = [batch(INT8_B) for _ in range(INT8_CALIB_BATCHES)]
    x = batch(INT8_B)
    f32 = vision.resnet50_v1()
    load_numpy_params(f32, arrays, ctx=gpu)
    ref = f32(x)._data.clone()
    f32_ms = time_ms(torch, lambda: f32(x), 3)
    del f32
    net = vision.resnet50_v1()
    load_numpy_params(net, arrays, ctx=gpu)
    torch.cuda.synchronize()
    t = time.perf_counter()
    quantize_net(net, calib_data=calib, calib_mode="naive")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t
    done, total = _quantized_layers(mx, net)
    macs = _conv_macs(mx, net, x)
    fn = cbr.fused_matmul_affine_relu
    fn.launches = fn.launches_mma = 0  # the int8 path starts here
    res = {}
    for mode in ("eager", "graph"):
        if mode == "graph":
            net.hybridize(static_alloc=True, static_shape=True)
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(4):  # a warm-up (the capture), then three
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = net(x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        warm = sum(ms[1:]) / 3
        res[mode] = dict(
            ms=ms, warm_ms=warm, images_per_s=INT8_B / warm * 1e3,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            out=out._data.clone())
        del out
    fused_launches = fn.launches  # ... and ends here
    net.hybridize(False)
    got = res["eager"].pop("out")
    graph_norm = _rel_norm(torch, res["graph"].pop("out"), got)
    agree = float((got.argmax(1) == ref.argmax(1)).float().mean())
    dist = _rel_norm(torch, got, ref)
    ops = 2 * macs
    # the images read once (f32), the weights once (int8), the logits
    nbytes = x._data.numel() * 4 + sum(a.size for a in arrays.values()) \
        + INT8_B * 1000 * 4
    bound_ops = ops / PEAK_INT8_OPS * 1e3
    bound_bytes = nbytes / PEAK_BYTES * 1e3
    xc = torch.rand((INT8_CHECK_B, 3, INT8_IMAGE, INT8_IMAGE),
                    generator=torch.Generator().manual_seed(SEED + 23))
    outs = []
    for ctx in (gpu, mx.cpu()):
        n = vision.resnet50_v1()
        load_numpy_params(n, arrays, ctx=ctx)
        xa = mx.nd.array(xc, ctx=ctx)
        quantize_net(n, calib_data=[xa], calib_mode="naive")
        outs.append(n(xa)._data.float().cpu())
        del n
    cpu_norm = _rel_norm(torch, outs[0], outs[1])
    cpu_agree = float((outs[0].argmax(1) == outs[1].argmax(1))
                      .float().mean())
    ok = done == total == 54 and fused_launches == 0 and \
        bool(torch.isfinite(got).all()) and graph_norm <= INT8_GRAPH_TOL \
        and cpu_norm <= INT8_CPU_TOL
    emit(dict(phase="int8_resnet", nvidia_smi=_card(), net="resnet50_v1",
              B=INT8_B, image=INT8_IMAGE, calib_batches=INT8_CALIB_BATCHES,
              quantize_net_s=quant_s, quantized_layers=done, layers=total,
              fused_launches=fused_launches, eager=res["eager"],
              graph=res["graph"], f32_forward_ms=f32_ms,
              int8_gop=ops / 1e9, bound_ms=max(bound_ops, bound_bytes),
              bound_by="operations" if bound_ops >= bound_bytes else "bytes",
              bound_ops_ms=bound_ops, bound_bytes_ms=bound_bytes,
              top1_agreement_with_f32=agree, logits_rel_norm_vs_f32=dist,
              graph_rel_norm_vs_eager=graph_norm, graph_tol=INT8_GRAPH_TOL,
              cpu_check=dict(B=INT8_CHECK_B, rel_norm=cpu_norm,
                             top1_agreement=cpu_agree, tol=INT8_CPU_TOL),
              ok=ok))
    if not ok:
        failures.append(f"int8 resnet: {done}/{total} layers quantized, #4 "
                        f"launched {fused_launches} times, graph vs eager "
                        f"{graph_norm}, card vs CPU {cpu_norm}")
    del net, calib, x, res, got, ref
    free_card(torch)


def int8_serve_phase(torch, mx, vision, serving, failures):
    """Phase 21c: 21b's ResNet-50 weights through ``InferenceServer`` with
    ``ServerConfig(int8=True, calib_data=...)`` (``quantize_net`` on two
    batches of 32 of the requests, naive) and phase 14's traffic: 64
    requests from 8 clients in nine waves, max_batch 32; the rate and
    latencies over the later eight waves beside phase 14's bf16 ones;
    every reply against its request's solo int8 forward."""
    from mxnet_tpu_torch.convert import load_numpy_params

    free_card(torch)
    gpu = mx.gpu(0)
    net = vision.resnet50_v1()
    load_numpy_params(net, STASH["int8_arrays"], ctx=gpu)
    rng = np.random.RandomState(SEED + 14)  # phase 14's requests
    images = [rng.rand(3, SERVE_IMAGE, SERVE_IMAGE).astype(np.float32)
              for _ in range(SERVE_REQUESTS)]
    calib = [mx.nd.array(np.stack(images[i:i + SERVE_MAX_BATCH]), ctx=gpu)
             for i in range(0, 2 * SERVE_MAX_BATCH, SERVE_MAX_BATCH)]
    net.hybridize(static_alloc=True)
    config = serving.ServerConfig(
        max_batch=SERVE_MAX_BATCH, min_batch=1, max_length=SERVE_IMAGE,
        min_length=SERVE_IMAGE, length_axis=1, batch_window_ms=5.0,
        queue_capacity=SERVE_REQUESTS, int8=True, calib_data=calib)
    replies, waves, rate, stats = _serve_waves(
        serving, net, config, images, net.cache_stats)
    done, total = _quantized_layers(mx, net)
    cache = net.cache_stats()
    net.hybridize(False)
    worst = 0.0
    for i, x in enumerate(images):
        solo = net(mx.nd.array(x[None], ctx=gpu))._data[0].float().cpu()
        for wave in replies:
            got = torch.from_numpy(np.asarray(wave[i], np.float32))
            worst = max(worst, _rel_norm(torch, got, solo))
    ceiling = len(config.policy.signatures())
    ok = done == total == 54 and worst <= INT8_SERVE_TOL and \
        not any(w["errors"] for w in waves) and stats["failed"] == 0 and \
        cache["signatures"] <= ceiling
    emit(dict(phase="int8_serve", nvidia_smi=_card(), net="resnet50_v1",
              dtype="int8 (f32 between layers)", image=SERVE_IMAGE,
              requests=SERVE_REQUESTS, clients=SERVE_CLIENTS,
              max_batch=SERVE_MAX_BATCH, waves=waves,
              images_per_s=rate["requests_per_s"], after_first_wave=rate,
              bf16_phase14=STASH.get("resnet_serve"),
              quantized_layers=done, cache_stats=cache,
              signature_ceiling=ceiling, worst_rel_norm_vs_solo=worst,
              tol=INT8_SERVE_TOL, ok=ok))
    if not ok:
        failures.append(f"int8 serving: {done}/{total} layers quantized, "
                        f"worst reply {worst}, errors "
                        f"{[w['errors'] for w in waves]}")
    del net, replies
    free_card(torch)


def _leaves_of(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves_of(v)
    elif hasattr(tree, "dtype"):
        yield tree


def int8_generative_phase(torch, mx, llama, serving, fa, failures):
    """Phase 21d: ``GenerativeServer`` with ``ServerConfig(int8=True)`` on
    phase 8's net (``llama3_8b``, 32 layers, bf16, the same seed):
    weight-only per-channel int8, each matrix dequantized to f32 per
    product as the reference does; 8b's traffic (8 prompts, two waves).
    Tick ms, decode tokens/s and peak memory beside 8b's bf16 server, and
    how many tokens equal 8b's (not required to be equal)."""
    free_card(torch)
    mx.random.seed(SEED)
    net = llama.llama3_8b()
    net.cast("bfloat16")
    net.initialize(ctx=mx.gpu(0))
    plain, _ = _serve_prompts(net.config.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fa)
    replies, srv, stats, wall_s = _serve(serving, net, plain, first_wave=2,
                                         int8=True)
    peak = torch.cuda.max_memory_allocated()
    launches = sum(c.launches for c in _counters(fa))
    rep = srv.replicas[0]
    ticks = list(rep.tick_ms)
    bf16 = STASH.get("serve", {})
    same = sum(int((r[len(p):] == b[len(p):]).sum()) for p, r, b in
               zip(plain, replies, bf16.get("replies", replies)))
    leaves = list(_leaves_of(srv.engine._w))
    int8_leaves = sum(1 for v in leaves if v.dtype == torch.int8)
    ok = stats["completed"] == len(plain) and stats["failed"] == 0 and \
        all(len(r) == len(p) + SERVE_NEW for p, r in zip(plain, replies)) \
        and int8_leaves > 0 and launches == 0
    emit(dict(phase="int8_generative", nvidia_smi=_card(),
              layers=net.config.num_layers, mode="paged", int8=True,
              waves=[2, len(plain) - 2], new_tokens=SERVE_NEW,
              decode_step_ms=ticks,
              decode_step_ms_median=float(np.median(ticks)) if ticks
              else None,
              bf16_decode_step_ms_median=bf16.get("decode_step_ms_median"),
              decode_tokens_per_s=sum(rep.tick_slots) / sum(ticks) * 1e3
              if ticks else None,
              overall_tokens_per_s=len(plain) * SERVE_NEW / wall_s,
              ttft_ms=[r["ttft_ms"] for r in srv.request_records()],
              bf16_ttft_ms=bf16.get("ttft_ms"),
              prefill_ms=list(rep.prefill_ms), max_memory_allocated=peak,
              weight_leaves=len(leaves), int8_leaves=int8_leaves,
              weight_bytes=sum(v.numel() * v.element_size()
                               for v in leaves),
              path_launches=launches, tokens_same_as_bf16=same,
              positions=len(plain) * SERVE_NEW, ok=ok))
    if not ok:
        failures.append(f"int8 generative serving: {stats}, int8 leaves "
                        f"{int8_leaves}, launches {launches}")
    del srv, replies, net
    free_card(torch)


def _rnn_case(mx, mode, ctx, arrays, head):
    x, states, params = arrays
    ins = [mx.nd.array(a, ctx=ctx) for a in [x] + states + params]
    for a in ins:
        a.attach_grad()
    with mx.autograd.record():
        outs = mx.nd.RNN(ins[0], ins[1:1 + len(states)],
                         ins[1 + len(states):], mode=mode,
                         state_size=RNN_H, num_layers=2, bidirectional=True)
        total = None
        for o, h in zip(outs, head):
            term = (o * mx.nd.array(h, ctx=ctx)).sum()
            total = term if total is None else total + term
    total.backward()
    return [o._data.float().cpu() for o in outs] + \
        [a.grad._data.float().cpu() for a in ins]


def rnn_ops_phase(torch, mx, failures):
    """Phase 22a: ``nd.RNN`` in every mode, 2 layers, both directions,
    states in and out (T=24, N=8, C=64, H=128, f32): outputs, final
    states and the gradients of the data, the states and every weight on
    the card against the CPU, each within RNN_TOL of its tensor's largest
    value; then an ``LSTMCell``'s ``unroll`` against the fused ``LSTM``
    layer on the same weights, on the card."""
    gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
    rows = []
    for mode, g in gates.items():
        rs = np.random.RandomState(SEED + 30 + len(mode))
        x = rs.normal(0, 1, (RNN_T, RNN_N, RNN_C)).astype(np.float32)
        states = [rs.normal(0, 0.5, (4, RNN_N, RNN_H)).astype(np.float32)
                  for _ in range(2 if mode == "lstm" else 1)]
        params = []
        for layer in range(2):
            ni = RNN_C if layer == 0 else 2 * RNN_H
            for _ in range(2):
                params += [rs.normal(0, 0.1, s).astype(np.float32) for s in
                           ((g * RNN_H, ni), (g * RNN_H, RNN_H),
                            (g * RNN_H,), (g * RNN_H,))]
        head = [rs.normal(size=s).astype(np.float32) for s in
                [(RNN_T, RNN_N, 2 * RNN_H)] + [(4, RNN_N, RNN_H)] *
                len(states)]
        arrays = (x, states, params)
        card = _rnn_case(mx, mode, mx.gpu(0), arrays, head)
        cpu = _rnn_case(mx, mode, mx.cpu(), arrays, head)
        worst = max((a - b).abs().max().item() /
                    max(b.abs().max().item(), 1e-30)
                    for a, b in zip(card, cpu))
        rows.append(dict(mode=mode, tensors=len(card), worst_share=worst,
                         ok=worst <= RNN_TOL))
    layer = mx.gluon.rnn.LSTM(RNN_H, input_size=RNN_C)
    cell = mx.gluon.rnn.LSTMCell(RNN_H, input_size=RNN_C)
    mx.random.seed(SEED)
    layer.initialize(mx.init.Uniform(0.1), ctx=mx.gpu(0))
    cell.initialize(ctx=mx.gpu(0))
    for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        getattr(cell, name).set_data(getattr(layer, f"l0_{name}").data())
    xs = mx.nd.array(np.random.RandomState(SEED + 35).normal(
        0, 1, (RNN_T, RNN_N, RNN_C)).astype(np.float32), ctx=mx.gpu(0))
    fused = layer(xs)._data
    unrolled, _ = cell.unroll(RNN_T, xs, layout="TNC", merge_outputs=True)
    cell_share = (unrolled._data - fused).abs().max().item() / \
        fused.abs().max().item()
    ok = all(r["ok"] for r in rows) and cell_share <= RNN_TOL
    emit(dict(phase="rnn_ops", nvidia_smi=_card(), T=RNN_T, N=RNN_N,
              C=RNN_C, H=RNN_H, layers=2, bidirectional=True, modes=rows,
              cell_unroll_vs_layer=cell_share, tol=RNN_TOL, ok=ok))
    if not ok:
        failures.append(f"nd.RNN card vs CPU: {rows}; cell unroll vs layer "
                        f"{cell_share}")


def _word_lm(mx, dropout):
    """The upstream example's ``RNNModel``: embedding, dropout, a 2-layer
    LSTM, dropout, and the decoder tied to the embedding's weight."""
    nn = mx.gluon.nn

    class RNNModel(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(WLM_VOCAB, WLM_UNITS)
                self.rnn = mx.gluon.rnn.LSTM(
                    WLM_UNITS, WLM_LAYERS, dropout=dropout,
                    input_size=WLM_UNITS)
                self.decoder = nn.Dense(WLM_VOCAB, in_units=WLM_UNITS,
                                        flatten=False,
                                        params=self.encoder.params)

        def hybrid_forward(self, F, ids):
            out = self.rnn(self.drop(self.encoder(ids)))
            return self.decoder(self.drop(out))

    return RNNModel()


def _wlm_flops():
    """Forward FLOPs of one (bptt, batch) step: the LSTM layers' input
    and recurrent products and the decoder."""
    tokens = WLM_BPTT * WLM_B
    lstm = WLM_LAYERS * 2 * tokens * (2 * WLM_UNITS) * 4 * WLM_UNITS
    return lstm + 2 * tokens * WLM_UNITS * WLM_VOCAB


def _count_launches(torch, fn):
    """Device kernels of one ``fn()`` on the card, read off
    ``torch.profiler`` ((None, the reason) where it records none)."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        return (n, None) if n else (None, "no device events")
    except Exception as e:  # noqa: BLE001 - reported, not a failure
        return None, repr(e)


def word_lm_phase(torch, mx, mt, failures):
    """Phase 22b: the LSTM word language model at the upstream Gluon
    example's widths (WLM_*), random ids from the seed: eager steps with
    ``clip_global_norm`` (the example's step) and ``FusedTrainStep``
    steps (K=WLM_K; like the reference's it has no hook between backward
    and update, so its steps clip each gradient element at WLM_CLIP
    through the optimizer's ``clip_gradient``, inside the update kernel);
    step ms, tokens/s, launches a step and the step's bound (3x the
    forward FLOPs at the f32 rate); ``torch.nn.LSTM`` (cuDNN) at the same
    shape as a yardstick, forward and backward."""
    free_card(torch)
    gpu = mx.gpu(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 40)

    def ids():
        return mx.nd.array(torch.randint(0, WLM_VOCAB, (WLM_BPTT, WLM_B),
                                         generator=gen, device="cuda",
                                         dtype=torch.int32))

    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def lm_loss(net, x, y):
        return loss_fn(net(x).reshape((-1, WLM_VOCAB)), y.reshape((-1,)))

    tokens = WLM_BPTT * WLM_B
    res = {}
    for route in ("eager", "fused"):
        mx.random.seed(SEED)
        net = _word_lm(mx, WLM_DROPOUT)
        net.initialize(mx.init.Uniform(0.1), ctx=gpu)
        net.hybridize(static_alloc=True)
        params = [p for p in net.collect_params().values()
                  if p.grad_req != "null"]
        opt = {"learning_rate": WLM_LR}
        if route == "fused":
            opt["clip_gradient"] = WLM_CLIP
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd", opt)
        batches = [(ids(), ids()) for _ in range(WLM_STEPS + 2)]
        torch.cuda.reset_peak_memory_stats()
        mt.multi_tensor_update.launches = 0
        if route == "eager":
            def step(x, y):
                with mx.autograd.record():
                    loss = lm_loss(net, x, y)
                loss.backward()
                mx.gluon.utils.clip_global_norm(
                    [p.grad() for p in params], WLM_CLIP * tokens)
                trainer.step(tokens)
                return float(loss.mean().asscalar())

            losses, ms = [], []
            for x, y in batches:
                torch.cuda.synchronize()
                t = time.perf_counter()
                losses.append(step(x, y))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            warm = sum(ms[2:]) / len(ms[2:])
            updates = mt.multi_tensor_update.launches
            launches, why = _count_launches(torch, lambda: step(*batches[0]))
        else:
            fstep = mx.gluon.FusedTrainStep(
                net, trainer, lm_loss, steps_per_execution=WLM_K,
                batch_size=tokens)
            losses, ms = [], []
            for x, y in batches[:3]:  # step 0 eager (the warm-up), replays
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fstep(x, y).asnumpy()
                ms.append((time.perf_counter() - t) * 1e3)
                losses += [float(v) / tokens for v in out]
            warm = sum(ms[1:]) / len(ms[1:]) / WLM_K
            updates = mt.multi_tensor_update.launches
            launches, why = _count_launches(torch, lambda: fstep(x, y))
            launches = launches / WLM_K if launches else launches
        res[route] = dict(
            losses=losses, ms=ms, step_ms=warm,
            tokens_per_s=tokens / warm * 1e3, launches_per_step=launches,
            profiler_error=why, update_launches=updates,
            max_memory_allocated=torch.cuda.max_memory_allocated())
        del net, trainer, params
        free_card(torch)
    # cuDNN's LSTM at the same shape, forward and backward: a yardstick
    lstm = torch.nn.LSTM(WLM_UNITS, WLM_UNITS, WLM_LAYERS,
                         dropout=WLM_DROPOUT).cuda()
    xin = torch.randn(WLM_BPTT, WLM_B, WLM_UNITS, device="cuda",
                      requires_grad=True)

    def cudnn_step():
        out, _ = lstm(xin)
        out.sum().backward()

    cudnn_ms = time_ms(torch, cudnn_step, 10)
    flops = 3 * _wlm_flops()
    bound = flops / PEAK_FLOPS["float32"] * 1e3
    first = res["eager"]["losses"][0]
    ok = all(math.isfinite(v) for r in res.values() for v in r["losses"]) \
        and abs(first - math.log(WLM_VOCAB)) < 1.0 and \
        res["eager"]["update_launches"] > 0 and \
        res["fused"]["update_launches"] > 0
    emit(dict(phase="word_lm", nvidia_smi=_card(), vocab=WLM_VOCAB,
              units=WLM_UNITS, layers=WLM_LAYERS, bptt=WLM_BPTT, B=WLM_B,
              dropout=WLM_DROPOUT, lr=WLM_LR, clip=WLM_CLIP,
              eager=res["eager"], fused=res["fused"],
              cudnn_lstm_fwd_bwd_ms=cudnn_ms, step_gflop=flops / 1e9,
              bound_ms=bound, bound_by="operations",
              ln_vocab=math.log(WLM_VOCAB), ok=ok))
    if not ok:
        failures.append(f"word LM: losses {res['eager']['losses']} / "
                        f"{res['fused']['losses']}")
    del lstm, xin
    free_card(torch)
    return res["eager"]["update_launches"] + res["fused"]["update_launches"]


def _ctc_net(mx):
    """``examples/train_ctc_ocr.py``'s ``CTCNet``."""
    class CTCNet(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.encoder = mx.gluon.rnn.LSTM(
                    CTC_HID, num_layers=1, layout="NTC", bidirectional=True,
                    input_size=CTC_FEAT)
                self.head = mx.gluon.nn.Dense(CTC_CLASSES + 1, flatten=False,
                                              in_units=2 * CTC_HID)

        def hybrid_forward(self, F, x):
            return self.head(self.encoder(x))

    return CTCNet()


def ctc_phase(torch, mx, mt, failures):
    """Phase 22c: the BiLSTM + ``CTCLoss`` net of
    ``examples/train_ctc_ocr.py`` at its shapes (B=32, T=32, 8 features,
    hidden 32 each way, 10 classes and the blank last, labels of 2-6
    digits padded with -1), Adam: eager steps and ``FusedTrainStep``
    steps (the host label checks skipped while the graph captures);
    ``ctc_loss`` on the card against the CPU route and ``F.ctc_loss`` on
    the same activations, within CTC_TOL; an infeasible label gives the
    reference's finite ~1e30."""
    gpu = mx.gpu(0)
    rs = np.random.RandomState(SEED + 50)
    xs = rs.normal(0, 1, (CTC_B, CTC_T, CTC_FEAT)).astype(np.float32)
    lab = np.full((CTC_B, CTC_LABEL), -1, np.float32)
    lens = rs.randint(2, CTC_LABEL + 1, CTC_B)
    for i, n in enumerate(lens):
        lab[i, :n] = rs.randint(0, CTC_CLASSES, n)
    x, y = mx.nd.array(xs, ctx=gpu), mx.nd.array(lab, ctx=gpu)
    loss_fn = mx.gluon.loss.CTCLoss(layout="NTC")
    res = {}
    mt.multi_tensor_update.launches = 0  # the training path starts here
    for route in ("eager", "fused"):
        mx.random.seed(SEED)
        net = _ctc_net(mx)
        net.initialize(mx.init.Xavier(), ctx=gpu)
        net.hybridize(static_alloc=True)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 1e-2})
        ms, losses = [], []
        if route == "eager":
            for _ in range(CTC_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                with mx.autograd.record():
                    loss = loss_fn(net(x), y).mean()
                loss.backward()
                trainer.step(1)
                losses.append(float(loss.asscalar()))
                ms.append((time.perf_counter() - t) * 1e3)
            del loss
            logits = net(x)._data.detach()
        else:
            fstep = mx.gluon.FusedTrainStep(
                net, trainer, lambda n, a, b: loss_fn(n(a), b).mean(),
                steps_per_execution=CTC_STEPS, batch_size=1)
            for _ in range(2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                losses += [float(v) for v in fstep(x, y).asnumpy()]
                ms.append((time.perf_counter() - t) * 1e3 / CTC_STEPS)
        res[route] = dict(losses=losses, step_ms=ms)
        del net, trainer
    updates = mt.multi_tensor_update.launches  # ... and ends here
    tnc = mx.nd.array(logits.transpose(0, 1).contiguous())
    card = mx.nd.ctc_loss(tnc, y, blank_label="last")._data.cpu()
    cpu = mx.nd.ctc_loss(mx.nd.array(tnc._data.cpu(), ctx=mx.cpu()),
                         mx.nd.array(lab, ctx=mx.cpu()),
                         blank_label="last")._data
    oracle = torch.nn.functional.ctc_loss(
        torch.log_softmax(tnc._data.cpu(), -1),
        torch.from_numpy(np.where(lab < 0, 0, lab)).long(),
        torch.full((CTC_B,), CTC_T, dtype=torch.long),
        torch.from_numpy(lens).long(), blank=CTC_CLASSES, reduction="none")
    vs_cpu = (card - cpu).abs().max().item() / cpu.abs().max().item()
    vs_torch = (card - oracle).abs().max().item() / oracle.abs().max().item()
    bad = np.zeros((1, CTC_LABEL), np.float32)  # 6 equal labels need 11
    infeasible = mx.nd.ctc_loss(tnc[:5, :1], mx.nd.array(bad, ctx=gpu),
                                blank_label="last")._data.item()
    ok = vs_cpu <= CTC_TOL and vs_torch <= CTC_TOL and \
        1e29 < infeasible < 1e31 and all(
            math.isfinite(v) for r in res.values() for v in r["losses"])
    emit(dict(phase="ctc", nvidia_smi=_card(), B=CTC_B, T=CTC_T,
              hidden=CTC_HID, classes=CTC_CLASSES + 1, eager=res["eager"],
              fused=res["fused"], update_launches=updates, ctc_vs_cpu=vs_cpu,
              ctc_vs_torch_ctc=vs_torch, tol=CTC_TOL,
              infeasible_loss=infeasible, ok=ok))
    if not ok:
        failures.append(f"ctc: card vs CPU {vs_cpu}, vs torch {vs_torch}, "
                        f"infeasible {infeasible}")
    return updates


# -- slice 15: detection -----------------------------------------------------
DET_CLASSES = 20               # VOC
SSD_IMAGE = 512
SSD_BATCHES = (32, 1)          # 23b: bf16 inference batches
SSD_CHECK_B = 2                # 23b: f32 card-vs-CPU batch
SSD_POST = 100                 # the detectors' post-NMS rows
FRCNN_IMAGE = (600, 1000)      # GluonCV's VOC test scale
FRCNN_CHECK_IMAGE = (320, 480)
YOLO_IMAGE = 416
YOLO_B = 16
YOLO_CHECK_B = 2
DET_REPS = 3                   # timed forwards of each mode, after a warm-up
DET_PROB_TOL = 1e-4            # f32 card vs CPU: pre-NMS scores, absolute
DET_BOX_TOL = 1e-4             # ... boxes, of the largest coordinate
DET_AGREE_MIN = 0.999          # ... class ids and valid flags: equal share
DET_ROI_AGREE_MIN = 0.9        # ... Faster R-CNN's proposals: equal share
OPS_TOL = 1e-5                 # 23a: f32 ops card vs CPU, relative norm
# 23a: (images, boxes, class ids) of the NMS scan: SSD-512's 400 kept by
# topk and its 1,364 anchors, the RPN's 2,000, YOLOv3-416's 10,647, and
# 11,200 boxes with ids, more than a block's 227 KB of shared memory holds
# (21 bytes a box), which the bitmask scan does not need
NMS_SIZES = [(32, 128, True), (32, 400, True), (16, 1364, True),
             (1, 2000, False), (1, 10647, True), (1, 11200, True)]
NMS_MAIN = (32, 400, True)     # SSD-512 at B=32: the kernels line's shape
# f32 operations of one pair in the scan's suppresses() (IoU: 4 for each
# side of the intersection, 1 product, 5 for each area, 2 for the union,
# the guard, the clamp, the division and the test), plus 1 class test
NMS_PAIR_OPS = 25
SSD_TRAIN_B = 16
SSD_TRAIN_IMAGES = 96          # 23e: synthetic JPEGs in the .rec
SSD_TRAIN_STEPS = 6            # 23e: fed eager steps timed, after a warm-up
SSD_TRAIN_K = 4                # 23e: FusedTrainStep steps a call
SSD_TRAIN_LR = 1e-3            # with f32 master weights (multi_precision)


def _det_nms_rows(run):
    """``run()`` with the port's ``box_nms`` recording each input (SSD
    reaches it inside ``MultiBoxDetection``, YOLOv3 and Faster R-CNN
    through ``F.contrib``) and ``Proposal`` each output: → (run's
    outputs, [(rows, kwargs)], [proposals])."""
    from mxnet_tpu_torch.ndarray import contrib as ndc
    from mxnet_tpu_torch.ops import contrib as oc

    seen, rois = [], []
    nms, prop = oc.box_nms, ndc.Proposal

    def record(data, **kw):
        seen.append((data._data.detach().float().cpu(), kw))
        return nms(data, **kw)

    def record_rois(*args, **kw):
        out = prop(*args, **kw)
        rois.append(out._data.detach().float().cpu())
        return out

    oc.box_nms = ndc.box_nms = record
    ndc.Proposal = record_rois
    try:
        out = run()
    finally:
        oc.box_nms = ndc.box_nms = nms
        ndc.Proposal = prop
    return out, seen, rois


def _det_f32_check(torch, mx, make, arrays, x):
    """The same f32 weights on the card and on the CPU, one forward of
    the CPU tensor ``x`` each: the pre-NMS rows (class ids and valid
    flags equal on DET_AGREE_MIN of the rows, scores within DET_PROB_TOL,
    boxes within DET_BOX_TOL of the largest coordinate), and the CPU's
    plain NMS on the card's own pre-NMS rows equal to the card's output
    bit for bit.  Faster R-CNN's rows each belong to a proposal, a
    discrete pick (the top 2,000 of its RPN scores, then NMS) that a
    score rounded otherwise can swap: its rows are compared where the
    two proposals agree (within 1e-3 px), and DET_ROI_AGREE_MIN of them
    must."""
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.ops import contrib as oc

    runs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        net = make()
        load_numpy_params(net, arrays, ctx=ctx)
        xa = mx.nd.array(x, ctx=ctx)
        out, seen, rois = _det_nms_rows(lambda: net(xa))
        runs.append((torch.cat([o._data.float().cpu() for o in out], -1),
                     seen[0][0], seen[0][1], rois))
        del net, out
    (g_out, g_rows, kw, g_rois), (_, c_rows, _, c_rois) = runs
    vt = kw.get("valid_thresh", 0)
    gv, cv = g_rows[..., 1] > vt, c_rows[..., 1] > vt
    both = gv & cv
    roi_agreement = None
    if g_rois:
        same = ((g_rois[0] - c_rois[0]).abs().amax(-1) <= 1e-3) \
            .reshape(both.shape)
        roi_agreement = float(same.float().mean())
        both &= same
    ids_equal = (g_rows[..., 0] == c_rows[..., 0])[both].float().mean()
    prob_err = (g_rows[..., 1] - c_rows[..., 1])[both].abs().max()
    boxes = c_rows[..., 2:6][both]
    box_err = (g_rows[..., 2:6][both] - boxes).abs().max() / \
        boxes.abs().max().clamp_min(1.0)
    plain = oc.box_nms(mx.nd.array(g_rows, ctx=mx.cpu()), **kw)._data
    plain = plain[:, :g_out.shape[1]]
    res = dict(B=x.shape[0], image=list(x.shape[2:]),
               valid_rows=int(both.sum()),
               valid_agreement=float((gv == cv).float().mean()),
               id_agreement=float(ids_equal), max_score_err=float(prob_err),
               max_box_err=float(box_err), roi_agreement=roi_agreement,
               kept_rows=int((g_out[..., 0] >= 0).sum()),
               cpu_nms_of_card_rows_equal=bool(torch.equal(plain, g_out)),
               finite=bool(torch.isfinite(g_rows).all()))
    res["ok"] = res["finite"] and res["cpu_nms_of_card_rows_equal"] and \
        res["valid_agreement"] >= DET_AGREE_MIN and \
        res["id_agreement"] >= DET_AGREE_MIN and \
        res["max_score_err"] <= DET_PROB_TOL and \
        res["max_box_err"] <= DET_BOX_TOL and res["kept_rows"] > 0 and \
        (roi_agreement is None or roi_agreement >= DET_ROI_AGREE_MIN)
    return res


def _det_infer(torch, mx, cbr, tc, net, x):
    """Eager then hybridized forwards of ``net`` on ``x`` (card tensors),
    DET_REPS timed of each after a warm-up (the graph's warm-up is its
    capture): ms, images/s, peak memory, the replay equal to the eager
    forward bit for bit; the launches of #4 and ``nms_keep`` of one
    eager forward, and of the whole run (all counts set to 0 at its
    start)."""
    fused = cbr.fused_matmul_affine_relu
    fused.launches = fused.launches_mma = tc.nms_keep.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = dict(B=x.shape[0], dtype=str(x.dtype))
    eager = [o._data.clone() for o in net(x)]
    torch.cuda.synchronize()
    res["fused_launches_a_forward"] = fused.launches
    res["nms_launches_a_forward"] = tc.nms_keep.launches
    for mode in ("eager", "graph"):
        if mode == "graph":
            net.hybridize(static_alloc=True, static_shape=True)
        ms = []
        for _ in range(DET_REPS + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = net(x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        warm = sum(ms[1:]) / DET_REPS
        res[mode] = dict(ms=ms, warm_ms=warm,
                         images_per_s=x.shape[0] / warm * 1e3)
    res["replay_equals_eager"] = all(
        torch.equal(o._data, e) for o, e in zip(out, eager))
    res["kept_rows"] = int((eager[0] >= 0).sum())
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    res["fused_launches"] = fused.launches
    res["fused_launches_mma"] = fused.launches_mma
    res["nms_launches"] = tc.nms_keep.launches
    net.hybridize(False)
    del out, eager
    return res


def _det_bound(mx, net, x, dtype):
    """(GFLOP, bound ms, bound_by) of one forward: 2·MACs of its convs and
    dense layers (``_conv_macs``) at the dtype's peak, against the input,
    the weights and the pre-NMS rows read or written once."""
    macs = _conv_macs(mx, net, x)
    item = 2 if dtype == "bfloat16" else 4
    nbytes = x._data.numel() * item + item * sum(
        p.data()._data.numel() for p in net.collect_params().values())
    ms, by = roofline_ms(2.0 * macs, nbytes, dtype)
    return 2.0 * macs / 1e9, ms, by


def detection_ops_phase(torch, mx, tc, failures):
    """Phase 23a: the contrib ops on the card against the port's CPU route
    at the detectors' shapes (f32, TF32 off): ``box_nms`` at SSD-512's
    (32, 1364, 6) class-aware with topk 400 (exact), ``Proposal`` at
    Faster R-CNN's (1, 18, 38, 63) with pre 2000 and post 128,
    ``ROIAlign`` of its 128 proposals on (1, 1024, 38, 63) pooled 14,
    forward and backward, ``MultiBoxTarget`` at 1,364 anchors and 8
    objects with negative mining 3, ``bipartite_matching``,
    ``BilinearResize2D``, deformable convolution at (8, 64, 32, 32) 3x3,
    and the control-flow ops eager and captured; then the ``nms_keep``
    bitmask scan against ``_nms_keep_plain`` on the card at every size of
    NMS_SIZES, bit for bit, with its device time (the host's enqueue
    hidden; the call's time beside it), the plain version's, its CUDA
    launches a call and the bound (``_nms_pairs``: the larger of its
    bytes and its pairs' operations).  Returns the kernels line's row at
    NMS_MAIN."""
    free_card(torch)
    gpu, cpu = mx.gpu(0), mx.cpu()
    gen = torch.Generator().manual_seed(SEED + 41)
    nd = mx.nd
    res, bad = {}, []

    def both(fn, *arrays, **kw):
        outs = []
        for ctx in (gpu, cpu):
            r = fn(*[nd.array(a, ctx=ctx) for a in arrays], **kw)
            r = r if isinstance(r, (tuple, list)) else [r]
            outs.append([o._data.detach().float().cpu() for o in r])
        return outs

    def rel(name, g, c, tol=OPS_TOL):
        err = max(_rel_norm(torch, a, b) for a, b in zip(g, c))
        res[name] = dict(rel_norm=err, tol=tol)
        if not err <= tol:
            bad.append(f"{name} {err}")

    def exact(name, g, c):
        eq = all(torch.equal(a, b) for a, b in zip(g, c))
        res[name] = dict(equal=eq)
        if not eq:
            bad.append(f"{name} not equal")

    # box_nms at SSD-512's rows, bf16-rounded scores (ties)
    n = 1364
    dets = torch.cat([
        torch.randint(0, DET_CLASSES, (32, n, 1), generator=gen).float(),
        torch.rand((32, n, 1), generator=gen).bfloat16().float(),
        _det_boxes(torch, gen, (32, n), 1.0)], -1)
    kw = dict(overlap_thresh=0.45, valid_thresh=0.01, topk=400,
              coord_start=2, score_index=1, id_index=0)
    exact("box_nms", *both(nd.contrib.box_nms, dets, **kw))
    g_dets = nd.array(dets, ctx=gpu)
    res["box_nms"]["op_ms"] = time_ms(
        torch, lambda: nd.contrib.box_nms(g_dets, **kw), 10)
    # Proposal at Faster R-CNN's 600x1000 RPN map
    fg = torch.rand((1, 9, 38, 63), generator=gen)
    cls_prob = torch.cat([1 - fg, fg], 1)
    bbox = torch.randn((1, 36, 38, 63), generator=gen) * 0.2
    info = torch.tensor([[600.0, 1000.0, 1.0]])
    pkw = dict(rpn_pre_nms_top_n=2000, rpn_post_nms_top_n=128,
               threshold=0.7, rpn_min_size=1, scales=(8, 16, 32),
               ratios=(0.5, 1, 2), feature_stride=16)
    g, c = both(nd.contrib.Proposal, cls_prob, bbox, info, **pkw)
    err = float((g[0] - c[0]).abs().max())
    res["proposal"] = dict(max_abs_err_px=err, tol_px=1e-3,
                           rois=list(g[0].shape))
    if not err <= 1e-3:
        bad.append(f"proposal {err}")
    rois = c[0]
    # ROIAlign of those proposals, forward and backward
    feat = torch.randn((1, 1024, 38, 63), generator=gen)
    cot = torch.randn((128, 1024, 14, 14), generator=gen)
    outs = []
    for ctx in (gpu, cpu):
        d = nd.array(feat, ctx=ctx)
        d.attach_grad()
        with mx.autograd.record():
            y = nd.contrib.ROIAlign(d, nd.array(rois, ctx=ctx),
                                    pooled_size=14, spatial_scale=1 / 16,
                                    sample_ratio=2)
            loss = (y * nd.array(cot, ctx=ctx)).sum()
        loss.backward()
        outs.append([y._data.float().cpu(), d.grad._data.float().cpu()])
        del d, y, loss
    rel("roi_align", *outs)
    # MultiBoxTarget at SSD-512's anchors
    anchors = nd.concat(*[nd.contrib.MultiBoxPrior(
        nd.zeros((1, 1, s, s), ctx=cpu), sizes=sz, ratios=(1, 2, 0.5))
        for s, sz in zip((16, 8, 4, 2, 1), _ssd512_sizes())], dim=1)._data
    lab = -torch.ones((SSD_TRAIN_B, 8, 5))
    for i in range(SSD_TRAIN_B):
        k = 1 + i % 8
        lab[i, :k, 0] = torch.randint(0, DET_CLASSES, (k,), generator=gen)
        lab[i, :k, 1:] = _det_boxes(torch, gen, (k,), 1.0)
    cp = torch.randn((SSD_TRAIN_B, DET_CLASSES + 1, anchors.shape[1]),
                     generator=gen)
    g, c = both(nd.contrib.MultiBoxTarget, anchors, lab, cp,
                negative_mining_ratio=3)
    rel("multibox_target_loc", g[:2], c[:2])
    agree = float((g[2] == c[2]).float().mean())
    res["multibox_target_cls"] = dict(agreement=agree, min=DET_AGREE_MIN)
    if not agree >= DET_AGREE_MIN:
        bad.append(f"multibox_target cls {agree}")
    # bipartite matching of those labels' IoUs against the anchors
    iou = nd.contrib.box_iou(nd.array(lab[:, :, 1:], ctx=cpu),
                             nd.array(anchors[0], ctx=cpu))._data
    exact("bipartite_matching", *both(nd.contrib.bipartite_matching, iou,
                                      threshold=0.1))
    fmap = torch.randn((8, 64, 32, 32), generator=gen)
    rel("bilinear_resize_2d", *both(nd.contrib.BilinearResize2D, fmap,
                                    height=64, width=64))
    off = torch.randn((8, 18, 32, 32), generator=gen) * 2
    wt = torch.randn((64, 64, 3, 3), generator=gen) * 0.05
    rel("deformable_convolution", *both(
        nd.contrib.DeformableConvolution, fmap, off, wt, kernel=(3, 3),
        pad=(1, 1), num_filter=64, no_bias=True))
    # control flow, eager on both, and captured inside a graph on the card
    xs = torch.randn((6, 4), generator=gen)

    def flow(x):
        outs, last = nd.contrib.foreach(lambda a, s: (a * s, a + s), x,
                                        nd.ones_like(x[0]))
        steps, v = nd.contrib.while_loop(
            lambda v: v.sum() < 40, lambda v: ([v * 2], [v + 3]), [last],
            max_iterations=8)
        pick = nd.contrib.cond(v[0].sum() > 0, lambda: v[0] * 2,
                               lambda: v[0] - 1)
        return outs, steps, pick

    rel("control_flow", *both(flow, xs), tol=1e-6)

    class Flow(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return flow(x)

    blk = Flow()
    xg = nd.array(xs, ctx=gpu)
    eager = [o._data.clone() for o in blk(xg)]
    blk.hybridize()
    blk(xg)  # the capture
    replay = blk(xg)
    exact("control_flow_graph", [o._data.cpu() for o in replay],
          [e.cpu() for e in eager])
    # the nms_keep kernel against its plain version on the card
    scans, main = [], None
    for g_, n_, with_cls in NMS_SIZES:
        boxes = _det_boxes(torch, gen, (g_, n_), math.sqrt(n_) * 4,
                           (2.0, 12.0)).cuda()
        valid = (torch.rand((g_, n_), generator=gen) > 0.1).cuda()
        ids = torch.randint(0, 3, (g_, n_), generator=gen).float().cuda() \
            if with_cls else None
        before = tc.nms_keep.cuda_launches
        got = tc.nms_keep(boxes, valid, ids, 0.45)
        cuda_launches = tc.nms_keep.cuda_launches - before
        ref = tc._nms_keep_plain(boxes, valid, ids, 0.45)
        equal = bool(torch.equal(got, ref))
        device_ms = time_ms(torch, lambda: tc.nms_keep(boxes, valid, ids,
                                                       0.45),
                            20, hide_host=True)
        k_ms = time_ms(torch, lambda: tc.nms_keep(boxes, valid, ids, 0.45),
                       20)
        p_ms = time_ms(torch, lambda: tc._nms_keep_plain(boxes, valid, ids,
                                                          0.45),
                       1 if n_ > 2000 else 3)
        nbytes = g_ * n_ * (16 + 1 + 1 + (4 if with_cls else 0))
        pairs = _nms_pairs(torch, tc, boxes, valid, ids, ref, 0.45)
        ops = pairs * (NMS_PAIR_OPS + (1 if with_cls else 0))
        bound, by = roofline_ms(ops, nbytes, "float32")
        row = dict(G=g_, n=n_, class_ids=with_cls, equal=equal,
                   kept=int(got.sum()), valid=int(valid.sum()), ms=k_ms,
                   device_ms=device_ms,
                   us_per_scanned_box=device_ms * 1e3 / n_,
                   cuda_launches_a_call=cuda_launches,
                   plain_ms=p_ms, pairs=pairs, operations=ops,
                   bytes=nbytes, bound_ms=bound, bound_by=by,
                   max_abs_err=float((got.float() - ref.float()).abs()
                                     .max()))
        scans.append(row)
        if (g_, n_, with_cls) == NMS_MAIN:
            main = row
        if not equal:
            bad.append(f"nms_keep at {g_}x{n_} differs from the plain "
                       "version")
        del boxes, valid, ids, got, ref
    emit(dict(phase="detection_ops", nvidia_smi=_card(), ops=res,
              nms_keep=scans, ok=not bad))
    if bad:
        failures.append("detection ops: " + "; ".join(bad))
    free_card(torch)
    return main


def _nms_pairs(torch, tc, boxes, valid, ids, keep, thresh):
    """The pairs a greedy scan of these boxes must test: each kept box i
    against every later valid box j (of i's class, when ``ids`` are given)
    that no kept box before i has removed, i.e. every kept i up to j's
    first kept suppressor.  ``keep`` is the scan's result; counted on the
    card a block of rows at a time."""
    g, n = valid.shape
    idx = torch.arange(n, device=boxes.device)
    rows = max(1, (1 << 24) // max(1, g * n))

    def met(i0, i1):  # kept i in [i0, i1) against later valid j
        m = keep[:, i0:i1, None] & valid[:, None, :] & \
            (idx[None, i0:i1, None] < idx[None, None, :])
        if ids is not None:
            m &= ids[:, i0:i1, None] == ids[:, None, :]
        return m

    first = torch.full((g, n), n, dtype=torch.long, device=boxes.device)
    for i0 in range(0, n, rows):
        i1 = min(n, i0 + rows)
        sup = met(i0, i1) & (tc._pair_iou(boxes[:, i0:i1], boxes) > thresh)
        at = torch.where(sup, idx[None, i0:i1, None], n)
        first = torch.minimum(first, at.min(1).values)
    total = 0
    for i0 in range(0, n, rows):
        i1 = min(n, i0 + rows)
        total += int((met(i0, i1) & (idx[None, i0:i1, None] <=
                                     first[:, None, :])).sum())
    return total


def _det_boxes(torch, gen, shape, size, wh=(0.02, 0.3)):
    """Random corner boxes (*shape, 4) in [0, size] (CPU, from ``gen``):
    centers uniform, sides uniform in ``wh`` (fractions of size when
    size is 1)."""
    c = torch.rand(shape + (2,), generator=gen) * size
    s = wh[0] + torch.rand(shape + (2,), generator=gen) * (wh[1] - wh[0])
    return torch.cat([c - s / 2, c + s / 2], -1)


def _ssd512_sizes():
    """``get_ssd``'s anchor sizes at 512 (5 levels)."""
    s = np.linspace(0.1, 0.9, 6)
    return [(float(s[i]), float(np.sqrt(s[i] * s[i + 1]))) for i in range(5)]


def _det_phase(torch, mx, cbr, tc, name, make, arrays, x, check_x,
               dtype, expect_fused, expect_nms, failures, phase):
    """A detector's inference phase: the f32 card-vs-CPU check on
    ``check_x``, then ``_det_infer`` on ``x`` (each a card tensor) in
    ``dtype``; returns (#4's launches, its tensor-core launches, the
    NMS launches) of the timed runs."""
    from mxnet_tpu_torch.convert import load_numpy_params

    free_card(torch)
    check = _det_f32_check(torch, mx, make, arrays, check_x)
    net = make()
    load_numpy_params(net, arrays, ctx=mx.gpu(0))
    if dtype != "float32":
        net.cast(dtype)
    STASH.setdefault("det", {})[name] = (make, arrays, x, dtype)
    runs, totals = [], [0, 0, 0]
    for xb in x:
        gflop, bound, by = _det_bound(mx, net, xb, dtype)
        r = _det_infer(torch, mx, cbr, tc, net, xb)
        r.update(gflop=gflop, bound_ms=bound, bound_by=by)
        runs.append(r)
        totals = [totals[0] + r["fused_launches"],
                  totals[1] + r["fused_launches_mma"],
                  totals[2] + r["nms_launches"]]
    ok = check["ok"] and all(
        r["replay_equals_eager"] and r["kept_rows"] > 0 and
        r["fused_launches_a_forward"] == expect_fused and
        r["nms_launches_a_forward"] == expect_nms for r in runs)
    emit(dict(phase=phase, nvidia_smi=_card(), net=name, dtype=dtype,
              f32_check=check, runs=runs, expect_fused=expect_fused,
              expect_nms=expect_nms, ok=ok))
    if not ok:
        failures.append(f"{name}: check {check}, runs " + "; ".join(
            f"B={r['B']} replay equal {r['replay_equals_eager']}, #4 "
            f"{r['fused_launches_a_forward']}, nms "
            f"{r['nms_launches_a_forward']}" for r in runs))
    del net
    free_card(torch)
    return totals


def ssd_infer_phase(torch, mx, detection, cbr, tc, failures):
    """Phase 23b: ``ssd_512_resnet50_v1`` (20 classes) at 512x512: the f32
    check at B=SSD_CHECK_B, then bf16 (``net.cast``) at B=32 and B=1,
    eager and hybridized: 20 launches of #4 (16 bottlenecks, 4 extras)
    and one of ``nms_keep`` a forward."""
    def make():
        return detection.ssd_512_resnet50_v1(classes=DET_CLASSES)

    arrays = _resnet_arrays(torch, mx, make, (1, 3, 128, 128))
    STASH["ssd512_arrays"] = arrays
    gen = torch.Generator().manual_seed(SEED + 42)
    check_x = torch.rand((SSD_CHECK_B, 3, SSD_IMAGE, SSD_IMAGE),
                         generator=gen)
    xs = [mx.nd.array(torch.rand((b, 3, SSD_IMAGE, SSD_IMAGE),
                                 generator=gen).bfloat16(), ctx=mx.gpu(0))
          for b in SSD_BATCHES]
    return _det_phase(torch, mx, cbr, tc, "ssd_512_resnet50_v1", make,
                      arrays, xs, check_x, "bfloat16", 20, 1, failures,
                      "ssd512_infer")


def frcnn_infer_phase(torch, mx, detection, cbr, tc, failures):
    """Phase 23c: ``faster_rcnn_resnet50_v1`` (20 classes; pre 2000,
    post 128) at 600x1000, B=1, in f32 (a bf16 cast fails in both
    packages: ROIAlign's f32 output meets stage 4's bf16 weights), eager
    and hybridized: 16 launches of #4 (13 in stages 1-3, 3 in stage 4 on
    the ROI batch) and two of ``nms_keep`` (the RPN's, the final
    ``box_nms``) a forward; the f32 check at 320x480."""
    def make():
        return detection.faster_rcnn_resnet50_v1(classes=DET_CLASSES)

    arrays = _resnet_arrays(torch, mx, make, (1, 3, 128, 128))
    gen = torch.Generator().manual_seed(SEED + 43)
    check_x = torch.rand((1, 3) + FRCNN_CHECK_IMAGE, generator=gen)
    x = mx.nd.array(torch.rand((1, 3) + FRCNN_IMAGE, generator=gen),
                    ctx=mx.gpu(0))
    return _det_phase(torch, mx, cbr, tc, "faster_rcnn_resnet50_v1", make,
                      arrays, [x], check_x, "float32", 16, 2, failures,
                      "frcnn_infer")


def yolo_infer_phase(torch, mx, detection, cbr, tc, failures):
    """Phase 23d: ``yolo3_darknet53`` (20 classes) at 416x416, bf16 at
    B=16, eager and hybridized: #4 never (Darknet's blocks end in
    LeakyReLU) and ``nms_keep`` once a forward; the f32 check at B=2."""
    def make():
        return detection.yolo3_darknet53(classes=DET_CLASSES)

    arrays = _resnet_arrays(torch, mx, make, (1, 3, 128, 128))
    gen = torch.Generator().manual_seed(SEED + 44)
    check_x = torch.rand((YOLO_CHECK_B, 3, YOLO_IMAGE, YOLO_IMAGE),
                         generator=gen)
    x = mx.nd.array(torch.rand((YOLO_B, 3, YOLO_IMAGE, YOLO_IMAGE),
                               generator=gen).bfloat16(), ctx=mx.gpu(0))
    return _det_phase(torch, mx, cbr, tc, "yolo3_darknet53", make, arrays,
                      [x], check_x, "bfloat16", 0, 1, failures,
                      "yolo_infer")


def write_det_records(mx, root, n, seed):
    """``n`` synthetic JPEGs (384-640 px a side, 1-8 filled boxes of the
    20 classes on a noise texture) in a ``.rec``/``.idx`` pair with the
    reference's detection label ``[2, 5, cls, x1, y1, x2, y2, ...]``
    (corners normalized to [0, 1]); returns the ``.rec`` path."""
    import cv2

    rng = np.random.RandomState(seed)
    rec, idx = os.path.join(root, "det.rec"), os.path.join(root, "det.idx")
    w = mx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        h, wd = rng.randint(384, 641, 2)
        img = rng.randint(0, 256, (h, wd, 3)).astype(np.uint8)
        k = 1 + i % 8
        objs = []
        for _ in range(k):
            bw, bh = rng.uniform(0.1, 0.5, 2)
            x1, y1 = rng.uniform(0, 1 - bw), rng.uniform(0, 1 - bh)
            cls = rng.randint(DET_CLASSES)
            img[int(y1 * h):int((y1 + bh) * h),
                int(x1 * wd):int((x1 + bw) * wd)] = (cls * 12, 255 - cls * 12,
                                                     128)
            objs += [cls, x1, y1, x1 + bw, y1 + bh]
        label = np.asarray([2, 5] + objs, np.float32)
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        assert ok
        w.write_idx(i, mx.recordio.pack(
            mx.recordio.IRHeader(0, label, i, 0), buf.tobytes()))
    w.close()
    return rec


def _ssd_loss(mx, net, x, label):
    """The SSD loss of ``tests/test_detection_models.py`` with negative
    mining 3: softmax cross-entropy over the anchors that
    ``MultiBoxTarget`` keeps (it marks the mined-away negatives -1) plus
    the L1 box loss on the matched anchors, per image, over the image's
    matched anchors (as GluonCV's ``SSDMultiBoxLoss`` normalizes)."""
    nd = mx.nd
    cls_p, box_p, anchors = net(x)
    loc_t, loc_m, cls_t = nd.contrib.MultiBoxTarget(
        anchors, label, nd.transpose(cls_p, axes=(0, 2, 1)),
        negative_mining_ratio=3)
    logp = nd.log_softmax(cls_p.astype("float32"), axis=-1)
    cls_loss = -nd.pick(logp, nd.maximum(cls_t, 0), axis=-1) * (cls_t >= 0)
    box = box_p.astype("float32").reshape((x.shape[0], -1))
    loc_loss = nd.abs(box - loc_t) * loc_m
    matched = nd.maximum(loc_m.sum(axis=1) / 4, 1)
    return (cls_loss.sum(axis=1) + loc_loss.sum(axis=1)) / matched


def ssd_train_phase(torch, mx, detection, mt, failures):
    """Phase 23e: ``ssd_512_resnet50_v1`` bf16 training at 512x512, B=16,
    fed by ``image.ImageDetIter`` over a ``.rec`` of SSD_TRAIN_IMAGES
    synthetic JPEGs written here (``CreateDetAugmenter``: random crop,
    mirror, mean/std), ``MultiBoxTarget`` with negative mining 3 and SGD
    (lr SSD_TRAIN_LR, momentum 0.9, f32 masters): SSD_TRAIN_K eager
    steps and one
    ``FusedTrainStep`` call over the same K batches from the same weights
    (losses within FUSED_LOSS_RTOL), a timed call of replays, then
    SSD_TRAIN_STEPS eager steps fed by the iterator: step ms and the
    iterator's wait.  Returns the update's launches."""
    import shutil
    import tempfile

    from mxnet_tpu_torch.convert import load_numpy_params

    free_card(torch)
    root = tempfile.mkdtemp(prefix="mxt_det_")
    try:
        t = time.perf_counter()
        rec = write_det_records(mx, root, SSD_TRAIN_IMAGES, SEED + 45)
        write_s = time.perf_counter() - t
        shape = (3, SSD_IMAGE, SSD_IMAGE)
        it = mx.image.ImageDetIter(
            SSD_TRAIN_B, shape, path_imgrec=rec, shuffle=True, seed=SEED,
            aug_list=mx.image.CreateDetAugmenter(
                shape, rand_crop=0.5, rand_mirror=True,
                mean=(123.68, 116.28, 103.53), std=(58.4, 57.1, 57.4)))

        def next_batch():
            try:
                b = it.next()
            except StopIteration:
                it.reset()
                b = it.next()
            return b.data[0].astype("bfloat16"), b.label[0]

        arrays = STASH.pop("ssd512_arrays")

        def make():
            net = detection.ssd_512_resnet50_v1(classes=DET_CLASSES)
            load_numpy_params(net, arrays, ctx=mx.gpu(0))
            net.cast("bfloat16")
            return net, mx.gluon.Trainer(net.collect_params(), "sgd", {
                "learning_rate": SSD_TRAIN_LR, "momentum": 0.9,
                "multi_precision": True})

        batches = [next_batch() for _ in range(SSD_TRAIN_K)]
        mt.multi_tensor_update.launches = 0  # the main path starts here
        net, tr = make()
        eager, eager_ms = [], []
        for xb, yb in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            with mx.autograd.record():
                loss = _ssd_loss(mx, net, xb, yb)
            loss.backward()
            tr.step(SSD_TRAIN_B)
            eager.append(float(loss.sum().asscalar()))
            eager_ms.append((time.perf_counter() - t) * 1e3)
        # fed by the iterator: the next batch is fetched while the step
        # runs on the card
        fed_ms, waits, fed = [], [], []
        xb, yb = next_batch()
        for _ in range(SSD_TRAIN_STEPS + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with mx.autograd.record():
                loss = _ssd_loss(mx, net, xb, yb)
            loss.backward()
            tr.step(SSD_TRAIN_B)
            tw = time.perf_counter()
            xb, yb = next_batch()
            waits.append((time.perf_counter() - tw) * 1e3)
            fed.append(float(loss.sum().asscalar()))
            fed_ms.append((time.perf_counter() - t) * 1e3)
        del net, tr, loss
        free_card(torch)
        net, tr = make()
        fstep = mx.gluon.FusedTrainStep(
            net, tr, lambda n, a, c: _ssd_loss(mx, n, a, c),
            steps_per_execution=SSD_TRAIN_K, batch_size=SSD_TRAIN_B,
            stacked_inputs=True)
        xs = mx.nd.stack(*[b[0] for b in batches], axis=0)
        ys = mx.nd.stack(*[b[1] for b in batches], axis=0)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        fused = fstep(xs, ys).asnumpy().tolist()
        first_call_s = time.perf_counter() - t
        torch.cuda.synchronize()
        t = time.perf_counter()
        more = fstep(xs, ys).asnumpy()
        call_ms = (time.perf_counter() - t) * 1e3
        updates = mt.multi_tensor_update.launches  # ... and ends here
        rel = max(abs(a - c) / abs(c) for a, c in zip(fused, eager))
        finite = all(math.isfinite(v) for v in eager + fed + fused) and \
            bool(np.isfinite(more).all())
        ok = finite and rel <= FUSED_LOSS_RTOL and len(fstep._graphs) == 1 \
            and updates == 2 * SSD_TRAIN_K + SSD_TRAIN_STEPS + 1 + \
            SSD_TRAIN_K
        step_ms = call_ms / SSD_TRAIN_K
        emit(dict(phase="ssd512_train", nvidia_smi=_card(), B=SSD_TRAIN_B,
                  image=SSD_IMAGE, dtype="bfloat16", lr=SSD_TRAIN_LR,
                  records=SSD_TRAIN_IMAGES, write_s=write_s,
                  label_shape=list(batches[0][1].shape),
                  eager_losses=eager, eager_step_ms=eager_ms,
                  fed_losses=fed, fed_step_ms=fed_ms,
                  iterator_wait_ms=waits,
                  fed_warm_step_ms=sum(fed_ms[1:]) / SSD_TRAIN_STEPS,
                  fused_losses=fused, next_losses=more.tolist(),
                  max_loss_rel_err=rel, tol=FUSED_LOSS_RTOL,
                  first_call_s=first_call_s, fused_call_ms=call_ms,
                  fused_step_ms=step_ms,
                  images_per_s=SSD_TRAIN_B / step_ms * 1e3,
                  multi_tensor_launches=updates,
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  ok=ok))
        if not ok:
            failures.append(f"ssd512 training: eager {eager} vs fused "
                            f"{fused} (worst {rel}), fed {fed}, updates "
                            f"{updates}")
        del net, tr, fstep, xs, ys, batches
        free_card(torch)
        return updates
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- slice 16: sparse storage ------------------------------------------------

FM_FEATURES = 1_000_000      # LIBSVM's criteo: 1,000,000 features
FM_INT_FIELDS = 13           # ... 13 integer fields
FM_CAT_FIELDS = 26           # ... and 26 categorical ones a row
FM_FACTOR = 16               # the MXNet FM example's factor size
FM_B = 1000                  # ... and batch
FM_ROWS = 64_000             # 64 batches
FM_STEPS = 64
FM_LR = 0.01                 # Adam
FM_CHECK_RTOL = 1e-5         # card vs CPU, f32 (the card's reductions)
FM_STORE_STEPS = 10          # 24d
SPARSE_LIN = dict(n=40000, d=4096, density=0.02, steps=40, batch=512,
                  lr=5.0)    # examples/sparse_linear_classification.py
SPARSE_OPS_REPS = 20
PROF_B, PROF_IMAGE = 128, 224  # 24e: the ResNet-50 forward profiled


def write_criteo(path, rows, seed):
    """A Criteo-shaped LibSVM file: ``rows`` lines of 39 features, one a
    field, each field's ids in its own slice of the 1,000,000 (skewed to
    the slice's start: id = start + span·u³, so some ids are hot, as
    hashed categorical values are), values in (0, 1] for the 13 integer
    fields and 1 for the 26 categorical ones, and labels 0/1 from a
    hidden linear rule (the score's median splits them)."""
    rng = np.random.RandomState(seed)
    fields = FM_INT_FIELDS + FM_CAT_FIELDS
    span = FM_FEATURES // fields
    ids = np.arange(fields) * span + \
        (span * rng.rand(rows, fields) ** 3).astype(np.int64)
    vals = np.ones((rows, fields))
    vals[:, :FM_INT_FIELDS] = 1.0 - rng.rand(rows, FM_INT_FIELDS)
    w_true = rng.randn(FM_FEATURES)
    score = (w_true[ids] * vals).sum(1)
    labels = (score > np.median(score)).astype(int)
    with open(path, "w") as f:
        for lab, i_row, v_row in zip(labels, ids, vals):
            f.write(f"{lab} " + " ".join(
                f"{i}:{v:.6g}" for i, v in zip(i_row, v_row)) + "\n")
    return labels.mean()


def _sparse_pair(mx, card, host):
    """(max error, whether the stored indices are equal) of a result on
    the card against the same call's result on the CPU."""
    sp = mx.nd.sparse
    if isinstance(card, sp.BaseSparseNDArray):
        parts = ["indices"] + (["indptr"] if card.stype == "csr" else [])
        same_idx = all(np.array_equal(getattr(card, p).asnumpy(),
                                      getattr(host, p).asnumpy())
                       for p in parts)
        on_card = all(getattr(card, p)._data.is_cuda
                      for p in ["data"] + parts)
        c, h = card.data.asnumpy(), host.data.asnumpy()
    else:
        same_idx, on_card = True, card._data.is_cuda
        c, h = card.asnumpy(), host.asnumpy()
    err = float(np.abs(c - h).max()) if c.size else 0.0
    scale = float(np.abs(h).max()) if h.size else 0.0
    return err, scale, same_idx and c.shape == h.shape, on_card


def sparse_ops_phase(torch, mx, failures):
    """Phase 24a: the sparse ops at the factorization machine's width, on
    the card against the same calls on CPU tensors: every
    ``cast_storage`` pair on a gradient-shaped row_sparse array (the
    1,000,000 x 16 table's rows of a 1,000-row batch), the union and
    intersection merges of two such arrays and of two CSR batches,
    ``retain``, and the CSR batch (1,000 x 1,000,000, 39 nonzeros a row)
    times the table and its transpose times a (1,000, 16) array.  Every
    result lies on the card; stored indices equal, values within 1e-6
    of the largest, the products bit for bit (``csrc/csr_dense_dot.cu``
    in both directions adds in the CPU's order).  Each product's ms
    beside ``torch.sparse.mm`` on the same CSR tensor (cuSPARSE; a
    yardstick only) and its bound; then ``csr_kernel_row``."""
    sp = mx.nd.sparse
    rng = np.random.RandomState(SEED + 240)
    nnz = FM_INT_FIELDS + FM_CAT_FIELDS

    def batch(seed):
        r = np.random.RandomState(seed)
        cols = np.sort(r.randint(0, FM_FEATURES - nnz, (FM_B, nnz)), 1) + \
            np.arange(nnz)  # distinct and increasing in each row
        return (r.uniform(0.01, 1.0, FM_B * nnz).astype(np.float32),
                cols.reshape(-1), np.arange(0, FM_B * nnz + 1, nnz))

    b1, b2 = batch(SEED + 241), batch(SEED + 242)
    table = rng.randn(FM_FEATURES, FM_FACTOR).astype(np.float32)
    d = rng.randn(FM_B, FM_FACTOR).astype(np.float32)

    def calls(ctx):
        c1 = sp.csr_matrix(b1, shape=(FM_B, FM_FEATURES), ctx=ctx)
        c2 = sp.csr_matrix(b2, shape=(FM_B, FM_FEATURES), ctx=ctx)
        v = mx.nd.array(table, ctx=ctx)
        g1 = sp.row_sparse_array((v._data[torch.unique(c1.indices._data)],
                                  torch.unique(c1.indices._data)),
                                 shape=table.shape, ctx=ctx)
        g2 = sp.row_sparse_array((v._data[torch.unique(c2.indices._data)]
                                  * 0.5, torch.unique(c2.indices._data)),
                                 shape=table.shape, ctx=ctx)
        out = {}
        for src in ("default", "row_sparse", "csr"):
            x = g1.todense() if src == "default" else g1.tostype(src)
            for dst in ("default", "row_sparse", "csr"):
                out[f"cast {src}->{dst}"] = mx.nd.cast_storage(x, dst)
        out.update({"rsp + rsp": g1 + g2, "rsp - rsp": g1 - g2,
                    "rsp * rsp": g1 * g2, "csr + csr": c1 + c2,
                    "csr * csr": c1 * c2,
                    "retain": sp.retain(g1, g2.indices),
                    "dot": mx.nd.dot(c1, v),
                    "dot transpose_a": mx.nd.dot(
                        c1, mx.nd.array(d, ctx=ctx), transpose_a=True)})
        return out, (c1, v, mx.nd.array(d, ctx=ctx))

    card, (c1, v, dd) = calls(mx.gpu(0))
    host, _ = calls(mx.cpu())
    rows, ok = {}, True
    for name in card:
        err, scale, same, on_card = _sparse_pair(mx, card[name], host[name])
        tol = 0.0 if name.startswith("dot") else 1e-6 * max(scale, 1.0)
        good = same and on_card and err <= tol
        rows[name] = dict(max_abs_err=err, tol=tol, indices_equal=same,
                          on_card=on_card, ok=good)
        ok = ok and good
    del host
    # the products' times: the port's route, cuSPARSE, and the bound
    crow = torch.sparse_csr_tensor(c1.indptr._data, c1.indices._data,
                                   c1.data._data, size=c1.shape)
    csc_t = crow.t()  # for the transposed product
    touched = int(torch.unique(c1.indices._data).numel())
    nnz_all = FM_B * nnz
    aux = nnz_all * (4 + 8) + (FM_B + 1) * 8
    times = {}
    for name, fn, lib, nbytes in (
            ("dot", lambda: mx.nd.dot(c1, v),
             lambda: torch.sparse.mm(crow, v._data),
             aux + touched * FM_FACTOR * 4 + FM_B * FM_FACTOR * 4),
            ("dot transpose_a",
             lambda: mx.nd.dot(c1, dd, transpose_a=True),
             lambda: torch.sparse.mm(csc_t, dd._data),
             aux + FM_B * FM_FACTOR * 4 + FM_FEATURES * FM_FACTOR * 4)):
        ms = time_ms(torch, fn, SPARSE_OPS_REPS)
        try:
            lib_ms = time_ms(torch, lib, SPARSE_OPS_REPS)
            lib_err = float((lib() - fn()._data).abs().max())
        except RuntimeError as e:  # a layout cuSPARSE does not take
            lib_ms, lib_err = None, repr(e)[:200]
        bound, by = roofline_ms(2 * nnz_all * FM_FACTOR, nbytes, "float32")
        times[name] = dict(ms=ms, library_ms=lib_ms, library_max_abs_diff=
                           lib_err, bound_ms=bound, bound_by=by,
                           bytes=nbytes)
    emit(dict(phase="sparse_ops", card=STASH["smi"], B=FM_B,
              features=FM_FEATURES, factor=FM_FACTOR, nnz_per_row=nnz,
              touched_rows=touched, checks=rows, dot=times, ok=ok))
    if not ok:
        failures.append(f"sparse ops: {rows}")
    STASH["sparse_dot"] = times
    csr_row = csr_kernel_row(torch, c1, v, dd, crow, times, failures)
    del card, c1, v, dd, crow, csc_t
    free_card(torch)
    return csr_row


def csr_kernel_row(torch, c1, v, dd, crow, times, failures):
    """The CSR product's kernel (``csrc/csr_dense_dot.cu``) at the
    factorization machine's shape, in both directions: phase 24a's batch
    times the table, and its transpose times a (1,000, 16) array (the
    same kernel on the column-ordered view, the sort included).  Each
    direction's 20 launches against its plain version on CPU copies of
    the same inputs, bit for bit (the kernel adds in the CPU's order with
    the CPU's rounding); its call's time (``ms``) and its device time
    (``device_ms``, the host's enqueue hidden) beside the same two of the
    plain version on the card (``index_add_``) and of
    ``torch.sparse.mm`` (cuSPARSE), and the bound of 24a's row.  Returns
    ``{"forward": row, "transposed": row}``."""
    from mxnet_tpu_torch.ndarray import sparse as tsp

    rows = tsp._csr_rows(c1)
    a = (c1.data._data, c1.indices._data, c1.indptr._data, rows)
    host_a = [t.cpu() for t in a]
    out, bad = {}, []
    for name, rhs, kw, n_out, lib, dot_row in (
            ("forward", v._data, {}, FM_B,
             lambda: torch.sparse.mm(crow, v._data), times["dot"]),
            ("transposed", dd._data,
             dict(transpose_a=True, n_cols=FM_FEATURES), FM_FEATURES,
             lambda: torch.sparse.mm(crow.t(), dd._data),
             times["dot transpose_a"])):
        host = tsp._csr_dense_dot(host_a[0], host_a[1], host_a[3], n_out,
                                  rhs.cpu(), bool(kw))
        runs = [tsp.csr_dense_dot(*a, rhs, **kw) for _ in range(20)]
        got = [r.cpu() for r in runs]
        same = all(torch.equal(g, host) for g in got)
        err = max(float((g - host).abs().max()) for g in got)
        del runs, got
        out[name] = dict(max_abs_err=err, bit_equal=same, runs=20)
        for key, fn in (("", lambda: tsp.csr_dense_dot(*a, rhs, **kw)),
                        ("plain_", lambda: tsp._csr_dense_dot(
                            a[0], a[1], a[3], n_out, rhs, bool(kw))),
                        ("library_", lib)):
            out[name][key + "ms"] = time_ms(torch, fn, SPARSE_OPS_REPS)
            out[name][key + "device_ms"] = time_ms(
                torch, fn, SPARSE_OPS_REPS, hide_host=True)
        out[name].update(bound_ms=dot_row["bound_ms"],
                         bound_by=dot_row["bound_by"],
                         bytes=dot_row["bytes"])
        if kw:  # the transposed call's parts: the view, then the kernel
            view = tsp._csr_column_view(a[0], a[1], a[3], FM_FEATURES)
            out[name]["view_device_ms"] = time_ms(
                torch, lambda: tsp._csr_column_view(a[0], a[1], a[3],
                                                    FM_FEATURES),
                SPARSE_OPS_REPS, hide_host=True)
            out[name]["kernel_device_ms"] = time_ms(
                torch, lambda: tsp._csr_dense_dot_cuda(
                    view[0], view[1], view[2], view[3], None, rhs, False),
                SPARSE_OPS_REPS, hide_host=True)
            del view
        if not same:
            bad.append(f"csr_dense_dot {name}: not bit-equal to its plain "
                       f"version over 20 launches ({err} off)")
    emit(dict(phase="csr_kernel", card=STASH["smi"], B=FM_B,
              features=FM_FEATURES, factor=FM_FACTOR, **out, ok=not bad))
    failures.extend(bad)
    return out


def _fm_tables(model):
    """The model's tables and the store's Adam state (when made)."""
    out = {"w": model.w._data, "v": model.v._data}
    upd = model.kv._updater
    for key in ("fm_w", "fm_v"):
        for i, s in enumerate(upd.states.get(key, ()) if upd else ()):
            out[f"{key}.state{i}"] = s._data
    return out


def fm_cpu_check(torch, mx, fm, first, card_loss, pushed, card_rows,
                 rows):
    """Step 1 of phase 24b against a CPU model on the same batch and
    tables: the loss and the pushed gradients within FM_CHECK_RTOL (of
    the step's largest gradient: the CSR products are bit-equal, but the
    card's reductions (the logits' sum over the factors, w0's gradient,
    a sum over the batch that nearly cancels) add in another order than
    the CPU's), and the card's updated rows against the CPU's Adam
    applied to the card's own gradients, within FM_CHECK_RTOL.  (The
    tables after the step are not compared with the CPU model's directly:
    Adam's first step is lr·g/(|g| + 3.2e-7), so a row whose gradient
    nearly cancels turns those last bits into differences of up to ~1e-4
    of lr.)  The direct differences are printed beside."""
    def record(kv, into):
        push = kv.push

        def call(key, value, priority=0):
            into[key] = value.copy()
            push(key, value, priority)
        kv.push = call

    cpu_pushed = {}
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.Adam(learning_rate=FM_LR))
    record(kv, cpu_pushed)
    model = fm.FMModel(FM_FEATURES, FM_FACTOR, seed=SEED + 244, kvstore=kv,
                       ctx=mx.cpu())
    cpu_loss = model.step(*first)
    out = dict(loss_rel=abs(card_loss - cpu_loss) / abs(cpu_loss))
    # w0's gradient is a sum over the batch that nearly cancels: every
    # gradient is held to the step's largest one
    scale = max(float(np.abs(g.asnumpy()).max())
                for g in cpu_pushed.values())
    for key, g in cpu_pushed.items():
        c = pushed[key].as_in_context(mx.cpu())
        cd, gd = (c.data, g.data) if hasattr(g, "indices") else (c, g)
        same = not hasattr(g, "indices") or torch.equal(
            c.indices._data, g.indices._data)
        out[f"grad_{key}_rel"] = float(
            (cd._data - gd._data).abs().max() / scale) \
            if same else float("inf")
    replay = mx.kv.create("local")
    replay.set_optimizer(mx.optimizer.Adam(learning_rate=FM_LR))
    fresh = fm.FMModel(FM_FEATURES, FM_FACTOR, seed=SEED + 244,
                       kvstore=replay, ctx=mx.cpu())
    for key, g in pushed.items():
        replay.push(key, g.as_in_context(mx.cpu()))
    for k, key in (("w", "fm_w"), ("v", "fm_v")):
        want = replay._store[key]._data[rows]
        out[f"{k}_replay_max_abs_err"] = float(
            (card_rows[k] - want).abs().max())
        out[f"{k}_replay_ok"] = bool(torch.allclose(
            card_rows[k], want, rtol=FM_CHECK_RTOL, atol=1e-7))
        out[f"{k}_vs_cpu_model_max_abs_diff"] = float(
            (card_rows[k] - getattr(model, k)._data[rows]).abs().max())
    out["ok"] = out["loss_rel"] <= FM_CHECK_RTOL and all(
        v <= FM_CHECK_RTOL for k, v in out.items()
        if k.startswith("grad_")) and out["w_replay_ok"] and \
        out["v_replay_ok"]
    del model, fresh, kv, replay
    return out


def fm_repeat_check(torch, mx, fm, model, csr, label):
    """Step 1 of phase 24b again, on the card, from the state it starts
    from: a twin model from the same seed (its tables checked bit-equal
    to the model's before its first step) and a fresh ``local`` store
    with Adam take the same batch.  Called before the model's step;
    returns a function that, given the model's tables and pushed
    gradients after that step, compares the twin's with them bit for
    bit."""
    before = {k: getattr(model, k)._data for k in ("w", "v", "w0")}
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.Adam(learning_rate=FM_LR))
    twin = fm.FMModel(FM_FEATURES, FM_FACTOR, seed=SEED + 244, kvstore=kv,
                      ctx=mx.gpu(0))
    same_start = all(torch.equal(getattr(twin, k)._data, t)
                     for k, t in before.items())
    pushed, push = {}, kv.push

    def record(key, value, priority=0):
        pushed[key] = value.copy()
        push(key, value, priority)
    kv.push = record
    twin.step(csr, label)

    def compare(tables, model_pushed):
        mine = dict(_fm_tables(twin), w0=twin.w0._data)
        theirs = dict(tables, w0=model.w0._data)
        out = dict(same_start=same_start)
        for k, t in mine.items():
            out[f"{k}_bit_identical"] = bool(torch.equal(t, theirs[k]))
        for key, g in pushed.items():
            h = model_pushed[key]
            parts = ("data", "indices") if hasattr(g, "indices") else ()
            out[f"grad_{key}_bit_identical"] = all(
                torch.equal(getattr(g, p)._data, getattr(h, p)._data)
                for p in parts) if parts else bool(
                torch.equal(g._data, h._data))
        out["ok"] = all(out.values()) and len(pushed) == 3
        return out
    return compare


def fm_phase(torch, mx, fm, mt, failures):
    """Phase 24b, the slice's main path: ``FMModel(1_000_000, 16)`` on the
    card with a ``local`` store running Adam (lr FM_LR: the lazy row
    updates), fed by ``io.LibSVMIter(batch_size=1000)`` over a
    Criteo-shaped file of 64,000 rows written here from the seed; 64
    steps.  After each step the rows the batch did not touch are
    bit-equal to before in ``w``, ``v`` and Adam's state; the loss is
    finite and lower over the last 8 steps than over the first 8; step
    1 matches a CPU model's step on the same batch and tables
    (``fm_cpu_check``), and step 1 run again on the card from the same
    state (a twin model from the same seed, its tables checked equal
    first) gives bit-identical tables, Adam state and pushed gradients
    (``fm_repeat_check``: the CSR products, ``csrc/csr_dense_dot.cu`` in
    both directions, add in a fixed order).  Each step is split (a
    synchronize at each boundary) into the iterator's wait, the forward
    and gradients, push + update, and the pulls; samples/s and peak
    memory.  The lazy update is not the multi-tensor kernel's (0
    launches)."""
    import tempfile

    root = tempfile.mkdtemp(prefix="mxt_fm_")
    path = os.path.join(root, "criteo_shaped.libsvm")
    t = time.perf_counter()
    pos = write_criteo(path, FM_ROWS, SEED + 243)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    with mx.gpu(0):
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(FM_FEATURES,),
                              batch_size=FM_B)
    parse_s = time.perf_counter() - t
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.Adam(learning_rate=FM_LR))
    model = fm.FMModel(FM_FEATURES, FM_FACTOR, seed=SEED + 244, kvstore=kv,
                       ctx=mx.gpu(0))
    marks, pushed = [], {}

    def timed(fn, tag):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            marks.append((tag, t0, time.perf_counter()))
            if tag == "push" and not losses:  # step 1's gradients
                pushed[a[0]] = a[1].copy()
            return r
        return call

    kv.push = timed(kv.push, "push")
    kv.row_sparse_pull = timed(kv.row_sparse_pull, "pull")
    kv.pull = timed(kv.pull, "pull")
    losses, split, untouched_ok, first = [], [], True, None
    mt.multi_tensor_update.launches = 0
    batches = iter(it)
    for step in range(FM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = next(batches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        csr, label = b.data[0], b.label[0]
        rows = torch.unique(csr.indices._data)
        before = {k: v.clone() for k, v in _fm_tables(model).items()}
        if step == 0:
            first = (csr.as_in_context(mx.cpu()),
                     label.as_in_context(mx.cpu()))
            repeat = fm_repeat_check(torch, mx, fm, model, csr, label)
        del marks[:]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses.append(model.step(csr, label))
        t3 = time.perf_counter()
        push = [m for m in marks if m[0] == "push"]
        pull = [m for m in marks if m[0] == "pull"]
        split.append(dict(
            iterator_ms=(t1 - t0) * 1e3,
            forward_ms=(push[0][1] - t2) * 1e3,
            push_update_ms=sum(e - s for _, s, e in push) * 1e3,
            pull_ms=(sum(e - s for _, s, e in pull) + t3 - pull[-1][2]) *
            1e3, step_ms=(t3 - t2) * 1e3))
        keep = torch.ones(FM_FEATURES, dtype=torch.bool, device=rows.device)
        keep[rows] = False
        after = _fm_tables(model)
        for k, old in before.items():
            if not torch.equal(after[k][keep], old[keep]):
                untouched_ok = False
                failures.append(f"fm step {step}: untouched rows of {k} "
                                "changed")
        if step == 0:
            card_rows = {k: after[k][rows].cpu() for k in ("w", "v")}
            card_rows_idx = rows.cpu()
            repeat = repeat(after, pushed)
    launches = mt.multi_tensor_update.launches
    peak = torch.cuda.max_memory_allocated() - base_mem
    check = fm_cpu_check(torch, mx, fm, first, losses[0], pushed,
                         card_rows, card_rows_idx)
    # the first step allocates and warms the sort and gather kernels
    mean = {k: float(np.mean([s[k] for s in split[1:]])) for k in split[0]}
    fed_ms = mean["iterator_ms"] + mean["step_ms"]
    head, tail = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
    ok = untouched_ok and bool(np.isfinite(losses).all()) and \
        tail < head and check["ok"] and launches == 0 and \
        model.v._data.is_cuda and repeat["ok"]
    row = dict(phase="fm", card=STASH["smi"], features=FM_FEATURES,
               factor=FM_FACTOR, B=FM_B, rows=FM_ROWS, steps=FM_STEPS,
               optimizer="adam", lr=FM_LR, store="local",
               positive_share=float(pos), write_s=write_s, parse_s=parse_s,
               losses=losses, first8=head, last8=tail,
               untouched_rows_bit_equal=untouched_ok, cpu_check=check,
               repeat_check=repeat,
               mean_split_ms_after_first=mean,
               samples_per_s=FM_B / fed_ms * 1e3,
               samples_per_s_step_only=FM_B / mean["step_ms"] * 1e3,
               split_first3=split[:3], peak_bytes=peak,
               table_bytes=FM_FEATURES * (FM_FACTOR + 1) * 4,
               update_kernel_launches=launches, ok=ok)
    emit(row)
    if not ok:
        failures.append(f"fm: head {head} tail {tail} check {check} "
                        f"launches {launches} repeat {repeat}")
    STASH["fm"] = dict(path=path, root=root, it=it, mean=mean)
    del model, kv
    free_card(torch)
    return row


def sparse_linear_phase(torch, mx, failures):
    """Phase 24c: ``examples/sparse_linear_classification.py``'s loop at
    its defaults (N=40,000, D=4,096, density 0.02, batch 512, 40 steps,
    SGD lr 5.0), written against the port on the card (the example
    imports the JAX package): CSR features, the dense weight's gradient
    through the CSR ``dot`` under ``autograd.record()``.  The loss falls
    (last < 0.8 x first) and the full-set accuracy beats 0.5 by 0.1."""
    cfg = SPARSE_LIN
    rs = np.random.RandomState(0)
    x = rs.randn(cfg["n"], cfg["d"]).astype(np.float32)
    x[rs.rand(cfg["n"], cfg["d"]) > cfg["density"]] = 0.0
    w_true = rs.randn(cfg["d"]).astype(np.float32)
    y = (x @ w_true > 0).astype(np.float32)
    nd = mx.nd
    with mx.gpu(0):
        x_csr = nd.tanh(nd.array(x).tostype("csr") * 1.0)
        xn = x_csr.asnumpy()
        w = nd.zeros((cfg["d"], 1))
        w.attach_grad()
        b = nd.zeros((1,))
        b.attach_grad()
        opt = mx.optimizer.SGD(learning_rate=cfg["lr"])
        states = {0: opt.create_state(0, w), 1: opt.create_state(1, b)}
        rs = np.random.RandomState(1)
        losses, step_ms = [], []
        for _ in range(cfg["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx = rs.randint(0, cfg["n"], cfg["batch"])
            xb = nd.array(xn[idx]).tostype("csr")
            yb = nd.array(y[idx].reshape(-1, 1))
            with mx.autograd.record():
                logits = nd.dot(xb, w) + b
                ls = nd.log_softmax(nd.concat(nd.zeros_like(logits),
                                              logits, dim=1))
                nll = -(yb * ls[:, 1:2] + (1 - yb) * ls[:, 0:1])
                nll = nll.mean()
            nll.backward()
            for i, p in ((0, w), (1, b)):
                opt.update(i, p, p.grad, states[i])
            losses.append(float(nll.asscalar()))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        pred = (nd.dot(x_csr, w) + b).asnumpy().ravel() > 0
        acc = float((pred == (y > 0.5)).mean())
        on_card = x_csr.data._data.is_cuda and w.grad._data.is_cuda
    ok = losses[-1] < losses[0] * 0.8 and acc > 0.6 and on_card
    emit(dict(phase="sparse_linear", card=STASH["smi"], **cfg,
              nnz=int(x_csr.data.shape[0]), losses=losses, accuracy=acc,
              step_ms_mean=float(np.mean(step_ms[1:])), on_card=on_card,
              ok=ok))
    if not ok:
        failures.append(f"sparse linear: losses {losses[0]} -> "
                        f"{losses[-1]}, accuracy {acc}")
    del x, xn, x_csr
    free_card(torch)


def _ps_server(uri, secret):
    """A ``dist_async`` parameter server in a process of its own on this
    card; returns the process once the port takes connections."""
    import socket

    env = dict(os.environ, MXT_PS_SECRET=secret,
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.abspath(__file__))] +
                   [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from mxnet_tpu_torch.kvstore import dist_async as d; "
         f"d.serve_forever({uri!r}, background=False)"], env=env)
    host, port = uri.rsplit(":", 1)
    deadline = time.time() + 120
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"parameter server exited {proc.returncode}")
        try:
            socket.create_connection((host, int(port)), timeout=1).close()
            return proc
        except OSError:
            time.sleep(0.2)
    proc.kill()
    raise RuntimeError("parameter server did not start")


def fm_stores_phase(torch, mx, fm, parallel, failures):
    """Phase 24d: FM_STORE_STEPS steps of phase 24b's model and batches
    through three stores side by side, each with Adam: ``local``, a
    one-rank NCCL ``dist_sync`` store (its push and ``row_sparse_pull``
    go to its local store), and ``dist_async`` over loopback TCP to a
    parameter server process on this card (per-run secret).  Each
    model's pushes are also given to a ``local`` store of its own (its
    shadow): after each step the model's tables, which its pulls wrote,
    must equal its shadow store's bit for bit.  Across the three models
    the relative norm of each table's difference from the ``local``
    model's is printed and held to 1e-4.
    The ms of each store's push + pulls a step."""
    import secrets

    from mxnet_tpu_torch.kvstore import dist_async

    it = STASH["fm"]["it"]
    it.reset()
    parallel.initialize(f"127.0.0.1:{parallel.free_port()}", 1, 0,
                        init_timeout=120)
    secret = secrets.token_hex(16)
    uri = f"127.0.0.1:{parallel.free_port()}"
    proc = _ps_server(uri, secret)
    models, shadows, io_ms, diffs, exact = {}, {}, {}, [], True
    try:
        stores = {"local": mx.kv.create("local"),
                  "dist_sync": mx.kv.create("dist_sync"),
                  "dist_async": dist_async.AsyncPSKVStore(root_uri=uri,
                                                          secret=secret)}
        for name, kv in stores.items():
            kv.set_optimizer(mx.optimizer.Adam(learning_rate=FM_LR))
            shadow = shadows[name] = mx.kv.create("local")
            shadow.set_optimizer(mx.optimizer.Adam(learning_rate=FM_LR))
            marks = []

            def timed(fn, marks=marks, shadow=shadow, push=False):
                def call(*a, **k):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    r = fn(*a, **k)
                    torch.cuda.synchronize()
                    marks.append(time.perf_counter() - t0)
                    if push:
                        shadow.push(a[0], a[1])
                    return r
                return call

            init = kv.init

            def init_both(key, value, init=init, shadow=shadow):
                shadow.init(key, value)
                init(key, value)

            kv.init = init_both
            kv.push = timed(kv.push, push=True)
            kv.row_sparse_pull, kv.pull = (timed(kv.row_sparse_pull),
                                           timed(kv.pull))
            models[name] = fm.FMModel(FM_FEATURES, FM_FACTOR,
                                      seed=SEED + 244, kvstore=kv,
                                      ctx=mx.gpu(0))
            models[name]._marks = marks
            io_ms[name] = []
        losses = {n: [] for n in models}
        for step, b in zip(range(FM_STORE_STEPS), it):
            row = {}
            for name, model in models.items():
                del model._marks[:]
                losses[name].append(model.step(b.data[0], b.label[0]))
                io_ms[name].append(sum(model._marks) * 1e3)
                for k, key in (("w0", "fm_w0"), ("w", "fm_w"),
                               ("v", "fm_v")):
                    mine = getattr(model, k)._data
                    if not torch.equal(mine, shadows[name]._store[key]
                                       ._data):
                        exact = False
                        failures.append(f"fm stores: {name}'s {k} is not "
                                        f"its shadow store's at step "
                                        f"{step}")
                    ref = getattr(models["local"], k)._data
                    row[f"{name}.{k}"] = float(
                        torch.linalg.vector_norm(mine - ref) /
                        torch.linalg.vector_norm(ref).clamp_min(1e-30))
            diffs.append(row)
        stores["dist_async"].close()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
        parallel.shutdown()
    worst = {k: max(d[k] for d in diffs) for k in diffs[0]}
    ok = exact and len(diffs) == FM_STORE_STEPS and \
        max(worst.values()) <= 1e-4 and all(
            np.allclose(losses[n], losses["local"], rtol=FM_CHECK_RTOL)
            for n in losses)
    emit(dict(phase="fm_stores", card=STASH["smi"], steps=FM_STORE_STEPS,
              features=FM_FEATURES, factor=FM_FACTOR, B=FM_B,
              server="a process of its own, its table on this card",
              signed=True, losses=losses, tables_equal_shadow_store=exact,
              max_rel_norm_diff_vs_local_model=worst,
              push_pull_ms={n: float(np.mean(v[1:]))
                            for n, v in io_ms.items()}, ok=ok))
    if not ok:
        failures.append(f"fm stores: {worst}, losses {losses}")
    del models, shadows
    free_card(torch)


_HAND_WRITTEN = ("fa_fwd", "fa_bwd", "fused_mm_affine_relu",
                 "multi_tensor_update", "nms_keep")
_LIBRARY = ("gemm", "cutlass", "cudnn", "cublas", "xmma", "sm90_", "sm80_",
            "implicit_convolve", "conv2d", "winograd", "nhwc", "cusparse",
            "dgrad", "wgrad")


def _device_split(torch, prof, wall_ms):
    """The device time of a ``torch.profiler`` run split between the
    port's hand-written kernels, cuBLAS/cuDNN, other kernels and memory
    copies, with the host's share of the wall time (the wall time less
    the union of the device's busy intervals)."""
    kinds = dict(hand_written=0.0, cublas_cudnn=0.0, other_kernels=0.0,
                 memcpy_memset=0.0)
    spans, names = [], {}
    for e in prof.events():
        if getattr(e, "device_type", None) != \
                torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        name = e.name.lower()
        if "memcpy" in name or "memset" in name:
            kind = "memcpy_memset"
        elif any(k in name for k in _HAND_WRITTEN):
            kind = "hand_written"
        elif any(k in name for k in _LIBRARY):
            kind = "cublas_cudnn"
        else:
            kind = "other_kernels"
        kinds[kind] += us / 1e3
        spans.append((e.time_range.start, e.time_range.end))
        names[e.name[:200]] = names.get(e.name[:200], 0.0) + us / 1e3
    busy, end = 0.0, -1e30
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    busy_ms = busy / 1e3
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                host_only_ms=max(wall_ms - busy_ms, 0.0),
                idle_share=max(wall_ms - busy_ms, 0.0) / wall_ms,
                device_ms=kinds, kernels=len(spans), top=top)


def profile_phase(torch, mx, fm, vision, failures):
    """Phase 24e: ``mx.profiler`` with ``profile_device_trace`` (a
    ``torch.profiler`` CUDA trace) over one fed phase-24b step (the
    iterator's batch included) and one
    ResNet-50 v1 bf16 B=128 forward (the fused 1x1 kernel's route),
    each after a warm-up: the device time split between the port's
    hand-written kernels, cuBLAS/cuDNN, other kernels and copies, and
    the host's share of the step's wall time; the op events' aggregate
    (``profiler.dumps``) beside it."""
    import tempfile

    prof = mx.profiler
    root = tempfile.mkdtemp(prefix="mxt_prof_")
    out = {}

    def profiled(name, fn):
        fn()  # warm-up
        torch.cuda.synchronize()
        prof.set_config(filename=os.path.join(root, f"{name}.json"),
                        profile_device_trace=True, aggregate_stats=True)
        prof.set_state("run")
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.set_state("stop")
        split = _device_split(torch, prof.device_profile(), wall)
        if split["kernels"] == 0:  # no device events: CUDA events
            split["event_ms"] = time_ms(torch, fn, 1)
        ops = json.loads(prof.dumps(format="json", reset=True))
        split["host_op_events"] = sum(v["count"] for v in ops.values())
        out[name] = split

    it = STASH["fm"]["it"]
    it.reset()
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.Adam(learning_rate=FM_LR))
    model = fm.FMModel(FM_FEATURES, FM_FACTOR, seed=SEED + 244, kvstore=kv,
                       ctx=mx.gpu(0))
    batches = iter(it)

    def fm_step():
        b = next(batches)
        model.step(b.data[0], b.label[0])

    profiled("fm_step", fm_step)
    del model, kv
    free_card(torch)
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.cast("bfloat16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 245)
    x = mx.nd.array(torch.rand((PROF_B, 3, PROF_IMAGE, PROF_IMAGE),
                               generator=gen, device="cuda").bfloat16())
    profiled("resnet50_bf16_b128_forward",
             lambda: net(x).wait_to_read())
    # without device events (CUPTI unavailable) the split is not measured;
    # the resnet forward's own kernels must show where there are events
    traced = all(v["kernels"] > 0 for v in out.values())
    ok = not traced or \
        out["resnet50_bf16_b128_forward"]["device_ms"]["hand_written"] > 0
    emit(dict(phase="profile", card=STASH["smi"], device_trace=traced,
              splits=out, ok=ok))
    if not ok:
        failures.append(f"profile: the resnet forward showed no "
                        f"hand-written kernel: {out}")
    del net, x
    free_card(torch)
    return out


# -- slice 17: symbols and export -------------------------------------------
SYM_B = 32                   # 25a: Module and Executor batch (f32)
SYM_IMAGE = 224
SYM_STEPS = 8                # 25a: Module.fit steps (2 batches x 4 epochs)
SYM_LR = 0.01                # 25a: SGD with momentum 0.9
SYM_TOL = 1e-4               # 25a: symbol vs Gluon forward, relative norm
LSTM_HIDDEN = 256            # 25a: the bucketing LSTM
LSTM_LENS = (35, 20)         # 25a: its two buckets (default first)
LSTM_ROUNDS = 6              # 25a: steps of each bucket, alternating
LSTM_LR = 0.02               # 25a: SGD
EXPORT_B = 32                # 25b: the exported ResNet-50's batch (bf16)
EXPORT_TOL = 2.0 ** -8       # 25b, 25c: program vs live block, rel. norm
BERT_SYM_B = 16              # 25c: bert_to_symbol / ONNX batch (f32)
BERT_SYM_TOL = 1e-4          # 25c: relative norm vs BERTModel (f32)
QUANT_CHECK_B = 2            # 25d: the int8 graph, card vs CPU
QUANT_TOL = INT8_CPU_TOL     # 25d: of the largest output, card vs CPU


def resnet50_symbol(mx, classes=1000, label=True):
    """``resnet50_v1`` as an ``mx.sym`` graph, layer for layer the Gluon
    net (``gluon/model_zoo/vision/resnet.py``: BottleneckV1, stages of
    3, 4, 6, 3 units, the stride on each unit's first 1x1 conv, which has
    a bias), each node named after the Gluon layer's structural name with
    ``_`` for ``.``; returns (symbol, {symbol argument or auxiliary name:
    Gluon structural name})."""
    S = mx.sym
    names = {}

    def conv(x, key, c, k, stride=1, pad=0, bias=False):
        n = key.replace(".", "_")
        names[n + "_weight"] = key + ".weight"
        if bias:
            names[n + "_bias"] = key + ".bias"
        return S.Convolution(x, kernel=(k, k), stride=(stride, stride),
                             pad=(pad, pad), num_filter=c, no_bias=not bias,
                             name=n)

    def bn(x, key):
        n = key.replace(".", "_")
        for sym_name, gluon_name in (("gamma", "gamma"), ("beta", "beta"),
                                     ("moving_mean", "running_mean"),
                                     ("moving_var", "running_var")):
            names[f"{n}_{sym_name}"] = f"{key}.{gluon_name}"
        return S.BatchNorm(x, eps=1e-5, momentum=0.9, fix_gamma=False,
                           name=n)

    def relu(x, key):
        return S.Activation(x, act_type="relu", name=key.replace(".", "_"))

    with mx.name.NameManager():
        x = S.var("data")
        x = relu(bn(conv(x, "features.0", 64, 7, 2, 3), "features.1"),
                 "features.2")
        x = S.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max", name="features_3")
        in_c = 64
        for i, (units, c) in enumerate(zip((3, 4, 6, 3),
                                           (256, 512, 1024, 2048))):
            for u in range(units):
                key = f"features.{4 + i}.{u}"
                stride = 2 if i and not u else 1
                h = relu(bn(conv(x, key + ".body.0", c // 4, 1, stride,
                                 bias=True), key + ".body.1"),
                         key + ".body.2")
                h = relu(bn(conv(h, key + ".body.3", c // 4, 3, 1, 1),
                            key + ".body.4"), key + ".body.5")
                h = bn(conv(h, key + ".body.6", c, 1, bias=True),
                       key + ".body.7")
                res = x
                if not u and c != in_c:
                    res = bn(conv(x, key + ".downsample.0", c, 1, stride),
                             key + ".downsample.1")
                x = S.Activation(h + res, act_type="relu",
                                 name=key.replace(".", "_") + "_out")
            in_c = c
        x = S.Pooling(x, kernel=(1, 1), global_pool=True, pool_type="avg",
                      name="features_8")
        names["output_weight"] = "output.weight"
        names["output_bias"] = "output.bias"
        x = S.FullyConnected(x, num_hidden=classes, name="output")
        if label:
            x = S.SoftmaxOutput(x, name="softmax")
    return x, names


def _sym_params(mx, names, arrays, ctx, aux_names):
    """(arg_params, aux_params) of the symbol from the Gluon arrays."""
    arg, aux = {}, {}
    for n, key in names.items():
        (aux if n in aux_names else arg)[n] = mx.nd.array(arrays[key],
                                                          ctx=ctx)
    return arg, aux


def symbol_module_phase(torch, mx, vision, mt, failures):
    """Phase 25a: ``resnet50_v1`` built with ``mx.sym``
    (``resnet50_symbol``), weights copied from an initialized Gluon
    ``resnet50_v1`` by structural name: its ``simple_bind`` inference
    forward at f32 B=32 against the Gluon forward (relative norm within
    SYM_TOL); ``Module.fit`` SGD with momentum over SYM_STEPS steps (two
    seeded batches, four epochs) through the fused update kernel, its
    step ms and images/s and the loss falling; then ``BucketingModule``
    over a one-layer ``sym.RNN`` LSTM at two sequence lengths sharing
    its parameters.  Returns the update kernel's launches."""
    free_card(torch)
    gpu = mx.gpu(0)
    arrays = _resnet_arrays(torch, mx, vision.resnet50_v1, (1, 3, 64, 64))
    STASH["resnet50_arrays"] = arrays
    sym, names = resnet50_symbol(mx)
    aux_names = set(sym.list_auxiliary_states())
    arg, aux = _sym_params(mx, names, arrays, gpu, aux_names)
    missing = set(sym.list_arguments()) - set(arg) - {"data",
                                                      "softmax_label"}
    gen = torch.Generator().manual_seed(SEED + 25)
    x = torch.rand((SYM_B, 3, SYM_IMAGE, SYM_IMAGE), generator=gen)
    net = vision.resnet50_v1()
    from mxnet_tpu_torch.convert import load_numpy_params

    load_numpy_params(net, arrays, ctx=gpu)
    with mx.gpu(0):
        want = net(mx.nd.array(x, ctx=gpu))._data
    del net
    exe = sym.simple_bind(gpu, data=(SYM_B, 3, SYM_IMAGE, SYM_IMAGE), grad_req="null")
    exe.copy_params_from(arg, aux)
    got = exe.forward(is_train=False, data=mx.nd.array(x, ctx=gpu))[0]
    # SoftmaxOutput's inference output is the softmax: compare logits'
    # softmax
    rel = _rel_norm(torch, got._data, torch.softmax(want.float(), -1))
    infer_ms = time_ms(torch, lambda: exe.forward(is_train=False), 3)
    del exe
    free_card(torch)
    # Module.fit: two seeded batches, four epochs
    xs = torch.rand((2 * SYM_B, 3, SYM_IMAGE, SYM_IMAGE), generator=gen).numpy()
    ys = torch.randint(0, 1000, (2 * SYM_B,), generator=gen).float().numpy()
    losses, stamps = [], []
    mt.multi_tensor_update.launches = 0  # the main path starts here
    with mx.gpu(0):
        it = mx.io.NDArrayIter(xs, ys, batch_size=SYM_B)
        mod = mx.mod.Module(sym, context=gpu)

        def on_batch(param):
            out = mod.get_outputs()[0]._data.detach().float()
            lab = torch.from_numpy(ys[param.nbatch * SYM_B:
                                      (param.nbatch + 1) * SYM_B]).long()
            p = out[torch.arange(SYM_B), lab.to(out.device)]
            losses.append(float(-torch.log(p.clamp_min(1e-30)).mean()))
            stamps.append(time.perf_counter())

        stamps.append(time.perf_counter())
        mod.fit(it, num_epoch=SYM_STEPS // 2, optimizer="sgd",
                optimizer_params={"learning_rate": SYM_LR,
                                  "momentum": 0.9},
                arg_params=arg, aux_params=aux, batch_end_callback=on_batch)
    updates = mt.multi_tensor_update.launches  # ... and ends here
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    warm = step_ms[2:]
    fit = dict(losses=losses, step_ms=step_ms,
               warm_step_ms=sum(warm) / len(warm),
               images_per_s=SYM_B / (sum(warm) / len(warm)) * 1e3,
               update_launches=updates)
    STASH["sym_module"] = (mod, sym)
    # BucketingModule over a sym.RNN LSTM, shared parameters
    bucket = _bucketing_lstm(torch, mx, gen)
    ok = rel <= SYM_TOL and not missing and \
        losses[-2:] and max(losses[-2:]) < min(losses[:2]) and \
        updates == SYM_STEPS and bucket["ok"]
    emit(dict(phase="symbol_module", nvidia_smi=_card(), net="resnet50_v1",
              B=SYM_B, dtype="float32", nodes=len(sym._topo()),
              args=len(sym.list_arguments()),
              aux=len(sym.list_auxiliary_states()),
              forward_vs_gluon_rel_norm=rel, tol=SYM_TOL,
              executor_forward_ms=infer_ms, fit=fit, bucketing=bucket,
              ok=ok))
    if not ok:
        failures.append(f"25a: rel {rel}, missing {missing}, losses "
                        f"{losses}, updates {updates}, bucketing {bucket}")
    free_card(torch)
    return updates


def _bucketing_lstm(torch, mx, gen):
    """``BucketingModule`` over a one-layer ``sym.RNN`` LSTM tagger at
    LSTM_LENS, LSTM_ROUNDS steps a bucket in turn, each step's label the
    argmax of the step's first 10 input features (learnable); both
    buckets read one set of parameter arrays and each bucket's loss
    falls."""
    gpu, nb, hid = mx.gpu(0), 32, LSTM_HIDDEN

    def sym_gen(seq_len):
        S = mx.sym
        with mx.name.NameManager():
            params = [S.var(f"lstm_{n}", shape=s) for n, s in (
                ("i2h_weight", (4 * hid, 64)), ("h2h_weight", (4 * hid, hid)),
                ("i2h_bias", (4 * hid,)), ("h2h_bias", (4 * hid,)))]
            out = S.RNN(S.var("data"), [S.var("lstm_h"), S.var("lstm_c")],
                        params, state_size=hid, mode="lstm", name="lstm")
            out = S.Reshape(out, shape=(-1, hid))
            fc = S.FullyConnected(out, num_hidden=10, name="fc")
            lab = S.Reshape(S.var("softmax_label"), shape=(-1,))
            return S.SoftmaxOutput(fc, lab, name="softmax"), \
                ("data", "lstm_h", "lstm_c"), ("softmax_label",)

    def shapes(t):
        return [("data", (t, nb, 64)), ("lstm_h", (1, nb, hid)),
                ("lstm_c", (1, nb, hid))]

    with mx.gpu(0):
        bm = mx.mod.BucketingModule(sym_gen, default_bucket_key=LSTM_LENS[0],
                                    context=gpu)
        bm.bind(shapes(LSTM_LENS[0]),
                [("softmax_label", (LSTM_LENS[0], nb))])
        bm.init_params(mx.init.Xavier())
        # Module's rescale_grad is 1 / T: each step sums the gradients of
        # nb rows, so the rate is small
        bm.init_optimizer(optimizer="sgd",
                          optimizer_params={"learning_rate": LSTM_LR})
        data = {}
        for t in LSTM_LENS:
            x = torch.randn((t, nb, 64), generator=gen)
            data[t] = (x, x[..., :10].argmax(-1).float())
        zeros = mx.nd.zeros((1, nb, hid), ctx=gpu)
        losses = {t: [] for t in LSTM_LENS}
        for _ in range(LSTM_ROUNDS):
            for t in LSTM_LENS:
                x, y = data[t]
                batch = mx.io.DataBatch(
                    [mx.nd.array(x, ctx=gpu), zeros, zeros],
                    [mx.nd.array(y, ctx=gpu)], bucket_key=t,
                    provide_data=shapes(t),
                    provide_label=[("softmax_label", (t, nb))])
                bm.forward(batch, is_train=True)
                prob = bm.get_outputs()[0]._data.detach()
                p = prob[torch.arange(t * nb), y.reshape(-1).long()
                         .to(prob.device)]
                losses[t].append(float(-torch.log(p.clamp_min(1e-30))
                                       .mean()))
                bm.backward()
                bm.update()
    mods = bm._buckets
    shared = all(mods[LSTM_LENS[0]]._exec.arg_dict[n] is
                 mods[LSTM_LENS[1]]._exec.arg_dict[n]
                 for n in mods[LSTM_LENS[0]]._param_names)
    ok = shared and all(v[-1] < v[0] for v in losses.values())
    return dict(lengths=list(LSTM_LENS), hidden=hid, batch=nb,
                losses={str(k): v for k, v in losses.items()},
                shared_parameters=shared, ok=ok)


def _program_nodes(program, op):
    return sum(1 for n in program.graph.nodes
               if n.op == "call_function" and str(n.target) ==
               f"mxnet_tpu_torch.{op}.default")


def export_resnet_phase(torch, mx, vision, cbr, serving, failures):
    """Phase 25b: ``resnet50_v1`` bf16 (the seed's weights, as phase 14),
    hybridized and called once at B=EXPORT_B, exported on the card
    (``HybridBlock.export``: a ``torch.export`` program with the fused
    kernel #4 as its custom-op nodes), read back by
    ``SymbolBlock.imports`` and ``Predictor``: 16 #4 nodes in the
    program, 16 launches a ``Predictor.forward`` (captured once, then
    replayed), outputs against the live hybridized block; then 64
    requests from 8 clients through ``InferenceServer(Predictor)`` (nine
    waves, as phase 14; one batch bucket, the program's B) with its
    images/s and latencies beside phase 14's.  Returns (#4's launches,
    its tensor-core launches) of the served path."""
    import tempfile

    free_card(torch)
    gpu = mx.gpu(0)
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=gpu)
    net(mx.nd.zeros((1, 3, SERVE_IMAGE, SERVE_IMAGE), ctx=gpu))
    net.cast("bfloat16")
    net.hybridize(static_alloc=True)
    gen = torch.Generator().manual_seed(SEED + 26)
    x = torch.rand((EXPORT_B, 3, SERVE_IMAGE, SERVE_IMAGE), generator=gen)
    xb = mx.nd.array(x.bfloat16(), ctx=gpu)
    live = net(xb)._data.clone()
    live_ms = time_ms(torch, lambda: net(xb), 5)
    fn = cbr.fused_matmul_affine_relu
    res = {}
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "resnet50_v1")
        t = time.perf_counter()
        sym_file, params_file = net.export(prefix)
        res["export_s"] = time.perf_counter() - t
        res["program_bytes"] = os.path.getsize(prefix + "-0000.pt2")
        res["params_bytes"] = os.path.getsize(params_file)
        block = mx.gluon.SymbolBlock.imports(sym_file, ["data"],
                                             params_file, ctx=gpu)
        res["program_fused_nodes"] = _program_nodes(block._program,
                                                    "fused_matmul_affine_relu")
        sb_out = block(xb)._data
        res["symbol_block_vs_live_rel_norm"] = _rel_norm(torch, sb_out, live)
        pred = mx.predictor.Predictor(sym_file, params_file, ctx=gpu)
    per_forward = []
    for _ in range(3):  # the capture, then replays
        before = fn.launches
        out = pred.forward(data=xb)[0]._data
        torch.cuda.synchronize()
        per_forward.append(fn.launches - before)
    res["launches_a_predictor_forward"] = per_forward
    res["predictor_vs_live_rel_norm"] = _rel_norm(torch, out, live)
    res["predictor_vs_live_max_abs"] = (out.float() - live.float()).abs() \
        .max().item()
    res["predictor_ms"] = time_ms(torch, lambda: pred.forward(data=xb), 5)
    res["live_block_ms"] = live_ms
    res["predictor_cache"] = pred.cache_stats()
    del net, block
    rng = np.random.RandomState(SEED + 14)
    images = [rng.rand(3, SERVE_IMAGE, SERVE_IMAGE).astype(np.float32)
              for _ in range(SERVE_REQUESTS)]
    config = serving.ServerConfig(
        max_batch=EXPORT_B, min_batch=EXPORT_B, max_length=SERVE_IMAGE,
        min_length=SERVE_IMAGE, length_axis=1, batch_window_ms=5.0,
        queue_capacity=SERVE_REQUESTS)
    fn.launches = fn.launches_mma = 0  # the main path starts here
    replies, waves, rate, stats = _serve_waves(
        serving, pred, config, images, pred.cache_stats)
    launches, mma = fn.launches, fn.launches_mma  # ... and ends here
    # each reply against a solo forward of its image through the program
    # (padded to the program's batch)
    worst = 0.0
    for i in range(0, SERVE_REQUESTS, EXPORT_B):
        ref = pred.forward(data=np.stack(images[i:i + EXPORT_B]))[0]._data
        ref = ref.float().cpu()
        for j in range(EXPORT_B):
            for wave in replies:
                got = torch.from_numpy(np.asarray(wave[i + j], np.float32))
                worst = max(worst, _rel_norm(torch, got, ref[j]))
    ok = res["program_fused_nodes"] == 16 and per_forward == [16] * 3 and \
        res["predictor_vs_live_rel_norm"] <= EXPORT_TOL and \
        res["symbol_block_vs_live_rel_norm"] <= EXPORT_TOL and \
        launches == 16 * stats["batches"] and mma == launches and \
        worst <= EXPORT_TOL and not any(w["errors"] for w in waves) and \
        stats["failed"] == 0
    emit(dict(phase="export_resnet", nvidia_smi=_card(), net="resnet50_v1",
              dtype="bfloat16", B=EXPORT_B, tol=EXPORT_TOL, **res,
              served=dict(requests=SERVE_REQUESTS, clients=SERVE_CLIENTS,
                          waves=waves, images_per_s=rate["requests_per_s"],
                          p50_ms=rate["p50_ms"], p99_ms=rate["p99_ms"],
                          after_first_wave=rate, batches=stats["batches"],
                          fused_launches=launches, worst_rel_norm=worst),
              phase14=STASH.get("resnet_serve"), ok=ok))
    if not ok:
        failures.append(f"25b: {res}, served launches {launches} for "
                        f"{stats['batches']} batches, worst {worst}")
    del pred
    free_card(torch)
    return launches, mma


def export_bert_phase(torch, mx, bert, fa, failures):
    """Phase 25c: ``bert_base`` (vocab 30522, dropout 0) from the seed:
    in f32 at B=BERT_SYM_B, T=128, ``bert_to_symbol`` → ``Executor`` and
    ``export_bert_onnx`` → ``import_model`` → bind, each against
    ``BERTModel``'s forward (relative norm within BERT_SYM_TOL); then in
    bf16 at B=64, T=128, hybridized and exported: 12 flash-forward nodes
    in the program, 12 launches of #1 a ``Predictor.forward``, outputs
    against the live block.  Each forward's ms.  Returns #1's launches
    (and its tensor-core launches) of the exported program's forwards."""
    import tempfile

    free_card(torch)
    gpu = mx.gpu(0)
    mx.random.seed(SEED)
    net = bert.bert_base(vocab_size=BERT_VOCAB, dropout=0.0)
    net.initialize(mx.init.Xavier(), ctx=gpu)
    gen = torch.Generator().manual_seed(SEED + 27)
    b, t = BERT_SYM_B, BERT_T
    ids = torch.randint(0, BERT_VOCAB, (b, t), generator=gen,
                        dtype=torch.int32)
    tt = torch.randint(0, 2, (b, t), generator=gen, dtype=torch.int32)
    args = [mx.nd.array(a, ctx=gpu, dtype="int32") for a in (ids, tt)]
    want = [o._data for o in net(*args)]
    res = dict(live_f32_ms=time_ms(torch, lambda: net(*args), 3))
    sym, params = bert.bert_to_symbol(net, b, t)
    inputs = {"data0": args[0], "data1": args[1]}
    exe = sym.bind(gpu, args={**params, **inputs}, grad_req="null")
    outs = exe.forward()
    res["symbol_rel_norm"] = [_rel_norm(torch, o._data, w)
                              for o, w in zip(outs, want)]
    res["symbol_ms"] = time_ms(torch, lambda: exe.forward(), 3)
    del exe
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "bert_base.onnx")
        t0 = time.perf_counter()
        bert.export_bert_onnx(net, path, b, t)
        res["onnx_export_s"] = time.perf_counter() - t0
        res["onnx_bytes"] = os.path.getsize(path)
        with mx.gpu(0):
            isym, iarg, iaux = mx.contrib.onnx.import_model(path)
    iexe = isym.bind(gpu, args={**iarg, **inputs}, aux_states=iaux,
                     grad_req="null")
    iouts = iexe.forward()
    res["onnx_rel_norm"] = [_rel_norm(torch, o._data, w)
                            for o, w in zip(iouts, want)]
    res["onnx_ms"] = time_ms(torch, lambda: iexe.forward(), 3)
    del iexe, iarg, iaux, params, outs, iouts
    free_card(torch)
    # the bf16 export at bench.py's BERT shape
    net.cast("bfloat16")
    net.hybridize(static_alloc=True)
    ids = torch.randint(0, BERT_VOCAB, (BERT_B, t), generator=gen,
                        dtype=torch.int32)
    tt = torch.zeros((BERT_B, t), dtype=torch.int32)
    args = [mx.nd.array(a, ctx=gpu, dtype="int32") for a in (ids, tt)]
    live = [o._data.clone() for o in net(*args)]
    res["live_bf16_ms"] = time_ms(torch, lambda: net(*args), 5)
    counters = _counters(fa)
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "bert_base")
        t0 = time.perf_counter()
        sym_file, params_file = net.export(prefix)
        res["export_s"] = time.perf_counter() - t0
        pred = mx.predictor.Predictor(sym_file, params_file, ctx=gpu)
        res["program_flash_nodes"] = _program_nodes(pred._block._program,
                                                    "flash_attention_fwd")
    per_forward = []
    _zero_counts(fa)  # the main path starts here
    for _ in range(3):
        before = counters[0].launches
        outs = pred.forward(data0=args[0], data1=args[1])
        torch.cuda.synchronize()
        per_forward.append(counters[0].launches - before)
    launches = counters[0].launches  # ... and ends here
    mma = counters[0].launches_mma
    other = [c.launches for c in counters[1:]]
    res["launches_a_predictor_forward"] = per_forward
    res["predictor_rel_norm"] = [_rel_norm(torch, o._data, w)
                                 for o, w in zip(outs, live)]
    res["predictor_ms"] = time_ms(
        torch, lambda: pred.forward(data0=args[0], data1=args[1]), 5)
    ok = max(res["symbol_rel_norm"]) <= BERT_SYM_TOL and \
        max(res["onnx_rel_norm"]) <= BERT_SYM_TOL and \
        res["program_flash_nodes"] == 12 and per_forward == [12] * 3 and \
        max(res["predictor_rel_norm"]) <= EXPORT_TOL and mma == launches \
        and other == [0, 0]
    emit(dict(phase="export_bert", nvidia_smi=_card(), net="bert_base",
              f32_B=b, bf16_B=BERT_B, T=t, tol=dict(
                  symbol=BERT_SYM_TOL, program=EXPORT_TOL), **res,
              flash_launches=launches, ok=ok))
    if not ok:
        failures.append(f"25c: {res}, backward launches {other}")
    del net, pred
    free_card(torch)
    return launches, mma


def checkpoint_quant_phase(torch, mx, failures):
    """Phase 25d: 25a's trained symbol through ``mx.model.
    save_checkpoint`` → ``load_checkpoint`` → ``Predictor`` (the nnvm
    replay route, one CUDA graph a signature) at f32 B=SYM_B, against the
    module's own forward, with its ms a batch; then ``quantize_model``
    (naive calibration, two batches) of the same symbol: its int8 graph
    on the card at B=SYM_B (ms), and at B=QUANT_CHECK_B against the same
    graph on the CPU: each int32 product of the card's graph equal to
    the CPU's op on the same int8 operands (the card's, read by a
    monitor), and the outputs within QUANT_TOL of the largest (each
    layer's float side — dequantize, BatchNorm, requantize — rounds a
    little differently on the two devices, so later layers see a few
    int8 values one step apart, as in phase 21b)."""
    import tempfile

    free_card(torch)
    gpu = mx.gpu(0)
    mod, train_sym = STASH.pop("sym_module")
    arg, aux = mod.get_params()
    gen = torch.Generator().manual_seed(SEED + 28)
    x = torch.rand((SYM_B, 3, SYM_IMAGE, SYM_IMAGE), generator=gen)
    xa = mx.nd.array(x, ctx=gpu)
    mod.forward(mx.io.DataBatch([xa], [mx.nd.zeros((SYM_B,), ctx=gpu)]),
                is_train=False)
    want = mod.get_outputs()[0]._data.clone()
    del mod
    free_card(torch)
    res = {}
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "resnet50_sym")
        mx.model.save_checkpoint(prefix, SYM_STEPS, train_sym, arg, aux)
        sym, larg, laux = mx.model.load_checkpoint(prefix, SYM_STEPS)
        pred = mx.predictor.Predictor(
            prefix + "-symbol.json", f"{prefix}-{SYM_STEPS:04d}.params",
            ctx=gpu, input_names=["data"])
    got = pred.forward(data=xa)[0]._data
    res["replay_vs_module_rel_norm"] = _rel_norm(torch, got, want)
    res["predictor_ms"] = time_ms(torch, lambda: pred.forward(data=xa), 5)
    res["predictor_cache"] = pred.cache_stats()
    del pred
    # the symbol quantizer on the inference symbol (no label head)
    qsrc, names = resnet50_symbol(mx, label=False)
    calib = [mx.nd.array(torch.rand((SYM_B, 3, SYM_IMAGE, SYM_IMAGE), generator=gen),
                         ctx=gpu) for _ in range(2)]
    t0 = time.perf_counter()
    qsym, qarg, qaux = mx.contrib.quantization.quantize_model(
        qsrc, larg, laux, ctx=gpu, calib_mode="naive", calib_data=calib)
    res["quantize_s"] = time.perf_counter() - t0
    res["quantized_nodes"] = sum(
        1 for n in qsym._topo() if n.op in ("quantized_conv",
                                            "quantized_fully_connected"))
    exe = qsym.simple_bind(gpu, data=(SYM_B, 3, SYM_IMAGE, SYM_IMAGE), grad_req="null")
    exe.copy_params_from(qarg, qaux)
    exe.forward(data=xa)
    res["int8_graph_ms"] = time_ms(torch, lambda: exe.forward(), 3)
    del exe
    free_card(torch)
    xc = x[:QUANT_CHECK_B]
    outs, seen = [], {}
    for ctx in (gpu, mx.cpu()):
        e = qsym.simple_bind(ctx, data=tuple(xc.shape), grad_req="null")
        e.copy_params_from(qarg, qaux)
        if ctx is gpu:  # the quantized ops' operands and products
            e.set_monitor_callback(
                lambda n, a: seen.__setitem__(n, a._data.cpu())
                if n.startswith("quantized_") else None, monitor_all=True)
        outs.append(e.forward(data=mx.nd.array(xc, ctx=ctx))[0]._data.cpu())
        del e
    card_out, cpu_out = outs
    from mxnet_tpu_torch.ops import registry

    equal, products = True, 0
    for node in qsym._topo():
        if not node.name.startswith("quantized_") or node.is_var():
            continue
        ins = [mx.nd.array(seen[f"{node.name}_input{i}"], ctx=mx.cpu())
               for i in range(len(node.inputs))]
        attrs = {k: v for k, v in node.attrs.items()
                 if not k.startswith("__")}
        cpu_q = registry.get_op(node.op)(*ins, **attrs)[0]._data
        card_q = seen[f"{node.name}_output0"]
        products += 1
        equal = equal and card_q.dtype == torch.int32 and \
            torch.equal(cpu_q, card_q)
    res["int32_products"] = products
    res["int32_equal"] = equal
    scale = cpu_out.abs().max().item()
    res["card_vs_cpu_max_err_share"] = \
        (card_out - cpu_out).abs().max().item() / scale
    ok = res["replay_vs_module_rel_norm"] <= SYM_TOL and \
        res["predictor_cache"]["signatures"] == 1 and \
        res["quantized_nodes"] == 54 and res["int32_equal"] and \
        res["int32_products"] == 54 and \
        res["card_vs_cpu_max_err_share"] <= QUANT_TOL
    emit(dict(phase="checkpoint_quant", nvidia_smi=_card(),
              net="resnet50_v1 (mx.sym)", B=SYM_B, check_B=QUANT_CHECK_B,
              tol=dict(replay=SYM_TOL, int8=QUANT_TOL), **res, ok=ok))
    if not ok:
        failures.append(f"25d: {res}")
    free_card(torch)


# --- slice 18: the NumPy front end, custom ops, the Estimator, the tools ----

NP_N = 4096                  # 26b: (4096, 4096) f32 for the np table's
NP_WIDE = ("unary", "binary", "compare", "logical", "integer",
           "reduction", "product")   # ... elementwise, reductions, products
NP_N_SORTS = 1024            # 26b: the sorts, statistics, index and shape
#                              families (their CPU side takes seconds a call)
NP_TOL = 1e-4                # 26b: card vs CPU, of the largest |value|
NP_RANDOM_N = 1 << 20        # 26b: draws a distribution on the card
LINALG_N = 1024              # 26b: linalg reconstructions on the card
LINALG_TOL = 1e-3            # ... relative norm, f32


def np_cases(n, seed=0):
    """One call of every name of ``mx.np``'s function table
    (``mxnet_tpu_torch.numpy.FUNCTIONS``): ``(name, family, args,
    kwargs)`` with numpy arrays where the call takes arrays (the caller
    makes them ``mx.np`` arrays on its device), at the width ``n``: (n, n)
    f32 for the elementwise ops, the reductions and ``matmul``, n-long
    vectors for the 1-d ones, small blocks where the output grows faster
    (``kron``: (√n, √n) each)."""
    rng = np.random.RandomState(seed)
    k = max(2, int(round(n ** 0.5)))
    X = rng.uniform(0.5, 2.0, (n, n)).astype(np.float32)
    S = rng.standard_normal((n, n)).astype(np.float32)
    U = rng.uniform(-0.9, 0.9, (n, n)).astype(np.float32)
    V = rng.standard_normal(n).astype(np.float32)
    I = rng.randint(-50, 50, (n, n)).astype(np.int64)
    P = rng.randint(1, 50, (n, n)).astype(np.int64)
    SH = rng.randint(0, 8, (n, n)).astype(np.int64)
    B = rng.rand(n, n) > 0.5
    C = B.copy()
    C[rng.rand(n, n) > 0.5] = False
    K = rng.standard_normal((k, k)).astype(np.float32)
    V3 = rng.standard_normal((n, 3)).astype(np.float32)
    W = rng.standard_normal(9).astype(np.float32)
    SV = np.sort(V)
    Q = rng.standard_normal(n).astype(np.float32)
    ids = rng.randint(0, 1000, n * 4).astype(np.int64)
    take = rng.randint(-n, n, n).astype(np.int64)
    order = np.argsort(S, axis=1, kind="stable")
    x1 = X.copy()
    x1[0, 0] += 1.0
    xp = np.linspace(0.0, 3.0, 101).astype(np.float32)
    fp = np.sin(xp).astype(np.float32)
    nanS = S.copy()
    nanS[::7, 3] = np.nan
    INF = np.where(S > 0, S, np.inf).astype(np.float32)
    u = lambda fam, *names: [(nm, fam, (X,), {}) for nm in names]  # noqa
    cases = u("unary", "sin", "cos", "tan", "arctan", "sinh", "cosh",
              "tanh", "arcsinh", "exp", "expm1", "log", "log2", "log10",
              "log1p", "sqrt", "cbrt", "square", "reciprocal", "degrees",
              "radians", "rint", "floor", "ceil", "trunc", "ravel", "copy",
              "conj", "real", "imag", "angle", "atleast_1d", "atleast_2d",
              "atleast_3d", "negative")
    cases += [("arcsin", "unary", (U,), {}), ("arccos", "unary", (U,), {}),
              ("arctanh", "unary", (U,), {}),
              ("arccosh", "unary", (X + 1,), {}),
              ("absolute", "unary", (S,), {}), ("abs", "unary", (S,), {}),
              ("sign", "unary", (S,), {}),
              ("logical_not", "predicate", (B,), {}),
              ("isnan", "predicate", (nanS,), {}),
              ("isinf", "predicate", (INF,), {}),
              ("isfinite", "predicate", (INF,), {}),
              ("isneginf", "predicate", (-INF,), {}),
              ("isposinf", "predicate", (INF,), {}),
              ("sort", "sort", (S,), {"axis": -1}),
              ("argsort", "sort", (S,), {"axis": -1}),
              ("partition", "sort", (S, 3), {}),
              ("argpartition", "sort", (S, 3), {}),
              ("unique", "sort", (ids,), {"return_index": True,
                                         "return_inverse": True,
                                         "return_counts": True}),
              ("nonzero", "index", (B,), {}),
              ("flatnonzero", "index", (B,), {}),
              ("diag", "shape", (V,), {"k": 1}),
              ("diagonal", "shape", (S,), {"offset": -2})]
    b = lambda fam, x, y, *names: [(nm, fam, (x, y), {})  # noqa: E731
                                   for nm in names]
    cases += b("binary", X, S, "add", "subtract", "multiply", "divide",
               "true_divide", "maximum", "minimum", "fmax", "fmin",
               "arctan2", "hypot", "logaddexp", "logaddexp2", "copysign",
               "nextafter")
    cases += b("binary", S, X, "floor_divide", "mod", "remainder")
    cases += b("binary", X, U, "power", "float_power")
    cases += b("compare", X, x1, "equal", "not_equal", "greater",
               "greater_equal", "less", "less_equal")
    cases += b("logical", B, C, "logical_and", "logical_or", "logical_xor")
    cases += b("integer", I, P, "bitwise_and", "bitwise_or", "bitwise_xor",
               "gcd", "lcm")
    cases += b("integer", I, SH, "left_shift", "right_shift")
    cases += [("invert", "integer", (I,), {}),
              ("heaviside", "binary", (S, X), {}),
              ("ldexp", "binary", (X, SH), {}),
              ("add", "binary", (X, 2.5), {}),
              ("matmul", "product", (S, X), {}),
              ("dot", "product", (S, X), {}),
              ("inner", "product", (S, X), {}),
              ("vdot", "product", (S, X), {}),
              ("outer", "product", (V, Q), {}),
              ("kron", "product", (K, K), {}),
              ("tensordot", "product", (S, X), {"axes": 1}),
              ("einsum", "product", ("ij,jk->ik", S, X), {}),
              ("cross", "product", (V3, V3[::-1].copy()), {}),
              ("convolve", "product", (V, W), {}),
              ("correlate", "product", (V, W), {"mode": "same"}),
              ("searchsorted", "index", (SV, Q), {"side": "right"})]
    r = lambda nm, x, **kw: (nm, "reduction", (x,), kw)  # noqa: E731
    cases += [r("sum", S, axis=1), r("mean", S, axis=0), r("max", S),
              r("min", S, axis=1), r("amax", S, axis=0), r("amin", S),
              r("prod", X[:, :8], axis=1), r("nanprod", X[:, :8], axis=1),
              r("nansum", nanS, axis=1), r("std", S, axis=1, ddof=1),
              r("var", S, axis=0), r("ptp", S, axis=1),
              r("argmax", nanS, axis=0), r("argmin", S, axis=1),
              r("nanargmax", nanS, axis=1), r("nanargmin", nanS, axis=1),
              r("all", B, axis=0), r("any", C, axis=1),
              r("cumsum", S, axis=1), r("cumprod", X[:, :8], axis=1),
              r("nancumsum", nanS, axis=0), r("count_nonzero", B, axis=1),
              r("average", S, axis=1, weights=V), r("trace", S)]
    st = lambda nm, x, *a, **kw: (nm, "statistics", (x,) + a, kw)  # noqa
    cases += [st("median", S, axis=1),
              st("percentile", S, np.array([5.0, 50, 95]), axis=1),
              st("quantile", S, 0.3), st("histogram", X, bins=50),
              st("bincount", ids, minlength=1000),
              st("digitize", X, xp),
              st("interp", X, xp, fp, left=-1.0, right=2.0),
              st("trapz", S, axis=-1), st("gradient", S, axis=1),
              st("diff", S, axis=0, n=2),
              st("ediff1d", V, to_end=np.ones(1, np.float32)),
              st("allclose", X, x1), st("isclose", X, x1),
              st("array_equal", X, x1), st("array_equiv", X, X[:1]),
              st("clip", S, -0.5, 0.5), st("round", S * 100, decimals=1),
              st("around", S * 10)]
    s = lambda nm, x, *a, **kw: (nm, "shape", (x,) + a, kw)  # noqa: E731
    cases += [s("reshape", S, (n // 2, 2 * n)), s("transpose", S),
              s("swapaxes", S, 0, 1), s("moveaxis", S, 0, 1),
              s("rollaxis", S, 1), s("expand_dims", S, (0, 2)),
              s("squeeze", S[None]), s("tile", K, (3, 2)),
              s("repeat", V, 3), s("roll", S, 7, axis=1), s("flip", S),
              s("fliplr", S), s("flipud", S), s("rot90", S),
              s("broadcast_to", V, (4, n)), s("append", V, Q),
              s("pad", K, ((2, 3), (1, 0)), mode="reflect"),
              s("triu", S, 1), s("tril", S, -1), s("resize", V, (3, n)),
              s("insert", V, np.array([1, 5]),
                np.array([9.0, 8.0], np.float32)),
              s("delete", V, np.array([0, 2])),
              s("take", S, take, axis=0),
              s("take_along_axis", S, order, 1),
              s("where", B, S, X), s("unravel_index", ids, (10, 100)),
              ("ravel_multi_index", "index",
               ((ids % 10, ids // 10),), {"dims": (10, 100)}),
              ("concatenate", "shape", ([S, X],), {"axis": 1}),
              ("stack", "shape", ([V, Q],), {}),
              ("vstack", "shape", ([S, X],), {}),
              ("hstack", "shape", ([V, Q],), {}),
              ("dstack", "shape", ([S, X],), {}),
              ("column_stack", "shape", ([V, Q],), {}),
              ("split", "shape", (S, 4), {"axis": 1}),
              ("array_split", "shape", (V, 3), {}),
              ("hsplit", "shape", (S, 2), {}),
              ("vsplit", "shape", (S, 2), {}),
              ("dsplit", "shape", (S[:, :, None].repeat(2, 2), 2), {}),
              ("broadcast_arrays", "shape", (V, S), {}),
              ("meshgrid", "shape", (V[:k], Q[:k]), {})]
    return cases


def np_outputs(out):
    """A call's outputs as a flat list of numpy arrays."""
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in np_outputs(o)]
    if hasattr(out, "asnumpy"):
        return [out.asnumpy()]
    return [np.asarray(out)]


def np_rel_err(got, want):
    """Worst |got − want| over the largest |want| (0 for exact equality,
    NaN where both are NaN)."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    if g.shape != w.shape:
        return float("inf")
    if g.size == 0:
        return 0.0
    both = np.isnan(g) & np.isnan(w)
    if (np.isnan(g) != np.isnan(w)).any():
        return float("inf")
    d = np.where(both, 0.0, np.abs(g - w))
    inf_eq = np.isinf(g) & (g == w)
    d = np.where(inf_eq, 0.0, d)
    scale = np.abs(np.where(both | np.isinf(w), 0.0, w)).max()
    return float(d.max() / max(scale, 1e-30))


EST_B, EST_T = 32, 128        # 26a: Estimator.fit batch (bf16 under amp)
EST_STEPS = 8                 # 26a: StoppingHandler(max_batch=8)
EST_DISTINCT = 64             # 26a: distinct samples, repeated 4 times
EST_VAL_BATCHES = 2
EST_LR = 1e-4                 # 26a: Adam
MON_B = 32                    # 26d: the monitored ResNet-50 forward (bf16)
CONSIST_B = 4                 # 26d: check_consistency of a BERT-base layer
CONSIST_RTOL, CONSIST_ATOL = 1e-3, 1e-4   # f32 card vs CPU


def _np_batchify(mx):
    """A ``DataLoader`` batchify that yields ``mx.np`` arrays in
    page-locked host memory (the Estimator copies them to the card
    without blocking)."""
    def batchify(samples):
        cols = []
        for col in zip(*samples):
            a = mx.np.array(np.stack(col), ctx=mx.cpu())
            a._data = a._data.pin_memory()
            cols.append(a)
        return cols

    return batchify


def estimator_bert_phase(torch, mx, bert, fa, mt, failures):
    """Phase 26a: ``gluon.contrib.estimator.Estimator.fit`` on a
    ``bert_base`` classifier (12 layers, width 768, 12 heads, vocab
    30522, 2 classes) at full width in np mode (``npx.set_np()``, batches
    of ``mx.np`` arrays from a ``DataLoader`` over an ``ArrayDataset``),
    under ``amp.init("bfloat16")``, Adam through ``Trainer`` (the fused
    update kernel), with ``StoppingHandler(max_batch=8)``,
    ``CheckpointHandler``, ``EarlyStoppingHandler`` and
    ``LoggingHandler``: #1 launches 12 × (8 + 2) times (8 training
    forwards, 2 validation batches), #2 and #3 12 × 8, the update 8.
    Then ``evaluate`` against a hand-written loop, the checkpoint's
    reload to a bit-equal forward, the ms a batch of ``fit`` against a
    hand-written step loop on the same net and batch, and a device-trace
    split of one batch of ``fit``.  Returns the launches (forward, dQ,
    dK/dV, update) and the tensor-core ones."""
    import contextlib
    import io
    import tempfile

    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon.contrib import estimator as est

    free_card(torch)
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 26)
    distinct = rng.randint(0, BERT_VOCAB, (EST_DISTINCT, EST_T)) \
        .astype(np.int32)
    labels = (distinct[:, 0] % 2).astype(np.float32)
    reps = EST_STEPS * EST_B // EST_DISTINCT
    train_ids, train_lab = np.tile(distinct, (reps, 1)), \
        np.tile(labels, reps)
    val_ids = rng.randint(0, BERT_VOCAB, (EST_VAL_BATCHES * EST_B, EST_T)) \
        .astype(np.int32)
    val_lab = (val_ids[:, 0] % 2).astype(np.float32)
    data = mx.gluon.data
    mx.npx.set_np()
    amp.init("bfloat16")
    ckpt_dir = tempfile.mkdtemp(prefix="mxt_est_")
    try:
        mx.random.seed(SEED)
        net = bert.BERTClassifier(bert.bert_base(vocab_size=BERT_VOCAB),
                                  num_classes=2)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        batchify = _np_batchify(mx)
        train = data.DataLoader(data.ArrayDataset(train_ids, train_lab),
                                batch_size=EST_B, batchify_fn=batchify)
        val = data.DataLoader(data.ArrayDataset(val_ids, val_lab),
                              batch_size=EST_B, batchify_fn=batchify)
        first = next(iter(train))
        assert type(first[0]).__name__ == "ndarray"
        with mx.autograd.predict_mode():
            net(first[0].as_in_context(mx.gpu(0)))  # the deferred shapes
        torch.cuda.synchronize()
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": EST_LR})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        losses, stamps = [], []

        class Watch(est.BatchEnd):
            def batch_end(self, estimator, *args, **kwargs):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

        def recorded_loss(out, label):
            loss = loss_fn(out, label)
            losses.append(loss.mean())
            return loss

        val_acc = mx.metric.Accuracy()
        e = est.Estimator(net, recorded_loss,
                          train_metrics=[mx.metric.Accuracy()],
                          val_metrics=[val_acc], trainer=trainer)
        handlers = [est.StoppingHandler(max_batch=EST_STEPS),
                    est.CheckpointHandler(ckpt_dir, model_prefix="bert"),
                    est.EarlyStoppingHandler(val_acc, patience=2),
                    est.LoggingHandler(), Watch()]
        log = io.StringIO()
        _zero_counts(fa)  # the main path starts here
        mt.multi_tensor_update.launches = 0
        torch.cuda.synchronize()
        t_fit = time.perf_counter()
        with contextlib.redirect_stdout(log):
            e.fit(train, val_data=val, epochs=1, event_handlers=handlers)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        counts = [c.launches for c in _counters(fa)] + \
            [mt.multi_tensor_update.launches]  # ... and ends here
        mma = _mma_counts(fa)
        values = [float(v.item()) for v in losses]
        layers = len(net.bert.encoder.transformer_cells)
        want = [layers * (EST_STEPS + EST_VAL_BATCHES), layers * EST_STEPS,
                layers * EST_STEPS, EST_STEPS]
        # the same 64 samples come back every 2 batches: the loss of the
        # last pass over them against the first
        falls = np.mean(values[-2:]) < np.mean(values[:2])
        finite = bool(np.isfinite(values).all())
        ev = e.evaluate(val)
        acc = mx.metric.Accuracy()
        for x, y in val:
            x, y = x.as_in_context(mx.gpu(0)), y.as_in_context(mx.gpu(0))
            with mx.autograd.predict_mode():
                acc.update(y, net(x))
        hand_eval = {acc.get()[0]: acc.get()[1]}
        # the checkpoint reloads to a bit-equal forward
        path = os.path.join(ckpt_dir, "bert-0001.params")
        net2 = bert.BERTClassifier(bert.bert_base(vocab_size=BERT_VOCAB),
                                   num_classes=2)
        net2.load_parameters(path, ctx=mx.gpu(0))
        x0 = first[0].as_in_context(mx.gpu(0))
        with mx.autograd.predict_mode():
            o1 = net(x0)._data
            o2 = net2(x0)._data
        bit_equal = bool(torch.equal(o1, o2))
        del net2
        # ms a batch: fit's (between batch ends, the first excluded)
        # against a hand-written record/backward/step loop on the same net
        fit_ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
        y0 = first[1].as_in_context(mx.gpu(0))
        hand_ms = []
        for _ in range(EST_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with mx.autograd.record():
                loss = loss_fn(net(x0), y0)
            loss.backward()
            trainer.step(EST_B)
            torch.cuda.synchronize()
            hand_ms.append((time.perf_counter() - t1) * 1e3)
        del loss
        split = _fit_split(torch, mx, e, train, est)
    finally:
        amp.turn_off()
        mx.npx.reset_np()
    res = dict(phase="estimator_fit", card=STASH["smi"], B=EST_B, T=EST_T,
               layers=layers, batches=EST_STEPS, losses=values,
               launches_fwd_dq_dkv_update=counts, want=want,
               launches_mma=mma, evaluate=ev, hand_evaluate=hand_eval,
               checkpoint_bit_equal=bit_equal, fit_s=fit_s,
               fit_batch_ms=fit_ms, fit_batch_ms_median=float(
                   np.median(fit_ms)), hand_step_ms=hand_ms[1:],
               hand_step_ms_median=float(np.median(hand_ms[1:])),
               fit_over_hand=float(np.median(fit_ms) /
                                   np.median(hand_ms[1:])),
               log_lines=log.getvalue().splitlines()[:4],
               cache_stats=net.cache_stats(), device_split=split,
               seconds=time.perf_counter() - t0)
    res["ok"] = ok = finite and falls and counts == want and \
        ev == hand_eval and bit_equal
    emit(res)
    if not ok:
        failures.append(f"estimator fit: losses {values}, launches "
                        f"{counts} (want {want}), evaluate {ev} vs "
                        f"{hand_eval}, checkpoint bit-equal {bit_equal}")
    del net, e, trainer
    free_card(torch)
    return counts, mma


def _host_ms(torch, fn, iters):
    """Median wall ms of ``fn`` over ``iters`` synchronised calls, after
    one warm-up call."""
    fn()
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return float(np.median(out))


def _fit_split(torch, mx, e, train, est):
    """The device-trace split of one batch of ``Estimator.fit`` (a fit of
    one batch, after the phase's batches warmed it), as phase 24e splits
    its step."""
    import contextlib
    import io

    prof = mx.profiler
    one = [next(iter(train))]
    with contextlib.redirect_stdout(io.StringIO()):
        e.fit(one, epochs=1)  # warm-up
        torch.cuda.synchronize()
        prof.set_config(profile_device_trace=True, aggregate_stats=True)
        prof.set_state("run")
        t0 = time.perf_counter()
        e.fit(one, epochs=1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.set_state("stop")
    split = _device_split(torch, prof.device_profile(), wall)
    if split["kernels"] == 0:
        split["event_ms"] = time_ms(torch, lambda: e.fit(one, epochs=1), 1)
    prof.dumps(reset=True)
    return split


def np_card_phase(torch, mx, failures):
    """Phase 26b: every name of the ``mx.np`` table (``np_cases``: f32
    elementwise ops, reductions and products such as ``matmul`` at
    (NP_N, NP_N) = 4096², the sorts, statistics, index and shape
    families at 1024²) on CUDA tensors against the same call on the
    CPU, each output
    within NP_TOL of the largest |value| (integers and bools exact); the
    count checked and the worst error by family.  Then ``np.random``'s
    moments (and a Kolmogorov–Smirnov test) on the card, and ``linalg``
    reconstructions at (LINALG_N, LINALG_N).  The comparison of each
    output pair (``np_rel_err``'s number) runs on the card
    (``_card_rel_err``): in numpy on the host it took about 0.65 s an
    output at 4096², most of the phase."""
    t0 = time.perf_counter()
    gpu, cpu = mx.gpu(0), mx.cpu()
    names = set(mx.np.FUNCTIONS)
    cache = {}

    def conv(a, ctx):
        if isinstance(a, np.ndarray):
            key = (id(a), ctx)
            if key not in cache:
                cache[key] = (a, mx.np.array(a, ctx=ctx))
            return cache[key][1]
        if isinstance(a, (list, tuple)) and a and \
                isinstance(a[0], np.ndarray):
            return type(a)(conv(x, ctx) for x in a)
        return a

    worst, checked, bad, ms = {}, set(), [], {}
    cases = [c for c in np_cases(NP_N) if c[1] in NP_WIDE] + \
        [c for c in np_cases(NP_N_SORTS) if c[1] not in NP_WIDE]
    for name, fam, args, kw in cases:
        fn = getattr(mx.np, name)
        try:
            g_args = [conv(a, gpu) for a in args]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = np_outputs(fn(*g_args, **kw))
            ms[name] = (time.perf_counter() - t1) * 1e3
            with cpu:
                want = np_outputs(fn(*[conv(a, cpu) for a in args], **kw))
        except Exception as exc:  # noqa: BLE001 (each name is reported)
            bad.append(f"{name}: {type(exc).__name__}: {exc}"[:300])
            continue
        errs = [_card_rel_err(torch, g, w) for g, w in zip(got, want)] \
            if len(got) == len(want) else [float("inf")]
        err = max(errs, default=0.0)
        worst[fam] = max(worst.get(fam, 0.0), err)
        checked.add(name)
        if err > NP_TOL:
            bad.append(f"{name}: {err}")
    cache.clear()
    missing = sorted(names - checked)
    rnd = _np_random_card(mx)
    lin = _linalg_card(torch, mx)
    slowest = sorted(ms.items(), key=lambda kv: -kv[1])[:5]
    ok = not bad and not missing and rnd["ok"] and lin["ok"]
    emit(dict(phase="np_card", card=STASH["smi"], n=NP_N,
              n_sorts=NP_N_SORTS,
              checked=len(checked), table=len(names), missing=missing,
              worst_by_family=worst, failed=bad[:10],
              slowest_card_ms=slowest, random=rnd, linalg=lin,
              seconds=time.perf_counter() - t0, ok=ok))
    if not ok:
        failures.append(f"np on the card: {bad[:5]}, missing {missing}, "
                        f"random {rnd['ok']}, linalg {lin['ok']}")
    free_card(torch)


def _card_rel_err(torch, got, want):
    """``np_rel_err``'s number, computed on the card in float64: worst
    |got − want| over the largest |want| (0 for exact equality, NaN where
    both are NaN, a complex output's real part, as numpy's float64 cast
    takes it)."""
    g, w = np.asarray(got), np.asarray(want)
    if g.shape != w.shape:
        return float("inf")
    if g.size == 0:
        return 0.0

    def card(a):
        if a.dtype.kind == "c":
            a = a.real
        if a.dtype.kind == "u" and a.dtype.itemsize > 1:
            a = a.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(a)).cuda().double()

    g, w = card(g), card(w)
    gn, wn = torch.isnan(g), torch.isnan(w)
    if bool((gn != wn).any()):
        return float("inf")
    both = gn & wn
    d = torch.where(both, 0.0, (g - w).abs())
    d = torch.where(torch.isinf(g) & (g == w), 0.0, d)
    scale = torch.where(both | torch.isinf(w), 0.0, w).abs().max()
    return float(d.max() / scale.clamp_min(1e-30))


def _np_random_card(mx):
    """Moments of ``np.random``'s distributions drawn on the card, within
    6 standard errors, and a KS test (p > 1e-4) where scipy is here."""
    try:
        import scipy.stats as st
    except ImportError:  # the moments still hold the draws
        st = None
    n = NP_RANDOM_N
    mx.np.random.seed(SEED + 262)
    gpu = mx.gpu(0)
    cases = {"uniform": ((-1.0, 3.0), (1.0, 16 / 12),
                         ("uniform", (-1.0, 4.0))),
             "normal": ((0.5, 2.0), (0.5, 4.0), ("norm", (0.5, 2.0))),
             "gamma": ((2.5, 1.5), (3.75, 5.625),
                       ("gamma", (2.5, 0, 1.5))),
             "beta": ((2.0, 5.0), (2 / 7, 10 / 392),
                      ("beta", (2.0, 5.0))),
             "exponential": ((2.0,), (2.0, 4.0), ("expon", (0, 2.0))),
             "chisquare": ((3.0,), (3.0, 6.0), ("chi2", (3.0,)))}
    out, ok = {}, True
    for name, (args, (mean, var), (dist, params)) in cases.items():
        x = getattr(mx.np.random, name)(*args, size=(n,), ctx=gpu) \
            .asnumpy().astype(np.float64)
        dm = abs(x.mean() - mean) / np.sqrt(var / n)
        dv = abs(x.var() - var) / var
        p = float(st.kstest(x, getattr(st, dist)(*params).cdf).pvalue) \
            if st else None
        good = dm < 6 and dv < 0.02 and (p is None or p > 1e-4)
        ok &= good
        out[name] = dict(mean_se=float(dm), var_rel=float(dv), ks_p=p,
                         ok=good)
    c = mx.np.random.choice(4, size=(n,), p=[0.1, 0.2, 0.3, 0.4],
                            ctx=gpu).asnumpy()
    freq = np.bincount(c, minlength=4) / n
    out["choice"] = freq.tolist()
    ok &= bool(np.abs(freq - [0.1, 0.2, 0.3, 0.4]).max() < 0.005)
    return dict(draws=n, dists=out, ok=bool(ok))


def _linalg_card(torch, mx):
    """``np.linalg`` at (LINALG_N, LINALG_N) f32 on the card: each
    result's reconstruction (relative norm within LINALG_TOL), the
    inverses and solves on a symmetric positive definite matrix, the
    factorizations on a Gaussian one."""
    rng = np.random.RandomState(SEED + 263)
    n = LINALG_N
    a = rng.standard_normal((n, n)).astype(np.float32)
    spd = (a @ a.T / n + np.eye(n)).astype(np.float32)
    b = rng.standard_normal((n, 4)).astype(np.float32)
    la = mx.np.linalg
    A, S, B = (mx.np.array(x, ctx=mx.gpu(0)) for x in (a, spd, b))

    def rel(x, y):
        x, y = (t._data if hasattr(t, "_data") else t for t in (x, y))
        return float(torch.linalg.norm((x - y).to(torch.complex128)) /
                     torch.linalg.norm(y.to(torch.complex128)))

    eye = mx.np.eye(n, ctx=mx.gpu(0))
    errs = {}
    # the inverses and solves on the well-conditioned S (a Gaussian A of
    # this size is near-singular at f32's tolerance); the factorizations
    # on A
    errs["inv"] = rel(mx.np.matmul(S, la.inv(S)), eye)
    errs["solve"] = rel(mx.np.matmul(S, la.solve(S, B)), B)
    u, s, vh = la.svd(A, full_matrices=False)
    errs["svd"] = rel(mx.np.matmul(u * s, vh), A)
    w, v = la.eigh(S)
    errs["eigh"] = rel(mx.np.matmul(S, v), v * w)
    q, r = la.qr(A)
    errs["qr"] = rel(mx.np.matmul(q, r), A)
    l_ = la.cholesky(S)
    errs["cholesky"] = rel(mx.np.matmul(l_, mx.np.transpose(l_)), S)
    we, ve = la.eig(A)
    Ac = A._data.to(torch.complex64)
    errs["eig"] = rel(Ac @ ve._data, ve._data * we._data)
    errs["pinv"] = rel(mx.np.matmul(S, la.pinv(S)), eye)
    x, _, rank, _ = la.lstsq(S, B)
    errs["lstsq"] = rel(mx.np.matmul(S, x), B)
    sign, logdet = la.slogdet(S)
    errs["slogdet_vs_cpu"] = abs(float(logdet.item()) - float(
        np.linalg.slogdet(spd.astype(np.float64))[1])) / abs(float(
            logdet.item()))
    worst = max(errs.values())
    return dict(n=n, rel_norm=errs, worst=worst, rank=int(rank.item()),
                ok=worst <= LINALG_TOL and int(rank.item()) == n)


def custom_rtc_phase(torch, mx, failures):
    """Phase 26c: ``nd.Custom`` on the card (a sigmoid whose forward and
    backward go through the host, ``asnumpy`` and ``nd.array``), eager
    and under ``record()``, against torch's sigmoid; the same op inside
    a hybridized block on two different inputs: each output follows its
    own input and the block runs eagerly (``cache_stats()["eager"]``,
    no graph); a capture that reaches it raises naming the op; and
    ``rtc.PallasKernel`` wrapping a torch callable, value and gradient
    against plain torch."""
    from mxnet_tpu_torch import cuda_graph

    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0],
                        mx.nd.array(1.0 / (1.0 + np.exp(-x))))

        def backward(self, req, out_grad, in_data, out_data, in_grad,
                     aux):
            y = out_data[0].asnumpy()
            self.assign(in_grad[0], req[0], mx.nd.array(
                out_grad[0].asnumpy() * y * (1 - y)))

    @mx.operator.register("chip_sigmoid")
    class SigmoidProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 264)
    x = torch.randn((256, 512), generator=gen, device="cuda")
    xa = mx.nd.array(x)
    eager = mx.nd.Custom(xa, op_type="chip_sigmoid")
    res = {"eager_err": float((eager._data - torch.sigmoid(x)).abs().max()),
           "on_card": eager._data.is_cuda}
    xa.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(xa, op_type="chip_sigmoid")
        (y * y).sum().backward()
    s = torch.sigmoid(x)
    res["grad_err"] = float((xa.grad._data.detach() - 2 * s * s * (1 - s))
                            .abs().max())

    class Block(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, a):
            return F.Custom(a * 2, op_type="chip_sigmoid") + 1

    blk = Block()
    blk.hybridize(static_alloc=True)
    x2 = torch.randn((256, 512), generator=gen, device="cuda")
    o1 = blk(mx.nd.array(x))._data.clone()
    o2 = blk(mx.nd.array(x2))._data.clone()
    res["hybrid_errs"] = [float((o - torch.sigmoid(2 * v) - 1).abs().max())
                          for o, v in ((o1, x), (o2, x2))]
    res["hybrid_cache_stats"] = blk.cache_stats()
    try:
        cuda_graph.capture(lambda: mx.nd.Custom(
            mx.nd.array(x), op_type="chip_sigmoid")._data)
        res["capture"] = "captured"
    except mx.MXNetError as exc:
        res["capture"] = str(exc)[:120]
    torch.cuda.synchronize()

    k = mx.rtc.PallasKernel(lambda a, b: torch.tanh(a) * b, name="tanh_mul")
    a = mx.nd.array(x)
    b = mx.nd.array(x2)
    a.attach_grad()
    with mx.autograd.record():
        out = k(a, b)
        (out * out).sum().backward()
    t = torch.tanh(x)
    res["pallas_kernel_err"] = float((out._data - t * x2).abs().max())
    res["pallas_kernel_grad_err"] = float(
        (a.grad._data - 2 * t * x2 * x2 * (1 - t * t)).abs().max())
    errs = [res["eager_err"], res["grad_err"], *res["hybrid_errs"],
            res["pallas_kernel_err"], res["pallas_kernel_grad_err"]]
    stats = res["hybrid_cache_stats"]
    res["ok"] = ok = res["on_card"] and max(errs) < 1e-5 and \
        stats.get("eager") == 2 and stats["signatures"] == 1 and \
        "chip_sigmoid" in res["capture"]
    emit(dict(phase="custom_rtc", card=STASH["smi"], **res))
    if not ok:
        failures.append(f"custom/rtc on the card: {res}")


def tools_phase(torch, mx, vision, bert, cbr, failures):
    """Phase 26d: ``Monitor`` on an eager ResNet-50 v1 bf16 B=32
    evaluation forward (its stats collected, #4 still launching 16
    times: observers leave the fused runs fused), its ms against the
    unmonitored forward's; ``runtime.Features()``
    (CUDA true, TPU false); ``test_utils.check_consistency([mx.cpu(),
    mx.gpu(0)])`` on a BERT-base encoder layer (f32, flash on the card,
    its plain version on the CPU); ``visualization.print_summary`` of
    phase 25a's ResNet-50 symbol (its text in ``chiprun_out/``).
    Returns #4's launches (and its tensor-core ones) in the monitored
    forward."""
    import contextlib
    import io

    from mxnet_tpu_torch.convert import load_numpy_params

    free_card(torch)
    res = {}
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.cast("bfloat16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 265)
    x = mx.nd.array(torch.rand((MON_B, 3, 224, 224), generator=gen,
                               device="cuda").bfloat16())
    def forward():
        with mx.autograd.predict_mode():
            return net(x)._data

    plain = forward().clone()
    plain_ms = _host_ms(torch, forward, 3)
    mon = mx.monitor.Monitor(1, sort=True)
    mon.install(net)

    def monitored():
        mon.tic()
        forward()
        return mon.toc()

    monitored_ms = _host_ms(torch, monitored, 3)
    fused = cbr.fused_matmul_affine_relu
    fused.launches = fused.launches_mma = 0  # the monitored forward
    mon.tic()
    with mx.autograd.predict_mode():
        out = net(x)._data
    rows = mon.toc()
    launches, mma = fused.launches, fused.launches_mma  # ... ends here
    mon.uninstall()
    stats = [float(r[2]) for r in rows]
    res["monitor"] = dict(rows=len(rows), launches=launches,
                          launches_mma=mma, first=rows[:2],
                          plain_forward_ms=plain_ms,
                          monitored_forward_ms=monitored_ms,
                          finite=bool(np.isfinite(stats).all()),
                          output_equal=bool(torch.equal(out, plain)))
    del net, x, out, plain
    free_card(torch)
    feats = mx.runtime.Features()
    res["features"] = {k: feats.is_enabled(k) for k in
                       ("CUDA", "CUDNN", "NCCL", "TPU", "PALLAS",
                        "NATIVE_ENGINE")}
    # check_consistency on a BERT-base encoder layer, CPU then card
    cells = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        cell = bert.BERTEncoderCell(768, 3072, 12, dropout=0.0,
                                    prefix="cell_")
        cells[ctx] = cell
    xs = np.random.RandomState(SEED + 266).standard_normal(
        (CONSIST_B, BERT_T, 768)).astype(np.float32)
    host = cells[mx.cpu()]
    mx.random.seed(SEED)
    host.initialize(mx.init.Xavier(), ctx=mx.cpu())
    host(mx.nd.array(xs, ctx=mx.cpu()))
    load_numpy_params(cells[mx.gpu(0)], {
        k: p.data().asnumpy()
        for k, p in host._collect_params_with_prefix().items()},
        ctx=mx.gpu(0))
    worst = []
    mx.test_utils.check_consistency(
        lambda a: cells[a.context](a), [xs], [mx.cpu(), mx.gpu(0)],
        rtol=CONSIST_RTOL, atol=CONSIST_ATOL, collect=worst.append)
    res["consistency_max_rel_err"] = worst[0]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        total = mx.visualization.print_summary(
            resnet50_symbol(mx)[0], shape={"data": (1, 3, 224, 224),
                                        "softmax_label": (1,)})
    text = buf.getvalue()
    if os.path.isdir("chiprun_out"):
        with open("chiprun_out/print_summary_resnet50.txt", "w") as f:
            f.write(text)
    res["print_summary"] = dict(total_params=total,
                                lines=len(text.splitlines()))
    want_feats = {"CUDA": True, "TPU": False, "PALLAS": False}
    ok = launches == 16 and res["monitor"]["rows"] > 100 and \
        res["monitor"]["finite"] and res["monitor"]["output_equal"] and \
        all(res["features"][k] == v for k, v in want_feats.items()) and \
        25_000_000 < total < 26_000_000
    emit(dict(phase="tools", card=STASH["smi"], ok=ok, **res))
    if not ok:
        failures.append(f"tools on the card: {res}")
    free_card(torch)
    return launches, mma


# --- slice 19: training telemetry ------------------------------------------

TEL_LAYERS = 8               # 27a: llama3_8b widths, bf16; at phase 9's 16
#                              the numerics-on FusedTrainStep capture (its
#                              graph's gradients and the weights' copy for
#                              update. stats) ran out of the 80 GB
TEL_T = 2048                 # ... B=1, T=2048
TEL_STRIDE = 2               # 27a: numerics harvested every 2nd step
TEL_FUSED_K = 2              # 27a: FusedTrainStep steps a call
TEL_GRAD_NORM_RTOL = 1e-3    # 27a: grad_norm vs a separate vector_norm
TEL_FLOPS_RTOL = 0.05        # 27a: model_flops vs 6·params·tokens + attn
MON_GRAPH_B = 32             # 27b: the monitored ResNet-50 (bf16)
MON_GRAPH_REPLAYS = 3        # 27b: timed replays of each mode
MON_STAT_RTOL = 2.0 ** -8    # 27b: graph vs eager monitor l2 (f32 of bf16)
MEM_STEPS = 10               # 27c: ResNet-50 training steps under memwatch
MEM_B = 32                   # ... bf16 batch
TIMELINE_B, TIMELINE_T = 8, 128   # 27d: the profiled BERT-base step
#: the keys of the reference's step record (``mxnet_tpu/telemetry/
#: __init__.py::step_end`` with ``examples``, memwatch and costs on);
#: tests/test_torch_telemetry.py holds the port's keys to the reference's
#: on the CPU.  REF_STEP_KEYS_IF: the keys it adds when they apply (a
#: harvested step; a mesh or a placement reported by ``parallel``)
REF_STEP_KEYS = frozenset((
    "step", "wall_time", "step_ms", "phases_ms", "counters", "gauges",
    "host_sync", "cachedop_cache_hit", "cachedop_cache_miss", "bulk_flush",
    "bulk_async_wait_ms", "data_wait_ms", "ckpt_saves", "ckpt_bytes",
    "ckpt_async_overlap_ms", "compile_count", "allreduce_bytes",
    "examples", "examples_per_sec", "live_bytes", "peak_live_bytes",
    "live_bytes_by_device", "model_flops", "bytes_accessed", "mfu"))
REF_STEP_KEYS_IF = frozenset(("numerics", "mesh_shape", "sharded_params",
                              "replicated_params"))


def _out_path(name):
    """A file in ``chiprun_out/`` (listed in .gitignore) when it exists,
    else in a temporary directory."""
    import tempfile

    root = "chiprun_out" if os.path.isdir("chiprun_out") else \
        tempfile.mkdtemp(prefix="mxt_tel_")
    return os.path.join(root, name)


def llama_step_flops(cfg, params, t, layers):
    """6·(matrix-product parameters)·tokens + the flash kernels' formula
    flops (forward 4·D, dQ 6·D, dK/dV 8·D a visible pair, causal as
    half): the training step's work as the cost registry counts it.  The
    embedding table's gather has no products; an untied head's matrix
    does."""
    from mxnet_tpu_torch.ops.flash_attention import visible_pairs

    matmul = sum(p.data().size for p in params.values()
                 if len(p.shape) == 2)
    if not cfg.tie_embeddings:
        matmul -= cfg.vocab_size * cfg.hidden_size
    d = cfg.hidden_size // cfg.num_heads
    attn = 18.0 * d * visible_pairs(t, t, True) * cfg.num_heads * layers
    return 6.0 * matmul * t + attn


def telemetry_llama_phase(torch, mx, llama, fa, mt, failures):
    """Phase 27a: ``llama3_8b`` widths at TEL_LAYERS layers, bf16, B=1,
    T=2048, SGD with momentum, hybridized, under ``telemetry.enable(
    jsonl_path=..., numerics=True, retrace="raise")`` with numerics at
    stride 2: two eager ``Trainer`` steps and two ``FusedTrainStep``
    calls (K=2) with numerics off, four eager steps with it on, one
    profiled step, two fused calls with it on, and one forward with a NaN
    in decoder layer 1.  Each step window ends with the loss's
    ``wait_to_read`` (a host sync, the same in every step), so
    ``step_ms`` holds the card's work.  Checks: every record has the
    reference's keys; the harvested records list ``embed``,
    ``decoder.0…L-1``, ``norm``, ``logits`` and every ``grad.``/
    ``update.`` path; ``grad_norm`` against a separate vector norm of the
    gradients; off-stride steps make no ``_materialize`` call and no more
    syncs than a numerics-off step (``torch.cuda.set_sync_debug_mode``'s
    implicit-sync warnings and explicit ``torch.cuda.synchronize``
    calls); no retrace after warmup, and a changed shape raises
    ``RetraceError`` naming the aval; the NaN is ``first_nan`` =
    ``decoder.1``; ``mfu`` in (0, 1] and ``model_flops`` within 5% of
    ``llama_step_flops``; #1, #2, #3 and the update kernel at their
    counts.  Returns the launches (#1, #2, #3, the tensor-core ones,
    the update)."""
    import warnings

    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import numerics, retrace

    free_card(torch)
    t0 = time.perf_counter()
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=TEL_LAYERS)
    net.cast("bfloat16")
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    net.hybridize()
    cfg = net.config
    params = net.collect_params()
    trainer = mx.gluon.Trainer(params, "sgd",
                               {"learning_rate": TRAIN_LR, "momentum": 0.9})
    ids, labels = _ids_labels(torch, mx, cfg.vocab_size, TEL_T, SEED + 27)
    vocab = cfg.vocab_size

    def lm_loss(n, a, b):
        return mx.nd.softmax_cross_entropy(
            n(a).reshape((-1, vocab)), b.reshape((-1,))) / b.size

    jsonl = _out_path("telemetry_27a.jsonl")
    counts = {"sync": 0, "materialize": 0}
    real_sync, real_mat = torch.cuda.synchronize, numerics._materialize

    def counting_sync(*a, **k):
        counts["sync"] += 1
        return real_sync(*a, **k)

    def counting_mat(entries):
        counts["materialize"] += 1
        return real_mat(entries)

    rows = []

    def window(label, run):
        """One telemetry step of ``run()`` (which returns an NDArray it
        waits for): the record, its wall ms, explicit and implicit syncs,
        ``_materialize`` calls and the peak of allocated memory."""
        real_sync()
        torch.cuda.reset_peak_memory_stats()
        s0, m0 = counts["sync"], counts["materialize"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t = time.perf_counter()
                with telemetry.step(examples=TEL_T) as scope:
                    run().wait_to_read()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        ms = (time.perf_counter() - t) * 1e3
        implicit = sum("synchroniz" in str(w.message) for w in caught)
        rec = scope.record
        row = dict(label=label, step=rec["step"], ms=ms,
                   step_ms=rec["step_ms"],
                   harvested="numerics" in rec,
                   explicit_syncs=counts["sync"] - s0,
                   implicit_syncs=implicit,
                   materialize=counts["materialize"] - m0,
                   peak=torch.cuda.max_memory_allocated(),
                   model_flops=rec.get("model_flops"), mfu=rec.get("mfu"),
                   host_sync=rec["host_sync"])
        rows.append(row)
        return rec, row

    def eager():
        loss = _lm_forward(mx, net, ids, labels)
        loss.backward()
        trainer.step(1)
        return loss

    fused_calls = 0

    def fused(step):
        nonlocal fused_calls
        fused_calls += 1
        return lambda: step(ids, labels)

    torch.cuda.synchronize = counting_sync
    numerics._materialize = counting_mat
    _zero_counts(fa)  # the main path starts here
    mt.multi_tensor_update.launches = 0
    forwards = backwards = updates = 0
    try:
        telemetry.enable(jsonl_path=jsonl, numerics=True, retrace="raise")
        numerics.enable(stride=TEL_STRIDE)
        numerics.disable()
        for i in range(2):  # numerics off: the first is the warm-up
            window("eager_off", eager)
        fstep = mx.gluon.FusedTrainStep(net, trainer, lm_loss,
                                        steps_per_execution=TEL_FUSED_K,
                                        batch_size=1)
        for i in range(2):
            window("fused_off", fused(fstep))
        del fstep
        free_card(torch)
        numerics.enable(stride=TEL_STRIDE)
        for i in range(4):
            rec_g, _ = window("eager_on", eager)
            if i == 0:
                retrace.warm()  # the numerics-on signatures are in
        # the last one was harvested: its grad_norm against the gradients
        # the parameters still hold
        grad_norm = rec_g["numerics"]["grad_norm"]
        grad_ref = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad()._data.float())
             for p in params.values() if p.grad_req != "null"])))
        # one more step under the device trace
        prof = mx.profiler
        prof.set_config(filename=_out_path("telemetry_27a_profile.json"),
                        profile_device_trace=True, aggregate_stats=True)
        prof.set_state("run")
        rec_p, row_p = window("eager_on_profiled", eager)
        prof.set_state("stop")
        split = _device_split(torch, prof.device_profile(), row_p["ms"])
        fstep = mx.gluon.FusedTrainStep(net, trainer, lm_loss,
                                        steps_per_execution=TEL_FUSED_K,
                                        batch_size=1)
        fused_recs = []
        for i in range(2):
            fused_recs.append(window("fused_on", fused(fstep))[0])
        del fstep
        forwards = 2 + 4 + 1 + fused_calls * TEL_FUSED_K
        backwards = forwards
        updates = forwards
        violations = retrace.violations()
        # an injected shape change raises before anything runs
        short = mx.nd.array(ids._data[:, :TEL_T // 2])
        try:
            with mx.autograd.record():
                net(short)
            retrace_error = None
        except retrace.RetraceError as exc:
            retrace_error = str(exc)
        retrace.disable()
        retrace.reset()
        # trap 4: NaN into decoder layer 1's first weight, one eager
        # forward at a harvested step
        victim = next(iter(net.model.layers[1].collect_params().values()))
        with torch.no_grad():
            victim.data()._data.view(-1)[0] = float("nan")
        while (telemetry._step_idx + 1) % TEL_STRIDE:
            with telemetry.step(examples=0):
                pass
        net.hybridize(False)
        rec_nan, _ = window("nan_forward", lambda: net(ids))
        forwards += 1
    finally:
        torch.cuda.synchronize = real_sync
        numerics._materialize = real_mat
        telemetry.disable()
        numerics.clear()
        retrace.disable()
        retrace.reset()
    launches = [c.launches for c in _counters(fa)]  # the main path ends
    mma = _mma_counts(fa)
    update_launches = mt.multi_tensor_update.launches
    records = telemetry.read_jsonl(jsonl)
    steps = [r for r in records if r.get("record") is None]
    bad_keys = [sorted(set(r) - REF_STEP_KEYS_IF ^ REF_STEP_KEYS)
                for r in steps if set(r) - REF_STEP_KEYS_IF != REF_STEP_KEYS]
    harvested = [r for r in steps if "numerics" in r]
    live = [p for p in params.values() if p.grad_req != "null"]
    want_paths = {"embed", "norm", "logits"} | {
        f"decoder.{i}" for i in range(TEL_LAYERS)} | {
        f"{k}.{p.name}" for p in live for k in ("grad", "update")}
    on = [r for r in harvested if r["step"] in
          {row["step"] for row in rows if row["label"] in
           ("eager_on", "fused_on")}]
    paths_ok = bool(on) and all(set(r["numerics"]["tensors"]) == want_paths
                                and list(r["numerics"]["tensors"])[:3] ==
                                ["embed", "decoder.0", "decoder.1"]
                                for r in on)
    grad_rel = abs(grad_norm - grad_ref) / grad_ref
    off_rows = [row for row in rows if row["label"] == "eager_off"][1:]
    offstride = [row for row in rows if row["label"] in ("eager_on",)
                 and not row["harvested"]]
    base_syncs = (off_rows[0]["explicit_syncs"], off_rows[0]["implicit_syncs"])
    syncs_ok = all(row["materialize"] == 0 and
                   (row["explicit_syncs"], row["implicit_syncs"]) ==
                   base_syncs for row in offstride) and all(
        row["materialize"] == 1 for row in rows
        if row["harvested"] and row["label"] != "nan_forward")
    step_flops = llama_step_flops(cfg, params, TEL_T, TEL_LAYERS)
    steady = [r for r in steps if r["step"] in
              {row["step"] for row in rows[1:]
               if row["label"] in ("eager_off", "eager_on")}] + \
        fused_recs[1:]
    flops_err = [abs(r["model_flops"] / (step_flops * (
        TEL_FUSED_K if r in fused_recs else 1)) - 1.0) for r in steady]
    mfu_ok = all(r["mfu"] is not None and 0.0 < r["mfu"] <= 1.0
                 for r in steady)
    first_nan = rec_nan.get("numerics", {}).get("first_nan")
    want_launches = [TEL_LAYERS * forwards, TEL_LAYERS * backwards,
                     TEL_LAYERS * backwards]
    res = dict(
        layers=TEL_LAYERS, t=TEL_T, stride=TEL_STRIDE, k=TEL_FUSED_K,
        records=len(steps), bad_keys=bad_keys[:3], harvested=len(harvested),
        paths_ok=paths_ok, grad_norm=grad_norm,
        grad_vector_norm=grad_ref, grad_norm_rel_err=grad_rel,
        syncs_numerics_off=base_syncs, syncs_ok=syncs_ok,
        violations=violations, retrace_error=(retrace_error or "")[:300],
        first_nan=first_nan, step_flops=step_flops,
        flops_rel_err=max(flops_err), mfu_ok=mfu_ok,
        mfu=[r["mfu"] for r in steady], launches=launches,
        launches_mma=mma, update_launches=update_launches,
        want_launches=want_launches + [updates], windows=rows,
        profile_split=split,
        seconds=time.perf_counter() - t0)
    ok = not bad_keys and paths_ok and syncs_ok and violations == [] and \
        grad_rel <= TEL_GRAD_NORM_RTOL and \
        retrace_error is not None and "args[0].shape" in retrace_error and \
        first_nan is not None and first_nan["path"] == "decoder.1" and \
        first_nan["layer"] == 1 and max(flops_err) <= TEL_FLOPS_RTOL and \
        mfu_ok and launches == want_launches and \
        update_launches == updates and min(mma) > 0
    emit(dict(phase="telemetry_llama", card=STASH["smi"], ok=ok, **res))
    if not ok:
        failures.append(f"27a telemetry on the Llama step: {res}")
    del net, trainer, params
    free_card(torch)
    return launches, mma, update_launches


def monitor_graph_phase(torch, mx, vision, cbr, failures):
    """Phase 27b: ``Monitor`` on a hybridized ResNet-50 v1, bf16, B=32,
    predict mode: the taps are outputs of the CUDA graph, every replay
    launches #4 16 times, and each ``monitor.<name>`` row matches an
    eager monitor's f32 l2 norm of the same child's output within
    MON_STAT_RTOL; the monitored replay's ms beside the plain replay's.
    Returns #4's launches (and its tensor-core ones) in the monitored
    replays."""
    from mxnet_tpu_torch.telemetry import numerics

    free_card(torch)
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.cast("bfloat16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 271)
    x = mx.nd.array(torch.rand((MON_GRAPH_B, 3, 224, 224), generator=gen,
                               device="cuda").bfloat16())

    def forward():
        with mx.autograd.predict_mode():
            return net(x)._data

    eager = mx.monitor.Monitor(
        1, stat_func=lambda a: mx.nd.norm(a.astype("float32")), sort=True)
    eager.install(net)
    eager.tic()
    plain = forward().clone()
    want = eager.toc()
    eager.uninstall()
    net.hybridize()
    plain_ms = _host_ms(torch, forward, MON_GRAPH_REPLAYS)
    fused = cbr.fused_matmul_affine_relu
    try:
        mon = mx.monitor.Monitor(1, sort=True).install(net)

        def monitored():
            mon.tic()
            out = forward()
            return out, mon.toc()

        monitored()  # the capture with the taps inside
        fused.launches = fused.launches_mma = 0  # the monitored replays
        rows_all, equal = [], True
        torch.cuda.synchronize()
        times = []
        for _ in range(MON_GRAPH_REPLAYS):
            t = time.perf_counter()
            out, rows = monitored()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            rows_all.append(rows)
            equal &= bool(torch.equal(out, plain))
        launches, mma = fused.launches, fused.launches_mma  # ... end
        mon.uninstall()
    finally:
        numerics.clear()
    # a name that several children share is one numerics path, holding
    # the last of them in forward order (the reference's dict semantics)
    last = {}
    for r in want:
        last[r[1]] = float(r[2])
    names_ok = all([r[1] for r in rows] == sorted(last)
                   for rows in rows_all)
    worst = max(abs(float(g[2]) / last[g[1]] - 1.0)
                for rows in rows_all for g in rows if g[1] in last)
    res = dict(b=MON_GRAPH_B, rows=len(want), paths=len(last),
               names_ok=names_ok,
               worst_rel=worst, launches=launches, launches_mma=mma,
               per_forward=launches / MON_GRAPH_REPLAYS,
               plain_replay_ms=plain_ms,
               monitored_replay_ms=float(np.median(times)),
               output_equal=equal)
    ok = names_ok and worst <= MON_STAT_RTOL and equal and \
        launches == 16 * MON_GRAPH_REPLAYS and len(last) > 100
    emit(dict(phase="monitor_graph", card=STASH["smi"], ok=ok, **res))
    if not ok:
        failures.append(f"27b Monitor on the hybridized ResNet-50: {res}")
    del net, x, plain
    free_card(torch)
    return launches, mma


def memwatch_phase(torch, mx, vision, failures):
    """Phase 27c: memwatch over MEM_STEPS ResNet-50 v1 bf16 B=32 training
    steps (SGD, momentum 0.9): the ledger's ``live_bytes`` the same after
    every step from the second on (no leak), printed beside the caching
    allocator's ``memory_allocated`` and its per-step
    ``peak_live_bytes`` beside ``max_memory_allocated`` (the gap is
    autograd's saved activations and temporaries, which no NDArray
    binds); then an allocation beyond the card's memory inside an
    ``apply_op`` raises ``OOMError`` naming the largest live buffer, and
    a shape error passes through unchanged."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops.registry import apply_op
    from mxnet_tpu_torch.telemetry import memwatch

    free_card(torch)
    telemetry.enable(cost=False)
    memwatch.enable(report_path=_out_path("memwatch_oom_27c.json"))
    try:
        mx.random.seed(SEED)
        net = vision.resnet50_v1(classes=1000)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net.cast("bfloat16")
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.01, "momentum": 0.9})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 272)
        x = mx.nd.array(torch.rand((MEM_B, 3, 224, 224), generator=gen,
                                   device="cuda").bfloat16())
        y = mx.nd.array(torch.randint(0, 1000, (MEM_B,), generator=gen,
                                      device="cuda").float())
        steps = []
        for _ in range(MEM_STEPS):
            torch.cuda.reset_peak_memory_stats()
            with telemetry.step() as scope:
                with mx.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                trainer.step(MEM_B)
                loss.wait_to_read()
            del loss
            rec = scope.record
            steps.append(dict(live_bytes=memwatch.live_bytes(),
                              ledger_size=memwatch.ledger_size(),
                              peak_live_bytes=rec["peak_live_bytes"],
                              memory_allocated=torch.cuda.memory_allocated(),
                              max_memory_allocated=
                              torch.cuda.max_memory_allocated()))
        steady = {s["live_bytes"] for s in steps[1:]}
        top = memwatch.snapshot()[0]
        total = torch.cuda.get_device_properties(0).total_memory
        try:
            apply_op(lambda a: torch.empty(2 * total, dtype=torch.uint8,
                                           device=a.device), x, name="huge")
            oom = None
        except memwatch.OOMError as exc:
            oom = str(exc)
        try:
            apply_op(lambda a: a @ a[..., :3, :], x, name="bad_shapes")
            other = None
        except memwatch.OOMError:
            other = "OOMError"
        except RuntimeError as exc:
            other = type(exc).__name__
    finally:
        telemetry.disable()
    named = oom is not None and str(top["shape"]) in oom and \
        (top["owner"] is None or top["owner"] in oom)
    res = dict(b=MEM_B, steps=steps, steady_live_bytes=sorted(steady),
               largest=top, oom_message=(oom or "")[:400],
               non_oom_error=other)
    ok = len(steady) == 1 and named and other == "RuntimeError"
    emit(dict(phase="memwatch", card=STASH["smi"], ok=ok, **res))
    if not ok:
        failures.append(f"27c memwatch: {res}")
    del net, trainer, x, y
    free_card(torch)


def timeline_phase(torch, mx, bert, failures):
    """Phase 27d: one profiled BERT-base training step (f32, B=8, T=128,
    Adam, hybridized, after a warm-up step) with telemetry on:
    ``profiler.dump()`` writes one chrome trace that holds the
    ``trainer.step``/``trainer.allreduce``/``trainer.update`` spans
    (category ``telemetry``) and the op events (``operator``), on one
    clock, the ops of the update inside its span."""
    from mxnet_tpu_torch import telemetry

    free_card(torch)
    mx.random.seed(SEED)
    b, t = TIMELINE_B, TIMELINE_T
    net = bert.bert_base(vocab_size=BERT_VOCAB)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.hybridize()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 273)
    ids = mx.nd.array(torch.randint(0, BERT_VOCAB, (b, t), generator=gen,
                                    device="cuda", dtype=torch.int32))
    seg = mx.nd.zeros((b, t), ctx=mx.gpu(0), dtype="int32")
    labels = mx.nd.array(torch.randint(0, BERT_VOCAB, (b, t), generator=gen,
                                       device="cuda", dtype=torch.int32))
    net(ids, seg)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": BERT_LR})

    def step():
        with mx.autograd.record():
            out = net(ids, seg)
            mlm = out[-1] if isinstance(out, (list, tuple)) else out
            loss = mx.nd.softmax_cross_entropy(
                mlm.reshape((-1, BERT_VOCAB)), labels.reshape((-1,)))
        loss.backward()
        trainer.step(b)
        loss.wait_to_read()

    prof = mx.profiler
    path = _out_path("telemetry_27d_trace.json")
    try:
        telemetry.enable()
        step()  # the warm-up
        prof.set_config(filename=path, profile_device_trace=False)
        prof.dump(finished=True)
        prof.set_state("run")
        with telemetry.step(examples=b):
            step()
        prof.dump(finished=True)
    finally:
        telemetry.disable()
    events = json.load(open(path))["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "telemetry"}
    ops = [e for e in events if e.get("cat") == "operator"]
    upd = spans.get("trainer.update")
    in_update = [e for e in ops if upd is not None and
                 upd["ts"] <= e["ts"] <= upd["ts"] + upd["dur"]]
    res = dict(b=b, t=t, spans=sorted(spans), op_events=len(ops),
               ops_in_update=len(in_update), events=len(events))
    ok = {"trainer.step", "trainer.allreduce", "trainer.update"} <= \
        set(spans) and len(ops) > 100
    emit(dict(phase="timeline", card=STASH["smi"], ok=ok, **res))
    if not ok:
        failures.append(f"27d one timeline: {res}")
    del net, trainer
    free_card(torch)



OBS_SLO = {"default": {"ttft_ms": 2000.0, "tpot_ms": 60.0}}  # 28a targets
OBS_WINDOW_S = 2.0           # 28a: the capacity ledgers' sliding window
OBS_UTIL_MIN = 0.8           # 28a: decode utilization, saturated lane
OBS_SUMMARY_EVERY = 4        # 28a, 28b: serving.latency every N completions
OBS_REQUESTS = 64            # 28b: requests a wave (8 clients)
OBS_WAVES = 3                # 28b: waves a server (the first captures)
OBS_BERT_T = 128             # 28b: BERT-base, every request at T=128
OBS_OVERLOAD_SUBMITS = 16    # 28a: submits into queue_capacity=2
FLEET_STRIDE = 2             # 28c: the fleet exchange's stride
FLEET_ON_STEPS = 6           # 28c: eager steps with the fleet on
FLEET_OFF_STEPS = 3          # 28c: ... and off (the first is the warm-up)
# 28b: the emit_summary keys of the reference's BatchScheduler
# (mxnet_tpu/serving/scheduler.py:314-326)
REF_BATCH_SUMMARY_KEYS = frozenset((
    "record", "completed", "failed", "batches", "rejected",
    "queue_wait_ms", "total_ms", "ttft_ms", "batch_size"))
# 28a: the reference's replica summary (mxnet_tpu/serving/lanes.py:777-807)
REF_REPLICA_SUMMARY_KEYS = frozenset((
    "record", "replica", "completed", "failed", "batches", "queue_wait_ms",
    "total_ms", "ttft_ms", "handoff_ms", "batch_size", "kv_cache",
    "capacity"))


def _prom_samples(text):
    """Prometheus text → {sample: value}; raises on a malformed line."""
    out = {}
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("#"):
            if not ln.startswith("# TYPE mxt_"):
                raise ValueError(f"bad comment line {ln!r}")
            continue
        name, value = ln.rsplit(" ", 1)
        if not name.startswith("mxt_"):
            raise ValueError(f"bad sample line {ln!r}")
        out[name] = float(value)
    return out


def _connected(trace):
    """A finished trace is one tree: one ``request`` root, every other
    span's parent among the trace's spans, and the serving path's
    spans present."""
    spans = trace["spans"]
    ids = {s["id"] for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    names = [s["name"] for s in spans]
    return (len(roots) == 1 and roots[0]["name"] == "request" and
            all(s["parent"] in ids for s in spans if s["parent"] is not None)
            and all(n in names for n in ("queue", "prefill", "handoff",
                                         "evict")) and
            names.count("decode.step") >= 1)


def serving_observability_phase(torch, mx, llama, serving, fa, net,
                                failures):
    """Phases 28a and 28d: phase 8b's server and requests (``llama3_8b``,
    32 layers, bf16, paged, 8 requests of 64-1024 tokens, 32 new tokens
    each, two waves) under ``telemetry.enable(jsonl_path=..., trace=True,
    capacity=True, numerics=True, retrace="raise")`` with
    ``ServerConfig(http_port=0, slo=OBS_SLO, summary_every=4)``.  The
    engine is built with the numerics taps on, so its graphed tick also
    returns ``stats_of(logits)``.  Every prefill shape the traffic can
    meet runs once (batch buckets 1, 2, 4 × the prompts' length buckets),
    then ``retrace.warm()`` and the run of the two waves, with
    ``in_flight()`` and ``capacity.snapshot`` read while it decodes.
    Checks: one connected trace a request and its completion record; trace ids in ``in_flight()`` while decoding;
    ``GET /metrics`` parses and counts 8 completions; ``stats()["slo"]``
    goodput in [0, 1]; decode utilization at least OBS_UTIL_MIN while
    the lane decodes 4 slots in the second wave, and rho, headroom and
    the KV fraction in the snapshot; every tick's ``serving.logits``
    bundle finite (nan and inf 0); no retrace; the replicas' summaries
    with the reference's keys; the tokens within 8b's check (gap
    SERVE_ULPS, at least SERVE_SAME_MIN equal to 8b's offline decoder).
    Then 28d: the first wave again with the lock sanitizer on: its order
    edges, no violation, no held-while-blocking event.  An overloaded
    second server (``queue_capacity=2``, 16 submits) writes exactly one
    flight dump, where ``MXNET_TRACE_DUMP`` says.  Printed: the graphed
    tick's ms off (8b) and on, and a device-trace split of one graphed
    tick with its idle share.  The serving path launches no kernel of
    the port (dense ``_attend``, as the reference's); the check's
    ``net(ids)`` launches are reported apart."""
    import tempfile
    import urllib.request

    from mxnet_tpu_torch import sanitizer, telemetry
    from mxnet_tpu_torch.telemetry import capacity, numerics, retrace
    from mxnet_tpu_torch.telemetry import tracing
    from mxnet_tpu_torch.telemetry.sinks import ListSink

    free_card(torch)
    plain, _ = _serve_prompts(net.config.vocab_size)
    dump_dir = tempfile.mkdtemp(prefix="mxt_flight_")
    old_dump = os.environ.get("MXNET_TRACE_DUMP")
    os.environ["MXNET_TRACE_DUMP"] = os.path.join(dump_dir, "flight.json")
    jsonl = _out_path("serving_28a.jsonl")
    sink = ListSink()
    telemetry.enable(jsonl_path=jsonl, trace=True, capacity=True,
                     numerics=True, retrace="raise")
    telemetry.add_sink(sink)
    capacity.enable(window_s=OBS_WINDOW_S)
    res = {}
    try:
        cfg = serving.ServerConfig(
            max_length=SERVE_MAX_LEN, num_slots=SERVE_SLOTS,
            max_batch=SERVE_SLOTS, block_size=SERVE_BLOCK,
            queue_capacity=4 * SERVE_PROMPTS, http_port=0, slo=OBS_SLO,
            summary_every=OBS_SUMMARY_EVERY)
        srv = serving.GenerativeServer(net, cfg)
        eng = srv.engine
        rep = srv.replicas[0]

        def waves():
            futs = [srv.submit(p, max_new_tokens=SERVE_NEW)
                    for p in plain[:2]]
            deadline = time.time() + 300
            while eng.steps - steps0 < 2 and time.time() < deadline:
                time.sleep(0.001)
            t_wave2 = time.perf_counter()
            futs += [srv.submit(p, max_new_tokens=SERVE_NEW)
                     for p in plain[2:]]
            samples, flights = [], []
            while not all(f.done() for f in futs):
                rows = srv.in_flight()
                dec = [r for r in rows
                       if r["state"] in ("decoding", "handoff")]
                flights.append([r["trace_id"] for r in dec])
                snap = capacity.snapshot(0)
                if snap is not None:
                    samples.append(dict(
                        t=time.perf_counter() - t_wave2,
                        decoding=len(dec), utilization=snap["utilization"],
                        rho=snap["rho"], headroom_rps=snap["headroom_rps"],
                        kv_free_frac=snap["kv_free_frac"]))
                time.sleep(0.05)
            return [f.result(600) for f in futs], samples, flights

        with srv:
            url = srv.metrics_url
            # every prefill program shape the traffic can meet, before
            # the warmup is declared: (batch bucket, length bucket)
            lbs = sorted({cfg.policy.length_bucket(len(p)) for p in plain})
            with torch.inference_mode():
                for kb in sorted({cfg.policy.batch_bucket(n)
                                  for n in range(1, SERVE_SLOTS + 1)}):
                    for lb in lbs:
                        eng.prefill_rows(np.ones((kb, lb), np.int32),
                                         np.full(kb, lb, np.int32))
            torch.cuda.synchronize()
            retrace.warm()
            ticks0 = len(rep.tick_ms)
            steps0 = eng.steps
            t = time.perf_counter()
            replies, samples, flights = waves()
            wall_s = time.perf_counter() - t
            deadline = time.time() + 60
            while srv.stats()["completed"] < len(plain) and \
                    time.time() < deadline:
                time.sleep(0.01)
            scrape = urllib.request.urlopen(url + "/metrics",
                                            timeout=30).read().decode()
            health = json.loads(urllib.request.urlopen(
                url + "/healthz", timeout=30).read())
            stats = srv.stats()
            ticks = list(rep.tick_ms)[ticks0:]
            pend = [e[1].reshape(-1, 5) for e in list(numerics._pending)
                    if e[0] == ("serving.logits",)]
            logit_stats = torch.cat(pend).cpu() if pend else None
            violations = retrace.violations()
            measured = list(sink.records)
            # 28d: the first wave again with the lock sanitizer on
            sanitizer.reset_locks()
            sanitizer.enable_locks()
            try:
                lock_futs = [srv.submit(p, max_new_tokens=SERVE_NEW)
                             for p in plain[:2]]
                [f.result(600) for f in lock_futs]
            finally:
                sanitizer.disable_locks()
            edges = sanitizer.lock_order_edges()
            lock_violations = sanitizer.lock_order_violations()
            blocked = sanitizer.held_blocking_events()
        telemetry.disable()
        capacity.disable()
        numerics.clear()
        retrace.disable()
        retrace.reset()
        # the graphed tick alone, on the engine's vacant state: its wall
        # time off and on the profiler's device trace, and the split
        active = list(range(SERVE_SLOTS))
        for _ in range(3):
            eng.step(active)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(10):
            eng.step(active)
        tick_alone_ms = (time.perf_counter() - t) * 1e2
        prof = mx.profiler
        prof.set_config(filename=_out_path("serving_28a_profile.json"),
                        profile_device_trace=True, aggregate_stats=True)
        prof.set_state("run")
        t = time.perf_counter()
        eng.step(active)
        wall = (time.perf_counter() - t) * 1e3
        prof.set_state("stop")
        split = _device_split(torch, prof.device_profile(), wall)
        prof.dumps(reset=True)

        # trap 8: an overloaded second server writes one dump, in a
        # directory of its own (28a's run may have dumped a saturation)
        run_dumps = sorted(os.listdir(dump_dir))
        dump_dir = tempfile.mkdtemp(prefix="mxt_flight_overload_")
        os.environ["MXNET_TRACE_DUMP"] = os.path.join(dump_dir,
                                                      "flight.json")
        telemetry.enable(memory=False, cost=False, trace=True)
        small = serving.ServerConfig(max_length=256, num_slots=1,
                                     max_batch=1, block_size=SERVE_BLOCK,
                                     queue_capacity=2)
        over = serving.GenerativeServer(net, small)
        rejected = 0
        with over:
            over.generate(plain[0][:64], max_new_tokens=4, timeout=300)
            futs = []
            for i in range(OBS_OVERLOAD_SUBMITS):
                try:
                    futs.append(over.submit(plain[i % len(plain)][:64],
                                            max_new_tokens=4))
                except serving.ServerOverloadedError:
                    rejected += 1
            [f.result(600) for f in futs]
        dumps = sorted(os.listdir(dump_dir))
        report = json.loads(open(os.path.join(dump_dir, dumps[0])).read()) \
            if dumps else {}
        del over
    finally:
        telemetry.disable()
        capacity.disable()
        numerics.clear()
        retrace.disable()
        retrace.reset()
        sanitizer.disable_locks()
        tracing.clear()
        if old_dump is None:
            os.environ.pop("MXNET_TRACE_DUMP", None)
        else:
            os.environ["MXNET_TRACE_DUMP"] = old_dump

    traces = [r for r in measured if r.get("record") == "trace"]
    recs = [r for r in measured if r.get("record") == "serving.request"]
    sums = [r for r in measured if r.get("record") == "serving.latency"]
    trace_ids = sorted(t["trace_id"] for t in traces)
    trees_ok = len(traces) == len(plain) and \
        all(t["status"] == "ok" and _connected(t) for t in traces) and \
        sorted(r["trace_id"] for r in recs) == trace_ids and \
        len(set(trace_ids)) == len(plain)
    flight_ids = {tid for row in flights for tid in row}
    flights_ok = bool(flight_ids) and flight_ids <= set(trace_ids)
    # the saturated lane: every slot decoding (the second wave)
    samples_ok = [s for s in samples if s["decoding"] == SERVE_SLOTS]
    util_max = max((s["utilization"] for s in samples_ok), default=None)
    cap_end = stats.get("capacity", [{}])[0]
    samples_prom = _prom_samples(scrape)
    completed_prom = samples_prom.get("mxt_serving_completed_total")
    slo = stats["slo"]["tenants"].get("default", {})
    goodput = slo.get("goodput")
    nan_inf = None if logit_stats is None else \
        (int(logit_stats[:, 3].sum()), int(logit_stats[:, 4].sum()))
    sums_ok = bool(sums) and all(set(s) == REF_REPLICA_SUMMARY_KEYS
                                 for s in sums)

    # 8b's token check on the measured replies
    ref = STASH.get("serve", {})
    offline = ref.get("offline", [])
    _zero_counts(fa)  # the check's own launches
    worst_gap, same = 0.0, 0
    for p, r, o in zip(plain, replies, offline):
        t0 = len(p)
        ids = mx.nd.array(torch.from_numpy(
            r[None, :-1].astype(np.int32)).cuda())
        with torch.no_grad():
            lf = net(ids)._data[0, t0 - 1:].float()
        top = lf.max(dim=-1).values
        toks = torch.from_numpy(r[t0:].astype(np.int64)).cuda()
        gap = (top - lf.gather(1, toks[:, None])[:, 0]) / \
            _bf16_ulp(torch, top)
        worst_gap = max(worst_gap, gap.max().item())
        same += int((r[t0:] == o[t0:]).sum())
        del lf
    check_launches = fa.flash_attention_fwd.launches
    same_8b = sum(int(np.array_equal(a, b)) for a, b in
                  zip(replies, ref.get("replies", [])))
    tick_on = float(np.median(ticks)) if ticks else None
    tick_off = ref.get("decode_step_ms_median")
    smi = STASH.get("smi")
    res.update(
        phase="serving_observability", card=smi, layers=net.config.num_layers,
        dtype="bfloat16", waves=[2, len(plain) - 2],
        traces=len(traces), records=len(recs), trees_connected=trees_ok,
        in_flight_trace_ids=len(flight_ids), in_flight_ok=flights_ok,
        metrics_completed=completed_prom, metrics_samples=len(samples_prom),
        health=health.get("status"), slo=slo, goodput=goodput,
        capacity_samples=samples, decode_utilization_max_at_4_slots=util_max,
        capacity_end=cap_end, logit_bundles=None if logit_stats is None
        else int(logit_stats.shape[0]), logit_nan_inf=nan_inf,
        retrace_violations=violations, summaries=len(sums),
        summary_keys_ok=sums_ok, worst_gap_ulps=worst_gap,
        tol_ulps=SERVE_ULPS, tokens_same_as_offline=same,
        tokens_same_min=SERVE_SAME_MIN, replies_equal_to_8b=same_8b,
        check_launches=check_launches,
        tick_ms_observability_off_8b=tick_off,
        tick_ms_observability_on=tick_on,
        tick_on_over_off=tick_on / tick_off if tick_on and tick_off
        else None,
        tick_ms_on=ticks, tick_alone_ms=tick_alone_ms,
        tick_device_split=split, wall_s=wall_s,
        step_graph_key=list(eng._step_key),
        run_dumps=run_dumps, overload_rejected=rejected,
        overload_dumps=dumps,
        overload_dump_reason=report.get("reason"),
        overload_dump_traces=len(report.get("traces", [])))
    ok = trees_ok and flights_ok and completed_prom == len(plain) and \
        goodput is not None and 0.0 <= goodput <= 1.0 and \
        util_max is not None and util_max >= OBS_UTIL_MIN and \
        cap_end.get("rho") is not None and \
        cap_end.get("headroom_rps") is not None and \
        cap_end.get("kv_free_frac") is not None and \
        nan_inf == (0, 0) and logit_stats.shape[0] >= len(ticks) and \
        violations == [] and sums_ok and worst_gap <= SERVE_ULPS and \
        same >= SERVE_SAME_MIN and stats["failed"] == 0 and \
        eng._step_key[-1] == "numerics" and eng._step_graph is not None \
        and rejected >= 1 and len(dumps) == 1 and \
        report.get("reason") == "overload_rejection" and \
        len(report.get("traces", [])) >= 1
    res["ok"] = ok
    emit(res)
    if not ok:
        failures.append(
            f"28a serving observability: trees {trees_ok}, in_flight "
            f"{flights_ok}, /metrics completed {completed_prom}, goodput "
            f"{goodput}, utilization {util_max}, end {cap_end}, logits "
            f"nan/inf {nan_inf}, retrace {violations[:1]}, summaries "
            f"{sums_ok}, gap {worst_gap}, same {same}, dumps {dumps} "
            f"({report.get('reason')}), rejected {rejected}")
    lock_ok = lock_violations == [] and blocked == []
    emit(dict(phase="lock_sanitizer", card=smi,
              order_edges=sorted(list(k) for k in edges),
              violations=lock_violations, held_while_blocking=blocked,
              ok=lock_ok))
    if not lock_ok:
        failures.append(f"28d lock sanitizer: violations {lock_violations}, "
                        f"held while blocking {blocked}")
    del srv, replies
    free_card(torch)


def _serve_observed(torch, serving, telemetry, model, config, requests,
                    cache_stats, counters):
    """One ``InferenceServer`` of ``model`` over OBS_WAVES waves with
    observability off, then one with tracing, a JSONL sink, ``/metrics``
    and ``summary_every`` on; the launches of ``counters`` (kernel
    wrappers) are counted over the second server's run alone.  Returns
    (off summary, on summary, on stats, launches, sink records, scrape)."""
    from mxnet_tpu_torch.telemetry import tracing
    from mxnet_tpu_torch.telemetry.sinks import ListSink

    _, _, off, _ = _serve_waves(serving, model, config, requests,
                                cache_stats, waves=OBS_WAVES)
    sink = ListSink()
    telemetry.enable(memory=False, cost=False, trace=True)
    telemetry.add_sink(sink)
    on_cfg = serving.ServerConfig(
        max_batch=config.policy.max_batch, min_batch=1,
        max_length=config.policy.max_length,
        min_length=config.policy.min_length, length_axis=config.length_axis,
        batch_window_ms=config.batch_window_ms,
        queue_capacity=config.queue_capacity,
        summary_every=OBS_SUMMARY_EVERY, http_port=0)
    scrape = []

    def scrape_metrics(srv):
        import urllib.request

        scrape.append(urllib.request.urlopen(
            srv.metrics_url + "/metrics", timeout=30).read().decode())

    for c in counters:
        for key in [a for a in vars(c) if a.startswith("launches")]:
            setattr(c, key, 0)  # the main path starts here
    try:
        _, _, on, stats = _serve_waves(serving, model, on_cfg, requests,
                                       cache_stats, waves=OBS_WAVES,
                                       before_stop=scrape_metrics)
    finally:
        launches = [c.launches for c in counters]  # ... and ends here
        telemetry.disable()
        tracing.clear()
    return off, on, stats, launches, list(sink.records), \
        scrape[0] if scrape else ""


def stateless_observability_phase(torch, mx, bert, vision, cbr, fa, serving,
                                  failures):
    """Phase 28b: ``InferenceServer`` on BERT-base (bf16, hybridized,
    every request T=128, unmasked: the flash route, #1) and on ResNet-50
    v1 (bf16, hybridized, 224x224: #4, 16 launches a forward), each
    served OBS_WAVES waves of OBS_REQUESTS requests from 8 clients with
    observability off and then on (tracing, a sink, ``summary_every``,
    ``/metrics``).  Checks: each request one trace (``queue``, ``batch``,
    ``request``) and one record; the ``serving.latency`` records with the
    reference's keys; ``/metrics`` parses and counts the completions;
    #1 launches 12 times a BERT batch and #4 16 times a ResNet batch,
    counted over the observed server's run.  Printed: requests/s off and
    on (over the waves after the first)."""
    from mxnet_tpu_torch import telemetry

    gpu = mx.gpu(0)
    smi = STASH.get("smi")
    out = {}

    def checks(name, recs, stats, scrape, launches, per_batch):
        traces = [r for r in recs if r.get("record") == "trace"]
        reqs = [r for r in recs if r.get("record") == "serving.request"]
        sums = [r for r in recs if r.get("record") == "serving.latency"]
        n = OBS_REQUESTS * OBS_WAVES
        prom = _prom_samples(scrape) if scrape else {}
        ok = len(traces) == n and len(reqs) == n and \
            all([s["name"] for s in t["spans"]] == ["queue", "batch",
                                                    "request"]
                for t in traces) and \
            len(sums) == n // OBS_SUMMARY_EVERY and \
            all(set(s) == REF_BATCH_SUMMARY_KEYS for s in sums) and \
            prom.get("mxt_serving_completed_total") == n and \
            stats["failed"] == 0 and launches == per_batch * stats["batches"]
        return ok, dict(traces=len(traces), records=len(reqs),
                        summaries=len(sums),
                        metrics_completed=prom.get(
                            "mxt_serving_completed_total"))

    # BERT-base, the flash route
    free_card(torch)
    mx.random.seed(SEED)
    net = bert.BERTClassifier(bert.bert_base(
        vocab_size=BERT_VOCAB, use_decoder=False, use_classifier=False),
        num_classes=2)
    net.initialize(mx.init.Xavier(), ctx=gpu)
    net(mx.nd.ones((1, OBS_BERT_T), ctx=gpu, dtype="int32"))
    net.cast("bfloat16")
    net.hybridize(static_alloc=True)
    rng = np.random.RandomState(SEED + 28)
    requests = [rng.randint(1, BERT_VOCAB, OBS_BERT_T).astype(np.int32)
                for _ in range(OBS_REQUESTS)]

    def classify(batch):
        return net(mx.nd.array(batch["data"], ctx=gpu, dtype="int32"))

    config = serving.ServerConfig(
        max_batch=SERVE_MAX_BATCH, min_batch=1, max_length=OBS_BERT_T,
        min_length=OBS_BERT_T, batch_window_ms=5.0,
        queue_capacity=OBS_REQUESTS)
    off, on, stats, launches, recs, scrape = _serve_observed(
        torch, serving, telemetry, classify, config, requests,
        net.cache_stats, _counters(fa))
    layers = 12
    ok_b, detail = checks("bert", recs, stats, scrape, launches[0], layers)
    ok_b = ok_b and launches[1:] == [0, 0]
    out["bert"] = dict(requests_per_s_off=off["requests_per_s"],
                       requests_per_s_on=on["requests_per_s"],
                       p50_ms_off=off["p50_ms"], p50_ms_on=on["p50_ms"],
                       p99_ms_off=off["p99_ms"], p99_ms_on=on["p99_ms"],
                       batches=stats["batches"], flash_launches=launches,
                       ok=ok_b, **detail)
    bert_launches = launches[0]
    bert_mma = fa.flash_attention_fwd.launches_mma
    net.hybridize(False)
    del net
    free_card(torch)

    # ResNet-50, the fused 1x1 route
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=gpu)
    net(mx.nd.zeros((1, 3, SERVE_IMAGE, SERVE_IMAGE), ctx=gpu))
    net.cast("bfloat16")
    net.hybridize(static_alloc=True)
    images = [rng.rand(3, SERVE_IMAGE, SERVE_IMAGE).astype(np.float32)
              for _ in range(OBS_REQUESTS)]

    def forward(batch):
        return net(mx.nd.array(batch["data"], ctx=gpu, dtype="bfloat16"))

    config = serving.ServerConfig(
        max_batch=SERVE_MAX_BATCH, min_batch=1, max_length=SERVE_IMAGE,
        min_length=SERVE_IMAGE, length_axis=1, batch_window_ms=5.0,
        queue_capacity=OBS_REQUESTS)
    fn = cbr.fused_matmul_affine_relu
    off, on, stats, launches, recs, scrape = _serve_observed(
        torch, serving, telemetry, forward, config, images,
        net.cache_stats, [fn])
    ok_r, detail = checks("resnet", recs, stats, scrape, launches[0], 16)
    res_mma = fn.launches_mma
    ok_r = ok_r and res_mma == launches[0]
    out["resnet"] = dict(requests_per_s_off=off["requests_per_s"],
                         requests_per_s_on=on["requests_per_s"],
                         p50_ms_off=off["p50_ms"], p50_ms_on=on["p50_ms"],
                         p99_ms_off=off["p99_ms"], p99_ms_on=on["p99_ms"],
                         batches=stats["batches"], fused_launches=launches[0],
                         ok=ok_r, **detail)
    net.hybridize(False)
    del net
    free_card(torch)
    ok = ok_b and ok_r
    emit(dict(phase="stateless_observability", card=smi,
              requests=OBS_REQUESTS, waves=OBS_WAVES, clients=SERVE_CLIENTS,
              ok=ok, **out))
    if not ok:
        failures.append(f"28b stateless observability: {out}")
    return (bert_launches, bert_mma), (launches[0], res_mma)


def fleet_llama_phase(torch, mx, llama, fa, mt, parallel, failures):
    """Phase 28c: 27a's ``llama3_8b`` widths at TEL_LAYERS layers, bf16,
    B=1, T=2048, SGD with momentum, eager steps under ``telemetry``
    (JSONL) on a one-rank NCCL group: FLEET_OFF_STEPS steps with the
    fleet off, then ``fleet.enable(stride=2, http_port=0)`` and
    FLEET_ON_STEPS steps.  Checks: the fleet view's 7 columns of one
    rank, ``duty_cycle`` in (0, 1]; ``fleet.prometheus_text()`` and the
    endpoint's ``/metrics`` parse; an injected shape change after
    ``retrace.warm()`` raises and trips ``fleet.incident("retrace")``;
    NaN in decoder layer 1 gives a ``nan_tensor`` anomaly at layer 1 and
    (with ``halt=True``) one fleet dump; #1, #2, #3 and the update kernel
    at their counts.  Printed: the step's ms with the fleet off, on and
    off the stride, and ``exchange_ms``."""
    import tempfile
    import urllib.request

    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import fleet, numerics, retrace

    free_card(torch)
    parallel.initialize(f"127.0.0.1:{parallel.free_port()}", 1, 0,
                        init_timeout=120)
    dump_dir = tempfile.mkdtemp(prefix="mxt_fleet_")
    old_dump = os.environ.get("MXNET_FLEET_DUMP")
    os.environ.pop("MXNET_FLEET_DUMP", None)
    smi = STASH.get("smi")
    try:
        mx.random.seed(SEED)
        net = llama.llama3_8b(num_layers=TEL_LAYERS)
        net.cast("bfloat16")
        net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
        net.hybridize()
        params = net.collect_params()
        trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": TRAIN_LR,
                                                   "momentum": 0.9})
        ids, labels = _ids_labels(torch, mx, net.config.vocab_size, TEL_T,
                                  SEED + 28)
        anomalies = []

        def step():
            t = time.perf_counter()
            with telemetry.step(examples=TEL_T) as scope:
                loss = _lm_forward(mx, net, ids, labels)
                loss.backward()
                trainer.step(1)
                loss.wait_to_read()
            return scope.record, (time.perf_counter() - t) * 1e3

        _zero_counts(fa)  # the main path starts here
        mt.multi_tensor_update.launches = 0
        jsonl = _out_path("fleet_28c.jsonl")
        telemetry.enable(jsonl_path=jsonl, memory=True, cost=False,
                         retrace="raise")
        off_ms = [step()[1] for _ in range(FLEET_OFF_STEPS)][1:]
        fleet.enable(stride=FLEET_STRIDE, http_port=0,
                     on_anomaly=anomalies.append)
        on = [step() for _ in range(FLEET_ON_STEPS)]
        retrace.warm()
        view = fleet.last_view()
        text = fleet.prometheus_text()
        scrape = urllib.request.urlopen(fleet.metrics_url() + "/metrics",
                                        timeout=30).read().decode()
        forwards = FLEET_OFF_STEPS + FLEET_ON_STEPS
        # an injected shape change: a retrace violation, and the fleet's
        # flight recorder writes its incident
        os.environ["MXNET_FLEET_DUMP"] = os.path.join(dump_dir,
                                                      "retrace.json")
        short = mx.nd.array(ids._data[:, :TEL_T // 2])
        try:
            with mx.autograd.record():
                net(short)
            retrace_error = None
        except retrace.RetraceError as exc:
            retrace_error = str(exc)
        retrace.disable()
        retrace.reset()
        retrace_dump = os.path.exists(os.path.join(dump_dir,
                                                   "retrace.json"))
        # NaN into decoder layer 1: one harvested eager forward with the
        # watchdog's halt on
        os.environ["MXNET_FLEET_DUMP"] = os.path.join(dump_dir, "nan.json")
        fleet.enable(stride=FLEET_STRIDE, halt=True,
                     on_anomaly=anomalies.append)
        numerics.enable(stride=1)
        victim = next(iter(net.model.layers[1].collect_params().values()))
        with torch.no_grad():
            victim.data()._data.view(-1)[0] = float("nan")
        net.hybridize(False)
        halted = None
        try:
            with telemetry.step(examples=TEL_T):
                net(ids).wait_to_read()
        except fleet.WatchdogHalt as exc:
            halted = str(exc)
        forwards += 1
        nan_doc = json.loads(open(os.path.join(dump_dir, "nan.json")).read()) \
            if os.path.exists(os.path.join(dump_dir, "nan.json")) else {}
    finally:
        telemetry.disable()
        fleet.disable()
        fleet.clear()
        numerics.clear()
        retrace.disable()
        retrace.reset()
        if old_dump is None:
            os.environ.pop("MXNET_FLEET_DUMP", None)
        else:
            os.environ["MXNET_FLEET_DUMP"] = old_dump
        parallel.shutdown()
    launches = [c.launches for c in _counters(fa)]  # the main path ends
    mma = _mma_counts(fa)
    updates = mt.multi_tensor_update.launches
    backwards = FLEET_OFF_STEPS + FLEET_ON_STEPS
    want = [TEL_LAYERS * forwards, TEL_LAYERS * backwards,
            TEL_LAYERS * backwards]
    cols = ("step_ms", "allreduce_wait_ms", "compute_ms", "peak_live_bytes",
            "examples_per_sec", "first_nan_layer", "duty_cycle")
    view_ok = view is not None and all(
        len(view.get(c, [])) == 1 for c in cols) and \
        0.0 < view["duty_cycle"][0] <= 1.0 and view["world_size"] == 1
    records = telemetry.read_jsonl(jsonl)
    stamped = [r for r in records if r.get("record") is None
               and "rank" in r]
    on_stride = [ms for rec, ms in on if rec["step"] % FLEET_STRIDE == 0]
    off_stride = [ms for rec, ms in on if rec["step"] % FLEET_STRIDE]
    nan_evt = [a for a in anomalies if a["kind"] == "nan_tensor"]
    dumps = sorted(os.listdir(dump_dir))
    try:
        _prom_samples(text)
        prom = _prom_samples(scrape)
        prom_ok = prom.get("mxt_fleet_world_size") == 1.0
    except ValueError:
        prom_ok = False
    res = dict(
        phase="fleet_llama", card=smi, layers=TEL_LAYERS, t=TEL_T,
        stride=FLEET_STRIDE, step_ms_fleet_off=off_ms,
        step_ms_fleet_on_stride=on_stride,
        step_ms_fleet_off_stride=off_stride,
        step_ms_median_off=float(np.median(off_ms)),
        step_ms_median_on=float(np.median([ms for _, ms in on[1:]])),
        exchange_ms=view.get("exchange_ms") if view else None,
        view={c: view.get(c) for c in cols} if view else None,
        view_ok=view_ok, stamped_records=len(stamped),
        prometheus_ok=prom_ok, retrace_error=(retrace_error or "")[:200],
        retrace_dump=retrace_dump, halted=halted,
        nan_anomaly=nan_evt[:1], nan_dump_reason=nan_doc.get("reason"),
        dumps=dumps, launches=launches, launches_mma=mma,
        want_launches=want, update_launches=updates,
        want_updates=backwards)
    ok = view_ok and prom_ok and len(stamped) == FLEET_ON_STEPS and \
        retrace_error is not None and retrace_dump and \
        halted is not None and bool(nan_evt) and \
        nan_evt[0]["layer"] == 1 and nan_evt[0]["path"] == "decoder.1" and \
        nan_doc.get("reason") == "watchdog_halt" and \
        dumps == ["nan.json", "retrace.json"] and launches == want and \
        mma == want and updates == backwards
    res["ok"] = ok
    emit(res)
    if not ok:
        failures.append(f"28c fleet watchdog: {res}")
    del net, trainer
    free_card(torch)
    return launches, mma, updates


# -- slice 21: memory as a managed budget ------------------------------------

PLAN_HIDDEN, PLAN_LAYERS, PLAN_B = 8192, 8, 4  # 29a: params-dominated MLP
PLAN_TOL = 0.10              # the planner against memwatch and the allocator
REMAT_LAYERS = 16            # 29b: the training slice's depth
REMAT_STEPS = 3
FULL_LAYERS = 32             # 29c: llama3_8b's depth
FULL_STEPS = 2
OFFLOAD_LAYERS = 8           # 29d: offloaded against on-device, bit for bit
OFFLOAD_STEPS = 3
OFFLOAD_DEPTHS = (32, 24, 16)  # 29d: the deepest the host can pin
OFFLOAD_FULL_STEPS = 2
HOST_RESERVE = 8 << 30       # host memory left free beside the pinned state


def _pow2(n):
    """The caching host allocator's block for ``n`` bytes (it rounds each
    pinned allocation up to a power of two)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _mem_available():
    """``MemAvailable`` of the host in bytes (``/proc/meminfo``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return None


def memory_plan_phase(torch, mx, memory, failures):
    """Phase 29a: the planner on the card.  A params-dominated MLP
    (PLAN_LAYERS x Dense(PLAN_HIDDEN), f32, B=PLAN_B, the reference
    test's lane at card size) trained two steps with Adam and with SGD +
    momentum under memwatch: ``plan_model``'s ``predicted_peak_bytes``
    within PLAN_TOL of ``memwatch.live_bytes()`` and of
    ``torch.cuda.memory_allocated``; ``budget_bytes()`` is the card's
    total memory; ``plan_kv_pool`` equals phase 8b's engine's
    ``kv_pool_bytes()``."""
    from mxnet_tpu_torch.telemetry import memwatch

    rows, ok = {}, True
    for name, kw in (("adam", {"learning_rate": 1e-3}),
                     ("sgd", {"learning_rate": 0.01, "momentum": 0.9})):
        free_card(torch)
        memwatch.enable()
        try:
            mx.random.seed(SEED)
            net = mx.gluon.nn.HybridSequential()
            for _ in range(PLAN_LAYERS):
                net.add(mx.gluon.nn.Dense(PLAN_HIDDEN, activation="relu",
                                          in_units=PLAN_HIDDEN))
            net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
            net.hybridize(static_alloc=True)
            trainer = mx.gluon.Trainer(net.collect_params(), name, kw)
            x = mx.nd.ones((PLAN_B, PLAN_HIDDEN), ctx=mx.gpu(0))
            y = mx.nd.ones((PLAN_B, PLAN_HIDDEN), ctx=mx.gpu(0)) * 0.5
            loss_fn = mx.gluon.loss.L2Loss()
            for _ in range(2):
                with mx.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                trainer.step(PLAN_B)
            torch.cuda.synchronize()
            del loss
            gc.collect()
            live = memwatch.live_bytes()
            alloc = torch.cuda.memory_allocated()
            plan = memory.plan_model(
                net.collect_params(), optimizer=trainer._optimizer,
                batch_bytes=2 * PLAN_B * PLAN_HIDDEN * 4, remat="none",
                use_registry=False)
        finally:
            memwatch.disable()
        pred = plan.predicted_peak_bytes
        err_live, err_alloc = abs(pred - live) / live, \
            abs(pred - alloc) / alloc
        good = err_live <= PLAN_TOL and err_alloc <= PLAN_TOL and plan.fits
        rows[name] = dict(predicted_peak_bytes=pred, live_bytes=live,
                          memory_allocated=alloc, err_live=err_live,
                          err_allocated=err_alloc, breakdown=plan.breakdown,
                          ok=good)
        ok = ok and good
        del net, trainer, x, y
    total = torch.cuda.get_device_properties(0).total_memory
    budget = memory.budget_bytes()
    kv = STASH.get("serve", {}).get("kv_pool")
    kv_plan = None if kv is None else memory.plan_kv_pool(
        kv["num_layers"], kv["num_kv_heads"], kv["head_dim"],
        kv["num_blocks"], kv["block_size"], dtype=kv["dtype"])
    kv_ok = kv is not None and kv_plan == kv["bytes"]
    ok = ok and budget == total and kv_ok
    emit(dict(phase="memory_plan", card=STASH["smi"], layers=PLAN_LAYERS,
              hidden=PLAN_HIDDEN, B=PLAN_B, tol=PLAN_TOL, optimizers=rows,
              budget_bytes=budget, total_memory=total,
              kv_pool_bytes=None if kv is None else kv["bytes"],
              plan_kv_pool=kv_plan, ok=ok))
    if not ok:
        failures.append(f"29a planner: {rows}, budget {budget} vs "
                        f"{total}, kv pool {kv_plan} vs {kv}")
    free_card(torch)


def _llama_f32(torch, mx, llama, layers):
    """``llama3_8b`` widths at ``layers``, f32, ``scan_layers=True``,
    weights drawn on the card from the seed, and plain SGD."""
    free_card(torch)
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=layers, scan_layers=True)
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": TRAIN_LR})
    return net, trainer


def _remat_steps(torch, mx, fa, mt, net, trainer, ids, labels, steps):
    """``steps`` eager training steps → per step (loss, ms, peak bytes,
    #1/#2/#3 launches, their tensor-core launches, update launches)."""
    out = []
    for _ in range(steps):
        before = [c.launches for c in _counters(fa)]
        before_mma = _mma_counts(fa)
        upd = mt.multi_tensor_update.launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss = _lm_forward(mx, net, ids, labels)
        loss.backward()
        trainer.step(1)
        value = float(loss.asscalar())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        out.append(dict(loss=value, ms=ms,
                        peak=torch.cuda.max_memory_allocated(),
                        launches=[c.launches - n for c, n in
                                  zip(_counters(fa), before)],
                        launches_mma=[c - n for c, n in
                                      zip(_mma_counts(fa), before_mma)],
                        update_launches=mt.multi_tensor_update.launches -
                        upd))
        del loss
    return out


def _state_bytes(net):
    """Bytes of the net's weights (and so of its gradients)."""
    return sum(p.data()._data.numel() * p.data()._data.element_size()
               for p in net.collect_params().values())


def remat_ladder_phase(torch, mx, llama, fa, mt, memory, failures):
    """Phase 29b: the remat ladder on the training slice's configuration,
    ``llama3_8b(scan_layers=True)`` at REMAT_LAYERS layers, f32, B=1,
    T=2048, SGD: REMAT_STEPS steps from the same weights at each of
    "none", "dots" and "layer".  Each tier's step ms, peak allocated
    memory, the planner's prediction (its coarse prior, and with the
    "none" tier's measured activation bytes as the hint) and the
    launches of #1/#2/#3 and the update a step (#1: REMAT_LAYERS a step
    under "none", 2 x REMAT_LAYERS under the others); the losses
    bit-equal across the tiers.  Returns (launches, tensor-core
    launches, update launches, the "none" tier's activation bytes)."""
    from mxnet_tpu_torch.memory import policy

    rows, losses, totals, upd_total = {}, {}, [0, 0, 0], 0
    mma_total = [0, 0, 0]
    act_none = None
    for tier in policy.TIERS:
        net, trainer = _llama_f32(torch, mx, llama, REMAT_LAYERS)
        net.set_remat(tier)
        ids, labels = _ids_labels(torch, mx, net.config.vocab_size, 2048,
                                  SEED + 5)
        weights = _state_bytes(net)
        steps = _remat_steps(torch, mx, fa, mt, net, trainer, ids, labels,
                             REMAT_STEPS)
        hidden_b = 2048 * net.config.hidden_size * 4
        plan = memory.plan_model(net, optimizer=trainer._optimizer,
                                 batch_bytes=hidden_b, remat=tier,
                                 use_registry=False)
        peak = max(s["peak"] for s in steps)
        if tier == "none":
            act_none = peak - 2 * weights
        hinted = memory.plan_model(net, optimizer=trainer._optimizer,
                                   batch_bytes=hidden_b, remat=tier,
                                   activation_hint=act_none,
                                   use_registry=False)
        want = [(1 if tier == "none" else 2) * REMAT_LAYERS,
                REMAT_LAYERS, REMAT_LAYERS]
        # f32 runs the FMA designs: no tensor-core launch, recompute too
        good = all(s["launches"] == want and
                   s["launches_mma"] == [0, 0, 0] and
                   s["update_launches"] == 1 for s in steps)
        rows[tier] = dict(step_ms=[s["ms"] for s in steps],
                          max_memory_allocated=peak,
                          weights_bytes=weights,
                          predicted_peak_bytes=plan.predicted_peak_bytes,
                          predicted_with_hint=hinted.predicted_peak_bytes,
                          launches_per_step=steps[-1]["launches"],
                          launches_mma_per_step=steps[-1]["launches_mma"],
                          update_launches_per_step=steps[-1]
                          ["update_launches"], ok=good)
        losses[tier] = [s["loss"] for s in steps]
        for s in steps:
            totals = [a + b for a, b in zip(totals, s["launches"])]
            mma_total = [a + b for a, b in zip(mma_total, s["launches_mma"])]
            upd_total += s["update_launches"]
        if not good:
            failures.append(f"29b {tier}: launches {steps}")
        del net, trainer, ids, labels
    ref = losses["none"]
    diffs = {t: max(abs(a - b) for a, b in zip(v, ref))
             for t, v in losses.items()}
    same = all(v == ref for v in losses.values())
    falling = ref[-1] < ref[0]
    emit(dict(phase="remat_ladder", card=STASH["smi"], layers=REMAT_LAYERS,
              dtype="float32", B=1, T=2048, tiers=rows, losses=losses,
              largest_loss_difference=diffs,
              activation_bytes_none=act_none,
              ok=same and falling and all(r["ok"] for r in rows.values())))
    if not same:
        failures.append(f"29b: the tiers' losses differ: {diffs}")
    if not falling:
        failures.append(f"29b: the loss did not fall: {ref}")
    free_card(torch)
    return totals, mma_total, upd_total, act_none


def full_depth_phase(torch, mx, llama, fa, mt, memory, act_none, failures):
    """Phase 29c: ``llama3_8b`` at all FULL_LAYERS layers, f32, B=1,
    T=2048, SGD, ``set_remat("layer")``: FULL_STEPS steps through the
    flash kernels (#1 2 x FULL_LAYERS a step, #2 and #3 FULL_LAYERS).
    Printed: the peak against the planner's prediction (its prior, and
    with 29b's "none"-tier activation bytes scaled to FULL_LAYERS as the
    hint), the step ms and the launches; and "auto"'s pick with no hint
    (the reference's coarse prior, which may pick a tier that does not
    fit: reported as it is) and with that hint."""
    from mxnet_tpu_torch.memory import policy

    net, trainer = _llama_f32(torch, mx, llama, FULL_LAYERS)
    net.set_remat("layer")
    ids, labels = _ids_labels(torch, mx, net.config.vocab_size, 2048,
                              SEED + 5)
    weights = _state_bytes(net)
    steps = _remat_steps(torch, mx, fa, mt, net, trainer, ids, labels,
                         FULL_STEPS)
    hidden_b = 2048 * net.config.hidden_size * 4
    hint = None if act_none is None else \
        int(act_none * FULL_LAYERS / REMAT_LAYERS)
    plan = memory.plan_model(net, optimizer=trainer._optimizer,
                             batch_bytes=hidden_b, remat="layer",
                             use_registry=False)
    hinted = memory.plan_model(net, optimizer=trainer._optimizer,
                               batch_bytes=hidden_b, remat="layer",
                               activation_hint=hint, use_registry=False)
    auto = policy.auto_tier(net, optimizer=trainer._optimizer,
                            batch_bytes=hidden_b, record=False)
    auto_hint = policy.auto_tier(net, optimizer=trainer._optimizer,
                                 batch_bytes=hidden_b, activation_hint=hint,
                                 record=False)
    want = [2 * FULL_LAYERS, FULL_LAYERS, FULL_LAYERS]
    losses = [s["loss"] for s in steps]
    ok = all(s["launches"] == want and s["launches_mma"] == [0, 0, 0] and
             s["update_launches"] == 1 and math.isfinite(s["loss"])
             for s in steps) and losses[-1] < losses[0]
    peak = max(s["peak"] for s in steps)
    emit(dict(phase="full_depth", card=STASH["smi"], layers=FULL_LAYERS,
              dtype="float32", B=1, T=2048, remat="layer", losses=losses,
              step_ms=[s["ms"] for s in steps], max_memory_allocated=peak,
              weights_bytes=weights,
              predicted_peak_bytes=plan.predicted_peak_bytes,
              predicted_with_hint=hinted.predicted_peak_bytes,
              activation_hint=hint,
              launches_per_step=[s["launches"] for s in steps],
              launches_mma_per_step=[s["launches_mma"] for s in steps],
              update_launches=[s["update_launches"] for s in steps],
              auto_no_hint=dict(tier=auto[0],
                                predicted_peak_bytes=auto[1]
                                .predicted_peak_bytes, fits=auto[1].fits),
              auto_with_hint=dict(tier=auto_hint[0],
                                  predicted_peak_bytes=auto_hint[1]
                                  .predicted_peak_bytes,
                                  fits=auto_hint[1].fits),
              budget_bytes=memory.budget_bytes(), ok=ok))
    if not ok:
        failures.append(f"29c full depth: losses {losses}, steps {steps}")
    totals = [sum(s["launches"][i] for s in steps) for i in range(3)]
    mma = [sum(s["launches_mma"][i] for s in steps) for i in range(3)]
    upd = sum(s["update_launches"] for s in steps)
    del net, trainer, ids, labels
    free_card(torch)
    return totals, mma, upd


def _llama_bf16(torch, mx, llama, layers, offload=None):
    """``llama3_8b`` widths at ``layers``, bf16 weights, ``scan_layers``
    (remat "layer"), SGD with momentum and f32 masters."""
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=layers, scan_layers=True)
    net.cast("bfloat16")
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    trainer = mx.gluon.Trainer(
        net.collect_params(), "sgd",
        {"learning_rate": TRAIN_LR, "momentum": 0.9,
         "multi_precision": True}, offload=offload)
    return net, trainer


def _offload_step(torch, mx, fa, mt, offload, net, trainer, ids, labels):
    """One step → (loss, ms, the card's peak during the update and its
    rise over the update's start, the trainer's optimizer state on the
    card (the staging buffer when offloaded), H2D and D2H bytes, update
    launches, #1/#2/#3 launches, tensor-core launches)."""
    before = [c.launches for c in _counters(fa)]
    before_mma = _mma_counts(fa)
    st = offload.stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss = _lm_forward(mx, net, ids, labels)
    loss.backward()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    upd = mt.multi_tensor_update.launches
    trainer.step(1)
    value = float(loss.asscalar())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    after = offload.stats()
    state = [h._data for i in trainer._live()
             for h in trainer._offloaded_ndarrays(i)]
    stage = trainer._offload_stage
    return dict(loss=value, ms=ms,
                update_peak=torch.cuda.max_memory_allocated(),
                update_extra=torch.cuda.max_memory_allocated() - start,
                state_on_card=sum(x.numel() * x.element_size()
                                  for x in state if x.is_cuda) +
                (0 if stage is None else stage.numel()),
                h2d_bytes=after["h2d_bytes_total"] - st["h2d_bytes_total"],
                d2h_bytes=after["d2h_bytes_total"] - st["d2h_bytes_total"],
                update_launches=mt.multi_tensor_update.launches - upd,
                launches=[c.launches - n for c, n in
                          zip(_counters(fa), before)],
                launches_mma=[c - n for c, n in
                              zip(_mma_counts(fa), before_mma)])


def _host_need(net):
    """Pinned host bytes of a bf16 net's offloaded state (f32 master and
    momentum a parameter), each rounded as the caching host allocator
    rounds it."""
    return sum(2 * _pow2(p.data()._data.numel() * 4)
               for p in net.collect_params().values())


def offload_phase(torch, mx, llama, fa, mt, memory, failures):
    """Phase 29d: host offload.  ``llama3_8b`` bf16 weights, SGD with
    momentum and ``multi_precision=True``, remat "layer", B=1, T=2048.
    First the deepest of OFFLOAD_DEPTHS whose state the host can pin
    (``MemAvailable``, printed first, less HOST_RESERVE) for
    OFFLOAD_FULL_STEPS offloaded steps: run first, while the host has
    the most memory (torch keeps pinned blocks cached once made, and the
    pair below reuses them).  Then at OFFLOAD_LAYERS layers
    ``Trainer(offload="host")`` against the on-device trainer for
    OFFLOAD_STEPS steps: the weights bit-equal after every step; each
    trainer's optimizer state on the card and the card's peak during its
    update (both nets are on the card), the H2D/D2H bytes, the step ms
    and the update's launches a step (one a group)."""
    from mxnet_tpu_torch.memory import offload

    free_card(torch)
    offload.reset()
    host_avail = _mem_available()
    emit(dict(phase="offload_host", card=STASH["smi"],
              mem_available=host_avail))
    totals, mma, upd = [0, 0, 0], [0, 0, 0], 0

    def count(got):
        nonlocal totals, mma, upd
        totals = [a + b for a, b in zip(totals, got["launches"])]
        mma = [a + b for a, b in zip(mma, got["launches_mma"])]
        upd += got["update_launches"]

    for layers in OFFLOAD_DEPTHS:
        probe = llama.llama3_8b(num_layers=layers)
        need = sum(2 * _pow2(int(np.prod(p.shape)) * 4)
                   for p in probe.collect_params().values())
        del probe
        if host_avail is None or need + HOST_RESERVE <= host_avail:
            break
    else:
        layers = None
    if layers is None:
        failures.append(f"29d: the host cannot pin the state of "
                        f"{OFFLOAD_DEPTHS[-1]} layers ({host_avail} bytes "
                        f"available)")
    else:
        t = time.perf_counter()
        net, trainer = _llama_bf16(torch, mx, llama, layers,
                                   offload="host")
        ids, labels = _ids_labels(torch, mx, net.config.vocab_size, 2048,
                                  SEED + 5)
        steps = [_offload_step(torch, mx, fa, mt, offload, net, trainer,
                               ids, labels)
                 for _ in range(OFFLOAD_FULL_STEPS)]
        for g in steps:
            count(g)
        groups = len(trainer._offload_groups(trainer._live()))
        losses = [s["loss"] for s in steps]
        good = all(math.isfinite(x) for x in losses) and \
            steps[-1]["update_launches"] == groups and \
            steps[-1]["launches"] == [2 * layers, layers, layers]
        emit(dict(phase="offload_full", card=STASH["smi"], layers=layers,
                  wanted_layers=OFFLOAD_DEPTHS[0], mem_available=host_avail,
                  pinned_need=_host_need(net),
                  seconds=time.perf_counter() - t, steps=steps,
                  groups=groups, stage_bytes=trainer._offload_stage.numel(),
                  resident_bytes=offload.resident_bytes(),
                  weights_bytes=_state_bytes(net), ok=good))
        if not good:
            failures.append(f"29d offload at {layers} layers: {steps}")
        del net, trainer
        free_card(torch)
        offload.reset()
    pair = [_llama_bf16(torch, mx, llama, OFFLOAD_LAYERS),
            _llama_bf16(torch, mx, llama, OFFLOAD_LAYERS, offload="host")]
    ids, labels = _ids_labels(torch, mx, pair[0][0].config.vocab_size,
                              2048, SEED + 5)
    rows, equal = [], True
    for step in range(OFFLOAD_STEPS):
        got = [_offload_step(torch, mx, fa, mt, offload, net, tr, ids,
                             labels) for net, tr in pair]
        same = all(torch.equal(a.data()._data, b.data()._data) for a, b in
                   zip(pair[0][0].collect_params().values(),
                       pair[1][0].collect_params().values()))
        equal = equal and same and got[0]["loss"] == got[1]["loss"]
        rows.append(dict(step=step, device=got[0], offloaded=got[1],
                         weights_equal=same))
        for g in got:
            count(g)
    groups = len(pair[1][1]._offload_groups(pair[1][1]._live()))
    resident = offload.resident_bytes()
    ok = equal and all(r["offloaded"]["update_launches"] == groups and
                       r["device"]["update_launches"] == 1 for r in rows) \
        and resident > 0
    emit(dict(phase="offload_pair", card=STASH["smi"],
              layers=OFFLOAD_LAYERS, steps=rows, groups=groups,
              stage_bytes=pair[1][1]._offload_stage.numel(),
              resident_bytes=resident, mem_available=_mem_available(),
              ok=ok))
    if not ok:
        failures.append(f"29d offload at {OFFLOAD_LAYERS} layers: {rows}")
    del pair
    free_card(torch)
    offload.reset()
    return totals, mma, upd



# -- slice 23: graphed recorded forwards, the serving graphs, the detectors'
# export, host offload over a mesh, bulk segments (phases 30a-30e) ----------

REC_STEPS = 4               # 30a: recorded steps a loop (the first eager)
REC_LLAMA_LAYERS = 4        # 30a: llama3_8b depth (phase 9 runs 16)
REC_TWICE_B = 16            # 30a: ResNet-50's batch in the twice-called loop
REC_DROP = 0.1              # 30a: the fresh-mask check's rate
REC_DROP_N = 1 << 22        # ... over this many units
GS_LENGTHS = (96, 400, 1000)  # 30b: prompt lengths served a mode
GS_PREFIX = 512             # 30b: the radix mode's shared prefix
GS_NEW = 8                  # 30b: new tokens a request
GS_BUCKETS = ((1, 128), (1, 512), (1, 2048))  # 30b: timed prefills
GS_MIN_LENGTH = 128         # 30b: the servers' shortest length bucket
GS_REPS = 3                 # 30b: timed calls of each program, after two
OFFMESH_LAYERS = 8          # 30d: llama3_8b depth
OFFMESH_STEPS = 3
BULK_N = 16                 # 30e: ops a segment
BULK_STEPS = 4              # 30e: steps of each loop
BULK_WLM_B = 32


def _phase(fn, failures, default, *args):
    """``fn(*args, failures)``; an exception fails the run (it is added to
    ``failures`` with its traceback on stderr) and gives ``default``, so
    the later phases still run and report."""
    import traceback

    try:
        return fn(*args, failures)
    except Exception as exc:
        traceback.print_exc()
        failures.append(f"{fn.__name__} raised {type(exc).__name__}: {exc}")
        return default


def _grad_diff(torch, a, b):
    """(every gradient of ``a`` bit-equal to ``b``'s, the largest relative
    norm of a difference) over two nets' parameter lists."""
    equal, worst = True, 0.0
    for p, q in zip(a, b):
        if p.grad_req == "null":
            continue
        g, h = p.grad()._data.float(), q.grad()._data.float()
        if not torch.equal(g, h):
            equal = False
            worst = max(worst, float((g - h).norm() /
                                     h.norm().clamp_min(1e-30)))
    return equal, worst


def _params_equal(torch, a, b):
    return all(torch.equal(p.data()._data, q.data()._data)
               for p, q in zip(a.collect_params().values(),
                               b.collect_params().values()))


def _rec_pair(torch, mx, fa, name, make, inputs, loss_of, opt, batch,
              failures):
    """30a's loop: two nets of ``make()`` from one seed, the second
    hybridized; REC_STEPS recorded steps of each, interleaved (forward,
    backward, ``Trainer.step``), the first call of the hybridized net its
    warm-up, the second its capture, the rest replays.  Returns the row
    and the flash launches of the graphed route."""
    nets, trainers = [], []
    for hyb in (False, True):
        mx.random.seed(SEED)
        net = make()
        net(*inputs)  # resolve deferred shapes, eagerly
        if hyb:
            net.hybridize()
        nets.append(net)
        trainers.append(mx.gluon.Trainer(net.collect_params(), *opt))
    torch.cuda.synchronize()
    rows, launches, mma = [], [0, 0, 0], [0, 0, 0]
    for step in range(REC_STEPS):
        row = dict(step=step)
        for route, net, tr in zip(("eager", "graphed"), nets, trainers):
            before = [c.launches for c in _counters(fa)]
            before_mma = _mma_counts(fa)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with mx.autograd.record():
                loss = loss_of(net, *inputs)
            loss.backward()
            tr.step(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            got = [c.launches - n for c, n in zip(_counters(fa), before)]
            row[route] = dict(loss=float(loss.mean().asscalar()), ms=ms,
                              launches=got)
            if route == "graphed":
                launches = [a + b for a, b in zip(launches, got)]
                mma = [a + c - d for a, c, d in
                       zip(mma, _mma_counts(fa), before_mma)]
            del loss
        row["grads_bit_equal"], row["grad_rel_norm"] = _grad_diff(
            torch, list(nets[1].collect_params().values()),
            list(nets[0].collect_params().values()))
        rows.append(row)
    stats = nets[1].cache_stats()
    weights_equal = _params_equal(torch, nets[1], nets[0])
    instances = [len(e.instances) for e in
                 nets[1]._cached_op._rec_graphs.values() if e != "eager"]
    bit_equal = all(r["grads_bit_equal"] and
                    r["graphed"]["loss"] == r["eager"]["loss"]
                    for r in rows) and weights_equal
    # the routes run the same kernels in the same order: bit-equal
    good = stats.get("eager", 0) == 0 and stats["recorded"] == 0 and \
        "over_budget" not in stats and \
        stats["hits"] >= REC_STEPS - 1 and bit_equal
    eager_ms = [r["eager"]["ms"] for r in rows[2:]]
    graph_ms = [r["graphed"]["ms"] for r in rows[2:]]
    row = dict(net=name, steps=rows, cache_stats=stats,
               capture_error=nets[1]._cached_op.capture_error,
               graph_instances=instances,
               graph_pool_bytes=nets[1]._cached_op.recorded_graph_bytes(),
               weights_bit_equal=weights_equal, bit_equal=bit_equal,
               eager_step_ms=sum(eager_ms) / len(eager_ms),
               graphed_step_ms=sum(graph_ms) / len(graph_ms),
               launches_a_step=rows[-1]["graphed"]["launches"], ok=good)
    if not good:
        failures.append(f"30a {name}: {row}")
    del nets, trainers
    free_card(torch)
    return row, (launches, mma)


def recorded_graph_phase(torch, mx, bert, llama, vision, fa, failures):
    """Phase 30a: hybridized blocks under ``autograd.record()`` replay a
    forward and a backward CUDA graph as one tape node.  Against the same
    loop unhybridized, from one state, REC_STEPS steps each: BERT-base
    (B=64, T=128, amp bf16, Adam, dropout 0), ``llama3_8b`` at full width
    and REC_LLAMA_LAYERS layers (bf16, B=1, T=2048, SGD with momentum)
    and ResNet-50 (bf16, B=128, BatchNorm's batch statistics, SGD with
    momentum): the losses, every gradient and the weights after the
    steps bit-equal (the routes run the same kernels); the step ms of
    each route; the graph pairs' pool bytes; #1-#3's launches a graphed
    step.  Then ResNet-50
    at B=REC_TWICE_B called twice before its backward (two instances of
    the graph pair), and the fresh-mask check: a hybridized Dropout at
    rate REC_DROP over REC_DROP_N units, whose two replays draw different
    masks, each keeping 1 - REC_DROP of the units within 1%."""
    from mxnet_tpu_torch import amp

    free_card(torch)
    gpu = mx.gpu(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 230)
    rows, launches, mma = {}, [0, 0, 0], [0, 0, 0]
    _zero_counts(fa)  # 30a's paths start here (each step's delta is read)

    def add(name, got):
        nonlocal launches, mma
        rows[name], (n, m) = got
        launches = [a + b for a, b in zip(launches, n)]
        mma = [a + b for a, b in zip(mma, m)]

    b, t = BERT_B, BERT_T
    ids = mx.nd.array(torch.randint(0, BERT_VOCAB, (b, t), generator=gen,
                                    device="cuda", dtype=torch.int32))
    seg = mx.nd.zeros((b, t), ctx=gpu, dtype="int32")
    labels = mx.nd.array(torch.randint(0, BERT_VOCAB, (b, t), generator=gen,
                                       device="cuda", dtype=torch.int32))

    def make_bert():
        net = bert.bert_base(vocab_size=BERT_VOCAB, dropout=0.0)
        net.initialize(mx.init.Xavier(), ctx=gpu)
        return net

    amp.init("bfloat16")
    try:
        add("bert_base", _rec_pair(
            torch, mx, fa, "bert_base", make_bert, (ids, seg),
            lambda n, i, s: mx.nd.softmax_cross_entropy(
                n(i, s)[-1], labels) / (b * t),
            ("adam", {"learning_rate": BERT_LR}), 1, failures))
    finally:
        amp.turn_off()

    def make_llama():
        net = llama.llama3_8b(num_layers=REC_LLAMA_LAYERS)
        net.cast("bfloat16")
        net.initialize(mx.init.Normal(0.02), ctx=gpu)
        return net

    lids, llab = _ids_labels(torch, mx, 128256, 2048, SEED + 5)
    add("llama3_8b", _rec_pair(
        torch, mx, fa, f"llama3_8b_{REC_LLAMA_LAYERS}_layers", make_llama,
        (lids,), lambda n, i: mx.nd.softmax_cross_entropy(
            n(i).reshape((-1, n.config.vocab_size)), llab.reshape((-1,)))
        / llab.size, ("sgd", {"learning_rate": TRAIN_LR, "momentum": 0.9}),
        1, failures))

    def make_resnet():
        net = vision.resnet50_v1(classes=1000)
        net.initialize(mx.init.Xavier(), ctx=gpu)
        net(mx.nd.zeros((1, 3, 224, 224), ctx=gpu))
        net.cast("bfloat16")
        return net

    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for tag, bsz, twice in (("resnet50_v1", RESNET_BATCHES[0], False),
                            ("resnet50_v1_called_twice", REC_TWICE_B,
                             True)):
        x = mx.nd.array(torch.rand((bsz, 3, 224, 224), generator=gen,
                                   device="cuda").bfloat16())
        y = mx.nd.array(torch.randint(0, 1000, (bsz,), generator=gen,
                                      device="cuda").float())
        if twice:
            def loss_of(n, x):
                return loss_fn(n(x), y) + loss_fn(n(x * 0.5), y)
        else:
            def loss_of(n, x):
                return loss_fn(n(x), y)
        add(tag, _rec_pair(torch, mx, fa, tag, make_resnet, (x,), loss_of,
                           ("sgd", {"learning_rate": RESNET_LR,
                                    "momentum": 0.9}), bsz, failures))
    twice_ok = rows["resnet50_v1_called_twice"]["graph_instances"] == [2]
    drop = mx.gluon.nn.Dropout(REC_DROP)
    drop.hybridize()
    ones = mx.nd.ones((REC_DROP_N,), ctx=gpu)
    ones.attach_grad()
    masks = []
    for _ in range(3):
        with mx.autograd.record():
            out = drop(ones)
        out.backward()
        masks.append(out._data != 0)
    keep = [float(m.float().mean()) for m in masks]
    fresh = not torch.equal(masks[1], masks[2])
    drop_ok = fresh and drop.cache_stats()["hits"] == 2 and all(
        abs(k - (1 - REC_DROP)) < 0.01 for k in keep)
    ok = all(r["ok"] for r in rows.values()) and twice_ok and drop_ok
    emit(dict(phase="recorded_graphs", card=STASH["smi"], runs=rows,
              called_twice_instances_ok=twice_ok,
              dropout=dict(rate=REC_DROP, units=REC_DROP_N,
                           keep_rates=keep, fresh_masks=fresh, ok=drop_ok),
              launches=dict(zip(("fwd", "dq", "dkv"), launches)), ok=ok))
    if not (twice_ok and drop_ok):
        failures.append(f"30a: twice-called instances {twice_ok}, dropout "
                        f"keep {keep}, fresh {fresh}")
    del masks, ones, drop
    free_card(torch)
    return launches, mma


def _gs_prompts(vocab, radix):
    rng = np.random.RandomState(SEED + 231)
    if radix:
        pre = rng.randint(1, vocab, size=GS_PREFIX)
        return [np.concatenate([pre, rng.randint(1, vocab, size=n)])
                .astype(np.int32) for n in (40, 200, 300)]
    return [rng.randint(1, vocab, size=n).astype(np.int32)
            for n in GS_LENGTHS]


def _gs_serve(mx, serving, net, prompts, naive, radix=False, max_batch=4,
              min_length=GS_MIN_LENGTH, **kw):
    """Serve ``prompts`` (GS_NEW tokens each) twice in one server, with
    the engine's programs eager (the NaiveEngine) or graphed; the radix
    mode's first prompt goes alone first, so that the others find its
    prefix.  The first wave captures the graphs the build did not, the
    second replays them.  Returns (both waves' replies, stats, the
    second wave's TTFTs in ms, the engine's graph pools, its KV pool
    bytes, wall s, and the build's seconds, whether it captured the
    whole prefill/scatter table, the programs captured while serving,
    the graphs' budget)."""
    prev = mx.engine.engine_type()
    if naive:
        mx.engine.set_engine_type("NaiveEngine")
    try:
        cfg = serving.ServerConfig(max_batch=max_batch,
                                   max_length=SERVE_MAX_LEN,
                                   min_length=min_length,
                                   num_slots=SERVE_SLOTS,
                                   block_size=SERVE_BLOCK, **kw)
        t = time.perf_counter()
        srv = serving.GenerativeServer(net, cfg)
        built_s = time.perf_counter() - t
        built = set(srv.engine.graph_pool_bytes())
        replies = []
        with srv:
            for wave in range(2):
                head = prompts[:1] if radix and wave == 0 else []
                for group in (head, prompts[len(head):]):
                    replies += [f.result(600) for f in
                                [srv.submit(p, max_new_tokens=GS_NEW)
                                 for p in group]]
            stats = srv.stats()
        wall = time.perf_counter() - t
        ttft = [r["ttft_ms"] for r in srv.request_records()][len(prompts):]
        pools = srv.engine.graph_pool_bytes()
        kv = srv.engine.kv_pool_bytes()
        sigs = cfg.policy.signatures()
        table = {(p, kb, lb) for p in ("prefill", "scatter")
                 for kb, lb in sigs}
        if radix:
            table |= {("gather", kb, lp) for kb, lp in sigs}
            table |= {("prefill_sfx", kb, lp, lb) for kb, lp in sigs
                      for kb2, lb in sigs if kb2 == kb}
        extra = dict(build_s=built_s, table_captured_at_build=table <= built,
                     captured_while_serving=len(set(pools) - built),
                     graph_budget=srv.engine._graph_budget)
        del srv
        return replies, stats, ttft, pools, kv, wall, extra
    finally:
        mx.engine.set_engine_type(prev)


def serving_graphs_phase(torch, mx, serving, net, failures):
    """Phase 30b: the serving engine's programs as CUDA graphs, on phase
    8's ``llama3_8b`` (32 layers, bf16).  First one paged engine with a
    speculative window of 3, eager (the NaiveEngine) and graphed: each
    GS_BUCKETS prefill and the verify program timed (GS_REPS calls after
    two), and the graph pools' bytes beside ``kv_pool_bytes``.  Then
    GenerativeServer in the paged, slots, radix, speculative (the net as
    its own draft, spec_k=3) and int8 modes, eager and graphed, on three
    prompts (GS_LENGTHS; the radix mode's share a GS_PREFIX-token
    prefix) served twice, the second wave replaying what the first
    captured: the greedy tokens equal, token for token; the second
    wave's TTFTs; the graphed server's ``compiled_signatures``.  The
    paged, radix and int8 servers (int8 at batch 1, radix at batch 1-2
    from 512 tokens) capture their whole bucket table (lengths GS_MIN_LENGTH to
    SERVE_MAX_LEN) when built and nothing while serving, and the
    engine's graph memory (its pool's growth at every capture and the
    two arenas) stays within ``cuda_graph.budget``."""
    from mxnet_tpu_torch.serving import generative

    free_card(torch)
    vocab = net.config.vocab_size
    rng = np.random.RandomState(SEED + 232)
    timing, pools = {}, {}
    for naive in (True, False):
        prev = mx.engine.engine_type()
        if naive:
            mx.engine.set_engine_type("NaiveEngine")
        try:
            eng = generative.LlamaServingEngine(
                net, max_len=SERVE_MAX_LEN, num_slots=SERVE_SLOTS,
                kv_mode="paged", block_size=SERVE_BLOCK, spec_k=3)
            route = "eager" if naive else "graphed"
            res = {}
            for kb, lp in GS_BUCKETS:
                ids = rng.randint(1, vocab, size=(kb, lp)).astype(np.int32)
                t0s = np.full(kb, lp, np.int32)
                ms = []
                for _ in range(GS_REPS + 2):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    toks, rows = eng.prefill_rows(ids, t0s)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t) * 1e3)
                    del rows
                res[f"prefill_{kb}x{lp}_ms"] = sum(ms[2:]) / GS_REPS
            drafts = np.zeros((SERVE_SLOTS, 3), np.int32)
            ms = []
            for _ in range(GS_REPS + 2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                eng.verify(drafts)
                ms.append((time.perf_counter() - t) * 1e3)
            res["verify_ms"] = sum(ms[2:]) / GS_REPS
            res["kv_pool_bytes"] = eng.kv_pool_bytes()
            res["graph_bytes_total"] = sum(eng.graph_pool_bytes().values())
            res["graph_pool_bytes"] = {
                "/".join(map(str, k)): v
                for k, v in eng.graph_pool_bytes().items()}
            timing[route] = res
            del eng
            free_card(torch)
        finally:
            mx.engine.set_engine_type(prev)
    modes = {"paged": {"capture_buckets": True},
             "slots": {"kv_mode": "slots"},
             # its table is cubic in the lengths: batch 1-2 from 512
             "radix": {"radix_cache": True, "capture_buckets": True,
                       "min_length": 512, "max_batch": 2},
             "speculative": {"draft_net": net, "spec_k": 3},
             # int8's f32 products make its prefill ~10x bf16's: its
             # table is the batch-1 row
             "int8": {"int8": True, "capture_buckets": True,
                      "max_batch": 1}}
    runs, equal = {}, True
    for mode, kw in modes.items():
        prompts = _gs_prompts(vocab, mode == "radix")
        got = {}
        for naive in (True, False):
            got["eager" if naive else "graphed"] = _gs_serve(
                mx, serving, net, prompts, naive, mode == "radix", **kw)
            free_card(torch)
        same = all(np.array_equal(a, b) for a, b in
                   zip(got["eager"][0], got["graphed"][0]))
        equal = equal and same
        runs[mode] = dict(
            tokens_equal=same,
            ttft_ms={k: v[2] for k, v in got.items()},
            wall_s={k: v[5] for k, v in got.items()},
            kv_pool_bytes=got["graphed"][4],
            graph_bytes_total=sum(got["graphed"][3].values()),
            **got["graphed"][6],
            graph_pool_bytes={"/".join(map(str, k)): v
                              for k, v in got["graphed"][3].items()},
            compiled_signatures=[list(s) for s in
                                 got["graphed"][1]["compiled_signatures"]])
    kinds = {k.split("/")[0] for r in runs.values()
             for k in r["graph_pool_bytes"]}
    ok = equal and {"prefill", "scatter", "verify", "gather",
                    "prefill_sfx"} <= kinds and \
        not timing["eager"]["graph_pool_bytes"] and all(
            runs[m]["table_captured_at_build"] and
            runs[m]["captured_while_serving"] == 0 and
            runs[m]["graph_bytes_total"] <= runs[m]["graph_budget"]
            for m in ("paged", "radix", "int8"))
    emit(dict(phase="serving_graphs", card=STASH["smi"], layers=len(
        net.model.layers), engine=timing, servers=runs, ok=ok))
    if not ok:
        failures.append(f"30b: tokens equal {equal}, graphed programs "
                        f"{sorted(kinds)}")


def detector_export_phase(torch, mx, tc, failures):
    """Phase 30c: the detectors' export.  SSD-512 and YOLOv3 (bf16) and
    Faster R-CNN (f32) at B=1, with 23b-23d's weights: the hybridized
    block's forward, ``HybridBlock.export`` (its seconds), the program
    imported on the card (``SymbolBlock.imports``) and its forward:
    ids, scores and boxes equal to the live block's bit for bit, with
    ``nms_keep``'s launches through the program.  Also the custom op's
    host cost: ``nms_keep`` through ``torch.library``'s dispatcher
    against the ctypes launch it wraps (``_nms_keep_cuda``), at the
    kernels line's shape."""
    import tempfile

    from mxnet_tpu_torch.convert import load_numpy_params

    free_card(torch)
    tmp = tempfile.mkdtemp(prefix="mxt_export_det_")
    rows, launches, fused = {}, 0, [0, 0]
    cbr = sys.modules["mxnet_tpu_torch.ops.conv_bn_relu"]
    for name, (make, arrays, x, dtype) in STASH["det"].items():
        net = make()
        load_numpy_params(net, arrays, ctx=mx.gpu(0))
        if dtype != "float32":
            net.cast(dtype)
        x = x[-1][:1]
        net.hybridize()
        live = [o._data.clone() for o in net(x)]
        t = time.perf_counter()
        sym, params = net.export(os.path.join(tmp, name))
        export_s = time.perf_counter() - t
        block = mx.gluon.SymbolBlock.imports(sym, ["data"], params,
                                             ctx=mx.gpu(0))
        tc.nms_keep.launches = 0
        f0 = (cbr.fused_matmul_affine_relu.launches,
              cbr.fused_matmul_affine_relu.launches_mma)
        outs = [o._data for o in block(x)]
        torch.cuda.synchronize()
        nms = tc.nms_keep.launches
        launches += nms
        fused = [fused[0] + cbr.fused_matmul_affine_relu.launches - f0[0],
                 fused[1] + cbr.fused_matmul_affine_relu.launches_mma -
                 f0[1]]
        equal = all(torch.equal(a, b) for a, b in zip(outs, live))
        rows[name] = dict(dtype=dtype, export_s=export_s,
                          nms_launches_a_forward=nms, bit_equal=equal,
                          kept_rows=int((live[0] >= 0).sum()),
                          ok=equal and nms > 0)
        del net, block, live, outs
        free_card(torch)
    g, n, cls = NMS_MAIN
    gen = torch.Generator().manual_seed(SEED + 233)
    boxes = _det_boxes(torch, gen, (g, n), 512.0, wh=(10.0, 150.0)).cuda()
    valid = (torch.rand((g, n), generator=gen) > 0.1).cuda()
    ids = torch.randint(0, DET_CLASSES, (g, n),
                        generator=gen).float().cuda() if cls else None
    op_us = host_us(torch, lambda: tc.nms_keep(boxes, valid, ids, 0.45),
                    200)
    direct_us = host_us(torch, lambda: tc._nms_keep_cuda(boxes, valid, ids,
                                                         0.45), 200)
    same = torch.equal(tc.nms_keep(boxes, valid, ids, 0.45),
                       tc._nms_keep_cuda(boxes, valid, ids, 0.45))
    ok = all(r["ok"] for r in rows.values()) and same
    emit(dict(phase="detector_export", card=STASH["smi"], nets=rows,
              nms_host_us=dict(custom_op=op_us, ctypes_launch=direct_us,
                               at=dict(G=g, n=n, class_ids=cls),
                               same_mask=same), ok=ok))
    if not ok:
        failures.append(f"30c: {rows}, op and launch masks equal {same}")
    return launches, fused


def offload_mesh_phase(torch, mx, llama, fa, mt, parallel, failures):
    """Phase 30d: ``Trainer(offload="host")`` over a mesh.  A one-rank
    NCCL group, mesh {dp: 1, tp: 1}, ``LLAMA_RULES``, the ``dist_sync``
    store; ``llama3_8b`` at OFFMESH_LAYERS layers, bf16 with f32 masters,
    SGD with momentum, B=1, T=2048: the offloaded mesh trainer against
    the on-device mesh trainer from one state for OFFMESH_STEPS steps,
    the weights bit-equal after each; the step ms and the H2D/D2H bytes
    of each step."""
    from mxnet_tpu_torch.memory import offload

    free_card(torch)
    offload.reset()
    parallel.initialize(f"127.0.0.1:{parallel.free_port()}", 1, 0)
    try:
        mesh = parallel.make_mesh({"dp": 1, "tp": 1})
        pair = []
        _zero_counts(fa)  # 30d's path starts here
        mt.multi_tensor_update.launches = 0
        for off in (None, "host"):
            mx.random.seed(SEED)
            net = llama.llama3_8b(num_layers=OFFMESH_LAYERS)
            net.cast("bfloat16")
            net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
            tr = mx.gluon.Trainer(
                net.collect_params(), "sgd",
                {"learning_rate": TRAIN_LR, "momentum": 0.9,
                 "multi_precision": True}, kvstore="dist_sync",
                partition_rules=parallel.LLAMA_RULES, mesh=mesh,
                offload=off)
            pair.append((net, tr))
        ids, labels = _ids_labels(torch, mx, pair[0][0].config.vocab_size,
                                  2048, SEED + 5)
        ids = parallel.shard_batch(ids, mesh)
        labels = parallel.shard_batch(labels, mesh)
        rows, equal, totals, mma, upd = [], True, [0, 0, 0], [0, 0, 0], 0
        for step in range(OFFMESH_STEPS):
            got = [_offload_step(torch, mx, fa, mt, offload, net, tr, ids,
                                 labels) for net, tr in pair]
            same = all(torch.equal(parallel.local(a.data()._data),
                                   parallel.local(b.data()._data))
                       for a, b in zip(pair[0][0].collect_params().values(),
                                       pair[1][0].collect_params().values()))
            equal = equal and same and got[0]["loss"] == got[1]["loss"]
            rows.append(dict(step=step, device=got[0], offloaded=got[1],
                             weights_equal=same))
            for g in got:
                totals = [a + b for a, b in zip(totals, g["launches"])]
                mma = [a + b for a, b in zip(mma, g["launches_mma"])]
                upd += g["update_launches"]
        states = [a for i in pair[1][1]._live()
                  for a in pair[1][1]._offloaded_ndarrays(i)]
        stashed = all(offload.is_stashed(a) for a in states)
        ok = equal and stashed and offload.resident_bytes() > 0
        emit(dict(phase="offload_mesh", card=STASH["smi"],
                  layers=OFFMESH_LAYERS, mesh={"dp": 1, "tp": 1},
                  steps=rows, states_stashed=stashed,
                  resident_bytes=offload.resident_bytes(), ok=ok))
        if not ok:
            failures.append(f"30d offload over a mesh: equal {equal}, "
                            f"stashed {stashed}: {rows}")
        del pair, states
    finally:
        parallel.shutdown()
        free_card(torch)
        offload.reset()
    return totals, mma, upd


def _bulk_run(torch, mx, fn, n):
    """``fn()`` under ``engine.bulk(n)`` (n > 1) or unbulked, timed to the
    card's end, with the telemetry step record around it: (its result,
    ms, the record's ``bulk_flush``, its flush counters)."""
    tel = mx.telemetry
    tel.enable(memory=False, cost=False)
    try:
        tel.step_begin()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if n > 1:
            with mx.engine.bulk(n):
                out = fn()
        else:
            out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        rec = tel.step_end()
    finally:
        tel.disable()
    reasons = {k[len("engine.bulk_flush."):]: v
               for k, v in rec["counters"].items()
               if k.startswith("engine.bulk_flush.")}
    return out, ms, rec["bulk_flush"], reasons


def bulk_phase(torch, mx, fm, failures):
    """Phase 30e: the engine's bulk segments (``engine.bulk(BULK_N)``, the
    async tier on) on three eager loops, each against the same loop
    unbulked from one state, BULK_STEPS times: SSD-512's B=1 bf16 forward
    (23b's weights, unhybridized), the word LM's step (unhybridized,
    dropout 0, ``clip_global_norm`` and the update outside ``record``)
    and the FM step (24b's model and store, unhybridized).  Each bulked
    result bit-equal to the unbulked one (the SSD rows; the word LM's
    weights and the FM tables after the steps); the ms of a step bulked
    and unbulked; the segment cache's hits and misses; ``bulk_flush`` and
    the flush reasons of the last bulked step."""
    from mxnet_tpu_torch.convert import load_numpy_params

    free_card(torch)
    engine = mx.engine
    tc = sys.modules["mxnet_tpu_torch.ops.contrib"]
    cbr = sys.modules["mxnet_tpu_torch.ops.conv_bn_relu"]
    rows, nms, fused = {}, 0, [0, 0]
    tc.nms_keep.launches = 0  # 30e's paths start here
    cbr.fused_matmul_affine_relu.launches = 0
    cbr.fused_matmul_affine_relu.launches_mma = 0

    def loop(name, make_state, step, same):
        nonlocal nms, fused
        res = {}
        for n in (1, BULK_N):
            state = make_state()
            engine.clear_segment_cache()
            ms = []
            for _ in range(BULK_STEPS):
                n0 = tc.nms_keep.launches
                f0 = (cbr.fused_matmul_affine_relu.launches,
                      cbr.fused_matmul_affine_relu.launches_mma)
                out, t, flushes, reasons = _bulk_run(
                    torch, mx, lambda: step(state), n)
                ms.append(t)
                if n > 1:
                    nms += tc.nms_keep.launches - n0
                    fused = [
                        fused[0] + cbr.fused_matmul_affine_relu.launches -
                        f0[0], fused[1] +
                        cbr.fused_matmul_affine_relu.launches_mma - f0[1]]
            res[n] = dict(state=state, out=out, ms=ms, flushes=flushes,
                          reasons=reasons,
                          cache=engine.segment_cache_stats())
        equal = same(res[1], res[BULK_N])
        rows[name] = dict(
            bit_equal=equal, unbulked_ms=res[1]["ms"],
            bulked_ms=res[BULK_N]["ms"],
            segment_cache=res[BULK_N]["cache"],
            bulk_flush=res[BULK_N]["flushes"],
            flush_reasons=res[BULK_N]["reasons"],
            ok=equal and res[BULK_N]["flushes"] > 0 and
            res[BULK_N]["cache"]["hit"] > 0)
        del res
        free_card(torch)

    make_ssd, arrays, xs, dtype = STASH["det"]["ssd_512_resnet50_v1"]

    def ssd_state():
        net = make_ssd()
        load_numpy_params(net, arrays, ctx=mx.gpu(0))
        net.cast(dtype)
        return net

    loop("ssd_512_resnet50_v1_b1", ssd_state,
         lambda net: [o._data for o in net(xs[-1][:1])],
         lambda a, b: all(torch.equal(x, y)
                          for x, y in zip(a["out"], b["out"])))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 234)
    x = mx.nd.array(torch.randint(0, WLM_VOCAB, (WLM_BPTT, BULK_WLM_B),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32))
    y = mx.nd.array(torch.randint(0, WLM_VOCAB, (WLM_BPTT, BULK_WLM_B),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tokens = WLM_BPTT * BULK_WLM_B

    def wlm_state():
        mx.random.seed(SEED)
        net = _word_lm(mx, 0.0)
        net.initialize(mx.init.Uniform(0.1), ctx=mx.gpu(0))
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": WLM_LR})
        return net, tr

    def wlm_step(state):
        net, tr = state
        params = [p for p in net.collect_params().values()
                  if p.grad_req != "null"]
        with mx.autograd.record():
            loss = loss_fn(net(x).reshape((-1, WLM_VOCAB)),
                           y.reshape((-1,)))
        loss.backward()
        mx.gluon.utils.clip_global_norm([p.grad() for p in params],
                                        WLM_CLIP * tokens)
        tr.step(tokens)
        return loss.mean()

    loop("word_lm_step", wlm_state, wlm_step,
         lambda a, b: _params_equal(torch, a["state"][0], b["state"][0]))

    path = STASH["fm"]["path"]

    def fm_state():
        with mx.gpu(0):
            it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(FM_FEATURES,),
                                  batch_size=FM_B)
        kv = mx.kv.create("local")
        kv.set_optimizer(mx.optimizer.Adam(learning_rate=FM_LR))
        model = fm.FMModel(FM_FEATURES, FM_FACTOR, seed=SEED + 244,
                           kvstore=kv, ctx=mx.gpu(0))
        return model, iter(it)

    def fm_step(state):
        model, batches = state
        b = next(batches)
        return model.step(b.data[0], b.label[0])

    loop("fm_step", fm_state, fm_step,
         lambda a, b: all(torch.equal(u, v) for u, v in zip(
             _fm_tables(a["state"][0]).values(),
             _fm_tables(b["state"][0]).values())))
    ok = all(r["ok"] for r in rows.values())
    emit(dict(phase="bulk_segments", card=STASH["smi"], n=BULK_N,
              steps=BULK_STEPS, async_tier=engine.async_enabled(),
              loops=rows, ok=ok))
    if not ok:
        failures.append(f"30e bulk segments: {rows}")
    return nms, fused


def main():
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.models import bert, llama
    from mxnet_tpu_torch.ops import conv_bn_relu as cbr
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import multi_tensor as mt
    from mxnet_tpu_torch import checkpoint, serving

    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    STASH["smi"] = smi
    flags = torch.backends.cuda.matmul
    emit(dict(phase="card", nvidia_smi=smi,
              precision_flags={  # set by the package at import
                  "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                  "matmul.allow_tf32": flags.allow_tf32,
                  "matmul.allow_bf16_reduced_precision_reduction":
                      flags.allow_bf16_reduced_precision_reduction,
                  "matmul.allow_fp16_reduced_precision_reduction":
                      flags.allow_fp16_reduced_precision_reduction},
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), cpu_count=os.cpu_count(),
              torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              nvcc=run([_kernels.nvcc(), "--version"]).splitlines()[-1]))

    t = time.perf_counter()
    logs = _kernels.build(verbose=True)
    build_s = time.perf_counter() - t
    for name in _kernels.SOURCES:
        _kernels.load(name)
    emit(dict(phase="build", seconds=build_s, built=sorted(logs),
              ptxas=[ln.strip() for log in logs.values()
                     for ln in log.splitlines() if "registers" in ln]))

    failures = []
    if torch.backends.cudnn.allow_tf32 or flags.allow_tf32 or \
            flags.allow_bf16_reduced_precision_reduction or \
            flags.allow_fp16_reduced_precision_reduction:
        failures.append("a precision flag is on after importing the "
                        "package")
    rows = kernel_phase(torch, fa, failures)
    brows = backward_phase(torch, fa, failures)
    fused = fused_kernel_phase(torch, cbr, failures)
    zoo = zoo_kernel_phase(torch, cbr, zoo_shapes(torch, mx, vision, cbr),
                           failures)
    mtrow = multi_tensor_phase(torch, mx, llama, mt, failures)
    f32_phase(torch, mx, llama, fa, failures)
    f32_train_phase(torch, mx, llama, fa, failures)
    bf16_phase(torch, mx, llama, fa, failures)
    fused_llama_phase(torch, mx, llama, fa, mt, checkpoint, failures)
    serving_f32_phase(torch, mx, llama, serving, failures)
    infer_launches, infer_mma, net = slice_phase(torch, mx, llama, fa,
                                                 failures)
    serving_bf16_phase(torch, mx, llama, serving, fa, net, failures)
    serving_mesh_phase(torch, mx, serving, net, failures)
    # slice 20: serving observability and the lock sanitizer (28a, 28d)
    serving_observability_phase(torch, mx, llama, serving, fa, net,
                                failures)
    # slice 23: the serving programs as graphs (30b)
    _phase(serving_graphs_phase, failures, None, torch, mx, serving, net)
    del net
    train_launches, train_mma, update_launches = train_phase(
        torch, mx, llama, fa, mt, failures)
    resnet_f32_phase(torch, mx, vision, cbr, failures)
    resnet18_f32_train_phase(torch, mx, vision, failures)
    fused_launches, fused_mma = resnet_infer_phase(torch, mx, vision, cbr,
                                                   failures)
    update_launches += resnet_train_phase(torch, mx, vision, cbr, mt,
                                          failures)
    update_launches += fused_resnet_phase(torch, mx, vision, mt, failures)
    bert_check_phase(torch, mx, bert, fa, failures)
    bert_launches, bert_mma, bert_updates = bert_train_phase(
        torch, mx, bert, fa, mt, failures)
    update_launches += bert_updates
    served, served_mma = resnet_serve_phase(torch, mx, vision, cbr, serving,
                                            failures)
    fused_launches += served
    fused_mma += served_mma
    bert_serve_phase(torch, mx, bert, fa, serving, failures)
    zoo_f32_phase(torch, mx, vision, cbr, failures)
    zoo_launches = zoo_infer_phase(torch, mx, vision, cbr, failures)
    fused_launches += sum(n for n, _ in zoo_launches.values())
    fused_mma += sum(n for _, n in zoo_launches.values())
    inception_train_phase(torch, mx, vision, cbr, mt, failures)
    eval_launches, eval_mma, lane_updates = image_lane_phase(
        torch, mx, vision, cbr, mt, failures)
    fused_launches += eval_launches
    fused_mma += eval_mma
    update_launches += lane_updates
    packed_launches, packed_mma, packed_updates = packed_llama_phase(
        torch, mx, llama, fa, failures)
    update_launches += packed_updates
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import ring

    mesh = nccl_phase(torch, mx, parallel, failures)
    mesh_launches, mesh_mma, mesh_updates = mesh_train_phase(
        torch, mx, llama, fa, mt, parallel, mesh, failures)
    update_launches += mesh_updates
    ulysses_launches, ulysses_mma = sp_bodies_phase(torch, mx, fa, ring,
                                                    failures)
    update_launches += classic_dp_phase(torch, mx, vision, mt, failures)
    pp_launches, pp_mma, pp_updates = pipeline_phase(torch, mx, llama, fa,
                                                     mt, failures)
    update_launches += pp_updates
    gm_launches, gm_mma, gm_updates = graph_mesh_phase(
        torch, mx, llama, vision, fa, mt, parallel, mesh, failures)
    update_launches += gm_updates
    sharded_checkpoint_phase(torch, mx, llama, checkpoint, parallel, mesh,
                             failures)
    from mxnet_tpu_torch.models import moe

    moe_check_phase(torch, mx, llama, moe, fa, failures)
    moe_infer = mixtral_infer_phase(torch, mx, llama, fa, failures)
    moe_train = mixtral_train_phase(torch, mx, llama, moe, fa, mt, failures)
    update_launches += moe_train[2]
    moe_ep = moe_mesh_phase(torch, mx, llama, moe, fa, mt, parallel, vision,
                            failures)
    update_launches += moe_ep[2]
    parallel.shutdown()
    # slice 14: int8 inference and recurrent nets
    int8_ops_phase(torch, mx, failures)
    int8_resnet_phase(torch, mx, vision, cbr, failures)
    int8_serve_phase(torch, mx, vision, serving, failures)
    int8_generative_phase(torch, mx, llama, serving, fa, failures)
    rnn_ops_phase(torch, mx, failures)
    update_launches += word_lm_phase(torch, mx, mt, failures)
    update_launches += ctc_phase(torch, mx, mt, failures)
    # slice 15: detection
    from mxnet_tpu_torch.gluon.model_zoo import detection
    from mxnet_tpu_torch.ops import contrib as tc

    nms_row = detection_ops_phase(torch, mx, tc, failures)
    det = {"ssd_512_resnet50_v1": ssd_infer_phase(
               torch, mx, detection, cbr, tc, failures),
           "faster_rcnn_resnet50_v1": frcnn_infer_phase(
               torch, mx, detection, cbr, tc, failures),
           "yolo3_darknet53": yolo_infer_phase(
               torch, mx, detection, cbr, tc, failures)}
    update_launches += ssd_train_phase(torch, mx, detection, mt, failures)
    det_launches = sum(v[0] for v in det.values())
    fused_launches += det_launches
    fused_mma += sum(v[1] for v in det.values())
    nms_launches = sum(v[2] for v in det.values())
    if 0 in [v[2] for v in det.values()] or nms_row is None:
        failures.append(f"a detector launched no nms_keep: {det}")
    # slice 16: sparse storage (the CSR products on csr_dense_dot)
    from mxnet_tpu_torch.models import fm

    from mxnet_tpu_torch.ndarray import sparse as tsp

    csr_row = sparse_ops_phase(torch, mx, failures)
    # the sparse main paths start here
    tsp.csr_dense_dot.launches = tsp.csr_dense_dot.launches_transposed = 0
    fm_phase(torch, mx, fm, mt, failures)
    sparse_linear_phase(torch, mx, failures)
    fm_stores_phase(torch, mx, fm, parallel, failures)
    profile_phase(torch, mx, fm, vision, failures)
    csr_launches = tsp.csr_dense_dot.launches  # ... and end here
    csr_launches_t = tsp.csr_dense_dot.launches_transposed
    if 0 in (csr_launches, csr_launches_t):
        failures.append(f"the sparse paths launched no csr_dense_dot "
                        f"({csr_launches} forward, {csr_launches_t} "
                        "transposed)")
    # slice 17: symbols and export
    update_launches += symbol_module_phase(torch, mx, vision, mt, failures)
    exp_fused = export_resnet_phase(torch, mx, vision, cbr, serving,
                                    failures)
    fused_launches += exp_fused[0]
    fused_mma += exp_fused[1]
    exp_flash = export_bert_phase(torch, mx, bert, fa, failures)
    checkpoint_quant_phase(torch, mx, failures)
    if 0 in (exp_fused[0], exp_flash[0]):
        failures.append(f"an exported program launched no kernel: #4 "
                        f"{exp_fused}, #1 {exp_flash}")
    # slice 18: the NumPy front end, custom ops, the Estimator, the tools
    est, est_mma = estimator_bert_phase(torch, mx, bert, fa, mt, failures)
    update_launches += est[3]
    np_card_phase(torch, mx, failures)
    custom_rtc_phase(torch, mx, failures)
    mon = tools_phase(torch, mx, vision, bert, cbr, failures)
    fused_launches += mon[0]
    fused_mma += mon[1]
    if 0 in est or mon[0] == 0:
        failures.append(f"slice 18 left a kernel unlaunched: fit {est}, "
                        f"monitored forward {mon}")
    # slice 19: training telemetry
    tel, tel_mma, tel_updates = telemetry_llama_phase(torch, mx, llama, fa,
                                                      mt, failures)
    update_launches += tel_updates
    mon_g = monitor_graph_phase(torch, mx, vision, cbr, failures)
    fused_launches += mon_g[0]
    fused_mma += mon_g[1]
    memwatch_phase(torch, mx, vision, failures)
    timeline_phase(torch, mx, bert, failures)
    if 0 in tel or tel_updates == 0 or mon_g[0] == 0:
        failures.append(f"slice 19 left a kernel unlaunched: 27a {tel}, "
                        f"updates {tel_updates}, 27b {mon_g}")
    # slice 20: stateless serving under tracing (28b), the fleet
    # watchdog on a training step (28c)
    obs_bert, obs_resnet = stateless_observability_phase(
        torch, mx, bert, vision, cbr, fa, serving, failures)
    fused_launches += obs_resnet[0]
    fused_mma += obs_resnet[1]
    obs_fleet, obs_fleet_mma, obs_updates = fleet_llama_phase(
        torch, mx, llama, fa, mt, parallel, failures)
    update_launches += obs_updates
    if 0 in (obs_bert[0], obs_resnet[0], obs_updates) or 0 in obs_fleet:
        failures.append(f"slice 20 left a kernel unlaunched: 28b #1 "
                        f"{obs_bert}, #4 {obs_resnet}, 28c {obs_fleet}, "
                        f"updates {obs_updates}")
    # slice 21: memory as a managed budget (29a-29d)
    from mxnet_tpu_torch import memory

    memory_plan_phase(torch, mx, memory, failures)
    lad, lad_mma, lad_upd, act_none = remat_ladder_phase(
        torch, mx, llama, fa, mt, memory, failures)
    full, full_mma, full_upd = full_depth_phase(
        torch, mx, llama, fa, mt, memory, act_none, failures)
    off, off_mma, off_upd = offload_phase(torch, mx, llama, fa, mt, memory,
                                          failures)
    update_launches += lad_upd + full_upd + off_upd
    mem = [a + b + c for a, b, c in zip(lad, full, off)]
    mem_mma = [a + b + c for a, b, c in zip(lad_mma, full_mma, off_mma)]
    if 0 in mem or 0 in (lad_upd, full_upd, off_upd):
        failures.append(f"slice 21 left a kernel unlaunched: 29b {lad}, "
                        f"29c {full}, 29d {off}, updates "
                        f"{(lad_upd, full_upd, off_upd)}")
    # slice 23: graphed recorded forwards (30a), the detectors' export
    # (30c), host offload over a mesh (30d), bulk segments (30e)
    rec, rec_mma = _phase(recorded_graph_phase, failures,
                          ([0, 0, 0], [0, 0, 0]), torch, mx, bert, llama,
                          vision, fa)
    exp_nms, exp_det = _phase(detector_export_phase, failures,
                              (0, [0, 0]), torch, mx, tc)
    offm, offm_mma, offm_upd = _phase(
        offload_mesh_phase, failures, ([0, 0, 0], [0, 0, 0], 0), torch, mx,
        llama, fa, mt, parallel)
    update_launches += offm_upd
    bulk_nms, bulk_fused = _phase(bulk_phase, failures, (0, [0, 0]), torch,
                                  mx, fm)
    nms_launches += exp_nms + bulk_nms
    fused_launches += exp_det[0] + bulk_fused[0]
    fused_mma += exp_det[1] + bulk_fused[1]
    mem = [a + b + c for a, b, c in zip(mem, rec, offm)]
    mem_mma = [a + b + c for a, b, c in zip(mem_mma, rec_mma, offm_mma)]
    if 0 in rec or 0 in offm or 0 in (exp_nms, bulk_nms, offm_upd):
        failures.append(f"slice 23 left a kernel unlaunched: 30a {rec}, "
                        f"30c nms {exp_nms}, 30d {offm} updates {offm_upd}, "
                        f"30e nms {bulk_nms}")
    if update_launches == 0:
        failures.append("the training paths launched no multi-tensor "
                        "update")

    s, bs = rows[0], brows[0]
    sb = next(r for r in rows if r["shape"] == "bert")
    bb = next(r for r in brows if r["shape"] == "bert")
    src = "mxnet_tpu_torch/csrc/flash_attention_{}.cu"
    replaces = "mxnet_tpu/ops/flash_attention.py:{}"
    # each kernel: the design that ran at the Llama slice shape (the
    # forward's shapes for the fused kernel), its time and bound at
    # BERT-base's shape beside them, and the main paths' launches of each
    # design (the f32 FMA design's are the rest)
    # the MoE paths: 20b's forwards and generates (#1 only), 20c's eager
    # steps and 20d's ep-route steps
    moe_tr = [a + b for a, b in zip(moe_train[0], moe_ep[0])]
    moe_tr_mma = [a + b for a, b in zip(moe_train[1], moe_ep[1])]
    fwd_launches = infer_launches + train_launches[0] + bert_launches[0] + \
        packed_launches[0] + mesh_launches[0] + ulysses_launches[0] + \
        pp_launches[0] + gm_launches[0] + moe_infer[0] + moe_tr[0] + \
        exp_flash[0] + est[0] + tel[0] + obs_bert[0] + obs_fleet[0] + \
        mem[0]
    fwd_mma = infer_mma + train_mma[0] + bert_mma[0] + packed_mma[0] + \
        mesh_mma[0] + ulysses_mma[0] + pp_mma[0] + gm_mma[0] + \
        moe_infer[1] + moe_tr_mma[0] + exp_flash[1] + est_mma[0] + \
        tel_mma[0] + obs_bert[1] + obs_fleet_mma[0] + mem_mma[0]
    dq_launches = train_launches[1] + bert_launches[1] + \
        packed_launches[1] + mesh_launches[1] + ulysses_launches[1] + \
        pp_launches[1] + gm_launches[1] + moe_tr[1] + est[1] + tel[1] + \
        obs_fleet[1] + mem[1]
    dq_mma = train_mma[1] + bert_mma[1] + packed_mma[1] + mesh_mma[1] + \
        ulysses_mma[1] + pp_mma[1] + gm_mma[1] + moe_tr_mma[1] + \
        est_mma[1] + tel_mma[1] + obs_fleet_mma[1] + mem_mma[1]
    dkv_launches = train_launches[2] + bert_launches[2] + \
        packed_launches[2] + mesh_launches[2] + ulysses_launches[2] + \
        pp_launches[2] + gm_launches[2] + moe_tr[2] + est[2] + tel[2] + \
        obs_fleet[2] + mem[2]
    dkv_mma = train_mma[2] + bert_mma[2] + packed_mma[2] + mesh_mma[2] + \
        ulysses_mma[2] + pp_mma[2] + gm_mma[2] + moe_tr_mma[2] + \
        est_mma[2] + tel_mma[2] + obs_fleet_mma[2] + mem_mma[2]
    if moe_infer[0] == 0 or 0 in moe_tr:
        failures.append(f"the MoE paths left a kernel unlaunched: "
                        f"{moe_infer}, {moe_tr}")
    bert_fwd = dict(ms=sb["kernel_ms"], bound_ms=sb["bound_ms"],
                    bound_by=sb["bound_by"], plain_ms=sb["plain_ms"],
                    library_ms=sb["library_ms"],
                    max_abs_err=sb["max_abs_err_o"])
    bert_dq = dict(ms=bb["dq_ms"], bound_ms=bb["dq_bound_ms"],
                   bound_by=bb["dq_bound_by"], plain_ms=bb["plain_ms"],
                   library_ms=bb["library_ms"],
                   max_abs_err=bb["max_abs_err_dq"])
    bert_dkv = dict(ms=bb["dkv_ms"], bound_ms=bb["dkv_bound_ms"],
                    bound_by=bb["dkv_bound_by"], plain_ms=bb["plain_ms"],
                    library_ms=bb["library_ms"],
                    max_abs_err=max(bb["max_abs_err_dk"],
                                    bb["max_abs_err_dv"]))
    emit({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": src.format("fwd"), "replaces": replaces.format(132),
         "design": design_name(s["design"], s["dtype"]),
         "launches": fwd_launches, "launches_mma": fwd_mma,
         "launches_fma": fwd_launches - fwd_mma,
         "launches_bert": bert_launches[0], "at_bert_shape": bert_fwd,
         "launches_mesh": mesh_launches[0],
         "launches_ulysses": ulysses_launches[0],
         "launches_pipeline": pp_launches[0],
         "launches_graph_mesh": gm_launches[0],
         "launches_moe": moe_infer[0],
         "launches_moe_train": moe_tr[0],
         "launches_exported": exp_flash[0],
         "launches_estimator": est[0],
         "launches_telemetry": tel[0],
         "launches_observability": obs_bert[0] + obs_fleet[0],
         "launches_memory": mem[0],
         "launches_recorded_graphs": rec[0],
         "max_abs_err": s["max_abs_err_o"], "ms": s["kernel_ms"],
         "tflops": s["tflops"],
         "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
         "bound_by": s["bound_by"], "library_ms": s["library_ms"]},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": src.format("bwd"), "replaces": replaces.format(259),
         "design": design_name(bs["dq_design"], bs["dtype"]),
         "launches": dq_launches, "launches_mma": dq_mma,
         "launches_fma": dq_launches - dq_mma,
         "launches_bert": bert_launches[1], "at_bert_shape": bert_dq,
         "launches_mesh": mesh_launches[1],
         "launches_ulysses": ulysses_launches[1],
         "launches_pipeline": pp_launches[1],
         "launches_graph_mesh": gm_launches[1],
         "launches_moe": 0,
         "launches_moe_train": moe_tr[1],
         "launches_estimator": est[1],
         "launches_telemetry": tel[1],
         "launches_observability": obs_fleet[1],
         "launches_memory": mem[1],
         "launches_recorded_graphs": rec[1],
         "max_abs_err": bs["max_abs_err_dq"], "ms": bs["dq_ms"],
         "tflops": bs["dq_tflops"],
         "plain_ms": bs["plain_ms"], "bound_ms": bs["dq_bound_ms"],
         "bound_by": bs["dq_bound_by"], "library_ms": bs["library_ms"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": src.format("bwd"), "replaces": replaces.format(302),
         "design": design_name(bs["dkv_design"], bs["dtype"]),
         "launches": dkv_launches, "launches_mma": dkv_mma,
         "launches_fma": dkv_launches - dkv_mma,
         "launches_bert": bert_launches[2], "at_bert_shape": bert_dkv,
         "launches_mesh": mesh_launches[2],
         "launches_ulysses": ulysses_launches[2],
         "launches_pipeline": pp_launches[2],
         "launches_graph_mesh": gm_launches[2],
         "launches_moe": 0,
         "launches_moe_train": moe_tr[2],
         "launches_estimator": est[2],
         "launches_telemetry": tel[2],
         "launches_observability": obs_fleet[2],
         "launches_memory": mem[2],
         "launches_recorded_graphs": rec[2],
         "max_abs_err": max(bs["max_abs_err_dk"], bs["max_abs_err_dv"]),
         "ms": bs["dkv_ms"], "tflops": bs["dkv_tflops"],
         "plain_ms": bs["plain_ms"],
         "bound_ms": bs["dkv_bound_ms"], "bound_by": bs["dkv_bound_by"],
         "library_ms": bs["library_ms"]},
        {"name": "fused_matmul_affine_relu", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/fused_matmul_affine_relu.cu",
         "replaces": "tools/pallas_conv_probe.py:35",
         "design": design_name(fused["design"], "bfloat16"),
         "launches": fused_launches, "launches_mma": fused_mma,
         "launches_fma": fused_launches - fused_mma,
         "launches_served": served, "launches_eval": eval_launches,
         "launches_detection": det_launches,
         "launches_detection_by_net": {k: v[0] for k, v in det.items()},
         "launches_exported": exp_fused[0],
         "launches_monitor": mon[0],
         "launches_monitor_graph": mon_g[0],
         "launches_observability": obs_resnet[0],
         "launches_exported_detectors": exp_det[0],
         "launches_bulk": bulk_fused[0],
         "max_abs_err": fused["max_abs_err"],
         "ms": fused["kernel_ms"], "tflops": fused["tflops"],
         "plain_ms": fused["plain_ms"],
         "bound_ms": fused["bound_ms"], "bound_by": fused["bound_by"],
         "library_ms": fused["library_ms"]},
        *[{"name": "fused_matmul_affine_relu", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/fused_matmul_affine_relu.cu",
           "replaces": "tools/pallas_conv_probe.py:35",
           "design": design_name("mma", "bfloat16"), "net": name,
           "B": ZOO_B, "launches": zoo_launches[name][0],
           "launches_mma": zoo_launches[name][1],
           "max_abs_err": zoo[name]["max_abs_err"],
           "ms": zoo[name]["kernel_ms"], "plain_ms": zoo[name]["plain_ms"],
           "bound_ms": zoo[name]["bound_ms"],
           "bound_by": zoo[name]["bound_by"],
           "library_ms": zoo[name]["library_ms"],
           "gflop": zoo[name]["gflop"]} for name, _, _ in ZOO_FUSED],
        {"name": "multi_tensor_update", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/multi_tensor_update.cu",
         "replaces": "mxnet_tpu/gluon/trainer.py:516",
         "design": "one launch over a device table, bf16 SGD momentum",
         "launches_bert": bert_updates, "launches_estimator": est[3],
         "launches_telemetry": tel_updates,
         "launches_observability": obs_updates,
         "launches_memory": lad_upd + full_upd + off_upd,
         "launches_offload_mesh": offm_upd,
         "launches": update_launches, "max_abs_err": mtrow["max_abs_err"],
         "ms": mtrow["kernel_ms"], "plain_ms": mtrow["plain_ms"],
         "bound_ms": mtrow["bound_ms"], "bound_by": mtrow["bound_by"],
         "library_ms": mtrow["library_ms"]},
        {"name": "nms_keep", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/nms_keep.cu",
         "replaces": "mxnet_tpu/ops/contrib.py:84 (lax.fori_loop; no "
                     "Pallas kernel)",
         "design": "bitmask scan: the 64-bit suppression words of the "
                   "pair blocks on and above the diagonal, then a warp an "
                   "image walks them in word order",
         "at": dict(zip(("G", "n", "class_ids"), NMS_MAIN)),
         "launches": nms_launches,
         "launches_by_net": {k: v[2] for k, v in det.items()},
         "launches_exported": exp_nms, "launches_bulk": bulk_nms,
         "cuda_launches_a_call": nms_row["cuda_launches_a_call"],
         "max_abs_err": nms_row["max_abs_err"], "ms": nms_row["ms"],
         "device_ms": nms_row["device_ms"],
         "us_per_scanned_box": nms_row["us_per_scanned_box"],
         "plain_ms": nms_row["plain_ms"], "bound_ms": nms_row["bound_ms"],
         "bound_by": nms_row["bound_by"], "library_ms": None},
        *[{"name": "csr_dense_dot" if d == "forward" else
           "csr_dense_dot_transposed", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/csr_dense_dot.cu",
           "replaces": "mxnet_tpu/ndarray/sparse.py:587 (XLA's BCOO "
                       "matmul; no Pallas kernel)",
           "design": "a group of lanes a row (4 at n = 16), 16 gathers in "
                     "flight a lane while the next pairs load, the adds in "
                     "stored order, no atomics" +
                     ("" if d == "forward" else
                      ", on the column-ordered view (a stable sort)"),
           "at": dict(B=FM_B, features=FM_FEATURES, factor=FM_FACTOR,
                      nnz_per_row=FM_INT_FIELDS + FM_CAT_FIELDS),
           "launches": csr_launches if d == "forward" else csr_launches_t,
           "max_abs_err": csr_row[d]["max_abs_err"],
           "bit_equal": csr_row[d]["bit_equal"],
           **{k: csr_row[d][k] for k in (
               "ms", "device_ms", "plain_ms", "plain_device_ms",
               "library_ms", "library_device_ms", "bound_ms", "bound_by")}}
          for d in ("forward", "transposed")]]})
    emit(dict(phase="script", card=smi,
              seconds=time.perf_counter() - t_script))
    if failures:
        for f in failures:
            print("FAILED: " + f, file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
