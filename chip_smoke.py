"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout on a machine with a CUDA card.  It
builds the port's CUDA kernels from ``paddle_tpu_torch/csrc`` with
``nvcc`` (one process per source, all at once, into the git-ignored
``paddle_tpu_torch/_build/``) and then:

1. prints the card (``nvidia-smi`` name and power limit), the CUDA
   version and the kernel build time; turns TF32 off for the fp32
   phases;
2. ``[kernel]`` holds the split-K paged-attention kernel
   (``csrc/paged_attention_sm90.cu``) against its plain PyTorch version
   at GPT-2-small decode shapes with ragged lengths and scattered page
   tables in fp32 (within 1e-5 max abs error), bf16 and fp16, each
   element within half an ulp of the output dtype plus the fp32
   reorder bound and, in 16 bits, at least ``K1_SAME_MIN`` of the
   elements equal to the rounded plain output (:func:`paged_gate`);
   three broken outputs (one split left out of the combine, the tail
   mask off by one, a page id replaced by its neighbour) must fail that
   gate; empty rows exactly 0, two runs bitwise equal and equal to a
   third into a NaN-filled output, no ptxas spill; then at B=256 in fp32
   and bf16, a plan of one split (no combine launch) with every fourth
   row empty, and at the speculative verify's 40 rows (8 page tables
   each repeated 5 times, row (b, i) of length n_b + i + 1, one window
   past the table's reach) in fp32, bf16 and fp16 with the three
   controls.  Times the kernel (``torch.profiler`` device time and CUDA events,
   L2 flushed before each call) beside the kernel it replaced
   (``_cuda_core_paged``), the plain version, the bound and, as a
   yardstick only, ``scaled_dot_product_attention`` on pre-gathered
   K/V; ``[kernel long]`` does the same at the long-context tier's
   shape, every request 32768 tokens, with pages of 16 and 256 tokens
   (and ragged lengths up to 32768 in bf16, with the controls);
3. ``[flash]`` holds the three flash-attention kernels (forward, dq,
   dk/dv) against their plain versions: at the training path's shapes
   (B=8, S=1024, H=12, D=64, causal) as strided ``[B, S, H, D]`` views
   of a fused qkv tensor and in the ``[B*H, S, D]`` layout, in bf16
   (within 2e-2 x max(|ref|, 1)) and fp32 (within 1e-4 x max(|ref|, 1));
   then at awkward shapes in fp32: S=1000 (ragged tiles), non-causal
   Sq=384 != Sk=640, D=128, segment ids with fully-masked rows (output
   exactly 0), and GQA through the public ``flash_attention`` with
   gradients through autograd.  Times each kernel, its plain version
   and, as a yardstick only, ``scaled_dot_product_attention`` forward
   and forward+backward at the main shape in bf16;
4. ``[lmce]`` holds the three fused lm-head cross-entropy kernels
   (forward, dh, dW; for bf16 operands the tensor-core kernels, for
   fp32 the CUDA-core ones) against their plain versions
   computed in fp32 on the same values: at the training path's shape
   (N=8192, V=50304, D=768) in bf16 (within 2e-2 x max(|ref|, 1)) and
   fp32 (within 1e-4 x max(|ref|, 1)), then in fp32 at N=1000 (ragged
   rows) with V=1000 and V=786 (ragged vocab), every fourth label -100
   (loss and dh rows exactly 0), D=64, 200 and 2048.  Times the
   forward, its plain version and, as a yardstick only, ``h @ W.T``
   with fp32 ``F.cross_entropy``, forward and forward+backward, in
   bf16 (the backward's times are ``[lmce tc]``'s);
5. serves GPT-2-small (12 layers, hidden 768, 12 heads, vocab 50304,
   random weights from ``--seed``) through ``LLMServer`` in fp32:
   12 greedy requests over 8 slots, every decode dispatch a replay of
   the captured decode step and every prefill a replay of its (group
   bucket, prompt bucket) program (``warmup`` captures the decode
   step's greedy and mixed variants and the 28 prefill programs the 12
   prompt lengths reach; none may capture in the timed window);
   checks every token count, two captures, that the kernel
   launched exactly 12 times per decode dispatch, counted per replay
   (and the comparison entry ``_cuda_core_paged`` never), that two
   requests' tokens equal the sequential ``reference_decode``, and that
   a seeded sampled request (temperature 0.9, top-k 20, top-p 0.9) run
   after them equals ``reference_decode`` with the same settings;
   prints the capture seconds, the graph pool's size, the host
   microseconds a dispatch, and the timed window's prefill: host ms in
   its spans and device ms between CUDA events around each engine
   step's prefill work (:func:`prefill_timer`);
6. serves the same model in bf16 and checks counts, captures and
   launches; both serving phases end with a profiled window (8 requests
   of 41 tokens drained with the pump stopped): device-busy ms a
   dispatch and K1's device ms a call in the graph;
6'. ``[serve prefill capture fp32/bf16]``: GPT-2-small at full width
   (33280 positions), ``max_batch=8``, pages of 16, its pool filled with
   noise: the grouped programs at G = 1 and 8 and prompt buckets 16 and
   1024 (random lengths in the bucket, every other row sampled) and a
   chunk of 512 at contexts 4096 and 4112 (one block past a power of
   two, so its gather runs at twice its extent), each captured once and
   its replay held bit for bit against its eager body on the card (the
   tokens, and the pool outside the scratch block, where padding pages
   land), the request's pages and the scratch block the only blocks
   written, K1 never launched; prints capture seconds, the graph pool
   and each program's host ms (median) and device ms (profiled) a call
   beside its eager body's; ``[serve poll]``: the 12 requests in fp32
   with an EOS id (the fifth token of request 0's stream in 5) at the
   auto-tuned poll cadence and at a fixed interval of 8: the decision
   (interval, poll cost, ms a dispatch), both runs' tokens equal 5's
   cut at their first EOS;
6a. ``[serve spec fp32]`` / ``[serve spec bf16]``: the same 12 requests
   through ``LLMServer(draft_params=..., spec_k=4)``, with a self-draft
   and with an adversarial draft (weights from ``--seed`` + 1): two
   captures (the speculative greedy and mixed variants), K1 launched
   exactly 12 x 5 times a dispatch (per replay) and
   ``_cuda_core_paged`` never, every token count, the allocator empty
   after the drain; fp32: all 12 requests equal the plain fp32
   engine's tokens, two of them and a seeded sampled request equal
   ``reference_decode``; bf16: equal to the plain bf16 engine's tokens,
   or departing only where the two tokens' logits lie within
   ``BF16_GAP_ULPS`` bf16 ulps (printed), and every token, past any
   departure too, within ``BF16_GAP_ULPS`` of the argmax of its own
   prefix's teacher-forced logits.  Prints tokens/s beside the
   plain engine's, tokens per dispatch, the accept rate, capture
   seconds, the graph pool and the profiled window (K1's device ms a
   call at [B] and at [B*(k+1)] rows); ``[serve refresh]``:
   ``LLMServer(network)`` on the port's ``GPTForCausalLM``, then
   ``refresh_weights`` from a second network: a fresh server's tokens
   (the first from the captured prefill programs, which read the
   weights in place), no new capture;
6b. ``[serve noise]``: the sampler's hashed Gumbel noise of a
   ``[8, 50304]`` batch of (seed, position), bit for bit on the card
   and on the CPU;
6c. ``[serve long]``: GPT-2-small at full width with 33280 positions in
   bf16, ``max_batch=2``, pages of 256, ``prefill_chunk=1024``,
   ``prefix_cache=True`` (the JAX long-context tier's round (a),
   ``bench.py:1262-1400``, at full width): one 32512-token prompt
   (max_tokens 4, temperature 0.8, seed 1) admitted in 32 chunks, its
   TTFT and seconds per chunk (each step synchronised) and the chunks'
   host and device ms (the warm-up captured every (chunk, context)
   program of the phase's prompts, their repeats included, and none
   captures after it); the same prompt
   again (126 blocks from the prefix cache, one chunk) decoding 64
   tokens at a 32k context through K1: decode tokens/s, K1's launches
   per dispatch and, profiled, its device ms per launch; then
   ``[serve long fp32]``: a 4032-token prompt through
   ``prefill_chunk=512`` gives the same greedy tokens as the engine
   without chunking and as ``reference_decode``;
6d. ``[serve prefix]`` (round (b)): ``max_batch=4``, pages of 16,
   ``prefill_chunk=128``, ``prefix_cache=True``, bf16: 12 requests of a
   shared 512-token system prompt and 16 own tokens, one after the
   other; checks the hit and miss counts and prints the hit rate, the
   prompt tokens skipped and the synchronised TTFT of a miss and of
   the hits;
6e. ``[serve chunk gap]`` (round (c)): the inter-token gaps (p50, p99,
   max) of a 48-token stream, each token read as it comes, while a
   4032-token prompt is admitted with ``prefill_chunk=512`` and with
   the whole prompt at once (bf16, pages of 16), each run warmed once,
   with the admission's wall, device-busy ms and seconds a step, and the
   read run's prefill host and device ms; no capture after warm-up;
6f. ``[serve disagg fp32]`` / ``[serve disagg bf16]``: the 12 requests
   of 5/6 through a ``DisaggRouter`` over a prefill-role and a
   decode-role ``LLMServer`` (each warmed, each engine on its own CUDA
   stream), every request a page migration: fp32 tokens equal the
   role-both engine's of this run and ``reference_decode`` for two
   requests, bf16 tokens equal or departing within ``BF16_GAP_ULPS``
   (teacher-forced, as 6a); 12 migrations imported,
   ``exported_blocks == imported_blocks``, both allocators empty, K1
   launched 12 times per decode dispatch (per replay) and the prefill
   engine no dispatch and no decode capture, the decode engine at most
   2 captures, no prefill program captured after the warm-ups,
   ``_cuda_core_paged`` never; prints the prefill replica's prefill host
   and device ms beside role both's, tokens/s beside the
   role-both engine's, TTFT and inter-token p50/p99,
   ``serving_migration_s`` p50/p99 and the blocks migrated, and the
   export's and the import's device ms a migration (profiled window);
6g. ``[serve disagg gap]``: 6e's scenario through a ``DisaggRouter``
   (the stream hands off to the decode-role replica, the long prompt
   goes to the same prefill-role replica), the stream's inter-token
   p50/p99/max beside 6e's of this run and the prefill replica's
   prefill host and device ms, no capture after the warm-ups;
6h. ``[serve router]``: a ``ServingRouter`` over two role-both
   ``LLMServer`` replicas sharing the fp32 weights (``metrics_port=0``):
   tokens equal 5's, each replica serves some; ``control_round`` with
   the pumps idle under ``torch.cuda.set_sync_debug_mode("error")``;
   ``/metrics`` names both replicas' ``serving_tokens_total``,
   ``/events`` is a list, ``scrape(materialize=True)`` equals each
   engine's token count; prints the round's host microseconds;
7. ``[train]`` trains GPT-2-small at full width through
   ``Model.fit``: B=8, S=1024, dropout 0, ``amp.decorate(level="O2",
   dtype="bfloat16")``, ``AdamW(1e-4, multi_precision=True)``, random
   weights and tokens from ``--seed``, labels = tokens rolled by one,
   TRAIN_STEPS steps on one repeated batch.  Its per-step clock is a
   batch hook, so the fit resolves ``steps_per_dispatch`` to 1: one
   eager warm-up step, then the step captured into a CUDA graph and
   replayed once per step (one graph, one capture).  Checks finite
   losses, the last below the first, each flash kernel launched 12
   times per step (counted per replay) and no plain call; prints step
   ms, tokens/s and peak memory, a ``torch.profiler`` breakdown of one
   group of two more replays (the ten busiest "other" kernels by name
   beside the groups) and the memory left reserved once the model's
   graphs are freed (as every training phase does);
7b. ``[train eager]`` repeats 7 through the eager route
   (``steps_per_dispatch=0``): the same checks, every loss within 1e-2
   relative of 7's, and its step ms, tokens/s, peak memory and idle
   share beside 7's; ``[train fold]`` trains the same model with no
   per-step hook: a two-step fit that warms up and captures, then
   FOLD_STEPS steps at ``steps_per_dispatch=FOLD_K`` and FOLD_STEPS
   under auto-K, each synchronised only at its start and end (launches
   by replay, one graph, finite falling loss); prints the capture time,
   the graph pool's reserved memory, step ms and tokens/s of both, the
   tuner's decision, peak memory and a profile of one group of FOLD_K
   replays;
8. ``[train fused lmce]`` repeats 7 with ``enable_fused_lmce`` (the
   lm head and the loss in the three lmce kernels, the logits never in
   device memory): also checks each lmce kernel launched once per
   step, all three as the tensor-core kernels (``.tc``) and the
   CUDA-core forward and backward never, the first loss within 1e-2
   relative of
   7's and a lower peak; ``[train fp16]`` repeats 7 after
   ``amp.decorate(level="O2")`` with its default dtype, float16, and
   no GradScaler: finite losses, the launch checks of 7 and the first
   loss within 1e-2 relative of 7's;
9. ``[train fp32 parity]`` trains a small GPT (2 layers, hidden 128,
   head dim 64, S=256) for three steps on the card and on the CPU's
   plain path from the same weights and compares the losses, unfused
   and fused;
10. ``[flash bh]`` holds the ``[B*H, S, D]`` configuration's kernels,
    ``flash_fwd_hpack`` (head-packed forward) and ``flash_bwd_fused``
    (single-sweep backward), against their plain versions at GPT's
    ``[96, 1024, 64]`` causal and ERNIE's ``[192, 512, 64]`` non-causal
    shapes, in bf16 (within 2e-2 x max(|ref|, 1)) and fp32 (within
    1e-4 x max(|ref|, 1)), and in fp32 against ``flash_fwd`` and the
    split ``flash_bwd_dq`` + ``flash_bwd_dkv`` (within 1e-5 x
    max(|ref|, 1)); then in fp32 at S=1000, odd H with hp=2 (heads
    straddling batches), hp=4, segment ids with fully-masked rows
    (exactly 0) and, through the public ``flash_attention`` under the
    knobs, D=128, whose launches must show ``flash_fwd``, not the
    head-packed kernel.  Times each kernel, its plain version and, as
    a yardstick only, ``scaled_dot_product_attention`` forward (and
    forward+backward for the fused backward), and the ``[B*H, S, D]``
    layout copies;
11. ``[flash tc]`` holds the tensor-core forward of bf16
    ``flash_fwd`` and ``flash_fwd_hpack`` (``csrc/flash_fwd_sm90.cu``,
    ``wgmma`` fed by TMA) against ``flash_fwd_tc_reference`` (p rounded
    to bf16 as the kernel rounds it; within 1e-2 x max(|ref|, 1)) at
    GPT's ``[8, 1024, 12, 64]`` views and ``[96, 1024, 64]`` causal,
    ERNIE's ``[192, 512, 64]`` non-causal, S=1000, Sq != Sk, D=128,
    odd H with hp=2 (packs straddling batches), hp=4 and segment ids
    with a fully-masked row (out exactly 0, lse the floor); the
    head-packed kernel bitwise against ``flash_fwd``; counts the
    ``HGMMA`` instructions in the library's SASS and prints ptxas's
    registers and spills; times the kernels at the three main shapes
    beside the CUDA-core forward they replaced for bf16, the plain
    version and, as a yardstick only, SDPA, with the bound and
    TFLOP/s;
12. ``[flash tc bwd]`` holds the tensor-core split backward of bf16
    and fp16 ``flash_bwd_dq`` and ``flash_bwd_dkv``
    (``csrc/flash_bwd_sm90.cu``) against the plain versions (dS and p
    rounded to the input dtype, as the TPU kernels round them) at GPT's
    ``[8, 1024, 12, 64]`` views causal, ``[B*H, S, D]`` with segment ids
    and a fully-masked row (dq exactly 0), S=1000, non-causal Sq=384
    Sk=640 and D=128, element by element (:func:`flash_bwd_gate`: each
    element within rtol |ref| plus the bound of rounding each term once
    and of the fp32 sums' order, and at least ``TC_BWD_SAME_MIN`` of the
    elements equal to the plain version's in the 16-bit dtype), delta
    within its fp32 bound, two runs bitwise equal; at the main shape a
    backward with delta = 0 and one with dS and p unrounded must fail
    the same gate; counts the ``HGMMA`` instructions, prints ptxas's
    registers and spills (none allowed); times the pair at the main
    shape by CUDA events and by device time (``torch.profiler``) beside
    the CUDA-core pair it replaced for 16-bit inputs, the plain
    versions and, as a yardstick only, SDPA's backward alone;
12b. ``[flash tc fused]`` holds the tensor-core fused backward
    (``flash_bwd_fused`` on bf16 and fp16 at D 64/128, the fused sweep of
    ``csrc/flash_bwd_sm90.cu``) against ``flash_bwd_fused_reference``
    element by element with the same gate at GPT's ``[96, 1024, 64]``
    causal and ERNIE's ``[192, 512, 64]`` non-causal, segment ids with a
    fully-masked row (dq exactly 0), S=1000, Sq=384 != Sk=640 and D=128,
    with the delta = 0 and unrounded controls at GPT's shape (which must
    fail), two runs' dk and dv bitwise equal (dq's atomic reduce-adds may
    reorder); prints registers and spills (none allowed); times it at
    both main shapes by device time beside the CUDA-core sweep it
    replaced for 16-bit inputs, the tensor-core split pair and, as a
    yardstick only, SDPA's backward alone;
13. ``[train bh]`` repeats 7 with ``PADDLE_TORCH_FLASH_NO_PACKED=1``,
    ``HEADPACK=2`` and ``FUSED_BWD=1``: the two kernels launched 12
    times per step, both as the tensor-core kernels (the fused
    backward's pre-pass and bf16 epilogue as often), the default path's
    three flash kernels never, no plain call, the first loss within
    1e-2 relative of 7's;
14. ``[train ernie bh]`` trains ERNIE-3.0-base MLM (12 layers, hidden
    768, 12 heads, vocab 40000, random weights from ``--seed``) at
    B=16, S=512, bf16 O2, AdamW, dropout 0, under the same knobs,
    labels = the tokens on 15% of positions and -100 elsewhere, with
    the checks of 13 (the first loss against the default path's loss
    on the same weights and batch) and a profile;
15. ``[train fp32 parity bh]`` trains a small GPT and a small BERT
    (2 layers, hidden 128, head dim 64, S=256) for three fp32 steps on
    the card and on the CPU under the knobs and compares the losses
    (fp32 never launches the tensor-core forward);
15b. ``[train fold bh]`` repeats 7b's ``[train fold]`` under the
    ``[B*H, S, D]`` knobs; ``[train fold parity]`` fits the small GPT in
    fp32 and bf16 O2 and the small BERT under the knobs over
    FOLD_BATCHES distinct batches at K = 1, 4 and auto and through the
    eager route: end states (parameters, moments, beta powers, masters,
    step counts) bit-identical for every K, within 1e-4 x max(|ref|, 1)
    of the eager route in fp32, each K=4 group's losses distinct and
    equal to K=1's (the BERT run's fused backward adds dq with atomics
    in an order that changes from run to run, so its K's are held
    within that 1e-4, not bit for bit); with dropout 0.1, K=1 and K=4
    bit-identical with
    the generator's offset equal to the eager route's; two controls
    patched in by the phase (the optimizer's scalars as host floats,
    which the capture freezes; every loss slot of a group from the
    graph's one static loss) must fail those gates;
15c. ``[train resnet50]`` trains ResNet-50 ImageNet as ``bench.py:274-306``
    runs it, at full size: B=64 3x224x224 fp32 images and 1000 labels
    from ``--seed``, ``Momentum(0.1, 0.9, multi_precision=True)``,
    ``amp.decorate`` O2 bf16, ``CrossEntropyLoss`` and
    ``prepare(amp_configs=O2 bf16)``, through ``Model.fit``: RESNET_STEPS
    steps with a per-step clock (K=1: one eager warm-up step, the
    capture, replays), then RESNET_FOLD_STEPS at K=8 and under auto-K
    (synchronised at their ends only), then RESNET_STEPS through the
    eager route (``steps_per_dispatch=0``) from the same weights, then
    two witnesses eagerly from the same weights on the same batch: fp32
    without AMP at lr 0.1, and O2 at RESNET_SLOW_LR.  Checks finite
    losses that fall over the first three steps on the fixed batch (lr
    0.1 without warm-up overshoots after that, in fp32 as in O2), O2's
    first three within RESNET_FP32_LOSS_TOL of fp32's, O2 at the lower
    rate falling over each of its first RESNET_SLOW_FALL steps, the
    eager route's first three losses within FOLD_EAGER_LOSS_TOL of the
    replays', the
    BN running statistics moved off 0 / 1, one graph and one capture
    for all the replayed fits and none eagerly; prints images/s and
    step ms (median, steps 3+), peak ``max_memory_allocated``, the
    capture seconds and the graph pool, and ``torch.profiler``'s device
    idle share and busy ms by group (cuDNN convolution forward, dgrad,
    wgrad, BatchNorm, other elementwise, the optimizer, the loss) over
    RESNET_PROFILE replays and over eager steps;
15d. ``[train resnet parity]``: ResNet-18 at 64x64, B=4, fp32 (TF32
    off), ``Momentum(RESNET_PARITY_LR, 0.9)`` on three batches.  One step
    with cuDNN's convolutions: the logits and every gradient within 1e-4
    x max(|ref|, 1) of the CPU's.  Then the main path's route, cuDNN's
    convolutions and BatchNorm with ``cudnn.deterministic`` (no
    algorithm that adds with atomics), at K=1, at K=4 and eagerly.  A
    ReLU input within fp32 rounding of 0 may take another sign on the
    card than on the CPU, and send one element's gradient the other
    way (one such flip moves a velocity by 1.65e-3 after three steps),
    so the eager run's ReLU inputs are kept and the reference is the
    CPU run whose ReLUs follow the card's signs: the eager run after
    each step against it, K=1 after each step and K=4 at its end
    against the eager run, every parameter, velocity and BN buffer
    within 1e-4 x max(|ref|, 1); whether the replays are bit-equal is
    printed.  The eager run against the plain CPU run is printed beside
    the ReLU inputs that took another sign, and a departure over the
    bound with no such flip fails;
15e. ``[vision zoo]``: one constructor of every ported CNN family
    (ResNet's basic and bottleneck blocks, ResNeXt, wide ResNet, VGG,
    MobileNet v1-v3, ShuffleNetV2 relu and swish, DenseNet, SqueezeNet
    1.0 / 1.1, GoogLeNet, InceptionV3, AlexNet, LeNet): one fp32 eval
    forward on the card against the same model on the CPU within 1e-4 x
    max(|ref|, 1) at 64x64 (96 for SqueezeNet, GoogLeNet and
    InceptionV3, 224 for AlexNet, 28x28x1 for LeNet), then four bf16
    O2 ``Momentum(ZOO_LR, 0.9)`` training steps at the published input
    size (224; 299 for InceptionV3) and B=8, the first of whose loss and
    every gradient are finite; prints the ms a step (median of the last
    three) per family; then ViT (``img_size=32, patch_size=8``, 2
    blocks, at 32, 24 and 48: the resized position table) and
    ``ppyoloe_tiny`` (eval scores and boxes at 64) card vs CPU, fp32;
15f. ``[train vit]`` trains ViT-B/16 as ``bench.py:427-500`` does: B=32,
    1000 classes, buckets 224 and 192 alternating (the position table
    resized in the 192 graph), AdamW(1e-3, multi_precision), bf16 O2,
    ``prepare(amp_configs=O2)``, through ``Model.fit``, cuDNN on its
    deterministic algorithms (the patch convolution): one graph per
    bucket (``compile_stats`` 2 / 2 after the first step of each and
    unchanged over the timed and profiled replays), ``VIT_STEPS`` losses
    bit-equal to ``fit(steps_per_dispatch=0)`` from the same weights;
    prints ms a step per bucket replayed and eager, images/s, the
    profile by kernel group, the composed attention's device ms alone,
    peak memory and the graph pool.  bench's rate has no warm-up, so
    the gates on the loss are witnesses: fp32 at 1e-3 (O2's first three
    losses within ``VIT_FP32_LOSS_TOL``) and O2 at ``VIT_SLOW_LR``
    (falling over each bucket's first three steps);
15g. ``[train vit-l]``: ViT-L/16 at B=32, 224 only, a captured step and
    ``VIT_L_STEPS`` replays: finite losses, ms a step, peak memory;
15h. ``[train ppyoloe]`` trains ``ppyoloe_crn_s(num_classes=80)`` as
    ``bench.py:352-425`` does (B=8, buckets 640 and 512 alternating,
    Adam(1e-3), fp32, 8 padded boxes an image with a mask), the step
    captured per bucket by the fold engine (``build_folded_step``, the
    loss dict's ``loss`` backpropagated): finite terms, no capture after
    the first step of each bucket, ms a step and images/s, the profile,
    the assignment and losses alone (device ms); then, cuDNN
    deterministic, ``DET_STEPS`` replayed steps bit-equal (all four
    terms) to eager ones from the same weights; the witness of the loss
    is Adam at ``DET_SLOW_LR``, falling over each bucket's first three;
15i. ``[detect eval]``: the trained detector in eval at 640, B=8, then
    ``postprocess`` (multiclass NMS on the card) at the score that keeps
    the top ``DET_EVAL_SHARE`` of the class scores: the rows equal the
    CPU's on the card's outputs (labels and boxes exactly, scores within
    ``NMS_SCORE_TOL``); prints the forward's and the NMS's ms;
15j. ``[train lenet]``: ``BASELINE.json:7``'s configuration as
    ``tests/test_lenet_e2e.py`` writes it, on the port: ``MNIST`` (the
    synthetic fallback, 60000 / 10000 images) in a ``DataLoader`` at
    B=64, shuffled from a seeded generator, ``drop_last``; ``LeNet`` with
    ``Adam(1e-3)``, ``CrossEntropyLoss`` and ``Accuracy()``.  One epoch
    of ``fit`` under auto-K, ``evaluate`` on the test set (one captured
    eval graph per batch shape), ``save``, ``load`` into a second model
    whose evaluation must be bit-equal, ``predict`` on 256 test images
    (equal across the two models); the accuracy must beat the JAX
    test's 0.2.  Gates, with cuDNN's deterministic algorithms: a fit at
    K=8 and one on the eager route from one start and one batch order
    end bit-equal (parameters, moments, beta powers, step counts and
    the Accuracy sums); K=1 fits with the device prefetcher (each batch
    staged on a copy stream) at 4 workers and at 0 end bit-equal; no
    capture in a timed window.  Prints ms a step at K=1, K=8, auto-K
    (with its K) and eager, images/s and the idle share (device busy
    from a profiled window against the unprofiled wall), evaluation's
    images/s captured and eager, the loader's host ms a batch at 0 and 4
    workers, the checkpoint's sizes and seconds and peak memory;
15k. ``[train resnet50 fit]``: ResNet-50 as ``[train resnet50]`` with
    what the user's script adds: ``Accuracy(topk=(1, 5))`` in the
    graph, its counts held against a host recount of the same steps'
    logits (rows whose logits tie at the k-th place may go either way),
    ms a step with and without it; ``evaluate`` on 4 batches captured
    and eager; ``accumulate_grad_batches=4`` at B=16 bit-equal to the
    fit at B=64 on the concatenated batches; a save after 3 steps, two
    steps that move every state, a ``load`` into the same captured
    model and 3 more replays bit-equal to 6 uninterrupted steps with no
    new capture (both with cuDNN's deterministic algorithms), with the
    files' sizes and the seconds; a ``DataLoader`` over
    ``SyntheticImages(3, 224, 224)`` at 0 and 4 workers: images/s and
    the idle share;
15l. ``[train ernie sched]``: ERNIE-3.0-base MLM pretraining (12 layers,
    hidden 768, 12 heads, vocab 40000, B=16, S=512, 15% of positions
    labelled, dropout 0, bf16 O2, the default flash path: K5's
    tensor-core forward and K6's split backward, non-causal) as
    PaddleNLP's script sets it up: ``AdamW(0.9, 0.999, 1e-8,
    weight_decay=0.01, apply_decay_param_fun=<p.name off biases and
    norms>, grad_clip=ClipGradByGlobalNorm(1.0), multi_precision)``
    under ``LinearWarmup(PolynomialDecay(1e-4, 16, end_lr=1e-5), 4, 0,
    1e-4)`` (the schedule cut to the phase's 20 steps, so that it
    crosses the warmup into the decay; the widths are not cut), through
    ``Model.fit`` with ``LRSchedulerCallback(by_step=True,
    by_epoch=False)``: K=1, a replay of the captured step a step with
    the rate refreshed before it.  On that run (the main path, PyTorch's
    default mode): each step's rate equal to the schedule's (printed),
    step 1's global norm within 1e-5 relative of a float64 recompute of
    the same bf16 gradients, K5/K6 launched 12 + 12 + 12 a step, all
    tensor-core, nothing plain; ms a step beside ``[train ernie bh]``,
    peak memory, the clip alone (device time) and a profile of two
    replays with the clip's norms and the optimizer's foreach kernels
    as groups.  Then, under ``torch.use_deterministic_algorithms`` (the
    CUDA embedding backward sums the all-zero token-type ids in an order
    that changes from run to run, and the clip spreads that last bit to
    every update): the end state (parameters, masters, moments, beta
    powers, step counts, the scheduler's epochs) and the losses
    bit-equal to the eager route's (``steps_per_dispatch=0``) from the
    same weights and batches; a save after step 10 loaded into a fresh
    captured model and run 10 more steps bit-equal to the straight run;
    two controls patched in (the rate never refreshed, the clip left
    out) must fail the eager gate;
15m. ``[train ernie fp16 scaler]``: the same model and optimizer in
    fp16 O2 through PaddleNLP's custom loop, eagerly: ``auto_cast(O2,
    float16)`` forward, ``scaler.scale(loss).backward();
    scaler.step(opt); scaler.update(); opt.clear_grad()``, 20 steps from
    ``GradScaler(init_loss_scaling=32768)``, then from 2**24 and 2**32
    (the last must overflow).  Every skipped step leaves every
    parameter, master, moment, beta power and step count bit-unchanged
    and halves the scale; the losses are finite, the first within
    ``FP16_FIRST_LOSS_TOL`` of ``[train ernie sched]``'s (same weights
    and batch); K5/K6 launched 12 + 12 + 12 a step in fp16, all
    tensor-core (an inf in the backward's operands neither traps nor
    hangs them); prints the skips and the scale a step, then times the
    loop alone from 32768 (the scaler's read the one sync a step);
15n. ``[optimizers]``: SGD, Momentum (Nesterov), Adam (amsgrad), AdamW
    (a decay function, the global-norm clip), Adagrad, RMSProp (plain
    and centered with momentum), Lamb (an exclude function), Adadelta
    and Adamax, three steps each on the card and on the CPU from the
    same fp32 weights and gradients (within ``OPT_TOL`` x max(|ref|,
    1)), and LBFGS with the strong-Wolfe line search on the extended
    Rosenbrock function of 64 values; then each but LBFGS in
    ``Model.fit`` of a small MLP with ``StepDecay`` stepped by step: K=1
    replays bit-equal to the eager route (a scalar the capture froze
    would show);
15o. ``[train transformer]``: PaddleNLP's Transformer-base for WMT14
    en-de (Vaswani et al. Table 3 "base": 6 + 6 pre-LN layers, d_model
    512, 8 heads, FFN 2048; the shared BPE vocabulary of 33708 padded
    to 33712; ``transformer.base.yaml``) written with the port's
    ``nn.Layer``, ``nn.Embedding(padding_idx=0)``, ``nn.Transformer`` and
    the soft-label cross-entropy (:func:`slice19_models`; random
    sentence pairs from ``--seed``), bf16 O2, ``Adam(0.9, 0.997, 1e-9)``
    with fp32 masters under ``NoamDecay(512, 4000, 2.0)`` stepped by
    ``LRSchedulerCallback(by_step=True)`` (so ``fit`` runs K=1), label
    smoothing 0.1, in three ~4096-token buckets (B, S) = (128, 32), (64,
    64), (32, 128), a captured graph each: at dropout 0 and under the
    deterministic algorithms, four steps a bucket replayed bit-equal to
    the eager route (parameters, masters, moments, beta powers, step
    counts, the scheduler's ``last_epoch``); at dropout 0.1 the timed
    run: ms a step and target tokens/s a bucket, capture seconds, reserved
    memory after each bucket's capture, peak, a ``torch.profiler``
    split (cuBLAS, the composed attention's softmax, the soft-label
    cross-entropy's softmax, LayerNorm, Adam, the rest) and the
    composed attention alone;
15p. ``[train transformer parity]``: the same model at its widths with
    2 + 2 layers in fp32, three ``SGD(0.1)`` steps of B=8 S=32 on the card
    (K=1 replays) and on the CPU from the same weights: parameters within
    ``CARD_CPU_TOL`` x max(|ref|, 1), losses within ``PARITY_TOL``; the
    run without ``memory_mask`` must fail that gate;
15q. ``[translate greedy]``: the 6 + 6 model in fp32 from the weights
    ``[train transformer]`` starts from decodes 32 sources of 64 tokens
    greedily for 64 steps, the decoder re-run on the prefix each step:
    ms a step and a token; the CPU, teacher-forced on the card's tokens,
    must give each of them as its argmax unless the two best logits lie
    within ``NMT_GAP`` (such steps printed and counted);
    ``MultiHeadAttention`` fed one position at a time with its cache
    equals the full causal call within ``MHA_CACHE_TOL``;
15r. ``[train crnn]``: CRNN (arXiv:1507.05717 Table 1's VGG, PaddleOCR's
    ``EncoderWithRNN`` ``LSTM(512, 256, bidirectional, 2 layers)`` and
    ``CTCHead`` ``Linear(512, 37)``, ``CTCLoss(blank=0)``) on 1x32x100
    text-line images whose stripes follow the labels, label lengths 3-12
    changing every batch, B=256, ``Adam(5e-4)``, fp32: under the
    deterministic algorithms 20 K=1 replays bit-equal to the eager route
    (BatchNorm statistics included), a control whose label lengths stay
    those of the first batch must differ, the loss falls; timed in the
    default mode (ms a step, images/s, peak, a profile split and the
    LSTM and CTC alone); card vs CPU at B=8 under the deterministic
    algorithms: step 1's gradients within ``CRNN_GRAD_TOL`` of each
    leaf's largest, the loss at "mean" and "sum" on the same weights,
    and three ``SGD(0.002)`` steps (K=1 replays) within ``CARD_CPU_TOL``,
    each step's worst leaves printed; a control whose card loss is
    scaled by 0.99 must fail both gates;
15s. ``[rnn]``: ``SimpleRNN``, ``LSTM`` and ``GRU``, 2 layers,
    bidirectional, with ragged ``sequence_length`` and initial states,
    card vs CPU in fp32 within ``RNN_TOL`` x max(|ref|, 1): outputs and
    every gradient, eager and as a captured graph replayed on other
    lengths;
15t. ``[nn layers]``: every layer class and function of slice 20 (the 1-D,
    3-D and transposed convolutions; the 1-D and 3-D pools, adaptive
    pools, masks and unpools; instance, group, RMS, layer, local
    response, 3-D batch and spectral norms; every activation; the pads,
    shape, upsampling, fold and misc functions; the dropouts' plain
    functions of a given mask) forward and backward on the card against
    the CPU port in fp32 within ``NN_TOL`` x max(|ref|, 1) (outputs and
    the gradients of the inputs and parameters), the convolution, pool,
    norm and pad cases also in bf16 under O2 within ``NN_BF16_TOL``; per
    family a control with one argument changed on the card must fail;
    the dropouts', ``RReLU``'s and ``gumbel_softmax``'s own draws on the
    card by distribution; ``weight_norm`` and ``spectral_norm`` in a
    network trained by ``Model.fit`` (K=1 replays: the hooks run inside
    the captured step) against the CPU fit, with a ``spectral_norm(dim=1)``
    control;
15u. ``[train cyclegan]``: CycleGAN as PaddleGAN's
    ``configs/cyclegan_cityscapes.yaml`` sets it up (two ResNet
    generators with 9 blocks, two 70x70 PatchGANs, InstanceNorm without
    affine, reflection pads, LSGAN, cycle L1 x10, identity x0.5, image
    pools of 50, ``Adam(2e-4, beta1=0.5)``), 256x256, B=1, fp32, through
    PaddleGAN's eager loop (the G step with the discriminators'
    ``trainable`` off, then the D step on pooled, detached fakes):
    ``GAN_STEPS`` steps on one image pair, losses finite and the cycle
    and identity terms falling; ms a step, image pairs/s, peak and a
    profile split (cuDNN's FFT convolutions, forward, dgrad, wgrad;
    InstanceNorm; pads; Adam; the rest);
15v. ``[train cyclegan parity]``: the route ``[train cyclegan]`` times
    (cuDNN's convolutions, its default algorithm choice, fp32, TF32
    off), the kinks of the reference run following the card's (the
    ReLUs' and LeakyReLUs' signs and the L1 losses' signs).  At 64x64
    card vs CPU from the same weights: step 1's gradients per leaf
    within ``NN_TOL`` of the leaf's largest (the conv biases that feed
    an InstanceNorm, whose gradients are rounding noise, of the largest
    of all), and after three G+D steps at Adam's 2e-4 at least
    ``GAN_SHARE_MIN`` of the parameters within ``GAN_SHARE_LR`` x lr of
    the CPU's and all within a few lr (Adam turns a noise gradient into
    a step of ~lr).  At the timed 256x256, where cuDNN takes other
    algorithms (an FFT weight gradient for the residual blocks), step
    1's gradients per leaf within ``NN_TOL`` of a float64 run of the
    same model on the card by ATen's convolutions (cuDNN off).  The
    model with zero padding in place of reflection on the card must
    fail every gate;
15w. ``[train r2plus1d]``: R(2+1)D-18 (torchvision's ``r2plus1d_18``,
    31.5 M parameters, 400 classes), B=32 clips of 3x16x112x112, bf16 O2
    with fp32 masters, ``Momentum(0.01, 0.9, L2Decay(1e-4))``, through
    ``Model.fit``: K=1 replays (ms a step, clips/s, TFLOP/s by the
    convolutions' count, peak, capture seconds, the graph pool, a
    profile split: Conv3D forward / dgrad / wgrad, BatchNorm3D, layout
    transforms, casts, the rest), the eager route, and under the
    deterministic algorithms three K=1 replays bit-equal to eager;
15x. ``[train r2plus1d parity]``: R(2+1)D-18 in fp32 at B=2 clips of
    3x8x56x56, card vs CPU from the same weights, cuDNN deterministic:
    step 1's gradients per leaf within ``CRNN_GRAD_TOL`` of the leaf's
    largest, three ``Momentum(1e-3)`` steps (K=1 replays) within
    ``CARD_CPU_TOL`` (the CPU's ReLUs following the card's signs, as
    ``[train resnet parity]``'s), K=1 replays bit-equal to the eager
    run, a control whose card clips run backwards in time must fail
    both; the bf16 O2 forward card vs CPU within ``NN_BF16_TOL`` x
    max(|ref|, 1) on two draws of weights and clips, and the card's with
    its convolutions left in fp32 (the custom black list) must fail it
    on both;
15y. ``[train widedeep]``: PaddleRec's Wide&Deep as
    ``models/rank/wide_deep/config_bigdata.yaml`` sets it up
    (:data:`WD_SOURCE`, :func:`slice21_models`): one
    ``Embedding(1000001, 9, sparse=True)`` looked up once per slot in 26
    slots, the wide ``Linear(13, 1)``, the deep MLP 247-512-256-128-32-1
    with ReLU, sigmoid and ``binary_cross_entropy``, batch 512, Adam at
    lr 0.001, on synthetic Criteo-shaped data from ``--seed``
    (:func:`widedeep_data`), 50 steps each way: PaddleRec's eager loop
    (``backward`` / ``step`` / ``clear_grad``) with ``Adam(lazy_mode=
    True)`` and with ``lazy_mode=False`` (the sparse gradient densified),
    ``Model.fit`` with ``prepare(jit=False)`` and ``Auc`` (its losses
    equal to the lazy loop's) and captured (the lookup dense; its first
    loss equal to the loop's).  Gates: finite, falling losses, every row
    no step looked up bit-equal to its start, the two loops' second
    losses equal.  Prints ms a step, the optimizer's ms, merges and
    synchronising operations a step (``Tensor.coalesce`` counted, torch's
    sync debug mode), the optimizer's least bytes (lazy against dense),
    peak memory and each way's idle share over a profiled window;
15z. ``[train widedeep parity]``: the full table in fp32, card against
    the port on the CPU under the deterministic algorithms, three lazy
    Adam steps with ``ClipGradByGlobalNorm``: every row never looked up
    bit-equal to its start with moments exactly 0 (a planted control, one
    such row moved by lr, must fail it), each leaf after step 1 within
    ``WD_TIGHT`` x its scale on ``WD_SHARE`` of the elements and within
    2 lr on all (Adam's first step is lr x sign(g)), each step's loss
    within ``WD_LOSS_RTOL`` relative;
15za. ``[train gpt o1]``: GPT-2-small (B=8, S=1024) with fp32 weights
    through ``Model.fit`` with ``amp_configs`` O1 bfloat16, K=1 replays
    (the tensor-core flash kernels, 12 launches a step each), then three
    eager steps under ``custom_black_list={"flash_attention"}``: q, k, v
    reach the flash kernels in fp32, so the CUDA-core bodies launch (no
    ``.tc`` launch) and no plain version runs;
15zb. ``[tensor ops]`` runs every spec of the op catalogue
    (``paddle_tpu_torch/ops/op_spec.py``, the port's copy of the JAX
    table) on Paddle ``Tensor`` s on the card against the same op on
    the CPU in the port, TF32 off: fp32 and bf16 where the spec lists
    it at the spec's forward bounds (dtype and shape equal, integers and
    booleans exact), and where ``check_grad`` is set the gradient of
    ``sum(op(x)[0])`` by ``backward()`` at the spec's gradient bounds;
    prints the specs and runs made, the ops ``OP_TABLE`` holds (all and
    those of the port's six op modules, counted in this run) and the
    largest errors, and fails on any mismatch (all are listed first);
15zc. ``[tensor flash]``: ``paddle.nn.functional.flash_attention`` on
    ``Tensor`` s at ``[8, 1024, 12, 64]`` bf16, causal,
    ``stop_gradient=False``, then ``paddle.grad`` over q, k and v: the
    output and the three gradients within ``FLASH_BF16_TOL`` x max(|ref|,
    1) of the plain versions on the same values; the profiler counts one
    tensor-core forward (K5) and one tensor-core dq + dkv pair (K6) and
    no CUDA-core flash kernel;
15zd. ``[train gpt dygraph]``: GPT-2-small (12 layers, 768 wide, vocab
    50304, B=8, S=1024), bf16 O2 (``amp.decorate`` and ``auto_cast``),
    AdamW, five steps of the classic dygraph loop (``paddle.to_tensor``
    inputs, ``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``,
    ``float(loss)``), and beside it the same loop on raw torch tensors
    (same seed, net, optimizer and batches), both under
    ``torch.use_deterministic_algorithms``: losses and final leaves
    bit-equal; K5 and K6 12 + 12 a step, all tensor-core, no plain call;
    then both loops again for ``DYGRAPH_TIMED_STEPS`` steps in PyTorch's
    default mode, as ``[train eager]`` runs; prints each way's median
    step time, profiled idle share and peak memory (both modes) beside
    ``[train eager]``'s step;
15ze. ``[dist nccl world1]``: one rank started by
    ``paddle_tpu_torch.distributed.spawn`` with
    ``PADDLE_DISTRI_BACKEND=nccl`` (the one NCCL world a single card
    allows): every collective of ``distributed.communication`` through
    NCCL on CUDA tensors (send/recv, which need a peer, aside), the
    object collectives and ``stream.all_reduce``, each exact;
15zf. ``[dist gloo cuda]``: four ranks on the one card, gloo over CUDA
    tensors (the backend ``init_parallel_env`` picks when ranks share a
    card): every collective on each rank against what the rank computes
    for itself, bf16 all-reduce, two subgroups of ``new_group`` and the
    dp2 x mp2 hybrid groups (the CPU tests' exercise,
    ``tests/torch_dist_workers.py``); prints which collectives gloo composed
    (``communication.GLOO_CUDA_COMPOSED``) and how often;
15zg. ``[train gpt hybrid]``: the same four ranks train GPT-2-small
    (12 layers, 768 wide, vocab 50304, S=1024, global B=8) dp2 x mp2
    through ``fleet.init`` -> ``fleet.distributed_model`` ->
    ``fleet.distributed_optimizer``, bf16 O2, AdamW with the hybrid
    global-norm clip, ``recompute=True``, ``HYBRID_STEPS`` steps of the
    dygraph loop on Tensors (each rank its dp rows): the loss falls on
    every rank; every rank's attention runs 6 heads and K5 / K6 launch
    as tensor-core kernels only (the forward twice a layer: recompute
    replays it); after the last update every leaf (bf16 parameter and
    fp32 master) is bit-equal over the dp group, and the leaves not
    split over mp over the mp group; prints the losses, ms a step, each rank's peak
    allocated and reserved memory, each collective's calls, bytes and
    host ms a step, and one profiled step's device busy time by rank;
15zh. ``[train gpt hybrid parity]``: GPT-2-small in fp32 from numpy
    weights, sharding2 x mp2 through ``DistributedRunner(
    sharding_stage=2)`` against the single-process raw loop on the card
    (rank 0), same weights and batch, SGD: step 1's gradient of every
    leaf (the shards joined on rank 0) within ``PARITY_GRAD_TOL`` of the
    leaf's largest, and the ``PARITY_STEPS`` losses within
    ``PARITY_LOSS_TOL`` relative; mp rank 1's shard of one leaf scaled
    by ``PARITY_CONTROL`` must fail; K5 / K6 at the hybrid shape (q, k,
    v ``[4, 1024, 6, 64]`` strided in a packed qkv, row stride 1152)
    held against their plain versions;
15zi. ``[train ernie sharding]``: four ranks on the one card (one world
    for 15zi-15zl) train ERNIE-3.0-base MLM (global B=16, S=512,
    ``SHARD_MASKED`` positions a row) at sharding 4 through
    ``group_sharded_parallel(level="os_g")``, bf16 O2, AdamW with the
    global-norm clip, ``SHARD_STEPS`` dygraph steps: the loss falls, K5 /
    K6 launch as tensor-core kernels only at ``[4, 512, 12, 64]``, and
    after the last step every parameter is bit-equal over the four
    ranks; prints losses, ms a step, each rank's optimizer-state bytes
    and peak memory, the collectives a step and a profiled step's busy
    time by rank;
15zj. ``[train ernie sharding parity]``: the same in fp32 with SGD and
    the clip against the single-process loop on the card (this process,
    after the world): step 1's gradient of every leaf within
    ``PARITY_GRAD_TOL`` of the leaf's largest, ``PARITY_STEPS`` losses
    within ``PARITY_LOSS_TOL``; rank 1's chunk of one leaf scaled by
    ``PARITY_CONTROL`` must fail;
15zk. ``[train gpt cp]``: GPT-2-small (global B=8, S=1024) at sep2 x mp2
    through ``DistributedRunner``, ``context_parallel`` "ring" and then
    "ulysses", bf16 O2, AdamW with the clip, ``CP_STEPS`` steps each:
    the loss falls; every leaf bit-equal over sep, the leaves not split
    over mp over mp; prints the sep p2p and all-to-all bytes and the
    compositions gloo needed;
15zl. ``[train gpt cp parity]``: both kinds in fp32 from numpy weights
    against the single-process raw loop (rank 0), the gates of 15zh;
    ``ring_flash_attention(balanced=True)`` on zigzag slices of q, k, v
    ``[8, 1024, 6, 64]`` fp32, merged, and the gradients of the whole
    inputs against the plain attention (``FLASH_OUT_TOL`` /
    ``FLASH_GRAD_TOL``);
15zm. ``[train gpt3 pipe]``: eight ranks on the one card (one world for
    15zm-15zn) train GPT-3 1.3B (24 layers, 2048 wide, 16 heads, FFN
    8192, vocab 50304, S=2048) dp1 x mp2 x pp4 through ``fleet.init`` ->
    ``GPTForCausalLMPipe(num_stages=4)`` (each rank builds its stage) ->
    ``fleet.distributed_model`` -> ``train_batch``, ``PIPE_M``
    micro-batches of 1 (1F1B), remat_stage, fp32 AdamW with the clip,
    one warm step and ``PIPE_STEPS`` timed (the last profiled): the loss
    falls and is the same on every rank; K5 / K6 launch on every rank
    as the CUDA-core kernels only (the forward twice: remat replays it);
    the tied embedding's two copies and the leaves not split over mp are
    bit-equal after the last update; prints ms a step, the bubble, each
    rank's collectives by axis, peak memory and busy time; then (this
    process) K5 / K6 at ``[1, 2048, 8, 128]`` fp32, row stride 3072,
    against their plain versions and timed;
15zn. ``[train gpt pipe parity]``: GPT-2-small fp32 from numpy weights
    at dp2 x mp2 x pp2 through ``PipelinedRunner`` (``PP_PARITY_M``
    micro-batches), SGD with the clip, against the single-process raw
    loop (this process, after the world): the gates of 15zh on the
    stages' gradients joined over mp and stages, mp rank 1's shard of
    one stage-0 leaf scaled by ``PARITY_CONTROL`` must fail;
15zo. ``[train gpt compressed]``: four ranks on the one card (one world
    for 15zo-15zs, one of two ranks for 15zp's dp2 runs) train
    GPT-2-small (global B=8, S=1024) dp4 through ``fleet.init``
    (``quantized_allreduce=8``, ``sharded_weight_update=True``, amp O2
    bf16, recompute) -> ``fleet.distributed_runner``: the int8 ring
    reduce-scatters the gradients (one flat buffer), each rank updates
    its flat quarter of
    the weights and AdamW state, the chunks are all-gathered exactly;
    one warm step and ``COMP_STEPS`` timed: the loss falls, the weights
    are bit-equal over the four ranks (a rank's weight one ulp off, the
    control, fails that gate), each rank's optimizer state is at most
    ``COMP_STATE_SHARE`` of the unsharded state; prints the dp bytes a
    rank a step counted by ``comm_stats`` beside the byte model and a
    plain dp4 step's, ``dp_compress_ratio``, peaks and K5 / K6 launches;
15zp. ``[train gpt compressed parity]``, fp32: dp2 bits 16 bit-identical
    to the plain dp2 path in losses and every weight over
    ``COMP_PARITY_STEPS`` steps (rank 1's step-1 gradient one ulp off,
    the control, must part them), dp2 bits 16 with the sharded update
    within rtol 2e-5 / atol 1e-6 of it; dp4 bits 8: step 1's loss
    equal to the exact run's and every loss within ``COMP_BITS8_TOL``
    of it (``tests/test_dp_compressed.py``'s bound), and step 1's
    gradient of every leaf after the int8 ring within the ring's bound
    of the exact dp mean, W quantizations of at most ``W |g|max / 127``
    each (``tests/test_compressed_collectives.py``'s ``4 step``; the
    control, the ring's mean with this rank's gradient left out, must
    fail it); and one int8 all-reduce of a ``BIG_LEAF`` gradient against
    the exact sum at the bounds of ``tests/test_compressed_collectives.py``;
15zq. ``[train gpt lmce mp]``: dp2 x mp2, bf16 O2, the non-fused steps and
    then ``enable_fused_lmce`` from the same weights (K7 / K8 on each
    rank's [25152, 768] vocab shard, tensor-core): the fused loss falls,
    step 1 within ``LMCE_MP_BF16_TOL`` of the non-fused, rank 0's K7 and
    K8 calls at the path's shape held against their plain versions with
    ``[lmce tc]``'s gates; ms a step and peaks beside the non-fused;
15zr. ``[train gpt lmce mp parity]``: fp32 dp1 x mp4 (a 12576-row vocab
    shard a rank, the CUDA-core K7 / K8) against the single-process fused
    loop on rank 0: the gates of 15zh;
15zs. ``[train gpt ckpt]``: fp32 dp2 x mp2 for ``CKPT_STEPS`` steps,
    ``save_runner_state`` after step 2 and ``CheckpointManager`` every
    second step (two kept); fresh runners from other weights: (a) the
    same layout resumes steps 3-4 bit-identically (the one-ulp control
    fails), (b) dp4 and (c) this process load the moments of fc1, the
    fused qkv and the word embedding bit-equal to the source's joined
    over mp (``merge_mp_states``; the qkv joined as a plain column
    split, the control, differs) and resume steps 3-4 within
    ``CKPT_TOL`` (step 4 reads the resharded moments), (d) a dp4 sharded-update run (exact ring) resumes
    bit-identically and loads into an unsharded dp4 runner, (e) step 4
    with one rank's file truncated fails ``verify_step`` and
    ``restore()`` returns step 2; under
    ``torch.use_deterministic_algorithms``; prints bytes, seconds and
    the index's leaf count, and deletes the directories;
16. ``[lmce tc]`` holds the tensor-core LMCE backward
    (``csrc/lmce_sm90.cu``, ``wgmma`` fed by TMA) against its plain
    versions (dL rounded to the operand dtype; each element within
    rtol |ref| + (u |dL| + eta) @ |B|: rtol one ulp of the value, 1e-2
    bf16 and 2e-3 fp16, then the bound of rounding each dL once) at
    the main shape in bf16 and fp16 and at N=333 V=786 D=200, N=1000
    V=1000 D=64 and N=1000 V=786 D=2048 (every fourth label -100) in
    both: ignored rows of dh exactly 0, two runs bitwise equal, and at
    the main shape the gradient of a backward without the S product
    fails the same gate; counts the ``HGMMA`` instructions in its SASS and
    prints ptxas's registers and spills; times both kernels at the main
    shape beside the CUDA-core backward they replaced for 16-bit
    operands and the plain versions, with the bound and TFLOP/s;
16b. ``[lmce tc fwd]`` holds the tensor-core forward
    (``csrc/lmce_fwd_sm90.cu``: 128 h rows a CTA, W streamed through a
    TMA ring, the vocabulary split into slices merged by a second pass)
    against ``lmce_reference`` per row (:func:`lmce_fwd_gate`: fp32 sums
    of D products and of V exps in other orders) at the main shape and
    N=333 V=786 D=200, N=1000 V=1000 D=64 and N=1000 V=786 D=2048 (h
    streamed), bf16 and fp16: ignored rows exactly 0, two runs bitwise
    equal, and at V=786 D=200 three broken forwards (the ragged
    vocabulary edge dropped, the label column off by one, one slice left
    out of the combine) fail the gate; counts ``HGMMA``, prints
    registers and spills (none allowed); times it at the main shape by
    device time and events beside the CUDA-core forward it replaced for
    16-bit operands, the plain version and, as a yardstick only,
    ``h @ W.T`` with fp32 ``F.cross_entropy``;
17. ``[fp16]`` holds every kernel against its plain version in fp16
    (within 1e-2 x max(|ref|, 1)): K1, the flash forward (tensor-core
    and CUDA-core), dq/dkv, the fused backward, the head-packed forward
    (both bodies) at ``[train fp16]``'s views (B=8, S=1024, H=12,
    D=64), and the three LMCE kernels (the backward's both bodies held
    element by element, as in 16);
18. ``[headdim]`` holds the flash kernels (forward, split and fused
    backward, head-packed forward at hp 2 and 4) at head dims 16 and 32
    in fp32, bf16 and fp16, causal and not (no tensor-core launch: below
    64 the CUDA-core forward runs), and K1 at Dh=16 (half a warp per
    row), each against its plain version;
19. prints the kernels' JSON line, the card line, and last the line
    ``{"ok": true, "device": {...}}``.

Every training phase but ``[train eager]`` runs through the fold
engine, whose launch counts add each replay's launches.  In every
training phase each 16-bit flash launch (forward, split and
fused backward) must be the tensor-core kernel's
(``<wrapper>.tc_launches`` equal to ``launches``: 12 per step each) and
the CUDA-core comparison entries, which the timings call through
``_cuda_core_fwd`` and ``_cuda_core_flash_bwd``, must not launch;
likewise every 16-bit lmce launch (forward, dh, dW) is the tensor-core
kernel's and ``lmce_kernel._cuda_core_fwd`` / ``_cuda_core_bwd`` never
launch.

Any failed check raises, so the script exits non-zero; without a card,
or without the repository beside it, it exits non-zero before any
result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
FP32_TOL = 1e-5
BF16_TOL = 2e-2
FLASH_FP32_TOL = 1e-4            # x max(|ref|, 1); fp32 sums reordered
FLASH_BF16_TOL = 2e-2            # x max(|ref|, 1); bf16 inputs/outputs
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 8
PARITY_TOL = 1e-4                # relative, per loss; cuBLAS vs CPU sums
FUSED_FIRST_LOSS_TOL = 1e-2      # relative; the unfused path rounds the
                                 # logits to bf16, the fused one does not
FP16_FIRST_LOSS_TOL = 1e-2       # relative; fp16 against bf16 rounding
BH_FIRST_LOSS_TOL = 1e-2         # relative; the [B*H, S, D] path rounds
                                 # p and dS to bf16 in the fused backward
FLASH_PAIR_TOL = 1e-5            # x max(|ref|, 1); kernel against kernel,
                                 # fp32, sums in other orders or atomics
ERNIE_B, ERNIE_S = 16, 512
FOLD_K, FOLD_STEPS = 8, 32       # [train fold]: K and the timed fits' steps
FOLD_BATCHES = 11                # [train fold parity]: groups 4 + 4 + 3
FOLD_LR = 1e-3                   # [train fold parity]: AdamW's rate
FOLD_EAGER_TOL = 1e-4            # x max(|ref|, 1), fp32; folded vs eager
FOLD_EAGER_LOSS_TOL = 1e-2       # relative; [train eager] vs [train]
BH_KNOBS = {"PADDLE_TORCH_FLASH_NO_PACKED": "1",
            "PADDLE_TORCH_FLASH_HEADPACK": "2",
            "PADDLE_TORCH_FLASH_FUSED_BWD": "1"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_cuda(torch, fn, iters, warmup=5, flush=None):
    """Median milliseconds per call, CUDA events around each call; the
    L2 flush (if any) runs outside the timed region."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# paged decode attention (K1): csrc/paged_attention_sm90.cu
# ---------------------------------------------------------------------------
K1_SOURCE = "paddle_tpu_torch/csrc/paged_attention_sm90.cu"
K1_CORE_SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
K1_REPLACES = "paddle_tpu/inference/serving/paged_attention_kernel.py:62"
K1_SAME_MIN = 0.99               # share of 16-bit outputs equal to the
                                 # plain output rounded to the dtype
K1_LONG = 32768                  # tokens a request holds in [kernel long]
K1_NAMES = {"split": ("paged_split_kernel",),
            "combine": ("paged_combine_kernel",)}
K1_CORE_NAMES = {"core": ("paged_attn_kernel",)}
F32_EPS = 2.0 ** -23
HALF_ULP = {"bfloat16": (7, -126), "float16": (10, -14)}  # (mantissa
                                 # bits, least normal exponent)


def paged_inputs(torch, seed, B, H, Dh, BS, MAXNB, lengths_l):
    """fp32 pools of ``B*MAXNB + 1`` pages (page 0 the scratch page), each
    request's pages scattered over the pool, q; on the card."""
    NB = B * MAXNB + 1
    rng = np.random.default_rng(seed)
    table = np.zeros((B, MAXNB), dtype=np.int32)
    free = rng.permutation(np.arange(1, NB)).tolist()
    for b, n in enumerate(lengths_l):
        nb = -(-n // BS)
        table[b, :nb] = [free.pop() for _ in range(nb)]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pool_k = torch.randn((NB, BS, H, Dh), generator=gen, device=dev)
    pool_v = torch.randn((NB, BS, H, Dh), generator=gen, device=dev)
    q = torch.randn((B, H, Dh), generator=gen, device=dev)
    return (pool_k, pool_v, torch.as_tensor(table, device=dev),
            torch.as_tensor(np.array(lengths_l, np.int32), device=dev), q)


def paged_exact(torch, inputs, v_abs=False):
    """The plain version's arithmetic in fp64 on the same values (its
    rounding far under fp32's): ``[B, H, Dh]``; with ``v_abs``, of |v|
    (``a = sum_t p_t |v_t| / l``)."""
    pk, pv, table, lengths, q = inputs
    NB, BS, H, Dh = pk.shape
    idx = table.long().clamp(0, NB - 1)
    k = pk.double()[idx].flatten(1, 2)                 # [B, T, H, Dh]
    v = pv.double()[idx].flatten(1, 2)
    if v_abs:
        v = v.abs()
    logits = torch.einsum("bhd,bthd->bht", q.double(), k) / np.sqrt(Dh)
    valid = (torch.arange(k.shape[1], device=q.device)[None, :]
             < lengths.long()[:, None])[:, None, :]
    logits = torch.where(valid, logits, -1e30)
    w = torch.where(valid, torch.exp(logits - logits.amax(-1, keepdim=True)),
                    0.0)
    den = w.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bht,bthd->bhd", w / den, v)


def paged_gate(torch, got, ref, inputs, plan, exact):
    """Per element against ``exact``, the fp64 output and ``a`` of
    :func:`paged_exact`:
    ``|got - exact| <= half an ulp of |exact| + eta`` in the output dtype
    (no rounding term for fp32), eta the bound of the kernel's fp32
    arithmetic: ``((2n + 8) eps + ds) (a + |exact|)`` with ``n = 2
    ceil(ST/TS) + TS + NS`` the longest chain of fp32 sums and rescalings
    a token's term meets (a lane group's, then the merges of the token
    groups and of the splits), ``ds = Dh eps scale max_t sum_i |q_i
    k_ti|`` a score's own error, ``8 eps`` for the exps and the division
    and ``a = sum_t p_t |v_t| / l``.  Returns ``(largest |err| / bound,
    share of elements equal to the fp32 plain output ``ref`` rounded to
    the dtype)``; passes at ratio <= 1 and, in 16 bits, share >=
    ``K1_SAME_MIN``."""
    pk, pv, table, lengths, q = inputs
    NB, BS, H, Dh = pk.shape
    T = table.shape[1] * BS
    ex, a = exact
    kg = pk.float().abs()[table.long().clamp(0, NB - 1)].reshape(
        -1, T, H, Dh)
    dots = torch.einsum("bhd,bthd->bht", q.float().abs(), kg)
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths.long()[:, None])[:, None, :]
    ds = Dh * F32_EPS / np.sqrt(Dh) * torch.where(valid, dots, 0.0).amax(-1)
    del kg, dots
    n = 2 * -(-plan.split_tokens // plan.token_groups) + \
        plan.token_groups + plan.splits
    eta = ((2 * n + 8) * F32_EPS + ds.double())[..., None] * (a + ex.abs())
    bound = eta
    name = str(got.dtype).split(".")[-1]
    if name in HALF_ULP:
        bits, emin = HALF_ULP[name]
        e = torch.floor(torch.log2((ex.abs() + eta).clamp_min(2.0 ** emin)))
        bound = bound + 0.5 * torch.exp2(e - bits)
    diff = (got.double() - ex).abs()
    ratio = torch.where(diff == 0, torch.zeros_like(diff),
                        diff / bound).max().item()
    share = (got == ref.to(got.dtype)).float().mean().item()
    return ratio, share


def paged_controls(torch, pak, inputs, plan, dtype):
    """Three broken outputs the gate must fail: one split left out of the
    combine, the tail mask off by one, a page id replaced by its
    neighbour in the pool (each from the plain version, rounded to
    ``dtype``)."""
    pk, pv, table, lengths, q = [t.float() if t.is_floating_point() else t
                                 for t in inputs]
    NB, BS = pk.shape[:2]
    T = table.shape[1] * BS
    m, l, acc = pak.paged_split_partials(pk, pv, table, lengths, q,
                                         plan.split_tokens)
    m[:, 1], l[:, 1], acc[:, 1] = -1e30, 0.0, 0.0
    longest = int(lengths.argmax().item())
    moved = table.clone()
    moved[longest, 1] = moved[longest, 1] % (NB - 1) + 1
    return {
        "split 1 not combined": pak.paged_split_combine(
            m, l, acc, lengths, plan.split_tokens, T, dtype),
        "tail mask + 1": pak.paged_ragged_attention_reference(
            pk, pv, table, torch.where(lengths > 0, lengths + 1,
                                       lengths).clamp(max=T), q).to(dtype),
        "page id + 1": pak.paged_ragged_attention_reference(
            pk, pv, moved, lengths, q).to(dtype),
    }


def paged_check(torch, pak, phase, tag, inputs, controls=False):
    """The kernel on ``inputs`` against the plain version on the same
    values in fp32 and against the plain mirror of its split
    (:func:`paged_gate`), two runs bitwise equal, empty rows exactly 0;
    ``controls``: the three broken outputs of :func:`paged_controls` fail
    the gate.  Returns ``{max_abs_err, split_max_abs_err, gate_ratio,
    equal_share, plan}``."""
    pk, pv, table, lengths, q = inputs
    B, MAXNB = table.shape
    NB, BS, H, Dh = pk.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = pak.split_plan(B, H, Dh, BS, MAXNB, q.element_size(), sms)
    before = pak.paged_ragged_attention.launches
    core_before = pak._cuda_core_paged.launches
    got = pak.paged_ragged_attention(*inputs)
    again = pak.paged_ragged_attention(*inputs)
    torch.cuda.synchronize()
    check(pak.paged_ragged_attention.launches == before + 2
          and pak._cuda_core_paged.launches == core_before,
          f"[{phase}] {tag}: the split kernel did not launch (or the "
          "comparison entry did)")
    # once more into a NaN-filled output (not counted): an element the
    # kernels leave unwritten shows
    poisoned = pak._launch_sm90(
        pak._lib(pak.KERNEL_NAME), torch.cuda.current_stream().cuda_stream,
        *inputs, 1.0 / np.sqrt(Dh), sms, out=torch.full_like(q, np.nan))
    torch.cuda.synchronize()
    check(torch.equal(poisoned, got),
          f"[{phase}] {tag}: into a NaN-filled output the kernel leaves "
          "elements unwritten or differs")
    f32 = [t.float() if t.is_floating_point() else t for t in inputs]
    ref = pak.paged_ragged_attention_reference(*f32)
    sref = pak.paged_split_reference(*f32, plan.split_tokens)
    check(got.dtype == q.dtype and bool(torch.isfinite(got.float()).all()),
          f"[{phase}] {tag}: dtype {got.dtype} or not finite")
    empty = lengths == 0
    check(bool((got[empty] == 0).all()),
          f"[{phase}] {tag}: an empty row is not exactly 0")
    same = torch.equal(got, again)
    err = (got.float() - ref).abs().max().item()
    serr = (sref - ref).abs().max().item()
    exact = (paged_exact(torch, inputs),
             paged_exact(torch, inputs, v_abs=True))
    ratio, share = paged_gate(torch, got, ref, inputs, plan, exact)
    line = (f"[{phase}] {tag} {plan}: max_abs_err={err:.3e} (plain split "
            f"mirror {serr:.3e}); gate ratio {ratio:.3e} (<= 1)"
            + (f", {share:.5f} of the elements equal to the rounded plain "
               f"output" if q.dtype != torch.float32 else "")
            + f"; two runs bitwise equal: {same}, and a third into a "
            f"NaN-filled output; {int(empty.sum().item())} empty rows "
            f"exactly 0")
    ctl = {}
    if controls:
        for name, bad in paged_controls(torch, pak, inputs, plan,
                                        q.dtype).items():
            ctl[name] = paged_gate(torch, bad, ref, inputs, plan, exact)
        line += "; controls (fail, as they must): " + "; ".join(
            f"{n} ratio {r:.3e} equal {sh:.5f}" for n, (r, sh) in
            ctl.items())
    print(line, flush=True)
    sixteen = q.dtype != torch.float32
    for name, (r, sh) in ctl.items():
        check(r > 1.0 or (sixteen and sh < K1_SAME_MIN),
              f"[{phase}] {tag}: the gate passes the {name} control")
    check(ratio <= 1.0, f"[{phase}] {tag}: gate ratio {ratio:.3e} > 1")
    check(not sixteen or share >= K1_SAME_MIN,
          f"[{phase}] {tag}: {share:.5f} equal < {K1_SAME_MIN}")
    check(q.dtype != torch.float32 or err <= FP32_TOL,
          f"[{phase}] {tag}: fp32 kernel vs plain {err} > {FP32_TOL}")
    check(same, f"[{phase}] {tag}: two runs differ")
    return {"max_abs_err": err, "split_max_abs_err": serr,
            "gate_ratio": ratio, "equal_share": share, "plan": plan,
            "controls": ctl}


def l2_flush(torch):
    """A call that reads 128 MB, so the 50 MB L2 then holds none of a
    kernel's inputs and no dirty line (a write-based flush leaves ~50 MB
    for the next kernel to write back)."""
    buf = torch.zeros(128 * 1024 * 1024 // 4, device="cuda")
    return buf.sum


PROFILE_TRIES = 3                # windows tried before "no device time" fails
PROFILE_PRIMERS = 1024           # empty kernels that open a profiled window
SPIN_KEY = "spin_kernel"         # torch.cuda._sleep's kernel: the primers,
                                 # never counted


@contextlib.contextmanager
def profile_window(torch, cpu=False):
    """``torch.profiler`` with CUDA activity (and the CPU's if ``cpu``),
    the card drained before it and the window opened by
    ``PROFILE_PRIMERS`` empty kernels (``torch.cuda._sleep(0)``) and a
    synchronize.  The profiler loses the first kernel records of some
    windows, the more the longer since the process's first profiled
    window (``chip_profiler_lag.py``; on the H100 a window late in this
    script once recorded none of three 22 ms kernels): the primers take
    that loss.  Count a kernel's time with :func:`kernel_us`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(PROFILE_PRIMERS):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        yield prof


def kernel_us(e):
    """A profile entry's own device microseconds; 0 for the primers."""
    if SPIN_KEY in e.key:
        return 0.0
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profiled(torch, body, cpu=False):
    """:func:`profile_window` over ``body()`` and a synchronize: the
    profile.  A window that records no device time is run again, up to
    ``PROFILE_TRIES`` times, and then fails.  ``body`` must be
    repeatable."""
    from torch.autograd import DeviceType
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile_window(torch, cpu) as prof:
            body()
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA and kernel_us(e) > 0
               for e in prof.key_averages()):
            return prof
        print(f"[profile] window {attempt} of {PROFILE_TRIES}: "
              "torch.profiler recorded no device time", flush=True)
    raise RuntimeError(f"torch.profiler recorded no device time in "
                       f"{PROFILE_TRIES} windows")


def k1_device_ms(torch, fn, iters, groups, flush):
    """Device milliseconds per call of ``fn`` by ``torch.profiler``, the L2
    flush run before each call and not counted: ``{group: ms}`` over the
    kernels whose name holds one of the group's substrings (an empty
    tuple: every kernel but the flush's)."""
    flush_keys = {e.key for e in profiled(torch, flush).key_averages()}
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(iters):
            flush()
            fn()

    prof = profiled(torch, window)
    out = dict.fromkeys(groups, 0.0)
    for e in prof.key_averages():
        if not e.count:
            continue
        # the profiler may drop some kernel records: a kernel's time a
        # call is its mean per launch times its launches a call
        us = kernel_us(e) / e.count * max(1, round(e.count / iters))
        for g, subs in groups.items():
            if any(x in e.key for x in subs) if subs else \
                    e.key not in flush_keys:
                out[g] += us
    return {g: us / 1e3 for g, us in out.items()}


def host_us(torch, fn, calls=200):
    """Host microseconds per call of ``fn``: the Python loop's time with
    nothing waited on (``calls`` calls stay inside the card's launch
    queue), the device drained before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def paged_times(torch, pak, inputs, flush, iters, plain_iters):
    """The kernel (device time per launch pair and events), the kernel it
    replaced (``_cuda_core_paged``), the plain version and, as a
    yardstick only, SDPA over K/V gathered beforehand (the gather not
    timed: no PyTorch call attends through a page table)."""
    pk, pv, table, lengths, q = inputs
    B, MAXNB = table.shape
    NB, BS, H, Dh = pk.shape
    dev = k1_device_ms(torch, lambda: pak.paged_ragged_attention(*inputs),
                       iters, {**K1_NAMES, "all": K1_NAMES["split"]
                               + K1_NAMES["combine"]}, flush)
    core_dev = k1_device_ms(torch, lambda: pak._cuda_core_paged(*inputs),
                            iters, K1_CORE_NAMES, flush)["core"]
    host = host_us(torch, lambda: pak.paged_ragged_attention(*inputs))
    core_host = host_us(torch, lambda: pak._cuda_core_paged(*inputs))
    ms = time_cuda(torch, lambda: pak.paged_ragged_attention(*inputs),
                   iters, flush=flush)
    core_ms = time_cuda(torch, lambda: pak._cuda_core_paged(*inputs), iters,
                        flush=flush)
    plain_ms = time_cuda(torch, lambda: pak.paged_ragged_attention_reference(
        *inputs), plain_iters, warmup=1, flush=flush)
    kg, vg = pak.gather_pages(torch.stack([pk, pv])[None], 0, table)
    kg = kg.permute(0, 2, 1, 3).contiguous()              # [B, H, T, Dh]
    vg = vg.permute(0, 2, 1, 3).contiguous()
    T = kg.shape[2]
    mask = (torch.arange(T, device=q.device)[None, :]
            < lengths[:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib():
        return sdpa(q[:, :, None], kg, vg, attn_mask=mask)
    lib_ms = time_cuda(torch, lib, iters, flush=flush)
    lib_dev = k1_device_ms(torch, lib, iters, {"all": ()}, flush)["all"]
    del kg, vg
    lens = lengths.tolist()
    nbytes = pak.attention_bytes(lens, BS, H, Dh, q.element_size())
    flops = 4 * sum(lens) * H * Dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return {"device_ms": dev["all"], "split_device_ms": dev["split"],
            "combine_device_ms": dev["combine"], "ms": ms,
            "host_us": host, "cuda_core_host_us": core_host,
            "cuda_core_device_ms": core_dev, "cuda_core_ms": core_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev, "bytes": nbytes,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "tb_per_s": nbytes / (dev["all"] * 1e-3) / 1e12}


def times_line(r):
    return (f"device_ms={r['device_ms']:.5f} (split "
            f"{r['split_device_ms']:.5f}, combine "
            f"{r['combine_device_ms']:.5f}; {r['tb_per_s']:.3f} TB/s) "
            f"kernel_ms={r['ms']:.5f} by events, host {r['host_us']:.2f} "
            f"us a call; the kernel it replaced (_cuda_core_paged) "
            f"device_ms={r['cuda_core_device_ms']:.5f} events "
            f"{r['cuda_core_ms']:.5f} host {r['cuda_core_host_us']:.2f} us; "
            f"plain_ms={r['plain_ms']:.5f}; "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}, {r['bytes']} "
            f"bytes); library yardstick (not used by the port): sdpa on "
            f"K/V gathered beforehand {r['library_ms']:.5f} ms, device "
            f"{r['library_device_ms']:.5f}")


def kernel_phase(torch, seed, nvcc_log=""):
    """``[kernel]``: the split-K kernel at GPT-2-small's decode shape
    with ragged lengths and scattered pages, fp32, bf16 and fp16, held
    by :func:`paged_check` (the three controls in bf16 and fp16), and
    timed beside the kernel it replaced, the plain version, the bound
    and SDPA (:func:`l2_flush` before each call); then at B=256 (one
    split) and at the speculative verify's 40 rows
    (:func:`verify_inputs`, with the controls in every dtype)."""
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    B, H, Dh, BS, MAXNB = 8, 12, 64, 16, 64
    lengths_l = [0, 1, 16, 17, 500, 1024, 333, 64]
    if nvcc_log:
        from paddle_tpu_torch import _build
        _, regs, spills = sass_summary(
            _build.library_path("paged_attention_sm90"), nvcc_log)
        print(f"[kernel] {K1_SOURCE}: ptxas registers per kernel {regs}, "
              f"spill store bytes {spills}", flush=True)
        check(not any(spills), f"[kernel] ptxas spills {spills}")
    inputs = paged_inputs(torch, seed, B, H, Dh, BS, MAXNB, lengths_l)
    flush = l2_flush(torch)
    res = {}
    for dn, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                      ("fp16", torch.float16)):
        x = [t.to(dtype) if t.is_floating_point() else t for t in inputs]
        r = paged_check(torch, pak, "kernel", f"{dn} B={B} H={H} Dh={Dh} "
                        f"BS={BS} MAXNB={MAXNB} lengths={lengths_l}", x,
                        controls=dn != "fp32")
        if dn != "fp16":
            r.update(paged_times(torch, pak, x, flush, 100, 20))
            print(f"[kernel] {dn}: " + times_line(r), flush=True)
        res[dn] = r
    # serving at max_batch 256: 256 (request, head group) pairs fill the
    # card, so one split and no combine; an inactive slot has length 0
    B1 = 256
    lengths_1 = [0 if b % 4 == 0 else (37 * b) % 1024 + 1
                 for b in range(B1)]
    one = paged_inputs(torch, seed + 1, B1, H, Dh, BS, MAXNB, lengths_1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dn, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        x = [t.to(dtype) if t.is_floating_point() else t for t in one]
        check(pak.split_plan(B1, H, Dh, BS, MAXNB, x[4].element_size(),
                             sms).splits == 1,
              f"[kernel] B={B1}: the plan has more than one split")
        res[f"{dn} one split"] = paged_check(
            torch, pak, "kernel", f"{dn} B={B1} H={H} Dh={Dh} BS={BS} "
            f"MAXNB={MAXNB} one split, every 4th row empty", x)
        del x
    del one
    # the speculative verify's shape: [serve spec]'s 8 page tables each
    # repeated k+1 times, row (b, i) attending n_b + i + 1 tokens
    S = SPEC_K + 1
    ver = verify_inputs(torch, seed + 2, VERIFY_LENS, S, H, Dh, BS, MAXNB)
    for dn, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                      ("fp16", torch.float16)):
        x = [t.to(dtype) if t.is_floating_point() else t for t in ver]
        res[f"{dn} verify"] = paged_check(
            torch, pak, "kernel", f"{dn} verify B={B * S} (8 tables x "
            f"{S}) H={H} Dh={Dh} BS={BS} MAXNB={MAXNB} windows from "
            f"n={VERIFY_LENS}", x, controls=True)
        del x
    del ver
    return res


VERIFY_LENS = [0, 21, 56, 80, 116, 216, 349, 1021]   # [kernel] verify: each
                                 # slot's cache tokens before the window (an
                                 # idle slot, seven of REQ_LENS's prompts 16
                                 # tokens into their answers, and one whose
                                 # window runs past the table's 1024 tokens)


def verify_inputs(torch, seed, lens, S, H, Dh, BS, MAXNB):
    """K1's inputs as the speculative verify builds them
    (``spec_score_forward``): the pools and ``len(lens)`` page tables of
    :func:`paged_inputs` (an idle slot's all scratch), each table
    repeated ``S`` times, row ``(b, i)`` of length ``lens[b] + i + 1``
    (the verify's write included; the kernel clamps it to the table's
    reach), and q for the ``len(lens) * S`` rows."""
    T = MAXNB * BS
    pk, pv, table, _, _ = paged_inputs(
        torch, seed, len(lens), H, Dh, BS, MAXNB,
        [min(n + S, T) if n else 0 for n in lens])
    rows = np.array([n + i + 1 for n in lens for i in range(S)], np.int32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    q = torch.randn((len(rows), H, Dh), generator=gen, device="cuda")
    return (pk, pv, table.repeat_interleave(S, dim=0),
            torch.as_tensor(rows, device=q.device), q)


def kernel_long_phase(torch, seed):
    """``[kernel long]``: the kernel at the long-context tier's decode
    shape (B=8, H=12, Dh=64, every request 32768 tokens) with pages of 16
    and of 256 tokens, fp32, bf16 and fp16 (and ragged lengths up to
    32768 in bf16), held by :func:`paged_check` and timed as ``[kernel]``
    is (fp32 and bf16)."""
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    B, H, Dh = 8, 12, 64
    flush = l2_flush(torch)
    res = {}
    for BS in (16, 256):
        MAXNB = K1_LONG // BS
        inputs = paged_inputs(torch, seed + BS, B, H, Dh, BS, MAXNB,
                              [K1_LONG] * B)
        for dn, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                          ("fp16", torch.float16)):
            x = [t.to(dtype) if t.is_floating_point() else t
                 for t in inputs]
            r = paged_check(torch, pak, "kernel long", f"{dn} B={B} H={H} "
                            f"Dh={Dh} BS={BS} MAXNB={MAXNB} lengths "
                            f"{K1_LONG} each", x)
            if dn != "fp16":
                r.update(paged_times(torch, pak, x, flush, 10, 3))
                print(f"[kernel long] {dn} BS={BS}: " + times_line(r),
                      flush=True)
            res[f"{dn} bs{BS}"] = r
            del x
        if BS == 256:
            ragged = [K1_LONG, K1_LONG - 1, 1, 0, 256, 257, 20000, 12345]
            x = list(inputs)
            x[3] = torch.as_tensor(np.array(ragged, np.int32),
                                   device=x[4].device)
            x = [t.to(torch.bfloat16) if t.is_floating_point() else t
                 for t in x]
            res["bf16 ragged"] = paged_check(
                torch, pak, "kernel long", f"bf16 B={B} H={H} Dh={Dh} "
                f"BS={BS} MAXNB={MAXNB} lengths={ragged}", x, controls=True)
            del x
        del inputs
    return res


REQ_LENS = [5, 17, 40, 64, 100, 200, 333, 500, 700, 900, 15, 250]
REQ_MAX = [64, 48, 32, 64, 40, 56, 64, 32, 64, 48, 64, 60]
ORACLE_REQS = (0, 2)


SAMPLED_REQ = 1                  # [serve fp32]: the seeded sampled request's
SAMPLED_KW = dict(temperature=0.9, top_k=20, top_p=0.9, seed=1234)
SAMPLED_MAX = 32                 # prompt (REQ_LENS[1]) and its settings


def _oracle_check(torch, tag, params, scfg, prompt, got, n, **kw):
    """Hold ``got`` against the sequential ``reference_decode``."""
    from paddle_tpu_torch.inference.serving import reference_decode
    with torch.no_grad():
        ref, lg = reference_decode(params, scfg, prompt, n, **kw)
    ref = ref.tolist()
    if got != ref:
        j = next(k for k in range(len(ref)) if got[k] != ref[k])
        top = torch.topk(lg[j].float(), 2).values.tolist()
        raise AssertionError(
            f"{tag}: tokens differ from reference_decode({kw}) at token {j}"
            f" ({got[j]} vs {ref[j]}; oracle top-2 logits {top})")


def serving_phase(torch, seed, dtype, tag, check_oracle):
    """``[serve fp32]`` / ``[serve bf16]``: GPT-2-small through
    ``LLMServer``, 12 greedy requests over 8 slots, every decode dispatch
    a replay of the captured step (``warmup`` captures the greedy and the
    mixed variant)."""
    from paddle_tpu_torch.inference.serving import (LLMServer,
                                                    ServingModelConfig,
                                                    params_from_numpy)
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    from paddle_tpu_torch.models import gpt2_small, init_decode_weights_numpy
    cfg = gpt2_small()
    params = params_from_numpy(init_decode_weights_numpy(cfg, seed),
                               device="cuda", dtype=dtype)
    scfg = ServingModelConfig.from_gpt_config(cfg)
    L = cfg.num_hidden_layers
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in REQ_LENS]
    server = LLMServer(params=params, gpt_config=cfg, max_batch=8,
                       block_size=16, num_blocks=512, eos_id=None,
                       auto_start=False, device="cuda")
    try:
        warm = server.warmup(REQ_LENS)
        pool = pool_reserved(torch, server.engine._graph_pool)
        compiled = server.engine.compile_stats()
        d0 = server.engine.stats()["dispatches"]
        pak.paged_ragged_attention.launches = 0
        pak._cuda_core_paged.launches = 0
        server.start()
        with traced() as spans, prefill_timer(torch) as ptime:
            t0 = time.monotonic()
            futs = [server.submit(p, max_tokens=m)
                    for p, m in zip(prompts, REQ_MAX)]
            results = [f.result(timeout=600) for f in futs]
            wall = time.monotonic() - t0
        launches = pak.paged_ragged_attention.launches
        core_launches = pak._cuda_core_paged.launches
        st = server.stats()
        sampled = None
        if check_oracle:
            # one seeded sampled request alone: the mixed variant's replays
            d1, l1 = server.engine.stats()["dispatches"], launches
            sampled = server.submit(prompts[SAMPLED_REQ],
                                    max_tokens=SAMPLED_MAX,
                                    **SAMPLED_KW).result(timeout=600)
            d_s = server.engine.stats()["dispatches"] - d1
            l_s = pak.paged_ragged_attention.launches - l1
            check(l_s == d_s * L, f"{tag}: sampled run's kernel launches "
                  f"{l_s} != dispatches {d_s} x {L}")
        captures = server.engine.compile_stats()["decode_captures"]
        capture_gate(f"[serve {tag}]", [server.engine], [compiled])
        server.stop()
        prof = profile_dispatches(torch, server.engine, prompts, L)
    finally:
        server.close()
    dispatches = st["dispatches"] - d0
    for r, m in zip(results, REQ_MAX):
        check(len(r.tokens) == m, f"{tag}: {len(r.tokens)} tokens != {m}")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{tag}: token out of vocab")
    check(captures == 2, f"{tag}: {captures} decode captures, want 2 (the "
          "greedy and the mixed variant, each once)")
    check(launches == dispatches * L,
          f"{tag}: kernel launches {launches} != dispatches {dispatches}"
          f" x {L} (counted per replay)")
    check(core_launches == 0, f"{tag}: the comparison entry "
          f"_cuda_core_paged launched {core_launches} times")
    n_tok = sum(len(r.tokens) for r in results)
    cap = st["decode_capture_s"]
    print(f"[serve {tag}] GPT-2-small L=12 D=768 H=12 V=50304: "
          f"{len(results)} requests, {n_tok} tokens in {wall:.4f} s = "
          f"{n_tok / wall:.2f} tokens/s; dispatches={dispatches} "
          f"kernel_launches={launches} (per replay; _cuda_core_paged "
          f"{core_launches}); ttft_p50_s={st['ttft_p50_s']:.6f}"
          f" intertoken_p50_s={st['intertoken_p50_s']:.6f} "
          f"intertoken_p99_s={st['intertoken_p99_s']:.6f}; dispatch host "
          f"us p50 {st['dispatch_host_us_p50']:.1f}; decode captures "
          f"{captures}, capture s greedy {cap['greedy']:.4f} mixed "
          f"{cap['mixed']:.4f}, graph pool "
          f"{'n/a' if pool is None else f'{pool / 2**20:.1f} MiB'}; "
          f"warmup_s={warm['warmup_s']:.3f} ({warm['prefill_captures']} "
          f"prefill programs captured, none in the timed window); "
          f"{prefill_line(spans, ptime)}; {spans_line(spans)}",
          flush=True)
    if check_oracle:
        for i in ORACLE_REQS:
            _oracle_check(torch, f"{tag} request {i}", params, scfg,
                          prompts[i], results[i].tokens, REQ_MAX[i])
        print(f"[serve {tag}] greedy tokens of requests {ORACLE_REQS} equal"
              " the sequential reference_decode", flush=True)
        _oracle_check(torch, f"{tag} sampled request", params, scfg,
                      prompts[SAMPLED_REQ], sampled.tokens, SAMPLED_MAX,
                      **SAMPLED_KW)
        print(f"[serve {tag}] the seeded sampled request ({SAMPLED_KW}, "
              f"{SAMPLED_MAX} tokens) equals reference_decode with the "
              "same settings", flush=True)
    print(f"[serve {tag}] {profile_line(prof)}", flush=True)
    return {"launches": launches, "dispatches": dispatches,
            "core_launches": core_launches, "tokens_per_s": n_tok / wall,
            "wall_s": wall, "captures": captures,
            "capture_s": cap, "pool": pool,
            "dispatch_host_us": st["dispatch_host_us_p50"],
            "ttft_p50_s": st["ttft_p50_s"],
            "intertoken_p50_s": st["intertoken_p50_s"],
            "tokens": [r.tokens for r in results], "profile": prof,
            "spans": spans, "prefill": ptime,
            "prefill_captures": warm["prefill_captures"],
            "warmup_s": warm["warmup_s"]}


def traced():
    """A context that arms ``observability.trace`` around a timed run
    and yields the dict its span summary fills at exit (host ms per
    span name: prefill forwards, decode dispatches, migrations)."""
    import contextlib
    from paddle_tpu_torch.observability import trace

    @contextlib.contextmanager
    def run():
        out = {}
        trace.clear()
        trace.enable()
        try:
            yield out
        finally:
            trace.disable()
            out.update(trace.summary())
            trace.clear()
    return run()


def spans_line(spans):
    """The host time of the traced run's engine spans, in words."""
    return "host ms in spans (count, total, max): " + ", ".join(
        f"{k} {v['count']} {v['total']:.3f} {v['max']:.3f}"
        for k, v in sorted(spans.items()) if k.startswith("serving."))


PREFILL_SPANS = ("serving.prefill", "serving.prefill_chunk")


def prefill_timer(torch):
    """A context that records CUDA events on the engine's stream around
    every grouped prefill and every prefill chunk any engine runs while
    it is open (``DecodeEngine._prefill_grouped`` given a group,
    ``_advance_prefill`` given a job), and yields the dict it fills at
    exit: ``calls`` and ``device_ms``, the stream's time from each
    call's first device work to its last (idle gaps where the host had
    not yet enqueued the next kernel count too)."""
    import contextlib
    from paddle_tpu_torch.inference.serving.engine import DecodeEngine

    def timed(orig, busy, marks):
        def fn(self, *args):
            if not busy(self, *args):
                return orig(self, *args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(self, *args)
            end.record()
            marks.append((start, end))
            return out
        return fn

    @contextlib.contextmanager
    def run():
        out, marks = {}, []
        grouped = DecodeEngine._prefill_grouped
        advance = DecodeEngine._advance_prefill
        DecodeEngine._prefill_grouped = timed(
            grouped, lambda eng, seated: bool(seated), marks)
        DecodeEngine._advance_prefill = timed(
            advance, lambda eng: bool(eng._prefill_jobs), marks)
        try:
            yield out
        finally:
            DecodeEngine._prefill_grouped = grouped
            DecodeEngine._advance_prefill = advance
            for _, end in marks:
                end.synchronize()
            out.update(calls=len(marks), device_ms=sum(
                s.elapsed_time(e) for s, e in marks))
    return run()


def prefill_line(spans, timer):
    """Host ms in the prefill spans and device ms of the same calls."""
    host = sum(spans[k]["total"] for k in PREFILL_SPANS if k in spans)
    n = sum(spans[k]["count"] for k in PREFILL_SPANS if k in spans)
    return (f"prefill: {n} calls, host {host:.3f} ms in spans, device "
            f"{timer['device_ms']:.3f} ms (stream time over the "
            f"{timer['calls']} engine steps that prefilled)")


def capture_gate(name, engines, before):
    """No prefill program captured in a timed window: ``before`` is each
    engine's ``compile_stats()`` after its warm-up."""
    for eng, st in zip(engines, before):
        now = eng.compile_stats()
        for key in ("prefill_captures", "chunk_captures"):
            check(now[key] == st[key], f"{name}: {key} moved from "
                  f"{st[key]} to {now[key]} in the timed window (a shape "
                  "key the warm-up did not reach)")


REPLAY_CALLS = 20                # replays timed alone on the host
PROFILE_REQS = 8                 # the profiled window: the first 8 prompts
PROFILE_MAX = 41                 # of REQ_LENS, 41 tokens each (8 windows of
                                 # k+1 = 5 after the prefill's token)


def kernel_calls(prof, calls_per_dispatch):
    """K1's device microseconds per call in a profiled window of graph
    replays, by the call's place in its dispatch: the split and (with
    several splits) the combine that follows it are one call.  Returns
    ``[us]`` of length ``calls_per_dispatch`` (each place's mean), or
    None where the trace does not hold whole dispatches."""
    from torch.autograd import DeviceType
    evs = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name)
                 for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and ("paged_split" in e.name or "paged_combine" in e.name))
    calls = []
    for _, us, name in evs:
        if "paged_split" in name:
            calls.append(us)
        elif calls:
            calls[-1] += us
    if not calls or len(calls) % calls_per_dispatch:
        return None
    per = np.asarray(calls).reshape(-1, calls_per_dispatch)
    return per.mean(axis=0).tolist()


def profile_dispatches(torch, eng, prompts, L):
    """Seat ``PROFILE_REQS`` greedy requests of ``PROFILE_MAX`` tokens on
    ``eng`` (pump stopped, steps captured), then profile the dispatches
    that drain them: device-busy ms a dispatch (every kernel's device
    time over the dispatches) and K1's device ms a call, split by rows
    (speculative: the draft's ``[B]`` calls and the verify's
    ``[B*(k+1)]``)."""
    k = eng.spec_k
    reqs = [eng.submit(p, max_tokens=PROFILE_MAX)
            for p in prompts[:PROFILE_REQS]]
    eng.step()                         # admits and prefills them all
    check(all(r.lazy_tokens for r in reqs),
          "profiled window: every request seated in one step")
    torch.cuda.synchronize()
    d0 = eng.stats()["dispatches"]
    with profile_window(torch) as prof:
        eng.run_until_idle()
        torch.cuda.synchronize()
    n = eng.stats()["dispatches"] - d0
    busy_us = sum(kernel_us(e) for e in prof.key_averages())
    per = kernel_calls(prof, L * (k + 1))
    # the host's cost of one replay alone (cudaGraphLaunch), each on an
    # idle device and an all-inactive batch (one dispatch stages the
    # drained engine's layout first): what a dispatch's host time owes
    # to the graph's size
    eng._decode_dispatch(False)
    step = eng._steps[False]
    host = []
    for _ in range(REPLAY_CALLS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step.replay()
        host.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    out = {"dispatches": n, "busy_ms": busy_us / 1e3 / n,
           "k1_ms": None, "k1_verify_ms": None,
           "replay_host_us": float(np.median(host)) * 1e6,
           "tokens": sum(len(r.future.result(timeout=0).tokens)
                         for r in reqs)}
    if per is not None:
        out["k1_ms"] = float(np.mean(per[:L * k] if k else per)) / 1e3
        if k:
            out["k1_verify_ms"] = float(np.mean(per[L * k:])) / 1e3
    return out


def profile_line(p):
    """The profiled window of :func:`profile_dispatches`, in words."""
    k1 = ("not measured (the trace did not hold whole dispatches)"
          if p["k1_ms"] is None else f"{p['k1_ms']:.5f} ms a call at [B]")
    if p["k1_verify_ms"] is not None:
        k1 += f", {p['k1_verify_ms']:.5f} ms a call at [B*(k+1)]"
    return (f"profiled window ({PROFILE_REQS} requests x {PROFILE_MAX} "
            f"tokens, {p['tokens']} tokens, {p['dispatches']} dispatches "
            f"profiled): device busy {p['busy_ms']:.4f} ms a dispatch; K1 "
            f"device {k1}; a greedy replay alone costs the host "
            f"{p['replay_host_us']:.1f} us (median of {REPLAY_CALLS})")


SPEC_K = 4                       # [serve spec]: proposals a window
BF16_GAP_ULPS = 4                # [serve spec bf16]: a token may differ from
                                 # the plain engine's, or from the argmax of
                                 # its own prefix's logits (teacher-forced
                                 # prefill, bf16), only where the two
                                 # tokens' logits lie within this many bf16
                                 # ulps of each other: the verify's matmuls
                                 # run at 40 rows where the plain step runs
                                 # 8, and round their sums in another order
TF_ROWS = 16                     # prefixes a teacher-forced prefill group holds


def teacher_forced_gaps(torch, params, scfg, prompt, got):
    """Every token of ``got`` on its own prefix: prefill groups whose row
    ``j`` holds ``prompt + got[:j]`` (each row the one causal sequence,
    read at its own length) give each prefix's next-token logits.
    Returns ``[(gap, ulp)]`` per token: how far ``got[j]``'s logit lies
    below the row's largest (0 where it is the argmax), and one bf16 ulp
    at their magnitude."""
    from paddle_tpu_torch.inference.serving.decode_model import (
        prefill_group_forward)
    seq = list(prompt) + list(got[:-1])
    out = []
    for j0 in range(0, len(got), TF_ROWS):
        js = list(range(j0, min(len(got), j0 + TF_ROWS)))
        G, n = len(js), len(prompt) + js[-1]
        ids = torch.tensor([seq[:n]] * G, dtype=torch.int32,
                           device=params.wte.device)
        with torch.no_grad():
            _, _, lg = prefill_group_forward(
                params, scfg, ids, [len(prompt) + j for j in js], [0.0] * G,
                [0] * G, [1.0] * G, [0] * G)
        lg = lg.float()
        top = lg.max(dim=1).values.cpu().numpy()
        mine = lg[torch.arange(G, device=lg.device),
                  torch.tensor([got[j] for j in js],
                               device=lg.device)].cpu().numpy()
        for t, m in zip(top, mine):
            mag = max(abs(float(t)), abs(float(m)), 1e-30)
            out.append((float(t - m), 2.0 ** (np.floor(np.log2(mag)) - 7)))
        del ids, lg
    return out


def _departure(torch, params, scfg, prompt, got, want):
    """Where ``got`` first departs from ``want``: ``(index, gap, ulp,
    top2)`` with the logits of the shared prefix's next token by a
    teacher-forced prefill (both runs saw the same tokens up to there),
    the gap between the two tokens' logits, one bf16 ulp at their
    magnitude and the top two logits; None where they agree."""
    from paddle_tpu_torch.inference.serving import prefill_forward
    j = next((i for i in range(min(len(got), len(want)))
              if got[i] != want[i]), None)
    if j is None:
        return None
    ids = list(prompt) + list(want[:j])
    with torch.no_grad():
        _, _, lg = prefill_forward(
            params, scfg, torch.tensor([ids], dtype=torch.int32,
                                       device=params.wte.device), len(ids))
    row = lg.float()
    a, b = float(row[got[j]]), float(row[want[j]])
    top2 = torch.topk(row, 2).values.tolist()
    ulp = 2.0 ** (np.floor(np.log2(max(abs(a), abs(b), 1e-30))) - 7)
    return j, abs(a - b), ulp, top2


def serve_spec_phase(torch, seed, dtype, tag, plain):
    """``[serve spec fp32]`` / ``[serve spec bf16]``: GPT-2-small through
    ``LLMServer(draft_params=..., spec_k=SPEC_K)``, the 12 requests of
    ``[serve fp32/bf16]`` over 8 slots, every decode dispatch a replay of
    one of the two captured speculative variants, with a self-draft and
    with an adversarial draft (weights from ``seed + 1``).  ``plain`` is
    the plain engine's result in the same dtype (its tokens and
    tokens/s)."""
    from paddle_tpu_torch.inference.serving import (LLMServer,
                                                    ServingModelConfig,
                                                    params_from_numpy)
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    from paddle_tpu_torch.models import gpt2_small, init_decode_weights_numpy
    cfg = gpt2_small()
    scfg = ServingModelConfig.from_gpt_config(cfg)
    L, k = cfg.num_hidden_layers, SPEC_K
    params = params_from_numpy(init_decode_weights_numpy(cfg, seed),
                               device="cuda", dtype=dtype)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in REQ_LENS]
    out = {}
    for draft_tag in ("self", "adversarial"):
        name = f"[serve spec {tag} {draft_tag}]"
        draft = params if draft_tag == "self" else params_from_numpy(
            init_decode_weights_numpy(cfg, seed + 1), device="cuda",
            dtype=dtype)
        server = LLMServer(params=params, gpt_config=cfg, draft_params=draft,
                           spec_k=k, max_batch=8, block_size=16,
                           num_blocks=512, eos_id=None, auto_start=False,
                           device="cuda")
        eng = server.engine
        try:
            warm = server.warmup(REQ_LENS)
            pool = pool_reserved(torch, eng._graph_pool)
            d0 = eng.stats()["dispatches"]
            pak.paged_ragged_attention.launches = 0
            pak._cuda_core_paged.launches = 0
            server.start()
            t0 = time.monotonic()
            futs = [server.submit(p, max_tokens=m)
                    for p, m in zip(prompts, REQ_MAX)]
            results = [f.result(timeout=600) for f in futs]
            wall = time.monotonic() - t0
            launches = pak.paged_ragged_attention.launches
            core_launches = pak._cuda_core_paged.launches
            st = server.stats()
            sampled = None
            if dtype == torch.float32:
                d1, l1 = eng.stats()["dispatches"], launches
                sampled = server.submit(prompts[SAMPLED_REQ],
                                        max_tokens=SAMPLED_MAX,
                                        **SAMPLED_KW).result(timeout=600)
                d_s = eng.stats()["dispatches"] - d1
                l_s = pak.paged_ragged_attention.launches - l1
                check(l_s == d_s * L * (k + 1), f"{name} sampled run's "
                      f"kernel launches {l_s} != dispatches {d_s} x {L} x "
                      f"{k + 1}")
            captures = eng.compile_stats()["decode_captures"]
            server.stop()
            kv = eng._kv.allocator.stats()
            prof = profile_dispatches(torch, eng, prompts, L)
            kv_after = eng._kv.allocator.stats()
        finally:
            server.close()
        dispatches = st["dispatches"] - d0
        spec = st["spec"]
        for r, m in zip(results, REQ_MAX):
            check(len(r.tokens) == m, f"{name} {len(r.tokens)} tokens != {m}")
            check(all(0 <= t < cfg.vocab_size for t in r.tokens),
                  f"{name} token out of vocab")
        check(captures == 2, f"{name} {captures} decode captures, want 2 "
              "(the greedy and the mixed speculative variant, each once)")
        check(launches == dispatches * L * (k + 1),
              f"{name} kernel launches {launches} != dispatches "
              f"{dispatches} x {L} x {k + 1} (counted per replay)")
        check(core_launches == 0, f"{name} the comparison entry "
              f"_cuda_core_paged launched {core_launches} times")
        for when, a in (("after the drain", kv),
                        ("after the profiled window", kv_after)):
            check(a["allocated"] == 0 and a["reserved"] == 0,
                  f"{name} allocator not empty {when}: {a}")
        # the plain engine's tokens: equal, or (bf16) a departure where the
        # two candidates were tied within the bf16 rounding bound
        departures = []
        for i, (r, want) in enumerate(zip(results, plain["tokens"])):
            d = _departure(torch, params, scfg, prompts[i], r.tokens, want)
            if d is None:
                continue
            j, gap, ulp, top2 = d
            departures.append((i, j))
            print(f"{name} request {i} departs from the plain engine at "
                  f"token {j} ({r.tokens[j]} vs {want[j]}): their logits "
                  f"differ by {gap:.6g} = {gap / ulp:.3f} bf16 ulps; "
                  f"top-2 logits {top2}", flush=True)
            check(dtype != torch.float32, f"{name} request {i}: fp32 "
                  "tokens differ from the plain fp32 engine's")
            check(gap <= BF16_GAP_ULPS * ulp, f"{name} request {i}: the "
                  f"departure's logit gap {gap:.6g} exceeds "
                  f"{BF16_GAP_ULPS} bf16 ulps ({BF16_GAP_ULPS * ulp:.6g})")
        # bf16: every token against the argmax of its own prefix's logits,
        # past any departure too
        not_top, worst = 0, 0.0
        if dtype != torch.float32:
            for i, r in enumerate(results):
                for j, (gap, ulp) in enumerate(teacher_forced_gaps(
                        torch, params, scfg, prompts[i], r.tokens)):
                    not_top += gap > 0
                    worst = max(worst, gap / ulp)
                    check(gap <= BF16_GAP_ULPS * ulp, f"{name} request {i} "
                          f"token {j} ({r.tokens[j]}): its logit lies "
                          f"{gap:.6g} = {gap / ulp:.3f} bf16 ulps below its "
                          f"prefix's largest, over {BF16_GAP_ULPS}")
        n_tok = sum(len(r.tokens) for r in results)
        cap = st["decode_capture_s"]
        res = {"tokens_per_s": n_tok / wall, "wall_s": wall,
               "dispatches": dispatches, "launches": launches,
               "launches_per_dispatch": launches / dispatches,
               "tokens_per_dispatch": spec["tokens_per_dispatch"],
               "accept_rate": spec["accept_rate"], "captures": captures,
               "capture_s": cap, "pool": pool, "profile": prof,
               "departures": departures, "not_argmax": not_top,
               "worst_gap_ulps": worst,
               "dispatch_host_us": st["dispatch_host_us_p50"]}
        out[draft_tag] = res
        print(f"{name} GPT-2-small L=12 D=768 H=12 V=50304, k={k}: "
              f"{len(results)} requests, {n_tok} tokens in {wall:.4f} s = "
              f"{n_tok / wall:.2f} tokens/s (plain {tag} engine, this run: "
              f"{plain['tokens_per_s']:.2f}); dispatches={dispatches} "
              f"({plain['dispatches']} plain), tokens per lane-dispatch "
              f"{spec['tokens_per_dispatch']:.4f}, accept rate "
              f"{spec['accept_rate']:.4f}; K1 launches {launches} = "
              f"{launches / dispatches:.1f} a dispatch (per replay; "
              f"_cuda_core_paged {core_launches}); dispatch host us p50 "
              f"{st['dispatch_host_us_p50']:.1f}; ttft_p50_s="
              f"{st['ttft_p50_s']:.6f}; decode captures {captures}, "
              f"capture s greedy {cap['greedy']:.4f} mixed "
              f"{cap['mixed']:.4f}, graph pool "
              f"{'n/a' if pool is None else f'{pool / 2**20:.1f} MiB'}; "
              f"warmup_s={warm['warmup_s']:.3f}; allocator empty after the "
              f"drain", flush=True)
        print(f"{name} {profile_line(prof)}", flush=True)
        if dtype == torch.float32:
            for i in ORACLE_REQS:
                _oracle_check(torch, f"{name} request {i}", params, scfg,
                              prompts[i], results[i].tokens, REQ_MAX[i])
            _oracle_check(torch, f"{name} sampled request", params, scfg,
                          prompts[SAMPLED_REQ], sampled.tokens, SAMPLED_MAX,
                          **SAMPLED_KW)
            print(f"{name} all 12 requests' tokens equal the plain fp32 "
                  f"engine's; requests {ORACLE_REQS} and the seeded sampled "
                  f"request ({SAMPLED_KW}) equal reference_decode",
                  flush=True)
        else:
            print(f"{name} {12 - len(departures)} of 12 requests' tokens "
                  "equal the plain bf16 engine's; departures (request, "
                  f"token) {departures}, each within {BF16_GAP_ULPS} bf16 "
                  f"ulps; teacher-forced on its own prefix, {not_top} of "
                  f"{n_tok} tokens are not that prefix's argmax, the "
                  f"farthest {worst:.3f} bf16 ulps below it (<= "
                  f"{BF16_GAP_ULPS})", flush=True)
        del server, eng, draft
        torch.cuda.empty_cache()
    return out


REFRESH_REQS = (0, 2, 5, 11)     # [serve refresh]: four of the 12 prompts,
REFRESH_MAX = 24                 # 24 tokens each


def serve_refresh_phase(torch, seed):
    """``[serve refresh]``: ``LLMServer(network)`` on the port's training
    ``GPTForCausalLM`` at GPT-2-small (fp32, random weights from
    ``seed``), four greedy requests, the pump stopped, then
    ``refresh_weights`` from a second network (``seed + 1``): the same
    requests give a fresh server's tokens on the second network, the
    captured steps are the same objects and ``decode_captures`` does not
    move."""
    from paddle_tpu_torch.inference.serving import LLMServer
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small
    cfg = gpt2_small(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)

    def network(s):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(s)
        net = GPTForCausalLM(cfg, device="cuda", generator=gen)
        net.eval()
        return net

    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in REQ_LENS]
    prompts = [prompts[i] for i in REFRESH_REQS]
    kw = dict(max_batch=8, block_size=16, num_blocks=512, eos_id=None,
              auto_start=False, device="cuda")

    def run(server):
        server.start()
        try:
            return [f.result(timeout=600).tokens for f in
                    [server.submit(p, max_tokens=REFRESH_MAX)
                     for p in prompts]]
        finally:
            server.stop()

    net_a, net_b = network(seed), network(seed + 1)
    server = LLMServer(net_a, **kw)
    try:
        server.warmup([len(p) for p in prompts])
        steps = dict(server.engine._steps)
        before = run(server)
        captures = server.engine.compile_stats()["decode_captures"]
        prefill = server.engine.compile_stats()["prefill_captures"]
        t0 = time.monotonic()
        server.refresh_weights(net_b)
        torch.cuda.synchronize()
        refresh_s = time.monotonic() - t0
        after = run(server)
        same = server.engine._steps == steps
        captures_after = server.engine.compile_stats()["decode_captures"]
        prefill_after = server.engine.compile_stats()["prefill_captures"]
    finally:
        server.close()
    del net_a
    fresh = LLMServer(net_b, **kw)
    try:
        fresh.warmup([len(p) for p in prompts])
        want = run(fresh)
    finally:
        fresh.close()
    del net_b, server, fresh
    torch.cuda.empty_cache()
    check(captures == 2 and captures_after == 2 and same
          and prefill == prefill_after,
          f"[serve refresh] decode captures {captures} -> {captures_after}"
          f" (same graphs: {same}), prefill captures {prefill} -> "
          f"{prefill_after}; a refresh must not capture again")
    check(after == want, "[serve refresh] tokens after refresh_weights "
          "differ from a fresh server's on the new network")
    check(after != before, "[serve refresh] the refreshed server still "
          "gives the old network's tokens")
    print(f"[serve refresh] LLMServer(GPTForCausalLM GPT-2-small fp32): "
          f"{len(prompts)} requests x {REFRESH_MAX} tokens, then "
          f"refresh_weights(a second network) in {refresh_s:.4f} s: tokens "
          f"equal a fresh server's on it (each first token from a captured "
          f"prefill program), decode captures {captures} -> "
          f"{captures_after}, prefill captures {prefill} -> "
          f"{prefill_after}, the same captured graphs", flush=True)
    return {"refresh_s": refresh_s}


def serve_noise_phase(torch, seed):
    """``[serve noise]``: the sampler's hashed Gumbel noise of a
    ``[8, 50304]`` batch of (seed, position) on the card, bit for bit
    against the CPU."""
    from paddle_tpu_torch.inference.serving.sampling import (gumbel_noise,
                                                             noise_bits)
    s = torch.arange(8, dtype=torch.int64) * 2654435761 % 2 ** 32 + seed
    p = torch.arange(8, dtype=torch.int64) * 4099 + 17
    dev = torch.device("cuda")
    bits = noise_bits(s.to(dev), p.to(dev), 50304).cpu()
    card = gumbel_noise(s.to(dev), p.to(dev), 50304).cpu()
    check(torch.equal(bits, noise_bits(s, p, 50304)),
          "[serve noise] hash bits differ between the card and the CPU")
    cpu = gumbel_noise(s, p, 50304)
    diff = int((card.view(torch.int32) != cpu.view(torch.int32)).sum())
    check(diff == 0, f"[serve noise] {diff} of {cpu.numel()} noise values "
          "differ between the card and the CPU")
    print(f"[serve noise] [8, 50304] Gumbel noise bit-identical on the card "
          f"and the CPU (hash bits and float32 values; min {cpu.min():.4f} "
          f"max {cpu.max():.4f})", flush=True)


LONG_CTX = 32768                 # the long-context tier (bench.py:1262-1400)
LONG_BS, LONG_CHUNK = 256, 1024
LONG_PROMPT = LONG_CTX - LONG_BS
LONG_POSITIONS = LONG_CTX + 512


def _long_cfg():
    from paddle_tpu_torch.models import gpt2_small
    return gpt2_small(max_position_embeddings=LONG_POSITIONS)


def _long_params(torch, seed, dtype):
    from paddle_tpu_torch.inference.serving import params_from_numpy
    from paddle_tpu_torch.models import init_decode_weights_numpy
    return params_from_numpy(init_decode_weights_numpy(_long_cfg(), seed),
                             device="cuda", dtype=dtype)


def _drive(torch, eng, req):
    """Step ``eng`` until ``req`` has its first token, synchronising
    after each step; returns each step's seconds."""
    steps = []
    while not req.lazy_tokens:
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
    return steps


def serve_long_phase(torch, seed):
    """``[serve long]``: GPT-2-small at full width with 33280 positions,
    bf16, ``max_batch=2``, pages of 256, ``prefill_chunk=1024``,
    ``prefix_cache=True``: one prompt of 32512 tokens (max_tokens 4,
    temperature 0.8, seed 1) chunk by chunk, then the same prompt again
    (a prefix-cache hit of 126 blocks) decoding 64 tokens at a 32k
    context through K1, timed, and once more profiled for K1's device
    time per launch.  Then ``[serve long fp32]``: a 4032-token prompt
    through ``prefill_chunk=512`` against the same engine unchunked and
    ``reference_decode`` (greedy tokens equal)."""
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    cfg = _long_cfg()
    L = cfg.num_hidden_layers
    params = _long_params(torch, seed, torch.bfloat16)
    rng = np.random.default_rng(seed + 7)
    prompt = rng.integers(0, cfg.vocab_size, LONG_PROMPT).tolist()
    eng = DecodeEngine(params=params, gpt_config=cfg, max_batch=2,
                       block_size=LONG_BS, num_blocks=136,
                       prefill_chunk=LONG_CHUNK, prefix_cache=True,
                       device="cuda")
    res = {}
    with torch.no_grad():
        warm = eng.warmup([2048, LONG_PROMPT])
        compiled = eng.compile_stats()
        # a warm-up request (two chunks of another prompt)
        w = eng.submit(rng.integers(0, cfg.vocab_size, 2048).tolist(),
                       max_tokens=2)
        eng.run_until_idle()
        check(len(w.future.result(timeout=0).tokens) == 2,
              "[serve long] warm-up request")
        torch.cuda.synchronize()
        c0 = eng.stats()["prefill_chunks"]
        with traced() as spans, prefill_timer(torch) as ptime:
            t0 = time.perf_counter()
            req = eng.submit(prompt, max_tokens=4, temperature=0.8, seed=1)
            steps = _drive(torch, eng, req)
            ttft = time.perf_counter() - t0
        chunks = eng.stats()["prefill_chunks"] - c0
        eng.run_until_idle()
        toks = req.future.result(timeout=0).tokens
        check(len(toks) == 4 and all(0 <= t < cfg.vocab_size for t in toks),
              f"[serve long] tokens {toks}")
        check(chunks == -(-LONG_PROMPT // LONG_CHUNK),
              f"[serve long] {chunks} chunks")
        hits0 = eng.stats()["prefix_cache"]["hits"]
        # the same prompt again: 126 blocks from the cache, one chunk,
        # then 63 decode dispatches at a 32k context
        pak.paged_ragged_attention.launches = 0
        d0 = eng.stats()["dispatches"]
        req = eng.submit(prompt, max_tokens=64)
        _drive(torch, eng, req)
        t1 = time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t1
        dispatches = eng.stats()["dispatches"] - d0
        launches = pak.paged_ragged_attention.launches
        check(len(req.future.result(timeout=0).tokens) == 64,
              "[serve long] second request's tokens")
        check(launches == dispatches * L, f"[serve long] K1 launches "
              f"{launches} != dispatches {dispatches} x {L}")
        hits = eng.stats()["prefix_cache"]["hits"] - hits0
        check(hits == (LONG_PROMPT - 1) // LONG_BS,
              f"[serve long] prefix hits {hits}")
        req = eng.submit(prompt, max_tokens=17)
        _drive(torch, eng, req)
        d1 = eng.stats()["dispatches"]
        with profile_window(torch) as prof:
            eng.run_until_idle()
            torch.cuda.synchronize()
        n_prof = eng.stats()["dispatches"] - d1
        allev = sorted(((kernel_us(e), e.key)
                        for e in prof.key_averages()), reverse=True)
        busy_us = sum(us for us, _ in allev)
        print(f"[serve long] profiled decode: {n_prof} dispatches, device "
              f"busy {busy_us / 1e3 / n_prof:.4f} ms a dispatch; top "
              "kernels (ms a dispatch): " + "; ".join(
                  f"{k[:60]} {us / 1e3 / n_prof:.4f}"
                  for us, k in allev[:6]), flush=True)
        ev = [e for e in prof.key_averages()
              if any(n in e.key for n in ("paged_split", "paged_combine",
                                          "paged_attn"))]
        k1_us = sum(kernel_us(e) / e.count for e in ev)
        kept = min((e.count for e in ev), default=0)
        check(kept >= 8 * L, f"[serve long] the profiler kept {kept} K1 "
              "launches")
        captures = eng.compile_stats()["decode_captures"]
        capture_gate("[serve long]", [eng], [compiled])
        eng.release_graphs()
    check(len(steps) == chunks, f"[serve long] {len(steps)} steps for "
          f"{chunks} chunks")
    res.update({"ttft_s": ttft, "chunks": chunks,
                "chunk_p50_s": float(np.percentile(steps, 50)),
                "chunk_p99_s": float(np.percentile(steps, 99)),
                "decode_tokens_per_s": (dispatches - 1) / dec_s,
                "decode_busy_ms": busy_us / 1e3 / n_prof,
                "k1_device_ms": k1_us / 1e3, "launches_per_dispatch":
                launches / dispatches, "prefix_hits": hits,
                "captures": captures, "prefill": ptime,
                "chunk_captures": warm["chunk_captures"]})
    print(f"[serve long] GPT-2-small L=12 D=768 positions {LONG_POSITIONS} "
          f"bf16, max_batch=2 BS={LONG_BS} prefill_chunk={LONG_CHUNK} "
          f"prefix_cache: a {LONG_PROMPT}-token prompt: TTFT {ttft:.4f} s "
          f"in {chunks} chunks (s per chunk p50 {res['chunk_p50_s']:.4f}, "
          f"p99 {res['chunk_p99_s']:.4f}); tokens {toks}; again from the "
          f"cache ({hits} block hits): {dispatches - 1} decode tokens at "
          f"{res['decode_tokens_per_s']:.2f} tokens/s, K1 launches "
          f"{launches} = {launches / dispatches:.1f} per dispatch, K1 "
          f"device {k1_us / 1e3:.5f} ms per launch at B=2 with one "
          f"{LONG_PROMPT}-{LONG_PROMPT + 17}-token context (profiled "
          f"replays); decode captures {captures}; warm-up "
          f"{warm['warmup_s']:.3f} s captured {warm['chunk_captures']} chunk "
          f"programs {warm['chunk_keys']}, none after it; the TTFT window's "
          f"{prefill_line(spans, ptime)}", flush=True)
    del eng, params
    torch.cuda.empty_cache()
    res.update(serve_long_fp32(torch, seed))
    return res


def serve_long_fp32(torch, seed):
    """``[serve long fp32]``: the chunked engine against the unchunked
    one and the sequential oracle at 4032 tokens, greedy, fp32."""
    from paddle_tpu_torch.inference.serving import (DecodeEngine,
                                                    ServingModelConfig)
    cfg = _long_cfg()
    params = _long_params(torch, seed, torch.float32)
    prompt = np.random.default_rng(seed + 8).integers(
        0, cfg.vocab_size, 4032).tolist()
    out = {}
    with torch.no_grad():
        for chunk in (512, None):
            eng = DecodeEngine(params=params, gpt_config=cfg, max_batch=2,
                               block_size=LONG_BS, num_blocks=40,
                               prefill_chunk=chunk, device="cuda")
            f = eng.submit(prompt, max_tokens=8).future
            eng.run_until_idle()
            out[chunk] = f.result(timeout=0).tokens
            check(eng.stats()["prefill_chunks"] == (8 if chunk else 0),
                  f"[serve long fp32] chunks {eng.stats()['prefill_chunks']}")
            eng.release_graphs()
    check(out[512] == out[None], f"[serve long fp32] chunked {out[512]} != "
          f"unchunked {out[None]}")
    _oracle_check(torch, "[serve long fp32]", params,
                  ServingModelConfig.from_gpt_config(cfg), prompt, out[512],
                  8)
    print(f"[serve long fp32] a 4032-token prompt in 8 chunks of 512: greedy"
          f" tokens {out[512]} equal the unchunked engine's and "
          "reference_decode's", flush=True)
    return {"fp32_tokens": out[512]}


PREFIX_SYSTEM, PREFIX_OWN, PREFIX_REQS = 512, 16, 12


def serve_prefix_phase(torch, seed):
    """``[serve prefix]``: GPT-2-small, bf16, ``max_batch=4``, pages of
    16, ``prefill_chunk=128``, ``prefix_cache=True``: 12 requests, each a
    shared 512-token system prompt and 16 tokens of its own, each run
    to completion before the next."""
    from paddle_tpu_torch.inference.serving import (DecodeEngine,
                                                    params_from_numpy)
    from paddle_tpu_torch.models import gpt2_small, init_decode_weights_numpy
    cfg = gpt2_small()
    params = params_from_numpy(init_decode_weights_numpy(cfg, seed),
                               device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(seed + 9)
    system = rng.integers(0, cfg.vocab_size, PREFIX_SYSTEM).tolist()
    eng = DecodeEngine(params=params, gpt_config=cfg, max_batch=4,
                       block_size=16, num_blocks=512, prefill_chunk=128,
                       prefix_cache=True, device="cuda")
    ttft = []
    with torch.no_grad():
        eng.warmup([PREFIX_SYSTEM + PREFIX_OWN])
        for _ in range(PREFIX_REQS):
            p = system + rng.integers(0, cfg.vocab_size,
                                      PREFIX_OWN).tolist()
            t0 = time.perf_counter()
            req = eng.submit(p, max_tokens=16)
            _drive(torch, eng, req)
            ttft.append(time.perf_counter() - t0)
            eng.run_until_idle()
            check(len(req.future.result(timeout=0).tokens) == 16,
                  "[serve prefix] tokens")
        pc = eng.stats()["prefix_cache"]
        eng.release_graphs()
    shareable = (PREFIX_SYSTEM + PREFIX_OWN - 1) // 16
    check(pc["misses"] == shareable and
          pc["hits"] == shareable * (PREFIX_REQS - 1),
          f"[serve prefix] hits {pc['hits']} misses {pc['misses']}")
    res = {"hit_rate": pc["hit_rate"], "skipped_tokens": pc["hits"] * 16,
           "ttft_miss_s": ttft[0],
           "ttft_hit_p50_s": float(np.percentile(ttft[1:], 50))}
    print(f"[serve prefix] GPT-2-small bf16, {PREFIX_REQS} requests of a "
          f"shared {PREFIX_SYSTEM}-token system prompt + {PREFIX_OWN} own: "
          f"hit rate {pc['hit_rate']:.4f} ({pc['hits']} block hits, "
          f"{pc['misses']} misses), {res['skipped_tokens']} prompt tokens "
          f"skipped; TTFT (synchronised) first {ttft[0]:.5f} s, hits p50 "
          f"{res['ttft_hit_p50_s']:.5f} s", flush=True)
    return res


def chunk_gap_phase(torch, seed):
    """``[serve chunk gap]``: the inter-token gaps a streaming request
    sees (each token read as it comes) while a 4032-token prompt is
    admitted, with ``prefill_chunk=512`` and with the whole prompt at
    once; bf16, full width, 33280 positions, ``max_batch=2``, pages of
    16.  Each configuration runs twice; the second run is read.  A third
    run, profiled, reads the device-busy ms of the steps that admit the
    prompt against their wall time (how far the admission is the
    host's)."""
    from paddle_tpu_torch.inference.serving import DecodeEngine
    cfg = _long_cfg()
    params = _long_params(torch, seed, torch.bfloat16)
    rng = np.random.default_rng(seed + 10)
    stream_prompt = rng.integers(0, cfg.vocab_size, 8).tolist()
    long_prompt = rng.integers(0, cfg.vocab_size, 4032).tolist()
    res = {}
    with torch.no_grad():
        for chunk in (512, None):
            eng = DecodeEngine(params=params, gpt_config=cfg, max_batch=2,
                               block_size=16, num_blocks=300,
                               prefill_chunk=chunk, device="cuda")
            eng.warmup([8, 4032])
            compiled = eng.compile_stats()
            for _ in range(2):
                seen = []
                with traced() as spans, prefill_timer(torch) as ptime:
                    eng.submit(stream_prompt, max_tokens=48,
                               stream_cb=lambda rid, i, tok: seen.append(
                                   (int(tok), time.perf_counter())))
                    for _ in range(4):
                        eng.step()
                    eng.submit(long_prompt, max_tokens=2)
                    eng.run_until_idle()
                gaps = np.diff([t for _, t in seen])
            check(len(seen) == 48, f"[serve chunk gap] {len(seen)} tokens")
            key = f"chunk {chunk}" if chunk else "whole"
            res[key] = {"p50_s": float(np.percentile(gaps, 50)),
                        "p99_s": float(np.percentile(gaps, 99)),
                        "max_s": float(gaps.max()),
                        "prefill": prefill_line(spans, ptime)}
            # the profiled run: the steps from the prompt's submit to its
            # first token, each synchronised
            eng.submit(stream_prompt, max_tokens=48)
            for _ in range(4):
                eng.step()
            torch.cuda.synchronize()
            req = eng.submit(long_prompt, max_tokens=2)
            with profile_window(torch) as prof:
                steps = _drive(torch, eng, req)
            eng.run_until_idle()
            busy = sum(kernel_us(e) for e in prof.key_averages()) / 1e3
            res[key].update({"admit_steps": len(steps),
                             "admit_wall_ms": sum(steps) * 1e3,
                             "admit_step_p50_s": float(np.median(steps)),
                             "admit_busy_ms": busy})
            capture_gate(f"[serve chunk gap] {key}", [eng], [compiled])
            eng.release_graphs()
    print("[serve chunk gap] a 48-token stream while a 4032-token prompt is "
          "admitted (bf16, full width): inter-token s " + "; ".join(
              f"{k}: p50 {r['p50_s']:.5f} p99 {r['p99_s']:.5f} max "
              f"{r['max_s']:.5f}, admission (profiled) {r['admit_steps']} "
              f"steps, wall {r['admit_wall_ms']:.3f} ms (s a step p50 "
              f"{r['admit_step_p50_s']:.5f}), device busy "
              f"{r['admit_busy_ms']:.3f} ms; the read run's {r['prefill']}"
              for k, r in res.items()) + "; no capture after warm-up",
          flush=True)
    return res


PREFILL_GROUP_KEYS = ((1, 16), (8, 16), (1, 1024), (8, 1024))
PREFILL_CHUNK = 512              # [serve prefill capture]: the chunk, and
PREFILL_CTX = (4096, 4112)       # its contexts: a power of two and one
                                 # block past it (gathered at 2x its extent)
PREFILL_TIMED = 5                # runs timed a program, replay and eager


def _program_times(torch, eng, fn):
    """Host ms (median enqueue) and device-busy ms (``torch.profiler``)
    a call of ``fn`` on ``eng``'s stream, over ``PREFILL_TIMED`` calls."""
    host = []
    with torch.no_grad(), eng._on_stream():
        fn()
        torch.cuda.synchronize()
        for _ in range(PREFILL_TIMED):
            t = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        with profile_window(torch) as prof:
            for _ in range(PREFILL_TIMED):
                fn()
            torch.cuda.synchronize()
    busy_us = sum(kernel_us(e) for e in prof.key_averages())
    return float(np.median(host)) * 1e3, busy_us / 1e3 / PREFILL_TIMED


def _hold_program(torch, eng, name, prog, host, body, pages):
    """``prog``'s first run (warm-up and capture), then a replay and its
    eager body on the same pool: tokens and pool equal bit for bit, every
    page of ``pages`` written and no block outside them but the scratch
    block; then host and device ms a call of each."""
    from paddle_tpu_torch.inference.serving import SCRATCH_BLOCK
    pool = eng._kv.pool

    def eager():
        prog.inputs.copy_(host, non_blocking=True)
        body()
        return prog.out.clone()

    with torch.no_grad(), eng._on_stream():
        pool0 = pool.clone()
        prog.run(host, body)
        pool.copy_(pool0)
        got = prog.run(host, body)
        replayed = pool.clone()
        pool.copy_(pool0)
        want = eager()
    torch.cuda.synchronize()
    check(prog.captures == 1, f"{name}: {prog.captures} captures")
    check(torch.equal(got, want), f"{name}: the replay's tokens "
          f"{got.tolist()} differ from the eager body's {want.tolist()}")
    # every block but the scratch block, where a group's padding pages
    # all land (an index_put_ with repeated indices keeps any one write)
    keep = [b for b in range(pool.shape[2]) if b != SCRATCH_BLOCK]
    check(torch.equal(replayed[:, :, keep], pool[:, :, keep]),
          f"{name}: the replay's pool differs from the eager body's")
    written = (replayed != pool0).flatten(3).any(-1).any(0).any(
        0).nonzero().flatten().tolist()
    stray = sorted(set(written) - set(pages) - {SCRATCH_BLOCK})
    check(not stray, f"{name}: blocks {stray[:8]} written outside the "
          "request's pages and the scratch block")
    check(set(pages) <= set(written), f"{name}: pages "
          f"{sorted(set(pages) - set(written))[:8]} not written")
    del pool0, replayed
    r_host, r_dev = _program_times(torch, eng, lambda: prog.run(host, body))
    e_host, e_dev = _program_times(torch, eng, eager)
    return {"capture_s": prog.call.capture_s, "replay_host_ms": r_host,
            "replay_device_ms": r_dev, "eager_host_ms": e_host,
            "eager_device_ms": e_dev, "written": len(written),
            "scratch": SCRATCH_BLOCK in written}


def serve_prefill_capture_phase(torch, seed, dtype, tag):
    """``[serve prefill capture fp32/bf16]``: GPT-2-small at full width
    (33280 positions, random weights from ``seed``), ``max_batch=8``,
    pages of 16, ``prefill_chunk=512``, its pool filled with noise; each
    grouped program of ``PREFILL_GROUP_KEYS`` (prompts of random lengths
    in the bucket, every other row sampled) and each chunk of 512 at the
    contexts ``PREFILL_CTX`` (one gathered at 2x its extent), captured,
    held bit for bit against its eager body on the card (tokens and the
    pool: the request's pages and the scratch block written, no other
    block), then timed beside it; no K1 launch."""
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    from paddle_tpu_torch.io.bucketing import shape_bucket
    name = f"[serve prefill capture {tag}]"
    cfg = _long_cfg()
    params = _long_params(torch, seed, dtype)
    rng = np.random.default_rng(seed + 11)
    eng = DecodeEngine(params=params, gpt_config=cfg, max_batch=8,
                       block_size=16, num_blocks=600,
                       prefill_chunk=PREFILL_CHUNK, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    with torch.no_grad():
        eng._kv.pool.normal_(generator=gen)
    pak.paged_ragged_attention.launches = 0
    out = {}
    for Gb, b in PREFILL_GROUP_KEYS:
        prog = eng._group_program(Gb, b)
        host, image = eng._host_image(prog)
        ids, lengths, temps, topks, topps, seeds, blocks = \
            prog.views(image)
        pages, nxt = [], 1
        for g in range(Gb):
            n = int(rng.integers(b // 2 + 1, b + 1))
            ids[g, :n] = rng.integers(0, cfg.vocab_size, n)
            lengths[g] = n
            if g % 2:
                temps[g], topks[g], topps[g] = 0.8, 40, 0.9
                seeds[g] = int(rng.integers(0, 2 ** 32))
            nb = -(-n // 16)
            blocks[g, :nb] = np.arange(nxt, nxt + nb)
            pages += list(range(nxt, nxt + nb))
            nxt += nb
        out[f"group {Gb}x{b}"] = _hold_program(
            torch, eng, f"{name} group {Gb}x{b}", prog, host,
            lambda prog=prog: eng._group_body(prog), pages)
    for ctx in PREFILL_CTX:
        take = PREFILL_CHUNK if ctx == PREFILL_CTX[0] else PREFILL_CHUNK - 7
        nbc = shape_bucket(ctx // 16, eng._ctx_buckets)
        prog = eng._chunk_program(PREFILL_CHUNK, nbc)
        host, image = eng._host_image(prog)
        table, ctx_len, ids, chunk_len, blocks, temp, topk, topp, seed_ = \
            prog.views(image)
        # the request's page-table row as the engine holds it (context
        # pages, then the chunk's, then scratch), cut at the extent
        ctx_pages = np.arange(1, ctx // 16 + 1)
        pages = np.arange(ctx // 16 + 1, ctx // 16 + 1 + -(-take // 16))
        row = np.zeros(eng.max_blocks_per_seq, np.int32)
        row[:len(ctx_pages) + len(pages)] = np.concatenate([ctx_pages, pages])
        table[0] = row[:nbc]
        ctx_len[0], chunk_len[0] = ctx, take
        ids[0, :take] = rng.integers(0, cfg.vocab_size, take)
        blocks[:len(pages)] = pages
        temp[0], topk[0], topp[0] = 0.8, 40, 0.9
        seed_[0] = int(rng.integers(0, 2 ** 32))
        key = f"chunk {PREFILL_CHUNK} at context {ctx} (extent {nbc} blocks)"
        out[key] = _hold_program(
            torch, eng, f"{name} {key}", prog, host,
            lambda prog=prog: eng._chunk_body(prog), pages.tolist())
    st = eng.stats()
    launches = pak.paged_ragged_attention.launches
    eng.release_graphs()
    check(st["prefill_captures"] == len(PREFILL_GROUP_KEYS) and
          st["chunk_captures"] == len(PREFILL_CTX),
          f"{name}: captures {st['prefill_captures']} / "
          f"{st['chunk_captures']}")
    check(launches == 0, f"{name}: K1 launched {launches} times in prefill")
    pool = st["graph_pool_bytes"]
    print(f"{name} GPT-2-small L=12 D=768 (33280 positions), max_batch=8, "
          f"BS=16: {st['prefill_captures']} grouped and "
          f"{st['chunk_captures']} chunk programs captured in "
          f"{st['prefill_capture_s']:.4f} s, graph pool "
          f"{'n/a' if pool is None else f'{pool / 2**20:.1f} MiB'}; each "
          "replay's tokens and pool equal its eager body's bit for bit, the "
          "request's pages and the scratch block the only blocks written, "
          "K1 0 launches; a call (median host ms, profiled device ms), "
          "replay vs eager body: " + "; ".join(
              f"{k}: capture {r['capture_s']:.4f} s, host "
              f"{r['replay_host_ms']:.4f} vs {r['eager_host_ms']:.4f}, "
              f"device {r['replay_device_ms']:.4f} vs "
              f"{r['eager_device_ms']:.4f}" for k, r in out.items()),
          flush=True)
    del eng, params
    torch.cuda.empty_cache()
    return {"keys": out, "graph_pool_bytes": pool,
            "capture_s": st["prefill_capture_s"]}


def serve_poll_phase(torch, seed, plain):
    """``[serve poll]``: the 12 requests of ``[serve fp32]`` with an EOS
    id (the fifth token of request 0's stream there) through an
    ``LLMServer`` with the auto-tuned poll cadence (the default) and
    with a fixed interval of 8: the auto decision (interval, poll cost,
    ms a dispatch) on the card; both runs' tokens equal ``[serve
    fp32]``'s cut after their first EOS."""
    from paddle_tpu_torch.inference.serving import LLMServer, params_from_numpy
    from paddle_tpu_torch.models import gpt2_small, init_decode_weights_numpy
    cfg = gpt2_small()
    params = params_from_numpy(init_decode_weights_numpy(cfg, seed),
                               device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in REQ_LENS]
    eos = plain["tokens"][0][4]
    want = [t[:t.index(eos) + 1] if eos in t else t for t in plain["tokens"]]
    runs = {}
    for interval in (None, 8):
        server = LLMServer(params=params, gpt_config=cfg, max_batch=8,
                           block_size=16, num_blocks=512, eos_id=eos,
                           done_poll_interval=interval, auto_start=False,
                           device="cuda")
        try:
            server.warmup(REQ_LENS)
            server.start()
            t0 = time.monotonic()
            results = [f.result(timeout=600) for f in
                       [server.submit(p, max_tokens=m)
                        for p, m in zip(prompts, REQ_MAX)]]
            wall = time.monotonic() - t0
            st = server.stats()
        finally:
            server.close()
        got = [r.tokens for r in results]
        check(got == want, f"[serve poll] interval {interval}: tokens differ"
              " from [serve fp32]'s cut at the EOS")
        runs[interval] = {"tokens_per_s": sum(map(len, got)) / wall,
                          "decision": st.get("done_poll_decision"),
                          "interval": st["done_poll_interval"],
                          "dispatches": st["dispatches"]}
    d = runs[None]["decision"]
    check(d is not None and 1 <= d["done_poll_interval"] <= d["max"],
          f"[serve poll] the auto cadence did not decide: {d}")
    cut = sum(1 for t in plain["tokens"] if eos in t)
    print(f"[serve poll] GPT-2-small fp32, eos_id {eos} ({cut} of 12 streams"
          f" hold it): auto decision {d}; {runs[None]['tokens_per_s']:.2f} "
          f"tokens/s in {runs[None]['dispatches']} dispatches, at a fixed "
          f"interval 8 {runs[8]['tokens_per_s']:.2f} in "
          f"{runs[8]['dispatches']}; tokens equal [serve fp32]'s cut at the "
          "EOS in both", flush=True)
    del params
    torch.cuda.empty_cache()
    return runs


DISAGG_RETRY_S = 0.005           # DisaggRouter's retry loop for parked
                                 # tickets
DISAGG_PROFILE_MAX = 4           # the profiled window: the first
                                 # PROFILE_REQS prompts, 4 tokens each


def _bf16_departures(torch, name, params, scfg, prompts, results, want):
    """bf16 tokens against another engine's (``want``): equal, or
    departing where the two tokens' logits lie within ``BF16_GAP_ULPS``
    bf16 ulps; then every token against the argmax of its own prefix's
    teacher-forced logits.  Returns (departures, not argmax, worst gap
    in ulps)."""
    departures = []
    for i, (r, w) in enumerate(zip(results, want)):
        d = _departure(torch, params, scfg, prompts[i], r.tokens, w)
        if d is None:
            continue
        j, gap, ulp, top2 = d
        departures.append((i, j))
        print(f"{name} request {i} departs at token {j} ({r.tokens[j]} vs "
              f"{w[j]}): their logits differ by {gap:.6g} = "
              f"{gap / ulp:.3f} bf16 ulps; top-2 logits {top2}", flush=True)
        check(gap <= BF16_GAP_ULPS * ulp, f"{name} request {i}: the "
              f"departure's logit gap {gap:.6g} exceeds {BF16_GAP_ULPS} "
              f"bf16 ulps ({BF16_GAP_ULPS * ulp:.6g})")
    not_top, worst = 0, 0.0
    for i, r in enumerate(results):
        for j, (gap, ulp) in enumerate(teacher_forced_gaps(
                torch, params, scfg, prompts[i], r.tokens)):
            not_top += gap > 0
            worst = max(worst, gap / ulp)
            check(gap <= BF16_GAP_ULPS * ulp, f"{name} request {i} token "
                  f"{j} ({r.tokens[j]}): its logit lies {gap:.6g} = "
                  f"{gap / ulp:.3f} bf16 ulps below its prefix's largest")
    return departures, not_top, worst


def _disagg_router(torch, kw_pre, kw_dec, warm):
    """A ``DisaggRouter`` over one prefill-role and one decode-role
    ``LLMServer``, each warmed (``warm``: prompt lengths) before its pump
    starts; no control loop, the retry loop every ``DISAGG_RETRY_S``.
    Returns the router and the two servers."""
    from paddle_tpu_torch.inference.serving import DisaggRouter, LLMServer
    made = {}

    def factory(role, kw):
        def make():
            server = LLMServer(role=role, auto_start=False, **kw)
            server.warmup(warm)
            made[role] = server
            return server.start()
        return make

    router = DisaggRouter(factory("prefill", kw_pre),
                          factory("decode", kw_dec),
                          prefill_pool={"decision_interval_s": 0},
                          decode_pool={"decision_interval_s": 0},
                          retry_interval_s=DISAGG_RETRY_S)
    return router, made["prefill"], made["decode"]


def _role_gates(name, pre, dec, migrations):
    """The tier's invariants after a run: the prefill engine never
    decoded or captured, the decode engine captured at most its two
    variants, ``migrations`` tickets were imported, export and import
    accounting agree and both allocators are empty."""
    pst, dst = pre.engine.stats(), dec.engine.stats()
    check(pst["decode_captures"] == 0 and pst["dispatches"] == 0,
          f"{name} the prefill engine ran {pst['dispatches']} decode "
          f"dispatches, {pst['decode_captures']} captures")
    check(dst["decode_captures"] <= 2, f"{name} the decode engine captured "
          f"{dst['decode_captures']} times (imports must not capture again)")
    got = int(dec.engine._c_migrations.collect(materialize=False))
    check(got == migrations, f"{name} {got} migrations imported, want "
          f"{migrations}")
    a, b = pst["kv"], dst["kv"]
    check(a["exported_blocks"] == b["imported_blocks"],
          f"{name} exported {a['exported_blocks']} blocks, imported "
          f"{b['imported_blocks']}")
    for who, kv in (("prefill", a), ("decode", b)):
        check(kv["free"] == kv["capacity"] and kv["reserved"] == 0
              and kv["pinned"] == 0, f"{name} the {who} allocator is not "
              f"empty after the run: {kv}")
    return dst


def migration_device_ms(torch, router, prompts):
    """Profile ``router`` serving ``prompts`` (``DISAGG_PROFILE_MAX``
    tokens each): device ms a migration of the export's gather
    (``index_select`` kernels) and of the import's scatter
    (``index_copy`` kernels), None where the trace holds no such
    kernel."""
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with profile_window(torch) as prof:
        for f in [router.submit(p, max_tokens=DISAGG_PROFILE_MAX)
                  for p in prompts]:
            f.result(timeout=600)
        torch.cuda.synchronize()
    us = {"export": 0.0, "import": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = e.name.lower().replace("_", "")
        if "indexselect" in key:
            us["export"] += e.time_range.elapsed_us()
        elif "indexcopy" in key:
            us["import"] += e.time_range.elapsed_us()
    return {k: (v / 1e3 / len(prompts) if v else None)
            for k, v in us.items()}


def serve_disagg_phase(torch, seed, dtype, tag, plain):
    """``[serve disagg fp32]`` / ``[serve disagg bf16]``: the 12 requests
    of ``[serve fp32/bf16]`` through a ``DisaggRouter`` over a
    prefill-role and a decode-role ``LLMServer`` (GPT-2-small, both on
    the card, each engine on its own stream), every request handed off
    as a page migration.  ``plain`` is the role-"both" engine's result
    in the same dtype and run."""
    from paddle_tpu_torch.inference.serving import (ServingModelConfig,
                                                    params_from_numpy)
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    from paddle_tpu_torch.models import gpt2_small, init_decode_weights_numpy
    name = f"[serve disagg {tag}]"
    cfg = gpt2_small()
    scfg = ServingModelConfig.from_gpt_config(cfg)
    L = cfg.num_hidden_layers
    params = params_from_numpy(init_decode_weights_numpy(cfg, seed),
                               device="cuda", dtype=dtype)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in REQ_LENS]
    kw = dict(params=params, gpt_config=cfg, max_batch=8, block_size=16,
              num_blocks=512, eos_id=None, device="cuda")
    router, pre, dec = _disagg_router(torch, kw, kw, REQ_LENS)
    compiled = [pre.engine.compile_stats(), dec.engine.compile_stats()]
    try:
        d0 = dec.engine.stats()["dispatches"]
        pak.paged_ragged_attention.launches = 0
        pak._cuda_core_paged.launches = 0
        with traced() as spans, prefill_timer(torch) as ptime:
            t0 = time.monotonic()
            futs = [router.submit(p, max_tokens=m)
                    for p, m in zip(prompts, REQ_MAX)]
            results = [f.result(timeout=600) for f in futs]
            wall = time.monotonic() - t0
        launches = pak.paged_ragged_attention.launches
        core_launches = pak._cuda_core_paged.launches
        check(router.pending_handoffs == 0,
              f"{name} {router.pending_handoffs} tickets still parked")
        dst = _role_gates(name, pre, dec, len(prompts))
        de = dec.engine
        mig = {"p50_s": de._h_migration.quantile(0.5),
               "p99_s": de._h_migration.quantile(0.99),
               "blocks": int(de._c_migrated_blocks.collect())}
        dev_ms = migration_device_ms(torch, router,
                                     prompts[:PROFILE_REQS])
        # the same requests twice more, every kernel loaded by now
        again = []
        for _ in range(2):
            with traced() as sp:
                t0 = time.monotonic()
                res = [f.result(timeout=600) for f in
                       [router.submit(p, max_tokens=m)
                        for p, m in zip(prompts, REQ_MAX)]]
                w = time.monotonic() - t0
            check([r.tokens for r in res] == [r.tokens for r in results],
                  f"{name} a later run's tokens differ from the first's")
            again.append((w, [r.stats.ttft for r in res], sp))
        capture_gate(name, [pre.engine, dec.engine], compiled)
    finally:
        router.close()
    dispatches = dst["dispatches"] - d0
    for r, m in zip(results, REQ_MAX):
        check(len(r.tokens) == m, f"{name} {len(r.tokens)} tokens != {m}")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{name} token out of vocab")
    check(launches == dispatches * L, f"{name} K1 launches {launches} != "
          f"the decode engine's dispatches {dispatches} x {L} (per replay;"
          " the prefill engine launches none)")
    check(core_launches == 0, f"{name} the comparison entry "
          f"_cuda_core_paged launched {core_launches} times")
    if dtype == torch.float32:
        for i, (r, want) in enumerate(zip(results, plain["tokens"])):
            check(r.tokens == want, f"{name} request {i}: tokens differ from"
                  " the role-both fp32 engine's")
        for i in ORACLE_REQS:
            _oracle_check(torch, f"{name} request {i}", params, scfg,
                          prompts[i], results[i].tokens, REQ_MAX[i])
        tok_line = ("all 12 requests' tokens equal the role-both fp32 "
                    f"engine's; requests {ORACLE_REQS} equal "
                    "reference_decode")
    else:
        deps, not_top, worst = _bf16_departures(
            torch, name, params, scfg, prompts, results, plain["tokens"])
        tok_line = (f"{12 - len(deps)} of 12 requests' tokens equal the "
                    f"role-both bf16 engine's; departures (request, token) "
                    f"{deps}, each within {BF16_GAP_ULPS} bf16 ulps; "
                    f"teacher-forced, {not_top} tokens are not their "
                    f"prefix's argmax, the farthest {worst:.3f} ulps below")
    n_tok = sum(len(r.tokens) for r in results)

    def ms(v):
        return "not measured" if v is None else f"{v:.5f} ms"
    print(f"{name} GPT-2-small, DisaggRouter over a prefill-role and a "
          f"decode-role LLMServer on one card: {len(results)} requests, "
          f"{n_tok} tokens in {wall:.4f} s = {n_tok / wall:.2f} tokens/s "
          f"(role-both engine, this run: {plain['tokens_per_s']:.2f}); "
          f"ttft p50 {dst['ttft_p50_s']:.6f} p99 {dst['ttft_p99_s']:.6f} s; "
          f"inter-token p50 {dst['intertoken_p50_s']:.6f} p99 "
          f"{dst['intertoken_p99_s']:.6f} s (host gaps of the decode "
          f"engine); serving_migration_s p50 {mig['p50_s']:.6f} p99 "
          f"{mig['p99_s']:.6f} s (histogram estimates); "
          f"{len(results)} migrations, {mig['blocks']} blocks; decode "
          f"dispatches {dispatches}, K1 launches {launches} (per replay; "
          f"_cuda_core_paged {core_launches}), decode captures "
          f"{dst['decode_captures']}, the prefill engine 0 dispatches and "
          f"0 captures; device ms a migration (profiled, "
          f"{PROFILE_REQS} requests): export {ms(dev_ms['export'])}, "
          f"import {ms(dev_ms['import'])}; the prefill replica's "
          f"{prefill_line(spans, ptime)} (role both, this run: "
          f"{prefill_line(plain['spans'], plain['prefill'])}), "
          f"{compiled[0]['prefill_captures']} prefill programs captured "
          f"in its warm-up, none after; {spans_line(spans)} (role both,"
          f" this run: {spans_line(plain['spans'])})", flush=True)
    print(f"{name} {tok_line}", flush=True)
    print(f"{name} the same requests twice more: " + "; ".join(
        f"{n_tok / w:.2f} tokens/s, ttft p50 {np.percentile(tt, 50):.6f} "
        f"p99 {np.percentile(tt, 99):.6f} s, {spans_line(sp)}"
        for w, tt, sp in again), flush=True)
    del router, pre, dec, params
    torch.cuda.empty_cache()
    return {"launches": launches, "dispatches": dispatches,
            "tokens_per_s": n_tok / wall, "wall_s": wall,
            "ttft_p50_s": dst["ttft_p50_s"], "ttft_p99_s": dst["ttft_p99_s"],
            "intertoken_p50_s": dst["intertoken_p50_s"],
            "intertoken_p99_s": dst["intertoken_p99_s"],
            "migration": mig, "migration_device_ms": dev_ms,
            "spans": spans, "prefill": ptime,
            "again_tokens_per_s": [n_tok / w for w, _, _ in again]}


def disagg_gap_phase(torch, seed, role_both):
    """``[serve disagg gap]``: ``[serve chunk gap]``'s scenario (bf16,
    full width, 33280 positions, pages of 16, a 48-token stream read
    token by token while a 4032-token prompt is admitted, in chunks of
    512 and whole) through a ``DisaggRouter``: the stream is admitted
    first and hands off to the decode-role replica, then the long prompt
    goes to the same prefill-role replica.  Each configuration runs
    twice; the second run is read.  ``role_both`` is ``[serve chunk
    gap]``'s result from the same run."""
    import threading
    cfg = _long_cfg()
    params = _long_params(torch, seed, torch.bfloat16)
    rng = np.random.default_rng(seed + 10)
    stream_prompt = rng.integers(0, cfg.vocab_size, 8).tolist()
    long_prompt = rng.integers(0, cfg.vocab_size, 4032).tolist()
    kw = dict(params=params, gpt_config=cfg, max_batch=2, block_size=16,
              num_blocks=300, device="cuda")
    res = {}
    for chunk in (512, None):
        name = f"[serve disagg gap] chunk {chunk}"
        router, pre, dec = _disagg_router(
            torch, dict(kw, prefill_chunk=chunk), kw, [8, 4032])
        compiled = [pre.engine.compile_stats(), dec.engine.compile_stats()]
        try:
            for _ in range(2):
                seen, started = [], threading.Event()

                def cb(rid, i, tok, seen=seen, started=started):
                    seen.append((int(tok), time.perf_counter()))
                    if len(seen) >= 4:
                        started.set()

                with traced() as spans, prefill_timer(torch) as ptime:
                    fs = router.submit(stream_prompt, max_tokens=48,
                                       stream_cb=cb)
                    check(started.wait(600),
                          f"{name}: the stream did not start")
                    fl = router.submit(long_prompt, max_tokens=2)
                    fs.result(timeout=600)
                    fl.result(timeout=600)
                gaps = np.diff([t for _, t in seen])
            check(len(seen) == 48, f"{name}: {len(seen)} tokens streamed")
            _role_gates(name, pre, dec, 4)
            capture_gate(name, [pre.engine, dec.engine], compiled)
        finally:
            router.close()
        res["whole" if chunk is None else f"chunk {chunk}"] = {
            "p50_s": float(np.percentile(gaps, 50)),
            "p99_s": float(np.percentile(gaps, 99)),
            "max_s": float(gaps.max()),
            "prefill": prefill_line(spans, ptime)}
        del router, pre, dec
        torch.cuda.empty_cache()
    print("[serve disagg gap] a 48-token stream on the decode-role replica "
          "while the prefill-role replica admits a 4032-token prompt (bf16, "
          "full width, one card): inter-token s " + "; ".join(
              f"{k}: p50 {r['p50_s']:.5f} p99 {r['p99_s']:.5f} max "
              f"{r['max_s']:.5f} (role both, this run: p50 "
              f"{role_both[k]['p50_s']:.5f} p99 {role_both[k]['p99_s']:.5f}"
              f" max {role_both[k]['max_s']:.5f}), the read run's prefill "
              f"replica's {r['prefill']}" for k, r in res.items())
          + "; no capture after warm-up", flush=True)
    return res


def serve_router_phase(torch, seed, plain):
    """``[serve router]``: a ``ServingRouter`` over two role-"both"
    ``LLMServer`` replicas sharing one set of GPT-2-small fp32 weights
    (``min_replicas=2``, no control loop, ``metrics_port=0``), the 12
    requests of ``[serve fp32]``: tokens equal the plain engine's, each
    replica serves some; then, with the pumps idle, ``control_round``
    under ``torch.cuda.set_sync_debug_mode("error")`` (the control loop
    never syncs), ``/metrics`` and ``/events`` over 127.0.0.1 and
    ``scrape(materialize=True)`` against each engine's own count."""
    import urllib.request
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.inference.serving import (LLMServer, ServingRouter,
                                                    params_from_numpy)
    from paddle_tpu_torch.models import gpt2_small, init_decode_weights_numpy
    cfg = gpt2_small()
    params = params_from_numpy(init_decode_weights_numpy(cfg, seed),
                               device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in REQ_LENS]
    made = []

    def factory():
        server = LLMServer(params=params, gpt_config=cfg, max_batch=8,
                           block_size=16, num_blocks=512, eos_id=None,
                           auto_start=False, device="cuda")
        server.warmup(REQ_LENS)
        made.append(server)
        return server.start()

    router = ServingRouter(factory, min_replicas=2, max_replicas=2,
                           decision_interval_s=0, metrics_port=0)
    try:
        t0 = time.monotonic()
        futs = [router.submit(p, max_tokens=m)
                for p, m in zip(prompts, REQ_MAX)]
        results = [f.result(timeout=600) for f in futs]
        wall = time.monotonic() - t0
        deadline = time.monotonic() + 60
        while any(s.engine.active_count or s.engine.scheduler.queue_depth
                  for s in made) and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t = time.perf_counter()
            sig = router.control_round()
            round_us = (time.perf_counter() - t) * 1e6
        finally:
            torch.cuda.set_sync_debug_mode(0)
        base = f"http://127.0.0.1:{router.metrics_port}"
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=30).read().decode()
        events = json.load(urllib.request.urlopen(base + "/events",
                                                  timeout=30))
        snap = observability.scrape(materialize=True)
        per = []
        for s in made:
            key = (f'serving_tokens_total{{engine="{s.engine._obs_id}",'
                   'phase="both"}')
            check(key + " " in text, f"[serve router] /metrics lacks {key}")
            st = s.stats()
            check(snap[key]["value"] == st["total_tokens"],
                  f"[serve router] scrape {snap[key]['value']} != "
                  f"stats {st['total_tokens']} for {key}")
            per.append((st["completed"], st["total_tokens"]))
        check(isinstance(events.get("events"), list),
              f"[serve router] /events gave {events!r}")
    finally:
        router.close()
    for i, (r, want) in enumerate(zip(results, plain["tokens"])):
        check(r.tokens == want, f"[serve router] request {i}: tokens differ "
              "from the plain fp32 engine's")
    check(all(n >= 1 for n, _ in per), f"[serve router] a replica served no "
          f"request: {per}")
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[serve router] ServingRouter over two role-both LLMServers "
          f"(GPT-2-small fp32, shared weights): {len(results)} requests, "
          f"{n_tok} tokens in {wall:.4f} s = {n_tok / wall:.2f} tokens/s "
          f"(one plain engine, this run: {plain['tokens_per_s']:.2f}); "
          f"(requests, tokens) per replica {per}; tokens equal the plain "
          f"engine's; control_round {round_us:.1f} host us under "
          f"set_sync_debug_mode('error') (decision {sig['decision']}); "
          f"/metrics names both replicas, /events a list of "
          f"{len(events['events'])}, scrape(materialize=True) equals each "
          f"engine's token count", flush=True)
    del router, made, params
    torch.cuda.empty_cache()
    return {"round_us": round_us, "tokens_per_s": n_tok / wall}


# ---------------------------------------------------------------------------
# flash attention: the three kernels against their plain versions
# ---------------------------------------------------------------------------
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
BH_KERNELS = ("flash_fwd_hpack", "flash_bwd_fused")    # [flash bh] phase
FLASH_REPLACES = {
    "flash_fwd": "paddle_tpu/ops/pallas_ops.py:795",
    "flash_bwd_dq": "paddle_tpu/ops/pallas_ops.py:883",
    "flash_bwd_dkv": "paddle_tpu/ops/pallas_ops.py:959",
    "flash_fwd_hpack": "paddle_tpu/ops/pallas_ops.py:192",
    "flash_bwd_fused": "paddle_tpu/ops/pallas_ops.py:397",
}


def _err(got, ref):
    """(max abs error, error / max(|ref|, 1))."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1.0)


def flash_run(fk, q, k, v, g, causal, qseg=None, kseg=None):
    """The three kernels in the order the backward runs them."""
    out, lse = fk.flash_fwd(q, k, v, causal, qseg, kseg)
    dq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, causal, qseg, kseg)
    dk, dv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal, qseg, kseg)
    return {"out": out, "lse": lse, "delta": delta, "dq": dq, "dk": dk,
            "dv": dv}


def flash_plain(torch, fk, q, k, v, g, causal, qseg=None, kseg=None):
    """The plain forward in fp32 on the same values, and dq/dk/dv of it
    through autograd."""
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    out, lse = fk.flash_attention_reference(*leaves, causal, qseg, kseg)
    dq, dk, dv = torch.autograd.grad(out, leaves, g.float())
    delta = (g.float() * out.detach()).sum(-1).permute(0, 2, 1)
    return {"out": out.detach(), "lse": lse.detach(), "delta": delta,
            "dq": dq, "dk": dk, "dv": dv}


def flash_compare(torch, fk, tag, tol, q, k, v, g, causal, qseg=None,
                  kseg=None):
    got = flash_run(fk, q, k, v, g, causal, qseg, kseg)
    ref = flash_plain(torch, fk, q, k, v, g, causal, qseg, kseg)
    torch.cuda.synchronize()
    errs = {}
    for name in ("out", "lse", "delta", "dq", "dk", "dv"):
        check(bool(torch.isfinite(got[name].float()).all()),
              f"[flash] {tag}: {name} not finite")
        err, rel = _err(got[name], ref[name])
        check(rel <= tol, f"[flash] {tag}: {name} error {err:.3e} "
                          f"(relative {rel:.3e}) > {tol}")
        errs[name] = err
    print(f"[flash] {tag}: max_abs_err " + " ".join(
        f"{n}={e:.3e}" for n, e in errs.items()) + f" (tol {tol} x "
          "max(|ref|, 1))", flush=True)
    return got, errs


def flash_phase(torch, seed):
    from paddle_tpu_torch.nn.functional import flash_attention
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    B, S, H, D = TRAIN_B, TRAIN_S, 12, 64
    res = {}
    for dtype, tol in ((torch.bfloat16, FLASH_BF16_TOL),
                       (torch.float32, FLASH_FP32_TOL)):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        qkv = rnd(B, S, 3, H, D, dtype=dtype)          # GPT's layout
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        g = rnd(B, S, H, D, dtype=dtype)
        _, errs = flash_compare(torch, fk, f"{name} [B,S,H,D] views "
                                f"B={B} S={S} H={H} D={D} causal", tol,
                                q, k, v, g, True)
        res[name] = errs

        def bh(t):
            return t.permute(0, 2, 1, 3).reshape(B * H, S, 1, D)
        flash_compare(torch, fk, f"{name} [B*H,S,D] layout", tol,
                      bh(q), bh(k), bh(v), bh(g), True)
        if dtype == torch.bfloat16:
            main = (q, k, v, g)

    tol = FLASH_FP32_TOL
    flash_compare(torch, fk, "S=1000 causal (ragged)", tol,
                  *[rnd(2, 1000, 4, 64) for _ in range(4)], True)
    q, g = rnd(2, 384, 4, 64), rnd(2, 384, 4, 64)
    flash_compare(torch, fk, "non-causal Sq=384 Sk=640", tol, q,
                  rnd(2, 640, 4, 64), rnd(2, 640, 4, 64), g, False)
    flash_compare(torch, fk, "D=128 causal S=512", tol,
                  *[rnd(2, 512, 4, 128) for _ in range(4)], True)
    qseg = torch.zeros((2, 300), dtype=torch.int32, device=dev)
    qseg[:, 150:] = 1
    qseg[:, 7] = 9                                   # sees no key
    kseg = torch.zeros((2, 300), dtype=torch.int32, device=dev)
    kseg[:, 150:] = 1
    got, _ = flash_compare(torch, fk, "segment ids + fully-masked row",
                           tol, *[rnd(2, 300, 4, 64) for _ in range(4)],
                           False, qseg, kseg)
    check(bool((got["out"][:, 7] == 0).all()), "[flash] masked row not 0")
    check(bool((got["lse"][:, :, 7] == fk.LSE_FLOOR).all()),
          "[flash] masked row lse not the floor")
    # GQA through the public function, gradients through autograd
    q = rnd(2, 256, 8, 64).requires_grad_()
    kv = [rnd(2, 256, 2, 64).requires_grad_() for _ in range(2)]
    g = rnd(2, 256, 8, 64)
    out, _ = flash_attention(q, *kv, causal=True)
    grads = torch.autograd.grad(out, [q, *kv], g)
    ref, _ = fk.flash_attention_reference(
        q, *[torch.repeat_interleave(t, 4, dim=2) for t in kv], True)
    rgrads = torch.autograd.grad(ref, [q, *kv], g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out, *grads),
                          (ref, *rgrads)):
        err, rel = _err(a, b)
        check(rel <= tol, f"[flash] GQA {name} error {err:.3e}")
    print(f"[flash] GQA Hq=8 Hkv=2 through flash_attention: out and "
          f"grads within {tol}", flush=True)

    # times at the main shape, bf16, the GPT layout
    q, k, v, g = main
    fwd = fk.flash_fwd(q, k, v, True)
    dq_res = fk.flash_bwd_dq(q, k, v, fwd[0], fwd[1], g, True)
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    calls = {
        "flash_fwd": (lambda: fk.flash_fwd(q, k, v, True),
                      lambda: fk.flash_attention_reference(q, k, v, True)),
        "flash_bwd_dq": (
            lambda: fk.flash_bwd_dq(q, k, v, fwd[0], fwd[1], g, True),
            lambda: fk.flash_bwd_dq_reference(q, k, v, fwd[0], fwd[1], g,
                                              True)),
        "flash_bwd_dkv": (
            lambda: fk.flash_bwd_dkv(q, k, v, g, fwd[1], dq_res[1], True),
            lambda: fk.flash_bwd_dkv_reference(q, k, v, g, fwd[1],
                                               dq_res[1], True)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, gt = [t.transpose(1, 2) for t in (q, k, v, g)]
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]

    def sdpa_fwd_bwd():
        o = sdpa(*leaves, is_causal=True)
        torch.autograd.grad(o, leaves, gt)

    with torch.no_grad():
        sdpa_ms = time_cuda(torch, lambda: sdpa(qt, kt, vt, is_causal=True),
                            20, flush=flush)
    sdpa_fb_ms = time_cuda(torch, sdpa_fwd_bwd, 20, flush=flush)
    for name, (kern, plain) in calls.items():
        with torch.no_grad():
            ms = time_cuda(torch, kern, 20, flush=flush)
            plain_ms = time_cuda(torch, plain, 5, warmup=2, flush=flush)
        flops, nbytes = fk.kernel_work(name, B, H, S, S, D, True, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        err_key = {"flash_fwd": "out", "flash_bwd_dq": "dq",
                   "flash_bwd_dkv": "dk"}[name]
        max_err = (max(res["bf16"]["dk"], res["bf16"]["dv"])
                   if name == "flash_bwd_dkv" else res["bf16"][err_key])
        res[name] = {
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sdpa_ms if name == "flash_fwd" else None,
            "max_abs_err": max_err, "flops": flops, "bytes": nbytes,
            "tflops": flops / (ms * 1e-3) / 1e12,
        }
        r = res[name]
        print(f"[flash] {name} bf16 B={B} S={S} H={H} D={D} causal: "
              f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} bound_ms="
              f"{r['bound_ms']:.5f} ({r['bound_by']}: {flops} flop, "
              f"{nbytes} bytes) achieved {r['tflops']:.2f} TFLOP/s",
              flush=True)
    res["sdpa_fwd_ms"], res["sdpa_fwd_bwd_ms"] = sdpa_ms, sdpa_fb_ms
    print(f"[flash] library yardstick (not used by the port): sdpa "
          f"forward {sdpa_ms:.5f} ms, forward+backward {sdpa_fb_ms:.5f} "
          f"ms; flash kernels forward+dq+dkv "
          f"{sum(res[n]['ms'] for n in FLASH_KERNELS):.5f} ms", flush=True)
    return res


# ---------------------------------------------------------------------------
# the tensor-core forward (csrc/flash_fwd_sm90.cu): bf16 flash_fwd and
# flash_fwd_hpack
# ---------------------------------------------------------------------------
TC_SOURCE = "paddle_tpu_torch/csrc/flash_fwd_sm90.cu"
CORE_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
TC_TOL = 1e-2                    # x max(|ref|, 1); the kernel against its
                                 # plain version, both rounding p to 16 bits


def sass_summary(lib_path, nvcc_log):
    """``HGMMA`` instructions in the library's SASS (``cuobjdump``) and
    ptxas's registers and spill bytes per kernel from the build log."""
    from paddle_tpu_torch import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    regs, spills = [], []
    for line in nvcc_log.splitlines():
        if "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split("registers")[0]))
        if "spill stores" in line:
            spills.append(int(line.split("bytes spill stores")[0]
                              .split(",")[-1]))
    return hgmma, regs, spills


def tc_compare(torch, fk, tag, q, k, v, causal, hp=1, qseg=None,
               kseg=None):
    """A tensor-core forward (``flash_fwd``, or ``flash_fwd_hpack`` when
    ``hp > 1``, which must also equal ``flash_fwd`` bit for bit) against
    ``flash_fwd_tc_reference`` on the same bf16 values."""
    before = fk.flash_fwd.tc_launches + fk.flash_fwd_hpack.tc_launches
    if hp > 1:
        out, lse = fk.flash_fwd_hpack(q, k, v, hp, causal)
        fout, flse = fk.flash_fwd(q, k, v, causal)
    else:
        out, lse = fk.flash_fwd(q, k, v, causal, qseg, kseg)
    ref, ref_lse = fk.flash_fwd_tc_reference(q, k, v, causal, qseg, kseg)
    torch.cuda.synchronize()
    check(fk.flash_fwd.tc_launches + fk.flash_fwd_hpack.tc_launches
          == before + (2 if hp > 1 else 1),
          f"[flash tc] {tag}: the tensor-core kernels did not launch")
    check(out.dtype == torch.bfloat16 and lse.dtype == torch.float32,
          f"[flash tc] {tag}: dtypes {out.dtype}, {lse.dtype}")
    errs = {}
    for name, got, want in (("out", out, ref), ("lse", lse, ref_lse)):
        check(bool(torch.isfinite(got.float()).all()),
              f"[flash tc] {tag}: {name} not finite")
        err, rel = _err(got, want)
        check(rel <= TC_TOL, f"[flash tc] {tag}: {name} error {err:.3e} "
                             f"(relative {rel:.3e}) > {TC_TOL}")
        errs[name] = err
    line = (f"[flash tc] {tag}: vs flash_fwd_tc_reference max_abs_err "
            f"out={errs['out']:.3e} lse={errs['lse']:.3e} (tol {TC_TOL} x "
            "max(|ref|, 1))")
    if hp > 1:
        same = torch.equal(out, fout) and torch.equal(lse, flse)
        check(same, f"[flash tc] {tag}: flash_fwd_hpack hp={hp} differs "
                    "from flash_fwd")
        line += f"; hp={hp} bitwise equal to flash_fwd: {same}"
    print(line, flush=True)
    return out, lse, errs


def flash_tc_phase(torch, seed, nvcc_log):
    """``[flash tc]``: the tensor-core forward against its plain version
    at the main path's shapes and awkward ones, the head-packed entry
    bitwise against ``flash_fwd``, the SASS's ``HGMMA`` count, and times
    beside the CUDA-core forward it replaced for bf16 and SDPA."""
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 20)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    hgmma, regs, spills = sass_summary(_build.library_path("flash_fwd_sm90"),
                                       nvcc_log)
    print(f"[flash tc] {TC_SOURCE}: {hgmma} HGMMA instructions in the SASS;"
          f" ptxas registers per kernel {regs}, spill store bytes {spills}",
          flush=True)
    check(hgmma > 0, "[flash tc] no HGMMA instruction in the SASS")
    res = {"hgmma": hgmma, "registers": regs, "spill_bytes": spills}

    qkv = rnd(TRAIN_B, TRAIN_S, 3, 12, 64)              # GPT's layout
    gpt = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    bh = {"gpt": ([rnd(TRAIN_B * 12, TRAIN_S, 1, 64) for _ in range(3)],
                  True),
          "ernie": ([rnd(ERNIE_B * 12, ERNIE_S, 1, 64) for _ in range(3)],
                    False)}
    errs = {}
    _, _, errs["views"] = tc_compare(
        torch, fk, f"GPT [B,S,H,D] views B={TRAIN_B} S={TRAIN_S} H=12 D=64 "
        "causal", *gpt, True)
    for model, (args, causal) in bh.items():
        _, _, errs[model] = tc_compare(
            torch, fk, f"{model} {list(args[0].shape)} "
            f"{'causal' if causal else 'non-causal'}", *args, causal, hp=2)
    tc_compare(torch, fk, "S=1000 causal (ragged) [2, 1000, 4, 64]",
               *[rnd(2, 1000, 4, 64) for _ in range(3)], True)
    tc_compare(torch, fk, "S=1000 causal hp=2 [8, 1000, 1, 64]",
               *[rnd(8, 1000, 1, 64) for _ in range(3)], True, hp=2)
    tc_compare(torch, fk, "non-causal Sq=384 Sk=640", rnd(2, 384, 4, 64),
               rnd(2, 640, 4, 64), rnd(2, 640, 4, 64), False)
    tc_compare(torch, fk, "D=128 causal S=512",
               *[rnd(2, 512, 4, 128) for _ in range(3)], True)
    tc_compare(torch, fk, "D=128 non-causal Sq=200 Sk=333",
               rnd(2, 200, 3, 128), rnd(2, 333, 3, 128), rnd(2, 333, 3, 128),
               False)
    tc_compare(torch, fk, "odd H [2, 300, 3, 64] hp=2, packs straddle "
               "batches", *[rnd(2, 300, 3, 64) for _ in range(3)], False,
               hp=2)
    tc_compare(torch, fk, "hp=4 [8, 256, 1, 64] causal",
               *[rnd(8, 256, 1, 64) for _ in range(3)], True, hp=4)
    qseg = torch.zeros((2, 300), dtype=torch.int32, device=dev)
    qseg[:, 150:] = 1
    qseg[:, 7] = 9                                   # sees no key
    kseg = torch.zeros((2, 300), dtype=torch.int32, device=dev)
    kseg[:, 150:] = 1
    out, lse, _ = tc_compare(torch, fk, "segment ids + fully-masked row",
                             *[rnd(2, 300, 4, 64) for _ in range(3)], False,
                             qseg=qseg, kseg=kseg)
    check(bool((out[:, 7] == 0).all())
          and bool((lse[:, :, 7] == fk.LSE_FLOOR).all()),
          "[flash tc] masked row: out not 0 or lse not the floor")
    print("[flash tc] fully-masked row: out exactly 0, lse exactly "
          f"{fk.LSE_FLOOR}", flush=True)

    # times: the tensor-core kernel, the CUDA-core kernel it replaced for
    # bf16, the plain version and SDPA (a yardstick, not used by the port)
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cells = {"flash_fwd": (gpt, True, 1, "views", TRAIN_B, 12, TRAIN_S),
             "flash_fwd_hpack": (bh["gpt"][0], True, 2, "gpt",
                                 TRAIN_B * 12, 1, TRAIN_S),
             "flash_fwd_hpack ernie": (bh["ernie"][0], False, 2, "ernie",
                                       ERNIE_B * 12, 1, ERNIE_S)}
    for cell, (args, causal, hp, model, B, H, S) in cells.items():
        q, k, v = args
        qt, kt, vt = [t.transpose(1, 2) for t in args]
        if hp > 1:
            def kern():
                return fk.flash_fwd_hpack(q, k, v, hp, causal)
        else:
            def kern():
                return fk.flash_fwd(q, k, v, causal)
        with torch.no_grad():
            ms = time_cuda(torch, kern, 20, flush=flush)
            core_ms = time_cuda(
                torch, lambda: fk._cuda_core_fwd(q, k, v, causal, hp=hp), 20,
                flush=flush)
            plain_ms = time_cuda(
                torch, lambda: fk.flash_fwd_tc_reference(q, k, v, causal), 5,
                warmup=2, flush=flush)
            lib_ms = time_cuda(torch, lambda: sdpa(qt, kt, vt,
                                                   is_causal=causal), 20,
                               flush=flush)
        name = cell.split()[0]
        flops, nbytes = fk.kernel_work(name, B, H, S, S, 64, causal, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        r = {"ms": ms, "cuda_core_ms": core_ms, "plain_ms": plain_ms,
             "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "flops": flops, "bytes": nbytes,
             "tflops": flops / (ms * 1e-3) / 1e12,
             "cuda_core_tflops": flops / (core_ms * 1e-3) / 1e12,
             "max_abs_err": max(errs[model].values())}
        res[cell] = r
        print(f"[flash tc] {cell} bf16 {list(q.shape)} "
              f"{'causal' if causal else 'non-causal'}"
              f"{f' hp={hp}' if hp > 1 else ''}: kernel_ms={ms:.5f} "
              f"({r['tflops']:.1f} TFLOP/s) cuda_core_ms={core_ms:.5f} "
              f"({r['cuda_core_tflops']:.1f} TFLOP/s, "
              f"{core_ms / ms:.2f}x the tensor-core time) plain_ms="
              f"{plain_ms:.5f} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}"
              f": {flops} flop, {nbytes} bytes) library_ms (sdpa forward, "
              f"not used by the port)={lib_ms:.5f}", flush=True)
    return res


# ---------------------------------------------------------------------------
# the tensor-core split backward (csrc/flash_bwd_sm90.cu): 16-bit
# flash_bwd_dq and flash_bwd_dkv
# ---------------------------------------------------------------------------
TC_BWD_SOURCE = "paddle_tpu_torch/csrc/flash_bwd_sm90.cu"
# The 16-bit gradients are held element by element, in two parts.
# (1) |got - ref| <= rtol |ref| + (u |X| + e_X + eta) @ |B|, where X is
# the rounded factor of the product (dS for dq and dk, p for dv) and B
# the other (K, Q, dO): the kernel and the plain version round the same
# fp32 values to the output dtype (rtol: one ulp and margin, the LMCE
# gate's LMCE_GRAD_RTOL), after rounding dS and p from fp32 values that differ slightly,
# so a term may move by an ulp of X; u |X| bounds rounding every term
# once (u half an ulp, eta half the subnormal spacing), and e_X the fp32
# difference itself: S, dP and delta are sums of D products taken in
# other orders (each within g = D eps32 of the sum of their |terms| for
# the two sides together), and ex2 and exp differ by a few eps32, so
#   e_p  = p (scale g |Q||K|^T + 4 eps32)
#   e_dS = p scale (g (|dO||V|^T + sum|dO O|) + |dP - delta| (scale g
#          |Q||K|^T + 4 eps32)),
# which matters where dP - delta cancels (a row whose only key is
# itself: dS = 0 up to those sums).
# (2) That bound cannot tell a kernel that rounds dS from one that does
# not: leaving the rounding out moves each sum by less than it.  What
# tells them apart is how many elements come out the same: rounding the
# same values, the two sides part only where a sum or a term straddles a
# rounding boundary, so most elements are equal in the 16-bit dtype,
# while a missing rounding moves a sum by a fraction of an ulp of its
# own, and about half the elements change.  So at least
# TC_BWD_SAME_MIN of the elements must be equal.  delta (fp32 sums of D
# products in another order) is held within 2 D eps32 sum|dO O|.
TC_BWD_SAME_MIN = {"bfloat16": 0.95, "float16": 0.9}


def flash_bwd_terms(torch, fk, q, k, v, g, out, lse, delta, causal,
                    qseg=None, kseg=None):
    """The gate's spread ``(u |X| + e_X + eta) @ |B|`` of dq, dk and dv
    (the comment above), from the plain versions' p and dS."""
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    p, ds = fk._dsoftmax(q, k, v, g, lse, delta, causal, qseg, kseg, scale)
    fi, eps32 = torch.finfo(q.dtype), torch.finfo(torch.float32).eps
    u, eta, gam = fi.eps / 2, fi.tiny * fi.eps / 2, q.shape[-1] * eps32
    qk = torch.einsum("bqhd,bkhd->bhqk", q.float().abs(), k.float().abs())
    e_p = p * (qk.mul_(scale * gam).add_(4 * eps32))
    del qk
    dpv = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    dpd = (dpv - delta[..., None]).abs_()
    gv = torch.einsum("bqhd,bkhd->bhqk", g.float().abs(), v.float().abs())
    go = (g.float() * out.float()).abs().sum(-1).permute(0, 2, 1)
    gv.add_(go[..., None])
    e_ds = (gv.mul_(gam).mul_(p).add_(dpd.mul_(e_p))).mul_(scale)
    del dpv, dpd, gv
    x_ds = ds.abs_().mul_(u).add_(e_ds).add_(eta)
    x_p = e_p.add_(p.abs().mul_(u)).add_(eta)
    del ds, p, e_ds
    return {
        "dq": torch.einsum("bhqk,bkhd->bqhd", x_ds, k.float().abs()),
        "dk": torch.einsum("bhqk,bqhd->bkhd", x_ds, q.float().abs()),
        "dv": torch.einsum("bhqk,bqhd->bkhd", x_p, g.float().abs()),
    }


def flash_bwd_gate(torch, got, ref, spread):
    """``(max abs error, ratio, share equal)`` of a 16-bit gradient:
    ``ratio`` the largest ``|got - ref| / (rtol |ref| + spread)`` (part 1
    passes at <= 1) and the share of elements equal in the dtype (part 2
    passes at >= TC_BWD_SAME_MIN)."""
    rtol = LMCE_GRAD_RTOL[str(ref.dtype).rsplit(".", 1)[-1]]
    same = (got == ref).float().mean().item()
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    ratio = torch.where(diff == 0, torch.zeros_like(diff),
                        diff / (rtol * ref.abs() + spread)).max().item()
    return diff.max().item(), ratio, same


def flash_bwd_passes(dtype, ratio, same):
    return ratio <= 1.0 and same >= TC_BWD_SAME_MIN[
        str(dtype).rsplit(".", 1)[-1]]


def tc_bwd_compare(torch, fk, tag, q, k, v, g, causal, qseg=None, kseg=None,
                   controls=False):
    """The tensor-core ``flash_bwd_dq`` + ``flash_bwd_dkv`` against their
    plain versions on the same 16-bit values (the tensor-core forward's
    out and lse), through :func:`flash_bwd_gate`; delta within 2 D eps32
    sum|dO O|; a second run bitwise equal.  ``controls``: a backward
    with delta = 0 and one with dS and p left unrounded must fail the
    gate (their old-gate errors are printed beside).  Returns the max abs
    errors, ratios and shares."""
    before = (fk.flash_bwd_dq.tc_launches, fk.flash_bwd_dkv.tc_launches)
    out, lse = fk.flash_fwd(q, k, v, causal, qseg, kseg)
    dq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, causal, qseg, kseg)
    dk, dv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal, qseg, kseg)
    again = (*fk.flash_bwd_dq(q, k, v, out, lse, g, causal, qseg, kseg),
             *fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal, qseg, kseg))
    torch.cuda.synchronize()
    check((fk.flash_bwd_dq.tc_launches, fk.flash_bwd_dkv.tc_launches)
          == (before[0] + 2, before[1] + 2),
          f"[flash tc bwd] {tag}: the tensor-core kernels did not launch")
    got = {"dq": dq, "dk": dk, "dv": dv}
    rdq, rdelta = fk.flash_bwd_dq_reference(q, k, v, out, lse, g, causal,
                                            qseg, kseg)
    rdk, rdv = fk.flash_bwd_dkv_reference(q, k, v, g, lse, delta, causal,
                                          qseg, kseg)
    ref = {"dq": rdq, "dk": rdk, "dv": rdv}
    spread = flash_bwd_terms(torch, fk, q, k, v, g, out, lse, delta,
                             causal, qseg, kseg)
    errs, ratios, shares = {}, {}, {}
    for name in ("dq", "dk", "dv"):
        check(got[name].dtype == q.dtype
              and bool(torch.isfinite(got[name].float()).all()),
              f"[flash tc bwd] {tag}: {name} dtype {got[name].dtype} or not "
              "finite")
        errs[name], ratios[name], shares[name] = flash_bwd_gate(
            torch, got[name], ref[name], spread[name])
    d_bound = (2 * q.shape[-1] * torch.finfo(torch.float32).eps
               * (g.float() * out.float()).abs().sum(-1).permute(0, 2, 1))
    d_err = (delta - rdelta).abs()
    errs["delta"] = d_err.max().item()
    d_ratio = (d_err / d_bound.clamp_min(1e-30)).max().item()
    same = all(torch.equal(a, b) for a, b in zip((dq, delta, dk, dv), again))
    line = (f"[flash tc bwd] {tag}: max_abs_err " + " ".join(
        f"{n}={e:.3e}" for n, e in errs.items()) + "; gate ratio " + " ".join(
        f"{n}={r:.3e}" for n, r in ratios.items()) + " (<= 1); equal " +
        " ".join(f"{n}={s:.5f}" for n, s in shares.items()) +
        f" (>= {TC_BWD_SAME_MIN[str(q.dtype).rsplit('.', 1)[-1]]}); delta "
        f"ratio {d_ratio:.3e} (<= 1); two runs bitwise equal: {same}")
    res = {"errs": errs, "ratios": ratios, "shares": shares}
    if controls:
        res["controls"] = bwd_controls(torch, fk, q, k, v, g, lse, delta,
                                       causal, qseg, kseg, ref, spread)
        line += controls_line(res["controls"])
    print(line, flush=True)
    for cname, (ratio, share, _) in res.get("controls", {}).items():
        check(not flash_bwd_passes(q.dtype, ratio, share),
              f"[flash tc bwd] {tag}: the gate passes the {cname} control "
              f"(ratio {ratio:.3e}, equal {share:.5f})")
    for name in ("dq", "dk", "dv"):
        check(flash_bwd_passes(q.dtype, ratios[name], shares[name]),
              f"[flash tc bwd] {tag}: {name} fails the gate (ratio "
              f"{ratios[name]:.3e}, equal {shares[name]:.5f})")
    check(d_ratio <= 1.0, f"[flash tc bwd] {tag}: delta error "
          f"{errs['delta']:.3e}, ratio {d_ratio:.3e}")
    check(same, f"[flash tc bwd] {tag}: two runs differ")
    return res, dq


def bwd_controls(torch, fk, q, k, v, g, lse, delta, causal, qseg, kseg, ref,
                 spread):
    """The gate on two broken backwards: delta = 0, and dS and p left
    unrounded (fp32 into the products).  Returns ``{"<control> <grad>":
    (ratio, share equal, old-gate relative error)}``."""
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    _, ds0 = fk._dsoftmax(q, k, v, g, lse, torch.zeros_like(delta),
                          causal, qseg, kseg, scale)
    p32 = fk._probs(q, k, lse, causal, qseg, kseg, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    ds32 = p32 * (dp - delta[..., None]) * scale
    del dp
    bad = {
        "delta=0": {
            "dq": torch.einsum("bhqk,bkhd->bqhd", ds0, k.float()),
            "dk": torch.einsum("bhqk,bqhd->bkhd", ds0, q.float())},
        "unrounded": {
            "dq": torch.einsum("bhqk,bkhd->bqhd", ds32, k.float()),
            "dk": torch.einsum("bhqk,bqhd->bkhd", ds32, q.float()),
            "dv": torch.einsum("bhqk,bqhd->bkhd", p32, g.float())},
    }
    del ds0, ds32, p32
    out = {}
    for cname, grads in bad.items():
        for name, t in grads.items():
            t = t.to(q.dtype)
            _, ratio, share = flash_bwd_gate(torch, t, ref[name],
                                             spread[name])
            out[f"{cname} {name}"] = (ratio, share, _err(t, ref[name])[1])
    return out


def controls_line(controls):
    return "; controls (fail, as they must): " + "; ".join(
        f"{n} ratio {r:.3e} equal {sh:.5f} old-gate {o:.3e} "
        f"({'passes' if o <= FLASH_BF16_TOL else 'fails'} 2e-2 x "
        "max(|ref|, 1))" for n, (r, sh, o) in controls.items())


def device_ms(torch, fn, iters, groups):
    """Device milliseconds per call of ``fn`` by ``torch.profiler``:
    ``{group: ms}`` summed over the kernels whose name holds any of the
    group's substrings (``groups``: ``{name: (substrings,)}``; an empty
    tuple takes every kernel), host work not counted."""
    for _ in range(3):
        fn()

    def window():
        for _ in range(iters):
            fn()

    prof = profiled(torch, window)
    out = dict.fromkeys(groups, 0.0)
    for e in prof.key_averages():
        us = kernel_us(e)
        for g, subs in groups.items():
            if not subs or any(x in e.key for x in subs):
                out[g] += us
    return {g: us / iters / 1e3 for g, us in out.items()}


def flash_tc_bwd_phase(torch, seed, nvcc_log):
    """``[flash tc bwd]``: the tensor-core split backward against its
    plain versions at the main path's shapes and awkward ones, in bf16
    and fp16, through :func:`flash_bwd_gate` and its controls; the SASS's
    ``HGMMA`` count, registers and spills; times at the main shape by
    events and by device time beside the CUDA-core pair it replaced for
    16-bit inputs and SDPA's backward alone."""
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 60)

    hgmma, regs, spills = sass_summary(_build.library_path("flash_bwd_sm90"),
                                       nvcc_log)
    print(f"[flash tc bwd] {TC_BWD_SOURCE}: {hgmma} HGMMA instructions in "
          f"the SASS; ptxas registers per kernel {regs}, spill store bytes "
          f"{spills}", flush=True)
    check(hgmma > 0, "[flash tc bwd] no HGMMA instruction in the SASS")
    check(not any(spills), f"[flash tc bwd] ptxas spills {spills}")
    res = {"hgmma": hgmma, "registers": regs, "spill_bytes": spills}

    B, S, H, D = TRAIN_B, TRAIN_S, 12, 64
    for dtype in (torch.bfloat16, torch.float16):
        dn = "bf16" if dtype == torch.bfloat16 else "fp16"

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        qkv = rnd(B, S, 3, H, D)                       # GPT's layout
        main = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], rnd(B, S, H, D))
        r, _ = tc_bwd_compare(torch, fk, f"{dn} GPT [B,S,H,D] views B={B} "
                              f"S={S} H={H} D={D} causal", *main, True,
                              controls=True)
        res[dn] = {"main": r, "args": main}
        seg_rows = 2 * 4
        qseg = torch.zeros((seg_rows, 300), dtype=torch.int32, device=dev)
        qseg[:, 150:] = 1
        qseg[:, 7] = 9                                 # sees no key
        kseg = torch.zeros((seg_rows, 300), dtype=torch.int32, device=dev)
        kseg[:, 150:] = 1
        _, dq = tc_bwd_compare(
            torch, fk, f"{dn} [B*H,S,D] [8, 300, 64] segment ids + a "
            "fully-masked row", *[rnd(seg_rows, 300, 1, 64) for _ in
                                  range(4)], False, qseg, kseg)
        check(bool((dq[:, 7] == 0).all()),
              f"[flash tc bwd] {dn} masked row: dq not exactly 0")
        tc_bwd_compare(torch, fk, f"{dn} S=1000 causal (ragged) "
                       "[2, 1000, 4, 64]",
                       *[rnd(2, 1000, 4, 64) for _ in range(4)], True)
        tc_bwd_compare(torch, fk, f"{dn} non-causal Sq=384 Sk=640",
                       rnd(2, 384, 4, 64), rnd(2, 640, 4, 64),
                       rnd(2, 640, 4, 64), rnd(2, 384, 4, 64), False)
        tc_bwd_compare(torch, fk, f"{dn} D=128 causal S=512",
                       *[rnd(2, 512, 4, 128) for _ in range(4)], True)
        tc_bwd_compare(torch, fk, f"{dn} D=128 non-causal Sq=200 Sk=333",
                       rnd(2, 200, 3, 128), rnd(2, 333, 3, 128),
                       rnd(2, 333, 3, 128), rnd(2, 200, 3, 128), False)
    print("[flash tc bwd] fully-masked row: dq exactly 0", flush=True)

    # times at the main shape: the tensor-core pair, the CUDA-core pair it
    # replaced for 16-bit inputs, the plain versions and SDPA's backward
    # alone (a yardstick, not used by the port)
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dn in ("bf16", "fp16"):
        q, k, v, g = res[dn].pop("args")
        out, lse = fk.flash_fwd(q, k, v, True)
        _, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, True)
        qt, kt, vt, gt = [t.transpose(1, 2) for t in (q, k, v, g)]
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        o = sdpa(*leaves, is_causal=True)

        def sdpa_bwd():
            torch.autograd.grad(o, leaves, gt, retain_graph=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(*leaves, is_causal=True), leaves, gt)

        def pair():
            fk.flash_bwd_dq(q, k, v, out, lse, g, True)
            fk.flash_bwd_dkv(q, k, v, g, lse, delta, True)

        def core_pair():
            fk._cuda_core_flash_bwd("dq", q, k, v, out, lse, g, True)
            fk._cuda_core_flash_bwd("dkv", q, k, v, g, lse, delta, True)

        calls = {
            "flash_bwd_dq": (
                lambda: fk.flash_bwd_dq(q, k, v, out, lse, g, True),
                lambda: fk._cuda_core_flash_bwd("dq", q, k, v, out, lse, g,
                                                True),
                lambda: fk.flash_bwd_dq_reference(q, k, v, out, lse, g,
                                                  True)),
            "flash_bwd_dkv": (
                lambda: fk.flash_bwd_dkv(q, k, v, g, lse, delta, True),
                lambda: fk._cuda_core_flash_bwd("dkv", q, k, v, g, lse,
                                                delta, True),
                lambda: fk.flash_bwd_dkv_reference(q, k, v, g, lse, delta,
                                                   True)),
        }
        with torch.no_grad():
            # flash_bwd_tc_kernel<T, D, mode>: mode 0 is dq, 1 dkv
            dev_ms = device_ms(torch, pair, 20, {
                "flash_bwd_dq": ("64, 0>", "128, 0>", "Li0EEEv"),
                "flash_bwd_dkv": ("64, 1>", "128, 1>", "Li1EEEv"),
                "all": ()})
            core_dev = device_ms(torch, core_pair, 5, {
                "flash_bwd_dq": ("flash_bwd_dq_kernel",),
                "flash_bwd_dkv": ("flash_bwd_dkv_kernel",)})
        lib_bwd_dev = device_ms(torch, sdpa_bwd, 20, {"all": ()})["all"]
        lib_bwd_ms = time_cuda(torch, sdpa_bwd, 20, flush=flush)
        lib_fb_ms = time_cuda(torch, sdpa_fwd_bwd, 20, flush=flush)
        with torch.no_grad():
            pair_ms = time_cuda(torch, pair, 20, flush=flush)
        for name, (kern, core, plain) in calls.items():
            with torch.no_grad():
                ms = time_cuda(torch, kern, 20, flush=flush)
                core_ms = time_cuda(torch, core, 5, warmup=2, flush=flush)
                plain_ms = time_cuda(torch, plain, 5, warmup=2, flush=flush)
            flops, nbytes = fk.kernel_work(name, B, H, S, S, D, True, 2)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS_PER_S * 1e3
            main = res[dn]["main"]
            errs = ([main["errs"]["dq"], main["errs"]["delta"]]
                    if name == "flash_bwd_dq" else
                    [main["errs"]["dk"], main["errs"]["dv"]])
            r = {"ms": ms, "device_ms": dev_ms[name],
                 "cuda_core_ms": core_ms,
                 "cuda_core_device_ms": core_dev[name],
                 "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "flops": flops, "bytes": nbytes,
                 "tflops": flops / (ms * 1e-3) / 1e12,
                 "device_tflops": flops / (dev_ms[name] * 1e-3) / 1e12,
                 "max_abs_err": max(errs)}
            res[dn][name] = r
            print(f"[flash tc bwd] {name}_tc {dn} B={B} S={S} H={H} D={D} "
                  f"causal: kernel_ms={ms:.5f} ({r['tflops']:.1f} TFLOP/s) "
                  f"device_ms={dev_ms[name]:.5f} "
                  f"({r['device_tflops']:.1f} TFLOP/s) cuda_core_ms="
                  f"{core_ms:.5f} (device {core_dev[name]:.5f}; "
                  f"{core_ms / ms:.2f}x the tensor-core time) plain_ms="
                  f"{plain_ms:.5f} bound_ms={r['bound_ms']:.5f} "
                  f"({r['bound_by']}: {flops} flop, {nbytes} bytes)",
                  flush=True)
        res[dn].update({"pair_ms": pair_ms, "pair_device_ms": dev_ms["all"],
                        "library_bwd_ms": lib_bwd_ms,
                        "library_bwd_device_ms": lib_bwd_dev,
                        "library_fwd_bwd_ms": lib_fb_ms})
        print(f"[flash tc bwd] {dn} pair dq+dkv: {pair_ms:.5f} ms by events, "
              f"{dev_ms['all']:.5f} ms device; library yardstick (not used "
              f"by the port): sdpa backward alone {lib_bwd_ms:.5f} ms by "
              f"events, {lib_bwd_dev:.5f} ms device; sdpa forward+backward "
              f"{lib_fb_ms:.5f} ms", flush=True)
        del o, leaves
    return res


# ---------------------------------------------------------------------------
# the tensor-core fused backward (K4a)
# ---------------------------------------------------------------------------
# flash_bwd_fused_tc is held by flash_bwd_gate as the split pair is: dk
# and dv come from the same fp32 sums in one fixed order, so the same
# thresholds hold.  dq's partials (one per kv warpgroup of 64 rows) are
# added through fp32 atomics in an order that changes from run to run;
# that moves dq's fp32 sum by a few ulps of fp32, far inside the bound's
# e_dS term, and its 16-bit rounding only where the sum straddles a
# boundary, so dq is held to the same share of equal elements too.


def tc_fused_compare(torch, fk, tag, q, k, v, g, causal, qseg=None,
                     kseg=None, controls=False):
    """The tensor-core ``flash_bwd_fused`` against
    ``flash_bwd_fused_reference`` on the same 16-bit values (the
    tensor-core forward's out and lse), through :func:`flash_bwd_gate`;
    a second run's dk and dv bitwise equal (dq's atomics may reorder);
    ``controls``: the delta = 0 and unrounded backwards must fail the
    gate.  Returns the readings and the gradients."""
    before = fk.flash_bwd_fused.tc_launches
    out, lse = fk.flash_fwd(q, k, v, causal, qseg, kseg)
    got = fk.flash_bwd_fused(q, k, v, out, lse, g, causal, qseg, kseg)
    again = fk.flash_bwd_fused(q, k, v, out, lse, g, causal, qseg, kseg)
    torch.cuda.synchronize()
    check(fk.flash_bwd_fused.tc_launches == before + 2,
          f"[flash tc fused] {tag}: the tensor-core sweep did not launch")
    ref = dict(zip(("dq", "dk", "dv"), fk.flash_bwd_fused_reference(
        q, k, v, out, lse, g, causal, qseg, kseg)))
    delta = fk._delta(out, g).contiguous()
    spread = flash_bwd_terms(torch, fk, q, k, v, g, out, lse, delta, causal,
                             qseg, kseg)
    errs, ratios, shares = {}, {}, {}
    for name, t in zip(("dq", "dk", "dv"), got):
        check(t.dtype == q.dtype and bool(torch.isfinite(t.float()).all()),
              f"[flash tc fused] {tag}: {name} dtype {t.dtype} or not "
              "finite")
        errs[name], ratios[name], shares[name] = flash_bwd_gate(
            torch, t, ref[name], spread[name])
    dkv_same = torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    dq_rerun = (got[0].float() - again[0].float()).abs().max().item()
    dq_rerun_equal = (got[0] == again[0]).float().mean().item()
    sm = TC_BWD_SAME_MIN[str(q.dtype).rsplit(".", 1)[-1]]
    line = (f"[flash tc fused] {tag}: max_abs_err " + " ".join(
        f"{n}={e:.3e}" for n, e in errs.items()) + "; gate ratio " + " ".join(
        f"{n}={r:.3e}" for n, r in ratios.items()) + " (<= 1); equal " +
        " ".join(f"{n}={x:.5f}" for n, x in shares.items()) +
        f" (>= {sm}); two runs: dk, dv bitwise equal {dkv_same}, dq "
        f"max diff {dq_rerun:.3e} ({dq_rerun_equal:.5f} equal)")
    res = {"errs": errs, "ratios": ratios, "shares": shares,
           "dq_rerun_equal": dq_rerun_equal}
    if controls:
        res["controls"] = bwd_controls(torch, fk, q, k, v, g, lse, delta,
                                       causal, qseg, kseg, ref, spread)
        line += controls_line(res["controls"])
    print(line, flush=True)
    for cname, (ratio, share, _) in res.get("controls", {}).items():
        check(not flash_bwd_passes(q.dtype, ratio, share),
              f"[flash tc fused] {tag}: the gate passes the {cname} "
              f"control (ratio {ratio:.3e}, equal {share:.5f})")
    for name in ("dq", "dk", "dv"):
        check(flash_bwd_passes(q.dtype, ratios[name], shares[name]),
              f"[flash tc fused] {tag}: {name} fails the gate (ratio "
              f"{ratios[name]:.3e}, equal {shares[name]:.5f})")
    check(dkv_same, f"[flash tc fused] {tag}: two runs' dk or dv differ")
    return res, got


def flash_tc_fused_phase(torch, seed, nvcc_log):
    """``[flash tc fused]``: the tensor-core fused backward against its
    plain version at GPT's and ERNIE's ``[B*H, S, D]`` shapes and awkward
    ones, in bf16 and fp16, with the two controls; times at both main
    shapes by device time beside the CUDA-core sweep it replaced for
    16-bit inputs, SDPA's backward alone and the tensor-core split
    pair."""
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 70)
    hgmma, regs, spills = sass_summary(_build.library_path("flash_bwd_sm90"),
                                       nvcc_log)
    print(f"[flash tc fused] {TC_BWD_SOURCE} (dq, dkv and the fused sweep): "
          f"{hgmma} HGMMA instructions in the SASS; ptxas registers per "
          f"kernel {regs}, spill store bytes {spills}", flush=True)
    check(not any(spills), f"[flash tc fused] ptxas spills {spills}")
    res = {"hgmma": hgmma, "registers": regs, "spill_bytes": spills}
    shapes = {"gpt": (TRAIN_B * 12, TRAIN_S, True),
              "ernie": (ERNIE_B * 12, ERNIE_S, False)}
    main = {}
    for dtype in (torch.bfloat16, torch.float16):
        dn = "bf16" if dtype == torch.bfloat16 else "fp16"

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        for model, (BH, S, causal) in shapes.items():
            args = [rnd(BH, S, 1, 64) for _ in range(4)]
            r, _ = tc_fused_compare(
                torch, fk, f"{dn} {model} [{BH}, {S}, 64] "
                f"{'causal' if causal else 'non-causal'}", *args, causal,
                controls=model == "gpt")
            res[f"{dn} {model}"] = r
            main[(dn, model)] = args
        qseg = torch.zeros((8, 300), dtype=torch.int32, device=dev)
        qseg[:, 150:] = 1
        qseg[:, 7] = 9                                 # sees no key
        kseg = torch.zeros((8, 300), dtype=torch.int32, device=dev)
        kseg[:, 150:] = 1
        _, got = tc_fused_compare(
            torch, fk, f"{dn} [8, 300, 64] segment ids + a fully-masked "
            "row", *[rnd(8, 300, 1, 64) for _ in range(4)], False, qseg,
            kseg)
        check(bool((got[0][:, 7] == 0).all()),
              f"[flash tc fused] {dn} masked row: dq not exactly 0")
        tc_fused_compare(torch, fk, f"{dn} S=1000 causal (ragged) "
                         "[8, 1000, 64]",
                         *[rnd(8, 1000, 1, 64) for _ in range(4)], True)
        tc_fused_compare(torch, fk, f"{dn} non-causal Sq=384 Sk=640 H=4",
                         rnd(2, 384, 4, 64), rnd(2, 640, 4, 64),
                         rnd(2, 640, 4, 64), rnd(2, 384, 4, 64), False)
        tc_fused_compare(torch, fk, f"{dn} D=128 causal S=512 H=4",
                         *[rnd(2, 512, 4, 128) for _ in range(4)], True)
        tc_fused_compare(torch, fk, f"{dn} D=128 non-causal Sq=200 Sk=333",
                         rnd(2, 200, 3, 128), rnd(2, 333, 3, 128),
                         rnd(2, 333, 3, 128), rnd(2, 200, 3, 128), False)
    print("[flash tc fused] fully-masked row: dq exactly 0", flush=True)

    # device times at both main shapes (bf16; fp16 at GPT's)
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for (dn, model), (q, k, v, g) in main.items():
        if dn == "fp16" and model == "ernie":
            continue
        BH, S, causal = shapes[model]
        out, lse = fk.flash_fwd(q, k, v, causal)
        _, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, causal)
        leaves = [t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v)]
        o_lib = sdpa(*leaves, is_causal=causal)
        gt = g.transpose(1, 2)

        def fused():
            fk.flash_bwd_fused(q, k, v, out, lse, g, causal)

        def core():
            fk._cuda_core_flash_bwd("fused", q, k, v, out, lse, g, causal)

        def pair():
            fk.flash_bwd_dq(q, k, v, out, lse, g, causal)
            fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal)

        with torch.no_grad():
            dev_ms = device_ms(torch, fused, 20, {
                "sweep": ("flash_bwd_tc_kernel",), "all": ()})
            core_dev = device_ms(torch, core, 5, {
                "sweep": ("flash_bwd_fused_kernel",), "all": ()})
            pair_dev = device_ms(torch, pair, 20, {"all": ()})["all"]
            ms = time_cuda(torch, fused, 20, flush=flush)
            core_ms = time_cuda(torch, core, 5, warmup=2, flush=flush)
            plain_ms = time_cuda(torch, lambda: fk.flash_bwd_fused_reference(
                q, k, v, out, lse, g, causal), 5, warmup=2, flush=flush)
        lib_bwd_dev = device_ms(torch, lambda: torch.autograd.grad(
            o_lib, leaves, gt, retain_graph=True), 20, {"all": ()})["all"]
        del o_lib
        flops, nbytes = fk.kernel_work("flash_bwd_fused", BH, 1, S, S, 64,
                                       causal, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        r = {"ms": ms, "device_ms": dev_ms["all"],
             "sweep_device_ms": dev_ms["sweep"], "cuda_core_ms": core_ms,
             "cuda_core_device_ms": core_dev["all"],
             "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_bwd_device_ms": lib_bwd_dev,
             "pair_device_ms": pair_dev, "flops": flops, "bytes": nbytes,
             "device_tflops": flops / (dev_ms["all"] * 1e-3) / 1e12,
             "max_abs_err": max(res[f"{dn} {model}"]["errs"].values())}
        res[f"{dn} {model}"].update(r)
        print(f"[flash tc fused] flash_bwd_fused_tc {dn} {model} [{BH}, {S}, "
              f"64] {'causal' if causal else 'non-causal'}: device_ms="
              f"{r['device_ms']:.5f} (sweep {r['sweep_device_ms']:.5f}; "
              f"{r['device_tflops']:.1f} TFLOP/s) kernel_ms={ms:.5f} "
              f"cuda_core device_ms={r['cuda_core_device_ms']:.5f} "
              f"({r['cuda_core_device_ms'] / r['device_ms']:.2f}x; events "
              f"{core_ms:.5f}) plain_ms={plain_ms:.5f} bound_ms="
              f"{r['bound_ms']:.5f} ({r['bound_by']}: {flops} flop, {nbytes} "
              f"bytes); tensor-core split pair device_ms={pair_dev:.5f}; "
              f"library yardstick (not used by the port): sdpa backward "
              f"alone device_ms={lib_bwd_dev:.5f} "
              f"({r['device_ms'] / lib_bwd_dev:.2f}x)", flush=True)
    return res


# ---------------------------------------------------------------------------
# [B*H, S, D] flash configuration: head-packed forward, fused backward
# ---------------------------------------------------------------------------
class knobs_set:
    """Set environment knobs for a ``with`` block, restoring them after."""

    def __init__(self, values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bh_compare(torch, fk, tag, tol, q, k, v, g, causal, hp=2, qseg=None,
               kseg=None):
    """The head-packed forward (or, with segment ids, ``flash_fwd``)
    and the fused backward against their plain versions; in fp32 also
    against ``flash_fwd`` and the split pair on the same inputs."""
    if qseg is None:
        out, lse = fk.flash_fwd_hpack(q, k, v, hp, causal)
    else:
        out, lse = fk.flash_fwd(q, k, v, causal, qseg, kseg)
    dq, dk, dv = fk.flash_bwd_fused(q, k, v, out, lse, g, causal, qseg, kseg)
    got = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    rout, rlse = fk.flash_attention_reference(
        *[t.float() for t in (q, k, v)], causal, qseg, kseg)
    rdq, rdk, rdv = fk.flash_bwd_fused_reference(q, k, v, out, lse, g, causal,
                                                 qseg, kseg)
    ref = {"out": rout, "lse": rlse, "dq": rdq, "dk": rdk, "dv": rdv}
    pair = {}
    if q.dtype == torch.float32:
        fout, flse = fk.flash_fwd(q, k, v, causal, qseg, kseg)
        sdq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, causal, qseg, kseg)
        sdk, sdv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal, qseg,
                                    kseg)
        pair = {"out": fout, "lse": flse, "dq": sdq, "dk": sdk, "dv": sdv}
    torch.cuda.synchronize()
    errs, pair_errs = {}, {}
    for name in got:
        check(got[name].dtype == (torch.float32 if name == "lse" else q.dtype),
              f"[flash bh] {tag}: {name} dtype {got[name].dtype}")
        check(bool(torch.isfinite(got[name].float()).all()),
              f"[flash bh] {tag}: {name} not finite")
        err, rel = _err(got[name], ref[name])
        check(rel <= tol, f"[flash bh] {tag}: {name} error {err:.3e} "
                          f"(relative {rel:.3e}) > {tol}")
        errs[name] = err
        if pair:
            err, rel = _err(got[name], pair[name])
            check(rel <= FLASH_PAIR_TOL, f"[flash bh] {tag}: {name} vs "
                  f"flash_fwd / split pair {err:.3e} > {FLASH_PAIR_TOL}")
            pair_errs[name] = err
    line = (f"[flash bh] {tag}: vs plain max_abs_err " + " ".join(
        f"{n}={e:.3e}" for n, e in errs.items()) + f" (tol {tol} x "
        "max(|ref|, 1))")
    if pair:
        same = torch.equal(out, pair["out"]) and torch.equal(lse, pair["lse"])
        line += ("; vs flash_fwd + split pair " + " ".join(
            f"{n}={e:.3e}" for n, e in pair_errs.items())
            + f" (tol {FLASH_PAIR_TOL}; forward bitwise equal: {same})")
    print(line, flush=True)
    return got, errs


def flash_bh_phase(torch, seed):
    from paddle_tpu_torch.nn.functional import flash_attention
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 10)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # the main path's shapes, as the public function hands them over:
    # contiguous [B*H, S, 1, D]
    shapes = {"gpt": (TRAIN_B * 12, TRAIN_S, True),
              "ernie": (ERNIE_B * 12, ERNIE_S, False)}
    res, main = {"bf16": {}, "fp32": {}}, {}
    for dtype, tol in ((torch.bfloat16, FLASH_BF16_TOL),
                       (torch.float32, FLASH_FP32_TOL)):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        for model, (BH, S, causal) in shapes.items():
            args = [rnd(BH, S, 1, 64, dtype=dtype) for _ in range(4)]
            _, errs = bh_compare(
                torch, fk, f"{name} {model} [{BH}, {S}, 64] "
                f"{'causal' if causal else 'non-causal'} hp=2", tol, *args,
                causal)
            for n, e in errs.items():
                res[name][n] = max(res[name].get(n, 0.0), e)
            if dtype == torch.bfloat16:
                main[model] = args

    tol = FLASH_FP32_TOL
    bh_compare(torch, fk, "S=1000 causal (ragged) hp=2", tol,
               *[rnd(8, 1000, 1, 64) for _ in range(4)], True)
    q = rnd(2, 300, 3, 64)
    bh_compare(torch, fk, "[2, 300, 3, 64] odd H, hp=2 pairs straddle "
               "batches", tol, q, *[rnd(2, 300, 3, 64) for _ in range(3)],
               False)
    bh_compare(torch, fk, "hp=4 non-causal [8, 256, 64]", tol,
               *[rnd(8, 256, 1, 64) for _ in range(4)], False, hp=4)
    qseg = torch.zeros((2, 300), dtype=torch.int32, device=dev)
    qseg[:, 150:] = 1
    qseg[:, 7] = 9                                   # sees no key
    kseg = torch.zeros((2, 300), dtype=torch.int32, device=dev)
    kseg[:, 150:] = 1
    got, _ = bh_compare(torch, fk, "segment ids + fully-masked row through "
                        "the fused backward", tol,
                        *[rnd(2, 300, 4, 64) for _ in range(4)], False,
                        qseg=qseg, kseg=kseg)
    check(bool((got["out"][:, 7] == 0).all())
          and bool((got["dq"][:, 7] == 0).all()),
          "[flash bh] masked row: out or dq not exactly 0")
    # D=128 under HEADPACK=2: the rule sends it to flash_fwd
    q, k, v = [rnd(2, 256, 4, 128).requires_grad_() for _ in range(3)]
    g = rnd(2, 256, 4, 128)
    fk.reset_counts()
    with knobs_set(BH_KNOBS):
        out, _ = flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(out, [q, k, v], g)
    counts = {f.__name__: f.launches for f in fk.ALL_WRAPPERS}
    check(counts == {"flash_fwd": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                     "flash_fwd_hpack": 0, "flash_bwd_fused": 1},
          f"[flash bh] D=128 under HEADPACK=2 launched {counts}")
    ref, _ = fk.flash_attention_reference(q, k, v, True)
    rgrads = torch.autograd.grad(ref, [q, k, v], g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out, *grads),
                          (ref, *rgrads)):
        err, rel = _err(a, b)
        check(rel <= tol, f"[flash bh] D=128 {name} error {err:.3e}")
    print(f"[flash bh] D=128 through flash_attention under the knobs: "
          f"launches {counts}; out and grads within {tol}", flush=True)

    # times at both main shapes, bf16; the GPT shape's go in the JSON
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for model, (BH, S, causal) in shapes.items():
        q, k, v, g = main[model]
        out, lse = fk.flash_fwd_hpack(q, k, v, 2, causal)
        qt, kt, vt, gt = [t.transpose(1, 2) for t in (q, k, v, g)]
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]

        def sdpa_fwd_bwd():
            o = sdpa(*leaves, is_causal=causal)
            torch.autograd.grad(o, leaves, gt)

        o_lib = sdpa(*leaves, is_causal=causal)
        # device times of the fused backward (its three launches) and of
        # SDPA's backward alone, host work not counted
        with torch.no_grad():
            fused_dev = device_ms(torch, lambda: fk.flash_bwd_fused(
                q, k, v, out, lse, g, causal), 20, {"all": ()})["all"]
        lib_bwd_dev = device_ms(torch, lambda: torch.autograd.grad(
            o_lib, leaves, gt, retain_graph=True), 20, {"all": ()})["all"]
        del o_lib
        calls = {
            "flash_fwd_hpack": (
                lambda: fk.flash_fwd_hpack(q, k, v, 2, causal),
                lambda: fk.flash_attention_reference(q, k, v, causal),
                lambda: sdpa(qt, kt, vt, is_causal=causal)),
            "flash_bwd_fused": (
                lambda: fk.flash_bwd_fused(q, k, v, out, lse, g, causal),
                lambda: fk.flash_bwd_fused_reference(q, k, v, out, lse, g,
                                                     causal),
                sdpa_fwd_bwd),
        }
        for name, (kern, plain, lib) in calls.items():
            with torch.no_grad():
                ms = time_cuda(torch, kern, 20, flush=flush)
                plain_ms = time_cuda(torch, plain, 5, warmup=2, flush=flush)
            lib_ms = time_cuda(torch, lib, 20, flush=flush)
            flops, nbytes = fk.kernel_work(name, BH, 1, S, S, 64, causal, 2)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS_PER_S * 1e3
            r = {"ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": lib_ms, "flops": flops, "bytes": nbytes,
                 "tflops": flops / (ms * 1e-3) / 1e12}
            if name == "flash_bwd_fused":
                r.update({"device_ms": fused_dev,
                          "library_bwd_device_ms": lib_bwd_dev})
            res.setdefault(name, {})[model] = r
            print(f"[flash bh] {name} bf16 {model} [{BH}, {S}, 64] "
                  f"{'causal' if causal else 'non-causal'}: kernel_ms="
                  f"{ms:.5f} plain_ms={plain_ms:.5f} bound_ms="
                  f"{r['bound_ms']:.5f} ({r['bound_by']}: {flops} flop, "
                  f"{nbytes} bytes) achieved {r['tflops']:.2f} TFLOP/s; "
                  f"library_ms (sdpa "
                  f"{'forward' if name == 'flash_fwd_hpack' else 'forward+backward'}"
                  f", not used by the port)={lib_ms:.5f}"
                  + (f"; device_ms={fused_dev:.5f}, sdpa backward alone "
                     f"device_ms={lib_bwd_dev:.5f}"
                     if name == "flash_bwd_fused" else ""), flush=True)
    # the layout's cost: one [B, S, H, D] <-> [B*H, S, D] copy at GPT's
    # training shape; a layer makes eight (q, k, v, out; dO, dq, dk, dv)
    qkv = rnd(TRAIN_B, TRAIN_S, 3, 12, 64, dtype=torch.bfloat16)
    copy_ms = time_cuda(torch, lambda: qkv[:, :, 0].transpose(1, 2)
                        .contiguous(), 50, flush=flush)
    res["layout_copy_ms"] = copy_ms
    print(f"[flash bh] layout copy [8, 1024, 12, 64] bf16 view -> contiguous "
          f"[96, 1024, 64]: {copy_ms:.5f} ms; x 8 per layer x 12 layers = "
          f"{copy_ms * 96:.3f} ms per GPT-2-small step", flush=True)
    return res


# ---------------------------------------------------------------------------
# fused lm-head cross-entropy: the three kernels against their plain versions
# ---------------------------------------------------------------------------
LMCE_KERNELS = ("lmce_fwd", "lmce_bwd_dh", "lmce_bwd_dw")
LMCE_REPLACES = {
    "lmce_fwd": "paddle_tpu/ops/pallas_lmce.py:58",
    "lmce_bwd_dh": "paddle_tpu/ops/pallas_lmce.py:108",
    "lmce_bwd_dw": "paddle_tpu/ops/pallas_lmce.py:138",
}
LMCE_V, LMCE_D = 50304, 768      # GPT-2-small's vocabulary and width


def lmce_compare(torch, lk, tag, tol, h, w, labels, g):
    """The three kernels against the plain versions computed in fp32 on
    the same values (the backward from the plain forward's lse);
    ignored rows must give exactly 0 loss and 0 dh."""
    loss, lse = lk.lmce_fwd(h, w, labels)
    got = {"loss": loss, "lse": lse,
           "dh": lk.lmce_bwd_dh(h, w, labels, lse, g),
           "dw": lk.lmce_bwd_dw(h, w, labels, lse, g)}
    hf, wf = h.float(), w.float()
    rloss, rlse = lk.lmce_reference(hf, wf, labels)
    ref = {"loss": rloss, "lse": rlse,
           "dh": lk.lmce_bwd_dh_reference(hf, wf, labels, rlse, g),
           "dw": lk.lmce_bwd_dw_reference(hf, wf, labels, rlse, g)}
    torch.cuda.synchronize()
    check(got["dh"].dtype == got["dw"].dtype == h.dtype,
          f"[lmce] {tag}: gradient dtypes {got['dh'].dtype}")
    errs, rels = {}, {}
    for name in ("loss", "lse", "dh", "dw"):
        check(bool(torch.isfinite(got[name].float()).all()),
              f"[lmce] {tag}: {name} not finite")
        err, rel = _err(got[name], ref[name])
        check(rel <= tol, f"[lmce] {tag}: {name} error {err:.3e} "
                          f"(relative {rel:.3e}) > {tol}")
        errs[name], rels[name] = err, rel
    ignored = labels < 0
    n_ignored = int(ignored.sum().item())
    if n_ignored:
        check(bool((got["loss"][ignored] == 0).all())
              and bool((got["dh"][ignored] == 0).all()),
              f"[lmce] {tag}: ignored rows not exactly 0")
    print(f"[lmce] {tag}: max_abs_err " + " ".join(
        f"{n}={e:.3e}" for n, e in errs.items()) + "; / max(|ref|, 1) "
          + " ".join(f"{n}={r:.3e}" for n, r in rels.items())
          + f" (tol {tol}); {n_ignored} ignored rows exactly 0",
          flush=True)
    return errs


def lmce_phase(torch, seed):
    from paddle_tpu_torch.ops import lmce_kernel as lk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def inputs(N, V, D, dtype, ignore=False):
        h = torch.randn((N, D), generator=gen, device=dev)
        w = torch.randn((V, D), generator=gen, device=dev) * 0.05
        labels = torch.randint(0, V, (N,), generator=gen, device=dev)
        if ignore:
            labels[::4] = -100
        g = torch.rand((N,), generator=gen, device=dev)
        return h.to(dtype), w.to(dtype), labels, g

    N, V, D = TRAIN_B * TRAIN_S, LMCE_V, LMCE_D
    res = {}
    for dtype, tol in ((torch.bfloat16, FLASH_BF16_TOL),
                       (torch.float32, FLASH_FP32_TOL)):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        args = inputs(N, V, D, dtype)
        res[name] = lmce_compare(torch, lk, f"{name} N={N} V={V} D={D}",
                                 tol, *args)
        if dtype == torch.bfloat16:
            main = args
        del args
    tol = FLASH_FP32_TOL
    lmce_compare(torch, lk, "N=1000 V=1000 D=64, every 4th label -100",
                 tol, *inputs(1000, 1000, 64, torch.float32, True))
    lmce_compare(torch, lk, "N=1000 V=786 D=2048, every 4th label -100",
                 tol, *inputs(1000, 786, 2048, torch.float32, True))
    lmce_compare(torch, lk, "N=333 V=786 D=200", tol,
                 *inputs(333, 786, 200, torch.float32))

    # times at the main shape, bf16
    h, w, labels, g = main
    _, lse = lk.lmce_fwd(h, w, labels)
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    # the backward's times are [lmce tc]'s (both bodies)
    calls = {
        "lmce_fwd": (lambda: lk.lmce_fwd(h, w, labels),
                     lambda: lk.lmce_reference(h, w, labels)),
    }
    # yardstick only, never called by the port: the unfused lm head
    ce = torch.nn.functional.cross_entropy
    leaves = [t.detach().requires_grad_() for t in (h, w)]

    def library_fwd():
        return ce(torch.matmul(h, w.t()).float(), labels, reduction="none")

    def library_fwd_bwd():
        loss = ce(torch.matmul(leaves[0], leaves[1].t()).float(), labels,
                  reduction="none")
        torch.autograd.grad(loss, leaves, g)

    with torch.no_grad():
        lib_ms = time_cuda(torch, library_fwd, 10, warmup=2, flush=flush)
    lib_fb_ms = time_cuda(torch, library_fwd_bwd, 10, warmup=2, flush=flush)
    for name, (kern, plain) in calls.items():
        with torch.no_grad():
            ms = time_cuda(torch, kern, 5, warmup=2, flush=flush)
            plain_ms = time_cuda(torch, plain, 5, warmup=2, flush=flush)
        flops, nbytes = lk.kernel_work(name, N, V, D, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        err_keys = ("loss", "lse")
        res[name] = {
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms if name == "lmce_fwd" else None,
            "library_fwd_bwd_ms": lib_fb_ms,
            "max_abs_err": max(res["bf16"][k] for k in err_keys),
            "fp32_max_abs_err": max(res["fp32"][k] for k in err_keys),
            "flops": flops, "bytes": nbytes,
            "tflops": flops / (ms * 1e-3) / 1e12,
        }
        r = res[name]
        print(f"[lmce] {name} bf16 N={N} V={V} D={D}: kernel_ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}: {flops} flop, {nbytes} bytes) achieved "
              f"{r['tflops']:.2f} TFLOP/s", flush=True)
    print(f"[lmce] library yardstick (not used by the port): matmul + fp32 "
          f"cross_entropy forward {lib_ms:.5f} ms, forward+backward "
          f"{lib_fb_ms:.5f} ms", flush=True)
    return res


LMCE_SOURCE = "paddle_tpu_torch/csrc/lmce.cu"
LMCE_TC_SOURCE = "paddle_tpu_torch/csrc/lmce_sm90.cu"
LMCE_TC_KERNELS = ("lmce_bwd_dh_tc", "lmce_bwd_dw_tc")
LMCE_RAGGED = (("N=333 V=786 D=200", 333, 786, 200, False),
               ("N=1000 V=1000 D=64, every 4th label -100", 1000, 1000, 64,
                True),
               ("N=1000 V=786 D=2048 (three D windows), every 4th label "
                "-100", 1000, 786, 2048, True))
# The 16-bit LMCE gradients are held element by element:
#   |got - ref| <= rtol |ref| + (u |dL| + eta) @ |B|
# where B is the other factor (W for dh, h for dW).  The kernel and the
# plain version round the same fp32 sums, so the outputs may part by one
# ulp of the value: rtol is 2^-7 of it in bf16, 2^-10 in fp16, plus
# margin.  Before that, each side rounds dL to the operand dtype from
# fp32 values that differ slightly (S summed in another order by the
# tensor cores): where they straddle a rounding boundary a term moves
# by one ulp of dL, and an element whose terms cancel can move by much
# more than an ulp of its own value.  (u |dL| + eta) @ |B| is the
# forward bound of rounding every dL once (u = eps / 2, half an ulp;
# eta = half the subnormal spacing, which fp16's dL of ~1e-5 reaches).
# A gate scaled by max|ref| alone could not see the softmax part of the
# gradient, ~1% of the one-hot part at GPT-2-small's shape.
LMCE_GRAD_RTOL = {"bfloat16": 1e-2, "float16": 2e-3}


def lmce_grad_gate(torch, lk, which, got, ref, h, w, labels, lse, g):
    """``(max abs error, ratio)`` of a 16-bit LMCE gradient (``which``
    ``"dh"`` or ``"dw"``) against its plain version ``ref`` on the same
    inputs: ``ratio`` is the largest ``|got - ref| / (rtol |ref| + (u |dL|
    + eta) @ |B|)`` over the elements, and the gate passes at ``ratio
    <= 1``."""
    fi = torch.finfo(got.dtype)
    rtol = LMCE_GRAD_RTOL[str(got.dtype).rsplit(".", 1)[-1]]
    dl = lk._dlogits(h, w, labels, lse, g, h.dtype).abs_()
    dl.mul_(fi.eps / 2).add_(fi.tiny * fi.eps / 2)
    spread = (dl @ w.float().abs() if which == "dh"
              else dl.t() @ h.float().abs())
    del dl
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    bound = rtol * ref.abs()
    ratio = torch.where(diff == 0, torch.zeros_like(diff),
                        diff / (bound + spread)).max().item()
    return diff.max().item(), ratio


def lmce_s_free(torch, which, h, w, labels, lse, g):
    """The plain gradient of a backward that drops the S product (S = 0,
    p = exp(-lse)): the gate's negative control, which must fail it."""
    lab = labels.long()
    cols = torch.arange(w.shape[0], device=h.device)
    gv = torch.where(lab >= 0, g.float(), torch.zeros_like(g.float()))
    dl = ((torch.exp(-lse.float())[:, None]
           - (cols[None, :] == lab[:, None]).float()) * gv[:, None])
    dl = dl.to(h.dtype).float()
    if which == "dh":
        return (dl @ w.float()).to(h.dtype)
    return (dl.t() @ h.float()).to(w.dtype)


def lmce_tc_compare(torch, lk, tag, h, w, labels, g, control=False):
    """The tensor-core backward (``lmce_bwd_dh`` / ``lmce_bwd_dw`` on
    16-bit operands) against the plain versions on the same values (dL
    rounded to the operand dtype, products summed in fp32) from the
    plain lse, element by element (:func:`lmce_grad_gate`); rows with an
    ignored label exactly 0 in dh; a second run bitwise equal.
    ``control``: the S-free gradient (:func:`lmce_s_free`) must fail
    the same gate.  Returns the max abs errors and the gate's ratios."""
    _, lse = lk.lmce_reference(h, w, labels)
    bwd = (lk.lmce_bwd_dh, lk.lmce_bwd_dw)
    before = [f.tc_launches for f in bwd]
    got = {"dh": lk.lmce_bwd_dh(h, w, labels, lse, g),
           "dw": lk.lmce_bwd_dw(h, w, labels, lse, g)}
    again = {"dh": lk.lmce_bwd_dh(h, w, labels, lse, g),
             "dw": lk.lmce_bwd_dw(h, w, labels, lse, g)}
    torch.cuda.synchronize()
    check([f.tc_launches for f in bwd] == [b + 2 for b in before],
          f"[lmce tc] {tag}: the tensor-core kernels did not launch")
    errs, ratios, controls = {}, {}, {}
    for name, plain in (("dh", lk.lmce_bwd_dh_reference),
                        ("dw", lk.lmce_bwd_dw_reference)):
        ref = plain(h, w, labels, lse, g)
        check(got[name].dtype == h.dtype,
              f"[lmce tc] {tag}: {name} dtype {got[name].dtype}")
        check(bool(torch.isfinite(got[name].float()).all()),
              f"[lmce tc] {tag}: {name} not finite")
        err, ratio = lmce_grad_gate(torch, lk, name, got[name], ref, h, w,
                                    labels, lse, g)
        check(ratio <= 1.0, f"[lmce tc] {tag}: {name} error {err:.3e}, "
              f"gate ratio {ratio:.3e} > 1")
        errs[name], ratios[name] = err, ratio
        if control:
            controls[name] = lmce_grad_gate(
                torch, lk, name, lmce_s_free(torch, name, h, w, labels, lse,
                                             g), ref, h, w, labels, lse, g)[1]
            check(controls[name] > 1.0, f"[lmce tc] {tag}: the gate passes "
                  f"the S-free {name} (ratio {controls[name]:.3e})")
        del ref
    same = all(torch.equal(got[k], again[k]) for k in got)
    check(same, f"[lmce tc] {tag}: two runs differ")
    ignored = labels < 0
    n_ignored = int(ignored.sum().item())
    if n_ignored:
        check(bool((got["dh"][ignored] == 0).all()),
              f"[lmce tc] {tag}: ignored rows of dh not exactly 0")
    dn = str(h.dtype).rsplit(".", 1)[-1]
    print(f"[lmce tc] {tag}: max_abs_err dh={errs['dh']:.3e} "
          f"dw={errs['dw']:.3e}; gate ratio dh={ratios['dh']:.3e} "
          f"dw={ratios['dw']:.3e} (per element |err| <= "
          f"{LMCE_GRAD_RTOL[dn]} |ref| + (u |dL| + eta) @ |B|, passes <= 1)"
          + (f"; the S-free control's ratio dh={controls['dh']:.3e} "
             f"dw={controls['dw']:.3e} (fails, as it must)"
             if control else "")
          + f"; two runs bitwise equal: {same}; {n_ignored} ignored rows "
          "of dh exactly 0", flush=True)
    return errs, ratios


def lmce_tc_phase(torch, seed, nvcc_log):
    """``[lmce tc]``: the tensor-core backward (``csrc/lmce_sm90.cu``)
    against its plain versions at the main shape in bf16 and fp16 and at
    the ragged shapes in both, the SASS's ``HGMMA`` count, and times at
    the main shape beside the CUDA-core backward it replaced for 16-bit
    operands and the plain versions."""
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import lmce_kernel as lk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 30)

    def inputs(N, V, D, dtype, ignore=False):
        h = torch.randn((N, D), generator=gen, device=dev)
        w = torch.randn((V, D), generator=gen, device=dev) * 0.05
        labels = torch.randint(0, V, (N,), generator=gen, device=dev)
        if ignore:
            labels[::4] = -100
        g = torch.rand((N,), generator=gen, device=dev)
        return h.to(dtype), w.to(dtype), labels, g

    hgmma, regs, spills = sass_summary(_build.library_path("lmce_sm90"),
                                       nvcc_log)
    print(f"[lmce tc] {LMCE_TC_SOURCE}: {hgmma} HGMMA instructions in the "
          f"SASS; ptxas registers per kernel {regs}, spill store bytes "
          f"{spills}", flush=True)
    check(hgmma > 0, "[lmce tc] no HGMMA instruction in the SASS")
    res = {"hgmma": hgmma, "registers": regs, "spill_bytes": spills}

    N, V, D = TRAIN_B * TRAIN_S, LMCE_V, LMCE_D
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    for dtype in (torch.bfloat16, torch.float16):
        dn = "bf16" if dtype == torch.bfloat16 else "fp16"
        h, w, labels, g = inputs(N, V, D, dtype)
        errs, ratios = lmce_tc_compare(torch, lk, f"{dn} N={N} V={V} D={D}",
                                       h, w, labels, g, control=True)
        for tag, n, v, d, ignore in LMCE_RAGGED:
            e, r = lmce_tc_compare(torch, lk, f"{dn} {tag}",
                                   *inputs(n, v, d, dtype, ignore))
            errs = {k: max(x, e[k]) for k, x in errs.items()}
            ratios = {k: max(x, r[k]) for k, x in ratios.items()}
        _, lse = lk.lmce_fwd(h, w, labels)
        for which, name in (("dh", "lmce_bwd_dh"), ("dw", "lmce_bwd_dw")):
            fn = getattr(lk, name)
            plain = getattr(lk, f"{name}_reference")
            with torch.no_grad():
                ms = time_cuda(torch, lambda: fn(h, w, labels, lse, g), 10,
                               warmup=2, flush=flush)
                core_ms = time_cuda(
                    torch, lambda: lk._cuda_core_bwd(which, h, w, labels, lse,
                                                     g), 3, warmup=1,
                    flush=flush)
                plain_ms = time_cuda(
                    torch, lambda: plain(h, w, labels, lse, g), 3, warmup=1,
                    flush=flush)
            flops, nbytes = lk.kernel_work(name, N, V, D, 2)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS_PER_S * 1e3
            r = {"ms": ms, "cuda_core_ms": core_ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "flops": flops, "bytes": nbytes,
                 "tflops": flops / (ms * 1e-3) / 1e12,
                 "cuda_core_tflops": flops / (core_ms * 1e-3) / 1e12,
                 "max_abs_err": errs[which], "gate_ratio": ratios[which]}
            res[f"{name}_tc {dn}"] = r
            print(f"[lmce tc] {name}_tc {dn} N={N} V={V} D={D}: kernel_ms="
                  f"{ms:.5f} ({r['tflops']:.1f} TFLOP/s) cuda_core_ms="
                  f"{core_ms:.5f} ({r['cuda_core_tflops']:.1f} TFLOP/s, "
                  f"{core_ms / ms:.2f}x the tensor-core time) plain_ms="
                  f"{plain_ms:.5f} bound_ms={r['bound_ms']:.5f} "
                  f"({r['bound_by']}: {flops} flop, {nbytes} bytes)",
                  flush=True)
        del h, w, labels, g, lse
    return res


LMCE_FWD_TC_SOURCE = "paddle_tpu_torch/csrc/lmce_fwd_sm90.cu"
# The tensor-core forward's loss and lse are held per row against the
# plain version on the same 16-bit values:
#   |lse - ref| <= D eps32 A + V eps32 + 4 eps32 |ref|
#   |loss - ref| <= 2 D eps32 A + V eps32 + 4 eps32 |ref|
# with A = max_v sum_d |h_d| |w_vd|: both sides sum each logit's D
# products in fp32 in other orders (each within (D - 1) eps32 / 2 of
# sum|terms|, and lse moves by at most the largest logit's error, the
# loss by that and the picked logit's), the sum-exp over V terms in
# another order and with ex2.approx (a relative error of at most V eps32
# between the two), and the final log and subtraction round once or
# twice.  Ignored rows must be exactly 0.
LMCE_FWD_RAGGED = (("N=333 V=786 D=200", 333, 786, 200, False),
                   ("N=1000 V=1000 D=64, every 4th label -100", 1000, 1000,
                    64, True),
                   ("N=1000 V=786 D=2048 (h streamed), every 4th label "
                    "-100", 1000, 786, 2048, True))


def lmce_fwd_gate(torch, got, ref, h, w, labels):
    """The largest ``|err| / bound`` of a forward's ``(loss, lse)``
    against the plain ``ref`` over the rows (the bound above); passes at
    ``<= 1``.  Rows whose plain loss is the unmatched-label ``-NEG`` are
    held to the same relative bound."""
    eps = torch.finfo(torch.float32).eps
    D, V = h.shape[1], w.shape[0]
    a = (h.float().abs() @ w.float().abs().t()).amax(dim=-1)
    base = D * eps * a + V * eps
    ratio = 0.0
    for t, r, extra in ((got[1], ref[1], 0.0), (got[0], ref[0], D * eps * a)):
        diff = (t.float() - r.float()).abs()
        bound = base + extra + 4 * eps * r.float().abs()
        ratio = max(ratio, torch.where(diff == 0, torch.zeros_like(diff),
                                       diff / bound).max().item())
    return ratio


def lmce_fwd_controls(torch, lk, slices, h, w, labels):
    """Three broken forwards the gate must fail: the ragged vocabulary
    edge left out, the label column off by one, and the split forward's
    combine without one slice's partial."""
    V = w.shape[0]
    lab = labels.long()
    part = lk.lmce_fwd_partials(h, w, labels, slices)
    keep = [k for k in range(slices) if k != slices // 2]
    return {
        "ragged edge dropped": lk.lmce_reference(
            h, w[:V - V % lk.FWD_VOCAB_TILE], labels),
        "label column + 1": lk.lmce_reference(
            h, w, torch.where(lab >= 0, lab + 1, lab)),
        "one slice not combined": lk.lmce_fwd_combine(part[:, keep], labels),
    }


def lmce_tc_fwd_compare(torch, lk, tag, h, w, labels, controls=False):
    """The tensor-core ``lmce_fwd`` against ``lmce_reference`` on the same
    16-bit values through :func:`lmce_fwd_gate`; ignored rows exactly 0;
    a second run bitwise equal; ``controls`` (a ragged V): the three
    broken forwards of :func:`lmce_fwd_controls` fail the gate."""
    before = lk.lmce_fwd.tc_launches
    got = lk.lmce_fwd(h, w, labels)
    again = lk.lmce_fwd(h, w, labels)
    torch.cuda.synchronize()
    check(lk.lmce_fwd.tc_launches == before + 2,
          f"[lmce tc fwd] {tag}: the tensor-core forward did not launch")
    ref = lk.lmce_reference(h, w, labels)
    for name, t in zip(("loss", "lse"), got):
        check(t.dtype == torch.float32 and bool(torch.isfinite(t).all()),
              f"[lmce tc fwd] {tag}: {name} dtype {t.dtype} or not finite")
    ratio = lmce_fwd_gate(torch, got, ref, h, w, labels)
    errs = {n: (a - b).abs().max().item()
            for n, a, b in zip(("loss", "lse"), got, ref)}
    same = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    ignored = labels < 0
    n_ignored = int(ignored.sum().item())
    line = (f"[lmce tc fwd] {tag}: max_abs_err loss={errs['loss']:.3e} "
            f"lse={errs['lse']:.3e}; gate ratio {ratio:.3e} (<= 1); two runs "
            f"bitwise equal: {same}; {n_ignored} ignored rows exactly 0")
    ctl = {}
    if controls:
        sms = torch.cuda.get_device_properties(h.device).multi_processor_count
        slices = lk.vocab_slices(h.shape[0], w.shape[0], sms)
        check(slices > 1 and w.shape[0] % lk.FWD_VOCAB_TILE,
              f"[lmce tc fwd] {tag}: the controls need a ragged V and "
              "several slices")
        for name, bad in lmce_fwd_controls(torch, lk, slices, h, w,
                                           labels).items():
            ctl[name] = lmce_fwd_gate(torch, bad, ref, h, w, labels)
        line += "; controls (fail, as they must): " + "; ".join(
            f"{n} ratio {r:.3e}" for n, r in ctl.items())
    print(line, flush=True)
    for name, r in ctl.items():
        check(r > 1.0, f"[lmce tc fwd] {tag}: the gate passes the {name} "
              f"control (ratio {r:.3e})")
    check(ratio <= 1.0, f"[lmce tc fwd] {tag}: gate ratio {ratio:.3e} > 1")
    check(same, f"[lmce tc fwd] {tag}: two runs differ")
    if n_ignored:
        check(bool((got[0][ignored] == 0).all()),
              f"[lmce tc fwd] {tag}: ignored rows not exactly 0")
    return errs, ratio


def lmce_tc_fwd_phase(torch, seed, nvcc_log):
    """``[lmce tc fwd]``: the tensor-core forward (``csrc/lmce_fwd_sm90.cu``)
    against its plain version at the main shape and the ragged shapes, in
    bf16 and fp16, with the controls; the SASS's ``HGMMA`` count; times
    at the main shape (device time and events) beside the CUDA-core
    forward it replaced for 16-bit operands, the bound and the library
    call."""
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import lmce_kernel as lk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 80)

    def inputs(N, V, D, dtype, ignore=False):
        h = torch.randn((N, D), generator=gen, device=dev)
        w = torch.randn((V, D), generator=gen, device=dev) * 0.05
        labels = torch.randint(0, V, (N,), generator=gen, device=dev)
        if ignore:
            labels[::4] = -100
        return h.to(dtype), w.to(dtype), labels

    hgmma, regs, spills = sass_summary(_build.library_path("lmce_fwd_sm90"),
                                       nvcc_log)
    print(f"[lmce tc fwd] {LMCE_FWD_TC_SOURCE}: {hgmma} HGMMA instructions "
          f"in the SASS; ptxas registers per kernel {regs}, spill store "
          f"bytes {spills}", flush=True)
    check(hgmma > 0, "[lmce tc fwd] no HGMMA instruction in the SASS")
    check(not any(spills), f"[lmce tc fwd] ptxas spills {spills}")
    res = {"hgmma": hgmma, "registers": regs, "spill_bytes": spills}
    N, V, D = TRAIN_B * TRAIN_S, LMCE_V, LMCE_D
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    ce = torch.nn.functional.cross_entropy
    for dtype in (torch.bfloat16, torch.float16):
        dn = "bf16" if dtype == torch.bfloat16 else "fp16"
        h, w, labels = inputs(N, V, D, dtype)
        errs, ratio = lmce_tc_fwd_compare(torch, lk, f"{dn} N={N} V={V} "
                                          f"D={D}", h, w, labels)
        err_main = max(errs.values())
        for tag, n, v, d, ignore in LMCE_FWD_RAGGED:
            e, r = lmce_tc_fwd_compare(torch, lk, f"{dn} {tag}",
                                       *inputs(n, v, d, dtype, ignore),
                                       controls=d == 200)
            errs = {k: max(x, e[k]) for k, x in errs.items()}
            ratio = max(ratio, r)
        with torch.no_grad():
            dev_ms = device_ms(torch, lambda: lk.lmce_fwd(h, w, labels), 10, {
                "sweep": ("lmce_fwd_tc_kernel",),
                "combine": ("lmce_fwd_combine",), "all": ()})
            core_dev = device_ms(torch, lambda: lk._cuda_core_fwd(
                h, w, labels), 3, {"all": ()})["all"]
            ms = time_cuda(torch, lambda: lk.lmce_fwd(h, w, labels), 10,
                           warmup=2, flush=flush)
            core_ms = time_cuda(torch, lambda: lk._cuda_core_fwd(
                h, w, labels), 3, warmup=1, flush=flush)
            plain_ms = time_cuda(torch, lambda: lk.lmce_reference(
                h, w, labels), 3, warmup=1, flush=flush)
            lib_ms = time_cuda(torch, lambda: ce(
                torch.matmul(h, w.t()).float(), labels, reduction="none"),
                10, warmup=2, flush=flush)
            lib_dev = device_ms(torch, lambda: ce(
                torch.matmul(h, w.t()).float(), labels, reduction="none"),
                10, {"all": ()})["all"]
        flops, nbytes = lk.kernel_work("lmce_fwd", N, V, D, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        r = {"ms": ms, "device_ms": dev_ms["all"],
             "sweep_device_ms": dev_ms["sweep"],
             "combine_device_ms": dev_ms["combine"],
             "cuda_core_ms": core_ms, "cuda_core_device_ms": core_dev,
             "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": lib_ms, "library_device_ms": lib_dev,
             "flops": flops, "bytes": nbytes,
             "tflops": flops / (ms * 1e-3) / 1e12,
             "device_tflops": flops / (dev_ms["all"] * 1e-3) / 1e12,
             "max_abs_err": err_main, "ragged_max_abs_err":
                 max(errs.values()), "gate_ratio": ratio}
        res[dn] = r
        print(f"[lmce tc fwd] lmce_fwd_tc {dn} N={N} V={V} D={D}: device_ms="
              f"{r['device_ms']:.5f} (sweep {r['sweep_device_ms']:.5f}, "
              f"combine {r['combine_device_ms']:.5f}; "
              f"{r['device_tflops']:.1f} TFLOP/s) kernel_ms={ms:.5f} "
              f"cuda_core_ms={core_ms:.5f} (device {core_dev:.5f}; "
              f"{core_dev / r['device_ms']:.2f}x) plain_ms={plain_ms:.5f} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}: {flops} "
              f"flop, {nbytes} bytes); library yardstick (not used by the "
              f"port): matmul + fp32 cross_entropy {lib_ms:.5f} ms "
              f"(device {lib_dev:.5f})", flush=True)
        del h, w, labels
    return res


# ---------------------------------------------------------------------------
# fp16 and head dims 16 / 32 on the card
# ---------------------------------------------------------------------------
FP16_TOL = 1e-2                  # x max(|ref|, 1); fp16 inputs and outputs
                                 # (11 bits), at most the bf16 gate
DTYPE_TOLS = {"fp32": FLASH_FP32_TOL, "bf16": FLASH_BF16_TOL,
              "fp16": FP16_TOL}


def hold(torch, phase, tag, tol, pairs):
    """Each ``(name, got, ref)``: finite and within ``tol`` x max(|ref|,
    1) of the plain version; prints and returns the max abs errors."""
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in pairs:
        check(bool(torch.isfinite(got.float()).all()),
              f"[{phase}] {tag}: {name} not finite")
        err, rel = _err(got, ref)
        check(rel <= tol, f"[{phase}] {tag}: {name} error {err:.3e} "
                          f"(relative {rel:.3e}) > {tol}")
        errs[name] = err
    print(f"[{phase}] {tag}: max_abs_err " + " ".join(
        f"{n}={e:.3e}" for n, e in errs.items()) + f" (tol {tol} x "
          "max(|ref|, 1))", flush=True)
    return errs


def flash_hold(torch, fk, phase, tag, tol, q, k, v, g, causal, hps=(2,)):
    """Every flash kernel on these inputs against its plain version on
    the same values: the routed forward and the CUDA-core forward
    (p rounded to the input dtype, ``flash_fwd_tc_reference``), the
    routed and the CUDA-core split backward (dS and p rounded as the
    plain versions round them), the fused backward, and the head-packed
    forward for each
    ``hp`` in the ``[B*H, S, D]`` layout (its routed body and its
    CUDA-core body).  Returns the max abs error per kernel."""
    B, S, H, D = q.shape
    out, lse = fk.flash_fwd(q, k, v, causal)
    ref = fk.flash_fwd_tc_reference(q, k, v, causal)
    core = fk._cuda_core_fwd(q, k, v, causal)
    e = hold(torch, phase, f"{tag} flash_fwd (tensor-core: "
             f"{fk._is_tc(q)}) and the CUDA-core forward", tol,
             [("out", out, ref[0]), ("lse", lse, ref[1]),
              ("core out", core[0], ref[0]), ("core lse", core[1], ref[1])])
    errs = {"flash_fwd": max(e["out"], e["lse"]),
            "flash_fwd cuda_core": max(e["core out"], e["core lse"])}
    dq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, causal)
    dk, dv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
    cdq, cdelta = fk._cuda_core_flash_bwd("dq", q, k, v, out, lse, g, causal)
    cdk, cdv = fk._cuda_core_flash_bwd("dkv", q, k, v, g, lse, delta, causal)
    rdq, rdelta = fk.flash_bwd_dq_reference(q, k, v, out, lse, g, causal)
    rdk, rdv = fk.flash_bwd_dkv_reference(q, k, v, g, lse, delta, causal)
    e = hold(torch, phase, f"{tag} flash_bwd_dq + flash_bwd_dkv "
             f"(tensor-core: {fk._is_tc(q)}) and the CUDA-core pair", tol,
             [("dq", dq, rdq), ("delta", delta, rdelta), ("dk", dk, rdk),
              ("dv", dv, rdv), ("core dq", cdq, rdq),
              ("core delta", cdelta, rdelta), ("core dk", cdk, rdk),
              ("core dv", cdv, rdv)])
    errs["flash_bwd_dq"] = max(e["dq"], e["delta"])
    errs["flash_bwd_dkv"] = max(e["dk"], e["dv"])
    errs["flash_bwd_dq cuda_core"] = max(e["core dq"], e["core delta"])
    errs["flash_bwd_dkv cuda_core"] = max(e["core dk"], e["core dv"])
    got = fk.flash_bwd_fused(q, k, v, out, lse, g, causal)
    core = fk._cuda_core_flash_bwd("fused", q, k, v, out, lse, g, causal)
    rf = fk.flash_bwd_fused_reference(q, k, v, out, lse, g, causal)
    e = hold(torch, phase, f"{tag} flash_bwd_fused (tensor-core: "
             f"{fk._is_tc(q)}) and the CUDA-core sweep", tol,
             list(zip(("dq", "dk", "dv"), got, rf))
             + list(zip(("core dq", "core dk", "core dv"), core, rf)))
    errs["flash_bwd_fused"] = max(e["dq"], e["dk"], e["dv"])
    errs["flash_bwd_fused cuda_core"] = max(e["core dq"], e["core dk"],
                                            e["core dv"])

    def bh(t):
        return t.permute(0, 2, 1, 3).reshape(B * H, S, 1, D).contiguous()
    qb, kb, vb = bh(q), bh(k), bh(v)
    rb = fk.flash_fwd_tc_reference(qb, kb, vb, causal)
    errs["flash_fwd_hpack"] = errs["flash_fwd_hpack cuda_core"] = 0.0
    for hp in hps:
        o, l = fk.flash_fwd_hpack(qb, kb, vb, hp, causal)
        co, cl = fk._cuda_core_fwd(qb, kb, vb, causal, hp=hp)
        e = hold(torch, phase, f"{tag} flash_fwd_hpack hp={hp} "
                 f"(tensor-core: {fk._is_tc(qb, (64,))}) and its CUDA-core "
                 "body", tol, [("out", o, rb[0]), ("lse", l, rb[1]),
                               ("core out", co, rb[0]),
                               ("core lse", cl, rb[1])])
        errs["flash_fwd_hpack"] = max(errs["flash_fwd_hpack"], e["out"],
                                      e["lse"])
        errs["flash_fwd_hpack cuda_core"] = max(
            errs["flash_fwd_hpack cuda_core"], e["core out"], e["core lse"])
    return errs


def paged_hold(torch, pak, phase, tag, tol, dtype, Dh, seed):
    """The paged kernel against its plain version (fp32 on the same
    values) at decode shapes with ragged lengths, scattered pages and an
    empty row (exactly 0)."""
    B, H, BS, NB, MAXNB = 8, 12, 16, 512, 64
    lengths_l = [0, 1, 16, 17, 500, 1024, 333, 64]
    rng = np.random.default_rng(seed)
    table = np.zeros((B, MAXNB), dtype=np.int32)
    free = rng.permutation(np.arange(1, NB)).tolist()
    for b, n in enumerate(lengths_l):
        table[b, :-(-n // BS)] = [free.pop() for _ in range(-(-n // BS))]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pk, pv = [torch.randn((NB, BS, H, Dh), generator=gen, device=dev)
              .to(dtype) for _ in range(2)]
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(dtype)
    table_t = torch.as_tensor(table, device=dev)
    lengths = torch.as_tensor(np.array(lengths_l, np.int32), device=dev)
    before = pak.paged_ragged_attention.launches
    out = pak.paged_ragged_attention(pk, pv, table_t, lengths, q)
    ref = pak.paged_ragged_attention_reference(pk.float(), pv.float(),
                                               table_t, lengths, q.float())
    check(pak.paged_ragged_attention.launches == before + 1,
          f"[{phase}] {tag}: the paged kernel did not launch")
    check(out.dtype == dtype and bool((out[0] == 0).all()),
          f"[{phase}] {tag}: dtype {out.dtype} or the empty row not 0")
    return hold(torch, phase, f"{tag} paged_ragged_attention B={B} H={H} "
                f"Dh={Dh} lengths={lengths_l}", tol, [("out", out, ref)])


def fp16_phase(torch, seed):
    """``[fp16]``: every kernel against its plain version in fp16 (fault
    C1): K1, the flash forwards (tensor-core and CUDA-core), dq/dkv, the
    fused backward and the head-packed forward at ``[train fp16]``'s
    shapes, and the three LMCE kernels (the backward's tensor-core and
    CUDA-core bodies, held by :func:`lmce_grad_gate`)."""
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    from paddle_tpu_torch.ops import lmce_kernel as lk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 40)
    f16 = torch.float16
    res = {"paged_ragged_attention": paged_hold(
        torch, pak, "fp16", "fp16", FP16_TOL, f16, 64, seed)["out"]}
    B, S, H, D = TRAIN_B, TRAIN_S, 12, 64     # [train fp16]'s shapes
    qkv = torch.randn((B, S, 3, H, D), generator=gen, device=dev).to(f16)
    g = torch.randn((B, S, H, D), generator=gen, device=dev).to(f16)
    res.update(flash_hold(torch, fk, "fp16", f"fp16 [B,S,H,D] views B={B} "
                          f"S={S} H={H} D={D} causal", FP16_TOL,
                          qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], g, True))
    N, V = 1024, LMCE_V
    h = torch.randn((N, LMCE_D), generator=gen, device=dev).to(f16)
    w = (torch.randn((V, LMCE_D), generator=gen, device=dev) * 0.05).to(f16)
    labels = torch.randint(0, V, (N,), generator=gen, device=dev)
    labels[::4] = -100
    gg = torch.rand((N,), generator=gen, device=dev)
    loss, lse = lk.lmce_fwd(h, w, labels)
    closs, clse = lk._cuda_core_fwd(h, w, labels)
    rloss, rlse = lk.lmce_reference(h, w, labels)
    got = [lk.lmce_bwd_dh(h, w, labels, lse, gg),
           lk.lmce_bwd_dw(h, w, labels, lse, gg),
           lk._cuda_core_bwd("dh", h, w, labels, lse, gg),
           lk._cuda_core_bwd("dw", h, w, labels, lse, gg)]
    tag = f"fp16 lmce N={N} V={V} D={LMCE_D}, every 4th label -100"
    e = hold(torch, "fp16", f"{tag}: lmce_fwd (tensor-core) and the "
             "CUDA-core forward", FP16_TOL,
             [("loss", loss, rloss), ("lse", lse, rlse),
              ("core loss", closs, rloss), ("core lse", clse, rlse)])
    fwd_ratio = lmce_fwd_gate(torch, (loss, lse), (rloss, rlse), h, w, labels)
    check(fwd_ratio <= 1.0, f"[fp16] {tag}: lmce_fwd gate ratio "
          f"{fwd_ratio:.3e} > 1")
    refs = {"dh": lk.lmce_bwd_dh_reference(h, w, labels, lse, gg),
            "dw": lk.lmce_bwd_dw_reference(h, w, labels, lse, gg)}
    torch.cuda.synchronize()
    ratios = {}
    for name, t in zip(("dh_tc", "dw_tc", "dh", "dw"), got):
        e[name], ratios[name] = lmce_grad_gate(
            torch, lk, name[:2], t, refs[name[:2]], h, w, labels, lse, gg)
        check(bool(torch.isfinite(t.float()).all()) and ratios[name] <= 1.0,
              f"[fp16] {tag}: {name} error {e[name]:.3e}, gate ratio "
              f"{ratios[name]:.3e} > 1 (or not finite)")
    print(f"[fp16] {tag}: the tensor-core and the CUDA-core backward: "
          "max_abs_err " + " ".join(f"{n}={e[n]:.3e}" for n in ratios)
          + "; gate ratio " + " ".join(f"{n}={r:.3e}" for n, r in
                                       ratios.items())
          + f" (per element |err| <= {LMCE_GRAD_RTOL['float16']} |ref| + "
          "(u |dL| + eta) @ |B|, passes <= 1)", flush=True)
    check(all(t.dtype == f16 for t in got), "[fp16] lmce gradient dtypes")
    check(bool((got[0][labels < 0] == 0).all()),
          "[fp16] lmce ignored rows of dh not exactly 0")
    res.update({"lmce_fwd": max(e["loss"], e["lse"]),
                "lmce_fwd cuda_core": max(e["core loss"], e["core lse"]),
                "lmce_bwd_dh_tc": e["dh_tc"], "lmce_bwd_dw_tc": e["dw_tc"],
                "lmce_bwd_dh": e["dh"], "lmce_bwd_dw": e["dw"]})
    return res


def headdim_phase(torch, seed):
    """``[headdim]``: the flash kernels (forward, split and fused
    backward, head-packed forward at hp 2 and 4) at head dims 16 and 32
    in fp32, bf16 and fp16, and the paged kernel at Dh = 16 (gpt_tiny's
    head dim; half a warp per row), each against its plain version
    (fault C2).  Below 64 every forward is the CUDA-core kernel."""
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 50)
    res = {}
    for D in (16, 32):
        for dn, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                          ("fp16", torch.float16)):
            args = [torch.randn((2, 300, 4, D), generator=gen,
                                device=dev).to(dtype) for _ in range(4)]
            before = sum(f.tc_launches for f in fk.TC_WRAPPERS)
            for causal in (True, False):
                res[f"D={D} {dn} {'causal' if causal else 'non-causal'}"] = \
                    flash_hold(torch, fk, "headdim", f"{dn} D={D} "
                               f"[2, 300, 4, {D}] "
                               f"{'causal' if causal else 'non-causal'}",
                               DTYPE_TOLS[dn], *args, causal, hps=(2, 4))
            check(sum(f.tc_launches for f in fk.TC_WRAPPERS) == before,
                  f"[headdim] D={D} {dn} launched a tensor-core kernel")
    for dn, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                      ("fp16", torch.float16)):
        res[f"paged Dh=16 {dn}"] = paged_hold(
            torch, pak, "headdim", dn, DTYPE_TOLS[dn] if dn != "fp32" else
            FP32_TOL, dtype, 16, seed)["out"]
    return res


# ---------------------------------------------------------------------------
# training: GPT-2-small through Model.fit
# ---------------------------------------------------------------------------
def _train_model(torch, cfg, device, seed, o2, bert=False,
                 amp_dtype="bfloat16", lr=1e-4):
    """GPT (or, with ``bert``, BertForPretraining) from ``seed`` and its
    AdamW(``lr``, multi_precision), cast to ``amp_dtype`` O2 if ``o2``
    (``amp_dtype`` None: ``amp.decorate``'s default, float16)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import BertForPretraining, GPTForCausalLM
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    net = (BertForPretraining if bert else GPTForCausalLM)(
        cfg, device=device, generator=gen)
    opt = paddle.optimizer.AdamW(learning_rate=lr,
                                 parameters=net.parameters(),
                                 multi_precision=True)
    if o2 and amp_dtype is None:
        paddle.amp.decorate(net, opt, level="O2")
    elif o2:
        paddle.amp.decorate(net, opt, level="O2", dtype=amp_dtype)
    return net, opt


def _mlm_batch(torch, vocab, b, s, seed):
    """Tokens and MLM labels: the token on 15% of positions, -100
    elsewhere (bench.py's ERNIE batch), from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (b, s)).astype(np.int64)
    labels = np.where(rng.random((b, s)) < 0.15, x, -100).astype(np.int64)
    return torch.from_numpy(x), torch.from_numpy(labels)


def fit_and_check(torch, tag, desc, model, net, batch, want, tokens,
                  low=None, fold=None):
    """``Model.fit`` for TRAIN_STEPS steps on one repeated batch, every
    launch count set to 0 just before and read just after; checks
    finite, falling losses, the launch counts against ``want`` (every
    flash and lmce kernel and the fused backward's helpers; under the
    fold engine counted per replay), no plain call and the O2 dtypes
    (``low``: the 16-bit one, bf16 by default); prints step ms,
    tokens/s, peak memory and a profile of two more steps.  ``fold`` is
    ``steps_per_dispatch``: None resolves to 1 (the per-step clock is a
    batch hook), so the fit warms up one eager step, captures the step
    and replays it; 0 is the eager route.  Frees the model's graphs at
    the end and prints the memory still reserved."""
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    from paddle_tpu_torch.ops import lmce_kernel as lk

    clock = _step_clock(torch)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_counts()
    lk.reset_counts()
    model.fit([batch] * TRAIN_STEPS, epochs=1, num_iters=TRAIN_STEPS,
              verbose=0, callbacks=[clock], steps_per_dispatch=fold)
    launches = launch_table(fk, lk)
    plain = {f.__name__: f.plain_calls for f in fk.ALL_WRAPPERS + lk.WRAPPERS}
    peak = torch.cuda.max_memory_allocated()
    losses = clock.losses
    check(len(losses) == TRAIN_STEPS, f"[{tag}] {len(losses)} steps")
    check(all(np.isfinite(losses)), f"[{tag}] loss not finite: {losses}")
    check(losses[-1] < losses[0], f"[{tag}] loss did not fall: {losses}")
    check(launches == want, f"[{tag}] launches {launches}, expected {want}")
    check(not any(plain.values()), f"[{tag}] plain calls {plain}")
    graphs = model.compile_stats()
    want_graphs = ({"graphs": 0, "captures": 0} if fold == 0 else
                   {"graphs": 1, "captures": 1})
    check(graphs == want_graphs, f"[{tag}] graphs {graphs}, expected "
          f"{want_graphs}")
    check(model._fold == (1 if fold is None else fold),
          f"[{tag}] steps_per_dispatch resolved to {model._fold}")
    dtypes = {p.dtype for p in net.parameters()}
    check(dtypes == {low or torch.bfloat16, torch.float32},
          f"[{tag}] O2 parameter dtypes {dtypes}")
    steps_ms = np.diff(clock.stamps) * 1e3
    step_ms = float(np.median(steps_ms[2:]))
    tok_s = tokens / (step_ms * 1e-3)
    print(f"[{tag}] {desc}: {TRAIN_STEPS} steps "
          f"(steps_per_dispatch={model._fold}, {graphs}), losses "
          f"{[round(v, 6) for v in losses]}; step_ms first="
          f"{steps_ms[0]:.3f} median(steps 3+)={step_ms:.3f} -> "
          f"{tok_s:.1f} tokens/s; peak_mem_gib="
          f"{peak / 2**30:.3f} (resident before fit "
          f"{resident / 2**30:.3f}); launches {launches}; plain calls "
          f"{plain}", flush=True)
    prof = profile_steps(torch, model, batch, 2, tag, folded=fold != 0)
    free_model(torch, tag, model)
    return {"launches": launches, "losses": losses, "peak": peak,
            "step_ms": step_ms, "tokens_per_s": tok_s, "profile": prof}


def launch_table(fk, lk):
    """Every launch count of the training path's kernels, by name."""
    launches = {f.__name__: f.launches for f in fk.ALL_WRAPPERS + lk.WRAPPERS}
    launches.update({f"{f.__name__}.tc": f.tc_launches
                     for f in fk.TC_WRAPPERS + lk.TC_WRAPPERS})
    launches["_cuda_core_fwd"] = fk._cuda_core_fwd.launches
    launches["_cuda_core_flash_bwd"] = fk._cuda_core_flash_bwd.launches
    launches["_cuda_core_bwd"] = lk._cuda_core_bwd.launches
    launches["_cuda_core_lmce_fwd"] = lk._cuda_core_fwd.launches
    launches.update(fk.flash_bwd_fused.helper_launches)
    return launches


def free_model(torch, tag, model):
    """Free ``model``'s CUDA graphs and their pool, and print the memory
    the card still holds reserved, so that a pool left behind by one
    phase shows before it runs a later one out of memory."""
    import gc
    model.release_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] after freeing the model's graphs: reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB, allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)


def _want_launches(layer_calls, bh=False, fused_lmce_steps=0):
    """Expected launch counts: the default path's three flash kernels,
    or under the [B*H, S, D] knobs the head-packed forward, the fused
    backward and its helpers (bf16: the dq epilogue runs too),
    ``layer_calls`` times each; every 16-bit forward, split and fused
    backward launch the tensor-core body's (``.tc``), none the CUDA-core
    comparison entries'; each 16-bit lmce launch (forward, dh, dW) the
    tensor-core body's, none the CUDA-core forward's or backward's."""
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    from paddle_tpu_torch.ops import lmce_kernel as lk
    want = {f.__name__: 0 if bh else layer_calls for f in fk.WRAPPERS}
    want.update({f.__name__: layer_calls if bh else 0
                 for f in fk.BH_WRAPPERS})
    want.update({f"{f.__name__}.tc": want[f.__name__]
                 for f in fk.TC_WRAPPERS})
    want["_cuda_core_fwd"] = 0
    want["_cuda_core_flash_bwd"] = 0
    want["flash_bwd_fused_prep"] = layer_calls if bh else 0
    want["flash_bwd_fused_dq_cast"] = layer_calls if bh else 0
    want.update({f.__name__: fused_lmce_steps for f in lk.WRAPPERS})
    want.update({f"{f.__name__}.tc": fused_lmce_steps
                 for f in lk.TC_WRAPPERS})
    want["_cuda_core_bwd"] = 0
    want["_cuda_core_lmce_fwd"] = 0
    return want


def train_phase(torch, seed, fused=False, bh=False, fp16=False,
                eager=False):
    """``[train]``, with ``fused`` the same run with ``enable_fused_lmce``
    (``[train fused lmce]``), with ``bh`` under the [B*H, S, D] knobs
    (``[train bh]``), with ``fp16`` after ``amp.decorate(level="O2")``
    with its default dtype, float16 (``[train fp16]``), with ``eager``
    through the eager route, ``steps_per_dispatch=0`` (``[train
    eager]``)."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import (GPTPretrainingCriterion,
                                         enable_fused_lmce, gpt2_small)
    tag = ("train fused lmce" if fused else "train bh" if bh else
           "train fp16" if fp16 else "train eager" if eager else "train")
    gc.collect()                # the previous phase's model, if any
    cfg = gpt2_small(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    net, opt = _train_model(torch, cfg, "cuda", seed, o2=True,
                            amp_dtype=None if fp16 else "bfloat16")
    crit = GPTPretrainingCriterion()
    if fused:
        enable_fused_lmce(net, crit)
    model = paddle.Model(net, device="cuda")
    model.prepare(opt, crit)
    rng = np.random.default_rng(seed + 2)
    x = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(np.int64)
    batch = (torch.from_numpy(x).pin_memory(),
             torch.from_numpy(np.roll(x, -1, axis=1)).pin_memory())
    L = cfg.num_hidden_layers
    want = _want_launches(TRAIN_STEPS * L, bh=bh,
                          fused_lmce_steps=TRAIN_STEPS if fused else 0)
    with knobs_set(BH_KNOBS if bh else {}):
        return fit_and_check(
            torch, tag, f"GPT-2-small L=12 D=768 H=12 V=50304 B={TRAIN_B} "
            f"S={TRAIN_S} {'fp16 (the default)' if fp16 else 'bf16'} O2 "
            "AdamW", model, net, batch, want, TRAIN_B * TRAIN_S,
            low=torch.float16 if fp16 else torch.bfloat16,
            fold=0 if eager else None)


def bh_train_phase(torch, seed, base):
    """``[train bh]``: the ``[train]`` run under the [B*H, S, D] knobs,
    first loss within BH_FIRST_LOSS_TOL relative of ``base``'s (same
    weights and batch)."""
    res = train_phase(torch, seed, bh=True)
    first, base_first = res["losses"][0], base["losses"][0]
    rel = abs(first - base_first) / abs(base_first)
    check(rel <= BH_FIRST_LOSS_TOL,
          f"[train bh] first loss {first} vs [train] {base_first} "
          f"(relative {rel:.3e} > {BH_FIRST_LOSS_TOL})")
    print("[train bh] step losses bh vs default: " + ", ".join(
        f"{a:.6f}/{b:.6f}" for a, b in zip(res["losses"], base["losses"]))
        + f"; first-loss relative diff {rel:.3e} (tol {BH_FIRST_LOSS_TOL}); "
        f"step_ms {res['step_ms']:.3f} vs {base['step_ms']:.3f}; "
        f"peak_mem_gib {res['peak'] / 2**30:.3f} vs "
        f"{base['peak'] / 2**30:.3f}", flush=True)
    return res


def ernie_train_phase(torch, seed):
    """``[train ernie bh]``: ERNIE-3.0-base MLM pretraining at B=16,
    S=512, bf16 O2, AdamW, under the [B*H, S, D] knobs.  The first
    loss is held against the default path's loss on the same weights
    and batch, taken before the fit by a step that updates nothing."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import BertPretrainingCriterion, ernie_3_base
    tag = "train ernie bh"
    gc.collect()
    cfg = ernie_3_base(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    net, opt = _train_model(torch, cfg, "cuda", seed, o2=True, bert=True)
    model = paddle.Model(net, device="cuda")
    model.prepare(opt, BertPretrainingCriterion(cfg.vocab_size))
    x, labels = _mlm_batch(torch, cfg.vocab_size, ERNIE_B, ERNIE_S, seed + 4)
    batch = (x.pin_memory(), labels.pin_memory())
    base_first = float(model.train_batch([batch[0]], [batch[1]],
                                         update=False)[0][0])
    want = _want_launches(TRAIN_STEPS * cfg.num_hidden_layers, bh=True)
    with knobs_set(BH_KNOBS):
        res = fit_and_check(
            torch, tag, f"ERNIE-3.0-base L=12 D=768 H=12 V=40000 "
            f"B={ERNIE_B} S={ERNIE_S} bf16 O2 AdamW, MLM 15%", model, net,
            batch, want, ERNIE_B * ERNIE_S)
    rel = abs(res["losses"][0] - base_first) / abs(base_first)
    check(rel <= BH_FIRST_LOSS_TOL,
          f"[{tag}] first loss {res['losses'][0]} vs default path "
          f"{base_first} (relative {rel:.3e} > {BH_FIRST_LOSS_TOL})")
    print(f"[{tag}] first loss {res['losses'][0]:.6f} vs the default "
          f"path's {base_first:.6f} on the same weights and batch: relative "
          f"diff {rel:.3e} (tol {BH_FIRST_LOSS_TOL})", flush=True)
    return res


def fp16_train_phase(torch, seed, base):
    """``[train fp16]``: the ``[train]`` run after ``amp.decorate(level=
    "O2")`` with its default dtype, float16, and no GradScaler (as the
    JAX reference trains): finite losses, each flash kernel 12 times a
    step with the tensor-core forward, no plain call, the first loss
    within 1e-2 relative of ``base``'s (bf16, same weights and batch)."""
    res = train_phase(torch, seed, fp16=True)
    first, base_first = res["losses"][0], base["losses"][0]
    rel = abs(first - base_first) / abs(base_first)
    check(rel <= FP16_FIRST_LOSS_TOL,
          f"[train fp16] first loss {first} vs [train] {base_first} "
          f"(relative {rel:.3e} > {FP16_FIRST_LOSS_TOL})")
    print("[train fp16] step losses fp16 vs bf16: " + ", ".join(
        f"{a:.6f}/{b:.6f}" for a, b in zip(res["losses"], base["losses"]))
        + f"; first-loss relative diff {rel:.3e} (tol "
        f"{FP16_FIRST_LOSS_TOL}); step_ms {res['step_ms']:.3f} vs "
        f"{base['step_ms']:.3f}; peak_mem_gib {res['peak'] / 2**30:.3f} "
        f"vs {base['peak'] / 2**30:.3f}", flush=True)
    return res


def fused_train_phase(torch, seed, base):
    """``[train fused lmce]``: the ``[train]`` run with the fused lm-head
    cross-entropy, held against ``base`` (``train_phase``'s result):
    first loss within 1e-2 relative (same weights and batch; the
    unfused path rounds the logits to bf16) and a lower peak."""
    res = train_phase(torch, seed, fused=True)
    first, base_first = res["losses"][0], base["losses"][0]
    rel = abs(first - base_first) / abs(base_first)
    check(rel <= FUSED_FIRST_LOSS_TOL,
          f"[train fused lmce] first loss {first} vs [train] {base_first}"
          f" (relative {rel:.3e} > {FUSED_FIRST_LOSS_TOL})")
    check(res["peak"] < base["peak"],
          f"[train fused lmce] peak {res['peak']} bytes not below "
          f"[train]'s {base['peak']}")
    print("[train fused lmce] step losses fused vs unfused: " + ", ".join(
        f"{a:.6f}/{b:.6f}" for a, b in zip(res["losses"], base["losses"]))
        + f"; first-loss relative diff {rel:.3e} (tol "
        f"{FUSED_FIRST_LOSS_TOL}); step_ms {res['step_ms']:.3f} vs "
        f"{base['step_ms']:.3f}; peak_mem_gib {res['peak'] / 2**30:.3f} "
        f"vs {base['peak'] / 2**30:.3f}", flush=True)
    return res


def train_eager_phase(torch, seed, base):
    """``[train eager]``: the ``[train]`` run through the eager route
    (``steps_per_dispatch=0``, one ``train_batch`` a step), the same
    call's comparison for step ms, tokens/s, peak memory and idle share;
    every loss within FOLD_EAGER_LOSS_TOL relative of ``base``'s (same
    weights and batch, the same kernels)."""
    res = train_phase(torch, seed, eager=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                  base["losses"]))
    check(rel <= FOLD_EAGER_LOSS_TOL,
          f"[train eager] losses {res['losses']} vs [train] "
          f"{base['losses']} (relative {rel:.3e})")
    idle = {k: r["profile"]["idle"] for k, r in
            (("eager", res), ("replayed", base))}
    print(f"[train eager] vs [train] (K=1 replays): step_ms "
          f"{res['step_ms']:.3f} vs {base['step_ms']:.3f}; tokens/s "
          f"{res['tokens_per_s']:.1f} vs {base['tokens_per_s']:.1f}; "
          f"peak_mem_gib {res['peak'] / 2**30:.3f} vs "
          f"{base['peak'] / 2**30:.3f}; profiled idle share {idle}; "
          f"losses max relative diff {rel:.3e}"
          + (" (bit-identical)" if rel == 0 else ""), flush=True)
    return res


def pool_reserved(torch, pool):
    """Bytes of the segments the caching allocator holds for the graph
    pool ``pool`` (``torch.cuda.memory_snapshot()``), or None where the
    snapshot does not name pools."""
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def train_fold_phase(torch, seed, bh=False):
    """``[train fold]`` (``[train fold bh]`` under the [B*H, S, D]
    knobs): GPT-2-small as ``[train]`` with no per-step hook.  A fit of
    two steps at ``steps_per_dispatch=2`` warms up and captures; then a
    fit of FOLD_STEPS steps at K=FOLD_K and one under auto-K, each
    synchronised only at its start and end.  Checks one graph, launch
    counts by replay, a finite last loss; prints the capture time, the
    graph pool's reserved memory, step ms and tokens/s of both timed
    fits, the tuner's decision, peak memory and a profile of one group
    of FOLD_K replays."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt2_small
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    from paddle_tpu_torch.ops import lmce_kernel as lk

    class LastLoss(Callback):
        """Keeps the epoch's last loss (no per-step hook)."""

        def on_epoch_end(self, epoch, logs=None):
            self.loss = float(logs["loss"][0])

    tag = "train fold bh" if bh else "train fold"
    gc.collect()
    cfg = gpt2_small(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    net, opt = _train_model(torch, cfg, "cuda", seed, o2=True)
    model = paddle.Model(net, device="cuda")
    model.prepare(opt, GPTPretrainingCriterion())
    rng = np.random.default_rng(seed + 2)
    x = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(np.int64)
    batch = (torch.from_numpy(x).pin_memory(),
             torch.from_numpy(np.roll(x, -1, axis=1)).pin_memory())
    tokens = TRAIN_B * TRAIN_S
    L = cfg.num_hidden_layers
    last = LastLoss()
    with knobs_set(BH_KNOBS if bh else {}):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        model.fit([batch] * 2, epochs=1, verbose=0, steps_per_dispatch=2)
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
        runner = next(iter(model._graphs.values()))
        pool = pool_reserved(torch, model._graph_pool)
        fk.reset_counts()
        lk.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        model.fit([batch] * FOLD_STEPS, epochs=1, verbose=0,
                  callbacks=[last], steps_per_dispatch=FOLD_K)
        torch.cuda.synchronize()
        k_ms = (time.monotonic() - t0) * 1e3 / FOLD_STEPS
        launches = launch_table(fk, lk)
        peak = torch.cuda.max_memory_allocated()
        want = _want_launches(FOLD_STEPS * L, bh=bh)
        check(launches == want,
              f"[{tag}] launches {launches}, expected {want}")
        check(np.isfinite(last.loss), f"[{tag}] last loss {last.loss}")
        k_loss = last.loss
        torch.cuda.synchronize()
        t0 = time.monotonic()
        model.fit([batch] * FOLD_STEPS, epochs=1, verbose=0,
                  callbacks=[last])
        torch.cuda.synchronize()
        auto_ms = (time.monotonic() - t0) * 1e3 / FOLD_STEPS
        tuner = model._fold_tuner
        check(tuner is not None and tuner.decided,
              f"[{tag}] the auto-K fit decided no K")
        check(np.isfinite(last.loss) and last.loss < k_loss,
              f"[{tag}] last loss {last.loss} after {k_loss}")
        graphs = model.compile_stats()
        check(graphs == {"graphs": 1, "captures": 1}, f"[{tag}] {graphs}")
        prof = profile_steps(torch, model, batch, FOLD_K, tag)
    print(f"[{tag}] GPT-2-small B={TRAIN_B} S={TRAIN_S} bf16 O2 AdamW, no "
          f"per-step hook: first fit (1 eager warm-up step, capture, 1 "
          f"replay) {first_s:.3f} s, capture {runner.capture_s:.3f} s; "
          f"graphs {graphs}; graph pool reserved "
          + (f"{pool / 2**30:.3f} GiB" if pool is not None else
             "not measured")
          + f"; K={FOLD_K} over {FOLD_STEPS} steps: step_ms {k_ms:.3f} -> "
          f"{tokens / (k_ms * 1e-3):.1f} tokens/s, peak_mem_gib "
          f"{peak / 2**30:.3f}, last loss {k_loss:.6f}; auto-K over "
          f"{FOLD_STEPS} steps: step_ms {auto_ms:.3f} -> "
          f"{tokens / (auto_ms * 1e-3):.1f} tokens/s, decision "
          f"{tuner.decision}; launches {launches}", flush=True)
    free_model(torch, tag, model)
    return {"k_ms": k_ms, "auto_ms": auto_ms, "decision": tuner.decision,
            "capture_s": runner.capture_s, "pool": pool, "peak": peak,
            "profile": prof, "launches": launches}


def _fold_batches(torch, vocab, seed, bert):
    """FOLD_BATCHES distinct batches of [2, 256] tokens (MLM labels for
    BERT, the tokens rolled by one for GPT)."""
    if bert:
        return [_mlm_batch(torch, vocab, 2, 256, seed + i)
                for i in range(FOLD_BATCHES)]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(FOLD_BATCHES):
        x = rng.integers(0, vocab, (2, 256)).astype(np.int64)
        out.append((torch.from_numpy(x),
                    torch.from_numpy(np.roll(x, -1, axis=1))))
    return out


def _fold_state(model):
    """Parameters, moments, beta powers, masters and step counts."""
    out = {f"param {n}": p.detach().clone()
           for n, p in model.network.named_parameters()}
    for i, st in model._optimizer._state.items():
        for k in ("moment1", "moment2", "beta1_pow", "beta2_pow",
                  "master_weight"):
            if k in st:
                out[f"{i} {k}"] = st[k].detach().clone()
        out[f"{i} steps"] = st["steps"]
    return out


def _fold_run(torch, run, seed, fold, dropout=0.0):
    """One fit of ``run``'s model over its batches at
    ``steps_per_dispatch=fold`` (with a loss keeper unless auto-K);
    returns its end state, per-step losses, the generator's offset and
    the resolved K, and frees the model."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import random as prandom
    cfg, bert, o2, batches, crit = run
    if dropout:
        cfg = dataclasses.replace(cfg, hidden_dropout_prob=dropout,
                                  attention_probs_dropout_prob=dropout)
    prandom.seed(seed)
    net, opt = _train_model(torch, cfg, "cuda", seed, o2=o2, bert=bert,
                            lr=FOLD_LR)
    model = paddle.Model(net, device="cuda")
    model.prepare(opt, crit())
    keep = _loss_keeper() if fold is not None else None
    model.fit(batches, epochs=1, verbose=0, steps_per_dispatch=fold,
              callbacks=[keep] if keep else None)
    torch.cuda.synchronize()
    res = {"state": _fold_state(model), "losses": keep and keep.losses,
           "offset": prandom.default_generator("cuda").get_offset(),
           "fold": model._fold, "graphs": model.compile_stats()}
    model.release_graphs()
    return res


def _state_diff(torch, a, b):
    """Largest |a - b| / max(|a|, 1) over the tensors of two end states
    (a step count that differs counts as inf)."""
    worst = 0.0
    for k, va in a.items():
        vb = b[k]
        if not isinstance(va, torch.Tensor):
            worst = max(worst, 0.0 if va == vb else float("inf"))
            continue
        ref = va.float()
        d = (vb.float() - ref).abs().max().item()
        worst = max(worst, d / max(ref.abs().max().item(), 1.0))
    return worst


def _states_equal(torch, a, b):
    return set(a) == set(b) and all(
        torch.equal(v, b[k]) if isinstance(v, torch.Tensor) else v == b[k]
        for k, v in a.items())


def fold_gates(torch, runs, fp32, exact=True):
    """The fold parity gates over ``runs`` (by ``steps_per_dispatch``:
    1, 4, None for auto-K, 0 the eager route); returns the failures and
    the largest relative difference from the eager route.  ``exact``:
    K=4's and auto-K's end states and K=4's losses equal K=1's bit for
    bit; else (a step whose kernels add in an order that changes from
    run to run) within FOLD_EAGER_TOL x max(|ref|, 1)."""
    fails = []
    for k in (4, None):
        if exact and not _states_equal(torch, runs[k]["state"],
                                       runs[1]["state"]):
            fails.append(f"K={k} end state differs from K=1's")
        diff = _state_diff(torch, runs[1]["state"], runs[k]["state"])
        if not exact and diff > FOLD_EAGER_TOL:
            fails.append(f"K={k} vs K=1: {diff:.3e} > {FOLD_EAGER_TOL}")
    eager = _state_diff(torch, runs[0]["state"], runs[4]["state"])
    if fp32 and eager > FOLD_EAGER_TOL:
        fails.append(f"K=4 vs steps_per_dispatch=0: {eager:.3e} > "
                     f"{FOLD_EAGER_TOL}")
    l1, l4 = runs[1]["losses"], runs[4]["losses"]
    groups = [l4[i:i + 4] for i in range(0, len(l4), 4)]
    if any(len(set(g)) != len(g) for g in groups):
        fails.append(f"a K=4 group repeats a loss: {groups}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(l4, l1))
    if (l4 != l1) if exact else not (len(l4) == len(l1) and
                                     rel <= FOLD_EAGER_TOL):
        fails.append(f"K=4 losses {l4} vs K=1 losses {l1}")
    return fails, eager


def fold_parity_phase(torch, seed):
    """``[train fold parity]``: a small GPT (2 layers, hidden 128, head
    dim 64, S=256) in fp32 (TF32 off) and in bf16 O2, and a small BERT
    in fp32 under the [B*H, S, D] knobs, each fit over FOLD_BATCHES
    distinct batches at K = 1, 4 (groups of 4, 4, 3), auto-K and the
    eager route.  Gates (:func:`fold_gates`): end states bit-identical
    for every K; within FOLD_EAGER_TOL x max(|ref|, 1) of the eager
    route in fp32; a K=4 group's losses distinct and equal to K=1's.
    The BERT run's fused backward adds dq through atomics, whose order
    changes from run to run, so its K's agree within FOLD_EAGER_TOL
    (two K=1 runs' difference is printed beside).
    With dropout 0.1 (GPT fp32) K=1 and K=4 end bit-identical with the
    generator's offset equal to the eager route's.  Two controls,
    patched in here, must fail the gates: the optimizer's scalars as
    host floats (frozen by the capture), and every slot of a group's
    losses read from the graph's one static loss."""
    from paddle_tpu_torch.framework import dispatch
    from paddle_tpu_torch.models import (BertConfig, BertPretrainingCriterion,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import optimizer as popt
    tag = "train fold parity"
    bcfg = BertConfig(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=256,
                      max_position_embeddings=256, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    gpt = _small_gpt()
    gpt_batches = _fold_batches(torch, gpt.vocab_size, seed + 7, False)
    configs = {
        "GPT L=2 D=128 fp32": ((gpt, False, False, gpt_batches,
                                GPTPretrainingCriterion), {}),
        "GPT L=2 D=128 bf16 O2": ((gpt, False, True, gpt_batches,
                                   GPTPretrainingCriterion), {}),
        "BERT L=2 D=128 fp32 [B*H,S,D]": (
            (bcfg, True, False, _fold_batches(torch, 256, seed + 8, True),
             lambda: BertPretrainingCriterion(bcfg.vocab_size)), BH_KNOBS),
    }
    out = {}
    for desc, (run, knobs) in configs.items():
        # the fused backward adds dq's partials with atomics, in an order
        # that changes from run to run: no two runs of it, at any K, end
        # bit-identical, so its K's are held to the eager tolerance
        exact = knobs is not BH_KNOBS
        with knobs_set(knobs):
            runs = {k: _fold_run(torch, run, seed, k) for k in (1, 4, None, 0)}
            if not exact:
                again = _fold_run(torch, run, seed, 1)
        fails, eager = fold_gates(torch, runs, fp32=not run[2], exact=exact)
        check(not fails, f"[{tag}] {desc}: {fails}")
        check(runs[4]["graphs"] == {"graphs": 1, "captures": 1} and
              runs[0]["graphs"] == {"graphs": 0, "captures": 0},
              f"[{tag}] {desc}: graphs {runs[4]['graphs']} / "
              f"{runs[0]['graphs']}")
        out[desc] = eager
        same = ("end bit-identical; K=4 losses per step equal K=1's" if exact
                else "end within the tolerance of K=1 (largest |diff|/"
                f"max(|ref|,1) {_state_diff(torch, runs[1]['state'], runs[4]['state']):.3e};"
                " two K=1 runs differ by "
                f"{_state_diff(torch, runs[1]['state'], again['state']):.3e}"
                " with the fused backward's atomics); K=4 losses per step "
                "within it of K=1's")
        print(f"[{tag}] {desc}: K=1, K=4 (groups 4+4+3) and auto-K "
              f"(decided K={runs[None]['fold']}) {same} and distinct in each "
              f"group; vs steps_per_dispatch=0 largest |diff|/max(|ref|,1) "
              f"{eager:.3e}" + (" (bit-identical)" if eager == 0 else "")
              + f" (tol {FOLD_EAGER_TOL}"
              + (", fp32)" if not run[2] else ", not gated in bf16)"),
              flush=True)
    run = configs["GPT L=2 D=128 fp32"][0]
    try:
        drop = {k: _fold_run(torch, run, seed, k, dropout=0.1)
                for k in (1, 4, 0)}
    except NotImplementedError as exc:
        print(f"[{tag}] dropout 0.1: the engine refuses it on this "
              f"PyTorch: {exc}", flush=True)
    else:
        offsets = [drop[k]["offset"] for k in (1, 4, 0)]
        check(_states_equal(torch, drop[1]["state"], drop[4]["state"]),
              f"[{tag}] dropout 0.1: K=1 and K=4 end states differ")
        check(len(set(offsets)) == 1,
              f"[{tag}] dropout 0.1: generator offsets K=1, K=4, eager "
              f"{offsets}")
        print(f"[{tag}] dropout 0.1 (GPT fp32): K=1 and K=4 end "
              f"bit-identical; generator offset {offsets[0]} after K=1, "
              f"K=4 and the eager route; vs eager largest diff "
              f"{_state_diff(torch, drop[0]['state'], drop[4]['state']):.3e}",
              flush=True)

    def host_scalars(self, states, lr, decay):
        """Control 1: the scalars as host floats of the host step count
        (the optimizer before device scalars); a capture freezes them."""
        f = np.float32
        t = states[0]["steps"] + 1
        b1p, b2p = f(f(self._beta1) ** t), f(f(self._beta2) ** t)
        lr32 = f(self.get_lr())
        root = np.sqrt(f(1) - b2p, dtype=f)
        vals = (f(lr32 * root / (f(1) - b1p)), f(f(self._epsilon) * root),
                f(lr32 * f(decay)))
        return tuple(torch.full((), float(v), dtype=torch.float32,
                                device=lr.device) for v in vals)

    def one_static_loss(self, losses, i):
        """Control 2: every slot of the group from the one static loss."""
        losses.copy_(self.loss.expand_as(losses))

    controls = {"optimizer scalars as host floats": (popt.Adam, "_scalars",
                                                     host_scalars),
                "every slot from the one static loss": (
                    dispatch.CapturedStep, "_take_loss", one_static_loss)}
    for name, (cls, attr, fn) in controls.items():
        saved = getattr(cls, attr)
        setattr(cls, attr, fn)
        try:
            runs = {k: _fold_run(torch, run, seed, k) for k in (1, 4, None, 0)}
        finally:
            setattr(cls, attr, saved)
        fails, _ = fold_gates(torch, runs, fp32=True)
        check(fails, f"[{tag}] control '{name}' passed the gates")
        print(f"[{tag}] control '{name}' fails the gates: {fails}",
              flush=True)
    return out


def _kernel_group(name):
    if any(k in name for k in ("flash_fwd_kernel", "flash_fwd_tc_kernel",
                                "flash_bwd_tc_kernel", "flash_bwd_dq_kernel",
                                "flash_bwd_dkv_kernel",
                                "flash_fwd_hpack_kernel",
                                "flash_bwd_fused", "fused_prep_kernel",
                                "fused_dq_cast_kernel")):
        return "flash kernels"
    if any(k in name for k in ("lmce_fwd_kernel", "lmce_bwd_kernel",
                                "lmce_bwd_tc_kernel", "lmce_fwd_tc_kernel",
                                "lmce_fwd_combine_kernel")):
        return "lmce kernels"
    low = name.lower()
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if "foreach" in low or "multi_tensor" in low:
        return "optimizer (foreach)"
    return "other (elementwise, norms, loss, copies)"


def profile_run(torch, tag, label, run, steps, group=_kernel_group):
    """``torch.profiler`` over ``run()``, ``steps`` train steps: device
    time by kernel ``group``, the busiest kernels, the ten busiest of
    the "other" group by kernel name, and the share of the wall time the
    device sat idle (1 - kernel time / wall; one stream, so kernels do
    not overlap); ``run`` runs again if the profiler recorded no device
    time (:func:`profiled`)."""
    wall = []

    def window():
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall.append((time.monotonic() - t0) * 1e6)

    prof = profiled(torch, window, cpu=True)
    wall_us = wall[-1]
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                SPIN_KEY in e.key:
            continue
        kernels[e.key] = kernels.get(e.key, 0.0) + kernel_us(e)
    busy = sum(kernels.values())
    groups = {}
    for name, us in kernels.items():
        g = group(name)
        groups[g] = groups.get(g, 0.0) + us
    idle = 1 - busy / wall_us
    print(f"[{tag} profile] {steps} {label} steps: wall "
          f"{wall_us / steps / 1e3:.3f} ms/step, device busy "
          f"{busy / steps / 1e3:.3f} ms/step, idle share {idle:.4f}",
          flush=True)
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[{tag} profile]   {g}: {us / steps / 1e3:.3f} ms/step "
              f"({us / busy:.4f} of device time)", flush=True)
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag} profile]   top: {us / steps / 1e3:.3f} ms/step "
              f"{name[:110]}", flush=True)
    other = sorted(((us, name) for name, us in kernels.items()
                    if group(name).startswith("other")),
                   reverse=True)[:10]
    for us, name in other:
        print(f"[{tag} profile]   other top: {us / steps / 1e3:.3f} "
              f"ms/step {name[:200]}", flush=True)
    return {"wall_ms": wall_us / steps / 1e3, "busy_ms": busy / steps / 1e3,
            "idle": idle, "groups_ms": {g: us / steps / 1e3
                                        for g, us in groups.items()}}


def profile_steps(torch, model, batch, steps, tag="train", folded=True):
    """:func:`profile_run` over ``steps`` more train steps: one fold group
    of graph replays (``fit(steps_per_dispatch=steps)``, the graph
    captured by the fit before) if ``folded``, else ``steps`` eager
    ``train_batch`` calls."""
    def run():
        if folded:
            model.fit([batch] * steps, epochs=1, verbose=0,
                      steps_per_dispatch=steps)
        else:
            for _ in range(steps):
                model.train_batch([batch[0]], [batch[1]])

    return profile_run(torch, tag, "replayed" if folded else "eager", run,
                       steps)


def _loss_keeper():
    """A callback that keeps each step's loss."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Keep(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"][0]))

    return Keep()


def _gpt_batches(torch, cfg, seed):
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(3):
        x = rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int64)
        batches.append((torch.from_numpy(x),
                        torch.from_numpy(np.roll(x, -1, axis=1))))
    return batches


def _small_gpt():
    from paddle_tpu_torch.models import gpt_tiny
    return gpt_tiny(hidden_size=128, num_attention_heads=2,
                    intermediate_size=256, max_position_embeddings=256)


def train_parity_phase(torch, seed):
    """Three fp32 steps of a small GPT on the card (kernels) and on the
    CPU (plain versions) from the same weights, unfused and with
    ``enable_fused_lmce``; losses within PARITY_TOL relative (cuBLAS,
    the kernels and the CPU sum in other orders; TF32 is off).  fp32
    runs the CUDA-core lmce kernels; returns their launches in the fused
    run."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import (GPTPretrainingCriterion,
                                         enable_fused_lmce)
    from paddle_tpu_torch.ops import lmce_kernel as lk
    cfg = _small_gpt()
    batches = _gpt_batches(torch, cfg, seed + 3)
    cpu_net, _ = _train_model(torch, cfg, "cpu", seed, o2=False)
    for fused in (False, True):
        tag = "train fp32 parity" + (" fused lmce" if fused else "")
        losses = {}
        lk.reset_counts()
        for device in ("cpu", "cuda"):
            net, opt = _train_model(torch, cfg, device, seed, o2=False)
            net.load_state_dict(cpu_net.state_dict())
            crit = GPTPretrainingCriterion()
            if fused:
                enable_fused_lmce(net, crit)
            model = paddle.Model(net, device=device)
            model.prepare(opt, crit)
            keep = _loss_keeper()
            model.fit(batches, epochs=1, verbose=0, callbacks=[keep])
            losses[device] = keep.losses
        counts = [(f.launches, f.plain_calls) for f in lk.WRAPPERS]
        want = [(3, 3)] * 3 if fused else [(0, 0)] * 3
        check(counts == want, f"[{tag}] lmce (launches, plain calls) "
              f"{counts}, expected {want}")
        check(not any(f.tc_launches for f in lk.TC_WRAPPERS),
              f"[{tag}] fp32 launched the tensor-core lmce backward")
        if fused:
            res = {f.__name__: f.launches for f in lk.WRAPPERS}
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                    losses["cpu"])]
        check(len(rel) == 3 and max(rel) <= PARITY_TOL,
              f"[{tag}] losses cuda {losses['cuda']} vs cpu "
              f"{losses['cpu']}")
        print(f"[{tag}] GPT L=2 D=128 H=2 Dh=64 S=256: losses cuda "
              f"{losses['cuda']} cpu {losses['cpu']} (max relative diff "
              f"{max(rel):.3e}, tol {PARITY_TOL}); lmce (launches, plain "
              f"calls) {counts}", flush=True)
    return res


def bh_parity_phase(torch, seed):
    """``[train fp32 parity bh]``: three fp32 steps of a small GPT
    (causal) and a small BERT (non-causal MLM) under the [B*H, S, D]
    knobs on the card (the head-packed forward and the fused backward)
    and on the CPU (their plain versions) from the same weights; losses
    within PARITY_TOL relative."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import (BertConfig, BertPretrainingCriterion,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    bcfg = BertConfig(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=256,
                      max_position_embeddings=256, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    runs = {
        "GPT L=2 D=128 H=2 Dh=64 S=256 causal": (
            _small_gpt(), False, _gpt_batches(torch, _small_gpt(), seed + 5),
            GPTPretrainingCriterion),
        "BERT L=2 D=128 H=2 Dh=64 S=256 non-causal MLM": (
            bcfg, True, [_mlm_batch(torch, 256, 2, 256, seed + 6 + i)
                         for i in range(3)],
            lambda: BertPretrainingCriterion(bcfg.vocab_size)),
    }
    layer_calls = 3 * 2                     # three steps x two layers
    want = {"cpu": [(0, 0)] * 3 + [(0, layer_calls)] * 2,
            "cuda": [(0, 0)] * 3 + [(layer_calls, 0)] * 2}
    for desc, (cfg, bert, batches, crit) in runs.items():
        cpu_net, _ = _train_model(torch, cfg, "cpu", seed, o2=False,
                                  bert=bert)
        losses, counts = {}, {}
        with knobs_set(BH_KNOBS):
            for device in ("cpu", "cuda"):
                net, opt = _train_model(torch, cfg, device, seed, o2=False,
                                        bert=bert)
                net.load_state_dict(cpu_net.state_dict())
                model = paddle.Model(net, device=device)
                model.prepare(opt, crit())
                keep = _loss_keeper()
                fk.reset_counts()
                model.fit(batches, epochs=1, verbose=0, callbacks=[keep])
                losses[device] = keep.losses
                counts[device] = [(f.launches, f.plain_calls)
                                  for f in fk.ALL_WRAPPERS]
                check(not any(f.tc_launches for f in fk.TC_WRAPPERS),
                      f"[train fp32 parity bh] {desc}: fp32 launched the "
                      "tensor-core forward")
        check(counts == want, f"[train fp32 parity bh] {desc}: flash "
              f"(launches, plain calls) {counts}, expected {want}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                    losses["cpu"])]
        check(len(rel) == 3 and max(rel) <= PARITY_TOL,
              f"[train fp32 parity bh] {desc}: losses cuda "
              f"{losses['cuda']} vs cpu {losses['cpu']}")
        print(f"[train fp32 parity bh] {desc}: losses cuda {losses['cuda']}"
              f" cpu {losses['cpu']} (max relative diff {max(rel):.3e}, tol "
              f"{PARITY_TOL}); flash (launches, plain calls) cuda "
              f"{counts['cuda']}", flush=True)


# ---------------------------------------------------------------------------
# The vision zoo: ResNet-50 training, ResNet parity, every CNN family.
# No TPU kernel lies on this path: the convolutions are cuDNN's.
# ---------------------------------------------------------------------------
RESNET_B, RESNET_SIZE, RESNET_CLASSES = 64, 224, 1000   # bench.py:280
RESNET_STEPS = 10                # [train resnet50]: K=1 and eager fits
RESNET_FOLD_STEPS = 32           # [train resnet50]: the K=8 and auto-K fits
RESNET_PROFILE = 8               # replays in the profiled window
RESNET_FP32_LOSS_TOL = 5e-2      # relative: O2's first three losses vs fp32's
RESNET_SLOW_LR = 0.01            # [train resnet50]'s witness at a lower rate,
RESNET_SLOW_FALL = 6             # whose loss falls over the first 6 steps
RESNET_FLOPS_IMG = 3 * 4.1e9     # bench.py:300-301: ~4.1 GFLOP forward an
                                 # image at 224x224, training ~3x
RESNET_PARITY_LR = 0.003         # [train resnet parity]: at lr 0.1 three
                                 # steps at B=4 turn fp32 differences of
                                 # 1e-8 into 1e-3 (the CPU test's finding)
ZOO_TOL = 1e-4                   # x max(|ref|, 1), fp32, card vs CPU
ZOO_B = 8
ZOO_LR = 0.01                    # [vision zoo]: Momentum's rate; at 0.1
                                 # VGG, GoogLeNet and AlexNet reach NaN by
                                 # the fourth step at B=8
ZOO_FAMILIES = (                 # (constructor, forward size, train size,
    ("resnet18", 64, 224, 3),    #  channels)
    ("resnext50_32x4d", 64, 224, 3),
    ("wide_resnet50_2", 64, 224, 3),
    ("vgg16", 64, 224, 3),
    ("mobilenet_v1", 64, 224, 3),
    ("mobilenet_v2", 64, 224, 3),
    ("mobilenet_v3_small", 64, 224, 3),
    ("mobilenet_v3_large", 64, 224, 3),
    ("shufflenet_v2_x1_0", 64, 224, 3),
    ("shufflenet_v2_swish", 64, 224, 3),
    ("densenet121", 64, 224, 3),
    ("squeezenet1_0", 96, 224, 3),
    ("squeezenet1_1", 96, 224, 3),
    ("googlenet", 96, 224, 3),
    ("inception_v3", 96, 299, 3),
    ("alexnet", 224, 224, 3),
    ("LeNet", 28, 28, 1),
)


def _vision_group(name):
    """The ``[train resnet50]`` profile's kernel groups, by kernel name."""
    low = name.lower()
    if "fprop" in low:
        return "conv forward (cuDNN)"
    if "dgrad" in low:
        return "conv dgrad (cuDNN)"
    if "wgrad" in low:
        return "conv wgrad (cuDNN)"
    if "bn_" in low or "batch_norm" in low or "batchnorm" in low:
        return "BatchNorm"
    if "foreach" in low or "multi_tensor" in low:
        return "optimizer (foreach)"
    if any(t in low for t in ("nchwtonhwc", "nhwctonchw", "nchw2nhwc",
                              "nhwc2nchw")):
        return "layout transforms (NCHW <-> NHWC)"
    if any(t in low for t in ("xmma", "cutlass", "gemm", "conv", "nvjet",
                              "implicit", "cudnn")):
        return "conv other / matmul (cuDNN, cuBLAS)"
    if any(t in low for t in ("logsumexp", "log_softmax", "softmax",
                              "nll", "gather")):
        return "loss"
    return "other elementwise (casts, relu, adds, pools)"


def _resnet50_model(torch, seed, lr=0.1, o2=True, metrics=None):
    """ResNet-50 from ``seed`` on the card with bench.py's setup (with
    ``o2=False``: fp32, no AMP), and ``metrics``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet50
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    net = resnet50(num_classes=RESNET_CLASSES, device="cuda", generator=gen)
    opt = paddle.optimizer.Momentum(lr, 0.9, parameters=net.parameters(),
                                    multi_precision=o2)
    amp = {"level": "O2", "dtype": "bfloat16"} if o2 else None
    if o2:
        paddle.amp.decorate(net, opt, **amp)
    model = paddle.Model(net, device="cuda")
    model.prepare(opt, paddle.nn.CrossEntropyLoss(), metrics,
                  amp_configs=amp)
    return net, model


def _resnet50_witness(torch, seed, batch, lr, o2):
    """RESNET_STEPS eager steps of :func:`_resnet50_model` on ``batch``:
    the losses."""
    import gc
    net, model = _resnet50_model(torch, seed, lr, o2)
    losses = [float(model.train_batch([batch[0]], [batch[1]])[0][0])
              for _ in range(RESNET_STEPS)]
    del net, model
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def _step_clock(torch):
    from paddle_tpu_torch.hapi.callbacks import Callback

    class StepClock(Callback):
        """Waits for the device at each step end and stamps it (the
        measurement's sync); keeps the losses."""

        def __init__(self):
            super().__init__()
            self.stamps, self.losses = [], []

        def on_train_begin(self, logs=None):
            torch.cuda.synchronize()
            self.stamps.append(time.monotonic())

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            self.stamps.append(time.monotonic())
            self.losses.append(float(logs["loss"][0]))

    return StepClock()


def _clocked_fit(torch, model, batch, steps, fold):
    """``fit`` of ``steps`` steps on one batch with a per-step clock:
    (losses, median step ms over steps 3+, first step ms)."""
    clock = _step_clock(torch)
    model.fit([batch] * steps, epochs=1, verbose=0, callbacks=[clock],
              steps_per_dispatch=fold)
    ms = np.diff(clock.stamps) * 1e3
    return clock.losses, float(np.median(ms[2:])), float(ms[0])


def _timed_fit(torch, model, batch, steps, fold):
    """``fit`` of ``steps`` steps synchronised only at its ends: ms a
    step."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    model.fit([batch] * steps, epochs=1, verbose=0,
              steps_per_dispatch=fold)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e3 / steps


def train_resnet50_phase(torch, seed):
    """``[train resnet50]`` (module docstring, 15c)."""
    import gc
    tag = "train resnet50"
    gc.collect()
    torch.cuda.empty_cache()
    net, model = _resnet50_model(torch, seed)
    rng = np.random.default_rng(seed + 5)
    x = rng.random((RESNET_B, 3, RESNET_SIZE, RESNET_SIZE),
                   dtype=np.float32)
    y = rng.integers(0, RESNET_CLASSES, (RESNET_B,)).astype(np.int64)
    batch = (torch.from_numpy(x).pin_memory(),
             torch.from_numpy(y).pin_memory())
    check(float(net.bn1._mean.abs().max()) == 0.0
          and float((net.bn1._variance - 1).abs().max()) == 0.0,
          f"[{tag}] BN running statistics do not start at 0 / 1")
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, first_ms = _clocked_fit(torch, model, batch,
                                             RESNET_STEPS, None)
    peak = torch.cuda.max_memory_allocated()
    check(model._fold == 1, f"[{tag}] steps_per_dispatch resolved to "
          f"{model._fold} under a per-step clock")
    check(len(losses) == RESNET_STEPS and all(np.isfinite(losses)),
          f"[{tag}] losses {losses}")
    # bench.py's lr 0.1 has no warm-up: on one fixed batch the loss falls
    # over the first steps and then overshoots, in fp32 as in O2 (the
    # witnesses below), so the gate is the fall over the first three
    check(losses[0] > losses[1] > losses[2], f"[{tag}] loss not falling "
          f"over the first three steps on the fixed batch: {losses}")
    check(float(net.bn1._mean.abs().max()) > 0
          and float((net.bn1._variance - 1).abs().max()) > 0
          and float(net.layer4[2].bn3._mean.abs().max()) > 0,
          f"[{tag}] BN running statistics did not move")
    dtypes = {p.dtype for p in net.parameters()}
    check(dtypes == {torch.bfloat16, torch.float32},
          f"[{tag}] O2 parameter dtypes {dtypes}")
    check(net.bn1._mean.dtype == torch.float32,
          f"[{tag}] BN buffers {net.bn1._mean.dtype}")
    runner = next(iter(model._graphs.values()))
    pool = pool_reserved(torch, model._graph_pool)
    ips = RESNET_B / (step_ms * 1e-3)
    k_ms = _timed_fit(torch, model, batch, RESNET_FOLD_STEPS, 8)
    auto_ms = _timed_fit(torch, model, batch, RESNET_FOLD_STEPS, None)
    tuner = model._fold_tuner
    check(tuner is not None and tuner.decided,
          f"[{tag}] the auto-K fit decided no K")
    prof = profile_run(
        torch, tag, "replayed",
        lambda: model.fit([batch] * RESNET_PROFILE, epochs=1, verbose=0,
                          steps_per_dispatch=RESNET_PROFILE),
        RESNET_PROFILE, _vision_group)
    graphs = model.compile_stats()
    check(graphs == {"graphs": 1, "captures": 1},
          f"[{tag}] {graphs}: a capture after the first")
    free_model(torch, tag, model)
    del net, model
    # the eager route from the same weights: its losses are the replays'
    net, model = _resnet50_model(torch, seed)
    torch.cuda.reset_peak_memory_stats()
    e_losses, eager_ms, _ = _clocked_fit(torch, model, batch, RESNET_STEPS,
                                         0)
    eager_peak = torch.cuda.max_memory_allocated()
    rel = max(abs(a - b) / abs(b) for a, b in zip(e_losses[:3], losses[:3]))
    check(all(np.isfinite(e_losses)) and rel <= FOLD_EAGER_LOSS_TOL,
          f"[{tag}] eager losses {e_losses} vs the replays' {losses}")
    eprof = profile_run(
        torch, f"{tag} eager", "eager",
        lambda: [model.train_batch([batch[0]], [batch[1]])
                 for _ in range(3)], 3, _vision_group)
    check(model.compile_stats() == {"graphs": 0, "captures": 0},
          f"[{tag}] the eager route captured: {model.compile_stats()}")
    free_model(torch, tag, model)
    del net, model
    # the witnesses of the overshoot: the same steps in fp32 at lr 0.1,
    # whose losses O2's follow, and in O2 at RESNET_SLOW_LR, where the
    # loss falls step after step
    fp32 = _resnet50_witness(torch, seed, batch, 0.1, False)
    slow = _resnet50_witness(torch, seed, batch, RESNET_SLOW_LR, True)
    f_rel = max(abs(a - b) / abs(b) for a, b in zip(losses[:3], fp32[:3]))
    check(all(np.isfinite(fp32)) and f_rel <= RESNET_FP32_LOSS_TOL,
          f"[{tag}] O2 losses {losses} vs fp32's {fp32}")
    check(all(a > b for a, b in zip(slow[:RESNET_SLOW_FALL],
                                    slow[1:RESNET_SLOW_FALL])),
          f"[{tag}] O2 at lr {RESNET_SLOW_LR}: loss not falling over the "
          f"first {RESNET_SLOW_FALL} steps: {slow}")
    print(f"[{tag}] witnesses, eager from the same weights on the same "
          f"batch: fp32 at lr 0.1 {[round(v, 5) for v in fp32]} (O2's "
          f"first three within {f_rel:.3e} relative); O2 at lr "
          f"{RESNET_SLOW_LR} {[round(v, 5) for v in slow]}", flush=True)
    tflops = RESNET_FLOPS_IMG * ips / 1e12
    print(f"[{tag}] ResNet-50 B={RESNET_B} {RESNET_SIZE}x{RESNET_SIZE} "
          f"{RESNET_CLASSES} classes bf16 O2 Momentum(0.1, 0.9, "
          f"multi_precision), CrossEntropyLoss: losses K=1 "
          f"{[round(v, 5) for v in losses]}, eager "
          f"{[round(v, 5) for v in e_losses]}; K=1 replays: step_ms "
          f"first={first_ms:.3f} median(steps 3+)={step_ms:.3f} -> "
          f"{ips:.1f} images/s ({tflops:.1f} TFLOP/s by bench.py's count, "
          f"{tflops / 989:.4f} of 989); K=8 over {RESNET_FOLD_STEPS}: "
          f"{k_ms:.3f} ms -> {RESNET_B / (k_ms * 1e-3):.1f} images/s; "
          f"auto-K: {auto_ms:.3f} ms -> {RESNET_B / (auto_ms * 1e-3):.1f} "
          f"images/s, decision {tuner.decision}; eager: step_ms "
          f"{eager_ms:.3f} -> {RESNET_B / (eager_ms * 1e-3):.1f} images/s, "
          f"first three losses within {rel:.3e} relative of the replays'; "
          f"peak_mem_gib {peak / 2**30:.3f} replayed, "
          f"{eager_peak / 2**30:.3f} eager; capture {runner.capture_s:.3f} "
          f"s, graph pool reserved "
          + (f"{pool / 2**30:.3f} GiB" if pool is not None else
             "not measured") + f"; graphs {graphs}", flush=True)
    return {"step_ms": step_ms, "images_per_s": ips, "k8_ms": k_ms,
            "fp32_losses": fp32, "slow_losses": slow, "auto_ms": auto_ms, "eager_ms": eager_ms, "peak": peak,
            "eager_peak": eager_peak, "capture_s": runner.capture_s,
            "pool": pool, "profile": prof, "eager_profile": eprof}


def _resnet_parity_state(model):
    """Parameters, velocities and BN buffers of a fit model, copied to
    the CPU, by name."""
    out = {k: v.detach().float().cpu().clone()
           for k, v in model.network.state_dict().items()}
    names = [k for k, _ in model.network.named_parameters()]
    for i, st in model._optimizer._state.items():
        out[f"{names[i]}.velocity"] = (st["velocity"].detach().float()
                                       .cpu().clone())
    return out


_RELUS = ("ReLU", "LeakyReLU", "L1Loss")


def _relu_watch(torch, net):
    """Forward pre-hooks on every ReLU (and LeakyReLU) of ``net`` that
    keep each call's input on the CPU, a list per forward (the hooks see
    eager forwards only, not graph replays); on every ``L1Loss``, the
    other kink, they keep ``input - label``."""
    calls = []

    def keep(mod, args):
        x = args[0] - args[1] if type(mod).__name__ == "L1Loss" else args[0]
        calls.append(x.detach().float().cpu())

    for mod in net.modules():
        if type(mod).__name__ in _RELUS:
            mod.register_forward_pre_hook(keep)
    return calls


def _relu_force(net, inputs):
    """Make every ReLU (and LeakyReLU) of ``net`` pass what another run's
    passed: its n-th call takes its input where ``inputs[n] > 0`` and 0
    (the leaky slope times it) elsewhere (eager forwards in order), so
    the gradient takes that run's way through each one whatever the
    sign of this run's input; an ``L1Loss`` takes ``|input - label|``
    with the other run's signs."""
    masks = iter([x > 0 for x in inputs])

    def relu(x):
        return x * next(masks).to(x.device, x.dtype)

    def leaky(slope):
        def forced(x):
            return x.where(next(masks).to(x.device), x * slope)
        return forced

    def l1(reduction):
        def forced(x, y):
            d = x - y
            out = d.where(next(masks).to(x.device), -d)
            return {"mean": out.mean, "sum": out.sum}.get(
                reduction, lambda: out)()
        return forced

    for mod in net.modules():
        if type(mod).__name__ == "ReLU":
            mod.forward = relu
        elif type(mod).__name__ == "LeakyReLU":
            mod.forward = leaky(mod._args[0] if mod._args else
                                mod._kwargs.get("negative_slope", 0.01))
        elif type(mod).__name__ == "L1Loss":
            mod.forward = l1(mod.reduction)


def _parity_fit(torch, init, batches, device, fold, watch=False,
                force=None):
    """Momentum(RESNET_PARITY_LR, 0.9) steps of ResNet-18 from ``init``
    on ``device`` through ``fit(steps_per_dispatch=fold)``, one per
    batch: the state after each step as its callback sees it (after its
    group ran), the graphs, and with ``watch`` every ReLU input of each
    step; ``force``: another run's ReLU inputs, whose signs this run's
    ReLUs follow (:func:`_relu_force`)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.vision.models import resnet18
    net = resnet18(num_classes=10, device=device)
    net.load_state_dict(init)
    opt = paddle.optimizer.Momentum(RESNET_PARITY_LR, 0.9,
                                    parameters=net.parameters())
    model = paddle.Model(net, device=device)
    model.prepare(opt, paddle.nn.CrossEntropyLoss())
    relus = _relu_watch(torch, net) if watch else None
    if force is not None:
        _relu_force(net, [x for step in force for x in step])
    after, seen = [], []

    class Keep(Callback):
        def on_train_batch_end(self, step, logs=None):
            after.append(_resnet_parity_state(model))
            if watch:
                seen.append(list(relus))
                relus.clear()

    model.fit(batches, epochs=1, verbose=0, callbacks=[Keep()],
              steps_per_dispatch=fold)
    graphs = model.compile_stats()
    model.release_graphs()
    return after, graphs, seen


def _worst(a, b):
    """max |a - b| / max(|b|, 1) per entry, the worst first."""
    return sorted(((float((a[k] - b[k]).abs().max())
                    / max(float(b[k].abs().max()), 1.0), k) for k in b),
                  reverse=True)


def _relu_flips(card, cpu):
    """ReLU inputs whose sign differs between two runs, per step: (step,
    call, elements flipped, the largest |input| among them on the card
    and on the CPU, the call's largest |input| on the CPU)."""
    out = []
    for step, (a_calls, b_calls) in enumerate(zip(card, cpu)):
        for call, (a, b) in enumerate(zip(a_calls, b_calls)):
            m = (a > 0) != (b > 0)
            if bool(m.any()):
                out.append((step, call, int(m.sum()),
                            float(a[m].abs().max()),
                            float(b[m].abs().max()),
                            float(b.abs().max())))
    return out


def train_resnet_parity_phase(torch, seed):
    """``[train resnet parity]`` (module docstring, 15d)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet18
    tag = "train resnet parity"
    rng = np.random.default_rng(seed + 6)
    batches = [(torch.from_numpy(rng.standard_normal(
        (4, 3, 64, 64)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 10, (4,)).astype(np.int64)))
        for _ in range(3)]
    cpu_net = resnet18(num_classes=10, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    init = {k: v.clone() for k, v in cpu_net.state_dict().items()}
    names = [k for k, _ in cpu_net.named_parameters()]
    # one step with cuDNN's convolutions: logits and every gradient
    card = resnet18(num_classes=10, device="cuda")
    card.load_state_dict(init)
    crit = paddle.nn.CrossEntropyLoss()
    step = {}
    for net, dev in ((cpu_net, "cpu"), (card, "cuda")):
        x, y = (t.to(dev) for t in batches[0])
        out = net(x)
        crit(out, y).backward()
        step[dev] = {"logits": out.detach().cpu()}
        step[dev].update({k: p.grad.cpu() for k, p in
                          net.named_parameters()})
    one = _worst(step["cuda"], step["cpu"])
    print(f"[{tag}] one step with cuDNN: logits and gradients card vs CPU, "
          "worst " + ", ".join(f"{k} {r:.3e}" for r, k in one[:3]),
          flush=True)
    check(one[0][0] <= ZOO_TOL, f"[{tag}] one step with cuDNN: {one[0]}")
    ref, _, ref_relu = _parity_fit(torch, init, batches, "cpu", 0,
                                   watch=True)
    worst = {}
    # the main path's route, cuDNN's convolutions and BatchNorm, with
    # its algorithms pinned to the deterministic ones (no atomic adds),
    # so that a replay can be held against the eager run bit for bit
    after = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        for run, fold in (("K=1", 1), ("K=4", 4), ("eager", 0)):
            after[run], graphs, seen = _parity_fit(
                torch, init, batches, "cuda", fold, watch=fold == 0)
            want = ({"graphs": 0, "captures": 0} if fold == 0 else
                    {"graphs": 1, "captures": 1})
            check(graphs == want, f"[{tag}] {run}: {graphs}")
            check(len(after[run]) == len(batches),
                  f"[{tag}] {run}: {len(after[run])} steps seen")
    # a ReLU input within fp32 rounding of 0 may take another sign on
    # the card than on the CPU and send one element's gradient the other
    # way: the CPU run that follows the card's ReLU signs is the
    # reference, step by step; the plain CPU run's departure is printed
    # and must come with such a flip
    flips = _relu_flips(seen, ref_relu)
    forced, _, _ = _parity_fit(torch, init, batches, "cpu", 0, force=seen)
    per = [_worst(a, b)[0] for a, b in zip(after["eager"], forced)]
    worst["eager vs cpu (card's ReLU signs), worst step"] = max(per)[0]
    for i in range(len(batches)):
        worst[f"K=1 vs eager, step {i}"] = _worst(after["K=1"][i],
                                                   after["eager"][i])[0][0]
    worst["K=4 vs eager"] = _worst(after["K=4"][-1],
                                   after["eager"][-1])[0][0]
    same = {run: all(torch.equal(after[run][-1][k], after["eager"][-1][k])
                     for k in ref[-1]) for run in ("K=1", "K=4")}
    free = _worst(after["eager"][-1], ref[-1])
    print(f"[{tag}] cuDNN (deterministic) eager vs the CPU run that "
          "follows its ReLU signs, each step: "
          + ", ".join(f"step {i} {k} {r:.3e}" for i, (r, k) in
                      enumerate(per)), flush=True)
    print(f"[{tag}] three steps with cuDNN running free, eager vs the "
          "plain CPU run: worst "
          + ", ".join(f"{k} {r:.3e}" for r, k in free[:3])
          + f"; ReLU inputs of another sign than the CPU's (step, call, "
          f"elements, max |card|, max |cpu|, call's max |cpu|): {flips}",
          flush=True)
    check(free[0][0] <= ZOO_TOL or flips,
          f"[{tag}] the free-running cuDNN route departs by "
          f"{free[0][0]:.3e} with no ReLU sign flip to explain it")
    for name, ratio in worst.items():
        check(ratio <= ZOO_TOL, f"[{tag}] {name}: {ratio:.3e} > {ZOO_TOL} "
              "x max(|ref|, 1)")
    print(f"[{tag}] ResNet-18 64x64 B=4 fp32 (TF32 off), three "
          f"Momentum({RESNET_PARITY_LR}, 0.9) steps: max |diff| / max(|ref|,"
          f" 1) over parameters, velocities and BN buffers "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (tol {ZOO_TOL}); cuDNN replays bit-equal to eager: {same}; "
          f"one step with cuDNN {one[0][0]:.3e}; three running free with "
          f"cuDNN {free[0][0]:.3e} with {len(flips)} ReLU sign flip(s)",
          flush=True)
    return {"worst": worst, "one_step_cudnn": one[0][0],
            "free_cudnn": free[0][0], "relu_flips": flips}


def _zoo_loss(crit, out, y):
    """CrossEntropyLoss of the logits; GoogLeNet's aux heads weigh 0.3."""
    if isinstance(out, tuple):
        return crit(out[0], y) + 0.3 * (crit(out[1], y) + crit(out[2], y))
    return crit(out, y)


def vision_zoo_phase(torch, seed):
    """``[vision zoo]`` (module docstring, 15e)."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision import models as TM
    tag = "vision zoo"
    crit = paddle.nn.CrossEntropyLoss()
    rng = np.random.default_rng(seed + 7)
    res = {}
    for name, fsize, tsize, ch in ZOO_FAMILIES:
        ctor = getattr(TM, name)
        cpu = ctor(num_classes=10, device="cpu",
                   generator=torch.Generator().manual_seed(seed)).eval()
        net = ctor(num_classes=10, device="cuda").eval()
        net.load_state_dict(cpu.state_dict())
        x = torch.from_numpy(rng.random((2, ch, fsize, fsize),
                                        dtype=np.float32))
        with torch.no_grad():
            ref, got = cpu(x), net(x.cuda())
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        err = max(float((g.cpu() - r).abs().max())
                  / max(float(r.abs().max()), 1.0)
                  for g, r in zip(got, ref))
        check(all(tuple(g.shape) == (2, 10) for g in got),
              f"[{tag}] {name}: output shapes {[g.shape for g in got]}")
        check(err <= ZOO_TOL, f"[{tag}] {name}: card vs CPU {err:.3e}")
        del cpu
        opt = paddle.optimizer.Momentum(ZOO_LR, 0.9,
                                        parameters=net.parameters(),
                                        multi_precision=True)
        paddle.amp.decorate(net, opt, level="O2", dtype="bfloat16")
        net.train()
        xt = torch.from_numpy(rng.random((ZOO_B, ch, tsize, tsize),
                                         dtype=np.float32)).cuda()
        yt = torch.from_numpy(rng.integers(0, 10, (ZOO_B,))).cuda()
        times = []
        for i in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
                out = net(xt)
            loss = _zoo_loss(crit, out, yt)
            loss.backward()
            if i == 0:
                first = float(loss.detach())
                finite = bool(torch.isfinite(loss)) and all(
                    bool(torch.isfinite(p.grad).all())
                    for p in net.parameters() if p.grad is not None)
                check(finite, f"[{tag}] {name}: loss {first} or a "
                      "gradient not finite")
                check(all(p.grad is not None for p in net.parameters()),
                      f"[{tag}] {name}: a parameter got no gradient")
            opt.step()
            opt.clear_grad()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        step_ms = float(np.median(times[1:]))
        res[name] = {"max_abs_err": err, "step_ms": step_ms}
        print(f"[{tag}] {name}: fp32 forward at {fsize}x{fsize} card vs CPU "
              f"{err:.3e} x max(|ref|, 1) (tol {ZOO_TOL}); bf16 O2 step at "
              f"B={ZOO_B} {tsize}x{tsize}: first loss {first:.5f} with "
              f"finite gradients, fourth {float(loss.detach()):.5f}; "
              f"{step_ms:.3f} ms a step (eager, median of 3 "
              f"after the first; first {times[0]:.3f})", flush=True)
        del net, opt, out, loss
        gc.collect()
        torch.cuda.empty_cache()
    # the transformer (at its build grid, a smaller and a larger one) and
    # the detector (eval scores and boxes): fp32 forwards, card vs CPU
    for name, ctor, kw, sizes in (
            ("vit tiny", TM.VisionTransformer, VIT_TINY, (32, 24, 48)),
            ("ppyoloe_tiny", TM.ppyoloe_tiny, {"num_classes": 4}, (64,))):
        cpu = ctor(**kw, device="cpu",
                   generator=torch.Generator().manual_seed(seed)).eval()
        net = ctor(**kw, device="cuda").eval()
        net.load_state_dict(cpu.state_dict())
        errs = []
        for size in sizes:
            x = torch.from_numpy(rng.random((2, 3, size, size),
                                            dtype=np.float32))
            with torch.no_grad():
                ref, got = cpu(x), net(x.cuda())
            ref = ref if isinstance(ref, tuple) else (ref,)
            got = got if isinstance(got, tuple) else (got,)
            check(all(g.shape == r.shape for g, r in zip(got, ref)),
                  f"[{tag}] {name} at {size}: shapes")
            errs.append(max(float((g.cpu() - r).abs().max())
                            / max(float(r.abs().max()), 1.0)
                            for g, r in zip(got, ref)))
        check(max(errs) <= ZOO_TOL, f"[{tag}] {name}: card vs CPU {errs}")
        res[name] = {"max_abs_err": max(errs)}
        print(f"[{tag}] {name}: fp32 eval forward card vs CPU at "
              + ", ".join(f"{s}x{s} {e:.3e}" for s, e in zip(sizes, errs))
              + f" x max(|ref|, 1) (tol {ZOO_TOL})", flush=True)
        del cpu, net
    return res


# ---------------------------------------------------------------------------
# ViT and PP-YOLOE: the vision zoo's transformer and detector
# ---------------------------------------------------------------------------
VIT_B, VIT_CLASSES, VIT_LR = 32, 1000, 1e-3    # bench.py:427-500 (bench_vit)
VIT_SIZES = (224, 192)           # the resolution buckets, alternating
VIT_STEPS = 8                    # [train vit]: steps held bit for bit against
                                 # eager (the first of each bucket warms up
                                 # and captures, the rest replay)
VIT_PROFILE = 4                  # replays in the profiled window
VIT_L_STEPS = 3                  # [train vit-l]: replays after the capture
VIT_FALL = 3                     # steps of each bucket a witness's loss falls over
VIT_SLOW_LR = 1e-4               # the witnesses: O2 at a tenth of the rate,
DET_SLOW_LR = 1e-4               # whose loss falls step after step, and
VIT_FP32_LOSS_TOL = 5e-2         # fp32 at bench's rate, whose first three
                                 # losses O2's follow (relative)
DET_B, DET_CLASSES, DET_LR = 8, 80, 1e-3       # bench.py:352-425
DET_SIZES = (640, 512)           # (bench_detector); its data: 8 boxes an
DET_GMAX = 8                     # image, labels 0-3, the first box real
DET_STEPS = 8                    # [train ppyoloe]: as VIT_STEPS
DET_PROFILE = 4
NMS_SCORE_TOL = 1e-6             # [detect eval]: card rows vs the CPU's
DET_EVAL_SHARE = 0.01            # [detect eval]: class scores NMS considers
VIT_TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2,
                num_heads=4, num_classes=4)    # [vision zoo]'s ViT


def _vit_model(torch, seed, ctor="vit_b_16", lr=VIT_LR, o2=True):
    """``ctor`` from ``seed`` on the card with ``bench_vit``'s setup:
    AdamW(1e-3, multi_precision), ``amp.decorate`` O2 bf16,
    ``prepare(amp_configs=O2)``, CrossEntropyLoss (with ``o2=False``:
    fp32, no AMP)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision import models as TM
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    net = getattr(TM, ctor)(num_classes=VIT_CLASSES, device="cuda",
                            generator=gen)
    opt = paddle.optimizer.AdamW(learning_rate=lr,
                                 parameters=net.parameters(),
                                 multi_precision=o2)
    amp = {"level": "O2", "dtype": "bfloat16"} if o2 else None
    if o2:
        paddle.amp.decorate(net, opt, **amp)
    model = paddle.Model(net, device="cuda")
    model.prepare(opt, paddle.nn.CrossEntropyLoss(), amp_configs=amp)
    return net, model


def _vit_witness(torch, seed, seq, lr, o2):
    """Eager steps of :func:`_vit_model` over ``seq``: the losses."""
    import gc
    net, model = _vit_model(torch, seed, lr=lr, o2=o2)
    losses, _ = _fit_clocked(torch, model, seq, 0)
    del net, model
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def _vit_batches(torch, seed, sizes):
    """``bench_vit``'s data: one batch per bucket, drawn in bucket order
    from ``np.random.RandomState(seed)``, in pinned memory."""
    rng = np.random.RandomState(seed)
    out = {}
    for s in sizes:
        x = rng.rand(VIT_B, 3, s, s).astype(np.float32)
        y = rng.randint(0, VIT_CLASSES, (VIT_B,)).astype(np.int64)
        out[s] = (torch.from_numpy(x).pin_memory(),
                  torch.from_numpy(y).pin_memory())
    return out


def _fit_clocked(torch, model, batches, fold):
    """``fit`` over ``batches`` with a per-step clock: (losses, ms of
    each step)."""
    clock = _step_clock(torch)
    model.fit(batches, epochs=1, verbose=0, callbacks=[clock],
              steps_per_dispatch=fold)
    return clock.losses, [float(v) for v in np.diff(clock.stamps) * 1e3]


def _per_bucket(sizes, values):
    """``values`` of an alternating bucket sequence, per bucket."""
    return {s: values[i::len(sizes)] for i, s in enumerate(sizes)}


def _falls(losses, sizes, n):
    """Each bucket's loss falls over its first ``n`` steps."""
    return all(all(a > b for a, b in zip(v[:n], v[1:n]))
               for v in _per_bucket(sizes, losses).values())


def _vit_group(name):
    """The ``[train vit]`` profile's kernel groups, by kernel name."""
    low = name.lower()
    if "foreach" in low or "multi_tensor" in low:
        return "optimizer (foreach)"
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul (cuBLAS)"
    if "softmax" in low:
        return "softmax (attention, loss)"
    if "layer_norm" in low or "layernorm" in low:
        return "LayerNorm"
    if "gelu" in low:
        return "GELU"
    if any(t in low for t in ("fprop", "dgrad", "wgrad", "cudnn", "conv")):
        return "patch conv (cuDNN)"
    if "copy" in low or "cast" in low:
        return "casts and copies"
    return "other elementwise (adds, reductions, loss, resize)"


def _attention_ms(torch, b, n, heads, dh):
    """Device ms of one composed attention forward and backward
    (``nn_ops.scaled_dot_product_attention``, fp32 inside) on bf16
    ``[b, n, heads, dh]`` inputs: ViT's attention at one layer."""
    from paddle_tpu_torch.ops import nn_ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, n, heads, dh, device="cuda", generator=gen)
               .bfloat16().requires_grad_() for _ in range(3))
    g = torch.randn(b, n, heads, dh, device="cuda",
                    generator=gen).bfloat16()

    def fn():
        nn_ops.scaled_dot_product_attention(q, k, v).backward(g)

    return device_ms(torch, fn, 5, {"all": ()})["all"]


def train_vit_phase(torch, seed):
    """``[train vit]`` (module docstring, 15f)."""
    import gc
    tag = "train vit"
    gc.collect()
    torch.cuda.empty_cache()
    data = _vit_batches(torch, seed, VIT_SIZES)
    seq = [data[VIT_SIZES[i % 2]] for i in range(VIT_STEPS)]
    # the patch embedding's convolution on cuDNN's deterministic
    # algorithms (no atomic adds), so that a replay can be held against
    # the eager run bit for bit; every other op is deterministic anyway
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        net, model = _vit_model(torch, seed)
        dtypes = {n: p.dtype for n, p in net.named_parameters()}
        check(dtypes["pos_embed"] == dtypes["cls_token"] == torch.bfloat16
              and dtypes["norm.weight"] == torch.float32,
              f"[{tag}] O2 parameter dtypes {set(dtypes.values())}")
        torch.cuda.reset_peak_memory_stats()
        warm, warm_ms = _fit_clocked(torch, model, seq[:2], None)
        graphs = model.compile_stats()
        check(model._fold == 1 and graphs == {"graphs": 2, "captures": 2},
              f"[{tag}] after one step per bucket: {graphs}, K="
              f"{model._fold}: want one graph per bucket")
        timed, ms = _fit_clocked(torch, model, seq[2:], None)
        peak = torch.cuda.max_memory_allocated()
        check(model.compile_stats() == graphs,
              f"[{tag}] a capture in the timed window: "
              f"{model.compile_stats()}")
        losses = warm + timed
        pool = pool_reserved(torch, model._graph_pool)
        capture_s = {s: r.capture_s for s, r in
                     zip(VIT_SIZES, model._graphs.values())}
        prof = profile_run(
            torch, tag, "replayed",
            lambda: model.fit(seq[:VIT_PROFILE], epochs=1, verbose=0,
                              steps_per_dispatch=VIT_PROFILE),
            VIT_PROFILE, _vit_group)
        check(model.compile_stats() == graphs,
              f"[{tag}] a capture in the profiled window")
        free_model(torch, tag, model)
        del net, model
        net, model = _vit_model(torch, seed)
        torch.cuda.reset_peak_memory_stats()
        eager, eager_ms = _fit_clocked(torch, model, seq, 0)
        eager_peak = torch.cuda.max_memory_allocated()
        check(model.compile_stats() == {"graphs": 0, "captures": 0},
              f"[{tag}] the eager route captured: {model.compile_stats()}")
        free_model(torch, tag, model)
        del net, model
    same = losses == eager
    # bench's lr 1e-3 has no warm-up: on the fixed batches the loss of a
    # bucket can rise at its second step; the witnesses, eager from the
    # same weights over the same steps: fp32 at 1e-3, whose first three
    # losses O2's follow, and O2 at VIT_SLOW_LR, falling in each bucket
    wseq = seq[:2 * VIT_FALL]
    fp32 = _vit_witness(torch, seed, wseq, VIT_LR, False)
    slow = _vit_witness(torch, seed, wseq, VIT_SLOW_LR, True)
    f_rel = max(abs(a - b) / abs(b) for a, b in zip(losses[:3], fp32[:3]))
    attn = {s: _attention_ms(torch, VIT_B, (s // 16) ** 2 + 1, 12, 64)
            for s in VIT_SIZES}
    steps_ms = _per_bucket(VIT_SIZES, [None, None] + ms)
    eager_b = _per_bucket(VIT_SIZES, eager_ms)
    res = {"step_ms": {}, "eager_ms": {}, "images_per_s": {}}
    for s in VIT_SIZES:
        rep = [v for v in steps_ms[s] if v is not None]
        res["step_ms"][s] = float(np.median(rep))
        res["eager_ms"][s] = float(np.median(eager_b[s][1:]))
        res["images_per_s"][s] = VIT_B / (res["step_ms"][s] * 1e-3)
    busy = prof["busy_ms"]
    print(f"[{tag}] ViT-B/16 B={VIT_B} buckets {VIT_SIZES} alternating, "
          f"bf16 O2 AdamW({VIT_LR}, multi_precision), CrossEntropyLoss, "
          f"cuDNN deterministic (the patch conv): losses "
          f"{[round(v, 5) for v in losses]} replayed, bit-equal to eager: "
          f"{same}; graphs {graphs}, capture "
          + ", ".join(f"{s}: {c:.3f} s" for s, c in capture_s.items())
          + "; replayed ms a step "
          + ", ".join(f"{s}: {res['step_ms'][s]:.3f} ({res['images_per_s'][s]:.1f}"
                      f" images/s)" for s in VIT_SIZES)
          + "; eager ms a step "
          + ", ".join(f"{s}: {res['eager_ms'][s]:.3f}" for s in VIT_SIZES)
          + f"; first steps (warm-up + capture) {[round(v, 3) for v in warm_ms]}"
          f" ms; peak_mem_gib {peak / 2**30:.3f} replayed, "
          f"{eager_peak / 2**30:.3f} eager; graph pool reserved "
          + (f"{pool / 2**30:.3f} GiB" if pool is not None else
             "not measured"), flush=True)
    print(f"[{tag}] composed attention alone (fp32 inside, forward + "
          f"backward, one layer, device time): "
          + ", ".join(f"{s}: {v:.3f} ms x 12 layers = {12 * v:.3f} ms"
                      for s, v in attn.items())
          + f"; the profiled window's device-busy {busy:.3f} ms a step "
          f"(both buckets), idle share {prof['idle']:.4f}", flush=True)
    print(f"[{tag}] witnesses, eager over the first {len(wseq)} steps: "
          f"fp32 at lr {VIT_LR} {[round(v, 5) for v in fp32]} (O2's first "
          f"three within {f_rel:.3e} relative); O2 at lr {VIT_SLOW_LR} "
          f"{[round(v, 5) for v in slow]}", flush=True)
    check(all(np.isfinite(losses)), f"[{tag}] losses {losses}")
    check(same, f"[{tag}] replayed losses {losses} are not bit-equal to "
          f"the eager run's {eager}")
    check(all(np.isfinite(fp32)) and f_rel <= VIT_FP32_LOSS_TOL,
          f"[{tag}] O2 losses {losses[:3]} vs fp32's {fp32[:3]}")
    check(_falls(slow, VIT_SIZES, VIT_FALL),
          f"[{tag}] O2 at lr {VIT_SLOW_LR}: loss not falling over each "
          f"bucket's first {VIT_FALL} steps: {_per_bucket(VIT_SIZES, slow)}")
    res.update({"fp32_losses": fp32, "slow_losses": slow})
    res.update({"losses": losses, "eager_losses": eager, "peak": peak,
                "eager_peak": eager_peak, "pool": pool, "profile": prof,
                "attention_ms": attn, "capture_s": capture_s})
    return res


def train_vit_l_phase(torch, seed):
    """``[train vit-l]`` (module docstring, 15g)."""
    import gc
    tag = "train vit-l"
    gc.collect()
    torch.cuda.empty_cache()
    batch = _vit_batches(torch, seed, VIT_SIZES[:1])[VIT_SIZES[0]]
    net, model = _vit_model(torch, seed, "vit_l_16")
    torch.cuda.reset_peak_memory_stats()
    losses, ms = _fit_clocked(torch, model, [batch] * (VIT_L_STEPS + 1),
                              None)
    peak = torch.cuda.max_memory_allocated()
    graphs = model.compile_stats()
    check(graphs == {"graphs": 1, "captures": 1}, f"[{tag}] {graphs}")
    check(all(np.isfinite(losses)), f"[{tag}] losses {losses}")
    step_ms = float(np.median(ms[1:]))
    print(f"[{tag}] ViT-L/16 B={VIT_B} {VIT_SIZES[0]}x{VIT_SIZES[0]} bf16 O2 "
          f"AdamW: losses {[round(v, 5) for v in losses]}; first step "
          f"(warm-up + capture) {ms[0]:.3f} ms, replayed {step_ms:.3f} ms a "
          f"step ({VIT_B / (step_ms * 1e-3):.1f} images/s); peak_mem_gib "
          f"{peak / 2**30:.3f}", flush=True)
    free_model(torch, tag, model)
    del net, model
    return {"step_ms": step_ms, "peak": peak, "losses": losses}


def _det_batches(torch, seed):
    """``bench_detector``'s data from ``np.random.RandomState(seed)``, one
    batch per bucket in bucket order, on the card: images, padded boxes
    ``[B, 8, 4]`` (x1 <= x2 - 4), labels 0-3 and the mask (the first box
    always real)."""
    rng = np.random.RandomState(seed)
    out = {}
    for size in DET_SIZES:
        imgs = rng.rand(DET_B, 3, size, size).astype(np.float32)
        boxes = rng.rand(DET_B, DET_GMAX, 4).astype(np.float32) * size
        boxes = np.concatenate([np.minimum(boxes[..., :2], boxes[..., 2:]),
                                np.maximum(boxes[..., :2], boxes[..., 2:])
                                + 4], -1)
        labels = rng.randint(0, 4, (DET_B, DET_GMAX)).astype(np.int64)
        mask = (rng.rand(DET_B, DET_GMAX) < 0.5).astype(np.float32)
        mask[:, 0] = 1.0
        out[size] = tuple(torch.from_numpy(v).cuda()
                          for v in (imgs, boxes, labels, mask))
    return out


class _DetTrainer:
    """PP-YOLOE's training step through the fold engine as ``Model``
    builds it: ``build_folded_step`` per batch signature (image-size
    bucket) in one graph pool, with the launch-count and optimizer
    ledgers; the dict's ``loss`` is backpropagated and every term is
    copied out of each step.  ``step(batch, captured=False)`` runs the
    same body eagerly."""

    def __init__(self, torch, net, opt):
        from paddle_tpu_torch.ops import counts
        self.torch, self.net, self.opt = torch, net, opt
        self.device = torch.device("cuda", torch.cuda.current_device())
        self.pool = torch.cuda.graph_pool_handle()
        self.runners = {}
        self.ledgers = ((counts.read, counts.write),
                        (opt._bookkeeping, opt._set_bookkeeping))
        self.terms = torch.zeros(3, device=self.device)

    def _per_step(self, values):
        imgs, boxes, labels, mask = values
        out = self.net(imgs, gt_boxes=boxes, gt_labels=labels, gt_mask=mask)
        out["loss"].backward()
        self.opt._step()
        self.opt.clear_grad()
        self.terms.copy_(self.torch.stack(
            [out[k].detach() for k in ("loss_cls", "loss_iou", "loss_dfl")]))
        return out["loss"].detach().float()

    def step(self, batch, captured=True):
        """One step: ``[loss, loss_cls, loss_iou, loss_dfl]`` on the card,
        not waited for."""
        from paddle_tpu_torch.framework.dispatch import build_folded_step
        torch = self.torch
        self.net.train()
        self.opt.refresh_lr()
        if not captured:
            loss = self._per_step(list(batch))
            return torch.cat([loss[None], self.terms])
        key = tuple(tuple(b.shape) for b in batch)
        runner = self.runners.get(key)
        if runner is None:
            runner = self.runners[key] = build_folded_step(
                self._per_step, self.device, self.pool, self.ledgers)
        losses = torch.empty(1, device=self.device)
        runner.run([b[None] for b in batch], losses)
        return torch.cat([losses, self.terms])

    def captures(self):
        return sum(r.captures for r in self.runners.values())

    def close(self):
        for r in self.runners.values():
            r.close()
        self.runners = {}
        self.pool = None


def _det_model(torch, seed, lr=DET_LR):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import ppyoloe_crn_s
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    net = ppyoloe_crn_s(num_classes=DET_CLASSES, device="cuda",
                        generator=gen)
    opt = paddle.optimizer.Adam(learning_rate=lr,
                                parameters=net.parameters())
    return net, _DetTrainer(torch, net, opt)


def _det_run(torch, tr, seq, captured):
    """``seq``'s steps with a clock: ([steps, 4] numpy terms, ms each)."""
    out, ms = [], []
    for batch in seq:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out.append(tr.step(batch, captured))
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
    return torch.stack(out).cpu().numpy(), ms


def _det_loss_ms(torch, net, batch):
    """Device ms of the assignment and the four losses alone, forward
    and backward, on the head's maps for ``batch`` (the head's convs
    are run once before and left out)."""
    head = net.head
    imgs, boxes, labels, mask = batch
    with torch.no_grad():
        cls, reg, shapes = head._raw(net.neck(net.backbone(imgs)))
    cls, reg = cls.clone().requires_grad_(), reg.clone().requires_grad_()
    head._raw = lambda feats: (cls, reg, shapes)
    try:
        return device_ms(
            torch,
            lambda: head.loss(None, boxes, labels, mask)["loss"].backward(),
            5, {"all": ()})["all"]
    finally:
        del head._raw


def train_ppyoloe_phase(torch, seed):
    """``[train ppyoloe]`` (module docstring, 15h).  Returns the trained
    detector for ``[detect eval]``."""
    import gc
    tag = "train ppyoloe"
    gc.collect()
    torch.cuda.empty_cache()
    data = _det_batches(torch, seed)
    seq = [data[DET_SIZES[i % 2]] for i in range(DET_STEPS)]
    net, tr = _det_model(torch, seed)
    torch.cuda.reset_peak_memory_stats()
    warm, warm_ms = _det_run(torch, tr, seq[:2], True)
    check(tr.captures() == 2 and len(tr.runners) == 2,
          f"[{tag}] {tr.captures()} captures after one step per bucket")
    timed, ms = _det_run(torch, tr, seq[2:], True)
    peak = torch.cuda.max_memory_allocated()
    check(tr.captures() == 2, f"[{tag}] a capture in the timed window")
    terms = np.concatenate([warm, timed])
    pool = pool_reserved(torch, tr.pool)
    check(np.isfinite(terms).all(), f"[{tag}] loss terms {terms}")
    prof = profile_run(
        torch, tag, "replayed",
        lambda: [tr.step(b) for b in seq[:DET_PROFILE]], DET_PROFILE,
        _vision_group)
    check(tr.captures() == 2, f"[{tag}] a capture in the profiled window")
    loss_ms = {s: _det_loss_ms(torch, net, data[s]) for s in DET_SIZES}
    tr.close()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    # replayed against eager from the same start, cuDNN's algorithms
    # pinned to the deterministic ones (no atomic adds)
    runs = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        for name, captured in (("replayed", True), ("eager", False)):
            dnet, dtr = _det_model(torch, seed)
            runs[name] = _det_run(torch, dtr, seq, captured)
            dtr.close()
            del dnet, dtr
            gc.collect()
            torch.cuda.empty_cache()
    same = np.array_equal(runs["replayed"][0], runs["eager"][0])
    # at bench's lr 1e-3 a bucket's loss can stall a step on the fixed
    # batches; the witness, eager from the same weights over the same
    # steps at DET_SLOW_LR, falls in each bucket
    wnet, wtr = _det_model(torch, seed, DET_SLOW_LR)
    slow = list(_det_run(torch, wtr, seq[:6], False)[0][:, 0])
    wtr.close()
    del wnet, wtr
    step = _per_bucket(DET_SIZES, [None, None] + ms)
    res = {"step_ms": {}, "images_per_s": {}, "det_step_ms": {},
           "eager_ms": {}}
    for s in DET_SIZES:
        res["step_ms"][s] = float(np.median([v for v in step[s]
                                             if v is not None]))
        res["images_per_s"][s] = DET_B / (res["step_ms"][s] * 1e-3)
        res["det_step_ms"][s] = float(np.median(
            _per_bucket(DET_SIZES, runs["replayed"][1])[s][1:]))
        res["eager_ms"][s] = float(np.median(
            _per_bucket(DET_SIZES, runs["eager"][1])[s][1:]))
    busy = prof["busy_ms"]
    print(f"[{tag}] ppyoloe_crn_s {DET_CLASSES} classes B={DET_B} buckets "
          f"{DET_SIZES} alternating, fp32, Adam({DET_LR}): [loss, cls, iou,"
          f" dfl] per step {np.round(terms, 5).tolist()}; replayed ms a step "
          + ", ".join(f"{s}: {res['step_ms'][s]:.3f} "
                      f"({res['images_per_s'][s]:.1f} images/s)"
                      for s in DET_SIZES)
          + f"; first steps (warm-up + capture) "
          f"{[round(v, 3) for v in warm_ms]} ms; peak_mem_gib "
          f"{peak / 2**30:.3f}; graph pool reserved "
          + (f"{pool / 2**30:.3f} GiB" if pool is not None else
             "not measured"), flush=True)
    print(f"[{tag}] cuDNN deterministic: replayed ms a step "
          + ", ".join(f"{s}: {res['det_step_ms'][s]:.3f}" for s in DET_SIZES)
          + ", eager " + ", ".join(f"{s}: {res['eager_ms'][s]:.3f}"
                                   for s in DET_SIZES)
          + f"; {DET_STEPS} steps bit-equal (all four terms): {same}; the "
          f"assignment and losses alone (forward + backward, device time): "
          + ", ".join(f"{s}: {v:.3f} ms" for s, v in loss_ms.items())
          + f" against the profiled window's device-busy {busy:.3f} ms a "
          f"step (both buckets), idle share {prof['idle']:.4f}", flush=True)
    print(f"[{tag}] witness, eager over the first 6 steps at lr "
          f"{DET_SLOW_LR}: {[round(float(v), 5) for v in slow]}", flush=True)
    check(same, f"[{tag}] deterministic replays {runs['replayed'][0]} are "
          f"not bit-equal to eager {runs['eager'][0]}")
    check(_falls(slow, DET_SIZES, 3),
          f"[{tag}] at lr {DET_SLOW_LR}: loss not falling over each "
          f"bucket's first 3 steps: {_per_bucket(DET_SIZES, slow)}")
    res.update({"slow_losses": slow})
    res.update({"terms": terms, "peak": peak, "pool": pool, "profile": prof,
                "loss_ms": loss_ms})
    return res, net, data


def detect_eval_phase(torch, seed, net, data):
    """``[detect eval]`` (module docstring, 15i)."""
    tag = "detect eval"
    size = DET_SIZES[0]
    imgs = data[size][0]
    net.eval()
    with torch.no_grad():
        fwd_ms = time_cuda(torch, lambda: net(imgs), 5, warmup=2)
        scores, boxes = net(imgs)
    check(tuple(scores.shape) == (DET_B, boxes.shape[1], DET_CLASSES)
          and tuple(boxes.shape) == (DET_B, scores.shape[1], 4)
          and bool(torch.isfinite(scores).all())
          and bool(torch.isfinite(boxes).all()),
          f"[{tag}] outputs {scores.shape} {boxes.shape}")
    # after a few steps on random boxes no class score reaches
    # postprocess's default 0.05, so the threshold keeps this run's best
    # DET_EVAL_SHARE of them: an NMS with work to do
    thr = float(torch.quantile(scores.flatten(), 1 - DET_EVAL_SHARE))
    net.postprocess(scores, boxes, score_threshold=thr)       # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rows = net.postprocess(scores, boxes, score_threshold=thr)
    torch.cuda.synchronize()
    nms_ms = (time.monotonic() - t0) * 1e3
    cpu = net.postprocess(scores.cpu(), boxes.cpu(), score_threshold=thr)
    kept = [int(r.shape[0]) for r in rows]
    worst = 0.0
    for i, (got, ref) in enumerate(zip(rows, cpu)):
        got = got.cpu()
        check(got.shape == ref.shape and torch.equal(got[:, 0], ref[:, 0])
              and torch.equal(got[:, 2:], ref[:, 2:]),
              f"[{tag}] image {i}: card rows {got.shape} differ from the "
              f"CPU's {ref.shape} in labels or boxes")
        if len(ref):
            worst = max(worst, float((got[:, 1] - ref[:, 1]).abs().max()))
    check(worst <= NMS_SCORE_TOL, f"[{tag}] scores off by {worst:.3e}")
    check(sum(kept) > 0, f"[{tag}] no detection kept: {kept}")
    above = int((scores > thr).sum())
    print(f"[{tag}] ppyoloe_crn_s eval at {size}x{size} B={DET_B} "
          f"({scores.shape[1]} anchors; the largest score "
          f"{float(scores.max()):.5f}, {above} class scores above the "
          f"threshold {thr:.6f}): forward {fwd_ms:.3f} ms (events, median "
          f"of 5); postprocess (multiclass NMS per image on the card, IoU "
          f"0.6, at most 400 a class, keep 100) {nms_ms:.3f} ms (host "
          f"clock, synchronised); rows kept "
          f"{kept}, equal to the CPU run on the card's outputs (labels and "
          f"boxes exactly, scores within {worst:.3e})", flush=True)
    return {"forward_ms": fwd_ms, "nms_ms": nms_ms, "kept": kept,
            "threshold": thr}


LENET_B = 64                     # [train lenet]: tests/test_lenet_e2e.py:22
LENET_LR = 1e-3                  # Adam's rate there
LENET_MIN_ACC = 0.2              # the accuracy it must beat there (:53)
LENET_PARITY = 64                # steps the K=8 and eager fits are held over
LENET_TIMED = 256                # steps of each timed fit (host-bound)
LENET_PROFILE = 64               # steps of each profiled window
LENET_EVAL_TIMED = 64            # test batches of each timed evaluation
LENET_LOADER = 300               # batches each loader is timed over
LENET_PREFETCH = 96              # steps of the prefetcher's fits
LENET_PREDICT = 256              # test images predicted
RESNET_FIT_STEPS = 8             # [train resnet50 fit]: the metric's fits
RESNET_EVAL = 4                  # batches evaluated
RESNET_MICRO = 16                # accumulate_grad_batches=4 at this batch
RESNET_CKPT = 3                  # steps before the save and after the load
RESNET_LOADER_STEPS = 12         # steps over the SyntheticImages loader


def _lenet_model(torch, seed, metric=True):
    """LeNet from ``seed`` on the card with ``tests/test_lenet_e2e.py``'s
    setup: Adam(1e-3), CrossEntropyLoss, Accuracy()."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.vision.models import LeNet
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    net = LeNet(generator=gen)
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Adam(LENET_LR,
                                        parameters=net.parameters()),
                  paddle.nn.CrossEntropyLoss(),
                  Accuracy() if metric else None)
    return model


def _lenet_loader(torch, ds, seed, workers=0):
    from paddle_tpu_torch.io import DataLoader
    return DataLoader(ds, batch_size=LENET_B, shuffle=True, drop_last=True,
                      num_workers=workers,
                      generator=torch.Generator().manual_seed(seed))


def _host_batches(loader, n):
    """The first ``n`` batches of ``loader``, kept on the host (pinned)."""
    out = []
    for i, batch in enumerate(loader):
        if i >= n:
            break
        out.append(tuple(batch))
    return out


def _fit_state(torch, model):
    """Parameters, buffers, every optimizer slot, the step counts and
    each metric's device sums, on the host."""
    out = {f"param/{n}": p.detach().cpu()
           for n, p in model.network.named_parameters()}
    out.update({f"buffer/{n}": b.detach().cpu()
                for n, b in model.network.named_buffers()})
    for i, st in model._optimizer._state.items():
        for k, v in st.items():
            out[f"{i}/{k}"] = v if k == "steps" else v.detach().cpu()
    out["global_step"] = model._optimizer._global_step
    for j, m in enumerate(model._metrics):
        s = m._device_stat_sum()
        out[f"metric{j}"] = None if s is None else torch.from_numpy(s)
    return out


def _unequal(torch, a, b):
    """The keys on which two :func:`_fit_state` s differ, bit for bit."""
    bad = set(a) ^ set(b)
    for k in set(a) & set(b):
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape and torch.equal(x, y)):
                bad.add(k)
        elif x != y:
            bad.add(k)
    return sorted(bad)


def _fit_ms(torch, model, batches, fold):
    """``fit`` over ``batches`` synchronised only at its ends: (ms a
    step, whether it captured a graph)."""
    before = model.compile_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    model.fit(batches, epochs=1, verbose=0, steps_per_dispatch=fold)
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) * 1e3 / len(batches)
    return ms, model.compile_stats() != before


def _eval_ips(torch, model, batches):
    """Images/s of ``evaluate`` over ``batches``, synchronised at its
    ends, and its result."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res = model.evaluate(batches, verbose=0)
    torch.cuda.synchronize()
    n = sum(b[0].shape[0] for b in batches)
    return n / (time.monotonic() - t0), res


@contextlib.contextmanager
def cudnn_deterministic(torch):
    """cuDNN's deterministic algorithms (a weight gradient summed with
    atomics differs from run to run): for the bit-for-bit gates."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def train_lenet_phase(torch, seed):
    """``[train lenet]`` (module docstring, 15j)."""
    import gc
    import tempfile
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io import DataLoader, Subset
    from paddle_tpu_torch.vision.datasets import MNIST
    tag = "train lenet"
    train_ds, test_ds = MNIST(mode="train"), MNIST(mode="test")
    check(len(train_ds) == 60000 and len(test_ds) == 10000,
          f"[{tag}] MNIST sizes {len(train_ds)} / {len(test_ds)}")
    # the main path: one epoch under auto-K, evaluate, save, load, predict
    model = _lenet_model(torch, seed)
    loader = _lenet_loader(torch, train_ds, seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    model.fit(loader, epochs=1, verbose=0)
    torch.cuda.synchronize()
    epoch_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    tuner = model._fold_tuner
    check(tuner is not None and tuner.decided,
          f"[{tag}] the auto-K fit decided no K")
    check(model._optimizer._global_step == len(loader) == 937,
          f"[{tag}] {model._optimizer._global_step} steps, "
          f"{len(loader)} batches")
    train_acc = model._metrics[0].accumulate()
    res = model.evaluate(test_ds, batch_size=LENET_B, verbose=0)
    stats = model.compile_stats()
    check(stats == {"graphs": 1, "captures": 1, "eval_graphs": 2,
                    "eval_captures": 2},
          f"[{tag}] graphs {stats} (one train graph, eval at 64 and 16)")
    check(res["acc"] > LENET_MIN_ACC and np.isfinite(float(res["loss"][0])),
          f"[{tag}] evaluate {res}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "lenet")
        t0 = time.monotonic()
        model.save(path)
        save_s = time.monotonic() - t0
        sizes = [os.path.getsize(path + s) for s in (".pdparams", ".pdopt")]
        model2 = _lenet_model(torch, seed + 1)
        t0 = time.monotonic()
        model2.load(path)
        load_s = time.monotonic() - t0
    res2 = model2.evaluate(test_ds, batch_size=LENET_B, verbose=0)
    check(float(res2["loss"][0]) == float(res["loss"][0])
          and res2["acc"] == res["acc"],
          f"[{tag}] the loaded model evaluates {res2}, the first {res}")
    sub = Subset(test_ds, range(LENET_PREDICT))
    out = model.predict(sub, batch_size=LENET_B, stack_outputs=True)[0]
    out2 = model2.predict(sub, batch_size=LENET_B, stack_outputs=True)[0]
    check(out.shape == (LENET_PREDICT, 10) and np.isfinite(out).all()
          and np.array_equal(out, out2),
          f"[{tag}] predict {out.shape}, equal {np.array_equal(out, out2)}")
    pred_acc = float((out.argmax(1) == test_ds.labels[:LENET_PREDICT]).mean())
    del model2
    # K=8 against the eager route, from one start and one batch order
    batches = _host_batches(_lenet_loader(torch, train_ds, seed + 2),
                            LENET_PARITY)
    states = {}
    with cudnn_deterministic(torch):
        for fold in (8, 0):
            m = _lenet_model(torch, seed)
            m.fit(batches, epochs=1, verbose=0, steps_per_dispatch=fold)
            states[fold] = _fit_state(torch, m)
    bad = _unequal(torch, states[8], states[0])
    check(not bad and states[0]["global_step"] == LENET_PARITY,
          f"[{tag}] K=8 and eager differ in {bad[:8]}")
    # timed fits: K=1, K=8, auto-K replays of one graph, and eager
    timed = _host_batches(_lenet_loader(torch, train_ds, seed + 3),
                          LENET_TIMED)
    m = _lenet_model(torch, seed)
    m.fit(timed[:8], epochs=1, verbose=0, steps_per_dispatch=1)
    k1_ms, c1 = _fit_ms(torch, m, timed, 1)
    k8_ms, c8 = _fit_ms(torch, m, timed, 8)
    auto_ms, ca = _fit_ms(torch, m, timed, None)
    auto_k = m._fold
    check(not (c1 or c8 or ca), f"[{tag}] a capture in a timed window: "
          f"K=1 {c1}, K=8 {c8}, auto {ca}")
    prof = {k: profile_run(
        torch, tag, f"K={k}",
        lambda k=k: m.fit(timed[:LENET_PROFILE], epochs=1, verbose=0,
                          steps_per_dispatch=k),
        LENET_PROFILE, _vision_group) for k in sorted({1, auto_k})}
    idle = {k: 1 - p["busy_ms"] / (k1_ms if k == 1 else auto_ms)
            for k, p in prof.items()}
    e = _lenet_model(torch, seed)
    eager_ms, _ = _fit_ms(torch, e, timed, 0)
    eprof = profile_run(
        torch, f"{tag} eager", "eager",
        lambda: e.fit(timed[:LENET_PROFILE], epochs=1, verbose=0,
                      steps_per_dispatch=0), LENET_PROFILE, _vision_group)
    # evaluation: the captured eval step against the eager one
    ev = _host_batches(DataLoader(test_ds, batch_size=LENET_B,
                                  drop_last=True), LENET_EVAL_TIMED)
    m.evaluate(ev[:2], verbose=0)
    before = m.compile_stats()
    ev_ips, ev_res = _eval_ips(torch, m, ev)
    check(m.compile_stats() == before,
          f"[{tag}] evaluation captured in its timed window")
    m.prepare(m._optimizer, m._loss, m._metrics, jit=False)
    ev_eager_ips, ev_eager = _eval_ips(torch, m, ev)
    check(m.compile_stats() == {"graphs": 0, "captures": 0},
          f"[{tag}] the eager evaluation captured")
    del m, e
    # the loader's host time a batch
    loader_ms = {}
    for w in (0, 4):
        it = iter(_lenet_loader(torch, train_ds, seed, workers=w))
        next(it)
        t0 = time.monotonic()
        for _ in range(LENET_LOADER):
            next(it)
        loader_ms[w] = (time.monotonic() - t0) * 1e3 / LENET_LOADER
        del it
    # the prefetcher (K=1 stages onto the card): workers 4 against 0

    class Staged(Callback):
        def on_epoch_begin(self, epoch, logs=None):
            self.staged = (self.loader._stage_device is not None
                           and self.loader._fold_hint == 1)

    pre = {}
    with cudnn_deterministic(torch):
        for w in (4, 0):
            pm = _lenet_model(torch, seed)
            cb = Staged()
            cb.loader = _lenet_loader(torch, train_ds, seed + 4, workers=w)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            pm.fit(cb.loader, epochs=1, verbose=0, callbacks=[cb],
                   num_iters=LENET_PREFETCH, steps_per_dispatch=1)
            torch.cuda.synchronize()
            ips = LENET_PREFETCH * LENET_B / (time.monotonic() - t0)
            check(cb.staged, f"[{tag}] the prefetcher was off (workers {w})")
            pre[w] = (_fit_state(torch, pm), ips)
    bad = _unequal(torch, pre[4][0], pre[0][0])
    check(not bad, f"[{tag}] prefetched run with 4 workers differs from "
          f"0 workers in {bad[:8]}")
    ips = {k: LENET_B / (v * 1e-3) for k, v in
           (("1", k1_ms), ("8", k8_ms), ("auto", auto_ms), ("eager",
                                                            eager_ms))}
    print(f"[{tag}] LeNet B={LENET_B} Adam({LENET_LR}) CrossEntropyLoss "
          f"Accuracy() on MNIST (synthetic fallback, 60000 / 10000): one "
          f"epoch under auto-K {epoch_s:.3f} s ({937 * LENET_B / epoch_s:.1f}"
          f" images/s, loader in the loop), decision {tuner.decision}, "
          f"train acc {train_acc:.5f}; evaluate loss "
          f"{float(res['loss'][0]):.6f} acc {res['acc']:.5f} (> "
          f"{LENET_MIN_ACC}); the loaded model's equal; predict "
          f"{LENET_PREDICT} images acc {pred_acc:.5f}; .pdparams "
          f"{sizes[0]} B, .pdopt {sizes[1]} B, save {save_s:.4f} s, load "
          f"{load_s:.4f} s; peak_mem_gib {peak / 2**30:.4f}", flush=True)
    print(f"[{tag}] K=8 and eager bit-equal over {LENET_PARITY} steps "
          f"(parameters, moments, beta powers, step counts, the Accuracy "
          f"sums); ms a step over {LENET_TIMED}: K=1 {k1_ms:.4f} "
          f"({ips['1']:.1f} images/s, idle {idle[1]:.4f}), K=8 "
          f"{k8_ms:.4f} ({ips['8']:.1f}), auto-K (K={auto_k}) "
          f"{auto_ms:.4f} ({ips['auto']:.1f}, idle {idle[auto_k]:.4f}), "
          f"eager {eager_ms:.4f} ({ips['eager']:.1f}, idle "
          f"{1 - eprof['busy_ms'] / eager_ms:.4f}); device busy "
          f"{prof[1]['busy_ms']:.4f} ms a step; no capture in the timed "
          f"windows", flush=True)
    print(f"[{tag}] evaluate {LENET_EVAL_TIMED} x {LENET_B}: captured "
          f"{ev_ips:.1f} images/s (loss {float(ev_res['loss'][0]):.6f}), "
          f"eager {ev_eager_ips:.1f} (loss "
          f"{float(ev_eager['loss'][0]):.6f}); loader host ms a batch "
          f"workers 0 {loader_ms[0]:.4f}, 4 {loader_ms[4]:.4f}; K=1 with "
          f"the prefetcher over {LENET_PREFETCH} steps: workers 4 "
          f"{pre[4][1]:.1f} images/s, 0 {pre[0][1]:.1f}, end states "
          f"bit-equal", flush=True)
    return {"epoch_s": epoch_s, "k1_ms": k1_ms, "k8_ms": k8_ms,
            "auto_ms": auto_ms, "auto_k": auto_k, "eager_ms": eager_ms,
            "idle": idle, "eval_ips": ev_ips, "eval_eager_ips": ev_eager_ips,
            "loader_ms": loader_ms, "acc": res["acc"], "peak": peak}


def _resnet_fit_batches(torch, seed, n, b=RESNET_B):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.random((b, 3, RESNET_SIZE, RESNET_SIZE), dtype=np.float32)
        y = rng.integers(0, RESNET_CLASSES, (b,)).astype(np.int64)
        out.append((torch.from_numpy(x).pin_memory(),
                    torch.from_numpy(y).pin_memory()))
    return out


def _logits_recorder(torch, n):
    """A device metric whose stat is the step's logits (fp32, flat), so a
    captured step hands each step's logits to the callbacks."""
    from paddle_tpu_torch.metric import Metric

    class Logits(Metric):
        supports_device_update = True

        def __init__(self):
            self.reset()

        def device_batch_stats(self):
            return lambda pred, label: pred.detach().float().reshape(-1)

        def device_acc_init(self, device="cpu"):
            return torch.zeros(n, device=device)

        def _stat_result(self, stat):
            return stat

        def reset(self):
            self._reset_device_state()

        def accumulate(self):
            return 0.0

        def name(self):
            return "logits"

    return Logits()


def _topk_recount(logits, labels, k):
    """Rows whose label is among the ``k`` largest logits: (certain,
    ambiguous), ambiguous where logits equal to the label's straddle the
    k-th place, so that the ranking's tie order decides."""
    lab = logits[np.arange(len(labels)), labels]
    greater = (logits > lab[:, None]).sum(1)
    equal = (logits == lab[:, None]).sum(1) - 1
    certain = int((greater + equal < k).sum())
    ambiguous = int(((greater < k) & (greater + equal >= k)).sum())
    return certain, ambiguous


def train_resnet50_fit_phase(torch, seed):
    """``[train resnet50 fit]`` (module docstring, 15k)."""
    import gc
    import tempfile
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.vision.datasets import SyntheticImages
    tag = "train resnet50 fit"
    batches = _resnet_fit_batches(torch, seed + 7, RESNET_FIT_STEPS)
    # half of each batch's labels are the starting network's top-1 (train
    # mode, O2), so that the counts below are not near 0 as with random
    # labels over 1000 classes
    import paddle_tpu_torch as paddle
    net, model = _resnet50_model(torch, seed)
    with torch.no_grad(), paddle.amp.auto_cast(level="O2",
                                               dtype="bfloat16"):
        for x, y in batches:
            top = net(x.cuda()).float().argmax(1).cpu()
            y[:RESNET_B // 2] = top[:RESNET_B // 2]
    del net, model

    def free(model):
        model.release_graphs()
        gc.collect()
        torch.cuda.empty_cache()

    # Accuracy(topk=(1, 5)) in the graph, against a host recount of the
    # same steps' logits (handed out by a recorder metric)
    rec = _logits_recorder(torch, RESNET_B * RESNET_CLASSES)
    net, model = _resnet50_model(torch, seed,
                                 metrics=[Accuracy(topk=(1, 5)), rec])

    class Keep(Callback):
        def __init__(self):
            super().__init__()
            self.rows = []

        def on_train_batch_end(self, step, logs=None):
            self.rows.append(np.asarray(logs["logits"]).reshape(
                RESNET_B, RESNET_CLASSES))

    keep = Keep()
    model.fit(batches, epochs=1, verbose=0, callbacks=[keep],
              steps_per_dispatch=4)
    dev = model._metrics[0]._device_stat_sum()
    labels = [b[1].numpy() for b in batches]
    amb = {}
    for j, k in enumerate((1, 5)):
        parts = [_topk_recount(lg, lb, k) for lg, lb in zip(keep.rows,
                                                             labels)]
        certain = sum(p[0] for p in parts)
        amb[k] = sum(p[1] for p in parts)
        check(certain <= dev[j] <= certain + amb[k],
              f"[{tag}] top-{k} count {dev[j]} outside the host recount "
              f"[{certain}, {certain + amb[k]}]")
    check(dev[-1] == RESNET_FIT_STEPS * RESNET_B and len(keep.rows) ==
          RESNET_FIT_STEPS, f"[{tag}] rows {dev[-1]}, steps "
          f"{len(keep.rows)}")
    free(model)
    del net, model
    # the metric's cost: ms a step with and without it (K=8 replays)
    ms, busy_ms = {}, {}
    for name, metrics in (("with Accuracy", [Accuracy(topk=(1, 5))]),
                          ("without", None)):
        net, model = _resnet50_model(torch, seed, metrics=metrics)
        model.fit(batches, epochs=1, verbose=0, steps_per_dispatch=8)
        ms[name], cap = _fit_ms(torch, model, batches * 2, 8)
        check(not cap, f"[{tag}] a capture in the timed window")
        busy_ms[name] = profile_run(
            torch, f"{tag} {name}", "replayed",
            lambda: model.fit(batches, epochs=1, verbose=0,
                              steps_per_dispatch=8),
            RESNET_FIT_STEPS, _vision_group)["busy_ms"]
        if metrics:
            acc_model = (net, model)
        else:
            free(model)
        del net, model
    busy = busy_ms["without"]
    # evaluation: captured against eager
    net, model = acc_model
    evb = batches[:RESNET_EVAL]
    model.evaluate(evb, verbose=0)
    before = model.compile_stats()
    ev_ips, ev_res = _eval_ips(torch, model, evb)
    check(model.compile_stats() == before and before["eval_graphs"] == 1,
          f"[{tag}] evaluation graphs {before} -> {model.compile_stats()}")
    model.prepare(model._optimizer, model._loss, model._metrics,
                  amp_configs={"level": "O2", "dtype": "bfloat16"},
                  jit=False)
    ev_eager_ips, ev_eager = _eval_ips(torch, model, evb)
    free(model)
    del net, model
    del acc_model
    with cudnn_deterministic(torch):
        # accumulate_grad_batches=4 at B=16 against B=64 on the concatenation
        full = batches[:RESNET_CKPT]
        micro = [(x[i:i + RESNET_MICRO], y[i:i + RESNET_MICRO])
                 for x, y in full for i in range(0, RESNET_B, RESNET_MICRO)]
        states = {}
        for name, data, k in (("accumulate", micro, 4), ("full", full, 1)):
            net, model = _resnet50_model(torch, seed)
            model.fit(data, epochs=1, verbose=0, accumulate_grad_batches=k,
                      steps_per_dispatch=1)
            states[name] = _fit_state(torch, model)
            free(model)
            del net, model
        bad = _unequal(torch, states["accumulate"], states["full"])
        check(not bad and states["full"]["global_step"] == RESNET_CKPT,
              f"[{tag}] accumulate_grad_batches=4 at B={RESNET_MICRO} "
              f"differs from B={RESNET_B} in {bad[:8]}")
        del states
        # save after 3 steps, 2 steps that move everything, load into the
        # same captured model, 3 more replays; against 6 uninterrupted
        net, model = _resnet50_model(torch, seed)
        first, later = batches[:RESNET_CKPT], batches[RESNET_CKPT:
                                                      2 * RESNET_CKPT]
        model.fit(first, epochs=1, verbose=0, steps_per_dispatch=1)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "resnet50")
            torch.cuda.synchronize()
            t0 = time.monotonic()
            model.save(path)
            save_s = time.monotonic() - t0
            sizes = [os.path.getsize(path + s)
                     for s in (".pdparams", ".pdopt")]
            model.fit(batches[-2:], epochs=1, verbose=0,
                      steps_per_dispatch=1)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            model.load(path)
            torch.cuda.synchronize()
            load_s = time.monotonic() - t0
        model.fit(later, epochs=1, verbose=0, steps_per_dispatch=1)
        resumed = _fit_state(torch, model)
        graphs = model.compile_stats()
        free(model)
        del net, model
        net, model = _resnet50_model(torch, seed)
        model.fit(first + later, epochs=1, verbose=0, steps_per_dispatch=1)
        straight = _fit_state(torch, model)
        free(model)
        del net, model
    bad = _unequal(torch, resumed, straight)
    check(not bad and graphs == {"graphs": 1, "captures": 1},
          f"[{tag}] resumed run differs in {bad[:8]}; graphs {graphs}")
    del resumed, straight
    # the host loader over SyntheticImages at workers 0 and 4 (K=1, the
    # prefetcher staging onto the card)
    ds = SyntheticImages(num_samples=RESNET_LOADER_STEPS * RESNET_B,
                         image_shape=(3, RESNET_SIZE, RESNET_SIZE),
                         num_classes=RESNET_CLASSES, seed=seed)
    net, model = _resnet50_model(torch, seed)
    # the loader's labels are [B, 1]: capture that signature first
    model.fit(DataLoader(ds, batch_size=RESNET_B), epochs=1, verbose=0,
              num_iters=2, steps_per_dispatch=1)
    loader_ips = {}
    for w in (0, 4):
        loader = DataLoader(ds, batch_size=RESNET_B, num_workers=w)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        model.fit(loader, epochs=1, verbose=0, steps_per_dispatch=1)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / RESNET_LOADER_STEPS
        loader_ips[w] = (RESNET_B / (wall_ms * 1e-3), 1 - busy / wall_ms)
    graphs = model.compile_stats()
    check(graphs == {"graphs": 1, "captures": 1},
          f"[{tag}] loader fits captured again: {graphs}")
    free(model)
    del net, model
    print(f"[{tag}] ResNet-50 B={RESNET_B} {RESNET_SIZE}x{RESNET_SIZE} bf16 "
          f"O2 Momentum(0.1, 0.9, multi_precision): Accuracy(topk=(1, 5)) "
          f"in the graph over {RESNET_FIT_STEPS} steps counts top-1 "
          f"{dev[0]:.0f}, top-5 {dev[1]:.0f} of {dev[2]:.0f} rows, within "
          f"the host recount (rows with ties at the k-th place: top-1 "
          f"{amb[1]}, top-5 {amb[5]}); K=8 ms a step with it "
          f"{ms['with Accuracy']:.4f}, without {ms['without']:.4f}; device "
          f"busy with it {busy_ms['with Accuracy']:.4f}, without "
          f"{busy:.4f} (the metric "
          f"{busy_ms['with Accuracy'] - busy:.4f} ms); evaluate "
          f"{RESNET_EVAL} batches captured {ev_ips:.1f} images/s, eager "
          f"{ev_eager_ips:.1f}", flush=True)
    print(f"[{tag}] accumulate_grad_batches=4 at B={RESNET_MICRO} "
          f"bit-equal to B={RESNET_B} over {RESNET_CKPT} steps; save after "
          f"{RESNET_CKPT}, 2 steps, load into the captured model, "
          f"{RESNET_CKPT} replays bit-equal to {2 * RESNET_CKPT} straight "
          f"(cuDNN deterministic), no new capture; .pdparams {sizes[0]} B, "
          f".pdopt {sizes[1]} B, save {save_s:.3f} s, load {load_s:.3f} s; "
          f"SyntheticImages loader, K=1, {RESNET_LOADER_STEPS} steps: "
          f"workers 0 {loader_ips[0][0]:.1f} images/s (idle "
          f"{loader_ips[0][1]:.4f}), workers 4 {loader_ips[4][0]:.1f} "
          f"(idle {loader_ips[4][1]:.4f}) against a replayed device busy "
          f"of {busy:.3f} ms a step", flush=True)
    return {"ms": ms, "busy_ms": busy_ms, "eval_ips": ev_ips,
            "eval_eager_ips": ev_eager_ips,
            "sizes": sizes, "save_s": save_s, "load_s": load_s,
            "loader": loader_ips}


# -- ERNIE pretraining as PaddleNLP sets it up (slice 18) ------------------

ERNIE_SCHED_STEPS = 20           # [train ernie sched] / [... fp16 scaler]
ERNIE_SAVE_AT = 10               # [train ernie sched]: the checkpoint's step
ERNIE_WARMUP, ERNIE_DECAY = 4, 16    # the schedule cut to the 20 steps:
ERNIE_PEAK_LR, ERNIE_END_LR = 1e-4, 1e-5  # warmup, then the linear decay
ERNIE_NO_DECAY = ("bias", "norm", "ln")   # PaddleNLP's "bias"/"norm", and
                                 # this BERT's LayerNorm names ln1/ln2/_ln
ERNIE_NORM_RTOL = 1e-5           # the clip's global norm vs float64
SCALER_TIMED = 12                # [train ernie fp16 scaler]: the timed loop
SCALER_INITS = (32768.0, 2.0 ** 24, 2.0 ** 32)   # [train ernie fp16
                                 # scaler]: PaddleNLP's, then two that
                                 # overflow (the last must)
OPT_STEPS, OPT_FIT_STEPS = 3, 6  # [optimizers]: card vs CPU, fit K=1/eager
OPT_TOL = 1e-6                   # x max(|ref|, 1), fp32, card vs CPU


def _ernie_pretrain_model(torch, seed, dtype="bfloat16", device="cuda"):
    """ERNIE-3.0-base MLM from ``seed`` (dropout 0), O2 in ``dtype``, and
    PaddleNLP's pretraining optimizer: AdamW(0.9, 0.999, 1e-8, decay
    0.01 on the parameters whose structured name holds none of
    ERNIE_NO_DECAY, by ``p.name``), ClipGradByGlobalNorm(1.0),
    multi_precision, LinearWarmup(PolynomialDecay) cut to the phase."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import BertForPretraining, ernie_3_base
    cfg = ernie_3_base(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    net = BertForPretraining(cfg, device=device, generator=gen)
    decay = {p.name for n, p in net.named_parameters()
             if not any(nd in n for nd in ERNIE_NO_DECAY)}
    lr = paddle.optimizer.lr
    sched = lr.LinearWarmup(
        lr.PolynomialDecay(ERNIE_PEAK_LR, ERNIE_DECAY, end_lr=ERNIE_END_LR,
                           power=1.0), ERNIE_WARMUP, 0.0, ERNIE_PEAK_LR)
    opt = paddle.optimizer.AdamW(
        learning_rate=sched, beta1=0.9, beta2=0.999, epsilon=1e-8,
        parameters=net.parameters(), weight_decay=0.01,
        apply_decay_param_fun=lambda name: name in decay,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0), multi_precision=True)
    paddle.amp.decorate(net, opt, level="O2", dtype=dtype)
    return cfg, net, opt, sched


def _ernie_batches(torch, vocab, seed):
    return [tuple(t.pin_memory() for t in
                  _mlm_batch(torch, vocab, ERNIE_B, ERNIE_S, seed + 40 + i))
            for i in range(ERNIE_SCHED_STEPS)]


def _pretrain_state(torch, opt, net):
    """Parameters, every optimizer slot (masters, moments, beta powers),
    the step counts and the scheduler's epochs (the inner scheduler's
    too), cloned on the card."""
    out = {f"param {n}": p.detach().clone()
           for n, p in net.named_parameters()}
    for i, st in opt._state.items():
        for k, v in st.items():
            out[f"{i} {k}"] = (v.detach().clone()
                               if isinstance(v, torch.Tensor) else v)
    out["global_step"] = opt._global_step
    sched = opt._learning_rate
    out["last_epoch"] = (getattr(sched, "last_epoch", None), getattr(
        getattr(sched, "lr_after", None), "last_epoch", None))
    return out


CLIP_NORM_KERNELS = ("NormTwo", "LpNorm")   # the clip's norms: per-tensor
                                 # reductions, or the foreach kernel where
                                 # a list is of one dtype


def _pretrain_group(name):
    """Profile groups of the pretraining step: the global-norm clip's
    norms apart from the optimizer's foreach kernels (its fp32 widening
    and rounding copies stay among the elementwise kernels)."""
    if any(k in name for k in CLIP_NORM_KERNELS):
        return "clip norms"
    return _kernel_group(name)


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` for
    the block, then the previous setting; yields the warnings the block
    raised.  ``warn_only``: PyTorch decides once per process whether
    ``CUBLAS_WORKSPACE_CONFIG`` is deterministic, at the first cuBLAS
    call, before this script's later phases could set it."""
    import warnings
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            yield caught
        finally:
            torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def _grad_norm_check(torch, tag, cfg, net, opt, batch):
    """The clip's global norm over the bf16 gradients of step 1 (the
    start's weights, batch 0) against a float64 recompute of the same
    gradients, and the clip alone timed by events; the gradients are
    dropped after."""
    from paddle_tpu_torch.models import BertPretrainingCriterion
    x, labels = (t.cuda() for t in batch)
    BertPretrainingCriterion(cfg.vocab_size)(*net(x), labels).backward()
    grads = [p.grad for p in net.parameters() if p.grad is not None]
    clip = opt._grad_clip
    norm = clip.global_norm(grads).item()
    ref = float(np.sqrt(sum(g.double().square().sum().item()
                            for g in grads)))
    rel = abs(norm - ref) / ref
    check(rel <= ERNIE_NORM_RTOL, f"[{tag}] global norm {norm} vs float64 "
          f"{ref} (relative {rel:.3e} > {ERNIE_NORM_RTOL})")
    clip_ms = device_ms(torch, lambda: clip.pure_clip(grads), 10,
                        {"clip": (), "norms": CLIP_NORM_KERNELS})
    dtypes = sorted({str(g.dtype) for g in grads})
    n_el = sum(g.numel() for g in grads)
    for p in net.parameters():
        p.grad = None
    return {"norm": norm, "ref": ref, "rel": rel, "clip_ms": clip_ms,
            "tensors": len(grads), "elements": n_el, "dtypes": dtypes}


def ernie_sched_phase(torch, seed, base):
    """``[train ernie sched]`` (module docstring, 15l).  ``base`` is
    ``[train ernie bh]``'s result, whose step ms is printed beside."""
    import gc
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.hapi.callbacks import Callback, LRSchedulerCallback
    from paddle_tpu_torch.models import BertPretrainingCriterion
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    from paddle_tpu_torch.ops import lmce_kernel as lk
    tag = "train ernie sched"
    vocab = 40000
    batches = _ernie_batches(torch, vocab, seed)

    class Rates(Callback):
        """The rate each step ran at (before the scheduler steps)."""

        def __init__(self, opt):
            super().__init__()
            self.opt, self.rates = opt, []

        def on_train_batch_end(self, step, logs=None):
            self.rates.append(self.opt.get_lr())

    class Saver(Callback):
        """``model.save`` after the ``at``-th step (after the scheduler
        stepped, as PaddleNLP saves)."""

        def __init__(self, at, path):
            super().__init__()
            self.at, self.path = at, path

        def on_train_batch_end(self, step, logs=None):
            if self.path is not None and step + 1 == self.at:
                self.model.save(self.path)

    def run(fold, data, save=None, load=None, patch=None, norm=False):
        gc.collect()
        torch.cuda.empty_cache()
        cfg, net, opt, sched = _ernie_pretrain_model(torch, seed)
        model = paddle.Model(net, device="cuda")
        model.prepare(opt, BertPretrainingCriterion(cfg.vocab_size))
        extra = {}
        if norm:
            extra["norm"] = _grad_norm_check(torch, tag, cfg, net, opt,
                                             data[0])
        if load is not None:
            model.load(load)
        if patch is not None:
            patch(opt)
        clock, rates = _step_clock(torch), Rates(opt)
        torch.cuda.reset_peak_memory_stats()
        fk.reset_counts()
        lk.reset_counts()
        model.fit(data, epochs=1, verbose=0, steps_per_dispatch=fold,
                  callbacks=[clock, rates,
                             LRSchedulerCallback(by_step=True, by_epoch=False),
                             Saver(ERNIE_SAVE_AT, save)])
        torch.cuda.synchronize()
        extra.update(launches=launch_table(fk, lk), plain={
            f.__name__: f.plain_calls for f in fk.ALL_WRAPPERS + lk.WRAPPERS},
            peak=torch.cuda.max_memory_allocated(),
            graphs=model.compile_stats(), fold=model._fold)
        steps_ms = np.diff(clock.stamps) * 1e3
        return dict(model=model, net=net, opt=opt, sched=sched,
                    state=_pretrain_state(torch, opt, net),
                    losses=clock.losses, rates=rates.rates,
                    step_ms=float(np.median(steps_ms[2:])), **extra)

    # the main path as a user runs it: Model.fit at K=1 (a by-step
    # scheduler), a replay of the captured step a step with the rate
    # refreshed before it; timed, counted and profiled
    t = run(None, batches, norm=True)
    want = _want_launches(ERNIE_SCHED_STEPS * 12)
    check(t["launches"] == want, f"[{tag}] launches {t['launches']}, "
          f"expected {want}")
    check(not any(t["plain"].values()), f"[{tag}] plain {t['plain']}")
    check(t["fold"] == 1 and t["graphs"] == {"graphs": 1, "captures": 1},
          f"[{tag}] fold {t['fold']} graphs {t['graphs']}")
    check(all(np.isfinite(t["losses"])), f"[{tag}] losses {t['losses']}")
    sched_rates = [0.0] + [ERNIE_PEAK_LR * k / ERNIE_WARMUP
                           for k in range(1, ERNIE_WARMUP)]
    sched_rates += [(ERNIE_PEAK_LR - ERNIE_END_LR) *
                    (1 - min(k, ERNIE_DECAY) / ERNIE_DECAY) + ERNIE_END_LR
                    for k in range(ERNIE_SCHED_STEPS - ERNIE_WARMUP)]
    check(np.allclose(t["rates"], sched_rates, rtol=1e-12, atol=0),
          f"[{tag}] rates {t['rates']} vs {sched_rates}")
    lr_dev = [v.item() for v in t["opt"]._lr_dev.values()]
    check(lr_dev == [np.float32(t["rates"][-1])],
          f"[{tag}] the device rate {lr_dev} vs the last step's "
          f"{t['rates'][-1]}")
    prof = profile_run(
        torch, tag, "replayed", lambda: t["model"].fit(
            [batches[0]] * 2, epochs=1, verbose=0, steps_per_dispatch=2),
        2, group=_pretrain_group)
    free_model(torch, tag, t.pop("model"))
    del t["net"], t["opt"], t["state"]
    # the gates, under torch.use_deterministic_algorithms: PyTorch's CUDA
    # embedding backward sums the token-type table (every id 0) in an
    # order that changes from run to run, and the global-norm clip
    # carries that last bit into every parameter's update, so two eager
    # runs part within a few steps; its deterministic form makes runs
    # repeatable (the flash kernels and cuBLAS are in either mode)
    with deterministic_algorithms(torch) as warned, \
            tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "ernie")
        a = run(None, batches, save=ckpt)
        free_model(torch, tag, a.pop("model"))
        del a["net"], a["opt"]
        b = run(0, batches)
        free_model(torch, tag, b.pop("model"))
        del b["net"], b["opt"]
        same = _states_equal(torch, a["state"], b["state"])
        diff = _state_diff(torch, b["state"], a["state"])
        check(same and a["losses"] == b["losses"],
              f"[{tag}] replays vs eager: largest |diff|/max(|ref|,1) "
              f"{diff:.3e}, losses {a['losses']} vs {b['losses']}")
        # resumed from the step-10 checkpoint into a fresh captured model
        c = run(None, batches[ERNIE_SAVE_AT:], load=ckpt)
        free_model(torch, tag, c.pop("model"))
        del c["net"], c["opt"]
        check(_states_equal(torch, a["state"], c["state"]) and
              c["losses"] == a["losses"][ERNIE_SAVE_AT:] and
              c["rates"] == a["rates"][ERNIE_SAVE_AT:],
              f"[{tag}] resumed run vs straight: largest diff "
              f"{_state_diff(torch, a['state'], c['state']):.3e}")
        ckpt_sizes = [os.path.getsize(ckpt + s)
                      for s in (".pdparams", ".pdopt")]
        del c

        # two controls, patched in here, must fail the gate

        def frozen_rate(opt):
            opt.refresh_lr = lambda: None

        def no_clip(opt):
            opt._grad_clip = None

        controls = {}
        for name, patch in (("refresh_lr writes nothing", frozen_rate),
                            ("the clip left out", no_clip)):
            r = run(None, batches, patch=patch)
            free_model(torch, tag, r.pop("model"))
            check(not _states_equal(torch, b["state"], r["state"]),
                  f"[{tag}] control '{name}' passed the gate")
            controls[name] = _state_diff(torch, b["state"], r["state"])
            del r
    warned = sorted({str(w.message)[:120] for w in warned})
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(t["losses"],
                                                        a["losses"]))
    gc.collect()
    torch.cuda.empty_cache()
    n = t["norm"]
    print(f"[{tag}] ERNIE-3.0-base L=12 D=768 H=12 V=40000 B={ERNIE_B} "
          f"S={ERNIE_S} bf16 O2, MLM 15%, PaddleNLP's setting: AdamW(0.9, "
          f"0.999, 1e-8, decay 0.01 off biases and norms), "
          f"ClipGradByGlobalNorm(1.0), LinearWarmup(PolynomialDecay("
          f"{ERNIE_PEAK_LR}, {ERNIE_DECAY}, end_lr={ERNIE_END_LR}), "
          f"{ERNIE_WARMUP}, 0, {ERNIE_PEAK_LR}) (the schedule cut to the "
          f"phase's {ERNIE_SCHED_STEPS} steps; widths not cut), "
          f"LRSchedulerCallback(by_step=True): {ERNIE_SCHED_STEPS} steps at "
          f"steps_per_dispatch={t['fold']} ({t['graphs']})", flush=True)
    print(f"[{tag}] rate a step: "
          + ", ".join(f"{r:.4g}" for r in t["rates"]), flush=True)
    print(f"[{tag}] losses: " + ", ".join(f"{v:.6f}" for v in t["losses"]),
          flush=True)
    print(f"[{tag}] step 1's global norm {n['norm']:.9g} vs float64 "
          f"{n['ref']:.9g} over the {n['tensors']} gradients "
          f"({n['elements']} elements, {n['dtypes']}): relative "
          f"{n['rel']:.3e} (tol {ERNIE_NORM_RTOL}); the clip alone "
          f"{n['clip_ms']['clip']:.4f} ms of device time, its norms "
          f"{n['clip_ms']['norms']:.4f} (torch.profiler)", flush=True)
    print(f"[{tag}] under torch.use_deterministic_algorithms (warnings "
          f"{warned}): replays vs the eager route: end states (parameters, "
          f"masters, moments, beta powers, step counts, scheduler epochs) "
          f"and losses bit-equal; resumed from the step-{ERNIE_SAVE_AT} "
          f"checkpoint (.pdparams {ckpt_sizes[0]} B, .pdopt {ckpt_sizes[1]} "
          f"B) into a fresh captured model, "
          f"{ERNIE_SCHED_STEPS - ERNIE_SAVE_AT} steps bit-equal to the straight run; its losses vs the default "
          f"mode's: largest relative diff {loss_rel:.3e}", flush=True)
    print(f"[{tag}] controls fail the gates (largest |diff|/max(|ref|,1) "
          f"from the eager route): " + "; ".join(
              f"{k}: {v:.3e}" for k, v in controls.items()), flush=True)
    tok_s = ERNIE_B * ERNIE_S / (t["step_ms"] * 1e-3)
    print(f"[{tag}] step_ms median(steps 3+) replayed {t['step_ms']:.3f} "
          f"vs [train ernie bh] {base['step_ms']:.3f} ({tok_s:.1f} "
          f"tokens/s); deterministic mode: "
          f"replayed {a['step_ms']:.3f}, eager {b['step_ms']:.3f}; "
          f"peak_mem_gib {t['peak'] / 2**30:.3f}; launches "
          f"{t['launches']}", flush=True)
    return {"launches": t["launches"], "losses": t["losses"],
            "step_ms": t["step_ms"], "det_ms": a["step_ms"],
            "eager_ms": b["step_ms"], "peak": t["peak"], "norm": n,
            "profile": prof, "controls": controls}


def ernie_scaler_phase(torch, seed, base):
    """``[train ernie fp16 scaler]`` (module docstring, 15m).  ``base``
    is ``[train ernie sched]``'s result (bf16, same weights and first
    batch)."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import BertPretrainingCriterion
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    from paddle_tpu_torch.ops import lmce_kernel as lk
    tag = "train ernie fp16 scaler"
    vocab = 40000
    batches = _ernie_batches(torch, vocab, seed)
    base_first = base["losses"][0]
    out = {}
    for init in SCALER_INITS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg, net, opt, sched = _ernie_pretrain_model(torch, seed,
                                                     dtype="float16")
        crit = BertPretrainingCriterion(cfg.vocab_size)
        scaler = paddle.amp.GradScaler(init_loss_scaling=init)
        losses, skipped, scales = [], [], []
        fk.reset_counts()
        lk.reset_counts()
        for step, (x, labels) in enumerate(batches):
            before = _pretrain_state(torch, opt, net) if step else None
            scale, taken = scaler._scale, opt._global_step
            x, labels = x.cuda(non_blocking=True), labels.cuda(
                non_blocking=True)
            with paddle.amp.auto_cast(level="O2", dtype="float16"):
                outs = net(x)
            loss = crit(*outs, labels)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            sched.step()
            losses.append(float(loss.detach()))
            skipped.append(opt._global_step == taken)   # step() not called
            scales.append(scaler._scale)
            if skipped[-1]:
                check(scaler._scale == max(scale * 0.5, 1.0),
                      f"[{tag}] step {step}: scale {scale} -> "
                      f"{scaler._scale} on a skip")
                if before is not None:
                    after = _pretrain_state(torch, opt, net)
                    del after["last_epoch"], before["last_epoch"]
                    check(_states_equal(torch, before, after),
                          f"[{tag}] step {step} skipped but the state moved")
                else:
                    check(not opt._state and opt._global_step == 0,
                          f"[{tag}] a skipped first step made state")
            del before
        launches = launch_table(fk, lk)
        plain = {f.__name__: f.plain_calls
                 for f in fk.ALL_WRAPPERS + lk.WRAPPERS}
        want = _want_launches(ERNIE_SCHED_STEPS * 12)
        check(launches == want, f"[{tag}] init {init}: launches {launches},"
              f" expected {want}")
        check(not any(plain.values()), f"[{tag}] plain calls {plain}")
        check(all(np.isfinite(losses)), f"[{tag}] losses {losses}")
        taken = skipped.count(False)
        check(taken > 0 and opt._global_step == taken,
              f"[{tag}] init {init}: {taken} steps taken, global_step "
              f"{opt._global_step}")
        dtypes = {p.dtype for p in net.parameters()}
        check(dtypes == {torch.float16, torch.float32},
              f"[{tag}] O2 parameter dtypes {dtypes}")
        rel = abs(losses[0] - base_first) / abs(base_first)
        check(rel <= FP16_FIRST_LOSS_TOL,
              f"[{tag}] first loss {losses[0]} vs bf16 {base_first} "
              f"(relative {rel:.3e} > {FP16_FIRST_LOSS_TOL})")
        out[init] = {"losses": losses, "skipped": skipped, "scales": scales,
                     "launches": launches, "rel": rel}
        print(f"[{tag}] init_loss_scaling={init:g}: {ERNIE_SCHED_STEPS} "
              f"eager steps (auto_cast O2 fp16, scaler.scale(loss)."
              f"backward(); scaler.step(opt); scaler.update(); "
              f"opt.clear_grad()); skipped steps "
              f"{[i for i, s in enumerate(skipped) if s]}, each leaving "
              f"every parameter, master, moment, beta power and step count "
              f"bit-unchanged and halving the scale; scale after each step "
              f"{[f'{s:g}' for s in scales]}", flush=True)
        print(f"[{tag}] init_loss_scaling={init:g}: losses "
              + ", ".join(f"{v:.6f}" for v in losses)
              + f"; first loss vs bf16 {base_first:.6f}: relative "
              f"{rel:.3e} (tol {FP16_FIRST_LOSS_TOL}); fp16 launches "
              f"{launches}", flush=True)
        del net, opt, sched, scaler
    check(any(out[SCALER_INITS[-1]]["skipped"]),
          f"[{tag}] no step overflowed from {SCALER_INITS[-1]:g}")
    # the loop timed alone from PaddleNLP's scale: no snapshot and no
    # loss read, so the scaler's found_inf is the one host read a step
    gc.collect()
    torch.cuda.empty_cache()
    cfg, net, opt, sched = _ernie_pretrain_model(torch, seed, dtype="float16")
    scaler = paddle.amp.GradScaler(init_loss_scaling=SCALER_INITS[0])
    torch.cuda.reset_peak_memory_stats()
    for step, (x, labels) in enumerate(batches[:SCALER_TIMED]):
        if step == 2:
            torch.cuda.synchronize()
            t0 = time.monotonic()
        x, labels = x.cuda(non_blocking=True), labels.cuda(non_blocking=True)
        with paddle.amp.auto_cast(level="O2", dtype="float16"):
            outs = net(x)
        scaler.scale(crit(*outs, labels)).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        sched.step()
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / (SCALER_TIMED - 2)
    peak = torch.cuda.max_memory_allocated()
    del net, opt, sched, scaler
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] timed alone from {SCALER_INITS[0]:g}: {step_ms:.3f} ms "
          f"a step over steps 3-{SCALER_TIMED} (one host read a step, the "
          f"scaler's), against bf16 [train ernie sched] replayed "
          f"{base['step_ms']:.3f} and eager {base['eager_ms']:.3f} "
          f"(deterministic mode); peak_mem_gib {peak / 2**30:.3f}",
          flush=True)
    out["step_ms"], out["peak"] = step_ms, peak
    return out


def _opt_cases(paddle):
    """[optimizers]: each update rule with its settings (the rate a
    StepDecay under fit), the lambdas building a fresh one."""
    lr = paddle.optimizer.lr
    o = paddle.optimizer
    clip = paddle.nn.ClipGradByGlobalNorm

    def sched(v):
        return lr.StepDecay(v, step_size=2, gamma=0.5)

    return {
        "SGD": lambda ps, f: o.SGD(f(0.1), parameters=ps, weight_decay=0.01),
        "Momentum nesterov": lambda ps, f: o.Momentum(
            f(0.1), 0.8, parameters=ps, use_nesterov=True,
            weight_decay=0.01),
        "Adam amsgrad": lambda ps, f: o.Adam(f(0.01), parameters=ps,
                                             amsgrad=True),
        "AdamW decay fn, clip": lambda ps, f: o.AdamW(
            f(0.01), parameters=ps, weight_decay=0.1,
            apply_decay_param_fun=lambda n: n != ps[1].name,
            grad_clip=clip(1.0)),
        "Adagrad": lambda ps, f: o.Adagrad(f(0.1), parameters=ps,
                                           weight_decay=0.01,
                                           initial_accumulator_value=0.1),
        "RMSProp": lambda ps, f: o.RMSProp(f(0.01), parameters=ps,
                                           weight_decay=0.01),
        "RMSProp centered": lambda ps, f: o.RMSProp(
            f(0.01), parameters=ps, centered=True, momentum=0.9),
        "Lamb": lambda ps, f: o.Lamb(f(0.01), lamb_weight_decay=0.1,
                                     parameters=ps,
                                     exclude_from_weight_decay_fn=(
                                         lambda n: n == ps[1].name)),
        "Adadelta": lambda ps, f: o.Adadelta(f(1.0), parameters=ps,
                                             weight_decay=0.01),
        "Adamax": lambda ps, f: o.Adamax(f(0.01), parameters=ps,
                                         weight_decay=0.01),
    }, sched


def optimizers_phase(torch, seed):
    """``[optimizers]`` (module docstring, 15n)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.hapi.callbacks import LRSchedulerCallback
    tag = "optimizers"
    rng = np.random.default_rng(seed + 60)
    shapes = [(256, 512), (512,), (512, 64), (64,)]
    w0 = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * sc).astype(np.float32)
              for s in shapes] for sc in (1.0, 1e-3, 0.3)]
    cases, sched = _opt_cases(paddle)
    errs = {}
    for name, make in cases.items():
        ends = {}
        for dev in ("cuda", "cpu"):
            ps = [nn.Parameter(torch.from_numpy(w).to(dev), name=f"w{i}")
                  for i, w in enumerate(w0)]
            opt = make(ps, lambda v: v)
            for k in range(OPT_STEPS):
                for p, g in zip(ps, grads[k]):
                    p.grad = torch.from_numpy(g).to(dev)
                opt.step()
            ends[dev] = [p.detach().cpu() for p in ps]
        errs[name] = max(((c - r).abs().max() / max(r.abs().max(), 1.0)).item()
                         for c, r in zip(ends["cuda"], ends["cpu"]))
        check(errs[name] <= OPT_TOL, f"[{tag}] {name}: card vs CPU "
              f"{errs[name]:.3e} > {OPT_TOL}")

    # LBFGS (eager only): the extended Rosenbrock function of 64 values
    def lbfgs_end(dev):
        w = nn.Parameter(torch.from_numpy(
            np.linspace(-1.2, 1.0, 64).astype(np.float32)).to(dev), name="w")
        opt = paddle.optimizer.LBFGS(learning_rate=1.0, max_iter=4,
                                     line_search_fn="strong_wolfe",
                                     parameters=[w])

        def closure():
            opt.clear_grad()
            a, b = w[:-1], w[1:]
            loss = (100.0 * (b - a * a) * (b - a * a)
                    + (1.0 - a) * (1.0 - a)).sum()
            loss.backward()
            return loss

        losses = [float(opt.step(closure)) for _ in range(OPT_STEPS)]
        return w.detach().cpu(), losses

    (wc, lc), (wr, lr_) = lbfgs_end("cuda"), lbfgs_end("cpu")
    errs["LBFGS strong_wolfe"] = ((wc - wr).abs().max() /
                                  max(wr.abs().max(), 1.0)).item()
    check(errs["LBFGS strong_wolfe"] <= OPT_TOL and lc[-1] < lc[0],
          f"[{tag}] LBFGS: card vs CPU {errs['LBFGS strong_wolfe']:.3e}, "
          f"losses {lc} / {lr_}")

    # each rule but LBFGS in Model.fit at K=1 (replays) against the
    # eager route, bit-equal: a scalar the capture froze shows here
    data_rng = np.random.default_rng(seed + 61)
    data = [(torch.from_numpy(data_rng.standard_normal((32, 256)).astype(
        np.float32)), torch.from_numpy(data_rng.integers(0, 64, (32,))))
        for _ in range(OPT_FIT_STEPS)]

    def fit_end(make, fold):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        net = nn.Sequential(nn.Linear(256, 512, device="cuda", generator=gen),
                            nn.ReLU(),
                            nn.Linear(512, 64, device="cuda", generator=gen))
        opt = make(list(net.parameters()), sched)
        model = paddle.Model(net, device="cuda")
        model.prepare(opt, nn.CrossEntropyLoss())
        keep = _loss_keeper()
        model.fit(data, epochs=1, verbose=0, steps_per_dispatch=fold,
                  callbacks=[keep, LRSchedulerCallback(by_step=True,
                                                       by_epoch=False)])
        torch.cuda.synchronize()
        state = _pretrain_state(torch, opt, net)
        graphs = model.compile_stats()
        model.release_graphs()
        return state, keep.losses, graphs

    fits = {}
    for name, make in cases.items():
        s1, l1, g1 = fit_end(make, 1)
        s0, l0, g0 = fit_end(make, 0)
        check(g1 == {"graphs": 1, "captures": 1} and
              g0 == {"graphs": 0, "captures": 0},
              f"[{tag}] {name}: graphs {g1} / {g0}")
        check(_states_equal(torch, s1, s0) and l1 == l0,
              f"[{tag}] {name}: K=1 replays vs eager route, largest diff "
              f"{_state_diff(torch, s0, s1):.3e}, losses {l1} vs {l0}")
        fits[name] = l1[-1] < l1[0]
    print(f"[{tag}] {OPT_STEPS} steps on the card and on the CPU from the "
          f"same fp32 weights and gradients, largest |diff|/max(|ref|,1) "
          f"(tol {OPT_TOL}): " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in errs.items()),
          flush=True)
    print(f"[{tag}] Model.fit of an MLP (256-512-64) over {OPT_FIT_STEPS} "
          f"batches with StepDecay(step_size=2) by step: K=1 replays "
          f"bit-equal to the eager route for every rule ({len(fits)}); loss "
          f"fell for {sum(fits.values())}", flush=True)
    return errs


# ---------------------------------------------------------------------------
# Slice 19: Transformer-base translation and the CRNN text recognizer
# (module docstring, 15o-15s), on the port's nn.Layer, nn.Transformer,
# nn.LSTM and the losses of nn/loss.py.  No kernel of the port runs here:
# the attention is the composed form, the LSTM and CTC the recurrences
# of ops/rnn_ops.py and ops/nn_ops.py, the matmuls cuBLAS and the
# convolutions cuDNN.
# ---------------------------------------------------------------------------
NMT_VOCAB = 33712        # WMT14 en-de's 33708 shared BPE tokens, padded
                         # to a multiple of 8 as PaddleNLP's reader pads
NMT_D, NMT_HEADS, NMT_LAYERS, NMT_FFN = 512, 8, 6, 2048   # Table 3 "base"
NMT_MAX_LEN = 256        # the position table's rows (transformer.base.yaml)
NMT_PAD = 0              # PaddleNLP: bos = pad = 0, eos = 1
NMT_EOS = 1
NMT_SMOOTH = 0.1         # label_smooth_eps
NMT_BUCKETS = ((128, 32), (64, 64), (32, 128))   # (B, S): ~4096 tokens
NMT_GATE_STEPS = 4       # [train transformer]: steps a bucket, the gates
NMT_TIMED_STEPS = 6      # steps a bucket timed (after the capture step)
NMT_PARITY = dict(layers=2, b=8, s=32, steps=3, lr=0.1)
NMT_GREEDY_B, NMT_GREEDY_S = 32, 64
NMT_GAP = 1e-5           # [translate greedy]: a step whose two best logits
                         # lie closer is printed and counted, not failed
CARD_CPU_TOL = 1e-4      # x max(|ref|, 1), fp32 parameters card vs CPU
MHA_CACHE_TOL = 1e-5     # x max(|ref|, 1), cached vs full causal call
CRNN_CLASSES = 37        # 36 alphanumerics and the blank
CRNN_H, CRNN_W = 32, 100
CRNN_B, CRNN_LR = 256, 5e-4
CRNN_STEPS = 20
CRNN_LABELS = (3, 12)    # label lengths drawn from [3, 12]
CRNN_PARITY = dict(b=8, steps=3, lr=0.002)   # at 0.05 three steps turn
                         # the card's and the CPU's rounding into 2.7e-4
                         # of a BatchNorm mean ([train crnn] prints each
                         # step's worst leaves)
CRNN_GRAD_TOL = 1e-4     # step 1's gradients card vs CPU, per leaf:
                         # max |diff| / the leaf's largest |CPU gradient|
CRNN_GRAD_CONTROL = 0.99  # the control scales the card's loss by this
RNN_TOL = 1e-5           # [rnn]: x max(|ref|, 1), card vs CPU, fp32


def sinusoid_table(n_pos, d):
    """PaddleNLP's ``position_encoding_init``: sines on the first half of
    the channels, cosines on the second, timescales from 1 to 1e4."""
    half = d // 2
    inc = np.log(1e4) / max(half - 1, 1)
    inv = np.exp(np.arange(half) * -inc)
    t = np.arange(n_pos)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(t), np.cos(t)], axis=1)
    return np.pad(table, [[0, 0], [0, d % 2]]).astype(np.float32)


_SLICE19 = {}


def slice19_models():
    """The two user models of slice 19, written with the port's layers as
    a user writes them (the CPU tests hold them against the same models
    on the JAX package): PaddleNLP's ``TransformerModel`` with its
    ``CrossEntropyCriterion``, and CRNN with PaddleOCR's BiLSTM neck,
    CTC head and CTC loss."""
    if _SLICE19:
        return _SLICE19
    import torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    class TransformerModel(nn.Layer):
        """``examples/machine_translation/transformer`` of PaddleNLP: one
        word table (``padding_idx`` 0, Normal(0, d**-0.5)) scaled by
        sqrt(d) for source and target, a fixed sinusoidal position table
        read at ``(id != pad) * position``, dropout on both inputs,
        ``nn.Transformer(normalize_before=True)`` with the source
        padding bias (-1e9 at pads, ``[B, 1, 1, S]``) as ``src_mask`` and
        ``memory_mask`` and the causal mask as ``tgt_mask``, and the
        output projection tied to the word table."""

        def __init__(self, vocab=NMT_VOCAB, d_model=NMT_D, n_head=NMT_HEADS,
                     num_layers=NMT_LAYERS, d_inner=NMT_FFN, dropout=0.1,
                     max_length=NMT_MAX_LEN, pad_id=NMT_PAD, *, device=None,
                     generator=None):
            super().__init__()
            self.vocab, self.d_model, self.pad_id = vocab, d_model, pad_id
            self.dropout = dropout
            kw = dict(device=device, generator=generator)
            self.word_embedding = nn.Embedding(
                vocab, d_model, padding_idx=pad_id,
                weight_attr=nn.initializer.Normal(0.0, d_model ** -0.5), **kw)
            dev = self.word_embedding.weight.device
            self.register_buffer(
                "pos_table", torch.tensor(sinusoid_table(max_length, d_model),
                                          device=dev), persistable=False)
            self.transformer = nn.Transformer(
                d_model, n_head, num_layers, num_layers, d_inner, dropout,
                "relu", normalize_before=True, **kw)

        def embed(self, ids):
            pos = (ids != self.pad_id).long() * torch.arange(
                ids.shape[1], device=ids.device)
            emb = self.word_embedding(ids) * self.d_model ** 0.5
            out = emb + self.pos_table[pos].to(emb.dtype)
            return F.dropout(out, self.dropout, training=self.training)

        def src_bias(self, src):
            return ((src == self.pad_id).float() * -1e9)[:, None, None, :]

        def logits(self, dec):
            return F.linear(dec, self.word_embedding.weight.t())

        def forward(self, src, tgt, memory_mask=True):
            bias = self.src_bias(src)
            causal = nn.Transformer.generate_square_subsequent_mask(
                tgt.shape[1], device=tgt.device)
            dec = self.transformer(self.embed(src), self.embed(tgt),
                                   src_mask=bias, tgt_mask=causal,
                                   memory_mask=bias if memory_mask else None)
            return self.logits(dec)

        @torch.no_grad()
        def greedy(self, src, max_len):
            """Greedy decoding from bos (= pad, PaddleNLP's) for ``max_len``
            steps, the decoder re-run on the prefix at each step (the
            decoder takes ``cache=`` and ignores it, as the JAX one
            does); a sentence that emitted eos emits pad after it.
            Returns the tokens ``[B, max_len]`` and each step's last
            logits ``[B, max_len, V]``."""
            bias = self.src_bias(src)
            memory = self.transformer.encoder(self.embed(src), src_mask=bias)
            b = src.shape[0]
            seq = torch.full((b, 1), self.pad_id, dtype=torch.long,
                             device=src.device)
            done = torch.zeros(b, dtype=torch.bool, device=src.device)
            steps = []
            for _ in range(max_len):
                causal = nn.Transformer.generate_square_subsequent_mask(
                    seq.shape[1], device=src.device)
                dec = self.transformer.decoder(self.embed(seq), memory,
                                               tgt_mask=causal,
                                               memory_mask=bias)
                last = self.logits(dec[:, -1]).float()
                nxt = torch.where(done, torch.full_like(done, self.pad_id,
                                                        dtype=torch.long),
                                  last.argmax(-1))
                done = done | (nxt == NMT_EOS)
                seq = torch.cat([seq, nxt[:, None]], dim=1)
                steps.append(last)
            return seq[:, 1:], torch.stack(steps, 1)

    class TransformerCriterion(nn.Layer):
        """PaddleNLP's ``CrossEntropyCriterion``: the label smoothed to
        ``one_hot * (1 - eps) + eps / V``, soft-label cross-entropy a
        position, weighted by the non-pad positions and divided by their
        count."""

        def __init__(self, vocab=NMT_VOCAB, eps=NMT_SMOOTH, pad_id=NMT_PAD):
            super().__init__()
            self.vocab, self.eps, self.pad_id = vocab, eps, pad_id

        def forward(self, logits, label):
            soft = torch.zeros(label.shape + (self.vocab,),
                               device=logits.device)
            soft.scatter_(-1, label.unsqueeze(-1), 1.0)
            soft = soft * (1 - self.eps) + self.eps / self.vocab
            cost = F.cross_entropy(logits, soft, soft_label=True,
                                   reduction="none")
            w = (label != self.pad_id).float()
            return (cost * w).sum() / w.sum()

    def conv(cin, cout, k=3, p=1, bn=False, **kw):
        layers = [nn.Conv2D(cin, cout, k, 1, p, bias_attr=False if bn
                            else None, **kw)]
        if bn:
            layers.append(nn.BatchNorm2D(cout, **kw))
        return layers + [nn.ReLU()]

    class CRNN(nn.Layer):
        """Shi, Bai and Yao's CRNN (arXiv:1507.05717, Table 1) as its
        common PyTorch implementation lays out the VGG (BatchNorm after
        the two 512 convolutions, whose bias goes with it as in
        PaddleOCR's ConvBNLayer), PaddleOCR's ``EncoderWithRNN`` neck
        (``LSTM(512, 256, direction="bidirectional", num_layers=2)``)
        and ``CTCHead`` (``Linear(512, classes)``): a ``[B, 1, 32, 100]``
        image to ``[B, 26, classes]`` logits."""

        def __init__(self, classes=CRNN_CLASSES, hidden=256, *, device=None,
                     generator=None):
            super().__init__()
            kw = dict(device=device, generator=generator)
            pool_w = dict(kernel_size=2, stride=(2, 1), padding=(0, 1))
            self.backbone = nn.Sequential(
                *conv(1, 64, **kw), nn.MaxPool2D(2, 2),
                *conv(64, 128, **kw), nn.MaxPool2D(2, 2),
                *conv(128, 256, **kw), *conv(256, 256, **kw),
                nn.MaxPool2D(**pool_w),
                *conv(256, 512, bn=True, **kw),
                *conv(512, 512, bn=True, **kw), nn.MaxPool2D(**pool_w),
                *conv(512, 512, k=2, p=0, **kw))
            self.neck = nn.LSTM(512, hidden, num_layers=2,
                                direction="bidirectional", **kw)
            self.head = nn.Linear(2 * hidden, classes, **kw)

        def forward(self, x):
            f = self.backbone(x)                     # [B, 512, 1, 26]
            seq = f.squeeze(2).transpose(1, 2)       # [B, 26, 512]
            seq, _ = self.neck(seq)
            return self.head(seq)

    class CTCCriterion(nn.Layer):
        """PaddleOCR's CTC loss on the head's logits: time-major, every
        input length the full 26 steps, the labels' own lengths (a
        device tensor, the second label)."""

        def __init__(self, reduction="mean"):
            super().__init__()
            self.ctc = nn.CTCLoss(blank=0, reduction=reduction)

        def forward(self, logits, labels, label_lengths):
            lp = logits.transpose(0, 1)
            t, b = lp.shape[0], lp.shape[1]
            lens = torch.full((b,), t, dtype=torch.long, device=lp.device)
            return self.ctc(lp, labels, lens, label_lengths)

    _SLICE19.update(TransformerModel=TransformerModel,
                    TransformerCriterion=TransformerCriterion, CRNN=CRNN,
                    CTCCriterion=CTCCriterion)
    return _SLICE19


def nmt_batch(b, s, seed, vocab=NMT_VOCAB):
    """Random sentence pairs of ``b`` rows, ``s`` positions: each source
    and target of a length drawn from [s/2, s] and padded with 0 after
    it; the decoder's input is bos (0) and the target shifted right,
    the label the target.  numpy int64 ``(src, tgt_in, label)``."""
    rng = np.random.RandomState(seed)

    def sents():
        ids = rng.randint(2, vocab, (b, s))
        lens = rng.randint(s // 2, s + 1, b)
        ids[np.arange(s)[None, :] >= lens[:, None]] = NMT_PAD
        return ids.astype(np.int64)

    src, tgt = sents(), sents()
    tgt_in = np.concatenate([np.zeros((b, 1), np.int64), tgt[:, :-1]], 1)
    return src, tgt_in, tgt


def ocr_batch(b, seed, classes=CRNN_CLASSES):
    """Text-line images ``[b, 1, 32, 100]`` whose stripes follow the
    labels (``tests/test_crnn_e2e.py``'s images at CRNN's size: a
    6-pixel stripe a character at x = 2 + 8 i, of value k / classes,
    plus noise), labels ``[b, 12]`` padded with 0 past each length, and
    the lengths, drawn from ``CRNN_LABELS``."""
    rng = np.random.RandomState(seed)
    lo, hi = CRNN_LABELS
    lens = rng.randint(lo, hi + 1, b)
    labels = rng.randint(1, classes, (b, hi))
    labels[np.arange(hi)[None, :] >= lens[:, None]] = 0
    imgs = np.zeros((b, 1, CRNN_H, CRNN_W), np.float32)
    for i in range(b):
        for j in range(lens[i]):
            x0 = 2 + j * 8
            imgs[i, 0, :, x0:x0 + 6] = labels[i, j] / classes
    imgs += rng.randn(*imgs.shape).astype(np.float32) * 0.01
    return imgs, labels.astype(np.int64), lens.astype(np.int64)


def _nmt_model(torch, seed, dropout, layers=NMT_LAYERS, device="cuda",
               o2=True, sgd_lr=None):
    """PaddleNLP's Transformer-base from ``seed`` (the table's and the
    first layers' draws from a seeded generator, the clones' from the
    port's generator of the device, reseeded), its criterion, and its
    optimizer: ``Adam(0.9, 0.997, 1e-9)`` under ``NoamDecay(512, 4000,
    2.0)`` (or ``SGD(sgd_lr)``), bf16 O2 with fp32 masters if ``o2``."""
    import paddle_tpu_torch as paddle
    m = slice19_models()
    paddle.seed(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    net = m["TransformerModel"](num_layers=layers, dropout=dropout,
                                device=device, generator=gen)
    if sgd_lr is not None:
        sched = None
        opt = paddle.optimizer.SGD(sgd_lr, parameters=net.parameters())
    else:
        sched = paddle.optimizer.lr.NoamDecay(NMT_D, 4000, learning_rate=2.0)
        opt = paddle.optimizer.Adam(
            learning_rate=sched, beta1=0.9, beta2=0.997, epsilon=1e-9,
            parameters=net.parameters(), multi_precision=o2)
    amp = None
    if o2:
        paddle.amp.decorate(net, opt, level="O2", dtype="bfloat16")
        amp = {"level": "O2", "dtype": "bfloat16"}
    model = paddle.Model(net, device=device)
    model.prepare(opt, m["TransformerCriterion"](), amp_configs=amp)
    return net, opt, sched, model


def _nmt_data(torch, seed, steps):
    """``steps`` batches a bucket, interleaved bucket by bucket, pinned."""
    out = []
    for j in range(steps):
        for i, (b, s) in enumerate(NMT_BUCKETS):
            out.append(tuple(torch.from_numpy(a).pin_memory() for a in
                             nmt_batch(b, s, seed + 1000 * i + j)))
    return out


def _nmt_group(name):
    """Profile groups of the translation step."""
    low = name.lower()
    if "softmax_warp" in low:
        return "composed attention softmax"
    if "cunn_softmax" in low:
        return "softmax cross-entropy"
    if "layer_norm" in low or "gammabeta" in low:
        return "LayerNorm"
    g = _kernel_group(name)
    return "Adam (foreach)" if g.startswith("optimizer") else g


def _masked_attention_ms(torch, b, s, causal):
    """Device ms of one composed attention forward and backward on bf16
    ``[b, s, 8, 64]`` with the ``[b, 1, 1, s]`` padding bias (and the
    causal mask): one of the 18 a Transformer-base step runs."""
    from paddle_tpu_torch.nn import Transformer
    from paddle_tpu_torch.ops import nn_ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, s, NMT_HEADS, NMT_D // NMT_HEADS,
                           device="cuda", generator=gen)
               .bfloat16().requires_grad_() for _ in range(3))
    g = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
    bias = torch.zeros(b, 1, 1, s, device="cuda")
    bias[:, :, :, s - s // 4:] = -1e9
    mask = bias + Transformer.generate_square_subsequent_mask(s) \
        if causal else bias

    def fn():
        nn_ops.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                            dropout_p=0.1).backward(g)

    return device_ms(torch, fn, 5, {"all": ()})["all"]


def _layer_state(torch, opt, net):
    """:func:`_pretrain_state` and the network's buffers."""
    out = _pretrain_state(torch, opt, net)
    out.update({f"buffer {n}": b.detach().clone()
                for n, b in net.named_buffers()})
    return out


def train_transformer_phase(torch, seed):
    """``[train transformer]`` (module docstring, 15o)."""
    import gc
    from paddle_tpu_torch.hapi.callbacks import Callback, LRSchedulerCallback
    tag = "train transformer"
    gc.collect()
    torch.cuda.empty_cache()
    gate_data = _nmt_data(torch, seed, NMT_GATE_STEPS)

    def run(fold, data, dropout, clock=None, extra=()):
        net, opt, sched, model = _nmt_model(torch, seed, dropout)
        cbs = [LRSchedulerCallback(by_step=True, by_epoch=False)]
        cbs += [clock] if clock is not None else []
        model.fit(data, epochs=1, verbose=0, steps_per_dispatch=fold,
                  callbacks=cbs + list(extra))
        torch.cuda.synchronize()
        return net, opt, sched, model

    # the gates at dropout 0, under the deterministic algorithms (the
    # word table's backward, an index-add of 4096 ids, sums in another
    # order each run otherwise): K=1 replays against the eager route
    with deterministic_algorithms(torch) as warned:
        runs = {}
        for fold in (None, 0):
            clock = _step_clock(torch)
            net, opt, sched, model = run(fold, gate_data, 0.0, clock)
            runs[fold] = dict(state=_layer_state(torch, opt, net),
                              losses=clock.losses, fold=model._fold,
                              graphs=model.compile_stats())
            free_model(torch, tag, model)
            del net, opt, sched, model
    rep, eag = runs[None], runs[0]
    warned = sorted({str(w.message)[:100] for w in warned})
    check(rep["fold"] == 1 and rep["graphs"] == {
        "graphs": len(NMT_BUCKETS), "captures": len(NMT_BUCKETS)},
        f"[{tag}] K {rep['fold']}, graphs {rep['graphs']}: want K=1 and a "
        "graph a bucket")
    check(eag["graphs"] == {"graphs": 0, "captures": 0},
          f"[{tag}] the eager route captured: {eag['graphs']}")
    same = _states_equal(torch, rep["state"], eag["state"]) and \
        rep["losses"] == eag["losses"]
    diff = _state_diff(torch, eag["state"], rep["state"])
    check(same, f"[{tag}] replays vs eager at dropout 0: largest |diff|/"
          f"max(|ref|,1) {diff:.3e}; losses {rep['losses']} vs "
          f"{eag['losses']}")
    check(all(np.isfinite(rep["losses"])), f"[{tag}] {rep['losses']}")
    # the timed run at dropout 0.1 in the default mode: one capture step
    # a bucket (reserved memory printed after each), then the clock
    reserved = []

    class Reserved(Callback):
        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            reserved.append(torch.cuda.memory_reserved())

    torch.cuda.reset_peak_memory_stats()
    warm = _nmt_data(torch, seed + 1, 1)
    clock = _step_clock(torch)
    net, opt, sched, model = run(None, warm, 0.1, clock, [Reserved()])
    first_ms = [float(v) for v in np.diff(clock.stamps) * 1e3]
    graphs = model.compile_stats()
    capture_s = [r.capture_s for r in model._graphs.values()]
    timed = _nmt_data(torch, seed + 2, NMT_TIMED_STEPS)
    clock = _step_clock(torch)
    model.fit(timed, epochs=1, verbose=0, callbacks=[
        clock, LRSchedulerCallback(by_step=True, by_epoch=False)])
    torch.cuda.synchronize()
    check(model.compile_stats() == graphs,
          f"[{tag}] a capture in the timed window: {model.compile_stats()}")
    peak = torch.cuda.max_memory_allocated()
    pool = pool_reserved(torch, model._graph_pool)
    ms = np.diff(clock.stamps) * 1e3
    nb = len(NMT_BUCKETS)
    res = {"step_ms": {}, "tokens_per_s": {}, "first_ms": first_ms,
           "capture_s": capture_s, "reserved": reserved, "peak": peak,
           "pool": pool, "gate_losses": rep["losses"],
           "timed_losses": clock.losses}
    for i, (b, s) in enumerate(NMT_BUCKETS):
        step = float(np.median(ms[i::nb]))
        res["step_ms"][f"{b}x{s}"] = step
        res["tokens_per_s"][f"{b}x{s}"] = b * s / (step * 1e-3)
    prof = profile_run(
        torch, tag, "replayed", lambda: model.fit(
            timed[:nb], epochs=1, verbose=0, steps_per_dispatch=1),
        nb, group=_nmt_group)
    check(model.compile_stats() == graphs,
          f"[{tag}] a capture in the profiled window")
    free_model(torch, tag, model)
    del net, opt, sched, model
    attn = {f"{b}x{s}": 6 * (2 * _masked_attention_ms(torch, b, s, False)
                             + _masked_attention_ms(torch, b, s, True))
            for b, s in NMT_BUCKETS}
    res.update(profile=prof, attention_ms=attn)
    print(f"[{tag}] Transformer-base (Vaswani et al. Table 3 'base': 6 + 6 "
          f"layers, d_model {NMT_D}, {NMT_HEADS} heads, FFN {NMT_FFN}, "
          f"shared vocabulary {NMT_VOCAB}, pre-LN as PaddleNLP's "
          f"transformer.base.yaml), bf16 O2, Adam(0.9, 0.997, 1e-9) with "
          f"fp32 masters under NoamDecay(512, 4000, 2.0) stepped by step, "
          f"label smoothing {NMT_SMOOTH}; buckets (B, S) {NMT_BUCKETS}, a "
          f"graph each ({graphs})", flush=True)
    print(f"[{tag}] gates (dropout 0, deterministic algorithms; warnings "
          f"{warned}): {NMT_GATE_STEPS} steps a bucket replayed at K=1 "
          f"bit-equal to the eager route (parameters, fp32 masters, moments, "
          f"beta powers, step counts, the scheduler's last_epoch): {same}; "
          f"losses {[round(v, 5) for v in rep['losses']]}", flush=True)
    print(f"[{tag}] dropout 0.1: first step a bucket (warm-up + capture) "
          f"{[round(v, 3) for v in first_ms]} ms, capture "
          f"{[round(v, 3) for v in capture_s]} s, reserved after each "
          f"bucket's capture {[round(r / 2**30, 3) for r in reserved]} GiB; "
          f"graph pool " + (f"{pool / 2**30:.3f} GiB" if pool is not None
                            else "not measured")
          + f"; peak_mem_gib {peak / 2**30:.3f}", flush=True)
    print(f"[{tag}] replayed ms a step (median of {NMT_TIMED_STEPS}): "
          + ", ".join(f"{k}: {res['step_ms'][k]:.3f} "
                      f"({res['tokens_per_s'][k]:.1f} target tokens/s)"
                      for k in res["step_ms"])
          + "; the composed attention alone (18 a step, forward + "
          "backward, device ms): "
          + ", ".join(f"{k}: {v:.3f}" for k, v in attn.items()), flush=True)
    return res


def train_transformer_parity_phase(torch, seed):
    """``[train transformer parity]`` (module docstring, 15p)."""
    tag = "train transformer parity"
    p = NMT_PARITY
    data = [nmt_batch(p["b"], p["s"], seed + 50 + i)
            for i in range(p["steps"])]

    def run(device, init, drop_memory_mask=False):
        net, _, _, model = _nmt_model(torch, seed, 0.0, p["layers"], device,
                                      o2=False, sgd_lr=p["lr"])
        net.set_state_dict(init)
        if drop_memory_mask:
            dec = net.transformer.decoder
            full = dec.forward
            dec.forward = lambda tgt, memory, tgt_mask=None, \
                memory_mask=None, cache=None: full(tgt, memory, tgt_mask)
        clock = _loss_keeper()
        fold = 1 if device == "cuda" else 0
        model.fit([tuple(torch.from_numpy(a) for a in b) for b in data],
                  epochs=1, verbose=0, steps_per_dispatch=fold,
                  callbacks=[clock])
        state = {k: v.detach().cpu().clone() for k, v in
                 net.state_dict().items()}
        if device == "cuda":
            free_model(torch, tag, model)
        return state, clock.losses

    net, *_ = _nmt_model(torch, seed, 0.0, p["layers"], "cuda", o2=False,
                         sgd_lr=p["lr"])
    init = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    del net
    card, card_losses = run("cuda", init)
    cpu, cpu_losses = run("cpu", init)
    ctl, ctl_losses = run("cuda", init, drop_memory_mask=True)

    def gate(state, losses):
        err, worst = max(((state[k] - v).abs().max().item() /
                          max(v.abs().max().item(), 1.0), k)
                         for k, v in cpu.items())
        moved = max((cpu[k] - init[k]).abs().max().item() for k in cpu)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                            cpu_losses))
        return err, loss_rel, moved, worst

    err, loss_rel, moved, worst = gate(card, card_losses)
    c_err, c_loss, _, _ = gate(ctl, ctl_losses)
    print(f"[{tag}] Transformer-base widths, {p['layers']} + {p['layers']} "
          f"layers, fp32 (TF32 off), SGD({p['lr']}) (linear in the "
          f"gradient; Adam turns rounding noise into whole steps), "
          f"{p['steps']} steps of B={p['b']} S={p['s']}: card (K=1 replays) "
          f"vs CPU: parameters largest |diff|/max(|ref|,1) {err:.3e} "
          f"({worst}; tol {CARD_CPU_TOL}; the largest move {moved:.3e}), "
          f"losses "
          f"{[round(v, 6) for v in card_losses]} vs "
          f"{[round(v, 6) for v in cpu_losses]} (relative {loss_rel:.3e}); "
          f"control without memory_mask: {c_err:.3e}, losses relative "
          f"{c_loss:.3e}", flush=True)
    check(err <= CARD_CPU_TOL and loss_rel <= PARITY_TOL,
          f"[{tag}] card vs CPU {err:.3e}, losses {loss_rel:.3e}")
    check(c_err > CARD_CPU_TOL or c_loss > PARITY_TOL,
          f"[{tag}] the control without memory_mask passed the gate")
    return {"err": err, "loss_rel": loss_rel, "control": (c_err, c_loss)}


def translate_greedy_phase(torch, seed):
    """``[translate greedy]`` (module docstring, 15q)."""
    import paddle_tpu_torch as paddle
    tag = "translate greedy"
    m = slice19_models()
    net, *_ = _nmt_model(torch, seed, 0.0, o2=False, sgd_lr=0.0)
    net.eval()
    src_np = nmt_batch(NMT_GREEDY_B, NMT_GREEDY_S, seed + 77)[0]
    src = torch.from_numpy(src_np).cuda()
    net.greedy(src, 2)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    tokens, logits = net.greedy(src, NMT_GREEDY_S)
    torch.cuda.synchronize()
    total_ms = (time.monotonic() - t0) * 1e3
    tokens = tokens.cpu()
    # the CPU, teacher-forced on the card's tokens: at every step before
    # a sentence's eos the card's token must be the CPU logits' argmax
    cpu = m["TransformerModel"](num_layers=NMT_LAYERS, dropout=0.0,
                                device="cpu")
    cpu.set_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    cpu.eval()
    tgt_in = torch.cat([torch.zeros(NMT_GREEDY_B, 1, dtype=torch.long),
                        tokens[:, :-1]], 1)
    with torch.no_grad():
        ref = cpu(torch.from_numpy(src_np), tgt_in)
    live = torch.ones(NMT_GREEDY_B, dtype=torch.bool)
    ties, checked = [], 0
    for t in range(NMT_GREEDY_S):
        top = ref[:, t].topk(2, dim=-1)
        for i in torch.nonzero(live).flatten().tolist():
            checked += 1
            tok = int(tokens[i, t])
            if tok != int(top.indices[i, 0]):
                gap = float(top.values[i, 0] - ref[i, t, tok])
                ties.append((i, t, tok, int(top.indices[i, 0]), gap))
        live &= tokens[:, t] != NMT_EOS
    logit_err = (logits.cpu() - ref).abs().max().item() / max(
        ref.abs().max().item(), 1.0)
    # MultiHeadAttention's cache: one position at a time equals the full
    # causal call
    paddle.seed(seed)
    mha = paddle.nn.MultiHeadAttention(NMT_D, NMT_HEADS, device="cuda")
    mha.eval()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(NMT_GREEDY_B, NMT_GREEDY_S, NMT_D, device="cuda",
                    generator=gen)
    with torch.no_grad():
        full = mha(x, attn_mask=paddle.nn.Transformer
                   .generate_square_subsequent_mask(NMT_GREEDY_S))
        cache, outs = mha.gen_cache(x), []
        for t in range(NMT_GREEDY_S):
            o, cache = mha(x[:, t:t + 1], cache=cache)
            outs.append(o)
    inc = torch.cat(outs, 1)
    cache_err = (inc - full).abs().max().item() / max(
        full.abs().max().item(), 1.0)
    print(f"[{tag}] Transformer-base (6 + 6 layers, fp32, the weights "
          f"[train transformer] starts from), {NMT_GREEDY_B} sources of "
          f"{NMT_GREEDY_S} tokens, greedy for {NMT_GREEDY_S} steps, the "
          f"decoder re-run on the prefix each step: {total_ms:.1f} ms, "
          f"{total_ms / NMT_GREEDY_S:.3f} ms a step, "
          f"{total_ms / NMT_GREEDY_S / NMT_GREEDY_B:.4f} ms a generated "
          f"token; card tokens vs the CPU's argmax (teacher-forced) at "
          f"{checked} steps: {len(ties)} apart, each within {NMT_GAP} "
          f"{ties[:8]}; last logits vs the CPU's {logit_err:.3e}; "
          f"MultiHeadAttention with the cache vs the full causal call "
          f"{cache_err:.3e} (tol {MHA_CACHE_TOL})", flush=True)
    check(all(g <= NMT_GAP for *_, g in ties),
          f"[{tag}] card tokens depart from the CPU's beyond {NMT_GAP}: "
          f"{ties[:8]}")
    check(cache_err <= MHA_CACHE_TOL, f"[{tag}] cache {cache_err:.3e}")
    return {"ms": total_ms, "ties": len(ties), "checked": checked,
            "cache_err": cache_err}


def _crnn_model(torch, seed, device="cuda", criterion=None, sgd_lr=None):
    """CRNN from ``seed``, ``Adam(CRNN_LR)`` (or ``SGD(sgd_lr)``), fp32,
    in a ``Model`` whose labels are the label ids and their lengths."""
    import paddle_tpu_torch as paddle
    m = slice19_models()
    paddle.seed(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    net = m["CRNN"](device=device, generator=gen)
    opt = (paddle.optimizer.SGD(sgd_lr, parameters=net.parameters())
           if sgd_lr is not None else
           paddle.optimizer.Adam(CRNN_LR, parameters=net.parameters()))
    model = paddle.Model(net, labels=["label", "length"], device=device)
    model.prepare(opt, criterion or m["CTCCriterion"]())
    return net, opt, model


def _crnn_group(name):
    """Profile groups of the CRNN step, by kernel name."""
    low = name.lower()
    if "batch_norm" in low or "bn_" in low:
        return "BatchNorm"
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                              "implicit_convolve", "xmma")):
        return "cuDNN convolutions"
    if "logaddexp" in low:
        return "CTC (logaddexp)"
    if any(k in low for k in ("sigmoid", "tanh")):
        return "LSTM gates (sigmoid, tanh)"
    g = _kernel_group(name)
    return "Adam (foreach)" if g.startswith("optimizer") else g


def crnn_grad_gate(a, b):
    """max |a - b| / max |b| per gradient leaf (1 for an all-zero leaf),
    the worst first: each leaf against its own scale, so a leaf of small
    gradients is held as closely as a large one."""
    return sorted(((float((a[k] - b[k]).abs().max())
                    / (float(b[k].abs().max()) or 1.0), k) for k in b),
                  reverse=True)


def crnn_parity(torch, seed, tag, card="cuda"):
    """``[train crnn]``'s card-vs-CPU gates, CRNN at B=8 from the same
    weights under the deterministic algorithms: step 1's gradients per
    leaf within ``CRNN_GRAD_TOL`` (a control whose card loss is scaled
    by ``CRNN_GRAD_CONTROL`` must fail), the loss at "mean" and "sum",
    then three SGD steps (K=1 replays on ``card``) within
    ``CARD_CPU_TOL`` (the control must fail that gate too), each step's
    worst leaves printed.  ``card="cpu"`` runs the same on the CPU twice
    (no graphs)."""
    from paddle_tpu_torch.hapi.callbacks import Callback
    m = slice19_models()
    p = CRNN_PARITY
    small = [ocr_batch(p["b"], seed + 400 + i) for i in range(p["steps"])]
    net, _, _ = _crnn_model(torch, seed, card, sgd_lr=p["lr"])
    init = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    del net

    class Scaled(m["CTCCriterion"]):
        """The control: every gradient CRNN_GRAD_CONTROL of its value."""

        def forward(self, *args):
            return CRNN_GRAD_CONTROL * super().forward(*args)

    class Keep(Callback):
        """Each step's loss and the state after it."""

        def __init__(self, net):
            super().__init__()
            self.net, self.losses, self.states = net, [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"][0]))
            self.states.append({k: v.detach().cpu().clone() for k, v in
                                self.net.state_dict().items()})

    grads, red, ends = {}, {}, {}
    runs = (("card", card, m["CTCCriterion"]()), ("cpu", "cpu",
            m["CTCCriterion"]()), ("control", card, Scaled()))
    with deterministic_algorithms(torch):
        for run, dev, criterion in runs:
            # the gradients on a model of their own: the fit's capture
            # must not meet the autograd nodes of an eager backward run
            # on the default stream
            net, _, _ = _crnn_model(torch, seed, dev, sgd_lr=p["lr"])
            net.set_state_dict(init)
            x0, lab0, len0 = (torch.from_numpy(a).to(dev) for a in small[0])
            logits = net(x0)
            criterion(logits, lab0, len0).backward()
            grads[run] = {k: q.grad.detach().cpu().clone() for k, q in
                          net.named_parameters()}
            logits = logits.detach()
            red[run] = [float(m["CTCCriterion"](r)(logits, lab0, len0))
                        for r in ("mean", "sum")]
            del net, logits
            net, _, model = _crnn_model(torch, seed, dev, criterion,
                                        sgd_lr=p["lr"])
            net.set_state_dict(init)
            keep = Keep(net)
            model.fit([tuple(torch.from_numpy(a) for a in b) for b in small],
                      epochs=1, verbose=0, callbacks=[keep],
                      steps_per_dispatch=1 if run != "cpu" else 0)
            ends[run] = (keep.states, keep.losses)
            if dev != "cpu":
                free_model(torch, tag, model)
            del net, model
    g_err, g_leaf = crnn_grad_gate(grads["card"], grads["cpu"])[0]
    gc_err, gc_leaf = crnn_grad_gate(grads["control"], grads["cpu"])[0]
    (on_card, card_l), (on_cpu, cpu_l) = ends["card"], ends["cpu"]
    per_step = [_worst(a, b)[:3] for a, b in zip(on_card, on_cpu)]
    err, worst = per_step[-1][0]
    c_err, c_leaf = _worst(ends["control"][0][-1], on_cpu[-1])[0]
    red_rel = max(abs(a - b) / abs(b) for a, b in zip(red["card"],
                                                      red["cpu"]))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    print(f"[{tag}] card vs CPU under the deterministic algorithms at "
          f"B={p['b']}, step 1's gradients per leaf, |diff| / the leaf's "
          f"largest |CPU gradient|: {g_err:.3e} ({g_leaf}; tol "
          f"{CRNN_GRAD_TOL}); the control (card loss x{CRNN_GRAD_CONTROL}) "
          f"{gc_err:.3e} ({gc_leaf}; must fail); the loss on the same "
          f"weights, 'mean' and 'sum': card {red['card']} vs CPU "
          f"{red['cpu']} (relative {red_rel:.3e})", flush=True)
    for step, leaves in enumerate(per_step):
        print(f"[{tag}] SGD({p['lr']}) step {step + 1} (K=1 replays) vs "
              f"CPU, parameters and BatchNorm statistics |diff|/max(|ref|,1)"
              f", the worst: " + ", ".join(f"{k} {e:.3e}" for e, k in
                                           leaves), flush=True)
    print(f"[{tag}] after {p['steps']} steps {err:.3e} ({worst}; tol "
          f"{CARD_CPU_TOL}); losses relative {loss_rel:.3e}; the control "
          f"after {p['steps']} steps {c_err:.3e} ({c_leaf}; must fail)",
          flush=True)
    check(g_err <= CRNN_GRAD_TOL and err <= CARD_CPU_TOL and
          loss_rel <= PARITY_TOL and red_rel <= PARITY_TOL,
          f"[{tag}] card vs CPU: gradients {g_err:.3e}, parameters "
          f"{err:.3e}, losses {loss_rel:.3e}, reductions {red_rel:.3e}")
    check(gc_err > CRNN_GRAD_TOL and c_err > CARD_CPU_TOL,
          f"[{tag}] the control (loss x{CRNN_GRAD_CONTROL}) passed a gate: "
          f"gradients {gc_err:.3e}, after {p['steps']} steps {c_err:.3e}")
    return {"err": err, "grad_err": g_err, "grad_control": gc_err,
            "control_steps": c_err}


def train_crnn_phase(torch, seed):
    """``[train crnn]`` (module docstring, 15r)."""
    import gc
    tag = "train crnn"
    m = slice19_models()
    gc.collect()
    torch.cuda.empty_cache()
    data = [tuple(torch.from_numpy(a).pin_memory() for a in
                  ocr_batch(CRNN_B, seed + 300 + i))
            for i in range(CRNN_STEPS)]
    lens = [int(b[2].sum()) for b in data]

    class FrozenLengths(m["CTCCriterion"]):
        """The control: the first batch's label lengths kept and read at
        every later step, as a capture that read them on the host
        would have frozen them."""

        def forward(self, logits, labels, label_lengths):
            if not hasattr(self, "first"):
                self.first = label_lengths.clone()
            return super().forward(logits, labels, self.first)

    def run(fold, criterion=None):
        net, opt, model = _crnn_model(torch, seed, criterion=criterion)
        clock = _step_clock(torch)
        torch.cuda.reset_peak_memory_stats()
        model.fit(data, epochs=1, verbose=0, steps_per_dispatch=fold,
                  callbacks=[clock])
        torch.cuda.synchronize()
        out = dict(state=_layer_state(torch, opt, net), losses=clock.losses,
                   ms=list(np.diff(clock.stamps) * 1e3),
                   peak=torch.cuda.max_memory_allocated(),
                   graphs=model.compile_stats(), model=model)
        return out

    with deterministic_algorithms(torch) as warned:
        rep = run(1)
        free_model(torch, tag, rep.pop("model"))
        eag = run(0)
        free_model(torch, tag, eag.pop("model"))
        ctl = run(1, FrozenLengths())
        free_model(torch, tag, ctl.pop("model"))
    warned = sorted({str(w.message)[:100] for w in warned})
    same = _states_equal(torch, rep["state"], eag["state"]) and \
        rep["losses"] == eag["losses"]
    diff = _state_diff(torch, eag["state"], rep["state"])
    ctl_same = _states_equal(torch, ctl["state"], eag["state"])
    ctl_diff = _state_diff(torch, eag["state"], ctl["state"])
    check(rep["graphs"] == {"graphs": 1, "captures": 1},
          f"[{tag}] graphs {rep['graphs']}")
    check(same, f"[{tag}] replays vs eager: largest |diff|/max(|ref|,1) "
          f"{diff:.3e}; losses {rep['losses']} vs {eag['losses']}")
    check(not ctl_same, f"[{tag}] the frozen-lengths control passed the "
          "replay-vs-eager gate")
    check(rep["losses"][-1] < rep["losses"][0],
          f"[{tag}] the loss did not fall: {rep['losses']}")
    # timed in the default mode (cuDNN's fastest algorithms)
    t = run(1)
    model = t.pop("model")
    step_ms = float(np.median(t["ms"][2:]))
    prof = profile_run(
        torch, tag, "replayed", lambda: model.fit(
            data[:4], epochs=1, verbose=0, steps_per_dispatch=1), 4,
        group=_crnn_group)
    free_model(torch, tag, model)
    # the LSTM neck and the CTC loss alone, forward + backward
    net, _, model = _crnn_model(torch, seed)
    x = torch.randn(CRNN_B, 26, 512, device="cuda", requires_grad=True)
    lp = torch.randn(26, CRNN_B, CRNN_CLASSES, device="cuda",
                     requires_grad=True)
    labels, llen = (b.cuda() for b in data[0][1:])
    tlen = torch.full((CRNN_B,), 26, dtype=torch.long, device="cuda")
    ctc = m["CTCCriterion"]().ctc
    lstm_ms = device_ms(torch, lambda: net.neck(x)[0].sum().backward(), 5,
                        {"all": ()})["all"]
    ctc_ms = device_ms(torch, lambda: ctc(lp, labels, tlen, llen).backward(),
                       5, {"all": ()})["all"]
    free_model(torch, tag, model)
    del net, model
    print(f"[{tag}] CRNN (VGG of Table 1, LSTM(512, 256, bidirectional, 2 "
          f"layers), Linear(512, {CRNN_CLASSES}), CTCLoss(blank=0)), fp32, "
          f"Adam({CRNN_LR}), B={CRNN_B} 1x{CRNN_H}x{CRNN_W}, label lengths "
          f"{CRNN_LABELS} (label tokens a batch {lens[:6]}...): "
          f"{CRNN_STEPS} steps", flush=True)
    print(f"[{tag}] under the deterministic algorithms (warnings {warned}): "
          f"K=1 replays vs eager bit-equal {same}; the frozen-lengths "
          f"control {ctl_diff:.3e} from eager (must differ); losses "
          f"{[round(v, 4) for v in rep['losses']]}", flush=True)
    print(f"[{tag}] default mode: replayed {step_ms:.3f} ms a step "
          f"({CRNN_B / (step_ms * 1e-3):.1f} images/s), first step (warm-up "
          f"+ capture) {t['ms'][0]:.3f} ms; peak_mem_gib "
          f"{t['peak'] / 2**30:.3f}; alone (device ms, forward + backward): "
          f"the LSTM neck {lstm_ms:.3f}, CTC {ctc_ms:.3f}", flush=True)
    par = crnn_parity(torch, seed, tag)
    return {"step_ms": step_ms, "images_per_s": CRNN_B / (step_ms * 1e-3),
            "peak": t["peak"], "profile": prof, "lstm_ms": lstm_ms,
            "ctc_ms": ctc_ms, "losses": rep["losses"], "control": ctl_diff,
            **par}


def rnn_phase(torch, seed):
    """``[rnn]`` (module docstring, 15s)."""
    import paddle_tpu_torch as paddle
    tag = "rnn"
    B, T, I, H, L = 16, 20, 64, 128, 2
    rng = np.random.RandomState(seed + 500)

    def inputs(k):
        r = np.random.RandomState(seed + 600 + k)
        lens = r.randint(1, T + 1, B)
        lens[0] = T
        return (r.randn(B, T, I).astype(np.float32), lens.astype(np.int64),
                r.randn(2 * L, B, H).astype(np.float32),
                r.randn(2 * L, B, H).astype(np.float32))

    cot = [rng.randn(B, T, 2 * H).astype(np.float32),
           rng.randn(2 * L, B, H).astype(np.float32)]
    cot = {dev: [torch.from_numpy(c).to(dev) for c in cot]
           for dev in ("cpu", "cuda")}

    def grads(net, x, lens, h0, c0, lstm):
        init = (h0, c0) if lstm else h0
        out, st = net(x, init, lens)
        h = st[0] if lstm else st
        g_out, g_h = cot[x.device.type]
        loss = (out * g_out).sum() + (h * g_h).sum()
        wrt = [x, h0] + ([c0] if lstm else []) + list(net.parameters())
        return [out] + list(torch.autograd.grad(loss, wrt))

    def err(got, ref):
        return max((a.detach().cpu() - b.detach()).abs().max().item() /
                   max(b.abs().max().item(), 1.0) for a, b in zip(got, ref))

    out = {}
    for cls in ("SimpleRNN", "LSTM", "GRU"):
        lstm = cls == "LSTM"
        paddle.seed(seed)
        cpu = getattr(paddle.nn, cls)(I, H, num_layers=L,
                                      direction="bidirectional",
                                      device="cpu")
        card = getattr(paddle.nn, cls)(I, H, num_layers=L,
                                       direction="bidirectional",
                                       device="cuda")
        card.set_state_dict(cpu.state_dict())

        def on(dev, arrays):
            x, lens, h0, c0 = arrays
            return (torch.from_numpy(x).to(dev).requires_grad_(),
                    torch.from_numpy(lens).to(dev),
                    torch.from_numpy(h0).to(dev).requires_grad_(),
                    torch.from_numpy(c0).to(dev).requires_grad_())

        a = inputs(0)
        ref = grads(cpu, *on("cpu", a), lstm)
        eager = err(grads(card, *on("cuda", a), lstm), ref)
        # captured: forward and backward in one graph on static inputs,
        # then replayed on another batch (other lengths) copied in
        static = on("cuda", a)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                grads(card, *static, lstm)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = grads(card, *static, lstm)
        b = inputs(1)
        with torch.no_grad():
            for dst, src in zip(static, on("cuda", b)):
                dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        captured = err(static_out, grads(cpu, *on("cpu", b), lstm))
        out[cls] = (eager, captured)
        check(eager <= RNN_TOL and captured <= RNN_TOL,
              f"[{tag}] {cls}: card vs CPU eager {eager:.3e}, captured "
              f"{captured:.3e} (tol {RNN_TOL})")
        del graph, static, static_out
    print(f"[{tag}] SimpleRNN, LSTM, GRU: {L} layers, bidirectional, I={I} "
          f"H={H} B={B} T={T}, ragged sequence_length and initial states, "
          f"fp32: card vs CPU largest |diff|/max(|ref|,1) over the outputs "
          f"and the gradients of the input, the initial states and every "
          f"weight (eager, captured and replayed on other lengths): "
          + ", ".join(f"{k} {e:.3e} / {c:.3e}" for k, (e, c) in out.items())
          + f" (tol {RNN_TOL})", flush=True)
    return out


# ---------------------------------------------------------------------------
# Slice 20: the rest of the nn layer families, with CycleGAN and
# R(2+1)D-18 (module docstring, 15t-15x).  No kernel of the port runs
# here: the convolutions (2-D, transposed, 3-D) are cuDNN's, the pads,
# norms and pools ATen's.
# ---------------------------------------------------------------------------
GAN_SIZE = 256            # cyclegan_cityscapes.yaml: load 286, crop 256
GAN_B = 1                 # batch_size 1, as the paper trains it
GAN_LR = 2e-4             # Adam(2e-4, beta1 0.5): paper section 4
GAN_POOL = 50             # the image pool of the paper's section 4
GAN_STEPS = 12            # [train cyclegan]: G+D steps timed
GAN_PARITY = dict(size=64, steps=3)   # [train cyclegan parity]: full widths
GAN_SHARE_MIN = 0.99      # parity gate 2: the share of parameters within
GAN_SHARE_LR = 0.1        # GAN_SHARE_LR x lr of the CPU's after the steps
VIDEO_CLASSES = 400       # Kinetics-400, torchvision's r2plus1d_18 head
VIDEO_B, VIDEO_T, VIDEO_SIZE = 32, 16, 112   # torchvision's video
                          # classification reference: 16 frames, 112 crop
VIDEO_LR, VIDEO_DECAY = 0.01, 1e-4
VIDEO_STEPS = 8           # [train r2plus1d]: K=1 replays (and eager)
VIDEO_PARITY = dict(b=2, t=8, size=56, steps=3, lr=1e-3)   # [train
                          # r2plus1d parity]: at 4x16x16 and lr 0.01 the
                          # small model's bf16 O2 losses parted by 17% in
                          # three steps on the CPU (tests/test_torch_r2plus1d)

_SLICE20 = {}


def slice20_models(nn):
    """The two user models of slice 20 on the layers of ``nn``: the
    port's ``paddle_tpu_torch.nn`` on the card, and in the CPU tests also
    the JAX package's ``paddle_tpu.nn``, which takes the same
    constructors and calls (each constructor passes ``kw``, the port's
    ``device`` / ``generator``, on to every layer; the JAX layers take
    none).  CycleGAN as PaddleGAN's ``configs/cyclegan_cityscapes.yaml``
    sets it up (Zhu et al. 2017, arXiv:1703.10593, section 4 and
    appendix 7.2) with its eager training loop, and R(2+1)D-18 as
    torchvision's ``r2plus1d_18`` builds it (Tran et al. 2018,
    arXiv:1711.11248, Table 1 and eq. 1)."""
    if nn.__name__ in _SLICE20:
        return _SLICE20[nn.__name__]

    def norm(c, kw):
        # PaddleGAN's "instance" norm: no affine, no running statistics
        return nn.InstanceNorm2D(c, weight_attr=False, bias_attr=False, **kw)

    class ResnetBlock(nn.Layer):
        """``R256``: two 3x3 convolutions on reflection pads, each with
        InstanceNorm, a ReLU between, and the input added."""

        def __init__(self, dim, pad_mode, kw):
            super().__init__()
            self.conv_block = nn.Sequential(
                nn.Pad2D([1, 1, 1, 1], mode=pad_mode),
                nn.Conv2D(dim, dim, 3, **kw), norm(dim, kw), nn.ReLU(),
                nn.Pad2D([1, 1, 1, 1], mode=pad_mode),
                nn.Conv2D(dim, dim, 3, **kw), norm(dim, kw))

        def forward(self, x):
            return x + self.conv_block(x)

    class ResnetGenerator(nn.Layer):
        """PaddleGAN's ``ResnetGenerator``: ``c7s1-ngf, d2ngf, d4ngf,
        R4ngf x n_blocks, u2ngf, ungf, c7s1-3`` (appendix 7.2), the
        convolutions with biases (PaddleGAN's ``use_bias`` under
        InstanceNorm), ``Conv2DTranspose(stride 2, padding 1,
        output_padding 1)`` to upsample, ``Tanh`` out.  ``pad_mode``
        "constant" is the parity phases' control (zero padding)."""

        def __init__(self, ngf=64, n_blocks=9, pad_mode="reflect", kw=None):
            super().__init__()
            kw = kw or {}
            layers = [nn.Pad2D([3, 3, 3, 3], mode=pad_mode),
                      nn.Conv2D(3, ngf, 7, **kw), norm(ngf, kw), nn.ReLU()]
            for i in range(2):
                m = 2 ** i
                layers += [nn.Conv2D(ngf * m, ngf * m * 2, 3, stride=2,
                                     padding=1, **kw),
                           norm(ngf * m * 2, kw), nn.ReLU()]
            layers += [ResnetBlock(ngf * 4, pad_mode, kw)
                       for _ in range(n_blocks)]
            for i in range(2):
                m = 2 ** (2 - i)
                layers += [nn.Conv2DTranspose(ngf * m, ngf * m // 2, 3,
                                              stride=2, padding=1,
                                              output_padding=1, **kw),
                           norm(ngf * m // 2, kw), nn.ReLU()]
            layers += [nn.Pad2D([3, 3, 3, 3], mode=pad_mode),
                       nn.Conv2D(ngf, 3, 7, **kw), nn.Tanh()]
            self.model = nn.Sequential(*layers)

        def forward(self, x):
            return self.model(x)

    class NLayerDiscriminator(nn.Layer):
        """The 70x70 PatchGAN ``C64-C128-C256-C512`` (appendix 7.2):
        4x4 convolutions, LeakyReLU(0.2), InstanceNorm on all but the
        first block, then a 1-channel 4x4 convolution (30x30 patches
        at 256)."""

        def __init__(self, ndf=64, n_layers=3, kw=None):
            super().__init__()
            kw = kw or {}
            layers = [nn.Conv2D(3, ndf, 4, stride=2, padding=1, **kw),
                      nn.LeakyReLU(0.2)]
            mult = 1
            for n in range(1, n_layers + 1):
                prev, mult = mult, min(2 ** n, 8)
                layers += [nn.Conv2D(ndf * prev, ndf * mult, 4,
                                     stride=2 if n < n_layers else 1,
                                     padding=1, **kw),
                           norm(ndf * mult, kw), nn.LeakyReLU(0.2)]
            layers.append(nn.Conv2D(ndf * mult, 1, 4, stride=1, padding=1,
                                    **kw))
            self.model = nn.Sequential(*layers)

        def forward(self, x):
            return self.model(x)

    class ImagePool:
        """The paper's history of generated images (section 4), at
        batch 1: until ``size`` images are held each new one is kept
        and returned; after that, with probability 1/2 a held image is
        returned and the new one takes its place.  The draws come from
        ``rng`` (numpy), so both packages take the same ones."""

        def __init__(self, size, rng):
            self.size, self.rng, self.images = size, rng, []

        def query(self, image):
            if self.size == 0:
                return image
            if len(self.images) < self.size:
                self.images.append(image.detach())
                return image
            if self.rng.uniform(0, 1) > 0.5:
                i = int(self.rng.integers(0, self.size))
                held, self.images[i] = self.images[i], image.detach()
                return held
            return image

    class CycleGAN(nn.Layer):
        """PaddleGAN's ``CycleGANModel`` and its ``train_iter``: two
        generators, two discriminators, ``Adam(lr, beta1=0.5)`` for the
        generators together and for the discriminators together, LSGAN
        (``MSELoss`` against 1 and 0), cycle L1 x ``lambda_cycle`` and
        identity L1 x ``lambda_cycle * lambda_idt``, image pools of
        ``pool_size``.  :meth:`train_step` is one G step with the
        discriminators' ``trainable`` off, then one D step on the pooled,
        detached fakes, each ``clear_grad``, ``backward``, ``step``."""

        def __init__(self, optimizer, ngf=64, n_blocks=9, ndf=64, lr=GAN_LR,
                     pool_size=GAN_POOL, lambda_cycle=10.0, lambda_idt=0.5,
                     pad_mode="reflect", seed=0, kw=None):
            super().__init__()
            self.netG_A = ResnetGenerator(ngf, n_blocks, pad_mode, kw)
            self.netG_B = ResnetGenerator(ngf, n_blocks, pad_mode, kw)
            self.netD_A = NLayerDiscriminator(ndf, kw=kw)
            self.netD_B = NLayerDiscriminator(ndf, kw=kw)
            self.optG = optimizer.Adam(
                lr, beta1=0.5, beta2=0.999, parameters=list(
                    self.netG_A.parameters()) + list(
                    self.netG_B.parameters()))
            self.optD = optimizer.Adam(
                lr, beta1=0.5, beta2=0.999, parameters=list(
                    self.netD_A.parameters()) + list(
                    self.netD_B.parameters()))
            self.l1, self.mse = nn.L1Loss(), nn.MSELoss()
            self.lam, self.idt = lambda_cycle, lambda_idt
            rng = np.random.default_rng(seed)
            self.pool_A = ImagePool(pool_size, rng)
            self.pool_B = ImagePool(pool_size, rng)

        def gan_loss(self, pred, real):
            target = pred.detach() * 0.0 + (1.0 if real else 0.0)
            return self.mse(pred, target)

        @staticmethod
        def set_requires_grad(nets, flag):
            for net in nets:
                for p in net.parameters():
                    p.trainable = flag

        def g_loss(self, real_A, real_B):
            """The generators' loss and the fakes (PaddleGAN's
            ``forward`` and ``backward_G``)."""
            fake_B = self.netG_A(real_A)
            rec_A = self.netG_B(fake_B)
            fake_A = self.netG_B(real_B)
            rec_B = self.netG_A(fake_A)
            idt_w = self.lam * self.idt
            losses = {
                "idt_A": self.l1(self.netG_A(real_B), real_B) * idt_w,
                "idt_B": self.l1(self.netG_B(real_A), real_A) * idt_w,
                "G_A": self.gan_loss(self.netD_A(fake_B), True),
                "G_B": self.gan_loss(self.netD_B(fake_A), True),
                "cycle_A": self.l1(rec_A, real_A) * self.lam,
                "cycle_B": self.l1(rec_B, real_B) * self.lam}
            total = losses["idt_A"] + losses["idt_B"] + losses["G_A"] + \
                losses["G_B"] + losses["cycle_A"] + losses["cycle_B"]
            return total, losses, fake_A, fake_B

        def d_loss(self, net, real, fake):
            loss_real = self.gan_loss(net(real), True)
            loss_fake = self.gan_loss(net(fake.detach()), False)
            return (loss_real + loss_fake) * 0.5

        def train_step(self, real_A, real_B):
            """One G step and one D step; the losses (tensors)."""
            self.set_requires_grad([self.netD_A, self.netD_B], False)
            self.optG.clear_grad()
            total, losses, fake_A, fake_B = self.g_loss(real_A, real_B)
            total.backward()
            self.optG.step()
            self.set_requires_grad([self.netD_A, self.netD_B], True)
            self.optD.clear_grad()
            losses["D_A"] = self.d_loss(self.netD_A, real_B,
                                        self.pool_B.query(fake_B))
            losses["D_A"].backward()
            losses["D_B"] = self.d_loss(self.netD_B, real_A,
                                        self.pool_A.query(fake_A))
            losses["D_B"].backward()
            self.optD.step()
            losses["G"] = total
            return {k: v.detach() for k, v in losses.items()}

    def conv2plus1d(cin, cout, mid, stride, kw):
        """Eq. 1's factored 3x3x3: a (1, 3, 3) spatial convolution to
        ``mid`` channels, BatchNorm, ReLU, a (3, 1, 1) temporal one."""
        return [nn.Conv3D(cin, mid, (1, 3, 3), stride=(1, stride, stride),
                          padding=(0, 1, 1), bias_attr=False, **kw),
                nn.BatchNorm3D(mid, **kw), nn.ReLU(),
                nn.Conv3D(mid, cout, (3, 1, 1), stride=(stride, 1, 1),
                          padding=(1, 0, 0), bias_attr=False, **kw)]

    class BasicBlock(nn.Layer):
        """torchvision's ``BasicBlock`` with ``Conv2Plus1D``: ``mid =
        (in * planes * 27) // (in * 9 + 3 * planes)`` channels between the
        factored convolutions (eq. 1's parameter match), a 1x1x1
        projection with BatchNorm where the shape changes."""

        def __init__(self, inplanes, planes, stride, kw):
            super().__init__()
            mid = (inplanes * planes * 27) // (inplanes * 9 + 3 * planes)
            self.conv1 = nn.Sequential(
                *conv2plus1d(inplanes, planes, mid, stride, kw),
                nn.BatchNorm3D(planes, **kw), nn.ReLU())
            self.conv2 = nn.Sequential(
                *conv2plus1d(planes, planes, mid, 1, kw),
                nn.BatchNorm3D(planes, **kw))
            self.downsample = None
            if stride != 1 or inplanes != planes:
                self.downsample = nn.Sequential(
                    nn.Conv3D(inplanes, planes, 1, stride=stride,
                              bias_attr=False, **kw),
                    nn.BatchNorm3D(planes, **kw))
            self.relu = nn.ReLU()

        def forward(self, x):
            res = x if self.downsample is None else self.downsample(x)
            return self.relu(self.conv2(self.conv1(x)) + res)

    class R2Plus1D(nn.Layer):
        """R(2+1)D-18 (Table 1; torchvision's ``VideoResNet`` with
        ``R2Plus1dStem``: (1, 7, 7) stride (1, 2, 2) to 45 channels,
        (3, 1, 1) to 64), four stages of ``layers`` blocks at ``widths``,
        ``AdaptiveAvgPool3D(1)`` and ``Linear(widths[-1], classes)``;
        ``[N, 3, T, H, W]`` clips in.  Paddle's default initializers
        (KaimingUniform convolutions) where torchvision's are Kaiming
        normal: the weights are random from a seed either way."""

        def __init__(self, num_classes=VIDEO_CLASSES, layers=(2, 2, 2, 2),
                     widths=(64, 128, 256, 512), stem_mid=45, kw=None):
            super().__init__()
            kw = kw or {}
            self.stem = nn.Sequential(
                nn.Conv3D(3, stem_mid, (1, 7, 7), stride=(1, 2, 2),
                          padding=(0, 3, 3), bias_attr=False, **kw),
                nn.BatchNorm3D(stem_mid, **kw), nn.ReLU(),
                nn.Conv3D(stem_mid, widths[0], (3, 1, 1), stride=1,
                          padding=(1, 0, 0), bias_attr=False, **kw),
                nn.BatchNorm3D(widths[0], **kw), nn.ReLU())
            inplanes, stages = widths[0], []
            for i, (n, planes) in enumerate(zip(layers, widths)):
                blocks = []
                for j in range(n):
                    stride = 2 if i > 0 and j == 0 else 1
                    blocks.append(BasicBlock(inplanes, planes, stride, kw))
                    inplanes = planes
                stages.append(nn.Sequential(*blocks))
            self.layer1, self.layer2, self.layer3, self.layer4 = stages
            self.avgpool = nn.AdaptiveAvgPool3D(1)
            self.flatten = nn.Flatten()
            self.fc = nn.Linear(widths[-1], num_classes, **kw)

        def forward(self, x):
            x = self.stem(x)
            for stage in (self.layer1, self.layer2, self.layer3,
                          self.layer4):
                x = stage(x)
            return self.fc(self.flatten(self.avgpool(x)))

    out = dict(ResnetGenerator=ResnetGenerator,
               NLayerDiscriminator=NLayerDiscriminator, CycleGAN=CycleGAN,
               ImagePool=ImagePool, R2Plus1D=R2Plus1D)
    _SLICE20[nn.__name__] = out
    return out


def in_noise_leaves(net, nn):
    """The names of ``net``'s parameters whose gradient is rounding noise:
    the bias of a convolution whose output goes straight into an
    InstanceNorm without affine (which removes any per-channel shift),
    PaddleGAN's ``use_bias`` under InstanceNorm."""
    names = {id(p): n for n, p in net.named_parameters()}
    out = []
    for _, seq in net.named_sublayers():
        if not isinstance(seq, nn.Sequential):
            continue
        layers = list(seq.children())
        for conv, nxt in zip(layers, layers[1:]):
            if isinstance(conv, (nn.Conv2D, nn.Conv2DTranspose)) and \
                    isinstance(nxt, nn.InstanceNorm2D) and \
                    conv.bias is not None:
                out.append(names[id(conv.bias)])
    return sorted(out)



NN_TOL = 1e-4             # [nn layers]: fp32 card vs CPU, x max(|ref|, 1)
NN_BF16_TOL = 5e-2        # [nn layers]: bf16 O2 card vs CPU


def _nn_cases(torch):
    """``[nn layers]``' cases by family: ``(name, make, shapes, o2)`` where
    ``make()`` builds the function on the CPU (a layer's parameters drawn
    there, the card's copy made by :func:`_on`) and ``shapes`` are its
    float inputs' shapes; ``o2`` marks the cases also run in bf16 under
    O2.  Every layer class and function of slice 20 is a case; a
    family's first case has a control (``controls``)."""
    import inspect
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import activation as A
    from paddle_tpu_torch.ops import nn_ops as O

    def layer(ctor, *args, **kw):
        takes = inspect.signature(ctor).parameters

        def make():
            gen = torch.Generator().manual_seed(7)
            extra = {k: v for k, v in (("device", "cpu"), ("generator", gen))
                     if k in takes}
            return ctor(*args, **kw, **extra)
        return make

    def fn(f, *args, **kw):
        return lambda: (lambda *xs: f(*xs, *args, **kw))

    x3, x4, x5 = (2, 6, 20), (2, 6, 12, 10), (2, 4, 6, 10, 8)
    conv = [
        ("conv1d", fn(F.conv1d, None, 2, [1, 2], 2, 2), [x3, (4, 3, 3)],
         True),
        ("conv3d", fn(F.conv3d, None, (1, 2, 2), (0, 1, 1)),
         [x5, (8, 4, 1, 3, 3)], True),
        ("conv2d_transpose", fn(F.conv2d_transpose, None, 2, 1, 1),
         [x4, (6, 3, 3, 3)], True),
        ("conv1d_transpose", fn(F.conv1d_transpose, None, 2, 1, 1, 1, 2),
         [x3, (6, 2, 3)], True),
        ("conv3d_transpose", fn(F.conv3d_transpose, None, 2, 1, 1),
         [x5, (4, 3, 3, 3, 3)], True),
        ("Conv1D", layer(nn.Conv1D, 6, 8, 3, 1, 1), [x3], True),
        ("Conv3D", layer(nn.Conv3D, 4, 8, (3, 1, 1), 1, (1, 0, 0)), [x5],
         True),
        ("Conv1DTranspose", layer(nn.Conv1DTranspose, 6, 4, 3, 2, 1, 1),
         [x3], True),
        ("Conv2DTranspose", layer(nn.Conv2DTranspose, 6, 4, 3, 2, 1, 1),
         [x4], True),
        ("Conv3DTranspose", layer(nn.Conv3DTranspose, 4, 2, 3, 2, 1, 1),
         [x5], True)]
    pool = [
        ("max_pool1d", fn(F.max_pool1d, 3, 2, 1), [x3], True),
        ("avg_pool1d", fn(F.avg_pool1d, 3, 2, 1), [x3], True),
        ("max_pool3d", fn(F.max_pool3d, 3, 2, 1), [x5], True),
        ("avg_pool3d", fn(F.avg_pool3d, 3, 2, 1, True), [x5], True),
        ("adaptive_avg_pool1d", fn(F.adaptive_avg_pool1d, 7), [x3], True),
        ("adaptive_max_pool1d", fn(F.adaptive_max_pool1d, 7), [x3], True),
        ("adaptive_avg_pool3d", fn(F.adaptive_avg_pool3d, (2, 3, 3)), [x5],
         True),
        ("adaptive_max_pool3d", fn(F.adaptive_max_pool3d, 2), [x5], True),
        ("max_unpool1d", fn(lambda x: F.max_unpool1d(
            *F.max_pool1d(x, 2, return_mask=True), 2)), [x3], False),
        ("max_unpool2d", fn(lambda x: F.max_unpool2d(
            *F.max_pool2d(x, 2, return_mask=True), 2)), [x4], False),
        ("max_unpool3d", fn(lambda x: F.max_unpool3d(
            *F.max_pool3d(x, 2, return_mask=True), 2)), [x5], False),
        ("MaxPool1D", layer(nn.MaxPool1D, 3, 2), [x3], True),
        ("AvgPool1D", layer(nn.AvgPool1D, 3, 2, 1, False), [x3], True),
        ("MaxPool3D", layer(nn.MaxPool3D, (1, 2, 2)), [x5], True),
        ("AvgPool3D", layer(nn.AvgPool3D, 2, 1, 1), [x5], True),
        ("AdaptiveAvgPool1D", layer(nn.AdaptiveAvgPool1D, 3), [x3], True),
        ("AdaptiveMaxPool1D", layer(nn.AdaptiveMaxPool1D, 3), [x3], True),
        ("AdaptiveAvgPool3D", layer(nn.AdaptiveAvgPool3D, 1), [x5], True),
        ("AdaptiveMaxPool3D", layer(nn.AdaptiveMaxPool3D, 2), [x5], True),
        ("MaxUnPool1D", fn(lambda x: nn.MaxUnPool1D(2)(
            *F.max_pool1d(x, 2, return_mask=True))), [x3], False),
        ("MaxUnPool2D", fn(lambda x: nn.MaxUnPool2D(2)(
            *F.max_pool2d(x, 2, return_mask=True))), [x4], False),
        ("MaxUnPool3D", fn(lambda x: nn.MaxUnPool3D(2)(
            *F.max_pool3d(x, 2, return_mask=True))), [x5], False)]
    c6 = (6,)
    norm = [
        ("instance_norm", fn(F.instance_norm), [x4, c6, c6], True),
        ("group_norm", fn(lambda x, w, b: F.group_norm(x, 3, w, b)),
         [x4, c6, c6], True),
        ("rms_norm", fn(F.rms_norm), [x4, (10,), (10,)], True),
        ("layer_norm", fn(lambda x, w: F.layer_norm(x, 10, w)),
         [x4, (10,)], True),
        ("local_response_norm", fn(F.local_response_norm, 3), [x4], True),
        ("batch_norm 3-D", fn(lambda x: F.batch_norm(
            x, torch.zeros(4, device=x.device),
            torch.ones(4, device=x.device), training=True,
            data_format="NCDHW")), [x5], True),
        ("InstanceNorm1D", layer(nn.InstanceNorm1D, 6), [x3], True),
        ("InstanceNorm2D (no affine)", layer(
            nn.InstanceNorm2D, 6, weight_attr=False, bias_attr=False), [x4],
         True),
        ("InstanceNorm3D", layer(nn.InstanceNorm3D, 4), [x5], True),
        ("GroupNorm", layer(nn.GroupNorm, 2, 6), [x4], True),
        ("RMSNorm", layer(nn.RMSNorm, 10), [x4], True),
        ("LayerNorm (no bias)", layer(nn.LayerNorm, 10, 1e-5, None, False),
         [x4], True),
        ("LocalResponseNorm", layer(nn.LocalResponseNorm, 5), [x4], True),
        ("BatchNorm3D", layer(nn.BatchNorm3D, 4), [x5], True),
        ("SyncBatchNorm", layer(nn.SyncBatchNorm, 6), [x4], True),
        ("SpectralNorm", layer(nn.SpectralNorm, (6, 4, 3), 1, 2),
         [(6, 4, 3)], False)]
    act = [(n, fn(getattr(A, n), *a), [x4], False) for n, a in (
        ("leaky_relu", (0.2,)), ("elu", (0.7,)), ("selu", ()),
        ("celu", (1.5,)), ("log_sigmoid", ()), ("hardtanh", (-1.5, 2.0)),
        ("tanhshrink", ()), ("softplus", (2.0, 5.0)), ("softsign", ()),
        ("softshrink", (0.3,)), ("hardshrink", (0.4,)), ("mish", ()),
        ("tanh", ()), ("thresholded_relu", (0.5, -0.25)),
        ("rrelu", (0.1, 0.3)), ("softmax", (1,)), ("log_softmax", (3,)),
        ("glu", (1,)), ("maxout", (2, 1)))]
    act += [("prelu", fn(A.prelu), [x4, c6], False),
            ("rrelu_apply", fn(A.rrelu_apply), [x4, x4], False),
            ("gumbel_softmax_apply", fn(A.gumbel_softmax_apply, 0.5, True),
             [x4, x4], False)]
    act += [(n, layer(getattr(nn, n), *a), [x4], False) for n, a in (
        ("LeakyReLU", (0.2,)), ("ELU", ()), ("SELU", ()), ("CELU", ()),
        ("LogSigmoid", ()), ("Hardtanh", ()), ("Tanh", ()),
        ("Tanhshrink", ()), ("Softplus", ()), ("Softsign", ()),
        ("Softshrink", ()), ("Hardshrink", ()), ("Mish", ()),
        ("ThresholdedReLU", ()), ("Maxout", (3,)), ("GLU", (1,)),
        ("Softmax", (1,)), ("LogSoftmax", ()), ("Softmax2D", ()),
        ("PReLU", (6, 0.1)))]

    def rrelu_eval():
        m = nn.RReLU(0.1, 0.3)
        m.eval()
        return m

    act.append(("RReLU (eval)", rrelu_eval, [x4], False))
    grid = (2, 5, 4, 2)
    misc = [
        ("pad reflect", fn(F.pad, [3, 3, 3, 3], "reflect"), [x4], True),
        ("pad replicate 3-D", fn(F.pad, [1, 2, 0, 1, 2, 0], "replicate",
                                 0.0, "NCDHW"), [x5], True),
        ("pad circular", fn(F.pad, [2, 1], "circular", 0.0, "NCL"), [x3],
         True),
        ("pad constant NHWC", fn(F.pad, [1, 2, 3, 4], "constant", 0.5,
                                 "NHWC"), [x4], True),
        ("Pad1D", layer(nn.Pad1D, [2, 1], "reflect"), [x3], True),
        ("Pad2D", layer(nn.Pad2D, 1, "replicate"), [x4], True),
        ("Pad3D", layer(nn.Pad3D, [1, 1, 0, 1, 1, 0]), [x5], True),
        ("ZeroPad2D", layer(nn.ZeroPad2D, [1, 0, 2, 1]), [x4], True),
        ("Flatten", layer(nn.Flatten, 1, 2), [x4], False),
        ("Unflatten", layer(nn.Unflatten, 1, [2, 3]), [x4], False),
        ("Upsample", layer(nn.Upsample, None, 2, "nearest"), [x4], False),
        ("UpsamplingBilinear2D", layer(nn.UpsamplingBilinear2D, (16, 13)),
         [x4], False),
        ("UpsamplingNearest2D", layer(nn.UpsamplingNearest2D, None, 2),
         [x4], False),
        ("PixelShuffle", layer(nn.PixelShuffle, 2), [(2, 8, 5, 6)], False),
        ("PixelUnshuffle", layer(nn.PixelUnshuffle, 2), [x4], False),
        ("ChannelShuffle", layer(nn.ChannelShuffle, 3), [x4], False),
        ("Unfold", layer(nn.Unfold, [2, 3], 1, 1), [x4], False),
        ("Fold", layer(nn.Fold, [6, 7], 2), [(2, 12, 30)], False),
        ("unfold", fn(F.unfold, 3, 2, 1), [x4], False),
        ("fold", fn(F.fold, [6, 7], 2, 1, [1, 0, 0, 1]), [(2, 12, 42)],
         False),
        ("CosineSimilarity", layer(nn.CosineSimilarity, 1), [x4, x4], False),
        ("Bilinear", layer(nn.Bilinear, 5, 4, 3), [(6, 5), (6, 4)], False),
        ("bilinear", fn(F.bilinear), [(6, 5), (6, 4), (3, 5, 4), (3,)],
         False),
        ("temporal_shift", fn(F.temporal_shift, 2, 0.25), [x4], False),
        ("affine_grid", fn(F.affine_grid, [2, 1, 5, 4], False), [(2, 2, 3)],
         False),
        ("grid_sample bilinear reflection", fn(
            F.grid_sample, "bilinear", "reflection", False), [x4, grid],
         False),
        ("grid_sample nearest zeros", fn(F.grid_sample, "nearest", "zeros"),
         [x4, grid], False),
        ("normalize", fn(F.normalize, 3, 1), [x4], False),
        ("embedding", fn(lambda w: F.embedding(
            torch.arange(12, device=w.device).reshape(3, 4) % 7, w, 2)),
         [(7, 5)], False),
        ("dropout_apply", fn(lambda x, k: O.dropout_apply(x, k > 0, 0.3)),
         [x4, x4], False),
        ("alpha_dropout_apply", fn(lambda x, k: O.alpha_dropout_apply(
            x, k > 0, 0.3)), [x4, x4], False)]
    controls = {
        "conv": lambda x, w: F.conv1d(x, w.flip(-1), None, 2, [1, 2], 2, 2),
        "pool": lambda x: F.avg_pool1d(x, 3, 2, 1),
        "norm": lambda x, w, b: F.instance_norm(x, w, b, 1e-2),
        "act": lambda x: A.leaky_relu(x, 0.21),
        "misc": lambda x: F.pad(x, [3, 3, 3, 3], "replicate")}
    return {"conv": conv, "pool": pool, "norm": norm, "act": act,
            "misc": misc}, controls


def _nn_run(torch, f, inputs, g_seed):
    """``f`` on ``inputs`` (float ones requiring grad) and the gradients
    of the inputs and of ``f``'s parameters (when it is a layer) for one
    random cotangent: a list of tensors on the CPU (fp32)."""
    out = f(*inputs)
    outs = [out] if isinstance(out, torch.Tensor) else list(out)
    dense = [o for o in outs if o.is_floating_point()]
    gen = torch.Generator().manual_seed(g_seed)
    cots = [torch.randn(o.shape, generator=gen).to(o.device, o.dtype)
            for o in dense]
    wrt = [t for t in inputs if t.requires_grad]
    if isinstance(f, torch.nn.Module):
        wrt += [p for p in f.parameters() if p.requires_grad]
    grads = []
    if wrt and any(o.requires_grad for o in dense):
        loss = sum((o.float() * c.float()).sum() for o, c in zip(dense, cots)
                   if o.requires_grad)
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    res = outs + [g for g in grads if g is not None]
    return [r.detach().float().cpu() if r.is_floating_point() else
            r.detach().cpu() for r in res]


def _nn_err(torch, got, ref):
    """max |a - b| / max(|b|, 1) over the results; integer results (the
    pools' masks) must be equal (inf otherwise)."""
    worst = 0.0
    for a, b in zip(got, ref):
        if not b.is_floating_point():
            worst = max(worst, 0.0 if torch.equal(a, b) else float("inf"))
            continue
        worst = max(worst, float((a - b).abs().max()) / max(
            float(b.abs().max()), 1.0))
    return worst


def _nn_inputs(torch, shapes, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(dev).requires_grad_()
            for s in shapes]


def _on(torch, f, dev):
    """A copy of the CPU-built ``f`` on ``dev`` (a layer's state moved as
    it is; a function stays itself)."""
    import copy
    return copy.deepcopy(f).to(dev) if isinstance(f, torch.nn.Module) \
        else f


def nn_layers_phase(torch, seed):
    """``[nn layers]`` (module docstring, 15t)."""
    import paddle_tpu_torch as paddle
    tag = "nn layers"
    families, controls = _nn_cases(torch)
    worst, o2_worst, counted = {}, {}, 0
    for fam, cases in families.items():
        for i, (name, make, shapes, o2) in enumerate(cases):
            f = make()
            card = _on(torch, f, "cuda")     # before f's buffers move
            ref = _nn_run(torch, f, _nn_inputs(torch, shapes, seed + i,
                                               "cpu"), seed)
            got = _nn_run(torch, card, _nn_inputs(torch, shapes, seed + i,
                                                  "cuda"), seed)
            err = _nn_err(torch, got, ref)
            check(err <= NN_TOL, f"[{tag}] {fam} {name}: card vs CPU "
                  f"{err:.3e} (tol {NN_TOL})")
            worst[fam] = max(worst.get(fam, (0.0, "")), (err, name))
            counted += 1
            if o2:
                with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
                    ref = _nn_run(torch, make(), _nn_inputs(
                        torch, shapes, seed + i, "cpu"), seed)
                    got = _nn_run(torch, _on(torch, make(), "cuda"),
                                  _nn_inputs(torch, shapes, seed + i,
                                             "cuda"), seed)
                err = _nn_err(torch, got, ref)
                check(err <= NN_BF16_TOL, f"[{tag}] {fam} {name} bf16 O2: "
                      f"card vs CPU {err:.3e} (tol {NN_BF16_TOL})")
                o2_worst[fam] = max(o2_worst.get(fam, (0.0, "")),
                                    (err, name))
        # the control: the family's first case with one argument changed
        # on the card must fail the same gate
        name, make, shapes, _ = cases[0]
        ref = _nn_run(torch, make(), _nn_inputs(torch, shapes, seed, "cpu"),
                      seed)
        got = _nn_run(torch, controls[fam], _nn_inputs(
            torch, shapes, seed, "cuda"), seed)
        c_err = _nn_err(torch, got, ref) if [g.shape for g in got] == \
            [r.shape for r in ref] else float("inf")
        check(c_err > NN_TOL, f"[{tag}] {fam}: the control passed the gate "
              f"({c_err:.3e})")
        print(f"[{tag}] {fam}: {len(cases)} cases, largest card vs CPU "
              f"|diff|/max(|ref|,1) over the outputs and the gradients of "
              f"the inputs and parameters, fp32: {worst[fam][0]:.3e} "
              f"({worst[fam][1]}; tol {NN_TOL})" + (
                  f"; bf16 O2: {o2_worst[fam][0]:.3e} ({o2_worst[fam][1]}; "
                  f"tol {NN_BF16_TOL})" if fam in o2_worst else "") +
              f"; the control ({name} changed) {c_err:.3e} (must fail)",
              flush=True)
    reparam = _nn_reparam(torch, seed, tag)
    drops = _nn_dropouts(torch, tag)
    return {"worst": worst, "o2_worst": o2_worst, "cases": counted,
            "reparam": reparam, "dropouts": drops}


def _nn_dropouts(torch, tag):
    """The dropouts' own draws on the card: about ``p`` of the elements
    (of the channels, for the 2-D / 3-D ones) dropped, the kept ones as
    the formulas give them, one draw shared along the dims ``axis``
    leaves out; ``RReLU``'s slopes in [lower, upper]; the Gumbel
    softmax's argmax shares following the softmax."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import nn_ops as O
    x = torch.rand(64, 32, 8, 8, 8, device="cuda") + 1.0
    out = {}
    for name, layer, shared in (
            ("Dropout(axis=[0, 1])", nn.Dropout(0.3, [0, 1]), (2, 3, 4)),
            ("Dropout3D", nn.Dropout3D(0.3), (2, 3, 4)),
            ("Dropout2D", nn.Dropout2D(0.3), (2, 3)),
            ("Dropout(downscale_in_infer)",
             nn.Dropout(0.3, mode="downscale_in_infer"), ())):
        xin = x if name != "Dropout2D" else x[..., 0]
        y = layer(xin)
        keep = y != 0
        want = O.dropout_apply(xin, keep, 0.3, layer.mode if hasattr(
            layer, "mode") else "upscale_in_train")
        check(torch.equal(y, want), f"[{tag}] {name}: kept values")
        for d in shared:
            check(bool((keep == keep.narrow(d, 0, 1)).all()),
                  f"[{tag}] {name}: the mask is not shared along dim {d}")
        out[name] = float(keep.float().mean())
        check(abs(out[name] - 0.7) < 0.02, f"[{tag}] {name}: kept share "
              f"{out[name]:.4f}")
    y = nn.AlphaDropout(0.3)(x)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = (0.7 * (1 + 0.3 * alpha_p ** 2)) ** -0.5
    kept = (y - (a * alpha_p - a * alpha_p * 0.3)).abs() > 1e-5
    out["AlphaDropout"] = float(kept.float().mean())
    check(abs(out["AlphaDropout"] - 0.7) < 0.02 and torch.allclose(
        y[kept], a * x[kept] - a * alpha_p * 0.3, rtol=1e-5),
          f"[{tag}] AlphaDropout")
    xs = torch.randn(256, 4096, device="cuda")
    slope = nn.RReLU(0.1, 0.3)(xs)[xs < 0] / xs[xs < 0]
    out["RReLU slope range"] = (float(slope.min()), float(slope.max()),
                                float(slope.mean()))
    check(float(slope.min()) >= 0.1 - 1e-6 and float(slope.max()) <= 0.3 +
          1e-6 and abs(float(slope.mean()) - 0.2) < 0.005,
          f"[{tag}] RReLU slopes {out['RReLU slope range']}")
    logits = torch.tensor([1.0, 0.0, -1.0], device="cuda").repeat(20000, 1)
    share = F.gumbel_softmax(logits, 1.0, True).mean(0)
    out["gumbel argmax share"] = [round(float(v), 4) for v in share]
    check(float((share - logits[0].softmax(0)).abs().max()) < 0.02,
          f"[{tag}] gumbel_softmax shares {out['gumbel argmax share']}")
    print(f"[{tag}] the card's own draws: kept shares (p = 0.3) "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()
                      if isinstance(v, float))
          + f"; RReLU(0.1, 0.3) slopes min/max/mean "
          f"{out['RReLU slope range']}; gumbel_softmax(hard) argmax shares "
          f"{out['gumbel argmax share']} (softmax "
          f"{[round(float(v), 4) for v in logits[0].softmax(0)]})",
          flush=True)
    return out


def _nn_reparam(torch, seed, tag):
    """``weight_norm`` and ``spectral_norm`` in a network trained by
    ``Model.fit`` on the card (K=1: every step a replay of the captured
    step, so the hooks run inside the graph) against the same fit on
    the CPU, three SGD steps: the parameters, the power iteration's
    buffers and the losses; a control whose card network normalises the
    spectral norm's weight over dim 1 must fail."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import utils

    def build(dev, sn_dim=0):
        paddle.seed(seed)
        gen = torch.Generator().manual_seed(seed)
        net = nn.Sequential(
            nn.Conv2D(3, 8, 3, padding=1, device="cpu", generator=gen),
            nn.ReLU(), nn.Conv2D(8, 8, 3, stride=2, device="cpu",
                                 generator=gen),
            nn.Flatten(), nn.Linear(8 * 7 * 7, 5, device="cpu",
                                    generator=gen))
        utils.weight_norm(net[0])
        utils.spectral_norm(net[2], dim=sn_dim, generator=gen)
        utils.weight_norm(net[4], dim=None)
        net.to(dev)
        opt = paddle.optimizer.SGD(0.05, parameters=net.parameters())
        model = paddle.Model(net, device=dev)
        model.prepare(opt, nn.CrossEntropyLoss())
        return net, model

    rng = np.random.default_rng(seed + 900)
    batches = [(torch.from_numpy(rng.standard_normal((4, 3, 16, 16)).astype(
        np.float32)), torch.from_numpy(rng.integers(0, 5, (4,))))
        for _ in range(3)]
    ends = {}
    for run, dev, sn_dim in (("cpu", "cpu", 0), ("card", "cuda", 0),
                             ("control", "cuda", 1)):
        net, model = build(dev, sn_dim)
        keep = _loss_keeper()
        model.fit(batches, epochs=1, verbose=0, callbacks=[keep],
                  steps_per_dispatch=1 if dev == "cuda" else 0)
        graphs = model.compile_stats()
        ends[run] = ({k: v.detach().float().cpu() for k, v in
                      net.state_dict().items()}, keep.losses, graphs)
        if dev == "cuda":
            free_model(torch, tag, model)
    err, leaf = _worst(ends["card"][0], ends["cpu"][0])[0]
    c_err, c_leaf = _worst(ends["control"][0], ends["cpu"][0])[0]
    names = sorted(ends["cpu"][0])
    check("0.weight_g" in names and "2.weight_orig" in names and
          "2.weight_u" in names and "4.weight_v" in names,
          f"[{tag}] reparametrised names {names}")
    check(ends["card"][2] == {"graphs": 1, "captures": 1},
          f"[{tag}] weight-norm fit graphs {ends['card'][2]}")
    check(err <= NN_TOL, f"[{tag}] weight_norm / spectral_norm fit, card "
          f"vs CPU {err:.3e} ({leaf})")
    check(c_err > NN_TOL, f"[{tag}] the spectral_norm(dim=1) control "
          f"passed ({c_err:.3e})")
    print(f"[{tag}] weight_norm (conv, dim 0; linear, dim None) and "
          f"spectral_norm (conv) through Model.fit, 3 SGD(0.05) steps, K=1 "
          f"replays ({ends['card'][2]}) vs the CPU: parameters and the "
          f"u / v buffers {err:.3e} ({leaf}; tol {NN_TOL}); losses card "
          f"{[round(v, 6) for v in ends['card'][1]]} CPU "
          f"{[round(v, 6) for v in ends['cpu'][1]]}; the control "
          f"(spectral_norm over dim 1) {c_err:.3e} ({c_leaf}; must fail)",
          flush=True)
    return {"err": err, "control": c_err}


def _gan_group(name):
    """``[train cyclegan]``'s profile groups, by kernel name."""
    low = name.lower()
    if "fft" in low or "gemv" in low:
        return "cuDNN FFT convolutions (fft2d r2c / c2r, complex gemv)"
    if "dgrad" in low or "wgrad" in low or "fprop" in low or any(
            t in low for t in ("xmma", "cutlass", "implicit", "cudnn",
                               "conv", "gemm", "nvjet")):
        if "dgrad" in low:
            return "cuDNN conv dgrad (and transposed conv forward)"
        if "wgrad" in low:
            return "cuDNN conv wgrad"
        return "cuDNN conv forward (and transposed conv dgrad), other gemm"
    if "batch_norm" in low or "bn_" in low:
        return "InstanceNorm (batch_norm kernels)"
    if "reflection_pad" in low or "replication_pad" in low or "pad" in low:
        return "pads (reflection)"
    if "foreach" in low or "multi_tensor" in low or "adam" in low:
        return "Adam (foreach)"
    if any(t in low for t in ("nchwtonhwc", "nhwctonchw", "nchw2nhwc",
                              "nhwc2nchw")):
        return "layout transforms (NCHW <-> NHWC)"
    return "other elementwise (losses, LeakyReLU, tanh, adds, copies)"


def _video_group(name):
    """``[train r2plus1d]``'s profile groups, by kernel name."""
    low = name.lower()
    if "fft" in low or "gemv" in low:
        return "Conv3D by cuDNN's FFT (fft r2c / c2r, complex gemv)"
    if "dgrad" in low:
        return "Conv3D dgrad (cuDNN)"
    if "wgrad" in low:
        return "Conv3D wgrad (cuDNN)"
    if "fprop" in low or any(t in low for t in ("xmma", "cutlass",
                                                "implicit", "conv")):
        return "Conv3D forward (cuDNN)"
    if "batch_norm" in low or "bn_" in low or "batchnorm" in low:
        return "BatchNorm3D"
    if any(t in low for t in ("nchwtonhwc", "nhwctonchw", "nchw2nhwc",
                              "nhwc2nchw", "transpose")):
        return "layout transforms (NCDHW <-> NDHWC)"
    if "foreach" in low or "multi_tensor" in low:
        return "optimizer (foreach)"
    if "copy" in low or "cast" in low:
        return "O2 casts and copies"
    if any(t in low for t in ("gemm", "nvjet", "cublas")):
        return "matmul (cuBLAS: the head)"
    return "other elementwise (ReLU, adds, pools, loss)"


def _gan(torch, seed, dev, pad_mode="reflect"):
    """CycleGAN at its published widths on ``dev``, from ``seed``: the
    parameters drawn on the CPU and copied into a model built on
    ``dev`` (whose optimizers hold its own parameters), so the card's
    and the CPU's start alike; the image pools' draws from ``seed``."""
    import paddle_tpu_torch as paddle
    m = slice20_models(paddle.nn)
    gen = torch.Generator().manual_seed(seed)
    gan = m["CycleGAN"](paddle.optimizer, pad_mode=pad_mode, seed=seed,
                        kw=dict(device="cpu", generator=gen))
    if dev == "cpu":
        return gan
    out = m["CycleGAN"](paddle.optimizer, pad_mode=pad_mode, seed=seed,
                        kw=dict(device=dev))
    out.set_state_dict(gan.state_dict())
    return out


def _gan_images(torch, seed, n, size, dev):
    rng = np.random.default_rng(seed)
    return [tuple(torch.from_numpy(np.tanh(rng.standard_normal(
        (GAN_B, 3, size, size))).astype(np.float32)).to(dev)
        for _ in range(2)) for _ in range(n)]


def train_cyclegan_phase(torch, seed):
    """``[train cyclegan]`` (module docstring, 15u)."""
    import gc
    tag = "train cyclegan"
    gc.collect()
    torch.cuda.empty_cache()
    gan = _gan(torch, seed, "cuda")
    n_params = sum(p.numel() for p in gan.parameters())
    (a, b), = _gan_images(torch, seed + 1000, 1, GAN_SIZE, "cuda")
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(GAN_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = gan.train_step(a, b)
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(v) for step in losses for v in step.values()),
          f"[{tag}] a loss is not finite: {losses}")
    # the reconstruction terms fall on the fixed pair; the adversarial
    # terms rise while the discriminators learn
    first, last = losses[0], losses[-1]
    check(all(last[k] < first[k] for k in ("cycle_A", "cycle_B", "idt_A",
                                            "idt_B")),
          f"[{tag}] the cycle and identity losses did not fall: first "
          f"{first}, last {last}")
    step_ms = float(np.median(ms[2:]))
    prof = profile_run(torch, tag, "eager G+D",
                       lambda: [gan.train_step(a, b) for _ in range(3)], 3,
                       group=_gan_group)
    del gan
    gc.collect()
    torch.cuda.empty_cache()
    # the same steps on ATen's own convolutions (cuDNN off), a reading
    aten_ms = []
    saved = torch.backends.cudnn.enabled
    try:
        torch.backends.cudnn.enabled = False
        gan = _gan(torch, seed, "cuda")
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            gan.train_step(a, b)
            torch.cuda.synchronize()
            aten_ms.append((time.monotonic() - t0) * 1e3)
    finally:
        torch.backends.cudnn.enabled = saved
    del gan
    gc.collect()
    torch.cuda.empty_cache()
    aten_step = float(np.median(aten_ms[2:]))
    print(f"[{tag}] CycleGAN (cyclegan_cityscapes.yaml: two ResNet "
          f"generators c7s1-64,d128,d256,R256x9,u128,u64,c7s1-3 and two "
          f"70x70 PatchGANs, InstanceNorm without affine, reflection pads; "
          f"{n_params} parameters), fp32 eager, Adam({GAN_LR}, beta1 0.5), "
          f"LSGAN + cycle L1 x10 + identity x0.5, image pools of "
          f"{GAN_POOL}, {GAN_SIZE}x{GAN_SIZE} B={GAN_B}, one fixed image "
          f"pair, {GAN_STEPS} G+D steps: step_ms first={ms[0]:.3f} "
          f"median(steps 3+)={step_ms:.3f} -> "
          f"{GAN_B / (step_ms * 1e-3):.3f} image pairs/s; peak_mem_gib "
          f"{peak / 2**30:.3f}; losses first "
          f"{ {k: round(v, 4) for k, v in first.items()} } last "
          f"{ {k: round(v, 4) for k, v in last.items()} }; with cuDNN off "
          f"(ATen's convolutions) {aten_step:.3f} ms a step", flush=True)
    return {"step_ms": step_ms, "images_per_s": GAN_B / (step_ms * 1e-3),
            "first_ms": ms[0], "peak": peak, "profile": prof,
            "losses": losses, "aten_step_ms": aten_step}


def _gan_grad_errors(grads, ref, noise):
    """Each leaf's max |diff| over its own largest |CPU gradient|; the
    noise leaves' (rounding noise, :func:`in_noise_leaves`) over the
    largest gradient of all.  Returns ``{leaf: error}``."""
    top = max(float(v.abs().max()) for v in ref.values())
    return {k: float((grads[k] - v).abs().max()) / (
        top if k in noise else (float(v.abs().max()) or 1.0))
        for k, v in ref.items()}


def _gan_run(torch, seed, dev, data, pad="reflect", watch=False, force=None,
             dtype=None):
    """Train steps of :func:`_gan` on ``dev``, one per image pair of
    ``data``: step 1's gradients, the state after the last step and the
    losses; ``watch`` keeps every ReLU / LeakyReLU input (eager, in
    order) and ``force`` makes them follow another run's
    (:func:`_relu_force`); ``dtype`` float64 runs the model in it."""
    gan = _gan(torch, seed, dev, pad_mode=pad)
    if dtype is not None:
        gan = gan.to(dtype=dtype)
    seen = _relu_watch(torch, gan) if watch else None
    if force is not None:
        _relu_force(gan, force)
    losses, grads = [], None
    for a, b in data:
        out = gan.train_step(a.to(dev, dtype or a.dtype),
                             b.to(dev, dtype or b.dtype))
        losses.append({k: float(v) for k, v in out.items()})
        if grads is None:
            grads = {k: q.grad.detach().double().cpu().clone() for k, q in
                     gan.named_parameters()}
    state = {k: v.detach().double().cpu().clone() for k, v in
             gan.state_dict().items()}
    return dict(grads=grads, losses=losses, state=state, seen=seen)


def train_cyclegan_parity_phase(torch, seed):
    """``[train cyclegan parity]`` (module docstring, 15v)."""
    import paddle_tpu_torch as paddle
    tag = "train cyclegan parity"
    p = GAN_PARITY
    data = _gan_images(torch, seed + 1100, p["steps"], p["size"], "cpu")
    big = _gan_images(torch, seed + 1150, 1, GAN_SIZE, "cpu")
    noise = set()
    probe = _gan(torch, seed, "cpu")
    for name in ("netG_A", "netG_B", "netD_A", "netD_B"):
        noise |= {f"{name}.{k}" for k in in_noise_leaves(
            getattr(probe, name), paddle.nn)}
    init = {k: v.double() for k, v in probe.state_dict().items()}
    del probe
    # the main path's route, as [train cyclegan] runs it
    check(torch.backends.cudnn.enabled and not
          torch.backends.cudnn.deterministic and not
          torch.backends.cudnn.benchmark and not
          torch.backends.cudnn.allow_tf32,
          f"[{tag}] not the main path's cuDNN settings")
    card = _gan_run(torch, seed, "cuda", data, watch=True)
    ctl = _gan_run(torch, seed, "cuda", data, pad="constant")
    card_big = _gan_run(torch, seed, "cuda", big, watch=True)
    ctl_big = _gan_run(torch, seed, "cuda", big, pad="constant")
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        ref_big = _gan_run(torch, seed, "cuda", big, force=card_big["seen"],
                           dtype=torch.float64)
    cpu = _gan_run(torch, seed, "cpu", data, force=card["seen"])
    lr = GAN_LR

    def gates(run):
        errs = _gan_grad_errors(run["grads"], cpu["grads"], noise)
        leaf = max(errs, key=errs.get)
        diffs = torch.cat([(run["state"][k] - v).abs().reshape(-1)
                           for k, v in cpu["state"].items()])
        share = float((diffs <= GAN_SHARE_LR * lr).float().mean())
        return errs[leaf], leaf, share, float(diffs.max())

    def big_gate(run):
        errs = _gan_grad_errors(run["grads"], ref_big["grads"], noise)
        leaf = max(errs, key=errs.get)
        return errs[leaf], leaf

    g_err, g_leaf, share, d_max = gates(card)
    c_err, c_leaf, c_share, c_max = gates(ctl)
    b_err, b_leaf = big_gate(card_big)
    cb_err, cb_leaf = big_gate(ctl_big)
    moved = float(torch.cat([(cpu["state"][k] - v).abs().reshape(-1)
                             for k, v in init.items()]).max())
    # step 1's losses come from the same weights; the later steps' from
    # weights that Adam's steps on noise gradients moved apart by ~lr
    rel = [max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b)
           for a, b in zip(card["losses"], cpu["losses"])]
    loss_rel = rel[0]
    few = 2 * p["steps"] * lr
    print(f"[{tag}] CycleGAN at its widths, fp32, TF32 off, the card on "
          f"cuDNN's default algorithms (the timed route), the reference "
          f"run's ReLUs, LeakyReLUs and L1 losses following the card's "
          f"signs; {p['size']}x{p['size']}, card vs CPU from the same "
          f"weights: gate 1, step 1's gradients per leaf / the leaf's "
          f"largest ({len(noise)} conv biases before InstanceNorm, whose "
          f"gradients are rounding noise, / the largest of all): "
          f"{g_err:.3e} ({g_leaf}; tol {NN_TOL}); gate 2, after "
          f"{p['steps']} G+D steps of Adam({lr}): {share:.5f} of the "
          f"parameters within {GAN_SHARE_LR} x lr of the CPU's (min "
          f"{GAN_SHARE_MIN}), all within {d_max:.3e} (few lr: {few:.1e}; "
          f"the CPU moved them up to {moved:.3e}); step 1's losses "
          f"relative {loss_rel:.3e} (tol {PARITY_TOL}; the steps after: "
          f"{', '.join(f'{v:.3e}' for v in rel[1:])}); {GAN_SIZE}x"
          f"{GAN_SIZE}, gate 3, step 1's gradients per leaf against float64 "
          f"on the card by ATen's convolutions: {b_err:.3e} ({b_leaf}; tol "
          f"{NN_TOL}); the control (zero padding in place of reflection) "
          f"{c_err:.3e} ({c_leaf}), share {c_share:.5f} and at "
          f"{GAN_SIZE} {cb_err:.3e} ({cb_leaf}) (must fail all three)",
          flush=True)
    check(g_err <= NN_TOL and share >= GAN_SHARE_MIN and d_max <= few and
          loss_rel <= PARITY_TOL and b_err <= NN_TOL,
          f"[{tag}] card vs CPU: gradients {g_err:.3e}, share {share:.5f}, "
          f"largest {d_max:.3e}, losses {loss_rel:.3e}; at {GAN_SIZE} vs "
          f"float64: {b_err:.3e}")
    check(c_err > NN_TOL and c_share < GAN_SHARE_MIN and cb_err > NN_TOL,
          f"[{tag}] the zero-padding control passed a gate: gradients "
          f"{c_err:.3e}, share {c_share:.5f}, at {GAN_SIZE} {cb_err:.3e}")
    return {"grad_err": g_err, "share": share, "control_grad": c_err,
            "control_share": c_share, "grad_err_256": b_err,
            "control_grad_256": cb_err}


def _video_model(torch, seed, dev="cuda", o2=True, lr=VIDEO_LR,
                 criterion=None):
    """R(2+1)D-18 from ``seed`` (drawn on the CPU), Momentum(lr, 0.9,
    L2Decay(VIDEO_DECAY)), bf16 O2 with fp32 masters when ``o2``, in a
    ``Model`` on ``dev``."""
    import paddle_tpu_torch as paddle
    m = slice20_models(paddle.nn)
    gen = torch.Generator().manual_seed(seed)
    net = m["R2Plus1D"](kw=dict(device="cpu", generator=gen)).to(dev)
    opt = paddle.optimizer.Momentum(
        lr, 0.9, parameters=net.parameters(),
        weight_decay=paddle.regularizer.L2Decay(VIDEO_DECAY),
        multi_precision=o2)
    amp = {"level": "O2", "dtype": "bfloat16"} if o2 else None
    if o2:
        paddle.amp.decorate(net, opt, **amp)
    model = paddle.Model(net, device=dev)
    model.prepare(opt, criterion or paddle.nn.CrossEntropyLoss(),
                  amp_configs=amp)
    return net, model


def _video_batch(torch, seed, b, t, size, pinned=True):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, 3, t, size, size)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, VIDEO_CLASSES, (b,)))
    return (x.pin_memory(), y.pin_memory()) if pinned else (x, y)


def video_flops(torch, net, clip):
    """Forward FLOPs of ``net``'s convolutions and head on one ``clip``
    (2 x multiply-adds), counted from the shapes each layer sees in one
    forward in eval mode."""
    import paddle_tpu_torch as paddle
    flops = [0]

    def hook(layer, args, out):
        k = int(np.prod(layer.weight.shape[1:])) if isinstance(
            layer, paddle.nn.Conv3D) else layer.weight.shape[0]
        flops[0] += 2 * out.numel() * k

    hooks = [m.register_forward_post_hook(hook) for m in net.sublayers()
             if isinstance(m, (paddle.nn.Conv3D, paddle.nn.Linear))]
    training = net.training
    net.eval()
    with torch.no_grad():
        net(clip)
    net.train(training)
    for h in hooks:
        h.remove()
    return flops[0]


def train_r2plus1d_phase(torch, seed):
    """``[train r2plus1d]`` (module docstring, 15w)."""
    import gc
    tag = "train r2plus1d"
    gc.collect()
    torch.cuda.empty_cache()
    batch = _video_batch(torch, seed + 1200, VIDEO_B, VIDEO_T, VIDEO_SIZE)
    net, model = _video_model(torch, seed)
    n_params = sum(p.numel() for p in net.parameters())
    fwd_flops = video_flops(torch, net, batch[0][:1].cuda())
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, first_ms = _clocked_fit(torch, model, batch,
                                             VIDEO_STEPS, None)
    peak = torch.cuda.max_memory_allocated()
    check(model._fold == 1, f"[{tag}] steps_per_dispatch resolved to "
          f"{model._fold} under a per-step clock")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"[{tag}] losses {losses}")
    runner = next(iter(model._graphs.values()))
    pool = pool_reserved(torch, model._graph_pool)
    prof = profile_run(
        torch, tag, "replayed",
        lambda: model.fit([batch] * 3, epochs=1, verbose=0,
                          steps_per_dispatch=3), 3, _video_group)
    graphs = model.compile_stats()
    check(graphs == {"graphs": 1, "captures": 1},
          f"[{tag}] {graphs}: a capture after the first")
    free_model(torch, tag, model)
    del net, model
    net, model = _video_model(torch, seed)
    torch.cuda.reset_peak_memory_stats()
    e_losses, eager_ms, _ = _clocked_fit(torch, model, batch, 4, 0)
    eager_peak = torch.cuda.max_memory_allocated()
    free_model(torch, tag, model)
    del net, model
    # replays bit-equal to eager under the deterministic algorithms
    ends = {}
    with cudnn_deterministic(torch), deterministic_algorithms(torch) as w:
        for fold in (1, 0):
            net, model = _video_model(torch, seed)
            model.fit([batch] * 3, epochs=1, verbose=0,
                      steps_per_dispatch=fold)
            ends[fold] = _fit_state(torch, model)
            free_model(torch, tag, model)
            del net, model
    warned = sorted({str(x.message)[:80] for x in w})
    same = _states_equal(torch, ends[1], ends[0])
    check(same, f"[{tag}] K=1 replays vs eager under the deterministic "
          f"algorithms: {_state_diff(torch, ends[0], ends[1]):.3e}")
    ips = VIDEO_B / (step_ms * 1e-3)
    tflops = 3 * fwd_flops * ips / 1e12
    print(f"[{tag}] R(2+1)D-18 ({n_params} parameters, {VIDEO_CLASSES} "
          f"classes), bf16 O2 with fp32 masters, Momentum({VIDEO_LR}, 0.9, "
          f"L2Decay({VIDEO_DECAY})), CrossEntropyLoss, B={VIDEO_B} clips of "
          f"3x{VIDEO_T}x{VIDEO_SIZE}x{VIDEO_SIZE}, one fixed batch: losses "
          f"K=1 {[round(v, 4) for v in losses]}, eager "
          f"{[round(v, 4) for v in e_losses]}; K=1 replays: step_ms "
          f"first={first_ms:.3f} median(steps 3+)={step_ms:.3f} -> "
          f"{ips:.2f} clips/s ({tflops:.1f} TFLOP/s by the convolutions' "
          f"and the head's count, {fwd_flops / 1e9:.2f} GFLOP a clip "
          f"forward, x3 for a step; {tflops / 989:.4f} of 989); eager: "
          f"step_ms {eager_ms:.3f} -> "
          f"{VIDEO_B / (eager_ms * 1e-3):.2f} clips/s; peak_mem_gib "
          f"{peak / 2**30:.3f} replayed, {eager_peak / 2**30:.3f} eager; "
          f"capture {runner.capture_s:.3f} s, graph pool reserved "
          + (f"{pool / 2**30:.3f} GiB" if pool is not None else
             "not measured") + f"; graphs {graphs}; under the deterministic "
          f"algorithms 3 K=1 replays bit-equal to eager: {same} (warnings "
          f"{warned})", flush=True)
    return {"step_ms": step_ms, "clips_per_s": ips, "eager_ms": eager_ms,
            "gflop_clip_fwd": fwd_flops / 1e9, "tflops": tflops,
            "peak": peak, "eager_peak": eager_peak,
            "capture_s": runner.capture_s, "pool": pool, "profile": prof,
            "losses": losses}


def _video_parity_run(torch, seed, dev, batches, fold, watch=False,
                      force=None):
    """R(2+1)D-18 in fp32 on ``dev``: step 1's gradients of the first
    batch (a forward and backward of their own), then ``fit`` of one
    Momentum step a batch (``steps_per_dispatch=fold``): the gradients,
    the state after the fit, the losses, and with ``watch`` the ReLU
    inputs of the gradient run and of the fit (eager only) in order;
    ``force``: another run's, whose signs this run's ReLUs follow."""
    from paddle_tpu_torch.hapi.callbacks import Callback
    import paddle_tpu_torch as paddle
    p = VIDEO_PARITY
    net, model = _video_model(torch, seed, dev, o2=False, lr=p["lr"])
    seen = _relu_watch(torch, net) if watch else None
    if force is not None:
        _relu_force(net, force)
    x0, y0 = (t.to(dev) for t in batches[0])
    paddle.nn.CrossEntropyLoss()(net(x0), y0).backward()
    grads = {k: q.grad.detach().cpu().clone() for k, q in
             net.named_parameters()}
    net.clear_gradients()
    losses = []

    class Keep(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs["loss"][0]))

    model.fit(batches, epochs=1, verbose=0, callbacks=[Keep()],
              steps_per_dispatch=fold)
    state = {k: v.detach().float().cpu().clone() for k, v in
             net.state_dict().items()}
    if dev != "cpu":
        free_model(torch, "train r2plus1d parity", model)
    return dict(grads=grads, state=state, losses=losses, seen=seen)


def train_r2plus1d_parity_phase(torch, seed):
    """``[train r2plus1d parity]`` (module docstring, 15x)."""
    import paddle_tpu_torch as paddle
    tag = "train r2plus1d parity"
    p = VIDEO_PARITY
    batches = [_video_batch(torch, seed + 1300 + i, p["b"], p["t"],
                            p["size"], pinned=False)
               for i in range(p["steps"])]
    reversed_ = [(x.flip(2), y) for x, y in batches]
    with cudnn_deterministic(torch):
        card = _video_parity_run(torch, seed, "cuda", batches, 0, watch=True)
        replay = _video_parity_run(torch, seed, "cuda", batches, 1)
        ctl = _video_parity_run(torch, seed, "cuda", reversed_, 0)
        # the bf16 O2 forward, two draws of weights and clips: the card's
        # against the CPU's in bf16 (the gate) and in fp32, and the card's
        # with the convolutions left in fp32 (the control)
        outs = {}
        runs = (("bf16", "cuda", True, None), ("bf16", "cpu", True, None),
                ("fp32", "cpu", False, None),
                ("control", "cuda", True, ["conv3d"]))
        for i in range(2):
            for name, dev, o2, black in runs:
                net, _ = _video_model(torch, seed + i, dev, o2=o2)
                with paddle.amp.auto_cast(
                        enable=o2, level="O2", dtype="bfloat16",
                        custom_black_list=black), torch.no_grad():
                    outs[i, name, dev] = net(
                        batches[i][0].to(dev)).float().cpu()
                del net
    cpu = _video_parity_run(torch, seed, "cpu", batches, 0,
                            force=card["seen"])
    g_err, g_leaf = crnn_grad_gate(card["grads"], cpu["grads"])[0]
    c_gerr, c_gleaf = crnn_grad_gate(ctl["grads"], cpu["grads"])[0]
    err, leaf = _worst(card["state"], cpu["state"])[0]
    c_err, c_leaf = _worst(ctl["state"], cpu["state"])[0]
    same = _states_equal(torch, replay["state"], card["state"]) and \
        replay["losses"] == card["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                       cpu["losses"]))

    def o2_err(got, ref):
        return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                     1.0)

    o2_bf16 = [o2_err(outs[i, "bf16", "cuda"], outs[i, "bf16", "cpu"])
               for i in range(2)]
    o2_fp32 = [o2_err(outs[i, "bf16", "cuda"], outs[i, "fp32", "cpu"])
               for i in range(2)]
    o2_ctl = [o2_err(outs[i, "control", "cuda"], outs[i, "bf16", "cpu"])
              for i in range(2)]
    print(f"[{tag}] R(2+1)D-18 fp32, B={p['b']} clips of 3x{p['t']}x"
          f"{p['size']}x{p['size']}, cuDNN deterministic, TF32 off, card vs "
          f"CPU from the same weights, the CPU's ReLUs following the card's "
          f"signs: step 1's gradients per leaf / the leaf's largest "
          f"{g_err:.3e} ({g_leaf}; tol {CRNN_GRAD_TOL}); after {p['steps']} "
          f"Momentum({p['lr']}, 0.9, L2Decay) steps (eager; K=1 replays "
          f"bit-equal to it: {same}) parameters and BatchNorm statistics "
          f"{err:.3e} ({leaf}; tol {CARD_CPU_TOL}); losses relative "
          f"{loss_rel:.3e}; the control (clips reversed in time on the card) "
          f"{c_gerr:.3e} ({c_gleaf}) and {c_err:.3e} ({c_leaf}) (must fail "
          f"both); the bf16 O2 forward on the card against the CPU's bf16 "
          f"O2 forward, weights and clips of seeds {seed} and {seed + 1}: "
          f"{', '.join(f'{v:.3e}' for v in o2_bf16)} (tol {NN_BF16_TOL}; "
          f"against the CPU's fp32 forward "
          f"{', '.join(f'{v:.3e}' for v in o2_fp32)}, bf16's own error); "
          f"the control (the card's convolutions left in fp32 by the custom "
          f"black list) {', '.join(f'{v:.3e}' for v in o2_ctl)} (must "
          f"fail)", flush=True)
    check(g_err <= CRNN_GRAD_TOL and err <= CARD_CPU_TOL and same and
          loss_rel <= PARITY_TOL and max(o2_bf16) <= NN_BF16_TOL,
          f"[{tag}] card vs CPU: gradients {g_err:.3e}, parameters "
          f"{err:.3e}, replays bit-equal {same}, losses {loss_rel:.3e}, bf16 "
          f"O2 forward {o2_bf16}")
    check(c_gerr > CRNN_GRAD_TOL and c_err > CARD_CPU_TOL,
          f"[{tag}] the time-reversed control passed a gate: gradients "
          f"{c_gerr:.3e}, parameters {c_err:.3e}")
    check(min(o2_ctl) > NN_BF16_TOL, f"[{tag}] the fp32-convolution control "
          f"passed the bf16 O2 gate: {o2_ctl}")
    return {"grad_err": g_err, "err": err, "o2_err": o2_bf16,
            "o2_fp32_err": o2_fp32, "o2_control": o2_ctl,
            "control_grad": c_gerr, "control": c_err}


# ---------------------------------------------------------------------------
# Slice 21: sparse-embedding training (PaddleRec Wide&Deep, lazy Adam) and
# GPT-2-small under O1 with the custom lists
# ---------------------------------------------------------------------------
#: PaddleRec ``models/rank/wide_deep/config_bigdata.yaml`` (Cheng et al.
#: 2016, arXiv:1606.07792): the Criteo shape at its published widths
WD_SOURCE = ("PaddleRec models/rank/wide_deep/config_bigdata.yaml + net.py "
             "(Cheng et al. 2016, arXiv:1606.07792): Criteo, 26 sparse "
             "slots, 13 dense, Adam lr 0.001")
WD = dict(sparse_feature_number=1000001, sparse_feature_dim=9,
          dense_feature_dim=13, num_field=26, layer_sizes=(512, 256, 128, 32))
WD_B, WD_LR, WD_STEPS, WD_CTR = 512, 0.001, 50, 0.25
# [train widedeep parity]: the global-norm clip, and the step-1 gate on
# each leaf (a share of elements within a tight bound of the leaf's scale)
# and on each step's loss
WD_CLIP, WD_TIGHT, WD_SHARE, WD_LOSS_RTOL = 0.1, 1e-6, 0.9999, 2e-5
_SLICE21 = {}


def slice21_models(nn, concat):
    """PaddleRec's Wide&Deep (``models/rank/wide_deep/net.py``,
    ``WideDeepLayer``) on the layers of ``nn`` (the port's on the card,
    and in the CPU tests also the JAX package's, as
    :func:`slice20_models` builds CycleGAN) with ``concat`` the
    package's ``concat(tensors, axis)``: one ``Embedding(sparse=True)``
    table looked up once per slot, the wide ``Linear(dense, 1)``, the
    deep MLP (Linear and ReLU per ``layer_sizes``, then Linear to 1) on
    the slots' embeddings and the dense features, and the sigmoid of
    their sum.  The table draws from ``Uniform(-1, 1)``, the wide part
    from ``TruncatedNormal(0, 1/sqrt(dense))``, each MLP layer from
    ``Normal(0, 1/sqrt(fan_in))``, as ``net.py`` does, through
    ``ParamAttr``.  ``padding_idx`` (not in PaddleRec) lets the tests
    put a padding row in the table."""
    if nn.__name__ in _SLICE21:
        return _SLICE21[nn.__name__]
    init = nn.initializer

    class WideDeep(nn.Layer):
        def __init__(self, sparse_feature_number, sparse_feature_dim,
                     dense_feature_dim, num_field, layer_sizes,
                     padding_idx=None, sparse=True, **kw):
            super().__init__()
            self.num_field = num_field
            self.wide_part = nn.Linear(
                dense_feature_dim, 1, weight_attr=nn.ParamAttr(
                    initializer=init.TruncatedNormal(
                        0.0, 1.0 / math.sqrt(dense_feature_dim))), **kw)
            self.embedding = nn.Embedding(
                sparse_feature_number, sparse_feature_dim, padding_idx,
                sparse, weight_attr=nn.ParamAttr(
                    name="SparseFeatFactors", initializer=init.Uniform()),
                **kw)
            sizes = ([sparse_feature_dim * num_field + dense_feature_dim]
                     + list(layer_sizes) + [1])
            layers = []
            for i in range(len(sizes) - 1):
                layers.append(nn.Linear(
                    sizes[i], sizes[i + 1], weight_attr=nn.ParamAttr(
                        initializer=init.Normal(
                            0.0, 1.0 / math.sqrt(sizes[i]))), **kw))
                if i < len(sizes) - 2:
                    layers.append(nn.ReLU())
            self.mlp = nn.Sequential(*layers)

        def forward(self, sparse_ids, dense):
            """``sparse_ids`` ``[B, num_field]`` int64, ``dense`` ``[B,
            dense]``: the click probability ``[B, 1]``."""
            embs = [self.embedding(sparse_ids[:, k])
                    for k in range(self.num_field)]
            deep = self.mlp(concat(embs + [dense], 1))
            return nn.functional.sigmoid(self.wide_part(dense) + deep)

    out = dict(WideDeep=WideDeep)
    _SLICE21[nn.__name__] = out
    return out


def widedeep_data(seed, steps, b=WD_B, rows=WD["sparse_feature_number"],
                  fields=WD["num_field"], dense=WD["dense_feature_dim"],
                  ctr=WD_CTR):
    """``steps`` batches of synthetic Criteo-shaped data from ``seed``, as
    numpy arrays: ids from a Zipf-like draw over the ``rows`` hash
    buckets (rank ``floor(rows ** u)`` for uniform ``u``, a
    power law; each slot its own offset into the shared table), dense
    features in [0, 1) and Bernoulli(``ctr``) labels ``[b, 1]``
    (fp32), about Criteo's click rate."""
    rng = np.random.default_rng(seed)
    offs = rng.integers(0, rows, (1, fields))
    out = []
    for _ in range(steps):
        rank = np.floor(rows ** rng.random((b, fields))).astype(np.int64)
        ids = (rank - 1 + offs) % rows
        out.append((ids, rng.random((b, dense), dtype=np.float32),
                    (rng.random((b, 1)) < ctr).astype(np.float32)))
    return out


def _wd_model(torch, seed, dev, sparse=True):
    """Wide&Deep (:data:`WD`) on ``dev`` from ``seed``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.ops import manipulation as M
    paddle.seed(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return slice21_models(nn, M.concat)["WideDeep"](
        sparse=sparse, device=dev, generator=gen, **WD)


def _wd_batches(torch, data, dev):
    """The numpy batches as ``dev`` tensors, staged once (set-up)."""
    return [tuple(torch.from_numpy(a).to(dev) for a in b) for b in data]


def _wd_group(name):
    low = name.lower()
    if "embedding" in low or "indexselect" in low or "index_select" in low:
        return "embedding lookup"
    if any(t in low for t in ("sort", "unique", "coalesce", "scan",
                              "radix", "segment", "reduce_by_key")):
        return "sparse merge (sort, unique, sum)"
    if "index" in low or "scatter" in low or "gather" in low:
        return "row updates (index ops)"
    return _kernel_group(name)


@contextlib.contextmanager
def _wd_counters(torch):
    """Counts ``Tensor.coalesce`` calls (each reads a row count on the
    host) and the synchronising operations torch's sync debug mode
    reports, while the block runs."""
    import warnings
    counts = {"coalesce": 0, "sync_warnings": 0, "sync_ops": set()}
    real = torch.Tensor.coalesce

    def coalesce(self):
        counts["coalesce"] += 1
        return real(self)

    torch.Tensor.coalesce = coalesce
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield counts
        syncs = [str(w.message) for w in caught
                 if "synchroniz" in str(w.message)]
        counts["sync_warnings"] = len(syncs)
        counts["sync_ops"] = {m.split("\n")[0][:120] for m in syncs}
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.Tensor.coalesce = real


def _wd_eager(torch, net, opt, batches):
    """PaddleRec's dygraph loop (``backward`` / ``step`` /
    ``clear_grad``) over ``batches``: (losses, step ms, optimizer ms);
    the losses are read once at the end."""
    from paddle_tpu_torch.nn import functional as F
    losses, ms, opt_ms = [], [], []
    for ids, dense, y in batches:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = F.binary_cross_entropy(net(ids, dense), y)
        loss.backward()
        torch.cuda.synchronize()
        t1 = time.monotonic()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        t2 = time.monotonic()
        ms.append((t2 - t0) * 1e3)
        opt_ms.append((t2 - t1) * 1e3)
        losses.append(loss.detach())
    return ([float(v) for v in torch.stack(losses).cpu()], ms, opt_ms)


def train_widedeep_phase(torch, seed):
    """``[train widedeep]`` (module docstring, 15y)."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.metric import Auc
    tag = "train widedeep"
    card = card_line()
    gc.collect()
    torch.cuda.empty_cache()
    data = widedeep_data(seed + 2100, WD_STEPS)
    batches = _wd_batches(torch, data, "cuda")
    rows = WD["sparse_feature_number"]
    dim = WD["sparse_feature_dim"]
    touched = [len(np.unique(b[0])) for b in data]
    seen = np.unique(np.concatenate([b[0].ravel() for b in data]))
    print(f"[{tag}] {WD_SOURCE}: sparse_feature_number {rows}, "
          f"sparse_feature_dim {dim}, {WD['num_field']} slots, "
          f"dense_input_dim {WD['dense_feature_dim']}, fc_sizes "
          f"{list(WD['layer_sizes'])}, batch {WD_B}, Adam lr {WD_LR}; "
          f"loss sigmoid + binary_cross_entropy (PaddleRec's log_loss is "
          f"not in the JAX package); synthetic data from --seed: ids a "
          f"Zipf-like draw over the buckets, dense in [0, 1), labels "
          f"Bernoulli({WD_CTR}); {WD_STEPS} steps a way; distinct rows "
          f"touched a step: median {int(np.median(touched))} of "
          f"{WD_B * WD['num_field']} lookups, {len(seen)} over the run",
          flush=True)
    out = {"touched": float(np.median(touched)), "ways": {}}
    untouched = torch.ones(rows, dtype=torch.bool, device="cuda")
    untouched[torch.from_numpy(seen).cuda()] = False
    for lazy in (True, False):
        way = "eager lazy Adam" if lazy else "eager dense Adam"
        net = _wd_model(torch, seed, "cuda")
        w0 = net.embedding.weight.detach().clone()
        opt = paddle.optimizer.Adam(WD_LR, parameters=net.parameters(),
                                    lazy_mode=lazy)
        torch.cuda.reset_peak_memory_stats()
        losses, ms, opt_ms = _wd_eager(torch, net, opt, batches)
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)), f"[{tag}] {way}: a loss is not "
              f"finite: {losses}")
        check(np.mean(losses[-10:]) < np.mean(losses[:5]),
              f"[{tag}] {way}: the loss did not fall: {losses}")
        w = net.embedding.weight.detach()
        check(torch.equal(w[untouched], w0[untouched]),
              f"[{tag}] {way}: a row no step looked up moved")
        with _wd_counters(torch) as counts:
            _wd_eager(torch, net, opt, batches[:5])
        prof = profile_run(torch, tag, way,
                           lambda: _wd_eager(torch, net, opt, batches[:5]),
                           5, group=_wd_group)
        step_ms = float(np.median(ms[2:]))
        res = {"losses": losses, "step_ms": step_ms,
               "opt_ms": float(np.median(opt_ms[2:])), "peak": peak,
               "coalesce_a_step": counts["coalesce"] / 5,
               "syncs_a_step": counts["sync_warnings"] / 5,
               "sync_ops": sorted(counts["sync_ops"]),
               "idle": prof["idle"], "busy_ms": prof["busy_ms"],
               "groups_ms": prof["groups_ms"]}
        out["ways"][way] = res
        print(f"[{tag}] {way}: step_ms first={ms[0]:.3f} median(steps 3+)="
              f"{step_ms:.3f} -> {WD_B / (step_ms * 1e-3):.1f} samples/s; "
              f"optimizer step + clear_grad {res['opt_ms']:.3f} ms; merges "
              f"(coalesce) a step {res['coalesce_a_step']}, synchronising "
              f"ops a step (sync debug mode, a prototype that reports "
              f"what it detects) {res['syncs_a_step']} {res['sync_ops']}; "
              f"peak_mem_gib {peak / 2**30:.3f}; losses first "
              f"{losses[0]:.6f} last {losses[-1]:.6f}; card {card}",
              flush=True)
        del net, opt
        gc.collect()
        torch.cuda.empty_cache()
    lazy, dense = (out["ways"][w] for w in ("eager lazy Adam",
                                           "eager dense Adam"))
    # step 1 of lazy and dense Adam moves the same rows by the same rule
    # (every moment starts at 0): the second losses agree
    check(abs(lazy["losses"][1] - dense["losses"][1])
          <= 1e-6 * abs(dense["losses"][1]),
          f"[{tag}] step 2 losses lazy {lazy['losses'][1]} vs dense "
          f"{dense['losses'][1]}")
    # the optimizer's least bytes a step: read w, m1, m2 and the gradient,
    # write w, m1, m2, over the touched rows (lazy) or the table (dense)
    out["lazy_opt_bytes"] = 7 * 4 * dim * out["touched"]
    out["dense_opt_bytes"] = 7 * 4 * dim * rows
    # Model.fit, eager (jit=False: sparse, lazy) with Auc, and captured
    for jit in (False, True):
        way = "fit captured" if jit else "fit jit=False"
        net = _wd_model(torch, seed, "cuda")
        opt = paddle.optimizer.Adam(WD_LR, parameters=net.parameters(),
                                    lazy_mode=True)
        model = paddle.Model(net, device="cuda")
        auc = Auc()
        model.prepare(opt, nn.BCELoss(), auc, jit=jit)
        clock = _step_clock(torch)
        torch.cuda.reset_peak_memory_stats()
        model.fit(batches, epochs=1, verbose=0, callbacks=[clock])
        peak = torch.cuda.max_memory_allocated()
        losses = clock.losses
        check(len(losses) == WD_STEPS and all(np.isfinite(losses)),
              f"[{tag}] {way}: losses {losses}")
        value = float(auc.accumulate())
        check(0.0 <= value <= 1.0, f"[{tag}] {way}: Auc {value}")
        if jit:
            check(model.compile_stats()["captures"] == 1,
                  f"[{tag}] {way}: {model.compile_stats()}")
            check(abs(losses[0] - lazy["losses"][0])
                  <= 1e-6 * abs(lazy["losses"][0]),
                  f"[{tag}] {way}: first loss {losses[0]} vs the eager "
                  f"loop's {lazy['losses'][0]}")
        else:
            check(np.allclose(losses, lazy["losses"], rtol=1e-6, atol=0),
                  f"[{tag}] {way}: losses {losses} vs the eager lazy "
                  f"loop's {lazy['losses']}")
        step_ms = float(np.median(np.diff(clock.stamps)[2:] * 1e3))
        steps = 5
        prof = profile_run(
            torch, tag, way, lambda: model.fit(
                batches[:steps], epochs=1, verbose=0), steps,
            group=_wd_group)
        out["ways"][way] = {"losses": losses, "step_ms": step_ms,
                            "peak": peak, "auc": value,
                            "idle": prof["idle"], "busy_ms": prof["busy_ms"],
                            "groups_ms": prof["groups_ms"]}
        print(f"[{tag}] {way}: step_ms median(steps 3+)={step_ms:.3f} -> "
              f"{WD_B / (step_ms * 1e-3):.1f} samples/s; Auc {value:.4f}; "
              f"peak_mem_gib {peak / 2**30:.3f}; losses first "
              f"{losses[0]:.6f} last {losses[-1]:.6f}; card {card}",
              flush=True)
        model.release_graphs()
        del model, net, opt
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[{tag}] optimizer least bytes a step (the table): lazy "
          f"{out['lazy_opt_bytes'] / 2**20:.3f} MiB, dense "
          f"{out['dense_opt_bytes'] / 2**20:.3f} MiB; card {card}",
          flush=True)
    return out


def _wd_untouched_gate(torch, w, w0, st, untouched):
    """Every untouched row bit-equal to its initial value and its
    moments exactly 0: the list of failures."""
    bad = []
    if not torch.equal(w[untouched], w0[untouched]):
        bad.append("an untouched row moved")
    for k in ("moment1", "moment2"):
        if bool(st[k][untouched].any()):
            bad.append(f"an untouched row's {k} is not 0")
    return bad


def train_widedeep_parity_phase(torch, seed):
    """``[train widedeep parity]`` (module docstring, 15z)."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    tag = "train widedeep parity"
    gc.collect()
    torch.cuda.empty_cache()
    steps = 3
    data = widedeep_data(seed + 2200, steps)
    runs = {}
    with deterministic_algorithms(torch) as caught:
        for dev in ("cuda", "cpu"):
            net = _wd_model(torch, seed, "cuda")
            if dev == "cpu":
                net = net.to("cpu")
            w0 = net.embedding.weight.detach().clone()
            opt = paddle.optimizer.Adam(
                WD_LR, parameters=net.parameters(), lazy_mode=True,
                grad_clip=nn.ClipGradByGlobalNorm(WD_CLIP))
            losses, states = [], []
            for ids, dense, y in _wd_batches(torch, data, dev):
                loss = F.binary_cross_entropy(net(ids, dense), y)
                loss.backward()
                if not states:
                    norm = float(nn.ClipGradByGlobalNorm(1.0).global_norm(
                        [p.grad.coalesce().values() if p.grad.is_sparse
                         else p.grad for p in net.parameters()]))
                opt.step()
                opt.clear_grad()
                losses.append(float(loss))
                states.append({k: v.detach().cpu().clone() for k, v in
                               net.state_dict().items()})
            st = opt._state[[id(p) for p in opt.parameters()].index(
                id(net.embedding.weight))]
            runs[dev] = {"losses": losses, "states": states, "w0": w0.cpu(),
                         "st": {k: st[k].cpu() for k in ("moment1",
                                                         "moment2")},
                         "norm": norm}
            del net, opt
    gc.collect()
    torch.cuda.empty_cache()
    card, cpu = runs["cuda"], runs["cpu"]
    seen = np.unique(np.concatenate([b[0].ravel() for b in data]))
    untouched = torch.ones(WD["sparse_feature_number"], dtype=torch.bool)
    untouched[torch.from_numpy(seen)] = False
    w_end = card["states"][-1]["embedding.weight"]
    bad = _wd_untouched_gate(torch, w_end, card["w0"], card["st"], untouched)
    check(not bad, f"[{tag}] {bad}")
    check(torch.equal(card["w0"], cpu["w0"]), f"[{tag}] the initial tables "
          "differ")
    # the planted control: one untouched row moved by a lazy step's size
    row = int(torch.nonzero(untouched)[7])
    planted = w_end.clone()
    planted[row] -= WD_LR
    check(_wd_untouched_gate(torch, planted, card["w0"], card["st"],
                             untouched),
          f"[{tag}] the control (row {row} moved by lr) passed the gate")
    # step 1, every leaf: nearly every element within WD_TIGHT of the
    # leaf's scale, all within 2 lr (Adam's first step is lr x sign(g):
    # a gradient at rounding level may take the other sign)
    worst = {}
    for k, ref in cpu["states"][0].items():
        got = card["states"][0][k]
        if k == "embedding.weight":
            sel = ~untouched
            got, ref = got[sel], ref[sel]
        diff = (got.double() - ref.double()).abs()
        scale = max(float(ref.abs().max()), 1.0)
        share = float((diff <= WD_TIGHT * scale).double().mean())
        worst[k] = (float(diff.max()), share)
        check(float(diff.max()) <= 2 * WD_LR + WD_TIGHT * scale
              and share >= WD_SHARE,
              f"[{tag}] step 1 {k}: max |card - cpu| {float(diff.max())}, "
              f"share within {WD_TIGHT} x scale {share}")
    for i, (a, b) in enumerate(zip(card["losses"], cpu["losses"])):
        check(abs(a - b) <= WD_LOSS_RTOL * abs(b),
              f"[{tag}] step {i + 1} loss card {a} vs cpu {b}")
    w = max(worst, key=lambda k: worst[k][0])
    print(f"[{tag}] fp32, the full table ({WD['sparse_feature_number']} x "
          f"{WD['sparse_feature_dim']}), card vs the port on the CPU under "
          f"the deterministic algorithms ({len(caught)} warnings), {steps} "
          f"lazy Adam steps with ClipGradByGlobalNorm({WD_CLIP}) (step-1 "
          f"global norm card {card['norm']:.6f} cpu {cpu['norm']:.6f}): "
          f"{int(untouched.sum())} untouched rows bit-equal with moments "
          f"0; step-1 leaves: largest |diff| {worst[w][0]:.3e} ({w}), "
          f"smallest share within {WD_TIGHT} "
          f"{min(v[1] for v in worst.values()):.6f}; losses card "
          f"{card['losses']} cpu {cpu['losses']}; the planted control "
          f"(row {row} moved) fails the untouched gate", flush=True)
    return {"losses": card["losses"], "cpu_losses": cpu["losses"],
            "worst": worst}


def train_gpt_o1_phase(torch, seed):
    """``[train gpt o1]`` (module docstring, 15za)."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt2_small
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    from paddle_tpu_torch.ops import lmce_kernel as lk
    tag = "train gpt o1"
    gc.collect()
    torch.cuda.empty_cache()
    cfg = gpt2_small(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    net, opt = _train_model(torch, cfg, "cuda", seed, o2=False)
    crit = GPTPretrainingCriterion()
    model = paddle.Model(net, device="cuda")
    model.prepare(opt, crit, amp_configs={"level": "O1",
                                          "dtype": "bfloat16"})
    rng = np.random.default_rng(seed + 2300)
    x = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(np.int64)
    batch = (torch.from_numpy(x).cuda(),
             torch.from_numpy(np.roll(x, -1, axis=1)).cuda())
    L = cfg.num_hidden_layers
    clock = _step_clock(torch)
    torch.cuda.reset_peak_memory_stats()
    fk.reset_counts()
    lk.reset_counts()
    model.fit([batch] * TRAIN_STEPS, epochs=1, verbose=0, callbacks=[clock])
    launches = launch_table(fk, lk)
    plain = {f.__name__: f.plain_calls for f in fk.ALL_WRAPPERS + lk.WRAPPERS}
    peak = torch.cuda.max_memory_allocated()
    losses = clock.losses
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"[{tag}] losses {losses}")
    want = _want_launches(TRAIN_STEPS * L)
    check(launches == want, f"[{tag}] launches {launches}, expected {want}")
    check(not any(plain.values()), f"[{tag}] plain calls {plain}")
    check({p.dtype for p in net.parameters()} == {torch.float32},
          f"[{tag}] the weights are not fp32")
    check(model.compile_stats() == {"graphs": 1, "captures": 1},
          f"[{tag}] {model.compile_stats()}")
    step_ms = float(np.median(np.diff(clock.stamps)[2:] * 1e3))
    model.release_graphs()
    # the user's eager step with flash attention on the custom black
    # list: fp32 q, k, v, so the CUDA-core kernels
    black_ms, black_losses = [], []
    fk.reset_counts()
    lk.reset_counts()
    n_black = 3
    for _ in range(n_black):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16",
                                  custom_black_list={"flash_attention"}):
            logits = net(batch[0])
        loss = crit(logits, batch[1])
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        black_ms.append((time.monotonic() - t0) * 1e3)
        black_losses.append(float(loss))
    black = launch_table(fk, lk)
    plain = {f.__name__: f.plain_calls for f in fk.ALL_WRAPPERS + lk.WRAPPERS}
    check(all(np.isfinite(black_losses)), f"[{tag}] black list losses "
          f"{black_losses}")
    want = _want_launches(n_black * L)
    want.update({f"{f.__name__}.tc": 0 for f in fk.TC_WRAPPERS})
    check(black == want, f"[{tag}] black list launches {black}, expected "
          f"{want}")
    check(not any(plain.values()), f"[{tag}] plain calls {plain}")
    print(f"[{tag}] GPT-2-small L=12 D=768 H=12 V=50304 B={TRAIN_B} "
          f"S={TRAIN_S}, fp32 weights, Model.fit with amp_configs O1 "
          f"bfloat16, AdamW: {TRAIN_STEPS} steps (K=1 replays), losses "
          f"{[round(v, 6) for v in losses]}; step_ms median(steps 3+)="
          f"{step_ms:.3f} -> {TRAIN_B * TRAIN_S / (step_ms * 1e-3):.1f} "
          f"tokens/s; peak_mem_gib {peak / 2**30:.3f}; launches {launches}; "
          f"then {n_black} eager steps under custom_black_list="
          f"{{'flash_attention'}}: step_ms {[round(v, 3) for v in black_ms]},"
          f" losses {[round(v, 6) for v in black_losses]}, launches "
          f"{black}; card {card_line()}", flush=True)
    del model, net, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "black_launches": black,
            "step_ms": step_ms, "black_ms": black_ms, "peak": peak}


# ---------------------------------------------------------------------------
# the Paddle Tensor, the op catalogue and dygraph autograd
# ---------------------------------------------------------------------------
OP_MODULES = ("creation", "math", "manipulation", "logic", "linalg",
              "array_ops")       # the port's six op modules
DYGRAPH_STEPS = 5                 # [train gpt dygraph]: gate steps each way
DYGRAPH_TIMED_STEPS = 10          # and timed steps each way, default mode


def _spec_inputs(paddle, spec, dtype):
    """The spec's numpy inputs (its seed 0) as Tensors on the current
    place, floating ones in ``dtype`` (cast on the device: the card's
    machine has no ml_dtypes)."""
    rng = np.random.RandomState(0)
    out = []
    for gen in spec.inputs:
        a = gen(rng)
        t = paddle.to_tensor(a)
        if np.issubdtype(a.dtype, np.floating):
            t = t.astype(dtype)
        out.append(t)
    return out


def _spec_run(paddle, spec, dtype, place, grad):
    """``spec`` with the current place ``place`` ("cpu" or "gpu:0"): the
    outputs as CPU torch tensors, or with ``grad`` the gradients of
    ``sum(out[0])`` by ``backward()``."""
    paddle.set_device(place)
    try:
        args = _spec_inputs(paddle, spec, dtype)
        gidx = spec.grad_inputs
        if gidx is None:
            gidx = [i for i, a in enumerate(args)
                    if a.dtype.is_floating_point]
        if grad:
            for i in gidx:
                args[i].stop_gradient = False
        out = spec.fn(*args, **spec.kwargs)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        want = paddle.CPUPlace() if place == "cpu" else paddle.CUDAPlace(0)
        for o in outs:
            check(isinstance(o, paddle.Tensor) and o.place == want,
                  f"[tensor ops] {spec.name}: {type(o)} on "
                  f"{getattr(o, 'place', None)}, not a Tensor on {want}")
        if not grad:
            return [o.value.detach().cpu() for o in outs]
        outs[0].sum().backward()
        return [args[i].grad.value.cpu() for i in gidx]
    finally:
        paddle.set_device("gpu:0")


def _spec_diff(torch, got, ref, rtol, atol):
    """The largest excess of ``|got - ref|`` over ``atol + rtol |ref|``
    (numpy's ``allclose``; <= 0 passes) and the max abs error; integers
    and booleans must be equal."""
    if not (ref.is_floating_point() or ref.is_complex()):
        same = bool(torch.equal(got, ref))
        return (0.0 if same else 1.0), (0.0 if same else float("inf"))
    if got.numel() == 0:
        return 0.0, 0.0
    g = got.to(torch.complex128 if ref.is_complex() else torch.float64)
    r = ref.to(g.dtype)
    d = (g - r).abs()
    agree = (torch.isnan(g) & torch.isnan(r)) | ((g == r) & ~torch.isfinite(
        r))
    d = d.masked_fill(agree, 0.0)
    excess = (d - (atol + rtol * r.abs())).max()
    return float(excess), float(d.max())


def tensor_ops_phase(torch, seed):
    """``[tensor ops]`` (module docstring, 15zb)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import op_spec
    tag = "tensor ops"
    specs = op_spec.build_specs()
    t0 = time.monotonic()
    bad, worst = [], {"fp32": 0.0, "bf16": 0.0, "grad": 0.0}
    runs = 0
    for spec in specs:
        todo = [("fp32", "float32", False)]
        if "bfloat16" in spec.dtypes:
            todo.append(("bf16", "bfloat16", False))
        if spec.check_grad:
            todo.append(("grad", "float32", True))
        for key, dtype, grad in todo:
            runs += 1
            try:
                cpu = _spec_run(paddle, spec, dtype, "cpu", grad)
                gpu = _spec_run(paddle, spec, dtype, "gpu:0", grad)
            except Exception as exc:    # listed with the rest, then fails
                bad.append(f"{spec.name} {key}: {type(exc).__name__}: "
                           f"{str(exc)[:200]}")
                continue
            rtol = spec.grad_rtol if grad else spec.fw_rtol[dtype]
            atol = spec.grad_atol if grad else spec.fw_atol[dtype]
            for k, (g, r) in enumerate(zip(gpu, cpu)):
                if g.dtype != r.dtype or g.shape != r.shape:
                    bad.append(f"{spec.name} {key}[{k}]: {g.dtype}"
                               f"{tuple(g.shape)} vs CPU {r.dtype}"
                               f"{tuple(r.shape)}")
                    continue
                excess, err = _spec_diff(torch, g, r, rtol, atol)
                worst[key] = max(worst[key], err)
                if excess > 0:
                    bad.append(f"{spec.name} {key}[{k}]: max abs err "
                               f"{err:.3e} over rtol {rtol} atol {atol}")
    for line in bad:
        print(f"[{tag}] MISMATCH {line}", flush=True)
    six = sum(getattr(op.raw, "__module__", "").rsplit(".", 1)[-1]
              in OP_MODULES for op in paddle.OP_TABLE.values())
    print(f"[{tag}] {len(specs)} specs ({runs} runs: fp32, bf16 where "
          f"listed, gradients where check_grad) on Tensors on the card "
          f"against the port on the CPU, TF32 off; OP_TABLE holds "
          f"{len(paddle.OP_TABLE)} ops, {six} of them from the port's "
          f"op modules {', '.join(OP_MODULES)}; max abs err fp32 "
          f"{worst['fp32']:.3e} bf16 {worst['bf16']:.3e} grad "
          f"{worst['grad']:.3e}; mismatches {len(bad)}; "
          f"{time.monotonic() - t0:.1f} s; card {card_line()}", flush=True)
    check(not bad, f"[{tag}] {len(bad)} mismatches: {bad[:5]}")
    return {"specs": len(specs), "runs": runs, "max_abs_err": worst}


def tensor_flash_phase(torch, seed):
    """``[tensor flash]`` (module docstring, 15zc)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    tag = "tensor flash"
    B, S, H, D = TRAIN_B, TRAIN_S, 12, 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 2400)

    def rnd(scale):
        return (torch.randn(B, S, H, D, device="cuda", generator=gen)
                * scale).to(torch.bfloat16)

    qv, kv, vv, gv = rnd(0.5), rnd(0.5), rnd(0.5), rnd(1.0)
    paddle.set_device("gpu:0")
    result = {}

    def body():
        q, k, v = (paddle.to_tensor(t, stop_gradient=False)
                   for t in (qv, kv, vv))
        out, _ = paddle.nn.functional.flash_attention(q, k, v, causal=True)
        grads = paddle.grad([out], [q, k, v],
                            grad_outputs=[paddle.to_tensor(gv)])
        result["v"] = (out, grads)

    body()                                # warm-up (first launches)
    torch.cuda.synchronize()
    fk.reset_counts()
    prof = profiled(torch, body)
    launches = {f.__name__: f.launches for f in fk.ALL_WRAPPERS}
    launches.update({f"{f.__name__}.tc": f.tc_launches
                     for f in fk.TC_WRAPPERS})
    plain = {f.__name__: f.plain_calls for f in fk.ALL_WRAPPERS}
    names = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.key] = names.get(e.key, 0) + e.count
    k5 = sum(c for n, c in names.items() if "flash_fwd_tc_kernel" in n)
    k6 = sum(c for n, c in names.items() if "flash_bwd_tc_kernel" in n)
    core = sum(c for n, c in names.items() if any(
        k in n for k in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                         "flash_bwd_dkv_kernel", "flash_bwd_fused")))
    out, (dq, dk, dv) = result["v"]
    check(isinstance(out, paddle.Tensor) and not out.stop_gradient,
          f"[{tag}] the output is not a Tensor with a gradient")
    rout, rlse = fk.flash_fwd_tc_reference(qv, kv, vv, True)
    rdq, rdelta = fk.flash_bwd_dq_reference(qv, kv, vv, rout, rlse, gv, True)
    rdk, rdv = fk.flash_bwd_dkv_reference(qv, kv, vv, gv, rlse, rdelta, True)
    errs = hold(torch, tag, f"B={B} S={S} H={H} D={D} bf16 causal through "
                "the Tensor API", FLASH_BF16_TOL,
                [("out", out.value, rout), ("dq", dq.value, rdq),
                 ("dk", dk.value, rdk), ("dv", dv.value, rdv)])
    check(k5 == 1 and k6 == 2 and core == 0,
          f"[{tag}] profiler: flash_fwd_tc_kernel x{k5} (want 1), "
          f"flash_bwd_tc_kernel x{k6} (want 2: dq + dkv), CUDA-core flash "
          f"kernels x{core} (want 0)")
    for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[n] == 1 and launches[f"{n}.tc"] == 1,
              f"[{tag}] {n} launches {launches[n]} (tensor-core "
              f"{launches[f'{n}.tc']}), want 1 and 1")
    check(not any(plain.values()), f"[{tag}] plain calls {plain}")
    print(f"[{tag}] profiler: flash_fwd_tc_kernel x{k5} (K5), "
          f"flash_bwd_tc_kernel x{k6} (K6, dq + dkv), CUDA-core flash x"
          f"{core}; wrapper counts {launches}; card {card_line()}",
          flush=True)
    return {"launches": launches, "max_abs_err": errs}


def _dygraph_run(torch, paddle, cfg, seed, batch, wrap, tag, steps):
    """One way of ``[train gpt dygraph]``: a net and AdamW from ``seed``,
    ``steps`` steps of the loop on Tensors (``wrap``) or on raw torch
    tensors, each step synchronised and clocked; then two profiled
    steps.  Returns the losses, the leaves after the clocked steps, the
    step times (median of steps 3+), their launches, the peak memory and
    the profile."""
    import gc
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    from paddle_tpu_torch.ops import lmce_kernel as lk
    gc.collect()
    torch.cuda.empty_cache()
    net, opt = _train_model(torch, cfg, "cuda", seed, o2=True)
    crit = GPTPretrainingCriterion()
    xn, yn = batch
    x, y = (torch.from_numpy(a).pin_memory() for a in (xn, yn))

    def step():
        if wrap:               # numpy in, as a Paddle user's loop has it
            xs, ys = paddle.to_tensor(xn), paddle.to_tensor(yn)
        else:
            xs, ys = x.cuda(non_blocking=True), y.cuda(non_blocking=True)
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = net(xs)
        loss = crit(logits, ys)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_counts()
    lk.reset_counts()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.monotonic()
        loss = step()
        losses.append(float(loss) if wrap else loss.item())
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
    launches = launch_table(fk, lk)
    plain = {f.__name__: f.plain_calls for f in fk.ALL_WRAPPERS + lk.WRAPPERS}
    peak = torch.cuda.max_memory_allocated()
    check(isinstance(loss, paddle.Tensor) == wrap,
          f"[{tag}] the loss is a {type(loss)}")
    leaves = [p.detach().clone() for p in net.parameters()]
    mode = "deterministic" if torch.are_deterministic_algorithms_enabled() \
        else "default-mode"
    prof = profile_run(torch, tag, f"{mode} {'Tensor' if wrap else 'raw'}"
                       "-loop", lambda: [step() for _ in range(2)], 2)
    del net, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "leaves": leaves, "ms": ms,
            "step_ms": float(np.median(ms[2:])), "launches": launches,
            "plain": plain, "peak": peak, "profile": prof}


def train_gpt_dygraph_phase(torch, seed, eager):
    """``[train gpt dygraph]`` (module docstring, 15zd); ``eager`` is
    ``[train eager]``'s result, printed beside for comparison only."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import gpt2_small
    tag = "train gpt dygraph"
    cfg = gpt2_small(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    rng = np.random.default_rng(seed + 2500)
    x = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(np.int64)
    batch = (x, np.roll(x, -1, axis=1))
    paddle.set_device("gpu:0")
    prev_cfg = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        res = {wrap: _dygraph_run(torch, paddle, cfg, seed, batch, wrap, tag,
                                  DYGRAPH_STEPS)
               for wrap in (True, False)}
    finally:
        torch.use_deterministic_algorithms(False)
        if prev_cfg is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_cfg
    # the same two loops timed in PyTorch's default mode, as [train eager]
    # runs (the deterministic mode NaN-fills every new allocation)
    fast = {wrap: _dygraph_run(torch, paddle, cfg, seed, batch, wrap, tag,
                               DYGRAPH_TIMED_STEPS)
            for wrap in (True, False)}
    t, r = res[True], res[False]
    ft, fr = fast[True], fast[False]
    for way, run in (("Tensor", t), ("raw", r), ("timed Tensor", ft),
                     ("timed raw", fr)):
        want = _want_launches(len(run["losses"]) * cfg.num_hidden_layers)
        check(all(np.isfinite(run["losses"])), f"[{tag}] {way} losses "
              f"{run['losses']}")
        check(run["launches"] == want, f"[{tag}] {way} launches "
              f"{run['launches']}, expected {want}")
        check(not any(run["plain"].values()), f"[{tag}] {way} plain calls "
              f"{run['plain']}")
    check(t["losses"][-1] < t["losses"][0], f"[{tag}] loss did not fall: "
          f"{t['losses']}")
    check(t["losses"] == r["losses"], f"[{tag}] losses Tensor "
          f"{t['losses']} vs raw {r['losses']}: not bit-equal")
    same = [bool(torch.equal(a, b)) for a, b in zip(t["leaves"],
                                                    r["leaves"])]
    check(all(same), f"[{tag}] {same.count(False)} of {len(same)} leaves "
          "differ between the Tensor and the raw loop")
    per_step = {k: v // DYGRAPH_STEPS for k, v in t["launches"].items() if v}
    print(f"[{tag}] GPT-2-small L=12 D=768 H=12 V=50304 B={TRAIN_B} "
          f"S={TRAIN_S} bf16 O2 (amp.decorate + auto_cast) AdamW, "
          f"{DYGRAPH_STEPS} dygraph steps each way under "
          f"use_deterministic_algorithms: losses {t['losses']} (Tensor) "
          f"== {r['losses']} (raw), {len(same)} leaves bit-equal; step_ms "
          f"{[round(v, 3) for v in t['ms']]} (Tensor) / "
          f"{[round(v, 3) for v in r['ms']]} (raw), profiled idle share "
          f"{t['profile']['idle']:.4f} / {r['profile']['idle']:.4f}, device "
          f"busy ms/step {t['profile']['busy_ms']:.3f} / "
          f"{r['profile']['busy_ms']:.3f}, peak_mem_gib "
          f"{t['peak'] / 2**30:.3f} / {r['peak'] / 2**30:.3f}; default mode, "
          f"{DYGRAPH_TIMED_STEPS} steps each: step_ms median(steps 3+) "
          f"Tensor {ft['step_ms']:.3f} raw {fr['step_ms']:.3f} (Tensor - raw "
          f"{ft['step_ms'] - fr['step_ms']:.3f} ms) vs [train eager] "
          f"(Model.train_batch) {eager['step_ms']:.3f}; profiled idle share "
          f"Tensor {ft['profile']['idle']:.4f} raw "
          f"{fr['profile']['idle']:.4f} [train eager] "
          f"{eager['profile']['idle']:.4f}; device busy ms/step Tensor "
          f"{ft['profile']['busy_ms']:.3f} raw {fr['profile']['busy_ms']:.3f}"
          f" [train eager] {eager['profile']['busy_ms']:.3f}; peak_mem_gib "
          f"Tensor {ft['peak'] / 2**30:.3f} raw {fr['peak'] / 2**30:.3f} "
          f"[train eager] {eager['peak'] / 2**30:.3f}; losses Tensor == raw "
          f"{ft['losses'] == fr['losses']}; launches a step {per_step}; card "
          f"{card_line()}", flush=True)
    return {"launches": t["launches"], "raw_launches": r["launches"],
            "step_ms": ft["step_ms"], "raw_step_ms": fr["step_ms"],
            "det_step_ms": t["step_ms"], "det_raw_step_ms": r["step_ms"],
            "idle": ft["profile"]["idle"], "raw_idle": fr["profile"]["idle"],
            "peak": ft["peak"], "raw_peak": fr["peak"]}


# ---------------------------------------------------------------------------
# the distributed slice (A10, first half): collectives on NCCL (a world of
# one rank) and on gloo over CUDA tensors (four ranks on the one card), and
# GPT-2-small trained dp2 x mp2 by four ranks
# ---------------------------------------------------------------------------
HYBRID_B, HYBRID_S = 8, 1024     # [train gpt hybrid]: the global batch
HYBRID_STEPS = 5                 # dygraph steps, timed
HYBRID_LR = 1e-4                 # AdamW's rate (multi_precision, bf16 O2)
HYBRID_CLIP = 1.0                # the hybrid global-norm clip
PARITY_STEPS = 3                 # [train gpt hybrid parity]: SGD steps
PARITY_LR = 0.01                 # SGD's rate: it moves each weight by its
                                 # gradient (Adam would turn a gradient of
                                 # rounding noise into a whole step)
PARITY_GRAD_TOL = 1e-4           # x the leaf's largest |gradient|, step 1
PARITY_LOSS_TOL = 1e-4           # relative, each of the steps' losses
PARITY_CONTROL = 1.01            # the planted control's factor on one
                                 # rank's shard of one leaf's gradient
WORLD_TIMEOUT_S = 480            # a world that runs longer fails the phase


def gpt_numpy_state(cfg, seed):
    """A GPT state dict (numpy, the JAX package's names and layouts) from
    ``numpy.random.default_rng(seed)``: Normal(0, ``initializer_range``)
    matrices and embeddings, zero biases, unit norm scales."""
    from paddle_tpu_torch.models.gpt import _expected_shapes
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in _expected_shapes(cfg).items():
        if name.endswith(".bias"):
            out[name] = np.zeros(shape, np.float32)
        elif name.endswith(("ln1.weight", "ln2.weight",
                            "final_norm.weight")):
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = (rng.standard_normal(shape, dtype=np.float32)
                         * np.float32(cfg.initializer_range))
    return out


def _run_world(fn, nprocs, env, *args):
    """``fn(workdir, stacks_after, *args)`` on ``nprocs`` ranks started by
    ``paddle_tpu_torch.distributed.spawn`` (the env contract, ``env``
    beside it); each rank pickles its result into ``workdir``.  A rank
    that fails, or a world that outlives ``WORLD_TIMEOUT_S``, ends the
    world and raises; a rank still running ``stacks_after`` seconds in
    prints its threads' stacks first (``faulthandler``), so a hung
    collective shows where it waits."""
    import pickle
    import shutil
    import tempfile

    from paddle_tpu_torch.distributed.spawn import spawn
    workdir = tempfile.mkdtemp(prefix="chip_world_")
    ctx = spawn(fn, args=(workdir, WORLD_TIMEOUT_S - 30) + args,
                nprocs=nprocs, join=False, env=env)
    if not ctx.join(WORLD_TIMEOUT_S):
        ctx.terminate()
        raise RuntimeError(f"{fn.__name__}: the world ran past "
                           f"{WORLD_TIMEOUT_S} s")
    out = []
    for r in range(nprocs):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    shutil.rmtree(workdir)
    return out


def _rank_setup(stacks_after):
    """A rank's start: its stacks printed if it still runs after
    ``stacks_after`` seconds, TF32 off (the fp32 comparisons), the card."""
    import faulthandler
    faulthandler.dump_traceback_later(stacks_after)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu:0")
    return torch, paddle


def _rank_done(workdir, res):
    import pickle
    import paddle_tpu_torch as paddle
    rank = paddle.distributed.get_rank()
    tmp = os.path.join(workdir, f"rank{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(res, f)
    os.replace(tmp, os.path.join(workdir, f"rank{rank}.pkl"))
    paddle.distributed.destroy_process_group()


def _dist_exercise():
    """The rank-side exercises the CPU tests run too
    (``tests/torch_dist_workers.py``, torch and numpy only)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_dist_workers
    return torch_dist_workers


def _collective_checks(torch, paddle, tag):
    """Every collective of ``distributed.communication`` on CUDA tensors
    of this rank, the object collectives and the ``stream`` namespace
    (``torch_dist_workers.exercise_collectives``, the CPU tests'
    exercise), each result held exactly against what this rank computes
    for itself (``expected_collectives``: every rank's input is
    ``arange(6) + 10 r + 1``, so the results are moves and
    integer-valued sums).  Returns the names checked."""
    w = _dist_exercise()
    dist = paddle.distributed
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    got = w.exercise_collectives(paddle, dev)
    want = w.expected_collectives(rank, world)
    bad = w.mismatches(got, want)
    check(not bad, f"[{tag}] rank {rank}: " + "; ".join(
        f"{k} {got.get(k)} != {want[k]}" for k in bad))
    return sorted(want)


def _nccl_world1_rank(workdir, stacks_after):
    torch, paddle = _rank_setup(stacks_after)
    dist = paddle.distributed
    dist.init_parallel_env()
    check(dist.get_backend() == "nccl",
          f"[dist nccl world1] backend {dist.get_backend()}")
    checked = _collective_checks(torch, paddle, "dist nccl world1")
    _rank_done(workdir, {"checked": checked,
                         "composed": dist.communication.composed_counts(),
                         "stats": dist.communication.comm_stats()})


def dist_nccl_phase(torch, seed):
    """``[dist nccl world1]``: one rank on NCCL (the one NCCL world a
    single card allows): every collective through NCCL on CUDA tensors
    (send/recv need a peer and are left out), the object collectives."""
    t0 = time.monotonic()
    res = _run_world(_nccl_world1_rank, 1,
                     {"PADDLE_DISTRI_BACKEND": "nccl"})[0]
    check(res["composed"] == {}, f"[dist nccl world1] composed "
          f"{res['composed']}")
    print(f"[dist nccl world1] 1 rank, NCCL, CUDA tensors: "
          f"{len(res['checked'])} checks passed "
          f"({', '.join(res['checked'])}); calls through the backend "
          f"{ {k: v['calls'] for k, v in res['stats'].items()} }; "
          f"{time.monotonic() - t0:.1f} s with the rank's start; card "
          f"{card_line()}", flush=True)


def _gloo_cuda(torch, paddle):
    """[dist gloo cuda] on this rank: the collectives, two subgroups from
    ``new_group`` and the dp2 x mp2 hybrid groups."""
    dist = paddle.distributed
    comm = dist.communication
    comm.reset_counts()
    rank = dist.get_rank()
    checked = _collective_checks(torch, paddle, "dist gloo cuda")
    w = _dist_exercise()
    dev = torch.device("cuda", torch.cuda.current_device())
    got = w.exercise_groups(paddle, dev)
    want = w.expected_groups(rank)
    bad = w.mismatches(got, want)
    check(not bad, f"[dist gloo cuda] rank {rank}: " + "; ".join(
        f"{k} {got.get(k)} != {want[k]}" for k in bad))
    checked += sorted(want)
    return {"checked": checked, "composed": comm.composed_counts(),
            "backend": dist.get_backend(),
            "groups": {k: got["hybrid_ranks"][k] for k in ("dp", "mp")}}


def _peaks(torch):
    return (torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())


def _hybrid_train(torch, paddle, seed):
    """[train gpt hybrid] on this rank (``hybrid_world_phase``)."""
    from paddle_tpu_torch.models import (GPTAttention,
                                         GPTPretrainingCriterion, gpt2_small)
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dist = paddle.distributed
    fleet, comm = dist.fleet, dist.communication
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    s.recompute = True
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                     recompute=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 2600 + hcg.get_model_parallel_rank())
    net = GPTForCausalLM(cfg, device="cuda", generator=gen)
    opt = paddle.optimizer.AdamW(
        learning_rate=HYBRID_LR, parameters=net.parameters(),
        multi_precision=True,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(HYBRID_CLIP))
    paddle.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    model = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(opt)
    crit = GPTPretrainingCriterion()
    rng = np.random.default_rng(seed + 2601)
    x = rng.integers(0, cfg.vocab_size, (HYBRID_B, HYBRID_S)).astype(np.int64)
    n, r = hcg._get_data_group().nranks, hcg._data_rank()
    k = HYBRID_B // n
    xs = paddle.to_tensor(x[r * k:(r + 1) * k])
    ys = paddle.to_tensor(np.roll(x, -1, 1)[r * k:(r + 1) * k])
    heads = sorted({m.num_heads for m in net.modules()
                    if isinstance(m, GPTAttention)})

    def step():
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(xs)
        loss = crit(logits, ys)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_counts()
    comm.reset_counts()
    losses, ms = [], []
    for _ in range(HYBRID_STEPS):
        t0 = time.monotonic()
        loss = step()
        losses.append(float(loss))
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
    launches = {f.__name__: f.launches for f in fk.WRAPPERS}
    launches.update({f"{f.__name__}.tc": f.tc_launches for f in fk.WRAPPERS})
    launches["plain"] = sum(f.plain_calls for f in fk.ALL_WRAPPERS)
    stats = comm.comm_stats()
    composed = comm.composed_counts()
    peak = _peaks(torch)
    wall = []
    with profile_window(torch) as prof:
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        wall.append((time.monotonic() - t0) * 1e3)
    busy = sum(kernel_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    # after the 6 updates: every leaf (bf16 parameter and fp32 master)
    # bit-equal over the dp group, the ones not split over mp (norms,
    # position embedding, row-parallel biases) over the mp group too
    replicas = _dist_exercise().hybrid_replicas(hcg, opt)
    del model, opt, net
    torch.cuda.empty_cache()
    return {"losses": losses, "ms": ms, "launches": launches,
            "stats": stats, "composed": composed, "peak": peak,
            "heads": heads, "profile_wall_ms": wall[0], "busy_ms": busy,
            "replicas": replicas,
            "rows": [r * k, (r + 1) * k],
            "coords": (hcg.get_data_parallel_rank(),
                       hcg.get_model_parallel_rank())}


def _grad_gate(got, ref):
    """Per leaf, max |got - ref| / max |ref| (the leaf's largest)."""
    return {n: float(np.abs(got[n] - ref[n]).max()
                     / max(float(np.abs(ref[n]).max()), 1e-30))
            for n in ref}


def _hybrid_parity(torch, paddle, seed):
    """[train gpt hybrid parity] on this rank (``hybrid_world_phase``):
    the fp32 GPT-2-small at sharding2 x mp2 through ``DistributedRunner(
    sharding_stage=2)``, then on rank 0 alone the single-process raw loop
    on the same weights and batch, the comparison, the control and the
    K5/K6 hold at this rank's H = 6 shape."""
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt2_small,
                                         state_dict_from_jax)
    dist = paddle.distributed
    fleet = dist.fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"sharding_degree": 2, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    rank = dist.get_rank()
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    state = gpt_numpy_state(cfg, seed + 2700)
    rng = np.random.default_rng(seed + 2701)
    x = rng.integers(0, cfg.vocab_size, (HYBRID_B, HYBRID_S)).astype(np.int64)
    y = np.roll(x, -1, 1)
    net = GPTForCausalLM(cfg, device="cuda")
    net.load_state_dict(state_dict_from_jax(
        state, cfg, hcg.get_model_parallel_rank(), 2))
    opt = paddle.optimizer.SGD(learning_rate=PARITY_LR,
                               parameters=net.parameters())
    crit = GPTPretrainingCriterion()
    runner = DistributedRunner(net, opt, crit, sharding_stage=2)
    # step 1's gradient, reduced as train_step reduces it
    _, _, mb, r, n = runner._split([x], [y])
    dev = runner._device()
    rows = slice(r * (mb // n), (r + 1) * (mb // n))
    runner._forward_loss(*(
        [torch.from_numpy(a[rows]).to(dev)] for a in (x, y))).backward()
    runner._update.reduce()
    grads = {k: v.float().cpu().numpy() for k, v in
             runner._update.sharded.gather_grads().items()}
    for _, p in runner._update.named:
        p.grad = None
    runner._update.sharded.clear_shard_grads()
    mp_grads = []
    dist.all_gather_object(mp_grads, grads,
                           group=hcg.get_model_parallel_group())
    del grads
    losses = [runner.train_step([x], [y]) for _ in range(PARITY_STEPS)]
    peak = _peaks(torch)
    del runner, opt, net
    torch.cuda.empty_cache()
    res = {"losses": losses, "peak": peak}
    if rank == 0:
        res.update(_parity_reference(torch, paddle, cfg, state, x, y,
                                     mp_grads))
        res["kernels"] = _h6_hold(torch, seed)
    dist.barrier()
    return res


def _parity_reference(torch, paddle, cfg, state, x, y, mp_grads):
    """The single-process raw loop on the card (rank 0, the other ranks
    idle): step 1's gradients and ``PARITY_STEPS`` SGD losses; the
    per-leaf gate of the joined distributed gradients, and of the planted
    control (mp rank 1's shard of one leaf scaled by ``PARITY_CONTROL``),
    which must fail."""
    import gc
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         state_dict_from_jax)
    from paddle_tpu_torch.models.gpt import merge_mp_states
    hcg = collective.get_mesh()
    collective.set_mesh(None)       # the reference is the whole model
    try:
        net = GPTForCausalLM(cfg, device="cuda")
        crit = GPTPretrainingCriterion()
    finally:
        collective.set_mesh(hcg)
    net.load_state_dict(state_dict_from_jax(state, cfg))
    opt = paddle.optimizer.SGD(learning_rate=PARITY_LR,
                               parameters=net.parameters())
    xt, yt = (torch.from_numpy(a).cuda() for a in (x, y))
    losses, ref = [], None
    for i in range(PARITY_STEPS):
        loss = crit(net(xt), yt)
        loss.backward()
        if i == 0:
            ref = {n: p.grad.float().cpu().numpy()
                   for n, p in net.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    del net, opt
    gc.collect()
    torch.cuda.empty_cache()
    got = merge_mp_states(mp_grads, cfg)
    ratios = _grad_gate(got, ref)
    leaf = f"gpt.layers.{cfg.num_hidden_layers // 2}.mlp.fc1.weight"
    bad = [dict(g) for g in mp_grads]
    bad[1][leaf] = bad[1][leaf] * PARITY_CONTROL
    control = _grad_gate(merge_mp_states(bad, cfg), ref)[leaf]
    return {"serial_losses": losses, "ratios": ratios, "control": control,
            "control_leaf": leaf}


def _h6_hold(torch, seed):
    """K5 / K6 at the hybrid path's per-rank shape: q, k, v strided views
    ``[4, 1024, 6, 64]`` of a packed qkv ``[4, 1024, 3, 6, 64]`` (row
    stride 1152 elements), bf16, against their plain versions
    (``tc_compare`` / ``tc_bwd_compare``)."""
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 2702)
    b, s = HYBRID_B // 2, HYBRID_S
    qkv = torch.randn(b, s, 3, 6, 64, device="cuda", generator=gen,
                      dtype=torch.float32).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    g = torch.randn(b, s, 6, 64, device="cuda", generator=gen).to(
        torch.bfloat16)
    _, _, ferr = tc_compare(torch, fk, "hybrid H=6 [4, 1024, 6, 64] row "
                            "stride 1152", q, k, v, True)
    bres, _ = tc_bwd_compare(torch, fk, "hybrid H=6 [4, 1024, 6, 64] row "
                             "stride 1152", q, k, v, g, True)
    return {"fwd_err": ferr, "bwd_errs": bres["errs"],
            "bwd_ratios": bres["ratios"]}


def _hybrid_rank(workdir, stacks_after, seed):
    torch, paddle = _rank_setup(stacks_after)
    paddle.distributed.init_parallel_env()
    res = {"gloo": _gloo_cuda(torch, paddle)}
    res["train"] = _hybrid_train(torch, paddle, seed)
    res["parity"] = _hybrid_parity(torch, paddle, seed)
    _rank_done(workdir, res)


def _gib(b):
    return b / 2 ** 30


def hybrid_world_phase(torch, seed):
    """``[dist gloo cuda]``, ``[train gpt hybrid]`` and ``[train gpt hybrid
    parity]``: four ranks on the one card (gloo over CUDA tensors),
    started once by ``distributed.spawn``; each rank runs the three in
    turn and this process prints and gates what they return.  Returns
    the hybrid training's launches summed over the ranks."""
    from paddle_tpu_torch.distributed import communication as comm
    t0 = time.monotonic()
    ranks = _run_world(_hybrid_rank, 4, {}, seed)
    world_s = time.monotonic() - t0
    card = card_line()
    g = [r["gloo"] for r in ranks]
    composed = {}
    for res in g:
        for k, v in res["composed"].items():
            composed[k] = composed.get(k, 0) + v
        check(res["backend"] == "gloo", f"[dist gloo cuda] backend "
              f"{res['backend']}")
    print(f"[dist gloo cuda] 4 ranks on one card, gloo over CUDA tensors: "
          f"{len(g[0]['checked'])} checks passed on every rank "
          f"({', '.join(g[0]['checked'])}); hybrid groups rank 0 "
          f"{g[0]['groups']}; composed on gloo (all ranks, uses): "
          f"{composed} (GLOO_CUDA_COMPOSED "
          f"{sorted(comm.GLOO_CUDA_COMPOSED)}); card {card}", flush=True)
    check(set(composed) <= set(comm.GLOO_CUDA_COMPOSED) and composed,
          f"[dist gloo cuda] composed {composed}")

    tag = "train gpt hybrid"
    tr = [r["train"] for r in ranks]
    L = 12
    per_rank_fwd = 2 * L * HYBRID_STEPS      # forward + recompute's replay
    per_rank_bwd = L * HYBRID_STEPS
    for i, res in enumerate(tr):
        la = res["launches"]
        check(res["heads"] == [6], f"[{tag}] rank {i} heads {res['heads']}")
        check(la["flash_fwd"] == la["flash_fwd.tc"] == per_rank_fwd
              and la["flash_bwd_dq"] == la["flash_bwd_dq.tc"] == per_rank_bwd
              and la["flash_bwd_dkv"] == la["flash_bwd_dkv.tc"]
              == per_rank_bwd and la["plain"] == 0,
              f"[{tag}] rank {i} launches {la}")
        check(all(np.isfinite(res["losses"])), f"[{tag}] rank {i} losses "
              f"{res['losses']}")
        check(res["losses"][-1] < res["losses"][0],
              f"[{tag}] rank {i}: loss did not fall: {res['losses']}")
        rep = res["replicas"]
        check(rep["dp"][0] > 0 and rep["mp"][0] > 0
              and rep["dp"][1] == rep["mp"][1] == 0,
              f"[{tag}] rank {i}: replicas differ (elements compared, "
              f"differing): {rep}")
    print(f"[{tag}] replicas after {HYBRID_STEPS + 1} updates, bit-equal "
          "on every rank (elements compared, differing): every leaf over "
          "dp, the leaves not split over mp over mp: " + "; ".join(
              f"rank {i} dp {r['replicas']['dp']} mp {r['replicas']['mp']}"
              for i, r in enumerate(tr)), flush=True)
    step_ms = float(np.median([np.median(r["ms"][2:]) for r in tr]))
    per_step = {k: {"calls": v["calls"] / HYBRID_STEPS,
                    "bytes": v["bytes"] / HYBRID_STEPS,
                    "ms": v["seconds"] * 1e3 / HYBRID_STEPS}
                for k, v in tr[0]["stats"].items()}
    busy = [r["busy_ms"] for r in tr]
    wall = max(r["profile_wall_ms"] for r in tr)
    print(f"[{tag}] GPT-2-small L=12 D=768 H=12 V=50304 global B={HYBRID_B} "
          f"S={HYBRID_S}, dp2 x mp2 on 4 ranks of one card (spawn, "
          "fleet.init -> distributed_model -> distributed_optimizer), bf16 "
          f"O2 AdamW lr {HYBRID_LR}, global-norm clip {HYBRID_CLIP}, "
          f"recompute=True, dygraph loop on Tensors, {HYBRID_STEPS} steps: "
          + "; ".join(f"rank {i} (dp {r['coords'][0]}, mp {r['coords'][1]},"
                      f" rows {r['rows']}) losses "
                      f"{[round(v, 5) for v in r['losses']]}, step_ms "
                      f"{[round(v, 1) for v in r['ms']]}, peak allocated "
                      f"{_gib(r['peak'][0]):.3f} GiB reserved "
                      f"{_gib(r['peak'][1]):.3f} GiB"
                      for i, r in enumerate(tr)), flush=True)
    print(f"[{tag}] step_ms median(steps 3+, median over ranks) "
          f"{step_ms:.1f}; collectives a step on rank 0 (calls, bytes in, "
          f"host ms): " + ", ".join(
              f"{k} {v['calls']:.0f} / {v['bytes'] / 2**20:.1f} MiB / "
              f"{v['ms']:.1f} ms" for k, v in sorted(per_step.items()))
          + f"; composed uses {tr[0]['composed']}; one profiled step: wall "
          f"{wall:.1f} ms, device busy by rank "
          f"{[round(b, 1) for b in busy]} ms (sum {sum(busy):.1f}), card "
          f"idle share {max(0.0, 1 - sum(busy) / wall):.4f} (four "
          f"processes' kernels summed, no overlap assumed); K5/K6 launches a "
          f"rank: flash_fwd {tr[0]['launches']['flash_fwd']} (tc "
          f"{tr[0]['launches']['flash_fwd.tc']}), flash_bwd_dq "
          f"{tr[0]['launches']['flash_bwd_dq']}, flash_bwd_dkv "
          f"{tr[0]['launches']['flash_bwd_dkv']}, at H=6; card {card}; "
          f"world {world_s:.1f} s", flush=True)

    tag = "train gpt hybrid parity"
    p0 = ranks[0]["parity"]
    for i, r in enumerate(ranks):
        check(r["parity"]["losses"] == p0["losses"],
              f"[{tag}] rank {i} losses {r['parity']['losses']}")
    rel = [abs(a - b) / abs(b) for a, b in zip(p0["losses"],
                                               p0["serial_losses"])]
    worst = max(p0["ratios"], key=p0["ratios"].get)
    print(f"[{tag}] GPT-2-small fp32, global B={HYBRID_B} S={HYBRID_S}, "
          "sharding2 x mp2 through DistributedRunner(sharding_stage=2) on 4 "
          "ranks vs the single-process raw loop on the card, same numpy "
          f"weights and batch, SGD lr {PARITY_LR}: losses "
          f"{[round(v, 6) for v in p0['losses']]} vs "
          f"{[round(v, 6) for v in p0['serial_losses']]} (relative "
          f"{[f'{v:.2e}' for v in rel]}, tol {PARITY_LOSS_TOL}); step 1 "
          f"gradients of {len(p0['ratios'])} leaves, worst "
          f"{p0['ratios'][worst]:.3e} of the leaf's largest ({worst}; tol "
          f"{PARITY_GRAD_TOL}); control (mp rank 1's shard of "
          f"{p0['control_leaf']} x{PARITY_CONTROL}) {p0['control']:.3e} "
          f"(must fail); K5/K6 at H=6 row stride 1152: forward errs "
          f"{ {k: f'{v:.3e}' for k, v in p0['kernels']['fwd_err'].items()} }"
          f", backward gate ratios "
          f"{ {k: f'{v:.3e}' for k, v in p0['kernels']['bwd_ratios'].items()} }"
          f"; peak allocated by rank "
          f"{[round(_gib(r['parity']['peak'][0]), 3) for r in ranks]} GiB; "
          f"card {card}", flush=True)
    check(max(rel) <= PARITY_LOSS_TOL, f"[{tag}] losses part by {rel}")
    check(p0["ratios"][worst] <= PARITY_GRAD_TOL,
          f"[{tag}] {worst} gradient {p0['ratios'][worst]:.3e}")
    check(p0["control"] > PARITY_GRAD_TOL,
          f"[{tag}] the control passes ({p0['control']:.3e})")
    return {k: sum(r["train"]["launches"][k] for r in ranks)
            for k in tr[0]["launches"]}


# ---------------------------------------------------------------------------
# ERNIE under sharding stage 2 and context parallel (one world of four
# ranks), pipeline parallel (one world of eight): 15zi-15zn
# ---------------------------------------------------------------------------
SHARD_STEPS = 5                  # [train ernie sharding]: dygraph steps
SHARD_LR = 1e-4                  # AdamW's rate (multi_precision, bf16 O2)
SHARD_MASKED = 77                # MLM positions in every row (15% of 512):
                                 # each rank's mean over its rows is then
                                 # its share of the global batch's mean
CP_STEPS = 3                     # [train gpt cp]: steps of each kind
PIPE_M, PIPE_S = 8, 2048         # [train gpt3 pipe]: micro-batches of 1
PIPE_STEPS = 3                   # timed steps, after one warm step
PIPE_LR = 1e-4                   # AdamW's rate (fp32, as the JAX engine)
PIPE_CLIP = 1.0                  # the hybrid global-norm clip
PIPE_GIB = 6.1                   # a rank's reckoned peak at dp1 x mp2 x pp4
                                 # (GPT3_MEMFIT.json, PERF.md section 5)
PP_PARITY_M = 4                  # [train gpt pipe parity]: micro-batches
PIPE_FLASH = (1, PIPE_S, 8, 128)  # one rank's K5/K6 shape at 1.3B, mp2
FLASH_OUT_TOL = (2e-4, 2e-5)     # (rtol, atol) of the outputs and of the
FLASH_GRAD_TOL = (5e-4, 5e-5)    # gradients: ROADMAP C's flash bounds


def _fleet_init(paddle, hybrid, pipeline=None):
    s = paddle.distributed.fleet.DistributedStrategy()
    s.hybrid_configs = hybrid
    if pipeline is not None:
        s.pipeline_configs = pipeline
    paddle.distributed.fleet.init(is_collective=True, strategy=s)
    return paddle.distributed.fleet.get_hybrid_communicate_group()


def _launches(fk):
    out = {f.__name__: f.launches for f in fk.ALL_WRAPPERS}
    out.update({f"{f.__name__}.tc": f.tc_launches for f in fk.TC_WRAPPERS})
    out["plain"] = sum(f.plain_calls for f in fk.ALL_WRAPPERS)
    return out


def _per_step(stats, steps):
    return {k: {"calls": v["calls"] / steps, "bytes": v["bytes"] / steps,
                "ms": v["seconds"] * 1e3 / steps} for k, v in stats.items()}


def _stats_line(per_step):
    return ", ".join(f"{k} {v['calls']:.0f} / {v['bytes'] / 2**20:.1f} MiB "
                     f"/ {v['ms']:.1f} ms"
                     for k, v in sorted(per_step.items()))


def _profiled_busy(torch, step):
    """One profiled ``step()``: (wall ms, this rank's device busy ms)."""
    with profile_window(torch) as prof:
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    busy = sum(kernel_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return wall, busy


def _mlm_even(vocab, b, s, k, seed):
    """Tokens and MLM labels on exactly ``k`` positions of every row (-100
    elsewhere), from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (b, s)).astype(np.int64)
    y = np.full_like(x, -100)
    for i in range(b):
        at = rng.choice(s, k, replace=False)
        y[i, at] = x[i, at]
    return x, y


def _ernie_shard_model(torch, paddle, seed, o2):
    """ERNIE-3.0-base MLM from a card generator seeded ``seed`` (the same
    draws in every process), dropout 0: bf16 O2 with AdamW (PaddleNLP's
    decay set) when ``o2``, else fp32 with SGD; both with the global-norm
    clip."""
    from paddle_tpu_torch.models import BertForPretraining, ernie_3_base
    cfg = ernie_3_base(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    net = BertForPretraining(cfg, device="cuda", generator=gen)
    clip = paddle.nn.ClipGradByGlobalNorm(1.0)
    if not o2:
        return cfg, net, paddle.optimizer.SGD(
            learning_rate=PARITY_LR, parameters=net.parameters(),
            grad_clip=clip)
    decay = {p.name for n, p in net.named_parameters()
             if not any(nd in n for nd in ERNIE_NO_DECAY)}
    opt = paddle.optimizer.AdamW(
        learning_rate=SHARD_LR, parameters=net.parameters(),
        weight_decay=0.01, apply_decay_param_fun=lambda name: name in decay,
        grad_clip=clip, multi_precision=True)
    paddle.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    return cfg, net, opt


def _data_rows(hcg, b):
    n, r = hcg._get_data_group().nranks, hcg._data_rank()
    k = b // n
    return slice(r * k, (r + 1) * k), n


def _ernie_sharding(torch, paddle, seed):
    """[train ernie sharding] on this rank (``world4_phase``)."""
    from paddle_tpu_torch.models import BertPretrainingCriterion
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dist = paddle.distributed
    comm = dist.communication
    hcg = _fleet_init(paddle, {"sharding_degree": 4})
    cfg, net, opt = _ernie_shard_model(torch, paddle, seed + 2800, True)
    model, opt, _ = dist.sharding.group_sharded_parallel(net, opt,
                                                          level="os_g")
    crit = BertPretrainingCriterion(cfg.vocab_size)
    x, y = _mlm_even(cfg.vocab_size, ERNIE_B, ERNIE_S, SHARD_MASKED,
                     seed + 2801)
    rows, n = _data_rows(hcg, ERNIE_B)
    xs, ys = (torch.from_numpy(a[rows]).cuda() for a in (x, y))

    def step():
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            mlm, nsp = model(xs)
        loss = crit(mlm, nsp, ys)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_counts()
    comm.reset_counts()
    losses, ms = [], []
    for _ in range(SHARD_STEPS):
        t0 = time.monotonic()
        v = step().detach().float().reshape(1)
        comm.all_reduce(v, group=hcg._get_data_group())
        losses.append(float(v) / n)
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
    launches = _launches(fk)
    stats = comm.comm_stats(by_axis=True)
    peak = _peaks(torch)
    wall, busy = _profiled_busy(torch, step)
    inner = opt._optim
    state_bytes = sum(v.numel() * v.element_size()
                      for st in inner._state.values() for v in st.values()
                      if isinstance(v, torch.Tensor))
    w = _dist_exercise()
    replicas = w.replica_diffs(list(net.parameters()),
                               hcg.get_sharding_parallel_group())
    res = {"losses": losses, "ms": ms, "launches": launches, "stats": stats,
           "peak": peak, "wall_ms": wall, "busy_ms": busy,
           "state_bytes": state_bytes, "replicas": replicas,
           "params": sum(p.numel() for p in net.parameters()),
           "rows": [rows.start, rows.stop]}
    del model, opt, net
    torch.cuda.empty_cache()
    return res


def _ernie_sharding_parity(torch, paddle, seed):
    """[train ernie sharding parity] on this rank: fp32 ERNIE-3.0-base at
    stage 2 over four ranks, SGD with the global-norm clip; step 1's
    whole reduced gradients (rank 0 keeps them) and the
    ``PARITY_STEPS`` losses.  The single-process loop runs after the
    world (:func:`_ernie_reference`)."""
    from paddle_tpu_torch.models import BertPretrainingCriterion
    dist = paddle.distributed
    hcg = _fleet_init(paddle, {"sharding_degree": 4})
    cfg, net, opt = _ernie_shard_model(torch, paddle, seed + 2810, False)
    model, opt, _ = dist.sharding.group_sharded_parallel(net, opt,
                                                          level="os_g")
    crit = BertPretrainingCriterion(cfg.vocab_size)
    x, y = _mlm_even(cfg.vocab_size, ERNIE_B, ERNIE_S, SHARD_MASKED,
                     seed + 2811)
    rows, n = _data_rows(hcg, ERNIE_B)
    xs, ys = (torch.from_numpy(a[rows]).cuda() for a in (x, y))
    crit(*model(xs), ys).backward()
    update = opt._hybrid_update()
    update.reduce()
    grads = {k: v.float().cpu().numpy()
             for k, v in update.sharded.gather_grads().items()}
    for _, p in update.named:
        p.grad = None
    update.sharded.clear_shard_grads()
    losses = []
    for _ in range(PARITY_STEPS):
        loss = crit(*model(xs), ys)
        loss.backward()
        opt.step()
        opt.clear_grad()
        v = loss.detach().float().reshape(1)
        dist.all_reduce(v, group=hcg._get_data_group())
        losses.append(float(v) / n)
    del model, opt, net
    torch.cuda.empty_cache()
    return {"losses": losses,
            "grads": grads if dist.get_rank() == 0 else None}


def _ernie_reference(torch, paddle, seed, grads):
    """The single-process fp32 loop on the card on
    :func:`_ernie_sharding_parity`'s weights and whole batch: its losses
    and the per-leaf gate of the stage-2 gradients, and of a planted
    control (rank 1's chunk of one leaf's gradient scaled by
    ``PARITY_CONTROL``), which must fail."""
    from paddle_tpu_torch.models import BertPretrainingCriterion
    cfg, net, opt = _ernie_shard_model(torch, paddle, seed + 2810, False)
    crit = BertPretrainingCriterion(cfg.vocab_size)
    x, y = (torch.from_numpy(a).cuda() for a in _mlm_even(
        cfg.vocab_size, ERNIE_B, ERNIE_S, SHARD_MASKED, seed + 2811))
    losses, ref = [], None
    for i in range(PARITY_STEPS):
        loss = crit(*net(x), y)
        loss.backward()
        if i == 0:              # the NSP head takes no gradient: zeros,
            ref = {k: (p.grad.float().cpu().numpy()    # as the chunks hold
                       if p.grad is not None else np.zeros(p.shape,
                                                           np.float32))
                   for k, p in net.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    del net, opt
    torch.cuda.empty_cache()
    ratios = _grad_gate(grads, ref)
    leaf = max((k for k in ref if ".encoder." in k and k.endswith("weight")),
               key=lambda k: ref[k].size)
    bad = grads[leaf].copy().reshape(-1)
    chunk = -(-bad.size // 4)
    bad[chunk:2 * chunk] *= PARITY_CONTROL
    control = _grad_gate({leaf: bad.reshape(ref[leaf].shape)},
                         {leaf: ref[leaf]})[leaf]
    return {"serial_losses": losses, "ratios": ratios, "control": control,
            "control_leaf": leaf}


def _cp_train(torch, paddle, seed, kind):
    """[train gpt cp] on this rank: GPT-2-small at sep2 x mp2 through
    ``DistributedRunner``, ``context_parallel=kind``, bf16 O2, AdamW with
    the global-norm clip, ``CP_STEPS`` steps of the global batch."""
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt2_small)
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    comm = paddle.distributed.communication
    hcg = _fleet_init(paddle, {"sep_degree": 2, "mp_degree": 2})
    cfg = gpt2_small(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0, context_parallel=kind)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 2900 + hcg.get_model_parallel_rank())
    net = GPTForCausalLM(cfg, device="cuda", generator=gen)
    opt = paddle.optimizer.AdamW(
        learning_rate=HYBRID_LR, parameters=net.parameters(),
        multi_precision=True,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(HYBRID_CLIP))
    paddle.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    runner = DistributedRunner(net, opt, GPTPretrainingCriterion(),
                               amp_level="O2", amp_dtype="bfloat16")
    rng = np.random.default_rng(seed + 2901)
    x = rng.integers(0, cfg.vocab_size, (HYBRID_B, HYBRID_S)).astype(np.int64)
    y = np.roll(x, -1, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_counts()
    comm.reset_counts()
    losses, ms = [], []
    for _ in range(CP_STEPS):
        t0 = time.monotonic()
        losses.append(runner.train_step([x], [y]))
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
    res = {"losses": losses, "ms": ms, "launches": _launches(fk),
           "stats": comm.comm_stats(by_axis=True),
           "composed": comm.composed_counts(), "peak": _peaks(torch)}
    res["wall_ms"], res["busy_ms"] = _profiled_busy(
        torch, lambda: runner.train_step([x], [y]))
    w = _dist_exercise()
    leaves = w.optimizer_leaves(opt)
    res["replicas"] = {
        "sep": w.replica_diffs([t for t, _ in leaves],
                               hcg.get_sep_parallel_group()),
        "mp": w.replica_diffs([t for t, sp in leaves if not sp],
                              hcg.get_model_parallel_group())}
    del runner, opt, net
    torch.cuda.empty_cache()
    return res


def _cp_parity(torch, paddle, seed, kind, state):
    """[train gpt cp parity] on this rank: the fp32 GPT-2-small from numpy
    weights at sep2 x mp2 (``context_parallel=kind``) through
    ``DistributedRunner``, SGD; rank 0 then runs the single-process raw
    loop on the same weights and batch (:func:`_parity_reference`)."""
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt2_small,
                                         state_dict_from_jax)
    dist = paddle.distributed
    hcg = _fleet_init(paddle, {"sep_degree": 2, "mp_degree": 2})
    cfg = gpt2_small(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0, context_parallel=kind)
    rng = np.random.default_rng(seed + 2951)
    x = rng.integers(0, cfg.vocab_size, (HYBRID_B, HYBRID_S)).astype(np.int64)
    y = np.roll(x, -1, 1)
    net = GPTForCausalLM(cfg, device="cuda")
    net.load_state_dict(state_dict_from_jax(
        state, cfg, hcg.get_model_parallel_rank(), 2))
    opt = paddle.optimizer.SGD(learning_rate=PARITY_LR,
                               parameters=net.parameters())
    runner = DistributedRunner(net, opt, GPTPretrainingCriterion())
    dev = runner._device()
    runner._forward_loss(runner._rows([x], 0, HYBRID_B, dev),
                         runner._rows([y], 0, HYBRID_B, dev)).backward()
    runner._update.reduce()
    grads = {k: p.grad.float().cpu().numpy() for k, p in runner._update.named}
    for _, p in runner._update.named:
        p.grad = None
    mp_grads = []
    dist.all_gather_object(mp_grads, grads,
                           group=hcg.get_model_parallel_group())
    del grads
    losses = [runner.train_step([x], [y]) for _ in range(PARITY_STEPS)]
    del runner, opt, net
    torch.cuda.empty_cache()
    res = {"losses": losses}
    if dist.get_rank() == 0:
        res.update(_parity_reference(torch, paddle, cfg, state, x, y,
                                     mp_grads))
    dist.barrier()
    return res


def _close(got, ref, tol):
    """max |got - ref| - rtol |ref| over the elements, beside max |got -
    ref| (the allclose test: the first at most ``atol``)."""
    d = (got.float() - ref.float()).abs()
    return (float((d - tol[0] * ref.float().abs()).max()),
            float(d.max()))


def _zigzag_hold(torch, paddle, seed):
    """``ring_flash_attention(balanced=True)`` on zigzag-ordered slices of
    the global q, k, v ``[8, 1024, 6, 64]`` fp32 (one rank's GPT-2 heads
    at mp2) over the sep group, the output merged and the gradients of
    the global inputs, against the plain attention on the whole."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        context_parallel as cp
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    group = collective.get_mesh().get_sep_parallel_group()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 2990)
    q, k, v, w = (torch.randn(HYBRID_B, HYBRID_S, 6, 64, device="cuda",
                              generator=gen) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    parts = [cp.zigzag_split_sequence(t, group=group) for t in leaves]
    out = cp.zigzag_merge_sequence(cp.ring_flash_attention(
        *parts, causal=True, balanced=True, group=group), group=group)
    (out * w).sum().backward()
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref, _ = fk.flash_attention_reference(*ref_leaves, True)
    (ref * w).sum().backward()
    errs = {"out": _close(out.detach(), ref.detach(), FLASH_OUT_TOL)}
    for name, a, b in zip(("dq", "dk", "dv"), leaves, ref_leaves):
        errs[name] = _close(a.grad, b.grad, FLASH_GRAD_TOL)
    return errs


def _world4_rank(workdir, stacks_after, seed):
    torch, paddle = _rank_setup(stacks_after)
    paddle.distributed.init_parallel_env()
    res, secs = {}, {}
    t0 = time.monotonic()
    res["ernie"] = _ernie_sharding(torch, paddle, seed)
    res["ernie_parity"] = _ernie_sharding_parity(torch, paddle, seed)
    secs["ernie"] = time.monotonic() - t0
    t0 = time.monotonic()
    res["cp"] = {kind: _cp_train(torch, paddle, seed, kind)
                 for kind in ("ring", "ulysses")}
    from paddle_tpu_torch.models import gpt2_small
    state = gpt_numpy_state(gpt2_small(), seed + 2950)
    res["cp_parity"] = {kind: _cp_parity(torch, paddle, seed, kind, state)
                        for kind in ("ring", "ulysses")}
    res["zigzag"] = _zigzag_hold(torch, paddle, seed)
    secs["cp"] = time.monotonic() - t0
    res["secs"] = secs
    _rank_done(workdir, res)


def world4_phase(torch, seed):
    """``[train ernie sharding]``, its parity, ``[train gpt cp]`` and its
    parity: four ranks on the one card (gloo over CUDA tensors), started
    once; this process runs the ERNIE single-process reference after the
    world, prints and gates.  Returns the ERNIE training's launches
    summed over the ranks."""
    import paddle_tpu_torch as paddle
    t0 = time.monotonic()
    ranks = _run_world(_world4_rank, 4, {}, seed)
    world_s = time.monotonic() - t0
    card = card_line()

    tag = "train ernie sharding"
    tr = [r["ernie"] for r in ranks]
    for i, res in enumerate(tr):
        la = res["launches"]
        check(all(np.isfinite(res["losses"])) and res["losses"] == tr[0][
            "losses"], f"[{tag}] rank {i} losses {res['losses']}")
        check(res["losses"][-1] < res["losses"][0],
              f"[{tag}] rank {i}: loss did not fall: {res['losses']}")
        check(la["flash_fwd"] == la["flash_fwd.tc"] > 0
              and la["flash_bwd_dq"] == la["flash_bwd_dq.tc"] > 0
              and la["flash_bwd_dkv"] == la["flash_bwd_dkv.tc"] > 0
              and la["plain"] == 0, f"[{tag}] rank {i} launches {la}")
        rep = res["replicas"]
        check(rep[0] > 0 and rep[1] == 0, f"[{tag}] rank {i}: parameters "
              f"differ over the sharding group (compared, differing) {rep}")
    total_state = sum(r["state_bytes"] for r in tr)
    per_step = _per_step(tr[0]["stats"], SHARD_STEPS)
    busy = [r["busy_ms"] for r in tr]
    wall = max(r["wall_ms"] for r in tr)
    print(f"[{tag}] ERNIE-3.0-base MLM L=12 D=768 H=12 V=40000 global "
          f"B={ERNIE_B} S={ERNIE_S} ({SHARD_MASKED} masked a row), sharding "
          "4 on 4 ranks of one card (spawn, fleet.init, group_sharded_"
          "parallel(level='os_g')), bf16 O2 (amp.decorate + auto_cast) "
          f"AdamW lr {SHARD_LR} with the global-norm clip, {SHARD_STEPS} "
          f"dygraph steps: losses {[round(v, 5) for v in tr[0]['losses']]}"
          "; " + "; ".join(
              f"rank {i} rows {r['rows']} step_ms "
              f"{[round(v, 1) for v in r['ms']]} optimizer state "
              f"{r['state_bytes'] / 2**20:.1f} MiB peak allocated "
              f"{_gib(r['peak'][0]):.3f} GiB reserved "
              f"{_gib(r['peak'][1]):.3f} GiB" for i, r in enumerate(tr))
          + f"; the ranks' optimizer state together {total_state / 2**20:.1f}"
          f" MiB (one process would hold it all: each rank "
          f"{[round(r['state_bytes'] / total_state, 4) for r in tr]} of "
          f"it); parameters bit-equal over the 4 ranks after the last step "
          f"({tr[0]['replicas'][0]} elements); card {card}", flush=True)
    la = tr[0]["launches"]
    print(f"[{tag}] step_ms median(steps 3+, median over ranks) "
          f"{np.median([np.median(r['ms'][2:]) for r in tr]):.1f}; "
          f"collectives a step on rank 0 (calls, bytes in, host ms): "
          f"{_stats_line(per_step)}; one profiled step: wall {wall:.1f} ms, "
          f"device busy by rank {[round(b, 1) for b in busy]} ms, card idle "
          f"share {max(0.0, 1 - sum(busy) / wall):.4f}; K5/K6 a rank at "
          f"[{ERNIE_B // 4}, {ERNIE_S}, 12, 64] bf16 non-causal: flash_fwd "
          f"{la['flash_fwd']} (tc {la['flash_fwd.tc']}), flash_bwd_dq "
          f"{la['flash_bwd_dq']} (tc {la['flash_bwd_dq.tc']}), "
          f"flash_bwd_dkv {la['flash_bwd_dkv']} (tc "
          f"{la['flash_bwd_dkv.tc']}), plain {la['plain']}", flush=True)

    tag = "train ernie sharding parity"
    t1 = time.monotonic()
    p = [r["ernie_parity"] for r in ranks]
    for i, r in enumerate(p):
        check(r["losses"] == p[0]["losses"],
              f"[{tag}] rank {i} losses {r['losses']}")
    ref = _ernie_reference(torch, paddle, seed, p[0]["grads"])
    _parity_gates(tag, "ERNIE-3.0-base fp32, global B=16 S=512, sharding 4 "
                  "(group_sharded_parallel level 'os_g') on 4 ranks vs the "
                  "single-process loop on the card, same weights and "
                  f"batch, SGD lr {PARITY_LR} with the global-norm clip",
                  p[0]["losses"], ref, "rank 1's chunk of", card,
                  time.monotonic() - t1)

    tag = "train gpt cp"
    for kind in ("ring", "ulysses"):
        c = [r["cp"][kind] for r in ranks]
        for i, res in enumerate(c):
            check(all(np.isfinite(res["losses"])) and res["losses"] ==
                  c[0]["losses"], f"[{tag}] {kind} rank {i} losses "
                  f"{res['losses']}")
            check(res["losses"][-1] < res["losses"][0],
                  f"[{tag}] {kind} rank {i}: loss did not fall: "
                  f"{res['losses']}")
            rep = res["replicas"]
            check(rep["sep"][0] > 0 and rep["mp"][0] > 0 and
                  rep["sep"][1] == rep["mp"][1] == 0,
                  f"[{tag}] {kind} rank {i}: replicas differ {rep}")
        per_step = _per_step(c[0]["stats"], CP_STEPS)
        busy = [r["busy_ms"] for r in c]
        wall = max(r["wall_ms"] for r in c)
        print(f"[{tag}] {kind}: GPT-2-small L=12 D=768 H=12 V=50304 global "
              f"B={HYBRID_B} S={HYBRID_S}, sep2 x mp2 on 4 ranks of one card "
              "(each rank 512 positions, 6 heads) through DistributedRunner, "
              f"bf16 O2 AdamW lr {HYBRID_LR}, global-norm clip, {CP_STEPS} "
              f"steps: losses {[round(v, 5) for v in c[0]['losses']]}, "
              f"step_ms by rank {[[round(v, 1) for v in r['ms']] for r in c]}"
              f", peak allocated by rank "
              f"{[round(_gib(r['peak'][0]), 3) for r in c]} GiB reserved "
              f"{[round(_gib(r['peak'][1]), 3) for r in c]} GiB; replicas "
              f"bit-equal over sep (every leaf) and mp (leaves not split) "
              f"{c[0]['replicas']}; collectives a step on rank 0 (calls, "
              f"bytes in, host ms): {_stats_line(per_step)}; composed on "
              f"gloo {c[0]['composed']}; one profiled step: wall "
              f"{wall:.1f} ms, device busy by rank "
              f"{[round(b, 1) for b in busy]} ms, card idle share "
              f"{max(0.0, 1 - sum(busy) / wall):.4f}; flash launches "
              f"{c[0]['launches']['flash_fwd']} (the sep attention is "
              f"composed from torch operations); card {card}", flush=True)

    tag = "train gpt cp parity"
    for kind in ("ring", "ulysses"):
        p0 = ranks[0]["cp_parity"][kind]
        for i, r in enumerate(ranks):
            check(r["cp_parity"][kind]["losses"] == p0["losses"],
                  f"[{tag}] {kind} rank {i} losses "
                  f"{r['cp_parity'][kind]['losses']}")
        _parity_gates(f"{tag}] [{kind}", "GPT-2-small fp32, global B="
                      f"{HYBRID_B} S={HYBRID_S}, sep2 x mp2 through "
                      f"DistributedRunner (context_parallel={kind!r}) on 4 "
                      "ranks vs the single-process raw loop on the card, "
                      f"same numpy weights and batch, SGD lr {PARITY_LR}",
                      p0["losses"], p0, "mp rank 1's shard of", card, None)
    z = ranks[0]["zigzag"]
    for i, r in enumerate(ranks):
        for name, (over, worst) in r["zigzag"].items():
            atol = (FLASH_OUT_TOL if name == "out" else FLASH_GRAD_TOL)[1]
            check(over <= atol, f"[{tag}] zigzag rank {i} {name}: |d| - "
                  f"rtol |ref| reaches {over:.3e} > {atol}")
    print(f"[{tag}] ring_flash_attention(balanced=True) on zigzag slices "
          f"of q, k, v [{HYBRID_B}, {HYBRID_S}, 6, 64] fp32 over sep 2, "
          "causal, merged, vs the plain attention on the whole: max |d| "
          + ", ".join(f"{k} {v[1]:.3e}" for k, v in z.items())
          + f" (allclose at {FLASH_OUT_TOL} out, {FLASH_GRAD_TOL} gradients);"
          f" seconds in the world: ERNIE {ranks[0]['secs']['ernie']:.1f}, "
          f"cp {ranks[0]['secs']['cp']:.1f}; world {world_s:.1f} s",
          flush=True)
    return {k: sum(r["ernie"]["launches"][k] for r in ranks)
            for k in tr[0]["launches"]}


def _parity_gates(tag, desc, losses, ref, control_what, card, ref_s):
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["serial_losses"])]
    worst = max(ref["ratios"], key=ref["ratios"].get)
    print(f"[{tag}] {desc}: losses {[round(v, 6) for v in losses]} vs "
          f"{[round(v, 6) for v in ref['serial_losses']]} (relative "
          f"{[f'{v:.2e}' for v in rel]}, tol {PARITY_LOSS_TOL}); step 1 "
          f"gradients of {len(ref['ratios'])} leaves, worst "
          f"{ref['ratios'][worst]:.3e} of the leaf's largest ({worst}; tol "
          f"{PARITY_GRAD_TOL}); control ({control_what} "
          f"{ref['control_leaf']} x{PARITY_CONTROL}) {ref['control']:.3e} "
          "(must fail)" + ("" if ref_s is None else
                           f"; reference {ref_s:.1f} s") + f"; card {card}",
          flush=True)
    check(max(rel) <= PARITY_LOSS_TOL, f"[{tag}] losses part by {rel}")
    check(ref["ratios"][worst] <= PARITY_GRAD_TOL,
          f"[{tag}] {worst} gradient {ref['ratios'][worst]:.3e}")
    check(ref["control"] > PARITY_GRAD_TOL,
          f"[{tag}] the control passes ({ref['control']:.3e})")


def _gpt3_pipe(torch, paddle, seed):
    """[train gpt3 pipe] on this rank (``pipe_world_phase``)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import is_mp_split
    from paddle_tpu_torch.models import GPTForCausalLMPipe, gpt3_1p3b
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dist = paddle.distributed
    comm = dist.communication
    hcg = _fleet_init(paddle, {"mp_degree": 2, "pp_degree": 4},
                      {"accumulate_steps": PIPE_M, "micro_batch_size": 1})
    stage, mp = hcg.get_stage_id(), hcg.get_model_parallel_rank()
    cfg = gpt3_1p3b(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 3000 + 10 * stage + mp)
    t0 = time.monotonic()
    net = GPTForCausalLMPipe(cfg, num_stages=4, device="cuda", generator=gen)
    opt = paddle.optimizer.AdamW(
        learning_rate=PIPE_LR, parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(PIPE_CLIP))
    model = dist.fleet.distributed_model(net)
    build_s = time.monotonic() - t0
    rng = np.random.default_rng(seed + 3001)
    x = rng.integers(0, cfg.vocab_size, (PIPE_M, PIPE_S)).astype(np.int64)
    y = np.roll(x, -1, 1)

    def step():
        return float(model.train_batch((x, y), opt))

    t0 = time.monotonic()
    losses = [step()]
    torch.cuda.synchronize()
    warm_ms = (time.monotonic() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    fk.reset_counts()
    comm.reset_counts()
    ms = []
    for _ in range(PIPE_STEPS - 1):
        t0 = time.monotonic()
        losses.append(step())
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
    wall, busy = _profiled_busy(torch, lambda: losses.append(step()))
    ms.append(wall)                     # the last step, under the profiler
    launches = _launches(fk)
    stats = comm.comm_stats(by_axis=True)
    peak = _peaks(torch)
    w = _dist_exercise()
    ties = [w.replica_diffs([p], g) for p, g, _ in model._engine._ties]
    mp_rep = w.replica_diffs([p for p in net.parameters()
                              if not is_mp_split(p)],
                             hcg.get_model_parallel_group())
    layers = sum(1 for l in net.run_function
                 if type(l).__name__ == "GPTDecoderLayer")
    res = {"losses": losses, "warm_ms": warm_ms, "ms": ms,
           "launches": launches, "stats": stats, "peak": peak,
           "wall_ms": wall, "busy_ms": busy, "ties": ties, "mp_rep": mp_rep,
           "coords": (stage, mp), "layers": layers, "build_s": build_s,
           "params": sum(p.numel() for p in net.parameters())}
    del model, opt, net
    torch.cuda.empty_cache()
    return res


def _pipe_parity(torch, paddle, seed):
    """[train gpt pipe parity] on this rank: the fp32 GPT-2-small pipe
    model from numpy weights at dp2 x mp2 x pp2 through
    ``PipelinedRunner``, SGD with the global-norm clip: step 1's reduced
    gradients of this rank's stage shard (the dp-rank-0 ranks keep
    them) and the ``PARITY_STEPS`` losses.  The single-process loop runs
    after the world (:func:`_pipe_reference`)."""
    from paddle_tpu_torch.distributed import PipelinedRunner
    from paddle_tpu_torch.models import GPTForCausalLMPipe, gpt2_small
    from paddle_tpu_torch.models.gpt import (pipe_state_from_causal,
                                             state_dict_from_jax)
    hcg = _fleet_init(paddle, {"dp_degree": 2, "mp_degree": 2,
                               "pp_degree": 2})
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    state = pipe_state_from_causal(gpt_numpy_state(cfg, seed + 3100), cfg)
    stage, mp = hcg.get_stage_id(), hcg.get_model_parallel_rank()
    net = GPTForCausalLMPipe(cfg, num_stages=2, device="cuda")
    net.load_state_dict(state_dict_from_jax(state, cfg, mp, 2, stage, 2))
    del state
    opt = paddle.optimizer.SGD(
        learning_rate=PARITY_LR, parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(PIPE_CLIP))
    runner = PipelinedRunner(net, opt, accumulate_steps=PP_PARITY_M)
    x, y = _pipe_parity_batch(cfg, seed)
    eng = runner._engine
    update = eng._hybrid_update(opt)
    eng._layers.train()
    eng._schedule(torch.from_numpy(x), torch.from_numpy(y), True)
    update.reduce()
    grads = {k: p.grad.float().cpu().numpy()
             for k, p in net.named_parameters()}
    for _, p in update.named:
        p.grad = None
    losses = [runner.train_step([x], [y])[0] for _ in range(PARITY_STEPS)]
    del runner, opt, net
    torch.cuda.empty_cache()
    return {"losses": losses, "coords": (hcg.get_data_parallel_rank(),
                                         stage, mp),
            "grads": grads if hcg.get_data_parallel_rank() == 0 else None}


def _pipe_parity_batch(cfg, seed):
    rng = np.random.default_rng(seed + 3101)
    x = rng.integers(0, cfg.vocab_size, (HYBRID_B, HYBRID_S)).astype(np.int64)
    return x, np.roll(x, -1, 1)


def _pipe_reference(torch, paddle, seed, ranks):
    """The single-process raw loop on the card (GPT-2-small fp32, the
    numpy weights of :func:`_pipe_parity`, SGD with the global-norm clip):
    its losses and the per-leaf gate of the pipe ranks' gradients joined
    over mp and the stages, and of a planted control (mp rank 1's shard
    of one leaf of stage 0 scaled by ``PARITY_CONTROL``), which must
    fail."""
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt2_small,
                                         state_dict_from_jax)
    from paddle_tpu_torch.models.gpt import (causal_state_from_pipe,
                                             merge_mp_states)
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    net = GPTForCausalLM(cfg, device="cuda")
    net.load_state_dict(state_dict_from_jax(gpt_numpy_state(
        cfg, seed + 3100), cfg))
    opt = paddle.optimizer.SGD(
        learning_rate=PARITY_LR, parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(PIPE_CLIP))
    crit = GPTPretrainingCriterion()
    x, y = (torch.from_numpy(a).cuda() for a in _pipe_parity_batch(cfg, seed))
    losses, ref = [], None
    for i in range(PARITY_STEPS):
        loss = crit(net(x), y)
        loss.backward()
        if i == 0:
            ref = {k: p.grad.float().cpu().numpy()
                   for k, p in net.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    del net, opt
    torch.cuda.empty_cache()
    mine = sorted((r["parity"] for r in ranks
                   if r["parity"]["coords"][0] == 0),
                  key=lambda r: r["coords"][1:])
    states = [r["grads"] for r in mine]
    got = causal_state_from_pipe(merge_mp_states(states, cfg, 2), cfg)
    ratios = _grad_gate(got, ref)
    li = cfg.num_hidden_layers // 4                  # a layer of stage 0
    leaf = f"gpt.layers.{li}.mlp.fc1.weight"
    pipe_leaf = f"_layers_list.{li + 1}.mlp.fc1.weight"
    bad = [dict(s) for s in states]
    bad[1][pipe_leaf] = bad[1][pipe_leaf] * PARITY_CONTROL
    control = _grad_gate(causal_state_from_pipe(
        merge_mp_states(bad, cfg, 2), cfg), ref)[leaf]
    return {"serial_losses": losses, "ratios": ratios, "control": control,
            "control_leaf": leaf}


def _pipe_rank(workdir, stacks_after, seed):
    torch, paddle = _rank_setup(stacks_after)
    paddle.distributed.init_parallel_env()
    res = {}
    t0 = time.monotonic()
    res["pipe"] = _gpt3_pipe(torch, paddle, seed)
    t1 = time.monotonic()
    res["parity"] = _pipe_parity(torch, paddle, seed)
    res["secs"] = {"pipe": t1 - t0, "parity": time.monotonic() - t1}
    _rank_done(workdir, res)


def _pipe_flash_hold(torch, seed):
    """K5 / K6 at the 1.3B pipeline's per-rank shape: q, k, v strided
    views ``[1, 2048, 8, 128]`` of a packed qkv (row stride 3072
    elements), fp32 (the CUDA-core kernels), causal, against their plain
    versions at ROADMAP C's flash bounds; then each kernel's time (CUDA
    events and device time), the plain version's, the bound at the fp32
    CUDA-core rate and SDPA's forward in fp32 as the library yardstick."""
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    B, S, H, D = PIPE_FLASH
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 3200)
    qkv = torch.randn(B, S, 3, H, D, device="cuda", generator=gen)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    g = torch.randn(B, S, H, D, device="cuda", generator=gen)
    fk.reset_counts()
    got = flash_run(fk, q, k, v, g, True)
    la = _launches(fk)
    check(la["flash_fwd"] == la["flash_bwd_dq"] == la["flash_bwd_dkv"] == 1
          and la["flash_fwd.tc"] == la["flash_bwd_dq.tc"] ==
          la["flash_bwd_dkv.tc"] == la["plain"] == 0,
          f"[train gpt3 pipe] fp32 D=128: not the CUDA-core kernels {la}")
    ref = flash_plain(torch, fk, q, k, v, g, True)
    torch.cuda.synchronize()
    errs = {}
    for name in ("out", "lse", "dq", "dk", "dv"):
        tol = FLASH_OUT_TOL if name in ("out", "lse") else FLASH_GRAD_TOL
        check(bool(torch.isfinite(got[name]).all()),
              f"[train gpt3 pipe] fp32 D=128 {name} not finite")
        over, worst = _close(got[name], ref[name], tol)
        check(over <= tol[1], f"[train gpt3 pipe] fp32 D=128 {name}: "
              f"|d| - rtol |ref| reaches {over:.3e} > {tol[1]}")
        errs[name] = worst
    out, lse = got["out"], got["lse"]
    dq_res = fk.flash_bwd_dq(q, k, v, out, lse, g, True)
    calls = {
        "flash_fwd": (lambda: fk.flash_fwd(q, k, v, True),
                      lambda: fk.flash_attention_reference(q, k, v, True)),
        "flash_bwd_dq": (
            lambda: fk.flash_bwd_dq(q, k, v, out, lse, g, True),
            lambda: fk.flash_bwd_dq_reference(q, k, v, out, lse, g, True)),
        "flash_bwd_dkv": (
            lambda: fk.flash_bwd_dkv(q, k, v, g, lse, dq_res[1], True),
            lambda: fk.flash_bwd_dkv_reference(q, k, v, g, lse, dq_res[1],
                                               True)),
    }
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with torch.no_grad():
        sdpa_ms = time_cuda(torch, lambda: torch.nn.functional.
                            scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True),
                            10)
    res = {"errs": errs}
    for name, (kern, plain) in calls.items():
        with torch.no_grad():
            ms = time_cuda(torch, kern, 10)
            dev_ms = device_ms(torch, kern, 5, {"all": ()})["all"]
            plain_ms = time_cuda(torch, plain, 3, warmup=1)
        flops, nbytes = fk.kernel_work(name, B, H, S, S, D, True, 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        res[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "library_ms": sdpa_ms if name == "flash_fwd" else None,
                     "tflops": flops / (ms * 1e-3) / 1e12}
    return res


def pipe_world_phase(torch, seed):
    """``[train gpt3 pipe]`` and ``[train gpt pipe parity]``: eight ranks
    on the one card, started once; this process then runs the GPT-2
    single-process reference and holds K5/K6 at the 1.3B rank shape.
    Returns the 1.3B training's launches summed over the ranks, and the
    K5/K6 hold."""
    import paddle_tpu_torch as paddle
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    t0 = time.monotonic()
    ranks = _run_world(_pipe_rank, 8, {}, seed)
    world_s = time.monotonic() - t0
    card = card_line()
    tag = "train gpt3 pipe"
    tr = [r["pipe"] for r in ranks]
    per_layer = 24 // 4
    want_fwd = 2 * per_layer * PIPE_M * PIPE_STEPS   # forward + the replay
    want_bwd = per_layer * PIPE_M * PIPE_STEPS
    for i, res in enumerate(tr):
        la = res["launches"]
        check(res["layers"] == per_layer, f"[{tag}] rank {i} built "
              f"{res['layers']} decoder layers")
        check(la["flash_fwd"] == want_fwd and la["flash_bwd_dq"] == want_bwd
              and la["flash_bwd_dkv"] == want_bwd and la["flash_fwd.tc"] ==
              la["flash_bwd_dq.tc"] == la["flash_bwd_dkv.tc"] == 0
              and la["plain"] == 0, f"[{tag}] rank {i} launches {la}")
        check(all(np.isfinite(res["losses"])) and res["losses"] ==
              tr[0]["losses"], f"[{tag}] rank {i} losses {res['losses']}")
        check(res["losses"][-1] < res["losses"][0],
              f"[{tag}] rank {i}: loss did not fall: {res['losses']}")
        check(all(n > 0 and bad == 0 for n, bad in res["ties"]),
              f"[{tag}] rank {i}: the tied embedding's copies differ "
              f"{res['ties']}")
        check(res["mp_rep"][0] > 0 and res["mp_rep"][1] == 0,
              f"[{tag}] rank {i}: leaves not split over mp differ over mp "
              f"{res['mp_rep']}")
    step_ms = float(np.median([np.median(r["ms"]) for r in tr]))
    busy = [r["busy_ms"] for r in tr]
    wall = max(r["wall_ms"] for r in tr)
    print(f"[{tag}] GPT-3 1.3B L=24 D=2048 H=16 F=8192 V=50304 S={PIPE_S}, "
          "dp1 x mp2 x pp4 on 8 ranks of one card (spawn, fleet.init -> "
          "GPTForCausalLMPipe(num_stages=4) -> fleet.distributed_model -> "
          f"train_batch), {PIPE_M} micro-batches of 1 a step (1F1B), "
          f"remat_stage, fp32 AdamW lr {PIPE_LR}, global-norm clip "
          f"{PIPE_CLIP}: losses {[round(v, 5) for v in tr[0]['losses']]} "
          f"(the first the warm step); bubble (P-1)/(M+P-1) = 3/11 = "
          f"{3 / 11:.4f}; " + "; ".join(
              f"rank {i} (stage {r['coords'][0]}, mp {r['coords'][1]}, "
              f"{r['params'] / 1e6:.1f}M parameters, built in "
              f"{r['build_s']:.1f} s) warm {r['warm_ms']:.0f} ms, step_ms "
              f"{[round(v, 1) for v in r['ms']]}, peak allocated "
              f"{_gib(r['peak'][0]):.3f} GiB reserved "
              f"{_gib(r['peak'][1]):.3f} GiB" for i, r in enumerate(tr))
          + f" (reckoned ~{PIPE_GIB} GiB a rank); this process held "
          f"{_gib(held):.3f} GiB; card {card}", flush=True)
    for i, r in enumerate(tr):
        print(f"[{tag}] rank {i} (stage {r['coords'][0]}, mp "
              f"{r['coords'][1]}) collectives a step (calls, bytes in, host "
              f"ms): {_stats_line(_per_step(r['stats'], PIPE_STEPS))}",
              flush=True)
    la = tr[0]["launches"]
    print(f"[{tag}] step_ms median(median over ranks) {step_ms:.1f}; "
          f"tokens/s {PIPE_M * PIPE_S / step_ms * 1e3:.1f}; the last "
          f"step profiled: wall {wall:.1f} ms, device busy by rank "
          f"{[round(b, 1) for b in busy]} ms (sum {sum(busy):.1f}), card "
          f"idle share {max(0.0, 1 - sum(busy) / wall):.4f}; the tied "
          "embedding's copies bit-equal after the last update (elements, "
          f"differing) {[r['ties'] for r in tr]}; leaves not split over "
          f"mp bit-equal over mp {tr[0]['mp_rep']}; K5/K6 launches a rank "
          f"(fp32: the CUDA-core kernels at [1, {PIPE_S}, 8, 128], row "
          f"stride 3072): flash_fwd {la['flash_fwd']} (tc "
          f"{la['flash_fwd.tc']}), flash_bwd_dq {la['flash_bwd_dq']}, "
          f"flash_bwd_dkv {la['flash_bwd_dkv']}, plain {la['plain']}; "
          f"seconds in the world: pipe {ranks[0]['secs']['pipe']:.1f}, "
          f"parity {ranks[0]['secs']['parity']:.1f}; world {world_s:.1f} s",
          flush=True)
    hold = _pipe_flash_hold(torch, seed)
    print(f"[{tag}] K5/K6 fp32 CUDA-core at [1, {PIPE_S}, 8, 128] row "
          "stride 3072, causal, vs the plain versions: max |d| "
          + ", ".join(f"{k} {v:.3e}" for k, v in hold["errs"].items())
          + f" (allclose at {FLASH_OUT_TOL} out, {FLASH_GRAD_TOL} "
          "gradients); " + "; ".join(
              f"{n} {r['ms']:.4f} ms (device {r['device_ms']:.4f}, "
              f"{r['tflops']:.2f} TFLOP/s) plain {r['plain_ms']:.3f} bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})"
              for n, r in hold.items() if n != "errs")
          + f"; SDPA fp32 forward {hold['flash_fwd']['library_ms']:.4f} ms; "
          f"card {card}", flush=True)

    tag = "train gpt pipe parity"
    t1 = time.monotonic()
    p = [r["parity"] for r in ranks]
    for i, r in enumerate(p):
        check(r["losses"] == p[0]["losses"],
              f"[{tag}] rank {i} losses {r['losses']}")
    ref = _pipe_reference(torch, paddle, seed, ranks)
    _parity_gates(tag, f"GPT-2-small fp32, global B={HYBRID_B} S={HYBRID_S}"
                  f", dp2 x mp2 x pp2 through PipelinedRunner ({PP_PARITY_M} "
                  "micro-batches, remat_stage) on 8 ranks vs the "
                  "single-process raw loop on the card, same numpy weights "
                  f"and batch, SGD lr {PARITY_LR} with the global-norm clip "
                  f"{PIPE_CLIP}", p[0]["losses"], ref,
                  "stage 0 mp rank 1's shard of", card,
                  time.monotonic() - t1)
    launches = {k: sum(r["pipe"]["launches"][k] for r in ranks)
                for k in tr[0]["launches"]}
    return launches, hold


# ---------------------------------------------------------------------------
# compressed dp, the distributed checkpoint and the fused LMCE over a split
# vocabulary (a world of four ranks and one of two): 15zo-15zs
# ---------------------------------------------------------------------------
COMP_STEPS = 5                   # [train gpt compressed]: timed steps
COMP_LR = 1e-4                   # AdamW's rate in the new GPT phases
COMP_CLIP = 1.0                  # the global-norm clip
COMP_PARITY_STEPS = 3            # steps of each compressed parity run
COMP_BITS8_TOL = 0.05            # bits 8 vs exact, the losses (the bound
                                 # of tests/test_dp_compressed.py:130)
COMP_SHARD_RTOL, COMP_SHARD_ATOL = 2e-5, 1e-6   # sharded vs unsharded
                                 # (tests/test_dp_compressed.py:188-205)
COMP_STATE_SHARE = 0.27          # a dp4 rank's optimizer state / unsharded
BIG_LEAF = (50304, 768)          # the word embedding's gradient
LMCE_MP_STEPS = 5                # [train gpt lmce mp]: fused steps, timed
LMCE_MP_PLAIN_STEPS = 3          # the non-fused steps beside them
LMCE_MP_BF16_TOL = 1e-4          # relative: fused vs non-fused step-1 loss,
                                 # bf16 O2 (the logits' rounding, ~2e-6)
CKPT_STEPS = 4                   # [train gpt ckpt]: the first run's steps
CKPT_TOL = 1e-4                  # relative: steps 3-4 resumed in another layout
CKPT_MOMENT_LEAVES = ("gpt.layers.1.mlp.fc1.weight",      # column split
                      "gpt.layers.1.attn.qkv_proj.weight",  # (3, heads, hd)
                      "gpt.embeddings.word_embeddings.weight")  # vocab rows
CONTROL_LEAF = "gpt.layers.1.mlp.fc1.weight"   # the one-ulp controls' leaf


def _gpt2_runner_parts(torch, paddle, cfg, state, hcg, kind="adamw",
                       fused=False, o2=False):
    """GPT-2-small on the card from numpy ``state`` (this rank's mp
    shard), its optimizer and criterion."""
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         enable_fused_lmce,
                                         state_dict_from_jax)
    net = GPTForCausalLM(cfg, device="cuda")
    net.load_state_dict(state_dict_from_jax(
        state, cfg, hcg.get_model_parallel_rank(),
        hcg.get_model_parallel_world_size()))
    clip = paddle.nn.ClipGradByGlobalNorm(COMP_CLIP)
    if kind == "adamw":
        opt = paddle.optimizer.AdamW(learning_rate=COMP_LR,
                                     parameters=net.parameters(),
                                     multi_precision=o2, grad_clip=clip)
    else:
        opt = paddle.optimizer.SGD(learning_rate=PARITY_LR,
                                   parameters=net.parameters(),
                                   grad_clip=clip)
    if o2:
        paddle.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    crit = GPTPretrainingCriterion()
    if fused:
        enable_fused_lmce(net, crit)
    return net, opt, crit


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.vocab_size, (HYBRID_B, HYBRID_S)).astype(np.int64)
    return x, np.roll(x, -1, 1)


def _timed_steps(torch, runner, x, y, n):
    losses, ms = [], []
    for _ in range(n):
        t0 = time.monotonic()
        losses.append(runner.train_step([x], [y]))
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
    return losses, ms


def _params_of(net):
    return {n: p.detach().clone() for n, p in net.named_parameters()}


def _same(a, b):
    """Elements compared and differing between two weight snapshots."""
    n = bad = 0
    for k, v in a.items():
        n += v.numel()
        bad += int((v != b[k]).sum().item())
    return [n, bad]


def _ulp_hook(torch, p):
    """A one-shot gradient hook moving each element of ``p``'s gradient
    one ulp up (the planted control of a bit-equal gate: one element's
    ulp can vanish in the dp sum's rounding, and Adam's first update is
    the gradient's sign, so the control perturbs the whole leaf and the
    gate reads after a later update)."""
    state = {"armed": True}

    def hook(g):
        if not state["armed"]:
            return g
        state["armed"] = False
        return torch.nextafter(g, torch.full_like(g, float("inf")))
    return p.register_hook(hook)


def _compressed_train(torch, paddle, seed):
    """[train gpt compressed] on this rank: dp4 through the strategy, the
    int8 ring and the sharded update, bf16 O2."""
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    fleet = paddle.distributed.fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 4}
    s.quantized_allreduce = 8
    s.sharded_weight_update = True
    s.recompute = True
    s.amp = True
    s.amp_configs = {"use_pure_fp16": True, "use_bf16": True}
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                     recompute=True)
    state = gpt_numpy_state(cfg, seed + 3100)
    net, opt, crit = _gpt2_runner_parts(torch, paddle, cfg, state, hcg,
                                        o2=True)
    runner = fleet.distributed_runner(net, opt, crit)
    check(runner._dp_explicit and runner._update.sharded is not None,
          "[train gpt compressed] the strategy did not reach the runner")
    x, y = _batch(cfg, seed + 3101)
    runner.train_step([x], [y])                 # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_counts()
    comm.reset_counts()
    reg = metrics.registry()
    before = reg.counter("dp_allreduce_bytes_total").collect()
    losses, ms = _timed_steps(torch, runner, x, y, COMP_STEPS)
    launches = _launches(fk)
    stats = comm.comm_stats()
    counted = reg.counter("dp_allreduce_bytes_total").collect() - before
    ratio = reg.gauge("dp_compress_ratio").collect()
    peak = _peaks(torch)
    state_bytes = runner.optimizer_state_bytes()
    replicas = _dist_exercise().replica_diffs(
        [p for _, p in net.named_parameters()],
        hcg.get_data_parallel_group())
    # the replica gate's control: one rank's copy of one weight one ulp off
    leaf = dict(net.named_parameters())[CONTROL_LEAF]
    if hcg.get_data_parallel_rank() == 1:
        with torch.no_grad():
            flat = leaf.view(-1)
            flat[0] = torch.nextafter(flat[0], torch.tensor(
                float("inf"), device=leaf.device, dtype=leaf.dtype))
    control = _dist_exercise().replica_diffs([leaf],
                                             hcg.get_data_parallel_group())
    info = dict(runner._dp_comm_info)
    del runner, opt, net
    torch.cuda.empty_cache()
    # the plain dp4 step's bytes on the same world, fp32 gradients
    plain = _plain_dp4_bytes(torch, paddle, cfg, state, hcg, x, y)
    return {"losses": losses, "ms": ms, "launches": launches,
            "stats": stats, "counted": counted, "info": info, "peak": peak,
            "state_bytes": state_bytes, "replicas": replicas,
            "control": control, "plain": plain, "ratio": ratio}


def _plain_dp4_bytes(torch, paddle, cfg, state, hcg, x, y):
    """One plain dp4 step (bf16 O2, the implicit path): its collective
    bytes a rank and the unsharded optimizer state's bytes."""
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.distributed import communication as comm
    net, opt, crit = _gpt2_runner_parts(torch, paddle, cfg, state, hcg,
                                        o2=True)
    runner = DistributedRunner(net, opt, crit, amp_level="O2")
    runner.train_step([x], [y])
    comm.reset_counts()
    t0 = time.monotonic()
    runner.train_step([x], [y])
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) * 1e3
    out = {"stats": comm.comm_stats(), "ms": ms,
           "state_bytes": runner.optimizer_state_bytes()}
    del runner, opt, net
    torch.cuda.empty_cache()
    return out


def _compressed_parity4(torch, paddle, seed):
    """[train gpt compressed parity] at dp4 on this rank: fp32, bits 8 vs
    the exact plain run; then one int8 all-reduce of a word-embedding
    gradient against the exact sum."""
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.distributed import compressed as C
    from paddle_tpu_torch.distributed.communication import all_reduce
    from paddle_tpu_torch.models import gpt2_small
    hcg = _fleet_init(paddle, {"dp_degree": 4})
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                     recompute=True)
    state = gpt_numpy_state(cfg, seed + 3200)
    x, y = _batch(cfg, seed + 3201)
    out = {}
    for bits in (0, 8):
        net, opt, crit = _gpt2_runner_parts(torch, paddle, cfg, state, hcg)
        runner = DistributedRunner(net, opt, crit, dp_compress_bits=bits)
        seen = _spy_ring(runner) if bits else None
        out[f"losses{bits}"] = [runner.train_step([x], [y])
                                for _ in range(COMP_PARITY_STEPS)]
        if seen:
            out["grads"] = _ring_gate(torch, paddle, hcg, seen)
        del runner, opt, net, seen
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 3202 + 7 * hcg.get_data_parallel_rank())
    g = torch.randn(BIG_LEAF, device="cuda", generator=gen)
    exact = g.clone()
    all_reduce(exact, group=hcg.get_data_parallel_group())
    qgen = torch.Generator(device="cuda")
    qgen.manual_seed(seed + 3203 + hcg.get_data_parallel_rank())
    t0 = time.monotonic()
    got = C.quantized_all_reduce(g, hcg.get_data_parallel_group(), bits=8,
                                 generator=qgen)
    torch.cuda.synchronize()
    ring_ms = (time.monotonic() - t0) * 1e3
    err = got - exact
    q, sc = C._block_quant(exact.reshape(-1), 256, 8, generator=qgen)
    floor = (C._block_dequant(q, sc) - exact.reshape(-1)).abs().mean()
    absmax = g.abs().max()
    all_reduce(absmax, op=paddle.distributed.ReduceOp.MAX,
               group=hcg.get_data_parallel_group())
    step = float(absmax) * 4 / 127
    out["big"] = {"err_mean": float(err.mean()),
                  "err_abs_mean": float(err.abs().mean()),
                  "err_max": float(err.abs().max()), "floor": float(floor),
                  "step": step, "rel": float(err.norm() / exact.norm()),
                  "ms": ring_ms}
    del g, exact, got, err, q, sc
    torch.cuda.empty_cache()
    return out


def _spy_ring(runner):
    """Step 1's gradients of ``runner`` (bits 8, no sharded update) as
    this rank computed them (``local``) and after the int8 ring's dp mean
    (``reduced``), taken around its own update calls."""
    seen = {}
    explicit, step = runner._explicit_update, runner._update.step

    def grads():
        return {n: p.grad.detach().clone() for n, p in runner._update.named
                if p.grad is not None}

    def spy_explicit():
        if "local" not in seen:
            seen["local"] = grads()
        explicit()

    def spy_step(reduce=True):
        if "reduced" not in seen:
            seen["reduced"] = grads()
        step(reduce)

    runner._explicit_update = spy_explicit
    runner._update.step = spy_step
    return seen


def _ring_gate(torch, paddle, hcg, seen):
    """Step 1's int8-ring dp mean of every leaf against the exact one
    (the plain all-reduce of the same local gradients over W): the
    largest error over ``W |g|max / 127`` (W quantizations of at most
    ``W |g|max / 127`` each, over W; ``|g|max`` over every rank), the
    worst leaf; the control leaves this rank's gradient out of the
    ring's mean, which the gate must refuse."""
    from paddle_tpu_torch.distributed.communication import all_reduce
    dp = hcg.get_data_parallel_group()
    w = dp.nranks
    worst, worst_leaf, control, rel = 0.0, None, 0.0, 0.0
    for name, local in seen["local"].items():
        exact = local.clone()
        all_reduce(exact, group=dp)
        exact /= w
        gmax = local.abs().max()
        all_reduce(gmax, op=paddle.distributed.ReduceOp.MAX, group=dp)
        bound = w * float(gmax) / 127
        got = seen["reduced"][name]
        ratio = float((got - exact).abs().max()) / bound if bound else 0.0
        if ratio >= worst:
            worst, worst_leaf = ratio, name
        rel = max(rel, float((got - exact).norm() / exact.norm())
                  if float(exact.norm()) else 0.0)
        if bound:
            control = max(control, float((got - local / w - exact).abs()
                                         .max()) / bound)
    return {"worst": worst, "leaf": worst_leaf, "control": control,
            "rel": rel, "leaves": len(seen["local"])}


def _comp2_rank(workdir, stacks_after, seed):
    """[train gpt compressed parity] at dp2 (a two-rank world): bits 16
    against the plain dp2 path bit for bit, with its one-ulp control; the
    sharded update against the unsharded run."""
    torch, paddle = _rank_setup(stacks_after)
    paddle.distributed.init_parallel_env()
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.models import gpt2_small
    hcg = _fleet_init(paddle, {"dp_degree": 2})
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                     recompute=True)
    state = gpt_numpy_state(cfg, seed + 3300)
    x, y = _batch(cfg, seed + 3301)
    runs, snaps = {}, {}
    leaf = CONTROL_LEAF
    for name, bits, shard, steps, ulp in (
            ("plain", 0, False, COMP_PARITY_STEPS, False),
            ("bits16", 16, False, COMP_PARITY_STEPS, False),
            ("bits16 control", 16, False, 2, True),
            ("bits16 shard", 16, True, COMP_PARITY_STEPS, False)):
        net, opt, crit = _gpt2_runner_parts(torch, paddle, cfg, state, hcg)
        runner = DistributedRunner(net, opt, crit, dp_compress_bits=bits,
                                   dp_shard_update=shard)
        hook = None
        if ulp and hcg.get_data_parallel_rank() == 1:
            hook = _ulp_hook(torch, dict(net.named_parameters())[leaf])
        losses = []
        for i in range(steps):
            losses.append(runner.train_step([x], [y]))
            if name == "plain" and i == 1:
                snaps["plain step 2"] = _params_of(net)
        if hook is not None:
            hook.remove()
        snaps[name] = _params_of(net)
        runs[name] = {"losses": losses}
        del runner, opt, net
        torch.cuda.empty_cache()
    res = {"losses": {k: v["losses"] for k, v in runs.items()},
           "bits16": _same(snaps["plain"], snaps["bits16"]),
           "control": _same(snaps["plain step 2"], snaps["bits16 control"]),
           "shard": max(float(((snaps["bits16 shard"][k] - v).abs()
                               - COMP_SHARD_RTOL * v.abs()).max())
                        for k, v in snaps["plain"].items())}
    _rank_done(workdir, res)


def _lmce_mp_train(torch, paddle, seed):
    """[train gpt lmce mp] on this rank: dp2 x mp2, bf16 O2, the non-fused
    steps then the fused ones from the same weights; rank 0 holds its K7 /
    K8 calls at the path's shape against their plain versions."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_ops
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    from paddle_tpu_torch.ops import lmce_kernel as lk
    dist = paddle.distributed
    fleet = dist.fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    s.recompute = True
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                     recompute=True)
    state = gpt_numpy_state(cfg, seed + 3400)
    x, y = _batch(cfg, seed + 3401)
    n, r = hcg._get_data_group().nranks, hcg._data_rank()
    k = HYBRID_B // n
    xs = paddle.to_tensor(x[r * k:(r + 1) * k])
    ys = paddle.to_tensor(y[r * k:(r + 1) * k])
    out = {}
    for fused, steps in ((False, LMCE_MP_PLAIN_STEPS), (True, LMCE_MP_STEPS)):
        net, opt, crit = _gpt2_runner_parts(torch, paddle, cfg, state, hcg,
                                            fused=fused, o2=True)
        model = fleet.distributed_model(net)
        opt = fleet.distributed_optimizer(opt)

        def step():
            with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
                outs = model(xs)
            loss = crit(outs, ys)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_counts()
        lk.reset_counts()
        losses, ms = [], []
        for _ in range(steps):
            t0 = time.monotonic()
            losses.append(float(step()))
            torch.cuda.synchronize()
            ms.append((time.monotonic() - t0) * 1e3)
        res = {"losses": losses, "ms": ms, "peak": _peaks(torch),
               "flash": _launches(fk),
               "lmce": {f.__name__: f.launches for f in lk.WRAPPERS},
               "lmce_tc": {f.__name__: f.tc_launches
                           for f in lk.TC_WRAPPERS},
               "lmce_plain": sum(f.plain_calls for f in lk.WRAPPERS)}
        if fused:
            # every rank runs the forward (its mp collectives); rank 0
            # holds its K7 / K8 calls
            with torch.no_grad(), paddle.amp.auto_cast(level="O2",
                                                       dtype="bfloat16"):
                hidden = model(xs)
        if fused and dist.get_rank() == 0:
            w = net.lm_weight().detach()
            hidden = getattr(hidden, "_value", hidden)
            h = hidden.detach().reshape(-1, hidden.shape[-1]).to(w.dtype)
            start = hcg.get_model_parallel_rank() * w.shape[0]
            _, _, lab_fwd, lab_bwd = mp_ops._vocab_labels(
                ys._value.reshape(-1).to(h.device), start, w.shape[0])
            tag = (f"lmce mp] [rank 0 h {list(h.shape)} W shard "
                   f"{list(w.shape)} bf16")
            ferrs, fratio = lmce_tc_fwd_compare(torch, lk, tag, h, w,
                                                lab_fwd)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed + 3402)
            g = torch.rand((h.shape[0],), generator=gen, device="cuda")
            berrs, bratios = lmce_tc_compare(torch, lk, tag, h, w, lab_bwd, g,
                                             control=True)
            res["hold"] = {"fwd_errs": ferrs, "fwd_ratio": fratio,
                           "bwd_errs": berrs, "bwd_ratios": bratios,
                           "h": list(h.shape), "w": list(w.shape)}
            del hidden, h, w, g
        out["fused" if fused else "plain"] = res
        del model, opt, net
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _lmce_mp_parity(torch, paddle, seed):
    """[train gpt lmce mp parity] on this rank: fp32 dp1 x mp4 (a 12576-row
    vocab shard a rank) with the fused route; rank 0 then runs the
    single-process fused loop on the same weights and batch."""
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.ops import lmce_kernel as lk
    dist = paddle.distributed
    hcg = _fleet_init(paddle, {"mp_degree": 4})
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    state = gpt_numpy_state(cfg, seed + 3500)
    x, y = _batch(cfg, seed + 3501)
    y[:, ::11] = -100
    net, opt, crit = _gpt2_runner_parts(torch, paddle, cfg, state, hcg,
                                        kind="sgd", fused=True)
    runner = DistributedRunner(net, opt, crit)
    dev = runner._device()
    lk.reset_counts()
    runner._forward_loss(*([torch.from_numpy(a).to(dev)] for a in (x, y))
                         ).backward()
    runner._update.reduce()
    grads = {k: p.grad.float().cpu().numpy()
             for k, p in net.named_parameters()}
    for p in net.parameters():
        p.grad = None
    mp_grads = []
    dist.all_gather_object(mp_grads, grads,
                           group=hcg.get_model_parallel_group())
    del grads
    losses = [runner.train_step([x], [y]) for _ in range(PARITY_STEPS)]
    launches = {f.__name__: f.launches for f in lk.WRAPPERS}
    launches["tc"] = sum(f.tc_launches for f in lk.TC_WRAPPERS)
    launches["plain"] = sum(f.plain_calls for f in lk.WRAPPERS)
    shard = list(net.lm_weight().shape)
    del runner, opt, net
    torch.cuda.empty_cache()
    res = {"losses": losses, "launches": launches, "shard": shard}
    if dist.get_rank() == 0:
        res.update(_fused_reference(torch, paddle, cfg, state, x, y,
                                    mp_grads))
    dist.barrier()
    return res


def _fused_reference(torch, paddle, cfg, state, x, y, mp_grads):
    """The single-process fused loop on the card (the whole model, the
    fp32 CUDA-core K7 / K8): step 1's gradients and ``PARITY_STEPS`` SGD
    losses with the clip; the per-leaf gate of the joined gradients and
    of the planted control (mp rank 1's shard of one leaf scaled by
    ``PARITY_CONTROL``)."""
    import gc
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         enable_fused_lmce,
                                         state_dict_from_jax)
    from paddle_tpu_torch.models.gpt import merge_mp_states
    hcg = collective.get_mesh()
    collective.set_mesh(None)
    try:
        net = GPTForCausalLM(cfg, device="cuda")
        crit = GPTPretrainingCriterion()
    finally:
        collective.set_mesh(hcg)
    net.load_state_dict(state_dict_from_jax(state, cfg))
    enable_fused_lmce(net, crit)
    opt = paddle.optimizer.SGD(
        learning_rate=PARITY_LR, parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(COMP_CLIP))
    xt, yt = (torch.from_numpy(a).cuda() for a in (x, y))
    losses, ref = [], None
    for i in range(PARITY_STEPS):
        loss = crit(net(xt), yt)
        loss.backward()
        if i == 0:
            ref = {n: p.grad.float().cpu().numpy()
                   for n, p in net.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    del net, opt
    gc.collect()
    torch.cuda.empty_cache()
    got = merge_mp_states(mp_grads, cfg)
    ratios = _grad_gate(got, ref)
    leaf = "gpt.embeddings.word_embeddings.weight"
    bad = [dict(g) for g in mp_grads]
    bad[1][leaf] = bad[1][leaf] * PARITY_CONTROL
    control = _grad_gate(merge_mp_states(bad, cfg), ref)[leaf]
    return {"serial_losses": losses, "ratios": ratios, "control": control,
            "control_leaf": leaf}


def _joined_moments(paddle, opt, hcg, cfg):
    """``{"<leaf>.<moment>": numpy}``: AdamW's moments of
    ``CKPT_MOMENT_LEAVES`` joined over the mp group by the model's own
    ``merge_mp_states`` (not the checkpoint's layouts), and under
    ``"control"`` the qkv's moment1 joined as a plain column split."""
    from paddle_tpu_torch.models.gpt import merge_mp_states
    mine = {k: v.cpu().numpy() for k, v in _moments_of(opt).items()}
    parts = []
    paddle.distributed.all_gather_object(
        parts, mine, group=hcg.get_model_parallel_group())
    out = {}
    for k in mine:
        leaf = k.rsplit(".", 1)[0]
        out[k] = merge_mp_states([{leaf: p[k]} for p in parts], cfg)[leaf]
    qkv = f"{CKPT_MOMENT_LEAVES[1]}.moment1"
    out["control"] = np.concatenate([p[qkv] for p in parts], axis=-1)
    return out


def _moments_of(opt):
    st = opt._state
    return {f"{leaf}.{slot}": st[opt._param_names.index(leaf)][slot]
            .detach() for leaf in CKPT_MOMENT_LEAVES
            for slot in ("moment1", "moment2")}


def _moment_diffs(torch, opt, src):
    """``[compared, differing, control differing]``: this optimizer's
    whole moments against the source's joined ones (``src``)."""
    got = _moments_of(opt)
    n = bad = 0
    for k, v in got.items():
        n += v.numel()
        bad += int((v.cpu() != torch.from_numpy(src[k])).sum())
    qkv = got[f"{CKPT_MOMENT_LEAVES[1]}.moment1"].cpu()
    control = int((qkv != torch.from_numpy(src["control"])).sum())
    return [n, bad, control]


def _ckpt_train(torch, paddle, seed, root):
    """[train gpt ckpt] on this rank (a)-(e); returns what this process
    prints and gates, and leaves the step-2 runner state at
    ``root/src`` for (c)."""
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.distributed.checkpoint import (
        CheckpointManager, load_runner_state, save_runner_state)
    from paddle_tpu_torch.distributed.checkpoint.reshard import read_index
    from paddle_tpu_torch.models import gpt2_small
    import warnings
    dist = paddle.distributed
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                     recompute=True)
    state = gpt_numpy_state(cfg, seed + 3600)
    other = gpt_numpy_state(cfg, seed + 3601)
    x, y = _batch(cfg, seed + 3602)
    out = {}
    leaf = CONTROL_LEAF
    with deterministic_algorithms(torch):
        hcg = _fleet_init(paddle, {"dp_degree": 2, "mp_degree": 2})
        net, opt, crit = _gpt2_runner_parts(torch, paddle, cfg, state, hcg)
        runner = DistributedRunner(net, opt, crit)
        mgr = CheckpointManager(os.path.join(root, "mgr"),
                                save_interval_steps=2, max_to_keep=2,
                                async_save=False)
        losses, save_s = [], {}
        for step in range(1, CKPT_STEPS + 1):
            losses.append(runner.train_step([x], [y]))
            if step == 2:
                t0 = time.monotonic()
                save_runner_state(runner, os.path.join(root, "src"))
                save_s["runner"] = time.monotonic() - t0
                src_m = _joined_moments(paddle, opt, hcg, cfg)
                if dist.get_rank() == 0:
                    np.savez(os.path.join(root, "moments.npz"), **src_m)
            t0 = time.monotonic()
            if mgr.save(step, net, opt):
                save_s[f"manager step {step}"] = time.monotonic() - t0
        ref = _params_of(net)
        del runner, opt, net
        torch.cuda.empty_cache()
        out.update(losses=losses, save_s=save_s,
                   mgr_steps=mgr.all_steps(),
                   files=sorted(os.listdir(os.path.join(root, "mgr", "4"))))
        src = os.path.join(root, "src")
        out["bytes"] = os.path.getsize(os.path.join(
            src, f"rank{dist.get_rank()}.pt"))
        out["leaves"] = len(read_index(src)["leaves"])
        # (a) the same layout from other weights: steps 3-4 bit-equal, and
        # the control: one rank's step-3 gradient one ulp off
        for name, ulp in (("same", False), ("same control", True)):
            net, opt, crit = _gpt2_runner_parts(torch, paddle, cfg, other,
                                                hcg)
            runner = DistributedRunner(net, opt, crit)
            t0 = time.monotonic()
            load_runner_state(runner, src)
            out.setdefault("load_s", {})[name] = time.monotonic() - t0
            hook = None
            if ulp and dist.get_rank() == 1:
                hook = _ulp_hook(torch, dict(net.named_parameters())[leaf])
            out[name] = [runner.train_step([x], [y])
                         for _ in range(CKPT_STEPS - 2)]
            if hook is not None:
                hook.remove()
            out[f"{name} weights"] = _same(ref, _params_of(net))
            del runner, opt, net
            torch.cuda.empty_cache()
        del ref
        # (e) the manager: step 4 torn on rank 2's file, restore() -> 2
        dist.barrier()
        if dist.get_rank() == 2:
            victim = os.path.join(root, "mgr", "4", "rank2.pt")
            with open(victim, "r+b") as f:
                f.truncate(os.path.getsize(victim) // 2)
        dist.barrier()
        net, opt, crit = _gpt2_runner_parts(torch, paddle, cfg, other, hcg)
        mgr = CheckpointManager(os.path.join(root, "mgr"), async_save=False)
        out["torn_verified"] = mgr.verify_step(4)
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            out["restored"] = mgr.restore(net, opt)
        runner = DistributedRunner(net, opt, crit)
        out["after_restore"] = runner.train_step([x], [y])
        del runner, opt, net
        torch.cuda.empty_cache()
        # (b) dp4
        hcg = _fleet_init(paddle, {"dp_degree": 4})
        net, opt, crit = _gpt2_runner_parts(torch, paddle, cfg, other, hcg)
        runner = DistributedRunner(net, opt, crit)
        t0 = time.monotonic()
        load_runner_state(runner, src)
        out["load_s"]["dp4"] = time.monotonic() - t0
        out["dp4 moments"] = _moment_diffs(torch, opt, src_m)
        del src_m
        out["dp4"] = [runner.train_step([x], [y]) for _ in range(2)]
        del runner, opt, net
        torch.cuda.empty_cache()
        # (d) dp4 sharded update (exact ring): saved after step 2, resumed
        # bit-identically from other weights; the control one ulp off;
        # then into an unsharded dp4 runner
        shup = os.path.join(root, "shup")
        net, opt, crit = _gpt2_runner_parts(torch, paddle, cfg, state, hcg)
        runner = DistributedRunner(net, opt, crit, dp_compress_bits=16,
                                   dp_shard_update=True)
        out["shard_losses"] = [runner.train_step([x], [y]) for _ in range(2)]
        save_runner_state(runner, shup)
        slices = {k: v for k, v in opt.state_dict().items()
                  if k == f"{leaf}.moment1"}
        out["shard_losses"].append(runner.train_step([x], [y]))
        ref = _params_of(net)
        out["shard_state_bytes"] = runner.optimizer_state_bytes()
        del runner, opt, net
        torch.cuda.empty_cache()
        for name, ulp in (("shard", False), ("shard control", True)):
            net, opt, crit = _gpt2_runner_parts(torch, paddle, cfg, other,
                                                hcg)
            runner = DistributedRunner(net, opt, crit, dp_compress_bits=16,
                                       dp_shard_update=True)
            load_runner_state(runner, shup)
            hook = None
            if ulp and dist.get_rank() == 1:
                hook = _ulp_hook(torch, dict(net.named_parameters())[leaf])
            out[f"{name} resumed"] = runner.train_step([x], [y])
            if hook is not None:
                hook.remove()
            out[f"{name} weights"] = _same(ref, _params_of(net))
            del runner, opt, net
            torch.cuda.empty_cache()
        del ref
        net, opt, crit = _gpt2_runner_parts(torch, paddle, cfg, other, hcg)
        runner = DistributedRunner(net, opt, crit)
        load_runner_state(runner, shup)
        whole = opt.state_dict()[f"{leaf}.moment1"].reshape(-1)
        local = slices[f"{leaf}.moment1"].local
        mine, span = hcg.get_data_parallel_rank(), local.numel()
        out["unsharded_slice_equal"] = bool(torch.equal(
            whole[mine * span:(mine + 1) * span], local))
        out["unsharded_state_bytes"] = runner.optimizer_state_bytes()
        del runner, opt, net
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _comp_rank(workdir, stacks_after, seed, root):
    torch, paddle = _rank_setup(stacks_after)
    paddle.distributed.init_parallel_env()
    res, secs = {}, {}
    for name, fn in (("compressed", _compressed_train),
                     ("compressed_parity", _compressed_parity4),
                     ("lmce_mp", _lmce_mp_train),
                     ("lmce_mp_parity", _lmce_mp_parity)):
        t0 = time.monotonic()
        res[name] = fn(torch, paddle, seed)
        secs[name] = time.monotonic() - t0
    t0 = time.monotonic()
    res["ckpt"] = _ckpt_train(torch, paddle, seed, root)
    secs["ckpt"] = time.monotonic() - t0
    res["secs"] = secs
    _rank_done(workdir, res)


def _ckpt_one_process(torch, paddle, seed, root):
    """(c): this process (no world) loads the dp2 x mp2 runner state,
    holds its moments against the source's joined ones and runs steps 3
    and 4."""
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.distributed.checkpoint import load_runner_state
    from paddle_tpu_torch.distributed.fleet.base import topology as ttopo
    from paddle_tpu_torch.models import gpt2_small
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                     recompute=True)
    hcg = ttopo.HybridCommunicateGroup(ttopo.CommunicateTopology(
        dims=[1, 1, 1, 1, 1]), 0)
    with deterministic_algorithms(torch):
        net, opt, crit = _gpt2_runner_parts(
            torch, paddle, cfg, gpt_numpy_state(cfg, seed + 3601), hcg)
        runner = DistributedRunner(net, opt, crit, mesh=hcg)
        t0 = time.monotonic()
        load_runner_state(runner, os.path.join(root, "src"))
        load_s = time.monotonic() - t0
        with np.load(os.path.join(root, "moments.npz")) as f:
            moments = _moment_diffs(torch, opt, dict(f))
        x, y = _batch(cfg, seed + 3602)
        losses = [runner.train_step([x], [y]) for _ in range(2)]
        step = opt._global_step
    del runner, opt, net
    torch.cuda.empty_cache()
    return {"losses": losses, "load_s": load_s, "step": step,
            "moments": moments}


def compressed_world_phase(torch, seed):
    """``[train gpt compressed]``, its parity, ``[train gpt lmce mp]``, its
    parity and ``[train gpt ckpt]`` (module docstring, 15zo-15zs): a world
    of four ranks on the one card for all but the dp2 parity, which runs
    in a world of two; then (c) in this process.  Returns the launches
    for the kernels line."""
    import shutil
    import tempfile
    import paddle_tpu_torch as paddle
    root = tempfile.mkdtemp(prefix="chip_ckpt_")
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    t0 = time.monotonic()
    ranks = _run_world(_comp_rank, 4, env, seed, root)
    world_s = time.monotonic() - t0
    t0 = time.monotonic()
    pair = _run_world(_comp2_rank, 2, env, seed)
    pair_s = time.monotonic() - t0
    t0 = time.monotonic()
    one = _ckpt_one_process(torch, paddle, seed, root)
    one_s = time.monotonic() - t0
    shutil.rmtree(root)
    card = card_line()
    secs = ranks[0]["secs"]

    tag = "train gpt compressed"
    tr = [r["compressed"] for r in ranks]
    for i, res in enumerate(tr):
        la = res["launches"]
        check(all(np.isfinite(res["losses"])) and res["losses"] ==
              tr[0]["losses"], f"[{tag}] rank {i} losses {res['losses']}")
        check(res["losses"][-1] < res["losses"][0],
              f"[{tag}] rank {i}: loss did not fall: {res['losses']}")
        check(res["replicas"][0] > 0 and res["replicas"][1] == 0,
              f"[{tag}] rank {i}: weights differ over the four ranks "
              f"(compared, differing) {res['replicas']}")
        check(res["control"][1] > 0, f"[{tag}] rank {i}: the replica gate "
              f"misses one rank's weight one ulp off {res['control']}")
        check(la["flash_fwd"] == la["flash_fwd.tc"] > 0
              and la["flash_bwd_dq"] == la["flash_bwd_dq.tc"] > 0
              and la["flash_bwd_dkv"] == la["flash_bwd_dkv.tc"] > 0
              and la["plain"] == 0, f"[{tag}] rank {i} launches {la}")
        share = res["state_bytes"] / res["plain"]["state_bytes"]
        check(share <= COMP_STATE_SHARE, f"[{tag}] rank {i}: optimizer "
              f"state {share:.4f} of the unsharded state")
    r0 = tr[0]
    per = _per_step(r0["stats"], COMP_STEPS)
    sent = per.get("send", {}).get("bytes", 0.0)
    gathered = per.get("all_gather", {}).get("bytes", 0.0) * 3
    plain = _per_step(r0["plain"]["stats"], 1)
    plain_bytes = sum(v["bytes"] for v in plain.values())
    print(f"[{tag}] GPT-2-small L=12 D=768 H=12 V=50304 global B={HYBRID_B} "
          f"S={HYBRID_S}, dp4 on 4 ranks of one card through fleet.init "
          "(quantized_allreduce=8, sharded_weight_update=True, amp O2 bf16, "
          f"recompute) -> fleet.distributed_runner, AdamW lr {COMP_LR} with "
          f"the global-norm clip {COMP_CLIP}, one warm step and "
          f"{COMP_STEPS} timed: losses "
          f"{[round(v, 5) for v in r0['losses']]}; " + "; ".join(
              f"rank {i} step_ms {[round(v, 1) for v in r['ms']]} optimizer "
              f"state {r['state_bytes'] / 2**20:.1f} MiB "
              f"({r['state_bytes'] / r['plain']['state_bytes']:.4f} of the "
              f"unsharded {r['plain']['state_bytes'] / 2**20:.1f} MiB) peak "
              f"allocated {_gib(r['peak'][0]):.3f} GiB reserved "
              f"{_gib(r['peak'][1]):.3f} GiB" for i, r in enumerate(tr))
          + f"; weights bit-equal over the four ranks after the last step "
          f"({r0['replicas'][0]} elements), the control (one rank's copy of "
          f"one weight one ulp off) differs in {r0['control'][1]}; card "
          f"{card}", flush=True)
    print(f"[{tag}] step_ms median(steps 3+, median over ranks) "
          f"{np.median([np.median(r['ms'][2:]) for r in tr]):.1f} (the plain "
          f"dp4 step on the same world {r0['plain']['ms']:.1f} ms); dp bytes "
          f"a rank a step, measured by comm_stats: the int8 ring's sends "
          f"{sent:.0f} + the exact all-gather's ring-equivalent sends "
          f"{gathered:.0f} = {sent + gathered:.0f} bytes (its bf16 "
          "parameters) beside the byte model's dp_comm_bytes_per_step "
          f"{r0['info']['bytes_per_step']} (32-bit gather) and "
          f"dp_allreduce_bytes_total's {r0['counted'] / COMP_STEPS:.0f} a "
          f"step; the plain dp4 step's collectives {plain_bytes:.0f} bytes "
          f"in ({_stats_line(plain)}); dp_compress_ratio {r0['ratio']:.4f};"
          f" collectives a step on rank 0 (calls, bytes in, host ms): "
          f"{_stats_line(per)}; K5/K6 a rank at [2, 1024, 12, 64] bf16: "
          f"flash_fwd {r0['launches']['flash_fwd']} (tc "
          f"{r0['launches']['flash_fwd.tc']}), flash_bwd_dq "
          f"{r0['launches']['flash_bwd_dq']}, flash_bwd_dkv "
          f"{r0['launches']['flash_bwd_dkv']}; seconds "
          f"{secs['compressed']:.1f}", flush=True)

    tag = "train gpt compressed parity"
    p = [r["compressed_parity"] for r in ranks]
    for i, r in enumerate(p):
        check(r["losses8"] == p[0]["losses8"] and r["losses0"] ==
              p[0]["losses0"], f"[{tag}] rank {i} losses differ")
        big = r["big"]
        check(big["err_abs_mean"] < 3 * big["floor"] and big["err_max"] <
              4 * big["step"] and abs(big["err_mean"]) < 0.05 * big["step"],
              f"[{tag}] rank {i}: the int8 all-reduce of {BIG_LEAF} {big}")
    l8, l0 = p[0]["losses8"], p[0]["losses0"]
    check(l8[0] == l0[0] and all(abs(a - b) < COMP_BITS8_TOL
                                 for a, b in zip(l8, l0)),
          f"[{tag}] dp4 bits 8 losses {l8} vs the exact run's {l0}")
    for i, r in enumerate(p):
        gr = r["grads"]
        check(gr["leaves"] > 0 and gr["worst"] <= 1.0, f"[{tag}] rank {i}: "
              f"the int8 ring's step-1 gradient of {gr['leaf']} parts from "
              f"the exact dp mean by {gr['worst']:.3f} of its bound")
        check(gr["control"] > 1.0, f"[{tag}] rank {i}: the control (this "
              f"rank's gradient left out) passes the ring gate {gr}")
    q = [r for r in pair]
    for i, r in enumerate(q):
        n, bad = r["bits16"]
        check(n > 0 and bad == 0 and r["losses"]["bits16"] ==
              r["losses"]["plain"], f"[{tag}] dp2 rank {i}: bits 16 is not "
              f"the plain path: {r['bits16']} {r['losses']}")
        check(r["control"][1] > 0, f"[{tag}] dp2 rank {i}: the one-ulp "
              f"control passes {r['control']}")
        check(r["shard"] <= COMP_SHARD_ATOL, f"[{tag}] dp2 rank {i}: the "
              f"sharded update parts from the unsharded by {r['shard']}")
    big = p[0]["big"]
    print(f"[{tag}] GPT-2-small fp32, global B={HYBRID_B} S={HYBRID_S}, "
          f"AdamW lr {COMP_LR} with the clip, {COMP_PARITY_STEPS} steps: "
          f"dp2 (a two-rank world) bits 16 losses "
          f"{[round(v, 6) for v in q[0]['losses']['bits16']]} equal to the "
          f"plain dp2 path's, every weight bit-equal "
          f"({q[0]['bits16'][0]} elements, differing {q[0]['bits16'][1]}); "
          f"control (rank 1's step-1 gradient of one leaf one ulp up, read "
          f"after step 2) differs in {q[0]['control'][1]}; dp2 bits 16 with the sharded "
          f"update within rtol {COMP_SHARD_RTOL} + atol "
          f"(|d| - rtol |ref| reaches {q[0]['shard']:.3e} <= "
          f"{COMP_SHARD_ATOL}); dp4 bits 8 losses {p[0]['losses8']} vs "
          f"exact {p[0]['losses0']} (step 1 equal, each within "
          f"{COMP_BITS8_TOL}); step 1's gradients after the int8 ring vs "
          f"the exact dp mean, {p[0]['grads']['leaves']} leaves: worst "
          f"{max(r['grads']['worst'] for r in p):.4f} of the ring's bound "
          f"W |g|max / 127, W = 4 ({p[0]['grads']['leaf']} on rank 0), largest "
          f"relative norm {max(r['grads']['rel'] for r in p):.3e}; the "
          f"control (a rank's own gradient left out of the mean) reaches "
          f"{min(r['grads']['control'] for r in p):.3f} of the bound (the "
          f"least over ranks, > 1 fails); one int8 all-reduce of a {BIG_LEAF} fp32 "
          f"leaf over dp4: mean error {big['err_mean']:.3e} (|.| < 0.05 "
          f"step = {0.05 * big['step']:.3e}), mean |error| "
          f"{big['err_abs_mean']:.3e} (< 3 x the one-quantization floor "
          f"{big['floor']:.3e}), max |error| {big['err_max']:.3e} (< 4 step "
          f"= {4 * big['step']:.3e}), relative norm {big['rel']:.3e}, "
          f"{big['ms']:.1f} ms; seconds {secs['compressed_parity']:.1f} + "
          f"the dp2 world {pair_s:.1f}; card {card}", flush=True)

    tag = "train gpt lmce mp"
    lm = [r["lmce_mp"] for r in ranks]
    for i, r in enumerate(lm):
        f, pl = r["fused"], r["plain"]
        want = {k: LMCE_MP_STEPS for k in ("lmce_fwd", "lmce_bwd_dh",
                                           "lmce_bwd_dw")}
        check(f["lmce"] == want and f["lmce_tc"] == want and
              f["lmce_plain"] == 0, f"[{tag}] rank {i}: K7/K8 launches "
              f"{f['lmce']} tc {f['lmce_tc']} plain {f['lmce_plain']}")
        check(pl["lmce"] == {k: 0 for k in want},
              f"[{tag}] rank {i}: the non-fused run launched K7/K8")
        check(f["losses"][-1] < f["losses"][0],
              f"[{tag}] rank {i}: loss did not fall {f['losses']}")
        rel = abs(f["losses"][0] - pl["losses"][0]) / abs(pl["losses"][0])
        check(rel <= LMCE_MP_BF16_TOL, f"[{tag}] rank {i}: step 1 fused "
              f"{f['losses'][0]} vs non-fused {pl['losses'][0]}")
    hold = lm[0]["fused"]["hold"]
    f0, p0 = lm[0]["fused"], lm[0]["plain"]
    print(f"[{tag}] GPT-2-small, dp2 x mp2 on 4 ranks (fleet.init -> "
          "distributed_model -> distributed_optimizer, bf16 O2, recompute), "
          f"enable_fused_lmce, AdamW lr {COMP_LR} with the clip, "
          f"{LMCE_MP_STEPS} steps: losses {[round(v, 5) for v in f0['losses']]}"
          f" (step 1 vs the non-fused step on the same weights and batch "
          f"{p0['losses'][0]:.5f}: relative "
          f"{abs(f0['losses'][0] - p0['losses'][0]) / p0['losses'][0]:.3e}, "
          f"tol {LMCE_MP_BF16_TOL}); step_ms fused by rank "
          f"{[[round(v, 1) for v in r['fused']['ms']] for r in lm]} vs "
          f"non-fused {[[round(v, 1) for v in r['plain']['ms']] for r in lm]}"
          f"; peak allocated fused "
          f"{[round(_gib(r['fused']['peak'][0]), 3) for r in lm]} GiB vs "
          f"non-fused {[round(_gib(r['plain']['peak'][0]), 3) for r in lm]} "
          f"GiB; K7/K8 a rank {f0['lmce']} (tensor-core {f0['lmce_tc']}) "
          f"on h [4096, 768] x W [25152, 768]; rank 0's calls held at "
          f"h {hold['h']} W {hold['w']} bf16 against their plain versions: "
          f"forward gate ratio {hold['fwd_ratio']:.3e}, errors "
          f"{ {k: f'{v:.3e}' for k, v in hold['fwd_errs'].items()} }, "
          f"backward gate ratios "
          f"{ {k: f'{v:.3e}' for k, v in hold['bwd_ratios'].items()} } "
          f"(<= 1, the S-free control fails); seconds {secs['lmce_mp']:.1f};"
          f" card {card}", flush=True)

    tag = "train gpt lmce mp parity"
    mp = [r["lmce_mp_parity"] for r in ranks]
    for i, r in enumerate(mp):
        check(r["losses"] == mp[0]["losses"], f"[{tag}] rank {i} losses")
        la = r["launches"]
        check(la["lmce_fwd"] == la["lmce_bwd_dh"] == la["lmce_bwd_dw"] ==
              PARITY_STEPS + 1 and la["tc"] == 0 and la["plain"] == 0,
              f"[{tag}] rank {i} launches {la}")
        check(r["shard"] == [12576, 768], f"[{tag}] shard {r['shard']}")
    _parity_gates(tag, "GPT-2-small fp32 with enable_fused_lmce, dp1 x mp4 "
                  "(a [12576, 768] vocab shard a rank, the CUDA-core K7/K8, "
                  f"{mp[0]['launches']['lmce_fwd']} forward launches a "
                  "rank) through DistributedRunner vs the single-process "
                  "fused loop on the card, same numpy weights and batch "
                  f"(every 11th label -100), SGD lr {PARITY_LR} with the "
                  "clip", mp[0]["losses"], mp[0], "mp rank 1's shard of",
                  card, None)

    tag = "train gpt ckpt"
    ck = [r["ckpt"] for r in ranks]
    c0 = ck[0]
    ref3 = c0["losses"][2]
    ref34 = c0["losses"][2:]

    def resumed(got):
        return len(got) == 2 and all(abs(a - b) <= CKPT_TOL * abs(b)
                                     for a, b in zip(got, ref34))

    def moments_ok(m):
        return m[0] > 0 and m[1] == 0 and m[2] > 0

    for i, r in enumerate(ck):
        check(r["losses"] == c0["losses"], f"[{tag}] rank {i} losses")
        check(r["same"] == r["losses"][2:] and r["same weights"][1] == 0
              and r["same weights"][0] > 0, f"[{tag}] rank {i} (a): "
              f"{r['same']} vs {r['losses'][2:]}, weights {r['same weights']}")
        check(r["same control weights"][1] > 0, f"[{tag}] rank {i} (a): the "
              f"one-ulp control passes {r['same control weights']}")
        check(resumed(r["dp4"]), f"[{tag}] rank {i} (b): dp4 steps 3-4 "
              f"{r['dp4']} vs {ref34}")
        check(moments_ok(r["dp4 moments"]), f"[{tag}] rank {i} (b): the "
              "moments (compared, differing, control differing) "
              f"{r['dp4 moments']}")
        check(r["shard resumed"] == r["shard_losses"][2] and
              r["shard weights"][1] == 0, f"[{tag}] rank {i} (d): "
              f"{r['shard resumed']} vs {r['shard_losses'][2]}, weights "
              f"{r['shard weights']}")
        check(r["shard control weights"][1] > 0, f"[{tag}] rank {i} (d): "
              f"the one-ulp control passes {r['shard control weights']}")
        check(r["unsharded_slice_equal"], f"[{tag}] rank {i} (d): the "
              "unsharded runner's moment is not the chunks joined")
        check(not r["torn_verified"] and r["restored"] == 2 and
              r["after_restore"] == ref3, f"[{tag}] rank {i} (e): verified "
              f"{r['torn_verified']}, restored {r['restored']}, step 3 "
              f"{r['after_restore']}")
        check(r["mgr_steps"] == [2, 4], f"[{tag}] manager steps "
              f"{r['mgr_steps']}")
    check(resumed(one["losses"]) and one["step"] == 4 and
          moments_ok(one["moments"]), f"[{tag}] (c): one process's steps "
          f"3-4 {one['losses']} vs {ref34}, moments {one['moments']}")
    print(f"[{tag}] GPT-2-small fp32, global B={HYBRID_B} S={HYBRID_S}, "
          f"dp2 x mp2 AdamW lr {COMP_LR} with the clip, {CKPT_STEPS} steps "
          f"(losses {[round(v, 6) for v in c0['losses']]}), "
          "save_runner_state after step 2, CheckpointManager(save_interval_"
          "steps=2, max_to_keep=2) at every step (kept "
          f"{c0['mgr_steps']}; step 4's files {c0['files']}), under "
          "torch.use_deterministic_algorithms: (a) dp2 x mp2 from other "
          f"weights loads step 2, steps 3-4 {c0['same']} bit-equal, every "
          f"weight ({c0['same weights'][0]} elements) bit-equal, the one-ulp "
          f"control differs in {c0['same control weights'][1]}; the moments "
          f"of {list(CKPT_MOMENT_LEAVES)} loaded at dp4 and in one process "
          f"against the source's joined over mp by merge_mp_states (compared,"
          f" differing, the control's differing) {c0['dp4 moments']} and "
          f"{one['moments']}; steps 3-4 (b) dp4 {c0['dp4']}, (c) one "
          f"process {one['losses']} (vs {ref34}, tol {CKPT_TOL} relative); "
          "(d) dp4 sharded update "
          f"(exact ring) saved after step 2 resumes step 3 "
          f"{c0['shard resumed']:.6f} = {c0['shard_losses'][2]:.6f}, every "
          "weight bit-equal, the control differs in "
          f"{c0['shard control weights'][1]}, optimizer state "
          f"{c0['shard_state_bytes'] / 2**20:.1f} MiB a rank, loaded into an "
          f"unsharded dp4 runner ({c0['unsharded_state_bytes'] / 2**20:.1f} "
          "MiB) whose moments are the chunks joined; (e) step 4 with rank "
          f"2's file truncated: verify_step {c0['torn_verified']}, restore() "
          f"-> {c0['restored']}, step 3 {c0['after_restore']:.6f}; runner "
          f"state: bytes written by rank "
          f"{[r['bytes'] for r in ck]}, index {c0['leaves']} leaves, save "
          f"seconds {c0['save_s']}, load seconds by rank 0 "
          f"{ {k: round(v, 2) for k, v in c0['load_s'].items()} } and in "
          f"one process {one['load_s']:.2f}; seconds {secs['ckpt']:.1f} + "
          f"(c) {one_s:.1f}; card {card}", flush=True)
    print(f"[dist worlds] compressed / lmce mp / ckpt world {world_s:.1f} s "
          f"(by phase {', '.join(f'{k} {v:.1f}' for k, v in secs.items())}), "
          f"dp2 world {pair_s:.1f} s", flush=True)
    return {"compressed": {k: sum(r["compressed"]["launches"][k]
                                  for r in ranks)
                           for k in r0["launches"]},
            "lmce_mp": {"flash": {k: sum(r["lmce_mp"]["fused"]["flash"][k]
                                         for r in ranks)
                                  for k in f0["flash"]},
                        "lmce": {k: sum(r["lmce_mp"]["fused"]["lmce"][k]
                                        for r in ranks)
                                 for k in f0["lmce"]},
                        "hold": hold},
            "lmce_mp_fp32": {k: sum(r["lmce_mp_parity"]["launches"][k]
                                    for r in ranks)
                             for k in ("lmce_fwd", "lmce_bwd_dh",
                                       "lmce_bwd_dw")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    from paddle_tpu_torch import _build

    card = card_line()
    print(f"[env] card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    built = _build.build_all()
    build_s = time.monotonic() - t0
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; kernels built in "
          f"{build_s:.2f} s: {sorted(built)}; ml_dtypes (reads the JAX "
          f"package's bf16 checkpoints) "
          f"{'present' if importlib.util.find_spec('ml_dtypes') else 'absent'}",
          flush=True)
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    kres = kernel_phase(torch, args.seed,
                        built.get("paged_attention_sm90", {}).get("log", ""))
    klong = kernel_long_phase(torch, args.seed)
    fres = flash_phase(torch, args.seed)
    lres = lmce_phase(torch, args.seed)
    s32 = serving_phase(torch, args.seed, torch.float32, "fp32", True)
    s16 = serving_phase(torch, args.seed, torch.bfloat16, "bf16", False)
    serve_prefill_capture_phase(torch, args.seed, torch.float32, "fp32")
    serve_prefill_capture_phase(torch, args.seed, torch.bfloat16, "bf16")
    serve_poll_phase(torch, args.seed, s32)
    sp32 = serve_spec_phase(torch, args.seed, torch.float32, "fp32", s32)
    sp16 = serve_spec_phase(torch, args.seed, torch.bfloat16, "bf16", s16)
    serve_refresh_phase(torch, args.seed)
    serve_noise_phase(torch, args.seed)
    slong = serve_long_phase(torch, args.seed)
    serve_prefix_phase(torch, args.seed)
    cgap = chunk_gap_phase(torch, args.seed)
    sd32 = serve_disagg_phase(torch, args.seed, torch.float32, "fp32", s32)
    sd16 = serve_disagg_phase(torch, args.seed, torch.bfloat16, "bf16", s16)
    disagg_gap_phase(torch, args.seed, cgap)
    serve_router_phase(torch, args.seed, s32)
    tres = train_phase(torch, args.seed)
    eager = train_eager_phase(torch, args.seed, tres)
    train_fold_phase(torch, args.seed)
    lmce_train = fused_train_phase(torch, args.seed, tres)
    fp16_train = fp16_train_phase(torch, args.seed, tres)
    fp32_lmce = train_parity_phase(torch, args.seed)
    bhres = flash_bh_phase(torch, args.seed)
    tcres = flash_tc_phase(torch, args.seed,
                           built.get("flash_fwd_sm90", {}).get("log", ""))
    tcb = flash_tc_bwd_phase(torch, args.seed,
                             built.get("flash_bwd_sm90", {}).get("log", ""))
    tcf = flash_tc_fused_phase(torch, args.seed,
                               built.get("flash_bwd_sm90", {}).get("log", ""))
    ltc = lmce_tc_phase(torch, args.seed,
                        built.get("lmce_sm90", {}).get("log", ""))
    ltf = lmce_tc_fwd_phase(torch, args.seed,
                            built.get("lmce_fwd_sm90", {}).get("log", ""))
    f16 = fp16_phase(torch, args.seed)
    hd = headdim_phase(torch, args.seed)
    bh_train = bh_train_phase(torch, args.seed, tres)
    ernie_train = ernie_train_phase(torch, args.seed)
    bh_parity_phase(torch, args.seed)
    train_fold_phase(torch, args.seed, bh=True)
    fold_parity_phase(torch, args.seed)
    train_resnet50_phase(torch, args.seed)
    train_resnet_parity_phase(torch, args.seed)
    vision_zoo_phase(torch, args.seed)
    train_vit_phase(torch, args.seed)
    train_vit_l_phase(torch, args.seed)
    _, det_net, det_data = train_ppyoloe_phase(torch, args.seed)
    detect_eval_phase(torch, args.seed, det_net, det_data)
    del det_net, det_data
    train_lenet_phase(torch, args.seed)
    train_resnet50_fit_phase(torch, args.seed)
    esched = ernie_sched_phase(torch, args.seed, ernie_train)
    escaler = ernie_scaler_phase(torch, args.seed, esched)
    optimizers_phase(torch, args.seed)
    train_transformer_phase(torch, args.seed)
    train_transformer_parity_phase(torch, args.seed)
    translate_greedy_phase(torch, args.seed)
    train_crnn_phase(torch, args.seed)
    rnn_phase(torch, args.seed)
    nn_layers_phase(torch, args.seed)
    train_cyclegan_phase(torch, args.seed)
    train_cyclegan_parity_phase(torch, args.seed)
    train_r2plus1d_phase(torch, args.seed)
    train_r2plus1d_parity_phase(torch, args.seed)
    train_widedeep_phase(torch, args.seed)
    train_widedeep_parity_phase(torch, args.seed)
    o1 = train_gpt_o1_phase(torch, args.seed)
    tensor_ops_phase(torch, args.seed)
    tensor_flash_phase(torch, args.seed)
    dyg = train_gpt_dygraph_phase(torch, args.seed, eager)
    dist_nccl_phase(torch, args.seed)
    hyb = hybrid_world_phase(torch, args.seed)
    t0 = time.monotonic()
    shard = world4_phase(torch, args.seed)
    t1 = time.monotonic()
    pipe, pipe_hold = pipe_world_phase(torch, args.seed)
    print(f"[dist worlds] seconds: ERNIE sharding + cp world {t1 - t0:.1f}, "
          f"pipeline world with its reference and hold "
          f"{time.monotonic() - t1:.1f}", flush=True)
    comp = compressed_world_phase(torch, args.seed)

    k32, k16 = kres["fp32"], kres["bf16"]
    kernels = [{
        "name": "paged_ragged_attention", "route": "cuda",
        "source": K1_SOURCE, "cuda_core_source": K1_CORE_SOURCE,
        "replaces": K1_REPLACES,
        "launches": s32["launches"], "max_abs_err": k32["max_abs_err"],
        "ms": k32["ms"], "device_ms": k32["device_ms"],
        "plain_ms": k32["plain_ms"], "bound_ms": k32["bound_ms"],
        "bound_by": k32["bound_by"], "library_ms": k32["library_ms"],
        "library_device_ms": k32["library_device_ms"],
        "cuda_core_ms": k32["cuda_core_ms"],
        "cuda_core_device_ms": k32["cuda_core_device_ms"],
        "host_us": k32["host_us"],
        "cuda_core_host_us": k32["cuda_core_host_us"],
        "plan": list(k32["plan"]), "bf16_plan": list(k16["plan"]),
        "verify_plans": {dn: list(kres[f"{dn} verify"]["plan"])
                         for dn in ("fp32", "bf16")},
        "verify_max_abs_err": {dn: kres[f"{dn} verify"]["max_abs_err"]
                               for dn in ("fp32", "bf16", "fp16")},
        "bf16_ms": k16["ms"], "bf16_device_ms": k16["device_ms"],
        "bf16_bound_ms": k16["bound_ms"],
        "bf16_cuda_core_device_ms": k16["cuda_core_device_ms"],
        "bf16_library_device_ms": k16["library_device_ms"],
        "bf16_max_abs_err": k16["max_abs_err"],
        "bf16_launches": s16["launches"],
        "launches_counted": "per replay of the captured decode step",
        "serving_dispatches": s32["dispatches"],
        "bf16_serving_dispatches": s16["dispatches"],
        "long_engine": {"device_ms": slong["k1_device_ms"],
                        "launches_per_dispatch":
                        slong["launches_per_dispatch"],
                        "shape": f"B=2, BS={LONG_BS}, one request at "
                                 f"{LONG_PROMPT}-{LONG_PROMPT + 17} "
                                 "tokens, bf16, in the engine's graph"},
        "cuda_core_serving_launches": s32["core_launches"]
        + s16["core_launches"],
        "disagg_launches": sd32["launches"] + sd16["launches"],
        "disagg_dispatches": sd32["dispatches"] + sd16["dispatches"],
        "spec_launches": sum(r["launches"] for r in
                             list(sp32.values()) + list(sp16.values())),
        "spec_launches_per_dispatch": sp32["self"]["launches_per_dispatch"],
        "spec": {f"{t} {d}": {
            "launches": r["launches"], "dispatches": r["dispatches"],
            "tokens_per_s": r["tokens_per_s"],
            "tokens_per_dispatch": r["tokens_per_dispatch"],
            "accept_rate": r["accept_rate"],
            "busy_ms_a_dispatch": r["profile"]["busy_ms"],
            "k1_draft_device_ms": r["profile"]["k1_ms"],
            "k1_verify_device_ms": r["profile"]["k1_verify_ms"],
            "capture_s": r["capture_s"], "graph_pool_bytes": r["pool"]}
            for t, res in (("fp32", sp32), ("bf16", sp16))
            for d, r in res.items()},
        "plain_busy_ms_a_dispatch": {"fp32": s32["profile"]["busy_ms"],
                                     "bf16": s16["profile"]["busy_ms"]},
        "gate_ratio": max(r["gate_ratio"] for r in
                          list(kres.values()) + list(klong.values())),
        "equal_share": min(r["equal_share"] for k, r in
                           list(kres.items()) + list(klong.items())
                           if not k.startswith("fp32")),
        "fp16_max_abs_err": max(kres["fp16"]["max_abs_err"],
                                f16["paged_ragged_attention"]),
        "dh16_max_abs_err": max(v for k, v in hd.items()
                                if k.startswith("paged")),
        "long": {k: {x: (list(r[x]) if x == "plan" else r[x])
                     for x in ("device_ms", "ms", "cuda_core_device_ms",
                               "cuda_core_ms", "plain_ms", "bound_ms",
                               "library_ms", "library_device_ms",
                               "tb_per_s", "max_abs_err", "plan")
                     if x in r}
                 for k, r in klong.items()},
    }]
    for name in FLASH_KERNELS:
        r = fres[name]
        kernels.append({
            "name": name, "route": "cuda", "source": CORE_SOURCE,
            "replaces": FLASH_REPLACES[name],
            "launches": tres["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "fp32_max_abs_err": max(fres["fp32"].values()),
        })
    for name in BH_KERNELS:
        r, e = bhres[name]["gpt"], bhres[name]["ernie"]
        errs = ("out", "lse") if name == "flash_fwd_hpack" else \
            ("dq", "dk", "dv")
        fwd = name == "flash_fwd_hpack"
        kernels.append({
            "name": name, "route": "cuda", "source": CORE_SOURCE,
            "replaces": FLASH_REPLACES[name],
            "launches": (bh_train["launches"][name]
                         + ernie_train["launches"][name]),
            "gpt_launches": bh_train["launches"][name],
            "ernie_launches": ernie_train["launches"][name],
            "max_abs_err": max(bhres["bf16"][k] for k in errs),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"] if fwd else None,
            "library_fwd_bwd_ms": None if fwd else r["library_ms"],
            "fp32_max_abs_err": max(bhres["fp32"][k] for k in errs),
            "ernie_ms": e["ms"], "ernie_plain_ms": e["plain_ms"],
            "ernie_bound_ms": e["bound_ms"],
            "ernie_library_ms": e["library_ms"],
        })
        if not fwd:
            kernels[-1].update({
                "device_ms": r["device_ms"],
                "library_bwd_device_ms": r["library_bwd_device_ms"],
                "ernie_device_ms": e["device_ms"],
                "ernie_library_bwd_device_ms": e["library_bwd_device_ms"]})
            kernels[-1]["helper_launches"] = {
                k: bh_train["launches"][k] + ernie_train["launches"][k]
                for k in ("flash_bwd_fused_prep", "flash_bwd_fused_dq_cast")}
    # the bf16 forwards run the tensor-core kernel: its numbers, with the
    # CUDA-core kernel's (the fp32 body) beside them
    for entry in kernels:
        cell = {"flash_fwd": "flash_fwd",
                "flash_fwd_hpack": "flash_fwd_hpack"}.get(entry["name"])
        if cell is None:
            continue
        r = tcres[cell]
        entry.update({
            "source": TC_SOURCE, "fp32_source": CORE_SOURCE,
            "tc_launches": (tres["launches"][f"{cell}.tc"]
                            if cell == "flash_fwd" else
                            bh_train["launches"][f"{cell}.tc"]
                            + ernie_train["launches"][f"{cell}.tc"]),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "tflops": r["tflops"], "cuda_core_ms": r["cuda_core_ms"],
            "hgmma": tcres["hgmma"]})
        if cell == "flash_fwd_hpack":
            e = tcres["flash_fwd_hpack ernie"]
            entry.update({"ernie_ms": e["ms"],
                          "ernie_plain_ms": e["plain_ms"],
                          "ernie_bound_ms": e["bound_ms"],
                          "ernie_library_ms": e["library_ms"],
                          "ernie_cuda_core_ms": e["cuda_core_ms"]})
    # the 16-bit split backward runs the tensor-core pair: its numbers,
    # with the CUDA-core pair's (the fp32 body) beside them
    for entry in kernels:
        if entry["name"] not in ("flash_bwd_dq", "flash_bwd_dkv"):
            continue
        r, r16 = tcb["bf16"][entry["name"]], tcb["fp16"][entry["name"]]
        pair = tcb["bf16"]
        entry.update({
            "source": TC_BWD_SOURCE, "fp32_source": CORE_SOURCE,
            "tc_launches": tres["launches"][f"{entry['name']}.tc"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
            "library_bwd_pair_ms": pair["library_bwd_ms"],
            "library_bwd_pair_device_ms": pair["library_bwd_device_ms"],
            "library_fwd_bwd_ms": pair["library_fwd_bwd_ms"],
            "pair_ms": pair["pair_ms"],
            "pair_device_ms": pair["pair_device_ms"],
            "tflops": r["tflops"], "device_tflops": r["device_tflops"],
            "cuda_core_ms": r["cuda_core_ms"],
            "cuda_core_device_ms": r["cuda_core_device_ms"],
            "hgmma": tcb["hgmma"], "fp16_ms": r16["ms"],
            "fp16_device_ms": r16["device_ms"],
            "gate_ratio": max(tcb["bf16"]["main"]["ratios"][n] for n in (
                ("dq",) if entry["name"] == "flash_bwd_dq" else
                ("dk", "dv"))),
            "equal_share": min(tcb["bf16"]["main"]["shares"][n] for n in (
                ("dq",) if entry["name"] == "flash_bwd_dq" else
                ("dk", "dv")))})
    # the 16-bit fused backward runs the tensor-core sweep: its numbers
    # (GPT's shape; ERNIE's beside), with the CUDA-core sweep's (the fp32
    # body) beside them
    for entry in kernels:
        if entry["name"] != "flash_bwd_fused":
            continue
        r, e, r16 = tcf["bf16 gpt"], tcf["bf16 ernie"], tcf["fp16 gpt"]
        entry.update({
            "source": TC_BWD_SOURCE, "fp32_source": CORE_SOURCE,
            "tc_launches": (bh_train["launches"]["flash_bwd_fused.tc"]
                            + ernie_train["launches"]["flash_bwd_fused.tc"]),
            "max_abs_err": max(r["max_abs_err"], e["max_abs_err"]),
            "ms": r["ms"], "device_ms": r["device_ms"],
            "sweep_device_ms": r["sweep_device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library_bwd_device_ms": r["library_bwd_device_ms"],
            "pair_device_ms": r["pair_device_ms"],
            "device_tflops": r["device_tflops"],
            "cuda_core_ms": r["cuda_core_ms"],
            "cuda_core_device_ms": r["cuda_core_device_ms"],
            "hgmma": tcf["hgmma"], "fp16_device_ms": r16["device_ms"],
            "gate_ratio": max(r["ratios"].values()),
            "equal_share": min(r["shares"].values()),
            "ernie_ms": e["ms"], "ernie_device_ms": e["device_ms"],
            "ernie_plain_ms": e["plain_ms"], "ernie_bound_ms": e["bound_ms"],
            "ernie_library_bwd_device_ms": e["library_bwd_device_ms"],
            "ernie_pair_device_ms": e["pair_device_ms"],
            "ernie_cuda_core_device_ms": e["cuda_core_device_ms"]})
    # the 16-bit forward runs the tensor-core kernel: its numbers, with the
    # CUDA-core forward's (the fp32 body) beside them
    r, r16, lf = ltf["bf16"], ltf["fp16"], lres["lmce_fwd"]
    kernels.append({
        "name": "lmce_fwd", "route": "cuda", "source": LMCE_FWD_TC_SOURCE,
        "fp32_source": LMCE_SOURCE, "replaces": LMCE_REPLACES["lmce_fwd"],
        "launches": lmce_train["launches"]["lmce_fwd"],
        "tc_launches": lmce_train["launches"]["lmce_fwd.tc"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "library_device_ms": r["library_device_ms"],
        "library_fwd_bwd_ms": lf["library_fwd_bwd_ms"],
        "tflops": r["tflops"], "device_tflops": r["device_tflops"],
        "cuda_core_ms": r["cuda_core_ms"],
        "cuda_core_device_ms": r["cuda_core_device_ms"],
        "hgmma": ltf["hgmma"], "gate_ratio": max(r["gate_ratio"],
                                                 r16["gate_ratio"]),
        "fp16_ms": r16["ms"], "fp16_device_ms": r16["device_ms"],
        "fp16_max_abs_err": r16["max_abs_err"],
        "fp32_max_abs_err": lf["fp32_max_abs_err"],
    })
    # the backward: the tensor-core kernels (bf16 and fp16, the main
    # path), and the CUDA-core ones (fp32: the [train fp32 parity] fused
    # run's launches; timed in bf16 beside the tensor-core kernels)
    for name in ("lmce_bwd_dh", "lmce_bwd_dw"):
        which = name[-2:]
        tc, tc16 = ltc[f"{name}_tc bf16"], ltc[f"{name}_tc fp16"]
        kernels.append({
            "name": f"{name}_tc", "route": "cuda", "source": LMCE_TC_SOURCE,
            "replaces": LMCE_REPLACES[name],
            "launches": lmce_train["launches"][f"{name}.tc"],
            "max_abs_err": tc["max_abs_err"], "ms": tc["ms"],
            "plain_ms": tc["plain_ms"], "bound_ms": tc["bound_ms"],
            "bound_by": tc["bound_by"], "library_ms": None,
            "library_fwd_bwd_ms": lres["lmce_fwd"]["library_fwd_bwd_ms"],
            "tflops": tc["tflops"], "cuda_core_ms": tc["cuda_core_ms"],
            "hgmma": ltc["hgmma"], "fp16_ms": tc16["ms"],
            "fp16_max_abs_err": max(tc16["max_abs_err"], f16[f"{name}_tc"]),
        })
        kernels.append({
            "name": name, "route": "cuda", "source": LMCE_SOURCE,
            "replaces": LMCE_REPLACES[name],
            "launches": fp32_lmce[name],
            "max_abs_err": lres["fp32"][which], "ms": tc["cuda_core_ms"],
            "plain_ms": tc["plain_ms"], "bound_ms": tc["bound_ms"],
            "bound_by": tc["bound_by"], "library_ms": None,
            "library_fwd_bwd_ms": lres["lmce_fwd"]["library_fwd_bwd_ms"],
            "fp16_max_abs_err": f16[name],
        })
    # fp16 ([fp16]) and head dims 16 / 32 ([headdim]) errors on every
    # flash and lmce entry
    hd_flash = [v for k, v in hd.items() if k.startswith("D=")]
    for entry in kernels:
        name = entry["name"]
        if name in f16 and "fp16_max_abs_err" not in entry:
            entry["fp16_max_abs_err"] = f16[name]
        if f"{name} cuda_core" in f16:
            entry["cuda_core_fp16_max_abs_err"] = f16[f"{name} cuda_core"]
        if name in FLASH_KERNELS + BH_KERNELS:
            entry["d16_d32_max_abs_err"] = max(e[name] for e in hd_flash)
        if name in FLASH_KERNELS:
            entry["fp16_launches"] = fp16_train["launches"][name]
            entry["fp16_tc_launches"] = fp16_train["launches"][f"{name}.tc"]
            entry["fused_lmce_launches"] = lmce_train["launches"][name]
            entry["ernie_sched_launches"] = esched["launches"][name]
            entry["ernie_sched_tc_launches"] = \
                esched["launches"][f"{name}.tc"]
            fp16 = escaler[SCALER_INITS[0]]["launches"]
            entry["ernie_fp16_scaler_launches"] = fp16[name]
            entry["ernie_fp16_scaler_tc_launches"] = fp16[f"{name}.tc"]
            entry["gpt_o1_launches"] = o1["launches"][name]
            entry["gpt_o1_tc_launches"] = o1["launches"][f"{name}.tc"]
            entry["gpt_o1_black_list_cuda_core_launches"] = \
                o1["black_launches"][name]
            entry["dygraph_launches"] = dyg["launches"][name]
            entry["dygraph_tc_launches"] = dyg["launches"][f"{name}.tc"]
            entry["hybrid_launches"] = hyb[name]
            entry["hybrid_tc_launches"] = hyb[f"{name}.tc"]
            entry["ernie_sharding_launches"] = shard[name]
            entry["ernie_sharding_tc_launches"] = shard[f"{name}.tc"]
            entry["pipe_1p3b_launches"] = pipe[name]
            entry["pipe_1p3b_tc_launches"] = pipe[f"{name}.tc"]
            entry["compressed_dp4_launches"] = comp["compressed"][name]
            entry["compressed_dp4_tc_launches"] = \
                comp["compressed"][f"{name}.tc"]
            entry["lmce_mp_launches"] = comp["lmce_mp"]["flash"][name]
            entry["lmce_mp_tc_launches"] = \
                comp["lmce_mp"]["flash"][f"{name}.tc"]
            h = pipe_hold[name]
            entry["pipe_1p3b_fp32_d128"] = {
                "shape": list(PIPE_FLASH), "ms": h["ms"],
                "device_ms": h["device_ms"], "plain_ms": h["plain_ms"],
                "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
                "library_ms": h["library_ms"],
                "max_abs_err": max(pipe_hold["errs"][k] for k in (
                    ("out", "lse") if name == "flash_fwd" else
                    ("dq",) if name == "flash_bwd_dq" else ("dk", "dv")))}
    # the fused LMCE over a split vocabulary ([train gpt lmce mp], bf16 on
    # the tensor cores; its parity, fp32 on the CUDA cores)
    hold = comp["lmce_mp"]["hold"]
    for entry in kernels:
        name = entry["name"]
        if name in ("lmce_fwd", "lmce_bwd_dh_tc", "lmce_bwd_dw_tc"):
            key = name.replace("_tc", "")
            entry["lmce_mp_launches"] = comp["lmce_mp"]["lmce"][key]
            entry["lmce_mp_hold"] = {
                "shape": {"h": hold["h"], "w": hold["w"]},
                "gate_ratio": (hold["fwd_ratio"] if key == "lmce_fwd" else
                               hold["bwd_ratios"][key[-2:]]),
                "max_abs_err": (max(hold["fwd_errs"].values())
                                if key == "lmce_fwd" else
                                hold["bwd_errs"][key[-2:]])}
        if name in ("lmce_bwd_dh", "lmce_bwd_dw"):
            entry["lmce_mp_fp32_launches"] = comp["lmce_mp_fp32"][name]
        if name == "lmce_fwd":
            entry["lmce_mp_fp32_launches"] = comp["lmce_mp_fp32"][name]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
