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

    def host_scalars(self, states, lr):
        """Control 1: the scalars as host floats of the host step count
        (the optimizer before device scalars); a capture freezes them."""
        f = np.float32
        t = states[0]["steps"] + 1
        b1p, b2p = f(f(self._beta1) ** t), f(f(self._beta2) ** t)
        lr32 = f(self.get_lr())
        root = np.sqrt(f(1) - b2p, dtype=f)
        vals = (f(lr32 * root / (f(1) - b1p)), f(f(self._epsilon) * root),
                f(lr32 * f(self._weight_decay)))
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


def _relu_watch(torch, net):
    """Forward pre-hooks on every ReLU of ``net`` that keep each call's
    input on the CPU, a list per forward (the hooks see eager forwards
    only, not graph replays)."""
    calls = []

    def keep(mod, args):
        calls.append(args[0].detach().float().cpu())

    for mod in net.modules():
        if type(mod).__name__ == "ReLU":
            mod.register_forward_pre_hook(keep)
    return calls


def _relu_force(net, inputs):
    """Make every ReLU of ``net`` pass what another run's ReLU passed:
    its n-th call multiplies its input by ``inputs[n] > 0`` (eager
    forwards in order), so the gradient takes that run's way through
    each ReLU whatever the sign of this run's input."""
    masks = iter([x > 0 for x in inputs])

    def forced(x):
        return x * next(masks).to(x.device, x.dtype)

    for mod in net.modules():
        if type(mod).__name__ == "ReLU":
            mod.forward = forced


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
    train_eager_phase(torch, args.seed, tres)
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
