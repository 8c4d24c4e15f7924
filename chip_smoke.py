#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold each of its
kernels against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi), and the build of every
   kernel source in ``streamformer_tpu_torch/csrc`` (one nvcc each, all
   started together); the bf16 kernels of B/L and I hold HMMA (tensor-core)
   instructions, and the decode bodies of A/D/J, F/G and K, the full-clip
   kernels C and H and the append kernel E the bulk asynchronous copy
   UBLKCP (``cuobjdump -sass``);
2. each kernel against its plain version at the flagship shapes, bf16 and
   fp32 (kernel A linear and ring, and linear at capacity 64), with its time (a call's, CUDA events
   around the wrapper, and the kernel's own device time, ``torch.profiler``
   over the same L2-flushed calls), the plain version's time, one
   ``scaled_dot_product_attention`` call's time (a yardstick the port never
   calls) and the bound (the card's least time for the bytes and
   operations); B on the full clip's R=128 rows bit-equal to B on each
   8-row slice (batch invariance); C's packed entry (the (B, T, N, 3D) qkv
   read in place) bit-equal to C on the transposed (R, T, D) rows; E at
   capacities 16 and 64, its packed entry bit-equal to its (t, R, D) entry
   with the same appended planes;
3. the whole encoder on the card against the same encoder on the CPU (the
   plain versions) at a small fp32 config: full clip, a linear stream and a
   ring stream of 2C frames;
4. ``from_pretrained`` on a checkpoint written from seeded random weights at
   the flagship width (768 hidden, 12 layers, 12 heads, 224x224, T=16,
   bf16), then ``model_forward`` at batch 8;
5. 16 frames through ``streaming_forward`` on a linear cache of capacity
   16, each frame held to the full clip within the bf16 envelope the JAX
   package accepts on its chip (0.078 hidden, 0.008 pooled);
6. a ring stream of 2C frames (C=8), kernel A held against its plain
   version on the ring's cache;
7. streaming frames/s at batch 8 at steady state (ring, capacity 16), and
   the device time by kernel over a profiled window; the host ms a step
   with every kernel entry calling its ``torch.library`` op against the
   launcher called directly, in turns (the ops' dispatch cost);
8. the serving engine (``serving.StreamingEngine``, ragged cache, kernels D
   and E) on the flagship model of phase 4: 8 slots, 12 streams of 4-16
   frames fed in bursts (holds and slot recycling), each stream's pooled
   features held to a lone B=1 stream within 0.008, in latency mode
   (``tick()``) and throughput mode (``tick(frames=8)``); uint8 staging
   with on-device normalize held to a float feed;
9. ``server.StreamingServer`` on 127.0.0.1: two clients each open, feed
   (uint8, base64), close and read their features, held to the engine's;
10. engine frames/s at 8 slots at steady state in both tick modes, and the
    device busy time per tick over a profiled window, the float throughput
    tick's beside the earlier design's (``EARLIER_THROUGHPUT_TICK``); the
    latency tick's ms through the ops against the launcher, in turns;
11. kernels F and G (the int8 cache) against their plain versions at the
    flagship shapes, bf16 and fp32, linear and ring (F also linear at
    capacity 64), codes and scale columns equal, timed beside one
    ``scaled_dot_product_attention`` call on the dequantized cache (a
    yardstick of the float function: no PyTorch call takes the int8 cache);
12. lockstep int8 serving on the flagship model: 16 frames at batch 8 on an
    int8 linear cache of capacity 16, each frame within the JAX package's
    int8 gates of the bf16 full clip (cosine 0.999 with the int8 cache alone,
    0.995 with int8 weights too), then a ring stream of 2C frames with int8
    weights, kernel F L times a step; int8 streaming frames/s and the device
    time by kernel;
13. the engine on an int8 cache (kernel G) on phase 8's bursty streams,
    with bf16 weights (each stream within 0.008 pooled of a lone B=1 stream
    on an int8 cache) and with int8 weights (within two bf16 ulps at 1,
    0.0156: int8 weights turn the bf16 rounding of products at another batch
    size into code steps), in both tick modes, ``tick(frames=8)`` bit for bit
    equal to ``tick()`` and G launched L times per t=1 step the engine ran;
    engine frames/s with the device busy share for both;
14. the backward kernels H and I against their plain versions at the
    flagship shapes (H: R=1568, T=16; I: R=128, N=196), bf16 and fp32, twice
    for bit-equality, timed beside the backward of one
    ``scaled_dot_product_attention`` call (a yardstick the port never calls);
    H's packed entry (one (B, T, N, 3D) gradient) bit-equal to H on the
    transposed rows;
15. a small fp32 ``MultitaskModel`` on the card against the same model on
    the CPU (plain versions): one ``loss_fn`` and backward for a task of each
    of the seven kinds, every gradient leaf held to the CPU's, and a second
    run on the card bit-equal to the first;
16. the training path at full width: a ``MultitaskModel`` on the flagship
    encoder (bf16 compute over fp32 master parameters) with the SigLIP-base
    text tower shape frozen, seeded random weights, the hash tokenizer;
    ``create_optimizer`` (AdamW, clip 1.0, weight decay 0.05, layer decay
    0.75, cosine schedule with warm-up) and ``MultitaskTrainer.
    train_one_epoch`` over batches of 8 clips alternating a classification, a
    grounding and a VIS task, ``update_freq=2``, 6 optimizer updates: finite
    losses whose sum over the three repeated batches falls from the first
    round to the last, the text tower unchanged bit
    for bit, B, C, H and I each L times a micro-step; then a short run with
    ``remat="layer"`` (B and C 2L times a micro-step, the same losses) and
    the peak memory of both;
17. training clips/s and ms per micro-step at steady state, and a
    ``torch.profiler`` window of the trainer: device busy ms per micro-step,
    device time by kernel and launches per micro-step (B, C, H and I each
    matched by its symbol, fatal if one reads no time);
18. kernels J and K (the row-major cache) against their plain versions at
    the flagship shapes, bf16 and fp32, len 0, 7 and 15, K on int8 codes
    (``quantize_kv_heads``) and on a float cache, J's written rows equal,
    timed beside one ``scaled_dot_product_attention`` call;
19. row-major lockstep streams on phase 4's model at batch 8: a linear
    stream of 16 frames (C=16) through kernel J, each frame within the bf16
    envelope of the full clip and bit for bit equal to the pos-major stream;
    an int8 row-major stream through kernel K at pooled cosine > 0.999 to
    the full clip; a row-major ring of 2C frames (C=8, kernel J) within
    0.008 pooled of the pos-major ring, on the main input and on four more
    seeded inputs; and frames/s of a linear stream on both layouts;
20. multi-frame appends to the ring (C=8, 3C frames) in chunks of 4 and 12,
    each frame within 0.008 pooled of the t=1 ring stream, kernel A L*t
    times a chunk; the same on an int8 ring with kernel F;
21. kernel L (head-split spatial attention) against its plain version at
    (R, H, N, dh) = (8, 12, 196, 64) and (128, 12, 196, 64), bf16 and fp32,
    forward and gradient, timed beside one ``scaled_dot_product_attention``
    call;
22. the streaming consumers at full width (bf16, capacity 16) on seeded
    uint8 frames of 240x320 preprocessed on the card: the OAD extractor's
    streaming mode (a 40-frame clip in chunks of 16, and four more seeded
    clips) against a t=1 ring stream, its windowed mode against ``model_forward``, its batched mode (8
    slots, 12 clips of 4-40 frames) against the streaming mode, with
    extraction frames/s; the vision tower on a linear cache (C=16, chunks
    through kernel E; C=64, each call one append through kernel E) and on the
    ring (C=8), each frame within the 0.078/0.008 envelope of a direct
    ``streaming_forward`` stream, its context window and ``clear_cache``;
23. the training entry point at full width: ``siglip_init`` on a seeded
    random SigLIP-base state dict (``pytorch_model.bin``), its encoder at
    gate 0 on an 8-frame clip against each frame alone (time table zeroed,
    0.078 / 0.008); the train augmentation's device ms per batch (8 uint8
    clips of 16x256x340, ``torch.profiler``); ``train.run.train`` (the CLI's
    training function) handed in-memory clips of three tasks (the card's
    machine has no cv2 to decode files), the SigLIP-initialised backbone as
    ``--model_path``, 2 epochs of 6 micro-steps at batch 8, ``update_freq=2``,
    the loader in train mode (RandAugment m7 n4, resized crop, flip,
    normalize, erasing on the card): B, C, H and I L times a micro-step,
    clips/s with the loader in the loop beside phase 17's; ``--eval_freq 1``
    over an in-memory eval union (classification, retrieval, grounding):
    the eval metrics in log.txt, the eval seconds an epoch, B and C L times
    an eval batch; a SIGTERM after the second update of epoch 1 of a run
    without ``--eval_freq``, then a fresh call resuming from the mid-epoch
    checkpoint, equal to the validating uninterrupted run bit for bit; the
    time ``save_checkpoint`` takes to return with ``block=True`` and
    ``block=False``, and the checkpoint's bytes on disk;
24. distribution: ``parallel.mesh.init_distributed`` (NCCL, world size 1;
    the card's machine has one GPU) and ``make_mesh(1, 1)``; phase 16's
    model and optimizer with ``MultitaskTrainer(mesh=)`` through phase 16's
    12 micro-steps and phase 17's 12 timed ones, the timed losses equal to
    phase 17's bit for bit, B, C, H and I L times a micro-step, the ms per
    micro-step beside phase 17's, and the device ms of the update's
    gradient sync (the bucketed all-reduce of the fp32 buffer); then B, C,
    H and I at the rank shape of model parallelism 2 (6 heads of 64, the
    packed qkv (8, 16, 196, 1152)) against their plain versions, bf16 and
    fp32, timed beside ``scaled_dot_product_attention``;
25. a small fp32 language model on the card against the same on the CPU:
    the forward, lockstep and ragged with a cache (an append clamped at the
    capacity edge), on int8 and int4 KV caches and with int8 weights (the
    ``lm_head`` too), logits within 1e-4; ``DecodeEngine``'s greedy tokens
    equal on both devices; a small ``LlavaQwenModel`` (SMALL_CONFIG's
    tower, B and C on the card) with equal prompt embeddings and answers;
26. the LM at Qwen2.5-7B's widths (152,064 vocab, 3,584 hidden, 18,944
    MLP, 28 layers, 28 query and 4 KV heads of 128, bf16, seeded random
    weights drawn on the card) under ``DecodeEngine`` at 8 slots and
    capacity 1,024: 16 requests of 64-448 prompt ids and 32-64 new tokens
    in bursts; each request's tokens held to one B=1 forward over its prompt
    and tokens (a position must match where the lone top-1/top-2 margin
    exceeds the largest logit difference between the two); 4-step ticks
    equal to 1-step ticks; int8 and int4 KV within pooled-logit cosine
    0.999 and 0.995 of the bf16 engine; the scores' fp32 product timed
    against a cast of the cache; decode ms a tick, tokens/s, device busy and
    launches a step at 8 and 32 slots, beside the bound (the weights' bytes
    over 3.35 TB/s); prefill ms by bucket; after phase 27, the same with int8
    weights and the int8 ``lm_head`` (cosine 0.99) and the peak memory;
27. VideoQA: ``LlavaQwenModel`` of phase 4's tower (non-streaming, 16 frames
    of 224x224), the projector (768 -> 3,584 -> 3,584) and phase 26's LM;
    ``VideoQAServer`` on 127.0.0.1 with two concurrent clients posting
    ``/qa``, their tokens equal to the in-process engine's on the same
    spliced prompts, each request's round trip; then ``generate`` on a
    streaming linear tower (C=16) through kernel E;
28. VideoQA training (``downstream.videoqa``, ``videoqa_run``): a small fp32
    ``VideoQAModel`` (SMALL_CONFIG's tower, LM_SMALL) on the card against
    the same on the CPU, two steps each of stages 1, 2 and 3 and of DPO,
    losses, DPO metrics and every parameter within 1e-4, frozen parts bit
    for bit; stage 3 at full width (the flagship tower, bf16 over fp32
    masters; the projector 768 -> 896; the LM at Qwen2.5-0.5B's widths,
    151,936 vocab, 896 hidden, 24 layers, 14 / 2 heads of 64, tied; max_len
    256): 12 steps on one repeated seeded sample, finite and falling losses,
    B, C, H and I L times a step, ms per step, samples/s, device busy and
    launches a step (a 4-step profile), the peak memory; DPO at those
    widths (reward accuracy rising on a repeated pair, B and C 2L times a
    step, H and I L); stage 1 at Qwen2.5-7B widths (phase 26's LM redrawn
    from its seed, and phase 4's tower, both frozen: bit for bit unchanged,
    B and C only); ``videoqa_run.train`` on in-memory clips (an epoch of
    stage 3 and its checkpoint), then ``--eval --ckpt``: the checkpoint
    restored into a fresh model bit for bit, answers written through the
    ``DecodeEngine`` (E on the streaming tower, a two-turn row re-opened);
29. action recognition (``downstream.ar``, ``ar_run``): a small fp32 step
    (mixup, EMA, layer decay) on the card against the CPU within 1e-4;
    ``ar_run.train`` on in-memory uint8 clips at the CLI's defaults (the
    flagship encoder, bf16, 400 classes, batch 16 of 16 frames of 224^2,
    mixup 0.8, cutmix 1.0, smoothing 0.1, EMA 0.9999, layer decay 0.75): 8
    steps, B, C, H and I L times each, validation of the model and its
    EMA, the multi-view test of 4 segments x 3 crops and a checkpoint;
    clips/s, ms per step and the peak memory;
30. online action detection (``extract.oad``, ``downstream.oad_lstr``,
    ``oad_data``, ``oad_run``): two seeded uint8 clips of 600 frames
    (240x320, 25 s at 24 fps) through the streaming extractor a frame a call
    on phase 4's encoder (ring C=16; A and B L times a frame), frames/s, the
    features and one-hot targets written as ``PerFrameDataset`` reads them;
    one A call (R=196 past the ring's wrap) and one B call (R=1) of that run
    held to their plain versions on the same inputs;
    ``oad_run.train`` at LSTR's THUMOS-14 settings (768 -> 1024, 8 heads,
    22 classes, long memory 512 at rate 4, work 32, 8 groups) with the CLI's
    batch 16, lr 7e-5 and weight decay 5e-5: 12 steps (finite, falling),
    validation (mAP, mcAP) and a checkpoint, ms per step, windows/s, device
    busy and launches a step (a 4-step profile), the peak memory; MAT (48
    future, 8 anticipation) two steps; ``LSTRStream`` over 256 frames, ms a
    frame that recomputes the compressed memory and a frame that reuses it,
    its last logits within 2e-3 of ``forward`` on the data layer's window; a
    small fp32 LSTR, two steps on the card against the CPU;
31. OVIS (``ops.msdeform_attn``, ``models.adapter``, ``downstream.segmentor``,
    ``ctvis_plugin``, ``ovis_run``, ``eval.ytvis``): a small fp32 adapter and
    segmentor on the card against the CPU (the FPN, logits, masks and
    embeddings within 1e-4, the mask logits within 1e-4 of max(1, their
    largest), one step's loss within 1e-4, its gradients within 1e-4 of a
    leaf's largest); ``ovis_run.train`` at the CLI's defaults (the flagship
    backbone frozen in fp32, 2 frames of 224^2, the adapter's 4 blocks, the
    segmentor's 100 queries and 40 classes at hidden 256, the CTVIS loss) on
    8 seeded clips of 3 instances: B and C L times a step (the backbone runs
    once for the matching and the loss forwards), H and I never; ms per
    step, clips/s, the peak memory; a 3-step profile (device busy, launches
    a step) and MSDeformAttn's device time, its calls of a step replayed
    alone; one C call (the packed (1, 2, 196, 2304) qkv) and one B call
    (R=2) of a step held to their plain versions at the fp32 limit; kernel M
    (MSDeformAttn, ``csrc/msdeform_attn.cu``) twice a forward's
    MSDeformAttn calls a step and its backward once a call with a graph
    (the card-vs-CPU gates above hold it through the adapter and the
    segmentor), its forward and backward rows on the inputs and output
    gradient of the step's first call of each shape (an extractor's, a pixel
    decoder layer's), against the plain version at the fp32 limit (the
    gradients against max(1, their largest), the locations' off the kinks
    of bilinear sampling); ``run_inference`` on two in-memory videos of 6
    frames through ``HungarianTracker``, results JSON and
    ``evaluate_ytvis``'s AP;
32. deployment at the flagship (bf16, phase 4's weights): ``save_pretrained``
    then ``from_pretrained`` bit for bit, with the write's seconds and
    bytes; ``torch.export`` artifacts (``streamformer_tpu_torch.export``) of
    the flagship's first ``EXPORT_LAYERS`` layers (a depth cut),
    each written to a file and loaded back, run against the live calls: the
    full clip at batch 8 x 16 frames (B, C), the streaming step at batch 8
    on the ring C=16, t=1 (A, B), the ragged append at t=8 on the linear
    C=16 (E, B), the ragged int8-cache step (G, B): outputs held to the live
    calls (bit for bit expected), each kernel launched inside the program L
    times a call, the median ms a call exported against live, export
    seconds, artifact bytes and the copies of the cache in the graph; and
    the LM decode artifact at Qwen2.5-7B widths, two layers, 8 slots, run by
    ``DecodeEngine`` in place of its live step, with the live engine's
    greedy tokens;
33. the shapes and attention types past the first slices, at the flagship
    width (bf16), each sub-phase's launches held to its path and every
    kernel it launched held to its plain version on inputs captured from
    the path (B with L on the same, L bit-equal to B): (a) ``ar_run.train``
    at ``--input_size 384 --num_frames 16``, batch 4, 4 steps on in-memory
    clips of 416x480 (B and I at R=64, N=576, kernel rows), ms a step and
    the peak memory; (b) ``model_forward`` at 2 x 64 frames and the backward
    of its pooled sum (C and H at R=392, T=64, kernel rows), then a 64-frame
    linear stream (capacity 64, kernel A) against the clip within phase 5's
    gates, and the frames bit for bit; (c) ``enable_causal_temporal=False``
    through ``from_pretrained``: the full clip and its backward at 2 x 16
    frames (C and H without the mask, kernel rows at R=1568), 4 frames
    streamed at t=1 bit-equal to the causal model's stream; (d)
    ``joint_space_time`` at 1 x 8 frames, forward and backward (B and I at
    R=1, N=1568, kernel rows, and B's block count); (e) ``space_only`` at 2
    x 16 frames, the full clip and the frames streamed at t=1. The phase
    must take at most 60 s;
34. the streaming remainders, at the flagship width: (a) kernel rows of E
    without the mask (R=1568 C=16 t=8), at 64 frames causal and not (R=392
    C=64, the tiled body), past its whole-table plan (R=196 C=4096 t=16) and
    at t=1 on a capacity of 60000 (R=8), its ring mode (R=1568 C=8 t=4 and
    t=12), E's tiled body forced at the flagship (and bit-equal to the whole
    table: causal, non-causal, ring, a mixed cache, a lockstep t=1 step), A,
    D and J with fp32
    queries on a bf16 cache and bf16 queries on an fp32 cache (that one
    bit-equal to the bf16 cache), each within 2e-2 / 2e-5 of its plain
    version; (b) a 16-frame non-causal chunk into an empty cache bit-equal
    to the non-causal full clip, and on an int8 cache (F a query) within
    the JAX package's int8 gate of it (pooled cosine above 0.999); (c) one causal call of 64 frames (phase
    33b's config) against its clip within phase 5's gates, with the frames
    bit for bit; (d) the bf16 model on an fp32 cache bit-equal to the bf16
    cache, the fp32 model on a bf16 cache within 0.078 / 0.008 of its full
    clip and its t=1 stream bit-equal to its E chunks; (e) the engine on a
    mixed cache (t=1 steps, D; ticks of 4 frames, E chunks) within 0.008 of
    lone streams, and int8
    partial appends (``new_valid``, G a frame) bit-equal to the t=1 G stream
    on the valid frames. Each run's launches held to its path. The phase
    must take at most 60 s; (f) the t=1 decode kernels past their body's
    shared-memory plan (the scores of a row in a scratch), at C=8192: kernel
    rows of F, G (two streams), J and K (int8) at batch 1 (R=196), each
    within 2e-2 of its plain version with its writes equal, then the
    flagship cut to 2 layers on filled caches of that capacity, 3 frames at
    t=1 from the last slots: an int8 pos-major stream (F) and two per-stream
    ones (G), a row-major bf16 stream (J) and an int8 one (K), each within
    0.078 / 0.008 of the same stream with the plain versions in the kernels'
    place, in at most 90 s;
35. serving over several GPUs: (a) kernel rows of A, D, E, F and G at the
    rank shape of model parallelism 2 (6 heads of 64, R=1568, C=16, bf16),
    each within 2e-2 of its plain version, its cache writes equal; (b) the
    flagship streamed tensor parallel by two processes on this card over
    gloo (``tools.tp_stream``: a ring cache of C=16 at batch 8, 16 frames, a
    float and an int8 cache, each rank's cache at D / 2), each rank's pooled
    output within 0.008 of this process's stream (int8: cosine above
    0.999), A (or F) and B L times a frame on each rank; then over an NCCL
    mesh of world size 1: (c) ``StreamingEngine(mesh=)`` on phase 8's bursts
    as uint8 frames, latency and throughput ticks, bit for bit the
    one-process engine's, D (or E) and B L times a tick; (d)
    ``DecodeEngine(mesh=)`` at Qwen2.5-7B's widths, two layers, the
    one-process engine's greedy tokens; (e) ``export_sharded_forward`` of
    the flagship's first ``EXPORT_LAYERS`` layers, loaded on the mesh's
    groups, bit for bit the live full clip, B and C inside it.

Twenty paths are main paths: the lockstep encode (the launch counters are
zeroed just before phase 4's forward and read after phase 5), the serving
engine (zeroed before each engine run of phase 8, read after it), lockstep
int8 serving (zeroed before each stream of phase 12), the int8 engine
(zeroed before each engine run of phase 13), training (zeroed before
phase 16's epoch, read after it), the row-major streams (zeroed before each
stream of phase 19), the ring chunks (zeroed before each chunk of phase
20), the consumers (zeroed before each extraction and tower run of phase
22), and kernel L's own entry point, which no model path calls (zeroed
before phase 21's forward and gradient step), and the training entry point
(zeroed before phase 23's uninterrupted run, read after it), and the mesh
trainer (zeroed before phase 24's warm-up, read after its timed epoch),
and VideoQA (zeroed before phase 27's server run, read after it: B and C L
times an encode; then before the streaming tower's ``generate``: E), and
VideoQA training (zeroed before phase 28's timed stage-3 steps and read
after the profiled ones; zeroed before the timed DPO steps, the timed
stage-1 steps, ``videoqa_run.train`` and ``run_eval``, each read after
it), and AR fine-tuning (zeroed before phase 29's ``ar_run.train``, read
after it and around each of its steps), and online action detection
(zeroed before each clip's extraction in phase 30, read after it), and
OVIS (zeroed before phase 31's ``ovis_run.train``, read after it and around
each of its steps, and before its ``run_inference``, read after it), and
the exported programs (zeroed before each call of phase 32's artifacts,
read after it), and the shapes and attention types (zeroed before each
run of phase 33, read after it), and the streaming remainders (zeroed
before each run of phase 34b-f, read after it), and serving over several
GPUs (each rank of phase 35b zeroes before its stream and reads after it;
zeroed before each mesh engine run of 35c and the sharded program's call
of 35e, read after it). Every kernel must have run on its path.
The last two lines are the
``{"kernels": [...]}`` summary and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout, it exits non-zero and prints
neither.
"""

import base64
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; fp32 CUDA cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}  # kernel vs plain, max-abs (tests/test_torch_cuda.py)
STREAM_TOL_HIDDEN, STREAM_TOL_POOLED = 0.078, 0.008
# the JAX package's int8 gates against the float full clip: pooled cosine
# (tests/test_streaming.py, int8 cache; tests/test_quant.py, int8 weights)
INT8_CACHE_COS, INT8_WEIGHTS_COS = 0.999, 0.995
# an engine stream with int8 weights against its lone B=1 stream, pooled
# max-abs: 0.009765625 in both H100 runs that measured it (the bf16 products
# of another batch size move an activation code on a rounding edge, and a
# code step moves the output by more than 0.008); two bf16 ulps at 1
INT8_WEIGHTS_ENGINE_TOL = 2 * 2.0 ** -7
CARD_VS_CPU_TOL = 1e-4  # fp32 encoder, card vs CPU: summation order only
SOURCES = {
    "temporal_decode_pm": ("streamformer_tpu_torch/csrc/temporal_decode_pm.cu",
                           "streamformer_tpu/ops/attention.py:662"),
    "temporal_decode_pm_ragged": ("streamformer_tpu_torch/csrc/temporal_decode_pm.cu",
                                  "streamformer_tpu/ops/attention.py:751"),
    "temporal_append_pm_ragged": ("streamformer_tpu_torch/csrc/temporal_append_pm.cu",
                                  "streamformer_tpu/ops/attention.py:946"),
    "temporal_decode_pm_int8": ("streamformer_tpu_torch/csrc/temporal_decode_pm_int8.cu",
                                "streamformer_tpu/ops/attention.py:1090"),
    "temporal_decode_pm_int8_ragged": ("streamformer_tpu_torch/csrc/temporal_decode_pm_int8.cu",
                                       "streamformer_tpu/ops/attention.py:1171"),
    "spatial_flat": ("streamformer_tpu_torch/csrc/spatial_flat.cu",
                     "streamformer_tpu/ops/attention.py:1531"),
    "temporal_fullclip": ("streamformer_tpu_torch/csrc/temporal_fullclip.cu",
                          "streamformer_tpu/ops/attention.py:1335"),
    "temporal_fullclip_bwd": ("streamformer_tpu_torch/csrc/temporal_fullclip_bwd.cu",
                              "streamformer_tpu/ops/attention.py:1415"),
    "spatial_flat_bwd": ("streamformer_tpu_torch/csrc/spatial_flat_bwd.cu",
                         "streamformer_tpu/ops/attention.py:1589"),
    "temporal_decode_rm": ("streamformer_tpu_torch/csrc/temporal_decode_pm.cu",
                           "streamformer_tpu/ops/attention.py:381"),
    "temporal_decode_rm_readonly": ("streamformer_tpu_torch/csrc/temporal_decode_rm.cu",
                                    "streamformer_tpu/ops/attention.py:463"),
    "spatial_attention": ("streamformer_tpu_torch/csrc/spatial_flat.cu",
                          "streamformer_tpu/ops/attention.py:138"),
    # kernel M replaces no pallas_call: the JAX package's native MSDeformAttn
    # (a CPU op there) and the XLA gathers of its ms_deform_attn_core
    "ms_deform_attn": ("streamformer_tpu_torch/csrc/msdeform_attn.cu",
                       "streamformer_tpu/native/msdeform.cpp:51"),
    "ms_deform_attn_bwd": ("streamformer_tpu_torch/csrc/msdeform_attn.cu",
                           "streamformer_tpu/native/msdeform.cpp:92"),
}
# flagship: batch, frames, patches (224/16 squared), hidden, heads, cache capacity
FLAGSHIP = dict(batch=8, frames=16, patches=196, hidden=768, heads=12, capacity=16)
FLAGSHIP_CONFIG = dict(dtype="bfloat16")  # the config's defaults are the flagship widths
SMALL_CONFIG = dict(image_size=48, num_frames=4, hidden_size=96, num_hidden_layers=3,
                    num_attention_heads=4, intermediate_size=192, dtype="float32")
RING_CAPACITY = 8
# kernels A and F: (mode, capacity, len) at the flagship's capacity, linear
# and ring, and at the config's default capacity (64, past one stage of the
# decode body's shared-memory ring)
DECODE_CASES = (("linear", FLAGSHIP["capacity"], FLAGSHIP["capacity"] - 1),
                ("ring", FLAGSHIP["capacity"], 2 * FLAGSHIP["capacity"] + 5), ("linear", 64, 63))
# kernel D's per-stream lengths (linear, and ring past C), E's lens and valid
D_LENS = {"linear": [0, 1, 5, 9, 14, 15, 15, 15], "ring": [16, 17, 23, 31, 40, 41, 50, 63]}
E_LENS, E_VALID, E_T = [0, 1, 5, 8, 8, 12, 15, 16], [8, 0, 8, 8, 3, 4, 1, 0], 8
E_LENS_64 = [0, 9, 20, 33, 40, 51, 60, 64]  # E at capacity 64, the same valid
# serving: slots, streams and their frame counts (a seeded draw in [4, 16])
ENGINE = dict(slots=8, streams=12, min_frames=4, max_frames=16, burst_ticks=4, frames=8)
MEAN, STD = (0.481, 0.457, 0.408), (0.268, 0.261, 0.275)  # SigLIP-style normalize
THROUGHPUT_STREAMS = 48  # of capacity-many frames each, for engine frames/s
# the float throughput tick of phase 10 with the earlier kernel E (a warp a
# (row, head), a lane a query, q, k and v copied to (t, R, D) rows around it
# and ctx back): device busy ms a tick and frames/s, four runs on an H100
# 80GB HBM3 at 700 W; printed beside this run's for comparison
EARLIER_THROUGHPUT_TICK = dict(busy_ms=(17.142, 17.251), frames_per_s=(2087.0, 2814.5))
# training: the text tower of phase 15 (phase 16 takes SiglipTextConfig's defaults, the
# SigLIP-base shape), and phase 16's run
SMALL_TEXT_CONFIG = dict(vocab_size=1000, hidden_size=96, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=192, max_position_embeddings=16)
TRAIN_TEXT_CONFIG = dict()
TRAIN = dict(batch=8, update_freq=2, updates=6, remat_micro_steps=4, timed_micro_steps=12,
             profiled_micro_steps=6, base_lr=1e-4, min_lr=1e-6, warmup_steps=1, clip_grad=1.0,
             weight_decay=0.05, layer_decay=0.75, classes=10, vis_classes=5, mask_size=56)
RM_LENS = (0, 7, 15)  # phase 18: J's and K's cache lengths at capacity 16
L_SHAPES = ((8, 12, 196, 64), (128, 12, 196, 64))  # phase 21: (R, H, N, dh), step and clip
CHUNKS = (4, 12)  # phase 20: ring appends of 4 and of 12 (> C) frames
# phase 22: the consumers' clips (uint8, 240x320), the batched clip lengths' range
OAD = dict(frames=40, chunk=16, height=240, width=320, clips=12, min_frames=4, max_frames=40)
# phases 19 and 22: the row-major ring's and the OAD streaming mode's gaps to
# their references are read again on inputs of these seeds, off the main path
GAP_SEEDS = (1, 2, 3, 4)
TOWER_CALLS = {"linear C=16": (16, "linear", (5, 11)), "linear C=64": (64, "linear", (3, 4, 9)),
               "ring C=8": (8, "ring", (6, 10, 8))}
# each wrapper's kernels (csrc/), by what their symbols contain: a kernel
# row's device time is theirs alone in a profile of its calls
KERNEL_SYMBOLS = {
    "temporal_decode_pm": ("temporal_decode_pm_kernel",),
    "temporal_decode_pm_ragged": ("temporal_decode_pm_kernel",),
    "temporal_decode_rm": ("temporal_decode_pm_kernel",),
    "temporal_append_pm_ragged": ("temporal_append_pm_kernel", "temporal_append_pm_tiled"),
    "temporal_decode_pm_int8": ("temporal_decode_pm_int8_kernel",),
    "temporal_decode_pm_int8_ragged": ("temporal_decode_pm_int8_kernel",),
    "spatial_flat": ("spatial_flat_tc_kernel", "spatial_flat_kernel", "tiled::forward_"),
    "spatial_attention": ("spatial_flat_tc_kernel", "spatial_flat_kernel", "tiled::forward_"),
    "temporal_fullclip": ("temporal_fullclip_kernel", "tiled::forward_"),
    "temporal_fullclip_bwd": ("temporal_fullclip_bwd_kernel", "tiled::dq_",
                              "tiled::dkv_kernel"),
    "spatial_flat_bwd": ("spatial_flat_bwd", "tiled::dq_", "tiled::dkv_kernel"),
    "temporal_decode_rm_readonly": ("temporal_decode_rm_kernel",),
    "ms_deform_attn": ("msdeform_attn_kernel",),
    "ms_deform_attn_bwd": ("msdeform_attn_bwd_kernel",),
}
# phase 23: the training entry point. SigLIP-base's text tower (the vision
# tower's widths are the flagship's); three in-memory tasks of 16 clips of
# 256x340 uint8 frames, batch 8, so 6 micro-steps an epoch; the SIGTERM
# after the second update of epoch 1
SIGLIP_TEXT = dict(vocab=32000, positions=64)
ENTRY = dict(batch=8, epochs=2, update_freq=2, clips_per_task=16, height=256, width=340,
             lr=1e-3, preempt_after_update=2, classes=10, vis_classes=5, mask_size=56,
             aug_batches=3, siglip_frames=8, text_layers=12, eval_clips=8)
GRAD_CARD_VS_CPU_TOL = 1e-4  # of a leaf's largest gradient magnitude; fp32, summation order only
REMAT_LOSS_TOL = 1e-2  # relative: the recompute repeats the forward; bf16 rounding at most
# phases 25-27: the VideoQA serving path. The LM at Qwen2.5-7B's widths
# (Qwen/Qwen2.5-7B-Instruct config.json, as the JAX bench builds it), seeded
# random weights drawn on the card; the small fp32 LM of phase 25
LM_7B = dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_hidden_layers=28,
             num_attention_heads=28, num_key_value_heads=4, max_position_embeddings=32768,
             rope_theta=1e6, rms_norm_eps=1e-6, tie_word_embeddings=False, attention_bias=True,
             dtype="bfloat16")
LM_SMALL = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=8, num_key_value_heads=2, rope_theta=10000.0,
                tie_word_embeddings=False, dtype="float32")
# phase 26's traffic: 16 requests of 64-448 prompt ids (the JAX bench's range)
# and 32-64 new tokens, opened in bursts of 8, 4 and 4 a burst_ticks apart, so
# that slots recycle; then steady decode at 8 and 32 slots
DECODE = dict(slots=8, wide_slots=32, capacity=1024, requests=16, min_prompt=64, max_prompt=448,
              min_new=32, max_new=64, buckets=(64, 128, 256, 512), bursts=(8, 4, 4),
              burst_ticks=16, timed_ticks=24, profiled_ticks=4)
# the JAX tests' gates of the quantized LM (tests/test_lm_serving.py:319-440),
# pooled-logit cosine to the float LM: int8 KV INT8_CACHE_COS, int4 KV and int8
# weights these; held at the depth those tests set them at, two layers (at the
# 7B widths, with all 28 random layers, the errors of either quantization
# compound: the cosines are reported). int4's gate is reported only: the
# reference's int4 KV, which the port reproduces code for code, does not
# reach it at head_dim 128 (ROADMAP section 3)
INT4_CACHE_COS, INT8_WEIGHTS_LM_COS, JAX_GATE_LAYERS = 0.995, 0.99, 2
# the greedy check is void when the engine's logits sit so far from the lone
# forward's that no margin exceeds the gap: at least this share of positions
# must be decided by it
GREEDY_DECIDED_MIN = 0.1
# phase 27: two questions on 16 frames each, a prompt of 24 + <image> + 16 ids
# phase 32: the LM decode artifact's engine run (phase 26's widths, two layers)
LM_EXPORT = dict(slots=8, capacity=128, requests=12, new=16)
PROFILE_TRIES = 12  # profiles of a kernel's calls before its device time counts as missing
EXPORT_LAYERS = 2  # phase 32's encoder programs: a depth cut of the flagship (PERF.md section 4)
VQA = dict(frames=16, system=24, question=16, max_new=16, capacity=128, buckets=(32, 64))
# phases 28-29: the downstream training paths. VideoQA stages 2-3 and DPO at
# Qwen2.5-0.5B's published widths (Qwen/Qwen2.5-0.5B-Instruct config.json; the
# JAX CLI's defaults): 7B widths need optimizer state sharded over cards
LM_05B = dict(vocab_size=151936, hidden_size=896, intermediate_size=4864, num_hidden_layers=24,
              num_attention_heads=14, num_key_value_heads=2, max_position_embeddings=32768,
              rope_theta=1e6, rms_norm_eps=1e-6, tie_word_embeddings=True, attention_bias=True,
              dtype="bfloat16")
# one sample: 24 system ids, <image> (16 frame tokens), 16 question ids, a
# 32-id answer (the labels), padded to max_len; steps, the timed and the
# profiled among them; DPO steps; stage 1 at 7B widths; the CLI's rows
VQA_TRAIN = dict(max_len=256, system=24, question=16, answer=32, steps=12, warmup=4, timed=4,
                 profiled=4, dpo_steps=6, dpo_timed=4, s1_steps=6, s1_timed=4, cli_rows=4,
                 cli_new=8)
# the small fp32 VideoQA model of phase 28a: SMALL_CONFIG's tower, LM_SMALL
TRAIN_VS_CPU_TOL = 1e-4  # losses, DPO metrics and parameters, fp32: summation order only
# each step's gradients of a trained part, card vs CPU, relative to the part's
# largest: at lrs of 2e-5 and 2e-6 a parameter moves too little for the
# parameters' check to see a wrong gradient (the tower's through H and I)
TRAIN_GRAD_RTOL = 1e-4
# phase 29: action recognition on Kinetics-400's classes at the CLI's defaults
# (batch 16, 16 frames of 224^2), 8 steps from 16 distinct in-memory clips of
# 256x320 uint8 frames; validation on one batch; the final test on 2 clips of
# 4 segments x 3 crops
AR = dict(classes=400, batch=16, steps=8, clips=16, height=256, width=320, val_clips=16,
          test_clips=2, segments=4, crops=3, lr=2e-4, small_classes=10, small_batch=4)
# phase 30: online action detection. Extraction: two seeded uint8 clips of 25 s
# at 24 fps (240x320) through the streaming extractor a frame a call (A and B
# L times a frame); LSTR at THUMOS-14's settings (the LSTRConfig defaults:
# long memory 512 at rate 4, work 32) with the CLI's batch 16, lr 7e-5 and
# weight decay 5e-5; 12 steps, a 4-step profile; MAT (48 future, 8
# anticipation) 2 steps; the stream over 256 frames; a small fp32 LSTR card vs CPU
OAD_RUN = dict(clips=2, frames=600, height=240, width=320, classes=22, batch=16, steps=12,
               profiled=4, mat_steps=2, future=48, anticipation=8, stream_frames=256,
               small=dict(visual_size=64, d_model=64, num_heads=4, dim_feedforward=128,
                          num_classes=5, long_memory_num_samples=16, work_memory_num_samples=8,
                          enc_queries_0=4, enc_queries_1=8, groups=4))
STREAM_VS_FORWARD_TOL = 2e-3  # the stream's last logits vs forward on its window, fp32
# phase 31: OVIS at the CLI's defaults (the flagship backbone frozen in fp32,
# 224^2, 2 frames, the adapter's 4 blocks of 12 deformable heads, the
# segmentor's defaults at hidden 256: 100 queries, 40 YouTube-VIS 2019
# classes, 3 + 9 layers; AdamW 1e-4, weight decay 0.05): 8 steps on seeded
# clips of 3 instances, a 3-step profile; inference on two 6-frame videos;
# a small fp32 adapter and segmentor card vs CPU
OVIS = dict(steps=8, profiled=3, instances=3, classes=40, videos=2, video_frames=6,
            video_height=180, video_width=320,
            small_flags=["--hidden_size", "64", "--num_layers", "2", "--num_heads", "4",
                         "--intermediate_size", "128", "--input_size", "64"],
            small_seg=dict(hidden_dim=64, num_queries=8, num_classes=5, nheads=4,
                           dim_feedforward=64, enc_layers=1, dec_layers=3, mask_dim=64,
                           in_dim=64))
# phase 33: the shapes and attention types past the first slices, at the
# flagship width: AR fine-tuning at 384^2 (SigLIP's 384 checkpoint: 576
# patches a frame) on in-memory clips of 416x480; 64 frames; non-causal;
# joint space-time at 8 frames (1568 tokens); space-only at 16; the phase's
# budget on the card
SHAPES = dict(ar_size=384, ar_frames=16, ar_batch=4, ar_steps=4, ar_height=416, ar_width=480,
              long_frames=64, long_batch=2, nc_batch=2, nc_stream=4, joint_frames=8,
              joint_batch=1, space_frames=16, space_batch=2, tiled_frames=300, tiled_rows=64,
              tiled_patches=576, budget_s=60)
# phase 34: the streaming remainders. E past its whole-table plan (a capacity of
# 4096 at 16 frames), at t=1 on a capacity of 60000 (past A's plan too); the
# fp32 model on a bf16 cache at batch 2; the engine on a mixed cache (slots,
# each stream's frames from the flagship video, ticks of 1 and of 4 frames); int8 partial appends of 3
# frames at batch 4, new_valid a call; the phase's budget on the card
REST = dict(plan_cap=4096, plan_t=16, long_cap=60000, mixed_batch=2, engine_slots=2,
            engine_frames=(6, 4, 8, 5), engine_tick=4, int8_valid=([1, 3, 2, 3], [3, 0, 2, 1]),
            budget_s=60)
# phase 34f: F, G, J and K past the decode body's shared-memory plan (about
# C = 3,800 at the flagship width): the capacity, the depth cut of the
# streams' model (a filled cache of 8192 slots is 2.5 GB a layer in int8, 5
# GB in bf16), the frames streamed at t=1, the part's budget on the card
LONG_DECODE = dict(cap=8192, layers=2, frames=3, budget_s=90)
DEVICE = "cuda"


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from streamformer_tpu_torch.checkpoint import from_pretrained
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.models import encoder
    from streamformer_tpu_torch.ops import attention as ops
    from streamformer_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    # the capacity-64 cases of A and F draw from their own stream, so that
    # gen's draws, and every later phase's inputs, are those of the
    # flagship cases alone
    gen64 = torch.Generator(device=dev).manual_seed(64)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2

    # ---- 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, {len(build.SOURCES)} sources "
          "in parallel)")
    # the bf16 bodies of B/L and I run on the tensor cores: HMMA in their SASS
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    for lib in ("spatial_flat", "spatial_flat_bwd"):
        sass = subprocess.run([cuobjdump, "-sass", str(build.library_path(lib))], check=True,
                              capture_output=True, text=True).stdout
        hmma = {}
        for fn in sass.split("Function : ")[1:]:
            if "_tc_kernel" in fn.split("\n", 1)[0]:
                hmma[fn.split("\n", 1)[0].strip()] = fn.count("HMMA")
        if not hmma or not all(hmma.values()):
            fail(f"{lib}: bf16 kernels without HMMA instructions: {hmma}")
        print(f"{lib}: HMMA instructions in the bf16 kernels' SASS: {sorted(hmma.values())}")
    # the decode bodies (decode_row.cuh: A, D, J, F, G and K), C and H
    # (fullclip.cuh) and E stage their operands with cp.async.bulk, which
    # sm_90a's SASS spells UBLKCP (UBLKCP.S.G: global to shared)
    for lib in ("temporal_decode_pm", "temporal_decode_pm_int8", "temporal_decode_rm",
                "temporal_fullclip", "temporal_fullclip_bwd", "temporal_append_pm"):
        sass = subprocess.run([cuobjdump, "-sass", str(build.library_path(lib))], check=True,
                              capture_output=True, text=True).stdout
        bulk = {}
        for fn in sass.split("Function : ")[1:]:
            if f"{lib}_kernel" in fn.split("\n", 1)[0]:
                bulk[fn.split("\n", 1)[0].strip()] = fn.count("UBLKCP")
        if not bulk or not all(bulk.values()):
            fail(f"{lib}: kernels without bulk copies (UBLKCP): {bulk}")
        print(f"{lib}: UBLKCP instructions in the kernels' SASS: {sorted(bulk.values())}")

    def time_ms(fn, iters=15):
        """Median device time of one call, L2 flushed before each."""
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        torch.cuda.synchronize()
        return statistics.median(times)

    def device_ms(fn, symbols, iters=15):
        """The kernel's own device time a call: ``torch.profiler`` over
        iters calls, L2 flushed before each, as time_ms times them (whose
        events also hold the wrapper's host work). Each kernel's mean over
        the launches the profile recorded (late in a run it may miss some,
        or, now and then, all, six profiles in a row once: a profile
        without the kernel's rows is taken again, PROFILE_TRIES profiles at
        most; each such profile prints what it did record, for the cause,
        an open question in PERF.md), times its launches a call (tiled.cuh's
        backward launches both sides over chunks of its stored p and ds),
        summed over the kernels a call runs: its count over iters rounded
        up, since a profile may miss launches but never adds any (the
        warm-up call is synchronized before it starts)."""
        fn()
        torch.cuda.synchronize()
        for k in range(PROFILE_TRIES):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    flush.zero_()
                    fn()
                torch.cuda.synchronize()
            on_card = device_rows(prof)
            rows = [e for e in on_card if any(sym in e.key for sym in symbols)]
            if rows:
                return sum(e.device_time_total / e.count * max(1, -(-e.count // iters))
                           for e in rows) / 1e3
            print(f"device_ms: profile {k + 1} of {PROFILE_TRIES} holds no row of {symbols}: "
                  f"{len(on_card)} device rows ({sum(e.count for e in on_card)} events: "
                  f"{sorted(e.key for e in on_card)[:4]}), "
                  f"{sum(e.count for e in prof.key_averages())} events in all")
        fail(f"no device time matched {symbols} in {PROFILE_TRIES} profiles: a kernel symbol was "
             "renamed")

    def bound(nbytes, flops, dtype_name):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    def randn(*shape, dtype, g=gen):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    def max_err(a, b):
        return (a.float().cpu() - b.float().cpu()).abs().max().item()

    def finite(out):
        return all(torch.isfinite(x).all().item() for x in out.values())

    def device_rows(prof):
        """The profile's kernels and copies on the card, by name. A range
        that the host annotated (``Optimizer.step#AdamW.step``) is no
        kernel: its device time is its kernels' time over again."""
        return [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                and getattr(e, "device_time_total", 0) > 0
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith("Optimizer.")]

    # ---- 2. kernels against their plain versions at flagship shapes
    b_, t_, n_, d_, h_, cap = (FLAGSHIP[k] for k in
                               ("batch", "frames", "patches", "hidden", "heads", "capacity"))
    dh = d_ // h_
    results = {}

    def record(name, shape_tag, dtype_name, err, fn, plain, library, nbytes, flops, tol=None):
        tol = TOL[dtype_name] if tol is None else tol
        if not err <= tol:
            fail(f"{name} {shape_tag} {dtype_name}: max-abs error {err} > {tol}")
        ms, plain_ms = time_ms(fn), time_ms(plain)
        lib_ms = None if library is None else time_ms(library)  # None: no PyTorch call computes it
        dev_ms = device_ms(fn, KERNEL_SYMBOLS[name])
        bound_ms, bound_by = bound(nbytes, flops, dtype_name)
        row = dict(name=name, shape=shape_tag, dtype=dtype_name, max_abs_err=err, tol=tol, ms=ms,
                   device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        print("kernel " + json.dumps(row))
        results[(name, shape_tag, dtype_name)] = row

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        elt = torch.finfo(dtype).bits // 8
        # A: one streaming step, linear (len C-1) and ring (len past C)
        r = b_ * n_
        for mode, c_, length in DECODE_CASES:
            g_ = gen if c_ == cap else gen64
            q, kn, vn = (randn(r, d_, dtype=dtype, g=g_) for _ in range(3))
            kc, vc = randn(c_, r, d_, dtype=dtype, g=g_), randn(c_, r, d_, dtype=dtype, g=g_)
            ln = torch.tensor(length, dtype=torch.int32, device=dev)
            k_ref, v_ref = kc.clone(), vc.clone()
            ref = ops.temporal_decode_pm_plain(q, kn, vn, k_ref, v_ref, ln, h_)
            got = ops.temporal_decode_pm(q, kn, vn, kc, vc, ln, h_)
            torch.cuda.synchronize()
            if not (torch.equal(kc, k_ref) and torch.equal(vc, v_ref)):
                fail(f"temporal_decode_pm {mode} C={c_} {dn}: appended cache planes differ")
            n_read = min(length, c_) - (1 if length >= c_ else 0)  # old slots attended
            # yardstick: the new frame against the updated cache's valid slots
            window = (torch.arange(c_, device=dev) <= length).view(1, c_)
            q4 = q.view(r, h_, 1, dh)
            k4 = kc.view(c_, r, h_, dh).permute(1, 2, 0, 3)
            v4 = vc.view(c_, r, h_, dh).permute(1, 2, 0, 3)
            record("temporal_decode_pm", f"{mode} R={r} C={c_} len={length}", dn, max_err(got, ref),
                   lambda: ops.temporal_decode_pm(q, kn, vn, kc, vc, ln, h_),
                   lambda: ops.temporal_decode_pm_plain(q, kn, vn, kc, vc, ln, h_),
                   lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=window),
                   elt * r * d_ * (3 + 1 + 2 * n_read + 2), 4 * r * d_ * (n_read + 1))
        # D: one engine tick, every stream at its own length (linear and ring)
        r = b_ * n_
        for mode, lens in D_LENS.items():
            q, kn, vn = randn(r, d_, dtype=dtype), randn(r, d_, dtype=dtype), randn(r, d_, dtype=dtype)
            kc, vc = randn(cap, r, d_, dtype=dtype), randn(cap, r, d_, dtype=dtype)
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            k_ref, v_ref = kc.clone(), vc.clone()
            ref = ops.temporal_decode_pm_ragged_plain(q, kn, vn, k_ref, v_ref, ln, n_, h_)
            got = ops.temporal_decode_pm_ragged(q, kn, vn, kc, vc, ln, n_, h_)
            torch.cuda.synchronize()
            if not (torch.equal(kc, k_ref) and torch.equal(vc, v_ref)):
                fail(f"temporal_decode_pm_ragged {mode} {dn}: appended cache planes differ")
            n_read = sum(min(x, cap - 1) for x in lens)  # old slots attended, over streams
            rows_len = ln.long().repeat_interleave(n_)
            window = (torch.arange(cap, device=dev)[None] <= rows_len[:, None]).view(r, 1, 1, cap)
            q4 = q.view(r, h_, 1, dh)
            k4 = kc.view(cap, r, h_, dh).permute(1, 2, 0, 3)
            v4 = vc.view(cap, r, h_, dh).permute(1, 2, 0, 3)
            record("temporal_decode_pm_ragged", f"{mode} R={r} C={cap} lens={lens}", dn,
                   max_err(got, ref),
                   lambda: ops.temporal_decode_pm_ragged(q, kn, vn, kc, vc, ln, n_, h_),
                   lambda: ops.temporal_decode_pm_ragged_plain(q, kn, vn, kc, vc, ln, n_, h_),
                   lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=window),
                   elt * d_ * (6 * r + 2 * n_ * n_read), 4 * d_ * n_ * (n_read + b_))
        # E: one throughput-mode chunk, t=8 frames, mixed lens and valid, at
        # the flagship capacity (the (t, R, D) entry, and the packed entry on
        # the same frames as a (B, t, N, 3D) qkv, bit for bit equal) and at
        # capacity 64 (its own generator, as A's and F's)
        for c_, e_lens in ((cap, E_LENS), (64, E_LENS_64)):
            g_ = gen if c_ == cap else gen64
            lens_t = torch.tensor(e_lens, dtype=torch.int32, device=dev)
            valid_t = torch.tensor(E_VALID, dtype=torch.int32, device=dev)
            q, kn, vn = (randn(E_T, r, d_, dtype=dtype, g=g_) for _ in range(3))
            kc, vc = randn(c_, r, d_, dtype=dtype, g=g_), randn(c_, r, d_, dtype=dtype, g=g_)
            k_ref, v_ref = kc.clone(), vc.clone()
            ref = ops.temporal_append_pm_ragged_plain(q, kn, vn, k_ref, v_ref, lens_t, valid_t, n_,
                                                      h_)
            k_rows, v_rows = kc.clone(), vc.clone()
            got = ops.temporal_append_pm_ragged(q, kn, vn, k_rows, v_rows, lens_t, valid_t, n_, h_)
            qkv = torch.cat([q, kn, vn], -1).view(E_T, b_, n_, 3 * d_).transpose(0, 1).contiguous()
            packed = ops.temporal_append_pm_qkv(qkv, kc, vc, lens_t, valid_t, n_, h_)
            torch.cuda.synchronize()
            for planes, how in (((k_rows, v_rows), "(t, R, D) entry"), ((kc, vc), "packed entry")):
                if not (torch.equal(planes[0], k_ref) and torch.equal(planes[1], v_ref)):
                    fail(f"temporal_append_pm_ragged C={c_} {dn} {how}: appended cache planes "
                         "differ")
            if not torch.equal(packed.transpose(0, 1).reshape(E_T, r, d_), got):
                fail(f"temporal_append_pm_qkv C={c_} {dn}: differs from the (t, R, D) entry")
            err = max(max_err(got[:v, i * n_:(i + 1) * n_], ref[:v, i * n_:(i + 1) * n_])
                      for i, v in enumerate(E_VALID) if v)  # columns past valid are unspecified
            # yardstick: the t queries against [cache prefix, new frames], causal mask
            ti = torch.arange(E_T, device=dev)
            rows_len = lens_t.long().repeat_interleave(n_)
            old = (torch.arange(c_, device=dev)[None, None] < rows_len[:, None, None]).expand(
                r, E_T, c_)
            mask = torch.cat([old, (ti[None] <= ti[:, None]).expand(r, E_T, E_T)], -1)[:, None]
            q4 = q.view(E_T, r, h_, dh).permute(1, 2, 0, 3)
            k4 = torch.cat([kc, kn]).view(c_ + E_T, r, h_, dh).permute(1, 2, 0, 3)
            v4 = torch.cat([vc, vn]).view(c_ + E_T, r, h_, dh).permute(1, 2, 0, 3)
            n_old = sum(min(x, c_) for x in e_lens)
            nbytes = elt * n_ * d_ * (2 * n_old + 4 * E_T * b_ + 2 * sum(E_VALID))
            flops = 4 * d_ * n_ * (E_T * n_old + b_ * E_T * (E_T + 1) // 2)
            sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
            if c_ == cap:
                record("temporal_append_pm_ragged", f"R={r} C={c_} t={E_T}", dn, err,
                       lambda: ops.temporal_append_pm_ragged(q, kn, vn, kc, vc, lens_t, valid_t,
                                                             n_, h_),
                       lambda: ops.temporal_append_pm_ragged_plain(q, kn, vn, kc, vc, lens_t,
                                                                   valid_t, n_, h_),
                       sdpa, nbytes, flops)
            record("temporal_append_pm_ragged", f"qkv R={r} C={c_} t={E_T}", dn, err,
                   lambda: ops.temporal_append_pm_qkv(qkv, kc, vc, lens_t, valid_t, n_, h_),
                   lambda: ops.temporal_append_pm_qkv_plain(qkv, kc, vc, lens_t, valid_t, n_, h_),
                   sdpa, nbytes, flops)
            del q, kn, vn, kc, vc, k_ref, v_ref, k_rows, v_rows, qkv, q4, k4, v4
        # B: the streaming step (R = B) and the full clip (R = B*T)
        for r in (b_, b_ * t_):
            q, k, v = (randn(r, n_, d_, dtype=dtype) for _ in range(3))
            out = ops.spatial_flat(q, k, v, h_)
            err = max_err(out, ops.spatial_flat_plain(q, k, v, h_))
            qh, kh, vh = (x.view(r, n_, h_, dh).transpose(1, 2) for x in (q, k, v))
            record("spatial_flat", f"R={r} N={n_}", dn, err,
                   lambda: ops.spatial_flat(q, k, v, h_),
                   lambda: ops.spatial_flat_plain(q, k, v, h_),
                   lambda: F.scaled_dot_product_attention(qh, kh, vh),
                   4 * elt * r * n_ * d_, 4 * r * n_ * n_ * d_)
            # batch invariance: the full clip's rows equal, bit for bit, B on each
            # streaming step's slice of B rows (the stream-against-clip and
            # engine gates compare B at one R against B at another)
            for i in range(0, r, b_):
                if not torch.equal(ops.spatial_flat(q[i:i + b_], k[i:i + b_], v[i:i + b_], h_),
                                   out[i:i + b_]):
                    fail(f"spatial_flat {dn}: rows {i}..{i + b_ - 1} of R={r} differ from B "
                         f"on those {b_} rows alone")
            if r > b_:
                print(f"spatial_flat {dn}: R={r} bit-equal to B on each slice of {b_} rows")
        # C: the full clip's temporal attention (R = B*N rows of T frames)
        r = b_ * n_
        q, k, v = (randn(r, t_, d_, dtype=dtype) for _ in range(3))
        err = max_err(ops.temporal_fullclip(q, k, v, h_), ops.temporal_fullclip_plain(q, k, v, h_))
        qh, kh, vh = (x.view(r, t_, h_, dh).transpose(1, 2) for x in (q, k, v))
        record("temporal_fullclip", f"R={r} T={t_}", dn, err,
               lambda: ops.temporal_fullclip(q, k, v, h_),
               lambda: ops.temporal_fullclip_plain(q, k, v, h_),
               lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
               4 * elt * r * t_ * d_, 2 * t_ * (t_ + 1) * r * d_)
        # the packed entry (the encoder's call) reads the (B, T, N, 3D) qkv in
        # place: bit-equal to C on the transposed (R, T, D) rows
        qkv = torch.cat([x.view(b_, n_, t_, d_).transpose(1, 2) for x in (q, k, v)], -1)
        packed = ops.temporal_fullclip_qkv(qkv, h_).transpose(1, 2).reshape(r, t_, d_)
        if not torch.equal(packed, ops.temporal_fullclip(q, k, v, h_)):
            fail(f"temporal_fullclip_qkv {dn}: differs from temporal_fullclip on the same rows")
        print(f"temporal_fullclip_qkv {dn}: (B, T, N, 3D) in place bit-equal to the (R, T, D) "
              "entry")
        del q, k, v, qh, kh, vh, qkv, packed
    torch.cuda.synchronize()

    def open_gates(model, seed):
        """Open the zero-initialised gates and embedding tables, so that the
        temporal path and the positions matter."""
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in model.encoder.layer:
                layer.temporal_attention_gating.fill_(0.5)
            for p in (model.embeddings.time_embeddings, model.embeddings.position_embeddings):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))

    # ---- 3. the encoder on the card against the encoder on the CPU, small fp32 config
    small = StreamformerConfig(**SMALL_CONFIG)
    on_cpu = encoder.StreamformerEncoder(small, device="cpu", generator=torch.Generator().manual_seed(1))
    open_gates(on_cpu, 1)
    on_card = encoder.StreamformerEncoder(small)
    on_card.load_state_dict(on_cpu.state_dict())
    clip = torch.randn(2, small.num_frames, 3, small.image_size, small.image_size,
                       generator=torch.Generator().manual_seed(2))
    worst = 0.0
    for key, ref in encoder.model_forward(on_cpu, clip).items():
        worst = max(worst, max_err(encoder.model_forward(on_card, clip)[key], ref))
    for capacity, frames in ((small.num_frames, small.num_frames), (2, 4)):  # linear; ring 2C
        cache_cpu = encoder.init_cache(small, 2, capacity=capacity, device="cpu")
        cache_card = encoder.init_cache(small, 2, capacity=capacity)
        for i in range(frames):
            ref, cache_cpu = encoder.streaming_forward(on_cpu, clip[:, i:i + 1], cache_cpu)
            got, cache_card = encoder.streaming_forward(on_card, clip[:, i:i + 1], cache_card)
            worst = max(worst, *(max_err(got[k], ref[k]) for k in ref))
    if not worst <= CARD_VS_CPU_TOL:
        fail(f"encoder on the card vs the CPU: max-abs {worst} > {CARD_VS_CPU_TOL}")
    print(f"small fp32 encoder, card vs CPU (full clip, linear and ring streams): "
          f"max-abs {worst} (<= {CARD_VS_CPU_TOL})")
    del on_cpu, on_card

    # ---- 4. from_pretrained, then the full clip at flagship width
    cfg = StreamformerConfig(cache_capacity=cap, **FLAGSHIP_CONFIG)
    ckpt = os.path.join(root, "build", "chip_smoke_checkpoint")
    seeded = encoder.StreamformerEncoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    open_gates(seeded, 0)
    cfg.save_pretrained(ckpt)
    torch.save(seeded.state_dict(), os.path.join(ckpt, "pytorch_model.bin"))
    del seeded
    model = from_pretrained(ckpt)
    if model.device.type != dev.type:
        fail(f"from_pretrained put the model on {model.device}")
    video = torch.randn(b_, t_, 3, cfg.image_size, cfg.image_size, device=dev, generator=gen)
    L = cfg.num_hidden_layers
    ops.reset_launches()
    full = encoder.model_forward(model, video)
    torch.cuda.synchronize()
    after_full = dict(ops.LAUNCHES)
    hidden, pooled = full["last_hidden_state"], full["pooler_output"]
    if hidden.shape != (b_, t_, n_, d_) or pooled.shape != (b_, t_, d_):
        fail(f"full clip shapes {tuple(hidden.shape)}, {tuple(pooled.shape)}")
    if not finite(full):
        fail("full clip outputs are not finite")
    if after_full != {**dict.fromkeys(ops.LAUNCHES, 0), "spatial_flat": L, "temporal_fullclip": L}:
        fail(f"full-clip launches {after_full}")
    print(f"full clip B={b_} T={t_} bf16: finite, launches {after_full}")

    # ---- 5. linear stream of T frames == the full clip
    cache = encoder.init_cache(cfg, b_)
    worst_h = worst_p = 0.0
    for i in range(t_):
        out, cache = encoder.streaming_forward(model, video[:, i:i + 1], cache)
        eh = max_err(out["last_hidden_state"], hidden[:, i:i + 1])
        ep = max_err(out["pooler_output"], pooled[:, i:i + 1])
        worst_h, worst_p = max(worst_h, eh), max(worst_p, ep)
        if not (eh <= STREAM_TOL_HIDDEN and ep <= STREAM_TOL_POOLED):
            fail(f"stream frame {i}: hidden err {eh} (<= {STREAM_TOL_HIDDEN}), "
                 f"pooled err {ep} (<= {STREAM_TOL_POOLED})")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    stream_launches = {k: launches[k] - after_full[k] for k in launches}
    if stream_launches != {**dict.fromkeys(ops.LAUNCHES, 0), "temporal_decode_pm": L * t_,
                           "spatial_flat": L * t_}:
        fail(f"streaming launches {stream_launches}")
    if int(cache["len"]) != t_:
        fail(f"cache len {int(cache['len'])} after {t_} frames")
    print(f"linear stream {t_} frames == full clip: max err hidden {worst_h} (<= {STREAM_TOL_HIDDEN}), "
          f"pooled {worst_p} (<= {STREAM_TOL_POOLED}); launches {stream_launches}")
    del cache

    # ---- 6. ring stream of 2C frames, kernel A against its plain version on it
    ring = encoder.init_cache(cfg, b_, capacity=RING_CAPACITY)
    for i in range(2 * RING_CAPACITY):
        out, ring = encoder.streaming_forward(model, video[:, i % t_:i % t_ + 1], ring)
        if not finite(out):
            fail(f"ring frame {i}: outputs not finite")
    r = b_ * n_
    q, kn, vn = (randn(r, d_, dtype=torch.bfloat16) for _ in range(3))
    kc, vc = ring["layers"][0]["k"], ring["layers"][0]["v"]
    k_ref, v_ref = kc.clone(), vc.clone()
    ref = ops.temporal_decode_pm_plain(q, kn, vn, k_ref, v_ref, ring["len"], h_)
    got = ops.temporal_decode_pm(q, kn, vn, kc, vc, ring["len"], h_)
    ring_err = max_err(got, ref)
    if not (ring_err <= TOL["bfloat16"] and torch.equal(kc, k_ref) and torch.equal(vc, v_ref)):
        fail(f"ring decode vs plain: max-abs {ring_err}")
    print(f"ring stream {2 * RING_CAPACITY} frames at C={RING_CAPACITY}: finite; kernel A vs plain "
          f"on the ring cache (len={int(ring['len'])}): max-abs {ring_err}")
    del ring

    # ---- 7. streaming frames/s at steady state (ring, capacity 16, batch 8)
    cache = encoder.init_cache(cfg, b_)
    frame = video[:, :1]
    for i in range(t_):
        encoder.streaming_forward(model, video[:, i:i + 1], cache)
    torch.cuda.synchronize()
    steps = 32
    t0 = time.perf_counter()
    for _ in range(steps):
        encoder.streaming_forward(model, frame, cache)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    print(f"streaming encode ({smi}): {b_ / step_s:.1f} frames/s at batch {b_}, "
          f"{step_s * 1e3:.3f} ms/step (ring cache C={cap}, steady state, bf16)")
    # the torch.library ops' dispatch cost: the same steps with every entry
    # calling its op (as a traced program does), in turns direct, op, op, direct
    real_via_op = ops._via_op

    def host_ms(run, via_op, reps):
        ops._via_op = (lambda: True) if via_op else real_via_op
        try:
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0_) * 1e3 / reps
        finally:
            ops._via_op = real_via_op

    def dispatch_turns(run, reps):
        got = {False: [], True: []}
        for via_op in (False, True, True, False):
            got[via_op].append(host_ms(run, via_op, reps))
        return got[False], got[True]

    direct7, via7 = dispatch_turns(lambda: encoder.streaming_forward(model, frame, cache), steps)
    print(f"ops' dispatch, streaming step ({smi}): {steps} steps a turn, direct, op, op, direct: "
          f"{direct7[0]:.3f}, {via7[0]:.3f}, {via7[1]:.3f}, {direct7[1]:.3f} ms/step (host clock): "
          f"through the ops {statistics.mean(via7) - statistics.mean(direct7):+.3f} ms/step, "
          f"spread of the direct turns {abs(direct7[0] - direct7[1]):.3f} ms")
    window = 8
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            encoder.streaming_forward(model, frame, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / window
    rows = device_rows(prof)
    busy = sum(e.device_time_total for e in rows) / window / 1e3
    print(f"profile, {window} steady steps: device busy {busy:.3f} ms/step of {wall_ms:.3f} "
          f"(profiled wall clock)")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:12]:
        print(f"  {e.device_time_total / window / 1e3:8.4f} ms/step  x{e.count // window:<3d} "
              f"{e.key[:90]}")

    # ---- 8. the serving engine: ragged cache, kernels D and E
    from streamformer_tpu_torch.server import StreamingServer
    from streamformer_tpu_torch.serving import StreamingEngine

    img = cfg.image_size
    rng = np.random.default_rng(0)
    lens = [int(x) for x in rng.integers(ENGINE["min_frames"], ENGINE["max_frames"] + 1,
                                         ENGINE["streams"])]
    clips = [rng.standard_normal((n, 3, img, img)).astype(np.float32) for n in lens]

    def lone(clip, mdl=model):
        """Oracle: one frame at a time through a lone B=1 lockstep cache."""
        c1 = encoder.init_cache(mdl.cfg, 1)
        feats = []
        for i in range(len(clip)):
            out, c1 = encoder.streaming_forward(mdl, torch.from_numpy(clip[None, i:i + 1]), c1)
            feats.append(out["pooler_output"][0, 0].float())
        return torch.stack(feats).cpu().numpy()

    def serve(eng, clips, frames):
        """Open every stream and feed it half its frames, tick a few times (the
        short streams starve and hold, the rest wait for a slot), then feed
        the rest, close and run to the end. Returns (features, ticks)."""
        sids = [eng.open() for _ in clips]
        for sid, clip in zip(sids, clips):
            eng.feed(sid, clip[:len(clip) // 2])
        ticks = sum(eng.tick(frames=frames) for _ in range(ENGINE["burst_ticks"]))
        for sid, clip in zip(sids, clips):
            eng.feed(sid, clip[len(clip) // 2:])
            eng.close(sid)
        ticks += eng.run_until_idle(frames=frames)
        feats = []
        for sid in sids:
            f, done = eng.poll(sid)
            if not done:
                fail(f"engine stream {sid} not finished")
            feats.append(f)
        return feats, ticks

    oracle = [lone(c) for c in clips]
    engine_launches = {k: 0 for k in ops.LAUNCHES}
    by_mode = {}
    for mode_name, frames in (("latency", 1), ("throughput", ENGINE["frames"])):
        eng = StreamingEngine(model, slots=ENGINE["slots"], mode="linear")
        ops.reset_launches()
        feats, ticks = serve(eng, clips, frames)
        torch.cuda.synchronize()
        run = dict(ops.LAUNCHES)
        for k in run:
            engine_launches[k] += run[k]
        want = ({"temporal_decode_pm_ragged": L * ticks, "temporal_append_pm_ragged": 0}
                if frames == 1 else
                {"temporal_decode_pm_ragged": 0, "temporal_append_pm_ragged": L * ticks})
        if any(run[k] != v for k, v in want.items()) or run["spatial_flat"] != L * ticks \
                or run["temporal_decode_pm"] or run["temporal_fullclip"]:
            fail(f"engine {mode_name} launches {run} over {ticks} ticks (L={L})")
        errs = [float(np.abs(f - o).max()) if f.shape == o.shape else float("inf")
                for f, o in zip(feats, oracle)]
        bitwise = all(np.array_equal(f, o) for f, o in zip(feats, oracle))
        if not max(errs) <= STREAM_TOL_POOLED:
            fail(f"engine {mode_name}: pooled vs lone streams max-abs {max(errs)} "
                 f"> {STREAM_TOL_POOLED}")
        by_mode[mode_name] = feats
        print(f"engine {mode_name} (tick frames={frames}), {len(clips)} streams of {lens} frames "
              f"over {ENGINE['slots']} slots, {ticks} ticks: pooled vs lone B=1 streams max-abs "
              f"{max(errs)} (<= {STREAM_TOL_POOLED}), bitwise {bitwise}; launches {run}")
    mode_err = max(float(np.abs(a - b).max())
                   for a, b in zip(by_mode["latency"], by_mode["throughput"]))
    if not mode_err <= STREAM_TOL_POOLED:
        fail(f"engine tick(frames={ENGINE['frames']}) vs tick(): max-abs {mode_err}")
    print(f"engine tick(frames={ENGINE['frames']}) vs tick(): max-abs {mode_err}")
    del eng

    # uint8 staging with on-device normalize against the host-normalized float feed
    raw = [rng.integers(0, 256, (n, 3, img, img), dtype=np.uint8) for n in lens[:4]]
    m_, s_ = (np.asarray(v, np.float32).reshape(1, 3, 1, 1) for v in (MEAN, STD))
    u8_feats, _ = serve(StreamingEngine(model, slots=ENGINE["slots"], mode="linear",
                                        stage_dtype="uint8", normalize=(MEAN, STD)), raw, 1)
    float_feats, _ = serve(StreamingEngine(model, slots=ENGINE["slots"], mode="linear"),
                           [(c.astype(np.float32) / 255.0 - m_) / s_ for c in raw], 1)
    u8_err = max(float(np.abs(a - b).max()) for a, b in zip(u8_feats, float_feats))
    if not u8_err <= STREAM_TOL_POOLED:
        fail(f"uint8-staged engine vs float feed: max-abs {u8_err}")
    print(f"engine uint8 staging + normalize vs float feed: max-abs {u8_err}")

    # ---- 9. the HTTP server: two clients over a socket
    srv = StreamingServer(model, slots=ENGINE["slots"], port=0, stage_dtype="uint8",
                          normalize=(MEAN, STD)).start()

    def request(method, path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=data,
                                     method=method, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    served, errors = {}, []

    def client(i):
        try:
            sid = request("POST", "/streams")["sid"]
            clip = raw[i]
            request("POST", f"/streams/{sid}/frames",
                    {"frames_b64": base64.b64encode(clip.tobytes()).decode(),
                     "shape": list(clip.shape), "dtype": "uint8"})
            request("POST", f"/streams/{sid}/close")
            acc, deadline = [], time.time() + 120
            while time.time() < deadline:
                r = request("GET", f"/streams/{sid}/features")
                acc.append(np.asarray(r["features"], np.float32).reshape(-1, d_))
                if r["done"]:
                    served[i] = np.concatenate(acc)
                    return
                time.sleep(0.01)
            errors.append(f"client {i}: stream {sid} never finished")
        except Exception as e:  # reported below: the phase fails
            errors.append(f"client {i}: {e!r}")

    try:
        health = request("GET", "/healthz")
        clients = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=180)
        health_after = request("GET", "/healthz")
    finally:
        srv.stop()
    if errors or len(served) != 2 or not health["ok"]:
        fail(f"server: {errors or served.keys()}, healthz {health}")
    srv_err = max(float(np.abs(served[i] - u8_feats[i]).max()) for i in range(2))
    if not srv_err <= STREAM_TOL_POOLED:
        fail(f"server features vs the engine's: max-abs {srv_err}")
    print(f"server: 2 clients, streams of {[len(raw[i]) for i in range(2)]} uint8 frames over "
          f"HTTP; features vs the engine max-abs {srv_err}; healthz {health} -> {health_after}")

    # ---- 10. engine frames/s at steady state, 8 slots, both tick modes
    cap_frames = cfg.cache_capacity
    pool = [rng.integers(0, 256, (cap_frames, 3, img, img), dtype=np.uint8) for _ in range(8)]

    def engine_run(frames, streams, mdl=model):
        """Serve ``streams`` streams of capacity-many frames, all fed up front,
        to the end; returns (seconds, ticks, frames served). The clock stops
        after the polls, which wait for the device."""
        eng = StreamingEngine(mdl, slots=ENGINE["slots"], mode="linear", stage_dtype="uint8",
                              normalize=(MEAN, STD))
        sids = []
        for i in range(streams):
            sid = eng.open()
            eng.feed(sid, pool[i % len(pool)])
            eng.close(sid)
            sids.append(sid)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ticks = eng.run_until_idle(frames=frames)
        n = sum(len(eng.poll(sid)[0]) for sid in sids)
        return time.perf_counter() - t0, ticks, n

    def engine_rates(mdl, tag):
        """Engine frames/s in both tick modes and the device busy share."""
        engine_run(1, ENGINE["slots"], mdl)  # warm-up
        engine_run(ENGINE["frames"], ENGINE["slots"], mdl)
        for mode_name, frames in (("latency", 1), ("throughput", ENGINE["frames"])):
            sec, ticks, n = engine_run(frames, THROUGHPUT_STREAMS, mdl)
            streams = 2 * ENGINE["slots"]  # two generations of streams, profiled
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                p_sec, p_ticks, _ = engine_run(frames, streams, mdl)
            rows = device_rows(prof)
            dev_ms = sum(e.device_time_total for e in rows) / p_ticks / 1e3
            tick_ms, wall_ms = sec * 1e3 / ticks, p_sec * 1e3 / p_ticks
            print(f"{tag}engine {mode_name} mode (tick frames={frames}) ({smi}): "
                  f"{n / sec:.1f} frames/s, {n} frames in {ticks} ticks, {tick_ms:.3f} ms/tick; "
                  f"{THROUGHPUT_STREAMS} streams of {cap_frames} uint8 frames over "
                  f"{ENGINE['slots']} slots (linear C={cap}, bf16); profile of {streams} streams, "
                  f"{p_ticks} ticks: device busy {dev_ms:.3f} ms/tick, "
                  f"{100 * dev_ms / wall_ms:.1f} % of the profiled {wall_ms:.3f} ms/tick, "
                  f"{100 * dev_ms / tick_ms:.1f} % of the unprofiled tick")
            if not tag and frames > 1:
                was = EARLIER_THROUGHPUT_TICK
                print(f"  beside the earlier kernel E (a warp a (row, head), copies around it; "
                      f"H100 80GB HBM3, 700 W): device busy {was['busy_ms'][0]}-"
                      f"{was['busy_ms'][1]} ms/tick, {was['frames_per_s'][0]}-"
                      f"{was['frames_per_s'][1]} frames/s; this run {dev_ms:.3f} ms/tick, "
                      f"{n / sec:.1f} frames/s")
            for e in sorted(rows, key=lambda e: -e.device_time_total)[:8]:
                print(f"  {e.device_time_total / p_ticks / 1e3:8.4f} ms/tick  "
                      f"x{e.count / p_ticks:<6.1f} {e.key[:90]}")

    engine_rates(model, "")

    def engine_tick_ms():
        sec, ticks, _ = engine_run(1, THROUGHPUT_STREAMS)
        return sec * 1e3 / ticks

    got10 = {False: [], True: []}
    for via_op in (False, True, True, False):
        ops._via_op = (lambda: True) if via_op else real_via_op
        try:
            got10[via_op].append(engine_tick_ms())
        finally:
            ops._via_op = real_via_op
    direct10, via10 = got10[False], got10[True]
    print(f"ops' dispatch, engine latency tick ({smi}): direct, op, op, direct: "
          f"{direct10[0]:.3f}, {via10[0]:.3f}, {via10[1]:.3f}, {direct10[1]:.3f} ms/tick: through "
          f"the ops {statistics.mean(via10) - statistics.mean(direct10):+.3f} ms/tick, spread of "
          f"the direct turns {abs(direct10[0] - direct10[1]):.3f} ms")

    # ---- 11. kernels F and G (int8 cache) against their plain versions
    from streamformer_tpu_torch.ops import quant

    r = b_ * n_

    def int8_operands(dtype, c_=cap):
        """A query, a new frame quantized by ``quantize_kv``, and an int8
        cache of c_ slots of random codes with per-(slot, row) scales."""
        g_ = gen if c_ == cap else gen64
        q = randn(r, d_, dtype=dtype, g=g_)
        new = (*encoder.quantize_kv(randn(r, d_, dtype=dtype, g=g_)),
               *encoder.quantize_kv(randn(r, d_, dtype=dtype, g=g_)))
        new = (new[0], new[2], new[1], new[3])  # k codes, v codes, k scales, v scales
        codes = torch.randint(-127, 128, (2, c_, r, d_), dtype=torch.int8, device=dev,
                              generator=g_)
        scales = 0.005 + 0.025 * torch.rand(2, c_, r, device=dev, generator=g_)
        return q, new, [codes[0].clone(), codes[1].clone(), scales[0].clone(), scales[1].clone()]

    def int8_bytes(elt, rows_read):
        """q and the output; the new codes in and the plane writes; the new
        scales in and their writes; each cached (slot, row) read: codes and
        two scales."""
        return elt * r * d_ * 2 + 2 * r * d_ * 2 + 4 * r * 2 * 2 + rows_read * (2 * d_ + 2 * 4)

    def dequantized_sdpa(q, cache, rows_len, dtype):
        """Yardstick: the new frame against the updated cache, dequantized to
        q's dtype, with the valid slots as the mask."""
        kd, vd = ((c.float() * s[..., None]).to(dtype) for c, s in ((cache[0], cache[2]),
                                                                    (cache[1], cache[3])))
        c_ = kd.shape[0]
        window = (torch.arange(c_, device=dev)[None] <= rows_len[:, None]).view(r, 1, 1, c_)
        q4 = q.view(r, h_, 1, dh)
        k4, v4 = (x.view(c_, r, h_, dh).permute(1, 2, 0, 3) for x in (kd, vd))
        return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=window)

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        elt = torch.finfo(dtype).bits // 8
        for mode, c_, length in DECODE_CASES:
            q, new, cache = int8_operands(dtype, c_)
            ref_cache = [c.clone() for c in cache]
            ln = torch.tensor(length, dtype=torch.int32, device=dev)
            ref = ops.temporal_decode_pm_int8_plain(q, *new, *ref_cache, ln, h_)
            got = ops.temporal_decode_pm_int8(q, *new, *cache, ln, h_)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(cache, ref_cache)):
                fail(f"temporal_decode_pm_int8 {mode} C={c_} {dn}: appended codes or scales "
                     "differ")
            n_read = min(length, c_) - (1 if length >= c_ else 0)
            record("temporal_decode_pm_int8", f"{mode} R={r} C={c_} len={length}", dn,
                   max_err(got, ref),
                   lambda: ops.temporal_decode_pm_int8(q, *new, *cache, ln, h_),
                   lambda: ops.temporal_decode_pm_int8_plain(q, *new, *cache, ln, h_),
                   dequantized_sdpa(q, cache, torch.full((r,), length, device=dev), dtype),
                   int8_bytes(elt, r * n_read), 4 * r * d_ * (n_read + 1))
        for mode, lens in D_LENS.items():
            q, new, cache = int8_operands(dtype)
            ref_cache = [c.clone() for c in cache]
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            ref = ops.temporal_decode_pm_int8_ragged_plain(q, *new, *ref_cache, ln, n_, h_)
            got = ops.temporal_decode_pm_int8_ragged(q, *new, *cache, ln, n_, h_)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(cache, ref_cache)):
                fail(f"temporal_decode_pm_int8_ragged {mode} {dn}: appended codes or scales "
                     "differ")
            n_read = sum(min(x, cap - 1) for x in lens)  # old slots attended, over streams
            record("temporal_decode_pm_int8_ragged", f"{mode} R={r} C={cap} lens={lens}", dn,
                   max_err(got, ref),
                   lambda: ops.temporal_decode_pm_int8_ragged(q, *new, *cache, ln, n_, h_),
                   lambda: ops.temporal_decode_pm_int8_ragged_plain(q, *new, *cache, ln, n_, h_),
                   dequantized_sdpa(q, cache, ln.long().repeat_interleave(n_), dtype),
                   int8_bytes(elt, n_ * n_read), 4 * d_ * n_ * (n_read + b_))
        del q, new, cache, ref_cache
    torch.cuda.synchronize()

    # ---- 12. lockstep int8 serving on the flagship model: kernel F
    def cosine(a, b):
        a, b = a.float().flatten(), b.float().flatten()
        return float(a @ b / (a.norm() * b.norm() + 1e-12))

    def int8_stream(mdl, what, gate):
        """16 frames on an int8 linear cache, each held to the bf16 full
        clip; returns the launches of the run."""
        cache = encoder.init_cache(cfg, b_, dtype="int8")
        ops.reset_launches()
        worst = 1.0
        for i in range(t_):
            out, cache = encoder.streaming_forward(mdl, video[:, i:i + 1], cache)
            c = cosine(out["pooler_output"], pooled[:, i:i + 1])
            worst = min(worst, c)
            if not (c > gate and finite(out)):
                fail(f"int8 stream ({what}) frame {i}: pooled cosine {c} to the bf16 full clip "
                     f"(> {gate})")
        torch.cuda.synchronize()
        run = dict(ops.LAUNCHES)
        if run != {**dict.fromkeys(ops.LAUNCHES, 0), "temporal_decode_pm_int8": L * t_,
                   "spatial_flat": L * t_}:
            fail(f"int8 stream ({what}) launches {run}")
        print(f"int8 linear stream, {what}, {t_} frames at batch {b_}: worst pooled cosine to the "
              f"bf16 full clip {worst} (> {gate}); launches {run}")
        return run

    int8_launches = int8_stream(model, "int8 cache, bf16 weights", INT8_CACHE_COS)
    q_model = quant.quantize_encoder(from_pretrained(ckpt, cfg.replace(cache_dtype="int8")))
    for k, v in int8_stream(q_model, "int8 cache, int8 weights", INT8_WEIGHTS_COS).items():
        int8_launches[k] += v
    ring_cfg = q_model.cfg.replace(cache_mode="ring")
    ring = encoder.init_cache(ring_cfg, b_)
    ops.reset_launches()
    for i in range(2 * cap):
        out, ring = encoder.streaming_forward(q_model, video[:, i % t_:i % t_ + 1], ring,
                                              cfg=ring_cfg)
        if not finite(out):
            fail(f"int8 ring frame {i}: outputs not finite")
    torch.cuda.synchronize()
    run = dict(ops.LAUNCHES)
    if run["temporal_decode_pm_int8"] != L * 2 * cap or run["temporal_decode_pm"]:
        fail(f"int8 ring launches {run} over {2 * cap} steps (L={L})")
    for k, v in run.items():
        int8_launches[k] += v
    q, new, _ = int8_operands(torch.bfloat16)
    layer0 = ring["layers"][0]
    cache = [layer0[k] for k in ("k", "v", "k_scale", "v_scale")]
    ref_cache = [c.clone() for c in cache]
    ref = ops.temporal_decode_pm_int8_plain(q, *new, *ref_cache, ring["len"], h_)
    got = ops.temporal_decode_pm_int8(q, *new, *cache, ring["len"], h_)
    ring_err = max_err(got, ref)
    if not (ring_err <= TOL["bfloat16"] and all(torch.equal(a, b)
                                                for a, b in zip(cache, ref_cache))):
        fail(f"int8 ring decode vs plain: max-abs {ring_err}")
    print(f"int8 ring stream (int8 weights) {2 * cap} frames at C={cap}: finite, F {L} times a "
          f"step; F vs plain on the ring cache (len={int(ring['len'])}): max-abs {ring_err}")
    steps = 32
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        encoder.streaming_forward(q_model, frame, ring, cfg=ring_cfg)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    print(f"int8 streaming encode, int8 weights and cache ({smi}): {b_ / step_s:.1f} frames/s at "
          f"batch {b_}, {step_s * 1e3:.3f} ms/step (int8 ring cache C={cap}, steady state)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            encoder.streaming_forward(q_model, frame, ring, cfg=ring_cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / window
    rows = device_rows(prof)
    busy = sum(e.device_time_total for e in rows) / window / 1e3
    print(f"int8 profile, {window} steady steps: device busy {busy:.3f} ms/step of {wall_ms:.3f} "
          f"(profiled wall clock)")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:12]:
        print(f"  {e.device_time_total / window / 1e3:8.4f} ms/step  x{e.count // window:<3d} "
              f"{e.key[:90]}")
    host = [e for e in prof.key_averages() if getattr(e, "self_cpu_time_total", 0) > 0]
    print("int8 profile, host time by operation:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"  {e.self_cpu_time_total / window / 1e3:8.4f} ms/step  x{e.count // window:<4d} "
              f"{e.key[:90]}")
    del ring, q, new, cache, ref_cache

    # ---- 13. the engine on an int8 cache: kernel G
    def cosines(feats, oracle):
        return [float((f * o).sum() / (np.linalg.norm(f) * np.linalg.norm(o) + 1e-12))
                if f.shape == o.shape else 0.0 for f, o in zip(feats, oracle)]

    def int8_engine(mdl, what, tol):
        """Phase 8's bursty streams in both tick modes against lone B=1
        streams of ``mdl``, pooled max-abs within ``tol``; launches added to
        ``int8_engine_launches``."""
        oracle = [lone(c, mdl) for c in clips]
        by_mode = {}
        for mode_name, frames in (("latency", 1), ("throughput", ENGINE["frames"])):
            eng = StreamingEngine(mdl, slots=ENGINE["slots"], mode="linear")
            ops.reset_launches()
            feats, ticks = serve(eng, clips, frames)
            torch.cuda.synchronize()
            run = dict(ops.LAUNCHES)
            for k in run:
                int8_engine_launches[k] += run[k]
            steps = eng.forwards  # an int8 tick is one t=1 step per frame of its fullest slot
            if run != {**dict.fromkeys(ops.LAUNCHES, 0),
                       "temporal_decode_pm_int8_ragged": L * steps, "spatial_flat": L * steps}:
                fail(f"int8 engine ({what}) {mode_name} launches {run} over {ticks} ticks, "
                     f"{steps} steps")
            err = max(float(np.abs(f - o).max()) if f.shape == o.shape else float("inf")
                      for f, o in zip(feats, oracle))
            cos = min(cosines(feats, oracle))
            if not err <= tol:
                fail(f"int8 engine ({what}) {mode_name}: pooled vs lone streams max-abs {err} "
                     f"> {tol} (worst cosine {cos})")
            by_mode[mode_name] = feats
            print(f"int8 engine ({what}) {mode_name} (tick frames={frames}), {len(clips)} streams "
                  f"over {ENGINE['slots']} slots, {ticks} ticks ({steps} steps): pooled vs lone "
                  f"B=1 streams max-abs {err} (<= {tol}), worst cosine {cos}; launches {run}")
        if not all(np.array_equal(a, b) for a, b in zip(by_mode["latency"],
                                                         by_mode["throughput"])):
            fail(f"int8 engine ({what}) tick(frames={ENGINE['frames']}) differs from tick()")
        print(f"int8 engine ({what}) tick(frames={ENGINE['frames']}) == tick() bit for bit")

    int8_engine_launches = dict.fromkeys(ops.LAUNCHES, 0)
    c8_model = from_pretrained(ckpt, cfg.replace(cache_dtype="int8"))  # bf16 weights
    int8_engine(c8_model, "int8 cache, bf16 weights", STREAM_TOL_POOLED)
    int8_engine(q_model, "int8 cache, int8 weights", INT8_WEIGHTS_ENGINE_TOL)
    engine_rates(c8_model, "int8-cache ")
    engine_rates(q_model, "int8-cache int8-weight ")

    # ---- 14. the backward kernels H and I against their plain versions
    del c8_model, q_model
    torch.cuda.empty_cache()

    def grads_err(got, ref):
        """Worst max-abs error over (dq, dk, dv), and the tolerance scale: the
        largest gradient magnitude where that exceeds 1."""
        err = max(max_err(a, b) for a, b in zip(got, ref))
        return err, max(1.0, *(b.float().abs().max().item() for b in ref))

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        elt = torch.finfo(dtype).bits // 8
        for name, kernel, plain, r, length, causal, flops in (
            ("temporal_fullclip_bwd", ops.temporal_fullclip_bwd, ops.temporal_fullclip_bwd_plain,
             b_ * n_, t_, True, 5 * t_ * (t_ + 1) * b_ * n_ * d_),
            ("spatial_flat_bwd", ops.spatial_flat_bwd, ops.spatial_flat_bwd_plain,
             b_ * t_, n_, False, 10 * b_ * t_ * n_ * n_ * d_),
        ):
            q, k, v, g = (randn(r, length, d_, dtype=dtype) for _ in range(4))
            got, again = kernel(q, k, v, g, h_), kernel(q, k, v, g, h_)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{name} {dn}: two runs on the same inputs differ")
            if causal:  # the packed entry: one (B, T, N, 3D) gradient, bit-equal to H's three
                def packed(x):
                    return x.view(b_, n_, t_, -1).transpose(1, 2)

                grad = ops.temporal_fullclip_qkv_bwd(
                    torch.cat([packed(x) for x in (q, k, v)], -1), packed(g).contiguous(), h_)
                if not all(torch.equal(packed(x), grad[..., i * d_:(i + 1) * d_])
                           for i, x in enumerate(got)):
                    fail(f"temporal_fullclip_qkv_bwd {dn}: differs from {name} on the same rows")
                print(f"temporal_fullclip_qkv_bwd {dn}: one (B, T, N, 3D) gradient bit-equal to "
                      f"{name}'s three")
                del grad
            err, scale = grads_err(got, plain(q, k, v, g, h_))
            # yardstick: the backward of one SDPA call, on a graph built once
            qh, kh, vh = (x.view(r, length, h_, dh).transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            gh = g.view(r, length, h_, dh).transpose(1, 2)
            out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
            record(name, f"R={r} {'T' if causal else 'N'}={length}", dn, err,
                   lambda: kernel(q, k, v, g, h_), lambda: plain(q, k, v, g, h_),
                   lambda: torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True),
                   7 * elt * r * length * d_, flops, tol=TOL[dn] * scale)
            del q, k, v, g, got, again, qh, kh, vh, gh, out
    torch.cuda.synchronize()

    # ---- 15. a small fp32 MultitaskModel: gradients on the card against the CPU's
    os.environ.setdefault("STREAMFORMER_ALLOW_HASH_TOKENIZER", "1")  # a dry run: no tokenizer files
    from streamformer_tpu_torch.models.multitask import MultitaskModel
    from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig
    from streamformer_tpu_torch.parallel.sharding import shard_model
    from streamformer_tpu_torch.train import optim
    from streamformer_tpu_torch.train.trainer import MultitaskTrainer, TrainState

    small_text = SiglipTextConfig(**SMALL_TEXT_CONFIG)
    mt_cpu = MultitaskModel(small, {}, small_text, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    open_gates(mt_cpu.backbone, 3)
    mt_card = MultitaskModel(small, {}, small_text)
    mt_card.load_state_dict(mt_cpu.state_dict())
    sb, st_, sn, sd_ = 2, small.num_frames, small.num_patches, small.hidden_size
    srng = np.random.default_rng(4)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    def small_batch(kind):
        f = lambda *shape: srng.standard_normal(shape).astype(np.float32)  # noqa: E731
        captions = srng.integers(0, small_text.vocab_size, (sb, 16)).astype(np.int32)
        return {
            "classification": {"label_embeddings": unit(f(5, sd_)),
                               "label": srng.integers(0, 5, sb)},
            "retrieval": {"caption_ids": captions},
            "grounding": {"caption_ids": captions,
                          "label": srng.integers(0, 2, (sb, st_)).astype(np.float32)},
            "universal_localization": {"label_embeddings": unit(f(sb, 5, sd_)),
                                       "class_mask": np.ones((sb, 5), bool),
                                       "label": srng.integers(-1, 5, (sb, st_))},
            "naive_localization": {"label_embeddings": f(5, sd_),
                                   "target_labels": srng.integers(-1, 2, (1, sb * st_, 5))
                                   .astype(np.float32)},
            "vis": {"label_embeddings": unit(f(sb, 5, sd_)), "class_mask": np.ones((sb, 5), bool),
                    "mask_target": srng.integers(-1, 5, (sb, st_, 12, 12))},
            "refervos": {"caption_ids": captions,
                         "mask_target": srng.integers(-1, 2, (sb, st_, 12, 12))},
        }[kind]

    def loss_and_grads(mdl, task, px, ti):
        mdl.zero_grad(set_to_none=True)
        loss, _ = mdl.loss_fn(task, px, ti)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in mdl.named_parameters()
                             if p.grad is not None}

    small_launches = dict.fromkeys(ops.LAUNCHES, 0)
    worst_rel = 0.0
    small_tasks = (("Kinetics", "classification"), ("TaskRetrieval", "retrieval"),
                   ("CharadesSTA", "grounding"), ("TaskLocalization", "universal_localization"),
                   ("THUMOS14", "naive_localization"), ("YoutubeVIS", "vis"), ("MEVIS", "refervos"))
    for task, kind in small_tasks:
        px = srng.standard_normal((sb, st_, 3, small.image_size, small.image_size)).astype(np.float32)
        ti = small_batch(kind)
        ref_loss, ref = loss_and_grads(mt_cpu, task, px, ti)
        ops.reset_launches()
        got_loss, got = loss_and_grads(mt_card, task, px, ti)
        _, again = loss_and_grads(mt_card, task, px, ti)
        torch.cuda.synchronize()
        for k, v in ops.LAUNCHES.items():
            small_launches[k] += v
        if got.keys() != ref.keys() or not abs(got_loss - ref_loss) <= 1e-4 * max(1, abs(ref_loss)):
            fail(f"small {task}: loss {got_loss} on the card, {ref_loss} on the CPU; "
                 f"leaves {len(got)} vs {len(ref)}")
        top = max(v.abs().max().item() for v in ref.values())
        for leaf, want in ref.items():
            # a leaf whose gradient is rounding noise is held to 1 % of the largest leaf's scale
            leaf_tol = GRAD_CARD_VS_CPU_TOL * max(want.abs().max().item(), 1e-2 * top)
            err = max_err(got[leaf], want)
            worst_rel = max(worst_rel, err / (leaf_tol / GRAD_CARD_VS_CPU_TOL))
            if not err <= leaf_tol:
                fail(f"small {task}: gradient of {leaf} differs from the CPU's by {err} "
                     f"(> {leaf_tol})")
            if not torch.equal(got[leaf], again[leaf]):
                fail(f"small {task}: gradient of {leaf} differs between two runs on the card")
    sl = small.num_hidden_layers
    want = {**dict.fromkeys(ops.LAUNCHES, 0), "spatial_flat": 2 * 7 * sl,
            "temporal_fullclip": 2 * 7 * sl, "spatial_flat_bwd": 2 * 7 * sl,
            "temporal_fullclip_bwd": 2 * 7 * sl}
    if small_launches != want:
        fail(f"small multitask launches {small_launches}")
    print(f"small fp32 MultitaskModel, {len(small_tasks)} task kinds, card vs CPU: every gradient "
          f"leaf within {GRAD_CARD_VS_CPU_TOL} of its scale (worst {worst_rel:.2e}), two runs on "
          f"the card bit-equal; launches {small_launches}")
    del mt_cpu, mt_card

    # ---- 16. the training path at full width
    tr = TRAIN
    tb = tr["batch"]
    train_tasks = {
        "Kinetics": {"label2id": {f"action {i}": i for i in range(tr["classes"])}},
        "YoutubeVIS": {"label2id": {"ytvis": {f"object {i}": i for i in range(tr["vis_classes"])}}},
    }
    train_cfg = StreamformerConfig(**FLAGSHIP_CONFIG)
    text_cfg = SiglipTextConfig(hidden_size=train_cfg.hidden_size, **TRAIN_TEXT_CONFIG)

    def make_trainer(remat, mesh=None):
        """A seeded model (the same weights every time), its optimizer,
        trainer and state; over ``mesh``, sharded on its model dim first."""
        mdl = MultitaskModel(train_cfg.replace(remat=remat), train_tasks, text_cfg,
                             generator=torch.Generator().manual_seed(5))
        open_gates(mdl.backbone, 5)
        shard_model(mdl, mesh)
        lr = optim.cosine_lr_schedule(tr["base_lr"], tr["min_lr"], epochs=1,
                                      steps_per_epoch=tr["updates"],
                                      warmup_steps=tr["warmup_steps"])
        tx = optim.create_optimizer(mdl, lr, weight_decay=tr["weight_decay"],
                                    clip_grad=tr["clip_grad"], layer_decay=tr["layer_decay"],
                                    num_layers=train_cfg.num_hidden_layers,
                                    trainable_mask=optim.trainable_mask_frozen_text(mdl))
        return mdl, lr, MultitaskTrainer(mdl, tx, update_freq=tr["update_freq"], mesh=mesh), \
            TrainState.create(mdl, tx)

    class LossLog:
        """A log writer that keeps each micro-step's (task, loss) and lr."""

        def __init__(self):
            self.losses, self.lrs = [], []

        def set_step(self):
            pass

        def update(self, head="", **kw):
            if head == "loss":
                self.losses.extend(kw.items())
            elif head == "opt":
                self.lrs.append(kw["lr"])

    tmodel, lr_sched, trainer, state = make_trainer("none")
    if tmodel.device.type != dev.type:
        fail(f"MultitaskModel lives on {tmodel.device}")
    tmodel.prepare_for_multi_tasks()
    masters = {p.dtype for p in tmodel.parameters()}
    if masters != {torch.float32}:
        fail(f"master parameters are {masters}, not fp32")
    trng = np.random.default_rng(6)

    def clips():
        return torch.randn(tb, t_, 3, train_cfg.image_size, train_cfg.image_size, device=dev,
                           generator=gen)

    vis_table = tmodel.label_embeddings["YoutubeVIS"]["ytvis"]
    captions = tmodel.tokenize([f"a person does thing {i} and then stops" for i in range(tb)])
    one_round = [
        ("Kinetics", {"pixel_values": clips(), "task_input": {
            "label_embeddings": tmodel.label_embeddings["Kinetics"],
            "label": trng.integers(0, tr["classes"], tb)}}),
        ("CharadesSTA", {"pixel_values": clips(), "task_input": {
            "caption_ids": captions,
            "label": trng.integers(0, 2, (tb, t_)).astype(np.float32)}}),
        ("YoutubeVIS", {"pixel_values": clips(), "task_input": {
            "label_embeddings": vis_table[None].expand(tb, -1, -1),
            "class_mask": np.ones((tb, tr["vis_classes"]), bool),
            "mask_target": trng.integers(-1, tr["vis_classes"],
                                         (tb, t_, tr["mask_size"], tr["mask_size"]))}}),
    ]
    micro_steps = tr["update_freq"] * tr["updates"]
    stream = [one_round[i % 3] for i in range(micro_steps)]  # each batch comes back 4 times
    text_before = {n: p.detach().clone() for n, p in tmodel.text.named_parameters()}
    first_params = {n: p.detach().clone() for n, p in tmodel.backbone.named_parameters()}
    log = LossLog()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state, stats = trainer.train_one_epoch(state, iter(stream), 0,
                                           torch.Generator(device=dev).manual_seed(7),
                                           log_writer=log, lr_schedule=lr_sched, print_freq=4)
    torch.cuda.synchronize()
    first_epoch_s = time.perf_counter() - t0
    peak_plain = torch.cuda.max_memory_allocated()
    train_launches = dict(ops.LAUNCHES)
    want = {**dict.fromkeys(ops.LAUNCHES, 0),
            **dict.fromkeys(("spatial_flat", "temporal_fullclip", "spatial_flat_bwd",
                             "temporal_fullclip_bwd"), L * micro_steps)}
    if train_launches != want:
        fail(f"training launches {train_launches} over {micro_steps} micro-steps (L={L})")
    if state.step != tr["updates"] or len(log.losses) != micro_steps:
        fail(f"{state.step} updates and {len(log.losses)} logged losses, not {tr['updates']} and "
             f"{micro_steps}")
    if not all(np.isfinite(v) for _, v in log.losses):
        fail(f"training losses {log.losses}")
    by_task = {}
    for task, value in log.losses:
        by_task.setdefault(task, []).append(value)
    # the objective the accumulated updates descend: the three repeated batches together
    rounds = [sum(v for _, v in log.losses[i:i + 3]) for i in range(0, micro_steps, 3)]
    if not rounds[-1] < rounds[0]:
        fail(f"the loss over the three repeated batches did not fall: {rounds} ({by_task})")
    if not all(torch.equal(p, text_before[n]) for n, p in tmodel.text.named_parameters()):
        fail("the frozen text tower changed")
    moved = sum(not torch.equal(p, first_params[n]) for n, p in tmodel.backbone.named_parameters())
    if moved != len(first_params):
        fail(f"only {moved} of {len(first_params)} backbone parameters moved")
    print(f"training, flagship width ({smi}): {micro_steps} micro-steps of {tb} clips, "
          f"{state.step} AdamW updates (update_freq={tr['update_freq']}), bf16 compute over fp32 "
          f"masters; loss over the three repeated batches by round {rounds}, falling; by task "
          f"{json.dumps(by_task)}; lr {log.lrs[::tr['update_freq']]}; "
          f"grad norm (mean) {stats['grad_norm']:.4f}; text tower unchanged bit for bit; "
          f"launches {train_launches}; peak memory {peak_plain / 2**30:.2f} GiB; first epoch "
          f"{first_epoch_s:.1f} s")
    del text_before, first_params

    # ---- 17. training rate at steady state, and where a micro-step's time goes
    timed = [one_round[i % 3] for i in range(tr["timed_micro_steps"])]
    timed_log = LossLog()  # phase 24 holds its losses to these
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = trainer.train_one_epoch(state, iter(timed), 1,
                                       torch.Generator(device=dev).manual_seed(8),
                                       log_writer=timed_log, print_freq=len(timed))
    torch.cuda.synchronize()
    micro_s = (time.perf_counter() - t0) / len(timed)
    print(f"training rate ({smi}): {tb / micro_s:.2f} clips/s, {micro_s * 1e3:.2f} ms per "
          f"micro-step of {tb} clips ({len(timed)} micro-steps, {len(timed) // tr['update_freq']} "
          f"updates, steady state, bf16, no remat)")
    n_prof = tr["profiled_micro_steps"]
    profiled = [one_round[i % 3] for i in range(2 + n_prof)]  # the trainer skips the first two
    t0 = time.perf_counter()
    state, _ = trainer.train_one_epoch(state, iter(profiled), 2,
                                       torch.Generator(device=dev).manual_seed(9),
                                       print_freq=len(profiled), profile_steps=n_prof,
                                       profile_dir=os.path.join(root, "build", "train_profile"))
    torch.cuda.synchronize()
    rows = device_rows(trainer.last_profile)
    busy = sum(e.device_time_total for e in rows) / n_prof / 1e3
    # the kernels' symbols (csrc/): I's and H's before B's and C's, which
    # their names contain; bf16 B is spatial_flat_tc_kernel, fp32 B
    # spatial_flat_kernel
    groups = (("I spatial_flat_bwd", ("spatial_flat_bwd",)),
              ("H temporal_fullclip_bwd", ("temporal_fullclip_bwd",)),
              ("B spatial_flat", ("spatial_flat_tc_kernel", "spatial_flat_kernel")),
              ("C temporal_fullclip", ("temporal_fullclip_kernel",)),
              ("matmuls (cuBLAS, CUTLASS)", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
              ("optimizer (multi-tensor)", ("multi_tensor", "foreach", "adam")),
              ("layer norm", ("layer_norm", "LayerNorm")),
              ("reductions, softmax", ("reduce", "softmax", "Softmax")),
              ("copies and casts", ("Memcpy", "Memset", "copy", "Copy")),
              ("elementwise", ("elementwise", "Elementwise")))
    by_group = dict.fromkeys([g for g, _ in groups] + ["other"], 0.0)
    for e in rows:
        group = next((g for g, keys in groups if any(k in e.key for k in keys)), "other")
        by_group[group] += e.device_time_total / n_prof / 1e3
    missing = [g for g, _ in groups[:4] if by_group[g] <= 0]
    if missing:
        fail(f"training profile: no device time matched {missing}: a kernel symbol was renamed")
    print(f"training profile, {n_prof} micro-steps ({n_prof // tr['update_freq']} updates): device "
          f"busy {busy:.2f} ms per micro-step, {100 * busy / (micro_s * 1e3):.1f} % of the "
          f"unprofiled micro-step; {sum(e.count for e in rows) / n_prof:.0f} launches per "
          f"micro-step; device ms per micro-step by kind: "
          + json.dumps({g: round(v, 3) for g, v in by_group.items()}))
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:14]:
        print(f"  {e.device_time_total / n_prof / 1e3:8.4f} ms/micro-step  "
              f"x{e.count / n_prof:<6.1f} {e.key[:90]}")
    del tmodel, trainer, state, stream, timed, profiled
    torch.cuda.empty_cache()

    # ---- 16 again, with remat="layer": the same losses, a smaller peak
    rmodel, r_sched, r_trainer, r_state = make_trainer("layer")
    r_log = LossLog()
    r_steps = tr["remat_micro_steps"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    r_state, _ = r_trainer.train_one_epoch(r_state, iter([one_round[i % 3] for i in range(r_steps)]),
                                           0, torch.Generator(device=dev).manual_seed(7),
                                           log_writer=r_log, lr_schedule=r_sched, print_freq=r_steps)
    torch.cuda.synchronize()
    remat_s = (time.perf_counter() - t0) / r_steps
    peak_remat = torch.cuda.max_memory_allocated()
    remat_launches = dict(ops.LAUNCHES)
    want = {**dict.fromkeys(ops.LAUNCHES, 0), "spatial_flat": 2 * L * r_steps,
            "temporal_fullclip": 2 * L * r_steps, "spatial_flat_bwd": L * r_steps,
            "temporal_fullclip_bwd": L * r_steps}
    if remat_launches != want:
        fail(f"remat training launches {remat_launches} over {r_steps} micro-steps (L={L})")
    remat_diff = max(abs(a[1] - b[1]) / max(abs(b[1]), 1e-6)
                     for a, b in zip(r_log.losses, log.losses[:r_steps]))
    if len(r_log.losses) != r_steps or not remat_diff <= REMAT_LOSS_TOL:
        fail(f"remat losses {r_log.losses} differ from {log.losses[:r_steps]} by {remat_diff} "
             f"(relative, > {REMAT_LOSS_TOL})")
    print(f"training with remat=\"layer\" ({smi}): {r_steps} micro-steps, losses within "
          f"{remat_diff:.2e} (relative) of the run without; launches {remat_launches}; peak "
          f"memory {peak_remat / 2**30:.2f} GiB against {peak_plain / 2**30:.2f} GiB without; "
          f"{remat_s * 1e3:.2f} ms per micro-step (the first {r_steps} of a run, warm-up included)")
    for k in train_launches:
        train_launches[k] += remat_launches[k]
    del rmodel, r_trainer, r_state  # one_round stays for phase 24
    torch.cuda.empty_cache()

    # ---- 18. kernels J and K (the row-major cache) against their plain versions
    zeros = dict.fromkeys(ops.LAUNCHES, 0)

    def add(acc, run):
        for k_, v_ in run.items():
            acc[k_] += v_

    r = b_ * n_
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        elt = torch.finfo(dtype).bits // 8
        for length in RM_LENS:
            ln = torch.tensor(length, dtype=torch.int32, device=dev)
            window = (torch.arange(cap, device=dev) <= length).view(1, cap)  # after the write
            q, kn, vn = (randn(r, d_, dtype=dtype) for _ in range(3))
            kc, vc = randn(r, cap, d_, dtype=dtype), randn(r, cap, d_, dtype=dtype)
            k_ref, v_ref = kc.clone(), vc.clone()
            ref = ops.temporal_decode_rm_plain(q, kn, vn, k_ref, v_ref, ln, h_)
            got = ops.temporal_decode_rm(q, kn, vn, kc, vc, ln, h_)
            torch.cuda.synchronize()
            if not (torch.equal(kc, k_ref) and torch.equal(vc, v_ref)):
                fail(f"temporal_decode_rm len={length} {dn}: written cache rows differ")
            q4 = q.view(r, h_, 1, dh)
            k4, v4 = (x.view(r, cap, h_, dh).transpose(1, 2) for x in (kc, vc))
            record("temporal_decode_rm", f"R={r} C={cap} len={length}", dn, max_err(got, ref),
                   lambda: ops.temporal_decode_rm(q, kn, vn, kc, vc, ln, h_),
                   lambda: ops.temporal_decode_rm_plain(q, kn, vn, kc, vc, ln, h_),
                   lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=window),
                   elt * r * d_ * (3 + 1 + 2 * length + 2), 4 * r * d_ * (length + 1))
            # K: the cache already holds the new frame; int8 codes and their
            # per-(row, position, head) scales from one quantize, or float
            kf, vf = randn(r, cap, d_, dtype=torch.float32), randn(r, cap, d_, dtype=torch.float32)
            for mode in ("int8", "float"):
                if mode == "int8":
                    (kq, ks), (vq, vs) = (encoder.quantize_kv_heads(x, h_) for x in (kf, vf))
                    args = (kq, vq, ks, vs)
                    kd, vd = (encoder.dequantize_kv(c.view(r, cap, h_, dh), s_, dtype)
                              .view(r, cap, d_) for c, s_ in ((kq, ks), (vq, vs)))
                    nbytes = elt * r * d_ * 2 + 2 * r * (length + 1) * (d_ + 4 * h_)
                else:
                    args = (kf.to(dtype), vf.to(dtype), None, None)
                    kd, vd = args[:2]
                    nbytes = elt * r * d_ * 2 + 2 * elt * r * (length + 1) * d_
                before = [None if a is None else a.clone() for a in args]
                ref = ops.temporal_decode_rm_readonly_plain(q, *args, ln, h_)
                got = ops.temporal_decode_rm_readonly(q, *args, ln, h_)
                torch.cuda.synchronize()
                if not all(a is None or torch.equal(a, b) for a, b in zip(args, before)):
                    fail(f"temporal_decode_rm_readonly {mode} len={length} {dn} wrote its cache")
                k4, v4 = (x.view(r, cap, h_, dh).transpose(1, 2) for x in (kd, vd))
                record("temporal_decode_rm_readonly", f"{mode} R={r} C={cap} len={length}", dn,
                       max_err(got, ref),
                       lambda: ops.temporal_decode_rm_readonly(q, *args, ln, h_),
                       lambda: ops.temporal_decode_rm_readonly_plain(q, *args, ln, h_),
                       lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=window),
                       nbytes, 4 * r * d_ * (length + 1))
            del q, kn, vn, kc, vc, k_ref, v_ref, kf, vf, args, before, kd, vd, q4, k4, v4
    torch.cuda.synchronize()

    # ---- 19. row-major lockstep streams on the flagship model: kernels J and K
    rm_cfg = cfg.replace(cache_layout="row_major")
    rm_launches = dict(zeros)
    cache = encoder.init_cache(rm_cfg, b_)
    ops.reset_launches()
    rm_outs, worst_h, worst_p = [], 0.0, 0.0
    for i in range(t_):
        out, cache = encoder.streaming_forward(model, video[:, i:i + 1], cache, cfg=rm_cfg)
        eh = max_err(out["last_hidden_state"], hidden[:, i:i + 1])
        ep = max_err(out["pooler_output"], pooled[:, i:i + 1])
        worst_h, worst_p = max(worst_h, eh), max(worst_p, ep)
        if not (eh <= STREAM_TOL_HIDDEN and ep <= STREAM_TOL_POOLED):
            fail(f"row-major stream frame {i}: hidden err {eh}, pooled err {ep}")
        rm_outs.append(out)
    torch.cuda.synchronize()
    run = dict(ops.LAUNCHES)
    if run != {**zeros, "temporal_decode_rm": L * t_, "spatial_flat": L * t_}:
        fail(f"row-major stream launches {run}")
    add(rm_launches, run)
    pm_cache = encoder.init_cache(cfg, b_)
    for i in range(t_):
        out, pm_cache = encoder.streaming_forward(model, video[:, i:i + 1], pm_cache)
        if not all(torch.equal(out[k], rm_outs[i][k]) for k in out):
            fail(f"row-major stream frame {i} differs from the pos-major stream")
    print(f"row-major linear stream {t_} frames at batch {b_} == full clip: max err hidden "
          f"{worst_h} (<= {STREAM_TOL_HIDDEN}), pooled {worst_p} (<= {STREAM_TOL_POOLED}); bit for "
          f"bit equal to the pos-major stream; launches {run}")
    del rm_outs, pm_cache, cache
    cache = encoder.init_cache(rm_cfg, b_, dtype="int8")
    ops.reset_launches()
    worst = 1.0
    for i in range(t_):
        out, cache = encoder.streaming_forward(model, video[:, i:i + 1], cache, cfg=rm_cfg)
        c = cosine(out["pooler_output"], pooled[:, i:i + 1])
        worst = min(worst, c)
        if not (c > INT8_CACHE_COS and finite(out)):
            fail(f"row-major int8 stream frame {i}: pooled cosine {c} (> {INT8_CACHE_COS})")
    torch.cuda.synchronize()
    run = dict(ops.LAUNCHES)
    if run != {**zeros, "temporal_decode_rm_readonly": L * t_, "spatial_flat": L * t_}:
        fail(f"row-major int8 stream launches {run}")
    add(rm_launches, run)
    print(f"row-major int8 linear stream, {t_} frames at batch {b_}: worst pooled cosine to the "
          f"bf16 full clip {worst} (> {INT8_CACHE_COS}); launches {run}")
    del cache
    rm_ring_cfg, pm_ring_cfg = rm_cfg.replace(cache_mode="ring"), cfg.replace(cache_mode="ring")

    def ring_gap(frames):
        """Pooled max-abs between a row-major and a pos-major ring stream of
        2C frames of ``frames`` (B, T, ...), taken in turn (frame i % T)."""
        rm_ring = encoder.init_cache(rm_ring_cfg, b_, capacity=RING_CAPACITY)
        pm_ring = encoder.init_cache(pm_ring_cfg, b_, capacity=RING_CAPACITY)
        worst = 0.0
        for i in range(2 * RING_CAPACITY):
            frame_i = frames[:, i % t_:i % t_ + 1]
            rm_out, rm_ring = encoder.streaming_forward(model, frame_i, rm_ring, cfg=rm_ring_cfg)
            pm_out, pm_ring = encoder.streaming_forward(model, frame_i, pm_ring, cfg=pm_ring_cfg)
            worst = max(worst, max_err(rm_out["pooler_output"], pm_out["pooler_output"]))
        return worst

    ops.reset_launches()
    gaps = [ring_gap(video)]
    torch.cuda.synchronize()
    run = dict(ops.LAUNCHES)
    if run != {**zeros, "temporal_decode_pm": 2 * L * RING_CAPACITY,
               "temporal_decode_rm": 2 * L * RING_CAPACITY,
               "spatial_flat": 2 * 2 * L * RING_CAPACITY}:
        fail(f"ring streams launches {run}")
    add(rm_launches, run)
    for seed in GAP_SEEDS:
        gaps.append(ring_gap(torch.randn(video.shape, device=dev,
                                         generator=torch.Generator(device=dev).manual_seed(seed))))
    if not max(gaps) <= STREAM_TOL_POOLED:
        fail(f"row-major ring vs pos-major ring: pooled max-abs {gaps} > {STREAM_TOL_POOLED}")
    print(f"row-major ring (kernel J) vs pos-major ring (kernel A), {2 * RING_CAPACITY} frames "
          f"at C={RING_CAPACITY}: pooled max-abs {gaps[0]} "
          f"(<= {STREAM_TOL_POOLED}); on the inputs of seeds {list(GAP_SEEDS)}: {gaps[1:]}; "
          f"launches {run}")

    def stream_rate(c):
        """frames/s of a linear stream of T frames from an empty cache."""
        cache = encoder.init_cache(c, b_)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(t_):
            encoder.streaming_forward(model, video[:, i:i + 1], cache, cfg=c)
        torch.cuda.synchronize()
        return b_ * t_ / (time.perf_counter() - t0)

    rates = {"pos-major": [], "row-major": []}
    for name in ("pos-major", "row-major", "row-major", "pos-major"):
        rates[name].append(stream_rate(cfg if name == "pos-major" else rm_cfg))
    print(f"linear stream frames/s at batch {b_}, {t_} frames from an empty cache, C={cap}, bf16 "
          f"({smi}), in turns: " + json.dumps({k: [round(x, 1) for x in v] for k, v in rates.items()}))

    # ---- 20. multi-frame appends to the ring: A (float) and F (int8) once per frame
    ring_cfg8 = cfg.replace(cache_mode="ring")
    n_frames = 3 * RING_CAPACITY
    frames3c = video[:, [i % t_ for i in range(n_frames)]]
    chunk_launches = dict(zeros)
    for kind, cache_dtype, kernel in (("float", None, "temporal_decode_pm"),
                                      ("int8", "int8", "temporal_decode_pm_int8")):
        ring1 = encoder.init_cache(ring_cfg8, b_, capacity=RING_CAPACITY, dtype=cache_dtype)
        ref = torch.cat([encoder.streaming_forward(model, frames3c[:, i:i + 1], ring1,
                                                   cfg=ring_cfg8)[0]["pooler_output"]
                         for i in range(n_frames)], dim=1)
        for chunk in CHUNKS:
            ring = encoder.init_cache(ring_cfg8, b_, capacity=RING_CAPACITY, dtype=cache_dtype)
            worst = 0.0
            for lo in range(0, n_frames, chunk):
                ops.reset_launches()
                out, ring = encoder.streaming_forward(model, frames3c[:, lo:lo + chunk], ring,
                                                      cfg=ring_cfg8)
                torch.cuda.synchronize()
                run = dict(ops.LAUNCHES)
                if run != {**zeros, kernel: L * chunk, "spatial_flat": L}:
                    fail(f"{kind} ring chunk of {chunk} launches {run}")
                add(chunk_launches, run)
                worst = max(worst, max_err(out["pooler_output"], ref[:, lo:lo + chunk]))
            if not worst <= STREAM_TOL_POOLED:
                fail(f"{kind} ring in chunks of {chunk} vs t=1 steps: pooled max-abs {worst}")
            print(f"{kind} ring C={RING_CAPACITY}, {n_frames} frames in chunks of {chunk}: pooled "
                  f"max-abs {worst} to the t=1 ring stream (<= {STREAM_TOL_POOLED}); {kernel} "
                  f"{L} * {chunk} times a chunk")
        del ring1, ring, ref
    del frames3c

    # ---- 21. kernel L, head-split spatial attention, against its plain version
    l_launches = dict(zeros)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        elt = torch.finfo(dtype).bits // 8
        for rr, hh, nn, dd in L_SHAPES:
            q, k, v, g = (randn(rr, hh, nn, dd, dtype=dtype) for _ in range(4))
            # its entry point as a caller drives it: forward and gradient
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            ops.reset_launches()
            out = ops.spatial_attention(*leaves)
            out.backward(g)
            torch.cuda.synchronize()
            run = dict(ops.LAUNCHES)
            if run != {**zeros, "spatial_attention": 1}:
                fail(f"spatial_attention forward and gradient launches {run}")
            add(l_launches, run)
            plain = [x.clone().requires_grad_() for x in (q, k, v)]
            ref = ops.spatial_attention_plain(*plain)
            ref.backward(g)
            gerr, gscale = grads_err([x.grad for x in leaves], [x.grad for x in plain])
            if not gerr <= TOL[dn] * gscale:
                fail(f"spatial_attention gradient {dn}: max-abs {gerr} > {TOL[dn] * gscale}")
            print(f"spatial_attention gradient R={rr} {dn}: max-abs {gerr} to autograd of the "
                  "plain version")
            record("spatial_attention", f"R={rr} H={hh} N={nn} dh={dd}", dn,
                   max_err(out.detach(), ref.detach()),
                   lambda: ops.spatial_attention(q, k, v),
                   lambda: ops.spatial_attention_plain(q, k, v),
                   lambda: F.scaled_dot_product_attention(q, k, v),
                   4 * elt * rr * hh * nn * dd, 4 * rr * hh * nn * nn * dd)
            del q, k, v, g, leaves, plain, out, ref
    torch.cuda.synchronize()

    # ---- 22. the streaming consumers at full width: OAD extractor and vision tower
    from streamformer_tpu_torch.downstream.vision_tower import TimesformerVisionTower
    from streamformer_tpu_torch.extract import oad

    consumer_launches = dict(zeros)
    orng = np.random.default_rng(10)

    def uint8_video(n):
        return orng.integers(0, 256, (n, OAD["height"], OAD["width"], 3), dtype=np.uint8)

    ring16 = cfg.replace(cache_mode="ring")
    px = oad.preprocess_frames(uint8_video(OAD["frames"]), cfg.image_size)
    if px.device.type != dev.type or px.shape != (OAD["frames"], 3, cfg.image_size, cfg.image_size):
        fail(f"preprocess_frames gave {tuple(px.shape)} on {px.device}")
    padded = -(-OAD["frames"] // OAD["chunk"]) * OAD["chunk"]
    ops.reset_launches()
    feats = oad.extract_features_streaming(model, px, chunk=OAD["chunk"])
    torch.cuda.synchronize()
    run = dict(ops.LAUNCHES)
    if run != {**zeros, "temporal_decode_pm": L * padded, "spatial_flat": L * padded // OAD["chunk"]}:
        fail(f"OAD streaming launches {run}")
    add(consumer_launches, run)

    def oad_gap(clip, got):
        """Pooled max-abs of the streaming mode's features ``got`` to a t=1
        ring stream of the same preprocessed clip."""
        c1 = encoder.init_cache(ring16, 1)
        ref = np.stack([encoder.streaming_forward(model, clip[None, i:i + 1], c1, cfg=ring16)[0]
                        ["pooler_output"][0, 0].float().cpu().numpy()
                        for i in range(clip.shape[0])])
        return float(np.abs(got - ref).max())

    errs = [oad_gap(px, feats)]
    if feats.shape != (OAD["frames"], d_):
        fail(f"OAD streaming mode gave {feats.shape}")
    for seed in GAP_SEEDS:
        clip = oad.preprocess_frames(np.random.default_rng(seed).integers(
            0, 256, (OAD["frames"], OAD["height"], OAD["width"], 3), dtype=np.uint8),
            cfg.image_size)
        errs.append(oad_gap(clip, oad.extract_features_streaming(model, clip, chunk=OAD["chunk"])))
    if not max(errs) <= STREAM_TOL_POOLED:
        fail(f"OAD streaming mode: max-abs {errs} to the t=1 ring stream")
    print(f"OAD streaming mode, {OAD['frames']} uint8 frames of {OAD['height']}x{OAD['width']} "
          f"preprocessed on the card, chunks of {OAD['chunk']} on the ring C={cap}: pooled max-abs "
          f"{errs[0]} to a t=1 ring stream (<= {STREAM_TOL_POOLED}); on the clips of seeds "
          f"{list(GAP_SEEDS)}: {errs[1:]}; launches {run}")
    ops.reset_launches()
    win = oad.extract_features_windowed(model, px)
    torch.cuda.synchronize()
    run = dict(ops.LAUNCHES)
    if run != {**zeros, "spatial_flat": L, "temporal_fullclip": L}:
        fail(f"OAD windowed launches {run}")
    add(consumer_launches, run)
    starts = list(range(0, OAD["frames"] - 6 + 1, 4))
    batch = torch.stack([px[s_:s_ + 6] for s_ in starts]).to(torch.bfloat16)
    direct = encoder.model_forward(model, batch)["pooler_output"][:, -1].float().cpu().numpy()
    lone_w = max(float(np.abs(encoder.model_forward(model, batch[j:j + 1])["pooler_output"]
                              [0, -1].float().cpu().numpy() - win[j]).max())
                 for j in range(len(starts)))
    if not (np.array_equal(win, direct) and lone_w <= STREAM_TOL_POOLED):
        fail(f"OAD windowed mode: differs from model_forward (lone windows max-abs {lone_w})")
    print(f"OAD windowed mode, {len(starts)} windows of 6: equal to model_forward's last frames; "
          f"lone windows max-abs {lone_w}; launches {run}")
    blens = [int(x) for x in orng.integers(OAD["min_frames"], OAD["max_frames"] + 1, OAD["clips"])]
    bclips = [oad.preprocess_frames(uint8_video(n), cfg.image_size) for n in blens]
    want = [oad.extract_features_streaming(model, c, chunk=OAD["chunk"]) for c in bclips]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    got = oad.extract_features_batched(model, bclips, slots=ENGINE["slots"])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    run = dict(ops.LAUNCHES)
    if not (run["temporal_decode_pm_ragged"] > 0 and run["temporal_decode_pm_ragged"] % L == 0
            and run["temporal_decode_pm"] == 0 and run["temporal_append_pm_ragged"] == 0):
        fail(f"OAD batched launches {run}")
    add(consumer_launches, run)
    errs = [float(np.abs(g_ - w_).max()) if g_.shape == w_.shape else float("inf")
            for g_, w_ in zip(got, want)]
    if not max(errs) <= STREAM_TOL_POOLED:
        fail(f"OAD batched mode vs streaming mode: max-abs {max(errs)}")
    print(f"OAD batched mode ({smi}), {len(blens)} clips of {blens} frames over {ENGINE['slots']} "
          f"slots (ring C={cap}): max-abs {max(errs)} to the streaming mode (<= "
          f"{STREAM_TOL_POOLED}); {sum(blens) / sec:.1f} frames/s extracted ({sum(blens)} frames "
          f"in {sec:.3f} s, preprocessed clips on the card); launches {run}")
    want_tower = {"linear C=16": {"temporal_append_pm_ragged": 2 * L, "spatial_flat": 2 * L},
                  "linear C=64": {"temporal_append_pm_ragged": 3 * L, "spatial_flat": 3 * L},
                  "ring C=8": {"temporal_decode_pm": 24 * L, "spatial_flat": 3 * L}}
    for name, (capacity, mode, calls) in TOWER_CALLS.items():
        tcfg = cfg.replace(cache_capacity=capacity, cache_mode=mode, streaming_mode=True)
        tower = TimesformerVisionTower(model, cfg=tcfg)
        tpx = tower.preprocess(uint8_video(sum(calls)))[None]
        dcache = encoder.init_cache(tcfg, 1)
        direct = [encoder.streaming_forward(model, tpx[:, i:i + 1], dcache, cfg=tcfg,
                                            total_frames_hint=max(tcfg.num_frames, capacity))[0]
                  for i in range(sum(calls))]
        d_hidden = torch.cat([o["last_hidden_state"] for o in direct], dim=1)
        d_pooled = torch.cat([o["pooler_output"] for o in direct], dim=1)
        ops.reset_launches()
        lo, worst_h, worst_p, first = 0, 0.0, 0.0, None
        for t in calls:
            ctx = tower(tpx[:, lo:lo + t])
            lo += t
            first = ctx.clone() if first is None else first
            if ctx.shape != (1, min(lo, tower.context_length), n_, d_):
                fail(f"tower {name}: context {tuple(ctx.shape)} after {lo} frames")
            new = ctx[:, -t:]
            worst_h = max(worst_h, max_err(new, d_hidden[:, lo - t:lo]))
            worst_p = max(worst_p, max_err(encoder.map_pool(new, model.head, tcfg),
                                           d_pooled[:, lo - t:lo]))
        torch.cuda.synchronize()
        run = dict(ops.LAUNCHES)
        if run != {**zeros, **want_tower[name]}:
            fail(f"tower {name} launches {run}")
        add(consumer_launches, run)
        if not (worst_h <= STREAM_TOL_HIDDEN and worst_p <= STREAM_TOL_POOLED):
            fail(f"tower {name}: hidden {worst_h}, pooled {worst_p} from the direct stream")
        if tower(None) is not ctx:
            fail(f"tower {name}: forward(None) does not return the held context")
        tower.clear_cache()
        if not torch.equal(tower(tpx[:, :calls[0]]), first):
            fail(f"tower {name}: clear_cache did not restart the stream")
        print(f"vision tower {name}, calls of {list(calls)} frames: max err hidden {worst_h} "
              f"(<= {STREAM_TOL_HIDDEN}), pooled {worst_p} (<= {STREAM_TOL_POOLED}) to a direct "
              f"t=1 stream; context {tuple(ctx.shape)}; forward(None) and clear_cache hold; "
              f"launches {run}")
        del tower, dcache, direct, d_hidden, d_pooled
    torch.cuda.empty_cache()

    # ---- 23. the training entry point at full width: SigLIP init, the loader
    # with on-card augmentation, checkpoints and a resume after SIGTERM
    import shutil
    import signal
    import tempfile

    from streamformer_tpu_torch.checkpoint.siglip_init import init_from_siglip_dir
    from streamformer_tpu_torch.data import collate
    from streamformer_tpu_torch.data.datasets import MultiTaskDataset
    from streamformer_tpu_torch.train import checkpoint as ckpt_lib
    from streamformer_tpu_torch.train import run as train_run
    from streamformer_tpu_torch.train import trainer as trainer_mod

    en = ENTRY
    work = tempfile.mkdtemp(prefix="entry-", dir=os.path.join(root, "build"))
    try:
        # 23a. SigLIP init from a seeded random SigLIP-base state dict
        srng = torch.Generator(device=dev).manual_seed(23)
        d, m_ = cfg.hidden_size, cfg.intermediate_size

        def tower(prefix, n_layers):
            shapes = {}
            for i in range(n_layers):
                e = f"{prefix}encoder.layers.{i}."
                for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    shapes[f"{e}self_attn.{name}.weight"] = (d, d)
                    shapes[f"{e}self_attn.{name}.bias"] = (d,)
                for name in ("layer_norm1", "layer_norm2"):
                    shapes[f"{e}{name}.weight"], shapes[f"{e}{name}.bias"] = (d,), (d,)
                shapes[f"{e}mlp.fc1.weight"], shapes[f"{e}mlp.fc1.bias"] = (m_, d), (m_,)
                shapes[f"{e}mlp.fc2.weight"], shapes[f"{e}mlp.fc2.bias"] = (d, m_), (d,)
            return shapes

        v = "vision_model."
        shapes = {v + "embeddings.patch_embedding.weight": (d, 3, cfg.patch_size, cfg.patch_size),
                  v + "embeddings.patch_embedding.bias": (d,),
                  v + "embeddings.position_embedding.weight": (cfg.num_patches, d),
                  **tower(v, L), v + "post_layernorm.weight": (d,), v + "post_layernorm.bias": (d,),
                  v + "head.probe": (1, 1, d), v + "head.attention.in_proj_weight": (3 * d, d),
                  v + "head.attention.in_proj_bias": (3 * d,),
                  v + "head.attention.out_proj.weight": (d, d),
                  v + "head.attention.out_proj.bias": (d,), v + "head.layernorm.weight": (d,),
                  v + "head.layernorm.bias": (d,), v + "head.mlp.fc1.weight": (m_, d),
                  v + "head.mlp.fc1.bias": (m_,), v + "head.mlp.fc2.weight": (d, m_),
                  v + "head.mlp.fc2.bias": (d,),
                  "text_model.embeddings.token_embedding.weight": (SIGLIP_TEXT["vocab"], d),
                  "text_model.embeddings.position_embedding.weight": (SIGLIP_TEXT["positions"], d),
                  **tower("text_model.", en["text_layers"]),
                  "text_model.final_layer_norm.weight": (d,),
                  "text_model.final_layer_norm.bias": (d,), "text_model.head.weight": (d, d),
                  "text_model.head.bias": (d,), "logit_scale": (1,), "logit_bias": (1,)}
        siglip_sd = {}
        for name, shape in shapes.items():
            x = torch.randn(shape, device=dev, generator=srng)
            if "norm" in name and name.endswith("weight"):
                x = 1.0 + 0.1 * x
            elif name.endswith("probe"):
                pass
            else:
                x = 0.02 * x
            siglip_sd[name] = x.cpu()
        siglip_dir = os.path.join(work, "siglip")
        os.makedirs(siglip_dir)
        torch.save(siglip_sd, os.path.join(siglip_dir, "pytorch_model.bin"))
        n_siglip = sum(x.numel() for x in siglip_sd.values())
        del siglip_sd
        t0 = time.perf_counter()
        audit = os.path.join(work, "siglip_audit.json")
        enc_sd, text_sd, extras = init_from_siglip_dir(
            siglip_dir, cfg, generator=torch.Generator().manual_seed(24), audit_path=audit)
        init_s = time.perf_counter() - t0
        with open(audit) as f:
            audit_json = json.load(f)
        if "map_head" not in audit_json["loaded"] or len(audit_json["fresh_init"]) != L + 2:
            fail(f"siglip audit {audit_json}")
        if len(text_sd) != 2 + 16 * en["text_layers"] + 4 or set(extras) != {"logit_scale", "logit_bias"}:
            fail(f"siglip text tower of {len(text_sd)} leaves, extras {sorted(extras)}")
        sig_model = encoder.StreamformerEncoder(cfg)
        sig_model.load_state_dict(enc_sd)
        gates = [float(layer.temporal_attention_gating) for layer in sig_model.encoder.layer]
        if any(g != 0.0 for g in gates):
            fail(f"siglip init: gates {gates}")
        with torch.no_grad():
            sig_model.embeddings.time_embeddings.zero_()  # each frame at SigLIP's own
        sclip = torch.randn(1, en["siglip_frames"], 3, cfg.image_size, cfg.image_size, device=dev,
                            generator=srng)
        whole = encoder.model_forward(sig_model, sclip)
        sig_h = sig_p = 0.0
        for t in range(en["siglip_frames"]):
            alone = encoder.model_forward(sig_model, sclip[:, t:t + 1])
            sig_h = max(sig_h, max_err(whole["last_hidden_state"][:, t], alone["last_hidden_state"][:, 0]))
            sig_p = max(sig_p, max_err(whole["pooler_output"][:, t], alone["pooler_output"][:, 0]))
        if not (finite(whole) and sig_h <= STREAM_TOL_HIDDEN and sig_p <= STREAM_TOL_POOLED):
            fail(f"siglip init: the {en['siglip_frames']}-frame clip differs from each frame "
                 f"alone by {sig_h} hidden, {sig_p} pooled")
        print(f"siglip_init ({smi}): a seeded random SigLIP-base state dict ({n_siglip} values, "
              f"pytorch_model.bin) -> encoder and text tower in {init_s:.1f} s; gates 0; an "
              f"{en['siglip_frames']}-frame clip against each frame alone (time table zeroed): "
              f"hidden {sig_h} (<= {STREAM_TOL_HIDDEN}), pooled {sig_p} (<= {STREAM_TOL_POOLED})")
        backbone_dir = os.path.join(work, "backbone")
        cfg.save_pretrained(backbone_dir)
        torch.save(enc_sd, os.path.join(backbone_dir, "pytorch_model.bin"))
        del sig_model, whole, enc_sd, text_sd
        torch.cuda.empty_cache()

        # 23b. three in-memory tasks in the JAX datasets' task_input shapes
        drng = np.random.default_rng(25)
        n_clips = en["clips_per_task"]
        frames = drng.integers(0, 256, (3 * n_clips, cfg.num_frames, en["height"], en["width"], 3),
                               dtype=np.uint8)

        class InMemory:
            """A task of seeded uint8 clips held in memory (the card's machine
            has no cv2 to decode files with)."""

            def __init__(self, task_name, first, task_input):
                self.task_name, self.first, self.task_input = task_name, first, task_input

            def __len__(self):
                return n_clips

            def __getitem__(self, i):
                return {"task_name": self.task_name,
                        "task_input": {"frames": frames[self.first + i], **self.task_input(i)}}

        nf = cfg.num_frames
        grounding_labels = drng.integers(0, 2, (n_clips, nf)).astype(np.float32)
        masks = drng.integers(-1, en["vis_classes"], (n_clips, nf, en["mask_size"], en["mask_size"]))
        train_ds = MultiTaskDataset([
            InMemory("Kinetics", 0, lambda i: {"label": np.int64(i % en["classes"])}),
            InMemory("CharadesSTA", n_clips,
                     lambda i: {"caption": f"a person does thing {i} and then stops",
                                "label": grounding_labels[i]}),
            InMemory("YoutubeVIS", 2 * n_clips,
                     lambda i: {"mask_target": masks[i], "dataset": "ytvis",
                                "selected_classes": np.arange(en["vis_classes"])}),
        ])
        # the eval union (--eval_freq 1): a classification, a retrieval and a
        # grounding task, one eval batch each
        ne = en["eval_clips"]
        eval_frames = drng.integers(0, 256, (3 * ne, nf, en["height"], en["width"], 3),
                                    dtype=np.uint8)

        class EvalTask:
            def __init__(self, task_name, first, task_input):
                self.task_name, self.first, self.task_input = task_name, first, task_input

            def __len__(self):
                return ne

            def __getitem__(self, i):
                return {"task_name": self.task_name,
                        "task_input": {"frames": eval_frames[self.first + i],
                                       **self.task_input(i)}}

        eval_ds = MultiTaskDataset([
            EvalTask("Kinetics", 0, lambda i: {"label": np.int64(i % en["classes"])}),
            EvalTask("TaskRetrieval", ne, lambda i: {"caption": f"clip {i} shows event {i * 7}"}),
            EvalTask("CharadesSTA", 2 * ne,
                     lambda i: {"caption": f"a person does thing {i}",
                                "meta": {"times": np.arange(nf) * 0.5,
                                         "gt": (0.5 * (i % 4), 0.5 * (i % 4) + 3.0)}}),
        ])
        eval_batches = 3 * -(-ne // 8)  # evaluate_multitask's batches of 8, a task each
        mtc = {"Kinetics": {"label2id": {f"action {i}": i for i in range(en["classes"])}},
               "CharadesSTA": {"label2id": None},
               "YoutubeVIS": {"label2id": {"ytvis": {f"object {i}": i
                                                     for i in range(en["vis_classes"])}}}}
        micro_per_epoch = 3 * n_clips // en["batch"]

        def entry_args(out, extra=()):
            return train_run.get_args([*extra,
                "--metadata", "(in memory)", "--output_dir", out, "--model_path", backbone_dir,
                "--batch_size", str(en["batch"]), "--epochs", str(en["epochs"]),
                "--update_freq", str(en["update_freq"]), "--lr", str(en["lr"]),
                "--warmup_steps", "1", "--clip_grad", "1.0", "--layer_decay", "0.75",
                "--num_workers", "8", "--seed", "0", "--hidden_size", str(cfg.hidden_size),
                "--num_layers", str(L), "--num_heads", str(cfg.num_attention_heads),
                "--intermediate_size", str(cfg.intermediate_size),
                "--input_size", str(cfg.image_size), "--num_frames", str(cfg.num_frames),
                "--text_layers", str(en["text_layers"])])

        # the augmentation's device time per batch
        aug = collate.make_train_augment(cfg.image_size)
        aug_batch = torch.from_numpy(frames[:en["batch"]]).to(dev)
        aug(aug_batch, 0, 0, list(range(en["batch"])))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(1, 1 + en["aug_batches"]):
            aug_out = aug(aug_batch, 0, step, list(range(en["batch"])))
        torch.cuda.synchronize()
        aug_host_ms = (time.perf_counter() - t0) * 1e3 / en["aug_batches"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for step in range(1, 1 + en["aug_batches"]):  # the same batches again
                aug_out = aug(aug_batch, 0, step, list(range(en["batch"])))
            torch.cuda.synchronize()
        aug_rows = device_rows(prof)
        aug_ms = sum(e.device_time_total for e in aug_rows) / en["aug_batches"] / 1e3
        if not aug_rows or aug_out.shape != (en["batch"], nf, 3, cfg.image_size, cfg.image_size) \
                or not torch.isfinite(aug_out).all():
            fail(f"train augmentation: {tuple(aug_out.shape)}, {len(aug_rows)} device rows")
        top = sorted(aug_rows, key=lambda e: -e.device_time_total)[:6]
        print(f"train augmentation ({smi}): batch of {en['batch']} uint8 clips of {nf}x"
              f"{en['height']}x{en['width']} -> ({en['batch']}, {nf}, 3, {cfg.image_size}, "
              f"{cfg.image_size}) (RandAugment rand-m7-n4-mstd0.5-inc1, resized crop, flip, "
              f"normalize, erasing): device {aug_ms:.3f} ms per batch ({en['aug_batches']} profiled "
              f"batches), {aug_host_ms:.3f} ms a batch by the host clock to its end; "
              "largest: " + ", ".join(f"{e.key[:40]} {e.device_time_total / en['aug_batches'] / 1e3:.3f}"
                                      for e in top))
        del aug_batch, aug_out

        # 23c. the full run, uninterrupted, validating after each epoch
        # (--eval_freq 1); the eval's launches and seconds are read around
        # evaluate_multitask, which train() imports when it is called
        print("training entry point: the card's machine has no cv2, so train_run.train gets a "
              "MultiTaskDataset of in-memory clips instead of build_datasets' metadata reader")
        from streamformer_tpu_torch.eval import validate as validate_mod

        real_evaluate = validate_mod.evaluate_multitask
        evals = []

        def timed_evaluate(*a, **k):
            torch.cuda.synchronize()
            before, t_ev = dict(ops.LAUNCHES), time.perf_counter()
            res = real_evaluate(*a, **k)
            torch.cuda.synchronize()
            evals.append((time.perf_counter() - t_ev,
                          {n: ops.LAUNCHES[n] - before[n] for n in before}, res))
            return res

        args_a = entry_args(os.path.join(work, "whole"), ["--eval_freq", "1"])
        torch.cuda.synchronize()
        validate_mod.evaluate_multitask = timed_evaluate
        try:
            ops.reset_launches()
            t0 = time.perf_counter()
            state_a = train_run.train(args_a, train_ds, eval_ds, mtc)
            torch.cuda.synchronize()
        finally:
            validate_mod.evaluate_multitask = real_evaluate
        entry_s = time.perf_counter() - t0
        entry_launches = dict(ops.LAUNCHES)
        micro_total = en["epochs"] * micro_per_epoch
        eval_launches = {**zeros, "spatial_flat": L * eval_batches,
                         "temporal_fullclip": L * eval_batches}
        if len(evals) != en["epochs"] or any(e[1] != eval_launches for e in evals):
            fail(f"--eval_freq 1: {len(evals)} evals over {en['epochs']} epochs, launches "
                 f"{[e[1] for e in evals]}, not B and C L={L} times each of {eval_batches} "
                 "eval batches")
        want = {**zeros, **dict.fromkeys(("spatial_flat", "temporal_fullclip", "spatial_flat_bwd",
                                          "temporal_fullclip_bwd"), L * micro_total)}
        for kernel in ("spatial_flat", "temporal_fullclip"):
            want[kernel] += en["epochs"] * L * eval_batches
        if entry_launches != want:
            fail(f"training entry launches {entry_launches} over {micro_total} micro-steps and "
                 f"{en['epochs']} evals (L={L})")
        with open(os.path.join(args_a.output_dir, "log.txt")) as f:
            all_lines = [json.loads(line) for line in f]
        log_lines = [r for r in all_lines if "loss" in r]
        eval_lines = [r for r in all_lines if "loss" not in r]
        updates = micro_total // en["update_freq"]
        if state_a.step != updates or [r["epoch"] for r in log_lines] != [0, 1] or \
                not all(np.isfinite(r["loss"]) for r in log_lines):
            fail(f"training entry: {state_a.step} updates, log {log_lines}")
        eval_keys = {"eval_Kinetics_top1", "eval_Kinetics_top5", "eval_TaskRetrieval_v2t_R@1",
                     "eval_TaskRetrieval_t2v_R@1", "eval_CharadesSTA_mIoU"}
        if [r["epoch"] for r in eval_lines] != [0, 1] or \
                not all(eval_keys <= set(r) and all(np.isfinite(v) for v in r.values())
                        for r in eval_lines):
            fail(f"--eval_freq 1: log.txt's eval lines {eval_lines}")
        print(f"validation ({smi}): --eval_freq 1 over an in-memory eval union of {ne} clips each "
              f"of Kinetics, TaskRetrieval and CharadesSTA ({eval_batches} batches of 8 at "
              f"{nf}x{cfg.image_size}^2, bf16): {[round(e[0], 3) for e in evals]} s an epoch's "
              f"eval; B and C {L} times an eval batch ({evals[0][1]['spatial_flat']} and "
              f"{evals[0][1]['temporal_fullclip']} an eval); metrics by epoch "
              f"{[{k: round(v, 3) for k, v in r.items()} for r in eval_lines]}")
        if sorted(x for x in os.listdir(args_a.output_dir) if x.startswith("checkpoint")) != \
                ["checkpoint-0", "checkpoint-1"]:
            fail(f"training entry checkpoints {os.listdir(args_a.output_dir)}")
        steady = log_lines[-1]["epoch_time"] / micro_per_epoch
        print(f"training entry point ({smi}): {en['epochs']} epochs of {micro_per_epoch} "
              f"micro-steps of {en['batch']} clips (update_freq={en['update_freq']}, {state_a.step} "
              f"AdamW updates) from the SigLIP-initialised backbone (--model_path), the loader in "
              f"train mode: losses by epoch {[round(r['loss'], 4) for r in log_lines]}; launches "
              f"{entry_launches} ({L} a micro-step each); epoch 1: {steady * 1e3:.2f} ms per "
              f"micro-step, {en['batch'] / steady:.2f} clips/s with the loader in the loop, against "
              f"phase 17's {micro_s * 1e3:.2f} ms, {tb / micro_s:.2f} clips/s on pre-built batches "
              f"({100 * (steady / micro_s - 1):+.1f} %); epoch times "
              f"{[round(r['epoch_time'], 3) for r in log_lines]} s; whole call {entry_s:.1f} s")
        want_state = {k: v.detach().cpu().clone() for k, v in state_a.model.state_dict().items()}
        want_opt = {k: {f: x.detach().cpu().clone() for f, x in st.items()}
                    for k, st in state_a.optimizer.state_dict()["inner"]["state"].items()}
        want_count = state_a.optimizer.count
        del state_a
        shutil.rmtree(args_a.output_dir, ignore_errors=True)
        torch.cuda.empty_cache()

        # 23d. SIGTERM after the second update of epoch 1, then a fresh call resumes
        real_step_fn = trainer_mod.MultitaskTrainer.step_fn
        seen = {"updates": 0}
        per_epoch_updates = micro_per_epoch // en["update_freq"]

        def preempting_step_fn(self, task_name, apply_update):
            fn = real_step_fn(self, task_name, apply_update)

            def wrapped(st, *a):
                st, out = fn(st, *a)
                if apply_update and st.step > per_epoch_updates:
                    seen["updates"] += 1
                    if seen["updates"] == en["preempt_after_update"]:
                        signal.raise_signal(signal.SIGTERM)
                return st, out

            return wrapped

        args_b = entry_args(os.path.join(work, "cut"))
        trainer_mod.MultitaskTrainer.step_fn = preempting_step_fn
        try:
            ops.reset_launches()
            cut = train_run.train(args_b, train_ds, None, mtc)
        finally:
            trainer_mod.MultitaskTrainer.step_fn = real_step_fn
        cut_step = cut.step
        del cut
        torch.cuda.empty_cache()
        meta = ckpt_lib._load_flat(os.path.join(args_b.output_dir, "checkpoint-1"))
        cut_at = (int(meta["meta/epoch"]), int(meta["meta/micro"]), int(meta["meta/step"]))
        del meta
        want_cut = (1, en["preempt_after_update"] * en["update_freq"],
                    per_epoch_updates + en["preempt_after_update"])
        if cut_step != want_cut[2] or cut_at != want_cut:
            fail(f"preempted run: step {cut_step}, checkpoint (epoch, micro, step) {cut_at}, "
                 f"not {want_cut}")
        resumed = train_run.train(args_b, train_ds, None, mtc)
        torch.cuda.synchronize()
        resumed_launches = dict(ops.LAUNCHES)
        got_state = resumed.model.state_dict()
        got_opt = resumed.optimizer.state_dict()["inner"]["state"]
        diff = [k for k, x in want_state.items() if not torch.equal(got_state[k].cpu(), x)]
        diff += [f"optimizer {k}.{f}" for k, st in want_opt.items() for f, x in st.items()
                 if not torch.equal(got_opt[k][f].cpu(), x)]
        if diff or resumed.optimizer.count != want_count or got_opt.keys() != want_opt.keys():
            fail(f"the resumed run differs from the uninterrupted one: {diff[:8]} ({len(diff)}), "
                 f"count {resumed.optimizer.count} vs {want_count}")
        if resumed_launches["spatial_flat"] != L * micro_total:
            fail(f"preempted and resumed runs launched {resumed_launches}")
        print(f"preemption ({smi}): SIGTERM after update {en['preempt_after_update']} of epoch 1 -> "
              f"mid-epoch checkpoint (epoch, micro, step) {cut_at}; a fresh call resumed from it: "
              f"parameters ({len(want_state)} tensors), AdamW moments and update count "
              f"({want_count}) equal to the uninterrupted run's (which validated after each "
              f"epoch) bit for bit; launches of both calls "
              f"{resumed_launches}")
        del want_state, want_opt, got_state, got_opt

        # 23e. what a save costs: blocking and asynchronous
        timing_dir = os.path.join(work, "timing")
        t0 = time.perf_counter()
        path = ckpt_lib.save_checkpoint(timing_dir, 0, resumed.model, resumed.optimizer,
                                        step=resumed.step)
        block_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(dp, fn))
                         for dp, _, fns in os.walk(path) for fn in fns)
        t0 = time.perf_counter()
        ckpt_lib.save_checkpoint(timing_dir, 1, resumed.model, resumed.optimizer,
                                 step=resumed.step, block=False)
        async_s = time.perf_counter() - t0
        ckpt_lib.wait_for_checkpoints()
        async_total_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in resumed.model.parameters())
        n_trained = sum(p.numel() for p in resumed.optimizer.params())
        print(f"checkpoint ({smi}): {ckpt_bytes} bytes on disk ({ckpt_bytes / 2**30:.2f} GiB: "
              f"{n_params} fp32 parameters, AdamW moments of {n_trained}); save_checkpoint "
              f"returns after {block_s:.3f} s with block=True, {async_s:.3f} s with block=False "
              f"(the write committed {async_total_s:.3f} s after the call)")
        del resumed
        add(entry_launches, resumed_launches)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 24. distribution: the trainer over a (data, model) mesh on NCCL, and B, C, H and I
    # at the rank shape of model parallelism 2
    import socket

    import torch.distributed as dist
    from streamformer_tpu_torch.parallel import mesh as mesh_lib
    from streamformer_tpu_torch.train import trainer as trainer_lib

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mesh_lib.init_distributed(f"localhost:{port}", 1, 0)  # NCCL, world size 1
    try:
        if dist.get_backend() != "nccl":
            fail(f"the process group runs {dist.get_backend()}, not nccl")
        mesh = mesh_lib.make_mesh(1, 1)
        pmodel, p_sched, p_trainer, p_state = make_trainer("none", mesh)
        pmodel.prepare_for_multi_tasks()
        warm = [one_round[i % 3] for i in range(tr["update_freq"] * tr["updates"])]
        timed = [one_round[i % 3] for i in range(tr["timed_micro_steps"])]
        p_log = LossLog()
        ops.reset_launches()
        p_state, _ = p_trainer.train_one_epoch(p_state, iter(warm), 0,
                                               torch.Generator(device=dev).manual_seed(7),
                                               print_freq=4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_state, _ = p_trainer.train_one_epoch(p_state, iter(timed), 1,
                                               torch.Generator(device=dev).manual_seed(8),
                                               log_writer=p_log, print_freq=len(timed))
        torch.cuda.synchronize()
        mesh_micro_s = (time.perf_counter() - t0) / len(timed)
        dist_launches = dict(ops.LAUNCHES)
        want = {**dict.fromkeys(ops.LAUNCHES, 0),
                **dict.fromkeys(("spatial_flat", "temporal_fullclip", "spatial_flat_bwd",
                                 "temporal_fullclip_bwd"), L * (len(warm) + len(timed)))}
        if dist_launches != want:
            fail(f"mesh training launches {dist_launches}, not {want}")
        if p_log.losses != timed_log.losses:
            fail(f"mesh training losses {p_log.losses} differ from phase 17's "
                 f"{timed_log.losses}")
        # the update's gradient sync alone: the bucketed all-reduce of the fp32 buffer
        n_elem = p_state.flat.numel()
        n_buckets = len(p_state.flat.split(trainer_lib.BUCKET))
        syncs = 5
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(syncs):
                p_trainer._sync_gradients(p_state)
            torch.cuda.synchronize()
        sync_rows = device_rows(prof)
        sync_ms = sum(e.device_time_total for e in sync_rows) / syncs / 1e3
        t0 = time.perf_counter()
        for _ in range(syncs):
            p_trainer._sync_gradients(p_state)
        torch.cuda.synchronize()
        sync_wall_ms = (time.perf_counter() - t0) / syncs * 1e3
        print(f"distributed training ({smi}): mesh data=1 x model=1 over NCCL (world size 1), "
              f"{len(timed)} micro-steps after {len(warm)} of warm-up at "
              f"{mesh_micro_s * 1e3:.2f} ms per micro-step against phase 17's "
              f"{micro_s * 1e3:.2f} ({tb / mesh_micro_s:.2f} clips/s); losses equal to phase "
              f"17's bit for bit {p_log.losses}; launches {dist_launches}; gradient sync an "
              f"update: all-reduce of the fp32 buffer of {n_elem} elements "
              f"({4 * n_elem / 2**30:.3f} GiB) in {n_buckets} buckets, {sync_ms:.4f} device ms, "
              f"{sync_wall_ms:.3f} ms host clock ("
              + ", ".join(f"{e.key[:40]} x{e.count // syncs}" for e in sync_rows) + ")")
        del pmodel, p_trainer, p_state, warm, timed, one_round
        torch.cuda.empty_cache()
    finally:
        mesh_lib.shutdown()

    # B, C, H and I at the rank shape of mp=2: half the heads, the packed qkv of the
    # column-parallel projection (B, T, N, 3D / 2), read in place
    h_r, d_r = h_ // 2, d_ // 2
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        elt = torch.finfo(dtype).bits // 8
        qkv = randn(b_, t_, n_, 3 * d_r, dtype=dtype)
        g = randn(b_, t_, n_, d_r, dtype=dtype)
        tag = f"mp=2 rank qkv ({b_}, {t_}, {n_}, {3 * d_r}) H={h_r}"
        # C and H: the encoder's packed entries
        err = max_err(ops.temporal_fullclip_qkv(qkv, h_r),
                      ops.temporal_fullclip_qkv_plain(qkv, h_r))
        qh, kh, vh = (x.reshape(b_, t_, n_, h_r, dh).permute(0, 2, 3, 1, 4)
                      for x in qkv.split(d_r, dim=-1))
        record("temporal_fullclip", tag, dn, err, lambda: ops.temporal_fullclip_qkv(qkv, h_r),
               lambda: ops.temporal_fullclip_qkv_plain(qkv, h_r),
               lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
               4 * elt * b_ * t_ * n_ * d_r, 2 * t_ * (t_ + 1) * b_ * n_ * d_r)
        got = ops.temporal_fullclip_qkv_bwd(qkv, g, h_r)
        ref = ops.temporal_fullclip_qkv_bwd_plain(qkv, g, h_r)
        scale = max(1.0, ref.float().abs().max().item())
        qs, ks, vs = (x.detach().requires_grad_() for x in (qh, kh, vh))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        gs = g.reshape(b_, t_, n_, h_r, dh).permute(0, 2, 3, 1, 4)
        record("temporal_fullclip_bwd", tag, dn, max_err(got, ref),
               lambda: ops.temporal_fullclip_qkv_bwd(qkv, g, h_r),
               lambda: ops.temporal_fullclip_qkv_bwd_plain(qkv, g, h_r),
               lambda: torch.autograd.grad(out, (qs, ks, vs), gs, retain_graph=True),
               7 * elt * b_ * t_ * n_ * d_r, 5 * t_ * (t_ + 1) * b_ * n_ * d_r,
               tol=TOL[dn] * scale)
        del got, ref, qs, ks, vs, out, gs, qh, kh, vh
        # B and I: the encoder's (B*T, N, D / 2) rows of each third
        q, k, v = (qkv[..., i * d_r:(i + 1) * d_r].reshape(b_ * t_, n_, d_r).contiguous()
                   for i in range(3))
        gr = g.reshape(b_ * t_, n_, d_r)
        tag = f"mp=2 rank R={b_ * t_} N={n_} D={d_r} H={h_r}"
        qh, kh, vh = (x.view(b_ * t_, n_, h_r, dh).transpose(1, 2) for x in (q, k, v))
        record("spatial_flat", tag, dn, max_err(ops.spatial_flat(q, k, v, h_r),
                                                ops.spatial_flat_plain(q, k, v, h_r)),
               lambda: ops.spatial_flat(q, k, v, h_r), lambda: ops.spatial_flat_plain(q, k, v, h_r),
               lambda: F.scaled_dot_product_attention(qh, kh, vh),
               4 * elt * b_ * t_ * n_ * d_r, 4 * b_ * t_ * n_ * n_ * d_r)
        got = ops.spatial_flat_bwd(q, k, v, gr, h_r)
        ref = ops.spatial_flat_bwd_plain(q, k, v, gr, h_r)
        err = max(max_err(a, c) for a, c in zip(got, ref))
        scale = max(1.0, *(c.float().abs().max().item() for c in ref))
        qs, ks, vs = (x.detach().requires_grad_() for x in (qh, kh, vh))
        out = F.scaled_dot_product_attention(qs, ks, vs)
        gs = gr.view(b_ * t_, n_, h_r, dh).transpose(1, 2)
        record("spatial_flat_bwd", tag, dn, err, lambda: ops.spatial_flat_bwd(q, k, v, gr, h_r),
               lambda: ops.spatial_flat_bwd_plain(q, k, v, gr, h_r),
               lambda: torch.autograd.grad(out, (qs, ks, vs), gs, retain_graph=True),
               7 * elt * b_ * t_ * n_ * d_r, 10 * b_ * t_ * n_ * n_ * d_r, tol=TOL[dn] * scale)
        del qkv, g, q, k, v, gr, got, ref, qs, ks, vs, out, gs, qh, kh, vh
    torch.cuda.empty_cache()

    # ---- 25. a small fp32 LM and LlavaQwenModel on the card against the same on the CPU
    import copy

    from streamformer_tpu_torch.downstream import videoqa as VQ
    from streamformer_tpu_torch.downstream.vision_tower import TimesformerVisionTower
    from streamformer_tpu_torch.lm_serving import DecodeEngine
    from streamformer_tpu_torch.models import language_model as LM
    from streamformer_tpu_torch.ops import quant
    from streamformer_tpu_torch.server import VideoQAServer

    t_lm = time.perf_counter()
    lm_cfg = LM.LMConfig(**LM_SMALL)
    cpu_lm = LM.LanguageModel(lm_cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card_lm = LM.LanguageModel(lm_cfg, device=dev)
    card_lm.load_state_dict(cpu_lm.state_dict())
    q_cpu, q_card = (quant.quantize_lm(copy.deepcopy(m_), min_elements=0)
                     for m_ in (cpu_lm, card_lm))
    srng = np.random.default_rng(25)
    emb_s = torch.from_numpy(srng.standard_normal((3, 7, lm_cfg.hidden_size)).astype(np.float32))
    step_s = torch.from_numpy(srng.standard_normal((3, 1, lm_cfg.hidden_size)).astype(np.float32))
    worst_lm = {}
    for case, (m_cpu, m_card, cd, ragged) in {
            "lockstep": (cpu_lm, card_lm, None, False), "ragged": (cpu_lm, card_lm, None, True),
            "int8 KV": (cpu_lm, card_lm, "int8", True), "int4 KV": (cpu_lm, card_lm, "int4", True),
            "int8 weights": (q_cpu, q_card, None, True)}.items():
        outs = []
        for m_ in (m_cpu, m_card):
            c_ = LM.init_cache(lm_cfg, 3, 16, per_stream_len=ragged, cache_dtype=cd,
                               device=m_.device)
            o1, c_ = LM.forward(m_, emb_s.to(m_.device), cache=c_)
            if ragged:  # depths 7, 3 and 16 (an append clamped at the capacity edge)
                c_["len"] = torch.tensor([7, 3, 16], device=m_.device)
            o2, c_ = LM.forward(m_, step_s.to(m_.device), cache=c_)
            outs.append(torch.cat([o1["logits"], o2["logits"]], 1))
        worst_lm[case] = max_err(outs[0], outs[1])
        if not worst_lm[case] <= CARD_VS_CPU_TOL:
            fail(f"small LM {case}: card vs CPU logits max-abs {worst_lm[case]}")
    prompts_s = [srng.integers(0, lm_cfg.vocab_size, (n,)) for n in (3, 11, 20, 5, 8, 2)]
    engine_toks = []
    for m_ in (cpu_lm, card_lm):
        eng = DecodeEngine(m_, slots=3, capacity=32, max_new_tokens=6, prefill_buckets=(4, 8))
        sids = [eng.open_tokens(p) for p in prompts_s]
        eng.run_until_idle()
        engine_toks.append([eng.poll(s_)[0] for s_ in sids])
    if engine_toks[0] != engine_toks[1]:
        fail(f"small LM engine tokens differ: card {engine_toks[1]}, CPU {engine_toks[0]}")
    # the small LlavaQwenModel: SMALL_CONFIG's tower (B and C on the card), the projector, the LM
    scfg = StreamformerConfig(**SMALL_CONFIG)
    s_cpu = encoder.StreamformerEncoder(scfg, device="cpu",
                                        generator=torch.Generator().manual_seed(3))
    open_gates(s_cpu, 3)
    s_card = encoder.StreamformerEncoder(scfg, device=dev)
    s_card.load_state_dict(s_cpu.state_dict())
    p_cpu = VQ.init_mm_projector(scfg.hidden_size, lm_cfg.hidden_size, device="cpu",
                                 generator=torch.Generator().manual_seed(4))
    p_card = VQ.init_mm_projector(scfg.hidden_size, lm_cfg.hidden_size, device=dev)
    p_card.load_state_dict(p_cpu.state_dict())
    vq_px = torch.from_numpy(srng.standard_normal(
        (1, scfg.num_frames, 3, scfg.image_size, scfg.image_size)).astype(np.float32))
    vq_ids = np.array([3, VQ.IMAGE_TOKEN_INDEX, 9, 12, 40])
    vq_out = []
    for enc_, proj_, lm_ in ((s_cpu, p_cpu, cpu_lm), (s_card, p_card, card_lm)):
        vqm = VQ.LlavaQwenModel(TimesformerVisionTower(enc_, streaming_mode=False), lm_, proj_)
        vq_out.append((vqm.prompt_embeds(vq_ids, vq_px), vqm.generate(vq_ids, vq_px, 6)))
    vq_err = max_err(vq_out[0][0], vq_out[1][0])
    if not vq_err <= CARD_VS_CPU_TOL or not np.array_equal(vq_out[0][1], vq_out[1][1]):
        fail(f"small LlavaQwenModel card vs CPU: prompt embeds {vq_err}, tokens "
             f"{vq_out[1][1].tolist()} vs {vq_out[0][1].tolist()}")
    print(f"small fp32 LM ({LM_SMALL['num_hidden_layers']} layers, {lm_cfg.hidden_size} hidden, "
          f"GQA {lm_cfg.num_attention_heads}/{lm_cfg.num_key_value_heads}) card vs CPU logits "
          f"max-abs {worst_lm} (<= {CARD_VS_CPU_TOL}); engine tokens equal on both devices "
          f"({sum(map(len, engine_toks[1]))} tokens, 6 requests over 3 slots); small "
          f"LlavaQwenModel prompt embeds max-abs {vq_err}, generate {vq_out[1][1].tolist()} on "
          f"both ({time.perf_counter() - t_lm:.1f} s)")
    del cpu_lm, card_lm, q_cpu, q_card, s_cpu, s_card, p_cpu, p_card, vq_out

    # ---- 26. the Qwen2.5-7B-width LM at bf16 under DecodeEngine
    t26 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg7 = LM.LMConfig(**LM_7B)
    t0 = time.perf_counter()
    lm7 = LM.LanguageModel(cfg7, device=dev, generator=torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p_.numel() for p_ in lm7.parameters())
    # the bound of a decode step: every weight a step reads (all but the
    # embedding table, of which a step gathers S rows) once over the HBM rate
    weight_bytes = sum(p_.numel() * p_.element_size() for n_, p_ in lm7.named_parameters()
                       if "embed_tokens" not in n_)
    drng = np.random.default_rng(26)
    plens = drng.integers(DECODE["min_prompt"], DECODE["max_prompt"] + 1, DECODE["requests"])
    budgets = drng.integers(DECODE["min_new"], DECODE["max_new"] + 1, DECODE["requests"])
    d_prompts = [drng.integers(0, cfg7.vocab_size, (int(n_),)) for n_ in plens]

    def spy(eng):
        """Record the logits of every draw by (sid, n): the engine's _select
        sees them; tokens are drawn as before."""
        rows, orig = [], eng._select

        def select(logits, sids, counts):
            act = (eng._active_dev if sids is eng._sids_dev
                   else torch.ones(1, dtype=torch.bool, device=dev))
            rows.append((logits.clone(), sids.clone(), counts.clone(), act.clone()))
            return orig(logits, sids, counts)

        eng._select = select
        return rows

    def keyed(rows):
        out = {}
        for logits, sids, counts, act in rows:
            for i_, (s_, n_, a_) in enumerate(zip(sids.tolist(), counts.tolist(), act.tolist())):
                if a_:
                    out[(s_, n_)] = logits[i_]
        return out

    def serve(m_, **kw):
        """The traffic in bursts (slots recycle): tokens and the logits of
        each draw, by request."""
        eng = DecodeEngine(m_, slots=DECODE["slots"], capacity=DECODE["capacity"],
                           prefill_buckets=DECODE["buckets"], **kw)
        rows = spy(eng)
        sids, nxt = [], 0
        for burst in DECODE["bursts"]:
            for _ in range(burst):
                sids.append(eng.open_tokens(d_prompts[nxt], max_new_tokens=int(budgets[nxt])))
                nxt += 1
            for _ in range(DECODE["burst_ticks"]):
                eng.tick()
        eng.run_until_idle()
        toks = [eng.poll(s_)[0] for s_ in sids]
        torch.cuda.synchronize()
        return toks, keyed(rows), eng

    t0 = time.perf_counter()
    toks7, logits7, eng7 = serve(lm7)
    serve_s = time.perf_counter() - t0
    if [len(t_) for t_ in toks7] != budgets.tolist():
        fail(f"7B engine: token counts {[len(t_) for t_ in toks7]}, budgets {budgets.tolist()}")
    def greedy_check(m_, toks, logits, label, cache_dtype=None):
        """Each request against one B=1 forward over its prompt and tokens
        (through a cache of ``cache_dtype`` when the engine's is quantized,
        none when it is float). A position is decided where the lone
        top-1/top-2 margin exceeds the largest |logit difference| between
        the two; every decided position must match. The float engine must
        have GREEDY_DECIDED_MIN of its positions decided; a quantized one's
        share is reported (a code on a rounding edge of another GEMM shape
        takes a whole step, int4's a seventh of the absmax, and 28 random
        layers amplify it)."""
        deltas, margins, agree = [], [], []
        for r_, (ids_, t_) in enumerate(zip(d_prompts, toks)):
            seq = torch.tensor(np.concatenate([ids_, t_[:-1]]), device=dev)[None]
            c_ = (None if cache_dtype is None else
                  LM.init_cache(m_.cfg, 1, seq.shape[1], cache_dtype=cache_dtype, device=dev))
            lone_out, _ = LM.forward(m_, LM.embed_tokens(m_, seq), cache=c_)
            lone = lone_out["logits"][0, len(ids_) - 1:]
            mine = torch.stack([logits[(r_, n_)] for n_ in range(len(t_))])
            deltas.append((mine - lone).abs().amax(-1))
            top2 = lone.topk(2, -1).values
            margins.append(top2[:, 0] - top2[:, 1])
            agree.append(lone.argmax(-1) == torch.tensor(t_, device=dev))
            del lone_out, lone, mine, c_
        deltas, margins, agree = (torch.cat(x_).cpu() for x_ in (deltas, margins, agree))
        delta_max = deltas.max().item()
        decided = margins > delta_max
        if not bool(agree[decided].all()):
            fail(f"7B engine, {label}: {int((~agree[decided]).sum())} decided positions differ "
                 f"from the lone forward (largest |dlogit| {delta_max})")
        result = (round(delta_max, 4), round(decided.float().mean().item(), 3),
                  round(agree.float().mean().item(), 3), len(agree))
        print(f"greedy check {label} (largest |dlogit| to the lone forward, share of positions "
              f"decided, share equal, positions): {result}")
        if label == "bf16" and decided.float().mean().item() < GREEDY_DECIDED_MIN:
            fail(f"7B engine, {label}: only {decided.float().mean().item():.3f} of the positions "
                 f"decided (largest |dlogit| {delta_max}): the engine's logits are not the lone "
                 "forward's")
        return result

    greedy = {"bf16": greedy_check(lm7, toks7, logits7, "bf16")}
    # k-step ticks
    toks_k4, _, eng_k4 = serve(lm7, decode_steps_per_tick=4)
    if toks_k4 != toks7 or not eng_k4.stats["decode_by_k"].get(4):
        fail(f"7B engine: decode_steps_per_tick=4 tokens differ from k=1 "
             f"({eng_k4.stats['decode_by_k']})")

    def pooled_cosine(ref, other):
        """Cosine of the pooled logits of the draws whose earlier tokens
        agree between two engines' runs of the traffic; the share of tokens
        equal."""
        (toks_r, logits_r), (toks_o, logits_o) = ref[:2], other[:2]
        a_, b_, same, total = [], [], 0, 0
        for r_, (t_ref, t_o) in enumerate(zip(toks_r, toks_o)):
            for n_ in range(min(len(t_ref), len(t_o))):
                a_.append(logits_r[(r_, n_)])
                b_.append(logits_o[(r_, n_)])
                if t_ref[n_] != t_o[n_]:
                    break
            same += sum(x_ == y_ for x_, y_ in zip(t_ref, t_o))
            total += len(t_ref)
        a_, b_ = torch.stack(a_).double().ravel(), torch.stack(b_).double().ravel()
        return round((a_ @ b_ / (a_.norm() * b_.norm())).item(), 6), round(same / total, 3)

    class depth_cut:
        """The LM's first n layers, at its widths (the depth the JAX tests set
        their gates at), for the length of a with-block."""

        def __init__(self, m_, n_):
            self.m_, self.n_ = m_, n_

        def __enter__(self):
            self.saved = self.m_.cfg, self.m_.model.layers
            self.m_.cfg = self.m_.cfg.replace(num_hidden_layers=self.n_)
            self.m_.model.layers = self.saved[1][:self.n_]

        def __exit__(self, *exc):
            self.m_.cfg, self.m_.model.layers = self.saved

    # quantized KV: at full depth each engine's tokens against its own lone
    # forward, and the pooled-logit cosine to the bf16 engine (reported); the
    # JAX tests' gates at their depth, two layers
    quality = {}
    for cd in ("int8", "int4"):
        run_q = serve(lm7, cache_dtype=cd)
        greedy[f"{cd} KV"] = greedy_check(lm7, run_q[0], run_q[1], f"{cd} KV", cd)
        quality[f"{cd} KV"] = {"28 layers": pooled_cosine((toks7, logits7), run_q)}
        del run_q
    with depth_cut(lm7, JAX_GATE_LAYERS):
        ref2 = serve(lm7)[:2]
        # the same check at two layers: how much of the gap 28 random layers amplify
        greedy[f"bf16, {JAX_GATE_LAYERS} layers"] = greedy_check(
            lm7, ref2[0], ref2[1], f"bf16, {JAX_GATE_LAYERS} layers")
        for cd in ("int8", "int4"):
            quality[f"{cd} KV"][f"{JAX_GATE_LAYERS} layers"] = pooled_cosine(
                ref2, serve(lm7, cache_dtype=cd))
    print(f"quantized KV, pooled-logit cosine and token share to bf16: {quality}")
    cos8 = quality["int8 KV"][f"{JAX_GATE_LAYERS} layers"][0]
    if not cos8 > INT8_CACHE_COS:
        fail(f"7B widths, {JAX_GATE_LAYERS} layers, int8 KV: pooled-logit cosine {cos8} to the "
             f"bf16 engine (gate {INT8_CACHE_COS})")
    torch.cuda.synchronize()

    # the scores' product: fp32 accumulators out of a bf16 product (out_dtype)
    # against the cache copied to fp32 first, one layer's kv-heads at 8 slots
    qs_ = torch.randn(DECODE["slots"], cfg7.num_attention_heads // cfg7.num_key_value_heads,
                      cfg7.head_dim, device=dev, dtype=torch.bfloat16)
    ks_ = torch.randn(DECODE["slots"], DECODE["capacity"], cfg7.num_key_value_heads * cfg7.head_dim,
                      device=dev, dtype=torch.bfloat16)
    heads_ = [ks_[:, :, g_ * cfg7.head_dim:(g_ + 1) * cfg7.head_dim].transpose(1, 2)
              for g_ in range(cfg7.num_key_value_heads)]
    score_ms = {
        "out_dtype": time_ms(lambda: [LM._scores(qs_, k_) for k_ in heads_]),
        "cast to fp32": time_ms(lambda: [torch.bmm(qs_.float(), k_.float()) for k_ in heads_]),
        "bf16 scores": time_ms(lambda: [torch.bmm(qs_, k_) for k_ in heads_])}
    del qs_, ks_, heads_

    def decode_rate(m_, slots, label):
        """ms a tick and tokens/s of `slots` active streams at steady state,
        and a profiled window: device busy ms and launches a step."""
        eng = DecodeEngine(m_, slots=slots, capacity=DECODE["capacity"],
                           prefill_buckets=DECODE["buckets"],
                           max_new_tokens=DECODE["capacity"])
        for i_ in range(slots):
            eng.open_tokens(d_prompts[i_ % len(d_prompts)])
        while eng._pending or eng._inflight is not None:
            eng.tick()
        for _ in range(4):
            eng.tick()
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        for _ in range(DECODE["timed_ticks"]):
            eng.tick()
        torch.cuda.synchronize()
        tick_s = (time.perf_counter() - t0_) / DECODE["timed_ticks"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(DECODE["profiled_ticks"]):
                eng.tick()
            torch.cuda.synchronize()
        rows_ = device_rows(prof)
        busy = sum(e_.device_time_total for e_ in rows_) / DECODE["profiled_ticks"] / 1e3
        launches_ = sum(e_.count for e_ in rows_) / DECODE["profiled_ticks"]
        top = sorted(rows_, key=lambda e_: -e_.device_time_total)[:4]
        kv_bytes = sum(2 * cfg7.num_hidden_layers * int(n_) * cfg7.num_key_value_heads
                       * cfg7.head_dim * 2 for n_ in eng._host_len[:slots])
        wb = sum(p_.numel() * p_.element_size() for n_, p_ in m_.named_parameters()
                 if "embed_tokens" not in n_) + sum(
            b_.numel() * b_.element_size() for n_, b_ in m_.named_buffers()
            if n_.endswith(("weight", "weight_scale")))
        bound = (wb + kv_bytes) / HBM_BYTES_PER_S * 1e3
        print(f"decode {label} ({smi}), {slots} slots, capacity {DECODE['capacity']}, cache "
              f"lengths {int(eng._host_len[:slots].min())}-{int(eng._host_len[:slots].max())}: "
              f"{tick_s * 1e3:.3f} ms a tick, {slots / tick_s:.1f} tokens/s; device busy "
              f"{busy:.3f} ms a step ({busy / (tick_s * 1e3) * 100:.1f} % of the tick), "
              f"{launches_:.0f} launches a step; bound {bound:.3f} ms (weights "
              f"{wb / 2**30:.2f} GiB + the KV read {kv_bytes / 2**20:.1f} MiB over 3.35 TB/s); "
              "top: " + ", ".join(f"{e_.key[:32]} {e_.device_time_total / DECODE['profiled_ticks'] / 1e3:.3f}"
                                  for e_ in top))
        del eng
        return tick_s, busy, launches_, bound

    rates = {("bf16", s_): decode_rate(lm7, s_, "bf16")
             for s_ in (DECODE["slots"], DECODE["wide_slots"])}
    peng = DecodeEngine(lm7, slots=1, capacity=DECODE["capacity"],
                        prefill_buckets=DECODE["buckets"])
    prefill_rate = {}
    for lb in DECODE["buckets"]:
        ids_ = torch.from_numpy(drng.integers(0, cfg7.vocab_size, (1, lb))).to(dev)
        ms_ = time_ms(lambda: peng._prefill_chunk(ids_, True, 0, 0, lb, 0), iters=5)
        prefill_rate[lb] = (ms_, lb / ms_ * 1e3)
    del peng
    print(f"Qwen2.5-7B-width LM ({smi}): {n_params / 1e9:.3f} B parameters drawn on the card in "
          f"{build_s:.2f} s; {DECODE['requests']} requests of {plens.min()}-{plens.max()} prompt "
          f"ids and {budgets.min()}-{budgets.max()} new tokens over {DECODE['slots']} slots in "
          f"{serve_s:.2f} s ({eng7.stats['admits']} admits, {eng7.stats['decode_steps']} decode "
          f"steps, prefill chunks {eng7.stats['prefill_chunks']}); greedy checks (largest "
          f"|dlogit| to the lone forward, share of positions decided, share equal, positions) "
          f"{greedy}; k=4 ticks equal k=1 ({eng_k4.stats['decode_by_k']}); pooled-logit cosine "
          f"and token share to bf16 {quality} (the JAX gates at {JAX_GATE_LAYERS} layers: int8 > "
          f"{INT8_CACHE_COS}; int4's {INT4_CACHE_COS}, not met by the reference's int4 at "
          f"head_dim 128, ROADMAP section 3); scores ms a layer (4 kv-heads, 8 slots, C={DECODE['capacity']}) "
          f"{ {k_: round(v_, 4) for k_, v_ in score_ms.items()} }; prefill ms and tokens/s by "
          f"bucket { {k_: (round(a_, 3), round(b_, 1)) for k_, (a_, b_) in prefill_rate.items()} }")
    del eng7, eng_k4

    # ---- 27. VideoQA: the flagship tower, the projector, the 7B LM; VideoQAServer over HTTP
    t27 = time.perf_counter()
    vtower = TimesformerVisionTower(model, streaming_mode=False)
    vproj = VQ.init_mm_projector(cfg.hidden_size, cfg7.hidden_size, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(27))
    vqa = VQ.LlavaQwenModel(vtower, lm7, vproj)
    vrng = np.random.default_rng(27)
    qa_frames = [vrng.standard_normal((VQA["frames"], 3, cfg.image_size, cfg.image_size))
                 .astype(np.float32) for _ in range(2)]
    qa_ids = [np.concatenate([vrng.integers(0, cfg7.vocab_size, (VQA["system"],)),
                              [VQ.IMAGE_TOKEN_INDEX],
                              vrng.integers(0, cfg7.vocab_size, (VQA["question"],))])
              for _ in range(2)]
    qa_kw = dict(slots=2, capacity=VQA["capacity"], max_new_tokens=VQA["max_new"],
                 prefill_buckets=VQA["buckets"])
    srv = VideoQAServer(vqa, port=0, **qa_kw).start()

    def qa_request(method, path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=data,
                                     method=method, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    answers, round_trip, qa_errors = {}, {}, []

    def qa_client(i):
        try:
            t0_ = time.perf_counter()
            rid = qa_request("POST", "/qa", {
                "prompt_ids": qa_ids[i].tolist(),
                "frames_b64": base64.b64encode(qa_frames[i].tobytes()).decode(),
                "shape": list(qa_frames[i].shape)})["rid"]
            toks, deadline = [], time.time() + 300
            while time.time() < deadline:
                r = qa_request("GET", f"/qa/{rid}/tokens")
                toks += r["tokens"]
                if r["done"]:
                    answers[i], round_trip[i] = toks, time.perf_counter() - t0_
                    return
                time.sleep(0.005)
            qa_errors.append(f"client {i}: request {rid} never finished")
        except Exception as e:  # reported below: the phase fails
            qa_errors.append(f"client {i}: {e!r}")

    try:
        ops.reset_launches()
        clients = [threading.Thread(target=qa_client, args=(i,)) for i in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        torch.cuda.synchronize()
        vqa_launches = dict(ops.LAUNCHES)
    finally:
        srv.stop()
    if qa_errors or len(answers) != 2:
        fail(f"VideoQA server: {qa_errors or answers.keys()}")
    want = {**zeros, "spatial_flat": 2 * L, "temporal_fullclip": 2 * L}
    if vqa_launches != want:
        fail(f"VideoQA server launches {vqa_launches}, not {want} (B and C L times an encode)")
    # the in-process engine on the same spliced prompts
    q_eng = DecodeEngine(lm7, **qa_kw)
    q_sids = [q_eng.open(vqa.prompt_embeds(qa_ids[i], torch.from_numpy(qa_frames[i])[None]))
              for i in range(2)]
    q_eng.run_until_idle()
    in_process = [q_eng.poll(s_)[0] for s_ in q_sids]
    if [answers[0], answers[1]] != in_process:
        fail(f"VideoQA server tokens {answers} differ from the in-process engine's {in_process}")
    # generate on a streaming linear tower (C=16): the frames through kernel E
    stower = TimesformerVisionTower(model, cfg=cfg.replace(cache_mode="linear",
                                                           cache_capacity=VQA["frames"],
                                                           streaming_mode=True))
    svqa = VQ.LlavaQwenModel(stower, lm7, vproj)
    ops.reset_launches()
    s_answer = svqa.generate(qa_ids[0], torch.from_numpy(qa_frames[0])[None],
                             max_new_tokens=VQA["max_new"])
    torch.cuda.synchronize()
    stream_launches = dict(ops.LAUNCHES)
    if not stream_launches["temporal_append_pm_ragged"] or s_answer.shape != (1, VQA["max_new"]):
        fail(f"streaming-tower generate: launches {stream_launches}, answer {s_answer.shape}")
    add(vqa_launches, stream_launches)
    print(f"VideoQA ({smi}): flagship tower (non-streaming, {VQA['frames']} frames of "
          f"{cfg.image_size}^2), projector {cfg.hidden_size}->{cfg7.hidden_size}, the 7B LM; "
          f"VideoQAServer, 2 clients at once: tokens equal the in-process engine's "
          f"({[len(a_) for a_ in in_process]} tokens, spliced prompts of "
          f"{[len(i_) - 1 + VQA['frames'] for i_ in qa_ids]}); round trip "
          f"{[round(round_trip[i] * 1e3, 1) for i in range(2)]} ms; server launches "
          f"{ {k_: v_ for k_, v_ in vqa_launches.items() if v_} } with the streaming linear "
          f"tower's generate (E {stream_launches['temporal_append_pm_ragged']}); its answer "
          f"{'equals' if s_answer[0].tolist() == in_process[0] else 'differs from'} the "
          f"full-clip tower's ({time.perf_counter() - t27:.1f} s)")
    del q_eng, stower, svqa, vtower, vqa

    # ---- 26 again, int8 weights with the int8 lm_head
    quant.quantize_lm(lm7)
    torch.cuda.empty_cache()
    if not isinstance(lm7.lm_head, quant.Int8Linear):
        fail("quantize_lm left the 7B lm_head float")
    run8 = serve(lm7)
    greedy["int8 weights"] = greedy_check(lm7, run8[0], run8[1], "int8 weights")
    quality["int8 weights"] = {"28 layers": pooled_cosine((toks7, logits7), run8)}
    del run8
    with depth_cut(lm7, JAX_GATE_LAYERS):
        quality["int8 weights"][f"{JAX_GATE_LAYERS} layers"] = pooled_cosine(ref2, serve(lm7))
    cos8 = quality["int8 weights"][f"{JAX_GATE_LAYERS} layers"][0]
    if not cos8 > INT8_WEIGHTS_LM_COS:
        fail(f"7B widths, {JAX_GATE_LAYERS} layers, int8 weights: pooled-logit cosine {cos8} "
             f"(gate {INT8_WEIGHTS_LM_COS})")
    rates.update({("int8", s_): decode_rate(lm7, s_, "int8 weights")
                  for s_ in (DECODE["slots"], DECODE["wide_slots"])})
    print(f"7B int8 weights with the int8 lm_head ({smi}): greedy check "
          f"{greedy['int8 weights']}; pooled-logit cosine and token share to bf16 "
          f"{quality['int8 weights']} (the JAX gate at {JAX_GATE_LAYERS} layers: > "
          f"{INT8_WEIGHTS_LM_COS}); peak memory of phases 26-27 "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phases 25-27 "
          f"{time.perf_counter() - t_lm:.1f} s")
    del lm7, logits7, ref2, vproj
    torch.cuda.empty_cache()

    # ---- 28. VideoQA training: stages 1-3 and DPO (downstream.videoqa, videoqa_run)
    from streamformer_tpu_torch.downstream import videoqa_run

    vt = VQA_TRAIN
    t28 = time.perf_counter()
    bcih = ("spatial_flat", "temporal_fullclip", "temporal_fullclip_bwd", "spatial_flat_bwd")

    def vqa_model(tower_cfg, lm_cfg, device, seed):
        """A trainable tower (gates opened), projector and LM from seeds."""
        tw = encoder.StreamformerEncoder(tower_cfg, device=device, trainable=True,
                                         generator=torch.Generator().manual_seed(seed))
        open_gates(tw, seed)
        lm_ = LM.LanguageModel(lm_cfg, device=device, trainable=True,
                               generator=torch.Generator(device=device).manual_seed(seed + 1))
        pj = VQ.init_mm_projector(tower_cfg.hidden_size, lm_cfg.hidden_size, device=device,
                                  generator=torch.Generator(device=device).manual_seed(seed + 2))
        return VQ.VideoQAModel(tw, pj, lm_)

    def vqa_rows(vocab, seed):
        """A prompt (system ids, <image>, question ids) and two answers."""
        r_ = np.random.default_rng(seed)
        prompt = np.concatenate([r_.integers(3, vocab, vt["system"]), [VQ.IMAGE_TOKEN_INDEX],
                                 r_.integers(3, vocab, vt["question"])])
        return prompt, r_.integers(3, vocab, vt["answer"]), r_.integers(3, vocab, vt["answer"])

    def vqa_batch(prompt, answer, frames, device):
        ids = np.concatenate([prompt, answer])
        labels = np.where(np.arange(len(ids)) >= len(prompt), ids, -100)
        return VQ.make_batch(ids, labels, frames, vt["max_len"], device=device)

    def pixels(tower_cfg, seed, device):
        g_ = torch.Generator().manual_seed(seed)
        return torch.randn(1, tower_cfg.num_frames, 3, tower_cfg.image_size, tower_cfg.image_size,
                           generator=g_).to(device)

    def dpo_batch(px, prompt, chosen, rejected, frames, device):
        return {"pixel_values": px, "chosen": vqa_batch(prompt, chosen, frames, device),
                "rejected": vqa_batch(prompt, rejected, frames, device)}

    def recorded_grads(opt_, m_):
        """Wrap ``opt_.step`` to keep each step's gradients of the trained
        parameters, copied to the host as the step starts (the clip then
        scales them in place)."""
        kept, inner = [], opt_.step

        def step_():
            kept.append({k_: (torch.zeros_like(p_) if p_.grad is None else p_.grad).detach().to(
                "cpu", copy=True) for k_, p_ in m_.named_parameters() if p_.requires_grad})
            inner()

        opt_.step = step_
        return kept

    # 28a. a small fp32 model on the card against the same on the CPU: two
    # steps each of stages 1, 2 and 3 and of DPO; the losses, the metrics and
    # the parameters after them, and each step's gradients part by part
    scfg = StreamformerConfig(**SMALL_CONFIG)
    slm = LM.LMConfig(**LM_SMALL)
    init_sd = vqa_model(scfg, slm, "cpu", 28).state_dict()
    s_prompt, s_chosen, s_rejected = vqa_rows(slm.vocab_size, 28)
    worst28, grad28 = {}, {}
    for case in ("stage 1", "stage 2", "stage 3", "dpo"):
        runs, grads28 = [], []
        for device in ("cpu", dev):
            m_ = vqa_model(scfg, slm, device, 28)
            m_.load_state_dict(init_sd)
            px = pixels(scfg, 28, device)
            if case == "dpo":
                opt_, st_ = VQ.make_videoqa_dpo_step(m_, VQ.reference_copy(m_), stage=3,
                                                     beta=0.5, gamma=0.1)
                grads28.append(recorded_grads(opt_, m_))
                b_dpo = dpo_batch(px, s_prompt, s_chosen, s_rejected, scfg.num_frames, device)
                outs = [st_(b_dpo) for _ in range(2)]
                vals = [float(lo) for lo, _ in outs] + [float(v_) for _, m2 in outs
                                                        for v_ in m2.values()]
            else:
                opt_, st_ = VQ.make_videoqa_train_step(m_, int(case[-1]))
                grads28.append(recorded_grads(opt_, m_))
                b_sft = vqa_batch(s_prompt, s_chosen, scfg.num_frames, device)
                b_sft["pixel_values"] = px
                vals = [float(st_(b_sft)) for _ in range(2)]
            sd_ = {k_: v_.detach().cpu() for k_, v_ in m_.state_dict().items()}
            if case != "dpo":  # frozen parts bit for bit
                frozen = [p_ for p_ in ("tower", "lm") if (p_ == "tower" and case != "stage 3")
                          or (p_ == "lm" and case == "stage 1")]
                moved = [k_ for k_ in sd_ if k_.split(".")[0] in frozen
                         and not torch.equal(sd_[k_], init_sd[k_])]
                if moved:
                    fail(f"small VideoQA {case} on {device}: frozen parameters moved: {moved[:3]}")
            runs.append((np.array(vals), sd_))
        err_vals = float(np.abs(runs[0][0] - runs[1][0]).max())
        err_params = max(max_err(runs[0][1][k_], runs[1][1][k_]) for k_ in runs[0][1])
        worst28[case] = (err_vals, err_params)
        if not max(err_vals, err_params) <= TRAIN_VS_CPU_TOL:
            fail(f"small VideoQA {case}: card vs CPU losses/metrics {err_vals}, parameters "
                 f"{err_params} (> {TRAIN_VS_CPU_TOL})")
        rel = {}
        for g_cpu, g_dev in zip(*grads28):
            if g_cpu.keys() != g_dev.keys():
                fail(f"small VideoQA {case}: card and CPU trained different parameters")
            for part in sorted({k_.split(".")[0] for k_ in g_cpu}):
                names = [k_ for k_ in g_cpu if k_.split(".")[0] == part]
                scale = max(float(g_cpu[k_].abs().max()) for k_ in names)
                err = max(max_err(g_cpu[k_], g_dev[k_]) for k_ in names) / max(scale, 1e-30)
                rel[part] = max(rel.get(part, 0.0), err)
        grad28[case] = rel
        if len(grads28[0]) != 2 or not max(rel.values()) <= TRAIN_GRAD_RTOL:
            fail(f"small VideoQA {case}: card vs CPU gradients a part, relative to the "
                 f"part's largest: {rel} (> {TRAIN_GRAD_RTOL})")
    print(f"small fp32 VideoQA training, card vs CPU after two steps (losses and DPO metrics, "
          f"every parameter): {worst28} (<= {TRAIN_VS_CPU_TOL}); each step's gradients a "
          f"trained part, relative to its largest: {grad28} (<= {TRAIN_GRAD_RTOL}); frozen "
          f"parts bit for bit")
    del init_sd, runs, m_, grads28

    # 28b. stage 3 at full width: the flagship tower, the projector, the LM at
    # Qwen2.5-0.5B's widths, bf16 over fp32 masters
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fcfg = StreamformerConfig(**FLAGSHIP_CONFIG)
    lm05 = LM.LMConfig(**LM_05B)
    vqm = vqa_model(fcfg, lm05, dev, 280)
    n_lm = sum(p_.numel() for p_ in vqm.lm.parameters())
    f_prompt, f_chosen, f_rejected = vqa_rows(lm05.vocab_size, 281)
    f_px = pixels(fcfg, 281, dev)
    f_batch = vqa_batch(f_prompt, f_chosen, fcfg.num_frames, dev)
    f_batch["pixel_values"] = f_px
    _, step3 = VQ.make_videoqa_train_step(vqm, 3)
    losses3 = [step3(f_batch) for _ in range(vt["warmup"])]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    losses3 += [step3(f_batch) for _ in range(vt["timed"])]
    torch.cuda.synchronize()
    s3_ms = (time.perf_counter() - t0) / vt["timed"] * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        losses3 += [step3(f_batch) for _ in range(vt["profiled"])]
        torch.cuda.synchronize()
    s3_launches = dict(ops.LAUNCHES)
    n3 = vt["timed"] + vt["profiled"]
    rows3 = device_rows(prof)
    s3_busy = sum(e.device_time_total for e in rows3) / vt["profiled"] / 1e3
    s3_ops = sum(e.count for e in rows3) / vt["profiled"]
    s3_peak = torch.cuda.max_memory_allocated() / 2**30
    losses3 = [float(x_) for x_ in losses3]
    want = {**zeros, **{k_: L * n3 for k_ in bcih}}
    if s3_launches != want:
        fail(f"VideoQA stage 3: launches {s3_launches} over {n3} steps, not {want}")
    if not (np.isfinite(losses3).all() and losses3[-1] < losses3[0]):
        fail(f"VideoQA stage 3 at full width: losses {losses3} not finite and falling")
    print(f"VideoQA stage 3 ({smi}): flagship tower (bf16 over fp32 masters, "
          f"{fcfg.num_frames} frames of {fcfg.image_size}^2), projector {fcfg.hidden_size}->{lm05.hidden_size}, the LM at "
          f"Qwen2.5-0.5B widths ({n_lm / 1e6:.1f} M parameters, {lm05.num_hidden_layers} layers), "
          f"max_len {vt['max_len']}: {s3_ms:.2f} ms per step, {1e3 / s3_ms:.2f} samples/s; device "
          f"busy {s3_busy:.2f} ms a step ({100 * s3_busy / s3_ms:.1f} %), {s3_ops:.0f} launches a "
          f"step; peak {s3_peak:.2f} GiB; losses {[round(x_, 4) for x_ in losses3]}; launches "
          f"{ {k_: v_ // n3 for k_, v_ in s3_launches.items() if v_} } a step")
    for e in sorted(rows3, key=lambda e: -e.device_time_total)[:8]:
        print(f"  {e.device_time_total / vt['profiled'] / 1e3:8.4f} ms/step  "
              f"x{e.count / vt['profiled']:<6.1f} {e.key[:90]}")

    # 28c. DPO at the same widths, the reference a frozen copy of 28b's model
    _, dstep = VQ.make_videoqa_dpo_step(vqm, VQ.reference_copy(vqm), stage=3)
    d_batch = dpo_batch(f_px, f_prompt, f_chosen, f_rejected, fcfg.num_frames, dev)
    d_metrics = []
    for i_ in range(vt["dpo_steps"]):
        if i_ == vt["dpo_steps"] - vt["dpo_timed"]:
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
        d_metrics.append(dstep(d_batch))
    torch.cuda.synchronize()
    dpo_ms = (time.perf_counter() - t0) / vt["dpo_timed"] * 1e3
    dpo_launches = dict(ops.LAUNCHES)
    dpo_peak = torch.cuda.max_memory_allocated() / 2**30
    accs = [float(m2["reward_accuracy"]) for _, m2 in d_metrics]
    margins = [float(m2["reward_margin"]) for _, m2 in d_metrics]
    want = {**zeros, "spatial_flat": 2 * L * vt["dpo_timed"],
            "temporal_fullclip": 2 * L * vt["dpo_timed"],
            "temporal_fullclip_bwd": L * vt["dpo_timed"], "spatial_flat_bwd": L * vt["dpo_timed"]}
    if dpo_launches != want:
        fail(f"VideoQA DPO: launches {dpo_launches}, not {want} (B and C 2L a step: the policy "
             "and the reference; H and I L)")
    if not (accs[-1] == 1.0 and margins[-1] > margins[0]):
        fail(f"VideoQA DPO: reward accuracy {accs}, margins {margins}: not rising")
    print(f"VideoQA DPO ({smi}), 28b's widths: {dpo_ms:.2f} ms per step, {1e3 / dpo_ms:.2f} "
          f"pairs/s; reward accuracy {accs}, margin {[round(x_, 4) for x_ in margins]}; peak "
          f"{dpo_peak:.2f} GiB; launches "
          f"{ {k_: v_ // vt['dpo_timed'] for k_, v_ in dpo_launches.items() if v_} } a step")
    del vqm, dstep, step3, d_batch, f_batch, d_metrics, prof, rows3
    torch.cuda.empty_cache()

    # 28d. stage 1 at Qwen2.5-7B widths: phase 26's LM (redrawn from its seed)
    # and phase 4's tower, frozen, bf16; only the projector moves
    lm7 = LM.LanguageModel(cfg7, device=dev, generator=torch.Generator(device=dev).manual_seed(7))
    p7 = VQ.init_mm_projector(cfg.hidden_size, cfg7.hidden_size, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(282))
    s1m = VQ.VideoQAModel(model, p7, lm7)
    frozen_copy = {k_: v_.clone() for k_, v_ in s1m.state_dict().items()
                   if not k_.startswith("projector.")}
    copy_bytes = sum(v_.numel() * v_.element_size() for v_ in frozen_copy.values())
    proj_before = p7.fc1.weight.detach().clone()
    torch.cuda.reset_peak_memory_stats()
    _, step1 = VQ.make_videoqa_train_step(s1m, 1)
    s_prompt7, s_answer7, _ = vqa_rows(cfg7.vocab_size, 283)
    b7 = vqa_batch(s_prompt7, s_answer7, cfg.num_frames, dev)
    b7["pixel_values"] = pixels(cfg, 283, dev)
    losses1 = []
    for i_ in range(vt["s1_steps"]):
        if i_ == vt["s1_steps"] - vt["s1_timed"]:
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
        losses1.append(step1(b7))
    torch.cuda.synchronize()
    s1_ms = (time.perf_counter() - t0) / vt["s1_timed"] * 1e3
    s1_launches = dict(ops.LAUNCHES)
    s1_peak = (torch.cuda.max_memory_allocated() - copy_bytes) / 2**30
    losses1 = [float(x_) for x_ in losses1]
    want = {**zeros, "spatial_flat": L * vt["s1_timed"], "temporal_fullclip": L * vt["s1_timed"]}
    if s1_launches != want:
        fail(f"VideoQA stage 1 at 7B widths: launches {s1_launches}, not {want} (B and C only)")
    moved = [k_ for k_, v_ in s1m.state_dict().items()
             if k_ in frozen_copy and not torch.equal(v_, frozen_copy[k_])]
    if moved or torch.equal(p7.fc1.weight, proj_before) or not np.isfinite(losses1).all():
        fail(f"VideoQA stage 1 at 7B widths: frozen parameters moved {moved[:3]}, or the "
             f"projector did not; losses {losses1}")
    print(f"VideoQA stage 1 ({smi}): phase 4's tower and the Qwen2.5-7B-width LM frozen (bf16), "
          f"projector {cfg.hidden_size}->{cfg7.hidden_size}->{cfg7.hidden_size} trained: "
          f"{s1_ms:.2f} ms per step, {1e3 / s1_ms:.2f} samples/s; peak {s1_peak:.2f} GiB (less "
          f"the {copy_bytes / 2**30:.2f} GiB comparison copy); the tower and the LM bit for bit "
          f"unchanged; losses {[round(x_, 4) for x_ in losses1]}; launches "
          f"{ {k_: v_ // vt['s1_timed'] for k_, v_ in s1_launches.items() if v_} } a step")
    del lm7, p7, s1m, frozen_copy, step1, b7
    torch.cuda.empty_cache()

    # 28e. the CLI's training function on in-memory clips: an epoch of stage 3
    # at 28b's widths and a checkpoint; then --eval --ckpt restoring it into a
    # fresh model and answering through the DecodeEngine on the streaming tower
    work28 = tempfile.mkdtemp(prefix="videoqa-", dir=os.path.join(root, "build"))
    try:
        cli = ["--data", "in-memory", "--output_dir", work28, "--stage", "3", "--bf16",
               "--eval_samples", "0", "--seed", "28", "--max_len", str(vt["max_len"]),
               "--num_frames", str(fcfg.num_frames), "--input_size", str(fcfg.image_size)]
        vargs = videoqa_run.get_args(cli)
        if (vargs.lm_vocab, vargs.lm_hidden, vargs.lm_layers) != (
                lm05.vocab_size, lm05.hidden_size, lm05.num_hidden_layers):
            fail("videoqa_run's LM defaults are not Qwen2.5-0.5B's widths")
        vm = videoqa_run.build_model(vargs)
        tok = videoqa_run.load_tokenizer(vargs, vargs.lm_vocab)
        wrng = np.random.default_rng(284)
        words = "the a dog cat runs jumps red blue left right over under".split()

        def text(n):
            return " ".join(wrng.choice(words, n))

        cli_rows = [{"video": f"clip{i}", "conversations": [
            {"from": "human", "value": "<image>\n" + text(12)},
            {"from": "gpt", "value": text(20)}]} for i in range(vt["cli_rows"])]
        clips = {f"clip{i}": pixels(fcfg, 285 + i, dev) for i in range(vt["cli_rows"])}

        def load_video(path, mode="train"):
            return clips[path]

        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        hist = videoqa_run.train(vargs, cli_rows, load_video, vm, tok)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_launches = dict(ops.LAUNCHES)
        want = {**zeros, **{k_: L * vt["cli_rows"] for k_ in bcih}}
        if cli_launches != want or not np.isfinite(hist[0]["loss"]):
            fail(f"videoqa_run.train: launches {cli_launches} (want {want}), stats {hist}")
        if ckpt_lib.latest_checkpoint(work28) != 0:
            fail("videoqa_run.train wrote no checkpoint-0")
        eargs = videoqa_run.get_args(cli + ["--eval", "--ckpt", work28, "--answers_file",
                                            os.path.join(work28, "answers.jsonl"),
                                            "--max_new_tokens", str(vt["cli_new"]),
                                            "--engine_slots", "2"])
        fresh = videoqa_run.build_model(eargs, serving=True)  # as main() builds it for --eval
        t0 = time.perf_counter()
        if (ckpt_lib.auto_resume(eargs.ckpt, fresh) or {}).get("epoch") != 0:
            fail("--eval --ckpt restored no checkpoint")
        restore_s = time.perf_counter() - t0
        # the serving modules hold the masters cast once to their dtypes
        trained = vm.state_dict()
        differ = [k_ for k_, v_ in fresh.state_dict().items()
                  if not torch.equal(v_, trained[k_].to(v_.dtype))]
        if differ or fresh.lm.model.embed_tokens.weight.dtype != torch.bfloat16:
            fail(f"the restored serving model is not the trained one cast: {differ[:3]}")
        del vm, trained
        torch.cuda.empty_cache()
        questions = [
            {"video": "clip0", "sample_id": "q0", "conversations": [
                {"from": "human", "value": text(10)}, {"from": "gpt", "value": text(6)},
                {"from": "human", "value": text(8)}, {"from": "gpt", "value": text(6)}]},
            {"video": "clip1", "sample_id": "q1", "conversations": [
                {"from": "human", "value": text(10)}]}]
        ops.reset_launches()
        t0 = time.perf_counter()
        answers_file = videoqa_run.run_eval(eargs, fresh, tok, questions, load_video)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_launches = dict(ops.LAUNCHES)
        with open(answers_file) as f_:
            answered = [json.loads(ln_) for ln_ in f_]
        if (sorted((a_["sample_id"], a_["gt_response"] is not None) for a_ in answered)
                != [("q0", True), ("q0", True), ("q1", False)]
                or not all(1 <= len(a_["pred_token_ids"]) <= vt["cli_new"] for a_ in answered)
                or not eval_launches["temporal_append_pm_ragged"]):
            fail(f"videoqa_run --eval: answers {answered}, launches {eval_launches}")
        ckpt_gib = sum(os.path.getsize(os.path.join(dp_, f_)) for dp_, _, fs_ in
                       os.walk(os.path.join(work28, "checkpoint-0")) for f_ in fs_) / 2**30
        print(f"videoqa_run ({smi}): train() an epoch of {vt['cli_rows']} stage-3 steps at 28b's "
              f"widths from in-memory clips in {cli_s:.2f} s (loss {hist[0]['loss']:.4f}, the "
              f"checkpoint of {ckpt_gib:.2f} GiB written inside it); --eval --ckpt: restored in "
              f"{restore_s:.2f} s, the trained masters cast once to the serving dtypes; "
              f"{len(answered)} answers (a two-turn row and a one-turn row) through the DecodeEngine in {eval_s:.2f} s; "
              f"launches: training { {k_: v_ for k_, v_ in cli_launches.items() if v_} }, "
              f"eval { {k_: v_ for k_, v_ in eval_launches.items() if v_} } (E on the streaming "
              f"tower)")
        del fresh, clips
    finally:
        shutil.rmtree(work28, ignore_errors=True)
    torch.cuda.empty_cache()
    vqa_train_launches = {k_: s3_launches[k_] + dpo_launches[k_] + s1_launches[k_]
                          + cli_launches[k_] + eval_launches[k_] for k_ in zeros}
    print(f"phase 28: {time.perf_counter() - t28:.1f} s")

    # ---- 29. action recognition: downstream.ar and ar_run at batch 16
    from streamformer_tpu_torch.downstream import ar as AR_mod
    from streamformer_tpu_torch.downstream import ar_run

    t29 = time.perf_counter()
    # 29a. a small fp32 step on the card against the CPU: mixup, EMA, layer decay
    acfg = StreamformerConfig(**SMALL_CONFIG)
    arng = np.random.default_rng(29)
    a_px = torch.from_numpy(arng.standard_normal(
        (AR["small_batch"], acfg.num_frames, 3, acfg.image_size, acfg.image_size)).astype(np.float32))
    a_y = torch.from_numpy(arng.integers(0, AR["small_classes"], AR["small_batch"]))
    a_runs = []
    for device in ("cpu", dev):
        am = AR_mod.ARModel(
            encoder.StreamformerEncoder(acfg, device=device, trainable=True,
                                        generator=torch.Generator().manual_seed(29)),
            AR_mod.init_classifier(acfg, AR["small_classes"], device=device,
                                   generator=torch.Generator().manual_seed(30)))
        open_gates(am.backbone, 29)
        a_opt = optim.create_optimizer(am, optim.cosine_lr_schedule(1e-3, 1e-6, 1, 2),
                                       weight_decay=0.05, clip_grad=5.0, layer_decay=0.75,
                                       num_layers=acfg.num_hidden_layers)
        a_ema = AR_mod.init_ema(am)
        a_step = AR_mod.make_train_step(am, a_opt, AR["small_classes"], ema=a_ema, ema_decay=0.9)
        a_losses = [float(a_step(a_px, a_y, collate.seed_of(29, i_))) for i_ in range(2)]
        a_runs.append((np.array(a_losses),
                       {k_: v_.detach().cpu() for k_, v_ in am.state_dict().items()},
                       {k_: v_.detach().cpu() for k_, v_ in a_ema.state_dict().items()}))
    a_err = (float(np.abs(a_runs[0][0] - a_runs[1][0]).max()),
             max(max_err(a_runs[0][1][k_], a_runs[1][1][k_]) for k_ in a_runs[0][1]),
             max(max_err(a_runs[0][2][k_], a_runs[1][2][k_]) for k_ in a_runs[0][2]))
    if not max(a_err) <= TRAIN_VS_CPU_TOL:
        fail(f"small AR step card vs CPU: losses, parameters, EMA max-abs {a_err}")
    print(f"small fp32 AR training (mixup, EMA, layer decay), card vs CPU after two steps: "
          f"losses, parameters, EMA max-abs {a_err} (<= {TRAIN_VS_CPU_TOL})")
    del a_runs, am, a_opt, a_ema, a_step

    # 29b. ar_run.train at the CLI's defaults on in-memory clips
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    crng = np.random.default_rng(290)
    pool = [crng.integers(0, 256, (FLAGSHIP["frames"], AR["height"], AR["width"], 3),
                          dtype=np.uint8) for _ in range(AR["clips"])]
    views = AR["segments"] * AR["crops"]

    class Clips:
        """In-memory clips in the datasets' item schema; in test mode each
        of a clip's views a crop at its own offset."""

        def __init__(self, n, test=False):
            self.n, self.test = n, test

        def __len__(self):
            return self.n * (views if self.test else 1)

        def __getitem__(self, i):
            vid, view = divmod(i, views) if self.test else (i, 0)
            frames = pool[vid % len(pool)]
            item = {"label": (37 * vid) % AR["classes"]}
            if self.test:
                x0 = (view % AR["crops"]) * (AR["width"] - AR["height"]) // (AR["crops"] - 1)
                frames = frames[:, :, x0:x0 + AR["height"]]
                item["sample_idx"] = vid
            return {"task_input": {"frames": frames, **item}}

    work29 = tempfile.mkdtemp(prefix="ar-", dir=os.path.join(root, "build"))
    orig_make = AR_mod.make_train_step
    step_ms, step_launches = [], []

    def timed_make(*a_, **k_):
        """make_train_step whose steps are timed (the card synchronised
        around each) and their launches counted."""
        inner = orig_make(*a_, **k_)

        def timed_step(px, labels, seed):
            torch.cuda.synchronize()
            before = dict(ops.LAUNCHES)
            t_ = time.perf_counter()
            loss_ = inner(px, labels, seed)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t_) * 1e3)
            step_launches.append({k2: ops.LAUNCHES[k2] - before[k2] for k2 in before})
            return loss_

        return timed_step

    try:
        aargs = ar_run.get_args([
            "--anno_train", "in-memory", "--num_classes", str(AR["classes"]), "--bf16",
            "--epochs", "1", "--layer_decay", "0.75", "--model_ema", "--num_workers", "4",
            "--output_dir", work29, "--seed", "29", "--test_num_segment", str(AR["segments"]),
            "--test_num_crop", str(AR["crops"])])
        if (aargs.batch_size, aargs.mixup, aargs.cutmix, aargs.smoothing,
                aargs.model_ema_decay) != (AR["batch"], 0.8, 1.0, 0.1, 0.9999):
            fail("ar_run's defaults are not the reference recipe's")
        AR_mod.make_train_step = timed_make
        ar_model = ar_run.build_model(aargs)
        ops.reset_launches()
        t0 = time.perf_counter()
        ar_res = ar_run.train(aargs, Clips(AR["batch"] * AR["steps"]), Clips(AR["val_clips"]),
                              Clips(AR["test_clips"], test=True), model=ar_model)
        torch.cuda.synchronize()
        ar_s = time.perf_counter() - t0
        ar_launches = dict(ops.LAUNCHES)
        ar_peak = torch.cuda.max_memory_allocated() / 2**30
        stats29 = ar_res["history"][0]
        if len(step_ms) != AR["steps"] or any(
                sl_ != {**zeros, **{k_: L for k_ in bcih}} for sl_ in step_launches):
            fail(f"ar_run.train: {len(step_ms)} steps, launches a step {step_launches}")
        if not (np.isfinite(stats29["loss"]) and {"top1", "top5", "top1_ema"} <= stats29.keys()
                and ar_res["final_test"] is not None and ckpt_lib.latest_checkpoint(work29) == 0):
            fail(f"ar_run.train: stats {stats29}, final test {ar_res['final_test']}")
    finally:
        AR_mod.make_train_step = orig_make
        shutil.rmtree(work29, ignore_errors=True)
    steady = statistics.median(step_ms[1:])
    print(f"AR fine-tuning ({smi}): ar_run.train on the flagship encoder (bf16 over fp32 masters), "
          f"{AR['classes']} classes, batch {AR['batch']}, {FLAGSHIP['frames']} frames of "
          f"{aargs.input_size}^2, mixup 0.8 / cutmix 1.0 / smoothing 0.1, EMA 0.9999, layer decay "
          f"0.75: {AR['steps']} steps {[round(x_, 2) for x_ in step_ms]} ms (synchronised); "
          f"steady {steady:.2f} ms per step, {AR['batch'] * 1e3 / steady:.2f} clips/s; the epoch "
          f"with the loader {stats29['epoch_time']:.2f} s "
          f"({AR['batch'] * AR['steps'] / stats29['epoch_time']:.2f} clips/s); loss "
          f"{stats29['loss']:.4f}; validation "
          f"{ {k_: stats29[k_] for k_ in ('top1', 'top5', 'top1_ema')} }; "
          f"final test ({AR['test_clips']} clips x {AR['segments']} segments x {AR['crops']} "
          f"crops) {ar_res['final_test']}; peak {ar_peak:.2f} GiB; launches a step "
          f"{ {k_: v_ for k_, v_ in step_launches[0].items() if v_} }, in all "
          f"{ {k_: v_ for k_, v_ in ar_launches.items() if v_} } ({ar_s:.1f} s)")
    del ar_model, pool
    torch.cuda.empty_cache()
    print(f"phase 29: {time.perf_counter() - t29:.1f} s")

    # ---- 30. online action detection: extraction, LSTR/MAT training, the stream
    from streamformer_tpu_torch.downstream import oad_data
    from streamformer_tpu_torch.downstream import oad_lstr
    from streamformer_tpu_torch.downstream import oad_run

    t30 = time.perf_counter()
    oa = OAD_RUN
    # 30a. extraction: A and B L times a frame, features and one-hot targets on disk
    work30 = tempfile.mkdtemp(prefix="oad-", dir=os.path.join(root, "build"))
    for sub in ("rgb", "target"):
        os.makedirs(os.path.join(work30, sub))
    xrng = np.random.default_rng(300)
    names30 = [f"video_{i_}" for i_ in range(oa["clips"])]
    oad_launches = dict(zeros)
    ext_s = 0.0
    feats30 = {}
    # the first clip's A and B calls of a middle layer at frame 2C+1 (the ring
    # past its wrap) are kept, to hold them to their plain versions after the run
    held30, calls30 = {}, {"a": 0, "b": 0}
    pick30 = L * (2 * cap + 1) + L // 2
    orig30 = {"a": ops.temporal_decode_pm, "b": ops.spatial_flat}

    def keep30(key, args):
        if calls30[key] == pick30:
            held30[key] = [x_.detach().clone() if torch.is_tensor(x_) else x_ for x_ in args]
        calls30[key] += 1
        return orig30[key](*args)

    for name in names30:
        clip = xrng.integers(0, 256, (oa["frames"], oa["height"], oa["width"], 3), dtype=np.uint8)
        px30 = oad.preprocess_frames(clip, cfg.image_size)
        if name == names30[0]:
            ops.temporal_decode_pm = lambda *a_: keep30("a", a_)
            ops.spatial_flat = lambda *a_: keep30("b", a_)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        try:
            f30 = oad.extract_features_streaming(model, px30, chunk=1)
        finally:
            ops.temporal_decode_pm, ops.spatial_flat = orig30["a"], orig30["b"]
        ext_s += time.perf_counter() - t0
        run = dict(ops.LAUNCHES)
        if run != {**zeros, "temporal_decode_pm": L * oa["frames"], "spatial_flat": L * oa["frames"]}:
            fail(f"OAD extraction a frame a call: launches {run} over {oa['frames']} frames")
        if f30.shape != (oa["frames"], d_) or not np.isfinite(f30).all():
            fail(f"OAD extraction gave {f30.shape}, finite {np.isfinite(f30).all()}")
        add(oad_launches, run)
        # per-frame labels in segments of 24-96 frames, class 0 the background
        labels = np.zeros(oa["frames"], np.int64)
        pos = 0
        while pos < oa["frames"]:
            span = int(xrng.integers(24, 97))
            labels[pos:pos + span] = 0 if xrng.uniform() < 0.5 else int(xrng.integers(1, oa["classes"]))
            pos += span
        np.save(os.path.join(work30, "rgb", name + ".npy"), f30)
        np.save(os.path.join(work30, "target", name + ".npy"),
                np.eye(oa["classes"], dtype=np.float32)[labels])
        feats30[name] = f30
        del px30, clip
    ext_fps = oa["clips"] * oa["frames"] / ext_s
    print(f"OAD extraction ({smi}): {oa['clips']} clips of {oa['frames']} uint8 frames "
          f"{oa['height']}x{oa['width']} (25 s at 24 fps), phase 4's encoder (ring "
          f"C={cap}) a frame a call: {ext_fps:.1f} frames/s; launches a frame "
          f"{ {k_: v_ // (oa['clips'] * oa['frames']) for k_, v_ in oad_launches.items() if v_} }")
    # A and B at the extraction's shapes (R = 196 rows of one stream; one frame's
    # 196 patches), on the inputs of the main path's calls, against their plain versions
    if set(held30) != {"a", "b"}:
        fail(f"OAD extraction: {calls30} calls of A and B, none captured at call {pick30}")
    q, kn, vn, kc, vc, ln, hh = held30["a"]
    dn, elt = str(q.dtype).split(".")[1], q.element_size()
    r, c_, length = q.shape[0], kc.shape[0], int(ln)
    k_ref, v_ref = kc.clone(), vc.clone()
    ref = ops.temporal_decode_pm_plain(q, kn, vn, k_ref, v_ref, ln, hh)
    got = ops.temporal_decode_pm(q, kn, vn, kc, vc, ln, hh)
    torch.cuda.synchronize()
    if not (torch.equal(kc, k_ref) and torch.equal(vc, v_ref)):
        fail("temporal_decode_pm on OAD extraction's call: appended cache planes differ")
    n_read = min(length, c_) - (1 if length >= c_ else 0)
    window = (torch.arange(c_, device=dev) <= length).view(1, c_)
    q4 = q.view(r, hh, 1, d_ // hh)
    k4, v4 = (x_.view(c_, r, hh, d_ // hh).permute(1, 2, 0, 3) for x_ in (kc, vc))
    record("temporal_decode_pm", f"OAD extraction ring R={r} C={c_} len={length}", dn,
           max_err(got, ref), lambda: ops.temporal_decode_pm(q, kn, vn, kc, vc, ln, hh),
           lambda: ops.temporal_decode_pm_plain(q, kn, vn, kc, vc, ln, hh),
           lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=window),
           elt * r * d_ * (3 + 1 + 2 * n_read + 2), 4 * r * d_ * (n_read + 1))
    q, k, v, hh = held30["b"]
    r, n30 = q.shape[:2]
    qh, kh, vh = (x_.view(r, n30, hh, d_ // hh).transpose(1, 2) for x_ in (q, k, v))
    record("spatial_flat", f"OAD extraction R={r} N={n30}", dn,
           max_err(ops.spatial_flat(q, k, v, hh), ops.spatial_flat_plain(q, k, v, hh)),
           lambda: ops.spatial_flat(q, k, v, hh), lambda: ops.spatial_flat_plain(q, k, v, hh),
           lambda: F.scaled_dot_product_attention(qh, kh, vh),
           4 * elt * r * n30 * d_, 4 * r * n30 * n30 * d_)
    del held30, q, kn, vn, kc, vc, k_ref, v_ref, ref, got, k, v, q4, k4, v4, qh, kh, vh

    # 30b. oad_run.train at LSTR's THUMOS-14 settings, then batch inference and a checkpoint
    with open(os.path.join(work30, "train.txt"), "w") as f_:
        f_.write("\n".join(names30) + "\n")
    with open(os.path.join(work30, "val.txt"), "w") as f_:
        f_.write(names30[-1] + "\n")
    oargs = oad_run.get_args([
        "--feature_root", os.path.join(work30, "rgb"), "--target_root",
        os.path.join(work30, "target"), "--train_list", os.path.join(work30, "train.txt"),
        "--val_list", os.path.join(work30, "val.txt"), "--num_classes", str(oa["classes"]),
        "--long_memory_num_samples", "512", "--epochs", "1", "--steps_per_epoch",
        str(oa["steps"]), "--output_dir", os.path.join(work30, "out"), "--seed", "30"])
    lcfg = oad_run.config_of(oargs)
    if (lcfg != oad_lstr.LSTRConfig(num_classes=oa["classes"]) or oargs.batch_size != oa["batch"]
            or (oargs.lr, oargs.weight_decay, oargs.long_sample_rate) != (7e-5, 5e-5, 4)):
        fail(f"OAD settings {lcfg}, batch {oargs.batch_size}, lr {oargs.lr}: not LSTR's THUMOS-14")
    train30, val30 = oad_run.build_datasets(oargs, lcfg)
    lstr = oad_lstr.LSTR(lcfg, generator=torch.Generator().manual_seed(30))
    n_lstr = sum(p_.numel() for p_ in lstr.parameters())
    orig_oad_make = oad_data.make_train_step
    oad_ms, oad_losses, oad_steps = [], [], []

    def timed_oad_make(*a_, **k_):
        """make_train_step whose steps are timed, the card synchronised
        around each; the step is kept for the profile."""
        inner = orig_oad_make(*a_, **k_)
        oad_steps.append(inner)

        def timed_step(batch):
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            loss_ = inner(batch)
            torch.cuda.synchronize()
            oad_ms.append((time.perf_counter() - t_) * 1e3)
            oad_losses.append(float(loss_))
            return loss_

        return timed_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held30 = torch.cuda.memory_allocated()
    oad_data.make_train_step = timed_oad_make
    try:
        t0 = time.perf_counter()
        hist30 = oad_run.train(oargs, train30, val30, model=lstr)
        oad_train_s = time.perf_counter() - t0
    finally:
        oad_data.make_train_step = orig_oad_make
    oad_peak = (torch.cuda.max_memory_allocated() - held30) / 2**30
    stats30 = hist30[0]
    if not (len(oad_losses) == oa["steps"] and np.isfinite(oad_losses).all()
            and np.mean(oad_losses[-3:]) < np.mean(oad_losses[:3])):
        fail(f"LSTR training: losses {oad_losses} not finite and falling")
    if not ({"mAP", "mcAP"} <= stats30.keys() and 0 <= stats30["mAP"] <= 100
            and ckpt_lib.latest_checkpoint(oargs.output_dir) == 0):
        fail(f"LSTR validation and checkpoint: stats {stats30}")
    pbatches = list(train30.batches(oa["batch"], np.random.default_rng(31)))[:oa["profiled"]]
    pbatches = [oad_data.to_device(b_x, dev) for b_x in pbatches]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b_x in pbatches:
            oad_steps[0](b_x)
        torch.cuda.synchronize()
    rows30 = device_rows(prof)
    if not rows30:
        fail("the LSTR profile read no device time")
    oad_busy = sum(e.device_time_total for e in rows30) / oa["profiled"] / 1e3
    oad_ops = sum(e.count for e in rows30) / oa["profiled"]
    steady30 = statistics.median(oad_ms[1:])
    print(f"LSTR training ({smi}): THUMOS-14 settings ({n_lstr / 1e6:.1f} M parameters; visual "
          f"768, d_model 1024, 8 heads, long 512 at rate 4, work 32, 8 groups), batch "
          f"{oa['batch']}, AdamW 7e-5 / 5e-5: {oa['steps']} steps "
          f"{[round(x_, 2) for x_ in oad_ms]} ms (synchronised, host batches in the loop); steady "
          f"{steady30:.2f} ms per step, {oa['batch'] * 1e3 / steady30:.1f} windows/s; device busy "
          f"{oad_busy:.2f} ms a step on device batches ({100 * oad_busy / steady30:.1f} % of the "
          f"step), {oad_ops:.0f} launches a step; peak {oad_peak:.2f} GiB above what earlier phases "
          f"hold; losses "
          f"{[round(x_, 4) for x_ in oad_losses]}; validation on {len(val30)} windows mAP "
          f"{stats30['mAP']:.2f} mcAP {stats30['mcAP']:.2f}; the epoch {oad_train_s:.1f} s")
    for e in sorted(rows30, key=lambda e: -e.device_time_total)[:6]:
        print(f"  {e.device_time_total / oa['profiled'] / 1e3:8.4f} ms/step  "
              f"x{e.count / oa['profiled']:<6.1f} {e.key[:90]}")

    # 30c. MAT: the future/CCI branch and anticipation queries, two steps
    mcfg = oad_lstr.LSTRConfig(num_classes=oa["classes"], future_num_samples=oa["future"],
                               anticipation_num_samples=oa["anticipation"])
    mat = oad_lstr.LSTR(mcfg, generator=torch.Generator().manual_seed(32))
    mat_step = orig_oad_make(mat, oad_data.make_optimizer(mat, 7e-5, 5e-5))
    mat_losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b_x in pbatches[:oa["mat_steps"]]:
        mat_losses.append(float(mat_step(b_x)))
    mat_ms = (time.perf_counter() - t0) / oa["mat_steps"] * 1e3
    with torch.no_grad():
        mout = oad_lstr.forward(mat, pbatches[0]["features"], memory_mask=pbatches[0]["memory_mask"])
    if not (np.isfinite(mat_losses).all() and mout["logits"].shape[1] == 32 + oa["anticipation"]
            and mout["future_logits"].shape[1] == mcfg.fut_queries):
        fail(f"MAT: losses {mat_losses}, logits {tuple(mout['logits'].shape)}")
    print(f"MAT (future {oa['future']}, anticipation {oa['anticipation']}, 2 CCI rounds): losses "
          f"{[round(x_, 4) for x_ in mat_losses]}, {mat_ms:.2f} ms a step; logits "
          f"{tuple(mout['logits'].shape)}, future {tuple(mout['future_logits'].shape)}")
    del mat, mat_step, mout

    # 30d. LSTRStream over 256 frames of 30a's features
    stream = oad_lstr.LSTRStream(lstr, long_sample_rate=oargs.long_sample_rate)
    sfeat = feats30[names30[0]][:oa["stream_frames"]]
    recompute_ms, reuse_ms = [], []
    for fr in sfeat:
        torch.cuda.synchronize()
        ts_ = time.perf_counter()
        last = stream.step(fr)
        torch.cuda.synchronize()
        (recompute_ms if stream.recomputed else reuse_ms).append((time.perf_counter() - ts_) * 1e3)
    window = train30[train30.samples.index((0, oa["stream_frames"]))]
    with torch.no_grad():
        want = oad_lstr.forward(lstr, torch.from_numpy(window["features"][None]).to(dev),
                                memory_mask=torch.from_numpy(window["memory_mask"][None]).to(dev))
    s_err = max_err(last, want["logits"][0, lcfg.work_memory_num_samples - 1])
    if not s_err <= STREAM_VS_FORWARD_TOL:
        fail(f"LSTRStream after {oa['stream_frames']} frames: {s_err} from forward on its window")
    print(f"LSTRStream ({smi}) over {oa['stream_frames']} frames (fp32, THUMOS-14 widths): "
          f"{statistics.median(recompute_ms):.3f} ms a frame that recomputes the compressed memory "
          f"({len(recompute_ms)} frames), {statistics.median(reuse_ms):.3f} ms a frame that reuses it "
          f"({len(reuse_ms)}), {1e3 * len(sfeat) / (sum(recompute_ms) + sum(reuse_ms)):.1f} frames/s "
          f"(synchronised a frame); last logits {s_err} from forward on the data layer's window "
          f"(<= {STREAM_VS_FORWARD_TOL})")
    del stream, lstr, train30, val30, pbatches

    # 30e. a small fp32 LSTR: two steps on the card against the CPU
    def grad_rel(cpu_grads, dev_grads):
        """The worst leaf's card-vs-CPU gradient error against max(the leaf's
        largest, 1e-2 of the largest of all), phase 15's rule: a leaf whose
        gradient is zero in exact arithmetic (an attention key's bias) holds
        summation noise only."""
        top = max(float(g_.abs().max()) for g_ in cpu_grads.values())
        return max(max_err(cpu_grads[k_], dev_grads[k_])
                   / max(float(cpu_grads[k_].abs().max()), 1e-2 * top) for k_ in cpu_grads)

    scfg = oad_lstr.LSTRConfig(**oa["small"])
    srng = np.random.default_rng(33)
    ln_, lw_ = scfg.long_memory_num_samples, scfg.work_memory_num_samples
    sbatches = [{"features": srng.standard_normal((4, ln_ + lw_, scfg.visual_size)).astype(np.float32),
                 "memory_mask": srng.uniform(size=(4, ln_)) > 0.3,
                 "targets": np.eye(scfg.num_classes, dtype=np.float32)[
                     srng.integers(0, scfg.num_classes, (4, lw_))]} for _ in range(2)]
    sruns = []
    for device in ("cpu", dev):
        sm_ = oad_lstr.LSTR(scfg, device=device, generator=torch.Generator().manual_seed(34))
        sopt = oad_data.make_optimizer(sm_, 1e-3, 5e-5)
        grads_ = []
        inner_ = sopt.step

        def rec_step(m_=sm_, g_=grads_, i_=inner_):
            g_.append({k_: p_.grad.detach().cpu().clone() for k_, p_ in m_.named_parameters()})
            i_()

        sopt.step = rec_step
        sstep = orig_oad_make(sm_, sopt)
        sruns.append(([float(sstep(b_x)) for b_x in sbatches], grads_))
    l_err = float(np.abs(np.subtract(sruns[0][0], sruns[1][0])).max())
    g_rel = max(grad_rel(gc, gd) for gc, gd in zip(sruns[0][1], sruns[1][1]))
    if not (l_err <= TRAIN_VS_CPU_TOL and g_rel <= GRAD_CARD_VS_CPU_TOL):
        fail(f"small LSTR card vs CPU: losses {l_err}, gradients {g_rel} of a leaf's largest")
    print(f"small fp32 LSTR (MAT off), two steps, card vs CPU: losses max-abs {l_err} "
          f"(<= {TRAIN_VS_CPU_TOL}), gradients {g_rel} of a leaf's largest, at least 1e-2 of "
          f"the largest of all (<= {GRAD_CARD_VS_CPU_TOL})")
    shutil.rmtree(work30, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 30: {time.perf_counter() - t30:.1f} s")

    # ---- 31. OVIS: the adapter and segmentor on the frozen flagship backbone
    from streamformer_tpu_torch.downstream import ovis_run
    from streamformer_tpu_torch.downstream import segmentor as SEG
    from streamformer_tpu_torch.eval import ytvis as ytvis_port
    from streamformer_tpu_torch.models import adapter as ADP
    from streamformer_tpu_torch.ops import msdeform_attn as MSDA

    t31 = time.perf_counter()
    ov = OVIS
    vrng = np.random.default_rng(310)

    def vis_clip(size, frames, classes):
        """A seeded clip of ``ov['instances']`` rectangles that drift a
        little from frame to frame, each a class index into
        ``selected_classes``."""
        px_ = vrng.integers(0, 256, (frames, size, size, 3), dtype=np.uint8)
        mt_ = np.full((frames, size, size), -1, np.int64)
        for c_ in range(ov["instances"]):
            y0, x0 = vrng.integers(0, size // 2, 2)
            hh, ww = vrng.integers(size // 8, size // 2, 2)
            for t_i in range(frames):
                dy, dx = vrng.integers(-size // 32, size // 32 + 1, 2)
                mt_[t_i, max(y0 + dy, 0):y0 + dy + hh, max(x0 + dx, 0):x0 + dx + ww] = c_
        return {"frames": px_, "mask_target": mt_,
                "selected_classes": vrng.choice(classes, ov["instances"], replace=False)}

    # 31d first, while the card is empty: a small fp32 adapter and segmentor, card vs CPU
    sargs = ovis_run.get_args(["--anno", "in-memory", "--num_classes", "5", "--num_queries", "8",
                               "--output_dir", os.path.join(root, "build", "ovis-small"),
                               *ov["small_flags"]])
    s_seg = SEG.SegmentorConfig(**ov["small_seg"])
    s_clip = vis_clip(64, 2, 5)
    s_runs = []
    for device in ("cpu", dev):
        base = ovis_run.build_model(sargs, device=device)  # its backbone and adapter
        open_gates(base.backbone, 31)
        sm31 = ovis_run.OVISModel(base.backbone, torch.nn.ModuleDict({
            "adapter": base.params["adapter"],
            "segmentor": SEG.Segmentor(s_seg, device=device,
                                       generator=torch.Generator().manual_seed(31))}), s_seg, {})
        spx = ovis_run.to_pixels(s_clip["frames"], device)
        with torch.no_grad():
            fpn_ = ADP.adapter_forward(sm31.params["adapter"], sm31.backbone, spx)
            out_ = sm31.forward(spx)
        sopt = ovis_run.make_optimizer(sm31.params, 1e-4, 0.05)
        inner_ = sopt.step
        grads_ = {}

        def rec31(m_=sm31, g_=grads_, i_=inner_):
            g_.update({k_: p_.grad.detach().cpu().clone() for k_, p_ in m_.params.named_parameters()})
            i_()

        sopt.step = rec31
        sloss = float(ovis_run.train_step(sm31, sopt, s_clip))
        s_runs.append(({k_: v_.cpu() for k_, v_ in fpn_.items()},
                       {k_: out_[k_].cpu() for k_ in ("pred_logits", "pred_masks", "embeddings")},
                       sloss, grads_))
    # the FPN, logits and embeddings are held max-abs; the mask logits, a
    # product of the decoder's embeddings with the per-pixel features over
    # hidden_dim channels, reach tens, and are held against max(1, their largest)
    errs31 = {k_: max_err(s_runs[0][i_][k_], s_runs[1][i_][k_])
              for i_ in (0, 1) for k_ in s_runs[0][i_]}
    mask_top = float(s_runs[0][1]["pred_masks"].abs().max())
    o_err = max(e_ for k_, e_ in errs31.items() if k_ != "pred_masks")
    m_err = errs31["pred_masks"] / max(1.0, mask_top)
    ol_err = abs(s_runs[0][2] - s_runs[1][2])
    og_rel = grad_rel(s_runs[0][3], s_runs[1][3])
    if not (o_err <= TRAIN_VS_CPU_TOL and m_err <= TRAIN_VS_CPU_TOL and ol_err <= TRAIN_VS_CPU_TOL
            and og_rel <= GRAD_CARD_VS_CPU_TOL):
        fail(f"small OVIS card vs CPU: max-abs {errs31}, masks {m_err} of {mask_top}, loss "
             f"{ol_err}, gradients {og_rel}")
    print(f"small fp32 adapter and segmentor, card vs CPU: FPN, logits and embeddings max-abs "
          f"{o_err} ({ {k_: e_ for k_, e_ in errs31.items()} }); masks {errs31['pred_masks']} "
          f"max-abs, {m_err} of max(1, their largest {mask_top:.3f}); one step's loss {ol_err} "
          f"(all <= {TRAIN_VS_CPU_TOL}), gradients {og_rel} of a leaf's largest, at least 1e-2 of "
          f"the largest of all (<= {GRAD_CARD_VS_CPU_TOL})")
    del s_runs, sm31, base

    # 31a. ovis_run.train at the CLI's defaults on in-memory clips
    work31 = tempfile.mkdtemp(prefix="ovis-", dir=os.path.join(root, "build"))
    vargs = ovis_run.get_args(["--anno", "in-memory", "--num_classes", str(ov["classes"]),
                               "--epochs", "1", "--steps_per_epoch", str(ov["steps"]),
                               "--output_dir", work31, "--seed", "31"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held31 = torch.cuda.memory_allocated()
    ovm = ovis_run.build_model(vargs)
    open_gates(ovm.backbone, 32)
    scfg31 = ovm.seg_cfg
    if ((ovm.backbone.cfg.hidden_size, ovm.backbone.cfg.num_hidden_layers, vargs.input_size,
         vargs.num_frames, vargs.lr, vargs.weight_decay) != (768, 12, 224, 2, 1e-4, 0.05)
            or (scfg31.hidden_dim, scfg31.num_queries, scfg31.num_classes, scfg31.enc_layers,
                scfg31.dec_layers) != (256, 100, ov["classes"], 3, 9)
            or ovm.params["adapter"].interaction_indexes != ADP.INTERACTION_INDEXES):
        fail(f"OVIS settings are not the CLI's defaults: {vargs}, {scfg31}")
    n_ovis = sum(p_.numel() for p_ in ovm.params.parameters())
    L31 = ovm.backbone.cfg.num_hidden_layers
    clips31 = [vis_clip(vargs.input_size, vargs.num_frames, ov["classes"])
               for _ in range(ov["steps"])]
    orig_train_step = ovis_run.train_step
    ov_ms, ov_launch = [], []

    def timed_train_step(*a_, **k_):
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        t_ = time.perf_counter()
        loss_ = orig_train_step(*a_, **k_)
        torch.cuda.synchronize()
        ov_ms.append((time.perf_counter() - t_) * 1e3)
        ov_launch.append({k2: ops.LAUNCHES[k2] - before[k2] for k2 in before})
        return loss_

    ovis_run.train_step = timed_train_step
    try:
        ops.reset_launches()
        _, hist31 = ovis_run.train(vargs, clips31, ovm)
        ovis_launches = dict(ops.LAUNCHES)
    finally:
        ovis_run.train_step = orig_train_step
    ov_peak = (torch.cuda.max_memory_allocated() - held31) / 2**30
    # MSDeformAttn calls a forward (the adapter's extractors, the pixel decoder's
    # layers): M runs them in both forwards of a step, its backward once a call
    msda31 = (sum(1 + len(getattr(blk, "extra_extractors", []))
                  for blk in ovm.params["adapter"].interactions) + scfg31.enc_layers)
    want31 = {**zeros, "spatial_flat": L31, "temporal_fullclip": L31,
              "ms_deform_attn": 2 * msda31, "ms_deform_attn_bwd": msda31}
    if len(ov_ms) != ov["steps"] or any(sl_ != want31 for sl_ in ov_launch):
        fail(f"ovis_run.train: {len(ov_ms)} steps, launches a step {ov_launch} (want {want31})")
    if not (np.isfinite(hist31[0]["loss"]) and ckpt_lib.latest_checkpoint(work31) == 0):
        fail(f"ovis_run.train: stats {hist31}")
    steady31 = statistics.median(ov_ms[1:])

    # 31b. a 3-step profile; MSDeformAttn's device time, its calls replayed
    # alone at the step's shapes (forward and backward as the step runs them).
    # The same step keeps the inputs of a middle layer's B and C calls, and
    # M's inputs and output gradient at the first call of each shape.
    captured = []
    orig_msda = (ADP.ms_deform_attn, SEG.ms_deform_attn)
    orig_core, m_held = MSDA.ms_deform_attn_core, {}

    def keep_core(value, shapes, loc, weight):
        out = orig_core(value, shapes, loc, weight)
        key = (tuple(tuple(hw) for hw in shapes), tuple(value.shape))
        if out.requires_grad and key not in m_held:
            entry = m_held[key] = [x_.detach().clone() for x_ in (value, loc, weight)] + [None]
            out.register_hook(lambda g_, e_=entry: e_.__setitem__(3, g_.detach().clone()))
        return out

    held31, calls31 = {}, {"b": 0, "c": 0}
    orig31 = {"b": ops.spatial_flat, "c": ops.temporal_fullclip_qkv}

    def keep31(key, args):
        if calls31[key] == L31 // 2:
            held31[key] = [x_.detach().clone() if torch.is_tensor(x_) else x_ for x_ in args]
        calls31[key] += 1
        return orig31[key](*args)

    def capturing(module, query, ref, value, shapes):
        captured.append((module, query.detach(), ref, value.detach(), list(shapes),
                         torch.is_grad_enabled()))
        return MSDA.ms_deform_attn(module, query, ref, value, shapes)

    ADP.ms_deform_attn = SEG.ms_deform_attn = capturing
    MSDA.ms_deform_attn_core = keep_core
    ops.spatial_flat = lambda *a_: keep31("b", a_)
    ops.temporal_fullclip_qkv = lambda *a_: keep31("c", a_)
    popt = ovis_run.make_optimizer(ovm.params, vargs.lr, vargs.weight_decay)
    try:
        orig_train_step(ovm, popt, clips31[0])
    finally:
        ADP.ms_deform_attn, SEG.ms_deform_attn = orig_msda
        MSDA.ms_deform_attn_core = orig_core
        ops.spatial_flat, ops.temporal_fullclip_qkv = orig31["b"], orig31["c"]
    torch.cuda.synchronize()
    # B and C at the OVIS backbone's shapes (fp32, 2 frames), on the inputs of
    # the step's calls, against their plain versions
    if set(held31) != {"b", "c"}:
        fail(f"OVIS step: {calls31} calls of B and C, none captured at call {L31 // 2}")
    qkv, hh = held31["c"][:2]  # the encoder also passes its causal flag (True)
    b31, tf31, n31, d31 = qkv.shape[0], qkv.shape[1], qkv.shape[2], qkv.shape[3] // 3
    dn, elt = str(qkv.dtype).split(".")[1], qkv.element_size()
    qh, kh, vh = (x_.reshape(b31, tf31, n31, hh, d31 // hh).permute(0, 2, 3, 1, 4)
                  for x_ in qkv.split(d31, dim=-1))
    record("temporal_fullclip", f"OVIS backbone qkv {tuple(qkv.shape)} H={hh}", dn,
           max_err(ops.temporal_fullclip_qkv(qkv, hh), ops.temporal_fullclip_qkv_plain(qkv, hh)),
           lambda: ops.temporal_fullclip_qkv(qkv, hh),
           lambda: ops.temporal_fullclip_qkv_plain(qkv, hh),
           lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
           4 * elt * b31 * tf31 * n31 * d31, 2 * tf31 * (tf31 + 1) * b31 * n31 * d31)
    q, k, v, hh = held31["b"]
    r, n31 = q.shape[:2]
    qh, kh, vh = (x_.view(r, n31, hh, d31 // hh).transpose(1, 2) for x_ in (q, k, v))
    record("spatial_flat", f"OVIS backbone R={r} N={n31}", dn,
           max_err(ops.spatial_flat(q, k, v, hh), ops.spatial_flat_plain(q, k, v, hh)),
           lambda: ops.spatial_flat(q, k, v, hh), lambda: ops.spatial_flat_plain(q, k, v, hh),
           lambda: F.scaled_dot_product_attention(qh, kh, vh),
           4 * elt * r * n31 * d31, 4 * r * n31 * n31 * d31)
    del held31, qkv, q, k, v, qh, kh, vh

    def m_grad_err(got, want, loc, shapes):
        """The worst of M's three gradients against max(1, its largest),
        the locations' off the kinks: a pixel coordinate within 1e-4 of an
        integer, where bilinear sampling's derivative jumps and two right
        implementations whose coordinates differ in the last bit may give
        either side's (tests/test_torch_cuda.py). Returns the error and the
        coordinates left out."""
        size = torch.tensor([[wd, ht] for ht, wd in shapes], dtype=torch.float64, device=dev)
        pos = loc.double() * size[:, None, :] - 0.5
        keep = (pos - pos.round()).abs() >= 1e-4
        errs = []
        for i_, (a_, b_) in enumerate(zip(got, want)):
            diff = (a_.float() - b_.float()).abs()
            if i_ == 1:
                diff = torch.where(keep, diff, torch.zeros_like(diff))
            errs.append(diff.max().item() / max(1.0, b_.abs().max().item()))
        return max(errs), int((~keep).sum())

    # M at the step's shapes, forward and backward, on the captured calls
    if len(m_held) != 2 or any(e_[3] is None for e_ in m_held.values()):
        fail(f"OVIS step: M's calls captured at {sorted(m_held)}, output gradients "
             f"{[e_[3] is not None for e_ in m_held.values()]} (want an extractor's and a pixel "
             "decoder layer's)")
    m_main = {}
    for (shp, _), (v_, l_, w_, g_) in m_held.items():
        where = "extractor" if len(shp) == 1 else "pixel decoder"
        tag = f"OVIS {where} value {tuple(v_.shape)} loc {tuple(l_.shape)} levels {list(shp)}"
        m_main[where] = tag
        dn, elt = str(v_.dtype).split(".")[1], v_.element_size()
        samples = l_[..., 0].numel()  # (b, q, m, l, p) samples, each over D channels
        ins = elt * (v_.numel() + l_.numel() + w_.numel())
        with torch.no_grad():
            err = max_err(MSDA.ms_deform_attn_core(v_, shp, l_, w_),
                          MSDA.ms_deform_attn_core_plain(v_, shp, l_, w_))
        # forward: a multiply-add a corner and one for the weight, a channel
        record("ms_deform_attn", tag, dn, err, lambda: MSDA.ms_deform_attn_core(v_, shp, l_, w_),
               lambda: MSDA.ms_deform_attn_core_plain(v_, shp, l_, w_), None,
               ins + elt * g_.numel(), 10 * samples * v_.shape[-1])
        pargs = [x_.clone().requires_grad_() for x_ in (v_, l_, w_)]
        pout = MSDA.ms_deform_attn_core_plain(pargs[0], shp, pargs[1], pargs[2])
        err, kinks = m_grad_err(MSDA.ms_deform_attn_core_backward(v_, shp, l_, w_, g_),
                                torch.autograd.grad(pout, pargs, g_, retain_graph=True), l_, shp)
        # backward: the gathers, four scattered adds, the three gradients' sums
        record("ms_deform_attn_bwd", tag, dn, err,
               lambda: MSDA.ms_deform_attn_core_backward(v_, shp, l_, w_, g_),
               lambda: torch.autograd.grad(pout, pargs, g_, retain_graph=True), None,
               2 * ins + elt * g_.numel(), 28 * samples * v_.shape[-1])
        print(f"M {tag} ({smi}): {kinks} of {l_.numel()} location coordinates on a kink, left "
              "out of the backward's location error")
        del pargs, pout
    del m_held
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for c_ in clips31[1:1 + ov["profiled"]]:
            orig_train_step(ovm, popt, c_)
        torch.cuda.synchronize()
    rows31 = device_rows(prof)
    if not rows31:
        fail("the OVIS profile read no device time")
    ov_busy = sum(e.device_time_total for e in rows31) / ov["profiled"] / 1e3
    ov_ops = sum(e.count for e in rows31) / ov["profiled"]
    m_ms = sum(e.device_time_total for e in rows31 if "msdeform_attn" in e.key) / ov["profiled"] / 1e3

    def replay():
        for module, q_, r_, v_, shp, grad in captured:
            if grad:
                q_ = q_.clone().requires_grad_()
                v_ = v_.clone().requires_grad_()
                MSDA.ms_deform_attn(module, q_, r_, v_, shp).sum().backward()
            else:
                with torch.no_grad():
                    MSDA.ms_deform_attn(module, q_, r_, v_, shp)

    msda_ms = time_ms(replay, iters=5)  # the calls' wall time alone: host launches too
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    msda_dev = sum(e.device_time_total for e in device_rows(prof)) / 1e3
    ovm.params.zero_grad()
    n_msda = (sum(1 for c_ in captured if not c_[5]), sum(1 for c_ in captured if c_[5]))
    if n_msda != (msda31, msda31):
        fail(f"OVIS step: MSDeformAttn calls {n_msda} without and with a graph (want {msda31} each)")
    print(f"OVIS training ({smi}): ovis_run.train at the CLI's defaults (the flagship backbone "
          f"frozen, fp32, {vargs.num_frames} frames of {vargs.input_size}^2; adapter and segmentor "
          f"{n_ovis / 1e6:.1f} M parameters, {scfg31.num_queries} queries, {scfg31.num_classes} "
          f"classes; AdamW 1e-4 / 0.05), {ov['instances']} instances a clip: {ov['steps']} steps "
          f"{[round(x_, 1) for x_ in ov_ms]} ms (synchronised); steady {steady31:.2f} ms per step, "
          f"{1e3 / steady31:.2f} clips/s; loss {hist31[0]['loss']:.4f}; peak {ov_peak:.2f} GiB above "
          f"what earlier phases hold (the model included); "
          f"launches a step {ov_launch[0]}; the profile: device busy {ov_busy:.2f} ms a step "
          f"({100 * ov_busy / steady31:.1f} % of the step), {ov_ops:.0f} launches a step")
    print(f"MSDeformAttn ({smi}): {n_msda[0]} calls without a graph and {n_msda[1]} with one a "
          f"step, replayed alone: device time {msda_dev:.3f} ms ({100 * msda_dev / ov_busy:.1f} % "
          f"of the step's device busy time), wall {msda_ms:.2f} ms (events, L2 flushed first; "
          f"{100 * msda_ms / steady31:.1f} % of the step); kernel M (forward and backward) in the "
          f"step's profile {m_ms:.3f} ms a step ({100 * m_ms / ov_busy:.1f} % of busy)")
    for e in sorted(rows31, key=lambda e: -e.device_time_total)[:8]:
        print(f"  {e.device_time_total / ov['profiled'] / 1e3:8.4f} ms/step  "
              f"x{e.count / ov['profiled']:<6.1f} {e.key[:90]}")
    del captured, popt

    # 31c. run_inference on two in-memory videos through HungarianTracker, scored
    iargs = ovis_run.get_args(["--anno", "in-memory", "--num_classes", str(ov["classes"]),
                               "--output_dir", work31, "--num_frames", str(ov["video_frames"]),
                               "--tracker", "HungarianTracker"])
    frames31, videos31, annos31 = {}, {}, {}
    vh, vw = ov["video_height"], ov["video_width"]
    for vid in range(1, ov["videos"] + 1):
        names = []
        for f_i in range(ov["video_frames"]):
            name = f"v{vid}/{f_i:03d}.jpg"
            frames31[name] = vrng.integers(0, 256, (vargs.input_size, vargs.input_size, 3),
                                           dtype=np.uint8)
            names.append(name)
        videos31[vid] = {"id": vid, "file_names": names, "height": vh, "width": vw}
        mask = np.zeros((vh, vw), bool)
        mask[vh // 4:vh // 2, vw // 4:vw // 2] = True
        annos31[vid] = [{"video_id": vid, "category_id": vid,
                         "segmentations": [ytvis_port.mask_to_rle(mask)] * ov["video_frames"]}]

    class Videos:
        """In-memory videos in VISDataset's schema (ids, videos, annos)."""
        ids = sorted(videos31)
        videos = videos31
        annos = annos31

    ops.reset_launches()
    t0 = time.perf_counter()
    line31 = ovis_run.run_inference(iargs, ovm,
                                    load_frame=lambda path: frames31[path],
                                    ds=Videos())
    torch.cuda.synchronize()
    inf_s = time.perf_counter() - t0
    inf_launches = dict(ops.LAUNCHES)
    add(ovis_launches, inf_launches)
    n_frames31 = ov["videos"] * ov["video_frames"]
    with open(os.path.join(work31, "results.json")) as f_:
        rows_json = json.load(f_)
    if (inf_launches != {**zeros, "spatial_flat": L31 * n_frames31,
                         "temporal_fullclip": L31 * n_frames31,
                         "ms_deform_attn": msda31 * n_frames31}
            or line31["num_videos"] != ov["videos"] or "AP" not in line31
            or not all(len(r_["segmentations"]) == ov["video_frames"] for r_ in rows_json)):
        fail(f"OVIS inference: {line31}, launches {inf_launches}")
    print(f"OVIS inference ({smi}): {ov['videos']} videos of {ov['video_frames']} frames, "
          f"HungarianTracker, {len(rows_json)} tracks in results.json; YTVIS "
          f"{ {k_: round(v_, 4) for k_, v_ in line31.items() if k_ not in ('tracker', 'num_videos')} }; "
          f"{1e3 * inf_s / n_frames31:.1f} ms a frame; launches {inf_launches}")
    shutil.rmtree(work31, ignore_errors=True)
    del ovm, clips31
    torch.cuda.empty_cache()
    print(f"phase 31: {time.perf_counter() - t31:.1f} s")

    # ---- 32. deployment: the HF checkpoint writer and torch.export artifacts
    # of the encoder's programs and the LM decode step, at the flagship
    t32 = time.perf_counter()
    from streamformer_tpu_torch import export as EX
    from streamformer_tpu_torch.checkpoint import save_pretrained

    torch.cuda.empty_cache()
    work32 = tempfile.mkdtemp(prefix="export-", dir=os.path.join(root, "build"))
    export_launches = dict(zeros)
    try:
        # 32a. save_pretrained, then from_pretrained: bit for bit
        hf_dir = os.path.join(work32, "hf")
        t0 = time.perf_counter()
        hf_bytes = save_pretrained(hf_dir, model, cfg)
        hf_s = time.perf_counter() - t0
        back = from_pretrained(hf_dir)
        back_sd = back.state_dict()
        diff = [k for k, v in model.state_dict().items() if not torch.equal(back_sd[k], v)]
        if diff or back.device.type != dev.type:
            fail(f"save_pretrained -> from_pretrained: {len(diff)} tensors differ ({diff[:4]})")
        print(f"save_pretrained ({smi}): the flagship encoder as config.json and "
              f"model.safetensors (fp32, reference names, no safetensors package): {hf_bytes} "
              f"bytes in {hf_s:.2f} s; from_pretrained gives back all {len(model.state_dict())} "
              "tensors bit for bit")
        del back

        def graph_copies(prog):
            """Clones and copies in a program's graph (a mutated input that
            export functionalized); lifted constants are not copies."""
            return [str(n_.target) for n_ in prog.module.graph.nodes if n_.op == "call_function"
                    and any(w_ in str(n_.target)
                            for w_ in ("clone", "copy_", "auto_functionalized"))]

        def exported(kind, make, tag):
            """Export to a file, load it back; (program, export s, bytes)."""
            path = os.path.join(work32, f"{tag}.pt2")
            t0_ = time.perf_counter()
            make(path)
            ex_s = time.perf_counter() - t0_
            prog = EX.load_exported(path)
            if prog.metadata["kind"] != kind or prog.metadata["device_type"] != "cuda":
                fail(f"{tag}: artifact metadata {prog.metadata['kind']}, "
                     f"{prog.metadata['device_type']}")
            return prog, ex_s, os.path.getsize(path)

        def hold(tag, got, want):
            """Exported against live: bit for bit expected (the same kernels in
            the same order); else within the kernels' bf16 gate."""
            errs = [max_err(got[k_], want[k_]) for k_ in ("last_hidden_state", "pooler_output")]
            if max(errs) > TOL["bfloat16"]:
                fail(f"{tag}: exported against live max-abs {errs}")
            return all(torch.equal(got[k_], want[k_]) for k_ in ("last_hidden_state",
                                                               "pooler_output")), max(errs)

        def report(tag, prog, ex_s, nbytes, equal, err, runs, launches_, live_ms, exp_ms):
            copies = graph_copies(prog)
            print(f"export {tag} ({smi}): export {ex_s:.2f} s, artifact {nbytes} bytes (no "
                  f"weights), loaded from its file; outputs against the live calls over {runs} "
                  f"calls: {'bit for bit' if equal else f'max-abs {err}'}; launches inside the "
                  f"program {({k_: v_ for k_, v_ in launches_.items() if v_})}; median ms a call "
                  f"exported {exp_ms:.3f} against live {live_ms:.3f}; copies of the cache in the "
                  f"graph: {len(copies)} {copies[:4]}")

        # the programs are exported and run at a depth cut to EXPORT_LAYERS
        # (the flagship's first layers): every kernel still runs in each,
        # L32 times a call; the export's seconds are the depth's
        cfg32 = cfg.replace(num_hidden_layers=EXPORT_LAYERS)
        L32 = cfg32.num_hidden_layers
        model32 = encoder.StreamformerEncoder(cfg32, device=dev)
        model32.load_state_dict({k_: v_ for k_, v_ in model.state_dict().items()
                                 if k_ in model32.state_dict()})
        params = model32.state_dict()
        # an artifact takes frames in the compute dtype (static shapes and
        # dtypes); the live calls cast them to it first
        vid = video.to(encoder.compute_dtype(cfg32))

        # 32b. the full clip at batch 8 x 16 frames: B and C
        prog, ex_s, nbytes = exported("full_clip", lambda path_: EX.export_full_clip(
            cfg32, b_, t_, path=path_), "full_clip")
        ops.reset_launches()
        got = prog(params, vid)
        torch.cuda.synchronize()
        fc_launches = dict(ops.LAUNCHES)
        add(export_launches, fc_launches)
        want = encoder.model_forward(model32, vid)
        equal, err = hold("full clip", got, want)
        if fc_launches != {**zeros, "spatial_flat": L32, "temporal_fullclip": L32}:
            fail(f"exported full clip launches {fc_launches}")
        report(f"full clip B={b_} T={t_}", prog, ex_s, nbytes, equal, err, 1, fc_launches,
               time_ms(lambda: encoder.model_forward(model32, vid), iters=5),
               time_ms(lambda: prog(params, vid), iters=5))
        del prog, got, want

        def stream_case(tag, kind_cfg, t_new, calls, ragged, counted):
            """The exported step against the live one, each on its own cache,
            ``calls`` calls of t_new frames of ``vid`` (frame i % T); the
            kernel ``counted`` and B must run L32 times a call inside the
            program (t_new = 1 for A and G; E takes the t_new frames at once)."""
            prog_, ex_s_, nbytes_ = exported(
                "streaming_step", lambda path_: EX.export_streaming_step(
                    kind_cfg, b_, t_new, per_stream_len=ragged, path=path_), tag)
            c_live = encoder.init_cache(kind_cfg, b_, per_stream_len=ragged)
            c_exp = encoder.init_cache(kind_cfg, b_, per_stream_len=ragged)
            equal_, err_, launched = True, 0.0, dict(zeros)
            for i_ in range(calls):
                x_ = vid[:, [(i_ * t_new + j_) % t_ for j_ in range(t_new)]]
                if ragged and i_ * t_new % kind_cfg.cache_capacity == 0:  # the linear cache full
                    done_ = torch.ones(b_, dtype=torch.bool, device=dev)
                    encoder.reset_streams(c_live, done_)
                    encoder.reset_streams(c_exp, done_)
                live_, c_live = encoder.streaming_forward(model32, x_, c_live, cfg=kind_cfg)
                ops.reset_launches()
                got_, c_exp = prog_(params, x_, c_exp)
                torch.cuda.synchronize()
                add(launched, ops.LAUNCHES)
                eq_, e_ = hold(tag, got_, live_)
                equal_, err_ = equal_ and eq_, max(err_, e_)
            if launched != {**zeros, counted: L32 * calls, "spatial_flat": L32 * calls}:
                fail(f"exported {tag}: launches {launched} over {calls} calls")
            if not torch.equal(c_live["len"], c_exp["len"]):
                fail(f"exported {tag}: lengths {c_exp['len'].tolist()} vs {c_live['len'].tolist()}")
            add(export_launches, launched)
            x_ = vid[:, :t_new]

            def live_call():
                if ragged:
                    encoder.reset_streams(c_live, torch.ones(b_, dtype=torch.bool, device=dev))
                encoder.streaming_forward(model32, x_, c_live, cfg=kind_cfg)

            def exp_call():
                if ragged:
                    encoder.reset_streams(c_exp, torch.ones(b_, dtype=torch.bool, device=dev))
                prog_(params, x_, c_exp)

            report(tag, prog_, ex_s_, nbytes_, equal_, err_, calls, launched,
                   time_ms(live_call, iters=9), time_ms(exp_call, iters=9))

        # 32c. the streaming step at batch 8 on the ring, C=16, t=1: A and B
        stream_case(f"streaming step B={b_} ring C={cap} t=1", cfg32.replace(cache_mode="ring"), 1,
                    cap + 4, False, "temporal_decode_pm")
        # 32d. the ragged append at t=8 on the linear cache, C=16: E and B
        stream_case(f"ragged append B={b_} linear C={cap} t={E_T}", cfg32, E_T, 2 * cap // E_T,
                    True, "temporal_append_pm_ragged")
        # 32e. the ragged int8-cache step, t=1: G and B
        stream_case(f"ragged int8-cache step B={b_} linear C={cap} t=1",
                    cfg32.replace(cache_dtype="int8"), 1, 6, True,
                    "temporal_decode_pm_int8_ragged")

        # 32f. the LM decode step at Qwen2.5-7B widths, two layers, 8 slots,
        # run by DecodeEngine in place of its live step: the same greedy tokens
        cfg7x = LM.LMConfig(**{**LM_7B, "num_hidden_layers": 2})
        lm7x = LM.LanguageModel(cfg7x, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(32))
        lm_cap = LM_EXPORT["capacity"]
        prog, ex_s, nbytes = exported("lm_decode", lambda path_: EX.export_lm_decode(
            cfg7x, LM_EXPORT["slots"], lm_cap, path=path_), "lm_decode")
        lm_params = lm7x.state_dict()
        erng = np.random.default_rng(32)
        e_prompts = [erng.integers(0, cfg7x.vocab_size, (int(n_),))
                     for n_ in erng.integers(16, 64, LM_EXPORT["requests"])]

        def lm_serve(exported_step):
            eng = DecodeEngine(lm7x, slots=LM_EXPORT["slots"], capacity=lm_cap,
                               prefill_buckets=(64,), max_new_tokens=LM_EXPORT["new"])
            if exported_step:
                def step(toks):
                    ntok, eng._cache = prog(lm_params, toks, eng._cache, eng._active_dev)
                    eng._counts_dev += eng._active_dev.long()
                    return ntok.long()

                eng._decode_step = step
            sids = [eng.open_tokens(p_) for p_ in e_prompts]
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            ticks = eng.run_until_idle()
            toks = [eng.poll(s_)[0] for s_ in sids]
            torch.cuda.synchronize()
            return toks, (time.perf_counter() - t0_) * 1e3 / ticks

        live_toks, _ = lm_serve(False)
        exp_toks, _ = lm_serve(True)
        live_toks, live_tick = lm_serve(False)
        exp_toks2, exp_tick = lm_serve(True)
        if exp_toks != live_toks or exp_toks2 != live_toks or \
                any(len(t_) != LM_EXPORT["new"] for t_ in live_toks):
            fail(f"LM decode artifact: tokens differ from DecodeEngine's ({exp_toks[:2]} vs "
                 f"{live_toks[:2]})")
        print(f"export LM decode ({smi}): Qwen2.5-7B widths, 2 layers, bf16, {LM_EXPORT['slots']} "
              f"slots, capacity {lm_cap}: export {ex_s:.2f} s, artifact {nbytes} bytes (no "
              f"weights); DecodeEngine with the artifact as its decode step gives the live "
              f"engine's greedy tokens ({LM_EXPORT['requests']} requests of {LM_EXPORT['new']} "
              f"tokens, slots recycled); ms a tick exported {exp_tick:.3f} against live "
              f"{live_tick:.3f}; copies of the cache in the graph: {len(graph_copies(prog))}")
        del prog, lm7x, lm_params, model32
    finally:
        shutil.rmtree(work32, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 32: {time.perf_counter() - t32:.1f} s")

    # ---- 33. shapes and attention types past the first slices, at the flagship width
    t33 = time.perf_counter()
    captured = {}
    patched = {}

    def capture(fn_name, key):
        """Wrap ops.<fn_name> so that its first call's arguments (tensors
        cloned) are kept under ``key``; the wrapper's launches still count."""
        orig = patched.setdefault(fn_name, getattr(ops, fn_name))

        def wrapped(*a_, **k_):
            if key not in captured:
                captured[key] = tuple(x_.detach().clone() if torch.is_tensor(x_) else x_
                                      for x_ in a_)
            return orig(*a_, **k_)

        setattr(ops, fn_name, wrapped)

    def restore():
        for fn_name, orig in patched.items():
            setattr(ops, fn_name, orig)
        patched.clear()

    def capture_all(tag):
        capture("_spatial_flat_forward", ("B", tag))
        capture("spatial_flat_bwd", ("I", tag))
        capture("_temporal_fullclip_qkv_forward", ("C", tag))
        capture("temporal_fullclip_qkv_bwd", ("H", tag))

    def sdpa_rows(x, heads):  # (R, L, D) -> (R, H, L, dh)
        return x.view(x.shape[0], x.shape[1], heads, -1).transpose(1, 2)

    def check_b(tag, shape_tag=None):
        """B on its captured inputs against its plain version, L (B's body
        on head-split strides) on the same against its own and bit-equal to
        B; a kernel row when ``shape_tag`` names one."""
        q, k, v, h = captured[("B", tag)]
        r, n, d = q.shape
        dn = str(q.dtype).split(".")[1]
        out = ops.spatial_flat(q, k, v, h)
        err = max_err(out, ops.spatial_flat_plain(q, k, v, h))
        if not err <= TOL[dn]:
            fail(f"spatial_flat {tag} R={r} N={n} {dn}: max-abs error {err}")
        split = [sdpa_rows(x, h).contiguous() for x in (q, k, v)]
        out_l = ops.spatial_attention(*split)
        err_l = max_err(out_l, ops.spatial_attention_plain(*split))
        if not (err_l <= TOL[dn] and torch.equal(out_l.transpose(1, 2).reshape(r, n, d), out)):
            fail(f"spatial_attention {tag} N={n} {dn}: max-abs error {err_l}, or not bit-equal "
                 f"to B")
        if shape_tag:
            qh, kh, vh = (sdpa_rows(x, h) for x in (q, k, v))
            nbytes, flops = 4 * q.element_size() * r * n * d, 4 * r * n * n * d
            record("spatial_flat", shape_tag, dn, err, lambda: ops.spatial_flat(q, k, v, h),
                   lambda: ops.spatial_flat_plain(q, k, v, h),
                   lambda: F.scaled_dot_product_attention(qh, kh, vh), nbytes, flops)
            record("spatial_attention", shape_tag, dn, err_l,
                   lambda: ops.spatial_attention(*split),
                   lambda: ops.spatial_attention_plain(*split),
                   lambda: F.scaled_dot_product_attention(*split), nbytes, flops)
        return err, err_l

    def unit_grad(shape, dtype, plain):
        """A randn output gradient of ``shape``, scaled so that the smallest
        peak of the plain version's gradients (``plain(g)``) is 1 (the
        backward is linear in g; the path's own gradients are too small for
        the limit to see them); returns it and those gradients."""
        g = torch.randn(shape, device=dev, generator=gen)
        peak = min(x.float().abs().max().item() for x in plain(g.to(dtype)))
        g = (g / peak).to(dtype)
        return g, plain(g)

    def grads_check(name, got, ref, dtype_name="bfloat16"):
        """Each gradient held to TOL times max(1, its own peak), which a
        zeroed one (a peak of at least 1 away) cannot meet; returns the worst
        error and the largest limit."""
        errs = [max_err(a, b) for a, b in zip(got, ref)]
        lims = [TOL[dtype_name] * max(1.0, b.float().abs().max().item()) for b in ref]
        peaks = [b.float().abs().max().item() for b in ref]
        if not all(e_ <= l_ < p_ for e_, l_, p_ in zip(errs, lims, peaks)):
            fail(f"{name}: max-abs errors {errs}, limits {lims}, gradient peaks {peaks}")
        return max(errs), max(lims)

    def check_i(tag, shape_tag=None):
        q, k, v, g, h = captured[("I", tag)]
        r, n, d = q.shape
        dn = str(q.dtype).split(".")[1]
        g, ref = unit_grad(g.shape, g.dtype, lambda g_: ops.spatial_flat_bwd_plain(q, k, v, g_, h))
        err, lim = grads_check(f"spatial_flat_bwd {tag} R={r} N={n} {dn}",
                               ops.spatial_flat_bwd(q, k, v, g, h), ref, dn)
        if shape_tag:
            qh, kh, vh = (sdpa_rows(x, h).detach().requires_grad_() for x in (q, k, v))
            gh = sdpa_rows(g, h)
            out = F.scaled_dot_product_attention(qh, kh, vh)
            record("spatial_flat_bwd", shape_tag, dn, err,
                   lambda: ops.spatial_flat_bwd(q, k, v, g, h),
                   lambda: ops.spatial_flat_bwd_plain(q, k, v, g, h),
                   lambda: torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True),
                   7 * q.element_size() * r * n * d, 10 * r * n * n * d, tol=lim)
        return err

    def packed_rows(qkv):  # (B, T, N, 3D) -> three (B*N, T, D) views
        b, t, n, d3 = qkv.shape
        return [x.transpose(1, 2).reshape(b * n, t, d3 // 3) for x in ops._thirds(qkv)]

    def check_ch(tag, shape_tag=None, repeat=1):
        """C and H on their captured (B, T, N, 3D) inputs (batch repeated
        ``repeat`` times) against their plain versions."""
        qkv, h, causal = (captured[("C", tag)] + (True,))[:3]
        qkv_h, g, h_h, causal_h = (captured[("H", tag)] + (True,))[:4]
        if repeat > 1:
            qkv, qkv_h = (x.repeat(repeat, 1, 1, 1) for x in (qkv, qkv_h))
        b, t, n, d3 = qkv.shape
        r, d = b * n, d3 // 3
        err = max_err(ops.temporal_fullclip_qkv(qkv, h, causal),
                      ops.temporal_fullclip_qkv_plain(qkv, h, causal))
        if not err <= TOL["bfloat16"]:
            fail(f"temporal_fullclip {tag} R={r} T={t}: max-abs error {err}")
        g, ref = unit_grad((b, t, n, d), g.dtype, lambda g_: ops._thirds(
            ops.temporal_fullclip_qkv_bwd_plain(qkv_h, g_, h_h, causal_h)))
        err_h, lim = grads_check(f"temporal_fullclip_bwd {tag} R={r} T={t}", ops._thirds(
            ops.temporal_fullclip_qkv_bwd(qkv_h, g, h_h, causal_h)), ref)
        if shape_tag:
            qh, kh, vh = (sdpa_rows(x, h) for x in packed_rows(qkv))
            record("temporal_fullclip", shape_tag, "bfloat16", err,
                   lambda: ops.temporal_fullclip_qkv(qkv, h, causal),
                   lambda: ops.temporal_fullclip_qkv_plain(qkv, h, causal),
                   lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal),
                   4 * 2 * r * t * d, (2 * t * (t + 1) if causal else 4 * t * t) * r * d)
            qg, kg, vg = (sdpa_rows(x, h).detach().requires_grad_() for x in packed_rows(qkv_h))
            gh = sdpa_rows(g.transpose(1, 2).reshape(r, t, d), h)
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal_h)
            record("temporal_fullclip_bwd", shape_tag, "bfloat16", err_h,
                   lambda: ops.temporal_fullclip_qkv_bwd(qkv_h, g, h_h, causal_h),
                   lambda: ops.temporal_fullclip_qkv_bwd_plain(qkv_h, g, h_h, causal_h),
                   lambda: torch.autograd.grad(out, (qg, kg, vg), gh, retain_graph=True),
                   7 * 2 * r * t * d, (5 * t * (t + 1) if causal_h else 10 * t * t) * r * d,
                   tol=lim)
        return err, err_h

    def fwd_bwd(m, x, tag, want):
        """The full clip, then the backward of its pooled output's sum into
        the frames (kernels H and I behind C and B); launches held to
        ``want``."""
        capture_all(tag)
        ops.reset_launches()
        try:
            px = x.detach().clone().requires_grad_()
            out = encoder.model_forward(m, px)
            out["pooler_output"].float().sum().backward()
            torch.cuda.synchronize()
        finally:
            restore()
        got = dict(ops.LAUNCHES)
        if got != {**zeros, **want}:
            fail(f"{tag}: full clip and backward launches {got}, not {want}")
        if not (finite(out) and torch.isfinite(px.grad).all()):
            fail(f"{tag}: outputs or gradient not finite")
        return {k_: v_.detach() for k_, v_ in out.items()}, got

    def stream_vs(m, x, full_out, tag, want, **kw):
        """x streamed a frame a call on a linear cache of x's length, each
        frame held to the full clip within the streaming gates; launches
        held to ``want``; returns the worst errors and the bit-equal frames."""
        cfg_s = m.cfg.replace(cache_mode="linear")
        cache_s = encoder.init_cache(cfg_s, x.shape[0], capacity=x.shape[1], device=dev)
        ops.reset_launches()
        wh = wp = 0.0
        same = 0
        outs = []
        for i in range(x.shape[1]):
            o_, cache_s = encoder.streaming_forward(m, x[:, i:i + 1], cache_s, cfg=cfg_s, **kw)
            outs.append(o_)
            eh = max_err(o_["last_hidden_state"], full_out["last_hidden_state"][:, i:i + 1])
            ep = max_err(o_["pooler_output"], full_out["pooler_output"][:, i:i + 1])
            wh, wp = max(wh, eh), max(wp, ep)
            same += int(torch.equal(o_["last_hidden_state"],
                                    full_out["last_hidden_state"][:, i:i + 1]))
        torch.cuda.synchronize()
        got = dict(ops.LAUNCHES)
        if got != {**zeros, **want}:
            fail(f"{tag} stream: launches {got}, not {want}")
        if not (wh <= STREAM_TOL_HIDDEN and wp <= STREAM_TOL_POOLED):
            fail(f"{tag} stream: hidden err {wh} (<= {STREAM_TOL_HIDDEN}), pooled err {wp} "
                 f"(<= {STREAM_TOL_POOLED})")
        return wh, wp, same, outs, got

    shapes_launches = dict(zeros)
    bc = {"spatial_flat": L, "temporal_fullclip": L}
    bcih = {**bc, "temporal_fullclip_bwd": L, "spatial_flat_bwd": L}

    # 33a. ar_run.train at 384^2 (576 patches a frame), 16 frames, batch 4
    t_a = time.perf_counter()
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    srng = np.random.default_rng(33)
    s_pool = [srng.integers(0, 256, (SHAPES["ar_frames"], SHAPES["ar_height"], SHAPES["ar_width"],
                                     3), dtype=np.uint8) for _ in range(SHAPES["ar_batch"])]

    class SClips:
        def __len__(self):
            return SHAPES["ar_batch"] * SHAPES["ar_steps"]

        def __getitem__(self, i):
            return {"task_input": {"frames": s_pool[i % len(s_pool)], "label": (37 * i) % 400}}

    work33 = tempfile.mkdtemp(prefix="shapes-", dir=os.path.join(root, "build"))
    step_ms.clear()  # phase 29's timed steps, read again here
    step_launches.clear()
    try:
        sargs = ar_run.get_args([
            "--anno_train", "in-memory", "--num_classes", "400", "--bf16", "--epochs", "1",
            "--batch_size", str(SHAPES["ar_batch"]), "--input_size", str(SHAPES["ar_size"]),
            "--num_frames", str(SHAPES["ar_frames"]), "--num_workers", "2",
            "--output_dir", work33, "--seed", "33"])
        AR_mod.make_train_step = timed_make
        s_model = ar_run.build_model(sargs)
        capture_all("384")
        ops.reset_launches()
        s_res = ar_run.train(sargs, SClips(), model=s_model)
        torch.cuda.synchronize()
    finally:
        restore()
        AR_mod.make_train_step = orig_make
        shutil.rmtree(work33, ignore_errors=True)
    add(shapes_launches, ops.LAUNCHES)
    s_peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    if len(step_ms) != SHAPES["ar_steps"] or any(sl_ != {**zeros, **bcih} for sl_ in step_launches):
        fail(f"33a: {len(step_ms)} steps, launches a step {step_launches}")
    if not np.isfinite(s_res["history"][0]["loss"]):
        fail(f"33a: loss {s_res['history'][0]['loss']}")
    n384 = (SHAPES["ar_size"] // 16) ** 2
    r384 = SHAPES["ar_batch"] * SHAPES["ar_frames"]
    del s_model
    torch.cuda.empty_cache()
    eb, el = check_b("384", f"R={r384} N={n384}")
    ei = check_i("384", f"R={r384} N={n384}")
    ec, eh_ = check_ch("384")
    print(f"33a ({smi}): ar_run.train at {SHAPES['ar_size']}^2 ({n384} patches), "
          f"{SHAPES['ar_frames']} frames, batch {SHAPES['ar_batch']}, bf16 over fp32 masters: "
          f"{SHAPES['ar_steps']} steps {[round(x_, 2) for x_ in step_ms]} ms (synchronised), "
          f"steady {statistics.median(step_ms[1:]):.2f} ms a step; loss "
          f"{s_res['history'][0]['loss']:.4f}; "
          f"peak {s_peak:.2f} GiB above the earlier phases' {base_mem / 2**30:.2f}; launches a "
          f"step { {k_: v_ for k_, v_ in step_launches[0].items() if v_} }; on the captured inputs "
          f"B {eb}, L {el} (bit-equal to B), I {ei}, C {ec}, H {eh_} max-abs against the plain "
          f"versions ({time.perf_counter() - t_a:.1f} s)")

    # 33b. 64 frames: the full clip and its backward (C and H at T=64), then
    # a 64-frame linear stream (capacity 64, kernel A) against it
    t_b = time.perf_counter()
    long_x = torch.randn(SHAPES["long_batch"], SHAPES["long_frames"], 3, cfg.image_size,
                         cfg.image_size, device=dev, generator=gen).to(torch.bfloat16)
    tl_ = SHAPES["long_frames"]
    long_out, got = fwd_bwd(model, long_x, "64f", bcih)
    add(shapes_launches, got)
    rl_ = SHAPES["long_batch"] * n_
    ec, eh_ = check_ch("64f", f"qkv R={rl_} T={tl_}")
    wh, wp, same, _, got = stream_vs(model, long_x, long_out, "64f",
                                     {"temporal_decode_pm": L * tl_, "spatial_flat": L * tl_},
                                     total_frames_hint=tl_)
    add(shapes_launches, got)
    print(f"33b ({smi}): model_forward at B={SHAPES['long_batch']} x {tl_} frames of "
          f"{cfg.image_size}^2 and "
          f"the backward of its pooled sum: finite, B C H I {L} times each; C {ec} and H {eh_} "
          f"max-abs against the plain versions on the captured (B, T, N, 3D) inputs; a "
          f"{tl_}-frame linear stream (C={tl_}, A and B {L} times a frame) against the clip: "
          f"hidden {wh}, pooled {wp}; {same} of {tl_} frames bit for bit "
          f"({time.perf_counter() - t_b:.1f} s)")
    del long_x, long_out

    # 33c. non-causal temporal attention: from_pretrained with the flag off,
    # the full clip and its backward (C and H without the mask), then 4
    # frames streamed at t=1 (the decode kernels; one new frame sees what a
    # causal one sees: bit-equal to the causal model's stream)
    t_c = time.perf_counter()
    nc = from_pretrained(ckpt, cfg.replace(enable_causal_temporal=False))
    nc_x = video[:SHAPES["nc_batch"]]
    nc_out, got = fwd_bwd(nc, nc_x, "noncausal", bcih)
    add(shapes_launches, got)
    causal_out = encoder.model_forward(model, nc_x)
    moved = max_err(nc_out["pooler_output"], causal_out["pooler_output"])
    ec, eh_ = check_ch("noncausal", f"qkv R={b_ * n_} T={t_} non-causal",
                       repeat=b_ // SHAPES["nc_batch"])
    ts_ = SHAPES["nc_stream"]
    cfg_lin = cfg.replace(cache_mode="linear")
    c_nc = encoder.init_cache(cfg_lin, SHAPES["nc_batch"], device=dev)
    c_c = encoder.init_cache(cfg_lin, SHAPES["nc_batch"], device=dev)
    ops.reset_launches()
    nc_equal = True
    for i in range(ts_):
        o_nc, c_nc = encoder.streaming_forward(nc, nc_x[:, i:i + 1], c_nc, cfg=cfg_lin.replace(
            enable_causal_temporal=False))
        o_c, c_c = encoder.streaming_forward(model, nc_x[:, i:i + 1], c_c, cfg=cfg_lin)
        nc_equal = nc_equal and all(torch.equal(o_nc[k_], o_c[k_]) for k_ in o_c)
        if not finite(o_nc):
            fail(f"33c: stream frame {i} not finite")
    torch.cuda.synchronize()
    got = dict(ops.LAUNCHES)
    if got != {**zeros, "temporal_decode_pm": 2 * L * ts_, "spatial_flat": 2 * L * ts_}:
        fail(f"33c stream: launches {got}")
    if not nc_equal:
        fail("33c: the non-causal t=1 stream differs from the causal one")
    add(shapes_launches, got)
    print(f"33c ({smi}): enable_causal_temporal=False through from_pretrained, B="
          f"{SHAPES['nc_batch']} x {t_} frames: the full clip and its backward finite, B C H I "
          f"{L} times each, its pooled output {moved} from the causal model's; C {ec} and H "
          f"{eh_} max-abs against the plain versions (captured inputs, batch repeated to "
          f"R={b_ * n_}); {ts_} frames streamed at t=1 bit-equal to the causal model's stream "
          f"({time.perf_counter() - t_c:.1f} s)")
    del nc, nc_out, causal_out, c_nc, c_c

    # 33d. joint space-time attention: T x N = 1568 tokens a clip, kernels B
    # and I at R=1
    t_d = time.perf_counter()
    jt = from_pretrained(ckpt, cfg.replace(attention_type="joint_space_time"))
    if hasattr(jt.encoder.layer[0], "temporal_attention"):
        fail("33d: a joint_space_time layer holds a temporal block")
    j_x = video[:SHAPES["joint_batch"], :SHAPES["joint_frames"]]
    j_out, got = fwd_bwd(jt, j_x, "joint", {"spatial_flat": L, "spatial_flat_bwd": L})
    add(shapes_launches, got)
    nj = SHAPES["joint_frames"] * n_
    eb, el = check_b("joint", f"R={SHAPES['joint_batch']} N={nj}")
    ei = check_i("joint", f"R={SHAPES['joint_batch']} N={nj}")
    qj = captured[("B", "joint")][0]
    jblocks = qj.shape[0] * h_ * -(-nj // ops._spatial_chunks(dev, qj.shape[0], nj, h_,
                                                             torch.bfloat16))
    print(f"33d ({smi}): joint_space_time through from_pretrained, B={SHAPES['joint_batch']} x "
          f"{SHAPES['joint_frames']} frames ({nj} tokens a clip): the full clip and its backward "
          f"finite, B and I {L} times each; B {eb}, L {el} (bit-equal to B), I {ei} max-abs "
          f"against the plain versions; B's launch {jblocks} blocks, at {nj} and at "
          f"{2 * nj} tokens "
          f"{h_ * -(-2 * nj // ops._spatial_chunks(dev, 1, 2 * nj, h_, torch.bfloat16))} "
          f"({time.perf_counter() - t_d:.1f} s)")
    del jt, j_out

    # 33e. space-only attention: frames independent, no time table; the full
    # clip, then the frames streamed at t=1 (B only)
    t_e = time.perf_counter()
    so = from_pretrained(ckpt, cfg.replace(attention_type="space_only"))
    s_x = video[:SHAPES["space_batch"], :SHAPES["space_frames"]]
    ops.reset_launches()
    so_out = encoder.model_forward(so, s_x)
    torch.cuda.synchronize()
    got = dict(ops.LAUNCHES)
    if got != {**zeros, "spatial_flat": L} or not finite(so_out):
        fail(f"33e: full-clip launches {got}, or outputs not finite")
    add(shapes_launches, got)
    wh, wp, same, _, got = stream_vs(so, s_x, so_out, "space_only",
                                     {"spatial_flat": L * SHAPES["space_frames"]})
    add(shapes_launches, got)
    print(f"33e ({smi}): space_only through from_pretrained, B={SHAPES['space_batch']} x "
          f"{SHAPES['space_frames']} frames: the full clip finite, B {L} times; streamed at t=1 "
          f"(B {L} times a frame, the cache unused): hidden {wh}, pooled {wp} from the clip, "
          f"{same} of {SHAPES['space_frames']} frames bit for bit "
          f"({time.perf_counter() - t_e:.1f} s)")
    del so, so_out

    # 33f. csrc/tiled.cuh at the flagship heads, on seeded inputs (no path
    # of this script runs these shapes): C and H past one head's whole-row
    # plan (bf16, B=1 x T frames of 196 patches); fp32 B, L and I past 256
    # keys (R=64, N=576); and fp32 B, L and I at R=128 N=196 on each of
    # their two bodies, the per-lane one the wrapper picks and tiled.cuh
    # forced, timed in the same run
    t_f = time.perf_counter()
    tt = SHAPES["tiled_frames"]
    bf16 = ops._DTYPE_CODES[torch.bfloat16]
    if any(ops._body_smem(k_, f"sf_{k_}", tt, d_, h_, bf16, 1)
           for k_ in ("temporal_fullclip", "temporal_fullclip_bwd")):
        fail(f"33f: C or H at T={tt} would not take tiled.cuh")
    qkv = randn(1, tt, n_, 3 * d_, dtype=torch.bfloat16)
    captured[("C", "tiled")] = (qkv, h_)
    captured[("H", "tiled")] = (qkv, qkv[..., :d_], h_)
    ec, eh_ = check_ch("tiled", f"qkv R={n_} T={tt} tiled.cuh")
    rt, nt = SHAPES["tiled_rows"], SHAPES["tiled_patches"]
    if ops._body_smem("spatial_flat", "sf_spatial_flat", nt, d_, h_,
                      ops._DTYPE_CODES[torch.float32]):
        fail(f"33f: fp32 B at N={nt} would not take tiled.cuh")
    lane = {}
    for tag, r32, n32 in (("tiled32", rt, nt), ("lane32", b_ * t_, n_)):
        qkv32 = [randn(r32, n32, d_, dtype=torch.float32) for _ in range(4)]
        captured[("B", tag)] = (*qkv32[:3], h_)
        captured[("I", tag)] = (*qkv32, h_)
    eb, el = check_b("tiled32", f"R={rt} N={nt} tiled.cuh")
    ei = check_i("tiled32", f"R={rt} N={nt} tiled.cuh")
    lane["per-lane"] = (check_b("lane32", f"R={b_ * t_} N={n_} per-lane"),
                        check_i("lane32", f"R={b_ * t_} N={n_} per-lane"))
    ops._body_smem, body_smem = (lambda *a_: 0), ops._body_smem
    try:
        lane["tiled.cuh"] = (check_b("lane32", f"R={b_ * t_} N={n_} tiled.cuh"),
                             check_i("lane32", f"R={b_ * t_} N={n_} tiled.cuh"))
    finally:
        ops._body_smem = body_smem
    dev_of = {body: [results[(k_, f"R={b_ * t_} N={n_} {body}", "float32")]["device_ms"]
                     for k_ in ("spatial_flat", "spatial_attention", "spatial_flat_bwd")]
              for body in lane}
    print(f"33f ({smi}): tiled.cuh: C {ec} and H {eh_} max-abs at qkv R={n_} T={tt}; fp32 B {eb}, "
          f"L {el}, I {ei} at R={rt} N={nt}; fp32 B, L, I device ms at R={b_ * t_} N={n_}: "
          f"per-lane {dev_of['per-lane']}, tiled.cuh {dev_of['tiled.cuh']} (errors "
          f"{lane}) ({time.perf_counter() - t_f:.1f} s)")
    del qkv
    captured.clear()
    torch.cuda.empty_cache()
    s33 = time.perf_counter() - t33
    print(f"phase 33: {s33:.1f} s")
    if s33 > SHAPES["budget_s"]:
        fail(f"phase 33 took {s33:.1f} s, past its {SHAPES['budget_s']} s")

    # ---- 34. the streaming remainders: E without the mask, past 32 frames and
    # past its plan, its ring mode; A, D, J and E on a cache of the other
    # float type; int8 partial appends (kernel G a frame)
    t34 = time.perf_counter()
    rest_launches = dict(zeros)
    bf16, fp32 = torch.bfloat16, torch.float32
    dname = {bf16: "bfloat16", fp32: "float32"}
    keys34 = ("last_hidden_state", "pooler_output")

    def e_visible(lens_rows, c_, t, causal, ring):
        """(R, 1, t, C + t): the keys E's queries see, as its plain version."""
        ti = torch.arange(t, device=dev)
        slot = torch.arange(c_, device=dev)
        if ring:
            kpos = slot + c_ * torch.div(lens_rows[:, None] - 1 - slot, c_, rounding_mode="floor")
            old = (kpos >= 0) & (kpos > lens_rows[:, None] + t - 1 - c_)
            new = (ti > t - 1 - c_).expand(t, t)
        else:
            old = slot < lens_rows[:, None]
            new = (ti[None] <= ti[:, None]) if causal else torch.ones(t, t, dtype=torch.bool,
                                                                      device=dev)
        return torch.cat([old[:, None].expand(-1, t, c_),
                          new.expand(len(lens_rows), t, t)], -1)[:, None]

    def e_case(t, per_stream, lens, valid, c_, dtype, kv, seed):
        g_ = torch.Generator(device=dev).manual_seed(seed)
        rows_ = per_stream * len(lens)

        def draw(*shape, to):  # bf16 values in either type
            return torch.randn(*shape, device=dev, generator=g_).to(bf16).to(to)

        q = draw(t, rows_, d_, to=dtype)
        kn, vn = draw(t, rows_, d_, to=kv), draw(t, rows_, d_, to=kv)
        kc, vc = draw(c_, rows_, d_, to=kv), draw(c_, rows_, d_, to=kv)
        return (q, kn, vn, kc, vc, torch.tensor(lens, dtype=torch.int32, device=dev),
                torch.tensor(valid, dtype=torch.int32, device=dev))

    def e_row(tag, t, per_stream, lens, valid, c_, causal=True, ring=False, dtype=bf16, kv=None,
              seed=34, row=True):
        """E's (t, R, D) entry against its plain version on the same operands
        (appended planes equal), a kernel row with its bound and one SDPA
        call on the same function; returns the output and planes."""
        kv = kv or dtype
        q, kn, vn, kc, vc, lens_t, valid_t = e_case(t, per_stream, lens, valid, c_, dtype, kv,
                                                     seed)
        k_ref, v_ref = kc.clone(), vc.clone()
        ref = ops.temporal_append_pm_ragged_plain(q, kn, vn, k_ref, v_ref, lens_t, valid_t,
                                                  per_stream, h_, causal, ring)
        got = ops.temporal_append_pm_ragged(q, kn, vn, kc, vc, lens_t, valid_t, per_stream, h_,
                                            causal, ring)
        torch.cuda.synchronize()
        if not (torch.equal(kc, k_ref) and torch.equal(vc, v_ref)):
            fail(f"E {tag}: appended planes differ from the plain version's")
        err, nbytes, flops = 0.0, 0, 0
        eq, ekv = torch.finfo(dtype).bits // 8, torch.finfo(kv).bits // 8
        for i, (length, nv) in enumerate(zip(lens, valid)):
            sl = slice(i * per_stream, (i + 1) * per_stream)
            if ring:
                n_new = min(t, c_)
                n_old, written, nv = max(0, min(length, c_ - t)), n_new, t
                seen = t * (n_old + n_new)
            else:
                n_new, n_old = t, min(length, c_)
                seen = t * n_old + (t * (t + 1) // 2 if causal else t * t)
                written = min(n_old + nv, c_) - n_old
            if nv:
                err = max(err, max_err(got[:nv, sl], ref[:nv, sl]))
            nbytes += per_stream * d_ * (2 * eq * t + 2 * ekv * (n_new + n_old + written))
            flops += 4 * per_stream * d_ * seen
        if row:
            r_ = per_stream * len(lens)
            q4 = q.view(t, r_, h_, dh).permute(1, 2, 0, 3)
            k4, v4 = (torch.cat([c0, n0]).to(dtype).view(c_ + t, r_, h_, dh).permute(1, 2, 0, 3)
                      for c0, n0 in ((kc, kn), (vc, vn)))
            mask = e_visible(lens_t.long().repeat_interleave(per_stream), c_, t, causal, ring)
            record("temporal_append_pm_ragged", tag, dname[dtype], err,
                   lambda: ops.temporal_append_pm_ragged(q, kn, vn, kc, vc, lens_t, valid_t,
                                                         per_stream, h_, causal, ring),
                   lambda: ops.temporal_append_pm_ragged_plain(q, kn, vn, kc, vc, lens_t, valid_t,
                                                               per_stream, h_, causal, ring),
                   lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask),
                   nbytes, flops, tol=TOL[dname[dtype]])
            del q4, k4, v4, mask
        elif not err <= TOL[dname[dtype]]:
            fail(f"E {tag}: max-abs error {err}")
        return got, kc, vc

    # 34a. kernel rows: E without the mask, at 64 frames (tiled, causal and
    # not), past the plan (tiled), at t=1 on a capacity of 60000 (tiled), its
    # ring at t=4 and t=12 (> C); tiled bit-equal to the whole table
    ta = time.perf_counter()
    rf = b_ * n_
    e_row(f"non-causal R={rf} C={cap} t={E_T}", E_T, n_, E_LENS, E_VALID, cap, causal=False)
    for causal in (True, False):
        e_row(f"{'causal' if causal else 'non-causal'} R={2 * n_} C=64 t=64 tiled", 64, n_,
              [0, 0], [64, 64], 64, causal=causal)
    e_row(f"R={n_} C={REST['plan_cap']} t={REST['plan_t']} past the plan", REST["plan_t"], n_,
          [REST["plan_cap"] - REST["plan_t"]], [REST["plan_t"]], REST["plan_cap"])
    e_row(f"R=8 C={REST['long_cap']} t=1", 1, 8, [REST["long_cap"] - 1], [1], REST["long_cap"])
    for t in CHUNKS:
        e_row(f"ring R={rf} C={RING_CAPACITY} t={t}", t, rf, [3 * RING_CAPACITY + 5], [0],
              RING_CAPACITY, causal=False, ring=True)
    for body in ("whole", "tiled"):
        if body == "tiled":
            ops._body_smem, body_smem34 = (lambda *a_: 0), ops._body_smem
        try:
            bits34 = [e_row(f"R={rf} C={cap} t={E_T} tiled.cuh forced", E_T, n_, E_LENS, E_VALID,
                            cap, seed=341, row=body == "tiled"),
                      e_row("", E_T, n_, E_LENS, E_VALID, cap, causal=False, seed=342, row=False),
                      e_row("", 12, rf, [37], [0], RING_CAPACITY, causal=False, ring=True,
                            seed=343, row=False),
                      e_row("", E_T, n_, E_LENS, E_VALID, cap, dtype=fp32, kv=bf16, seed=344,
                            row=False),
                      e_row("", 1, n_, [cap - 1] * b_, [1] * b_, cap, seed=346, row=False)]
        finally:
            if body == "tiled":
                ops._body_smem = body_smem34
        if body == "whole":
            whole34 = bits34
    same34 = [all(torch.equal(a_, b__) for a_, b__ in zip(w_, t__))
              for w_, t__ in zip(whole34, bits34)]
    if not all(same34):
        fail(f"34a: tiled E differs from the whole-table E (causal, non-causal, ring, mixed, "
             f"linear t=1): {same34}")
    del whole34, bits34
    # A, D and J on a cache of the other float type (bf16 values in both)
    for dtype, kv in ((fp32, bf16), (bf16, fp32)):
        g_ = torch.Generator(device=dev).manual_seed(345)

        def draw(*shape, to):
            return torch.randn(*shape, device=dev, generator=g_).to(bf16).to(to)

        q, kn, vn = draw(rf, d_, to=dtype), draw(rf, d_, to=kv), draw(rf, d_, to=kv)
        kc, vc = draw(cap, rf, d_, to=kv), draw(cap, rf, d_, to=kv)
        eq, ekv = torch.finfo(dtype).bits // 8, torch.finfo(kv).bits // 8
        q4 = q.view(rf, h_, 1, dh)
        k4, v4 = (c0.to(dtype).view(cap, rf, h_, dh).permute(1, 2, 0, 3) for c0 in (kc, vc))
        tag = f"mixed {dname[dtype]} q {dname[kv]} cache R={rf} C={cap}"
        for kernel_name, lens in (("temporal_decode_pm", [cap - 1]),
                                  ("temporal_decode_pm_ragged", D_LENS["linear"]),
                                  ("temporal_decode_rm", [cap - 1])):
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            per = rf // len(lens)
            if kernel_name == "temporal_decode_pm_ragged":
                fn, plain = ops.temporal_decode_pm_ragged, ops.temporal_decode_pm_ragged_plain
                args = lambda k_, v_: (q, kn, vn, k_, v_, ln, per, h_)  # noqa: E731
                planes = (kc, vc)
            elif kernel_name == "temporal_decode_pm":
                fn, plain = ops.temporal_decode_pm, ops.temporal_decode_pm_plain
                args = lambda k_, v_: (q, kn, vn, k_, v_, ln.reshape(()), h_)  # noqa: E731
                planes = (kc, vc)
            else:
                fn, plain = ops.temporal_decode_rm, ops.temporal_decode_rm_plain
                args = lambda k_, v_: (q, kn, vn, k_, v_, ln.reshape(()), h_)  # noqa: E731
                planes = tuple(c0.transpose(0, 1).contiguous() for c0 in (kc, vc))
            refs = [p_.clone() for p_ in planes]
            ref = plain(*args(*refs))
            gots = [p_.clone() for p_ in planes]
            got = fn(*args(*gots))
            torch.cuda.synchronize()
            if not all(torch.equal(a_, b__) for a_, b__ in zip(gots, refs)):
                fail(f"{kernel_name} {tag}: appended planes differ")
            if kv == fp32:  # bf16 values in the fp32 cache: the bf16 cache's bits
                a16 = list(args(*(p_.to(bf16) for p_ in planes)))
                a16[1], a16[2] = kn.to(bf16), vn.to(bf16)
                if not torch.equal(fn(*a16), got):
                    fail(f"{kernel_name} {tag}: differs from the bf16 cache's bits")
            n_read = sum(min(x_, cap - 1) for x_ in lens) * per
            window = (torch.arange(cap, device=dev)[None]
                      <= ln.long().repeat_interleave(per)[:, None]).view(rf, 1, 1, cap)
            record(kernel_name, tag + f" len={lens if len(lens) > 1 else lens[0]}", dname[dtype],
                   max_err(got, ref), (lambda f_=fn, a_=args(*planes): f_(*a_)),
                   (lambda f_=plain, a_=args(*planes): f_(*a_)),
                   lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=window),
                   rf * d_ * (2 * eq + 4 * ekv) + 2 * ekv * d_ * n_read,
                   4 * d_ * (n_read + rf))
        del q, kn, vn, kc, vc, q4, k4, v4
    torch.cuda.empty_cache()
    print(f"34a ({smi}): E without the mask, at 64 frames, past the plan, at C="
          f"{REST['long_cap']}, its ring at t={CHUNKS}; tiled bit-equal to the whole table "
          f"(causal, non-causal, ring, mixed, linear t=1); A, D, J on mixed caches (the fp32 cache of bf16 "
          f"values bit-equal to the bf16 cache) ({time.perf_counter() - ta:.1f} s)")

    def run34(tag, fn, want):
        """fn() with the launch counts zeroed before and read after, held
        to ``want`` (and B L times a call where the model runs)."""
        ops.reset_launches()
        out_ = fn()
        torch.cuda.synchronize()
        got_ = dict(ops.LAUNCHES)
        if got_ != {**zeros, **want}:
            fail(f"34 {tag}: launches {got_}, not {want}")
        add(rest_launches, got_)
        return out_

    def stream34(m, x, calls, cfg_s, cache_s, **kw):
        outs_, lo_ = [], 0
        for t in calls:
            o_, cache_s = encoder.streaming_forward(m, x[:, lo_:lo_ + t], cache_s, cfg=cfg_s,
                                                    **kw)
            outs_.append(o_)
            lo_ += t
        return {k_: torch.cat([o_[k_] for o_ in outs_], 1) for k_ in keys34}, cache_s

    def state_copy(cfg_m):
        m = encoder.StreamformerEncoder(cfg_m, device=dev)
        m.load_state_dict(model.state_dict())
        return m

    cfg_lin = cfg.replace(cache_mode="linear")
    # 34b. a 16-frame non-causal chunk into an empty cache: the non-causal
    # full clip (phase 33c's) bit for bit, E = C without the mask
    tb = time.perf_counter()
    nc34 = state_copy(cfg.replace(enable_causal_temporal=False))
    nc_x = video[:SHAPES["nc_batch"]]
    nc_full = encoder.model_forward(nc34, nc_x)
    nc_cfg = cfg_lin.replace(enable_causal_temporal=False)
    nc_chunk = run34("non-causal chunk", lambda: encoder.streaming_forward(
        nc34, nc_x, encoder.init_cache(nc_cfg, SHAPES["nc_batch"], device=dev), cfg=nc_cfg)[0],
        {"temporal_append_pm_ragged": L, "spatial_flat": L})
    nc_same = all(torch.equal(nc_chunk[k_], nc_full[k_]) for k_ in keys34)
    if not nc_same:
        fail(f"34b: the non-causal chunk differs from the non-causal full clip: hidden "
             f"{max_err(nc_chunk['last_hidden_state'], nc_full['last_hidden_state'])}")
    # the same chunk on an int8 cache: F a query, each at the last frame's
    # position after the frames before it are written; held to the full clip
    # by the JAX package's int8 gate (pooled cosine)
    nc8_cfg = nc_cfg.replace(cache_dtype="int8")
    nc8 = run34("non-causal int8 chunk", lambda: encoder.streaming_forward(
        nc34, nc_x, encoder.init_cache(nc8_cfg, SHAPES["nc_batch"], device=dev), cfg=nc8_cfg)[0],
        {"temporal_decode_pm_int8": t_ * L, "spatial_flat": L})
    nc8_cos = cosine(nc8["pooler_output"], nc_full["pooler_output"])
    if not (nc8_cos > INT8_CACHE_COS and finite(nc8)):
        fail(f"34b: the non-causal int8 chunk: pooled cosine {nc8_cos} to the non-causal full "
             f"clip (> {INT8_CACHE_COS})")
    del nc34, nc_full, nc_chunk, nc8
    # 34c. 64 frames in one causal call (E's tiled body) on phase 33b's config
    tl_ = SHAPES["long_frames"]
    long34 = torch.randn(SHAPES["long_batch"], tl_, 3, cfg.image_size, cfg.image_size,
                         device=dev, generator=gen).to(bf16)
    long_full = encoder.model_forward(model, long34)
    long_call = run34("64-frame call", lambda: encoder.streaming_forward(
        model, long34, encoder.init_cache(cfg_lin, SHAPES["long_batch"], capacity=tl_,
                                          device=dev), cfg=cfg_lin)[0],
        {"temporal_append_pm_ragged": L, "spatial_flat": L})
    lh = max_err(long_call["last_hidden_state"], long_full["last_hidden_state"])
    lp = max_err(long_call["pooler_output"], long_full["pooler_output"])
    long_same = sum(int(torch.equal(long_call["last_hidden_state"][:, i],
                                    long_full["last_hidden_state"][:, i])) for i in range(tl_))
    if not (lh <= STREAM_TOL_HIDDEN and lp <= STREAM_TOL_POOLED):
        fail(f"34c: the 64-frame call against its clip: hidden {lh}, pooled {lp}")
    del long34, long_full, long_call
    print(f"34b-c ({smi}): a {t_}-frame non-causal chunk into an empty cache bit-equal to the "
          f"non-causal full clip (E and B {L} times), on an int8 cache pooled cosine {nc8_cos} "
          f"to it (F {t_ * L} times); one causal call of {tl_} frames (E's tiled "
          f"body) against the clip: hidden {lh}, pooled {lp}, {long_same} of {tl_} frames bit "
          f"for bit ({time.perf_counter() - tb:.1f} s)")

    # 34d. mixed caches on the flagship: the bf16 model on an fp32 cache
    # against the bf16 cache (t=1, then a chunk: A 4L, E L); the fp32 model on
    # a bf16 cache against its full clip, its t=1 stream against E's chunks
    td = time.perf_counter()
    x34 = video[:, :8]
    mixed_runs = {}
    for cache_dtype in (None, "float32"):
        cfg_m = cfg_lin.replace(cache_dtype=cache_dtype)
        mixed_runs[cache_dtype] = run34(f"bf16 model, {cache_dtype} cache", lambda: stream34(
            model, x34, [1, 1, 1, 1, 4], cfg_m, encoder.init_cache(cfg_m, b_, device=dev))[0],
            {"temporal_decode_pm": 4 * L, "temporal_append_pm_ragged": L, "spatial_flat": 5 * L})
    bf_same = all(torch.equal(mixed_runs[None][k_], mixed_runs["float32"][k_]) for k_ in keys34)
    if not bf_same:
        fail("34d: the bf16 model on an fp32 cache differs from the bf16 cache")
    del mixed_runs
    cfg32 = cfg_lin.replace(dtype="float32", cache_dtype="bfloat16")
    m32 = state_copy(cfg32)
    x32 = video[:REST["mixed_batch"], :8].float()
    full32 = encoder.model_forward(m32, x32)
    t1_32, _ = run34("fp32 model, bf16 cache, t=1", lambda: stream34(
        m32, x32, [1] * 8, cfg32, encoder.init_cache(cfg32, REST["mixed_batch"], device=dev)),
        {"temporal_decode_pm": 8 * L, "spatial_flat": 8 * L})
    ch_32, _ = run34("fp32 model, bf16 cache, chunks", lambda: stream34(
        m32, x32, [3, 5], cfg32, encoder.init_cache(cfg32, REST["mixed_batch"], device=dev)),
        {"temporal_append_pm_ragged": 2 * L, "spatial_flat": 2 * L})
    mh = max_err(t1_32["last_hidden_state"], full32["last_hidden_state"])
    mp = max_err(t1_32["pooler_output"], full32["pooler_output"])
    m_same = sum(int(torch.equal(t1_32["last_hidden_state"][:, i],
                                 ch_32["last_hidden_state"][:, i])) for i in range(8))
    if not (mh <= STREAM_TOL_HIDDEN and mp <= STREAM_TOL_POOLED):
        fail(f"34d: the fp32 model on a bf16 cache against its full clip: hidden {mh}, pooled {mp}")
    if m_same != 8:
        fail(f"34d: the fp32 model's t=1 stream on a bf16 cache equals its E chunks in {m_same} "
             f"of 8 frames, not all: max-abs "
             f"{max_err(t1_32['last_hidden_state'], ch_32['last_hidden_state'])}")
    del m32, full32, t1_32, ch_32
    print(f"34d ({smi}): the bf16 model on an fp32 cache bit-equal to the bf16 cache (t=1 and a "
          f"chunk); the fp32 model on a bf16 cache against its full clip hidden {mh}, pooled {mp}; "
          f"its t=1 stream bit-equal to its E chunks [3, 5] in {m_same} of 8 frames "
          f"({time.perf_counter() - td:.1f} s)")

    # 34e. the engine on a mixed cache (the bf16 model, an fp32 cache: t=1
    # steps, D; ticks of several frames, E chunks), each stream against a
    # lone B=1 stream on the same cache; int8 partial appends (G a frame)
    # against the t=1 G stream
    te = time.perf_counter()
    mixed34 = state_copy(cfg.replace(cache_dtype="float32"))
    eng = StreamingEngine(mixed34, slots=REST["engine_slots"], mode="linear")
    clips34 = [video[i, :n].float().cpu().numpy() for i, n in enumerate(REST["engine_frames"])]

    def serve34(frames):
        sids_ = []
        for clip in clips34:
            sid_ = eng.open()
            eng.feed(sid_, clip)
            eng.close(sid_)
            sids_.append(sid_)
        eng.run_until_idle(frames=frames)
        return [eng.poll(sid_)[0] for sid_ in sids_]

    eng_ticks, feats34 = {}, {}
    for frames34, kernel34 in ((1, "temporal_decode_pm_ragged"),
                               (REST["engine_tick"], "temporal_append_pm_ragged")):
        steps34 = eng.forwards
        ops.reset_launches()
        feats34[frames34] = serve34(frames34)
        torch.cuda.synchronize()
        eng_launch = dict(ops.LAUNCHES)
        eng_ticks[frames34] = ticks34 = eng.forwards - steps34
        if eng_launch != {**zeros, kernel34: L * ticks34, "spatial_flat": L * ticks34}:
            fail(f"34e: engine launches {eng_launch} over {ticks34} calls of ticks of "
                 f"{frames34} frames")
        add(rest_launches, eng_launch)
    eng_err = 0.0
    cfg_e = mixed34.cfg.replace(cache_mode="linear")
    for i, clip in enumerate(clips34):
        lone, _ = stream34(mixed34, torch.from_numpy(clip)[None].to(dev, bf16), [1] * len(clip),
                           cfg_e, encoder.init_cache(cfg_e, 1, device=dev))
        for feats in feats34.values():
            eng_err = max(eng_err, float(np.abs(feats[i] - lone["pooler_output"][0].float().cpu()
                                                .numpy()).max()))
    if not eng_err <= STREAM_TOL_POOLED:
        fail(f"34e: engine streams on a mixed cache {eng_err} from lone streams")
    del eng, mixed34
    nv34 = REST["int8_valid"]
    cfg8 = cfg_lin.replace(cache_dtype="int8")
    b8 = len(nv34[0])
    x8 = video[:b8, :3 * len(nv34)]
    c8 = encoder.init_cache(cfg8, b8, per_stream_len=True, device=dev)
    part = []
    for i, valid in enumerate(nv34):
        vt = torch.tensor(valid, dtype=torch.int32, device=dev)
        o_ = run34(f"int8 new_valid {valid}", lambda: encoder.streaming_forward(
            model, x8[:, 3 * i:3 * i + 3], c8, cfg=cfg8, new_valid=vt)[0],
            {"temporal_decode_pm_int8_ragged": 3 * L, "spatial_flat": L})
        part.append(o_)
    ref8 = encoder.init_cache(cfg8, b8, per_stream_len=True, device=dev)
    ops.reset_launches()
    i8_err, i8_same, i8_n = 0.0, 0, 0
    for i, valid in enumerate(nv34):
        for ti in range(3):
            active = torch.tensor([ti < v_ for v_ in valid], device=dev)
            o_, _ = encoder.streaming_forward(model, x8[:, 3 * i + ti:3 * i + ti + 1], ref8,
                                              cfg=cfg8)
            ref8["len"].sub_((~active).to(torch.int32))
            for bi, v_ in enumerate(valid):
                if ti < v_:
                    a_ = part[i]["last_hidden_state"][bi, ti]
                    b_ref = o_["last_hidden_state"][bi, 0]
                    i8_err = max(i8_err, max_err(part[i]["pooler_output"][bi, ti],
                                                 o_["pooler_output"][bi, 0]))
                    i8_same += int(torch.equal(a_, b_ref))
                    i8_n += 1
    torch.cuda.synchronize()
    if c8["len"].tolist() != ref8["len"].tolist():
        fail(f"34e: int8 new_valid lengths {c8['len'].tolist()}, the t=1 stream's "
             f"{ref8['len'].tolist()}")
    if i8_same != i8_n:
        fail(f"34e: int8 new_valid equals the t=1 G stream in {i8_same} of {i8_n} valid frames "
             f"(pooled max-abs {i8_err})")
    del c8, ref8, part
    torch.cuda.empty_cache()
    print(f"34e ({smi}): the engine on a mixed cache ({len(clips34)} streams, "
          f"{REST['engine_slots']} slots; {eng_ticks[1]} t=1 steps, D {L} times a step; ticks "
          f"of {REST['engine_tick']} frames, {eng_ticks[REST['engine_tick']]} E chunks, E {L} "
          f"times a chunk): {eng_err} pooled from lone streams; int8 new_valid {nv34} (G {L} times a frame): {i8_same} of "
          f"{i8_n} valid frames bit-equal to the t=1 G stream, lengths equal "
          f"({time.perf_counter() - te:.1f} s)")
    s34 = time.perf_counter() - t34
    print(f"phase 34: {s34:.1f} s")
    if s34 > REST["budget_s"]:
        fail(f"phase 34 took {s34:.1f} s, past its {REST['budget_s']} s")

    # 34f. F, G, J and K past their body's shared-memory plan: kernel rows at
    # batch 1 on seeded operands, then streams of the flagship cut to a few
    # layers on filled caches of that capacity, each held to the same stream
    # with the plain versions in the kernels' place
    tf = time.perf_counter()
    c34 = LONG_DECODE["cap"]
    bf16c = ops._DTYPE_CODES[bf16]
    gl = torch.Generator(device=dev).manual_seed(347)
    for lib_, sym_, shape_ in (
            ("temporal_decode_pm_int8", "sf_temporal_decode_pm_int8", (d_, h_, c34, bf16c)),
            ("temporal_decode_pm", "sf_temporal_decode_pm", (d_, h_, c34, bf16c, bf16c)),
            ("temporal_decode_rm", "sf_temporal_decode_rm_readonly", (d_, h_, c34, bf16c, 1))):
        if ops._body_smem(lib_, sym_, *shape_) <= ops._MAX_SMEM:
            fail(f"34f: {sym_} at C={c34} fits a block's shared memory: not past the plan")

    def codes34(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=gl)

    def scales34(*shape):
        return 0.005 + 0.025 * torch.rand(*shape, device=dev, generator=gl)

    def dequant34(codes, scales):
        """bf16 codes * scales (a scale a leading index, or a trailing head),
        slot chunk by slot chunk: a yardstick's dense cache."""
        out = torch.empty(codes.shape, dtype=bf16, device=dev)
        step = 1024
        for i in range(0, codes.shape[0], step):
            c_, s_ = codes[i:i + step].float(), scales[i:i + step]
            if s_.ndim == c_.ndim:  # (R, C, H) scales of (R, C, D) codes
                c_ = c_.view(*s_.shape, -1) * s_[..., None]
            else:
                c_ = c_ * s_[..., None]
            out[i:i + step] = c_.reshape(out[i:i + step].shape).to(bf16)
        return out

    def tol34(ref):
        """TOL of the output's own scale: at C = 8192 each output averages
        thousands of keys (a mean |x| near 0.015), so a fixed 2e-2 would
        pass a kernel that dropped a chunk of keys."""
        return TOL["bfloat16"] * ref.float().abs().max().item()

    length = c34 - 1
    for name, lens in (("temporal_decode_pm_int8", [length]),
                       ("temporal_decode_pm_int8_ragged", [length, c34 // 2])):
        rr = n_ * len(lens)
        q = randn(rr, d_, dtype=bf16, g=gl)
        kq, ks = encoder.quantize_kv(randn(rr, d_, dtype=bf16, g=gl))
        vq, vs = encoder.quantize_kv(randn(rr, d_, dtype=bf16, g=gl))
        new = (kq, vq, ks, vs)
        planes = [codes34(c34, rr, d_), codes34(c34, rr, d_), scales34(c34, rr),
                  scales34(c34, rr)]
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        if name == "temporal_decode_pm_int8":
            fn, plain = ops.temporal_decode_pm_int8, ops.temporal_decode_pm_int8_plain
            args = lambda p_: (q, *new, *p_, ln.reshape(()), h_)  # noqa: E731
        else:
            fn, plain = ops.temporal_decode_pm_int8_ragged, ops.temporal_decode_pm_int8_ragged_plain
            args = lambda p_: (q, *new, *p_, ln, n_, h_)  # noqa: E731
        refs = [p_.clone() for p_ in planes]
        ref = plain(*args(refs))
        got = fn(*args(planes))
        torch.cuda.synchronize()
        if not all(torch.equal(a_, b__) for a_, b__ in zip(planes, refs)):
            fail(f"{name} C={c34}: appended codes or scales differ")
        del refs
        rows_len = ln.long().repeat_interleave(n_)
        kd, vd = dequant34(planes[0], planes[2]), dequant34(planes[1], planes[3])
        window = (torch.arange(c34, device=dev)[None] <= rows_len[:, None]).view(rr, 1, 1, c34)
        q4 = q.view(rr, h_, 1, dh)
        k4, v4 = (x.view(c34, rr, h_, dh).permute(1, 2, 0, 3) for x in (kd, vd))
        n_read = n_ * sum(min(x_, c34 - 1) for x_ in lens)
        record(name, f"past the plan R={rr} C={c34} lens={lens}", "bfloat16", max_err(got, ref),
               lambda: fn(*args(planes)), lambda: plain(*args(planes)),
               lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=window),
               2 * rr * d_ * 2 + 2 * rr * d_ * 2 + 4 * rr * 2 * 2 + n_read * (2 * d_ + 2 * 4),
               4 * d_ * (n_read + rr), tol=tol34(ref))
        del q, new, planes, kd, vd, q4, k4, v4, window
        torch.cuda.empty_cache()
    # J (bf16 row-major, writes the new frame at len) and K (int8, reads 0..len)
    q, kn, vn = (randn(n_, d_, dtype=bf16, g=gl) for _ in range(3))
    kc, vc = randn(n_, c34, d_, dtype=bf16, g=gl), randn(n_, c34, d_, dtype=bf16, g=gl)
    ln = torch.tensor(length, dtype=torch.int32, device=dev)
    k_ref, v_ref = kc.clone(), vc.clone()
    ref = ops.temporal_decode_rm_plain(q, kn, vn, k_ref, v_ref, ln, h_)
    got = ops.temporal_decode_rm(q, kn, vn, kc, vc, ln, h_)
    torch.cuda.synchronize()
    if not (torch.equal(kc, k_ref) and torch.equal(vc, v_ref)):
        fail(f"temporal_decode_rm C={c34}: written cache rows differ")
    del k_ref, v_ref
    window = (torch.arange(c34, device=dev) <= length).view(1, c34)
    q4 = q.view(n_, h_, 1, dh)
    k4, v4 = (x.view(n_, c34, h_, dh).transpose(1, 2) for x in (kc, vc))
    record("temporal_decode_rm", f"past the plan R={n_} C={c34} len={length}", "bfloat16",
           max_err(got, ref), lambda: ops.temporal_decode_rm(q, kn, vn, kc, vc, ln, h_),
           lambda: ops.temporal_decode_rm_plain(q, kn, vn, kc, vc, ln, h_),
           lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=window),
           2 * n_ * d_ * (3 + 1 + 2 * length + 2), 4 * n_ * d_ * (length + 1), tol=tol34(ref))
    del kc, vc, k4, v4
    torch.cuda.empty_cache()
    kq, vq = codes34(n_, c34, d_), codes34(n_, c34, d_)
    ks, vs = scales34(n_, c34, h_), scales34(n_, c34, h_)
    ref = ops.temporal_decode_rm_readonly_plain(q, kq, vq, ks, vs, ln, h_)
    got = ops.temporal_decode_rm_readonly(q, kq, vq, ks, vs, ln, h_)
    k4, v4 = (dequant34(c_, s_).view(n_, c34, h_, dh).transpose(1, 2)
              for c_, s_ in ((kq, ks), (vq, vs)))
    record("temporal_decode_rm_readonly", f"int8 past the plan R={n_} C={c34} len={length}",
           "bfloat16", max_err(got, ref),
           lambda: ops.temporal_decode_rm_readonly(q, kq, vq, ks, vs, ln, h_),
           lambda: ops.temporal_decode_rm_readonly_plain(q, kq, vq, ks, vs, ln, h_),
           lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=window),
           2 * n_ * d_ * 2 + 2 * n_ * (length + 1) * (d_ + 4 * h_), 4 * n_ * d_ * (length + 1),
           tol=tol34(ref))
    del q, kn, vn, kq, vq, ks, vs, k4, v4, q4
    torch.cuda.empty_cache()

    # the streams: the flagship's first layers, filled caches, the last frames' slots left
    cut = cfg.replace(num_hidden_layers=LONG_DECODE["layers"])
    m34f = encoder.StreamformerEncoder(cut, device=dev)
    missing = m34f.load_state_dict(model.state_dict(), strict=False).missing_keys
    if missing:
        fail(f"34f: the cut model misses {missing[:4]}")
    l34, nf = cut.num_hidden_layers, LONG_DECODE["frames"]

    def filled(cfg_s, lens):
        cache_s = encoder.init_cache(cfg_s, len(lens), per_stream_len=len(lens) > 1, device=dev)
        for layer in cache_s["layers"]:
            for key, x in layer.items():
                if x.dtype == torch.int8:
                    x.copy_(codes34(*x.shape))
                elif key.endswith("_scale"):
                    x.copy_(scales34(*x.shape))
                else:
                    x.copy_(randn(*x.shape, dtype=x.dtype, g=gl))
        cache_s["len"].copy_(torch.tensor(lens, dtype=torch.int32, device=dev).reshape(
            cache_s["len"].shape))
        return cache_s

    int8_lin = cut.replace(cache_mode="linear", cache_dtype="int8", cache_capacity=c34)
    rm = cut.replace(cache_layout="row_major", cache_mode="linear", cache_capacity=c34)
    streams34f = (("F", int8_lin, [c34 - nf], "temporal_decode_pm_int8",
                   ops.temporal_decode_pm_int8_plain),
                  ("G", int8_lin, [c34 - nf, c34 // 2], "temporal_decode_pm_int8_ragged",
                   ops.temporal_decode_pm_int8_ragged_plain),
                  ("J", rm, [c34 - nf], "temporal_decode_rm", ops.temporal_decode_rm_plain),
                  ("K", rm.replace(cache_dtype="int8"), [c34 - nf], "temporal_decode_rm_readonly",
                   ops.temporal_decode_rm_readonly_plain))
    gaps34f = {}
    for tag, cfg_s, lens, kname, plain_fn in streams34f:
        x_s = video[:len(lens), :nf]
        cache_k = filled(cfg_s, lens)
        cache_p = {"layers": [{k_: x.clone() for k_, x in layer.items()}
                              for layer in cache_k["layers"]], "len": cache_k["len"].clone()}
        got34 = run34(f"{tag} stream C={c34}", lambda: stream34(
            m34f, x_s, [1] * nf, cfg_s, cache_k)[0], {kname: nf * l34, "spatial_flat": nf * l34})
        kernel_fn = getattr(ops, kname)
        setattr(ops, kname, plain_fn)
        try:
            ref34 = stream34(m34f, x_s, [1] * nf, cfg_s, cache_p)[0]
        finally:
            setattr(ops, kname, kernel_fn)
        torch.cuda.synchronize()
        gh = max_err(got34["last_hidden_state"], ref34["last_hidden_state"])
        gp = max_err(got34["pooler_output"], ref34["pooler_output"])
        if not (finite(got34) and gh <= STREAM_TOL_HIDDEN and gp <= STREAM_TOL_POOLED):
            fail(f"34f: the {tag} stream at C={c34} against its plain run: hidden {gh}, pooled "
                 f"{gp}")
        gaps34f[tag] = (gh, gp)
        del cache_k, cache_p, got34, ref34
        torch.cuda.empty_cache()
    del m34f
    sf_ = time.perf_counter() - tf
    print(f"34f ({smi}): F, G, J and K past the decode body's plan at C={c34}: kernel rows within "
          f"{TOL['bfloat16']} of their plain versions, writes equal; the flagship cut to {l34} "
          f"layers on filled caches, {nf} frames at t=1 from the last slots (F, G, J, K {l34} "
          f"times a frame): (hidden, pooled) from the plain run {gaps34f} ({sf_:.1f} s)")
    if sf_ > LONG_DECODE["budget_s"]:
        fail(f"phase 34f took {sf_:.1f} s, past its {LONG_DECODE['budget_s']} s")

    # ---- 35. serving over several GPUs: A, D, E, F and G at the rank shape of model
    # parallelism 2; the flagship streamed tensor parallel by two ranks on this card
    # over gloo; the engines over an NCCL mesh of world size 1; the sharded export
    t35 = time.perf_counter()
    from streamformer_tpu_torch.tools import tp_stream

    serve_launches = dict(zeros)
    h_r, d_r, r = h_ // 2, d_ // 2, b_ * n_
    bf, elt = torch.bfloat16, 2
    # 35a. A, D, E, F and G at one rank's shape (6 heads of 64, R=1568, C=16, bf16)
    q, kn, vn = (randn(r, d_r, dtype=bf) for _ in range(3))
    kc, vc = randn(cap, r, d_r, dtype=bf), randn(cap, r, d_r, dtype=bf)
    ln = torch.tensor(cap - 1, dtype=torch.int32, device=dev)
    lens_t = torch.tensor(D_LENS["linear"], dtype=torch.int32, device=dev)
    q4 = q.view(r, h_r, 1, dh)
    k4, v4 = (x.view(cap, r, h_r, dh).permute(1, 2, 0, 3) for x in (kc, vc))
    tag = f"mp=2 rank H={h_r}"

    def same_planes(name, planes, refs):
        if not all(torch.equal(a_, b_ref) for a_, b_ref in zip(planes, refs)):
            fail(f"35a {name} {tag}: the written cache planes differ from the plain version's")

    refs = [kc.clone(), vc.clone()]
    ref = ops.temporal_decode_pm_plain(q, kn, vn, *refs, ln, h_r)
    got = ops.temporal_decode_pm(q, kn, vn, kc, vc, ln, h_r)
    torch.cuda.synchronize()
    same_planes("A", (kc, vc), refs)
    n_read = cap - 1
    record("temporal_decode_pm", f"{tag} linear R={r} C={cap} len={cap - 1}", "bfloat16",
           max_err(got, ref), lambda: ops.temporal_decode_pm(q, kn, vn, kc, vc, ln, h_r),
           lambda: ops.temporal_decode_pm_plain(q, kn, vn, kc, vc, ln, h_r),
           lambda: F.scaled_dot_product_attention(q4, k4, v4),
           elt * r * d_r * (3 + 1 + 2 * n_read + 2), 4 * r * d_r * (n_read + 1))
    refs = [kc.clone(), vc.clone()]
    ref = ops.temporal_decode_pm_ragged_plain(q, kn, vn, *refs, lens_t, n_, h_r)
    got = ops.temporal_decode_pm_ragged(q, kn, vn, kc, vc, lens_t, n_, h_r)
    torch.cuda.synchronize()
    same_planes("D", (kc, vc), refs)
    n_read = sum(min(x, cap - 1) for x in D_LENS["linear"])
    rows_len = lens_t.long().repeat_interleave(n_)
    window = (torch.arange(cap, device=dev)[None] <= rows_len[:, None]).view(r, 1, 1, cap)
    record("temporal_decode_pm_ragged", f"{tag} linear R={r} C={cap} lens={D_LENS['linear']}",
           "bfloat16", max_err(got, ref),
           lambda: ops.temporal_decode_pm_ragged(q, kn, vn, kc, vc, lens_t, n_, h_r),
           lambda: ops.temporal_decode_pm_ragged_plain(q, kn, vn, kc, vc, lens_t, n_, h_r),
           lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=window),
           elt * d_r * (6 * r + 2 * n_ * n_read), 4 * d_r * n_ * (n_read + b_))
    # E: the packed entry on a (B, t, N, 3D / 2) qkv, the engine's throughput chunk
    e_lens = torch.tensor(E_LENS, dtype=torch.int32, device=dev)
    e_valid = torch.tensor(E_VALID, dtype=torch.int32, device=dev)
    qkv = randn(b_, E_T, n_, 3 * d_r, dtype=bf)
    refs = [kc.clone(), vc.clone()]
    ref = ops.temporal_append_pm_qkv_plain(qkv, *refs, e_lens, e_valid, n_, h_r)
    got = ops.temporal_append_pm_qkv(qkv, kc, vc, e_lens, e_valid, n_, h_r)
    torch.cuda.synchronize()
    same_planes("E", (kc, vc), refs)
    err = max(max_err(got[i, :v], ref[i, :v]) for i, v in enumerate(E_VALID) if v)
    qe, ke, ve = (x.reshape(b_, E_T, n_, h_r, dh).permute(0, 2, 3, 1, 4).reshape(r, h_r, E_T, dh)
                  for x in qkv.split(d_r, dim=-1))
    ti = torch.arange(E_T, device=dev)
    e_rows = e_lens.long().repeat_interleave(n_)
    old = (torch.arange(cap, device=dev)[None, None] < e_rows[:, None, None]).expand(r, E_T, cap)
    e_mask = torch.cat([old, (ti[None] <= ti[:, None]).expand(r, E_T, E_T)], -1)[:, None]
    ke = torch.cat([k4, ke], 2)
    ve = torch.cat([v4, ve], 2)
    n_old = sum(min(x, cap) for x in E_LENS)
    record("temporal_append_pm_ragged", f"{tag} qkv R={r} C={cap} t={E_T}", "bfloat16", err,
           lambda: ops.temporal_append_pm_qkv(qkv, kc, vc, e_lens, e_valid, n_, h_r),
           lambda: ops.temporal_append_pm_qkv_plain(qkv, kc, vc, e_lens, e_valid, n_, h_r),
           lambda: F.scaled_dot_product_attention(qe, ke, ve, attn_mask=e_mask),
           elt * n_ * d_r * (2 * n_old + 4 * E_T * b_ + 2 * sum(E_VALID)),
           4 * d_r * n_ * (E_T * n_old + b_ * E_T * (E_T + 1) // 2))
    del qkv, qe, ke, ve, e_mask, old
    # F and G: the int8 cache of one rank's heads (the row scales the whole D's:
    # MAX-reduced over the model group in the encoder; here one rank's operands)
    new = (*encoder.quantize_kv(randn(r, d_r, dtype=bf)), *encoder.quantize_kv(randn(r, d_r, dtype=bf)))
    new = (new[0], new[2], new[1], new[3])
    codes = torch.randint(-127, 128, (2, cap, r, d_r), dtype=torch.int8, device=dev, generator=gen)
    scales = 0.005 + 0.025 * torch.rand(2, cap, r, device=dev, generator=gen)
    cache8 = [codes[0].clone(), codes[1].clone(), scales[0].clone(), scales[1].clone()]
    kd, vd = ((c_.float() * s_[..., None]).to(bf) for c_, s_ in ((cache8[0], cache8[2]),
                                                                (cache8[1], cache8[3])))
    k8, v8 = (x.view(cap, r, h_r, dh).permute(1, 2, 0, 3) for x in (kd, vd))

    def int8_bytes(rows_read):
        return elt * r * d_r * 2 + 2 * r * d_r * 2 + 4 * r * 2 * 2 + rows_read * (2 * d_r + 2 * 4)

    refs = [c_.clone() for c_ in cache8]
    ref = ops.temporal_decode_pm_int8_plain(q, *new, *refs, ln, h_r)
    got = ops.temporal_decode_pm_int8(q, *new, *cache8, ln, h_r)
    torch.cuda.synchronize()
    same_planes("F", cache8, refs)
    record("temporal_decode_pm_int8", f"{tag} linear R={r} C={cap} len={cap - 1}", "bfloat16",
           max_err(got, ref), lambda: ops.temporal_decode_pm_int8(q, *new, *cache8, ln, h_r),
           lambda: ops.temporal_decode_pm_int8_plain(q, *new, *cache8, ln, h_r),
           lambda: F.scaled_dot_product_attention(q4, k8, v8),
           int8_bytes(r * (cap - 1)), 4 * r * d_r * cap)
    refs = [c_.clone() for c_ in cache8]
    ref = ops.temporal_decode_pm_int8_ragged_plain(q, *new, *refs, lens_t, n_, h_r)
    got = ops.temporal_decode_pm_int8_ragged(q, *new, *cache8, lens_t, n_, h_r)
    torch.cuda.synchronize()
    same_planes("G", cache8, refs)
    record("temporal_decode_pm_int8_ragged", f"{tag} linear R={r} C={cap} lens={D_LENS['linear']}",
           "bfloat16", max_err(got, ref),
           lambda: ops.temporal_decode_pm_int8_ragged(q, *new, *cache8, lens_t, n_, h_r),
           lambda: ops.temporal_decode_pm_int8_ragged_plain(q, *new, *cache8, lens_t, n_, h_r),
           lambda: F.scaled_dot_product_attention(q4, k8, v8, attn_mask=window),
           int8_bytes(n_ * n_read), 4 * d_r * n_ * (n_read + b_))
    del q, kn, vn, kc, vc, q4, k4, v4, new, codes, scales, cache8, kd, vd, k8, v8, refs
    torch.cuda.empty_cache()
    print(f"35a ({smi}): A, D, E, F and G at the mp=2 rank shape ({h_r} heads of {dh}, R={r}, "
          f"C={cap}, bf16) within {TOL['bfloat16']} of their plain versions, the cache writes "
          "equal (kernel rows above)")

    # 35b. the flagship streamed tensor parallel (mp = 2) by two processes on this
    # card over gloo (NCCL takes one rank a GPU), ring C=16, batch 8, 16 frames, on
    # a float and an int8 cache, each rank held to this process's stream
    # (the same two ranks first serve 35c's streams over a (2, 1) mesh, held below to
    # the one-process engine; the export over (1, 2) on two ranks of the card is
    # tests/test_torch_cuda.py's, at a small width: here it would cost ~40 s)
    rng35 = np.random.default_rng(35)
    lens35 = [int(x) for x in rng35.integers(ENGINE["min_frames"], ENGINE["max_frames"] + 1,
                                             ENGINE["streams"])]
    raw35 = [rng35.integers(0, 256, (n, 3, img, img), dtype=np.uint8) for n in lens35]
    tick_frames35 = (1, ENGINE["frames"])
    work35 = tempfile.mkdtemp(prefix="serve-", dir=os.path.join(root, "build"))
    try:
        tb0 = time.perf_counter()
        torch.save(video.cpu(), os.path.join(work35, "video.pt"))
        torch.save({"clips": raw35, "slots": ENGINE["slots"], "tick_frames": tick_frames35,
                    "burst_ticks": ENGINE["burst_ticks"], "export_layers": 0},
                   os.path.join(work35, "serve.pt"))
        ranks35 = tp_stream.launch(2, ckpt, os.path.join(work35, "video.pt"), work35,
                                   capacity=cap, cache_dtypes=("float", "int8"),
                                   serve=os.path.join(work35, "serve.pt"))
        tb_s = time.perf_counter() - tb0
        served35 = [res.pop("serve") for res in ranks35]
        ones = tp_stream.reference(model, video, cap, ("float", "int8"))
        for name, kernel in (("float", "temporal_decode_pm"), ("int8", "temporal_decode_pm_int8")):
            one, one_s = ones[name]
            for rk, res in enumerate(ranks35):
                got = res[name]
                want = {**zeros, kernel: L * t_, "spatial_flat": L * t_}
                if got["launches"] != want or got["width"] != d_r:
                    fail(f"35b rank {rk} {name}: launches {got['launches']}, cache width "
                         f"{got['width']} (want {want}, {d_r})")
                add(serve_launches, got["launches"])
                # the int8 ranks too are held at the float gate: their codes and row
                # scales are the one-process cache's (the row absmax MAX-reduced over
                # the model group), which a scale of the rank's half row would break
                e_, cos_ = max_err(got["pooled"], one), cosine(got["pooled"], one)
                if not (e_ <= STREAM_TOL_POOLED and (name == "float" or cos_ > INT8_CACHE_COS)):
                    fail(f"35b rank {rk} {name}: pooled max-abs {e_} (> {STREAM_TOL_POOLED}) or "
                         f"cosine {cos_} (<= {INT8_CACHE_COS}) from one process's stream")
                gate = f"pooled max-abs {e_} (<= {STREAM_TOL_POOLED})" + (
                    "" if name == "float" else f", cosine {cos_} (> {INT8_CACHE_COS})")
                print(f"35b ({smi}): rank {rk} of 2 (gloo, one card), {name} ring cache C={cap} "
                      f"of width {got['width']}, {t_} frames at batch {b_} in "
                      f"{got['seconds']:.3f} s (one process {one_s:.3f} s): {gate} against one "
                      f"process; launches "
                      f"{ {k_: v_ for k_, v_ in got['launches'].items() if v_} }")
        print(f"35b: two ranks started, served, streamed and joined in {tb_s:.1f} s")
    finally:
        shutil.rmtree(work35, ignore_errors=True)

    # 35c-e over an NCCL mesh of world size 1 (the card's machine has one GPU)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mesh_lib.init_distributed(f"localhost:{port}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            fail(f"35c: the process group runs {dist.get_backend()}, not nccl")
        mesh35 = mesh_lib.make_mesh(1, 1)
        # 35c. StreamingEngine over the mesh: bursts as phase 8's (12 streams of 4-16
        # uint8 frames), both tick modes, bit for bit the one-process engine's; then
        # 35b's two ranks' engine over (2, 1), 4 slots a rank, against it
        for frames in tick_frames35:
            out35 = {}
            for tag35, msh in (("mesh", mesh35), ("one", None)):
                eng = StreamingEngine(model, slots=ENGINE["slots"], mode="linear",
                                      stage_dtype="uint8", mesh=msh)
                ops.reset_launches()
                try:
                    out35[tag35] = tp_stream.engine_run(eng, raw35, frames, ENGINE["burst_ticks"])
                except RuntimeError as e:
                    fail(f"35c: {e}")
                torch.cuda.synchronize()
                if tag35 == "mesh":
                    run = dict(ops.LAUNCHES)
            feats, ticks = out35["mesh"]
            kernel = "temporal_decode_pm_ragged" if frames == 1 else "temporal_append_pm_ragged"
            if run != {**zeros, kernel: L * ticks, "spatial_flat": L * ticks}:
                fail(f"35c engine over the mesh, ticks of {frames}: launches {run} over {ticks} "
                     "ticks")
            add(serve_launches, run)
            if out35["one"][1] != ticks or not all(
                    np.array_equal(a_, b_ref) for a_, b_ref in zip(feats, out35["one"][0])):
                fail(f"35c engine over the mesh, ticks of {frames}: differs from the one-process "
                     "engine")
            print(f"35c ({smi}): StreamingEngine(mesh=) over NCCL (world size 1), "
                  f"{ENGINE['slots']} slots, {len(raw35)} uint8 streams of {lens35} frames, ticks "
                  f"of {frames}: "
                  f"{ticks} ticks bit for bit the one-process engine's; launches "
                  f"{ {k_: v_ for k_, v_ in run.items() if v_} }")
            for rk, got in enumerate(served35):
                got = got["engine"][frames]
                e_ = max(float(np.abs(a_ - b_ref).max()) if a_.shape == b_ref.shape else
                         float("inf") for a_, b_ref in zip(got["feats"], out35["one"][0]))
                if got["ticks"] != ticks or not e_ <= STREAM_TOL_POOLED or \
                        got["launches"][kernel] == 0 or got["local_slots"] != ENGINE["slots"] // 2:
                    fail(f"35c rank {rk} of 2 over (2, 1), ticks of {frames}: {got['ticks']} ticks "
                         f"(want {ticks}), pooled max-abs {e_} (> {STREAM_TOL_POOLED}?), "
                         f"{got['local_slots']} local slots, launches {got['launches']}")
                add(serve_launches, got["launches"])
                print(f"35c ({smi}): rank {rk} of 2 (gloo, one card) over a (2, 1) mesh, "
                      f"{got['local_slots']} of {ENGINE['slots']} slots, ticks of {frames}: "
                      f"{got['ticks']} ticks, pooled max-abs {e_} (<= {STREAM_TOL_POOLED}) from "
                      f"the one-process engine; launches "
                      f"{ {k_: v_ for k_, v_ in got['launches'].items() if v_} }")
        del eng, out35, feats
        # 35d. DecodeEngine over the mesh at Qwen2.5-7B widths, two layers (a depth
        # cut): the one-process engine's greedy tokens
        cfg7m = LM.LMConfig(**{**LM_7B, "num_hidden_layers": 2})
        lm7m = LM.LanguageModel(cfg7m, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(35))
        prng = np.random.default_rng(35)
        p35 = [prng.integers(0, cfg7m.vocab_size, (int(n_p),))
               for n_p in prng.integers(16, 64, LM_EXPORT["requests"])]
        toks35 = []
        for msh in (mesh35, None):
            eng = DecodeEngine(lm7m, slots=LM_EXPORT["slots"], capacity=LM_EXPORT["capacity"],
                               prefill_buckets=(64,), max_new_tokens=LM_EXPORT["new"], mesh=msh)
            sids = [eng.open_tokens(p_) for p_ in p35]
            eng.run_until_idle()
            toks35.append([eng.poll(s_)[0] for s_ in sids])
        if toks35[0] != toks35[1] or any(len(t_) != LM_EXPORT["new"] for t_ in toks35[0]):
            fail(f"35d DecodeEngine over the mesh: tokens {toks35[0][:2]} differ from the "
                 f"one-process engine's {toks35[1][:2]}")
        print(f"35d ({smi}): DecodeEngine(mesh=) over NCCL (world size 1), Qwen2.5-7B widths, 2 "
              f"layers, bf16, {LM_EXPORT['slots']} slots, {len(p35)} requests of "
              f"{LM_EXPORT['new']} tokens: the one-process engine's greedy tokens")
        del lm7m, eng
        torch.cuda.empty_cache()
        # 35e. export_sharded_forward over the mesh, the flagship's first EXPORT_LAYERS
        # layers: the loaded program is the live (tensor-parallel) full clip, bit for bit
        from streamformer_tpu_torch.parallel import sharding

        cfg35 = cfg.replace(num_hidden_layers=EXPORT_LAYERS)
        model35 = encoder.StreamformerEncoder(cfg35, device=dev)
        model35.load_state_dict({k_: v_ for k_, v_ in model.state_dict().items()
                                 if k_ in model35.state_dict()})
        sharding.shard_encoder(model35, mesh35.get_group("model"))
        te0 = time.perf_counter()
        blob = EX.export_sharded_forward(cfg35, b_, mesh35, t_)
        ex_s = time.perf_counter() - te0
        prog = EX.load_exported(blob, mesh=mesh35)
        vid35 = video.to(bf)
        ops.reset_launches()
        got = prog(model35.state_dict(), vid35)
        torch.cuda.synchronize()
        run = dict(ops.LAUNCHES)
        want = encoder.model_forward(model35, vid35)
        if run != {**zeros, "spatial_flat": EXPORT_LAYERS, "temporal_fullclip": EXPORT_LAYERS}:
            fail(f"35e: launches inside the sharded program {run}")
        add(serve_launches, run)
        if not all(torch.equal(got[k_], want[k_]) for k_ in ("last_hidden_state",
                                                           "pooler_output")):
            fail("35e: the sharded program differs from the live full clip: max-abs "
                 f"{max_err(got['pooler_output'], want['pooler_output'])}")
        print(f"35e ({smi}): export_sharded_forward over a (1, 1) NCCL mesh, {EXPORT_LAYERS} "
              f"layers, batch {b_} x {t_} frames: export {ex_s:.2f} s, {len(blob)} bytes, mesh "
              f"{prog.metadata['mesh']}; loaded with the mesh's groups, bit for bit the live full "
              f"clip; launches { {k_: v_ for k_, v_ in run.items() if v_} }")
        del prog, got, want, model35, blob, served35
    finally:
        mesh_lib.shutdown()
    torch.cuda.empty_cache()
    print(f"phase 35: {time.perf_counter() - t35:.1f} s")

    # ---- summary
    main_shape = {"temporal_decode_pm": f"linear R={b_ * n_} C={cap} len={cap - 1}",
                  "temporal_decode_pm_ragged": f"linear R={b_ * n_} C={cap} lens={D_LENS['linear']}",
                  "temporal_append_pm_ragged": f"qkv R={b_ * n_} C={cap} t={E_T}",
                  "temporal_decode_pm_int8": f"linear R={b_ * n_} C={cap} len={cap - 1}",
                  "temporal_decode_pm_int8_ragged":
                      f"linear R={b_ * n_} C={cap} lens={D_LENS['linear']}",
                  "spatial_flat": f"R={b_} N={n_}", "temporal_fullclip": f"R={b_ * n_} T={t_}",
                  "temporal_fullclip_bwd": f"R={b_ * n_} T={t_}",
                  "spatial_flat_bwd": f"R={b_ * t_} N={n_}",
                  "temporal_decode_rm": f"R={b_ * n_} C={cap} len={cap - 1}",
                  "temporal_decode_rm_readonly": f"int8 R={b_ * n_} C={cap} len={cap - 1}",
                  "spatial_attention": "R={} H={} N={} dh={}".format(*L_SHAPES[0]),
                  "ms_deform_attn": m_main["pixel decoder"],
                  "ms_deform_attn_bwd": m_main["pixel decoder"]}
    main_dtype = {"ms_deform_attn": "float32", "ms_deform_attn_bwd": "float32"}  # OVIS runs fp32
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        row = results[(name, main_shape[name], main_dtype.get(name, "bfloat16"))]
        count = sum(path[name] for path in  # encode, engine, their int8 runs, training, then
                    (launches, engine_launches, int8_launches, int8_engine_launches,  # the later
                     train_launches, rm_launches, chunk_launches, consumer_launches,  # slices'
                     l_launches, entry_launches, dist_launches, vqa_launches,
                     vqa_train_launches, ar_launches, oad_launches, ovis_launches,
                     export_launches, shapes_launches, rest_launches, serve_launches))
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=count, max_abs_err=row["max_abs_err"], ms=row["ms"],
                            device_ms=row["device_ms"], plain_ms=row["plain_ms"],
                            bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"]))
        if count == 0:
            fail(f"{name} never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
