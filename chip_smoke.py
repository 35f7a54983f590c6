#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's serving paths on VGA frames (640x480, shrink 2, n_per_oct 8,
smooth 1, grad_hist) with the committed models and its BASELINE config-5
path on 3840x2160 frames (FPGA integer channels grad_hist_4_u1+grad_mag_u1,
C = 5, shrink 2, n_per_oct 4, smooth 0 and 1, the committed
models/fpga_4k_*synth_64.pb), its fast serving mode on VGA uint8 and
float32 frames, exact float32 frames, bucketed serving at any frame size
(BucketedDetector), its host-pool training loop (BASELINE config 4), the
FPGA trainer, the device-pool trainer (BASELINE config 4b), the
per-level channel pyramid, the image-space channel canvas (shrink 1 and
grad_mag, plain torch), CNN-verified detection, verifier training, the
command-line tools (train, detect) with the native loader,
single-scale serving (BASELINE config 1, n_scales), and all of it over
several devices and processes (meshes, tile sharding, two ranks over
torch.distributed), two-phase and row-wise batched serving, channel
functions a user registers (the per-level canvas), and checks
and times its thirteen CUDA kernels
(planes B1,
grad_hist B2, cascade B3, cascade_response B4, fpga B5, cascade_generic
B6, grad_hist_fast B2f, cascade_fast B3f, grad_hist_float B2d,
cascade_suffix S1, compact S2, nms S3, octaves S4):

 1. prints torch/CUDA versions and the card's name and power limit;
 2. builds the kernels from waldboost_tpu_torch/csrc (one nvcc per source,
    all at once) and prints ptxas's register / shared-memory / spill
    report;
 3. runs each kernel at the VGA batch-8 shapes against its plain-torch
    version on the card, bitwise (tolerance 0), mismatches printed per
    phase: B1, B2, B3 on a noise batch; B4 with flagship_synth_64 and
    flagship_hard_256, n_stages_cap None and 12, on the noise and the
    golden-scene canvas; B6 on the padded tables of flagship_synth_64
    (complete heaps), flagship_hard_256, and a seeded 40-stage model of
    depth-5 trees (bucket 64: 24 inactive stages, general routing), on
    both canvases; hs is compared at every window origin;
 3a. B1 into output buffers pre-filled with 0xAB (a gap byte the kernel
    missed would show) at VGA, 1080p and 4K; BASELINE config 3's 1080p
    shapes (1920x1080, flagship_synth_64's plan, 43 levels): B1 and B2
    (smooth 0 and 1) against their plain versions at batch 8, bitwise;
 3b. tiling edges: B5 at 3x5, 17x45 and 70x257 planes (batch 1 and 3,
    planes starting one byte past a word boundary, C = 1, 4, 5, both
    smooths); B3, B4 (n_stages_cap 0, 1, all) and B6 on grids smaller
    than the walk's 8 x 32 tile, with the 40-stage deep model and a
    256-stage one whose packed records exceed the walk's shared-memory
    budget;
 3c. B2f against its plain version on the bfloat16 bits, for uint8,
    float32 and bfloat16 planes, smooth 0 and 1: at VGA batch 8 (the fast
    canvas step's planes of noise frames), at 1080p batch 8 (seeded
    planes), and at the tiling edges 3x5, 17x45, 70x257, 33x132 and 70x256
    (widths no multiple of 4, 8 or 16, and multiples) with planes and mask
    also starting one element off their aligned start (float32: 4 bytes
    off 16); B3f (csrc/cascade_fast.cu; the kernel always counts n_weak,
    which is compared too) against its plain version and against B3 over
    the canvas's float32 copy, printing how its front read the canvas (TMA
    box copies, global memory or no front): the three committed
    models on the VGA bfloat16 canvases of noise frames (from uint8, f32
    and bf16 planes) and of 8 scene_generator(seed=100) frames, and
    B3f_EDGES (grids under one tile, bfloat16 rows off
    16 bytes, canvases one element off a word, windows 8, 12 and 24, C =
    1, 4 and 5, batch 1 and 3) with the seeded cascades of
    b3f_edge_models (HEAP2 fronts of 3 and 4 stages, 40 depth-5 stages,
    256 whose records exceed the walk's shared memory, one stage, 16 that
    never reject); and B4 over one canvas;
 3d. B2d against its plain version, bitwise (both native f64): at VGA
    batch 8 on the exact float planes of float noise frames and of the
    golden scenes as float32, smooth 0 and 1, each into an output
    pre-filled with NaN; and at 3c's tiling edges with planes and mask
    also starting one element off their aligned start;
 4. serving path (slice 1): make_batched_detector_boxes(k=1024,
    nms_iou=0.5) on the 3 golden scene frames with every launch counter
    set to 0 first: survivor counts, kept boxes and scores equal the
    committed JAX outputs (tests/data/torch_port_vga_golden.npz) bitwise,
    and B1-B3 launched;
 4a. fast serving mode: make_batched_detector_boxes(fast=True, k=1024,
    nms_iou=0.5, with_n_weak=False) on the golden frames (uint8) and on
    their float32 versions with fast_float "f32" and "bf16", the counters
    set to 0 before each: counts, kept boxes and scores equal the
    committed JAX fast-mode outputs (tests/data/torch_port_fast_golden.npz)
    bitwise; B1, B2f and B3f must have launched for uint8 frames, B2f and
    B3f for float frames, and no exact-mode B2 or B3; then
    make_multi_detector_boxes(fast=True) over the three models must launch
    B2f and B3f and give the single-model fast path's boxes for its first
    model;
 5. Model-API path: counters set to 0, then on the golden frames
    Model.detect, detect_topk(k=1024, nms_iou=0.5) and scan_packed_batch
    of the three committed models, wt.detect over all three
    (response_scale 1, 0.5, 2), make_batched_detector (all stages and
    n_stages_cap=12) and make_multi_detector_boxes; counters read, then
    every result checked against the committed JAX outputs
    (tests/data/torch_port_model_golden.npz) bitwise; all five kernels
    must have launched;
 5b. at the config-5 batch-8 shapes (4K noise, halo-0 plan, C = 5), each
    kernel of that path against its plain version, bitwise: B1, B5 (the
    composite kind, smooth 0 and 1), B3, and B4 for both FPGA models with
    n_stages_cap None and the golden's prefix length, and B6 on both
    models' padded runtime tables; B5 also for each
    single kind and the reversed composite on VGA planes; then the
    config-5 path: counters
    set to 0, both FPGA models and their prefixes (model_from_stages)
    through make_batched_detector_boxes(k=1024, nms_iou=0.5),
    Model.detect and make_batched_detector(n_stages_cap) on the seeded 4K
    noise frames of tests/data/torch_port_fpga_golden.npz; counters read
    (B1, B5, B3, B4 must have launched), then counts, n_weak, alive counts,
    kept boxes and scores checked against that file bitwise;
 5c. bucketed serving: BucketedDetector(flagship_synth_64, bucket=128,
    k=1024, nms_iou=0.5) on the four frames of
    tests/data/torch_port_bucket_golden.npz (640x480, 600x448 and 576x432
    in one bucket, 1280x720 in another), the counters set to 0 first:
    two set-ups, B1, B2 and B3 launched, counts, kept boxes and scores
    bitwise JAX's BucketedDetector, every survivor of a k=8192 bucketed
    detector equal to the card's Model.detect at the true size; B1 (into a
    0xAB-filled buffer), B2 and B3 against their plain versions on a
    bucket's per-size tables; fast mode on uint8 frames runs B2 and B3f,
    never B2f; the config-5 smooth-1 model's golden prefix at 1920x1080
    and 1904x1072 (one bucket) equal to its Model.detect, B1, B5 and B3
    launched and held against their plain versions on the bucket's tables;
 5d. exact float serving: the golden scene frames as float32 through the
    VGA detector (k=1024, NMS 0.5) with the counters set to 0 first: B2d
    and B3 launched, no B1, B2 or B2f; counts, kept boxes and scores and
    Model.detect's survivors bitwise tests/data/torch_port_float_golden.npz;
 6t. BASELINE config 4 (host-pool training: 12x12x4 grad_hist, shrink 2,
    n_per_oct 4, smooth 1, fake_data_generator(seed=11), pool 1000/1000,
    alpha 0.2, depth 2), teacher-forced against the JAX golden
    (tests/data/torch_port_train_golden.npz, 6 stages) with the counters
    set to 0 first: per stage the pool update (mining on the card) equals
    the golden bitwise (labels, scores, instance ids, the samples' SHA-256
    with values below 2**-30 as 0, counts, n_weak / n_loc / n_images), the
    card's fit equals the golden tree (structure and thresholds bitwise,
    predictions within 1e-5; on a differing split both gains are printed,
    recomputed in float64), the SPRT on the pool's scores plus the golden
    tree's responses equals the golden theta and learner stats bitwise;
    the golden tree and theta are then appended; B1, B2 and B6 must have
    launched;
 6u. the stage-0 and stage-5 pools fitted twice on the card: bitwise equal
    trees;
 6v. the FPGA trainer: wt.fpga.train 2 stages (8x8x4 grad_hist_4_u1,
    n_per_oct 2, smooth 1, pool 60/60, fake_data_generator(seed=3)) with
    the counters set to 0 first, teacher-forced against the JAX golden
    (tests/data/torch_port_fpga_train_golden.npz) as in 6t: each stage's
    pool and counters bitwise, the card's fit equal to the golden tree,
    theta and learner stats bitwise; integer thresholds, predictions on
    the 1/32 grid within +-3; B1, B5 and B6 must have launched; then at
    the trainer's mining shapes (8 of its 256x256 frames) B1, B5 and B6
    against their plain versions, bitwise, on the canvas the mining
    scans; save, load and detect give equal boxes;
 6w. the device-pool trainer (BASELINE config 4b: config 4's model, data,
    quotas and learner through parallel.trainer.train_sharded, mining seed
    0, a 32-deep prefetcher, a warm call to 2 stages then the rest, one
    pools dict) with the counters set to 0 first, teacher-forced against
    the JAX golden (tests/data/torch_port_device_train_golden.npz, 6
    stages): per stage the pools entering the step (v, H, counts, the
    SHA-256 of each padded x with values below 2**-30 as 0) and n_weak /
    n_loc / n_images bitwise; the card's fit equal to the golden heap tree
    (features and thresholds bitwise, predictions within 1e-5; on a
    differing split both gains printed in float64); with the golden tree
    forced, theta, p0, p1, n0, n1 and the pruned masks bitwise, the loss
    within 1e-6; B1, B2 and B6 must have launched; then at config 4b's
    mining shapes (8 of its 256x256 frames, the trained 6-stage tables)
    B1, B2 and B6 against their plain versions, bitwise, on the canvas
    the mining scans; then train_sharded 2 stages at 6v's size with the
    FPGA options in-step (bank masks from PixelBanks / BankScheduler, clip
    3, quantizer 32, integer thresholds), teacher-forced in the same way
    against its JAX golden
    (tests/data/torch_port_device_fpga_train_golden.npz; the fit held to
    JAX's tree before the FPGA transforms, the step's tree after them):
    integer thresholds, leaves on the 1/32 grid within +-3, every split
    feature in its depth's scheduled bank, B5 launched; then on the 3
    golden frames channel_pyramid on the card equals its CPU run bitwise
    (grad_hist, smooth 1), Model.scan_channels' survivors equal
    Model.scan_packed's level by level, and wt.detect over models with
    different channel options equals its per-level loop on the CPU;
 6c. the image-space canvas: the three cascades of
    tests/data/torch_port_canvas_golden.npz (scripts/
    make_torch_canvas_golden.py: grad_hist at shrink 1 with a 24x24x4
    window, grad_mag and grad_hist+grad_mag at shrink 2, 64 stages each,
    n_per_oct 8, smooth 1) on its three VGA scenes and two VGA noise
    frames, the counters set to 0 first: the shrink-1 cascade's
    survivors, n_weak and the kept boxes of host NMS 0.5, of
    make_batched_detector_boxes(k=1024, nms_iou=0.5) and of
    BucketedDetector(bucket=128) bitwise the golden, its float noise
    frame within the flip bound, its mining scan's survivors equal the
    golden's; the grad_mag cascades within PARITY.md's flip bound (0.5%
    of the boxes); B3, B4 and B6 launched, B1 and B2 not; each canvas on
    the card equal to its CPU run bitwise on a uint8 and a float frame;
 6d. CNN-verified detection: the golden's flax verifier converted
    (convert.verifier_state_dict), TF32 switched on globally and a probe
    inside every verifier call requiring full float32 there; on the three
    scenes with flagship_synth_64, detect_and_verify's boxes and cascade
    scores bitwise the golden's, its verified scores and verify_scores
    within 1e-5 of the scores' scale, the fused bucket (k=1024, NMS 0.5)
    equal to detect_and_verify then host NMS and to the golden's;
 7a. verifier training, teacher-forced with dropout off
    (tests/data/torch_port_cli_golden.npz, scripts/make_torch_cli_golden.py):
    from the golden's flax init on seeded pools (1000 windows a class, 12 x
    12 x 4), 2 epochs of 50 batches of 64, lr 1e-4, twice with TF32 switched
    on globally: printed epoch losses within 1e-5 and parameters within 2e-5
    of JAX's, the two runs bitwise, full float32 in every pass; ms a step;
    then planted faults (TF32 on, Adam's bias corrections dropped), each
    of which must put the parameters outside that tolerance;
 7b. the verifier arm of BASELINE.md round 4 with dropout on: config 4's
    detector to 32 stages, the verifier 3 x 400 batches of 64 on its final
    pool, the AUC of the cascade and of detect_and_verify over 200 held-out
    images (seed 999, IoU 0.5): verified >= cascade - 0.03; steps a second;
    B1, B2, B4 and B6 launched;
 7c. the CLI's train_main in-process: config 4's widths (4 stages, pool
    1000/1000, seed 0) and --fpga (3 stages, 8 x 8 x 4 grad_hist_4_u1), each
    model equal to JAX's CLI model (trees, features and thresholds bitwise,
    predictions and thetas within 1e-5) and its JSON line equal (loss within
    1e-6), B1, B2 (B5 with --fpga) and B6 launched, stages a minute; then 2
    stages from a bbGt directory of PGM files through the native loader
    (stage count, the model loads);
 7d. the CLI's detect_main in-process over 8 VGA scenes saved as .npy:
    flagship_synth_64 alone (BucketedDetector; B1, B2, B3) with its JSON
    equal to JAX's, then with flagship_hard_64 too (wt.detect; B1, B2, B4)
    with each file's (box, score, label) rows equal to JAX's as sets (the
    list order is JAX's two-phase compaction's); frames a second after a
    warm call;
 7e. single-scale serving: make_batched_detector_boxes(n_scales=1) of
    config 1 (models/config1_stump_synth_64.pb, k=128, n_weak off as
    bench.py serves it, and on) and of flagship_synth_64 at n_scales 1 and
    4 (k=1024) on a noise batch, the scene batch and a coarse-noise batch
    (on which every run keeps windows): counts, n_weak, boxes and scores
    bitwise JAX's; B1, B2 and B3 launched; 10 config-1 batches and config
    1's Model.detect on the coarse frames through profiling.Meter, its
    report (with config 1's cascade counters) printed;
 6. times each kernel against its plain version (CUDA events, in turns), each
    layer of the serving path, the serving path end to end (60 batches of 8
    per workload, MP/s, p50/p80; config 1 single-scale among them), Model.detect and the three-model wt.detect
    (ms/frame, p50 of 30 frames) and make_batched_detector (MP/s at batch 8,
    30 batches), B3 on the 40-stage depth-5 model (GENERAL node records); B2f
    on each plane type and B3f at VGA; B3f on the noise and the scene
    canvas from a CUDA graph of 20 calls (no host time) beside its bound;
    B2d's instruction floor (its f64 operations and conversions at
    16.9e12 and 4.18e12 a second, one after the other); fast serving end to
    end (30 batches per workload: uint8 noise k=128 and scenes k=1024, float32
    noise with f32 and bf16 planes, k=128); B2d at VGA (float noise planes,
    smooth 1), the float64 plane build alone, exact float serving end to end
    (float noise k=128, float scenes k=1024; 30 batches each); bucketed
    serving over a mixed stream (8 frames of each of the bucket golden's four
    sizes per detect_many, 5 calls, MP/s); the first sight of 5 novel sizes
    (host ms of the first and second call: Model.detect, which runs the
    packer, against BucketedDetector, which builds tables only); the
    image-space cascades' batched detectors (k=1024, NMS 0.5, 30 batches of 8:
    the shrink-1 one on noise and scenes, grad_mag and grad_hist+grad_mag on
    noise) and each canvas step (whole, resize, channels; us/image); verified
    detection (the flagship's VGA bucket program with the verifier fused,
    k=1024, NMS 0.5, scene batches) and the verifier's ms per 1024 windows; at
    config 5: B5 (smooth 0, 1), B3 and B4 (C = 5) and B1 (halo 0) against
    their plain versions and bounds; at 1080p B1 and B2 (smooth 1 and 0)
    likewise; the serving path end to end (k=128, NMS 0.5, smooth 0 and 1,
    MP/s with p50/p80 over 20 batches of 8) and the peak device memory; config
    4 as bench.py times it (2 warm stages, then 6 timed: stages/min, each
    stage's ms, the launches per stage of B1, B2 and B6) and config 4b
    likewise (a warm call to 2 stages, then 12 timed), both rates on one line;
    probes the host;
 7. traces 10 batches of each serving workload (and of the fast scene and
    bf16 float-fast workloads) with torch.profiler and prints the device
    idle share and, per layer span (wb.*), host and device time, and 3
    batches of each config-5 workload likewise; then 6 more config-4
    stages in one train call: the device idle share, host and device
    time per span, and each stage's host time split over the wb.train.*
    spans (mine, label, gather, rescore, fit, sprt) and the rest; then 6
    more config-4b stages in one train_sharded call likewise (spans mine,
    label, insert, step), and per stage the bytes copied each way (from the
    trace's memcpy events): a stage that does not mine copies at most 256
    KB to the host and 64 KB to the device, and no copy is as large as a
    pool's samples (2048 x 576 float32);
 8. several devices and processes (phases 8a-8f), each on a mesh of the
    card repeated four times and, where two or more cards are visible, on
    meshes of 2 and min(4, count) real cards (with one card it prints
    that the real-card runs need two or more); every kernel launch
    counted per phase (once a shard), on real cards each shard's kernels
    found on its card in a profiler trace:
    8a. sharded VGA serving (flagship_synth_64, k 128 and 1024, NMS 0.5,
        8 frames a shard: the golden scenes and their flips): each shard
        bitwise the unsharded detector, the golden frames the golden's;
    8b. fast mode over the mesh (B2f, B3f): bitwise the unsharded fast
        path and the fast golden;
    8c. tile-sharded 4K (fpga_4k_synth_64, each config-5 golden frame in
        mesh-size bands of origin rows): hs, alive and n_weak bitwise the
        unsharded B4 path, boxes=True the golden's counts, n_weak and
        (12-stage prefix) kept boxes; ms a frame beside the unsharded
        B4 path;
    8d. BucketedDetector(mesh) on the bucket golden's four sizes, and
        detect_and_verify(mesh) on the golden scenes (verified scores
        within 1e-5 of their scale);
    8e. train_sharded(mesh) at config 4b (2048 slots a class, 6 stages)
        and fpga.train(mesh) (2 stages), teacher-forced against their
        goldens as in 6w; then config 4b's stages/min on the mesh;
    8f. tests/torch_mp_worker.py as two ranks (NCCL, a card each, with two
        or more cards; gloo, both on the card, with one), 4 shards a
        rank: 8 stages of wt.train and sharded detection bitwise the same
        program in this process on 8 shards, and both teacher-forced
        equal to tests/data/torch_port_mesh_golden.npz; its wall time;
    and sharded VGA MP/s (k=128, noise) at 1 shard, 4 shards on one card
    (overhead, not scaling) and each real-card mesh;
 9. two-phase and row-wise batched serving (kernels S1, S2):
    9a. make_batched_detector_boxes on the flagship's VGA batch of
        tests/data/torch_port_twophase_golden.npz (3 seeded noise frames,
        the 3 golden scenes; scripts/make_torch_twophase_golden.py):
        two_phase=True at JAX's defaults and at an overflowing prefix 2,
        capacity 512, then extractor="rowwise" (k_row 16, NMS 0.5), each
        path from counters set to 0 (two-phase: B1, B2, B4, S1, S2 twice
        a batch, no B3; row-wise: B1, B2, B4, no S1 or S2), all five
        outputs whole and bitwise the golden; then S2 (topk_masked over
        B4's hs and alive) and S1 (cascade_suffix_sparse) bitwise their
        plain versions on the card on the inputs the two-phase path gives
        them: VGA noise and scenes,
        scenes overflowing (S2's route for more survivors than the
        capacity), the bfloat16 canvas of fast mode, the 40-stage depth-5
        model (GENERAL records), and config 5 (fpga_4k_synth_64, 4K noise
        batch 8), also overflowing;
    9b. S1 and S2 per call beside their plain versions, in turns, on the
        device (torch.profiler: the kernels' own time) and with the
        wrapper (CUDA events around back-to-back calls) at VGA scenes and
        4K noise, S2 beside torch.sort(stable=True) of the whole masked
        map, the bounds; then
        two-phase against dense make_batched_detector_boxes end to end
        (MP/s, p50, p80; dense, two-phase, two-phase, dense) at VGA noise
        k=128, VGA scenes k=1024 (NMS 0.5) and config 5 k=128;
    9d. S2 (ops/nms.py::topk_masked, csrc/compact.cu) bitwise its plain
        version on the maps of chip_smoke.topk_maps (ties, all -inf, all
        finite, counts k - 1, k, k + 1 and far above k, +0 and -0 tied
        with NaN and +-inf) at the VGA and 4K grid sizes, batch 8, in both
        input forms (masked map; hs and alive), k = 1, the paths' k, 8192
        and the whole map, and k = 65536 at 4K (runs sorted by several
        blocks, then merged); the dense extraction (k 1024 at VGA scenes,
        128 at 4K noise) launching S2 once a batch, bitwise its plain
        version on B3's map and timed beside it and torch.sort(stable=True)
        of the map, in turns; then the dense extraction and two-phase's
        finish (compaction, suffix, final top k) at VGA and 4K, JAX's
        defaults and the overflowing setting, nms_iou=None, under
        torch.cuda.set_sync_debug_mode("error") with torch.sort replaced by
        a probe: no host sync and no sort on the card;
    9c. the two-phase detector over a mesh of the card repeated four
        times (and 2 and 4 real cards where present), 8 scenes a shard:
        bitwise the unsharded detector, each kernel once a shard (S2
        twice);
10. user channel functions through the per-level canvas (no kernel of
    its own: plain torch, then B3):
    10a. the flagship's 64 stages over "user_grad_hist", a registered
        ChannelFunction whose fn is the port's grad_hist fn (no canvas
        form), through make_batched_detector_boxes(k=1024, nms_iou=0.5) on
        the VGA scene batch and a noise batch, the counters set to 0
        first: all five outputs and the canvas inside the levels
        (level_interior_mask) against the built-in kernel canvas's path,
        every difference counted and printed; B3 launched, no channel
        kernel (B1, B2, B2d, B2f, B5);
    10b. the JAX-trained (12, 12, 2) model over "user_grad" (the image and
        |gx|, chip_smoke.user_grad) of tests/data/
        torch_port_custom_channels_golden.npz (scripts/
        make_torch_custom_channels_golden.py) on its 8 VGA scenes of
        scene_generator(seed=100), k 4096, no NMS: counts, validity, boxes
        and scores bitwise;
    10c. compute_pyramid on a VGA scene: the kernel canvas's levels, the
        per-level route's and channel_pyramid's, bitwise;
    10d. the VGA batch-8 canvas and whole detector call (k=1024, NMS 0.5)
        of the per-level and the kernel canvas, in turns (CUDA events);
11. S3 (ops/nms.py::nms, csrc/nms.cu) bitwise nms_plain on the card on
    the extraction's candidates (rects, scores, valid of
    make_batched_detector_boxes with nms_iou=None): the VGA scenes and a
    noise batch at k 1024, 4K noise (fpga_4k_synth_64) at k 128 and the
    VGA scenes at k 12000 (past the block's shared memory), batch 8, NMS
    0.5 and 0.3, one launch a call; the dense VGA and 4K detectors with
    NMS 0.5 finished under the sync debug mode "error"; S3 beside
    nms_plain in turns (device time from the profiler, CUDA events; S3
    also replayed from a CUDA graph) at the VGA scenes and 4K noise, with
    the plain loop's rounds and the bound; every serving path with NMS
    (phases 3-5d, 8a, 8b, 9a row-wise, 9c) launches S3, from counters set
    to 0 just before it;
12. S4 (ops/octaves.py::octaves, csrc/octaves.cu) byte for byte the
    plain chain (octaves_plain: octave_buffer of channels.py::
    level_octaves) on the card, on uint8 noise and float32 frames with
    NaN, +-inf, subnormals and -0 at VGA (5 octaves) and 4K (7), batch 8,
    one launch each; the dense VGA and 4K detector calls launch it once;
    S4 beside the plain chain in turns (device time from the profiler,
    CUDA events) at VGA and 4K, with its bound (the frames read once, the
    octave buffer written once); every serving path's launch counts above
    carry S4's column (octaves);
13. prints the per-kernel JSON summary (launches from the Model-API path,
    S2's, S3's and S4's among them, B5's from the config-5 path, B2f's and
    B3f's from the fast path, B2d's from the exact float path, S1's from the
    two-phase path, max_abs_err, ms (S1's and S2's, and their plain_ms and
    library_ms, the device time from the profiler at VGA scenes), plain_ms,
    bound_ms from this run's shapes, library_ms where a PyTorch call
    computes the same: S2's torch.sort), then the final ok line.

Before the summary it prints its own wall time.  Any failed phase raises
and the script exits nonzero without the ok line.
It never falls back to the CPU.

Usage: python chip_smoke.py [--trace-dir DIR]   (DIR keeps the traces)
       python chip_smoke.py --mesh-only   (build, then phases 8a-8f alone,
                                           no summary)
       python chip_smoke.py --twophase-only  (build, then phases 9a-9d
                                              alone, no summary)
       python chip_smoke.py --channels-only  (build, then phases 10a-10d
                                              alone, no summary)
       python chip_smoke.py --octaves-only  (build, then phase 12 alone,
                                             no summary)
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
VGA = (480, 640)
HD = (1080, 1920)  # BASELINE config 3's frames
HW4K = (2160, 3840)  # BASELINE config 5's frames
BATCH = 8
MODEL_NAMES = ("flagship_synth_64", "flagship_hard_64", "flagship_hard_256")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_vga_golden.npz")
MODEL_GOLDEN = os.path.join(ROOT, "tests", "data",
                            "torch_port_model_golden.npz")
FPGA_GOLDEN = os.path.join(ROOT, "tests", "data",
                           "torch_port_fpga_golden.npz")
#: the committed BASELINE config-5 models (smooth 0, smooth 1)
FPGA_MODELS = ("fpga_4k_synth_64", "fpga_4k_smooth_synth_64")

# kernel name (its key in waldboost_tpu_torch._build.launches) -> (CUDA
# source, the TPU kernel's pallas_call it replaces)
KERNELS = {
    "planes": ("waldboost_tpu_torch/csrc/planes.cu",
               "waldboost_tpu/ops/plane_pallas.py:339 and :483"),
    "grad_hist": ("waldboost_tpu_torch/csrc/grad_hist.cu",
                  "waldboost_tpu/ops/channels_pallas.py:405"),
    "cascade": ("waldboost_tpu_torch/csrc/cascade.cu",
                "waldboost_tpu/ops/cascade_static.py:764"),
    "cascade_response": ("waldboost_tpu_torch/csrc/cascade.cu",
                         "waldboost_tpu/ops/cascade_static.py:611"),
    "fpga": ("waldboost_tpu_torch/csrc/fpga.cu",
             "waldboost_tpu/ops/channels_pallas.py:684"),
    "cascade_generic": ("waldboost_tpu_torch/csrc/cascade.cu",
                        "waldboost_tpu/ops/cascade_pallas.py:182"),
    "grad_hist_fast": ("waldboost_tpu_torch/csrc/grad_hist_float.cu",
                       "waldboost_tpu/ops/channels_pallas.py:405 (fast=True)"),
    "cascade_fast": ("waldboost_tpu_torch/csrc/cascade_fast.cu",
                     "waldboost_tpu/ops/cascade_static.py:764 (fast=True)"),
    "grad_hist_float": ("waldboost_tpu_torch/csrc/grad_hist_float.cu",
                        "waldboost_tpu/ops/channels_pallas.py:405 (float_dd, "
                        ":373)"),
    # S1 and S2 replace XLA operations of two-phase serving, not a
    # pallas_call
    "cascade_suffix": ("waldboost_tpu_torch/csrc/cascade.cu",
                       "replaces the XLA op waldboost_tpu/ops/cascade.py:476 "
                       "(cascade_suffix_sparse)"),
    "compact": ("waldboost_tpu_torch/csrc/compact.cu",
                "replaces the XLA ops waldboost_tpu/parallel/detect.py:759 "
                "(approx_max_k, recall_target=1.0) and :767 (lax.top_k), "
                "and the extraction's top-k, waldboost_tpu/ops/nms.py:154"),
    # S3 replaces a loop of XLA ops, not a pallas_call
    "nms": ("waldboost_tpu_torch/csrc/nms.cu",
            "replaces the XLA while loop waldboost_tpu/ops/nms.py:89 "
            "(nms_device's lax.while_loop)"),
    # S4 replaces the XLA octave chain, not a pallas_call
    "octaves": ("waldboost_tpu_torch/csrc/octaves.cu",
                "replaces the XLA octave chain "
                "waldboost_tpu/channels.py:517 (_compute_octaves_f32)"),
}
#: the fast serving mode's golden (scripts/make_torch_fast_golden.py)
FAST_GOLDEN = os.path.join(ROOT, "tests", "data",
                           "torch_port_fast_golden.npz")
#: bucketed serving's and exact float frames' goldens
#: (scripts/make_torch_bucket_golden.py)
BUCKET_GOLDEN = os.path.join(ROOT, "tests", "data",
                             "torch_port_bucket_golden.npz")
FLOAT_GOLDEN = os.path.join(ROOT, "tests", "data",
                            "torch_port_float_golden.npz")
#: (h, w) of the bucket golden's frames: three in one bucket, one apart
BUCKET_SIZES = ((480, 640), (448, 600), (432, 576), (720, 1280))
#: frame sizes no path has seen before the first-sight timing
NOVEL_SIZES = ((470, 630), (462, 618), (452, 606), (444, 596), (436, 580))
#: the FPGA bucket check: two 1080p-class sizes of one bucket
FPGA_BUCKET_SIZES = ((1080, 1920), (1072, 1904))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 (and the
#: integer work counted with it) and float64 operations/s outside the
#: tensor cores (the f64 peak counts a fused multiply-add as two)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
F64_OPS_S = 34e12
#: f64 instructions/s (an unfused add or multiply takes a fused one's
#: slot: half the FLOP peak) and conversions to or from f64/s (16 a clock
#: and SM: CUDA's throughput table for compute capability 9.0; 132 SMs at
#: the 1.98 GHz the peaks assume)
F64_INSTR_S = F64_OPS_S / 2
CONV_S = 132 * 16 * 1.98e9
#: tiling edges of B2d and B2f (h, w, batch): widths off the 128-column
#: tile, float32 widths no multiple of 4 (5, 45, 257), a multiple of 4
#: but not of 8 (132) and of 16 (256); each also one element off its
#: aligned start
GH_EDGES = (((3, 5), 3), ((17, 45), 1), ((70, 257), 3), ((33, 132), 2),
            ((70, 256), 2))


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def random_deep_stage(rng, window, n_channels, depth=5):
    """A random tree exactly ``depth`` deep (its leftmost path) with
    shallower leaves elsewhere, numbered in preorder (children above their
    parent), as a stage dict (numpy only)."""
    m, n = window
    feature, left, right = [], [], []

    def node(d, full):
        k = len(left)
        feature.append([0, 0, 0])
        left.append(-1)
        right.append(-1)
        if d < depth and (full or rng.rand() < 0.6):
            feature[k] = [rng.randint(m), rng.randint(n),
                          rng.randint(n_channels)]
            left[k] = node(d + 1, full)
            right[k] = node(d + 1, False)
        return k

    node(0, True)
    k = len(left)
    return dict(feature=np.array(feature), threshold=rng.randn(k).astype("f"),
                left=np.array(left), right=np.array(right),
                prediction=rng.randn(k).astype("f"))


#: B3f's edge set: (window, channels, the canvas's rows and columns beyond
#: the window, batch, element offset of the canvas): grids under one
#: 16 x 64 tile of origins, widths whose bfloat16 rows are off 16 bytes
#: (the front reads the canvas from global memory), grids of several tiles
#: with rows on 16 bytes (box copies), the same one element off a word
#: (global memory again)
B3F_EDGES = (((8, 8), 1, (3, 50), 3, 0), ((8, 8), 1, (40, 205), 1, 1),
             ((12, 12), 4, (40, 5), 1, 0), ((12, 12), 4, (19, 77), 3, 0),
             ((12, 12), 4, (37, 140), 3, 0), ((12, 12), 4, (37, 140), 3, 1),
             ((24, 24), 4, (9, 61), 1, 0), ((24, 24), 4, (45, 176), 3, 0),
             ((12, 12), 5, (21, 130), 1, 0), ((12, 12), 5, (50, 148), 3, 1))


def deep_model(wt, synth, dev, drng=None):
    """The seeded 40-stage model of depth-5 trees (GENERAL node records)
    with the flagship's window and channel options, on ``dev``, drawn
    from ``drng`` (``RandomState(1)`` when None; advanced)."""
    if drng is None:
        drng = np.random.RandomState(1)
    deep_stages, deep_theta = [], []
    for t in range(40):
        s = random_deep_stage(drng, (12, 12), 4, depth=5)
        s["threshold"] = drng.uniform(0, 300, len(s["threshold"])) \
            .astype(np.float32)
        deep_stages.append(s)
        deep_theta.append(-0.6 - 0.1 * t if t % 2 else -np.inf)
    return wt.model_from_stages(synth.shape, synth.channel_opts, deep_stages,
                                deep_theta, device=dev)


def static_operands(casc_mod, stages, theta, window, n_channels, dev):
    """The :class:`CascadeOperands` of stage dicts and thetas."""
    from waldboost_tpu_torch.ops.cascade import NODE_KEYS, stage_tables
    tab = stage_tables(stages)
    sc = casc_mod.StaticCascade(*(tab[k] for k in NODE_KEYS),
                                np.asarray(theta, np.float32))
    return casc_mod.CascadeOperands.build(sc, window, n_channels, dev)


def b3f_edge_models(casc_mod, rng, window, n_channels, dev):
    """Seeded cascades for B3f's edges, canvas values in [0, 300): 20
    depth-2 stages rejecting at 2 of every 3 (HEAP2 records, a front of
    stage 0), the same with stage 0 unable to reject (a front of stages
    0-2), 40 depth-5 stages rejecting at every second (GENERAL records, no
    front), 256 depth-5 stages that never reject (records past the walk's
    shared-memory budget), one stage, and 16 depth-2 stages that never
    reject (the front runs every stage)."""
    def stages(k, depth):
        out = []
        for _ in range(k):
            st = random_deep_stage(rng, window, n_channels, depth=depth)
            st["threshold"] = rng.uniform(0, 300, len(st["threshold"])) \
                .astype(np.float32)
            out.append(st)
        return out

    ninf = -np.inf
    heap20 = stages(20, 2)
    theta20 = [-0.3 - 0.05 * t if t % 3 != 1 else ninf for t in range(20)]
    models = {
        "heap20": (heap20, theta20),
        "hard20": (heap20, [ninf] + theta20[1:]),
        "deep40": (stages(40, 5), [-0.6 - 0.1 * t if t % 2 else ninf
                                   for t in range(40)]),
        "big256": (stages(256, 5), [ninf] * 256),
        "one": (stages(1, 2), [-0.2]),
        "never16": (stages(16, 2), [ninf] * 16),
    }
    return {name: static_operands(casc_mod, st, th, window, n_channels, dev)
            for name, (st, th) in models.items()}


def scene_batch(n, hw=VGA, seed=100):
    """``n`` frames of ``utils.scene_generator(seed)`` as a (n, h, w) uint8
    tensor on the CPU: textured clutter and objects, where a window enters
    2-2.5 stages of the committed cascades."""
    import torch
    from waldboost_tpu_torch.utils import scene_generator
    gen = scene_generator(seed=seed, hw=hw)
    return torch.from_numpy(np.stack([next(gen)["image"] for _ in range(n)]))


def user_grad(image):
    """Phase 10's user channel function (torch): the image and ``|gx|`` of
    ``ops.image.gradients`` as two float32 channels, registered as
    ``"user_grad"``, as ``scripts/make_torch_custom_channels_golden.py``
    registers its JAX twin."""
    import torch
    from waldboost_tpu_torch.ops.image import gradients
    im = image.to(torch.float32)
    gx, _ = gradients(im)
    return torch.stack([im, gx.abs()])


def front_paths(since):
    """How B3f's fronts read the canvas (``tma``, ``global``, ``none``) in
    the launches counted in ``_build.launches`` since ``since``, a copy of
    it (``{}``: since it was cleared)."""
    from waldboost_tpu_torch import _build
    return ", ".join(k.split("/", 1)[1]
                     for k, n in sorted(_build.launches.items())
                     if k.startswith("cascade_fast/")
                     and n != since.get(k, 0))


def b3f_edges(casc_mod, dev, seed=12):
    """``(label, canvas, valid, ops)`` over :data:`B3F_EDGES` and
    :func:`b3f_edge_models`: seeded bfloat16 canvases (values in [0,
    300)) and masks (80% valid)."""
    import torch
    rng = np.random.RandomState(seed)
    for window, C, (dh, dw), batch, off in B3F_EDGES:
        shape = (batch, C, window[0] + dh, window[1] + dw)
        vals = torch.from_numpy(rng.uniform(0, 300, shape).astype(np.float32))
        buf = torch.empty(vals.numel() + off, dtype=torch.bfloat16,
                          device=dev)
        cv = buf[off:].view(shape)
        cv.copy_(vals)
        valid = torch.from_numpy((rng.rand(dh, dw) < 0.8).astype(np.uint8)) \
            .to(dev)
        for name, ops in b3f_edge_models(casc_mod, rng, window, C,
                                         dev).items():
            yield (f"{name} window {window} C={C} canvas {shape[2:]} batch "
                   f"{batch} offset {off}", cv, valid, ops)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters=20):
    """Device milliseconds per call of ``fn``: the kernels, copies and
    memsets its calls put on the card, summed from a torch.profiler trace
    of ``iters`` calls (no host time, where CUDA events around
    back-to-back calls measure the wrapper's host time when it is the
    longer); None when the profiler saw no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0)
                for e in prof.key_averages())
    return total / 1e3 / iters if total > 0 else None


def graph_ms(fn, iters, replays=3):
    """Mean milliseconds per call of ``fn`` on the card with the host out
    of the way: ``iters`` calls captured in one CUDA graph, the graph
    replayed ``replays`` times between CUDA events (the calls' allocations
    come from the graph's pool; launch counters move only at capture)."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    del g
    return t0.elapsed_time(t1) / (iters * replays)


def max_abs_err(got, want):
    """Largest |got - want| over tensors of one shape; equal entries
    (infinities included) count 0, an infinity against a finite value
    counts inf."""
    import torch
    if got.shape != want.shape:
        return float("inf")
    got, want = got.double(), want.double()
    diff = torch.where(got == want, torch.zeros_like(got),
                       (got - want).abs().nan_to_num(nan=float("inf")))
    return float(diff.max()) if diff.numel() else 0.0


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes, f32_ops=0.0, f64_ops=0.0, conversions=0.0):
    """(ms, what bounds it): the least time of a call that moves
    ``n_bytes`` and does the given operations (``f64_ops`` unfused f64
    adds and multiplies, ``conversions`` to or from f64)."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = max(f32_ops / F32_OPS_S, f64_ops / F64_INSTR_S,
                conversions / CONV_S)
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def host_probe():
    """Host-side costs that bound a launch-heavy path: one tiny kernel
    launch, a launch plus synchronize round trip, one layer span with no
    profiler running (us each), and a fixed pure-Python loop (ms)."""
    import torch
    from waldboost_tpu_torch.parallel.detect import span
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(2000):
        x.add_(1)
    torch.cuda.synchronize()
    launch = (time.perf_counter() - t) / 2000 * 1e6
    t = time.perf_counter()
    for _ in range(200):
        x.add_(1)
        torch.cuda.synchronize()
    sync = (time.perf_counter() - t) / 200 * 1e6
    t = time.perf_counter()
    for _ in range(2000):
        with span("probe"):
            pass
    span_us = (time.perf_counter() - t) / 2000 * 1e6
    t = time.perf_counter()
    sum(i * i for i in range(200000))
    loop = (time.perf_counter() - t) * 1e3
    return {"host_launch_us": launch, "host_launch_sync_us": sync,
            "host_span_us": span_us, "host_python_loop_ms": loop}


def report_trace(trace, what):
    """``wbbench/trace.py::reduce_trace`` of a Chrome trace over its
    ``smoke.window`` span on the current card, printed after ``trace
    <what>``: the window, the device's busy time and each span's host and
    device milliseconds."""
    import torch
    from wbbench.trace import reduce_trace
    bd = reduce_trace(trace, "smoke.window", [torch.cuda.current_device()])
    print(f"trace {what} {bd['window_s'] * 1e3:.3f} ms, device busy "
          f"{bd['busy_s'] * 1e3:.3f} ms ({bd['n_device_events']} device "
          f"events)")
    for layer, t in bd["layers"].items():
        print(f"  {layer}: host {t['host_s'] * 1e3:.3f} ms, device "
              f"{t['device_s'] * 1e3:.3f} ms")
    return bd


def trace_workload(workload, fn, batches, n, metric, trace_dir=None):
    """``n`` calls of ``fn`` on the batches in turn, each ending in a
    synchronize, traced by torch.profiler in one ``smoke.window`` span:
    prints the window, the device busy time and each ``wb.*`` span's host
    and device time, and reports the device idle share (the trace kept
    in ``trace_dir`` when given)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    fn(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke.window"):
            for r in range(n):
                fn(batches[r % len(batches)])
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", dir=trace_dir)
    os.close(fd)
    prof.export_chrome_trace(path)
    with open(path) as f:
        bd = report_trace(json.load(f), f"{workload}: {n} batches in")
    if trace_dir is None:
        os.remove(path)
    else:
        os.replace(path, os.path.join(trace_dir, f"{workload}.json"))
    if bd["n_device_events"]:
        metric(f"{workload}_device_idle_share", bd["idle_share"], "1")
    else:
        print(f"trace {workload}: the profiler recorded no device events; "
              f"device idle share not measured")
    return bd


def stage_splits(trace, window):
    """Per ``window`` span of a Chrome trace (in time order): its host
    milliseconds, those of each ``wb.train.*`` span inside it, and the
    rest ("other")."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"
          and e.get("cat") == "user_annotation"]
    out = []
    for w in sorted((e for e in ev if e["name"] == window),
                    key=lambda e: e["ts"]):
        w0, w1 = w["ts"], w["ts"] + w["dur"]
        split = {"stage": w["dur"] / 1e3}
        for e in ev:
            if e["name"].startswith("wb.train.") and w0 <= e["ts"] <= w1:
                name = e["name"][len("wb.train."):]
                split[name] = split.get(name, 0.0) + e["dur"] / 1e3
        split["other"] = split["stage"] - sum(
            v for k, v in split.items() if k != "stage")
        out.append(split)
    return out


def sorted_rows(*cols):
    """(N, k) float32 rows of the given columns in lexicographic order."""
    cols = [np.asarray(c, np.float32) for c in cols]
    rows = np.concatenate([c[:, None] if c.ndim == 1 else c for c in cols],
                          axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def box_rows(boxes, *fields):
    return sorted_rows(boxes.get(), *(boxes.get_field(f) for f in fields))


def golden_split(g, key):
    return np.split(g[key + "_rows"], np.cumsum(g[key + "_counts"])[:-1])


def fpga_frames(g):
    """``(hw, frames)`` of the config-5 golden: its seeded uint8 noise."""
    hw = tuple(int(v) for v in g["hw"])
    frames = np.random.RandomState(int(g["seed"])).randint(
        0, 256, (int(g["n_frames"]),) + hw).astype(np.uint8)
    return hw, frames


def fpga_path(wt, dev, g, models):
    """Every config-5 call the golden ``g`` records, on ``dev``: per model
    name the full cascade's and its prefix's make_batched_detector_boxes
    outputs and Model.detect rows and counters, and make_batched_detector
    (n_stages_cap) alive counts and n_weak, as numpy."""
    import torch
    hw, frames = fpga_frames(g)
    images = torch.from_numpy(frames).to(dev)
    k, iou = int(g["k"]), float(g["nms_iou"])

    def detect_all(model):
        out = []
        for img in frames:
            model.reset()
            boxes = model.detect(img)
            out.append((box_rows(boxes, "scores"), model.n_weak, model.n_loc))
        return out

    res = {}
    for name, model in models.items():
        P = int(g[name + "_prefix_stages"])
        prefix = wt.model_from_stages(model.shape, model.channel_opts,
                                      model.stages[:P], model.theta[:P],
                                      device=dev)
        full, _ = wt.make_batched_detector_boxes(model, hw, k=k, nms_iou=iou,
                                                 device=dev)
        pre, _ = wt.make_batched_detector_boxes(prefix, hw, k=k, nms_iou=iou,
                                                device=dev)
        cap, _ = wt.make_batched_detector(model, hw, n_stages_cap=P,
                                          device=dev)
        _, alive, cap_nw = cap(images)
        res[name] = dict(
            full=[a.cpu().numpy() for a in full(images)],
            full_detect=detect_all(model),
            prefix=[a.cpu().numpy() for a in pre(images)],
            prefix_detect=detect_all(prefix),
            cap=(alive.sum(dim=(1, 2)).cpu().numpy(), cap_nw.cpu().numpy()))
    return res


def check_fpga_path(g, res):
    """Hold :func:`fpga_path`'s results to the golden, bitwise.  The boxes
    NMS keeps are held to the JAX package's host NMS of the same survivors
    (``kept_host``); whether JAX's device NMS kept the same is printed."""
    for name, r in res.items():
        _, _, _, count, n_weak = r["full"]
        require(np.array_equal(count, g[name + "_full_count"])
                and np.array_equal(n_weak, g[name + "_full_n_weak"]),
                f"{name}: full-cascade survivors or n_weak differ from JAX")
        for i, (rows, nw, nloc) in enumerate(r["full_detect"]):
            require((len(rows), nw, nloc) == (
                g[name + "_full_detect_counts"][i],
                g[name + "_full_detect_n_weak"][i],
                g[name + "_full_detect_n_loc"][i]),
                f"{name} frame {i}: full Model.detect differs from JAX")
        rects, scores, valid, count, n_weak = r["prefix"]
        require(np.array_equal(count, g[name + "_prefix_count"])
                and np.array_equal(n_weak, g[name + "_prefix_n_weak"]),
                f"{name}: prefix survivors or n_weak differ from JAX")
        agree = []
        for b, (ref, dev_ref) in enumerate(zip(
                golden_split(g, name + "_prefix_kept_host"),
                golden_split(g, name + "_prefix_kept"))):
            got = sorted_rows(rects[b][valid[b]], scores[b][valid[b]])
            require(np.array_equal(got, sorted_rows(ref)),
                    f"{name} frame {b}: prefix kept boxes differ from JAX")
            agree.append(np.array_equal(got, sorted_rows(dev_ref)))
        for i, (rows, det_ref) in enumerate(zip(
                r["prefix_detect"], golden_split(g, name + "_prefix_detect"))):
            require(np.array_equal(rows[0], sorted_rows(det_ref))
                    and rows[1:] == (g[name + "_prefix_detect_n_weak"][i],
                                     g[name + "_prefix_detect_n_loc"][i]),
                    f"{name} frame {i}: prefix Model.detect differs from JAX")
        alive, cap_nw = r["cap"]
        require(np.array_equal(alive, g[name + "_cap_alive"])
                and np.array_equal(cap_nw, g[name + "_cap_n_weak"]),
                f"{name}: make_batched_detector(n_stages_cap) differs")
        print(f"{name}: full cascade survivors {r['full'][3].tolist()}, "
              f"Model.detect {[len(d[0]) for d in r['full_detect']]}; "
              f"{int(g[name + '_prefix_stages'])}-stage prefix survivors "
              f"{count.tolist()}, kept {valid.sum(1).tolist()} (JAX device "
              f"NMS agrees: {agree}), Model.detect "
              f"{[len(d[0]) for d in r['prefix_detect']]}, n_stages_cap alive "
              f"{alive.tolist()}: bitwise equal to JAX")


#: BASELINE config 4 (bench.py::bench_train_loop): the training golden of
#: scripts/make_torch_train_golden.py and the settings it was made with
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data",
                            "torch_port_train_golden.npz")
TRAIN_SHAPE = (12, 12, 4)
TRAIN_OPTS = dict(shrink=2, n_per_oct=4, smooth=1, channels="grad_hist")
TRAIN_SEED, TRAIN_POOL, TRAIN_ALPHA, TRAIN_DEPTH = 11, 1000, 0.2, 2
#: the FPGA trainer at tests/test_fpga.py::test_fpga_train_end_to_end's
#: settings (fpga.train's defaults otherwise: alpha 0.1, banks 2 x 2, clip
#: 3, quantizer 32): its golden, made by the same script
FPGA_TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data",
                                 "torch_port_fpga_train_golden.npz")
FPGA_TRAIN_SHAPE = (8, 8, 4)
FPGA_TRAIN_OPTS = dict(shrink=2, n_per_oct=2, smooth=1,
                       channels="grad_hist_4_u1")
FPGA_TRAIN_SEED, FPGA_TRAIN_POOL, FPGA_TRAIN_DEPTH = 3, 60, 2
#: BASELINE config 4b (bench.py::bench_train_loop_device_pool): the
#: device-pool trainer at config 4's model, data, quotas and learner, with
#: mining seed 0, the records behind a 32-deep prefetcher and a warm
#: segment to length 2 before the rest, sharing one ``pools`` dict; its
#: golden is made by scripts/make_torch_device_train_golden.py
DEVICE_TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data",
                                   "torch_port_device_train_golden.npz")
DEVICE_TRAIN_SEED, DEVICE_TRAIN_PREFETCH, DEVICE_TRAIN_WARM = 0, 32, 2
#: the device-pool trainer with the FPGA options in-step (as wb.fpga.train
#: drives it over a mesh) at the FPGA_TRAIN_* model, data and quotas:
#: bank masks from PixelBanks (2 x 2) and BankScheduler
#: (:func:`bank_masks_fn`), clip 3, quantizer 32, integer thresholds, one
#: call to 2 stages; its golden is made by the same script
DEVICE_FPGA_TRAIN_GOLDEN = os.path.join(
    ROOT, "tests", "data", "torch_port_device_fpga_train_golden.npz")
DEVICE_FPGA_TRAIN_KW = dict(min_tp=FPGA_TRAIN_POOL, min_fp=FPGA_TRAIN_POOL,
                            seed=0, max_depth=FPGA_TRAIN_DEPTH, clip=3,
                            quantizer=32, integer_thresholds=True)


def samples_digest(samples) -> str:
    """SHA-256 of a pool's samples as float32 bytes, values of magnitude
    below 2**-30 written as 0 (the canvas's exact-cancellation tolerance,
    PARITY.md section 1c), as scripts/make_torch_train_golden.py hashes
    them."""
    import hashlib
    a = np.asarray(samples, np.float32)
    a = np.ascontiguousarray(np.where(np.abs(a) < 2.0 ** -30,
                                      np.float32(0), a))
    return hashlib.sha256(a.tobytes()).hexdigest()


def golden_tree(g, s):
    """Stage ``s``'s tree of the training golden as a stage dict."""
    return {k: g[f"s{s}_{k}"] for k in ("feature", "threshold", "left",
                                        "right", "prediction")}


def tree_diff(tree, ref):
    """None when ``tree`` (a DTree) equals the stage dict ``ref`` in
    structure and thresholds bitwise and in predictions within 1e-5, else
    what differs."""
    got = tree.to_stage_dict()
    for k in ("feature", "left", "right", "threshold"):
        if not np.array_equal(got[k], ref[k]):
            return f"{k}: {got[k].tolist()} against {ref[k].tolist()}"
    err = float(np.max(np.abs(got["prediction"] - ref["prediction"])))
    if not err <= 1e-5:
        return f"prediction differs by {err}"
    return None


def split_gains_f64(X0, W0, X1, W1, tree):
    """The entropy gain of each inner node's split of ``tree`` (a stage
    dict), recomputed in float64 from the pool with the fit's
    class-balanced weights: ``{node: gain}``."""
    X = np.concatenate([X0, X1]).reshape(len(X0) + len(X1), -1)
    X = X.astype(np.float64)
    y = np.concatenate([np.zeros(len(X0)), np.ones(len(X1))])
    W0, W1 = np.asarray(W0, np.float64), np.asarray(W1, np.float64)
    w = np.concatenate([W0 / max(W0.sum() * 2, 1e-300),
                        W1 / max(W1.sum() * 2, 1e-300)])
    m, n, C = X0.shape[1:]

    def ent(p0, p1):
        t = p0 + p1
        q = np.array([p0, p1]) / (t if t > 0 else 1.0)
        return float(-sum(v * np.log2(v) for v in q if v > 0))

    out, reach = {}, {0: np.ones(len(y), bool)}
    for k in range(len(tree["left"])):
        if k not in reach or tree["left"][k] < 0:
            continue
        r, c, ch = tree["feature"][k]
        at = reach[k]
        go_left = at & (X[:, (r * n + c) * C + ch] <= tree["threshold"][k])
        go_right = at & ~go_left
        reach[int(tree["left"][k])] = go_left
        reach[int(tree["right"][k])] = go_right
        mass = [[float(w[sel & (y == cl)].sum()) for cl in (0, 1)]
                for sel in (at, go_left, go_right)]
        tot = sum(mass[0])
        out[k] = ent(*mass[0]) - sum(
            sum(mm) / (tot if tot > 0 else 1.0) * ent(mm[0] + 1e-4,
                                                       mm[1] + 1e-4)
            for mm in mass[1:])
    return out


def check_golden_pool(g, s, pool, model):
    """Require stage ``s``'s pool and the model's counters to equal the
    training golden ``g`` bitwise (labels, scores, instance ids, the
    samples' SHA-256, counts, n_weak / n_loc / n_images); the pool's
    stats."""
    box = pool.samples
    digest = samples_digest(box.get_field("samples"))
    st, cost = pool.pool_stats(), model.cost_stats()
    require(np.array_equal(box.get_field("tp_label"), g[f"s{s}_labels"])
            and np.array_equal(box.get_field("scores"), g[f"s{s}_scores"])
            and np.array_equal(box.get_field("instance_id"),
                               g[f"s{s}_instance_id"])
            and digest == str(g["digest"][s])
            and (st["num_tp"], st["num_fp"]) == (g["n_tp"][s], g["n_fp"][s]),
            f"training stage {s}: the pool differs from JAX's")
    require((cost["n_weak"], cost["n_loc"], cost["n_images"]) == (
        g["n_weak"][s], g["n_loc"][s], g["n_images"][s]),
        f"training stage {s}: the model's counters differ from JAX's")
    return st


def check_golden_tree(s, tree, ref, X0, W0, X1, W1):
    """Require the port's fitted ``tree`` to equal the golden stage dict
    ``ref`` (structure and thresholds bitwise, predictions within 1e-5);
    on a differing split print both gains, recomputed in float64."""
    diff = tree_diff(tree, ref)
    if diff is not None:
        print(f"training stage {s}: split gains in float64, port "
              f"{split_gains_f64(X0, W0, X1, W1, tree.to_stage_dict())}, "
              f"JAX {split_gains_f64(X0, W0, X1, W1, ref)}")
    require(diff is None, f"training stage {s}: the tree differs from "
            f"JAX's: {diff}")


def check_golden_loss(g, s, lo):
    """Require the loss ``lo`` of stage ``s`` to equal the golden's: the
    loss sums numpy's float32 exp, whose SIMD paths differ by an ULP
    between hosts, so bitwise on the golden's host, else within 1e-6."""
    require(abs(lo - g["loss"][s]) <= 1e-6 * abs(g["loss"][s]),
            f"training stage {s}: loss {lo!r} against JAX's "
            f"{g['loss'][s]!r}")
    if lo != g["loss"][s]:
        print(f"training stage {s}: loss {lo!r}, the golden's "
              f"{g['loss'][s]!r} (numpy exp on this host)")


def fpga_train_golden_run(wt, dev, g):
    """``wt.fpga.train`` at the ``FPGA_TRAIN_*`` settings on ``dev`` (its
    mining runs B1, B5 and B6 there), teacher-forced against the FPGA
    training golden ``g``: each stage's fit (fpga.DTree.fit on ``dev``:
    bank-restricted features, integer thresholds, clipped and quantized
    leaves) is held to the golden tree and the golden tree is used in its
    place; after each stage a callback holds the pool and counters to the
    golden bitwise, and the theta (float32 in the port) and learner stats
    too.  Returns the trained model and its record generator."""
    from waldboost_tpu_torch.fpga import training as fpga_training
    from waldboost_tpu_torch.utils import fake_data_generator

    plain_fit = fpga_training.DTree.fit
    fits = []

    def forced_fit(X0, W0, X1, W1, **kwargs):
        s = len(fits)
        fits.append(plain_fit(X0, W0, X1, W1, **kwargs))
        ref = golden_tree(g, s)
        check_golden_tree(s, fits[-1], ref, X0, W0, X1, W1)
        return wt.DTree(ref["feature"], ref["threshold"], ref["left"],
                        ref["right"], ref["prediction"])

    def check_stage(model, learner, s):
        check_golden_pool(g, s, pool, model)
        rec = learner.history[-1]
        require(model.theta[-1] == float(np.float32(g["theta"][s]))
                and rec.p0 == g["p0"][s] and rec.p1 == g["p1"][s],
                f"FPGA training stage {s}: theta {model.theta[-1]!r}, p0 "
                f"{rec.p0!r}, p1 {rec.p1!r} against JAX's "
                f"{g['theta'][s]!r}, {g['p0'][s]!r}, {g['p1'][s]!r}")
        check_golden_loss(g, s, rec.loss)
        print(f"FPGA training stage {s}: pool tp {pool.pool_stats()['num_tp']}"
              f" fp {pool.pool_stats()['num_fp']}, tree and theta "
              f"{model.theta[-1]!r} equal to JAX's")

    gen = fake_data_generator(seed=FPGA_TRAIN_SEED)
    model = wt.Model(FPGA_TRAIN_SHAPE, FPGA_TRAIN_OPTS, device=dev)
    pool = wt.SamplePool(min_tp=FPGA_TRAIN_POOL, min_fp=FPGA_TRAIN_POOL,
                         seed=0)
    fpga_training.DTree.fit = staticmethod(forced_fit)
    try:
        wt.fpga.train(model, gen, pool=pool, length=len(g["theta"]),
                      max_depth=FPGA_TRAIN_DEPTH, callbacks=[check_stage])
    finally:
        fpga_training.DTree.fit = staticmethod(plain_fit)
    require(len(fits) == len(model) == len(g["theta"]),
            "FPGA training: not every stage was fitted")
    return model, gen


def train_golden_run(wt, dev, g, refit=()):
    """Config 4 teacher-forced against the training golden ``g`` on
    ``dev``: per stage the pool update (mining on ``dev``), held to the
    golden bitwise (labels, scores, instance ids, samples' SHA-256, pool
    counts and the model's counters); the port's fit on ``dev``, held to
    the golden tree (structure and thresholds bitwise, predictions within
    1e-5); the host SPRT on the pool's scores plus the golden tree's
    responses with the golden P0 and P1, held to the golden theta and
    learner stats bitwise; then the golden tree and theta are appended.
    Returns per-stage fit milliseconds and, for the stages in ``refit``,
    the pool ``(X0, W0, X1, W1)``."""
    import torch
    from waldboost_tpu_torch.training import (fit_rejection_threshold, loss,
                                              weights)
    from waldboost_tpu_torch.utils import fake_data_generator

    gen = fake_data_generator(seed=TRAIN_SEED)
    model = wt.Model(TRAIN_SHAPE, TRAIN_OPTS, device=dev)
    pool = wt.SamplePool(min_tp=TRAIN_POOL, min_fp=TRAIN_POOL, seed=0)
    fit_ms, pools = [], {}
    P0 = P1 = 1.0
    for s in range(len(g["theta"])):
        pool.update(model, gen)
        st = check_golden_pool(g, s, pool, model)
        X0, H0 = pool.get_false_positives()
        X1, H1 = pool.get_true_positives()
        W0, W1 = weights(H0), weights(-np.asarray(H1))
        if s in refit:
            pools[s] = (X0, W0, X1, W1)
        ref = golden_tree(g, s)
        t = time.perf_counter()
        tree = wt.DTree.fit(X0, W0, X1, W1, max_depth=TRAIN_DEPTH,
                            device=dev)
        fit_ms.append((time.perf_counter() - t) * 1e3)
        check_golden_tree(s, tree, ref, X0, W0, X1, W1)
        gtree = wt.DTree(ref["feature"], ref["threshold"], ref["left"],
                         ref["right"], ref["prediction"])
        H0g = H0 + gtree.predict(X0)
        H1g = H1 + gtree.predict(X1)
        theta = fit_rejection_threshold(H0g, P0, H1g, P1, TRAIN_ALPHA)
        p0 = (H0g >= theta).sum() / max(H0g.size, 1)
        p1 = (H1g >= theta).sum() / max(H1g.size, 1)
        lo = loss(H0g, H1g)
        require(theta == g["theta"][s] and p0 == g["p0"][s]
                and p1 == g["p1"][s],
                f"training stage {s}: theta {theta!r}, p0 {p0!r}, p1 {p1!r} "
                f"against JAX's {g['theta'][s]!r}, {g['p0'][s]!r}, "
                f"{g['p1'][s]!r}")
        check_golden_loss(g, s, lo)
        P0 *= float(g["p0"][s])
        P1 *= float(g["p1"][s])
        model.append(ref, float(g["theta"][s]))
        print(f"training stage {s}: pool tp {st['num_tp']} fp "
              f"{st['num_fp']}, tree and theta {theta!r} equal to JAX's "
              f"(fit {fit_ms[-1]:.1f} ms)")
    return fit_ms, pools


def heap_stage_dict(tree, shape):
    """The stage dict of a heap-layout tree ``(feature, threshold, left,
    right, pred)`` (numpy), unreachable nodes pruned."""
    from waldboost_tpu_torch.parallel.trainer import _dtree_from_fit
    return _dtree_from_fit(tree, shape).to_stage_dict()


def heap_tree_diff(tree, g, s, key="heap"):
    """None when the heap tables ``tree`` (numpy) equal stage ``s``'s
    ``key`` tree of the device-training golden ``g`` (features, children
    and thresholds bitwise, predictions within 1e-5), else what
    differs."""
    for i, k in enumerate(("feature", "threshold", "left", "right")):
        ref = g[f"s{s}_{key}_{k}"]
        if not np.array_equal(tree[i], ref):
            return f"{k}: {tree[i].tolist()} against {ref.tolist()}"
    err = float(np.max(np.abs(tree[4] - g[f"s{s}_{key}_pred"])))
    if not err <= 1e-5:
        return f"pred differs by {err}"
    return None


def bank_masks_fn(banks, scheduler, scheduled):
    """``feature_masks_fn`` of the FPGA device-training run: each stage's
    (depth, F) mask allows one bank of ``banks`` (a ``PixelBanks``) per
    depth, as ``scheduler`` (a ``BankScheduler``) schedules them; each
    stage's banks are appended to ``scheduled``.  Takes the objects, so
    that the golden script passes the JAX package's."""
    depth = FPGA_TRAIN_DEPTH
    F = int(np.prod(FPGA_TRAIN_SHAPE))

    def masks_fn(stage):
        mask = np.zeros((depth, F), bool)
        scheduled.append(scheduler.schedule(depth))
        for d, b in enumerate(scheduled[-1]):
            mask[d, banks.bank_pixels(b)] = True
        return mask
    return masks_fn


def check_bank_stages(model, banks, scheduled):
    """The FPGA device-training run's invariants: integer thresholds,
    leaves on the 1/32 grid within +-3, every split feature in its
    depth's scheduled bank."""
    m, n, C = model.shape
    require(len(model) == len(scheduled),
            "FPGA device training: a stage without its bank schedule")
    for st, banks_s in zip(model.stages, scheduled):
        thr, pred = st["threshold"], st["prediction"]
        require(np.array_equal(thr, np.floor(thr))
                and np.array_equal(pred * 32, np.round(pred * 32))
                and np.abs(pred).max() <= 3,
                "FPGA device training: a stage is not integer / "
                "1/32-quantized")
        node_depth = {0: 0}
        for k in range(len(st["left"])):
            if st["left"][k] < 0:
                continue
            d = node_depth[k]
            node_depth[int(st["left"][k])] = node_depth[
                int(st["right"][k])] = d + 1
            r, c, ch = st["feature"][k]
            require((r * n + c) * C + ch in set(banks.bank_pixels(
                banks_s[d]).tolist()),
                f"FPGA device training: node {k}'s feature is outside "
                f"depth {d}'s bank {banks_s[d]}")


def device_train_golden_run(wt, dev, g, fpga=False, mesh=None):
    """The device-pool trainer on ``dev``, teacher-forced against the
    device-training golden ``g``.  Config 4b (``fpga`` false):
    ``train_sharded`` as bench.py runs it (the prefetched generator, a
    warm call to ``DEVICE_TRAIN_WARM`` stages, then the rest, one
    ``pools`` dict).  ``fpga``: one call at the ``FPGA_TRAIN_*`` settings
    with ``DEVICE_FPGA_TRAIN_KW`` and :func:`bank_masks_fn`, and
    :func:`check_bank_stages` at the end.  With ``mesh`` the pools are
    sharded over it (their shards gathered on ``dev`` for the checks),
    and the FPGA run is ``fpga.train(mesh=...)`` with the same settings.

    Each stage step is wrapped: the pools entering it (v, H, counts, the
    digests of x), the model's mining counters and the step's inputs
    (P0, P1, use_sprt, the feature mask; none where the golden has none)
    are held to the golden bitwise;
    the step's fit is held to the golden's fitted heap tree (``fit`` keys
    where the golden has them, the tree before the FPGA transforms, else
    ``heap``): features, children and thresholds bitwise, predictions
    within 1e-5 (on a differing split both gains are printed, recomputed
    in float64), and the golden tree is used in its place; then the
    step's tree, theta, p0, p1, n0, n1 and the pruned masks are held
    bitwise and the loss within 1e-6.  Returns the trained model and the
    record generator, which goes on past the records the run took."""
    import torch
    from waldboost_tpu_torch.fpga.banks import BankScheduler, PixelBanks
    from waldboost_tpu_torch.io import prefetch_iterable
    from waldboost_tpu_torch.ops.fit import TreeFitResult
    from waldboost_tpu_torch.parallel import train_step, trainer
    from waldboost_tpu_torch.utils import fake_data_generator

    from waldboost_tpu_torch.parallel.mesh import gather

    n_stages = len(g["theta"])
    if fpga:
        shape, opts, depth = FPGA_TRAIN_SHAPE, FPGA_TRAIN_OPTS, \
            FPGA_TRAIN_DEPTH
        gen = fake_data_generator(seed=FPGA_TRAIN_SEED)
        banks, scheduled = PixelBanks(shape, (2, 2)), []
        kw = dict(DEVICE_FPGA_TRAIN_KW, feature_masks_fn=bank_masks_fn(
            banks, BankScheduler(int(banks.n_banks)), scheduled))
        lengths = (n_stages,)
        if mesh is not None:
            # fpga.train schedules the same banks itself
            sched = BankScheduler(int(banks.n_banks))
            scheduled += [sched.schedule(depth) for _ in range(n_stages)]
    else:
        shape, opts, depth = TRAIN_SHAPE, TRAIN_OPTS, TRAIN_DEPTH
        gen = prefetch_iterable(fake_data_generator(seed=TRAIN_SEED),
                                depth=DEVICE_TRAIN_PREFETCH)
        kw = dict(min_tp=TRAIN_POOL, min_fp=TRAIN_POOL,
                  seed=DEVICE_TRAIN_SEED, pools={})
        lengths = (DEVICE_TRAIN_WARM, n_stages)
    fit_key = "fit" if "s0_fit_feature" in g else "heap"
    model = wt.Model(shape, opts, device=dev)
    m, n, C = shape
    real_make, real_fit = trainer.make_train_step, train_step.fit_tree_complete
    done = []

    def host(t):
        return (gather(t, mesh, dev) if isinstance(t, list) else t).cpu() \
            .numpy()

    def forced_fit(s):
        def fit(xf, y, w_split, w_pred, valid, **kwargs):
            res = real_fit(xf, y, w_split, w_pred, valid, **kwargs)
            got = tuple(host(t) for t in res)
            diff = heap_tree_diff(got, g, s, fit_key)
            if diff is not None:
                ref = tuple(g[f"s{s}_{fit_key}_{k}"]
                            for k in TreeFitResult._fields)
                sel = [host(valid & (y == c)) for c in (0, 1)]
                X = host(xf).reshape(-1, m, n, C)
                W = host(w_pred)
                pools = (X[sel[0]], W[sel[0]], X[sel[1]], W[sel[1]])
                gains = [split_gains_f64(*pools, heap_stage_dict(t, shape))
                         for t in (got, ref)]
                print(f"device training stage {s}: split gains in float64, "
                      f"port {gains[0]}, JAX {gains[1]}")
            require(diff is None, f"device training stage {s}: the tree "
                    f"differs from JAX's: {diff}")
            return TreeFitResult(*(
                torch.from_numpy(np.array(g[f"s{s}_{fit_key}_{k}"])).to(dev)
                for k in TreeFitResult._fields))
        return fit

    def make(**kwargs):
        step = real_make(**kwargs)

        def checked(x0, H0, v0, x1, H1, v1, P0, P1, theta_in, use_sprt,
                    fmask=None):
            s = len(done)
            require(s < n_stages, "device training: more stages than the "
                    "golden holds")
            cost = model.cost_stats()
            pools_in = (host(v0), host(v1), host(H0), host(H1))
            require(all(np.array_equal(a, g[f"s{s}_{k}"]) for a, k in zip(
                        pools_in, ("v0", "v1", "H0", "H1")))
                    and (int(pools_in[0].sum()), int(pools_in[1].sum()))
                    == (g["n_fp"][s], g["n_tp"][s])
                    and samples_digest(host(x0)) == str(g["digest_fp"][s])
                    and samples_digest(host(x1)) == str(g["digest_tp"][s]),
                    f"device training stage {s}: the pools differ from "
                    f"JAX's")
            require((cost["n_weak"], cost["n_loc"], cost["n_images"]) == (
                g["n_weak"][s], g["n_loc"][s], g["n_images"][s]),
                f"device training stage {s}: the model's counters differ "
                f"from JAX's")
            ref_mask = g.get(f"s{s}_fmask")
            require(np.float32(P0) == g["P0"][s]
                    and np.float32(P1) == g["P1"][s]
                    and bool(use_sprt) == bool(g["use_sprt"][s])
                    and (np.array_equal(np.asarray(fmask), ref_mask)
                         if ref_mask is not None else
                         fmask is None or np.all(fmask)),
                    f"device training stage {s}: the step's inputs differ")
            train_step.fit_tree_complete = forced_fit(s)
            try:
                res = step(x0, H0, v0, x1, H1, v1, P0, P1, theta_in,
                           use_sprt, fmask)
            finally:
                train_step.fit_tree_complete = real_fit
            got = {k: host(getattr(res, k)) for k in (
                "theta", "p0", "p1", "n0", "n1", "loss")}
            require(all(np.array_equal(host(t), g[f"s{s}_heap_{k}"])
                        for k, t in res.tree._asdict().items()),
                    f"device training stage {s}: the step's tree differs "
                    f"from JAX's")
            require(all(got[k] == g[k][s] for k in ("theta", "p0", "p1",
                                                   "n0", "n1"))
                    and np.array_equal(host(res.v0), g[f"s{s}_v0_out"])
                    and np.array_equal(host(res.v1), g[f"s{s}_v1_out"]),
                    f"device training stage {s}: theta, p0, p1, counts or "
                    f"pruned pools {got} differ from JAX's")
            require(abs(got["loss"] - g["loss"][s]) <= 1e-6 * g["loss"][s],
                    f"device training stage {s}: loss {got['loss']!r} "
                    f"against JAX's {g['loss'][s]!r}")
            done.append(s)
            print(f"device training stage {s}: pools fp {g['n_fp'][s]} tp "
                  f"{g['n_tp'][s]} and tree equal to JAX's, theta "
                  f"{float(got['theta'])!r}, pruned to {int(got['n0'])} / "
                  f"{int(got['n1'])}")
            return res
        return checked

    trainer.make_train_step = make
    try:
        learner = wt.Learner(alpha=TRAIN_ALPHA, max_depth=depth)
        for length in lengths:
            if fpga and mesh is not None:
                wt.fpga.train(model, gen, learner=learner, length=length,
                              pool=wt.SamplePool(min_tp=kw["min_tp"],
                                                 min_fp=kw["min_fp"],
                                                 seed=kw["seed"]),
                              max_depth=depth, clip=kw["clip"],
                              quantizer=kw["quantizer"], mesh=mesh)
            else:
                trainer.train_sharded(model, gen, learner=learner,
                                      length=length, mesh=mesh, **kw)
    finally:
        trainer.make_train_step = real_make
    require(len(done) == len(model) == n_stages,
            "device training: not every stage ran")
    for s, (stage, theta) in enumerate(model):
        ref = golden_tree(g, s)
        require(all(np.array_equal(stage[k], ref[k]) for k in ref)
                and theta == float(g["theta"][s]),
                f"device training stage {s}: the appended tree or theta "
                f"differs from JAX's")
    if fpga:
        check_bank_stages(model, banks, scheduled)
    return model, gen


def pyramid_checks(wt, dev, frames, model, other):
    """On each frame: ``channel_pyramid`` on ``dev`` equals its CPU run
    bitwise (``model``'s channel options); ``model.scan_channels``'
    survivors and scores equal ``model.scan_packed``'s, level by level;
    ``wt.detect`` over ``model`` and ``other`` (other channel options)
    equals the per-level loop run on the CPU.  Returns the levels,
    survivors and mixed-detect boxes per frame."""
    from waldboost_tpu_torch.channels import channel_pyramid

    def on_cpu(mm):
        return wt.model_from_stages(mm.shape, mm.channel_opts, mm.stages,
                                    mm.theta, device="cpu")

    cpu_pair = [on_cpu(model), on_cpu(other)]
    out = []
    for i, frame in enumerate(frames):
        got = list(channel_pyramid(frame, model.channel_opts, device=dev))
        want = list(channel_pyramid(frame, model.channel_opts,
                                    device="cpu"))
        require(len(got) == len(want) > 0 and all(
            sa == sb and np.array_equal(a, b)
            for (a, sa), (b, sb) in zip(got, want)),
            f"pyramid frame {i}: channel_pyramid on the card differs from "
            f"the CPU's")
        _, packed, rs, cs, hs = model.scan_packed(frame)
        lid = packed.level_maps(model.shape[:2])[0][rs, cs]
        where = {pl.plan_index: (li, pl) for li, pl in
                 enumerate(packed.levels)}
        n_surv = 0
        for pi, (_, _, (r, c, h)) in enumerate(model.scan_channels(frame)):
            if pi in where:
                li, pl = where[pi]
                sel = lid == li
                ref = (rs[sel] - pl.y, cs[sel] - pl.x, hs[sel])
            else:
                ref = (np.empty(0, np.int64),) * 2 + (
                    np.empty(0, np.float32),)
            require(all(np.array_equal(a, b) for a, b in zip((r, c, h),
                                                             ref)),
                    f"pyramid frame {i} level {pi}: scan_channels differs "
                    f"from scan_packed")
            n_surv += len(r)
        mixed = wt.detect(frame, model, other, response_scale=[1, 0.5])
        ref = wt.detect(frame, *cpu_pair, response_scale=[1, 0.5])
        require(np.array_equal(box_rows(mixed, "scores", "label"),
                               box_rows(ref, "scores", "label")),
                f"pyramid frame {i}: mixed-option wt.detect differs from "
                f"the per-level loop on the CPU")
        out.append((len(got), n_surv, len(mixed)))
    return out


def stage_memcpy(trace, window):
    """Per ``window`` span of a Chrome trace (in time order): the bytes of
    the device copies launched inside it, host-to-device and
    device-to-host, its largest single copy, and whether it mined (holds a
    ``wb.train.mine`` span).  A copy's size is its ``bytes`` argument, or
    its bandwidth times its duration where the trace has no such field."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in ev
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    spans = [e for e in ev if e.get("cat") == "user_annotation"]
    copies = []
    for e in ev:
        if e.get("cat") != "gpu_memcpy":
            continue
        a = e.get("args", {})
        size = a.get("bytes")
        if size is None:
            size = a.get("memory bandwidth (GB/s)", 0.0) * e["dur"] * 1e3
        kind = ("h2d" if "HtoD" in e["name"] else
                "d2h" if "DtoH" in e["name"] else "d2d")
        copies.append((launch_ts.get(a.get("correlation")), kind,
                       int(size)))
    out = []
    for w in sorted((e for e in spans if e["name"] == window),
                    key=lambda e: e["ts"]):
        w0, w1 = w["ts"], w["ts"] + w["dur"]
        rec = {"h2d": 0, "d2h": 0, "d2d": 0, "largest": 0,
               "mined": any(e["name"] == "wb.train.mine"
                            and w0 <= e["ts"] <= w1 for e in spans)}
        for lt, kind, size in copies:
            if lt is not None and w0 <= lt <= w1:
                rec[kind] += size
                if kind != "d2d":
                    rec["largest"] = max(rec["largest"], size)
        out.append(rec)
    n_unmatched = sum(lt is None for lt, _, _ in copies)
    return out, n_unmatched


#: the image-space canvas's and verified serving's golden, and the three
#: image-space cascades it was made with (scripts/make_torch_canvas_golden.py)
CANVAS_GOLDEN = os.path.join(ROOT, "tests", "data",
                             "torch_port_canvas_golden.npz")
CANVAS_MODELS = {"s1": "torch_port_s1_synth_64",
                 "grad_mag": "torch_port_grad_mag_synth_64",
                 "hist_mag": "torch_port_hist_mag_synth_64"}
#: PARITY.md's float bound: the share of boxes (rectangle and score) in
#: one set and not the other
FLIP_BOUND = 0.005
#: the verifier's tolerance: |port - JAX| <= VERIFIER_TOL * max(1, max|JAX|)
VERIFIER_TOL = 1e-5


def canvas_model_path(key):
    return os.path.join(ROOT, "tests", "data", CANVAS_MODELS[key] + ".pb")


def canvas_golden_frames(g):
    """The golden's frames: the VGA golden's scenes, then its noise."""
    scenes = np.load(GOLDEN)["frames"][:int(g["n_scenes"])]
    noise = np.random.RandomState(int(g["noise_seed"])).randint(
        0, 256, (2,) + VGA).astype(np.uint8)
    return np.concatenate([scenes, noise])


def golden_rows(g, key, i, *cols):
    """Frame i's rows of the golden's ``key`` columns."""
    start = int(g[f"{key}_counts"][:i].sum())
    stop = start + int(g[f"{key}_counts"][i])
    return [g[f"{key}_{c}"][start:stop] for c in cols]


def flip_share(a, b):
    """(flipped, total): rows of (N, 5) box-and-score arrays in one set
    and not the other, over the rows in either."""
    sa, sb = set(map(tuple, a.tolist())), set(map(tuple, b.tolist()))
    return len(sa ^ sb), len(sa | sb)


def canvas_golden_run(wt, dev, g, frames, idx):
    """The image-space cascades on frames ``idx`` on ``dev`` against the
    golden: Model.detect's survivors and n_weak, then host NMS 0.5, and
    the batched (k=1024, NMS 0.5) and bucketed detectors' kept boxes;
    the shrink-1 cascade bitwise (its float frame too within the flip
    bound), the grad_mag ones within the flip bound.  Returns per model
    the survivors, kept boxes and flip counts."""
    import torch
    out = {}
    for key in CANVAS_MODELS:
        model = wt.load(canvas_model_path(key), device=dev)
        exact = key == "s1"
        flips = [0, 0]
        n_raw = n_kept = 0

        def hold(what, got, want):
            if exact:
                require(np.array_equal(got, want),
                        f"{key}: {what} differ from the golden")
            f, t = flip_share(got, want)
            flips[0] += f
            flips[1] += t

        sub = frames[idx]
        det, _ = wt.make_batched_detector_boxes(model, VGA, k=1024,
                                                nms_iou=0.5, device=dev)
        rects, scores, valid, count, _ = (
            a.cpu().numpy() for a in det(torch.from_numpy(sub).to(dev)))
        bucket = wt.parallel.detect.BucketedDetector(
            model, bucket=128, k=1024, nms_iou=0.5, device=dev)
        for j, (i, kept_b) in enumerate(zip(idx, bucket.detect_many(
                list(sub)))):
            model.reset()
            raw = model.detect(frames[i])
            want = sorted_rows(*golden_rows(g, key + "_raw", i, "rects",
                                            "scores"))
            hold(f"frame {i} survivors", box_rows(raw, "scores"), want)
            if exact:
                require(model.cost_stats()["n_weak"] == int(
                    g[key + "_n_weak"][i]), f"{key}: frame {i} n_weak "
                    f"differs from the golden")
                require(count[j] == len(want), f"{key}: frame {i} batched "
                        f"survivor count differs from the golden")
            kept = sorted_rows(*golden_rows(g, key + "_kept", i, "rects",
                                            "scores"))
            hold(f"frame {i} kept boxes (host NMS)", box_rows(
                wt.bbx.non_max_suppression(raw, iou_threshold=0.5),
                "scores"), kept)
            hold(f"frame {i} batched kept boxes",
                 sorted_rows(rects[j][valid[j]], scores[j][valid[j]]), kept)
            hold(f"frame {i} bucketed kept boxes", box_rows(kept_b,
                                                            "scores"), kept)
            n_raw += len(raw)
            n_kept += len(kept)
        if exact and 3 in idx:
            raw = model.detect(frames[3].astype(np.float32)
                               + np.float32(0.25))
            f, t = flip_share(box_rows(raw, "scores"), sorted_rows(
                *golden_rows(g, "s1f_raw", 0, "rects", "scores")))
            require(f <= FLIP_BOUND * t, f"s1: float frame flips {f} of {t}")
            out["s1_float_flips"] = (f, t)
        require(flips[0] <= FLIP_BOUND * flips[1],
                f"{key}: {flips[0]} of {flips[1]} boxes flip against the "
                f"golden")
        out[key] = (n_raw, n_kept, tuple(flips))
    return out


def flax_params(g, prefix):
    """The flax parameter tree stored in ``g`` under ``prefix/...`` keys
    (one key a leaf, its path joined by "/") as nested dicts."""
    tree = {}
    for k in g.files:
        if k.startswith(prefix + "/"):
            node = tree
            *path, leaf = k.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = g[k]
    return tree


def golden_verifier(wt, g):
    """The golden's verifier as the port's (module, state dict)."""
    from waldboost_tpu_torch.convert import verifier_state_dict
    return (wt.verification.VerifierCNN(TRAIN_SHAPE),
            verifier_state_dict(flax_params(g, "verifier")))


def verifier_close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    return float(np.abs(np.asarray(got) - want).max(initial=0.0)), \
        VERIFIER_TOL * scale


def precision_probe(net):
    """``(seen, handle)``: a list that each forward call of ``net`` (and
    of its deep copies, which share the hook) appends the float32 matmul
    precision and cuDNN's convolution precision to, as they stand during
    the call, and the hook's handle (``handle.remove()`` ends the
    probe)."""
    import torch
    seen = []

    def probe(*_):
        conv = getattr(torch.backends.cudnn, "conv", None)
        seen.append((torch.get_float32_matmul_precision(),
                     getattr(conv, "fp32_precision", None)
                     if conv is not None
                     else not torch.backends.cudnn.allow_tf32))
    return seen, net.register_forward_pre_hook(probe)


def tf32_probe(wt, verifier, dev):
    """:func:`precision_probe` on the program of ``verifier`` on
    ``dev``."""
    return precision_probe(
        wt.verification.get_verifier_program(*verifier, dev).net)


def full_f32(seen) -> bool:
    """Whether a probe saw calls, each at full float32 (no TF32)."""
    return bool(seen) and all(p == "highest" and c in ("ieee", True)
                              for p, c in seen)


def verifier_golden_run(wt, dev, g, scenes, idx, verifier):
    """On scenes ``idx`` (the flagship and ``verifier``, the golden's as
    :func:`golden_verifier` gives it, on ``dev``): ``detect_and_verify``'s boxes and cascade scores bitwise
    the golden's, its verified scores and ``verify_scores`` on its
    windows within the tolerance; the fused bucket (k=1024, NMS 0.5)
    equal to detect_and_verify then host NMS on the verified scores,
    and to the golden's fused bucket within the tolerance.  Returns the
    windows and kept boxes per frame and the largest score error."""
    module, state = verifier
    synth = wt.load(os.path.join(ROOT, "models", "flagship_synth_64.pb"),
                    device=dev)
    bdet = wt.parallel.detect.BucketedDetector(
        synth, bucket=128, k=1024, nms_iou=0.5, verifier=(module, state),
        device=dev)
    fused = bdet.detect_many([scenes[i] for i in idx])
    out, worst = [], 0.0
    for i, fb in zip(idx, fused):
        dv = wt.verification.detect_and_verify(scenes[i], synth, module,
                                               state)
        rects, scores, casc = golden_rows(g, "ver", i, "rects", "scores",
                                          "cascade_scores")
        require(np.array_equal(dv.get(), rects) and np.array_equal(
            dv.get_field("cascade_scores"), casc),
            f"verifier frame {i}: boxes or cascade scores differ from the "
            f"golden")
        err, tol = verifier_close(dv.get_field("scores"), scores)
        require(err <= tol, f"verifier frame {i}: verified scores {err} "
                f"from the golden (tolerance {tol})")
        worst = max(worst, err)
        _, _, rs, cs, hs = synth.scan_packed(scenes[i])
        wins = synth.gather_windows_device(scenes[i], rs, cs)
        err, tol = verifier_close(wt.verification.verify_scores(
            module, state, wins, hs, device=dev), scores)
        require(err <= tol, f"verifier frame {i}: verify_scores {err} from "
                f"the golden (tolerance {tol})")
        worst = max(worst, err)
        ref = wt.bbx.non_max_suppression(dv, iou_threshold=0.5)
        got_rows = box_rows(fb, "cascade_scores")
        require(np.array_equal(got_rows, box_rows(ref, "cascade_scores")),
                f"verifier frame {i}: the fused bucket keeps other boxes "
                f"than detect_and_verify then NMS")
        want_rows = sorted_rows(*golden_rows(g, "vbk", i, "rects",
                                             "cascade_scores"))
        require(np.array_equal(got_rows, want_rows),
                f"verifier frame {i}: the fused bucket keeps other boxes "
                f"than the golden's")
        a = box_rows(fb, "cascade_scores", "scores")
        b = sorted_rows(*golden_rows(g, "vbk", i, "rects", "cascade_scores",
                                     "scores"))
        err, tol = verifier_close(a[:, -1], b[:, -1])
        require(err <= tol, f"verifier frame {i}: fused verified scores "
                f"{err} from the golden (tolerance {tol})")
        worst = max(worst, err)
        out.append((len(dv), len(fb)))
    return out, worst


#: slice 13's golden (scripts/make_torch_cli_golden.py, JAX on the CPU):
#: verifier training, the CLI's train and detect, single-scale serving
CLI_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_cli_golden.npz")
#: phase 7a: the verifier trained teacher-forced (dropout off) on seeded
#: pools of config 4's window, VTRAIN_POOL windows a class
VTRAIN_POOL = 1000
VTRAIN_KW = dict(epochs=2, steps=50, batch_size=64, lr=1e-4, seed=0)
#: 7a's tolerances, absolute: the trained parameters and the printed epoch
#: losses against JAX's (the two sides sum convolutions, GroupNorm's
#: statistics and the loss in other orders).  On an H100 a sound run read
#: 4.27e-6 for the parameters and 0 for the losses; with TF32 on the
#: parameters read 2.53e-3, with Adam's bias corrections dropped 3.8e-2:
#: 7a requires both planted faults to fall outside the tolerance
VTRAIN_PARAM_TOL, VTRAIN_LOSS_TOL = 2e-5, 1e-5
#: 7b: the verifier arm of BASELINE.md round 4 (scripts/exp_r10_verifier.py):
#: config 4's detector to 32 stages, the verifier 3 epochs x 400 batches of
#: 64 on the final pool, AUC over 200 held-out images (seed 999, IoU 0.5)
VARM_STAGES, VARM_EPOCHS, VARM_STEPS = 32, 3, 400
VARM_EVAL, VARM_EVAL_SEED, VARM_AUC_SLACK = 200, 999, 0.03
#: 7c: the CLI's training runs: config 4's widths; the FPGA trainer at
#: FPGA_TRAIN_*'s; a bbGt directory of CLI_BBGT_IMAGES frames
CLI_TRAIN_ARGS = ("--length", "4", "--n-per-oct", "4", "--min-tp", "1000",
                  "--min-fp", "1000", "--seed", "0")
CLI_FPGA_ARGS = ("--fpga", "--length", "3", "--shape", "8", "8", "4",
                 "--channels", "grad_hist_4_u1", "--n-per-oct", "2",
                 "--min-tp", "60", "--min-fp", "60", "--seed", "3")
CLI_BBGT_ARGS = ("--length", "2", "--n-per-oct", "2", "--min-tp", "50",
                 "--min-fp", "50", "--seed", "0")
CLI_TRAIN_RUNS = {"train": CLI_TRAIN_ARGS, "fpga": CLI_FPGA_ARGS}
CLI_BBGT_IMAGES = 10
#: 7d: the CLI's detection over CLI_FRAMES VGA scenes (scene_batch), with
#: the first model alone and with both
CLI_FRAMES = 8
CLI_DETECT_MODELS = ("flagship_synth_64", "flagship_hard_64")
#: 7e: single-scale serving (model, n_scales, k, with_n_weak): config 1 as
#: bench.py::bench_vga_single_scale serves it, and counting n_weak, then
#: the flagship's pyramid capped at 1 and 4 levels; on a noise batch, the
#: scene batch and a batch of coarse noise (N_SCALES_GRAIN-pixel blocks).
#: Config 1's stumps pass no window of the first two (n_weak shows their
#: walk); on the coarse batch every run keeps windows, whose boxes and
#: scores are compared
N_SCALES_RUNS = (("config1_stump_synth_64", 1, 128, False),
                 ("config1_stump_synth_64", 1, 128, True),
                 ("flagship_synth_64", 1, 1024, True),
                 ("flagship_synth_64", 4, 1024, True))
N_SCALES_NOISE_SEED, N_SCALES_COARSE_SEED, N_SCALES_GRAIN = 13, 2, 6


def dropout_off(wt, shape=TRAIN_SHAPE):
    """The port's verifier for ``shape`` with its dropout off, as JAX's
    tests switch flax's off from outside: a subclass whose ``forward``
    ignores the generator of the dropout masks that ``train`` hands it."""
    class DropoutOff(wt.verification.VerifierCNN):
        def forward(self, x, generator=None):
            return super().forward(x)
    return DropoutOff(shape)


def verifier_pools(n=VTRAIN_POOL, shape=TRAIN_SHAPE, seed=0):
    """Seeded verifier pools ``(X0, H0, X1, H1)``: ``n`` uniform windows a
    class, the positives with a brighter centre, cascade scores N(0,
    0.1)."""
    rng = np.random.RandomState(seed)
    X0 = rng.rand(n, *shape).astype(np.float32)
    X1 = rng.rand(n, *shape).astype(np.float32)
    m, w = shape[0] // 4, shape[1] // 4
    X1[:, m:shape[0] - m, w:shape[1] - w, :] += 1.0
    H0 = (rng.randn(n) * 0.1).astype(np.float32)
    H1 = (rng.randn(n) * 0.1).astype(np.float32)
    return X0, H0, X1, H1


def printed_losses(text):
    """The losses of the ``Epoch e/E: loss x`` lines of a training log."""
    return [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith("Epoch ")]


def vtrain_golden_run(wt, dev, g):
    """Phase 7a: the verifier trained on ``dev`` with dropout off from the
    golden's flax init on :func:`verifier_pools`, the epoch losses and
    the parameters held to JAX's (VTRAIN_*_TOL).  Returns ``(state,
    worst parameter difference, worst loss difference, ms a step by the
    host clock ending in a synchronize, the precision probe's calls)``."""
    import contextlib
    import io

    import torch
    from waldboost_tpu_torch.convert import verifier_state_dict
    X0, H0, X1, H1 = verifier_pools()
    module = dropout_off(wt)
    seen, probe = precision_probe(module)
    log = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = wt.verification.train(
            module, verifier_state_dict(flax_params(g, "vinit")), X0, H0,
            X1, H1, device=dev, **VTRAIN_KW)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t) * 1e3 / (VTRAIN_KW["epochs"]
                                            * VTRAIN_KW["steps"])
    probe.remove()
    got, want = printed_losses(log.getvalue()), printed_losses(
        str(g["vtrain_log"]))
    require(len(got) == len(want) == VTRAIN_KW["epochs"],
            f"verifier training printed {got}, JAX {want}")
    loss_err = max(abs(a - b) for a, b in zip(got, want))
    require(loss_err <= VTRAIN_LOSS_TOL, f"verifier training: epoch losses "
            f"{got} against JAX's {want} (tolerance {VTRAIN_LOSS_TOL})")
    ref = verifier_state_dict(flax_params(g, "vfinal"))
    require(sorted(state) == sorted(ref), "verifier training: other "
            "parameters than JAX's")
    err = max(float((state[k] - ref[k]).abs().max()) for k in ref)
    require(err <= VTRAIN_PARAM_TOL, f"verifier training: parameters {err} "
            f"from JAX's (tolerance {VTRAIN_PARAM_TOL})")
    return state, err, loss_err, ms, seen


def vtrain_planted_faults(wt, dev, g):
    """7a's parameter difference from JAX's with a fault planted in the
    port's training: ``{"tf32": TF32 on inside every pass, "no_bias_
    correction": Adam's bias corrections dropped (the step count taken as
    1e6, where both are 1 in float32)}``; the readings that
    VTRAIN_PARAM_TOL must stay below."""
    import contextlib

    import torch
    from waldboost_tpu_torch.convert import verifier_state_dict
    from waldboost_tpu_torch.ops.fit import full_f32_matmul
    V = wt.verification
    adam = V._adam_step

    @contextlib.contextmanager
    def tf32_on():
        with full_f32_matmul():        # restores the caller's settings
            torch.set_float32_matmul_precision("high")
            conv = getattr(torch.backends.cudnn, "conv", None)
            if conv is not None and hasattr(conv, "fp32_precision"):
                conv.fp32_precision = "tf32"
            else:
                torch.backends.cudnn.allow_tf32 = True
            yield

    faults = {"tf32": ("full_f32_matmul", tf32_on),
              "no_bias_correction": ("_adam_step", lambda p, gr, m, v, t, lr:
                                     adam(p, gr, m, v, 10 ** 6, lr))}
    ref = verifier_state_dict(flax_params(g, "vfinal"))
    init = verifier_state_dict(flax_params(g, "vinit"))
    out = {}
    for key, (attr, fault) in faults.items():
        sound = getattr(V, attr)
        setattr(V, attr, fault)
        try:
            state = V.train(dropout_off(wt), init, *verifier_pools(),
                            device=dev, verbose=False, **VTRAIN_KW)
        finally:
            setattr(V, attr, sound)
        out[key] = max(float((state[k] - ref[k]).abs().max()) for k in ref)
    return out


def verifier_arm_run(wt, dev):
    """Phase 7b: BASELINE.md round 4's verifier arm on ``dev`` (dropout
    on): config 4's detector trained to VARM_STAGES stages, the verifier
    trained on its final pool's false and true positives, the AUC of the
    cascade (``evaluate_model``) and of ``detect_and_verify`` over
    VARM_EVAL held-out images.  Requires the verified AUC at least the
    cascade's less VARM_AUC_SLACK.  Returns ``(auc_cascade, auc_verified,
    verifier steps a second, stages)``."""
    from itertools import islice

    import torch
    from waldboost_tpu_torch.testing import Evaluator, evaluate_model
    from waldboost_tpu_torch.utils import fake_data_generator
    model = wt.Model(TRAIN_SHAPE, TRAIN_OPTS, device=dev)
    pool = wt.SamplePool(min_tp=TRAIN_POOL, min_fp=TRAIN_POOL, seed=0)
    wt.train(model, fake_data_generator(seed=TRAIN_SEED), pool=pool,
             length=VARM_STAGES,
             learner=wt.Learner(alpha=TRAIN_ALPHA, max_depth=TRAIN_DEPTH))
    X0, H0 = pool.get_false_positives()
    X1, H1 = pool.get_true_positives()
    module, params = wt.verification.init_verifier(model.shape, seed=0)
    t = time.perf_counter()
    params = wt.verification.train(module, params, X0, H0, X1, H1,
                                   epochs=VARM_EPOCHS, steps=VARM_STEPS,
                                   batch_size=64, verbose=False, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    steps_s = VARM_EPOCHS * VARM_STEPS / (time.perf_counter() - t)
    corpus = list(islice(fake_data_generator(seed=VARM_EVAL_SEED), VARM_EVAL))
    auc_cascade = evaluate_model(corpus, model).evaluate()["auc"]
    ev = Evaluator()
    for i, d in enumerate(corpus, 1):
        ev.add_ground_truth(i, d["groundtruth_boxes"], d["image"].shape)
        ev.add_detections(i, wt.verification.detect_and_verify(
            d["image"], model, module, params))
    auc_verified = ev.evaluate()["auc"]
    require(auc_verified >= auc_cascade - VARM_AUC_SLACK,
            f"phase 7b: the verifier degrades the AUC ({auc_verified} "
            f"against the cascade's {auc_cascade})")
    return auc_cascade, auc_verified, steps_s, len(model)


def cli_output(fn, argv) -> str:
    """What a CLI entry ``fn`` prints on ``argv``."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(list(argv))
    return out.getvalue()


def check_cli_model(wt, path, model_bytes, what):
    """The model file at ``path`` equal to JAX's ``model_bytes``: stage
    count, tree structure, features and thresholds bitwise, predictions
    and thetas within 1e-5 (numpy's and XLA's ``log`` round differently;
    the thetas follow the predictions)."""
    ref_path = path + ".jax.pb"
    with open(ref_path, "wb") as f:
        f.write(np.asarray(model_bytes, np.uint8).tobytes())
    got, ref = (wt.load(p, device="cpu") for p in (path, ref_path))
    require(len(got) == len(ref), f"{what}: {len(got)} stages, JAX "
            f"{len(ref)}")
    for s_, (a, b) in enumerate(zip(got.stages, ref.stages)):
        for k in ("feature", "left", "right", "threshold"):
            require(np.array_equal(a[k], b[k]),
                    f"{what}: stage {s_}'s {k} differs from JAX's")
        require(np.abs(a["prediction"] - b["prediction"]).max() <= 1e-5,
                f"{what}: stage {s_}'s predictions differ from JAX's")
    require(np.abs(np.subtract(got.theta, ref.theta)).max(initial=0) <= 1e-5,
            f"{what}: thetas {got.theta} against JAX's {ref.theta}")


def check_cli_stats(out, want, what):
    """The JSON line a training run printed equal to JAX's (the model
    path aside), the loss within 1e-6 (numpy's float32 ``exp`` differs
    by an ULP between hosts)."""
    got = json.loads(out.strip().splitlines()[-1])
    want = json.loads(str(want))
    loss, ref_loss = got.pop("loss"), want.pop("loss")
    got.pop("model")
    want.pop("model")
    require(got == want and abs(loss - ref_loss) <= 1e-6,
            f"{what}: JSON {got} (loss {loss}) against JAX's {want} (loss "
            f"{ref_loss})")
    return got["stages"]


def write_bbgt_dataset(root, n_images=CLI_BBGT_IMAGES, seed=4):
    """A bbGt-style dataset under ``root``: P5 PGM images and 12-field v3
    annotations of ``fake_data_generator(seed)``; ``(image dir,
    annotation dir)``."""
    from waldboost_tpu_torch.utils import fake_data_generator
    img_dir, ann_dir = os.path.join(root, "img"), os.path.join(root, "ann")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    gen = fake_data_generator(seed=seed)
    for i in range(n_images):
        d = next(gen)
        img = d["image"]
        with open(os.path.join(img_dir, f"im{i:03d}.pgm"), "wb") as f:
            f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
            f.write(img.tobytes())
        lines = ["% bbGt version=3"]
        for x0, y0, x1, y1 in d["groundtruth_boxes"].get():
            lines.append(f"obj {x0:.0f} {y0:.0f} {x1 - x0:.0f} "
                         f"{y1 - y0:.0f} 0 0 0 0 0 0 0")
        with open(os.path.join(ann_dir, f"im{i:03d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return img_dir, ann_dir


def cli_train_golden_run(wt, dev, g, tmp, key):
    """One of phase 7c's runs on ``dev``: ``train_main`` at
    CLI_TRAIN_RUNS[key], its model and JSON line held to the golden's
    (:func:`check_cli_model`, :func:`check_cli_stats`).  Returns its
    stages a minute (host clock)."""
    from waldboost_tpu_torch import cli
    path = os.path.join(tmp, f"cli_{key}.pb")
    argv = CLI_TRAIN_RUNS[key]
    t = time.perf_counter()
    out = cli_output(cli.train_main, ("-o", path) + argv
                     + ("--device", str(dev)))
    rate = 60 * int(argv[argv.index("--length") + 1]) / (
        time.perf_counter() - t)
    check_cli_stats(out, g[key + "_json"], f"CLI train {key}")
    check_cli_model(wt, path, g[key + "_model"], f"CLI train {key}")
    return rate


def cli_bbgt_run(wt, dev, tmp):
    """Phase 7c's bbGt run: ``train_main --images/--annotations`` on a
    :func:`write_bbgt_dataset` directory through the native loader (the
    loader's threads finish out of order, so this holds the contract:
    the stage count, and the saved model loads)."""
    from waldboost_tpu_torch import cli
    from waldboost_tpu_torch.io import native_available
    require(native_available(), "the native loader did not build")
    img_dir, ann_dir = write_bbgt_dataset(os.path.join(tmp, "bbgt"))
    path = os.path.join(tmp, "cli_bbgt.pb")
    out = cli_output(cli.train_main, ("-o", path) + CLI_BBGT_ARGS + (
        "--images", img_dir, "--annotations", ann_dir, "--device", str(dev)))
    stages = json.loads(out.strip().splitlines()[-1])["stages"]
    require(stages == int(CLI_BBGT_ARGS[1]) and len(wt.load(
        path, device=dev)) == stages, f"CLI bbGt training: {stages} stages")
    return stages


def cli_json(text):
    """A detect_main JSON with each file name cut to its base name."""
    res = json.loads(text)
    for r in res:
        r["filename"] = os.path.basename(r["filename"])
    return res


def cli_rows(res):
    """Each file's (box, score, label) rows of a detect_main result, as a
    set: the list order of several models' boxes is JAX's two-phase
    compaction's (ROADMAP A13, not ported)."""
    return [(r["filename"], sorted(zip(map(tuple, r["boxes"]), r["scores"],
                                       r["labels"] or [0] * len(r["boxes"]))))
            for r in res]


def write_cli_frames(tmp, n=CLI_FRAMES):
    """``n`` VGA scenes (:func:`scene_batch`) saved as ``.npy`` files."""
    paths = []
    for i, frame in enumerate(scene_batch(n).numpy()):
        paths.append(os.path.join(tmp, f"scene{i}.npy"))
        np.save(paths[-1], frame)
    return paths


def cli_detect_args(n_models, paths, dev=None):
    """detect_main's arguments: CLI_DETECT_MODELS' first ``n_models``,
    the files, and ``--device dev`` unless ``dev`` is None."""
    args = []
    for name in CLI_DETECT_MODELS[:n_models]:
        args += ["-m", os.path.join(ROOT, "models", name + ".pb")]
    args += list(paths)
    return args if dev is None else args + ["--device", str(dev)]


def cli_detect_golden_run(dev, g, paths, n_models):
    """Phase 7d on ``dev``: ``detect_main`` over ``paths``
    (:func:`write_cli_frames`) with CLI_DETECT_MODELS' first
    ``n_models``: with one (BucketedDetector) its JSON equal to the
    golden's; with two (``wt.detect``) each file's rows equal to the
    golden's as sets (:func:`cli_rows`).  Returns the result."""
    from waldboost_tpu_torch import cli
    got = cli_json(cli_output(cli.detect_main,
                              cli_detect_args(n_models, paths, dev)))
    want = cli_json(str(g[f"detect_json_{n_models}"]))
    if n_models == 1:
        require(got == want, "CLI detect: the JSON differs from JAX's")
    else:
        require(cli_rows(got) == cli_rows(want), f"CLI detect with "
                f"{n_models} models: boxes differ from JAX's")
    return got


def n_scales_frames():
    """7e's frames: (name, (BATCH, 480, 640) uint8) for a seeded noise
    batch, the scene batch and a seeded batch of coarse noise (uniform
    N_SCALES_GRAIN x N_SCALES_GRAIN blocks)."""
    noise = np.random.RandomState(N_SCALES_NOISE_SEED).randint(
        0, 256, (BATCH,) + VGA).astype(np.uint8)
    f = N_SCALES_GRAIN
    coarse = np.random.RandomState(N_SCALES_COARSE_SEED).randint(
        0, 256, (BATCH, -(-VGA[0] // f), -(-VGA[1] // f))).astype(np.uint8)
    coarse = coarse.repeat(f, 1).repeat(f, 2)[:, :VGA[0], :VGA[1]]
    return (("noise", noise), ("scenes", scene_batch(BATCH).numpy()),
            ("coarse", np.ascontiguousarray(coarse)))


def n_scales_key(name, n_scales, with_n_weak, frames):
    """The golden's key prefix of one N_SCALES_RUNS entry and batch."""
    return f"ns/{name}/{n_scales}/{'n_weak' if with_n_weak else 'plain'}/" \
        f"{frames}"


def n_scales_golden_run(wt, dev, g):
    """Phase 7e's checks on ``dev``: each N_SCALES_RUNS detector on each
    :func:`n_scales_frames` batch, its packed plan of ``n_scales``
    levels, counts and n_weak equal to the golden's and every frame's
    valid boxes and scores bitwise (as sorted rows); on the coarse batch
    each run must keep windows.  Returns the detectors and their survivor
    counts."""
    import torch
    dets, counts = {}, {}
    frames = n_scales_frames()
    for name, ns, k, with_n_weak in N_SCALES_RUNS:
        model = wt.load(os.path.join(ROOT, "models", name + ".pb"),
                        device=dev)
        fn, packed = wt.make_batched_detector_boxes(
            model, VGA, k=k, with_n_weak=with_n_weak, n_scales=ns,
            device=dev)
        require(len(packed.levels) == ns, f"{name} n_scales={ns}: "
                f"{len(packed.levels)} levels")
        dets[(name, ns, with_n_weak)] = fn
        for fname, batch in frames:
            key = n_scales_key(name, ns, with_n_weak, fname)
            rects, scores, valid, count, n_weak = (
                a.cpu().numpy() for a in fn(torch.from_numpy(batch).to(dev)))
            require(np.array_equal(count, g[key + "/count"])
                    and np.array_equal(n_weak, g[key + "/n_weak"]),
                    f"{key}: counts {count.tolist()} / n_weak "
                    f"{n_weak.tolist()} against JAX's "
                    f"{g[key + '/count'].tolist()} / "
                    f"{g[key + '/n_weak'].tolist()}")
            want = np.split(g[key + "/rows"],
                            np.cumsum(g[key + "/kept"])[:-1])
            for b in range(len(batch)):
                require(np.array_equal(
                    sorted_rows(rects[b][valid[b]], scores[b][valid[b]]),
                    sorted_rows(want[b][:, :4], want[b][:, 4])),
                    f"{key} frame {b}: boxes or scores differ from JAX's")
            require(fname != "coarse" or valid.any(),
                    f"{key}: no window kept, so no box is compared")
            counts[key] = count.tolist()
    return dets, counts


#: phases 8a-8f: the tests' two-process golden (JAX's tests/mp_worker.py
#: program over 8 devices, scripts/make_torch_mesh_golden.py), the frames
#: a shard takes in 8a and 8b, and each launch counter's kernel function
#: as a profiler trace names it (where a counter has its own function)
TWOPHASE_GOLDEN = os.path.join(ROOT, "tests", "data",
                               "torch_port_twophase_golden.npz")


def twophase_golden_run(wt, dev, g, model, runs=None):
    """The runs of tests/data/torch_port_twophase_golden.npz
    (scripts/make_torch_twophase_golden.py; all, or those named in
    ``runs``) on ``dev``: ``{run: list of the outputs that differ from the
    golden}`` (every output whole, slot order included; tolerance 0) and
    ``{run: the five outputs}``."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from make_torch_twophase_golden import (OUTPUTS, RUNS, frames_digest,
                                            golden_frames)
    frames = golden_frames()
    require(frames_digest(frames) == str(g["frames_sha256"]),
            "the two-phase golden's frames differ from its digest")
    images = torch.from_numpy(frames).to(dev)
    diffs, outs = {}, {}
    for name, kw in RUNS.items():
        if runs is not None and name not in runs:
            continue
        fn, _ = wt.make_batched_detector_boxes(model, frames.shape[1:],
                                               device=dev, **kw)
        res = [a.cpu().numpy() for a in fn(images)]
        outs[name] = res
        diffs[name] = [o for o, a in zip(OUTPUTS, res)
                       if not (a.shape == g[f"{name}_{o}"].shape
                               and np.array_equal(a, g[f"{name}_{o}"]))]
    return diffs, outs


MESH_GOLDEN = os.path.join(ROOT, "tests", "data",
                           "torch_port_mesh_golden.npz")
MESH_SHARD_BATCH = 8
TRACE_KERNELS = {"planes": "planes_kernel", "grad_hist": "grad_hist_kernel",
                 "cascade": "cascade_kernel", "fpga": "fpga_kernel",
                 "grad_hist_fast": "grad_hist_float_kernel",
                 "cascade_fast": "cascade_fast_kernel",
                 "cascade_response": "cascade_kernel",
                 "cascade_suffix": "suffix_kernel",
                 "compact": "topk_kernel", "nms": "nms_kernel",
                 "octaves": "octaves_kernel"}
#: the two-process run's own time limit (each rank)
MP_TIMEOUT_S = 300


def sync_all():
    """Wait for every visible card."""
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def card_meshes(dev):
    """``[(label, mesh)]`` of phases 8a-8f: ``dev`` repeated four times
    (on any card machine), then the real cards' meshes of 2 and of
    ``min(4, count)`` cards where two or more are visible."""
    import torch
    from waldboost_tpu_torch.parallel.mesh import make_mesh
    meshes = [("4 shards on one card", make_mesh(devices=[dev] * 4))]
    n = torch.cuda.device_count()
    for k in sorted({2, min(4, n)} if n >= 2 else ()):
        meshes.append((f"{k} cards", make_mesh(n_devices=k)))
    if n < 2:
        print(f"phases 8a-8f: one card visible ({n}): the runs on a mesh of "
              f"real cards and NCCL need two or more")
    return meshes


def kernel_devices(fn):
    """``(fn(), {kernel function name: device indices})``: ``fn`` run once
    under torch.profiler, every card waited for, and the devices each
    kernel of its trace ran on."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync_all()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    seen = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            seen.setdefault(e["name"], set()).add(
                int(e.get("args", {}).get("device", -1)))
    return out, seen


def require_on_devices(seen, kernels, mesh, what):
    """Each of ``kernels`` (launch-counter names) ran on every card of
    ``mesh`` in the trace ``seen`` (:func:`kernel_devices`)."""
    want = {d.index for d in mesh.local_devices}
    for k in kernels:
        got = set().union(*(v for name, v in seen.items()
                            if TRACE_KERNELS[k] in name))
        require(want <= got, f"{what}: {k} ran on devices {sorted(got)}, "
                f"the mesh's are {sorted(want)}")


def mesh_launches(zero, read, fn, kernels, n, what):
    """``fn()`` with the launch counters set to 0 first; each of
    ``kernels`` launched ``n`` times, once a shard (``kernels`` a dict:
    that many times a shard).  Returns the output and the counts."""
    zero()
    out = fn()
    sync_all()
    got = read()
    per = kernels if isinstance(kernels, dict) else dict.fromkeys(kernels, 1)
    require(all(got[k] == c * n for k, c in per.items()),
            f"{what}: launches {got}, {n} shards of {per} expected")
    return out, got


def mesh_blocks_equal(outs, want, mesh, dev, what):
    """Each output gathered on ``dev`` is ``want``'s (one shard's batch)
    repeated shard by shard, bitwise."""
    from waldboost_tpu_torch.parallel.mesh import gather
    for i, (o, w) in enumerate(zip(outs, want)):
        g = gather(o, mesh, dev)
        b = w.shape[0]
        require(all(bool(g[s * b:(s + 1) * b].eq(w).all())
                    for s in range(mesh.size)),
                f"{what}: output {i} differs from the unsharded path")


def mesh_serving_run(wt, dev, mesh, label, synth, scene_np, golden, fastg,
                     zero, read):
    """Phases 8a and 8b on ``mesh``: the VGA detector (k 128 and 1024, NMS
    0.5) and the fast one (the fast golden's k and NMS, no n_weak) over
    ``MESH_SHARD_BATCH`` frames a shard (the golden scenes and their
    flips), every output bitwise the unsharded detector's on one shard's
    frames, the first three frames the goldens', each kernel launched
    once a shard, on the shard's card.  Returns the launches of 8a and
    8b."""
    import torch
    from waldboost_tpu_torch.parallel.mesh import shard_array
    n = mesh.size
    scene = torch.from_numpy(scene_np).to(dev)
    shards = shard_array(np.concatenate([scene_np] * n), mesh)
    launches = {}
    runs = (("8a", 128, None, False), ("8a", 1024, None, False),
            ("8b", int(fastg["k"]), float(fastg["nms_iou"]), True))
    for phase, k, iou, fast in runs:
        kw = dict(k=k, nms_iou=0.5 if iou is None else iou, fast=fast,
                  with_n_weak=not fast)
        fs, _ = wt.make_batched_detector_boxes(synth, VGA, mesh=mesh, **kw)
        fu, _ = wt.make_batched_detector_boxes(synth, VGA, device=dev, **kw)
        kernels = ("octaves", "planes", "grad_hist_fast", "cascade_fast",
                   "nms") if fast else ("octaves", "planes", "grad_hist",
                                        "cascade", "nms")
        what = f"phase {phase} ({label}, k={k})"
        outs, got = mesh_launches(zero, read, lambda: fs(shards), kernels, n,
                                  what)
        require(not fast or got["grad_hist"] == got["cascade"] == 0,
                f"{what}: an exact-mode kernel was launched")
        launches[phase] = got
        want = fu(scene)
        mesh_blocks_equal(outs, want, mesh, dev, what)
        rects, scores, valid, count, _ = (a.cpu().numpy() for a in want)
        if fast:
            ref_counts = fastg["uint8_counts"]
            refs = np.split(fastg["uint8_kept"],
                            np.cumsum(fastg["uint8_kept_counts"])[:-1])
        elif k == 1024:
            ref_counts = golden["raw_counts"]
            refs = [np.concatenate([r, s[:, None]], 1) for r, s in zip(
                np.split(golden["kept_rects"],
                         np.cumsum(golden["kept_counts"])[:-1]),
                np.split(golden["kept_scores"],
                         np.cumsum(golden["kept_counts"])[:-1]))]
        else:
            continue
        require(np.array_equal(count[:len(ref_counts)], ref_counts)
                and all(np.array_equal(sorted_rows(rects[b][valid[b]],
                                                   scores[b][valid[b]]),
                                       sorted_rows(ref))
                        for b, ref in enumerate(refs)),
                f"{what}: the golden frames' boxes differ from JAX's")
        if any(d.index != dev.index for d in mesh.local_devices):
            _, seen = kernel_devices(lambda: fs(shards))
            require_on_devices(seen, kernels, mesh, what)
    print(f"phases 8a, 8b ({label}): {n} shards of {MESH_SHARD_BATCH} VGA "
          f"frames, k 128 and 1024 and fast mode, bitwise the unsharded "
          f"path and the goldens; launches 8a {launches['8a']}, 8b "
          f"{launches['8b']}")
    return launches


def mesh_rate(wt, dev, mesh, synth, reps=10):
    """Sharded VGA MP/s (k=128, NMS 0.5) over ``MESH_SHARD_BATCH`` noise
    frames a shard, the shards already on their cards; every card is
    waited for at the end of each batch."""
    from waldboost_tpu_torch.parallel.mesh import shard_array
    rng = np.random.RandomState(21)
    frames = rng.randint(0, 256, (MESH_SHARD_BATCH * mesh.size,) + VGA
                         ).astype(np.uint8)
    shards = shard_array(frames, mesh)
    fs, _ = wt.make_batched_detector_boxes(synth, VGA, k=128, nms_iou=0.5,
                                           mesh=mesh)
    for _ in range(2):
        fs(shards)
    sync_all()
    t = time.perf_counter()
    for _ in range(reps):
        fs(shards)
        sync_all()
    dt = (time.perf_counter() - t) / reps
    return frames.size / 1e6 / dt, dt * 1e3


def tile_run(wt, dev, mesh, label, g5, models5, zero, read, reps=10):
    """Phase 8c on ``mesh``: each config-5 golden frame (3840 x 2160) of
    fpga_4k_synth_64 in ``mesh.size`` bands: hs, alive and n_weak bitwise
    the unsharded B4 path's; with boxes the full cascade's and its
    prefix's counts and n_weak, and the prefix's kept boxes, the
    golden's; B1 and B5 launched once a frame, B4 once a band.  Returns
    the launches and ms a frame of the tile-sharded and the unsharded
    response."""
    import torch
    from waldboost_tpu_torch.parallel.detect import \
        make_tile_sharded_detector
    name = FPGA_MODELS[0]
    model = models5[name]
    hw, frames = fpga_frames(g5)
    k, iou = int(g5["k"]), float(g5["nms_iou"])
    P = int(g5[name + "_prefix_stages"])
    prefix = wt.model_from_stages(model.shape, model.channel_opts,
                                  model.stages[:P], model.theta[:P],
                                  device=dev)
    ft, _ = make_tile_sharded_detector(model, hw, mesh)
    fu, _ = wt.make_batched_detector(model, hw, device=dev)
    boxed = {"full": make_tile_sharded_detector(model, hw, mesh, boxes=True,
                                                k=k, nms_iou=iou)[0],
             "prefix": make_tile_sharded_detector(prefix, hw, mesh,
                                                  boxes=True, k=k,
                                                  nms_iou=iou)[0]}
    what = f"phase 8c ({label})"
    images = [torch.from_numpy(f).to(dev) for f in frames]
    launches = None
    for b, img in enumerate(images):
        (hs, alive, nw), got = mesh_launches(
            zero, read, lambda: ft(img), ("cascade_response",), mesh.size,
            what)
        require(got["planes"] == got["fpga"] == 1,
                f"{what}: the canvas took {got}")
        launches = launches or got
        hu, au, nu = fu(img[None])
        require(torch.equal(hs, hu[0]) and torch.equal(alive, au[0])
                and int(nw) == int(nu[0]),
                f"{what} frame {b}: the bands differ from the unsharded B4")
        for key, fb in boxed.items():
            rects, scores, valid, count, bnw = (
                a.cpu().numpy() for a in fb(img))
            require(int(count) == int(g5[f"{name}_{key}_count"][b])
                    and int(bnw) == int(g5[f"{name}_{key}_n_weak"][b]),
                    f"{what} frame {b}: the {key} cascade's count or n_weak "
                    f"differs from the golden's")
            if key == "prefix":
                ref = golden_split(g5, name + "_prefix_kept_host")[b]
                require(np.array_equal(sorted_rows(rects[valid],
                                                   scores[valid]),
                                       sorted_rows(ref)),
                        f"{what} frame {b}: the prefix's kept boxes differ "
                        f"from the golden's")
    if any(d.index != dev.index for d in mesh.local_devices):
        _, seen = kernel_devices(lambda: ft(images[0]))
        require_on_devices(seen, ("cascade",), mesh, what)
    times = {}
    for key, fn in (("tile", lambda: ft(images[0])),
                    ("unsharded", lambda: fu(images[0][None]))):
        fn()
        sync_all()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
            sync_all()
        times[key] = (time.perf_counter() - t) / reps * 1e3
    print(f"phase 8c ({label}): {len(images)} 4K frames in {mesh.size} "
          f"bands bitwise the unsharded B4 and the golden's boxes; "
          f"launches {launches}")
    return launches, times


def bucket_verifier_run(wt, dev, mesh, label, synth, bgold, cgold, scenes,
                        zero, read):
    """Phase 8d on ``mesh``: BucketedDetector over the bucket golden's four
    sizes (each group padded to the mesh with blank frames) equal to the
    golden's kept boxes; detect_and_verify over the golden scenes: boxes
    and cascade scores bitwise the canvas golden's, verified scores
    within VERIFIER_TOL of their scale.  Returns the bucket's launches and
    the largest verified-score error."""
    from waldboost_tpu_torch.parallel.detect import BucketedDetector
    bframes = [bgold[f"frame_{h}x{w}"] for h, w in BUCKET_SIZES]
    bdet = BucketedDetector(synth, bucket=int(bgold["bucket"]),
                            k=int(bgold["k"]), nms_iou=float(bgold["nms_iou"]),
                            mesh=mesh)
    zero()
    out = bdet.detect_many(bframes)
    sync_all()
    launches = read()
    what = f"phase 8d ({label})"
    require(all(launches[k] >= mesh.size
                for k in ("planes", "grad_hist", "cascade")),
            f"{what}: the bucket's launches {launches}")
    for (h, w), bx in zip(BUCKET_SIZES, out):
        want = bgold[f"kept_{h}x{w}"]
        require(np.array_equal(box_rows(bx, "scores"),
                               sorted_rows(want[:, :4], want[:, 4])),
                f"{what} {h}x{w}: kept boxes differ from the JAX golden")
    module, state = golden_verifier(wt, cgold)
    worst = 0.0
    for i, scene in enumerate(scenes):
        dv = wt.verification.detect_and_verify(scene, synth, module, state,
                                               mesh=mesh)
        rects, scores, casc = golden_rows(cgold, "ver", i, "rects", "scores",
                                          "cascade_scores")
        require(np.array_equal(dv.get(), rects) and np.array_equal(
            dv.get_field("cascade_scores"), casc),
            f"{what} frame {i}: verified boxes or cascade scores differ")
        err, tol = verifier_close(dv.get_field("scores"), scores)
        require(err <= tol, f"{what} frame {i}: verified scores {err} from "
                f"the golden (tolerance {tol})")
        worst = max(worst, err)
    print(f"phase 8d ({label}): bucket golden equal at {len(out)} sizes, "
          f"launches {launches}; detect_and_verify on {len(scenes)} scenes "
          f"within {worst:.3g} of JAX's")
    return launches, worst


def mesh_train_run(wt, dev, mesh, label, zero, read):
    """Phase 8e on ``mesh``: config 4b's ``train_sharded`` (2048 slots a
    class, 6 stages) and ``fpga.train`` (2 stages) teacher-forced against
    their goldens, bitwise; then config 4b untouched, a warm call to 2
    stages and 6 timed.  Returns the launches and the stages/min."""
    from waldboost_tpu_torch.io import prefetch_iterable
    from waldboost_tpu_torch.parallel.trainer import train_sharded
    from waldboost_tpu_torch.utils import fake_data_generator
    what = f"phase 8e ({label})"
    zero()
    model, _ = device_train_golden_run(wt, dev, np.load(DEVICE_TRAIN_GOLDEN),
                                       mesh=mesh)
    sync_all()
    launches = read()
    require(all(launches[k] > 0 for k in ("planes", "grad_hist",
                                          "cascade_generic")),
            f"{what}: config 4b's mining did not run B1, B2 and B6")
    zero()
    fmodel, _ = device_train_golden_run(
        wt, dev, np.load(DEVICE_FPGA_TRAIN_GOLDEN), fpga=True, mesh=mesh)
    sync_all()
    flaunch = read()
    require(all(flaunch[k] > 0 for k in ("planes", "fpga",
                                         "cascade_generic")),
            f"{what}: fpga.train's mining did not run B1, B5 and B6")
    model = wt.Model(TRAIN_SHAPE, TRAIN_OPTS, device=dev)
    gen = prefetch_iterable(fake_data_generator(seed=TRAIN_SEED),
                            depth=DEVICE_TRAIN_PREFETCH)
    learner, pools = wt.Learner(alpha=TRAIN_ALPHA, max_depth=TRAIN_DEPTH), {}
    kw = dict(learner=learner, min_tp=TRAIN_POOL, min_fp=TRAIN_POOL,
              seed=DEVICE_TRAIN_SEED, pools=pools, mesh=mesh)
    train_sharded(model, gen, length=DEVICE_TRAIN_WARM, **kw)
    sync_all()
    t = time.perf_counter()
    train_sharded(model, gen, length=DEVICE_TRAIN_WARM + 6, **kw)
    sync_all()
    rate = 6 / (time.perf_counter() - t) * 60.0
    require(len(pools["fp"].x) == mesh.n_local,
            f"{what}: the pools are not sharded over the mesh")
    print(f"phase 8e ({label}): config 4b 6 stages and fpga.train 2 stages "
          f"equal to JAX's; launches {launches}, FPGA {flaunch}")
    return launches, flaunch, rate


def mesh_golden_diff(got, g):
    """None when the program's teacher-forced outputs ``got`` are the
    mesh golden's (tests/torch_mp_worker.py: stages bitwise, thetas as
    float32, losses within 1e-6, counts and kept boxes bitwise; on the
    scene frames the host NMS of the golden's candidates), else what
    differs.  The port's host NMS is the JAX package's, copied."""
    import waldboost_tpu_torch as wt
    for t in range(len(g["theta"])):
        for k in ("feature", "threshold", "left", "right", "prediction"):
            if not np.array_equal(got[f"{k}{t}"], g[f"{k}{t}"]):
                return f"stage {t} {k}"
    if not np.array_equal(got["theta"].astype(np.float32),
                          g["theta"].astype(np.float32)):
        return "theta"
    if not np.allclose(got["losses"], g["losses"], rtol=1e-6, atol=0):
        return "losses"
    for prefix in ("", "scene_"):
        if not np.array_equal(got[prefix + "count"], g[prefix + "count"]):
            return prefix + "count"
        r, s, v = (got[prefix + k] for k in ("rects", "scores", "valid"))
        gr, gs, gv = (g[prefix + k] for k in ("rects", "scores", "valid"))
        for b in range(len(v)):
            want = sorted_rows(gr[b][gv[b]], gs[b][gv[b]])
            if prefix:
                kept = wt.bbx.non_max_suppression(
                    wt.Boxes(gr[b][gv[b]], scores=gs[b][gv[b]]),
                    iou_threshold=0.5)
                want = box_rows(kept, "scores")
            if not np.array_equal(sorted_rows(r[b][v[b]], s[b][v[b]]),
                                  want):
                return f"{prefix}frame {b}"
    return None


def two_process_run(dev, tmp):
    """Phase 8f: tests/torch_mp_worker.py as two ranks (NCCL, one card a
    rank, with two or more cards; else gloo, both on ``dev``), 4 shards a
    rank, free and teacher-forced with the mesh golden; the same program
    in this process over 8 shards of ``dev``.  Free: the two layouts
    bitwise (losses within 1e-6); forced: both the golden's.  Returns the
    two-process wall time (s) and the backend."""
    import socket

    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_mp_worker import run_program
    from waldboost_tpu_torch.parallel.mesh import make_mesh
    nccl = torch.cuda.device_count() >= 2
    backend, device = ("nccl", "cuda") if nccl else ("gloo", str(dev))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = os.path.join(tmp, "mp.npz")
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mp_worker.py"),
         "--rank", str(r), "--world", "2", "--backend", backend,
         "--init", f"tcp://localhost:{port}", "--device", device,
         "--local-devices", "4", "--golden", MESH_GOLDEN, "--out", out],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0, f"phase 8f: rank {r} exited "
                f"{p.returncode}:\n{log[-3000:]}")
    sp = os.path.join(tmp, "sp.npz")
    mesh = make_mesh(devices=[dev] * 8)
    g = np.load(MESH_GOLDEN)
    run_program(mesh, sp)
    run_program(mesh, sp + ".forced.npz", forced=g)
    mp, one = np.load(out), np.load(sp)
    require(set(mp.files) == set(one.files)
            and np.allclose(mp["losses"], one["losses"], rtol=1e-6, atol=0)
            and all(np.array_equal(mp[f], one[f]) for f in mp.files
                    if f != "losses"),
            "phase 8f: two processes differ from one process on 8 shards")
    for name, path in (("two processes", out), ("one process", sp)):
        diff = mesh_golden_diff(np.load(path + ".forced.npz"), g)
        require(diff is None, f"phase 8f: {name}, teacher-forced, differ "
                f"from the mesh golden ({diff})")
    print(f"phase 8f: two ranks over {backend} ({device}, 4 shards each) "
          f"bitwise one process on 8 shards; both teacher-forced equal to "
          f"the golden; scene survivors {one['scene_count'].tolist()}")
    return wall, backend


def mesh_phases(wt, dev, card, metric, zero, read, synth, scene_np, golden,
                fastg):
    """Phases 8a-8f on every mesh of :func:`card_meshes`; prints the rates
    beside ``card``.  Returns the launches of each kernel per mesh path
    (on the repeated-card mesh)."""
    from waldboost_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    meshes = card_meshes(dev)
    models5 = {name: wt.load(os.path.join(ROOT, "models", name + ".pb"),
                             device=dev) for name in FPGA_MODELS[:1]}
    g5, bgold, cgold = (np.load(p) for p in (FPGA_GOLDEN, BUCKET_GOLDEN,
                                            CANVAS_GOLDEN))
    scenes = canvas_golden_frames(cgold)[:int(cgold["n_scenes"])]
    per_path = {}
    for label, mesh in meshes:
        sv = mesh_serving_run(wt, dev, mesh, label, synth, scene_np, golden,
                              fastg, zero, read)
        tl, tms = tile_run(wt, dev, mesh, label, g5, models5, zero, read)
        bl, _ = bucket_verifier_run(wt, dev, mesh, label, synth, bgold,
                                    cgold, scenes, zero, read)
        trl, ftl, rate = mesh_train_run(wt, dev, mesh, label, zero, read)
        tag = label.replace(" ", "_")
        metric(f"tile_sharded_4k_{tag}_ms_per_frame", tms["tile"], "ms")
        metric(f"unsharded_4k_b4_ms_per_frame", tms["unsharded"], "ms")
        metric(f"train_config4b_{tag}_stages_per_min", rate, "stages/min")
        print(f"phase 8c ({label}, {card}): tile-sharded 4K "
              f"{tms['tile']:.4f} ms a frame, the unsharded B4 path "
              f"{tms['unsharded']:.4f} ms; phase 8e: config 4b {rate:.1f} "
              f"stages/min on the mesh")
        if not per_path:
            per_path = {"8a": sv["8a"], "8b": sv["8b"], "8c": tl, "8d": bl,
                        "8e": trl, "8e_fpga": ftl}
    rate_meshes = [("1 shard", make_mesh(devices=[dev]))] + meshes
    for label, mesh in rate_meshes:
        mps, ms = mesh_rate(wt, dev, mesh, synth)
        kind = ("overhead, not scaling: every shard on one card"
                if len({d.index for d in mesh.devices}) == 1
                and mesh.size > 1 else "scaling")
        metric(f"sharded_vga_{label.replace(' ', '_')}_mp_per_s", mps, "MP/s")
        print(f"phase 8a rate ({label}, {card}): {mps:.1f} MP/s, "
              f"{ms:.4f} ms a batch of {MESH_SHARD_BATCH * mesh.size} "
              f"frames ({kind})")
    with tempfile.TemporaryDirectory() as tmp:
        wall, backend = two_process_run(dev, tmp)
    metric(f"two_process_{backend}_wall_s", wall, "s")
    print(f"phase 8f ({card}): two-process run {wall:.1f} s wall over "
          f"{backend}")
    print(f"phases 8a-8f: {time.perf_counter() - t0:.1f} s")
    return per_path


#: phase 9: S1 and S2, and the two-phase path's kernels with their
#: launches a batch (S2 compacts the prefix and takes the final top k)
TP_KERNELS = ("cascade_suffix", "compact")
TP_PATH = ("planes", "grad_hist", "cascade_response") + TP_KERNELS
TP_LAUNCHES = (("planes", 1), ("grad_hist", 1), ("cascade_response", 1),
               ("cascade_suffix", 1), ("compact", 2))
#: phase 9's overflowing two-phase setting
TP_OVER = dict(prefix=2, capacity=512)


class TpInputs:
    """What a two-phase detector's ``finish`` gives S2 and S1 for a batch:
    the canvas, B4's (B, GU * GV) prefix scores and alive flags (S2's
    masked form of them for the library's sort), the survivor counts and
    the compacted (B, cap) lists; :meth:`calls` are S2's and S1's calls
    and their plain versions on them."""

    def __init__(self, det, images):
        import torch
        from waldboost_tpu_torch.ops.nms import topk_masked
        self.det = det
        self.cv, hs1, alive1, _ = det.launch(images)
        B = hs1.shape[0]
        self.hs, self.al = hs1.reshape(B, -1), alive1.reshape(B, -1)
        self.masked = torch.where(self.al, self.hs, float("-inf"))
        self.scores, self.idx, self.count = topk_masked(self.hs, det.cap,
                                                        alive=self.al)
        self.alive = torch.isfinite(self.scores)

    def calls(self):
        from waldboost_tpu_torch.ops import cascade as gen_mod
        from waldboost_tpu_torch.ops import nms as nms_mod
        d = self.det
        args = (self.cv, d.prefix_step.ops, d.window, None, self.idx,
                self.scores, self.alive, d.prefix)
        return {
            "compact": (
                lambda: nms_mod.topk_masked(self.hs, d.cap, alive=self.al),
                lambda: nms_mod.topk_masked_plain(self.hs, d.cap,
                                                  alive=self.al)),
            "cascade_suffix": (
                lambda: gen_mod.cascade_suffix_sparse(*args),
                lambda: gen_mod.cascade_suffix_sparse_plain(*args)),
        }

    def bounds(self, n_weak):
        """``{kernel: (ms, bound_by)}``: S2 reads the prefix scores and
        flags once and writes the (B, cap) scores, int64 indices and the
        counts once; S1 reads and writes the lists once (index, score,
        flag in; score, flag out), reads three canvas values for each
        stage an entry enters (this run's ``n_weak`` of the suffix) and
        the records once."""
        B, cap = self.scores.shape
        rec = self.det.prefix_step.ops.records(tuple(self.cv.shape[1:]))
        return {"compact": bound(nbytes(self.hs, self.al) + B * cap * 12
                                 + B * 4),
                "cascade_suffix": bound(B * cap * 18 + n_weak * 3
                                        * self.cv.element_size()
                                        + nbytes(rec.data))}


def timed_in_turns(call, plain, lib=None):
    """``((ms, plain ms, library ms), (events ms, events ms))`` of a
    kernel's wrapper ``call``, its plain version and the library call
    ``lib``, in turns (call, plain, library, call): device ms from the
    profiler (:func:`device_ms`), the call's also from CUDA events around
    back-to-back calls (host time included where the wrapper's is the
    longer)."""
    ev = [cuda_ms(call, 20)]
    ms = [device_ms(call)]
    plain_ms = device_ms(plain, 3)
    lib_ms = device_ms(lib, 10) if lib is not None else None
    ms.append(device_ms(call))
    ev.append(cuda_ms(call, 20))
    ms = [m for m in ms if m is not None]
    return (float(np.mean(ms)) if ms else None, plain_ms, lib_ms), ev


def timing_text(row, ev, lib_name):
    """One line of :func:`timed_in_turns`'s numbers."""
    f = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    lib = "" if row[2] is None and lib_name is None else \
        f", {lib_name} {f(row[2])}"
    return (f"{f(row[0])} on the device, {ev[0]:.4f} / {ev[1]:.4f} ms "
            f"with the wrapper (events), plain {f(row[1])}{lib}")


def batch_rate(fn, batches, reps):
    """``(MP/s, p50 ms, p80 ms)`` of ``fn`` over the batches in turn: the
    host clock around each call, each ending in a synchronize."""
    import torch
    for b in batches[:2]:
        fn(b)
    torch.cuda.synchronize()
    ms, pixels = [], 0
    for r in range(reps):
        images = batches[r % len(batches)]
        t = time.perf_counter()
        fn(images)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        pixels += images.numel()
    p50, p80 = np.percentile(ms, [50, 80])
    return pixels / sum(ms) / 1e3, float(p50), float(p80)


def twophase_mesh_run(wt, dev, mesh, label, synth, scene_np, zero, read):
    """Phase 9c on ``mesh``: the VGA two-phase detector (k=1024, NMS 0.5)
    over ``MESH_SHARD_BATCH`` scene frames a shard, bitwise the unsharded
    detector's, its kernels launched once a shard, on the shard's card."""
    from waldboost_tpu_torch.parallel.mesh import shard_array
    import torch
    n = mesh.size
    kw = dict(k=1024, nms_iou=0.5, two_phase=True)
    fs, _ = wt.make_batched_detector_boxes(synth, VGA, mesh=mesh, **kw)
    fu, _ = wt.make_batched_detector_boxes(synth, VGA, device=dev, **kw)
    shards = shard_array(np.concatenate([scene_np] * n), mesh)
    what = f"phase 9c ({label})"
    outs, got = mesh_launches(zero, read, lambda: fs(shards),
                              dict(TP_LAUNCHES, nms=1), n, what)
    mesh_blocks_equal(outs, fu(torch.from_numpy(scene_np).to(dev)), mesh,
                      dev, what)
    if any(d.index != dev.index for d in mesh.local_devices):
        _, seen = kernel_devices(lambda: fs(shards))
        require_on_devices(seen, TP_PATH + ("nms",), mesh, what)
    print(f"{what}: {n} shards of {MESH_SHARD_BATCH} VGA scenes, two-phase "
          f"bitwise the unsharded path; launches {got}")


def twophase_phases(wt, dev, card, metric, zero, read, synth, noise, scene,
                    scene_np):
    """Phases 9a-9d: two-phase and row-wise batched serving and kernels
    S1 and S2.  Returns the two-phase path's launches and, per kernel, its
    largest error against its plain version over every check, ``(ms,
    plain ms, library ms)`` and ``(bound ms, bound by)`` at VGA scenes
    (``timing[k]``, ``bounds[k]``; 4K rows printed beside them)."""
    import torch
    t0 = time.perf_counter()
    g = np.load(TWOPHASE_GOLDEN)

    # -- 9a: the golden, every output whole and bitwise; each path's
    # launches from counters set to 0 just before it
    launches = {}
    for path, runs in (("two-phase", ("tp", "tpo")), ("row-wise", ("row",))):
        zero()
        diffs, outs = twophase_golden_run(wt, dev, g, synth, runs)
        torch.cuda.synchronize()
        launches[path] = read()
        bad = {k: v for k, v in diffs.items() if v}
        require(not bad, f"phase 9a: {path} outputs differ from the golden: "
                f"{bad}")
        print(f"phase 9a: {path} {list(runs)} bitwise the golden (counts "
              f"{[outs[r][3].tolist() for r in runs]}); launches "
              f"{launches[path]}")
    tp, row = launches["two-phase"], launches["row-wise"]
    require(all(tp[k] > 0 for k in TP_PATH) and tp["cascade"] == 0
            and tp["compact"] == 2 * tp["cascade_suffix"]
            and tp["nms"] == 0,
            f"phase 9a: the two-phase path launched {tp}")
    require(all(row[k] > 0 for k in TP_PATH[:3]) and row["nms"] == 1
            and not any(row[k] for k in TP_KERNELS + ("cascade",)),
            f"phase 9a: the row-wise path launched {row}")

    # S1 and S2 against their plain versions on the card, bitwise, on the
    # inputs the two-phase path gives them
    fpga = wt.load(os.path.join(ROOT, "models", FPGA_MODELS[0] + ".pb"),
                   device=dev)
    hw4k = HW4K
    gen = torch.Generator(device=dev).manual_seed(9)
    noise4k = [torch.randint(0, 256, (BATCH,) + hw4k, generator=gen,
                             dtype=torch.uint8, device=dev)
               for _ in range(2)]
    build = lambda m, hw, **kw: wt.make_batched_detector_boxes(
        m, hw, device=dev, two_phase=True, **kw)[0]
    dets = {"vga": build(synth, VGA), "vga128": build(synth, VGA, k=128),
            "4k": build(fpga, hw4k, k=128, nms_iou=0.5)}
    cases = {
        "VGA noise": (dets["vga128"], noise[0]),
        "VGA scenes": (dets["vga"], scene),
        "VGA scenes overflow": (build(synth, VGA, **TP_OVER), scene),
        "VGA scenes bf16 canvas": (build(synth, VGA, fast=True), scene),
        "VGA scenes, deep40 (GENERAL records)": (
            build(deep_model(wt, synth, dev), VGA), scene),
        "4K noise": (dets["4k"], noise4k[0]),
        "4K noise overflow": (build(fpga, hw4k, k=128, **TP_OVER),
                              noise4k[0]),
    }
    errs = {k: 0.0 for k in TP_KERNELS}
    timed = {}
    for label, (det, images) in cases.items():
        inp = TpInputs(det, images)
        calls = inp.calls()
        for kname, (call, plain) in calls.items():
            got, want = call(), plain()
            bad = sum(int((a != b).sum()) for a, b in zip(got, want))
            errs[kname] = max([errs[kname]] + [max_abs_err(a, b) for a, b
                                               in zip(got, want)])
            print(f"phase 9a: {kname} {label}: {bad} mismatching elements "
                  f"of {sum(a.numel() for a in want)}")
            require(bad == 0, f"phase 9a: {kname} {label} differs from its "
                    f"plain version")
        suffix = calls["cascade_suffix"][0]()
        print(f"phase 9a: {label}: cap {det.cap}, prefix survivors "
              f"{inp.count.tolist()}, suffix survivors "
              f"{suffix[1].sum(dim=1).tolist()}, suffix n_weak "
              f"{suffix[2].tolist()}")
        if label in ("VGA scenes", "4K noise"):
            timed[label] = (inp, calls, int(suffix[2].sum()))
        else:
            del inp, calls, suffix

    # -- 9b: each kernel beside its plain version and the library call
    # (S2: one stable sort of the whole map), CUDA events, in turns
    timing, bounds = {}, {}
    for label, (inp, calls, n_weak) in timed.items():
        b = inp.bounds(n_weak)
        for kname, (call, plain) in calls.items():
            lib = (lambda: torch.sort(inp.masked, dim=1, descending=True,
                                      stable=True)) \
                if kname == "compact" else None
            row, ev = timed_in_turns(call, plain, lib)
            if label == "VGA scenes":
                timing[kname], bounds[kname] = row, b[kname]
            print(f"phase 9b: {kname} {label} batch {BATCH}: "
                  f"{timing_text(row, ev, lib and 'torch.sort of the map')}"
                  f", bound "
                  f"{b[kname][0]:.5f} ms ({b[kname][1]}) ({card})")
            tag = f"{kname}_{label.split()[0].lower()}"
            metric(f"{tag}_ms", row[0], "ms")
            metric(f"{tag}_events_ms", float(np.mean(ev)), "ms")
            if lib is not None:
                metric(f"{tag}_library_ms", row[2], "ms")
        del calls
    del timed

    # two-phase against dense end to end, in turns: dense, two-phase,
    # two-phase, dense
    flips = [scene, torch.flip(scene, dims=[2])]
    e2e = {
        "vga_noise_k128": (build(synth, VGA, k=128, nms_iou=0.5),
                           wt.make_batched_detector_boxes(
                               synth, VGA, k=128, nms_iou=0.5,
                               device=dev)[0], noise, 30),
        "vga_scene_k1024": (build(synth, VGA, k=1024, nms_iou=0.5),
                            wt.make_batched_detector_boxes(
                                synth, VGA, k=1024, nms_iou=0.5,
                                device=dev)[0], flips, 30),
        "fpga_4k_quantized_k128": (dets["4k"], wt.make_batched_detector_boxes(
            fpga, hw4k, k=128, nms_iou=0.5, device=dev)[0], noise4k, 10),
    }
    for workload, (two, dense, batches, reps) in e2e.items():
        res = {"dense": [], "two_phase": []}
        for which in ("dense", "two_phase", "two_phase", "dense"):
            res[which].append(batch_rate(
                two if which == "two_phase" else dense, batches, reps))
        for which, runs in res.items():
            mps = float(np.mean([r[0] for r in runs]))
            metric(f"{workload}_{which}_mp_per_s", mps, "MP/s")
            print(f"phase 9b: {workload} {which}: "
                  + "; ".join(f"{r[0]:.1f} MP/s, p50 {r[1]:.3f} ms, p80 "
                              f"{r[2]:.3f} ms" for r in runs)
                  + f" ({card})")
        for which, fn in (("dense", dense), ("two_phase", two)):
            trace_workload(f"{workload}_{which}", fn, batches,
                           3 if workload.startswith("fpga") else 10, metric)

    # -- 9d: S2 on adversarial maps, the dense extraction, no host sync
    err, dense_rows = topk_phase(wt, dev, card, metric, zero, read, synth,
                                 fpga, scene, noise4k[0])
    errs["compact"] = max(errs["compact"], err)

    del e2e, dets, cases, noise4k

    # -- 9c: two-phase over the mesh: the card repeated, real cards too
    meshes = [("4 shards on one card", wt.parallel.mesh.make_mesh(
        devices=[dev] * 4))]
    n = torch.cuda.device_count()
    meshes += [(f"{k} cards", wt.parallel.mesh.make_mesh(n_devices=k))
               for k in sorted({2, min(4, n)} if n >= 2 else ())]
    for label, mesh in meshes:
        twophase_mesh_run(wt, dev, mesh, label, synth, scene_np, zero, read)
    if n < 2:
        print(f"phase 9c: one card visible ({n}): the real-card meshes need "
              f"two or more")
    print(f"phases 9a-9d: {time.perf_counter() - t0:.1f} s")
    return launches["two-phase"], errs, timing, bounds


#: phase 9d: the kinds of map S2 is held to its plain version on
#: (:func:`topk_maps`), the k of its multi-block sort, and its k values
#: at each grid size (the last: the whole map)
TOPK_KINDS = ("ties", "all_inf", "all_finite", "around_k", "far_above",
              "signed_zeros_nonfinite")
TOPK_BIG_K = 65536
TOPK_KS = {"VGA": (1, 1024, 8192), "4K": (1, 128, 8192)}


def topk_maps(kind, batch, n, k, seed):
    """``(hs, alive)``: a seeded (batch, n) float32 score map and bool
    mask of ``kind`` for a top ``k`` (its masked form: hs where alive, -inf
    elsewhere; hs is finite where not alive, as B4 leaves it).  "ties":
    rows of 0, 1, k - 1, k, k + 1 and 3k + 7 survivors on a grid of four
    scores 0.5 apart; "all_inf": none alive; "all_finite": every entry
    alive on a 0.25 grid; "around_k": rows of k - 1, k and k + 1
    survivors; "far_above": about a third alive, scores rounded to 1/1024
    (every digit pass of the select, ties at its threshold);
    "signed_zeros_nonfinite": +0 and -0 tied, a tenth of the survivors NaN,
    +inf or -inf (ranked as -inf)."""
    rng = np.random.default_rng(seed)
    hs = rng.standard_normal((batch, n), dtype=np.float32)
    alive = np.zeros((batch, n), bool)

    def pick(b, c):
        at = rng.choice(n, int(min(max(c, 0), n)), replace=False)
        alive[b, at] = True
        return at

    if kind == "ties":
        for b in range(batch):
            at = pick(b, (0, 1, k - 1, k, k + 1, 3 * k + 7)[b % 6])
            hs[b, at] = rng.integers(0, 4, len(at)) * 0.5
    elif kind == "all_finite":
        alive[:] = True
        hs = (rng.integers(-64, 64, (batch, n)) * 0.25).astype(np.float32)
    elif kind == "around_k":
        for b in range(batch):
            pick(b, k - 1 + b % 3)
    elif kind == "far_above":
        alive = rng.random((batch, n)) < 1 / 3
        hs = np.round(hs * 1024) / np.float32(1024)
    elif kind == "signed_zeros_nonfinite":
        for b in range(batch):
            at = pick(b, (k + 1, k // 2, n // 5)[b % 3])
            hs[b, at] = np.where(rng.random(len(at)) < 0.5, 0.0, -0.0)
            odd = at[rng.random(len(at)) < 0.1]
            hs[b, odd] = rng.choice(np.array([np.nan, np.inf, -np.inf],
                                             np.float32), len(odd))
    elif kind != "all_inf":
        raise ValueError(f"unknown map kind {kind!r}")
    return hs.astype(np.float32), alive


def topk_mismatches(got, want):
    """Elements of S2's outputs that differ from the plain version's,
    scores compared by their bits (NaN and -0 included)."""
    import torch
    bad = 0
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        bad += int((a != b).sum()) if a.shape == b.shape else a.numel() + 1
    return bad


def topk_check(hs, alive, k):
    """S2 against its plain version on one map in both input forms:
    ``(mismatching elements, largest |score difference| where finite)``."""
    import torch
    from waldboost_tpu_torch.ops import nms as nms_mod
    masked = torch.where(alive, hs, float("-inf"))
    bad, err = 0, 0.0
    for v, a in ((masked, None), (hs, alive)):
        got = nms_mod.topk_masked(v, k, alive=a)
        want = nms_mod.topk_masked_plain(v, k, alive=a)
        bad += topk_mismatches(got, want)
        fin = torch.isfinite(got[0]) & torch.isfinite(want[0])
        if bool(fin.any()):
            err = max(err, max_abs_err(got[0][fin], want[0][fin]))
    return bad, err


def no_sync_run(det, images):
    """``det.finish`` of a launched batch with PyTorch's sync debug mode
    set to "error" (a host synchronization raises) and ``torch.sort``
    replaced by a probe: returns the CUDA tensors' sorts it saw."""
    import torch
    det.finish(det.launch(images))  # the first call builds cached tables
    launched = det.launch(images)
    torch.cuda.synchronize()
    real_sort, seen = torch.sort, []

    def probe(x, *a, **kw):
        if x.is_cuda:
            seen.append(tuple(x.shape))
        return real_sort(x, *a, **kw)

    torch.sort = probe
    torch.cuda.set_sync_debug_mode("error")
    try:
        det.finish(launched)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.sort = real_sort
    torch.cuda.synchronize()
    return seen


def topk_phase(wt, dev, card, metric, zero, read, synth, fpga, scene,
               noise4k):
    """Phase 9d: S2 (``ops/nms.py::topk_masked``) bitwise its plain
    version on every kind of :func:`topk_maps` at the VGA and 4K grid
    sizes, batch 8, both input forms, k = 1, the paths' k, 8192 and the
    whole map, and k = 65536 at 4K (the multi-block sort); the dense
    extraction launching S2 on B3's map, bitwise its plain version; the
    dense extraction and two-phase's finish (compaction, suffix, final
    top k) at VGA and 4K, the overflowing setting included, with
    ``nms_iou=None`` under the sync debug mode "error", no torch.sort on
    the card; S2 on the dense maps timed beside its plain version and
    torch.sort(stable=True) of the map, in turns.  Returns S2's largest
    error and ``{label: (ms, plain ms, library ms, bound)}``."""
    import torch
    from waldboost_tpu_torch.ops import nms as nms_mod
    t0 = time.perf_counter()
    make = lambda m, hw, **kw: wt.make_batched_detector_boxes(
        m, hw, device=dev, **kw)[0]
    dense = {"VGA": (make(synth, VGA, k=1024), scene),
             "4K": (make(fpga, HW4K, k=128), noise4k)}
    err, n_checks = 0.0, 0
    for label, (det, _) in dense.items():
        gu, gv = det.grid.valid.shape
        n = gu * gv
        for i, kind in enumerate(TOPK_KINDS):
            for k in TOPK_KS[label] + (n,):
                hs, alive = topk_maps(kind, BATCH, n, min(k, n), 17 + i)
                bad, e = topk_check(torch.from_numpy(hs).to(dev),
                                    torch.from_numpy(alive).to(dev), k)
                err, n_checks = max(err, e), n_checks + 2
                require(bad == 0, f"phase 9d: S2 {label} {kind} k={k}: "
                        f"{bad} elements differ from its plain version")
        print(f"phase 9d: S2 {label} grid {gu}x{gv} ({n} entries), batch "
              f"{BATCH}: {len(TOPK_KINDS)} kinds x k {TOPK_KS[label] + (n,)}"
              f" x 2 forms bitwise its plain version")
    gu, gv = dense["4K"][0].grid.valid.shape
    for kind in ("far_above", "ties"):
        hs, alive = topk_maps(kind, BATCH, gu * gv, TOPK_BIG_K, 29)
        bad, e = topk_check(torch.from_numpy(hs).to(dev),
                            torch.from_numpy(alive).to(dev), TOPK_BIG_K)
        err, n_checks = max(err, e), n_checks + 2
        require(bad == 0, f"phase 9d: S2 4K {kind} k={TOPK_BIG_K}: {bad} "
                f"elements differ from its plain version")
    print(f"phase 9d: S2 4K k={TOPK_BIG_K} (runs of {nms_mod.TOPK_RUN}, "
          f"merged) bitwise its plain version; {n_checks} checks, largest "
          f"error {err}")

    # the dense extraction launches S2 on B3's masked map
    rows = {}
    for label, (det, images) in dense.items():
        zero()
        det(images)
        torch.cuda.synchronize()
        got = read()
        require(got["compact"] == 1 and got["cascade"] == 1,
                f"phase 9d: the dense {label} path launched {got}")
        masked, _, count = det.launch(images)
        flat = masked.reshape(masked.shape[0], -1)
        call = lambda: nms_mod.topk_masked(flat, det.k)
        plain = lambda: nms_mod.topk_masked_plain(flat, det.k)
        bad = topk_mismatches(call(), plain())
        require(bad == 0, f"phase 9d: S2 on the dense {label} map differs "
                f"from its plain version ({bad})")
        lib = lambda: torch.sort(flat, dim=1, descending=True, stable=True)
        row, ev = timed_in_turns(call, plain, lib)
        b = bound(nbytes(flat) + flat.shape[0] * det.k * 12
                  + flat.shape[0] * 4)
        rows[label] = row + (b,)
        print(f"phase 9d: S2 on the dense {label} map (k={det.k}, counts "
              f"{count.tolist()}): {timing_text(row, ev, 'torch.sort of the map')}"
              f", bound {b[0]:.5f} ms ({b[1]}); launches {got['compact']} a "
              f"batch ({card})")
        metric(f"compact_dense_{label.lower()}_ms", row[0], "ms")
        metric(f"compact_dense_{label.lower()}_events_ms",
               float(np.mean(ev)), "ms")
        metric(f"compact_dense_{label.lower()}_library_ms", row[2], "ms")

    # no host sync and no torch.sort on the extraction paths
    tp = lambda m, hw, **kw: make(m, hw, two_phase=True, **kw)
    runs = {
        "dense VGA": (dense["VGA"][0], scene),
        "dense 4K": (dense["4K"][0], noise4k),
        "two-phase VGA": (tp(synth, VGA), scene),
        "two-phase VGA overflow": (tp(synth, VGA, **TP_OVER), scene),
        "two-phase 4K": (tp(fpga, HW4K, k=128), noise4k),
        "two-phase 4K overflow": (tp(fpga, HW4K, k=128, **TP_OVER), noise4k),
    }
    for label, (det, images) in runs.items():
        seen = no_sync_run(det, images)
        require(not seen, f"phase 9d: {label} sorted on the card: {seen}")
    print(f"phase 9d: {list(runs)} finished under the sync debug mode "
          f"'error' (nms_iou=None) without a host sync or a torch.sort on "
          f"the card")
    print(f"phase 9d: {time.perf_counter() - t0:.1f} s")
    return err, rows


#: phase 10: a JAX-trained model over the user channel function
#: ``user_grad`` and its VGA golden (scripts/
#: make_torch_custom_channels_golden.py)
CUSTOM_GOLDEN = os.path.join(ROOT, "tests", "data",
                             "torch_port_custom_channels_golden.npz")
#: the per-level path runs B3 and no channel kernel
PER_LEVEL_PATH = ("cascade",)
CHANNEL_KERNELS = ("planes", "grad_hist", "grad_hist_float",
                   "grad_hist_fast", "fpga")


def custom_golden_run(wt, dev, g, tmp):
    """The golden's ``user_grad`` model (its file bytes, loaded on the
    card) over the golden's VGA scenes, ``make_batched_detector_boxes(k)``
    (every survivor, no NMS): ``(diffs, count)`` with ``diffs`` the
    mismatching elements of each output."""
    import hashlib
    import torch
    path = os.path.join(tmp, "user_grad.pb")
    with open(path, "wb") as f:
        f.write(g["model"].tobytes())
    model = wt.load(path, device=dev)
    require(model.channel_opts["channels"].name == "user_grad",
            "phase 10b: the golden model is not over user_grad")
    frames = scene_batch(len(g["count"]), hw=VGA, seed=100)
    require(hashlib.sha256(frames.numpy().tobytes()).hexdigest()
            == str(g["frames_sha256"]), "phase 10b: the frames differ from "
            "the golden's")
    fn, _ = wt.make_batched_detector_boxes(model, VGA,
                                           k=g["rects"].shape[1], device=dev)
    rects, scores, valid, count, _ = (a.cpu().numpy()
                                      for a in fn(frames.to(dev)))
    torch.cuda.synchronize()
    v = g["valid"]
    diffs = {"count": int((count != g["count"]).sum()),
             "valid": int((valid != v).sum()),
             "rects": int((rects[v] != g["rects"][v]).sum()),
             "scores": int((scores[v] != g["scores"][v]).sum())}
    return diffs, count


def channel_phases(wt, dev, card, metric, zero, read, synth, noise, scene):
    """Phases 10a-10d: channel functions a user registers, served through
    the per-level canvas.  Returns the per-level path's launches."""
    import torch
    from waldboost_tpu_torch.channels import (ChannelFunction,
                                              channel_pyramid,
                                              compute_pyramid, grad_hist,
                                              register_channel_function)
    t0 = time.perf_counter()
    # -- 10a: the flagship over a user function computing grad_hist: every
    # output and the canvas inside the levels against the kernel canvas's
    register_channel_function(ChannelFunction("user_grad_hist",
                                              grad_hist.fn, 4))
    register_channel_function(ChannelFunction("user_grad", user_grad, 2))
    user = wt.model_from_stages(
        synth.shape, dict(synth.channel_opts, channels="user_grad_hist"),
        synth.stages, synth.theta, device=dev)
    kw = dict(k=1024, nms_iou=0.5)
    det_k, packed = wt.make_batched_detector_boxes(synth, VGA, device=dev,
                                                   **kw)
    det_u, packed_u = wt.make_batched_detector_boxes(user, VGA, device=dev,
                                                     **kw)
    require(det_u.canvas.per_level and not det_k.canvas.per_level,
            "phase 10a: the user model did not take the per-level canvas")
    require(packed_u == packed, "phase 10a: the two plans differ")
    inside = torch.as_tensor(packed.level_interior_mask(), device=dev)
    names = ("rects", "scores", "valid", "count", "n_weak")
    for label, batch in (("scenes", scene), ("noise", noise[0])):
        zero()
        got = det_u(batch)
        torch.cuda.synchronize()
        launches = read()
        want = det_k(batch)
        cu, ck = det_u.canvas(batch), det_k.canvas(batch)
        Hc, Wc = cu.shape[-2:]
        canvas_bad = int((cu[..., inside]
                          != ck[..., :Hc, :Wc][..., inside]).sum())
        bad = {n: int((a != b).sum()) for n, a, b in zip(names, got, want)}
        print(f"phase 10a: {label}: per-level canvas against the kernel "
              f"canvas inside the levels: {canvas_bad} of "
              f"{int(inside.sum()) * cu.shape[0] * cu.shape[1]} values "
              f"differ; outputs {bad} mismatching elements (counts "
              f"{got[3].tolist()}); launches {launches}")
        require(canvas_bad == 0 and not any(bad.values()),
                f"phase 10a: {label}: the per-level path differs from the "
                f"kernel canvas's")
        require(all(launches[k] > 0 for k in PER_LEVEL_PATH)
                and not any(launches[k] for k in CHANNEL_KERNELS),
                f"phase 10a: the per-level path launched {launches}")
    path_launches = launches

    # -- 10b: the JAX-trained user_grad model against its golden
    g = np.load(CUSTOM_GOLDEN)
    with tempfile.TemporaryDirectory() as tmp:
        diffs, count = custom_golden_run(wt, dev, g, tmp)
    require(not any(diffs.values()), f"phase 10b: user_grad serving differs "
            f"from the JAX golden: {diffs}")
    print(f"phase 10b: user_grad ({len(g['count'])} VGA scenes, k "
          f"{g['rects'].shape[1]}) bitwise the JAX golden (counts "
          f"{count.tolist()})")

    # -- 10c: compute_pyramid on a VGA frame: the kernel canvas's levels,
    # the per-level route's and channel_pyramid's
    frame = scene[0]
    cut = compute_pyramid(frame, synth.channel_opts, device=dev)
    lev = compute_pyramid(frame, user.channel_opts, device=dev)
    hwc = list(channel_pyramid(frame.cpu().numpy(), synth.channel_opts,
                               device=dev))
    require(len(cut) == len(lev) == len(hwc) > 0,
            "phase 10c: level counts differ")
    n_bad = sum(int((a != b).sum()) for (a, _), (b, _) in zip(cut, lev))
    n_bad += sum(int((a.permute(1, 2, 0).cpu() != torch.from_numpy(c))
                     .sum()) for (a, _), (c, _) in zip(cut, hwc))
    require(n_bad == 0 and all(sa == sb for (_, sa), (_, sb)
                               in zip(cut, lev)),
            f"phase 10c: compute_pyramid's routes differ ({n_bad} values)")
    print(f"phase 10c: compute_pyramid on a VGA scene: {len(cut)} levels, "
          f"the kernel canvas's cut, the per-level route and "
          f"channel_pyramid bitwise")

    # -- 10d: batch times, per-level against the kernel canvas, in turns
    rows = {}
    for which in ("kernel", "per-level", "per-level", "kernel"):
        det = det_k if which == "kernel" else det_u
        iters = 20 if which == "kernel" else 5
        rows.setdefault(which, []).append(
            (cuda_ms(lambda: det.canvas(scene), iters),
             cuda_ms(lambda: det(scene), iters)))
    for which, vals in rows.items():
        canvas_ms = [v[0] for v in vals]
        batch_ms = [v[1] for v in vals]
        metric(f"vga_{which.replace('-', '_')}_canvas_ms", min(canvas_ms),
               "ms")
        metric(f"vga_{which.replace('-', '_')}_batch_ms", min(batch_ms),
               "ms")
        print(f"phase 10d: {which} canvas, VGA scenes batch {BATCH} "
              f"({card}): canvas {canvas_ms} ms, whole detector call "
              f"(k=1024, NMS 0.5) {batch_ms} ms (CUDA events)")
    print(f"phases 10a-10d: {time.perf_counter() - t0:.1f} s")
    return path_launches


#: phase 11: the K at which S3 runs past the block's shared memory (25
#: bytes a candidate; the H100 opts a block in to 227 KB), and the NMS
#: thresholds S3 is held to its plain version at
NMS_BIG_K = 12000
NMS_THRESHOLDS = (0.5, 0.3)


def nms_phase(wt, dev, card, metric, zero, read, synth, scene, noise):
    """Phase 11: S3 (``ops/nms.py::nms``, csrc/nms.cu) bitwise
    ``nms_plain`` on the card, on the candidates the extraction gives it
    (``make_batched_detector_boxes(nms_iou=None)``'s rects, scores and
    valid): the VGA scenes and a noise batch at k 1024, 4K noise through
    fpga_4k_synth_64 at k 128, and the VGA scenes at k ``NMS_BIG_K``
    (past the block's shared memory), batch 8, at each of
    ``NMS_THRESHOLDS``, S3 launched once a call; the dense VGA and 4K
    detectors with NMS 0.5 finished under the sync debug mode "error";
    then S3 beside ``nms_plain`` in turns at the VGA scenes and 4K noise
    (NMS 0.5), S3 also replayed from a CUDA graph, with its bound (the
    candidates read once, keep written once).  Returns S3's largest
    error (0: every keep entry must equal the plain version's), ``(ms,
    plain ms, None)`` and the bound at the VGA scenes."""
    import torch
    from waldboost_tpu_torch.ops import nms as nms_mod
    t0 = time.perf_counter()
    fpga = wt.load(os.path.join(ROOT, "models", FPGA_MODELS[0] + ".pb"),
                   device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    noise4k = torch.randint(0, 256, (BATCH,) + HW4K, generator=gen,
                            dtype=torch.uint8, device=dev)
    make = lambda m, hw, **kw: wt.make_batched_detector_boxes(
        m, hw, device=dev, **kw)[0]
    optin = torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin
    require(NMS_BIG_K * 25 > optin, f"phase 11: k={NMS_BIG_K} fits the "
            f"block's {optin} bytes of shared memory")
    cases = {"VGA scenes": (make(synth, VGA, k=1024), scene),
             "VGA noise": (make(synth, VGA, k=1024), noise),
             "4K noise": (make(fpga, HW4K, k=128), noise4k),
             f"VGA scenes k={NMS_BIG_K}": (make(synth, VGA, k=NMS_BIG_K),
                                           scene)}
    timed = {}
    for label, (det, images) in cases.items():
        rects, scores, valid = det(images)[:3]
        for thr in NMS_THRESHOLDS:
            zero()
            got = nms_mod.nms(rects, scores, valid, thr)
            torch.cuda.synchronize()
            launches = read()["nms"]
            want = nms_mod.nms_plain(rects, scores, valid, thr)
            bad = int((got != want).sum())
            print(f"phase 11: S3 {label} {tuple(scores.shape)}, NMS {thr}: "
                  f"{bad} mismatching keep entries of {want.numel()}, "
                  f"{int(valid.sum())} candidates, kept "
                  f"{want.sum(1).tolist()}, {launches} launch")
            require(bad == 0 and launches == 1, f"phase 11: S3 {label} NMS "
                    f"{thr}: {bad} keep entries differ from nms_plain, "
                    f"{launches} launches")
        if label in ("VGA scenes", "4K noise"):
            timed[label] = (rects, scores, valid)
    del cases

    # the dense detectors with NMS read nothing back on the host
    runs = {"dense VGA": (make(synth, VGA, k=1024, nms_iou=0.5), scene),
            "dense 4K": (make(fpga, HW4K, k=128, nms_iou=0.5), noise4k)}
    for label, (det, images) in runs.items():
        seen = no_sync_run(det, images)
        require(not seen, f"phase 11: {label} sorted on the card: {seen}")
    print(f"phase 11: {list(runs)} with NMS 0.5 finished under the sync "
          f"debug mode 'error' without a host sync")

    row_vga = b_vga = None
    for label, (rects, scores, valid) in timed.items():
        call = lambda: nms_mod.nms(rects, scores, valid, 0.5)
        plain = lambda: nms_mod.nms_plain(rects, scores, valid, 0.5)
        rounds = int(plain().sum(1).max())
        row, ev = timed_in_turns(call, plain)
        replayed = graph_ms(call, 10)
        b = bound(nbytes(rects, scores, valid) + valid.numel())
        if label == "VGA scenes":
            row_vga, b_vga = row, b
        print(f"phase 11: S3 {label} {tuple(scores.shape)}, NMS 0.5, "
              f"{rounds} rounds: {timing_text(row, ev, None)}, replayed "
              f"from a CUDA graph {replayed:.4f} ms, bound {b[0]:.5f} ms "
              f"({b[1]}) ({card})")
        tag = f"nms_{label.split()[0].lower()}"
        metric(f"{tag}_ms", row[0], "ms")
        metric(f"{tag}_events_ms", float(np.mean(ev)), "ms")
        metric(f"{tag}_plain_ms", row[1], "ms")
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return 0.0, row_vga, b_vga


#: phase 12: the frames S4 is held and timed at (label, sides, octaves:
#: the benchmark's plans have 5 at VGA and 7 at 4K)
OCTAVE_CASES = (("VGA", VGA, 5), ("4K", HW4K, 7))


def special_floats(shape, dev, seed):
    """Seeded float32 frames over many exponents, about a twelfth each
    NaN, +inf, -inf, subnormal and -0."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev) * torch.pow(
        2.0, torch.randint(-20, 20, shape, generator=gen, device=dev).float())
    pick = torch.randint(0, 12, shape, generator=gen, device=dev)
    sub = torch.randint(1, 2 ** 23, shape, generator=gen, device=dev,
                        dtype=torch.int32).view(torch.float32)
    for code, value in ((0, float("nan")), (1, float("inf")),
                        (2, float("-inf")), (4, -0.0)):
        x = torch.where(pick == code, torch.full_like(x, value), x)
    return torch.where(pick == 3, sub, x).contiguous()


def octaves_phase(wt, dev, card, metric, zero, read, synth):
    """Phase 12: S4 (``ops/octaves.py::octaves``, csrc/octaves.cu) byte
    for byte ``octaves_plain`` on the card: uint8 noise and float32 frames
    with NaN, +-inf, subnormals and -0 at each of ``OCTAVE_CASES``, batch
    8, one launch each; the dense VGA and 4K detector calls launch it
    once; then S4 beside the plain chain in turns on the uint8 noise, with
    its bound (the frames read once, the octave buffer written once).
    Returns S4's largest error (0: every value must equal the plain
    chain's bits), ``(ms, plain ms, None)`` and the bound at VGA."""
    import torch
    from waldboost_tpu_torch.ops import octaves as oct_mod
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(12)
    bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t
    frames = {}
    for label, hw, n in OCTAVE_CASES:
        u8 = torch.randint(0, 256, (BATCH,) + hw, generator=gen,
                           dtype=torch.uint8, device=dev)
        frames[label] = u8
        for images in (u8, special_floats((BATCH,) + hw, dev, 12)):
            zero()
            got = oct_mod.octaves(images, n)
            torch.cuda.synchronize()
            launches = read()["octaves"]
            want = oct_mod.octaves_plain(images, n)
            bad = int((bits(got) != bits(want)).sum())
            print(f"phase 12: S4 {label} {images.dtype} {tuple(got.shape)}, "
                  f"{n} octaves: {bad} mismatching values of "
                  f"{want.numel()}, {launches} launch")
            require(bad == 0 and launches == 1, f"phase 12: S4 {label} "
                    f"{images.dtype}: {bad} values differ from the plain "
                    f"chain, {launches} launches")

    fpga = wt.load(os.path.join(ROOT, "models", FPGA_MODELS[0] + ".pb"),
                   device=dev)
    dense = {"VGA": wt.make_batched_detector_boxes(
                 synth, VGA, k=1024, nms_iou=0.5, device=dev)[0],
             "4K": wt.make_batched_detector_boxes(
                 fpga, HW4K, k=128, nms_iou=0.5, device=dev)[0]}
    for label, det in dense.items():
        det(frames[label])
        torch.cuda.synchronize()
        zero()
        det(frames[label])
        torch.cuda.synchronize()
        got = read()
        print(f"phase 12: dense {label} call launches {got}")
        require(got["octaves"] == 1, f"phase 12: the dense {label} call "
                f"launched S4 {got['octaves']} times")
    del dense

    row_vga = b_vga = None
    for label, hw, n in OCTAVE_CASES:
        u8 = frames[label]
        call = lambda: oct_mod.octaves(u8, n)
        plain = lambda: oct_mod.octaves_plain(u8, n)
        row, ev = timed_in_turns(call, plain)
        b = bound(nbytes(u8, call()))
        if label == "VGA":
            row_vga, b_vga = row, b
        share = "not measured" if row[0] is None else f"{b[0] / row[0]:.3f}"
        print(f"phase 12: S4 {label} {tuple(u8.shape)}, {n} octaves: "
              f"{timing_text(row, ev, None)}, bound {b[0]:.5f} ms ({b[1]}), "
              f"bound/kernel {share} ({card})")
        tag = f"octaves_{label.lower()}"
        metric(f"{tag}_ms", row[0], "ms")
        metric(f"{tag}_events_ms", float(np.mean(ev)), "ms")
        metric(f"{tag}_plain_ms", row[1], "ms")
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return 0.0, row_vga, b_vga


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace-dir", default=None,
                    help="keep the profiler traces (Chrome JSON) here")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build, then run phases 8a-8f alone (no summary)")
    ap.add_argument("--twophase-only", action="store_true",
                    help="build, then run phases 9a-9d alone (no summary)")
    ap.add_argument("--channels-only", action="store_true",
                    help="build, then run phases 10a-10d alone (no "
                    "summary)")
    ap.add_argument("--octaves-only", action="store_true",
                    help="build, then run phase 12 alone (no summary)")
    args = ap.parse_args()
    started = time.perf_counter()

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: the smoke "
                           "test needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import waldboost_tpu_torch as wt
    from waldboost_tpu_torch import _build, packing
    from waldboost_tpu_torch import cli as cli_mod
    from waldboost_tpu_torch.canvas import (ChannelCanvas, channel_canvas,
                                            serving_opts)
    from waldboost_tpu_torch.channels import resolve_channel_function
    from waldboost_tpu_torch.ops import cascade as gen_mod
    from waldboost_tpu_torch.ops import cascade_static as casc_mod
    from waldboost_tpu_torch.ops import channels as chan_mod
    from waldboost_tpu_torch.ops import fpga as fpga_mod
    from waldboost_tpu_torch.ops import planes as plane_mod
    from waldboost_tpu_torch.ops.nms import extract_detections
    from waldboost_tpu_torch.parallel.detect import BucketedDetector
    from waldboost_tpu_torch.polyphase import META_COLS
    from waldboost_tpu_torch.profiling import Meter
    from waldboost_tpu_torch.utils import fake_data_generator
    def zero_counters():
        _build.launches.clear()

    def read_counters():
        return {name: _build.launches[name] for name in KERNELS}

    dev = torch.device("cuda", torch.cuda.current_device())
    device_name = torch.cuda.get_device_name(dev)
    card = card_line()
    power_limit = card.split(",")[-1].strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} numpy "
          f"{np.__version__}")
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- phase 1: build ---------------------------------------------------
    t0 = time.time()
    sources = sorted({os.path.basename(src)[:-3]
                      for src, _ in KERNELS.values()})
    _build.build(sources)
    for name in sources:
        for line in _build.build_log(name).splitlines():
            if "spill" in line or "ptxas" in line and (
                    "Used" in line or "Compiling" in line):
                print(f"[{name}] {line.strip()}")
    print(f"build: {time.time() - t0:.1f} s")

    models = {name: wt.load(os.path.join(ROOT, "models", name + ".pb"),
                            device=dev) for name in MODEL_NAMES}
    synth, hard256 = models["flagship_synth_64"], models["flagship_hard_256"]
    golden = np.load(GOLDEN)
    mgold = np.load(MODEL_GOLDEN)
    rng = np.random.RandomState(0)
    noise = [torch.from_numpy(rng.randint(0, 256, (BATCH,) + VGA)
                              .astype(np.uint8)).to(dev) for _ in range(4)]
    gframes = golden["frames"]
    require(gframes.shape == (3,) + VGA, "golden file must hold 3 VGA frames")
    require(np.array_equal(mgold["frames"], gframes),
            "the two golden files must hold the same frames")
    # the 3 golden scenes, then their horizontal and vertical flips
    scene_np = np.ascontiguousarray(np.concatenate(
        [gframes, gframes[:, :, ::-1], gframes[:, ::-1, :]])[:BATCH])
    require(scene_np.shape == (BATCH,) + VGA,
            "scene batch must hold BATCH frames")
    scene = torch.from_numpy(scene_np).to(dev)

    def metric(name, value, unit):
        print(json.dumps({"metric": name, "value": value, "unit": unit,
                          "device": device_name,
                          "power_limit": power_limit}))

    if args.twophase_only:
        twophase_phases(wt, dev, card, metric, zero_counters, read_counters,
                        synth, noise, scene, scene_np)
        print(f"chip_smoke --twophase-only wall time: "
              f"{time.perf_counter() - started:.1f} s ({card}); phases 1 "
              f"and 9a-9d passed, the others were not run")
        return

    if args.channels_only:
        channel_phases(wt, dev, card, metric, zero_counters, read_counters,
                       synth, noise, scene)
        print(f"chip_smoke --channels-only wall time: "
              f"{time.perf_counter() - started:.1f} s ({card}); phases 1 "
              f"and 10a-10d passed, the others were not run")
        return

    if args.octaves_only:
        octaves_phase(wt, dev, card, metric, zero_counters, read_counters,
                      synth)
        print(f"chip_smoke --octaves-only wall time: "
              f"{time.perf_counter() - started:.1f} s ({card}); phases 1 "
              f"and 12 passed, the others were not run")
        return

    if args.mesh_only:
        mesh_phases(wt, dev, card, metric, zero_counters, read_counters,
                    synth, scene_np, golden, np.load(FAST_GOLDEN))
        print(f"chip_smoke --mesh-only wall time: "
              f"{time.perf_counter() - started:.1f} s ({card}); phases 1 "
              f"and 8a-8f passed, the others were not run")
        return

    # -- phase 2: each kernel against its plain version at VGA batch 8 -----
    det, packed = wt.make_batched_detector_boxes(synth, VGA, k=1024,
                                                 nms_iou=0.5, device=dev)
    cstep, grid = det.canvas, det.grid
    print(f"plan: {len(packed.levels)} levels, canvas {packed.canvas_h}x"
          f"{packed.canvas_w}, {int(grid.valid.sum())} valid origins")
    octs = cstep.octaves(noise[0])
    planes = cstep.planes(octs)
    planes_ref = plane_mod.planes_plain(octs, cstep.plane_ops)
    canvas = cstep.channels(planes)
    canvas_ref = chan_mod.grad_hist_plain(planes, cstep.interior,
                                          cstep.smooth)
    casc = det.cascade(canvas)
    casc_ref = casc_mod.cascade_masked_plain(canvas, grid.valid,
                                             det.cascade_ops)
    scene_canvas = cstep(scene)
    torch.cuda.synchronize()
    errs = {}

    def check_phase(kernel, phase, got, want):
        torch.cuda.synchronize()
        bad = sum(int((g != w).sum()) for g, w in zip(got, want))
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        print(f"phase {phase}: {bad} mismatching elements of "
              f"{sum(g.numel() for g in got)} (max abs err {err})")
        require(bad == 0, f"{phase}: kernel differs from its plain version")

    check_phase("planes", "planes", [planes], [planes_ref])
    check_phase("planes", "planes into a 0xAB buffer",
                [plane_mod.planes(octs, cstep.plane_ops,
                                  out=torch.full_like(planes_ref, 0xAB))],
                [planes_ref])
    check_phase("grad_hist", "grad_hist", [canvas], [canvas_ref])
    check_phase("cascade", "cascade", casc, casc_ref)
    masked, n_weak, count = casc
    print(f"noise batch: survivors {count.tolist()}, n_weak "
          f"{n_weak.tolist()}")

    canvases = {"noise": canvas, "scene": scene_canvas}
    for mname in ("flagship_synth_64", "flagship_hard_256"):
        ops = models[mname]._operands(dev)
        for cap in (None, 12):
            for cname, cv in canvases.items():
                got = casc_mod.cascade_response(cv, grid.valid, ops, cap)
                want = casc_mod.cascade_response_plain(cv, grid.valid, ops,
                                                       cap)
                check_phase("cascade_response",
                            f"cascade_response {mname} cap={cap} {cname}",
                            got, want)
                print(f"  alive {got[1].sum(dim=(1, 2)).tolist()}, n_weak "
                      f"{got[2].tolist()}")
    drng = np.random.RandomState(1)
    deep = deep_model(wt, synth, dev, drng)
    tables = {"flagship_synth_64": synth._get_cascade(),
              "flagship_hard_256": hard256._get_cascade(),
              "deep40": deep._get_cascade()}
    for tname, (ctab, meta) in tables.items():
        print(f"B6 tables {tname}: {ctab.n_stages} stages "
              f"({int(ctab.active.sum())} active), {ctab.n_nodes} nodes, "
              f"depth {meta.depth}, complete {meta.complete}")
        for cname, cv in canvases.items():
            got = gen_mod.cascade_response_grid(cv, ctab, (12, 12),
                                                grid.valid)
            want = gen_mod.cascade_response_grid_plain(cv, ctab, (12, 12),
                                                       grid.valid)
            check_phase("cascade_generic", f"cascade_generic {tname} {cname}",
                        got, want)
            print(f"  alive {got[1].sum(dim=(1, 2)).tolist()}, n_weak "
                  f"{got[2].tolist()}")
    require(tables["deep40"][0].n_stages == 64
            and not tables["deep40"][1].complete,
            "the deep model must take the padded general-tree tables")

    # -- phase 2a: B1 and B2 at BASELINE config 3's 1080p shapes -------------
    _, npo, sm1080, cf1080 = serving_opts(synth.channel_opts, synth.shape[2])
    packed1080 = packing._packed_plan_cached(HD[0], HD[1], 2, npo,
                                             synth.shape[:2], halo=cf1080.halo)
    # not the cached canvas step: freed before the end-to-end runs
    cs1080 = ChannelCanvas(packed1080, HD, sm1080, cf1080, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    noise1080 = torch.randint(0, 256, (BATCH,) + HD, generator=gen,
                              dtype=torch.uint8, device=dev)
    octs1080 = cs1080.octaves(noise1080)
    planes1080 = cs1080.planes(octs1080)
    print(f"1080p plan: {len(packed1080.levels)} levels, planes "
          f"{packed1080.canvas_h}x{packed1080.canvas_w}")
    want = plane_mod.planes_plain(octs1080, cs1080.plane_ops)
    check_phase("planes", f"planes 1080p batch {BATCH}", [planes1080], [want])
    check_phase("planes", f"planes 1080p into a 0xAB buffer",
                [plane_mod.planes(octs1080, cs1080.plane_ops,
                                  out=torch.full_like(want, 0xAB))], [want])
    canvas1080 = {}
    for sm in (1, 0):
        m = cs1080.interior if sm else None
        canvas1080[sm] = chan_mod.grad_hist(planes1080, m, sm)
        check_phase("grad_hist", f"grad_hist 1080p smooth={sm} batch {BATCH}",
                    [canvas1080[sm]],
                    [chan_mod.grad_hist_plain(planes1080, m, sm)])
    del want

    # -- phase 2b: tiling edges of B5 and the walk --------------------------
    # B5 at sizes that are no multiple of its 128 x 16 tile or its 4-pixel
    # vector, planes starting off a word boundary; the walk on grids
    # smaller than its 8 x 32 tile of origins, and on a cascade whose
    # records exceed its shared-memory budget (read from global memory)
    erng = np.random.RandomState(3)
    for ehw, eb in (((3, 5), 3), ((17, 45), 1), ((70, 257), 3)):
        buf = torch.from_numpy(erng.randint(0, 256, 4 * eb * ehw[0] * ehw[1]
                                            + 1).astype(np.uint8)).to(dev)
        eplanes = buf[1:].view((eb, 2, 2) + ehw)
        ering = torch.from_numpy((erng.rand(2, 2, *ehw) < 0.8)
                                 .astype(np.uint8)).to(dev)
        einner = torch.from_numpy((erng.rand(*ehw) < 0.9)
                                  .astype(np.uint8)).to(dev)
        for fkind in ("grad_mag_u1", "grad_hist_4_u1",
                      "grad_hist_4_u1+grad_mag_u1"):
            for sm in (0, 1):
                em = einner if sm else None
                check_phase("fpga", f"fpga edge {ehw} batch {eb} {fkind} "
                            f"smooth={sm}",
                            [fpga_mod.fpga_channels(eplanes, ering, em, fkind,
                                                    sm)],
                            [fpga_mod.fpga_channels_plain(eplanes, ering, em,
                                                          fkind, sm)])
    big_stages = [random_deep_stage(drng, (12, 12), 4, depth=5)
                  for _ in range(256)]
    for st in big_stages:
        st["threshold"] = drng.uniform(0, 300, len(st["threshold"])) \
            .astype(np.float32)
    big = wt.model_from_stages(synth.shape, synth.channel_opts, big_stages,
                               [-np.inf] * 256, device=dev)
    for ehw in ((12 + 3, 12 + 50), (12 + 40, 12 + 5), (12 + 19, 12 + 77)):
        ecv = torch.from_numpy(erng.uniform(0, 300, (3, 4) + ehw)
                               .astype(np.float32)).to(dev)
        evalid = torch.from_numpy((erng.rand(ehw[0] - 12, ehw[1] - 12) < 0.8)
                                  .astype(np.uint8)).to(dev)
        for mname, mm in (("deep40", deep), ("big256", big)):
            eops = mm._operands(dev)
            check_phase("cascade", f"cascade edge {ehw} {mname}",
                        casc_mod.cascade_masked(ecv, evalid, eops),
                        casc_mod.cascade_masked_plain(ecv, evalid, eops))
            for cap in (0, 1, None):
                check_phase("cascade_response",
                            f"cascade_response edge {ehw} {mname} cap={cap}",
                            casc_mod.cascade_response(ecv, evalid, eops, cap),
                            casc_mod.cascade_response_plain(ecv, evalid, eops,
                                                            cap))
            ectab = mm._get_cascade()[0]
            check_phase("cascade_generic", f"cascade_generic edge {ehw} "
                        f"{mname} ({ectab.n_stages} stages)",
                        gen_mod.cascade_response_grid(ecv, ectab, (12, 12),
                                                      evalid),
                        gen_mod.cascade_response_grid_plain(ecv, ectab,
                                                            (12, 12), evalid))
    print(f"records bytes: big256 "
          f"{big._operands(dev).records((4, 52, 62)).data.numel() * 4}, "
          f"deep40 {deep._operands(dev).records((4, 52, 62)).data.numel() * 4}"
          f" static, {tables['deep40'][0].records((4, 52, 62)).data.numel() * 4}"
          f" padded")
    del big, big_stages

    # -- phase 2c: B2f and B3f against their plain versions ------------------
    # B2f bitwise on the bfloat16 bits, for uint8, float32 and bfloat16
    # planes: at VGA (the fast canvas step's own planes of noise frames),
    # at 1080p (seeded planes), and at phase 2b's small odd shapes with the
    # planes and mask starting one element off a word; then B3f (and B4 over
    # the same bfloat16 canvas) on the VGA fast canvas
    fastg = np.load(FAST_GOLDEN)
    fsteps = {ff: channel_canvas(packed, VGA, cstep.smooth, cstep.cf, dev,
                                 True, ff) for ff in ("f32", "bf16")}
    frng = np.random.RandomState(8)
    noise_f = [torch.from_numpy((frng.randint(0, 256, (BATCH,) + VGA)
                                 + frng.rand(BATCH, *VGA)).astype(np.float32))
               .to(dev) for _ in range(2)]
    fplanes = {"uint8": planes}
    for ff, st in fsteps.items():
        fplanes[ff] = st.planes(st.octaves(noise_f[0]))
    gen = torch.Generator(device=dev).manual_seed(9)
    rand1080 = torch.rand((BATCH, 2, 2) + tuple(planes1080.shape[3:]),
                          generator=gen, device=dev) * 256
    fplanes1080 = {"uint8": planes1080, "f32": rand1080,
                   "bf16": rand1080.to(torch.bfloat16)}
    del rand1080

    def fast_phase(phase, p, m, sm):
        got = chan_mod.grad_hist_fast(p, m, sm)
        check_phase("grad_hist_fast", phase, [got.view(torch.int16)],
                    [chan_mod.grad_hist_fast_plain(p, m, sm)
                     .view(torch.int16)])
        return got

    fcanvas = {}
    for label, pl_, mask_ in (("VGA", fplanes, cstep.interior),
                              ("1080p", fplanes1080, cs1080.interior)):
        for kind, p in pl_.items():
            for sm in (1, 0):
                got = fast_phase(f"grad_hist_fast {label} {kind} planes "
                                 f"smooth={sm} batch {BATCH}", p,
                                 mask_ if sm else None, sm)
                if label == "VGA" and sm == 1:
                    fcanvas[kind] = got
    del fplanes1080
    for ehw, eb in GH_EDGES:
        emask = torch.from_numpy((erng.rand(*ehw) < 0.9).astype(np.uint8)) \
            .to(dev)
        vals = torch.from_numpy(erng.rand(eb, 2, 2, *ehw).astype(np.float32)
                                * 256).to(dev)
        for kind, p in (("uint8", vals.to(torch.uint8)), ("f32", vals),
                        ("bf16", vals.to(torch.bfloat16))):
            for sm in (0, 1):
                for off in (0, 1):
                    buf = torch.empty(p.numel() + off, dtype=p.dtype,
                                      device=dev)
                    q = buf[off:].view(p.shape)
                    q.copy_(p)
                    mbuf = torch.empty(emask.numel() + off, dtype=torch.uint8,
                                       device=dev)
                    mq = mbuf[off:].view(ehw)
                    mq.copy_(emask)
                    fast_phase(f"grad_hist_fast edge {ehw} batch {eb} {kind} "
                               f"smooth={sm} offset {off}", q,
                               mq if sm else None, sm)
    fcv = fcanvas["uint8"]
    # the timing rows' scene canvas: 8 frames of scene_generator(seed=100)
    fcv_scene = chan_mod.grad_hist_fast(
        cstep.planes(cstep.octaves(scene_batch(BATCH).to(dev))),
        cstep.interior, 1)

    def b3f_phase(phase, cv, valid_, ops):
        """B3f against its plain version and B3 over the float32 copy."""
        since = dict(_build.launches)
        got = casc_mod.cascade_masked(cv, valid_, ops)
        path = front_paths(since)
        check_phase("cascade_fast", f"{phase} (front by {path})", got,
                    casc_mod.cascade_masked_plain(cv, valid_, ops))
        check_phase("cascade_fast", f"{phase} against B3 on float32", got,
                    casc_mod.cascade_masked(cv.float(), valid_, ops))
        return got

    for mname in MODEL_NAMES:
        ops = models[mname]._operands(dev)
        for kind, cv in dict(fcanvas, scene=fcv_scene).items():
            got = b3f_phase(f"cascade_fast {mname} bf16 canvas of {kind} "
                            "planes", cv, grid.valid, ops)
            print(f"  survivors {got[2].tolist()}, n_weak {got[1].tolist()}")
        if mname == "flagship_hard_64":
            continue
        for cap in (None, 12):
            check_phase("cascade_response", f"cascade_response {mname} "
                        f"cap={cap} bf16 canvas",
                        casc_mod.cascade_response(fcv, grid.valid, ops, cap),
                        casc_mod.cascade_response_plain(fcv, grid.valid, ops,
                                                        cap))

    # B3f's edges: grids under one tile, rows off 16 bytes, a canvas one
    # element off a word, windows 8, 12 and 24, C = 1, 4 and 5, batch 1 and
    # 3, the seeded cascades of b3f_edge_models
    for label, ecv, evalid, eops in b3f_edges(casc_mod, dev):
        b3f_phase(f"cascade_fast edge {label}", ecv, evalid, eops)

    # -- phase 3d: B2d against its plain version ----------------------------
    # on the exact float planes (the canvas step's float64 build) of float
    # noise frames and of the golden scenes as float32, at VGA batch 8,
    # smooth 0 and 1, each into an output pre-filled with NaN; then at
    # phase 2b's small odd shapes with planes and mask one element off a
    # word.  Both sides are native f64 without FMA: bitwise.
    scene_f = scene.float()
    octs_f = cstep.octaves(noise_f[0])
    xplanes = {"noise": cstep.planes(octs_f),
               "scene": cstep.planes(cstep.octaves(scene_f))}

    def float_phase(phase, p, m, sm):
        want = chan_mod.grad_hist_float_plain(p, m, sm)
        got = chan_mod.grad_hist_float(p, m, sm,
                                       out=torch.full_like(want, float("nan")))
        check_phase("grad_hist_float", phase, [got], [want])
        return got

    xcanvas = {}
    for kind, p in xplanes.items():
        for sm in (1, 0):
            got = float_phase(f"grad_hist_float VGA {kind} smooth={sm} "
                              f"batch {BATCH}", p,
                              cstep.interior if sm else None, sm)
            if sm == 1:
                xcanvas[kind] = got
    for ehw, eb in GH_EDGES:
        emask = torch.from_numpy((erng.rand(*ehw) < 0.9).astype(np.uint8)) \
            .to(dev)
        vals = torch.from_numpy(erng.rand(eb, 2, 2, *ehw).astype(np.float32)
                                * 256).to(dev)
        for sm in (0, 1):
            for off in (0, 1):
                buf = torch.empty(vals.numel() + off, dtype=torch.float32,
                                  device=dev)
                q = buf[off:].view(vals.shape)
                q.copy_(vals)
                mbuf = torch.empty(emask.numel() + off, dtype=torch.uint8,
                                   device=dev)
                mq = mbuf[off:].view(ehw)
                mq.copy_(emask)
                float_phase(f"grad_hist_float edge {ehw} batch {eb} smooth="
                            f"{sm} offset {off}", q, mq if sm else None, sm)

    # -- phase 3: serving path (slice 1) on the golden frames --------------
    frames = torch.from_numpy(gframes).to(dev)
    zero_counters()
    rects, scores, valid, count, n_weak = det(frames)
    torch.cuda.synchronize()
    serving_launches = read_counters()
    print(f"serving path launches: {serving_launches}")
    require(all(serving_launches[k] > 0
                for k in ("planes", "grad_hist", "cascade", "compact")),
            "a kernel of the serving path was not launched")
    require(serving_launches["nms"] == 1,
            "the serving path did not launch S3 once for its call")
    require(serving_launches["octaves"] == 1,
            "the serving path did not launch S4 once for its call")
    rects, scores = rects.cpu().numpy(), scores.cpu().numpy()
    valid, count = valid.cpu().numpy(), count.cpu().numpy()
    require(rects.shape == (len(gframes), 1024, 4)
            and np.isfinite(rects).all(), "bad box tensor")
    require(np.isfinite(scores[valid]).all(), "non-finite kept score")
    print(f"golden frames: survivors {count.tolist()} (JAX "
          f"{golden['raw_counts'].tolist()}), kept {valid.sum(1).tolist()} "
          f"(JAX {golden['kept_counts'].tolist()})")
    require(np.array_equal(count, golden["raw_counts"]),
            "survivor counts differ from the JAX golden")
    split = np.cumsum(golden["kept_counts"])[:-1]
    for b, (r_ref, s_ref) in enumerate(zip(
            np.split(golden["kept_rects"], split),
            np.split(golden["kept_scores"], split))):
        require(np.array_equal(sorted_rows(rects[b][valid[b]],
                                           scores[b][valid[b]]),
                               sorted_rows(r_ref, s_ref)),
                f"frame {b}: kept boxes/scores differ from the JAX golden")
    print("serving path: boxes and scores bitwise equal to JAX")

    # -- phase 3a: fast serving mode on the golden frames -------------------
    # uint8 frames, and their float32 versions with f32 and bf16 planes,
    # each run with the counters set to 0 first; then the multi-model
    # detector in fast mode over the uint8 frames
    fk, fiou = int(fastg["k"]), float(fastg["nms_iou"])
    ffloat = torch.from_numpy(gframes + np.random.RandomState(
        int(fastg["seed"])).rand(*gframes.shape).astype(np.float32)).to(dev)
    fast_dets = {ff: wt.make_batched_detector_boxes(
        synth, VGA, k=fk, nms_iou=fiou, with_n_weak=False, device=dev,
        fast=True, fast_float=ff)[0] for ff in ("f32", "bf16")}
    fast_runs = (("uint8", fast_dets["f32"], frames,
                  ("octaves", "planes", "grad_hist_fast", "cascade_fast",
                   "nms")),
                 ("float_f32", fast_dets["f32"], ffloat,
                  ("octaves", "grad_hist_fast", "cascade_fast", "nms")),
                 ("float_bf16", fast_dets["bf16"], ffloat,
                  ("octaves", "grad_hist_fast", "cascade_fast", "nms")))
    fast_launches = dict.fromkeys(KERNELS, 0)
    fast_out = {}
    for key, fdet, imgs, need in fast_runs:
        zero_counters()
        out = fdet(imgs)
        torch.cuda.synchronize()
        got = read_counters()
        print(f"fast path {key} launches: {got}; B3f's front read the canvas "
              f"by {front_paths({})}")
        require(all(got[k] > 0 for k in need),
                f"fast path {key}: a kernel of the path was not launched")
        require(got["grad_hist"] == 0 and got["cascade"] == 0,
                f"fast path {key}: an exact-mode kernel was launched")
        for k, v in got.items():
            fast_launches[k] += v
        fast_out[key] = [a.cpu().numpy() for a in out]
    for key, (rects, scores, valid, count, n_weak) in fast_out.items():
        require(np.isfinite(rects).all() and np.isfinite(scores[valid]).all()
                and not n_weak.any(), f"fast path {key}: bad outputs")
        require(np.array_equal(count, fastg[key + "_counts"]),
                f"fast path {key}: survivor counts differ from the JAX "
                f"golden")
        for b, ref in enumerate(np.split(
                fastg[key + "_kept"],
                np.cumsum(fastg[key + "_kept_counts"])[:-1])):
            require(np.array_equal(sorted_rows(rects[b][valid[b]],
                                               scores[b][valid[b]]),
                                   sorted_rows(ref)),
                    f"fast path {key} frame {b}: kept boxes/scores differ "
                    f"from the JAX golden")
        print(f"fast path {key}: survivors {count.tolist()}, kept "
              f"{valid.sum(1).tolist()}: bitwise equal to JAX")
    fn_multi_fast, _ = wt.make_multi_detector_boxes(
        list(models.values()), VGA, k=fk, nms_iou=fiou, device=dev,
        fast=True)
    zero_counters()
    multi_fast = [a.cpu().numpy() for a in fn_multi_fast(frames)]
    torch.cuda.synchronize()
    got = read_counters()
    print(f"fast multi-model launches: {got}")
    require(got["grad_hist_fast"] > 0 and got["cascade_fast"] > 0
            and got["nms"] > 0,
            "make_multi_detector_boxes(fast=True) did not launch B2f, B3f "
            "and S3")
    rects, scores, mvalid, label, _, _ = multi_fast
    urects, uscores, uvalid, _, _ = fast_out["uint8"]
    for b in range(len(gframes)):
        sel = mvalid[b] & (label[b] == 0)
        require(np.array_equal(sorted_rows(rects[b][sel], scores[b][sel]),
                               sorted_rows(urects[b][uvalid[b]],
                                           uscores[b][uvalid[b]])),
                f"frame {b}: the fast multi-model detector's first model "
                f"differs from the fast single-model detector")
    print("fast multi-model detector: its flagship_synth_64 boxes equal the "
          "single-model fast path's")

    # -- phase 4: the Model-API path on the golden frames ------------------
    scales = [float(s) for s in mgold["response_scale"]]
    k_top, iou = int(mgold["topk_k"]), float(mgold["nms_iou"])
    fn_full, _ = wt.make_batched_detector(synth, VGA, device=dev)
    fn_cap, _ = wt.make_batched_detector(synth, VGA, n_stages_cap=12,
                                         device=dev)
    fn_multi, _ = wt.make_multi_detector_boxes(
        list(models.values()), VGA, k=2048, response_scale=scales,
        device=dev)
    zero_counters()
    api = {}
    for name, model in models.items():
        per = []
        for frame in gframes:
            model.reset()
            boxes = model.detect(frame)
            per.append((boxes, model.n_weak, model.n_loc,
                        model.detect_topk(frame, k=k_top, nms_iou=iou)))
        model.reset()
        scan = model.scan_packed_batch(gframes)
        api[name] = (per, scan, model.n_weak)
    multi = [wt.detect(frame, *models.values(), response_scale=scales)
             for frame in gframes]
    full = fn_full(frames)
    capped = fn_cap(frames)
    multi_b = fn_multi(frames)
    torch.cuda.synchronize()
    path_launches = read_counters()
    print(f"Model-API path launches: {path_launches}")
    require(all(v > 0 for k, v in path_launches.items()
                if k not in ("fpga", "grad_hist_fast", "cascade_fast",
                             "grad_hist_float", "cascade_suffix")),
            "a kernel of the Model-API path was not launched")

    for name, (per, scan, scan_n_weak) in api.items():
        det_ref = golden_split(mgold, name + "_detect")
        topk_ref = golden_split(mgold, name + "_topk")
        scan_ref = golden_split(mgold, name + "_scan")
        for i, (boxes, nw, nloc, topk) in enumerate(per):
            require(np.array_equal(box_rows(boxes, "scores"),
                                   sorted_rows(det_ref[i])),
                    f"{name} frame {i}: Model.detect differs from JAX")
            require((nw, nloc) == (mgold[name + "_n_weak"][i],
                                   mgold[name + "_n_loc"][i]),
                    f"{name} frame {i}: n_weak/n_loc differ from JAX")
            require(np.array_equal(box_rows(topk, "scores"),
                                   sorted_rows(topk_ref[i])),
                    f"{name} frame {i}: detect_topk differs from JAX")
        _, hs, _, per_image = scan
        for i, (rs, cs) in enumerate(per_image):
            sc = hs[i][torch.as_tensor(rs, device=dev),
                       torch.as_tensor(cs, device=dev)].cpu().numpy()
            require(np.array_equal(np.stack([rs, cs, sc], 1)
                                   .astype(np.float32), scan_ref[i]),
                    f"{name} frame {i}: scan_packed_batch differs from JAX")
        require(scan_n_weak == mgold[name + "_scan_n_weak"].sum(),
                f"{name}: scan_packed_batch n_weak differs from JAX")
        print(f"{name}: detect {[len(p[0]) for p in per]}, topk "
              f"{[len(p[3]) for p in per]}, scan "
              f"{[len(p[0]) for p in per_image]} bitwise equal to JAX")
    multi_ref = golden_split(mgold, "multi")
    for i, boxes in enumerate(multi):
        require(np.array_equal(box_rows(boxes, "scores", "label"),
                               sorted_rows(multi_ref[i])),
                f"frame {i}: wt.detect differs from JAX")
    rects, scores, mvalid, label, mcount, _ = (a.cpu().numpy()
                                               for a in multi_b)
    for i in range(len(gframes)):
        ref = multi_ref[i]
        for kix in range(len(models)):
            require(mcount[i, kix] == (ref[:, 5] == kix).sum(),
                    f"frame {i} model {kix}: multi-detector count differs")
        sel = mvalid[i]
        require(np.array_equal(sorted_rows(rects[i][sel], scores[i][sel],
                                           label[i][sel]), sorted_rows(ref)),
                f"frame {i}: make_multi_detector_boxes differs from JAX")
    print(f"wt.detect and make_multi_detector_boxes: "
          f"{[len(b) for b in multi]} boxes bitwise equal to JAX")
    synth_scan = golden_split(mgold, "flagship_synth_64_scan")
    hs_f, alive_f, nw_f = full
    hs_c, alive_c, nw_c = capped
    for i, ref in enumerate(synth_scan):
        rs, cs = (torch.as_tensor(ref[:, j].astype(np.int64), device=dev)
                  for j in (0, 1))
        require(int(alive_f[i].sum()) == len(ref)
                and bool(alive_f[i][rs, cs].all())
                and np.array_equal(hs_f[i][rs, cs].cpu().numpy(), ref[:, 2]),
                f"frame {i}: make_batched_detector differs from JAX")
        require(bool(alive_c[i][rs, cs].all()),
                f"frame {i}: a survivor is dead after the 12-stage prefix")
    require(bool((nw_c <= nw_f).all()) and bool((alive_c | ~alive_f).all()),
            "the 12-stage prefix must do less work and keep more windows")
    prefix_ref = casc_mod.cascade_response_plain(
        cstep(frames), grid.valid, synth._operands(dev), 12)
    check_phase("cascade_response", "make_batched_detector prefix", capped,
                prefix_ref)
    print(f"make_batched_detector: survivors {alive_f.sum(dim=(1, 2)).tolist()}"
          f" of {alive_c.sum(dim=(1, 2)).tolist()} after 12 stages")

    # -- phase 4b: kernel B5 and the config-5 path (3840x2160, C = 5) -------
    fgold = np.load(FPGA_GOLDEN)
    hw4k = tuple(int(v) for v in fgold["hw"])
    require(hw4k == (2160, 3840), "the config-5 golden must be at 4K")
    fmodels = {name: wt.load(os.path.join(ROOT, "models", name + ".pb"),
                             device=dev) for name in FPGA_MODELS}
    gen = torch.Generator(device=dev).manual_seed(5)
    noise4k = [torch.randint(0, 256, (BATCH,) + hw4k, generator=gen,
                             dtype=torch.uint8, device=dev) for _ in range(2)]
    dets4k = {name: wt.make_batched_detector_boxes(
        mm, hw4k, k=128, nms_iou=0.5, device=dev)[0]
        for name, mm in fmodels.items()}
    c5 = {name: d.canvas for name, d in dets4k.items()}
    det5 = dets4k[FPGA_MODELS[0]]
    cs0 = c5[FPGA_MODELS[0]]
    octs4k = cs0.octaves(noise4k[0])
    planes4k = cs0.planes(octs4k)
    print(f"config-5 plan: {len(det5.packed.levels)} levels, canvas "
          f"{det5.packed.canvas_h}x{det5.packed.canvas_w}, halo "
          f"{det5.packed.halo}, {int(det5.grid.valid.sum())} valid origins")
    require(det5.packed.halo == 0, "the FPGA plan must have halo 0")
    # B1 with no reflect halo: edge levels sit at the canvas border
    want = plane_mod.planes_plain(octs4k, cs0.plane_ops)
    check_phase("planes", f"planes 4K halo 0 batch {BATCH}", [planes4k],
                [want])
    check_phase("planes", "planes 4K into a 0xAB buffer",
                [plane_mod.planes(octs4k, cs0.plane_ops,
                                  out=torch.full_like(want, 0xAB))], [want])
    del want
    canvas4k = {}
    for name, cs in c5.items():
        canvas4k[name] = cs.channels(planes4k)
        want = fpga_mod.fpga_channels_plain(planes4k, cs.ring, cs.interior,
                                            cs.cf.fused_kind, cs.smooth)
        check_phase("fpga", f"fpga {cs.cf.fused_kind} smooth={cs.smooth} "
                    f"4K batch {BATCH}", [canvas4k[name]], [want])
    del want
    vga4 = packing._packed_plan_cached(VGA[0], VGA[1], 2, 4, (12, 12),
                                       halo=0)
    for fkind in ("grad_hist_4_u1", "grad_mag_u1",
                  "grad_mag_u1+grad_hist_4_u1"):
        for sm in (0, 1):
            cs = channel_canvas(vga4, VGA, sm,
                                resolve_channel_function(fkind), dev)
            pv = cs.planes(cs.octaves(noise[0]))
            check_phase("fpga", f"fpga {fkind} smooth={sm} VGA batch {BATCH}",
                        [cs.channels(pv)],
                        [fpga_mod.fpga_channels_plain(pv, cs.ring, cs.interior,
                                                      fkind, sm)])
    casc5 = det5.cascade(canvas4k[FPGA_MODELS[0]])
    check_phase("cascade", f"cascade C=5 4K batch {BATCH}", casc5,
                casc_mod.cascade_masked_plain(canvas4k[FPGA_MODELS[0]],
                                              det5.grid.valid,
                                              det5.cascade_ops))
    print(f"config-5 noise batch: survivors {casc5[2].tolist()}, n_weak "
          f"{casc5[1].tolist()}")
    # B4 at C = 5 on each model's 4K canvas: all stages and the golden's
    # prefix length (the n_stages_cap of make_batched_detector)
    for name, mm in fmodels.items():
        ops5 = mm._operands(dev)
        for cap in (None, int(fgold[name + "_prefix_stages"])):
            got = casc_mod.cascade_response(canvas4k[name],
                                            dets4k[name].grid.valid, ops5, cap)
            want = casc_mod.cascade_response_plain(
                canvas4k[name], dets4k[name].grid.valid, ops5, cap)
            check_phase("cascade_response", f"cascade_response C=5 4K {name} "
                        f"cap={cap} batch {BATCH}", got, want)
            print(f"  alive {got[1].sum(dim=(1, 2)).tolist()}, n_weak "
                  f"{got[2].tolist()}")
        # B6 at C = 5 on the model's padded runtime tables
        ctab5 = mm._get_cascade()[0]
        got = gen_mod.cascade_response_grid(canvas4k[name], ctab5, (12, 12),
                                            dets4k[name].grid.valid)
        want = gen_mod.cascade_response_grid_plain(
            canvas4k[name], ctab5, (12, 12), dets4k[name].grid.valid)
        check_phase("cascade_generic", f"cascade_generic C=5 4K {name} "
                    f"batch {BATCH}", got, want)
    del got, want

    zero_counters()
    fres = fpga_path(wt, dev, fgold, fmodels)
    torch.cuda.synchronize()
    fpga_launches = read_counters()
    print(f"config-5 path launches: {fpga_launches}")
    require(all(fpga_launches[k] > 0 for k in ("planes", "fpga", "cascade",
                                               "cascade_response", "nms")),
            "a kernel of the config-5 path was not launched")
    check_fpga_path(fgold, fres)

    # -- phase 5c: bucketed serving on the card ------------------------------
    bgold = np.load(BUCKET_GOLDEN)
    bframes = [bgold[f"frame_{h}x{w}"] for h, w in BUCKET_SIZES]
    bdet = BucketedDetector(synth, bucket=int(bgold["bucket"]),
                            k=int(bgold["k"]), nms_iou=float(bgold["nms_iou"]),
                            device=dev)
    zero_counters()
    bout = bdet.detect_many(bframes)
    torch.cuda.synchronize()
    bucket_launches = read_counters()
    print(f"bucketed path launches: {bucket_launches}")
    require(all(bucket_launches[k] > 0
                for k in ("planes", "grad_hist", "cascade", "nms")),
            "bucketed serving: a kernel of the path was not launched")
    require(bdet.compiles == 2, f"bucketed serving: {bdet.compiles} set-ups "
            f"for two buckets")
    bexact = BucketedDetector(synth, bucket=int(bgold["bucket"]), k=8192,
                              device=dev)
    for (h, w), frame, bx in zip(BUCKET_SIZES, bframes, bout):
        key = f"{h}x{w}"
        want = bgold[f"kept_{key}"]
        require(np.array_equal(box_rows(bx, "scores"),
                               sorted_rows(want[:, :4], want[:, 4])),
                f"bucketed {key}: kept boxes/scores differ from the JAX "
                f"golden")
        bucket_hw = bdet._snap(h, w)
        batch = np.zeros((1,) + bucket_hw, np.uint8)
        batch[0, :h, :w] = frame
        cnt = bdet._program(bucket_hw)(
            torch.from_numpy(batch).to(dev),
            bdet._geometry(bucket_hw, (h, w)))[3]
        require(int(cnt[0]) == int(bgold[f"count_{key}"]),
                f"bucketed {key}: {int(cnt[0])} survivors, JAX "
                f"{int(bgold[f'count_{key}'])}")
        require(np.array_equal(box_rows(bexact.detect(frame), "scores"),
                               box_rows(synth.detect(frame), "scores")),
                f"bucketed {key}: boxes differ from Model.detect at the "
                f"true size")
        print(f"bucketed {key} in bucket {bucket_hw}: {int(cnt[0])} "
              f"survivors, {len(bx)} kept: bitwise equal to JAX's bucket; "
              f"every survivor equal to Model.detect's")
    # B1 (into a 0xAB buffer), B2 and B3 on a bucket's per-size tables
    h, w = BUCKET_SIZES[1]
    bhw = bdet._snap(h, w)
    bgeom = bdet._geometry(bhw, (h, w))
    bimgs = torch.from_numpy(np.ascontiguousarray(
        np.stack([bframes[1], bframes[1][::-1]]))).to(dev)
    boct = bgeom.canvas.octaves(bimgs)
    bwant = plane_mod.planes_plain(boct, bgeom.canvas.plane_ops)
    check_phase("planes", f"planes bucket {bhw} size {(h, w)}",
                [plane_mod.planes(boct, bgeom.canvas.plane_ops,
                                  out=torch.full_like(bwant, 0xAB))], [bwant])
    bcv = bgeom.canvas.channels(bwant)
    check_phase("grad_hist", f"grad_hist bucket {bhw} size {(h, w)}", [bcv],
                [chan_mod.grad_hist_plain(bwant, bgeom.canvas.interior, 1)])
    check_phase("cascade", f"cascade bucket {bhw} size {(h, w)}",
                casc_mod.cascade_masked(bcv, bgeom.grid.valid,
                                        synth._operands(dev)),
                casc_mod.cascade_masked_plain(bcv, bgeom.grid.valid,
                                              synth._operands(dev)))
    # fast mode on uint8 frames: B2's canvas in bfloat16 through B3f, no B2f
    bfast = BucketedDetector(synth, bucket=int(bgold["bucket"]), k=8192,
                             fast=True, device=dev)
    zero_counters()
    bfast.detect_many(bframes)
    torch.cuda.synchronize()
    got = read_counters()
    print(f"bucketed fast path launches (uint8 frames): {got}; B3f's front "
          f"read the canvas by {front_paths({})}")
    require(got["grad_hist"] > 0 and got["cascade_fast"] > 0
            and got["grad_hist_fast"] == 0 and got["cascade"] == 0,
            "bucketed fast mode on uint8 frames must run B2 and B3f, not "
            "B2f")
    # an FPGA model: two 1080p-class sizes in one bucket against its
    # Model.detect (the config-5 smooth-1 model's golden prefix, which
    # keeps windows of noise), then B1, B5 and B3 on the bucket's tables
    fname = FPGA_MODELS[1]
    fm = fmodels[fname]
    npre = int(fgold[fname + "_prefix_stages"])
    fpre = wt.model_from_stages(fm.shape, fm.channel_opts, fm.stages[:npre],
                                fm.theta[:npre], device=dev)
    fbdet = BucketedDetector(fpre, bucket=128, k=8192, device=dev)
    fb_rng = np.random.RandomState(12)
    fbframes = [fb_rng.randint(0, 256, hw).astype(np.uint8)
                for hw in FPGA_BUCKET_SIZES]
    zero_counters()
    fbout = fbdet.detect_many(fbframes)
    torch.cuda.synchronize()
    got = read_counters()
    print(f"bucketed FPGA path launches: {got}")
    require(all(got[k] > 0 for k in ("planes", "fpga", "cascade")),
            "bucketed FPGA serving: a kernel of the path was not launched")
    require(fbdet.compiles == 1, "the FPGA sizes must share one bucket")
    for hw, frame, bx in zip(FPGA_BUCKET_SIZES, fbframes, fbout):
        require(np.array_equal(box_rows(bx, "scores"),
                               box_rows(fpre.detect(frame), "scores")),
                f"bucketed FPGA {hw}: boxes differ from Model.detect")
        print(f"bucketed FPGA {hw} ({npre}-stage prefix of {fname}): "
              f"{len(bx)} survivors equal to Model.detect's")
    fhw = fbdet._snap(*FPGA_BUCKET_SIZES[1])
    fgeom = fbdet._geometry(fhw, FPGA_BUCKET_SIZES[1])
    fimgs = torch.from_numpy(fbframes[1][None]).to(dev)
    foct = fgeom.canvas.octaves(fimgs)
    fwant = plane_mod.planes_plain(foct, fgeom.canvas.plane_ops)
    check_phase("planes", f"planes FPGA bucket {fhw}",
                [plane_mod.planes(foct, fgeom.canvas.plane_ops,
                                  out=torch.full_like(fwant, 0xAB))], [fwant])
    fb_cv = fgeom.canvas.channels(fwant)
    check_phase("fpga", f"fpga FPGA bucket {fhw}", [fb_cv],
                [fpga_mod.fpga_channels_plain(
                    fwant, fgeom.canvas.ring, fgeom.canvas.interior,
                    fgeom.canvas.cf.fused_kind, fgeom.canvas.smooth)])
    check_phase("cascade", f"cascade FPGA bucket {fhw}",
                casc_mod.cascade_masked(fb_cv, fgeom.grid.valid,
                                        fpre._operands(dev)),
                casc_mod.cascade_masked_plain(fb_cv, fgeom.grid.valid,
                                              fpre._operands(dev)))
    del fbdet, fgeom, fb_cv, fwant, foct

    # -- phase 5d: exact float serving on the card ---------------------------
    flgold = np.load(FLOAT_GOLDEN)
    fl_frames = torch.from_numpy(gframes.astype(np.float32)).to(dev)
    zero_counters()
    rects, scores, valid, count, _ = (a.cpu().numpy() for a in det(fl_frames))
    torch.cuda.synchronize()
    float_launches = read_counters()
    print(f"exact float path launches: {float_launches}")
    require(float_launches["grad_hist_float"] > 0
            and float_launches["cascade"] > 0
            and float_launches["nms"] == 1
            and float_launches["octaves"] == 1,
            "exact float serving: B2d, B3, S3 or S4 was not launched")
    require(float_launches["grad_hist"] == 0
            and float_launches["grad_hist_fast"] == 0
            and float_launches["planes"] == 0,
            "exact float serving launched B1, B2 or B2f")
    require(np.array_equal(count, flgold["batched_counts"]),
            f"exact float: survivors {count.tolist()}, JAX "
            f"{flgold['batched_counts'].tolist()}")
    fl_kept = np.split(flgold["batched_kept"],
                       np.cumsum(flgold["batched_kept_counts"])[:-1])
    fl_raw = np.split(flgold["detect_rows"],
                      np.cumsum(flgold["detect_counts"])[:-1])
    for b in range(len(gframes)):
        require(np.array_equal(sorted_rows(rects[b][valid[b]],
                                           scores[b][valid[b]]),
                               sorted_rows(fl_kept[b][:, :4],
                                           fl_kept[b][:, 4])),
                f"exact float frame {b}: kept boxes/scores differ from JAX")
        bx = synth.detect(gframes[b].astype(np.float32))
        require(np.array_equal(box_rows(bx, "scores"),
                               sorted_rows(fl_raw[b][:, :4], fl_raw[b][:, 4])),
                f"exact float frame {b}: Model.detect differs from JAX")
    print(f"exact float frames: survivors {count.tolist()}, kept "
          f"{valid.sum(1).tolist()}: bitwise equal to JAX (batched and "
          f"Model.detect)")

    # -- phase 6t: config 4 training, teacher-forced against the golden ----
    tgold = np.load(TRAIN_GOLDEN)
    zero_counters()
    fit_ms, tpools = train_golden_run(wt, dev, tgold, refit=(0, 5))
    torch.cuda.synchronize()
    train_launches = read_counters()
    print(f"phase 6t: {len(fit_ms)} stages equal to JAX's, mining "
          f"launches {train_launches}")
    require(all(train_launches[k] > 0 for k in ("planes", "grad_hist",
                                                "cascade_generic")),
            "a kernel of the mining path (B1, B2, B6) was not launched")

    # -- phase 6u: the fit on the card is deterministic --------------------
    for s_, (X0, W0, X1, W1) in tpools.items():
        a, b = (wt.DTree.fit(X0, W0, X1, W1, max_depth=TRAIN_DEPTH,
                             device=dev).to_stage_dict() for _ in range(2))
        require(all(np.array_equal(a[k], b[k]) for k in a),
                f"phase 6u: two fits of stage {s_}'s pool differ")
        print(f"phase 6u: stage {s_} ({len(X0)} + {len(X1)} samples) "
              f"fitted twice, bitwise equal")
    del tpools

    # -- phase 6v: the FPGA trainer, teacher-forced, B5 in its mining -------
    zero_counters()
    fmodel, fgen = fpga_train_golden_run(wt, dev, np.load(FPGA_TRAIN_GOLDEN))
    torch.cuda.synchronize()
    fl = read_counters()
    require(all(fl[k] > 0 for k in ("planes", "fpga", "cascade_generic")),
            f"phase 6v: FPGA training did not run on B1, B5 and B6 ({fl})")
    for st in fmodel.stages:
        require(np.array_equal(st["threshold"], np.floor(st["threshold"]))
                and np.array_equal(st["prediction"] * 32,
                                   np.round(st["prediction"] * 32))
                and np.abs(st["prediction"]).max() <= 3,
                "phase 6v: FPGA stage not integer / 1/32-quantized")
    # the trainer's mining shapes (a batch of 8 of its 256 x 256 frames):
    # B1, B5 and B6 against their plain versions; the canvas is the one
    # Model.scan_packed_batch mines
    vframes = np.stack([next(fgen)["image"] for _ in range(BATCH)])
    vpacked, vsmooth, vcf = fmodel._plan(vframes.shape[1:])
    vstep = channel_canvas(vpacked, vframes.shape[1:], vsmooth, vcf, dev)
    voct = vstep.octaves(torch.from_numpy(vframes).to(dev))
    vplanes = vstep.planes(voct)
    check_phase("planes", f"planes FPGA trainer {vframes.shape[1:]} batch "
                f"{BATCH}", [vplanes], [plane_mod.planes_plain(
                    voct, vstep.plane_ops)])
    vcanvas = vstep.channels(vplanes)
    check_phase("fpga", f"fpga {vcf.fused_kind} smooth={vsmooth} FPGA "
                f"trainer batch {BATCH}", [vcanvas],
                [fpga_mod.fpga_channels_plain(vplanes, vstep.ring,
                                              vstep.interior, vcf.fused_kind,
                                              vsmooth)])
    _, vgrid, mined = fmodel._scan_setup(vframes)
    require(torch.equal(mined, vcanvas),
            "phase 6v: the mining canvas is not the checked one")
    vtab = fmodel._get_cascade()[0]
    check_phase("cascade_generic", f"cascade_generic FPGA trainer "
                f"({len(fmodel)} stages in {vtab.n_stages}) batch {BATCH}",
                gen_mod.cascade_response_grid(vcanvas, vtab, (8, 8),
                                              vgrid.valid),
                gen_mod.cascade_response_grid_plain(vcanvas, vtab, (8, 8),
                                                    vgrid.valid))
    del voct, vplanes, vcanvas, mined
    frame = vframes[0]
    with tempfile.TemporaryDirectory() as tmp:
        fpath = os.path.join(tmp, "fpga.pb")
        fmodel.save(fpath)
        reloaded = wt.load(fpath, device=dev)
    before, after = fmodel.detect(frame), reloaded.detect(frame)
    require(np.array_equal(box_rows(before, "scores"),
                           box_rows(after, "scores")),
            "phase 6v: the saved FPGA model detects other boxes")
    print(f"phase 6v: fpga.train {len(fmodel)} stages equal to JAX's, "
          f"launches {fl}; thresholds "
          f"{[st['threshold'].tolist() for st in fmodel.stages]}; save, "
          f"load, detect: {len(after)} boxes, equal")

    # -- phase 6w: the device-pool trainer (config 4b), teacher-forced ------
    zero_counters()
    wmodel, wgen = device_train_golden_run(wt, dev,
                                           np.load(DEVICE_TRAIN_GOLDEN))
    torch.cuda.synchronize()
    wl = read_counters()
    require(all(wl[k] > 0 for k in ("planes", "grad_hist", "cascade_generic")),
            f"phase 6w: config 4b's mining did not run B1, B2 and B6 ({wl})")
    print(f"phase 6w: config 4b {len(wmodel)} stages equal to JAX's, "
          f"launches {wl}")
    # config 4b's mining shapes (a batch of 8 of its 256 x 256 frames, the
    # trained model's tables): B1, B2 and B6 against their plain versions
    # over the whole canvas and grid; the canvas is the one
    # Model.scan_packed_batch mines
    wframes = np.stack([next(wgen)["image"] for _ in range(BATCH)])
    wpacked, wsmooth, wcf = wmodel._plan(wframes.shape[1:])
    wstep = channel_canvas(wpacked, wframes.shape[1:], wsmooth, wcf, dev)
    woct = wstep.octaves(torch.from_numpy(wframes).to(dev))
    wplanes = wstep.planes(woct)
    check_phase("planes", f"planes config 4b {wframes.shape[1:]} batch "
                f"{BATCH}", [wplanes], [plane_mod.planes_plain(
                    woct, wstep.plane_ops)])
    wcanvas = wstep.channels(wplanes)
    check_phase("grad_hist", f"grad_hist smooth={wsmooth} config 4b batch "
                f"{BATCH}", [wcanvas],
                [chan_mod.grad_hist_plain(wplanes, wstep.interior,
                                          wstep.smooth)])
    _, wgrid, mined = wmodel._scan_setup(wframes)
    require(torch.equal(mined, wcanvas),
            "phase 6w: the mining canvas is not the checked one")
    wtab = wmodel._get_cascade()[0]
    check_phase("cascade_generic", f"cascade_generic config 4b "
                f"({len(wmodel)} stages in {wtab.n_stages}) batch {BATCH}",
                gen_mod.cascade_response_grid(wcanvas, wtab,
                                              wmodel.shape[:2], wgrid.valid),
                gen_mod.cascade_response_grid_plain(
                    wcanvas, wtab, wmodel.shape[:2], wgrid.valid))
    del wmodel, woct, wplanes, wcanvas, mined
    # the FPGA options in-step (bank masks, clip, quantizer, integer
    # thresholds), teacher-forced against their own golden; mining runs B5
    zero_counters()
    fdmodel, _ = device_train_golden_run(
        wt, dev, np.load(DEVICE_FPGA_TRAIN_GOLDEN), fpga=True)
    torch.cuda.synchronize()
    fdl = read_counters()
    require(all(fdl[k] > 0 for k in ("planes", "fpga", "cascade_generic")),
            f"phase 6w: FPGA device training did not run B1, B5 and B6 "
            f"({fdl})")
    print(f"phase 6w: FPGA device training {len(fdmodel)} stages equal to "
          f"JAX's, integer thresholds "
          f"{[st['threshold'].tolist() for st in fdmodel.stages]}, features "
          f"in their banks; launches {fdl}")
    # the per-level pyramid on the golden frames (synth_64's options), and
    # wt.detect over synth_64 and hard_64 moved to n_per_oct 4
    hard64 = models["flagship_hard_64"]
    other = wt.model_from_stages(hard64.shape, dict(hard64.channel_opts,
                                                    n_per_oct=4),
                                 hard64.stages, hard64.theta, device=dev)
    t = time.perf_counter()
    pyr = pyramid_checks(wt, dev, gframes, synth, other)
    print(f"phase 6w: pyramid on {len(gframes)} frames (levels, "
          f"scan_channels survivors, mixed wt.detect boxes) {pyr}: card "
          f"equals CPU, scan_channels equals scan_packed "
          f"({time.perf_counter() - t:.1f} s)")

    # -- phase 6c: the image-space canvas (shrink 1, grad_mag) ------------
    # the canvas golden's three cascades on its five VGA frames with the
    # counters set to 0 first: the shrink-1 cascade bitwise JAX's through
    # Model.detect (B4), the batched (B3) and the bucketed (B3) detector,
    # and its mining scan (B6) of the noise frames; the grad_mag and
    # grad_hist+grad_mag cascades within the flip bound; no B1 or B2 (the
    # image-space canvas is plain torch); then each cascade's canvas on
    # the card against its CPU run, bitwise, on a noise frame
    t = time.perf_counter()
    cgold = np.load(CANVAS_GOLDEN)
    cframes = canvas_golden_frames(cgold)
    require(np.array_equal(cframes[:len(gframes)], gframes),
            "the canvas golden's scenes are not the VGA golden's")
    cmodels = {key: wt.load(canvas_model_path(key), device=dev)
               for key in CANVAS_MODELS}
    zero_counters()
    cres = canvas_golden_run(wt, dev, cgold, cframes,
                             list(range(len(cframes))))
    mined = cmodels["s1"].scan_packed_batch(cframes[3:])
    torch.cuda.synchronize()
    canvas_launches = read_counters()
    print(f"phase 6c: image-space path launches: {canvas_launches}")
    require(all(canvas_launches[k] > 0 for k in
                ("cascade", "cascade_response", "cascade_generic")),
            "phase 6c: B3, B4 or B6 was not launched on the shrink-1 path")
    require(canvas_launches["planes"] == canvas_launches["grad_hist"] == 0,
            "phase 6c: the image-space path launched B1 or B2")
    require([len(rs) for rs, _ in mined[3]] == cgold["s1_raw_counts"][
        3:].tolist(), "phase 6c: the mining scan's survivors differ from "
        "the golden")
    for key, model in cmodels.items():
        packed_c, smooth_c, cf_c = model._plan(VGA)
        for floats in (False, True):
            img = torch.from_numpy(cframes[3:4])
            if floats:
                img = img.float() + 0.25
            got = channel_canvas(packed_c, VGA, smooth_c, cf_c, dev)(
                img.to(dev))
            want = channel_canvas(packed_c, VGA, smooth_c, cf_c,
                                  torch.device("cpu"))(img)
            require(torch.equal(got.cpu(), want),
                    f"phase 6c: {key} canvas on the card differs from the "
                    f"CPU's ({'float' if floats else 'uint8'} frame)")
    print(f"phase 6c: (survivors, kept, (flips, boxes)) {cres}: shrink 1 "
          f"bitwise JAX's, grad_mag within {FLIP_BOUND}; canvases equal "
          f"the CPU's ({time.perf_counter() - t:.1f} s)")

    # -- phase 6d: CNN-verified detection -----------------------------------
    # the golden's flax verifier converted; TF32 switched on globally for
    # the phase, and off inside every verifier call (a probe reads the
    # precisions there); detect_and_verify, verify_scores and the fused
    # bucket on the three scenes against the golden
    t = time.perf_counter()
    verifier = golden_verifier(wt, cgold)
    seen, probe = tf32_probe(wt, verifier, dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    vres, verr = verifier_golden_run(wt, dev, cgold, gframes,
                                     list(range(len(gframes))), verifier)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    probe.remove()
    require(full_f32(seen),
            f"phase 6d: TF32 was on inside a verifier call ({seen})")
    print(f"phase 6d: (windows, kept) {vres}: boxes and cascade scores "
          f"bitwise, verified scores within {verr:.3g} of JAX's, TF32 off "
          f"in {len(seen)} calls ({time.perf_counter() - t:.1f} s)")

    # -- phase 7a: verifier training, teacher-forced, dropout off ----------
    # twice from the golden's flax init with TF32 switched on globally:
    # the epoch losses and parameters against JAX's, the two runs bitwise,
    # full float32 inside every forward pass
    t = time.perf_counter()
    clig = np.load(CLI_GOLDEN)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    vruns = [vtrain_golden_run(wt, dev, clig) for _ in range(2)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (vs1, verr, vlerr, vms1, vseen1), (vs2, _, _, vms2, vseen2) = vruns
    require(all(torch.equal(vs1[k], vs2[k]) for k in vs1),
            "phase 7a: two runs of verifier training differ")
    require(full_f32(vseen1 + vseen2),
            f"phase 7a: TF32 was on inside a training pass "
            f"({set(vseen1 + vseen2)})")
    print(f"phase 7a ({card}): verifier training {VTRAIN_KW['epochs']} x "
          f"{VTRAIN_KW['steps']} batches of {VTRAIN_KW['batch_size']}: "
          f"parameters within {verr:.3g} of JAX's (tolerance "
          f"{VTRAIN_PARAM_TOL}), epoch losses within {vlerr:.3g}; two runs "
          f"bitwise; full f32 in {len(vseen1) + len(vseen2)} passes; "
          f"{vms1:.3f} / {vms2:.3f} ms a step "
          f"({time.perf_counter() - t:.1f} s)")
    del vruns, vs1, vs2
    faults = vtrain_planted_faults(wt, dev, clig)
    print(f"phase 7a ({card}): parameters from JAX's with a planted fault: "
          + ", ".join(f"{k} {v:.3g}" for k, v in faults.items())
          + f" (tolerance {VTRAIN_PARAM_TOL})")
    require(min(faults.values()) > VTRAIN_PARAM_TOL,
            f"phase 7a: a planted fault stays inside the tolerance "
            f"{VTRAIN_PARAM_TOL} ({faults})")

    # -- phase 7b: the verifier arm of BASELINE.md round 4 (dropout on) ----
    t = time.perf_counter()
    zero_counters()
    auc_c, auc_v, vsteps, vstages = verifier_arm_run(wt, dev)
    torch.cuda.synchronize()
    arm_launches = read_counters()
    print(f"phase 7b ({card}): {vstages} stages; AUC cascade {auc_c:.4f}, "
          f"verified {auc_v:.4f} (gate {auc_c - VARM_AUC_SLACK:.4f}); "
          f"verifier {vsteps:.1f} steps/s; launches {arm_launches} "
          f"({time.perf_counter() - t:.1f} s)")
    require(all(arm_launches[k] > 0 for k in ("planes", "grad_hist",
                                              "cascade_response",
                                              "cascade_generic")),
            "phase 7b: training, evaluation or detect_and_verify did not "
            "run B1, B2, B4 and B6")

    # -- phase 7c: the CLI's train, in-process -----------------------------
    with tempfile.TemporaryDirectory() as tmp:
        for key in CLI_TRAIN_RUNS:
            t = time.perf_counter()
            zero_counters()
            rate = cli_train_golden_run(wt, dev, clig, tmp, key)
            torch.cuda.synchronize()
            cl = read_counters()
            chans = "fpga" if key == "fpga" else "grad_hist"
            print(f"phase 7c ({card}): CLI train {key}: model and JSON "
                  f"equal to JAX's, {rate:.1f} stages/min, launches {cl} "
                  f"({time.perf_counter() - t:.1f} s)")
            require(all(cl[k] > 0 for k in ("planes", chans,
                                            "cascade_generic")),
                    f"phase 7c: CLI train {key} did not run B1, "
                    f"{'B5' if key == 'fpga' else 'B2'} and B6")
        t = time.perf_counter()
        zero_counters()
        stages = cli_bbgt_run(wt, dev, tmp)
        torch.cuda.synchronize()
        print(f"phase 7c ({card}): CLI train on a bbGt directory through "
              f"the native loader: {stages} stages, the model loads; "
              f"launches {read_counters()} "
              f"({time.perf_counter() - t:.1f} s)")

        # -- phase 7d: the CLI's detect, in-process -------------------------
        paths = write_cli_frames(tmp)
        for n_models, want in ((1, ("planes", "grad_hist", "cascade")),
                               (2, ("planes", "grad_hist",
                                    "cascade_response"))):
            t = time.perf_counter()
            zero_counters()
            res = cli_detect_golden_run(dev, clig, paths, n_models)
            torch.cuda.synchronize()
            dl = read_counters()
            require(all(dl[k] > 0 for k in want),
                    f"phase 7d: CLI detect with {n_models} model(s) did not "
                    f"launch {want} ({dl})")
            t1 = time.perf_counter()
            cli_output(cli_mod.detect_main,
                       cli_detect_args(n_models, paths, dev))
            fps = len(paths) / (time.perf_counter() - t1)
            print(f"phase 7d ({card}): CLI detect, {n_models} model(s), "
                  f"{len(paths)} VGA scenes: {[len(r['boxes']) for r in res]}"
                  f" boxes, {'JSON' if n_models == 1 else 'rows'} equal to "
                  f"JAX's; launches {dl}; {fps:.1f} frames/s after a warm "
                  f"call ({time.perf_counter() - t:.1f} s)")

    # -- phase 7e: single-scale serving (config 1), n_scales ---------------
    t = time.perf_counter()
    zero_counters()
    ns_dets, ns_counts = n_scales_golden_run(wt, dev, clig)
    torch.cuda.synchronize()
    nl = read_counters()
    print(f"phase 7e ({card}): n_scales runs bitwise JAX's, survivors "
          f"{ns_counts}; launches {nl} ({time.perf_counter() - t:.1f} s)")
    require(all(nl[k] > 0 for k in ("planes", "grad_hist", "cascade")),
            "phase 7e: single-scale serving did not run B1, B2 and B3")
    # profiling.Meter: config 1 served single-scale on noise batches, and
    # its Model.detect (the full pyramid, B4) on the coarse frames, whose
    # cascade counters the report gives
    det_c1 = ns_dets[N_SCALES_RUNS[0][:2] + (N_SCALES_RUNS[0][3],)]
    c1 = wt.load(os.path.join(ROOT, "models", N_SCALES_RUNS[0][0] + ".pb"),
                 device=dev)
    coarse = dict(n_scales_frames())["coarse"]
    meter = Meter()
    for r in range(10):
        with meter.phase("config1_single_scale", items=BATCH,
                         pixels=noise[r % 4].numel(), block_on=noise):
            det_c1(noise[r % 4])
    for im in coarse:
        with meter.phase("config1_model_detect", items=1, pixels=im.size):
            c1.detect(im)
    meter.note_model(c1, N_SCALES_RUNS[0][0])
    print(f"phase 7e profiling.Meter ({card}):\n{meter.report()}")

    # -- phase 5: timing and the host --------------------------------------
    timing = {}
    ops_synth = synth._operands(dev)
    casc_synth = tables["flagship_synth_64"][0]
    calls = {
        "planes": (lambda: cstep.planes(octs),
                   lambda: plane_mod.planes_plain(octs, cstep.plane_ops)),
        "grad_hist": (lambda: cstep.channels(planes),
                      lambda: chan_mod.grad_hist_plain(planes, cstep.interior,
                                                       cstep.smooth)),
        "cascade": (lambda: det.cascade(canvas),
                    lambda: casc_mod.cascade_masked_plain(
                        canvas, grid.valid, det.cascade_ops)),
        "cascade_response": (
            lambda: casc_mod.cascade_response(canvas, grid.valid, ops_synth),
            lambda: casc_mod.cascade_response_plain(canvas, grid.valid,
                                                    ops_synth)),
        "cascade_generic": (
            lambda: gen_mod.cascade_response_grid(canvas, casc_synth,
                                                  (12, 12), grid.valid),
            lambda: gen_mod.cascade_response_grid_plain(
                canvas, casc_synth, (12, 12), grid.valid)),
    }
    # B3 on GENERAL node records: the seeded 40-stage depth-5 model
    ops_deep = deep._operands(dev)
    calls["cascade_deep40"] = (
        lambda: casc_mod.cascade_masked(canvas, grid.valid, ops_deep),
        lambda: casc_mod.cascade_masked_plain(canvas, grid.valid, ops_deep))
    name0, name1 = FPGA_MODELS
    calls.update({
        "fpga": (lambda: c5[name0].channels(planes4k),
                 lambda: fpga_mod.fpga_channels_plain(
                     planes4k, c5[name0].ring, None, c5[name0].cf.fused_kind,
                     0)),
        "fpga_smooth": (lambda: c5[name1].channels(planes4k),
                        lambda: fpga_mod.fpga_channels_plain(
                            planes4k, c5[name1].ring, c5[name1].interior,
                            c5[name1].cf.fused_kind, 1)),
        "cascade_c5": (lambda: det5.cascade(canvas4k[name0]),
                       lambda: casc_mod.cascade_masked_plain(
                           canvas4k[name0], det5.grid.valid,
                           det5.cascade_ops)),
        "cascade_response_c5": (
            lambda: casc_mod.cascade_response(canvas4k[name0],
                                              det5.grid.valid,
                                              det5.cascade_ops),
            lambda: casc_mod.cascade_response_plain(
                canvas4k[name0], det5.grid.valid, det5.cascade_ops)),
        "planes_4k": (lambda: cs0.planes(octs4k),
                      lambda: plane_mod.planes_plain(octs4k, cs0.plane_ops)),
        "planes_1080p": (lambda: cs1080.planes(octs1080),
                         lambda: plane_mod.planes_plain(octs1080,
                                                        cs1080.plane_ops)),
        "grad_hist_1080p": (lambda: cs1080.channels(planes1080),
                            lambda: chan_mod.grad_hist_plain(
                                planes1080, cs1080.interior, 1)),
        "grad_hist_1080p_smooth0": (
            lambda: chan_mod.grad_hist(planes1080, None, 0),
            lambda: chan_mod.grad_hist_plain(planes1080, None, 0)),
        "cascade_fast": (
            lambda: casc_mod.cascade_masked(fcv, grid.valid, ops_synth),
            lambda: casc_mod.cascade_masked_plain(fcv, grid.valid,
                                                  ops_synth)),
    })
    # B2d at VGA smooth 1 on the float noise frames' planes
    calls["grad_hist_float"] = (
        lambda: chan_mod.grad_hist_float(xplanes["noise"], cstep.interior, 1),
        lambda: chan_mod.grad_hist_float_plain(xplanes["noise"],
                                               cstep.interior, 1))
    # B2f at VGA smooth 1 on each plane type (uint8: the main path's)
    for kind, p in fplanes.items():
        name = "grad_hist_fast" + ("" if kind == "uint8" else f"_{kind}")
        calls[name] = ((lambda p: lambda: chan_mod.grad_hist_fast(
            p, cstep.interior, 1))(p),
            (lambda p: lambda: chan_mod.grad_hist_fast_plain(
                p, cstep.interior, 1))(p))
    big_calls = ("fpga", "fpga_smooth", "cascade_c5", "cascade_response_c5",
                 "planes_4k", "planes_1080p", "grad_hist_1080p",
                 "grad_hist_1080p_smooth0")
    for name, (kern, plain) in calls.items():
        # plain, kernel, kernel, plain: both orders inside one call
        big = name in big_calls
        p1 = cuda_ms(plain, 1 if big else 3)
        k1 = cuda_ms(kern, 10 if big else 20)
        k2 = cuda_ms(kern, 10 if big else 20)
        p2 = cuda_ms(plain, 1 if big else 3)
        timing[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        metric(f"{name}_kernel_us_per_image", timing[name][0] * 1e3 / BATCH,
               "us/image")
        metric(f"{name}_plain_us_per_image", timing[name][1] * 1e3 / BATCH,
               "us/image")

    # the least time of each kernel's call at these shapes: bytes (each
    # input read once, each output written once) over the HBM rate, or its
    # arithmetic over the peak rate of its type
    def planes_bound(pt, o, p):
        elems = pt.host.meta[:, META_COLS.index("elems")]
        return bound(nbytes(o, p, pt.tiles, pt.pieces, pt.rtap, pt.ctap),
                     f32_ops=12 * int(elems.sum()) * BATCH)

    def grad_hist_bound(p, mask, cv):
        return bound(nbytes(p, mask, cv), f32_ops=35 * cv.numel(),
                     f64_ops=12 * cv.numel())

    def grad_hist_float_bound(p, mask, cv):
        # per pooled pixel and image, from the kernel: 13 f64 prefilters
        # (3 operations and a rounding to f32 each), 12 projections (3
        # operations and a rounding each; bin 0 is |gx|), 10 plane elements
        # widened (an f64 multiply each): 85 f64 operations and 25
        # conversions; in f32 the gradient differences, the pool and the
        # smooth (64); the smooth's tile recomputes 16 pooled rows for 14
        rows = 16 / 14 if mask is not None else 1.0
        n = rows * cv.numel() / 4
        return bound(nbytes(p, mask, cv), f32_ops=64 * cv.numel() / 4,
                     f64_ops=85 * n, conversions=25 * n)

    def grad_hist_fast_bound(p, mask, cv):
        # B2's operations, the projections in f32
        return bound(nbytes(p, mask, cv), f32_ops=47 * cv.numel())

    def records(tab, cv):
        return tab.records(tuple(cv.shape[1:])).data

    nw_synth = int(casc_mod.cascade_response(canvas, grid.valid,
                                             ops_synth)[2].sum())
    resp_out = BATCH * grid.valid.numel() * 5 + 4 * BATCH
    bounds = {
        "planes": planes_bound(cstep.plane_ops, octs, planes),
        "grad_hist": grad_hist_bound(planes, cstep.interior, canvas),
        "planes_1080p": planes_bound(cs1080.plane_ops, octs1080, planes1080),
        "grad_hist_1080p": grad_hist_bound(planes1080, cs1080.interior,
                                           canvas1080[1]),
        "grad_hist_1080p_smooth0": grad_hist_bound(planes1080, None,
                                                   canvas1080[0]),
        "cascade": bound(nbytes(canvas, grid.valid, *casc,
                                records(det.cascade_ops, canvas)),
                         f32_ops=4 * int(casc[1].sum())),
        "cascade_response": bound(nbytes(canvas, grid.valid,
                                         records(ops_synth, canvas))
                                  + resp_out, f32_ops=4 * nw_synth),
        "cascade_generic": bound(nbytes(canvas, grid.valid,
                                        records(casc_synth, canvas))
                                 + resp_out, f32_ops=4 * nw_synth),
        "planes_4k": planes_bound(cs0.plane_ops, octs4k, planes4k),
    }
    for kind, p in fplanes.items():
        name = "grad_hist_fast" + ("" if kind == "uint8" else f"_{kind}")
        bounds[name] = grad_hist_fast_bound(p, cstep.interior, fcanvas[kind])
    bounds["grad_hist_float"] = grad_hist_float_bound(
        xplanes["noise"], cstep.interior, xcanvas["noise"])
    casc_fast = casc_mod.cascade_masked(fcv, grid.valid, ops_synth)
    bounds["cascade_fast"] = bound(
        nbytes(fcv, grid.valid, *casc_fast, records(ops_synth, fcv)),
        f32_ops=4 * int(casc_fast[1].sum()))
    casc_deep = casc_mod.cascade_masked(canvas, grid.valid, ops_deep)
    bounds["cascade_deep40"] = bound(
        nbytes(canvas, grid.valid, *casc_deep, records(ops_deep, canvas)),
        f32_ops=4 * int(casc_deep[1].sum()))
    # B5: integer work counted at the f32 rate, per pooled pixel the four
    # Sobel pairs (56 operations) and per channel the four responses,
    # quantizations, selects and the wrap pool (25), plus the smooth (18)
    n_pix = BATCH * det5.packed.canvas_h * det5.packed.canvas_w
    n_out = c5[name0].cf.n_channels
    canvas5 = canvas4k[name0]
    bounds["fpga"] = bound(nbytes(planes4k, c5[name0].ring, canvas5),
                           f32_ops=n_pix * (56 + 25 * n_out))
    bounds["fpga_smooth"] = bound(
        nbytes(planes4k, c5[name1].ring, c5[name1].interior, canvas5),
        f32_ops=n_pix * (56 + 43 * n_out))
    bounds["cascade_c5"] = bound(nbytes(canvas5, det5.grid.valid, *casc5,
                                        records(det5.cascade_ops, canvas5)),
                                 f32_ops=4 * int(casc5[1].sum()))
    nw5 = int(casc_mod.cascade_response(canvas5, det5.grid.valid,
                                        det5.cascade_ops)[2].sum())
    bounds["cascade_response_c5"] = bound(
        nbytes(canvas5, det5.grid.valid, records(det5.cascade_ops, canvas5))
        + BATCH * det5.grid.valid.numel() * 5 + 4 * BATCH,
        f32_ops=4 * nw5)
    # B2d's instruction floor: its f64 operations and conversions on one
    # pipe, one after the other (the bound takes the larger alone)
    xcv = xcanvas["noise"]
    n_px = 16 / 14 * xcv.numel() / 4
    metric("grad_hist_float_instruction_floor_us_per_image",
           (85 * n_px / F64_INSTR_S + 25 * n_px / CONV_S) * 1e6 / BATCH,
           "us/image")
    for cname, cv in (("noise", fcv), ("scene", fcv_scene)):
        got = casc_mod.cascade_masked(cv, grid.valid, ops_synth)
        least = bound(nbytes(cv, grid.valid, *got, records(ops_synth, cv)),
                      f32_ops=4 * int(got[1].sum()))[0]
        # from a CUDA graph of the calls: no host time
        new_ms = graph_ms(lambda: casc_mod.cascade_masked(
            cv, grid.valid, ops_synth), 20)
        metric(f"cascade_fast_{cname}_graph_kernel_us_per_image",
               new_ms * 1e3 / BATCH, "us/image")
        metric(f"cascade_fast_{cname}_bound_us_per_image",
               least * 1e3 / BATCH, "us/image")
        plain_ms = cuda_ms(lambda: casc_mod.cascade_masked_plain(
            cv, grid.valid, ops_synth), 2)
        metric(f"cascade_fast_{cname}_plain_us_per_image",
               plain_ms * 1e3 / BATCH, "us/image")
        print(f"cascade_fast {cname} ({card}): bound {least:.5f} ms; from "
              f"a CUDA graph {new_ms:.4f} ms, at {least / new_ms:.3f} of the "
              f"bound; plain version {plain_ms:.4f} ms")
    for name, (ms, what) in bounds.items():
        metric(f"{name}_bound_us_per_image", ms * 1e3 / BATCH, "us/image")
        print(f"{name}: bound by {what}; kernel at "
              f"{bounds[name][0] / timing[name][0]:.3f} of its bound")
    # the 1080p tensors are not part of the serving paths measured below
    del calls, cs1080, noise1080, octs1080, planes1080, canvas1080

    # per-layer device time on the noise batch (k=1024 detector, and the
    # config-5 smooth-0 k=128 detector); the extraction is timed with and
    # without the NMS that follows it
    for prefix, d, cs, imgs, o, p, cv, (mk, _, cnt) in (
            ("", det, cstep, noise[1], octs, planes, canvas, casc),
            ("c5_", det5, c5[name0], noise4k[1], octs4k, planes4k, canvas5,
             casc5)):
        g = d.grid
        layers = {
            "octaves": lambda: cs.octaves(imgs),
            "planes": lambda: cs.planes(o),
            "channels": lambda: cs.channels(p),
            "cascade": lambda: d.cascade(cv),
            "extract": lambda: extract_detections(
                mk, cnt, g.level_id, g.offsets, g.inv_scales, d.window, d.k),
            "extract_nms": lambda: d.extract(mk, cnt),
        }
        for name, fn in layers.items():
            metric(f"{prefix}layer_{name}_us_per_image",
                   cuda_ms(fn, 10 if not prefix else 3) * 1e3 / BATCH,
                   "us/image")

    def e2e(workload, fn_, batches, reps=60):
        """Host clock per batch call, each ending in a synchronize."""
        mps, med, p80 = batch_rate(fn_, batches, reps)
        metric(f"{workload}_mp_per_s", mps, "MP/s")
        metric(f"{workload}_batch_ms_p50", med, "ms")
        metric(f"{workload}_batch_ms_p80", p80, "ms")
        print(f"{workload}: {reps} batches of {BATCH}")

    det128, _ = wt.make_batched_detector_boxes(synth, VGA, k=128,
                                               nms_iou=0.5, device=dev)
    workloads = {
        "vga_single_scale_noise_k128": (det_c1, noise),
        "vga_full_pyramid_noise_k128": (det128, noise),
        "vga_full_pyramid_scene_k1024": (det, [scene,
                                               torch.flip(scene, dims=[2])]),
    }
    torch.cuda.reset_peak_memory_stats(dev)
    for workload, (fn_, batches) in workloads.items():
        e2e(workload, fn_, batches)
    metric("peak_device_memory_mib",
           torch.cuda.max_memory_allocated(dev) / 2 ** 20, "MiB")
    e2e("batched_detector_vga_scene", fn_full,
        [scene, torch.flip(scene, dims=[2])], reps=30)
    # fast serving mode: uint8 frames (B1, B2f, B3f) and float32 frames
    # (f32 octaves, float planes, B2f, B3f), 30 batches each
    fast128 = {ff: wt.make_batched_detector_boxes(
        synth, VGA, k=128, nms_iou=0.5, device=dev, fast=True,
        fast_float=ff)[0] for ff in ("f32", "bf16")}
    fast_workloads = {
        "vga_fast_noise_k128": (fast128["f32"], noise),
        "vga_fast_scene_k1024": (fast_dets["f32"],
                                 [scene, torch.flip(scene, dims=[2])]),
        "vga_float_fast_f32_noise_k128": (fast128["f32"], noise_f),
        "vga_float_fast_bf16_noise_k128": (fast128["bf16"], noise_f),
    }
    for workload, (fn_, batches) in fast_workloads.items():
        e2e(workload, fn_, batches, reps=30)
    # exact float frames: f32 octaves, the float64 plane build (plain
    # torch, timed alone too), B2d, B3
    metric("planes_float_us_per_image",
           cuda_ms(lambda: plane_mod.planes_float(octs_f,
                                                  cstep.float_plane_ops),
                   5) * 1e3 / BATCH, "us/image")
    float_workloads = {
        "vga_float_exact_noise_k128": (det128, noise_f),
        "vga_float_exact_scene_k1024": (det, [scene_f,
                                              torch.flip(scene_f, dims=[2])]),
    }
    for workload, (fn_, batches) in float_workloads.items():
        e2e(workload, fn_, batches, reps=30)
    # bucketed serving: a mixed stream of the bucket golden's four sizes,
    # 8 frames of each (the frame and its flips), numpy frames in and
    # boxes out through BucketedDetector.detect_many (host clock)
    stream = [np.ascontiguousarray(v) for f in bframes
              for v in (f, f[:, ::-1], f[::-1], f[::-1, ::-1])] * 2
    stream_mp = sum(f.size for f in stream) / 1e6
    bdet.detect_many(stream)
    torch.cuda.synchronize()
    bms = []
    for _ in range(5):
        t = time.perf_counter()
        bdet.detect_many(stream)
        torch.cuda.synchronize()
        bms.append((time.perf_counter() - t) * 1e3)
    metric("bucketed_mixed_stream_mp_per_s", stream_mp * 5 / sum(bms) * 1e3,
           "MP/s")
    metric("bucketed_mixed_stream_ms_p50", float(np.median(bms)), "ms")
    print(f"bucketed mixed stream ({card}): {len(stream)} frames of "
          f"{len(BUCKET_SIZES)} sizes, {stream_mp:.3f} MP a call, 5 calls")
    # first sight of a novel size: Model.detect (packer, tables, run)
    # against BucketedDetector in a bucket it has set up (tables, run),
    # each beside its second call at that size
    firsts = {"model_detect": [], "bucketed": []}
    warms = {"model_detect": [], "bucketed": []}
    for h, w in NOVEL_SIZES:
        frame = np.ascontiguousarray(gframes[1][:h, :w])
        for name, fn_ in (("bucketed", bdet.detect),
                          ("model_detect", synth.detect)):
            for rec in (firsts, warms):
                t = time.perf_counter()
                fn_(frame)
                torch.cuda.synchronize()
                rec[name].append((time.perf_counter() - t) * 1e3)
    for name in firsts:
        metric(f"first_sight_{name}_ms", float(np.mean(firsts[name])), "ms")
        metric(f"second_call_{name}_ms", float(np.mean(warms[name])), "ms")
        print(f"first sight {name} ({card}): "
              f"{[round(v, 3) for v in firsts[name]]} ms, second call "
              f"{[round(v, 3) for v in warms[name]]} ms")
    # the image-space canvas: the shrink-1 cascade's batched detector
    # (k=1024, NMS 0.5) on noise (its survivors) and scenes, the grad_mag
    # and composite ones on noise, 30 batches of 8 each; the canvas step
    # of each alone (octaves, the resize, the channels; CUDA events)
    for key, model in cmodels.items():
        cdet, _ = wt.make_batched_detector_boxes(model, VGA, k=1024,
                                                 nms_iou=0.5, device=dev)
        e2e(f"vga_{key}_noise_k1024", cdet, noise, reps=30)
        if key == "s1":
            e2e("vga_s1_scene_k1024", cdet, [scene, torch.flip(scene,
                                                               dims=[2])],
                reps=30)
        cstep_c = cdet.canvas
        octs_c = cstep_c.octaves(noise[0])
        img_c = cstep_c.planes(octs_c)
        for name, fn_ in (("canvas", lambda: cstep_c(noise[0])),
                          ("resize", lambda: cstep_c.planes(octs_c)),
                          ("channels", lambda: cstep_c.channels(img_c))):
            metric(f"image_canvas_{key}_{name}_us_per_image",
                   cuda_ms(fn_, 10) * 1e3 / BATCH, "us/image")
        del cdet, cstep_c, octs_c, img_c
    # verified detection: the flagship's bucket program at VGA with the
    # verifier fused (k=1024, NMS 0.5) on the scene batches, and the
    # verifier alone on 1024 windows of a scene's canvas
    vfn, _ = wt.parallel.detect.make_bucket_detector_boxes(
        synth, VGA, k=1024, nms_iou=0.5, verifier=verifier, device=dev)
    vgeom = vfn.geometry(VGA)
    e2e("vga_verified_scene_k1024", lambda b: vfn(b, vgeom),
        [scene, torch.flip(scene, dims=[2])], reps=30)
    vcanvas = synth.scan_packed(gframes[1])[0]
    vrng = np.random.RandomState(3)
    gu_v, gv_v = (s_ - 12 for s_ in vcanvas.shape[1:])
    vwins = synth.gather_windows_device(
        vcanvas, vrng.randint(0, gu_v, 1024), vrng.randint(0, gv_v, 1024),
        is_canvas=True, as_device=True)[0]
    vprog = wt.verification.get_verifier_program(*verifier, dev)
    vzero = torch.zeros(1024, device=dev)
    metric("verifier_ms_per_1024_windows",
           cuda_ms(lambda: vprog(vwins, vzero), 20), "ms")
    del vfn, vgeom, vcanvas, vwins
    # config 5 as bench.py runs it: k=128, NMS 0.5, uniform noise
    workloads5 = {"fpga_4k_quantized_k128": (dets4k[name0], noise4k),
                  "fpga_4k_smooth_k128": (dets4k[name1], noise4k)}
    torch.cuda.reset_peak_memory_stats(dev)
    for workload, (fn_, batches) in workloads5.items():
        e2e(workload, fn_, batches, reps=20)
    metric("c5_peak_device_memory_mib",
           torch.cuda.max_memory_allocated(dev) / 2 ** 20, "MiB")

    def per_frame(name, fn_, n=30):
        """Host clock per call on one numpy frame, p50 over ``n`` frames
        (the scene batch's frames in turn); each call returns host data."""
        fn_(scene_np[0])
        ms = []
        for r in range(n):
            t = time.perf_counter()
            fn_(scene_np[r % BATCH])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        metric(f"{name}_ms_per_frame_p50", float(np.median(ms)), "ms")

    # config 4 as bench.py times it: 2 warm stages, then 6 timed stages
    # (host clock; a callback stamps each stage's end)
    tmodel = wt.Model(TRAIN_SHAPE, TRAIN_OPTS, device=dev)
    tgen = fake_data_generator(seed=TRAIN_SEED)
    tpool = wt.SamplePool(min_tp=TRAIN_POOL, min_fp=TRAIN_POOL, seed=0)
    tlearner = wt.Learner(alpha=TRAIN_ALPHA, max_depth=TRAIN_DEPTH)

    def train_to(length, **kw):
        wt.train(tmodel, tgen, pool=tpool, learner=tlearner, length=length,
                 **kw)
        torch.cuda.synchronize()

    train_to(2)
    stamps = []
    zero_counters()
    t = time.perf_counter()
    train_to(8, callbacks=[lambda *a: stamps.append(time.perf_counter())])
    dt = time.perf_counter() - t
    per_stage = np.diff([t] + stamps) * 1e3
    tl = read_counters()
    metric("train_config4_stages_per_min", 6 / dt * 60.0, "stages/min")
    print(f"config 4 timed stages 2-7 ({card}): "
          f"{per_stage.round(3).tolist()} ms; launches per stage: B1 "
          f"{tl['planes'] / 6}, B2 {tl['grad_hist'] / 6}, B6 "
          f"{tl['cascade_generic'] / 6}; fpr "
          f"{tlearner.false_positive_rate:.5f}")
    config4_rate = 6 / dt * 60.0

    # config 4b as bench.py times it (bench_train_loop_device_pool): a warm
    # call to 2 stages, then 12 timed stages (host clock; a callback stamps
    # each stage's end), one pools dict
    from waldboost_tpu_torch.io import prefetch_iterable
    from waldboost_tpu_torch.parallel.trainer import train_sharded
    bmodel = wt.Model(TRAIN_SHAPE, TRAIN_OPTS, device=dev)
    bgen = prefetch_iterable(fake_data_generator(seed=TRAIN_SEED),
                             depth=DEVICE_TRAIN_PREFETCH)
    blearner = wt.Learner(alpha=TRAIN_ALPHA, max_depth=TRAIN_DEPTH)
    bpools = {}

    def train_b(length, **kw):
        train_sharded(bmodel, bgen, learner=blearner, length=length,
                      min_tp=TRAIN_POOL, min_fp=TRAIN_POOL,
                      seed=DEVICE_TRAIN_SEED, pools=bpools, **kw)
        torch.cuda.synchronize()

    train_b(DEVICE_TRAIN_WARM)
    stamps = []
    zero_counters()
    t = time.perf_counter()
    train_b(DEVICE_TRAIN_WARM + 12,
            callbacks=[lambda *a: stamps.append(time.perf_counter())])
    dt = time.perf_counter() - t
    per_stage = np.diff([t] + stamps) * 1e3
    bl = read_counters()
    metric("train_config4b_stages_per_min", 12 / dt * 60.0, "stages/min")
    print(f"config 4b timed stages 2-13 ({card}): "
          f"{per_stage.round(3).tolist()} ms; launches per stage: B1 "
          f"{bl['planes'] / 12}, B2 {bl['grad_hist'] / 12}, B6 "
          f"{bl['cascade_generic'] / 12}; fpr "
          f"{blearner.false_positive_rate:.5f}")
    print(f"training ({card}): config 4b {12 / dt * 60.0:.1f} stages/min, "
          f"config 4 {config4_rate:.1f} stages/min in the same run")

    per_frame("model_detect_synth64", synth.detect)
    per_frame("model_detect_hard256", hard256.detect)
    per_frame("wt_detect_three_models",
              lambda f: wt.detect(f, *models.values(), response_scale=scales))
    print(f"host: {len(os.sched_getaffinity(0))} usable cores, load "
          f"average {os.getloadavg()}")
    for name, value in host_probe().items():
        metric(name, value, "ms" if name.endswith("_ms") else "us")

    # -- phase 6: profiler trace of each serving workload ------------------
    from torch.profiler import ProfilerActivity, profile, record_function
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="wb_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    traced_fast = {k: fast_workloads[k] for k in (
        "vga_fast_scene_k1024", "vga_float_fast_bf16_noise_k128")}
    n_traced = dict.fromkeys(workloads, 10)
    n_traced.update(dict.fromkeys(traced_fast, 10))
    n_traced.update(dict.fromkeys(workloads5, 3))
    for workload, (fn_, batches) in {**workloads, **traced_fast,
                                     **workloads5}.items():
        trace_workload(workload, fn_, batches, n_traced[workload], metric,
                       trace_dir if args.trace_dir else None)
    # config 4: 6 more stages traced in one train call; a callback closes
    # each stage's span at the stage's end and opens the next one
    stage_span = []

    def next_stage(*_):
        if stage_span:
            stage_span.pop().__exit__(None, None, None)
        stage_span.append(record_function("smoke.stage"))
        stage_span[0].__enter__()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke.window"):
            next_stage()
            train_to(14, callbacks=[next_stage])
            stage_span.pop().__exit__(None, None, None)
    path = os.path.join(trace_dir, "train_config4.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    if args.trace_dir is None:
        os.remove(path)
    bd = report_trace(trace, f"train_config4 ({card}): 6 stages in")
    if bd["n_device_events"]:
        metric("train_config4_device_idle_share", bd["idle_share"], "1")
    # the last span holds only the end of the train call
    for i, split in enumerate(stage_splits(trace, "smoke.stage")[:6]):
        print(f"train stage {8 + i} split (host ms, {card}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items()))

    # config 4b: 6 more stages traced in one train_sharded call, stage
    # spans as above; the bytes each stage copies each way
    b0 = len(bmodel)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke.window"):
            next_stage()
            train_b(b0 + 6, callbacks=[next_stage])
            stage_span.pop().__exit__(None, None, None)
    path = os.path.join(trace_dir, "train_config4b.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    if args.trace_dir is None:
        os.remove(path)
    bd = report_trace(trace, f"train_config4b ({card}): 6 stages in")
    require(bd["n_device_events"] > 0, "config 4b: the profiler recorded no "
            "device events")
    metric("train_config4b_device_idle_share", bd["idle_share"], "1")
    for i, split in enumerate(stage_splits(trace, "smoke.stage")[:6]):
        print(f"train 4b stage {b0 + i} split (host ms, {card}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    copies, n_unmatched = stage_memcpy(trace, "smoke.stage")
    x_bytes = 2048 * TRAIN_SHAPE[0] * TRAIN_SHAPE[1] * TRAIN_SHAPE[2] * 4
    for i, rec in enumerate(copies[:6]):
        print(f"train 4b stage {b0 + i} copies ({card}): host-to-device "
              f"{rec['h2d']} B, device-to-host {rec['d2h']} B, on the "
              f"device {rec['d2d']} B, largest {rec['largest']} B"
              + (", mined" if rec["mined"] else ""))
        require(rec["largest"] < x_bytes,
                f"config 4b stage {b0 + i}: a pool's samples crossed")
        if not rec["mined"]:
            require(rec["d2h"] <= 256 * 1024 and rec["h2d"] <= 64 * 1024,
                    f"config 4b stage {b0 + i} (no mining) copied more than "
                    f"256 KB to the host or 64 KB to the device")
    require(len(copies) >= 6 and any(not r["mined"] for r in copies[:6]),
            "config 4b: the trace holds no stage without mining")
    print(f"trace train_config4b: {n_unmatched} copies not matched to a "
          f"launch")
    if args.trace_dir is None:
        os.rmdir(trace_dir)

    # -- phases 8a-8f: several devices and processes ------------------------
    mesh_path_launches = mesh_phases(wt, dev, card, metric, zero_counters,
                                     read_counters, synth, scene_np, golden,
                                     fastg)
    print(f"mesh path launches (4 shards on one card): "
          f"{json.dumps(mesh_path_launches)}")

    # -- phases 9a-9d: two-phase and row-wise serving, S1 and S2 ------------
    tp_launches, tp_errs, tp_timing, tp_bounds = twophase_phases(
        wt, dev, card, metric, zero_counters, read_counters, synth, noise,
        scene, scene_np)
    errs.update(tp_errs)
    timing.update(tp_timing)
    bounds.update(tp_bounds)

    # -- phases 10a-10d: user channel functions, the per-level canvas -----
    per_level_launches = channel_phases(wt, dev, card, metric,
                                        zero_counters, read_counters, synth,
                                        noise, scene)
    print(f"per-level path launches (VGA noise batch): "
          f"{json.dumps(per_level_launches)}")

    # -- phase 11: S3 at the serving paths' candidate sets ----------------
    errs["nms"], timing["nms"], bounds["nms"] = nms_phase(
        wt, dev, card, metric, zero_counters, read_counters, synth, scene,
        noise[0])

    # -- phase 12: S4 at the cells' frames ------------------------------
    errs["octaves"], timing["octaves"], bounds["octaves"] = octaves_phase(
        wt, dev, card, metric, zero_counters, read_counters, synth)

    print(f"chip_smoke wall time: {time.perf_counter() - started:.1f} s "
          f"({card})")
    # launches: the Model-API path's (S2's among them: the dense
    # extraction; S3's: its NMS), B5's from the config-5 path, B2f's and
    # B3f's from the fast serving path, S1's from the two-phase path
    launches = dict(path_launches, fpga=fpga_launches["fpga"],
                    grad_hist_fast=fast_launches["grad_hist_fast"],
                    cascade_fast=fast_launches["cascade_fast"],
                    grad_hist_float=float_launches["grad_hist_float"],
                    cascade_suffix=tp_launches["cascade_suffix"])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timing[name][0], "plain_ms": timing[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": timing[name][2] if len(timing[name]) > 2 else None}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
