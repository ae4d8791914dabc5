#!/usr/bin/env python3
"""Smoke run of coma_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. Device: the card's name, the device count, and ``nvidia-smi``'s name and
   power limit.
2. Kernels: build the CUDA kernels from ``coma_tpu_torch/csrc/`` (one
   ``nvcc`` per source, started together; the compiler's registers and
   spills, the bf16 attention kernel's dynamic shared memory per head dim,
   and its count of ``wgmma`` (HGMMA) and TMA-load (UTMALDG) instructions in
   the compiled code are printed), then hold K1 and K2 against their plain
   PyTorch version on the card — K1 (contact splat) at the qual
   (10475x180x250), object-contact (1000x1500x250) and quant:full
   (750x2048x250) shapes, K2 (occupancy hits) at H=10475, R=30 — with a
   batch the slab does not divide, a padded slot, a zero normal and a pair on
   the singular branch. K1 tolerance: |kernel - plain| <= 1e-5 + 1e-4 |plain|
   (the kernel splats with the TPU kernel's theta^2 polynomial where sigma
   gives one, <= ~3e-7 from the exact splat, and forms t = 1 - c.g with
   fused multiply-adds); K2: equal hit counts. At the qual shape the contact
   map and the min-max-normalised orientation score of the two states are
   held against each other too (within 1e-4 of the map's maximum, within
   1e-3). Then, at the main path's slab of 32 samples, each K1 shape's
   route (polynomial or exact), the share of (h, o, sample, direction,
   patch) groups the warp-skip mask keeps, the kernel's time, the plain
   version's and the bound; K2 on a slab of i.i.d. Gaussian vertices: equal hits, its
   time, the share of tests its brick cull keeps and of accumulator elements
   it touches, and the bound of that work beside the dense bound. First, the
   host's time to make K1's splat plan for the 250-point grid (the first
   call in a process: the fit and the patch partition; then a second call).
   A kernel's time is its device time alone (``torch.profiler``); the
   wrapper's whole call, timed by CUDA events, is printed beside it.
3. Extraction: a synthetic results tree made from a numpy seed (a 10475-vertex
   human surface, 64 posed samples, a 180-point / 1500-vertex backpack) goes
   through ``coma_tpu_torch.cli.extract_coma`` at ``qual:backpack_human_contact``
   and ``qual:backpack_occupancy``. Before it, K2 runs on the tree's first 32
   posed samples as the extraction prepares them (equal hits, time, kept
   share, touched share, bounds: the main path's data). The launch counters
   are set to 0 just before the extraction and read just after; each kernel
   must have launched.
4. Inference: ``coma_tpu_torch.cli.inference`` for all four products; the
   outputs must be finite with maxima 1.0 (contact, orientation) or 0.7
   (occupancy).
4b. learn_coma: ``coma_tpu_torch.cli.learn_coma`` on a second synthetic tree
   at the published qual widths — a seeded SMPL-X-shaped npz in the official
   key layout (phase 3's 10475-vertex body and its faces, 55 joints) for
   ``downsample_human`` at 1000/1500/2000/2048/20000 points, a backpack OBJ
   downsampled at 2048/1500/180, 72 human samples carrying ``IoU``,
   ``interscetion_ratio`` and ``num_inliers`` (64 survive; 3, 2 and 2 are
   rejected by the three thresholds; one sentinel) and the four default qual
   extractions — with every kernel's counter set to 0 just before and read
   just after (K1 and K2 must launch, K3 must not). Checks: the filter's counts, the star-pose
   vertices written from the card against the CPU's LBS (within 1e-5),
   ``used_count`` 64 in each pickle, the four products' rules. Printed: each
   stage's wall clock, the card's SMPL-X forward in ms, the poisson-disk path
   (native or Python). Then phase 3's two extractions on two ranks through
   ``cli/extract_coma --multihost``, one process each: under gloo with both
   ranks on card 0 (torchrun's variables), and under NCCL with a card per rank
   where the machine has two (``COMA_*`` variables). Each is held against phase
   3's one-rank pickle (contact within 1e-5 + 1e-4 |x|; occupancy hits,
   ``used_count`` and anchor equal) and every rank must launch its kernel;
   each rank's wall clock, wait for the other rank (its first collective),
   all-reduce ms and bytes, peak device memory and launches of every kernel
   are printed beside the one-rank wall clock.
5. K3 (flash attention) against its plain version computed in fp32 from the
   same inputs, at every shape phase 6 gives it, (B, heads, Lq, Lk, D): the
   UNet's under classifier-free guidance (batch 8 for 4 images) at the 64²,
   32², 16² and 8² levels, self (8, 8, L, L, D) and cross (8, 8, L, 77, D)
   with (L, D) = (4096, 40), (1024, 80), (256, 160) and (64, 160), and the
   VAE mid block's (4, 1, 4096, 4096, 512), in bf16 on the tensor-core
   kernel ``csrc/flash_attention_sm90.cu`` (|kernel - plain| <= 5e-4 + 8e-3
   |plain|: the output is rounded to bf16 once, a relative error of at most
   2^-8, and P enters the tensor cores as two bf16 terms). Then in float32
   on ``csrc/flash_attention.cu`` (within 1e-4) at the same UNet and VAE
   shapes built in float32 (the library's default; the plain check on batch
   rows 0 and 7 at 64² self) and at every shape the tiny loop gives it (read
   from ``attention.shape_launches`` after one tiny UNet and VAE call). A
   non-finite output raises. Then the kernel's time, the plain version's,
   ``F.scaled_dot_product_attention``'s as a yardstick (the port never calls
   it), the bound, the kernel's share of the bound (bound / kernel) and its
   ratio to SDPA (kernel / SDPA); for float32 also the kernel's device time
   per launch and the SDPA backend's kernels (``torch.profiler``), and the
   instance's query rows, dynamic shared memory and blocks per SM.
6. Inpainting: ``coma_tpu_torch.cli.inpaint`` at full width (SD-1.x UNet and
   VAE in bf16, CLIP ViT-L, the person segmenter; 512², 50 DDIM steps,
   guidance 7.5, mode ``p``, ``--random_weights``) on one batch of 4 images
   of a synthetic tree. The K3 counters are set to 0 just before and read
   just after: 1644 launches (16 transformer blocks x 2 attentions x 50
   steps, plus 44 VAE mid-block calls), every one of them on the bf16
   tensor-core kernel. The 4 images must be finite, in [0, 1], and
   written as 512x512 RGB PNGs. Then the tiny loop (64², f32) runs on the
   card and on the CPU from the same weights and noise and must agree within
   1e-3, its 1002 K3 launches all on the float32 kernel.
6b. Inpainting from a diffusers directory at SD-2-inpainting's published
   widths: the port's writer puts seeded random weights (UNet
   320/640/1280/1280, heads 5/10/20/20, cross-dim 1024, Linear
   ``proj_in``/``proj_out``; the OpenCLIP text tower, 1024 wide, 23 layers,
   16 heads, gelu; the VAE) in F16 under the diffusers layout with the
   published ``config.json`` files and a miniature vocabulary, then
   ``cli/inpaint --weights_dir`` inpaints phase 6's batch of 4 at 512², 50
   steps. Checks: the images finite in [0, 1]; K3's counters from 0, every
   launch bf16, 1600 at D = 64 and 44 at D = 512. Printed: the directory's
   size, the load's seconds, images/s, peak memory.
6c. Phase 6's run with ``--provoke_crop auto`` on a tree whose default mask
   (192 x 128 pixels) lets it take a bucket: the bucket, K3's launches at
   the crop's VAE shapes (42: a decode and an encode in each of 21 provoke
   rounds) and the wall clock beside phase 6's.
7. The HOI-reconstruction application: ``cli/optimize`` on phase 4b's
   SMPL-X-shaped npz, its ``qual:backpack_human_contact`` pickle (H 10475,
   O 180, N 250) and 180-point object downsample, with a seeded VPoser
   snapshot (512 wide, latent 32), at the CLI defaults (lr 1e-2, weights 1e12 /
   2.6e11) cut to 100 of their 2000 steps, then with ``--use_collision`` at
   50 steps; every kernel's counter from 0 (the application runs none).
   Checks: the losses finite and the total falling from step 0; the card
   against the CPU over 10 steps (total loss within 1e-3 relative, vertices
   within 1e-3 m; the card sums ``index_add`` and the gather's backward with
   atomics). Printed:
   the wall clocks, ms per step (CUDA events), peak memory, and the device's
   idle share over 10 steps (``torch.profiler``).

8. SAM in the loop: ``cli/inpaint --adaptive_mask_model_type ps_ae
   --random_weights`` on phase 6's tree (4 images at 512², 50 steps; SAM
   ViT-B at 1024² refining the U-Net's person box in each of the 21 provoke
   rounds, seeded weights), then ``s_ab_ae`` on the same route (all five SAM
   modes parse and pass the CLI's checks). Printed: images/s, peak memory,
   SAM's time per provoke step (CUDA events around its forward), K3's
   launches (1644 each, as mode p). Then SAM's forward on the card against
   the CPU at one seeded image and box (TF32 off): max |dlogits| within
   1e-3 + 1e-3 max|logits|, at most 1e-3 of the mask pixels differing.
9. PointRend in the loop: ``--person_segmenter pointrend`` (``PointRendConfig(
   max_detections=20)``, 800 px) in mode p with seeded stand-in weights
   through ``--pointrend_weights`` (a Flax-layout ``.npz``: Flax's
   initializers, the box regressions zeroed and the classifier favouring the
   person class, so the anchors are the proposals and masks reach the
   paste), then with ``--pointrend_fast``. Printed: the wall clock, the
   detector's time per provoke step, the NMS rounds, the merged masks'
   share of the frames, K3's launches (1644). Then the detector on the card
   against the CPU at one seeded image (TF32 off): the same valid slots and
   classes, boxes within 1e-2 px, at most 1e-3 of the merged mask's pixels
   differing.
10. ``cli/segment_human`` on phase 6's four images with the committed U-Net,
   and with ``--segmenter pointrend`` (``PointRendConfig()``) on phase 9's
   stand-in as a Flax-layout ``.npz``: the pickles' keys, dtypes and shapes;
   images/s.
11. ``--save_step_video`` on phase 6's batch: the GIF decoded by the port's
   reader (``decode_gif``) must hold the ⌈50/3⌉ = 17 frames of 512x1024 of
   ``compose_step_frames``' output, each quantised as PIL's writer does
   (``utils/gif.pil_frames``); K3 launches 1645 (the video's one VAE decode of the 17 x̂0);
   the video's cost beside phase 6's wall clock.

12. Stage 2, 3D HOI lifting, with every kernel's counter set to 0 before
   and read after (stage 2 launches none of K1, K2, K3). (a)
   ``cli/predict_human`` with a seeded Hand4Whole at the published widths
   (ResNet-50 body at 256x192, ResNet-50 hands on 2 x 256², ResNet-18 face
   at 192²) and phase 4b's npz on phase 6's four images, each with a
   one-person instance pickle whose box is the inpainting mask's: every
   image regressed, finite meshes of 10475 vertices; one 512x384 patch on
   the card against the CPU with TF32 off, within 1e-3 + 1e-3 |x|; images/s,
   peak memory, the network's ms per patch. (b)
   ``cli/generate_3d_hoi_samples --skip segment predict`` with the neural
   COAP backend (a seeded COAP at the published widths written as a Flax
   ``.npz``, its output bias at +2) on a tree written here: phase 4b's body
   posed with seeded parameters, a closed ring (4096 faces) around its legs
   and a 1 cm marker 8 cm from its pelvis, 8 orthographic views at 512²
   (elevation 15°, azimuth steps of 45°, the Chair category's ortho scale),
   per view the body's exact projection as ``human_preds`` and its occluded
   silhouette as ``human_segs``. Checks: depth init picks, in every view,
   the candidate nearest the true depth (recomputed on the host); the mean
   vertex error and the summed loss fall; the losses are finite;
   ``compute_metrics`` writes ``IoU`` (>= 0.9) and ``interscetion_ratio``;
   the port's ``cli/filter`` keeps all 8. Printed: each stage's wall clock,
   depth init's ms per sample and its rasterizer's share, RANSAC ms, the
   optimizer's ms per step and idle share (``torch.profiler``),
   compute_metrics' ms per sample and refinements, one 128³ ratio's ms,
   peak memory.

13. Stage 1 end to end, every kernel's counter from 0: ``cli/
   generate_2d_hoi_images`` on a synthetic textured chair written here (seat,
   back and four legs, 20,736 faces; a ``map_Kd`` material with a 512² PNG, a
   Kd-only one, the legs without UVs) under the registered Chair id, at
   ``render_objects``' defaults and the Chair camera config (8 views at 512²,
   stride 0.1, bbox (0.6, 0.6, 1.1), AO 8, specular 0.25, sky environment,
   ACES tonemap), ``select_mask`` at the Chair band [0.8, 0.9] (what it kept
   per view is printed), ``generate_prompts`` from the registered prompts,
   then ``inpaint`` on one batch of 4 (the first two views with a kept mask,
   one prompt, both viewpoint texts, one image each; the pickles trimmed to
   that). Checks: 8 renders, segs and camera pickles; each seg equal to
   ``render_silhouette`` of its camera; view 0's PNG equal to the card's
   render, the asset rendered alone exactly white where it does not cover
   (the ground quad covers every pixel of the CLI's renders) and covering
   the seg; view 0 rendered on the CPU from the card's triangles: coverage
   and material equal, RGB within 1e-4 on 99.9% of values and 0.15
   everywhere; view 0's candidate masks equal on the card, on the CPU and
   in the PNGs; K3 1644 launches, all on the tensor-core kernel, K1 and K2
   none; the images finite and in [0, 1]. Printed: ms per view of
   ``render_textured`` (CUDA events) split into the attribute pass, the
   shadow pass, the 8 AO passes and the rest (shading), the silhouette's
   ms, the count of candidate masks and the fill's ms, the seconds spent
   writing PNGs, each stage's wall clock, images/s and peak memory.

14. The rest of item 14, every kernel's counter set to 0 before each part
   and read after. (a) Evaluation: a BEHAVE-shaped sequence of 64 frames
   written from the seed (the phase 3 body posed per frame as the fits'
   verts/faces pickles; per frame the backpack's ``lowres_center``,
   ``raw2normal`` and fit pickles; the downsamples at ``quant:full``: 750
   human indices, 2048 raw object points with normals), read through
   ``pipelines/behave_eval.BehaveSequence`` and prepared by
   ``prepare_affordance_extraction_inputs_for_behave`` into
   ``pipelines/extract.aggregate_samples_streaming``: the ground-truth state
   (H 750, O 2048, N 250; K1 2 launches, K2 and K3 none), held against the
   plain version on the card over all 64 frames (K1's limit, 1e-5 + 1e-4
   |plain|; the CPU route, ~94 s a frame at these widths, is held against
   ``coma_tpu`` by the CPU tests); ``cli/evaluate`` of
   it against itself (SIM 1, MAE 0 within 1e-6) and against the state of a
   sequence from another seed (finite, SIM < 1). Printed: the host's prep
   ms per frame, the aggregation's and evaluate's seconds, peak memory.
   (b) ``cli/visualize human`` (phase 4's human contact on phase 4b's star
   pose: the PLY's colours the product's jet colours), ``object``,
   ``occupancy --mode volume`` (512², 192 steps, phase 4b's backpack
   downsample composited) and ``--mode slices``; the volume render on the
   card against the CPU (within 1e-4 on 99.9% of values, 1e-2 at most);
   ``render_contact_scene`` at 512x384 of phase 12's posed body and a sphere
   2 cm from it with its contact spheres; every image finite in [0, 1]; no
   kernel launched. Printed: ms per volume render and per contact scene
   (CUDA events), peak memory. (c) ``cli/train_segmenter`` at its defaults
   (``PersonSegmenter()``, batch 64 at 128², both domains, corruption with
   the numpy JPEG, a pool of 48) cut to ``--steps 20 --eval_batches 2
   --log_every 10``: the loss finite and the mean of the last 10 steps below
   step 1's, the npz loaded by the port's loader segmenting 4 images, one
   AdamW step from seeded weights on 8 images card against CPU with TF32
   off (loss and every parameter whose gradient is at least 1e-5 within
   1e-4; the others, whose Adam step takes the sign of a near-zero
   gradient, within 2.2 lr); no kernel launched. Printed: ms per step (CUDA
   events), the wait on the producer queue, the pool's seconds, both IoUs,
   peak memory. ``python3 tools/item14_torch.py`` runs phase 14 alone.

15. Multi-rank and checkpoint modules, every kernel's counter set to 0 just
   before each part's path and read just after, per rank. (a) ``cli/inpaint
   --mesh 2`` at phase 6's configuration (SD-1.x at 512², 50 DDIM steps,
   mode p, bf16, seeded weights) and tree at ``--batch_size 2``: two gloo
   ranks on card 0 (torchrun's variables), and two NCCL ranks, a card each,
   where the machine has two (COMA_* variables); whole batches go to the
   ranks in turn, one each. Against it, the one-process run at
   ``--batch_size 2``. Every PNG equal to the one-process run's (else the
   largest difference is printed and the phase fails); each rank launches
   K3 1644 times, all on the bf16 kernel. Printed: each rank's wall clock
   and peak memory, the one-process wall clock. (b)
   ``parallel/sharding.sharded_contact_aggregate_2d``: 64 seeded samples at
   ``quant:full`` (H 750, O 2048, N 250, sigma 0.2) on 4 gloo ranks on card
   0 as 2 data x 2 model, each rank holding 375 rows of the grids (1.5 GB);
   the slices gathered on rank 0 within K1's 1e-5 + 1e-4 |plain| of one
   process's plain ``contact_update_batch`` of the same samples on the card,
   ``used_count`` 64; every rank launches K1. Printed: each rank's
   aggregation seconds, all-reduce ms and bytes (its data group only). (c)
   A weights root of seeded stand-ins in the published layouts (a Lightning
   COAP ``.ckpt`` at ``COAPConfig()``'s widths, a VPoser snapshot, phase
   4b's SMPL-X npz): ``cli/convert_weights --all`` exits 0 with each of
   them ``loaded``; the ``.ckpt`` through ``cli/optimize_depth.load_coap``:
   occupancy on the card within 1e-5 of the CPU's (TF32 off) and within
   1e-6 of the same weights from a Flax ``.npz``; no kernel launched.
   ``python3 tools/phase15_torch.py`` runs phase 15 alone. The rank
   processes run this file's ``rank_main``.

16. The images ``coma_tpu`` reads through PIL. (a) Every fixture of
   ``tests/data/images/`` (written from seeds by Pillow, by libjpeg-turbo's
   compressor, by libwebp's API and by ``tools/make_image_fixtures.py``'s
   writers: baseline, progressive, arithmetic (SOF9/SOF10, DAC), lossless
   (SOF3) and block-smoothed JPEGs in every sampling, gray, RGB, CMYK and
   YCCK; Adam7 PNGs; BMP, TGA, PBM/PGM/PPM, TIFF (JPEG strips, separate
   planes, fill order 2, BigTIFF) and GIF files of every kind the readers
   take; lossy, lossless, alpha and animated WebP; DDS of every block format
   and bit-mask layout Pillow reads; PSD of every mode; SGI, PCX, DCX, ICO,
   CUR, QOI, XBM, IM, ICNS, BLP, Sun raster, MSP, SPIDER and bare DIB files;
   lossless AVIF of every sampling, range, matrix, tiling and aom tool
   switch, and lossy AVIF as Pillow writes it (four q contexts, speeds 5 to
   10, transforms of 4 to 64 points, 4:1 ones at speed 4, delta q, the deblocking filter, every
   sampling, a lossy alpha item, tiles, 128² superblocks) and restored at
   speeds 0 to 4 or with aom's enable-cdef=1 (CDEF at cdef_bits 0 to 3 in
   every sampling, Wiener, self-guided and switchable loop restoration on
   every plane, mixed, over tiles, 16 x 64 and 64 x 16 transforms, a
   restored alpha item), with aom's quantizer matrices (tune=iq, every
   level 0 to 14) and film grain (its 16 test vectors, grain tables, its
   denoiser; every sampling, an alpha item); the 2048 x 1536
   BEHAVE frames and atlas) through ``read_image``
   with the native decoders and codecs (``native/src/{jpeg_decode,
   image_codecs,bcn_decode,webp_decode,av1_decode}.cpp``, built with
   ``g++``; the phase fails if they do not build or load): the SHA-256 of
   modes None, RGB and L equal to
   Pillow's in the manifest, and each file Pillow refuses refused naming
   itself. The
   BEHAVE frame's decode, median of 5, split into entropy and
   reconstruction ms (host), beside the plain decoder's (Python entropy,
   numpy reconstruction; equal coefficients and pixels), the Python entropy
   decoder on the 512² texture, and the host decode ms (median of 5) of the
   2048 x 1536 atlas as TGA, TIFF-LZW, SOF9, block-smoothed progressive
   JPEG, lossy and lossless WebP, DDS BC7 and DXT1, PSD PackBits, YCbCr
   TIFF-JPEG, QOI, SGI RLE and lossless, lossy (Pillow's defaults),
   restored (speed 4 with CDEF), screen-content (palettes and intra block
   copy) and tune=iq with denoise-noise-level (quantizer matrices and film
   grain) 4:2:0 AVIF, the lossless, lossy, restored, screen-content and
   quantizer-matrix and film-grain AVIF fixtures' counts printed on a line
   of its own, and on another the
   restored fixtures with CDEF-filtered blocks and with restored units,
   from the decoder's counters. (b) A BEHAVE-shaped sequence of 2 frames
   whose k0-k3 colour frames and person masks are the 2048 x 1536 JPEGs:
   ``BehaveSequence.__getitem__`` and ``get_person_mask``, every image equal
   to Pillow's hash; ms per frame. (c) Phase 13's chair with the 512² JPEG
   as its seat's ``map_Kd`` and an arithmetic JPEG, a TGA, a BMP, a
   TIFF-LZW, a CMYK JPEG, a lossy WebP with alpha, a lossless WebP, a DDS
   BC7, a DDS DXT1, a PSD, a YCbCr 4:2:0 TIFF-JPEG, an SGI RLE, a PCX, a
   QOI, an ICO, a BLP2 DXT5, a Sun RLE file and the rest of
   ``PART_TEXTURES`` (two lossless AVIFs, 4:2:0 and RGBA, a lossy AVIF at
   Pillow's defaults, one at speed 0 with CDEF and loop restoration, whose
   counters must show both, two of screen content at Pillow's defaults: a
   flat texture whose counters must show luma and chroma palettes and a
   decal of letters whose counters must show intrabc blocks, and last a
   tune=iq one whose counters must show weighting by a quantizer matrix and
   a denoised one whose counters must show film grain) on its back,
   legs, stretchers, armrests, seat trims, back slats and seat studs, through
   ``cli/generate_2d_hoi_images`` at 384² with phase 13's checks (view 0 on
   the card against the CPU, K3 1644 launches, all bf16, K1 and K2 none,
   counters from 0); each layer is its decoded texture bilinearly resized; the inpainting's inputs (384² renders
   and masks) equal the host's ``read_image`` and PIL's bicubic resize to
   512². (d) The seeded step video (17 frames of 512 x 256) through
   ``utils/gif.write_gif``, read back by the port's GIF reader: every frame,
   duration and the loop equal to Pillow's decoding of ``coma_tpu``'s
   PIL-written file (the manifest's hash). ``python3 tools/phase16_torch.py``
   runs phase 16 alone.

17. ``coma_tpu_torch.benchkit``, the bench's measured entry points (``coma_tpu/benchkit.py``'s
   counterpart). First K3 against its plain version at the suite's batch-16
   shapes, the UNet's (32, 8, L, L|77, D) at the four levels and the VAE's
   (16, 1, L, L, 512) at the full frame, fast mode's 32² and crop mode's 40²,
   the fp32 plain version on batch rows 0 and B - 1 only (5e-4 + 8e-3
   |plain|), with the kernel's, the plain version's and SDPA's times on the
   whole batch. Then every key of ``bench.py``'s sections coma, pipe_suite,
   torch_baselines, dp_scaling and extract_production, one line per emitted
   dict: ``bench_coma`` at qual, object-contact and quant:full and
   ``bench_occupancy`` (9 launches of K1 or K2 each: a 1-step and a 2-step
   chain, each run 3 times); the pipeline suite at 16 images, 512², 50 steps
   (K3 on every variant: its warm-up's launches + 1644 a timed batch, all
   bf16; the UNet step's 352; ``0 < unet_step_mfu <= 1``; crop bucket 40),
   the first two timed batches of the headline compared (the warm-up is one
   forward of each model at its shapes); the device's idle share of the CFG
   UNet step and of each segmenter's provoke call (``torch.profiler``); the
   two CPU baselines; ``bench_dp_scaling`` at 1 and 2 ranks on the card (K3,
   f32, 1044 launches a rank); ``bench_extract_production`` with 64 samples
   at qual (K1, 2 launches). Each kernel's counter is set to 0 before each
   path and read after it. ``python3 tools/phase17_torch.py`` runs phase 17
   alone.

Phase 5 also holds K3 at phase 6b's shapes (D = 64: (8, 5, 4096, 4096|77),
(8, 10, 1024, 1024|77), (8, 20, 256, 256|77), (8, 20, 64, 64|77)) and at
phase 6c's crop, (4, 1, c², c², 512) for the bucket c the crop takes.

After the phases come three lines: ``{"kernels": [...]}``, the card's name
and power limit as ``nvidia-smi`` gives them, and last ``{"ok": true,
"device": {...}}``. Without a card, or without the package beside this file,
the script fails before printing any of them.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(REPO, "_smoke")  # the synthetic tree, removed at the end
DEVICE = "cuda"
SEED = 0
N_SAMPLES = 64
SLAB = 32             # the extraction's batch: one kernel launch per batch
H_FULL = 10475        # SMPL-X vertex count
OCC_O, OCC_R = 1500, 30  # qual:backpack_occupancy object vertices, voxels per side
PEAK_F32_OPS = 67e12  # H100 SXM, FP32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (data sheet)
K1_OPS_PER_SPLAT = 12  # dot 5, clamp 2, arccos 1, square 1, scale 1, exp 1, add 1
K2_OPS_PER_TEST = 9    # cross 5, doubling 1, subtract 1, add 1, compare 1
K1_RTOL, K1_ATOL = 1e-4, 1e-5

K1_SHAPES = (  # (name, H, O, N, hyperparameter key)
    ("qual", 10475, 180, 250, "qual:backpack_human_contact"),
    ("object_contact", 1000, 1500, 250, "qual:backpack_object_contact"),
    ("quant_full", 750, 2048, 250, "quant:full"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, kernel: str, reps: int):
    """(ms per call from CUDA events; device ms per call of the kernels whose
    name holds ``kernel``, and device operations per call, both from
    ``torch.profiler``), after one warm-up call. A call's events also hold
    its wrapper's other launches and, where the host issues more slowly
    than the card runs, the host's time."""
    from torch.profiler import ProfilerActivity, profile

    call_ms = cuda_ms(fn, reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events if kernel in e.key) / reps / 1e3
    if not device_ms > 0:
        raise AssertionError(f"the profiler saw no device time of {kernel}")
    return call_ms, device_ms, sum(e.count for e in events) / reps


def bound(ops: float, nbytes: float, peak: float = PEAK_F32_OPS):
    ops_ms, bytes_ms = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def sass_counts(source: str) -> str:
    """Tensor-core (HGMMA) and TMA-load (UTMALDG) instructions in a built library."""
    from coma_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path(source))], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return f"{sass.count('HGMMA')} HGMMA, {sass.count('UTMALDG')} UTMALDG"


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def contact_inputs(rng, B, H, O):
    """Samples with a zero human normal and both singular branches."""
    hv = rng.normal(size=(B, H, 3)) * 0.3
    ov = rng.normal(size=(B, O, 3)) * 0.3
    hn = unit(rng.normal(size=(B, H, 3)))
    on = unit(rng.normal(size=(B, O, 3)))
    hn[:, 0] = 0.0
    on[:, 1] = (0.0, 0.0, -1.0)
    hn[:, 2] = (0.0, 0.0, -1.0)
    return [torch.from_numpy(np.float32(a)).to(DEVICE) for a in (hv, hn, ov, on)]


def product_diffs(kern, plain):
    """Largest difference of the contact map (relative to its maximum) and
    of the min-max-normalised orientation score between two states."""
    from coma_tpu_torch.affordance.contact import contact_map, orientational_tendency

    cm_k, cm_p = contact_map(kern, "human")["human"], contact_map(plain, "human")["human"]
    map_err = float((cm_k - cm_p).abs().max()) / float(cm_p.abs().max())
    del cm_k, cm_p
    ot_k, ot_p = orientational_tendency(kern), orientational_tendency(plain)
    orient_err = float((ot_k - ot_p).abs().max())
    if not (map_err <= 1e-4 and orient_err <= 1e-3) or not torch.isfinite(ot_k).all():
        raise AssertionError(f"K1 products: contact map differs by {map_err:.3e} of its maximum "
                             f"(limit 1e-4), orientation score by {orient_err:.3e} (limit 1e-3)")
    return map_err, orient_err


def check_k1(rng, name, H, O, N, key, products=False):
    from coma_tpu_torch.affordance.contact import contact_update_batch
    from coma_tpu_torch.affordance.state import init_coma_state
    from coma_tpu_torch.config.hyperparams import get_hyperparams
    from coma_tpu_torch.ops.contact_kernel import (fused_contact_update_batch, mask_keep_share,
                                                   polynomial_route)

    hp = get_hyperparams(key)
    init = lambda: init_coma_state(
        H, O, N, hp["spatial_grid_size"], hp["spatial_grid_thres"],
        hp["normal_gaussian_sigma"], hp["principle_vec"], hp["sub_principle_vec"],
        hp["eps"], device=DEVICE,
    )
    poly = polynomial_route(float(hp["normal_gaussian_sigma"])) is not None
    # 6 samples in slabs of 4 (4 + 2), sample 4 padded and holding NaN
    args = contact_inputs(rng, 6, H, O)
    args[0][4] = float("nan")
    valid = torch.tensor([1, 1, 1, 1, 0, 1], dtype=torch.float32, device=DEVICE)
    kern, plain = init(), init()
    fused_contact_update_batch(kern, *args, valid=valid, slab=4)
    contact_update_batch(plain, *args, valid=valid)
    torch.cuda.synchronize()
    max_abs, max_rel, bad = 0.0, 0.0, []
    for f in ("prob_grid_canon_human_wrt_obj", "prob_grid_canon_obj_wrt_human",
              "contact_dist_expectation_grid_nom", "contact_dist_expectation_grid_denom",
              "significant_contact_count", "used_count"):
        k, p = getattr(kern, f), getattr(plain, f)
        err = (k - p).abs()
        if not torch.isfinite(k).all() or bool((err > K1_ATOL + K1_RTOL * p.abs()).any()):
            bad.append(f)
        max_abs = max(max_abs, float(err.max()))
        max_rel = max(max_rel, float((err / p.abs().clamp(min=1e-6)).max()))
    if bad:
        raise AssertionError(f"K1 {name}: kernel disagrees with plain in {bad} "
                             f"(max abs {max_abs:.3e})")
    map_err, orient_err = product_diffs(kern, plain) if products else (None, None)
    del kern, plain
    torch.cuda.empty_cache()

    # timing at the main path's slab: 32 valid samples, one launch per call
    slab = contact_inputs(rng, SLAB, H, O)
    ones = torch.ones(SLAB, dtype=torch.float32, device=DEVICE)
    acc = init()
    call_ms, ms, ops_per_call = kernel_ms(
        lambda: fused_contact_update_batch(acc, *slab, valid=ones, slab=SLAB),
        "contact_splat_kernel", reps=3)
    keep_share = mask_keep_share(acc, slab[1], slab[3], ones)
    plain_acc = init()
    plain_ms = cuda_ms(lambda: contact_update_batch(plain_acc, *slab, valid=ones), reps=1)
    del acc, plain_acc
    torch.cuda.empty_cache()
    splats = 2.0 * SLAB * H * O * N
    nbytes = 4.0 * (2 * 2 * H * O * N + 3 * 2 * H * O + 2 * SLAB * (H + O) * 3 + 3 * N + SLAB)
    bound_ms, bound_by = bound(K1_OPS_PER_SPLAT * splats, nbytes)
    return dict(shape=f"{name} H={H} O={O} N={N} slab={SLAB}",
                route="polynomial" if poly else "exact", mask_keep_share=keep_share,
                max_abs_err=max_abs, max_rel_err=max_rel, contact_map_err=map_err,
                orientation_err=orient_err, ms=ms, call_ms=call_ms,
                device_ops_per_call=ops_per_call, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def init_k2():
    from coma_tpu_torch.affordance.state import init_occupancy_state

    return init_occupancy_state(H_FULL, OCC_O, OCC_R, scale_tolerance=3.0, device=DEVICE)


def check_k2(rng):
    """Equal hits on 6 samples in slabs of 4 with a padded NaN sample; then
    :func:`k2_slab` on 32 i.i.d. Gaussian samples."""
    from coma_tpu_torch.affordance.occupancy import occupancy_update_batch
    from coma_tpu_torch.ops.occupancy_kernel import fused_occupancy_update_batch

    inputs = lambda B: [torch.from_numpy(np.float32(rng.normal(size=(B, n, 3)) * 0.6))
                        .to(DEVICE) for n in (H_FULL, OCC_O)]
    hv, ov = inputs(6)
    hv[4] = float("nan")
    valid = torch.tensor([1, 1, 1, 1, 0, 1], dtype=torch.float32, device=DEVICE)
    kern, plain = init_k2(), init_k2()
    fused_occupancy_update_batch(kern, hv, ov, valid=valid, slab=4)
    occupancy_update_batch(plain, hv, ov, valid=valid)
    torch.cuda.synchronize()
    differing = int((kern.spatial_occupancy_grids != plain.spatial_occupancy_grids).sum())
    max_abs = float((kern.spatial_occupancy_grids - plain.spatial_occupancy_grids).abs().max())
    hits = float(kern.spatial_occupancy_grids.sum())
    if differing or hits == 0 or not torch.equal(kern.anchor_vert, plain.anchor_vert) \
            or float(kern.used_count) != 5.0:
        raise AssertionError(f"K2: {differing} differing cells, {hits} hits, anchors "
                             f"{kern.anchor_vert.tolist()} vs {plain.anchor_vert.tolist()}")
    del kern, plain
    return dict(k2_slab(*inputs(SLAB), "i.i.d. Gaussian vertices"), max_abs_err=max_abs)


def k2_slab(hv, ov, inputs: str):
    """K2 on one slab of 32 valid samples: hits equal to the plain
    version's, both times, the tests the cull keeps and the accumulator
    elements the kernel reads and writes, and the bound of that work beside
    the dense bound."""
    from coma_tpu_torch.affordance.occupancy import occupancy_update_batch
    from coma_tpu_torch.ops.occupancy_kernel import fused_occupancy_update_batch, kept_work

    H, L = H_FULL, OCC_R ** 3
    ones = torch.ones(SLAB, dtype=torch.float32, device=DEVICE)
    kern, plain = init_k2(), init_k2()
    fused_occupancy_update_batch(kern, hv, ov, valid=ones, slab=SLAB)
    occupancy_update_batch(plain, hv, ov, valid=ones)
    torch.cuda.synchronize()
    differing = int((kern.spatial_occupancy_grids != plain.spatial_occupancy_grids).sum())
    if differing or float(kern.spatial_occupancy_grids.sum()) == 0:
        raise AssertionError(f"K2 on {inputs}: {differing} differing cells")
    call_ms, ms, ops_per_call = kernel_ms(
        lambda: fused_occupancy_update_batch(kern, hv, ov, valid=ones, slab=SLAB),
        "occupancy_hits_kernel", reps=5)
    plain_ms = cuda_ms(lambda: occupancy_update_batch(plain, hv, ov, valid=ones), reps=1)
    kept, dense, touched = kept_work(kern, hv, ov, ones)
    del kern, plain
    torch.cuda.empty_cache()
    inputs_bytes = 4.0 * (SLAB * H * 4 + 4 * L + SLAB)   # x and ||x||^2, grid and ||g||^2, valid
    bound_ms, bound_by = bound(K2_OPS_PER_TEST * kept, 8.0 * touched + inputs_bytes)
    dense_bound_ms, dense_bound_by = bound(K2_OPS_PER_TEST * dense, 8.0 * H * L + inputs_bytes)
    return dict(shape=f"H={H} R={OCC_R} slab={SLAB}, {inputs}", differing_cells=differing,
                kept_tests=kept, dense_tests=dense, kept_share=kept / dense,
                touched_share=touched / (H * L), ms=ms, call_ms=call_ms,
                device_ops_per_call=ops_per_call, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, dense_bound_ms=dense_bound_ms, dense_bound_by=dense_bound_by)


def log_k2(r, label):
    log(f"K2 {r['shape']}: {r['differing_cells']} differing cells; the cull keeps "
        f"{r['kept_tests']} of {r['dense_tests']} tests ({r['kept_share']:.4f}) and touches "
        f"{r['touched_share']:.4f} of the accumulator; kernel {r['ms']:.3f} ms (the wrapper's "
        f"call {r['call_ms']:.3f} ms, {r['device_ops_per_call']:.0f} device operations), plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}, the kept work) "
        f"against {r['dense_bound_ms']:.3f} ms ({r['dense_bound_by']}, dense), share of bound "
        f"{r['bound_ms'] / r['ms']:.3f} [{label}]")


def time_splat_plan(key: str):
    """Host ms of K1's splat plan for the 250-point grid at ``key``'s σ: the
    first call in the process (the fit, its check and the patch partition),
    then a second call (the fit cached)."""
    from coma_tpu_torch.affordance.sphere import fibonacci_sphere
    from coma_tpu_torch.config.hyperparams import get_hyperparams
    from coma_tpu_torch.ops.contact_kernel import splat_plan

    grid = fibonacci_sphere(250).astype(np.float32)
    sigma = float(get_hyperparams(key)["normal_gaussian_sigma"])
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        splat_plan(grid, sigma)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


# ---------------------------------------------------------------------------
# Phase 3: a synthetic results tree
# ---------------------------------------------------------------------------

SC, CAT, ASSET, PROMPT = "BEHAVE", "backpack", "behave_asset", "a person wearing a backpack"
RINGS, AROUND = 25, 419   # 25 x 419 = 10475 vertices


def human_template():
    """A closed-around body surface: 25 rings of 419 vertices, outward faces."""
    z = np.linspace(0.0, 1.7, RINGS)
    theta = np.linspace(0.0, 2 * np.pi, AROUND, endpoint=False)
    radius = 0.3 + 0.05 * np.sin(np.pi * z / 1.7)
    verts = np.stack([
        radius[:, None] * np.cos(theta)[None, :],
        radius[:, None] * np.sin(theta)[None, :],
        np.broadcast_to(z[:, None], (RINGS, AROUND)),
    ], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(RINGS - 1), np.arange(AROUND), indexing="ij")
    v00, v01 = i * AROUND + j, i * AROUND + (j + 1) % AROUND
    v10, v11 = v00 + AROUND, v01 + AROUND
    faces = np.concatenate([
        np.stack([v00, v01, v11], -1).reshape(-1, 3),
        np.stack([v00, v11, v10], -1).reshape(-1, 3),
    ])
    return verts, faces.astype(np.int64)


def backpack(rng, n):
    """``n`` points on a patch 2 cm behind the body's back, normals outward."""
    theta = np.pi + rng.uniform(-0.6, 0.6, n)
    z = rng.uniform(0.8, 1.4, n)
    radius = 0.3 + 0.05 * np.sin(np.pi * z / 1.7) + 0.02
    pts = np.stack([radius * np.cos(theta), radius * np.sin(theta), z], -1)
    normals = np.stack([np.cos(theta), np.sin(theta), np.zeros(n)], -1)
    return pts, normals


def write_tree(root: str, rng) -> dict:
    def dump(path, payload):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as fh:
            pickle.dump(payload, fh)

    from coma_tpu_torch.core.paths import ResultsTree, SampleKey, smplx_downsample_path

    tree = ResultsTree(f"{root}/results")
    constants = f"{root}/constants/mesh"
    verts, faces = human_template()
    dump(smplx_downsample_path("FULL", constants), dict(
        N=H_FULL, N_raw=H_FULL, downsample_indices=np.arange(H_FULL)))

    obj_verts, obj_normals = backpack(rng, 2000)  # the OBJ the 1500 indices pick from
    raw_pts, raw_normals = backpack(rng, 180)
    for res, n in (("180", 180), (str(OCC_O), OCC_O)):
        dump(tree.asset_downsample(SC, CAT, ASSET, res), dict(
            obj_vertices_original=obj_verts, obj_vertex_normals_original=obj_normals,
            downsample_indices=np.sort(rng.choice(2000, n, replace=False)), N=n,
            downsampled_pcd_points_raw=raw_pts, downsampled_pcd_normal_raw=raw_normals,
            N_raw=180,
        ))

    whitelist, keys = [], []
    for k in range(N_SAMPLES):
        key = SampleKey(SC, CAT, ASSET, f"{k // 16:03d}", "0", PROMPT, f"{k % 16:05d}")
        yaw = rng.uniform(-0.1, 0.1)
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        posed = verts @ rot.T + rng.normal(scale=0.005, size=3) \
            + rng.normal(scale=0.002, size=verts.shape)
        dump(tree.human_sample(key), dict(verts=posed, faces=faces))
        keys.append(key)
        whitelist.append([key.view_id, key.asset_mask_id, key.prompt, key.inpaint_id])
    wl = tree.postfilter_json(SC, CAT, ASSET, PROMPT)
    os.makedirs(os.path.dirname(wl), exist_ok=True)
    with open(wl, "w") as fh:
        json.dump(whitelist, fh)
    return dict(tree=tree, constants=constants, keys=keys)


def posed_slab(paths, key: str):
    """The tree's first 32 samples as the extraction prepares them for
    ``key``: (human verts, object verts) on the card."""
    from coma_tpu_torch.affordance.io import load_pickle
    from coma_tpu_torch.config.hyperparams import get_hyperparams
    from coma_tpu_torch.core.paths import smplx_downsample_path
    from coma_tpu_torch.pipelines.affordance_inputs import prepare_affordance_extraction_inputs

    hp, tree = get_hyperparams(key), paths["tree"]
    human = load_pickle(smplx_downsample_path("FULL", paths["constants"]))
    obj = load_pickle(tree.asset_downsample(SC, CAT, ASSET, hp["object_res"]))
    samples = [prepare_affordance_extraction_inputs(
        tree.human_sample(k), human, obj, hp["human_use_downsample_pcd_raw"],
        hp["object_use_downsample_pcd_raw"], hp["eps"]) for k in paths["keys"][:SLAB]]
    return [torch.from_numpy(np.stack([d[f] for d in samples])).to(DEVICE)
            for f in ("human_verts", "obj_verts")]


def extract(paths, key: str, label: str):
    from coma_tpu_torch.cli import extract_coma

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    extract_coma.main([
        "--human_sample_dir", f"{paths['tree'].root}/generation/human_sample",
        "--constants_mesh_dir", paths["constants"], "--hyperparams_key", key,
        "--device", DEVICE,
    ])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pickle_path = paths["tree"].coma_pickle(SC, CAT, ASSET, key, PROMPT)
    with open(pickle_path, "rb") as fh:
        d = pickle.load(fh)
    if d["used_count"] != N_SAMPLES:
        raise AssertionError(f"{key}: used_count {d['used_count']} != {N_SAMPLES}")
    for k, v in d.items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f" and not np.isfinite(v).all():
            raise AssertionError(f"{key}: non-finite values in {k}")
    log(f"extract {key}: {N_SAMPLES} samples in {seconds:.3f} s = "
        f"{N_SAMPLES / seconds:.2f} samples/s (CLI wall clock: load, prep, aggregate, "
        f"export, product), peak device memory {peak_gb:.3f} GB [{label}]")
    return pickle_path, seconds


def infer(paths, coma_path, visualize_type, key, res, out_dir):
    from coma_tpu_torch.cli import inference

    return inference.main([
        "--supercategory", SC, "--category", CAT, "--coma_path", coma_path,
        "--visualize_type", visualize_type, "--hyperparams_key", key,
        "--asset_downsample_pth", paths["tree"].asset_downsample(SC, CAT, ASSET, res),
        "--output_dir", f"{out_dir}/{visualize_type}", "--device", DEVICE,
    ])


def check_product(visualize_type: str, path: str, n: int) -> str:
    """The rules for one product file: finite, max 1.0 over ``n`` human
    vertices (contact, orientation); ``n`` object points, one with the colour
    of 1.0 (object contact); an R³ field with max 0.7 (occupancy)."""
    from coma_tpu_torch.utils.colormap import jet_rgb
    from coma_tpu_torch.utils.ply import read_ply_pointcloud

    if visualize_type in ("aggr-human-contact", "orientation"):
        arr = np.load(path)
        if arr.shape != (n,) or not np.isfinite(arr).all() or arr.max() != 1.0:
            raise AssertionError(f"{visualize_type}: shape {arr.shape}, max {arr.max()}")
        return f"shape {arr.shape}, max {arr.max()}, mean {arr.mean():.4f}"
    if visualize_type == "aggr-object-contact":
        points, normals, colors = read_ply_pointcloud(path)
        top = np.round(jet_rgb(np.float32([1.0])) * 255) / 255
        if points.shape != (n, 3) or not np.isfinite(colors).all() \
                or not np.isclose(colors, top).all(-1).any():
            raise AssertionError(f"{visualize_type}: no point carries the colour of 1.0")
        return f"{len(points)} points, colour of 1.0 present"
    field = np.load(path, allow_pickle=True).item()["prob_field"]
    if field.shape != (OCC_R,) * 3 or not np.isfinite(field).all() \
            or not np.isclose(field.max(), 0.7):
        raise AssertionError(f"occupancy: shape {field.shape}, max {field.max()}")
    return f"shape {field.shape}, max {field.max()}"


def check_products(paths, contact_pickle, occupancy_pickle, out_dir) -> dict:
    """Infer and check the four products; returns the paths of the human
    contact, object contact and occupancy products."""
    products = {}
    for vt, key in (("aggr-human-contact", "qual:backpack_human_contact"),
                    ("orientation", "qual:backpack_orientation")):
        path = infer(paths, contact_pickle, vt, key, "180", out_dir)
        log(f"inference {vt}: {check_product(vt, path, H_FULL)}")
        products.setdefault("human_contact", path)
    ply = infer(paths, contact_pickle, "aggr-object-contact", "qual:backpack_object_contact",
                "180", out_dir)
    log(f"inference aggr-object-contact: {check_product('aggr-object-contact', ply, 180)}")
    occ = infer(paths, occupancy_pickle, "occupancy", "qual:backpack_occupancy", str(OCC_O),
                out_dir)
    log(f"inference occupancy: {check_product('occupancy', occ, 0)}")
    return dict(products, object_contact=ply, occupancy=occ)


# ---------------------------------------------------------------------------
# Phase 4b: learn_coma through the CLI; phase 3's extractions on two ranks
# ---------------------------------------------------------------------------

# SMPL-X's kinematic tree (55 joints: body, jaw and eyes, 2 x 15 hand joints)
SMPLX_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
                 15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
                 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53]
LEARN_METRICS = (  # (IoU, interscetion_ratio, num_inliers, samples): survivors, then rejects
    (0.9, 0.01, 5, N_SAMPLES), (0.5, 0.01, 5, 3), (0.9, 0.2, 5, 2), (0.9, 0.01, 0, 2))
LEARN_KEYS = ("qual:backpack_human_contact", "qual:backpack_object_contact",
              "qual:backpack_occupancy", "qual:backpack_orientation")
STAR_ATOL = 1e-5
RANK_RTOL, RANK_ATOL = 1e-4, 1e-5
RANK_TIMEOUT_S = 600


def write_smplx_npz(path: str, rng) -> None:
    """A seeded SMPL-X-shaped model in the official npz layout at the
    published widths: the phase 3 body (10475 vertices and its faces), 55
    joints, 400 shape and expression directions, posedirs (10475, 3, 486),
    12 hand PCA components. Skinning weights lean on the root (0.9), so the
    star pose bends the surface without tearing it."""
    verts, faces = human_template()
    V, J = len(verts), len(SMPLX_PARENTS)
    weights = 0.1 * rng.dirichlet(np.ones(J), size=V)
    weights[:, 0] += 0.9
    np.savez(
        path, v_template=verts, shapedirs=np.float32(rng.normal(size=(V, 3, 400)) * 1e-3),
        posedirs=np.float32(rng.normal(size=(V, 3, 486)) * 1e-3),
        J_regressor=rng.dirichlet(np.ones(V), size=J), weights=weights,
        kintree_table=np.stack([SMPLX_PARENTS, np.arange(J)]).astype(np.int64),
        hands_meanl=rng.normal(size=45) * 0.1, hands_meanr=rng.normal(size=45) * 0.1,
        hands_componentsl=rng.normal(size=(12, 45)), hands_componentsr=rng.normal(size=(12, 45)),
        f=faces.astype(np.uint32),
    )


def backpack_mesh(n_around: int = 40, n_up: int = 30):
    """The phase 3 backpack patch as a mesh 2 cm behind the body's back,
    faces wound outward."""
    theta = np.linspace(np.pi - 0.6, np.pi + 0.6, n_around)
    z = np.linspace(0.8, 1.4, n_up)
    radius = 0.3 + 0.05 * np.sin(np.pi * z / 1.7) + 0.02
    verts = np.stack([radius[:, None] * np.cos(theta), radius[:, None] * np.sin(theta),
                      np.broadcast_to(z[:, None], (n_up, n_around))], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_up - 1), np.arange(n_around - 1), indexing="ij")
    v00, v01 = i * n_around + j, i * n_around + j + 1
    v10, v11 = v00 + n_around, v01 + n_around
    faces = np.concatenate([np.stack([v00, v01, v11], -1).reshape(-1, 3),
                            np.stack([v00, v11, v10], -1).reshape(-1, 3)])
    return verts, faces


def write_learn_tree(root: str, rng) -> dict:
    """The learn_coma inputs under ``root``: ``smplx.npz``, ``backpack.obj``
    and the human samples with their filter metrics, one sentinel among them."""
    from coma_tpu_torch.geometry.mesh import save_obj

    write_smplx_npz(f"{root}/smplx.npz", rng)
    save_obj(f"{root}/backpack.obj", *backpack_mesh())
    verts, faces = human_template()
    samples = [m[:3] for m in LEARN_METRICS for _ in range(m[3])] + [None]
    for k, metrics in enumerate(samples):
        d = f"{root}/results/generation/human_sample/{SC}/{CAT}/{ASSET}/{k // 16:03d}/0/{PROMPT}"
        os.makedirs(d, exist_ok=True)
        yaw = rng.uniform(-0.1, 0.1)
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        payload = "NO HUMANS" if metrics is None else dict(
            verts=verts @ rot.T + rng.normal(scale=0.005, size=3)
            + rng.normal(scale=0.002, size=verts.shape), faces=faces,
            IoU=metrics[0], interscetion_ratio=metrics[1], num_inliers=metrics[2])
        with open(f"{d}/{k % 16:05d}.pickle", "wb") as fh:
            pickle.dump(payload, fh)
    return dict(root=root, samples=len(samples))


def star_pose_check(npz: str, star_pickle: str, label: str):
    """The star template learn_coma wrote (from the card) against the CPU's
    LBS on the same npz, within 1e-5; then the card's SMPL-X forward in ms."""
    from coma_tpu_torch.models.smplx import SMPLXModel, star_pose_vertices

    with open(star_pickle, "rb") as fh:
        card = pickle.load(fh)["vertices"]
    cpu = star_pose_vertices(SMPLXModel.from_npz(npz, device="cpu")).numpy()
    err = float(np.abs(card - cpu).max())
    if card.shape != (H_FULL, 3) or not err <= STAR_ATOL:
        raise AssertionError(f"star pose: card vs CPU max abs {err:.3e} (limit {STAR_ATOL:.0e})")
    model = SMPLXModel.from_npz(npz, device=DEVICE)
    ms = cuda_ms(lambda: star_pose_vertices(model), reps=10)
    log(f"SMPL-X star pose (V={H_FULL}, 55 joints, posedirs {tuple(model.posedirs.shape)}): card "
        f"vs CPU max abs {err:.3e} (limit {STAR_ATOL:.0e}); forward {ms:.3f} ms on the card [{label}]")
    return err, ms


def learn_coma(root: str, label: str) -> dict:
    """``cli/learn_coma`` on the tree, every kernel's counter from 0; the
    checks: the filter's rejections, K1 and K2 launched and K3 not, the star
    pose, ``used_count`` equal to the survivors in each pickle, the four
    products' rules."""
    from coma_tpu_torch import native
    from coma_tpu_torch.cli import learn_coma as cli
    from coma_tpu_torch.config.hyperparams import get_hyperparams
    from coma_tpu_torch.ops import attention, contact_kernel, occupancy_kernel

    cwd = os.getcwd()
    os.chdir(root)
    try:
        contact_kernel.launches = 0
        occupancy_kernel.launches = 0
        attention.launches = 0
        t0 = time.perf_counter()
        out = cli.main(["--smplx_model_path", "smplx.npz", "--obj_pth", "backpack.obj",
                        "--supercategory", SC, "--category", CAT, "--asset_id", ASSET,
                        "--device", DEVICE])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"contact_splat": contact_kernel.launches,
                    "occupancy_hits": occupancy_kernel.launches,
                    "flash_attention": attention.launches}
    finally:
        os.chdir(cwd)
    survivors = LEARN_METRICS[0][3]
    want = dict(rejected_iou=LEARN_METRICS[1][3], rejected_intersection=LEARN_METRICS[2][3],
                rejected_inliers=LEARN_METRICS[3][3])
    if {k: out["filter"][k] for k in want} != want or out["filter"]["leftover"] != survivors:
        raise AssertionError(f"filter: {out['filter']}, expected {want}")
    if not (launches["contact_splat"] and launches["occupancy_hits"]) \
            or launches["flash_attention"]:
        raise AssertionError(f"learn_coma must launch K1 and K2, not K3: {launches}")
    log(f"learn_coma: {seconds:.3f} s, stages " + ", ".join(
        f"{k} {v:.3f} s" for k, v in out["seconds"].items()) + f"; poisson-disk elimination: "
        f"{native.path_name()}; filter {out['filter']}; launches {launches} [{label}]")
    star = star_pose_check(f"{root}/smplx.npz", f"{root}/constants/mesh/smplx_star.pickle",
                           label)
    tree = f"{root}/results/coma"
    for key in LEARN_KEYS:
        with open(f"{tree}/extracted_coma/{SC}/{CAT}/{ASSET}/{key}:{PROMPT}.pickle", "rb") as fh:
            d = pickle.load(fh)
        if d["used_count"] != survivors:
            raise AssertionError(f"learn_coma {key}: used_count {d['used_count']} != {survivors}")
        (product,) = out[f"extract ({key})"]
        vt = get_hyperparams(key)["visualize_type"]
        n = d["obj_res"] if vt == "aggr-object-contact" else d["human_res"]
        log(f"learn_coma {key}: used_count {d['used_count']}, H={d['human_res']}, "
            f"O={d['obj_res']}; {vt}: {check_product(vt, os.path.join(root, product), n)} "
            f"[{label}]")
        del d
    return dict(seconds=seconds, stage_seconds=out["seconds"], launches=launches,
                star_pose_max_abs_err=star[0], smplx_forward_ms=star[1],
                native=native.path_name())


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(world: int, style: str, argv: list, report_key: str, cwd: str = REPO):
    """``python argv`` in ``world`` processes with the launch variables of
    ``style`` (torchrun's or COMA_*); returns (wall clock of the processes,
    each rank's ``{report_key: ...}`` line, in rank order)."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO)
        if style == "torchrun":
            env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
        else:
            env.update(COMA_COORDINATOR=f"localhost:{port}", COMA_NUM_PROCESSES=str(world),
                       COMA_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, *argv], cwd=cwd, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{world} ranks of {argv[:3]} failed:\n" + "\n".join(
            o[-3000:] for o in outs))
    reports = []
    for out in outs:
        lines = [json.loads(l)[report_key] for l in out.splitlines()
                 if l.startswith('{"%s"' % report_key)]
        if len(lines) != 1:
            raise AssertionError(f"a rank printed {len(lines)} reports:\n{out[-3000:]}")
        reports.append(lines[0])
    return seconds, sorted(reports, key=lambda r: r["rank"])


def extract_on_ranks(paths, key: str, backend: str, world: int, style: str, label: str):
    """``cli/extract_coma --multihost`` in ``world`` processes (launch
    variables of ``style``: torchrun's or COMA_*); returns (wall clock of the
    processes, each rank's report)."""
    return spawn_ranks(world, style, [
        "-m", "coma_tpu_torch.cli.extract_coma", "--multihost", "--dist_backend", backend,
        "--device", DEVICE, "--human_sample_dir", f"{paths['tree'].root}/generation/human_sample",
        "--constants_mesh_dir", paths["constants"], "--hyperparams_key", key], "extract_rank")


def compare_rank_pickle(key: str, got_path: str, want_path: str) -> dict:
    """The ranks' pickle against the single process's: contact fields within
    1e-5 + 1e-4 |x| (on the card), occupancy hits, counts and anchor equal."""
    with open(got_path, "rb") as fh:
        got = pickle.load(fh)
    with open(want_path, "rb") as fh:
        want = pickle.load(fh)
    if got["used_count"] != want["used_count"]:
        raise AssertionError(f"{key}: used_count {got['used_count']} != {want['used_count']}")
    if "spatial_occupancy_grids" in want:
        differing = int((got["spatial_occupancy_grids"] != want["spatial_occupancy_grids"]).sum())
        if differing or not np.array_equal(got["debug_obj_vert"], want["debug_obj_vert"]):
            raise AssertionError(f"{key}: {differing} differing occupancy cells, anchors "
                                 f"{got['debug_obj_vert']} vs {want['debug_obj_vert']}")
        return dict(differing_cells=0, max_abs_err=0.0)
    worst = 0.0
    for f in ("prob_grid_canon_human_wrt_obj", "prob_grid_canon_obj_wrt_human",
              "contact_dist_expectation_grid_nom", "contact_dist_expectation_grid_denom",
              "significant_contact_count"):
        a = torch.from_numpy(got[f]).to(DEVICE)
        b = torch.from_numpy(want[f]).to(DEVICE)
        err = (a - b).abs()
        if bool((err > RANK_ATOL + RANK_RTOL * b.abs()).any()) or not torch.isfinite(a).all():
            raise AssertionError(f"{key}: the ranks' {f} differs by {float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
        del a, b, err
    return dict(max_abs_err=worst)


def extractions_on_two_ranks(paths, single: dict, label: str) -> list:
    """Phase 3's two extractions on two ranks, each against phase 3's pickle:
    under gloo with both ranks on card 0, and under NCCL with a card per
    rank where the machine has two. Every rank must launch its kernel."""
    runs = [("gloo", "torchrun")] + ([("nccl", "coma")] if torch.cuda.device_count() >= 2 else [])
    if len(runs) == 1:
        log(f"NCCL on two ranks: skipped, {torch.cuda.device_count()} card(s) on this machine "
            f"[{label}]")
    results = []
    for backend, style in runs:
        for key, kernel in (("qual:backpack_human_contact", "contact_splat"),
                            ("qual:backpack_occupancy", "occupancy_hits")):
            seconds, reports = extract_on_ranks(paths, key, backend, 2, style, label)
            launches = [r["launches"][kernel] for r in reports]
            if len(reports) != 2 or not all(n > 0 for n in launches):
                raise AssertionError(f"{backend} {key}: {kernel} launches per rank {launches}")
            diff = compare_rank_pickle(key, single[key]["path"], single[key]["single_path"])
            one = single[key]["seconds"]
            log(f"2 ranks ({backend}, {style} variables) {key}: processes {seconds:.3f} s, "
                f"in-process CLI " + ", ".join(f"rank {r['rank']} {r['seconds']:.3f} s" for r in reports)
                + f" against one rank's {one:.3f} s (phase 3); equal to one rank's pickle "
                f"({diff}); " + "; ".join(
                    f"rank {r['rank']} on {r['device']}: launches {r['launches']}, "
                    f"waited {r['wait_ms']:.3f} ms for the other rank (the sample count's "
                    f"all-reduce), then all-reduce "
                    f"{r['allreduce_ms']:.3f} ms for {r['allreduce_bytes']} bytes, "
                    f"peak device memory {r['peak_device_gb']} GB" for r in reports)
                + f" [{label}]")
            results.append(dict(backend=backend, key=key, seconds=seconds, one_rank_seconds=one,
                                ranks=reports, **diff))
    return results


# ---------------------------------------------------------------------------
# Phase 5: K3 (flash attention) against its plain version
# ---------------------------------------------------------------------------

PEAK_BF16_OPS = 989e12   # H100 SXM, dense bf16 tensor cores (data sheet)
K3_SHAPES = (  # (name, B, H, Lq, Lk, D, dtype): phase 6's, CFG doubling the UNet's batch
    ("unet_self_64x64", 8, 8, 4096, 4096, 40, torch.bfloat16),
    ("unet_cross_64x64", 8, 8, 4096, 77, 40, torch.bfloat16),
    ("unet_self_32x32", 8, 8, 1024, 1024, 80, torch.bfloat16),
    ("unet_cross_32x32", 8, 8, 1024, 77, 80, torch.bfloat16),
    ("unet_self_16x16", 8, 8, 256, 256, 160, torch.bfloat16),
    ("unet_cross_16x16", 8, 8, 256, 77, 160, torch.bfloat16),
    ("unet_mid_self_8x8", 8, 8, 64, 64, 160, torch.bfloat16),
    ("unet_mid_cross_8x8", 8, 8, 64, 77, 160, torch.bfloat16),
    ("vae_mid", 4, 1, 4096, 4096, 512, torch.bfloat16),
    # phase 6b's SD-2 UNet: heads 5/10/20/20 of 64 channels
    ("sd2_unet_self_64x64", 8, 5, 4096, 4096, 64, torch.bfloat16),
    ("sd2_unet_cross_64x64", 8, 5, 4096, 77, 64, torch.bfloat16),
    ("sd2_unet_self_32x32", 8, 10, 1024, 1024, 64, torch.bfloat16),
    ("sd2_unet_cross_32x32", 8, 10, 1024, 77, 64, torch.bfloat16),
    ("sd2_unet_self_16x16", 8, 20, 256, 256, 64, torch.bfloat16),
    ("sd2_unet_cross_16x16", 8, 20, 256, 77, 64, torch.bfloat16),
    ("sd2_unet_mid_self_8x8", 8, 20, 64, 64, 64, torch.bfloat16),
    ("sd2_unet_mid_cross_8x8", 8, 20, 64, 77, 64, torch.bfloat16),
)
K3_F32_SHAPES = (  # (name, B, H, Lq, Lk, D, batch rows held): SD-1's UNet and VAE in float32
    ("unet_self_32x32_f32", 8, 8, 1024, 1024, 80, None),
    ("unet_self_64x64_f32", 8, 8, 4096, 4096, 40, (0, 7)),
    ("unet_cross_64x64_f32", 8, 8, 4096, 77, 40, None),
    ("unet_cross_32x32_f32", 8, 8, 1024, 77, 80, None),
    ("unet_self_16x16_f32", 8, 8, 256, 256, 160, None),
    ("unet_cross_16x16_f32", 8, 8, 256, 77, 160, None),
    ("unet_mid_self_8x8_f32", 8, 8, 64, 64, 160, None),
    ("unet_mid_cross_8x8_f32", 8, 8, 64, 77, 160, None),
    ("vae_mid_f32", 4, 1, 4096, 4096, 512, None),
)
K3_BF16_ATOL, K3_BF16_RTOL, K3_F32_ATOL = 5e-4, 8e-3, 1e-4


K3_PROFILE_WINDOWS = 3   # a window in which CUPTI recorded no device activity is taken again


def k3_profile(q, k, v, reps: int):
    """One ``torch.profiler`` window over ``reps`` K3 calls and one
    ``F.scaled_dot_product_attention`` call: K3's device ms per launch (the
    mean over the launches the profiler recorded), and the names of the
    device kernels SDPA ran (which backend took the call). A window that
    recorded no device time of K3 is taken again, ``K3_PROFILE_WINDOWS`` in
    all; if none does, it raises."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from coma_tpu_torch.ops.attention import scaled_dot_attention

    for _ in range(K3_PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                scaled_dot_attention(q, k, v)
            F.scaled_dot_product_attention(q, k, v)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        k3 = [e for e in events if "flash_attention" in e.key]
        if k3 and sum(e.self_device_time_total for e in k3) > 0:
            break
    else:
        raise AssertionError(f"the profiler saw no device time of K3 in {K3_PROFILE_WINDOWS} "
                             "windows")
    device_ms = sum(e.self_device_time_total for e in k3) / sum(e.count for e in k3) / 1e3
    sdpa = sorted(e.key for e in events if "flash_attention" not in e.key)
    return device_ms, "; ".join(sdpa) or "no device kernel seen"


def tiny_k3_shapes():
    """The float32 shapes the tiny loop (64², 'baseline' mode) gives K3, read
    from ``attention.shape_launches`` after one tiny UNet call at its batch
    (2 images under guidance) and one VAE encode and decode on the card."""
    from coma_tpu_torch.models.diffusion import unet, vae
    from coma_tpu_torch.models.layers import init_flax_default_
    from coma_tpu_torch.ops import attention

    g = torch.Generator().manual_seed(SEED)
    cfg = unet.tiny_unet_config()
    net = init_flax_default_(unet.UNet2DCondition(cfg), g).to(DEVICE).eval()
    enc, dec = (init_flax_default_(m(vae.tiny_vae_config()), g).to(DEVICE).eval()
                for m in (vae.Encoder, vae.Decoder))
    rng = np.random.default_rng(SEED)

    def rand(*shape):
        return torch.from_numpy(np.float32(rng.normal(size=shape))).to(DEVICE)

    attention.shape_launches.clear()
    with torch.no_grad():
        net(rand(4, cfg.in_channels, 8, 8), torch.full((4,), 500.0, device=DEVICE),
            rand(4, 7, cfg.cross_attention_dim))
        enc(rand(2, 3, 64, 64))
        dec(rand(2, 4, 8, 8))
    torch.cuda.synchronize()
    shapes = sorted(s[:5] for s in attention.shape_launches if s[5] == "float32")
    attention.shape_launches.clear()
    if not shapes:
        raise AssertionError("the tiny UNet and VAE gave K3 no float32 call")
    return [(f"tiny_{Lq}x{Lk}_d{D}", B, H, Lq, Lk, D, None) for B, H, Lq, Lk, D in shapes]


def check_k3(rng, name, B, H, Lq, Lk, D, dtype, rows=None):
    """Kernel vs the plain version computed in fp32 from the same inputs (on
    the batch ``rows`` only, where given: the fp32 scores of a whole batch
    can be too large); times of the kernel, the plain version (in the input
    dtype) and SDPA on the whole batch."""
    import torch.nn.functional as F

    from coma_tpu_torch.ops.attention import KERNELS, attention_reference, scaled_dot_attention

    q, k, v = (torch.from_numpy(np.float32(rng.normal(size=(B, H, n, D)))).to(DEVICE, dtype)
               for n in (Lq, Lk, Lk))
    sel = slice(None) if rows is None else list(rows)
    out = scaled_dot_attention(q, k, v)[sel]
    want = attention_reference(q[sel].float(), k[sel].float(), v[sel].float())
    torch.cuda.synchronize()
    err = (out.float() - want).abs()
    rtol = K3_BF16_RTOL if dtype == torch.bfloat16 else 0.0
    atol = K3_BF16_ATOL if dtype == torch.bfloat16 else K3_F32_ATOL
    max_abs = float(err.max())
    atol_used = float((err - rtol * want.abs()).max())   # the least atol that passes
    if atol_used > atol or not torch.isfinite(out).all():
        raise AssertionError(f"K3 {name}: kernel disagrees with plain (max abs {max_abs:.3e}, "
                             f"needs atol {atol_used:.3e} > {atol:.0e} with rtol {rtol:.0e})")
    del out, want, err
    # float32 shapes of a few µs a call: more calls, as the host's call dominates
    reps = 10 if dtype == torch.bfloat16 or B * H * Lq * Lk * D > 1e8 else 100
    ms = cuda_ms(lambda: scaled_dot_attention(q, k, v), reps=reps)
    plain_ms = cuda_ms(lambda: attention_reference(q, k, v), reps=3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps=reps)
    extra = {}
    if dtype == torch.float32:
        from coma_tpu_torch.ops.attention import f32_tile

        rows_per_block, smem, per_sm = f32_tile(B * H, Lq, D)
        device_ms, backend = k3_profile(q, k, v, reps)
        extra = dict(device_ms=device_ms, sdpa_backend=backend, block_rows=rows_per_block,
                     dynamic_smem_bytes=smem, blocks_per_sm=per_sm)
    torch.cuda.empty_cache()
    size = torch.finfo(dtype).bits // 8
    nbytes = size * B * H * (2 * Lq + 2 * Lk) * D
    peak = PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_F32_OPS
    bound_ms, bound_by = bound(4.0 * B * H * Lq * Lk * D, nbytes, peak)
    return dict(shape=f"{name} ({B}, {H}, {Lq}, {Lk}, {D}) {str(dtype)[6:]}"
                + ("" if rows is None else f", rows {list(rows)} held"),
                source=f"coma_tpu_torch/csrc/{KERNELS[dtype][0]}.cu",
                max_abs_err=max_abs, atol_used=atol_used, atol=atol, rtol=rtol, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms, ratio_to_sdpa=ms / library_ms, **extra)


def log_k3_f32(r, label) -> None:
    log(f"K3 {r['shape']}: kernel {r['ms']:.4f} ms a call (device {r['device_ms']:.4f} ms), "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), share of bound "
        f"{r['share_of_bound']:.3f}; SDPA {r['library_ms']:.4f} "
        f"ms (kernel/SDPA {r['ratio_to_sdpa']:.3f}; {r['sdpa_backend']}); plain "
        f"{r['plain_ms']:.4f} ms, max abs err {r['max_abs_err']:.3e} (limit {r['atol']:.0e}); "
        f"instance of {r['block_rows']} query rows a block, {r['dynamic_smem_bytes']} B of "
        f"dynamic shared memory, {r['blocks_per_sm']} block(s) an SM [{label}]")


# ---------------------------------------------------------------------------
# Phase 6: inpainting through the CLI, and a tiny loop against the CPU
# ---------------------------------------------------------------------------

INPAINT_RES, INPAINT_IMAGES = 512, 4   # 1 mask x 1 prompt x 2 view texts x 2 seeds
K3_LAUNCHES_PER_BATCH = 50 * 32 + 44   # UNet: 16 blocks x 2 attentions x 50 steps; VAE: 44


def write_inpaint_tree(root: str, rng, mask_box=None) -> None:
    """A render, an asset mask (rows res/8..7res/8, columns res/4..3res/4, or
    ``mask_box`` = (top, bottom, left, right)), its valid-mask pickle and one
    prompt."""
    from coma_tpu_torch.utils.png import write_png

    res, view = INPAINT_RES, "view:00000"
    g = f"{root}/results/generation"
    base = f"{SC}/{CAT}/{ASSET}"
    for d in (f"renders/{base}", f"valid_masks/{base}", f"prompts/{base}",
              f"asset_masks/{base}/{view}"):
        os.makedirs(f"{g}/{d}", exist_ok=True)
    yy, xx = np.mgrid[:res, :res] / res
    render = np.stack([yy, xx, 0.5 + 0.5 * np.sin(6 * xx)], -1) * 200 \
        + rng.integers(0, 55, size=(res, res, 3))
    write_png(f"{g}/renders/{base}/{view}.png", np.uint8(render))
    top, bottom, left, right = mask_box or (res // 8, 7 * res // 8, res // 4, 3 * res // 4)
    mask = np.zeros((res, res), np.uint8)
    mask[top:bottom, left:right] = 255
    write_png(f"{g}/asset_masks/{base}/{view}/0.png", mask)
    with open(f"{g}/valid_masks/{base}/{view}.pickle", "wb") as fh:
        pickle.dump({"valid_mask_ids": [0]}, fh)
    with open(f"{g}/prompts/{base}/prompts.pickle", "wb") as fh:
        pickle.dump({"prompts": [PROMPT]}, fh)


def inpaint(root: str, label: str, flags=("--random_weights",), what="bf16, 50 steps, mode p",
            mode="p"):
    """``cli/inpaint`` at full width with ``flags`` in ``mode``; returns
    (seconds, peak GB, outputs)."""
    from coma_tpu_torch.cli import inpaint as cli
    from coma_tpu_torch.models.diffusion.pipeline import AdaptiveMaskInpaintPipeline
    from coma_tpu_torch.utils.png import read_png

    outputs, generate = [], AdaptiveMaskInpaintPipeline.generate

    def kept(self, *args, **kwargs):     # keep the float images for the finiteness check
        out = generate(self, *args, **kwargs)
        outputs.append((out[0] if isinstance(out, tuple) else out).float().cpu())
        return out

    AdaptiveMaskInpaintPipeline.generate = kept
    cwd = os.getcwd()
    os.chdir(root)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli.main([*flags, "--device", DEVICE, "--num_img_per_combination", "2",
                  "--batch_size", str(INPAINT_IMAGES), "--adaptive_mask_model_type", mode])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        AdaptiveMaskInpaintPipeline.generate = generate
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pngs = sorted(Path(root, "results", "generation", "inpaintings").rglob("*.png"))
    if len(pngs) != INPAINT_IMAGES or len(outputs) != 1:
        raise AssertionError(f"inpaint wrote {len(pngs)} images in {len(outputs)} batches")
    for p in pngs:
        img = read_png(str(p))
        if img.shape != (INPAINT_RES, INPAINT_RES, 3):
            raise AssertionError(f"{p}: shape {img.shape}")
    out = outputs[0]
    if out.shape != (INPAINT_IMAGES, 3, INPAINT_RES, INPAINT_RES) or not torch.isfinite(out).all() \
            or out.min() < 0 or out.max() > 1:
        raise AssertionError(f"inpaint output: shape {tuple(out.shape)}, "
                             f"finite {bool(torch.isfinite(out).all())}")
    log(f"inpaint {INPAINT_IMAGES} images at {INPAINT_RES}², {what}: "
        f"{seconds:.3f} s = {INPAINT_IMAGES / seconds:.4f} images/s (CLI wall clock: models, "
        f"prompts, the loop, PNGs), peak device memory {peak_gb:.3f} GB [{label}]")
    return seconds, peak_gb, out


TINY_LOOP_K3_LAUNCHES = 50 * 20 + 2   # 10 transformer blocks x 2 x 50 steps; a VAE encode, decode


def tiny_loop_against_cpu():
    """The tiny f32 loop ('baseline' mode, no segmenter) on the card, K3
    included, against the same loop on the CPU with the plain attention; the
    same weights and noise. cuDNN's TF32 is switched off for this comparison.
    K3's counters are set to 0 before the card's run and read after: every
    launch on the float32 kernel. Returns (max abs difference, launches)."""
    import copy

    from coma_tpu_torch.models.diffusion import pipeline, unet, vae
    from coma_tpu_torch.models.layers import init_flax_default_
    from coma_tpu_torch.ops import attention

    g = torch.Generator().manual_seed(SEED)
    models = [init_flax_default_(unet.UNet2DCondition(unet.tiny_unet_config()), g),
              init_flax_default_(vae.Encoder(vae.tiny_vae_config()), g),
              init_flax_default_(vae.Decoder(vae.tiny_vae_config()), g)]
    rng = np.random.default_rng(SEED)
    image = torch.from_numpy(np.float32(rng.uniform(-1, 1, size=(2, 3, 64, 64))))
    mask = torch.zeros(2, 64, 64)
    mask[:, 8:56, 12:52] = 1.0
    ctx = torch.from_numpy(np.float32(rng.normal(size=(2, 7, 32))))
    outs = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    reset_k3_counters()
    try:
        for dev in ("cpu", DEVICE):
            m = [copy.deepcopy(x).to(dev).eval() for x in models]
            pipe = pipeline.AdaptiveMaskInpaintPipeline(
                *m, None, pipeline.AdaptiveMaskConfig(use_adaptive_mask=False))
            noise = pipeline.TorchNoise(torch.Generator().manual_seed(SEED + 1))
            outs.append(pipe.generate(image.to(dev), mask.to(dev), ctx.to(dev),
                                      ctx.to(dev) * 0, noise=noise).cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    launches = dict(attention.source_launches)
    err = float((outs[0] - outs[1]).abs().max())
    if not torch.isfinite(outs[1]).all() or err > 1e-3:
        raise AssertionError(f"tiny loop: card vs CPU max abs {err:.3e} (limit 1e-3)")
    if launches["flash_attention"] != TINY_LOOP_K3_LAUNCHES or attention.launches != \
            TINY_LOOP_K3_LAUNCHES:
        raise AssertionError(f"tiny loop: K3 launches {launches}, expected "
                             f"{TINY_LOOP_K3_LAUNCHES}, all on the float32 kernel")
    log(f"tiny loop (64², f32, 50 steps) on the card vs the CPU: max abs {err:.3e}; K3 "
        f"launches {launches}")
    return err, launches["flash_attention"]


# ---------------------------------------------------------------------------
# Phase 6b: inpainting from a diffusers directory at SD-2-inpainting's widths
# ---------------------------------------------------------------------------

SD2_UNET_JSON = dict(  # stabilityai/stable-diffusion-2-inpainting, unet/config.json
    in_channels=9, out_channels=4, block_out_channels=[320, 640, 1280, 1280],
    layers_per_block=2, cross_attention_dim=1024, attention_head_dim=[5, 10, 20, 20],
    norm_num_groups=32, use_linear_projection=True,
    down_block_types=["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"])
SD2_CLIP_JSON = dict(  # its text_encoder/config.json (OpenCLIP ViT-H, penultimate layer)
    vocab_size=49408, hidden_size=1024, intermediate_size=4096, num_hidden_layers=23,
    num_attention_heads=16, max_position_embeddings=77, hidden_act="gelu")
SD2_VAE_JSON = dict(in_channels=3, latent_channels=4, block_out_channels=[128, 256, 512, 512],
                    layers_per_block=2, norm_num_groups=32, scaling_factor=0.18215)
SD_WEIGHTS_DTYPE = "F16"


def write_vocab(d: str) -> None:
    """A miniature CLIP vocabulary holding every byte symbol (alone and
    word-final), so any prompt tokenizes; one merge."""
    from coma_tpu_torch.models.diffusion.tokenizer import bytes_to_unicode

    os.makedirs(d, exist_ok=True)
    vocab = {"<|startoftext|>": 49406, "<|endoftext|>": 49407}
    for ch in bytes_to_unicode().values():
        for tok in (ch, ch + "</w>"):
            vocab.setdefault(tok, len(vocab) - 2)
    vocab.setdefault("pe", len(vocab) - 2)
    with open(f"{d}/vocab.json", "w") as fh:
        json.dump(vocab, fh)
    with open(f"{d}/merges.txt", "w") as fh:
        fh.write("#version: 0.2\np e\n")


def write_sd2_dir(d: str, seed: int) -> dict:
    """A diffusers SD-2-inpainting directory from seeded random weights
    (Flax's initialisers, made on the card), written by the port's writer in
    F16, ``proj_in``/``proj_out`` as Linear weights; returns sizes and seconds."""
    from coma_tpu_torch.models.diffusion import weights as W
    from coma_tpu_torch.models.diffusion.clip_text import CLIPTextEncoder, sd2_clip_text_config
    from coma_tpu_torch.models.diffusion.unet import UNet2DCondition, sd2_inpaint_unet_config
    from coma_tpu_torch.models.diffusion.vae import Decoder, Encoder, VAEConfig
    from coma_tpu_torch.models.layers import init_flax_default_

    t0 = time.perf_counter()
    g = torch.Generator(DEVICE).manual_seed(seed)
    for sub, cfg in (("unet", SD2_UNET_JSON), ("vae", SD2_VAE_JSON),
                     ("text_encoder", SD2_CLIP_JSON)):
        os.makedirs(f"{d}/{sub}", exist_ok=True)
        with open(f"{d}/{sub}/config.json", "w") as fh:
            json.dump(cfg, fh)
    write_vocab(f"{d}/tokenizer")
    ucfg = sd2_inpaint_unet_config(torch.float32)
    unet = init_flax_default_(UNet2DCondition(ucfg, device=DEVICE), g)
    W.write_safetensors(f"{d}/{W.UNET_FILE}", W.export_state_dict(
        unet.state_dict(), W.unet_key_map(ucfg), linear_projection=True), SD_WEIGHTS_DTYPE)
    n_unet = sum(p.numel() for p in unet.parameters())
    del unet
    vcfg = VAEConfig()
    enc_map, dec_map = W.vae_key_map(vcfg)
    enc = init_flax_default_(Encoder(vcfg, device=DEVICE), g)
    dec = init_flax_default_(Decoder(vcfg, device=DEVICE), g)
    W.write_safetensors(f"{d}/{W.VAE_FILE}", {**W.export_state_dict(enc.state_dict(), enc_map),
                                             **W.export_state_dict(dec.state_dict(), dec_map)},
                        SD_WEIGHTS_DTYPE)
    del enc, dec
    ccfg = sd2_clip_text_config()
    clip = init_flax_default_(CLIPTextEncoder(ccfg, device=DEVICE), g)
    W.write_safetensors(f"{d}/{W.CLIP_FILE}", W.export_state_dict(
        clip.state_dict(), W.clip_key_map(ccfg)), SD_WEIGHTS_DTYPE)
    n_clip = sum(p.numel() for p in clip.parameters())
    del clip
    torch.cuda.empty_cache()
    nbytes = sum(os.path.getsize(f"{d}/{f}") for f in (W.UNET_FILE, W.VAE_FILE, W.CLIP_FILE))
    return dict(write_seconds=time.perf_counter() - t0, bytes=nbytes, unet_params=n_unet,
                clip_params=n_clip)


def launches_by_head_dim() -> dict:
    """K3's launches since the counters were reset, by (dtype, head dim)."""
    from coma_tpu_torch.ops import attention

    out = {}
    for (_, _, _, _, D, dtype), n in attention.shape_launches.items():
        out[f"{dtype} D={D}"] = out.get(f"{dtype} D={D}", 0) + n
    return out


def reset_k3_counters() -> None:
    from coma_tpu_torch.ops import attention

    attention.launches = 0
    for src in attention.source_launches:
        attention.source_launches[src] = 0
    attention.shape_launches.clear()


def inpaint_sd2(label: str) -> dict:
    """Phase 6b: write the directory, then ``cli/inpaint --weights_dir`` on
    phase 6's tree, K3's counters from 0; checks the images and that every
    K3 launch is bf16: 1600 UNet launches at D = 64 and 44 VAE ones at 512."""
    from coma_tpu_torch.models.diffusion import weights as W
    from coma_tpu_torch.ops import attention

    with tempfile.TemporaryDirectory(prefix="sd2_", dir=SCRATCH) as tmp:
        written = write_sd2_dir(f"{tmp}/sd2", SEED + 5)
        write_inpaint_tree(tmp, np.random.default_rng(SEED + 2))
        load_seconds, load = [], W.load_sd_params

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = load(*args, **kwargs)
            load_seconds.append(time.perf_counter() - t0)
            return out

        W.load_sd_params = timed
        reset_k3_counters()
        try:
            seconds, peak_gb, _ = inpaint(tmp, label, ("--weights_dir", f"{tmp}/sd2"),
                                          "SD-2-inpainting widths from --weights_dir, bf16 UNet, "
                                          "50 steps, mode p")
        finally:
            W.load_sd_params = load
        by_dim = launches_by_head_dim()
        total = attention.launches
    want = {"bfloat16 D=64": 50 * 32, "bfloat16 D=512": 44}
    if by_dim != want or total != K3_LAUNCHES_PER_BATCH or len(load_seconds) != 1:
        raise AssertionError(f"SD-2 run: K3 launches {by_dim} (total {total}), expected {want}; "
                             f"{len(load_seconds)} loads")
    log(f"SD-2 directory: {written['bytes']} bytes in {SD_WEIGHTS_DTYPE} (UNet "
        f"{written['unet_params']} parameters, CLIP {written['clip_params']}), written in "
        f"{written['write_seconds']:.3f} s; load_sd_params {load_seconds[0]:.3f} s; the CLI "
        f"{seconds:.3f} s = {INPAINT_IMAGES / seconds:.4f} images/s, "
        f"{INPAINT_IMAGES / (seconds - load_seconds[0]):.4f} images/s past the load; K3 "
        f"launches by head dim {by_dim} [{label}]")
    return dict(seconds=seconds, load_seconds=load_seconds[0], peak_gb=peak_gb,
                images_per_s=INPAINT_IMAGES / seconds, launches=total,
                launches_by_head_dim=by_dim, **written)


# ---------------------------------------------------------------------------
# Phase 6c: phase 6's run with --provoke_crop auto
# ---------------------------------------------------------------------------

# rows, columns of the default mask: 192 x 128 pixels, so at 512² auto takes
# the 40-latent bucket (24 x 16 latents plus a 6-latent halo on each side)
CROP_MASK_BOX = (160, 352, 192, 320)


def crop_bucket() -> int:
    """The bucket ``--provoke_crop auto`` takes for phase 6c's mask."""
    from coma_tpu_torch.models.diffusion.pipeline import choose_crop_latent

    mask = np.zeros((INPAINT_RES, INPAINT_RES), np.float32)
    top, bottom, left, right = CROP_MASK_BOX
    mask[top:bottom, left:right] = 1.0
    return choose_crop_latent(mask[None])


def inpaint_cropped(label: str, full_frame_seconds: float) -> dict:
    """Phase 6c: ``--provoke_crop auto`` on a tree whose mask lets it crop;
    the bucket taken, K3's launches at the crop's VAE shapes (a decode and an
    encode in each of the 21 provoke rounds), the wall clock beside phase 6's."""
    from coma_tpu_torch.cli import inpaint as cli
    from coma_tpu_torch.ops import attention

    taken, choose = [], cli.provoke_crop_for

    def recorded(*args, **kwargs):
        taken.append(choose(*args, **kwargs))
        return taken[-1]

    with tempfile.TemporaryDirectory(prefix="crop_", dir=SCRATCH) as tmp:
        write_inpaint_tree(tmp, np.random.default_rng(SEED + 2), CROP_MASK_BOX)
        cli.provoke_crop_for = recorded
        reset_k3_counters()
        try:
            seconds, peak_gb, _ = inpaint(tmp, label, ("--random_weights", "--provoke_crop",
                                                       "auto"), "bf16, 50 steps, mode p, "
                                          "--provoke_crop auto")
        finally:
            cli.provoke_crop_for = choose
        shapes = dict(attention.shape_launches)
        total = attention.launches
    c = crop_bucket()
    crop_shape = (INPAINT_IMAGES, 1, c * c, c * c, 512, "bfloat16")
    full_shape = (INPAINT_IMAGES, 1, 4096, 4096, 512, "bfloat16")
    if taken != [c] or not c or shapes.get(crop_shape) != 42 or shapes.get(full_shape) != 2 \
            or total != K3_LAUNCHES_PER_BATCH:
        raise AssertionError(f"crop run: buckets {taken} (expected [{c}]), K3 launches {shapes}")
    log(f"inpaint --provoke_crop auto: bucket {c} latents, K3 {shapes[crop_shape]} launches at "
        f"{crop_shape[:5]} and {shapes[full_shape]} at the full frame's {full_shape[:5]}; "
        f"{seconds:.3f} s against phase 6's {full_frame_seconds:.3f} s (its mask declines the "
        f"crop) [{label}]")
    return dict(bucket=c, seconds=seconds, peak_gb=peak_gb, launches=total,
                crop_shape_launches=shapes[crop_shape], full_frame_seconds=full_frame_seconds)


# ---------------------------------------------------------------------------
# Phases 8-10: the segmenters in the loop, and segment_human
# ---------------------------------------------------------------------------

SEG_ATOL, SEG_RTOL = 1e-3, 1e-3   # card vs CPU, float32 on both with TF32 off
SEG_MASK_SHARE = 1e-3             # mask pixels allowed to differ (logits at the threshold)
PR_BOX_ATOL = 1e-2                # px
PROVOKE_ROUNDS = 21


class ForwardTimer:
    """CUDA events around every call of ``cls.forward`` while the ``with``
    block runs (the device's time between them, kernels and any gaps)."""

    def __init__(self, cls):
        self.cls, self.pairs = cls, []

    def __enter__(self):
        forward, pairs = self.cls.forward, self.pairs
        self.forward = forward

        def timed(module, *args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = forward(module, *args, **kwargs)
            end.record()
            pairs.append((start, end))
            return out

        self.cls.forward = timed
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.forward

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.pairs]


class NoTF32:
    def __enter__(self):
        self.saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def fresh_outputs(root: str) -> None:
    shutil.rmtree(f"{root}/results/generation/inpaintings", ignore_errors=True)


def ms_summary(ms: list) -> str:
    return (f"{np.mean(ms):.3f} ms mean (min {np.min(ms):.3f}, max {np.max(ms):.3f}) over "
            f"{len(ms)} provoke steps")


def sam_card_vs_cpu(label: str) -> dict:
    """The CLI's seeded SAM ViT-B at 1024² on one seeded image and box, on
    the card and on the CPU."""
    import copy

    from coma_tpu_torch.models import sam

    cfg = sam.SAMConfig()
    model = sam.init_sam_random_(sam.SAM(cfg), torch.Generator().manual_seed(1))
    rng = np.random.default_rng(SEED + 8)
    S = cfg.img_size
    x = torch.from_numpy(np.float32(rng.normal(size=(1, 3, S, S))))
    box = torch.tensor([[0.2, 0.15, 0.7, 0.9]]) * S
    with torch.no_grad(), NoTF32():
        want, want_iou = model.eval()(x, box)
        got, got_iou = copy.deepcopy(model).to(DEVICE)(x.to(DEVICE), box.to(DEVICE))
        got, got_iou = got.cpu(), got_iou.cpu()
    err = float((got - want).abs().max())
    limit = SEG_ATOL + SEG_RTOL * float(want.abs().max())
    share = float(((got > 0) != (want > 0)).float().mean())
    if not torch.isfinite(got).all() or err > limit or share > SEG_MASK_SHARE:
        raise AssertionError(f"SAM card vs CPU: max |dlogits| {err:.3e} (limit {limit:.3e}), "
                             f"mask pixels differing {share:.3e} (limit {SEG_MASK_SHARE})")
    log(f"SAM ViT-B forward at {S}² on the card vs the CPU (TF32 off): max |dlogits| "
        f"{err:.3e} (limit {limit:.3e}; logits up to {float(want.abs().max()):.3e}), mask pixels "
        f"differing {share:.3e} (positive share {float((want > 0).float().mean()):.4f}), IoU "
        f"{float(got_iou[0]):.6f} vs {float(want_iou[0]):.6f}")
    return dict(max_abs_err=err, limit=limit, mask_share_differing=share)


def sam_phase(root: str, label: str, p_seconds: float) -> dict:
    """Phase 8: ``--adaptive_mask_model_type ps_ae`` at full width (SAM ViT-B
    at 1024² refining the U-Net's person box in each of the 21 provoke
    rounds), then ``s_ab_ae`` on the same route; K3's counters from 0."""
    from coma_tpu_torch.cli import inpaint as cli
    from coma_tpu_torch.models import sam
    from coma_tpu_torch.ops import attention

    for mode in cli.SAM_MODES:      # each parses and passes the CLI's checks
        args = cli.build_parser().parse_args(["--random_weights", "--adaptive_mask_model_type",
                                              mode])
        cli.check_args(args)
    runs = {}
    for mode in ("ps_ae", "s_ab_ae"):
        fresh_outputs(root)
        reset_k3_counters()
        with ForwardTimer(sam.SAM) as timer:
            seconds, peak_gb, _ = inpaint(root, label, what=f"bf16, 50 steps, mode {mode}, SAM "
                                          "ViT-B at 1024²", mode=mode)
        ms = timer.ms()
        if len(ms) != PROVOKE_ROUNDS or attention.launches != K3_LAUNCHES_PER_BATCH:
            raise AssertionError(f"mode {mode}: SAM ran {len(ms)} times, K3 launched "
                                 f"{attention.launches} times (expected {PROVOKE_ROUNDS}, "
                                 f"{K3_LAUNCHES_PER_BATCH})")
        runs[mode] = dict(seconds=seconds, images_per_s=INPAINT_IMAGES / seconds,
                          peak_gb=peak_gb, sam_ms=float(np.mean(ms)), sam_calls=len(ms),
                          launches=attention.launches)
        log(f"mode {mode}: SAM {ms_summary(ms)} (CUDA events around its forward, batch "
            f"{INPAINT_IMAGES}); K3 launches {attention.launches}; against mode p's "
            f"{p_seconds:.3f} s [{label}]")
    runs["card_vs_cpu"] = sam_card_vs_cpu(label)
    return runs


def pointrend_stand_in(cfg, seed: int):
    """Seeded PointRend weights (Flax's initializers) with the box
    regressions zeroed and the classifier constant in favour of the person
    class: the proposals are the anchors (which overlap in long NMS chains),
    every detection is a person at one score (ties for top-K), and the point
    head's seeded logits cut masks out of the boxes. Seeded weights alone
    reach activations of ~1e3 at pixel scale and push every box off the
    frame, so no mask would reach the paste."""
    from coma_tpu_torch.models import pointrend as pr
    from coma_tpu_torch.models.layers import init_flax_default_

    model = init_flax_default_(pr.PointRendModel(cfg), torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for layer in (model.rpn_head.anchor_deltas, model.box.bbox_pred, model.box.cls_score):
            layer.weight.zero_()
            layer.bias.zero_()
        model.box.cls_score.bias[0] = 10.0
    return model.eval()


def pointrend_card_vs_cpu(label: str) -> dict:
    """Phase 9's detector (the stand-in at the loop's config) on one seeded
    512² image at the loop's 800 px scale, on the card and on the CPU."""
    import copy

    from coma_tpu_torch.models import pointrend as pr

    cfg = pr.PointRendConfig(max_detections=20)
    model = pointrend_stand_in(cfg, SEED + 10)
    image = torch.from_numpy(np.float32(np.random.default_rng(SEED + 9).uniform(
        size=(1, 3, INPAINT_RES, INPAINT_RES))))
    net, box_scale = pr.preprocess_batch(image, cfg)
    pr.reset_nms_stats()
    with torch.no_grad(), NoTF32():
        want = model(net)
        cpu_rounds = dict(pr.NMS_STATS)
        pr.reset_nms_stats()
        got = {k: v.cpu() for k, v in copy.deepcopy(model).to(DEVICE)(net.to(DEVICE)).items()}
        card_rounds = dict(pr.NMS_STATS)
    masks = [pr.merged_person_mask(d, (INPAINT_RES,) * 2, box_scale) for d in (want, got)]
    share = float((masks[0] != masks[1]).float().mean())
    box_err = float((got["boxes"] - want["boxes"]).abs().max())
    logit_err = float((got["mask_logits"] - want["mask_logits"]).abs().max())
    same = torch.equal(got["valid"], want["valid"]) and torch.equal(got["classes"],
                                                                    want["classes"])
    if not same or box_err > PR_BOX_ATOL or share > SEG_MASK_SHARE or not want["valid"].any():
        raise AssertionError(f"PointRend card vs CPU: same slots {same}, boxes {box_err:.3e} px "
                             f"(limit {PR_BOX_ATOL}), mask pixels differing {share:.3e}")
    log(f"PointRend R50-FPN at 800 px on the card vs the CPU (TF32 off): "
        f"{int(want['valid'].sum())} valid slots, the same slots and classes; boxes within "
        f"{box_err:.3e} px (limit {PR_BOX_ATOL}); mask logits within {logit_err:.3e}; merged "
        f"person mask {float(masks[0].float().mean()):.4f} of the frame, pixels differing "
        f"{share:.3e} (limit {SEG_MASK_SHARE}); NMS rounds card {card_rounds}, CPU {cpu_rounds}")
    return dict(box_err=box_err, mask_logit_err=logit_err, mask_share_differing=share,
                valid=int(want["valid"].sum()), nms_card=card_rounds)


def pointrend_phase(root: str, label: str, p_seconds: float) -> dict:
    """Phase 9: ``--person_segmenter pointrend`` in mode p with the stand-in
    weights through ``--pointrend_weights`` (a Flax-layout ``.npz``), then
    with ``--pointrend_fast``; the detector's time per provoke step, NMS
    rounds, the merged person masks' share of the frames, K3's launches;
    then the card against the CPU at one input."""
    from coma_tpu_torch.models import pointrend as pr
    from coma_tpu_torch.ops import attention

    runs = {}
    npz = f"{root}/pointrend_stand_in.npz"
    write_flax_npz(pointrend_stand_in(pr.PointRendConfig(max_detections=20), SEED + 10), npz)
    for name, extra in (("f32", ()), ("fast", ("--pointrend_fast",))):
        fresh_outputs(root)
        reset_k3_counters()
        pr.reset_nms_stats()
        masks, make = [], pr.make_pointrend_segment_fn

        def recording(*args, _make=make, **kwargs):
            fn = _make(*args, **kwargs)
            return lambda x: masks.append(fn(x)) or masks[-1]

        pr.make_pointrend_segment_fn = recording
        try:
            with ForwardTimer(pr.PointRendModel) as timer:
                seconds, peak_gb, _ = inpaint(root, label, (
                    "--random_weights", "--person_segmenter", "pointrend", "--pointrend_weights",
                    npz, *extra), f"bf16, 50 steps, mode p, PointRend {name}")
        finally:
            pr.make_pointrend_segment_fn = make
        ms = timer.ms()
        nms = dict(pr.NMS_STATS)
        share = float(torch.stack([m.float().mean() for m in masks]).mean())
        if len(ms) != PROVOKE_ROUNDS or attention.launches != K3_LAUNCHES_PER_BATCH \
                or not 0 < share < 1:
            raise AssertionError(f"PointRend {name}: the detector ran {len(ms)} times, K3 "
                                 f"launched {attention.launches} times, person share {share}")
        runs[name] = dict(seconds=seconds, peak_gb=peak_gb, detector_ms=float(np.mean(ms)),
                          nms=nms, person_share=share, launches=attention.launches)
        log(f"PointRend {name}: detector {ms_summary(ms)} (CUDA events, batch "
            f"{INPAINT_IMAGES} at 800 px); NMS {nms['calls']} calls, {nms['rounds']} rounds "
            f"({nms['rounds'] / max(nms['calls'], 1):.2f} a call, at most {nms['max_rounds']}); "
            f"merged person masks {share:.4f} of the frames; K3 launches {attention.launches}; "
            f"against mode p's U-Net {p_seconds:.3f} s [{label}]")
    runs["card_vs_cpu"] = pointrend_card_vs_cpu(label)
    runs["profile"] = profile_detector(label)
    return runs


def profile_detector(label: str, calls: int = 1) -> dict:
    """Where a provoke step's detector time goes: the in-loop segment
    function (stand-in weights, batch 4 at 800 px, float32) under
    ``torch.profiler`` after a warm-up; wall ms per call, the device's busy
    ms and idle share, device operations per call, the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from coma_tpu_torch.models import pointrend as pr

    model = pointrend_stand_in(pr.PointRendConfig(max_detections=20), SEED + 10).to(DEVICE)
    fn = pr.make_pointrend_segment_fn(model)
    images = torch.from_numpy(np.float32(np.random.default_rng(SEED + 11).uniform(
        size=(INPAINT_IMAGES, 3, INPAINT_RES, INPAINT_RES)))).to(DEVICE)
    fn(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / calls / 1e3
    ops = sum(e.count for e in events) / calls
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    if not busy_ms > 0:
        raise AssertionError("the profiler saw no device time of the detector")
    log(f"PointRend in-loop call under the profiler (batch {INPAINT_IMAGES}, 800 px, f32): "
        f"{wall_ms:.3f} ms wall per call, device busy {busy_ms:.3f} ms (idle "
        f"{1 - busy_ms / wall_ms:.3f}), {ops:.0f} device operations per call; largest: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / calls / 1e3:.3f} ms x"
                    f"{e.count // calls}" for e in top) + f" [{label}]")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                device_ops=ops)


def write_flax_npz(model: torch.nn.Module, path: str) -> None:
    """The module's weights as a ``/``-keyed Flax-layout params store (the
    format ``coma_tpu``'s ``save_params`` writes): Conv weights (O, I, kh, kw)
    as kernels (kh, kw, I, O), Linear weights (O, I) as kernels (I, O)."""
    arrays = {}
    for key, value in model.state_dict().items():
        *parents, leaf = key.split(".")
        arr = value.detach().cpu().numpy()
        if leaf == "weight" and arr.ndim in (2, 4):
            leaf, arr = "kernel", (arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0))
        arrays["/".join(["params", *parents, leaf])] = np.ascontiguousarray(arr)
    np.savez(path, **arrays)


PICKLE_LAYOUT = {"pred_masks": np.bool_, "pred_boxes": np.float32, "scores": np.float32,
                 "pred_classes": np.int64}


def check_instance_pickles(out_dir: str, n_images: int) -> int:
    pickles = sorted(Path(out_dir).rglob("*.pickle"))
    if len(pickles) != n_images:
        raise AssertionError(f"segment_human wrote {len(pickles)} pickles for {n_images} images")
    total = 0
    for p in pickles:
        with open(p, "rb") as fh:
            d = pickle.load(fh)
        if list(d) != [*PICKLE_LAYOUT, "image_size"] or d["image_size"] != (INPAINT_RES,) * 2:
            raise AssertionError(f"{p}: keys {list(d)}, image_size {d.get('image_size')}")
        n = len(d["scores"])
        for k, dt in PICKLE_LAYOUT.items():
            if d[k].dtype != dt or d[k].shape[0] != n:
                raise AssertionError(f"{p}: {k} {d[k].dtype} {d[k].shape}")
        if d["pred_masks"].shape[1:] != (INPAINT_RES,) * 2 or d["pred_boxes"].shape[1:] != (4,):
            raise AssertionError(f"{p}: masks {d['pred_masks'].shape}, boxes "
                                 f"{d['pred_boxes'].shape}")
        total += n
    return total


def segment_human_phase(inpaint_dir: str, label: str) -> dict:
    """Phase 10: ``cli/segment_human`` on phase 6's images, with the committed
    U-Net and with PointRend (``PointRendConfig()``) from phase 9's seeded
    stand-in written as a Flax-layout ``.npz``."""
    from coma_tpu_torch.cli import segment_human as cli
    from coma_tpu_torch.models import pointrend as pr

    n_images = len(list(Path(inpaint_dir).rglob("*.png")))
    runs = {}
    with tempfile.TemporaryDirectory(prefix="segment_", dir=SCRATCH) as tmp:
        write_flax_npz(pointrend_stand_in(pr.PointRendConfig(), SEED + 10),
                       f"{tmp}/pointrend.npz")
        for name, extra in (("unet", ()), ("pointrend", ("--segmenter", "pointrend",
                                                          "--segmenter_params",
                                                          f"{tmp}/pointrend.npz"))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli.main(["--inpaint_dir", inpaint_dir, "--save_dir", f"{tmp}/{name}", "--device",
                      DEVICE, *extra])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            instances = check_instance_pickles(f"{tmp}/{name}", n_images)
            runs[name] = dict(seconds=seconds, images_per_s=n_images / seconds,
                              instances=instances)
            log(f"segment_human --segmenter {name}: {n_images} images at {INPAINT_RES}² in "
                f"{seconds:.3f} s = {n_images / seconds:.4f} images/s (the CLI's wall clock: "
                f"weights, PNGs, pickles), {instances} instances kept; the pickles' keys, dtypes "
                f"and shapes are coma_tpu's [{label}]")
    return runs


# ---------------------------------------------------------------------------
# Phase 11: the step video's GIF, decoded with numpy
# ---------------------------------------------------------------------------

def decode_gif(data: bytes):
    """GIF bytes -> (frames (S, H, W, 3) uint8 as PIL shows them, delays in
    1/100 s, loop count), through the port's reader (``utils/gif_reader.py``)."""
    from coma_tpu_torch.utils.gif_reader import decode_gif_frames

    frames, durations, loop = decode_gif_frames(data, "step video")
    return frames, [d // 10 for d in durations], loop


def step_video_phase(root: str, label: str, p_seconds: float) -> dict:
    """Phase 11: phase 6's batch with ``--save_step_video``: the GIF decoded
    here against the frames the CLI composed, and what the video costs."""
    from coma_tpu_torch.ops import attention
    from coma_tpu_torch.utils.gif import pil_frames
    from coma_tpu_torch.visualization import video

    composed, write_seconds = [], []
    compose, write = video.compose_step_frames, video.write_adaptive_mask_video

    def recorded(*args, **kwargs):
        composed.append(compose(*args, **kwargs))
        return composed[-1]

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = write(*args, **kwargs)
        write_seconds.append(time.perf_counter() - t0)
        return out

    fresh_outputs(root)
    reset_k3_counters()
    video.compose_step_frames, video.write_adaptive_mask_video = recorded, timed
    try:
        seconds, _, _ = inpaint(root, label, ("--random_weights", "--save_step_video"),
                                "bf16, 50 steps, mode p, --save_step_video")
    finally:
        video.compose_step_frames, video.write_adaptive_mask_video = compose, write
    gifs = sorted(Path(root, "results", "generation", "inpaintings").rglob("*.steps.gif"))
    if len(gifs) != 1 or len(composed) != 1:
        raise AssertionError(f"{len(gifs)} step videos, {len(composed)} composed")
    data = gifs[0].read_bytes()
    t0 = time.perf_counter()
    frames, delays, loop = decode_gif(data)
    decode_s = time.perf_counter() - t0
    want_shape = (-(-50 // 3), INPAINT_RES, 2 * INPAINT_RES, 3)
    kept = pil_frames(composed[0])
    quantised = np.stack([palette[indices] for palette, indices, _ in kept])
    if composed[0].shape != want_shape or frames.shape != quantised.shape or loop != 0 \
            or not np.array_equal(frames, quantised):
        raise AssertionError(f"step video: frames {frames.shape} (composed {composed[0].shape}, "
                             f"want {want_shape}), loop {loop}, equal to PIL's per-frame "
                             f"quantisation {np.array_equal(frames, quantised)}")
    # one more attention than phase 6: the video's single VAE decode of the 17 x̂0
    if attention.launches != K3_LAUNCHES_PER_BATCH + 1:
        raise AssertionError(f"step video run: K3 launched {attention.launches} times")
    quant_err = float(np.abs(frames.astype(np.int16) - composed[0]).mean()) \
        if frames.shape == composed[0].shape else float("nan")
    log(f"--save_step_video: {gifs[0].name}, {len(data)} bytes, {frames.shape[0]} frames of "
        f"{frames.shape[2]}x{frames.shape[1]}, delay {delays[0]} cs, loop {loop}; decoded here "
        f"({decode_s:.3f} s) equal to PIL's per-frame median cut of the composed frames (mean |d| "
        f"to them "
        f"{quant_err:.3f} of 255); compose + encode + write {write_seconds[0]:.3f} s; the run "
        f"{seconds:.3f} s against phase 6's {p_seconds:.3f} s; K3 launches {attention.launches} "
        f"(phase 6's + 1: the video's VAE decode) [{label}]")
    return dict(seconds=seconds, write_seconds=write_seconds[0], frames=int(frames.shape[0]),
                bytes=len(data), launches=attention.launches, phase6_seconds=p_seconds)


# ---------------------------------------------------------------------------
# Phase 7: the HOI-reconstruction application through cli/optimize
# ---------------------------------------------------------------------------

OPT_CPU_STEPS = 10
# card vs CPU after 10 steps at the CLI's weights (1e12, 2.6e11): Adam's first
# steps move each parameter by ≈ lr·sign(g), so a gradient's sign decides; the
# sums (index_add, the gather's backward) run in another order on the card
OPT_LOSS_RTOL, OPT_VERTS_ATOL = 1e-3, 1e-3
OPT_TIMED_STEPS = (20, 120)
OPT_CLI_STEPS = 100   # of the CLI's 2000: the ms per step is timed apart (OPT_TIMED_STEPS)
OPT_COLLISION_STEPS = 50
OPT_PROFILED_STEPS = 10   # 50 until PR 25: the profiler took ~66 s of the host to read 50


def write_vposer_snapshot(path: str, seed: int) -> None:
    """A seeded VPoser snapshot by the reference's keys (512 wide, latent 32):
    Flax's initialisers, the biases then drawn N(0, 0.05²) and the output
    bias centred on the identity's 6D code (1, 0, 0, 1, 0, 0), so that the
    zero latent decodes, as a trained VPoser's does, to a pose near rest
    (not to the identity exactly, where the decoder's gradient vanishes)."""
    from coma_tpu_torch.models.layers import init_flax_default_
    from coma_tpu_torch.models.vposer import VPoserDecoder, VPoserEncoder

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for module in (VPoserEncoder(), VPoserDecoder()):
        init_flax_default_(module, g)
        with torch.no_grad():
            for name, p in module.named_parameters():
                if name.endswith("bias"):
                    p.normal_(0.0, 0.05, generator=g)
            if isinstance(module, VPoserDecoder):
                module.dec_out.bias += torch.tensor([1.0, 0, 0, 1.0, 0, 0]).repeat(21)
        sd.update({f"bodyprior_{k}": v for k, v in module.state_dict().items()})
    torch.save(sd, path)


def optimize_inputs(learn_root: str, keep: str) -> dict:
    """Move phase 4b's SMPL-X npz, its ``qual:backpack_human_contact`` pickle
    and its 180-point object downsample into ``keep``."""
    from coma_tpu_torch.core.paths import ResultsTree

    tree = ResultsTree(f"{learn_root}/results")
    files = dict(npz=f"{learn_root}/smplx.npz",
                 coma=tree.coma_pickle(SC, CAT, ASSET, "qual:backpack_human_contact", PROMPT),
                 obj=tree.asset_downsample(SC, CAT, ASSET, "180"))
    out = {}
    for k, path in files.items():
        out[k] = os.path.join(keep, os.path.basename(path))
        os.replace(path, out[k])
    out["vposer"] = os.path.join(keep, "vposer.pt")
    write_vposer_snapshot(out["vposer"], SEED + 6)
    return out


def run_optimize_cli(files: dict, out_dir: str, label: str, extra=()) -> dict:
    """``cli/optimize`` once, every kernel's counter from 0 (the application
    runs none); the losses finite and the total falling from step 0."""
    from coma_tpu_torch.cli import optimize
    from coma_tpu_torch.ops import attention, contact_kernel, occupancy_kernel

    contact_kernel.launches = occupancy_kernel.launches = attention.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = optimize.main(["--coma_pth", files["coma"], "--obj_downsample_pth", files["obj"],
                            "--smplx_model_path", files["npz"], "--vposer_snapshot",
                            files["vposer"], "--save_pth", f"{out_dir}/optimized.obj",
                            "--losses_json", f"{out_dir}/losses.json", "--device", DEVICE, *extra])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"contact_splat": contact_kernel.launches,
                "occupancy_hits": occupancy_kernel.launches,
                "flash_attention": attention.launches}
    hist = result.loss_history
    if not (np.isfinite(hist).all() and all(np.isfinite(v) for v in result.losses.values())
            and np.isfinite(result.vertices).all() and hist[-1] < hist[0]) \
            or any(launches.values()):
        raise AssertionError(f"optimize {list(extra)}: losses {result.losses}, total "
                             f"{hist[0]} -> {hist[-1]}, launches {launches}")
    log(f"optimize {' '.join(extra)} (the CLI's defaults otherwise): {seconds:.3f} s "
        f"(CLI wall clock: pickle, npz, snapshot, the fit, OBJ), {len(hist)} steps, total loss "
        f"{hist[0]:.6e} at step 0 -> {hist[-1]:.6e}; final {result.losses}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches {launches} [{label}]")
    return dict(seconds=seconds, steps=len(hist), loss_first=float(hist[0]),
                loss_last=float(hist[-1]), losses=result.losses, launches=launches,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def optimize_problem(files: dict, device):
    """The fit's arguments at the CLI defaults on ``device``."""
    from coma_tpu_torch.affordance.io import load_pickle
    from coma_tpu_torch.cli.optimize import load_decoder
    from coma_tpu_torch.models.smplx import SMPLXModel

    obj = load_pickle(files["obj"])
    return dict(smplx_model=SMPLXModel.from_npz(files["npz"], device=device),
                vposer_decoder=load_decoder(files["vposer"], device),
                obj_verts=np.asarray(obj["downsampled_pcd_points_raw"], np.float32),
                obj_normals=np.asarray(obj["downsampled_pcd_normal_raw"], np.float32))


def optimize_phase(files: dict, label: str) -> dict:
    """Phase 7: the CLI at its defaults but ``OPT_CLI_STEPS`` steps, then
    with ``--use_collision`` at ``OPT_COLLISION_STEPS``; ms per step (CUDA
    events, the difference of two fits); the card against the CPU over 10
    steps; the device's idle share over ``OPT_PROFILED_STEPS`` steps."""
    from torch.profiler import ProfilerActivity, profile

    from coma_tpu_torch.affordance.io import load_pickle
    from coma_tpu_torch.pipelines.application import derive_targets_from_coma, optimize_smpl

    with tempfile.TemporaryDirectory(prefix="opt_", dir=SCRATCH) as out:
        runs = dict(defaults=run_optimize_cli(files, out, label,
                                              ("--num_iters", str(OPT_CLI_STEPS))),
                    collision=run_optimize_cli(files, out, label,
                                               ("--use_collision", "--num_iters",
                                                str(OPT_COLLISION_STEPS))))
    coma = load_pickle(files["coma"])
    sel = len(derive_targets_from_coma(coma, 0, 0.3)[1])
    card = optimize_problem(files, DEVICE)

    def fit(n, problem=card):
        return optimize_smpl(coma_dict=coma, num_iters=n, **problem)

    fit(2)   # warm-up
    ms = []
    for n in OPT_TIMED_STEPS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fit(n)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    ms_per_step = (ms[1] - ms[0]) / (OPT_TIMED_STEPS[1] - OPT_TIMED_STEPS[0])

    got = fit(OPT_CPU_STEPS)
    want = fit(OPT_CPU_STEPS, optimize_problem(files, "cpu"))
    loss_err = float(np.max(np.abs(got.loss_history - want.loss_history)
                            / np.abs(want.loss_history)))
    verts_err = float(np.abs(got.vertices - want.vertices).max())
    if not (loss_err <= OPT_LOSS_RTOL and verts_err <= OPT_VERTS_ATOL):
        raise AssertionError(f"optimize, card vs CPU over {OPT_CPU_STEPS} steps: total loss "
                             f"rel {loss_err:.3e} (limit {OPT_LOSS_RTOL:.0e}), vertices abs "
                             f"{verts_err:.3e} (limit {OPT_VERTS_ATOL:.0e})")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit(OPT_PROFILED_STEPS)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches_per_step = sum(e.count for e in events) / OPT_PROFILED_STEPS
    if not busy_ms > 0:
        raise AssertionError("the profiler saw no device time in the fit")
    idle = 1.0 - busy_ms / window_ms
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    log("optimize fit, device time by kernel over "
        f"{OPT_PROFILED_STEPS} steps: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms ({e.count})" for e in top))
    split = step_split(files, coma)
    log(f"optimize fit (H={card['smplx_model'].num_verts}, |sel|={sel} contact pairs): "
        f"{ms_per_step:.3f} ms per step (CUDA events, {OPT_TIMED_STEPS[1]} - "
        f"{OPT_TIMED_STEPS[0]} steps); card vs CPU over {OPT_CPU_STEPS} steps: total loss max "
        f"rel {loss_err:.3e} (limit {OPT_LOSS_RTOL:.0e}), vertices max abs {verts_err:.3e} m "
        f"(limit {OPT_VERTS_ATOL:.0e}); {OPT_PROFILED_STEPS} steps under the profiler: "
        f"{window_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle {idle:.4f}, "
        f"{launches_per_step:.0f} device operations per step; host ms per step, each part "
        f"ending in a synchronise: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f" [{label}]")
    return dict(runs=runs, contact_pairs=sel, ms_per_step=ms_per_step,
                card_vs_cpu_loss_rel=loss_err, card_vs_cpu_verts_abs=verts_err,
                profiled_ms=window_ms, busy_ms=busy_ms, idle_share=idle,
                device_ops_per_step=launches_per_step, step_split_ms=split)


def step_split(files: dict, coma, steps: int = 50) -> dict:
    """Host ms per step of the fit's parts (the losses, their gradient,
    Adam), each ended by a synchronise: the loop is bound by the host's
    launches, so the split shows where the host spends a step."""
    from coma_tpu_torch.pipelines.application import OptaxAdam, build_problem

    problem = build_problem(coma_dict=coma, **optimize_problem(files, DEVICE))
    params, names = problem.params, list(problem.params)
    opt = OptaxAdam(params, 1e-2)
    parts = dict(losses=0.0, gradient=0.0, adam=0.0)
    for step in range(steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total, _ = problem.losses_fn(params)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(total, [params[k] for k in names])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step(params, dict(zip(names, grads)))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if step >= 2:   # two warm-up steps
            for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[k] += dt * 1e3 / steps
    return parts


# ---------------------------------------------------------------------------
# Phase 12: stage 2 (3D lifting): predict_human, then the lifting chain
# ---------------------------------------------------------------------------

H4W_RTOL = H4W_ATOL = 1e-3      # Hand4Whole, card vs CPU in float32 (TF32 off)
LIFT_SC, LIFT_CAT = "Chair", "Lounge Chair / Cafe Chair / Office Chair"
LIFT_ASSET = "0a5a346c-cc3b-4280-b358-ccd1c4d8a865"
LIFT_PROMPT = "1 person sits on a chair"
LIFT_RES, LIFT_VIEWS, LIFT_ELEVATION = 512, 8, 15.0   # render_objects' defaults
LIFT_ORTHO_SCALE, LIFT_Z_SCALE = 1.75, 0.5             # the Chair category's camera config
LIFT_EPOCHS = 200                                      # optimize_depth's default
LIFT_TIMED_STEPS = (10, 60)
LIFT_PROFILED_STEPS = 20
RETRIEVAL_RANGE, INTERVAL_RATIO = 3, 0.3               # initialize_depth's defaults
MARKER_OFFSET = 0.08   # m: the asset vertex nearest every view's pelvis ray, off the pelvis
RING = dict(r_in=0.46, r_out=0.52, z0=0.25, z1=0.6, around=128, rows=8)


def camera_ring(asset_world: np.ndarray) -> list:
    """``render_objects``' camera pickles: ``LIFT_VIEWS`` orthographic views
    on a 10 m ring at ``LIFT_ELEVATION``°, azimuth 2πi/n, ortho scale = the
    asset's largest extent x ortho_scale x 2, no perturbation (R and t in
    float64, as a pickle of the reference holds them)."""
    from coma_tpu_torch.pipelines.rendering import euler_xyz_to_matrix

    lengths = asset_world.max(0) - asset_world.min(0)
    scale = float(lengths.max()) * LIFT_ORTHO_SCALE * 2
    elev = np.deg2rad(LIFT_ELEVATION)
    cams = []
    for i in range(LIFT_VIEWS):
        a = 2 * np.pi * i / LIFT_VIEWS
        t = np.array([10 * np.cos(elev) * np.cos(a), 10 * np.cos(elev) * np.sin(a),
                      10 * np.sin(elev) + lengths[2] * LIFT_Z_SCALE])
        cams.append(dict(R=euler_xyz_to_matrix(np.pi / 2 - elev, 0.0, np.pi / 2 + a), t=t,
                         scale=scale, resolution=(LIFT_RES, LIFT_RES), obj_R=np.eye(3),
                         obj_t=np.zeros((3, 1)), obj_rotation=np.eye(3),
                         obj_location=np.zeros((3, 1))))
    return cams


def ring_asset(pelvis: np.ndarray, rng):
    """A closed ring (a low wall around the body's legs; RING gives its radii,
    heights and resolution: 4096 faces) and a 1 cm tetrahedron whose first
    vertex lies MARKER_OFFSET from the pelvis, inside the body. World
    coordinates (z up), the ring centred on the pelvis' vertical axis."""
    n, rows = RING["around"], RING["rows"]
    theta = 2 * np.pi * np.arange(n) / n
    z = np.linspace(RING["z0"], RING["z1"], rows)
    walls = [np.stack([r * np.cos(theta)[None].repeat(rows, 0), r * np.sin(theta)[None].repeat(
        rows, 0), z[:, None].repeat(n, 1)], -1).reshape(-1, 3) for r in (RING["r_out"],
                                                                        RING["r_in"])]
    verts = np.concatenate(walls) + [pelvis[0], pelvis[1], 0.0]
    o = lambda i, k: i * n + k % n
    q = lambda i, k: rows * n + i * n + k % n
    faces = []
    for k in range(n):
        for i in range(rows - 1):
            faces += [(o(i, k), o(i, k + 1), o(i + 1, k + 1)), (o(i, k), o(i + 1, k + 1),
                                                                 o(i + 1, k)),
                      (q(i, k), q(i + 1, k + 1), q(i, k + 1)), (q(i, k), q(i + 1, k),
                                                                 q(i + 1, k + 1))]
        for i in (0, rows - 1):
            faces += [(o(i, k), q(i, k + 1), o(i, k + 1)), (o(i, k), q(i, k), q(i, k + 1))]
    phi = rng.uniform(0, 2 * np.pi)
    m0 = pelvis + MARKER_OFFSET * np.array([np.cos(phi), np.sin(phi), 0.0])
    marker = m0 + np.array([[0, 0, 0], [0.01, 0, 0], [0, 0.01, 0], [0, 0, 0.01]])
    b = len(verts)
    faces += [(b, b + 2, b + 1), (b, b + 1, b + 3), (b, b + 3, b + 2), (b + 1, b + 2, b + 3)]
    return np.concatenate([verts, marker]), np.asarray(faces, np.int64)


def seeded_body(npz: str, rng):
    """Phase 4b's SMPL-X-shaped body posed with seeded parameters, standing
    on the ground with its pelvis on the world's z axis: (smplx_data with
    its world ``transl``, world vertices (V, 3), world joints and landmarks
    (76, 3), faces)."""
    from coma_tpu_torch.models.keypoints import append_vertex_landmarks
    from coma_tpu_torch.models.smplx import SMPLXModel, smplx_forward

    model = SMPLXModel.from_npz(npz, device=DEVICE)
    data = dict(betas=rng.normal(size=(1, 10)) * 0.5, expression=rng.normal(size=(1, 10)) * 0.5,
                global_orient=np.array([[0.0, 0.0, rng.uniform(-np.pi, np.pi)]]),
                body_pose=rng.normal(size=(1, 63)) * 0.1,
                left_hand_pose=rng.normal(size=(1, 45)) * 0.1,
                right_hand_pose=rng.normal(size=(1, 45)) * 0.1, jaw_pose=np.zeros((1, 3)),
                leye_pose=np.zeros((1, 3)), reye_pose=np.zeros((1, 3)))
    data = {k: np.float32(v) for k, v in data.items()}
    with torch.no_grad():
        verts, joints = smplx_forward(model, **{k: torch.as_tensor(v, device=DEVICE)
                                                for k, v in data.items()})
        joints = append_vertex_landmarks(verts, joints)
    verts, joints = verts[0].cpu().numpy(), joints[0].cpu().numpy()
    shift = np.array([-joints[0, 0], -joints[0, 1], -verts[:, 2].min()])
    data["transl"] = np.float32(shift[None])
    return data, np.float32(verts + shift), np.float32(joints + shift), model.faces_array


def write_lift_tree(root: str, npz: str, rng) -> dict:
    """The stage-2 inputs under ``root``: the asset OBJ (trimesh axes), the
    camera pickles, and per view the exact projection of the body and its
    joints (``human_preds``, a perfect regressor's output) and its occluded
    silhouette (``human_segs``); the seeded COAP weights as a Flax ``.npz``."""
    from coma_tpu_torch.core.paths import flatten
    from coma_tpu_torch.geometry.mesh import save_obj
    from coma_tpu_torch.lifting.cameras import (
        COMPATIBILITY_MATRIX_TRIMESH_P3D_TO_BLENDER,
        OrthoCamera,
        project_points,
    )
    from coma_tpu_torch.lifting.rasterizer import render_silhouette
    from coma_tpu_torch.pipelines.asset_world import asset_to_world

    smplx_data, body, joints, faces = seeded_body(npz, rng)
    asset_v, asset_f = ring_asset(joints[0], rng)
    # the OBJ in trimesh axes (y up): world = obj @ M
    save_obj(f"{root}/asset.obj", asset_v @ COMPATIBILITY_MATRIX_TRIMESH_P3D_TO_BLENDER.T,
             asset_f)
    cams = camera_ring(asset_v)
    rel = f"{flatten(LIFT_SC)}/{flatten(LIFT_CAT)}/{LIFT_ASSET}"
    gen = f"{root}/results/generation"
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=DEVICE)
    views = []
    for i, cam in enumerate(cams):
        view = f"view:{i:05d}"
        os.makedirs(f"{gen}/cameras/{rel}", exist_ok=True)
        with open(f"{gen}/cameras/{rel}/{view}.pickle", "wb") as fh:
            pickle.dump(cam, fh)
        world_asset, _ = asset_to_world(asset_v @ COMPATIBILITY_MATRIX_TRIMESH_P3D_TO_BLENDER.T,
                                        cam, "3D-FUTURE")
        camera = OrthoCamera.from_pickle(cam, DEVICE)
        with torch.no_grad():
            verts_px = project_points(camera, t(body)).cpu().numpy()
            joints_px = project_points(camera, t(joints)).cpu().numpy()
            mask = render_silhouette(camera, t(body), torch.as_tensor(faces, device=DEVICE),
                                     occluder_verts=t(world_asset),
                                     occluder_faces=torch.as_tensor(asset_f, device=DEVICE))
        mask = mask.cpu().numpy()
        ys, xs = np.nonzero(mask)
        pred = dict(verts=verts_px, faces=faces, pelvis=joints_px[0].copy(),
                    smplx_data=smplx_data, joints_proj=joints_px[:, :2].copy(),
                    joints_img=joints_px.copy(),
                    convert_data=dict(focals=[5000.0, 5000.0], princpt=[LIFT_RES / 2] * 2,
                                      z_mean=float(verts_px[:, 2].mean())))
        seg = dict(pred_masks=mask[None], pred_boxes=np.float32([[xs.min(), ys.min(),
                                                                  xs.max() + 1, ys.max() + 1]]),
                   scores=np.float32([0.99]), pred_classes=np.zeros(1, np.int64),
                   image_size=mask.shape)
        for kind, payload in (("human_preds", pred), ("human_segs", seg)):
            d = f"{gen}/{kind}/{rel}/{view}/00000/{LIFT_PROMPT}"
            os.makedirs(d, exist_ok=True)
            with open(f"{d}/00000.pickle", "wb") as fh:
                pickle.dump(payload, fh)
        views.append(dict(view=view, cam=cam, world_asset=world_asset, mask_px=int(mask.sum())))
    coap = write_coap_npz(f"{root}/coap.npz", npz, SEED + 12)
    return dict(body=body, joints=joints, faces=faces, asset_faces=asset_f, views=views,
                obj=f"{root}/asset.obj", coap=coap, rel=rel)


def write_coap_npz(path: str, npz: str, seed: int) -> dict:
    """A seeded COAP at the published widths for phase 4b's partition, as a
    Flax-layout ``.npz``: Flax's initialisers, the decoder's output bias at
    +2 (occupancy σ(−2) ≈ 0.12 away from the learned surface), so the term is
    live where the network says so and the multiview evidence still leads."""
    from coma_tpu_torch.models.coap import COAPConfig, COAPOccupancy
    from coma_tpu_torch.models.coap_partition import build_partition
    from coma_tpu_torch.models.layers import init_flax_default_
    from coma_tpu_torch.models.smplx import SMPLXModel

    smplx = SMPLXModel.from_npz(npz, device="cpu")
    part = build_partition(smplx.lbs_weights.numpy(), smplx.parents)
    model = COAPOccupancy(COAPConfig(num_parts=part.num_parts))
    init_flax_default_(model, torch.Generator().manual_seed(seed))
    last = getattr(model.decoder, f"lin{model.decoder.n_layers - 1}")
    with torch.no_grad():
        last.bias.fill_(2.0)
    write_flax_npz(model, path)
    return dict(path=path, parts=part.num_parts, max_part_size=part.max_part_size)


def expected_candidates(tree: dict) -> list:
    """Per view, initialize_depth's candidate displacements recomputed on the
    host in float64 from the same lifted pelvis and asset, and the index of
    the one nearest the true depth (displacement 0: the predictions are the
    body's exact projections)."""
    out = []
    for v in tree["views"]:
        R = np.asarray(v["cam"]["R"])
        d = R[:, 2] / np.linalg.norm(R[:, 2])
        p = tree["joints"][0].astype(np.float64)
        disp = p[None] - v["world_asset"]
        perp = disp - (disp @ d)[:, None] * d[None]
        sel = v["world_asset"][np.argmin(np.linalg.norm(perp, axis=1))]
        dist = (sel - p) @ d
        proj = tree["body"] @ d
        cand = dist + np.arange(-RETRIEVAL_RANGE, RETRIEVAL_RANGE + 1) * (
            proj.max() - proj.min()) * INTERVAL_RATIO
        out.append(dict(candidates=cand, nearest=int(np.argmin(np.abs(cand)))))
    return out


def predict_phase(images_dir: str, npz: str, label: str) -> dict:
    """Phase 12a: ``cli/predict_human`` at Hand4Whole's published widths on
    phase 6's images, each with a one-person instance pickle whose box is
    the inpainting mask's; then one patch regressed on the card against the
    CPU (TF32 off), and the network's ms per image."""
    from coma_tpu_torch.cli import predict_human
    from coma_tpu_torch.models.hand4whole import Hand4Whole
    from coma_tpu_torch.models.layers import init_flax_default_
    from coma_tpu_torch.pipelines.mocap import crop_patch, process_bbox
    from coma_tpu_torch.utils.png import read_png, to_rgb

    pngs = sorted(Path(images_dir).rglob("*.png"))
    res = INPAINT_RES
    box = np.float32([[res // 4, res // 8, 3 * res // 4, 7 * res // 8]])   # the mask, xyxy
    mask = np.zeros((1, res, res), bool)
    mask[0, res // 8: 7 * res // 8, res // 4: 3 * res // 4] = True
    with tempfile.TemporaryDirectory(prefix="predict_", dir=SCRATCH) as tmp:
        for p in pngs:
            out = Path(tmp, "segs", p.relative_to(images_dir)).with_suffix(".pickle")
            out.parent.mkdir(parents=True, exist_ok=True)
            with open(out, "wb") as fh:
                pickle.dump(dict(pred_masks=mask, pred_boxes=box, scores=np.float32([0.99]),
                                 pred_classes=np.zeros(1, np.int64), image_size=(res, res)), fh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        counts = predict_human.main(["--inpaint_dir", images_dir, "--human_seg_dir",
                                     f"{tmp}/segs", "--save_dir", f"{tmp}/preds",
                                     "--smplx_model_path", npz, "--device", DEVICE])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        preds = [pickle.load(open(p, "rb")) for p in sorted(Path(tmp, "preds").rglob("*.pickle"))]
    # predictions are grouped by the main prompt: an image under "<prompt>, full body"
    # and one of the same name under "<prompt>" share a pickle, as in coma_tpu
    outputs = {p.relative_to(images_dir).parent.parent / p.parent.name.split(",")[0] / p.stem
               for p in pngs}
    if counts["regressed"] != len(pngs) or len(preds) != len(outputs) or any(
            isinstance(p, str) or p["verts"].shape != (H_FULL, 3)
            or not np.isfinite(p["verts"]).all() or p["joints_img"].shape != (76, 3)
            or not np.isfinite(p["joints_img"]).all() for p in preds):
        raise AssertionError(f"predict_human: {counts}, {len(preds)} pickles for {len(pngs)} "
                             f"images ({len(outputs)} distinct outputs)")

    model = init_flax_default_(Hand4Whole(), torch.Generator().manual_seed(0)).eval()
    image = to_rgb(read_png(str(pngs[0])))
    bbox = process_bbox(np.float32([box[0, 0], box[0, 1], box[0, 2] - box[0, 0],
                                    box[0, 3] - box[0, 1]]), res, res)
    patch = crop_patch(image, bbox, "cpu")
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = model(patch)
            model = model.to(DEVICE)
            card_patch = patch.to(DEVICE)
            got = model(card_patch)
            err = {k: float((got[k].cpu() - w).abs().max()) for k, w in want.items()}
            ok = all(torch.allclose(got[k].cpu(), w, rtol=H4W_RTOL, atol=H4W_ATOL)
                     for k, w in want.items())
            fp32_ms = cuda_ms(lambda: model(card_patch), 10)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm
    with torch.no_grad():
        tf32_ms = cuda_ms(lambda: model(card_patch), 10)
    if not ok:
        raise AssertionError(f"Hand4Whole card vs CPU (limit {H4W_ATOL:.0e} + {H4W_RTOL:.0e}"
                             f"|x|): max abs diff {err}")
    params = sum(p.numel() for p in model.parameters())
    log(f"predict_human: {len(pngs)} images at {res}² in {seconds:.3f} s = "
        f"{len(pngs) / seconds:.4f} images/s (CLI wall clock: weights, SMPL-X npz, PNGs, one "
        f"patch at a time, SMPL-X forward, pickles), peak device memory {peak:.3f} GB; "
        f"Hand4Whole at the published widths ({params / 1e6:.1f} M parameters) {fp32_ms:.3f} "
        f"ms per 512x384 patch in float32, {tf32_ms:.3f} ms with cuDNN's TF32 (CUDA events); "
        f"card vs CPU, TF32 off: max abs diff {max(err.values()):.3e} (limit {H4W_ATOL:.0e} + "
        f"{H4W_RTOL:.0e}|x|) [{label}]")
    return dict(seconds=seconds, images_per_s=len(pngs) / seconds, peak_gb=peak,
                patch_ms_fp32=fp32_ms, patch_ms_tf32=tf32_ms, card_vs_cpu_max_abs=err,
                params=params)


def lift_phase(npz: str, label: str) -> dict:
    """Phase 12b: ``cli/generate_3d_hoi_samples --skip segment predict`` on the
    tree ``write_lift_tree`` writes, with the neural COAP backend; the checks
    and the stage costs (depth init and its rasterizer, RANSAC, the
    optimizer's step and idle share, compute_metrics), then the port's
    ``cli/filter`` on the result."""
    from torch.profiler import ProfilerActivity, profile

    from coma_tpu_torch.cli import filter as filter_cli
    from coma_tpu_torch.cli import generate_3d_hoi_samples as orchestrator
    from coma_tpu_torch.lifting import depth_init, depth_optimize, metrics, triangulation

    raster_events, ransac_ms, captured = [], [], {}
    render, mine, optimize = (depth_init.render_silhouettes_batch,
                              triangulation.mine_ransac_inliers,
                              depth_optimize.optimize_depth_batch)

    def timed_render(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = render(*args, **kwargs)
        end.record()
        raster_events.append((start, end))
        return out

    def timed_mine(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mine(*args, **kwargs)
        torch.cuda.synchronize()
        ransac_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def captured_optimize(**kwargs):
        captured.update(kwargs)
        return optimize(**kwargs)

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="lift_", dir=SCRATCH) as tmp:
        tree = write_lift_tree(tmp, npz, np.random.default_rng(SEED + 11))
        expected = expected_candidates(tree)
        depth_init.render_silhouettes_batch = timed_render
        triangulation.mine_ransac_inliers = timed_mine
        depth_optimize.optimize_depth_batch = captured_optimize
        os.chdir(tmp)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = orchestrator.main([
                "--skip", "segment", "predict", "--device", DEVICE, "--asset_obj_pth",
                tree["obj"], "--smplx_model_path", npz, "--coap_ckpt", tree["coap"]["path"],
                "--collision_backend", "coap", "--num_epoch", str(LIFT_EPOCHS)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            stats = filter_cli.main([])
        finally:
            os.chdir(cwd)
            depth_init.render_silhouettes_batch = render
            triangulation.mine_ransac_inliers = mine
            depth_optimize.optimize_depth_batch = optimize
        stages = {s: {Path(p).parts[-4]: pickle.load(open(p, "rb")) for p in sorted(
            Path(tmp, "results", "generation", s).rglob("*.pickle"))}
            for s in ("human_before_opt", "human_after_opt", "human_sample")}
        result = out["optimize"]["result"]

        # the checks
        views = [v["view"] for v in tree["views"]]
        before, after, samples = (stages[s] for s in ("human_before_opt", "human_after_opt",
                                                      "human_sample"))
        for name, s in (("before", before), ("after", after), ("sample", samples)):
            if sorted(s) != views or any(isinstance(x, str) for x in s.values()):
                raise AssertionError(f"stage 2 {name}: {[(k, type(x).__name__)
                                                         for k, x in s.items()]}")
        picked = [before[v]["idx"] for v in views]
        nearest = [e["nearest"] for e in expected]
        if picked != nearest:
            raise AssertionError(f"depth init picked candidates {picked}, the ones nearest the "
                                 f"true depth are {nearest}")
        err = lambda v, s: float(np.linalg.norm(s[v]["verts"] - tree["body"], axis=1).mean())
        err_before = np.array([err(v, before) for v in views])
        err_after = np.array([err(v, after) for v in views])
        hist = result.history.cpu().numpy()
        if not (np.isfinite(hist).all() and hist[-1].sum() < hist[0].sum()
                and err_after.mean() < err_before.mean()):
            raise AssertionError(f"depth optimisation: loss {hist[0].sum()} -> {hist[-1].sum()}"
                                 f", mean vertex error {err_before.mean()} -> "
                                 f"{err_after.mean()} m")
        ious = [samples[v]["IoU"] for v in views]
        ratios = [samples[v]["interscetion_ratio"] for v in views]
        if not (min(ious) >= 0.9 and all(np.isfinite(ratios))) \
                or stats["leftover"] != len(views):
            raise AssertionError(f"compute_metrics: IoU {ious}, interscetion_ratio {ratios}; "
                                 f"filter {stats}")

        # the costs
        torch.cuda.synchronize()
        raster_ms = sum(s.elapsed_time(e) for s, e in raster_events)
        n = len(views)
        init_ms = out["seconds"]["init"] * 1e3
        kwargs = dict(captured)
        ms = []
        for steps in LIFT_TIMED_STEPS:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            optimize(**dict(kwargs, num_epochs=steps))
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        step_ms = (ms[1] - ms[0]) / (LIFT_TIMED_STEPS[1] - LIFT_TIMED_STEPS[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            optimize(**dict(kwargs, num_epochs=LIFT_PROFILED_STEPS))
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        if not busy_ms > 0:
            raise AssertionError("the profiler saw no device time in the depth optimisation")
        ops_per_step = sum(e.count for e in events) / LIFT_PROFILED_STEPS
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
        hv = torch.as_tensor(np.float32(after[views[0]]["verts"]), device=DEVICE)
        hf = torch.as_tensor(np.int64(tree["faces"]), device=DEVICE)
        av = torch.as_tensor(np.float32(tree["views"][0]["world_asset"]), device=DEVICE)
        af = torch.as_tensor(tree["asset_faces"], device=DEVICE)
        fine_ms = cuda_ms(lambda: metrics.intersection_volume_ratio(hv, hf, av, af,
                                                                    resolution=128), 1)
    refined = out["metrics"]["refined"]
    log(f"stage 2 lifting, {n} views at {LIFT_RES}² of a {H_FULL}-vertex body and a "
        f"{len(tree['asset_faces'])}-face asset, neural COAP ({tree['coap']['parts']} parts of up "
        f"to {tree['coap']['max_part_size']} vertices): generate_3d_hoi_samples {seconds:.3f} s "
        f"(" + ", ".join(f"{k} {v:.3f} s" for k, v in out["seconds"].items()) + f"), peak device "
        f"memory {peak:.3f} GB; depth init {init_ms / n:.3f} ms per sample, the rasterizer "
        f"{raster_ms / n:.3f} ms of it ({raster_ms / init_ms:.4f}, CUDA events around the "
        f"candidates' render); RANSAC {np.mean(ransac_ms):.3f} ms per sample ({len(ransac_ms)} "
        f"calls, 7 candidate views); depth optimisation {step_ms:.3f} ms per step for the batch "
        f"of {n} (CUDA events, {LIFT_TIMED_STEPS[1]} - {LIFT_TIMED_STEPS[0]} steps), "
        f"{LIFT_PROFILED_STEPS} steps under the profiler: {window_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle {1 - busy_ms / window_ms:.4f}, {ops_per_step:.0f} device "
        f"operations per step; compute_metrics {out['seconds']['metrics'] * 1e3 / n:.3f} ms per "
        f"sample, {refined} of {n} refined at 128³ (one 128³ ratio alone: {fine_ms:.3f} ms) "
        f"[{label}]")
    log("stage 2 depth optimisation, device time by kernel over "
        f"{LIFT_PROFILED_STEPS} steps: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms ({e.count})" for e in top))
    residual = [round(float(e["candidates"][e["nearest"]]), 4) for e in expected]
    log(f"stage 2 checks: depth init picked candidate {picked} (the nearest to the true depth "
        f"in every view; residual {residual} m), mean vertex error {err_before.mean():.4f} m -> {err_after.mean():.4f} m after "
        f"{LIFT_EPOCHS} steps, loss {hist[0].sum():.4f} -> {hist[-1].sum():.4f}; IoU "
        f"{min(ious):.4f}-{max(ious):.4f}, interscetion_ratio {max(ratios):.4f}; cli/filter "
        f"kept {stats['leftover']} of {n}")
    return dict(seconds=seconds, stage_seconds=out["seconds"], peak_gb=peak,
                init_ms_per_sample=init_ms / n, raster_ms_per_sample=raster_ms / n,
                raster_share=raster_ms / init_ms, ransac_ms=float(np.mean(ransac_ms)),
                step_ms=step_ms, idle_share=1 - busy_ms / window_ms,
                device_ops_per_step=ops_per_step,
                metrics_ms_per_sample=out["seconds"]["metrics"] * 1e3 / n, refined=refined,
                fine_ratio_ms=fine_ms, picked=picked, err_before=float(err_before.mean()),
                err_after=float(err_after.mean()), filter=stats)


def stage2_phase(images_dir: str, npz: str, label: str) -> dict:
    """Phase 12: 12a then 12b, every kernel's counter from 0: stage 2 runs
    none of K1, K2, K3."""
    from coma_tpu_torch.ops import attention, contact_kernel, occupancy_kernel

    contact_kernel.launches = occupancy_kernel.launches = attention.launches = 0
    runs = dict(predict=predict_phase(images_dir, npz, label), lift=lift_phase(npz, label))
    launches = {"contact_splat": contact_kernel.launches,
                "occupancy_hits": occupancy_kernel.launches,
                "flash_attention": attention.launches}
    if any(launches.values()):
        raise AssertionError(f"stage 2 launched a kernel: {launches}")
    log(f"launches in stage 2: {launches}")
    return dict(runs, launches=launches)


# ---------------------------------------------------------------------------
# Phase 13: stage 1 end to end (render_objects -> select_mask -> prompts -> inpaint)
# ---------------------------------------------------------------------------

STAGE1_SC, STAGE1_CAT = "Chair", "Lounge Chair / Cafe Chair / Office Chair"
STAGE1_ASSET = "0a5a346c-cc3b-4280-b358-ccd1c4d8a865"   # registered: prompts, camera config
STAGE1_SPLITS = (24, 12)       # quads per box side: seat and back, legs (20,736 triangles)
STAGE1_VIEWS, STAGE1_RES = 8, 512
STAGE1_RGB_ATOL, STAGE1_RGB_SHARE, STAGE1_RGB_MAX = 1e-4, 1e-3, 0.15   # the CPU tests'


def chair_box(lo, hi, k: int):
    """An axis-aligned box whose six sides are split into k x k quads:
    (vertices, quads facing out, per-vertex UVs running 0..1 over a side)."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    verts, quads, uvs = [], [], []
    g = np.linspace(0.0, 1.0, k + 1)
    for axis in range(3):
        for side in (0, 1):
            a, b = (axis + 1) % 3, (axis + 2) % 3
            base = len(verts)
            for i in g:
                for j in g:
                    p = np.empty(3)
                    p[axis] = (lo, hi)[side][axis]
                    p[a] = lo[a] + i * (hi[a] - lo[a])
                    p[b] = lo[b] + j * (hi[b] - lo[b])
                    verts.append(p)
                    uvs.append((i, j))
            for i in range(k):
                for j in range(k):
                    q = base + i * (k + 1) + j
                    quad = (q, q + k + 1, q + k + 2, q + 1)
                    quads.append(quad if side else quad[::-1])
    return verts, quads, uvs


def write_chair(root: str, rng, texture: str = None, part_textures: tuple = ()) -> str:
    """A synthetic chair (OBJ axes, y up): a 50 x 50 cm seat at 43-48 cm, a
    back to 95 cm and four 4 cm legs. Seat and back use a ``map_Kd``
    material (a 512² RGB PNG written by the port's writer, or a copy of the
    image file ``texture``), the legs a Kd-only material and carry no UVs.
    ``part_textures`` (up to forty-eight image files) give the back, then
    each leg, then (past five) each of four stretchers between the legs, two
    armrests, four trims under the seat's edges, two slats before the back,
    a footrest bar, a headrest, two back posts, two armrest posts, a rear
    stretcher, three low stretchers, a lumbar bar, a front apron, two seat
    knobs, a cross of two bars under the seat, four foot pads, a back emblem,
    two armrest pads, four studs at the seat's front and four at its back a
    material, UVs and a ``map_Kd`` of their own.
    Returns the OBJ's path."""
    from coma_tpu_torch.utils.png import write_png

    if texture is None:
        yy, xx = np.mgrid[:512, :512] / 512
        tex = np.stack([0.55 + 0.25 * np.sin(40 * xx), 0.35 + 0.15 * np.sin(25 * yy),
                        np.full_like(xx, 0.25)], -1) + rng.uniform(0, 0.1, (512, 512, 3))
        map_kd = "fabric.png"
        write_png(f"{root}/{map_kd}", np.uint8(np.clip(tex, 0, 1) * 255))
    else:
        map_kd = "fabric" + os.path.splitext(texture)[1]
        shutil.copy(texture, f"{root}/{map_kd}")
    mtl = f"newmtl fabric\nKd 0.6 0.4 0.3\nmap_Kd {map_kd}\nnewmtl metal\nKd 0.3 0.3 0.32\n"
    for k, path in enumerate(part_textures):
        name = f"part{k}" + os.path.splitext(path)[1]
        shutil.copy(path, f"{root}/{name}")
        mtl += f"newmtl part{k}\nKd 0.2 0.5 0.7\nmap_Kd {name}\n"
    with open(f"{root}/chair.mtl", "w") as fh:
        fh.write(mtl)
    big, leg = STAGE1_SPLITS
    parts = [("fabric", chair_box((-0.25, 0.43, -0.25), (0.25, 0.48, 0.25), big)),
             ("fabric", chair_box((-0.25, 0.48, -0.25), (0.25, 0.95, -0.2), big))]
    parts += [("metal", chair_box((x, 0.0, z), (x + 0.04, 0.43, z + 0.04), leg))
              for x in (-0.23, 0.19) for z in (-0.23, 0.19)]
    extras = [((-0.21, 0.14, -0.23), (0.19, 0.17, -0.20)),
              ((-0.21, 0.14, 0.19), (0.19, 0.17, 0.22)),
              ((-0.23, 0.14, -0.19), (-0.20, 0.17, 0.19)),
              ((0.20, 0.14, -0.19), (0.23, 0.17, 0.19)),
              ((-0.27, 0.62, -0.20), (-0.23, 0.65, 0.20)),
              ((0.23, 0.62, -0.20), (0.27, 0.65, 0.20)),
              ((-0.25, 0.39, 0.21), (0.25, 0.43, 0.25)),
              ((-0.25, 0.39, -0.25), (0.25, 0.43, -0.21)),
              ((-0.25, 0.39, -0.21), (-0.21, 0.43, 0.21)),
              ((0.21, 0.39, -0.21), (0.25, 0.43, 0.21)),
              ((-0.15, 0.52, -0.20), (-0.11, 0.90, -0.17)),
              ((0.11, 0.52, -0.20), (0.15, 0.90, -0.17)),
              ((-0.21, 0.05, 0.19), (0.19, 0.08, 0.22)),
              ((-0.22, 0.95, -0.25), (0.22, 1.00, -0.19)),
              ((-0.27, 0.48, -0.25), (-0.25, 0.95, -0.21)),
              ((0.25, 0.48, -0.25), (0.27, 0.95, -0.21)),
              ((-0.27, 0.48, 0.14), (-0.24, 0.62, 0.17)),
              ((0.24, 0.48, 0.14), (0.27, 0.62, 0.17)),
              ((-0.21, 0.25, -0.23), (0.19, 0.28, -0.20)),
              ((-0.21, 0.30, 0.19), (0.19, 0.33, 0.22)),
              ((-0.23, 0.30, -0.19), (-0.20, 0.33, 0.19)),
              ((0.20, 0.30, -0.19), (0.23, 0.33, 0.19)),
              ((-0.20, 0.70, -0.21), (0.20, 0.74, -0.19)),
              ((-0.22, 0.35, 0.22), (0.18, 0.38, 0.25)),
              ((-0.20, 0.48, 0.20), (-0.16, 0.52, 0.24)),
              ((0.16, 0.48, 0.20), (0.20, 0.52, 0.24)),
              ((-0.10, 0.20, -0.02), (0.10, 0.23, 0.02)),
              ((-0.02, 0.20, -0.10), (0.02, 0.23, 0.10)),
              ((-0.25, 0.00, -0.25), (-0.19, 0.02, -0.19)),
              ((0.19, 0.00, -0.25), (0.25, 0.02, -0.19)),
              ((-0.25, 0.00, 0.19), (-0.19, 0.02, 0.25)),
              ((0.19, 0.00, 0.19), (0.25, 0.02, 0.25)),
              ((-0.05, 0.80, -0.22), (0.05, 0.88, -0.19)),
              ((-0.27, 0.66, -0.20), (-0.23, 0.68, 0.20)),
              ((0.23, 0.66, -0.20), (0.27, 0.68, 0.20)),
              ((-0.12, 0.44, 0.25), (-0.08, 0.47, 0.26)),
              ((0.08, 0.44, 0.25), (0.12, 0.47, 0.26)),
              ((-0.02, 0.44, 0.25), (0.02, 0.47, 0.26)),
              ((0.16, 0.44, 0.25), (0.20, 0.47, 0.26))]
    rear_studs = [((-0.20, 0.44, -0.26), (-0.16, 0.47, -0.25)),
                  ((0.16, 0.44, -0.26), (0.20, 0.47, -0.25)),
                  ((-0.08, 0.44, -0.26), (-0.04, 0.47, -0.25)),
                  ((0.04, 0.44, -0.26), (0.08, 0.47, -0.25))]
    # with no part textures, the first 34 extras in metal
    boxes = (extras + rear_studs)[:len(part_textures) - 5] if part_textures else extras[:-5]
    parts += [("metal", chair_box(lo, hi, leg)) for lo, hi in boxes]
    for k in range(len(part_textures)):
        parts[1 + k] = (f"part{k}", parts[1 + k][1])
    vlines, tlines, flines, n, current = [], [], [], 0, None
    for mat, (verts, quads, uvs) in parts:
        vlines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
        if mat != current:
            flines.append(f"usemtl {mat}")
            current = mat
        if mat != "metal":
            t0 = len(tlines)
            tlines += [f"vt {u:.6f} {v:.6f}" for u, v in uvs]
            flines += ["f " + " ".join(f"{n + i + 1}/{t0 + i + 1}" for i in q) for q in quads]
        else:
            flines += ["f " + " ".join(str(n + i + 1) for i in q) for q in quads]
        n += len(verts)
    path = f"{root}/chair.obj"
    with open(path, "w") as fh:
        fh.write("\n".join(["mtllib chair.mtl"] + vlines + tlines + flines) + "\n")
    return path


def stage1_render_kwargs(camera) -> dict:
    """``render_textured``'s options as ``cli/render_objects`` passes them at
    its defaults (AO 8, specular 0.25, sky environment, tonemap)."""
    from coma_tpu_torch.lifting.rasterizer import make_sky_env

    return dict(ao_samples=8, light_samples=1, light_cone_deg=5.0, tonemap=True, gi_samples=0,
                specular=0.25, roughness=0.35, env_map=make_sky_env(device=camera.R.device),
                view_dir=tuple((-camera.front).cpu().numpy().astype(np.float32).tolist()))


def stage1_scene(camera, verts_world, mesh):
    from coma_tpu_torch.pipelines.rendering import textured_scene

    scene = textured_scene(camera, verts_world, mesh)
    return scene, stage1_render_kwargs(camera)


def render_scene(scene, kw, res, ground=True):
    from coma_tpu_torch.lifting.rasterizer import render_textured

    cut = None if ground else -2           # the ground quad is the last two triangles
    return render_textured(scene["tri_px"][:cut], scene["tri_uv"][:cut], scene["tri_mat"][:cut],
                           scene["tri_n"][:cut], scene["textures"], res, res,
                           tri_w=scene["tri_w"][:cut], shadow_casters=scene["casters"], **kw)


def run_stage(name: str, argv: list) -> float:
    """One stage through ``cli/generate_2d_hoi_images`` (the others skipped);
    its wall clock, ending in a synchronise."""
    from coma_tpu_torch.cli import generate_2d_hoi_images as orchestrator

    stages = ("render", "select_mask", "prompts", "inpaint")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    orchestrator.main(["--skip", *[s for s in stages if s != name], *argv])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def stage1_timings(camera, verts_world, mesh, label: str) -> dict:
    """Per view at 512² on the card (CUDA events, after a warm-up): the
    textured render split into its attribute pass, shadow pass, 8 AO passes
    and the rest (shading), the silhouette, and the candidate masks."""
    from coma_tpu_torch.geometry import polygon
    from coma_tpu_torch.lifting import rasterizer as R
    from coma_tpu_torch.pipelines.rendering import candidate_mask_grid, candidate_quads

    scene, kw = stage1_scene(camera, verts_world, mesh)
    res = STAGE1_RES
    attrs = lambda: R.rasterize_attributes(scene["tri_px"], scene["tri_uv"], scene["tri_mat"],
                                           scene["tri_n"], res, res, tri_aux=scene["tri_w"])
    pos_img = attrs()[4]
    light = torch.tensor((0.25, 0.15, 0.95), device=DEVICE)
    light = light / torch.linalg.norm(light)
    dirs = R.cosine_hemisphere_dirs(8, device=DEVICE)
    out = dict(
        triangles=int(scene["tri_px"].shape[0]),
        attributes_ms=cuda_ms(attrs, reps=5),
        shadow_ms=cuda_ms(lambda: R._directional_visibility(
            scene["casters"], pos_img, light[None], 512, 2.0, 3, R.CHUNK), reps=5),
        ao_ms=cuda_ms(lambda: R._directional_visibility(
            scene["casters"], pos_img, dirs, 256, 2.0, 1, R.CHUNK), reps=5),
        render_ms=cuda_ms(lambda: render_scene(scene, kw, res), reps=5),
    )
    out["shading_ms"] = out["render_ms"] - out["attributes_ms"] - out["shadow_ms"] - out["ao_ms"]
    verts_t = torch.as_tensor(np.float32(verts_world), device=DEVICE)
    faces_t = torch.as_tensor(mesh.faces, device=DEVICE)
    out["silhouette_ms"] = cuda_ms(lambda: R.render_silhouette(camera, verts_t, faces_t), reps=5)
    cfg = dict(bbox_size=(0.6, 0.6, 1.1), stride_x=0.1, stride_y=0.1, azimuth_z=np.pi / 2)
    bounds = (verts_world.min(axis=0), verts_world.max(axis=0))
    quads = candidate_quads(camera, bounds, **cfg)
    hulls, counts = polygon.pad_hulls([polygon.convex_hull(q) for q in quads])
    hulls, counts = torch.as_tensor(hulls, device=DEVICE), torch.as_tensor(counts, device=DEVICE)
    out["masks"] = len(quads)
    out["fill_ms"] = cuda_ms(lambda: polygon.fill_convex_polygons(hulls, counts, res, res), reps=5)
    out["mask_grid_ms"] = cuda_ms(lambda: candidate_mask_grid(camera, bounds, **cfg), reps=5)
    log(f"stage 1, one view at {res}² ({out['triangles']} triangles with the ground): "
        f"render_textured {out['render_ms']:.3f} ms = attribute pass "
        f"{out['attributes_ms']:.3f} + shadow pass {out['shadow_ms']:.3f} + 8 AO passes "
        f"{out['ao_ms']:.3f} + shading {out['shading_ms']:.3f}; silhouette "
        f"{out['silhouette_ms']:.3f} ms; {out['masks']} candidate masks: fill "
        f"{out['fill_ms']:.3f} ms, the grid with its host hulls {out['mask_grid_ms']:.3f} ms "
        f"(CUDA events) [{label}]")
    return out


def stage1_phase(label: str, texture: str = None, res: int = STAGE1_RES, timings: bool = True,
                 check=None, part_textures: tuple = ()) -> dict:
    """Phase 13: ``cli/generate_2d_hoi_images`` on a synthetic textured chair
    at ``render_objects``' defaults and the Chair camera config, every
    kernel's counter from 0, then the checks. Phase 16 passes a JPEG
    ``texture`` and ``part_textures`` of other formats, renders at ``res``,
    skips the per-view ``timings`` and adds ``check(obj, mesh, batches)``
    (``batches``: each ``cli/inpaint.load_batch`` call's chunk, images and
    masks)."""
    from coma_tpu_torch.cli import inpaint as cli_inpaint
    from coma_tpu_torch.cli import render_objects as cli_render
    from coma_tpu_torch.geometry.mesh import load_obj_textured
    from coma_tpu_torch.lifting import rasterizer as R
    from coma_tpu_torch.lifting.cameras import OrthoCamera
    from coma_tpu_torch.models.diffusion.pipeline import AdaptiveMaskInpaintPipeline
    from coma_tpu_torch.ops import attention, contact_kernel, occupancy_kernel
    from coma_tpu_torch.pipelines.rendering import candidate_mask_grid
    from coma_tpu_torch.utils.png import read_png

    root = tempfile.mkdtemp(prefix="stage1_", dir=SCRATCH)
    obj = write_chair(root, np.random.default_rng(SEED + 5), texture, part_textures)
    argv = ["--obj_pth", obj, "--supercategory", STAGE1_SC, "--category", STAGE1_CAT,
            "--asset_id", STAGE1_ASSET, "--resolution", str(res), str(res),
            "--device", DEVICE, "--random_weights",
            "--num_img_per_combination", "1", "--batch_size", str(INPAINT_IMAGES)]
    contact_kernel.launches = occupancy_kernel.launches = attention.launches = 0
    for src in attention.source_launches:
        attention.source_launches[src] = 0
    png_seconds = [0.0]
    write_png = cli_render.write_png

    def timed_write(path, image):
        t0 = time.perf_counter()
        write_png(path, image)
        png_seconds[0] += time.perf_counter() - t0

    outputs, generate = [], AdaptiveMaskInpaintPipeline.generate
    batches, load_batch = [], cli_inpaint.load_batch

    def kept(self, *args, **kwargs):     # the float images, for the range check
        out = generate(self, *args, **kwargs)
        outputs.append((out[0] if isinstance(out, tuple) else out).float().cpu())
        return out

    def recorded(chunk, size):           # the inpainting's inputs
        imgs, masks = load_batch(chunk, size)
        batches.append((chunk, imgs, masks))
        return imgs, masks

    cwd = os.getcwd()
    cli_render.write_png = timed_write
    cli_inpaint.load_batch = recorded
    AdaptiveMaskInpaintPipeline.generate = kept
    seconds, peak = {}, {}
    try:
        os.chdir(root)
        for stage in ("render", "select_mask", "prompts"):
            torch.cuda.reset_peak_memory_stats()
            seconds[stage] = run_stage(stage, argv)
            peak[stage] = torch.cuda.max_memory_allocated() / 1e9
        g = f"{root}/results/generation"
        base = f"{STAGE1_SC}/{STAGE1_CAT.replace('/', ':')}/{STAGE1_ASSET}"
        kept_ids = {}
        for p in sorted(glob_paths(f"{g}/valid_masks/{base}", "*.pickle")):
            with open(p, "rb") as fh:
                kept_ids[Path(p).stem] = pickle.load(fh)["valid_mask_ids"]
        log("stage 1: the Chair band [0.8, 0.9] kept, per view: " + ", ".join(
            f"{v} {len(ids)}" for v, ids in kept_ids.items()))
        chosen = [v for v, ids in kept_ids.items() if ids][:2]
        if len(chosen) < 2:
            raise AssertionError(f"fewer than two views kept a mask: {kept_ids}")
        for v, ids in kept_ids.items():
            with open(f"{g}/valid_masks/{base}/{v}.pickle", "rb") as fh:
                d = pickle.load(fh)
            d["valid_mask_ids"] = ids[:1] if v in chosen else []
            with open(f"{g}/valid_masks/{base}/{v}.pickle", "wb") as fh:
                pickle.dump(d, fh)
        with open(f"{g}/prompts/{base}/prompts.pickle", "rb") as fh:
            prompts = pickle.load(fh)
        prompts["prompts"] = prompts["prompts"][:1]
        with open(f"{g}/prompts/{base}/prompts.pickle", "wb") as fh:
            pickle.dump(prompts, fh)
        torch.cuda.reset_peak_memory_stats()
        seconds["inpaint"] = run_stage("inpaint", argv)
        peak["inpaint"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        os.chdir(cwd)
        cli_render.write_png = write_png
        cli_inpaint.load_batch = load_batch
        AdaptiveMaskInpaintPipeline.generate = generate
    launches = {"contact_splat": contact_kernel.launches,
                "occupancy_hits": occupancy_kernel.launches,
                "flash_attention": attention.launches}
    by_source = dict(attention.source_launches)

    # the files, and each seg against the silhouette of its camera
    counts = {d: len(glob_paths(f"{g}/{d}/{base}", f"*.{ext}"))
              for d, ext in (("renders", "png"), ("asset_segs", "png"), ("cameras", "pickle"))}
    if set(counts.values()) != {STAGE1_VIEWS}:
        raise AssertionError(f"stage 1 wrote {counts}, expected {STAGE1_VIEWS} of each")
    mesh = load_obj_textured(obj)
    verts_world = mesh.vertices @ cli_render.OBJ_TO_WORLD.T
    verts_world = verts_world - np.array([0.0, 0.0, verts_world[:, 2].min()])
    verts_t = torch.as_tensor(np.float32(verts_world), device=DEVICE)
    faces_t = torch.as_tensor(mesh.faces, device=DEVICE)
    cameras = []
    for v in range(STAGE1_VIEWS):
        view = f"view:{v:05d}"
        with open(f"{g}/cameras/{base}/{view}.pickle", "rb") as fh:
            camera = OrthoCamera.from_pickle(pickle.load(fh), device=DEVICE)
        cameras.append(camera)
        seg = read_png(f"{g}/asset_segs/{base}/{view}.png")[..., 0]
        want = R.render_silhouette(camera, verts_t, faces_t).cpu().numpy().astype(np.uint8) * 255
        if not np.array_equal(seg, want):
            raise AssertionError(f"{view}: the seg differs from render_silhouette at "
                                 f"{int((seg != want).sum())} pixels")

    # view 0: the PNG is the card's render; the card against the CPU
    camera = cameras[0]
    scene, kw = stage1_scene(camera, verts_world, mesh)
    rgb, covered = render_scene(scene, kw, res)
    png = read_png(f"{g}/renders/{base}/view:00000.png")
    if not np.array_equal((rgb * 255).to(torch.uint8).cpu().numpy(), png):
        raise AssertionError("the render PNG is not the card's render_textured")
    alone, alone_cov = render_scene(scene, kw, res, ground=False)
    seg0 = read_png(f"{g}/asset_segs/{base}/view:00000.png")[..., 0] > 0
    if not (alone[~alone_cov] == 1.0).all() or not np.array_equal(alone_cov.cpu().numpy(), seg0):
        raise AssertionError("the asset alone: background not exactly white, or its coverage "
                             "is not the seg")
    # the CPU renders the card's scene: the projection is a matrix product,
    # summed in another order by cuBLAS, so it is held on its own
    cpu_cam = OrthoCamera(R=camera.R.cpu(), t=camera.t.cpu(), scale=camera.scale,
                          resolution=camera.resolution)
    projected, cpu_kw = stage1_scene(cpu_cam, verts_world, mesh)
    # (the asset's triangles: the ground's corners lie 1e4 m out, where a
    # float32 pixel coordinate's last bit is 0.06 px)
    projection_err = float((projected["tri_px"][:-2] - scene["tri_px"][:-2].cpu()).abs().max())
    cpu_scene = {k: v.cpu() for k, v in scene.items()}
    t0 = time.perf_counter()
    cpu_rgb, cpu_cov = render_scene(cpu_scene, cpu_kw, res)
    cpu_render_s = time.perf_counter() - t0
    attrs = [R.rasterize_attributes(s["tri_px"], s["tri_uv"], s["tri_mat"], s["tri_n"],
                                    res, res, tri_aux=s["tri_w"])
             for s in (scene, cpu_scene)]
    if not (torch.equal(torch.isfinite(attrs[0][0]).cpu(), torch.isfinite(attrs[1][0]))
            and torch.equal(attrs[0][2].cpu(), attrs[1][2])
            and torch.equal(covered.cpu(), cpu_cov)):
        raise AssertionError("view 0: coverage or material differ between the card and the CPU")
    diff = (rgb.cpu() - cpu_rgb).abs()
    beyond = int((diff > STAGE1_RGB_ATOL).sum())
    if beyond > STAGE1_RGB_SHARE * diff.numel() or float(diff.max()) > STAGE1_RGB_MAX:
        raise AssertionError(f"view 0 RGB: {beyond} values beyond {STAGE1_RGB_ATOL} of "
                             f"{diff.numel()}, max {float(diff.max()):.3e}")
    cfg = dict(bbox_size=(0.6, 0.6, 1.1), stride_x=0.1, stride_y=0.1, azimuth_z=np.pi / 2)
    bounds = (verts_world.min(axis=0), verts_world.max(axis=0))
    masks = candidate_mask_grid(camera, bounds, **cfg)
    cpu_masks = candidate_mask_grid(cpu_cam, bounds, **cfg)
    mask_pngs = sorted(glob_paths(f"{g}/asset_masks/{base}/view:00000", "*.png"))
    written = np.stack([read_png(p)[..., 0] for p in mask_pngs])
    if not torch.equal(masks.cpu(), cpu_masks) or not np.array_equal(written, cpu_masks.numpy()):
        raise AssertionError("view 0: candidate masks differ between the card, the CPU and "
                             "the PNGs")

    # the inpainting batch: K3 only, on the tensor-core kernel
    if launches["flash_attention"] != K3_LAUNCHES_PER_BATCH \
            or by_source["flash_attention_sm90"] != K3_LAUNCHES_PER_BATCH \
            or launches["contact_splat"] or launches["occupancy_hits"]:
        raise AssertionError(f"stage 1 launches {launches} ({by_source}); expected K3 "
                             f"{K3_LAUNCHES_PER_BATCH}, all bf16, and no K1 or K2")
    pngs = glob_paths(f"{g}/inpaintings", "**/*.png")
    if len(pngs) != INPAINT_IMAGES or len(outputs) != 1:
        raise AssertionError(f"inpaint wrote {len(pngs)} images in {len(outputs)} batches")
    out = outputs[0]
    if out.shape != (INPAINT_IMAGES, 3, INPAINT_RES, INPAINT_RES) or not torch.isfinite(out).all() \
            or out.min() < 0 or out.max() > 1:
        raise AssertionError(f"stage 1 images: shape {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    timings = stage1_timings(camera, verts_world, mesh, label) if timings else {}
    if check is not None:
        check(obj, mesh, batches)
    log(f"stage 1 through cli/generate_2d_hoi_images ({mesh.faces.shape[0]} faces, "
        f"{STAGE1_VIEWS} views at {res}², texture {os.path.basename(texture or 'fabric.png')}): render {seconds['render']:.3f} s (of it "
        f"{png_seconds[0]:.3f} s writing PNGs: {STAGE1_VIEWS} renders, {STAGE1_VIEWS} segs, "
        f"{STAGE1_VIEWS} x {masks.shape[0]} masks), select_mask {seconds['select_mask']:.3f} s, "
        f"generate_prompts {seconds['prompts']:.3f} s, inpaint {seconds['inpaint']:.3f} s = "
        f"{INPAINT_IMAGES / seconds['inpaint']:.4f} images/s (views {', '.join(chosen)}); peak "
        f"device memory " + ", ".join(f"{k} {v:.3f} GB" for k, v in peak.items())
        + f"; view 0 on the card vs the CPU: the asset's projection within {projection_err:.3e} "
        f"px; on "
        f"the card's triangles coverage and material equal, RGB {beyond} values beyond "
        f"{STAGE1_RGB_ATOL} of {diff.numel()}, max {float(diff.max()):.3e} (the CPU's render "
        f"{cpu_render_s:.3f} s); masks equal; launches {launches} ({by_source}) [{label}]")
    shutil.rmtree(root, ignore_errors=True)
    return dict(seconds=seconds, peak_gb=peak, png_seconds=png_seconds[0], kept=kept_ids,
                launches=launches, by_source=by_source, rgb_beyond=beyond,
                rgb_max_err=float(diff.max()), projection_err=projection_err, **timings)


# ---------------------------------------------------------------------------
# Phase 14: BEHAVE ground-truth evaluation, visualize, train_segmenter
# ---------------------------------------------------------------------------

EVAL_KEY, EVAL_H, EVAL_O = "quant:full", 750, 2048   # quant:full's widths
BEHAVE_FRAMES = 64
EVAL_SIM_ATOL = 1e-6
VOLUME_ATOL, VOLUME_SHARE, VOLUME_MAX = 1e-4, 1e-3, 1e-2
SCENE_SIZE = (512, 384)     # the Kinect camera at the CLI's resolution
TRAIN_CUTS = ["--steps", "20", "--eval_batches", "2", "--log_every", "10"]
TRAIN_CHECK_BATCH, TRAIN_CHECK_LR = 8, 3e-4
TRAIN_ATOL, TRAIN_GRAD_FLOOR = 1e-4, 1e-5


def kernel_counts() -> dict:
    from coma_tpu_torch.ops import attention, contact_kernel, occupancy_kernel

    return {"contact_splat": contact_kernel.launches,
            "occupancy_hits": occupancy_kernel.launches,
            "flash_attention": attention.launches}


def reset_kernel_counts() -> None:
    from coma_tpu_torch.ops import attention, contact_kernel, occupancy_kernel

    contact_kernel.launches = occupancy_kernel.launches = attention.launches = 0
    for src in attention.source_launches:
        attention.source_launches[src] = 0


def small_rotation(rng, scale: float) -> np.ndarray:
    from coma_tpu_torch.geometry.transforms import rodrigues

    return rodrigues(torch.tensor(rng.normal(size=3) * scale)).numpy()


def write_behave_frames(root: str, rng) -> dict:
    """A BEHAVE sequence of ``BEHAVE_FRAMES`` frames at quant:full's widths:
    per frame the posed 10475-vertex body as the fit's verts/faces pickle,
    the backpack's ``lowres_center``, ``raw2normal`` and fit (angle, trans)
    pickles; the human downsample (750 indices) and the object's (2048 raw
    points with normals from the phase 3 backpack)."""
    verts, faces = human_template()
    seq = f"{root}/Date01_Sub01_backpack"
    os.makedirs(seq)
    with open(f"{seq}/info.json", "w") as fh:
        json.dump(dict(cat="backpack", gender="male", kinects=[0, 1, 2, 3]), fh)
    obj_verts, obj_normals = backpack(rng, 2000)
    raw_pts, raw_normals = backpack(rng, EVAL_O)
    human_meta = dict(downsample_indices=np.sort(rng.choice(H_FULL, EVAL_H, replace=False)),
                      N=EVAL_H)
    obj_meta = dict(obj_vertices_original=obj_verts, obj_vertex_normals_original=obj_normals,
                    downsampled_pcd_points_raw=raw_pts, downsampled_pcd_normal_raw=raw_normals,
                    N_raw=EVAL_O)

    def dump(path, payload):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as fh:
            pickle.dump(payload, fh)

    for k in range(BEHAVE_FRAMES):
        frame = f"{seq}/t{k // 30:04d}.{k % 30:03d}"
        rot = small_rotation(rng, 0.02)
        shift = rng.normal(scale=0.005, size=3)
        dump(f"{frame}/person/fit01/person_fit_mesh.pickle",
             dict(verts=verts @ rot.T + shift + rng.normal(scale=0.002, size=verts.shape),
                  faces=faces))
        R = small_rotation(rng, 0.02)
        t = rng.normal(scale=0.005, size=3)
        center = rng.normal(scale=0.005, size=3)
        fit = f"{frame}/backpack/fit01"
        dump(f"{fit}/lowres_center.pickle", dict(obj_lowres_center=center))
        dump(f"{fit}/raw2normal.pickle", dict(R_raw2normal=R, t_raw2normal=t))
        # the fit follows the body's shift, within a few mm
        dump(f"{fit}/backpack_fit.pkl", dict(angle=rng.normal(scale=0.01, size=3),
                                             trans=shift + rng.normal(scale=0.003, size=3)))
    return dict(seq=seq, human_meta=human_meta, obj_meta=obj_meta)


def behave_prep(data: dict):
    """The frames of ``data``'s sequence (read through the port's reader) and
    the prep of one frame into the canonical frame."""
    from coma_tpu_torch.config.hyperparams import get_hyperparams
    from coma_tpu_torch.pipelines.behave_eval import (
        BehaveSequence, prepare_affordance_extraction_inputs_for_behave)

    reader = BehaveSequence(data["seq"])
    frames = list(range(len(reader)))
    hp = get_hyperparams(EVAL_KEY)

    def prep(idx):
        fit = os.path.dirname(reader.objfit_param_file(idx, "fit01"))
        return prepare_affordance_extraction_inputs_for_behave(
            human_mesh_pth=f"{reader.frame_folder(idx)}/person/fit01/person_fit_mesh.pickle",
            human_mesh_pth_type="pickle", human_downsample_metadata=data["human_meta"],
            object_downsample_metadata=data["obj_meta"],
            human_use_downsample_pcd_raw=hp["human_use_downsample_pcd_raw"],
            object_use_downsample_pcd_raw=hp["object_use_downsample_pcd_raw"],
            lowres_center_pth=f"{fit}/lowres_center.pickle",
            raw2normal_pth=f"{fit}/raw2normal.pickle",
            obj_param_pth=reader.objfit_param_file(idx, "fit01"), eps=hp["eps"])

    return frames, prep


def eval_state(device, H: int = EVAL_H, O: int = EVAL_O):
    """A fresh state at ``quant:full``'s hyperparameters."""
    from coma_tpu_torch.affordance.state import init_coma_state
    from coma_tpu_torch.config.hyperparams import get_hyperparams

    hp = get_hyperparams(EVAL_KEY)
    return init_coma_state(H, O, hp["normal_res"], hp["spatial_grid_size"],
                           hp["spatial_grid_thres"], hp["normal_gaussian_sigma"],
                           hp["principle_vec"], hp["sub_principle_vec"], hp["eps"],
                           device=device)


def gt_state(data: dict):
    """``aggregate_samples_streaming`` over the prepped frames: the
    ground-truth state (K1 on the card, one launch per 32 frames)."""
    from coma_tpu_torch.pipelines.extract import aggregate_samples_streaming

    frames, prep = behave_prep(data)
    return aggregate_samples_streaming(eval_state(DEVICE), frames, prep, occupancy=False,
                                       batch_size=SLAB)


K1_FIELDS = ("prob_grid_canon_human_wrt_obj", "prob_grid_canon_obj_wrt_human",
             "contact_dist_expectation_grid_nom", "contact_dist_expectation_grid_denom",
             "significant_contact_count", "used_count")


def state_err(kern, plain, what: str) -> float:
    worst = 0.0
    for f in K1_FIELDS:
        k, p = getattr(kern, f), getattr(plain, f).to(getattr(kern, f).device)
        err = (k - p).abs()
        if not torch.isfinite(k).all() or bool((err > K1_ATOL + K1_RTOL * p.abs()).any()):
            raise AssertionError(f"{what}: {f} differs by {float(err.max()):.3e} "
                                 f"(limit {K1_ATOL:.0e} + {K1_RTOL:.0e} |plain|)")
        worst = max(worst, float(err.max()))
    return worst


def evaluate_phase(root: str, label: str) -> dict:
    """14a: the ground-truth state of a BEHAVE-shaped sequence through the
    library (K1 launches counted from 0), held against the plain version on
    the card; ``cli/evaluate`` of it against itself and against a perturbed
    one."""
    from coma_tpu_torch.affordance.contact import contact_update_batch
    from coma_tpu_torch.affordance.io import save_coma_state
    from coma_tpu_torch.cli import evaluate

    data = write_behave_frames(f"{root}/gt", np.random.default_rng(SEED + 12))
    other = write_behave_frames(f"{root}/other", np.random.default_rng(SEED + 13))
    frames, prep = behave_prep(data)
    t0 = time.perf_counter()
    prepped = [prep(i) for i in frames]
    prep_ms = (time.perf_counter() - t0) / len(frames) * 1e3
    perturbed, _ = gt_state(other)
    save_coma_state(perturbed, f"{root}/other.pickle")
    del perturbed
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    state, n = gt_state(data)
    torch.cuda.synchronize()
    aggregate_s = time.perf_counter() - t0
    gt_pickle = f"{root}/gt.pickle"
    save_coma_state(state, gt_pickle)
    metrics, eval_s = {}, []
    for name, pred in (("self", gt_pickle), ("perturbed", f"{root}/other.pickle")):
        t0 = time.perf_counter()
        evaluate.main(["--pred_coma", pred, "--gt_coma", gt_pickle, "--out_json",
                       f"{root}/{name}.json", "--device", DEVICE])
        eval_s.append(time.perf_counter() - t0)
        with open(f"{root}/{name}.json") as fh:
            metrics[name] = json.load(fh)
    launches = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if n != BEHAVE_FRAMES or launches != {"contact_splat": -(-BEHAVE_FRAMES // SLAB),
                                          "occupancy_hits": 0, "flash_attention": 0}:
        raise AssertionError(f"evaluation: {n} frames, launches {launches}")
    for key, m in metrics["self"].items():
        if abs(m["sim"] - 1.0) > EVAL_SIM_ATOL or abs(m["mae"]) > EVAL_SIM_ATOL:
            raise AssertionError(f"evaluate against itself: {key} {m}")
    for key, m in metrics["perturbed"].items():
        if not (np.isfinite([m["sim"], m["mae"]]).all() and m["sim"] < 1.0):
            raise AssertionError(f"evaluate against the perturbed state: {key} {m}")

    # the plain version over all frames, on the card: the CPU route takes ~94 s a
    # frame at these widths (tests/test_torch_behave_eval.py holds it at small ones)
    stack = {f: torch.from_numpy(np.stack([d[f] for d in prepped])).to(DEVICE)
             for f in ("human_verts", "human_normals", "obj_verts", "obj_normals")}
    plain = contact_update_batch(eval_state(DEVICE), stack["human_verts"],
                                 stack["human_normals"], stack["obj_verts"], stack["obj_normals"])
    card_err = state_err(state, plain, "evaluation: K1 against the plain version on the card")
    del plain, state
    torch.cuda.empty_cache()
    log(f"evaluation ({EVAL_KEY}, H={EVAL_H} O={EVAL_O} N=250, {BEHAVE_FRAMES} frames): host "
        f"prep {prep_ms:.3f} ms per frame, aggregation {aggregate_s:.3f} s (prep and K1), "
        f"evaluate {eval_s[0]:.3f} s / {eval_s[1]:.3f} s (self / perturbed), peak device memory "
        f"{peak_gb:.3f} GB; K1 vs its plain version on the card max abs {card_err:.3e}; "
        f"SIM/MAE self "
        f"{json.dumps(metrics['self'])}, perturbed {json.dumps(metrics['perturbed'])}; "
        f"launches {launches} [{label}]")
    return dict(launches=launches, prep_ms_per_frame=prep_ms, aggregate_s=aggregate_s,
                evaluate_s=eval_s, peak_gb=peak_gb, k1_vs_plain_max_abs=card_err,
                metrics=metrics)


def read_ply_mesh_colors(path: str) -> np.ndarray:
    """The (V, 3) uint8 vertex colours of a binary PLY mesh as
    ``save_vertex_colored_mesh`` writes it."""
    with open(path, "rb") as fh:
        data = fh.read()
    head, body = data.split(b"end_header\n", 1)
    n_v = int(head.split(b"element vertex ")[1].split(b"\n")[0])
    rec = np.frombuffer(body[:27 * n_v], np.dtype([("xyz", "<f8", 3), ("rgb", "u1", 3)]))
    return rec["rgb"]


def check_image(img: np.ndarray, what: str) -> None:
    if not (np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0):
        raise AssertionError(f"{what}: not finite in [0, 1]")


def contact_scene_inputs(npz: str):
    """Phase 12's posed body in the Kinect colour frame (3 m in front), its
    part labels from the skinning weights, and a 10 cm sphere 2 cm from its
    side at the pelvis."""
    from coma_tpu_torch.visualization.contact_viz import part_labels_from_lbs, uv_sphere

    _, body, joints, faces = seeded_body(npz, np.random.default_rng(SEED + 11))
    pelvis = joints[0]
    near = body[np.argmax(body[:, 0] - 10 * np.abs(body[:, 2] - pelvis[2]))]
    out = near - pelvis
    out[2] = 0.0
    out /= np.linalg.norm(out)
    sphere = uv_sphere(near + out * (0.02 + 0.1), 0.1, 16, 24)

    def to_cam(v):
        v = np.asarray(v, np.float64) - [pelvis[0], pelvis[1], 0.85]
        return np.stack([v[:, 0], v[:, 2], 3.0 + v[:, 1]], -1)

    labels = part_labels_from_lbs(np.load(npz)["weights"])
    return [(to_cam(body), np.asarray(faces)), (to_cam(sphere[0]), sphere[1])], labels


def visualize_phase(products: dict, star_pickle: str, obj_pickle: str, npz: str, out: str,
                    label: str) -> dict:
    """14b: ``cli/visualize`` on phase 4's products, the volume render on
    the card against the CPU, and a contact scene (counters from 0)."""
    from coma_tpu_torch.cli import visualize
    from coma_tpu_torch.utils.colormap import jet_rgb
    from coma_tpu_torch.utils.png import read_png
    from coma_tpu_torch.visualization.contact_viz import (PART_NAMES, get_contact_spheres,
                                                         render_contact_scene)
    from coma_tpu_torch.visualization.volume import save_occupancy_volume_render

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    seconds = {}
    runs = (("human", ["human", "--affordance_npy", products["human_contact"], "--smplx_star_pth",
                       star_pickle, "--out", f"{out}/human"]),
            ("object", ["object", "--ply", products["object_contact"], "--out",
                        f"{out}/object.png"]),
            ("volume", ["occupancy", "--occupancy_npy", products["occupancy"],
                        "--asset_downsample_pth", obj_pickle, "--out", f"{out}/volume.png"]),
            ("slices", ["occupancy", "--mode", "slices", "--occupancy_npy",
                        products["occupancy"], "--out", f"{out}/slices.png"]))
    for name, argv in runs:
        t0 = time.perf_counter()
        visualize.main(argv + ["--device", DEVICE])
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    meshes, labels = contact_scene_inputs(npz)
    spheres = get_contact_spheres(meshes[0][0], labels, meshes[1][0], meshes[1][1])
    if not spheres:
        raise AssertionError("contact scene: no contact sphere 2 cm from the body")
    scene_ms = cuda_ms(lambda: render_contact_scene(meshes, image_size=SCENE_SIZE,
                                                    viz_contact=True, part_labels=labels,
                                                    device=DEVICE), reps=3)
    scene = render_contact_scene(meshes, image_size=SCENE_SIZE, viz_contact=True,
                                 part_labels=labels, device=DEVICE)
    launches = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(launches.values()):
        raise AssertionError(f"visualize launched a kernel: {launches}")

    weights = np.load(products["human_contact"]).astype(np.float64)
    weights = (weights - weights.min()) / max(weights.max() - weights.min(), 1e-12)
    want = np.clip(np.round(jet_rgb(weights) * 255), 0, 255).astype(np.uint8)
    if not np.array_equal(read_ply_mesh_colors(f"{out}/human.ply"), want):
        raise AssertionError("visualize human: the PLY's colours are not the product's")
    for name in ("human.png", "object.png", "volume.png", "slices.png"):
        check_image(read_png(f"{out}/{name}") / 255.0, name)
    check_image(scene, "contact scene")
    if scene.shape != (SCENE_SIZE[1], SCENE_SIZE[0], 3) or not (scene < 0.99).any():
        raise AssertionError(f"contact scene: shape {scene.shape} or nothing drawn")

    info = np.load(products["occupancy"], allow_pickle=True).item()
    with open(obj_pickle, "rb") as fh:
        d = pickle.load(fh)
    verts = np.asarray(d["obj_vertices_original"], np.float32)
    mesh = (verts - verts[0][None], np.asarray(d["obj_faces_original"], np.int64))
    kw = dict(mesh=mesh, voxel_size=float(info["spatial_grid_metadata"]["voxel_size"]))
    card = save_occupancy_volume_render(None, info["prob_field"], device=DEVICE, **kw)
    t0 = time.perf_counter()
    cpu = save_occupancy_volume_render(None, info["prob_field"], device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    check_image(card, "volume render")
    diff = np.abs(card - cpu)
    share = float((diff > VOLUME_ATOL).mean())
    if share > VOLUME_SHARE or diff.max() > VOLUME_MAX:
        raise AssertionError(f"volume render card vs CPU: {share:.2e} of values beyond "
                             f"{VOLUME_ATOL:.0e}, max {diff.max():.3e}")
    field = torch.as_tensor(info["prob_field"], device=DEVICE)
    from coma_tpu_torch.visualization.volume import render_occupancy_volume

    volume_ms = cuda_ms(lambda: render_occupancy_volume(field), reps=3)
    log(f"visualize: human {seconds['human']:.3f} s, object {seconds['object']:.3f} s, volume "
        f"{seconds['volume']:.3f} s, slices {seconds['slices']:.3f} s (CLI wall clocks); "
        f"volume render 512², 192 steps, R={field.shape[0]}: {volume_ms:.3f} ms (CUDA events), "
        f"card vs CPU max {diff.max():.3e}, {share:.2e} of values beyond {VOLUME_ATOL:.0e} "
        f"(CPU {cpu_s:.1f} s); contact scene {SCENE_SIZE[0]}x{SCENE_SIZE[1]} with contact "
        f"spheres ({', '.join(PART_NAMES[p] for p in sorted(spheres))}): {scene_ms:.3f} ms; peak device memory {peak_gb:.3f} GB; launches {launches} "
        f"[{label}]")
    return dict(launches=launches, cli_seconds=seconds, volume_ms=volume_ms,
                volume_max_abs=float(diff.max()), volume_share_beyond=share,
                contact_scene_ms=scene_ms, peak_gb=peak_gb)


def train_step_card_vs_cpu() -> dict:
    """One AdamW step of the segmenter from seeded weights on a fixed batch
    (8 images at 128², corrupted), card against CPU with TF32 off: the loss
    within 1e-4, every parameter whose CPU gradient is at least 1e-5 within
    1e-4, the rest within 2.2 lr (Adam's first step scales each gradient by
    its own size, so near-zero gradients take any sign)."""
    from coma_tpu_torch.models.layers import init_flax_default_
    from coma_tpu_torch.models.segmentation import PersonSegmenter
    from coma_tpu_torch.models.segmentation_train import SegTrainer
    from coma_tpu_torch.models.synthetic_person import person_batch_domain

    imgs, masks = person_batch_domain(np.random.default_rng(SEED + 14), TRAIN_CHECK_BATCH, 128,
                                      corrupt=True, device="cpu")
    out = {}
    with NoTF32():
        for dev in ("cpu", DEVICE):
            model = init_flax_default_(PersonSegmenter(), torch.Generator().manual_seed(SEED))
            trainer = SegTrainer(model.to(dev), TRAIN_CHECK_LR, weight_decay=1e-4)
            loss = trainer.step(torch.as_tensor(imgs, device=dev),
                                torch.as_tensor(masks, device=dev))
            out[dev] = (float(loss), {k: (p.detach().cpu(), p.grad.detach().cpu())
                                      for k, p in model.named_parameters()})
    loss_err = abs(out[DEVICE][0] - out["cpu"][0])
    worst_sure, worst_all = 0.0, 0.0
    for k, (p_cpu, g_cpu) in out["cpu"][1].items():
        err = (out[DEVICE][1][k][0] - p_cpu).abs()
        sure = g_cpu.abs() >= TRAIN_GRAD_FLOOR
        worst_sure = max(worst_sure, float(err[sure].max()) if sure.any() else 0.0)
        worst_all = max(worst_all, float(err.max()))
    if loss_err > TRAIN_ATOL or worst_sure > TRAIN_ATOL or worst_all > 2.2 * TRAIN_CHECK_LR:
        raise AssertionError(f"training step card vs CPU: loss {loss_err:.3e}, parameters "
                             f"{worst_sure:.3e} (|grad| >= {TRAIN_GRAD_FLOOR:.0e}), "
                             f"{worst_all:.3e} (all)")
    return dict(loss_err=loss_err, param_err=worst_sure, param_err_all=worst_all)


def train_phase(out: str, label: str) -> dict:
    """14c: ``cli/train_segmenter`` at its defaults cut to 20 steps (counters
    from 0), its checkpoint loaded and run, one step card against CPU."""
    from coma_tpu_torch.cli import train_segmenter
    from coma_tpu_torch.models.flax_params import load_flax_params
    from coma_tpu_torch.models.segmentation import PersonSegmenter, make_person_segment_fn
    from coma_tpu_torch.models.synthetic_person import person_batch
    from coma_tpu_torch.utils.checkpoint import load_params

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    summary = train_segmenter.main(TRAIN_CUTS + ["--out", f"{out}/person_segmenter.npz",
                                                 "--device", DEVICE])
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(launches.values()):
        raise AssertionError(f"train_segmenter launched a kernel: {launches}")
    losses = np.asarray(summary["losses"])
    if not np.isfinite(losses).all() or not losses[-10:].mean() < losses[0]:
        raise AssertionError(f"train_segmenter: losses {losses.tolist()}")
    model = load_flax_params(PersonSegmenter(device=DEVICE), load_params(summary["out"])).eval()
    images = torch.as_tensor(person_batch(np.random.default_rng(SEED + 15), 4, 128)[0],
                             device=DEVICE).permute(0, 3, 1, 2)
    with torch.no_grad():
        masks = make_person_segment_fn(model)(images)
    if masks.shape != (4, 128, 128) or not torch.isfinite(masks).all():
        raise AssertionError(f"the trained checkpoint: masks {tuple(masks.shape)}")
    check = train_step_card_vs_cpu()
    step_ms, waits = np.asarray(summary["step_ms"]), np.asarray(summary["queue_wait_s"])
    log(f"train_segmenter (batch 64 at 128², both domains, corruption on, pool 48; "
        f"{' '.join(TRAIN_CUTS)}): {seconds:.3f} s; step {np.median(step_ms):.3f} ms median "
        f"(min {step_ms.min():.3f}, max {step_ms.max():.3f}; CUDA events), waiting on the "
        f"producer {waits[1:].mean() * 1e3:.3f} ms per step after the first "
        f"({waits.sum():.3f} s in all), background pool {summary['pool_seconds']:.3f} s; loss "
        f"{losses[0]:.4f} -> {losses[-10:].mean():.4f} (mean of the last 10); held-out IoU "
        f"{summary['iou']:.4f}, cross-domain {summary['cross_domain_iou']:.4f}; the checkpoint "
        f"segments 4 images, {float(masks.mean()):.3f} of the pixels person; one step card vs "
        f"CPU: loss {check['loss_err']:.3e}, parameters {check['param_err']:.3e} (all "
        f"{check['param_err_all']:.3e}); peak device memory {peak_gb:.3f} GB; launches "
        f"{launches} [{label}]")
    return dict(launches=launches, seconds=seconds, step_ms_median=float(np.median(step_ms)),
                queue_wait_ms_per_step=float(waits[1:].mean() * 1e3),
                pool_seconds=summary["pool_seconds"], iou=summary["iou"],
                cross_domain_iou=summary["cross_domain_iou"], peak_gb=peak_gb, **check)


def phase14(products: dict, star_pickle: str, obj_pickle: str, npz: str, label: str) -> dict:
    with tempfile.TemporaryDirectory(prefix="phase14_", dir=SCRATCH) as tmp:
        os.makedirs(f"{tmp}/visualize")
        return dict(evaluate=evaluate_phase(tmp, label),
                    visualize=visualize_phase(products, star_pickle, obj_pickle, npz,
                                              f"{tmp}/visualize", label),
                    train_segmenter=train_phase(tmp, label))


# ---------------------------------------------------------------------------
# Phase 15: --mesh inpainting over ranks (K3), the 2-D aggregation (K1), the
# weights-readiness check
# ---------------------------------------------------------------------------

MESH_BATCH = 2                       # phase 6's 4 images as 2 batches, one per rank
MESH_FLAGS = ("--random_weights",)   # phase 6's configuration
AGG_SAMPLES, AGG_GRID = 64, (2, 2)   # the 2-D aggregation: samples, (n_data, n_model)
COAP_CPU_ATOL, COAP_NPZ_ATOL = 1e-5, 1e-6
RANK_REPORT = "phase15_rank"


def rank_main(argv: list) -> int:
    """One rank of phase 15, in a process of its own (``python -c "import
    chip_smoke; ..." TASK ...``): ``inpaint ARGS`` runs ``cli/inpaint`` with
    ARGS, ``aggregate_2d IN DEVICE`` the 2-D aggregation of IN's samples.
    Prints one ``{"phase15_rank": ...}`` line with the rank's kernel
    launches (its counters from 0 just before the path) and wall clock."""
    from coma_tpu_torch.parallel.distributed import launch_config

    task, *args = argv
    rank = launch_config()[2]
    t0 = time.perf_counter()
    if task == "inpaint":
        from coma_tpu_torch.cli import inpaint as cli
        from coma_tpu_torch.ops import attention

        reset_kernel_counts()
        cli.main(args)
        report = dict(launches=kernel_counts(), by_source=dict(attention.source_launches))
    else:
        report = aggregate_2d_rank(*args)
    if torch.cuda.is_available():
        report["peak_device_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
    print(json.dumps({RANK_REPORT: dict(report, rank=rank,
                                        seconds=time.perf_counter() - t0)}), flush=True)
    return 0


def png_outputs(root: str) -> dict:
    base = Path(root, "results", "generation", "inpaintings")
    return {str(p.relative_to(base)): p.read_bytes() for p in sorted(base.rglob("*.png"))}


def largest_png_difference(got: dict, want: dict) -> int:
    from coma_tpu_torch.utils.png import read_png

    worst = 0
    with tempfile.TemporaryDirectory(dir=SCRATCH) as tmp:
        for name in want:
            for which, data in (("got", got[name]), ("want", want[name])):
                Path(tmp, which).write_bytes(data)
            diff = np.abs(read_png(f"{tmp}/got").astype(int) - read_png(f"{tmp}/want"))
            worst = max(worst, int(diff.max()))
    return worst


def mesh_inpaint_phase(label: str) -> dict:
    """(a) ``cli/inpaint --mesh 2`` at phase 6's configuration (full width,
    512², 50 steps, mode p, bf16) at ``--batch_size 2`` on two ranks, one
    batch each: under gloo on card 0 (torchrun's variables), and under NCCL
    with a card per rank where the machine has two (COMA_* variables).
    Against it, the one-process run at ``--batch_size 2`` in this process.
    Every PNG equal; each rank launches K3 1644 times, all on the bf16
    kernel."""
    from coma_tpu_torch.cli import inpaint as cli
    from coma_tpu_torch.ops import attention

    argv = [*MESH_FLAGS, "--device", DEVICE, "--num_img_per_combination", "2",
            "--batch_size", str(MESH_BATCH)]
    runs = [("gloo", "torchrun")] + ([("nccl", "coma")] if torch.cuda.device_count() >= 2
                                     else [])
    if len(runs) == 1:
        log(f"--mesh 2 under NCCL: skipped, {torch.cuda.device_count()} card(s) on this "
            f"machine [{label}]")
    with tempfile.TemporaryDirectory(prefix="mesh_", dir=SCRATCH) as tmp:
        one, mesh = f"{tmp}/one", f"{tmp}/mesh"
        for root in (one, mesh):
            write_inpaint_tree(root, np.random.default_rng(SEED + 2))
        reset_kernel_counts()
        cwd = os.getcwd()
        os.chdir(one)
        try:
            t0 = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            one_seconds = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        one_launches, one_by_source = kernel_counts(), dict(attention.source_launches)
        want = png_outputs(one)
        if len(want) != INPAINT_IMAGES:
            raise AssertionError(f"the one-process run wrote {len(want)} images")
        results = []
        for backend, style in runs:
            fresh_outputs(mesh)
            seconds, ranks = spawn_ranks(2, style, [
                "-c", "import sys, chip_smoke; sys.exit(chip_smoke.rank_main(sys.argv[1:]))",
                "inpaint", *argv, "--mesh", "2", "--dist_backend", backend], RANK_REPORT,
                cwd=mesh)
            check_mesh_launches(ranks, INPAINT_IMAGES // MESH_BATCH // 2)
            got = png_outputs(mesh)
            if got.keys() != want.keys():
                raise AssertionError(f"--mesh 2 ({backend}) wrote {sorted(got)}, the one-process "
                                     f"run {sorted(want)}")
            differing = [k for k in want if got[k] != want[k]]
            if differing:
                raise AssertionError(
                    f"--mesh 2 ({backend}): {len(differing)} of {len(want)} PNGs differ from the "
                    f"one-process run's, by up to {largest_png_difference(got, want)} of 255")
            log(f"--mesh 2 ({backend}, {style} variables), {INPAINT_IMAGES} images at "
                f"{INPAINT_RES}², --batch_size {MESH_BATCH}: processes {seconds:.3f} s; "
                + "; ".join(f"rank {r['rank']} {r['seconds']:.3f} s, K3 launches "
                            f"{r['launches']['flash_attention']} ({r['by_source']}), peak "
                            f"{r.get('peak_device_gb')} GB" for r in ranks)
                + f"; the one-process run {one_seconds:.3f} s, K3 launches "
                f"{one_launches['flash_attention']} ({one_by_source}); every PNG equal [{label}]")
            results.append(dict(backend=backend, seconds=seconds, ranks=ranks))
    return dict(one_seconds=one_seconds, one_launches=one_launches, runs=results)


def check_mesh_launches(ranks: list, batches_per_rank: int) -> None:
    want = K3_LAUNCHES_PER_BATCH * batches_per_rank
    for r in ranks:
        if r["launches"]["flash_attention"] != want \
                or r["by_source"]["flash_attention_sm90"] != want:
            raise AssertionError(f"--mesh rank {r['rank']}: K3 launches {r['launches']} "
                                 f"({r['by_source']}), expected {want}, all bf16")


def aggregate_2d_rank(inp: str, device: str) -> dict:
    """One rank of the 2-D aggregation: its H slice of a fresh ``quant:full``
    state, its sample shard through ``sharded_contact_aggregate_2d`` (K1 on
    the card), the slices gathered on rank 0, which holds them against a
    one-process ``contact_update_batch`` of all the samples."""
    from coma_tpu_torch.affordance.contact import contact_update_batch
    from coma_tpu_torch.parallel import distributed, sharding

    ctx = distributed.initialize("gloo", device)
    try:
        with np.load(inp) as f:
            samples = [torch.from_numpy(f[k]).to(ctx.device) for k in ("hv", "hn", "ov", "on")]
        H, O = samples[0].shape[1], samples[2].shape[1]
        grid = sharding.grid_2d(ctx, *AGG_GRID)
        state = sharding.shard_state_over_h(eval_state(ctx.device, H, O), grid.model,
                                            grid.n_model)
        distributed.sync(ctx.device)
        reset_kernel_counts()
        t0 = time.perf_counter()
        sharding.sharded_contact_aggregate_2d(state, *samples, grid)
        distributed.sync(ctx.device)
        report = dict(launches=kernel_counts(), aggregate_seconds=time.perf_counter() - t0,
                      data=grid.data, model=grid.model, rows=state.human_res,
                      allreduce_ms=ctx.allreduce_ms, allreduce_bytes=ctx.allreduce_bytes)
        full = sharding.gather_over_h(state, grid)
        if ctx.is_root:
            del state
            plain = contact_update_batch(eval_state(ctx.device, H, O), *samples)
            report["max_abs_err"] = state_err(full, plain, "the 2-D aggregation against one "
                                                           "process's plain version")
            report["used_count"] = float(full.used_count)
        return report
    finally:
        distributed.shutdown(ctx)


def aggregate_2d_phase(label: str) -> dict:
    """(b) 64 seeded samples at ``quant:full`` (H 750, O 2048, N 250, σ 0.2)
    on 4 gloo ranks on card 0 as 2 data x 2 model: each rank holds 375 rows
    of the grids (1.5 GB) and launches K1 on its 32 samples; rank 0's
    gathered state within K1's limit of the one-process plain version, a
    ``used_count`` of 64."""
    with tempfile.TemporaryDirectory(prefix="agg2d_", dir=SCRATCH) as tmp:
        samples = contact_inputs(np.random.default_rng(SEED + 15), AGG_SAMPLES, EVAL_H, EVAL_O)
        np.savez(f"{tmp}/samples.npz", **{k: v.cpu().numpy()
                                          for k, v in zip(("hv", "hn", "ov", "on"), samples)})
        del samples
        seconds, ranks = spawn_ranks(AGG_GRID[0] * AGG_GRID[1], "torchrun", [
            "-c", "import sys, chip_smoke; sys.exit(chip_smoke.rank_main(sys.argv[1:]))",
            "aggregate_2d", f"{tmp}/samples.npz", DEVICE], RANK_REPORT)
    check_aggregate_launches(ranks)
    root = ranks[0]
    if root["used_count"] != AGG_SAMPLES:
        raise AssertionError(f"the 2-D aggregation counted {root['used_count']} samples")
    log(f"2-D aggregation, {AGG_SAMPLES} samples at {EVAL_KEY} (H {EVAL_H}, O {EVAL_O}, N 250) "
        f"on {len(ranks)} gloo ranks on card 0 as {AGG_GRID[0]} data x {AGG_GRID[1]} model: "
        f"processes {seconds:.3f} s; gathered state within {root['max_abs_err']:.3e} of one "
        f"process's plain version (limit {K1_ATOL:.0e} + {K1_RTOL:.0e} |plain|), used_count "
        f"{root['used_count']:.0f}; " + "; ".join(
            f"rank {r['rank']} (data {r['data']}, model {r['model']}, {r['rows']} rows): K1 "
            f"launches {r['launches']['contact_splat']}, aggregation {r['aggregate_seconds']:.3f}"
            f" s, all-reduce {r['allreduce_ms']:.3f} ms for {r['allreduce_bytes']} bytes, peak "
            f"{r.get('peak_device_gb')} GB" for r in ranks) + f" [{label}]")
    return dict(seconds=seconds, ranks=ranks)


def check_aggregate_launches(ranks: list) -> None:
    for r in ranks:
        if r["launches"]["contact_splat"] < 1 or r["launches"]["occupancy_hits"] \
                or r["launches"]["flash_attention"]:
            raise AssertionError(f"2-D aggregation rank {r['rank']}: launches {r['launches']}")


def write_coap_ckpt(path: str, num_parts: int, seed: int) -> None:
    """A seeded COAP checkpoint in the published Lightning layout at
    ``COAPConfig()``'s widths: the state dict under ``state_dict``, its keys
    behind ``model.``, a body-model buffer beside them."""
    from coma_tpu_torch.models.coap import COAPConfig, COAPOccupancy
    from coma_tpu_torch.models.layers import init_flax_default_

    model = init_flax_default_(COAPOccupancy(COAPConfig(num_parts=num_parts)),
                               torch.Generator().manual_seed(seed))
    sd = {f"model.{k}": v for k, v in model.state_dict().items()}
    sd["model.smpl_body.v_template"] = torch.zeros(H_FULL, 3)
    torch.save({"epoch": 0, "global_step": 0, "state_dict": sd,
                "hyper_parameters": {"num_parts": num_parts}}, path)


def weights_phase(label: str) -> dict:
    """(c) A weights root of seeded stand-ins in the published layouts (a
    Lightning COAP ``.ckpt``, a VPoser snapshot, phase 4b's SMPL-X npz):
    ``cli/convert_weights --all`` reports each ``loaded`` and exits 0; the
    ``.ckpt`` through ``cli/optimize_depth.load_coap``: its occupancy on the
    card within 1e-5 of the CPU's and within 1e-6 of the same weights from a
    Flax ``.npz``. No kernel runs."""
    from argparse import Namespace

    from coma_tpu_torch.cli import convert_weights, optimize_depth
    from coma_tpu_torch.models.coap_partition import build_partition
    from coma_tpu_torch.models.flax_params import flax_tree
    from coma_tpu_torch.models.smplx import SMPLXModel
    from coma_tpu_torch.utils.checkpoint import save_params

    with tempfile.TemporaryDirectory(prefix="weights_", dir=SCRATCH) as root:
        rng = np.random.default_rng(SEED + 15)
        for d in ("coap", "vposer", "smplx"):
            os.makedirs(f"{root}/{d}")
        npz = f"{root}/smplx/SMPLX_NEUTRAL.npz"
        write_smplx_npz(npz, rng)
        body = SMPLXModel.from_npz(npz, device="cpu")
        K = build_partition(body.lbs_weights.numpy(), body.parents).num_parts
        ckpt = f"{root}/coap/coap_smplx_neutral.ckpt"
        write_coap_ckpt(ckpt, K, SEED + 15)
        write_vposer_snapshot(f"{root}/vposer/TR00_E096.pt", SEED + 15)
        reset_kernel_counts()
        t0 = time.perf_counter()
        try:
            convert_weights.main(["--all", "--weights_root", root, "--report",
                                  f"{root}/report.json"])
            code = 0
        except SystemExit as done:
            code = done.code
        seconds = time.perf_counter() - t0
        with open(f"{root}/report.json") as f:
            report = json.load(f)
        loaded = sorted(k for k, v in report.items() if v["status"] == "loaded")
        if code != 0 or loaded != ["coap_smplx_neutral", "smplx_neutral", "vposer"]:
            raise AssertionError(f"convert_weights --all: exit {code}, loaded {loaded}: "
                                 f"{ {k: v['status'] for k, v in report.items()} }")
        card, part, _ = optimize_depth.load_coap(Namespace(coap_ckpt=ckpt, smplx_model_path=npz),
                                                 torch.device(DEVICE))
        cpu = optimize_depth.load_coap(Namespace(coap_ckpt=ckpt, smplx_model_path=npz),
                                       torch.device("cpu"))[0]
        flax_npz = f"{root}/coap.npz"
        save_params(flax_tree(cpu), flax_npz)
        from_npz = optimize_depth.load_coap(Namespace(coap_ckpt=flax_npz, smplx_model_path=npz),
                                            torch.device(DEVICE))[0]
        parts = torch.from_numpy(np.float32(rng.normal(size=(K, 64, 3)) * 0.1))
        query = torch.from_numpy(np.float32(rng.normal(size=(K, 4096, 3)) * 0.1))
        inside = torch.from_numpy(np.float32(rng.uniform(size=(K, 4096)) > 0.3))
        with torch.no_grad(), NoTF32():
            want = cpu(parts, query, inside)
            on_card = [m(parts.to(DEVICE), query.to(DEVICE), inside.to(DEVICE)).cpu()
                       for m in (card, from_npz)]
        cpu_err = float((on_card[0] - want).abs().max())
        npz_err = float((on_card[0] - on_card[1]).abs().max())
        launches = kernel_counts()
        if cpu_err > COAP_CPU_ATOL or npz_err > COAP_NPZ_ATOL or any(launches.values()) \
                or not 0 < float(want.max()) <= 1:
            raise AssertionError(f"COAP from its checkpoint: card vs CPU {cpu_err:.3e} (limit "
                                 f"{COAP_CPU_ATOL}), vs the Flax npz {npz_err:.3e} (limit "
                                 f"{COAP_NPZ_ATOL}), launches {launches}")
    log(f"weights readiness: convert_weights --all {seconds:.3f} s, loaded {loaded} (the other "
        f"{len(report) - len(loaded)} entries missing), exit {code}; COAP's Lightning .ckpt "
        f"({K} parts) through load_coap: occupancy card vs CPU {cpu_err:.3e} (limit "
        f"{COAP_CPU_ATOL}, TF32 off), vs the Flax npz {npz_err:.3e} (limit {COAP_NPZ_ATOL}); "
        f"launches {launches} [{label}]")
    return dict(seconds=seconds, loaded=loaded, cpu_err=cpu_err, npz_err=npz_err,
                launches=launches)


def phase15(label: str) -> dict:
    """Phase 15: (a) ``--mesh`` inpainting, (b) the 2-D aggregation, (c) the
    weights-readiness check."""
    t0 = time.perf_counter()
    out = dict(mesh=mesh_inpaint_phase(label), aggregate_2d=aggregate_2d_phase(label),
               weights=weights_phase(label))
    log(f"phase 15: {time.perf_counter() - t0:.1f} s [{label}]")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the images coma_tpu reads through PIL: the JPEG decoder, the BEHAVE
# reader on JPEG frames, a JPEG-textured asset through stage 1 into K3
# ---------------------------------------------------------------------------

IMAGE_FIXTURES = os.path.join(REPO, "tests", "data", "images")
BEHAVE_COLOR = "behave_color_2048x1536.jpg"
BEHAVE_MASK = "behave_mask_2048x1536.jpg"
FABRIC_JPEG = "fabric_512.jpg"       # the 512² progressive texture of phase 16's chair
# the chair's back, legs, stretchers, armrests, seat trims, back slats, footrest, headrest,
# back posts, armrest posts and rear stretcher in phase 16c: arithmetic JPEG, TGA, BMP,
# TIFF-LZW, CMYK JPEG, lossy WebP with alpha, lossless WebP, DDS BC7, DDS DXT1, PSD, YCbCr
# 4:2:0 TIFF-JPEG, SGI RLE, PCX, QOI, ICO, BLP2 DXT5, Sun RLE, a damaged JPEG Pillow recovers
# (a wrong RSTn), TIFFs in CCITT Group 4 (fill order 2), Group 3 2-D, LZMA, Zstandard,
# old-style JPEG and ThunderScan, a lossless JP2, a lossy tiled J2K, a Lab PSD, a CIELab
# TIFF and a PFM, and XPM, FTEX DXT1, GBR RGBA, PIXAR, FLC, PhotoCD (stored gzipped: written
# out before the run), McIdas, FITS, XV thumbnail, IPTC/NAA and 1-bit tiled TIFF, and a
# lossless 4:2:0 AVIF, a lossless RGBA AVIF, a lossy AVIF (Pillow's defaults) and a restored
# one (speed 0 with CDEF: CDEF and loop restoration) on four studs at the seat's front, and
# two screen-content AVIFs at Pillow's defaults (a flat texture in palette mode, a decal of
# letters in intra block copy), a tune=iq AVIF (quantizer matrices) and a denoised one (film
# grain) on four studs at its back
PART_TEXTURES = ("arith_420.jpg", "tga_rgba32_rle.tga", "bmp_rgb24.bmp", "tiff_rgb_lzw.tif",
                 "cmyk_libjpeg.jpg", "chair_lossy_alpha.webp", "chair_lossless.webp",
                 "chair_bc7.dds", "chair_dxt1.dds", "chair_rle.psd", "chair_ycbcr_420.tif",
                 "chair_rle.sgi", "chair.pcx", "chair.qoi", "chair.ico", "chair_dxt5.blp",
                 "chair_rle.ras", "damaged/jpeg_resync_next.jpg", "chair_g4_fill2.tif",
                 "chair_g3_2d.tif", "chair_lzma.tif", "chair_zstd.tif", "chair_ojpeg.tif",
                 "chair_thunderscan.tif", "chair_lossless.jp2", "chair_lossy_tiles.j2k",
                 "chair_lab.psd", "chair_cielab.tif", "chair.pfm", "chair.xpm",
                 "chair_dxt1.ftc", "chair_rgba.gbr", "chair.pxr", "chair.flc", "pcd_base.pcd",
                 "chair_i16.area", "chair.fits", "chair.xv", "chair.iptc",
                 "chair_tiled_1bit.tif", "chair_lossless_420.avif", "chair_rgba.avif",
                 "chair_lossy.avif", "chair_restored.avif", "chair_flat.avif",
                 "chair_decal.avif", "chair_iq.avif", "chair_grain.avif")
# the restored part texture whose decoder counters phase 16c checks
RESTORED_PART = "chair_restored.avif"
# the screen-content part textures whose counters phase 16c checks: palette, intrabc
PALETTE_PART, INTRABC_PART = "chair_flat.avif", "chair_decal.avif"
# the part textures whose counters phase 16c checks: quantizer matrices, film grain
QM_PART, GRAIN_PART = "chair_iq.avif", "chair_grain.avif"
# the damaged 2048 x 1536 atlas whose recovery phase 16a times
DAMAGED_ATLAS = "atlas_damaged_restart_2048x1536.jpg"
# the 2048 x 1536 files whose host decode phase 16a times
TIMED_DECODES = ("atlas_rle_2048x1536.tga", "atlas_lzw_2048x1536.tif",
                 "atlas_arith_2048x1536.jpg", "atlas_smoothed_2048x1536.jpg",
                 "atlas_lossy_2048x1536.webp", "atlas_lossless_2048x1536.webp",
                 "atlas_bc7_2048x1536.dds", "atlas_dxt1_2048x1536.dds",
                 "atlas_rle_2048x1536.psd", "atlas_ycbcr_jpeg_2048x1536.tif",
                 "atlas_2048x1536.qoi", "atlas_rle_2048x1536.sgi", "atlas_zstd_2048x1536.tif",
                 "atlas_g4_2048x1536.tif", "atlas_lossless_2048x1536.jp2",
                 "atlas_lossy_2048x1536.j2k", "atlas_2048x1536.flc",
                 "atlas_gzip_2048x1536.fits", "atlas_lossless_2048x1536.avif",
                 "atlas_lossy_2048x1536.avif", "atlas_restored_2048x1536.avif",
                 "atlas_screen_2048x1536.avif", "atlas_iq_grain_2048x1536.avif")
BEHAVE_JPEG_FRAMES = 2
DECODE_REPS = 5
PHASE16_RES = 384                    # render_objects' resolution: inpaint resizes to 512²


def image_manifest() -> dict:
    """The committed fixtures' Pillow hashes, by file name (and the seeded
    step video's under ``step_video``)."""
    with open(os.path.join(IMAGE_FIXTURES, "manifest.json")) as fh:
        manifest = json.load(fh)
    return dict({e["file"]: e for e in manifest["files"]}, step_video=manifest["step_video"])


def damaged_manifest() -> dict:
    """The damaged fixtures' Pillow hashes (or refusals), by their path under
    ``IMAGE_FIXTURES`` (``damaged/<file>``; ``stored`` likewise)."""
    with open(os.path.join(IMAGE_FIXTURES, "damaged", "manifest.json")) as fh:
        files = json.load(fh)["files"]
    out = {}
    for e in files:
        e = dict(e, file="damaged/" + e["file"])
        if "stored" in e:
            e["stored"] = "damaged/" + e["stored"]
        out[e["file"]] = e
    return out


def fixture_bytes(entry: dict) -> bytes:
    """A fixture's file as Pillow read it (a ``.gz``-stored one decompressed)."""
    import gzip

    with open(os.path.join(IMAGE_FIXTURES, entry.get("stored", entry["file"])), "rb") as fh:
        data = fh.read()
    return gzip.decompress(data) if entry.get("stored", "").endswith(".gz") else data


def image_sha(image: np.ndarray) -> str:
    """SHA-256 of an array's values (a bool array as 0/1 bytes), as the
    fixture tool hashes Pillow's arrays."""
    import hashlib

    a = np.asarray(image)
    return hashlib.sha256(np.ascontiguousarray(a.astype(np.uint8) if a.dtype == bool else a)
                          .tobytes()).hexdigest()


def avif_counters(name: str) -> dict:
    """The AV1 decoder's counters of an AVIF fixture, its colour and alpha
    items summed: 8 x 8 blocks CDEF filtered, Wiener and self-guided units,
    Y and UV palette blocks, intrabc blocks and their chroma predictions,
    the (plane, transform size) pairs a quantizer matrix weighted and the
    planes film grain ran on."""
    from coma_tpu_torch.utils import avif

    with open(os.path.join(IMAGE_FIXTURES, name), "rb") as fh:
        data = fh.read()
    _, color, alpha = avif.decode_avif_planes(data, name)
    items = [color[0]] + ([alpha[0]] if alpha else [])
    out = dict(cdef_blocks=sum(i["cdef_blocks"] for i in items),
               wiener=sum(i[f"wiener_units_{p}"] for i in items for p in range(3)),
               sgrproj=sum(i[f"sgrproj_units_{p}"] for i in items for p in range(3)),
               **{k: sum(i[k] for i in items) for k in ("palette_y_blocks", "palette_uv_blocks",
                                                        "intrabc_blocks", "intrabc_chroma_blocks")})
    out["units"] = out["wiener"] + out["sgrproj"]
    out["qm_weighted"] = sum(bool(v) for i in items for k, v in i.items()
                             if k.startswith("qm_levels_"))
    out["grain_planes"] = sum(bin(i["grain_planes"]).count("1") for i in items)
    return out


def decode_phase(label: str) -> dict:
    """(a) Every fixture through ``read_image`` (the native JPEG, BCn and
    WebP decoders and codecs, which must build) against Pillow's hashes for
    modes None, RGB and L, the refused ones refused naming the file; the
    BEHAVE frame's decode timed (entropy and reconstruction, median of 5)
    beside the plain decoder's (Python entropy, numpy reconstruction), the
    Python entropy decoder on the 512² texture, and the host decode of the
    2048 x 1536 atlas as TGA, TIFF-LZW, SOF9, block-smoothed progressive JPEG,
    lossy and lossless WebP, DDS BC7 and DXT1, PSD PackBits, YCbCr
    TIFF-JPEG, QOI, SGI RLE, TIFF-Zstandard, (thresholded) TIFF CCITT
    Group 4, lossless JPEG 2000 (JP2, 5/3), lossy JPEG 2000 (J2K, 9/7,
    tiles, layers, RPCL), FLC (BRUN), FITS (a GZIP_1 table) and lossless,
    lossy, restored, screen-content and quantizer-matrix with film grain
    AVIF (4:2:0, coded-lossless and lossy AV1 through
    ``native/src/av1_decode.cpp``, the restored one with CDEF and loop
    restoration, the screen one with palettes and intra block copy, the last
    tune=iq with denoise-noise-level) (median of 5). Each restored AVIF
    fixture must show CDEF or loop restoration in the decoder's counters,
    each quantizer-matrix or film-grain fixture a weighted transform block
    or grain."""
    import statistics

    from coma_tpu_torch.native import codecs
    from coma_tpu_torch.utils import jpeg
    from coma_tpu_torch.utils.image_io import decode_image, read_image
    from coma_tpu_torch.utils.modes import to_mode

    if not (jpeg.native_available() and codecs.available() and codecs.bcn_available()
            and codecs.webp_available() and codecs.tiff_available()
            and codecs.j2k_available()):
        raise AssertionError("a native image decoder (native/src/jpeg_decode.cpp, "
                             "image_codecs.cpp, bcn_decode.cpp, webp_decode.cpp, "
                             "tiff_codecs.cpp, j2k_decode.cpp) did not build or load")
    codecs.av1_library()                 # the AV1 decoder has no fallback: raises with g++'s stderr
    manifest = image_manifest()
    equal, refused = [], []
    for name, entry in manifest.items():
        if name == "step_video":
            continue
        path = os.path.join(IMAGE_FIXTURES, name)
        if entry.get("raises"):
            try:
                read_image(path)
            except ValueError as err:
                if name not in str(err):
                    raise AssertionError(f"{name}: refused without naming the file: {err}")
                refused.append(name)
                continue
            raise AssertionError(f"{name}: decoded, but Pillow refuses it")
        if name.endswith(".jpg"):
            with open(path, "rb") as fh:
                pixels = jpeg.decode_jpeg(fh.read(), path, native=True)
            image = read_image(path)
            if not np.array_equal(pixels[..., 0] if pixels.shape[-1] == 1 else pixels, image):
                raise AssertionError(f"{name}: read_image is not the native decoder's")
        decoded = decode_image(fixture_bytes(entry), path)     # read_image's decode, once
        for mode in (None, "RGB", "L"):
            if entry["sha256"][str(mode)] is None:        # Pillow refuses "LAB" to "L"
                try:
                    to_mode(decoded, mode)
                except ValueError:
                    continue
                raise AssertionError(f"{name}: converted to {mode}, which Pillow refuses")
            if image_sha(to_mode(decoded, mode)) != entry["sha256"][str(mode)]:
                raise AssertionError(f"{name}: mode {mode} differs from Pillow's")
        equal.append(name)

    damaged_equal, damaged_refused = [], []
    damaged = damaged_manifest()
    for name, entry in damaged.items():              # the native decoders, as above
        try:
            decoded = decode_image(fixture_bytes(entry), name)
        except ValueError as err:
            if not entry.get("raises") or name not in str(err):
                raise AssertionError(f"{name}: refused ({err}), not as Pillow") from None
            damaged_refused.append(name)
            continue
        if entry.get("raises"):
            raise AssertionError(f"{name}: decoded, but Pillow refuses it")
        for mode in (None, "RGB", "L"):
            if image_sha(to_mode(decoded, mode)) != entry["sha256"][str(mode)]:
                raise AssertionError(f"{name}: mode {mode} differs from Pillow's")
        damaged_equal.append(name)
    atlas = fixture_bytes(damaged["damaged/" + DAMAGED_ATLAS])
    atlas_entropy_ms, atlas_recon_ms = [], []
    for _ in range(DECODE_REPS):
        t0 = time.perf_counter()
        atlas_frame = jpeg.decode_coefficients(atlas, DAMAGED_ATLAS, native=True)
        t1 = time.perf_counter()
        atlas_image = jpeg.reconstruct(atlas_frame, native=True)
        atlas_entropy_ms.append((t1 - t0) * 1e3)
        atlas_recon_ms.append((time.perf_counter() - t1) * 1e3)
    if image_sha(atlas_image) != damaged["damaged/" + DAMAGED_ATLAS]["sha256"]["None"]:
        raise AssertionError(f"{DAMAGED_ATLAS}: the recovered atlas differs from Pillow's")

    def coefficients_equal(a, b) -> bool:
        return all(np.array_equal(x, y) for x, y in zip(a.coef, b.coef))

    with open(os.path.join(IMAGE_FIXTURES, BEHAVE_COLOR), "rb") as fh:
        data = fh.read()
    entropy_ms, recon_ms = [], []
    for _ in range(DECODE_REPS):
        t0 = time.perf_counter()
        frame = jpeg.decode_coefficients(data, BEHAVE_COLOR, native=True)
        t1 = time.perf_counter()
        image = jpeg.reconstruct(frame, native=True)
        entropy_ms.append((t1 - t0) * 1e3)
        recon_ms.append((time.perf_counter() - t1) * 1e3)
    t0 = time.perf_counter()
    plain = jpeg.decode_coefficients(data, BEHAVE_COLOR, native=False)
    t1 = time.perf_counter()
    plain_image = jpeg.reconstruct(plain, native=False)
    plain_entropy_s, plain_recon_s = t1 - t0, time.perf_counter() - t1
    if not coefficients_equal(plain, frame) or not np.array_equal(plain_image, image):
        raise AssertionError(f"{BEHAVE_COLOR}: the plain and native decoders differ")
    with open(os.path.join(IMAGE_FIXTURES, FABRIC_JPEG), "rb") as fh:
        fabric = fh.read()
    t0 = time.perf_counter()
    fabric_plain = jpeg.decode_coefficients(fabric, FABRIC_JPEG, native=False)
    fabric_python_s = time.perf_counter() - t0
    if not coefficients_equal(fabric_plain, jpeg.decode_coefficients(fabric, FABRIC_JPEG,
                                                                     native=True)):
        raise AssertionError(f"{FABRIC_JPEG}: the plain and native entropy decoders differ")
    timed = {}
    for name in TIMED_DECODES:
        blob = fixture_bytes(manifest[name])
        ms = []
        for _ in range(DECODE_REPS):
            t0 = time.perf_counter()
            decoded = decode_image(blob, name)
            ms.append((time.perf_counter() - t0) * 1e3)
        if image_sha(decoded.pixels) != manifest[name]["sha256"]["None"]:
            raise AssertionError(f"{name}: differs from Pillow's")
        timed[name] = dict(median_ms=statistics.median(ms), all_ms=ms, bytes=len(blob))
    out = dict(equal=len(equal), refused=refused, bytes=len(data),
               entropy_ms=statistics.median(entropy_ms), reconstruct_ms=statistics.median(recon_ms),
               entropy_ms_all=entropy_ms, reconstruct_ms_all=recon_ms,
               plain_entropy_s=plain_entropy_s, plain_reconstruct_s=plain_recon_s,
               fabric_python_entropy_s=fabric_python_s, timed_decodes=timed,
               damaged_equal=len(damaged_equal), damaged_refused=damaged_refused,
               damaged_atlas_bytes=len(atlas),
               damaged_atlas_entropy_ms=statistics.median(atlas_entropy_ms),
               damaged_atlas_reconstruct_ms=statistics.median(atlas_recon_ms),
               damaged_atlas_entropy_ms_all=atlas_entropy_ms,
               damaged_atlas_reconstruct_ms_all=atlas_recon_ms)
    log(f"phase 16a: {len(equal)} fixtures through read_image (native decoders and codecs) equal "
        f"to Pillow's hashes (modes None, RGB and L), {len(refused)} refused naming the file as "
        f"Pillow refuses them; {BEHAVE_COLOR} ({len(data)} bytes), median of {DECODE_REPS} "
        f"native decodes: entropy {out['entropy_ms']:.3f} ms, reconstruction "
        f"{out['reconstruct_ms']:.3f} ms (host); the plain decoder: Python entropy "
        f"{plain_entropy_s:.3f} s, numpy reconstruction {plain_recon_s:.3f} s, equal "
        f"coefficients and pixels; Python entropy on {FABRIC_JPEG} (512², progressive) "
        f"{fabric_python_s:.3f} s [{label}]")
    log(f"phase 16a: {len(damaged_equal)} damaged fixtures equal to Pillow's hashes and "
        f"{len(damaged_refused)} refused naming the file as Pillow refuses them (native "
        f"decoders); the recovered {DAMAGED_ATLAS} ({len(atlas)} bytes), median of "
        f"{DECODE_REPS}: entropy {out['damaged_atlas_entropy_ms']:.3f} ms, reconstruction "
        f"{out['damaged_atlas_reconstruct_ms']:.3f} ms (host), beside the clean "
        f"{BEHAVE_COLOR}'s {out['entropy_ms']:.3f} and {out['reconstruct_ms']:.3f} ms [{label}]")
    avif_equal = [n for n in equal if n.endswith(".avif")]
    avif_lossy = [n for n in avif_equal if "lossy" in n]
    avif_restored = [n for n in avif_equal if "restored" in n]
    avif_screen = [n for n in avif_equal if "screen content" in manifest[n]["kind"]]
    avif_qm_grain = [n for n in avif_equal if "quantizer matrices" in manifest[n]["kind"]
                     or "film grain" in manifest[n]["kind"]]
    qm_grain = {n: avif_counters(n) for n in avif_qm_grain}
    shown = [n for n, c in qm_grain.items() if not (c["qm_weighted"] or c["grain_planes"])
             and "coded-lossless" not in manifest[n]["kind"]]
    if shown:
        raise AssertionError(f"{shown}: no block weighted by a quantizer matrix and no grain")
    restored = {n: avif_counters(n) for n in avif_restored}
    shown = [n for n, c in restored.items() if not (c["cdef_blocks"] or c["units"])]
    if shown:
        raise AssertionError(f"{shown}: no CDEF-filtered block and no restored unit")
    with_cdef = [n for n, c in restored.items() if c["cdef_blocks"]]
    with_lr = [n for n, c in restored.items() if c["units"]]
    out.update(avif_equal=len(avif_equal), avif_lossy_equal=len(avif_lossy),
               avif_restored_equal=len(avif_restored), avif_cdef=len(with_cdef),
               avif_restoration=len(with_lr), avif_restored_counters=restored,
               avif_screen_equal=len(avif_screen), avif_qm_grain_equal=len(avif_qm_grain),
               avif_qm=sum(bool(c["qm_weighted"]) for c in qm_grain.values()),
               avif_grain=sum(bool(c["grain_planes"]) for c in qm_grain.values()))
    atlas_avif = timed["atlas_lossless_2048x1536.avif"]
    lossy_avif = timed["atlas_lossy_2048x1536.avif"]
    restored_avif = timed["atlas_restored_2048x1536.avif"]
    screen_avif = timed["atlas_screen_2048x1536.avif"]
    iq_avif = timed["atlas_iq_grain_2048x1536.avif"]
    lossless_count = (len(avif_equal) - len(avif_lossy) - len(avif_restored) - len(avif_screen)
                      - len(avif_qm_grain))
    log(f"phase 16a: {len(avif_equal)} AVIF fixtures ({lossless_count} coded-lossless, "
        f"{len(avif_lossy)} lossy, {len(avif_restored)} restored, {len(avif_screen)} screen "
        f"content, {len(avif_qm_grain)} with quantizer matrices ({out['avif_qm']} weighted) or "
        f"film grain ({out['avif_grain']} grained) AV1 through "
        f"native/src/av1_decode.cpp, libyuv's conversion) equal to Pillow's hashes in modes "
        f"None, RGB and L; host decode median of {DECODE_REPS}: atlas_lossless_2048x1536.avif "
        f"({atlas_avif['bytes']} bytes) {atlas_avif['median_ms']:.3f} ms, "
        f"atlas_lossy_2048x1536.avif ({lossy_avif['bytes']} bytes, Pillow's defaults) "
        f"{lossy_avif['median_ms']:.3f} ms, atlas_restored_2048x1536.avif "
        f"({restored_avif['bytes']} bytes, speed 4 with CDEF) {restored_avif['median_ms']:.3f} "
        f"ms, atlas_screen_2048x1536.avif ({screen_avif['bytes']} bytes, palettes and intra "
        f"block copy) {screen_avif['median_ms']:.3f} ms, atlas_iq_grain_2048x1536.avif "
        f"({iq_avif['bytes']} bytes, tune=iq with denoise-noise-level: quantizer matrices and "
        f"film grain) {iq_avif['median_ms']:.3f} ms [{label}]")
    log(f"phase 16a: restored AVIF fixtures equal to Pillow's hashes: {len(with_cdef)} with "
        f"CDEF ({sum(c['cdef_blocks'] for c in restored.values())} 8x8 blocks filtered), "
        f"{len(with_lr)} with loop restoration "
        f"({sum(c['wiener'] for c in restored.values())} Wiener and "
        f"{sum(c['sgrproj'] for c in restored.values())} self-guided units) [{label}]")
    log("phase 16a: host decode of the 2048 x 1536 atlas through read_image, median of "
        f"{DECODE_REPS}: " + ", ".join(f"{n} ({t['bytes']} bytes) {t['median_ms']:.3f} ms"
                                       for n, t in timed.items()) + f" [{label}]")
    return out


def behave_jpeg_phase(label: str) -> dict:
    """(b) A BEHAVE-shaped sequence whose k0-k3 colour frames and person masks
    are the committed 2048 x 1536 JPEGs, read through ``BehaveSequence``:
    ``__getitem__`` and ``get_person_mask`` against Pillow's hashes."""
    from coma_tpu_torch.pipelines.behave_eval import BehaveSequence
    from coma_tpu_torch.utils.png import write_png

    manifest = image_manifest()
    root = tempfile.mkdtemp(prefix="behave_jpeg_", dir=SCRATCH)
    try:
        seq = f"{root}/Date03_Sub04_chairwood"
        os.makedirs(seq)
        with open(f"{seq}/info.json", "w") as fh:
            json.dump(dict(cat="chairwood", gender="male", kinects=[0, 1, 2, 3]), fh)
        for k in range(BEHAVE_JPEG_FRAMES):
            frame = f"{seq}/t{k:04d}.000"
            os.makedirs(frame)
            for kid in range(4):
                shutil.copy(os.path.join(IMAGE_FIXTURES, BEHAVE_COLOR), f"{frame}/k{kid}.color.jpg")
                shutil.copy(os.path.join(IMAGE_FIXTURES, BEHAVE_MASK),
                            f"{frame}/k{kid}.person_mask.jpg")
                write_png(f"{frame}/k{kid}.depth.png", np.zeros((576, 640), np.uint8))
        reader = BehaveSequence(seq)
        want_mask = reader.get_mask(0, 0, "person", ret_bool=False)
        if image_sha(want_mask) != manifest[BEHAVE_MASK]["sha256"]["L"]:
            raise AssertionError(f"{BEHAVE_MASK}: get_mask differs from Pillow's convert('L')")
        seconds = []
        for idx in range(len(reader)):
            t0 = time.perf_counter()
            colors, depths = reader[idx]
            masks = reader.get_person_mask(idx)
            seconds.append(time.perf_counter() - t0)
            if len(colors) != 4 or len(masks) != 4:
                raise AssertionError(f"frame {idx}: {len(colors)} colours, {len(masks)} masks")
            for c in colors:
                if image_sha(c) != manifest[BEHAVE_COLOR]["sha256"]["RGB"]:
                    raise AssertionError(f"frame {idx}: a colour frame differs from Pillow's")
            for m in masks:
                if m.dtype != np.bool_ or not np.array_equal(m, want_mask > 127):
                    raise AssertionError(f"frame {idx}: a person mask differs")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ms = [x * 1e3 for x in seconds]
    log(f"phase 16b: BehaveSequence on {len(ms)} frames of 4 kinects (2048 x 1536 JPEG colour "
        f"frames and person masks): __getitem__ + get_person_mask "
        f"{', '.join(f'{x:.3f}' for x in ms)} ms a frame (host), every image equal to "
        f"Pillow's hash [{label}]")
    return dict(frame_ms=ms)


def jpeg_asset_phase(label: str) -> dict:
    """(c) Phase 13's chair with its fabric texture the committed progressive
    JPEG, its back an arithmetic JPEG, its legs TGA, BMP, TIFF-LZW and CMYK
    JPEG textures, its stretchers and armrests lossy WebP with alpha,
    lossless WebP, DDS BC7, DDS DXT1, PSD and YCbCr TIFF-JPEG ones, its
    seat trims and back slats SGI RLE, PCX, QOI, ICO, BLP2 DXT5 and Sun RLE
    ones, its footrest a damaged JPEG Pillow recovers, its headrest,
    back posts, armrest posts and rear stretcher TIFFs in CCITT Group 4
    (fill order 2), Group 3 2-D, LZMA, Zstandard, old-style JPEG and
    ThunderScan, its low stretchers, lumbar bar and front apron a
    lossless JP2, a lossy tiled J2K, a Lab PSD, a CIELab TIFF and a PFM, and
    its seat knobs, cross bars, foot pads, back emblem and armrest pads XPM,
    FTEX DXT1, GBR RGBA, PIXAR, FLC, PhotoCD, McIdas, FITS, XV thumbnail,
    IPTC/NAA and 1-bit tiled TIFF ones, and its studs two lossless AVIFs,
    a lossy one (Pillow's defaults), a restored one (CDEF and loop
    restoration, both shown by the decoder's counters), two of screen
    content (palette blocks in one, intrabc blocks in the other, shown by
    the counters), a tune=iq one (blocks weighted by a quantizer matrix)
    and a denoised one (film grain on every plane), through
    ``cli/generate_2d_hoi_images`` at
    ``PHASE16_RES``² (so ``inpaint`` resizes to 512²) into one batch of 4 on
    K3, with phase 13's checks; every texture layer and the inpainting's
    inputs against the host's ``read_image`` and PIL's resizes."""
    from coma_tpu_torch.utils.image_io import read_image
    from coma_tpu_torch.utils.resize import resize_bicubic, resize_bilinear

    texture = os.path.join(IMAGE_FIXTURES, FABRIC_JPEG)
    manifest = dict(image_manifest(), **damaged_manifest())
    counters = avif_counters(RESTORED_PART)
    if not (counters["cdef_blocks"] and counters["units"]):
        raise AssertionError(f"{RESTORED_PART}: counters {counters}: not CDEF and restoration")
    screen = {n: avif_counters(n) for n in (PALETTE_PART, INTRABC_PART)}
    if not (screen[PALETTE_PART]["palette_y_blocks"] and screen[PALETTE_PART]["palette_uv_blocks"]
            and screen[INTRABC_PART]["intrabc_blocks"]
            and screen[INTRABC_PART]["intrabc_chroma_blocks"]):
        raise AssertionError(f"counters {screen}: {PALETTE_PART} without luma and chroma "
                             f"palettes or {INTRABC_PART} without intrabc blocks")
    qm_grain = {n: avif_counters(n) for n in (QM_PART, GRAIN_PART)}
    if not (qm_grain[QM_PART]["qm_weighted"] and qm_grain[GRAIN_PART]["grain_planes"] == 3):
        raise AssertionError(f"counters {qm_grain}: {QM_PART} with no block weighted by a "
                             f"quantizer matrix or {GRAIN_PART} without grain on every plane")
    unpacked = os.path.join(SCRATCH, "part_textures")
    os.makedirs(unpacked, exist_ok=True)
    parts = []
    for n in PART_TEXTURES:              # a gzip-stored fixture is written out as Pillow read it
        if "stored" in manifest[n]:
            with open(os.path.join(unpacked, os.path.basename(n)), "wb") as fh:
                fh.write(fixture_bytes(manifest[n]))
            parts.append(os.path.join(unpacked, os.path.basename(n)))
        else:
            parts.append(os.path.join(IMAGE_FIXTURES, n))
    parts = tuple(parts)

    def check(obj, mesh, batches):
        for k, (name, path) in enumerate(zip((FABRIC_JPEG,) + PART_TEXTURES,
                                             (texture,) + parts)):
            decoded = read_image(path, "RGB")
            if image_sha(decoded) != manifest[name]["sha256"]["RGB"]:
                raise AssertionError(f"{name}: differs from Pillow's")
            layer = resize_bilinear(decoded, mesh.textures.shape[1:3][::-1]).astype(
                np.float32) / 255
            if not np.array_equal(mesh.textures[1 + k], layer):      # in order of use
                raise AssertionError(f"the chair's layer of {name} is not the decoded texture")
        if len(batches) != 1:
            raise AssertionError(f"inpaint loaded {len(batches)} batches")
        chunk, imgs, masks = batches[0]
        root = os.path.dirname(obj)              # the CLI's paths are relative to it
        for w, img, mask in zip(chunk, imgs, masks):
            render = read_image(os.path.join(root, w["render"]), "RGB")
            if render.shape != (PHASE16_RES, PHASE16_RES, 3):
                raise AssertionError(f"{w['render']}: shape {render.shape}")
            want = resize_bicubic(render, (INPAINT_RES, INPAINT_RES)).astype(np.float32)
            want_mask = resize_bicubic(read_image(os.path.join(root, w["mask"]), "L"),
                                       (INPAINT_RES, INPAINT_RES))
            if not (np.array_equal(img.permute(1, 2, 0).numpy(), want / 127.5 - 1.0)
                    and np.array_equal(mask.numpy(), np.float32(want_mask > 127))):
                raise AssertionError(f"{w['render']}: the inpainting's inputs are not the "
                                     "host's read_image and PIL's bicubic resize")

    try:
        out = stage1_phase(label, texture=texture, res=PHASE16_RES, timings=False, check=check,
                           part_textures=parts)
    finally:
        shutil.rmtree(unpacked, ignore_errors=True)
    log(f"phase 16c: the chair textured with {FABRIC_JPEG} and {', '.join(PART_TEXTURES)} at "
        f"{PHASE16_RES}², resized to {INPAINT_RES}² for inpainting: launches {out['launches']} "
        f"({out['by_source']}); {RESTORED_PART}: {counters['cdef_blocks']} 8x8 blocks CDEF "
        f"filtered, {counters['wiener']} Wiener and {counters['sgrproj']} self-guided units; "
        f"{PALETTE_PART}: {screen[PALETTE_PART]['palette_y_blocks']} Y and "
        f"{screen[PALETTE_PART]['palette_uv_blocks']} UV palette blocks; {INTRABC_PART}: "
        f"{screen[INTRABC_PART]['intrabc_blocks']} intrabc blocks, "
        f"{screen[INTRABC_PART]['intrabc_chroma_blocks']} chroma predictions; {QM_PART}: "
        f"{qm_grain[QM_PART]['qm_weighted']} (plane, transform size) pairs weighted by a "
        f"quantizer matrix; {GRAIN_PART}: film grain on {qm_grain[GRAIN_PART]['grain_planes']} "
        f"planes; each decoded to Pillow's hash [{label}]")
    out["restored_part"] = counters
    out["screen_parts"] = screen
    out["qm_grain_parts"] = qm_grain
    return out


def step_video_seeded_phase(label: str) -> dict:
    """(d) The seeded step-video frames (``tools/make_image_fixtures.py``'s
    ``step_video_frames``) through ``utils/gif.write_gif``, read back with the
    port's GIF reader: every frame against the hash of Pillow's decoding of
    ``coma_tpu``'s PIL-written file, with its durations and loop."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_image_fixtures import step_video_frames

    from coma_tpu_torch.utils.gif import write_gif
    from coma_tpu_torch.utils.gif_reader import decode_gif_frames

    entry = image_manifest()["step_video"]
    frames = step_video_frames(*(entry[k] for k in ("frames", "height", "width", "seed")))
    path = os.path.join(SCRATCH, "seeded.steps.gif")
    t0 = time.perf_counter()
    write_gif(frames, path)
    write_s = time.perf_counter() - t0
    with open(path, "rb") as fh:
        data = fh.read()
    os.remove(path)
    t0 = time.perf_counter()
    decoded, durations, loop = decode_gif_frames(data, path)
    read_s = time.perf_counter() - t0
    if list(decoded.shape) != entry["decoded_shape"] or image_sha(decoded) != entry["sha256"] \
            or durations != entry["durations"] or loop != entry["loop"]:
        raise AssertionError(f"seeded step video: decoded {decoded.shape}, durations "
                             f"{durations[:3]}..., loop {loop}: not Pillow's decoding of "
                             "coma_tpu's GIF")
    log(f"phase 16d: the seeded step video ({frames.shape[0]} frames of {frames.shape[2]}x"
        f"{frames.shape[1]}) written as PIL writes it ({write_s:.3f} s, {len(data)} bytes) and "
        f"read back by the port's reader ({read_s:.3f} s): equal to Pillow's decoding of "
        f"coma_tpu's GIF [{label}]")
    return dict(write_s=write_s, read_s=read_s, bytes=len(data))


def phase16(label: str) -> dict:
    """Phase 16: (a) every image fixture, the damaged ones too, against
    Pillow's hashes and the host decode times, (b) the BEHAVE reader on JPEG
    frames, (c) an asset textured in forty-nine files (a damaged JPEG, a Lab
    PSD, a CIELab TIFF, a PhotoCD, TIFFs in six more compressions, a 1-bit
    tiled TIFF, two lossless AVIFs, a lossy one, a restored one, two of
    screen content, a tune=iq one and a denoised one among them) through
    stage 1 into K3,
    every
    kernel's counter from 0 before (c)'s path and read after it, (d) the
    step-video GIF as PIL writes it."""
    t0 = time.perf_counter()
    out = dict(decode=decode_phase(label), behave=behave_jpeg_phase(label),
               stage1=jpeg_asset_phase(label), step_video=step_video_seeded_phase(label))
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 16: {out['seconds']:.1f} s [{label}]")
    return out


# ---------------------------------------------------------------------------
# Phase 17: coma_tpu_torch.benchkit, the bench's entry points, on the card
# ---------------------------------------------------------------------------

BENCH_K1_SHAPES = (  # (key, H, O, samples a step): bench.py's section_coma
    ("coma_contact_aggregation_samples_per_sec", 10475, 180, 32),
    ("coma_object_contact_samples_per_sec", 1000, 1500, 16),
    ("coma_quant_full_samples_per_sec", 750, 2048, 16),
)
CHAIN_STEPS = 9          # _sustained_rate: 3 runs of a 1-step chain, 3 of a 2-step chain
BENCH_BATCH = 16         # the bench's images a batch: the CFG UNet's batch 32
K3_BENCH_SHAPES = (  # (name, B, H, Lq, Lk, D): the pipeline suite's, at batch 16
    ("bench_unet_self_64x64", 32, 8, 4096, 4096, 40),
    ("bench_unet_cross_64x64", 32, 8, 4096, 77, 40),
    ("bench_unet_self_32x32", 32, 8, 1024, 1024, 80),
    ("bench_unet_cross_32x32", 32, 8, 1024, 77, 80),
    ("bench_unet_self_16x16", 32, 8, 256, 256, 160),
    ("bench_unet_cross_16x16", 32, 8, 256, 77, 160),
    ("bench_unet_mid_self_8x8", 32, 8, 64, 64, 160),
    ("bench_unet_mid_cross_8x8", 32, 8, 64, 77, 160),
    ("bench_vae_mid", 16, 1, 4096, 4096, 512),
    ("bench_vae_mid_fast_32x32", 16, 1, 1024, 1024, 512),   # fast mode's x̂0 at 1/2
    ("bench_vae_mid_crop_40x40", 16, 1, 1600, 1600, 512),   # crop mode's bucket 40
)
# K3 launches on each emitted key's path: the warm-up's (the CFG UNet's 32,
# the VAE's full-frame encode and decode, and the provoke round's own decode
# in fast mode, decode and encode in crop mode) + 1644 a timed batch; the
# UNet step: 11 forwards of 32
SUITE_K3 = {
    "hoi_2d_images_per_sec": 34 + 2 * K3_LAUNCHES_PER_BATCH,
    "unet_cfg_step_ms": 11 * 32,
    "hoi_2d_images_per_sec_pointrend_loop": 34 + K3_LAUNCHES_PER_BATCH,
    "hoi_2d_images_per_sec_pointrend_loop_fast": 34 + K3_LAUNCHES_PER_BATCH,
    "hoi_2d_images_per_sec_fast_mode": 35 + K3_LAUNCHES_PER_BATCH,
    "hoi_2d_images_per_sec_crop_mode": 36 + K3_LAUNCHES_PER_BATCH,
}
BENCH_CROP_BUCKET = 40   # choose_crop_latent of the bench's 200-pixel person box at 512²
TINY_K3_LAUNCHES = 50 * 20 + 44   # the tiny UNet's 10 transformer blocks x 2 x 50 steps + VAE
DP_RANKS = (1, 2)
EXTRACT_BENCH_SAMPLES = 64
WARM_SPREAD = 0.05       # the headline's two timed batches: the warm-up is enough within 5%


class StderrTee:
    """Copies what is written to stderr, which still gets it."""

    def __init__(self):
        self.parts, self.stream = [], sys.stderr

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def bench_line(d: dict, label: str) -> None:
    log(f"bench {json.dumps(d)} [{label}]")


def idle_share(fn, calls: int = 1) -> dict:
    """``fn`` under ``torch.profiler`` after a warm-up call: wall ms per
    call, the device's busy ms and idle share."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                  ) / calls / 1e3
    if not busy_ms > 0:
        raise AssertionError("the profiler saw no device time")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=max(0.0, 1 - busy_ms / wall_ms))


def bench_coma_phase(label: str) -> tuple:
    """bench.py's section_coma through ``benchkit``: K1 at its three shapes,
    K2 at qual, each kernel's counter from 0 before each call."""
    from coma_tpu_torch import benchkit as bk

    out, launches = {}, {}
    for key, h, o, iters in BENCH_K1_SHAPES:
        reset_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        rate, raw = bk.bench_coma(h=h, o=o, iters=iters, device=DEVICE)
        launches[key] = kernel_counts()
        out[key] = round(rate, 3)
        if key == BENCH_K1_SHAPES[0][0]:
            out["coma_contact_chain_times_s"] = raw
        log(f"bench_coma ({h}, {o}, {bk.N}), {iters} i.i.d. samples a step: {rate:.3f} "
            f"samples/s, chains {raw}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, launches {launches[key]} [{label}]")
    reset_kernel_counts()
    rate, raw = bk.bench_occupancy(device=DEVICE)
    key = "coma_occupancy_aggregation_samples_per_sec"
    launches[key] = kernel_counts()
    out[key] = round(rate, 3)
    log(f"bench_occupancy ({bk.H}, {bk.O}, R={bk.OCC_RES}), {bk.ITERS} i.i.d. samples a step: "
        f"{rate:.3f} samples/s, chains {raw}, launches {launches[key]} [{label}]")
    for key, counts in launches.items():
        want = ({"contact_splat": 0, "occupancy_hits": CHAIN_STEPS, "flash_attention": 0}
                if key == "coma_occupancy_aggregation_samples_per_sec" else
                {"contact_splat": CHAIN_STEPS, "occupancy_hits": 0, "flash_attention": 0})
        if counts != want:
            raise AssertionError(f"{key}: launches {counts}, expected {want}")
    bench_line(out, label)
    return out, launches


def bench_suite_phase(label: str) -> tuple:
    """bench.py's section_pipe_suite through ``benchkit``: K3's counters
    from 0 before each sub-measurement, read when it is emitted."""
    from coma_tpu_torch import benchkit as bk
    from coma_tpu_torch.ops import attention

    out, launches = {}, {}

    def emit(d):
        key = next(iter(d))
        launches[key] = dict(kernel_counts(), by_source=dict(attention.source_launches))
        out.update(d)
        bench_line(d, label)
        reset_kernel_counts()

    tee = StderrTee()
    sys.stderr = tee
    try:
        reset_kernel_counts()
        bk.bench_pipe_suite(emit, device=DEVICE)
    finally:
        sys.stderr = tee.stream
    for key, want in SUITE_K3.items():
        got = launches[key]
        if got["flash_attention"] != want or got["by_source"]["flash_attention_sm90"] != want \
                or got["contact_splat"] or got["occupancy_hits"]:
            raise AssertionError(f"{key}: launches {got}, expected K3 {want}, all bf16")
    if not 0 < out["unet_step_mfu"] <= 1:
        raise AssertionError(f"unet_step_mfu {out['unet_step_mfu']} is not in (0, 1]")
    if out["crop_mode_latent_bucket"] != BENCH_CROP_BUCKET:
        raise AssertionError(f"crop bucket {out['crop_mode_latent_bucket']}, expected "
                             f"{BENCH_CROP_BUCKET}")
    batches = [json.loads(line.split("timed batches ", 1)[1].split(" s", 1)[0])
               for line in tee.text().splitlines() if "timed batches" in line]
    first, second = batches[0]
    spread = abs(first - second) / second
    log(f"warm-up of each variant: one forward of each model at its shapes; the headline's "
        f"timed batches {first:.3f} s and {second:.3f} s differ by {spread:.4f} "
        f"({'within' if spread <= WARM_SPREAD else 'beyond'} {WARM_SPREAD}: "
        f"{'kept' if spread <= WARM_SPREAD else 'a whole generate would warm better'}) "
        f"[{label}]")
    flops = bk.unet_flops(bk.unet_config(), 2 * bk.BATCH, bk.LAT)
    log(f"unet step: {flops} FLOPs (FlopCounterMode on the meta device) against coma_tpu's "
        f"fallback 677e9*2*2*16 = {677e9 * 2 * 2 * 16:.6g}: ratio "
        f"{flops / (677e9 * 2 * 2 * 16):.4f} (not gated); {out['unet_cfg_step_ms']} ms a step = "
        f"{flops / (out['unet_cfg_step_ms'] / 1e3) / 1e12:.1f} TFLOP/s, MFU "
        f"{out['unet_step_mfu']} of {bk.H100_BF16_PEAK / 1e12:.1f} TFLOP/s [{label}]")
    return out, launches, dict(batches=batches, warm_spread=spread, flops=flops)


def bench_idle_phase(label: str) -> dict:
    """The device's idle share over one CFG UNet step at batch 32 and over
    one provoke round's segmenter call on 16 images at 512², per segmenter."""
    from coma_tpu_torch import benchkit as bk

    shared = {}
    images = torch.rand(BENCH_BATCH, 3, bk.RES, bk.RES, device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(SEED))
    out = {}
    for name, kw in (("unet_segmenter", {}), ("pointrend_f32", dict(segmenter="pointrend")),
                     ("pointrend_fast", dict(segmenter="pointrend", pointrend_fast=True))):
        pipe, unet_fn, ucfg = bk._build_pipeline(shared=shared, device=DEVICE, **kw)
        if name == "unet_segmenter":
            lat = torch.zeros(2 * BENCH_BATCH, 9, bk.LAT, bk.LAT, device=DEVICE)
            t = torch.full((2 * BENCH_BATCH,), 500.0, device=DEVICE)
            ctx = torch.zeros(2 * BENCH_BATCH, 77, ucfg.cross_attention_dim, device=DEVICE)
            out["cfg_unet_step"] = idle_share(lambda: unet_fn(lat, t, ctx))
        out[name] = idle_share(lambda: pipe.segment_fn(images))
    for name, r in out.items():
        log(f"idle share, {name} (batch {BENCH_BATCH}, 512², torch.profiler): "
            f"{r['wall_ms']:.3f} ms wall a call, device busy {r['busy_ms']:.3f} ms, idle "
            f"{r['idle_share']:.4f} [{label}]")
    return out


def phase17(label: str) -> dict:
    """Phase 17: ``coma_tpu_torch.benchkit``: K3 at the bench's shapes, then
    every key of bench.py's sections coma, pipe_suite, torch_baselines,
    dp_scaling and extract_production, each kernel's counter from 0 before
    each path and read after it; the device's idle share of the suite's
    parts."""
    from coma_tpu_torch import benchkit as bk

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 17)
    k3 = []
    for name, B, H, Lq, Lk, D in K3_BENCH_SHAPES:
        r = check_k3(rng, name, B, H, Lq, Lk, D, torch.bfloat16, rows=(0, B - 1))
        k3.append(r)
        log(f"K3 {r['shape']}: max abs err {r['max_abs_err']:.3e}, least passing atol "
            f"{r['atol_used']:.3e} (limit {r['atol']:.0e} + {r['rtol']:.0e} |plain|); kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), share of bound "
            f"{r['share_of_bound']:.3f}, kernel/SDPA {r['ratio_to_sdpa']:.3f} [{label}]")
    bench, launches = bench_coma_phase(label)

    suite, suite_launches, suite_info = bench_suite_phase(label)
    bench.update(suite)
    launches.update(suite_launches)
    idle = bench_idle_phase(label)

    t1 = time.perf_counter()
    baselines = {"inpaint_torch_cpu_imgs_per_sec": bk.bench_inpaint_torch_cpu(),
                 "coma_torch_cpu_samples_per_sec": bk.bench_coma_torch_cpu()}
    bench.update(baselines)
    bench_line(baselines, label)
    log(f"the CPU baselines ({torch.get_num_threads()} threads, the full-width UNet and VAE "
        f"decoder in float32; K1's plain arithmetic at ({bk.H}, {bk.O}, {bk.N})): "
        f"{time.perf_counter() - t1:.1f} s [{label}]")

    reset_kernel_counts()
    dp = bk.bench_dp_scaling(ranks=DP_RANKS, device=DEVICE)
    bench.update(dp)
    bench_line(dp, label)
    for n, point in dp["flagship_dp_scaling"].items():
        if point["launches"] != [TINY_K3_LAUNCHES] * int(n):
            raise AssertionError(f"dp scaling at {n} ranks: K3 launches {point['launches']}, "
                                 f"expected {TINY_K3_LAUNCHES} a rank")
    launches["flagship_dp_scaling"] = {n: p["launches"] for n, p in
                                       dp["flagship_dp_scaling"].items()}

    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="bench_extract_", dir=SCRATCH) as tmp:
        rate, breakdown = bk.bench_extract_production(
            num_samples=EXTRACT_BENCH_SAMPLES, workdir=tmp, device=DEVICE,
            emit=lambda d: (bench.update(d), bench_line(d, label)))
    extract = {"extract_coma_production_samples_per_sec": round(rate, 3),
               "extract_coma_production_breakdown": breakdown}
    bench.update(extract)
    bench_line(extract, label)
    launches["extract_coma_production_samples_per_sec"] = kernel_counts()
    want = {"contact_splat": -(-EXTRACT_BENCH_SAMPLES // SLAB), "occupancy_hits": 0,
            "flash_attention": 0}
    if launches["extract_coma_production_samples_per_sec"] != want or \
            breakdown["products_saved"] != 1:
        raise AssertionError(f"bench_extract_production: launches "
                             f"{launches['extract_coma_production_samples_per_sec']}, expected "
                             f"{want}; {breakdown['products_saved']} products")
    log(f"bench_extract_production: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{label}]")

    keys = {"coma_contact_aggregation_samples_per_sec", "coma_object_contact_samples_per_sec",
            "coma_quant_full_samples_per_sec", "coma_occupancy_aggregation_samples_per_sec",
            "coma_contact_chain_times_s", *SUITE_K3, "unet_step_mfu",
            "crop_mode_latent_bucket", "inpaint_torch_cpu_imgs_per_sec",
            "coma_torch_cpu_samples_per_sec", "flagship_dp_scaling",
            "extract_coma_production_samples_per_sec", "extract_coma_production_breakdown",
            "extract_coma_aggregate_s", "extract_coma_aggregate_samples_per_sec"}
    missing = keys - set(bench)
    if missing:
        raise AssertionError(f"phase 17 did not produce {sorted(missing)}")
    seconds = time.perf_counter() - t0
    log(f"phase 17: {seconds:.1f} s [{label}]")
    return dict(bench=bench, launches=launches, k3=k3, idle=idle, seconds=seconds, **suite_info)


def glob_paths(root: str, pattern: str) -> list:
    return [str(p) for p in Path(root).glob(pattern)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "coma_tpu_torch")):
        print("chip_smoke: coma_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from coma_tpu_torch.ops import attention, build, contact_kernel, occupancy_kernel

    t_main = time.perf_counter()

    def elapsed(after: str) -> None:
        log(f"elapsed after {after}: {time.perf_counter() - t_main:.1f} s")

    # phase 1: device
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    label = card_label()
    log(f"device: {name}, count {count}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2: build, then kernels against their plain versions
    t0 = time.perf_counter()
    build.build_all()
    log(f"built {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for src in build.SOURCES:
        if build.log_path(src).exists():
            for line in build.log_path(src).read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {src}: {line.strip()}")
    log("  flash_attention_sm90 dynamic shared memory per block: " + ", ".join(
        f"D={d} {attention.shared_memory_bytes(d)} B" for d in attention.HEAD_DIMS))
    log(f"  flash_attention_sm90 compiled code: {sass_counts('flash_attention_sm90')}")
    plan_ms = time_splat_plan(K1_SHAPES[0][4])
    log(f"K1 splat plan, 250-point grid, host: {plan_ms[0]:.3f} ms on the first call in the "
        f"process (fit, check, partition), {plan_ms[1]:.3f} ms on a second")
    rng = np.random.default_rng(SEED)
    k1 = []
    for shape in K1_SHAPES:
        r = check_k1(rng, *shape, products=shape[0] == "qual")
        k1.append(r)
        log(f"K1 {r['shape']}: {r['route']} route, max abs err {r['max_abs_err']:.3e}, "
            f"max rel err {r['max_rel_err']:.3e}; mask keeps {r['mask_keep_share']:.4f} of the "
            f"(h, o, sample, direction, patch) groups; kernel {r['ms']:.3f} ms (the wrapper's "
            f"call {r['call_ms']:.3f} ms, {r['device_ops_per_call']:.0f} device operations), "
            f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
            f"share of bound {r['bound_ms'] / r['ms']:.3f} [{label}]")
        if r["contact_map_err"] is not None:
            log(f"K1 {r['shape']}: kernel vs plain state, contact map max diff "
                f"{r['contact_map_err']:.3e} of its maximum (limit 1e-4), orientation score "
                f"max diff {r['orientation_err']:.3e} (limit 1e-3)")
    k2_iid = check_k2(rng)
    log_k2(k2_iid, label)

    elapsed("phase 2")

    # phase 3: K2 on the extraction's posed samples, then the extraction
    # through the CLI with the launch counters from 0
    os.makedirs(SCRATCH, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="tree_", dir=SCRATCH) as tmp:
        paths = write_tree(tmp, np.random.default_rng(SEED + 1))
        k2 = k2_slab(*posed_slab(paths, "qual:backpack_occupancy"),
                     "the extraction's first 32 posed samples")
        log_k2(k2, label)
        contact_kernel.launches = 0
        occupancy_kernel.launches = 0
        single = {key: dict(zip(("path", "seconds"), extract(paths, key, label)))
                  for key in ("qual:backpack_human_contact", "qual:backpack_occupancy")}
        launches = {"contact_splat": contact_kernel.launches,
                    "occupancy_hits": occupancy_kernel.launches}
        if not all(launches.values()):
            raise AssertionError(f"a kernel of the path never launched: {launches}")
        log(f"launches on the extraction path: {launches}")

        # phase 4: inference for all four products (three kept for phase 14)
        products = check_products(paths, single["qual:backpack_human_contact"]["path"],
                                  single["qual:backpack_occupancy"]["path"], f"{tmp}/output")
        viz_keep = tempfile.mkdtemp(prefix="visualize_", dir=SCRATCH)
        for k, path in products.items():
            products[k] = shutil.copy(path, viz_keep)

        elapsed("phases 3 and 4")
        # phase 4b: learn_coma through the CLI (K1/K2 counters from 0), then
        # phase 3's extractions on two ranks against phase 3's pickles
        keep = tempfile.mkdtemp(prefix="optimize_", dir=SCRATCH)   # phase 7's inputs
        with tempfile.TemporaryDirectory(prefix="learn_", dir=SCRATCH) as learn_tmp:
            write_learn_tree(learn_tmp, np.random.default_rng(SEED + 3))
            learned = learn_coma(learn_tmp, label)
            opt_files = optimize_inputs(learn_tmp, keep)
            star_pickle = shutil.copy(f"{learn_tmp}/constants/mesh/smplx_star.pickle", viz_keep)
        for run in single.values():
            run["single_path"] = run["path"] + ".one_rank"
            os.replace(run["path"], run["single_path"])
        ranked = extractions_on_two_ranks(paths, single, label)
        per_rank = {kernel: [dict(backend=r["backend"], key=r["key"], rank=rank["rank"],
                                  launches=rank["launches"][kernel])
                             for r in ranked for rank in r["ranks"]]
                    for kernel in ("contact_splat", "occupancy_hits", "flash_attention")}

    elapsed("phase 4b")

    # phase 5: K3 against its plain version, at phase 6's, 6b's and 6c's shapes
    c = crop_bucket()
    k3 = []
    for shape in K3_SHAPES + ((f"vae_mid_crop_{c}x{c}", INPAINT_IMAGES, 1, c * c, c * c, 512,
                               torch.bfloat16),):
        r = check_k3(rng, *shape)
        k3.append(r)
        log(f"K3 {r['shape']}: max abs err {r['max_abs_err']:.3e}, least passing atol "
            f"{r['atol_used']:.3e} (limit {r['atol']:.0e} + {r['rtol']:.0e} |plain|); "
            f"kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of bound "
            f"{r['share_of_bound']:.3f}, kernel/SDPA {r['ratio_to_sdpa']:.3f} [{label}]")
    # phase 5, float32: SD-1's shapes and the tiny loop's
    k3_f32 = []
    for shape in K3_F32_SHAPES + tuple(tiny_k3_shapes()):
        r = check_k3(rng, *shape[:6], torch.float32, rows=shape[6])
        k3_f32.append(r)
        log_k3_f32(r, label)

    elapsed("phase 5")

    # phase 6: inpainting through the CLI, the K3 counter from 0; then the
    # tiny loop on the card against the CPU
    with tempfile.TemporaryDirectory(prefix="inpaint_", dir=SCRATCH) as tmp:
        write_inpaint_tree(tmp, np.random.default_rng(SEED + 2))
        attention.launches = 0
        for src in attention.source_launches:
            attention.source_launches[src] = 0
        inpaint_seconds = inpaint(tmp, label)[0]
        launches["flash_attention"] = attention.launches
        by_source = dict(attention.source_launches)
        phase6_images = tempfile.mkdtemp(prefix="phase6_images_", dir=SCRATCH)  # phase 10's
        shutil.copytree(f"{tmp}/results/generation/inpaintings", phase6_images,
                        dirs_exist_ok=True)
    log(f"launches on the inpainting path: flash_attention {launches['flash_attention']} "
        f"({by_source})")
    if launches["flash_attention"] != K3_LAUNCHES_PER_BATCH \
            or by_source["flash_attention_sm90"] != K3_LAUNCHES_PER_BATCH:
        raise AssertionError(f"flash_attention launched {launches['flash_attention']} times "
                             f"({by_source}), expected {K3_LAUNCHES_PER_BATCH}, all bf16")
    tiny_launches = tiny_loop_against_cpu()[1]

    elapsed("phase 6")
    # phase 6b: SD-2-inpainting from a diffusers directory; phase 6c: the crop
    sd2 = inpaint_sd2(label)
    cropped = inpaint_cropped(label, inpaint_seconds)
    elapsed("phases 6b and 6c")

    # phases 8, 9 and 11 on phase 6's tree (its seed), phase 10 on phase 6's images
    with tempfile.TemporaryDirectory(prefix="segmenters_", dir=SCRATCH) as tmp:
        write_inpaint_tree(tmp, np.random.default_rng(SEED + 2))
        sam_runs = sam_phase(tmp, label, inpaint_seconds)
        pointrend_runs = pointrend_phase(tmp, label, inpaint_seconds)
        segment_human_phase(phase6_images, label)
        video_run = step_video_phase(tmp, label, inpaint_seconds)

    elapsed("phases 8 to 11")
    # phase 13: stage 1 end to end, every kernel's counter from 0
    stage1 = stage1_phase(label)
    elapsed("phase 13")

    try:
        # phase 7: the HOI-reconstruction application
        optimized = optimize_phase(opt_files, label)
        elapsed("phase 7")
        # phase 12: stage 2 on phase 6's images and phase 4b's npz, every
        # kernel's counter from 0
        stage2 = stage2_phase(phase6_images, opt_files["npz"], label)
        elapsed("phase 12")
        # phase 14: evaluation, visualize and train_segmenter, every
        # kernel's counter from 0 before each
        item14 = phase14(products, star_pickle, opt_files["obj"], opt_files["npz"], label)
        elapsed("phase 14")
        # phase 15: --mesh inpainting, the 2-D aggregation, the weights' readiness
        p15 = phase15(label)
        elapsed("phase 15")
        # phase 16: every image format read through PIL, a many-format asset into K3, the GIF
        p16 = phase16(label)
        elapsed("phase 16")
        # phase 17: coma_tpu_torch.benchkit, every kernel's counter from 0 before each path
        p17 = phase17(label)
        elapsed("phase 17")
    finally:
        shutil.rmtree(keep, ignore_errors=True)
        shutil.rmtree(phase6_images, ignore_errors=True)
        shutil.rmtree(viz_keep, ignore_errors=True)
    app_launches = {k: [r["launches"][k] for r in optimized["runs"].values()]
                    for k in ("contact_splat", "occupancy_hits", "flash_attention")}

    def item14_launches(kernel: str) -> dict:
        return {f"launches_{part}": item14[part]["launches"][kernel]
                for part in ("evaluate", "visualize", "train_segmenter")}

    def phase15_launches(kernel: str) -> dict:
        """Per rank for --mesh (each run) and the 2-D aggregation; the
        weights' check."""
        return dict(
            launches_mesh_inpaint=[r["launches"][kernel] for run in p15["mesh"]["runs"]
                                   for r in run["ranks"]],
            launches_aggregate_2d=[r["launches"][kernel] for r in p15["aggregate_2d"]["ranks"]],
            launches_weights=p15["weights"]["launches"][kernel])

    def bench_launches(kernel: str) -> dict:
        """Phase 17's launches of ``kernel`` on each emitted key's path."""
        out = {key: counts[kernel] for key, counts in p17["launches"].items()
               if key != "flagship_dp_scaling"}
        if kernel == "flash_attention":
            out["flagship_dp_scaling"] = p17["launches"]["flagship_dp_scaling"]
        return out

    k1_main = k1[0]
    kernels = [
        dict(name="contact_splat", route="cuda", source="coma_tpu_torch/csrc/contact_splat.cu",
             replaces="coma_tpu/ops/contact_kernel.py:405",
             launches=launches["contact_splat"],
             max_abs_err=max(r["max_abs_err"] for r in k1),
             max_rel_err=max(r["max_rel_err"] for r in k1),
             ms=k1_main["ms"], plain_ms=k1_main["plain_ms"], bound_ms=k1_main["bound_ms"],
             bound_by=k1_main["bound_by"], library_ms=None, shape=k1_main["shape"], shapes=k1,
             launches_learn_coma=learned["launches"]["contact_splat"],
             launches_per_rank=per_rank["contact_splat"],
             launches_optimize=app_launches["contact_splat"],
             launches_stage2=stage2["launches"]["contact_splat"],
             launches_stage1=stage1["launches"]["contact_splat"],
             **item14_launches("contact_splat"), **phase15_launches("contact_splat"),
             launches_phase16=p16["stage1"]["launches"]["contact_splat"],
             launches_bench=bench_launches("contact_splat")),
        dict(name="occupancy_hits", route="cuda", source="coma_tpu_torch/csrc/occupancy_hits.cu",
             replaces="coma_tpu/ops/occupancy_kernel.py:77",
             launches=launches["occupancy_hits"], max_abs_err=k2_iid["max_abs_err"],
             differing_cells=k2["differing_cells"] + k2_iid["differing_cells"], ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"], bound_by=k2["bound_by"],
             library_ms=None, dense_bound_ms=k2["dense_bound_ms"], kept_share=k2["kept_share"],
             touched_share=k2["touched_share"], shape=k2["shape"], shapes=[k2, k2_iid],
             launches_learn_coma=learned["launches"]["occupancy_hits"],
             launches_per_rank=per_rank["occupancy_hits"],
             launches_optimize=app_launches["occupancy_hits"],
             launches_stage2=stage2["launches"]["occupancy_hits"],
             launches_stage1=stage1["launches"]["occupancy_hits"],
             **item14_launches("occupancy_hits"), **phase15_launches("occupancy_hits"),
             launches_phase16=p16["stage1"]["launches"]["occupancy_hits"],
             launches_bench=bench_launches("occupancy_hits")),
        dict(name="flash_attention", route="cuda",
             source="coma_tpu_torch/csrc/flash_attention_sm90.cu",
             replaces="coma_tpu/ops/attention.py:41",
             launches=launches["flash_attention"],
             max_abs_err=max(r["max_abs_err"] for r in k3 + k3_f32 + p17["k3"]),
             ms=k3[0]["ms"], plain_ms=k3[0]["plain_ms"], bound_ms=k3[0]["bound_ms"],
             bound_by=k3[0]["bound_by"], library_ms=k3[0]["library_ms"], shape=k3[0]["shape"],
             f32={key: k3_f32[0][key] for key in (
                 "shape", "source", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms", "sdpa_backend", "block_rows", "dynamic_smem_bytes",
                 "blocks_per_sm")},
             launches_tiny_loop=tiny_launches,
             launches_by_source=by_source, shapes=k3, shapes_f32=k3_f32,
             launches_learn_coma=learned["launches"]["flash_attention"],
             launches_per_rank=per_rank["flash_attention"],
             launches_sd2_weights_dir=sd2["launches"],
             launches_sd2_by_head_dim=sd2["launches_by_head_dim"],
             launches_provoke_crop=cropped["launches"],
             launches_provoke_crop_shape=cropped["crop_shape_launches"],
             launches_sam_modes={m: r["launches"] for m, r in sam_runs.items()
                                 if "launches" in r},
             launches_pointrend={m: r["launches"] for m, r in pointrend_runs.items()
                                 if "launches" in r},
             launches_step_video=video_run["launches"],
             launches_optimize=app_launches["flash_attention"],
             launches_stage2=stage2["launches"]["flash_attention"],
             launches_stage1=stage1["launches"]["flash_attention"],
             launches_stage1_by_source=stage1["by_source"],
             **item14_launches("flash_attention"), **phase15_launches("flash_attention"),
             launches_phase16=p16["stage1"]["launches"]["flash_attention"],
             launches_bench=bench_launches("flash_attention"), shapes_bench=p17["k3"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(label)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
