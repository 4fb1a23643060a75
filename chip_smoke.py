#!/usr/bin/env python3
"""On-card check of the PyTorch port (`ov3det_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `ov3det_torch/csrc/` (one nvcc per source, all
at once), then:
  1. prints the card's name and power limit, the build time, each kernel's
     registers and shared memory (ptxas) and, from `cuobjdump -sass`, that the
     wgmma kernels (forward, dq, dk/dv, each with and without the radius)
     hold HGMMA and LDGSTS (cp.async) and no HMMA, that the trunk conv's
     wgmma kernels hold IGMMA and LDGSTS and no IMMA, with no spill, no
     stack frame and no ptxas advisory that it serialised their wgmma, and
     that the tile ball-group kernels the route launches (the forward at
     both tiles of centers, the pick pass) hold no FFMA;
  2. holds each kernel against its plain PyTorch version on the card at the
     shapes the main paths give it, and times kernel, plain version and,
     where one exists, a PyTorch call as a yardstick:
       FPS 8 x 20000 -> 2048 and 8 x 2048 -> 128, and a ragged 8 x 20001 ->
       64: the indices of the cluster design equal the plain version's and
       those of the first design (`_impl="first"`); both designs timed in
       turns (the cluster design must not be the slower); the cluster size
       and CTAs of each launch; the chain alone (the step's reductions,
       exchange and wait on no points), a measurement of the design printed
       beside the operations and bytes bound and never in its place;
       ball-group 8 x 20000, M = 2048, K = 64, C = 0 and C = 3, and at a
       ragged N (20 001) and a ragged M (2047): the tile design's output
       equals the plain version's and the first design's bit for bit on two
       launches, both designs timed in turns (replays of a CUDA graph of
       the calls, so that the host's launch rate does not enter the kernel
       time), with the distance tests the data needs and the bound beside
       them;
       attention BH = 32, N = 2048, D = 64 (the encoder of the training
       step): the dropout mask read back through the forward, dq and dk/dv
       kernels, in both designs, equals the plain hash exactly; forward, dq
       and dk/dv in bf16, with dropout 0.1 and without, within 2e-2 of the
       largest value of the plain version in f32 (LSE within 1e-3); the f32
       variants within 1e-4 of it.  The three kernels run their wgmma
       design at these shapes; their first (mma.sync) design, reached
       through the wrappers' `_impl="mma"`, must agree with it within the
       same tolerance and is timed in turns beside it (the wgmma design
       must be the faster), and is held against the plain version at
       N = 192, a shape it still serves.  Each time stands beside the plain
       version's, SDPA's without dropout and with the kernel's rate, and a
       bound: the largest of bytes, tensor operations, one exponential a
       score and, with dropout, the hash's integer operations;
  3. serves 3 requests of 8 synthetic scenes x 20 000 points through
     `Detector` at the full width of `sunrgbd_quick()` (seeded random
     weights), each request one CUDA-graph replay of the forward and the
     parse: each must launch FPS twice, the ball-group once, the attention
     forward 3 times, the NMS kernel and the empty-box test once and no
     backward kernel; the same requests eagerly from the same detector give
     the same detections bit for bit (phase 15), both timed; the stages of a
     request and the memory its parse takes, each beside the former
     empty-box test's (a batched matmul) from an earlier run; and one
     graphed request is profiled;
  4. runs one scene at f32 on the card and on the CPU (plain versions) with
     the same weights: query indices equal, box corners within 1e-3;
  5. trains: `build_training(sunrgbd_quick(), ...)` on the card takes one
     warm-up step and 5 timed steps on seeded synthetic batches (8 scenes x
     20 000 points, dropout as configured); each step must launch FPS twice,
     the ball-group once and each attention kernel 3 times, and give a
     finite loss and gradient norm.  Then a synchronised split of a step
     into forward, criterion, backward and optimiser, one step under
     torch.profiler (with the device ms, the kernel count and the largest
     kernels of each of the step's profiler ranges: forward, criterion,
     backward, optimizer, and the device ms and kernels by module class:
     LayerNorm with its add & norm, the GenericMLP's BatchNorm, ReLU and
     dropout, Dense, attention, the set abstraction, the transformer's
     dropout and the rest, `module_times`), and the peak device memory of a
     step;
  6. takes one training step at f32 with every dropout at 0 on one scene at
     full width, on the card and on the CPU from the same weights: matched
     masks equal, every loss within 1e-4 relative, grad_norm within 1e-3;
     then (`check_bn_relu`) the set abstraction's shared MLP on one eager
     step's own Dense outputs and incoming gradients (`record_sa`, every
     width), of the bf16 step and of its f32 twin (dropout 0):
     `bn_stats` within 1e-5 of the largest value of f64 sums, sums
     and means; given the module's batch statistics and the running ones,
     `bn_relu_apply` equal to its plain version (y's dtype at a hidden
     width, the f32 max-pool), `bn_relu_grad_sums` within 1e-4 (q = grad /
     ties equal), `bn_relu_grad_apply` within one bf16 ulp or 1e-3 of the
     largest value (bf16) or 1e-4 (f32), every kernel's two launches equal;
     the whole Function against the module chain's autograd (output, dy,
     dweight, dbias, the running statistics; the f32 step's gradients
     against the expression's VJP in f64, which the module's f32 autograd
     misses by up to 6e-3 of the largest value, leaving out the units
     whose maximum an ulp of the statistics moves, at most 1e-4 of them);
     all slots of a unit tied and
     NaN in y through the same gates; each kernel, its plain version, its
     library call (`torch.batch_norm_stats`,
     `torch.batch_norm_backward_reduce`), the kernels' and the module's
     forward and forward + backward, and the pairs' library yardstick
     (`F.batch_norm` + ReLU, `native_batch_norm_backward`) timed in turns
     by graph replays beside the bound of the width's bytes.  A training
     step launches each of the four kernels once a width (3 a SA module),
     a request the apply pass alone; the first-K requests of phase 11 hold
     their own eval-mode widths (slot axis 2) the same way;
     then (`check_add_norm`) the transformer's add & norm on the same
     step's own inputs (`record_add_norm`: the 38 norms of a step, 14 of
     them behind the attention's residual and its dropout, with their
     incoming gradients), of the bf16 step and its f32 twin: `add_norm`
     two launches equal, x_new equal to its plain version bit for bit (and
     to the CPU's, flax's dropout division on both devices), y within 1e-5
     of the largest value of the expression in f64 (or twice the plain
     version's own error), `add_norm_grad` (one kernel a launch) two
     launches equal, dx, dweight and dbias within 1e-4 of the largest value
     of the f64 VJP, dbranch equal to autograd's order on the kernel's dx
     bit for bit on the card and on the CPU, the Function (`AddNorm`) equal
     to the wrappers' launches bit for bit;
     crafted inputs through the same gates (NaN and infinities, constant
     rows whose variance clamps, a bf16 x, widths 8 and 768, x off a
     16-byte boundary) and what the kernels refuse raising; the dropout
     (`dropped`, bf16 and f32, forward and VJP) on the card equal to the
     CPU's bit for bit; the backward (one cooperative launch) in eager calls
     and graph replays in turns, the same bits;
     each distinct
     norm, its plain version and the library pair (the add and
     `F.layer_norm`; `native_layer_norm_backward`) timed in turns by graph
     replays beside the bound of its bytes.  A step launches each kernel
     once a norm, a request the forward alone (38 each; the requests of
     phases 3 and 7 hold their eval-mode norms the same way, and phase 11
     the text tower's at width 640);
  7. the masked-encoder ScanNet config (3DETR-m: `scannet_quick()` with
     `EncoderConfig(kind="masked", dropout=0.3)` and the matcher and loss
     weights of reference scripts/scannet_masked_ep1080.sh), at full width
     and depth on 8 scenes x 40 000 points:
       kernels: FPS 40000 -> 2048 -> 1024 -> 256 and a ragged 40001 -> 64,
       checked, timed and bounded as in 2; the
       ball-group at 40 000 points (C = 0) and at the interim SA's shapes
       (2048 tokens, 1024 centers, K = 32, C = 256), as in 2; the picks and
       inverse map of its feature gradient in one launch (`sources_map`,
       `feature_sources_map`): the sources equal to the plain version at
       every position and the list and work records to the plain inverse
       map on two launches, the first design's pick pass (`slot_sources(...,
       _impl="first")`) equal too, and on a scene where the direct and the
       expanded distances split at r^2 (it must give the expanded pick, the
       forward the direct one), timed in turns with the first pick pass and
       `feature_map` (it must be the faster in every turn); the sum
       (`feature_sum`) and the scatter on any sources (`feature_map` then
       `feature_sum`, counted in `feature_scatter`) equal to `_scatter`
       (the accumulating `index_put_`) bit for bit on the step's own
       sources on two launches, the scatter on crafted ones too (a point
       every slot of a ball names, empty balls, points no slot names, a
       scene on one point, K 1 at N 2047 and C 40, C 4, 65536 slots a
       scene), the whole gradient on the card equal to the CPU's and to the
       first route's bit for bit, the slots-a-point distribution printed,
       the sum, `index_put_`'s path and `index_add_` timed in turns beside
       the bound, the gradient by both routes in turns (the fused route
       must be the faster in every turn) and with the plain pick pass; the
       attention kernels with
       the radius bias at the three (N, r^2) of the encoder's layers, with
       token coordinates from the FPS picks above: the radius mask read
       back through the forward, dq and dk/dv kernels, in both designs,
       equals the plain version's bit for bit, bf16 within 2e-2 and f32
       within 1e-4 of the plain version (dropout 0 and 0.3), the two designs
       of the three kernels agreeing, each timed beside the first design
       (which must not be the faster at any layer), its plain
       version and `scaled_dot_product_attention` with the boolean mask
       (without dropout and with 0.3); the share of 64 x 64 and 128 x 128
       (q, k) tiles with no in-radius pair is printed;
       serving: 3 graphed requests, each launching FPS 3 times, the
       ball-group twice, the radius forward 3 times, NMS and the empty-box
       test once and no backward kernel, equal to the eager ones bit for bit
       (phase 15), with the stages and the parse's memory as in 3;
       training: one warm-up and 3 timed steps, each launching FPS 3 times,
       the ball-group twice, its pick pass and its scatter once and each
       radius kernel 3 times, with the stage
       split, peak memory and one profiled step; then one f32 step with
       every dropout at 0 on one scene, card against CPU, as in 6, and the
       shared MLP's check of 6 on both SA modules (the pre-encoder and the
       interim SA: 6 widths), and the add & norm's check of 6 (the encoder
       at 2048 tokens, then 1024);
  8. the training CLI: `ov3det_torch.main.main(argv)` in this process on a
     fresh directory, `--dataset_name synthetic` at the full width of
     `scannet_quick()` (3 x 256 vanilla encoder, 8 x 256 decoder, 256
     queries, 18 classes, 1 angle bin, 8 scenes x 40 000 points, bf16) with
     the matcher and loss flags of scripts/scannet_quick.sh: 2 epochs of 8
     steps, an eval of the 16 test scenes (2 batches) after each and at the
     end, with the loss; it must save `checkpoint`, `checkpoint_best` and a
     `final_eval.txt` holding mAP0.25; a second call on the directory must
     return at the final-eval guard; `--test_only` on `checkpoint_best` must
     print the AP table of the epoch that saved it, digit for digit.  Every
     training step must launch FPS twice, the ball-group once and each
     attention kernel 3 times, every eval batch FPS twice, the ball-group
     once and the attention forward 3 times (read around each call alone),
     and every parse of the AP calculator NMS once and the empty-box test
     once in an eval pass, never in the train-time AP (the probe gates each
     parse of every CLI run of phases 8 and 10-14).
     Printed: wall time per epoch, the host-clock iteration time (median and
     spread), the loop's wait on the loader, each eval pass split into
     forward, parse (NMS) and the host AP, checkpoint save and restore times
     and sizes, and the peak device memory; then the host AP with the C++
     rotated IoU and with the numpy one, in turns, on the `--test_only` pass
     and on 16 scenes of detections near the GT boxes;
  9. (after 16) prints the kernels line (launches summed over the serving
     and training runs of both configs, the CLI's run, phase 10's OV
     training and OV CLI runs, phase 11's runs, phase 12's, phase 13's and
     phase 14's CLI runs and phase 16's runs), the card line, and last
     {"ok": true, "device": {...}}.
 10. the open-vocabulary step ("OV sunrgbd_quick": `sunrgbd_quick()` with
     the 2D-alignment loss at weight 1, as bench.py:518-530 builds it, and
     the frozen RegionCLIP RN50x4 teacher in int8 at its defaults, seeded
     weights, 8 `SyntheticOVDataset` scenes x 20 000 points with 530 x 730
     uint8 canvases, 1024 regions a step):
       the whole teacher on one canvas and 8 boxes, card against CPU from
       the same weights: f32 within 1e-3 of the largest value; int8
       (quantised and calibrated on the card) cosine >= 0.999 per region
       and within INT8_CARD_VS_CPU of the largest value, beside the bf16
       teacher's distance from the int8 one; the fused int8 teacher (the
       `quant_conv` chain) equal to the unfused module path on the card
       bit for bit;
       the trunk's kernels at every distinct conv of one int8 teacher
       forward on an OV batch (8 canvases x 128 boxes: 141 `quant_conv`
       calls in 27 shapes and epilogues, 18 `pool_quantize` passes in 9),
       on the activations that forward gives them: each equal to its plain
       version bit for bit, the conv in both designs (the routed one, wgmma
       for C_in a multiple of 16, and the first) in its own epilogue, the
       full one (also with NaN and infinities in the residual: a NaN's code
       0) and the dequant-only f32 one (and at 15 rows on a 3 x 5
       image, C_in 40 and 48), the full one also against the CPU at the
       3 x 3 convs of at most CPU_CHECK_MACS products; the routed kernel,
       the first design, `_int_mm` alone, the plain version and cuDNN's
       bf16 conv timed in turns (graph replays) beside the int8 bound, per
       shape, per class and summed over a forward; the pass in both designs
       (the routed `pool_quantize_vec` and the first, `_impl="first"`) equal
       to the plain version bit for bit at its 9 shapes and at odd ones (an
       odd H or W at pool 2, C 8 short of a multiple of 16, one and two
       scales, f32, quotients on half-integers, NaN and infinities: a NaN's
       code 0), both designs, the plain
       version and `F.avg_pool2d` alone timed in turns beside the bound;
       the input end on that forward's own inputs (`check_teacher_input`):
       one `normalise` and one folded pass (`pool_quantize` with the stem's
       bn1 and ReLU) a forward, each equal to its plain version bit for bit
       (the normalisation on the uint8 canvases, as f32, with NaN,
       infinities and -0, into f32, off a 16-byte boundary, past the last
       whole piece; the folded pass on conv1's output at one and two
       scales, as f32, with NaN, infinities and -0, on half-integer
       quotients, at C 8 and on pieces of 8 values), each timed in turns
       with its plain version and the library chain the forward ran
       before, beside the bound;
       the RoI head's kernels at the 4 chunks of that forward, on the
       arguments it gives them, in bf16 and in f32, `roi_align` and
       `pool_attend` in both designs (the routed one and the first,
       `_impl="first"`): `roi_align` equal to `roi_align_plain` and
       `pool_tokens` to its plain version bit for bit, `pool_attend` within
       1 bf16 ulp of its plain version (f32: 1e-5 of the largest value),
       each second launch equal to the first; RoIAlign also on crafted
       boxes (taps clipped at every border, a width clamped to 1e-6, an
       inverted box, the canvas edge, NaN and infinite coordinates), batched
       and by image index; each kernel, the first designs, its plain version
       and its yardstick (`roi_align_einsum`, the two contractions;
       `torch.mean`; SDPA on the concatenated tokens) timed in turns by
       graph replays beside the bound; the clusters of `pool_attend` the
       card holds at once;
       the teacher's forward alone on that batch, fused int8 (and with
       every conv on the first design, and with the einsum RoI head: the
       module-level names swapped), unfused int8 and bf16, in turns; one
       forward with the kernels and one with the einsum RoI head profiled,
       with the device ms of its ranges (normalise, stem conv1, trunk,
       roi_align, res5, attnpool) and its peak memory; the teacher build's
       calibration forward launching each RoI-head kernel once;
       training: `build_training(..., teacher=)` with the teacher of
       `ov3det_torch.main.build_teacher`, one warm-up and 3 timed steps,
       each launching FPS twice, the ball-group once, each attention
       kernel 3 times, `quant_conv` 141 times, `pool_quantize` 17 times,
       its folded pass and `normalise` once and `roi_align`, `pool_tokens`
       and `pool_attend` 4 times each (and
       `torch._int_mm` never, on any path), with a finite loss and
       loss_2dalignment > 0; the
       stage split (forward, teacher, criterion, backward, optimiser), peak
       memory, one profiled step (with the device time and kernels of the
       teacher's range and of its parts' ranges, and the host's waits for
       the card), the lines that make the
       host wait in one step (CUDA's sync debug mode) and the bytes of one
       batch crossing to the card;
       the CLI: `main(argv)` with --use_image, --loss_2dalignment_weight 1
       and the flags of scripts/sunrgbd_quick.sh at full width (8 x 20 000
       points, bf16), one epoch of 8 steps and its evals: every step and
       eval batch launching as above, and a checkpoint holding the detector
       and its optimiser only, the keys, shapes and size of a point-only
       run's.
 11. the pseudo-label round at `scannet_quick()`'s width (the CLI's flags of
     scripts/scannet_quick.sh, bf16, batch 8) on a ScanNet-layout tree that
     `ov3det_torch.datasets.synthetic.write_scannet_tree` writes (16 train
     and 8 val scans of 40 000 points, per-scan point labels): one epoch of
     `ov3det_torch.main` to a checkpoint; `generate_pseudo_label.main` in
     this process with `--conf_thresh 0 --obj_thresh 0` (exactly 16 x 256
     finite rows, one file a scan; each of its 2 batches launching FPS
     twice, the ball-group once and the attention forward 3 times), then
     with `--label_dir` at the default thresholds (the boxes kept printed);
     the first batch's formatter rows from the card and from the CPU, the
     checkpoint at f32 (centres and sizes within 1e-3, score and objectness
     within 1e-4, labels where the top-2 margin exceeds 1e-4); one epoch of
     `--use_pbox` on the kept boxes (in nyu40 ids, `adjust_format_to_nyu40`),
     every step and eval batch launching as in 8; `lift_scene_scannet` on one
     scene of 4 frames whose 16-bit depth PNGs `write_png16` writes, with
     PIL never imported; the CLIP text tower at RN50x4's width from seeded
     weights on the 18 ScanNet classes x 15 templates (a stub vocabulary),
     card against CPU within 1e-5 of the largest value on 30 prompts, timed;
     a reference-layout 3DETR checkpoint at `scannet_quick()`'s width read by
     `load_reference_checkpoint` into a `Detector` with
     `ball_query_method="first_k"`: one request (FPS twice, the first-K
     query once, no ball-group, the attention forward 3 times, NMS and the
     empty-box test once), its time and peak memory, and a masked request
     with the first-K query (twice: the interim SA too); the first-K kernel
     in both designs (the routed `first_k_lanes` and the first,
     `_impl="first"`) equal to its plain version bit for bit on two launches
     each at both of the masked request's shapes (every scene: the
     pre-encoder's 8 x 40 000, M 2048, K 64, r 0.2 and the interim SA's
     8 x 2048, M 1024, K 32, r 0.4, on the request's own points and FPS
     centers) and on crafted cases (the r^2 boundary, full balls at N 1001,
     empty balls, a ragged stage and tile of centers, K 64 and 32, balls
     that fill at a stage and a slice boundary, K 1 and 128, N 1 and 31,
     M 65), card against CPU on one scene, K 129 refused; both designs, the
     plain version (the former path), the grouping and the tile ball-group
     timed in turns beside the bound at both f32 rates, at both queries,
     with the pre-encoder query's memory.
 12. data parallelism and the image bank.  The machine has one card, so two
     ranks share cuda:0 over gloo (NCCL refuses two ranks on one device):
       the steps: two processes this script spawns, each 8 of the 16 scenes
       of a global batch at `sunrgbd_quick()`'s full width; in f32 with TF32
       off and every dropout at 0, two steps against one rank of the 16
       scenes on the card (every loss within 1e-4 relative, the parameters
       within 1e-4, the BatchNorm statistics within 1e-5 relative; the ranks
       equal bit for bit); then 3 bf16 steps at the config's dropout a rank,
       each launching FPS twice, the ball-group once and each attention
       kernel 3 times, timed, and one step split into its stages with each
       all-reduce timed (the gradient's, BatchNorm's and the criterion's);
       a one-rank NCCL group: its all-reduce leaves the gradients bit for
       bit, and the step equals the step with no group as far as two steps
       with no group equal each other;
       the CLI in two ranks (the group joined before `main`) at
       `scannet_quick()`'s width, one epoch of 4 global steps and its eval:
       rank 0 alone prints and writes, one set of files, one AP table, the
       launches of every step and eval batch, and its final AP equal to a
       one-rank `--test_only` of the checkpoint within 1e-3;
       `--use_image --image_bank`, the OV CLI for one epoch as in 10: the
       bank's bytes on the card and the loop's wait on the loader beside
       phase 10's unbanked epoch; the bank's rows the encode of the scenes'
       canvases, the card's decode equal to the host's (uint8), and a banked
       step's losses within 1e-6 of a step given the host's canvases.
 13. the real datasets' images, with PIL never imported:
       the JPEG decoder (`ov3det_torch/utils/jpeg.py`, built here by g++):
       every fixture of `tests/data/jpeg/` decodes to the sha256 of PIL's
       array in its manifest and resizes to that of JAX's
       `resize_crop_image`, the progressive one raises; the host's decode
       ms of a 730 x 530 canvas and of a 1296 x 968 frame;
       the OV CLI as in 10, on a SUN RGB-D-layout tree of 64 train and 16
       val `make_scene` scans of 50 000 points with calibration and JPEGs
       cycled from the fixtures (`write_sunrgbd_tree`), with the gates of
       10; the image branch's ms a batch beside the loader's wait;
       the same with `--image_bank`: every row of the bank the yuv420
       encode of its scan's canvas, the bank's bytes and build seconds;
       `load_scene_frames` on a scene of 40 frames (the 1296 x 968
       fixtures, 16-bit depth PNGs of `write_png16`, poses) at
       max_frames 64: the shapes, the mask, ms a scene.
 14. the packed transfer and the graphed step (slice 12):
       the auction: the fused launch (`auction_lap_kernel`, the whole
       `auction_lap`) and the first design (`_impl="first"`: torch ops
       around `auction_kernel`) against the plain `auction_lap`, the three
       outputs equal, on the criterion's cost matrices of 3 eager
       `sunrgbd_quick` steps (transposed views) and a contiguous copy, on
       seeded costs with ties and ragged live persons (0 included), on
       signed zeros, on near-duplicate rows that do not converge (500 tight
       and 800 loose rounds) and on NaN and -inf benefits (a value, a
       person, a row); on step 0's costs the fused launch, the first
       design's kernel alone and its whole `auction_lap` (replays of a CUDA
       graph of calls, in turns) beside the plain version, the bound of
       step 0's work and its rounds' serial chain;
       `PackedStep` graphed against eager from one state and seeds at
       `sunrgbd_quick`, masked and OV width: 3 steps bit for bit in every
       loss, grad_norm, parameter, buffer and Adam moment; each graphed
       step's launches exact (the first auction design's never); no
       `index_put_`, `index_add_`, `_scatter`, plain auction, plain
       RoIAlign or plain attention pool called in the graphed or eager
       steps (`plain_spy`); no host wait in a group's
       4 replays (CUDA's
       sync debug mode); 5 steps of each timed, one graphed step profiled,
       the peak memory with the graph;
       the bytes of a group of 4 SUN RGB-D OV batches with and without the
       codecs; the OV CLI on phase 13's SUN RGB-D tree layout with
       `--quantize_points --yuv_images --super_batch 4` (every item
       launching 4 steps' kernels, every eval batch a request's), beside
       phase 13's unflagged epoch; the synthetic OV CLI with the codecs at
       `--super_batch 4` and 1: the logged losses and the final parameters
       and Adam moments equal bit for bit.
 15. the evaluation path (slice 13):
       the NMS kernel in both designs (the routed cluster design and the
       first, `_impl="first"`) against its plain version on the card: keep
       masks equal bit for bit in every mode (3D class-aware, 3D, 2D on the
       bird's-eye boxes, each also old-type) on the outputs of the last
       `sunrgbd_quick` and masked request (K 128, 256), on crafted scenes
       at K 8, 256 and 1024 (exact score ties, NaN, -inf, -1e30 scores, IoU
       exactly at the threshold and one ulp either side, as IoU and as the
       old type's ratio, a zero-volume and an infinite box, a box of
       another class over a kept one, a scene with nothing valid) and on
       scenes where every box survives (K 256, 1024); K 1025 refused; both
       designs in turns (graph replays), the plain loop and the bound timed
       at the two requests' shapes, and both designs' parts
       (`scripts/nms_parts.py`: the rank, the bitmask, the greedy pass);
       every NMS mode x empty-box removal x proposal mode of
       `get_ap_config_dict`: `APCalculator` on the card's parse against the
       CPU's plain path on the same outputs, mAP and AR within 1e-6;
       the empty-box kernel in both designs (the routed cluster design and
       the first, `_impl="first"`) against its plain version: counts equal
       bit for bit and in dtype on two launches each, on the two requests'
       outputs (B 8, K 128 x N 20 000, K 256 x N 40 000) and on crafted
       scenes (points at exactly -eps and the upper limit of each face and a
       ulp either side, rotated, degenerate and flat boxes, NaN and infinite
       corners, K 1, K 37 and N 300); both designs (graph replays), the
       plain version and the matmul test timed in turns beside the bound at
       both f32 rates;
       `make_packed_multi_step` at G = 4 and `sunrgbd_quick` width: one
       replay of its graph equals 4 replays of `PackedStep`'s one-step
       graph bit for bit (metrics, parameters, buffers, Adam moments).
 16. the port learns (`learning_phase`): the JAX package's learning check
     (tests/test_e2e_learning.py: its config, its `make_batch` batches from
     the same seeds, 300 steps, the schedule's epoch 40 steps) through the
     graphed `PackedStep`, each step launching FPS twice, the ball-group
     and the auction once (the encoder's attention on the plain path, as
     JAX's dispatch keeps it at 128 tokens), gated at the JAX test's
     thresholds: the loss at step 200 below 0.65 of step 0's, and mAP@0.25
     on two held-out batches above max(0.10, before + 0.08); then 300
     graphed steps at `sunrgbd_quick()`'s full width on 25 `make_batch`
     batches cycled (the attention kernels too), every loss finite, the
     trajectory and mAP@0.25 printed.
Every CLI run of phases 8 and 10-14 on one process replays the step's
CUDA graph, and on one process every eval batch and request replays an
eval graph (`engine.infer.GraphedEval`); a replay calls no wrapper, so the
runs here use `counted_packed_step()`, a `PackedStep` that adds the
kernels its capture recorded times its replays, less the capture's own
count, to what `read_counts` reads, and `count_eval_replays()` does the
same for the eval graphs.  Launch counts are set to 0 just
before each serving, training and CLI run, and read just after it.  The radius variants of the attention kernels count
apart (`.radius_launches`) and have their own entries in the kernels line.
Every profiled request and step runs once under the profiler before the
call it reads (the profiler's schedule: a warm-up, then the active call),
and each launch the wrappers count in the active call must be among its
kernels (`OWN_KERNELS`, by their symbols).
Exits non-zero, printing no result, without CUDA or without the package
beside this file.  Any failed check raises.
"""
import collections
import contextlib
import dataclasses
import functools
import gc
import hashlib
import io
import itertools
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, NUM_POINTS, REQUESTS = 8, 20000, 3  # sunrgbd_quick's data part
SCANNET_POINTS = 40000  # scannet_quick's data part, batch 8 as well
TRAIN_STEPS, MASKED_TRAIN_STEPS = 5, 3
ITERS_PER_EPOCH = 1000  # sets only the learning-rate schedule of the train phase
F32_PEAK, BF16_PEAK, HBM_BYTES_PER_S = 67e12, 989e12, 3.35e12  # H100 SXM data sheet
EX2_PER_SM_CLOCK, INT_LANES_PER_SM_CLOCK = 16, 64  # special-function and int32 results an SM a clock
# integer operations a score of the dropout hash with its row term formed once a
# thread and its column term advanced once a tile: 1.5 adds, the finaliser's
# 3 shifts, 3 xors and 2 multiplies, the compare and the select
HASH_OPS_PER_SCORE = 11


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel from nvcc's `-Xptxas -v` report:
    registers, spill stores, shared memory and any stack frame (local
    memory, such as an array indexed at run time)."""
    import re

    lines, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        tile = re.search(r"ball_group_tileILi([01])ELi(\d+)E", m.group(1)) if m else None
        lanes = re.search(r"first_k_lanesILi(\d+)E", m.group(1)) if m else None
        named = re.search(r"\d(points_in_box_cluster|points_in_box_kernel|first_k_kernel)E",
                          m.group(1)) if m else None
        head = re.search(r"\d(roi_align_kernel|pool_tokens_kernel|pool_attend_kernel|pool_attend_mma)I"
                         r"((?:f|13__nv_bfloat16|S\d*_)+)E", m.group(1)) if m else None
        conv = re.search(r"(quant_conv_kernel|quant_conv_wgmma)I((?:Li\d+E)+)(13__nv_bfloat16|f)E",
                         m.group(1)) if m else None
        if tile:
            kernel = f"ball_group_tile<{('fill', 'sources')[int(tile.group(1))]}, {tile.group(2)}>"
        elif lanes:
            kernel = f"first_k_lanes<{lanes.group(1)}>"
        elif named:
            kernel = named.group(1)
        elif head:
            types = []  # "S1_" and the like repeat an earlier type: here the one before
            for t in re.findall(r"f|13__nv_bfloat16|S\d*_", head.group(2)):
                types.append(types[-1] if t.startswith("S") else "f32" if t == "f" else "bf16")
            kernel = f"{head.group(1)}<{', '.join(types)}>"
        elif conv:
            ints = re.findall(r"Li(\d+)E", conv.group(2))
            kernel = f"{conv.group(1)}<{', '.join(ints + ['bf16' if conv.group(3) != 'f' else 'f32'])}>"
        elif m:
            t = re.search(r"(attn_(?:fwd|dq|dkv)_(?:bf16|f32|wgmma)|fps_kernel|fps_cluster_kernel|"
                          r"pick_kernel|fill_kernel)(?:ILi(\d+)E)?(?:ILb([01])E|Lb([01])E)?", m.group(1))
            flag = "cluster" if t and t.group(1) == "fps_cluster_kernel" else "radius"
            args = [a for a in (t.group(2), {"1": flag}.get(t.group(3) or t.group(4)))
                    if a] if t else []
            kernel = (t.group(1) + (f"<{', '.join(args)}>" if args else "")) if t else m.group(1)
        elif "spill stores" in line and kernel:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
            frame = re.search(r"(\d+) bytes stack frame", line).group(1)
        elif "Used" in line and "registers" in line and kernel:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{kernel}: {regs} registers, {spill} B spilled, "
                         f"{smem.group(1) if smem else 0} B shared"
                         + (f", {frame} B stack frame" if frame != "0" else ""))
            kernel = None
    return lines


def wgmma_advisories(log: str) -> list:
    """ptxas's advisories that it serialised a kernel's wgmma instructions
    (or ignored its setmaxnreg) in an `-Xptxas -v` report."""
    return [line.strip() for line in log.splitlines()
            if ("wgmma" in line and "serializ" in line.lower()) or "setmaxnreg ignored" in line]


def sass_summary() -> list:
    """What the wgmma attention kernels (the forward, dq and dk/dv, each with
    and without the radius) compile to, from `cuobjdump -sass` of the two
    attention libraries: per kernel the count of warpgroup products
    (HGMMA), of mma.sync products (HMMA) and of asynchronous 16-byte copies
    (LDGSTS).  A wgmma kernel must hold the first and the last and no HMMA.
    And the tile ball-group's kernels the route launches (two tiles of
    centers of the forward, one of the pick pass) and the feature gradient's
    fused picks and map (`feature_sources_map`) must hold no FFMA: each
    distance is rounded operation by operation."""
    import re

    from ov3det_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return [f"SASS not inspected: no cuobjdump beside {_build.nvcc_path()}"]
    lines = []
    for name, expected in (("attention_fwd", 2), ("attention_bwd", 4)):
        res = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                             capture_output=True, text=True, timeout=300, check=True)
        counts, kernel = {}, None
        for line in res.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                t = re.search(r"attn_(?:fwd|dq|dkv)_wgmmaILb([01])E", m.group(1))
                kernel = (t.group(0).split("IL")[0] + ("<radius>" if t.group(1) == "1" else "")) if t else None
            elif kernel:
                for op in ("HGMMA", "HMMA", "LDGSTS"):
                    if re.search(rf"\b{op}\b", line):
                        counts.setdefault(kernel, dict(HGMMA=0, HMMA=0, LDGSTS=0))[op] += 1
        for kernel, c in counts.items():
            require(c["HGMMA"] > 0 and c["LDGSTS"] > 0 and c["HMMA"] == 0,
                    f"{kernel} must run on wgmma and cp.async alone: {c}")
            lines.append(f"{kernel}: {c['HGMMA']} HGMMA, {c['HMMA']} HMMA, {c['LDGSTS']} LDGSTS in its SASS")
        require(len(counts) == expected,
                f"{name}: expected {expected} wgmma kernels in the SASS, found {sorted(counts)}")
    # the tile ball-group: no fused multiply-add may round a distance
    res = subprocess.run([tool, "-sass", str(_build.library_path("ball_group"))],
                         capture_output=True, text=True, timeout=300, check=True)
    ffma, kernel = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            t = re.search(r"ball_group_tileILi([01])ELi(\d+)E", m.group(1))
            kernel = (f"ball_group_tile<{('fill', 'sources')[int(t.group(1))]}, {t.group(2)}>"
                      if t else None)
            if kernel:
                ffma[kernel] = 0
        elif kernel and re.search(r"\bFFMA\b", line):
            ffma[kernel] += 1
    # the trunk conv's wgmma design: integer warpgroup products (IGMMA) and
    # cp.async alone, no mma.sync (IMMA)
    res = subprocess.run([tool, "-sass", str(_build.library_path("quant_conv"))],
                         capture_output=True, text=True, timeout=300, check=True)
    counts, kernel = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            t = re.search(r"quant_conv_wgmmaILi(\d+)E(13__nv_bfloat16|f)E", m.group(1))
            kernel = (f"quant_conv_wgmma<{t.group(1)}, {'f32' if t.group(2) == 'f' else 'bf16'}>"
                      if t else None)
            if kernel:
                counts[kernel] = dict(IGMMA=0, IMMA=0, LDGSTS=0)
        elif kernel:
            for op in ("IGMMA", "IMMA", "LDGSTS"):
                if re.search(rf"\b{op}\b", line):
                    counts[kernel][op] += 1
    for kernel, c in sorted(counts.items()):
        require(c["IGMMA"] > 0 and c["LDGSTS"] > 0 and c["IMMA"] == 0,
                f"{kernel} must run on wgmma and cp.async alone: {c}")
        lines.append(f"{kernel}: {c['IGMMA']} IGMMA, {c['IMMA']} IMMA, {c['LDGSTS']} LDGSTS in its SASS")
    require(len(counts) == 4, f"quant_conv: expected 4 wgmma kernels in the SASS, found {sorted(counts)}")
    modes = sorted(k.split("<")[1].split(",")[0] for k in ffma)
    require(modes == ["fill", "fill", "sources"],
            f"ball_group: expected the forward at two tiles and the pick pass in the SASS, found "
            f"{sorted(ffma)}")
    require(not any(ffma.values()), f"ball_group tile kernels hold FFMA: {ffma}")
    # the fused picks and map of the feature gradient: the same distances
    res = subprocess.run([tool, "-sass", str(_build.library_path("feature_grad"))],
                         capture_output=True, text=True, timeout=300, check=True)
    kernel = None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = "feature_sources_map" if "feature_sources_map" in m.group(1) else None
            if kernel:
                ffma[kernel] = 0
        elif kernel and re.search(r"\bFFMA\b", line):
            ffma[kernel] += 1
    require(ffma.get("feature_sources_map") == 0,
            f"feature_sources_map must be in the SASS without FFMA: {ffma}")
    lines.append(f"{', '.join(sorted(ffma))}: 0 FFMA in their SASS")
    return lines


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of one call, from CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of one call: `reps` calls captured in a CUDA graph
    (after one call outside it), the graph replayed once, then timed by CUDA
    events around one replay, so that the host's cost of each call (the
    wrapper's checks, allocation and launch) does not enter the time of a
    kernel shorter than it.  The launches a capture records count once, at
    capture, in the wrappers' counts."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def designs_in_turns(kernel, rate: float, seed, reps: int) -> tuple:
    """(ms, ms without dropout, the same two of the first design) of
    `kernel(p, seed, impl)`, timed this design, the first, the first, this,
    the smaller of each pair kept; by graph replays (`graph_ms`): eager
    calls of the smaller kernels time the host's launches, which a loaded
    host doubles."""
    ms, nd_ms = graph_ms(lambda: kernel(rate, seed), reps), graph_ms(lambda: kernel(0.0, None), reps)
    old_ms = graph_ms(lambda: kernel(rate, seed, "mma"), reps)
    old_nd = graph_ms(lambda: kernel(0.0, None, "mma"), reps)
    old_ms = min(old_ms, graph_ms(lambda: kernel(rate, seed, "mma"), reps))
    old_nd = min(old_nd, graph_ms(lambda: kernel(0.0, None, "mma"), reps))
    ms = min(ms, graph_ms(lambda: kernel(rate, seed), reps))
    nd_ms = min(nd_ms, graph_ms(lambda: kernel(0.0, None), reps))
    return ms, nd_ms, old_ms, old_nd


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sm_rates() -> tuple[float, float]:
    """(exponentials a second, int32 operations a second) of the card: 16 and
    64 results an SM a clock, at the SM count and clock the card reports."""
    props = torch.cuda.get_device_properties(0)
    khz = getattr(props, "clock_rate", None)
    if not khz:  # older PyTorch: nvidia-smi gives the maximum SM clock in MHz
        res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True)
        khz = float(res.stdout.strip().splitlines()[0]) * 1e3
    per_s = props.multi_processor_count * khz * 1e3
    return EX2_PER_SM_CLOCK * per_s, INT_LANES_PER_SM_CLOCK * per_s


def attention_bound(nbytes: float, tensor_flops: float, scores: float, dropout: bool,
                    f32_ops: float = 0.0) -> dict:
    """The least time of one attention kernel call: the largest of its bytes
    at the memory rate, its tensor operations at the bf16 peak, one
    exponential a score, its f32 operations (the radius test) and, with
    dropout, the hash's integer operations.  Returns bound_ms, bound_by
    ("bytes" or "operations") and bound_term, the term that won."""
    ex2_rate, int_rate = sm_rates()
    terms = {"bytes": nbytes / HBM_BYTES_PER_S, "tensor operations": tensor_flops / BF16_PEAK,
             "exponentials": scores / ex2_rate, "distance test": f32_ops / F32_PEAK}
    if dropout:
        terms["hash"] = HASH_OPS_PER_SCORE * scores / int_rate
    term = max(terms, key=terms.get)
    return dict(bound_ms=terms[term] * 1e3, bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


@functools.lru_cache(maxsize=None)
def count_int_mm():
    """`torch._int_mm` replaced by a wrapper that counts its calls in
    `.launches`: the plain int8 product, which no path on the card may call
    (the kernels' oracles do, outside the counted runs)."""
    original = torch._int_mm

    def int_mm(*args, **kwargs):
        int_mm.launches += 1
        return original(*args, **kwargs)

    int_mm.launches = 0
    torch._int_mm = int_mm
    return int_mm


def kernel_counters() -> dict:
    """name -> (wrapper, attribute): each wrapper counts its kernel's launches
    in `.launches`, the attention wrappers those of the radius variant in
    `.radius_launches`; "int_mm" counts `torch._int_mm`'s calls and
    "auction_first" the first auction design's launches, which must stay 0."""
    from ov3det_torch.ops.kernels import (
        add_norm,
        attention,
        attn_pool,
        auction,
        ball_group,
        ball_query,
        bn_relu,
        fps,
        nms,
        normalise,
        points_in_box,
        quant_conv,
        roi_align,
    )

    count_eval_replays()
    counters = {"fps": (fps.fps, "launches"), "ball_group": (ball_group.ball_group, "launches"),
                "sources_map": (ball_group.sources_map, "launches"),
                "feature_sum": (ball_group.feature_sum, "launches"),
                # the first design of the pick pass and the scatter on any
                # sources: the route where `sources_map` does not fit
                "slot_sources": (ball_group.slot_sources, "launches"),
                "feature_scatter": (ball_group.feature_scatter, "launches")}
    for name in ("attention_fwd", "attention_dq", "attention_dkv"):
        counters[name] = (getattr(attention, name), "launches")
        counters[f"{name}_radius"] = (getattr(attention, name), "radius_launches")
    counters["auction"] = (auction.auction_lap, "launches")
    # the first design's phases alone (`_impl="first"`): no main path launches them
    counters["auction_first"] = (auction.auction_phases, "launches")
    counters["nms"] = (nms.nms_keep, "launches")
    counters["quant_conv"] = (quant_conv.quant_conv, "launches")
    counters["pool_quantize"] = (quant_conv.pool_quantize, "launches")
    # the pass with the stem's bn1 and ReLU (`affine=`) counts apart
    counters["pool_quantize_affine"] = (quant_conv.pool_quantize, "affine_launches")
    counters["normalise"] = (normalise.normalise, "launches")
    counters["points_in_box"] = (points_in_box.points_in_box, "launches")
    counters["first_k"] = (ball_query.first_k, "launches")
    counters["roi_align"] = (roi_align.roi_align, "launches")
    counters["pool_tokens"] = (attn_pool.pool_tokens, "launches")
    counters["pool_attend"] = (attn_pool.pool_attend, "launches")
    for name in SA_KERNELS:
        counters[name] = (getattr(bn_relu, name), "launches")
    for name in NORM_KERNELS:
        counters[name] = (getattr(add_norm, name), "launches")
    counters["int_mm"] = (count_int_mm(), "launches")
    return counters


def wrapper_counts() -> dict:
    """name -> the launches its wrapper has counted."""
    return {n: getattr(w, a) for n, (w, a) in kernel_counters().items()}


REPLAYED: dict = {}  # name -> launches of graph replays less those their captures recorded


@functools.lru_cache(maxsize=None)
def count_eval_replays() -> None:
    """Count the launches of `engine.infer.GraphedEval` replays (the graphed
    eval step and request), as `counted_packed_step` does the training
    step's: each capture takes what it recorded off `REPLAYED`, each replay
    adds it.  Installed once, on the class, before any capture (every
    `kernel_counters` call makes sure of it)."""
    from ov3det_torch.engine.infer import GraphedEval

    record, replay = GraphedEval._record, GraphedEval._replay

    def counted_record(self, graph, stream, static_in):
        before = wrapper_counts()
        out = record(self, graph, stream, static_in)
        after = wrapper_counts()
        rec = {n: after[n] - before[n] for n in after if after[n] != before[n]}
        # on the instance, by the graph's id: a reference to the graph here
        # would keep its memory pool alive after the step is gone
        self.__dict__.setdefault("recorded", {})[id(graph)] = rec
        for n, c in rec.items():
            REPLAYED[n] = REPLAYED.get(n, 0) - c
        return out

    def counted_replay(self, key):
        replay(self, key)
        for n, c in self.recorded[id(self._graphs[key][0])].items():
            REPLAYED[n] = REPLAYED.get(n, 0) + c

    GraphedEval._record, GraphedEval._replay = counted_record, counted_replay


@functools.lru_cache(maxsize=None)
def counted_packed_step():
    """`engine.train.PackedStep` with its CUDA-graph launches counted: a
    capture calls the wrappers, which count each launch it records though
    nothing runs, and a replay calls none.  Each capture takes what it
    recorded off `REPLAYED` and each replay adds it, so that the wrappers'
    counts plus `REPLAYED` are the launches that ran (`read_counts`)."""
    from ov3det_torch.engine.train import PackedStep

    class CountedPackedStep(PackedStep):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.recorded = {}  # metas -> name -> the launches one replay makes

        def _record(self, graph, stream, static_row, metas):
            before = wrapper_counts()
            out = super()._record(graph, stream, static_row, metas)
            after = wrapper_counts()
            rec = {n: after[n] - before[n] for n in after if after[n] != before[n]}
            self.recorded[metas] = rec
            for n, c in rec.items():
                REPLAYED[n] = REPLAYED.get(n, 0) - c
            return out

        def _replay(self, rows, metas, first_iter):
            fresh = metas not in self._graphs  # its first row is the eager warm-up
            out = super()._replay(rows, metas, first_iter)
            replays = rows.shape[0] - int(fresh)
            for n, c in self.recorded[metas].items():
                REPLAYED[n] = REPLAYED.get(n, 0) + replays * c
            return out

    return CountedPackedStep


def read_counts() -> dict:
    """The launches that ran: the wrappers' counts plus `REPLAYED`."""
    counts = wrapper_counts()
    for n, c in REPLAYED.items():
        counts[n] += c
    return counts


def reset_counts() -> None:
    for w, a in kernel_counters().values():
        setattr(w, a, 0)
    REPLAYED.clear()


def kernel_sources() -> dict:
    """name -> (source in the repo, the TPU kernel it replaces)."""
    from ov3det_torch.ops.kernels import (
        add_norm,
        attention,
        attn_pool,
        auction,
        ball_group,
        ball_query,
        bn_relu,
        fps,
        nms,
        normalise,
        points_in_box,
        quant_conv,
        roi_align,
    )

    return {"fps": (fps.SOURCE, fps.REPLACES),
            "ball_group": (ball_group.SOURCE, ball_group.REPLACES),
            "sources_map": (ball_group.SCATTER_SOURCE, ball_group.SOURCES_MAP_REPLACES),
            "feature_sum": (ball_group.SCATTER_SOURCE, ball_group.SCATTER_REPLACES),
            "attention_fwd": (attention.SOURCE, attention.REPLACES),
            "attention_dq": (attention.BWD_SOURCE, attention.DQ_REPLACES),
            "attention_dkv": (attention.BWD_SOURCE, attention.DKV_REPLACES),
            "attention_fwd_radius": (attention.SOURCE, attention.FWD_RADIUS_REPLACES),
            "attention_dq_radius": (attention.BWD_SOURCE, attention.DQ_RADIUS_REPLACES),
            "attention_dkv_radius": (attention.BWD_SOURCE, attention.DKV_RADIUS_REPLACES),
            "auction": (auction.SOURCE, auction.REPLACES),
            "nms": (nms.SOURCE, nms.REPLACES),
            "quant_conv": (quant_conv.SOURCE, quant_conv.REPLACES),
            "pool_quantize": (quant_conv.SOURCE, quant_conv.POOL_REPLACES),
            "pool_quantize_affine": (quant_conv.SOURCE, quant_conv.AFFINE_REPLACES),
            "normalise": (normalise.SOURCE, normalise.REPLACES),
            "points_in_box": (points_in_box.SOURCE, points_in_box.REPLACES),
            "first_k": (ball_query.SOURCE, ball_query.REPLACES),
            "roi_align": (roi_align.SOURCE, roi_align.REPLACES),
            "pool_tokens": (attn_pool.SOURCE, attn_pool.TOKENS_REPLACES),
            "pool_attend": (attn_pool.SOURCE, attn_pool.ATTEND_REPLACES),
            "bn_stats": (bn_relu.SOURCE, bn_relu.STATS_REPLACES),
            "bn_relu_apply": (bn_relu.SOURCE, bn_relu.APPLY_REPLACES),
            "bn_relu_grad_sums": (bn_relu.SOURCE, bn_relu.GRAD_SUMS_REPLACES),
            "bn_relu_grad_apply": (bn_relu.SOURCE, bn_relu.GRAD_APPLY_REPLACES),
            "add_norm": (add_norm.SOURCE, add_norm.REPLACES),
            "add_norm_grad": (add_norm.SOURCE, add_norm.GRAD_REPLACES)}


# the set abstraction's shared MLP (`ops/kernels/bn_relu`): an SA module of
# SA_WIDTHS widths launches all four kernels once a width in a training step,
# the apply pass alone in eval mode (a request, an eval batch)
SA_KERNELS = ("bn_stats", "bn_relu_apply", "bn_relu_grad_sums", "bn_relu_grad_apply")
SA_WIDTHS = 3


def sa(modules: int = 1, train: bool = True) -> dict:
    """The shared MLP's launches of `modules` SA modules, for `expect`."""
    return {n: SA_WIDTHS * modules for n in (SA_KERNELS if train else ("bn_relu_apply",))}


# the transformer's add & norm (`ops/kernels/add_norm`): an encoder layer runs
# NORMS_PER_ENCODER_LAYER norms (norm1 alone, norm2 with the attention's
# residual), a decoder layer NORMS_PER_DECODER_LAYER (norm1 alone, norm2 and
# norm3 with the attentions' residuals, the stack's final norm on its output);
# a training step launches the forward and the backward once a norm, eval
# mode the forward alone
NORM_KERNELS = ("add_norm", "add_norm_grad")
NORMS_PER_ENCODER_LAYER, NORMS_PER_DECODER_LAYER = 2, 4


def norms(train: bool = True, times: int = 1, layers: tuple = (3, 8)) -> dict:
    """The add & norm launches of `times` forwards of a detector with
    (encoder, decoder) `layers` (every config of this script but the
    learning check's has 3 and 8), for `expect`."""
    n = times * (NORMS_PER_ENCODER_LAYER * layers[0] + NORMS_PER_DECODER_LAYER * layers[1])
    return {k: n for k in (NORM_KERNELS if train else ("add_norm",))}


def expect(**counts) -> dict:
    """Launches of every counter: the named ones as given, the rest 0."""
    return {n: counts.get(n, 0) for n in kernel_counters()}


def check_fps(fps, calls: list, ragged, label: str) -> dict:
    """FPS at the (cloud, samples) `calls` of one request: the indices of the
    cluster design must equal the plain version's and the first design's (at
    the ragged cloud too); both designs are timed in turns, the plain version
    once, and the chain alone (the step's reductions, exchange and wait on no
    points, at the call's cluster size and sample count).  Returns the sums
    over the calls as the kernels line's keys: `bound_ms` and `bound_by` are
    the bytes and f32 operations of these inputs at the card's peak rates;
    `chain_floor_ms` is a measurement of this design's own step, kept beside
    the bound and never in its place."""
    tot = dict(ms=0.0, ms_previous_design=0.0, plain_ms=0.0, chain_floor_ms=0.0)
    nbytes, ops, plans, shapes = 0, 0, [], []
    for xyz, k in list(calls) + [ragged]:
        N = xyz.shape[1]
        want = fps.fps_plain(xyz, k)
        require(torch.equal(fps.fps(xyz, k), want), f"fps {N}->{k} differs from plain")
        require(torch.equal(fps.fps(xyz, k, _impl="first"), want),
                f"fps {N}->{k}: the first design differs from plain")
    for xyz, k in calls:
        B, N, _ = xyz.shape
        reps = 3 if N > 4096 else 10
        plan = fps.plan(B, N)
        ms, old = cuda_ms(lambda: fps.fps(xyz, k), reps), cuda_ms(lambda: fps.fps(xyz, k, _impl="first"), reps)
        old = min(old, cuda_ms(lambda: fps.fps(xyz, k, _impl="first"), reps))
        ms = min(ms, cuda_ms(lambda: fps.fps(xyz, k), reps))
        chain = cuda_ms(lambda: fps.chain(B, k, plan["cluster"], xyz.device), reps)
        plain = cuda_ms(lambda: fps.fps_plain(xyz, k), 1 if N > 20000 else 2)
        require(ms <= old, f"fps {N}->{k}: the cluster design ({ms:.3f} ms) is slower than the "
                           f"first ({old:.3f} ms)")
        print(f"fps {B}x{N}->{k}: cluster of {plan['cluster']} ({plan['ctas']} CTAs of "
              f"{plan['threads']} threads, {plan['clusters_at_once']} clusters fit at once): "
              f"{ms:.3f} ms ({ms / (k - 1) * 1e3:.3f} us a step); first design {old:.3f} ms; the "
              f"chain alone {chain:.3f} ms ({chain / (k - 1) * 1e3:.3f} us a step); plain {plain:.3f} ms")
        for key, val in (("ms", ms), ("ms_previous_design", old), ("plain_ms", plain),
                         ("chain_floor_ms", chain)):
            tot[key] += val
        nbytes += B * (N * 12 + k * 8)
        ops += 10 * B * (k - 1) * N  # 3 sub, 3 mul, 2 add, min, compare per point-step
        plans.append(dict(points=N, samples=k, **plan))
        shapes.append(f"{N}->{k}")
    b_ms, b_by = bound_ms(nbytes, ops, F32_PEAK)
    work = f"one {label} request: {BATCH}x" + " + ".join(shapes)
    print(f"fps ({label}): indices equal the plain version's and the first design's at "
          f"{', '.join(shapes)} and at the ragged {ragged[0].shape[1]}->{ragged[1]}; cluster design "
          f"{tot['ms']:.3f} ms, first design {tot['ms_previous_design']:.3f} ms, plain "
          f"{tot['plain_ms']:.3f} ms; bound {b_ms:.4f} ms ({b_by}), chain floor "
          f"{tot['chain_floor_ms']:.3f} ms")
    return dict(max_abs_err=0.0, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, bound_term=b_by,
                chain_floor_ms=tot["chain_floor_ms"], library_ms=None,
                design="thread-block cluster per scene, st.async exchange",
                ms_previous_design=tot["ms_previous_design"], launch_plans=plans, work=work)


def grow_by_one(xyz: torch.Tensor) -> torch.Tensor:
    """The cloud with one more point: a point count that no tile divides."""
    return torch.cat([xyz, xyz[:, :1] + 0.5], dim=1).contiguous()


def check_kernels(batch: dict, dev: torch.device) -> dict:
    """Phase 2: the point kernels against their plain versions, timed;
    returns their entries for one request's work on the serving path."""
    from ov3det_torch.ops.kernels import fps

    xyz = torch.from_numpy(batch["point_clouds"]).to(dev)
    B, N, _ = xyz.shape
    entries = {}

    # FPS: 20000 -> 2048 (pre-encoder), then 2048 -> 128 (query seeds)
    inds = fps.fps(xyz, 2048)
    pre_xyz = torch.gather(xyz, 1, inds[..., None].expand(-1, -1, 3)).contiguous()
    entries["fps"] = check_fps(fps, [(xyz, 2048), (pre_xyz, 128)], (grow_by_one(xyz), 64), "sunrgbd")

    # ball-group: 8 x 20000 points, 2048 centers, K = 64, r = 0.2; C = 0 and C = 3,
    # then a ragged N (20 001 points) and a ragged M (2047 centers)
    K, radius = 64, 0.2
    feats = torch.randn(B, N, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    main = check_ball_group(xyz, None, pre_xyz, radius, K, "sunrgbd C=0", 10)
    c3 = check_ball_group(xyz, feats, pre_xyz, radius, K, "sunrgbd C=3", 10)
    grown = grow_by_one(xyz)
    ragged_n = check_ball_group(grown, torch.cat([feats, feats[:, :1]], 1).contiguous(), pre_xyz,
                                radius, K, "ragged N=20001 C=3", 3)
    ragged_m = check_ball_group(xyz, None, pre_xyz[:, :2047].contiguous(), radius, K,
                                "ragged M=2047 C=0", 3)
    entries["ball_group"] = dict(main, max_abs_err=0.0, library_ms=None,
                                 design="tile: a CTA a (scene, tile of centers), buckets staged by "
                                        "cp.async, picks in shared memory, one launch",
                                 shapes={"c3": c3, "ragged_n": ragged_n, "ragged_m": ragged_m},
                                 work="one request: 8x20000, M=2048, K=64, C=0")
    return entries


def distance_tests(pick, has, N: int, K: int) -> int:
    """Distance tests the early exit leaves: each bucket is scanned up to its
    first hit, or whole (its length within N) when it holds none."""
    Nb = -(-N // K)
    starts = torch.arange(K, device=pick.device) * Nb
    bucket_len = torch.clamp(N - starts, 0, Nb)
    return int(torch.where(has, pick - starts + 1, bucket_len).sum().item())


def check_ball_group(xyz, feats, centers, radius: float, K: int, label: str, reps: int) -> dict:
    """The forward at one shape: the tile design's output equals the plain
    version's and the first design's bit for bit, on two launches; the two
    designs timed in turns (tile, first, first, tile; the smaller of each
    pair; each a CUDA graph of `reps` calls: `graph_ms`), the plain version
    once.  The bound: the bytes (points, centers
    and features read once, the output written once) or the distance tests
    this data needs with the early exit (9 f32 operations each), the larger."""
    from ov3det_torch.ops.kernels import ball_group as BG

    B, N, _ = xyz.shape
    M = centers.shape[1]
    C = 0 if feats is None else feats.shape[-1]
    want = BG.ball_group_plain(xyz, feats, centers, radius, K)
    for launch in range(2):
        got = BG.ball_group(xyz, feats, centers, radius, K)
        require(torch.equal(got, want), f"ball_group {label}, launch {launch}: the tile design "
                                        f"differs from plain by {(got - want).abs().max().item()}")
    first = BG.ball_group(xyz, feats, centers, radius, K, _impl="first")
    require(torch.equal(first, want), f"ball_group {label}: the first design differs from plain")
    ms = graph_ms(lambda: BG.ball_group(xyz, feats, centers, radius, K), reps)
    old = graph_ms(lambda: BG.ball_group(xyz, feats, centers, radius, K, _impl="first"), reps)
    old = min(old, graph_ms(lambda: BG.ball_group(xyz, feats, centers, radius, K, _impl="first"), reps))
    ms = min(ms, graph_ms(lambda: BG.ball_group(xyz, feats, centers, radius, K), reps))
    plain = cuda_ms(lambda: BG.ball_group_plain(xyz, feats, centers, radius, K), 1)
    tests = distance_tests(*BG.bucket_picks(xyz, centers, radius, K), N, K)
    nbytes = (xyz.numel() + centers.numel() + (0 if feats is None else feats.numel())
              + want.numel()) * 4
    b_ms, b_by = bound_ms(nbytes, 9 * tests, F32_PEAK)
    print(f"ball_group {label} ({B}x{N}, M={M}, K={K}, C={C}): tile design equals plain and the "
          f"first design on two launches; "
          f"{tests} distance tests with early exit; tile {ms:.4f} ms, first design {old:.4f} ms, "
          f"plain {plain:.3f} ms, bound {b_ms:.4f} ms ({b_by}; output {want.numel() * 4 / 1e6:.1f} MB)")
    return dict(ms=ms, ms_previous_design=old, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                distance_tests=tests)


def reveal_masks(A, seed, rate: float, BH: int, N: int, D: int, dev, radius=None,
                 impl=None) -> dict:
    """The mask as each bf16 kernel applies it, read back exactly: the
    dropout mask, or with `radius` and no dropout the radius mask; `impl` is
    the wrappers' `_impl` (None: the design the shape routes to, "mma": the
    first design).

    With q = 0 every probability is 1/N (1/count of the in-radius keys with
    the radius), so a kernel's output is 0 exactly where it dropped or
    masked a position.  One-hot operands pick D columns per launch:
      forward: V = one-hot(key t*D + d)      -> out[q, d]  = m(q, t*D + d) / N
      dq:      K = one-hot, V = dO = 1        -> dq[q, d]   ~ m(q, t*D + d)
      dk/dv:   dO = one-hot(query t*D + d)    -> dv[key, d] = m(t*D + d, key) / N
    """
    bf = dict(dtype=torch.bfloat16, device=dev)
    zero, ones = torch.zeros(BH, N, D, **bf), torch.ones(BH, N, D, **bf)
    lse = torch.full((BH, N, 1), math.log(N), dtype=torch.float32, device=dev)
    no_delta = torch.zeros(BH, N, 1, dtype=torch.float32, device=dev)
    eye = torch.eye(D, **bf)
    seen = {name: torch.empty(BH, N, N, dtype=torch.bool, device=dev)
            for name in ("attention_fwd", "attention_dq", "attention_dkv")}
    for t in range(N // D):
        cols = slice(t * D, (t + 1) * D)
        sel = torch.zeros(BH, N, D, **bf)
        sel[:, cols] = eye
        out, _ = A.attention_fwd(zero, zero, sel, rate, seed, radius, _impl=impl)
        seen["attention_fwd"][:, :, cols] = out != 0
        dq = A.attention_dq(zero, sel, ones, ones, lse, no_delta, rate, seed, radius, _impl=impl)
        seen["attention_dq"][:, :, cols] = dq != 0
        _, dv = A.attention_dkv(zero, zero, zero, sel, lse, no_delta, rate, seed, radius,
                                _impl=impl)
        seen["attention_dkv"][:, cols, :] = (dv != 0).transpose(1, 2)
    return seen


def check_attention(dev: torch.device) -> dict:
    """Phase 2, attention: the three kernels of the training step's encoder
    (BH = 8 x 4 heads, N = 2048, D = 64) against their plain versions, per
    call.  The operands (8 MB each) stay in the 50 MB L2 between timed
    launches."""
    from ov3det_torch.ops.kernels import attention as A

    BH, N, D, rate = 32, 2048, 64, 0.1
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(BH, N, D, generator=g).to(dev) for _ in range(4))
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    seed = torch.tensor([20260101], dtype=torch.int32, device=dev)

    kept = A.drop_mask(seed, BH, N, N, rate) != 0
    for impl in (None, "mma"):
        for name, mask in reveal_masks(A, seed, rate, BH, N, D, dev, impl=impl).items():
            flips = int((mask != kept).sum())
            require(flips == 0, f"{name} (_impl={impl}): the dropout mask differs from the hash at "
                                f"{flips} positions")
    print(f"attention dropout p={rate}: the masks of the forward, dq and dk/dv kernels, in the wgmma "
          f"and in the first design, equal the hash at all {kept.numel()} positions (kept share "
          f"{kept.float().mean().item():.4f})")
    del kept, mask

    def rel(got, want):  # max error over the largest magnitude of the plain version
        err = (got.float() - want).abs().max()
        abs_err[0] = max(abs_err[0], err.item())
        return (err / want.abs().max()).item()

    errs = {"attention_fwd": 0.0, "attention_dq": 0.0, "attention_dkv": 0.0}
    abs_err = [0.0]
    for p in (0.0, rate):
        out, lse = A.attention_fwd(qb, kb, vb, p, seed)
        ref, ref_lse = A.attention_fwd_plain(qb.float(), kb.float(), vb.float(), p, seed)
        abs_err[0] = 0.0
        e_out, e_lse = rel(out, ref), (lse - ref_lse).abs().max().item()
        errs["attention_fwd"] = max(errs["attention_fwd"], abs_err[0])
        require(e_out <= 2e-2 and e_lse <= 1e-3, f"attention_fwd bf16 p={p}: {e_out}, lse {e_lse}")
        delta = (dob.float() * out.float()).sum(-1, keepdim=True)
        dq = A.attention_dq(qb, kb, vb, dob, lse, delta, p, seed)
        dk, dv = A.attention_dkv(qb, kb, vb, dob, lse, delta, p, seed)
        f32 = [t.float() for t in (qb, kb, vb, dob)]
        rdq = A.attention_dq_plain(*f32, lse, delta, p, seed)
        rdk, rdv = A.attention_dkv_plain(*f32, lse, delta, p, seed)
        abs_err[0] = 0.0
        e_dq = rel(dq, rdq)
        errs["attention_dq"] = max(errs["attention_dq"], abs_err[0])
        abs_err[0] = 0.0
        e_dkv = max(rel(dk, rdk), rel(dv, rdv))
        errs["attention_dkv"] = max(errs["attention_dkv"], abs_err[0])
        require(e_dq <= 2e-2 and e_dkv <= 2e-2, f"attention backward bf16 p={p}: dq {e_dq}, dk/dv {e_dkv}")
        # the first (mma.sync) design of the three kernels on the same inputs
        old_out, old_lse = A.attention_fwd(qb, kb, vb, p, seed, _impl="mma")
        old_dq = A.attention_dq(qb, kb, vb, dob, lse, delta, p, seed, _impl="mma")
        old_dk, old_dv = A.attention_dkv(qb, kb, vb, dob, lse, delta, p, seed, _impl="mma")
        e_old = max((a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                    for a, b in ((out, old_out), (dq, old_dq), (dk, old_dk), (dv, old_dv)))
        e_old_lse = (lse - old_lse).abs().max().item()
        require(e_old <= 2e-2 and e_old_lse <= 1e-3,
                f"attention p={p}: the wgmma and mma.sync designs differ by {e_old}, lse {e_old_lse}")

        out32, lse32 = A.attention_fwd(q, k, v, p, seed)
        ref32, rlse32 = A.attention_fwd_plain(q, k, v, p, seed)
        d32 = (do * out32).sum(-1, keepdim=True)
        e32 = [rel(out32, ref32), (lse32 - rlse32).abs().max().item(),
               rel(A.attention_dq(q, k, v, do, lse32, d32, p, seed),
                   A.attention_dq_plain(q, k, v, do, lse32, d32, p, seed))]
        e32 += [rel(a, b) for a, b in zip(A.attention_dkv(q, k, v, do, lse32, d32, p, seed),
                                          A.attention_dkv_plain(q, k, v, do, lse32, d32, p, seed))]
        require(max(e32) <= 1e-4, f"attention f32 p={p}: out, lse, dq, dk, dv errors {e32}")
        print(f"attention p={p}: bf16 error over the largest plain value: out {e_out:.2e}, "
              f"lse {e_lse:.2e} (abs), dq {e_dq:.2e}, dk/dv {e_dkv:.2e}; wgmma against mma.sync "
              f"design {e_old:.2e}, lse {e_old_lse:.2e}; f32 variants {max(e32):.2e}")

    first_design_check(A, dev)

    out, lse = A.attention_fwd(qb, kb, vb, rate, seed)
    delta = (dob.float() * out.float()).sum(-1, keepdim=True)
    bwd = (qb, kb, vb, dob, lse, delta)
    # name -> (kernel(p, seed, impl), plain version with dropout)
    calls = {
        "attention_fwd": (lambda p, sd, impl=None: A.attention_fwd(qb, kb, vb, p, sd, _impl=impl),
                          lambda: A.attention_fwd_plain(qb, kb, vb, rate, seed)),
        "attention_dq": (lambda p, sd, impl=None: A.attention_dq(*bwd, p, sd, _impl=impl),
                         lambda: A.attention_dq_plain(*bwd, rate, seed)),
        "attention_dkv": (lambda p, sd, impl=None: A.attention_dkv(*bwd, p, sd, _impl=impl),
                          lambda: A.attention_dkv_plain(*bwd, rate, seed)),
    }
    # yardsticks: PyTorch's fused attention without dropout and with the
    # kernels' rate; its backward computes dq, dk and dv in one call
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t.view(8, 4, N, D).detach().requires_grad_() for t in (qb, kb, vb))
    g4 = dob.view(8, 4, N, D)
    library, library_drop = {}, {}
    for p, into in ((0.0, library), (rate, library_drop)):
        into["attention_fwd"] = cuda_ms(lambda: sdpa(q4, k4, v4, dropout_p=p), 20)
        o4 = sdpa(q4, k4, v4, dropout_p=p)
        into["attention_dq"] = into["attention_dkv"] = cuda_ms(
            lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True), 20)
    flops = {"attention_fwd": 4, "attention_dq": 6, "attention_dkv": 8}  # x BH N^2 D
    tensor = BH * N * D * 2  # bytes of one bf16 operand
    nbytes = {"attention_fwd": 4 * tensor + BH * N * 4,  # q, k, v in; out, lse out
              "attention_dq": 5 * tensor + 2 * BH * N * 4,  # q, k, v, dO, lse, delta in; dq out
              "attention_dkv": 6 * tensor + 2 * BH * N * 4}
    scores = BH * N * N  # one exponential each, recomputed in dq and in dk/dv
    ex2_rate, int_rate = sm_rates()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"bounds: {sms} SMs at {ex2_rate / EX2_PER_SM_CLOCK / sms / 1e9:.3f} GHz: "
          f"{ex2_rate:.3e} exponentials/s, {int_rate:.3e} int32 operations/s, "
          f"{HASH_OPS_PER_SCORE} of them a score for the dropout hash")
    entries = {}
    for name, (kernel, plain) in calls.items():
        ms, nd_ms, old_ms, old_nd = designs_in_turns(kernel, rate, seed, 20)
        require(ms < old_ms and nd_ms < old_nd,
                f"{name}: the wgmma design ({ms:.3f} / {nd_ms:.3f} ms with / without dropout) is "
                f"not faster than the mma.sync design ({old_ms:.3f} / {old_nd:.3f} ms)")
        extra = dict(design="wgmma, cp.async ring", ms_previous_design=old_ms,
                     ms_previous_design_no_dropout=old_nd)
        plain_ms = cuda_ms(plain, 3)
        args = (nbytes[name], flops[name] * BH * N * N * D, scores)
        bound, bound_nd = attention_bound(*args, dropout=True), attention_bound(*args, dropout=False)
        was = f"; mma.sync design {old_ms:.3f} ms ({old_nd:.3f})"
        print(f"{name}: per call with dropout {rate}: kernel {ms:.3f} ms (without dropout "
              f"{nd_ms:.3f} ms){was}, plain {plain_ms:.3f} ms, library "
              f"{library_drop[name]:.3f} ms with dropout {rate} ({library[name]:.3f} ms without)"
              f"{' (SDPA backward: dq, dk and dv)' if name != 'attention_fwd' else ' (SDPA)'}, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_term']}; without dropout "
              f"{bound_nd['bound_ms']:.4f} ms, {bound_nd['bound_term']})")
        entries[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, **bound,
                             library_ms=library[name], library_ms_dropout=library_drop[name],
                             ms_no_dropout=nd_ms, bound_ms_no_dropout=bound_nd["bound_ms"],
                             bound_term_no_dropout=bound_nd["bound_term"], **extra,
                             work=f"one call, BH=32, N=2048, D=64 bf16, dropout {rate}; "
                                  "max_abs_err of bf16 against the plain version in f32")
    return entries


def first_design_check(A, dev: torch.device) -> None:
    """The first (mma.sync) forward, dq and dk/dv stay the route of every bf16
    shape the wgmma design does not take, and no main path reaches them: held
    against their plain versions at N = 192 (a multiple of 64, not of 128),
    with dropout and the radius."""
    BH, N, D, rate = 8, 192, 64, 0.1
    g = torch.Generator().manual_seed(7)
    q, k, v, do = (torch.randn(BH, N, D, generator=g).to(dev).bfloat16() for _ in range(4))
    xyz = torch.rand(2, N, 3, generator=g).to(dev)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    require(A._route(q.dtype, D, N, N) == "mma", "N = 192 must take the first design")
    worst = 0.0
    for radius in (None, (xyz, xyz, 0.25)):
        out, lse = A.attention_fwd(q, k, v, rate, seed, radius)
        f32 = [t.float() for t in (q, k, v, do)]
        ref, ref_lse = A.attention_fwd_plain(*f32[:3], rate, seed, radius)
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        pairs = [(out, ref), (A.attention_dq(q, k, v, do, lse, delta, rate, seed, radius),
                              A.attention_dq_plain(*f32, lse, delta, rate, seed, radius))]
        pairs += list(zip(A.attention_dkv(q, k, v, do, lse, delta, rate, seed, radius),
                          A.attention_dkv_plain(*f32, lse, delta, rate, seed, radius)))
        err = max(((a.float() - b).abs().max() / b.abs().max()).item() for a, b in pairs)
        e_lse = (lse - ref_lse).abs().max().item()
        require(err <= 2e-2 and e_lse <= 1e-3,
                f"first design at N=192, radius {radius is not None}: {err}, lse {e_lse}")
        worst = max(worst, err)
    print(f"attention, first design (mma.sync) at BH=8, N=192: forward, dq and dk/dv within "
          f"{worst:.2e} of the largest plain value, with dropout {rate}, with and without the radius")


def check_masked_points(batch: dict, dev: torch.device) -> tuple:
    """Phase 7, point kernels of the masked ScanNet config: FPS and the
    ball-group at its shapes against their plain versions and first designs,
    timed, and the pick pass and the scatter of the ball-group's feature
    gradient, with the gradient itself on the card against the CPU.  Returns
    (extras for the fps and ball_group entries, the sources_map and
    feature_sum entries, the token coordinates at 2048 and 1024
    tokens)."""
    from ov3det_torch.ops.kernels import fps

    xyz = torch.from_numpy(batch["point_clouds"]).to(dev)
    B, N, _ = xyz.shape
    gather = lambda p, i: torch.gather(p, 1, i[..., None].expand(-1, -1, 3)).contiguous()  # noqa: E731
    samples, clouds = (2048, 1024, 256), [xyz]
    for k in samples:
        clouds.append(gather(clouds[-1], fps.fps(clouds[-1], k)))
    fps_extra = check_fps(fps, list(zip(clouds, samples)), (grow_by_one(xyz), 64), "scannet_masked")
    del fps_extra["max_abs_err"]

    # pre-encoder 8 x 40000, M = 2048, K = 64, r = 0.2, C = 0; interim SA:
    # 2048 tokens, 1024 centers, K = 32, r = 0.4, C = 256
    pre_xyz, mid_xyz = clouds[1], clouds[2]
    feats = torch.randn(B, 2048, 256, generator=torch.Generator().manual_seed(2)).to(dev)
    pre = check_ball_group(xyz, None, pre_xyz, 0.2, 64, "masked pre-encoder C=0", 5)
    mid = check_ball_group(pre_xyz, feats, mid_xyz, 0.4, 32, "masked interim C=256", 5)
    bg_extra = dict(mid, library_ms=None, pre_encoder=pre,
                    work="one interim SA call: 8x2048, M=1024, K=32, C=256")
    return {"fps": fps_extra, "ball_group": bg_extra,
            "sources_map": check_slot_sources(pre_xyz, mid_xyz, dev),
            "feature_sum": check_feature_scatter(card_line(), pre_xyz, mid_xyz, dev)}, \
        pre_xyz, mid_xyz


SOURCES_TURNS = 3  # turns of the fused picks and map against the first pair


def check_slot_sources(pre_xyz, mid_xyz, dev: torch.device) -> dict:
    """The feature gradient's picks and map (`sources_map`: one launch of
    `feature_sources_map`) at the interim SA's shape: the sources equal the
    plain version at every position and the list and work records the plain
    inverse map, on two launches; the pick pass of the route and of the
    first design (`slot_sources(..., _impl="first")`,
    `ball_group_tile<sources>`) equal too; on a scene where the direct and
    the expanded distances split at r^2 both give the expanded pick.  Timed
    as replays of CUDA graphs in turns (SOURCES_TURNS each, the fused kernel
    first and last) with the first pair: the first pick pass, then
    `feature_map`; the fused kernel must be the faster in every turn.
    Returns the kernels line's entry."""
    from ov3det_torch.ops.kernels import ball_group as BG

    B, N, _ = pre_xyz.shape
    M, K, radius = mid_xyz.shape[1], 32, 0.4
    want_src, want_list, want_work = BG.sources_map_plain(pre_xyz, mid_xyz, radius, K)
    named = (want_work[..., 2] - want_work[..., 1]).sum(1)
    listed = torch.arange(K * M, device=dev)[None] < named[:, None]
    for launch in range(2):
        src, lst, work = BG.sources_map(pre_xyz, mid_xyz, radius, K)
        require(torch.equal(src, want_src), f"sources_map, launch {launch}: the sources differ from "
                                            f"the plain version at {int((src != want_src).sum())} "
                                            "positions")
        require(torch.equal(work, want_work), f"sources_map, launch {launch}: the work records "
                                              "differ from the plain inverse map")
        require(torch.equal(lst[listed], want_list[listed]),
                f"sources_map, launch {launch}: the list differs from the plain inverse map at "
                f"{int((lst[listed] != want_list[listed]).sum())} places")
    require(torch.equal(BG.slot_sources(pre_xyz, mid_xyz, radius, K), want_src),
            "slot_sources (the route) differs from the plain version")
    require(torch.equal(BG.slot_sources(pre_xyz, mid_xyz, radius, K, _impl="first"), want_src),
            "slot_sources, the first design, differs from the plain version")
    # the boundary scene: center (10, 0, 0), a point just outside r by the
    # direct distance and inside by the expanded one, first in bucket 0
    c0, r = np.float32(10.0), 0.2
    r2 = np.float32(r * r)
    p = np.nextafter(np.float32(c0 + np.float32(r)), np.float32(0))
    expanded = lambda p: np.maximum((c0 * c0 + p * p) - np.float32(2) * (c0 * p), 0)  # noqa: E731
    while not ((p - c0) * (p - c0) >= r2 and expanded(p) < r2):
        p = np.nextafter(p, np.float32(20))
    edge = np.zeros((1, 4, 3), np.float32)
    edge[0, :, 0] = [30.0, p, c0 - np.float32(0.1), 40.0]
    e_xyz = torch.from_numpy(edge).to(dev)
    e_c = torch.tensor([[[10.0, 0.0, 0.0]]], device=dev)
    e_feats = torch.arange(8, dtype=torch.float32, device=dev).view(1, 4, 2)
    e_want = BG.sources_map_plain(e_xyz, e_c, r, 1)
    e_got = BG.sources_map(e_xyz, e_c, r, 1)
    e_first = BG.slot_sources(e_xyz, e_c, r, 1, _impl="first")
    e_out = BG.ball_group(e_xyz, e_feats, e_c, r, 1)
    require(e_got[0].item() == 1 and e_first.item() == 1 and torch.equal(e_got[0], e_want[0])
            and torch.equal(e_got[2], e_want[2]) and e_got[1][0, 0].item() == 0,
            f"sources_map at the r^2 boundary: {e_got[0].item()} (the first design "
            f"{e_first.item()}), the expanded pick is 1")
    require(e_out[0, 0, 0, 3:].tolist() == [4.0, 5.0], "ball_group at the r^2 boundary must take "
                                                        "the direct pick, point 2")

    first_src = torch.empty_like(want_src)
    slots = torch.empty((B, K * M), dtype=torch.int32, device=dev)
    first_work = torch.empty((B, N, 4), dtype=torch.int32, device=dev)

    def pick_alone():  # `slot_sources(..., _impl="first")` into a buffer of its own
        BG._launch("ov3_ball_group_sources", dev, pre_xyz, mid_xyz, B, N, M, K,
                   BG._f32(radius * radius), first_src)

    def first_pair():
        pick_alone()
        BG._fg_launch("ov3_feature_map", dev, first_src, B, N, K * M, slots, first_work)

    fns = {"fused": lambda: BG.sources_map(pre_xyz, mid_xyz, radius, K),
           "first": first_pair, "first pick pass": pick_alone}
    turns = {k: [] for k in fns}
    for turn in range(SOURCES_TURNS):
        for name in (list(fns) if turn % 2 == 0 else list(fns)[::-1]):
            turns[name].append(graph_ms(fns[name], 10))
    require(all(a < b for a, b in zip(turns["fused"], turns["first"])),
            f"sources_map: the fused kernel is not faster than the first pick pass and "
            f"feature_map in every turn: {turns}")
    ms, first = min(turns["fused"]), min(turns["first"])
    plain = cuda_ms(lambda: BG.sources_map_plain(pre_xyz, mid_xyz, radius, K), 2)
    tests = distance_tests(*BG.bucket_picks_expanded(pre_xyz, mid_xyz, radius, K), N, K)
    # 9 f32 operations a test: c.x five, then add, multiply by 2, subtract,
    # compare; |x|^2 five once a point and |c|^2 five once a center; the
    # points and centers read once, the sources, list and records written once
    b_ms, b_by = bound_ms((pre_xyz.numel() + mid_xyz.numel()) * 4 + (2 * want_src.numel()
                                                                     + want_work.numel()) * 4,
                          9 * tests + 5 * B * (N + M), F32_PEAK)

    print(f"sources_map ({B}x{N}, M={M}, K={K}): the sources equal the plain version at all "
          f"{want_src.numel()} positions, the list and work records the plain inverse map, on two "
          f"launches; the first pick pass equal; the expanded pick at the r^2 boundary (the forward "
          f"the direct one); {tests} distance tests with early exit; in turns (graph replays): fused "
          f"{', '.join(f'{v:.4f}' for v in turns['fused'])} ms, the first pick pass and feature_map "
          f"{', '.join(f'{v:.4f}' for v in turns['first'])} ms (the pick pass alone "
          f"{', '.join(f'{v:.4f}' for v in turns['first pick pass'])}); plain {plain:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=0.0, ms=ms, ms_previous_design=first, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, distance_tests=tests, turns=turns,
                first_pick_ms=min(turns["first pick pass"]),
                design="feature_sources_map: a cluster of 8 CTAs a scene, each its 4 buckets' "
                       "points against every center, the empty slots filled over DSMEM, the "
                       "counting sort from shared memory; first: ball_group_tile<sources, 32> "
                       "then feature_map",
                work="one masked training step's backward: 8x2048, M=1024, K=32")


def crafted_sources(dev: torch.device) -> dict:
    """label -> (sources (B, K, M) int32, cotangent (B, K, M, 3 + C) f32, N,
    C) on the card: the skews and edges the feature-gradient scatter must
    sum in slot order, seeded."""
    gen = torch.Generator(device=dev).manual_seed(18)

    def grad(src, C):
        return torch.randn(*src.shape, 3 + C, generator=gen, device=dev)

    def keys(B, K, M, N):
        return torch.randint(0, N, (B, K, M), generator=gen, device=dev, dtype=torch.int32)

    out = {}
    src = keys(8, 32, 1024, 2048)
    src[:, :, ::5] = src[:, :1, ::5]  # every slot of a fifth of the balls on one point
    src[:, :, 1::7] = -1  # empty balls
    out["one point a ball, empty balls"] = (src, grad(src, 256), 2048, 256)
    src = keys(2, 32, 1024, 1024)  # half the points named by no slot
    out["points no slot names"] = (src, grad(src, 256), 2048, 256)
    src = torch.zeros((1, 32, 1024), dtype=torch.int32, device=dev)  # a scene on one point
    out["every slot on one point"] = (src, grad(src, 256), 2048, 256)
    src = keys(3, 1, 1024, 2047)
    out["K 1, N 2047"] = (src, grad(src, 40), 2047, 40)  # C not a multiple of 64
    src = keys(2, 32, 1024, 2048)
    out["C 4"] = (src, grad(src, 4), 2048, 4)
    src = keys(1, 64, 1024, 2048)
    out["65536 slots a scene"] = (src, grad(src, 16), 2048, 16)
    return out


def check_feature_scatter(card: str, pre_xyz, mid_xyz, dev: torch.device) -> dict:
    """Phase 7, the feature gradient's sum (`feature_sum` over the map of
    `sources_map`) and the scatter on any sources (`feature_scatter`:
    `feature_map`, then `feature_sum`) at the interim SA's shape: each equal
    to `_scatter` (the accumulating `index_put_`) bit for bit on the masked
    step's own sources on two launches, the scatter on crafted sources too;
    the whole gradient (two launches: `sources_map`, `feature_sum`) on the
    card equal to the CPU's bit for bit, and to the first route's (the first
    pick pass, then `feature_scatter`); the slots-a-point distribution; the
    sum, its plain version and `index_add_` timed in turns (graph replays),
    and the whole gradient by both routes in turns, and with the plain pick
    pass and `_scatter`.  Returns the kernels line's entry of the sum."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import feature_grad_parts

    from ov3det_torch.ops.kernels import ball_group as BG

    B, N, _ = pre_xyz.shape
    M, K, radius, C = mid_xyz.shape[1], 32, 0.4, 256
    src, lst, work = BG.sources_map(pre_xyz, mid_xyz, radius, K)
    g = torch.randn(B, K, M, 3 + C, generator=torch.Generator().manual_seed(3)).to(dev)
    want = BG._scatter(src, g, N, C)
    require(torch.equal(BG.feature_sum_plain(g, lst, work, N, C), want),
            "feature_sum_plain differs from _scatter")
    for launch in range(2):
        for name, got in (("feature_sum", BG.feature_sum(g, lst, work, N, C)),
                          ("feature_scatter", BG.feature_scatter(src, g, N, C))):
            require(torch.equal(got, want), f"{name}, launch {launch}: differs from _scatter at "
                                            f"{int((got != want).sum())} values")
    crafted = crafted_sources(dev)
    for label, (c_src, c_g, c_n, c_c) in crafted.items():
        require(torch.equal(BG.feature_scatter(c_src, c_g, c_n, c_c), BG._scatter(c_src, c_g, c_n, c_c)),
                f"feature_scatter on crafted sources ({label}): differs from _scatter")

    def first_route():
        return BG.feature_scatter(BG.slot_sources(pre_xyz, mid_xyz, radius, K, _impl="first"), g, N,
                                  C)

    grad = BG.feature_grad(pre_xyz, mid_xyz, radius, K, g, C)
    cpu = BG.feature_grad(pre_xyz.cpu(), mid_xyz.cpu(), radius, K, g.cpu(), C)
    # all sum each point's slots from 0 in slot order: the same bits
    require(torch.equal(grad.cpu(), cpu), "ball_group feature gradient: card and CPU differ at "
                                          f"{int((grad.cpu() != cpu).sum())} values")
    require(torch.equal(first_route(), grad), "ball_group feature gradient: the first route "
                                              "differs")
    dist = feature_grad_parts.distribution(src, N)

    rows = torch.where(src >= 0, src.long() + N * torch.arange(B, device=dev)[:, None, None],
                       B * N).reshape(-1)
    feats = g[..., 3:].reshape(-1, C)
    atomics = torch.zeros(B * N + 1, C, dtype=torch.float32, device=dev)
    fns = {"sum": lambda: BG.feature_sum(g, lst, work, N, C),
           "index_put_": lambda: BG.feature_sum_plain(g, lst, work, N, C),
           "index_add_": lambda: atomics.index_add_(0, rows, feats),
           "scatter": lambda: BG.feature_scatter(src, g, N, C),
           "gradient": lambda: BG.feature_grad(pre_xyz, mid_xyz, radius, K, g, C),
           "first gradient": first_route}
    ms = {k: [] for k in fns}
    for turn in range(SOURCES_TURNS):
        for name in (list(fns) if turn % 2 == 0 else list(fns)[::-1]):
            ms[name].append(graph_ms(fns[name], 10))
    require(all(a < b for a, b in zip(ms["gradient"], ms["first gradient"])),
            f"ball_group feature gradient: the fused route is not faster than the first in every "
            f"turn: {ms['gradient']} against {ms['first gradient']}")
    turns = ms
    ms = {k: min(v) for k, v in ms.items()}
    eager = cuda_ms(lambda: BG.feature_grad(pre_xyz, mid_xyz, radius, K, g, C), 10)
    plain_grad = cuda_ms(lambda: BG.feature_grad_plain(pre_xyz, mid_xyz, radius, K, g, C), 3)
    eager = min(eager, cuda_ms(lambda: BG.feature_grad(pre_xyz, mid_xyz, radius, K, g, C), 10))
    # the bound: the grouped gradient's features read once, the feature gradient written once
    g_bound = (B * K * M * C + B * N * C) * 4 / HBM_BYTES_PER_S * 1e3
    print(f"feature_sum ({B}x{N}, M={M}, K={K}, C={C}): equals _scatter bit for bit on the masked "
          f"step's sources (two launches), as does feature_scatter there and on {len(crafted)} "
          f"crafted sets ({', '.join(crafted)}); the whole gradient on the card equals the CPU's and "
          f"the first route's bit for bit; slots a point: max {dist['max']}, mean "
          f"{dist['mean']:.2f}, p99 {dist['p99']:.1f}, named by no slot {dist['unnamed']:.4f}")
    print(f"feature_sum times (graph replays, in turns): the sum {ms['sum']:.4f} ms, index_put_ "
          f"{ms['index_put_']:.4f} ms, index_add_ {ms['index_add_']:.4f} ms (atomics: its sums' "
          f"order changes from run to run), feature_map and the sum {ms['scatter']:.4f} ms, bound "
          f"{g_bound:.4f} ms (bytes); the whole gradient: sources_map and the sum "
          f"{', '.join(f'{v:.4f}' for v in turns['gradient'])} ms, the first pick pass and "
          f"feature_scatter {', '.join(f'{v:.4f}' for v in turns['first gradient'])} ms; eager "
          f"{eager:.4f} ms, with the plain pick pass and _scatter {plain_grad:.3f} ms ({card})")
    return dict(max_abs_err=0.0, ms=ms["sum"], plain_ms=ms["index_put_"], bound_ms=g_bound,
                bound_by="bytes", library_ms=ms["index_add_"],
                library="index_add_: atomics, its sums' order changes from run to run",
                distribution=dist, scatter_ms=ms["scatter"], feature_grad_ms=ms["gradient"],
                feature_grad_first_ms=ms["first gradient"], feature_grad_eager_ms=eager,
                feature_grad_plain_ms=plain_grad, gradient_turns=turns["gradient"],
                first_gradient_turns=turns["first gradient"],
                design="feature_sum<64, 16> (a warp a point and 64 channels, rows staged by "
                       "cp.async, added in slot order) over the map of sources_map",
                work="one masked training step's backward: 8x2048, M=1024, K=32, C=256")


def check_radius_attention(pre_xyz, mid_xyz, dev: torch.device) -> dict:
    """Phase 7, attention: the three kernels with the radius bias at the
    masked encoder's layers (BH = 8 x 4 heads, D = 64): N = 2048 at r^2 =
    0.16^2 and N = 1024 at 0.64^2 and 1.44^2, the points the FPS picks of a
    ScanNet-shaped batch.  Returns their entries, summed over the three
    layers (one training step's calls)."""
    from ov3det_torch.ops.kernels import attention as A

    H, D, rate = 4, 64, 0.3
    seed = torch.tensor([20261016], dtype=torch.int32, device=dev)
    names = ("attention_fwd", "attention_dq", "attention_dkv")
    flops = {"attention_fwd": 4, "attention_dq": 6, "attention_dkv": 8}  # x in-radius pairs x D
    tot = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_ms_no_dropout=0.0, library_ms=0.0,
                   library_ms_dropout=0.0, ms_no_dropout=0.0, max_abs_err=0.0, bound_time={})
           for n in names}
    for n in names:
        tot[n].update(ms_previous_design=0.0, ms_previous_design_no_dropout=0.0)
    empty_tiles = []
    for xyz, r in ((pre_xyz, 0.4 ** 2), (mid_xyz, 0.8 ** 2), (mid_xyz, 1.2 ** 2)):
        B, N, _ = xyz.shape
        BH, r2 = B * H, r * r
        radius = (xyz, xyz, r2)
        inside = A.radius_mask(xyz, xyz, r2)
        share = inside.float().mean().item()
        # (q, k) tiles with no pair inside the radius: what skipping them could save
        empty = {T: 1.0 - inside.view(B, N // T, T, N // T, T).any(dim=4).any(dim=2).float().mean().item()
                 for T in (64, 128)}
        empty_tiles.append(dict(N=N, r2=r2, in_radius_share=share, empty_64x64=empty[64],
                                empty_128x128=empty[128]))
        want = inside.repeat_interleave(H, dim=0)
        for impl in (None, "mma"):
            for name, mask in reveal_masks(A, None, 0.0, BH, N, D, dev, radius, impl).items():
                flips = int((mask != want).sum())
                require(flips == 0, f"{name} (_impl={impl}) radius N={N} r2={r2:.4f}: the mask "
                                    f"differs at {flips} positions")
        del want, mask

        g = torch.Generator().manual_seed(N)
        q, k, v, do = (torch.randn(BH, N, D, generator=g).to(dev) for _ in range(4))
        qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
        worst = {n: 0.0 for n in names}
        for p in (0.0, rate):
            out, lse = A.attention_fwd(qb, kb, vb, p, seed, radius)
            f32 = [t.float() for t in (qb, kb, vb, dob)]
            ref, ref_lse = A.attention_fwd_plain(*f32[:3], p, seed, radius)
            delta = (dob.float() * out.float()).sum(-1, keepdim=True)
            got = {"attention_fwd": [out], "attention_dq": [
                A.attention_dq(qb, kb, vb, dob, lse, delta, p, seed, radius)],
                "attention_dkv": list(A.attention_dkv(qb, kb, vb, dob, lse, delta, p, seed, radius))}
            refs = {"attention_fwd": [ref],
                    "attention_dq": [A.attention_dq_plain(*f32, lse, delta, p, seed, radius)],
                    "attention_dkv": list(A.attention_dkv_plain(*f32, lse, delta, p, seed, radius))}
            for n in names:
                for a, b in zip(got[n], refs[n]):
                    err = (a.float() - b).abs().max().item()
                    tot[n]["max_abs_err"] = max(tot[n]["max_abs_err"], err)
                    worst[n] = max(worst[n], err / b.abs().max().item())
            e_lse = (lse - ref_lse).abs().max().item()
            # the first (mma.sync) design of the three kernels on the same inputs
            old_out, old_lse = A.attention_fwd(qb, kb, vb, p, seed, radius, _impl="mma")
            olds = [old_out, A.attention_dq(qb, kb, vb, dob, lse, delta, p, seed, radius, _impl="mma"),
                    *A.attention_dkv(qb, kb, vb, dob, lse, delta, p, seed, radius, _impl="mma")]
            e_old = max((a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                        for a, b in zip(got["attention_fwd"] + got["attention_dq"]
                                        + got["attention_dkv"], olds))
            require(e_old <= 2e-2 and (lse - old_lse).abs().max().item() <= 1e-3,
                    f"radius N={N} r2={r2:.4f} p={p}: the wgmma and mma.sync designs differ by {e_old}")
            out32, lse32 = A.attention_fwd(q, k, v, p, seed, radius)
            ref32, rlse32 = A.attention_fwd_plain(q, k, v, p, seed, radius)
            d32 = (do * out32).sum(-1, keepdim=True)
            pairs = [(out32, ref32), (lse32, rlse32),
                     (A.attention_dq(q, k, v, do, lse32, d32, p, seed, radius),
                      A.attention_dq_plain(q, k, v, do, lse32, d32, p, seed, radius))]
            pairs += list(zip(A.attention_dkv(q, k, v, do, lse32, d32, p, seed, radius),
                              A.attention_dkv_plain(q, k, v, do, lse32, d32, p, seed, radius)))
            e32 = max(((a - b).abs().max() / b.abs().max()).item() for a, b in pairs)
            require(max(worst.values()) <= 2e-2 and e_lse <= 1e-3 and e32 <= 1e-4,
                    f"radius N={N} r2={r2:.4f} p={p}: bf16 {worst}, lse {e_lse}, f32 {e32}")
        print(f"attention radius N={N} r2={r2:.4f}: in-radius share {share:.4f}; (q, k) tiles with "
              f"no in-radius pair: {empty[64]:.4f} of the 64x64, {empty[128]:.4f} of the 128x128; "
              f"the masks of the "
              f"forward, dq and dk/dv kernels equal the plain version's at all {BH * N * N} "
              f"positions; bf16 error over the largest plain value {max(worst.values()):.2e}, "
              f"lse {e_lse:.2e}; f32 {e32:.2e}")

        out, lse = A.attention_fwd(qb, kb, vb, rate, seed, radius)
        delta = (dob.float() * out.float()).sum(-1, keepdim=True)
        bwd = (qb, kb, vb, dob, lse, delta)
        # name -> (kernel(p, seed, impl), plain version with dropout)
        calls = {
            "attention_fwd": (lambda p, sd, impl=None: A.attention_fwd(qb, kb, vb, p, sd, radius,
                                                                       _impl=impl),
                              lambda: A.attention_fwd_plain(qb, kb, vb, rate, seed, radius)),
            "attention_dq": (lambda p, sd, impl=None: A.attention_dq(*bwd, p, sd, radius,
                                                                      _impl=impl),
                             lambda: A.attention_dq_plain(*bwd, rate, seed, radius)),
            "attention_dkv": (lambda p, sd, impl=None: A.attention_dkv(*bwd, p, sd, radius,
                                                                       _impl=impl),
                              lambda: A.attention_dkv_plain(*bwd, rate, seed, radius)),
        }
        # yardstick: PyTorch's fused attention with the (B, 1, N, N) boolean
        # mask, without dropout and with the kernels' rate; its backward
        # computes dq, dk and dv in one call
        q4, k4, v4 = (t.view(B, H, N, D).detach().requires_grad_() for t in (qb, kb, vb))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        mask4 = inside[:, None]
        g4 = dob.view(B, H, N, D)
        lib = {}
        for p in (0.0, rate):
            fwd_ms = cuda_ms(lambda: sdpa(q4, k4, v4, attn_mask=mask4, dropout_p=p), 10)
            o4 = sdpa(q4, k4, v4, attn_mask=mask4, dropout_p=p)
            bwd_ms = cuda_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True), 10)
            lib[p] = {"attention_fwd": fwd_ms, "attention_dq": bwd_ms, "attention_dkv": bwd_ms}
            del o4
        pairs_in = inside.sum().item() * H  # (bh, q, k) pairs inside the radius
        tensor = BH * N * D * 2
        nbytes = {"attention_fwd": 4 * tensor + BH * N * 4,
                  "attention_dq": 5 * tensor + 2 * BH * N * 4,
                  "attention_dkv": 6 * tensor + 2 * BH * N * 4}
        for n, (kernel, plain) in calls.items():
            ms, nd_ms, old_ms, old_nd = designs_in_turns(kernel, rate, seed, 10)
            require(ms <= old_ms and nd_ms <= old_nd,
                    f"{n}_radius N={N} r2={r2:.4f}: the wgmma design ({ms:.3f} / {nd_ms:.3f} ms) is "
                    f"slower than the mma.sync design ({old_ms:.3f} / {old_nd:.3f} ms)")
            tot[n]["ms_previous_design"] += old_ms
            tot[n]["ms_previous_design_no_dropout"] += old_nd
            was = f"; mma.sync design {old_ms:.3f} ms ({old_nd:.3f})"
            plain_ms = cuda_ms(plain, 2)
            # what this data needs: the products, exponentials and hashes of
            # the in-radius pairs, and the distance test of every (b, q, k)
            # pair (9 f32 operations)
            args = (nbytes[n] + 2 * B * N * 12, flops[n] * pairs_in * D, pairs_in)
            bound = attention_bound(*args, dropout=True, f32_ops=9 * B * N * N)
            bound_nd = attention_bound(*args, dropout=False, f32_ops=9 * B * N * N)
            print(f"{n}_radius N={N} r2={r2:.4f}: kernel {ms:.3f} ms with dropout {rate} "
                  f"({nd_ms:.3f} ms without){was}, plain {plain_ms:.3f} ms, library "
                  f"{lib[rate][n]:.3f} ms with dropout {rate} ({lib[0.0][n]:.3f} ms without) "
                  f"(SDPA with the boolean mask{', backward: dq, dk and dv' if n != 'attention_fwd' else ''})"
                  f", bound {bound['bound_ms']:.4f} ms ({bound['bound_term']})")
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("ms_no_dropout", nd_ms),
                             ("library_ms", lib[0.0][n]), ("library_ms_dropout", lib[rate][n]),
                             ("bound_ms", bound["bound_ms"]),
                             ("bound_ms_no_dropout", bound_nd["bound_ms"])):
                tot[n][key] += val
            bt = tot[n]["bound_time"]
            bt[bound["bound_term"]] = bt.get(bound["bound_term"], 0.0) + bound["bound_ms"]
        del q4, k4, v4, mask4, inside
    entries = {}
    for n in names:
        e = tot[n]
        bt = e.pop("bound_time")
        term = max(bt, key=bt.get)
        e["design"] = "wgmma, cp.async ring"
        entries[f"{n}_radius"] = dict(
            e, bound_by="bytes" if term == "bytes" else "operations", bound_term=term,
            empty_tiles=empty_tiles,
            work="one masked training step: N=2048 r2=0.0256 + N=1024 r2=0.4096 + N=1024 "
                 "r2=2.0736, BH=32, D=64 bf16, dropout 0.3; library: SDPA with the boolean "
                 "mask; max_abs_err of bf16 against the plain version in f32")
    return entries


# the synchronised stage "parse (empty-box test + NMS)" of one request as this
# script measured it before the empty-box test was a kernel, and the device
# memory the parse takes above its inputs as it measured it with the matmul
# test (`matmul_points_in_box`) and the kernel in turns in a later run (NVIDIA
# H100 80GB HBM3, 700.00 W)
EARLIER_PARSE_MS = {"sunrgbd": 2.42, "scannet_masked": 7.89}
EARLIER_PARSE_MIB = {"sunrgbd": 644.7, "scannet_masked": 2578.4}
# the graphed requests (host clock) and the synchronised parse stage as this
# script measured them with the first designs of the empty-box test and the
# first-K query (NVIDIA H100 80GB HBM3, 700.00 W)
FIRST_DESIGNS_REQUEST_MS = {"sunrgbd": "16.42-17.43", "scannet_masked": "22.72-23.12"}
FIRST_DESIGNS_PARSE_MS = {"sunrgbd": 0.60, "scannet_masked": 0.75}


def matmul_points_in_box(points: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """The empty-box test as the port ran it before its kernel: (B, K, N, 3)
    relative coordinates and projections, a batched f32 matmul over the three
    axes and `all`.  The path the kernel replaced, timed beside it; never an
    oracle (the matmul's order of the three products is cuBLAS's)."""
    depth = torch.stack([corners[..., 0], corners[..., 2], -corners[..., 1]], dim=-1)
    origin = depth[:, :, 0, :]
    edges = torch.stack([depth[:, :, j, :] - origin for j in (1, 3, 4)], dim=2)
    sq = (edges * edges).sum(dim=-1)
    rel = points[:, None, :, :] - origin[:, :, None, :]
    proj = torch.matmul(rel, edges.transpose(-1, -2))
    inside = ((proj >= -1e-6) & (proj <= sq[:, :, None, :] + 1e-6)).all(dim=-1)
    return inside.sum(dim=-1)


def stage_times(det, batch: dict, label: str, reps: int = 3) -> None:
    """Host-clock time of each stage of `Detector.detect`, each ended by a
    synchronize: the model's forward (pre-encoder, encoder, decoder, heads
    timed apart), the device parse (empty-box test + NMS) and the host
    assembly.  Medians of `reps` runs.  Then the device memory the parse
    takes above its inputs.  Both beside the matmul test's records
    (`EARLIER_PARSE_MS`, `EARLIER_PARSE_MIB`)."""
    from ov3det_torch.engine.infer import INPUT_KEYS
    from ov3det_torch.eval.parse import assemble_predictions, parse_predictions

    model = det.model
    marks = {}

    def mark(name):
        def hook(*_):
            torch.cuda.synchronize()
            marks[name] = time.perf_counter()
        return hook

    handles = [model.pre_encoder.register_forward_hook(mark("pre_encoder")),
               model.encoder.register_forward_hook(mark("encoder")),
               model.decoder.register_forward_hook(mark("decoder"))]
    interim = getattr(model, "interim_downsample", None)
    if interim is not None:
        handles.append(interim.register_forward_hook(mark("interim")))
    rows = []
    for _ in range(reps):
        inputs = {k: torch.as_tensor(batch[k]).to(det.device) for k in INPUT_KEYS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = det.eval_step(inputs)
            torch.cuda.synchronize()
            t_fwd = time.perf_counter()
            keep, _ = parse_predictions(out["box_corners"], out["sem_cls_prob"],
                                        out["objectness_prob"], inputs["point_clouds"])
            host = [t.cpu().numpy() for t in (out["box_corners"], out["sem_cls_prob"],
                                              out["objectness_prob"], keep)]
        t_parse = time.perf_counter()
        assemble_predictions(*host)
        t_end = time.perf_counter()
        row = {"pre_encoder (FPS + ball-group + SA MLP)": marks["pre_encoder"] - t0}
        if interim is not None:
            row["encoder layer 0 + interim SA"] = marks["interim"] - marks["pre_encoder"]
            row["encoder layers 1-2"] = marks["encoder"] - marks["interim"]
        else:
            row["encoder"] = marks["encoder"] - marks["pre_encoder"]
        rows.append({**row,
                     "projection + query FPS + decoder": marks["decoder"] - marks["encoder"],
                     "heads + box decode": t_fwd - marks["decoder"],
                     "parse (empty-box test + NMS)": t_parse - t_fwd,
                     "assemble (host)": t_end - t_parse})
    for h in handles:
        h.remove()
    parts = ", ".join(f"{k} {np.median([r[k] for r in rows]) * 1e3:.2f} ms" for k in rows[0])
    print(f"stages of one request (synchronised, median of {reps}): {parts}; the parse stage "
          f"before the kernel: {EARLIER_PARSE_MS[label]} ms, with the first designs: "
          f"{FIRST_DESIGNS_PARSE_MS[label]} ms (NVIDIA H100 80GB HBM3, 700.00 W)")
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        parse_predictions(out["box_corners"], out["sem_cls_prob"], out["objectness_prob"],
                          inputs["point_clouds"])
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    print(f"parse's device memory above its inputs: {peak:.1f} MiB (with the matmul empty-box "
          f"test: {EARLIER_PARSE_MIB[label]} MiB, NVIDIA H100 80GB HBM3, 700.00 W)")


def range_kernels(prof, name: str):
    """(device ms, kernel count, {kernel name: device ms}) of the kernels
    launched while the profiler range `name` (a `record_function`) was open
    on the host: each CUDA API call ("cu...") inside the
    range's host interval, on its thread (on any thread for the ranges of
    `ANY_THREAD_RANGES`: autograd launches the backward's kernels from
    threads of its own while the range's thread waits), matched to the
    device events of its correlation id.  (The kernels a wrapper launches
    through ctypes belong to no PyTorch op, so the ops' own kernel lists
    miss them.)  None when the range holds none."""
    cpu = torch.autograd.DeviceType.CPU
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end, e.thread) for e in events
             if e.name == name and e.device_type == cpu]
    own_thread = name not in ANY_THREAD_RANGES
    launched = {e.id for e in events
                if e.device_type == cpu and e.name.startswith("cu")
                and any(s <= e.time_range.start <= t and (e.thread == th or not own_thread)
                        for s, t, th in spans)}
    kernels = [(e.name, e.time_range.end - e.time_range.start) for e in events
               if e.device_type != cpu and e.name != name and e.id in launched]
    by_name = collections.Counter()
    for kernel, us in kernels:
        by_name[kernel] += us / 1e3
    return (sum(by_name.values()), len(kernels), dict(by_name)) if kernels else None


PROFILE_MARGIN_S = 0.2  # idle host time each side of a profiled call, inside the active window
# the training step's stages, profiler ranges of `engine.train.make_train_step`
# ("teacher" between "forward" and "criterion" in the OV step)
STEP_RANGES = ("forward", "criterion", "backward", "optimizer")
ANY_THREAD_RANGES = ("backward",)
STEP_RANGE_TOP = 5  # kernels printed under each range of a profiled training step
# counter -> the kernels its wrapper launches, one a launch, by their demangled
# symbols: the routed design and the first of each (the first ball-group's
# fill kernel stands for its pair); a tuple where a launch is several
# kernels, each once
OWN_KERNELS = {
    "fps": r"\bfps_(?:cluster_)?kernel<",
    "ball_group": r"\bball_group_tile<0, |\bfill_kernel\(float const\*, float const\*, float const\*, "
                  r"int const\*",
    "slot_sources": r"\bball_group_tile<1, ",
    "sources_map": r"\bfeature_sources_map\(",
    "feature_sum": r"\bfeature_sum<",
    "feature_scatter": (r"\bfeature_map\(", r"\bfeature_sum<"),
    **{f"attention_{k}{'_radius' if radius else ''}":
       rf"\battn_{k}_(?:wgmma<{str(radius).lower()}>|(?:bf16|f32)<\d+, {str(radius).lower()}>)\("
       for k in ("fwd", "dq", "dkv") for radius in (False, True)},
    "auction": r"\bauction_lap_kernel\(",
    "auction_first": r"\bauction_kernel\(",
    "nms": r"\bnms_(?:cluster_)?kernel<",
    "quant_conv": r"\bquant_conv_(?:wgmma|kernel)<",
    "pool_quantize": r"\bpool_quantize_(?:vec<[^<>]*, false>|kernel<)",
    "pool_quantize_affine": r"\bpool_quantize_vec<[^<>]*, true>",
    "normalise": r"\bnormalise_kernel<",
    "points_in_box": r"\bpoints_in_box_(?:cluster|kernel)\(",
    "first_k": r"\bfirst_k_(?:lanes<|kernel\()",
    "roi_align": r"\broi_align_(?:rows|kernel)<",
    "pool_tokens": r"\bpool_tokens_kernel<",
    "pool_attend": r"\bpool_attend_(?:cluster|kernel|mma)<",
    "bn_stats": (r"\bbn_stats_partial<", r"\bsums_finish<0>\("),
    "bn_relu_apply": r"\bbn_relu_apply(?:_pooled)?<",
    "bn_relu_grad_sums": (r"\bbn_grad_sums(?:_pooled)?<", r"\bsums_finish<1>\("),
    "bn_relu_grad_apply": r"\bbn_grad_apply(?:_pooled)?<",
    "add_norm": r"\badd_norm_fwd<",
    "add_norm_grad": r"\badd_norm_bwd<",
}


# the step's device time by module class (`profile(by_module=True)`,
# `profile_modules`): this script opens a profiler range around the methods of
# the detector's module classes while it profiles (the program's modules open
# none); a forward kernel belongs to the innermost such range open when it was
# launched, a backward kernel to the range of the forward op that made its
# autograd node (the profiler's sequence numbers); the rest is "rest".  The
# transformer's residual dropouts (`models.transformer.dropout`) are a class
# of their own: the residual's add itself runs in the layer's own code ("rest")
# before the add & norm kernels, inside `LayerNorm.add` after.
MODULE_CLASSES = ("LayerNorm (add & norm)", "GenericMLP BatchNorm, ReLU, dropout", "Dense",
                  "attention", "set abstraction", "transformer dropout", "rest")
MODULE_RANGE = "module: "
BACKWARD_NODE = "autograd::engine::evaluate_function: "


@contextlib.contextmanager
def module_ranges():
    """Profiler ranges `MODULE_RANGE + class` around `LayerNorm.forward` and
    `.add`, `GenericMLP.forward`, `Dense.forward`,
    `MultiheadAttention.forward`, `PointnetSAModule.forward` and the
    transformer's `dropout` while the block runs (a method a tree lacks is
    skipped: PR 23's tree has no `LayerNorm.add`)."""
    from ov3det_torch.models import mlp, pointnet, transformer

    targets = [(mlp.LayerNorm, "forward", 0), (mlp.LayerNorm, "add", 0),
               (mlp.GenericMLP, "forward", 1), (mlp.Dense, "forward", 2),
               (transformer.MultiheadAttention, "forward", 3),
               (pointnet.PointnetSAModule, "forward", 4), (transformer, "dropout", 5)]
    originals = [(obj, name, getattr(obj, name), MODULE_CLASSES[i]) for obj, name, i in targets
                 if hasattr(obj, name)]

    def ranged(fn, label):
        def call(*args, **kwargs):
            with torch.profiler.record_function(MODULE_RANGE + label):
                return fn(*args, **kwargs)
        return call

    for obj, name, fn, label in originals:
        setattr(obj, name, ranged(fn, label))
    try:
        yield
    finally:
        for obj, name, fn, _ in originals:
            setattr(obj, name, fn)


class _Spans:
    """Nested host intervals of one thread, sorted by start: the innermost
    one open at a time."""

    def __init__(self, spans: list):
        import bisect

        self.bisect = bisect.bisect_right
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]
        self.parent, stack = [], []
        for i, (s, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t):
        i = self.bisect(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return self.spans[i][2] if i >= 0 else None


def module_times(prof) -> dict:
    """{class: [forward ms, forward kernels, backward ms, backward kernels]}
    of the profiled call, by `MODULE_CLASSES` (see above); every device event
    (kernels, copies and fills) counted once."""
    cpu = torch.autograd.DeviceType.CPU
    events = prof.events()
    host = [e for e in events if e.device_type == cpu]
    ranges, nodes = collections.defaultdict(list), collections.defaultdict(list)
    for e in host:
        span = (e.time_range.start, e.time_range.end)
        if e.name.startswith(MODULE_RANGE):
            ranges[e.thread].append((*span, e.name[len(MODULE_RANGE):]))
        elif e.name.startswith(BACKWARD_NODE):
            nodes[e.thread].append((*span, e.sequence_nr))
    ranges = {th: _Spans(v) for th, v in ranges.items()}
    nodes = {th: _Spans(v) for th, v in nodes.items()}
    # each forward op's class, by its sequence number (ops outside a backward
    # node).  Ops that make no node (a mask's draw before the add & norm) show
    # the number the next node will take: the last op with a number made it
    made = {}
    for e in sorted(host, key=lambda e: e.time_range.start):
        if e.sequence_nr >= 0 and e.thread in ranges and not e.name.startswith("autograd::") \
                and (e.thread not in nodes or nodes[e.thread].at(e.time_range.start) is None):
            made[e.sequence_nr] = ranges[e.thread].at(e.time_range.start) or "rest"
    launch = {}
    for e in host:
        if not e.name.startswith("cu"):
            continue
        t = e.time_range.start
        seq = nodes[e.thread].at(t) if e.thread in nodes else None
        if seq is not None:
            launch[e.id] = (made.get(seq, "rest"), 2)
        else:
            label = ranges[e.thread].at(t) if e.thread in ranges else None
            launch[e.id] = (label or "rest", 0)
    # a profiler range leaves a device-side event spanning its kernels: not a kernel
    annotations = {e.name for e in host if getattr(e, "is_user_annotation", False)}
    annotations |= set(STEP_RANGES) | set(TEACHER_RANGES)
    table = {c: [0.0, 0, 0.0, 0] for c in MODULE_CLASSES}
    for e in events:
        if e.device_type == cpu or e.name.startswith(MODULE_RANGE) or e.name in annotations:
            continue
        label, col = launch.get(e.id, ("rest", 0))
        table[label][col] += (e.time_range.end - e.time_range.start) / 1e3
        table[label][col + 1] += 1
    return table


def print_module_times(title: str, table: dict) -> None:
    busy = max(sum(v[0] + v[2] for v in table.values()), 1e-9)
    print(f"{title}: device time by module class, forward + backward (the forward by the innermost "
          f"class range open at the launch, the backward by the sequence number of the forward op "
          f"that made its node), {busy:.2f} ms in {sum(v[1] + v[3] for v in table.values())} "
          "kernels:")
    for cls, (fm, fn, bm, bn) in table.items():
        print(f"   {cls:36s} {fm + bm:8.3f} ms in {fn + bn:5d} kernels ({(fm + bm) / busy:.3f}): "
              f"forward {fm:.3f} ms in {fn}, backward {bm:.3f} ms in {bn}")


def profile_modules(title: str, fn) -> dict:
    """`fn` twice under the profiler (a warm-up call, then the one it reads)
    with `module_ranges`; prints and returns `module_times`.  Reads no launch
    count, so that it runs on a tree of any slice."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    torch.cuda.synchronize()
    with module_ranges(), warnings.catch_warnings(), \
            torch.profiler.profile(activities=acts, schedule=schedule) as prof:
        warnings.filterwarnings("ignore", message=".*clears events at the end of each cycle")
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        prof.step()
    table = module_times(prof)
    print_module_times(title, table)
    return table


def attribution_step(card: str, cfg, label: str, seed: int, dev: torch.device) -> dict:
    """`profile_modules` on one eager training step of `cfg` (after a
    warm-up step), with the generic entry points every slice's tree has."""
    from ov3det_torch.engine.train import batch_to_device, build_training

    training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = batch_to_device(synthetic_batches(cfg, 1, seed)[0], dev)
    training.train_step(batch, gen)
    table = profile_modules(f"{label} eager step ({card})", lambda: training.train_step(batch, gen))
    del training
    gc.collect()
    torch.cuda.empty_cache()
    return table


def profile(title: str, fn, ranges: tuple = (), waits: bool = False, range_top: int = 0,
            by_module: bool = False) -> None:
    """Run `fn` twice under torch.profiler's schedule, a warm-up call (the
    profiler traces, and keeps nothing) and the active one; for the active
    call print the wall time, the device busy time (kernels only), the
    kernel count, the idle share, the top kernels and ops by device time and
    the port's own kernels; for each profiler range named in `ranges`, its
    kernels' device time, their share of the busy time and their count; with
    `waits`, the host's calls that wait for the card (stream and device
    synchronisations), each with its count and host time.  Every launch the
    wrappers count in the active call (`read_counts`, graph replays
    included) must be in the profile, kernel for kernel (`OWN_KERNELS`).
    With `range_top`, each range's `range_top` largest kernels by device
    time are printed under it.  With `by_module`, both calls run under
    `module_ranges` and the device time by module class is printed
    (`module_times`)."""
    import re

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with module_ranges() if by_module else contextlib.nullcontext(), warnings.catch_warnings(), \
            torch.profiler.profile(activities=acts, schedule=schedule) as prof:
        # one cycle: that the profiler keeps the events of the last cycle alone says nothing here
        warnings.filterwarnings("ignore", message=".*clears events at the end of each cycle")
        fn()
        torch.cuda.synchronize()
        prof.step()
        # an idle margin each side of the active call: a graphed masked
        # request lost its first kernels to a window that began at the call
        time.sleep(PROFILE_MARGIN_S)
        before = read_counts()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        after = read_counts()
        time.sleep(PROFILE_MARGIN_S)
        prof.step()
    counted = {n: after[n] - before[n] for n in after if after[n] != before[n] and n in OWN_KERNELS}

    def device_us(e):  # the attribute's name changed across PyTorch versions
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # kernels are the device events; a CPU op's self device time is that of
    # the kernels it launched, so the two groups are listed apart and only
    # the kernels are summed
    # a profiler range (record_function) also leaves a device-side event
    # spanning its kernels: not a kernel, and it would count them twice
    ranges_seen = set(ranges) | {e.name for e in prof.events()
                                 if getattr(e, "is_user_annotation", False)}
    rows = [e for e in prof.key_averages() if device_us(e) > 0 and e.key not in ranges_seen]
    kernels = sorted((e for e in rows if e.device_type != torch.autograd.DeviceType.CPU),
                     key=device_us, reverse=True)
    ops = sorted((e for e in rows if e.device_type == torch.autograd.DeviceType.CPU),
                 key=device_us, reverse=True)
    busy_us = sum(device_us(e) for e in kernels)
    if not kernels:
        print(f"{title}: wall {wall_us / 1e3:.2f} ms, device time not measured "
              "(the profiler recorded no device events)")
    else:
        print(f"{title}: wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
              f"in {sum(e.count for e in kernels)} kernels (idle share "
              f"{1 - busy_us / wall_us:.3f}), after a warm-up call under the profiler")
        for name in ranges:
            got = range_kernels(prof, name)
            print(f" range {name!r}: " + ("device time not measured (no kernel tied to it)"
                                          if got is None else
                                          f"{got[0]:.2f} ms of device time in {got[1]} kernels, "
                                          f"{got[0] * 1e3 / busy_us:.3f} of the busy time"))
            for kernel, ms in sorted((got or (0, 0, {}))[2].items(), key=lambda kv: -kv[1])[:range_top]:
                print(f"   {ms:9.3f} ms  {kernel[:100]}")
    pats = {n: (p,) if isinstance(p, str) else p for n, p in OWN_KERNELS.items()}
    seen = {n: [sum(e.count for e in kernels if re.search(pat, e.key)) for pat in ps]
            for n, ps in pats.items()}
    lost = {n: (c, seen[n]) for n, c in counted.items() if any(s != c for s in seen[n])}
    own = [e for e in kernels if any(re.search(pat, e.key) for ps in pats.values() for pat in ps)]
    require(not lost, f"{title}: launches the wrappers counted against the profile's kernels "
                      f"(counted, profiled): {lost}; the port's kernels in the profile: "
                      f"{[(e.key[:70], e.count) for e in own]}")
    print(f" every launch the wrappers counted is in the profile: "
          f"{ {n: c for n, c in sorted(counted.items())} }")
    for name, group in (("kernels", kernels[:12]), ("the port's own kernels", own),
                        ("ops, by the device time of their kernels", ops[:12])):
        print(f" {name}:")
        for e in group:
            print(f"  {device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    host = sorted((e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print(" ops, by host time (self, profiler on):")
    for e in host[:8]:
        print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    if by_module:
        print_module_times(title, module_times(prof))
    if waits:
        got = {e.key: e for e in host if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize")}
        print(" host waits for the card (profiler on): " + (", ".join(
            f"{k} x{e.count}, {e.self_cpu_time_total / 1e3:.3f} ms" for k, e in sorted(got.items()))
            or "none"))


def sync_points(title: str, fn) -> int:
    """Run `fn` once with CUDA's sync debug mode at "warn" and print each
    line of Python that made the host wait for the card (a copy to the
    host, a blocking copy from pageable host memory, `.item()`), with its
    count; a wait with no line of the package on the stack is printed with
    the innermost lines it has.  Returns the number of waits."""
    where = collections.Counter()
    package = os.path.join(HERE, "ov3det_torch")

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        # the innermost line of the package on the stack, else the innermost three
        stack = traceback.extract_stack()[:-1]
        if any(f.name == "set_sync_debug_mode" for f in stack):
            return  # the mode's own switch warns, which is no wait of `fn`
        ours = [f for f in stack if f.filename.startswith(package)]
        if ours:
            where[f"{os.path.relpath(ours[-1].filename, HERE)}:{ours[-1].lineno}"] += 1
        else:
            where[" < ".join(f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                             for f in reversed(stack[-3:]))
                  + f" ({os.path.basename(filename)}:{lineno})"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"{title}: {sum(where.values())} synchronising calls on the host"
          + "".join(f"\n  x{n:<3d} {line}" for line, n in sorted(where.items())))
    return sum(where.values())


def serve(cfg, batches: list, per_request: dict, label: str, dev: torch.device,
          card: str = "") -> tuple:
    """Phases 3 and 7: the serving path at full width, each request one
    CUDA-graph replay of the forward and the parse (`Detector.request`).
    Then (phase 15) the same requests eagerly from the same detector: the
    detections equal bit for bit, both timed.  With `card`, the last
    request's eval-mode norms are held by `check_add_norm`.  Returns the
    launch counts of the graphed requests and the NMS inputs of the last
    batch's outputs."""
    from ov3det_torch.engine.infer import INPUT_KEYS, Detector
    from ov3det_torch.eval.parse import points_in_box_counts

    det = Detector(cfg, device=dev, seed=0)
    require(det.request.graph, f"{label}: the request is not graphed on the card")
    det.detect(batches[0])  # warm-up and capture: cuBLAS handles, allocator
    reset_counts()
    got, ms = [], {True: [], False: []}
    for r, batch in enumerate(batches):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = det.detect(batch)
        ms[True].append((time.perf_counter() - t0) * 1e3)
        after = read_counts()
        delta = {n: after[n] - before[n] for n in after}
        require(delta == per_request, f"{label} request {r}: launches {delta}, expected {per_request}")
        require(len(dets) == BATCH, "one detection list per scene")
        for classes, corners, scores in dets:
            require(corners.shape[1:] == (8, 3) and len(classes) == len(scores) == len(corners),
                    "detection arrays disagree in shape")
            require(np.isfinite(corners).all() and np.isfinite(scores).all(), "non-finite detections")
        got.append(dets)
        print(f"{label} request {r} (graphed): {ms[True][-1]:.2f} ms, detections per scene "
              f"{[len(c) for c, _, _ in dets]}, launches { {n: c for n, c in delta.items() if c} }")
    counts = read_counts()

    # phase 15: the same requests eagerly, from the same detector
    det.request.graph = False
    for r, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = det.detect(batch)
        ms[False].append((time.perf_counter() - t0) * 1e3)
        for (gc, gb, gs), (ec, eb, es) in zip(got[r], dets):
            require(np.array_equal(gc, ec) and np.array_equal(gb, eb) and np.array_equal(gs, es),
                    f"{label} request {r}: graphed and eager detections differ")
    det.request.graph = True
    print(f"{label}: {len(batches)} graphed requests equal the eager ones bit for bit; request "
          f"(host clock to the detections) graphed {[round(x, 2) for x in ms[True]]} ms (with the "
          f"first designs: {FIRST_DESIGNS_REQUEST_MS[label]} ms), eager "
          f"{[round(x, 2) for x in ms[False]]} ms")
    stage_times(det, batches[-1], label)

    # one more request under the profiler: device time by kernel and idle share
    profile(f"profiled graphed {label} request", lambda: det.detect(batches[-1]))
    if card:
        check_add_norm(card, f"{label} request", record_add_norm_request(det, batches[-1]),
                       timed=False)

    # the NMS inputs of the last batch's outputs, for phase 15's kernel check
    with torch.inference_mode():
        inputs = {k: torch.as_tensor(batches[-1][k]).to(dev) for k in INPUT_KEYS}
        out = det.eval_step(inputs)
        corners = out["box_corners"]
        mins, maxs = corners.amin(dim=2), corners.amax(dim=2)
        nms_inputs = dict(
            aabb=torch.cat([mins, maxs], -1).contiguous(),
            bev=torch.cat([mins[..., 0:1], mins[..., 2:3], maxs[..., 0:1], maxs[..., 2:3]], -1),
            scores=out["objectness_prob"].contiguous(),
            classes=torch.argmax(out["sem_cls_prob"], dim=-1),
            valid=points_in_box_counts(inputs["point_clouds"], corners) >= 5,
            points=inputs["point_clouds"][..., :3].contiguous(), corners=corners.contiguous())
    del det
    return counts, nms_inputs


def card_vs_cpu(batch: dict) -> None:
    """Phase 4: the same weights at f32 on the card and on the CPU."""
    from ov3det_torch.config import sunrgbd_quick
    from ov3det_torch.models.detr3d import Model3DETR

    cfg = dataclasses.replace(sunrgbd_quick().model, compute_dtype="float32")
    scene = {k: torch.from_numpy(batch[k][:1]) for k in
             ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")}
    outs = {}
    for device in ("cuda", "cpu"):
        model = Model3DETR(cfg, device=device, seed=1)
        with torch.inference_mode():
            out = model({k: t.to(device) for k, t in scene.items()})
        outs[device] = {k: v.cpu() for k, v in out.items()}
    require(torch.equal(outs["cuda"]["query_inds"], outs["cpu"]["query_inds"]),
            "query indices differ between card and CPU")
    err = (outs["cuda"]["box_corners"] - outs["cpu"]["box_corners"]).abs().max().item()
    require(err <= 1e-3, f"box corners differ between card and CPU by {err}")
    print(f"card vs CPU (f32, one scene): query indices equal, box_corners max err {err:.2e}")


def scannet_masked():
    """3DETR-m: scannet_quick with the masked encoder and the matcher and loss
    weights of reference scripts/scannet_masked_ep1080.sh, built as
    scripts/scannet_masked_timing.py builds it."""
    from ov3det_torch.config import EncoderConfig, LossConfig, MatcherConfig, scannet_quick

    base = scannet_quick()
    return dataclasses.replace(
        base, model=dataclasses.replace(base.model, encoder=EncoderConfig(kind="masked", dropout=0.3)),
        loss=LossConfig(matcher=MatcherConfig(cost_class=1.0, cost_objectness=0.0, cost_center=0.0,
                                              cost_giou=2.0),
                        giou_weight=1.0, no_object_weight=0.25))


def synthetic_batches(cfg, n: int, seed: int) -> list:
    """n seeded synthetic numpy batches of `cfg`'s data part."""
    from ov3det_torch.datasets.synthetic import make_batch

    return [make_batch(np.random.default_rng(seed + i), batch_size=cfg.data.batch_size_per_device,
                       num_points=cfg.data.num_points, max_num_obj=cfg.data.max_num_obj,
                       num_semcls=cfg.model.num_semcls, num_angle_bin=cfg.model.num_angle_bin)
            for i in range(n)]


def train(cfg, steps: int, per_step: dict, label: str, seed: int, dev: torch.device,
          teacher=None, batches=None) -> dict:
    """Phases 5, 7 and 10: training steps at full width on the card (with
    the 2D teacher and numpy `batches` of its schema in phase 10); returns
    the launch counts of the timed steps."""
    from ov3det_torch.engine.train import batch_to_device, build_training

    training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0, teacher=teacher)
    step = training.train_step
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [batch_to_device(b, dev)
               for b in batches or synthetic_batches(cfg, steps + 1, seed)]
    n_losses = 7 + (teacher is not None)  # loss_2dalignment beside the point losses

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(batches[0], gen)  # warm-up: cuBLAS handles, allocator
    print(f"{label} train warm-up step: {(time.perf_counter() - t0) * 1e3:.2f} ms, "
          f"loss {metrics['loss'].item():.4f}")
    reset_counts()
    for i, batch in enumerate(batches[1:]):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = read_counts()
        delta = {n: after[n] - before[n] for n in after}
        loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
        require(delta == per_step, f"{label} train step {i}: launches {delta}, expected {per_step}")
        require(math.isfinite(loss) and math.isfinite(gnorm),
                f"{label} train step {i}: loss {loss}, grad_norm {gnorm}")
        require(len(metrics) == cfg.model.decoder.num_layers * n_losses + 2,
                f"{label} train step {i}: {len(metrics)} metrics")
        if teacher is not None:
            align = metrics["loss_2dalignment"].item()
            require(math.isfinite(align) and align > 0,
                    f"{label} train step {i}: loss_2dalignment {align}")
        extra = "" if teacher is None else f", loss_2dalignment {align:.4f}"
        print(f"{label} train step {i}: {ms:.2f} ms, loss {loss:.4f}{extra}, grad_norm {gnorm:.4f}, "
              f"lr {training.schedule(training.optimizer.count - 1):.3e}, launches "
              f"{ {n: c for n, c in delta.items() if c} }")
    counts = read_counts()

    # a synchronised split of a step, median of 3
    rows = []
    for batch in batches[1:4]:
        marks = []

        def mark(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, gen, mark=mark)
        times = [t for _, t in marks]
        rows.append({name: (t - prev) * 1e3 for (name, t), prev in zip(marks, [t0] + times[:-1])})
    parts = ", ".join(f"{k} {np.median([r[k] for r in rows]):.2f} ms" for k in rows[0])
    L, Q, G = cfg.model.decoder.num_layers, cfg.model.num_queries, cfg.data.max_num_obj
    print(f"stages of one {label} train step (synchronised, median of 3): {parts} "
          f"(criterion = GIoU over {L}x{BATCH}x{Q}x{G} pairs, auction, losses)")

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step(batches[1], gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory of a {label} train step: {peak / 2**30:.3f} GiB "
          f"({base / 2**30:.3f} GiB held before it: weights, Adam moments, batches)")
    ranges = STEP_RANGES if teacher is None else ("forward", "teacher", *STEP_RANGES[1:],
                                                  *TEACHER_RANGES)
    profile(f"profiled {label} train step", lambda: step(batches[2], gen), ranges=ranges,
            waits=teacher is not None, range_top=STEP_RANGE_TOP, by_module=teacher is None)
    if teacher is not None:
        sync_points(f"one {label} train step under the sync debug mode",
                    lambda: step(batches[3], gen))
    return counts


def f32_no_dropout(cfg):
    """`cfg` with its detector in f32 and every dropout at 0."""
    model = dataclasses.replace(
        cfg.model, compute_dtype="float32", mlp_dropout=0.0,
        encoder=dataclasses.replace(cfg.model.encoder, dropout=0.0),
        decoder=dataclasses.replace(cfg.model.decoder, dropout=0.0))
    return dataclasses.replace(cfg, model=model)


def train_card_vs_cpu(base, label: str, seed: int) -> None:
    """Phases 6 and 7: one f32 training step with every dropout at 0 on one
    scene at full width, on the card and on the CPU, from the same weights."""
    from ov3det_torch.engine.train import batch_to_device, build_training
    from ov3det_torch.losses.criterion import compute_assignments

    cfg = f32_no_dropout(base)
    scene = {k: v[:1] for k, v in synthetic_batches(cfg, 1, seed)[0].items()}
    res = {}
    for name in ("cuda", "cpu"):
        dev = torch.device(name)
        batch = batch_to_device(scene, dev)
        training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=1)
        model = training.model
        gen = torch.Generator(device=dev).manual_seed(0)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        model.train()
        with torch.no_grad():  # the matcher's masks of this step
            out = model({k: batch[k] for k in ("point_clouds", "point_cloud_dims_min",
                                                "point_cloud_dims_max")}, gen)
            targets = dict(batch, nactual_gt=batch["gt_box_present"].sum(1).long())
            assign = compute_assignments(out, targets, cfg.loss,
                                         rotated_boxes=cfg.model.num_angle_bin > 1)
        model.load_state_dict(start)  # the probe moved the running statistics
        t0 = time.perf_counter()
        metrics = training.train_step(batch, gen)
        res[name] = ({k: v.cpu() for k, v in assign.items()},
                     {k: v.item() for k, v in metrics.items()})
        print(f"{label} f32 train step on {name}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    (a_gpu, m_gpu), (a_cpu, m_cpu) = res["cuda"], res["cpu"]
    for k in ("per_prop_gt_inds", "proposal_matched_mask"):
        require(torch.equal(a_gpu[k], a_cpu[k]), f"{label} card vs CPU: {k} differ")
    worst = max(abs(m_gpu[k] - v) / max(abs(v), 1e-6) for k, v in m_cpu.items() if k != "grad_norm")
    g_err = abs(m_gpu["grad_norm"] - m_cpu["grad_norm"]) / m_cpu["grad_norm"]
    require(worst <= 1e-4, f"{label} card vs CPU: a loss differs by {worst} relative")
    require(g_err <= 1e-3, f"{label} card vs CPU: grad_norm differs by {g_err} relative")
    print(f"{label} card vs CPU (f32 train step, one scene, dropout 0): matched masks equal, "
          f"losses within {worst:.2e} relative, grad_norm {m_gpu['grad_norm']:.5f} vs "
          f"{m_cpu['grad_norm']:.5f} ({g_err:.2e})")


# ------------------------------------------- the set abstraction's shared MLP
SA_REPS = 3  # calls a timing graph of one shared-MLP pass
SA_SUMS_REL = 1e-5  # sum y, sum y^2 and the means against f64 sums, of the largest value
SA_GRAD_REL = 1e-4  # dweight and dbias (the backward's two sums), of the largest value
SA_DY_REL = 1e-3  # dy: within one bf16 ulp, or this much of the largest value
SA_OUT_REL = 1e-4  # the whole Function's f32 output against the module's, of the largest value
SA_MOVED_SHARE = 1e-4  # an f32 pooled width: units whose maximum an ulp moved, at most this share
SA_CHECKED = {}  # label -> check_bn_relu's result: every run whose widths were held


@contextlib.contextmanager
def spy_sa(model):
    """`models.pointnet.bn_relu` spied on while the block runs: for each call
    of `model`'s SA modules, in order, a dict of its module and width
    (`name`), the Dense output `y`, the BatchNorm's `state` before the call
    (weight, bias, running statistics), `eps` and mode (`training`), the
    slot `axis` (None at a hidden width) and, from a hook on the output where
    it takes a gradient, the gradient the backward handed it (`grad`)."""
    from ov3det_torch.models import pointnet

    names = {}
    for module in ("pre_encoder", "interim_downsample"):
        sa_module = getattr(model, module, None)
        for i, norm in enumerate(sa_module.norms if sa_module is not None else ()):
            names[id(norm)] = f"{module} width {i} ({norm.weight.shape[0]} channels)"
    records, original = [], pointnet.bn_relu

    def spy(y, norm, pool_axis=None):
        rec = dict(name=names[id(norm)], y=y.detach().clone(), axis=pool_axis, eps=norm.eps,
                   training=norm.training,
                   state={k: v.detach().clone() for k, v in norm.state_dict().items()})
        out = original(y, norm, pool_axis)
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__("grad", g.detach().clone()))
        records.append(rec)
        return out

    pointnet.bn_relu = spy
    try:
        yield records
    finally:
        pointnet.bn_relu = original


def record_sa(cfg, batch: dict, dev: torch.device) -> list:
    """One eager training step of `cfg` (after a warm-up step) under
    `spy_sa`: every width's records, each with its `grad`."""
    from ov3det_torch.engine.train import batch_to_device, build_training

    training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    b = batch_to_device(batch, dev)
    training.train_step(b, gen)  # warm-up
    with spy_sa(training.model) as records:
        training.train_step(b, gen)
    torch.cuda.synchronize()
    require(all("grad" in r and r["training"] for r in records),
            "record_sa: a width got no gradient")
    del training
    gc.collect()
    torch.cuda.empty_cache()
    return records


def record_sa_request(det, batch: dict) -> list:
    """One request's eager forward (`Detector.eval_step`, the graphed
    request's own function) under `spy_sa`: every width's records in eval
    mode (the running statistics), with no gradient."""
    from ov3det_torch.engine.infer import INPUT_KEYS

    inputs = {k: torch.as_tensor(np.asarray(batch[k], np.float32)).to(det.device)
              for k in INPUT_KEYS}
    with spy_sa(det.model) as records:
        det.eval_step(inputs)
    torch.cuda.synchronize()
    require(records and not any(r["training"] or "grad" in r for r in records),
            "record_sa_request: expected eval-mode widths without gradients")
    for rec in records:  # plain tensors, out of inference mode
        rec["y"] = rec["y"].clone()
        rec["state"] = {k: v.clone() for k, v in rec["state"].items()}
    return records


def sa_norm(rec: dict):
    """A `BatchNorm` in the recorded state and mode on the record's
    device."""
    from ov3det_torch.models.mlp import BatchNorm

    norm = BatchNorm(rec["y"].shape[-1], rec["eps"]).to(rec["y"].device)
    norm.load_state_dict(rec["state"])
    return norm.train(rec["training"])


def values_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same dtype and shape, NaN positions, and values elsewhere (-0
    equal to +0: the ReLU of either)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a.masked_fill(na, 0), b.masked_fill(nb, 0))


def rel_err(got: torch.Tensor, want: torch.Tensor, rows: bool = False) -> float:
    """max |got - want| over max |want| (of each row of a (2, C) pair of sums
    with `rows`); NaN positions must agree (else inf)."""
    got, want = got.double(), want.double()
    na, nw = torch.isnan(got), torch.isnan(want)
    if not torch.equal(na, nw):
        return math.inf
    got, want = got.masked_fill(na, 0), want.masked_fill(nw, 0)
    if rows:
        return max(rel_err(g, w) for g, w in zip(got, want))
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def dy_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """`bf16_ulps` of dy, floored at SA_DY_REL of the largest value, with
    NaN positions equal (else inf)."""
    na, nw = torch.isnan(got), torch.isnan(want)
    if not torch.equal(na, nw):
        return math.inf
    got, want = got.float().masked_fill(na, 0), want.float().masked_fill(nw, 0)
    return bf16_ulps(got, want, floor=max(SA_DY_REL * want.abs().max().item(), 1e-30))


def sa_vjp(fn, y: torch.Tensor, norm, axis, grad: torch.Tensor) -> tuple:
    """(output, dy, dweight, dbias) of fn(y, norm, axis) with `grad`."""
    yr = y.detach().clone().requires_grad_()
    out = fn(yr, norm, axis)
    dy, dw, db = torch.autograd.grad(out, [yr, norm.weight, norm.bias], grad.to(out.dtype))
    return out.detach(), dy, dw, db


def sa_bytes(y: torch.Tensor, axis) -> dict:
    """The bytes each kernel must move at y's shape: each input read once,
    each output written once (the per-channel vectors included, the partial
    sums not)."""
    C, e = y.shape[-1], y.element_size()
    n = y.numel()
    pooled = 0 if axis is None else n // y.shape[axis] * 4  # a (B, M, C) f32 tensor
    vec = 4 * C
    if axis is None:
        return {"bn_stats": n * e + 2 * vec, "bn_relu_apply": 2 * n * e + 3 * vec,
                "bn_relu_grad_sums": 2 * n * e + 6 * vec, "bn_relu_grad_apply": 3 * n * e + 7 * vec}
    return {"bn_stats": n * e + 2 * vec, "bn_relu_apply": n * e + pooled + 3 * vec,
            "bn_relu_grad_sums": n * e + 3 * pooled + 6 * vec,
            "bn_relu_grad_apply": 2 * n * e + 2 * pooled + 7 * vec}


# f32 operations an element of each kernel: the sums 3 (an add, a fused
# square-add); the value 4 (sub, mul, add, the ReLU); the gradient's sums the
# value, the mask and xhat (2) and their two sums (3); its apply the value,
# the mask, xhat and the closed form (4)
SA_OPS = {"bn_stats": 3, "bn_relu_apply": 5, "bn_relu_grad_sums": 10, "bn_relu_grad_apply": 11}


def sa_dy_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """dy's error in units of its gate: bf16 ulps (`dy_ulps`) for bf16, the
    share of SA_GRAD_REL of the largest value for f32; at most 1 passes."""
    if got.dtype == torch.bfloat16:
        return dy_ulps(got, want)
    return rel_err(got, want) / SA_GRAD_REL


def check_sa_record(rec: dict) -> dict:
    """The kernels on one recorded width against their plain versions
    (`check_bn_relu`); returns this width's errors.  A training record
    holds all four, its backward at the batch statistics; an eval-mode
    record (a request's: no gradient) the statistics and the forward."""
    from ov3det_torch.models import pointnet
    from ov3det_torch.ops.kernels import bn_relu as bk

    y, axis, label = rec["y"], rec["axis"], rec["name"]
    training, grad = rec["training"], rec.get("grad")
    C = y.shape[-1]
    P = y.numel() // C
    dims = tuple(range(y.dim() - 1))
    errs = {}

    # the statistics: two launches equal, against f64 sums
    s1, s2 = bk.bn_stats(y), bk.bn_stats(y)
    x64 = y.double().reshape(-1, C)
    ref = torch.stack([x64.sum(0), (x64 * x64).sum(0)])
    require(bits_equal(s1, s2), f"bn_stats ({label}): two launches differ")
    errs["sums"] = rel_err(s1, ref, rows=True)
    errs["means"] = rel_err(s1 / P, ref / P, rows=True)
    errs["plain sums"] = rel_err(bk.bn_stats_plain(y), ref, rows=True)
    require(errs["sums"] <= SA_SUMS_REL and errs["means"] <= SA_SUMS_REL,
            f"bn_stats ({label}): sums {errs['sums']:.2e}, means {errs['means']:.2e} of the largest "
            f"value against f64 sums")
    errs["bn_stats"] = (s1.double() - ref).abs().max().item()

    # the apply pass given the module's own statistics (the batch's in
    # training, and the running ones); the backward at the batch's
    norm = sa_norm(rec)
    stats = {"running": (norm.running_mean, norm.running_var, None)}
    if training:
        x = y.float()
        mean = x.mean(dims)
        var_raw = (x * x).mean(dims) - mean * mean
        stats = {"batch": (mean, torch.clamp(var_raw, min=0.0), var_raw), **stats}
    for which, (m, v, raw) in stats.items():
        s = torch.rsqrt(v + norm.eps)
        scale = s * norm.weight.detach()
        bias = norm.bias.detach()
        out, again = (bk.bn_relu_apply(y, m, scale, bias, axis) for _ in range(2))
        want = bk.bn_relu_apply_plain(y, m, scale, bias, axis)
        require(values_equal(out, want) and bits_equal(out, again),
                f"bn_relu_apply ({label}, {which} statistics): the kernel differs from the plain "
                "version or itself")
        if which == "running":
            errs.setdefault("bn_relu_apply", 0.0)
            continue
        errs["bn_relu_apply"] = 0.0
        pooled = out if axis is not None else None
        (sums, q), (sums2, q2) = (bk.bn_relu_grad_sums(y, grad, m, scale, bias, s, axis, pooled)
                                  for _ in range(2))
        want_sums, want_q = bk.bn_relu_grad_sums_plain(y, grad, m, scale, bias, s, axis, pooled)
        require(bits_equal(sums, sums2) and (q is None or bits_equal(q, q2)),
                f"bn_relu_grad_sums ({label}): two launches differ")
        require(q is None or values_equal(q, want_q),
                f"bn_relu_grad_sums ({label}): q = grad / ties differs from the plain version")
        e_sums = rel_err(sums, want_sums, rows=True)
        require(e_sums <= SA_GRAD_REL, f"bn_relu_grad_sums ({label}): {e_sums:.2e} of the largest "
                                       "value")
        dy, dy2 = (bk.bn_relu_grad_apply(y, grad, m, scale, bias, s, sums, float(P), raw, axis,
                                         pooled, q) for _ in range(2))
        want_dy = bk.bn_relu_grad_apply_plain(y, grad, m, scale, bias, s, sums, float(P), raw,
                                              axis, pooled, q)
        e_dy = sa_dy_err(dy, want_dy)
        require(bits_equal(dy, dy2) and e_dy <= 1.0,
                f"bn_relu_grad_apply ({label}): {e_dy:.2f} of its gate (one bf16 ulp or "
                f"{SA_DY_REL} of the largest value in bf16, {SA_GRAD_REL} in f32), or two launches "
                "differ")
        errs["bn_relu_grad_sums"] = (sums - want_sums).abs().max().item()
        errs["bn_relu_grad_apply"] = (dy.float() - want_dy.float()).abs().max().item()
        errs["grad sums"], errs["dy"], errs["q"] = e_sums, e_dy, q

    # the whole Function against the module chain (its autograd in training;
    # an f32 record's gradients against the expression's VJP in f64)
    na, nb = sa_norm(rec), sa_norm(rec)
    kern = lambda t, n, a: pointnet.BnRelu.apply(t, n.weight, n.bias, n, a)  # noqa: E731
    if training:
        want = sa_vjp(pointnet.bn_relu_plain, y, na, axis, grad)
        got = sa_vjp(kern, y, nb, axis, grad)
    else:
        with torch.no_grad():
            want, got = (pointnet.bn_relu_plain(y, na, axis),), (kern(y, nb, axis),)
    errs["chain out"] = dy_ulps(got[0], want[0]) if got[0].dtype == torch.bfloat16 else \
        rel_err(got[0], want[0]) / SA_OUT_REL
    errs["chain running"] = max(rel_err(nb.running_mean, na.running_mean),
                                rel_err(nb.running_var, na.running_var))
    gates = errs["chain out"] <= 1.0 and errs["chain running"] <= SA_SUMS_REL
    if training and y.dtype == torch.bfloat16:
        errs["chain dy"] = sa_dy_err(got[1], want[1])
        errs["chain dweight"], errs["chain dbias"] = rel_err(got[2], want[2]), rel_err(got[3], want[3])
    elif training:
        ref, keep, errs["moved units"], units = sa_vjp64(rec)
        errs["moved share"] = errs["moved units"] / units
        errs["chain dy"] = rel_err(got[1][keep], ref[0][keep]) / SA_GRAD_REL
        errs["module dy"] = rel_err(want[1][keep], ref[0][keep])
        errs["chain dweight"], errs["chain dbias"] = rel_err(got[2], ref[1]), rel_err(got[3], ref[2])
        gates = gates and errs["moved share"] <= SA_MOVED_SHARE
    if training:
        gates = gates and errs["chain dy"] <= 1.0 and \
            max(errs["chain dweight"], errs["chain dbias"]) <= SA_GRAD_REL
    else:
        gates = gates and all(bits_equal(a, b) for a, b in zip(nb.buffers(), sa_norm(rec).buffers()))
    require(gates, f"the shared MLP's kernels ({label}) against the module chain: "
                   f"{ {k: v for k, v in errs.items() if k != 'q'} }")
    return errs


def sa_vjp64(rec: dict) -> tuple:
    """The module expression's VJP in f64 on an f32 training record's y,
    weight, bias and gradient: ((dy, dweight, dbias), keep, moved, units).
    The Function's f32 values (its statistics from `bn_stats`) decide what
    an ulp of a statistic can move.  At the pooled width `keep` leaves out
    the slots of each unit whose maximum, or whether it is above 0, differs
    between the f64 values and the f32 ones: one ulp moves a near-tie's
    gradient to another slot; `moved` counts those units of `units`.  At a
    hidden width `keep` is all of y and each ReLU takes the f32 value's side
    of 0 (the VJP jumps there: a value within an ulp of 0 may fall on the
    other side in f64); `moved` counts the values whose side differs, of
    `units` values."""
    from ov3det_torch.ops.kernels import bn_relu as bk

    y, axis, eps = rec["y"], rec["axis"], rec["eps"]
    norm = sa_norm(rec)
    m, v, _, _ = norm.statistics(bk.bn_stats(y), y.numel() // y.shape[-1])
    sc = torch.rsqrt(v + norm.eps)
    r32 = bk.bn_relu_apply_plain(y, m, sc * norm.weight.detach(), norm.bias.detach())
    y64 = y.double().requires_grad_()
    w64, b64 = (rec["state"][k].double().requires_grad_() for k in ("weight", "bias"))
    dims = tuple(range(y.dim() - 1))
    mean = y64.mean(dims)
    var = torch.clamp((y64 * y64).mean(dims) - mean * mean, min=0.0)
    pre64 = (y64 - mean) * (torch.rsqrt(var + eps) * w64) + b64
    if axis is None:
        out = torch.where((r32 > 0) | torch.isnan(r32), pre64, 0.0)  # the f32 side of 0
        ref = torch.autograd.grad(out, [y64, w64, b64], rec["grad"].double())
        moved = int(((r32 > 0) != (pre64.detach() > 0)).sum().item())
        return ref, torch.ones_like(y, dtype=torch.bool), moved, y.numel()
    r64 = torch.relu(pre64)
    ref = torch.autograd.grad(r64.amax(axis), [y64, w64, b64], rec["grad"].double())

    def at_max(t):
        return (t == t.amax(axis, keepdim=True)) & (t > 0)

    moved = (at_max(r32) != at_max(r64.detach())).any(axis, keepdim=True)
    units = moved.numel()
    return ref, (~moved).expand_as(y), int(moved.sum().item()), units


def check_sa_crafted(rec: dict) -> None:
    """All slots of every unit tied (slot 0 copied over the slot axis: q must
    be grad / K) and NaN in y, each through `check_sa_record`."""
    y, axis, grad = rec["y"], rec["axis"], rec["grad"]
    K = y.shape[axis]
    tied = y.narrow(axis, 0, 1).expand_as(y).contiguous()
    for case, t in (("all slots tied", tied), ("NaN in y", sprinkle(y, [float("nan")], 64, 31))):
        errs = check_sa_record(dict(rec, y=t, name=f"{rec['name']}, {case}"))
        if case == "all slots tied":
            q = errs["q"]
            live = ~torch.isnan(q)
            require(values_equal(q[live], (grad / K)[live]),
                    f"bn_relu_grad_sums ({rec['name']}, all slots tied): q is not grad / {K}")
    print(f"shared MLP ({rec['name']}): all slots tied (q = grad / {K}) and NaN in y through every "
          "gate of the width's check")


def time_sa_record(rec: dict) -> dict:
    """In turns by graph replays (`in_turns`): each kernel and its plain
    version on the record's inputs, the forward and the forward + backward
    through the kernels (`BnRelu`) and through the module chain, and the
    library calls: for the pairs `F.batch_norm(training=True)` and the ReLU
    forward, and `native_batch_norm_backward` after the ReLU's
    `threshold_backward`; for `bn_stats` `torch.batch_norm_stats` (each
    channel's mean and inverse deviation), for `bn_relu_grad_sums`
    `torch.batch_norm_backward_reduce` on the ReLU-masked gradient (sum g and
    sum g (y - mean): dbias and, scaled, dweight).  A library call is None
    where the library refuses the inputs."""
    import torch.nn.functional as F

    from ov3det_torch.models import pointnet
    from ov3det_torch.ops.kernels import bn_relu as bk

    y, axis, grad = rec["y"], rec["axis"], rec["grad"]
    C = y.shape[-1]
    P = y.numel() // C
    norm = sa_norm(rec)
    x = y.float()
    dims = tuple(range(y.dim() - 1))
    mean = x.mean(dims)
    var_raw = (x * x).mean(dims) - mean * mean
    s = torch.rsqrt(torch.clamp(var_raw, min=0.0) + norm.eps)
    scale, bias = s * norm.weight.detach(), norm.bias.detach()
    pooled = bk.bn_relu_apply(y, mean, scale, bias, axis) if axis is not None else None
    sums, q = bk.bn_relu_grad_sums(y, grad, mean, scale, bias, s, axis, pooled)
    nk, npl = sa_norm(rec), sa_norm(rec)
    yk, yp = (y.detach().clone().requires_grad_() for _ in range(2))

    def chain(fn, t, n, backward):
        if not backward:
            with torch.no_grad():
                return fn(t, n)
        out = fn(t, n)
        return torch.autograd.grad(out, [t, n.weight, n.bias], grad.to(out.dtype))

    kern = lambda t, n: pointnet.BnRelu.apply(t, n.weight, n.bias, n, axis)  # noqa: E731
    plain = lambda t, n: pointnet.bn_relu_plain(t, n, axis)  # noqa: E731
    runs = {
        "bn_stats": lambda: bk.bn_stats(y),
        "bn_stats plain": lambda: bk.bn_stats_plain(y),
        "bn_relu_apply": lambda: bk.bn_relu_apply(y, mean, scale, bias, axis),
        "bn_relu_apply plain": lambda: bk.bn_relu_apply_plain(y, mean, scale, bias, axis),
        "bn_relu_grad_sums": lambda: bk.bn_relu_grad_sums(y, grad, mean, scale, bias, s, axis,
                                                          pooled),
        "bn_relu_grad_sums plain": lambda: bk.bn_relu_grad_sums_plain(y, grad, mean, scale, bias,
                                                                      s, axis, pooled),
        "bn_relu_grad_apply": lambda: bk.bn_relu_grad_apply(y, grad, mean, scale, bias, s, sums,
                                                            float(P), var_raw, axis, pooled, q),
        "bn_relu_grad_apply plain": lambda: bk.bn_relu_grad_apply_plain(
            y, grad, mean, scale, bias, s, sums, float(P), var_raw, axis, pooled, q),
        "kernels forward": lambda: chain(kern, yk, nk, False),
        "kernels forward + backward": lambda: chain(kern, yk, nk, True),
        "module forward": lambda: chain(plain, yp, npl, False),
        "module forward + backward": lambda: chain(plain, yp, npl, True),
    }
    yl = y.detach().reshape(-1, C)
    gl = grad.reshape(-1, C).to(y.dtype) if axis is None else yl
    w, b = norm.weight.detach(), norm.bias.detach()
    rm, rv = norm.running_mean.clone(), norm.running_var.clone()
    library = ("library forward", "library backward", "bn_stats library",
               "bn_relu_grad_sums library")
    try:
        r, sm, si = torch.ops.aten.native_batch_norm(yl, w, b, rm, rv, True, 0.1, norm.eps)
        r = torch.relu(r)
        gm = torch.ops.aten.threshold_backward(gl, r, 0)
        runs["library forward"] = lambda: torch.relu(F.batch_norm(yl, rm, rv, w, b, True, 0.1,
                                                                  norm.eps))
        runs["library backward"] = lambda: torch.ops.aten.native_batch_norm_backward(
            torch.ops.aten.threshold_backward(gl, r, 0), yl, w, rm, rv, sm, si, True, norm.eps,
            [True, True, True])
        runs["bn_stats library"] = lambda: torch.batch_norm_stats(yl, norm.eps)
        runs["bn_relu_grad_sums library"] = lambda: torch.batch_norm_backward_reduce(
            gm, yl, sm, si, w, True, True, True)
        for name in library:
            runs[name]()
    except RuntimeError as err:  # a yardstick only: the port calls none of them
        print(f"shared MLP ({rec['name']}): the library yardstick refused the inputs: {err}")
        for name in library:
            runs.pop(name, None)
    best = in_turns(runs, SA_REPS)
    for name in library:
        best.setdefault(name, None)
    return best


def check_bn_relu(card: str, label: str, records: list, timed: bool) -> dict:
    """The set abstraction's shared MLP on a run's own Dense outputs, every
    width of every SA module (`check_sa_record`): from a training step
    (`record_sa`: with the incoming gradients) or a request's forward
    (`record_sa_request`: eval mode).  `bn_stats` two launches equal, sums
    and means within SA_SUMS_REL of the largest value against f64 sums;
    `bn_relu_apply` equal to its plain version given the module's batch
    statistics (training) and the running ones (the hidden widths' y dtype
    and the pooled f32, NaN positions too); in training `bn_relu_grad_sums`
    within SA_GRAD_REL (q = grad / ties equal) and `bn_relu_grad_apply`
    within one bf16 ulp or SA_DY_REL of the largest value (bf16) or
    SA_GRAD_REL (f32), each two launches equal; the whole Function
    (`BnRelu`) against the module chain from one state: the output, the
    running statistics and in training dy, dweight and dbias (f32: against
    the expression's VJP in f64, `sa_vjp64`); crafted
    inputs at a training record's pooled width (`check_sa_crafted`).  With
    `timed`, each width's passes in turns (`time_sa_record`) beside the
    bound of its bytes.  Returns the totals over the run's widths, each
    kernel over the widths that launch it: {kernel: ms, plain_ms,
    library_ms, bound_ms, max_abs_err, ...}."""
    t0 = time.perf_counter()
    tot = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0, ops=0, max_abs_err=0.0)
           for n in SA_KERNELS}
    chains = collections.Counter()
    for rec in records:
        errs = check_sa_record(rec)
        if rec["training"] and rec["axis"] is not None:
            check_sa_crafted(rec)
        y, axis = rec["y"], rec["axis"]
        run = SA_KERNELS if rec["training"] else ("bn_relu_apply",)
        nbytes = sa_bytes(y, axis)
        for n in run:
            tot[n]["nbytes"] += nbytes[n]
            tot[n]["ops"] += SA_OPS[n] * y.numel()
            tot[n]["max_abs_err"] = max(tot[n]["max_abs_err"], errs.get(n, 0.0))
        line = (f"shared MLP {label} {rec['name']}: {'x'.join(map(str, y.shape))} "
                f"{str(y.dtype)[6:]}, slot axis {axis}, "
                f"{'training' if rec['training'] else 'eval'}: sums {errs['sums']:.1e} and means "
                f"{errs['means']:.1e} of the largest value against f64 (the plain version "
                f"{errs['plain sums']:.1e}), apply equal")
        if rec["training"] and "module dy" not in errs:
            line += (f", grad sums {errs['grad sums']:.1e}, dy {errs['dy']:.2f} of its gate; the "
                     f"Function against the module's autograd: output {errs['chain out']:.2f}, dy "
                     f"{errs['chain dy']:.2f} of their gates, dweight {errs['chain dweight']:.1e}, "
                     f"dbias {errs['chain dbias']:.1e}, running statistics "
                     f"{errs['chain running']:.1e}")
        elif rec["training"]:
            line += (f", grad sums {errs['grad sums']:.1e}, dy {errs['dy']:.2f} of its gate; the "
                     f"Function against the module: output {errs['chain out']:.2f} of its gate, "
                     f"running statistics {errs['chain running']:.1e}; against the expression's "
                     f"f64 VJP: dy {errs['chain dy']:.2f} of its gate ({SA_GRAD_REL} of the largest "
                     f"value; the module's f32 autograd {errs['module dy']:.1e}), dweight "
                     f"{errs['chain dweight']:.1e}, dbias {errs['chain dbias']:.1e}, "
                     f"{errs['moved units']} " + ("units left out, their maximum moved by an ulp"
                                                  if rec["axis"] is not None else
                                                  "values on the other side of 0 in f64, the f32 "
                                                  "side taken") +
                     f" ({errs['moved share']:.1e} of them)")
        else:
            line += (f"; the Function against the module: output {errs['chain out']:.2f} of its "
                     "gate, the running statistics untouched")
        if timed:
            best = time_sa_record(rec)
            for n in SA_KERNELS:
                tot[n]["ms"] += best[n]
                tot[n]["plain_ms"] += best[f"{n} plain"]
                lib = best.get(f"{n} library")
                tot[n]["library_ms"] = None if lib is None or tot[n]["library_ms"] is None else \
                    tot[n]["library_ms"] + lib
            for k, v in best.items():
                if v is not None and not k.startswith(SA_KERNELS):
                    chains[k] += v
            bounds = {n: bound_ms(nbytes[n], SA_OPS[n] * y.numel(), F32_PEAK)[0]
                      for n in SA_KERNELS}
            line += "; " + ", ".join(f"{n} {best[n]:.4f} ms (plain {best[n + ' plain']:.4f}, "
                                     f"bound {bounds[n]:.4f}" +
                                     (f", library {best[n + ' library']:.4f}"
                                      if best.get(n + " library") is not None else "") + ")"
                                     for n in SA_KERNELS)
            line += "; " + ", ".join(f"{k} {v:.4f} ms" for k, v in best.items()
                                     if not k.startswith(SA_KERNELS) and v is not None)
            line += " (graph replays, in turns)"
        print(line + f" ({card})")
    out = {}
    for n in SA_KERNELS:
        if not tot[n]["nbytes"]:
            continue
        b_ms, b_by = bound_ms(tot[n]["nbytes"], tot[n]["ops"], F32_PEAK)
        out[n] = dict(max_abs_err=tot[n]["max_abs_err"], bound_ms=b_ms, bound_by=b_by,
                      nbytes=tot[n]["nbytes"], **({} if not timed else
                                                  dict(ms=tot[n]["ms"], plain_ms=tot[n]["plain_ms"],
                                                       library_ms=tot[n]["library_ms"])))
    SA_CHECKED[label] = out
    if timed:
        out["chains"] = dict(chains)
    print(f"shared MLP ({label}): {len(records)} widths held; " +
          ", ".join(f"{n} bound {v['bound_ms']:.4f} ms ({v['nbytes'] / 1e9:.3f} GB)"
                    for n, v in out.items() if n in SA_KERNELS) +
          (("; over the widths: " + ", ".join(f"{k} {v:.4f} ms" for k, v in chains.items()))
           if timed else "") + f"; the check took {time.perf_counter() - t0:.1f} s ({card})")
    return out


def sa_entries(step: dict, masked: dict, checked: dict) -> dict:
    """The kernels-line entries of the four shared-MLP kernels: the times and
    bounds of one sunrgbd_quick step's three widths, the masked config's
    beside them; each kernel's library call (`torch.batch_norm_stats`,
    `torch.batch_norm_backward_reduce`) and, on the forward pair's row
    (apply) and the backward pair's (grad_apply), the library call of the
    pair.  `max_abs_err` is the largest over every checked run (`checked`:
    label -> `check_bn_relu`'s result), which the entry lists."""
    chains = step["chains"]
    pair = {"bn_relu_apply": "library forward", "bn_relu_grad_apply": "library backward"}
    entries = {}
    for n in SA_KERNELS:
        e = {k: v for k, v in step[n].items() if k != "nbytes"}
        e.update(per="one sunrgbd_quick training step's 3 widths",
                 scannet_masked={k: v for k, v in masked[n].items() if k != "nbytes"},
                 checked_runs=sorted(label for label, c in checked.items() if n in c))
        if n in pair:
            e["library_ms"] = chains.get(pair[n])
            e["scannet_masked"]["library_ms"] = masked["chains"].get(pair[n])
        e["max_abs_err"] = max(c[n]["max_abs_err"] for c in checked.values() if n in c)
        entries[n] = e
    entries["bn_stats"]["library"] = "torch.batch_norm_stats: each channel's mean and invstd"
    entries["bn_relu_grad_sums"]["library"] = (
        "torch.batch_norm_backward_reduce on the ReLU-masked gradient: sum g and sum g (y - mean)")
    entries["bn_relu_apply"].update(
        library="F.batch_norm(training=True) + relu: the forward pair's work (bn_stats + "
                "bn_relu_apply)",
        pair_ms=step["bn_stats"]["ms"] + step["bn_relu_apply"]["ms"],
        kernels_forward_ms=chains.get("kernels forward"), module_forward_ms=chains.get("module forward"))
    entries["bn_relu_grad_apply"].update(
        library="threshold_backward + native_batch_norm_backward: the backward pair's work "
                "(bn_relu_grad_sums + bn_relu_grad_apply)",
        pair_ms=step["bn_relu_grad_sums"]["ms"] + step["bn_relu_grad_apply"]["ms"],
        kernels_forward_backward_ms=chains.get("kernels forward + backward"),
        module_forward_backward_ms=chains.get("module forward + backward"))
    return entries


# ------------------------------------------------ the transformer's add & norm
NORM_REPS = 20  # calls a timing graph of one add & norm (at 5 a graph replay's own cost moved a
# decoder norm's time by a microsecond from run to run)
NORM_Y_REL = 1e-5  # y against the f64 expression, of the largest value ...
NORM_PLAIN_FACTOR = 2.0  # ... or within this many times the plain version's own f32 error
NORM_GRAD_REL = 1e-4  # dx, dweight, dbias against the f64 VJP, of the largest value
# f32 operations an element: the forward the add (2 with the dropout's
# product), the two sums (2) and y (4); the backward xhat (2), gw, the two row
# sums (2), dx (4), the residual's add, the two parameter sums (2)
NORM_OPS = {"add_norm": 10, "add_norm_grad": 13}
NORM_CHECKED = {}  # label -> check_add_norm's result: every run whose norms were held


@contextlib.contextmanager
def spy_add_norm(model):
    """`models.mlp.AddNorm` spied on while the block runs: for each call (every
    `LayerNorm` of `model` on the card and every fused add & norm), in order,
    a dict of the norm's module name (`name`), x, the residual's branch and
    keep mask (None without), keep_prob, eps, weight and bias (copies),
    whether it takes a gradient (`training`) and, from hooks on its outputs,
    y's gradient (`grad_y`) and x_new's own (`grad_res`)."""
    from ov3det_torch.models import mlp

    names = {id(m.weight): n for n, m in model.named_modules() if isinstance(m, mlp.LayerNorm)}
    records, original = [], mlp.AddNorm

    class Spy:
        @staticmethod
        def apply(x, branch, weight, bias, keep, keep_prob, eps):
            rec = dict(name=names[id(weight)], x=x.detach().clone(),
                       branch=None if branch is None else branch.detach().clone(),
                       keep=None if keep is None else keep.clone(), keep_prob=keep_prob, eps=eps,
                       weight=weight.detach().clone(), bias=bias.detach().clone(),
                       training=torch.is_grad_enabled() and weight.requires_grad)
            out = original.apply(x, branch, weight, bias, keep, keep_prob, eps)
            outs = (out,) if branch is None else out
            if outs[-1].requires_grad:
                outs[-1].register_hook(lambda g: rec.__setitem__("grad_y", g.detach().clone()))
                if branch is not None:
                    outs[0].register_hook(lambda g: rec.__setitem__("grad_res", g.detach().clone()))
            records.append(rec)
            return out

    mlp.AddNorm = Spy
    try:
        yield records
    finally:
        mlp.AddNorm = original


def record_add_norm(cfg, batch: dict, dev: torch.device) -> list:
    """One eager training step of `cfg` (after a warm-up step) under
    `spy_add_norm`: every norm's records, each with its gradients."""
    from ov3det_torch.engine.train import batch_to_device, build_training

    training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    b = batch_to_device(batch, dev)
    training.train_step(b, gen)  # warm-up
    with spy_add_norm(training.model) as records:
        training.train_step(b, gen)
    torch.cuda.synchronize()
    require(records and all(r["training"] and "grad_y" in r
                            and (r["branch"] is None or "grad_res" in r) for r in records),
            "record_add_norm: a norm got no gradient")
    del training
    gc.collect()
    torch.cuda.empty_cache()
    return records


def record_add_norm_request(det, batch: dict) -> list:
    """One request's eager forward (`Detector.eval_step`) under
    `spy_add_norm`: every norm's records in eval mode (no mask, no
    gradient)."""
    from ov3det_torch.engine.infer import INPUT_KEYS

    inputs = {k: torch.as_tensor(np.asarray(batch[k], np.float32)).to(det.device)
              for k in INPUT_KEYS}
    with spy_add_norm(det.model) as records:
        det.eval_step(inputs)
    torch.cuda.synchronize()
    require(records and not any(r["training"] or r["keep"] is not None for r in records),
            "record_add_norm_request: expected eval-mode norms without masks")
    return [{k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in r.items()}
            for r in records]  # plain tensors, out of inference mode


def record_text_norms(encoder, ids: torch.Tensor) -> list:
    """The text tower's norms (width 640, no gradient) on `ids`, under
    `spy_add_norm`."""
    with torch.no_grad(), spy_add_norm(encoder) as records:
        encoder(ids)
    torch.cuda.synchronize()
    return records


def norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """A gradient's error in units of its gate: bf16 ulps (`dy_ulps`: one ulp,
    or SA_DY_REL of the largest value) in bf16, NORM_GRAD_REL of the largest
    value in f32; NaN positions must agree (else inf)."""
    if got.dtype == torch.bfloat16:
        return dy_ulps(got, want.float())
    return rel_err(got, want) / NORM_GRAD_REL


def abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| where neither is NaN."""
    got, want = got.double(), want.double()
    ok = ~(torch.isnan(got) | torch.isnan(want))
    return (got[ok] - want[ok]).abs().max().item() if ok.any() else 0.0


def norm_expression64(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """`LayerNorm`'s expression in f64 on the f32 (or bf16) rows h."""
    mean = h.mean(-1, keepdim=True)
    var = torch.clamp((h * h).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (h - mean) * (torch.rsqrt(var + eps) * weight) + bias, mean, torch.rsqrt(var + eps)


def check_norm_record(rec: dict) -> dict:
    """The kernels on one recorded norm against their plain versions and the
    expression in f64 (`check_add_norm`); returns the record's errors."""
    from ov3det_torch.models.mlp import AddNorm
    from ov3det_torch.ops.kernels import add_norm as an

    x, br, keep, kp, eps = rec["x"], rec["branch"], rec["keep"], rec["keep_prob"], rec["eps"]
    w, b, label = rec["weight"], rec["bias"], rec["name"]
    errs = {}
    first = an.add_norm(x, w, b, eps, br, keep, kp)
    again = an.add_norm(x, w, b, eps, br, keep, kp)
    require(all(t is None or bits_equal(t, u) for t, u in zip(first, again)),
            f"add_norm ({label}): two launches differ")
    x_new, y, stats = first
    px, py, _ = an.add_norm_plain(x, w, b, eps, br, keep, kp)
    require(br is None or bits_equal(x_new, px),
            f"add_norm ({label}): x_new differs from the plain version")
    if br is not None:  # the dropout's division is the CPU's (flax's) on the card
        cpu = x.cpu() + an.dropped(br.cpu(), None if keep is None else keep.cpu(), kp)
        require(bits_equal(x_new.cpu(), cpu), f"add_norm ({label}): x_new differs from the CPU's")
    h = x if br is None else x_new
    y64, mean64, r64 = norm_expression64(h.double(), w.double(), b.double(), eps)
    errs["y"], errs["plain y"] = rel_err(y, y64), rel_err(py, y64)
    errs["mean"] = rel_err(stats[0], mean64.reshape(-1))
    errs["r"] = rel_err(stats[1], r64.reshape(-1))
    # the kernel's rsqrtf against the card's torch.rsqrt on the kernel's own variance
    errs["rsqrt differs"] = float(not bits_equal(
        stats[1], torch.rsqrt(torch.clamp(stats[2], min=0.0) + eps)))
    errs["add_norm"] = abs_err(y, y64)
    require(errs["y"] <= max(NORM_Y_REL, NORM_PLAIN_FACTOR * errs["plain y"]),
            f"add_norm ({label}): y {errs['y']:.2e} of the largest value against f64, the plain "
            f"version {errs['plain y']:.2e} (gate {NORM_Y_REL}, or {NORM_PLAIN_FACTOR}x the "
            "plain version's)")
    if not rec["training"]:
        return errs

    gy, gres = rec["grad_y"], rec.get("grad_res")
    bdt = None if br is None else br.dtype
    first = an.add_norm_grad(h, gy, stats, w, x.dtype, gres, bdt, keep, kp)
    again = an.add_norm_grad(h, gy, stats, w, x.dtype, gres, bdt, keep, kp)
    require(all(t is None or bits_equal(t, u) for t, u in zip(first, again)),
            f"add_norm_grad ({label}): two launches differ")
    dx, dbr, sums = first
    hr, wr, bbr = (t.double().requires_grad_() for t in (h, w, b))
    dh, dw, db = torch.autograd.grad(norm_expression64(hr, wr, bbr, eps)[0], [hr, wr, bbr],
                                     gy.double())
    total = dh if gres is None else dh + gres.double()
    pdx, _ = an.add_norm_grad_plain(h, gy, stats, w, x.dtype, gres, bdt, keep, kp)
    errs["dx"], errs["plain dx"] = norm_err(dx, total), norm_err(pdx, total)
    errs["dweight"], errs["dbias"] = rel_err(sums[0], dw), rel_err(sums[1], db)
    errs["add_norm_grad"] = max(abs_err(dx, total), abs_err(sums[0], dw), abs_err(sums[1], db))
    if br is not None and x.dtype == torch.float32:  # dbranch from the kernel's own sum
        d = dx.to(bdt)
        want = an.dropped(d, keep, kp)
        cpu = an.dropped(d.cpu(), None if keep is None else keep.cpu(), kp)
        require(bits_equal(dbr, want) and bits_equal(dbr.cpu(), cpu),
                f"add_norm_grad ({label}): dbranch differs from autograd's order on the kernel's "
                "dx, on the card or on the CPU")
    elif br is not None:  # an f32 dbranch of a bf16 x: the f32 sum is not written
        want = total if keep is None else torch.where(keep, total / an.divisor(kp, bdt), 0.0)
        errs["dbranch"] = norm_err(dbr, want)
        require(errs["dbranch"] <= 1.0, f"add_norm_grad ({label}): dbranch {errs['dbranch']:.2f} "
                                        "of its gate")
    require(errs["dx"] <= 1.0 and max(errs["dweight"], errs["dbias"]) <= NORM_GRAD_REL,
            f"add_norm_grad ({label}) against the f64 VJP: dx {errs['dx']:.2f} of its gate, "
            f"dweight {errs['dweight']:.2e}, dbias {errs['dbias']:.2e} (gate {NORM_GRAD_REL})")

    # the Function (`AddNorm`, what the modules call) gives the wrappers' bits
    xr = x.clone().requires_grad_()
    brr = None if br is None else br.clone().requires_grad_()
    wr, bbr = w.clone().requires_grad_(), b.clone().requires_grad_()
    out = AddNorm.apply(xr, brr, wr, bbr, keep, kp, eps)
    outs = (out,) if br is None else out
    wrt = [xr, wr, bbr] + ([] if brr is None else [brr])
    got = torch.autograd.grad(outs, wrt, (gy,) if br is None else (gres, gy))
    want = [dx, sums[0], sums[1]] + ([] if dbr is None else [dbr])
    require(bits_equal(outs[-1], y) and (br is None or bits_equal(outs[0], x_new))
            and all(bits_equal(a, c) for a, c in zip(got, want)),
            f"AddNorm ({label}): the Function differs from its kernels' launches")
    return errs


def norm_bytes(rec: dict) -> dict:
    """The bytes each kernel must move at the record's shapes: each input read
    once, each output written once (x_new, y and the rows' statistics out of
    the forward; the backward's dweight and dbias, not the partial rows)."""
    x, br, keep = rec["x"], rec["branch"], rec["keep"]
    n, C, e = x.numel(), x.shape[-1], x.element_size()
    rows = n // C
    fwd = n * e + 4 * n + 8 * C + 12 * rows
    bwd = n * (4 if br is not None else e) + 4 * n + n * e + 4 * C + 12 * rows + 8 * C
    if br is not None:
        fwd += n * br.element_size() + 4 * n  # branch in, x_new out
        bwd += 4 * n + n * br.element_size()  # x_new's own gradient in, dbranch out
        if keep is not None:
            fwd, bwd = fwd + n, bwd + n
    return {"add_norm": fwd, "add_norm_grad": bwd}


def norm_signature(rec: dict) -> tuple:
    br = rec["branch"]
    return (tuple(rec["x"].shape), rec["x"].dtype, None if br is None else br.dtype,
            rec["keep"] is not None, rec["training"])


def time_norm_record(rec: dict) -> dict:
    """In turns by graph replays (`in_turns`): the forward kernel, its plain
    version and the library pair's forward (the add, then `F.layer_norm`,
    which takes the two-pass variance: a yardstick of its work); in training
    the backward kernels (one launch), the plain versions and the library's
    backward (`native_layer_norm_backward`, then the residual's add and the
    dropout's backward)."""
    import torch.nn.functional as F

    from ov3det_torch.ops.kernels import add_norm as an

    x, br, keep, kp, eps = rec["x"], rec["branch"], rec["keep"], rec["keep_prob"], rec["eps"]
    w, b = rec["weight"], rec["bias"]
    C = x.shape[-1]
    x_new, _, stats = an.add_norm(x, w, b, eps, br, keep, kp)
    h = x if br is None else x_new
    runs = {"add_norm": lambda: an.add_norm(x, w, b, eps, br, keep, kp),
            "add_norm plain": lambda: an.add_norm_plain(x, w, b, eps, br, keep, kp),
            "add_norm library": lambda: F.layer_norm(
                x.float() if br is None else x + an.dropped(br, keep, kp), (C,), w, b, eps)}
    if rec["training"]:
        gy, gres = rec["grad_y"], rec.get("grad_res")
        bdt = None if br is None else br.dtype
        hf = h.float()
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(hf, [C], w, b, eps)

        def library_backward():
            dxl, dwl, dbl = torch.ops.aten.native_layer_norm_backward(
                gy, hf, [C], lmean, lrstd, w, b, [True, True, True])
            if br is None:
                return dxl, dwl, dbl
            t = dxl + gres
            d = t.to(bdt)
            return t, d if keep is None else torch.where(keep, d, 0.0) / kp, dwl, dbl

        runs["add_norm_grad"] = lambda: an.add_norm_grad(h, gy, stats, w, x.dtype, gres, bdt,
                                                         keep, kp)
        runs["add_norm_grad plain"] = lambda: (
            an.add_norm_grad_plain(h, gy, stats, w, x.dtype, gres, bdt, keep, kp),
            an.add_norm_param_grads_plain(h, gy, stats))
        runs["add_norm_grad library"] = library_backward
    return in_turns(runs, NORM_REPS)


def check_norm_crafted(card: str, rec: dict) -> None:
    """Crafted inputs through `check_norm_record`, from a training record's
    fused add & norm (its weight, bias and eps; seeded gradients): NaN and
    infinities in x and the branch; constant rows (var_raw above, at and
    below 0: the clamp's backward); a bf16 x with an f32 branch, with and
    without the mask; a bf16 x alone; widths 8 and 768; x off a 16-byte
    boundary.  Then what the kernels refuse raises on the card: a bf16 x
    with a bf16 branch, C 776 and C 12."""
    from ov3det_torch.ops.kernels import add_norm as an

    dev = rec["x"].device
    g = torch.Generator(device=dev).manual_seed(24)

    def seeded(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def case(x, br, keep, w=None, b=None):
        C = x.shape[-1]
        w = rec["weight"] if w is None else w
        b = rec["bias"] if b is None else b
        return dict(rec, x=x, branch=br, keep=keep, weight=w, bias=b, training=True,
                    grad_y=seeded(x.shape), grad_res=None if br is None else seeded(x.shape),
                    name=f"{rec['name']}, {C} channels")

    x, br, keep = (t[:1, :512] for t in (rec["x"], rec["branch"], rec["keep"]))
    rows = x.reshape(-1, x.shape[-1]).clone()
    for i, c in enumerate((0.0099999998, 0.0119939977, 0.0149849951, 3.0, 0.0)):
        rows[i] = c
    nan = float("nan")
    cases = {
        "NaN and infinities in x and the branch": case(
            sprinkle(x, [nan, float("inf"), -float("inf")], 96, 41), sprinkle(br, [nan], 32, 42),
            keep),
        "constant rows": case(rows.view_as(x), None, None),
        "constant rows, with the branch 0": case(rows.view_as(x), torch.zeros_like(br), keep),
        "a bf16 x, an f32 branch, the mask": case(x.to(torch.bfloat16), br.float(), keep),
        "a bf16 x, an f32 branch": case(x.to(torch.bfloat16), br.float(), None),
        "a bf16 x alone": case(x.to(torch.bfloat16), None, None),
        "width 8": case(seeded((64, 8), scale=3.0), seeded((64, 8), torch.bfloat16),
                        seeded((64, 8)) > -1.0, seeded((8,)), seeded((8,))),
        "width 768": case(seeded((70, 768), scale=3.0), seeded((70, 768), torch.bfloat16),
                          seeded((70, 768)) > -1.0, seeded((768,)), seeded((768,))),
        "x off a 16-byte boundary": case(misaligned(x, 4), br, keep),
    }
    for name, c in cases.items():
        check_norm_record(c)
    refused = 0
    for x_bad, b_bad in ((x.to(torch.bfloat16), br), (seeded((4, 776)), None),
                         (seeded((4, 12)), None)):
        C = x_bad.shape[-1]
        w = rec["weight"] if C == x.shape[-1] else torch.ones(C, device=dev)
        try:
            an.add_norm(x_bad, w, torch.zeros_like(w), 1e-5, b_bad)
        except ValueError:
            refused += 1
    require(refused == 3, f"add_norm: {3 - refused} of 3 inputs the kernels do not take ran")
    print(f"add & norm crafted ({rec['name']}): {', '.join(cases)} through every gate of a "
          f"record's check; a bf16 x with a bf16 branch, C 776 and C 12 refused ({card})")
    check_dropout(card, dev)


def check_dropout(card: str, dev: torch.device) -> None:
    """The port's dropout (`dropped`: what `mlp.dropout` and the add & norm's
    plain version apply) on the card equal to the CPU's bit for bit, forward
    and through autograd, in bf16 (the FFN's and the last residual's) and f32
    (the GenericMLP's), at keep probabilities 0.9 and 0.7 and a
    `sunrgbd_quick` encoder's shape: flax's division on both devices.  Prints
    how many kept values the card's product by the reciprocal (torch's
    `x / keep_prob` with a CPU scalar there) would have changed."""
    from ov3det_torch.ops.kernels import add_norm as an

    g = torch.Generator(device=dev).manual_seed(25)
    moved = {}
    for dtype, kp in ((torch.bfloat16, 0.9), (torch.float32, 0.9), (torch.bfloat16, 0.7),
                      (torch.float32, 0.7)):
        x = (torch.randn((8, 2048, 256), generator=g, device=dev) * 3.0).to(dtype)
        ct = torch.randn(x.shape, generator=g, device=dev).to(dtype)
        keep = torch.rand(x.shape, generator=g, device=dev) < kp
        outs = []
        for d in (dev, torch.device("cpu")):
            xr = x.detach().to(d, copy=True).requires_grad_()
            y = an.dropped(xr, keep.to(d), kp)
            y.backward(ct.to(d))
            outs.append((y.detach().cpu(), xr.grad.cpu()))
        name = f"{str(dtype)[6:]} at {kp}"
        require(bits_equal(outs[0][0], outs[1][0]) and bits_equal(outs[0][1], outs[1][1]),
                f"dropout ({name}): the card's values or gradient differ from the CPU's")
        product = torch.where(keep, x / kp, 0.0).cpu()
        moved[name] = int((product != outs[0][0]).sum())
    torch.cuda.synchronize()
    print(f"dropout on the card = the CPU, forward and VJP, bit for bit ({', '.join(moved)}; "
          f"8x2048x256 each); kept values the reciprocal's product would change: "
          f"{', '.join(f'{n} {v}' for n, v in moved.items())} ({card})")


def check_grad_turns(card: str, rec: dict) -> str:
    """`add_norm_grad` (a cooperative launch) in eager calls and graph
    replays in turns: on the record's own inputs an eager launch, then a
    graph replay, an eager launch, a replay and an eager launch give the
    first launch's bits.  Returns the record's grid."""
    from ov3det_torch.ops.kernels import add_norm as an

    x, br, keep, kp, eps = rec["x"], rec["branch"], rec["keep"], rec["keep_prob"], rec["eps"]
    w, b = rec["weight"], rec["bias"]
    x_new, _, stats = an.add_norm(x, w, b, eps, br, keep, kp)
    h = x if br is None else x_new
    bdt = None if br is None else br.dtype

    def run():
        return an.add_norm_grad(h, rec["grad_y"], stats, w, x.dtype, rec.get("grad_res"), bdt,
                                keep, kp)

    first = [t.clone() for t in run() if t is not None]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = [t for t in run() if t is not None]
    turns = []
    for turn in ("replay", "eager", "replay", "eager"):
        if turn == "replay":
            graph.replay()
            turns.append([t.clone() for t in static])
        else:
            turns.append([t.clone() for t in run() if t is not None])
    torch.cuda.synchronize()
    require(all(bits_equal(a, c) for t in turns for a, c in zip(t, first)),
            f"add_norm_grad ({rec['name']}): graph replays and eager launches in turns differ")
    rows = x.numel() // x.shape[-1]
    blocks, per = an.grad_blocks(rows, an._sms(x.device.index or 0), x.shape[-1])
    return f"{rows} rows: {blocks} CTAs of {per} rows"


def check_add_norm(card: str, label: str, records: list, timed: bool) -> dict:
    """The transformer's add & norm on a run's own inputs (`check_norm_record`
    on each record): from a training step (`record_add_norm`: with the
    incoming gradients), a request (`record_add_norm_request`, eval mode) or
    the text tower (`record_text_norms`).  `add_norm` two launches equal,
    x_new equal to the plain version bit for bit, y within NORM_Y_REL of the
    largest value of the expression in f64 (or NORM_PLAIN_FACTOR times the
    plain version's own error, where that is larger); in training
    `add_norm_grad` two launches equal, dx within NORM_GRAD_REL of the
    largest value of the f64 VJP (bf16: one ulp or SA_DY_REL), dweight and
    dbias within NORM_GRAD_REL, dbranch equal to autograd's order on the
    kernel's dx bit for bit; the Function (`AddNorm`) equal to the wrappers'
    launches bit for bit.  With `timed`, each distinct signature (shape,
    dtypes, mask, mode) in turns (`time_norm_record`), times its count.
    Returns the totals over the run's norms: {kernel: ms, plain_ms,
    library_ms, bound_ms, max_abs_err, ...}."""
    t0 = time.perf_counter()
    groups = collections.OrderedDict()
    worst = collections.defaultdict(float)
    for rec in records:
        errs = check_norm_record(rec)
        groups.setdefault(norm_signature(rec), []).append((rec, errs))
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
    tot = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0, ops=0, launches=0)
           for n in NORM_KERNELS}
    grids = []
    for (shape, xdt, bdt, masked, training), members in groups.items():
        rec, count = members[0][0], len(members)
        run = NORM_KERNELS if training else ("add_norm",)
        if training:
            grids.append(check_grad_turns(card, rec))
        nbytes = norm_bytes(rec)
        for n in run:
            tot[n]["nbytes"] += count * nbytes[n]
            tot[n]["ops"] += count * NORM_OPS[n] * rec["x"].numel()
            tot[n]["launches"] += count
        errs = {k: max(e.get(k, 0.0) for _, e in members) for k in members[0][1]}
        line = (f"add & norm {label}: {count} x {'x'.join(map(str, shape))}, x {str(xdt)[6:]}, "
                f"branch {str(bdt)[6:] if bdt else 'none'}{', the mask' if masked else ''}, "
                f"{'training' if training else 'eval'} ({members[0][0]['name']} ...): y "
                f"{errs['y']:.1e} of the largest value against f64 (plain {errs['plain y']:.1e}), "
                f"mean {errs['mean']:.1e}, r {errs['r']:.1e}")
        if training:
            line += (f"; dx {errs['dx']:.2f} of its gate (plain {errs['plain dx']:.2f}), dweight "
                     f"{errs['dweight']:.1e}, dbias {errs['dbias']:.1e}")
        if timed:
            best = time_norm_record(rec)
            for n in run:
                tot[n]["ms"] += count * best[n]
                tot[n]["plain_ms"] += count * best[f"{n} plain"]
                tot[n]["library_ms"] += count * best[f"{n} library"]
            line += "; " + ", ".join(
                f"{n} {best[n]:.4f} ms (plain {best[n + ' plain']:.4f}, library "
                f"{best[n + ' library']:.4f}, bound "
                f"{bound_ms(nbytes[n], NORM_OPS[n] * rec['x'].numel(), F32_PEAK)[0]:.4f})"
                for n in run) + " (graph replays, in turns)"
        print(line + f" ({card})")
    out = {}
    for n in NORM_KERNELS:
        if not tot[n]["nbytes"]:
            continue
        b_ms, b_by = bound_ms(tot[n]["nbytes"], tot[n]["ops"], F32_PEAK)
        out[n] = dict(max_abs_err=worst[n], bound_ms=b_ms, bound_by=b_by, nbytes=tot[n]["nbytes"],
                      calls=tot[n]["launches"],
                      **({} if not timed else dict(ms=tot[n]["ms"], plain_ms=tot[n]["plain_ms"],
                                                   library_ms=tot[n]["library_ms"])))
    NORM_CHECKED[label] = out
    if grids:
        print(f"add & norm ({label}): add_norm_grad, one kernel a launch, eager and graphed in "
              f"turns the same bits ({'; '.join(sorted(set(grids)))}) "
              f"({card})")
    print(f"add & norm ({label}): {len(records)} norms in {len(groups)} signatures held (r equal "
          f"to torch.rsqrt of the kernel's own variance bit for bit: {worst['rsqrt differs'] == 0}); " +
          ", ".join(f"{n} {v['calls']} calls, bound {v['bound_ms']:.4f} ms "
                    f"({v['nbytes'] / 1e9:.3f} GB)" + (f", kernel {v['ms']:.4f} ms, plain "
                                                        f"{v['plain_ms']:.4f}, library "
                                                        f"{v['library_ms']:.4f}" if timed else "")
                    for n, v in out.items()) +
          f"; the check took {time.perf_counter() - t0:.1f} s ({card})")
    return out


def norm_entries(step: dict, masked: dict, checked: dict) -> dict:
    """The kernels-line entries of the two add & norm kernels: the times and
    bounds of one sunrgbd_quick step's 38 norms, the masked config's beside
    them; `library_ms` the library pair's (the add and `F.layer_norm`;
    `native_layer_norm_backward`, the residual's add and the dropout's
    backward).  `max_abs_err` is the largest over every checked run
    (`checked`: label -> `check_add_norm`'s result), which the entry lists."""
    entries = {}
    for n in NORM_KERNELS:
        e = {k: v for k, v in step[n].items() if k != "nbytes"}
        e.update(per=f"one sunrgbd_quick training step's {step[n]['calls']} norms",
                 scannet_masked={k: v for k, v in masked[n].items() if k != "nbytes"},
                 checked_runs=sorted(label for label, c in checked.items() if n in c))
        e["max_abs_err"] = max(c[n]["max_abs_err"] for c in checked.values() if n in c)
        entries[n] = e
    entries["add_norm"]["library"] = "the residual's add and F.layer_norm (two-pass variance)"
    entries["add_norm_grad"]["library"] = ("native_layer_norm_backward, the residual's add and "
                                           "the dropout's backward")
    return entries


CLI_ARGV = ["--dataset_name", "synthetic", "--device", "cuda", "--num_points", "40000",
            "--batchsize_per_gpu", "8", "--compute_dtype", "bfloat16", "--max_epoch", "2",
            "--eval_every_epoch", "1", "--eval_loss", "--log_every", "4", "--log_metrics_every", "8",
            # scripts/scannet_quick.sh
            "--nqueries", "256", "--matcher_giou_cost", "2", "--matcher_cls_cost", "1",
            "--matcher_center_cost", "0", "--matcher_objectness_cost", "0",
            "--loss_giou_weight", "1", "--loss_no_object_weight", "0.25",
            "--save_separate_checkpoint_every_epoch", "-1"]


def ap_table(lines: list, header: str) -> list:
    """The AP table printed after the first line starting with `header`."""
    i = next(i for i, line in enumerate(lines) if line.startswith(header))
    table = []
    for line in lines[i + 1:]:
        if not (line.startswith(("mAP0.", "AR0.", "-----", "IOU Thresh"))
                or " Average Precision: " in line or " Recall: " in line):
            break
        table.append(line)
    return table


class CliProbe:
    """Spies on in-process runs of `ov3det_torch.main.main`, through the
    names that module and the AP calculator look up: the launches of each
    train step and eval batch, the loop's host times, the eval passes'
    parts and the checkpoints' times and sizes.  `patched()` installs the
    spies and takes them out again.  A packed item (one process) is one
    entry of `steps` whatever batches it carries (`rows` holds how many);
    its launches are those its graph replays made.  `record_boxes` keeps
    each train batch's scans and GT boxes (a copy to the host a batch)."""

    def __init__(self, record_boxes: bool = False):
        self.record_boxes = record_boxes
        self.rows = []  # train batches of each entry of `steps`
        self.in_packed = False
        self.steps, self.evals = [], []  # (host start, epoch), launch deltas
        self.epochs, self.waits, self.eval_waits, self.starts = [], [], [], []
        self.passes, self.current = [], None
        self.saves, self.restores, self.train_ap_ms = [], [], []
        self.last_pass = None  # the last eval pass's APCalculator
        self.parses = []  # each AP parse's remove_empty_box (True: an eval pass's exact AP)
        self.train_boxes = []  # each train batch's scans and GT boxes, as the loader gave them

    @staticmethod
    def _delta(before: dict) -> dict:
        after = read_counts()
        return {n: after[n] - before[n] for n in after}

    def _train_step(self, step):
        def train_step(batch, generator, mark=None, staged=False):
            if self.in_packed:  # the packed step's warm-up or capture
                return step(batch, generator, mark, staged)
            before, t = read_counts(), time.perf_counter()
            out = step(batch, generator, mark, staged)
            self.steps.append((t, len(self.epochs) - 1, self._delta(before)))
            self.rows.append(1)
            return out
        return train_step

    def _packed_step(self, cls):
        probe = self

        class Probed(cls):
            def __call__(self, rows, metas, first_iter):
                before, t = read_counts(), time.perf_counter()
                probe.in_packed = True
                try:
                    out = super().__call__(rows, metas, first_iter)
                finally:
                    probe.in_packed = False
                probe.steps.append((t, len(probe.epochs) - 1, probe._delta(before)))
                probe.rows.append(int(rows.shape[0]) if rows.dim() == 2 else 1)
                return out
        return Probed

    def _eval_step(self, step):
        def eval_step(batch):
            before = read_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            self.evals.append(self._delta(before))
            if self.current is not None:
                self.current["forward"] += ms
            return out
        return eval_step

    def _timed(self, fn, part: str):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            if self.current is not None:
                self.current[part] += ms
            return out
        return timed

    def _parse(self, parse):
        """The AP calculator's parse, timed into the current pass and gated:
        it launches NMS once (none with `no_nms`) and the empty-box test once
        where it removes empty boxes (an eval pass's exact AP), none where
        it keeps them (the train-time AP)."""
        timed = self._timed(parse, "parse")

        def parse_predictions(*args, remove_empty_box=True, no_nms=False, **kwargs):
            before = read_counts()
            out = timed(*args, remove_empty_box=remove_empty_box, no_nms=no_nms, **kwargs)
            delta = {n: c for n, c in self._delta(before).items() if c}
            want = {n: c for n, c in expect(nms=int(not no_nms),
                                            points_in_box=int(remove_empty_box)).items() if c}
            require(delta == want, f"a parse (remove_empty_box {remove_empty_box}, no_nms "
                                   f"{no_nms}) launched {delta}, expected {want}")
            self.parses.append(remove_empty_box)
            return out
        return parse_predictions

    @contextlib.contextmanager
    def patched(self):
        from ov3det_torch import main as cli
        from ov3det_torch.engine.checkpoint import CheckpointManager
        from ov3det_torch.eval import ap_calculator

        probe = self

        class TimedLoader(cli.DataLoader):
            def set_epoch(self, epoch):
                probe.epochs.append(time.perf_counter())
                super().set_epoch(epoch)

            def __iter__(self):
                t = time.perf_counter()
                batches = super().__iter__()  # starts the worker processes the first time
                probe.starts.append(("train" if self.shuffle else "test", (time.perf_counter() - t) * 1e3))
                while True:
                    t = time.perf_counter()
                    try:
                        batch = next(batches)
                    except StopIteration:
                        return
                    (probe.waits if self.shuffle else probe.eval_waits).append(
                        (time.perf_counter() - t) * 1e3)
                    if self.shuffle and probe.record_boxes:
                        keys = ("scan_idx", "gt_box_present", "gt_box_sem_cls_label")
                        if isinstance(batch, tuple):  # packed rows on the card
                            from ov3det_torch.datasets.loader import unpack_batch

                            for row in batch[0].cpu():
                                one = unpack_batch(row, batch[1])
                                probe.train_boxes.append({k: one[k].numpy() for k in keys})
                        else:
                            probe.train_boxes.append({k: np.asarray(batch[k]) for k in keys})
                    yield batch

        def build_training(*args, **kwargs):
            tr = originals["build_training"](*args, **kwargs)
            return dataclasses.replace(tr, train_step=self._train_step(tr.train_step),
                                       eval_step=self._eval_step(tr.eval_step))

        def make_eval_step(*args, **kwargs):
            return self._eval_step(originals["make_eval_step"](*args, **kwargs))

        def evaluate(*args, **kwargs):
            self.current = dict(forward=0.0, parse=0.0, ap=0.0, start=time.perf_counter())
            try:
                return originals["evaluate"](*args, **kwargs)
            finally:
                self.passes.append(self.current)  # its AP follows in compute_metrics
                self.current = None

        def compute_metrics(calc):
            t = time.perf_counter()
            out = originals["compute_metrics"](calc)
            ms = (time.perf_counter() - t) * 1e3
            if calc.exact_eval:  # an eval pass, not the train-time AP
                self.last_pass = calc
                self.passes[-1]["ap"] = ms
                self.passes[-1]["end"] = time.perf_counter()
            else:
                self.train_ap_ms.append(ms)
            return out

        def save(mgr, model, optimizer, epoch, name="checkpoint", extra=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = originals["save"](mgr, model, optimizer, epoch, name, extra)
            self.saves.append((name, (time.perf_counter() - t) * 1e3, os.path.getsize(path) / 1e6))
            return path

        def restore(mgr, model, optimizer=None, name="checkpoint"):
            t = time.perf_counter()
            out = originals["restore"](mgr, model, optimizer, name)
            torch.cuda.synchronize()
            if out[0] is not None:
                self.restores.append((name, (time.perf_counter() - t) * 1e3,
                                      os.path.getsize(mgr._path(name)) / 1e6))
            return out

        spies = [(cli, "DataLoader", TimedLoader), (cli, "build_training", build_training),
                 (cli, "PackedStep", self._packed_step(counted_packed_step())),
                 (cli, "make_eval_step", make_eval_step), (cli, "evaluate", evaluate),
                 (ap_calculator, "parse_predictions", self._parse(ap_calculator.parse_predictions)),
                 (ap_calculator.APCalculator, "compute_metrics", compute_metrics),
                 (CheckpointManager, "save", save), (CheckpointManager, "restore", restore)]
        originals = {name: getattr(owner, name) for owner, name, _ in spies}
        for owner, name, spy in spies:
            setattr(owner, name, spy)
        try:
            yield
        finally:
            for owner, name, _ in spies:
                setattr(owner, name, originals[name])


def detections_near_gt(batch: dict, rng, Q: int) -> dict:
    """Final-layer outputs (numpy) whose boxes are jittered copies of the
    batch's GT boxes (1 angle bin, 18 classes): the detections of a trained
    model, which random weights do not give."""
    from ov3det_torch.geometry.boxes_np import corners_from_upright_depth_param_np

    B = batch["gt_box_present"].shape[0]
    src = rng.integers(0, batch["gt_box_present"].sum(1).min(), size=(B, Q))
    take = lambda a: np.take_along_axis(a, src[..., None], 1)  # noqa: E731
    centers = take(batch["gt_box_centers"]) + rng.normal(0, 0.06, (B, Q, 3))
    sizes = take(batch["gt_box_sizes"]) * rng.uniform(0.8, 1.2, (B, Q, 3))
    corners = corners_from_upright_depth_param_np(centers, sizes, np.zeros((B, Q)))
    logits = rng.normal(size=(B, Q, 19)) * 2
    cls = take(batch["gt_box_sem_cls_label"][..., None])[..., 0]
    np.put_along_axis(logits, cls[..., None], 4.0, axis=-1)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {"box_corners": corners.astype(np.float32),
            "sem_cls_prob": probs[..., :-1].astype(np.float32),
            "objectness_prob": (1 - probs[..., -1]).astype(np.float32)}


def host_ap_iou(card: str, tested, dev: torch.device) -> None:
    """The eval's host AP (`compute_metrics`) with the rotated IoU of the C++
    core against the numpy one, in turns, on the `--test_only` pass (random
    weights: few detections) and on 16 scenes x 256 queries of detections
    near the GT boxes; both IoUs must give the same metrics within 1e-6."""
    from functools import partial

    from ov3det_torch import native
    from ov3det_torch.datasets.dataset_configs import ScannetDatasetConfig
    from ov3det_torch.datasets.synthetic import make_batch
    from ov3det_torch.eval import voc
    from ov3det_torch.eval.ap_calculator import APCalculator
    from ov3det_torch.geometry.iou_np import box3d_iou_batch_np

    require(native.native_available(), "cli: the C++ rotated IoU did not build")
    near = APCalculator(class2type_map=ScannetDatasetConfig().class2type)
    rng = np.random.default_rng(500)
    for _ in range(2):
        batch = make_batch(rng, batch_size=8, num_points=SCANNET_POINTS, num_semcls=18,
                           num_angle_bin=1)
        out = detections_near_gt(batch, rng, 256)
        near.step_meter({k: torch.from_numpy(v).to(dev) for k, v in out.items()}, batch)
    try:
        for label, calc in (("the --test_only pass", tested), ("detections near the GT", near)):
            ms, metrics = {True: [], False: []}, {}
            for _ in range(3):
                for use_native in (True, False):
                    voc.box3d_iou_batch_np = partial(box3d_iou_batch_np, allow_native=use_native)
                    t = time.perf_counter()
                    metrics[use_native] = calc.compute_metrics()
                    ms[use_native].append((time.perf_counter() - t) * 1e3)
            for t in metrics[False]:
                for k, v in metrics[False][t].items():
                    require(abs(float(metrics[True][t][k]) - float(v)) <= 1e-6,
                            f"cli host AP: C++ and numpy IoU disagree on {t} {k}")
            dets = sum(len(p[0]) for p in calc.pred_map_cls.values())
            print(f"cli host AP ({label}: {calc.scan_cnt} scenes, {dets} detections, mAP0.25 "
                  f"{metrics[False][0.25]['mAP']:.4f}): C++ IoU "
                  f"{[round(x, 2) for x in ms[True]]} ms, numpy IoU "
                  f"{[round(x, 2) for x in ms[False]]} ms, in turns ({card})")
    finally:
        voc.box3d_iou_batch_np = box3d_iou_batch_np


def run_cli(probe: CliProbe, argv: list) -> tuple:
    """`ov3det_torch.main.main(argv)` with the probe's spies and its standard
    output captured; returns (its result, the printed lines)."""
    from ov3det_torch import main as cli

    out = io.StringIO()
    with probe.patched(), contextlib.redirect_stdout(out):
        result = cli.main(argv)
    return result, out.getvalue().splitlines()


def cli_phase(card: str) -> dict:
    """Phase 8: the training CLI at full `scannet_quick` width; returns the
    launch counts of its three runs (train, guard, --test_only)."""
    import tempfile

    train_step = expect(**sa(), **norms(), fps=2, ball_group=1, attention_fwd=3, attention_dq=3,
                        attention_dkv=3, auction=1)
    eval_batch = expect(**sa(train=False), **norms(train=False), fps=2, ball_group=1, attention_fwd=3, auction=1)  # --eval_loss
    test_batch = expect(**sa(train=False), **norms(train=False), fps=2, ball_group=1, attention_fwd=3)
    probe = CliProbe()
    with tempfile.TemporaryDirectory(prefix="ov3det_cli_") as run:
        argv = CLI_ARGV + ["--checkpoint_dir", run]
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, lines = run_cli(probe, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        for line in lines:  # the log without the per-class rows of the AP tables
            if not (" Average Precision: " in line or " Recall: " in line):
                print(f"cli| {line}")
        for name in ("checkpoint", "checkpoint_best", "final_eval.txt"):
            require(os.path.isfile(os.path.join(run, name)), f"cli: no {name} in the run directory")
        with open(os.path.join(run, "final_eval.txt")) as fh:
            require("mAP0.25" in fh.read(), "cli: final_eval.txt holds no mAP0.25")
        require(len(probe.steps) == 16, f"cli: {len(probe.steps)} training steps, expected 2 x 8")
        require(all(d == train_step for _, _, d in probe.steps),
                f"cli: a training step launched {[d for _, _, d in probe.steps if d != train_step][:1]}, "
                f"expected {train_step}")
        # 2 train-time AP batches, 2 evals during training and the final one, 2 batches each
        require(len(probe.evals) == 2 + 3 * 2, f"cli: {len(probe.evals)} eval batches, expected 8")
        require(all(d == eval_batch for d in probe.evals),
                f"cli: an eval batch launched {[d for d in probe.evals if d != eval_batch][:1]}, "
                f"expected {eval_batch}")
        # each parse gated by the probe: NMS once, the empty-box test once in
        # the exact eval passes' 6 batches and never in the train-time AP's 2
        require(sorted(probe.parses) == [False] * 2 + [True] * 6,
                f"cli: parses with remove_empty_box {probe.parses}, expected 2 False and 6 True")

        n_steps = len(probe.steps)
        _, again = run_cli(probe, argv)
        require(any(line.startswith("Found final eval file") for line in again),
                f"cli: the second call did not stop at the guard: {again[-3:]}")
        require(len(probe.steps) == n_steps, "cli: the second call trained")

        best = os.path.join(run, "checkpoint_best")
        metrics, tested = run_cli(probe, argv + ["--test_only", "--test_ckpt", best])
        require(len(probe.evals) == 10 and all(d == test_batch for d in probe.evals[8:]),
                f"cli --test_only: eval batches launched {probe.evals[8:]}, expected 2 x {test_batch}")
        require(probe.parses[8:] == [True, True], f"cli --test_only: parses {probe.parses[8:]}")
        saved = [i for i, line in enumerate(lines) if line.startswith("saved new best checkpoint")]
        require(bool(saved), "cli: no best checkpoint was saved")
        best_epoch = max(int(line.split("[")[1].split("/")[0]) for line in lines[:saved[-1]]
                         if line.startswith("Evaluate Epoch"))
        want = ap_table(lines, f"Evaluate Epoch [{best_epoch}/")
        got = ap_table(tested, "Test model")
        require(tested[0] == f"Test model (epoch {best_epoch}); Metrics:", f"cli: {tested[0]}")
        require(len(want) == 2 + 2 * (2 + 2 * 18) and got == want,
                f"cli: --test_only printed {got[:2]}, the epoch-{best_epoch} eval {want[:2]}")
        require(0.25 in metrics and math.isfinite(metrics[0.25]["mAP"]), "cli: no mAP at 0.25")
        print(f"cli --test_only on checkpoint_best (epoch {best_epoch}): the AP table equals that "
              f"epoch's, {len(got)} lines, {got[0]}")
        host_ap_iou(card, probe.last_pass, torch.device("cuda"))
    counts = read_counts()
    gc.collect()
    require(not multiprocessing.active_children(),
            f"cli: loader workers outlived the runs: {multiprocessing.active_children()}")

    def spread(xs):
        return (f"median {np.median(xs):.2f}, min {min(xs):.2f}, max {max(xs):.2f} ms "
                f"over {len(xs)}")

    print(f"cli training run: {wall:.2f} s wall (model build, 2 epochs, 3 evals, checkpoints), "
          f"peak device memory {peak / 2**30:.3f} GiB ({card})")
    for e, start in enumerate(probe.epochs):
        first = next(t for t, ep, _ in probe.steps if ep == e)
        loop_end = probe.passes[e]["start"]
        print(f"cli epoch {e}: {probe.passes[e]['end'] - start:.3f} s wall (set_epoch to the end "
              f"of its eval), {loop_end - first:.3f} s from its first step to its eval (steps, "
              f"train AP, checkpoint) ({card})")
    iters = [(b[0] - a[0]) * 1e3 for a, b in zip(probe.steps, probe.steps[1:]) if a[1] == b[1]]
    steady = [(b[0] - a[0]) * 1e3 for a, b in zip(probe.steps[1:], probe.steps[2:]) if a[1] == b[1]]
    print(f"cli iteration time (host clock, step start to step start): {spread(iters)}; "
          f"without the run's first step {spread(steady)}; each "
          f"{[round(x, 1) for x in iters]} ({card})")
    print(f"cli iter(loader), in call order (the first of each loader starts its 4 worker "
          f"processes): {[(w, round(ms, 2)) for w, ms in probe.starts]} ({card})")
    print(f"cli wait on next(loader) in the step loop: {spread(probe.waits)}; each "
          f"{[round(x, 2) for x in probe.waits]}; in the eval passes {spread(probe.eval_waits)} "
          f"({card})")
    for i, p in enumerate(probe.passes):
        total = (p["end"] - p["start"]) * 1e3
        which = ["epoch 0", "epoch 1", "final", "--test_only"][i] if i < 4 else str(i)
        print(f"cli eval pass ({which}, 16 scenes in 2 batches): {total:.2f} ms = forward "
              f"{p['forward']:.2f} + parse (NMS) {p['parse']:.2f} + host AP {p['ap']:.2f} + the rest "
              f"{total - p['forward'] - p['parse'] - p['ap']:.2f} ms ({card})")
    print(f"cli train-time AP (exact_eval off) compute_metrics: "
          f"{[round(x, 2) for x in probe.train_ap_ms]} ms ({card})")
    for name, ms, mb in probe.saves:
        print(f"cli checkpoint save {name}: {ms:.2f} ms, {mb:.2f} MB ({card})")
    for name, ms, mb in probe.restores:
        print(f"cli checkpoint restore {name}: {ms:.2f} ms, {mb:.2f} MB ({card})")
    print(f"cli launches over the three calls: { {n: c for n, c in counts.items() if c} }")
    return counts


# ------------------------------------------------------------ phase 10: the OV step
INT8_PEAK = 1979e12  # dense int8 tensor operations a second, H100 SXM data sheet
# the frozen RN50x4 teacher's kernels in one OV step (8 canvases, 128 boxes
# each, res5 in 4 chunks of 256 regions): 65 trunk convs in the backbone and
# 19 a chunk in res5; the quantise passes: the stem's conv1 output and
# pooled output, 2 in each of layer2's and layer3's stride-2 blocks, 3 a chunk
TEACHER_STEP = dict(quant_conv=141, pool_quantize=17, pool_quantize_affine=1, normalise=1,
                    roi_align=4, pool_tokens=4, pool_attend=4)
# the RoI head's kernels: one launch each a chunk of 256 regions
HEAD_KERNELS = ("roi_align", "pool_tokens", "pool_attend")
# the teacher forward's profiler ranges (`RegionCLIPTeacher.forward`)
TEACHER_RANGES = ("normalise", "stem conv1", "trunk", "roi_align", "res5", "attnpool")
OV_STEPS = 3
QUANT_REPS = 5  # calls a timing graph of one trunk conv
CPU_CHECK_MACS = 2.5e10  # the trunk's 3x3 convs up to this many products are also run on the CPU
# the int8 teacher's features, card against CPU from the same quantised state,
# over the largest value
INT8_CARD_VS_CPU = 1e-3
OV_CLI_ARGV = ["--dataset_name", "synthetic", "--device", "cuda", "--use_image",
               "--loss_2dalignment_weight", "1", "--num_points", "20000", "--batchsize_per_gpu",
               "8", "--compute_dtype", "bfloat16", "--max_epoch", "1",
               # scripts/sunrgbd_quick.sh
               "--nqueries", "128", "--base_lr", "7e-4", "--matcher_giou_cost", "3",
               "--matcher_cls_cost", "1", "--matcher_center_cost", "5",
               "--matcher_objectness_cost", "5", "--loss_giou_weight", "0",
               "--loss_no_object_weight", "0.1", "--save_separate_checkpoint_every_epoch", "-1"]


def ov_step() -> dict:
    """The launches of one OV training step: the detector's and the teacher's."""
    return expect(**sa(), **norms(), fps=2, ball_group=1, attention_fwd=3, attention_dq=3, attention_dkv=3,
                  auction=1, **TEACHER_STEP)


def ov_boxes(dev: torch.device) -> torch.Tensor:
    """(8, 128, 4) region boxes on 530 x 730 canvases: an OV step's 1024."""
    from ov3det_torch.models.regionclip import calibration_boxes

    rng = np.random.default_rng(3)
    return torch.from_numpy(np.concatenate([calibration_boxes(rng, 530.0, 730.0, n=128)
                                            for _ in range(BATCH)])).to(dev)


def record_trunk(teacher, images, boxes) -> tuple:
    """One forward of the fused int8 teacher with its kernel wrappers spied
    on: ({signature: calls, first call's arguments} of `quant_conv`, the
    same of `pool_quantize`).  A conv's signature is its input shape, kernel
    and epilogue; a pass's its input shape and dtype, pool and scales."""
    from ov3det_torch.models import clip_resnet as cr

    convs, pools = {}, {}
    conv, pool = cr.quant_conv, cr.pool_quantize

    def keep(table, key, args):
        entry = table.setdefault(key, {"calls": 0})
        entry["calls"] += 1
        if "args" not in entry:
            entry["args"] = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]

    def conv_spy(xq, kernel_q, k, padding, s_x, scale, bias=None, residual=None, relu=False,
                 s_next=None, out_bf16=True, dtype=torch.bfloat16):
        args = [xq, kernel_q, k, padding, s_x, scale, bias, residual, relu, s_next, out_bf16, dtype]
        keep(convs, (tuple(xq.shape), tuple(kernel_q.shape), k, bias is not None,
                     residual is not None, relu, s_next is not None, out_bf16, dtype), args)
        return conv(*args)

    def pool_spy(x, p, scales, affine=None):
        if affine is None:  # the folded pass is `record_input`'s
            keep(pools, (tuple(x.shape), x.dtype, p, len(scales)), [x, p, list(scales)])
        return pool(x, p, scales, affine=affine)

    cr.quant_conv, cr.pool_quantize = conv_spy, pool_spy
    try:
        with torch.no_grad():
            teacher(images, boxes)
    finally:
        cr.quant_conv, cr.pool_quantize = conv, pool
    torch.cuda.synchronize()
    return convs, pools


def conv_label(key) -> str:
    (B, H, W, C), (N, _), k, bias, res, relu, q, out, dtype = key
    parts = ["bias" if bias else "no bias", "residual" if res else "", "relu" if relu else "",
             "bf16 out" if out and dtype == torch.bfloat16 else ("f32 out" if out else ""),
             "int8 out" if q else ""]
    return f"{k}x{k} {C}->{N} at {B}x{H}x{W} ({', '.join(p for p in parts if p)})"


def check_quant_conv(card: str, teacher, images, boxes, dev: torch.device) -> dict:
    """Phase 10's kernel check, at every distinct trunk conv of the int8
    teacher's forward on an OV batch (8 canvases, 128 boxes each) and on the
    activations that forward gives it: `quant_conv` (the design `_route`
    picks) and its first design (`_impl="mma"`) equal `quant_conv_plain`
    bit for bit in the forward's epilogue, in the full one (bias, a random
    residual, ReLU, bf16 and int8 out), in the full one with NaN and
    infinities in the residual (a NaN output's code 0, the plain version's)
    and in the dequant-only one with an f32 output ("static" and "dynamic"
    modes of an f32 tower); then, in
    turns, the routed kernel, the first design, `torch._int_mm` alone on the
    im2col, the plain version (im2col, `_int_mm`, the elementwise ops) and
    cuDNN's bf16 conv of the same shape, each by replays of a CUDA graph of
    QUANT_REPS calls, beside the int8 bound.  Then the quantise passes
    (`check_pass`).  Two convs of 15 rows on
    an odd 3 x 5 image are checked too: C_in 40 (the first design) and C_in
    48 (the wgmma design, ragged in M and N).  Returns the kernels-line
    entries, times summed over one forward's calls."""
    from ov3det_torch.ops.kernels import quant_conv as qc

    t0 = time.perf_counter()
    convs, pools = record_trunk(teacher, images, boxes)
    n_conv = sum(e["calls"] for e in convs.values())
    n_pool = sum(e["calls"] for e in pools.values())
    require((n_conv, n_pool) == (TEACHER_STEP["quant_conv"], TEACHER_STEP["pool_quantize"]),
            f"the teacher's forward made {n_conv} conv and {n_pool} quantise-pass calls, expected "
            f"{TEACHER_STEP}")
    g = torch.Generator(device=dev).manual_seed(14)
    cases = dict(convs)
    for c_small in (40, 48):  # the first design's 8-byte gathers, the wgmma design's ragged tile
        xs = torch.randint(-127, 128, (1, 3, 5, c_small), generator=g, device=dev, dtype=torch.int8)
        ks = torch.randint(-127, 128, (c_small, 9 * c_small), generator=g, device=dev,
                           dtype=torch.int8)
        small = [xs, ks, 3, 1, torch.tensor(0.02, device=dev),
                 torch.rand(c_small, generator=g, device=dev),
                 torch.randn(c_small, generator=g, device=dev), None, True,
                 torch.tensor(0.05, device=dev), True, torch.bfloat16]
        cases[("small", c_small)] = {"calls": 0, "args": small}
    totals = collections.Counter()
    classes = collections.defaultdict(collections.Counter)  # class -> sums over its calls
    cpu_checked = 0
    print(f"quant_conv: {n_conv} calls in {len(convs)} distinct shapes and epilogues, "
          f"{n_pool} quantise passes in {len(pools)}, recorded from one int8 teacher forward on "
          f"8 canvases x 128 boxes")
    for key, entry in cases.items():
        xq, kq, k, pad, s_x, scale, bias, res, relu, s_next, out, dtype = entry["args"]
        B, H, W, C = xq.shape
        N = kq.shape[0]
        rand_res = (torch.randn((B, H, W, N), generator=g, device=dev) * 2).to(torch.bfloat16)
        nan_res = sprinkle(rand_res, [float("nan"), float("inf"), -float("inf")], 96, 17)
        variants = {"as called": entry["args"],
                    "full": [xq, kq, k, pad, s_x, scale, scale * 3 - 0.05, rand_res, True,
                             s_next if s_next is not None else s_x, True, torch.bfloat16],
                    "dequant only, f32": [xq, kq, k, pad, s_x, scale, None, None, False, None,
                                          True, None],
                    # NaN and infinities through the residual: a NaN's code is 0
                    "full, NaN in the residual": [xq, kq, k, pad, s_x, scale, scale * 3 - 0.05,
                                                  nan_res, True,
                                                  s_next if s_next is not None else s_x, True,
                                                  torch.bfloat16]}
        route = qc._route(C, N, k)
        for name, args in variants.items():
            want = qc.quant_conv_plain(*args)
            for impl in (None, "mma"):
                got = qc.quant_conv(*args, _impl=impl)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    require((a is None) == (b is None) and (a is None or (
                        bits_equal(a, b) if a.is_floating_point() else torch.equal(a, b))),
                            f"quant_conv {key} {name}: the {impl or route} design differs from "
                            f"the plain version")
            if name == "full, NaN in the residual":  # the plain version's code of NaN is 0
                out_bf, codes = want[0], want[1]
                nan_out = torch.isnan(out_bf)
                require(bool(nan_out.any()) and not bool(codes[nan_out].any()),
                        f"quant_conv {key}: NaN outputs not coded 0 by the plain version")
        if k == 3 and B * H * W * 9 * C * N <= CPU_CHECK_MACS:  # the card against the CPU
            cpu = [t.cpu() if isinstance(t, torch.Tensor) else t for t in variants["full"]]
            for a, b in zip(qc.quant_conv(*variants["full"]), qc.quant_conv_plain(*cpu)):
                require(torch.equal(a.cpu(), b), f"quant_conv {key}: the card differs from the CPU")
            cpu_checked += 1
        if key[0] == "small":
            print(f"quant_conv 3x3 {C}->{N} at 1x3x5 (15 rows), route {route}: it and the first "
                  f"design equal to the plain version bit for bit in the three epilogues")
            continue
        a = qc.im2col_int8(xq, k, pad).contiguous()
        x_bf = xq.to(torch.bfloat16).permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        w_bf = kq.view(N, k, k, C).permute(0, 3, 1, 2).to(torch.bfloat16)
        w_bf = w_bf.contiguous(memory_format=torch.channels_last)
        args = entry["args"]
        runs = {"kernel": lambda: qc.quant_conv(*args),
                "first": lambda: qc.quant_conv(*args, _impl="mma"),
                "int_mm": lambda: torch._int_mm(a, kq.t()),
                "plain": lambda: qc.quant_conv_plain(*args),
                "cudnn bf16": lambda: torch.nn.functional.conv2d(x_bf, w_bf, padding=pad)}
        ms = {n: [] for n in runs}
        for order in (list(runs), list(runs)[::-1]):
            for n in order:
                ms[n].append(graph_ms(runs[n], QUANT_REPS))
        best = {n: min(v) for n, v in ms.items()}
        M, K = a.shape
        ops = 2 * M * K * N
        nbytes = M * C + N * K + 8 * N + (2 * M * N if res is not None else 0) \
            + (2 * M * N if out else 0) + (M * N if s_next is not None else 0)
        b_ms, by = bound_ms(nbytes, ops, INT8_PEAK)
        calls = entry["calls"]
        cls = (("3x3 in res5" if B != images.shape[0] else "3x3 in the backbone") if k == 3
               else "1x1 with a residual" if res is not None else "1x1, no residual")
        for n, v in best.items():
            totals[n] += calls * v
            classes[cls][n] += calls * v
        classes[cls]["calls"] += calls
        classes[cls]["bound"] += calls * b_ms
        totals["bound"] += calls * b_ms
        totals[f"bound {by}"] += calls * b_ms
        bn = qc._n_tile(N, k * k * C)
        design = f"wgmma, tile {qc.WGMMA_ROWS}x{bn}" if route == "wgmma" else "mma"
        print(f"quant_conv {conv_label(key)}, {calls} calls: M {M}, K {K}, N {N}, route {design}; "
              f"it and the first design equal to the plain version bit for bit in the three "
              f"epilogues; kernel {best['kernel']:.4f} ms ({ops / best['kernel'] / 1e9:.0f} TOPS), "
              f"first design {best['first']:.4f} ms, _int_mm alone {best['int_mm']:.4f} ms, "
              f"plain {best['plain']:.4f} ms, cuDNN bf16 conv {best['cudnn bf16']:.4f} ms; bound "
              f"{b_ms:.4f} ms ({by}; int8 operations {ops / INT8_PEAK * 1e3:.4f} ms, bytes "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms) ({card})")
        del a, x_bf, w_bf
    print(f"quant_conv: the full epilogue on the card equal to the plain version on the CPU bit "
          f"for bit at the {cpu_checked} 3x3 shapes of at most {CPU_CHECK_MACS:.1e} products")
    conv_by = "operations" if totals["bound operations"] >= totals["bound bytes"] else "bytes"
    print(f"quant_conv over one teacher forward ({n_conv} calls): kernel {totals['kernel']:.3f} ms, "
          f"first design {totals['first']:.3f} ms, _int_mm alone {totals['int_mm']:.3f} ms, "
          f"plain {totals['plain']:.3f} ms, cuDNN bf16 "
          f"{totals['cudnn bf16']:.3f} ms, bound {totals['bound']:.3f} ms (operations-bound "
          f"convs {totals['bound operations']:.3f} ms, bytes-bound {totals['bound bytes']:.3f} "
          f"ms) ({card})")
    for cls, t in sorted(classes.items()):
        print(f"quant_conv, {cls}: {t['calls']} calls, kernel {t['kernel']:.3f} ms, first design "
              f"{t['first']:.3f} ms, _int_mm alone {t['int_mm']:.3f} ms, plain {t['plain']:.3f} "
              f"ms, cuDNN bf16 {t['cudnn bf16']:.3f} "
              f"ms, bound {t['bound']:.3f} ms, summed over a forward ({card})")

    per = f"summed over one teacher forward ({n_conv} calls, {len(convs)} shapes)"
    entry = dict(max_abs_err=0.0, ms=totals["kernel"], first_ms=totals["first"],
                 plain_ms=totals["plain"], bound_ms=totals["bound"], bound_by=conv_by,
                 library_ms=totals["cudnn bf16"], int_mm_ms=totals["int_mm"], per=per,
                 library="cuDNN bf16 conv2d of each shape")
    del convs
    return {"quant_conv": entry, "pool_quantize": check_pass(card, pools, dev, t0)}


def check_pass(card: str, pools: dict, dev: torch.device, t0: float) -> dict:
    """Phase 10's check of the quantise pass at the 9 passes of one teacher
    forward (`pools`: `record_trunk`'s, on that forward's activations) and
    at odd shapes (an odd H or W at pool 2, C 8 short of a multiple of 16,
    C 8 at pool 1 in pieces of 16, one and two scales, f32 inputs, values
    on the scale's half-integers, NaN and infinities: a NaN codes 0):
    the routed design (`pass_launch`) and the first (`_impl="first"`) equal
    the plain version bit for bit; then, at the forward's passes, in turns,
    the routed design, the first, the plain version and `F.avg_pool2d` alone,
    each by replays of a CUDA graph of QUANT_REPS calls, beside the bound.
    Returns the kernels-line entry, times summed over one forward's calls."""
    from ov3det_torch.ops.kernels import quant_conv as qc

    g = torch.Generator(device=dev).manual_seed(16)
    cases = dict(pools)
    odd = [((2, 7, 9, 48), torch.bfloat16, 2, 1), ((2, 9, 7, 40), torch.bfloat16, 2, 2),
           ((3, 5, 5, 24), torch.bfloat16, 1, 2), ((1, 3, 3, 8), torch.bfloat16, 1, 1),
           ((2, 5, 6, 32), torch.float32, 2, 2), ((2, 3, 5, 40), torch.float32, 1, 1),
           ((2, 5, 7, 8), torch.bfloat16, 1, 1)]  # C 8 in pieces of 16: no whole group of C
    for shape, dtype, p, n in odd:
        x = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
        cases[("odd", shape, dtype, p, n)] = {"calls": 0, "args": [x, p, [
            torch.tensor(0.02 + 0.01 * i, device=dev) for i in range(n)]]}
    specials = [float("nan"), float("inf"), -float("inf")]
    for shape, dtype, p in (((2, 6, 10, 32), torch.bfloat16, 1), ((2, 6, 10, 32), torch.bfloat16, 2),
                            ((2, 5, 7, 40), torch.float32, 1), ((2, 6, 8, 48), torch.float32, 2)):
        x = sprinkle((torch.randn(shape, generator=g, device=dev) * 3).to(dtype), specials, 60,
                     len(shape) + p)  # a NaN, and a pool over one, codes 0
        cases[("NaN", shape, dtype, p)] = {"calls": 0, "args": [x, p, [
            torch.tensor(0.02, device=dev), torch.tensor(0.05, device=dev)]]}
    halves = (torch.randint(-130, 130, (2, 6, 10, 32), generator=g, device=dev) + 0.5) * 0.25
    for p in (1, 2):  # quotients on half-integers: the exact fall-back decides every value
        cases[("half-integers", p)] = {"calls": 0, "args": [halves.to(torch.bfloat16), p, [
            torch.tensor(0.25, device=dev), torch.tensor(0.0625, device=dev)]]}
    ptotals = collections.Counter()
    for key, entry in cases.items():
        x, p, scales = entry["args"]
        B, H, W, C = x.shape
        want = qc.pool_quantize_plain(x, p, scales)
        for impl in (None, "first"):
            got = qc.pool_quantize(x, p, scales, _impl=impl)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"pool_quantize {key}: the {impl or 'routed'} design differs from the plain "
                    f"version")
        if key[0] == "NaN":  # the plain version codes a NaN (a pool over one) 0
            nan = torch.isnan(qc.avg_pool(x.float(), p) if p > 1 else x)
            require(bool(nan.any()) and not any(bool(q[nan].any()) for q in want),
                    f"pool_quantize {key}: NaN not coded 0 by the plain version")
        launch = qc.pass_launch(B, H, W, C, p)
        if not entry["calls"]:
            print(f"pool_quantize {'x'.join(map(str, x.shape))} {str(x.dtype)[6:]}, pool {p}, "
                  f"{len(scales)} scale(s) ({key[0]}), launch {launch}: it and the first design "
                  f"equal to the plain version bit for bit")
            continue
        runs = {"kernel": lambda: qc.pool_quantize(x, p, scales),
                "first": lambda: qc.pool_quantize(x, p, scales, _impl="first"),
                "plain": lambda: qc.pool_quantize_plain(x, p, scales),
                "avg_pool2d": lambda: qc.avg_pool(x, p)}
        ms = {n: [] for n in runs}
        for order in (list(runs), list(runs)[::-1]):
            for n in order:
                ms[n].append(graph_ms(runs[n], QUANT_REPS))
        best = {n: min(v) for n, v in ms.items()}
        out_n = x.numel() // (p * p)
        nbytes = x.numel() * x.element_size() + len(scales) * out_n
        b_ms, by = bound_ms(nbytes, x.numel() + 4 * len(scales) * out_n, F32_PEAK)
        for n, v in best.items():
            ptotals[n] += entry["calls"] * v
        ptotals["bound"] += entry["calls"] * b_ms
        print(f"pool_quantize {'x'.join(map(str, x.shape))} {str(x.dtype)[6:]}, pool {p}, "
              f"{len(scales)} scale(s), {entry['calls']} calls, launch {launch}: it and the first "
              f"design equal to the plain version bit for bit; kernel {best['kernel']:.4f} ms "
              f"({b_ms / best['kernel']:.2f} of the bound), first design {best['first']:.4f} ms, "
              f"plain {best['plain']:.4f} ms, F.avg_pool2d alone {best['avg_pool2d']:.4f} ms; "
              f"bound {b_ms:.4f} ms ({by}) ({card})")
    n_pool = sum(e["calls"] for e in pools.values())
    print(f"pool_quantize over one teacher forward ({n_pool} calls): kernel "
          f"{ptotals['kernel']:.3f} ms ({ptotals['bound'] / ptotals['kernel']:.2f} of the bound), "
          f"first design {ptotals['first']:.3f} ms, plain {ptotals['plain']:.3f} ms, F.avg_pool2d "
          f"alone {ptotals['avg_pool2d']:.3f} ms, bound {ptotals['bound']:.3f} ms; the check took "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    return dict(max_abs_err=0.0, ms=ptotals["kernel"], first_ms=ptotals["first"],
                plain_ms=ptotals["plain"], bound_ms=ptotals["bound"], bound_by="bytes",
                library_ms=None, avg_pool2d_ms=ptotals["avg_pool2d"],
                per=f"summed over one teacher forward ({n_pool} calls)")


HEAD_REPS = 5  # calls a timing graph of one RoI-head kernel
POOL_ATTEND_REL = 1e-5  # pool_attend against its plain version, of the largest value
_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same dtype, NaN positions and bits everywhere else."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a.masked_fill(na, 0).view(_INT_VIEW[a.dtype]),
                                               b.masked_fill(nb, 0).view(_INT_VIEW[b.dtype]))


def bf16_ulps(a: torch.Tensor, b: torch.Tensor, floor: float = 0.0) -> float:
    """The largest |a - b| over the bf16 ulp at the larger magnitude, or over
    `floor` where that is larger."""
    a, b = a.float(), b.float()
    m = torch.maximum(a.abs(), b.abs())
    ulp = torch.exp2(torch.floor(torch.log2(torch.where(m > 0, m, torch.ones_like(m)))) - 7)
    return ((a - b).abs() / torch.clamp(ulp, min=floor)).max().item()


def record_head(teacher, images, boxes) -> dict:
    """One forward of the teacher with the RoI head's calls spied on (the
    names `regionclip` and `clip_resnet` look up): {name: (args, kwargs) of
    each call of the kernel's wrapper}, one call a chunk."""
    from ov3det_torch.models import clip_resnet as cr
    from ov3det_torch.models import regionclip as rc

    calls = {n: [] for n in HEAD_KERNELS}
    wrapped = {"roi_align": (rc, "roi_align_batched"), "pool_tokens": (cr, "pool_tokens"),
               "pool_attend": (cr, "pool_attend")}
    originals = {n: getattr(obj, attr) for n, (obj, attr) in wrapped.items()}

    def spy(name):
        def call(*args, **kwargs):
            kept = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
            if name == "roi_align":  # (B, Q, 4) boxes: the wrapper's (R, 4) and r // Q
                feat, bx, scale, P = kept
                calls[name].append(([feat, bx.reshape(-1, 4), None, scale, P, 2],
                                    {"per_image": bx.shape[1]}))
            else:
                calls[name].append((kept, dict(kwargs)))
            return originals[name](*args, **kwargs)
        return call

    for n, (obj, attr) in wrapped.items():
        setattr(obj, attr, spy(n))
    try:
        with torch.no_grad():
            teacher(images, boxes)
    finally:
        for n, (obj, attr) in wrapped.items():
            setattr(obj, attr, originals[n])
    torch.cuda.synchronize()
    return calls


def crafted_roi_boxes(B: int, per_image: int, h: float, w: float, seed: int) -> torch.Tensor:
    """(B * per_image, 4) boxes on h x w canvases: taps clipped at every
    border, a width clamped to 1e-6, an inverted box, a box on the canvas
    edge, two pixels, NaN and infinite coordinates (regions 5, 6, 7 and 9
    come out NaN), then seeded ones."""
    from ov3det_torch.models.regionclip import calibration_boxes

    nan, inf = float("nan"), float("inf")
    crafted = [[-30.0, -20.0, w + 40.0, h + 30.0], [100.0, 80.0, 100.0 + 1e-5, 90.0],
               [300.0, 200.0, 120.0, 60.0], [w - 1.0, h - 1.0, w + 50.0, h + 40.0],
               [16.0, 16.0, 18.0, 18.0], [nan, 40.0, 200.0, 300.0], [40.0, 40.0, 200.0, nan],
               [-inf, 40.0, inf, 300.0], [40.0, 40.0, inf, 300.0], [-inf, -inf, 90.0, 90.0]]
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([calibration_boxes(rng, h, w, n=per_image)[0] for _ in range(B)])
    boxes[:len(crafted)] = np.asarray(crafted, np.float32)
    return torch.from_numpy(boxes)


def in_turns(runs: dict, reps: int = HEAD_REPS) -> dict:
    """The smaller of two graph-replay times of each run, timed in order and
    in the reverse order."""
    ms = {n: [] for n in runs}
    for order in (list(runs), list(runs)[::-1]):
        for n in order:
            ms[n].append(graph_ms(runs[n], reps))
    return {n: min(v) for n, v in ms.items()}


def roi_align_ops(boxes: torch.Tensor, scale: float, H: int, W: int, P: int, C: int) -> int:
    """The f32 operations (a multiply and an add each) RoIAlign needs on these
    boxes: each live x slot of every column once for each map row some
    output row reads, then each live y slot of every output row once for
    every column; NaN rows need none."""
    from ov3det_torch.ops import roi_align as ra

    x1, bin_w, y1, bin_h = ra._box_axes(boxes, scale, P)
    _, _, vx, nan_x = ra._axis_slots(x1, bin_w, W, P)
    py, _, vy, nan_y = ra._axis_slots(y1, bin_h, H, P)
    vx, vy = vx & ~nan_x[..., None], vy & ~nan_y[..., None]
    rows = torch.zeros((boxes.shape[0], H), dtype=torch.int32, device=boxes.device)
    rows.scatter_add_(1, torch.where(vy, py, 0).flatten(1), vy.flatten(1).int())
    per_region = vx.sum(dim=(1, 2)) * (rows > 0).sum(dim=1) + P * vy.sum(dim=(1, 2))
    return int(2 * C * per_region.sum().item())


def check_head(card: str, teacher, images, boxes, dev: torch.device) -> dict:
    """Phase 10's check of the RoI head's kernels on the calls of one int8
    teacher forward on an OV batch (8 canvases x 128 boxes: 4 chunks of 256
    regions, each kernel once a chunk, `record_head`), in bf16 as called and
    in f32: `roi_align` equal to `roi_align_plain` bit for bit (NaN
    positions included), `pool_tokens` to `pool_tokens_plain`, `pool_attend`
    within 1 bf16 ulp of `pool_attend_plain` (f32: 1e-5 of the largest
    value), and each kernel's second launch equal to its first bit for bit;
    `roi_align` and `pool_attend` in both designs (the routed one and the
    first, `_impl="first"`); RoIAlign also on crafted boxes
    (`crafted_roi_boxes`) at the forward's map, batched and through an image
    index.  Then, at each chunk, in turns by graph replays: each kernel, the
    first design of the two redesigned ones, its plain version and its
    yardstick (RoIAlign: `roi_align_einsum`, the two contractions;
    `pool_tokens`: `torch.mean` in f32, the cast and + pos[0]; `pool_attend`:
    `F.scaled_dot_product_attention(u, tokens, tokens, scale=hd**-0.5)` on
    the concatenated tokens), beside the bound of this batch's work.
    Returns the kernels-line entries, times summed over the forward's 4
    calls."""
    from ov3det_torch.ops import roi_align as ra
    from ov3det_torch.ops.kernels import attn_pool as ap
    from ov3det_torch.ops.kernels import roi_align as kra

    t0 = time.perf_counter()
    calls = record_head(teacher, images, boxes)
    n = {k: len(v) for k, v in calls.items()}
    require(n == {k: TEACHER_STEP[k] for k in HEAD_KERNELS},
            f"the teacher's forward made {n} RoI-head kernel calls, expected 4 each")
    err = collections.Counter()
    for (args, kw) in calls["roi_align"]:
        feat, bx, index, scale, P, ratio = args
        for dtype in (torch.bfloat16, torch.float32):
            f = feat.to(dtype)
            want = ra.roi_align_plain(f, bx, index, scale, P, ratio, **kw)
            for impl in (None, "first"):
                got, again = (kra.roi_align(f, bx, index, scale, P, ratio, **kw, _impl=impl)
                              for _ in range(2))
                torch.cuda.synchronize()
                require(bits_equal(got, want), f"roi_align {tuple(f.shape)} {dtype} "
                                               f"({impl or 'routed'} design): the kernel differs "
                                               "from roi_align_plain")
                require(bits_equal(got, again), f"roi_align {dtype} ({impl or 'routed'} design): "
                                                "two launches differ")
    feat, _, _, scale, P, ratio = calls["roi_align"][0][0]
    B, H, W, C = feat.shape
    per_image = calls["roi_align"][0][1]["per_image"]
    crafted = crafted_roi_boxes(B, per_image, float(images.shape[1]), float(images.shape[2]),
                                20).to(dev)
    index = torch.from_numpy(np.random.default_rng(21).integers(0, B, crafted.shape[0])).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        f = feat.to(dtype)
        for (idx, kw), impl in itertools.product(((None, {"per_image": per_image}), (index, {})),
                                                 (None, "first")):
            got = kra.roi_align(f, crafted, idx, scale, P, ratio, **kw, _impl=impl)
            want = ra.roi_align_plain(f, crafted, idx, scale, P, ratio, **kw)
            torch.cuda.synchronize()
            nan_regions = torch.isnan(got).flatten(1).any(dim=1)[:10].tolist()
            require(bits_equal(got, want) and bits_equal(got, kra.roi_align(f, crafted, idx, scale,
                                                                          P, ratio, **kw,
                                                                          _impl=impl)),
                    f"roi_align crafted boxes {dtype} ({'index' if kw == {} else 'batched'}, "
                    f"{impl or 'routed'} design): the kernel differs from roi_align_plain or from "
                    "itself")
            require(nan_regions == [False] * 5 + [True] * 3 + [False, True],
                    f"roi_align crafted boxes: NaN regions {nan_regions}")
    for (args, kw) in calls["pool_tokens"]:
        x, pos0 = args
        for dtype in (torch.bfloat16, torch.float32):
            xd, pd = x.to(dtype), pos0.to(dtype)
            got, again = ap.pool_tokens(xd, pd), ap.pool_tokens(xd, pd)
            torch.cuda.synchronize()
            require(bits_equal(got, ap.pool_tokens_plain(xd, pd)) and bits_equal(got, again),
                    f"pool_tokens {tuple(xd.shape)} {dtype}: the kernel differs from its plain "
                    "version or from itself")
    for (args, kw), impl in itertools.product(calls["pool_attend"], (None, "first")):
        x, pos, token0, u, hd, out_dtype = args
        for dtype in (torch.bfloat16, torch.float32):
            a = [t.to(dtype) for t in (x, pos, token0, u)]
            od = out_dtype if dtype == torch.bfloat16 else torch.float32
            got, again = (ap.pool_attend(*a, hd, od, _impl=impl) for _ in range(2))
            want = ap.pool_attend_plain(*a, hd, od)
            torch.cuda.synchronize()
            label = f"pool_attend {dtype} ({impl or 'routed'} design)"
            require(bits_equal(got, again), f"{label}: two launches differ")
            require(torch.isfinite(got).all().item(), f"{label}: a value not finite")
            key = "pool_attend" if impl is None else "pool_attend first"
            if dtype == torch.bfloat16:
                # an ulp of the element, or 1e-5 of the largest value where
                # that is larger: an f32 sum in another order moves a value
                # near 0 (the sum of terms of both signs) by more than its ulp
                big = want.float().abs().max().item()
                ulps = bf16_ulps(got, want, POOL_ATTEND_REL * big)
                require(ulps <= 1, f"{label}: {ulps} bf16 ulps (or {POOL_ATTEND_REL} of the "
                                   "largest value) from the plain version")
                diff = (got.float() - want.float()).abs()
                err[key] = max(err[key], diff.max().item())
                err[f"{key} ulps"] = max(err[f"{key} ulps"], bf16_ulps(got, want))
                err[f"{key} off by one"] += int((diff > 0).sum())
                err[f"{key} values"] += diff.numel()
            else:
                rel = ((got - want).abs().max() / want.abs().max()).item()
                require(rel <= POOL_ATTEND_REL, f"{label}: {rel} of the largest value")
                err[f"{key} f32"] = max(err[f"{key} f32"], rel)
    print(f"RoI head: roi_align, pool_tokens and pool_attend at the 4 chunks of one int8 teacher "
          f"forward (8 canvases x 128 boxes), bf16 and f32, roi_align and pool_attend in both "
          f"designs: roi_align and pool_tokens equal to their plain versions bit for bit "
          f"(roi_align also on the crafted boxes, batched and by image index, NaN regions where "
          f"expected); pool_attend in bf16 within 1 bf16 ulp or {POOL_ATTEND_REL} of the largest "
          f"value (routed: {err['pool_attend off by one']} of {err['pool_attend values']} values "
          f"differ, by {err['pool_attend']:.3e} at most, {err['pool_attend ulps']:.1f} ulps of "
          f"their own; first: {err['pool_attend first off by one']} differ, by "
          f"{err['pool_attend first']:.3e} at most, {err['pool_attend first ulps']:.1f} ulps), "
          f"in f32 within {err['pool_attend f32']:.2e} (first {err['pool_attend first f32']:.2e}) "
          f"of the largest value; every second launch equal to the first "
          f"({time.perf_counter() - t0:.1f} s)")
    (x, _, _, u, _, _), _ = calls["pool_attend"][0]
    print(f"pool_attend's cluster design at {x.shape[1] + 1} tokens, {u.shape[1]} heads, C "
          f"{x.shape[2]}: {ap.clusters_held(x.shape[1] + 1, u.shape[1], x.shape[2])} clusters of "
          f"{ap.CLUSTER} CTAs on the card at once (cudaOccupancyMaxActiveClusters), "
          f"{x.shape[0]} clusters a call ({card})")

    totals = collections.defaultdict(collections.Counter)
    for i in range(len(calls["roi_align"])):
        (feat, bx, index, scale, P, ratio), kw = calls["roi_align"][i]
        Q = kw["per_image"]
        best = in_turns({"kernel": lambda: kra.roi_align(feat, bx, index, scale, P, ratio, **kw),
                         "first": lambda: kra.roi_align(feat, bx, index, scale, P, ratio, **kw,
                                                        _impl="first"),
                         "plain": lambda: ra.roi_align_plain(feat, bx, index, scale, P, ratio, **kw),
                         "library": lambda: ra.roi_align_einsum(feat, bx.view(B, Q, 4), scale, P)})
        es = feat.element_size()
        nbytes = feat.numel() * es + bx.numel() * 4 + bx.shape[0] * P * P * C * es
        b_ms, by = bound_ms(nbytes, roi_align_ops(bx, scale, H, W, P, C), F32_PEAK)
        totals["roi_align"].update(best, bound=b_ms, **{f"bound {by}": b_ms})
        (x, pos0), _ = calls["pool_tokens"][i]
        best = in_turns({"kernel": lambda: ap.pool_tokens(x, pos0),
                         "plain": lambda: ap.pool_tokens_plain(x, pos0),
                         "library": lambda: torch.mean(x, dim=1, dtype=torch.float32).to(x.dtype)
                         + pos0})
        R, L, Cp = x.shape
        b_ms, by = bound_ms((x.numel() + (R + 1) * Cp) * x.element_size(), R * Cp * (L + 2),
                            F32_PEAK)
        totals["pool_tokens"].update(best, bound=b_ms, **{f"bound {by}": b_ms})
        (x, pos, token0, u, hd, od), _ = calls["pool_attend"][i]
        tokens = torch.cat([token0[:, None], x + pos[None, 1:]], dim=1)[:, None]
        query = u[:, None]
        best = in_turns({"kernel": lambda: ap.pool_attend(x, pos, token0, u, hd, od),
                         "first": lambda: ap.pool_attend(x, pos, token0, u, hd, od, _impl="first"),
                         "plain": lambda: ap.pool_attend_plain(x, pos, token0, u, hd, od),
                         "library": lambda: torch.nn.functional.scaled_dot_product_attention(
                             query, tokens, tokens, scale=hd ** -0.5)})
        heads, es = u.shape[1], x.element_size()
        nbytes = (x.numel() + pos.numel() + token0.numel() + u.numel()) * es \
            + R * heads * Cp * torch.empty((), dtype=od).element_size()
        products = 2 * R * heads * (L + 1) * Cp  # the logits' or z's multiplies and adds
        if x.dtype == torch.bfloat16:  # exact bf16 products: the logits, and z in 3 bf16 terms
            b_ms, by = bound_ms(nbytes, 4 * products, BF16_PEAK)
        else:
            b_ms, by = bound_ms(nbytes, 2 * products, F32_PEAK)
        totals["pool_attend"].update(best, bound=b_ms, **{f"bound {by}": b_ms})
        del tokens, query
    library = {"roi_align": "roi_align_einsum (the two contractions)",
               "pool_tokens": "torch.mean(dtype=f32), the cast and + pos[0]",
               "pool_attend": "F.scaled_dot_product_attention on the concatenated tokens"}
    entries = {}
    for name, t in totals.items():
        by = "operations" if t["bound operations"] >= t["bound bytes"] else "bytes"
        first = (f", first design {t['first']:.4f} ms ({t['bound'] / t['first']:.2f} of the bound)"
                 if "first" in t else "")
        print(f"{name} over one teacher forward (4 calls): kernel {t['kernel']:.4f} ms "
              f"({t['bound'] / t['kernel']:.2f} of the bound){first}, plain {t['plain']:.4f} ms, "
              f"{library[name]} {t['library']:.4f} ms; bound {t['bound']:.4f} ms ({by}) (graph "
              f"replays, in turns) ({card})")
        entries[name] = dict(max_abs_err=err.get(name, 0.0), ms=t["kernel"], plain_ms=t["plain"],
                             bound_ms=t["bound"], bound_by=by, library_ms=t["library"],
                             library=library[name],
                             per="summed over one teacher forward (4 calls, 256 regions each)",
                             **({"first_ms": t["first"]} if "first" in t else {}))
    return entries


# the teacher's input end: one launch each a forward (`RegionCLIPTeacher.forward`'s
# normalisation; the stem's bn1, ReLU and quantise in the chain's first pass)
INPUT_KERNELS = ("normalise", "pool_quantize_affine")
INPUT_REPS = 20  # calls a timing graph of one input-end kernel


def record_input(teacher, images, boxes) -> dict:
    """One forward of the int8 teacher with its input end spied on (the
    names `regionclip` and `clip_resnet` look up): {"normalise": the
    arguments of each `normalise` call, "pool_quantize_affine": those of
    each `pool_quantize` call with an affine}."""
    from ov3det_torch.models import clip_resnet as cr
    from ov3det_torch.models import regionclip as rc

    calls = {n: [] for n in INPUT_KERNELS}
    norm, pool = rc.normalise, cr.pool_quantize

    def keep(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    def norm_spy(x, mean, inv_std, out_dtype=None):
        calls["normalise"].append([keep(x), keep(mean), keep(inv_std), out_dtype])
        return norm(x, mean, inv_std, out_dtype)

    def pool_spy(x, p, scales, affine=None, **kw):
        if affine is not None:
            calls["pool_quantize_affine"].append([keep(x), p, [keep(s) for s in scales],
                                                  tuple(keep(t) for t in affine)])
        return pool(x, p, scales, affine=affine, **kw)

    rc.normalise, cr.pool_quantize = norm_spy, pool_spy
    try:
        with torch.no_grad():
            teacher(images, boxes)
    finally:
        rc.normalise, cr.pool_quantize = norm, pool
    torch.cuda.synchronize()
    return calls


def sprinkle(x: torch.Tensor, values: list, n: int, seed: int) -> torch.Tensor:
    """A copy of x with `n` seeded positions set to `values`, cycled."""
    out = x.clone()
    flat = out.view(-1)
    g = torch.Generator(device=x.device).manual_seed(seed)
    idx = torch.randperm(flat.numel(), generator=g, device=x.device)[:n]
    flat[idx] = torch.tensor(values, dtype=torch.float32, device=x.device).repeat(
        -(-n // len(values)))[:n].to(x.dtype)
    return out


def misaligned(x: torch.Tensor, offset: int) -> torch.Tensor:
    """x copied into a buffer at `offset` bytes past a 16-byte boundary."""
    n = x.numel() * x.element_size()
    buf = torch.empty(n + 16, dtype=torch.uint8, device=x.device)
    view = buf[offset:offset + n].view(x.dtype).view(x.shape)
    view.copy_(x)
    return view


def check_teacher_input(card: str, teacher, images, boxes, dev: torch.device) -> dict:
    """Phase 10's check of the teacher's input end on one int8 forward of an
    OV batch (8 canvases of 530 x 730, 128 boxes each) and on the arguments
    that forward gives it (`record_input`): the forward launches `normalise`
    and the folded pass (`pool_quantize` with bn1's affine and the ReLU)
    once each, and the trunk's other passes 17 times;
    `normalise` equals `normalise_plain` bit for bit (NaN positions too) on
    the forward's uint8 canvases, on them as f32, as f32 with NaN,
    infinities and -0, into f32, off a 16-byte boundary (a load a value) as
    uint8 and f32, and on a canvas whose values end past the last 16-value
    piece; the folded pass equals `pool_quantize_plain(..., affine=)` bit for
    bit on the forward's conv1 output (bf16, one scale and two), as f32,
    with NaN, infinities and -0, on values whose quotients lie on
    half-integers, at C 8 (the channel wrapping twice in a piece) and on a
    tensor of pieces of 8 values; each second launch equals the first.  Then,
    in turns by graph replays: each kernel, its plain version and the
    library chain the forward ran before (`normalise`: the four library
    kernels of the plain version, which is that chain; the folded pass:
    bn1 and the ReLU as library ops, then the quantise pass), beside the
    bound of this batch's bytes.  Returns the kernels-line entries."""
    from ov3det_torch.ops.kernels import normalise as nk
    from ov3det_torch.ops.kernels import quant_conv as qc

    t0 = time.perf_counter()
    calls = record_input(teacher, images, boxes)
    n_calls = {k: len(v) for k, v in calls.items()}
    require(n_calls == {k: TEACHER_STEP[k] for k in INPUT_KERNELS},
            f"the teacher's forward made {n_calls} input-end calls, expected one each")
    before = read_counts()
    with torch.no_grad():
        teacher(images, boxes)
    torch.cuda.synchronize()
    after = read_counts()
    own = ("normalise", "pool_quantize_affine", "pool_quantize", "quant_conv")
    launched = {k: after[k] - before[k] for k in own}
    require(launched == {k: TEACHER_STEP[k] for k in own},
            f"teacher forward: launches {launched}, expected {({k: TEACHER_STEP[k] for k in own})}")

    img, mean, inv, odt = calls["normalise"][0]
    specials = [float("nan"), float("inf"), float("-inf"), -0.0, 0.0, 255.0, 1e-45, -1e30]
    cases = {"the forward's uint8 canvases": (img, odt),
             "the canvases as f32": (img.float(), odt),
             "f32 with NaN, infinities and -0": (sprinkle(img.float(), specials, 4096, 22), odt),
             "uint8 into f32": (img, None),
             "uint8 3 bytes past a 16-byte boundary": (misaligned(img, 3), odt),
             "f32 4 bytes past a 16-byte boundary": (misaligned(img.float(), 4), odt),
             "1 x 5 x 7 (105 values: 6 pieces and 9 more)": (img[:1, :5, :7].contiguous(), odt)}
    for label, (x, dt) in cases.items():
        want = nk.normalise_plain(x, mean, inv, dt)
        got = nk.normalise(x, mean, inv, dt)
        again = nk.normalise(x, mean, inv, dt)
        torch.cuda.synchronize()
        require(bits_equal(got, want) and bits_equal(again, got),
                f"normalise ({label}): the kernel differs from the plain version or itself")
        print(f"normalise {'x'.join(map(str, x.shape))} {str(x.dtype)[6:]} -> "
              f"{str(got.dtype)[6:]} ({label}), launch {nk.normalise_launch(x)}: equal to the "
              f"plain version bit for bit, two launches equal")

    h, _, scales, (w, b) = calls["pool_quantize_affine"][0]
    C = h.shape[-1]
    g = torch.Generator(device=dev).manual_seed(23)
    # bn1 with w = 1 and b = 0.125 on multiples of 0.25: every quotient by
    # 0.25 on a half-integer, rounded half to even by the division
    one, eighth = torch.ones(C, device=dev), torch.full((C,), 0.125, device=dev)
    quarters = (torch.randint(-100, 100, (2, 6, 10, C), generator=g, device=dev) * 0.25)
    small = [(torch.randn(shape, generator=g, device=dev) * 3, torch.rand(shape[-1], generator=g,
                                                                          device=dev) + 0.5,
              torch.randn(shape[-1], generator=g, device=dev)) for shape in ((2, 5, 7, 8),
                                                                            (1, 3, 5, 40))]
    bf = torch.bfloat16
    fold = {"the forward's conv1 output": (h, scales, w, b),
            "the same at two scales": (h, scales + [scales[0] * 0.37], w, b),
            "the same as f32": (h.float(), scales, w.float(), b.float()),
            "with NaN, infinities and -0": (sprinkle(h, specials, 4096, 24), scales, w, b),
            "quotients on half-integers": (quarters.to(bf), [torch.tensor(0.25, device=dev)],
                                           one.to(bf), eighth.to(bf)),
            "C 8, the channel wrapping twice in a piece": (small[0][0].to(bf), scales,
                                                           small[0][1].to(bf), small[0][2].to(bf)),
            "1 x 3 x 5 x 40, pieces of 8": (small[1][0].to(bf), scales, small[1][1].to(bf),
                                            small[1][2].to(bf))}
    for label, (x, ss, wt, bt) in fold.items():
        want = qc.pool_quantize_plain(x, 1, ss, affine=(wt, bt))
        got = qc.pool_quantize(x, 1, ss, affine=(wt, bt))
        again = qc.pool_quantize(x, 1, ss, affine=(wt, bt))
        torch.cuda.synchronize()
        require(all(torch.equal(a, c) and torch.equal(a, d) for a, c, d in zip(got, want, again)),
                f"the folded pass ({label}): the kernel differs from the plain version or itself")
        B, H, W, Cx = x.shape
        print(f"pool_quantize with bn1's affine and the ReLU, {'x'.join(map(str, x.shape))} "
              f"{str(x.dtype)[6:]}, {len(ss)} scale(s) ({label}), launch "
              f"{qc.pass_launch(B, H, W, Cx, 1)}: equal to the plain version bit for bit, two "
              f"launches equal")

    n_img = img.numel()
    best_n = in_turns({"kernel": lambda: nk.normalise(img, mean, inv, odt),
                       "plain": lambda: nk.normalise_plain(img, mean, inv, odt),
                       "kernel, f32 canvases": lambda: nk.normalise(cases["the canvases as f32"][0],
                                                                     mean, inv, odt)},
                      INPUT_REPS)
    out_size = torch.empty((), dtype=odt or torch.float32).element_size()
    n_ms, n_by = bound_ms(n_img * (img.element_size() + out_size), 2 * n_img, F32_PEAK / 2)
    f32_ms, _ = bound_ms(n_img * (4 + out_size), 2 * n_img, F32_PEAK / 2)
    print(f"normalise over one teacher forward (1 call, {'x'.join(map(str, img.shape))} "
          f"{str(img.dtype)[6:]} -> {str(odt)[6:]}): kernel {best_n['kernel']:.4f} ms "
          f"({n_ms / best_n['kernel']:.2f} of the bound), plain (the library chain the forward ran "
          f"before) {best_n['plain']:.4f} ms; bound {n_ms:.4f} ms ({n_by}); f32 canvases: kernel "
          f"{best_n['kernel, f32 canvases']:.4f} ms, bound {f32_ms:.4f} ms (graph replays, in "
          f"turns) ({card})")

    n_h = h.numel()
    best_f = in_turns({"kernel": lambda: qc.pool_quantize(h, 1, scales, affine=(w, b)),
                       "plain": lambda: qc.pool_quantize_plain(h, 1, scales, affine=(w, b)),
                       "chain": lambda: qc.pool_quantize(torch.relu(h * w + b), 1, scales),
                       "pass alone": lambda: qc.pool_quantize(h, 1, scales)}, INPUT_REPS)
    f_ms, f_by = bound_ms(n_h * h.element_size() + len(scales) * n_h + 2 * C * w.element_size(),
                          n_h * (3 + 4 * len(scales)), F32_PEAK / 2)
    print(f"the folded pass over one teacher forward (1 call, {'x'.join(map(str, h.shape))} "
          f"{str(h.dtype)[6:]}, {len(scales)} scale): kernel {best_f['kernel']:.4f} ms "
          f"({f_ms / best_f['kernel']:.2f} of the bound), the chain the forward ran before (bn1 and "
          f"the ReLU as library ops, then the pass) {best_f['chain']:.4f} ms, the pass alone "
          f"without the affine {best_f['pass alone']:.4f} ms, plain {best_f['plain']:.4f} ms; "
          f"bound {f_ms:.4f} ms ({f_by}) (graph replays, in turns); the check took "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    return {"normalise": dict(max_abs_err=0.0, ms=best_n["kernel"], plain_ms=best_n["plain"],
                              bound_ms=n_ms, bound_by=n_by, library_ms=None,
                              f32_canvases_ms=best_n["kernel, f32 canvases"],
                              f32_canvases_bound_ms=f32_ms,
                              per="one teacher forward (1 call); plain = the library chain"),
            "pool_quantize_affine": dict(max_abs_err=0.0, ms=best_f["kernel"],
                                         plain_ms=best_f["plain"], bound_ms=f_ms, bound_by=f_by,
                                         library_ms=None, chain_ms=best_f["chain"],
                                         pass_alone_ms=best_f["pass alone"],
                                         chain="bn1 and the ReLU as library ops, then the pass",
                                         per="one teacher forward (1 call)")}


def einsum_head(teacher):
    """`teacher` with the RoI head as library ops: RoIAlign as the two
    contractions (`roi_align_einsum`) and the pool's mean token by
    `torch.mean` and its attention by einsums (`pool_attend_plain`), the
    module-level names swapped for the call as `teacher_forward_times`
    swaps `quant_conv`."""
    from ov3det_torch.models import clip_resnet as cr
    from ov3det_torch.models import regionclip as rc
    from ov3det_torch.ops import roi_align as ra
    from ov3det_torch.ops.kernels import attn_pool as ap

    def mean_token(x, pos0):
        return x.float().mean(dim=1).to(x.dtype) + pos0

    def run(*args):
        saved = rc.roi_align_batched, cr.pool_tokens, cr.pool_attend
        rc.roi_align_batched, cr.pool_tokens, cr.pool_attend = (ra.roi_align_einsum, mean_token,
                                                                ap.pool_attend_plain)
        try:
            return teacher(*args)
        finally:
            rc.roi_align_batched, cr.pool_tokens, cr.pool_attend = saved

    return run


def teacher_parts(card: str, teacher, images, boxes) -> None:
    """The teacher forward's ranges (`TEACHER_RANGES`) read from a profile
    of one forward with the kernels and one with the einsum RoI head
    (`einsum_head`), each with its peak device memory above what it was
    given; a forward with the kernels launches each RoI-head kernel 4 times."""
    old = einsum_head(teacher)
    for label, fn in (("kernels", teacher), ("the einsum RoI head", old)):
        def forward(fn=fn):
            with torch.no_grad():
                return fn(images, boxes)

        forward()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = read_counts()
        forward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        after = read_counts()
        launched = {k: after[k] - before[k] for k in (*HEAD_KERNELS, *INPUT_KERNELS)}
        want = {**{k: TEACHER_STEP[k] if fn is teacher else 0 for k in HEAD_KERNELS},
                **{k: TEACHER_STEP[k] for k in INPUT_KERNELS}}
        require(launched == want, f"teacher forward ({label}): launches {launched}, "
                                  f"expected {want}")
        print(f"teacher forward ({label}), 8 canvases x 128 boxes: peak device memory "
              f"{peak / 2**20:.1f} MiB above its inputs and weights; launches {launched} ({card})")
        profile(f"profiled teacher forward ({label})", forward, ranges=TEACHER_RANGES, range_top=6)


def teacher_card_vs_cpu(state: dict, image: np.ndarray, boxes: np.ndarray,
                        dev: torch.device) -> None:
    """The full RN50x4 teacher on one canvas and 8 boxes, on the card and on
    the CPU from the same weights: f32 features within 1e-3 of the largest
    value; int8 (quantised and calibrated on the card, the same state on
    both) cosine >= 0.999 per region and within INT8_CARD_VS_CPU of the
    largest value, a limit that the int8 teacher's distance from a bf16 one
    on the card (printed beside it) exceeds; the fused int8 teacher (the
    kernel chain) equal to the unfused one (the plain module path) on the
    card bit for bit."""
    from ov3det_torch.models.regionclip import RegionCLIPTeacher, quantize_teacher_params

    img, bx = torch.from_numpy(image), torch.from_numpy(boxes)
    feats = {}
    for dtype in (None, "bfloat16", "int8"):
        card = RegionCLIPTeacher(compute_dtype=dtype, device=dev)
        if dtype is None:
            s_card = {k: v.to(dev) for k, v in state.items()}
        elif dtype == "bfloat16":
            s_card = quantize_teacher_params({k: v.to(dev) for k, v in state.items()}, dtype)
        else:
            t0 = time.perf_counter()
            s_card = quantize_teacher_params({k: v.to(dev) for k, v in state.items()}, "int8",
                                             teacher=card, calib=(image.astype(np.float32), boxes))
            torch.cuda.synchronize()
            print(f"teacher int8 quantisation and calibration on the card: "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        card.load(s_card)
        if dtype == "bfloat16":  # the card alone: the yardstick of the int8 limit
            with torch.no_grad():
                feats[dtype] = card(img.to(dev), bx.to(dev)).cpu()
            del card, s_card
            continue
        cpu = RegionCLIPTeacher(compute_dtype=dtype, device="cpu").load(
            {k: v.cpu() for k, v in s_card.items()})
        with torch.no_grad():
            got = card(img.to(dev), bx.to(dev)).cpu()
            t0 = time.perf_counter()
            want = cpu(img, bx)
            cpu_s = time.perf_counter() - t0
        require(got.shape == (1, 8, 640) and torch.isfinite(got).all(), "teacher: bad features")
        feats[dtype] = got
        if dtype is None:
            err = ((got - want).abs().max() / want.abs().max()).item()
            require(err <= 1e-3, f"teacher f32: card vs CPU {err} of the largest value")
            print(f"teacher f32, one canvas, 8 boxes: card vs CPU within {err:.2e} of the largest "
                  f"value (the CPU forward {cpu_s:.1f} s)")
        else:
            unfused = card.clone(fused=False).load(s_card)
            with torch.no_grad():
                plain = unfused(img.to(dev), bx.to(dev)).cpu()
            require(torch.equal(got, plain), "teacher int8: the fused teacher differs from the "
                                             f"unfused one on the card by {(got - plain).abs().max()}")
            cos = torch.nn.functional.cosine_similarity(got[0], want[0], dim=-1)
            err = ((got - want).abs().max() / want.abs().max()).item()
            vs_bf16 = ((got - feats["bfloat16"]).abs().max() / got.abs().max()).item()
            vs_f32 = torch.nn.functional.cosine_similarity(got[0], feats[None][0], dim=-1)
            require(cos.min().item() >= 0.999, f"teacher int8: card vs CPU cosine {cos.tolist()}")
            require(err <= INT8_CARD_VS_CPU,
                    f"teacher int8: card vs CPU {err} of the largest value (bf16 is {vs_bf16})")
            print(f"teacher int8, one canvas, 8 boxes: fused (the quant_conv chain) equal to the "
                  f"unfused module path on the card bit for bit; card vs CPU cosine >= "
                  f"{cos.min().item():.7f}, within {err:.2e} of the largest value (limit "
                  f"{INT8_CARD_VS_CPU:.0e}; the bf16 teacher on the card is {vs_bf16:.2e} from "
                  f"the int8 one); int8 vs f32 on the card: cosine {vs_f32.min().item():.4f} to "
                  f"{vs_f32.max().item():.4f} (random weights, noise canvas; not a gate) "
                  f"(the CPU forward {cpu_s:.1f} s)")
            del unfused
        del card, cpu, s_card


def teacher_forward_times(card: str, teacher, state: dict, images, boxes,
                          dev: torch.device) -> None:
    """The teacher's forward alone on one OV batch (8 canvases, 128 boxes
    each, 4 chunks of 256 regions): the fused int8 teacher the step runs,
    the same with every trunk conv on the first design, the same with the
    einsum RoI head (`einsum_head`), the unfused int8 module path and a bf16
    teacher from the same weights, timed in turns (and in the reverse
    order); the fused features equal the unfused ones, and the first
    design's, bit for bit, and the einsum head's within cosine 0.999."""
    from ov3det_torch.models import clip_resnet as cr
    from ov3det_torch.models.regionclip import RegionCLIPTeacher, quantize_teacher_params

    unfused = teacher.clone(fused=False).load(teacher.state_dict())
    bf16 = RegionCLIPTeacher(compute_dtype="bfloat16", device=dev)
    bf16.load(quantize_teacher_params({k: v.to(dev) for k, v in state.items()}, "bfloat16"))
    routed = cr.quant_conv

    def first_design(*args):
        cr.quant_conv = functools.partial(routed, _impl="mma")
        try:
            return teacher(*args)
        finally:
            cr.quant_conv = routed

    models = {"int8 fused": teacher, "int8 fused, first design": first_design,
              "int8 fused, einsum RoI head": einsum_head(teacher), "int8 unfused": unfused,
              "bf16": bf16}
    ms = {n: [] for n in models}
    with torch.no_grad():
        for name in list(models) + list(models)[::-1]:
            ms[name].append(cuda_ms(lambda: models[name](images, boxes), 2))
        got, plain = teacher(images, boxes), unfused(images, boxes)
        require(torch.equal(got, plain), "teacher forward: fused and unfused int8 features differ")
        require(torch.equal(got, first_design(images, boxes)),
                "teacher forward: the wgmma and first designs' int8 features differ")
        cos = torch.nn.functional.cosine_similarity(got, bf16(images, boxes), dim=-1)
        old = models["int8 fused, einsum RoI head"](images, boxes)
        old_cos = torch.nn.functional.cosine_similarity(got, old, dim=-1).min().item()
        require(old_cos >= 0.999, f"teacher forward: the kernels' features against the einsum RoI "
                                  f"head's: cosine {old_cos}")
    best = {n: min(v) for n, v in ms.items()}
    print(f"teacher forward alone, 8 canvases x 128 boxes: int8 fused {best['int8 fused']:.2f} ms "
          f"(the first design {best['int8 fused, first design']:.2f} ms; the einsum RoI head "
          f"{best['int8 fused, einsum RoI head']:.2f} ms, cosine >= {old_cos:.6f} to the "
          f"kernels' features), "
          f"int8 unfused {best['int8 unfused']:.2f} ms, bf16 {best['bf16']:.2f} ms (CUDA events, "
          f"in turns; each {ms}); fused equal to unfused bit for bit; int8 fused "
          f"{'no slower' if best['int8 fused'] <= best['bf16'] else 'SLOWER'} than bf16; int8 vs "
          f"bf16 cosine >= {cos.min().item():.4f} ({card})")
    del unfused, bf16


def ov_config():
    """"OV sunrgbd_quick": sunrgbd_quick() with the 2D-alignment loss at
    weight 1, as bench.py:518-530 builds it."""
    from ov3det_torch.config import sunrgbd_quick

    base = sunrgbd_quick()
    return dataclasses.replace(base, loss=dataclasses.replace(base.loss, alignment_2d_weight=1.0))


def ov_batches(cfg, n: int, seed: int) -> list:
    """n numpy batches of 8 `SyntheticOVDataset` scenes x 20 000 points
    (530 x 730 uint8 canvases), the config's classes and angle bins."""
    from ov3det_torch.datasets.loader import collate
    from ov3det_torch.datasets.synthetic import SyntheticOVDataset

    ds = SyntheticOVDataset(size=n * BATCH, seed=seed, num_points=cfg.data.num_points,
                            num_semcls=cfg.model.num_semcls, num_angle_bin=cfg.model.num_angle_bin)
    return [collate([ds[i * BATCH + j] for j in range(BATCH)]) for i in range(n)]


CLI_RUNS = {}  # label -> wall, iteration times, loader waits and peak memory of an OV CLI run


def ov_cli(card: str, dev: torch.device, argv: list = OV_CLI_ARGV, label: str = "ov cli") -> tuple:
    """`main(argv)` with --use_image at the full width of sunrgbd_quick (the
    synthetic set unless `argv` names another): one epoch of 8 steps and its
    evals; every step launches as a training step,
    every eval batch as a request; the checkpoint holds the detector and its
    optimiser only, the same keys, shapes and size as a point-only run's.
    Returns the launch counts and the loop's waits on the loader."""
    import tempfile

    from ov3det_torch import main as cli
    from ov3det_torch.engine.checkpoint import CheckpointManager
    from ov3det_torch.engine.train import build_training

    train_step = ov_step()
    eval_batch = expect(**sa(train=False), **norms(train=False), fps=2, ball_group=1, attention_fwd=3)
    probe = CliProbe()
    with tempfile.TemporaryDirectory(prefix="ov3det_ov_cli_") as run:
        argv = argv + ["--checkpoint_dir", run]
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        training, lines = run_cli(probe, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        for line in lines:
            if not (" Average Precision: " in line or " Recall: " in line):
                print(f"{label}| {line}")
        require(training.teacher is not None and training.teacher.compute_dtype == "int8",
                f"{label}: no int8 teacher")
        require(len(probe.steps) == 8, f"{label}: {len(probe.steps)} training steps, expected 8")
        require(all(d == train_step for _, _, d in probe.steps),
                f"{label}: a step launched {[d for _, _, d in probe.steps if d != train_step][:1]}")
        require(bool(probe.evals) and all(d == eval_batch for d in probe.evals),
                f"{label}: an eval batch launched {[d for d in probe.evals if d != eval_batch][:1]}")
        path = os.path.join(run, "checkpoint")
        require(os.path.isfile(path) and os.path.isfile(os.path.join(run, "final_eval.txt")),
                f"{label}: no checkpoint or final_eval.txt")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        teacher_keys = set(training.teacher.state_dict())
        require(not teacher_keys & set(payload["model"])
                and set(payload["model"]) == set(training.model.state_dict()),
                f"{label}: the checkpoint holds more than the detector")
        cfg = cli.config_from_args(cli.make_args_parser().parse_args(argv))
        point = build_training(dataclasses.replace(cfg, teacher=dataclasses.replace(
            cfg.teacher, enabled=False)), 8, device=dev, seed=cfg.seed)
        with tempfile.TemporaryDirectory(prefix="ov3det_point_ckpt_") as other:
            ref = CheckpointManager(other).save(point.model, point.optimizer, 0)
            ref_payload = torch.load(ref, map_location="cpu", weights_only=True)
            ref_size, size = os.path.getsize(ref), os.path.getsize(path)
        require({k: v.shape for k, v in payload["model"].items()}
                == {k: v.shape for k, v in ref_payload["model"].items()}
                and abs(size - ref_size) <= 0.001 * ref_size,
                f"{label}: checkpoint {size} B against a point-only run's {ref_size} B")
    counts = read_counts()
    iters = [(b[0] - a[0]) * 1e3 for a, b in zip(probe.steps, probe.steps[1:])]
    CLI_RUNS[label] = dict(wall=wall, iters=iters, waits=list(probe.waits), peak=peak)
    print(f"{label} run: {wall:.2f} s wall (teacher build and calibration, 8 steps, evals, "
          f"checkpoints), iteration (host clock, step start to step start) median "
          f"{np.median(iters):.2f} ms, {min(iters):.2f} to {max(iters):.2f}; peak device memory "
          f"{peak / 2**30:.3f} GiB; checkpoint {size / 1e6:.2f} MB, a point-only run's "
          f"{ref_size / 1e6:.2f} MB, no teacher tensor ({card})")
    print(f"{label} launches: { {n: c for n, c in counts.items() if c} }")
    return counts, probe.waits


def ov_phase(card: str, dev: torch.device) -> tuple:
    """Phase 10: the open-vocabulary step; returns the launch counts of its
    training run and of its CLI run, the CLI's waits on the loader, the
    kernels-line entries of `quant_conv`, `pool_quantize`, `roi_align`,
    `pool_tokens` and `pool_attend`, and the launch counts of the teacher
    build's calibration forward."""
    from ov3det_torch import main as cli
    from ov3det_torch.models.regionclip import (
        RegionCLIPTeacher,
        calibration_boxes,
        init_teacher_state,
    )

    t_phase = time.perf_counter()
    cfg = ov_config()
    batches = ov_batches(cfg, OV_STEPS + 1, 700)
    first = {k: v[0] for k, v in batches[0].items()}
    boxes = calibration_boxes(np.random.default_rng(0), float(first["image_height"]),
                              float(first["image_width"]))
    t0 = time.perf_counter()
    state = init_teacher_state(RegionCLIPTeacher(device="cpu"), seed=0)
    print(f"teacher: RN50x4 seeded f32 weights drawn in {time.perf_counter() - t0:.1f} s, "
          f"{sum(v.numel() for v in state.values()) / 1e6:.2f} M values")
    teacher_card_vs_cpu(state, first["image"][None], boxes, dev)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    teacher = cli.build_teacher(cfg, first, dev)
    torch.cuda.synchronize()
    calibration = read_counts()
    launched = {k: calibration[k] for k in (*HEAD_KERNELS, *INPUT_KERNELS)}
    # the calibration runs the dynamic-scale tower, no chain: bn1 is a module there
    require(launched == {**{k: 1 for k in HEAD_KERNELS}, "normalise": 1,
                         "pool_quantize_affine": 0},
            f"the calibration forward (8 boxes, one chunk) launched {launched}")
    print(f"teacher build (seeded weights, int8 quantisation, calibration on the card): "
          f"{time.perf_counter() - t0:.2f} s; the calibration forward's RoI-head launches "
          f"{launched}")
    images, regions = torch.from_numpy(batches[0]["image"]).to(dev), ov_boxes(dev)
    entries = check_quant_conv(card, teacher, images, regions, dev)
    entries.update(check_teacher_input(card, teacher, images, regions, dev))
    entries.update(check_head(card, teacher, images, regions, dev))
    teacher_forward_times(card, teacher, state, images, regions, dev)
    teacher_parts(card, teacher, images, regions)
    del state, images, regions
    gc.collect()
    torch.cuda.empty_cache()
    nbytes = sum(v.nbytes for v in batches[0].values())
    print(f"one OV batch crossing to the card: {nbytes / 1e6:.2f} MB, of which the uint8 "
          f"canvases {batches[0]['image'].nbytes / 1e6:.2f} MB (int64 would make them "
          f"{8 * batches[0]['image'].nbytes / 1e6:.2f} MB)")
    trained = train(cfg, OV_STEPS, ov_step(), "ov_sunrgbd", 700, dev, teacher=teacher,
                    batches=batches)
    del teacher, batches
    gc.collect()
    cli_counts, waits = ov_cli(card, dev)
    print(f"phase 10 (the open-vocabulary step): {time.perf_counter() - t_phase:.1f} s")
    return trained, cli_counts, waits, entries, calibration


# ------------------------------------------------------------ phase 11: the pseudo-label round
PSEUDO_TRAIN, PSEUDO_VAL = 16, 8  # scans of the ScanNet-layout tree (2 and 1 batches of 8)
# the CLI at scannet_quick()'s width with the flags of scripts/scannet_quick.sh
PSEUDO_ARGV = ["--dataset_name", "scannet", "--device", "cuda", "--batchsize_per_gpu", "8",
               "--compute_dtype", "bfloat16", "--nqueries", "256", "--matcher_giou_cost", "2",
               "--matcher_cls_cost", "1", "--matcher_center_cost", "0",
               "--matcher_objectness_cost", "0", "--loss_giou_weight", "1",
               "--loss_no_object_weight", "0.25", "--save_separate_checkpoint_every_epoch", "-1",
               "--max_epoch", "1", "--log_every", "1"]
LIFT_FRAMES, LIFT_HW = 4, (240, 320)  # frames of the lifted scene; ScanNet's depth maps, halved
TEXT_CHECK_PROMPTS = 30  # prompts (2 classes x 15 templates) also run on the CPU


def write_png16(path: str, image: np.ndarray) -> None:
    """A 16-bit greyscale PNG of `image`, each scanline with the Up filter,
    written with zlib (the port reads PNGs without PIL)."""
    import struct
    import zlib

    H, W = image.shape
    rows = np.ascontiguousarray(image.astype(">u2")).view(np.uint8).reshape(H, 2 * W)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]  # modulo 256
    raw = np.concatenate([np.full((H, 1), 2, np.uint8), up], 1).tobytes()

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 16, 0, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@contextlib.contextmanager
def eval_spy(module, record: list):
    """Wrap `module.make_eval_step`: each eval batch appends (host ms to its
    sync, launch deltas) to `record`."""
    make = module.make_eval_step

    def make_eval_step(*args, **kwargs):
        step = make(*args, **kwargs)

        def eval_step(batch):
            before = read_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize()
            after = read_counts()
            record.append(((time.perf_counter() - t) * 1e3, {n: after[n] - before[n] for n in after}))
            return out
        return eval_step

    module.make_eval_step = make_eval_step
    try:
        yield
    finally:
        module.make_eval_step = make


def pseudo_pass(argv: list, label: str) -> tuple:
    """`generate_pseudo_label.main(argv)` in this process: (boxes written,
    wall s, [(batch ms, launches)], the formatter's rows before the
    thresholds)."""
    from ov3det_torch import generate_pseudo_label as gpl

    batches, rows, out = [], [], io.StringIO()
    run_inference = gpl.run_inference

    def keep_rows(cfg, args, device=None):
        formatter = run_inference(cfg, args, device)
        rows.append(np.concatenate(formatter.boxes))
        return formatter

    gpl.run_inference = keep_rows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with eval_spy(gpl, batches), contextlib.redirect_stdout(out):
            n = gpl.main(argv)
    finally:
        gpl.run_inference = run_inference
    wall = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        print(f"{label}| {line}")
    return n, wall, batches, rows[0]


def pseudo_thresholds(rows: np.ndarray, slots: int) -> tuple:
    """(conf, obj): the median score, and the median objectness raised just
    above the (slots + 1)-th largest objectness, among the rows at or over
    that score, of each scan that has more: no scan keeps more rows than
    the loader has GT slots."""
    conf = np.median(rows[:, 7])
    obj = np.median(rows[:, 8])
    over = rows[rows[:, 7] >= conf]
    for i in np.unique(over[:, 9]):
        ranked = np.sort(over[over[:, 9] == i, 8])[::-1]
        if len(ranked) > slots:
            obj = max(obj, np.nextafter(ranked[slots], np.float32(np.inf)))
    return float(conf), float(obj)


def paint_labels(tree: dict, scan_names: list, boxes: np.ndarray, out: str) -> None:
    """Label files for `--label_dir`: each scan's own point labels, over
    which each of its `boxes` (formatter rows) paints the points inside it,
    the scan's first box on top, alternately with the box's class and with
    the next class, so that the filter has boxes to keep and boxes to drop."""
    os.makedirs(out)
    for i, scan in enumerate(scan_names):
        labelled = np.load(os.path.join(tree["label_dir"], f"{scan}.npy"))
        xyz, cls = labelled[:, :3], labelled[:, 3].copy()
        mine = boxes[boxes[:, 9] == i]
        for j in range(len(mine) - 1, -1, -1):
            box = mine[j]
            inside = np.all(np.abs(xyz - box[:3]) <= box[3:6] / 2, axis=-1)
            cls[inside] = box[6] if j % 2 == 0 else (box[6] + 1) % 18
        np.save(os.path.join(out, f"{scan}.npy"), np.concatenate([xyz, cls[:, None]], 1))


def kept_reference(rows: np.ndarray, conf: float, obj: float, label_dir: str,
                   scan_names: list) -> list:
    """The boxes `--label_dir` keeps, scan by scan, by a direct count: score
    and objectness at or over the thresholds, and the box's class the most
    common one (ties to the lower) among the points inside it whose label
    is a class (below 18)."""
    kept = []
    for i, scan in enumerate(scan_names):
        labelled = np.load(os.path.join(label_dir, f"{scan}.npy"))
        xyz, cls = labelled[:, :3], labelled[:, 3].astype(np.int64)
        mine = rows[(rows[:, 9] == i) & (rows[:, 7] >= conf) & (rows[:, 8] >= obj)]
        keep = []
        for box in mine:
            inside = (np.all((xyz >= box[:3] - box[3:6] / 2) & (xyz <= box[:3] + box[3:6] / 2),
                             axis=-1) & (cls < 18))
            keep.append(bool(inside.any())
                        and np.bincount(cls[inside], minlength=18).argmax() == box[6])
        kept.append(mine[np.array(keep, bool)])
    return kept


def pseudo_card_vs_cpu(cfg, ckpt: str, dataset, dev: torch.device) -> None:
    """The first batch's formatter rows from the card and from the CPU, the
    same checkpoint at f32 (TF32 off): centres and sizes within 1e-3, score
    and objectness within 1e-4, the labels wherever the CPU's top-2 margin
    exceeds 1e-4."""
    from ov3det_torch.datasets.loader import collate
    from ov3det_torch.engine.checkpoint import restore_eval_checkpoint
    from ov3det_torch.engine.infer import make_eval_step
    from ov3det_torch.engine.train import batch_to_device
    from ov3det_torch.models.detr3d import Model3DETR
    from ov3det_torch.tools.label_formatter import LabelFormatter

    model_cfg = dataclasses.replace(cfg.model, compute_dtype="float32")
    batch = collate([dataset[i] for i in range(BATCH)])
    rows, probs, secs = {}, {}, {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = Model3DETR(model_cfg, device=device)
        restore_eval_checkpoint(model, ckpt)
        t0 = time.perf_counter()
        out = make_eval_step(model)(batch_to_device(batch, device))
        formatter = LabelFormatter(None, None, dataset.scan_names, model_cfg.num_semcls)
        formatter.step(out, batch)
        secs[name] = time.perf_counter() - t0
        rows[name], probs[name] = formatter.boxes[0], out["sem_cls_prob"].float().cpu()
        del model, out
    card, cpu = rows["card"], rows["cpu"]
    top2 = probs["cpu"].reshape(-1, probs["cpu"].shape[-1]).topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1] > 1e-4).numpy()
    geo = np.abs(card[:, :6] - cpu[:, :6]).max()
    prob = np.abs(card[:, 7:9] - cpu[:, 7:9]).max()
    require(card.shape == cpu.shape == (BATCH * model_cfg.num_queries, 10), f"pseudo rows {card.shape}")
    require(np.isfinite(card).all(), "pseudo card vs CPU: non-finite rows on the card")
    require(geo <= 1e-3, f"pseudo card vs CPU: centres and sizes differ by {geo}")
    require(prob <= 1e-4, f"pseudo card vs CPU: score or objectness differ by {prob}")
    require(np.array_equal(card[decided, 6], cpu[decided, 6]),
            "pseudo card vs CPU: a label differs where the top-2 margin exceeds 1e-4")
    require(np.array_equal(card[:, 9], cpu[:, 9]), "pseudo card vs CPU: scan indices differ")
    print(f"pseudo card vs CPU (f32 checkpoint, first batch, {len(card)} rows): centres and sizes "
          f"within {geo:.2e}, score and objectness within {prob:.2e}, labels equal on "
          f"{int(decided.sum())} rows with a top-2 margin above 1e-4 ({int((~decided).sum())} "
          f"below it; {int((card[:, 6] != cpu[:, 6]).sum())} of all rows differ); the eval forward "
          f"{secs['card']:.2f} s on the card, {secs['cpu']:.2f} s on the CPU")


def lift_scene(tree: dict, scan: str, run: str) -> int:
    """`lift_scene_scannet` on one scene seen from LIFT_FRAMES cameras: 2D
    boxes around the projections of its labelled GT boxes' points, depth
    PNGs from `write_png16`; returns the boxes lifted."""
    from ov3det_torch.tools.lift_boxes import LiftConfig, lift_scene_scannet

    H, W = LIFT_HW
    frames = os.path.join(run, "frames", scan)
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(frames, sub))
    b2d = os.path.join(run, "boxes2d", scan, "color")
    os.makedirs(b2d)
    f, cx, cy = 400.0, 320.0, 240.0  # 640 x 480 depth intrinsics, halved by the lifting
    np.savetxt(os.path.join(frames, "intrinsic_depth.txt"),
               np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
    labelled = np.load(os.path.join(tree["label_dir"], f"{scan}.npy"))
    xyz, cls = labelled[:, :3], labelled[:, 3].astype(np.int64)
    gt = np.load(os.path.join(tree["root_dir"], f"{scan}_bbox.npy"))
    nyu = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])
    rng = np.random.default_rng(1100)
    for fid in range(LIFT_FRAMES):
        # a camera 7 m back along -y looking at +y, image y down (world -z)
        pose = np.array([[1.0, 0, 0, 0], [0, 0, 1, -7.0], [0, -1, 0, 1.0], [0, 0, 0, 1]])
        pose[:3, 3] += rng.normal(0, 0.05, 3)
        cam = (np.linalg.inv(pose) @ np.concatenate([xyz, np.ones((len(xyz), 1))], 1).T)[:3]
        u = cam[0] * (f / 2) / cam[2] + cx / 2
        v = cam[1] * (f / 2) / cam[2] + cy / 2
        rows = []
        for box in gt:
            c = int(np.searchsorted(nyu, box[6]))
            inside = (cls == c) & np.all(np.abs(xyz - box[:3]) <= box[3:6] / 2, axis=-1)
            if inside.sum() < 10:
                continue
            x0, y0 = np.floor(u[inside].min()) - 2, np.floor(v[inside].min()) - 2
            x1, y1 = np.ceil(u[inside].max()) + 2, np.ceil(v[inside].max()) + 2
            if x0 > 0 and y0 > 0 and x1 < W and y1 < H:
                rows.append([x0, y0, x1 - x0, y1 - y0, rng.uniform(0.5, 1.0), c])
        np.save(os.path.join(b2d, f"{fid}.npy"), np.array(rows, np.float64).reshape(-1, 6))
        open(os.path.join(frames, "color", f"{fid}.jpg"), "wb").close()
        write_png16(os.path.join(frames, "depth", f"{fid}.png"),
                    rng.integers(500, 5000, size=(H, W)).astype(np.uint16))
        np.savetxt(os.path.join(frames, "pose", f"{fid}.txt"), pose)
    t0 = time.perf_counter()
    n = lift_scene_scannet(scan, detection_data_dir=tree["root_dir"] + "/",
                           frames_dir=os.path.join(run, "frames"),
                           label_path_fmt=os.path.join(tree["label_dir"], "{}.npy"),
                           boxes2d_dir=os.path.join(run, "boxes2d"), out_dir=os.path.join(run, "lifted"),
                           cfg=LiftConfig(use_gss=False, image_dims=LIFT_HW))
    ms = (time.perf_counter() - t0) * 1e3
    require("PIL" not in sys.modules, "lift: PIL was imported")
    require(n > 0, "lift: no box lifted")
    lifted = np.load(os.path.join(run, "lifted", f"{scan}_bbox.npy"))
    require(lifted.shape == (n, 8) and np.isfinite(lifted).all(), f"lift: rows {lifted.shape}")
    print(f"lift {scan}: {LIFT_FRAMES} frames of {H} x {W} (16-bit PNG depth read by "
          f"ov3det_torch.utils.png), {len(gt)} GT boxes, {n} boxes lifted in {ms:.1f} ms (host); "
          f"PIL not imported")
    return n


def text_tower(card: str, dev: torch.device) -> None:
    """The CLIP text tower at RN50x4's width (640, 10 heads, 12 layers, 77
    tokens, vocabulary 49 408), seeded weights, on the 18 ScanNet classes x
    PROMPT_TEMPLATES with a stub vocabulary: the card against the CPU on the
    first TEXT_CHECK_PROMPTS prompts within 1e-5 of the largest value (f32),
    the forward of all 270 timed, the class embeddings unit rows."""
    import gzip
    import tempfile

    from ov3det_torch.datasets.dataset_configs import ScannetDatasetConfig
    from ov3det_torch.models.clip_text import (
        CLIPTextEncoder,
        SimpleBPETokenizer,
        extract_class_embeddings,
        tokenize_prompts,
    )

    names = [ScannetDatasetConfig().class2type[i] for i in range(18)]
    with tempfile.TemporaryDirectory(prefix="ov3det_bpe_") as d:
        path = os.path.join(d, "bpe.txt.gz")
        with gzip.open(path, "wt", encoding="utf-8") as fh:  # a stub of CLIP's merges file
            fh.write("#version: 0.2\nt h\nth e</w>\nc h\na i\nch ai\nchai r</w>\np h\no t\n"
                     "ph ot\nphot o</w>\no f</w>\n")
        prompts = tokenize_prompts(names, SimpleBPETokenizer(path))
    flat = torch.from_numpy(prompts.reshape(-1, prompts.shape[-1]))
    t0 = time.perf_counter()
    on_card = CLIPTextEncoder(device=dev, seed=0)
    build_s = time.perf_counter() - t0
    on_cpu = CLIPTextEncoder(device="cpu", seed=0)
    ids = flat.to(dev)
    with torch.no_grad():
        got = on_card(ids)
        ms = cuda_ms(lambda: on_card(ids), 5)
        t0 = time.perf_counter()
        want = on_cpu(flat[:TEXT_CHECK_PROMPTS])
        cpu_s = time.perf_counter() - t0
    got = got.cpu()
    err = ((got[:TEXT_CHECK_PROMPTS] - want).abs().max() / want.abs().max()).item()
    require(got.shape == (len(flat), 640) and torch.isfinite(got).all(), "text tower: bad output")
    require(err <= 1e-5, f"text tower: card vs CPU {err} of the largest value")
    check_add_norm(card, "text tower", record_text_norms(on_card, ids[:TEXT_CHECK_PROMPTS]),
                   timed=True)
    emb = extract_class_embeddings(on_card, prompts)
    require(emb.shape == (18, 640) and np.allclose(np.linalg.norm(emb, axis=-1), 1, atol=1e-5),
            "text tower: class embeddings are not unit rows")
    params = sum(p.numel() for p in on_card.parameters())
    print(f"text tower (RN50x4 width, {params / 1e6:.2f} M seeded weights, built in {build_s:.2f} s): "
          f"{len(flat)} prompts x {flat.shape[1]} tokens in {ms:.2f} ms on the card (CUDA events, "
          f"f32, TF32 off); card vs CPU within {err:.2e} of the largest value on "
          f"{TEXT_CHECK_PROMPTS} prompts (the CPU {cpu_s:.2f} s); class embeddings {emb.shape} ({card})")
    del on_card, on_cpu


# the first-K request and query as this script measured them before the query
# was a kernel (NVIDIA H100 80GB HBM3, 700.00 W)
EARLIER_FIRST_K = {"request_ms": 70.69, "bucketed_ms": 27.63, "query_ms": 38.21, "query_mib": 675.4}
# f32 operations a distance test: c.x 5, the sum, 2 c.x, the difference, the
# test (|c|^2 and |x|^2 are formed once a center and a point; the clamp at 0
# changes no test below an r^2 > 0, and a NaN stays NaN)
FIRST_K_OPS = 9
FIRST_K_REPS = 20  # calls of a timing graph of the first-K query
# the pre-encoder's query and the first-K requests (host clock) as this
# script measured them with the first design (NVIDIA H100 80GB HBM3, 700.00 W)
FIRST_DESIGN_QUERY_MS = 0.9026
FIRST_DESIGN_REQUEST_MS = {"first_k request": 19.05, "masked first_k request": 23.33}


def first_k_tests(inds: torch.Tensor, N: int) -> int:
    """The distance tests a first-K scan makes, from its output (B, M, K): a
    full ball stops at its K-th hit (the last slot, which differs from the
    first), any other ball tests all N points."""
    full = inds[..., -1] != inds[..., 0]
    return int(torch.where(full, inds[..., -1] + 1, N).sum())


def first_k_scenes(dev: torch.device) -> dict:
    """Crafted first-K cases: label -> (xyz, centers, radius, nsample): the
    r^2 boundary scene of tests/test_torch_reference_ckpt.py (a point the
    expanded distance puts inside and a direct subtraction outside, the first
    point out under both, an empty ball); balls that hold every point of a
    cloud of 1001 (not a multiple of 32) at K 64 and 32; centers far from
    every point; and a random cloud of 5000 points (3 stages of points, the
    last ragged) with 77 centers (a ragged tile) at K 64 and 32."""
    radius = 0.2
    c0, r2 = np.float32(10.0), np.float32(radius * radius)
    direct = lambda p: (p - c0) * (p - c0)  # noqa: E731
    expanded = lambda p: np.maximum((c0 * c0 + p * p) - np.float32(2) * (c0 * p), 0)  # noqa: E731
    p = np.nextafter(np.float32(c0 + np.float32(radius)), np.float32(0))
    while not (direct(p) >= r2 and expanded(p) < r2):
        p = np.nextafter(p, np.float32(20))
    q = p
    while expanded(q) < r2:
        q = np.nextafter(q, np.float32(20))
    edge = np.zeros((1, 6, 3), np.float32)
    edge[0, :, 0] = [30.0, q, p, c0 - np.float32(0.1), 40.0, c0]
    edge_c = np.array([[[c0, 0, 0], [30.0, 0, 0], [-5.0, 0, 0]]], np.float32)
    rng = np.random.default_rng(17)
    cloud = rng.uniform(-1, 1, (2, 1001, 3)).astype(np.float32)
    far = rng.uniform(5, 6, (2, 40, 3)).astype(np.float32)
    big = rng.uniform(-1, 1, (3, 5000, 3)).astype(np.float32)
    big_c = np.concatenate([big[:, :40], rng.uniform(-1.2, 1.2, (3, 37, 3))], 1).astype(np.float32)
    cases = {"r^2 boundary, K 4": (edge, edge_c, radius, 4),
             "full balls, N 1001, K 64": (cloud, cloud[:, :50], 4.0, 64),
             "full balls, N 1001, K 32": (cloud, cloud[:, :50], 4.0, 32),
             "empty balls, K 64": (cloud, far, 0.3, 64),
             "N 5000, M 77, K 64": (big, big_c, 0.3, 64),
             "N 5000, M 77, K 32": (big, big_c, 0.2, 32)}
    return {k: (torch.from_numpy(x).to(dev), torch.from_numpy(np.ascontiguousarray(c)).to(dev),
                r, n) for k, (x, c, r, n) in cases.items()}


def first_k_seams(dev: torch.device) -> dict:
    """First-K cases at the seams of the routed design (`first_k_lanes`: a
    warp a slice of the points, staged `SLICE_POINTS` at a time, tiles of
    `LANE_TILE` centers): label -> (xyz, centers, radius, nsample).  In a
    cloud of 2400 far points (4 slices of 600 at nsample 16), a ball whose
    16th hit is the last point of slice 0's first stage, with more hits
    after it there and in slice 1; a ball whose hits close slice 0 and open
    slice 1; a ball of every point; then nsample 1 and 128 (2 slices), N 1
    and N 31, and M 65 (a tile and one center)."""
    from ov3det_torch.ops.kernels.ball_query import SLICE_POINTS, slices_for

    N, ns = 2400, 16
    L = N // slices_for(ns)
    seam = np.full((1, N, 3), 50.0, np.float32)
    seam[0, SLICE_POINTS - ns:SLICE_POINTS] = 0.0  # fills at the end of a stage
    seam[0, SLICE_POINTS + 20:SLICE_POINTS + 30] = 0.0  # hits it no longer takes
    seam[0, L + 5:L + 9] = 0.0
    seam[0, L - 10:L] = 10.0  # closes slice 0 ...
    seam[0, L:L + 6] = 10.0  # ... and opens slice 1
    seam[0, L + 40:L + 60] = 10.0
    seam_c = np.array([[[0, 0, 0], [10, 10, 10], [50, 50, 50]]], np.float32)
    rng = np.random.default_rng(19)
    cloud = rng.uniform(-1, 1, (2, 3000, 3)).astype(np.float32)
    tiny = rng.uniform(-1, 1, (2, 31, 3)).astype(np.float32)
    cases = {"seams: a stage and a slice boundary, K 16": (seam, seam_c, 0.1, ns),
             "K 1": (cloud, cloud[:, :70], 0.1, 1),
             "K 128 (2 slices)": (cloud, cloud[:, :70], 0.6, 128),
             "N 1, K 1": (tiny[:, :1], tiny[:, :5], 0.5, 1),
             "N 31, K 31": (tiny, tiny[:, :9], 0.8, 31),
             "M 65, K 64": (cloud, cloud[:, 100:165], 0.4, 64)}
    return {k: (torch.from_numpy(np.ascontiguousarray(x)).to(dev),
                torch.from_numpy(np.ascontiguousarray(c)).to(dev), r, n)
            for k, (x, c, r, n) in cases.items()}


def check_first_k(card: str, queries: list, dev: torch.device) -> dict:
    """Phase 11's first-K check.  `queries` are the masked first-K request's
    two queries on its own points, each (xyz, centers, radius, K): the
    pre-encoder's (8 x 40 000 points, M 2048, K 64, r 0.2) and the interim
    SA's (its 2048 points, their FPS 1024 as centers, K 32, r 0.4).  Both
    designs (the routed `first_k_lanes` and the first, `_impl="first"`)
    against the plain version on the card, bit for bit, on two launches each,
    at both queries (every scene), on `first_k_scenes` and on
    `first_k_seams`; the plain version on the card against the CPU's on one
    scene; a K past the kernel's limit refused on the card; then, at both
    queries, the routed design and the first (graph replays) and the plain
    version (the former path, CUDA events), with the grouping and the tile
    ball-group at the pre-encoder's, timed in turns beside the bound from
    the distance tests the data needs at both f32 rates, and each one's
    device memory above its inputs.  Returns the kernels line's keys."""
    from ov3det_torch.ops.kernels.ball_group import ball_group
    from ov3det_torch.ops.kernels.ball_query import (
        LANE_TILE,
        MAX_NSAMPLE,
        SLICE_POINTS,
        UNROLL,
        first_k,
        first_k_plain,
        slices_for,
    )
    from ov3det_torch.ops.pointcloud import group_points

    cases = {f"{x.shape[0]} x {x.shape[1]}, M {c.shape[1]}, K {n}, r {r}": (x, c, r, n)
             for x, c, r, n in queries}
    cases.update(first_k_scenes(dev))
    cases.update(first_k_seams(dev))
    xyz, centers, radius, K = queries[0]
    for label, (x, c, r, n) in cases.items():
        want = first_k_plain(x, c, r, n)
        for impl in (None, "first"):
            for launch in range(2):
                got = first_k(x, c, r, n, _impl=impl)
                require(got.dtype == want.dtype and torch.equal(got, want),
                        f"first_k {label}, {impl or 'routed'} design, launch {launch}: the "
                        f"kernel's indices differ from the plain version's at "
                        f"{int((got != want).sum())} slots")
        hits = ((want[..., 1:] != want[..., :1]).sum(-1) + 1).float()
        print(f"first_k {label}: both designs' indices equal the plain version's bit for bit on "
              f"two launches each; distinct indices a ball {hits.mean().item():.1f} (max "
              f"{int(hits.max())})")
        if label.startswith("empty"):
            require(not bool(want.any()), f"first_k {label}: an empty ball is not all 0")
        if label.startswith("r^2"):
            require(want[0, 0].tolist() == [2, 3, 5, 2] and want[0, 2].tolist() == [0] * 4,
                    f"first_k {label}: {want[0].tolist()}")
        if label.startswith("full"):
            require(bool((want == torch.arange(n, device=dev)).all()), f"first_k {label}")
        if label.startswith("seams"):
            L = x.shape[1] // slices_for(n)
            require(want[0, 0].tolist() == list(range(SLICE_POINTS - n, SLICE_POINTS))
                    and want[0, 1].tolist() == list(range(L - 10, L + 6)),
                    f"first_k {label}: {want[0, :2].tolist()}")
    require(torch.equal(first_k(xyz[:1], centers[:1], radius, K).cpu(),
                        first_k_plain(xyz[:1].cpu(), centers[:1].cpu(), radius, K)),
            "first_k: the card's indices differ from the CPU's")
    try:
        first_k(xyz, centers, radius, MAX_NSAMPLE + 1)
    except ValueError as e:
        print(f"first_k at K {MAX_NSAMPLE + 1} on the card: refused ({e})")
    else:
        raise AssertionError(f"first_k at K {MAX_NSAMPLE + 1} was not refused")

    mib = {}
    for name, fn in (("kernel", first_k), ("plain", first_k_plain)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        inds = fn(xyz, centers, radius, K)
        torch.cuda.synchronize()
        mib[name] = (torch.cuda.max_memory_allocated() - base) / 2**20
    timed = {}
    for (x, c, r, n), label in zip(queries, ("pre-encoder", "interim SA")):
        runs = {"kernel": lambda: first_k(x, c, r, n),
                "first": lambda: first_k(x, c, r, n, _impl="first"),
                "plain": lambda: first_k_plain(x, c, r, n)}
        if label == "pre-encoder":
            runs["grouping"] = lambda: group_points(x, None, c, inds, r)
            runs["tile ball-group"] = lambda: ball_group(x, None, c, r, n)
        ms = {name: [] for name in runs}
        for name in (*runs, *reversed(runs)):
            ms[name].append(graph_ms(runs[name], FIRST_K_REPS) if name in ("kernel", "first")
                            else cuda_ms(runs[name], 3))
        best = {name: min(v) for name, v in ms.items()}
        out = inds if label == "pre-encoder" else first_k(x, c, r, n)
        B, N, M = x.shape[0], x.shape[1], c.shape[1]
        tests = first_k_tests(out, N)
        b_ms, by = bound_ms(B * N * 12 + B * M * 12 + B * M * n * 8, FIRST_K_OPS * tests, F32_PEAK)
        unfused = FIRST_K_OPS * tests / (F32_PEAK / 2) * 1e3
        S = slices_for(n)
        shared = S * LANE_TILE * (n + UNROLL) * 4 + S * (2 * (3 * SLICE_POINTS + 4) * 4
                                                         + SLICE_POINTS * 16)
        print(f"first_k {label} at {B} x {N}, M {M}, K {n}, r {r} ({tests / 1e6:.1f} M distance "
              f"tests of {FIRST_K_OPS} f32 operations, each rounded on its own, "
              f"{(out[..., -1] != out[..., 0]).float().mean().item():.3f} of the balls full): "
              f"routed design (first_k_lanes<{S}>, {-(-M // LANE_TILE) * B} CTAs of {32 * S} "
              f"threads, {shared} B dynamic shared memory) {best['kernel']:.4f} ms, first design "
              f"{best['first']:.4f} ms (graph replays of {FIRST_K_REPS} calls, in turns), plain "
              f"version {best['plain']:.3f} ms (CUDA events)"
              + (f", grouping {best['grouping']:.3f} ms, tile ball-group "
                 f"{best['tile ball-group']:.3f} ms" if "grouping" in best else "")
              + f"; bound {b_ms:.5f} ms ({by}; at {F32_PEAK / 1e12:.0f} TFLOP/s, which counts an "
              f"FMA as two: at the {F32_PEAK / 2e12:.1f} T/s of operations that are not fused, "
              f"{unfused:.5f} ms): the routed design at {b_ms / best['kernel']:.3f} and "
              f"{unfused / best['kernel']:.3f} of them; no library call ({card})")
        timed[label] = dict(max_abs_err=0.0, ms=best["kernel"], first_ms=best["first"],
                            plain_ms=best["plain"], bound_ms=b_ms, bound_by=by,
                            bound_ms_unfused=unfused, library_ms=None)
    print(f"first_k device memory above its inputs at the pre-encoder's query: kernel "
          f"{mib['kernel']:.1f} MiB, plain version (the former path) {mib['plain']:.1f} MiB (before "
          f"the kernel: {EARLIER_FIRST_K['query_ms']} ms, {EARLIER_FIRST_K['query_mib']} MiB; "
          f"the first design {FIRST_DESIGN_QUERY_MS} ms; NVIDIA H100 80GB HBM3, 700.00 W)")
    return {**timed["pre-encoder"], "interim_sa": timed["interim SA"]}


@contextlib.contextmanager
def first_designs():
    """The main path's first-K query and empty-box test routed to their first
    designs (`_impl="first"`) while the block runs, through the names their
    callers look up (`ops.pointcloud.first_k`, `eval.parse.points_in_box`)."""
    from ov3det_torch.eval import parse
    from ov3det_torch.ops import pointcloud

    saved = pointcloud.first_k, parse.points_in_box
    pointcloud.first_k = functools.partial(saved[0], _impl="first")
    parse.points_in_box = functools.partial(saved[1], _impl="first")
    try:
        yield
    finally:
        pointcloud.first_k, parse.points_in_box = saved


def first_k_requests_in_turns(card: str, builds: dict, batches: list, dev: torch.device,
                              rounds: int = 4) -> None:
    """Each first-K request (label -> a function that builds its `Detector`)
    graphed with the routed designs of the first-K query and the empty-box
    test and with their first designs (a detector each, captured while
    `first_designs` routes them), timed in turns on the host clock (routed,
    first, first, routed, `rounds` times); the medians and ranges
    printed."""
    for label, build in builds.items():
        dets = {"routed": build()}
        dets["routed"].detect(batches[0])  # warm-up and capture
        with first_designs():
            dets["first"] = build()
            dets["first"].detect(batches[0])
        ms = {name: [] for name in dets}
        for _ in range(rounds):
            for name in ("routed", "first", "first", "routed"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dets[name].detect(batches[1])
                ms[name].append((time.perf_counter() - t0) * 1e3)
        print(f"{label} (graphed) in turns: the routed designs {np.median(ms['routed']):.2f} ms "
              f"({min(ms['routed']):.2f} to {max(ms['routed']):.2f}), the first designs of the "
              f"first-K query and the empty-box test {np.median(ms['first']):.2f} ms "
              f"({min(ms['first']):.2f} to {max(ms['first']):.2f}), {2 * rounds} requests each "
              f"({card})")
        del dets
    torch.cuda.empty_cache()


def check_first_k_sa(card: str, label: str, det, batch: dict) -> None:
    """`check_bn_relu` on the widths of one first-K request (eval mode, the
    running statistics, every last width pooled over slot axis 2)."""
    records = record_sa_request(det, batch)
    last = [r for r in records if r["axis"] is not None]
    require(last and all(r["axis"] == 2 for r in last),
            f"{label}: the pooled widths are not the first-K layout's (slot axis 2)")
    check_bn_relu(card, label, records, timed=False)


def reference_checkpoint(card: str, dev: torch.device) -> dict:
    """A reference-layout 3DETR checkpoint at scannet_quick()'s width (the
    port's seeded model written by `to_reference_state_dict`, saved as a
    .pth) read by `load_reference_checkpoint` into a `Detector` with
    `ball_query_method="first_k"`: one request's launches (FPS twice, the
    first-K query once, no ball-group, the attention forward 3 times, NMS
    and the empty-box test once), time and peak memory beside the bucketed
    request and the earlier record; the masked config with the first-K query (its
    interim SA too: the query twice); then `check_first_k` at both of the
    masked request's queries, on its second batch's points; each first-K
    request's shared-MLP widths held by `check_first_k_sa`.  Returns the
    requests' launch counts and the first-K query's kernels-line keys."""
    import tempfile

    from ov3det_torch.config import scannet_quick
    from ov3det_torch.engine.infer import Detector
    from ov3det_torch.models.convert_3detr import load_reference_checkpoint, to_reference_state_dict
    from ov3det_torch.models.detr3d import Model3DETR
    from ov3det_torch.ops.pointcloud import furthest_point_sample, gather_points

    quick = scannet_quick()
    cfg = dataclasses.replace(quick.model, ball_query_method="first_k")
    ref = to_reference_state_dict(Model3DETR(cfg, device="cpu", seed=5).state_dict())
    with tempfile.TemporaryDirectory(prefix="ov3det_ref_") as d:
        path = os.path.join(d, "checkpoint_best.pth")
        torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in ref.items()},
                    "epoch": 0}, path)
        t0 = time.perf_counter()
        state = load_reference_checkpoint(path)
        load_ms = (time.perf_counter() - t0) * 1e3
        mb = os.path.getsize(path) / 1e6
    det = Detector(cfg, state_dict=state, device=dev)
    batches = synthetic_batches(quick, 2, 900)
    det.detect(batches[0])  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dets = det.detect(batches[1])
    request_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    want = expect(**sa(train=False), **norms(train=False), fps=2, first_k=1, attention_fwd=3, nms=1,
                  points_in_box=1)
    require(counts == want, f"reference checkpoint request: launches {counts}, expected {want}")
    require(len(dets) == BATCH and all(np.isfinite(c).all() and np.isfinite(s).all()
                                       for _, c, s in dets), "reference checkpoint: bad detections")
    check_first_k_sa(card, "first_k request", det, batches[1])
    # the same weights and request with the bucketed ball-group, the
    # configuration's default: the yardstick of the first-K path's peak
    bucketed = Detector(quick.model, state_dict=state, device=dev)
    bucketed.detect(batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bucketed.detect(batches[1])
    bucketed_ms = (time.perf_counter() - t0) * 1e3
    bucketed_peak = torch.cuda.max_memory_allocated()
    del bucketed
    print(f"reference checkpoint ({len(ref)} tensors, {mb:.2f} MB, read and converted in "
          f"{load_ms:.1f} ms): first_k request of 8 x {SCANNET_POINTS} points {request_ms:.2f} ms, "
          f"peak device memory {peak / 2**30:.3f} GiB (the same request with the bucketed "
          f"ball-group: {bucketed_ms:.2f} ms, {bucketed_peak / 2**30:.3f} GiB; before the kernel: "
          f"first_k request {EARLIER_FIRST_K['request_ms']} ms and bucketed "
          f"{EARLIER_FIRST_K['bucketed_ms']} ms; with the first design: "
          f"{FIRST_DESIGN_REQUEST_MS['first_k request']} ms), "
          f"detections per scene {[len(c) for c, _, _ in dets]}, launches "
          f"{ {n: c for n, c in counts.items() if c} } ({card})")
    del det

    # the masked config with the first-K query: the pre-encoder and the interim SA
    masked = dataclasses.replace(scannet_masked().model, ball_query_method="first_k")
    m_det = Detector(masked, device=dev, seed=5)
    m_det.detect(batches[0])  # warm-up and capture
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_dets = m_det.detect(batches[1])
    masked_ms = (time.perf_counter() - t0) * 1e3
    m_counts = read_counts()
    want = expect(**sa(2, train=False), **norms(train=False), fps=3, first_k=2, attention_fwd_radius=3, nms=1,
                  points_in_box=1)
    require(m_counts == want, f"masked first_k request: launches {m_counts}, expected {want}")
    require(all(np.isfinite(c).all() and np.isfinite(s).all() for _, c, s in m_dets),
            "masked first_k request: non-finite detections")
    check_first_k_sa(card, "masked first_k request", m_det, batches[1])
    print(f"masked first_k request (graphed) of 8 x {SCANNET_POINTS} points: {masked_ms:.2f} ms "
          f"(with the first design: "
          f"{FIRST_DESIGN_REQUEST_MS['masked first_k request']} ms), launches "
          f"{ {n: c for n, c in m_counts.items() if c} } ({card})")
    del m_det
    counts = collections.Counter(counts)
    counts.update(m_counts)
    first_k_requests_in_turns(card, {
        "first_k request": lambda: Detector(cfg, state_dict=state, device=dev),
        "masked first_k request": lambda: Detector(masked, device=dev, seed=5)}, batches, dev)

    # the masked request's two queries on batches[1]: the pre-encoder's, then
    # the interim SA's on the pre-encoder's points (`Model3DETR.forward`)
    xyz = torch.from_numpy(batches[1]["point_clouds"][..., :3]).to(dev).contiguous()
    pre = gather_points(xyz, furthest_point_sample(xyz, masked.preenc_npoints)).contiguous()
    interim = gather_points(pre, furthest_point_sample(pre, masked.preenc_npoints // 2))
    entry = check_first_k(card, [(xyz, pre, masked.preenc_radius, masked.preenc_nsample),
                                 (pre, interim.contiguous(), masked.interim_radius,
                                  masked.interim_nsample)], dev)
    return dict(counts), entry


def pseudo_phase(card: str, dev: torch.device) -> dict:
    """Phase 11: the pseudo-label round at scannet_quick()'s width on a
    ScanNet-layout tree of synthetic scenes: train an epoch, label the train
    split (all rows, then with the label filter at thresholds taken from
    those rows), the rows card against CPU, retrain an epoch with --use_pbox
    on the kept boxes, lift a scene, the text tower and a reference
    checkpoint with the first-K ball query.  Returns the launch counts of
    its training runs, label passes and first-K requests, and the first-K
    query's kernels-line keys."""
    import shutil
    import tempfile

    from ov3det_torch.datasets.dataset_configs import ScannetDatasetConfig
    from ov3det_torch.datasets.registry import build_dataset
    from ov3det_torch.datasets.synthetic import write_scannet_tree
    from ov3det_torch.generate_pseudo_label import make_pseudo_label_parser
    from ov3det_torch.main import config_from_args
    from ov3det_torch.tools.format_tools import adjust_format_to_nyu40

    t_phase = time.perf_counter()
    train_step = expect(**sa(), **norms(), fps=2, ball_group=1, attention_fwd=3, attention_dq=3,
                        attention_dkv=3, auction=1)
    eval_batch = expect(**sa(train=False), **norms(train=False), fps=2, ball_group=1, attention_fwd=3)
    total = collections.Counter()
    with tempfile.TemporaryDirectory(prefix="ov3det_pseudo_") as run:
        t0 = time.perf_counter()
        tree = write_scannet_tree(os.path.join(run, "scannet"), PSEUDO_TRAIN, PSEUDO_VAL,
                                  SCANNET_POINTS, seed=11)
        print(f"pseudo tree: {PSEUDO_TRAIN} train + {PSEUDO_VAL} val scans of {SCANNET_POINTS} "
              f"points written in {time.perf_counter() - t0:.2f} s")
        data = ["--dataset_root_dir", tree["root_dir"], "--meta_data_dir", tree["meta_data_dir"]]
        label_argv = PSEUDO_ARGV + data
        cfg = config_from_args(make_pseudo_label_parser().parse_args(label_argv))
        Q = cfg.model.num_queries
        dataset = build_dataset(cfg.data, splits=("inference",))[0]["inference"]
        scans = list(dataset.scan_names)

        def train_run(extra: list, label: str) -> CliProbe:
            probe = CliProbe(record_boxes=True)
            reset_counts()
            t0 = time.perf_counter()
            _, lines = run_cli(probe, PSEUDO_ARGV + data + extra)
            wall = time.perf_counter() - t0
            counts = read_counts()
            for line in lines:
                if not (" Average Precision: " in line or " Recall: " in line):
                    print(f"{label}| {line}")
            require(len(probe.steps) == PSEUDO_TRAIN // BATCH
                    and all(d == train_step for _, _, d in probe.steps),
                    f"{label}: steps launched {[d for _, _, d in probe.steps]}")
            require(bool(probe.evals) and all(d == eval_batch for d in probe.evals),
                    f"{label}: eval batches launched {probe.evals}")
            total.update(counts)
            print(f"{label}: {wall:.2f} s wall ({len(probe.steps)} steps, {len(probe.evals)} eval "
                  f"batches, checkpoints), launches { {n: c for n, c in counts.items() if c} } "
                  f"({card})")
            return probe

        ckpt_dir = os.path.join(run, "train")
        train_run(["--checkpoint_dir", ckpt_dir], "pseudo train")
        ckpt = os.path.join(ckpt_dir, "checkpoint")

        label_argv += ["--test_ckpt", ckpt]
        reset_counts()
        n, wall, batches, all_rows = pseudo_pass(
            label_argv + ["--out_dir", os.path.join(run, "all"), "--conf_thresh", "0",
                          "--obj_thresh", "0"], "pseudo all")
        counts = read_counts()
        files = sorted(os.listdir(os.path.join(run, "all")))
        rows = [np.load(os.path.join(run, "all", name)) for name in files]
        require(n == PSEUDO_TRAIN * Q and sum(len(r) for r in rows) == n,
                f"pseudo all: {n} rows written, expected {PSEUDO_TRAIN} x {Q}")
        require(files == [f"{s}_bbox.npy" for s in scans] and scans == tree["train"],
                f"pseudo all: files {files}")
        require(all(r.shape == (Q, 7) and np.isfinite(r).all() for r in rows),
                "pseudo all: a file holds non-finite or misshapen rows")
        want = expect(**sa(2, train=False), **norms(train=False, times=2), fps=2 * 2,
                      ball_group=2, attention_fwd=2 * 3)
        require(counts == want and [d for _, d in batches] == [eval_batch, eval_batch],
                f"pseudo all: launches {counts}, batches {[d for _, d in batches]}")
        total.update(counts)
        print(f"pseudo label pass (no filter): {n} rows in {len(files)} files, {wall:.2f} s wall "
              f"(model build, checkpoint, loader, 2 batches, formatter), batches "
              f"{[round(ms, 2) for ms, _ in batches]} ms (host clock to a sync), launches "
              f"{ {k: c for k, c in counts.items() if c} } ({card})")

        # the filtered pass: thresholds from the rows above, and label files
        # on which some boxes agree with their scene and some do not
        slots = ScannetDatasetConfig().max_num_obj
        conf, obj = pseudo_thresholds(all_rows, slots)
        passed = all_rows[(all_rows[:, 7] >= conf) & (all_rows[:, 8] >= obj)]
        painted = os.path.join(run, "painted")
        paint_labels(tree, scans, passed, painted)
        reset_counts()
        n_kept, wall, batches, kept_rows = pseudo_pass(
            label_argv + ["--out_dir", os.path.join(run, "kept"), "--label_dir", painted,
                          "--conf_thresh", repr(conf), "--obj_thresh", repr(obj)], "pseudo filtered")
        counts = read_counts()
        require(counts == want, f"pseudo filtered: launches {counts}")
        total.update(counts)
        want_kept = kept_reference(kept_rows, conf, obj, painted, scans)
        kept = {s: np.load(os.path.join(run, "kept", f"{s}_bbox.npy")) for s in scans}
        n_passed = int(((kept_rows[:, 7] >= conf) & (kept_rows[:, 8] >= obj)).sum())
        require(0 < n_kept < n_passed, f"pseudo filtered: {n_kept} boxes kept of {n_passed} over "
                                       "the thresholds: the filter must keep some and drop some")
        require(n_kept == sum(len(k) for k in want_kept)
                and all(len(kept[s]) == len(k) for s, k in zip(scans, want_kept)),
                f"pseudo filtered: kept {[len(kept[s]) for s in scans]} a scan, a direct count "
                f"gives {[len(k) for k in want_kept]}")
        for s, k in zip(scans, want_kept):  # the formatter writes them grouped by class
            order = np.argsort(k[:, 6], kind="stable")
            require(np.array_equal(kept[s], k[order, :7]), f"pseudo filtered: {s}'s rows differ")
        rerun = np.abs(kept_rows - all_rows).max()
        print(f"pseudo label pass (--label_dir, conf {conf:.6g}, obj {obj:.6g}, the thresholds "
              f"from the first pass's rows): {n_kept} boxes kept of the {n_passed} over them "
              f"(most in a scan: {max(len(k) for k in want_kept)}), equal to a direct count, "
              f"{wall:.2f} s wall, batches {[round(ms, 2) for ms, _ in batches]} ms; its rows "
              f"within {rerun:.2e} of the first pass's ({card})")

        pseudo_card_vs_cpu(cfg, ckpt, dataset, dev)

        # the retraining round: the kept boxes in nyu40 ids (ScanNet's loader
        # reads those); the val split reads --pseudo_label_dir too, and gets
        # its GT boxes there, as a lifting over every scan would give it
        pbox = os.path.join(run, "pbox")
        adjust_format_to_nyu40(os.path.join(run, "kept"), pbox, scans)
        for scan in tree["val"]:
            shutil.copy(os.path.join(tree["root_dir"], f"{scan}_bbox.npy"), pbox)
        probe = train_run(["--use_pbox", "--pseudo_label_dir", pbox, "--checkpoint_dir",
                           os.path.join(run, "retrain")], "pseudo retrain")
        carried = {}
        for b in probe.train_boxes:
            for i, present, sem in zip(b["scan_idx"], b["gt_box_present"], b["gt_box_sem_cls_label"]):
                k, scan = int(present.sum()), scans[int(i)]
                require(k == len(kept[scan])
                        and np.array_equal(sem[:k], kept[scan][:, 6].astype(np.int64)),
                        f"pseudo retrain: {scan} carries {k} GT boxes of classes {sem[:k].tolist()}, "
                        f"its pseudo-label file {kept[scan][:, 6].tolist()}")
                carried[scan] = k
        require(sorted(carried) == scans and sum(carried.values()) == n_kept,
                f"pseudo retrain: its batches carry {carried}, {n_kept} boxes kept")
        print(f"pseudo retrain: its {len(probe.train_boxes)} batches carry the {n_kept} kept boxes "
              f"as GT ({[carried[s] for s in scans]} a scan), each scan's count and classes those "
              f"of its file in --pseudo_label_dir")
        gc.collect()
        require(not multiprocessing.active_children(),
                f"pseudo: loader workers outlived the runs: {multiprocessing.active_children()}")

        lift_scene(tree, tree["train"][0], run)
    text_tower(card, dev)
    ref_counts, first_k_entry = reference_checkpoint(card, dev)
    total.update(ref_counts)
    print(f"phase 11 (the pseudo-label round): {time.perf_counter() - t_phase:.1f} s")
    return dict(total), first_k_entry


# ------------------------------------------------------------ phase 12: data parallel and the bank
DDP_WORLD = 2  # ranks, both on cuda:0 over gloo: the machine has one card
DDP_STEPS = 3  # bf16 steps a rank, after a warm-up
DDP_TIMEOUT = 600  # seconds for a spawned group of ranks
SHARED_CARD = ("two processes share one card, so these times say nothing about the scaling "
               "of data parallelism")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, args: tuple, label: str) -> None:
    """fn(rank, *args) in DDP_WORLD spawned processes; a rank that fails, or
    a group that outlives DDP_TIMEOUT, fails the phase (the others are
    killed)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=DDP_WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + DDP_TIMEOUT
    try:
        while not ctx.join(timeout=5):  # raises when a rank failed, and ends the others
            require(time.monotonic() < deadline, f"{label}: the ranks outlived {DDP_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def join_gloo(rank: int, port: int) -> torch.device:
    """A rank of the phase's group: gloo on cuda:0, TF32 off."""
    sys.path.insert(0, HERE)
    from ov3det_torch.parallel import init_data_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    init_data_group(rank, DDP_WORLD, f"tcp://localhost:{port}", dev, backend="gloo")
    return dev


def global_batches(cfg, n: int, seed: int) -> list:
    """n seeded numpy batches of the global batch, DDP_WORLD x the config's."""
    per = cfg.data.batch_size_per_device
    return synthetic_batches(dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size_per_device=per * DDP_WORLD)), n, seed)


def timed_collectives():
    """A spy on torch.distributed.all_reduce: each call's elements and ms
    (synchronised on both sides)."""
    import torch.distributed as dist

    calls, original = [], dist.all_reduce

    def all_reduce(t, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(t, *args, **kwargs)
        torch.cuda.synchronize()
        calls.append((t.numel(), (time.perf_counter() - t0) * 1e3))
        return out

    return calls, original, all_reduce


def grad_taker(model, stage: str, into: list):
    """A `mark` hook that appends the model's gradients, by name, on the
    host, when the step reaches `stage`."""
    def mark(name):
        if name == stage:
            into.append({n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                         if p.grad is not None})
    return mark


def worst_leaf_err(got: dict, want: dict) -> tuple:
    """(the largest relative error of a gradient leaf, its name): |got -
    want| over |want| (L2), or over 1e-3 of the whole gradient's norm for a
    leaf smaller than that (a bias that BatchNorm cancels has a gradient of
    rounding noise)."""
    floor = 1e-3 * float(torch.cat([g.reshape(-1) for g in want.values()]).norm())
    require(set(got) == set(want), f"ddp: gradient leaves {sorted(set(got) ^ set(want))[:3]}")
    return max((float((got[n] - w).norm()) / max(float(w.norm()), floor), n)
               for n, w in want.items())


def ddp_steps_rank(rank: int, port: int, out: str) -> None:
    """A rank of phase 12's steps: two f32 steps (dropout 0) and the bf16
    steps at the config's dropout on its rows of the global batches; one
    step with its collectives timed."""
    import torch.distributed as dist

    dev = join_gloo(rank, port)
    try:
        from ov3det_torch.config import sunrgbd_quick
        from ov3det_torch.engine.train import batch_to_device, build_training
        from ov3det_torch.parallel import shard_batch

        res = {"f32": [], "grads": []}
        cfg = f32_no_dropout(sunrgbd_quick())
        training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0)
        gen = torch.Generator(device=dev).manual_seed(0)
        for batch in global_batches(cfg, 2, 1200):
            m = training.train_step(shard_batch(batch_to_device(batch, dev)), gen,
                                    mark=grad_taker(training.model, "all_reduce", res["grads"]))
            res["f32"].append({k: v.item() for k, v in m.items()})
        res["state"] = {k: v.cpu() for k, v in training.model.state_dict().items()}
        del training

        cfg = sunrgbd_quick()
        training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0)
        gen = torch.Generator(device=dev).manual_seed(0)
        batches = [shard_batch(batch_to_device(b, dev))
                   for b in global_batches(cfg, DDP_STEPS + 2, 1300)]
        training.train_step(batches[0], gen)  # warm-up
        reset_counts()
        res["steps"] = []
        for batch in batches[1:DDP_STEPS + 1]:
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = training.train_step(batch, gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = read_counts()
            res["steps"].append((ms, {n: after[n] - before[n] for n in after}, m["loss"].item(),
                                 m["grad_norm"].item()))
        res["counts"] = read_counts()

        # one more step, synchronised at each stage, its all-reduces timed
        calls, original, spy = timed_collectives()
        marks = []

        def mark(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        dist.all_reduce = spy
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            training.train_step(batches[-1], gen, mark=mark)
        finally:
            dist.all_reduce = original
        times = [t for _, t in marks]
        res["stages"] = {n: (t - p) * 1e3 for (n, t), p in zip(marks, [t0] + times[:-1])}
        res["collectives"] = calls
        torch.save(res, os.path.join(out, f"steps{rank}.pt"))
    finally:
        dist.destroy_process_group()


def ddp_cli_rank(rank: int, port: int, out: str, argv: list) -> None:
    """A rank of phase 12's CLI: `main(argv)` in this process, inside the
    group, under the probe's spies."""
    import torch.distributed as dist

    join_gloo(rank, port)
    try:
        probe = CliProbe()
        reset_counts()
        t0 = time.perf_counter()
        _, lines = run_cli(probe, argv)
        wall = time.perf_counter() - t0
        torch.save({"lines": lines, "steps": [d for _, _, d in probe.steps], "evals": probe.evals,
                    "waits": probe.waits, "saves": probe.saves, "wall": wall,
                    "counts": read_counts()}, os.path.join(out, f"cli{rank}.pt"))
    finally:
        dist.destroy_process_group()


def ddp_steps(card: str, dev: torch.device) -> dict:
    """Two ranks on the card against one rank of the global batch; returns
    the launches of both ranks' timed steps."""
    import tempfile

    from ov3det_torch.config import sunrgbd_quick
    from ov3det_torch.engine.train import batch_to_device, build_training

    step = expect(**sa(), **norms(), fps=2, ball_group=1, attention_fwd=3, attention_dq=3, attention_dkv=3,
                  auction=1)
    cfg = f32_no_dropout(sunrgbd_quick())
    training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    want_grads = []  # no group: the step's gradient is whole at the end of the backward
    take = grad_taker(training.model, "backward", want_grads)
    want = [{k: v.item() for k, v in training.train_step(batch_to_device(b, dev), gen,
                                                         mark=take).items()}
            for b in global_batches(cfg, 2, 1200)]
    want_state = {k: v.cpu() for k, v in training.model.state_dict().items()}
    del training
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="ov3det_ddp_") as out:
        t0 = time.perf_counter()
        spawn_ranks(ddp_steps_rank, (free_port(), out), "ddp steps")
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out, f"steps{r}.pt"), weights_only=False)
                 for r in range(DDP_WORLD)]
    print(f"ddp steps: {DDP_WORLD} ranks spawned on cuda:0 over gloo, {wall:.1f} s wall for both "
          f"(start, f32 steps, bf16 steps) ({card})")

    r0 = ranks[0]
    require(all(r["f32"] == r0["f32"] for r in ranks), "ddp: the ranks report other metrics")
    require(all(torch.equal(r["state"][k], v) for r in ranks[1:] for k, v in r0["state"].items()),
            "ddp: the ranks hold other weights")
    loss_err = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-6)
                   for g, w in zip(r0["f32"], want) for k in w if k.startswith("loss"))
    gn_err = max(abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                 for g, w in zip(r0["f32"], want))
    param_err = max(float((r0["state"][k] - v).abs().max()) for k, v in want_state.items()
                    if "running" not in k)
    bn_err = max(float(((r0["state"][k] - v).abs() / v.abs().clamp(min=1)).max())
                 for k, v in want_state.items() if "running" in k)
    require(len(r0["grads"]) == len(want_grads) == 2, "ddp: the all-reduced gradient not seen")
    grad_err, grad_leaf = max(worst_leaf_err(g, w) for g, w in zip(r0["grads"], want_grads))
    print(f"ddp f32 (TF32 off, dropout 0), 2 ranks x 8 scenes against 1 rank x 16 on the card, "
          f"two steps: losses within {loss_err:.2e} relative, grad_norm {gn_err:.2e}, the "
          f"all-reduced gradient leaf by leaf {grad_err:.2e} (worst: {grad_leaf}; relative, L2), "
          f"parameters {param_err:.2e}, BatchNorm statistics {bn_err:.2e} (relative, over "
          f"max(1, |x|))")
    require(loss_err <= 1e-4, f"ddp: a loss differs by {loss_err} relative")
    require(gn_err <= 1e-4, f"ddp: grad_norm differs by {gn_err} relative")
    # BatchNorm's f32 noise grows ~10x a layer down the backward: the first SA
    # layer's weight reads ~1e-3; a reduction that averages is 0.5 off on every
    # leaf, one that drops or doubles a rank that rank's share
    require(grad_err <= 1e-2, f"ddp: the gradient's {grad_leaf} differs by {grad_err} relative")
    require(param_err <= 1e-4, f"ddp: a parameter differs by {param_err}")
    require(bn_err <= 1e-5, f"ddp: a BatchNorm statistic differs by {bn_err}")

    counts = collections.Counter()
    for r, res in enumerate(ranks):
        for i, (ms, delta, loss, gnorm) in enumerate(res["steps"]):
            require(delta == step, f"ddp rank {r} step {i}: launches {delta}, expected {step}")
            require(math.isfinite(loss) and math.isfinite(gnorm), f"ddp rank {r} step {i}: {loss}")
        counts.update(res["counts"])
        print(f"ddp rank {r}: bf16 sunrgbd_quick steps at the config's dropout, 8 of the 16 "
              f"scenes: {[round(s[0], 2) for s in res['steps']]} ms, loss "
              f"{res['steps'][-1][2]:.4f}, launches a step { {n: c for n, c in step.items() if c} }"
              f" ({SHARED_CARD}; {card})")
        grad_n = max(n for n, _ in res["collectives"])  # the gradient's flat buffer
        grads = [ms for n, ms in res["collectives"] if n == grad_n]
        small = [ms for n, ms in res["collectives"] if n != grad_n]
        parts = ", ".join(f"{k} {v:.2f}" for k, v in res["stages"].items())
        print(f"ddp rank {r}: one step synchronised at each stage: {parts} ms; its all-reduces: "
              f"the gradient's {grad_n} f32 values in {len(grads)} call, {sum(grads):.2f} ms; "
              f"{len(small)} small ones (BatchNorm's sums, the criterion's denominators and "
              f"losses), {sum(small):.2f} ms in all, each synchronised ({SHARED_CARD}; {card})")
    print(f"ddp launches, both ranks: { {n: c for n, c in counts.items() if c} }")
    return dict(counts)


def nccl_one_rank(card: str, dev: torch.device) -> None:
    """A one-rank NCCL group: its all-reduce of the gradients leaves them
    bit for bit, and the step equals the step with no group as far as two
    steps with no group equal each other."""
    import torch.distributed as dist

    from ov3det_torch.config import sunrgbd_quick
    from ov3det_torch.engine.train import batch_to_device, build_training
    from ov3det_torch.parallel import data_group

    cfg = f32_no_dropout(sunrgbd_quick())
    batch = batch_to_device(synthetic_batches(cfg, 1, 1400)[0], dev)

    def one_step(mark=None):
        training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0)
        m = training.train_step(batch, torch.Generator(device=dev).manual_seed(0), mark=mark)
        return ({k: v.item() for k, v in m.items()},
                torch.cat([p.detach().reshape(-1) for p in training.model.parameters()]))

    plain, again = one_step(), one_step()
    floor = float((plain[1] - again[1]).abs().max())
    grads, times = {}, {}

    def mark(name):  # the interval from "backward" to "all_reduce" holds the all-reduce alone
        if name == "all_reduce":
            torch.cuda.synchronize()
            times[name] = time.perf_counter()
        if name in ("backward", "all_reduce"):
            grads[name] = torch.cat([p.grad.reshape(-1) for p in training_params
                                     if p.grad is not None])
        if name == "backward":
            torch.cuda.synchronize()
            times[name] = time.perf_counter()

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        require(data_group().backend == "nccl" and data_group().world == 1, "nccl: no group")
        dist.all_reduce(torch.zeros(1, device=dev))  # NCCL's communicator starts at its first use
        training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0)
        training_params = training.optimizer.params
        m = training.train_step(batch, torch.Generator(device=dev).manual_seed(0), mark=mark)
        got = ({k: v.item() for k, v in m.items()},
               torch.cat([p.detach().reshape(-1) for p in training.model.parameters()]))
    finally:
        dist.destroy_process_group()
    require(torch.equal(grads["backward"], grads["all_reduce"]),
            "nccl: the all-reduce over one rank changed the gradients")
    diff = float((got[1] - plain[1]).abs().max())
    require(diff <= floor, f"nccl: the step moved its parameters {diff} from the step with no "
                           f"group; two steps with no group differ by {floor}")
    require(got[0] == plain[0] or floor > 0, f"nccl: metrics {got[0]} against {plain[0]}")
    print(f"nccl one-rank group: the all-reduce of {grads['backward'].numel()} gradient values "
          f"left them bit for bit, {(times['all_reduce'] - times['backward']) * 1e3:.2f} ms; the "
          f"step's parameters {diff:.1e} from the step with no group (two steps with no group: "
          f"{floor:.1e}), metrics {'equal' if got[0] == plain[0] else 'within the floor'} ({card})")


def ddp_cli(card: str) -> dict:
    """The CLI in two ranks on cuda:0 (gloo; the group joined before
    `main`): one epoch and its eval at scannet_quick's width; returns the
    launches of both ranks."""
    import pickle
    import tempfile

    train_step = expect(**sa(), **norms(), fps=2, ball_group=1, attention_fwd=3, attention_dq=3,
                        attention_dkv=3, auction=1)
    eval_batch = expect(**sa(train=False), **norms(train=False), fps=2, ball_group=1, attention_fwd=3, auction=1)  # --eval_loss
    test_batch = expect(**sa(train=False), **norms(train=False), fps=2, ball_group=1, attention_fwd=3)
    with tempfile.TemporaryDirectory(prefix="ov3det_ddp_cli_") as out:
        run = os.path.join(out, "run")
        argv = CLI_ARGV + ["--max_epoch", "1", "--checkpoint_dir", run]
        spawn_ranks(ddp_cli_rank, (free_port(), out, argv), "ddp cli")
        ranks = [torch.load(os.path.join(out, f"cli{r}.pt"), weights_only=False)
                 for r in range(DDP_WORLD)]
        lines = ranks[0]["lines"]
        for line in lines:
            if not (" Average Precision: " in line or " Recall: " in line):
                print(f"ddp cli| {line}")
        require(not ranks[1]["lines"], f"ddp cli: rank 1 printed {ranks[1]['lines'][:2]}")
        files = sorted(f for f in os.listdir(run) if not f.startswith("events.out"))
        require(files == ["checkpoint", "checkpoint.extra.json", "checkpoint_best",
                          "checkpoint_best.extra.json", "final_eval.pkl", "final_eval.txt",
                          "scalars.jsonl"], f"ddp cli: the run wrote {files}")
        require(sum(line.startswith("mAP0.25, mAP0.50: ") for line in lines) == 1
                and lines.count("Evaluate Epoch [0/1]") == 1, "ddp cli: not one AP table")
        counts = collections.Counter()
        for r, res in enumerate(ranks):
            require(len(res["steps"]) == 4 and all(d == train_step for d in res["steps"]),
                    f"ddp cli rank {r}: steps launched {res['steps'][:1]}, expected 4 x {train_step}")
            # the train-time AP batch, the epoch's eval and the final one: a batch each
            require(len(res["evals"]) == 3 and all(d == eval_batch for d in res["evals"]),
                    f"ddp cli rank {r}: eval batches {res['evals']}, expected 3 x {eval_batch}")
            require(bool(res["saves"]) == (r == 0), f"ddp cli rank {r}: saves {res['saves']}")
            counts.update(res["counts"])
            print(f"ddp cli rank {r}: {res['wall']:.2f} s wall in main (model build, 4 steps of 8 "
                  f"of the 16 scenes, 2 evals); wait on next(loader) "
                  f"{[round(w, 2) for w in res['waits']]} ms ({SHARED_CARD}; {card})")
        with open(os.path.join(run, "final_eval.pkl"), "rb") as fh:
            two = pickle.load(fh)
        probe = CliProbe()
        reset_counts()
        one, _ = run_cli(probe, CLI_ARGV + ["--test_only", "--test_ckpt",
                                            os.path.join(run, "checkpoint"),
                                            "--checkpoint_dir", run])
        require(len(probe.evals) == 2 and all(d == test_batch for d in probe.evals),
                f"ddp cli: the one-rank eval launched {probe.evals}")
        counts.update(read_counts())
    worst = max(abs(float(one[t][k]) - float(v)) for t in two for k, v in two[t].items())
    require(worst <= 1e-3, f"ddp cli: the 2-rank AP and the one-rank eval differ by {worst}")
    print(f"ddp cli: the final eval of 2 ranks (8 scenes each) against a one-rank eval of the "
          f"same checkpoint (2 batches of 8): every AP and recall within {worst:.1e}; mAP0.25 "
          f"{two[0.25]['mAP']:.4f} ({card})")
    print(f"ddp cli launches, both ranks and the one-rank eval: "
          f"{ {n: c for n, c in counts.items() if c} }")
    return dict(counts)


def bank_cli(card: str, dev: torch.device, unbanked_waits: list) -> dict:
    """`--use_image --image_bank`: the OV CLI for one epoch, as `ov_cli`
    runs it, then the bank's canvases and a banked step against the host's
    decode."""
    import tempfile

    from ov3det_torch import main as cli
    from ov3det_torch.datasets.image_bank import BankRefDataset, yuv420_decode_rows, yuv420_encode
    from ov3det_torch.datasets.loader import collate
    from ov3det_torch.datasets.registry import build_dataset
    from ov3det_torch.engine.train import batch_to_device, build_training, decode_banked_images

    train_step = ov_step()
    eval_batch = expect(**sa(train=False), **norms(train=False), fps=2, ball_group=1, attention_fwd=3)
    probe = CliProbe()
    with tempfile.TemporaryDirectory(prefix="ov3det_bank_cli_") as run:
        argv = OV_CLI_ARGV + ["--image_bank", "--checkpoint_dir", run]
        reset_counts()
        t0 = time.perf_counter()
        training, lines = run_cli(probe, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for line in lines:
            if not (" Average Precision: " in line or " Recall: " in line):
                print(f"bank cli| {line}")
        require(len(probe.steps) == 8 and all(d == train_step for _, _, d in probe.steps),
                f"bank cli: steps launched {[d for _, _, d in probe.steps][:1]}")
        require(bool(probe.evals) and all(d == eval_batch for d in probe.evals),
                f"bank cli: eval batches launched {probe.evals[:1]}")
        payload = torch.load(os.path.join(run, "checkpoint"), map_location="cpu", weights_only=True)
        bank, hw = training.image_bank
        require(set(payload["model"]) == set(training.model.state_dict())
                and not any(v.dtype == torch.uint8 for v in payload["model"].values()),
                "bank cli: the checkpoint holds more than the detector")
    counts = read_counts()
    iters = [(b[0] - a[0]) * 1e3 for a, b in zip(probe.steps, probe.steps[1:])]
    print(f"bank cli run: {wall:.2f} s wall; the bank: {bank.shape[0]} canvases of {hw[0]} x "
          f"{hw[1]}, {bank.numel() / 1e6:.2f} MB of yuv420 on the card; iteration median "
          f"{np.median(iters):.2f} ms ({card})")
    print(f"wait on next(loader) in the step loop, banked: {[round(w, 2) for w in probe.waits]} "
          f"ms; phase 10's unbanked OV epoch: {[round(w, 2) for w in unbanked_waits]} ms ({card})")

    # the canvases the teacher gets: the device decode of the bank's rows,
    # against the host's decode of the same rows and the encode of the scenes
    cfg = cli.config_from_args(cli.make_args_parser().parse_args(argv))
    datasets, _ = build_dataset(cfg.data, splits=("train",))
    refs = BankRefDataset(datasets["train"])
    items = list(range(BATCH))
    host_rows = bank[:BATCH].cpu()
    require(all(np.array_equal(host_rows[i].numpy(), yuv420_encode(datasets["train"].get_image(i)))
                for i in items), "bank: a row is not the encode of its scene's canvas")
    banked = batch_to_device(collate([refs[i] for i in items]), dev)
    canvases = decode_banked_images(banked, (bank, hw))["image"]
    decode_ms = cuda_ms(lambda: decode_banked_images(banked, (bank, hw)), 5)
    host = yuv420_decode_rows(host_rows, (BATCH, *hw, 3))
    require(canvases.dtype == torch.uint8 and torch.equal(canvases.cpu(), host),
            "bank: the card's decode differs from the host's")
    shipped = dict(banked, image=host.to(dev))
    del shipped["image_ref"]
    metrics = []
    for batch, kw in ((banked, dict(image_bank=(bank, hw))), (shipped, {})):
        tr = build_training(cfg, 8, device=dev, seed=cfg.seed, teacher=training.teacher, **kw)
        m = tr.train_step(batch, torch.Generator(device=dev).manual_seed(0))
        metrics.append({k: v.item() for k, v in m.items()})
        del tr
    worst = max(abs(metrics[0][k] - v) / max(abs(v), 1e-6) for k, v in metrics[1].items())
    require(worst <= 1e-6, f"bank: the banked step's losses differ by {worst} relative")
    print(f"bank: the card's decode of {BATCH} rows equals the host's, uint8 ({decode_ms:.3f} ms "
          f"with the gather, CUDA events, mean of 5 after a warm-up); a banked OV step against one given those canvases: "
          f"every loss within {worst:.1e} relative, loss_2dalignment "
          f"{metrics[0]['loss_2dalignment']:.4f}; a banked batch crosses with {BATCH} x 4 B of "
          f"image_ref in place of {host.numel() / 1e6:.2f} MB of canvases ({card})")
    del training, bank
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def ddp_phase(card: str, dev: torch.device, unbanked_waits: list) -> list:
    """Phase 12: data parallelism and the image bank; returns the launch
    counts of its runs."""
    t_phase = time.perf_counter()
    steps = ddp_steps(card, dev)
    nccl_one_rank(card, dev)
    cli_counts = ddp_cli(card)
    bank_counts = bank_cli(card, dev, unbanked_waits)
    print(f"phase 12 (data parallelism and the image bank): {time.perf_counter() - t_phase:.1f} s")
    return [steps, cli_counts, bank_counts]



# ------------------------------------------------------------ phase 13: the real datasets' images
JPEG_FIXTURES = os.path.join(HERE, "tests", "data", "jpeg")  # PIL wrote them; manifest.json
# the SUN RGB-D-layout tree: 8 and 2 batches, the points of the dumps (sunrgbd_pc_bbox_50k)
SUN_TRAIN, SUN_VAL, SUN_POINTS = 64, 16, 50000
FRAMES_SCENE, FRAMES_MAX = 40, 64  # frames of the ScanNet scene, the dataset's max_frames
DECODE_REPS = 10


def sha256_of(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def median_ms(fn, reps: int = DECODE_REPS) -> float:
    """Host-clock median of `reps` calls, after one."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def check_decoder(card: str) -> float:
    """The JPEG decoder built here by g++; every committed fixture decodes
    to the digest of PIL's array in the manifest, and resizes to the digest
    of JAX's `resize_crop_image`; the progressive one raises.  Prints the
    host's decode ms; returns the median ms of a 730 x 530 canvas."""
    from ov3det_torch.datasets.image_utils import load_image, resize_crop_image
    from ov3det_torch.native import library_path
    from ov3det_torch.utils import jpeg

    built = not library_path(jpeg.SOURCE).is_file()
    t0 = time.perf_counter()
    jpeg.ensure_built()
    how = f"built by g++ in {time.perf_counter() - t0:.2f} s" if built else "loaded, built before"
    with open(os.path.join(JPEG_FIXTURES, "manifest.json")) as fh:
        manifest = json.load(fh)
    dims = tuple(manifest["resize_dims"])
    canvases, frames = [], []
    for entry in manifest["files"]:
        path = os.path.join(JPEG_FIXTURES, entry["file"])
        if entry.get("raises"):
            try:
                jpeg.read_jpeg(path)
            except ValueError as exc:
                require("progressive" in str(exc), f"{entry['file']}: {exc}")
            else:
                raise AssertionError(f"{entry['file']}: a progressive file decoded")
            continue
        img = jpeg.read_jpeg(path)
        require(list(img.shape) == entry["shape"] and sha256_of(img) == entry["sha256"],
                f"{entry['file']}: the decode differs from PIL's (manifest)")
        require(sha256_of(resize_crop_image(img, dims)) == entry["resized_sha256"],
                f"{entry['file']}: the resize differs from PIL's (manifest)")
        if (entry["width"], entry["height"]) == (730, 530):
            canvases.append(median_ms(lambda: jpeg.read_jpeg(path)))
        if (entry["width"], entry["height"]) == (1296, 968):
            frames.append((path, os.path.getsize(path)))
    require("PIL" not in sys.modules, "PIL was imported")
    frame, nbytes = frames[0]
    decode_ms = median_ms(lambda: jpeg.read_jpeg(frame))
    frame_ms = median_ms(lambda: load_image(frame, dims))
    ok = len(manifest["files"]) - 1
    print(f"jpeg decoder: {how}; {ok} fixtures decode to PIL's digests "
          f"(Pillow {manifest['pillow']}, libjpeg-turbo {manifest['libjpeg_turbo']}) and resize "
          f"to JAX's, the progressive one raises, PIL not imported")
    print(f"jpeg decode on the host (one thread, median of {DECODE_REPS}): a 730 x 530 canvas "
          f"{np.median(canvases):.3f} ms (median over {len(canvases)} fixtures: "
          f"{[round(c, 3) for c in canvases]}); a 1296 x 968 frame ({nbytes} B) {decode_ms:.3f} ms "
          f"decoded, {frame_ms:.3f} ms with the resize to {dims[0]} x {dims[1]} and the "
          f"normalisation ({card})")
    return float(np.median(canvases))


def write_sun_tree(root: str) -> dict:
    """A SUN RGB-D-layout tree of `make_scene` scans, its JPEGs cycled from
    the fixtures at SUN RGB-D's sensor sizes."""
    from ov3det_torch.datasets.synthetic import write_sunrgbd_tree

    images = sorted(os.path.join(JPEG_FIXTURES, f) for f in os.listdir(JPEG_FIXTURES)
                    if f.startswith("sun_"))
    t0 = time.perf_counter()
    tree = write_sunrgbd_tree(root, SUN_TRAIN, SUN_VAL, images, num_points=SUN_POINTS, seed=13)
    print(f"SUN RGB-D tree: {SUN_TRAIN} train + {SUN_VAL} val scans of {SUN_POINTS} points, "
          f"{len(images)} JPEGs cycled, written in {time.perf_counter() - t0:.1f} s")
    return tree


def sun_argv(tree: dict) -> list:
    """OV_CLI_ARGV on the SUN RGB-D tree in place of the synthetic set."""
    argv = list(OV_CLI_ARGV)
    argv[argv.index("synthetic")] = "sunrgbd"
    return argv + ["--dataset_root_dir", tree["root_dir"], "--meta_data_dir", tree["meta_data_dir"]]


def batch_decode_ms(argv: list) -> float:
    """Host ms of the image branch of one batch (8 canvases and their
    calibration), median of 3, in this process."""
    from ov3det_torch import main as cli
    from ov3det_torch.datasets.registry import build_dataset

    cfg = cli.config_from_args(cli.make_args_parser().parse_args(argv))
    ds = build_dataset(cfg.data, splits=("train",))[0]["train"]
    return median_ms(lambda: [ds._load_image_calib(ds.scan_names[i]) for i in range(BATCH)], 3)


def sun_bank_cli(card: str, dev: torch.device, argv: list, unbanked_waits: list) -> dict:
    """The SUN RGB-D OV CLI with --image_bank for one epoch: the launches of
    every step and eval batch, a checkpoint of the detector only; every row
    of the bank equals the yuv420 encode of its scan's canvas."""
    import tempfile

    from ov3det_torch import main as cli
    from ov3det_torch.datasets.image_bank import build_image_bank, yuv420_encode
    from ov3det_torch.datasets.registry import build_dataset

    train_step = ov_step()
    eval_batch = expect(**sa(train=False), **norms(train=False), fps=2, ball_group=1, attention_fwd=3)
    probe = CliProbe()
    with tempfile.TemporaryDirectory(prefix="ov3det_sun_bank_") as run:
        reset_counts()
        t0 = time.perf_counter()
        training, lines = run_cli(probe, argv + ["--image_bank", "--checkpoint_dir", run])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for line in lines:
            if not (" Average Precision: " in line or " Recall: " in line):
                print(f"sun bank cli| {line}")
        require(len(probe.steps) == 8 and all(d == train_step for _, _, d in probe.steps),
                f"sun bank cli: steps launched {[d for _, _, d in probe.steps][:1]}")
        require(bool(probe.evals) and all(d == eval_batch for d in probe.evals),
                f"sun bank cli: eval batches launched {probe.evals[:1]}")
        payload = torch.load(os.path.join(run, "checkpoint"), map_location="cpu", weights_only=True)
        require(set(payload["model"]) == set(training.model.state_dict())
                and not any(v.dtype == torch.uint8 for v in payload["model"].values()),
                "sun bank cli: the checkpoint holds more than the detector")
    counts = read_counts()
    bank, hw = training.image_bank
    del training
    ds = build_dataset(cli.config_from_args(cli.make_args_parser().parse_args(argv)).data,
                       splits=("train",))[0]["train"]
    rows = bank.cpu().numpy()
    require(rows.shape[0] == len(ds) == SUN_TRAIN
            and all(np.array_equal(rows[i], yuv420_encode(ds.get_image(i))) for i in range(len(ds))),
            "sun bank: a row is not the encode of its scan's canvas")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, _ = build_image_bank(ds, dev)  # serial, as the CLI and JAX build it
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(torch.equal(again, bank), "sun bank: a second build differs")
    iters = [(b[0] - a[0]) * 1e3 for a, b in zip(probe.steps, probe.steps[1:])]
    print(f"sun bank cli run: {wall:.2f} s wall; the bank: {bank.shape[0]} canvases of {hw[0]} x "
          f"{hw[1]}, {bank.numel()} B of yuv420 on the card, built (decode, encode, copy; serial) "
          f"in {build_s:.2f} s; every row the encode of its scan's canvas; iteration median "
          f"{np.median(iters):.2f} ms, {min(iters):.2f} to {max(iters):.2f} ({card})")
    print(f"wait on next(loader) in the step loop, banked: {[round(w, 2) for w in probe.waits]} ms; "
          f"unbanked: {[round(w, 2) for w in unbanked_waits]} ms ({card})")
    print(f"sun bank cli launches: { {n: c for n, c in counts.items() if c} }")
    del bank, again
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def scannet_frames(card: str) -> None:
    """`load_scene_frames` on a scene of 1296 x 968 colour frames (the two
    fixtures in turn), 640 x 480 16-bit depth PNGs (`write_png16`) and poses,
    at max_frames 64: shapes, the mask, and ms a scene."""
    import shutil
    import tempfile

    from ov3det_torch.datasets.image_utils import load_scene_frames

    frames = sorted(os.path.join(JPEG_FIXTURES, f) for f in os.listdir(JPEG_FIXTURES)
                    if f.startswith("scannet_"))
    rng = np.random.default_rng(17)
    with tempfile.TemporaryDirectory(prefix="ov3det_frames_") as root:
        scene = os.path.join(root, "scene0000_00")
        for sub in ("color", "depth", "pose"):
            os.makedirs(os.path.join(scene, sub))
        for f in range(FRAMES_SCENE):
            shutil.copyfile(frames[f % len(frames)], os.path.join(scene, "color", f"{f}.jpg"))
            write_png16(os.path.join(scene, "depth", f"{f}.png"),
                        rng.integers(0, 8000, (480, 640)).astype(np.uint16))
            np.savetxt(os.path.join(scene, "pose", f"{f}.txt"), np.eye(4) + rng.normal(0, 0.01, (4, 4)))
        out = load_scene_frames(root, "scene0000_00", max_frames=FRAMES_MAX)
        ms = median_ms(lambda: load_scene_frames(root, "scene0000_00", max_frames=FRAMES_MAX), 3)
    images, depths, poses, mask = out
    require(images.shape == (FRAMES_MAX, 3, 256, 328) and depths.shape == (FRAMES_MAX, 32, 41)
            and poses.shape == (FRAMES_MAX, 4, 4), f"frames: shapes {[a.shape for a in out]}")
    require(mask.tolist() == [1.0] * FRAMES_SCENE + [0.0] * (FRAMES_MAX - FRAMES_SCENE)
            and np.isfinite(images).all() and not images[FRAMES_SCENE:].any()
            and np.array_equal(poses[-1], np.eye(4)), "frames: mask or padding")
    require("PIL" not in sys.modules, "PIL was imported")
    print(f"ScanNet frames: load_scene_frames of {FRAMES_SCENE} frames (1296 x 968 JPEG, 640 x 480 "
          f"16-bit PNG, pose) at max_frames {FRAMES_MAX}: images {images.shape}, depths "
          f"{depths.shape}, poses {poses.shape}, mask {int(mask.sum())} ones then "
          f"{FRAMES_MAX - int(mask.sum())} zeros; {ms:.1f} ms a scene on the host, median of 3 "
          f"({ms / FRAMES_SCENE:.2f} ms a frame) ({card})")


def images_phase(card: str, dev: torch.device) -> list:
    """Phase 13: the real datasets' images; returns the launch counts of its
    two CLI runs."""
    import tempfile

    t_phase = time.perf_counter()
    canvas_ms = check_decoder(card)
    with tempfile.TemporaryDirectory(prefix="ov3det_sunrgbd_") as root:
        argv = sun_argv(write_sun_tree(root))
        counts, waits = ov_cli(card, dev, argv, "sun cli")
        per_batch = batch_decode_ms(argv)
        print(f"sun cli: the image branch of a batch ({BATCH} canvases and calibration) takes "
              f"{per_batch:.2f} ms in one host thread ({BATCH} x {canvas_ms:.3f} ms of decode = "
              f"{BATCH * canvas_ms:.2f}); the step loop's wait on next(loader): "
              f"{[round(w, 2) for w in waits]} ms ({card})")
        bank_counts = sun_bank_cli(card, dev, argv, waits)
    scannet_frames(card)
    print(f"phase 13 (the real datasets' images): {time.perf_counter() - t_phase:.1f} s")
    return [counts, bank_counts]


# ------------------------------------------------------------ phase 14: the packed, graphed step
GRAPH_STEPS, TIMED_STEPS = 3, 5  # steps held graph against eager; steps timed each way
GROUP = 4  # --super_batch of the flagged CLI epoch


def auction_work(benefit, live, eps_t, eps_l) -> tuple:
    """(bidder x object pairs, object x person tests, row-rounds, the serial
    chain) that the auction's rows need on these inputs: its rounds
    replayed with the plain round, counting a row's round only while it has
    a bidder, and the loose phase only for the rows the tight one left
    unconverged; the chain is the rounds of the row with the most (the rows
    run side by side, each round after the last)."""
    from ov3det_torch.ops.kernels import auction

    B, P, O = benefit.shape
    pairs = tests = rounds = 0
    per_row = torch.zeros(B, dtype=torch.int64, device=benefit.device)
    todo = torch.ones(B, dtype=torch.bool, device=benefit.device)
    for eps, cap in ((eps_t, 500), (eps_l, 800)):
        p2o = torch.where(live, -1, -2).to(torch.int64)
        o2p = torch.full((B, O), -1, dtype=torch.int64, device=benefit.device)
        price = torch.zeros((B, O), dtype=torch.float32, device=benefit.device)
        for _ in range(cap):
            bidders = ((p2o == -1) & todo[:, None]).sum(1)
            if not bool(bidders.any()):
                break
            n = int(bidders.sum())
            active = int((bidders > 0).sum())
            pairs, tests, rounds = pairs + n * O, tests + active * O * P, rounds + active
            per_row += bidders > 0
            p2o, o2p, price = auction._round(benefit, p2o, o2p, price, eps[:, None])
        todo = todo & (p2o == -1).any(1)
        if not bool(todo.any()):
            break
    return pairs, tests, rounds, int(per_row.max())


def check_auction(card: str, dev: torch.device) -> dict:
    """The fused auction (`auction_lap_kernel`, the whole `auction_lap` in
    one launch) and the first design (`_impl="first"`: torch ops around
    `auction_kernel`) against the plain `auction_lap`: on the cost matrices
    of 3 eager `sunrgbd_quick` steps (the criterion's own, caught at its
    call: transposed views) and a contiguous copy of the first, on seeded
    costs with ties and ragged live persons (0 included), on signed zeros, on
    near-duplicate rows that do not converge and on NaN and infinite costs;
    the three outputs equal.  On step 0's costs, in turns as graph replays:
    the fused launch, the first design's kernel alone and its whole
    `auction_lap`; the plain version once; the bound and the rounds' serial
    chain beside them."""
    from ov3det_torch.config import sunrgbd_quick
    from ov3det_torch.engine.train import batch_to_device, build_training
    from ov3det_torch.losses import criterion
    from ov3det_torch.ops.kernels import auction

    cfg = sunrgbd_quick()
    caught, real = [], criterion.auction_lap

    def spy(cost, n_persons=None, **kw):
        caught.append((cost.detach().clone(), n_persons.clone()))
        return real(cost, n_persons, **kw)

    training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0)
    gen = torch.Generator(device=dev)
    criterion.auction_lap = spy
    try:
        for i, b in enumerate(synthetic_batches(cfg, 3, 1400)):
            gen.manual_seed(i)
            training.train_step(batch_to_device(b, dev), gen)
    finally:
        criterion.auction_lap = real
    del training
    rng = np.random.default_rng(14)
    R, P, O = caught[0][0].shape
    require(caught[0][0].stride()[1] == 1, "the criterion's cost is no longer a transposed view")
    ragged = rng.integers(0, P + 1, R)
    ragged[:2] = 0, P
    seeded = [("ties, ragged live persons", torch.from_numpy(
                  rng.integers(0, 3, (R, P, O)).astype(np.float32)), ragged),
              ("signed zeros", torch.from_numpy(
                  rng.choice(np.array([0.0, -0.0, 0.5], np.float32), (R, P, O))), np.full(R, P)),
              ("near-duplicate rows", torch.from_numpy(
                  (np.repeat(rng.normal(size=(R, 1, O)), P, 1)
                   + 1e-7 * rng.normal(size=(R, P, O))).astype(np.float32)), np.full(R, P))]
    for name, bad in (("NaN costs", np.nan), ("-inf benefits", np.inf)):
        # a diverged step's: one value, one person, a whole row
        cost = rng.normal(size=(R, P, O)).astype(np.float32)
        cost[0, 5, 7], cost[1, 2], cost[3] = bad, bad, bad
        seeded.append((name, torch.from_numpy(cost), np.full(R, P)))
    cases = [(f"step {i}", c, n) for i, (c, n) in enumerate(caught)]
    cases.append(("step 0, contiguous", caught[0][0].contiguous(), caught[0][1]))
    cases += [(name, c.to(dev), torch.from_numpy(n).to(dev)) for name, c, n in seeded]
    for name, cost, n in cases:
        want = auction.auction_lap_plain(cost, n)
        for impl in (None, "first"):
            got = auction.auction_lap(cost, n, _impl=impl)
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"auction {name}: the {impl or 'fused'} design's outputs differ from the plain "
                    f"auction_lap's")
        print(f"auction {name} ({tuple(cost.shape)}, strides {cost.stride()}): the fused launch and "
              f"the first design equal the plain auction_lap")
    cost, n = caught[0]
    benefit, live, span = auction.auction_inputs(cost, n)
    args = (benefit, live, span * 2e-4, span * 5e-3)
    fns = {"fused": lambda: auction.auction_lap(cost, n),
           "first, whole": lambda: auction.auction_lap(cost, n, _impl="first"),
           "first, kernel": lambda: auction.auction_phases(*args)}
    ms = {k: [] for k in fns}
    for name in list(fns) + list(fns)[::-1]:
        ms[name].append(graph_ms(fns[name], 20))
    ms = {k: min(v) for k, v in ms.items()}
    plain = cuda_ms(lambda: auction.auction_lap_plain(cost, n), 3)
    pairs, tests, rounds, chain = auction_work(*args)
    # each (bidder, object): two subtractions, two comparisons; each (object, person): two
    ops = 4 * pairs + 2 * tests
    nbytes = R * P * O * 4 + R * 8 + R * (P + O) * 8 + R * O * 4
    b_ms, b_by = bound_ms(nbytes, ops, F32_PEAK)
    print(f"auction on step 0's costs, {R} x {P} x {O}: the fused launch {ms['fused']:.4f} ms, the "
          f"first design's kernel alone {ms['first, kernel']:.4f} ms and its whole auction_lap "
          f"{ms['first, whole']:.4f} ms (graph replays, in turns); the plain auction_lap "
          f"{plain:.3f} ms (its host checks included); {rounds} row-rounds, a chain of {chain} "
          f"rounds, {pairs} bidder x object pairs; bound {b_ms:.5f} ms ({b_by}) ({card})")
    return dict(max_abs_err=0.0, ms=ms["fused"], first_ms=ms["first, whole"],
                first_kernel_ms=ms["first, kernel"], plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                bound_term=b_by, library_ms=None, row_rounds=rounds, chain_rounds=chain,
                design="one launch for auction_lap: one CTA a row, the strided cost negated into "
                       "shared memory with the span, every round on the device with a 64-bit "
                       "key-max a winner, the fallback in the CTA",
                work=f"one sunrgbd_quick step: {R} x {P} x {O}")


@contextlib.contextmanager
def plain_spy():
    """Count the calls of the plain scatter, auction, RoIAlign, attention
    pool, normalisation, quantise pass, shared MLP and add & norm while the
    block runs
    (a Counter by name): none may run on the card's main path.  (The first
    auction design has a launch counter of its own, "auction_first".)"""
    from ov3det_torch.models import mlp, pointnet
    from ov3det_torch.ops import roi_align
    from ov3det_torch.ops.kernels import (
        add_norm,
        attn_pool,
        auction,
        ball_group,
        bn_relu,
        normalise,
        quant_conv,
    )

    calls = collections.Counter()
    targets = [(torch.Tensor, "index_put_"), (torch.Tensor, "index_add_"),
               (ball_group, "_scatter"), (auction, "auction_phases_plain"),
               (auction, "auction_lap_plain"), (roi_align, "roi_align_plain"),
               (roi_align, "roi_align_einsum"), (attn_pool, "pool_tokens_plain"),
               (attn_pool, "pool_attend_plain"), (normalise, "normalise_plain"),
               (quant_conv, "pool_quantize_plain"), (pointnet, "bn_relu_plain"),
               (bn_relu, "bn_stats_plain"), (bn_relu, "bn_relu_apply_plain"),
               (bn_relu, "bn_relu_grad_sums_plain"), (bn_relu, "bn_relu_grad_apply_plain"),
               (add_norm, "add_norm_plain"), (add_norm, "layer_norm_plain"),
               (mlp, "add_norm_plain"), (mlp, "layer_norm_plain"), (add_norm, "add_norm_grad_plain"),
               (add_norm, "add_norm_param_grads_plain")]
    originals = [(obj, name, getattr(obj, name)) for obj, name in targets]

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    for obj, name, fn in originals:
        setattr(obj, name, counted(name, fn))
    try:
        yield calls
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)


def graph_vs_eager(card: str, dev: torch.device, label: str, cfg, batches: list,
                   per_step: dict, teacher=None) -> dict:
    """`PackedStep` graphed and eager from one state and seeds on the same
    packed rows: GRAPH_STEPS steps equal bit for bit in every metric and
    every parameter and buffer; the graphed steps launch `per_step` each
    (replays counted; the first auction design never); no plain scatter or
    auction runs in either (`plain_spy`); no host wait inside a replay; then
    TIMED_STEPS more of each timed on the host clock and one graphed step
    profiled.  Returns the launch counts of the graphed steps."""
    from ov3det_torch.datasets.loader import pack_batch
    from ov3det_torch.engine.train import build_training

    packed = [pack_batch(b) for b in batches]
    metas = packed[0][1]
    require(all(m == metas for _, m in packed), f"{label}: the batches' layouts differ")
    rows = torch.from_numpy(np.stack([buf for buf, _ in packed])).to(dev)
    n = rows.shape[0]
    res, times = {}, {}
    for graph in (True, False):
        training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0, teacher=teacher)
        step = counted_packed_step()(training, 0, dev, graph=graph)
        torch.cuda.synchronize()
        if graph:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        got = []
        reset_counts()
        with plain_spy() as plain_calls:
            for i in range(GRAPH_STEPS):
                before = read_counts()
                metrics, _ = step(rows[i % n], metas, i)
                after = read_counts()
                if graph:
                    delta = {k: after[k] - before[k] for k in after}
                    require(delta == per_step, f"{label} graphed step {i}: launches {delta}, "
                                               f"expected {per_step}")
                got.append({k: v.clone() for k, v in metrics.items()})
        require(not plain_calls, f"{label} {'graphed' if graph else 'eager'} steps called plain "
                                 f"versions on the card: {dict(plain_calls)}")
        counts = read_counts()
        state = {k: v.clone() for k, v in training.model.state_dict().items()}
        state.update({f"mu{j}": t.clone() for j, t in enumerate(training.optimizer.mu)})
        res[graph] = (got, state)
        if graph:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            group = rows.repeat(-(-GROUP // n), 1)[:GROUP]
            waits = sync_points(f"{label}: {GROUP} graph replays of a group under the sync debug "
                                "mode", lambda: step(group, metas, GRAPH_STEPS))
            require(waits == 0, f"{label}: {waits} host waits inside the replay loop")
            profile(f"profiled graphed {label} step", lambda: step(rows[0], metas, 99))
        ms = []
        for i in range(TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(rows[i % n], metas, 100 + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        times[graph] = ms
        del training, step
        gc.collect()
        torch.cuda.empty_cache()
    (g_m, g_s), (e_m, e_s) = res[True], res[False]
    for i, (a, b) in enumerate(zip(g_m, e_m)):
        bad = [k for k in a if not torch.equal(a[k], b[k])]
        require(not bad, f"{label} step {i}: graphed and eager differ in {bad[:4]}")
    bad = [k for k in g_s if not torch.equal(g_s[k], e_s[k])]
    require(not bad, f"{label}: graphed and eager state differs in {bad[:4]}")
    print(f"{label}: {GRAPH_STEPS} graphed steps equal the eager ones bit for bit (losses, "
          f"grad_norm, {len(g_s)} parameters, buffers and Adam moments), and neither called "
          f"index_put_, index_add_, _scatter, the plain auction, the plain RoIAlign, the plain "
          f"attention pool, the plain normalisation, the plain quantise pass, the plain shared "
          f"MLP or the plain add & norm (a spy); step time "
          f"(host clock "
          f"to a sync, {TIMED_STEPS} steps) graphed median {np.median(times[True]):.2f} ms "
          f"({min(times[True]):.2f} to {max(times[True]):.2f}), eager median "
          f"{np.median(times[False]):.2f} ms ({min(times[False]):.2f} to {max(times[False]):.2f}); "
          f"peak device memory with the graph {peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB "
          f"before its first step) ({card})")
    return counts


def flagged_cli(card: str, argv: list, group: int, label: str) -> tuple:
    """The OV CLI for one epoch with the codecs and `--super_batch group`:
    every item launches `group` training steps' kernels (replays counted),
    every eval batch a request's.  Returns (launch counts, per-step
    Train_details of scalars.jsonl, the checkpoint's payload, iteration
    times a batch, loader waits, wall)."""
    import tempfile

    train_step = ov_step()
    eval_batch = expect(**sa(train=False), **norms(train=False), fps=2, ball_group=1, attention_fwd=3)
    probe = CliProbe()
    with tempfile.TemporaryDirectory(prefix="ov3det_flagged_") as run:
        reset_counts()
        t0 = time.perf_counter()
        _, lines = run_cli(probe, argv + ["--super_batch", str(group), "--checkpoint_dir", run])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for line in lines:
            if not (" Average Precision: " in line or " Recall: " in line):
                print(f"{label}| {line}")
        require(probe.rows == [group] * (8 // group),
                f"{label}: items of {probe.rows} batches, expected {8 // group} x {group}")
        want = {k: group * v for k, v in train_step.items()}
        require(all(d == want for _, _, d in probe.steps),
                f"{label}: an item launched {[d for _, _, d in probe.steps if d != want][:1]}")
        require(bool(probe.evals) and all(d == eval_batch for d in probe.evals),
                f"{label}: an eval batch launched {[d for d in probe.evals if d != eval_batch][:1]}")
        scalars = {}
        with open(os.path.join(run, "scalars.jsonl")) as fh:
            for line in fh:
                row = json.loads(line)
                got = {k: v for k, v in row.items() if k.startswith("Train_details/")}
                if got:
                    scalars[row["step"]] = got
        payload = torch.load(os.path.join(run, "checkpoint"), map_location="cpu", weights_only=True)
    counts = read_counts()
    # host ms from each item's start to the next's, a batch (the first holds the capture)
    iters = [(b[0] - a[0]) * 1e3 / g for (a, b), g in zip(zip(probe.steps, probe.steps[1:]),
                                                          probe.rows)]
    return counts, scalars, payload, iters, list(probe.waits), wall


def packed_phase(card: str, dev: torch.device) -> tuple:
    """Phase 14: the packed transfer, the graphed step and the auction;
    returns the auction's kernels-line entry and the launch counts of the
    flagged CLI runs."""
    import tempfile

    from ov3det_torch import main as cli
    from ov3det_torch.config import sunrgbd_quick
    from ov3det_torch.datasets.loader import batch_metas

    t_phase = time.perf_counter()
    entry = check_auction(card, dev)
    step = expect(**sa(), **norms(), fps=2, ball_group=1, attention_fwd=3, attention_dq=3, attention_dkv=3,
                  auction=1)
    sun, masked, ov = sunrgbd_quick(), scannet_masked(), ov_config()
    graph_vs_eager(card, dev, "sunrgbd", sun, synthetic_batches(sun, GRAPH_STEPS, 1500), step)
    graph_vs_eager(card, dev, "scannet_masked", masked,
                   synthetic_batches(masked, GRAPH_STEPS, 1600),
                   expect(**sa(2), **norms(), fps=3, ball_group=2, sources_map=1, feature_sum=1,
                          attention_fwd_radius=3, attention_dq_radius=3, attention_dkv_radius=3,
                          auction=1))
    batches = ov_batches(ov, GRAPH_STEPS, 1700)
    teacher = cli.build_teacher(ov, {k: v[0] for k, v in batches[0].items()}, dev)
    graph_vs_eager(card, dev, "ov_sunrgbd", ov, batches, ov_step(), teacher=teacher)
    del teacher, batches
    gc.collect()
    torch.cuda.empty_cache()

    flags = ["--quantize_points", "--yuv_images", "--log_every", "1"]
    with tempfile.TemporaryDirectory(prefix="ov3det_sunrgbd_packed_") as root:
        argv = sun_argv(write_sun_tree(root)) + flags
        sample = cli.build_dataset(cli.config_from_args(cli.make_args_parser().parse_args(argv))
                                   .data, splits=("train",))[0]["train"][0]
        for codecs in ((), ("point_clouds", "image")):
            _, nbytes = batch_metas(sample, BATCH, False, codecs)
            print(f"a group of {GROUP} SUN RGB-D OV batches (8 scenes x 20 000 points, 530 x 730 "
                  f"canvases) in one copy: {GROUP * nbytes} B "
                  f"{'with q16 points and yuv420 canvases' if codecs else 'without the codecs'}")
        sun_counts, _, _, sun_it, sun_w, sun_wall = flagged_cli(card, argv, GROUP, "sun flagged cli")
    base = CLI_RUNS.get("sun cli")
    print(f"sun flagged cli (--quantize_points --yuv_images --super_batch {GROUP}, --log_every 1): "
          f"wall {sun_wall:.2f} s; host ms a batch from an item's start to the next's (the first "
          f"item warms up and captures) {[round(x, 2) for x in sun_it]}; loader waits a group "
          f"{[round(w, 2) for w in sun_w]} ms ({card})")
    if base:
        print(f"phase 13's unflagged sun cli epoch: wall {base['wall']:.2f} s, iteration median "
              f"{np.median(base['iters']):.2f} ms ({min(base['iters']):.2f} to "
              f"{max(base['iters']):.2f}), loader waits {[round(w, 2) for w in base['waits']]} ms "
              f"({card})")
    # SUN RGB-D's train split augments from fresh entropy, so the grouped and
    # ungrouped runs are compared on the seeded synthetic OV set
    argv = OV_CLI_ARGV + flags
    grouped = flagged_cli(card, argv, GROUP, f"ov flagged cli G={GROUP}")
    single = flagged_cli(card, argv, 1, "ov flagged cli G=1")
    (g_counts, g_sc, g_pay, g_it, _, g_wall), (s_counts, s_sc, s_pay, s_it, _, s_wall) = \
        grouped, single
    require(sorted(g_sc) == [GROUP - 1, 2 * GROUP - 1] and all(g_sc[k] == s_sc[k] for k in g_sc),
            f"ov flagged cli: the grouped run logged {sorted(g_sc)}, or its losses differ from "
            "the ungrouped run's")
    bad = [k for k in g_pay["model"] if not torch.equal(g_pay["model"][k], s_pay["model"][k])]
    bad += [f"{name}{j}" for name in ("mu", "nu") for j, (a, b) in
            enumerate(zip(g_pay["optimizer"][name], s_pay["optimizer"][name])) if not torch.equal(a, b)]
    require(not bad and g_pay["optimizer"]["count"] == s_pay["optimizer"]["count"] == 8,
            f"ov flagged cli: the grouped and ungrouped checkpoints differ in {bad[:4]}")
    print(f"ov flagged cli (synthetic OV set, --quantize_points --yuv_images): --super_batch "
          f"{GROUP} equals --super_batch 1 bit for bit (the losses of steps {sorted(g_sc)}, every "
          f"parameter and Adam moment after the epoch); wall {g_wall:.2f} s and {s_wall:.2f} s; "
          f"iteration a batch G={GROUP} {[round(x, 2) for x in g_it]} ms, G=1 median "
          f"{np.median(s_it):.2f} ms ({min(s_it):.2f} to {max(s_it):.2f}) ({card})")
    print(f"phase 14 (the packed transfer, the graphed step, the auction): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return entry, [sun_counts, g_counts, s_counts]


# ------------------------------------------------------------ phase 16: the port learns
LEARN_STEPS, LEARN_BATCHES, LEARN_EVAL_SEEDS = 300, 25, (100, 101)
LEARN_ITERS_PER_EPOCH = 40  # the learning-rate schedule's epoch, as the JAX test sets it
LEARN_POINTS, LEARN_CLASSES = 768, 3


def learning_config():
    """The config of the JAX package's learning check (`tests/
    test_e2e_learning.py`) and of its twin `tests/test_torch_e2e_learning.py`,
    field for field: a 2 x 64 vanilla encoder (its attention on the plain
    path: 128 tokens, where JAX's dispatch keeps XLA), a 2 x 64 decoder, 32
    queries, 3 classes whose sizes differ, f32."""
    from ov3det_torch.config import (
        DecoderConfig,
        EncoderConfig,
        LossConfig,
        MatcherConfig,
        ModelConfig,
        OptimConfig,
        TrainConfig,
    )

    return TrainConfig(
        model=ModelConfig(
            encoder=EncoderConfig(num_layers=2, dim=64, ffn_dim=64, masking_radius=(0.16, 0.64)),
            decoder=DecoderConfig(num_layers=2, dim=64, ffn_dim=64), preenc_npoints=128,
            num_queries=32, preenc_mlp=(32, 64, 64), num_semcls=LEARN_CLASSES, num_angle_bin=1,
            clip_embed_dim=64, mlp_dropout=0.0),
        loss=LossConfig(matcher=MatcherConfig(cost_class=1, cost_objectness=5, cost_center=5,
                                              cost_giou=2),
                        giou_weight=1.0, center_weight=5.0, giou_compute_dtype="float32"),
        optim=OptimConfig(base_lr=1.5e-3, warm_lr_epochs=1, clip_gradient=0.1),
        max_epoch=10)


def learning_batches(seeds) -> list:
    """The JAX test's numpy batches: 4 `make_batch` scenes of 768 points and
    3 boxes each, from `default_rng(seed)`."""
    from ov3det_torch.datasets.synthetic import make_batch

    return [make_batch(np.random.default_rng(s), batch_size=4, num_points=LEARN_POINTS,
                       num_semcls=LEARN_CLASSES, num_angle_bin=1, num_boxes=3) for s in seeds]


def learned_ap(eval_step, num_semcls: int, batches: list, dev: torch.device) -> float:
    """mAP@0.25 of `eval_step` (the graphed eval) on numpy `batches`, as the
    JAX test measures it (`exact_eval=False`)."""
    from ov3det_torch.engine.train import batch_to_device
    from ov3det_torch.eval.ap_calculator import APCalculator

    calc = APCalculator(ap_iou_thresh=[0.25], exact_eval=False,
                        dataset_config=type("C", (), {"num_semcls": num_semcls})())
    for b in batches:
        t = batch_to_device(b, dev)
        calc.step_meter(eval_step(t), t)
    return calc.compute_metrics()[0.25]["mAP"]


def learn(card: str, dev: torch.device, label: str, cfg, batches: list, eval_batches: list,
          per_step: dict, gate: bool) -> dict:
    """LEARN_STEPS steps of `PackedStep` (graphed: step i replays on row
    i mod len(batches), its dropout seeded `step_seed(0, i)`) from the seeded
    initialisation, the schedule's epoch LEARN_ITERS_PER_EPOCH steps; each
    step launches `per_step` (replays counted) and every loss is finite.
    With `gate`, the JAX test's thresholds on the losses of steps 0, 100 and
    200 and on mAP@0.25 of `eval_batches` before and after:
    losses[-1] < 0.65 losses[0], ap_after > max(0.10, ap_before + 0.08).
    Returns the launch counts of the steps."""
    from ov3det_torch.datasets.loader import pack_batch
    from ov3det_torch.engine.train import build_training

    packed = [pack_batch(b) for b in batches]
    metas = packed[0][1]
    require(all(m == metas for _, m in packed), f"{label}: the batches' layouts differ")
    rows = torch.from_numpy(np.stack([buf for buf, _ in packed])).to(dev)
    training = build_training(cfg, LEARN_ITERS_PER_EPOCH, device=dev, seed=0)
    ap_before = learned_ap(training.eval_step, cfg.model.num_semcls, eval_batches, dev)
    step = counted_packed_step()(training, 0, dev)
    require(step.graph, f"{label}: the step must replay a CUDA graph on the card")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(LEARN_STEPS):
        metrics, _ = step(rows[i % rows.shape[0]], metas, i)
        losses.append(metrics["loss"].clone())  # a replay overwrites the static outputs
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {k: LEARN_STEPS * v for k, v in per_step.items()}
    require(counts == want, f"{label}: {LEARN_STEPS} steps launched {counts}, expected {want}")
    losses = torch.stack(losses).float().cpu().numpy()
    ap_after = learned_ap(training.eval_step, cfg.model.num_semcls, eval_batches, dev)
    at = [float(losses[i]) for i in range(0, LEARN_STEPS, 100)]
    trajectory = [round(float(losses[i]), 4) for i in range(0, LEARN_STEPS, 25)]
    print(f"{label}: {LEARN_STEPS} graphed steps in {wall:.2f} s; loss every 25 steps "
          f"{trajectory}, at steps 0, 100, 200 {[round(x, 4) for x in at]}, the last "
          f"{losses[-1]:.4f}; mAP@0.25 on {len(eval_batches)} held-out batches {ap_before:.4f} "
          f"before, {ap_after:.4f} after ({card})")
    require(bool(np.isfinite(losses).all()), f"{label}: a loss is not finite: {trajectory}")
    if gate:
        require(at[-1] < 0.65 * at[0], f"{label}: the loss fell from {at[0]} to {at[-1]}, not below "
                                       f"0.65 of it")
        require(ap_after > max(0.10, ap_before + 0.08),
                f"{label}: mAP@0.25 {ap_before} -> {ap_after}, not above max(0.10, before + 0.08)")
        print(f"{label}: passes the JAX test's thresholds (the loss at step 200 below 0.65 of "
              f"step 0's: {at[-1]:.4f} < {0.65 * at[0]:.4f}; mAP@0.25 {ap_after:.4f} > "
              f"{max(0.10, ap_before + 0.08):.4f})")
    del training, step, rows
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def learning_phase(card: str, dev: torch.device) -> list:
    """Phase 16: the JAX package's learning check on the card through the
    graphed `PackedStep`, gated at its thresholds (`learn`); then
    LEARN_STEPS graphed steps at `sunrgbd_quick()`'s full width (bf16, 8
    `make_batch` scenes x 20 000 points, LEARN_BATCHES batches cycled), every
    loss finite, the trajectory and mAP@0.25 printed (no AP gate: no JAX run
    calibrates one at that width).  Returns the launch counts of both runs."""
    from ov3det_torch.config import sunrgbd_quick

    t_phase = time.perf_counter()
    tiny = learn(card, dev, "learning check (the JAX test's config)", learning_config(),
                 learning_batches(range(LEARN_BATCHES)), learning_batches(LEARN_EVAL_SEEDS),
                 expect(**sa(), **norms(layers=(2, 2)), fps=2, ball_group=1, auction=1),
                 gate=True)
    sun = sunrgbd_quick()
    wide = learn(card, dev, "learning run (sunrgbd_quick width)", sun,
                 synthetic_batches(sun, LEARN_BATCHES, 2200), synthetic_batches(sun, 2, 2300),
                 expect(**sa(), **norms(), fps=2, ball_group=1, attention_fwd=3, attention_dq=3, attention_dkv=3,
                        auction=1), gate=False)
    print(f"phase 16 (the port learns): {time.perf_counter() - t_phase:.1f} s")
    return [tiny, wide]


NMS_THRESH = 0.25  # the eval's IoU of NMS (`get_ap_config_dict`)
NMS_REPS = 50  # calls of a timing graph
MULTI_G = 4  # steps of make_packed_multi_step's graph


def nms_bound(B: int, K: int, D: int, classes: bool) -> tuple:
    """The least time of one NMS call on the card: its inputs read once and
    its keep mask written once at the memory rate, against its f32
    operations at the f32 rate: a pair's overlap (D mins, D maxes, D
    differences, D clamps, D - 1 products, the union's two additions, its
    clamp, the division, the class product, the comparison: 5 D + 5) and
    its rank comparison (3)."""
    nbytes = B * K * (2 * D * 4 + 4 + (8 if classes else 0) + 1) + B * K
    return bound_ms(nbytes, B * K * K * (5 * D + 5 + 3), F32_PEAK)


def nms_scenes(seed: int, B: int, K: int, D: int) -> tuple:
    """(boxes (B, K, 2D), scores, classes, valid) numpy scenes with the hard
    cases of the greedy rule: boxes on a grid of 1/8, exact score ties, a
    pair at exactly the threshold, a zero-volume box, NaN, -inf, -1e30 and
    -6e29 scores, and a last scene with nothing valid; at K 32 and more,
    pairs whose overlap is the threshold and one ulp either side of it (as
    IoU and as the old type's intersection over the smaller box), an
    infinite box and a box of another class over a kept one."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 16, (B, K, D)) / 8.0
    boxes = np.concatenate([lo, lo + rng.integers(1, 10, (B, K, D)) / 8.0], -1).astype(np.float32)
    scores = (rng.integers(0, 12, (B, K)) / 16.0).astype(np.float32)
    classes = rng.integers(0, 3, (B, K)).astype(np.int64)
    valid = rng.random((B, K)) > 0.2
    boxes[0, 0] = [0.0] * D + [1.0] * D
    boxes[0, 1] = [0.0] * D + [1.0] * (D - 1) + [0.25]  # IoU 0.25 with box 0
    scores[0, :2], classes[0, :2], valid[0, :2] = [0.9, 0.8], 0, True
    boxes[0, 2, D:] = boxes[0, 2, :D]
    scores[0, 3:7] = [np.nan, -np.inf, -1e30, -6e29]
    scores[1, 1::4] = np.nan
    valid[-1] = False
    if K >= 32:
        thr = np.float32(NMS_THRESH)
        heights = (np.nextafter(thr, np.float32(0)), thr, np.nextafter(thr, np.float32(1)))
        for k, (small_first, h) in enumerate(itertools.product((False, True), heights)):
            # a unit box and a box of height h inside it: IoU h, and, when the
            # small box ranks first, the old type's intersection over the unit box h
            # (apart along x alone: the last axis starts at 0, so h keeps its ulps)
            i, base = 8 + 2 * k, np.float32(20 + 4 * k)
            boxes[1, i] = [base] + [0.0] * (D - 1) + [base + 1] + [1.0] * (D - 1)
            boxes[1, i + 1] = [base] + [0.0] * (D - 1) + [base + 1] + [1.0] * (D - 2) + [h]
            scores[1, i:i + 2] = (0.97, 0.98) if small_first else (0.98, 0.97)
            classes[1, i:i + 2], valid[1, i:i + 2] = 1, True
        boxes[1, 20] = [-np.inf] * D + [np.inf] * D  # an infinite box
        scores[1, 20], valid[1, 20] = 0.5, True
        boxes[1, 21], scores[1, 21], classes[1, 21], valid[1, 21] = boxes[1, 8], 0.95, 2, True
    return boxes, scores, classes, valid


def all_survive(B: int, K: int, D: int) -> tuple:
    """Scenes of K disjoint unit boxes in a row with distinct scores, all
    valid: every box is kept."""
    lo = np.zeros((B, K, D), np.float32)
    lo[..., 0] = 2.0 * np.arange(K, dtype=np.float32)
    boxes = np.concatenate([lo, lo + 1.0], -1)
    scores = np.tile(np.linspace(1.0, 0.01, K, dtype=np.float32), (B, 1))
    return boxes, scores, np.zeros((B, K), np.int64), np.ones((B, K), bool)


def check_nms(card: str, dev: torch.device, outputs: dict) -> dict:
    """Phase 15's kernel check: the NMS kernel's keep masks, of the cluster
    design and of the first (`_impl="first"`), against its plain version's on
    the card, bit for bit, in every mode (3D class-aware, 3D, 2D on the
    bird's-eye boxes, each also old-type) on the outputs of the two configs'
    requests (`outputs`: label -> `serve`'s NMS inputs), on crafted scenes at
    K 8, 256 and 1024 and on scenes where every box survives (K 256 and
    1024); a K above the kernel's limit raises; at the two requests' shapes
    (3D class-aware) the two designs in turns (graph replays), the plain loop
    and the bound, then both designs' parts (`scripts/nms_parts.py`).
    Returns the kernels line's keys (sunrgbd, with the masked request's under
    "scannet_masked")."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import nms_parts

    from ov3det_torch.ops.kernels.nms import MAX_K, cluster_size_for, nms_keep, nms_plain

    def modes(case: dict):
        for old in (False, True):
            yield f"3d class-aware{' old-type' if old else ''}", case["aabb"], case["classes"], old
            yield f"3d{' old-type' if old else ''}", case["aabb"], None, old
            yield f"2d bev{' old-type' if old else ''}", case["bev"], None, old

    def on_card(boxes6, boxes4, scores, classes, valid) -> dict:
        return {k: torch.from_numpy(v).to(dev) for k, v in dict(
            aabb=boxes6, bev=boxes4, scores=scores, classes=classes, valid=valid).items()}

    cases = dict(outputs)
    for K in (8, 256, MAX_K):
        boxes6, scores, classes, valid = nms_scenes(K, 4, K, 3)
        cases[f"crafted K {K}"] = on_card(boxes6, nms_scenes(K, 4, K, 2)[0], scores, classes, valid)
    for K in (256, MAX_K):
        boxes6, scores, classes, valid = all_survive(2, K, 3)
        cases[f"every box survives, K {K}"] = on_card(boxes6, all_survive(2, K, 2)[0], scores,
                                                      classes, valid)
    for label, case in cases.items():
        kept = []
        for mode, boxes, classes, old in modes(case):
            want = nms_plain(boxes, case["scores"], NMS_THRESH, case["valid"], classes, old)
            for impl in (None, "first"):
                got = nms_keep(boxes, case["scores"], NMS_THRESH, case["valid"], classes, old,
                               _impl=impl)
                require(torch.equal(got, want), f"nms {label} {mode}: the {impl or 'cluster'} "
                                                f"design's keep mask differs from the plain "
                                                f"version's in {(got != want).sum()} boxes")
            require(not label.startswith("every") or bool(want.all()),
                    f"nms {label} {mode}: not every box was kept")
            kept.append(f"{mode} {int(want.sum())}")
        B, K = case["scores"].shape
        print(f"nms {label} (B {B}, K {K}, {int(case['valid'].sum())} valid, clusters of "
              f"{cluster_size_for(K)} CTAs): both designs' keep masks equal the plain version's bit "
              f"for bit; kept {', '.join(kept)}")
    big = cases[f"crafted K {MAX_K}"]
    try:
        nms_keep(torch.cat([big["aabb"], big["aabb"][:, :1]], 1),
                 torch.cat([big["scores"], big["scores"][:, :1]], 1), NMS_THRESH,
                 torch.cat([big["valid"], big["valid"][:, :1]], 1))
    except ValueError as e:
        print(f"nms at K {MAX_K + 1}: refused ({e})")
    else:
        raise AssertionError(f"nms at K {MAX_K + 1} was not refused")

    entries = {}
    for label, case in outputs.items():
        args = (case["aabb"], case["scores"], NMS_THRESH, case["valid"], case["classes"])
        runs = {"kernel": lambda: nms_keep(*args), "first": lambda: nms_keep(*args, _impl="first")}
        ms = {n: [] for n in runs}
        for order in (list(runs), list(runs)[::-1]):
            for n in order:
                ms[n].append(graph_ms(runs[n], NMS_REPS))
        best = {n: min(v) for n, v in ms.items()}
        plain = cuda_ms(lambda: nms_plain(*args), 3)
        B, K = case["scores"].shape
        b_ms, by = nms_bound(B, K, 3, True)
        entries[label] = dict(max_abs_err=0.0, ms=best["kernel"], first_ms=best["first"],
                              plain_ms=plain, bound_ms=b_ms, bound_by=by, library_ms=None)
        print(f"nms {label} (B {B}, K {K}, 3d class-aware, {int(nms_keep(*args).sum())} kept): "
              f"cluster design {best['kernel']:.4f} ms, first design {best['first']:.4f} ms (graph "
              f"replays of {NMS_REPS} calls, in turns), plain loop {plain:.3f} ms, bound "
              f"{b_ms:.5f} ms ({by}); no library NMS ({card})")
    parts = nms_parts.parts({label: {k: case[k] for k in ("aabb", "scores", "classes", "valid")}
                             for label, case in outputs.items()})
    nms_parts.report(parts, card)
    return {**entries["sunrgbd"], "scannet_masked": entries["scannet_masked"]}


PIB_REPS = 50  # calls of a timing graph of the empty-box test
PIB_OPS = 24  # f32 operations a (point, box) pair: 3 differences, 3 projections of 5, 6 comparisons
# the first design alone as this script timed it (NVIDIA H100 80GB HBM3, 700.00 W)
FIRST_DESIGN_PIB_MS = {"sunrgbd": 0.0451, "scannet_masked": 0.1373}


def pib_bound(B: int, K: int, N: int) -> tuple:
    """The least time of one empty-box test: the points and corners read once
    and the counts written once at the memory rate, against PIB_OPS f32
    operations a (point, box) pair at the f32 rate.  That rate counts an FMA
    as two operations; the test's operations are each rounded on their own,
    which the card issues at half of it, so no kernel that gives the plain
    version's bits reaches this bound (`check_points_in_box` prints both)."""
    return bound_ms(B * N * 12 + B * K * (96 + 4), PIB_OPS * B * K * N, F32_PEAK)


def depth_to_camera(depth: np.ndarray) -> np.ndarray:
    """Corners in depth coordinates (x, y, z) -> camera ones (x, -z, y), the
    inverse of the test's flip."""
    return np.stack([depth[..., 0], -depth[..., 2], depth[..., 1]], -1)


def box_faces_scene(L: float, rng) -> tuple:
    """One scene of the empty-box test's boundary: (points (N, 3), corners
    (7, 8, 3) camera coordinates, the count box 0 must have).  Box 0 is the
    cube [0, L]^3 (L a power of two, so every projection is exact): on each
    face a point whose projection is exactly -eps or the upper limit
    f32(L^2 + eps), and one a ulp either side of it; then its two opposite
    corners and 1000 uniform points.  The others: two rotated boxes, a
    degenerate one (every corner the same point: each projection is 0, so it
    holds every point), a flat one (a zero edge), one with a NaN corner and
    one with an infinite corner."""
    eps = np.float32(1e-6)
    L = np.float32(L)
    lo, hi = -eps / L, (np.float32(L * L) + eps) / L  # exact: L is a power of two
    pts = []
    for j in range(3):
        for r, inward, outward in ((lo, np.float32(np.inf), -np.float32(np.inf)),
                                   (hi, -np.float32(np.inf), np.float32(np.inf))):
            for v in (r, np.nextafter(r, inward), np.nextafter(r, outward)):
                p = np.full(3, L / 2, np.float32)
                p[j] = v
                pts.append(p)
    pts += [np.zeros(3, np.float32), np.full(3, L, np.float32)]
    inside = 2 * 6 + 2  # the point on each face and the one a ulp in; the corners
    rand = rng.uniform(-2.0, 3.0, (1100, 3)).astype(np.float32)
    # none within 1e-4 of a face
    rand = rand[(np.minimum(np.abs(rand), np.abs(rand - L)) > 1e-4).all(-1)][:1000]
    require(len(rand) == 1000, "box_faces_scene: too few points away from the faces")
    inside += int(((rand > 0) & (rand < L)).all(-1).sum())
    points = np.concatenate([np.stack(pts), rand])

    unit = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)
    cube = depth_to_camera(unit * L)
    from ov3det_torch.geometry.boxes_np import corners_from_upright_depth_param_np

    rotated = corners_from_upright_depth_param_np(rng.uniform(-1, 2, (2, 3)),
                                                  rng.uniform(0.3, 2.5, (2, 3)),
                                                  rng.uniform(-np.pi, np.pi, 2))
    degenerate = np.broadcast_to(cube[6], (8, 3))
    flat = depth_to_camera(unit * np.array([L, L, 0], np.float32))
    nan, inf = cube.copy(), cube.copy()
    nan[4, 1], inf[3, 0] = np.nan, np.inf
    corners = np.stack([cube, *rotated, degenerate, flat, nan, inf]).astype(np.float32)
    return points.astype(np.float32), corners, inside


def check_points_in_box(card: str, dev: torch.device, outputs: dict) -> dict:
    """Phase 15's empty-box check: both designs' counts (the routed
    `points_in_box_cluster` and the first, `_impl="first"`) against the plain
    version's on the card, bit for bit and in the same dtype, on two launches
    each, at the two requests' shapes on their own outputs (`outputs`: label
    -> `serve`'s points and corners) and on crafted scenes (`box_faces_scene`
    at L 0.5, 1 and 2, the same scenes' boxes at K 1, seeded boxes at K 37,
    no multiple of the routed tile, and N 300, under one CTA's slice); then
    the routed design and the first (graph replays), the plain version and
    the matmul test (`matmul_points_in_box`) timed in turns beside the bound
    at both f32 rates.  Returns the kernels line's keys (sunrgbd, the masked
    request's under "scannet_masked")."""
    from ov3det_torch.geometry.boxes_np import corners_from_upright_depth_param_np
    from ov3det_torch.ops.kernels.points_in_box import (
        CLUSTER_TILE,
        cluster_size_for,
        points_in_box,
        points_in_box_plain,
    )

    rng = np.random.default_rng(18)
    scenes = [box_faces_scene(L, rng) for L in (0.5, 1.0, 2.0)]
    crafted = {"box faces": (torch.from_numpy(np.stack([p for p, _, _ in scenes])).to(dev),
                             torch.from_numpy(np.stack([c for _, c, _ in scenes])).to(dev))}
    crafted["box faces, K 1"] = (crafted["box faces"][0],
                                 crafted["box faces"][1][:, :1].contiguous())
    for K, N in ((37, 5000), (9, 300)):
        pts = rng.uniform(0.0, 6.0, (2, N, 3)).astype(np.float32)
        boxes = corners_from_upright_depth_param_np(
            rng.uniform(0.0, 6.0, (2 * K, 3)), rng.uniform(0.3, 3.0, (2 * K, 3)),
            rng.uniform(-np.pi, np.pi, 2 * K)).reshape(2, K, 8, 3).astype(np.float32)
        crafted[f"seeded boxes, K {K}, N {N}"] = (torch.from_numpy(pts).to(dev),
                                                  torch.from_numpy(boxes).to(dev))
    cases = {label: (o["points"], o["corners"]) for label, o in outputs.items()}
    cases.update(crafted)
    for label, (points, corners) in cases.items():
        want = points_in_box_plain(points, corners)
        for impl in (None, "first"):
            for launch in range(2):
                got = points_in_box(points, corners, _impl=impl)
                require(got.dtype == want.dtype and torch.equal(got, want),
                        f"points_in_box {label}, {impl or 'routed'} design, launch {launch}: the "
                        f"kernel's counts ({got.dtype}) differ from the plain version's "
                        f"({want.dtype}) in {int((got != want).sum())} boxes")
        B, K, N = corners.shape[0], corners.shape[1], points.shape[1]
        summary = (f"{want.tolist()}" if K <= 8 else
                   f"from {int(want.min())} to {int(want.max())}, {int((want < 5).sum())} under 5")
        print(f"points_in_box {label} (B {B}, K {K}, N {N}; the routed design's grid "
              f"{cluster_size_for(N)} x {-(-K // CLUSTER_TILE)} x {B}): both designs' counts "
              f"equal the plain version's bit for bit on two launches each; counts {summary}")
    faces = crafted["box faces"]
    counted = points_in_box_plain(*faces)[:, 0].tolist()
    require(counted == [n for _, _, n in scenes],
            f"points_in_box box faces: the cubes hold {counted}, expected "
            f"{[n for _, _, n in scenes]}")

    entries = {}
    for label, (points, corners) in cases.items():
        if label not in outputs:
            continue
        runs = {"kernel": lambda: points_in_box(points, corners),
                "first": lambda: points_in_box(points, corners, _impl="first"),
                "plain": lambda: points_in_box_plain(points, corners),
                "matmul": lambda: matmul_points_in_box(points, corners)}
        ms = {n: [] for n in runs}
        for n in (*runs, *reversed(runs)):
            ms[n].append(graph_ms(runs[n], PIB_REPS) if n in ("kernel", "first")
                         else cuda_ms(runs[n], 3))
        best = {n: min(v) for n, v in ms.items()}
        B, K, N = corners.shape[0], corners.shape[1], points.shape[1]
        b_ms, by = pib_bound(B, K, N)
        unfused = PIB_OPS * B * K * N / (F32_PEAK / 2) * 1e3
        entries[label] = dict(max_abs_err=0.0, ms=best["kernel"], first_ms=best["first"],
                              plain_ms=best["plain"], matmul_ms=best["matmul"], bound_ms=b_ms,
                              bound_by=by, bound_ms_unfused=unfused, library_ms=None)
        print(f"points_in_box {label} (B {B}, K {K}, N {N}, {B * K * N / 1e6:.1f} M point-box "
              f"pairs): routed design {best['kernel']:.4f} ms, first design {best['first']:.4f} ms "
              f"(graph replays of {PIB_REPS} calls; earlier, alone: "
              f"{FIRST_DESIGN_PIB_MS[label]} ms), plain version {best['plain']:.3f} ms, the matmul test "
              f"{best['matmul']:.3f} ms (CUDA events, in turns), bound {b_ms:.5f} ms ({by}; its "
              f"operations at the {F32_PEAK / 2e12:.1f} T/s of operations that are not fused "
              f"{unfused:.5f} ms): the routed design at {b_ms / best['kernel']:.3f} and "
              f"{unfused / best['kernel']:.3f} of them; no library call ({card})")
    return {**entries["sunrgbd"], "scannet_masked": entries["scannet_masked"]}


def ap_configs_card_vs_cpu(card: str, dev: torch.device) -> None:
    """Every NMS mode x the empty-box removal x the three proposal modes of
    `get_ap_config_dict`: `APCalculator` on the card's parse and on the
    CPU's plain path, on the same outputs (detections near the GT boxes of
    8 ScanNet-width scenes, 256 queries, 18 classes): mAP and AR within
    1e-6 at both IoU thresholds."""
    from ov3det_torch.datasets.synthetic import make_batch
    from ov3det_torch.eval.ap_calculator import APCalculator, get_ap_config_dict

    rng = np.random.default_rng(1500)
    batch = make_batch(rng, batch_size=BATCH, num_points=SCANNET_POINTS // 8, num_semcls=18,
                       num_angle_bin=1)
    out = detections_near_gt(batch, rng, 256)
    t0, worst, n = time.perf_counter(), 0.0, 0
    nms_modes = {"3d class-aware": dict(), "3d": dict(cls_nms=False),
                 "2d bev": dict(use_3d_nms=False), "no nms": dict(no_nms=True)}
    proposals = {"per class": dict(), "class prob": dict(per_class_proposal=False,
                                                         use_cls_confidence_only=True),
                 "objectness": dict(per_class_proposal=False)}
    for (mode, nms_kw), empty, (prop, prop_kw) in itertools.product(
            nms_modes.items(), (True, False), proposals.items()):
        cfgd = get_ap_config_dict(remove_empty_box=empty, **nms_kw, **prop_kw)
        metrics = {}
        for where in ("card", "cpu"):
            calc = APCalculator(ap_config_dict=cfgd)
            on = dev if where == "card" else torch.device("cpu")
            calc.step_meter({k: torch.from_numpy(v).to(on) for k, v in out.items()},
                            {k: torch.from_numpy(v).to(on) for k, v in batch.items()})
            metrics[where] = calc.compute_metrics()
        for t, m in metrics["cpu"].items():
            for key in ("mAP", "AR"):
                err = abs(float(metrics["card"][t][key]) - float(m[key]))
                require(err <= 1e-6, f"AP config {mode}, remove_empty_box {empty}, {prop}: {key} "
                                     f"at {t} card {metrics['card'][t][key]} vs CPU {m[key]}")
                worst = max(worst, err)
        n += 1
    print(f"AP settings: {n} combinations of get_ap_config_dict (NMS mode x empty-box removal x "
          f"proposal mode), the card's parse against the CPU's plain path on the same outputs: "
          f"mAP and AR at 0.25 and 0.5 within {worst:.1e} (gate 1e-6); "
          f"{time.perf_counter() - t0:.1f} s ({card})")


def multi_step_vs_single(card: str, dev: torch.device) -> None:
    """`make_packed_multi_step` at G = MULTI_G at `sunrgbd_quick` width: its
    graph of G steps, replayed once, against G replays of `PackedStep`'s
    one-step graph from the same state and seeds: every step's metrics and
    every parameter, buffer and Adam moment bit for bit; one replay of each
    timed (host clock to a sync)."""
    from ov3det_torch.config import sunrgbd_quick
    from ov3det_torch.datasets.loader import pack_batch
    from ov3det_torch.engine.train import PackedStep, build_training, make_packed_multi_step

    cfg = sunrgbd_quick()
    packed = [pack_batch(b) for b in synthetic_batches(cfg, 2 * MULTI_G, 1800)]
    metas = packed[0][1]
    rows = torch.from_numpy(np.stack([buf for buf, _ in packed])).to(dev)
    one = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0)
    multi = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0)
    single_step, multi_step = PackedStep(one, 0, dev), make_packed_multi_step(multi, 0, dev)
    # the first group: each warms up and captures
    single_step(rows[:MULTI_G], metas, 0)
    multi_step(rows[:MULTI_G], metas, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    singles = []
    for g in range(MULTI_G):
        m, _ = single_step(rows[MULTI_G + g], metas, MULTI_G + g)
        singles.append({k: v.clone() for k, v in m.items()})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stacked, _ = multi_step(rows[MULTI_G:], metas, MULTI_G)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for g, m in enumerate(singles):
        bad = [k for k in m if not torch.equal(stacked[k][g], m[k])]
        require(not bad, f"multi-step: step {g} differs from the one-step replay in {bad[:4]}")
    a, b = one.model.state_dict(), multi.model.state_dict()
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    bad += [f"{name}{j}" for name in ("mu", "nu") for j, (x, y) in
            enumerate(zip(getattr(one.optimizer, name), getattr(multi.optimizer, name)))
            if not torch.equal(x, y)]
    require(not bad and one.optimizer.count == multi.optimizer.count == 2 * MULTI_G,
            f"multi-step: the states differ in {bad[:4]}")
    print(f"make_packed_multi_step (G {MULTI_G}, sunrgbd_quick): one replay equals {MULTI_G} "
          f"one-step replays bit for bit (every loss and grad_norm, {len(a)} parameters and "
          f"buffers, the Adam moments); {MULTI_G} one-step replays {(t1 - t0) * 1e3:.2f} ms, one "
          f"{MULTI_G}-step replay {(t2 - t1) * 1e3:.2f} ms (host clock to a sync) ({card})")
    del one, multi, single_step, multi_step
    gc.collect()
    torch.cuda.empty_cache()


def eval_phase(card: str, dev: torch.device, nms_inputs: dict) -> dict:
    """Phase 15: the evaluation path (slice 13).  The graphed requests
    against the eager ones ran in `serve` (phases 3 and 7); here the NMS
    kernel, every AP setting card against CPU and the multi-step graph.
    Returns the kernels-line keys of NMS and the empty-box test."""
    t0 = time.perf_counter()
    entries = {"nms": check_nms(card, dev, nms_inputs),
               "points_in_box": check_points_in_box(card, dev, nms_inputs)}
    ap_configs_card_vs_cpu(card, dev)
    multi_step_vs_single(card, dev)
    print(f"phase 15 (the evaluation path): {time.perf_counter() - t0:.1f} s")
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ov3det_torch", "csrc")):
        print("chip_smoke: the ov3det_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ov3det_torch.config import sunrgbd_quick
    from ov3det_torch.ops.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s for {sorted(logs) or 'cached libraries'}")
    for name, log in sorted(logs.items()):
        lines = ptxas_summary(log)
        many = [line for line in lines if line.startswith("fps_cluster_kernel")]
        for line in lines:
            if line not in many:
                print(f"  {name}: {line}")
            require("_wgmma" not in line or ", 0 B spilled" in line, f"{line}: a wgmma kernel spills")
            require("quant_conv_wgmma" not in line or "stack frame" not in line,
                    f"{line}: the trunk conv's accumulators must stay in registers")
        advisories = wgmma_advisories(log)
        require(not advisories, f"{name}: ptxas serialised wgmma or ignored setmaxnreg: {advisories}")
        if many:  # one instantiation per count of points a thread, with and without a cluster
            facts = [line.split(": ")[1].split(", ") for line in many]  # registers, spills, shared
            regs = [int(f[0].split()[0]) for f in facts]
            spilled = sum(int(f[1].split()[0]) for f in facts)
            shared = max(int(f[2].split()[0]) for f in facts)
            require(spilled == 0, f"fps_cluster_kernel spills {spilled} B: the chain must stay in "
                                  "registers")
            print(f"  {name}: fps_cluster_kernel: {len(many)} instantiations (0 to 32 points a "
                  f"thread; one CTA or a cluster), {min(regs)} to {max(regs)} registers, {spilled} B "
                  f"spilled in all, at most {shared} B static shared")
    for line in sass_summary():
        print(f"  {line}")

    dev = torch.device("cuda")
    sun, masked = sunrgbd_quick(), scannet_masked()
    batches = synthetic_batches(sun, REQUESTS, 100)
    entries = {**check_kernels(batches[0], dev), **check_attention(dev)}
    served, sun_nms = serve(sun, batches,
                            expect(**sa(train=False), **norms(train=False), fps=2, ball_group=1,
                                   attention_fwd=3, nms=1, points_in_box=1), "sunrgbd", dev, card)
    card_vs_cpu(batches[0])
    trained = train(sun, TRAIN_STEPS,
                    expect(**sa(), **norms(), fps=2, ball_group=1, attention_fwd=3, attention_dq=3,
                           attention_dkv=3, auction=1), "sunrgbd", 200, dev)
    train_card_vs_cpu(sun, "sunrgbd", 200)
    sa_sun = check_bn_relu(card, "sunrgbd", record_sa(sun, batches[0], dev), timed=True)
    check_bn_relu(card, "sunrgbd f32", record_sa(f32_no_dropout(sun), batches[0], dev),
                  timed=False)
    sun_norms = record_add_norm(sun, batches[0], dev)
    norm_sun = check_add_norm(card, "sunrgbd", sun_norms, timed=True)
    check_norm_crafted(card, next(r for r in sun_norms if r["keep"] is not None))
    del sun_norms
    check_add_norm(card, "sunrgbd f32", record_add_norm(f32_no_dropout(sun), batches[0], dev),
                   timed=False)

    m_batches = synthetic_batches(masked, REQUESTS, 300)
    extras, pre_xyz, mid_xyz = check_masked_points(m_batches[0], dev)
    for name, extra in extras.items():
        if name in entries:
            entries[name]["scannet_masked"] = extra
        else:
            entries[name] = extra
    entries.update(check_radius_attention(pre_xyz, mid_xyz, dev))
    del pre_xyz, mid_xyz
    m_served, masked_nms = serve(masked, m_batches,
                                 expect(**sa(2, train=False), **norms(train=False), fps=3,
                                        ball_group=2, attention_fwd_radius=3, nms=1,
                                        points_in_box=1),
                                 "scannet_masked", dev, card)
    m_trained = train(masked, MASKED_TRAIN_STEPS,
                      expect(**sa(2), **norms(), fps=3, ball_group=2, sources_map=1,
                             feature_sum=1, attention_fwd_radius=3, attention_dq_radius=3,
                             attention_dkv_radius=3, auction=1),
                      "scannet_masked", 400, dev)
    train_card_vs_cpu(masked, "scannet_masked", 400)
    sa_masked = check_bn_relu(card, "scannet_masked", record_sa(masked, m_batches[0], dev),
                              timed=True)
    norm_masked = check_add_norm(card, "scannet_masked", record_add_norm(masked, m_batches[0], dev),
                                 timed=True)

    cli_counts = cli_phase(card)
    ov_trained, ov_cli_counts, ov_waits, quant_entries, calibration = ov_phase(card, dev)
    entries.update(quant_entries)
    pseudo_counts, entries["first_k"] = pseudo_phase(card, dev)
    entries.update(sa_entries(sa_sun, sa_masked, SA_CHECKED))
    entries.update(norm_entries(norm_sun, norm_masked, NORM_CHECKED))
    ddp_counts = ddp_phase(card, dev, ov_waits)
    image_counts = images_phase(card, dev)
    entries["auction"], packed_counts = packed_phase(card, dev)
    learning_counts = learning_phase(card, dev)
    entries.update(eval_phase(card, dev, {"sunrgbd": sun_nms, "scannet_masked": masked_nms}))
    del sun_nms, masked_nms

    runs = {"sunrgbd requests": served, "sunrgbd steps": trained, "masked requests": m_served,
            "masked steps": m_trained, "cli": cli_counts, "ov steps": ov_trained,
            "ov calibration": calibration, "ov cli": ov_cli_counts, "pseudo": pseudo_counts,
            **{f"ddp {i}": c for i, c in enumerate(ddp_counts)},
            **{f"images {i}": c for i, c in enumerate(image_counts)},
            **{f"packed {i}": c for i, c in enumerate(packed_counts)},
            **{f"learning {i}": c for i, c in enumerate(learning_counts)}}
    print("launches by run: " + json.dumps({label: {n: c for n, c in counts.items() if c}
                                            for label, counts in runs.items()}))
    int_mm = {label: counts["int_mm"] for label, counts in runs.items() if counts.get("int_mm")}
    require(not int_mm, f"torch._int_mm ran on the card's main paths: {int_mm}")
    kernels = []
    for name, (source, replaces) in kernel_sources().items():
        count = sum(c.get(name, 0) for c in runs.values())
        require(count > 0, f"{name} was not launched on the main paths")
        # every row names its first design's time: `first_ms`, from the
        # older rows' `ms_previous_design`; null where the kernel has none
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": count,
                        "first_ms": entries[name].get("ms_previous_design"), **entries[name]})
    print(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s, the build {build_s:.1f} s of it")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
