#!/usr/bin/env python3
"""Drive the PyTorch port (imfnet_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # needs one card; no arguments

Phases, each printed as one JSON line:
  device    nvidia-smi's name and power limit, torch and CUDA versions
  build     the four CUDA kernels built from imfnet_tpu_torch/csrc (nvcc,
            one process each, in parallel), with seconds and the
            compiler's register report, and the spills of each of kernel
            A's tensor-core instances (reported; there should be none)
  pipeline  warm-up pairs, then timed pairs through PairRegistrar() at bench
            scale (synthetic_pair(RandomState(0), 200k points), 120x160
            images, DEFAULT_BUCKETS 2-batch pad, full-width ResUNetBN2C,
            bf16, 5000 keypoints, 50k hypotheses): pairs/s, per-stage ms,
            voxel and level counts, and the kernel launches of the timed
            run, which must be 20 (kernel A, all 20 in its tensor-core
            variant), 2 (kernel B) and no C or D per pair
  grid_pipeline  the same pair and weights through the packed-grid path,
            PairRegistrar(compact_impl="kernel", map_impl="banded"): the
            same measurements; launches must be 1 (kernel C), 1 (kernel D:
            one grouped launch for the pyramid's ten maps), 20 (A, all
            tensor-core) and 2 (B) per pair, and its voxel
            table and every kernel map must equal the default path's bit
            for bit, its descriptors within 1e-5
  kernel    kernel A (sparse-conv gather-GEMM) at every conv shape of the
            main path, on the level sizes of the bench-scale pair, kernel B
            (flash NN) on the main path's keypoint descriptors, kernel C
            (sorted-run compaction) on the pair's 262 144 sorted raw-point
            keys (and on them doubled, so that every run has a duplicate,
            with enough slots and with too few), and kernel D
            (word-table match) at each of the grid
            path's 10 banded maps and on all ten in one grouped launch, as
            the path makes it, each against its plain PyTorch version
            on the same inputs: max error vs the stated tolerance (C and D
            exact), kernel / plain / library ms (CUDA events) and the
            roofline bound; the kernels, whose calls take microseconds, are
            timed as CUDA-graph replays (their eager event timing, bound
            by the host's launch rate, is kept as eager_ms), and
            launch_floor_ms is an empty kernel's replay. Kernel B also
            reports its plan (tile, split), that two calls are bit-equal,
            ragged sizes, ties and all-invalid references against the
            plain version, and a sweep of every built tile and split at the
            main path's shape with the plan's choice beside the best, and
            the SM clock and power while it runs back to back.
            Kernel A also
            reports its plan (variant, tile, split), that two calls are
            bit-equal and dead rows exactly 0, and dense_gemm_ms: one
            torch.matmul of the pre-gathered [n_out, 27*cin] bf16 matrix by
            [27*cin, cout], a yardstick of the dense work only (the port
            never calls it)
  roofline  sparse/roofline.py on the pipeline's pyramid: its bytes of the
            20 kernel-A convs, conv by conv through the maps, equal the
            kernel phase's (whose bound now comes from the same
            conv_traffic_bytes), and the forward's and kernel A's bytes over
            their ms as a share of the card's 3.35 TB/s
  dgr       DGR's registrar (eval/dgr.py, dgr_kitti_config, seeded weights)
            on a KITTI-sized pair (67 000 voxels a side, 30 % of the
            descriptors matching): ms and pairs/s of the graphed chain and
            its launches a pair, counted alone (kernel A 20 in the wide-K
            variant tcw and 1 cin1, kernel B 1, asserted); then, on that
            pair's own 6-D pyramid, kernel A at each distinct k3 conv of the
            network (729 offsets, tcw asserted) and at conv1 (cin 1, k 729,
            cin1 asserted) against the plain version over blocks of rows
            (1e-4 of the output's scale; dead rows 0, two calls bit-equal):
            graph-timed ms, tcw's ms without its walk tally and of its list
            build alone (the walk the rest), its tally against a count on
            the host (slots and live entries; the entries that waited on
            their row's order), the map's live entries a row, and the
            roofline bound from the map's live entries and bytes; last,
            the 20 tcw convs of a pair in network order in one graph (each
            residual block's two sharing one list build), with the tally
            and without, in turns, and with no list build shared
  reference the chain on a small pair, on the card vs on the CPU (the
            plain versions, which the CPU tests hold to the JAX package),
            in f32 for the default and the packed-grid path (equal tables,
            descriptors and transform within tolerance), and in bf16 for
            the default path, where the card's forward takes kernel A's
            tensor-core variant (equal tables, descriptors within the bf16
            tolerance)
  paths     pair latency of both paths, each as CUDA-graph replays (the
            default of PairRegistrar on the card) and eager
            (graphed=False), interleaved on the same host
  graphs_pair  the default path's post-quantize chain, one CUDA graph per
            bucket, against the same registrar run eagerly: every output
            bit for bit over a warm-up, a capture and a replay, the
            keypoints' NN indices both ways and RANSAC's inlier mask from
            one graph of nn_auto x2 + ransac_registration against the same
            calls eagerly (equal), the pose within 1e-3, a replay's launches
            (A 20, B 2), pairs/s and median both ways in blocks (eager,
            graphed, graphed, eager)
  builders  both pyramid builders ("search", "banded") on the bench-scale
            pair through PairRegistrar with kernel C's quantize: tables bit
            for bit equal to the search builder's, launches per pair (A 20,
            B 2, C 1, D 1 for "banded" alone), and, interleaved round by
            round, pyramid ms on one quantized pair and pair latency
  profile   torch.profiler over three pairs: device-busy ms per pair, the
            device's idle share against the unprofiled wall time, kernel
            launches per pair, the top kernels by device time, and the
            device ms and launches per pair of each CUDA kernel of csrc/ in
            place on the path
  grid_profile  the same for the packed-grid path; profile_eager the
            default path eager. The profiles come after every timed phase
            up to the trainer (a profiling session slows later launches)
  train_kernel  the kernels at the shapes of the training step, on a side of
            the full-width training batch: kernel A at the 20 dX calls of a
            backward (the forward's convs through their inverse maps, cin and
            cout swapped; tensor-core variant asserted, two calls bit-equal)
            and at conv1 (k 125, cin 1: the cin1 variant asserted, bit-equal
            twice and dead rows exactly 0, beside the scalar variant that
            took it before), kernel B at the
            positive search's 65 536 x 65 536 x 3 with the other pair's
            references masked (its D = 3 plan, the min fold, and the sweep
            of every min-fold tile at splits 1 and 2, the plan's choice
            beside the best), and the plain dW products (no kernel) per step
  train_reference  one training step at a small size in f32 on the card
            against the CPU (loss, every gradient, every updated parameter
            and buffer within the stated tolerances), then 8 steps at lr
            0.03 on the card, which must end below the first loss
  train     3 warm-up and 10 timed steps of ResUNetBN2C at full width
            (bench_config, bf16, conv1 k5 not in occupancy mode, batch of 2
            pairs: synthetic_batch(RandomState(0), 2, 200k points, n_pad
            65 536), SGD with momentum and weight decay): steps/s, median
            step ms, every loss finite, the share of voxels with a positive
            per pair of the batch, 2 000 sampled queries of each pair against
            an f64 brute force, kernel launches per step asserted (A 82: 80
            tensor-core + 2 cin1 and no scalar; B 2; C and D 0), peak memory
  dp        data parallelism at the train phase's width (bench_config, the
            search builder, synthetic_batch(RandomState(0) and (1), 2 pairs,
            200k points, n_pad 65 536)). One rank over NCCL, in this
            process after the train phase: 3 DP steps from a copy of one
            start bit-equal to 3 plain steps (parameters, buffers, momentum,
            losses), both timed interleaved, one more DP step under the
            profiler for the all-reduce's kernels and bytes. Two ranks
            sharing the card over gloo (make_mesh(devices=["cuda:0",
            "cuda:0"])), in the one pair of new processes of the last
            phases: 3 steps against make_emulated_dp_step on the same
            batches and draws (within 1e-5 of each tensor's largest entry;
            the maximum printed), both ranks bit-equal, A 82 (80 tensor-core
            + 2 cin1), B 2 a rank and step; batches/s of the two ranks
            against one. Then
            Trainer.train() on the two ranks (2 epochs of 2 steps, 50 000
            points a fragment, one validation pair an epoch) against 1
            epoch, a checkpoint and a resume: bit-equal on each rank; per
            rank and training step A 82, B 2, D 2, per validation step A 42,
            B 1, D 2. The line comes near the end, with sharded's
  graphs    the training step replayed as a CUDA graph
            (make_graphed_train_step, the search builder) against
            make_train_step at the train phase's width, from one seed, two
            steps an epoch: after 6 steps parameters, buffers, momentum,
            learning rate, losses and generator bit-equal; a replay's
            launches A 82 (80 tensor-core + 2 cin1), B 2; steps/s and median
            both ways in blocks (eager, graphed, graphed, eager). Then the
            validation step (one pair, same width) graphed against eager:
            metrics bit-equal, a replay A 42, B 1, ms both ways
  nn_widths kernel B at widths of its chunk fold (any D but 3 and 32, padded
            to a multiple of 8; fault 5): at 5 000 x 5 000 at D = 16, 64 and
            256 against its plain version (each choice's exact distance
            within the d^2 gate, two calls bit-equal), graph-timed beside its
            bound, the plain version and cdist + min; ragged sizes; the chunk
            fold at D = 32 bit-equal to the pair fold. Then model_n_out 16:
            the graphed validation step at the train phase's width and
            eval-3dmatch's register against their eager calls (bit-equal, a
            replay's launches as eager), and cli train --model-n-out 16
            through an epoch and its validation on the card
  graphs_kitti  eval-kitti's pair (make_eval_pair: both forwards and the
            registration in one CUDA graph, the draws of pair i outside)
            against graphed=False at kitti_config width on KITTI scans the
            phase writes: every output bit-equal over each pair and three
            calls of pair 0, a replay's launches A 40, B 2, D 2, ms both
            ways; the test split's ICP in the loader's producer thread
            beside this thread's pair graphs, and in a loader worker process
            (workers=1), each refined ground truth bit-equal to eager ICP's
  graphs_icp  ICP (icp_point_to_point) replayed as one CUDA graph against
            the eager loop on pair 0 of those scans (2^17 a side, 30
            iterations): T bit-equal, a replay's launches B 30, ms both ways
  graphs_extract  the bucketed extractor (quantize, pyramid, forward: three
            graphs a fragment, the host reads between them) against
            graphed=False at full width on the bench pair's side 0, grid and
            exact path: points and descriptors bit-equal, launches a fragment
            (A 20, + C 1 + D 1 on the grid path), ms both ways; then every
            bucket's pyramid and forward graph captured on both paths, and
            the reserved memory before and after
  graphs_3dmatch  eval-3dmatch's register (make_scene_register, one graph per
            keypoint pad, width and swap, RANSAC's uniforms outside) against
            the eager call at bench_config on 5 000 keypoints a side, 32-d:
            outputs bit-equal for both swaps, a replay's launches B 2, ms
            both ways. The five phases come after graphs; their profiles
            (graphs_*_profile, graphs_*_profile_eager: busy ms, idle share,
            runtime launch calls a call) after train_profile_graphed
  train_profile  torch.profiler over three steps: device-busy ms per step,
            idle share, launches per step, each csrc/ kernel in place;
            train_profile_graphed the same for the graphed step
  trainer   Trainer.train() at full width (bench_config: ResUNetBN2C
            32/64/128/256, conv1 k5, bf16, divisors (1, 3, 8, 20), 65 536
            rows a side, 2 pairs a batch, the grid pyramid that the config
            asks for) on SyntheticPairDataset with 200k points a fragment,
            through make_data_loader: 3 epochs of 4 steps, a validation epoch
            of 2 pairs before the first and after each, a checkpoint an
            epoch, written to a temporary directory. Steps/s including the
            loader, median step ms, the loader's wait (data_timer) and its
            share of an iteration, the ms of moving a batch to the card,
            kernel launches per training and per validation step, peak
            memory, each epoch's mean loss, each validation epoch's metrics,
            the checkpoint names. Fails unless every loss is finite, the last
            epoch's mean loss is below the first's, a training step launches
            A 82 (80 tensor-core + 2 cin1), B 2, D 2 and C 0 and a
            validation step A 42, B 1, D 2, a best-validation checkpoint
            exists, and the last checkpoint loaded into a new Trainer takes a
            next step bit-equal (loss, parameters, buffers, momentum) to the
            first trainer's. The run's loaders are the card's defaults: a
            worker process for training (workers=1), a thread for
            validation; the phase then runs the same config with the
            training loader's thread (workers=0) and fails unless every
            loss, and the parameters, buffers and momentum after the first
            epoch, equal the first run's bit for bit and no loader worker is
            alive after the runs. Batches reach the card through the
            trainer's staging ring (train/trainer.py::BatchStager); one more
            epoch with the worker moves every field pinned and copied on its
            own, as before the ring, and must equal the first run's first
            epoch bit for bit (losses, parameters, buffers, momentum): the
            move with and without the ring is printed ("staging"). Both
            runs' steps/s with the loader (over
            all epochs and over epochs 2-3, after the worker's start),
            median step, data share and move ms are printed with
            nvidia-smi's name and power limit, beside the trainer's step on
            one repeated batch (loader_bench.py reads the two loaders over
            100-step epochs). Every run but the last replays its steps as
            CUDA graphs (the card's default); the last runs the first
            configuration with both steps eager (graphed=False) and must
            equal it bit for bit (losses, validation metrics, the first and
            the last epoch's state, the generator), its rates beside the
            graphed run's ("graphs_vs_eager", loader_runs.eager_workers_1). The train_kernel phase
            also holds kernel D to its plain version on the grid pyramid of
            a side of the batch
  trained_pair  a held-out synthetic pair (a seed no training or validation
            sample has) through PairRegistrar(state_dict=...) with the seeded
            random weights and with the trainer's: inlier ratio, RRE, RTE,
            accepted; reported, gated only on finite well-formed outputs
  benchmark the 3DMatch path at full width through the CLI (cli.main in this
            process, so that launches are counted): generate-desc then
            eval-3dmatch with the trainer's best checkpoint, on a scene the
            phase writes (six 204 000-point PLY fragments of one synthetic
            world, the last also seeing a wall 16 m away: the exact path;
            gt.log and gt.info of the consecutive pairs; no images).
            Extraction ms per fragment by path, in generate-desc and in a
            second, warm generate-desc into a new directory, fragment 0
            alone against inside them, the AVG stat, launches per fragment,
            kernel B per pair, evaluation pairs/s and the summary. Fails
            unless grid fragments launch C 1, D 1, A 20 (tensor-core) and
            exact ones A 20 alone, each pair B 2, A, C and D equal their
            plain versions at a fragment's shapes and B at 5000 x 5000 x 32,
            every raw point's voxel has a descriptor row, a 6 000-point
            fragment's points are equal and its descriptors within the bf16
            gate on the card and the CPU, and num_pairs is gt.log's count
  kitti     kitti_config width (voxel 0.3, max_points 131 072, extent 704 x
            704 x 128): five 120 000-point scans over +-40 m in a KITTI
            layout, each its own 85 % of one world with 1 cm of noise, whose
            poses are off by 0.03 deg and 3 cm; the test pairs' ground truth
            refined by ICP on the card from that start (ms and kernel-B
            launches a pair, 30 asserted; within 5 mm and 0.01 deg of the true
            motion; card vs CPU on 8 192 points a side within 1e-4), kernel B
            against its plain version at ICP's 131 072^2 x 3 (d^2 within 1e-6
            of the largest |x|^2, the choice's exact d^2 within twice that)
            and at the evaluation's 131 072^2 x 32 with cdist + min beside it,
            A and D against theirs at pair 0's pyramid (131 072 rows,
            divisors 1, 1, 2, 4), pair 0's forward and registration ms, then
            eval-kitti through the CLI: success rate,
            RTE, RRE, launches a pair (A 40, B 2, D 2 asserted), and the
            skipped and evaluated pairs adding up to the file list; last,
            one ICP call under torch.profiler (kitti_icp_profile: device
            busy ms, idle share, kernel launches, top kernels)
  zoo       SimpleNetBN2C at full width (channels 32/64/128/256, tr
            32/64/64/128, conv1 k5, 32-d, bf16) through the bucketed
            extractor on fragment 0 of the benchmark scene (written anew):
            ms and launches a fragment (C 1, D 1, A 8 with conv1 in the
            cin1 variant, asserted), kernel A at each of its 8 convs
            against the plain version (1e-4 of scale; variants asserted:
            cin1 then 7 tensor-core), then 3 training steps on the train
            phase's batch (finite losses; A 30 of which 2 cin1, B 2 a step,
            asserted)
  convert   the seeded full-width ResUNetBN2C written as a released
            checkpoint would hold it (MinkowskiEngine offset order,
            perceiver_io names, the torchvision trunk) into a .pth, then cli
            convert-imfnet and generate-desc on fragment 0 with the converted
            and with the original weights: tensors and descriptors bit-equal
  dam       cli dam with the converted checkpoint on fragment 0, a seeded
            120 x 160 PNG, --point 780 and --image-out: the command's
            launches (A 49: 20 for the DAM's forward, 20 + 9 dX for the
            saliency; C 1, D 1), the ms of each map, A's 9 decoder dX calls
            against the plain version at the fragment's pyramid, card vs CPU
            in f32 on 6 000 of its points (DAM 1e-4, saliency 1e-3 of the
            largest value), the PLY's coloured points and the PNG's shape
  visualize cli visualize on fragments 0 and 1 with seeded PNGs: launches
            (C 1, D 1, A 20 a fragment, B 2 a pair, asserted), fitness and
            pose (finite, rigid), both views holding both clouds, coloured
  offline   a 3DMatch-style sequence of 50 480 x 640 depth PNGs of a
            synthetic room, cli fuse-fragments at 256^3 (2 fragments of 25
            frames, ms a frame), the first 8 frames fused on the card and on
            the CPU (point count within 0.5 %, every point within 2 voxels
            of the other cloud), cli
            compute-overlap on the six benchmark fragments in the world's
            frame (kernel B, one launch a pair at up to 204 000^2 x 3, held
            as in the kitti phase and timed beside its bound, its plain
            version and cdist + min; kept pairs and ratios against an f64
            KD-tree within 1e-3), cli compute-radius's seconds, and which
            voxel dedup ran (the native library or the numpy fallback)
  sharded   generate-desc on the benchmark scene (written anew) and
            eval-kitti on the KITTI scans (written anew, ICP cached first)
            through the CLI's rank functions, on two ranks sharing the card
            over gloo (the dp phase's processes) against rank 0 alone in
            the same processes (the serial path): every .npz equal (xyz exact,
            descriptors within 1e-5), the KITTI summaries equal, launches
            adding up to C 1 + D 1 + A 20 a grid fragment, A 20 the exact
            one, A 40 + B 2 + D 2 a pair; fragments/s and pairs/s of both
            from the slowest rank's seconds of the whole call, a second
            call in the same process (the first holds the warm-up), and
            generate-desc's "All Time" ratio beside them
  rejecting_ranks  fault 4 in the same pair of processes: one epoch of the
            DP Trainer (4 batches of 2 pairs, 50 000 points) whose rank 1
            dataset rejects both pairs of its first batch; fails unless
            both ranks end at their loader's steps, every batch each took
            holds 2 pairs, and rank 1 counts the rejections
Then one line {"kernels": [...]} (each kernel's launches on every path,
these included) and, last, {"ok": true, "device": {...}}.
Any failure raises and exits non-zero; so does a machine without CUDA.
"""
import argparse
import contextlib
import glob
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from imfnet_tpu_torch import cli
from imfnet_tpu_torch.config import dgr_kitti_config, kitti_config, threedmatch_config
from imfnet_tpu_torch.data.datasets import (KITTIPairDataset, SyntheticPairDataset,
                                             make_data_loader, velo2cam)
from imfnet_tpu_torch.data.synthetic import _surface_cloud, synthetic_batch, synthetic_pair
from imfnet_tpu_torch.eval import threedmatch
from imfnet_tpu_torch.eval.dgr import DGRRegistrar
from imfnet_tpu_torch.eval.extract import (DEFAULT_BUCKETS, make_bucketed_extractor,
                                           pad_points_bucketed)
from imfnet_tpu_torch.data.collate import voxelize_np
from imfnet_tpu_torch.eval.kitti import make_eval_pair, registration_errors
from imfnet_tpu_torch.eval.registration import make_pair_registration, sample_keypoints_segment
from imfnet_tpu_torch.geom.ply import write_ply
from imfnet_tpu_torch.geom.transforms import apply_transform_np, axis_angle_rotation
from imfnet_tpu_torch.match.icp import icp_graphed, icp_point_to_point
from imfnet_tpu_torch.match.nn_kernel import (MAX_SPLIT, NN_CHUNK_TILES, NN_MIN_TILES, NN_TILES,
                                                NNPlan, flash_nn, nn_plain, nn_plan, run_plan)
from imfnet_tpu_torch.match.nn import nn_auto
from imfnet_tpu_torch.match.ransac import ransac_registration, sample_shape
from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.parallel import dp
from imfnet_tpu_torch.parallel.mesh import close_mesh, make_mesh, mesh_backend, spawn_ranks
from imfnet_tpu_torch.pipeline import (HYPO_BLOCK, N_PAD_MAX, PairRegistrar, bench_config,
                                       init_model)
from imfnet_tpu_torch.sparse.conv_kernel import (SCALAR_TILE, TC_TILES, ConvPlan, conv_plan,
                                                 gather_gemm, gather_gemm_plain, shared_lists,
                                                 tcw_lists, tcw_tally_plain)
from imfnet_tpu_torch.sparse.conv_kernel import run_plan as conv_run_plan
from imfnet_tpu_torch.sparse.grid import (GridSpec, cell_keys, compact_words, level_tables,
                                          quantize_grid, word_queries)
from imfnet_tpu_torch.sparse.kernel_map import coarse_levels_fit
from imfnet_tpu_torch.sparse.coords import quantize, row_mask
from imfnet_tpu_torch.sparse.ops import weight_grad
from imfnet_tpu_torch.sparse.quant_kernel import sorted_compact, sorted_compact_plain
# the H100's peaks (NVIDIA data sheet, used for bounds only) and kernel A's
# traffic model
from imfnet_tpu_torch.sparse.roofline import (PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS,
                                              conv_traffic_bytes, forward_convs,
                                              forward_hbm_bytes)
from imfnet_tpu_torch.sparse.word_map_kernel import (empty_launch, word_match_many,
                                                     word_match_plain)
from imfnet_tpu_torch.train.checkpoint import load_model_from_checkpoint, save_checkpoint
from imfnet_tpu_torch.train.state import create_train_state
from imfnet_tpu_torch.train.step import (PairBatch, compute_correspondences, forward_pair,
                                         level_capacities, make_graphed_train_step,
                                         make_loss_fn, make_pyramid_fn, make_train_step,
                                         mean_step_over_ranks)
from imfnet_tpu_torch.train.trainer import (STAGING_SLOTS, Trainer, batch_to_device,
                                            build_model_from_config)
from imfnet_tpu_torch.train.validate import make_graphed_val_step, make_val_step
from imfnet_tpu_torch.utils import cuda_build, timer
from imfnet_tpu_torch.utils.graphs import jit


# The 20 kernel-A convs of one ResUNetIMF forward: (name, level, map, cin,
# cout). The map of level i gathers from level i (k3_same), i-1 (down) or
# i+1 (up).
MAIN_PATH_CONVS = (
    [("block1", 0, "k3_same", 32, 32)] * 2
    + [("conv2", 1, "down", 32, 64)] + [("block2", 1, "k3_same", 64, 64)] * 2
    + [("conv3", 2, "down", 64, 128)] + [("block3", 2, "k3_same", 128, 128)] * 2
    + [("conv4", 3, "down", 128, 256)] + [("block4", 3, "k3_same", 256, 256)] * 2
    + [("conv4_tr", 2, "up", 256, 128)] + [("block4_tr", 2, "k3_same", 128, 128)] * 2
    + [("conv3_tr", 1, "up", 256, 64)] + [("block3_tr", 1, "k3_same", 64, 64)] * 2
    + [("conv2_tr", 0, "up", 128, 64)] + [("block2_tr", 0, "k3_same", 64, 64)] * 2
)
assert len(MAIN_PATH_CONVS) == 20

# The 10 kernel-D maps of one packed-grid pyramid (build_pyramid_grid with
# map_impl="banded", conv1 k5): (name, query level, table level, kernel, mode)
GRID_MAPS = (
    [("k5 L0", 0, 0, 5, "same")]
    + [(f"down L{i}", i, i - 1, 3, "down") for i in (1, 2, 3)]
    + [(f"same L{i}", i, i, 3, "same") for i in (1, 2, 3)]
    + [(f"up L{i}", i, i + 1, 3, "up") for i in (0, 1, 2)]
)
assert len(GRID_MAPS) == 10

CONV_TOL_REL = 1e-4   # same exact bf16 products, f32 sums in another order
NN_D2_ATOL = 1e-4     # f32 d² of O(1) descriptors, sums in another order
NN_D2_REL = 1e-6      # f32 d² of coordinates, of their largest squared norm
GRID_DESC_ATOL = 1e-5  # equal maps and weights; only cuDNN's choice can differ
# bf16 descriptors, card vs CPU: both round each layer's f32 sums to bf16,
# summed in another order, so a rounding can flip (2^-9 relative) over ~25
# layers; the bound tests/test_torch_port_model.py holds bf16 descriptors to
REF_BF16_DESC_ATOL = 1e-2
REF_BF16_MIN_COS = 0.999

# every kernel wrapper's launch counter, kernel A's counts per variant, and
# the launches per pair each path must make
KERNELS = {"sparse_conv_gather_gemm": gather_gemm, "flash_nn": flash_nn,
           "sorted_compact": sorted_compact, "word_match": word_match_many}
A_VARIANTS = {"sparse_conv_gather_gemm.tc": "launches_tc",
              "sparse_conv_gather_gemm.cin1": "launches_cin1",
              "sparse_conv_gather_gemm.scalar": "launches_scalar",
              "sparse_conv_gather_gemm.tcw": "launches_tcw"}
DEFAULT_LAUNCHES = {"sparse_conv_gather_gemm": 20, "flash_nn": 2,
                    "sorted_compact": 0, "word_match": 0,
                    "sparse_conv_gather_gemm.tc": 20,
                    "sparse_conv_gather_gemm.cin1": 0, "sparse_conv_gather_gemm.scalar": 0,
                    "sparse_conv_gather_gemm.tcw": 0}
# the CUDA kernels of csrc/ by name, as the profiler reports them
PORT_CUDA_KERNELS = ("gather_gemm_tc", "gather_gemm_tcw", "gather_gemm_cin1",
                     "gather_gemm_kernel", "nn_transpose_kernel", "nn_transpose_any_kernel", "flash_nn_kernel",
                     "flash_nn3_kernel", "flash_nnk_kernel", "compact_single_pass",
                     "word_match_kernel")
GRID_LAUNCHES = {"sparse_conv_gather_gemm": 20, "flash_nn": 2,
                 "sorted_compact": 1, "word_match": 1,
                 "sparse_conv_gather_gemm.tc": 20,
                 "sparse_conv_gather_gemm.cin1": 0, "sparse_conv_gather_gemm.scalar": 0,
                 "sparse_conv_gather_gemm.tcw": 0}


# one training step: per side 20 tensor-core convs forward and their 20 dX
# calls backward, and conv1 (k 125, cin 1) forward in the cin1 variant (its
# input needs no gradient); one positive search per pair of the batch
TRAIN_LAUNCHES = {"sparse_conv_gather_gemm": 82, "flash_nn": 2,
                  "sorted_compact": 0, "word_match": 0,
                  "sparse_conv_gather_gemm.tc": 80,
                  "sparse_conv_gather_gemm.cin1": 2, "sparse_conv_gather_gemm.scalar": 0,
                  "sparse_conv_gather_gemm.tcw": 0}
# a step of the trainer builds its pyramids as the config says
# (use_grid_maps: the grid pyramid, one grouped kernel-D launch a side), and a
# validation step runs two eval-mode forwards (conv1 as a sparse conv: 21
# kernel-A launches a side), one descriptor search and two pyramids
TRAINER_STEP_LAUNCHES = dict(TRAIN_LAUNCHES, word_match=2)
TRAINER_VAL_LAUNCHES = {"sparse_conv_gather_gemm": 42, "flash_nn": 1,
                        "sorted_compact": 0, "word_match": 2,
                        "sparse_conv_gather_gemm.tc": 40,
                        "sparse_conv_gather_gemm.cin1": 2, "sparse_conv_gather_gemm.scalar": 0,
                        "sparse_conv_gather_gemm.tcw": 0}
# the trainer phase: 3 epochs of 4 batches of 2 pairs, 2 validation pairs an epoch
TRAINER_RUN = dict(synthetic_length=8, max_epoch=3, val_max_iter=2)
LOADER_WORKER = "PairLoader worker"   # the name of a loader's worker process
REPEATED_WARM, REPEATED_STEPS = 2, 6  # the trainer's step on one batch, after the runs
HELD_OUT_SEED = 777_777  # no training sample (seeds 1_000_003 + 7919 i) or validation sample (i)
TRAIN_BATCH = 2          # pairs per training batch
TRAIN_N_PAD = 65536      # voxel capacity of a batch side
# the CPU tests' training config (tests/test_torch_port_train.py)
SMALL_TRAIN = dict(batch_size=2, conv1_kernel_size=3, model_n_out=16,
                   num_pos_per_batch=128, num_hn_samples_per_batch=64,
                   max_points=2048, compute_dtype="float32")
# card vs CPU, one f32 step: the same sums in another order. Kernel A's
# f32 variant sums a row's 27 x cin products one after another, 2.6e-6 of
# the output's scale from the plain product at cin 256 (measured); the batch
# norms of the coarse levels (a few hundred rows, as many channels) pass
# that on to the gradients some 1e4 times larger: with the plain version in
# kernel A's place the card is within 1e-5 of the CPU, with the kernel 3e-2
# at the worst entry of the worst tensor and 1.2e-3 over all gradients.
TRAIN_REF_LOSS_ATOL = 1e-5
TRAIN_REF_GRAD_L2 = 1e-2      # |g - ref| / |ref| over all gradients together
TRAIN_REF_TENSOR_L2 = 1e-1    # the same for each gradient tensor alone
TRAIN_REF_BUFFER_REL = 1e-4   # running statistics, of each tensor's largest entry
# an updated parameter is p - lr (g + wd p): held to lr times the tensor's
# gradient tolerance
SEARCH_D2_ATOL = 2e-6         # f32 d2 of coordinates of a few metres against f64


T_START = time.perf_counter()
DEVICE = {}   # what the device phase read: nvidia-smi's name and power limit


def emit(obj):
    """One JSON line; a phase's line also gives the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def reset_counts():
    for fn in KERNELS.values():
        fn.launches = 0
    for attr in A_VARIANTS.values():
        setattr(gather_gemm, attr, 0)


def read_counts():
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    counts.update({k: getattr(gather_gemm, attr) for k, attr in A_VARIANTS.items()})
    return counts


def cuda_ms(fn, iters, warmup=2):
    """Mean device ms per call of fn over `iters` back-to-back calls."""
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


def capture(fn, iters):
    """A CUDA graph of `iters` calls of fn, warmed up on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_ms(graph):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def graph_ms(fn, iters=20):
    """Mean device ms per call of fn, `iters` calls captured in one CUDA
    graph and replayed: no host time between launches, so kernels of a few
    microseconds are not timed at the host's enqueue rate."""
    return replay_ms(capture(fn, iters)) / iters


def host_ms(fn, iters):
    """Mean wall ms per call, each call ending in a device synchronize."""
    out = None
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters, out


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    DEVICE["nvidia_smi"] = smi
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})


def tc_spills(ptxas):
    """{"bm x bn x bk": [stack, spill stores, spill loads] bytes} of kernel
    A's tensor-core instances, from the compiler's -v report."""
    found = re.findall(
        r"Function properties for \S*gather_gemm_tcILi(\d+)ELi(\d+)ELi(\d+)E\S*\s+"
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
        ptxas)
    return {f"{m}x{n}x{k}": [int(a), int(b), int(c)] for m, n, k, a, b, c in found}


def phase_build():
    t0 = time.perf_counter()
    report = cuda_build.build(["sparse_conv", "flash_nn", "sorted_compact",
                               "word_match"])
    regs = {name: [ln.split("info    : ")[-1] for ln in r["ptxas"].splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, r in report.items()}
    spills = tc_spills(report["sparse_conv"]["ptxas"])
    if report["sparse_conv"]["ptxas"] and len(spills) != len(TC_TILES):
        raise AssertionError(f"build: the report names {sorted(spills)}, "
                             f"not the {len(TC_TILES)} tensor-core instances")
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_source_seconds": {k: round(v["seconds"], 3) for k, v in report.items()},
          "ptxas": regs,
          "kernel_a_tc_stack_spill_stores_loads": spills,
          "kernel_a_tc_spills": sorted(k for k, v in spills.items() if v[1] or v[2])})


def bench_pair(config):
    pair = synthetic_pair(np.random.RandomState(0), n_points=200_000,
                          voxel_size=config.voxel_size, extent=1.5,
                          image_hw=(config.image_H, config.image_W))
    return pair


def conv_inputs(pyr, level, which, cin, cout, gen, backward=False):
    """Forward: features of the level the map gathers from, the conv's map
    and W[27, cin, cout]. Backward, the conv's dX call: dY on the conv's own
    level, the map's inverse (a stride-1 map itself, a down map's sibling up
    map and the reverse) and W[27, cout, cin]."""
    src = {"k3_same": level, "down": level - 1, "up": level + 1}[which]
    if backward:
        inv = {"k3_same": "k3_same", "down": "up", "up": "down"}[which]
        nbr = getattr(pyr.levels[src], inv)
        n_in = pyr.levels[level].coords.shape[0]
        cin, cout = cout, cin
    else:
        nbr = getattr(pyr.levels[level], which)
        n_in = pyr.levels[src].coords.shape[0]
    x = torch.randn((n_in, cin), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((27, cin, cout), generator=gen, device="cuda")
         * (27 * cin) ** -0.5).to(torch.bfloat16)
    return x, nbr, w


def phase_kernel_a(pyr, gen, backward=False):
    """Kernel A vs plain at each distinct conv call of the main path (with
    ``backward`` at each conv's dX call: cin and cout swapped, through the
    inverse map): the plan it takes (the tensor-core variant, asserted), the
    error, dead rows exactly 0 and two calls bit-equal; graph-timed kernel,
    plain and dense_gemm_ms."""
    shapes, seen = [], {}
    for name, level, which, cin, cout in MAIN_PATH_CONVS:
        key = (level, which, cin, cout)
        if key in seen:
            seen[key]["count"] += 1
            continue
        x, nbr, w = conv_inputs(pyr, level, which, cin, cout, gen, backward)
        if backward:
            name, cin, cout = name + " dX", cout, cin
        n_out, n_in = nbr.shape[0], x.shape[0]
        plan = conv_plan(n_out, cin, cout, nbr.shape[1], x.dtype)
        tc_before = gather_gemm.launches_tc
        out = gather_gemm(x, nbr, w)
        again = gather_gemm(x, nbr, w)
        ref = gather_gemm_plain(x, nbr, w)
        torch.cuda.synchronize()
        if plan.variant != "tc" or gather_gemm.launches_tc != tc_before + 2:
            raise AssertionError(f"kernel A at {key} did not take the tensor-core "
                                 f"variant: {plan}")
        err = float((out - ref).abs().max())
        tol = CONV_TOL_REL * max(1.0, float(ref.abs().max()))
        nnz = int((nbr >= 0).sum())
        dead = (nbr < 0).all(dim=1)
        bit_equal = torch.equal(out, again)
        if err > tol or not bool((out[dead] == 0).all()) or not bit_equal:
            raise AssertionError(f"kernel A disagrees at {key}: err {err} > {tol}, "
                                 f"a dead row is not exactly 0, or two calls "
                                 f"differ (bit-equal {bit_equal})")
        # how sparse the work is: live offsets per live row, and the share of
        # (tile, offset) pairs with a live row among the tiles with one
        live = nbr >= 0
        rows_read = int(torch.unique(nbr[live]).numel())
        offsets_read = int(live.any(dim=0).sum())
        tiles = torch.nn.functional.pad(live, (0, 0, 0, -n_out % plan.bm))
        tiles = tiles.reshape(-1, plan.bm, live.shape[1]).any(dim=1)
        tiles = tiles[tiles.any(dim=1)]
        # the dense yardstick: the gathered matrix is built once, outside
        idx = torch.where(nbr >= 0, nbr, n_in).long()
        dense_a = torch.cat([x, x.new_zeros((1, cin))])[idx].reshape(n_out, -1)
        dense_b = w.reshape(-1, cout)
        # bytes (sparse/roofline.py): the map and the output once; of x only
        # the rows the map names (each level's capacity padding is never
        # read), of W only the offsets with a live entry
        ops_ms = 2.0 * nnz * cin * cout / PEAK_BF16_FLOPS * 1e3
        nbytes = conv_traffic_bytes(n_out, n_in, nbr.shape[1], cin, cout, nbr=nbr)
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        entry = {
            "conv": name, "level": level, "map": which, "cin": cin, "cout": cout,
            "n_in": n_in, "n_out": n_out, "nnz": nnz, "x_rows_read": rows_read,
            "offsets_read": offsets_read,
            "live_rows": int((~dead).sum()), "count": 1,
            "offsets_per_live_row": float(live[~dead].sum(dim=1).float().mean()),
            "tile_offsets_live": float(tiles.float().mean()),
            "variant": plan.variant, "tile": [plan.bm, plan.bn], "bk": plan.bk,
            "split": plan.split, "blocks": plan.blocks(n_out, cout),
            "max_abs_err": err, "tol": tol, "bit_equal": bit_equal,
            "ms": graph_ms(lambda: gather_gemm(x, nbr, w)),
            "eager_ms": cuda_ms(lambda: gather_gemm(x, nbr, w), 20),
            "plain_ms": graph_ms(lambda: gather_gemm_plain(x, nbr, w), 5),
            "dense_gemm_ms": graph_ms(lambda: torch.matmul(dense_a, dense_b), 5),
            "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
        }
        del dense_a
        seen[key] = entry
        shapes.append(entry)
    for e in shapes:
        emit({"phase": "train_kernel" if backward else "kernel",
              "kernel": "sparse_conv_gather_gemm", **e})
    total = lambda k: sum(e[k] * e["count"] for e in shapes)  # noqa: E731
    ops_ms = sum(e["ops_ms"] * e["count"] for e in shapes)
    bytes_ms = sum(e["bytes_ms"] * e["count"] for e in shapes)
    slower = [e["conv"] for e in shapes if e["ms"] >= e["plain_ms"]]
    return {
        "name": "sparse_conv_gather_gemm", "route": "cuda",
        "source": "imfnet_tpu_torch/csrc/sparse_conv.cu",
        "replaces": "imfnet_tpu/sparse/pallas_conv.py:318",
        "also_replaces": ["imfnet_tpu/sparse/pallas_conv.py:485",
                          "imfnet_tpu/sparse/pallas_conv.py:595"],
        "unit": ("per side of a training step: the 20 dX calls of one backward"
                 if backward else "per pair: the 20 convs of one forward"),
        "variant": "tc",
        "max_abs_err": max(e["max_abs_err"] for e in shapes),
        "ms": total("ms"), "eager_ms": total("eager_ms"), "plain_ms": total("plain_ms"),
        "dense_gemm_ms": total("dense_gemm_ms"),
        "bytes": total("bytes"), "bound_ms": total("bound_ms"),
        "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
        "library_ms": None,
        "shapes_not_faster_than_plain": slower,
    }


def nn_compare(name, q, r, v, plan=None, same_index=True, tol=NN_D2_ATOL, gap_tol=None,
               plain=None):
    """Kernel B (in ``plan``, else the plan of its shape) against the plain
    version (``plain``, its result if already computed) on one input: d²
    within ``tol``, every choice a valid reference whose exact (f64)
    distance is within ``gap_tol`` (default ``tol``) of the plain choice's,
    two calls bit-equal, and with ``same_index`` equal indices; (0, +inf)
    where no reference is valid."""
    gap_tol = tol if gap_tol is None else gap_tol
    plan = plan or nn_plan(q.shape[0], r.shape[0], q.shape[1])
    i_k, d_k = run_plan(q, r, v, plan)
    i_2, d_2 = run_plan(q, r, v, plan)
    i_p, d_p = plain if plain is not None else nn_plain(q, r, v)
    torch.cuda.synchronize()
    bit_equal = torch.equal(i_k, i_2) and torch.equal(d_k, d_2)
    diff = torch.where(d_k == d_p, torch.zeros_like(d_k), (d_k - d_p).abs())
    err = float(diff.max()) if diff.numel() else 0.0
    mismatched = int((i_k != i_p).sum())
    any_valid = r.shape[0] > 0 and (v is None or bool(v.any()))
    if any_valid:
        q64, r64 = q.double(), r.double()
        exact_k = ((q64 - r64[i_k.long()]) ** 2).sum(1)
        exact_p = ((q64 - r64[i_p.long()]) ** 2).sum(1)
        choice_gap = float((exact_k - exact_p).abs().max())
        chose_valid = v is None or bool(v[i_k.long()].all())
    else:
        choice_gap = 0.0
        chose_valid = bool((i_k == 0).all()) and bool(torch.isinf(d_k).all())
    if not (err <= tol and choice_gap <= gap_tol and chose_valid and bit_equal):
        raise AssertionError(f"kernel B disagrees on {name} ({plan}): d2 err {err}, "
                             f"choice gap {choice_gap}, valid choices {chose_valid}, "
                             f"two calls bit-equal {bit_equal}")
    if same_index and mismatched:
        raise AssertionError(f"kernel B: {mismatched} indices differ on {name} ({plan})")
    return {"max_abs_err": err, "tol": tol, "choice_gap": choice_gap, "gap_tol": gap_tol,
            "index_mismatches": mismatched, "bit_equal": bit_equal}


NN_EDGE_SIZES = (1, 31, 129, 4999, 5003)


def nn_edge_cases(gen):
    """What only the card can show of kernel B: ragged sizes, ties, all or
    the last tile's references invalid, at D = 32 and 3, each against the
    plain version with equal indices."""
    checked = []
    for d in (32, 3):
        for n in NN_EDGE_SIZES:
            for m in NN_EDGE_SIZES:
                q = torch.randn((n, d), generator=gen, device="cuda")
                r = torch.randn((m, d), generator=gen, device="cuda")
                v = torch.rand((m,), generator=gen, device="cuda") > 0.1
                # a null mask where n < m
                nn_compare(f"ragged {n}x{m}x{d}", q, r, None if n < m else v)
        checked.append(f"ragged n, m in {list(NN_EDGE_SIZES)}, d {d}")
        q = torch.randn((5000, d), generator=gen, device="cuda")
        r = torch.randn((5000, d), generator=gen, device="cuda")
        # the first half of the references twice: the kernel must take the
        # first copy, as the plain version on the half alone does
        half = r[:2500].contiguous()
        i_k, _ = flash_nn(q, torch.cat([half, half]), None)
        i_p, _ = nn_plain(q, half, None)
        if not torch.equal(i_k, i_p):
            raise AssertionError(f"kernel B: ties do not go to the lowest index (d {d})")
        none = torch.zeros((5000,), dtype=torch.bool, device="cuda")
        nn_compare(f"all invalid, d {d}", q, r, none)
        head = torch.arange(5000, device="cuda") < 4992   # tile 39 of 128: none valid
        nn_compare(f"last tile invalid, d {d}", q, r, head)
        checked += [f"ties, d {d}", f"all invalid, d {d}", f"last tile invalid, d {d}"]
    return checked


def nn_sweep(q, r, v, phase="kernel", splits=range(1, MAX_SPLIT + 1), iters=20, **tols):
    """Every built tile x split of kernel B at one shape (its width's fold,
    at the given splits): each held to the plain version
    (``nn_compare`` with ``tols``, computed once), graph-timed over
    ``iters`` calls, the plan's choice beside the best."""
    n, m, d = q.shape[0], r.shape[0], q.shape[1]
    plan = nn_plan(n, m, d)
    plain = nn_plain(q, r, v)
    fold = {3: "min", 32: "pair"}.get(d, "chunk")
    tiles = {"min": NN_MIN_TILES, "pair": NN_TILES, "chunk": NN_CHUNK_TILES}[fold]
    instances = [(t, fold) for t in sorted(tiles)]
    rows = []
    for (bq, br, threads), fold in instances:
        for split in splits:
            p = NNPlan(bq, br, threads, split, fold)
            nn_compare(f"sweep {p}", q, r, v, plan=p, same_index=False, plain=plain, **tols)
            rows.append({"fold": fold, "tile": [bq, br], "threads": threads, "split": split,
                         "blocks": p.blocks(n), "ms": graph_ms(lambda: run_plan(q, r, v, p),
                                                               iters)})
    best = min(rows, key=lambda e: e["ms"])
    mine = next((e for e in rows if (*e["tile"], e["threads"], e["split"], e["fold"])
                 == tuple(plan)), None)
    emit({"phase": phase, "kernel": "flash_nn", "sweep": rows, "plan": mine or list(plan),
          "best": best, "n": n, "m": m, "d": d})
    return {"plan_ms": mine["ms"] if mine else None, "best": best}


def clocks_under_load(fn, seconds=1.0):
    """nvidia-smi's SM clock, its maximum and the power drawn while `fn`
    replays back to back for about `seconds`: whether the card holds the
    clock its peak rates assume."""
    graph = capture(fn, 20)
    t0 = time.perf_counter()
    for _ in range(int(seconds * 1e3 / replay_ms(graph)) + 1):   # queued, not waited for
        graph.replay()
    time.sleep(max(0.0, seconds / 2 - (time.perf_counter() - t0)))   # read mid-way
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    torch.cuda.synchronize()
    return smi


def phase_kernel_b(kd0, ok0, kd1, ok1, gen):
    """Kernel B vs plain on the main path's descriptors (both directions),
    and on Gaussian inputs of the same shape, where indices must be equal;
    then the cases of ``nn_edge_cases`` and the sweep of ``nn_sweep``."""
    entries = []
    n, d = kd0.shape
    gq = torch.randn((n, d), generator=gen, device="cuda")
    gr = torch.randn((n, d), generator=gen, device="cuda")
    gv = torch.rand((n,), generator=gen, device="cuda") > 0.1
    cases = [("descriptors 0->1", kd0, kd1, ok1), ("descriptors 1->0", kd1, kd0, ok0),
             ("gaussian d32", gq, gr, gv),
             ("gaussian d3", gq[:, :3].contiguous(), gr[:, :3].contiguous(), gv)]
    for name, q, r, v in cases:
        held = nn_compare(name, q, r, v, same_index=name.startswith("gaussian"))
        m = r.shape[0]
        plan = nn_plan(n, m, q.shape[1])
        ops = 2.0 * n * m * q.shape[1]
        nbytes = (q.numel() + r.numel()) * 4 + m + n * 8
        vmask = ~v

        def library():
            dist = torch.cdist(q, r)
            return dist.masked_fill(vmask[None, :], float("inf")).min(dim=1)

        entry = {"case": name, "n": n, "m": m, "d": q.shape[1], **held,
                 "tile": [plan.bq, plan.br], "threads": plan.threads, "split": plan.split,
                 "blocks": plan.blocks(n), "cuda_kernels_per_call": 2,
                 "ms": graph_ms(lambda: flash_nn(q, r, v)),
                 "eager_ms": cuda_ms(lambda: flash_nn(q, r, v), 20),
                 "plain_ms": cuda_ms(lambda: nn_plain(q, r, v), 5),
                 "library_ms": cuda_ms(library, 5),
                 "bound_ms": max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3,
                 "bound_by": "operations" if ops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES
                 else "bytes"}
        emit({"phase": "kernel", "kernel": "flash_nn", **entry})
        entries.append(entry)
    emit({"phase": "kernel", "kernel": "flash_nn", "checked": nn_edge_cases(gen)})
    nn_sweep(kd0, kd1, ok1)
    emit({"phase": "kernel", "kernel": "flash_nn",
          "sm_clock_max_clock_power_under_load":
              clocks_under_load(lambda: flash_nn(kd0, kd1, ok1))})
    main = entries[:2]
    total = lambda k: sum(e[k] for e in main)  # noqa: E731
    return {
        "name": "flash_nn", "route": "cuda", "source": "imfnet_tpu_torch/csrc/flash_nn.cu",
        "replaces": "imfnet_tpu/match/pallas_nn.py:54",
        "unit": "per pair: both NN directions of register_kp (two CUDA kernels "
                "per launch)",
        "tile": main[0]["tile"], "threads": main[0]["threads"], "split": main[0]["split"],
        "max_abs_err": max(e["max_abs_err"] for e in entries),
        "ms": total("ms"), "eager_ms": total("eager_ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"), "bound_by": main[0]["bound_by"],
        "library_ms": total("library_ms"),
    }


def phase_kernel_c(reg, pair):
    """Kernel C vs plain on the bench pair's sorted raw-point cell keys, as
    quantize_grid(compact_impl="kernel") hands them over. The pair's points
    are already one per voxel, so C is also held to its plain version on
    the keys doubled (every run two long) and with fewer slots than runs."""
    c = reg.config
    pb = reg.prepare(pair.xyz0, pair.xyz1, pair.image0, pair.image1)
    _, key = cell_keys(pb.xyz, pb.valid, c.voxel_size, pb.spec, pb.batch)
    sk, order = torch.sort(key, stable=True)
    n, n_out = sk.shape[0], 2 * N_PAD_MAX
    sk2, order2 = torch.sort(torch.cat([key, key]), stable=True)
    ragged = n - 2 * 2048 - 777      # ends inside a tile
    cases = {"bench": (sk, order, n_out), "doubled keys": (sk2, order2, n_out),
             "doubled keys, overflow": (sk2, order2, n_out // 4),
             "ragged n": (sk[:ragged].contiguous(), order[:ragged].contiguous(), n_out)}
    errs = []
    refs = {}
    for name, (k_, o_, m_) in cases.items():
        refs[name] = ref_sel, ref_count = sorted_compact_plain(k_, o_, m_)
        # two eager calls in a row: the kernel's state is not reset between
        for _ in range(2):
            sel, count = sorted_compact(k_, o_, m_)
            torch.cuda.synchronize()
            if not (torch.equal(sel, ref_sel) and torch.equal(count, ref_count)):
                raise AssertionError(f"kernel C disagrees with its plain version: {name}")
        errs.append(float((sel - ref_sel).abs().max()))
    # 100 replays of one captured call, whose arguments are frozen
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_sel, g_count = sorted_compact(sk, order, n_out)
    for i in range(100):
        g_sel.fill_(-7)
        g_count.fill_(-7)
        graph.replay()
        if not (torch.equal(g_sel, refs["bench"][0]) and torch.equal(g_count, refs["bench"][1])):
            raise AssertionError(f"kernel C: replay {i} of a captured call disagrees "
                                 f"with the plain version")
    cases["bench, 100 graph replays"] = None
    sel, count = sorted_compact(sk, order, n_out)
    err, runs = max(errs), int(count)
    # sk read once, order read at the run starts only, sel and count written
    nbytes = n * 8 + runs * 8 + n_out * 8 + 4
    entry = {"rows": n, "n_out": n_out, "runs": runs, "max_abs_err": err,
             "checked": list(cases),
             "tol": 0, "ms": graph_ms(lambda: sorted_compact(sk, order, n_out)),
             "eager_ms": cuda_ms(lambda: sorted_compact(sk, order, n_out), 20),
             "plain_ms": graph_ms(lambda: sorted_compact_plain(sk, order, n_out)),
             "launch_floor_ms": graph_ms(empty_launch),
             "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
             "cuda_kernels_per_call": 1}
    emit({"phase": "kernel", "kernel": "sorted_compact", **entry})
    return {
        "name": "sorted_compact", "route": "cuda",
        "source": "imfnet_tpu_torch/csrc/sorted_compact.cu",
        "replaces": "imfnet_tpu/sparse/pallas_quant.py:122",
        "unit": "per pair: one quantize (one CUDA kernel per launch)",
        "max_abs_err": err, "ms": entry["ms"], "plain_ms": entry["plain_ms"],
        "launch_floor_ms": entry["launch_floor_ms"],
        "bound_ms": entry["bound_ms"], "bound_by": "bytes",
        # no single PyTorch call compacts the run starts of a sorted stream
        # to their rows without a host read (unique_consecutive syncs for
        # its output size and returns no rows)
        "library_ms": None,
    }


def phase_kernel_d(reg, q):
    """Kernel D vs plain at each of the 10 banded maps of the bench pair's
    packed-grid pyramid, on the word tables and queries that
    build_pyramid_grid hands it: each map alone (one problem a launch), and
    all ten in one grouped launch, as the path makes it; the kernel's time
    per pair is the grouped launch's."""
    c = reg.config
    caps = level_capacities(q.sv.n_padded, tuple(c.level_capacity_divisors))
    origins, tables = level_tables(q.sv.coords, q.sv.num_valid, q.spec, caps)
    valid = [row_mask(t.shape[0], n) for t, n in tables]
    wtabs = [compact_words(t, v, origins, q.spec, lvl)
             for lvl, ((t, _), v) in enumerate(zip(tables, valid))]
    launch_floor_ms = graph_ms(empty_launch)
    entries, problems, refs = [], [], []
    for name, lvl, tl, k, mode in GRID_MAPS:
        qk, _ = word_queries(origins, tables[lvl][0], valid[lvl], q.spec,
                             table_level=tl, kernel_size=k, mode=mode)
        wt = wtabs[tl]
        keys, payload = wt.wkeys, wt.payload
        problem = (keys, payload, wt.n_words, qk)
        out = word_match_many([problem])[0]
        ref = word_match_plain(keys, payload, qk)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"kernel D disagrees with its plain version at {name}")
        problems.append(problem)
        refs.append(ref)
        m = keys.shape[0]
        flat = qk.reshape(-1)

        def library():
            return payload[torch.searchsorted(keys, flat).clamp_max(m - 1)]

        # queries read and 16 bytes a query written once; of the table, the
        # entries in use (key and payload), not its WORD_PAD tail
        used = int(wt.n_words)
        nbytes = qk.numel() * 4 + used * (4 + 16) + qk.numel() * 16
        entry = {"map": name, "rows": qk.shape[0], "columns": qk.shape[1],
                 "table": m, "table_used": used,
                 "max_abs_err": float((out - ref).abs().max()), "tol": 0,
                 "ms": graph_ms(lambda: word_match_many([problem])),
                 "eager_ms": cuda_ms(lambda: word_match_many([problem]), 20),
                 "plain_ms": graph_ms(lambda: word_match_plain(keys, payload, qk)),
                 "library_ms": graph_ms(library),
                 "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes"}
        emit({"phase": "kernel", "kernel": "word_match", **entry})
        entries.append(entry)
    before = word_match_many.launches
    outs = word_match_many(problems)
    torch.cuda.synchronize()
    if word_match_many.launches != before + 1:
        raise AssertionError("kernel D: the grouped call is not one launch")
    for (name, *_), out, ref in zip(GRID_MAPS, outs, refs):
        if not torch.equal(out, ref):
            raise AssertionError(f"kernel D's grouped launch disagrees with the "
                                 f"plain version at {name}")
    # where the level-0 k5 map's time goes: the same queries with no table
    # entry in use (the stream alone: queries in, zeros out), and one key for
    # every query (every search and load hits the same lines)
    keys, payload, n_words, qk = problems[0]
    none_used = torch.zeros_like(n_words)
    one_key = torch.full_like(qk, int(keys[int(n_words) // 2]))
    emit({"phase": "kernel", "kernel": "word_match", "map": GRID_MAPS[0][0],
          "stream_only_ms": graph_ms(lambda: word_match_many([(keys, payload, none_used, qk)])),
          "one_key_ms": graph_ms(lambda: word_match_many([(keys, payload, n_words, one_key)])),
          "ms": entries[0]["ms"], "bound_ms": entries[0]["bound_ms"]})
    total = lambda k: sum(e[k] for e in entries)  # noqa: E731
    grouped = {"maps": len(problems), "launches": 1, "max_abs_err": 0.0, "tol": 0,
               "ms": graph_ms(lambda: word_match_many(problems)),
               "eager_ms": cuda_ms(lambda: word_match_many(problems), 20),
               "per_map_ms_sum": total("ms"), "launch_floor_ms": launch_floor_ms,
               "bound_ms": total("bound_ms"), "bound_by": "bytes"}
    emit({"phase": "kernel", "kernel": "word_match", "grouped": grouped})
    return {
        "name": "word_match", "route": "cuda",
        "source": "imfnet_tpu_torch/csrc/word_match.cu",
        "replaces": "imfnet_tpu/sparse/pallas_word_map.py:122",
        "unit": "per pair: the 10 banded maps of one grid pyramid in one "
                "grouped launch",
        "max_abs_err": max(e["max_abs_err"] for e in entries),
        "ms": grouped["ms"], "eager_ms": grouped["eager_ms"],
        "per_map_ms_sum": total("ms"), "launch_floor_ms": launch_floor_ms,
        "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": "bytes",
        # yardstick only: searchsorted + one gather reads the first matching
        # entry and does not add the companion
        "library_ms": total("library_ms"),
    }


def pyramid_tables(pyr):
    out = {"k5_l0": pyr.k5_l0}
    for i, lv in enumerate(pyr.levels):
        out[f"L{i}.num_valid"] = lv.num_valid
        for name in ("coords", "k3_same", "down", "up"):
            if getattr(lv, name) is not None:
                out[f"L{i}.{name}"] = getattr(lv, name)
    return out


def compare_paths(ref, got):
    """The grid path's (q, pyr, feats) against the default path's on the
    same pair: integer tables bit for bit, descriptors within 1e-5."""
    (qd, pd, fd), (qg, pg, fg) = ref, got
    same = {"coords": torch.equal(qg.sv.coords, qd.sv.coords),
            "num_valid": torch.equal(qg.sv.num_valid, qd.sv.num_valid),
            "xyz_down": torch.equal(qg.xyz_down, qd.xyz_down)}
    td, tg = pyramid_tables(pd), pyramid_tables(pg)
    same["map_keys"] = td.keys() == tg.keys()
    for k in td:
        same[k] = k in tg and torch.equal(td[k], tg[k])
    desc_err = float((fg - fd).abs().max())
    if not all(same.values()) or desc_err > GRID_DESC_ATOL:
        raise AssertionError(f"grid path differs from the default path: "
                             f"{[k for k, v in same.items() if not v]}, "
                             f"descriptor err {desc_err}")
    return {"tables_equal": sorted(same), "descriptor_max_abs_err": desc_err,
            "descriptor_tol": GRID_DESC_ATOL}


def check_outputs(q, feats, out):
    n = int(q.sv.num_valid)
    if not bool(torch.isfinite(feats).all()):
        raise AssertionError("descriptors are not finite")
    norms = feats[:n].norm(dim=1)
    if not bool(((norms - 1).abs() < 1e-3).all()) or bool(feats[n:].any()):
        raise AssertionError("descriptors are not unit rows with zero padding")
    T = out["transformation"]
    R = T[:3, :3].double()
    if T.shape != (4, 4) or not bool(torch.isfinite(T).all()) or \
            float((R @ R.T - torch.eye(3, device=R.device, dtype=R.dtype)).abs().max()) > 1e-3:
        raise AssertionError(f"transformation is not rigid: {T}")
    for k, v in out.items():
        if not bool(torch.isfinite(v.float()).all()):
            raise AssertionError(f"metric {k} is not finite")


def phase_pipeline(reg, pair, phase="pipeline", per_pair=DEFAULT_LAUNCHES,
                   reference=None, n_warm=3, n_pairs=30):
    """Timed pairs through ``reg``; every kernel's launches are counted from
    0 over the timed run and must be ``per_pair`` times the pairs. With
    ``reference`` (the default path's q, pyramid, descriptors) the path's
    own must equal it."""
    cfg = reg.config
    args = (pair.xyz0, pair.xyz1, pair.image0, pair.image1, pair.T_gt, np.eye(6))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(n_warm):
        reg(*args, generator=gen)
    torch.cuda.synchronize()

    reset_counts()
    lat = []
    t0 = time.perf_counter()
    for _ in range(n_pairs):
        t = time.perf_counter()
        out = reg(*args, generator=gen)
        float(out["rte"])                # the pair's result reaches the host
        lat.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    if launches != {k: v * n_pairs for k, v in per_pair.items()}:
        raise AssertionError(f"{phase}: kernel launches {launches} over {n_pairs} "
                             f"pairs; want {per_pair} per pair")
    # median, and the highest percentile with at least ten samples above it
    q_hi = (n_pairs - 10) / n_pairs
    latency = {"median_ms": float(np.median(lat)),
               f"p{round(100 * q_hi)}_ms": float(np.quantile(lat, q_hi)),
               "min_ms": min(lat), "max_ms": max(lat), "samples": n_pairs}

    # stage split, each stage ending in a synchronize
    stages = {}
    stages["prepare_ms"], pb = host_ms(lambda: reg.prepare(*args[:4]), 5)
    stages["quantize_ms"], q = host_ms(lambda: reg.quantize(pb), 5)
    stages["pyramid_ms"], pyr = host_ms(lambda: reg.pyramid(q), 5)
    stages["forward_ms"], feats = host_ms(lambda: reg.forward(q, pyr, pb.images), 5)
    stages["match_ms"], out = host_ms(
        lambda: reg.match(q, feats, pair.T_gt, np.eye(6), generator=gen), 5)
    check_outputs(q, feats, out)
    same = {} if reference is None else compare_paths(reference, (q, pyr, feats))
    n0 = int(q.n0)
    emit({"phase": phase, "compact_impl": reg.compact_impl, "map_impl": reg.map_impl,
          "pairs": n_pairs, "seconds": seconds,
          "pairs_per_s": n_pairs / seconds, "latency": latency, "stages": stages,
          "launches": launches,
          "launches_per_pair": {k: v / n_pairs for k, v in launches.items()},
          "raw_points": [len(pair.xyz0), len(pair.xyz1)],
          "voxels_per_fragment": [n0, int(q.sv.num_valid) - n0],
          "n_pad": q.sv.n_padded,
          "levels": [{"num_valid": int(lv.num_valid), "capacity": lv.coords.shape[0]}
                     for lv in pyr.levels],
          "coarse_levels_fit": bool(coarse_levels_fit(pyr)),
          "keypoints": cfg.num_rand_keypoints, "hypotheses": cfg.ransac_max_iteration,
          "metrics": {k: float(v) for k, v in out.items() if v.numel() == 1},
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          **same})
    return launches, seconds / n_pairs, q, pyr, feats, stages


def phase_reference(path="default", compute_dtype="float32", **impls):
    """The chain on a small pair, card vs CPU, same weights and draws. f32
    (kernel A's scalar variant on the card, asserted): equal tables,
    descriptors within 1e-4, transforms within 1e-3. bf16, the main path's
    dtype (all 20 kernel-A launches of the card's forward take the
    tensor-core variant, asserted): equal tables, and descriptors within
    REF_BF16_DESC_ATOL with every live row's cosine above REF_BF16_MIN_COS;
    the match is only reported, since the nearest neighbours of descriptors
    that differ by bf16 roundings may differ."""
    cfg = bench_config().replace(compute_dtype=compute_dtype, num_rand_keypoints=400,
                                 ransac_max_iteration=12500,
                                 level_capacity_divisors=(1, 2, 4, 8))
    pair = synthetic_pair(np.random.RandomState(2), n_points=6000, image_hw=(24, 32))
    want = {"float32": [0, 0, 20], "bfloat16": [20, 0, 0]}[compute_dtype]
    outs = []
    for device in ("cuda", "cpu"):
        reg = PairRegistrar(cfg, device=device, seed=1, **impls)
        pb = reg.prepare(pair.xyz0, pair.xyz1, pair.image0, pair.image1)
        q = reg.quantize(pb)
        pyr = reg.pyramid(q)
        before = [gather_gemm.launches_tc, gather_gemm.launches_cin1,
                  gather_gemm.launches_scalar]
        feats = reg.forward(q, pyr, pb.images)
        if device == "cuda":
            variants = [gather_gemm.launches_tc - before[0],
                        gather_gemm.launches_cin1 - before[1],
                        gather_gemm.launches_scalar - before[2]]
        n = q.sv.n_padded
        rs = np.random.RandomState(4)
        u = tuple(torch.from_numpy(rs.rand(n).astype(np.float32)).to(device)
                  for _ in range(2))
        n_valid = min(cfg.num_rand_keypoints, int(q.n0))
        samples = torch.from_numpy(rs.randint(0, max(n_valid, 1), (1, 12500, 3))).to(device)
        out = reg.match(q, feats, pair.T_gt, np.eye(6), keypoint_u=u, samples=samples)
        outs.append((q, pyr, feats, out))
    (qg, pg, fg, og), (qc, pc, fc, oc) = outs
    if not torch.equal(qg.sv.coords.cpu(), qc.sv.coords):
        raise AssertionError(f"reference {path}: voxel tables differ")
    tg, tc = pyramid_tables(pg), pyramid_tables(pc)
    if tg.keys() != tc.keys() or not all(torch.equal(tg[k].cpu(), tc[k]) for k in tc):
        raise AssertionError(f"reference {path}: pyramid tables differ")
    f_err = float((fg.cpu() - fc).abs().max())
    n_live = int(qc.sv.num_valid)
    min_cos = float((fg.cpu()[:n_live] * fc[:n_live]).sum(dim=1).min())
    t_err = float((og["transformation"].cpu() - oc["transformation"]).abs().max())
    same_accept = bool(og["accepted"]) == bool(oc["accepted"])
    bf16 = compute_dtype == "bfloat16"
    f_tol = REF_BF16_DESC_ATOL if bf16 else 1e-4
    emit({"phase": "reference", "path": path, "compute_dtype": compute_dtype, **impls,
          "voxels": int(qg.sv.num_valid),
          "kernel_a_launches_tc_cin1_scalar": variants,
          "descriptor_max_abs_err": f_err, "descriptor_tol": f_tol,
          "descriptor_min_cos": min_cos,
          "transform_max_abs_err": t_err, "transform_tol": None if bf16 else 1e-3,
          "accepted": [bool(og["accepted"]), bool(oc["accepted"])]})
    if variants != want:
        raise AssertionError(f"reference {path} {compute_dtype}: kernel A took "
                             f"{variants} tensor-core/cin1/scalar launches, want {want}")
    if f_err > f_tol or (bf16 and min_cos < REF_BF16_MIN_COS) or (
            not bf16 and (t_err > 1e-3 or not same_accept)):
        raise AssertionError(f"reference {path} {compute_dtype}: card and CPU disagree")


def phase_paths(regs, pair, rounds=10):
    """Pair latency of the default and the packed-grid path, each replayed
    as CUDA graphs (the default) and eager, interleaved (the order of
    ``regs`` and back again per round) so that all see the same host."""
    args = (pair.xyz0, pair.xyz1, pair.image0, pair.image1, pair.T_gt, np.eye(6))
    gen = torch.Generator(device="cuda").manual_seed(2)
    lat = {name: [] for name in regs}
    order = list(regs) + list(regs)[::-1]
    for _ in range(rounds):
        for name in order:
            t = time.perf_counter()
            float(regs[name](*args, generator=gen)["rte"])
            lat[name].append((time.perf_counter() - t) * 1e3)
    emit({"phase": "paths", "order": ", ".join(order), "rounds": rounds,
          **{f"{k}_median_ms": float(np.median(v)) for k, v in lat.items()},
          **{f"{k}_ms": v for k, v in lat.items()}, "nvidia_smi": DEVICE["nvidia_smi"]})
    return lat


GRAPH_BLOCK = 10      # calls a block of the both-ways timings: eager, graphed, graphed, eager
GRAPH_CALLS = 3       # calls compared both ways: a warm-up, the capture, a replay


def both_ways(runs, block=GRAPH_BLOCK):
    """Wall ms of each call of ``runs["eager"]`` and ``runs["graphed"]``
    (each call ending in a synchronize), in blocks of ``block`` calls in the
    order eager, graphed, graphed, eager: {"eager": {...}, "graphed": {...}}
    with calls/s over the blocks, the median, and the median host ms until
    the call returned (before the synchronize: the host's own time where it
    returns before the card has finished)."""
    lat = {"eager": [], "graphed": []}
    host = {"eager": [], "graphed": []}
    for name in ("eager", "graphed", "graphed", "eager"):
        for _ in range(block):
            t = time.perf_counter()
            runs[name]()
            host[name].append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            lat[name].append((time.perf_counter() - t) * 1e3)
    return {k: {"per_s": len(v) / (sum(v) / 1e3), "median_ms": float(np.median(v)),
                "min_ms": min(v), "max_ms": max(v), "calls": len(v),
                "host_ms_median": float(np.median(host[k]))} for k, v in lat.items()}


def tensors_gap(got, want):
    """(bit-equal, largest |got - want| over the largest |want|) of two
    dicts of tensors with the same keys."""
    if got.keys() != want.keys():
        raise AssertionError(f"graphs: outputs {sorted(got)} against {sorted(want)}")
    equal, worst = True, 0.0
    for k, w in want.items():
        g = got[k]
        if torch.equal(g, w):
            continue
        equal = False
        scale = max(float(w.double().abs().max()), 1e-12)
        worst = max(worst, float((g.double() - w.double()).abs().max()) / scale)
    return equal, worst


def phase_graphs_pair(reg, reg_eager, pair):
    """The pair's post-quantize chain replayed as one CUDA graph per bucket
    (``PairRegistrar()``) against the same registrar run eagerly
    (``graphed=False``), same weights and draws: every output bit for bit
    over GRAPH_CALLS pairs (warm-up, capture, replay), and the keypoints'
    NN indices both ways and RANSAC's inlier mask from one graph of
    nn_auto ×2 + ransac_registration against the same calls eagerly; the
    launches one replay counts; pairs/s both ways, interleaved. The pose
    gap, if any, is held to the reference phase's 1e-3."""
    args = (pair.xyz0, pair.xyz1, pair.image0, pair.image1, pair.T_gt, np.eye(6))
    outs_equal, outs_gap = True, 0.0
    for i in range(GRAPH_CALLS):
        got = reg(*args, generator=torch.Generator(device="cuda").manual_seed(100 + i))
        want = reg_eager(*args, generator=torch.Generator(device="cuda").manual_seed(100 + i))
        eq, gap = tensors_gap(got, want)
        outs_equal, outs_gap = outs_equal and eq, max(outs_gap, gap)
    t_gap = float((got["transformation"] - want["transformation"]).abs().max())

    # the match's NN indices and inlier mask, graphed and eager
    cfg = reg.config
    pb = reg.prepare(*args[:4])
    q = reg.quantize(pb)
    feats = reg.forward(q, reg.pyramid(q), pb.images)
    gen = torch.Generator(device="cuda").manual_seed(7)
    k, n_rows = cfg.num_rand_keypoints, q.xyz_down.shape[0]
    i0, ok0 = sample_keypoints_segment(0, q.n0, k, n_rows, device="cuda", generator=gen)
    i1, ok1 = sample_keypoints_segment(q.n0, q.sv.num_valid - q.n0, k, n_rows,
                                       device="cuda", generator=gen)
    kp0, kd0, kp1, kd1 = q.xyz_down[i0], feats[i0], q.xyz_down[i1], feats[i1]

    def match(kp0, kd0, ok0, kp1, kd1, ok1, samples):
        nn01 = nn_auto(kd0, kd1, ok1)[0]
        nn10 = nn_auto(kd1, kd0, ok0)[0]
        res = ransac_registration(kp0, kp1[nn01.long()], ok0, cfg.voxel_size * 1.5,
                                  ransac_n=cfg.ransac_n, hypo_block=HYPO_BLOCK,
                                  num_hypotheses=cfg.ransac_max_iteration, samples=samples)
        return {"nn01": nn01, "nn10": nn10, "inliers": res.inlier_mask,
                "transformation": res.transformation}

    graphed = jit(match)
    match_equal = True
    shape = sample_shape(cfg.ransac_max_iteration, HYPO_BLOCK, cfg.ransac_n)
    for i in range(GRAPH_CALLS):
        u = torch.rand(shape, generator=gen, device="cuda")
        want = match(kp0, kd0, ok0, kp1, kd1, ok1, u)
        got = graphed(kp0, kd0, ok0, kp1, kd1, ok1, u)
        match_equal = match_equal and tensors_gap(dict(got), want)[0]

    gen = torch.Generator(device="cuda").manual_seed(3)
    reset_counts()
    float(reg(*args, generator=gen)["rte"])
    per_replay = read_counts()
    timed = both_ways({name: (lambda r=r: float(r(*args, generator=gen)["rte"]))
                       for name, r in (("eager", reg_eager), ("graphed", reg))})
    entry = {"phase": "graphs_pair", "calls_compared": GRAPH_CALLS,
             "outputs_bit_equal": outs_equal, "outputs_max_rel_err": outs_gap,
             "transform_max_abs_err": t_gap, "transform_tol": 1e-3,
             "nn_indices_and_inlier_mask_bit_equal": match_equal,
             "captures": reg.graphed.captures, "replays": reg.graphed.replays,
             "launches_per_replay": per_replay, "pairs": timed,
             "order": "eager, graphed, graphed, eager", "block": GRAPH_BLOCK,
             "nvidia_smi": DEVICE["nvidia_smi"]}
    emit(entry)
    if per_replay != DEFAULT_LAUNCHES:
        raise AssertionError(f"graphs_pair: a replay launched {per_replay}, an eager pair "
                             f"{DEFAULT_LAUNCHES}")
    if not match_equal or t_gap > 1e-3:
        raise AssertionError(f"graphs_pair: the graph differs from the eager calls: NN and "
                             f"inliers equal {match_equal}, pose gap {t_gap}")
    return entry


def phase_profile(reg, pair, wall_ms_per_pair, phase="profile", n_pairs=3):
    """Device time by kernel over a few pairs (torch.profiler, CUPTI). The
    idle share compares the device-busy time per pair with the unprofiled
    wall time per pair of the pipeline phase."""
    args = (pair.xyz0, pair.xyz1, pair.image0, pair.image1, pair.T_gt, np.eye(6))
    gen = torch.Generator(device="cuda").manual_seed(1)
    return profile_units(lambda: reg(*args, generator=gen), wall_ms_per_pair, phase,
                         "pair", n_pairs)


def profile_units(run, wall_ms_per_pair, phase, unit, n_pairs):
    """``run`` called ``n_pairs`` times under the profiler; every number is
    per call (a pair, or a training step: ``unit``). Returns the port's own
    kernels' [ms, launches] per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity alone: every number below reads the device's kernels,
    # and a trace of the host's operators too costs seconds to sort
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_pairs):
            run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("profile: the trace holds no device kernels")
    # what the host issued: the runtime's launch and copy calls per call
    api = {e.key: e.count / n_pairs for e in events if e.device_type != DeviceType.CUDA
           and e.key.startswith("cu") and ("Launch" in e.key or "Memcpy" in e.key)}
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / n_pairs
    top = sorted(kernels, key=lambda e: e.device_time_total, reverse=True)[:15]
    # the port's own CUDA kernels in place on the path: [ms, launches] per pair
    own = {name: [sum(e.device_time_total for e in kernels if name in e.key) / 1e3 / n_pairs,
                  sum(e.count for e in kernels if name in e.key) / n_pairs]
           for name in PORT_CUDA_KERNELS}
    emit({"phase": phase, f"{unit}s": n_pairs,
          f"device_busy_ms_per_{unit}": busy_ms,
          f"wall_ms_per_{unit}_unprofiled": wall_ms_per_pair,
          "device_idle_share": 1 - busy_ms / wall_ms_per_pair,
          f"kernel_launches_per_{unit}": sum(e.count for e in kernels) / n_pairs,
          f"host_api_calls_per_{unit}": api,
          f"port_kernels_ms_and_launches_per_{unit}": own,
          f"top_kernels_ms_per_{unit}": [
              [e.key[:90], e.device_time_total / 1e3 / n_pairs, e.count / n_pairs]
              for e in top]})
    return own


def train_model(cfg, device, seed=0):
    """The config's model with seeded random weights in the training
    configuration: conv1 as a sparse conv (no occupancy shortcut)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = load_model(cfg.model)(
            in_channels=cfg.in_channels, out_channels=cfg.model_n_out,
            conv1_kernel_size=cfg.conv1_kernel_size,
            normalize_feature=cfg.normalize_feature, bn_momentum=cfg.bn_momentum,
            compute_dtype=getattr(torch, cfg.compute_dtype))
    return model.to(device)


def phase_train_kernels(cfg, batch, gen):
    """The kernels at the training step's shapes, on side 0 of the batch:
    kernel A's 20 dX calls and conv1's cin1 call (beside the scalar variant
    that took it before),
    kernel B's positive search (with the sweep of its tiles), and the
    plain dW products of a step."""
    with torch.no_grad():
        pyr = make_pyramid_fn(cfg, TRAIN_N_PAD, TRAIN_BATCH)(batch.coords0, batch.n0)
    back = phase_kernel_a(pyr, gen, backward=True)

    # conv1: k = 5^3 offsets, one input channel, so the cin1 variant
    n = TRAIN_N_PAD
    x = batch.feats0.to(torch.bfloat16)
    w = (torch.randn((125, 1, 32), generator=gen, device="cuda") * 125 ** -0.5).to(torch.bfloat16)
    nbr = pyr.k5_l0
    plan = conv_plan(n, 1, 32, 125, x.dtype)
    before = (gather_gemm.launches_cin1, gather_gemm.launches_scalar)
    out, again, ref = gather_gemm(x, nbr, w), gather_gemm(x, nbr, w), gather_gemm_plain(x, nbr, w)
    torch.cuda.synchronize()
    launched = (gather_gemm.launches_cin1 - before[0], gather_gemm.launches_scalar - before[1])
    err, tol = float((out - ref).abs().max()), CONV_TOL_REL * max(1.0, float(ref.abs().max()))
    dead = (nbr < 0).all(dim=1)
    if (plan.variant != "cin1" or launched != (2, 0) or err > tol or not torch.equal(out, again)
            or not bool((out[dead] == 0).all())):
        raise AssertionError(f"kernel A at conv1: plan {plan}, launches cin1/scalar "
                             f"{launched}, err {err} > {tol}, two calls differ, or a dead "
                             f"row is not exactly 0")
    nnz = int((nbr >= 0).sum())
    scalar = ConvPlan("scalar", *SCALAR_TILE, 1)
    conv1 = {"conv": "conv1", "cin": 1, "cout": 32, "k_vol": 125, "n_out": n, "nnz": nnz,
             "variant": plan.variant, "bm": plan.bm, "max_abs_err": err, "tol": tol,
             "bit_equal": True, "dead_rows": int(dead.sum()),
             "ms": graph_ms(lambda: gather_gemm(x, nbr, w), 10),
             "scalar_variant_ms": graph_ms(lambda: conv_run_plan(x, nbr, w, scalar), 5),
             "plain_ms": graph_ms(lambda: gather_gemm_plain(x, nbr, w), 3),
             "library_ms": None,
             "bound_ms": (nbr.numel() * 4 + n * 2 + n * 32 * 4) / PEAK_BYTES * 1e3,
             "bound_by": "bytes"}
    conv1["x_bound"] = conv1["ms"] / conv1["bound_ms"]
    emit({"phase": "train_kernel", "kernel": "sparse_conv_gather_gemm", **conv1})

    # kernel B as compute_correspondences calls it: side 0's voxels against
    # side 1's, the other pair's references masked out. Voxel centres on a
    # 2.5 cm lattice: many near-ties, so the choice is held by its exact
    # distance, not by its index
    valid = row_mask(n, batch.n1) & (batch.coords1[:, 0] == 0)
    search = kernel_b_entry("positive search, one pair of the batch", batch.xyz0.contiguous(),
                            batch.xyz1.contiguous(), valid, "train_kernel", sweep=True)

    # dW has no kernel: a plain gather and product per conv (sparse/ops.py)
    dw_ms = 0.0
    for name, level, which, cin, cout in MAIN_PATH_CONVS:
        x, nbr, _ = conv_inputs(pyr, level, which, cin, cout, gen)
        dy = torch.randn((nbr.shape[0], cout), generator=gen, device="cuda").to(torch.bfloat16)
        dw_ms += cuda_ms(lambda: weight_grad(x, nbr, dy), 2, warmup=1)
    dy = torch.randn((n, 32), generator=gen, device="cuda").to(torch.bfloat16)
    dw_ms += cuda_ms(lambda: weight_grad(batch.feats0.to(torch.bfloat16), pyr.k5_l0, dy), 2,
                     warmup=1)
    emit({"phase": "train_kernel", "plain": "weight_grad (dW, no kernel)",
          "products_per_step": 42, "ms_per_side": dw_ms, "ms_per_step": 2 * dw_ms})
    return {"backward": back, "conv1": conv1, "search": search, "dw_ms_per_step": 2 * dw_ms,
            "word_match": train_kernel_d(cfg, batch)}


def train_kernel_d(cfg, batch):
    """Kernel D as the trainer's step calls it: the ten banded maps of the
    grid pyramid of one side of the training batch (2 pairs, the config's
    extent) in one grouped launch, every map exactly equal to its plain
    version; timed as a CUDA-graph replay."""
    spec = GridSpec(extent=tuple(cfg.grid_extent), num_batches=TRAIN_BATCH)
    caps = level_capacities(TRAIN_N_PAD, tuple(cfg.level_capacity_divisors))
    origins, tables = level_tables(batch.coords0, batch.n0, spec, caps)
    valid = [row_mask(t.shape[0], n) for t, n in tables]
    wtabs = [compact_words(t, v, origins, spec, lvl)
             for lvl, ((t, _), v) in enumerate(zip(tables, valid))]
    problems, nbytes = [], 0
    for name, lvl, tl, k, mode in GRID_MAPS:
        qk, _ = word_queries(origins, tables[lvl][0], valid[lvl], spec,
                             table_level=tl, kernel_size=k, mode=mode)
        problems.append((wtabs[tl].wkeys, wtabs[tl].payload, wtabs[tl].n_words, qk))
        nbytes += qk.numel() * 4 + int(wtabs[tl].n_words) * (4 + 16) + qk.numel() * 16
    before = word_match_many.launches
    outs = word_match_many(problems)
    torch.cuda.synchronize()
    if word_match_many.launches != before + 1:
        raise AssertionError("kernel D at the training shape: not one launch")
    plain_ms = 0.0
    for (name, *_), (keys, payload, _, qk), out in zip(GRID_MAPS, problems, outs):
        if not torch.equal(out, word_match_plain(keys, payload, qk)):
            raise AssertionError(f"kernel D disagrees with its plain version at the "
                                 f"training batch's {name}")
        plain_ms += graph_ms(lambda: word_match_plain(keys, payload, qk), 3)
    entry = {"case": "grid pyramid of one side of the training batch", "maps": len(problems),
             "rows_l0": TRAIN_N_PAD, "num_batches": TRAIN_BATCH, "max_abs_err": 0.0, "tol": 0,
             "ms": graph_ms(lambda: word_match_many(problems)),
             "plain_ms": plain_ms, "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes"}
    emit({"phase": "train_kernel", "kernel": "word_match", **entry})
    return entry


def phase_train_reference():
    """One training step at a small size in f32, on the card against the
    CPU, from the same weights, batch and draws: the loss, every gradient
    and every updated parameter and buffer. Then 8 steps at lr 0.03 on the
    card on that batch, which must end below the first loss."""
    cfg = threedmatch_config(**SMALL_TRAIN)
    n_pad = cfg.max_points
    rs = np.random.RandomState(3)
    draws = [torch.from_numpy(rs.rand(n_pad).astype(np.float32)) for _ in range(3)]
    runs = {}
    for device in ("cuda", "cpu"):
        model = train_model(cfg, device, seed=1)
        batch = synthetic_batch(np.random.RandomState(0), batch_size=2, n_points=700,
                                n_pad=n_pad, image_hw=(24, 32), device=device)
        state = create_train_state(model, cfg, steps_per_epoch=100)
        grads = {}
        hooks = [p.register_hook(lambda g, k=k: grads.__setitem__(k, g.detach().cpu()))
                 for k, p in model.named_parameters()]
        before = read_counts()
        state, metrics = make_train_step(cfg, map_impl="search")(
            state, batch, draws=[d.to(device) for d in draws])
        if device == "cuda":
            after = read_counts()
            launched = {k: after[k] - before[k] for k in after}
        for h in hooks:
            h.remove()
        runs[device] = (float(metrics["loss"]), grads,
                        {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (loss_g, grads_g, sd_g), (loss_c, grads_c, sd_c) = runs["cuda"], runs["cpu"]
    # f32: every kernel-A launch at cin > 1 takes the scalar variant, conv1
    # (cin 1) the cin1 one; conv1's input has no gradient, so 21 forward + 20
    # dX a side
    want = {"sparse_conv_gather_gemm.scalar": 80, "sparse_conv_gather_gemm.cin1": 2,
            "sparse_conv_gather_gemm.tc": 0, "flash_nn": 2}
    if any(launched[k] != v for k, v in want.items()):
        raise AssertionError(f"train_reference: launches {launched}, want {want}")
    def rel_l2(keys, got, ref):
        num = sum(float(((got[k] - ref[k]).double() ** 2).sum()) for k in keys) ** 0.5
        return num / max(sum(float((ref[k].double() ** 2).sum()) for k in keys) ** 0.5, 1e-30)

    grad_l2 = rel_l2(list(grads_c), grads_g, grads_c)
    worst_grad = max((rel_l2([k], grads_g, grads_c), k) for k in grads_c)
    worst_entry = max((float((grads_g[k] - grads_c[k]).abs().max())
                       / max(float(grads_c[k].abs().max()), 1e-6), k) for k in grads_c)
    params = dict(model.named_parameters())
    worst_param = max((float((sd_g[k] - sd_c[k]).abs().max())
                       / (cfg.lr * max(float(grads_c[k].norm()), 1e-6)), k) for k in params)
    worst_buffer = max((float((sd_g[k].float() - sd_c[k].float()).abs().max())
                        / max(float(sd_c[k].float().abs().max()), 1e-3), k)
                       for k in sd_c if k not in params)
    # 8 steps on the card
    model = train_model(cfg, "cuda", seed=1)
    batch = synthetic_batch(np.random.RandomState(0), batch_size=2, n_points=700, n_pad=n_pad,
                            image_hw=(24, 32), device="cuda")
    state = create_train_state(model, cfg.replace(lr=0.03), steps_per_epoch=100)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = make_train_step(cfg, map_impl="search")
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
    emit({"phase": "train_reference", "config": SMALL_TRAIN, "loss": [loss_g, loss_c],
          "loss_tol": TRAIN_REF_LOSS_ATOL, "gradients": len(grads_c),
          "gradients_rel_l2": grad_l2, "gradients_rel_l2_tol": TRAIN_REF_GRAD_L2,
          "worst_gradient_tensor_rel_l2": list(worst_grad),
          "gradient_tensor_rel_l2_tol": TRAIN_REF_TENSOR_L2,
          "worst_gradient_entry_of_tensor_max": list(worst_entry),
          "worst_updated_parameter_of_lr_times_gradient_norm": list(worst_param),
          "worst_buffer_rel_err": list(worst_buffer), "buffer_tol_rel": TRAIN_REF_BUFFER_REL,
          "launches": launched, "eight_step_losses": losses})
    if (abs(loss_g - loss_c) > TRAIN_REF_LOSS_ATOL or set(grads_g) != set(grads_c)
            or grad_l2 > TRAIN_REF_GRAD_L2 or worst_grad[0] > TRAIN_REF_TENSOR_L2
            or worst_param[0] > TRAIN_REF_TENSOR_L2 or worst_buffer[0] > TRAIN_REF_BUFFER_REL):
        raise AssertionError("train_reference: card and CPU disagree")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train_reference: 8 steps did not lower the loss: {losses}")


def check_positive_search(batch, radius, per_pair=2000):
    """The positive search of every pair of the batch against an f64 brute
    force on ``per_pair`` sampled queries: the kernel's match is the nearest
    same-pair voxel (its exact distance within SEARCH_D2_ATOL of the least)
    and its "ok" flag equals the brute force's, except within SEARCH_D2_ATOL
    of the radius. Returns per pair the share of voxels with a positive and
    the counts checked."""
    pairs, ok = compute_correspondences(batch, radius)
    n0 = int(batch.n0)
    pair_of = batch.coords0[:n0, 0]
    v1 = row_mask(batch.coords1.shape[0], batch.n1)
    x1 = batch.xyz1.double()
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = []
    for b in range(batch.T_gt.shape[0]):
        rows = torch.nonzero(pair_of == b)[:, 0]
        rows = rows[torch.randperm(rows.numel(), generator=gen, device="cuda")[:per_pair]]
        T = batch.T_gt[b].double()
        moved = batch.xyz0[rows].double() @ T[:3, :3].T + T[:3, 3]
        d2 = ((moved[:, None, :] - x1[None]) ** 2).sum(-1)          # [per_pair, N1] f64
        d2 = d2.masked_fill(~(v1 & (batch.coords1[:, 0] == b))[None], float("inf"))
        best_d, best_i = d2.min(dim=1)
        got_i = pairs[rows, 1].long()
        gap = float((d2[torch.arange(rows.numel()), got_i] - best_d).max())
        rim = (best_d - radius * radius).abs() <= SEARCH_D2_ATOL
        ok_equal = bool((ok[rows] == (best_d <= radius * radius))[~rim].all())
        same_pair = bool((batch.coords1[got_i, 0] == b).all())
        out.append({"pair": b, "voxels": int((pair_of == b).sum()),
                    "share_with_positive": float(ok[:n0][pair_of == b].float().mean()),
                    "checked": int(rows.numel()), "index_mismatches": int((got_i != best_i).sum()),
                    "worst_d2_above_least": gap, "ok_flags_equal": ok_equal,
                    "at_the_radius": int(rim.sum())})
        if gap > SEARCH_D2_ATOL or not ok_equal or not same_pair:
            raise AssertionError(f"train: the positive search of pair {b} disagrees with "
                                 f"the f64 brute force: {out[-1]}")
    if bool(ok[n0:].any()):
        raise AssertionError("train: a padding row has a positive")
    return out


def phase_train(cfg, batch, n_warm=3, n_steps=10):
    """Timed training steps at full width; every kernel's launches are
    counted from 0 over the timed steps and must be TRAIN_LAUNCHES a step."""
    model = train_model(cfg, "cuda")
    state = create_train_state(model, cfg, steps_per_epoch=100)
    # the search pyramid, whatever the config says: these launch gates and
    # times stay comparable with earlier runs; the trainer phase runs the
    # config's own
    step = make_train_step(cfg, map_impl="search")
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for _ in range(n_warm):
        state, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    lat, losses = [], []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        t = time.perf_counter()
        state, metrics = step(state, batch, gen)
        losses.append(metrics)              # 0-d tensors; read after the loop
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    if launches != {k: v * n_steps for k, v in TRAIN_LAUNCHES.items()}:
        raise AssertionError(f"train: kernel launches {launches} over {n_steps} steps; "
                             f"want {TRAIN_LAUNCHES} per step")
    losses = [{k: float(v) for k, v in m.items()} for m in losses]
    if not all(np.isfinite(list(m.values())).all() for m in losses):
        raise AssertionError(f"train: a loss is not finite: {losses}")
    after = model.state_dict()
    moved = [k for k in before if before[k].dtype.is_floating_point
             and not torch.equal(before[k], after[k])]
    finite = all(bool(torch.isfinite(v).all()) for v in after.values()
                 if v.dtype.is_floating_point)
    n_float = sum(v.dtype.is_floating_point for v in after.values())
    if not finite or len(moved) != n_float or state.step != n_warm + n_steps:
        raise AssertionError(f"train: {len(moved)} of {n_float} parameters and buffers moved, "
                             f"finite {finite}, {state.step} steps")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30    # of the steps alone
    radius = cfg.voxel_size * cfg.positive_pair_search_voxel_size_multiplier
    search = check_positive_search(batch, radius)
    emit({"phase": "train", "model": cfg.model, "compute_dtype": cfg.compute_dtype,
          "batch_pairs": TRAIN_BATCH, "n_pad": TRAIN_N_PAD,
          "voxels_per_side": [int(batch.n0), int(batch.n1)],
          "steps": n_steps, "seconds": seconds, "steps_per_s": n_steps / seconds,
          "pairs_per_s": TRAIN_BATCH * n_steps / seconds,
          "step_ms": {"median": float(np.median(lat)), "min": min(lat), "max": max(lat)},
          "launches": launches,
          "launches_per_step": {k: v / n_steps for k, v in launches.items()},
          "losses": losses, "tensors_moved": len(moved),
          "lr": float(state.optimizer.param_groups[0]["lr"]),
          "positive_search": search, "search_d2_tol": SEARCH_D2_ATOL,
          "peak_mem_gib": peak_gib})
    return launches, seconds / n_steps, state, step, gen


GRAPH_STEPS = 6       # steps compared both ways: three epochs of two
# one validation step at the train phase's width with the search builder
GRAPH_VAL_LAUNCHES = dict(TRAINER_VAL_LAUNCHES, word_match=0)


def phase_graphs(cfg, batch):
    """The training step replayed as a CUDA graph
    (``make_graphed_train_step``) against ``make_train_step``, from one
    seeded model, generator seed and batch (the train phase's; the search
    builder), two steps an epoch: after GRAPH_STEPS steps the parameters,
    buffers and momentum, the learning rate, every loss and the generator
    must be bit-equal (else the largest gap is printed and the phase
    fails); the launches one replay counts must be TRAIN_LAUNCHES; steps/s
    and step ms both ways, interleaved. Then the validation step
    (``make_graphed_val_step`` against ``make_val_step``, one pair at the
    same width, a generator seeded per call): metrics bit-equal over
    GRAPH_CALLS calls, a replay's launches GRAPH_VAL_LAUNCHES, ms both ways.
    Returns the graphed step, its state and generator, and its median ms."""
    states, gens = [], []
    for _ in range(2):
        states.append(create_train_state(train_model(cfg, "cuda"), cfg, steps_per_epoch=2))
        gens.append(torch.Generator(device="cuda").manual_seed(0))
    eager = make_train_step(cfg, map_impl="search")
    graphed = make_graphed_train_step(cfg, map_impl="search")
    losses = {"eager": [], "graphed": []}
    for _ in range(GRAPH_STEPS):
        losses["eager"].append(eager(states[0], batch, gens[0])[1]["loss"].clone())
        losses["graphed"].append(graphed(states[1], batch, gens[1])[1]["loss"].clone())
    torch.cuda.synchronize()
    states_equal, states_gap = arrays_gap(dp.train_state_arrays(states[1]),
                                          dp.train_state_arrays(states[0]), "graphs")
    losses_equal = all(torch.equal(a, b) for a, b in zip(losses["eager"], losses["graphed"]))
    gen_equal = torch.equal(gens[0].get_state(), gens[1].get_state())
    lr = [float(st.optimizer.param_groups[0]["lr"]) for st in states]
    reset_counts()
    graphed(states[1], batch, gens[1])
    per_replay = read_counts()
    timed = both_ways({"eager": lambda: eager(states[0], batch, gens[0]),
                       "graphed": lambda: graphed(states[1], batch, gens[1])})

    vcfg = cfg.replace(batch_size=1, max_points=TRAIN_N_PAD)
    vbatch = synthetic_batch(np.random.RandomState(1), batch_size=1, n_points=200_000,
                             n_pad=TRAIN_N_PAD, image_hw=(cfg.image_H, cfg.image_W))
    vmodel = train_model(cfg, "cuda")
    veager = make_val_step(vmodel, vcfg, map_impl="search")
    vgraphed = make_graphed_val_step(vmodel, vcfg, map_impl="search")
    val_equal = True
    for i in range(GRAPH_CALLS):
        want = veager(vbatch, torch.Generator(device="cuda").manual_seed(i))
        got = vgraphed(vbatch, torch.Generator(device="cuda").manual_seed(i))
        val_equal = val_equal and tensors_gap(got, want)[0]
    reset_counts()
    vgraphed(vbatch, torch.Generator(device="cuda").manual_seed(0))
    val_per_replay = read_counts()
    val_timed = both_ways({"eager": lambda: veager(vbatch, torch.Generator(device="cuda")),
                           "graphed": lambda: vgraphed(vbatch, torch.Generator(device="cuda"))},
                          block=5)
    emit({"phase": "graphs", "steps_compared": GRAPH_STEPS, "steps_per_epoch": 2,
          "state_bit_equal": states_equal, "state_max_rel_err": states_gap,
          "losses_bit_equal": losses_equal, "generator_equal": gen_equal, "lr": lr,
          "losses": [float(v) for v in losses["graphed"]],
          "captures": graphed.graphed.captures, "replays": graphed.graphed.replays,
          "launches_per_replay": per_replay, "steps": timed,
          "val_calls_compared": GRAPH_CALLS, "val_metrics_bit_equal": val_equal,
          "val_launches_per_replay": val_per_replay, "val_steps": val_timed,
          "order": "eager, graphed, graphed, eager", "block": GRAPH_BLOCK,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "nvidia_smi": DEVICE["nvidia_smi"]})
    if not (states_equal and losses_equal and gen_equal and lr[0] == lr[1]):
        raise AssertionError(f"graphs: the replayed step differs from the eager one: state "
                             f"{states_equal} ({states_gap}), losses {losses_equal}, "
                             f"generator {gen_equal}, lr {lr}")
    if per_replay != TRAIN_LAUNCHES or val_per_replay != GRAPH_VAL_LAUNCHES:
        raise AssertionError(f"graphs: a replay launched {per_replay} (step) and "
                             f"{val_per_replay} (validation); want {TRAIN_LAUNCHES} and "
                             f"{GRAPH_VAL_LAUNCHES}")
    if not val_equal:
        raise AssertionError("graphs: the replayed validation step differs from the eager one")
    return graphed, states[1], gens[1], timed["graphed"]["median_ms"]


class CountingTrainer(Trainer):
    """The port's Trainer, reading what the run reports around its own
    epochs: kernel launches of the training and of the validation epochs
    apart, each training epoch's wall time, timers and mean loss, each
    step's time to completion on the card, each validation epoch's metrics."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.counts = {"train": dict.fromkeys(TRAIN_LAUNCHES, 0),
                       "val": dict.fromkeys(TRAIN_LAUNCHES, 0)}
        self.steps = {"train": 0, "val": 0}
        self.epochs, self.vals, self.step_ms, self.losses = [], [], [], []
        self.first_epoch_state = None
        step = self.train_step

        def timed_step(state, batch, generator):
            t = time.perf_counter()
            out = step(state, batch, generator)
            torch.cuda.synchronize()
            self.step_ms.append((time.perf_counter() - t) * 1e3)
            self.losses.append(out[1]["loss"].detach().clone())
            return out

        timed_step.graphed = getattr(step, "graphed", None)
        self.train_step = timed_step

    def _count(self, kind, before, steps):
        after = read_counts()
        for k in after:
            self.counts[kind][k] += after[k] - before[k]
        self.steps[kind] += steps

    def _train_epoch(self, epoch):
        before, step0, t = read_counts(), self.state.step, time.perf_counter()
        super()._train_epoch(epoch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        self._count("train", before, self.state.step - step0)
        self.epochs.append({"epoch": epoch, "steps": self.state.step - step0,
                            "seconds": seconds, "mean_loss": self.loss_meter.avg,
                            "total_timer_avg_s": self.total_timer.avg,
                            "data_timer_avg_s": self.data_timer.avg,
                            "longest_batch_wait_s": self.data_timer.max,
                            "move_timer_avg_ms": self.move_timer.avg * 1e3})
        if self.first_epoch_state is None:
            self.first_epoch_state = dp.train_state_arrays(self.state)

    def _valid_epoch(self):
        before = read_counts()
        out = super()._valid_epoch()
        self._count("val", before, min(self.config.val_max_iter, len(self.val_data_loader)))
        self.vals.append(out)
        return out


def pinned_per_field(batch, device):
    """The move to the card before the staging ring: every field pinned anew
    and copied on its own. The trainer phase's unstaged reference (no path
    of the port moves batches so)."""
    return PairBatch(*(None if t is None else t.pin_memory().to(device, non_blocking=True)
                       for t in batch))


class UnstagedTrainer(CountingTrainer):
    """The counting trainer with ``pinned_per_field`` in place of its
    staging ring."""

    def move(self, batch):
        return pinned_per_field(batch, self.device)


def loader_workers_alive():
    """The loaders' worker processes this process still has."""
    return [p.name for p in multiprocessing.active_children() if p.name == LOADER_WORKER]


def run_rates(trainer):
    """What a trainer's epochs read: steps/s with the loader over all its
    epochs and after the first (which holds the worker's start), the median
    step, the loader's wait as a share of an iteration, the first epoch's
    longest wait for a batch, and the move to the card."""
    ep = trainer.epochs
    steps = sum(e["steps"] for e in ep)
    later = ep[1:]
    return {"epochs": len(ep), "steps": steps,
            "steps_per_s_with_loader": steps / sum(e["seconds"] for e in ep),
            "steps_per_s_after_first_epoch": (sum(e["steps"] for e in later)
                                              / sum(e["seconds"] for e in later)),
            "step_ms_median": float(np.median(trainer.step_ms)),
            "data_share_of_total": (sum(e["data_timer_avg_s"] * e["steps"] for e in ep)
                                    / sum(e["total_timer_avg_s"] * e["steps"] for e in ep)),
            "longest_batch_wait_s_first_epoch": ep[0]["longest_batch_wait_s"],
            "move_timer_ms": float(np.mean([e["move_timer_avg_ms"] for e in ep]))}


def phase_trainer(out_dir):
    """The trainer at full width on SyntheticPairDataset (200k points a
    fragment): the training loader in a worker process and the validation
    loader in a thread (the card's defaults), epochs with validation,
    checkpoints; then the same run with the training loader's thread
    (workers=0). Fails unless every loss is finite, the last
    epoch's mean loss is below the first's, a training step launches
    TRAINER_STEP_LAUNCHES and a validation step TRAINER_VAL_LAUNCHES, a
    best-validation checkpoint exists, the last checkpoint, loaded into a
    new Trainer, takes a next step bit-equal to the first trainer's, the
    two runs are bit-equal (every loss; the first epoch's parameters,
    buffers and momentum), the first epoch of a third run, with the
    worker and without the staging ring (``UnstagedTrainer``, no
    validation), is bit-equal to the first run's, and no loader worker is
    alive after them. Prints the move to the card with and without the
    ring. The runs' files go to ``out_dir``."""
    cfg = bench_config().replace(
        batch_size=TRAIN_BATCH, val_batch_size=1, dataset="SyntheticPairDataset",
        synthetic_n_points=200_000, max_points=TRAIN_N_PAD, stat_freq=1, out_dir=out_dir,
        **TRAINER_RUN)

    def loaders(c, workers):
        return (make_data_loader(c, "train", c.batch_size, workers=workers),
                make_data_loader(c, "val", c.val_batch_size))

    trainer = CountingTrainer(cfg, *loaders(cfg, None))
    if (trainer.data_loader.workers, trainer.val_data_loader.workers) != (1, 0):
        raise AssertionError("trainer: the card's loaders are not a worker process for "
                             "training and a thread for validation")
    trainer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    alive_after_run = loader_workers_alive()

    # ---- the first epoch again with the worker but without the staging
    # ring: every field pinned and copied on its own, as before the ring
    cfgu = cfg.replace(out_dir=os.path.join(out_dir, "unstaged"), max_epoch=1)
    unstaged = UnstagedTrainer(cfgu, make_data_loader(cfgu, "train", cfgu.batch_size), None)
    unstaged.init_state()
    unstaged.train()
    torch.cuda.synchronize()
    n_first = unstaged.epochs[0]["steps"]
    staged_equal, staged_gap = arrays_gap(unstaged.first_epoch_state, trainer.first_epoch_state,
                                          "trainer: the first epoch, unstaged against staged")
    staged_equal = staged_equal and all(torch.equal(x, y) for x, y in
                                        zip(unstaged.losses, trainer.losses[:n_first]))
    staging = {"slots": STAGING_SLOTS, "bit_equal_first_epoch": staged_equal,
               "states_max_rel_err": staged_gap,
               "move_ms_first_epoch": {"staged": trainer.epochs[0]["move_timer_avg_ms"],
                                       "unstaged": unstaged.epochs[0]["move_timer_avg_ms"]},
               "move_ms_staged_epochs": [e["move_timer_avg_ms"] for e in trainer.epochs],
               "unstaged_steps_per_s": n_first / unstaged.epochs[0]["seconds"],
               "unstaged_step_ms_median": float(np.median(unstaged.step_ms))}
    del unstaged

    # ---- the same run with the training loader's thread: its epochs after
    # the first read against the worker's epochs after the first
    cfg0 = cfg.replace(out_dir=os.path.join(out_dir, "thread"))
    thread = CountingTrainer(cfg0, *loaders(cfg0, 0))
    thread.init_state()
    thread.train()
    torch.cuda.synchronize()
    n_first = thread.epochs[0]["steps"]
    states_equal, states_gap = arrays_gap(thread.first_epoch_state, trainer.first_epoch_state,
                                          "trainer: the first epoch, workers 0 against 1")
    losses_equal = (len(thread.losses) == len(trainer.losses)
                    and all(torch.equal(x, y) for x, y in zip(trainer.losses, thread.losses)))
    first_equal = states_equal and losses_equal
    rates = {"workers_1": run_rates(trainer), "workers_0": run_rates(thread)}
    del thread

    # ---- the same run with both steps eager (graphed=False), which the
    # graphed run must equal bit for bit: losses, validation metrics, the
    # first epoch's state and the last
    cfge = cfg.replace(out_dir=os.path.join(out_dir, "eager"))
    eager = CountingTrainer(cfge, *loaders(cfge, None), graphed=False)
    eager.init_state()
    eager.train()
    torch.cuda.synchronize()
    first_gap = arrays_gap(eager.first_epoch_state, trainer.first_epoch_state,
                           "trainer: the first epoch, eager against graphed")
    last_gap = arrays_gap(dp.train_state_arrays(eager.state), dp.train_state_arrays(trainer.state),
                          "trainer: the last epoch, eager against graphed")
    graphs_vs_eager = {
        "losses_equal": (len(eager.losses) == len(trainer.losses)
                         and all(torch.equal(x, y) for x, y in zip(eager.losses, trainer.losses))),
        "validation_equal": len(eager.vals) == len(trainer.vals) and all(
            a.keys() == b.keys() and np.array_equal(list(a.values()), list(b.values()),
                                                     equal_nan=True)
            for a, b in zip(eager.vals, trainer.vals)),
        "first_epoch_bit_equal": first_gap[0], "last_epoch_bit_equal": last_gap[0],
        "states_max_rel_err": max(first_gap[1], last_gap[1]),
        "generator_equal": torch.equal(eager.generator.get_state(), trainer.generator.get_state()),
        "eager_launches_per_train_step": {k: v / eager.steps["train"]
                                          for k, v in eager.counts["train"].items()},
        "replays": {"train": trainer.train_step.graphed.replays,
                    "val": trainer.val_step.graphed.replays}}
    rates["eager_workers_1"] = run_rates(eager)
    eager.writer.close()
    del eager

    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        scalars = [json.loads(ln) for ln in f]
    losses = [r["value"] for r in scalars if r["tag"] == "train/loss"]
    names = sorted(os.path.basename(d) for d in glob.glob(os.path.join(out_dir, "*checkpoint_*")))
    ep = trainer.epochs
    n_train, n_val = trainer.steps["train"], trainer.steps["val"]
    train_s = sum(e["seconds"] for e in ep)
    data_share = (sum(e["data_timer_avg_s"] * e["steps"] for e in ep)
                  / sum(e["total_timer_avg_s"] * e["steps"] for e in ep))
    per_step = {k: v / n_train for k, v in trainer.counts["train"].items()}
    per_val = {k: v / n_val for k, v in trainer.counts["val"].items()}

    # ---- resume on the card: the last checkpoint into a new Trainer
    last = os.path.join(out_dir, max((n for n in names if n.startswith("checkpoint_")),
                                     key=lambda n: int(n.split("_")[2])))
    resumed = Trainer(cfg.replace(resume=last), *loaders(cfg, None))
    resumed.init_state()
    batch = batch_to_device(next(iter(make_data_loader(cfg, "val", TRAIN_BATCH))),
                            torch.device("cuda"))
    step = make_train_step(cfg)
    nxt = []
    for t in (trainer, resumed):
        _, m = step(t.state, batch, t.generator)
        sd = dict(t.state.model.state_dict())
        for i, st in t.state.optimizer.state_dict()["state"].items():
            sd[f"momentum{i}"] = st["momentum_buffer"]
        nxt.append((m["loss"], sd))
    (la, sa), (lb, sb) = nxt
    differing = [k for k in sa if not torch.equal(sa[k], sb[k])]
    resume_equal = (resumed.start_epoch == cfg.max_epoch + 1 and resumed.state.step == n_train + 1
                    and torch.equal(la, lb) and sa.keys() == sb.keys() and not differing)
    # the trainer's own step (the grid builder) on that one batch again and
    # again, on the resumed state, which nothing reads after: what a step
    # costs with no loader beside it and no new batch shapes
    repeated_ms = []
    for _ in range(REPEATED_WARM + REPEATED_STEPS):
        t = time.perf_counter()
        step(resumed.state, batch, resumed.generator)
        torch.cuda.synchronize()
        repeated_ms.append((time.perf_counter() - t) * 1e3)
    repeated_ms = repeated_ms[REPEATED_WARM:]

    emit({"phase": "trainer", "model": cfg.model, "compute_dtype": cfg.compute_dtype,
          "use_grid_maps": cfg.use_grid_maps, "batch_pairs": cfg.batch_size,
          "n_pad": cfg.max_points, "points_per_fragment": cfg.synthetic_n_points,
          **TRAINER_RUN, "seconds": seconds, "train_steps": n_train, "val_steps": n_val,
          "steps_per_s_with_loader": n_train / train_s,
          "pairs_per_s_with_loader": cfg.batch_size * n_train / train_s,
          "step_ms": {"median": float(np.median(trainer.step_ms)),
                      "min": min(trainer.step_ms), "max": max(trainer.step_ms)},
          "epochs": ep, "data_share_of_total": data_share,
          "move_to_device_ms": float(np.mean([e["move_timer_avg_ms"] for e in ep])),
          "launches": launches, "launches_per_train_step": per_step,
          "launches_per_val_step": per_val, "peak_mem_gib": peak_gib,
          "train_losses": losses, "mean_loss_first_epoch": ep[0]["mean_loss"],
          "mean_loss_last_epoch": ep[-1]["mean_loss"], "validation": trainer.vals,
          "best_val_epoch": trainer.best_val_epoch, "checkpoints": names,
          "resume": {"checkpoint": os.path.basename(last), "next_step_bit_equal": resume_equal,
                     "loss": [float(la), float(lb)], "tensors": len(sa),
                     "differing": differing[:5]},
          "nvidia_smi": DEVICE["nvidia_smi"], "loader_runs": rates,
          "repeated_batch_step_ms": {"steps": REPEATED_STEPS,
                                     "median": float(np.median(repeated_ms)),
                                     "min": min(repeated_ms), "max": max(repeated_ms)},
          "staging": staging, "graphs_vs_eager": graphs_vs_eager,
          "workers_1_vs_0": {"first_epoch_steps": n_first, "bit_equal": first_equal,
                                         "losses_equal": losses_equal,
                                         "states_max_rel_err": states_gap},
          "loader_workers_alive": {"after_the_run": alive_after_run,
                                   "after_the_phase": loader_workers_alive()}})
    if len(losses) != n_train or not np.isfinite(losses).all():
        raise AssertionError(f"trainer: a loss is missing or not finite: {losses}")
    if not ep[-1]["mean_loss"] < ep[0]["mean_loss"]:
        raise AssertionError(f"trainer: the mean loss did not fall: {[e['mean_loss'] for e in ep]}")
    if per_step != TRAINER_STEP_LAUNCHES or per_val != TRAINER_VAL_LAUNCHES:
        raise AssertionError(f"trainer: launches per training step {per_step} (want "
                             f"{TRAINER_STEP_LAUNCHES}), per validation step {per_val} "
                             f"(want {TRAINER_VAL_LAUNCHES})")
    if launches != {k: trainer.counts["train"][k] + trainer.counts["val"][k] for k in launches}:
        raise AssertionError(f"trainer: launches outside the epochs: {launches}")
    if not any(n.startswith("best_val_checkpoint_") for n in names):
        raise AssertionError(f"trainer: no best-validation checkpoint in {names}")
    if not resume_equal:
        raise AssertionError(f"trainer: the resumed state's next step differs: {differing[:5]}, "
                             f"loss {float(la)} vs {float(lb)}")
    if not first_equal:
        raise AssertionError(f"trainer: the run with workers=1 differs from workers=0: "
                             f"losses equal {losses_equal}, states {states_gap}")
    if not staged_equal:
        raise AssertionError(f"trainer: the staged run differs from the unstaged one: "
                             f"{staged_gap}")
    if not all(graphs_vs_eager[k] for k in ("losses_equal", "validation_equal",
                                            "first_epoch_bit_equal", "last_epoch_bit_equal",
                                            "generator_equal")) or \
            graphs_vs_eager["eager_launches_per_train_step"] != TRAINER_STEP_LAUNCHES:
        raise AssertionError(f"trainer: the graphed run differs from the eager one: "
                             f"{graphs_vs_eager}")
    if alive_after_run or loader_workers_alive():
        raise AssertionError(f"trainer: loader workers outlive the run: {alive_after_run}, "
                             f"{loader_workers_alive()}")
    trainer.writer.close()
    resumed.writer.close()
    return launches, {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def phase_trained_pair(state_dict):
    """A held-out synthetic pair (HELD_OUT_SEED) registered through
    PairRegistrar once with the seeded random weights and once with the
    trainer's: inlier ratio, RRE, RTE and whether RANSAC accepted. The same
    keypoint and RANSAC draws for both. No gate beyond finite, well-formed
    outputs: see PERF.md for what a few training steps move."""
    pair = synthetic_pair(np.random.RandomState(HELD_OUT_SEED), n_points=200_000)
    out = {}
    for name, sd in (("random", None), ("trained", state_dict)):
        reg = PairRegistrar(state_dict=sd)
        gen = torch.Generator(device="cuda").manual_seed(1)
        pb = reg.prepare(pair.xyz0, pair.xyz1, pair.image0, pair.image1)
        q = reg.quantize(pb)
        feats = reg.forward(q, reg.pyramid(q), pb.images)
        res = reg.match(q, feats, pair.T_gt, np.eye(6, dtype=np.float32), generator=gen)
        torch.cuda.synchronize()
        check_outputs(q, feats, res)
        out[name] = {k: float(v) for k, v in res.items() if v.numel() == 1}
    emit({"phase": "trained_pair", "held_out_seed": HELD_OUT_SEED, "points": 200_000,
          "inlier_ratio": {k: v["ir"] for k, v in out.items()},
          "inlier_ratio_mutual": {k: v["inlier_ratio_mutual"] for k, v in out.items()},
          "rre_raw": {k: v["rre_raw"] for k, v in out.items()},
          "rte_raw": {k: v["rte_raw"] for k, v in out.items()},
          "accepted": {k: bool(v["accepted"]) for k, v in out.items()},
          "metrics": out})
    return out


# ---- the published-benchmark path: generate-desc, eval-3dmatch -------------

BENCH_SCENE = "7-scenes-redkitchen"   # a 3DMatch test scene's name and layout
BENCH_FRAGMENTS = 6
BENCH_WORLD_POINTS = 240_000          # each fragment keeps about 85 %: 204 000
BENCH_WIDE = BENCH_FRAGMENTS - 1      # this fragment also sees a wall 16 m away
FRAGMENT_LAUNCHES = {
    "grid": {"sparse_conv_gather_gemm": 20, "flash_nn": 0, "sorted_compact": 1,
             "word_match": 1, "sparse_conv_gather_gemm.tc": 20,
             "sparse_conv_gather_gemm.cin1": 0, "sparse_conv_gather_gemm.scalar": 0,
             "sparse_conv_gather_gemm.tcw": 0},
    "exact": {"sparse_conv_gather_gemm": 20, "flash_nn": 0, "sorted_compact": 0,
              "word_match": 0, "sparse_conv_gather_gemm.tc": 20,
              "sparse_conv_gather_gemm.cin1": 0, "sparse_conv_gather_gemm.scalar": 0,
              "sparse_conv_gather_gemm.tcw": 0},
}
SMALL_FRAGMENT_POINTS = 6000          # the card-vs-CPU fragment


def write_benchmark_scene(root, seed=0, world_frame=False):
    """A 3DMatch-layout scene: BENCH_FRAGMENTS PLY fragments, each a random
    85 % of one synthetic world (the synthetic_pair geometry, 1.5 m) seen
    from its own random pose, and gt.log / gt.info for the consecutive
    pairs (gt maps fragment j into fragment i's frame). Fragment BENCH_WIDE
    also holds 4 000 points of a wall 16 m away, so its voxel span exceeds
    the 256-voxel × 0.025 m grid extent (the exact path). No images: the reader uses
    a zero image. With ``world_frame`` the same points are written in the
    world's frame, as fused fragments of one scene share it. Returns
    (pcloud root, benchmark dir, the number of pairs)."""
    rng = np.random.RandomState(seed)
    world = _surface_cloud(rng, BENCH_WORLD_POINTS, 1.5).astype(np.float64)
    scene_dir = os.path.join(root, "pcloud", BENCH_SCENE, "seq-01")
    bench = os.path.join(root, "bench", BENCH_SCENE)
    os.makedirs(scene_dir)
    os.makedirs(bench)
    poses = []
    for k in range(BENCH_FRAGMENTS):
        P = np.eye(4)
        P[:3, :3] = axis_angle_rotation(rng.randn(3), rng.rand() * np.pi)
        P[:3, 3] = rng.randn(3) * 0.5
        poses.append(P)
        pts = world[rng.rand(len(world)) < 0.85]
        if k == BENCH_WIDE:
            wall = np.c_[np.full(4000, 16.0), rng.rand(4000, 2) - 0.5]
            pts = np.concatenate([pts, wall])
        inv = np.eye(4) if world_frame else np.linalg.inv(P)
        write_ply(os.path.join(scene_dir, f"cloud_bin_{k}.ply"),
                  (pts @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32))
    pairs = [(k, k + 1) for k in range(BENCH_FRAGMENTS - 1)]
    with open(os.path.join(bench, "gt.log"), "w") as flog, \
            open(os.path.join(bench, "gt.info"), "w") as finfo:
        for i, j in pairs:
            T = np.linalg.inv(poses[i]) @ poses[j]
            flog.write(f"{i} {j} {BENCH_FRAGMENTS}\n"
                       + "\n".join("\t".join(f"{v:.12f}" for v in r) for r in T) + "\n")
            finfo.write(f"{i} {j} {BENCH_FRAGMENTS}\n"
                        + "\n".join("\t".join(f"{v:.6f}" for v in r)
                                    for r in np.eye(6) * 400.0) + "\n")
    return os.path.join(root, "pcloud"), os.path.join(root, "bench"), len(pairs)


def counted_extractors(records):
    """A stand-in for threedmatch.make_bucketed_extractor whose extractors
    record, per fragment, the path, voxels, bucket, ms and kernel launches."""
    real = make_bucketed_extractor

    def make(*args, **kw):
        ext = real(*args, **kw)

        def extract(*a):
            before = read_counts()
            t = time.perf_counter()
            out = ext(*a)          # numpy results: the card has finished
            ms = (time.perf_counter() - t) * 1e3
            after = read_counts()
            extract.last = c = ext.last
            records.append({"path": "exact" if c.extent is None else "grid",
                            "voxels": c.voxels, "bucket": c.bucket, "tried": list(c.tried),
                            "ms": ms, "launches": {k: after[k] - before[k] for k in after}})
            return out

        extract.last = None
        return extract

    return make


def counted_registers(per_pair):
    """A stand-in for threedmatch.make_scene_register whose register records
    kernel B's launches and the ms of each pair."""
    real = threedmatch.make_scene_register

    def make(*args, **kw):
        reg = real(*args, **kw)

        def register(*a, **k):
            before = flash_nn.launches
            t = time.perf_counter()
            out = reg(*a, **k)
            float(out["rr"])
            per_pair.append({"flash_nn": flash_nn.launches - before,
                             "ms": (time.perf_counter() - t) * 1e3})
            return out

        return register

    return make


def run_cli(argv, text=False):
    """``python -m imfnet_tpu_torch.cli`` in this process (so that the launch
    counts are visible): the JSON line it prints (with ``text``, all it
    prints), and its seconds."""
    import contextlib
    import io

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    seconds = time.perf_counter() - t
    if text:
        return buf.getvalue(), seconds
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]), seconds


def fragment_tables(cfg, raw, n_raw, extent, bucket):
    """One fragment's voxels and pyramid as the extractor builds them on the
    card, at ``bucket`` rows."""
    xyz = torch.from_numpy(raw).cuda()
    valid = torch.arange(len(raw), device="cuda") < n_raw
    ones = torch.ones((len(raw), 1), device="cuda")
    if extent is None:
        sv, _, _ = quantize(xyz, ones, valid, cfg.voxel_size, bucket)
        fn = make_pyramid_fn(cfg, bucket, 1, map_impl="search")
    else:
        sv, _, _ = quantize_grid(xyz, ones, valid, cfg.voxel_size, bucket,
                                 GridSpec(extent=extent, num_batches=1), compact_impl="kernel")
        fn = make_pyramid_fn(cfg, bucket, 1, extent=extent, map_impl="banded")
    return xyz, valid, sv, fn(sv.coords, sv.num_valid)


def hold_grid_maps(coords, n, spec, n_pad, divisors, where):
    """Kernel D on the ten maps of a grid pyramid (``n_pad`` rows at
    ``divisors``) in one grouped launch, each map exactly equal to its plain
    version."""
    origins, tables = level_tables(coords, n, spec, level_capacities(n_pad, divisors))
    vmask = [row_mask(t.shape[0], c) for t, c in tables]
    wtabs = [compact_words(t, v, origins, spec, lvl)
             for lvl, ((t, _), v) in enumerate(zip(tables, vmask))]
    problems = []
    for name, lvl, tl, k, mode in GRID_MAPS:
        qk, _ = word_queries(origins, tables[lvl][0], vmask[lvl], spec,
                             table_level=tl, kernel_size=k, mode=mode)
        problems.append((wtabs[tl].wkeys, wtabs[tl].payload, wtabs[tl].n_words, qk))
    for (name, *_), (keys, payload, _, qk), out in zip(
            GRID_MAPS, problems, word_match_many(problems)):
        if not torch.equal(out, word_match_plain(keys, payload, qk)):
            raise AssertionError(f"{where}: kernel D disagrees at {name}")
    return "exact, 10 maps grouped"


def hold_convs(pyr, gen, where):
    """Kernel A at each distinct conv of the forward on ``pyr`` against its
    plain version (CONV_TOL_REL, the tensor-core variant): the largest
    error."""
    rows = hold_conv_list(pyr, MAIN_PATH_CONVS, gen, where)
    if any(r["variant"] != "tc" for r in rows):
        raise AssertionError(f"{where}: kernel A took {[r['variant'] for r in rows]}")
    return max(r["max_abs_err"] for r in rows)


def hold_fragment_kernels(cfg, raw, n_raw, extent, bucket, gen):
    """Kernels A, C and D against their plain versions at one fragment's
    shapes: C on its sorted raw-point cell keys (exact), D on its grid
    pyramid's ten maps in one grouped launch (exact), A at each distinct
    conv of the forward (CONV_TOL_REL, tensor-core variant)."""
    xyz, valid, sv, pyr = fragment_tables(cfg, raw, n_raw, extent, bucket)
    held = {"path": "exact" if extent is None else "grid", "bucket": bucket,
            "voxels": int(sv.num_valid)}
    if extent is not None:
        spec = GridSpec(extent=extent, num_batches=1)
        _, key = cell_keys(xyz, valid, cfg.voxel_size, spec)
        sk, order = torch.sort(key, stable=True)
        sel, count = sorted_compact(sk, order, DEFAULT_BUCKETS[-1])
        ref_sel, ref_count = sorted_compact_plain(sk, order, DEFAULT_BUCKETS[-1])
        if not (torch.equal(sel, ref_sel) and torch.equal(count, ref_count)):
            raise AssertionError("benchmark: kernel C disagrees at a fragment's keys")
        held.update(sorted_compact="exact", word_match=hold_grid_maps(
            sv.coords, sv.num_valid, spec, bucket, tuple(cfg.level_capacity_divisors),
            "benchmark fragment"))
    held["sparse_conv_gather_gemm_max_abs_err"] = hold_convs(pyr, gen, "benchmark fragment")
    return held


def voxels_covered(d, voxel):
    """Whether every raw point's voxel has a descriptor row."""
    def keys(p):
        v = np.floor(p / voxel).astype(np.int64) + (1 << 20)
        return (v[:, 0] << 42) | (v[:, 1] << 21) | v[:, 2]
    return bool(np.isin(np.unique(keys(d["points"])), keys(d["xyz"])).all())


def phase_benchmark(checkpoint, gen):
    """The 3DMatch path at full width through the CLI: generate-desc, then
    eval-3dmatch, on a scene the phase writes, with the trainer's best
    checkpoint. Fails unless the grid fragments launch C 1, D 1, A 20
    (tensor-core) and the exact ones A 20 and no C or D, each pair launches
    B 2, A, C and D agree with their plain versions at a fragment's shapes
    and B at 5000² × 32, every raw point's voxel has a descriptor row, a
    small fragment's points and descriptors on the card equal a CPU run,
    and the evaluation counts gt.log's pairs."""
    records, per_pair, warm = [], [], []
    with tempfile.TemporaryDirectory(prefix="benchmark_") as root:
        pcloud, bench, n_pairs = write_benchmark_scene(root)
        desc, out = os.path.join(root, "desc"), os.path.join(root, "eval")
        saved = (threedmatch.TEST_SCENE_NAMES, threedmatch.make_bucketed_extractor,
                 threedmatch.make_scene_register)
        threedmatch.TEST_SCENE_NAMES = [BENCH_SCENE]
        threedmatch.make_bucketed_extractor = counted_extractors(records)
        threedmatch.make_scene_register = counted_registers(per_pair)
        try:
            reset_counts()
            stats, gen_s = run_cli(["generate-desc", "--checkpoint", checkpoint,
                                    "--pcloud-root", pcloud, "--out-root", desc])
            gen_launches = read_counts()
            reset_counts()
            summary, eval_s = run_cli(["eval-3dmatch", "--checkpoint", checkpoint,
                                       "--desc-root", desc, "--out-root", out,
                                       "--benchmark-dir", bench])
            eval_launches = read_counts()
            # generate-desc again into a new root: the first run holds the
            # process's first calls at each shape (allocator, cuDNN plans)
            threedmatch.make_bucketed_extractor = counted_extractors(warm)
            warm_stats, _ = run_cli(["generate-desc", "--checkpoint", checkpoint,
                                     "--pcloud-root", pcloud, "--out-root", desc + "_warm"])
        finally:
            (threedmatch.TEST_SCENE_NAMES, threedmatch.make_bucketed_extractor,
             threedmatch.make_scene_register) = saved

        model, cfg = load_model_from_checkpoint(checkpoint, torch.device("cuda"))
        frag_dir = os.path.join(desc, BENCH_SCENE, "seq-01")
        npz = [np.load(os.path.join(frag_dir, f"cloud_bin_{k}.npz"))
               for k in range(BENCH_FRAGMENTS)]
        covered = [voxels_covered(d, cfg.voxel_size) for d in npz]
        # one fragment's extraction alone, against its time inside generate-desc
        raw, n_raw = pad_points_bucketed(npz[0]["points"])
        image = np.zeros((1, cfg.image_H, cfg.image_W, 3), np.float32)
        alone = make_bucketed_extractor(model, config=cfg)
        alone(raw, n_raw, image)
        alone_ms = []
        for _ in range(5):
            t = time.perf_counter()
            alone(raw, n_raw, image)
            alone_ms.append((time.perf_counter() - t) * 1e3)
        # A, C, D at the shapes of a grid and of the exact fragment; B at
        # 5000² × 32 on two fragments' descriptors
        held = []
        for k in (0, BENCH_WIDE):
            r = records[k]
            raw_k, n_k = pad_points_bucketed(npz[k]["points"])
            extent = None if r["path"] == "exact" else tuple(cfg.grid_extent)
            held.append(hold_fragment_kernels(cfg, raw_k, n_k, extent, r["bucket"], gen))
        rs = np.random.RandomState(1)
        kd = [torch.from_numpy(d["feature"][rs.choice(len(d["feature"]), 5000, replace=False)]
                               ).cuda().contiguous() for d in npz[:2]]
        held_b = nn_compare("benchmark descriptors 5000 x 5000 x 32", kd[0], kd[1], None,
                            same_index=False)
        # card against CPU on a small fragment: a random SMALL_FRAGMENT_POINTS
        # of fragment 0, sparse enough that its coarse levels may escalate
        small = npz[0]["points"][rs.choice(len(npz[0]["points"]), SMALL_FRAGMENT_POINTS,
                                           replace=False)]
        raw_s, n_s = pad_points_bucketed(small)
        cpu_model, _ = load_model_from_checkpoint(checkpoint, torch.device("cpu"))
        xg, fg = make_bucketed_extractor(model, config=cfg)(raw_s, n_s, image)
        cpu_ext = make_bucketed_extractor(cpu_model, config=cfg)
        xc, fc = cpu_ext(raw_s, n_s, image)
        small_err = float(np.abs(fg - fc).max())
        small_cos = float((fg * fc).sum(axis=1).min())

    by_path = {p: [r["ms"] for r in records if r["path"] == p] for p in ("grid", "exact")}
    warm_by_path = {p: [r["ms"] for r in warm if r["path"] == p] for p in ("grid", "exact")}
    emit({"phase": "benchmark", "scene": BENCH_SCENE, "fragments": len(records),
          "raw_points": [int(len(d["points"])) for d in npz],
          "per_fragment": records, "extraction_ms_by_path": by_path,
          "extraction_median_ms_by_path": {p: float(np.median(v)) for p, v in by_path.items()
                                           if v},
          "generate_desc": stats,
          "generate_desc_seconds": gen_s,
          "fragment0_alone_ms": {"median": float(np.median(alone_ms)), "all": alone_ms},
          "fragment0_in_generate_desc_ms": records[0]["ms"],
          "warm_generate_desc": warm_stats, "warm_extraction_ms_by_path": warm_by_path,
          "warm_extraction_median_ms_by_path": {
              p: float(np.median(v)) for p, v in warm_by_path.items() if v},
          "launches_generate_desc": gen_launches, "launches_eval": eval_launches,
          "flash_nn_per_pair": [p["flash_nn"] for p in per_pair],
          "register_ms_per_pair": [p["ms"] for p in per_pair],
          "eval_seconds": eval_s, "eval_pairs_per_s": summary["num_pairs"] / eval_s,
          "summary": summary, "gt_pairs": n_pairs, "voxels_covered": covered,
          "kernels_held": held, "flash_nn_held": held_b,
          "small_fragment": {"points": SMALL_FRAGMENT_POINTS, "tried": list(cpu_ext.last.tried),
                             "xyz_down_equal": bool(np.array_equal(xg, xc)),
                             "descriptor_max_abs_err": small_err,
                             "descriptor_min_cos": small_cos,
                             "descriptor_tol": REF_BF16_DESC_ATOL}})
    if [r["path"] for r in warm] != [r["path"] for r in records]:
        raise AssertionError("benchmark: the warm generate-desc took other paths")
    for r in records + warm:
        if r["launches"] != FRAGMENT_LAUNCHES[r["path"]]:
            raise AssertionError(f"benchmark: a {r['path']}-path fragment launched "
                                 f"{r['launches']}, want {FRAGMENT_LAUNCHES[r['path']]}")
    if sorted({r["path"] for r in records}) != ["exact", "grid"] or \
            records[BENCH_WIDE]["path"] != "exact":
        raise AssertionError(f"benchmark: paths {[r['path'] for r in records]}")
    if any(p["flash_nn"] != 2 for p in per_pair) or len(per_pair) != n_pairs:
        raise AssertionError(f"benchmark: kernel B launches per pair {per_pair}")
    if summary["num_pairs"] != n_pairs or stats["count"] != BENCH_FRAGMENTS:
        raise AssertionError(f"benchmark: {summary['num_pairs']} pairs evaluated, "
                             f"{stats['count']} fragments; want {n_pairs}, {BENCH_FRAGMENTS}")
    if not all(covered):
        raise AssertionError(f"benchmark: raw voxels without a descriptor row: {covered}")
    if not np.array_equal(xg, xc) or small_err > REF_BF16_DESC_ATOL or \
            small_cos < REF_BF16_MIN_COS:
        raise AssertionError(f"benchmark: a small fragment on the card differs from the CPU: "
                             f"err {small_err}, min cos {small_cos}")
    return gen_launches, eval_launches


# ---- KITTI: ICP on the card, then eval-kitti -------------------------------

KITTI_SCANS = 5
KITTI_POINTS = 120_000
KITTI_KEEP = 0.85                     # each scan's own random share of the world
KITTI_NOISE = 0.01                    # m per axis, drawn anew for each scan
KITTI_POSE_ERR = (0.03, 0.03)         # °, m: each pose's error, which ICP must repair
ICP_GT_TOL = (0.005, 0.01)            # m, °: the refined ground truth against the truth
KITTI_DRIVE = 8                       # the first drive of the test split
ICP_CPU_POINTS = 8192                 # the card-vs-CPU ICP check, per side
ICP_ATOL = 1e-4
KITTI_PAIR_LAUNCHES = {"sparse_conv_gather_gemm": 40, "flash_nn": 2, "sorted_compact": 0,
                       "word_match": 2, "sparse_conv_gather_gemm.tc": 40,
                       "sparse_conv_gather_gemm.cin1": 0, "sparse_conv_gather_gemm.scalar": 0,
                       "sparse_conv_gather_gemm.tcw": 0}


def write_kitti_scans(root, seed=0):
    """The layout of tests/test_torch_port_kitti.py at scan scale: a world
    of KITTI_POINTS / KITTI_KEEP points over ±40 m (z ±1.5 m); scan t keeps
    its own random KITTI_KEEP of them with KITTI_NOISE of noise, seen after
    t moves of (1.5, 0.6, 0) m. Each pose in the poses file is off by a
    random rotation and translation of KITTI_POSE_ERR, so the closed-form
    ground truth is a perturbed start that ICP must refine. A test list of
    the drive. Returns each scan's true motion (world from scan)."""
    rng = np.random.RandomState(seed)
    seq = os.path.join(root, "dataset", "sequences", "%02d" % KITTI_DRIVE, "velodyne")
    poses_dir = os.path.join(root, "dataset", "poses")
    os.makedirs(seq)
    os.makedirs(poses_dir)
    M = np.eye(4)
    M[:3, 3] = [1.5, 0.6, 0.0]
    n_world = int(KITTI_POINTS / KITTI_KEEP)
    world = np.stack([rng.uniform(-40, 40, n_world), rng.uniform(-40, 40, n_world),
                      rng.uniform(-1.5, 1.5, n_world)], 1)
    V = velo2cam()
    motions = []
    with open(os.path.join(poses_dir, "%02d.txt" % KITTI_DRIVE), "w") as f:
        for t in range(KITTI_SCANS):
            Mt = np.linalg.matrix_power(M, t)
            motions.append(Mt)
            seen = world[rng.rand(n_world) < KITTI_KEEP]
            seen = seen + rng.randn(*seen.shape) * KITTI_NOISE
            pts = apply_transform_np(seen, np.linalg.inv(Mt)).astype(np.float32)
            np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1).tofile(
                os.path.join(seq, "%06d.bin" % t))
            E = np.eye(4)
            E[:3, :3] = axis_angle_rotation(rng.randn(3), np.radians(KITTI_POSE_ERR[0]))
            u = rng.randn(3)
            E[:3, 3] = u / np.linalg.norm(u) * KITTI_POSE_ERR[1]
            pT = np.linalg.inv(np.linalg.inv(V) @ np.linalg.inv(Mt @ E).T @ V)
            f.write(" ".join(f"{v:.9f}" for v in pT.T[:3].reshape(-1)) + "\n")
    with open(os.path.join(root, "test_list.txt"), "w") as f:
        f.write(f"{KITTI_DRIVE}\n")
    return motions


def closed_form_gt(dset, drive, t0, t1):
    """A pair's ground truth from the poses file, as KITTIPairDataset
    computes it before ICP."""
    poses = dset._poses(drive)
    p0, p1 = dset._position(poses[t0]), dset._position(poses[t1])
    return (velo2cam() @ p0.T @ np.linalg.inv(p1.T) @ np.linalg.inv(velo2cam())).T


def pose_gap(T, truth):
    """(m, °) between two poses. The angle comes from the skew part of
    R_Tᵀ R_truth, which resolves 1e-7 rad where the arccos of the trace
    steps by 0.03° on f32 entries."""
    R = T[:3, :3].T @ truth[:3, :3]
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.linalg.norm(T[:3, 3] - truth[:3, 3])), float(np.degrees(np.arcsin(min(s, 1.0))))


def phase_kitti(gen):
    """KITTI at kitti_config() width (voxel 0.3, max_points 131 072, extent
    704 x 704 x 128, ResUNetBN2C bf16, seeded random weights): the test
    pairs' ground truth refined by ICP on the card (30 kernel-B launches a
    pair at 2^17 x 2^17 x 3) from the poses' perturbed start, then
    eval-kitti through the CLI. Fails unless every refined ground truth is
    within ICP_GT_TOL of the scans' true motion, ICP on the card agrees
    with the CPU within ICP_ATOL (on ICP_CPU_POINTS points a side, from the
    same start), kernel B agrees with its plain version at 131 072² × 32
    and at ICP's shape, A and D agree with theirs at pair 0's pyramid, each
    pair launches KITTI_PAIR_LAUNCHES, and the skipped and evaluated pairs
    add up to the file list."""
    icp_calls = []
    real_icp = KITTIPairDataset._run_icp

    def counted_icp(*a, **kw):
        before = flash_nn.launches
        t = time.perf_counter()
        T = real_icp(*a, **kw)
        icp_calls.append({"ms": (time.perf_counter() - t) * 1e3,
                          "flash_nn": flash_nn.launches - before, "n": len(a[0]),
                          "m": len(a[1])})
        return T

    with tempfile.TemporaryDirectory(prefix="kitti_") as root:
        motions = write_kitti_scans(root)
        cfg = kitti_config(dataset="KITTIPairDataset", kitti_root=root, kitti_max_time_diff=3)
        state = create_train_state(build_model_from_config(cfg), cfg, 1)
        ckpt = save_checkpoint(root, "checkpoint", state, cfg, 1, 0.0, 1, cfg.best_val_metric)
        saved = dict(KITTIPairDataset.DATA_FILES)
        KITTIPairDataset.DATA_FILES["test"] = os.path.join(root, "test_list.txt")
        KITTIPairDataset._run_icp = staticmethod(counted_icp)
        try:
            dset = KITTIPairDataset("test", cfg, random_rotation=False, random_scale=False,
                                    icp_device="cuda")
            sample_ms = []
            reset_counts()
            for i in range(len(dset)):
                t = time.perf_counter()
                dset[i]
                sample_ms.append((time.perf_counter() - t) * 1e3)
            icp_launches = read_counts()
            KITTIPairDataset._run_icp = staticmethod(real_icp)
            # the refined ground truth of each pair (its .npy cache) and the
            # perturbed start, against the scans' true motion
            icp_gt = []
            for drive, t0, t1 in dset.files:
                truth = np.linalg.inv(motions[t1]) @ motions[t0]
                refined = np.load(os.path.join(dset.icp_path, "%d_%d_%d.npy" % (drive, t0, t1)))
                icp_gt.append({"pair": [t0, t1],
                               "start_m_deg": pose_gap(closed_form_gt(dset, drive, t0, t1), truth),
                               "refined_m_deg": pose_gap(refined, truth)})
            # ICP card against CPU on the first ICP_CPU_POINTS points of pair
            # 0's scans, from the closed-form start as the dataset starts
            drive, t0, t1 = dset.files[0]
            xyz0 = np.fromfile(dset._velodyne_fn(drive, t0), np.float32).reshape(-1, 4)[:, :3]
            xyz1 = np.fromfile(dset._velodyne_fn(drive, t1), np.float32).reshape(-1, 4)[:, :3]
            M = closed_form_gt(dset, drive, t0, t1)
            s0 = apply_transform_np(xyz0[:ICP_CPU_POINTS], M)
            s1 = xyz1[:ICP_CPU_POINTS]
            Tg = real_icp(s0, s1, device="cuda")
            Tc = real_icp(s0, s1, device="cpu")
            icp_err = float(np.abs(Tg - Tc).max())

            # kernel B at ICP's shape (pair 0's clouds from the start, padded)
            # and at the evaluation's 131 072² x 32 (pair 0's descriptors)
            n_pad = 1 << int(np.ceil(np.log2(max(len(xyz0), len(xyz1)))))
            src = torch.zeros((n_pad, 3), device="cuda")
            dst = torch.zeros((n_pad, 3), device="cuda")
            src[:len(xyz0)] = torch.from_numpy(apply_transform_np(xyz0, M).astype(np.float32)).cuda()
            dst[:len(xyz1)] = torch.from_numpy(xyz1).cuda()
            dvalid = torch.arange(n_pad, device="cuda") < len(xyz1)
            icp_nn = kernel_b_entry("ICP, pair 0", src, dst, dvalid, "kitti", sweep=True)
            model, _ = load_model_from_checkpoint(ckpt, torch.device("cuda"))
            loader = make_data_loader(cfg, "test", 1, shuffle=False, device="cuda")
            batch = batch_to_device(next(iter(loader)), torch.device("cuda"))
            # A and D at eval-kitti's shapes: side 0 of pair 0, its grid
            # pyramid as forward_pair builds it
            rows = batch.coords0.shape[0]
            divisors = tuple(cfg.level_capacity_divisors)
            with torch.no_grad():
                pyr0 = make_pyramid_fn(cfg, rows, 1, map_impl="banded")(batch.coords0, batch.n0)
            held = {"rows": rows, "voxels": int(batch.n0), "divisors": list(divisors),
                    "word_match": hold_grid_maps(
                        batch.coords0, batch.n0, GridSpec(extent=tuple(cfg.grid_extent),
                                                          num_batches=1),
                        rows, divisors, "kitti pair 0"),
                    "sparse_conv_gather_gemm_max_abs_err": hold_convs(pyr0, gen, "kitti pair 0")}
            del pyr0
            ms_fwd, (f0, f1) = host_ms(lambda: forward_pair_eval(model, batch, cfg), 3)
            register = make_pair_registration(
                num_keypoints=cfg.max_points, voxel_size=cfg.voxel_size, ransac_n=cfg.ransac_n,
                num_hypotheses=cfg.ransac_max_iteration, inlier_thresh=cfg.inlier_thresh,
                distance_multiplier=1.0)
            eye6 = torch.eye(6, device="cuda")
            rgen = torch.Generator(device="cuda")
            ms_reg, out = host_ms(lambda: register(
                batch.xyz0, f0, batch.n0, batch.xyz1, f1, batch.n1, batch.T_gt[0], eye6,
                generator=rgen.manual_seed(0)), 3)
            feats_nn = kernel_b_entry("descriptors, pair 0", f0.float().contiguous(),
                                      f1.float().contiguous(), row_mask(f1.shape[0], batch.n1),
                                      "kitti")
            del loader

            reset_counts()
            result, eval_s = run_cli(["eval-kitti", "--checkpoint", ckpt, "--kitti-root", root])
            eval_launches = read_counts()
            # where an ICP call's time goes, after every timed run: the
            # profiler slows the host's later launches in this process
            moved0 = apply_transform_np(xyz0, M)
            profile_units(lambda: real_icp(moved0, xyz1, device="cuda"),
                          float(np.mean([c["ms"] for c in icp_calls])), "kitti_icp_profile",
                          "icp", 1)
        finally:
            KITTIPairDataset._run_icp = staticmethod(real_icp)
            KITTIPairDataset.DATA_FILES.clear()
            KITTIPairDataset.DATA_FILES.update(saved)

    n_files = len(dset.files)
    rte, rre = registration_errors(batch.T_gt[0].cpu().numpy(),
                                   out["transformation"].cpu().numpy())
    emit({"phase": "kitti", "scans": KITTI_SCANS, "points_per_scan": KITTI_POINTS,
          "keep": KITTI_KEEP, "noise_m": KITTI_NOISE, "pose_err_deg_m": KITTI_POSE_ERR,
          "pairs": n_files, "voxel_size": cfg.voxel_size, "max_points": cfg.max_points,
          "extent": list(cfg.grid_extent), "icp": icp_calls,
          "icp_ms_per_pair": float(np.mean([c["ms"] for c in icp_calls])),
          "icp_ground_truth": icp_gt, "icp_gt_tol_m_deg": ICP_GT_TOL,
          "sample_ms": sample_ms, "launches_icp": icp_launches,
          "icp_card_vs_cpu": {"points": ICP_CPU_POINTS, "max_abs_err": icp_err,
                              "tol": ICP_ATOL},
          "voxels_pair0": [int(batch.n0), int(batch.n1)], "kernels_held_pair0": held,
          "forward_pair_ms": ms_fwd, "registration_ms": ms_reg,
          "pair0_rte_m_rre_deg": [float(rte), float(rre)],
          "flash_nn_icp": icp_nn, "flash_nn_descriptors": feats_nn,
          "eval_seconds": eval_s, "eval_ms_per_pair": eval_s * 1e3 / max(result["num_pairs"], 1),
          "launches_eval": eval_launches, "result": result})
    if any(c["flash_nn"] != 30 for c in icp_calls) or len(icp_calls) != n_files:
        raise AssertionError(f"kitti: ICP launches {icp_calls}")
    for g in icp_gt:
        if not (g["refined_m_deg"][0] <= ICP_GT_TOL[0] and g["refined_m_deg"][1] <= ICP_GT_TOL[1]
                and g["start_m_deg"][0] > ICP_GT_TOL[0]):
            raise AssertionError(f"kitti: ICP did not refine the perturbed start to the truth "
                                 f"within {ICP_GT_TOL}: {icp_gt}")
    if icp_err > ICP_ATOL:
        raise AssertionError(f"kitti: ICP on the card differs from the CPU by {icp_err}")
    n_eval = result["num_pairs"]
    if n_eval + result["failed_loads"] != n_files or not n_eval:
        raise AssertionError(f"kitti: {result} against {n_files} pairs listed")
    if eval_launches != {k: v * n_eval for k, v in KITTI_PAIR_LAUNCHES.items()}:
        raise AssertionError(f"kitti: launches {eval_launches} over {n_eval} pairs; want "
                             f"{KITTI_PAIR_LAUNCHES} a pair")
    return icp_launches, eval_launches, icp_nn, feats_nn


# ---- every remaining subcommand: the zoo, the converter, DAM, the visualizer,
# the offline tools --------------------------------------------------------------

ZOO_MODEL = "SimpleNetBN2C"
# SimpleNetBN2C's 8 kernel-A convs (channels 32/64/128/256, tr 32/64/64/128):
# (name, level, map, cin, cout); conv1 (k 5^3, cin 1) is the cin1 variant
ZOO_CONVS = (("conv1", 0, "k5", 1, 32), ("conv2", 1, "down", 32, 64),
             ("conv3", 2, "down", 64, 128), ("conv4", 3, "down", 128, 256),
             ("conv4_tr", 2, "up", 256, 128), ("conv3_tr", 1, "up", 256, 64),
             ("conv2_tr", 0, "up", 128, 64), ("conv1_tr", 0, "k3_same", 96, 32))
ZOO_FRAGMENT_LAUNCHES = {"sparse_conv_gather_gemm": 8, "flash_nn": 0, "sorted_compact": 1,
                         "word_match": 1, "sparse_conv_gather_gemm.tc": 7,
                         "sparse_conv_gather_gemm.cin1": 1, "sparse_conv_gather_gemm.scalar": 0,
                         "sparse_conv_gather_gemm.tcw": 0}
# a training step: per side 8 forward convs and the dX calls of the 7 whose
# input needs a gradient (not conv1's); one positive search per pair
ZOO_STEP_LAUNCHES = {"sparse_conv_gather_gemm": 30, "flash_nn": 2, "sorted_compact": 0,
                     "word_match": 0, "sparse_conv_gather_gemm.tc": 28,
                     "sparse_conv_gather_gemm.cin1": 2, "sparse_conv_gather_gemm.scalar": 0,
                     "sparse_conv_gather_gemm.tcw": 0}
ZOO_STEPS = 3
# the image saliency's backward reaches the image through the fusion, so
# only the 9 decoder convs after it take a dX call (kernel A through their
# inverse maps); the encoder's inputs need no gradient
DAM_DX_CONVS = MAIN_PATH_CONVS[11:]
DAM_POINT = 780
DAM_REL, SALIENCY_REL = 1e-4, 1e-3      # of each map's largest value
OFFLINE_FRAMES, OFFLINE_HW = 50, (480, 640)
OFFLINE_FRAMES_PER_FRAGMENT = 25         # two fragments
OFFLINE_CPU_FRAMES = 8                   # fused on the CPU and on the card, compared
OFFLINE_K = np.array([[585.0, 0.0, 320.0], [0.0, 585.0, 240.0], [0.0, 0.0, 1.0]])
# the room's inside, and two boxes on its floor (m; y points down, as the camera's)
ROOM = (np.array([-3.0, -1.6, -2.5]), np.array([3.0, 1.4, 3.5]))
ROOM_BOXES = ((np.array([0.6, 0.4, 1.2]), np.array([1.5, 1.4, 2.1])),
              (np.array([-1.9, -0.2, -0.6]), np.array([-1.1, 1.4, 0.4])))
# card against CPU fusion: f32 projections summed in another order may move a
# voxel across the truncation or a pixel's rounding edge, which adds or drops
# a surface voxel beside one the other run keeps
FUSE_COUNT_REL = 5e-3                   # |points_card - points_cpu| / points_cpu
FUSE_DIST_VOXELS = 2.0                  # the largest nearest-point distance, in voxels
OVERLAP_RATIO_ATOL = 1e-3


def conv_call(pyr, name, level, which, cin, cout, gen, backward=False):
    """(x, nbr, w) of one conv as ``conv_inputs`` makes them, and of conv1,
    whose map is the pyramid's k5 map and whose input is one channel."""
    if which != "k5":
        return conv_inputs(pyr, level, which, cin, cout, gen, backward)
    nbr = pyr.k5_l0
    x = torch.randn((nbr.shape[0], cin), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((nbr.shape[1], cin, cout), generator=gen, device="cuda")
         * (nbr.shape[1] * cin) ** -0.5).to(torch.bfloat16)
    return x, nbr, w


def hold_conv_list(pyr, convs, gen, where, backward=False, timed=False):
    """Kernel A against its plain version (CONV_TOL_REL) at each distinct
    conv of ``convs`` on ``pyr`` (with ``backward`` at its dX call), in the
    variant ``conv_plan`` gives, asserted by the variant's counter; with
    ``timed`` each graph-timed beside its plain version and its bound."""
    rows, seen = [], set()
    for name, level, which, cin, cout in convs:
        if (level, which, cin, cout) in seen:
            continue
        seen.add((level, which, cin, cout))
        x, nbr, w = conv_call(pyr, name, level, which, cin, cout, gen, backward)
        ci, co = w.shape[1], w.shape[2]
        plan = conv_plan(nbr.shape[0], ci, co, nbr.shape[1], x.dtype)
        attr = f"launches_{plan.variant}"
        before = getattr(gather_gemm, attr)
        out, ref = gather_gemm(x, nbr, w), gather_gemm_plain(x, nbr, w)
        err = float((out - ref).abs().max())
        tol = CONV_TOL_REL * max(1.0, float(ref.abs().max()))
        if getattr(gather_gemm, attr) != before + 1 or err > tol:
            raise AssertionError(f"{where}: kernel A at {name}: err {err} > {tol}, or not "
                                 f"the {plan.variant} variant")
        row = {"conv": name + (" dX" if backward else ""), "level": level, "map": which,
               "cin": ci, "cout": co, "k_vol": nbr.shape[1], "n_out": nbr.shape[0],
               "variant": plan.variant, "max_abs_err": err, "tol": tol}
        if timed:
            nnz = int((nbr >= 0).sum())
            rows_read = int(torch.unique(nbr[nbr >= 0]).numel())
            ops_ms = 2.0 * nnz * ci * co / PEAK_BF16_FLOPS * 1e3
            bytes_ms = (rows_read * ci * 2 + nbr.numel() * 4 + nbr.shape[1] * ci * co * 2
                        + nbr.shape[0] * co * 4) / PEAK_BYTES * 1e3
            row.update(ms=graph_ms(lambda: gather_gemm(x, nbr, w), 10),
                       plain_ms=graph_ms(lambda: gather_gemm_plain(x, nbr, w), 3),
                       bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms > bytes_ms else "bytes")
        rows.append(row)
    return rows


def phase_zoo(frag0, gen):
    """SimpleNetBN2C at full width (conv1 k5, 32-d, bf16) through the
    bucketed extractor on a benchmark fragment (ms and launches a fragment:
    C 1, D 1, A 8 of which conv1 cin1, asserted), kernel A at each of its
    convs against the plain version, then ZOO_STEPS training steps on the
    train phase's batch (finite losses; A 30: 28 tensor-core + 2 cin1,
    B 2 a step, asserted)."""
    from imfnet_tpu_torch.geom.ply import read_ply

    cfg = threedmatch_config(model=ZOO_MODEL)
    model = build_model_from_config(cfg, eval_fast=True).cuda().eval()
    raw, n_raw = pad_points_bucketed(read_ply(frag0)["points"].astype(np.float32))
    image = np.zeros((1, cfg.image_H, cfg.image_W, 3), np.float32)
    extract = make_bucketed_extractor(model, config=cfg)
    extract(raw, n_raw, image)                    # the process's first call at this shape
    reset_counts()
    frag_ms = []
    for _ in range(5):
        t = time.perf_counter()
        xyz, feats = extract(raw, n_raw, image)   # numpy: the card has finished
        frag_ms.append((time.perf_counter() - t) * 1e3)
    per_frag = {k: v / 5 for k, v in read_counts().items()}
    choice = extract.last
    norms = np.linalg.norm(feats, axis=1)
    _, _, _, pyr = fragment_tables(cfg, raw, n_raw, choice.extent, choice.bucket)
    convs = hold_conv_list(pyr, ZOO_CONVS, gen, "zoo", timed=True)

    tcfg = cfg.replace(batch_size=TRAIN_BATCH)
    batch = synthetic_batch(np.random.RandomState(0), batch_size=TRAIN_BATCH,
                            n_points=200_000, n_pad=TRAIN_N_PAD,
                            image_hw=(cfg.image_H, cfg.image_W))
    state = create_train_state(train_model(tcfg, "cuda"), tcfg, steps_per_epoch=100)
    step = make_train_step(tcfg, map_impl="search")
    step_gen = torch.Generator(device="cuda").manual_seed(0)
    reset_counts()
    step_ms, losses = [], []
    for _ in range(ZOO_STEPS):
        t = time.perf_counter()
        state, metrics = step(state, batch, step_gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append({k: float(v) for k, v in metrics.items()})
    step_launches = read_counts()
    conv1 = next(c for c in convs if c["conv"] == "conv1")
    emit({"phase": "zoo", "model": ZOO_MODEL, "compute_dtype": cfg.compute_dtype,
          "raw_points": int(n_raw), "voxels": choice.voxels, "bucket": choice.bucket,
          "path": "exact" if choice.extent is None else "grid",
          "fragment_ms": {"median": float(np.median(frag_ms)), "all": frag_ms},
          "launches_per_fragment": per_frag, "descriptor_norm_range": [float(norms.min()),
                                                                       float(norms.max())],
          "convs": convs, "conv1_ms": conv1["ms"], "conv1_plain_ms": conv1["plain_ms"],
          "conv1_bound_ms": conv1["bound_ms"],
          "train_step_ms": step_ms, "train_losses": losses,
          "train_launches_per_step": {k: v / ZOO_STEPS for k, v in step_launches.items()}})
    if per_frag != ZOO_FRAGMENT_LAUNCHES or len(choice.tried) != 1:
        raise AssertionError(f"zoo: a fragment launched {per_frag} (buckets {choice.tried}), "
                             f"want {ZOO_FRAGMENT_LAUNCHES}")
    if not (np.isfinite(feats).all() and np.allclose(norms, 1.0, atol=1e-3)):
        raise AssertionError("zoo: descriptors are not finite unit vectors")
    if [c["variant"] for c in convs] != ["cin1"] + ["tc"] * 7:
        raise AssertionError(f"zoo: kernel A's variants {[c['variant'] for c in convs]}")
    if step_launches != {k: v * ZOO_STEPS for k, v in ZOO_STEP_LAUNCHES.items()}:
        raise AssertionError(f"zoo: {step_launches} over {ZOO_STEPS} steps, "
                             f"want {ZOO_STEP_LAUNCHES} a step")
    if not all(np.isfinite(list(m.values())).all() for m in losses):
        raise AssertionError(f"zoo: a loss is not finite: {losses}")
    return {"fragment": per_frag, "step": {k: v / ZOO_STEPS for k, v in step_launches.items()},
            "convs": convs}


def reference_state_dict(sd, conv1_kernel_size):
    """A port ResUNetIMF state_dict in the released checkpoint's layout: the
    inverse of ``utils.torch_weights.convert_imfnet_torch`` (MinkowskiEngine
    offset order, ``.kernel`` names, residual blocks numbered from 1, the
    torchvision trunk under ``img_encoder.backbone``, PerceiverIO's names
    under ``perceiver_io``)."""
    from imfnet_tpu_torch.utils.torch_weights import me_offset_permutation

    fusion = {"cross_norm_q": "cross_attend_blocks.0.norm",
              "cross_norm_ctx": "cross_attend_blocks.0.norm_context",
              "cross_attn": "cross_attend_blocks.0.fn",
              "cross_ff_norm": "cross_attend_blocks.1.norm",
              "cross_ff.wi": "cross_attend_blocks.1.fn.net.0",
              "cross_ff.wo": "cross_attend_blocks.1.fn.net.2"}
    out = {}
    for key, value in sd.items():
        mod, _, leaf = key.rpartition(".")
        parts = mod.split(".")
        v = value.detach().cpu().clone()
        if parts[0] == "img_encoder":
            sub = parts[1:]
            if sub[0].startswith("layer"):
                layer, block = sub[0].split("_block")
                sub = [layer, block] + [{"down_conv": "downsample.0",
                                         "down_bn": "downsample.1"}.get(sub[1], sub[1])]
            out[".".join(["img_encoder.backbone", *sub, leaf])] = v
        elif parts[0] == "attention_fusion":
            rest = ".".join(parts[1:])
            name = next(fusion[p] + rest[len(p):] for p in sorted(fusion, key=len, reverse=True)
                        if rest == p or rest.startswith(p + "."))
            out[f"perceiver_io.{name}.{leaf}"] = v
        else:
            if parts[0].startswith("block"):   # conv0/norm0 → conv1/norm1
                parts[1] = parts[1][:-1] + str(int(parts[1][-1]) + 1)
            ref = ".".join(parts)
            if leaf == "weight" and v.dim() == 3:
                k = conv1_kernel_size if ref == "conv1" else 3
                me = torch.empty_like(v)
                me[torch.from_numpy(me_offset_permutation(k, reverse=ref.endswith("_tr")))] = v
                out[ref + ".kernel"] = me
            elif leaf == "weight" and v.dim() == 2:
                out[ref + ".kernel"] = v
            else:
                out[f"{ref}.{leaf}"] = v
    return out


def phase_convert(root, scene_dir):
    """A reference-layout .pth of the seeded full-width ResUNetBN2C through
    ``cli convert-imfnet``, then ``generate-desc`` on fragment 0 with the
    converted checkpoint and with the original weights: the descriptors must
    be bit-equal. Returns the converted checkpoint."""
    cfg = threedmatch_config()
    model = build_model_from_config(cfg)
    sd = model.state_dict()
    pth = os.path.join(root, "imfnet.pth")
    ref_sd = reference_state_dict(sd, cfg.conv1_kernel_size)
    n_ref = len(ref_sd)
    torch.save({"state_dict": ref_sd,
                "config": {"model": cfg.model, "model_n_out": cfg.model_n_out,
                           "conv1_kernel_size": cfg.conv1_kernel_size,
                           "normalize_feature": cfg.normalize_feature,
                           "voxel_size": cfg.voxel_size},
                "epoch": 1, "best_val": 0.0, "best_val_epoch": 1,
                "best_val_metric": cfg.best_val_metric}, pth)
    converted = os.path.join(root, "converted")
    reset_counts()
    info, convert_s = run_cli(["convert-imfnet", "--pth", pth, "--out", converted])
    state = torch.load(os.path.join(converted, "state.pt"), weights_only=True)["model"]
    same_tensors = set(state) == set(sd) and all(torch.equal(state[k], sd[k]) for k in sd)
    original = os.path.join(root, "original")
    os.makedirs(original)
    torch.save({"model": sd}, os.path.join(original, "state.pt"))
    with open(os.path.join(converted, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(original, "meta.json"), "w") as f:
        json.dump(meta, f)

    pcloud = os.path.join(root, "one_fragment")
    os.makedirs(os.path.join(pcloud, BENCH_SCENE, "seq-01"))
    os.symlink(os.path.join(scene_dir, "cloud_bin_0.ply"),
               os.path.join(pcloud, BENCH_SCENE, "seq-01", "cloud_bin_0.ply"))
    saved = threedmatch.TEST_SCENE_NAMES
    threedmatch.TEST_SCENE_NAMES = [BENCH_SCENE]
    desc, seconds = {}, {}
    try:
        for name, ckpt in (("converted", converted), ("original", original)):
            _, seconds[name] = run_cli(["generate-desc", "--checkpoint", ckpt, "--pcloud-root",
                                        pcloud, "--out-root", os.path.join(root, "desc_" + name)])
            desc[name] = np.load(os.path.join(root, "desc_" + name, BENCH_SCENE, "seq-01",
                                              "cloud_bin_0.npz"))
    finally:
        threedmatch.TEST_SCENE_NAMES = saved
    launches = read_counts()
    equal = (np.array_equal(desc["converted"]["xyz"], desc["original"]["xyz"])
             and np.array_equal(desc["converted"]["feature"], desc["original"]["feature"]))
    emit({"phase": "convert", "pth_tensors": n_ref,
          "convert": info, "convert_seconds": convert_s, "converted_meta_keys": sorted(meta),
          "state_dict_tensors_equal": same_tensors, "generate_desc_seconds": seconds,
          "descriptors": list(desc["converted"]["feature"].shape),
          "descriptors_bit_equal": equal, "launches": launches})
    if not (same_tensors and equal and meta.get("converted_from") == os.path.abspath(pth)):
        raise AssertionError(f"convert: tensors equal {same_tensors}, descriptors bit-equal "
                             f"{equal}, meta {meta.get('converted_from')}")
    return converted, launches


def phase_dam(root, ckpt, frag0, gen):
    """``cli dam`` at full width on a benchmark fragment with a seeded
    120 x 160 PNG, --point DAM_POINT and --image-out: launches (A 20 for the
    DAM's forward, 20 + 9 dX for the saliency, C 1, D 1), the ms of each
    map, kernel A's dX against its plain version at the fragment's pyramid,
    card against CPU in f32 on 6 000 of its points, and the files."""
    from imfnet_tpu_torch.dam.dam import descriptor_activation_map, image_activation_map
    from imfnet_tpu_torch.geom.image import load_image, process_image, save_image
    from imfnet_tpu_torch.geom.ply import read_ply

    png = os.path.join(root, "dam_image.png")
    save_image(png, np.random.RandomState(8).rand(120, 160, 3))
    out_ply, out_png = os.path.join(root, "dam.ply"), os.path.join(root, "dam.png")
    reset_counts()
    text, cli_s = run_cli(["dam", "--checkpoint", ckpt, "--ply", frag0, "--image", png,
                           "--point", str(DAM_POINT), "--out", out_ply, "--image-out", out_png],
                          text=True)
    cli_launches = read_counts()

    model, cfg = load_model_from_checkpoint(ckpt, torch.device("cuda"))
    points = read_ply(frag0)["points"].astype(np.float32)
    image = process_image(load_image(png), cfg.image_H, cfg.image_W)
    sv, pyr, img, _ = cli.dam_inputs(cfg, points, image, torch.device("cuda"))
    timed = {}
    for name, fn in (("dam", descriptor_activation_map), ("saliency", image_activation_map)):
        fn(model, sv, pyr, img, DAM_POINT)
        torch.cuda.synchronize()
        ms = []
        for _ in range(3):
            reset_counts()
            t = time.perf_counter()
            fn(model, sv, pyr, img, DAM_POINT)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        timed[name] = {"ms": ms, "median_ms": float(np.median(ms)), "launches": read_counts()}
    a_fwd = timed["dam"]["launches"]["sparse_conv_gather_gemm"]
    a_dx = timed["saliency"]["launches"]["sparse_conv_gather_gemm"] - a_fwd
    dx = hold_conv_list(pyr, DAM_DX_CONVS, gen, "dam", backward=True)

    # card against CPU, f32, on a 6 000-point part of the fragment
    small = points[np.random.RandomState(9).choice(len(points), SMALL_FRAGMENT_POINTS,
                                                   replace=False)]
    cfg32 = cfg.replace(compute_dtype="float32")
    maps = {}
    for dev in ("cuda", "cpu"):
        m32 = build_model_from_config(cfg32, eval_fast=True)
        m32.load_state_dict(model.state_dict())
        m32 = m32.to(dev).eval()
        args = cli.dam_inputs(cfg32, small, image, torch.device(dev))[:3]
        maps[dev] = (descriptor_activation_map(m32, *args, DAM_POINT).cpu(),
                     image_activation_map(m32, *args, DAM_POINT).cpu())
    dam_err = float((maps["cuda"][0] - maps["cpu"][0]).abs().max())
    sal_err = float((maps["cuda"][1] - maps["cpu"][1]).abs().max())
    dam_scale, sal_scale = float(maps["cpu"][0].max()), float(maps["cpu"][1].max())

    ply = read_ply(out_ply)
    overlay = load_image(out_png)
    emit({"phase": "dam", "point": DAM_POINT, "voxels": int(sv.num_valid),
          "cli_seconds": cli_s, "cli_launches": cli_launches,
          "dam_ms": timed["dam"]["median_ms"], "saliency_ms": timed["saliency"]["median_ms"],
          "timed": timed, "a_forward_launches": a_fwd, "a_dx_launches": a_dx,
          "a_dx_held": dx,
          "small_f32": {"points": SMALL_FRAGMENT_POINTS, "dam_max_abs_err": dam_err,
                        "dam_scale": dam_scale, "dam_tol": DAM_REL * dam_scale,
                        "saliency_max_abs_err": sal_err, "saliency_scale": sal_scale,
                        "saliency_tol": SALIENCY_REL * sal_scale},
          "ply_points": len(ply["points"]), "ply_has_colors": "colors" in ply,
          "overlay_shape": list(overlay.shape), "cli_output": text.strip().splitlines()})
    want_cli = {"sparse_conv_gather_gemm": 49, "flash_nn": 0, "sorted_compact": 1,
                "word_match": 1 if cfg.use_grid_maps else 0,
                "sparse_conv_gather_gemm.tc": 49, "sparse_conv_gather_gemm.cin1": 0,
                "sparse_conv_gather_gemm.scalar": 0,
                "sparse_conv_gather_gemm.tcw": 0}
    if cli_launches != want_cli or a_fwd != 20 or a_dx != len(DAM_DX_CONVS):
        raise AssertionError(f"dam: launches {cli_launches} (want {want_cli}), A forward "
                             f"{a_fwd}, A dX {a_dx}")
    if not (dam_err <= DAM_REL * dam_scale and sal_err <= SALIENCY_REL * sal_scale
            and dam_scale > 0 and sal_scale > 0):
        raise AssertionError(f"dam: card vs CPU, DAM err {dam_err} (max {dam_scale}), "
                             f"saliency err {sal_err} (max {sal_scale})")
    if len(ply["points"]) != int(sv.num_valid) or "colors" not in ply or \
            overlay.shape != (120, 160, 3):
        raise AssertionError(f"dam: the PLY has {len(ply['points'])} points (want "
                             f"{int(sv.num_valid)}), the overlay {overlay.shape}")
    return cli_launches


def phase_visualize(root, ckpt, scene_dir):
    """``cli visualize`` on benchmark fragments 0 and 1 with seeded images:
    launches per fragment (C 1, D 1, A 20) and per pair (B 2), the fitness
    and the pose; the two views must hold both clouds, coloured, and the
    pose must be finite and rigid."""
    from imfnet_tpu_torch.geom.image import save_image
    from imfnet_tpu_torch.geom.ply import read_ply

    argv = ["visualize", "--checkpoint", ckpt, "--out-dir", os.path.join(root, "views")]
    n_raw = 0
    for k in (0, 1):
        png = os.path.join(root, f"view_{k}.png")
        save_image(png, np.random.RandomState(10 + k).rand(120, 160, 3))
        ply = os.path.join(scene_dir, f"cloud_bin_{k}.ply")
        n_raw += len(read_ply(ply)["points"])
        argv += [f"--ply{k}", ply, f"--image{k}", png]
    reset_counts()
    text, seconds = run_cli(argv, text=True)
    launches = read_counts()
    fitness = float(text.split("fitness ")[1].split(";")[0])
    pose = np.array([float(v) for v in re.findall(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?",
                                                  text.split("\n", 1)[1])]).reshape(4, 4)
    views = {v: read_ply(os.path.join(root, "views", v + ".ply")) for v in ("before", "after")}
    emit({"phase": "visualize", "seconds": seconds, "fitness": fitness, "pose": pose.tolist(),
          "launches": launches, "launches_per_fragment": {
              k: launches[k] / 2 for k in ("sparse_conv_gather_gemm", "sorted_compact",
                                           "word_match")},
          "flash_nn_per_pair": launches["flash_nn"],
          "view_points": {v: len(d["points"]) for v, d in views.items()}})
    want = {"sparse_conv_gather_gemm": 40, "flash_nn": 2, "sorted_compact": 2, "word_match": 2,
            "sparse_conv_gather_gemm.tc": 40, "sparse_conv_gather_gemm.cin1": 0,
            "sparse_conv_gather_gemm.scalar": 0,
            "sparse_conv_gather_gemm.tcw": 0}
    if launches != want:
        raise AssertionError(f"visualize: launches {launches}, want {want}")
    rigid = np.allclose(pose[:3, :3] @ pose[:3, :3].T, np.eye(3), atol=1e-3)
    if not (np.isfinite(pose).all() and rigid and np.allclose(pose[3], [0, 0, 0, 1])
            and 0.0 <= fitness <= 1.0):
        raise AssertionError(f"visualize: pose {pose}, fitness {fitness}")
    for v, d in views.items():
        if len(d["points"]) != n_raw or "colors" not in d:
            raise AssertionError(f"visualize: {v}.ply has {len(d['points'])} points, want "
                                 f"{n_raw}, or no colours")
    return launches


def render_room_depth(cam2world, hw=OFFLINE_HW, K=OFFLINE_K):
    """Depth (z in the camera frame, m) of every pixel looking from inside
    ROOM at its walls and ROOM_BOXES."""
    H, W = hw
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)],
                    -1).reshape(-1, 3)
    d = rays @ cam2world[:3, :3].T
    o = cam2world[:3, 3]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d != 0, 1.0 / d, np.inf)
        t = np.where(d > 0, (ROOM[1] - o) * inv, (ROOM[0] - o) * inv)
        t = np.where(d != 0, t, np.inf).min(axis=1)          # the wall the ray leaves by
        for lo, hi in ROOM_BOXES:
            t1, t2 = (lo - o) * inv, (hi - o) * inv
            near = np.nan_to_num(np.minimum(t1, t2), nan=-np.inf).max(axis=1)
            far = np.nan_to_num(np.maximum(t1, t2), nan=np.inf).min(axis=1)
            hit = (near < far) & (near > 0) & (near < t)
            t = np.where(hit, near, t)
    return t.reshape(H, W).astype(np.float32)


def write_room_sequence(root, n_frames=OFFLINE_FRAMES):
    """A 3DMatch-style sequence: ``n_frames`` 480 x 640 uint16 depth PNGs (mm)
    of the room, seen by a camera that sways and turns through it,
    camera-to-world poses and camera-intrinsics.txt. Returns the scene dir."""
    from PIL import Image

    scene = os.path.join(root, "room")
    seq = os.path.join(scene, "seq-01")
    os.makedirs(seq)
    np.savetxt(os.path.join(scene, "camera-intrinsics.txt"), OFFLINE_K)
    for i in range(n_frames):
        a = 2 * np.pi * i / n_frames
        pose = np.eye(4)
        pose[:3, :3] = axis_angle_rotation(np.array([0.0, 1.0, 0.0]), 0.5 * np.sin(a)) @ \
            axis_angle_rotation(np.array([1.0, 0.0, 0.0]), 0.1 * np.cos(a))
        pose[:3, 3] = [0.4 * np.sin(a), 0.1 * np.cos(2 * a), -0.4 + 0.3 * np.cos(a)]
        depth = render_room_depth(pose)
        Image.fromarray(np.round(depth * 1000).astype(np.uint16)).save(
            os.path.join(seq, f"frame-{i:06d}.depth.png"))
        np.savetxt(os.path.join(seq, f"frame-{i:06d}.pose.txt"), pose)
    return scene


def nearest_gap(a, b):
    """The largest distance from a point of either cloud to the other."""
    from scipy.spatial import cKDTree

    return max(float(cKDTree(b).query(a)[0].max()), float(cKDTree(a).query(b)[0].max()))


def phase_offline(root, gen):
    """fuse-fragments on OFFLINE_FRAMES frames at 256^3 (ms a frame), two
    fragments; the first OFFLINE_CPU_FRAMES frames fused on the card against
    the CPU (point count and nearest-point gap);
    compute-overlap on the six benchmark fragments in the world's frame
    (kernel B at up to 204 000^2 x 3: one launch a pair, held to its plain
    version as in the kitti phase, timed beside its bound and cdist + min),
    its ratios against an f64 KD-tree; compute-radius's seconds."""
    from imfnet_tpu_torch.data.offline import fuse_fragment_frames
    from imfnet_tpu_torch.geom.ply import read_ply
    from imfnet_tpu_torch.utils.native import have_native
    from scipy.spatial import cKDTree

    t = time.perf_counter()
    scene = write_room_sequence(root)
    write_s = time.perf_counter() - t
    frags = os.path.join(root, "fused")
    reset_counts()
    fused, fuse_s = run_cli(["fuse-fragments", "--scene-dir", scene, "--out-dir", frags,
                             "--frames-per-fragment", str(OFFLINE_FRAMES_PER_FRAGMENT)])
    fuse_launches = read_counts()
    seq = os.path.join(scene, "seq-01")
    depths = sorted(os.path.join(seq, f) for f in os.listdir(seq)
                    if f.endswith(".depth.png"))[:OFFLINE_CPU_FRAMES]
    poses = [d[:-len(".depth.png")] + ".pose.txt" for d in depths]
    card, _ = fuse_fragment_frames(depths, poses, OFFLINE_K, device="cuda")
    t = time.perf_counter()
    cpu, _ = fuse_fragment_frames(depths, poses, OFFLINE_K, device="cpu")
    cpu_s = time.perf_counter() - t
    card, cpu = card.astype(np.float32), cpu.astype(np.float32)
    voxel = 6.0 / 256
    gap = nearest_gap(card, cpu)
    count_rel = abs(len(card) - len(cpu)) / len(cpu)

    pcloud, _, _ = write_benchmark_scene(os.path.join(root, "world"), world_frame=True)
    world_dir = os.path.join(pcloud, BENCH_SCENE, "seq-01")
    reset_counts()
    overlap, overlap_s = run_cli(["compute-overlap", "--fragments-dir", world_dir,
                                  "--out-dir", os.path.join(root, "overlap")])
    overlap_launches = read_counts()
    pts = [read_ply(os.path.join(world_dir, f"cloud_bin_{k}.ply"))["points"].astype(np.float32)
           for k in range(BENCH_FRAGMENTS)]
    ref = []
    for i in range(BENCH_FRAGMENTS):
        tree = cKDTree(pts[i].astype(np.float64))
        for j in range(i + 2, BENCH_FRAGMENTS):
            dd, _ = tree.query(pts[j].astype(np.float64))
            ratio = float((dd <= 0.075).sum()) / max(len(pts[i]), len(pts[j]))
            if ratio >= 0.3:
                ref.append([f"cloud_bin_{i}", f"cloud_bin_{j}", ratio])
    ratio_err = max((abs(a[2] - b[2]) for a, b in zip(overlap["pairs"], ref)), default=0.0)
    q, r = torch.from_numpy(pts[2]).cuda(), torch.from_numpy(pts[0]).cuda()
    b_entry = kernel_b_entry("overlap 204 000^2 x 3", q, r,
                             torch.ones(len(r), dtype=torch.bool, device="cuda"), "offline")

    radius, radius_s = run_cli(["compute-radius", "--fragments-dir", frags])
    radii = [np.load(f) for f in radius["radius_files"]]
    emit({"phase": "offline", "have_native": have_native(),
          "voxel_dedup": "native" if have_native() else "numpy fallback",
          "frames": OFFLINE_FRAMES, "hw": list(OFFLINE_HW), "write_seconds": write_s,
          "fuse_seconds": fuse_s, "fuse_ms_per_frame": fuse_s * 1e3 / OFFLINE_FRAMES,
          "fragments": len(fused["fragments"]), "fuse_launches": fuse_launches,
          "cpu_frames": OFFLINE_CPU_FRAMES, "cpu_frames_points": {"card": len(card), "cpu": len(cpu)},
          "cpu_fuse_seconds": cpu_s, "count_rel": count_rel,
          "count_rel_tol": FUSE_COUNT_REL, "nearest_gap_m": gap,
          "nearest_gap_tol_m": FUSE_DIST_VOXELS * voxel,
          "overlap_seconds": overlap_s, "overlap_pairs": overlap["pairs"],
          "overlap_kdtree_pairs": ref, "overlap_ratio_max_err": ratio_err,
          "overlap_launches": overlap_launches,
          "radius_seconds": radius_s, "radius_points": [len(x) for x in radii],
          "radius_median": [float(np.median(x)) for x in radii]})
    if len(fused["fragments"]) != 2 or count_rel > FUSE_COUNT_REL or \
            gap > FUSE_DIST_VOXELS * voxel or len(cpu) < 10_000:
        raise AssertionError(f"offline: {len(fused['fragments'])} fragments; card vs CPU "
                             f"{len(card)} / {len(cpu)} points, gap {gap} m")
    n_pairs = BENCH_FRAGMENTS * (BENCH_FRAGMENTS - 1) // 2 - (BENCH_FRAGMENTS - 1)
    if overlap_launches["flash_nn"] != n_pairs or \
            [p[:2] for p in overlap["pairs"]] != [p[:2] for p in ref] or \
            ratio_err > OVERLAP_RATIO_ATOL or not overlap["pairs"]:
        raise AssertionError(f"offline: overlap pairs {overlap['pairs']} against the KD-tree's "
                             f"{ref}, kernel B launches {overlap_launches['flash_nn']}")
    if len(radii) != 2 or not all(np.isfinite(x).all() and (x > 0).mean() > 0.9 for x in radii):
        raise AssertionError("offline: radii missing, not finite or mostly zero")
    return fuse_launches, overlap_launches, b_entry


def phase_slice8(gen, kernels):
    """zoo, convert, dam, visualize and offline on one benchmark scene;
    each kernel's launches on these paths go into its ``kernels`` entry."""
    with tempfile.TemporaryDirectory(prefix="slice8_") as root:
        pcloud, _, _ = write_benchmark_scene(root)
        scene_dir = os.path.join(pcloud, BENCH_SCENE, "seq-01")
        frag0 = os.path.join(scene_dir, "cloud_bin_0.ply")
        zoo = phase_zoo(frag0, gen)
        ckpt, convert_launches = phase_convert(root, scene_dir)
        dam_launches = phase_dam(root, ckpt, frag0, gen)
        vis_launches = phase_visualize(root, ckpt, scene_dir)
        fuse_launches, overlap_launches, overlap_nn = phase_offline(root, gen)
    for kern in kernels:
        name = kern["name"]
        kern.update({"zoo_launches_per_fragment": zoo["fragment"][name],
                     "zoo_launches_per_step": zoo["step"][name],
                     "convert_generate_desc_launches": convert_launches[name],
                     "dam_launches": dam_launches[name],
                     "visualize_launches": vis_launches[name],
                     "fuse_launches": fuse_launches[name],
                     "overlap_launches": overlap_launches[name]})
        if name == "flash_nn":
            kern.update({f"overlap_{k}": overlap_nn[k]
                         for k in ("n", "m", "d", "fold", "max_abs_err", "ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by")})
        if name == "sparse_conv_gather_gemm":
            conv1 = next(c for c in zoo["convs"] if c["conv"] == "conv1")
            kern.update({"zoo_max_abs_err": max(c["max_abs_err"] for c in zoo["convs"]),
                         "zoo_conv1_variant": conv1["variant"], "zoo_conv1_ms": conv1["ms"],
                         "zoo_conv1_plain_ms": conv1["plain_ms"],
                         "zoo_conv1_bound_ms": conv1["bound_ms"]})


def forward_pair_eval(model, batch, cfg):
    with torch.no_grad():
        return forward_pair(model, batch, train=False, config=cfg)


def kernel_b_entry(case, q, r, v, phase, chunk=8192, sweep=False):
    """Kernel B against its plain version on one input (``nn_compare``,
    indices by their exact distance), graph-timed, with its plain time,
    ``cdist`` + ``min`` in chunks of queries, and its bound.

    |q|² + |r|² − 2 q·r in f32 cancels to an error that grows with the
    squared norms, so coordinates of tens of metres hold d² to NN_D2_REL of
    the largest (3.5e-3 on KITTI's scans, |x|² up to 3 516). The exact distance of the
    choice is held to twice that: both versions choose in f32, and where
    every candidate's d² is within e of its exact value, the chosen one's
    exact d² is within 2e of the nearest's. With ``sweep``, also every
    tile at split 1 and 2 (``nn_sweep``)."""
    scale = max(float((q * q).sum(1).max()), float((r * r).sum(1).max()))
    tols = dict(tol=max(NN_D2_ATOL, NN_D2_REL * scale),
                gap_tol=max(NN_D2_ATOL, 2 * NN_D2_REL * scale))
    held = nn_compare(case, q, r, v, same_index=False, **tols)
    n, m, d = q.shape[0], r.shape[0], q.shape[1]

    def library():
        """cdist + min, a chunk of queries at a time (the whole distance
        matrix would be tens of GB)."""
        best = [torch.cdist(q[i:i + chunk], r).masked_fill(~v[None], float("inf")).min(dim=1)
                for i in range(0, n, chunk)]
        return torch.cat([b.indices for b in best]), torch.cat([b.values for b in best])

    ops, nbytes = 2.0 * n * m * d, (q.numel() + r.numel()) * 4 + m + n * 8
    plan = nn_plan(n, m, d)
    entry = {"case": case, "n": n, "m": m, "d": d, **held, "fold": plan.fold,
             "tile": [plan.bq, plan.br], "threads": plan.threads,
             "split": plan.split, "blocks": plan.blocks(n),
             "ms": graph_ms(lambda: flash_nn(q, r, v), 5),
             "plain_ms": cuda_ms(lambda: nn_plain(q, r, v), 2, warmup=1),
             "library_ms": cuda_ms(library, 2, warmup=1),
             "bound_ms": max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3,
             "bound_by": "operations" if ops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES else "bytes"}
    entry["x_bound"] = entry["ms"] / entry["bound_ms"]
    if sweep:
        entry["sweep_best"] = nn_sweep(q, r, v, phase, splits=(1, 2), iters=5, **tols)["best"]
    emit({"phase": phase, "kernel": "flash_nn", **entry})
    return entry


# ---- data parallelism, sharded evaluation, the grid builders ------------

DP_STEPS = 3                  # steps of each DP comparison; the first is a warm-up for times
# two ranks on one card against the emulation in this process: the largest
# |rank - emulation| of a tensor over its largest entry. Both run the same
# kernels on the same card; the ranks' sums over ranks run on the host (gloo)
DP_EMUL_REL = 1e-5
SHARED_CARD = ["cuda:0", "cuda:0"]   # two ranks on the one card, over gloo
# the DP trainer run: 4 batches of 2 pairs, 2 steps a rank an epoch, one
# validation pair an epoch; 50 000 points a fragment keep the loader short
DP_TRAINER_RUN = dict(synthetic_length=8, synthetic_n_points=50_000, val_max_iter=1)
# fault 4's run: 4 batches of 2 pairs, 2 steps a rank, rank 1 rejecting a pair
REJECTING_RUN = dict(synthetic_length=8, synthetic_n_points=50_000, max_epoch=1)
BUILDERS = ("search", "banded")
BUILDER_ROUNDS = 5


def arrays_gap(got, want, where):
    """(bit-equal, the largest |got - want| of a tensor over its largest
    |want|) over the module tensors and momentum of two train states."""
    equal, worst = True, 0.0
    for part in ("model", "momentum"):
        if got[part].keys() != want[part].keys():
            raise AssertionError(f"{where}: {part} holds other tensors")
        for k, w in want[part].items():
            g = got[part][k]
            if torch.equal(g, w):
                continue
            equal = False
            if not w.is_floating_point():
                worst = float("inf")
                continue
            scale = max(float(w.double().abs().max()), 1e-12)
            worst = max(worst, float((g.double() - w.double()).abs().max()) / scale)
    return equal, worst


def launches_per(counts, steps):
    return {k: v / max(steps, 1) for k, v in counts.items() if k != "steps"}


def phase_dp_one_rank(cfg, batch):
    """Data parallelism at the Train step cell's width (``bench_config``, the
    search builder), in this process. One rank over NCCL: DP_STEPS steps
    from a copy of one start equal DP_STEPS plain steps bit for bit
    (parameters, buffers, momentum), both timed, interleaved; one more DP
    step under the profiler gives the all-reduce's kernels. Returns what
    ``phase_ranks`` needs for the two ranks: this part's readings, the
    start, the ranks' batches (host copies: no CUDA tensor crosses a
    process) and the plain step's ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch1 = synthetic_batch(np.random.RandomState(1), batch_size=TRAIN_BATCH,
                             n_points=200_000, n_pad=TRAIN_N_PAD,
                             image_hw=(cfg.image_H, cfg.image_W))
    start = {k: v.detach().clone() for k, v in train_model(cfg, "cpu").state_dict().items()}

    # ---- one rank over NCCL against the plain step, interleaved
    mesh = make_mesh(devices=["cuda:0"])
    if mesh.backend != "nccl" or mesh.world_size != 1:
        raise AssertionError(f"dp: one rank on its own card is not NCCL: {mesh}")
    try:
        runs = {}
        for name, m in (("plain", None), ("dp", mesh)):
            model = train_model(cfg, "cuda")
            model.load_state_dict(start)
            runs[name] = {"state": create_train_state(model, cfg, steps_per_epoch=100),
                          "step": make_train_step(cfg, map_impl="search", mesh=m),
                          "gen": dp.rank_generator(cfg.seed, 0, "cuda"), "ms": [],
                          "loss": []}
        for _ in range(DP_STEPS):
            for r in runs.values():
                t = time.perf_counter()
                r["state"], metrics = r["step"](r["state"], batch, r["gen"])
                r["loss"].append(float(metrics["loss"]))
                r["ms"].append((time.perf_counter() - t) * 1e3)
        one_equal, one_gap = arrays_gap(dp.train_state_arrays(runs["dp"]["state"]),
                                        dp.train_state_arrays(runs["plain"]["state"]), "dp nccl")
        if not one_equal or runs["dp"]["loss"] != runs["plain"]["loss"]:
            raise AssertionError(f"dp: one NCCL rank differs from the plain step: {one_gap}, "
                                 f"losses {runs['dp']['loss']} / {runs['plain']['loss']}")
        model = runs["dp"]["state"].model
        reduced_bytes = 4 * (sum(p.numel() for p in model.parameters())
                             + sum(b.numel() for b in model.buffers() if b.is_floating_point()))
        torch.cuda.synchronize()
        r = runs["dp"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            r["state"], _ = r["step"](r["state"], batch, r["gen"])
            torch.cuda.synchronize()
        nccl = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()]
        nccl_ms = sum(e.device_time_total for e in nccl) / 1e3
        # the averaging alone (flatten, all-reduce, divide, copy back), on
        # the gradients of one more backward
        loss, metrics = make_loss_fn(model, cfg, "search")(batch, r["gen"])
        loss.backward()
        average_ms, _ = host_ms(lambda: mean_step_over_ranks(model, metrics, mesh), 5)
        model.zero_grad(set_to_none=True)
        plain_ms = float(np.median(runs["plain"]["ms"][1:]))
        one = {"backend": mesh.backend, "steps": DP_STEPS, "bit_equal": one_equal,
               "losses": runs["dp"]["loss"],
               "step_ms": {k: r["ms"] for k, r in runs.items()},
               "step_ms_median_after_first": {k: float(np.median(r["ms"][1:]))
                                              for k, r in runs.items()},
               "all_reduce_bytes": reduced_bytes, "all_reduce_ms": nccl_ms,
               "average_step_host_ms": average_ms,
               "all_reduce_kernels": [[e.key[:60], e.count, e.device_time_total / 1e3]
                                      for e in nccl]}
    finally:
        close_mesh()
    del runs, model, r
    torch.cuda.empty_cache()

    groups = [[PairBatch(*(None if t is None else t.cpu() for t in b)) for b in (batch, batch1)]
              ] * DP_STEPS
    return {"one": one, "start": start, "groups": groups, "plain_ms": plain_ms}


def dp_rank_calls(cfg, ctx, out_dir):
    """The ranks' data-parallel calls: DP_STEPS steps, then the DP
    trainer's two epochs against one, a checkpoint and a resume, each with
    its loaders in threads (a worker's start would outweigh 2-step
    epochs; the rejecting run takes the card's worker)."""
    base = bench_config().replace(
        batch_size=TRAIN_BATCH, val_batch_size=1, dataset="SyntheticPairDataset",
        max_points=TRAIN_N_PAD, stat_freq=1, data_parallel=2, **DP_TRAINER_RUN)
    first = base.replace(out_dir=os.path.join(out_dir, "split"), max_epoch=1)
    return [(dp.run_dp_steps, (cfg, ctx["start"], ctx["groups"], "search", 100)),
            (dp.run_trainer, (base.replace(out_dir=os.path.join(out_dir, "whole"), max_epoch=2),
                              None, True, None, 0)),
            (dp.run_trainer, (first, None, False, None, 0)),
            (dp.run_trainer, (first.replace(max_epoch=2), None, True, first.out_dir, 0))]


def phase_dp(cfg, ctx, ranks, spawn_s, names):
    """Two ranks sharing the card over gloo, each on its own batch (``ranks``:
    their ``dp_rank_calls`` results): DP_STEPS steps equal
    make_emulated_dp_step on the same batches and draws within DP_EMUL_REL,
    both ranks bit-equal, each launching TRAIN_LAUNCHES a step. Then
    Trainer.train() (DP_TRAINER_RUN): two epochs against one, a checkpoint
    and a resume, bit for bit on each rank, each training step
    TRAINER_STEP_LAUNCHES and validation step TRAINER_VAL_LAUNCHES. Emits
    the ``dp`` line with ``phase_dp_one_rank``'s readings; returns (launches
    per rank and step, the trainer's launches per training and validation
    step)."""
    one, start, groups, plain_ms = ctx["one"], ctx["start"], ctx["groups"], ctx["plain_ms"]
    steps = [r[0][0] for r in ranks]
    whole = [r[1][0] for r in ranks]
    whole_s = max(r[1][1] for r in ranks)
    resumed = [r[3][0] for r in ranks]
    model = train_model(cfg, "cuda")
    model.load_state_dict(start)
    state = create_train_state(model, cfg, steps_per_epoch=100)
    gens = [dp.rank_generator(cfg.seed, d, "cuda") for d in range(2)]
    emulate = dp.make_emulated_dp_step(cfg, 2, map_impl="search")
    emul_losses = []
    for group in groups:
        state, metrics = emulate(state, [batch_to_device(b, torch.device("cuda"))
                                         for b in group], gens)
        emul_losses.append(float(metrics["loss"]))
    want = dp.train_state_arrays(state)
    del state, model
    torch.cuda.empty_cache()
    ranks_equal, ranks_gap = arrays_gap(steps[1], steps[0], "rank 1 vs rank 0")
    emul_equal, emul_gap = arrays_gap(steps[0], want, "ranks vs emulation")
    rank_launches = steps[0]["launches"]
    two_ms = float(np.median([max(a, b) for a, b in zip(steps[0]["ms"][1:], steps[1]["ms"][1:])]))
    two = {"backend": mesh_backend(SHARED_CARD), "devices": SHARED_CARD, "steps": DP_STEPS,
           "ranks_bit_equal": ranks_equal, "emulation_bit_equal": emul_equal,
           "emulation_max_rel_err": emul_gap, "emulation_tol": DP_EMUL_REL,
           "losses": [m["loss"] for m in steps[0]["metrics"]], "emulation_losses": emul_losses,
           "step_ms": [r["ms"] for r in steps], "step_ms_median_after_first": two_ms,
           "spawn_seconds": spawn_s, "launches_per_rank_step": [r["launches"] for r in steps],
           "batches_per_s": {"two_ranks": 2 * 1e3 / two_ms, "one_rank_plain": 1e3 / plain_ms},
           "dp_steps_per_s": {"two_ranks": 1e3 / two_ms}}
    if not ranks_equal or emul_gap > DP_EMUL_REL or \
            any(r["launches"] != TRAIN_LAUNCHES for r in steps):
        raise AssertionError(f"dp: two ranks (equal {ranks_equal}) against the emulation "
                             f"{emul_gap} > {DP_EMUL_REL}, or launches "
                             f"{[r['launches'] for r in steps]} != {TRAIN_LAUNCHES}")

    gaps = [arrays_gap(resumed[r], whole[r], f"rank {r}: resumed vs whole") for r in range(2)]
    wr_equal, _ = arrays_gap(whole[1], whole[0], "trainer rank 1 vs rank 0")
    train_counts = whole[0]["launches"]["train"]
    val_counts = whole[0]["launches"]["val"]
    trainer = {"backend": mesh_backend(SHARED_CARD), "devices": SHARED_CARD,
               "config": {**DP_TRAINER_RUN, "max_epoch": 2},
               "steps": [r["step"] for r in whole], "seconds_whole": whole_s,
               "resume_bit_equal": [g[0] for g in gaps],
               "resume_max_rel_err": [g[1] for g in gaps], "ranks_bit_equal": wr_equal,
               "launches_per_train_step": [launches_per(r["launches"]["train"],
                                                        r["launches"]["train"]["steps"])
                                           for r in whole],
               "launches_per_val_step": [launches_per(r["launches"]["val"],
                                                      r["launches"]["val"]["steps"])
                                         for r in whole],
               "split_run_files": names}
    emit({"phase": "dp", "one_rank": one, "two_ranks": two, "trainer": trainer})
    if not all(g[0] for g in gaps) or not wr_equal or any(
            launches_per(r["launches"]["train"], r["launches"]["train"]["steps"])
            != TRAINER_STEP_LAUNCHES
            or launches_per(r["launches"]["val"], r["launches"]["val"]["steps"])
            != TRAINER_VAL_LAUNCHES for r in whole):
        raise AssertionError(f"dp: the resumed DP trainer differs ({gaps}), its ranks differ, "
                             f"or its launches are off: {trainer['launches_per_train_step']}, "
                             f"{trainer['launches_per_val_step']}")
    return rank_launches, launches_per(train_counts, train_counts["steps"]), \
        launches_per(val_counts, val_counts["steps"])


def sharded_inputs(root):
    """The Benchmark cell's six fragments and the KITTI cell's three pairs
    under ``root`` (ground truth refined into the ICP cache), a checkpoint
    of random weights for each, and ``calls(name)``: generate-desc and
    eval-kitti through the CLI's rank functions, each timed on a second
    call in its process (the first holds the warm-up), writing under
    ``root/name``. The split lists ride along to the ranks; this process's
    KITTI test list is the new one until the caller restores ``saved``."""
    pcloud, _, _ = write_benchmark_scene(root)
    for scene in threedmatch.TEST_SCENE_NAMES:      # the walk's other scenes: empty
        os.makedirs(os.path.join(pcloud, scene, "seq-01"), exist_ok=True)
    cfg = bench_config()
    ckpt = save_checkpoint(root, "checkpoint",
                           create_train_state(build_model_from_config(cfg), cfg, 1), cfg,
                           1, 0.0, 1, cfg.best_val_metric)
    kroot = os.path.join(root, "kitti")
    write_kitti_scans(kroot)
    kcfg = kitti_config(dataset="KITTIPairDataset", kitti_root=kroot, kitti_max_time_diff=3)
    kckpt = save_checkpoint(kroot, "checkpoint",
                            create_train_state(build_model_from_config(kcfg), kcfg, 1), kcfg,
                            1, 0.0, 1, kcfg.best_val_metric)
    saved = dict(KITTIPairDataset.DATA_FILES)
    KITTIPairDataset.DATA_FILES["test"] = os.path.join(kroot, "test_list.txt")
    dset = KITTIPairDataset("test", kcfg, random_rotation=False, random_scale=False,
                            icp_device="cuda")
    for i in range(len(dset)):            # the ICP cache, for every run
        dset[i]
    splits = cli._split_lists()

    def calls(name):
        args, warm = (argparse.Namespace(checkpoint=ckpt, pcloud_root=pcloud,
                                         out_root=os.path.join(root, out))
                      for out in (name, name + "_warm_up"))
        kargs = argparse.Namespace(checkpoint=kckpt, kitti_root=kroot)
        return [(dp.call_counted, (cli._generate_desc_rank, (args,), (warm,))),
                (dp.call_counted, (cli._eval_kitti_rank, (kargs, splits), (kargs, splits)))]

    return calls, saved


def phase_sharded(root, one, two, spawn_s):
    """generate-desc and eval-kitti on two ranks sharing the card over gloo
    (``two``: each rank's ``sharded_inputs`` calls; the CLI itself refuses
    two ranks on one card) against rank 0 alone in the same processes
    (``one``, the serial path). fragments/s and pairs/s come from the whole call's
    seconds (the slowest rank's); generate-desc's "All Time" ratio is given
    beside them. Fails unless every file equals the one rank's (xyz exact,
    descriptors within GRID_DESC_ATOL), the KITTI summaries are equal, and
    the launches add up to FRAGMENT_LAUNCHES a fragment and
    KITTI_PAIR_LAUNCHES a pair."""
    runs = {name: [[rank[j][0] for rank in ranks] for j in range(2)]
            for name, ranks in (("one_rank", one), ("two_ranks", two))}
    devices = {"one_rank": SHARED_CARD[:1], "two_ranks": SHARED_CARD}

    def summary(name, j, unit):
        ranks = runs[name][j]
        call_s = max(r[2] for r in ranks)
        result = ranks[0][0]
        n = result["count"] if j == 0 else result["num_pairs"]
        return {"backend": "none" if name == "one_rank" else mesh_backend(devices[name]),
                "devices": devices[name],
                "stats" if j == 0 else "summary": result,
                "launches": {k: sum(r[1][k] for r in ranks) for k in ranks[0][1]},
                "call_seconds": call_s, f"{unit}_per_s": n / call_s}

    out = {}
    gd = {name: summary(name, 0, "fragments") for name in runs}
    for r in gd.values():
        r["fragments_per_s_all_time"] = r["stats"]["count"] / r["stats"]["all_time"]
    scene = os.path.join(BENCH_SCENE, "seq-01")
    worst = 0.0
    for k in range(BENCH_FRAGMENTS):
        a, b = (np.load(os.path.join(root, name, scene, f"cloud_bin_{k}.npz"))
                for name in ("one_rank", "two_ranks"))
        if not (np.array_equal(a["xyz"], b["xyz"]) and np.array_equal(a["points"], b["points"])):
            raise AssertionError(f"sharded: fragment {k}'s voxels differ")
        worst = max(worst, float(np.abs(a["feature"] - b["feature"]).max()))
    want = {k: (BENCH_FRAGMENTS - 1) * FRAGMENT_LAUNCHES["grid"][k]
            + FRAGMENT_LAUNCHES["exact"][k] for k in FRAGMENT_LAUNCHES["grid"]}
    out["generate_desc"] = {**gd, "descriptor_max_abs_err": worst,
                            "descriptor_tol": GRID_DESC_ATOL, "launches_want": want,
                            "two_over_one": {
                                "call_seconds": gd["two_ranks"]["fragments_per_s"]
                                / gd["one_rank"]["fragments_per_s"],
                                "all_time": gd["two_ranks"]["fragments_per_s_all_time"]
                                / gd["one_rank"]["fragments_per_s_all_time"]}}
    if worst > GRID_DESC_ATOL or gd["two_ranks"]["stats"]["count"] != BENCH_FRAGMENTS or \
            any(r["launches"] != want for r in gd.values()):
        raise AssertionError(f"sharded: generate-desc {out['generate_desc']}")
    ek = {name: summary(name, 1, "pairs") for name in runs}
    n_pairs = ek["one_rank"]["summary"]["num_pairs"]
    want = {k: v * n_pairs for k, v in KITTI_PAIR_LAUNCHES.items()}
    out["eval_kitti"] = {**ek, "launches_want": want,
                         "two_over_one": ek["two_ranks"]["pairs_per_s"]
                         / ek["one_rank"]["pairs_per_s"]}
    if ek["one_rank"]["summary"] != ek["two_ranks"]["summary"] or n_pairs < 1 or \
            any(r["launches"] != want for r in ek.values()):
        raise AssertionError(f"sharded: eval-kitti {out['eval_kitti']}")
    emit({"phase": "sharded", "spawn_seconds": spawn_s, **out})
    return {"generate_desc": gd["two_ranks"]["launches"],
            "eval_kitti": ek["two_ranks"]["launches"]}


class RejectingPairs(SyntheticPairDataset):
    """Synthetic pairs, of which those in ``reject`` are rejected as a
    KITTI dataset rejects a pair with too few ground-truth matches."""

    def __init__(self, phase, config, reject=(), **kw):
        super().__init__(phase, config, **kw)
        self.reject = set(reject)

    def __getitem__(self, idx):
        if idx in self.reject:
            raise ValueError(f"pair {idx} rejected")
        return super().__getitem__(idx)


def run_rejecting_trainer(mesh, config, reject):
    """Rank function: ``Trainer.train()`` on the rank's shard of a train
    split whose dataset rejects the pairs in ``reject[rank]`` (the loader of
    the card's default, a worker process). Returns the rank's optimizer
    steps, steps an epoch, rejections and the pairs of each batch it took."""
    loader = make_data_loader(config, "train", config.batch_size, device=mesh.device)
    loader.dataset = RejectingPairs("train", config, reject=reject[mesh.rank])
    loader.dataset.reset_seed(config.seed)
    trainer = Trainer(config, loader, None, mesh=mesh)
    pairs, take = [], trainer._next_batch

    def next_batch(it):
        batch = take(it)
        pairs.append(int(batch.T_gt.shape[0]))
        return batch

    trainer._next_batch = next_batch
    trainer.train()
    return {"steps": trainer.state.step, "steps_per_epoch": len(loader),
            "rejected": loader.skip_count, "workers": loader.workers, "batch_pairs": pairs}


def rejecting_call(out_dir):
    """The ranks' run of fault 4: REJECTING_RUN on two ranks, rank 1's
    dataset rejecting both pairs of its first batch, so that a loader that
    only skipped them would leave rank 1 a batch short of rank 0."""
    cfg = bench_config().replace(
        batch_size=TRAIN_BATCH, dataset="SyntheticPairDataset", max_points=TRAIN_N_PAD,
        data_parallel=2, out_dir=out_dir, **REJECTING_RUN)
    order = np.random.RandomState(cfg.seed).permutation(cfg.synthetic_length)
    # rank 1 of 2 takes batch 1 first: places batch_size .. 2 batch_size - 1
    reject = {0: (), 1: tuple(int(i) for i in order[cfg.batch_size:2 * cfg.batch_size])}
    return (run_rejecting_trainer, (cfg, reject)), reject


def phase_rejecting_ranks(results, reject):
    """Fault 4 on two ranks (``results``: each rank's ``run_rejecting_trainer``
    result): the run ended, with both ranks at their loader's steps an
    epoch times the epochs, every batch either took full, and rank 1's
    rejections counted."""
    epochs = REJECTING_RUN["max_epoch"]
    entry = {"phase": "rejecting_ranks", "devices": SHARED_CARD, **REJECTING_RUN,
             "rejected_pairs": reject, "ranks": results}
    emit(entry)
    steps = [r["steps"] for r in results]
    if (steps[0] != steps[1] or any(r["steps"] != r["steps_per_epoch"] * epochs for r in results)
            or results[1]["rejected"] < len(reject[1]) or results[0]["rejected"] != 0
            or any(p != TRAIN_BATCH for r in results for p in r["batch_pairs"])):
        raise AssertionError(f"rejecting_ranks: {results}")
    return entry


def phase_ranks(cfg, ctx):
    """Every path of two ranks sharing the card over gloo, in one pair of
    new processes (``dp.run_calls``): the ``dp_rank_calls``, then the
    ``sharded_inputs`` calls on rank 0 alone (``dp.solo``: the one-rank
    reference, the serial path) and on both ranks. Emits the ``dp`` and
    ``sharded`` lines; returns ``phase_dp``'s and ``phase_sharded``'s
    launches."""
    with tempfile.TemporaryDirectory(prefix="ranks_") as root:
        calls, saved = sharded_inputs(os.path.join(root, "sharded"))
        try:
            dp_calls = dp_rank_calls(cfg, ctx, os.path.join(root, "dp_trainer"))
            one = [(dp.solo, c) for c in calls("one_rank")]
            rejecting, reject = rejecting_call(os.path.join(root, "rejecting"))
            t = time.perf_counter()
            ranks = spawn_ranks(dp.run_calls, SHARED_CARD,
                                (dp_calls + one + calls("two_ranks") + [rejecting],))
            spawn_s = time.perf_counter() - t
        finally:
            KITTIPairDataset.DATA_FILES.clear()
            KITTIPairDataset.DATA_FILES.update(saved)
        names = sorted(os.path.basename(d)
                       for d in glob.glob(os.path.join(root, "dp_trainer", "split", "*")))
        n, m = len(dp_calls), len(dp_calls) + len(one)
        dp_launches = phase_dp(cfg, ctx, [r[:n] for r in ranks], spawn_s, names)
        sharded_launches = phase_sharded(os.path.join(root, "sharded"), [ranks[0][n:m]],
                                         [r[m:-1] for r in ranks], spawn_s)
        phase_rejecting_ranks([r[-1][0] for r in ranks], reject)
    return dp_launches, sharded_launches


def phase_builders(pair, rounds=BUILDER_ROUNDS):
    """Both pyramid builders on the bench-scale pair, each through a
    PairRegistrar with kernel C's quantize (the same weights): tables bit
    for bit equal to the search builder's, launches per pair (A 20, B 2,
    C 1, and D 1 for "banded" alone), and, interleaved round by round, the
    pyramid's ms on one quantized pair and the whole pair's latency."""
    regs = {b: PairRegistrar(compact_impl="kernel", map_impl=b) for b in BUILDERS}
    args = (pair.xyz0, pair.xyz1, pair.image0, pair.image1, pair.T_gt, np.eye(6))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = regs["search"].quantize(regs["search"].prepare(*args[:4]))
    tables, launches = {}, {}
    for b, reg in regs.items():
        float(reg(*args, generator=gen)["rte"])          # warm-up
        tables[b] = pyramid_tables(reg.pyramid(q))
        reset_counts()
        float(reg(*args, generator=gen)["rte"])
        launches[b] = read_counts()
    ref = tables["search"]
    differ = {b: [k for k in ref if k not in t or not torch.equal(t[k], ref[k])]
              for b, t in tables.items()}
    pyr_ms, pair_ms = ({b: [] for b in BUILDERS} for _ in range(2))
    for _ in range(rounds):
        for b, reg in regs.items():
            ms, _ = host_ms(lambda: reg.pyramid(q), 1)
            pyr_ms[b].append(ms)
            t = time.perf_counter()
            float(reg(*args, generator=gen)["rte"])
            pair_ms[b].append((time.perf_counter() - t) * 1e3)
    want = {b: dict(GRID_LAUNCHES, word_match=int(b == "banded")) for b in BUILDERS}
    emit({"phase": "builders", "compact_impl": "kernel", "rounds": rounds,
          "order": list(BUILDERS), "tables": len(ref),
          "tables_differing": differ, "launches_per_pair": launches,
          "pyramid_ms": pyr_ms, "pyramid_ms_median": {b: float(np.median(v))
                                                       for b, v in pyr_ms.items()},
          "pair_ms": pair_ms, "pair_ms_median": {b: float(np.median(v))
                                                 for b, v in pair_ms.items()}})
    if any(differ.values()) or launches != want:
        raise AssertionError(f"builders: tables differ {differ} or launches {launches} "
                             f"!= {want}")
    del regs
    torch.cuda.empty_cache()
    return launches


def phase_roofline(reg, pyr, kernel_a, stages):
    """``sparse/roofline.py`` on the bench-scale pyramid: its bytes of the
    20 kernel-A convs equal the kernel phase's (conv by conv through the
    maps), and the forward's bytes over its ms as a share of PEAK_BYTES."""
    calls = forward_convs(reg.model, pyr)
    per_conv = [(c.name, conv_traffic_bytes(c.n_out, c.n_in, c.k, c.cin, c.cout,
                                            occupancy=c.occupancy, nbr=c.nbr)) for c in calls]
    a_convs = [b for c, (_, b) in zip(calls, per_conv) if c.k > 1 and not c.occupancy]
    total = forward_hbm_bytes(reg.model, pyr)
    fwd_ms = stages["forward_ms"]
    entry = {"phase": "roofline", "convs": len(calls), "kernel_a_convs": len(a_convs),
             "kernel_a_bytes": sum(a_convs), "kernel_phase_bytes": kernel_a["bytes"],
             "forward_bytes": total, "per_conv_bytes": per_conv,
             "forward_ms": fwd_ms,
             "forward_bytes_per_s_share_of_peak": total / (fwd_ms / 1e3) / PEAK_BYTES,
             "kernel_a_ms": kernel_a["ms"],
             "kernel_a_bytes_per_s_share_of_peak":
                 kernel_a["bytes"] / (kernel_a["ms"] / 1e3) / PEAK_BYTES,
             "kernel_a_bound_ms": kernel_a["bound_ms"], "peak_bytes_per_s": PEAK_BYTES}
    emit(entry)
    if len(a_convs) != len(MAIN_PATH_CONVS) or sum(a_convs) != kernel_a["bytes"]:
        raise AssertionError(f"roofline: the model's kernel-A bytes {sum(a_convs)} over "
                             f"{len(a_convs)} convs against the kernel phase's "
                             f"{kernel_a['bytes']}")
    return entry


# ---- kernel B at every width; the evaluation side's graphs: ICP, the
# extractors, eval-kitti's pair, eval-3dmatch's register ----------------------------

NN_WIDTHS = (16, 64, 256)           # model_n_out values that take the chunk fold
NN_WIDTH_RAGGED = ((1, 129), (129, 1), (31, 129), (4999, 5003))
WIDTH_KEYPOINTS = 5000              # a 3DMatch pair's keypoints a side
ICP_BLOCK = 3                       # ICP calls a block of its both-ways timing
PAIR_BLOCK = 5                      # eval-kitti pairs a block of theirs
SCENE_KEYPOINTS = 5000


def unit_rows(gen, n, d):
    """Unit rows of Gaussian directions, as descriptors are."""
    x = torch.randn((n, d), generator=gen, device="cuda")
    return (x / x.norm(dim=1, keepdim=True)).contiguous()


def outputs_equal(pairs):
    """(every pair of results bit-equal, the largest relative gap) over
    (got, want) dicts of tensors."""
    gaps = [tensors_gap(got, want) for got, want in pairs]
    return all(e for e, _ in gaps), max(g for _, g in gaps)


def keypoint_case(gen, d, n=SCENE_KEYPOINTS):
    """Two keypoint sets of one 3 m cloud under a known pose (gt.log's
    convention: it maps side 1 onto side 0), d-wide unit descriptors that
    identify the rows with noise, the last tenth of each side invalid."""
    xyz0 = torch.rand((n, 3), generator=gen, device="cuda") * 3
    c, s = np.cos(0.3), np.sin(0.3)
    R = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=torch.float32, device="cuda")
    t = torch.tensor([0.3, 0.1, -0.2], device="cuda")
    perm = torch.randperm(n, generator=gen, device="cuda")
    xyz1 = xyz0[perm] @ R.T + t
    f0 = unit_rows(gen, n, d)
    f1 = f0[perm] + 0.05 * torch.randn((n, d), generator=gen, device="cuda")
    f1 = (f1 / f1.norm(dim=1, keepdim=True)).contiguous()
    ok = torch.arange(n, device="cuda") < n - n // 10
    T = torch.eye(4, device="cuda")
    T[:3, :3], T[:3, 3] = R, t
    return [xyz0, f0, ok, xyz1, f1, ok.clone()], torch.linalg.inv(T), torch.eye(6, device="cuda")


def register_both_ways(cfg, gen, d, block=GRAPH_BLOCK):
    """eval-3dmatch's register (``make_scene_register``) graphed against
    eager on a d-wide keypoint case: outputs over GRAPH_CALLS pairs of each
    swap, a replay's launches against an eager call's, and both timed."""
    case, T_gt, cov = keypoint_case(gen, d)
    graphed = threedmatch.make_scene_register(cfg, cfg.inlier_thresh, "cuda")
    eager = threedmatch.make_scene_register(cfg, cfg.inlier_thresh, "cuda", graphed=False)
    pairs = []
    for swap in (False, True):
        for k in range(GRAPH_CALLS):
            want = {n: v.clone() for n, v in eager(k, *case, T_gt, cov, swap=swap).items()}
            pairs.append((graphed(k, *case, T_gt, cov, swap=swap), want))
    equal, gap = outputs_equal(pairs)
    reset_counts()
    eager(0, *case, T_gt, cov, swap=False)
    eager_launches = read_counts()
    reset_counts()
    graphed(0, *case, T_gt, cov, swap=False)
    replay_launches = read_counts()
    timed = both_ways({"eager": lambda: float(eager(0, *case, T_gt, cov, swap=False)["rr"]),
                       "graphed": lambda: float(graphed(0, *case, T_gt, cov, swap=False)["rr"])},
                      block=block)
    return {"d": d, "keypoints": SCENE_KEYPOINTS, "outputs_bit_equal": equal,
            "outputs_max_rel_err": gap, "accepted": bool(pairs[0][0]["accepted"]),
            "captures": graphed.graphed.captures, "replays": graphed.graphed.replays,
            "launches_eager": eager_launches, "launches_per_replay": replay_launches,
            "pairs": timed}, (graphed, eager, case, T_gt, cov)


def phase_nn_widths(gen):
    """Kernel B at widths of its chunk fold (fault 5): against its plain
    version at 5 000 x 5 000 (a 3DMatch pair's keypoints) at D = 16, 64 and
    256 (``kernel_b_entry``: the choice's exact distance within the d² gate,
    graph-timed ms beside its bound, the plain version and cdist + min), at
    ragged sizes, and the chunk fold at D = 32 bit-equal to the pair fold;
    then model_n_out 16 end to end: a graphed validation step at the train
    phase's width and eval-3dmatch's register against their eager calls,
    and ``cli train --model-n-out 16`` through an epoch and its validation
    on the card."""
    entries = []
    for d in NN_WIDTHS:
        q, r = unit_rows(gen, WIDTH_KEYPOINTS, d), unit_rows(gen, WIDTH_KEYPOINTS, d)
        v = torch.rand((WIDTH_KEYPOINTS,), generator=gen, device="cuda") > 0.1
        entries.append(kernel_b_entry(f"descriptors {WIDTH_KEYPOINTS}^2 x {d}", q, r, v,
                                      "nn_widths"))
    ragged = []
    for d in NN_WIDTHS:
        for n, m in NN_WIDTH_RAGGED:
            q, r = unit_rows(gen, n, d), unit_rows(gen, m, d)
            v = torch.rand((m,), generator=gen, device="cuda") > 0.1
            ragged.append([n, m, d, nn_compare(f"ragged {n}x{m}x{d}", q, r, v,
                                               same_index=False)["max_abs_err"]])
    q, r = unit_rows(gen, WIDTH_KEYPOINTS, 32), unit_rows(gen, WIDTH_KEYPOINTS, 32)
    pair_plan = nn_plan(WIDTH_KEYPOINTS, WIDTH_KEYPOINTS, 32)
    chunk_at_32 = all(torch.equal(a, b) for a, b in zip(
        run_plan(q, r, None, pair_plan._replace(fold="chunk")), run_plan(q, r, None, pair_plan)))

    # model_n_out 16: the validation step at the train phase's width
    cfg = bench_config().replace(batch_size=1, max_points=TRAIN_N_PAD, model_n_out=16)
    vbatch = synthetic_batch(np.random.RandomState(1), batch_size=1, n_points=200_000,
                             n_pad=TRAIN_N_PAD, image_hw=(cfg.image_H, cfg.image_W))
    vmodel = train_model(cfg, "cuda")
    veager = make_val_step(vmodel, cfg, map_impl="search")
    vgraphed = make_graphed_val_step(vmodel, cfg, map_impl="search")
    # a replay's metrics are the graph's outputs, which the next call overwrites
    val_equal, _ = outputs_equal([
        ({k: v.clone() for k, v in vgraphed(
            vbatch, torch.Generator(device="cuda").manual_seed(i)).items()},
         veager(vbatch, torch.Generator(device="cuda").manual_seed(i)))
        for i in range(GRAPH_CALLS)])
    reset_counts()
    vgraphed(vbatch, torch.Generator(device="cuda").manual_seed(0))
    val_launches = read_counts()
    del vmodel, veager, vgraphed, vbatch
    register16, _ = register_both_ways(bench_config(), gen, 16, block=3)
    # the documented flag, through the CLI on the card
    with tempfile.TemporaryDirectory(prefix="train16_") as out:
        t = time.perf_counter()
        run_cli(["train", "--dataset", "synthetic", "--batch-size", "1", "--max-epoch", "1",
                 "--lr", "0.05", "--voxel-size", "0.05", "--max-points", "1024",
                 "--model-n-out", "16", "--conv1-kernel-size", "3", "--synthetic-length", "4",
                 "--synthetic-n-points", "400", "--out-dir", out], text=True)
        train_s = time.perf_counter() - t
        with open(os.path.join(out, "metrics.jsonl")) as f:
            metrics = [json.loads(ln) for ln in f]
        best = sorted(n for n in os.listdir(out) if n.startswith("best_val_checkpoint"))
    val_metrics = {m["tag"]: m["value"] for m in metrics if m["tag"].startswith("val/")}
    emit({"phase": "nn_widths", "widths": list(NN_WIDTHS),
          "kernel_b": [{k: e[k] for k in ("d", "fold", "tile", "split", "max_abs_err",
                                          "choice_gap", "index_mismatches", "ms", "plain_ms",
                                          "library_ms", "bound_ms", "bound_by", "x_bound")}
                       for e in entries],
          "ragged_n_m_d_err": ragged, "chunk_fold_at_d32_equals_pair_fold": chunk_at_32,
          "val_step_16": {"metrics_bit_equal": val_equal, "launches_per_replay": val_launches},
          "register_16": register16,
          "cli_train_16": {"seconds": train_s, "val_metrics": val_metrics,
                           "best_checkpoints": best},
          "nvidia_smi": DEVICE["nvidia_smi"]})
    if not chunk_at_32:
        raise AssertionError("nn_widths: the chunk fold at D = 32 differs from the pair fold")
    if not val_equal or val_launches != GRAPH_VAL_LAUNCHES:
        raise AssertionError(f"nn_widths: the 16-d validation step: equal {val_equal}, "
                             f"launches {val_launches}")
    if not register16["outputs_bit_equal"] or \
            register16["launches_per_replay"] != register16["launches_eager"] or \
            register16["launches_per_replay"]["flash_nn"] != 2:
        raise AssertionError(f"nn_widths: the 16-d register: {register16}")
    if not val_metrics or not all(np.isfinite(v) for v in val_metrics.values()) or not best:
        raise AssertionError(f"nn_widths: cli train --model-n-out 16 validated "
                             f"{val_metrics}, checkpoints {best}")
    return entries


def icp_clouds(root):
    """Pair 0 of the KITTI scans as KITTIPairDataset hands them to ICP:
    voxelized at 5 cm, side 0 moved by the closed-form start, both padded
    to the next power of two."""
    cfg = kitti_config(dataset="KITTIPairDataset", kitti_root=root, kitti_max_time_diff=3)
    dset = KITTIPairDataset("test", cfg, random_rotation=False, random_scale=False,
                            icp_device="cuda")
    drive, t0, t1 = dset.files[0]
    xyz0 = np.fromfile(dset._velodyne_fn(drive, t0), np.float32).reshape(-1, 4)[:, :3]
    xyz1 = np.fromfile(dset._velodyne_fn(drive, t1), np.float32).reshape(-1, 4)[:, :3]
    _, sel0 = voxelize_np(xyz0, 0.05)
    _, sel1 = voxelize_np(xyz1, 0.05)
    src = apply_transform_np(xyz0[sel0], closed_form_gt(dset, drive, t0, t1))
    dst = xyz1[sel1]
    n_pad = 1 << int(np.ceil(np.log2(max(len(src), len(dst)))))
    rows = torch.arange(n_pad, device="cuda")
    out = []
    for x in (src, dst):
        p = torch.zeros((n_pad, 3), device="cuda")
        p[:len(x)] = torch.from_numpy(x.astype(np.float32)).cuda()
        out.append(p)
    return out + [rows < len(src), rows < len(dst)]


def phase_graphs_icp(root):
    """ICP (1.16) replayed as one CUDA graph (``icp_point_to_point``)
    against the eager loop (``graphed=False``) on a KITTI pair at scan
    scale: T bit-equal over GRAPH_CALLS calls, a replay's launches (B 30),
    ms both ways in blocks (eager, graphed, graphed, eager). Returns the
    profile runs for later."""
    args = icp_clouds(root)
    eye = torch.eye(4, device="cuda")
    want = icp_point_to_point(*args, eye, 0.2, graphed=False)
    got = [icp_point_to_point(*args, eye, 0.2) for _ in range(GRAPH_CALLS)]
    equal = all(torch.equal(T, want) for T in got)
    reset_counts()
    icp_point_to_point(*args, eye, 0.2, graphed=False)
    eager_launches = read_counts()
    reset_counts()
    icp_point_to_point(*args, eye, 0.2)
    replay_launches = read_counts()
    timed = both_ways({"eager": lambda: icp_point_to_point(*args, eye, 0.2, graphed=False),
                       "graphed": lambda: icp_point_to_point(*args, eye, 0.2)}, block=ICP_BLOCK)
    emit({"phase": "graphs_icp", "n_pad": int(args[0].shape[0]),
          "points": [int(args[2].sum()), int(args[3].sum())], "iters": 30,
          "calls_compared": GRAPH_CALLS, "T_bit_equal": equal,
          "captures": icp_graphed.captures, "replays": icp_graphed.replays,
          "launches_eager": eager_launches, "launches_per_replay": replay_launches,
          "calls": timed, "order": "eager, graphed, graphed, eager", "block": ICP_BLOCK,
          "max_memory_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
          "nvidia_smi": DEVICE["nvidia_smi"]})
    if not equal:
        raise AssertionError("graphs_icp: the replayed ICP differs from the eager one")
    if replay_launches != eager_launches or replay_launches["flash_nn"] != 30:
        raise AssertionError(f"graphs_icp: a replay launched {replay_launches}, an eager call "
                             f"{eager_launches}")
    return [(lambda: icp_point_to_point(*args, eye, 0.2, graphed=False),
             timed["eager"]["median_ms"], "graphs_icp_profile_eager", "icp"),
            (lambda: icp_point_to_point(*args, eye, 0.2),
             timed["graphed"]["median_ms"], "graphs_icp_profile", "icp")]


def phase_graphs_extract(gen):
    """The bucketed extractor (1.17) replayed as three CUDA graphs a
    fragment (quantize per raw bucket and path, pyramid and forward per
    bucket and path, the host reads between them) against
    ``graphed=False``, at full width (bench_config, bf16, random seeded
    weights) on the bench pair's side 0 (200 000 points): the grid path and,
    with the grid maps off, the exact path. Descriptors and points bit-equal
    over GRAPH_CALLS calls, launches a fragment equal to eager and to
    FRAGMENT_LAUNCHES, ms both ways; then every bucket's pyramid and forward
    graph captured on both paths and the peak reserved memory. Returns the
    profile runs for later."""
    cfg = bench_config()
    model = init_model(cfg, 0).cuda().eval()
    pair = bench_pair(cfg)
    raw, n_raw = pad_points_bucketed(pair.xyz0)
    image = np.asarray(pair.image0, np.float32)[None]
    paths, profiles = {}, []
    for path, pcfg in (("grid", cfg), ("exact", cfg.replace(use_grid_maps=False))):
        graphed = make_bucketed_extractor(model, config=pcfg)
        eager = make_bucketed_extractor(model, config=pcfg, graphed=False)
        want = eager(raw, n_raw, image)
        got = [graphed(raw, n_raw, image) for _ in range(GRAPH_CALLS)]
        equal = all(np.array_equal(g[0], want[0]) and np.array_equal(g[1], want[1])
                    for g in got)
        reset_counts()
        eager(raw, n_raw, image)
        eager_launches = read_counts()
        reset_counts()
        graphed(raw, n_raw, image)
        replay_launches = read_counts()
        timed = both_ways({"eager": lambda e=eager: e(raw, n_raw, image),
                           "graphed": lambda g=graphed: g(raw, n_raw, image)})
        paths[path] = {"choice": graphed.last._asdict(), "bit_equal": equal,
                       "launches_eager": eager_launches, "launches_per_fragment": replay_launches,
                       "fragments": timed,
                       "captures": {k: g.captures for k, g in graphed.graphed.items()},
                       "replays": {k: g.replays for k, g in graphed.graphed.items()}}
        if not equal:
            raise AssertionError(f"graphs_extract: the {path} path's replay differs from eager")
        if replay_launches != eager_launches or replay_launches != FRAGMENT_LAUNCHES[path]:
            raise AssertionError(f"graphs_extract: a {path} fragment launched "
                                 f"{replay_launches}; eager {eager_launches}")
        # every bucket's pyramid and forward graph on this path
        st = graphed.graphed
        extent = graphed.last.extent
        xyz = torch.as_tensor(raw).cuda()
        valid = torch.arange(xyz.shape[0], device="cuda") < n_raw
        img = torch.as_tensor(image).cuda()
        sv, _ = st["quantize"](xyz, valid, extent)
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        for bucket in DEFAULT_BUCKETS:
            for _ in range(GRAPH_CALLS):
                pyr, _ = st["pyramid"](sv.coords, sv.num_valid, bucket, extent)
                st["forward"](sv.coords, sv.feats, sv.num_valid, pyr, img, bucket)
        torch.cuda.synchronize()
        paths[path]["graphs_after_every_bucket"] = {k: len(g.graphs) for k, g in st.items()}
        paths[path]["reserved_gib_before_after_every_bucket"] = [
            reserved / 2 ** 30, torch.cuda.memory_reserved() / 2 ** 30]
        profiles += [(lambda e=eager: e(raw, n_raw, image), timed["eager"]["median_ms"],
                      f"graphs_extract_profile_eager_{path}", "fragment"),
                     (lambda g=graphed: g(raw, n_raw, image), timed["graphed"]["median_ms"],
                      f"graphs_extract_profile_{path}", "fragment")]
    emit({"phase": "graphs_extract", "raw_points": int(n_raw), "raw_bucket": len(raw),
          "paths": paths, "calls_compared": GRAPH_CALLS, "buckets": list(DEFAULT_BUCKETS),
          "max_memory_reserved_gib_after_every_bucket":
              torch.cuda.max_memory_reserved() / 2 ** 30,
          "memory_reserved_gib_after_every_bucket": torch.cuda.memory_reserved() / 2 ** 30,
          "order": "eager, graphed, graphed, eager", "block": GRAPH_BLOCK,
          "nvidia_smi": DEVICE["nvidia_smi"]})
    return profiles


def icp_cache(dset):
    """{pair: the refined ground truth's .npy} of a KITTI dataset."""
    return {f: np.load(os.path.join(dset.icp_path, "%d_%d_%d.npy" % f)) for f in dset.files}


def phase_graphs_kitti(root):
    """eval-kitti's pair (1.18), both forwards and the registration as one
    CUDA graph (``make_eval_pair``), against ``graphed=False`` at kitti_config
    width (random seeded weights, the occupancy conv1 of the CLI's
    inference model) on the KITTI scans, the draws of pair i from the
    generator seeded with i: every output (pose, RTE/RRE, inlier counts)
    bit-equal over each pair and GRAPH_CALLS calls of pair 0, a replay's
    launches KITTI_PAIR_LAUNCHES, ms both ways. ICP inside the loader, in
    both forms, with each form's own ICP cache: the test split's producer
    thread, while this thread replays and captures the pair's graph, and a
    loader worker process (``workers=1``, a CUDA context of its own); each
    refined ground truth bit-equal to eager ICP's. Returns the profile runs
    for later."""
    from imfnet_tpu_torch.data import datasets

    base = dict(dataset="KITTIPairDataset", kitti_root=root, kitti_max_time_diff=3)
    eager_cfg = kitti_config(icp_cache_path=os.path.join(root, "icp_eager"), **base)
    real_icp = datasets.icp_point_to_point
    datasets.icp_point_to_point = lambda *a, **kw: real_icp(*a, graphed=False, **kw)
    try:
        edset = KITTIPairDataset("test", eager_cfg, random_rotation=False, random_scale=False,
                                 icp_device="cuda")
        for i in range(len(edset)):
            edset[i]
    finally:
        datasets.icp_point_to_point = real_icp
    want_gt = icp_cache(edset)

    cfg = kitti_config(icp_cache_path=os.path.join(root, "icp_thread"), **base)
    torch.manual_seed(0)
    model = build_model_from_config(cfg, eval_fast=True).cuda().eval()
    graphed, eager = make_eval_pair(model, cfg), make_eval_pair(model, cfg, graphed=False)
    loader = make_data_loader(cfg, "test", 1, shuffle=False, device="cuda")
    pairs, batches = [], []
    t = time.perf_counter()
    for i, batch in loader.numbered():       # ICP in the producer thread meanwhile
        batch = batch_to_device(batch, torch.device("cuda"))
        got = graphed(i, batch)
        got = {k: v.clone() for k, v in got.items()}
        pairs.append((got, eager(i, batch)))
        batches.append((i, batch))
    thread_s = time.perf_counter() - t
    thread_gt = icp_cache(KITTIPairDataset("test", cfg, random_rotation=False,
                                           random_scale=False, icp_device="cuda"))
    wcfg = kitti_config(icp_cache_path=os.path.join(root, "icp_worker"), **base)
    wloader = make_data_loader(wcfg, "test", 1, shuffle=False, device="cuda", workers=1)
    t = time.perf_counter()
    n_worker = sum(1 for _ in wloader)
    worker_s = time.perf_counter() - t
    wloader.close()
    worker_gt = icp_cache(KITTIPairDataset("test", wcfg, random_rotation=False,
                                           random_scale=False, icp_device="cuda"))
    i0, b0 = batches[0]
    for _ in range(GRAPH_CALLS):
        pairs.append(({k: v.clone() for k, v in graphed(i0, b0).items()}, eager(i0, b0)))
    equal, gap = outputs_equal(pairs)
    reset_counts()
    eager(i0, b0)
    eager_launches = read_counts()
    reset_counts()
    graphed(i0, b0)
    replay_launches = read_counts()
    timed = both_ways({"eager": lambda: float(eager(i0, b0)["rte_raw"]),
                       "graphed": lambda: float(graphed(i0, b0)["rte_raw"])}, block=PAIR_BLOCK)
    gt_equal = {"thread": all(np.array_equal(thread_gt[f], want_gt[f]) for f in want_gt),
                "worker": all(np.array_equal(worker_gt[f], want_gt[f]) for f in want_gt)}
    rte_rre = [[float(g["rte_raw"]), float(g["rre_raw"])] for g, _ in pairs[:len(batches)]]
    emit({"phase": "graphs_kitti", "pairs": len(batches), "worker_pairs": n_worker,
          "outputs_bit_equal": equal, "outputs_max_rel_err": gap, "rte_rre_raw": rte_rre,
          "icp_ground_truth_bit_equal_to_eager": gt_equal,
          "loader_seconds": {"thread_with_pair_graphs": thread_s, "worker": worker_s},
          "captures": graphed.graphed.captures, "replays": graphed.graphed.replays,
          "launches_eager": eager_launches, "launches_per_replay": replay_launches,
          "pairs_timed": timed, "order": "eager, graphed, graphed, eager", "block": PAIR_BLOCK,
          "max_memory_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
          "nvidia_smi": DEVICE["nvidia_smi"]})
    if not equal:
        raise AssertionError(f"graphs_kitti: a replayed pair differs from eager ({gap})")
    if replay_launches != eager_launches or replay_launches != KITTI_PAIR_LAUNCHES:
        raise AssertionError(f"graphs_kitti: a replay launched {replay_launches}; eager "
                             f"{eager_launches}, want {KITTI_PAIR_LAUNCHES}")
    if not all(gt_equal.values()) or n_worker != len(batches) or not batches:
        raise AssertionError(f"graphs_kitti: ICP in the loader: {gt_equal}, pairs "
                             f"{len(batches)} (thread) and {n_worker} (worker)")
    return [(lambda: eager(i0, b0), timed["eager"]["median_ms"],
             "graphs_kitti_profile_eager", "pair"),
            (lambda: graphed(i0, b0), timed["graphed"]["median_ms"],
             "graphs_kitti_profile", "pair")]


def phase_graphs_3dmatch(gen):
    """eval-3dmatch's register (1.19), one CUDA graph per (keypoint pad,
    width, swap) with RANSAC's uniforms drawn outside from the pair's
    generator, against the eager call, at bench_config (50 000 hypotheses)
    on 5 000 keypoints a side with 32-d descriptors: every output bit-equal
    over GRAPH_CALLS pairs of each swap, a replay's launches (B 2), ms both
    ways. Returns the profile runs for later."""
    entry, (graphed, eager, case, T_gt, cov) = register_both_ways(bench_config(), gen, 32)
    emit({"phase": "graphs_3dmatch", **entry, "order": "eager, graphed, graphed, eager",
          "block": GRAPH_BLOCK, "nvidia_smi": DEVICE["nvidia_smi"]})
    if not entry["outputs_bit_equal"]:
        raise AssertionError("graphs_3dmatch: a replayed register differs from eager")
    if entry["launches_per_replay"] != entry["launches_eager"] or \
            entry["launches_per_replay"]["flash_nn"] != 2:
        raise AssertionError(f"graphs_3dmatch: launches {entry}")
    return [(lambda: eager(0, *case, T_gt, cov, swap=False), entry["pairs"]["eager"]["median_ms"],
             "graphs_3dmatch_profile_eager", "pair"),
            (lambda: graphed(0, *case, T_gt, cov, swap=False),
             entry["pairs"]["graphed"]["median_ms"], "graphs_3dmatch_profile", "pair")]


# DGR's 6-D inlier network (eval/dgr.py): its 20 k3 convs are the main
# path's levels and widths at 3^6 = 729 offsets, all in kernel A's wide-K
# variant; conv1 (cin 1, k 729) in the cin1 variant; one kernel-B search
DGR_K = 3 ** 6
DGR_LAUNCHES = {"sparse_conv_gather_gemm": 21, "flash_nn": 1, "sorted_compact": 0,
                "word_match": 0, "sparse_conv_gather_gemm.tc": 0,
                "sparse_conv_gather_gemm.cin1": 1, "sparse_conv_gather_gemm.scalar": 0,
                "sparse_conv_gather_gemm.tcw": 20}
DGR_VOXELS, DGR_INLIERS, DGR_PAIRS = 67_000, 0.3, 5
DGR_PLAIN_ROWS = 2048    # the plain version's rows a block: [2048, 729 * cin] f32 at most 1.5 GB


def dgr_pair(seed=0):
    """A KITTI-sized DGR pair: 67 000 voxels of 0.3 m over a 40 m disc, the
    second scan the first under a yaw of 0.15 rad and 11 m; 32-d unit
    descriptors, of which 30 % of the target's repeat the source voxel's
    plus 0.1 noise and the rest are drawn anew."""
    rng = np.random.default_rng(seed)
    n = 2 * DGR_VOXELS
    r, a = 40 * np.sqrt(rng.random(n)), 2 * np.pi * rng.random(n)
    xyz = np.c_[r * np.cos(a), r * np.sin(a), 3 * rng.random(n) - 1.5].astype(np.float32)
    _, first = np.unique(np.floor(xyz / np.float32(0.3)).astype(np.int64), axis=0,
                         return_index=True)
    xyz0 = xyz[np.sort(first)][:DGR_VOXELS]
    c, s = np.cos(0.15), np.sin(0.15)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    xyz1 = (xyz0 @ R.T + np.array([11.0, 0.5, 0.1], np.float32)).astype(np.float32)
    f0 = rng.standard_normal((DGR_VOXELS, 32)).astype(np.float32)
    f1 = rng.standard_normal((DGR_VOXELS, 32)).astype(np.float32)
    keep = rng.random(DGR_VOXELS) < DGR_INLIERS
    f1[keep] = f0[keep] + 0.1 * rng.standard_normal((int(keep.sum()), 32))
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    return xyz0, f0, xyz1, f1


def plain_blocked(x, nbr, w):
    """gather_gemm_plain over blocks of DGR_PLAIN_ROWS output rows: at 729
    offsets the whole gathered matrix would not fit the card."""
    return torch.cat([gather_gemm_plain(x, nbr[i:i + DGR_PLAIN_ROWS], w)
                      for i in range(0, nbr.shape[0], DGR_PLAIN_ROWS)])


def dgr_conv_entry(name, x, nbr, w, plan):
    """Kernel A at one DGR conv against the plain version: the plan and
    variant counter, the error over the output's scale, dead rows exactly 0,
    two calls bit-equal; for the wide-K walk its tally against the host's
    count of the map and the map's live entries a row; graph-timed ms (the
    walk with its tally and without it, and its list build alone), and the
    roofline bound from the inputs."""
    n_out, k = nbr.shape
    n_in, cin, cout = x.shape[0], w.shape[1], w.shape[2]
    attr = f"launches_{plan.variant}"
    before = getattr(gather_gemm, attr)
    out = gather_gemm(x, nbr, w)
    again = gather_gemm(x, nbr, w)
    if getattr(gather_gemm, attr) != before + 2:
        raise AssertionError(f"dgr: {name} did not launch kernel A's {plan.variant} variant")
    ref = plain_blocked(x, nbr, w)
    torch.cuda.synchronize()
    scale = max(float(ref.abs().max()), 1e-30)
    err = float((out - ref).abs().max()) / scale
    dead = (nbr < 0).all(dim=1)
    bit_equal = torch.equal(out, again)
    if err > CONV_TOL_REL or not bool((out[dead] == 0).all()) or not bit_equal:
        raise AssertionError(f"dgr: kernel A disagrees at {name}: {err} of the output's "
                             f"scale > {CONV_TOL_REL}, a dead row is not exactly 0, or two "
                             f"calls differ (bit-equal {bit_equal})")
    del ref, again
    nnz = int((nbr >= 0).sum())
    ops_ms = 2.0 * nnz * cin * cout / PEAK_BF16_FLOPS * 1e3
    nbytes = conv_traffic_bytes(n_out, n_in, k, cin, cout, nbr=nbr)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    entry = {"conv": name, "n_out": n_out, "n_in": n_in, "k": k, "cin": cin, "cout": cout,
             "nnz": nnz, "live_share": nnz / (n_out * k), "variant": plan.variant,
             "tile": [plan.bm, plan.bn], "bk": plan.bk, "split": plan.split,
             "max_rel_err": err, "tol_rel": CONV_TOL_REL, "bit_equal": bit_equal,
             "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
             "bound_ms": max(ops_ms, bytes_ms),
             "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}
    if plan.variant != "tcw":
        entry["ms"] = graph_ms(lambda: gather_gemm(x, nbr, w), 5)
        return entry
    # the tally against the host's count of the map
    timer.reset()
    with timer.tracing():
        gather_gemm(x, nbr, w)
        tally = timer.record()["counters"]
    timer.reset()
    want = tcw_tally_plain(nbr)
    if any(tally.get(k) != v for k, v in want.items()):
        raise AssertionError(f"dgr: {name}'s walk tally {tally} is not the map's {want}")
    live_row = (nbr >= 0).sum(dim=1)
    valid = live_row[live_row > 0].float()
    entry.update({"slots_walked": tally["conv.slots_walked"],
                  "entries_waited": tally.get("conv.entries_waited", 0),
                  "walk_share": nnz / max(1, tally["conv.slots_walked"]),
                  "rows_live": int(valid.numel()),
                  "row_live_mean": float(valid.mean()) if valid.numel() else 0.0,
                  "row_live_p99": float(valid.quantile(0.99)) if valid.numel() else 0.0,
                  "row_live_max": int(live_row.max())})
    # the walk tally on and off in turn, three times each, so that a drift
    # of the card's clock falls on both; the medians; the list build alone
    on, off = [], []
    for _ in range(3):
        on.append(graph_ms(lambda: gather_gemm(x, nbr, w), 5))
        off.append(graph_ms(lambda: conv_run_plan(x, nbr, w, plan, tally=False), 5))
    entry["ms"], entry["ms_without_tally"] = float(np.median(on)), float(np.median(off))
    entry["lists_ms"] = graph_ms(lambda: tcw_lists(nbr, cout, ob=plan.split), 5)
    entry["walk_ms"] = entry["ms"] - entry["lists_ms"]
    return entry


def phase_dgr(gen):
    """DGR's registrar on the card at the cell's size: the graphed chain's
    pairs/s and launches a pair (counts zeroed before the timed pairs:
    kernel A 20 wide-K + 1 cin1, B 1, asserted), then kernel A against its
    plain version on that pair's own 6-D pyramid at each distinct conv of
    the network (wide-K) and at conv1 (cin1, k 729). Returns kernel A's
    summary for the kernels line."""
    reg = DGRRegistrar(dgr_kitti_config(), device="cuda", seed=0)
    seen = []
    reg.model.register_forward_hook(lambda mod, inputs, out: seen.append(inputs))
    pair = dgr_pair()
    for _ in range(2):                   # the eager call, then the capture
        reg(*pair)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(DGR_PAIRS):
        out = reg(*pair)
    seconds = (time.perf_counter() - t0) / DGR_PAIRS
    launches = {k: v / DGR_PAIRS for k, v in read_counts().items()}
    if launches != DGR_LAUNCHES:
        raise AssertionError(f"dgr: launches a pair {launches}, want {DGR_LAUNCHES}")
    sv, pyr = seen[-1][0], seen[-1][1]  # the capture's buffers, as the last replay left them
    levels = [int(lv.num_valid) for lv in pyr.levels]
    del reg, seen
    entries, done, inputs = [], {}, {}
    for name, level, which, cin, cout in MAIN_PATH_CONVS:
        key = (level, which, cin, cout)
        if key in done:
            done[key]["count"] += 1
            continue
        src = {"k3_same": level, "down": level - 1, "up": level + 1}[which]
        nbr = getattr(pyr.levels[level], which)
        x = torch.randn((pyr.levels[src].coords.shape[0], cin), generator=gen,
                        device="cuda").to(torch.bfloat16)
        w = (torch.randn((DGR_K, cin, cout), generator=gen, device="cuda")
             * (DGR_K * cin) ** -0.5).to(torch.bfloat16)
        plan = conv_plan(nbr.shape[0], cin, cout, DGR_K, x.dtype)
        if plan.variant != "tcw":
            raise AssertionError(f"dgr: {name} {key} planned {plan}, not the wide-K variant")
        done[key] = dgr_conv_entry(name, x, nbr, w, plan)
        done[key]["count"] = 1
        entries.append(done[key])
        inputs[key] = (x, nbr, w)
    # the 20 convs of a pair in network order, one graph, each residual
    # block's two convs sharing one list build as the network runs them:
    # tally on and off in turns, three times each; then every conv building
    # its own lists
    names = [n for n, *_ in MAIN_PATH_CONVS]
    calls = [inputs[(lv, wh, ci, co)] for _, lv, wh, ci, co in MAIN_PATH_CONVS]
    pair_plans = [conv_plan(n.shape[0], w_.shape[1], w_.shape[2], DGR_K, x_.dtype)
                  for x_, n, w_ in calls]

    def pair(tally=True, share=True):
        i = 0
        while i < len(calls):
            two = share and i + 1 < len(calls) and names[i + 1] == names[i]
            with shared_lists() if two else contextlib.nullcontext():
                for j in range(i, i + 1 + two):
                    conv_run_plan(*calls[j], pair_plans[j], tally=tally)
            i += 1 + two

    pair_on, pair_off = [], []
    for _ in range(3):
        pair_on.append(graph_ms(pair, 2))
        pair_off.append(graph_ms(lambda: pair(tally=False), 2))
    pair_unshared = graph_ms(lambda: pair(share=False), 2)
    del calls, inputs
    nbr = pyr.levels[0].k3_same
    x = torch.randn((nbr.shape[0], 1), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((DGR_K, 1, 32), generator=gen, device="cuda").to(torch.bfloat16)
    plan = conv_plan(nbr.shape[0], 1, 32, DGR_K, x.dtype)
    if plan.variant != "cin1":
        raise AssertionError(f"dgr: conv1 planned {plan}, not the cin1 variant")
    conv1 = dgr_conv_entry("conv1", x, nbr, w, plan)
    for e in entries + [conv1]:
        emit({"phase": "dgr_kernel", "kernel": "sparse_conv_gather_gemm", **e})
    total = lambda k: sum(e[k] * e["count"] for e in entries)  # noqa: E731
    summary = {"dgr_launches_per_pair": launches["sparse_conv_gather_gemm"],
               "dgr_launches_by_variant": {v: launches[f"sparse_conv_gather_gemm.{v}"]
                                           for v in ("tc", "cin1", "scalar", "tcw")},
               "dgr_max_rel_err": max(e["max_rel_err"] for e in entries + [conv1]),
               "dgr_tcw_ms": total("ms"), "dgr_tcw_ms_without_tally": total("ms_without_tally"),
               "dgr_tcw_lists_ms": total("lists_ms"), "dgr_tcw_walk_ms": total("walk_ms"),
               "dgr_tcw_pair_ms": float(np.median(pair_on)),
               "dgr_tcw_pair_ms_without_tally": float(np.median(pair_off)),
               "dgr_tcw_pair_ms_turns": [pair_on, pair_off],
               "dgr_tcw_pair_ms_unshared": pair_unshared,
               "dgr_tcw_bound_ms": total("bound_ms"),
               "dgr_tcw_roofline_share": total("bound_ms") / total("ms"),
               "dgr_tcw_walk_share": total("nnz") / total("slots_walked"),
               "dgr_tcw_entries_waited": total("entries_waited"),
               "dgr_tcw_entries_live": total("nnz"),
               "dgr_conv1_ms": conv1["ms"], "dgr_conv1_bound_ms": conv1["bound_ms"],
               "dgr_conv1_tile": [plan.bm, plan.bn]}
    emit({"phase": "dgr", "voxels": DGR_VOXELS, "rows_valid": levels,
          "ms_per_pair": seconds * 1e3, "pairs_per_s": 1.0 / seconds,
          "launches_per_pair": launches, "wsum": float(out["wsum"]), **summary})
    del pyr, sv, x, w, nbr
    torch.cuda.empty_cache()
    return summary


def phase_eval_graphs(gen):
    """The five phases of kernel B's widths and the evaluation side's graphs;
    returns kernel B's width entries and the profile runs, which come after
    every timed phase."""
    widths = phase_nn_widths(gen)
    profiles = []
    saved = dict(KITTIPairDataset.DATA_FILES)
    with tempfile.TemporaryDirectory(prefix="kitti_graphs_") as root:
        write_kitti_scans(root)
        KITTIPairDataset.DATA_FILES["test"] = os.path.join(root, "test_list.txt")
        try:
            # eval-kitti first: its loader's producer thread warms up and
            # captures ICP's graph beside this thread's pair graphs
            profiles += phase_graphs_kitti(root)
            profiles += phase_graphs_icp(root)
        finally:
            KITTIPairDataset.DATA_FILES.clear()
            KITTIPairDataset.DATA_FILES.update(saved)
    # the profiles' runs read tensors on the card, not the scans
    profiles += phase_graphs_extract(gen)
    profiles += phase_graphs_3dmatch(gen)
    return widths, profiles


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False   # f32 convs stay f32
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_device()
    phase_build()

    reg = PairRegistrar()               # bench config, the card, seed 0
    pair = bench_pair(reg.config)
    launches, seconds_per_pair, q, pyr, feats, stages = phase_pipeline(reg, pair)
    grid = dict(compact_impl="kernel", map_impl="banded")
    reg_grid = PairRegistrar(**grid)    # the same weights (seed 0)
    grid_launches, grid_seconds_per_pair, q_grid, _, _, _ = phase_pipeline(
        reg_grid, pair, "grid_pipeline", GRID_LAUNCHES, reference=(q, pyr, feats),
        n_pairs=15)

    gen = torch.Generator(device="cuda").manual_seed(0)
    k = reg.config.num_rand_keypoints
    n_rows = q.xyz_down.shape[0]
    i0, ok0 = sample_keypoints_segment(0, q.n0, k, n_rows, device="cuda", generator=gen)
    i1, ok1 = sample_keypoints_segment(q.n0, q.sv.num_valid - q.n0, k, n_rows,
                                       device="cuda", generator=gen)
    kernels = [phase_kernel_a(pyr, gen),
               phase_kernel_b(feats[i0].contiguous(), ok0, feats[i1].contiguous(),
                              ok1, gen)]
    for kern in kernels:               # counted in the pipeline's timed run
        kern["launches"] = launches[kern["name"]]
    grid_kernels = [phase_kernel_c(reg_grid, pair), phase_kernel_d(reg_grid, q_grid)]
    for kern in grid_kernels:          # counted in the grid pipeline's timed run
        kern["launches"] = grid_launches[kern["name"]]
    kernels += grid_kernels
    phase_roofline(reg, pyr, kernels[0], stages)
    dgr = phase_dgr(gen)                # DGR's 6-D path, its launches counted alone

    phase_reference()
    phase_reference("grid", **grid)
    phase_reference(compute_dtype="bfloat16")
    # every timed phase before the profiler: a CUDA profiling session slows
    # the host's later launches in the same process
    reg_eager = PairRegistrar(graphed=False)
    reg_grid_eager = PairRegistrar(graphed=False, **grid)
    phase_paths({"default": reg, "default_eager": reg_eager, "grid": reg_grid,
                 "grid_eager": reg_grid_eager}, pair)
    builder_launches = phase_builders(pair)
    graphs_pair = phase_graphs_pair(reg, reg_eager, pair)
    del q, pyr, feats, q_grid

    # ---- the training step -------------------------------------------
    cfg = bench_config().replace(batch_size=TRAIN_BATCH)
    batch = synthetic_batch(np.random.RandomState(0), batch_size=TRAIN_BATCH,
                            n_points=200_000, n_pad=TRAIN_N_PAD,
                            image_hw=(cfg.image_H, cfg.image_W))
    train_kernels = phase_train_kernels(cfg, batch, gen)
    phase_train_reference()
    train_launches, seconds_per_step, state, step, step_gen = phase_train(cfg, batch)
    gstep, gstate, ggen, gstep_ms = phase_graphs(cfg, batch)
    # kernel B at every width, the evaluation side's graphs: timed before
    # the profiler, profiled after the others
    width_entries, eval_profiles = phase_eval_graphs(gen)
    # data parallelism, one rank: before the profiler, which slows this
    # process's later launches; the two ranks run last (phase_ranks)
    dp_ctx = phase_dp_one_rank(cfg, batch)
    phase_profile(reg, pair, seconds_per_pair * 1e3)
    phase_profile(reg_eager, pair, 1e3 / graphs_pair["pairs"]["eager"]["per_s"],
                  "profile_eager")
    own = phase_profile(reg_grid, pair, grid_seconds_per_pair * 1e3, "grid_profile")
    if own["compact_single_pass"][1] != 1:
        raise AssertionError(f"kernel C is not one CUDA kernel a call: {own}")
    profile_units(lambda: step(state, batch, step_gen), seconds_per_step * 1e3,
                  "train_profile", "step", 3)
    profile_units(lambda: gstep(gstate, batch, ggen), gstep_ms, "train_profile_graphed",
                  "step", 3)
    for run, wall_ms, name, unit in eval_profiles:
        profile_units(run, wall_ms, name, unit, 1)
    del eval_profiles
    del reg, reg_grid, reg_eager, reg_grid_eager, gstep, gstate
    a, b = kernels[0], kernels[1]
    by_variant = lambda counts: {v: counts[f"sparse_conv_gather_gemm.{v}"]  # noqa: E731
                                 for v in ("tc", "cin1", "scalar", "tcw")}
    a.update(dgr)
    a.update({"launches_by_variant": by_variant(launches),
              "train_launches": train_launches[a["name"]],
              "train_launches_by_variant": by_variant(train_launches),
              "backward_max_abs_err": train_kernels["backward"]["max_abs_err"],
              "backward_ms": train_kernels["backward"]["ms"],
              "backward_plain_ms": train_kernels["backward"]["plain_ms"],
              "backward_bound_ms": train_kernels["backward"]["bound_ms"],
              "conv1_variant": train_kernels["conv1"]["variant"],
              "conv1_ms": train_kernels["conv1"]["ms"],
              "conv1_scalar_variant_ms": train_kernels["conv1"]["scalar_variant_ms"],
              "conv1_plain_ms": train_kernels["conv1"]["plain_ms"],
              "conv1_bound_ms": train_kernels["conv1"]["bound_ms"],
              "conv1_max_abs_err": train_kernels["conv1"]["max_abs_err"],
              "weight_grad_plain_ms_per_step": train_kernels["dw_ms_per_step"]})
    b.update({"train_launches": train_launches[b["name"]],
              "search_fold": train_kernels["search"]["fold"],
              "search_max_abs_err": train_kernels["search"]["max_abs_err"],
              "search_ms": train_kernels["search"]["ms"],
              "search_plain_ms": train_kernels["search"]["plain_ms"],
              "search_bound_ms": train_kernels["search"]["bound_ms"]})
    for kern in kernels[2:]:
        kern["train_launches"] = train_launches[kern["name"]]
    d = kernels[3]
    d.update({"train_ms": train_kernels["word_match"]["ms"],
              "train_plain_ms": train_kernels["word_match"]["plain_ms"],
              "train_bound_ms": train_kernels["word_match"]["bound_ms"]})
    b["search_library_ms"] = train_kernels["search"]["library_ms"]
    b["other_widths"] = [{k: e[k] for k in ("n", "m", "d", "fold", "max_abs_err", "ms",
                                            "plain_ms", "library_ms", "bound_ms", "bound_by")}
                         for e in width_entries]
    del state, step, batch

    # ---- the trainer around the step ---------------------------------
    with tempfile.TemporaryDirectory(prefix="trainer_") as out_dir:
        trainer_launches, trained = phase_trainer(out_dir)
        for kern in kernels:
            kern["trainer_launches"] = trainer_launches[kern["name"]]
            if kern["name"] != "sorted_compact" and not kern["trainer_launches"]:
                raise AssertionError(f"the trainer never launched {kern['name']}")
        phase_trained_pair(trained)
        # ---- the published-benchmark path, with the trainer's best weights
        best = max(glob.glob(os.path.join(out_dir, "best_val_checkpoint_*")))
        gen_launches, eval_launches = phase_benchmark(best, gen)
    for kern in kernels:
        kern["generate_desc_launches"] = gen_launches[kern["name"]]
        kern["eval_3dmatch_launches"] = eval_launches[kern["name"]]
        if not kern["generate_desc_launches"] + kern["eval_3dmatch_launches"]:
            raise AssertionError(f"the benchmark path never launched {kern['name']}")

    # ---- KITTI: ICP, then eval-kitti ------------------------------------
    icp_launches, kitti_launches, icp_nn, kitti_nn = phase_kitti(gen)
    for kern in kernels:
        kern["kitti_icp_launches"] = icp_launches[kern["name"]]
        kern["eval_kitti_launches"] = kitti_launches[kern["name"]]
    b.update({f"{pre}_{k}": e[k] for pre, e in (("icp", icp_nn), ("kitti", kitti_nn))
              for k in ("n", "m", "d", "fold", "max_abs_err", "ms", "plain_ms", "library_ms",
                        "bound_ms", "bound_by")})

    # ---- the zoo, the converter, DAM, the visualizer, the offline tools ----
    phase_slice8(gen, kernels)

    # ---- two ranks in new processes: the DP step and trainer, sharded
    # generate-desc and eval-kitti ------------------------------------------
    (dp_launches, dp_trainer_launches, dp_val_launches), sharded_launches = \
        phase_ranks(cfg, dp_ctx)
    for kern in kernels:
        name = kern["name"]
        kern.update({"builders_launches_per_pair": {b: builder_launches[b][name]
                                                    for b in BUILDERS},
                     "dp_launches_per_rank_step": dp_launches[name],
                     "dp_trainer_launches_per_rank_step": dp_trainer_launches[name],
                     "dp_trainer_launches_per_rank_val_step": dp_val_launches[name],
                     "sharded_generate_desc_launches": sharded_launches["generate_desc"][name],
                     "sharded_eval_kitti_launches": sharded_launches["eval_kitti"][name]})
        if not (kern["dp_launches_per_rank_step"] + kern["sharded_generate_desc_launches"]
                + kern["dp_trainer_launches_per_rank_step"]):
            raise AssertionError(f"the new paths never launched {name}")

    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
