#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``textgcn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which passes or ends the run with a non-zero exit:

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles every CUDA source of the port with nvcc (in parallel):
   ``spmm_dropout.cu`` (K1), ``spmm_weighted.cu`` (K2), ``gat_fwd.cu``
   (K3), ``gat_bwd.cu`` (K4), ``gatv2_fwd.cu`` (K5), ``gatv2_bwd.cu`` (K6),
   ``spmm_lab.cu`` (L1), ``gather_lab.cu`` (L2, L3);
2b. data: the native interaction reader (``native.py``,
   ``csrc/graphbuild.cpp``, built with the host C++ compiler) loads S1,
   and the plain Python reader (``TEXTGCN_TPU_NATIVE=0``) loads it again:
   the same edges, weights, id maps and test lists; both timed.  Every
   later phase loads through the native reader;
3. kernel: holds K1 (``spmm_dropout``) against its plain torch version on
   the S1 graph, both directions, keep 1.0 and 0.6 with a salt whose high
   bit is set, within atol = rtol = 1e-5 (the summation order is the only
   difference; one flipped mask bit is ~0.1), and times the kernel, the
   plain version and ``torch.sparse.mm`` (a yardstick the port never
   calls) with CUDA events; then holds K1 against ``spmm_plain`` at the
   widths that take its other instances (``K1_WIDTHS``: float4 rows of 8,
   16 and 32 lanes, float2 rows, two column strips), to_user at keep 0.6;
   then on the benchmark's Amazon-Book graph (``lgcn-amazon-book``'s
   draw, rows of up to 4,896 edges, which K1 splits into chunks): both
   directions at keep 1 and 0.6, forward and backward, within the same
   tolerance of ``spmm_plain``, two launches bit-equal, every launch split,
   each timed beside its bound (``book_kernel_phase``); and K3 and K4 on
   the same graph, both directions at keep 1 and 0.6, held as phase 4
   holds them and timed beside the benchmark's bounds
   (``book_attention_phase``; ten times phase 4's tolerances, for rows
   a hundred times longer);
3b. K2 kernel: partitions each direction of the S1 graph by source range
   into W = 1 and W = 4 shards on the one card, as the mesh path does
   (``parallel.sharded_spmm.build_shard``), and holds K2
   (``spmm_weighted``) against ``spmm_weighted_plain`` on every shard at
   keep 1.0 and 0.6 (the hash mask multiplied into the weights), and the
   sum of the four shards' outputs against K1 on the full CSR with the
   same salt, all within atol = rtol = 1e-5; times K2 on one layer at W =
   1 and per shard at W = 4, the plain version and ``torch.sparse.mm``
   with the same weights (a yardstick the port never calls), at keep 1.0
   and 0.6; K2 at W = 1 must give K1's bits at both keeps (same weights,
   same order of sums); then K2 on the W = 1 to_user shard at keep 0.6 at
   the widths that take its other instances (``K2_WIDTHS``), within 1e-5
   of ``spmm_weighted_plain`` and bit-equal to K1 at each;
4. gat kernel: holds K3 against ``gat_att_plain`` (atol = rtol = 1e-5; its
   ``m``, the max over the kept logits that K4 reads, bit for bit) and K4,
   fed K3's ``m``, against ``gat_bwd_plain`` (atol = rtol = 1e-4: K4 sums
   dd with float atomics in a changing order, and its sums run over up to
   ~100 terms of magnitude ~10 here) on the S1 graph, both directions,
   keep 1.0 and 0.6, with unit-scale random inputs, and times kernel and
   plain; then K3 and K4 at the widths that take their other instances
   (``ATT_WIDTHS``: one, two, four and eight float2 a lane, two and four
   float4), to_user at keep 0.6, with ``g_num`` scaled by sqrt(64 / d) so
   that ``g_num . h`` spreads as at d = 64;
5. gatv2 kernel: the same for K5 against ``gatv2_att_plain`` (atol = rtol
   = 1e-5) and K6 against ``gatv2_bwd_plain`` (atol = rtol = 1e-4 for dhs
   and dhd, summed with float atomics; da, a sum over every kept edge, to
   1e-4 of its largest entry), then K5 and K6 at ``ATT_WIDTHS``, to_user
   at keep 0.6, with ``a`` and ``g_num`` scaled by sqrt(64 / d) so that
   the logits spread as at d = 64;
5a. shard kernels: K1 and K3-K6 on the W = 4 destination shards of S1
   (``parallel.sharded_conv.MeshConvOp`` of each rank, built in this one
   process: global ids, the edges into the rank's rows, the backward
   kernels on the shard's own transpose), both directions at keep 0.6:
   every launch against its plain version (K1, K3, K5 within 1e-5, K3's
   ``m`` bit for bit, K4 and K6 within 1e-4), each shard's rows of the
   forward outputs against the whole-graph kernel's, the backward
   partials summed over the four shards against the whole-graph
   kernel's; each kernel timed per shard against its bound;
5b. labs: runs the two lab entry points at the JAX labs' full shapes, as
   a user runs them (``textgcn_tpu_torch.tools.kernel_lab.main`` with all
   five modes at bf16 and at f32 x, ``gather_lab.main`` with both modes):
   L1 (``spmm_lab``), L2 (``gather_rows``) and L3 (``gather_rows_bulk``)
   launch exactly as often as their timing takes; then holds L1 in every
   mode and dtype against ``spmm_lab_plain`` (atol = rtol =
   1e-5), at the lab's shape and on small layouts with an edgeless
   destination block at group 1, 3 and 8 and d = 64 and 128 (two column
   slices), ``full`` against ``torch.sparse.mm`` and K2 over the same edges
   as a CSR, and L2 and L3 bit for bit against ``index_select``, and times
   each with its plain version and its library yardstick (L1 beside K2 on
   the CSR too, with its share of the bound);
6. small: serves ``data/dummy`` through the CLI on the card and on the
   CPU (the plain path the CPU tests tie to the JAX package): the metrics
   agree within 1e-6 and the predictions up to ties; then the same for
   ``graphsage --aggr max``, whose segment max is plain torch: it launches
   no kernel;
7. serve: S1 (60,000 users x 25,000 items, ~545k edges, d = 64, 3 layers)
   served through ``textgcn_tpu_torch.cli.main`` from a JAX-format pickle
   (tables padded to 4096 rows): K1 launches exactly 12 times (eval and
   predict, 3 layers x 2 directions each), none of them with a split
   schedule (S1's rows are short), ``predictions.tsv`` has one row
   per user, the metrics are finite, and the served top-40 of 256 users
   equals the top-40 of a plain-SpMM propagation on the card up to ties;
7b. approx serve: S1 served again with ``--approx_topk 0.95`` (serving
   mode), on one card (12 K1 launches) and with ``--mesh 1x1`` (12 K2
   launches; the single card's ``predictions.tsv`` byte for byte and its
   metrics); for the first 4,096 users: the served top-40 is the float32
   scores rounded to bfloat16, masked, top-k with ties to the lower
   index, computed on the card, each exact top-40 item is served or tied
   in bfloat16 with the 40th served value, and the mean top-40 recall
   against phase 7 is at least 0.95 (the per-user minimum logged); a
   batch's retrieval is timed in both modes (``approx_phase``);
7c. jax runs: phase 7's pickle written again as an Orbax directory
   (``write_orbax_dir``: OCDBT and zarr v2 in 4 row shards, as a TPU
   v5e-4 run of the JAX package saves it) and served through
   ``cli.main --ckpt_backend orbax --load``: the host read timed (MB/s)
   and bit-equal, K1 exactly 12 launches, ``predictions.tsv`` equal to
   phase 7's byte for byte; then the committed runs that the JAX package
   wrote (``tests/fixtures/jax_runs``: ``lgcn`` saved by 2 processes x 2
   devices, ``gat``, ``gbdt``'s ``tree.pkl``) served on the card and the
   CPU on ``data/dummy``, equal (``jax_runs_phase``);
8. train lgcn: S1 trained through ``cli.main`` for 2 epochs (batch 2048,
   dropout 0.4, eval every epoch): K1 launches exactly ``steps x 12 + 2
   evals x 6`` (6 forward and 6 backward a step), the loss sums are
   finite and fall, ``best.pkl`` serves through the CLI with the metrics
   of its epoch, and one step with the kernels agrees with one step with
   the plain versions on the card (same params, batch and salts: loss and
   gradients within atol = rtol = 1e-4, the f32 reordering of ~545k-term
   sums through 3 layers forward and back);
9. train gcn, graphsage, gat, gatv2 (``--aggr mean``): the same; ``gcn``
   and ``graphsage`` run K1 on the unit-weight op (``steps x 12 + 6`` per
   eval), ``gat`` launches K3 ``steps x 6 + 6`` per eval and K4 ``steps x
   6``, ``gatv2`` K5 and K6 the same; no single-card path launches K2;
9b. mesh: ``lgcn --mesh 1x1`` trained through ``cli.main`` with the
   ``lgcn`` phase's flags and seed (a one-rank NCCL group that the CLI
   starts and destroys): K2 launches exactly ``steps x 12 + evals x 6`` and
   K1 none, the loss sums equal phase 8's within 1e-5 relative and every
   eval's metrics within 1e-6 (same batches and salts), and its
   ``best.pkl`` serves through the non-mesh CLI with its epoch's metrics;
   then ``--mesh 1x1 --no_train --load --predict`` in a group this script
   starts serves S1 with 12 K2 launches and those metrics, and that
   trainer is timed as in phase 10;
9b'. mesh convs: ``gcn``, ``graphsage``, ``gat`` and ``gatv2`` (``--aggr
   mean``) with ``--mesh 1x1`` through ``cli.main`` in a one-rank group
   this script starts, for 1 epoch and 1 evaluation with phase 9's flags
   and seed: K1 (``gcn``, ``graphsage``) or K3/K4, K5/K6 launch exactly
   as on the single card, the epoch's loss sum and the metrics equal the
   single-card run's first epoch within ``MESH_CONV_TOL`` (1e-5 relative
   and 1e-6 for K1's deterministic sums; 1e-2 and 5e-3 for
   ``gat``/``gatv2``, whose K4/K6 add with float atomics: a second
   single-card epoch, run and logged here, differs by ~1e-3 too),
   ``best.pkl`` serves its metrics
   through the non-mesh CLI (1e-6), one step from the single card's
   params, batch and salts gives its loss and gradients (``STEP_TOL``),
   and each trainer is timed as in phase 10;
9c. ltr text: writes S1's ``meta_synced.tsv`` (a title and a description
   per item), ``reviews_text.tsv`` (one review per train and test edge,
   times from the seed) and the loader's two embedding caches (random
   unit vectors from the seed at the encoder's width, 384, with their
   ``.meta`` fingerprints: no encoder runs), and times ``load_ltr_data``;
   from here on each configuration of the text is loaded for real once
   and served from a memo after (``memoize_ltr_loader``: the phases below
   call the CLI on S1's text some twenty times);
9d. ltr: ``ltr_linear --load_base <phase 7's JAX-format pickle> --freeze``
   trained through ``cli.main`` for 2 epochs with ``--predict``: K1
   launches exactly ``6 (base eval) + steps x 6 + evals x 6 + 6
   (predict)`` (forward only: no backward through frozen tables), the
   tables stay the checkpoint's bit for bit, the loss sums are finite and
   fall, ``best.pkl`` serves its epoch's metrics, and the fused top-40 of
   256 users equals the reference's scoring, the ``(B, n_items, F)``
   feature tensor through the uncollapsed tower, up to ties (``LTR_TOL``
   = 1e-4); then one unfrozen ``ltr_linear`` step with the kernels
   against one with the plain versions (``STEP_TOL``); then ``ltr_pop``
   the same (without the step);
9d'. mesh ltr: ``ltr_linear`` and ``ltr_pop --load_base <phase 7's
   pickle> --freeze --mesh 1x1`` through ``cli.main`` in a one-rank group
   this script starts, for 1 epoch and 1 evaluation: K2 launches exactly
   ``6 (base eval) + steps x 6 + 6`` (forward only), the tables stay the
   checkpoint's bit for bit, the loss sum equals phase 9d's first epoch
   within 1e-5 relative, and the fused
   catalogue-sharded top-40 of 256 users equals the single-card head's
   (phase 9d's model with this run's tower) up to ties (``LTR_TOL``);
9e. resume: ``lgcn`` on S1 for 1 epoch, then ``--resume`` for the second
   (K1 as phase 8 a run), against phase 8's uninterrupted run: loss sums
   within 1e-4 relative, metrics 1e-3, tables 1e-3 (nothing promises the
   card's library kernels the same order of sums in two processes; the
   largest differences are printed, and were 0 in every run so far);
9f. refresh: ``lgcn --refresh_every 8`` on S1 for 2 epochs: K1 launches
   exactly ``ceil(steps / 8) x 6`` an epoch plus 6 an eval (forward only),
   the loss sums are finite;
9g. slices 7-9 through ``cli.main`` on S1 (``SLICE_FLAGS``), K1 only:
   ``adv_sampling``, ``text --pos user`` and ``ltr_reviews`` for 2
   epochs, ``kg``, ``reviews`` and ``ltr_kg`` for 1: K1 launches exactly
   ``steps x 18 + evals x 6`` for ``adv_sampling`` (a rank pass forward,
   then the loss pass forward and backward) and ``steps x 12 + evals x 6``
   for the others, every loss component finite; the 2-epoch runs' loss
   sums fall, their ``best.pkl`` serves its epoch's metrics, and one step
   runs against the plain versions (``adv_sampling``: the hard negatives
   selected once on the kernel path feed both loss passes, within
   ``STEP_TOL``; the share of rows whose selection the plain rank pass
   repeats is logged); ``text --pos user`` holds its (item, user) review
   table, one 384-wide row per train edge, on the card;
9h. probes: ``text_probe`` (four metric sets, no launch) and
   ``ltr_simple --load_base <phase 8's lgcn run>`` (the base's evaluation
   and two metric sets: 18 K1 launches);
9i. mining: one draw's hard negatives mined unset and under
   ``TEXTGCN_TPU_ADV_TOPK=0.95``, bit-equal; then, under the target, an
   ``adv_sampling`` step's (2048, 25,000) score, bf16 round and masks,
   ``mining_top_k`` and the whole selection, timed, beside ``torch.topk``
   on the same scores;
9i'. mesh slice: phase 9g's six models with ``--mesh 1x1`` through
   ``cli.main`` in one one-rank group this script starts, for 1 epoch and
   1 evaluation: K2 launches exactly as K1 does on the single card
   (``steps x 18 + 6`` for ``adv_sampling``, ``steps x 12 + 6`` for the
   others) and no other wrapper launches; one step from the single card's
   params, batch, draws and salts within 1e-6 (``adv_sampling``'s hard
   negatives the same in every row: K2 at W = 1 gives K1's bits); the
   epoch's loss sum and metrics against phase 9g's first epoch within
   1e-5 relative and 1e-6, unless a repeated single-card epoch (run here
   first, in-process) already differs by more, when the limits are 4x
   that difference, at least 1e-3 (the log says which rule applied); for
   ``ltr_reviews`` and ``ltr_kg`` the fused sharded top-40 of 256 users
   against the single-card scorer's on the same tables, up to ties; the
   ``adv_sampling`` mesh trainer timed as in phase 10; then
   ``text_probe`` (0 launches) and ``ltr_simple --load_base <phase 8's
   lgcn run>`` (18 K2 launches) with ``--mesh 1x1``: every metric of
   every probe equals phase 9h's within 1e-6;
9j. boosted: ``marcus --load_base <phase 8's lgcn run> --neg_samples 1``
   on S1 (one fit of 10 trees on every train edge and one negative each),
   then ``gbdt`` and ``gbdt_pop --load_base <a random base>`` on 4,096
   users of S1's generator with the whole catalogue (every item given a
   train edge) and S1's 384-wide text: 16 fit batches of 256 users x
   25,000 items, 160 trees; for each, K1 launches exactly 6 for each of
   the base's evaluation, the fit, the evaluation and the prediction
   (forward only), the tables stay the base's bit for bit, the metrics
   are finite, ``predictions.tsv`` has a row per user, and ``--load RUN
   --no_train`` restores ``forest.npz`` and re-serves the metrics
   (1e-6, 6 launches); then ``fit_gbrt`` on the first fit batch on the
   card against the same code on the CPU (the same node structure and
   thresholds, leaf values within 1e-9 relative, scores within 1e-5) on
   the batch's first 64 users' rows (1.6M), and the card's fit of the
   whole batch and ``forest_predict`` (10 and 160 trees) timed against
   the scorer's bound; then ``marcus`` (on S1) and ``gbdt_pop`` (on the
   4,096-user cut) again with ``--mesh 1x1`` (a one-rank group: K2's
   source shard, the fit replicated, the tie-exact sharded top-k): K2
   launches exactly 6 for each of the same four passes and no other
   kernel, ``forest.npz`` bit-equal to the single card's, the metrics
   equal, ``predictions.tsv`` byte-equal, and the ``--load RUN
   --no_train --mesh 1x1`` re-serve the same metrics (6 K2 launches);
9j2. dcp: ``lgcn --mesh 1x1`` on the 4,096-user cut for 1 epoch, then
   ``--resume``d for a second, with ``--ckpt_backend orbax``
   (``torch.distributed.checkpoint``: ``latest_checkpoint.orbax/``,
   ``best.orbax/``, ``resume_state.orbax/``) and with ``pickle``: K2
   launches exactly ``steps x 12 + 6`` a run; the resumed orbax run
   equals the pickle backend's bit for bit (loss sums, metrics, every
   array of the checkpoint and the resume state); its
   ``latest_checkpoint.orbax`` serves on one card without a mesh (6 K1
   launches) the metrics it measured (1e-6);
9j3. encoder: a BERT directory of all-MiniLM-L6-v2's published shape
   (vocab 30,522, hidden 384, 6 layers, 12 heads, 512 positions, ``gelu``)
   with seeded random weights in ``model.safetensors``: 512 sentences
   encoded on the card against the CPU (1e-4); then ``ltr_linear
   --load_base --freeze`` for 1 epoch on a copy of phase 9j's 4,096-user
   cut without caches under ``TEXTGCN_TPU_TEXT_ENCODER=flax`` encodes the
   descriptions and reviews on the card and writes both caches (K1
   exactly ``6 + steps x 6 + 6``; sentences/s logged), and a second run
   reads them and encodes nothing;
9j3'. encoder families: Sentence Transformers directories of six
   published shapes with seeded random weights: all-mpnet-base-v2
   (``mpnet``, hidden 768, 12 layers, 12 heads, FFN 3,072, vocabulary
   30,527, 514 positions, 32 relative buckets; mean pooling,
   ``Normalize``, ``max_seq_length`` 384), all-distilroberta-v1
   (``roberta``, 768, 6 layers, vocabulary 50,265 over a byte-level BPE
   learnt from the cut's text; mean, ``Normalize``, 512),
   msmarco-distilbert-base-v4 (``distilbert``, 768, 6 layers; mean, 512),
   paraphrase-multilingual-MiniLM-L12-v2 (``bert``, 384, 12 layers, FFN
   1,536, vocabulary 250,037) and paraphrase-multilingual-mpnet-base-v2
   (``xlm-roberta``, 768, 12 layers, vocabulary 250,002, 514 positions)
   over XLM-RoBERTa's ``tokenizer.json`` (a 250,002-piece Unigram that
   covers the cut's text, a precompiled NFKC charsmap, ``Metaspace``;
   mean, 128), and distiluse-base-multilingual-cased-v2 (``distilbert``,
   768, 6 layers, vocabulary 119,547 over a cased WordPiece
   ``tokenizer.json``; mean, ``Dense`` 768 -> 512 ``tanh``, 128): for each,
   64 of the cut's texts (for the multilingual ones eight of them
   non-Latin lines) encoded on the card against the CPU (1e-4), and 2,048
   timed on the card and through the tokenizer alone; then ``ltr_linear
   --load_base --freeze`` for 1 epoch on a copy of the cut without caches
   under ``TEXTGCN_TPU_TEXT_ENCODER=st`` over the MPNet directory (every
   text encoded 768 wide on the card, both caches written with unit rows)
   and over the multilingual MiniLM one (384 wide): K1 exactly ``6 + steps
   x 6 + 6`` each;
9j3a. flax dir (before 9j3'): phase 9j3's weights written with Flax's
   layout in ``flax_model.msgpack`` (by ``pack_msgpack``; the card's
   machine has neither ``flax`` nor ``msgpack``), and a copy sharded in
   three files with ``flax_model.msgpack.index.json``, each beside the
   same vocabulary and a ``modules.json`` with CLS pooling: ``read_state``
   of both equals that of phase 9j3's ``model.safetensors`` bit for bit
   (the msgpack read timed); 64 texts encoded under ``auto`` on the card
   against the CPU (1e-4); then ``ltr_linear --load_base --freeze`` for 1
   epoch on a fresh copy of the cut with ``TEXTGCN_TPU_TEXT_ENCODER``
   unset over the Flax-only directory: ``auto`` runs the Flax recipe (one
   warning an encode call; ``modules.json`` unread), K1 exactly ``6 +
   steps x 6 + 6``, and both caches byte-equal to phase 9j3's ``flax``
   run's;
9j4. health check: a probe of the card, and the ``Device backend ready``
   line of phase 9j3's first CLI run;
9j5. cold_report: a 5,000 x 2,000 ``--sharp --cold 0.2`` set, ``lgcn``
   trained 2 epochs, ``tools/cold_report.main --load`` (12 K1 launches):
   the ``all``, ``warm`` and ``cold`` metrics finite and in [0, 1];
9j6. tools: ``tools/sem_cold_sweep --quick --rows 2`` on the card (the
   ``lgcn`` base and the grid's first two ``kg`` rows, trained through
   ``cli.main`` and scored by ``cold_report``; every metric in [0, 1]; K1
   only), and ``tools/make_dummy`` into a temporary directory, byte for
   byte ``data/dummy``;
9k. trace: ``lgcn --epochs 1 --trace DIR`` through ``cli.main`` on the
   boosted phase's 4,096-user cut of S1 (S1's widths): K1 launches
   exactly ``steps x 12 + 6``, the ``torch.profiler`` trace parses and
   holds exactly that many device events of K1's kernel
   (``spmm_dropout_kernel``);
9l. quality: the 50,000 x 20,000 ``--sharp`` set written on the host by
   the port's generator (``tools/make_synthetic.py``, seed 0), then
   ``lgcn`` trained on it through ``cli.main`` with the quality sweep's
   flags (``tools/conv_quality_sweep.run_argv``: 60 epochs, lr 0.005,
   an evaluation every 5 epochs, batch 2048, the rest at their
   defaults): the best recall@20 read from ``resume_state.pkl`` must
   reach ``QUALITY_FLOOR`` (0.790; the JAX package's TPU control reached
   0.8002), K1 launches exactly ``epochs x steps x 12 + evals x 6`` over
   the epochs the run took, and the best metrics at 20 and 40 are logged
   beside ``QUALITY_r05.jsonl``'s ``lgcn`` row;
10. timing: ms per training step and examples/s of each model at S1, and
   of the frozen ``ltr_linear``, the ``--refresh_every 8``,
   ``adv_sampling`` and ``text --pos user`` steps (and in phase 9i' the
   ``adv_sampling --mesh 1x1`` step), split
   into sampling, forward, backward and Adam (and the refresh), host clock
   around synchronised work, the host's enqueue share of an
   unsynchronised run of steps, and the device's busy time per step, and
   each hand-written kernel's, from a ``torch.profiler`` trace of 10
   more.

The line before the last is ``{"kernels": [...]}`` with each kernel's
launches on the main paths (K1-K6) or the lab paths (L1-L3), error,
times and bound; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import csv
import copy
import itertools
import json
import os
import pickle
import re
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# S1: the JAX package's bench shape (bench.py, tools/scale_bench.py)
S1_USERS, S1_ITEMS, S1_DEG = 60_000, 25_000, 10
D, LAYERS, BATCH, KS = 64, 3, 2048, (20, 40)
HOLDOUT = 0.1
SALT = 0x9E3779B9            # high bit set: exercises the uint32 hash path
KEEP_DROPOUT = float(np.float32(1.0 - 0.4))   # float32(1 - p), p = 0.4
TOL = 1e-5
GAT_BWD_TOL = 1e-4
# K3 and K4 on the Amazon-Book graph against their plain versions: phase
# 4's tolerances were set for S1's rows of at most 47 edges; these hold up
# to 4,896, and the rounding of a float32 sum, in the kernel's order and in
# the plain version's (index_add's atomics on the card), grows as the
# square root of its length: sqrt(4896 / 47) ~ 10.  K3's num at keep 1
# read 1.14 and 2.42 of phase 4's own in two runs (PERF.md, section 6)
BOOK_ATT_SCALE = 10.0
# widths that take the redesigned kernels' other instances, held against
# their plain versions on one direction at keep 0.6: K1 and K2 (vec,
# lanes) (ops/spmm.k1_layout) (4, 8), (4, 16) with idle lanes, (2, 32),
# (4, 32) and (4, 32) over two column strips, and for K2 also (2, 8) and
# (2, 16), with S1's (4, 16) every instance it builds; K3, K4, K5 and K6
# (vec, per) (ops/gat.att_layout) (2, 1), (2, 2), (2, 4), (4, 2), (2, 8)
# and (4, 4): with S1's (4, 1), every instance they build
K1_WIDTHS = (32, 48, 62, 128, 256)
# the benchmark's skewed graph, where K1 splits its long rows
BOOK_CONFIG = os.path.join(REPO, 'portbench', 'configs',
                           'lgcn-amazon-book.json')
K2_WIDTHS = (14, 30) + K1_WIDTHS
ATT_WIDTHS = (30, 62, 126, 128, 254, 256)
STEP_TOL = 1e-4
TRAIN_EPOCHS = 2
N_CHECK_USERS = 256
# the LTR head's fused top-k against the reference's (B, n_items, F)
# scoring: f32 sums of ~830 products in another order
LTR_TOL = 1e-4
# a resumed run against the uninterrupted one on the card
RESUME_TOL, RESUME_METRIC_TOL, RESUME_TABLE_TOL = 1e-4, 1e-3, 1e-3
REFRESH = 8


def log(msg: str):
    print(msg, flush=True)


def check(ok: bool, msg: str):
    if not ok:
        raise SystemExit(f'chip_smoke FAILED: {msg}')


def synth_edges(n_users, n_items, avg_deg, seed=0):
    """Unique random (user, item) pairs with 1/sqrt(deg_u deg_i) weights:
    the generator of ``tools/scale_bench.py`` (``synth_edges``)."""
    rng = np.random.RandomState(seed)
    n_edges = n_users * avg_deg
    eu = rng.randint(0, n_users, n_edges).astype(np.int32)
    ei = rng.randint(0, n_items, n_edges).astype(np.int32)
    pairs = np.unique(np.stack([eu, ei], 1), axis=0)
    eu, ei = pairs[:, 0], pairs[:, 1]
    du = np.bincount(eu, minlength=n_users)
    di = np.bincount(ei, minlength=n_items)
    with np.errstate(divide='ignore'):
        w = 1.0 / np.sqrt(du[eu].astype(np.float64) * di[ei])
    w[~np.isfinite(w)] = 0
    return eu, ei, w.astype(np.float32)


def write_dataset(root: str, n_users: int, n_items: int, avg_deg: int,
                  seed: int = 0, every_item: bool = False,
                  name: str = 's1') -> str:
    """S1 interactions as ``train.tsv``/``test.tsv`` under ``root/name``.

    Every user keeps at least one train edge (a user without any edge
    gets one random item); with ``every_item``, by the same rule, every
    item too (an item without any edge gets one random user; a smaller
    user count keeps the whole catalogue so); about ``HOLDOUT`` of each
    user's other edges go to the test file, and only items that keep a
    train edge.
    """
    rng = np.random.RandomState(seed)
    eu, ei, _ = synth_edges(n_users, n_items, avg_deg, seed)
    missing = np.setdiff1d(np.arange(n_users), eu)
    if missing.size:
        extra = rng.randint(0, n_items, missing.size)
        pairs = np.unique(np.concatenate(
            [np.stack([eu, ei], 1), np.stack([missing, extra], 1)]), axis=0)
        eu, ei = pairs[:, 0], pairs[:, 1]
    if every_item:
        lonely = np.setdiff1d(np.arange(n_items), ei)
        extra = rng.randint(0, n_users, lonely.size)
        pairs = np.unique(np.concatenate(
            [np.stack([eu, ei], 1), np.stack([extra, lonely], 1)]), axis=0)
        eu, ei = pairs[:, 0], pairs[:, 1]
    keep = np.zeros(len(eu), bool)               # each item's train edge
    if every_item:
        keep[np.unique(ei, return_index=True)[1]] = True
    first = np.r_[True, eu[1:] != eu[:-1]]      # pairs are sorted by user
    test = (rng.rand(len(eu)) < HOLDOUT) & ~first & ~keep
    has_train = np.zeros(n_items, bool)
    has_train[ei[~test]] = True
    test &= has_train[ei]
    out = os.path.join(root, name)
    os.makedirs(out, exist_ok=True)
    for name, sel in (('train.tsv', ~test), ('test.tsv', test)):
        lines = [f'u{u}\ti{i}' for u, i in zip(eu[sel].tolist(),
                                               ei[sel].tolist())]
        with open(os.path.join(out, name), 'w') as f:
            f.write('user_id\tasin\n' + '\n'.join(lines) + '\n')
    return out


def write_jax_checkpoint(path: str, n_users: int, n_items: int, d: int,
                         seed: int = 0, model: str = 'lgcn',
                         conv_keys: tuple[str, ...] = (), layers: int = 0):
    """A pickle in the JAX package's format: N(0, 0.1) tables padded to a
    multiple of 4096 rows, as its Pallas backend writes them; with
    ``conv_keys``, ``layers`` conv layers of N(0, 0.2) weights, ``(d, d)``
    for a ``w*`` key and ``(d,)`` for the others."""
    rng = np.random.RandomState(seed)
    pad = lambda n: -(-n // 4096) * 4096  # noqa: E731
    params = {
        'user_emb': (0.1 * rng.randn(pad(n_users), d)).astype(np.float32),
        'item_emb': (0.1 * rng.randn(pad(n_items), d)).astype(np.float32),
    }
    if conv_keys:
        params['convs'] = [
            {k: (0.2 * rng.randn(*((d, d) if k.startswith('w') else (d,))))
             .astype(np.float32) for k in conv_keys}
            for _ in range(layers)]
    with open(path, 'wb') as f:
        pickle.dump({'params': params, 'epoch': 0, 'model': model}, f)


def nvidia_smi(fields: str) -> str:
    from textgcn_tpu_torch.tools import timing
    return timing.nvidia_smi(fields)


def card_name_and_power() -> str:
    return nvidia_smi('name,power.limit')


def time_ms(*args, **kwargs) -> dict[str, float]:
    """``textgcn_tpu_torch.tools.timing.time_ms``: median device ms of
    single launches behind a spin kernel, variants in turns."""
    from textgcn_tpu_torch.tools import timing
    return timing.time_ms(*args, **kwargs)


def bound_ms(csr, d: int, n_kept: int | None = None) -> tuple[float, str]:
    """Least time for one direction on the card: every input read once
    (x table, CSR), the output written once, and 2*d f32 operations for
    each of the ``n_kept`` edges whose weight is not 0 (default: every
    edge), against the published peaks."""
    nbytes = 4 * (csr.n_src * d + csr.rowptr.numel() + csr.col.numel()
                  + csr.w.numel() + csr.n_dst * d)
    from textgcn_tpu_torch.tools import timing
    n_kept = csr.n_edges if n_kept is None else n_kept
    return timing.bound_ms(nbytes, 2 * n_kept * d)


def loader_phase(data_dir: str, data) -> dict:
    """The native interaction reader against the plain Python one on S1:
    ``load_interactions`` with ``TEXTGCN_TPU_NATIVE=0`` gives the same
    edges, weights, id maps and test lists as the native load (``data``);
    both are timed (the native one by the caller)."""
    from textgcn_tpu_torch import native
    from textgcn_tpu_torch.data.core import load_interactions
    old = os.environ.get(native.ENV)
    os.environ[native.ENV] = '0'
    try:
        t0 = time.perf_counter()
        plain = load_interactions(data_dir)
        plain_s = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop(native.ENV, None)
        else:
            os.environ[native.ENV] = old
    g, h = data.graph, plain.graph
    same = all(np.array_equal(getattr(g, k), getattr(h, k))
               for k in ('edge_user', 'edge_item', 'edge_weight',
                         'user_degree', 'item_degree')) and all(
        np.array_equal(getattr(data, k), getattr(plain, k))
        for k in ('pos_padded', 'test_users')) and (
        data.user_id_map == plain.user_id_map
        and data.item_id_map == plain.item_id_map
        and data.true_test == plain.true_test
        and (data.n_train, data.n_test) == (plain.n_train, plain.n_test))
    check(same, 'the native reader and the Python reader disagree on S1')
    return {'python_reader_s': plain_s}


def kernel_phase(data, dev) -> dict:
    """K1 against spmm_plain on the S1 graph, then its times."""
    from textgcn_tpu_torch.ops.spmm import (GraphOp, spmm_dropout_cuda,
                                            spmm_plain)
    g = data.graph
    op = GraphOp(g.edge_user, g.edge_item, g.edge_weight, data.n_users,
                 data.n_items, dev)
    gen = torch.Generator().manual_seed(1)
    tables = {'to_user': torch.randn(data.n_items, D, generator=gen),
              'to_item': torch.randn(data.n_users, D, generator=gen)}
    max_err = 0.0
    result = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0, 'bound_ms': 0.0,
              'ms_keep_0_6': 0.0}
    bytes_bound = True
    for direction, csr in (('to_user', op.l_i2u), ('to_item', op.l_u2i)):
        x = tables[direction].to(dev)
        for keep in (1.0, KEEP_DROPOUT):
            got = spmm_dropout_cuda(csr, x, SALT, keep)
            want = spmm_plain(csr, x, SALT, keep)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            log(f'kernel {direction} keep={keep:.7g}: max_abs_err={err:.3e}')
            check(torch.allclose(got, want, atol=TOL, rtol=TOL),
                  f'K1 {direction} keep={keep} disagrees with spmm_plain '
                  f'(max abs err {err:.3e})')
        with warnings.catch_warnings():   # "sparse CSR is in beta"
            warnings.simplefilter('ignore', UserWarning)
            lib = torch.sparse_csr_tensor(csr.rowptr, csr.col, csr.w,
                                          size=(csr.n_dst, csr.n_src))
        t = time_ms({'plain': lambda: spmm_plain(csr, x, 0, 1.0),
                     'kernel': lambda: spmm_dropout_cuda(csr, x, 0, 1.0),
                     'library': lambda: torch.sparse.mm(lib, x)},
                    ['plain', 'kernel', 'library', 'library', 'kernel',
                     'plain'])
        t_drop = time_ms({'kernel': lambda: spmm_dropout_cuda(
            csr, x, SALT, KEEP_DROPOUT)}, ['kernel', 'kernel'])
        b, by = bound_ms(csr, D)
        bytes_bound &= by == 'bytes'
        log(f'timing {direction} (E={csr.n_edges}, {csr.n_dst}x{csr.n_src}, '
            f'd={D}): kernel {t["kernel"]:.4f} ms, kernel keep=0.6 '
            f'{t_drop["kernel"]:.4f} ms, plain {t["plain"]:.4f} ms, '
            f'torch.sparse.mm {t["library"]:.4f} ms, bound {b:.4f} ms '
            f'({by})')
        result['ms'] += t['kernel']
        result['ms_keep_0_6'] += t_drop['kernel']
        result['plain_ms'] += t['plain']
        result['library_ms'] += t['library']
        result['bound_ms'] += b
    log('clocks after timing (sm, max sm, power, temperature): '
        + nvidia_smi('clocks.sm,clocks.max.sm,power.draw,temperature.gpu'))
    result['max_abs_err'] = max_err
    result['bound_by'] = 'bytes' if bytes_bound else 'operations'
    result['max_abs_err_by_width'] = {}
    for d in K1_WIDTHS:
        x = torch.randn(op.n_items, d, generator=gen).to(dev)
        got = spmm_dropout_cuda(op.l_i2u, x, SALT, KEEP_DROPOUT)
        want = spmm_plain(op.l_i2u, x, SALT, KEEP_DROPOUT)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        result['max_abs_err_by_width'][d] = err
        log(f'kernel to_user d={d} keep={KEEP_DROPOUT:.7g}: max_abs_err='
            f'{err:.3e}')
        check(torch.allclose(got, want, atol=TOL, rtol=TOL),
              f'K1 at d={d} disagrees with spmm_plain (max abs err '
              f'{err:.3e})')
    return result


def book_graph():
    """``lgcn-amazon-book``'s train graph, as the benchmark draws it
    (``portbench.graphgen``; rows of up to 4,896 edges), with the
    program's weights ``1/sqrt(deg_u * deg_i)``: ``(user, item, w,
    n_users, n_items)``."""
    from portbench import graphgen
    with open(BOOK_CONFIG) as f:
        inter = graphgen.generate(json.load(f)['dataset'])
    eu, ei = inter.train_user, inter.train_item
    du = 1.0 / np.sqrt(np.bincount(eu, minlength=inter.n_users)[eu])
    di = 1.0 / np.sqrt(np.bincount(ei, minlength=inter.n_items)[ei])
    return eu, ei, (du * di).astype(np.float32), inter.n_users, inter.n_items


def book_kernel_phase(dev) -> dict:
    """K1 where its split schedule engages: on the Amazon-Book graph, both
    directions at keep 1 and 0.6, forward and backward (``GraphOp``'s
    autograd: the backward is K1 on the transpose) against
    ``spmm_plain`` within TOL; two launches give the same bits; every
    launch ran the schedule; each direction timed at both keeps beside
    its bound.  Then K3 and K4 on the same graph
    (``book_attention_phase``)."""
    from textgcn_tpu_torch.ops.spmm import (GraphOp, edge_mask,
                                            spmm_dropout_cuda, spmm_plain)
    t0 = time.perf_counter()
    eu, ei, w, n_users, n_items = book_graph()
    op = GraphOp(eu, ei, w, n_users, n_items, dev)
    log(f'book kernel: graph {len(eu)} train edges, {n_users} x {n_items}, '
        f'drawn and built in {time.perf_counter() - t0:.3f} s')
    gen = torch.Generator().manual_seed(25)
    res = {'max_abs_err': 0.0}
    launches = spmm_dropout_cuda.launches
    split = spmm_dropout_cuda.split_launches
    for direction in ('to_user', 'to_item'):
        fwd, bwd = op.csr_pair(direction)
        x = torch.randn(fwd.n_src, D, generator=gen).to(dev)
        g = torch.randn(fwd.n_dst, D, generator=gen).to(dev)
        lengths = fwd.rowptr[1:] - fwd.rowptr[:-1]
        row = {'max_row': int(lengths.max()), 'split_rows': fwd.split_rows,
               'chunks': fwd.chunks,
               'split_edge_share': fwd.split_edge_share}
        for keep in (1.0, KEEP_DROPOUT):
            pair = (SALT, keep)
            xg = x.clone().requires_grad_()
            out = getattr(op, direction)(xg, pair)
            out.backward(g)
            again = spmm_dropout_cuda(fwd, x, *pair)
            want = spmm_plain(fwd, x, *pair)
            want_g = spmm_plain(bwd, g, *pair)
            torch.cuda.synchronize()
            for part, got, ref in (('forward', out.detach(), want),
                                   ('backward', xg.grad, want_g)):
                err = float((got - ref).abs().max())
                res['max_abs_err'] = max(res['max_abs_err'], err)
                log(f'book kernel {direction} {part} keep={keep:.7g}: '
                    f'max_abs_err={err:.3e}')
                check(torch.allclose(got, ref, atol=TOL, rtol=TOL),
                      f'K1 on the book graph, {direction} {part} keep={keep}'
                      f', disagrees with spmm_plain (max abs err {err:.3e})')
            check(torch.equal(out.detach(), again),
                  f'K1 on the book graph, {direction} keep={keep}: two '
                  'launches give different bits')
            t = time_ms({'kernel': lambda: spmm_dropout_cuda(fwd, x, *pair)},
                        ['kernel', 'kernel'])
            n_kept = int(edge_mask(fwd, SALT, keep)[2].sum())
            b, by = bound_ms(fwd, D, n_kept)
            key = 'keep_1' if keep >= 1.0 else 'keep_0_6'
            row[f'ms_{key}'] = t['kernel']
            row[f'bound_ms_{key}'] = b
            log(f'timing book {direction} (E={fwd.n_edges}, max row '
                f'{row["max_row"]}, {fwd.split_rows} split rows in '
                f'{fwd.chunks} chunks, {fwd.split_edge_share:.4f} of the '
                f'edges; kept {n_kept}, d={D}) keep={keep:.7g}: kernel '
                f'{t["kernel"]:.4f} ms, bound {b:.4f} ms ({by}, '
                f'{100 * b / t["kernel"]:.2f}%)')
        res[direction] = row
    n = spmm_dropout_cuda.launches - launches
    check(spmm_dropout_cuda.split_launches - split == n > 0,
          f'K1 ran its split schedule in '
          f'{spmm_dropout_cuda.split_launches - split} of {n} launches on '
          'the book graph')
    log('clocks after timing (sm, max sm, power, temperature): '
        + nvidia_smi('clocks.sm,clocks.max.sm,power.draw,temperature.gpu'))
    res['attention'] = book_attention_phase(op, dev)
    return res


def book_attention_phase(op, dev) -> dict:
    """K3 and K4 where no group shares a long row: on the Amazon-Book
    graph's CSRs (``op``; the kernels read only their structure), both
    directions at keep 1 and 0.6, with phase 4's unit-scale inputs: K3
    against ``gat_att_plain`` (its ``m`` bit for bit), K4, fed K3's ``m``,
    against ``gat_bwd_plain``, each within phase 4's tolerance times
    ``BOOK_ATT_SCALE`` (the share of phase 4's own is logged); every
    launch counted as walking a long row; each timed beside the
    benchmark's least time of one launch (``portbench.work_gat``)."""
    from portbench import work_gat
    from textgcn_tpu_torch.ops import gat
    gen = torch.Generator().manual_seed(26)
    res = {'gat_fwd': {'max_abs_err': 0.0, 'tol_share': 0.0},
           'gat_bwd': {'max_abs_err': 0.0, 'tol_share': 0.0}}
    counts = [(f.launches, f.long_row_launches)
              for f in (gat.gat_fwd_cuda, gat.gat_bwd_cuda)]

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    for direction in ('to_user', 'to_item'):
        fwd, bwd = op.csr_pair(direction)
        n_src, n_dst = fwd.n_src, fwd.n_dst
        ins = (rand(n_src, D), rand(n_src), rand(n_dst))
        g_num, g_den = rand(n_dst, D), rand(n_dst)
        for keep in (1.0, KEEP_DROPOUT):
            got = gat.gat_fwd_cuda(fwd, *ins, SALT, keep)
            want = gat.gat_att_plain(fwd, *ins, SALT, keep)
            m = got[2]
            got_b = gat.gat_bwd_cuda(bwd, *ins, m, g_num, g_den, SALT, keep)
            want_b = gat.gat_bwd_plain(bwd, *ins, m, g_num, g_den, SALT,
                                       keep)
            torch.cuda.synchronize()
            key = 'keep_1' if keep >= 1.0 else 'keep_0_6'
            for name, a, b, tol, work, csr in (
                    ('gat_fwd', got, want, TOL, work_gat.k3, fwd),
                    ('gat_bwd', got_b, want_b, GAT_BWD_TOL, work_gat.k4,
                     bwd)):
                errs = [float((x - y).abs().max()) for x, y in zip(a, b)]
                share = tol_share(zip(a, b), tol, (False,) * 3)
                r = res[name]
                r['max_abs_err'] = max(r['max_abs_err'], *errs)
                r['tol_share'] = max(r['tol_share'], share)
                log(f'book {name} {direction} keep={keep:.7g}: max_abs_err '
                    + ', '.join(f'{out} {e:.3e} of {float(y.abs().max()):.3g}'
                                for out, e, y in zip(OUTPUTS[name], errs, b))
                    + f'; {share:.3f} of phase 4\'s tolerance')
                check(all(agree(x, y, BOOK_ATT_SCALE * tol, False)
                          for x, y in zip(a, b)),
                      f'{name} on the book graph, {direction} keep={keep}, '
                      f'disagrees with its plain version ({errs})')
                check(name != 'gat_fwd' or torch.equal(a[2], b[2]),
                      f'K3 on the book graph, {direction} keep={keep}: m is '
                      'not the max of the kept logits bit for bit')
                extra = () if name == 'gat_fwd' else (m, g_num, g_den)
                kernel = getattr(gat, f'{name}_cuda')
                t = time_ms({'kernel': lambda kernel=kernel, csr=csr,
                             extra=extra: kernel(csr, *ins, *extra, SALT,
                                                 keep)},
                            ['kernel', 'kernel'])['kernel']
                w = work(n_src, n_dst, fwd.n_edges, D, keep)
                bound = w.least_s() * 1e3
                r[f'{direction}_ms_{key}'] = t
                r[f'{direction}_bound_ms_{key}'] = bound
                log(f'timing book {name} {direction} (E={fwd.n_edges}, max '
                    f'row {int((csr.rowptr[1:] - csr.rowptr[:-1]).max())}, '
                    f'd={D}) keep={keep:.7g}: kernel {t:.4f} ms, bound '
                    f'{bound:.4f} ms ({100 * bound / t:.2f}%)')
    for (n0, long0), f in zip(counts, (gat.gat_fwd_cuda, gat.gat_bwd_cuda)):
        n, long_rows = f.launches - n0, f.long_row_launches - long0
        check(n > 0 and long_rows == n,
              f'{f.__name__}: {long_rows} of its {n} launches on the book '
              'graph counted as walking a long row')
    log('clocks after timing (sm, max sm, power, temperature): '
        + nvidia_smi('clocks.sm,clocks.max.sm,power.draw,temperature.gpu'))
    return res


def k2_phase(data, dev) -> dict:
    """K2 against spmm_weighted_plain on W = 1 and W = 4 source-range
    shards of the S1 graph, the four shards' sum against K1, then times.

    Returns one layer's (to_user + to_item) times and bound at W = 1, and
    the same per shard at W = 4 (the mean over the four shards)."""
    from textgcn_tpu_torch.ops.spmm import (GraphOp, edge_dropout_scale,
                                            spmm_dropout_cuda,
                                            spmm_weighted_cuda,
                                            spmm_weighted_plain)
    from textgcn_tpu_torch.parallel.sharded_spmm import build_shard
    g = data.graph
    op = GraphOp(g.edge_user, g.edge_item, g.edge_weight, data.n_users,
                 data.n_items, dev)
    gen = torch.Generator().manual_seed(4)
    res = {'max_abs_err': 0.0, 'max_abs_err_vs_k1': 0.0}
    res.update((f'{t}{key}', 0.0)
               for t in ('ms', 'plain_ms', 'library_ms', 'bound_ms',
                         'ms_w4_per_shard', 'plain_ms_w4_per_shard',
                         'bound_ms_w4_per_shard')
               for key in ('', '_keep_0_6'))
    by = set()
    for direction, full, src, dst, n_src, n_dst, dst_is_user in (
            ('to_user', op.l_i2u, g.edge_item, g.edge_user, data.n_items,
             data.n_users, True),
            ('to_item', op.l_u2i, g.edge_user, g.edge_item, data.n_users,
             data.n_items, False)):
        for n_ranks in (1, 4):
            n_src_p = -(-n_src // n_ranks) * n_ranks
            n_dst_p = -(-n_dst // n_ranks) * n_ranks
            x = torch.zeros(n_src_p, D)
            x[:n_src] = torch.randn(n_src, D, generator=gen)
            x = x.to(dev)
            per = n_src_p // n_ranks
            shards = [build_shard(src, dst, g.edge_weight, n_src_p, n_dst_p,
                                  n_ranks, r, dst_is_user, dev)
                      for r in range(n_ranks)]
            weights = {}
            if (direction, n_ranks) == ('to_user', 1):
                w1_to_user = shards[0], weights
            for keep in (1.0, KEEP_DROPOUT):
                total = torch.zeros(n_dst_p, D, device=dev)
                for r, sh in enumerate(shards):
                    w = sh.csr.w if keep >= 1.0 else sh.csr.w * \
                        edge_dropout_scale(sh.users, sh.items, SALT, keep)
                    weights[r, keep] = w
                    xr = x[r * per:(r + 1) * per]
                    got = spmm_weighted_cuda(sh.csr, w, xr)
                    want = spmm_weighted_plain(sh.csr, w, xr)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    res['max_abs_err'] = max(res['max_abs_err'], err)
                    check(torch.allclose(got, want, atol=TOL, rtol=TOL),
                          f'K2 {direction} W={n_ranks} shard {r} keep={keep}'
                          f' disagrees with spmm_weighted_plain (max abs err '
                          f'{err:.3e})')
                    total += got
                k1 = spmm_dropout_cuda(full, x[:n_src], SALT, keep)
                torch.cuda.synchronize()
                err_k1 = float((total[:n_dst] - k1).abs().max())
                log(f'K2 {direction} W={n_ranks} keep={keep:.7g}: max_abs_err '
                    f'vs plain {res["max_abs_err"]:.3e}, sum of shards vs K1 '
                    f'{err_k1:.3e}')
                check(torch.allclose(total[:n_dst], k1, atol=TOL, rtol=TOL)
                      and not total[n_dst:].any(),
                      f'K2 {direction} W={n_ranks} keep={keep}: the sum of '
                      f'the shards disagrees with K1 ({err_k1:.3e})')
                if n_ranks == 1:
                    # the same weights in the same order: K1's bits
                    check(torch.equal(total, k1),
                          f'K2 {direction} W=1 keep={keep} is not bit-equal '
                          f'to K1')
                else:
                    res['max_abs_err_vs_k1'] = max(res['max_abs_err_vs_k1'],
                                                   err_k1)
            for keep in (1.0, KEEP_DROPOUT):
                key = '' if keep >= 1.0 else '_keep_0_6'
                if n_ranks == 1:
                    csr, w = shards[0].csr, weights[0, keep]
                    with warnings.catch_warnings():   # "sparse CSR is in beta"
                        warnings.simplefilter('ignore', UserWarning)
                        lib = torch.sparse_csr_tensor(
                            csr.rowptr, csr.col, w,
                            size=(csr.n_dst, csr.n_src))
                    t = time_ms(
                        {'plain': lambda: spmm_weighted_plain(csr, w, x),
                         'kernel': lambda: spmm_weighted_cuda(csr, w, x),
                         'library': lambda: torch.sparse.mm(lib, x)},
                        ['plain', 'kernel', 'library', 'library', 'kernel',
                         'plain'])
                    n_kept = int((w != 0).sum())
                    b, b_by = bound_ms(csr, D, n_kept)
                    by.add(b_by)
                    log(f'timing K2 {direction} W=1 keep={keep:.7g} (E='
                        f'{csr.n_edges}, kept {n_kept}, {csr.n_dst}x'
                        f'{csr.n_src}, d={D}): kernel {t["kernel"]:.4f} ms, '
                        f'plain {t["plain"]:.4f} ms, torch.sparse.mm '
                        f'{t["library"]:.4f} ms, bound {b:.4f} ms ({b_by})')
                    res['ms' + key] += t['kernel']
                    res['plain_ms' + key] += t['plain']
                    res['library_ms' + key] += t['library']
                    res['bound_ms' + key] += b
                    continue
                for r, sh in enumerate(shards):
                    xr, w = x[r * per:(r + 1) * per], weights[r, keep]
                    t = time_ms(
                        {'kernel': lambda: spmm_weighted_cuda(sh.csr, w, xr),
                         'plain': lambda: spmm_weighted_plain(sh.csr, w, xr)},
                        ['plain', 'kernel', 'kernel', 'plain'])
                    n_kept = int((w != 0).sum())
                    b, _ = bound_ms(sh.csr, D, n_kept)
                    log(f'timing K2 {direction} W=4 shard {r} keep={keep:.7g}'
                        f' (E={sh.csr.n_edges}, kept {n_kept}, {sh.csr.n_dst}'
                        f'x{sh.csr.n_src}): kernel {t["kernel"]:.4f} ms, '
                        f'plain {t["plain"]:.4f} ms, bound {b:.4f} ms')
                    res['ms_w4_per_shard' + key] += t['kernel'] / n_ranks
                    res['plain_ms_w4_per_shard' + key] += t['plain'] / n_ranks
                    res['bound_ms_w4_per_shard' + key] += b / n_ranks
    log('clocks after timing (sm, max sm, power, temperature): '
        + nvidia_smi('clocks.sm,clocks.max.sm,power.draw,temperature.gpu'))
    res['bound_by'] = 'bytes' if by == {'bytes'} else 'operations'

    # K2's other instances: the W = 1 to_user shard at keep 0.6
    sh, weights = w1_to_user
    w = weights[0, KEEP_DROPOUT]
    res['max_abs_err_by_width'] = {}
    for d in K2_WIDTHS:
        x = torch.randn(sh.csr.n_src, d, generator=gen).to(dev)
        got = spmm_weighted_cuda(sh.csr, w, x)
        want = spmm_weighted_plain(sh.csr, w, x)
        k1 = spmm_dropout_cuda(op.l_i2u, x, SALT, KEEP_DROPOUT)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        res['max_abs_err_by_width'][d] = err
        log(f'K2 to_user W=1 d={d} keep={KEEP_DROPOUT:.7g}: max_abs_err '
            f'{err:.3e}, bit-equal to K1 {torch.equal(got, k1)}')
        check(torch.allclose(got, want, atol=TOL, rtol=TOL),
              f'K2 at d={d} disagrees with spmm_weighted_plain (max abs err '
              f'{err:.3e})')
        check(torch.equal(got, k1), f'K2 at d={d} is not bit-equal to K1')
    return res


def lab_phase(dev) -> dict:
    """L1-L3 through the two lab entry points, counted from 0 (every L1
    mode at bf16 and f32 x, both gathers), then each kernel held against
    its plain version at the labs' full shapes and timed in turns with it
    and with a library yardstick.  Returns the rows' numbers."""
    from textgcn_tpu_torch.ops.spmm import build_csr, spmm_weighted_cuda
    from textgcn_tpu_torch.tools import gather_lab, kernel_lab, timing
    from textgcn_tpu_torch.tools.lab_layout import tile_layout
    l1, l2, l3 = (kernel_lab.spmm_lab_cuda, gather_lab.gather_rows_cuda,
                  gather_lab.gather_rows_bulk_cuda)
    dtypes = {'bf16': torch.bfloat16, 'f32': torch.float32}

    reset_counts()
    t = time.perf_counter()
    entry = {}
    old = os.environ.get(kernel_lab.XDTYPE_ENV)
    try:
        for xd in dtypes:
            os.environ[kernel_lab.XDTYPE_ENV] = xd
            entry[xd] = kernel_lab.main(list(kernel_lab.MODES))
    finally:
        if old is None:
            os.environ.pop(kernel_lab.XDTYPE_ENV, None)
        else:
            os.environ[kernel_lab.XDTYPE_ENV] = old
    entry['gather'] = gather_lab.main(list(gather_lab.MODES))
    launches = counts()
    per_mode = 2 * (timing.WARMUP + timing.TIMED_LAUNCHES)
    want = dict.fromkeys(launches, 0)
    want.update(spmm_lab=per_mode * len(kernel_lab.MODES) * len(dtypes),
                gather_rows=per_mode, gather_rows_bulk=per_mode)
    log(f'labs: the entry points took {time.perf_counter() - t:.3f} s; '
        f'launches {launches}')
    check(launches == want, f'labs: launches {launches}, expected {want}')

    # L1: every mode at both dtypes vs plain
    src, dst, w, rng = kernel_lab.lab_graph()
    layout = tile_layout(src, dst, w, kernel_lab.NI, kernel_lab.NU).to(dev)
    x32 = kernel_lab.lab_x(rng, layout.n_src_padded, torch.float32).to(dev)
    xs = {xd: x32.to(dt) for xd, dt in dtypes.items()}
    l1_err, full_out = 0.0, None
    for xd, x in xs.items():
        for mode in kernel_lab.MODES:
            want_out = kernel_lab.spmm_lab_plain(layout, x, mode)
            got = l1(layout, x, mode)
            torch.cuda.synchronize()
            err = float((got - want_out).abs().max())
            check(torch.allclose(got, want_out, atol=TOL, rtol=TOL),
                  f'L1 {mode} x={xd} disagrees with spmm_lab_plain (max abs '
                  f'err {err:.3e})')
            l1_err = max(l1_err, err)
            log(f'L1 {mode} x={xd}: max_abs_err {err:.3e}')
            if (xd, mode) == ('f32', 'full'):
                full_out = got

    # small layouts: an edgeless destination block, group 1, 3 and 8, one
    # and two 64-column slices (d = 128), every mode at both dtypes
    small = lab_small_layouts(dev)
    for (group, d, xd), (lay, x) in small.items():
        for mode in kernel_lab.MODES:
            want_out = kernel_lab.spmm_lab_plain(lay, x, mode)
            got = l1(lay, x, mode)
            torch.cuda.synchronize()
            err = float((got - want_out).abs().max())
            check(torch.allclose(got, want_out, atol=TOL, rtol=TOL),
                  f'L1 {mode} x={xd} group={group} d={d} on the small '
                  f'layout disagrees with spmm_lab_plain (max abs err '
                  f'{err:.3e})')
            check(not got[1024:1536].any(), f'L1 {mode} x={xd} group='
                  f'{group} d={d} wrote into the edgeless block')
            l1_err = max(l1_err, err)
    log(f'L1 on the small layouts (edgeless block; group 1, 3, 8; d = 64, '
        f'128; both dtypes; every mode): {len(small) * len(kernel_lab.MODES)}'
        f' launches agree with spmm_lab_plain')

    # the same edges as a destination-sorted CSR: torch.sparse.mm with
    # duplicates summed (the yardstick), and K2, the port's own SpMM
    n_dst_p = layout.n_dst_blocks * layout.dst_block
    k2_csr = build_csr(dst, src, w, n_dst_p, layout.n_src_padded, True, dev)
    with warnings.catch_warnings():   # "sparse CSR is in beta"
        warnings.simplefilter('ignore', UserWarning)
        lib = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([dst, src]).astype(np.int64)),
            torch.from_numpy(w), (n_dst_p, layout.n_src_padded)) \
            .coalesce().to_sparse_csr().to(dev)
    k2_out = spmm_weighted_cuda(k2_csr, k2_csr.w, x32)
    lib_out = torch.sparse.mm(lib, x32)
    torch.cuda.synchronize()
    for name, other in (('K2', k2_out), ('torch.sparse.mm', lib_out)):
        err = float((other - full_out).abs().max())
        log(f'L1 full f32 vs {name} on the same edges: max_abs_err {err:.3e}')
        check(torch.allclose(other, full_out, atol=TOL, rtol=TOL),
              f'L1 full disagrees with {name} ({err:.3e})')

    t_full = time_ms({'plain': lambda: kernel_lab.spmm_lab_plain(
                          layout, x32, 'full'),
                      'kernel': lambda: l1(layout, x32, 'full'),
                      'library': lambda: torch.sparse.mm(lib, x32),
                      'k2': lambda: spmm_weighted_cuda(k2_csr, k2_csr.w,
                                                       x32)},
                     ['plain', 'kernel', 'library', 'k2', 'k2', 'library',
                      'kernel', 'plain'],
                     strict=('kernel', 'k2'))
    bound, by, nbytes = kernel_lab.spmm_lab_bound(layout, x32, 'full')
    # the same bound over the real edges alone: what the padding slots cost
    edge_bound, _ = timing.bound_ms(
        nbytes - 8 * (layout.n_slots - kernel_lab.E),
        2 * kernel_lab.E * kernel_lab.D)
    ms_by_mode = {xd: {m: r['ms'] for m, r in entry[xd].items()}
                  for xd in dtypes}
    bound_by_mode = {xd: {m: r['bound_ms'] for m, r in entry[xd].items()}
                     for xd in dtypes}
    log(f'timing L1 full x=f32 (845,824 slots, out ({n_dst_p}, '
        f'{kernel_lab.D})): kernel {t_full["kernel"]:.4f} ms, plain '
        f'{t_full["plain"]:.4f} ms, torch.sparse.mm {t_full["library"]:.4f}'
        f' ms, K2 on the CSR {t_full["k2"]:.4f} ms, bound {bound:.4f} ms '
        f'({by}, {nbytes / 1e6:.1f} MB; {bound / t_full["kernel"]:.3f} of '
        f'it; over the {kernel_lab.E} real edges alone {edge_bound:.4f} '
        f'ms); entry point ms by mode {json.dumps(ms_by_mode)}')
    res = {'L1': {
        'launches': launches['spmm_lab'], 'max_abs_err': l1_err,
        'ms': t_full['kernel'], 'plain_ms': t_full['plain'],
        'bound_ms': bound, 'bound_by': by, 'library_ms': t_full['library'],
        'ms_by_mode': ms_by_mode, 'bound_ms_by_mode': bound_by_mode,
        'bound_ms_real_edges': edge_bound, 'k2_csr_ms': t_full['k2'],
        'share_of_bound': bound / t_full['kernel']}}

    # L2 and L3: bitwise against index_select, then timed in turns with it
    # and with the other gather kernel on the same ids and table
    ids_all, rng = gather_lab.lab_ids()
    for row, name, mode, kernel, other, width in (
            ('L2', 'gather_rows', 'onehot', l2, l3, gather_lab.D),
            ('L3', 'gather_rows_bulk', 'dma', l3, l2, gather_lab.DMA_D)):
        ids = torch.from_numpy(gather_lab.mode_ids(ids_all, mode)).to(dev)
        x = gather_lab.lab_x(rng, width).to(dev)
        got, got_other = kernel(x, ids), other(x, ids)
        want_out = gather_lab.gather_rows_plain(x, ids)
        torch.cuda.synchronize()
        err = float((got - want_out).abs().max())
        check(torch.equal(got, want_out) and torch.equal(got_other, want_out),
              f'{row} ({mode}) differs from index_select ({err:.3e})')
        tm = time_ms({'plain': lambda: gather_lab.gather_rows_plain(x, ids),
                      'kernel': lambda: kernel(x, ids),
                      'other': lambda: other(x, ids)},
                     ['plain', 'kernel', 'other', 'other', 'kernel',
                      'plain'], strict=('kernel', 'other'))
        bound, by, nbytes = gather_lab.gather_bound(x, ids)
        n = ids.numel()
        log(f'timing {row} ({mode}, {n} rows of {width}): kernel '
            f'{tm["kernel"]:.4f} ms ({n / tm["kernel"] / 1e3:.1f}k rows/ms),'
            f' the other gather kernel {tm["other"]:.4f} ms, index_select '
            f'{tm["plain"]:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f}'
            f' MB); entry point {entry["gather"][mode]["ms"]:.4f} ms')
        res[row] = {'launches': launches[name], 'max_abs_err': err,
                    'ms': tm['kernel'], 'plain_ms': tm['plain'],
                    'bound_ms': bound, 'bound_by': by,
                    'library_ms': tm['plain'], 'rows': n,
                    'ms_entry_point': entry['gather'][mode]['ms'],
                    'other_gather_kernel_ms': tm['other']}
    log('clocks after timing (sm, max sm, power, temperature): '
        + nvidia_smi('clocks.sm,clocks.max.sm,power.draw,temperature.gpu'))
    return res


def lab_small_layouts(dev) -> dict:
    """``{(group, d, dtype name): (layout, x)}`` on ``dev``: 2,800 edges
    (300 repeated pairs) from 1,300 sources to 2,100 destinations with
    none into destination block 2 (rows 1,024-1,535), tiled at group 1, 3
    and 8, with x of N(0, 1) rows at d = 64 and 128, f32 and bf16."""
    from textgcn_tpu_torch.tools.lab_layout import tile_layout
    rng = np.random.RandomState(3)
    n_src, n_dst, e = 1_300, 2_100, 2_500
    src = rng.randint(0, n_src, e)
    dst = rng.randint(0, n_dst - 512, e)
    dst[dst >= 1024] += 512
    src = np.concatenate([src, src[:300]])
    dst = np.concatenate([dst, dst[:300]])
    w = rng.rand(len(src)).astype(np.float32)
    out = {}
    for group in (1, 3, 8):
        lay = tile_layout(src, dst, w, n_src, n_dst, group=group).to(dev)
        for d in (64, 128):
            x = torch.from_numpy(rng.randn(lay.n_src_padded, d)
                                 .astype(np.float32)).to(dev)
            out[group, d, 'f32'] = (lay, x)
            out[group, d, 'bf16'] = (lay, x.to(torch.bfloat16))
    return out


def cli_run(data_dir: str, argv: list[str], platform: str, entry=None):
    """``cli.main(argv)`` from inside ``data_dir``'s parent, as a user runs
    it; returns the trainer and the run directory.  With ``entry``,
    another entry point that takes the CLI's flags (its result alone)."""
    from textgcn_tpu_torch import cli
    old_cwd, old_env = os.getcwd(), os.environ.get('TEXTGCN_TPU_PLATFORM')
    os.chdir(os.path.dirname(data_dir))
    os.environ['TEXTGCN_TPU_PLATFORM'] = platform
    try:
        if entry is not None:
            return entry(['--data', data_dir, *argv])
        trainer = cli.main(['--data', data_dir, *argv])
        if platform == 'cuda':
            torch.cuda.synchronize()
        return trainer, os.path.join(os.getcwd(), trainer.cfg.save_path)
    finally:
        os.chdir(old_cwd)
        if old_env is None:
            os.environ.pop('TEXTGCN_TPU_PLATFORM', None)
        else:
            os.environ['TEXTGCN_TPU_PLATFORM'] = old_env


def serve(data_dir: str, uid: str, argv_extra: list[str], platform: str,
          model: tuple[str, ...] = ('--model', 'lgcn')):
    return cli_run(data_dir, [*model, '--no_train', '--uid', uid, '--quiet',
                              *argv_extra], platform)


def read_predictions(path: str, limit: int | None = None):
    """The rows of a ``predictions.tsv`` (the first ``limit``)."""
    with open(path, newline='') as f:
        rows = list(itertools.islice(csv.reader(f, delimiter='\t'),
                                     None if limit is None else limit + 1))
    check(rows[0] == ['user_id', 'y_pred', 'scores'],
          f'predictions.tsv header {rows[0]}')
    # scores may hold -inf (masked items), which literal_eval refuses
    return [(r[0], ast.literal_eval(r[1]),
             [float(s) for s in r[2][1:-1].split(',') if s.strip()])
            for r in rows[1:]]


def same_up_to_ties(vals_a, items_a, vals_b, items_b, tol) -> bool:
    """Equal top-k lists up to the order of tied values: the values agree
    within ``tol`` position by position, and so does each item whose
    value is finite and apart from every other value of its row."""
    va, vb = np.asarray(vals_a, np.float64), np.asarray(vals_b, np.float64)
    if va.shape != vb.shape:
        return False
    both_inf = np.isinf(va) & np.isinf(vb) & (np.sign(va) == np.sign(vb))
    with np.errstate(invalid='ignore'):
        close = np.abs(va - vb) <= tol
    if not (both_inf | close).all():
        return False
    for row in range(va.shape[0]):
        v = va[row]
        for j in range(len(v)):
            apart = np.isfinite(v[j]) and (
                np.abs(np.delete(v, j) - v[j]) > 2 * tol).all()
            if apart and items_a[row][j] != items_b[row][j]:
                return False
    return True


def small_phase(root: str) -> dict[str, int]:
    """data/dummy served on the card and on the CPU, as ``lgcn`` and as
    ``graphsage --aggr max``: same metrics and predictions.  Returns the
    kernel launches of the graphsage runs, which must be none."""
    import shutil
    dummy = os.path.join(root, 'dummy')
    shutil.copytree(os.path.join(REPO, 'data', 'dummy'), dummy)
    from textgcn_tpu_torch.data.core import load_interactions
    data = load_interactions(dummy)
    common = ['--predict', '--emb_size', '16', '--batch_size', '16', '-k',
              '3', '5']
    for model, flags, conv_keys in (
            ('lgcn', ('--model', 'lgcn'), ()),
            ('graphsage-max', ('--model', 'graphsage', '--aggr', 'max',
                               '--n_layers', '2'),
             ('w_nbr', 'w_root', 'b'))):
        ck = os.path.join(root, f'dummy_{model}.pkl')
        write_jax_checkpoint(ck, data.n_users, data.n_items, 16, seed=3,
                             model=flags[1], conv_keys=conv_keys, layers=2)
        runs = {}
        reset_counts()
        for platform in ('cuda', 'cpu'):
            trainer, run_dir = serve(dummy, f'small-{model}-{platform}',
                                     ['--load', ck, *common], platform,
                                     model=flags)
            runs[platform] = (trainer.last_metrics, read_predictions(
                os.path.join(run_dir, 'predictions.tsv')))
        launches = counts()
        (m_gpu, p_gpu), (m_cpu, p_cpu) = runs['cuda'], runs['cpu']
        for name in m_cpu:
            check(np.allclose(m_gpu[name], m_cpu[name], atol=1e-6, rtol=0),
                  f'dummy {model} {name}: card {m_gpu[name]} vs CPU '
                  f'{m_cpu[name]}')
        check([r[0] for r in p_gpu] == [r[0] for r in p_cpu],
              f'dummy {model} users')
        check(same_up_to_ties([r[2] for r in p_gpu], [r[1] for r in p_gpu],
                              [r[2] for r in p_cpu], [r[1] for r in p_cpu],
                              2e-4),
              f'dummy {model} predictions differ beyond ties')
        log(f'small: dummy {model} metrics card == CPU: {m_gpu}; '
            f'launches {launches}')
    check(not any(launches.values()),
          f'graphsage --aggr max launched kernels: {launches}')
    return launches


class PlainGraphOp:
    """A GraphOp whose two directions run ``spmm_plain``, the reference
    for the served top-k."""

    def __init__(self, op):
        self.op = op

    def weights(self, generator=None, dropout=0.0):
        return self.op.weights(generator, dropout)

    def to_user(self, item_emb, w_pair):
        from textgcn_tpu_torch.ops.spmm import spmm_plain
        return spmm_plain(self.op.l_i2u, item_emb, *w_pair)

    def to_item(self, user_emb, w_pair):
        from textgcn_tpu_torch.ops.spmm import spmm_plain
        return spmm_plain(self.op.l_u2i, user_emb, *w_pair)


def serve_phase(data_dir: str, ck: str) -> tuple[int, float]:
    """S1 through the CLI; returns K1's launches in that run and its
    seconds."""
    from textgcn_tpu_torch.ops.propagate import representation
    from textgcn_tpu_torch.ops.retrieval import mask_train_items
    from textgcn_tpu_torch.ops.spmm import spmm_dropout_cuda
    argv = ['--load', ck, '--predict', '--emb_size', str(D), '--n_layers',
            str(LAYERS), '--batch_size', str(BATCH),
            '-k', *map(str, KS)]
    reset_counts()
    split = spmm_dropout_cuda.split_launches
    t0 = time.perf_counter()
    trainer, run_dir = serve(data_dir, 'smoke', argv, 'cuda')
    seconds = time.perf_counter() - t0
    launches = spmm_dropout_cuda.launches
    check(spmm_dropout_cuda.split_launches == split,
          'K1 split a row of S1, whose rows are all short')
    check(sum(counts().values()) == launches,
          f'serving lgcn launched attention kernels: {counts()}')
    log(f'serve: cli.main took {seconds:.3f} s; K1 launches {launches}')
    data, model = trainer.data, trainer.model
    check(launches == 2 * LAYERS * 2,
          f'K1 launched {launches} times, expected {2 * LAYERS * 2} '
          '(eval + predict, 3 layers x 2 directions)')
    metrics = trainer.last_metrics
    check(metrics is not None and all(np.isfinite(v).all()
                                      for v in metrics.values()),
          f'metrics not finite: {metrics}')
    log(f'serve: metrics {json.dumps(metrics)}')
    preds = read_predictions(os.path.join(run_dir, 'predictions.tsv'))
    check(len(preds) == S1_USERS == data.n_users,
          f'{len(preds)} prediction rows for {data.n_users} users')
    check(all(len(p[1]) == max(KS) for p in preds), 'top-k width')

    # the served top-40 against a plain-SpMM propagation on the card
    item_index = {ext: i for i, ext in data.item_id_map.items()}
    users = torch.arange(N_CHECK_USERS, device=model.device)
    with torch.no_grad():
        ur, ir = representation(model.user_emb, model.item_emb,
                                PlainGraphOp(model.graph_op), LAYERS,
                                single=False)
        scores = mask_train_items(ur[users] @ ir.T,
                                  model.pos_padded[users], data.n_items)
        plain_vals, plain_idx = torch.topk(scores, max(KS), dim=1)
        served = torch.tensor(
            [[item_index[e] for e in preds[u][1]]
             for u in range(N_CHECK_USERS)], device=model.device)
        served_vals = scores.gather(1, served)
    check([p[0] for p in preds[:N_CHECK_USERS]]
          == [data.user_id_map[u] for u in range(N_CHECK_USERS)],
          'prediction rows are not in user order')
    same = same_up_to_ties(served_vals.cpu().numpy(), served.tolist(),
                           plain_vals.cpu().numpy(), plain_idx.tolist(), TOL)
    exact = float((served == plain_idx).float().mean())
    log(f'serve: top-{max(KS)} of {N_CHECK_USERS} users vs plain '
        f'propagation: same up to ties={same}, identical positions '
        f'{exact:.4f}')
    check(same, 'served top-k differs from the plain propagation')
    serve_breakdown(trainer)
    return launches, seconds


def serve_breakdown(trainer):
    """Where the serving time goes, piece by piece, after the counted run:
    host clock around work that ends in ``torch.cuda.synchronize()``."""
    from textgcn_tpu_torch.ops.metrics import calculate_metrics
    model, data = trainer.model, trainer.data

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    users = torch.as_tensor(data.test_users.astype(np.int64),
                            device=model.device)
    with torch.no_grad():
        reprs, t_prop = timed(model.representation)

        def topk():
            return torch.cat([
                model.topk_for_users(reprs, users[s:s + BATCH], max(KS))[1]
                for s in range(0, len(users), BATCH)]).cpu().numpy()

        preds, t_topk = timed(topk)
    _, t_metrics = timed(lambda: calculate_metrics(preds, data.true_test, KS))
    _, t_eval = timed(trainer.evaluate)
    _, t_predict = timed(lambda: trainer.predict(range(data.n_users),
                                                 save=True))
    log(f'serve breakdown (ms): propagation {t_prop:.3f}, score+top-k of '
        f'{len(users)} test users {t_topk:.3f}, metrics {t_metrics:.3f}, '
        f'evaluate {t_eval:.3f}, predict+write of {data.n_users} users '
        f'{t_predict:.3f}')


OUTPUTS = {'gat_fwd': ('num', 'den', 'm'), 'gat_bwd': ('dh', 'ds', 'dd'),
           'gatv2_fwd': ('num', 'den', 'm'),
           'gatv2_bwd': ('dhs', 'dhd', 'da')}
# per kernel: (floats read and written, operations per kept edge) of one
# launch over ``rows`` x ``cols`` (see attention_bound_ms)
ATTENTION_WORK = {
    'gat_fwd': lambda rows, cols, d: (cols * d + cols + rows * d + 3 * rows,
                                      2 * d),
    'gat_bwd': lambda rows, cols, d: (2 * rows * d + 2 * rows + cols * d
                                      + 4 * cols, 4 * d),
    'gatv2_fwd': lambda rows, cols, d: (cols * d + 2 * rows * d + d
                                        + 2 * rows, 6 * d),
    'gatv2_bwd': lambda rows, cols, d: (2 * rows * d + 3 * cols * d + 2 * d
                                        + 2 * cols, 13 * d),
}


def attention_bound_ms(name: str, csr, d: int, n_kept: int):
    """Least time for one launch of an attention kernel: every input read
    once, every output written once, against the published peaks.  Over
    the forward CSR (rows = destinations j, cols = sources i):

    * K3 ``gat_fwd`` reads h (cols, d), s, d and the CSR and writes num
      (rows, d), den and m: 2d operations per kept edge;
    * K5 ``gatv2_fwd`` reads hs (cols, d), hd (rows, d), a and the CSR and
      writes num (rows, d), den and m: 6d per kept edge (u, leaky, a . lk,
      num);

    over the transpose CSR (rows = forward sources i, cols = forward
    destinations j):

    * K4 ``gat_bwd`` reads h (rows, d), s, g_num (cols, d), d, m, g_den and
      the CSR and writes dh (rows, d), ds and dd: 4d per kept edge;
    * K6 ``gatv2_bwd`` reads hs (rows, d), hd and g_num (cols, d), a, m,
      g_den and the CSR and writes dhs (rows, d), dhd (cols, d) and da:
      13d per kept edge (u, leaky, z, the dot, dhs, dhd, da).

    Each adds ~8 operations per edge for the hash, the logit and the exp.
    """
    floats, per_kept = ATTENTION_WORK[name](csr.n_dst, csr.n_src, d)
    nbytes = 4 * (csr.rowptr.numel() + csr.col.numel() + floats)
    from textgcn_tpu_torch.tools import timing
    return timing.bound_ms(nbytes, per_kept * n_kept + 8 * csr.n_edges)


def shard_bound_ms(name: str, fwd, bwd, d: int, n_kept: int,
                   owned: int) -> float:
    """``bound_ms``/``attention_bound_ms`` of one launch on a destination
    shard, counting only what the rank keeps: its ``owned`` destination
    rows (a ``rowptr`` of ``owned + 1`` entries; the destination-side
    inputs and outputs on those rows), the shard's own edges and the whole
    source-side tables.  The backward kernels walk the shard's transpose,
    whose rows are every source, so their ``rowptr`` stays whole."""
    from textgcn_tpu_torch.tools import timing
    if name == 'spmm_dropout':
        nbytes = 4 * (fwd.n_src * d + owned + 1 + fwd.col.numel()
                      + fwd.w.numel() + owned * d)
        return timing.bound_ms(nbytes, 2 * n_kept * d)[0]
    if name.endswith('_fwd'):
        csr, rowptr = fwd, owned + 1
        floats, per_kept = ATTENTION_WORK[name](owned, fwd.n_src, d)
    else:
        csr, rowptr = bwd, bwd.rowptr.numel()
        floats, per_kept = ATTENTION_WORK[name](bwd.n_dst, owned, d)
    nbytes = 4 * (rowptr + csr.col.numel() + floats)
    return timing.bound_ms(nbytes, per_kept * n_kept + 8 * csr.n_edges)[0]


def agree(got, want, tol: float, whole: bool) -> bool:
    """Within ``tol`` entry by entry (atol = rtol), or, for a ``whole``
    sum such as GATv2's ``da``, within ``tol`` times its largest entry."""
    if whole:
        return float((got - want).abs().max()) <= tol * float(
            want.abs().max())
    return torch.allclose(got, want, atol=tol, rtol=tol)


def tol_share(pairs, tol: float, whole) -> float:
    """The largest ``|got - want| / (tol + tol |want|)`` over the entries
    of the entrywise ``(got, want)`` pairs (``whole`` marks the others):
    ``agree`` holds while it is at most 1."""
    return max(float(((x - y).abs() / (tol * (1 + y.abs()))).max())
               for (x, y), w in zip(pairs, whole) if not w)


def attention_kernel_phase(data, dev, conv: str) -> dict:
    """K3 and K4 (``conv='gat'``) or K5 and K6 (``'gatv2'``) against their
    plain versions on the S1 graph, both directions, keep 1.0 and 0.6; then
    their times at keep 0.6 (training) and 1.0 (eval), the plain versions'
    at 0.6, and the bounds.

    Forward outputs agree within atol = rtol = ``TOL``; backward ones
    within ``GAT_BWD_TOL``, each entry, except GATv2's ``da``: a sum over
    every kept edge of the direction, it is held to ``GAT_BWD_TOL`` times
    its largest entry."""
    from textgcn_tpu_torch.ops import gat
    from textgcn_tpu_torch.ops.spmm import GraphOp, edge_mask
    g = data.graph
    op = GraphOp(g.edge_user, g.edge_item, np.ones(g.n_edges, np.float32),
                 data.n_users, data.n_items, dev)
    gen = torch.Generator().manual_seed(2 if conv == 'gat' else 3)
    names = (f'{conv}_fwd', f'{conv}_bwd')
    kernels = (getattr(gat, f'{conv}_fwd_cuda'),
               getattr(gat, f'{conv}_bwd_cuda'))
    plains = (getattr(gat, f'{conv}_att_plain'),
              getattr(gat, f'{conv}_bwd_plain'))
    res = {name: {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
                  'ms_keep_1': 0.0, 'max_abs_err': 0.0,
                  'max_abs_err_by_output': {}, 'by': set()}
           for name in names}

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    for direction, fwd, bwd in (('to_user', op.l_i2u, op.l_u2i),
                                ('to_item', op.l_u2i, op.l_i2u)):
        n_src, n_dst = fwd.n_src, fwd.n_dst
        if conv == 'gat':      # h, s, d
            ins = (rand(n_src, D), rand(n_src), rand(n_dst))
        else:                  # hs, hd, a
            ins = (rand(n_src, D), rand(n_dst, D), 0.5 * rand(D))
        g_num, g_den = rand(n_dst, D), rand(n_dst)
        for keep in (1.0, KEEP_DROPOUT):
            got = kernels[0](fwd, *ins, SALT, keep)
            want = plains[0](fwd, *ins, SALT, keep)
            m = got[2]   # the backward reads the forward kernel's max
            got_b = kernels[1](bwd, *ins, m, g_num, g_den, SALT, keep)
            want_b = plains[1](bwd, *ins, m, g_num, g_den, SALT, keep)
            torch.cuda.synchronize()
            for name, a, b, tol in ((names[0], got, want, TOL),
                                    (names[1], got_b, want_b, GAT_BWD_TOL)):
                errs = [float((x - y).abs().max()) for x, y in zip(a, b)]
                err = max(errs)
                r = res[name]
                r['max_abs_err'] = max(r['max_abs_err'], err)
                r['max_abs_err_by_output'] = {
                    out: max(e, r['max_abs_err_by_output'].get(out, 0.0))
                    for out, e in zip(OUTPUTS[name], errs)}
                whole = (False, False, name == 'gatv2_bwd')
                log(f'{name} {direction} keep={keep:.7g}: '
                    f'max_abs_err={err:.3e} (by output '
                    + ', '.join(f'{out} {e:.3e} of {float(y.abs().max()):.3g}'
                                for out, e, y in zip(OUTPUTS[name], errs, b))
                    + f'; {tol_share(zip(a, b), tol, whole):.3f} of the '
                    'tolerance)')
                check(all(agree(x, y, tol, w)
                          for x, y, w in zip(a, b, whole)),
                      f'{name} {direction} keep={keep} disagrees with its '
                      f'plain version (max abs err {err:.3e})')
                check(name != 'gat_fwd' or torch.equal(a[2], b[2]),
                      f'K3 {direction} keep={keep}: m is not the max of '
                      f'the kept logits bit for bit')
        n_kept = int(edge_mask(fwd, SALT, KEEP_DROPOUT)[2].sum())
        for name, csr, kernel, plain, extra in (
                (names[0], fwd, kernels[0], plains[0], ()),
                (names[1], bwd, kernels[1], plains[1], (m, g_num, g_den))):
            def kern(keep, csr=csr, kernel=kernel, extra=extra):
                return kernel(csr, *ins, *extra, SALT, keep)

            def plain_call(csr=csr, plain=plain, extra=extra):
                return plain(csr, *ins, *extra, SALT, KEEP_DROPOUT)

            t = time_ms({'kernel': lambda: kern(KEEP_DROPOUT),
                         'kernel_keep_1': lambda: kern(1.0)},
                        ['kernel', 'kernel_keep_1', 'kernel_keep_1',
                         'kernel'], strict=('kernel', 'kernel_keep_1'))
            # the plain version launches ~50 kernels a call: 5 a round
            # keep the launch queue from filling up behind the spin
            t.update(time_ms({'plain': plain_call}, ['plain', 'plain'],
                             strict=(), reps=5))
            b, by = attention_bound_ms(name, csr, D, n_kept)
            log(f'timing {name} {direction} (E={csr.n_edges}, kept '
                f'{n_kept}, {csr.n_dst}x{csr.n_src}, d={D}): kernel keep=0.6 '
                f'{t["kernel"]:.4f} ms, keep=1 {t["kernel_keep_1"]:.4f} ms, '
                f'plain keep=0.6 {t["plain"]:.4f} ms, bound {b:.4f} ms '
                f'({by})')
            r = res[name]
            r['ms'] += t['kernel']
            r['ms_keep_1'] += t['kernel_keep_1']
            r['plain_ms'] += t['plain']
            r['bound_ms'] += b
            r['by'].add(by)
    for r in res.values():
        by = r.pop('by')
        r['bound_by'] = 'bytes' if by == {'bytes'} else 'operations'
    for name, errs in attention_widths(conv, op, dev, gen).items():
        res[name]['max_abs_err_by_width'] = errs
    return res


def attention_widths(conv: str, op, dev, gen) -> dict[str, dict]:
    """The templated attention kernels of ``conv`` (K3 and K4 for 'gat', K5
    and K6 for 'gatv2') against their plain versions at ``ATT_WIDTHS``,
    to_user at keep 0.6, within phases 4 and 5's tolerances: ``{name: {d:
    max abs error by output}}``.  ``a`` and ``g_num`` are scaled by
    sqrt(D / d), so that the logits and ``g_num . h`` spread as at d = D:
    unscaled they grow with sqrt(d), and so do the sums' rounding
    errors."""
    from textgcn_tpu_torch.ops import gat
    fwd, bwd = op.l_i2u, op.l_u2i
    names = (f'{conv}_fwd', f'{conv}_bwd')
    errs = {name: {} for name in names}

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    for d in ATT_WIDTHS:
        scale = (D / d) ** 0.5
        if conv == 'gat':      # h, s, d
            ins = (rand(fwd.n_src, d), rand(fwd.n_src), rand(fwd.n_dst))
        else:                  # hs, hd, a
            ins = (rand(fwd.n_src, d), rand(fwd.n_dst, d),
                   rand(d, scale=0.5 * scale))
        g_num, g_den = rand(fwd.n_dst, d, scale=scale), rand(fwd.n_dst)
        fwd_plain = getattr(gat, f'{conv}_att_plain')
        m = fwd_plain(fwd, *ins, SALT, KEEP_DROPOUT)[2]
        for name in names:
            if name.endswith('_fwd'):
                args, tol = (fwd, *ins, SALT, KEEP_DROPOUT), TOL
            else:
                args = (bwd, *ins, m, g_num, g_den, SALT, KEEP_DROPOUT)
                tol = GAT_BWD_TOL
            got = getattr(gat, f'{name}_cuda')(*args)
            want = (fwd_plain if name.endswith('_fwd') else
                    getattr(gat, f'{name}_plain'))(*args)
            torch.cuda.synchronize()
            e = errs[name][d] = [float((x - y).abs().max())
                                 for x, y in zip(got, want)]
            whole = (False, False, name == 'gatv2_bwd')
            log(f'{name} to_user d={d} keep={KEEP_DROPOUT:.7g}: max_abs_err '
                + ', '.join(f'{out} {v:.3e} of {float(y.abs().max()):.3g}'
                            for out, v, y in zip(OUTPUTS[name], e, want))
                + f'; {tol_share(zip(got, want), tol, whole):.3f} of the '
                'tolerance')
            check(all(agree(x, y, tol, w)
                      for x, y, w in zip(got, want, whole)),
                  f'{name} at d={d} disagrees with its plain version ({e})')
            check(name != 'gat_fwd' or torch.equal(got[2], want[2]),
                  f'K3 at d={d}: m is not the max of the kept logits bit '
                  'for bit')
    return errs


def _wrappers():
    """``{kernel name: (module, wrapper attribute, plain attribute)}``."""
    from textgcn_tpu_torch.ops import gat, spmm
    from textgcn_tpu_torch.tools import gather_lab, kernel_lab
    return {'spmm_dropout': (spmm, 'spmm_dropout_cuda', 'spmm_plain'),
            'spmm_weighted': (spmm, 'spmm_weighted_cuda',
                              'spmm_weighted_plain'),
            'gat_fwd': (gat, 'gat_fwd_cuda', 'gat_att_plain'),
            'gat_bwd': (gat, 'gat_bwd_cuda', 'gat_bwd_plain'),
            'gatv2_fwd': (gat, 'gatv2_fwd_cuda', 'gatv2_att_plain'),
            'gatv2_bwd': (gat, 'gatv2_bwd_cuda', 'gatv2_bwd_plain'),
            'spmm_lab': (kernel_lab, 'spmm_lab_cuda', 'spmm_lab_plain'),
            'gather_rows': (gather_lab, 'gather_rows_cuda',
                            'gather_rows_plain'),
            'gather_rows_bulk': (gather_lab, 'gather_rows_bulk_cuda',
                                 'gather_rows_plain')}


def counts() -> dict[str, int]:
    return {name: getattr(mod, attr).launches
            for name, (mod, attr, _) in _wrappers().items()}


def reset_counts():
    for mod, attr, _ in _wrappers().values():
        getattr(mod, attr).launches = 0


def best_row(recall_first_k: np.ndarray) -> int:
    """The eval whose checkpoint ``best.pkl`` holds: the last one that
    reached the running maximum of recall@smallest-k."""
    best, top = 0, -np.inf
    for i, v in enumerate(recall_first_k):
        if v >= top:
            best, top = i, v
    return best


def plain_kernels():
    """Swap every kernel wrapper for its plain version (same signature),
    for a run on the card that goes through no kernel; returns the undo."""
    wrappers = _wrappers()
    saved = {name: getattr(mod, attr)
             for name, (mod, attr, _) in wrappers.items()}
    for mod, attr, plain in wrappers.values():
        setattr(mod, attr, getattr(mod, plain))

    def undo():
        for name, (mod, attr, _) in wrappers.items():
            setattr(mod, attr, saved[name])
    return undo


def loss_and_grads(model, batch, w_pairs):
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(batch, w_pairs=w_pairs)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}


def step_vs_plain(trainer) -> float:
    """One S1 step's loss and gradients with the kernels and with the
    plain versions, from the same params, batch and salts."""
    model = trainer.model
    batch = model.sample_batches(
        torch.Generator(device=model.device).manual_seed(5), BATCH)[0]
    w_pairs = ((SALT, KEEP_DROPOUT), (SALT ^ 0x5A5A5A5A, KEEP_DROPOUT))
    k_loss, k_grads = loss_and_grads(model, batch, w_pairs)
    before = counts()
    undo = plain_kernels()
    try:
        p_loss, p_grads = loss_and_grads(model, batch, w_pairs)
    finally:
        undo()
    check(counts() == before, 'the plain step launched a kernel')
    return compare_steps(model, k_loss, k_grads, p_loss, p_grads)


def adv_draws(model, seed: int):
    """The first batch of an ``adv_sampling`` epoch, with a candidate
    mask and positive draws as a step draws them, from ``seed``."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    users = model.sample_batches(gen, BATCH)[0][0]
    b, p = users.shape[0], model.n_candidates / model.n_items
    keep = torch.rand((b, model.n_items), generator=gen,
                      device=model.device) < p
    ridx = torch.randint(0, 1 << 30, (b, model.pos_samples), generator=gen,
                         device=model.device)
    return users, keep, ridx


def adv_step_vs_plain(trainer) -> tuple[float, float]:
    """One S1 ``adv_sampling`` step with the kernels and with the plain
    versions, from the same params, users, draws and salts.  The hard
    negatives are selected once, on the kernel path, and both loss passes
    take them: the mining scores are rounded to bf16, so the ~1e-6 between
    the two propagations can move an item across the k-th place of a row.
    Returns the largest difference and the share of rows whose selection
    the plain rank pass repeats exactly."""
    model = trainer.model
    users, keep, ridx = adv_draws(model, 5)
    b = users.shape[0]
    pos = model.positives(users, ridx)
    w_rank = ((SALT, KEEP_DROPOUT), (SALT ^ 0x5A5A5A5A, KEEP_DROPOUT))
    w_loss = ((SALT ^ 0x1234567, KEEP_DROPOUT),
              (SALT ^ 0x7654321, KEEP_DROPOUT))

    def select():
        with torch.no_grad():
            ur, ir = model.representation(training=True, w_pairs=w_rank)
            return model.hard_negatives(ur, ir, users, keep)

    def step(negs, valid):
        model.zero_grad(set_to_none=True)
        ur, ir = model.representation(training=True, w_pairs=w_loss)
        loss = sum(model.expanded_loss(ur, ir, users, pos, negs, valid))
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), {n: p.grad.detach().clone()
                               for n, p in model.named_parameters()}

    negs, valid = select()
    k_loss, k_grads = step(negs, valid)
    before = counts()
    undo = plain_kernels()
    try:
        p_negs, p_valid = select()
        p_loss, p_grads = step(negs, valid)
    finally:
        undo()
    check(counts() == before, 'the plain step launched a kernel')
    agree = float(((p_negs == negs) & (p_valid == valid)).all(dim=1)
                  .float().mean())
    log(f'adv selection: the plain rank pass repeats the kernel path\'s '
        f'hard negatives in {agree:.4f} of {b} rows; valid negatives a row '
        f'{float(valid.float().sum(1).mean()):.2f} of {model.n_hard_negs}')
    return compare_steps(model, k_loss, k_grads, p_loss, p_grads), agree


def compare_steps(model, k_loss, k_grads, p_loss, p_grads,
                  names=('kernels', 'plain'), tol: float = STEP_TOL) -> float:
    """Check a step's loss and gradients with the kernels against the
    plain versions' (or ``names``' two paths; within ``tol``); the largest
    difference."""
    model.zero_grad(set_to_none=True)
    err = float((k_loss - p_loss).abs())
    a, b = names
    check(torch.allclose(k_loss, p_loss, atol=tol, rtol=tol),
          f'loss with {a} {float(k_loss)} vs {b} {float(p_loss)}')
    for name, g in k_grads.items():
        e = float((g - p_grads[name]).abs().max())
        err = max(err, e)
        check(torch.allclose(g, p_grads[name], atol=tol, rtol=tol),
              f'gradient of {name}: {a} vs {b} max abs err {e:.3e}')
    log(f'step {a} vs {b} ({model.cfg.model}): loss {float(k_loss):.6f} vs '
        f'{float(p_loss):.6f}, max abs err over loss and '
        f'{len(k_grads)} gradients {err:.3e}')
    return err


# the training paths: CLI flags, and the kernels that run a layer's two
# directions forward (and backward, with ``_bwd`` kernels)
MODEL_FLAGS = {
    'lgcn': ('--model', 'lgcn'),
    'gcn': ('--model', 'gcn', '--aggr', 'mean'),
    'graphsage': ('--model', 'graphsage', '--aggr', 'mean'),
    'gat': ('--model', 'gat', '--aggr', 'mean'),
    'gatv2': ('--model', 'gatv2', '--aggr', 'mean'),
}


# the paths of slices 7-9, all on K1: CLI flags and epochs (a 1-epoch run
# serves no best.pkl and runs no step against the plain versions)
SLICE_FLAGS = {
    'adv_sampling': (('--model', 'adv_sampling'), TRAIN_EPOCHS),
    'text_user': (('--model', 'text', '--pos', 'user'), TRAIN_EPOCHS),
    'ltr_reviews': (('--model', 'ltr_reviews'), TRAIN_EPOCHS),
    'kg': (('--model', 'kg'), 1),
    'reviews': (('--model', 'reviews'), 1),
    'ltr_kg': (('--model', 'ltr_kg'), 1),
}


def expected_launches(model: str, steps: int, evals: int) -> dict[str, int]:
    """Each kernel's launches in ``steps`` training steps and ``evals``
    evaluations: a layer runs both directions once forward and, in a step,
    once backward.  K1 serves as its own backward; ``adv_sampling`` runs a
    rank pass forward before each step's loss pass; the attention kernels
    have a backward kernel each; on the mesh path (``lgcn_mesh``, and a
    slice 7-9 path's name with ``_mesh``) K2 takes K1's place."""
    per_pass = 2 * LAYERS
    want = dict.fromkeys(_wrappers(), 0)
    if model.endswith('_mesh') and model != 'lgcn_mesh':
        # slices 7-9 on --mesh: K2 in K1's place
        single = expected_launches(model.removesuffix('_mesh'), steps, evals)
        want['spmm_weighted'] = single['spmm_dropout']
        return want
    if model == 'adv_sampling':
        want['spmm_dropout'] = steps * 3 * per_pass + evals * per_pass
    elif model in ('lgcn', 'gcn', 'graphsage', *SLICE_FLAGS):
        want['spmm_dropout'] = steps * 2 * per_pass + evals * per_pass
    elif model == 'lgcn_mesh':
        want['spmm_weighted'] = steps * 2 * per_pass + evals * per_pass
    else:
        want[f'{model}_fwd'] = steps * per_pass + evals * per_pass
        want[f'{model}_bwd'] = steps * per_pass
    return want


def train_phase(data_dir: str, model: str) -> dict:
    """S1 trained through the CLI for ``TRAIN_EPOCHS`` epochs (a slice
    7-9 path: its own count), eval every epoch; the kernel launches of
    that run, read just after it; with two epochs or more, falling loss
    sums, ``best.pkl`` re-served and one step against the plain
    versions."""
    flags, epochs = SLICE_FLAGS.get(model, (MODEL_FLAGS.get(model),
                                            TRAIN_EPOCHS))
    argv = [*flags, '--epochs', str(epochs), '--evaluate_every', '1',
            '--emb_size', str(D), '--n_layers', str(LAYERS), '--batch_size',
            str(BATCH), '--dropout', '0.4', '-k', *map(str, KS), '--uid',
            f'train-{model}', '--quiet']
    reset_counts()
    t0 = time.perf_counter()
    trainer, run_dir = cli_run(data_dir, argv, 'cuda')
    seconds = time.perf_counter() - t0
    launches = counts()
    steps = trainer.model.num_batches(BATCH)
    m = trainer.model
    log(f'train {model}: cli.main took {seconds:.3f} s; {steps} steps an '
        f'epoch (bucket_len {m.bucket_len} x {m.n_users} users / {BATCH}); '
        f'launches {launches}')
    check(steps == -(-m.bucket_len * m.n_users // BATCH) == 264,
          f'{steps} steps an epoch, expected ceil(9 * 60000 / 2048) = 264')
    want = expected_launches(model, steps * epochs, epochs)
    check(launches == want, f'train {model}: launches {launches}, expected '
          f'{want}')
    hist = trainer.loss_history
    log(f'train {model}: loss sums by epoch '
        + json.dumps([{c: round(v, 4) for c, v in h.items()}
                      for h in hist]))
    check(len(hist) == epochs
          and all(np.isfinite(v) for h in hist for v in h.values()),
          f'train {model}: loss sums {hist}')
    out = {'trainer': trainer, 'launches': launches, 'seconds': seconds,
           'run_dir': run_dir}
    if epochs == 1:
        return out
    check(hist[1]['loss'] < hist[0]['loss'],
          f'train {model}: epoch 2 loss sum {hist[1]["loss"]} is not below '
          f'epoch 1 {hist[0]["loss"]}')
    rows = trainer.metrics_logger
    best = best_row(rows['recall'][:, 0])
    served, _ = serve(data_dir, f'best-{model}',
                      ['--load', run_dir, '--emb_size', str(D), '--n_layers',
                       str(LAYERS), '--batch_size', str(BATCH), '-k',
                       *map(str, KS)], 'cuda', model=flags)
    for name, got in served.last_metrics.items():
        check(np.allclose(got, rows[name][best], atol=1e-6, rtol=0),
              f'train {model}: best.pkl serves {name} {got}, its epoch '
              f'{best + 1} measured {rows[name][best]}')
    log(f'train {model}: best.pkl (epoch {best + 1}) serves the same '
        f'metrics: {json.dumps(served.last_metrics)}')
    if model == 'adv_sampling':
        out['step_err'], out['selection_agreement'] = \
            adv_step_vs_plain(trainer)
    else:
        out['step_err'] = step_vs_plain(trainer)
    return out


def probe_phase(data_dir: str, base_dir: str) -> dict:
    """The two probes through the CLI: ``text_probe`` (the four text
    combinations as the scoring representation: no propagation, no
    launch) and ``ltr_simple --load_base <phase 8's lgcn run>`` (the
    base's evaluation and the two concat probes: 18 K1 launches); each
    probe's metrics are finite."""
    common = ['--emb_size', str(D), '--n_layers', str(LAYERS),
              '--batch_size', str(BATCH), '-k', *map(str, KS), '--quiet']
    out = {}
    for name, argv, n_sets, n_evals in (
            ('text_probe', ['--model', 'text_probe'], 4, 0),
            ('ltr_simple', ['--model', 'ltr_simple', '--load_base',
                            base_dir], 2, 3)):
        reset_counts()
        t0 = time.perf_counter()
        trainer, _ = cli_run(data_dir, [*argv, '--uid', f'probe-{name}',
                                        *common], 'cuda')
        seconds = time.perf_counter() - t0
        launches = counts()
        want = expected_launches('lgcn', 0, n_evals)
        rows = trainer.metrics_logger
        log(f'probe {name}: cli.main took {seconds:.3f} s; launches '
            f'{launches}; metrics by probe '
            + json.dumps({m: v.tolist() for m, v in rows.items()}))
        check(launches == want, f'probe {name}: launches {launches}, '
              f'expected {want}')
        check(all(v.shape[0] == n_sets and np.isfinite(v).all()
                  for v in rows.values()),
              f'probe {name}: {n_sets} finite metric sets expected')
        out[name] = {'launches': launches, 'seconds': seconds,
                     'metrics': rows}
    return out


def mining_phase(trainer, card: str) -> dict:
    """The mining layer of an ``adv_sampling`` step at S1, timed as
    single launches: the (2048, 25,000) float32 score product, the bf16
    rounding with the train and candidate masks, ``mining_top_k`` on the
    masked scores and the whole ``hard_negatives``; and ``torch.topk`` on
    the same scores, a yardstick the port never calls (it orders ties
    arbitrarily)."""
    from textgcn_tpu_torch.ops.retrieval import (catalog_scores,
                                                 mask_train_items,
                                                 mining_top_k)
    model = trainer.model
    users, keep, _ = adv_draws(model, 9)
    k = model.n_hard_negs

    def masked(scores):
        return mask_train_items(scores.to(torch.bfloat16),
                                model.pos_padded[users], model.n_items
                                ).masked_fill(~keep, -torch.inf)

    with torch.no_grad():
        ur, ir = model.representation()
        u = ur[users]
        scores = masked(catalog_scores(u, ir))
        fns = {'score': lambda: catalog_scores(u, ir),
               'mask': lambda: masked(catalog_scores(u, ir)),
               'top_k': lambda: mining_top_k(scores, k),
               'library_top_k': lambda: torch.topk(scores, k),
               'hard_negatives': lambda: model.hard_negatives(ur, ir, users,
                                                              keep)}
        ms = time_ms(fns, ['score', 'mask', 'top_k', 'library_top_k',
                           'hard_negatives', 'hard_negatives', 'top_k'],
                     strict=())
    ms['mask'] -= ms['score']
    log(f'mining at S1 ({card}): a step\'s (2048, {model.n_items}) score '
        f'{ms["score"]:.4f} ms, bf16 + masks {ms["mask"]:.4f}, mining_top_k '
        f'(k = {k}) {ms["top_k"]:.4f} (torch.topk {ms["library_top_k"]:.4f}),'
        f' hard_negatives {ms["hard_negatives"]:.4f} ms')
    return ms


def write_ltr_text(data_dir: str, data, dev, seed: int = 0) -> dict:
    """The LTR text of S1 beside its TSVs: ``meta_synced.tsv`` (a title
    and a description per item), ``reviews_text.tsv`` (one review per
    train and test edge, times from ``seed``, in the loader's (asin,
    user_id) order) and the two embedding caches the loader reads instead
    of running an encoder: random unit vectors from ``seed`` at the
    encoder's width (``STUB_DIM``, all-MiniLM-L6-v2's 384), each with the
    ``.meta`` fingerprint of its text rows.  Returns sizes and times."""
    from textgcn_tpu_torch.data.text import STUB_DIM, _texts_fingerprint
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    items = [data.item_id_map[i] for i in range(data.n_items)]
    with open(os.path.join(data_dir, 'meta_synced.tsv'), 'w') as f:
        f.write('asin\ttitle\tdescription\n')
        f.writelines(f'{a}\ttitle of {a}\ta longer description of {a}, '
                     f'its detail {i % 97}\n' for i, a in enumerate(items))
    item_texts = [f'title of {a} [SEP] a longer description of {a}, its '
                  f'detail {i % 97}' for i, a in enumerate(items)]
    g = data.graph
    edges = [(data.item_id_map[i], data.user_id_map[u])
             for u, i in zip(g.edge_user.tolist(), g.edge_item.tolist())]
    edges += [(data.item_id_map[i], data.user_id_map[u])
              for u, row in zip(data.test_users.tolist(), data.true_test)
              for i in row]
    edges.sort()
    times = rng.randint(1_500_000_000, 1_600_000_000, len(edges))
    texts = [f'review of {a} by {u}: opinion {n % 13}'
             for n, (a, u) in enumerate(edges)]
    with open(os.path.join(data_dir, 'reviews_text.tsv'), 'w') as f:
        f.write('user_id\tasin\treview\ttime\trating\n')
        f.writelines(f'{u}\t{a}\t{t}\t{tm}\t{n % 5 + 1}\n'
                     for n, ((a, u), t, tm)
                     in enumerate(zip(edges, texts, times.tolist())))
    gen = torch.Generator(device=dev).manual_seed(seed)
    emb = os.path.join(data_dir, 'embeddings')
    os.makedirs(emb, exist_ok=True)
    sizes = {}
    for stem, rows in (('item_kg_repr', item_texts),
                       ('item_full_reviews_loss_repr', texts)):
        v = torch.randn(len(rows), STUB_DIM, generator=gen, device=dev)
        v = (v / v.norm(dim=1, keepdim=True)).cpu().numpy()
        path = os.path.join(emb, f'{stem}_all-MiniLM-L6-v2_{seed}-seed.npy')
        np.save(path, v)
        with open(path + '.meta', 'w') as f:
            f.write(_texts_fingerprint(rows))
        sizes[stem] = v.nbytes
    out = {'reviews': len(edges), 'seconds': time.perf_counter() - t0,
           'cache_bytes': sizes}
    path = os.path.join(emb, 'item_full_reviews_loss_repr_all-MiniLM-L6-v2_'
                        f'{seed}-seed.npy')
    t = time.perf_counter()
    np.load(path)
    out['review_cache_load_s'] = time.perf_counter() - t
    log(f'ltr text: {len(items)} items, {len(edges)} reviews written in '
        f'{out["seconds"]:.3f} s; caches {sizes} bytes; np.load of the '
        f'review cache {out["review_cache_load_s"]:.3f} s')
    return out


def memoize_ltr_loader() -> dict[str, int]:
    """Make ``data.text.load_ltr_data`` load each configuration once.  The
    text phases run ``cli.main`` on one set with the same text flags some
    twenty times, and a real load of S1's text takes ~10 s; every
    configuration is still loaded for real once (the ltr text and boosted
    phases time that load).  The key is every ``Config`` field the loader
    reads.  Returns the counts of real loads and of memo hits."""
    from textgcn_tpu_torch.data import text
    real, cache = text.load_ltr_data, {}
    stats = {'loads': 0, 'hits': 0}

    def load(cfg, popularity_mode=None):
        key = (os.path.abspath(cfg.data), cfg.reshuffle, cfg.seed,
               cfg.bert_model, cfg.sep, cfg.emb_batch_size,
               popularity_mode or cfg.popularity_mode)
        if key in cache:
            stats['hits'] += 1
        else:
            stats['loads'] += 1
            cache[key] = real(cfg, popularity_mode)
        return cache[key]

    load.real = real
    text.load_ltr_data = load
    return stats


def reference_topk(model, users: torch.Tensor, k: int, chunk: int = 16):
    """The reference's way of scoring the catalogue with an LTR head: the
    ``(B, n_items, F)`` pairwise feature tensor through the uncollapsed
    tower, train-masked, top-k; ``chunk`` users at a time."""
    from textgcn_tpu_torch.ops.retrieval import mask_train_items
    items = torch.arange(model.n_items, device=model.device)
    vals, idx = [], []
    with torch.no_grad():
        ur, ir = model.representation()
        for s in range(0, len(users), chunk):
            u = users[s:s + chunk]
            b = len(u)
            feats = model.features_pairwise(
                ur[u][:, None, :].expand(-1, model.n_items, -1),
                ir[None].expand(b, -1, -1),
                u[:, None].expand(-1, model.n_items),
                items[None].expand(b, -1))
            scores = mask_train_items(model.apply_tower(feats),
                                      model.pos_padded[u], model.n_items)
            v, i = torch.topk(scores, k, dim=1)
            vals.append(v)
            idx.append(i)
    return torch.cat(vals), torch.cat(idx)


def ltr_phase(data_dir: str, ck: str, model: str) -> dict:
    """``model --load_base ck --freeze`` on S1 through the CLI for
    ``TRAIN_EPOCHS`` epochs, eval every epoch, then ``--predict``: K1
    launches only forward (base eval, each step, each eval, predict), the
    tables stay the checkpoint's bit for bit, the loss sums are finite
    and fall, ``best.pkl`` serves its epoch's metrics, and the fused
    top-40 of 256 users equals the reference's feature-tensor scoring up
    to ties (``LTR_TOL``)."""
    common = ['--emb_size', str(D), '--n_layers', str(LAYERS),
              '--batch_size', str(BATCH), '-k', *map(str, KS)]
    argv = ['--model', model, '--load_base', ck, '--freeze', '--epochs',
            str(TRAIN_EPOCHS), '--evaluate_every', '1', '--dropout', '0.4',
            '--predict', '--uid', f'train-{model}', '--quiet', *common]
    reset_counts()
    t0 = time.perf_counter()
    trainer, run_dir = cli_run(data_dir, argv, 'cuda')
    seconds = time.perf_counter() - t0
    launches = counts()
    m = trainer.model
    steps = m.num_batches(BATCH)
    per_pass = 2 * LAYERS
    want = dict.fromkeys(_wrappers(), 0)
    want['spmm_dropout'] = (per_pass + steps * TRAIN_EPOCHS * per_pass
                            + TRAIN_EPOCHS * per_pass + per_pass)
    log(f'ltr {model}: cli.main took {seconds:.3f} s; {steps} steps an '
        f'epoch; launches {launches}')
    check(launches == want, f'ltr {model}: launches {launches}, expected '
          f'{want} (base eval + steps + evals + predict, forward only)')
    with open(ck, 'rb') as f:
        base = pickle.load(f)['params']
    for name, n in (('user_emb', m.n_users), ('item_emb', m.n_items)):
        check(np.array_equal(getattr(m, name).detach().cpu().numpy(),
                             base[name][:n]),
              f'ltr {model}: the frozen {name} changed in training')
    hist = trainer.loss_history
    log(f'ltr {model}: loss sums by epoch '
        f'{[round(h["loss"], 4) for h in hist]}')
    check(len(hist) == TRAIN_EPOCHS
          and all(np.isfinite(h['loss']) for h in hist)
          and hist[1]['loss'] < hist[0]['loss'],
          f'ltr {model}: loss sums {hist}')
    rows = trainer.metrics_logger
    best = best_row(rows['recall'][:, 0])
    served, _ = serve(data_dir, f'best-{model}', ['--load', run_dir,
                                                  *common], 'cuda',
                      model=('--model', model))
    for name, got in served.last_metrics.items():
        check(np.allclose(got, rows[name][best], atol=1e-6, rtol=0),
              f'ltr {model}: best.pkl serves {name} {got}, its epoch '
              f'{best + 1} measured {rows[name][best]}')
    preds = read_predictions(os.path.join(run_dir, 'predictions.tsv'))
    check(len(preds) == m.n_users and all(len(p[1]) == max(KS)
                                          for p in preds),
          f'ltr {model}: predictions.tsv')
    users = torch.arange(N_CHECK_USERS, device=m.device)
    with torch.no_grad():
        fused_v, fused_i = m.topk_for_users(m.scoring_reprs(), users,
                                            max(KS))
    ref_v, ref_i = reference_topk(m, users, max(KS))
    err = float((fused_v - ref_v).abs().max())
    same = same_up_to_ties(fused_v.cpu().numpy(), fused_i.tolist(),
                           ref_v.cpu().numpy(), ref_i.tolist(), LTR_TOL)
    log(f'ltr {model}: best.pkl (epoch {best + 1}) serves the same metrics '
        f'{json.dumps(served.last_metrics)}; fused top-{max(KS)} of '
        f'{N_CHECK_USERS} users vs the (B, n_items, F) reference: max abs '
        f'err {err:.3e}, same up to ties={same}')
    check(same, f'ltr {model}: fused top-k differs from the reference')
    out = {'trainer': trainer, 'launches': launches, 'seconds': seconds,
           'topk_err': err}
    if model == 'ltr_linear':
        # one unfrozen step: the kernels' forward and backward against the
        # plain versions, the tower's gradients with them
        m.user_emb.requires_grad_(True)
        m.item_emb.requires_grad_(True)
        try:
            out['step_err'] = step_vs_plain(trainer)
        finally:
            m.user_emb.requires_grad_(False)
            m.item_emb.requires_grad_(False)
    return out


def resume_phase(data_dir: str, single) -> dict:
    """``lgcn`` on S1 for 1 epoch, then ``--resume`` for the second,
    against phase 8's uninterrupted run ``single``: loss sums within
    ``RESUME_TOL`` relative, metrics within ``RESUME_METRIC_TOL``, tables
    within ``RESUME_TABLE_TOL`` (nothing promises the card's library
    kernels the same order of sums in two processes).  Returns the
    launches and the largest differences."""
    common = [*MODEL_FLAGS['lgcn'], '--evaluate_every', '1', '--emb_size',
              str(D), '--n_layers', str(LAYERS), '--batch_size', str(BATCH),
              '--dropout', '0.4', '-k', *map(str, KS), '--quiet']
    reset_counts()
    first, first_dir = cli_run(data_dir, [*common, '--epochs', '1', '--uid',
                                          'resume-first'], 'cuda')
    c1 = counts()
    second, _ = cli_run(data_dir, [*common, '--epochs', str(TRAIN_EPOCHS),
                                   '--uid', 'resume-second', '--resume',
                                   first_dir], 'cuda')
    launches = counts()
    steps = first.model.num_batches(BATCH)
    per_run = expected_launches('lgcn', steps, 1)
    check(c1 == per_run and launches == {k: 2 * v for k, v in
                                         per_run.items()},
          f'resume: launches {c1} then {launches}, expected {per_run} each')
    got = [h['loss'] for h in first.loss_history + second.loss_history]
    ref = [h['loss'] for h in single.loss_history]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    metric_err = max(float(np.abs(second.metrics_logger[k] - v).max())
                     for k, v in single.metrics_logger.items())
    table_err = max(float((getattr(second.model, n).detach()
                           - getattr(single.model, n).detach()).abs().max())
                    for n in ('user_emb', 'item_emb'))
    log(f'resume lgcn: loss sums {got} vs uninterrupted {ref} (largest '
        f'relative difference {loss_rel:.3e}), largest metric difference '
        f'{metric_err:.3e}, largest table difference {table_err:.3e}; '
        f'launches {launches}')
    check(len(got) == len(ref) == TRAIN_EPOCHS and loss_rel <= RESUME_TOL,
          f'resume: loss sums {got} vs {ref}')
    check(second.metrics_logger['recall'].shape[0] == TRAIN_EPOCHS
          and metric_err <= RESUME_METRIC_TOL,
          f'resume: metrics differ by {metric_err}')
    check(table_err <= RESUME_TABLE_TOL,
          f'resume: tables differ by {table_err}')
    return {'launches': launches, 'loss_rel_err': loss_rel,
            'metric_err': metric_err, 'table_err': table_err}


def refresh_phase(data_dir: str) -> dict:
    """``lgcn --refresh_every REFRESH`` on S1 for ``TRAIN_EPOCHS`` epochs:
    K1 runs forward only, ``REFRESH`` steps apart (``ceil(steps /
    REFRESH)`` refreshes of 6 launches an epoch) and 6 an eval; the loss
    sums are finite."""
    argv = [*MODEL_FLAGS['lgcn'], '--refresh_every', str(REFRESH),
            '--epochs', str(TRAIN_EPOCHS), '--evaluate_every', '1',
            '--emb_size', str(D), '--n_layers', str(LAYERS), '--batch_size',
            str(BATCH), '--dropout', '0.4', '-k', *map(str, KS), '--uid',
            'train-lgcn-refresh', '--quiet']
    reset_counts()
    t0 = time.perf_counter()
    trainer, _ = cli_run(data_dir, argv, 'cuda')
    seconds = time.perf_counter() - t0
    launches = counts()
    steps = trainer.model.num_batches(BATCH)
    want = dict.fromkeys(_wrappers(), 0)
    want['spmm_dropout'] = (-(-steps // REFRESH) * TRAIN_EPOCHS
                            + TRAIN_EPOCHS) * 2 * LAYERS
    hist = [h['loss'] for h in trainer.loss_history]
    log(f'refresh lgcn every {REFRESH}: cli.main took {seconds:.3f} s; '
        f'launches {launches}; loss sums by epoch {hist}')
    check(launches == want, f'refresh: launches {launches}, expected '
          f'{want} (forward only, at the refresh steps and the evals)')
    check(len(hist) == TRAIN_EPOCHS and all(np.isfinite(hist)),
          f'refresh: loss sums {hist}')
    return {'trainer': trainer, 'launches': launches, 'seconds': seconds}


# the boosted heads: 4,096 users of S1's generator (every item kept), the
# fit's batch at S1's size (256 users x 25,000 items), 16 batches of it
BOOST_USERS = 4096
# the fit on the card against the same code on the CPU: leaf values
# (float64 means in another order of sums) and the forests' scores
FIT_VALUE_TOL, FIT_SCORE_TOL = 1e-9, 1e-5
# the users of the first fit batch whose rows the CPU fits for that
# comparison (1.6M rows; the whole batch's 6.4M took the CPU 50-74 s)
CPU_FIT_USERS = 64


def boosted_run(data_dir: str, base: str, model: str,
                extra: tuple[str, ...] = ()) -> dict:
    """``model --load_base base --predict`` through the CLI: K1 launches
    exactly 6 for each of the base's evaluation, the fit's propagation,
    the evaluation and the prediction (forward only); the loaded tables
    stay the base's bit for bit; finite metrics; ``predictions.tsv`` a
    row of ``max(KS)`` items per user; then ``--load RUN --no_train``
    restores ``forest.npz`` and re-serves the metrics (1e-6) with 6
    launches."""
    common = ['--emb_size', str(D), '--n_layers', str(LAYERS),
              '--batch_size', str(BATCH), '-k', *map(str, KS), '--quiet']
    flags = ('--model', model)
    reset_counts()
    t0 = time.perf_counter()
    trainer, run_dir = cli_run(data_dir, [*flags, '--load_base', base,
                                          '--predict', *extra, '--uid',
                                          f'boost-{model}', *common], 'cuda')
    seconds = time.perf_counter() - t0
    launches = counts()
    per_pass = 2 * LAYERS
    want = dict.fromkeys(_wrappers(), 0)
    want['spmm_dropout'] = 4 * per_pass
    m = trainer.model
    state = m.forest_state
    log(f'boosted {model}: cli.main took {seconds:.3f} s; {m.n_users} users '
        f'x {m.n_items} items, {len(state.trees)} trees; launches '
        f'{launches}; metrics {json.dumps(trainer.last_metrics)}')
    check(launches == want, f'boosted {model}: launches {launches}, '
          f'expected {want} (base eval, fit, eval, predict: forward only)')
    path = base if base.endswith('.pkl') else os.path.join(base, 'best.pkl')
    with open(path, 'rb') as f:
        tables = pickle.load(f)['params']
    for name, n in (('user_emb', m.n_users), ('item_emb', m.n_items)):
        check(np.array_equal(getattr(m, name).detach().cpu().numpy(),
                             tables[name][:n]),
              f'boosted {model}: {name} is not the base\'s')
    check(all(np.isfinite(v).all() for v in trainer.last_metrics.values()),
          f'boosted {model}: metrics {trainer.last_metrics}')
    preds = read_predictions(os.path.join(run_dir, 'predictions.tsv'))
    check(len(preds) == m.n_users and all(len(p[1]) == max(KS)
                                          for p in preds),
          f'boosted {model}: predictions.tsv')
    reset_counts()
    served, _ = serve(data_dir, f'boost-{model}-serve',
                      ['--load', run_dir, *common], 'cuda', model=flags)
    serve_launches = counts()
    check(serve_launches == dict(want, spmm_dropout=per_pass),
          f'boosted {model}: re-serving launched {serve_launches}')
    for name, got in served.last_metrics.items():
        check(np.allclose(got, trainer.last_metrics[name], atol=1e-6,
                          rtol=0),
              f'boosted {model}: forest.npz serves {name} {got}, the fit '
              f'measured {trainer.last_metrics[name]}')
    log(f'boosted {model}: --load RUN --no_train re-serves the metrics '
        f'from forest.npz; launches {serve_launches}')
    return {'trainer': trainer, 'launches': launches,
            'serve_launches': serve_launches, 'seconds': seconds,
            'trees': len(state.trees), 'run_dir': run_dir,
            'metrics': trainer.last_metrics,
            'importances': state.feature_importances().tolist()}


def same_files(a: str, b: str) -> bool:
    with open(a, 'rb') as f, open(b, 'rb') as g:
        return f.read() == g.read()


def same_forest(a: str, b: str) -> bool:
    """Two ``forest.npz`` files hold the same arrays, bit for bit."""
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            and x[k].tobytes() == y[k].tobytes() for k in x.files)


def boosted_mesh_run(data_dir: str, base: str, model: str, single: dict,
                     extra: tuple[str, ...] = ()) -> dict:
    """``model --load_base base --predict --mesh 1x1`` through the CLI (a
    one-rank group: the tables on K2's source shard, the fit replicated,
    the tie-exact sharded top-k) against ``single``, the single-card
    ``boosted_run`` of the same flags: K2 launches exactly 6 for each of
    the base's evaluation, the fit's propagation, the evaluation and the
    prediction (forward only) and no other kernel launches; ``forest.npz``
    bit-equal, the metrics equal, ``predictions.tsv`` byte-equal; then
    ``--load RUN --no_train --mesh 1x1`` re-serves the metrics with 6 K2
    launches."""
    common = ['--emb_size', str(D), '--n_layers', str(LAYERS),
              '--batch_size', str(BATCH), '-k', *map(str, KS), '--quiet',
              '--mesh', '1x1']
    flags = ('--model', model)
    reset_counts()
    t0 = time.perf_counter()
    trainer, run_dir = cli_run(data_dir, [*flags, '--load_base', base,
                                          '--predict', *extra, '--uid',
                                          f'boost-{model}-mesh', *common],
                               'cuda')
    seconds = time.perf_counter() - t0
    launches = counts()
    per_pass = 2 * LAYERS
    want = dict.fromkeys(_wrappers(), 0)
    want['spmm_weighted'] = 4 * per_pass
    log(f'boosted {model} --mesh 1x1: cli.main took {seconds:.3f} s; '
        f'launches {launches}; metrics {json.dumps(trainer.last_metrics)}')
    check(launches == want, f'boosted {model} --mesh 1x1: launches '
          f'{launches}, expected {want} (base eval, fit, eval, predict: '
          'forward only)')
    one = single['run_dir']
    check(same_forest(os.path.join(run_dir, 'forest.npz'),
                      os.path.join(one, 'forest.npz')),
          f'boosted {model} --mesh 1x1: forest.npz differs from the single '
          'card\'s')
    single_metrics = single['metrics']
    for name, got in trainer.last_metrics.items():
        check(np.array_equal(got, single_metrics[name]),
              f'boosted {model} --mesh 1x1: {name} {got}, the single card '
              f'{single_metrics[name]}')
    check(same_files(os.path.join(run_dir, 'predictions.tsv'),
                     os.path.join(one, 'predictions.tsv')),
          f'boosted {model} --mesh 1x1: predictions.tsv differs from the '
          'single card\'s')
    reset_counts()
    served, _ = serve(data_dir, f'boost-{model}-mesh-serve',
                      ['--load', run_dir, *common], 'cuda', model=flags)
    serve_launches = counts()
    check(serve_launches == dict(want, spmm_weighted=per_pass),
          f'boosted {model} --mesh 1x1: re-serving launched '
          f'{serve_launches}')
    for name, got in served.last_metrics.items():
        check(np.array_equal(got, single_metrics[name]),
              f'boosted {model} --mesh 1x1: forest.npz serves {name} {got}, '
              f'the single card measured {single_metrics[name]}')
    log(f'boosted {model} --mesh 1x1: forest.npz bit-equal, metrics equal, '
        f'predictions.tsv byte-equal to the single card\'s; the --load '
        f're-serve launched {serve_launches}')
    return {'launches': launches, 'serve_launches': serve_launches,
            'seconds': seconds}


def first_difference(a, b) -> str | None:
    """Where two fitted trees first differ in structure, or None."""
    for name in ('children_left', 'children_right', 'feature', 'threshold'):
        x, y = getattr(a, name), getattr(b, name)
        if x.shape != y.shape:
            return f'{name}: {x.shape[0]} nodes vs {y.shape[0]}'
        bad = np.flatnonzero(x != y)
        if bad.size:
            i = int(bad[0])
            return (f'node {i} {name}: {x[i]!r} vs {y[i]!r} (n = '
                    f'{a.n_node_samples[i]}, impurity {a.impurity[i]!r})')
    return None


def boosted_fit_phase(trainer, card: str, during) -> dict:
    """The first 256-user batch of ``trainer``'s model (a fit batch at
    S1's size): ``fit_gbrt`` on the card against the same code on the
    CPU over the batch's first ``CPU_FIT_USERS`` users' rows (the same
    node structure and thresholds, leaf values within ``FIT_VALUE_TOL``
    relative, the two forests' scores within ``FIT_SCORE_TOL``); the
    card's fit of the whole batch timed for a first and a
    warm-started batch; ``forest_predict`` over the batch timed at 10
    trees and at the model's whole forest, beside the bound: the rows'
    features read once and one score written.  The CPU's fit runs in a
    thread while ``during()`` runs (its time is reported, contended)."""
    from concurrent.futures import ThreadPoolExecutor

    from textgcn_tpu_torch.ops.trees import (compile_forest, fit_gbrt,
                                             forest_predict)
    from textgcn_tpu_torch.tools import timing
    m = trainer.model
    bs = m.fit_batch_users
    with torch.no_grad():
        reprs = m.compute_reprs()
        batches = []
        for b in range(2):
            users = torch.arange(b * bs, (b + 1) * bs, device=m.device)
            x = m.batch_features(reprs, users).reshape(-1, m.n_features)
            batches.append((x, m.labels(users, m.pos_padded,
                                        m.pos_degree).reshape(-1)))
    (x, y), (x2, y2) = batches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_fit = fit_gbrt(x, y, **m.tree_params)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = fit_gbrt(x2, y2, card_fit, **m.tree_params)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rows = x.shape[0]
    bound, by = timing.bound_ms(rows * (m.n_features + 1) * 4, 0)
    f_card = compile_forest(card_fit, m.device)
    f_all = m.forest
    with torch.no_grad():
        ms = time_ms({'predict_10': lambda: forest_predict(f_card, x)},
                     ['predict_10'], strict=())
        ms.update(time_ms({f'predict_{len(m.forest_state.trees)}':
                           lambda: forest_predict(f_all, x)},
                          [f'predict_{len(m.forest_state.trees)}'],
                          strict=(), reps=3, warmup=2))

    def cpu_job(x, y):
        t0 = time.perf_counter()
        return fit_gbrt(x, y, **m.tree_params), time.perf_counter() - t0

    n_cmp = CPU_FIT_USERS * m.n_items
    xc, yc = x[:n_cmp], y[:n_cmp]
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(cpu_job, xc.cpu(), yc.cpu())
        during()
        cpu_fit, cpu_s = job.result()
    card_fit = fit_gbrt(xc, yc, **m.tree_params)
    value_err = 0.0
    for t, (a, b) in enumerate(zip(card_fit.trees, cpu_fit.trees)):
        where = first_difference(a, b)
        check(where is None, f'boosted fit: tree {t} on the card differs '
              f'from the CPU\'s at {where}')
        rel = np.abs(a.value - b.value) / max(np.abs(b.value).max(), 1e-300)
        value_err = max(value_err, float(rel.max()))
    check(value_err <= FIT_VALUE_TOL, f'boosted fit: leaf values differ by '
          f'{value_err:.3e} relative')
    with torch.no_grad():
        s_card = forest_predict(compile_forest(card_fit, m.device), xc)
        s_cpu = forest_predict(compile_forest(cpu_fit), xc.cpu())
    score_err = float((s_card.cpu() - s_cpu).abs().max())
    check(score_err <= FIT_SCORE_TOL, f'boosted fit: the forests\' scores '
          f'differ by {score_err:.3e}')
    log(f'boosted fit ({card}): {rows} rows x {m.n_features} features, '
        f'card fit of 10 trees {fit_s:.3f} s (warm-started batch '
        f'{warm_s:.3f} s); the CPU\'s fit of the first {n_cmp} of them '
        f'{cpu_s:.3f} s (beside the card\'s next run); same nodes and '
        f'thresholds, leaf values within {value_err:.3e} relative, scores '
        f'within {score_err:.3e}; forest_predict {json.dumps(ms)} ms, bound '
        f'{bound:.4f} ms ({by})')
    return {'rows': rows, 'fit_s': fit_s, 'warm_fit_s': warm_s,
            'cpu_fit_rows': n_cmp, 'cpu_fit_s': cpu_s,
            'value_rel_err': value_err,
            'score_err': score_err, 'forest_predict_ms': ms,
            'forest_predict_bound_ms': bound, 'bound_by': by}


def boosted_phase(root: str, s1_dir: str, lgcn_run: str, card: str,
                  dev) -> dict:
    """The five heads' code on the card: ``marcus --load_base <phase 8's
    lgcn run> --neg_samples 1`` on S1, then ``gbdt`` and ``gbdt_pop`` on
    ``BOOST_USERS`` users of S1's generator with the full catalogue, S1's
    text widths and a random base (``boosted_run`` each), and the fit on
    the card against the CPU's (``boosted_fit_phase``); ``marcus`` and
    ``gbdt_pop`` again with ``--mesh 1x1`` against those single-card runs
    (``boosted_mesh_run``)."""
    from textgcn_tpu_torch.config import Config
    from textgcn_tpu_torch.data.core import load_interactions
    from textgcn_tpu_torch.data.text import load_ltr_data
    out = {'marcus': boosted_run(s1_dir, lgcn_run, 'marcus',
                                 ('--neg_samples', '1'))}
    marcus = out['marcus'].pop('trainer')
    out['marcus_mesh'] = boosted_mesh_run(s1_dir, lgcn_run, 'marcus',
                                          out['marcus'],
                                          ('--neg_samples', '1'))
    n_rows = int(marcus.data.pos_degree.sum()) * 2
    check(out['marcus']['trees'] == 10, 'marcus: one fit of 10 trees')
    log(f'boosted marcus: {n_rows} fit rows (positives and one negative '
        'each)')
    out['marcus']['fit_rows'] = n_rows
    data_dir = write_dataset(root, BOOST_USERS, S1_ITEMS, S1_DEG,
                             every_item=True, name='s1_boost')
    data = load_interactions(data_dir)
    check((data.n_users, data.n_items) == (BOOST_USERS, S1_ITEMS),
          f'the boosted data loaded as {data.n_users} x {data.n_items}')
    out['text'] = write_ltr_text(data_dir, data, dev)
    t = time.perf_counter()
    load_ltr_data(Config(data=data_dir).finalize())
    out['text']['load_ltr_data_s'] = time.perf_counter() - t
    ck = os.path.join(root, 'boost_base.pkl')
    write_jax_checkpoint(ck, data.n_users, data.n_items, D, seed=5)
    def run(model):
        out[model] = boosted_run(data_dir, ck, model)
        check(out[model]['trees'] == 10 * -(-BOOST_USERS // 256),
              f'{model}: {out[model]["trees"]} trees')

    run('gbdt')
    # the CPU's fit of the comparison runs while the card runs gbdt_pop
    out['fit'] = boosted_fit_phase(out['gbdt'].pop('trainer'), card,
                                   lambda: run('gbdt_pop'))
    out['gbdt_pop'].pop('trainer')
    out['gbdt_pop_mesh'] = boosted_mesh_run(data_dir, ck, 'gbdt_pop',
                                            out['gbdt_pop'])
    for r in out.values():
        for key in ('run_dir', 'metrics'):
            r.pop(key, None)
    log(f'boosted data: {data.n_users} users x {data.n_items} items, '
        f'{data.n_train} train / {data.n_test} test edges; load_ltr_data '
        f'{out["text"]["load_ltr_data_s"]:.3f} s')
    out['data_dir'] = data_dir
    return out


def dcp_phase(data_dir: str) -> dict:
    """``lgcn --mesh 1x1`` on ``data_dir`` for 1 epoch, then ``--resume``d
    for a second, once with ``--ckpt_backend orbax``
    (``torch.distributed.checkpoint``) and once with ``pickle``: each run
    launches K2 exactly ``expected_launches('lgcn_mesh', steps, 1)``
    times; the orbax runs write ``latest_checkpoint.orbax/``,
    ``best.orbax/`` and ``resume_state.orbax/`` (DCP directories), and the
    resumed run repeats the pickle backend's bit for bit: its loss sums,
    its metrics by eval, and every array of its checkpoint and resume
    state (K2 adds in a fixed order).  Then the resumed run's
    ``latest_checkpoint.orbax`` serves on one card without a mesh (6 K1
    launches) the metrics it measured (1e-6)."""
    from textgcn_tpu_torch.train.checkpoint import make_checkpointer
    common = [*MODEL_FLAGS['lgcn'], '--evaluate_every', '1', '--emb_size',
              str(D), '--n_layers', str(LAYERS), '--batch_size', str(BATCH),
              '--dropout', '0.4', '-k', *map(str, KS), '--quiet', '--mesh',
              '1x1']
    out, runs = {'launches': {}}, {}
    t0 = time.perf_counter()
    for backend in ('orbax', 'pickle'):
        argv = [*common, '--ckpt_backend', backend]
        reset_counts()
        first, first_dir = cli_run(data_dir, [*argv, '--epochs', '1',
                                              '--uid', f'dcp-{backend}-1'],
                                   'cuda')
        c1 = counts()
        second, second_dir = cli_run(data_dir, [
            *argv, '--epochs', '2', '--uid', f'dcp-{backend}-2',
            '--resume', first_dir], 'cuda')
        launches = counts()
        per_run = expected_launches('lgcn_mesh',
                                    first.model.num_batches(BATCH), 1)
        check(c1 == per_run and launches == {k: 2 * v for k, v in
                                             per_run.items()},
              f'dcp {backend}: launches {c1} then {launches}, expected '
              f'{per_run} each')
        ck = make_checkpointer(backend)
        runs[backend] = {
            'loss': [h['loss'] for h in first.loss_history
                     + second.loss_history],
            'metrics': second.metrics_logger,
            'latest': ck.load(os.path.join(second_dir, ck.latest_name)),
            'resume': ck.load_resume(second_dir), 'dir': second_dir,
            'first_dir': first_dir}
        out['launches'][backend] = launches
    out['seconds'] = time.perf_counter() - t0
    o, p = runs['orbax'], runs['pickle']
    for d in (o['first_dir'], o['dir']):
        for name in ('latest_checkpoint.orbax', 'resume_state.orbax'):
            check(os.path.exists(os.path.join(d, name, '.metadata')),
                  f'dcp: {d} has no DCP directory {name}')
    check(os.path.exists(os.path.join(o['first_dir'], 'best.orbax',
                                      '.metadata')),
          'dcp: the first orbax run wrote no best.orbax')
    check(o['loss'] == p['loss'], f'dcp: the orbax runs\' loss sums '
          f'{o["loss"]}, the pickle runs\' {p["loss"]}')
    for name, v in p['metrics'].items():
        check(np.array_equal(o['metrics'][name], v),
              f'dcp: {name} by eval {o["metrics"][name].tolist()} vs '
              f'{v.tolist()}')

    def leaves(tree, prefix=''):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f'{prefix}/{k}')
        else:
            yield prefix, tree

    for part in ('latest', 'resume'):
        got, want = dict(leaves(o[part])), dict(leaves(p[part]))
        check(sorted(got) == sorted(want),
              f'dcp: {part} keys {sorted(got)} vs {sorted(want)}')
        for key, v in want.items():
            g = got[key]
            same = (np.asarray(g).dtype == np.asarray(v).dtype
                    and np.asarray(g).tobytes() == np.asarray(v).tobytes()
                    if isinstance(v, np.ndarray) else g == v)
            check(same, f'dcp: {part}{key} differs between the backends')
    reset_counts()
    latest = os.path.join(o['dir'], 'latest_checkpoint.orbax')
    served, _ = serve(data_dir, 'dcp-serve',
                      ['--load', latest, '--ckpt_backend', 'orbax',
                       '--emb_size', str(D), '--n_layers', str(LAYERS),
                       '--batch_size', str(BATCH), '-k', *map(str, KS)],
                      'cuda')
    serve_launches = counts()
    want = expected_launches('lgcn', 0, 1)
    check(serve_launches == want, f'dcp: the single-card serve of '
          f'{latest} launched {serve_launches}, expected {want}')
    for name, v in served.last_metrics.items():
        check(np.allclose(v, o['metrics'][name][-1], atol=1e-6, rtol=0),
              f'dcp: {latest} serves {name} {v}, the run measured '
              f'{o["metrics"][name][-1]}')
    log(f'dcp lgcn --mesh 1x1: 1 epoch and a --resume for 1 more with '
        f'--ckpt_backend orbax repeat the pickle backend bit for bit (loss '
        f'sums {o["loss"]}, metrics, {sum(1 for _ in leaves(o["latest"]))}'
        f' + {sum(1 for _ in leaves(o["resume"]))} checkpoint leaves); '
        f'launches {out["launches"]}; latest_checkpoint.orbax serves its '
        f'metrics on one card ({serve_launches["spmm_dropout"]} K1 '
        f'launches); the four runs took {out["seconds"]:.3f} s')
    out['serve_launches'] = serve_launches
    return out


# the quality run: the sweep's configuration (60 epochs, lr 0.005, an
# evaluation every 5 epochs, batch 2048, the other flags at their
# defaults) on the 50k x 20k sharp set, held to a floor on best recall@20
# (the JAX package's TPU control reached 0.8002, QUALITY_r05.jsonl)
QUALITY_USERS, QUALITY_ITEMS, QUALITY_SEED = 50_000, 20_000, 0
QUALITY_EPOCHS, QUALITY_EVAL_EVERY, QUALITY_LR = 60, 5, 0.005
QUALITY_FLOOR = 0.790
QUALITY_METRICS = tuple(f'{m}@{k}' for m in ('recall', 'precision', 'hit',
                                             'ndcg', 'f1') for k in KS)


def jax_quality_row(model: str = 'lgcn', seed: int = 0) -> dict | None:
    """The JAX package's TPU row of ``QUALITY_r05.jsonl`` for ``model``
    and ``seed``, where the checkout has the file."""
    path = os.path.join(REPO, 'QUALITY_r05.jsonl')
    if not os.path.exists(path):
        return None
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            if row['model'] == model and row['seed'] == seed:
                return row
    return None


def quality_phase(root: str, card: str) -> dict:
    """The sharp set written on the host by the port's generator, then
    ``lgcn`` trained on it through the CLI with the sweep's flags: best
    recall@20 at least ``QUALITY_FLOOR``, and K1 launched exactly 12 times
    a step and 6 an evaluation over the epochs the run took (the early
    stop may end it before ``QUALITY_EPOCHS``; ``resume_state.pkl`` says
    where)."""
    from textgcn_tpu_torch.tools import conv_quality_sweep as sweep
    from textgcn_tpu_torch.tools.make_synthetic import generate
    data_dir = os.path.join(root, 'sharp50k')
    t0 = time.perf_counter()
    rows = generate(data_dir, QUALITY_USERS, QUALITY_ITEMS,
                    seed=QUALITY_SEED, sharp=True)
    gen_s = time.perf_counter() - t0
    argv = sweep.run_argv('lgcn', '0', data_dir, QUALITY_EPOCHS,
                          QUALITY_EVAL_EVERY, QUALITY_LR)
    reset_counts()
    t0 = time.perf_counter()
    trainer, run_dir = cli_run(data_dir, argv, 'cuda')
    wall_s = time.perf_counter() - t0
    launches = counts()
    best = sweep.best_metrics(run_dir)
    steps = trainer.model.num_batches(BATCH)
    want = dict.fromkeys(_wrappers(), 0)
    want['spmm_dropout'] = (best['epochs_run'] * steps * 4 * LAYERS
                            + best['n_evals'] * 2 * LAYERS)
    jax_row = jax_quality_row()
    port = {k: best[k] for k in QUALITY_METRICS}
    log(f'quality lgcn ({card}): {rows["train"]} train / {rows["test"]} '
        f'test rows generated in {gen_s:.3f} s; {steps} steps an epoch, '
        f'{best["epochs_run"]} epochs, {best["n_evals"]} evals, cli.main '
        f'{wall_s:.3f} s; best {json.dumps(port)}; the JAX package on the '
        f'TPU (QUALITY_r05.jsonl): '
        + (json.dumps({k: jax_row[k] for k in (*QUALITY_METRICS, 'n_evals',
                                                'wall_s')})
           if jax_row else 'not in this checkout')
        + f'; launches {launches}')
    check(all(np.isfinite(v) for v in port.values()),
          f'quality: metrics {port}')
    check(launches == want, f'quality: launches {launches}, expected {want} '
          f'({best["epochs_run"]} epochs x {steps} steps x 12 + '
          f'{best["n_evals"]} evals x 6)')
    check(best['recall@20'] >= QUALITY_FLOOR,
          f'quality: best recall@20 {best["recall@20"]:.4f} is under '
          f'{QUALITY_FLOOR}')
    return {'launches': launches, 'generate_s': gen_s, 'wall_s': wall_s,
            'train_rows': rows['train'], 'test_rows': rows['test'],
            'steps_per_epoch': steps, 'epochs_run': best['epochs_run'],
            'n_evals': best['n_evals'], 'best': port,
            'jax_tpu_row': jax_row}


def trace_phase(data_dir: str, root: str) -> dict:
    """``lgcn --epochs 1 --trace DIR`` through the CLI on ``data_dir``
    (the boosted phase's 4,096-user cut of S1, S1's widths): the trace
    parses, names K1's kernel symbol (``spmm_dropout_kernel`` of
    ``csrc/spmm_dropout.cu``) and holds one K1 device event for each
    launch the wrapper counted in that run."""
    from textgcn_tpu_torch.utils.profiling import device_events, trace_path
    trace_dir = os.path.join(root, 'trace_lgcn')
    argv = ['--model', 'lgcn', '--epochs', '1', '--evaluate_every', '1',
            '--emb_size', str(D), '--n_layers', str(LAYERS), '--batch_size',
            str(BATCH), '--dropout', '0.4', '-k', *map(str, KS), '--uid',
            'trace-lgcn', '--quiet', '--trace', trace_dir]
    reset_counts()
    t0 = time.perf_counter()
    trainer, _ = cli_run(data_dir, argv, 'cuda')
    wall_s = time.perf_counter() - t0
    launches = counts()
    steps = trainer.model.num_batches(BATCH)
    want = dict.fromkeys(_wrappers(), 0)
    want['spmm_dropout'] = steps * 4 * LAYERS + 2 * LAYERS
    check(launches == want, f'trace: launches {launches}, expected {want}')
    path = trace_path(trace_dir, 0)
    check(os.listdir(trace_dir) == [os.path.basename(path)],
          f'trace: {os.listdir(trace_dir)} in {trace_dir}')
    events = device_events(path)
    k1 = [e for e in events if e.get('cat') == 'kernel'
          and re.search(r'\bspmm_dropout_kernel\b', e.get('name', ''))]
    names = sorted({e['name'] for e in k1})
    log(f'trace lgcn: {os.path.getsize(path)} bytes, {len(events)} device '
        f'events, {len(k1)} of K1 ({names}), cli.main {wall_s:.3f} s; '
        f'launches {launches}')
    check(len(k1) == launches['spmm_dropout'],
          f'trace: {len(k1)} K1 device events, the wrapper counted '
          f'{launches["spmm_dropout"]}')
    return {'launches': launches, 'wall_s': wall_s,
            'trace_bytes': os.path.getsize(path),
            'device_events': len(events), 'k1_events': len(k1),
            'k1_symbols': names}


def mesh_phase(data_dir: str, single, card: str, trace_dir: str,
               dev) -> dict:
    """``lgcn --mesh 1x1`` trained through the CLI against the single-card
    ``lgcn`` run ``single`` (phase 8), its ``best.pkl`` re-served through
    the non-mesh CLI, then ``--mesh 1x1`` serving in a group started here,
    and the timing of that trainer."""
    import torch.distributed as dist

    from textgcn_tpu_torch.parallel import multihost
    flags = MODEL_FLAGS['lgcn']
    common = ['--emb_size', str(D), '--n_layers', str(LAYERS),
              '--batch_size', str(BATCH), '-k', *map(str, KS)]
    argv = [*flags, '--epochs', str(TRAIN_EPOCHS), '--evaluate_every', '1',
            '--dropout', '0.4', *common, '--uid', 'train-lgcn-mesh',
            '--quiet', '--mesh', '1x1']
    reset_counts()
    t0 = time.perf_counter()
    trainer, run_dir = cli_run(data_dir, argv, 'cuda')
    seconds = time.perf_counter() - t0
    launches = counts()
    check(not dist.is_initialized(),
          'the CLI left its process group behind')
    steps = trainer.model.num_batches(BATCH)
    want = expected_launches('lgcn_mesh', steps * TRAIN_EPOCHS, TRAIN_EPOCHS)
    log(f'mesh lgcn 1x1: cli.main took {seconds:.3f} s; launches {launches}')
    check(launches == want, f'mesh lgcn: launches {launches}, expected '
          f'{want}')
    got = [h['loss'] for h in trainer.loss_history]
    ref = [h['loss'] for h in single.loss_history]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    log(f'mesh lgcn: loss sums {got} vs single card {ref} (largest relative '
        f'difference {rel:.3e})')
    check(len(got) == len(ref) and rel <= TOL,
          f'mesh lgcn loss sums {got} vs single card {ref}')
    rows = trainer.metrics_logger
    for name, v in rows.items():
        check(np.allclose(v, single.metrics_logger[name], atol=1e-6, rtol=0),
              f'mesh lgcn {name} by eval {v.tolist()} vs single card '
              f'{single.metrics_logger[name].tolist()}')
    best = best_row(rows['recall'][:, 0])
    served, _ = serve(data_dir, 'best-lgcn-mesh',
                      ['--load', run_dir, *common], 'cuda', model=flags)
    for name, v in served.last_metrics.items():
        check(np.allclose(v, rows[name][best], atol=1e-6, rtol=0),
              f'mesh best.pkl serves {name} {v} through the non-mesh CLI, '
              f'its epoch {best + 1} measured {rows[name][best]}')
    log(f'mesh lgcn: metrics equal the single card run\'s at every eval; '
        f'best.pkl (epoch {best + 1}) serves them through the non-mesh CLI')

    created = multihost.maybe_initialize(multihost.local_device(dev.type))
    try:
        reset_counts()
        mesh_served, serve_dir = serve(
            data_dir, 'serve-lgcn-mesh',
            ['--load', run_dir, '--predict', *common, '--mesh', '1x1'],
            'cuda', model=flags)
        serve_launches = counts()
        want = expected_launches('lgcn_mesh', 0, 2)
        check(serve_launches == want, f'mesh serving launched '
              f'{serve_launches}, expected {want}')
        for name, v in mesh_served.last_metrics.items():
            check(np.allclose(v, rows[name][best], atol=1e-6, rtol=0),
                  f'mesh serving {name} {v} vs {rows[name][best]}')
        preds = read_predictions(os.path.join(serve_dir, 'predictions.tsv'))
        check(len(preds) == S1_USERS
              and all(len(p[1]) == max(KS) for p in preds),
              'mesh predictions.tsv: one row of top-40 per user')
        log(f'mesh serve 1x1: launches {serve_launches}, metrics as trained')
        timing = timing_phase(mesh_served, card, trace_dir,
                              name='lgcn_mesh')
    finally:
        if created:
            dist.destroy_process_group()
    return {'launches': launches, 'serve_launches': serve_launches,
            'seconds': seconds, 'timing': timing}


# the conv family on --mesh 1x1: its epoch's loss sum and metrics against
# the single card's first epoch within these (relative, absolute) limits.
# K1 adds in a fixed order.  K4 and K6 add with float atomics, and Adam
# carries the differences through the epoch (gat on an H100: up to 5.3e-3
# in the loss sum between two single-card epochs of one seed).  So for gat
# and gatv2 mesh_conv_phase first runs SPREAD_EPOCHS more single-card
# epochs and holds the mesh epoch, one more draw of that noise, to
# MESH_SPREAD_FACTOR times the largest difference between any two of them
# (three pairs), or to the floor below if that is larger.  A step from the
# same params, batch and salts is held to STEP_TOL besides: that check is
# deterministic, and it is the one that would see a drifting mesh path.
MESH_CONV_TOL = {'gcn': (TOL, 1e-6), 'graphsage': (TOL, 1e-6),
                 'gat': (1e-3, 1e-3), 'gatv2': (1e-3, 1e-3)}
SPREAD_EPOCHS = 2
MESH_SPREAD_FACTOR = 4.0
SHARDS = 4


def shard_kernel_phase(data, dev) -> dict:
    """K1 and K3-K6 on the W = 4 destination shards of S1, in this one
    process: each rank's ``MeshConvOp`` (global ids, the edges into its
    rows; the backward kernels on the shard's own transpose), both
    directions at keep 0.6.  Each launch against its plain version (K1
    and K3/K5 ``TOL``, K3's ``m`` bit for bit, K4/K6 ``GAT_BWD_TOL``),
    the forward outputs' rows of each shard against the whole-graph
    kernel's, and the backward partials summed over the shards (K4's
    ``dd`` and K6's ``dhd`` live on the shard's own rows) against the
    whole-graph kernel's.  Returns per kernel the largest error and one
    layer's (to_user + to_item) time and bound per shard, the mean over
    the four (the bound counts the rows the rank keeps,
    ``shard_bound_ms``)."""
    from textgcn_tpu_torch.ops import gat
    from textgcn_tpu_torch.ops.spmm import (GraphOp, edge_mask,
                                            spmm_dropout_cuda, spmm_plain)
    from textgcn_tpu_torch.parallel.mesh import Mesh
    from textgcn_tpu_torch.parallel.sharded_conv import MeshConvOp
    g = data.graph
    nu = -(-data.n_users // SHARDS) * SHARDS
    ni = -(-data.n_items // SHARDS) * SHARDS
    whole = GraphOp(g.edge_user, g.edge_item, np.ones(g.n_edges, np.float32),
                    nu, ni, dev)
    ops = [MeshConvOp(g.edge_user, g.edge_item, nu, ni,
                      Mesh((1, SHARDS), r, dev)) for r in range(SHARDS)]
    gen = torch.Generator().manual_seed(6)
    names = ('spmm_dropout', 'gat_fwd', 'gat_bwd', 'gatv2_fwd', 'gatv2_bwd')
    res = {n: {'max_abs_err': 0.0, 'ms': 0.0, 'bound_ms': 0.0}
           for n in names}
    pair = (SALT, KEEP_DROPOUT)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    def hold(name, what, got, want, tol, whole_sum=(), exact=()):
        torch.cuda.synchronize()
        errs = [float((x - y).abs().max()) for x, y in zip(got, want)]
        res[name]['max_abs_err'] = max(res[name]['max_abs_err'], *errs)
        ok = all(agree(x, y, tol, j in whole_sum)
                 for j, (x, y) in enumerate(zip(got, want)))
        ok &= all(torch.equal(got[j], want[j]) for j in exact)
        check(ok, f'{name} {what} disagrees (max abs err by output '
              f'{errs})')
        return errs

    for direction in ('to_user', 'to_item'):
        fwd, bwd = whole.csr_pair(direction)
        x = rand(fwd.n_src, D)
        h, s, d_dst = rand(fwd.n_src, D), rand(fwd.n_src), rand(fwd.n_dst)
        hs, hd, a = rand(fwd.n_src, D), rand(fwd.n_dst, D), rand(D, scale=0.5)
        g_num, g_den = rand(fwd.n_dst, D), rand(fwd.n_dst)
        want = {'spmm_dropout': (spmm_dropout_cuda(fwd, x, *pair),),
                'gat_fwd': gat.gat_fwd_cuda(fwd, h, s, d_dst, *pair),
                'gatv2_fwd': gat.gatv2_fwd_cuda(fwd, hs, hd, a, *pair)}
        want['gat_bwd'] = gat.gat_bwd_cuda(bwd, h, s, d_dst,
                                           want['gat_fwd'][2], g_num, g_den,
                                           *pair)
        want['gatv2_bwd'] = gat.gatv2_bwd_cuda(bwd, hs, hd, a,
                                               want['gatv2_fwd'][2], g_num,
                                               g_den, *pair)
        sums = {'spmm_dropout': [torch.zeros_like(want['spmm_dropout'][0])],
                'gat_bwd': [torch.zeros_like(t) for t in want['gat_bwd']],
                'gatv2_bwd': [torch.zeros_like(t) for t in want['gatv2_bwd']]}
        for r, op in enumerate(ops):
            sf, sb = op.csr_pair(direction)
            own = op.mesh.rows(sf.n_dst)
            calls = {
                'spmm_dropout': lambda sf=sf: (spmm_dropout_cuda(
                    sf, x, *pair),),
                'gat_fwd': lambda sf=sf: gat.gat_fwd_cuda(sf, h, s, d_dst,
                                                          *pair),
                'gatv2_fwd': lambda sf=sf: gat.gatv2_fwd_cuda(sf, hs, hd, a,
                                                              *pair)}
            got = {n: fn() for n, fn in calls.items()}
            m3, m5 = got['gat_fwd'][2], got['gatv2_fwd'][2]
            calls['gat_bwd'] = lambda sb=sb, m3=m3: gat.gat_bwd_cuda(
                sb, h, s, d_dst, m3, g_num, g_den, *pair)
            calls['gatv2_bwd'] = lambda sb=sb, m5=m5: gat.gatv2_bwd_cuda(
                sb, hs, hd, a, m5, g_num, g_den, *pair)
            got['gat_bwd'] = calls['gat_bwd']()
            got['gatv2_bwd'] = calls['gatv2_bwd']()
            plain = {
                'spmm_dropout': (spmm_plain(sf, x, *pair),),
                'gat_fwd': gat.gat_att_plain(sf, h, s, d_dst, *pair),
                'gatv2_fwd': gat.gatv2_att_plain(sf, hs, hd, a, *pair),
                'gat_bwd': gat.gat_bwd_plain(sb, h, s, d_dst, m3, g_num,
                                             g_den, *pair),
                'gatv2_bwd': gat.gatv2_bwd_plain(sb, hs, hd, a, m5, g_num,
                                                 g_den, *pair)}
            what = f'{direction} shard {r}'
            for n in names:
                bwd_kernel = n.endswith('_bwd')
                hold(n, f'{what} vs plain', got[n], plain[n],
                     GAT_BWD_TOL if bwd_kernel else TOL,
                     whole_sum=(2,) if n == 'gatv2_bwd' else (),
                     exact=(2,) if n == 'gat_fwd' else ())
            for n in ('gat_fwd', 'gatv2_fwd'):
                hold(n, f'{what}: its rows vs the whole graph',
                     [t[own] for t in got[n]], [t[own] for t in want[n]],
                     TOL, exact=(2,) if n == 'gat_fwd' else ())
            for n, parts in sums.items():
                for acc, t in zip(parts, got[n]):
                    acc += t
            check(not got['spmm_dropout'][0][:own.start].any()
                  and not got['spmm_dropout'][0][own.stop:].any(),
                  f'K1 {what} wrote rows it does not own')
            t = time_ms(calls, [*names, *names[::-1]], strict=names)
            n_kept = int(edge_mask(sf, *pair)[2].sum())
            bounds = {n: shard_bound_ms(n, sf, sb, D, n_kept,
                                        own.stop - own.start)
                      for n in names}
            log(f'shard kernels {what} (E={sf.n_edges}, kept {n_kept}, '
                f'{sf.n_dst}x{sf.n_src}, d={D}): '
                + ', '.join(f'{n} {t[n]:.4f} ms (bound {bounds[n]:.4f})'
                            for n in names))
            for n in names:
                res[n]['ms'] += t[n] / SHARDS
                res[n]['bound_ms'] += bounds[n] / SHARDS
        for n, parts in sums.items():
            hold(n, f'{direction}: the {SHARDS} shards summed vs the whole '
                 'graph', parts, want[n],
                 TOL if n == 'spmm_dropout' else GAT_BWD_TOL,
                 whole_sum=(2,) if n == 'gatv2_bwd' else ())
    log('shard kernels, W = 4 destination shards, a layer per shard: '
        + json.dumps(res))
    return res


def epoch_diffs(a, b) -> tuple[float, float]:
    """Two trainers' first epochs: the relative difference of their loss
    sums and the largest difference of their metrics."""
    la, lb = a.loss_history[0]['loss'], b.loss_history[0]['loss']
    return (abs(la - lb) / abs(lb),
            max(float(np.abs(v[0] - b.metrics_logger[n][0]).max())
                for n, v in a.metrics_logger.items()))


def mesh_conv_phase(data_dir: str, trained: dict, card: str,
                    trace_dir: str, dev) -> dict:
    """``gcn``, ``graphsage --aggr mean``, ``gat`` and ``gatv2`` with
    ``--mesh 1x1`` through the CLI (in a one-rank group started here) for
    1 epoch and 1 evaluation: exact K1/K3-K6 launches, the loss sum and
    the metrics against the single-card run's first epoch
    (``MESH_CONV_TOL``; for ``gat`` and ``gatv2`` at least
    ``MESH_SPREAD_FACTOR`` times the spread of ``SPREAD_EPOCHS`` more
    single-card epochs, run first), ``best.pkl``
    re-served through the non-mesh CLI, one step against the single
    card's from the same params, batch and salts (``STEP_TOL``), and each
    trainer timed."""
    import torch.distributed as dist

    from textgcn_tpu_torch.parallel import multihost
    from textgcn_tpu_torch.parallel.sharded_conv import MeshConvOp
    common = ['--emb_size', str(D), '--n_layers', str(LAYERS),
              '--batch_size', str(BATCH), '-k', *map(str, KS)]
    out = {}
    created = multihost.maybe_initialize(multihost.local_device(dev.type))
    try:
        for model in ('gcn', 'graphsage', 'gat', 'gatv2'):
            flags = MODEL_FLAGS[model]
            argv = [*flags, '--epochs', '1', '--evaluate_every', '1',
                    '--dropout', '0.4', *common, '--uid',
                    f'train-{model}-mesh', '--quiet', '--mesh', '1x1']
            single = trained[model]['trainer']
            rel_tol, metric_tol = MESH_CONV_TOL[model]
            if model in ('gat', 'gatv2'):
                # the card's own spread: more single-card epochs
                runs = [single] + [cli_run(data_dir, [
                    *argv[:argv.index('--uid')], '--uid', f'again-{model}-{j}',
                    '--quiet'], 'cuda')[0] for j in range(SPREAD_EPOCHS)]
                spread = [max(epoch_diffs(a, b)[j]
                              for k, a in enumerate(runs) for b in runs[:k])
                          for j in (0, 1)]
                rel_tol = max(rel_tol, MESH_SPREAD_FACTOR * spread[0])
                metric_tol = max(metric_tol, MESH_SPREAD_FACTOR * spread[1])
                log(f'{model}: {len(runs)} single-card epochs differ by up '
                    f'to {spread[0]:.3e} (loss sum, relative) and '
                    f'{spread[1]:.3e} (metrics); the mesh epoch\'s limits: '
                    f'{rel_tol:.3e} and {metric_tol:.3e}')
            reset_counts()
            t0 = time.perf_counter()
            trainer, run_dir = cli_run(data_dir, argv, 'cuda')
            seconds = time.perf_counter() - t0
            launches = counts()
            steps = trainer.model.num_batches(BATCH)
            want = expected_launches(model, steps, 1)
            log(f'mesh {model} 1x1: cli.main took {seconds:.3f} s; '
                f'launches {launches}')
            check(isinstance(trainer.model.graph_op, MeshConvOp),
                  f'mesh {model}: graph op {type(trainer.model.graph_op)}')
            check(launches == want, f'mesh {model}: launches {launches}, '
                  f'expected {want}')
            got = trainer.loss_history[0]['loss']
            ref = single.loss_history[0]['loss']
            rel, metric_err = epoch_diffs(trainer, single)
            log(f'mesh {model}: epoch 1 loss sum {got} vs single card {ref} '
                f'(relative difference {rel:.3e}, limit {rel_tol}); '
                f'metrics differ by {metric_err:.3e} (limit {metric_tol})')
            check(np.isfinite(got) and rel <= rel_tol,
                  f'mesh {model}: loss sum {got} vs single card {ref}')
            check(metric_err <= metric_tol,
                  f'mesh {model}: metrics differ from the single card run '
                  f'by {metric_err}')
            rows = trainer.metrics_logger
            served, _ = serve(data_dir, f'best-{model}-mesh',
                              ['--load', run_dir, *common], 'cuda',
                              model=flags)
            for name, v in served.last_metrics.items():
                check(np.allclose(v, rows[name][0], atol=1e-6, rtol=0),
                      f'mesh {model}: best.pkl serves {name} {v} through '
                      f'the non-mesh CLI, its epoch measured {rows[name][0]}')
            # one step of each from the single card's params, batch, salts
            m, one = trainer.model, single.model
            m.load_params(one.param_tree())
            batch = one.sample_batches(
                torch.Generator(device=one.device).manual_seed(5), BATCH)[0]
            w_pairs = ((SALT, KEEP_DROPOUT), (SALT ^ 0x5A5A5A5A,
                                              KEEP_DROPOUT))
            step_err = compare_steps(m, *loss_and_grads(m, batch, w_pairs),
                                     *loss_and_grads(one, batch, w_pairs),
                                     names=('--mesh 1x1', 'the single card'))
            one.zero_grad(set_to_none=True)
            out[model] = {'launches': launches, 'seconds': seconds,
                          'loss_rel_diff': rel, 'metric_diff': metric_err,
                          'step_err': step_err,
                          'limits': (rel_tol, metric_tol),
                          **({'single_card_spread': spread}
                             if model in ('gat', 'gatv2') else {}),
                          'timing': timing_phase(trainer, card, trace_dir,
                                                 name=f'{model}_mesh')}
    finally:
        if created:
            dist.destroy_process_group()
    return out


def mesh_ltr_phase(data_dir: str, ck: str, trained: dict, dev) -> dict:
    """``ltr_linear`` and ``ltr_pop --load_base ck --freeze --mesh 1x1``
    through the CLI (in a one-rank group started here) for 1 epoch and 1
    evaluation: exact K2 launches (forward only: base eval, steps, eval),
    the frozen tables the checkpoint's bit for bit, the loss sum within
    ``TOL`` relative of the single-card run's first epoch (phase 9d); then
    the fused catalogue-sharded top-40 of 256 users against the
    single-card head's with the same tower (copied in and restored), up
    to ties (``LTR_TOL``)."""
    import torch.distributed as dist

    from textgcn_tpu_torch.parallel import multihost
    common = ['--emb_size', str(D), '--n_layers', str(LAYERS),
              '--batch_size', str(BATCH), '-k', *map(str, KS)]
    with open(ck, 'rb') as f:
        base = pickle.load(f)['params']
    out = {}
    created = multihost.maybe_initialize(multihost.local_device(dev.type))
    try:
        for model in ('ltr_linear', 'ltr_pop'):
            argv = ['--model', model, '--load_base', ck, '--freeze',
                    '--epochs', '1', '--evaluate_every', '1', '--dropout',
                    '0.4', '--uid', f'train-{model}-mesh', '--quiet',
                    '--mesh', '1x1', *common]
            reset_counts()
            t0 = time.perf_counter()
            trainer, _ = cli_run(data_dir, argv, 'cuda')
            seconds = time.perf_counter() - t0
            launches = counts()
            m = trainer.model
            per_pass = 2 * LAYERS
            want = dict.fromkeys(_wrappers(), 0)
            want['spmm_weighted'] = (per_pass + m.num_batches(BATCH)
                                     * per_pass + per_pass)
            log(f'mesh {model} 1x1: cli.main took {seconds:.3f} s; launches '
                f'{launches}')
            check(launches == want, f'mesh {model}: launches {launches}, '
                  f'expected {want} (base eval + steps + eval, forward '
                  'only)')
            tree = m.param_tree()
            for name, n in (('user_emb', m.n_users), ('item_emb', m.n_items)):
                check(np.array_equal(tree[name].detach().cpu().numpy(),
                                     base[name][:n]),
                      f'mesh {model}: the frozen {name} changed in training')
            loss = trainer.loss_history[0]['loss']
            ref = trained[model]['trainer'].loss_history[0]['loss']
            rel = abs(loss - ref) / abs(ref)
            check(np.isfinite(loss) and rel <= TOL,
                  f'mesh {model}: epoch 1 loss sum {loss} vs the single '
                  f'card\'s {ref} (relative difference {rel:.3e})')
            single = trained[model]['trainer'].model
            saved = [p.detach().clone() for p in single.tower.parameters()]
            users = torch.arange(N_CHECK_USERS, device=m.device)
            try:
                with torch.no_grad():
                    for p, q in zip(single.tower.parameters(),
                                    m.tower.parameters()):
                        p.copy_(q)
                    mesh_v, mesh_i = m.topk_for_users(m.scoring_reprs(),
                                                      users, max(KS))
                    ref_v, ref_i = single.topk_for_users(
                        single.scoring_reprs(), users, max(KS))
            finally:
                with torch.no_grad():
                    for p, v in zip(single.tower.parameters(), saved):
                        p.copy_(v)
            err = float((mesh_v - ref_v).abs().max())
            same = same_up_to_ties(mesh_v.cpu().numpy(), mesh_i.tolist(),
                                   ref_v.cpu().numpy(), ref_i.tolist(),
                                   LTR_TOL)
            log(f'mesh {model}: tables unchanged; epoch 1 loss sum {loss} vs '
                f'the single card\'s {ref} (relative difference {rel:.3e}); '
                f'fused sharded top-{max(KS)} of {N_CHECK_USERS} users vs '
                f'the single-card head: max abs err {err:.3e}, same up to '
                f'ties={same}')
            check(same, f'mesh {model}: the fused sharded top-k differs '
                  'from the single-card head\'s')
            out[model] = {'launches': launches, 'seconds': seconds,
                          'loss_rel_diff': rel, 'topk_err': err}
    finally:
        if created:
            dist.destroy_process_group()
    return out


# slices 7-9 on --mesh 1x1 against their single-card runs: a step from the
# same params, batch, draws and salts within MESH_STEP_TOL (W = 1 runs K2,
# which gives K1's bits, and the gathers are copies); the first epoch's
# loss sum and metrics within (TOL, 1e-6), unless a repeated single-card
# epoch already differs from the first by more, when the limits become
# MESH_SPREAD_FACTOR times that difference, at least MESH_SPREAD_FLOOR
MESH_STEP_TOL = 1e-6
MESH_SPREAD_FLOOR = 1e-3


def repeat_epoch(single):
    """The single-card run's first epoch again, in this process: the same
    class, config and loaded data, a fresh model from the seed, one epoch
    and its evaluation, nothing saved."""
    import dataclasses

    from textgcn_tpu_torch.train.trainer import Trainer
    cfg = dataclasses.replace(single.cfg, epochs=1, save=False)
    model = type(single.model)(cfg, single.data, device=single.model.device)
    again = Trainer(cfg, model, single.data)
    again.fit()
    return again


def mesh_epoch_limits(model: str, single) -> dict:
    """The limits of a mesh epoch against ``single``'s first: strict when a
    repeated single-card epoch repeats it within them, else the spread
    rule (see ``MESH_STEP_TOL``)."""
    rel, metric = epoch_diffs(repeat_epoch(single), single)
    strict = rel <= TOL and metric <= 1e-6
    limits = ((TOL, 1e-6) if strict else
              (max(MESH_SPREAD_FLOOR, MESH_SPREAD_FACTOR * rel),
               max(MESH_SPREAD_FLOOR, MESH_SPREAD_FACTOR * metric)))
    log(f'{model}: a repeated single-card epoch differs from the first by '
        f'{rel:.3e} (loss sum, relative) and {metric:.3e} (metrics): the '
        f'{"strict" if strict else "spread"} rule, limits {limits[0]:.3e} '
        f'and {limits[1]:.3e}')
    return {'rule': 'strict' if strict else 'spread',
            'single_card_repeat': (rel, metric), 'limits': limits}


def mesh_slice_step(model: str, m, one) -> dict:
    """One step of the mesh model ``m`` and of the single-card model
    ``one`` from ``one``'s params and the same batch, draws and salts
    (``MESH_STEP_TOL``); ``adv_sampling``'s hard negatives must agree in
    every row."""
    m.load_params(one.param_tree())
    w_pairs = ((SALT, KEEP_DROPOUT), (SALT ^ 0x5A5A5A5A, KEEP_DROPOUT))
    names = ('--mesh 1x1', 'the single card')
    if model != 'adv_sampling':
        batch = one.sample_batches(
            torch.Generator(device=one.device).manual_seed(5), BATCH)[0]
        err = compare_steps(m, *loss_and_grads(m, batch, w_pairs),
                            *loss_and_grads(one, batch, w_pairs),
                            names=names, tol=MESH_STEP_TOL)
        one.zero_grad(set_to_none=True)
        return {'step_err': err}
    users, keep, ridx = adv_draws(one, 5)
    w_loss = ((SALT ^ 0x1234567, KEEP_DROPOUT),
              (SALT ^ 0x7654321, KEEP_DROPOUT))
    mined = {}

    def step(model_):
        mine = model_.hard_negatives
        model_.hard_negatives = lambda *a: mined.setdefault(
            id(model_), mine(*a))
        try:
            model_.zero_grad(set_to_none=True)
            loss, _ = model_.loss_given(users, keep, ridx, w_pairs, w_loss)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            del model_.hard_negatives
        return loss.detach(), {n: p.grad.detach().clone()
                               for n, p in model_.named_parameters()}

    err = compare_steps(m, *step(m), *step(one), names=names,
                        tol=MESH_STEP_TOL)
    one.zero_grad(set_to_none=True)
    (negs, valid), (ref_negs, ref_valid) = mined[id(m)], mined[id(one)]
    agree = float(((negs == ref_negs) & (valid == ref_valid)).all(dim=1)
                  .float().mean())
    check(agree == 1.0, f'mesh adv_sampling: the hard negatives agree with '
          f'the single card\'s in {agree:.4f} of the rows')
    log(f'mesh adv_sampling: the hard negatives of {users.shape[0]} users '
        'are the single card\'s in every row')
    return {'step_err': err, 'selection_agreement': agree}


def mesh_slice_phase(data_dir: str, trained: dict, probes: dict, dev,
                     card: str, trace_dir: str) -> dict:
    """Slices 7-9 with ``--mesh 1x1`` through the CLI, in one one-rank
    group started here: each ``SLICE_FLAGS`` model for 1 epoch and 1
    evaluation (exact K2 launches and no other; the epoch against the
    single-card run's first, ``mesh_epoch_limits``; one step,
    ``mesh_slice_step``; for ``ltr_reviews`` and ``ltr_kg`` the fused
    sharded top-40 of 256 users against the single-card scorer's on the
    same tables, up to ties), ``adv_sampling``'s mesh step timed; then
    ``text_probe`` and ``ltr_simple --load_base <phase 8's lgcn run>``:
    every metric of every probe the single-card probe's (1e-6)."""
    import torch.distributed as dist

    from textgcn_tpu_torch.parallel import multihost
    from textgcn_tpu_torch.parallel.sharded_spmm import MeshGraphOp
    common = ['--emb_size', str(D), '--n_layers', str(LAYERS),
              '--batch_size', str(BATCH), '-k', *map(str, KS), '--quiet',
              '--mesh', '1x1']
    out = {}
    created = multihost.maybe_initialize(multihost.local_device(dev.type))
    try:
        for model, (flags, _) in SLICE_FLAGS.items():
            t0 = time.perf_counter()
            single = trained[model]['trainer']
            res = mesh_epoch_limits(model, single)
            rel_tol, metric_tol = res['limits']
            argv = [*flags, '--epochs', '1', '--evaluate_every', '1',
                    '--dropout', '0.4', '--uid', f'train-{model}-mesh',
                    *common]
            reset_counts()
            t1 = time.perf_counter()
            trainer, _ = cli_run(data_dir, argv, 'cuda')
            run_s = time.perf_counter() - t1
            launches = counts()
            m = trainer.model
            steps = m.num_batches(BATCH)
            want = expected_launches(f'{model}_mesh', steps, 1)
            log(f'mesh {model} 1x1: cli.main took {run_s:.3f} s; launches '
                f'{launches}')
            check(isinstance(m.graph_op, MeshGraphOp),
                  f'mesh {model}: graph op {type(m.graph_op)}')
            check(launches == want, f'mesh {model}: launches {launches}, '
                  f'expected {want}')
            rel, metric_err = epoch_diffs(trainer, single)
            hist = trainer.loss_history[0]
            log(f'mesh {model}: epoch 1 loss sums {json.dumps(hist)} vs the '
                f'single card\'s {json.dumps(single.loss_history[0])} '
                f'(relative difference {rel:.3e}, limit {rel_tol:.3e}); '
                f'metrics differ by {metric_err:.3e} (limit '
                f'{metric_tol:.3e})')
            check(all(np.isfinite(v) for v in hist.values())
                  and rel <= rel_tol, f'mesh {model}: loss sum '
                  f'{hist["loss"]} vs {single.loss_history[0]["loss"]}')
            check(metric_err <= metric_tol, f'mesh {model}: metrics differ '
                  f'from the single card run by {metric_err}')
            res.update(mesh_slice_step(model, m, single.model))
            if model in ('ltr_reviews', 'ltr_kg'):
                users = torch.arange(N_CHECK_USERS, device=m.device)
                with torch.no_grad():
                    mesh_v, mesh_i = m.topk_for_users(m.scoring_reprs(),
                                                      users, max(KS))
                    one = single.model
                    ref_v, ref_i = one.topk_for_users(one.scoring_reprs(),
                                                      users, max(KS))
                err = float((mesh_v - ref_v).abs().max())
                same = same_up_to_ties(mesh_v.cpu().numpy(), mesh_i.tolist(),
                                       ref_v.cpu().numpy(), ref_i.tolist(),
                                       LTR_TOL)
                log(f'mesh {model}: fused sharded top-{max(KS)} of '
                    f'{N_CHECK_USERS} users vs the single-card scorer on '
                    f'the same tables: max abs err {err:.3e}, same up to '
                    f'ties={same}')
                check(same, f'mesh {model}: the fused sharded top-k '
                      'differs from the single card\'s')
                res['topk_err'] = err
            if model == 'adv_sampling':
                res['timing'] = timing_phase(trainer, card, trace_dir,
                                             name='adv_sampling_mesh')
            res.update(launches=launches, seconds=run_s, loss_rel_diff=rel,
                       metric_diff=metric_err)
            out[model] = res
            log(f'phase mesh slice {model}: {time.perf_counter() - t0:.3f} '
                's')
        base = trained['lgcn']['run_dir']
        for name, argv, n_evals in (
                ('text_probe', ['--model', 'text_probe'], 0),
                ('ltr_simple', ['--model', 'ltr_simple', '--load_base',
                                base], 3)):
            reset_counts()
            t0 = time.perf_counter()
            trainer, _ = cli_run(data_dir, [*argv, '--uid',
                                            f'probe-{name}-mesh', *common],
                                 'cuda')
            seconds = time.perf_counter() - t0
            launches = counts()
            want = expected_launches('lgcn_mesh', 0, n_evals)
            check(launches == want, f'mesh probe {name}: launches '
                  f'{launches}, expected {want}')
            ref = probes[name]['metrics']
            err = max(float(np.abs(v - ref[k]).max())
                      for k, v in trainer.metrics_logger.items())
            log(f'mesh probe {name} 1x1: cli.main took {seconds:.3f} s; '
                f'launches {launches}; every metric of every probe within '
                f'{err:.3e} of the single card\'s')
            check(all(v.shape == ref[k].shape
                      for k, v in trainer.metrics_logger.items())
                  and err <= 1e-6, f'mesh probe {name}: metrics differ '
                  f'from the single card\'s by {err}')
            out[f'probe_{name}'] = {'launches': launches, 'seconds': seconds,
                                    'metric_diff': err}
    finally:
        if created:
            dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# slice 14: serving mode, the mining target, the encoder, the health check
# and cold_report

APPROX = 0.95
APPROX_CHECK_USERS = 4096    # users whose served top-k approx_phase checks


def approx_phase(data_dir: str, ck: str, exact_seconds: float) -> dict:
    """S1 served with ``--approx_topk 0.95`` through ``cli.main``, on one
    card (12 K1 launches) and with ``--mesh 1x1`` (12 K2 launches, the
    single card's ``predictions.tsv`` byte for byte and its metrics).
    For the first ``APPROX_CHECK_USERS`` users: the served top-40 (items
    and 4-decimal values) equals the float32 scores rounded to bfloat16,
    masked, top-k with ties to the lower index, computed here on the card
    a batch at a time; each exact top-40 item (phase 7's serve) is served
    or tied in bfloat16 with the 40th served value; the mean top-40
    recall against phase 7 is at least 0.95 (the per-user minimum is
    logged: bfloat16 ties at the 40th place swap items).  One batch's
    retrieval is timed in both modes."""
    from textgcn_tpu_torch.ops.retrieval import (APPROX_TOPK_ENV,
                                                 catalog_scores,
                                                 mask_train_items,
                                                 score_and_topk,
                                                 top_k_lower_index)
    argv = ['--load', ck, '--predict', '--emb_size', str(D), '--n_layers',
            str(LAYERS), '--batch_size', str(BATCH), '-k', *map(str, KS),
            '--approx_topk', str(APPROX)]
    out, runs = {}, {}
    for name, extra, kernel in (('single', [], 'spmm_dropout'),
                                ('mesh', ['--mesh', '1x1'],
                                 'spmm_weighted')):
        reset_counts()
        t0 = time.perf_counter()
        trainer, run_dir = serve(data_dir, f'approx-{name}', argv + extra,
                                 'cuda')
        seconds = time.perf_counter() - t0
        launches = counts()
        want = dict.fromkeys(_wrappers(), 0)
        want[kernel] = 2 * LAYERS * 2
        check(launches == want, f'approx serve {name}: launches {launches}, '
              f'expected {want} (eval + predict, 3 layers x 2 directions)')
        check(APPROX_TOPK_ENV not in os.environ,
              f'cli.main left {APPROX_TOPK_ENV} set')
        runs[name] = (trainer, run_dir)
        out[f'{name}_launches'] = launches[kernel]
        out[f'{name}_cli_s'] = seconds
        log(f'approx serve {name}: cli.main took {seconds:.3f} s (exact '
            f'serve {exact_seconds:.3f} s); launches {launches}')
    files = {}
    for name, (_, run_dir) in runs.items():
        with open(os.path.join(run_dir, 'predictions.tsv'), 'rb') as f:
            files[name] = f.read()
    check(files['mesh'] == files['single'],
          'approx serve --mesh 1x1: predictions.tsv differs from the '
          'single card\'s')
    single, mesh = runs['single'][0], runs['mesh'][0]
    for name, v in single.last_metrics.items():
        check(np.array_equal(v, mesh.last_metrics[name]),
              f'approx serve --mesh 1x1 {name} {mesh.last_metrics[name]} vs '
              f'{v}')

    model, data = single.model, single.data
    checked = min(data.n_users, APPROX_CHECK_USERS)
    preds = read_predictions(os.path.join(runs['single'][1],
                                          'predictions.tsv'), checked)
    exact = read_predictions(os.path.join(
        os.path.dirname(data_dir), 'runs', os.path.basename(data_dir),
        'smoke', 'predictions.tsv'), checked)
    k, n = max(KS), data.n_items
    index = {ext: i for i, ext in data.item_id_map.items()}
    served_i = np.array([[index[e] for e in p[1]] for p in preds])
    served_v = np.array([p[2] for p in preds])
    exact_i = np.array([[index[e] for e in p[1]] for p in exact])
    same = tied = True
    with torch.no_grad():
        ur, ir = model.scoring_reprs()
        for start in range(0, checked, BATCH):
            stop = min(start + BATCH, checked)
            users = torch.arange(start, stop, device=model.device)
            scores = mask_train_items(
                catalog_scores(ur[users], ir[:n]).to(torch.bfloat16),
                model.pos_padded[users], n)
            ref_v, ref_i = top_k_lower_index(scores, k)
            ref_v = ref_v.float()
            same &= (np.array_equal(ref_i.cpu().numpy(),
                                    served_i[start:stop])
                     and np.array_equal(np.round(ref_v.cpu().numpy(), 4),
                                        served_v[start:stop]))
            # every exact item is served, or its bfloat16 score ties with
            # the last served value
            e = torch.as_tensor(exact_i[start:stop], device=model.device)
            held = (e[:, :, None] == ref_i[:, None, :]).any(-1) | (
                scores.gather(1, e).float() >= ref_v[:, k - 1:])
            tied &= bool(held.all())
    check(same, f'approx serve: a user\'s served top-{k} is not the '
          'bfloat16-rounded float32 scores\' top-k')
    out['checked_users'] = checked
    recall = np.array([len(set(a[1]) & set(e[1])) / k
                       for a, e in zip(preds, exact)])
    out.update(recall_mean=float(recall.mean()),
               recall_min=float(recall.min()),
               share_below_target=float((recall < APPROX).mean()),
               share_exact=float((recall == 1).mean()))
    log(f'approx serve: top-{k} recall against the exact serve over '
        f'{len(recall)} users: mean {out["recall_mean"]:.6f}, min '
        f'{out["recall_min"]:.4f}, {out["share_below_target"]:.6f} of the '
        f'users below {APPROX}, {out["share_exact"]:.4f} identical sets; '
        f'their exact items served or tied in bfloat16 at the {k}th '
        f'place: {tied}')
    check(tied, 'approx serve: an exact top-k item is neither served nor '
          'tied with the last served value')
    check(out['recall_mean'] >= APPROX,
          f'approx serve: mean top-{k} recall {out["recall_mean"]}')

    with torch.no_grad():
        users = torch.arange(BATCH, device=model.device)
        u, pos = ur[users], model.pos_padded[users]
        fns = {'exact': lambda: score_and_topk(u, ir, pos, k=k, n_items=n,
                                               approx=0.0),
               'approx': lambda: score_and_topk(u, ir, pos, k=k, n_items=n,
                                                approx=APPROX)}
        ms = time_ms(fns, ['exact', 'approx', 'approx', 'exact'], strict=())
    out['batch_ms'] = ms
    log(f'approx serve: one {BATCH}-user batch\'s scoring, mask and top-{k} '
        f'{ms["approx"]:.4f} ms in serving mode, {ms["exact"]:.4f} ms '
        'exact')
    return out


# --- Orbax directories as the JAX package writes them (phase 7c) ----------

def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), in Python: the writer below does not lean on
    the port's reader for the checksum it checks."""
    c = 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ _CRC32C[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


def zstd_raw_frame(data: bytes) -> bytes:
    """``data`` as one zstd frame of raw blocks (RFC 8878: single segment,
    an 8-byte content size, no checksum), which any zstd decoder reads."""
    out = [b'\x28\xb5\x2f\xfd', bytes([0xE0]),
           len(data).to_bytes(8, 'little')]
    step = 128 * 1024
    starts = range(0, len(data), step) if data else [0]
    for at in starts:
        block = data[at:at + step]
        last = at + step >= len(data)
        out.append(((len(block) << 3) | int(last)).to_bytes(3, 'little'))
        out.append(block)
    return b''.join(out)


def _ocdbt_file(magic: int, body: bytes) -> bytes:
    """An OCDBT manifest or node: magic, length, format version 0,
    compression 0 (none), the body, CRC-32C."""
    head = magic.to_bytes(4, 'big')
    tail = varint(0) + varint(0) + body
    raw = head + (4 + 8 + len(tail) + 4).to_bytes(8, 'little') + tail
    return raw + crc32c(raw).to_bytes(4, 'little')


def _file_table(paths: list[tuple[str, int]]) -> bytes:
    """A data file table of ``(path, base path length)``, unprefixed."""
    out = [varint(len(paths))]
    out += [varint(0) for _ in paths[1:]]
    out += [varint(len(p.encode())) for p, _ in paths]
    out += [varint(b) for _, b in paths]
    out += [p.encode() for p, _ in paths]
    return b''.join(out)


def write_ocdbt(root: str, items: dict[str, bytes], max_inline: int = 1024):
    """``items`` as an OCDBT store, as one process of an Orbax save leaves
    it once merged: ``ocdbt.process_0/`` holds a data file of the values
    above ``max_inline`` bytes, one leaf node of every key and its own
    manifest; the root manifest refers to the same node through the base
    path ``ocdbt.process_0/``."""
    proc = 'ocdbt.process_0'
    os.makedirs(os.path.join(root, proc, 'd'))
    keys = sorted(items)
    data_name, node_name = 'd/' + 'a' * 32, 'd/' + 'b' * 32
    blob, offsets = [], {}
    at = 0
    for k in keys:
        if len(items[k]) > max_inline:
            offsets[k] = at
            blob.append(items[k])
            at += len(items[k])
    with open(os.path.join(root, proc, data_name), 'wb') as f:
        f.write(b''.join(blob))
    enc = [k.encode() for k in keys]
    prefix = [0] + [len(os.path.commonprefix([a, b]))
                    for a, b in zip(enc, enc[1:])]
    body = [bytes([0]), _file_table([(data_name, 0)]), varint(len(keys))]
    body += [varint(p) for p in prefix[1:]]
    body += [varint(len(e) - p) for e, p in zip(enc, prefix)]
    body += [e[p:] for e, p in zip(enc, prefix)]
    body += [varint(len(items[k])) for k in keys]
    body += [varint(int(k in offsets)) for k in keys]
    body += [varint(0) for k in keys if k in offsets]
    body += [varint(offsets[k]) for k in keys if k in offsets]
    body += [items[k] for k in keys if k not in offsets]
    node = _ocdbt_file(0x0CDB20DE, b''.join(body))
    with open(os.path.join(root, proc, node_name), 'wb') as f:
        f.write(node)
    stats = (varint(len(keys)) + varint(len(node)) + varint(at)
             + time.time_ns().to_bytes(8, 'little'))
    for where, path, base in ((os.path.join(root, proc), node_name, 0),
                              (root, f'{proc}/{node_name}', len(proc) + 1)):
        body = [os.urandom(16), varint(0), varint(max_inline),
                varint(100_000_000), bytes([4]), varint(0),
                _file_table([(path, base)]), varint(1), varint(1),
                varint(0), varint(0), varint(0), varint(len(node)), stats,
                varint(0)]
        with open(os.path.join(where, 'manifest.ocdbt'), 'wb') as f:
            f.write(_ocdbt_file(0x0CDB3A2A, b''.join(body)))


def write_orbax_dir(path: str, state: dict, shards: int = 4):
    """The JAX package's ``OrbaxCheckpointer.save_latest`` of ``state``
    (``{'params': {...}, 'epoch', 'model'}``) as a TPU v5e-4 run writes it
    (``textgcn_tpu/train/checkpoint.py:77-162``): the tree ``{'params':
    params, 'meta': {'epoch', 'model'}}``; ``_METADATA``; the string leaves
    in ``_strings.json``; every array a zarr v2 array in an OCDBT store,
    a table of rows divisible by ``shards`` in ``shards`` row chunks (one
    per device), the rest one chunk, each chunk a zstd frame of raw
    blocks.  The card's machine has neither orbax nor tensorstore."""
    os.makedirs(path)
    tree = {'params': state['params'],
            'meta': {k: v for k, v in state.items() if k != 'params'}}
    items, meta, strings = {}, {}, {}

    def leaf(keys, value):
        name = '.'.join(str(k) for k, _ in keys)
        entry = {'key_metadata': [{'key': str(k), 'key_type': t}
                                  for k, t in keys]}
        if isinstance(value, str):
            strings[name] = value
            entry['value_metadata'] = {'value_type': 'string',
                                       'skip_deserialize': False}
        else:
            arr = np.asarray(value)
            scalar = not isinstance(value, np.ndarray)
            chunks = list(arr.shape)
            if arr.ndim == 2 and arr.shape[0] % shards == 0:
                chunks[0] //= shards
            dtype = arr.dtype.str.replace('=', '<')
            items[f'{name}/.zarray'] = json.dumps({
                'chunks': chunks, 'compressor': {'id': 'zstd', 'level': 1},
                'dimension_separator': '.', 'dtype': dtype,
                'fill_value': None, 'filters': None, 'order': 'C',
                'shape': list(arr.shape), 'zarr_format': 2},
                sort_keys=True, separators=(',', ':')).encode()
            if arr.ndim == 0:
                items[f'{name}/0'] = zstd_raw_frame(arr.tobytes())
            else:
                step = chunks[0]
                for c in range(arr.shape[0] // step):
                    key = '.'.join([str(c)] + ['0'] * (arr.ndim - 1))
                    items[f'{name}/{key}'] = zstd_raw_frame(
                        arr[c * step:(c + 1) * step].tobytes())
            entry['value_metadata'] = {
                'value_type': 'scalar' if scalar else 'jax.Array',
                'skip_deserialize': False,
                **({} if scalar else {'write_shape': chunks})}
        meta[str(tuple(str(k) for k, _ in keys))] = entry

    def walk(keys, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(keys + [(k, 2)], v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(keys + [(i, 1)], v)
        else:
            leaf(keys, node)

    walk([], tree)
    write_ocdbt(path, items)
    with open(os.path.join(path, '_METADATA'), 'w') as f:
        json.dump({'tree_metadata': meta, 'use_ocdbt': True,
                   'use_zarr3': False,
                   'store_array_data_equal_to_fill_value': True,
                   'custom_metadata': None}, f)
    with open(os.path.join(path, '_strings.json'), 'w') as f:
        json.dump(strings, f)


JAX_FIXTURES = os.path.join(REPO, 'tests', 'fixtures', 'jax_runs')


def jax_runs_phase(root: str, data_dir: str, ck: str) -> dict:
    """Runs that the JAX package saves on a TPU, served on the card.

    S1: phase 7's pickle written again by ``write_orbax_dir`` as
    ``best.orbax`` of a run directory and served through ``cli.main
    --ckpt_backend orbax --load RUN``: the host read of the directory
    timed (``DistCheckpointer.load``: OCDBT, zarr and the port's zstd
    decoder) and bit-equal to the pickle's arrays; K1 launches exactly 12
    and no other kernel; the metrics and ``predictions.tsv`` equal phase
    7's pickle serve's bit for bit.

    The committed fixtures (``tests/fixtures/jax_runs``, written by the
    JAX package itself with ``tests/helpers/make_jax_runs.py``): the
    ``lgcn`` run (saved by 2 processes x 2 devices) from ``best.orbax``,
    the ``gat`` run from ``best.orbax`` and the ``gbdt`` run from its
    ``tree.pkl`` and ``best.pkl``, each served on the card and on the CPU
    on a copy of ``data/dummy``: the metrics within 1e-6 and the
    predictions up to ties; K1 (``lgcn``, ``gbdt``) or K3 (``gat``)
    launches exactly 12 (eval and predict); the ``lgcn`` run's ``best.pkl``
    twin serves on the card the ``best.orbax`` serve's metrics and
    ``predictions.tsv`` bit for bit."""
    import shutil
    from textgcn_tpu_torch.train.checkpoint import DistCheckpointer
    with open(ck, 'rb') as f:
        state = pickle.load(f)
    run = os.path.join(root, 'jax_orbax_run')
    t0 = time.perf_counter()
    write_orbax_dir(os.path.join(run, 'best.orbax'), state)
    out = {'write_s': time.perf_counter() - t0}
    from textgcn_tpu_torch import zstd
    t0 = time.perf_counter()
    zstd.load()             # built with the host compiler at first use
    out['zstd_build_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    read = DistCheckpointer().load(run)
    out['read_s'] = time.perf_counter() - t0
    nbytes = sum(a.nbytes for a in state['params'].values())
    out['table_mb'] = nbytes / 1e6
    out['read_mb_per_s'] = nbytes / 1e6 / out['read_s']
    for name, table in state['params'].items():
        check(read['params'][name].dtype == table.dtype
              and np.array_equal(read['params'][name], table),
              f'jax runs: the Orbax read of {name} differs from the pickle')
    check((read['epoch'], read['model']) == (state['epoch'], state['model']),
          f'jax runs: meta {read["epoch"], read["model"]}')
    log(f'jax runs: wrote S1 as Orbax (OCDBT + zarr v2, 4 row shards) in '
        f'{out["write_s"]:.3f} s; the zstd decoder built in '
        f'{out["zstd_build_s"]:.3f} s; DistCheckpointer.load read '
        f'{out["table_mb"]:.1f} MB of tables in {out["read_s"]:.3f} s '
        f'({out["read_mb_per_s"]:.1f} MB/s on the host), bit-equal')

    argv = ['--predict', '--emb_size', str(D), '--n_layers', str(LAYERS),
            '--batch_size', str(BATCH), '-k', *map(str, KS)]
    reset_counts()
    t0 = time.perf_counter()
    trainer, run_dir = serve(data_dir, 'smoke-orbax',
                             ['--ckpt_backend', 'orbax', '--load', run,
                              *argv], 'cuda')
    out['serve_s'] = time.perf_counter() - t0
    launches = counts()
    want = dict.fromkeys(_wrappers(), 0)
    want['spmm_dropout'] = 2 * LAYERS * 2
    check(launches == want, f'jax runs: the Orbax serve of S1 launched '
          f'{launches}, expected {want}')
    out['launches'] = launches['spmm_dropout']
    pickle_run = os.path.join(os.path.dirname(run_dir), 'smoke')
    with open(os.path.join(run_dir, 'predictions.tsv'), 'rb') as f:
        got = f.read()
    with open(os.path.join(pickle_run, 'predictions.tsv'), 'rb') as f:
        check(got == f.read(), 'jax runs: the Orbax serve\'s '
              'predictions.tsv differs from the pickle serve\'s')
    log(f'jax runs: --ckpt_backend orbax --load served S1 in '
        f'{out["serve_s"]:.3f} s, K1 launches {out["launches"]}, '
        f'predictions.tsv equal to the pickle serve\'s byte for byte; '
        f'metrics {json.dumps(trainer.last_metrics)}')
    out['metrics'] = trainer.last_metrics

    dummy = os.path.join(root, 'dummy_jax')
    shutil.copytree(os.path.join(REPO, 'data', 'dummy'), dummy)
    common = ['--predict', '--emb_size', '64', '--batch_size', '16', '-k',
              '3', '5']
    fixtures = (
        ('lgcn', ('--model', 'lgcn'), ['--ckpt_backend', 'orbax'],
         'spmm_dropout'),
        ('lgcn_pkl', ('--model', 'lgcn'), [], 'spmm_dropout'),
        ('gat', ('--model', 'gat', '--aggr', 'mean'),
         ['--ckpt_backend', 'orbax'], 'gat_fwd'),
        ('gbdt', ('--model', 'gbdt'), [], 'spmm_dropout'))
    old = os.environ.get('TEXTGCN_TPU_TEXT_ENCODER')
    os.environ['TEXTGCN_TPU_TEXT_ENCODER'] = 'stub'
    served = {}
    try:
        for name, flags, backend, kernel in fixtures:
            src = os.path.join(JAX_FIXTURES, name.split('_')[0])
            runs = {}
            for platform in ('cuda', 'cpu'):
                reset_counts()
                trainer, run_dir = serve(
                    dummy, f'jax-{name}-{platform}',
                    [*backend, '--load', src, *common], platform,
                    model=flags)
                if platform == 'cuda':
                    launches = counts()
                with open(os.path.join(run_dir, 'predictions.tsv'),
                          'rb') as f:
                    raw = f.read()
                runs[platform] = (trainer.last_metrics, read_predictions(
                    os.path.join(run_dir, 'predictions.tsv')), raw)
            want = dict.fromkeys(_wrappers(), 0)
            want[kernel] = 2 * LAYERS * 2
            check(launches == want, f'jax runs: fixture {name} launched '
                  f'{launches} on the card, expected {want}')
            (m_gpu, p_gpu, _), (m_cpu, p_cpu, _) = runs['cuda'], runs['cpu']
            for metric in m_cpu:
                check(np.allclose(m_gpu[metric], m_cpu[metric], atol=1e-6,
                                  rtol=0),
                      f'jax runs: fixture {name} {metric}: card '
                      f'{m_gpu[metric]} vs CPU {m_cpu[metric]}')
            check(same_up_to_ties([r[2] for r in p_gpu],
                                  [r[1] for r in p_gpu],
                                  [r[2] for r in p_cpu],
                                  [r[1] for r in p_cpu], 2e-4),
                  f'jax runs: fixture {name} predictions differ beyond ties')
            served[name] = runs['cuda']
            out[f'fixture_{name}'] = {'launches': launches[kernel],
                                      'metrics': m_gpu}
            log(f'jax runs: fixture {name} served on the card == CPU: '
                f'{m_gpu}; launches {launches[kernel]} {kernel}')
    finally:
        if old is None:
            os.environ.pop('TEXTGCN_TPU_TEXT_ENCODER', None)
        else:
            os.environ['TEXTGCN_TPU_TEXT_ENCODER'] = old
    (m_o, _, raw_o), (m_p, _, raw_p) = served['lgcn'], served['lgcn_pkl']
    check(raw_o == raw_p and all(np.array_equal(m_o[k], m_p[k])
                                 for k in m_o),
          'jax runs: the lgcn fixture\'s best.orbax and best.pkl serve '
          'differently on the card')
    log('jax runs: the lgcn fixture\'s best.orbax (2 processes x 2 '
        'devices) serves its best.pkl twin\'s metrics and predictions.tsv '
        'bit for bit')
    return out


def adv_target_phase(trainer, card: str) -> dict:
    """Phase 9i (``mining_phase``) under ``TEXTGCN_TPU_ADV_TOPK=0.95``,
    after the hard negatives of one draw are mined unset and under the
    target: bit-equal."""
    from textgcn_tpu_torch.ops.retrieval import ADV_TOPK_ENV
    model = trainer.model
    users, keep, _ = adv_draws(model, 9)
    old = os.environ.pop(ADV_TOPK_ENV, None)
    try:
        with torch.no_grad():
            ur, ir = model.representation()
            unset = model.hard_negatives(ur, ir, users, keep)
            os.environ[ADV_TOPK_ENV] = str(APPROX)
            target = model.hard_negatives(ur, ir, users, keep)
        same = all(torch.equal(a, b) for a, b in zip(unset, target))
        log(f'adv recall target: {ADV_TOPK_ENV}={APPROX} mines the unset '
            f'run\'s hard negatives bit for bit: {same} '
            f'({int(unset[1].sum())} valid of {unset[1].numel()})')
        check(same, f'{ADV_TOPK_ENV}={APPROX} changed the hard negatives')
        return mining_phase(trainer, card)
    finally:
        if old is None:
            os.environ.pop(ADV_TOPK_ENV, None)
        else:
            os.environ[ADV_TOPK_ENV] = old


# all-MiniLM-L6-v2's published shape (its config.json)
MINILM = {'model_type': 'bert', 'vocab_size': 30522, 'hidden_size': 384,
          'num_hidden_layers': 6, 'num_attention_heads': 12,
          'intermediate_size': 1536, 'max_position_embeddings': 512,
          'hidden_act': 'gelu', 'layer_norm_eps': 1e-12,
          'type_vocab_size': 2}
ENCODE_SENTENCES = 512
ENCODE_TOL = 1e-4


def write_safetensors(path: str, tensors: dict[str, np.ndarray]):
    """float32 ``tensors`` in the ``.safetensors`` layout: the header's
    length (8 bytes, little-endian), the JSON header, the data."""
    header, offset = {}, 0
    for name, a in tensors.items():
        header[name] = {'dtype': 'F32', 'shape': list(a.shape),
                        'data_offsets': [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header).encode()
    raw += b' ' * (-len(raw) % 8)
    with open(path, 'wb') as f:
        f.write(len(raw).to_bytes(8, 'little'))
        f.write(raw)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a, np.float32).tobytes())


def random_weights(config: dict, seed: int) -> dict[str, np.ndarray]:
    """The ``state_dict`` of ``BertEncoder(config)`` (built without
    storage) as N(0, 0.02) numpy arrays from ``seed``, LayerNorms 1 and 0,
    biases 0."""
    from textgcn_tpu_torch.data.encoder_models import BertEncoder
    with torch.device('meta'):
        model = BertEncoder(config)
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, t in model.state_dict().items():
        if 'LayerNorm' in name and name.endswith('weight'):
            t = torch.ones(t.shape)
        elif 'LayerNorm' in name or name.endswith('bias'):
            t = torch.zeros(t.shape)
        else:
            t = 0.02 * torch.randn(t.shape, generator=gen)
        state[name] = t.numpy()
    return state


def write_minilm(root: str, seed: int = 0) -> str:
    """A BERT directory of ``MINILM``'s shape with N(0, 0.02) weights from
    ``seed`` (LayerNorms 1 and 0) in ``model.safetensors``, and a
    lower-casing ``vocab.txt`` that holds the synthetic text's words,
    digits and letters (and their ``##`` pieces), filled with unused
    entries to the vocabulary's size."""
    out = os.path.join(root, 'minilm-shaped')
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'config.json'), 'w') as f:
        json.dump(MINILM, f)
    with open(os.path.join(out, 'tokenizer_config.json'), 'w') as f:
        json.dump({'do_lower_case': True, 'model_max_length': 512}, f)
    chars = list('abcdefghijklmnopqrstuvwxyz0123456789,:.')
    vocab = ['[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]']
    vocab += ('title of a longer description its detail review by opinion '
              'category style item for enthusiasts product series').split()
    vocab += [str(i) for i in range(100)] + chars + ['##' + c for c in chars]
    vocab += [f'[unused{i}]' for i in range(MINILM['vocab_size']
                                            - len(vocab))]
    with open(os.path.join(out, 'vocab.txt'), 'w') as f:
        f.write('\n'.join(vocab) + '\n')
    write_safetensors(os.path.join(out, 'model.safetensors'),
                      random_weights(MINILM, seed))
    return out


def _msgpack_head(n: int, fix: int | None, limit: int, codes) -> bytes:
    """The type byte of a msgpack value of size (or value) ``n``: ``fix |
    n`` up to ``limit``, else the first of ``codes`` ((type, bytes of the
    size)) wide enough, with the size big-endian."""
    if fix is not None and n <= limit:
        return bytes([fix | n])
    for code, width in codes:
        if n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, 'big')
    raise ValueError(f'msgpack: {n} does not fit')


def _pack(obj, out: list):
    if isinstance(obj, dict):
        out.append(_msgpack_head(len(obj), 0x80, 15, ((0xde, 2), (0xdf, 4))))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_msgpack_head(len(obj), 0x90, 15, ((0xdc, 2), (0xdd, 4))))
        for value in obj:
            _pack(value, out)
    elif isinstance(obj, str):
        raw = obj.encode()
        out += [_msgpack_head(len(raw), 0xa0, 31,
                              ((0xd9, 1), (0xda, 2), (0xdb, 4))), raw]
    elif isinstance(obj, bytes):
        out += [_msgpack_head(len(obj), None, 0,
                              ((0xc4, 1), (0xc5, 2), (0xc6, 4))), obj]
    elif isinstance(obj, int) and 0 <= obj < 1 << 64:
        out.append(_msgpack_head(obj, 0, 127, ((0xcc, 1), (0xcd, 2),
                                               (0xce, 4), (0xcf, 8))))
    elif isinstance(obj, np.ndarray) and obj.nbytes <= 2 ** 30:
        # Flax's ext 1; an array over flax.serialization.MAX_CHUNK_SIZE
        # would be chunked, which this writer does not do
        payload = pack_msgpack((list(obj.shape), obj.dtype.name,
                                np.ascontiguousarray(obj).tobytes()))
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        head = (bytes([fixext[len(payload)]]) if len(payload) in fixext
                else _msgpack_head(len(payload), None, 0,
                                   ((0xc7, 1), (0xc8, 2), (0xc9, 4))))
        out += [head, b'\x01', payload]
    else:
        raise TypeError(f'msgpack: cannot pack {type(obj).__name__}')


def pack_msgpack(obj) -> bytes:
    """``obj`` in msgpack as ``flax.serialization.msgpack_serialize``
    writes a parameter tree: dicts with ``str`` keys, lists and tuples,
    ``str``, ``bytes``, non-negative ``int`` and numpy arrays (Flax's ext
    1: ``(shape, dtype name, C-order bytes)``).  The card's machine has
    neither ``flax`` nor ``msgpack``."""
    out: list[bytes] = []
    _pack(obj, out)
    return b''.join(out)


def flax_tree(state: dict[str, np.ndarray]) -> dict:
    """A BERT ``state_dict`` (``random_weights``) as ``FlaxBertModel``'s
    parameter tree: Dense kernels ``(in, out)``, LayerNorm ``scale`` and
    ``bias``, Embed ``embedding``."""
    tree: dict = {}
    for name, a in state.items():
        *path, parent, leaf = name.split('.')
        if leaf == 'weight':
            if parent == 'LayerNorm':
                leaf = 'scale'
            elif parent.endswith('embeddings'):
                leaf = 'embedding'
            else:
                leaf, a = 'kernel', a.T
        node = tree
        for key in (*path, parent):
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(a, np.float32)
    return tree


FLAX_SHARDS = 3


def write_flax_minilm(root: str, where: str, state: dict,
                      shards: int = 1) -> str:
    """``write_minilm``'s directory with Flax weights only: ``state``
    (``random_weights`` of ``write_minilm``'s seed) as ``flax_tree`` in
    ``flax_model.msgpack``, or in ``shards`` files of ``/``-joined names
    with ``flax_model.msgpack.index.json``, as ``FlaxPreTrainedModel
    .save_pretrained`` shards; its vocabulary, ``config.json`` and
    ``tokenizer_config.json``; and a ``modules.json`` with CLS pooling and
    ``max_seq_length`` 16, which ``auto`` must not read on such a
    directory.  The directory is ``root/where/minilm-shaped``: named as
    ``write_minilm``'s, so the LTR loader names its caches the same."""
    import shutil

    from textgcn_tpu_torch.data.flax_msgpack import flatten, unflatten
    src = os.path.join(root, 'minilm-shaped')
    out = os.path.join(root, where, 'minilm-shaped')
    os.makedirs(os.path.join(out, '1_Pooling'), exist_ok=True)
    for name in ('config.json', 'tokenizer_config.json', 'vocab.txt'):
        shutil.copy(os.path.join(src, name), out)
    for path, conf in (
            ('modules.json', [
                {'idx': 0, 'name': '0', 'path': '',
                 'type': 'sentence_transformers.models.Transformer'},
                {'idx': 1, 'name': '1', 'path': '1_Pooling',
                 'type': 'sentence_transformers.models.Pooling'}]),
            ('sentence_bert_config.json', {'max_seq_length': 16}),
            ('1_Pooling/config.json', {
                'word_embedding_dimension': MINILM['hidden_size'],
                'pooling_mode_cls_token': True,
                'pooling_mode_mean_tokens': False})):
        with open(os.path.join(out, path), 'w') as f:
            json.dump(conf, f)
    tree = flax_tree(state)
    if shards == 1:
        with open(os.path.join(out, 'flax_model.msgpack'), 'wb') as f:
            f.write(pack_msgpack(tree))
        return out
    flat = flatten(tree)
    names = list(flat)
    per = -(-len(names) // shards)
    weight_map = {}
    for k in range(shards):
        part = names[k * per:(k + 1) * per]
        shard = f'flax_model-{k + 1:05d}-of-{shards:05d}.msgpack'
        with open(os.path.join(out, shard), 'wb') as f:
            f.write(pack_msgpack(unflatten({n: flat[n] for n in part})))
        weight_map.update(dict.fromkeys(part, shard))
    with open(os.path.join(out, 'flax_model.msgpack.index.json'), 'w') as f:
        json.dump({'metadata': {'total_size': sum(
            a.nbytes for a in flat.values())}, 'weight_map': weight_map}, f)
    return out


def health_phase(log_path: str, dev) -> dict:
    """The health check: a probe of the card, and the probe line of a CLI
    run's ``log.log``."""
    from textgcn_tpu_torch.cli import device_healthcheck
    rtt = device_healthcheck(device=dev)
    with open(log_path) as f:
        lines = [s for s in f.read().splitlines()
                 if 'Device backend ready (' in s]
    log(f'health check: a probe of the card took {rtt:.4f} s; the CLI '
        f'run logged {lines}')
    check(rtt < 60 and len(lines) == 1, f'health check: {rtt} s, {lines}')
    return {'probe_s': rtt, 'line': lines[0]}


def encoder_phase(root: str, cut_dir: str, base_ck: str, card: str,
                  dev) -> dict:
    """The port's BERT at all-MiniLM-L6-v2's shape (``write_minilm``):
    ``ENCODE_SENTENCES`` of the cut's texts encoded on the card against
    the CPU (``ENCODE_TOL``); then ``ltr_linear --load_base <the boosted
    phase's base> --freeze`` for 1 epoch on a copy of the boosted phase's
    4,096-user cut without its embedding caches, under
    ``TEXTGCN_TPU_TEXT_ENCODER=flax``: it encodes the item descriptions
    and the reviews on the card and writes both caches (K1 launches
    exactly ``6 + steps x 6 + 6``, forward only); a second run reads the
    caches and encodes nothing (the same launches).  The loader's memo is
    bypassed for both runs.  The first run's sentences go through a fresh
    tokenizer once more, alone, for the host's share of the rate."""
    import shutil

    from textgcn_tpu_torch.data import encoder, text
    model_dir = write_minilm(root)
    enc_dir = os.path.join(root, 's1_enc')
    os.makedirs(enc_dir, exist_ok=True)
    for name in ('train.tsv', 'test.tsv', 'meta_synced.tsv',
                 'reviews_text.tsv'):
        shutil.copy(os.path.join(cut_dir, name), enc_dir)
    with open(os.path.join(enc_dir, 'reviews_text.tsv')) as f:
        next(f)
        sample = [line.split('\t')[2]
                  for line, _ in zip(f, range(ENCODE_SENTENCES))]
    t0 = time.perf_counter()
    on_card = encoder.encode(sample, model_dir, 64, dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = encoder.encode(sample, model_dir, 64, 'cpu')
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(on_card - on_cpu).max())
    out = {'card_vs_cpu_max_abs_err': err, 'sentences': len(sample),
           'card_s': card_s, 'cpu_s': cpu_s}
    log(f'encoder: {len(sample)} sentences at all-MiniLM-L6-v2\'s shape on '
        f'the card ({card_s:.3f} s) vs the CPU ({cpu_s:.3f} s): max abs '
        f'err {err:.3e}')
    check(on_card.shape == (len(sample), MINILM['hidden_size'])
          and err <= ENCODE_TOL, f'encoder: card vs CPU {err}')

    calls = []
    real_encode, loader = encoder.encode, text.load_ltr_data
    old_env = os.environ.get(text.ENCODER_ENV)

    def counted(sentences, model_dir, batch_size, *args, **kwargs):
        t = time.perf_counter()
        vectors = real_encode(sentences, model_dir, batch_size, *args,
                              **kwargs)
        calls.append((len(sentences), time.perf_counter() - t, sentences,
                      batch_size))
        return vectors

    encoder.encode = counted
    text.load_ltr_data = getattr(loader, 'real', loader)
    os.environ[text.ENCODER_ENV] = 'flax'
    argv = ['--model', 'ltr_linear', '--load_base', base_ck, '--freeze',
            '--epochs', '1', '--evaluate_every', '1', '--bert_model',
            model_dir, '--emb_size', str(D), '--n_layers', str(LAYERS),
            '--batch_size', str(BATCH), '-k', *map(str, KS)]
    try:
        for run in ('encode', 'cached'):
            n_calls = len(calls)
            reset_counts()
            t0 = time.perf_counter()
            trainer, run_dir = cli_run(
                enc_dir, argv + ['--uid', f'enc-{run}']
                + (['--quiet'] if run == 'cached' else []), 'cuda')
            seconds = time.perf_counter() - t0
            launches = counts()
            steps = trainer.model.num_batches(BATCH)
            want = dict.fromkeys(_wrappers(), 0)
            want['spmm_dropout'] = 2 * LAYERS * (steps + 2)
            check(launches == want, f'encoder {run}: launches {launches}, '
                  f'expected {want} (base eval + steps + eval, forward only)')
            out[f'{run}_launches'] = launches['spmm_dropout']
            out[f'{run}_cli_s'] = seconds
            new = calls[n_calls:]
            if run == 'encode':
                n = sum(c[0] for c in new)
                s = sum(c[1] for c in new)
                out.update(encoded=n, encode_s=s, sentences_per_s=n / s,
                           log=os.path.join(run_dir, 'log.log'))
                log(f'encoder: ltr_linear on the {trainer.data.n_users}-user '
                    f'cut with no caches encoded {n} sentences in '
                    f'{len(new)} calls, {s:.3f} s ({n / s:.1f} sentences/s '
                    f'on {card}); cli.main took {seconds:.3f} s')
                check(len(new) == 2, f'encoder: {len(new)} encode calls')
                # the host's share: the same sentences through a fresh
                # tokenizer (empty word cache) in the same batches
                tok = encoder.BertTokenizer.from_dir(model_dir)
                length = min(tok.max_length(),
                             MINILM['max_position_embeddings'])
                t0 = time.perf_counter()
                for _, _, sentences, batch in new:
                    for start in range(0, len(sentences), batch):
                        tok(sentences[start:start + batch], length)
                tok_s = time.perf_counter() - t0
                out.update(tokenizer_s=tok_s, tokenizer_share=tok_s / s)
                log(f'encoder: the tokenizer alone took {tok_s:.3f} s of '
                    f'the {s:.3f} s ({tok_s / s:.3f}; '
                    f'{n / tok_s:.1f} sentences/s on the host)')
            else:
                log(f'encoder: the second run read the caches ({len(new)} '
                    f'encode calls); cli.main took {seconds:.3f} s')
                check(not new, 'encoder: the second run encoded again')
    finally:
        encoder.encode, text.load_ltr_data = real_encode, loader
        if old_env is None:
            os.environ.pop(text.ENCODER_ENV, None)
        else:
            os.environ[text.ENCODER_ENV] = old_env
    caches = sorted(os.listdir(os.path.join(enc_dir, 'embeddings')))
    for name in caches:
        if name.endswith('.npy'):
            v = np.load(os.path.join(enc_dir, 'embeddings', name))
            check(v.shape[1] == MINILM['hidden_size']
                  and np.allclose(np.linalg.norm(v, axis=1), 1, atol=1e-4),
                  f'encoder cache {name}: {v.shape}')
    check(len(caches) == 4, f'encoder: caches {caches}')
    log(f'encoder: caches {caches}')
    return out


FLAX_SENTENCES = 64


def flax_dir_phase(root: str, cut_dir: str, base_ck: str, card: str,
                   dev) -> dict:
    """A Flax-only encoder directory (``write_flax_minilm``: the weights of
    ``encoder_phase``'s ``write_minilm`` directory, and a copy sharded in
    ``FLAX_SHARDS`` files): ``read_state`` of each gives the safetensors
    directory's tensors bit for bit (the msgpack read timed);
    ``FLAX_SENTENCES`` of the cut's texts encode under ``auto`` on the card
    against the CPU (``ENCODE_TOL``); then ``ltr_linear --load_base
    --freeze`` for 1 epoch on a fresh copy of the cut with
    ``TEXTGCN_TPU_TEXT_ENCODER`` unset (``auto``) and ``--bert_model`` the
    Flax-only directory: it encodes by the Flax recipe on the card (the
    directory's ``modules.json`` unread, one warning a call), K1 launches
    exactly ``6 + steps x 6 + 6``, and the two caches it writes equal
    ``encoder_phase``'s (``flax`` over ``model.safetensors``) byte for
    byte."""
    import shutil

    from textgcn_tpu_torch.data import encoder, text
    state = random_weights(MINILM, 0)
    t0 = time.perf_counter()
    flax_dir = write_flax_minilm(root, 'flax_only', state)
    sharded = write_flax_minilm(root, 'flax_sharded', state, FLAX_SHARDS)
    write_s = time.perf_counter() - t0
    del state
    mb = os.path.getsize(os.path.join(flax_dir, 'flax_model.msgpack')) / 1e6
    t0 = time.perf_counter()
    got = encoder.read_state(flax_dir)
    read_s = time.perf_counter() - t0
    for name, path in (('sharded', sharded),
                       ('safetensors', os.path.join(root, 'minilm-shaped'))):
        other = encoder.read_state(path)
        check(sorted(other) == sorted(got)
              and all(torch.equal(got[k], other[k]) for k in got),
              f'flax dir: read_state of the Flax-only directory and of the '
              f'{name} one differ')
    del got, other
    shards = [f for f in os.listdir(sharded) if f.endswith('.msgpack')]
    check(len(shards) == FLAX_SHARDS and encoder.flax_only(flax_dir)
          and encoder.flax_only(sharded),
          f'flax dir: {len(shards)} shards; flax_only '
          f'{encoder.flax_only(flax_dir)}, {encoder.flax_only(sharded)}')
    out = {'msgpack_mb': mb, 'read_s': read_s, 'read_mb_per_s': mb / read_s,
           'write_s': write_s}
    log(f'flax dir: read_state of flax_model.msgpack ({mb:.1f} MB) '
        f'{read_s:.3f} s ({mb / read_s:.1f} MB/s on the host), bit-equal '
        f'to the {FLAX_SHARDS} shards\' and to model.safetensors\'; both '
        f'directories written in {write_s:.3f} s')

    with open(os.path.join(cut_dir, 'reviews_text.tsv')) as f:
        next(f)
        sample = [line.split('\t')[2]
                  for line, _ in zip(f, range(FLAX_SENTENCES))]
    on_card = encoder.encode(sample, flax_dir, 64, dev, 'auto')
    on_cpu = encoder.encode(sample, flax_dir, 64, 'cpu', 'auto')
    err = float(np.abs(on_card - on_cpu).max())
    out['card_vs_cpu_max_abs_err'] = err
    log(f'flax dir: {len(sample)} texts under auto on the card against the '
        f'CPU: max abs err {err:.3e}')
    check(on_card.shape == (len(sample), MINILM['hidden_size'])
          and err <= ENCODE_TOL, f'flax dir: card vs CPU {err}')

    data_dir = os.path.join(root, 's1_flax')
    os.makedirs(data_dir, exist_ok=True)
    for name in ('train.tsv', 'test.tsv', 'meta_synced.tsv',
                 'reviews_text.tsv'):
        shutil.copy(os.path.join(cut_dir, name), data_dir)
    calls = []
    real_encode, loader = encoder.encode, text.load_ltr_data

    def counted(sentences, *args, **kwargs):
        t = time.perf_counter()
        vectors = real_encode(sentences, *args, **kwargs)
        calls.append((len(sentences), time.perf_counter() - t))
        return vectors

    encoder.encode = counted
    text.load_ltr_data = getattr(loader, 'real', loader)
    old_env = os.environ.pop(text.ENCODER_ENV, None)
    argv = ['--model', 'ltr_linear', '--load_base', base_ck, '--freeze',
            '--epochs', '1', '--evaluate_every', '1', '--bert_model',
            flax_dir, '--emb_size', str(D), '--n_layers', str(LAYERS),
            '--batch_size', str(BATCH), '-k', *map(str, KS),
            '--uid', 'enc-flax-only']
    try:
        reset_counts()
        t0 = time.perf_counter()
        trainer, run_dir = cli_run(data_dir, argv, 'cuda')
        cli_s = time.perf_counter() - t0
        launches = counts()
    finally:
        encoder.encode, text.load_ltr_data = real_encode, loader
        if old_env is not None:
            os.environ[text.ENCODER_ENV] = old_env
    steps = trainer.model.num_batches(BATCH)
    want = dict.fromkeys(_wrappers(), 0)
    want['spmm_dropout'] = 2 * LAYERS * (steps + 2)
    check(launches == want, f'flax dir: launches {launches}, expected '
          f'{want} (base eval + steps + eval, forward only)')
    n = sum(c[0] for c in calls)
    s = sum(c[1] for c in calls)
    with open(os.path.join(run_dir, 'log.log')) as f:
        warned = f.read().count('auto encodes by the Flax recipe')
    check(len(calls) == 2 and warned == 2,
          f'flax dir: {len(calls)} encode calls, {warned} warnings')
    ref = os.path.join(root, 's1_enc', 'embeddings')
    new = os.path.join(data_dir, 'embeddings')
    caches = sorted(os.listdir(new))
    check(len(caches) == 4 and caches == sorted(os.listdir(ref))
          and all(same_files(os.path.join(new, c), os.path.join(ref, c))
                  for c in caches),
          f'flax dir: caches {caches} differ from the flax run\'s '
          f'{sorted(os.listdir(ref))}')
    out.update(launches=launches['spmm_dropout'], encoded=n, encode_s=s,
               sentences_per_s=n / s, cli_s=cli_s)
    log(f'flax dir: ltr_linear under auto on the {trainer.data.n_users}-user '
        f'cut encoded {n} sentences through the Flax-only directory in '
        f'{s:.3f} s ({n / s:.1f} sentences/s on {card}); cli.main took '
        f'{cli_s:.3f} s; K1 {launches["spmm_dropout"]} launches; caches '
        f'{caches} byte-equal to the flax run\'s from model.safetensors')
    return out


# the published shapes of six sentence encoders (their config.json,
# modules.json, 1_Pooling/config.json, 2_Dense/config.json and
# sentence_bert_config.json); the last three tokenize from tokenizer.json
ST_MODELS = {
    'all-mpnet-base-v2': {
        'config': {'model_type': 'mpnet', 'vocab_size': 30527,
                   'hidden_size': 768, 'num_hidden_layers': 12,
                   'num_attention_heads': 12, 'intermediate_size': 3072,
                   'max_position_embeddings': 514,
                   'relative_attention_num_buckets': 32,
                   'hidden_act': 'gelu', 'layer_norm_eps': 1e-5,
                   'pad_token_id': 1, 'bos_token_id': 0, 'eos_token_id': 2},
        'normalize': True, 'max_seq_length': 384},
    'all-distilroberta-v1': {
        'config': {'model_type': 'roberta', 'vocab_size': 50265,
                   'hidden_size': 768, 'num_hidden_layers': 6,
                   'num_attention_heads': 12, 'intermediate_size': 3072,
                   'max_position_embeddings': 514, 'type_vocab_size': 1,
                   'hidden_act': 'gelu', 'layer_norm_eps': 1e-5,
                   'pad_token_id': 1, 'bos_token_id': 0, 'eos_token_id': 2},
        'normalize': True, 'max_seq_length': 512},
    'msmarco-distilbert-base-v4': {
        'config': {'model_type': 'distilbert', 'vocab_size': 30522,
                   'dim': 768, 'n_layers': 6, 'n_heads': 12,
                   'hidden_dim': 3072, 'max_position_embeddings': 512,
                   'activation': 'gelu', 'sinusoidal_pos_embds': False,
                   'pad_token_id': 0},
        'normalize': False, 'max_seq_length': 512},
    'paraphrase-multilingual-MiniLM-L12-v2': {
        'config': {'model_type': 'bert', 'vocab_size': 250037,
                   'hidden_size': 384, 'num_hidden_layers': 12,
                   'num_attention_heads': 12, 'intermediate_size': 1536,
                   'max_position_embeddings': 512, 'type_vocab_size': 2,
                   'hidden_act': 'gelu', 'layer_norm_eps': 1e-12,
                   'pad_token_id': 0},
        'tokenizer': 'unigram', 'normalize': False, 'max_seq_length': 128},
    'paraphrase-multilingual-mpnet-base-v2': {
        'config': {'model_type': 'xlm-roberta', 'vocab_size': 250002,
                   'hidden_size': 768, 'num_hidden_layers': 12,
                   'num_attention_heads': 12, 'intermediate_size': 3072,
                   'max_position_embeddings': 514, 'type_vocab_size': 1,
                   'hidden_act': 'gelu', 'layer_norm_eps': 1e-5,
                   'pad_token_id': 1, 'bos_token_id': 0, 'eos_token_id': 2},
        'tokenizer': 'unigram', 'normalize': False, 'max_seq_length': 128},
    'distiluse-base-multilingual-cased-v2': {
        'config': {'model_type': 'distilbert', 'vocab_size': 119547,
                   'dim': 768, 'n_layers': 6, 'n_heads': 12,
                   'hidden_dim': 3072, 'max_position_embeddings': 512,
                   'activation': 'gelu', 'sinusoidal_pos_embds': False,
                   'pad_token_id': 0},
        'tokenizer': 'wordpiece', 'dense': 512, 'normalize': False,
        'max_seq_length': 128},
}
# card against CPU (the multilingual models' with MULTILINGUAL's lines
# among them), and sentences/s on the card
FAMILY_SENTENCES = 64
RATE_SENTENCES = 2048
CUT_WORDS = ('title of a longer description its detail review by opinion '
             'sep').split()
# XLM-RoBERTa's SentencePiece vocabulary: 250,002 pieces, <mask> the last
UNIGRAM_PIECES = 250_002
MULTILINGUAL = [
    "Émile's café, naïve façade — très bien",
    'Ελληνικά κείμενα ΟΔΟΣ Σοφία', 'русский текст пример отзыва',
    '한국어 리뷰 텍스트', 'हिन्दी पाठ समीक्षा', '中文文本示例评论',
    'ｆｕｌｌ ｗｉｄｔｈ ＡＢＣ １２３  two  spaces', 'ﬁne ﬂow ① ½ ™']


def _wordpiece_vocab(specials: list[str], size: int,
                     cased: bool = False) -> list[str]:
    chars = list('abcdefghijklmnopqrstuvwxyz0123456789,:.[]_')
    if cased:
        chars += list('ABCDEFGHIJKLMNOPQRSTUVWXYZ')
    vocab = specials + CUT_WORDS + [str(i) for i in range(100)] + chars \
        + ['##' + c for c in chars]
    return vocab + [f'[unused{i}]' for i in range(size - len(vocab))]


def unigram_tokenizer_json(corpus: list[str], size: int) -> dict:
    """XLM-RoBERTa's ``tokenizer.json`` layout (Precompiled, then Replace
    of ``" {2,}"``, Metaspace, ``<s> $A </s>``) over a Unigram vocabulary
    of ``size`` pieces: the four specials, the corpus's words after ``▁``
    (-6), ``▁``, its characters and two-digit numbers (-9), filler pieces
    (-20, behind U+E000) and ``<mask>``.  The charsmap holds a few hundred
    NFKC mappings (``tests/helpers/torch_charsmap.py``)."""
    sys.path.insert(0, os.path.join(REPO, 'tests', 'helpers'))
    from torch_charsmap import charsmap_b64, nfkc_mappings
    words, chars = set(), set()
    for text in corpus:
        for w in text.split():
            words.add('▁' + w)
            chars.update(w)
    pieces = [['<s>', 0.0], ['<pad>', 0.0], ['</s>', 0.0], ['<unk>', 0.0]]
    pieces += [[w, -6.0] for w in sorted(words)]
    pieces += [[p, -9.0] for p in ['▁', *sorted(chars),
                                   *(f'{i:02d}' for i in range(100))]]
    # fillers behind a private-use character that no text holds
    pieces += [[f'\ue000{k:x}', -20.0]
               for k in range(size - 1 - len(pieces))]
    pieces.append(['<mask>', 0.0])
    added = [{'id': i, 'content': t, 'single_word': False, 'lstrip': False,
              'rstrip': False, 'normalized': False, 'special': True}
             for i, t in enumerate(('<s>', '<pad>', '</s>', '<unk>'))]
    added.append({'id': size - 1, 'content': '<mask>', 'single_word': False,
                  'lstrip': True, 'rstrip': False, 'normalized': False,
                  'special': True})
    return {
        'version': '1.0', 'truncation': None, 'padding': None,
        'added_tokens': added,
        'normalizer': {'type': 'Sequence', 'normalizers': [
            {'type': 'Precompiled',
             'precompiled_charsmap': charsmap_b64(nfkc_mappings())},
            {'type': 'Replace', 'pattern': {'Regex': ' {2,}'},
             'content': ' '}]},
        'pre_tokenizer': {'type': 'Metaspace', 'replacement': '▁',
                          'prepend_scheme': 'always', 'split': True},
        'post_processor': {
            'type': 'TemplateProcessing',
            'single': [{'SpecialToken': {'id': '<s>', 'type_id': 0}},
                       {'Sequence': {'id': 'A', 'type_id': 0}},
                       {'SpecialToken': {'id': '</s>', 'type_id': 0}}],
            'pair': [], 'special_tokens': {
                '<s>': {'id': '<s>', 'ids': [0], 'tokens': ['<s>']},
                '</s>': {'id': '</s>', 'ids': [2], 'tokens': ['</s>']}}},
        'decoder': None,
        'model': {'type': 'Unigram', 'unk_id': 3, 'vocab': pieces,
                  'byte_fallback': False}}


def wordpiece_tokenizer_json(size: int) -> dict:
    """A cased multilingual BERT's ``tokenizer.json`` layout
    (``BertNormalizer`` without lower-casing, ``BertPreTokenizer``,
    ``[CLS] $A [SEP]``) over ``_wordpiece_vocab``."""
    specials = ['[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]']
    vocab = _wordpiece_vocab(specials, size, cased=True)
    return {
        'version': '1.0', 'truncation': None, 'padding': None,
        'added_tokens': [{'id': i, 'content': t, 'single_word': False,
                          'lstrip': False, 'rstrip': False,
                          'normalized': False, 'special': True}
                         for i, t in enumerate(specials)],
        'normalizer': {'type': 'BertNormalizer', 'clean_text': True,
                       'handle_chinese_chars': True, 'strip_accents': None,
                       'lowercase': False},
        'pre_tokenizer': {'type': 'BertPreTokenizer'},
        'post_processor': {
            'type': 'TemplateProcessing',
            'single': [{'SpecialToken': {'id': '[CLS]', 'type_id': 0}},
                       {'Sequence': {'id': 'A', 'type_id': 0}},
                       {'SpecialToken': {'id': '[SEP]', 'type_id': 0}}],
            'pair': [], 'special_tokens': {
                '[CLS]': {'id': '[CLS]', 'ids': [2], 'tokens': ['[CLS]']},
                '[SEP]': {'id': '[SEP]', 'ids': [3], 'tokens': ['[SEP]']}}},
        'decoder': None,
        'model': {'type': 'WordPiece', 'unk_token': '[UNK]',
                  'continuing_subword_prefix': '##',
                  'max_input_chars_per_word': 100,
                  'vocab': {t: i for i, t in enumerate(vocab)}}}


def write_st_model(root: str, name: str, corpus: list[str],
                   seed: int = 0) -> str:
    """A Sentence Transformers directory of ``ST_MODELS[name]``'s published
    shape: ``config.json``, the tokenizer files (a WordPiece ``vocab.txt``,
    a BPE ``vocab.json``/``merges.txt``, or a Unigram or WordPiece
    ``tokenizer.json`` that cover the cut's text), N(0, 0.02) weights from
    ``seed`` (LayerNorms 1 and 0, biases 0) in ``model.safetensors``,
    ``modules.json`` (Transformer, mean Pooling, the model's Dense and
    Normalize) and ``sentence_bert_config.json``."""
    spec = ST_MODELS[name]
    config = spec['config']
    out = os.path.join(root, name)
    os.makedirs(os.path.join(out, '1_Pooling'), exist_ok=True)
    with open(os.path.join(out, 'config.json'), 'w') as f:
        json.dump(config, f)
    kind = config['model_type']
    tokenizer = spec.get('tokenizer')
    if tokenizer is not None:
        if tokenizer == 'unigram':
            tok = unigram_tokenizer_json(corpus + MULTILINGUAL,
                                         UNIGRAM_PIECES)
            tok_conf = {'tokenizer_class': 'XLMRobertaTokenizer',
                        'model_max_length': 512, 'bos_token': '<s>',
                        'eos_token': '</s>', 'unk_token': '<unk>',
                        'sep_token': '</s>', 'pad_token': '<pad>',
                        'cls_token': '<s>', 'mask_token': '<mask>'}
        else:
            tok = wordpiece_tokenizer_json(config['vocab_size'])
            tok_conf = {'tokenizer_class': 'BertTokenizer',
                        'do_lower_case': False, 'model_max_length': 512,
                        'pad_token': '[PAD]'}
        with open(os.path.join(out, 'tokenizer.json'), 'w',
                  encoding='utf-8') as f:
            json.dump(tok, f, ensure_ascii=False)
    elif kind == 'roberta':
        from textgcn_tpu_torch.data import bpe
        vocab, merges = bpe.learn(
            [w for text in corpus for w in bpe.pretokenize(text)], 400,
            config['vocab_size'])
        with open(os.path.join(out, 'vocab.json'), 'w') as f:
            json.dump(vocab, f)
        with open(os.path.join(out, 'merges.txt'), 'w') as f:
            f.write('#version: 0.2\n'
                    + ''.join(f'{a} {b}\n' for a, b in merges))
        tok_conf = {'add_prefix_space': False, 'model_max_length': 512}
    else:
        specials = (['<s>', '<pad>', '</s>', '<unk>', '[UNK]', '<mask>']
                    if kind == 'mpnet'
                    else ['[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]'])
        with open(os.path.join(out, 'vocab.txt'), 'w') as f:
            f.write('\n'.join(_wordpiece_vocab(specials,
                                               config['vocab_size'])) + '\n')
        tok_conf = {'do_lower_case': True, 'model_max_length': 512}
    with open(os.path.join(out, 'tokenizer_config.json'), 'w') as f:
        json.dump(tok_conf, f)
    width = config.get('hidden_size', config.get('dim'))
    modules = [('Transformer', ''), ('Pooling', '1_Pooling')]
    if spec.get('dense'):
        dense_dir = os.path.join(out, '2_Dense')
        os.makedirs(dense_dir, exist_ok=True)
        with open(os.path.join(dense_dir, 'config.json'), 'w') as f:
            json.dump({'in_features': width, 'out_features': spec['dense'],
                       'bias': True, 'activation_function':
                       'torch.nn.modules.activation.Tanh'}, f)
        gen = torch.Generator().manual_seed(seed + 1)
        write_safetensors(os.path.join(dense_dir, 'model.safetensors'), {
            'linear.weight': (0.02 * torch.randn(
                spec['dense'], width, generator=gen)).numpy(),
            'linear.bias': (0.02 * torch.randn(
                spec['dense'], generator=gen)).numpy()})
        modules.append(('Dense', '2_Dense'))
    if spec['normalize']:
        modules.append(('Normalize', f'{len(modules)}_Normalize'))
        os.makedirs(os.path.join(out, modules[-1][1]), exist_ok=True)
    with open(os.path.join(out, 'modules.json'), 'w') as f:
        json.dump([{'idx': k, 'name': str(k), 'path': path,
                    'type': f'sentence_transformers.models.{m}'}
                   for k, (m, path) in enumerate(modules)], f)
    with open(os.path.join(out, '1_Pooling', 'config.json'), 'w') as f:
        json.dump({'word_embedding_dimension': width,
                   'pooling_mode_cls_token': False,
                   'pooling_mode_mean_tokens': True,
                   'pooling_mode_max_tokens': False,
                   'pooling_mode_mean_sqrt_len_tokens': False}, f)
    with open(os.path.join(out, 'sentence_bert_config.json'), 'w') as f:
        json.dump({'max_seq_length': spec['max_seq_length'],
                   'do_lower_case': False}, f)
    write_safetensors(os.path.join(out, 'model.safetensors'),
                      random_weights(config, seed))
    return out


def _cut_texts(cut_dir: str) -> list[str]:
    """The cut's review texts, then its item descriptions as the loader
    joins them."""
    with open(os.path.join(cut_dir, 'reviews_text.tsv')) as f:
        next(f)
        reviews = [line.split('\t')[2] for line in f]
    with open(os.path.join(cut_dir, 'meta_synced.tsv')) as f:
        next(f)
        items = [' [SEP] '.join(line.rstrip('\n').split('\t')[1:])
                 for line in f]
    return reviews + items


def st_ltr_run(root: str, cut_dir: str, base_ck: str, model_dir: str,
               uid: str) -> dict:
    """``ltr_linear --load_base <base_ck> --freeze`` for 1 epoch on a copy
    of the cut without caches under ``TEXTGCN_TPU_TEXT_ENCODER=st
    --bert_model <model_dir>``: every text of the cut encoded on the card,
    both caches written; K1 launches exactly ``6 + steps x 6 + 6``.
    Returns the launches, the encode calls' sentences and seconds, the
    CLI's seconds and the caches' arrays."""
    import shutil

    from textgcn_tpu_torch.data import encoder, text
    enc_dir = os.path.join(root, f's1_{uid}')
    os.makedirs(enc_dir, exist_ok=True)
    for name in ('train.tsv', 'test.tsv', 'meta_synced.tsv',
                 'reviews_text.tsv'):
        shutil.copy(os.path.join(cut_dir, name), enc_dir)
    calls = []
    real_encode, loader = encoder.encode, text.load_ltr_data
    old_env = os.environ.get(text.ENCODER_ENV)

    def counted(sentences, *args, **kwargs):
        t = time.perf_counter()
        vectors = real_encode(sentences, *args, **kwargs)
        calls.append((len(sentences), time.perf_counter() - t))
        return vectors

    encoder.encode = counted
    text.load_ltr_data = getattr(loader, 'real', loader)
    os.environ[text.ENCODER_ENV] = 'st'
    argv = ['--model', 'ltr_linear', '--load_base', base_ck, '--freeze',
            '--epochs', '1', '--evaluate_every', '1', '--bert_model',
            model_dir, '--emb_size', str(D), '--n_layers', str(LAYERS),
            '--batch_size', str(BATCH), '-k', *map(str, KS), '--uid', uid]
    try:
        reset_counts()
        t0 = time.perf_counter()
        trainer, _ = cli_run(enc_dir, argv, 'cuda')
        seconds = time.perf_counter() - t0
        launches = counts()
    finally:
        encoder.encode, text.load_ltr_data = real_encode, loader
        if old_env is None:
            os.environ.pop(text.ENCODER_ENV, None)
        else:
            os.environ[text.ENCODER_ENV] = old_env
    steps = trainer.model.num_batches(BATCH)
    want = dict.fromkeys(_wrappers(), 0)
    want['spmm_dropout'] = 2 * LAYERS * (steps + 2)
    check(launches == want, f'{uid} ltr_linear: launches {launches}, '
          f'expected {want} (base eval + steps + eval, forward only)')
    check(len(calls) == 2, f'{uid} ltr_linear: {len(calls)} encode calls')
    caches = sorted(os.listdir(os.path.join(enc_dir, 'embeddings')))
    check(len(caches) == 4, f'{uid} caches {caches}')
    arrays = {name: np.load(os.path.join(enc_dir, 'embeddings', name))
              for name in caches if name.endswith('.npy')}
    n, s = sum(c[0] for c in calls), sum(c[1] for c in calls)
    return {'launches': launches['spmm_dropout'], 'encoded': n,
            'encode_s': s, 'sentences_per_s': n / s, 'cli_s': seconds,
            'caches': caches, 'arrays': arrays}


def encoder_families_phase(root: str, cut_dir: str, base_ck: str, card: str,
                           dev) -> dict:
    """The sentence encoders at their published shapes
    (``write_st_model``: all-mpnet-base-v2, all-distilroberta-v1,
    msmarco-distilbert-base-v4, paraphrase-multilingual-MiniLM-L12-v2 and
    paraphrase-multilingual-mpnet-base-v2 over a Unigram tokenizer.json,
    distiluse-base-multilingual-cased-v2 over a WordPiece tokenizer.json
    and a Dense 768 -> 512 tanh) by Sentence Transformers' recipe: for
    each, ``FAMILY_SENTENCES`` of the 4,096-user cut's texts (the
    multilingual ones with ``MULTILINGUAL``'s lines) encoded on the card
    against the CPU
    (``ENCODE_TOL``), then ``RATE_SENTENCES`` timed on the card
    (sentences/s) and through the tokenizer alone (its share); then
    ``st_ltr_run`` with the MPNet directory (unit rows: it lists
    ``Normalize``) and with the multilingual MiniLM one (the slice's
    path)."""
    from textgcn_tpu_torch.data import encoder
    texts = _cut_texts(cut_dir)
    step = max(1, len(texts) // RATE_SENTENCES)
    sample = texts[::step][:RATE_SENTENCES]
    out = {}
    dirs = {}
    for name, spec in ST_MODELS.items():
        t0 = time.perf_counter()
        dirs[name] = path = write_st_model(root, name, texts[:2000])
        write_s = time.perf_counter() - t0
        tok, model, length, pipe = encoder.load_sentence_encoder(path, dev)
        recipe = {'pooling': pipe.pooling, 'dense': pipe.dense,
                  'norm_floor': 1e-12 if pipe.normalize else None}
        few = sample[:FAMILY_SENTENCES]
        if 'tokenizer' in spec:
            few = few[:-len(MULTILINGUAL)] + MULTILINGUAL
        on_card = encoder.encode_with(tok, model, length, few, 64, **recipe)
        on_cpu = encoder.encode_with(tok, copy.deepcopy(model).to('cpu'),
                                     length, few, 64, **recipe)
        err = float(np.abs(on_card - on_cpu).max())
        width = spec.get('dense') or spec['config'].get(
            'hidden_size', spec['config'].get('dim'))
        check(on_card.shape == (len(few), width) and err <= ENCODE_TOL
              and np.isfinite(on_card).all(),
              f'{name}: card vs CPU {err}, shape {on_card.shape}')
        encoder.encode_with(tok, model, length, sample[:64], 64, **recipe)
        t0 = time.perf_counter()
        encoder.encode_with(tok, model, length, sample, 64, **recipe)
        card_s = time.perf_counter() - t0
        fresh = encoder.load_tokenizer(pipe.transformer_dir,
                                       model.model_type)
        t0 = time.perf_counter()
        for start in range(0, len(sample), 64):
            fresh(sample[start:start + 64], length)
        tok_s = time.perf_counter() - t0
        out[name] = {'model_type': model.model_type,
                     'tokenizer': type(tok).__name__,
                     'card_vs_cpu_max_abs_err': err,
                     'card_vs_cpu_sentences': len(few),
                     'sentences_per_s': len(sample) / card_s,
                     'tokenizer_share': tok_s / card_s,
                     'tokenizer_sentences_per_s': len(sample) / tok_s,
                     'max_length': length, 'write_s': write_s}
        log(f'encoder {name} ({model.model_type}, {type(tok).__name__}, '
            f'{width} wide): {len(few)} sentences on the card vs the CPU '
            f'max abs err {err:.3e}; {len(sample)} sentences in '
            f'{card_s:.3f} s on the card ({len(sample) / card_s:.1f} '
            f'sentences/s on {card}), the tokenizer alone {tok_s:.3f} s '
            f'({tok_s / card_s:.3f} of it); written in {write_s:.3f} s')
        del model
        torch.cuda.empty_cache()

    for key, name, uid in (
            ('ltr_linear_st_mpnet', 'all-mpnet-base-v2', 'mpnet-st'),
            ('ltr_linear_st_multilingual_minilm',
             'paraphrase-multilingual-MiniLM-L12-v2', 'minilm-ml-st')):
        run = st_ltr_run(root, cut_dir, base_ck, dirs[name], uid)
        spec = ST_MODELS[name]
        width = spec['config']['hidden_size']
        for cache, v in run.pop('arrays').items():
            check(v.shape[1] == width and np.isfinite(v).all()
                  and (not spec['normalize'] or np.allclose(
                      np.linalg.norm(v, axis=1), 1, atol=1e-4)),
                  f'{uid} cache {cache}: {v.shape}')
        out[key] = run
        log(f'encoder: ltr_linear --freeze under TEXTGCN_TPU_TEXT_ENCODER='
            f'st with the {name}-shaped model encoded {run["encoded"]} '
            f'sentences in {run["encode_s"]:.3f} s '
            f'({run["sentences_per_s"]:.1f} sentences/s on {card}); '
            f'cli.main took {run["cli_s"]:.3f} s; K1 {run["launches"]} '
            f'launches; caches {run["caches"]}')
    return out


def tool_phase(root: str) -> dict:
    """The last three tools: ``sem_cold_sweep --quick --rows 2`` on the card
    (the ``lgcn`` base and the grid's first two ``kg`` rows through
    ``cli.main`` and ``cold_report``: every metric in [0, 1], K1 launched),
    and ``make_dummy`` into a temporary directory, byte for byte
    ``data/dummy``."""
    from textgcn_tpu_torch.tools import make_dummy, sem_cold_sweep
    # the sweep defaults the encoder to the stub for the rest of the process
    old = os.environ.get('TEXTGCN_TPU_TEXT_ENCODER')
    reset_counts()
    t0 = time.perf_counter()
    try:
        rows = sem_cold_sweep.main([
            '--quick', '--rows', '2', '--data',
            os.path.join(root, 'coldsweep_data'), '--runs',
            os.path.join(root, 'coldsweep_runs')])
    finally:
        if old is None:
            os.environ.pop('TEXTGCN_TPU_TEXT_ENCODER', None)
        else:
            os.environ['TEXTGCN_TPU_TEXT_ENCODER'] = old
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = counts()
    names = sorted(r['name'] for r in rows)
    want = sorted(['base_lgcn'] + [sem_cold_sweep.run_name('kg', *g)
                                   for g in sem_cold_sweep.GRID[:2]])
    check(names == want and all(
        0 <= r[k] <= 1 for r in rows
        for k in ('warm_r20', 'warm_r40', 'cold_r40', 'cold_ndcg40')),
        f'sem_cold_sweep: {rows}')
    check(launches['spmm_dropout'] > 0
          and sum(launches.values()) == launches['spmm_dropout'],
          f'sem_cold_sweep: launches {launches}')
    out_dir = os.path.join(root, 'dummy')
    t0 = time.perf_counter()
    make_dummy.main([out_dir])
    dummy_s = time.perf_counter() - t0
    names = ('train.tsv', 'test.tsv', 'meta_synced.tsv', 'reviews_text.tsv')
    same = all(same_files(os.path.join(out_dir, n),
                          os.path.join(REPO, 'data', 'dummy', n))
               for n in names)
    check(same, 'make_dummy: the bytes differ from data/dummy')
    log(f'tools: sem_cold_sweep --quick --rows 2 in {sweep_s:.3f} s (K1 '
        f'{launches["spmm_dropout"]} launches; {rows}); make_dummy wrote '
        f"data/dummy's bytes in {dummy_s:.3f} s")
    return {'sweep_s': sweep_s, 'launches': launches['spmm_dropout'],
            'rows': rows, 'make_dummy_s': dummy_s}


def cold_phase(root: str) -> dict:
    """``cold_report``: a 5,000 x 2,000 ``--sharp --cold 0.2`` set from the
    port's generator, ``lgcn`` trained 2 epochs on it through ``cli.main``,
    then ``tools/cold_report.main --load`` on the card (12 K1 launches:
    the load's evaluation and the one ranking pass); the three splits'
    metrics finite and in [0, 1]."""
    from textgcn_tpu_torch.tools import cold_report
    from textgcn_tpu_torch.tools.make_synthetic import generate
    data_dir = os.path.join(root, 'cold')
    generate(data_dir, n_users=5000, n_items=2000, seed=0, sharp=True,
             cold=0.2)
    common = ['--model', 'lgcn', '--emb_size', str(D), '--n_layers',
              str(LAYERS), '--batch_size', str(BATCH), '-k', *map(str, KS),
              '--quiet']
    t0 = time.perf_counter()
    _, run_dir = cli_run(data_dir, common + ['--epochs', '2',
                                             '--evaluate_every', '1',
                                             '--uid', 'cold-base'], 'cuda')
    train_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    results = cli_run(data_dir, common + ['--load', run_dir, '--uid', 'cold'],
                      'cuda', entry=cold_report.main)
    report_s = time.perf_counter() - t0
    launches = counts()
    want = dict.fromkeys(_wrappers(), 0)
    want['spmm_dropout'] = 2 * 2 * LAYERS
    check(launches == want, f'cold_report: launches {launches}, expected '
          f'{want}')
    check(list(results) == ['all', 'warm', 'cold']
          and all(np.isfinite(v).all() and (np.asarray(v) >= 0).all()
                  and (np.asarray(v) <= 1).all()
                  for r in results.values() for v in r.values()),
          f'cold_report: {results}')
    recall = {s: [float(x) for x in r['recall']] for s, r in results.items()}
    log(f'cold_report: trained in {train_s:.3f} s, reported in '
        f'{report_s:.3f} s; recall@{KS} {recall}')
    return {'launches': launches['spmm_dropout'], 'recall': recall,
            'train_s': train_s, 'report_s': report_s}


def device_ms_per_step(trainer, batches, trace_dir: str,
                       name: str) -> tuple:
    """Device time of ``len(batches)`` training steps from a
    ``torch.profiler`` trace: the summed durations of its kernel, memcpy
    and memset events (one stream, so they do not overlap) per step, the
    number of those events per step, the five kernels that take most of
    the time, the time of each hand-written kernel (``<name>_kernel`` of a
    ``_wrappers()`` name) per step, and ``host_ms_per_step``."""
    from torch.profiler import ProfilerActivity, profile
    model = trainer.model
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i, batch in enumerate(batches):
            trainer.epoch_step(i, batch)
        torch.cuda.synchronize()
    model.cached_rest = None
    path = os.path.join(trace_dir, f'trace_{name}.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    by_name, n_events = {}, 0
    for e in events:
        if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            n_events += 1
            name = e['name'].replace('(anonymous namespace)::', '')
            name = re.split(r'[(<]', name.removeprefix('void '))[0]
            by_name[name] = by_name.get(name, 0.0) + e['dur'] / 1e3
    n = len(batches)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    ours = {name: by_name[f'{name}_kernel'] / n for name in _wrappers()
            if f'{name}_kernel' in by_name}
    return (sum(by_name.values()) / n, n_events / n,
            [(name, ms / n) for name, ms in top], ours,
            host_ms_per_step(prof, n))


def host_ms_per_step(prof, n: int) -> dict:
    """The host's side of ``n`` profiled steps, per step: the summed self
    time of every operator and runtime call the profiler saw (Python
    between them not included), the collectives (``c10d::`` operators:
    how many, and their time with what they call), and the six that take
    most of the host's time (self ms, calls).  The profiler adds its own
    cost to each call, the same on both sides of a comparison."""
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    coll = [e for e in host if e.key.startswith('c10d::')]
    top = sorted(host, key=lambda e: -e.self_cpu_time_total)[:6]
    return {'ops': sum(e.self_cpu_time_total for e in host) / 1e3 / n,
            'collectives': sum(e.count for e in coll) / n,
            'collectives_ms': sum(e.cpu_time_total for e in coll) / 1e3 / n,
            'top': [(e.key, e.self_cpu_time_total / 1e3 / n, e.count / n)
                    for e in top]}


def timing_phase(trainer, card: str, trace_dir: str, n_steps: int = 30,
                 name: str | None = None) -> dict:
    """Where a training step's time goes at S1, after the counted run:
    sampling an epoch, and forward, backward and Adam of ``n_steps`` steps,
    each piece timed by the host clock around synchronised work (under
    ``--refresh_every N`` also the refresh of steps 0, N, 2N, ...); then
    ``n_steps`` unsynchronised steps (``Trainer.epoch_step``): ms per
    step, examples/s and the host's share (the time to enqueue them over
    the time to finish); then 10 steps under ``torch.profiler``: the
    device's busy time per step, whose share of the unsynchronised step is
    the device busy share."""
    model = trainer.model
    name = name or model.cfg.model
    refresh = trainer.cfg.refresh_every
    gen = torch.Generator(device=model.device).manual_seed(7)

    def sync_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    batches, t_sample = sync_ms(lambda: model.sample_batches(gen, BATCH))
    pieces = {'forward': [], 'backward': [], 'adam': [], 'refresh': []}
    per_step = {}
    for i, batch in enumerate(batches[:n_steps + 3]):
        w_pairs = trainer.step_salts()
        if refresh and i % refresh == 0:
            c0 = counts()

            def rest():
                with torch.no_grad():
                    model.cached_rest = model.propagate_rest(w_pairs=w_pairs)

            _, t_r = sync_ms(rest)
            c1 = counts()
            per_step['refresh'] = {k: c1[k] - c0[k] for k in c0}
            if i >= 3:
                pieces['refresh'].append(t_r)
        trainer.optimizer.zero_grad(set_to_none=True)
        c0 = counts()
        (loss, _), t_f = sync_ms(lambda: model.loss(batch, w_pairs=w_pairs))
        c1 = counts()
        _, t_b = sync_ms(loss.backward)
        c2 = counts()
        _, t_a = sync_ms(trainer.optimizer.step)
        per_step.update(forward={k: c1[k] - c0[k] for k in c0},
                        backward={k: c2[k] - c1[k] for k in c0})
        if i >= 3:   # warm-up steps
            pieces['forward'].append(t_f)
            pieces['backward'].append(t_b)
            pieces['adam'].append(t_a)
    model.cached_rest = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, batch in enumerate(batches[:n_steps]):
        trainer.epoch_step(i, batch)
    t_enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    model.cached_rest = None
    out = {part: float(np.median(v)) for part, v in pieces.items() if v}
    out['sampling_epoch'] = t_sample
    out['sampling_per_step'] = t_sample / len(batches)
    out['step'] = t_total / n_steps * 1e3
    out['examples_per_s'] = BATCH * n_steps / t_total
    out['host_enqueue_share'] = t_enqueue / t_total
    out['launches_per_step'] = per_step
    (out['device'], out['device_events'], top, out['kernel_ms'],
     out['host']) = device_ms_per_step(
        trainer, batches[n_steps:n_steps + 10], trace_dir, name)
    out['device_busy_share'] = out['device'] / out['step']
    host = out['host']
    refresh_note = (f', refresh {out["refresh"]:.3f} ms every {refresh} '
                    'steps' if refresh else '')
    log(f'timing train {name} at S1 ({card}): sampling '
        f'{t_sample:.3f} ms an epoch ({out["sampling_per_step"]:.4f} ms a '
        f'step); forward {out["forward"]:.3f} ms, backward '
        f'{out["backward"]:.3f} ms, Adam {out["adam"]:.3f} ms{refresh_note} '
        f'(medians of {n_steps} synchronised steps); unsynchronised step '
        f'{out["step"]:.3f} ms, {out["examples_per_s"]:.0f} examples/s, '
        f'host enqueue share {out["host_enqueue_share"]:.3f}; launches a '
        f'step {json.dumps(per_step)}; device busy {out["device"]:.3f} ms '
        f'a step (share {out["device_busy_share"]:.3f}) in '
        f'{out["device_events"]:.0f} kernels and copies, most in '
        + ', '.join(f'{name} {ms:.3f} ms' for name, ms in top)
        + '; hand-written kernels a step: '
        + ', '.join(f'{name} {ms:.4f} ms'
                    for name, ms in out['kernel_ms'].items())
        + f'; host (profiled) {host["ops"]:.3f} ms of operators a step, '
        f'{host["collectives"]:.0f} collectives taking '
        f'{host["collectives_ms"]:.3f} ms, most in '
        + ', '.join(f'{k} {ms:.3f} ms ({c:g} calls)'
                    for k, ms, c in host['top']))
    return out



def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: CUDA is not available')
    sys.path.insert(0, REPO)
    from textgcn_tpu_torch import cuda_build, native
    from textgcn_tpu_torch.data.core import load_interactions
    dev = torch.device('cuda')
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'python {sys.version.split()[0]}')

    t = time.perf_counter()
    card = card_name_and_power()
    log(card)
    log(f'phase device: {time.perf_counter() - t:.3f} s')

    t = time.perf_counter()
    built = cuda_build.build()
    for name, text in cuda_build.build_logs.items():
        log(f'nvcc {name}:\n{text.strip()}')
    log(f'phase build: {time.perf_counter() - t:.3f} s '
        f'(per source: {built or "already built"})')

    os.makedirs(os.path.join(REPO, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, 'build')) as root:
        t = time.perf_counter()
        data_dir = write_dataset(root, S1_USERS, S1_ITEMS, S1_DEG)
        t_load = time.perf_counter()
        native_lib = native.build()
        build_s = time.perf_counter() - t_load
        os.environ.pop(native.ENV, None)
        t_load = time.perf_counter()
        data = load_interactions(data_dir)
        loader = {'native_reader_s': time.perf_counter() - t_load,
                  'native_build_s': build_s}
        loader.update(loader_phase(data_dir, data))
        log(f'load_interactions at S1: the native reader '
            f'{loader["native_reader_s"]:.3f} s (its library '
            f'{os.path.basename(native_lib)} built in {build_s:.3f} s), the '
            f'Python reader {loader["python_reader_s"]:.3f} s; the same '
            'edges, id maps and test lists')
        check((data.n_users, data.n_items) == (S1_USERS, S1_ITEMS),
              f'S1 loaded as {data.n_users} x {data.n_items}')
        ck = os.path.join(root, 's1_ck.pkl')
        write_jax_checkpoint(ck, data.n_users, data.n_items, D)
        log(f'phase data: {time.perf_counter() - t:.3f} s '
            f'({data.n_users} users, {data.n_items} items, '
            f'{data.n_train} train / {data.n_test} test edges)')

        t = time.perf_counter()
        k1 = kernel_phase(data, dev)
        k1['book'] = book_kernel_phase(dev)
        log(f'phase kernel: {time.perf_counter() - t:.3f} s')

        t = time.perf_counter()
        k2 = k2_phase(data, dev)
        log(f'phase K2 kernel: {time.perf_counter() - t:.3f} s')

        att = {}
        for conv in ('gat', 'gatv2'):
            t = time.perf_counter()
            att.update(attention_kernel_phase(data, dev, conv))
            log(f'phase {conv} kernel: {time.perf_counter() - t:.3f} s')

        t = time.perf_counter()
        shard = shard_kernel_phase(data, dev)
        log(f'phase shard kernels: {time.perf_counter() - t:.3f} s')

        t = time.perf_counter()
        labs = lab_phase(dev)
        log(f'phase labs: {time.perf_counter() - t:.3f} s')

        t = time.perf_counter()
        small_phase(root)
        log(f'phase small: {time.perf_counter() - t:.3f} s')

        t = time.perf_counter()
        launches, serve_s = serve_phase(data_dir, ck)
        log(f'phase serve: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        approx = approx_phase(data_dir, ck, serve_s)
        log(f'phase approx serve: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        jax_runs = jax_runs_phase(root, data_dir, ck)
        log(f'phase jax runs: {time.perf_counter() - t:.3f} s')

        trained, timing = {}, {}
        for model in MODEL_FLAGS:
            t = time.perf_counter()
            trained[model] = train_phase(data_dir, model)
            log(f'phase train {model}: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        mesh = mesh_phase(data_dir, trained['lgcn']['trainer'], card, root,
                          dev)
        timing['lgcn_mesh'] = mesh['timing']
        log(f'phase mesh: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        mesh_conv = mesh_conv_phase(data_dir, trained, card, root, dev)
        for model, r in mesh_conv.items():
            timing[f'{model}_mesh'] = r.pop('timing')
        log(f'phase mesh convs: {time.perf_counter() - t:.3f} s')

        t = time.perf_counter()
        ltr_text = write_ltr_text(data_dir, data, dev)
        ltr_loads = memoize_ltr_loader()
        t_load = time.perf_counter()
        from textgcn_tpu_torch.config import Config
        from textgcn_tpu_torch.data.text import load_ltr_data
        load_ltr_data(Config(data=data_dir).finalize())
        ltr_text['load_ltr_data_s'] = time.perf_counter() - t_load
        log(f'load_ltr_data at S1: {ltr_text["load_ltr_data_s"]:.3f} s '
            f'(reads the {ltr_text["reviews"]}-row review cache of '
            f'{ltr_text["cache_bytes"]["item_full_reviews_loss_repr"]} '
            'bytes)')
        log(f'phase ltr text: {time.perf_counter() - t:.3f} s')
        for model in ('ltr_linear', 'ltr_pop'):
            t = time.perf_counter()
            trained[model] = ltr_phase(data_dir, ck, model)
            log(f'phase ltr {model}: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        mesh_ltr = mesh_ltr_phase(data_dir, ck, trained, dev)
        log(f'phase mesh ltr: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        resumed = resume_phase(data_dir, trained['lgcn']['trainer'])
        log(f'phase resume: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        trained['lgcn_refresh'] = refresh_phase(data_dir)
        log(f'phase refresh: {time.perf_counter() - t:.3f} s')

        timed = (*MODEL_FLAGS, 'ltr_linear', 'lgcn_refresh', 'adv_sampling',
                 'text_user')
        for model in SLICE_FLAGS:
            t = time.perf_counter()
            trained[model] = train_phase(data_dir, model)
            log(f'phase train {model}: {time.perf_counter() - t:.3f} s')
        m = trained['text_user']['trainer'].model
        pair_bytes = m.pair_vectors.numel() * m.pair_vectors.element_size()
        check(m.pos_mode == 'user'
              and m.pair_vectors.device.type == m.device.type
              and m.pair_keys.numel() == m.pair_vectors.shape[0]
              == data.n_train, f'text --pos user: the pair table '
              f'{tuple(m.pair_vectors.shape)} on {m.pair_vectors.device}')
        log(f'text --pos user: the (item, user) review table '
            f'{tuple(m.pair_vectors.shape)}, {pair_bytes} bytes, on '
            f'{m.pair_vectors.device}')
        t = time.perf_counter()
        probes = probe_phase(data_dir, trained['lgcn']['run_dir'])
        log(f'phase probes: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        mining = adv_target_phase(trained['adv_sampling']['trainer'], card)
        log(f'phase mining (adv recall target): '
            f'{time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        mesh_slice = mesh_slice_phase(data_dir, trained, probes, dev, card,
                                      root)
        timing['adv_sampling_mesh'] = mesh_slice['adv_sampling'].pop(
            'timing')
        for model in SLICE_FLAGS:
            if model not in timed:
                trained[model].pop('trainer')
        log(f'phase mesh slice: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        boosted = boosted_phase(root, data_dir, trained['lgcn']['run_dir'],
                                card, dev)
        log(f'phase boosted: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        dcp = dcp_phase(boosted['data_dir'])
        log(f'phase dcp: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        encoded = encoder_phase(root, boosted['data_dir'],
                                os.path.join(root, 'boost_base.pkl'), card,
                                dev)
        log(f'phase encoder: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        flax_dir = flax_dir_phase(root, boosted['data_dir'],
                                  os.path.join(root, 'boost_base.pkl'), card,
                                  dev)
        log(f'phase flax dir: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        families = encoder_families_phase(
            root, boosted['data_dir'], os.path.join(root, 'boost_base.pkl'),
            card, dev)
        log(f'phase encoder families: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        health = health_phase(encoded.pop('log'), dev)
        log(f'phase health check: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        cold = cold_phase(root)
        log(f'phase cold_report: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        tools = tool_phase(root)
        log(f'phase tools: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        traced = trace_phase(boosted.pop('data_dir'), root)
        log(f'phase trace: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        quality = quality_phase(root, card)
        log(f'phase quality: {time.perf_counter() - t:.3f} s')

        for model in timed:
            t = time.perf_counter()
            timing[model] = timing_phase(trained[model].pop('trainer'), card,
                                         root, name=model)
            log(f'phase timing {model}: {time.perf_counter() - t:.3f} s')
        log(f'load_ltr_data: {ltr_loads["loads"]} real loads, '
            f'{ltr_loads["hits"]} served from the memo')
        trained['ltr_pop'].pop('trainer')

    # each path's launches, counted from 0 just before its run
    by_path = {'serve_lgcn': {'spmm_dropout': launches},
               'serve_lgcn_approx': {
                   'spmm_dropout': approx['single_launches']},
               'serve_lgcn_approx_mesh': {
                   'spmm_weighted': approx['mesh_launches']},
               'serve_lgcn_jax_orbax': {
                   'spmm_dropout': jax_runs['launches']},
               'serve_jax_fixture_lgcn_orbax': {
                   'spmm_dropout': jax_runs['fixture_lgcn']['launches']},
               'serve_jax_fixture_lgcn_pkl': {
                   'spmm_dropout': jax_runs['fixture_lgcn_pkl']['launches']},
               'serve_jax_fixture_gat_orbax': {
                   'gat_fwd': jax_runs['fixture_gat']['launches']},
               'serve_jax_fixture_gbdt_tree_pkl': {
                   'spmm_dropout': jax_runs['fixture_gbdt']['launches']},
               'train_ltr_linear_encoder': {
                   'spmm_dropout': encoded['encode_launches']},
               'train_ltr_linear_encoder_cached': {
                   'spmm_dropout': encoded['cached_launches']},
               'train_ltr_linear_flax_only_auto': {
                   'spmm_dropout': flax_dir['launches']},
               'train_ltr_linear_st_mpnet': {
                   'spmm_dropout':
                   families['ltr_linear_st_mpnet']['launches']},
               'train_ltr_linear_st_multilingual_minilm': {
                   'spmm_dropout': families[
                       'ltr_linear_st_multilingual_minilm']['launches']},
               'cold_report': {'spmm_dropout': cold['launches']},
               'sem_cold_sweep_quick': {'spmm_dropout': tools['launches']}}
    by_path.update({f'train_{m}': {k: n for k, n in r['launches'].items()
                                   if n}
                    for m, r in trained.items()})
    by_path['train_lgcn_mesh'] = {'spmm_weighted':
                                  mesh['launches']['spmm_weighted']}
    by_path['serve_lgcn_mesh'] = {'spmm_weighted':
                                  mesh['serve_launches']['spmm_weighted']}
    for m, r in (*mesh_conv.items(), *mesh_ltr.items(),
                 *mesh_slice.items()):
        path = f'{m}_mesh' if m.startswith('probe_') else f'train_{m}_mesh'
        by_path[path] = {k: n for k, n in r['launches'].items() if n}
    # the two runs of the resume phase (epoch 1, then --resume for 2)
    by_path['train_lgcn_resume'] = {k: n for k, n in
                                    resumed['launches'].items() if n}
    by_path.update({f'probe_{m}': {k: n for k, n in r['launches'].items()
                                   if n} for m, r in probes.items()})
    for m in ('marcus', 'gbdt', 'gbdt_pop', 'marcus_mesh', 'gbdt_pop_mesh'):
        for path, key in (('train', 'launches'), ('serve', 'serve_launches')):
            by_path[f'{path}_{m}'] = {k: n for k, n in
                                      boosted[m][key].items() if n}
    # lgcn --mesh 1x1: 1 epoch and a --resume for 1 more, each backend
    for backend, c in dcp['launches'].items():
        by_path[f'train_lgcn_mesh_resume_{backend}'] = {
            k: n for k, n in c.items() if n}
    by_path['serve_lgcn_dcp'] = {k: n for k, n in
                                 dcp['serve_launches'].items() if n}

    by_path['train_lgcn_trace'] = {k: n for k, n in
                                   traced['launches'].items() if n}
    by_path['train_lgcn_quality'] = {k: n for k, n in
                                     quality['launches'].items() if n}

    def launch_fields(name, model):
        paths = {p: c[name] for p, c in by_path.items() if name in c}
        return {'launches': sum(paths.values()),
                'launches_by_path': paths,
                'launches_per_step': {
                    part: timing[model]['launches_per_step'][part][name]
                    for part in ('forward', 'backward')}}

    def shard_fields(name):
        # one layer (to_user + to_item) of one W = 4 destination shard of
        # S1 at keep 0.6 (the mean over the four; the bound counts only the
        # destination rows the rank keeps), and the largest error of that
        # check against the plain version and the whole graph
        r = shard[name]
        return {'max_abs_err_w4_dst_shards': r['max_abs_err'],
                'ms_w4_dst_shard': r['ms'],
                'bound_ms_w4_dst_shard': r['bound_ms']}

    kernels = [{
        'name': 'spmm_dropout',
        'route': 'cuda',
        'source': 'textgcn_tpu_torch/csrc/spmm_dropout.cu',
        'replaces': 'textgcn_tpu/ops/pallas_spmm.py:103',
        # serve lgcn; train lgcn, gcn and graphsage (forward and
        # backward); train ltr_linear and ltr_pop --freeze (forward only:
        # base eval, steps, evals, predict); lgcn --resume; lgcn
        # --refresh_every 8 (forward only, at the refresh steps); train
        # adv_sampling (the rank pass forward, the loss pass forward and
        # backward), text --pos user, kg, reviews, ltr_reviews and ltr_kg;
        # ltr_simple --load_base (the base's eval and two probes); train
        # marcus, gbdt and gbdt_pop --load_base (forward only: base eval,
        # the fit's propagation, eval, predict) and their --load re-serve;
        # train lgcn --trace (1 epoch) and the quality run (60 epochs on
        # the 50k x 20k sharp set, or fewer if the early stop ends it);
        # train gcn and graphsage --mesh 1x1 (1 epoch); serve the
        # resumed lgcn --mesh 1x1 run's latest_checkpoint.orbax on one card;
        # serve lgcn --approx_topk 0.95; serve lgcn from a JAX Orbax
        # directory of S1 (--ckpt_backend orbax --load), and the committed
        # JAX runs on data/dummy (lgcn from best.orbax and from best.pkl,
        # gbdt from tree.pkl); train ltr_linear --freeze on the
        # 4,096-user cut as the encoder writes its caches, then from them
        # (forward only), again under auto through a Flax-only
        # directory of the same weights, and with the
        # all-mpnet-base-v2-shaped and the
        # paraphrase-multilingual-MiniLM-L12-v2-shaped encoders
        # under TEXTGCN_TPU_TEXT_ENCODER=st; cold_report (the
        # load's evaluation and one ranking pass); sem_cold_sweep --quick
        # --rows 2 (lgcn and two kg runs, each trained and reported)
        **launch_fields('spmm_dropout', 'lgcn'),
        'max_abs_err': k1['max_abs_err'],
        'max_abs_err_by_width': k1['max_abs_err_by_width'],
        # times and bound: one layer, i.e. the to_user + to_item launches
        # at keep = 1 on S1, d = 64 (ms_keep_0_6: the same at keep 0.6)
        'ms': k1['ms'],
        'ms_keep_0_6': k1['ms_keep_0_6'],
        'plain_ms': k1['plain_ms'],
        'bound_ms': k1['bound_ms'],
        'bound_by': k1['bound_by'],
        'library_ms': k1['library_ms'],
        # the Amazon-Book graph's rows, split: per direction its split
        # rows and chunks, and one launch's ms and bound at each keep
        'book': k1['book'],
        **shard_fields('spmm_dropout'),
    }, {
        'name': 'spmm_weighted',
        'route': 'cuda',
        'source': 'textgcn_tpu_torch/csrc/spmm_weighted.cu',
        'replaces': 'textgcn_tpu/ops/pallas_spmm.py:61',
        # train and serve lgcn --mesh 1x1 (forward and backward); train
        # ltr_linear and ltr_pop --freeze --mesh 1x1 (forward only); train
        # adv_sampling (the rank pass forward, the loss pass forward and
        # backward), text --pos user, kg, reviews, ltr_reviews and ltr_kg
        # --mesh 1x1 (1 epoch); ltr_simple --load_base --mesh 1x1 (the
        # base's eval and two probes); train marcus and gbdt_pop
        # --load_base --mesh 1x1 (forward only: base eval, the fit's
        # propagation, eval, predict) and their --load re-serve; lgcn
        # --mesh 1x1 for 1 epoch and --resume'd for 1 more with
        # --ckpt_backend orbax and with pickle; serve lgcn --approx_topk
        # 0.95 --mesh 1x1
        **launch_fields('spmm_weighted', 'lgcn_mesh'),
        'max_abs_err': k2['max_abs_err'],
        'max_abs_err_4_shards_vs_k1': k2['max_abs_err_vs_k1'],
        'max_abs_err_by_width': k2['max_abs_err_by_width'],
        # times and bound: one layer (to_user + to_item) on S1, d = 64, at
        # W = 1; the *_w4_per_shard keys: one layer of one shard at W = 4
        # (mean over the four), which reads a quarter of the edges and
        # writes the whole padded destination range
        'ms': k2['ms'],
        'plain_ms': k2['plain_ms'],
        'bound_ms': k2['bound_ms'],
        'bound_by': k2['bound_by'],
        'library_ms': k2['library_ms'],
        'ms_w4_per_shard': k2['ms_w4_per_shard'],
        'plain_ms_w4_per_shard': k2['plain_ms_w4_per_shard'],
        'bound_ms_w4_per_shard': k2['bound_ms_w4_per_shard'],
        # the same with the keep-0.6 hash mask multiplied into the weights,
        # as the mesh path's training steps run K2
        **{f'{t}_keep_0_6': k2[f'{t}_keep_0_6']
           for t in ('ms', 'plain_ms', 'library_ms', 'bound_ms',
                     'ms_w4_per_shard', 'plain_ms_w4_per_shard',
                     'bound_ms_w4_per_shard')},
    }]
    for name, line in (('gat_fwd', 201), ('gat_bwd', 293),
                       ('gatv2_fwd', 647), ('gatv2_bwd', 715)):
        r = att[name]
        kernels.append({
            'name': name,
            'route': 'cuda',
            'source': f'textgcn_tpu_torch/csrc/{name}.cu',
            'replaces': f'textgcn_tpu/ops/pallas_gat.py:{line}',
            **launch_fields(name, name.split('_')[0]),
            'max_abs_err': r['max_abs_err'],
            'max_abs_err_by_output': r['max_abs_err_by_output'],
            **({'max_abs_err_by_width': r['max_abs_err_by_width']}
               if 'max_abs_err_by_width' in r else {}),
            # times, plain and bound: one layer (to_user + to_item) at
            # keep 0.6, the training path, on S1, d = 64
            'ms': r['ms'],
            'ms_keep_1': r['ms_keep_1'],
            'plain_ms': r['plain_ms'],
            'bound_ms': r['bound_ms'],
            'bound_by': r['bound_by'],
            'library_ms': None,
            'library_note': 'no single PyTorch call computes the masked '
                            'edge-softmax aggregation or its gradient',
            **shard_fields(name),
        })
    for row, name, source, replaces, path in (
            ('L1', 'spmm_lab', 'spmm_lab.cu', 'tools/kernel_lab.py:129',
             'lab_kernel_lab'),
            ('L2', 'gather_rows', 'gather_lab.cu', 'tools/gather_lab.py:85',
             'lab_gather_lab'),
            ('L3', 'gather_rows_bulk', 'gather_lab.cu',
             'tools/gather_lab.py:150', 'lab_gather_lab')):
        r = labs[row]
        kernels.append({
            'name': name,
            'route': 'cuda',
            'source': f'textgcn_tpu_torch/csrc/{source}',
            'replaces': replaces,
            # all five L1 modes at bf16 and f32 x, or both gathers, run
            # through the lab entry points (python -m
            # textgcn_tpu_torch.tools.kernel_lab / gather_lab)
            'launches': r['launches'],
            'launches_by_path': {path: r['launches']},
            'max_abs_err': r['max_abs_err'],
            # L1: mode full, f32 x (the function torch.sparse.mm computes),
            # at the lab's full shape; L2/L3: the lab's gathers, whose
            # plain version is the one-call yardstick index_select
            **{k: v for k, v in r.items()
               if k not in ('launches', 'max_abs_err')},
        })
    steps = {m: {'step_ms': timing[m]['step'],
                 'examples_per_s': timing[m]['examples_per_s'],
                 'host_enqueue_share': timing[m]['host_enqueue_share'],
                 'host_profiled_ms_per_step': timing[m]['host'],
                 'device_ms_per_step': timing[m]['device'],
                 'device_busy_share': timing[m]['device_busy_share'],
                 'kernel_device_ms_per_step': timing[m]['kernel_ms'],
                 'refresh_ms': timing[m].get('refresh'),
                 'step_vs_plain_max_abs_err': trained.get(m, {}).get(
                     'step_err')}
             for m in timing}
    for m in ('ltr_linear', 'ltr_pop'):
        steps.setdefault(m, {})['fused_topk_vs_reference_max_abs_err'] = \
            trained[m]['topk_err']
    steps['adv_sampling']['selection_agreement'] = \
        trained['adv_sampling']['selection_agreement']
    log(json.dumps({'training_at_s1': steps, 'card': card,
                    'ltr_text': ltr_text,
                    'resume_vs_uninterrupted': resumed,
                    'mesh_conv': mesh_conv, 'mesh_ltr': mesh_ltr,
                    'mesh_slice': mesh_slice, 'ltr_loads': ltr_loads,
                    'mining_ms': mining,
                    'boosted': boosted, 'dcp': dcp,
                    'trace': traced, 'quality': quality,
                    'approx_serve': approx, 'jax_runs': jax_runs,
                    'encoder': encoded,
                    'flax_dir': flax_dir,
                    'encoder_families': families, 'tools': tools,
                    'loader': loader,
                    'health_check': health, 'cold_report': cold,
                    'text_user_pair_table_bytes': pair_bytes}))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
