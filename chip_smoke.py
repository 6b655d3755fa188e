"""Smoke run of the PyTorch port on one NVIDIA card: build, check, serve, train.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before the result line):

1. device   the card's name, count and power limit; no card -> exit 1.
2. build    the eight sources under csrc/ (forest traversal, histograms,
            split search, row compaction, wave partition, row partition,
            the wave's selection, replay and tree loop, the gradient
            discretizer), one nvcc each, all started together; build seconds
            and ptxas's registers / shared memory / spills; beside them, g++
            builds the text parser (native/parser.cpp) and the C API
            (capi/lgbm_capi.c) into build/lightgbm_tpu_torch/.
3. models   from --seed, with the port's Tree API: the HIGGS-profile model
            the repo targets (binary, 28 features, 500 trees x 255 leaves,
            LightGBM docs/Experiments.rst HIGGS settings), a multiclass-3
            model with categorical splits, and a model with constant and
            stump trees; each written with Booster.save_model.
4. kernels  each kernel against its plain PyTorch version on the card:
            the traversal on a 65,536-row sample (~1% NaN and exact zeros)
            and on serving batches of 64, 512 and 4096 rows (both of its
            plans), leaf indices exactly equal, raw scores bit-equal, two
            launches bit-equal, then its timings at the main path's shapes;
            its accumulate mode (a block of 10 trees added onto running
            sums, prediction early stopping's step) bit-equal to the plain
            version on a 262,144-row chunk and the serving batch sizes.
            On the HIGGS-width training data (1,048,576 rows x 28 features
            x 255 bins, made from --seed): the leaf histogram at the root,
            on a ~100,000-row and a ~4,000-row leaf (and the 100,000 rows
            consecutive, the gather's cost apart), read to their counts,
            bit-equal to the plain emulation of its fixed-point sum, exact
            on grid-snapped gradients and in the integer mode, within the
            float32 summation bound otherwise, two launches bit-equal; the
            ragged (wave) histogram
            at the root and on 21 ranges covering about half the rows, each
            also with every row in bin 0, and histogram_slots on a sample,
            held as the leaf histogram and, otherwise, bit-equal to the
            plain emulation of its fixed-point sum. The
            split kernel's per-feature form on those leaves, with and without
            a feature mask, equal to the plain version run on the CPU (the
            gain within 4 ULP), and its leaf batch at a wave's 42 children
            bit-equal; its find form (group histogram -> record) on one leaf
            and on 42, with and without a feature mask, and on a small
            dataset whose features EFB bundles, likewise. The row compaction
            of 21 ranges with a random split, bit-equal. The wave partition
            (decide, scan, scatter) on the inputs of a real wave (21 ranges,
            recorded from a round of training), on the same with random
            sides and on a real bagged initial partition, every output
            exactly equal to the plain version run on the CPU, and the
            relabel on a real commit. The wave's selection and replay
            kernels on the first, a middle and the last live wave of a real
            tree (each wave's carry kept from a round whose trees run the
            loop from the host, the CPU's loop, in place of the tree graph,
            the wave run again from it): the selection's table, the
            replay's state after it (records, depths, ranges, the split
            log's bits, the scalars and the done word) and its commit table
            exactly equal to the plain versions run on the CPU. The serial learner's row partition
            (decide, scatter) on three real splits recorded from a serial
            round (the root's, ~100,000 and ~4,000 rows), both children
            exactly equal to the plain version run on the CPU. Then their
            timings beside their bounds, plain versions and, for the
            compaction and the partition's scatter, index_copy_; the whole
            wave partition, the whole find_best_split and RowPartition.split
            as the learners call them, beside the parent's sequence of
            PyTorch glue and kernels for the same work (device time and
            host time a call).
5. exact    training on 16,384 rows with grid-snapped custom gradients, 2
            rounds: the serial learner (feature_fraction_bynode=0.8) on the
            card and with device_type=cpu, and the wave learner on the card
            against a CPU GBDT whose learner is the wave learner, without and
            with bagging: byte-equal models.
6. booster  the serving path, part 1: Booster(model_file=...) on the default
            device predicts 1,048,576 rows (auto-streamed in 262,144-row
            chunks); the streamed raw scores equal the CPU Booster's on
            both sides of every chunk boundary; leaf indices on a slice;
            the same rows with prediction early stopping (binary margin,
            pred_early_stop_freq 10, margin 4): the share of rows stopped,
            the trees walked a row and the rows/s beside the full predict's,
            the first rows bit-equal to the CPU Booster's early stop, an
            infinite margin bit-equal to the full prediction.
7. serving  the serving path, part 2: PredictionService + HTTP front with the
            bench's settings, 256 requests of 64 rows from 8 threads, JSON
            and binary wire, every answer bit-equal to Booster.predict.
8. train    the training path, the main one: lightgbm_tpu_torch.train on
            the 1,048,576 x 28 data, binary objective, num_leaves=255,
            max_bin=255, learning_rate=0.1, 10 rounds, with a 65,536-row
            validation set, through the wave learner; seconds per iteration,
            leaves per tree, waves, committed and speculated splits, rows
            histogrammed per tree (at most N * (1 + waves / 2): a wave
            histograms only the smaller children of disjoint leaves), train
            and valid AUC (at --seed 0 within 0.002 of WAVE_AUC_SEED0); the
            model text reloads and predicts equal to the training Booster;
            a tree is one CUDA graph launch (the root, then a WHILE node of
            two waves a pass): tree graph launches, waves run and no-op
            waves a tree, host time a tree, the first iteration in its parts
            (buffer allocation, captures, the first tree); the device-to-
            host copies, their bytes and the host synchronizations of one
            tree, read from a torch.profiler trace (exactly the results' one
            copy and the one wait on its event); the host scopes, the
            device's busy share over one round and the device operations
            (kernels and copies) a wave launches there.
9. serial   the same with feature_fraction_bynode=0.8, through the serial
            learner (at --seed 0 its AUC within 0.002 of SERIAL_AUC_SEED0),
            with the device operations a split of the profiled round. Then
            the tree graph's loop-condition kernel: the main path's last
            tree grown again by its tree graph and by the host's loop on the
            card from the same inputs, split log, scalars and passes equal.
10. multiclass  Covertype's shapes from --seed (581,012 x 54: ten integer
            columns in Covertype's ranges, 4 + 40 one-hot columns that EFB
            bundles, 7 classes at Covertype's shares), multiclass, 255
            leaves, learning_rate 0.1: at 8,192 rows the card's model text
            byte-equal to the CPU's on snapped softmax gradients through both
            learners; then 10 rounds (70 trees) through the wave learner and
            3 with feature_fraction_bynode=0.8 through the serial one, with
            a 65,536-row validation set: train multi_logloss falls every
            round, valid multi_error ends below the majority class's
            (0.512), predicted rows sum to 1 within 1e-6, the model reloads
            and predicts bit-equal and answers 64-row binary-wire requests
            through PredictionService bit-equal to Booster.predict;
            seconds per iteration and per tree.
11. async   the async per-tree pipeline: phase 8's data at learning_rate
            0.125, no metric, no validation set, 10 Booster.update()
            rounds and 10 more (the wave width settled), with the pipeline
            on and off in one process: model text byte-equal and final
            train score bit-equal; each path's seconds per iteration and the
            card's share of the wall in tree graphs (CUDA events) in each
            window, and device-to-host copies and host synchronizations a
            tree over three profiled rounds (the pipeline's: one results
            copy and one wait a tree).
12. quantized  quantized-gradient training (use_quantized_grad,
            num_grad_quant_bins=4, quant_train_renew_leaf): the gradient
            discretizer (csrc/quantize.cu, two launches) against its plain
            version on the card on phase 8's first gradients (1,048,576
            rows; their hessian is constant on the card) and on its
            gradients at its final scores, stochastic and nearest rounding,
            4 and 16 bins and a hessian of ones: int8 rows, sentinel and
            scales bit-equal; the
            split kernel's int32 input on a quantized tree's root and first
            wave's 42 children (run eagerly on the card): records bit-equal
            to the plain version run on the CPU; the leaf and ragged
            histograms' integer modes over every row exactly equal to their
            plain versions; each timed (torch.profiler). Exact: with
            stochastic rounding and bagging 0.8, card and CPU model texts
            byte-equal through the wave and the serial learner, renewal off
            on the binary logloss gradients computed on the host (the card's
            torch.exp is not the CPU's, so the built-in objective's
            gradients differ in the last bit) and renewal on on snapped
            ones, at 16,384 rows (2 rounds), and the same at 8,192 rows of
            Covertype's shapes (7 classes, 63 leaves, 2 rounds). Then phase
            8's data through the wave learner (10 rounds) and the serial one
            (3 rounds, feature_fraction_bynode=0.8), each as phases 8 and 9
            report them, beside their float runs: s/iteration, waves a tree,
            and the valid AUC at most 0.003 below the float run's after as
            many rounds (the JAX package's margin, tests/test_quantized.py);
            the model text's hash, to compare two runs.

13. goss    GOSS (data_sample_strategy=goss, top_rate 0.2, other_rate 0.1)
            on phase 8's data at learning rate 0.1, so rounds 1-10 are its
            warm-up and rounds 11-15 sample: exact first (16,384 rows, 63
            leaves, 8 rounds at learning rate 0.5 on snapped gradients, which the
            multiplier 8 keeps snapped; card and CPU model texts byte-equal
            through both learners), then 15 rounds through the wave learner
            and 13 through the serial one (feature_fraction_bynode=0.8), as
            phases 8 and 9 report them, and for rounds 2-10 and the sampling
            rounds apart: s/iteration, rows in the bag, rows histogrammed and
            waves a tree, the bagging scope's host time in its parts (the
            MT19937 position draw, the selection's enqueue and its card time
            by CUDA events, the out-of-bag set) and the valid AUC. A profiled
            sampling round of the wave learner copies neither the bag's mask
            nor the out-of-bag set to the host (no device-to-host copy of N
            bytes or more; the bag's host indices never made); the selection
            at full width on the card bit-equal to the CPU's and to the host
            path's.
14. categorical  the airline data's shapes from --seed (szilard/benchm-ml,
            ASA Data Expo 2009 dep_delayed_15min: Month 12, DayofMonth 31,
            DayOfWeek 7, UniqueCarrier 22, Origin and Dest 250 Zipf-skewed
            categories, DepTime and Distance numeric; 1,048,576 rows cut
            from 10 M) as a pandas DataFrame with category columns: exact
            first (16,384 rows, 63 leaves, 3 rounds, gradients computed on the host,
            snapped for the float run, whose histograms agree where their sums
            are exact, unsnapped for the quantized one: card and CPU model
            texts byte-equal), then 10 rounds
            through the serial learner (255 leaves, learning rate 0.1,
            max_cat_to_onehot 8, bagging 0.8) with a 65,536-row validation
            set, as phase 9 reports it: one-hot and sorted-subset splits a
            tree (both must occur), valid AUC rising, the train score equal
            to predict(raw_score=True) within 1e-6 on the training rows, the
            model reloaded from its file predicting bit-equal, 64-row
            binary-wire requests bit-equal to Booster.predict, and the
            categorical scan's host and card time a leaf (its record on the
            card bit-equal to the CPU's).
15. lanes   the serial learner's constrained lanes on phase 8's data and
            settings, 5 rounds each: (1) monotone constraints (+1 on feature
            0, -1 on 1, +1 on 21, -1 on 25, the label model's directions),
            interaction constraints [0-7], [8-15], [16-27] and a forced-splits
            JSON (the root on feature 0, its left child on 25): every root on
            feature 0, every path below the forced splits inside one group, a
            monotone sweep of 4,096 sampled rows over 32 grid points a
            constrained feature never stepping against its direction, valid
            AUC rising; (2) CEGB (split, coupled and lazy penalties on all 28
            features): fewer distinct features a tree than phase 8's first 5
            trees; (3) linear trees (linear_lambda 0.01): the train score
            equal to predict(raw_score=True) within 1e-5 on the 1,048,576
            rows, valid AUC rising, every linear score through the
            traversal's leaf mode. Exact first: each run, and run 1
            quantized, at 16,384 rows, 63 leaves, 2 rounds on host gradients,
            card and CPU model texts byte-equal. The split kernel's
            constrained mode bit-equal to its plain version on the root and
            two leaves whose bounds bind, its device time beside the
            unconstrained search's, and the linear score's time at 1,048,576
            rows. Each run prints s/iteration, the scopes find_best_split,
            partition, hist_root, hist_children, forced_splits, cegb_penalty
            and linear_fit, and the busy share and device-to-host copies of
            one more profiled round.
16. life cycle  DART, random forests and the model's life cycle on phase
            8's data through the wave learner. Exact first (16,384 rows, 63
            leaves, 4 rounds; card and CPU model texts byte-equal): DART on
            snapped gradients (drop_rate 0.5, skip_drop 0.2), RF on labels on
            a 1/64 grid whose mean is 1, and a run resumed from a checkpoint
            after round 2 on the card through the serial learner
            (feature_fraction_bynode 0.8). Then at full width: DART with
            LightGBM's defaults (drop_rate 0.1, skip_drop 0.5, max_drop 50),
            10 rounds: valid AUC rising, the train score within 1e-3 of
            predict(raw_score=True), the trees dropped a round, the busy
            share of one more profiled round; RF (bagging 0.5 every round,
            feature_fraction 0.8), 10 rounds: the train score within 1e-5 of
            the mean of the trees' outputs, valid AUC above 0.5; a
            checkpoint after round 5 of 10 at phase 11's settings (the async
            pipeline running), resumed with init_model: model text byte-equal
            and train score bit-equal to the uninterrupted run, the write,
            the load and the resumed rounds timed; refit of phase 8's
            booster on a fresh 1,048,576-row draw (valid AUC within 0.01 of
            the original's) and a rollback of one iteration (the train score
            within 1e-6 of predict); the health guardrail's rollback policy
            (check every 2 rounds, NaN in 5% of the rows' gradients at round
            5, 8 updates): predictions finite. Each run prints its
            s/iteration; the phase its launches per kernel and its seconds.
17. ranking learning to rank at MSLR-WEB30K's shapes from --seed (136
            dense features, labels 0-4 at the release's shares, queries of
            ~120 documents on average and one of 1,251; 524,288 rows cut
            from 3.77 M, and a 65,536-row validation set of its own queries)
            with LightGBM's ranking settings (255 leaves, learning rate 0.1,
            NDCG at 1, 3, 5, 10). Exact first, on 65,536 rows of whole
            queries: the card's lambdarank (plain and position-debiased) and
            rank_xendcg gradients within 1e-5 of the same objectives on the
            CPU (xendcg rtol 1e-5 / atol 1e-7), 2 iterations; on snapped
            lambdarank gradients computed on the host, card and CPU model
            texts byte-equal through both learners (8,192 rows of whole
            queries, 63 leaves, 2 rounds).
            Each objective's gradient step at full width: card time and peak
            memory. Then lambdarank, 10 rounds through the wave learner
            (valid NDCG@10 rising from round 1 to 10) and 3 through the
            serial one; position-debiased lambdarank (10 position ids, a
            document's shown rank), 3 rounds; rank_xendcg, 5 rounds;
            cross_entropy on phase 8's rows with labels in [0, 1], 5 rounds
            (the valid cross entropy falling); LGBMRanker.fit and predict on
            the 65,536-row cut. Each run prints s/iteration (the first
            apart), the valid NDCG@10 by round and the busy share of one
            more profiled round.
18. observe and serve  on phase 8's binned data: 3 wave rounds in a
            telemetry session (telemetry_dir) between two runs without one:
            events.jsonl, trace.json and metrics.prom written and parsed, an
            iteration and a tree_wave event a tree, hbm_high_water_bytes
            equal to torch.cuda.max_memory_allocated, the model text
            byte-equal, s/iteration on and off; perfmodel.attribution of the
            session (fractions sum to 1 within 1e-9, roofline fractions at
            most 1.05); the sync sanitizer over 3 rounds at phase 11's async
            settings and over GOSS's first sampling round at phase 13's (no
            host read and no sync, torch.cuda.set_sync_debug_mode("error")
            armed, in the sync-free scopes tree_device and goss_select; the
            host reads by scope; model texts byte-equal); one round under
            LGBM_TPU_PROFILE, whose trace names the wave's kernels. Then
            PredictionService(replicas=2) with phase 3's HIGGS-profile and
            multiclass models, one a replica: 256 binary-wire requests of 64
            rows from 8 threads over HTTP, each bit-equal to Booster.predict,
            /metrics' request counter 256, /debug/flight answering; a canary
            at fraction 0.25 of a second HIGGS-profile version gets every 4th
            request, is promoted after 4 and answers bit-equal to its
            Booster; predict_fail@1:3 fails 3 requests (HTTP 500, no
            launch) and opens the breaker, which sheds the 4th (HTTP 503
            breaker_open, no launch, answered nowhere else) and after the
            cooldown two half-open probes on the card close it,
            serve_breaker_state on /metrics following each step. No
            dispatch fails and no request is shed outside that window
            (checked after phases 7, 10 and 17 and at the end of 18).
19. façades  262,144 of phase 8's rows written as a TSV with a .weight side
            file, and its valid rows as another: (1) the native parse, timed,
            its first 32,768 rows exactly equal to np.genfromtxt's; (2) cli
            task=train from the text (no device_type: the card; 10 rounds at
            phase 8's settings, save_binary=true), the wave kernels and the
            traversal launched, s/iteration; (3) task=train from the .bin
            cache: the model text byte-equal to (2)'s (its data= line
            apart), and (2)'s byte-equal to engine.train on the parsed
            arrays on the card; (4) task=predict's file equal to
            Booster.predict's values as %.9g; (5) task=convert_model
            compiled with g++, 4,096 rows within rtol 1e-5, atol 1e-7 of
            Booster.predict; (6) task=refit on the valid file byte-equal to
            Booster.refit, the traversal's leaf mode launched; (7) SHAP of
            128 rows on the host, timed, each row's sum within rtol 1e-5,
            atol 1e-6 of the card's raw score; (8) the C API in this process
            through ctypes: DatasetCreateFromFile on the cache,
            BoosterCreate, 3 UpdateOneIter on the card (the wave kernels
            launched), PredictForMat and PredictForCSR bit-equal to
            Booster.predict of the same model, SaveModel and
            CreateFromModelfile round-tripping; (9) a feval on a validation
            set recorded by record_evaluation.
20. stream  single-card streaming on phase 8's rows: (1) ingest: 16
            pushes of 65,536 rows into a RowBlockStore (one through
            push_csr), the finalized plane byte-equal to the whole matrix
            binned under the store's layout, timed; (2) the out-of-core
            learner: LGBM_TPU_HBM_BUDGET of 4 blocks (a quarter of the plane),
            phase 9's settings, 4 rounds: the trees byte-equal to phase 9's
            resident serial model's first 4, then 3 quantized rounds
            byte-equal to the resident serial learner's; s/iteration beside
            phase 9's, the blocks uploaded (cold, prefetched, cache hits),
            the upload bytes equal to stream_block_bytes x blocks + the
            group rows, the copy stream's seconds against the host link's
            bound, the cache's peak at most its 4 blocks, the busy share of
            one more round, the carried mode's launches; (3) the leaf
            histogram's carried mode over the 16 blocks at the root, a
            ~100,000-row and a ~4,000-row leaf, bit-equal to one resident
            call and to the plain fixed-point emulation (the integer mode at
            the root likewise), its time a leaf and a block beside its bound,
            the plain version's and index_add_'s (int32 sums for the integer
            mode, held equal); (4) the flywheel: a
            PredictionService over HTTP serving phase 9's model, 4 client
            threads sending 64-row binary-wire requests throughout, a
            ContinuousTrainer (wave learner, 10 rounds, a 16,384-row holdout
            gate, LGBM_TPU_DRIFT=1 and drift_shift on feature 8 from row
            393,216) over 3 generations of 262,144 rows: no failed request,
            every answer bit-equal to a published generation's
            Booster.predict, the requests' p50 and p99 latency with the
            service alone (a second before and after) and while it trains; the drift alarm latches and generation 1's
            boundary refreshes the bins (layout_generation and the sidecar's
            bin_mapper_generation 1); kill@5 in generation 1, resumed to
            the text of an uninterrupted run; bad_generation@2 rejected by
            the gate and never answering, its retry published; /statz
            carrying drift; (5) the C API through ctypes:
            DatasetCreateStreaming, 4 PushRows and 1 PushRowsByCSR,
            BoosterCreate, 3 UpdateOneIter on the card, SaveModel
            byte-equal to engine.train on a RowBlockStore fed the same
            blocks.
21. distributed  a gang started with the port's launcher code
            (parallel/elastic.py GangSupervisor and worker_env, the script
            itself as each rank: --gang-worker): min(cards, 4) ranks over
            NCCL, or with one card 2 ranks on it over gloo, staged through
            pinned host memory (printed). Each rank builds phase 8's
            1,048,576 x 28 rows from --seed and keeps its shard on its card;
            data-, feature- and voting-parallel (top_k 28) wave learners, 10
            rounds at phase 8's settings, equal to phase 8's single-card
            model (split_gain within 4 ULP) on the real logloss gradients;
            voting at top_k 5 (10 of the 28 features elected a leaf), 5
            rounds, within 0.001 valid AUC of the exact run's after 5; the
            host-driven data-parallel learner at phase 9's settings, 4
            rounds, equal to phase 9's first 4 trees; quantized
            data-parallel equal to phase 12's; row-sharded
            predict of the 1M rows and a service loaded with shard_rows
            bit-equal to Booster.predict; `launch -n 2 -- <cli args>
            tree_learner=data` writing the in-process gang's model. Prints
            each learner's s/iteration beside phase 8's (9's), the wire's
            bytes a wave from perfmodel.py beside those counted at the
            collectives, the collectives' share of a run (host wall around
            the calls, each synchronized in a measured run) and the launches
            a kernel over the ranks. Phase 4 holds the ragged kernel's image
            mode, the leaf kernel's and the conversion kernel against their
            plain versions (with +inf, -inf and NaN gradients among the
            rows) and times them.
22. elastic  the gang's failure handling, on phase 21's 65,536-row CLI
            text file (5 rounds, a snapshot every iteration): (a) `launch
            -n 2 --elastic` with worker_kill@1:3: rank 1 exits 43, the gang
            is reaped and relaunched once from rank 0's snapshot, the model
            byte-equal to phase 21's undisturbed `launch -n 2` model, a
            gang_worker_lost flight dump naming rank 1, gang_recovery_ms
            printed; (b) the same with worker_hang@1:3, the collective
            watchdog's deadline and `--liveness-timeout`: the gang reaped by
            exit 117 (or a liveness loss), the relaunched model byte-equal;
            (c) `allow_shrink` from 2 ranks to 1 (the script itself as each
            rank: --elastic-worker) on quantized data-parallel at phase 12's
            settings, rank 1 killed at iteration 2, the one rank resuming
            from rank 0's snapshot: byte-equal to phase 12's model. Run by
            phase 21's gang: (d) the data-parallel run (5 rounds) with the
            elastic heartbeat every iteration and the sanitizer's
            collective-order check at each, the heartbeats and the checks
            counted, s/iteration beside phase 21's data run, the trees
            phase 8's;
            (e) phase 20's streamed runs (16 blocks of 65,536 rows, a
            4-block budget a rank) with tree_learner=data through the
            gang-sharded streamed learner, float (3 rounds) and quantized:
            the trees phase 20's, the carried kernel launched on every
            rank, no rank uploading a block it does not own, the bytes
            counted at the collectives perfmodel's, s/iteration and the
            uploads a rank. Phase 20's kernels hold two open carries over
            alternate blocks, added and converted once, bit-equal to one
            resident call.

Bounds: each kernel's bytes and operations come from
lightgbm_tpu_torch/perfmodel.py's formula for its row of PERF.md's table,
over the card's peak rates in the same module. The library call of the
leaf and ragged histograms is index_add_ over the flat bin index.

The Booster surface: after phase 8, dump_model parses and its leaf values
and thresholds equal the model text's, feature_importance ("split" and
"gain") equals the CPU Booster's loaded from the text, lower_bound and
upper_bound are printed; in phase 11 a third pair of runs with
callback.reset_parameter halving the rate after 10 rounds, pipeline on and
off, has a byte-equal model text and a bit-equal final train score.

The launch counters are set to 0 just before phase 6 and read just after
phase 7 (the serving and predict paths, prediction early stopping's
accumulate mode included), and again just before and after each of phases
8, 9, 10 and 11, of phase 12's two full-width runs and of the full-width runs
of phases 13, 14, 15, 16 and 17 (the training paths), of phases 18 and 19 and
of phase 20's streamed runs (float and quantized), flywheel and C API, on
each rank of phase 21's gang around each of its runs (phase 22's (d) and
(e) among them) and around phase 22 (c)'s resumed run: every
kernel of each path must
have launched there; across phase 12 the discretizer and the integer modes
of the ragged and leaf histograms and of the split kernel. The last three lines are the kernels' JSON record, the card's name
and power limit as nvidia-smi gives them, and {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile-of DIR

times the leaf histogram of the package in checkout DIR (an older commit
unpacked with git archive) at the root and the two leaves of phase 4, and
profiles one round of each learner on the same data: busy share, device
operations a wave or a split, host scopes; for a comparison in one call.
It prints no result line.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import inspect
import itertools
import json
import os
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from lightgbm_tpu_torch import perfmodel

DEVICE = "cuda"
# the card the bounds are for (torch.cuda.get_device_name, set in main):
# its peak rates come from lightgbm_tpu_torch/perfmodel.py's table
CARD_KIND = "NVIDIA H100 80GB HBM3"
HIGGS = dict(n_features=28, n_iterations=500, num_leaves=255)
SAMPLE_ROWS = 65_536
MAIN_ROWS = 1_048_576
SERVE_REQUESTS, SERVE_ROWS, SERVE_THREADS = 256, 64, 8
SERVE_BATCHES = (64, 512, 4096)  # one request, a few coalesced, a full batch
# the training path: HIGGS width (bench.py:7-13) with per-node sampling
TRAIN_ROWS, VALID_ROWS, LEAF_ROWS = 1_048_576, 65_536, 100_000
SMALL_LEAF_ROWS = 4_000  # a typical serial leaf: 1,048,576 rows over 255 leaves
# the exact card = CPU runs of phases 5, 12, 13, 15 and 16 (32,768 rows and
# 2 rounds since phase 17 came, 16,384 rows since phase 21: their CPU halves
# are most of the smoke's time)
TRAIN_ROUNDS, EXACT_ROWS, EXACT_ROUNDS = 10, 16_384, 2
SERIAL_ROUNDS = 10  # the serial learner's path, after the wave learner's
TRAIN_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
                "learning_rate": 0.1, "feature_fraction_bynode": 0.8,
                "metric": "auc", "verbosity": -1}
SCAN_PARAMS = [0.0, 0.0, 20.0, 1e-3, 0.0, 0.0]  # TRAIN_PARAMS' regularizers
# the main path: the HIGGS parameters without per-node sampling, which the
# wave learner grows
WAVE_PARAMS = {k: v for k, v in TRAIN_PARAMS.items() if k != "feature_fraction_bynode"}
WAVE_K, SLOT_SLOTS = 21, 4  # the wave learner's default width; histogram_slots' slots
GROUP_BINS = 256  # every value a uint8 group bin takes
# train / valid AUC of the 10 wave-learner rounds at --seed 0 when the wave
# histogram sums in float32; summed in fixed point they stay within 0.002
WAVE_AUC_SEED0 = (0.74877, 0.74533)
# train / valid AUC of the 10 serial-learner rounds at --seed 0 when the
# dense histogram sums in float32 (the parent's kernel); summed in fixed
# point they stay within 0.002
SERIAL_AUC_SEED0 = (0.74867, 0.74533)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    from lightgbm_tpu_torch.fingerprint import card_identity

    line = card_identity()
    check(line is not None, "nvidia-smi did not report the card's name and power limit")
    return line


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after one warm-up
    call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def leaf_depths(trees, device) -> torch.Tensor:
    """[T, L] depth of every leaf (0 for a constant tree)."""
    L = max(t.num_leaves for t in trees)
    depth = np.zeros((len(trees), L), dtype=np.int64)
    for k, t in enumerate(trees):
        if t.num_leaves > 1:
            depth[k, :t.num_leaves] = t.leaf_depth[:t.num_leaves]
    return torch.from_numpy(depth).to(device)


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound(cost):
    """The least time the card could take for a kernel's (bytes,
    operations), a perfmodel.py formula's: bytes over the memory rate or
    float32 operations over the peak rate, whichever is larger (ms, and
    which)."""
    from lightgbm_tpu_torch import perfmodel

    b = perfmodel.bound_ms(*cost, CARD_KIND)
    check(b is not None, f"perfmodel.py has no peak rates for {CARD_KIND!r}")
    return b


def higgs_rows(seed: int, n: int):
    """HIGGS-shaped rows from a seed: 28 dense features (momenta-like
    positive skewed columns, angle-like symmetric and uniform ones, a few
    tagging columns of four values) and a binary label drawn from a fixed
    logistic function of them plus noise."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, 28), dtype=np.float32)
    X[:, 0:8] = rng.exponential(1.0, size=(n, 8))
    X[:, 8:16] = rng.normal(size=(n, 8))
    X[:, 16:21] = rng.uniform(-np.pi, np.pi, size=(n, 5))
    X[:, 21:25] = rng.randint(0, 4, size=(n, 4))
    X[:, 25:28] = rng.gamma(2.0, 0.5, size=(n, 3))
    f = (0.8 * X[:, 0] - 0.6 * X[:, 1] + 0.5 * X[:, 8] * X[:, 9]
         + 0.4 * np.sin(X[:, 16]) + 0.3 * X[:, 21] - 0.7 * X[:, 25]
         + 0.2 * X[:, 10] ** 2 - 0.5)
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-f - rng.normal(0, 0.5, n)))).astype(np.float64)
    return X, y


def snapped_logloss(preds, dataset):
    """Binary logloss gradients snapped to a 2**-4 grid: with |g| <= 1 and
    at most 2**16 rows every histogram sum is exact in float32, so the card
    and the CPU see the same bits whatever order they sum in."""
    p = 1.0 / (1.0 + np.exp(-preds))
    grad = np.round((p - dataset.get_label()) * 16) / 16
    hess = np.round(np.maximum(p * (1.0 - p), 1.0 / 16) * 16) / 16
    return grad, hess


# UCI Covertype (Blackard 1998; covtype.info): 581,012 rows, 10 integer
# columns in these ranges, 4 wilderness and 40 soil indicator columns, and
# the rows of each of the 7 cover types
COVTYPE_ROWS = 581_012
COVTYPE_RANGES = ((1859, 3858), (0, 360), (0, 66), (0, 1397), (-173, 601), (0, 7117),
                  (0, 255), (0, 255), (0, 255), (0, 7173))
COVTYPE_CLASS_ROWS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
COVTYPE_MAJORITY_ERROR = 1.0 - max(COVTYPE_CLASS_ROWS) / COVTYPE_ROWS  # 0.5124
MC_VALID_ROWS, MC_ROUNDS, MC_SERIAL_ROUNDS = 65_536, 10, 3
MC_EXACT_ROWS, MC_EXACT_ROUNDS, MC_EXACT_LEAVES = 8_192, 2, 63
MC_PARAMS = {"objective": "multiclass", "num_class": 7, "num_leaves": 255, "max_bin": 255,
             "learning_rate": 0.1, "metric": "multi_logloss,multi_error",
             "is_provide_training_metric": True, "verbosity": -1}
# the async pipeline's phase: the main path's settings at a learning rate
# exact in float32, no metric and no validation set; ASYNC_ROUNDS rounds,
# then as many more, timed apart, once the wave width has settled
ASYNC_ROUNDS = 10
ASYNC_PARAMS = {**{k: v for k, v in TRAIN_PARAMS.items() if k != "feature_fraction_bynode"},
                "learning_rate": 0.125, "metric": "None"}


def covertype_rows(seed: int, n: int):
    """Covertype-shaped rows from a seed: the 10 continuous columns as
    integers in Covertype's ranges (elevation, aspect, slope, four
    distances, three hillshades), one-hot wilderness (4) and soil (40)
    columns, which EFB bundles, and 7 classes at Covertype's shares, drawn
    from a fixed function of the features plus noise (per-class linear
    logits of the standardized continuous columns and of the area and soil
    types, Gumbel noise, the classes' offsets set so their shares match)."""
    rng = np.random.RandomState(seed)
    cols = [rng.normal(2959, 280, n), rng.uniform(0, 360, n), rng.normal(14, 7.5, n),
            rng.exponential(270, n), rng.normal(46, 58, n), rng.exponential(2350, n),
            rng.normal(212, 27, n), rng.normal(223, 20, n), rng.normal(143, 38, n),
            rng.exponential(1980, n)]
    cont = np.stack([np.clip(np.round(c), lo, hi) for c, (lo, hi) in zip(cols, COVTYPE_RANGES)],
                    axis=1)
    area = rng.choice(4, n, p=[0.45, 0.05, 0.44, 0.06])
    soil = rng.choice(40, n, p=rng.dirichlet(np.full(40, 0.6)))
    X = np.zeros((n, 54), dtype=np.float32)
    X[:, :10] = cont
    X[np.arange(n), 10 + area] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    f = np.random.RandomState(12345)  # the label function, fixed across seeds
    z = (cont - cont.mean(axis=0)) / cont.std(axis=0)
    logits = (z @ f.normal(0, 1.0, (10, 7)) + f.normal(0, 1.0, (4, 7))[area]
              + f.normal(0, 1.0, (40, 7))[soil] + rng.gumbel(0, 0.5, (n, 7)))
    want = np.asarray(COVTYPE_CLASS_ROWS, dtype=np.float64) / COVTYPE_ROWS
    offset = np.zeros(7)
    for _ in range(40):
        share = np.bincount(np.argmax(logits + offset, axis=1), minlength=7) / n
        offset += np.log(want / np.maximum(share, 1e-6))
    return X, np.argmax(logits + offset, axis=1).astype(np.float64)


def snapped_softmax(preds, dataset):
    """Softmax gradients snapped to a 2**-4 grid, class-major as the fobj
    path reshapes them: every histogram sum is exact, so the card and the
    CPU see the same bits."""
    p = np.exp(preds - preds.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    onehot = np.eye(preds.shape[1])[dataset.get_label().astype(int)]
    grad = np.round((p - onehot) * 16) / 16
    factor = preds.shape[1] / (preds.shape[1] - 1.0)
    hess = np.round(np.maximum(factor * p * (1.0 - p), 1.0 / 16) * 16) / 16
    return grad.T.ravel(), hess.T.ravel()


def leaf_gradients(rng, n_rows, dev):
    """gh_ext [N+1, 3] float32 (real and grid-snapped) and int8 on the card,
    each with its zero sentinel row."""
    raw = np.stack([rng.normal(0, 0.3, n_rows), rng.uniform(0.05, 0.25, n_rows),
                    np.ones(n_rows)], axis=1)
    snapped = np.round(np.clip(raw, -0.9, 0.9) * 16) / 16
    ext = lambda a: torch.from_numpy(np.concatenate(  # noqa: E731
        [a, np.zeros((1, 3))]).astype(np.float32)).to(dev)
    q = torch.from_numpy(np.concatenate([rng.randint(-127, 128, (n_rows, 3)),
                                         np.zeros((1, 3))]).astype(np.int8)).to(dev)
    return ext(raw), ext(snapped), q


def leaf_sets(rng, n_rows, dev):
    """The serial learner's row sets at three sizes, as RowPartition holds
    them: {name: (row_idx [P] on the card, count)}, sorted rows padded with
    the sentinel to their bucket: the root (every row), a LEAF_ROWS leaf, a
    SMALL_LEAF_ROWS leaf, and the LEAF_ROWS leaf's count of consecutive rows
    (the gather's cost apart)."""
    from lightgbm_tpu_torch.ops.partition import bucket_size

    def padded(rows):
        idx = np.full(bucket_size(len(rows)), n_rows, np.int32)
        idx[:len(rows)] = rows
        return torch.from_numpy(idx).to(dev), len(rows)

    sets = {"root": padded(np.arange(n_rows))}
    for name, k in (("leaf", LEAF_ROWS), ("small", SMALL_LEAF_ROWS)):
        sets[name] = padded(np.sort(rng.choice(n_rows, k, replace=False)))
    sets["leaf_contiguous"] = padded(np.arange(LEAF_ROWS) + n_rows // 3)
    return sets


def index_add_ms(bins, gh, rows, slots, n_slots, num_bins, want, reps=10):
    """The one PyTorch call that computes a histogram's sums: index_add_ of
    each (row, group)'s gh into its flat (group, bin[, slot]) cell, in no
    fixed order, over the index and the gh rows expanded beforehand; held to
    the kernel's result `want` within the float32 summation bound, or, for
    integer gh (the quantized mode), summed in int32 and held equal to it.
    Returns its ms a call (CUDA events)."""
    G = bins.shape[0]
    rows = rows.to(torch.int64)
    cell = (bins[:, rows].to(torch.int64)
            + torch.arange(G, device=bins.device)[:, None] * num_bins)
    if slots is not None:
        cell = cell * n_slots + slots[rows].to(torch.int64)[None]
    idx = cell.reshape(-1)
    exact = not gh.is_floating_point()
    dtype = torch.int32 if exact else torch.float32
    src = gh[rows][None].expand(G, -1, -1).reshape(-1, gh.shape[1]).to(dtype)
    size = G * num_bins * n_slots

    def call(values=src):
        return torch.zeros((size, gh.shape[1]), dtype=dtype,
                           device=bins.device).index_add_(0, idx, values)

    got = call().view_as(want)
    if exact:
        check(torch.equal(got, want), "index_add_: differs from the kernel's integer histogram")
    else:
        err = (got.double() - want.double()).abs()
        check(bool((err <= rows.numel() * 2.0 ** -24 * call(src.abs()).view_as(want).double()
                    + 1e-30).all()),
              "index_add_: outside the float32 summation bound of the kernel's histogram")
    ms = cuda_ms(call, reps)
    del idx, src, cell
    torch.cuda.empty_cache()
    return ms


def check_histogram(dev, bins, n_rows, num_bins, seed):
    """The leaf-histogram kernel against its plain versions at the serial
    learner's shapes: the root, a ~100,000-row and a ~4,000-row leaf (leaf
    _sets), each read to its count with the fixed-point exponents computed
    once beforehand, as the learner calls it. Bit-equal to the plain
    emulation of its fixed-point sum run on the CPU, equal to the plain
    version on snapped gradients and in the integer mode and within its
    float32 summation bound otherwise, two launches bit-equal; the identity
    row set (no index) equal to the root's. The plain version runs on the
    CPU, whose sums are sequential, and is timed on the card. Returns (max
    |kernel - plain| on unsnapped gradients, timings, bounds, the gradients
    and the LEAF_ROWS leaf's rows on the card)."""
    from lightgbm_tpu_torch.ops import hist_cuda
    from lightgbm_tpu_torch.ops.histogram import (_build_histogram_plain,
                                                  _build_histogram_rows_fixed,
                                                  _build_histogram_rows_plain,
                                                  fixed_point_exponents)

    rng = np.random.RandomState(seed)
    G = bins.shape[0]
    gh, gh_snap, q = leaf_gradients(rng, n_rows, dev)
    sets = leaf_sets(rng, n_rows, dev)
    exps = fixed_point_exponents(gh, n_rows)
    check(torch.equal(exps.cpu(), fixed_point_exponents(gh.cpu(), n_rows)),
          "histogram: the card's fixed-point exponents differ from the CPU's")
    bins_h, gh_h = bins.cpu(), gh.cpu()
    max_err, timings, bounds = 0.0, {}, {}
    out_bytes = G * num_bins * 3 * 4
    for name, (idx, count) in sets.items():
        idx_h = idx.cpu()

        def kern(values, e=None, i=idx, c=count):
            return hist_cuda.histogram(bins, values, i, num_bins, c, e)

        def plain(values, i=idx_h, c=count):
            return _build_histogram_rows_plain(bins_h, values.cpu(), i, num_bins, c)

        check(torch.equal(kern(gh_snap).cpu(), plain(gh_snap)),
              f"histogram {name}: differs from the plain version on snapped gradients")
        got, again = kern(gh, exps), kern(gh)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"histogram {name}: two launches differ (exponents passed / computed)")
        got = got.cpu()
        fixed = _build_histogram_rows_fixed(bins_h, gh_h, idx_h, num_bins, exps.cpu(), count)
        check(torch.equal(got.view(torch.int32), fixed.view(torch.int32)),
              f"histogram {name}: differs from the plain fixed-point emulation")
        ref = plain(gh)
        err = (got.double() - ref.double()).abs()
        check(bool((err <= count * 2.0 ** -24 * plain(gh.abs()).double()).all()),
              f"histogram {name}: outside the float32 summation bound")
        check(torch.equal(kern(q).cpu(), plain(q)), f"histogram {name}: integer mode differs")
        max_err = max(max_err, float(err.max()))
        timings[name] = cuda_ms(lambda k=kern: k(gh, exps), 20)
        # the kernel's own device time, and the call's device events
        # (zeroing, kernel, conversion): back to back, a small leaf's calls
        # are host-bound and CUDA events time the wrapper
        timings[name + "_device"] = kernel_device_ms(lambda k=kern: k(gh, exps), 20,
                                                     "hist_rows_kernel")
        timings[name + "_events"] = call_device_ms(lambda k=kern: k(gh, exps), 20)
        timings["plain_" + name] = cuda_ms(
            lambda i=idx, c=count: _build_histogram_rows_plain(bins, gh, i, num_bins, c), 3)
        # each input read once over the leaf's rows (bins, gh, the index),
        # the output written once
        bounds[name] = bound(perfmodel.hist_rows(count, G, out_bytes))
        if name == "root":
            timings["library_root"] = index_add_ms(bins, gh, idx[:count], None, 1,
                                                   num_bins, kern(gh, exps))
    root_idx, root_count = sets["root"]
    check(torch.equal(hist_cuda.histogram(bins, gh[:n_rows], None, num_bins).cpu(),
                      hist_cuda.histogram(bins, gh, root_idx, num_bins, root_count,
                                          exps).cpu()),
          "histogram: the identity row set differs from the root's index set")
    timings["plain_root_identity"] = cuda_ms(
        lambda: _build_histogram_plain(bins, gh[:n_rows], num_bins), 3)
    return max_err, timings, bounds, (gh, sets["leaf"][0])


def record_serial_splits(lt, train_set, params):
    """Copies of the inputs of three real splits of one serial round (the
    root's, and those whose leaves come nearest LEAF_ROWS and
    SMALL_LEAF_ROWS rows), kept from lt.train with RowPartition.split
    wrapped: {name: (bins_row, row_idx, count, decision, n_data)}."""
    from lightgbm_tpu_torch.ops import partition as pmod

    kept = {}
    split = pmod.RowPartition.split

    def record(self, leaf, new_leaf, bins_row, decision, cat_mask=None):
        cnt = self.leaf_count[leaf]
        item = (bins_row.clone(), self.leaf_idx[leaf].clone(), cnt, tuple(decision),
                self.num_data)
        kept.setdefault("root", item)
        for name, target in (("leaf", LEAF_ROWS), ("small", SMALL_LEAF_ROWS)):
            if name not in kept or abs(cnt - target) < abs(kept[name][2] - target):
                kept[name] = item
        return split(self, leaf, new_leaf, bins_row, decision, cat_mask)

    pmod.RowPartition.split = record
    try:
        lt.train(dict(params), train_set, num_boost_round=1)
    finally:
        pmod.RowPartition.split = split
    check(set(kept) == {"root", "leaf", "small"}, f"recorded only {sorted(kept)}")
    return kept


def _parent_split(bins_row, idx, cnt, decision, n_data, min_bucket=256):
    """The parent's RowPartition.split (its ops/partition.py:81-149): the
    decision on each row of the padded set, a stable argsort on a 3-way key,
    the sync, then each child's padded buffer. Returns (left, right, left
    count)."""
    from lightgbm_tpu_torch.ops.partition import bucket_size, split_decision_bins

    P = idx.shape[0]
    dev = idx.device
    valid = torch.arange(P, dtype=torch.int32, device=dev) < cnt
    gb = bins_row[torch.clamp(idx, max=n_data - 1).to(torch.int64)]
    go_left = split_decision_bins(gb, decision) & valid
    key = torch.where(go_left, 0, torch.where(valid, 1, 2)).to(torch.int32)
    order = torch.argsort(key, stable=True)
    sorted_idx = torch.where(valid, idx[order], n_data)
    left_cnt = int(go_left.sum())
    right_cnt = cnt - left_cnt
    lp, rp = bucket_size(left_cnt, min_bucket), bucket_size(right_cnt, min_bucket)
    left = torch.where(torch.arange(lp, device=dev) < left_cnt, sorted_idx[:lp], n_data)
    padded = torch.cat([sorted_idx, torch.full((rp,), n_data, dtype=sorted_idx.dtype,
                                               device=dev)])
    right = torch.where(torch.arange(rp, device=dev) < right_cnt,
                        padded[left_cnt:left_cnt + rp], n_data)
    return left.to(torch.int32), right.to(torch.int32), left_cnt


def check_row_partition(dev, kept):
    """The serial learner's partition kernels (decide, scatter) against
    their plain version run on the CPU on three real splits: both children's
    buffers and the left count exactly equal, two launches equal, and
    RowPartition.split's children equal to the parent's op sequence's. Timed
    as the learner calls it (RowPartition.split: the table, the launches,
    the one sync, the children) beside the parent's sequence: device ms a
    call (torch.profiler, the device's own events) and host ms a call.
    Returns (timings, bounds, {name: (count, P, left count)})."""
    from lightgbm_tpu_torch.ops import partition_cuda
    from lightgbm_tpu_torch.ops.partition import (RowPartition, _split_rows_plain,
                                                  go_left_table)

    timings, bounds, shapes = {}, {}, {}
    for name, (bins_row, idx, cnt, decision, n) in kept.items():
        table = go_left_table(decision)
        got = partition_cuda.split_rows(bins_row, idx, cnt, table, n)
        again = partition_cuda.split_rows(bins_row, idx, cnt, table, n)
        torch.cuda.synchronize()
        ref = _split_rows_plain(bins_row.cpu(), idx.cpu(), cnt, table, n)
        for what, g, a, r in zip(("left", "right", "n_left"), got, again, ref):
            check(g.dtype == r.dtype and g.shape == r.shape and torch.equal(g.cpu(), r),
                  f"row partition ({name}): {what} differs from the plain version")
            check(torch.equal(a, g), f"row partition ({name}): two launches differ in {what}")
        part = RowPartition(1, dev)

        def this(p=part, b=bins_row, i=idx, c=cnt, d=decision, n=n):
            p.num_data, p.leaf_idx, p.leaf_count = n, {0: i}, {0: c}
            p.split(0, 1, b, d)
            return p.leaf_idx[0], p.leaf_idx[1], p.leaf_count[0]

        def parent(b=bins_row, i=idx, c=cnt, d=decision, n=n):
            return _parent_split(b, i, c, d, n)

        mine, theirs = this(), parent()
        check(mine[2] == theirs[2] and torch.equal(mine[0], theirs[0])
              and torch.equal(mine[1], theirs[1]),
              f"row partition ({name}): RowPartition.split differs from the parent's")
        reps = 20
        busy = {k: device_busy_share(lambda f=f: [f() for _ in range(reps)])
                for k, f in (("this", this), ("parent", parent))}
        timings[name] = {
            "passes": device_kernel_ms(this, 10, ("row_decide_kernel",
                                                  "row_scatter_kernel")) or {},
            "device": call_device_ms(this, reps),
            "parent_device": call_device_ms(parent, reps),
            "ops": None if busy["this"] is None else busy["this"][3] / reps,
            "parent_ops": None if busy["parent"] is None else busy["parent"][3] / reps,
            "host": host_ms(this, reps), "parent_host": host_ms(parent, reps),
            "plain": cuda_ms(lambda: _split_rows_plain(bins_row, idx, cnt, table, n), 5),
        }
        # the library call: a stable argsort of the rows' side flags (the
        # left rows first, each side in the leaf's order), the flags made
        # beforehand
        side = torch.from_numpy(table).to(dev)[bins_row[idx[:cnt].to(torch.int64)]
                                               .to(torch.int64)]
        order = torch.argsort(side.logical_not().to(torch.int8), stable=True)
        n_left = int(ref[2])
        check(torch.equal(idx[:cnt][order][:n_left].cpu(), ref[0][:n_left]),
              f"row partition ({name}): the stable argsort's left rows differ")
        timings[name]["library"] = cuda_ms(
            lambda: torch.argsort(side.logical_not().to(torch.int8), stable=True), 20)
        P = idx.shape[0]
        tiles = -(-cnt // partition_cuda.TILE)
        bounds[name] = {  # each input read once, each output written once
            # the index and a bin byte in, a bit and the tile's count out
            "decide": bound(perfmodel.row_partition_decide(cnt, tiles)),
            # the index, the bits and the counts in, both children out
            "scatter": bound(perfmodel.row_partition_scatter(cnt, tiles, P)),
        }
        shapes[name] = (cnt, P, int(ref[2]))
    return timings, bounds, shapes


def check_split_scan(dev, ds, bins, num_bins, gh, idx):
    """The split-scan kernel against its plain version run on the CPU on the
    same real leaf histograms (the root and the leaf), with and without a
    feature mask: every field equal, the gain within 4 ULP of the un-shifted
    gain. Returns (max |gain difference|, timings, bound)."""
    from lightgbm_tpu_torch.ops import hist_cuda, scan_cuda
    from lightgbm_tpu_torch.ops import split as ts

    meta_d = ts.make_feature_meta(ds, num_bins, dev)
    meta_h = ts.make_feature_meta(ds, num_bins, "cpu")
    F = len(meta_h.real_feature)
    params_d = torch.tensor(SCAN_PARAMS, device=dev)
    params_h = torch.tensor(SCAN_PARAMS)
    mask = np.random.RandomState(5).rand(F) < 0.8
    max_err = 0.0
    for name, rows in (("root", None), ("leaf", idx)):
        hist = hist_cuda.histogram(bins, gh if rows is not None else gh[:-1], rows,
                                   num_bins)
        tot = hist[0].sum(dim=0)
        fh = ts.gather_feature_hist(hist, meta_d, tot)
        for m in (None, mask):
            rec = scan_cuda.split_scan(
                fh, tot, meta_d, params_d,
                None if m is None else torch.from_numpy(m).to(dev)).cpu()
            ref = ts._per_feature_best_plain(fh.cpu(), tot.cpu(), meta_h, params_h,
                                             None if m is None else torch.from_numpy(m))
            what = f"split scan {name}{' masked' if m is not None else ''}"
            check(torch.equal(rec[:, 1:], ref[:, 1:]), f"{what}: records differ")
            finite = torch.isfinite(ref[:, 0])
            check(torch.equal(torch.isfinite(rec[:, 0]), finite), f"{what}: gains differ")
            shift = ts.leaf_gain(tot[0].cpu(), tot[1].cpu(), *params_h[[0, 1, 5]])
            ulp = torch.from_numpy(np.spacing(
                np.abs((ref[:, 0] + shift).numpy()).astype(np.float32)))
            d = (rec[:, 0] - ref[:, 0]).abs()[finite]
            check(bool((d <= 4 * ulp[finite]).all()), f"{what}: gain beyond 4 ULP")
            check(bool((rec[:, 1] >= 0).any()), f"{what}: no feature has a split")
            max_err = max(max_err, float(d.max()) if d.numel() else 0.0)
    mask_d = torch.from_numpy(mask).to(dev)
    timings = {
        "kernel": cuda_ms(lambda: scan_cuda.split_scan(fh, tot, meta_d, params_d, mask_d), 50),
        "kernel_device": kernel_device_ms(
            lambda: scan_cuda.split_scan(fh, tot, meta_d, params_d, mask_d), 20, "split_kernel"),
        "plain": cuda_ms(lambda: ts._per_feature_best_plain(fh, tot, meta_d, params_d,
                                                            mask_d), 10),
    }
    B = meta_h.max_bins
    return max_err, timings, bound(perfmodel.split_scan(F, B)), F, B


def half_ranges(rng, n_rows, k):
    """k disjoint row ranges covering about half the rows, as a wave's
    smaller children do: the first half of each of k random segments."""
    cuts = np.sort(rng.choice(np.arange(1, n_rows), k - 1, replace=False))
    edges = np.concatenate([[0], cuts, [n_rows]])
    starts = edges[:-1]
    return starts.astype(np.int32), (starts + np.diff(edges) // 2).astype(np.int32)


def check_wave_histogram(dev, bins, n_rows, num_bins, seed):
    """The ragged (wave) histogram kernel against its plain version run on
    the CPU: at the root (one range over every row) and on WAVE_K disjoint
    ranges covering about half the rows, each row of range k carrying slot
    k, gh read in place from the wave learner's [N, 5] payload; both again
    with every row in bin 0 (the dominant-bin case). Exact on snapped
    gradients and in the integer mode, within the float32 summation bound
    otherwise and bit-equal there to the plain emulation of the kernel's
    fixed-point sum, two launches bit-equal; then histogram_slots on a
    sample. Timed as the wave learner calls it, with the fixed-point
    exponents computed once beforehand. Returns (max |d|, timings, bounds,
    the wave case's histogram, the root's)."""
    from lightgbm_tpu_torch.ops import hist_cuda
    from lightgbm_tpu_torch.ops.histogram import (_histogram_slots_ragged_fixed,
                                                  _histogram_slots_ragged_plain,
                                                  fixed_point_exponents, histogram_slots)

    rng = np.random.RandomState(seed)
    G = bins.shape[0]
    raw = np.stack([rng.normal(0, 0.3, n_rows), rng.uniform(0.05, 0.25, n_rows),
                    np.ones(n_rows)], axis=1)
    payload = {"real": raw, "snapped": np.round(np.clip(raw, -0.9, 0.9) * 16) / 16,
               "quantized": rng.randint(-127, 128, size=(n_rows, 3))}
    payload = {k: torch.from_numpy(np.concatenate(
        [v, np.zeros((n_rows, 2))], axis=1).astype(np.float32)) for k, v in payload.items()}
    pay_d = {k: v.to(dev) for k, v in payload.items()}
    starts, ends = half_ranges(rng, n_rows, WAVE_K)
    slot = np.full(n_rows, WAVE_K, np.int32)
    for k in range(WAVE_K):
        slot[starts[k]:ends[k]] = k
    root = (np.zeros(n_rows, np.int32), np.array([0], np.int32), np.array([n_rows], np.int32))
    zeros = torch.zeros_like(bins)
    cases = {"root": (bins, *root), "wave": (bins, slot, starts, ends),
             "dominant_root": (zeros, *root), "dominant_wave": (zeros, slot, starts, ends)}
    exps = fixed_point_exponents(payload["real"][:, :3], n_rows)
    exps_d = exps.to(dev)
    check(torch.equal(fixed_point_exponents(pay_d["real"][:, :3], n_rows).cpu(), exps),
          "ragged histogram: the card's fixed-point exponents differ from the CPU's")
    max_err, kept, timings, bounds = 0.0, {}, {}, {}
    out_bytes = G * num_bins * 3 * 4
    for name, (bins_d, sl, st, en) in cases.items():
        K = len(st)
        bins_h = bins_d.cpu()
        args_h = [torch.from_numpy(a) for a in (sl, st, en)] + [torch.ones(K, dtype=torch.bool)]
        args_d = [a.to(dev) for a in args_h]

        def kern(mode, a=args_d, K=K, b=bins_d, e=None):
            return hist_cuda.histogram_ragged(b, pay_d[mode][:, :3], *a, num_bins, K,
                                              mode == "quantized", exponents=e)

        def plain(mode, a=args_h, K=K, b=bins_h, values=None):
            v = payload[mode] if values is None else values
            return _histogram_slots_ragged_plain(b, v[:, :3], *a, num_bins, K,
                                                 mode == "quantized")

        check(torch.equal(kern("snapped").cpu(), plain("snapped")),
              f"ragged histogram {name}: differs from the plain version on snapped gradients")
        got, again = kern("real"), kern("real")
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"ragged histogram {name}: two launches differ")
        got = got.cpu()
        ref = plain("real")
        err = (got.double() - ref.double()).abs()
        rows = int((en - st).sum())
        check(bool((err <= rows * 2.0 ** -24 * plain("real", values=payload["real"].abs())
                    .double()).all()),
              f"ragged histogram {name}: outside the float32 summation bound")
        check(torch.equal(got, _histogram_slots_ragged_fixed(
                  bins_h, payload["real"][:, :3], *args_h, num_bins, K, exps)),
              f"ragged histogram {name}: differs from the plain fixed-point emulation")
        check(torch.equal(kern("quantized").cpu(), plain("quantized")),
              f"ragged histogram {name}: integer mode differs")
        max_err = max(max_err, float(err.max()))
        if name in ("root", "wave"):
            kept[name] = kern("real")
        timings[name] = cuda_ms(lambda k=kern: k("real", e=exps_d), 20)
        timings["scaling_" + name] = cuda_ms(lambda k=kern: k("real"), 20)
        timings["plain_" + name] = cuda_ms(
            lambda a=args_d, K=K, b=bins_d: _histogram_slots_ragged_plain(
                b, pay_d["real"][:, :3], *a, num_bins, K), 2)
        # each input read once over the rows in the ranges, the output written
        bounds[name] = bound(perfmodel.hist_ragged(rows, G, K, out_bytes))
        if name == "wave":
            in_ranges = torch.cat([torch.arange(int(a), int(b), device=dev)
                                   for a, b in zip(st, en)])
            timings["library_wave"] = index_add_ms(
                bins_d, pay_d["real"][:, :3], in_ranges, args_d[0], K, num_bins,
                kern("real", e=exps_d))
    # histogram_slots: every row, SLOT_SLOTS slots, on a sample
    n, S = SAMPLE_ROWS, SLOT_SLOTS
    sb = bins[:, :n].contiguous()
    sg = pay_d["snapped"][:n, :3].contiguous()
    ss = torch.from_numpy(rng.randint(0, S + 2, size=n).astype(np.int32)).to(dev)
    check(torch.equal(histogram_slots(sb, sg, ss, num_bins, S).cpu(),
                      histogram_slots(sb.cpu(), sg.cpu(), ss.cpu(), num_bins, S)),
          "histogram_slots: differs from the plain version on snapped gradients")
    all_rows = [torch.zeros(S, dtype=torch.int32, device=dev),
                torch.full((S,), n, dtype=torch.int32, device=dev),
                torch.ones(S, dtype=torch.bool, device=dev)]
    timings["slots"] = cuda_ms(lambda: histogram_slots(sb, sg, ss, num_bins, S), 20)
    timings["plain_slots"] = cuda_ms(lambda: _histogram_slots_ragged_plain(
        sb, sg, ss, *all_rows, num_bins, S), 2)
    bounds["slots"] = bound(perfmodel.hist_ragged(n, G, S, out_bytes))
    # its library call: index_add_ over the rows whose slot is one of the S
    timings["library_slots"] = index_add_ms(
        sb, sg, torch.nonzero(ss < S)[:, 0], ss, S, num_bins,
        histogram_slots(sb, sg, ss, num_bins, S))
    check_image_modes(dev, bins, payload, pay_d, cases, exps, num_bins, timings, bounds)
    return max_err, timings, bounds, kept["wave"], kept["root"]


def check_image_modes(dev, bins, payload, pay_d, cases, exps, num_bins, timings, bounds):
    """Phase 21's kernel modes on phase 4's ragged inputs: the ragged
    kernel's image mode (the unconverted int64 fixed-point sums and flag
    words the gang's ranks add) and the conversion kernel (image -> float32
    with the exponents), each bit-equal to its plain version run on the CPU
    on the 21 ranges, and on a 65,536-row sample holding
    +inf, -inf and NaN gradients (the flag words); the conversion of the
    image equal to the float mode's result; two launches bit-equal. Timed
    as the learners call them: the image of a wave's 21 ranges, and the
    conversion of a wave's 42 children [2K, G, B, CH]; plain versions on
    the card; the image's library call is the float mode's (index_add_)."""
    from lightgbm_tpu_torch.ops import hist_cuda
    from lightgbm_tpu_torch.ops.histogram import (_histogram_slots_ragged_image_plain,
                                                  _image_to_float_plain,
                                                  fixed_point_exponents)

    G = bins.shape[0]
    exps_d = exps.to(dev)
    n = SAMPLE_ROWS
    bad = payload["real"][:n].clone()
    bad[7, 0], bad[8, 1], bad[9, 0], bad[9, 1] = float("inf"), float("-inf"), float("nan"), 1.0
    bad[10, 0] = float("-inf")
    bad_exps = fixed_point_exponents(bad[:, :3], n)
    sample = (bins[:, :n].contiguous(), np.zeros(n, np.int32), np.array([0], np.int32),
              np.array([n], np.int32))
    for name, (bins_d, sl, st, en), gh_h, e in (
            ("wave", cases["wave"], payload["real"], exps),
            ("non-finite sample", sample, bad, bad_exps)):
        K = len(st)
        args_h = [torch.from_numpy(a) for a in (sl, st, en)] + [torch.ones(K, dtype=torch.bool)]
        args_d = [a.to(dev) for a in args_h]
        gh_d = gh_h.to(dev)
        e_d = e.to(dev)
        got = hist_cuda.histogram_ragged(bins_d, gh_d[:, :3], *args_d, num_bins, K,
                                         exponents=e_d, image=True)
        again = hist_cuda.histogram_ragged(bins_d, gh_d[:, :3], *args_d, num_bins, K,
                                           exponents=e_d, image=True)
        ref = _histogram_slots_ragged_image_plain(bins_d.cpu(), gh_h[:, :3], *args_h,
                                                  num_bins, K, e)
        for what, g, a, r in (("sums", got.sums, again.sums, ref.sums),
                              ("flags", got.flags, again.flags, ref.flags)):
            check(torch.equal(g.cpu(), r), f"ragged image mode ({name}): {what} differ from "
                                           "the plain version")
            check(torch.equal(a, g), f"ragged image mode ({name}): two launches differ")
        conv = hist_cuda.image_to_float(got.sums, got.flags, e_d)
        conv_ref = _image_to_float_plain(ref.sums, ref.flags, e)
        check(torch.equal(conv.cpu().view(torch.int32), conv_ref.view(torch.int32)),
              f"conversion ({name}): differs from the plain version")
        floated = hist_cuda.histogram_ragged(bins_d, gh_d[:, :3], *args_d, num_bins, K,
                                             exponents=e_d)
        check(torch.equal(conv.view(torch.int32), floated.view(torch.int32)),
              f"conversion ({name}): differs from the float mode's own conversion")
        if name == "non-finite sample":
            check(int((ref.flags != 0).sum()) > 0, "ragged image mode: no flag word set")
    bins_w, sl, st, en = cases["wave"]
    K = len(st)
    args_d = [torch.from_numpy(a).to(dev) for a in (sl, st, en)] + [
        torch.ones(K, dtype=torch.bool, device=dev)]
    rows = int((en - st).sum())
    timings["image_wave"] = cuda_ms(lambda: hist_cuda.histogram_ragged(
        bins_w, pay_d["real"][:, :3], *args_d, num_bins, K, exponents=exps_d, image=True), 20)
    timings["plain_image_wave"] = cuda_ms(lambda: _histogram_slots_ragged_image_plain(
        bins_w, pay_d["real"][:, :3], *args_d, num_bins, K, exps_d), 1)
    cells_w = G * num_bins * K * 3
    bounds["image_wave"] = bound(perfmodel.hist_ragged_image(rows, G, cells_w))
    # a wave's 2K children, as the learners convert them after the subtraction
    img = hist_cuda.histogram_ragged(bins_w, pay_d["real"][:, :3], *args_d, num_bins, K,
                                     exponents=exps_d, image=True)
    sums = torch.cat([img.sums, img.sums], dim=-1).contiguous()
    flags = torch.cat([img.flags, img.flags], dim=-1).contiguous()
    timings["convert"] = cuda_ms(lambda: hist_cuda.image_to_float(sums, flags, exps_d), 20)
    timings["plain_convert"] = cuda_ms(lambda: _image_to_float_plain(sums, flags, exps_d), 5)
    bounds["convert"] = bound(perfmodel.image_to_float(sums.numel()))
    timings["convert_cells"] = sums.numel()
    # the leaf histogram's image mode (the host-driven data-parallel
    # learner's), on a sample bit-equal to its plain version, timed at the
    # root (the plain version on the card)
    from lightgbm_tpu_torch.ops.histogram import _histogram_rows_image_plain

    sb = bins[:, :n].contiguous()
    g_s = bad[:, :3].contiguous()
    got = hist_cuda.histogram(sb, g_s.to(dev), None, num_bins, exponents=bad_exps.to(dev),
                              image=True)
    ref = _histogram_rows_image_plain(sb.cpu(), g_s, None, num_bins, None, bad_exps)
    check(torch.equal(got.sums.cpu(), ref.sums) and torch.equal(got.flags.cpu(), ref.flags),
          "leaf histogram image mode: differs from the plain version")
    gh_root = pay_d["real"][:, :3].contiguous()
    timings["image_rows"] = cuda_ms(lambda: hist_cuda.histogram(
        bins, gh_root, None, num_bins, exponents=exps_d, image=True), 20)
    timings["plain_image_rows"] = cuda_ms(lambda: _histogram_rows_image_plain(
        bins, gh_root, None, num_bins, None, exps_d), 1)
    bounds["image_rows"] = bound(perfmodel.hist_rows(bins.shape[1], G,
                                                     12 * G * num_bins * 3))


def check_compaction(dev, bins, n_rows, seed):
    """The compaction kernel against its plain version run on the CPU, on
    WAVE_K ranges covering every row with a random go_left (the forward map
    from range_partition_dst on the card, equal to the CPU's): bit-equal, two
    launches bit-equal. Returns (timings, bound)."""
    from lightgbm_tpu_torch.ops import compact_cuda
    from lightgbm_tpu_torch.ops.compact import (_compact_rows_plain,
                                                range_partition_dst_by_range)

    rng = np.random.RandomState(seed)
    G = bins.shape[0]
    rows = rng.normal(size=(n_rows, 5)).astype(np.float32)
    rows[:, 3] = np.arange(n_rows)
    rows[:, 4] = rng.randint(0, 255, n_rows)
    cuts = np.sort(rng.choice(np.arange(1, n_rows), WAVE_K - 1, replace=False))
    edges = np.concatenate([[0], cuts, [n_rows]]).astype(np.int32)
    range_of = np.repeat(np.arange(WAVE_K, dtype=np.int32), np.diff(edges))
    args_h = [torch.from_numpy(rng.rand(n_rows) < 0.5), torch.from_numpy(range_of),
              torch.from_numpy(edges[:-1]), torch.from_numpy(np.diff(edges)),
              torch.ones(WAVE_K, dtype=torch.bool)]
    dst, n_left = range_partition_dst_by_range(*[a.to(dev) for a in args_h])
    dst_h, n_left_h = range_partition_dst_by_range(*args_h)
    check(torch.equal(dst.cpu(), dst_h) and torch.equal(n_left.cpu(), n_left_h),
          "compaction: range_partition_dst on the card differs from the CPU's")
    rows_d = torch.from_numpy(rows).to(dev)
    got, again = compact_cuda.compact(bins, rows_d, dst), compact_cuda.compact(bins, rows_d, dst)
    torch.cuda.synchronize()
    ref = _compact_rows_plain(bins.cpu(), torch.from_numpy(rows), dst_h)
    for g, a, r in zip(got, again, ref):
        check(torch.equal(g.cpu().view(torch.uint8), r.view(torch.uint8)),
              "compaction: differs from the plain version")
        check(torch.equal(a.view(torch.uint8), g.view(torch.uint8)),
              "compaction: two launches differ")
    out = (torch.empty_like(bins), torch.empty_like(rows_d))
    dst64 = dst.long()

    def library():
        out[0].index_copy_(1, dst64, bins)
        out[1].index_copy_(0, dst64, rows_d)

    library()
    check(torch.equal(out[0], got[0]) and torch.equal(out[1].view(torch.int32),
                                                      got[1].view(torch.int32)),
          "compaction: index_copy_ differs from the kernel")
    timings = {"kernel": cuda_ms(lambda: compact_cuda.compact(bins, rows_d, dst, out), 20),
               "plain": cuda_ms(lambda: _compact_rows_plain(bins, rows_d, dst), 5),
               "library": cuda_ms(library, 20)}
    return timings, bound(perfmodel.compact_rows(n_rows, G))


def check_batched_scan(dev, ds, num_bins, wave_hist, root_hist):
    """The split-scan kernel's leaf batch at a wave's shape (2 * WAVE_K
    children: each range's histogram and the root minus it) against the
    plain version run on the CPU: every field bit-equal, the gain too.
    Returns (timings, bound, leaves)."""
    from lightgbm_tpu_torch.ops import scan_cuda
    from lightgbm_tpu_torch.ops import split as ts

    G = root_hist.shape[0]
    left = wave_hist.reshape(G, num_bins, WAVE_K, 3).permute(2, 0, 1, 3)
    hists = torch.stack([left, root_hist[None] - left], dim=1).reshape(
        2 * WAVE_K, G, num_bins, 3)
    totals = hists[:, 0].sum(dim=1)
    meta_d = ts.make_feature_meta(ds, num_bins, dev)
    meta_h = ts.make_feature_meta(ds, num_bins, "cpu")
    params_d = torch.tensor(SCAN_PARAMS, device=dev)
    fh = ts.gather_feature_hist(hists, meta_d, totals)
    rec = scan_cuda.split_scan(fh, totals, meta_d, params_d)
    ref = ts._per_feature_best_plain(fh.cpu(), totals.cpu(), meta_h,
                                     torch.tensor(SCAN_PARAMS))
    check(torch.equal(rec.cpu().view(torch.int32), ref.view(torch.int32)),
          "batched split scan: records differ from the CPU plain version")
    check(bool((rec[..., 1] >= 0).any()), "batched split scan: no feature has a split")
    timings = {"kernel": cuda_ms(lambda: scan_cuda.split_scan(fh, totals, meta_d,
                                                              params_d), 50),
               "kernel_device": kernel_device_ms(
                   lambda: scan_cuda.split_scan(fh, totals, meta_d, params_d), 20,
                   "split_kernel"),
               "plain": cuda_ms(lambda: ts._per_feature_best_plain(fh, totals, meta_d,
                                                                   params_d), 10)}
    L, F, B = fh.shape[0], fh.shape[1], fh.shape[2]
    return timings, bound(perfmodel.split_scan_batched(L, F, B)), (L, F, B)


_STATE = ("leaf_best", "depth", "start", "count", "rec_store", "scalars", "pool",
          "exponents", "feature_mask")


def record_wave_inputs(lt, train_set, params):
    """The inputs of real waves of the first tree of a round of lt.train
    through the wave learner: the carry before its first live wave, its
    third (the partition's check, WAVE_K ranges), a middle one and its last
    (where the leaf budget binds). On the card a tree is one graph launch
    whose waves the host never sees, so these rounds grow their trees with
    the loop driven from the host (the CPU's loop, `_waves_eager`) in place
    of the tree graph, the same waves on the same buffers: the first round
    counts the tree's live waves, a second, equal, one keeps the four
    carries; then each kept wave runs once more, eagerly, from its carry,
    with the wave's steps wrapped to keep copies of their inputs. Also a
    bagged initial partition, from a round with bagging. Returns {"waves":
    {name: {"select": args, "replay": (state before, args), "partition":
    args, "relabel": (rows, leaf column, table)}}, "wave": the third
    wave's partition args, "bagged": args, "relabel": the third wave's
    relabel}."""
    from lightgbm_tpu_torch.ops.wave import DONE
    from lightgbm_tpu_torch.treelearner import device as dmod

    kept, seen = {}, {}
    real = {name: getattr(dmod, name) for name in
            ("_grow", "_wave", "_tree_graph", "partition_wave", "select_wave",
             "replay_wave", "relabel_rows")}
    count = dmod._Grown._count
    live = {"n": 0, "want": {}, "trees": 0}

    def clone(args):
        return [a.clone() if isinstance(a, torch.Tensor) else a for a in args]

    def grow(*args, **kwargs):
        live["trees"] += 1
        if live["trees"] == 1:
            seen["args"] = inspect.signature(real["_grow"]).bind(*args, **kwargs).arguments
        return real["_grow"](*args, **kwargs)

    class HostLoop:
        """Stands in for the tree graph: the root, then the host's loop."""

        def __init__(self, buf, K, masked, bagged, num_leaves, root, wave):
            self.args = (buf, 1 if bagged else 0, wave, num_leaves)
            self.root = root

        def launch(self):
            self.root()
            dmod._waves_eager(*self.args)

    def wave_step(buf, cur, K, *rest):
        if live["trees"] == 1 and int(buf.scalars[DONE]) == 0:  # a live wave
            live["n"] += 1
            names = live["want"].get(live["n"], ())
            if names:
                snap = ((K, cur, rest[3]), buf.bins[cur].clone(), buf.rows[cur].clone(),
                        {k: getattr(buf, k).clone() for k in _STATE})
                seen.update((name, snap) for name in names)
        return real["_wave"](buf, cur, K, *rest)

    def part(*args, **kwargs):
        if kwargs.get("bagged"):
            kept.setdefault("bagged", clone(args))
        return real["partition_wave"](*args, **kwargs)

    dmod._grow, dmod._wave, dmod.partition_wave = grow, wave_step, part
    dmod._tree_graph = HostLoop
    dmod._Grown._count = lambda self, passes: None  # no tree graph ran
    try:
        lt.train(dict(params), train_set, num_boost_round=1)
        n = live["n"]
        check(n >= 4, f"the first tree has {n} live waves")
        want = {}
        for i, name in ((1, "first"), (3, "third"), ((n + 1) // 2, "middle"), (n, "last")):
            want.setdefault(i, []).append(name)
        live.update(n=0, trees=0, want=want)
        lt.train(dict(params), train_set, num_boost_round=1)
        check(live["n"] == n, f"two equal rounds grew {n} and {live['n']} live waves")
        lt.train({**params, "bagging_fraction": 0.8, "bagging_freq": 1}, train_set,
                 num_boost_round=1)
    finally:
        dmod._Grown._count = count
        for name in ("_grow", "_wave", "_tree_graph", "partition_wave"):
            setattr(dmod, name, real[name])
    a = seen["args"]
    bins, meta, tables, params_d = a["bins"], a["meta"], a["tables"], a["params"]
    L, num_bins, max_depth, buf = a["num_leaves"], a["num_bins"], a["max_depth"], a["buffers"]
    G, N = bins.shape
    scratch = dmod.WaveBuffers(G, N, buf.rows[0].shape[1], L, num_bins, buf.pool.shape[-1],
                               buf.feature_mask.shape[0], bins.device)
    waves = {}
    for name in ("first", "third", "middle", "last"):
        (K, cur, masked), bins_c, rows_c, state = seen[name]
        got = {}

        def select(*args):
            got["select"] = clone(args)
            return real["select_wave"](*args)

        def partition(*args, **kwargs):
            got["partition"] = clone(args)
            return real["partition_wave"](*args, **kwargs)

        def replay_step(*args):
            got["replay"] = clone(args)
            return real["replay_wave"](*args)

        def relabel(row_p, leaf_col, table):
            got["relabel"] = (row_p.clone(), leaf_col, table.clone())
            return real["relabel_rows"](row_p, leaf_col, table)

        scratch.bins[cur].copy_(bins_c)
        scratch.rows[cur].copy_(rows_c)
        for k in _STATE:
            getattr(scratch, k).copy_(state[k])
        dmod.select_wave, dmod.partition_wave = select, partition
        dmod.replay_wave, dmod.relabel_rows = replay_step, relabel
        try:
            dmod._wave(scratch, cur, K, meta, tables, params_d, masked, num_bins, max_depth)
        finally:
            for k in ("partition_wave", "select_wave", "replay_wave", "relabel_rows"):
                setattr(dmod, k, real[k])
        check(not torch.equal(scratch.scalars, state["scalars"]),
              f"the {name} wave changed no scalar")
        waves[name] = got
    del scratch
    kept["waves"] = waves
    kept["wave"] = waves["third"]["partition"]
    kept["relabel"] = waves["third"]["relabel"]
    check(kept["wave"][6].shape[0] == WAVE_K, "the recorded wave has "
          f"{kept['wave'][6].shape[0]} ranges, not {WAVE_K}")
    check("bagged" in kept, "recorded no bagged partition")
    return kept


def check_wave_step(dev, kept):
    """The wave's selection and replay kernels against their plain versions
    run on the CPU, on the first, a middle and the last live wave of a real
    tree: the selection's table, and the replay's state after it (records,
    depths, ranges, the split log's bits, the scalars with the done word)
    and commit table exactly equal, two launches equal. Returns (timings,
    bounds, shapes)."""
    from lightgbm_tpu_torch.ops import wave_cuda
    from lightgbm_tpu_torch.ops.wave import (DONE, REC, SCALARS, STORE, T,
                                             _replay_wave_plain, _select_wave_plain,
                                             select_size)

    def cpu(args):
        return [a.cpu() if isinstance(a, torch.Tensor) else
                type(a)(*(t.cpu() for t in a)) if isinstance(a, tuple) else a for a in args]

    committed = {}
    for name in ("first", "middle", "last"):
        sel_args = kept["waves"][name]["select"]
        leaf_best, start, count, scalars, tables, K = sel_args
        L = leaf_best.shape[0] - 1
        outs = [wave_cuda.select(*sel_args) for _ in range(2)]
        ref = _select_wave_plain(*cpu(sel_args))
        for got in outs:
            check(torch.equal(got.cpu(), ref), f"wave_select ({name} wave): the table "
                  "differs from the plain version")
        rp = kept["waves"][name]["replay"]
        results = []
        for device in (dev, dev, "cpu"):
            args = [a.clone().to(device) if isinstance(a, torch.Tensor) else a for a in rp]
            commit = (wave_cuda.replay(*args) if device != "cpu" else
                      _replay_wave_plain(*args))
            results.append([commit.cpu()] + [a.cpu() for a in args[:6]])
        for got in results[:2]:
            for what, g, r in zip(("commit", "leaf_best", "depth", "rec_store", "start",
                                   "count", "scalars"), got, results[2]):
                check(g.dtype == r.dtype and torch.equal(g.view(torch.uint8),
                                                         r.view(torch.uint8)),
                      f"wave_replay ({name} wave): {what} differs from the plain version")
        committed[name] = int(results[2][6][T] - rp[5][T].cpu())
    check(int(results[2][6][DONE]) == 1, "the last wave did not set the done word")

    # timings at the middle wave: the replay from a fresh copy of its state
    # each call (the copies are not the kernel's time)
    sel_args = kept["waves"]["middle"]["select"]
    rp = kept["waves"]["middle"]["replay"]
    L, K = sel_args[0].shape[0] - 1, sel_args[5]
    fresh = [a.clone() if isinstance(a, torch.Tensor) else a for a in rp]

    def replay_call():
        for a, b in zip(fresh[:6], rp[:6]):
            a.copy_(b)
        wave_cuda.replay(*fresh)

    def replay_plain():
        for a, b in zip(fresh[:6], rp[:6]):
            a.copy_(b)
        _replay_wave_plain(*fresh)

    timings = {
        "select": kernel_device_ms(lambda: wave_cuda.select(*sel_args), 20,
                                   "wave_select_kernel"),
        "select_events": cuda_ms(lambda: wave_cuda.select(*sel_args), 20),
        "select_plain": cuda_ms(lambda: _select_wave_plain(*sel_args), 3),
        "replay": kernel_device_ms(replay_call, 20, "wave_replay_kernel"),
        "replay_events": cuda_ms(replay_call, 20),
        "replay_plain": cuda_ms(replay_plain, 3),
    }
    n = committed["middle"]
    bounds = {"select": bound(perfmodel.wave_select(L, K, select_size(L, K))),
              "replay": bound(perfmodel.wave_replay(L, K, n))}
    return timings, bounds, (L, K, committed)


def device_kernel_ms(fn, reps, names):
    """Device milliseconds a call of fn() of each kernel whose name holds one
    of `names`, from torch.profiler over reps calls (None when the profiler
    records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        for name in names:
            if name in e.key and us > 0:
                out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out or None


def kernel_device_ms(fn, reps, name):
    """Device milliseconds a call of the kernel `name` launched by fn(), from
    torch.profiler, or None when the profiler records no device time. Where
    a kernel is shorter than its wrapper's host work, CUDA events around
    back-to-back calls time the host, not the kernel."""
    return (device_kernel_ms(fn, reps, (name,)) or {}).get(name)


def call_device_ms(fn, reps):
    """Device milliseconds of the device's own events (kernels, copies,
    fills) a call of fn(), from torch.profiler, or None."""
    busy = device_busy_share(lambda: [fn() for _ in range(reps)])
    return None if busy is None else busy[0] * 1e3 / reps


def device_or_events(t, key):
    """The profiler's device time of timings[key + "_device"], else the CUDA
    events' time of timings[key]."""
    d = t.get(key + "_device")
    return t[key] if d is None else d


def host_ms(fn, reps):
    """Host milliseconds a call of fn(), the device synchronized before and
    after the reps calls: what a host-bound caller pays a call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def check_partition(dev, kept, seed):
    """The wave partition's kernels against their plain version run on the
    CPU: on a real wave's inputs, on the same with random sides, on a real
    bagged initial partition; every output exactly equal, two launches
    equal; the relabel on a real commit. Returns (timings, bounds, counts)."""
    from lightgbm_tpu_torch.ops import compact_cuda
    from lightgbm_tpu_torch.ops.compact import (_partition_wave_plain,
                                                _relabel_rows_plain, partition_wave,
                                                range_partition_dst_by_range,
                                                relabel_rows)

    bins, rows, leaf_col, leaf2k, rgroup, lut, starts, counts, valid = kept["wave"]
    G, N = bins.shape
    rc = rows.shape[1]
    K = starts.shape[0]
    rnd = torch.from_numpy((np.random.RandomState(seed).rand(K, GROUP_BINS) < 0.5)
                           .astype(np.int32)).to(dev)
    cases = {"wave": (kept["wave"], False),
             "random_sides": ([bins, rows, leaf_col, leaf2k, rgroup, rnd, starts, counts,
                               valid], False),
             "bagged": (kept["bagged"], True)}

    def run(args, bagged, device):
        args = [a.to(device) if isinstance(a, torch.Tensor) else a for a in args]
        k = args[6].shape[0]
        slot = torch.full((N,), -7, dtype=torch.int32, device=device)
        got = partition_wave(*args, bagged=bagged, slot_out=slot)
        return [t.cpu() for t in got] + [slot.cpu()]

    moved = {}
    for name, (args, bagged) in cases.items():
        got, again = run(args, bagged, dev), run(args, bagged, dev)
        torch.cuda.synchronize()
        ref = run(args, bagged, "cpu")
        for what, g, a, r in zip(("bins", "rows", "ranges", "flags", "slot"),
                                 got, again, ref):
            check(g.dtype == r.dtype and g.shape == r.shape
                  and torch.equal(g.view(torch.uint8), r.view(torch.uint8)),
                  f"wave partition ({name}): {what} differs from the plain version")
            check(torch.equal(a.view(torch.uint8), g.view(torch.uint8)),
                  f"wave partition ({name}): two launches differ in {what}")
        moved[name] = int(ref[2][0].sum())
    before, leaf_c, table = kept["relabel"]
    got = before.clone()
    relabel_rows(got, leaf_c, table)
    ref = before.cpu()
    relabel_rows(ref, leaf_c, table.cpu())
    check(torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32)),
          "relabel: differs from the plain version")
    relabeled = int((table[1] - table[0]).sum())

    # timings at the real wave, into preallocated buffers as the learner calls
    args = kept["wave"]
    out = (torch.empty_like(bins), torch.empty_like(rows))
    slot = torch.empty(N, dtype=torch.int32, device=dev)

    def kernel():
        return partition_wave(*args, out=out, slot_out=slot)

    # the parent's sequence for the same work: the per-row glue
    # (treelearner/device.py:338-341 of the parent), the forward map
    # (ops/compact.py:range_partition_dst_by_range), the compaction kernel,
    # the slot vector (:348-356) and the relabel of every range (:401-404)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    rgroup_x, lut_x = torch.cat([rgroup, zero]), torch.cat([lut.reshape(-1),
                                                             zero.repeat(GROUP_BINS)])
    ok_b = valid != 0
    pos = torch.arange(N, dtype=torch.int32, device=dev)
    commit = torch.cat([ok_b, torch.zeros(1, dtype=torch.bool, device=dev)])
    new_ids = torch.arange(K + 1, dtype=torch.int64, device=dev) + 1000
    ok_k = ok_b.nonzero()[:, 0]
    table_all = torch.stack([starts + counts // 2, starts + counts, new_ids[:K].int()]
                            ).to(torch.int64)[:, ok_k].contiguous()

    def parent():
        go_left, rng = _decide_for(bins, rows, leaf_col, leaf2k, rgroup_x, lut_x)
        rng64 = rng.to(torch.int64)
        dst, nl = range_partition_dst_by_range(go_left, rng, starts, counts, ok_b)
        compact_cuda.compact(bins, rows, dst, out)
        nr = counts - nl
        left_small = nl <= nr
        sc = torch.minimum(nl, nr)
        ss = torch.where(left_small, starts, starts + nl)
        se = ss + sc
        in_s = ((pos >= torch.cat([ss, zero])[rng64]) & (pos < torch.cat([se, zero])[rng64]))
        torch.where(in_s, rng, K).to(torch.int32)
        mid = torch.cat([starts + nl, zero])
        is_right = commit[rng64] & (pos >= mid[rng64])
        out[1][:, leaf_col] = torch.where(is_right, new_ids[rng64].to(torch.float32),
                                          out[1][:, leaf_col])

    def this_tree():
        kernel()
        relabel_rows(out[1], leaf_col, table_all)

    dst, _ = range_partition_dst_by_range(
        *_decide_for(bins, rows, leaf_col, leaf2k, rgroup_x, lut_x), starts, counts, ok_b)
    dst64 = dst.to(torch.int64)
    lib_out = (torch.empty_like(bins), torch.empty_like(rows))

    def library():
        lib_out[0].index_copy_(1, dst64, bins)
        lib_out[1].index_copy_(0, dst64, rows)

    timings = {
        "partition": cuda_ms(kernel, 20),
        "passes": device_kernel_ms(kernel, 10, ("decide_kernel", "scan_kernel",
                                               "scatter_kernel")) or {},
        "plain": cuda_ms(lambda: _partition_wave_plain(*args, False, out, slot), 3),
        "library": cuda_ms(library, 20),
        "relabel": cuda_ms(lambda: relabel_rows(before, leaf_c, table), 20),
        "relabel_plain": cuda_ms(lambda: _relabel_rows_plain(before, leaf_c, table), 3),
        "this_tree": cuda_ms(this_tree, 20), "parent": cuda_ms(parent, 20),
        "this_tree_host": host_ms(this_tree, 20), "parent_host": host_ms(parent, 20),
    }
    tiles = -(-N // compact_cuda.TILE_ROWS)
    costs = {"decide": perfmodel.partition_decide(N, rc, tiles, K),
             "scan": perfmodel.partition_scan(tiles, K),
             "scatter": perfmodel.partition_scatter(N, G, rc, tiles, K),
             "relabel": perfmodel.relabel(relabeled)}
    costs["partition"] = (sum(costs[k][0] for k in ("decide", "scan", "scatter")), 0)
    bounds = {k: bound(v) for k, v in costs.items()}
    return timings, bounds, (N, G, K, moved, relabeled)


def _decide_for(bins, rows, leaf_col, leaf2k, rgroup_x, lut_x):
    """(go_left, range) of every row of a wave, as the parent learner built
    them (its treelearner/device.py:338-341), from tables with a zero entry
    for the range K of no range."""
    rng = leaf2k[rows[:, leaf_col].to(torch.int64) + 1]
    rng64 = rng.to(torch.int64)
    gb = bins.gather(0, rgroup_x[rng64].to(torch.int64)[None, :])[0]
    return lut_x[rng64 * GROUP_BINS + gb.to(torch.int64)] != 0, rng


def check_find_split(dev, ds, bins, num_bins, gh, idx, wave_hist, root_hist, seed):
    """The split kernel's find form (group histogram -> each leaf's record)
    against its plain version run on the CPU: one leaf (the root and a
    ~100,000-row leaf) with and without a feature mask, the 2 * WAVE_K
    children of a wave likewise, and one and six leaves of a small dataset
    whose features EFB bundles; every field equal but the gain, which is
    within 4 ULP of the un-shifted gain. Returns (max |gain d|, records
    bit-equal / compared, timings, bounds, shapes)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import hist_cuda, scan_cuda
    from lightgbm_tpu_torch.ops import split as ts

    meta_d = ts.make_feature_meta(ds, num_bins, dev)
    meta_h = ts.make_feature_meta(ds, num_bins, "cpu")
    F = len(meta_h.real_feature)
    params_d = torch.tensor(SCAN_PARAMS, device=dev)
    params_h = torch.tensor(SCAN_PARAMS)
    mask = np.random.RandomState(seed).rand(F) < 0.8
    G = root_hist.shape[0]
    left = wave_hist.reshape(G, num_bins, WAVE_K, 3).permute(2, 0, 1, 3)
    wave = torch.stack([left, root_hist[None] - left], dim=1).reshape(
        2 * WAVE_K, G, num_bins, 3).contiguous()
    leaf = hist_cuda.histogram(bins, gh, idx, num_bins)
    cases = {"root": (root_hist, meta_d, meta_h), "leaf": (leaf, meta_d, meta_h),
             "wave": (wave, meta_d, meta_h)}
    # a small dataset whose sparse features EFB bundles
    rng = np.random.RandomState(seed)
    n = 20000
    X = np.where(rng.rand(n, 12) < 0.01, rng.normal(size=(n, 12)), 0.0)
    efb = lt.Dataset(X, label=np.zeros(n), params={"min_data_in_leaf": 5,
                                                   "verbosity": -1}).construct()._handle
    check(any(g.is_multi for g in efb.groups), "the EFB dataset has no bundle")
    B_e = int(max(efb.group_bin_counts().max(), 2))
    gh_e = torch.from_numpy(np.concatenate([np.stack(
        [rng.normal(size=n), rng.uniform(0.05, 0.5, n), np.ones(n)], 1),
        np.zeros((1, 3))]).astype(np.float32)).to(dev)
    h_e = hist_cuda.histogram(torch.from_numpy(efb.bins).to(dev), gh_e[:n], None, B_e)
    h6 = torch.stack([h_e, h_e / 2, h_e - h_e / 2, h_e / 3, h_e * 0.25, h_e - h_e / 3])
    me_d, me_h = ts.make_feature_meta(efb, B_e, dev), ts.make_feature_meta(efb, B_e, "cpu")
    cases["efb"] = (h_e, me_d, me_h)
    cases["efb_batch"] = (h6, me_d, me_h)
    max_err, same, total = 0.0, 0, 0
    for name, (hist, md, mh) in cases.items():
        tot = hist[..., 0, :, :].sum(dim=-2)
        for m in ((None, mask) if mh is meta_h else (None,)):
            rec = ts.find_best_split(hist, tot, md, params_d,
                                     None if m is None else torch.from_numpy(m).to(dev)).cpu()
            ref = ts.find_best_split(hist.cpu(), tot.cpu(), mh, params_h,
                                     None if m is None else torch.from_numpy(m))
            what = f"find_best_split {name}{' masked' if m is not None else ''}"
            check(torch.equal(rec[..., 1:], ref[..., 1:]), f"{what}: records differ")
            finite = torch.isfinite(ref[..., 0])
            check(torch.equal(torch.isfinite(rec[..., 0]), finite), f"{what}: gains differ")
            shift = ts.leaf_gain(tot[..., 0].cpu(), tot[..., 1].cpu(), *params_h[[0, 1, 5]])
            ulp = torch.from_numpy(np.asarray(np.spacing(
                np.abs((ref[..., 0] + shift).numpy()).astype(np.float32))))
            d = (rec[..., 0] - ref[..., 0]).abs()[finite]
            check(bool((d <= 4 * ulp[finite]).all()), f"{what}: gain beyond 4 ULP")
            check(bool((rec[..., 1] >= 0).any()), f"{what}: no split found")
            recs = rec.reshape(-1, rec.shape[-1])
            same += int((recs.view(torch.int32) == ref.reshape(recs.shape).view(torch.int32))
                        .all(dim=1).sum())
            total += recs.shape[0]
            max_err = max(max_err, float(d.max()) if d.numel() else 0.0)
    # timings as the learners call it: one leaf with host totals (serial),
    # 42 children with device totals (wave)
    mask_d = torch.from_numpy(mask).to(dev)
    tot_leaf = leaf[0].sum(dim=0)
    host_tot = tuple(float(v) for v in tot_leaf.cpu())
    tot_wave = wave[:, 0].sum(dim=1)

    def one():
        return ts.find_best_split(leaf, host_tot, meta_d, params_d, mask_d)

    def batch():
        return ts.find_best_split(wave, tot_wave, meta_d, params_d, None)

    # the parent's sequences: the gather, the EFB fix, the per-feature
    # launch and the argmax (plus, for the serial learner, the totals'
    # upload)
    def parent_one():
        t = torch.tensor(host_tot, dtype=torch.float32, device=dev)
        fh = ts.gather_feature_hist(leaf, meta_d, t)
        return ts.reduce_best_record(scan_cuda.split_scan(fh, t, meta_d, params_d, mask_d))

    def parent_batch():
        fh = ts.gather_feature_hist(wave, meta_d, tot_wave)
        return ts.reduce_best_record(scan_cuda.split_scan(fh, tot_wave, meta_d, params_d))

    timings = {
        "one": cuda_ms(one, 50), "batch": cuda_ms(batch, 50),
        "one_device": kernel_device_ms(one, 20, "split_kernel"),
        "batch_device": kernel_device_ms(batch, 20, "split_kernel"),
        "plain_one": cuda_ms(lambda: ts._find_best_split_plain(
            leaf, tot_leaf, meta_d, params_d, mask_d), 5),
        "plain_batch": cuda_ms(lambda: ts._find_best_split_plain(
            wave, tot_wave, meta_d, params_d), 5),
        "one_host": host_ms(lambda: one().cpu(), 50),
        "parent_one_host": host_ms(lambda: parent_one().cpu(), 50),
        "batch_host": host_ms(batch, 50), "parent_batch_host": host_ms(parent_batch, 50),
        "parent_one": cuda_ms(parent_one, 50), "parent_batch": cuda_ms(parent_batch, 50),
    }
    B = meta_h.max_bins
    bounds = {"one": bound(perfmodel.find_best_split(F, B)),
              "batch": bound(perfmodel.find_best_split(F, B, 2 * WAVE_K))}
    return max_err, (same, total), timings, bounds, (F, B)


def device_busy_share(fn):
    """(kernel seconds, wall seconds, top kernels, device operations) of
    fn() under torch.profiler, or None when the profiler records no device
    time. Only the device's own events count (kernels, copies, fills): a
    host-side ATen op reports its kernels' device time too, and summing both
    would count that time twice. Device operations count those events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    per_kernel, ops = {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type != DeviceType.CPU:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us
            ops += e.count
    if not per_kernel:
        return None
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return (sum(per_kernel.values()) * 1e-6, wall,
            ", ".join(f"{k[:40]} {v / 1e3:.3f} ms" for k, v in top), ops)


def profile_round(lt, params, train_set, tag, label):
    """The device's busy share and the device operations (kernels and
    copies) a wave or a split over one steady round: a booster that has
    already taken one step, profiled through its second."""
    from lightgbm_tpu_torch.utils.timer import global_timer

    bst = lt.Booster(dict(params), train_set)
    bst.update()
    # waves run as graphs: inside a tree graph, or (an older checkout's
    # counter) one graph replay each
    counters = ("device_waves", "wave_graph_runs", "wave_graph_replays", "wave_noops")
    before = {k: global_timer.counters.get(k, 0) for k in counters}
    busy = device_busy_share(bst.update)
    waves, runs, replays, noops = (global_timer.counters.get(k, 0) - before[k]
                                   for k in counters)
    replays += runs
    splits = bst._gbdt.models[-1].num_leaves - 1
    per = ""
    if busy is not None:
        per = (f"; {busy[3]} device operations (kernels and copies) in the round, "
               + (f"{waves} waves: {busy[3] / waves:.1f} a wave" if waves else
                  f"{splits} splits: {busy[3] / max(splits, 1):.1f} a split"))
        if replays:
            per += (f" ({replays} waves run as graphs, {noops} of them no-op waves: "
                    f"{busy[3] / replays:.1f} a run)")
    print(f"{tag} device busy share over one training round ({label}, torch.profiler): "
          + ("not measured (the profiler saw no device time)" if busy is None else
             f"{busy[0] * 1e3:.1f} ms of kernels in {busy[1] * 1e3:.1f} ms wall, "
             f"{busy[0] / busy[1]:.1%} busy; top kernels: {busy[2]}{per}"))


def tree_transfers(booster, tag, label):
    """One more tree of the booster's wave learner, on its current
    gradients, under torch.profiler: its graph launches, device-to-host
    copies (count and bytes) and host synchronizations (runtime calls),
    read from the trace. Checks that the tree is one graph launch, that the
    results' one copy is its only device-to-host copy and that the host
    waits once, on that copy's event. Then the device time of a no-op wave
    (one run after the tree is done)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from lightgbm_tpu_torch.models.gbdt import _pack_gh
    from lightgbm_tpu_torch.ops.wave import DONE

    gbdt = booster._gbdt
    learner = gbdt.tree_learner
    g, h = gbdt.objective.get_gradients(gbdt.score[0])
    gh_ext = _pack_gh(g, h)
    adaptive, learner._adaptive_wave = learner._adaptive_wave, False  # one width
    learner.train(gh_ext)  # its width's graphs captured
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_tree"):
            tree = learner.train(gh_ext)  # ends in the results' copy, which waits
    learner._adaptive_wave = adaptive
    launched = learner.last_waves_launched
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    # the tree's span on the host clock (the profiler's own calls lie outside)
    span = next(e for e in events if e.get("name") == "chip_smoke_tree"
                and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation")
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    inside = [e for e in events if e.get("ph") == "X" and t0 <= float(e.get("ts", -1)) <= t1]
    d2h = [e for e in inside if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    nbytes = [int(e.get("args", {}).get("bytes", 0)) for e in d2h]
    syncs = [e["name"] for e in inside if e.get("cat") == "cuda_runtime"
             and "Synchronize" in e.get("name", "")]
    graphs = sum(1 for e in inside if e.get("cat") == "cuda_runtime"
                 and e.get("name", "").startswith("cudaGraphLaunch"))
    results = learner._buffers.results.numel()
    print(f"{tag} train ({label}): one tree of {tree.num_leaves} leaves, {launched} waves "
          f"run in its graph ({graphs} graph launches in the trace): {len(d2h)} "
          f"device-to-host copies, {sum(nbytes)} bytes ({sorted(set(nbytes))} apiece; the "
          f"results {results}), {len(syncs)} host synchronizations "
          f"({', '.join(f'{n} {syncs.count(n)}' for n in sorted(set(syncs)))}) "
          "(torch.profiler trace, the tree's span)")
    buf, K = learner._buffers, learner.wave_k
    buf.scalars[DONE:DONE + 1].fill_(1)
    wave_graphs = (buf.graphs[(K, 0, False)], buf.graphs[(K, 1, False)])

    def noop():
        for graph in wave_graphs:
            graph.replay()

    noop_ms = cuda_ms(noop, 20) / 2
    scatter = (device_kernel_ms(noop, 10, ("scatter_kernel",)) or {}).get("scatter_kernel")
    print(f"{tag} train ({label}): a no-op wave (a wave graph run after the tree is done, "
          f"K = {K}): {noop_ms:.4f} ms of device time a run (CUDA events), of which the "
          f"partition's copy of the carry (scatter_kernel, torch.profiler) "
          f"{fmt_ms(None if scatter is None else scatter / 2)}")
    check(len(d2h) == 1 and nbytes == [results],
          f"train ({label}): {len(d2h)} device-to-host copies of {nbytes} bytes for one "
          f"tree, not the results' one copy of {results}")
    check(syncs == ["cudaEventSynchronize"],
          f"train ({label}): host synchronizations {syncs} for one tree, not the wait on "
          "its results' event")


def drive_training(lt, libs, params, train_set, valid, rounds, required, tag, label):
    """One training path through lt.train, with every launch count set to 0
    just before it and read just after: rounds on the 1,048,576 x 28 data
    with the validation set; checks full-size trees, the reloaded model's
    predictions, the valid AUC and that every kernel in `required`
    launched; prints s/iteration, the host scopes and the device's busy
    share over one profiled round. Returns what the caller reports."""
    from lightgbm_tpu_torch.utils.timer import global_timer

    for lib in libs:
        lib.reset_launches()
    stamps, evals, hist_rows, waves = [], {}, [], [0]

    first = {}

    def after(env):
        stamps.append(time.perf_counter())
        hist_rows.append(getattr(env.model._gbdt.tree_learner, "last_hist_rows", 0))
        waves.append(global_timer.counters.get("device_waves", 0))
        if len(stamps) == 1:
            first.update(global_timer.totals)

    global_timer.reset()
    global_timer.enabled = True  # host-clock scopes of the learner's steps
    t_train = time.perf_counter()
    trained = lt.train(dict(params), train_set, num_boost_round=rounds,
                       valid_sets=[train_set.create_valid(valid[0], label=valid[1])],
                       valid_names=["valid"],
                       callbacks=[after, lt.record_evaluation(evals)])
    train_wall = time.perf_counter() - t_train
    global_timer.enabled = False
    launches = {}
    for lib in libs:
        launches.update(lib.launches)
    scopes = {k: (v, global_timer.counts[k]) for k, v in global_timer.totals.items()}
    counters = dict(global_timer.counters)
    leaves = [tr.num_leaves for tr in trained._gbdt.models]
    check(len(leaves) == rounds, f"train ({label}): {len(leaves)} trees for {rounds} rounds")
    check(all(n == params["num_leaves"] for n in leaves),
          f"train ({label}): trees stopped short of {params['num_leaves']} leaves: {leaves}")
    text = trained.model_to_string()
    reloaded = lt.Booster(model_str=text)
    pred_trained = trained.predict(valid[0], raw_score=True)
    check(bool(np.isfinite(pred_trained).all()), f"train ({label}): non-finite predictions")
    check(bool(np.array_equal(pred_trained, reloaded.predict(valid[0], raw_score=True))),
          f"train ({label}): the reloaded model predicts differently from the training "
          "Booster")
    train_auc = dict((name, val) for _, name, val, _ in trained.eval_train())["auc"]
    valid_auc = evals["valid"]["auc"]
    check(0.5 < valid_auc[-1] <= 1.0 and valid_auc[-1] >= valid_auc[0],
          f"train ({label}): valid AUC {valid_auc}")
    for name in required:
        check(launches[name] > 0, f"training path ({label}): kernel {name} never launched")
    n_rows = train_set.num_data()
    per_iter = np.diff([t_train] + stamps)
    steady = float(np.mean(per_iter[1:])) if len(per_iter) > 1 else float(per_iter[0])
    print(f"{tag} train ({label}): {n_rows} x {train_set.num_feature()}, {rounds} rounds in "
          f"{train_wall:.2f} s; s/iteration first {per_iter[0]:.3f}, mean of the rest "
          f"{steady:.3f} ({n_rows / steady:,.0f} row-iterations/s); leaves per tree "
          f"{sorted(set(leaves))}; train AUC {train_auc:.5f}, valid AUC {valid_auc[0]:.5f} "
          f"-> {valid_auc[-1]:.5f}")
    print(f"train ({label}): model text {len(text)} bytes reloads and predicts "
          f"{len(valid[1])} rows equal to the training Booster")
    print(f"training path ({label}) launches: {launches} (per tree: " + ", ".join(
        f"{name} {launches[name] / rounds:.1f}" for name in required) + ")")
    # host-clock scopes: a step's device work lands in the scope that next
    # waits on the card, so the split is approximate
    print(f"{tag} train ({label}) scopes (host s over {rounds} rounds): " + ", ".join(
        f"{k} {v:.3f} ({n})" for k, (v, n) in sorted(scopes.items(),
                                                      key=lambda kv: -kv[1][0])))
    learner = trained._gbdt.tree_learner
    if hasattr(learner, "last_waves_launched"):
        runs = counters.get("wave_graph_runs", 0)
        noops = counters.get("wave_noops", 0)
        trees = counters.get("tree_graph_launches", 0)
        check(trees == len(trained._gbdt.models) and runs == counters["device_waves"] + noops,
              f"train ({label}): {trees} tree graph launches for "
              f"{len(trained._gbdt.models)} trees, {runs} wave runs for "
              f"{counters['device_waves']} live and {noops} no-op waves")
        # host time enqueueing a tree, its graphs' captures (first use) apart
        tree_s = scopes["tree_device"][0] - scopes.get("tree_capture", (0.0, 0))[0]
        print(f"{tag} train ({label}): per tree one graph launch, {runs / trees:.1f} waves "
              f"run in it, {noops / trees:.1f} of them no-op waves (after the tree was "
              f"done); host time a tree {tree_s / trees * 1e3:.4f} ms (tree_device less "
              f"tree_capture, {tree_s:.3f} s over {trees} trees; tree_stage "
              f"{scopes['tree_stage'][0] / trees * 1e3:.4f}, tree_launch "
              f"{scopes['tree_launch'][0] / trees * 1e3:.4f} ms a tree), the wait for a "
              f"tree's results {scopes['tree_results'][0] / trees * 1e3:.4f} ms a tree")
        part = {k: first.get(k, 0.0) for k in ("wave_buffers", "tree_capture", "tree_device",
                                                 "tree_results")}
        tree1 = part["tree_device"] - part["tree_capture"]
        rest = per_iter[0] - part["wave_buffers"] - part["tree_device"] - part["tree_results"]
        captures = scopes.get("tree_capture", (0.0, 0))
        print(f"{tag} train ({label}): first iteration {per_iter[0]:.3f} s: buffer allocation "
              f"{part['wave_buffers']:.3f} s, the tree graph's captures (with the eager "
              f"root and warm-up wave that load the kernels) {part['tree_capture']:.3f} s, "
              f"the first tree {tree1:.3f} s (+ its results {part['tree_results']:.3f} s), the "
              f"rest (data to the card, gradients, scores, metrics) {rest:.3f} s; tree graphs "
              f"captured in the run {captures[1]} ({captures[0]:.3f} s)")
        tree_transfers(trained, tag, label)
    # one steady round: a booster that has already taken one step
    profile_round(lt, params, train_set, tag, label)
    return {"launches": launches, "learner": trained._gbdt.tree_learner,
            "counters": counters, "hist_rows": hist_rows, "waves": np.diff(waves),
            "per_iter": per_iter, "auc": (train_auc, valid_auc[-1]), "valid_auc": valid_auc,
            "booster": trained}


def check_tree_loop(learner):
    """The tree graph's loop-condition kernel (tree_loop_cond_kernel) at the
    main path's shapes: the last tree of the wave learner grown again from
    its staged inputs by its tree graph (the WHILE node run by the kernel)
    and by the host's loop (`_waves_eager`, the condition read on the
    host), on the card: the split log's bits, the scalars and the passes
    equal. Returns (timings, bound, passes): the kernel's device time a
    launch (torch.profiler over whole tree launches, divided by the launches
    a tree makes) and the plain condition's host time (one read of the done
    word)."""
    from lightgbm_tpu_torch.ops.wave import DONE
    from lightgbm_tpu_torch.treelearner import device as dmod

    buf = learner._buffers
    (K, masked, bagged), tree_graph = next(iter(buf.trees.items()))
    cfg = learner.config
    args = (learner.meta, learner.tables, learner.params_dev)

    def root():
        dmod._root(buf, learner.bins_dev, args[0], args[2], masked, bagged,
                   learner.group_bin_padded, cfg.max_depth)

    def wave(cur):
        dmod._wave(buf, cur, K, *args, masked, learner.group_bin_padded, cfg.max_depth)

    tree_graph.launch()
    torch.cuda.synchronize()
    graphed = buf.results.clone()
    root()
    passes = dmod._waves_eager(buf, 1 if bagged else 0, wave, cfg.num_leaves)
    torch.cuda.synchronize()
    check(torch.equal(graphed, buf.results),
          "tree_loop_cond: the tree graph's split log, scalars or passes differ from the "
          "host loop's on the same inputs")
    check(passes >= 1, "tree_loop_cond: the re-grown tree ran no pass")
    per_tree = (device_kernel_ms(tree_graph.launch, 5, ("tree_loop_cond",)) or {}).get(
        "tree_loop_cond")
    timings = {"kernel": None if per_tree is None else per_tree / (1 + passes),
               "plain": host_ms(lambda: int(buf.scalars[DONE]), 50)}
    return timings, bound(perfmodel.tree_loop_cond()), passes


def drive_multiclass(lt, libs, seed, tag):
    """Phase 10: multiclass at Covertype's width. Returns what the caller
    reports and the launches of the phase's main path."""
    from lightgbm_tpu_torch.serving import PredictionService, serve, wire
    from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner
    from lightgbm_tpu_torch.utils.timer import global_timer

    t0 = time.perf_counter()
    X, y = covertype_rows(seed + 11, COVTYPE_ROWS + MC_VALID_ROWS)
    X_valid, y_valid = X[COVTYPE_ROWS:], y[COVTYPE_ROWS:]
    X, y = X[:COVTYPE_ROWS], y[:COVTYPE_ROWS]
    shares = np.bincount(y.astype(int), minlength=7) / len(y)
    train_set = lt.Dataset(X, label=y, params={"max_bin": MC_PARAMS["max_bin"]}).construct()
    core = train_set._handle
    bundled = sum(1 for g in core.groups if g.is_multi)
    print(f"multiclass data: {len(y)} x {X.shape[1]} Covertype-shaped rows binned into "
          f"{core.num_groups} groups ({bundled} EFB bundles) in "
          f"{time.perf_counter() - t0:.1f} s; class shares "
          + " ".join(f"{v:.4f}" for v in shares))
    check(bundled >= 1, "multiclass: EFB bundled none of the one-hot columns")

    # at a reduced size, the card trains as the CPU does (snapped gradients)
    Xe, ye = X[:MC_EXACT_ROWS], y[:MC_EXACT_ROWS]
    exact = {**MC_PARAMS, "objective": snapped_softmax, "num_leaves": MC_EXACT_LEAVES,
             "metric": "None", "is_provide_training_metric": False}
    for label, extra in (("wave", {}), ("serial", {"feature_fraction_bynode": 0.8})):
        t = time.perf_counter()
        card = lt.train({**exact, **extra}, lt.Dataset(Xe, label=ye),
                        num_boost_round=MC_EXACT_ROUNDS)
        t_card = time.perf_counter() - t
        check(isinstance(card._gbdt.tree_learner, DeviceTreeLearner) == (label == "wave"),
              f"multiclass exact ({label}): the card trained with the wrong learner")
        t = time.perf_counter()
        if label == "wave":
            host_set = lt.Dataset(Xe, label=ye)
            host = lt.Booster({**exact, **extra, "objective": "none", "device_type": "cpu",
                               "num_iterations": MC_EXACT_ROUNDS}, host_set)
            host._gbdt.tree_learner = DeviceTreeLearner(host._gbdt.config, host_set._handle,
                                                        torch.device("cpu"))
            for _ in range(MC_EXACT_ROUNDS):
                host.update(fobj=snapped_softmax)
        else:
            host = lt.train({**exact, **extra, "device_type": "cpu"}, lt.Dataset(Xe, label=ye),
                            num_boost_round=MC_EXACT_ROUNDS)
        t_host = time.perf_counter() - t
        text = card.model_to_string()
        check(text == host.model_to_string(),
              f"multiclass exact ({label}): the card's model text differs from the CPU's on "
              "snapped gradients")
        print(f"multiclass exact ({label}): {MC_EXACT_ROWS} rows, {MC_EXACT_ROUNDS} rounds x 7 "
              f"trees, snapped softmax gradients: card and CPU model texts byte-equal "
              f"({len(text)} bytes; card {t_card:.1f} s, CPU {t_host:.1f} s)")

    for lib in libs:
        lib.reset_launches()
    global_timer.reset()
    global_timer.enabled = True
    runs = {}
    for label, extra, rounds in (("wave", {}, MC_ROUNDS),
                                 ("serial", {"feature_fraction_bynode": 0.8},
                                  MC_SERIAL_ROUNDS)):
        stamps, evals = [], {}
        t = time.perf_counter()
        bst = lt.train({**MC_PARAMS, **extra}, train_set, num_boost_round=rounds,
                       valid_sets=[train_set, train_set.create_valid(X_valid, label=y_valid)],
                       valid_names=["training", "valid"],
                       callbacks=[lambda env: stamps.append(time.perf_counter()),
                                  lt.record_evaluation(evals)])
        per_iter = np.diff([t] + stamps)
        check(isinstance(bst._gbdt.tree_learner, DeviceTreeLearner) == (label == "wave"),
              f"multiclass ({label}): trained with the wrong learner")
        check(bst.num_trees() == 7 * rounds, f"multiclass ({label}): {bst.num_trees()} trees")
        loss = evals["training"]["multi_logloss"]
        check(all(b < a for a, b in zip(loss, loss[1:])),
              f"multiclass ({label}): train multi_logloss did not fall every round: {loss}")
        verr = evals["valid"]["multi_error"]
        check(verr[-1] < COVTYPE_MAJORITY_ERROR,
              f"multiclass ({label}): valid multi_error {verr[-1]} not below the majority "
              f"class's {COVTYPE_MAJORITY_ERROR:.4f}")
        steady = float(np.mean(per_iter[1:])) if len(per_iter) > 1 else float(per_iter[0])
        runs[label] = bst
        print(f"{tag} multiclass ({label}): {len(y)} x 54, 7 classes, {rounds} rounds "
              f"({7 * rounds} trees); s/iteration first {per_iter[0]:.3f}, mean of the rest "
              f"{steady:.3f} ({steady / 7:.4f} s a tree); leaves per tree "
              f"{sorted(set(tr.num_leaves for tr in bst._gbdt.models))}; train multi_logloss "
              + " ".join(f"{v:.5f}" for v in loss) + f"; valid multi_logloss "
              f"{evals['valid']['multi_logloss'][-1]:.5f}, multi_error {verr[0]:.5f} -> "
              f"{verr[-1]:.5f} (the majority class's {COVTYPE_MAJORITY_ERROR:.5f})")
    bst = runs["wave"]
    prob = bst.predict(X_valid)
    check(prob.shape == (MC_VALID_ROWS, 7) and bool(np.isfinite(prob).all()),
          f"multiclass: predictions of shape {prob.shape}")
    row_sum = float(np.abs(prob.astype(np.float64).sum(axis=1) - 1.0).max())
    check(row_sum <= 1e-6, f"multiclass: predicted rows sum to 1 within {row_sum}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mc_") as tmp:
        path = os.path.join(tmp, "covertype.txt")
        bst.save_model(path)
        reloaded = lt.Booster(model_file=path)
        check(bool(np.array_equal(reloaded.predict(X_valid), prob))
              and bool(np.array_equal(reloaded.predict(X_valid, raw_score=True),
                                      bst.predict(X_valid, raw_score=True))),
              "multiclass: the reloaded model predicts differently")
        svc = PredictionService(max_batch_rows=4096, min_bucket=64, batch_window_s=0.001)
        server, server_thread = serve(svc, port=0)
        base = f"http://127.0.0.1:{server.port}"
        try:
            req = urllib.request.Request(
                base + "/models", data=json.dumps({"name": "covertype", "path": path}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                check(resp.status == 200, "multiclass serving: model upload refused")
            for i in range(8):
                rows = X_valid[i * 64:(i + 1) * 64]
                r = urllib.request.Request(base + "/predict",
                                           data=wire.encode_request("covertype", rows),
                                           headers={"Content-Type": wire.CONTENT_TYPE},
                                           method="POST")
                with urllib.request.urlopen(r, timeout=120) as resp:
                    got = wire.decode_response(resp.read())[0]
                check(bool(np.array_equal(got, bst.predict(rows))),
                      f"multiclass serving: request {i} differs from Booster.predict")
        finally:
            server.shutdown()
            server.server_close()
            svc.close()
            server_thread.join(timeout=10)
    global_timer.enabled = False
    launches = {}
    for lib in libs:
        launches.update(lib.launches)
    print(f"multiclass: {MC_VALID_ROWS} valid rows predicted as [N, 7], rows sum to 1 within "
          f"{row_sum:.2e}; the model reloads and predicts bit-equal; 8 requests of 64 rows "
          "served over the binary wire bit-equal to Booster.predict")
    print(f"multiclass path launches: {launches}")
    return launches


def async_pass(lt, train_set, asyn):
    """2 x ASYNC_ROUNDS Booster.update() rounds on the main path's data at a
    float32-exact learning rate, with the pipeline on or off. Each tree
    graph's time on the card comes from CUDA events around its launch (the
    profiler records no kernel of a tree graph that runs beside the host's
    launches, as the pipeline's do). Returns per round the host seconds,
    whether it captured a graph (a new wave width) and the card's
    milliseconds in tree graphs; the model text; the final train score;
    whether a tree was pending at the end; the host scopes."""
    from lightgbm_tpu_torch.ops import wave_cuda
    from lightgbm_tpu_torch.utils.timer import global_timer

    bst = lt.Booster(dict(ASYNC_PARAMS), train_set)
    bst._gbdt._async_pipeline = asyn
    launch, events = wave_cuda.TreeGraph.launch, []

    def timed(graph):
        pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record()
        launch(graph)
        pair[1].record()
        events.append(pair)

    stamps, captured = [], []
    global_timer.reset()
    global_timer.enabled = True
    wave_cuda.TreeGraph.launch = timed
    try:
        t = time.perf_counter()
        for _ in range(2 * ASYNC_ROUNDS):
            captures = global_timer.counts.get("tree_capture", 0)
            bst.update()
            stamps.append(time.perf_counter())
            captured.append(global_timer.counts.get("tree_capture", 0) > captures)
        torch.cuda.synchronize()
        stamps[-1] = time.perf_counter()  # the last tree's work on the card included
    finally:
        wave_cuda.TreeGraph.launch = launch
        global_timer.enabled = False
    per_iter = np.diff([t] + stamps)
    graph_ms = [a.elapsed_time(b) for a, b in events]
    pending = bst._gbdt._pending is not None
    scopes = {k: (v, global_timer.counts[k]) for k, v in global_timer.totals.items()}
    text = bst.model_to_string()  # flushes the pending tree
    return (per_iter, np.asarray(captured), graph_ms, text, bst._gbdt.score.clone(), pending,
            scopes)


def profile_async(lt, train_set, asyn, rounds=3):
    """Device-to-host copies and host synchronizations a tree over `rounds`
    steady updates of a booster that has taken two (its pipeline full when
    on), from a torch.profiler trace of the runtime calls."""
    from torch.profiler import ProfilerActivity, profile, record_function

    bst = lt.Booster(dict(ASYNC_PARAMS), train_set)
    bst._gbdt._async_pipeline = asyn
    bst.update()
    bst.update()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_rounds"):
            for _ in range(rounds):
                bst.update()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    # the rounds' span on the host clock (the profiler's own calls lie outside)
    span = next(e for e in events if e.get("name") == "chip_smoke_rounds"
                and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation")
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    calls = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
             and t0 <= float(e.get("ts", -1)) <= t1]
    # a copy's device event may land after the span: count the copies the
    # rounds enqueued (their runtime calls) by the bytes of their device events
    d2h = [int(e.get("args", {}).get("bytes", 0)) for e in events if e.get("ph") == "X"
           and e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")
           and float(e.get("ts", -1)) >= t0]
    syncs = [e["name"] for e in calls if "Synchronize" in e.get("name", "")]
    bst.model_to_string()
    return d2h, syncs, bst._gbdt.tree_learner._buffers.results.numel()


def drive_async(lt, libs, train_set, tag):
    """Phase 11: the async pipeline against the synchronous path on the main
    path's data. Returns the launches of the phase and the report."""
    for lib in libs:
        lib.reset_launches()
    out = {}
    for label, asyn in (("async", True), ("sync", False)):
        out[label] = async_pass(lt, train_set, asyn)
    sched = async_schedule_pair(lt, train_set)
    launches = {}
    for lib in libs:
        launches.update(lib.launches)
    text_a, score_a, pend_a = out["async"][3:6]
    text_s, score_s, pend_s = out["sync"][3:6]
    check(pend_a and not pend_s, f"async: a tree pending after the last update: async "
          f"{pend_a}, sync {pend_s}")
    check(text_a == text_s, "async: the model text differs from the synchronous path's")
    check(torch.equal(score_a, score_s), "async: the train score differs from the "
          "synchronous path's")
    report = {}
    for label, asyn in (("async", True), ("sync", False)):
        per_iter, captured, graph_ms, _, _, _, scopes = out[label]
        check(len(graph_ms) == len(per_iter), f"async ({label}): {len(graph_ms)} tree graph "
              f"launches in {len(per_iter)} rounds")
        graph_ms = np.asarray(graph_ms if graph_ms else [np.nan] * len(per_iter))
        window = {}
        rounds = np.arange(len(per_iter))
        for name, lo, hi in (("first", 1, ASYNC_ROUNDS), ("then", ASYNC_ROUNDS,
                                                          2 * ASYNC_ROUNDS)):
            # s/iteration over the window's rounds that captured no graph (a
            # capture is a new width's one-time cost); the card's share over
            # all of them (a pipelined tree's card time lands in the next
            # round, so the share of a single round can pass 100%)
            inside = (rounds >= lo) & (rounds < hi)
            keep = inside & ~captured
            window[name] = (float(per_iter[keep].mean()), float(graph_ms[inside].sum()) / 1e3
                            / float(per_iter[inside].sum()), float(graph_ms[inside].mean()),
                            int(keep.sum()))
        d2h, syncs, results = profile_async(lt, train_set, asyn)
        report[label] = window
        f, th = window["first"], window["then"]
        print(f"{tag} async phase ({label}): {train_set.num_data()} x "
              f"{train_set.num_feature()}, Booster.update() at learning rate 0.125; rounds "
              f"1-{ASYNC_ROUNDS}: s/iteration first {per_iter[0]:.4f}, mean of the rest "
              f"{per_iter[1:ASYNC_ROUNDS].mean():.4f}, mean of the {f[3]} of them that captured "
              f"no graph {f[0]:.4f}, the card in tree graphs {f[2]:.2f} ms a tree (CUDA "
              f"events), {f[1]:.1%} of rounds 2-{ASYNC_ROUNDS}' wall; rounds "
              f"{ASYNC_ROUNDS + 1}-{2 * ASYNC_ROUNDS}: {th[0]:.4f} s/iteration over the {th[3]} "
              f"that captured no graph, {th[2]:.2f} ms a tree in tree graphs, {th[1]:.1%} of "
              f"the wall; a tree (3 "
              f"profiled rounds) {len(d2h) / 3:.1f} device-to-host copies "
              f"({sorted(set(d2h))} bytes apiece), {len(syncs) / 3:.1f} host synchronizations ("
              + ", ".join(f"{n} {syncs.count(n)}" for n in sorted(set(syncs)))
              + ") (torch.profiler trace)")
        print(f"{tag} async phase ({label}) scopes (host s over {2 * ASYNC_ROUNDS} rounds): "
              + ", ".join(f"{k} {v:.4f} ({n})" for k, (v, n) in
                          sorted(scopes.items(), key=lambda kv: -kv[1][0])))
        if asyn:
            # the pipeline's steady round: the results' one copy a tree and
            # the one wait on its event, nothing else
            check(d2h == [results] * 3 and syncs == ["cudaEventSynchronize"] * 3,
                  f"async: {d2h} device-to-host copies and {syncs} host synchronizations in "
                  "three rounds, not one results copy and one wait a tree")
    print(f"async: {2 * ASYNC_ROUNDS} rounds, model text ({len(text_a)} bytes) byte-equal and "
          "the final train score bit-equal to the synchronous path's")
    (text_a, score_a, pend_a), (text_s, score_s, _) = sched[True], sched[False]
    check(pend_a, "async (rate schedule): no tree pending after the last update")
    check(text_a == text_s and torch.equal(score_a, score_s),
          "async (rate schedule): the model text or the final train score differs from the "
          "synchronous path's")
    print(f"async, callback.reset_parameter(learning_rate=[0.125] * {ASYNC_ROUNDS} + [0.0625] "
          f"* {ASYNC_ROUNDS}): {2 * ASYNC_ROUNDS} rounds, model text ({len(text_a)} bytes) "
          "byte-equal and the final train score bit-equal to the synchronous path's")
    print(f"async path launches: {launches}")
    return launches, report


# ---------------------------------------------------------------------------
# phase 12: quantized-gradient training

QUANT_PARAMS = {"use_quantized_grad": True, "num_grad_quant_bins": 4,
                "quant_train_renew_leaf": True}
QUANT_SERIAL_ROUNDS = 3
# the JAX package's own margin for quantized against float training
# (tests/test_quantized.py:32-38)
QUANT_AUC_MARGIN = 0.003


def host_logloss(preds, dataset):
    """The binary logloss gradients computed on the host, unsnapped. The
    card's torch.exp differs from the CPU's in the last bit on a share of
    float32 inputs, so the built-in objective's gradients differ between
    the two too; these are the same bits on both."""
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - dataset.get_label(), p * (1.0 - p)


def host_softmax(preds, dataset):
    """The softmax gradients computed on the host, unsnapped, class-major."""
    p = np.exp(preds - preds.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    onehot = np.eye(preds.shape[1])[dataset.get_label().astype(int)]
    factor = preds.shape[1] / (preds.shape[1] - 1.0)
    return (p - onehot).T.ravel(), (factor * p * (1.0 - p)).T.ravel()


def check_quantize(sets):
    """The discretizer (csrc/quantize.cu, two launches) against its plain
    version on the card on the same gradients: sets {name: (grad, hess,
    cases)}, each case (num_grad_quant_bins, stochastic rounding, hessian
    replaced by ones); the int8 rows, the sentinel and both scales
    bit-equal (and, in each set's first case, equal to the plain version run
    on the CPU). Timed on the "final" set. Returns (timings, bounds)."""
    from lightgbm_tpu_torch.ops import quantize_cuda
    from lightgbm_tpu_torch.ops.quantize import _quantize_gh_plain, prng_key, split_key

    _, key = split_key(prng_key(1))  # the first tree's key at data_random_seed=1
    for label, (grad, hess, cases) in sets.items():
        n = grad.shape[0]
        for i, (bins, stochastic, ones) in enumerate(cases):
            h = torch.ones_like(hess) if ones else hess
            got, scale = quantize_cuda.quantize(grad, h, key, bins, stochastic)
            again, _ = quantize_cuda.quantize(grad, h, key, bins, stochastic)
            ref, ref_scale = _quantize_gh_plain(grad, h, key, bins, stochastic)
            const = bool(float(scale[1]) == float(h.abs().max()))
            what = (f"quantize ({label} gradients, {bins} bins, "
                    f"{'stochastic' if stochastic else 'nearest'}"
                    f"{', hessian of ones' if ones else ''})")
            check(torch.equal(got, again), f"{what}: two launches differ")
            check(torch.equal(got, ref), f"{what}: int8 rows differ from the plain version")
            check(torch.equal(scale.view(torch.int32), ref_scale.view(torch.int32)),
                  f"{what}: scales differ from the plain version")
            check(bool((got[-1] == 0).all()) and bool((got[:-1, 2] == 1).all()),
                  f"{what}: the sentinel or the count channel is wrong")
            check(not const or bool((got[:-1, 1] == 1).all()), f"{what}: h_int is not 1")
            if i == 0:
                host, host_scale = _quantize_gh_plain(grad.cpu(), h.cpu(), key, bins,
                                                      stochastic)
                check(torch.equal(got.cpu(), host) and torch.equal(
                    scale.cpu().view(torch.int32), host_scale.view(torch.int32)),
                      f"{what}: differs from the plain version run on the CPU")
            values, cnt = torch.unique(got[:-1, 0].to(torch.int64), return_counts=True)
            print(f"kernels: {what}: {n} rows bit-equal to the plain version (scales "
                  f"{float(scale[0]):.9g}, {float(scale[1]):.9g}, "
                  f"{'a constant' if const else 'a varying'} hessian; h_int "
                  f"{int(got[:-1, 1].min())}..{int(got[:-1, 1].max())}; g_int counts "
                  f"{dict(zip(values.tolist(), cnt.tolist()))})")
    grad, hess, _ = sets["final"]
    n = grad.shape[0]

    def kern():
        return quantize_cuda.quantize(grad, hess, key, 4, True)

    timings = {"kernel": cuda_ms(kern, 50),
               "plain": cuda_ms(lambda: _quantize_gh_plain(grad, hess, key, 4, True), 5)}
    timings.update(device_kernel_ms(kern, 20, ("quantize_reduce_kernel", "quantize_kernel"))
                   or {})
    bounds = {"quantize_reduce": bound(perfmodel.quantize_reduce(n)),
              "quantize": bound(perfmodel.quantize(n))}
    return timings, bounds


def quantized_search_inputs(lt, dev, train_set, gh_q, scale):
    """A real quantized tree's root and first wave, run eagerly on the card
    (`_root`, then `_wave`) into a quantized wave learner's buffers: the
    int32 histograms and totals its split search was given at the root and
    at the wave's 2 * WAVE_K children."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.treelearner import device as dmod

    core = train_set._handle
    learner = dmod.DeviceTreeLearner(Config({**WAVE_PARAMS, **QUANT_PARAMS}), core, dev)
    buf = learner._buffers
    buf.gh.copy_(gh_q[:-1])
    buf.leaf0.zero_()
    buf.scale.copy_(scale)
    B, depth = learner.group_bin_padded, learner.config.max_depth
    real, got = dmod.find_best_split, {}

    def record(hist, totals, *args, **kwargs):
        got.setdefault("wave" if hist.dim() == 4 else "root", (hist.clone(), totals.clone()))
        return real(hist, totals, *args, **kwargs)

    dmod.find_best_split = record
    try:
        dmod._root(buf, learner.bins_dev, learner.meta, learner.params_dev, False, False, B,
                   depth)
        dmod._wave(buf, 0, WAVE_K, learner.meta, learner.tables, learner.params_dev, False,
                   B, depth)
    finally:
        dmod.find_best_split = real
    torch.cuda.synchronize()
    check(set(got) == {"root", "wave"}, f"the quantized tree searched {sorted(got)}")
    check(got["root"][0].dtype == torch.int32 and got["wave"][0].shape[0] == 2 * WAVE_K,
          "the quantized search was not given int32 histograms of the wave's children")
    return got, learner


def check_quantized_modes(dev, core, learner, got, gh_q, scale):
    """The integer modes on the quantized path: the split kernel's int32
    input at the root and the wave's children (records bit-equal to the
    plain version run on the CPU), the leaf histogram's and the ragged
    histogram's integer modes over every row (exactly equal to their plain
    versions on the card), each timed. Returns (timings, bounds)."""
    from lightgbm_tpu_torch.ops import hist_cuda
    from lightgbm_tpu_torch.ops import split as ts
    from lightgbm_tpu_torch.ops.histogram import (_build_histogram_rows_plain,
                                                  _histogram_slots_ragged_plain)

    meta_d = learner.meta
    B = learner.group_bin_padded
    meta_h = ts.make_feature_meta(core, B, "cpu")
    params_d, params_h = learner.params_dev, learner.params_dev.cpu()
    scale_h = scale.cpu()
    for name, (hist, tot) in got.items():
        rec = ts.find_best_split(hist, tot, meta_d, params_d, scale=scale)
        ref = ts.find_best_split(hist.cpu(), tot.cpu(), meta_h, params_h, scale=scale_h)
        check(torch.equal(rec.cpu().view(torch.int32), ref.view(torch.int32)),
              f"find_best_split (int32, {name}): records differ from the plain version")
        check(bool((rec[..., 1] >= 0).any()), f"find_best_split (int32, {name}): no split")
    (h1, t1), (hw, tw) = got["root"], got["wave"]
    host_tot = tuple(float(v) for v in t1.cpu())

    def one():  # as the serial learner calls it: host totals
        return ts.find_best_split(h1, host_tot, meta_d, params_d, scale=scale)

    def batch():  # as the wave calls it
        return ts.find_best_split(hw, tw, meta_d, params_d, scale=scale)

    bins = learner.bins_dev
    G, N = bins.shape
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    payload = gh_q[:-1].to(torch.float32)  # the wave learner's payload columns
    slot = torch.zeros(N, dtype=torch.int32, device=dev)
    starts = torch.zeros(1, dtype=torch.int32, device=dev)
    ends = torch.full((1,), N, dtype=torch.int32, device=dev)
    valid = torch.ones(1, dtype=torch.bool, device=dev)

    def rows_int():
        return hist_cuda.histogram(bins, gh_q, idx, B, N)

    def ragged_int():
        return hist_cuda.histogram_ragged(bins, payload, slot, starts, ends, valid, B, 1, True)

    check(torch.equal(rows_int(), _build_histogram_rows_plain(bins, gh_q, idx, B, N)),
          "histogram (integer mode, every row): differs from the plain version")
    check(torch.equal(ragged_int(), _histogram_slots_ragged_plain(
        bins, payload, slot, starts, ends, valid, B, 1, True)),
          "ragged histogram (integer mode, every row): differs from the plain version")
    check(torch.equal(rows_int(), ragged_int()),
          "the two integer histograms of every row differ")
    check(torch.equal(rows_int(), h1), "the quantized root histogram differs from every "
          "row's integer histogram")
    timings = {
        "one": kernel_device_ms(one, 20, "split_kernel"), "one_events": cuda_ms(one, 50),
        "batch": kernel_device_ms(batch, 20, "split_kernel"),
        "batch_events": cuda_ms(batch, 50),
        "plain_one": cuda_ms(lambda: ts._find_best_split_plain(
            h1.to(torch.float32) * scale, t1, meta_d, params_d), 5),
        "plain_batch": cuda_ms(lambda: ts._find_best_split_plain(
            hw.to(torch.float32) * scale, tw, meta_d, params_d), 5),
        "rows": kernel_device_ms(rows_int, 20, "hist_rows_kernel"),
        "rows_events": cuda_ms(rows_int, 20),
        "ragged": kernel_device_ms(ragged_int, 20, "hist_ragged_kernel"),
        "ragged_events": cuda_ms(ragged_int, 20),
        "plain_rows": cuda_ms(lambda: _build_histogram_rows_plain(bins, gh_q, idx, B, N), 3),
        "plain_ragged": cuda_ms(lambda: _histogram_slots_ragged_plain(
            bins, payload, slot, starts, ends, valid, B, 1, True), 3),
    }
    F, Bf = meta_h.gather_index.shape
    out = G * B * 3 * 4
    bounds = {"one": bound(perfmodel.find_best_split(F, Bf, quantized=True)),
              "batch": bound(perfmodel.find_best_split(F, Bf, 2 * WAVE_K, quantized=True)),
              "rows": bound(perfmodel.hist_rows(N, G, out, gh_bytes=3)),
              "ragged": bound(perfmodel.hist_ragged(N, G, 1, out))}
    for key in ("one", "batch", "rows", "ragged"):
        print(f"kernels: integer mode {key}: {fmt_ms(timings[key])} of device time a call "
              f"(torch.profiler; CUDA events {timings[key + '_events']:.4f} ms), plain "
              f"{timings['plain_' + key]:.3f} ms, bound {bounds[key][0]:.5f} ms "
              f"({bounds[key][1]})")
    return timings, bounds


def _exact_card_cpu(lt, X, y, params, rounds, learner, fobj=None, group=None):
    """The card's and the CPU's model texts of one run, through `learner`
    ("wave": lt on the card against a CPU GBDT whose learner is the wave
    learner; "serial": feature_fraction_bynode 0.8 on both), on the custom
    objective `fobj` or, without one, on params' own (query sizes `group`
    for a ranking run), and the two runs' seconds and trees' leaf counts."""
    from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner

    extra = {"feature_fraction_bynode": 0.8} if learner == "serial" else {}
    if fobj is not None:
        extra["objective"] = "none"
    out = {}
    for where in ("card", "cpu"):
        t = time.perf_counter()
        ds = lt.Dataset(X, label=y, group=group)
        bst = lt.Booster({**params, **extra,
                          **({"device_type": "cpu"} if where == "cpu" else {})}, ds)
        if where == "cpu" and learner == "wave":
            bst._gbdt.tree_learner = DeviceTreeLearner(bst._gbdt.config, ds._handle,
                                                       torch.device("cpu"))
        check(isinstance(bst._gbdt.tree_learner, DeviceTreeLearner) == (learner == "wave"),
              f"exact ({learner}, {where}): trained with the wrong learner")
        for _ in range(rounds):
            bst.update(fobj=fobj)
        out[where] = (bst.model_to_string(), time.perf_counter() - t,
                      [tr.num_leaves for tr in bst._gbdt.models])
    return out


def drive_quantized(lt, libs, train_set, valid, X_train, y_train, float_runs, seed, tag):
    """Phase 12: quantized-gradient training. The discretizer and the
    integer modes against their plain versions, card and CPU model texts
    byte-equal in the exact runs, then the full-width runs through both
    learners beside phase 8's and 9's float runs. Returns (the launches of
    the phase's main path, timings and bounds for the kernels' record)."""
    from lightgbm_tpu_torch.ops.quantize import prng_key, quantize_gh, split_key

    dev = torch.device(DEVICE)
    # ---- kernels, on phase 8's first gradients (the binary objective at the
    # boost-from-average score: a constant hessian, on the card) and on its
    # gradients at its final scores (a varying one)
    objective = float_runs["wave"]["booster"]._gbdt.objective
    init = objective.boost_from_score(0)
    grad, hess = objective.get_gradients(
        torch.full((TRAIN_ROWS,), init, dtype=torch.float32, device=dev))
    grad_f, hess_f = objective.get_gradients(float_runs["wave"]["booster"]._gbdt.score[0])
    t_quant, b_quant = check_quantize({
        "first": (grad, hess, ((4, True, False), (16, False, False), (4, True, True))),
        "final": (grad_f, hess_f, ((4, True, False), (16, True, False), (4, False, False),
                                   (16, False, False)))})
    del grad_f, hess_f
    print(f"{tag} kernels: quantize ({TRAIN_ROWS} rows, phase 8's final gradients, 4 bins, "
          f"stochastic): reduce {fmt_ms(t_quant.get('quantize_reduce_kernel'))} + quantize "
          f"{fmt_ms(t_quant.get('quantize_kernel'))} of device time (torch.profiler), "
          f"{t_quant['kernel']:.4f} ms a call (CUDA events), plain {t_quant['plain']:.3f} ms; "
          f"bounds {b_quant['quantize_reduce'][0]:.5f} + {b_quant['quantize'][0]:.5f} ms "
          f"(bytes)")
    _, key = split_key(prng_key(1))
    gh_ext = torch.cat([torch.stack([grad, hess, torch.ones_like(grad)], 1),
                        torch.zeros((1, 3), device=dev)])
    gh_q, scale = quantize_gh(gh_ext[:-1, 0], gh_ext[:-1, 1], key, 4, True)
    got, learner = quantized_search_inputs(lt, dev, train_set, gh_q, scale)
    t_modes, b_modes = check_quantized_modes(dev, train_set._handle, learner, got, gh_q,
                                             scale)
    del learner, got, gh_ext, grad, hess
    torch.cuda.empty_cache()

    # ---- exact: the card trains as the CPU does
    Xe, ye = X_train[:EXACT_ROWS], y_train[:EXACT_ROWS]
    base = {**WAVE_PARAMS, **QUANT_PARAMS, "bagging_fraction": 0.8, "bagging_freq": 1,
            "metric": "None"}
    Xm, ym = covertype_rows(seed + 13, MC_EXACT_ROWS)
    mc = {**MC_PARAMS, **QUANT_PARAMS, "num_leaves": MC_EXACT_LEAVES, "bagging_fraction": 0.8,
          "bagging_freq": 1, "metric": "None"}
    for data, (X, y), params, rounds, fobjs in (
            ("binary", (Xe, ye), base, EXACT_ROUNDS, (host_logloss, snapped_logloss)),
            ("multiclass", (Xm, ym), mc, MC_EXACT_ROUNDS, (host_softmax, snapped_softmax))):
        for learner in ("wave", "serial"):
            for renew, fobj in zip((False, True), fobjs):
                out = _exact_card_cpu(lt, X, y, {**params, "quant_train_renew_leaf": renew},
                                      rounds, learner, fobj)
                what = (f"exact quantized ({data}, {learner}, renewal "
                        f"{'on, snapped' if renew else 'off, unsnapped'} gradients)")
                check(out["card"][0] == out["cpu"][0],
                      f"{what}: the card's model text differs from the CPU's")
                print(f"{what}: {len(y)} rows, {rounds} rounds, stochastic rounding, bagging "
                      f"0.8: card and CPU model texts byte-equal ({len(out['card'][0])} bytes; "
                      f"leaves {out['card'][2]}; card {out['card'][1]:.1f} s, CPU "
                      f"{out['cpu'][1]:.1f} s)")

    # ---- why the exact runs take host gradients: the binary objective's
    # response on the card and on the CPU, from phase 8's final train scores
    score = float_runs["wave"]["booster"]._gbdt.score[0]
    sign = torch.from_numpy(np.where(y_train > 0, 1.0, -1.0).astype(np.float32)).to(dev)
    on_card = -sign / (1.0 + torch.exp(sign * score))
    on_cpu = -sign.cpu() / (1.0 + torch.exp(sign.cpu() * score.cpu()))
    exp_differ = int((torch.exp(score).cpu().view(torch.int32)
                      != torch.exp(score.cpu()).view(torch.int32)).sum())
    resp_differ = int((on_card.cpu().view(torch.int32) != on_cpu.view(torch.int32)).sum())
    print(f"exact: of phase 8's {score.numel()} final train scores, torch.exp differs "
          f"between the card and the CPU on {exp_differ} ({exp_differ / score.numel():.1%}), "
          f"the binary objective's response on {resp_differ} "
          f"({resp_differ / score.numel():.1%}): the exact runs take their gradients from "
          "the host")

    # ---- full width: both learners, beside phase 8's and 9's float runs
    launches = {}
    runs = {}
    for label, params, rounds, required in (
            ("wave", {**WAVE_PARAMS, **QUANT_PARAMS}, TRAIN_ROUNDS,
             ("quantize_reduce", "quantize", "histogram_slots_ragged_i32",
              "find_best_split_int", "find_best_split_batched_int", "partition_decide",
              "partition_scan", "partition_scatter", "relabel_rows", "wave_select",
              "wave_replay", "tree_loop_cond", "predict_forest_raw")),
            ("serial", {**TRAIN_PARAMS, **QUANT_PARAMS}, QUANT_SERIAL_ROUNDS,
             ("quantize_reduce", "quantize", "histogram_i32", "find_best_split_int",
              "row_partition_decide", "row_partition_scatter", "predict_forest_raw"))):
        run = drive_training(lt, libs, params, train_set, valid, rounds, required, tag,
                             f"{label}, quantized")
        runs[label] = run
        if label == "wave":  # held against phase 21's quantized data-parallel model
            PHASE_MODELS["quantized"] = run["booster"].model_to_string()
        for name, n in run["launches"].items():
            launches[name] = launches.get(name, 0) + n
        flt = float_runs[label]
        q_auc = run["valid_auc"][-1]
        f_auc = flt["valid_auc"][rounds - 1]
        steady = lambda r: float(np.mean(r["per_iter"][1:rounds]))  # noqa: E731
        waves = ("" if label == "serial" else
                 f"waves a tree {run['counters'].get('device_waves', 0) / rounds:.1f} against "
                 f"{flt['counters'].get('device_waves', 0) / len(flt['per_iter']):.1f}; ")
        text_hash = hashlib.sha256(
            run["booster"].model_to_string().encode()).hexdigest()[:16]
        print(f"{tag} quantized ({label}): {rounds} rounds, 4 bins, stochastic rounding, "
              f"renewal on: s/iteration {steady(run):.4f} against {steady(flt):.4f} float "
              f"(rounds 2-{rounds}, the same data in this process); {waves}valid AUC "
              f"{q_auc:.5f} against "
              f"{f_auc:.5f} float after {rounds} rounds (margin {QUANT_AUC_MARGIN}); model "
              f"text sha256 {text_hash}")
        check(q_auc >= f_auc - QUANT_AUC_MARGIN,
              f"quantized ({label}): valid AUC {q_auc:.5f} more than {QUANT_AUC_MARGIN} below "
              f"the float run's {f_auc:.5f}")
    print(f"quantized path launches: {launches}")
    return launches, {"quantize": (t_quant, b_quant), "modes": (t_modes, b_modes)}


# ---------------------------------------------------------------------------
# phase 13: GOSS

GOSS_PARAMS = {"data_sample_strategy": "goss", "top_rate": 0.2, "other_rate": 0.1}
GOSS_ROUNDS, GOSS_SERIAL_ROUNDS, GOSS_EXACT_ROUNDS = 15, 13, 8
EXACT_LEAVES = 63  # the exact runs of phases 13 and 14: the CPU's share of the time


class GossClock:
    """While entered, records by iteration the host seconds of the GOSS
    strategy's `bagging` call, of its MT19937 position draw and of the
    enqueue of its selection, the card's milliseconds in the selection
    (CUDA events around it), and the host seconds of the GBDT's out-of-bag
    set (`_refresh_bag_cache`): the `bagging` scope in its parts."""

    def __init__(self):
        self.records = {}

    def __enter__(self):
        from lightgbm_tpu_torch.models import gbdt, sample_strategy as ss

        self._saved = ((ss.GOSSStrategy, "bagging", ss.GOSSStrategy.bagging),
                       (ss.GOSSStrategy, "draw_positions", ss.GOSSStrategy.draw_positions),
                       (ss, "goss_select", ss.goss_select),
                       (gbdt.GBDT, "_refresh_bag_cache", gbdt.GBDT._refresh_bag_cache))
        (_, _, bagging), (_, _, draw), (_, _, select), (_, _, refresh) = self._saved
        records, current = self.records, [None]

        def timed(fn, key):
            def run(*args, **kwargs):
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                records.setdefault(current[0], {})[key] = time.perf_counter() - t
                return out
            return run

        def timed_bagging(strategy, iteration, grad, hess):
            current[0] = iteration
            return timed(bagging, "bagging")(strategy, iteration, grad, hess)

        def timed_select(*args, **kwargs):
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            pair[0].record()
            out = timed(select, "select_host")(*args, **kwargs)
            pair[1].record()
            records[current[0]]["events"] = pair
            return out

        ss.GOSSStrategy.bagging = timed_bagging
        ss.GOSSStrategy.draw_positions = timed(draw, "draw")
        ss.goss_select = timed_select
        gbdt.GBDT._refresh_bag_cache = timed(refresh, "oob")
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        torch.cuda.synchronize()
        for rec in self.records.values():
            pair = rec.pop("events", None)
            if pair is not None:
                rec["select_card"] = pair[0].elapsed_time(pair[1]) * 1e-3
        return False


def goss_windows(run, clock, rounds, warmup, n_rows, n_bag):
    """Rounds 2..warmup (no sampling) and warmup+1..rounds apart: s/iteration,
    rows in the bag, rows histogrammed a tree, waves a tree, the bagging
    scope's host time in its parts and the selection's card time (ms a
    round), and the valid AUC at the window's end."""
    out = {}
    waves = np.asarray(run["waves"], np.float64)
    for name, lo, hi in (("warm-up", 1, warmup), ("sampling", warmup, rounds)):
        it = np.arange(lo, hi)
        recs = [clock.records.get(int(i), {}) for i in it]

        def ms(key):
            return float(np.mean([r.get(key, 0.0) for r in recs]) * 1e3)

        out[name] = {
            "rounds": f"{lo + 1}-{hi}", "s_iter": float(np.mean(run["per_iter"][it])),
            "bag": n_bag if name == "sampling" else n_rows,
            "hist_rows": float(np.mean(np.asarray(run["hist_rows"], np.float64)[it])),
            "waves": float(np.mean(waves[it])) if len(waves) >= hi else 0.0,
            "bagging_ms": ms("bagging") + ms("oob"), "draw_ms": ms("draw"),
            "select_host_ms": ms("select_host"), "select_card_ms": ms("select_card"),
            "oob_ms": ms("oob"), "auc": run["valid_auc"][hi - 1]}
    return out


def sampling_round_transfers(lt, params, train_set, warmup):
    """One GOSS sampling round (Booster.update, no metric) of a booster
    past its warm-up, under torch.profiler: its device-to-host copies (each
    one's bytes) and host synchronizations, from the trace; and whether
    the bag's host indices were ever made."""
    from torch.profiler import ProfilerActivity, profile, record_function

    bst = lt.Booster({**params, "metric": "None"}, train_set)
    for _ in range(warmup + 1):
        bst.update()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_round"):
            bst.update()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    span = next(e for e in events if e.get("name") == "chip_smoke_round"
                and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation")
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    d2h = [int(e.get("args", {}).get("bytes", 0)) for e in events if e.get("ph") == "X"
           and e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")
           and t0 <= float(e.get("ts", -1))]
    syncs = [e["name"] for e in events if e.get("ph") == "X"
             and e.get("cat") == "cuda_runtime" and "Synchronize" in e.get("name", "")
             and t0 <= float(e.get("ts", -1)) <= t1]
    bag = bst._gbdt._cur_bag
    return d2h, syncs, bag, bst._gbdt.tree_learner._buffers.results.numel()


def check_goss_selection(lt, booster, iteration):
    """GOSS's selection at full width on the booster's final gradients: the
    card's mask and rescaled g, h bit-equal to the same code on the CPU and
    to the JAX package's host path as the port keeps it (`bagging_host`).
    Returns the CPU selection's milliseconds."""
    gbdt = booster._gbdt
    strategy = gbdt.sample_strategy
    g, h = gbdt.objective.get_gradients(gbdt.score[0])
    g, h = g[None], h[None]
    bag, gc, hc = strategy.bagging(iteration, g, h)
    t = time.perf_counter()
    bag_cpu, g_cpu, h_cpu = strategy.bagging(iteration, g.cpu(), h.cpu())
    cpu_ms = (time.perf_counter() - t) * 1e3
    host, g_host, h_host = strategy.bagging_host(iteration, g.cpu(), h.cpu())
    check(torch.equal(bag.mask.cpu(), bag_cpu.mask),
          "goss: the card's bag mask differs from the CPU selection's")
    for what, a, b in (("g", gc, g_cpu), ("h", hc, h_cpu), ("g (host path)", gc, g_host),
                       ("h (host path)", hc, h_host)):
        check(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32)),
              f"goss: the card's rescaled {what} differs from the CPU's")
    check(bool(np.array_equal(bag.indices, host)),
          "goss: the card's bag differs from the host path's")
    return cpu_ms, bag.n_bag


def first_difference(a: str, b: str) -> str:
    """The first line where two model texts differ, both sides, shortened."""
    for i, (la, lb) in enumerate(zip(a.splitlines(), b.splitlines())):
        if la != lb and not la.startswith("tree_sizes="):
            return f"line {i}: {la[:160]!r} against {lb[:160]!r}"
    return f"lengths {len(a)} and {len(b)}"


def drive_goss(lt, libs, train_set, valid, X_train, y_train, tag):
    """Phase 13: GOSS through both learners on the main path's data.
    Returns the launches of the phase's two runs and the report."""
    warmup = int(1.0 / WAVE_PARAMS["learning_rate"])
    # ---- exact: the card trains as the CPU does, through both learners
    Xe, ye = X_train[:EXACT_ROWS], y_train[:EXACT_ROWS]
    exact = {**WAVE_PARAMS, **GOSS_PARAMS, "learning_rate": 0.5, "metric": "None",
             "num_leaves": EXACT_LEAVES}
    for learner in ("wave", "serial"):
        out = _exact_card_cpu(lt, Xe, ye, exact, GOSS_EXACT_ROUNDS, learner, snapped_logloss)
        check(out["card"][0] == out["cpu"][0],
              f"exact goss ({learner}): the card's model text differs from the CPU's, "
              + first_difference(out["card"][0], out["cpu"][0]))
        print(f"exact goss ({learner}): {EXACT_ROWS} rows, {EXACT_LEAVES} leaves, "
              f"{GOSS_EXACT_ROUNDS} rounds at "
              f"learning rate 0.5 (sampling from round 3), snapped gradients: card and CPU "
              f"model texts byte-equal ({len(out['card'][0])} bytes; leaves "
              f"{out['card'][2]}; card {out['card'][1]:.1f} s, CPU {out['cpu'][1]:.1f} s)")
    # ---- full width through both learners
    launches, report = {}, {}
    for label, params, rounds, required in (
            ("wave", {**WAVE_PARAMS, **GOSS_PARAMS}, GOSS_ROUNDS,
             ("histogram_slots_ragged_image", "histogram_image_to_float", "partition_decide", "partition_scan",
              "partition_scatter", "relabel_rows", "find_best_split",
              "find_best_split_batched", "wave_select", "wave_replay", "tree_loop_cond",
              "predict_forest_raw")),
            ("serial", {**TRAIN_PARAMS, **GOSS_PARAMS}, GOSS_SERIAL_ROUNDS,
             ("histogram", "find_best_split", "row_partition_decide",
              "row_partition_scatter", "predict_forest_raw"))):
        with GossClock() as clock:
            run = drive_training(lt, libs, params, train_set, valid, rounds, required, tag,
                                 f"{label}, goss")
        for name, n in run["launches"].items():
            launches[name] = launches.get(name, 0) + n
        booster = run["booster"]
        bag = booster._gbdt._cur_bag
        check(type(bag).__name__ == "DeviceBag" and (label == "serial" or bag._host is None),
              f"goss ({label}): the last round's bag is a {type(bag).__name__}"
              + ("" if bag is None or bag._host is None else " read to the host"))
        windows = goss_windows(run, clock, rounds, warmup, train_set.num_data(), len(bag))
        report[label] = windows
        for name, w in windows.items():
            waves = "" if label == "serial" else (
                f"rows histogrammed a tree {w['hist_rows'] / TRAIN_ROWS:.2f}N; waves a tree "
                f"{w['waves']:.1f}; ")
            print(f"{tag} goss ({label}) rounds {w['rounds']} ({name}): s/iteration "
                  f"{w['s_iter']:.4f}; rows in the bag {w['bag']}; {waves}bagging scope "
                  f"{w['bagging_ms']:.3f} ms a round (host): the MT19937 position draw "
                  f"{w['draw_ms']:.3f} ms, the selection's enqueue {w['select_host_ms']:.3f} "
                  f"ms and {w['select_card_ms']:.3f} ms on the card (CUDA events), the "
                  f"out-of-bag set {w['oob_ms']:.3f} ms; valid AUC {w['auc']:.5f}")
        if label == "wave":
            d2h, syncs, last_bag, results = sampling_round_transfers(lt, params, train_set,
                                                                     warmup)
            big = [b for b in d2h if b >= train_set.num_data()]
            print(f"{tag} goss (wave): one profiled sampling round (Booster.update, round "
                  f"{warmup + 2}): {len(d2h)} device-to-host copies, {sorted(d2h)} bytes (the "
                  f"tree's results {results}), {len(syncs)} host synchronizations ("
                  + ", ".join(f"{n} {syncs.count(n)}" for n in sorted(set(syncs)))
                  + "); the bag's host indices "
                  + ("made" if last_bag._host is not None else "never made")
                  + " (torch.profiler trace)")
            check(not big and last_bag._host is None,
                  f"goss (wave): a sampling round copied {big} bytes to the host (the "
                  "mask or the out-of-bag set)")
            cpu_ms, n_bag = check_goss_selection(lt, booster, rounds)
            print(f"{tag} goss: the selection at full width ({TRAIN_ROWS} rows, the wave "
                  f"run's final gradients, {n_bag} rows in the bag): the card's mask and "
                  f"rescaled g, h bit-equal to the CPU's and to the host path's; the CPU "
                  f"selection {cpu_ms:.1f} ms")
    print(f"goss path launches: {launches}")
    return launches, report


# ---------------------------------------------------------------------------
# phase 14: categorical features

# the airline on-time data of szilard/benchm-ml (ASA Data Expo 2009,
# dep_delayed_15min): 6 categorical columns and 2 numeric ones; rows cut from
# 10 M, airports from ~300 to 250 (with bin 0, 251 bins: one byte a group)
AIRLINE_ROWS, AIRLINE_VALID_ROWS, AIRLINE_EXACT_ROWS = 1_048_576, 65_536, 16_384
AIRLINE_CARRIERS, AIRLINE_AIRPORTS = 22, 250
CAT_ROUNDS, CAT_EXACT_ROUNDS = 10, 3
# max_cat_to_onehot 8: DayOfWeek's 7 categories (8 bins with bin 0) take the
# one-hot lane, the wider columns the sorted subset
CAT_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255, "learning_rate": 0.1,
              "max_cat_to_onehot": 8, "bagging_fraction": 0.8, "bagging_freq": 1,
              "metric": "auc", "verbosity": -1}
AIRLINE_COLUMNS = ("Month", "DayofMonth", "DayOfWeek", "UniqueCarrier", "Origin", "Dest",
                   "DepTime", "Distance")


def airline_frame(seed: int, n: int):
    """Rows in the shapes of the airline data from a seed, as a pandas
    DataFrame with `category` columns (benchm-ml's "c-8"-style months and
    days, carrier and airport codes): Month 12, DayofMonth 31, DayOfWeek 7
    and UniqueCarrier 22 categories, Origin and Dest 250 each Zipf-skewed,
    DepTime in 0-2400 (hhmm), Distance in miles; the label,
    dep_delayed_15min, drawn from a fixed logistic function of them (about
    a fifth of the rows delayed)."""
    import pandas as pd

    rng = np.random.RandomState(seed)
    zipf = 1.0 / np.arange(1, AIRLINE_AIRPORTS + 1)
    zipf /= zipf.sum()
    # carriers' market shares falling with rank (the smallest ~1.3%)
    share = 1.0 / np.arange(1, AIRLINE_CARRIERS + 1) ** 0.8
    share /= share.sum()
    month = rng.randint(0, 12, n)
    dom = rng.randint(0, 31, n)
    dow = rng.randint(0, 7, n)
    carrier = rng.choice(AIRLINE_CARRIERS, n, p=share)
    origin = rng.choice(AIRLINE_AIRPORTS, n, p=zipf)
    dest = rng.choice(AIRLINE_AIRPORTS, n, p=zipf)
    hour = np.clip(rng.normal(13.5, 4.5, n), 0, 23.99)
    dep = (hour.astype(np.int64) * 100 + rng.randint(0, 60, n)).astype(np.float64)
    dist = np.clip(rng.lognormal(6.4, 0.6, n), 30, 4983).round()
    fx = {name: rng.normal(0, scale, k) for name, scale, k in (
        ("month", 0.25, 12), ("dow", 0.15, 7), ("carrier", 0.35, AIRLINE_CARRIERS),
        ("origin", 0.4, AIRLINE_AIRPORTS), ("dest", 0.3, AIRLINE_AIRPORTS),
        ("dom", 0.1, 31))}
    f = (-1.45 + fx["month"][month] + fx["dow"][dow] + fx["carrier"][carrier]
         + fx["origin"][origin] + fx["dest"][dest] + fx["dom"][dom]
         + 0.09 * (hour - 13.5) + 0.00008 * (dist - 700))
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-f))).astype(np.float64)

    def cat(codes, labels):
        return pd.Categorical.from_codes(codes, categories=labels)

    airports = [f"A{i:03d}" for i in range(AIRLINE_AIRPORTS)]
    frame = pd.DataFrame({
        "Month": cat(month, [f"c-{i}" for i in range(1, 13)]),
        "DayofMonth": cat(dom, [f"c-{i}" for i in range(1, 32)]),
        "DayOfWeek": cat(dow, [f"c-{i}" for i in range(1, 8)]),
        "UniqueCarrier": cat(carrier, [f"C{i:02d}" for i in range(AIRLINE_CARRIERS)]),
        "Origin": cat(origin, airports), "Dest": cat(dest, airports),
        "DepTime": dep, "Distance": dist})
    return frame, y


def check_categorical_scan(gbdt, dev):
    """The categorical scan (ops/split.py:best_categorical_record, PyTorch
    ops on the card) on the root histogram of the trained booster's
    gradients: host milliseconds to enqueue a call, card milliseconds a call
    (CUDA events), the split kernel's numeric search beside it; and its
    record bit-equal to the same code on the CPU."""
    from lightgbm_tpu_torch.ops.histogram import build_histogram_rows, fixed_point_exponents
    from lightgbm_tpu_torch.models.gbdt import _pack_gh
    from lightgbm_tpu_torch.ops.scan_cuda import split_find
    from lightgbm_tpu_torch.ops.split import best_categorical_record, make_feature_meta

    g, h = gbdt.objective.get_gradients(gbdt.score[0])
    tl = gbdt.tree_learner
    gh = _pack_gh(g, h)
    n = gbdt.num_data
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    hist = build_histogram_rows(tl.bins_dev, gh, rows, tl.group_bin_padded, count=n,
                                exponents=fixed_point_exponents(gh, n))
    totals = hist[0].sum(dim=0)
    args = (hist, totals, tl.meta, tl.params_dev)
    card = best_categorical_record(*args)
    cpu = best_categorical_record(hist.cpu(), totals.cpu(),
                                  make_feature_meta(gbdt.train_set, tl.group_bin_padded, "cpu"),
                                  tl.params_dev.cpu())
    check(torch.equal(card.cpu().view(torch.int32), cpu.view(torch.int32)),
          "categorical: the scan's record on the card differs from the CPU's")
    host = host_ms(lambda: best_categorical_record(*args), 20)
    ms = cuda_ms(lambda: best_categorical_record(*args), 20)
    numeric = cuda_ms(lambda: split_find(*args), 20)
    return {"host": host, "card": ms, "numeric": numeric}


def split_kinds(booster, max_onehot):
    """Per tree: (one-hot splits, sorted-subset splits), a categorical node
    being one-hot when its feature has at most max_cat_to_onehot bins."""
    mappers = booster.train_set._handle.mappers
    out = []
    for tree in booster._gbdt.models:
        onehot = subset = 0
        for node in range(tree.num_leaves - 1):
            if int(tree.decision_type[node]) & 1:
                if mappers[int(tree.split_feature[node])].num_bin <= max_onehot:
                    onehot += 1
                else:
                    subset += 1
        out.append((onehot, subset))
    return out


def drive_categorical(lt, libs, seed, tag):
    """Phase 14: categorical features through the serial learner at the
    airline data's shapes. Returns the launches of the phase's main run and
    the report."""
    from lightgbm_tpu_torch.basic import _pandas_to_matrix
    from lightgbm_tpu_torch.serving import PredictionService, serve, wire

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    frame, y = airline_frame(seed + 40, AIRLINE_ROWS + AIRLINE_VALID_ROWS)
    train_df, valid_df = frame.iloc[:AIRLINE_ROWS], frame.iloc[AIRLINE_ROWS:]
    y_train, y_valid = y[:AIRLINE_ROWS], y[AIRLINE_ROWS:]
    train_set = lt.Dataset(train_df, label=y_train,
                           params={"max_bin": CAT_PARAMS["max_bin"]}).construct()
    core = train_set._handle
    cats = [f for f in core.used_features if core.mappers[f].bin_type == 1]
    check(len(cats) == 6, f"categorical: {len(cats)} categorical features, not 6")
    bins = {AIRLINE_COLUMNS[f]: core.mappers[f].num_bin for f in core.used_features}
    check(int(core.group_bin_counts().max()) <= 256 and core.bins.dtype == np.uint8,
          f"categorical: the groups take more than one byte ({bins})")
    # the dummy bin 0 holds what the binner cut (at most min(categories,
    # max_bin) bins: the rarest airport), which no split sends left
    dummy = {AIRLINE_COLUMNS[f]: int((core.bins[core.feature_to_group[f][0]] == 0).sum())
             for f in cats}
    print(f"categorical data: {AIRLINE_ROWS} rows (airline shapes, categorical_feature auto "
          f"from the DataFrame's category columns), delayed {y_train.mean():.3f}; bins a "
          f"feature {bins}; rows in the dummy bin 0 {dummy}; binned in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- exact: the card trains as the CPU does, float and quantized
    ex_df, ex_y = train_df.iloc[:AIRLINE_EXACT_ROWS], y_train[:AIRLINE_EXACT_ROWS]
    base = {**CAT_PARAMS, "bagging_fraction": 1.0, "bagging_freq": 0, "metric": "None",
            "num_leaves": EXACT_LEAVES}
    # the float histograms agree where their sums are exact (the card sums in
    # fixed point, the CPU in float32), so the float run takes snapped
    # gradients; the quantized run's int32 sums are exact on any gradients
    for what, extra, fobj in (("float, snapped", {}, snapped_logloss),
                              ("quantized, unsnapped", QUANT_PARAMS, host_logloss)):
        out = _exact_card_cpu(lt, ex_df, ex_y, {**base, **extra}, CAT_EXACT_ROUNDS, "serial",
                              fobj)
        check(out["card"][0] == out["cpu"][0],
              f"exact categorical ({what}): the card's model text differs from the CPU's, "
              + first_difference(out["card"][0], out["cpu"][0]))
        n_cat = out["card"][0].count("num_cat=") - out["card"][0].count("num_cat=0")
        print(f"exact categorical ({what}): {AIRLINE_EXACT_ROWS} rows, {EXACT_LEAVES} leaves, "
              f"{CAT_EXACT_ROUNDS} "
              f"rounds, gradients computed on the host: card and CPU model texts byte-equal "
              f"({len(out['card'][0])} bytes; {n_cat} trees with categorical splits; leaves "
              f"{out['card'][2]}; card {out['card'][1]:.1f} s, CPU {out['cpu'][1]:.1f} s)")

    # ---- full width through the serial learner
    run = drive_training(lt, libs, CAT_PARAMS, train_set, (valid_df, y_valid), CAT_ROUNDS,
                         ("histogram", "find_best_split", "row_partition_decide",
                          "row_partition_scatter", "predict_forest_raw"), tag, "categorical")
    bst = run["booster"]
    kinds = split_kinds(bst, CAT_PARAMS["max_cat_to_onehot"])
    onehot, subset = (sum(k[i] for k in kinds) for i in (0, 1))
    check(onehot > 0 and subset > 0,
          f"categorical: one-hot splits {onehot}, sorted-subset splits {subset}: both must "
          "occur")
    auc = run["valid_auc"]
    check(auc[-1] > auc[0], f"categorical: valid AUC did not rise: {auc}")
    gap = float(np.abs(bst._gbdt.score[0].cpu().numpy()
                       - bst.predict(train_df, raw_score=True)).max())
    check(gap <= 1e-6, f"categorical: with bagging the train score differs from "
          f"predict(raw_score=True) by {gap}")
    scan = check_categorical_scan(bst._gbdt, dev)
    steady = float(np.mean(run["per_iter"][1:]))
    print(f"{tag} categorical: {CAT_ROUNDS} rounds, bagging 0.8: s/iteration {steady:.3f} "
          f"(rounds 2-{CAT_ROUNDS}); per tree one-hot splits {onehot / CAT_ROUNDS:.1f}, "
          f"sorted-subset splits {subset / CAT_ROUNDS:.1f} (of "
          f"{CAT_PARAMS['num_leaves'] - 1} splits); valid AUC "
          + " ".join(f"{a:.5f}" for a in auc)
          + f"; train score against predict(raw_score=True) on the {AIRLINE_ROWS} training "
          f"rows max |d| {gap:.3g}")
    print(f"{tag} categorical scan a leaf (the root, {len(cats)} categorical of "
          f"{len(core.used_features)} features, PyTorch ops replayed as one CUDA graph): host "
          f"{scan['host']:.4f} ms to enqueue, {scan['card']:.4f} ms of CUDA events a call; "
          f"the split kernel's numeric search {scan['numeric']:.4f} ms; its record bit-equal "
          f"to the CPU's")
    # ---- serving: 64-row binary-wire requests, the categories as their codes
    X_valid = _pandas_to_matrix(valid_df, bst.pandas_categorical)[0].astype(np.float32)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cat_") as tmp:
        path = os.path.join(tmp, "airline.txt")
        bst.save_model(path)
        check(bool(np.array_equal(lt.Booster(model_file=path).predict(valid_df),
                                  bst.predict(valid_df))),
              "categorical: the model loaded from its file predicts differently")
        svc = PredictionService(max_batch_rows=4096, min_bucket=64, batch_window_s=0.001)
        server, server_thread = serve(svc, port=0)
        base_url = f"http://127.0.0.1:{server.port}"
        try:
            req = urllib.request.Request(
                base_url + "/models", data=json.dumps({"name": "airline", "path": path}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                check(resp.status == 200, "categorical serving: model upload refused")
            for i in range(8):
                rows = X_valid[i * 64:(i + 1) * 64]
                r = urllib.request.Request(base_url + "/predict",
                                           data=wire.encode_request("airline", rows),
                                           headers={"Content-Type": wire.CONTENT_TYPE},
                                           method="POST")
                with urllib.request.urlopen(r, timeout=120) as resp:
                    got = wire.decode_response(resp.read())[0]
                check(bool(np.array_equal(got, bst.predict(valid_df.iloc[i * 64:(i + 1) * 64]))),
                      f"categorical serving: request {i} differs from Booster.predict")
        finally:
            server.shutdown()
            server.server_close()
            svc.close()
            server_thread.join(timeout=10)
    print("categorical: the model reloads from its file and predicts bit-equal; 8 requests "
          "of 64 rows served over the binary wire bit-equal to Booster.predict of the "
          "DataFrame")
    return run["launches"], {"scan": scan, "s_iter": steady, "onehot": onehot,
                             "subset": subset, "auc": auc, "gap": gap}


# ---------------------------------------------------------------------------
# phase 15: monotone and interaction constraints, forced splits, CEGB and
# linear trees, through the serial learner

LANE_ROUNDS, LANE_EXACT_ROUNDS = 5, 2
# the directions of higgs_rows' label model: +0.8 x0, -0.6 x1, +0.3 x21,
# -0.7 x25 (LightGBM docs, Parameters: monotone_constraints)
LANE_MONOTONE = {0: 1, 1: -1, 21: 1, 25: -1}
# the three families of HIGGS-shaped columns as interaction groups
# (LightGBM docs, Parameters: interaction_constraints)
LANE_INTERACTION = "[0,1,2,3,4,5,6,7],[8,9,10,11,12,13,14,15],[16,17,18,19,20,21,22,23,24," \
    "25,26,27]"
# the root on feature 0, its left child on feature 25 (the label model's two
# strongest monotone inputs); 25 lies outside feature 0's group, so no split
# follows the forced one there
LANE_FORCED = {"feature": 0, "threshold": 1.0, "left": {"feature": 25, "threshold": 1.0}}
# CEGB (Peter et al., NeurIPS 2017): a split penalty per row of the leaf, a
# coupled cost the first time a feature is used in the model (here per row
# of the training set, so it weighs as much at every size) and a lazy cost
# per row a feature is first computed for. The best split's gain is ~0.1 a
# row at the root on this data and the informative features' totals 0.02-0.2
# a row, so these bind (at 131,072 rows on a CPU: 2 distinct features a tree
# against 24-27 without, every tree at 255 leaves) without stopping the trees
LANE_CEGB_SPLIT, LANE_CEGB_COUPLED_PER_ROW, LANE_CEGB_LAZY = 1e-3, 5e-3, 1e-2
# linear trees (GBDT-PL, Shi et al., arXiv:1802.05640, measured on HIGGS)
LANE_LINEAR = {"linear_tree": True, "linear_lambda": 0.01}
LANE_SCOPES = ("find_best_split", "partition", "hist_root", "hist_children", "forced_splits",
               "cegb_penalty", "linear_fit")
SWEEP_ROWS, SWEEP_POINTS = 4096, 32


def with_monotone(train_set, constraints):
    """A view of a constructed Dataset whose core dataset carries monotone
    constraints, sharing its bins (a constructed Dataset takes them only at
    construction)."""
    import copy

    view = copy.copy(train_set)
    view._handle = copy.copy(train_set._handle)
    view._handle.monotone_constraints = list(constraints)
    return view


def monotone_list(n_features):
    return [LANE_MONOTONE.get(f, 0) for f in range(n_features)]


def lane_params(which, forced_path, n_rows):
    """Phase 8's settings with one lane's parameters, for n_rows rows."""
    if which == "constraints":
        return {**WAVE_PARAMS, "monotone_constraints": monotone_list(28),
                "interaction_constraints": LANE_INTERACTION,
                "forcedsplits_filename": forced_path}
    if which == "cegb":
        return {**WAVE_PARAMS, "cegb_penalty_split": LANE_CEGB_SPLIT,
                "cegb_penalty_feature_coupled": [LANE_CEGB_COUPLED_PER_ROW * n_rows] * 28,
                "cegb_penalty_feature_lazy": [LANE_CEGB_LAZY] * 28}
    return {**WAVE_PARAMS, **LANE_LINEAR}


def node_paths(tree):
    """[(node, features on the path from the root through the node)]."""
    out, stack = [], [(0, frozenset())]
    while stack and tree.num_leaves > 1:
        node, path = stack.pop()
        path = path | {int(tree.split_feature[node])}
        out.append((node, path))
        for child in (int(tree.left_child[node]), int(tree.right_child[node])):
            if child >= 0:
                stack.append((child, path))
    return out


def monotone_sweep(booster, X, seed):
    """Each constrained feature swept over SWEEP_POINTS grid points between
    its 0.5% and 99.5% quantiles on SWEEP_ROWS sampled rows: the raw scores
    never step against the constraint (float32 sums of monotone trees stay
    monotone). Returns the number of (row, step) pairs checked."""
    rows = X[np.random.RandomState(seed).choice(len(X), SWEEP_ROWS, replace=False)]
    checked = 0
    for f, direction in LANE_MONOTONE.items():
        lo, hi = np.quantile(X[:, f], [0.005, 0.995])
        grid = np.linspace(lo, hi, SWEEP_POINTS).astype(np.float32)
        Xs = np.repeat(rows, SWEEP_POINTS, axis=0)
        Xs[:, f] = np.tile(grid, SWEEP_ROWS)
        raw = booster.predict(Xs, raw_score=True).reshape(SWEEP_ROWS, SWEEP_POINTS)
        steps = np.diff(raw.astype(np.float64), axis=1) * direction
        check(bool((steps >= 0).all()),
              f"constraints: feature {f} steps against its monotone constraint "
              f"{direction} ({int((steps < 0).sum())} of {steps.size} steps, worst "
              f"{float(steps.min()):.3g})")
        checked += steps.size
    return checked


def lane_round(booster):
    """One more Booster.update() under torch.profiler: (busy share tuple of
    device_busy_share, device-to-host copies, their bytes)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        booster.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lane_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    kernel_us = sum(float(e.get("dur", 0)) for e in events
                    if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                               "gpu_memset"))
    d2h = [int(e.get("args", {}).get("bytes", 0)) for e in events
           if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
           and "DtoH" in e.get("name", "")]
    return kernel_us * 1e-6, wall, len(d2h), sum(d2h)


def drive_lane(lt, libs, label, params, train_set, valid, required, tag):
    """One full-width run of a lane with every launch count set to 0 just
    before it and read just after: LANE_ROUNDS rounds with the validation
    set; prints s/iteration, the lanes' host scopes, the valid AUC, then the
    busy share and the device-to-host copies of one more profiled round.
    Returns (booster, launches, report)."""
    from lightgbm_tpu_torch.utils.timer import global_timer

    for lib in libs:
        lib.reset_launches()
    stamps, evals = [], {}
    global_timer.reset()
    global_timer.enabled = True
    t_train = time.perf_counter()
    bst = lt.train(dict(params), train_set, num_boost_round=LANE_ROUNDS,
                   valid_sets=[train_set.create_valid(valid[0], label=valid[1])],
                   valid_names=["valid"],
                   callbacks=[lambda env: stamps.append(time.perf_counter()),
                              lt.record_evaluation(evals)])
    wall = time.perf_counter() - t_train
    global_timer.enabled = False
    launches = {}
    for lib in libs:
        launches.update(lib.launches)
    scopes = {k: (global_timer.totals[k], global_timer.counts[k]) for k in LANE_SCOPES
              if k in global_timer.totals}
    for name in required:
        check(launches[name] > 0, f"{label} path: kernel {name} never launched")
    check(type(bst._gbdt.tree_learner).__name__ == "SerialTreeLearner",
          f"{label}: trained with {type(bst._gbdt.tree_learner).__name__}")
    auc = evals["valid"]["auc"]
    check(len(bst._gbdt.models) == LANE_ROUNDS, f"{label}: {len(bst._gbdt.models)} trees")
    check(auc[-1] > auc[0], f"{label}: valid AUC did not rise: {auc}")
    per_iter = np.diff([t_train] + stamps)
    steady = float(np.mean(per_iter[1:]))
    leaves = [t.num_leaves for t in bst._gbdt.models]
    print(f"{tag} {label}: {train_set.num_data()} x {train_set.num_feature()}, "
          f"{LANE_ROUNDS} rounds in {wall:.2f} s; s/iteration first {per_iter[0]:.3f}, mean of "
          f"the rest {steady:.3f}; leaves per tree {leaves}; valid AUC "
          + " ".join(f"{a:.5f}" for a in auc))
    print(f"{tag} {label} scopes (host s over {LANE_ROUNDS} rounds, calls): " + ", ".join(
        f"{k} {v:.3f} ({n})" for k, (v, n) in scopes.items()))
    print(f"{label} path launches: {launches} (per tree: " + ", ".join(
        f"{name} {launches[name] / LANE_ROUNDS:.1f}" for name in required) + ")")
    busy, round_wall, n_d2h, d2h_bytes = lane_round(bst)
    splits = bst._gbdt.models[-1].num_leaves - 1
    print(f"{tag} {label}: one more round (torch.profiler trace): {busy * 1e3:.1f} ms of "
          f"device operations in {round_wall * 1e3:.1f} ms wall, {busy / round_wall:.1%} busy; "
          f"{n_d2h} device-to-host copies a tree ({n_d2h / max(splits, 1):.2f} a split), "
          f"{d2h_bytes} bytes")
    return bst, launches, {"s_iter": steady, "first": float(per_iter[0]), "auc": auc,
                           "scopes": scopes, "busy": busy / round_wall, "d2h": n_d2h,
                           "leaves": leaves}


def _exact_lane(lt, X, y, params, fobj, rounds):
    """The card's and the CPU's model texts of one serial-learner run on
    host gradients, and the two runs' seconds."""
    out = {}
    for where in ("card", "cpu"):
        t = time.perf_counter()
        bst = lt.Booster({**params, "objective": "none",
                          **({"device_type": "cpu"} if where == "cpu" else {})},
                         lt.Dataset(X, label=y))
        check(type(bst._gbdt.tree_learner).__name__ == "SerialTreeLearner",
              f"exact lane ({where}): trained with {type(bst._gbdt.tree_learner).__name__}")
        for _ in range(rounds):
            bst.update(fobj=fobj)
        out[where] = (bst.model_to_string(), time.perf_counter() - t)
    return out


def check_constrained_scan(booster, dev, tag):
    """The split kernel's constrained mode against its plain version run on
    the CPU, on the trained booster's gradients: the root histogram with
    infinite bounds and two leaves of its last tree with bounds that bind
    (three quarters of the way from the midpoint of the unconstrained
    record's outputs, which changes the record): records bit-equal. Then
    the device time of the
    constrained find form beside the unconstrained one at the root, the
    plain version's, and the bound."""
    from lightgbm_tpu_torch.models.gbdt import _pack_gh
    from lightgbm_tpu_torch.ops.histogram import build_histogram_rows, fixed_point_exponents
    from lightgbm_tpu_torch.ops import split as ts

    gbdt = booster._gbdt
    tl = gbdt.tree_learner
    g, h = gbdt.objective.get_gradients(gbdt.score[0])
    gh = _pack_gh(g, h)
    n = gbdt.num_data
    exps = fixed_point_exponents(gh, n)
    meta_h = ts.make_feature_meta(gbdt.train_set, tl.group_bin_padded, "cpu")
    params_h = tl.params_dev.cpu()
    part = tl.partition
    counts = [part.count(leaf) for leaf in range(gbdt.models[-1].num_leaves)]
    order = np.argsort(counts)[::-1]
    cases = [("root", torch.arange(n, dtype=torch.int32, device=dev), n, None)]
    for leaf in order[:2]:
        cases.append((f"leaf {int(leaf)}", part.indices(int(leaf)), counts[leaf], "bind"))
    hist_root, found = None, 0
    for name, rows, cnt, bounds in cases:
        hist = build_histogram_rows(tl.bins_dev, gh, rows, tl.group_bin_padded, count=cnt,
                                    exponents=exps)
        tot = tuple(float(v) for v in hist[0].sum(dim=0).cpu())
        if bounds is None:
            c = (-float("inf"), float("inf"))
            hist_root = (hist, tot)
        else:
            free = ts.find_best_split(hist.cpu(), tot, meta_h, params_h)
            mid = (float(free[10]) + float(free[11])) / 2
            half = abs(float(free[10]) - float(free[11])) / 2
            c = (mid - 0.75 * half, mid + 0.75 * half)
        rec = ts.find_best_split(hist, tot, tl.meta, tl.params_dev, constraint=c).cpu()
        ref = ts.find_best_split(hist.cpu(), tot, meta_h, params_h, constraint=c)
        check(torch.equal(rec.view(torch.int32), ref.view(torch.int32)),
              f"constrained split_kernel ({name}): the record differs from the plain version's")
        found += int(rec[1] >= 0)
        if bounds is None:
            check(bool(rec[1] >= 0), f"constrained split_kernel ({name}): no split found")
        else:
            check(not torch.equal(rec, free), f"constrained split_kernel ({name}): the "
                  "bounds do not bind")
            lo, hi = (float(np.float32(v)) for v in c)  # as the search rounds them
            check(rec[1] < 0 or (lo <= float(rec[10]) <= hi and lo <= float(rec[11]) <= hi),
                  f"constrained split_kernel ({name}): outputs outside the bounds")
    hist, tot = hist_root
    inf = (-float("inf"), float("inf"))

    def constrained():
        return ts.find_best_split(hist, tot, tl.meta, tl.params_dev, constraint=inf)

    def unconstrained():
        return ts.find_best_split(hist, tot, tl.meta, tl.params_dev)

    tot_d = torch.tensor(tot, dtype=torch.float32, device=dev)
    # the profiler's first trace in a process may see no device time:
    # each is asked twice at most
    t = {"constrained": cuda_ms(constrained, 50), "free": cuda_ms(unconstrained, 50),
         "free_device": (kernel_device_ms(unconstrained, 20, "split_kernel")
                         or kernel_device_ms(unconstrained, 20, "split_kernel")),
         "constrained_device": (kernel_device_ms(constrained, 20, "split_kernel")
                                or kernel_device_ms(constrained, 20, "split_kernel")),
         "plain": cuda_ms(lambda: ts._find_best_split_plain(hist, tot_d, tl.meta,
                                                            tl.params_dev, constraint=inf), 5)}
    F, B = tl.meta.gather_index.shape
    b = bound(perfmodel.find_best_split(F, B, constrained=True))
    print(f"{tag} kernels: find_best_split_constrained ({F} x {B}, the root of the constraints "
          f"run's gradients, and two leaves of its last tree with binding bounds): records "
          f"bit-equal to the plain version run on the CPU ({found} of the 3 with a split); device "
          f"time a call {fmt_ms(t['constrained_device'])} constrained against "
          f"{fmt_ms(t['free_device'])} unconstrained (torch.profiler; CUDA events "
          f"{t['constrained']:.4f} / {t['free']:.4f} ms), plain {t['plain']:.3f} ms, bound "
          f"{b[0]:.5f} ms ({b[1]})")
    return t, b


def linear_score_timing(booster, dev, tag):
    """The linear score of one tree over every training row, as the GBDT
    computes it: the traversal's leaf mode and the linear epilogue; its
    device time (CUDA events), the plain version's on the card, the bound;
    and the kernel's result bit-equal to the plain traversal's."""
    from lightgbm_tpu_torch.ops import predict_cuda
    from lightgbm_tpu_torch.ops.predict import (_predict_raw_fused, _traverse_leaves,
                                                pack_ensemble, predict_raw, to_device_rows)

    gbdt = booster._gbdt
    X = gbdt._train_raw_dev
    if X is None:
        X = to_device_rows(gbdt.train_raw, dev)
    packed = pack_ensemble([gbdt.models[-1]], device=dev)
    got = predict_raw(packed, X)
    check(torch.equal(predict_cuda.forest_leaf_indices(packed, X), _traverse_leaves(packed, X)),
          "linear score: the leaf mode's indices differ from the plain traversal's")
    check(torch.equal(got, _predict_raw_fused(packed, X, 1)),
          "linear score: differs from the plain version's")
    ms = cuda_ms(lambda: predict_raw(packed, X), 20)
    leaf_ms = cuda_ms(lambda: predict_cuda.forest_leaf_indices(packed, X), 20)
    plain = cuda_ms(lambda: _predict_raw_fused(packed, X, 1), 3)
    n, F = X.shape
    K = packed.lin_feat.shape[2]
    depth = float(torch.from_numpy(gbdt.models[-1].leaf_depth[:gbdt.models[-1].num_leaves])
                  .to(torch.float64).mean())
    tables = sum(t.numel() * t.element_size() for t in (
        packed.records, packed.lin_const, packed.lin_feat, packed.lin_coeff))
    b = bound(perfmodel.linear_score(n, F, K, depth, tables))
    print(f"{tag} linear score of one tree over {n} rows (K = {K} slots a leaf): "
          f"{ms:.4f} ms a call (CUDA events; the leaf mode alone {leaf_ms:.4f} ms, the "
          f"epilogue the rest), plain {plain:.3f} ms, bound {b[0]:.5f} ms ({b[1]}); the "
          f"kernel's leaf indices and the score bit-equal to the plain version's")
    return {"ms": ms, "leaf_ms": leaf_ms, "plain": plain}, b


def distinct_features(trees):
    return [len({int(t.split_feature[i]) for i in range(t.num_leaves - 1)}) for t in trees]


def drive_constraints(lt, libs, train_set, valid, X_train, y_train, baseline, tag):
    """Phase 15: monotone and interaction constraints with forced splits,
    CEGB and linear trees through the serial learner at HIGGS width, each
    exact on the card against the CPU at EXACT_ROWS rows. `baseline` is
    phase 8's booster (the same data and settings without a lane). Returns
    (the launches of the phase's full-width runs, the report)."""
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_lanes_")
    forced = os.path.join(tmp.name, "forced.json")
    with open(forced, "w") as fh:
        json.dump(LANE_FORCED, fh)
    # ---- exact: the card trains as the CPU does, lane by lane
    Xe, ye = X_train[:EXACT_ROWS], y_train[:EXACT_ROWS]
    exact = {"num_leaves": EXACT_LEAVES, "metric": "None"}
    for name, params, fobj in (
            ("constraints", lane_params("constraints", forced, len(Xe)), snapped_logloss),
            ("constraints, quantized",
             {**lane_params("constraints", forced, len(Xe)), **QUANT_PARAMS}, host_logloss),
            ("cegb", lane_params("cegb", forced, len(Xe)), snapped_logloss),
            ("linear", lane_params("linear", forced, len(Xe)), snapped_logloss)):
        out = _exact_lane(lt, Xe, ye, {**params, **exact}, fobj, LANE_EXACT_ROUNDS)
        check(out["card"][0] == out["cpu"][0],
              f"exact {name}: the card's model text differs from the CPU's, "
              + first_difference(out["card"][0], out["cpu"][0]))
        print(f"exact {name}: {EXACT_ROWS} rows, {EXACT_LEAVES} leaves, {LANE_EXACT_ROUNDS} "
              f"rounds, gradients computed on the host: card and CPU model texts byte-equal "
              f"({len(out['card'][0])} bytes; card {out['card'][1]:.1f} s, CPU "
              f"{out['cpu'][1]:.1f} s)")
    t_exact = time.perf_counter() - t_phase

    # ---- full width
    serial_kernels = ("histogram", "row_partition_decide", "row_partition_scatter",
                      "predict_forest_raw")
    launches, report = {}, {}
    mono_set = with_monotone(train_set, monotone_list(train_set.num_feature()))
    n = train_set.num_data()
    bst, got, rep = drive_lane(lt, libs, "constraints", lane_params("constraints", forced, n),
                               mono_set, valid, serial_kernels + ("find_best_split_constrained",),
                               tag)
    report["constraints"] = rep
    for name, n in got.items():
        launches[name] = launches.get(name, 0) + n
    trees = bst._gbdt.models[:LANE_ROUNDS]
    check(all(int(t.split_feature[0]) == 0 for t in trees),
          "constraints: a tree's root is not the forced split on feature 0")
    groups = [set(range(0, 8)), set(range(8, 16)), set(range(16, 28))]
    forced_nodes = {0, 1}  # the root and its left child, split first
    for k, t in enumerate(trees):
        for node, path in node_paths(t):
            if node in forced_nodes:
                continue
            check(any(path <= grp for grp in groups),
                  f"constraints: tree {k} node {node}'s path {sorted(path)} crosses the "
                  "interaction groups")
    checked = monotone_sweep(bst, X_train, 15)
    ms_scan, b_scan = check_constrained_scan(bst, dev, tag)
    print(f"{tag} constraints: every root on feature 0 (forced, its left child on 25); every "
          f"path below the forced splits inside one interaction group; the monotone sweep "
          f"({SWEEP_ROWS} rows x {SWEEP_POINTS} points x {len(LANE_MONOTONE)} features, "
          f"{checked} steps) never against a constraint")
    del bst
    torch.cuda.empty_cache()

    bst, got, rep = drive_lane(lt, libs, "cegb", lane_params("cegb", forced, n), train_set,
                               valid, serial_kernels + ("find_best_split",), tag)
    report["cegb"] = rep
    for name, n in got.items():
        launches[name] = launches.get(name, 0) + n
    pen, base = (distinct_features(bst._gbdt.models[:LANE_ROUNDS]),
                 distinct_features(baseline._gbdt.models[:LANE_ROUNDS]))
    check(np.mean(pen) < np.mean(base),
          f"cegb: distinct features per tree {pen}, not fewer than without CEGB {base}")
    print(f"{tag} cegb: distinct features per tree {pen} (mean {np.mean(pen):.1f}) against "
          f"{base} (mean {np.mean(base):.1f}) in phase 8's run without CEGB")
    del bst
    torch.cuda.empty_cache()

    bst, got, rep = drive_lane(lt, libs, "linear", lane_params("linear", forced, n), train_set,
                               valid, serial_kernels[:3] + ("find_best_split",
                                                            "predict_forest_leaf"), tag)
    report["linear"] = rep
    check(got["predict_forest_raw"] == 0,
          "linear: a linear tree was scored through the raw mode")
    for name, n in got.items():
        launches[name] = launches.get(name, 0) + n
    report["linear_leaf_launches"] = got["predict_forest_leaf"]
    # every tree, the profiled round's too (predict stops at best_iteration)
    gap = float(np.abs(bst._gbdt.score[0].cpu().numpy().astype(np.float64)
                       - bst.predict(X_train, raw_score=True,
                                     num_iteration=bst.current_iteration())).max())
    check(gap <= 1e-5, f"linear: the train score differs from predict(raw_score=True) by {gap}")
    n_coef = sum(len(c) for t in bst._gbdt.models for c in t.leaf_coeff[:t.num_leaves])
    print(f"{tag} linear: train score against predict(raw_score=True) on the {len(X_train)} "
          f"training rows max |d| {gap:.3g}; {n_coef} coefficients in {LANE_ROUNDS} trees")
    ms_lin, b_lin = linear_score_timing(bst, dev, tag)
    del bst
    torch.cuda.empty_cache()
    tmp.cleanup()
    print(f"{tag} phase 15: {time.perf_counter() - t_phase:.1f} s (exact runs {t_exact:.1f} s)")
    print(f"lanes path launches: {launches}")
    report.update({"scan": (ms_scan, b_scan), "linear_score": (ms_lin, b_lin)})
    return launches, report


# ---------------------------------------------------------------------------
# the Booster surface

# ---------------------------------------------------------------------------
# phase 16: DART, random forests and the model's life cycle

# LightGBM's DART defaults (docs/Parameters.rst: drop_rate, skip_drop, max_drop)
DART_PARAMS = {"boosting": "dart", "drop_rate": 0.1, "skip_drop": 0.5, "max_drop": 50}
RF_PARAMS = {"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1,
             "feature_fraction": 0.8}
LIFE_ROUNDS, LIFE_CUT, HEALTH_ROUNDS, LIFE_EXACT_ROUNDS = 10, 5, 8, 4
HEALTH_NAN_AT, HEALTH_EVERY = 5, 2  # NaN in every 20th row's gradient at round 5
DART_GAP, RF_GAP, ROLLBACK_GAP, REFIT_AUC_MARGIN = 1e-3, 1e-5, 1e-6, 0.01
LIFE_REQUIRED = ("histogram_slots_ragged_image", "histogram_image_to_float", "partition_decide", "partition_scan",
                 "partition_scatter", "relabel_rows", "find_best_split",
                 "find_best_split_batched", "wave_select", "wave_replay", "tree_loop_cond",
                 "predict_forest_raw", "predict_forest_leaf")


def host_auc(y, score) -> float:
    """Area under the ROC curve from the ranks of the scores (ties share
    their mean rank)."""
    from scipy.stats import rankdata

    pos = np.asarray(y) > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    ranks = rankdata(score)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def grid_rows(X, n):
    """n rows in +/- pairs from X and labels 1 + s, s on a 1/64 grid and
    odd in the rows: the labels' mean, boost-from-average's init score, is
    exactly 1, so every L2 gradient init - label is on the grid and every
    sum of them is exact."""
    half = np.asarray(X[:n // 2], dtype=np.float64)
    Xg = np.concatenate([half, -half])
    y = 1.0 + np.round((Xg[:, 0] - 0.5 * Xg[:, 8] + 0.25 * Xg[:, 16]) * 64) / 64
    check(float(np.mean(y)) == 1.0, "grid rows: the labels' mean is not 1")
    return Xg, y


def _checkpoint_at(path, cut):
    """A checkpoint callback writing `path` after round `cut` only."""
    from lightgbm_tpu_torch.checkpoint import checkpoint_callback

    return checkpoint_callback(lambda it: path if it == cut else path + f".{it}", period=cut)


def _life_exact(lt, X_train, y_train, tmp):
    """Phase 16's exact runs at EXACT_ROWS rows and EXACT_LEAVES leaves:
    DART on snapped gradients and RF on grid labels through the wave
    learner, and a run resumed from a checkpoint on the card (the serial
    learner, feature_fraction_bynode 0.8: its column sampler's stream is in
    the checkpoint), each byte-equal to the CPU's."""
    t = time.perf_counter()
    Xe, ye = X_train[:EXACT_ROWS], y_train[:EXACT_ROWS]
    dart = {**WAVE_PARAMS, **DART_PARAMS, "num_leaves": EXACT_LEAVES, "metric": "None",
            "drop_rate": 0.5, "skip_drop": 0.2}
    out = _exact_card_cpu(lt, Xe, ye, dart, LIFE_EXACT_ROUNDS, "wave", snapped_logloss)
    check(out["card"][0] == out["cpu"][0],
          "exact dart: the card's model text differs from the CPU's, "
          + first_difference(out["card"][0], out["cpu"][0]))
    Xg, yg = grid_rows(X_train, EXACT_ROWS)
    rf = {**WAVE_PARAMS, **RF_PARAMS, "objective": "regression", "metric": "None",
          "num_leaves": EXACT_LEAVES}
    out = _exact_card_cpu(lt, Xg, yg, rf, LIFE_EXACT_ROUNDS, "wave")
    check(out["card"][0] == out["cpu"][0],
          "exact rf: the card's model text differs from the CPU's, "
          + first_difference(out["card"][0], out["cpu"][0]))
    resume = {**TRAIN_PARAMS, "objective": snapped_logloss, "metric": "None",
              "num_leaves": EXACT_LEAVES}
    path = os.path.join(tmp, "exact_ckpt.txt")
    cut = LIFE_EXACT_ROUNDS // 2
    card = lt.train(dict(resume), lt.Dataset(Xe, label=ye), num_boost_round=LIFE_EXACT_ROUNDS,
                    callbacks=[_checkpoint_at(path, cut)])
    resumed = lt.train(dict(resume), lt.Dataset(Xe, label=ye),
                       num_boost_round=LIFE_EXACT_ROUNDS, init_model=path)
    cpu = lt.train({**resume, "device_type": "cpu"}, lt.Dataset(Xe, label=ye),
                   num_boost_round=LIFE_EXACT_ROUNDS)
    check(type(resumed._gbdt.tree_learner).__name__ == "SerialTreeLearner",
          "exact resume: not the serial learner")
    texts = [b.model_to_string() for b in (card, resumed, cpu)]
    check(texts[1] == texts[0] == texts[2],
          "exact resume: the resumed card run differs from the straight card run or the "
          "CPU's, " + first_difference(texts[1], texts[2]))
    print(f"exact dart / rf / resume: {EXACT_ROWS} rows, {EXACT_LEAVES} leaves, "
          f"{LIFE_EXACT_ROUNDS} rounds: DART on snapped gradients (drop_rate 0.5, skip_drop "
          f"0.2) and RF on grid labels through the wave learner, and a run resumed from "
          f"round {cut} on the card through the serial learner (feature_fraction_bynode "
          f"0.8): card and CPU model texts byte-equal ({time.perf_counter() - t:.1f} s)")


def _timed_run(lt, params, train_set, valid, rounds, callbacks=(), init_model=None):
    """lt.train with a stamp after each round: (booster, s/iteration of the
    rounds after the first, first-round s, wall s, valid AUC by round)."""
    stamps, evals = [], {}
    cbs = [lambda env: stamps.append(time.perf_counter()), *callbacks]
    kwargs = {}
    if valid is not None:
        cbs.append(lt.record_evaluation(evals))
        kwargs = {"valid_sets": [train_set.create_valid(valid[0], label=valid[1])],
                  "valid_names": ["valid"]}
    t = time.perf_counter()
    bst = lt.train(dict(params), train_set, num_boost_round=rounds, callbacks=cbs,
                   init_model=init_model, **kwargs)
    wall = time.perf_counter() - t
    per_iter = np.diff([t] + stamps)
    steady = float(np.mean(per_iter[1:])) if len(per_iter) > 1 else float(per_iter[0])
    return bst, steady, float(per_iter[0]), wall, evals.get("valid", {}).get("auc", [])


def drive_lifecycle(lt, libs, train_set, valid, X_train, y_train, baseline, seed, tag):
    """Phase 16: DART and RF through the wave learner at HIGGS width, a
    checkpoint resume through the async pipeline, refit and rollback of
    phase 8's booster (`baseline`) and the health guardrail's rollback,
    after their exact card = CPU runs. Returns (the launches of the phase's
    full-width runs, the report)."""
    from lightgbm_tpu_torch.checkpoint import SIDECAR_SUFFIX, load_checkpoint
    from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_life_")
    _life_exact(lt, X_train, y_train, tmp.name)
    report = {}
    for lib in libs:
        lib.reset_launches()
    n_rows = train_set.num_data()

    # ---- DART, LightGBM's defaults
    drops = []
    dart, s_dart, first, wall, auc = _timed_run(
        lt, {**WAVE_PARAMS, **DART_PARAMS}, train_set, valid, LIFE_ROUNDS,
        callbacks=[lambda env: drops.append(len(env.model._gbdt.drop_index))])
    check(isinstance(dart._gbdt.tree_learner, DeviceTreeLearner), "dart: not the wave learner")
    check(len(dart._gbdt.models) == LIFE_ROUNDS, f"dart: {len(dart._gbdt.models)} trees")
    check(0.5 < auc[-1] and auc[-1] >= auc[0], f"dart: valid AUC {auc}")
    gap = float(np.abs(dart._gbdt.score[0].cpu().numpy()
                       - dart.predict(X_train, raw_score=True)).max())
    check(gap <= DART_GAP, f"dart: train score {gap} from predict(raw_score=True)")
    busy = device_busy_share(dart.update)
    print(f"{tag} dart: {n_rows} x 28, {LIFE_ROUNDS} rounds (drop_rate 0.1, skip_drop 0.5, "
          f"max_drop 50) in {wall:.2f} s; s/iteration first {first:.3f}, mean of the rest "
          f"{s_dart:.4f}; trees dropped a round {drops} (mean {np.mean(drops):.1f}); valid AUC "
          f"{auc[0]:.5f} -> {auc[-1]:.5f}; train score against predict(raw_score=True): max "
          f"gap {gap:.3g}; one more round (torch.profiler): "
          + ("busy share not measured (the profiler saw no device time)" if busy is None else
             f"{busy[0] * 1e3:.1f} ms of device operations in {busy[1] * 1e3:.1f} ms wall, "
             f"{busy[0] / busy[1]:.1%} busy, {len(dart._gbdt.drop_index)} trees dropped; "
             f"top kernels: {busy[2]}"))
    report["dart"] = {"s_iter": s_dart, "drops": drops, "gap": gap, "auc": auc,
                      "busy": None if busy is None else busy[0] / busy[1]}

    # ---- random forest
    rf, s_rf, first, wall, auc = _timed_run(lt, {**WAVE_PARAMS, **RF_PARAMS}, train_set,
                                            valid, LIFE_ROUNDS)
    check(isinstance(rf._gbdt.tree_learner, DeviceTreeLearner), "rf: not the wave learner")
    check(0.5 < auc[-1], f"rf: valid AUC {auc}")
    trees = np.stack([rf.predict(X_train, raw_score=True, start_iteration=i, num_iteration=1)
                      for i in range(LIFE_ROUNDS)]).astype(np.float64)
    gap_rf = float(np.abs(rf._gbdt.score[0].cpu().numpy() - trees.mean(axis=0)).max())
    check(gap_rf <= RF_GAP, f"rf: train score {gap_rf} from the trees' mean output")
    print(f"{tag} rf: {LIFE_ROUNDS} rounds (bagging 0.5 every round, feature_fraction 0.8) "
          f"in {wall:.2f} s; s/iteration first {first:.3f}, mean of the rest {s_rf:.4f}; "
          f"valid AUC {auc[0]:.5f} -> {auc[-1]:.5f}; train score against the mean of the "
          f"trees' outputs: max gap {gap_rf:.3g}")
    report["rf"] = {"s_iter": s_rf, "gap": gap_rf, "auc": auc}
    del trees

    # ---- checkpoint resume through the async pipeline
    path = os.path.join(tmp.name, "ckpt.txt")
    ckpt = _checkpoint_at(path, LIFE_CUT)
    write = []

    def timed_ckpt(env):
        t = time.perf_counter()
        ckpt(env)
        if env.iteration + 1 == LIFE_CUT:
            write.append(time.perf_counter() - t)

    straight, s_straight, _, wall_straight, _ = _timed_run(
        lt, ASYNC_PARAMS, train_set, None, LIFE_ROUNDS, callbacks=[timed_ckpt])
    check(straight._gbdt._async_enabled(), "resume: the async pipeline is off")
    t = time.perf_counter()
    state = load_checkpoint(path)
    load_s = time.perf_counter() - t
    check(state is not None and state.iteration == LIFE_CUT, "resume: no valid checkpoint")
    resumed, s_resumed, first_resumed, wall_resumed, _ = _timed_run(
        lt, ASYNC_PARAMS, train_set, None, LIFE_ROUNDS, init_model=path)
    text = straight.model_to_string()
    check(resumed.model_to_string() == text,
          "resume: the resumed model text differs from the uninterrupted run's, "
          + first_difference(resumed.model_to_string(), text))
    check(torch.equal(resumed._gbdt.score, straight._gbdt.score),
          "resume: the final train scores differ")
    sidecar = os.path.getsize(path + SIDECAR_SUFFIX)
    print(f"{tag} resume: learning rate 0.125 through the async pipeline, checkpoint after "
          f"round {LIFE_CUT} of {LIFE_ROUNDS} ({write[0] * 1e3:.1f} ms to write, the pending "
          f"tree flushed; sidecar {sidecar} bytes; {load_s * 1e3:.1f} ms to load), resumed "
          f"with init_model: model text byte-equal ({len(text)} bytes) and the train score "
          f"bit-equal; s/iteration straight {s_straight:.4f} ({wall_straight:.2f} s), resumed "
          f"first {first_resumed:.3f} (with the restore) then {s_resumed:.4f} "
          f"({wall_resumed:.2f} s)")
    report["resume"] = {"write_s": write[0], "load_s": load_s, "first": first_resumed,
                        "s_iter": s_resumed, "sidecar": sidecar}

    # ---- refit of phase 8's booster on a fresh draw, then rollback
    X_new, y_new = higgs_rows(seed + 16, TRAIN_ROWS)
    t = time.perf_counter()
    refit = baseline.refit(X_new, y_new)
    refit_s = time.perf_counter() - t
    auc_old = host_auc(valid[1], baseline.predict(valid[0], raw_score=True))
    auc_new = host_auc(valid[1], refit.predict(valid[0], raw_score=True))
    check(abs(auc_new - auc_old) <= REFIT_AUC_MARGIN,
          f"refit: valid AUC {auc_new} against the original's {auc_old}")
    del X_new, y_new
    t = time.perf_counter()
    baseline.rollback_one_iter()
    rollback_s = time.perf_counter() - t
    gap_rb = float(np.abs(baseline._gbdt.score[0].cpu().numpy()
                          - baseline.predict(X_train, raw_score=True)).max())
    check(baseline.num_trees() == TRAIN_ROUNDS - 1 and gap_rb <= ROLLBACK_GAP,
          f"rollback: {baseline.num_trees()} trees, train score {gap_rb} from predict")
    print(f"{tag} refit: phase 8's {TRAIN_ROUNDS} trees on a fresh {TRAIN_ROWS}-row draw "
          f"(decay 0.9) in {refit_s:.2f} s (the new Dataset's binning included): valid AUC "
          f"{auc_new:.5f} against {auc_old:.5f}; rollback of one iteration in "
          f"{rollback_s * 1e3:.1f} ms: train score against predict(raw_score=True) max gap "
          f"{gap_rb:.3g}")
    report["refit"] = {"s": refit_s, "auc": (auc_old, auc_new), "rollback_s": rollback_s,
                       "gap": gap_rb}

    # ---- the health guardrail's rollback policy
    calls = [0]

    def poisoned(preds, dataset):
        grad, hess = snapped_logloss(preds, dataset)
        if calls[0] == HEALTH_NAN_AT:
            grad = grad.copy()
            grad[::20] = np.nan
        calls[0] += 1
        return grad, hess

    bst = lt.Booster({**WAVE_PARAMS, "objective": "none", "health_check_policy": "rollback",
                      "health_check_every": HEALTH_EVERY}, train_set)
    t = time.perf_counter()
    for _ in range(HEALTH_ROUNDS):
        bst.update(fobj=poisoned)
    health_s = time.perf_counter() - t
    pred = bst.predict(valid[0])
    check(bst._gbdt._health.clip_on, "health: no rollback happened")
    check(bool(np.isfinite(pred).all()), "health: non-finite predictions after the rollback")
    print(f"{tag} health: policy rollback, check every {HEALTH_EVERY} rounds, NaN in 5% of "
          f"the rows' gradients at round {HEALTH_NAN_AT}: {HEALTH_ROUNDS} updates in "
          f"{health_s:.2f} s, {bst.current_iteration()} iterations kept (rolled back to the "
          f"check before the NaN), predictions finite, valid AUC "
          f"{host_auc(valid[1], pred):.5f}")

    launches = {}
    for lib in libs:
        launches.update(lib.launches)
    for name in LIFE_REQUIRED:
        check(launches[name] > 0, f"life-cycle path: kernel {name} never launched")
    # DART's 10 + 1 profiled, RF's 10, the straight and the resumed runs', the health run's
    updates = (LIFE_ROUNDS + 1) + 2 * LIFE_ROUNDS + (LIFE_ROUNDS - LIFE_CUT) + HEALTH_ROUNDS
    print(f"life-cycle path launches: {launches} (per update, {updates} updates: "
          + ", ".join(f"{name} {launches[name] / updates:.1f}"
                      for name in LIFE_REQUIRED) + ")")
    tmp.cleanup()
    report["seconds"] = time.perf_counter() - t_phase
    print(f"{tag} phase 16: {report['seconds']:.1f} s")
    return launches, report


# MSLR-WEB30K's shapes (Qin & Liu, "Introducing LETOR 4.0 Datasets",
# arXiv:1306.2597, and the MSLR-WEB30K release): 136 dense features, labels
# 0-4 at about the release's shares, queries of ~120 documents on average,
# the longest 1,251; 524,288 rows cut from its 3.77 M (1,048,576 until phase
# 21 came: its binning was a third of the phase). LightGBM's ranking
# settings (docs/Experiments.rst): 255 leaves, learning rate 0.1, NDCG at
# 1, 3, 5 and 10.
MSLR_FEATURES, MSLR_MAX_QUERY = 136, 1251
MSLR_ROWS, MSLR_VALID_ROWS = 524_288, 65_536
MSLR_LABEL_SHARES = (0.514, 0.325, 0.134, 0.019, 0.008)
RANK_PARAMS = {"objective": "lambdarank", "num_leaves": 255, "max_bin": 255,
               "learning_rate": 0.1, "metric": "ndcg", "eval_at": [1, 3, 5, 10],
               "verbosity": -1}
RANK_ROUNDS, RANK_SERIAL_ROUNDS, RANK_POS_ROUNDS, RANK_XE_ROUNDS, XENT_ROUNDS = 10, 3, 3, 5, 5
RANK_POSITIONS = 10  # position ids of the debiased run: a document's shown rank, capped
# the card's gradients against the CPU's on RANK_GRAD_ROWS rows of whole
# queries; model texts card = CPU on RANK_EXACT_ROWS (136 features make the
# CPU's runs ~5x phase 5's a row); the estimator on RANK_GRAD_ROWS
RANK_GRAD_ROWS, RANK_EXACT_ROWS, RANK_EXACT_ROUNDS, RANK_RANKER_ROUNDS = 65_536, 8_192, 2, 10
# the card's gradients against the plain objective's on the CPU: the card's
# exp, log and log2 are not the CPU's, and its sums run in another order
RANK_GRAD_ATOL, XENDCG_RTOL, XENDCG_ATOL = 1e-5, 1e-5, 1e-7
RANK_REQUIRED = ("histogram_slots_ragged_image", "histogram_image_to_float", "partition_decide", "partition_scan",
                 "partition_scatter", "relabel_rows", "find_best_split",
                 "find_best_split_batched", "wave_select", "wave_replay", "tree_loop_cond",
                 "histogram", "row_partition_decide", "row_partition_scatter",
                 "predict_forest_raw")
# prediction early stopping in phase 6: the HIGGS-profile model, binary
# margin 2 |score|, checked every ES_FREQ iterations
ES_FREQ, ES_MARGIN, ES_CPU_ROWS = 10, 4.0, 1024


def mslr_rows(seed: int, n: int, longest: bool = True):
    """MSLR-WEB30K-shaped rows from a seed: (X [n, 136] float32, labels
    0-4, query sizes). Query sizes are log-normal around a mean of ~120
    documents, capped at MSLR_MAX_QUERY (the first query that long when
    `longest`); each document has a latent relevance (a query effect plus
    its own), labels cut from it at MSLR_LABEL_SHARES, and the features mix
    noisy views of it (BM25- and TF-IDF-like columns), skewed counts
    (exp of a normal) and small integer columns."""
    rng = np.random.default_rng(seed)
    sizes = np.clip(np.round(rng.lognormal(4.5, 0.75, size=n // 40 + 2)), 1,
                    MSLR_MAX_QUERY).astype(np.int64)
    if longest:
        sizes[0] = MSLR_MAX_QUERY
    cum = np.cumsum(sizes)
    k = int(np.searchsorted(cum, n))
    sizes = sizes[:k + 1]
    sizes[-1] -= int(cum[k] - n)
    query = np.repeat(np.arange(len(sizes)), sizes)
    rel = (rng.normal(0.0, 0.6, size=len(sizes))[query]
           + rng.standard_normal(n, dtype=np.float32))
    X = rng.standard_normal((n, MSLR_FEATURES), dtype=np.float32)
    weight = rng.uniform(0.2, 1.0, size=48).astype(np.float32)
    X[:, :48] += rel[:, None] * weight
    np.exp(X[:, 48:96], out=X[:, 48:96])
    X[:, 96:] = np.floor(np.abs(X[:, 96:]) * 3)
    noisy = rel + rng.normal(0.0, 0.5, size=n)
    cuts = np.quantile(noisy, np.cumsum(MSLR_LABEL_SHARES)[:-1])
    y = np.searchsorted(cuts, noisy).astype(np.float64)
    return X, y, sizes


def shown_positions(sizes):
    """Each document's rank in its query's list, capped at RANK_POSITIONS - 1."""
    return np.concatenate([np.minimum(np.arange(s), RANK_POSITIONS - 1) for s in sizes])


def query_cut(sizes, n):
    """The whole queries that fit in the first n rows: (rows, their sizes)."""
    cum = np.cumsum(sizes)
    k = int(np.searchsorted(cum, n, side="right"))
    return int(cum[k - 1]), sizes[:k]


class SnappedLambdarank:
    """lambdarank gradients of the port's objective on the host's CPU,
    snapped to a 2**-8 grid (hessians at least 2**-8): every histogram sum
    of them is exact in float32, so the card and the CPU grow the same
    trees whatever order they sum in."""

    def __init__(self):
        self.obj = None

    def __call__(self, preds, dataset):
        from lightgbm_tpu_torch.config import Config
        from lightgbm_tpu_torch.io.metadata import Metadata
        from lightgbm_tpu_torch.objectives import create_objective

        if self.obj is None:
            md = Metadata(len(preds))
            md.set_label(dataset.get_label())
            md.set_query(dataset.get_group())
            self.obj = create_objective("lambdarank", Config({"objective": "lambdarank"}))
            self.obj.init(md, len(preds), torch.device("cpu"))
        g, h = self.obj.get_gradients(torch.from_numpy(np.array(preds, dtype=np.float32)))
        return (np.round(g.numpy().astype(np.float64) * 256) / 256,
                np.round(np.maximum(h.numpy().astype(np.float64), 1 / 256) * 256) / 256)


def _objective_pair(name, params, y, sizes, positions=None, card_only=False):
    """The port's objective `name` bound to the same labels and queries on
    the card and on the CPU (the card alone with `card_only`)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.metadata import Metadata
    from lightgbm_tpu_torch.objectives import create_objective

    md = Metadata(len(y))
    md.set_label(y)
    md.set_query(sizes)
    if positions is not None:
        md.set_positions(positions)
    out = []
    for dev in (DEVICE,) if card_only else (DEVICE, "cpu"):
        obj = create_objective(name, Config({"objective": name, **params}))
        obj.init(md, len(y), torch.device(dev))
        out.append(obj)
    return out


def check_rank_gradients(y, sizes, seed):
    """The card's lambdarank (plain and position-debiased, 2 iterations)
    and rank_xendcg (2 iterations) gradients on RANK_GRAD_ROWS rows of
    whole queries against the same objectives run on the CPU. Returns the
    largest gaps."""
    rows, cut = query_cut(sizes, RANK_GRAD_ROWS)
    y = y[:rows]
    rng = np.random.RandomState(seed)
    score = (rng.normal(size=rows) * 2).astype(np.float32)
    gaps = {}
    cases = (("lambdarank", {}, None, RANK_GRAD_ATOL, 0.0),
             ("lambdarank", {"lambdarank_position_bias_regularization": 0.1},
              shown_positions(cut), RANK_GRAD_ATOL, 0.0),
             ("rank_xendcg", {}, None, XENDCG_ATOL, XENDCG_RTOL))
    for name, params, positions, atol, rtol in cases:
        card, cpu = _objective_pair(name, params, y, cut, positions)
        s = score.copy()
        worst = 0.0
        for _ in range(2):
            g, h = card.get_gradients(torch.from_numpy(s).to(DEVICE))
            rg, rh = cpu.get_gradients(torch.from_numpy(s))
            check(g.device.type == torch.device(DEVICE).type,
                  f"{name}: the gradients left the card")
            for a, b in ((g.cpu(), rg), (h.cpu(), rh)):
                d = (a.double() - b.double()).abs()
                check(bool((d <= atol + rtol * b.double().abs()).all()),
                      f"{name} ({'debiased' if positions is not None else 'plain'}): card "
                      f"gradients {float(d.max()):.3g} from the CPU's")
                worst = max(worst, float(d.max()))
            s = s - rg.numpy()
        key = name + ("_debiased" if positions is not None else "")
        gaps[key] = worst
    print(f"exact (ranking gradients): {rows} rows in {len(cut)} queries, 2 iterations: the "
          f"card's lambdarank, position-debiased lambdarank and rank_xendcg gradients and "
          f"hessians within {RANK_GRAD_ATOL:g} (xendcg rtol {XENDCG_RTOL:g} / atol "
          f"{XENDCG_ATOL:g}) of the CPU's; largest gaps "
          + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()))
    return gaps


def gradient_step(y, sizes, positions, tag):
    """The full-width gradient step of each ranking objective on the card:
    its device time (CUDA events, 3 calls after a warm-up) and the peak
    memory it allocates above what it holds."""
    out = {}
    rng = np.random.RandomState(17)
    score = torch.from_numpy((rng.normal(size=len(y)) * 2).astype(np.float32)).to(DEVICE)
    for label, name, params, pos in (
            ("lambdarank", "lambdarank", {}, None),
            ("lambdarank, position-debiased", "lambdarank",
             {"lambdarank_position_bias_regularization": 0.1}, positions),
            ("rank_xendcg", "rank_xendcg", {}, None)):
        obj = _objective_pair(name, params, y, sizes, pos, card_only=True)[0]
        obj.get_gradients(score)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: obj.get_gradients(score), 3)
        peak = torch.cuda.max_memory_allocated() - base
        buckets = ", ".join(f"{b['L']}:{len(b['qids'])}" for b in obj.layout.buckets)
        print(f"{tag} gradient step ({label}): {len(y)} rows in {len(sizes)} queries "
              f"(bucket length: queries {buckets}): {ms:.2f} ms of card time a call (CUDA "
              f"events), peak memory {peak / 2**20:.1f} MiB above the objective's own")
        out[label] = (ms, peak)
        del obj
    torch.cuda.empty_cache()
    return out


def _rank_run(lt, params, train_set, valid_set, rounds, metric_key="ndcg@10"):
    """lt.train with a stamp after each round and the validation set:
    (booster, s/iteration of the rounds after the first, first-round s,
    wall s, the valid metric by round)."""
    stamps, evals = [], {}
    t = time.perf_counter()
    bst = lt.train(dict(params), train_set, num_boost_round=rounds, valid_sets=[valid_set],
                   valid_names=["valid"],
                   callbacks=[lambda env: stamps.append(time.perf_counter()),
                              lt.record_evaluation(evals)])
    wall = time.perf_counter() - t
    per_iter = np.diff([t] + stamps)
    steady = float(np.mean(per_iter[1:])) if len(per_iter) > 1 else float(per_iter[0])
    return bst, steady, float(per_iter[0]), wall, evals["valid"][metric_key]


def _busy(bst, tag, label):
    busy = device_busy_share(bst.update)
    print(f"{tag} {label}: one more round (torch.profiler): "
          + ("busy share not measured (the profiler saw no device time)" if busy is None else
             f"{busy[0] * 1e3:.1f} ms of device operations in {busy[1] * 1e3:.1f} ms wall, "
             f"{busy[0] / busy[1]:.1%} busy; top kernels: {busy[2]}"))
    return None if busy is None else busy[0] / busy[1]


def drive_ranking(lt, libs, higgs_set, higgs_valid, seed, tag):
    """Phase 17: learning to rank at MSLR-WEB30K's shapes and cross entropy
    at HIGGS width (phase 8's binned data `higgs_set` and its validation
    rows, on soft labels for the run). Returns (the launches of the phase's
    full-width runs, the report)."""
    from lightgbm_tpu_torch.sklearn import LGBMRanker
    from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner

    t_phase = time.perf_counter()
    report = {}
    t = time.perf_counter()
    X, y, sizes = mslr_rows(seed + 17, MSLR_ROWS)
    Xv, yv, sv = mslr_rows(seed + 18, MSLR_VALID_ROWS, longest=False)
    t_make = time.perf_counter() - t
    t = time.perf_counter()
    train_set = lt.Dataset(X, label=y, group=sizes,
                           params={"max_bin": RANK_PARAMS["max_bin"]}).construct()
    valid_set = train_set.create_valid(Xv, label=yv, group=sv)
    t_bin = time.perf_counter() - t
    shares = np.bincount(y.astype(np.int64), minlength=5) / len(y)
    print(f"ranking data (MSLR-WEB30K shapes): {len(y)} x {X.shape[1]} rows in {len(sizes)} "
          f"queries (mean {sizes.mean():.1f}, longest {sizes.max()}), labels 0-4 at "
          + "/".join(f"{s:.3f}" for s in shares)
          + f"; validation {len(yv)} rows in {len(sv)} queries; made in {t_make:.1f} s, "
          f"binned in {t_bin:.1f} s")

    # ---- exact: the card's gradients and trees against the CPU's
    report["gradient_gaps"] = check_rank_gradients(y, sizes, seed + 19)
    t = time.perf_counter()
    rows, cut = query_cut(sizes, RANK_EXACT_ROWS)
    snapped = {**RANK_PARAMS, "num_leaves": EXACT_LEAVES, "metric": "None"}
    for learner in ("wave", "serial"):
        out = _exact_card_cpu(lt, X[:rows], y[:rows], snapped, RANK_EXACT_ROUNDS, learner,
                              SnappedLambdarank(), group=cut)
        check(out["card"][0] == out["cpu"][0],
              f"exact lambdarank ({learner}): the card's model text differs from the CPU's, "
              + first_difference(out["card"][0], out["cpu"][0]))
    print(f"exact (lambdarank): {rows} rows in {len(cut)} queries, {EXACT_LEAVES} leaves, "
          f"{RANK_EXACT_ROUNDS} rounds on snapped lambdarank gradients computed on the host: "
          f"card and CPU model texts byte-equal through the wave and the serial learner "
          f"({time.perf_counter() - t:.1f} s)")
    report["gradient_step"] = gradient_step(y, sizes, shown_positions(sizes), tag)

    # ---- the full-width runs, their launches counted
    for lib in libs:
        lib.reset_launches()
    runs = {}
    for label, params, rounds in (
            ("lambdarank (wave)", RANK_PARAMS, RANK_ROUNDS),
            ("lambdarank (serial, feature_fraction_bynode 0.8)",
             {**RANK_PARAMS, "feature_fraction_bynode": 0.8}, RANK_SERIAL_ROUNDS),
            ("rank_xendcg (wave)", {**RANK_PARAMS, "objective": "rank_xendcg"},
             RANK_XE_ROUNDS)):
        bst, steady, first, wall, ndcg = _rank_run(lt, params, train_set, valid_set, rounds)
        wave = isinstance(bst._gbdt.tree_learner, DeviceTreeLearner)
        check(wave == ("serial" not in label), f"{label}: trained with the wrong learner")
        check(all(np.isfinite(ndcg)) and 0.0 < ndcg[-1] <= 1.0, f"{label}: NDCG@10 {ndcg}")
        print(f"{tag} {label}: {rounds} rounds in {wall:.2f} s; s/iteration first "
              f"{first:.3f}, mean of the rest {steady:.4f}; valid NDCG@10 by round "
              + " ".join(f"{v:.5f}" for v in ndcg))
        busy = _busy(bst, tag, label)
        runs[label] = {"s_iter": steady, "first": first, "ndcg10": ndcg, "busy": busy}
        if label.startswith("lambdarank (wave)"):
            check(ndcg[-1] > ndcg[0], f"lambdarank: valid NDCG@10 did not rise from round 1 "
                                      f"to round {rounds}: {ndcg}")
            wave_bst = bst
    # position-debiased lambdarank: the binned data takes the positions
    train_set.set_position(shown_positions(sizes))
    bst, steady, first, wall, ndcg = _rank_run(
        lt, {**RANK_PARAMS, "lambdarank_position_bias_regularization": 0.1}, train_set,
        valid_set, RANK_POS_ROUNDS)
    biases = bst._gbdt.objective._pos_biases
    check(biases.device.type == torch.device(DEVICE).type
          and bool(torch.isfinite(biases).all()),
          "position debias: biases not finite on the card")
    print(f"{tag} lambdarank, position-debiased ({RANK_POSITIONS} position ids): "
          f"{RANK_POS_ROUNDS} rounds in {wall:.2f} s; s/iteration first {first:.3f}, mean of "
          f"the rest {steady:.4f}; valid NDCG@10 by round " + " ".join(f"{v:.5f}" for v in ndcg)
          + "; position biases " + " ".join(f"{v:.4f}" for v in biases.cpu().numpy()))
    busy = _busy(bst, tag, "lambdarank, position-debiased")
    runs["lambdarank, position-debiased"] = {"s_iter": steady, "first": first,
                                             "ndcg10": ndcg, "busy": busy}
    del bst
    # cross entropy at HIGGS width on soft labels (phase 8's binned rows,
    # their labels swapped for the run): the binary label pulled toward 1/2
    # by an amount that varies with the first feature
    def soft(X_, y_):
        return 1.0 / (1.0 + np.exp(-(np.asarray(y_, dtype=np.float64) * 2.0 - 1.0)
                                   * np.abs(np.asarray(X_[:, 0], dtype=np.float64))))

    X_higgs, y_higgs = higgs_set.get_data(), higgs_set.get_label()
    p = soft(X_higgs, y_higgs)
    higgs_set.set_label(p)
    xent_params = {**WAVE_PARAMS, "objective": "cross_entropy", "metric": "cross_entropy"}
    bst, steady, first, wall, xent = _rank_run(
        lt, xent_params, higgs_set,
        higgs_set.create_valid(higgs_valid[0], label=soft(*higgs_valid)), XENT_ROUNDS,
        metric_key="cross_entropy")
    check(isinstance(bst._gbdt.tree_learner, DeviceTreeLearner), "cross_entropy: not the "
          "wave learner")
    check(xent[-1] < xent[0], f"cross_entropy: valid cross entropy did not fall: {xent}")
    print(f"{tag} cross_entropy (wave, HIGGS rows with labels in [0, 1]): "
          f"{len(p)} rows, {XENT_ROUNDS} rounds in {wall:.2f} s; s/iteration first "
          f"{first:.3f}, mean of the rest {steady:.4f}; valid cross entropy by round "
          + " ".join(f"{v:.5f}" for v in xent))
    busy = _busy(bst, tag, "cross_entropy")
    higgs_set.set_label(y_higgs)
    runs["cross_entropy"] = {"s_iter": steady, "first": first, "xent": xent, "busy": busy}
    del bst
    # the ranker estimator on a cut of whole queries
    rows, cut = query_cut(sizes, RANK_GRAD_ROWS)
    t = time.perf_counter()
    ranker = LGBMRanker(n_estimators=RANK_RANKER_ROUNDS, num_leaves=63, learning_rate=0.1)
    ranker.fit(X[:rows], y[:rows], group=cut, eval_set=[(Xv, yv)], eval_group=[sv],
               eval_at=[10])
    fit_s = time.perf_counter() - t
    pred = ranker.predict(Xv)
    check(isinstance(ranker.booster_._gbdt.tree_learner, DeviceTreeLearner),
          "LGBMRanker: not the wave learner on the card")
    check(pred.shape == (len(yv),) and bool(np.isfinite(pred).all()),
          "LGBMRanker: predictions not finite of the valid set's shape")
    check(bool(np.array_equal(pred, ranker.booster_.predict(Xv))),
          "LGBMRanker: predict differs from its booster's")
    ndcg = ranker.evals_result_["valid_0"]["ndcg@10"]
    print(f"{tag} LGBMRanker: fit {RANK_RANKER_ROUNDS} rounds on {rows} rows in {len(cut)} "
          f"queries (63 leaves) in {fit_s:.2f} s, predict {len(yv)} rows; valid NDCG@10 "
          f"{ndcg[0]:.5f} -> {ndcg[-1]:.5f}")
    report["ranker"] = {"fit_s": fit_s, "ndcg10": ndcg}

    launches = {}
    for lib in libs:
        launches.update(lib.launches)
    for name in RANK_REQUIRED:
        check(launches[name] > 0, f"ranking path: kernel {name} never launched")
    print(f"ranking path launches: {launches}")
    report["runs"] = runs
    report["wave_booster"] = wave_bst
    report["seconds"] = time.perf_counter() - t_phase
    print(f"{tag} phase 17: {report['seconds']:.1f} s")
    return launches, report


# ---------------------------------------------------------------------------
# phase 18: observe and serve
OBSERVE_ROUNDS = 3  # wave rounds in the telemetry session and under the sanitizer
OBSERVE_REQUIRED = ("histogram_slots_ragged_image", "histogram_image_to_float", "partition_decide", "partition_scan",
                    "partition_scatter", "relabel_rows", "find_best_split_batched",
                    "wave_select", "wave_replay", "tree_loop_cond", "predict_forest_raw")
# the profiled round's trace must name these kernels
OBSERVE_TRACE_KERNELS = ("hist_ragged_kernel", "split_kernel", "wave_select_kernel",
                         "wave_replay_kernel", "decide_kernel", "scan_kernel",
                         "scatter_kernel")
CANARY_FRACTION, CANARY_PROMOTE, CANARY_REQUESTS = 0.25, 4, 24
BREAKER_ROWS = 1024  # rows a request of the breaker's open window
PROBE_ROWS = 200  # a half-open probe's request: one chunk under degraded_rows


def _http(base, path, body=None, ctype="application/json"):
    req = urllib.request.Request(base + path, data=body, method="POST" if body else "GET",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.read()


def _http_code(base, path, body, ctype):
    """(status, error code) of a request answered with an error; (200,
    None) for an answer."""
    try:
        status, _ = _http(base, path, body, ctype)
        return status, None
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())["error"]


def _metric(base, name):
    from lightgbm_tpu_torch import exposition

    status, text = _http(base, "/metrics")
    check(status == 200, "observe: /metrics refused")
    return exposition.parse_exposition(text.decode()).get((name, ()))


def observe_training(lt, train_set, tag, report):
    """Telemetry, attribution, sanitizer and profiler on phase 8's binned
    data."""
    from lightgbm_tpu_torch import exposition, perfmodel, telemetry
    from lightgbm_tpu_torch.utils import sanitize

    tmp = tempfile.mkdtemp(prefix="chip_smoke_observe_")
    # ---- a telemetry session over OBSERVE_ROUNDS wave rounds, against off
    # off, on, off: the first run also loads what a process loads once
    off = lt.train(dict(WAVE_PARAMS), train_set, num_boost_round=OBSERVE_ROUNDS)
    tel_dir = os.path.join(tmp, "telemetry")
    t = time.perf_counter()
    on = lt.train({**WAVE_PARAMS, "telemetry_dir": tel_dir}, train_set,
                  num_boost_round=OBSERVE_ROUNDS)
    wall_on = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    again = lt.train(dict(WAVE_PARAMS), train_set, num_boost_round=OBSERVE_ROUNDS)
    wall_off = time.perf_counter() - t
    check(again.model_to_string() == off.model_to_string(),
          "observe: two runs with telemetry off differ")
    check(on.model_to_string() == off.model_to_string(),
          "observe: the model text with telemetry on differs from telemetry off")
    check(sorted(os.listdir(tel_dir)) == ["events.jsonl", "metrics.prom", "trace.json"],
          f"observe: the telemetry dir holds {os.listdir(tel_dir)}")
    with open(os.path.join(tel_dir, "events.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    with open(os.path.join(tel_dir, "trace.json")) as fh:
        trace = json.load(fh)
    with open(os.path.join(tel_dir, "metrics.prom")) as fh:
        prom = exposition.parse_exposition(fh.read())
    kinds = [e["ev"] for e in events]
    waves = [e for e in events if e["ev"] == "tree_wave"]
    check(kinds.count("iteration") == OBSERVE_ROUNDS and len(waves) == OBSERVE_ROUNDS
          and all(e["graphed"] and e["waves"] > 0 for e in waves),
          f"observe: {kinds.count('iteration')} iteration and {len(waves)} tree_wave events "
          f"for {OBSERVE_ROUNDS} trees")
    summary = events[-1]
    check(summary["ev"] == "session_end", "observe: the stream does not end with session_end")
    check(summary["hbm_high_water_bytes"] == peak > 0,
          f"observe: hbm_high_water_bytes {summary['hbm_high_water_bytes']} is not the "
          f"memory stats' peak {peak}")
    check(prom[("lgbm_tpu_hbm_high_water_bytes", ())] == peak,
          "observe: metrics.prom's high-water is not the session's")
    spans = {e["name"] for e in trace["traceEvents"] if e["ph"] == "B"}
    check({"tree_device", "tree_results", "train_iteration.boost"} <= spans,
          f"observe: the trace lacks the learner's spans ({sorted(spans)[:12]})")
    report["s_per_iter"] = (wall_on / OBSERVE_ROUNDS, wall_off / OBSERVE_ROUNDS)
    print(f"{tag} observe: {OBSERVE_ROUNDS} wave rounds at {train_set.num_data()} x "
          f"{train_set.num_feature()}: {wall_on / OBSERVE_ROUNDS:.4f} s/iteration with a "
          f"telemetry session, {wall_off / OBSERVE_ROUNDS:.4f} without; model texts "
          f"byte-equal; {len(events)} events, {len(spans)} span labels, "
          f"{summary['compile_count']} compiles ({summary['kernel_compile_count']} kernel "
          f"builds), hbm_high_water_bytes {peak} = torch.cuda.max_memory_allocated")
    # ---- attribution of the session's stages
    att = perfmodel.attribution(summary["timer_totals"], summary["counters"],
                                total_s=wall_on, device_kind=CARD_KIND)
    check(abs(att["fractions_sum"] - 1.0) <= 1e-9,
          f"observe: attribution fractions sum to {att['fractions_sum']}")
    roofs = {k: v["roofline_frac"] for k, v in att["stages"].items() if "roofline_frac" in v}
    check(roofs and all(r <= 1.05 for r in roofs.values()),
          f"observe: roofline fractions {roofs}")
    report["attribution"] = att
    print(f"{tag} observe: attribution over {att['total_s']:.3f} s: " + ", ".join(
        f"{k} {v['fraction']:.3f}" for k, v in att["stages"].items())
        + "; grow_fused model " + ", ".join(
            f"{k} {v / 1e6:.1f} MB" for k, v in
            att["stages"]["grow_fused"]["model_components_bytes"].items())
        + f", {att['stages']['grow_fused']['model_s'] * 1e3:.3f} ms at the peak rate, "
        f"roofline fraction {roofs['grow_fused']:.4f}")
    # ---- the sanitizer: phase 11's async settings, then one GOSS sampling round
    async_params = dict(ASYNC_PARAMS)
    plain_async = lt.train(async_params, train_set, num_boost_round=OBSERVE_ROUNDS)
    sanitize.reset()
    sanitize.enable("cuda", sync_debug=True)
    try:
        checked_async = lt.train(async_params, train_set, num_boost_round=OBSERVE_ROUNDS)
    finally:
        sanitize.disable()
    counts_async = sanitize.sync_counts()
    check(checked_async.model_to_string() == plain_async.model_to_string(),
          "observe: the async run under the sanitizer differs from the run without it")
    goss = {**WAVE_PARAMS, **GOSS_PARAMS}
    warmup = int(1.0 / goss["learning_rate"])
    boosters = []
    for sanitized in (False, True):
        bst = lt.Booster(dict(goss), train_set)
        for _ in range(warmup):
            bst.update()
        sanitize.reset()
        if sanitized:
            sanitize.enable("cuda", sync_debug=True)
        try:
            bst.update()  # the first sampling round
        finally:
            sanitize.disable()
        boosters.append(bst)
    counts_goss = sanitize.sync_counts()
    check(boosters[0].model_to_string() == boosters[1].model_to_string(),
          "observe: the GOSS round under the sanitizer differs from the round without it")
    for what, counts in (("async", counts_async), ("GOSS", counts_goss)):
        for scope in sorted(sanitize.SYNC_FREE):
            check(not counts.get(scope), f"observe: {counts.get(scope)} syncs in the "
                                         f"sync-free scope {scope} ({what} run)")
    report["sanitizer"] = {"async": counts_async, "goss": counts_goss}
    print(f"observe: sanitizer ({OBSERVE_ROUNDS} async rounds; one GOSS sampling round): "
          f"0 syncs in {sorted(sanitize.SYNC_FREE)}, sync-debug mode armed there; model "
          f"texts byte-equal; host reads by scope: async {counts_async}, GOSS {counts_goss}")
    # ---- the profiler: one round under LGBM_TPU_PROFILE
    prof_dir = os.path.join(tmp, "profile")
    os.environ["LGBM_TPU_PROFILE"] = prof_dir
    try:
        lt.train(dict(WAVE_PARAMS), train_set, num_boost_round=1)
    finally:
        del os.environ["LGBM_TPU_PROFILE"]
    traces = [f for f in os.listdir(prof_dir) if f.endswith(".json")]
    check(len(traces) == 1, f"observe: the profile dir holds {traces}")
    with open(os.path.join(prof_dir, traces[0])) as fh:
        names = {str(e.get("name", "")) for e in json.load(fh)["traceEvents"]}
    missing = [k for k in OBSERVE_TRACE_KERNELS if not any(k in n for n in names)]
    check(not missing, f"observe: the profiler's trace names none of {missing}")
    cond = any("tree_loop_cond" in n for n in names)
    print(f"observe: LGBM_TPU_PROFILE wrote {traces[0]} ({len(names)} event names) naming "
          + ", ".join(OBSERVE_TRACE_KERNELS) + f"; the tree graph's tree_loop_cond "
          f"{'named' if cond else 'not named'} (it runs only inside the graph)")


def observe_serving(lt, higgs, multi, seed, tag, report):
    """Replicas, /metrics, /debug/flight, the canary and the breaker."""
    from lightgbm_tpu_torch import Booster
    from lightgbm_tpu_torch.models.synthetic import make_rows, random_model
    from lightgbm_tpu_torch.ops import predict_cuda
    from lightgbm_tpu_torch.serving import CircuitBreaker, PredictionService, serve, wire
    from lightgbm_tpu_torch.serving.breaker import CLOSED, HALF_OPEN, OPEN
    from lightgbm_tpu_torch.utils import faults
    from lightgbm_tpu_torch.utils.timer import global_timer

    texts = {"higgs": higgs.to_string(), "multi": multi.to_string()}
    boosters = {k: Booster(model_str=v) for k, v in texts.items()}
    width = {"higgs": HIGGS["n_features"], "multi": multi.max_feature_idx + 1}
    cats = {"higgs": (), "multi": (3, 7)}
    breaker = CircuitBreaker(cooldown_s=0.5, probe_successes=2)
    svc = PredictionService(max_batch_rows=4096, min_bucket=64, batch_window_s=0.001,
                            replicas=2, breaker=breaker)
    server, server_thread = serve(svc, port=0)
    base = f"http://127.0.0.1:{server.port}"
    try:
        for name, text in texts.items():
            status, _ = _http(base, "/models", json.dumps(
                {"name": name, "model_str": text}).encode())
            check(status == 200, f"observe serving: upload of {name} refused")
        check(svc.placement() == {"higgs": 0, "multi": 1},
              f"observe serving: placement {svc.placement()}")
        rows = {k: make_rows(np.random.RandomState(seed + 40 + i),
                             SERVE_REQUESTS * SERVE_ROWS, width[k], cats[k])
                for i, k in enumerate(texts)}
        answers, failures = [None] * SERVE_REQUESTS, []

        def client(worker):
            for i in range(worker, SERVE_REQUESTS, SERVE_THREADS):
                name = "higgs" if i % 2 == 0 else "multi"
                x = rows[name][i * SERVE_ROWS:(i + 1) * SERVE_ROWS]
                raw = i % 4 < 2
                try:
                    _, body = _http(base, "/predict", wire.encode_request(name, x, raw),
                                    wire.CONTENT_TYPE)
                    answers[i] = (name, x, raw, wire.decode_response(body)[0])
                except Exception as exc:  # noqa: BLE001 - reported below
                    failures.append(f"request {i}: {exc!r}")

        threads = [threading.Thread(target=client, args=(w,)) for w in range(SERVE_THREADS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t
        check(not failures, "observe serving: " + "; ".join(failures[:5]))
        for i, (name, x, raw, got) in enumerate(answers):
            check(bool(np.array_equal(got, boosters[name].predict(x, raw_score=raw))),
                  f"observe serving: request {i} ({name}) differs from Booster.predict")
        check(_metric(base, "lgbm_tpu_serve_batcher_requests") == SERVE_REQUESTS,
              "observe serving: /metrics' request counter is not the requests sent")
        per_replica = [b["requests"] for b in svc.stats()["replicas"]["batchers"]]
        check(per_replica == [SERVE_REQUESTS // 2] * 2,
              f"observe serving: requests by replica {per_replica}")
        status, body = _http(base, "/debug/flight")
        dump = json.loads(body)
        check(status == 200 and dump["format"] == "lgbm-flight" and dump["events"],
              "observe serving: /debug/flight did not answer a dump")
        print(f"{tag} observe serving: PredictionService(replicas=2), higgs on replica 0 and "
              f"multi on replica 1 (each its own CUDA stream); {SERVE_REQUESTS} requests x "
              f"{SERVE_ROWS} rows from {SERVE_THREADS} threads in {wall:.3f} s "
              f"({SERVE_REQUESTS * SERVE_ROWS / wall:,.0f} rows/s), {per_replica} a replica, "
              f"every answer bit-equal to Booster.predict; /metrics parses "
              f"(serve_batcher_requests {SERVE_REQUESTS}); /debug/flight "
              f"{len(dump['events'])} records")

        # ---- the canary: every round(1/fraction)-th request of higgs
        v2 = random_model(np.random.RandomState(seed + 50), **{**HIGGS, "n_iterations": 100})
        bst_v2 = Booster(model_str=v2.to_string())
        svc.start_canary("higgs", fraction=CANARY_FRACTION, promote_after=CANARY_PROMOTE,
                         model_str=v2.to_string())
        every = int(round(1 / CANARY_FRACTION))
        routed = []
        for i in range(CANARY_REQUESTS):
            x = rows["higgs"][i * SERVE_ROWS:(i + 1) * SERVE_ROWS]
            got = svc.predict("higgs", x, raw_score=True)
            want_v2 = bst_v2.predict(x, raw_score=True)
            want_v1 = boosters["higgs"].predict(x, raw_score=True)
            check(bool(np.array_equal(got, want_v2)) or bool(np.array_equal(got, want_v1)),
                  f"observe canary: request {i} is neither version's answer")
            routed.append(bool(np.array_equal(got, want_v2)))
        rule = [(i + 1) % every == 0 or i >= every * CANARY_PROMOTE
                for i in range(CANARY_REQUESTS)]
        check(routed == rule, f"observe canary: routed {routed}, the rule {rule}")
        info = svc.canary_info()
        check(info["promoted"] == 1 and not info["active"],
              f"observe canary: {info}")
        print(f"observe canary: fraction {CANARY_FRACTION}, promote after {CANARY_PROMOTE}: "
              f"requests {[i for i, r in enumerate(routed) if r and i < every * CANARY_PROMOTE]}"
              f" went to the candidate as the rule picks, then it was promoted; its answers "
              f"bit-equal to its Booster's")

        # ---- the breaker: predict_fail on 3 dispatches, shedding, recovery
        check(_metric(base, "lgbm_tpu_serve_breaker_state") == 0,
              "observe breaker: not closed before the faults")
        xb = make_rows(np.random.RandomState(seed + 60), 6 * BREAKER_ROWS, HIGGS["n_features"])
        failures0 = global_timer.counters.get("serve_dispatch_failures", 0)
        shed0 = global_timer.counters.get("serve_breaker_shed", 0)
        launches0 = predict_cuda.launches["predict_forest_raw"]
        faults.install("predict_fail@1:3")
        states, codes = [], []
        try:
            for i, raw in enumerate((False, True, False, True)):
                x = xb[i * BREAKER_ROWS:(i + 1) * BREAKER_ROWS]
                codes.append(_http_code(base, "/predict", wire.encode_request("higgs", x, raw),
                                        wire.CONTENT_TYPE))
                states.append(_metric(base, "lgbm_tpu_serve_breaker_state"))
        finally:
            faults.clear()
        check(codes == [(500, "internal_error")] * 3 + [(503, "breaker_open")],
              f"observe breaker: answers {codes}, not three failures and one shed request")
        check(breaker.state == OPEN and states == [0, 0, 2, 2],
              f"observe breaker: states {states} after 3 failures and one shed request")
        check(predict_cuda.launches["predict_forest_raw"] == launches0,
              "observe breaker: a failed or shed request launched the traversal")
        time.sleep(breaker.cooldown_s + 0.1)
        for i in (4, 5):
            x = xb[i * BREAKER_ROWS:i * BREAKER_ROWS + PROBE_ROWS]
            check(bool(np.array_equal(svc.predict("higgs", x), bst_v2.predict(x))),
                  f"observe breaker: probe request {i} differs from Booster.predict")
            states.append(_metric(base, "lgbm_tpu_serve_breaker_state"))
        check(predict_cuda.launches["predict_forest_raw"] > launches0,
              "observe breaker: the half-open probes did not run on the card")
        check(breaker.state == CLOSED and states[4:] == [3, 0],
              f"observe breaker: states {states}, not half-open then closed")
        stats = svc.stats()["batcher"]
        failures = global_timer.counters.get("serve_dispatch_failures", 0) - failures0
        shed = global_timer.counters.get("serve_breaker_shed", 0) - shed0
        check(failures == 3 and shed == 1 and stats["device_failures"] == 3
              and stats["breaker_shed"] == 1,
              f"observe breaker: {failures} device failures and {shed} shed requests, not 3 "
              f"and 1 (the injected window only)")
        check(_metric(base, "lgbm_tpu_serve_batcher_device_failures") == 3
              and _metric(base, "lgbm_tpu_serve_batcher_breaker_shed") == 1,
              "observe breaker: /metrics' failures and shed requests are not the window's")
        report["breaker"] = {"states": states, "codes": codes}
        print(f"{tag} observe breaker: predict_fail@1:3 -> 3 requests failed (HTTP 500) with "
              f"no launch, the breaker OPEN, a 4th request shed (HTTP 503 breaker_open) with "
              f"no launch; after the {breaker.cooldown_s} s cooldown 2 half-open probes on "
              f"the card closed it; serve_breaker_state on /metrics {states}; 3 failures and "
              f"1 shed request, all in the injected window")
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        server_thread.join(timeout=10)


def drive_observe(lt, libs, train_set, higgs, multi, seed, tag):
    """Phase 18: telemetry, attribution, the sanitizer and the profiler on
    phase 8's binned data, then replicas, /metrics, /debug/flight, the
    canary and the breaker. Returns (the launches of the phase, the
    report)."""
    from lightgbm_tpu_torch import telemetry

    for lib in libs:
        lib.reset_launches()
    report = {}
    t_phase = time.perf_counter()
    check(not telemetry.enabled(), "observe: a telemetry session is already active")
    observe_training(lt, train_set, tag, report)
    observe_serving(lt, higgs, multi, seed, tag, report)
    launches = {}
    for lib in libs:
        launches.update(lib.launches)
    for name in OBSERVE_REQUIRED:
        check(launches[name] > 0, f"observe path: kernel {name} never launched")
    report["seconds"] = time.perf_counter() - t_phase
    print(f"observe path launches: {launches}")
    print(f"{tag} phase 18: {report['seconds']:.1f} s")
    return launches, report


# phase 19's text file: a quarter of phase 8's rows (all until phase 21, half
# until phase 22)
FACADE_ROWS = 262_144
FACADE_ROUNDS, CAPI_ROUNDS = 10, 3
FACADE_CHECK_ROWS = 32_768  # rows held against the plain parse
CONVERT_ROWS, SHAP_ROWS = 4_096, 128
FACADE_WAVE = ("histogram_slots_ragged_image", "histogram_image_to_float", "partition_decide", "partition_scan",
               "partition_scatter", "relabel_rows", "find_best_split", "find_best_split_batched",
               "wave_select", "wave_replay", "tree_loop_cond")


def _counts(libs):
    out = {}
    for lib in libs:
        out.update(lib.launches)
    return out


def _moved(libs, before, names, what):
    after = _counts(libs)
    for name in names:
        check(after[name] > before[name], f"façades: {what}: kernel {name} never launched")
    return after


def _cli_args(task, **kw):
    return [f"task={task}"] + [f"{k}={v}" for k, v in kw.items()]


def _timed_cli(cli, args):
    """cli.run(args) with an after-iteration clock on its engine.train call
    (the first iteration apart); returns (seconds a round after the first,
    the first round's seconds, the whole run's seconds)."""
    real, stamps = cli.train_fn, []

    def timed(*a, **k):
        k["callbacks"] = list(k.get("callbacks") or []) + [
            lambda env: stamps.append(time.perf_counter())]
        stamps.append(time.perf_counter())
        return real(*a, **k)

    cli.train_fn = timed
    t0 = time.perf_counter()
    try:
        check(cli.run(args) == 0, f"façades: cli {args[0]} did not return 0")
    finally:
        cli.train_fn = real
    per = np.diff(stamps)
    return float(np.mean(per[1:])), float(per[0]), time.perf_counter() - t0


def _write_rows(path, X, y):
    np.savetxt(path, np.column_stack([y, X.astype(np.float64)]), fmt="%.9g", delimiter="\t")


def drive_facades(lt, libs, X_train, y_train, X_valid, y_valid, seed, tag):
    """Phase 19: the façades on phase 8's rows written to a TSV (with a
    .weight side file) and a valid TSV. Returns (the launches of the
    phase, the report)."""
    import ctypes
    import subprocess

    from lightgbm_tpu_torch import capi, cli
    from lightgbm_tpu_torch.capi import impl
    from lightgbm_tpu_torch.config import key_alias_transform, kv2map
    from lightgbm_tpu_torch.io.parser import parse_file, plain_parse_dense

    for lib in libs:
        lib.reset_launches()
    report = {}
    t_phase = time.perf_counter()
    X_train, y_train = X_train[:FACADE_ROWS], y_train[:FACADE_ROWS]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_facades_") as tmp:
        train, valid = os.path.join(tmp, "higgs.train"), os.path.join(tmp, "higgs.test")
        weight = np.random.RandomState(seed + 19).uniform(0.5, 1.5, len(y_train))
        t0 = time.perf_counter()
        _write_rows(train, X_train, y_train)
        np.savetxt(train + ".weight", weight, fmt="%.9g")
        _write_rows(valid, X_valid, y_valid)
        report["write_s"] = time.perf_counter() - t0
        size = os.path.getsize(train)

        # 1. parse natively; the first rows against the plain parse
        t0 = time.perf_counter()
        X, y, _ = parse_file(train)
        report["parse_s"] = time.perf_counter() - t0
        n_check = min(FACADE_CHECK_ROWS, len(y))
        plain = plain_parse_dense(train, "\t", 0, max_rows=n_check)
        check(bool(np.array_equal(np.column_stack([y, X])[:n_check], plain)),
              "façades: the native parse differs from the plain parse")
        check(X.shape == (len(y_train), 28), f"façades: parsed {X.shape}")
        Xv, yv, _ = parse_file(valid)
        w = np.loadtxt(train + ".weight")
        print(f"{tag} façades: wrote {len(y)} x 28 rows ({size / 1e6:.1f} MB of TSV, "
              f"%.9g) in {report['write_s']:.1f} s; native parse {report['parse_s']:.3f} s "
              f"({size / 1e6 / report['parse_s']:.0f} MB/s); the first {n_check} rows "
              f"exactly equal to np.genfromtxt's")

        # 2. train from text through the CLI, on the card (no device_type)
        model1, model2 = os.path.join(tmp, "m1.txt"), os.path.join(tmp, "m2.txt")
        train_kw = dict(objective="binary", num_leaves=255, max_bin=255, learning_rate=0.1,
                        num_iterations=FACADE_ROUNDS, metric="auc", verbosity=-1)
        args = _cli_args("train", data=train, valid=valid, output_model=model1,
                         save_binary="true", **train_kw)
        before = _counts(libs)
        per, first, wall = _timed_cli(cli, args)
        _moved(libs, before, FACADE_WAVE + ("predict_forest_raw",), "cli train")
        report["cli_s_iter"], report["cli_first_s"], report["cli_wall_s"] = per, first, wall
        text = open(model1).read()
        print(f"{tag} façades: cli train from text ({FACADE_ROUNDS} rounds, save_binary): "
              f"{wall:.2f} s (parse, binning, cache, training); s/iteration first "
              f"{first:.3f}, mean of the rest {per:.4f}")

        # 3. train from the cache: the same model (the data= line apart)
        args2 = _cli_args("train", data=train + ".bin", valid=valid, output_model=model2,
                          **train_kw)
        per2, first2, wall2 = _timed_cli(cli, args2)
        report["bin_s_iter"], report["bin_wall_s"] = per2, wall2
        check(open(model2).read() == text.replace(f"[data: {train}]", f"[data: {train}.bin]"),
              "façades: the model trained from the .bin cache differs from the text's")
        params = key_alias_transform(kv2map(args))
        params.pop("task")
        ds = lt.Dataset(X, label=y, weight=w)
        engine = lt.train(params, ds, num_boost_round=FACADE_ROUNDS,
                          valid_sets=[lt.Dataset(Xv, label=yv, reference=ds)],
                          valid_names=["valid_1"])
        check(engine.model_to_string() == text,
              "façades: the cli model differs from engine.train's on the parsed arrays")
        print(f"{tag} façades: cli train from {os.path.basename(train)}.bin: {wall2:.2f} s; "
              f"s/iteration first {first2:.3f}, mean of the rest {per2:.4f}; model text "
              f"byte-equal to the text run's and to engine.train on the parsed arrays")

        # 4. predict: the output file as Booster.predict formats it
        bst = lt.Booster(model_file=model1)
        out = os.path.join(tmp, "pred.txt")
        before = _counts(libs)
        check(cli.run(_cli_args("predict", data=valid, input_model=model1,
                                output_result=out, verbosity=-1)) == 0,
              "façades: cli predict failed")
        _moved(libs, before, ("predict_forest_raw",), "cli predict")
        want = os.path.join(tmp, "want.txt")
        prob = bst.predict(Xv)
        np.savetxt(want, prob, fmt="%.9g", delimiter="\n")
        check(open(out).read() == open(want).read(),
              "façades: cli predict's file differs from Booster.predict's values")
        valid_auc = host_auc(yv, prob)

        # 5. convert: the generated C++ compiled with g++, 4,096 rows
        cpp, so = os.path.join(tmp, "model.cpp"), os.path.join(tmp, "model.so")
        check(cli.run(_cli_args("convert_model", input_model=model1, convert_model=cpp,
                                verbosity=-1)) == 0, "façades: cli convert_model failed")
        t0 = time.perf_counter()
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", so, cpp], check=True,
                       capture_output=True)
        report["convert_compile_s"] = time.perf_counter() - t0
        native = ctypes.CDLL(so)
        rows = np.ascontiguousarray(Xv[:CONVERT_ROWS])
        got, buf = np.empty(CONVERT_ROWS), np.empty(1)
        ptr = ctypes.POINTER(ctypes.c_double)
        for i in range(CONVERT_ROWS):
            native.Predict(rows[i].ctypes.data_as(ptr), buf.ctypes.data_as(ptr))
            got[i] = buf[0]
        err = float(np.max(np.abs(got - prob[:CONVERT_ROWS])))
        check(bool(np.allclose(got, prob[:CONVERT_ROWS], rtol=1e-5, atol=1e-7)),
              f"façades: convert_model's C++ predicts {err:g} from Booster.predict")

        # 6. refit on the valid file: Booster.refit byte for byte, leaf mode
        refit_out = os.path.join(tmp, "refit.txt")
        refit_args = _cli_args("refit", data=valid, input_model=model1,
                               output_model=refit_out, verbosity=-1)
        before = _counts(libs)
        t0 = time.perf_counter()
        check(cli.run(refit_args) == 0, "façades: cli refit failed")
        report["refit_s"] = time.perf_counter() - t0
        _moved(libs, before, ("predict_forest_leaf",), "cli refit")
        rparams = key_alias_transform(kv2map(refit_args))
        rparams.pop("task")
        refit = lt.Booster(model_file=model1, params=rparams).refit(Xv, yv, params=rparams)
        check(open(refit_out).read() == refit.model_to_string(),
              "façades: cli refit differs from Booster.refit")

        # 7. SHAP on the host against the card's raw score
        t0 = time.perf_counter()
        contrib = bst.predict(Xv[:SHAP_ROWS], pred_contrib=True)
        report["shap_s"] = time.perf_counter() - t0
        raw = bst.predict(Xv[:SHAP_ROWS], raw_score=True)
        gap = float(np.max(np.abs(contrib.sum(axis=1) - raw)))
        check(contrib.shape == (SHAP_ROWS, 29)
              and bool(np.allclose(contrib.sum(axis=1), raw, rtol=1e-5, atol=1e-6)),
              f"façades: SHAP rows sum {gap:g} away from the raw score")
        print(f"{tag} façades: predict file bit-equal to Booster.predict (valid AUC "
              f"{valid_auc:.5f}); convert_model compiled in {report['convert_compile_s']:.1f} "
              f"s, {CONVERT_ROWS} rows within {err:.2e} of Booster.predict; refit of "
              f"{len(yv)} rows {report['refit_s']:.2f} s, byte-equal to Booster.refit; "
              f"SHAP of {SHAP_ROWS} rows x {len(bst._gbdt.models)} trees "
              f"{report['shap_s']:.2f} s on the host, sums within {gap:.2e} of the card's "
              f"raw score")

        # 8. the C API in this process through ctypes
        lib = capi.load()
        dsh, bsh, fin = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int()

        def ok(rc, what):
            check(rc == 0, f"façades: C API {what}: {lib.LGBM_GetLastError().decode()}")

        before = _counts(libs)
        t0 = time.perf_counter()
        ok(lib.LGBM_DatasetCreateFromFile((train + ".bin").encode(), b"", None,
                                          ctypes.byref(dsh)), "DatasetCreateFromFile")
        booster_params = " ".join(f"{k}={v}" for k, v in train_kw.items()).encode()
        ok(lib.LGBM_BoosterCreate(dsh, booster_params, ctypes.byref(bsh)), "BoosterCreate")
        t1 = time.perf_counter()
        for _ in range(CAPI_ROUNDS):
            ok(lib.LGBM_BoosterUpdateOneIter(bsh, ctypes.byref(fin)), "UpdateOneIter")
        report["capi_train_s"] = time.perf_counter() - t1
        report["capi_create_s"] = t1 - t0
        _moved(libs, before, FACADE_WAVE, "C API UpdateOneIter")
        n_out = ctypes.c_int64()
        size = ctypes.c_int64()
        ok(lib.LGBM_BoosterSaveModelToString(bsh, 0, -1, 0, 0, ctypes.byref(size), None),
           "SaveModelToString")
        sbuf = ctypes.create_string_buffer(size.value)
        ok(lib.LGBM_BoosterSaveModelToString(bsh, 0, -1, 0, size.value, ctypes.byref(size),
                                             sbuf), "SaveModelToString")
        capi_model = lt.Booster(model_str=sbuf.value.decode())
        Xc = np.ascontiguousarray(Xv)
        mat = np.empty(len(yv))
        ok(lib.LGBM_BoosterPredictForMat(bsh, Xc.ctypes.data, 1, Xc.shape[0], 28, 1, 0, 0,
                                         -1, b"", ctypes.byref(n_out),
                                         mat.ctypes.data_as(ptr)), "PredictForMat")
        want_c = capi_model.predict(Xv)
        check(bool(np.array_equal(mat, want_c)),
              "façades: C API PredictForMat differs from Booster.predict")
        rows_i, cols_i = np.nonzero(Xc)
        values = np.ascontiguousarray(Xc[rows_i, cols_i])
        indices = np.ascontiguousarray(cols_i, dtype=np.int32)
        indptr = np.concatenate([[0], np.cumsum(np.bincount(rows_i, minlength=len(yv)))])
        csr = np.empty(len(yv))
        ok(lib.LGBM_BoosterPredictForCSR(bsh, indptr.ctypes.data, 3, indices.ctypes.data,
                                         values.ctypes.data, 1, indptr.size, values.size, 28,
                                         0, 0, -1, b"", ctypes.byref(n_out),
                                         csr.ctypes.data_as(ptr)), "PredictForCSR")
        check(bool(np.array_equal(csr, want_c)),
              "façades: C API PredictForCSR differs from Booster.predict")
        saved = os.path.join(tmp, "capi_model.txt")
        ok(lib.LGBM_BoosterSaveModel(bsh, 0, -1, 0, saved.encode()), "SaveModel")
        nit, bsh2 = ctypes.c_int(), ctypes.c_void_p()
        ok(lib.LGBM_BoosterCreateFromModelfile(saved.encode(), ctypes.byref(nit),
                                               ctypes.byref(bsh2)), "CreateFromModelfile")
        again = np.empty(len(yv))
        ok(lib.LGBM_BoosterPredictForMat(bsh2, Xc.ctypes.data, 1, Xc.shape[0], 28, 1, 0, 0,
                                         -1, b"", ctypes.byref(n_out),
                                         again.ctypes.data_as(ptr)), "PredictForMat")
        check(nit.value == CAPI_ROUNDS and bool(np.array_equal(again, mat)),
              "façades: the C API's model file does not round-trip")
        for h in (bsh, bsh2):
            ok(lib.LGBM_BoosterFree(h), "BoosterFree")
        ok(lib.LGBM_DatasetFree(dsh), "DatasetFree")
        check(not impl._handles, "façades: the C API kept a freed handle")
        print(f"{tag} façades: C API DatasetCreateFromFile(.bin) + BoosterCreate "
              f"{report['capi_create_s']:.2f} s, {CAPI_ROUNDS} UpdateOneIter "
              f"{report['capi_train_s']:.3f} s on the card; PredictForMat and PredictForCSR "
              f"of {len(yv)} rows bit-equal to Booster.predict; the model file round-trips")

    # 9. fault 9: a feval on the valid set reaches record_evaluation
    def mean_score(preds, data):
        return "mean_score", float(np.mean(preds)), True

    evals = {}
    small = lt.Dataset(Xv, label=yv)
    fb = lt.train({"objective": "binary", "num_leaves": 255, "verbosity": -1}, small,
                  num_boost_round=3, valid_sets=[small.create_valid(X[:16_384], label=y[:16_384])],
                  valid_names=["v"], feval=mean_score,
                  callbacks=[lt.record_evaluation(evals)])
    got_mean = evals.get("v", {}).get("mean_score", [])
    want_mean = float(np.mean(fb.predict(X[:16_384], raw_score=True)))
    check(len(got_mean) == 3 and abs(got_mean[-1] - want_mean) <= 1e-6 * max(1, abs(want_mean)),
          f"façades: the feval on the valid set recorded {got_mean}, want {want_mean}")
    launches = _counts(libs)
    report["seconds"] = time.perf_counter() - t_phase
    print(f"{tag} façades: feval on the valid set recorded {len(got_mean)} rounds "
          f"(last {got_mean[-1]:.6f})")
    print(f"façades path launches: {launches}")
    print(f"{tag} phase 19: {report['seconds']:.1f} s")
    return launches, report


STREAM_BLOCK_ROWS = 65_536  # phase 20: 16 blocks of phase 8's 1,048,576 rows
STREAM_BUDGET_BLOCKS = 4  # a quarter of the plane on the card
STREAM_CSR_BLOCK = 5  # the block pushed through push_csr
STREAM_QUANT_ROUNDS = 3
# the float streamed run's rounds, held to phase 9's first trees (10, the
# serial run's, until phase 22 came)
STREAM_ROUNDS = 4
STREAM_GANG_ROUNDS = 3  # phase 22 (e)'s float rounds, held to phase 20's first trees
STREAM_SERIAL = ("histogram_carry", "find_best_split", "row_partition_decide",
                 "row_partition_scatter")
STREAM_QUANT = ("histogram_carry_i32", "find_best_split_int", "quantize_reduce", "quantize",
                "row_partition_decide", "row_partition_scatter")
FLY_ROWS, FLY_PUSH_ROWS = 262_144, 65_536  # a generation's fresh rows, a push
FLY_ROUNDS, FLY_HOLDOUT, FLY_CLIENTS = 10, 16_384, 4
FLY_SHIFT_FEATURE = 8  # a normal column, shifted out of its bins during generation 1's rows
FLY_KILL_AT = 5
FLY_STEADY_S = 1.0  # seconds the service answers alone before and after
CAPI_STREAM_PUSHES = 4  # dense pushes of FLY_PUSH_ROWS, then one CSR push


def _csr_of(M):
    """CSR arrays (int64 indptr, int32 indices, float64 values) of M's
    nonzero entries."""
    mask = M != 0
    indptr = np.concatenate([[0], np.cumsum(mask.sum(axis=1))]).astype(np.int64)
    return indptr, np.nonzero(mask)[1].astype(np.int32), M[mask].astype(np.float64)


def _stream_env(budget=None, block_rows=None):
    """Set (or, with None, clear) the streamed learner's two variables."""
    from lightgbm_tpu_torch.streaming.learner import BLOCK_ROWS_ENV, BUDGET_ENV

    for name, value in ((BUDGET_ENV, budget), (BLOCK_ROWS_ENV, block_rows)):
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = str(value)


def check_carried_histogram(dev, bins_h, n_rows, num_bins, seed, tag):
    """The leaf histogram's carried mode over the 16 blocks of phase 8's
    plane, at the root, a ~100,000-row and a ~4,000-row leaf: bit-equal to
    one resident call over all the leaf's rows and to the plain fixed-point
    emulation run on the CPU; the integer mode at the root likewise. Its
    time a leaf (every block's launch, CUDA events) and a block, beside its
    bound, the plain version's time on the card and index_add_'s. Returns
    the two JSON entries."""
    from lightgbm_tpu_torch.ops import hist_cuda
    from lightgbm_tpu_torch.ops.histogram import (_build_histogram_rows_fixed,
                                                  _build_histogram_rows_plain,
                                                  fixed_point_exponents)
    from lightgbm_tpu_torch.streaming.learner import block_runs

    rng = np.random.RandomState(seed)
    G = bins_h.shape[0]
    bins_cpu = torch.from_numpy(bins_h)
    bins = bins_cpu.to(dev)
    blocks = [bins[:, lo:lo + STREAM_BLOCK_ROWS].contiguous()
              for lo in range(0, n_rows, STREAM_BLOCK_ROWS)]
    gh, _, q = leaf_gradients(rng, n_rows, dev)
    exps = fixed_point_exponents(gh, n_rows)
    sets = leaf_sets(rng, n_rows, dev)
    out_bytes = G * num_bins * 3 * 4

    def carried(values, idx, count, e):
        rows = idx[:count]
        runs = block_runs(rows, STREAM_BLOCK_ROWS)
        carry = hist_cuda.HistogramCarry()
        out = None
        for i, (b, s, t) in enumerate(runs):
            lo = b * STREAM_BLOCK_ROWS
            out = hist_cuda.histogram(blocks[b], values[lo:lo + STREAM_BLOCK_ROWS],
                                      (rows[s:t] - lo).to(torch.int32), num_bins, count=t - s,
                                      exponents=e, carry=carry, last=i + 1 == len(runs))
        return out, len(runs)

    entries, err = {}, 0.0
    for name in ("root", "leaf", "small"):
        idx, count = sets[name]
        got, n_runs = carried(gh, idx, count, exps)
        one = hist_cuda.histogram(bins, gh, idx, num_bins, count, exps)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), one.view(torch.int32)),
              f"carried histogram {name}: differs from one resident call")
        fixed = _build_histogram_rows_fixed(bins_cpu, gh.cpu(), idx.cpu(), num_bins,
                                            exps.cpu(), count)
        check(torch.equal(got.cpu().view(torch.int32), fixed.view(torch.int32)),
              f"carried histogram {name}: differs from the plain fixed-point emulation")
        err = max(err, float((got.cpu().double() - fixed.double()).abs().max()))
        ms = cuda_ms(lambda i=idx, c=count: carried(gh, i, c, exps), 10)
        # the kernel's own device time a leaf (all its blocks' launches)
        dev_ms = kernel_device_ms(lambda i=idx, c=count: carried(gh, i, c, exps), 10,
                                  "hist_rows_kernel")
        plain = cuda_ms(lambda i=idx, c=count: _build_histogram_rows_fixed(
            bins, gh, i, num_bins, exps, c), 3)
        b, by = bound(perfmodel.hist_rows(count, G, out_bytes))
        resident = cuda_ms(lambda i=idx, c=count: hist_cuda.histogram(bins, gh, i, num_bins, c,
                                                                      exps), 10)
        print(f"{tag} histogram_carry {name} ({count} rows over {n_runs} blocks): kernel "
              f"{fmt_ms(dev_ms)} of device time a leaf (torch.profiler), "
              + ("" if dev_ms is None else f"{dev_ms / n_runs:.4f} ms a block; ")
              + f"{ms:.4f} ms a leaf of CUDA events with the host's run table, one resident "
              f"call {resident:.4f} ms; plain {plain:.3f} ms, bound {b:.4f} ms ({by})")
        if name == "root":
            library = index_add_ms(bins, gh, idx[:count], None, 1, num_bins, got)
            entries["histogram_carry"] = {
                "name": "histogram_carry", "route": "cuda",
                "source": "lightgbm_tpu_torch/csrc/histogram.cu",
                "replaces": "lightgbm_tpu/ops/hist_pallas.py:132",
                "max_abs_err": err, "ms": ms if dev_ms is None else dev_ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": library}
    # the gang-sharded streamed learner's use: each of two ranks carries its
    # own blocks (b % 2) with the carry left open, the int64 images are
    # added, and one conversion gives one resident call's bits
    from lightgbm_tpu_torch.ops.histogram import HistImage, image_to_float

    for name in ("root", "leaf"):
        idx, count = sets[name]
        rows = idx[:count]
        images = []
        for rank in range(2):
            carry, img = hist_cuda.HistogramCarry(), None
            mine = [r for r in block_runs(rows, STREAM_BLOCK_ROWS) if r[0] % 2 == rank]
            for i, (b, s, t) in enumerate(mine):
                lo = b * STREAM_BLOCK_ROWS
                img = hist_cuda.histogram(blocks[b], gh[lo:lo + STREAM_BLOCK_ROWS],
                                          (rows[s:t] - lo).to(torch.int32), num_bins,
                                          count=t - s, exponents=exps, carry=carry,
                                          last=i + 1 == len(mine), image=True)
            images.append(img)
        summed = HistImage(images[0].sums + images[1].sums, images[0].flags | images[1].flags)
        got = image_to_float(summed, exps)
        one = hist_cuda.histogram(bins, gh, idx, num_bins, count, exps)
        check(torch.equal(got.view(torch.int32), one.view(torch.int32)),
              f"carried histogram {name}, two open carries added: differs from one resident "
              "call")
    idx, count = sets["root"]
    got, n_runs = carried(q, idx, count, None)
    plain_q = _build_histogram_rows_plain(bins_cpu, q.cpu(), idx.cpu(), num_bins, count)
    check(torch.equal(got.cpu(), plain_q),
          "carried histogram, integer mode: differs from the plain version")
    check(torch.equal(got, hist_cuda.histogram(bins, q, idx, num_bins, count)),
          "carried histogram, integer mode: differs from one resident call")
    ms_q = cuda_ms(lambda: carried(q, idx, count, None), 10)
    dev_q = kernel_device_ms(lambda: carried(q, idx, count, None), 10, "hist_rows_kernel")
    plain_q_ms = cuda_ms(lambda: _build_histogram_rows_plain(bins, q, idx, num_bins, count), 3)
    b_q, by_q = bound(perfmodel.hist_rows(count, G, out_bytes))
    library_q = index_add_ms(bins, q, idx[:count], None, 1, num_bins, got)
    print(f"{tag} histogram_carry_i32 root ({count} rows over {n_runs} blocks): kernel "
          f"{fmt_ms(dev_q)} of device time a leaf (torch.profiler), {ms_q:.4f} ms a leaf of "
          f"CUDA events with the host's run table; plain {plain_q_ms:.3f} ms, int32 "
          f"index_add_ {library_q:.4f} ms (equal), bound {b_q:.4f} ms ({by_q})")
    entries["histogram_carry_i32"] = {
        "name": "histogram_carry_i32", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/histogram.cu",
        "replaces": "lightgbm_tpu/ops/hist_pallas.py:132", "max_abs_err": 0.0,
        "ms": ms_q if dev_q is None else dev_q,
        "plain_ms": plain_q_ms, "bound_ms": b_q, "bound_by": by_q, "library_ms": library_q}
    print(f"kernels: histogram_carry over {len(blocks)} blocks of {STREAM_BLOCK_ROWS} rows at "
          f"the root, a {LEAF_ROWS}- and a {SMALL_LEAF_ROWS}-row leaf: bit-equal to one "
          f"resident call and to the plain fixed-point emulation (max |d| {err}); two "
          f"open carries over alternate blocks, images added and converted once, bit-equal "
          f"to one resident call (root, leaf); the integer mode at the root exactly equal")
    del bins, blocks, gh, q
    torch.cuda.empty_cache()
    return entries


def _stream_run(lt, libs, params, train_set, rounds, required, label, tag):
    """lt.train under the streamed learner's budget, its launch counts set to
    0 just before and read just after; returns (booster, launches,
    s/iteration after the first, first, wall, stream counters)."""
    from lightgbm_tpu_torch.streaming import StreamedTreeLearner
    from lightgbm_tpu_torch.utils.timer import global_timer

    for lib in libs:
        lib.reset_launches()
    before = dict(global_timer.counters)
    bst, steady, first, wall, _ = _timed_run(lt, params, train_set, None, rounds)
    torch.cuda.synchronize()
    launches = _counts(libs)
    learner = bst._gbdt.tree_learner
    check(isinstance(learner, StreamedTreeLearner) and learner.bins_dev is None,
          f"stream ({label}): LGBM_TPU_HBM_BUDGET did not route to the streamed learner")
    for name in required:
        check(launches[name] > 0, f"stream path ({label}): kernel {name} never launched")
    moved = {k: v - before.get(k, 0) for k, v in global_timer.counters.items()
             if k.startswith("stream_")}
    return bst, launches, steady, first, wall, moved


def drive_stream(lt, libs, X_train, y_train, train_set, serial, seed, tag):
    """Phase 20: single-card streaming on phase 8's rows. Returns (the launch
    counts of its main paths, the carried mode's JSON entries)."""
    import ctypes

    from lightgbm_tpu_torch import capi, perfmodel as pm
    from lightgbm_tpu_torch.checkpoint import read_sidecar_manifest
    from lightgbm_tpu_torch.serving import PredictionService, serve, wire
    from lightgbm_tpu_torch.streaming import ContinuousTrainer, RowBlockStore
    from lightgbm_tpu_torch.utils import faults
    from lightgbm_tpu_torch.utils.timer import global_timer

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    n = X_train.shape[0]
    n_blocks = n // STREAM_BLOCK_ROWS
    paths = {}

    # ---- 1. ingest: 16 pushes, one of them CSR
    t = time.perf_counter()
    store = RowBlockStore(params={"max_bin": TRAIN_PARAMS["max_bin"], "verbosity": -1})
    for b in range(n_blocks):
        lo, hi = b * STREAM_BLOCK_ROWS, (b + 1) * STREAM_BLOCK_ROWS
        if b == STREAM_CSR_BLOCK:
            store.push_csr(*_csr_of(X_train[lo:hi]), X_train.shape[1], label=y_train[lo:hi])
        else:
            store.push_rows(X_train[lo:hi], label=y_train[lo:hi])
    pushed = store.finalize()
    ingest_s = time.perf_counter() - t
    t = time.perf_counter()
    whole = store._layout._bin_rows(X_train)
    check(np.array_equal(pushed.bins, whole),
          "stream: the pushed plane differs from the whole matrix binned under its layout")
    check(np.array_equal(pushed.metadata.label, y_train), "stream: the pushed labels differ")
    print(f"{tag} stream ingest: {n} x {X_train.shape[1]} rows in {n_blocks} pushes of "
          f"{STREAM_BLOCK_ROWS} (block {STREAM_CSR_BLOCK} through push_csr), layout fitted on "
          f"the first {min(store.bin_sample_rows, n)} rows: {ingest_s:.2f} s ({n / ingest_s:,.0f} "
          f"rows/s) with finalize; the plane ({pushed.bins.shape[0]} groups) byte-equal to "
          f"the matrix binned whole under the same layout ({time.perf_counter() - t:.2f} s)")
    del store, pushed, whole

    # ---- 2. the streamed learner at phase 9's settings, a quarter of the plane cached
    core = train_set._handle
    G = core.bins.shape[0]
    block_bytes = pm.stream_block_bytes(STREAM_BLOCK_ROWS, G, core.bins.dtype.itemsize)
    budget = STREAM_BUDGET_BLOCKS * block_bytes
    _stream_env(budget, STREAM_BLOCK_ROWS)
    try:
        bst, launches, steady, first, wall, moved = _stream_run(
            lt, libs, TRAIN_PARAMS, train_set, STREAM_ROUNDS, STREAM_SERIAL, "float", tag)
        paths["stream"] = launches
        learner = bst._gbdt.tree_learner
        cache = learner._cache
        check(first_trees(bst.model_to_string(), STREAM_ROUNDS)
              == first_trees(serial["booster"].model_to_string(), STREAM_ROUNDS),
              "stream: the streamed model's trees differ from phase 9's resident serial model's")
        check(cache.capacity == STREAM_BUDGET_BLOCKS and cache.peak <= cache.capacity,
              f"stream: the cache held {cache.peak} blocks under a budget of {cache.capacity}")
        h2d_s = learner.h2d_seconds()
        h2d_bytes = moved.get("stream_h2d_bytes", 0)
        uploads, rows_up = moved.get("stream_h2d_blocks", 0), moved.get("stream_h2d_rows", 0)
        check(h2d_bytes == uploads * block_bytes + rows_up * n,
              f"stream: {h2d_bytes} bytes uploaded for {uploads} blocks and {rows_up} group "
              f"rows")
        h2d_bound = pm.h2d_bound_ms(h2d_bytes, CARD_KIND)
        s9 = serial["per_iter"]
        print(f"{tag} stream train (serial lane, budget {budget} B = {STREAM_BUDGET_BLOCKS} "
              f"blocks of {block_bytes} B, plane {core.bins.nbytes} B in {cache.n_blocks} "
              f"blocks): {STREAM_ROUNDS} rounds in {wall:.2f} s; s/iteration first {first:.3f}, "
              f"mean of the rest {steady:.3f} (phase 9 resident: first {s9[0]:.3f}, rest "
              f"{float(np.mean(s9[1:])):.3f}); its trees byte-equal to phase 9's first; the plane "
              f"pinned in {cache.pin_s:.3f} s")
        print(f"{tag} stream uploads: {uploads} blocks ({moved.get('stream_h2d_cold', 0)} cold, "
              f"{moved.get('stream_h2d_prefetched', 0)} prefetched, "
              f"{moved.get('stream_cache_hits', 0)} cache hits) and {rows_up} group rows, "
              f"{h2d_bytes} B = {uploads} x stream_block_bytes + {rows_up} x {n}; copy-stream "
              f"time {h2d_s:.3f} s against the host link's bound {h2d_bound / 1e3:.3f} s "
              f"({h2d_bytes / max(h2d_s, 1e-9) / 1e9:.2f} GB/s); cache peak {cache.peak} of "
              f"{cache.capacity} blocks; leaf histograms "
              f"{moved.get('stream_leaf_histograms', 0)}, carried-mode launches "
              f"{launches['histogram_carry']} ({launches['histogram_carry'] / STREAM_ROUNDS:.1f} "
              f"a tree)")
        _busy(bst, tag, "stream (serial lane)")
        del bst, learner, cache
        # quantized: the resident serial learner, then the streamed one
        qparams = {**TRAIN_PARAMS, **QUANT_PARAMS}
        _stream_env(None)
        resident_q, _, _, _, _ = _timed_run(lt, qparams, train_set, None, STREAM_QUANT_ROUNDS)
        _stream_env(budget, STREAM_BLOCK_ROWS)
        bst_q, launches_q, steady_q, first_q, _, _ = _stream_run(
            lt, libs, qparams, train_set, STREAM_QUANT_ROUNDS, STREAM_QUANT, "quantized", tag)
        paths["stream_quantized"] = launches_q
        check(bst_q.model_to_string() == resident_q.model_to_string(),
              "stream (quantized): the model text differs from the resident serial learner's")
        PHASE_MODELS["stream_quantized"] = bst_q.model_to_string()
        print(f"{tag} stream train (quantized, serial lane): {STREAM_QUANT_ROUNDS} rounds, "
              f"s/iteration first {first_q:.3f}, rest {steady_q:.3f}; model text byte-equal to "
              f"the resident serial learner's; carried integer-mode launches "
              f"{launches_q['histogram_carry_i32']}")
        del bst_q, resident_q
    finally:
        _stream_env(None)
    torch.cuda.empty_cache()

    # ---- 3. the carried mode against its plain version
    entries = check_carried_histogram(dev, core.bins, n, int(core.group_bin_counts().max()),
                                      seed + 40, tag)
    entries["histogram_carry"]["launches"] = paths["stream"]["histogram_carry"]
    entries["histogram_carry_i32"]["launches"] = paths["stream_quantized"]["histogram_carry_i32"]

    # ---- 4. the flywheel: three generations under live traffic
    X_fly, y_fly = higgs_rows(seed + 41, 3 * FLY_ROWS)
    X_req = make_rows_like(X_fly, seed + 42)
    shift_at = FLY_ROWS + FLY_ROWS // 2
    drift_plan = f"drift_shift@{shift_at}:{FLY_SHIFT_FEATURE}"
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_stream_")
    os.environ["LGBM_TPU_DRIFT"] = "1"
    faults.install(drift_plan)
    svc = PredictionService(max_batch_rows=4096, min_bucket=64, batch_window_s=0.001)
    server, server_thread = serve(svc, port=0)
    base = f"http://127.0.0.1:{server.port}"
    for lib in libs:
        lib.reset_launches()
    answers, failures, done = [], [], threading.Event()
    # each request's latency, by whether a model trained in this process
    # when it was sent (training set) or not
    training, latency = threading.Event(), {"steady": [], "training": []}
    try:
        svc.load_model("live", booster=serial["booster"])
        published = [serial["booster"]]
        fly = RowBlockStore(params={"max_bin": TRAIN_PARAMS["max_bin"], "verbosity": -1})
        params = dict(WAVE_PARAMS)
        trainer = ContinuousTrainer(params, fly, num_boost_round=FLY_ROUNDS, service=svc,
                                    model_name="live", holdout_rows=FLY_HOLDOUT,
                                    checkpoint_dir=os.path.join(tmp.name, "live"))
        clean = ContinuousTrainer(params, fly, num_boost_round=FLY_ROUNDS,
                                  holdout_rows=FLY_HOLDOUT,
                                  checkpoint_dir=os.path.join(tmp.name, "clean"))

        def client(worker):
            i = worker
            while not done.is_set():
                k = i % (len(X_req) // SERVE_ROWS)
                raw = i % 3 == 0
                body = wire.encode_request("live", X_req[k * SERVE_ROWS:(k + 1) * SERVE_ROWS],
                                           raw)
                during = training.is_set()
                t_req = time.perf_counter()
                try:
                    _, payload = _http(base, "/predict", body, wire.CONTENT_TYPE)
                    answers.append((k, raw, wire.decode_response(payload)[0]))
                    latency["training" if during or training.is_set() else "steady"].append(
                        time.perf_counter() - t_req)
                except Exception as exc:  # noqa: BLE001 - reported below
                    failures.append(f"request {i}: {exc!r}")
                i += FLY_CLIENTS

        clients = [threading.Thread(target=client, args=(w,)) for w in range(FLY_CLIENTS)]
        for th in clients:
            th.start()
        walls = {}
        time.sleep(FLY_STEADY_S)  # the service alone: its steady latency

        def push(gen):
            for lo in range(gen * FLY_ROWS, (gen + 1) * FLY_ROWS, FLY_PUSH_ROWS):
                fly.push_rows(X_fly[lo:lo + FLY_PUSH_ROWS], label=y_fly[lo:lo + FLY_PUSH_ROWS])

        training.set()
        push(0)
        t = time.perf_counter()
        published.append(trainer.step())
        walls["gen0"] = time.perf_counter() - t
        clean.step()
        push(1)
        check(fly._drift.alarmed and fly._drift.alarm_feature == FLY_SHIFT_FEATURE,
              f"flywheel: drift_shift on feature {FLY_SHIFT_FEATURE} did not latch the alarm")
        psi = global_timer.counters.get("drift_psi_milli_max", 0) / 1e3
        faults.install(f"{drift_plan},kill@{FLY_KILL_AT}")
        try:
            trainer.step()
            check(False, "flywheel: kill@ did not stop generation 1")
        except faults.InjectedFault:
            pass
        check(fly.layout_generation == 1 and not fly._drift.alarmed,
              "flywheel: the generation boundary after the alarm did not refresh the bins")
        faults.install(drift_plan)
        t = time.perf_counter()
        resumed = trainer.step()
        walls["gen1_resume"] = time.perf_counter() - t
        published.append(resumed)
        uninterrupted = clean.step()
        check(resumed.model_to_string() == uninterrupted.model_to_string(),
              "flywheel: generation 1 resumed after kill@ differs from the uninterrupted run")
        manifest = read_sidecar_manifest(trainer.checkpoint_path(1))
        check(manifest["stream_generation"] == 1 and manifest["bin_mapper_generation"] == 1,
              f"flywheel: generation 1's sidecar says {manifest.get('stream_generation')} / "
              f"{manifest.get('bin_mapper_generation')}")
        push(2)
        faults.install(f"{drift_plan},bad_generation@2")
        rejected_before = global_timer.counters.get("stream_generation_rejected", 0)
        check(trainer.step() is None and svc.registry.get("live").version == 3,
              "flywheel: the poisoned generation 2 was published")
        check(global_timer.counters["stream_generation_rejected"] == rejected_before + 1,
              "flywheel: the holdout gate did not count the rejection")
        faults.install(drift_plan)
        t = time.perf_counter()
        published.append(trainer.step())
        walls["gen2_retry"] = time.perf_counter() - t
        check(published[-1] is not None and svc.registry.get("live").version == 4,
              "flywheel: generation 2's retry was not published")
        training.clear()
        time.sleep(FLY_STEADY_S)  # the last version answers a while, alone
        done.set()
        for th in clients:
            th.join(timeout=120)
        check(not any(th.is_alive() for th in clients), "flywheel: clients hung")
        _, statz = _http(base, "/statz")
        drift_stats = json.loads(statz)["drift"]
        check(drift_stats.get("enabled") is True, f"flywheel: /statz drift is {drift_stats}")
    finally:
        done.set()
        faults.clear()
        os.environ.pop("LGBM_TPU_DRIFT", None)
        server.shutdown()
        server.server_close()
        svc.close()
        server_thread.join(timeout=10)
        tmp.cleanup()
    check(not failures, "flywheel: " + "; ".join(failures[:5]))
    wants = {}
    for g, b in enumerate(published):
        for raw in (False, True):
            wants[(g, raw)] = b.predict(X_req, raw_score=raw)
    served = [0] * len(published)
    for k, raw, preds in answers:
        rows = slice(k * SERVE_ROWS, (k + 1) * SERVE_ROWS)
        hit = [g for g in range(len(published))
               if np.array_equal(preds, wants[(g, raw)][rows])]
        check(bool(hit), f"flywheel: an answer equals no published generation's prediction")
        served[hit[-1]] += 1
    check(all(latency.values()), f"flywheel: a latency window saw no request "
          f"({ {k: len(v) for k, v in latency.items()} })")
    pct = {k: (1e3 * np.percentile(v, 50), 1e3 * np.percentile(v, 99), len(v))
           for k, v in latency.items()}
    paths["flywheel"] = _counts(libs)
    for name in FACADE_WAVE + ("predict_forest_raw",):
        check(paths["flywheel"][name] > 0, f"flywheel path: kernel {name} never launched")
    print(f"{tag} flywheel: 3 generations of {FLY_ROWS} rows ({FLY_ROUNDS} wave rounds each, "
          f"{FLY_HOLDOUT}-row holdout) under {FLY_CLIENTS} clients of {SERVE_ROWS}-row "
          f"binary-wire requests: {len(answers)} answered, 0 failed, every answer bit-equal "
          f"to a published generation's Booster.predict (answers by version "
          f"{served}); generation 0 {walls['gen0']:.2f} s, generation 1 killed at "
          f"iteration {FLY_KILL_AT} and resumed in {walls['gen1_resume']:.2f} s byte-equal "
          f"to the uninterrupted run; drift on feature {FLY_SHIFT_FEATURE} (PSI {psi:.3f}) "
          f"latched, the next boundary refreshed the bins (layout_generation 1, the "
          f"sidecar's bin_mapper_generation 1); bad_generation@2 rejected by the holdout "
          f"gate and never served, its retry published in {walls['gen2_retry']:.2f} s; "
          f"/statz drift max_psi {drift_stats.get('max_psi')}; request latency (host "
          f"clock, HTTP round trip) with the service alone p50 {pct['steady'][0]:.3f} ms, "
          f"p99 {pct['steady'][1]:.3f} ms ({pct['steady'][2]} requests), while the "
          f"generations pushed and trained p50 {pct['training'][0]:.3f} ms, p99 "
          f"{pct['training'][1]:.3f} ms ({pct['training'][2]} requests)")

    # ---- 5. the C API's streaming handles through ctypes
    rows = (CAPI_STREAM_PUSHES + 1) * FLY_PUSH_ROWS
    Xc, yc = X_fly[:rows], np.ascontiguousarray(y_fly[:rows], dtype=np.float32)
    param_text = " ".join(f"{k}={v}" for k, v in WAVE_PARAMS.items()) + \
        f" num_iterations={CAPI_ROUNDS}"
    lib = capi.load()

    def ok(rc, what):
        check(rc == 0, f"stream C API {what}: {lib.LGBM_GetLastError().decode()}")

    for h in libs:
        h.reset_launches()
    t = time.perf_counter()
    ds = ctypes.c_void_p()
    ok(lib.LGBM_DatasetCreateStreaming(Xc.shape[1], b"", ctypes.byref(ds)), "CreateStreaming")
    for p in range(CAPI_STREAM_PUSHES):
        block = np.ascontiguousarray(Xc[p * FLY_PUSH_ROWS:(p + 1) * FLY_PUSH_ROWS])
        ok(lib.LGBM_DatasetPushRows(ds, block.ctypes.data, 0, FLY_PUSH_ROWS, Xc.shape[1],
                                    p * FLY_PUSH_ROWS), "PushRows")
    tail = Xc[CAPI_STREAM_PUSHES * FLY_PUSH_ROWS:]
    ip, ix, vals = _csr_of(tail)
    ok(lib.LGBM_DatasetPushRowsByCSR(ds, ip.ctypes.data, 3, ix.ctypes.data, vals.ctypes.data, 1,
                                     len(ip), len(vals), Xc.shape[1],
                                     CAPI_STREAM_PUSHES * FLY_PUSH_ROWS), "PushRowsByCSR")
    ok(lib.LGBM_DatasetSetField(ds, b"label", yc.ctypes.data, len(yc), 0), "SetField")
    bsh = ctypes.c_void_p()
    ok(lib.LGBM_BoosterCreate(ds, param_text.encode(), ctypes.byref(bsh)), "BoosterCreate")
    fin = ctypes.c_int()
    for _ in range(CAPI_ROUNDS):
        ok(lib.LGBM_BoosterUpdateOneIter(bsh, ctypes.byref(fin)), "UpdateOneIter")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capi_") as d:
        saved = os.path.join(d, "model.txt")
        ok(lib.LGBM_BoosterSaveModel(bsh, 0, -1, 0, saved.encode()), "SaveModel")
        with open(saved) as fh:
            capi_text = fh.read()
    capi_s = time.perf_counter() - t
    ok(lib.LGBM_BoosterFree(bsh), "BoosterFree")
    ok(lib.LGBM_DatasetFree(ds), "DatasetFree")
    paths["capi"] = _counts(libs)
    for name in FACADE_WAVE:
        check(paths["capi"][name] > 0, f"stream C API path: kernel {name} never launched")
    direct_store = RowBlockStore(params={})
    for p in range(CAPI_STREAM_PUSHES):
        direct_store.push_rows(np.ascontiguousarray(
            Xc[p * FLY_PUSH_ROWS:(p + 1) * FLY_PUSH_ROWS]))
    direct_store.push_csr(ip, ix, vals, Xc.shape[1])
    direct_store.set_label(yc)
    parsed = dict(tok.split("=", 1) for tok in param_text.split())
    direct = lt.train(parsed, direct_store.to_basic_dataset(params=parsed),
                      num_boost_round=CAPI_ROUNDS)
    check(capi_text == direct.model_to_string(),
          "stream C API: SaveModel differs from engine.train on a RowBlockStore fed the same "
          "blocks")
    print(f"{tag} stream C API: DatasetCreateStreaming, {CAPI_STREAM_PUSHES} PushRows of "
          f"{FLY_PUSH_ROWS} rows (float32) and 1 PushRowsByCSR, BoosterCreate, {CAPI_ROUNDS} "
          f"UpdateOneIter on the card and SaveModel in {capi_s:.2f} s: the model file "
          f"byte-equal to engine.train on a RowBlockStore fed the same blocks")
    print(f"{tag} phase 20 (stream) {time.perf_counter() - t_phase:.1f} s")
    return paths, [entries["histogram_carry"], entries["histogram_carry_i32"]]


def make_rows_like(X, seed):
    """Request rows for the flywheel's clients: SERVE_REQUESTS x SERVE_ROWS
    rows drawn from X."""
    rng = np.random.RandomState(seed)
    return np.ascontiguousarray(X[rng.choice(X.shape[0], SERVE_REQUESTS * SERVE_ROWS,
                                             replace=False)])


def check_booster_surface(lt, booster, tag):
    """After phase 8: dump_model parses, its leaf values and thresholds equal
    the model text's; feature_importance equals the CPU Booster's loaded
    from the same text; the score bounds printed."""
    text = booster.model_to_string()
    dump = json.loads(json.dumps(booster.dump_model()))
    trees = [dict(line.split("=", 1) for line in sec.splitlines() if "=" in line)
             for sec in text.split("Tree=")[1:]]
    check(len(dump["tree_info"]) == len(trees) == booster.num_trees(),
          f"booster surface: {len(dump['tree_info'])} trees dumped for {len(trees)}")
    for info, kv in zip(dump["tree_info"], trees):
        leaves, thresholds = {}, {}
        stack = [info["tree_structure"]]
        while stack:
            node = stack.pop()
            if "leaf_index" in node:
                leaves[node["leaf_index"]] = node["leaf_value"]
            elif "split_index" in node:
                thresholds[node["split_index"]] = node["threshold"]
                stack += [node["left_child"], node["right_child"]]
        want_leaves = [float(v) for v in kv["leaf_value"].split()]
        want_thr = [float(v) for v in kv["threshold"].split()]
        check([leaves[i] for i in range(len(want_leaves))] == want_leaves
              and [thresholds[i] for i in range(len(want_thr))] == want_thr,
              f"booster surface: tree {info['tree_index']}'s dumped leaf values or "
              "thresholds differ from the model text's")
    host = lt.Booster(model_str=text, params={"device_type": "cpu"})
    for kind in ("split", "gain"):
        check(bool(np.array_equal(booster.feature_importance(kind),
                                  host.feature_importance(kind))),
              f"booster surface: feature_importance({kind!r}) differs from the CPU Booster's")
    imp = booster.feature_importance("gain")
    print(f"{tag} booster surface: dump_model of {len(trees)} trees parses, leaf values and "
          f"thresholds equal to the model text's; feature_importance split "
          f"{booster.feature_importance('split').tolist()}, gain (top 3 features "
          f"{np.argsort(-imp)[:3].tolist()}) equal to the CPU Booster's; lower_bound "
          f"{booster.lower_bound():.6f}, upper_bound {booster.upper_bound():.6f}")


def async_schedule_pair(lt, train_set):
    """Phase 11's third pair: 2 x ASYNC_ROUNDS Booster.update() rounds with
    callback.reset_parameter halving the learning rate after ASYNC_ROUNDS,
    the pipeline on and off. Returns (model text, final train score, whether
    a tree was pending at the end) of each."""
    from lightgbm_tpu_torch.callback import CallbackEnv

    rounds = 2 * ASYNC_ROUNDS
    schedule = lt.reset_parameter(learning_rate=[0.125] * ASYNC_ROUNDS
                                  + [0.0625] * ASYNC_ROUNDS)
    out = {}
    for asyn in (True, False):
        params = dict(ASYNC_PARAMS)
        bst = lt.Booster(dict(params), train_set)
        bst._gbdt._async_pipeline = asyn
        for it in range(rounds):
            schedule(CallbackEnv(model=bst, params=params, iteration=it, begin_iteration=0,
                                 end_iteration=rounds, evaluation_result_list=None))
            bst.update()
        pending = bst._gbdt._pending is not None
        out[asyn] = (bst.model_to_string(), bst._gbdt.score.clone(), pending)
    return out


# ------------------------------------------------------------- phase 21
GANG_VOTE_TOP_K = 5  # the narrow voting run: 2 * 5 = 10 of the 28 features elected a leaf
GANG_VOTE_AUC_MARGIN = 0.001  # its valid AUC against the exact run's (JAX test_voting_learner.py:241)
GANG_SHARD_ROWS = 65_536  # pred_shard_rows of the row-sharded predict of the 1M rows
GANG_SERVE_ROWS, GANG_SERVE_SHARD = 32_768, 4_096  # the service's request and shard_rows
GANG_CLI_ROWS, GANG_CLI_ROUNDS = 65_536, 5  # the CLI's text file and rounds
GANG_TIMEOUT_S = 400  # the gang is reaped (and the phase fails) past this
# the host-driven data learner's rounds, held to phase 9's first trees (10,
# phase 9's, until phase 22 came)
GANG_HOST_ROUNDS = 4
GANG_RUNS = (  # (label, tree_learner, params, rounds)
    ("data", "data", "WAVE", "TRAIN"),
    ("feature", "feature", "WAVE", "TRAIN"),
    ("voting", "voting", "WAVE", "TRAIN"),
    ("voting_narrow", "voting", "WAVE", "HALF"),
    ("data_host", "data", "SERIAL", "HOST"),
    ("data_quantized", "data", "QUANT", "TRAIN"),
    # phase 22 (d): the data run again with the elastic runtime's heartbeat
    # every iteration and the sanitizer's collective-order check at each
    ("data_sanitized", "data", "WAVE", "HALF"),
)
# the runs with the elastic heartbeat and the sanitizer, which phase 22 (d) reports
GANG_PHASE22 = ("data_sanitized",)
GANG_REQUIRED = {
    "wave": ("histogram_slots_ragged_image", "histogram_image_to_float", "partition_decide",
             "partition_scan", "partition_scatter", "relabel_rows", "split_scan_batched",
             "wave_select", "wave_replay"),
    "host": ("histogram_image", "histogram_image_to_float", "find_best_split",
             "row_partition_decide", "row_partition_scatter"),
    "quantized": ("histogram_slots_ragged_i32", "split_scan_batched", "quantize_reduce",
                  "quantize", "partition_decide", "wave_select", "wave_replay"),
}
PHASE_MODELS = {}  # phases 8, 9 and 12's model texts as trained, for phase 21


def _gang_params(which, learner, label):
    base = {"WAVE": WAVE_PARAMS, "SERIAL": TRAIN_PARAMS,
            "QUANT": {**WAVE_PARAMS, **QUANT_PARAMS}}[which]
    params = {**base, "tree_learner": learner}
    if learner == "voting":
        params["top_k"] = GANG_VOTE_TOP_K if label == "voting_narrow" else HIGGS["n_features"]
    return params


def _gang_cli_args(tsv, out):
    return [f"data={tsv}", "task=train", "objective=binary", "tree_learner=data",
            f"num_iterations={GANG_CLI_ROUNDS}", "num_leaves=63", "max_bin=255",
            "verbosity=-1", f"output_model={out}"]


def trees_of(text):
    return text.split("end of trees")[0]


def first_trees(text, n):
    """The first n `Tree=` blocks of a model text (a run of fewer rounds is
    held to the first trees of a longer one)."""
    return "".join("Tree=" + b for b in trees_of(text).split("Tree=")[1:n + 1])


def same_model(a, b):
    """(equal, what differs): the trees of two model texts line for line,
    split_gain within 4 ULP of the larger gain, every other line equal."""
    la, lb = trees_of(a).splitlines(), trees_of(b).splitlines()
    if len(la) != len(lb):
        return False, f"{len(la)} lines against {len(lb)}"
    for x, y in zip(la, lb):
        if x == y:
            continue
        if x.startswith("split_gain=") and y.startswith("split_gain="):
            gx = np.array(x.split("=", 1)[1].split(), np.float32)
            gy = np.array(y.split("=", 1)[1].split(), np.float32)
            ulp = np.spacing(np.maximum(np.abs(gx), np.abs(gy)))
            if gx.shape == gy.shape and bool((np.abs(gx - gy) <= 4 * ulp).all()):
                continue
        if x.startswith("tree_sizes=") and y.startswith("tree_sizes="):
            continue  # follows split_gain's digits
        return False, f"{x[:120]} | {y[:120]}"
    return True, ""


def gang_worker(out_dir, seed):
    """One rank of phase 21's gang (started by `drive_distributed` through
    the launcher's GangSupervisor and worker_env): joins the gang, builds
    phase 8's data from --seed and keeps its shard on its card, trains
    through each distributed learner, predicts and serves row-sharded, and
    runs the CLI in the gang; writes its results to out_dir/rank<r>.json."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import cli
    from lightgbm_tpu_torch.ops import (compact_cuda, hist_cuda, partition_cuda, predict_cuda,
                                        quantize_cuda, scan_cuda, wave_cuda)
    from lightgbm_tpu_torch.parallel import dist, elastic
    from lightgbm_tpu_torch.serving import PredictionService
    from lightgbm_tpu_torch.utils import sanitize
    from lightgbm_tpu_torch.utils.timer import global_timer

    libs = (predict_cuda, hist_cuda, scan_cuda, compact_cuda.LIB, compact_cuda.WAVE_LIB,
            partition_cuda.LIB, wave_cuda.LIB, quantize_cuda)
    t0 = time.perf_counter()
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // int(os.environ["WORLD_SIZE"])))
    dist.init_distributed(lt.Config({"device_type": "cuda"}))
    world = dist.current_world()
    res = {"rank": world.rank, "size": world.size, "backend": world.backend,
           "device": str(world.device), "runs": {}}
    X, y = higgs_rows(seed + 5, TRAIN_ROWS)
    Xv, yv = higgs_rows(seed + 6, VALID_ROWS)
    train_set = lt.Dataset(X, label=y, params={"max_bin": TRAIN_PARAMS["max_bin"]}).construct()
    res["setup_s"] = time.perf_counter() - t0
    for label, learner, which, rounds_key in GANG_RUNS:
        params = _gang_params(which, learner, label)
        rounds = {"TRAIN": TRAIN_ROUNDS, "HOST": GANG_HOST_ROUNDS,
                  "HALF": TRAIN_ROUNDS // 2}[rounds_key]
        for lib in libs:
            lib.reset_launches()
        global_timer.reset()
        global_timer.enabled = True
        stamps, evals = [], {}
        if label in GANG_PHASE22:
            elastic.install(timeout_s=None, heartbeat_every=1)
            sanitize.enable("cuda")
            sanitize.reset()
        t = time.perf_counter()
        try:
            bst = lt.train(dict(params), train_set, num_boost_round=rounds,
                           valid_sets=[train_set.create_valid(Xv, label=yv)],
                           valid_names=["valid"],
                           callbacks=[lambda env: stamps.append(time.perf_counter()),
                                      lt.record_evaluation(evals)])
            torch.cuda.synchronize()
        finally:
            elastic.clear()
            sanitize.disable()
            sanitize.clear_override()
        wall = time.perf_counter() - t
        global_timer.enabled = False
        per_iter = np.diff([t] + stamps)
        launches = {}
        for lib in libs:
            launches.update({k: int(v) for k, v in lib.launches.items() if v})
        c = dict(global_timer.counters)
        res["runs"][label] = {
            "learner": type(bst._gbdt.tree_learner).__name__,
            "k_global": getattr(bst._gbdt.tree_learner, "k_global", None),
            "model": bst.model_to_string() if world.rank == 0 else "",
            "per_iter": per_iter.tolist(), "wall": wall, "auc": evals["valid"]["auc"],
            "launches": launches, "collective_us": c.get("collective_us", 0),
            "collective_bytes": c.get("collective_bytes", 0),
            "collective_calls": c.get("collective_calls", 0),
            "wave_wire_bytes": c.get("wave_wire_bytes", 0),
            "wave_wire_waves": c.get("wave_wire_waves", 0),
            "model_wire": c.get("wave_wire_model_bytes", 0),
            "waves": c.get("device_waves", 0),
            "heartbeats": c.get("elastic_heartbeats", 0),
            "order_checks": c.get("collective_order_checks", 0)}
        if label == "data":
            booster = bst
        del bst
        torch.cuda.empty_cache()
    # row-sharded predict of the 1M rows, and a service loaded with shard_rows
    predict_cuda.reset_launches()
    # the reference: a shard threshold above the row count, every row on this rank
    whole = booster.predict(X, pred_shard_rows=len(X) + 1)
    want = booster.predict(X[:GANG_SERVE_ROWS].astype(np.float32),
                           pred_shard_rows=GANG_SERVE_ROWS + 1)
    global_timer.reset()
    sharded = booster.predict(X, pred_shard_rows=GANG_SHARD_ROWS)
    res["predict"] = {"equal": whole.dtype == sharded.dtype
                      and whole.tobytes() == sharded.tobytes(),
                      "rows": int(global_timer.counters.get("predict_sharded_rows", 0)),
                      "launches": int(predict_cuda.launches["predict_forest_raw"])}
    svc = PredictionService(device="cuda", max_batch_rows=16_384, max_queue_rows=65_536,
                            max_request_rows=65_536)
    try:
        svc.load_model("higgs", booster=booster, shard_rows=GANG_SERVE_SHARD)
        served = np.asarray(svc.predict("higgs", X[:GANG_SERVE_ROWS].astype(np.float32)))
    finally:
        svc.close()
    res["serve"] = {"equal": served.dtype == want.dtype
                    and served.ravel().tobytes() == want.ravel().tobytes()}
    # the CLI in this gang: rank 0 writes the model
    out = os.path.join(out_dir, "cli_gang.txt")
    rc = cli.run(_gang_cli_args(os.path.join(out_dir, "cli.tsv"), out))
    res["cli_rc"] = int(rc)
    res["stream"] = gang_stream(lt, libs, train_set)
    with open(os.path.join(out_dir, f"rank{world.rank}.json"), "w") as fh:
        json.dump(res, fh)
    dist.shutdown()
    return 0


def gang_stream(lt, libs, train_set):
    """Phase 22 (e), on a rank of phase 21's gang: phase 20's streamed runs
    (16 blocks of 65,536 rows, a 4-block budget a rank) with
    tree_learner=data, float and quantized, through the gang-sharded
    streamed learner; each run's model (rank 0), launches, the blocks this
    rank uploaded, its stream counters and s/iteration."""
    from lightgbm_tpu_torch.streaming import ShardedStreamedTreeLearner
    from lightgbm_tpu_torch.utils.timer import global_timer

    core = train_set._handle
    block_bytes = perfmodel.stream_block_bytes(STREAM_BLOCK_ROWS, core.bins.shape[0],
                                               core.bins.dtype.itemsize)
    out = {}
    _stream_env(STREAM_BUDGET_BLOCKS * block_bytes, STREAM_BLOCK_ROWS)
    try:
        for label, params, rounds in (
                ("float", TRAIN_PARAMS, STREAM_GANG_ROUNDS),
                ("quantized", {**TRAIN_PARAMS, **QUANT_PARAMS}, STREAM_QUANT_ROUNDS)):
            for lib in libs:
                lib.reset_launches()
            global_timer.reset()
            global_timer.enabled = True
            bst, steady, first, wall, _ = _timed_run(lt, {**params, "tree_learner": "data"},
                                                     train_set, None, rounds)
            torch.cuda.synchronize()
            global_timer.enabled = False
            learner = bst._gbdt.tree_learner
            c = global_timer.counters
            out[label] = {
                "learner": type(learner).__name__,
                "sharded": isinstance(learner, ShardedStreamedTreeLearner),
                "model": bst.model_to_string() if learner.world.rank == 0 else "",
                "launches": {k: int(v) for k, v in _counts(libs).items() if v},
                "uploaded": sorted(int(b) for b in learner._cache.uploaded),
                "owned": list(learner._cache.owned), "n_blocks": learner._cache.n_blocks,
                "groups": len(learner.dataset.groups), "bins": learner.group_bin_padded,
                "steady": steady, "first": first, "wall": wall,
                "counters": {k: int(v) for k, v in c.items()
                             if k.startswith("stream_") or k.startswith("collective")}}
            del bst, learner
            torch.cuda.empty_cache()
    finally:
        _stream_env(None)
    return out


def drive_distributed(lt, wave, serial, X_train, y_train, seed, tag):
    """Phase 21: the distributed learners. A gang of min(cards, 4) ranks over
    NCCL (with one card: 2 ranks on it over gloo, staged through pinned host
    memory) started with the port's launcher code (GangSupervisor,
    worker_env); each rank (`gang_worker`) builds phase 8's data and keeps
    its shard on its card. Checks: data-, feature- and voting-parallel (top_k
    28) equal to phase 8's single-card model, the host-driven data-parallel
    learner (feature_fraction_bynode 0.8) to phase 9's, quantized
    data-parallel to phase 12's; voting at top_k 5 (10 of 28 features
    elected) within 0.001 valid AUC of the exact run; row-sharded predict
    and shard_rows serving bit-equal to Booster.predict; `launch -n 2 -- <cli args> tree_learner=data` writes
    the in-process gang's model. Returns {kernel: launches over the gang}."""
    import subprocess

    from lightgbm_tpu_torch import launch
    from lightgbm_tpu_torch.parallel.elastic import GangSupervisor, worker_env

    count = torch.cuda.device_count()
    n = min(count, 4) if count >= 2 else 2
    backend = "nccl" if count >= 2 else "gloo"
    print(f"phase 21: a gang of {n} ranks over {backend} on {count} card(s)"
          + ("" if count >= 2 else ", both ranks on the one card, staged through pinned "
             "host memory"), flush=True)
    t_phase = time.perf_counter()
    gang_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                            "chip_smoke_gang")
    os.makedirs(gang_dir, exist_ok=True)
    for name in os.listdir(gang_dir):
        os.unlink(os.path.join(gang_dir, name))
    tsv = os.path.join(gang_dir, "cli.tsv")
    np.savetxt(tsv, np.column_stack([y_train[:GANG_CLI_ROWS], X_train[:GANG_CLI_ROWS]]),
               delimiter="\t", fmt="%.9g")
    procs = []

    def spawn(world, rank, attempt):
        env = worker_env(port=port, world=world, rank=rank)
        log = open(os.path.join(gang_dir, f"rank{rank}.log"), "w")
        p = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gang-worker",
                              gang_dir, "--seed", str(seed)], env=env, stdout=log,
                             stderr=subprocess.STDOUT)
        procs.append(p)
        return p

    def reap():
        for p in procs:
            if p.poll() is None:
                p.kill()

    port = launch.free_port()
    timer = threading.Timer(GANG_TIMEOUT_S, reap)
    timer.start()
    try:
        rc = GangSupervisor(spawn, n).run()
    finally:
        timer.cancel()
    t_gang = time.perf_counter() - t_phase
    if rc != 0:
        for r in range(n):
            path = os.path.join(gang_dir, f"rank{r}.log")
            if os.path.exists(path):
                print(f"phase 21: rank {r}'s log (last 3,000 bytes):\n"
                      + open(path).read()[-3000:])
    check(rc == 0, f"phase 21: the gang failed (exit code {rc}) or ran past "
                   f"{GANG_TIMEOUT_S} s")
    ranks = [json.load(open(os.path.join(gang_dir, f"rank{r}.json"))) for r in range(n)]
    r0 = ranks[0]
    check(all(r["backend"] == backend and r["size"] == n for r in ranks),
          f"phase 21: the ranks' backends / sizes {[(r['backend'], r['size']) for r in ranks]}")
    print(f"{tag} phase 21: {n} ranks ({[r['device'] for r in ranks]}), data built in "
          f"{max(r['setup_s'] for r in ranks):.1f} s a rank")
    ref_text = {"data": PHASE_MODELS["wave"], "feature": PHASE_MODELS["wave"],
                "voting": PHASE_MODELS["wave"], "data_host": PHASE_MODELS["serial"],
                "data_quantized": PHASE_MODELS["quantized"],
                "data_sanitized": PHASE_MODELS["wave"]}
    want_kind = {"data_sanitized": "DeviceDataParallelTreeLearner",
                 "data": "DeviceDataParallelTreeLearner",
                 "feature": "DeviceFeatureParallelTreeLearner",
                 "voting": "VotingDataParallelTreeLearner",
                 "voting_narrow": "VotingDataParallelTreeLearner",
                 "data_host": "DataParallelTreeLearner",
                 "data_quantized": "DeviceDataParallelTreeLearner"}
    launches = {}
    for label, _, _, _ in GANG_RUNS:
        run = r0["runs"][label]
        check(all(r["runs"][label]["learner"] == want_kind[label] for r in ranks),
              f"phase 21 ({label}): grown by {run['learner']}, not {want_kind[label]}")
        if label in ref_text:
            n_run = run["model"].count("Tree=")
            ok, what = same_model(first_trees(run["model"], n_run),
                                  first_trees(ref_text[label], n_run))
            phase = {"data_host": 9, "data_quantized": 12}.get(label, 8)
            check(ok, f"phase 21 ({label}): the model differs from phase {phase}'s "
                      f"single-card model: {what}")
        required = GANG_REQUIRED["quantized" if label == "data_quantized" else
                                 "host" if label == "data_host" else "wave"]
        for name in required:
            check(all(r["runs"][label]["launches"].get(name, 0) > 0 for r in ranks),
                  f"phase 21 ({label}): kernel {name} never launched on a rank")
        for r in ranks:
            for name, v in r["runs"][label]["launches"].items():
                launches[name] = launches.get(name, 0) + v
    # the voting run takes half the rounds: against the exact run's AUC then
    narrow = r0["runs"]["voting_narrow"]
    check(narrow["k_global"] < HIGGS["n_features"],
          f"phase 21: voting at top_k {GANG_VOTE_TOP_K} elects {narrow['k_global']} of the "
          f"{HIGGS['n_features']} features: the election is not narrower than the exact run")
    top_n = narrow["auc"][-1]
    exact = r0["runs"]["data"]["auc"][len(narrow["auc"]) - 1]
    check(abs(top_n - exact) <= GANG_VOTE_AUC_MARGIN,
          f"phase 21: voting at top_k {GANG_VOTE_TOP_K} valid AUC {top_n:.5f} not within "
          f"{GANG_VOTE_AUC_MARGIN} of the exact run's {exact:.5f}")
    n_trees = narrow["model"].count("Tree=")
    exact_trees = r0["runs"]["data"]["model"].split("Tree=")[1:n_trees + 1]
    print(f"phase 21 (voting_narrow): {narrow['k_global']} of {HIGGS['n_features']} features "
          f"elected a leaf; its {n_trees} trees "
          + ("equal" if narrow["model"].split("Tree=")[1:] == exact_trees else "differ from")
          + " the exact run's first ones")
    check(all(r["predict"]["equal"] for r in ranks),
          "phase 21: the row-sharded predict of the 1M rows differs from Booster.predict")
    check(sum(r["predict"]["rows"] for r in ranks) == TRAIN_ROWS,
          f"phase 21: the ranks predicted {[r['predict']['rows'] for r in ranks]} rows")
    check(all(r["serve"]["equal"] for r in ranks),
          "phase 21: the shard_rows service's answers differ from Booster.predict")
    check(all(r["cli_rc"] == 0 for r in ranks), "phase 21: the in-gang CLI failed")
    # the launcher, 2 ranks, the same CLI arguments
    t = time.perf_counter()
    rc = launch.main(["-n", "2", "--", *_gang_cli_args(tsv, os.path.join(gang_dir,
                                                                 "cli_launch.txt"))])
    t_launch = time.perf_counter() - t
    check(rc == 0, f"phase 21: launch -n 2 exited {rc}")
    gang_cli = open(os.path.join(gang_dir, "cli_gang.txt")).read()
    launched = open(os.path.join(gang_dir, "cli_launch.txt")).read()
    ok, what = same_model(launched, gang_cli)
    check(ok and trees_of(launched) == trees_of(gang_cli),
          f"phase 21: launch -n 2's model differs from the {n}-rank gang's: {what}")
    # report
    base = float(np.mean(wave["per_iter"][1:]))
    base_serial = float(np.mean(serial["per_iter"][1:]))
    for label, _, _, _ in GANG_RUNS:
        if label in GANG_PHASE22:
            continue  # phase 22 (d) reports them
        runs = [r["runs"][label] for r in ranks]
        steady = float(np.mean(runs[0]["per_iter"][1:]))
        ref = base_serial if label == "data_host" else base
        share = max(ru["collective_us"] / 1e6 / ru["wall"] for ru in runs)
        waves = runs[0]["wave_wire_waves"]
        counted = runs[0]["wave_wire_bytes"] / waves if waves else 0.0
        model = runs[0]["model_wire"] / waves if waves else 0.0
        check(all(ru["wave_wire_bytes"] == ru["model_wire"] for ru in runs),
              f"phase 21 ({label}): the bytes counted at the collectives during the waves "
              f"differ from perfmodel's {[(ru['wave_wire_bytes'], ru['model_wire']) for ru in runs]}")
        print(f"{tag} phase 21 ({label}, {runs[0]['learner']}, {n} ranks over {backend}, "
              f"{count} card(s)): s/iteration {steady:.4f} (first {runs[0]['per_iter'][0]:.3f}; "
              f"phase {9 if label == 'data_host' else 8} single card {ref:.4f}); collectives "
              f"{share * 100:.1f}% of the run's wall (the busiest rank, host wall around the "
              f"synchronized calls: {runs[0]['collective_calls']} calls, "
              f"{runs[0]['collective_bytes'] / 1e6:.2f} MB handed by rank 0); wire a wave "
              f"perfmodel {model:.0f} B, counted {counted:.0f} B (rank 0, "
              f"{waves} waves run); valid AUC {runs[0]['auc'][-1]:.5f}")
        print(f"phase 21 ({label}) launches over the ranks: " + ", ".join(
            f"{k} {sum(r['runs'][label]['launches'].get(k, 0) for r in ranks)}"
            for k in sorted(runs[0]["launches"])))
    print(f"{tag} phase 21: models equal to phases 8 (data, feature, voting top_k 28), 9 "
          f"(host data, bynode 0.8) and 12 (quantized); voting top_k {GANG_VOTE_TOP_K} valid "
          f"AUC {top_n:.5f} against {exact:.5f}; row-sharded predict of {TRAIN_ROWS} rows and "
          f"the shard_rows service bit-equal; launch -n 2 ({t_launch:.1f} s) wrote the "
          f"gang's model; phase {time.perf_counter() - t_phase:.1f} s (gang {t_gang:.1f} s)")
    return launches, ranks


# ------------------------------------------------------------- phase 22
ELASTIC_COLLECTIVE_TIMEOUT_S = 8  # (b): the watchdog's deadline
ELASTIC_LIVENESS_S = 30  # (b): the supervisor's liveness deadline, past the watchdog's
ELASTIC_TIMEOUT_S = 240  # a run of phase 22 is reaped (and the phase fails) past this
SHRINK_KILL_AT = 2  # (c): rank 1 dies at the start of this iteration
STREAM_GANG_REQUIRED = {"float": ("histogram_carry", "histogram_image_to_float",
                                  "find_best_split", "row_partition_decide",
                                  "row_partition_scatter"),
                        "quantized": ("histogram_carry_i32", "find_best_split_int",
                                      "quantize_reduce", "quantize")}


def elastic_worker(out_dir, seed):
    """One rank of phase 22 (c)'s gang (started by `drive_elastic` through
    GangSupervisor with allow_shrink): phase 8's rows from --seed, quantized
    data-parallel training at phase 12's settings, rank 0 writing a
    snapshot every iteration; on a relaunch (a gang attempt past 0) it
    resumes from rank 0's newest snapshot. LGBM_TPU_FAULT=worker_kill@1:K
    kills rank 1 of the first attempt. Rank 0 writes the model text and
    its run's record to out_dir."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.checkpoint import checkpoint_callback
    from lightgbm_tpu_torch.ops import (compact_cuda, hist_cuda, partition_cuda, quantize_cuda,
                                        scan_cuda, wave_cuda)
    from lightgbm_tpu_torch.parallel import dist
    from lightgbm_tpu_torch.parallel.elastic import latest_snapshot

    libs = (hist_cuda, scan_cuda, compact_cuda.LIB, compact_cuda.WAVE_LIB, partition_cuda.LIB,
            wave_cuda.LIB, quantize_cuda)
    t0 = time.perf_counter()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // int(os.environ["WORLD_SIZE"])))
    dist.init_distributed(lt.Config({"device_type": "cuda"}))
    world = dist.current_world()
    attempt = int(os.environ.get("LGBM_TPU_GANG_ATTEMPT", "0"))
    X, y = higgs_rows(seed + 5, TRAIN_ROWS)
    train_set = lt.Dataset(X, label=y, params={"max_bin": TRAIN_PARAMS["max_bin"]}).construct()
    setup = time.perf_counter() - t0
    base = os.path.join(out_dir, "shrink.txt")
    resume = latest_snapshot(base) if attempt > 0 else None
    cbs = ([checkpoint_callback(lambda it: f"{base}.snapshot_iter_{it}", period=1)]
           if world.rank == 0 else [])
    for lib in libs:
        lib.reset_launches()
    bst, steady, first, wall, _ = _timed_run(
        lt, {**WAVE_PARAMS, **QUANT_PARAMS, "tree_learner": "data"}, train_set, None,
        TRAIN_ROUNDS, callbacks=cbs, init_model=resume)
    torch.cuda.synchronize()
    if world.rank == 0:
        with open(os.path.join(out_dir, f"shrink_attempt{attempt}.json"), "w") as fh:
            json.dump({"size": world.size, "attempt": attempt, "resumed_from": resume,
                       "learner": type(bst._gbdt.tree_learner).__name__,
                       "model": bst.model_to_string(), "setup_s": setup, "steady": steady,
                       "first": first, "wall": wall,
                       "launches": {k: int(v) for k, v in _counts(libs).items() if v}}, fh)
    dist.shutdown()
    return 0


def _launch_elastic(launch, gang_dir, name, tsv, env, extra):
    """`launch -n 2 --elastic` of phase 21's CLI arguments with snapshots
    every iteration, `env` set for the launcher and its workers: (exit code,
    seconds, the model text, the gang_worker_lost flight dumps' extras,
    the recovery ms)."""
    from lightgbm_tpu_torch.utils.timer import global_timer

    out = os.path.join(gang_dir, f"{name}.txt")
    flight = os.path.join(gang_dir, f"flight_{name}")
    saved = {k: os.environ.get(k) for k in [*env, "LGBM_TPU_FLIGHT_DIR"]}
    os.environ.update(env, LGBM_TPU_FLIGHT_DIR=flight)
    global_timer.counters.pop("gang_recovery_ms", None)
    t = time.perf_counter()
    try:
        rc = launch.main(["-n", "2", "--elastic", "--max-restarts", "1", *extra,
                          "--gang-dir", os.path.join(gang_dir, f"hb_{name}"), "--",
                          *_gang_cli_args(tsv, out), "snapshot_freq=1"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    secs = time.perf_counter() - t
    lost = [json.load(open(os.path.join(flight, f)))["extra"] for f in
            sorted(os.listdir(flight)) if "gang_worker_lost" in f] if os.path.isdir(flight) else []
    model = open(out).read() if os.path.exists(out) else ""
    return rc, secs, model, lost, global_timer.counters.get("gang_recovery_ms")


def drive_elastic(lt, gang_ranks, seed, tag):
    """Phase 22: the gang's failure handling. (a) `launch -n 2 --elastic` of
    phase 21's CLI run with worker_kill@1:3: one restart, the undisturbed
    model byte for byte, a gang_worker_lost dump naming rank 1; (b) the same
    with worker_hang@1:3, the collective watchdog's deadline and the
    supervisor's liveness deadline: the gang reaped (exit 117 or a liveness
    loss) and the relaunched model byte-equal; (c) `allow_shrink` from 2
    ranks to 1 on quantized data-parallel at phase 12's settings (rank 1
    killed at iteration SHRINK_KILL_AT, one rank resuming from rank 0's
    snapshot), byte-equal to phase 12's single-card model; (d) from phase
    21's gang: the data run with the heartbeat every iteration and the
    sanitizer's collective-order check at each, beside the plain data run;
    (e) from phase 21's gang: phase 20's streamed runs through the
    gang-sharded streamed learner, byte-equal to phase 20's models, the
    carried kernel on every rank, no rank uploading a block it does not
    own, the bytes counted at the collectives equal to perfmodel's. Returns
    {kernel: launches} over its runs."""
    t_phase = time.perf_counter()
    gang_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                            "chip_smoke_gang")
    secs_a, secs_b = elastic_relaunch(gang_dir, tag)
    launches, secs_c = elastic_shrink(gang_dir, seed, tag)
    elastic_gang_runs(gang_ranks, launches, tag)
    print(f"{tag} phase 22: {time.perf_counter() - t_phase:.1f} s (a) {secs_a:.1f} s, "
          f"(b) {secs_b:.1f} s, (c) {secs_c:.1f} s; (d), (e) in phase 21's gang")
    return launches


def elastic_relaunch(gang_dir, tag):
    """Phase 22 (a) and (b), over phase 21's CLI text file and its
    undisturbed `launch -n 2` model: (seconds of (a), of (b))."""
    from lightgbm_tpu_torch import launch
    from lightgbm_tpu_torch.parallel.elastic import EXIT_WORKER_LOST

    tsv = os.path.join(gang_dir, "cli.tsv")
    undisturbed = open(os.path.join(gang_dir, "cli_launch.txt")).read()

    # ---- (a) a killed worker
    rc, secs_a, model_a, lost_a, rec_a = _launch_elastic(
        launch, gang_dir, "killed", tsv, {"LGBM_TPU_FAULT": "worker_kill@1:3"}, [])
    check(rc == 0, f"phase 22 (a): launch --elastic with worker_kill@1:3 exited {rc}")
    check(trees_of(model_a) == trees_of(undisturbed),
          "phase 22 (a): the relaunched gang's model differs from phase 21's launch -n 2 model")
    check(len(lost_a) == 1 and lost_a[0]["rank"] == 1 and lost_a[0]["exit_code"] == 43,
          f"phase 22 (a): the gang_worker_lost dumps {lost_a} do not name rank 1's exit 43")
    print(f"{tag} phase 22 (a) killed worker: launch -n 2 --elastic, worker_kill@1:3 -> rank 1 "
          f"exit 43, gang reaped and relaunched once from rank 0's snapshot; gang_recovery_ms "
          f"{rec_a}; model byte-equal to phase 21's undisturbed launch -n 2 model; {secs_a:.1f} s")

    # ---- (b) a hung worker
    rc, secs_b, model_b, lost_b, rec_b = _launch_elastic(
        launch, gang_dir, "hung", tsv,
        {"LGBM_TPU_FAULT": "worker_hang@1:3",
         "LGBM_TPU_COLLECTIVE_TIMEOUT_S": str(ELASTIC_COLLECTIVE_TIMEOUT_S)},
        ["--liveness-timeout", str(ELASTIC_LIVENESS_S)])
    check(rc == 0, f"phase 22 (b): launch --elastic with worker_hang@1:3 exited {rc}")
    check(trees_of(model_b) == trees_of(undisturbed),
          "phase 22 (b): the relaunched gang's model differs from phase 21's launch -n 2 model")
    check(len(lost_b) == 1 and (lost_b[0]["exit_code"] == EXIT_WORKER_LOST
                                or lost_b[0]["why"] == "liveness"),
          f"phase 22 (b): the hung gang was not reaped by exit {EXIT_WORKER_LOST} or a "
          f"liveness loss: {lost_b}")
    how = (f"rank {lost_b[0]['rank']} exit {lost_b[0]['exit_code']}"
           if lost_b[0]["why"] == "exit" else f"rank {lost_b[0]['rank']}'s liveness file stale")
    print(f"{tag} phase 22 (b) hung worker: worker_hang@1:3, collective timeout "
          f"{ELASTIC_COLLECTIVE_TIMEOUT_S} s, liveness {ELASTIC_LIVENESS_S} s -> reaped by {how}; "
          f"gang_recovery_ms {rec_b}; model byte-equal; {secs_b:.1f} s")
    return secs_a, secs_b


def elastic_shrink(gang_dir, seed, tag):
    """Phase 22 (c): ({kernel: launches} of the resumed run, seconds)."""
    import subprocess

    from lightgbm_tpu_torch import launch
    from lightgbm_tpu_torch.parallel.elastic import GangSupervisor, worker_env

    launches = collections.defaultdict(int)

    # ---- (c) shrink 2 -> 1, quantized data-parallel
    shrink_dir = os.path.join(gang_dir, "shrink")
    os.makedirs(shrink_dir, exist_ok=True)
    for name in os.listdir(shrink_dir):
        os.unlink(os.path.join(shrink_dir, name))
    ports = {}
    procs = []

    def spawn(world, rank, attempt):
        port = ports.setdefault(attempt, launch.free_port())
        env = worker_env(port=port, world=world, rank=rank, attempt=attempt,
                         gang_dir=os.path.join(shrink_dir, "hb"), elastic=True)
        env["LGBM_TPU_FAULT"] = f"worker_kill@1:{SHRINK_KILL_AT}"
        log = open(os.path.join(shrink_dir, f"attempt{attempt}_rank{rank}.log"), "w")
        p = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--elastic-worker",
                              shrink_dir, "--seed", str(seed)], env=env, stdout=log,
                             stderr=subprocess.STDOUT)
        procs.append(p)
        return p

    def reap():
        for p in procs:
            if p.poll() is None:
                p.kill()

    timer = threading.Timer(ELASTIC_TIMEOUT_S, reap)
    timer.start()
    t = time.perf_counter()
    try:
        sup = GangSupervisor(spawn, 2, elastic=True, max_restarts=1, allow_shrink=True)
        rc = sup.run()
    finally:
        timer.cancel()
    secs_c = time.perf_counter() - t
    if rc != 0:
        for name in sorted(os.listdir(shrink_dir)):
            if name.endswith(".log"):
                print(f"phase 22 (c): {name} (last 2,000 bytes):\n"
                      + open(os.path.join(shrink_dir, name)).read()[-2000:])
    check(rc == 0 and sup.worlds == [2, 1],
          f"phase 22 (c): the shrinking gang exited {rc} over worlds {sup.worlds}")
    shrunk = json.load(open(os.path.join(shrink_dir, "shrink_attempt1.json")))
    # rank 0 may be reaped while it writes the newest snapshot: the relaunch
    # resumes from the newest whole one
    check(shrunk["size"] == 1 and shrunk["resumed_from"] is not None,
          f"phase 22 (c): the relaunch ran on {shrunk['size']} rank(s) from "
          f"{shrunk['resumed_from']}")
    check(trees_of(shrunk["model"]) == trees_of(PHASE_MODELS["quantized"]),
          "phase 22 (c): the model resumed on 1 rank differs from phase 12's single-card model")
    for name in ("histogram_slots_ragged_i32", "split_scan_batched", "quantize"):
        check(shrunk["launches"].get(name, 0) > 0,
              f"phase 22 (c): kernel {name} never launched in the resumed run")
    for k, v in shrunk["launches"].items():
        launches[k] += v
    print(f"{tag} phase 22 (c) shrink: 2 ranks, rank 1 killed at iteration {SHRINK_KILL_AT}, "
          f"relaunched on 1 ({shrunk['learner']}) from {os.path.basename(shrunk['resumed_from'])}"
          f"; model byte-equal to phase 12's single-card model; gang_recovery_ms "
          f"{sup.last_recovery_ms:.0f}; the resumed rank's data {shrunk['setup_s']:.1f} s, "
          f"s/iteration {shrunk['steady']:.4f}; {secs_c:.1f} s")
    return launches, secs_c


def elastic_gang_runs(gang_ranks, launches, tag):
    """Phase 22 (d) and (e), run by phase 21's gang: their checks and
    report; (e)'s launches are added to `launches`."""
    n = len(gang_ranks)
    count = torch.cuda.device_count()

    # ---- (d) the heartbeat and the collective-order check, from phase 21's gang
    plain = [r["runs"]["data"] for r in gang_ranks]
    sn = [r["runs"]["data_sanitized"] for r in gang_ranks]
    rounds = len(sn[0]["per_iter"])
    check(all(h["heartbeats"] == rounds for h in sn),
          f"phase 22 (d): heartbeats {[h['heartbeats'] for h in sn]}, not one an iteration")
    check(all(h["order_checks"] == rounds for h in sn),
          f"phase 22 (d): collective-order checks {[h['order_checks'] for h in sn]} of "
          f"{rounds} heartbeats")
    check(all(q["heartbeats"] == 0 for q in plain),
          "phase 22 (d): the run without the elastic runtime counted heartbeats")
    off = float(np.mean(plain[0]["per_iter"][1:rounds]))
    checked = float(np.mean(sn[0]["per_iter"][1:]))
    print(f"{tag} phase 22 (d) heartbeat ({n} ranks over {gang_ranks[0]['backend']}, {count} "
          f"card(s)): data-parallel s/iteration of rounds 2-{rounds}, one run each: phase 21's "
          f"data run {off:.4f}, with the heartbeat and the collective-order check every "
          f"iteration {checked:.4f} (the runs' spread is larger than the heartbeat's one "
          f"4-byte all-reduce: no cost is resolved here); {sn[0]['order_checks']} checks "
          f"passed a rank; models equal to phase 8's first {rounds} trees")
    for label in GANG_PHASE22:
        print(f"phase 22 (d, {label}) launches over the ranks: " + ", ".join(
            f"{k} {sum(r['runs'][label]['launches'].get(k, 0) for r in gang_ranks)}"
            for k in sorted(gang_ranks[0]["runs"][label]["launches"])))

    # ---- (e) the gang-sharded streamed learner, from phase 21's gang
    refs = {"float": PHASE_MODELS["serial"], "quantized": PHASE_MODELS["stream_quantized"]}
    for label in ("float", "quantized"):
        runs = [r["stream"][label] for r in gang_ranks]
        r0 = runs[0]
        check(all(ru["sharded"] for ru in runs),
              f"phase 22 (e, {label}): grown by {r0['learner']}, not the sharded streamed one")
        n_trees = r0["model"].count("Tree=")
        check(first_trees(r0["model"], n_trees) == first_trees(refs[label], n_trees),
              f"phase 22 (e, {label}): the sharded streamed model differs from phase 20's "
              f"single-card streamed model")
        for rank, ru in enumerate(runs):
            for name in STREAM_GANG_REQUIRED[label]:
                check(ru["launches"].get(name, 0) > 0,
                      f"phase 22 (e, {label}): kernel {name} never launched on rank {rank}")
            check(all(b % n == rank for b in ru["uploaded"]) and ru["uploaded"],
                  f"phase 22 (e, {label}): rank {rank} uploaded blocks {ru['uploaded']}, "
                  f"not only its own")
            c = ru["counters"]
            vb = 4 if label == "quantized" else 8
            want = perfmodel.stream_ici_bytes_per_wave(ru["groups"], ru["bins"], 3, vb)
            check(c.get("stream_ici_bytes_per_wave") == want
                  and c.get("stream_ici_bytes") == want * c.get("stream_leaf_histograms", -1),
                  f"phase 22 (e, {label}): rank {rank} counted {c.get('stream_ici_bytes')} B at "
                  f"the collectives for {c.get('stream_leaf_histograms')} leaf histograms, "
                  f"perfmodel {want} B each")
            for k, v in ru["launches"].items():
                launches[k] += v
        print(f"{tag} phase 22 (e, {label}): the sharded streamed learner on {n} ranks, "
              f"{r0['n_blocks']} blocks, each rank caching its own under phase 20's "
              f"{STREAM_BUDGET_BLOCKS}-block budget; s/iteration first {r0['first']:.3f}, rest "
              f"{r0['steady']:.3f}; uploads a rank "
              + ", ".join(f"{ru['counters'].get('stream_h2d_blocks', 0)} blocks + "
                          f"{ru['counters'].get('stream_h2d_rows', 0)} group rows"
                          for ru in runs)
              + f"; wire {r0['counters'].get('stream_ici_bytes_per_wave')} B a leaf histogram "
              f"(perfmodel), {r0['counters'].get('stream_leaf_histograms')} histograms; "
              f"{n_trees} trees byte-equal to phase 20's")


def profile_other(checkout: str, seed: int) -> int:
    """The package in another checkout on the training path's data: its
    leaf histogram's time at the root, a LEAF_ROWS and a SMALL_LEAF_ROWS
    leaf (the row sets and gradients of check_histogram; the whole padded
    set read, as its learner reads it where it takes no count), and for each
    learner the host scopes of a 2-round run and one profiled round."""
    sys.path.insert(0, os.path.abspath(checkout))
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import hist_cuda
    from lightgbm_tpu_torch.utils.timer import global_timer

    check(os.path.dirname(os.path.abspath(lt.__file__)).startswith(os.path.abspath(checkout)),
          f"imported {lt.__file__}, not the package in {checkout}")
    card = card_line()
    dev = torch.device(DEVICE)
    X, y = higgs_rows(seed + 5, TRAIN_ROWS)
    train_set = lt.Dataset(X, label=y, params={"max_bin": TRAIN_PARAMS["max_bin"]}).construct()
    core = train_set._handle
    num_bins = int(core.group_bin_counts().max())
    bins = torch.from_numpy(core.bins).to(dev)
    rng = np.random.RandomState(seed + 7)  # as check_histogram's
    gh, _, _ = leaf_gradients(rng, TRAIN_ROWS, dev)
    sets = leaf_sets(rng, TRAIN_ROWS, dev)
    calls = {name: (lambda i=idx: hist_cuda.histogram(bins, gh, i, num_bins), count,
                    idx.shape[0]) for name, (idx, count) in sets.items()}
    print(f"[{card}] {checkout}: histogram (device events a call, torch.profiler; a call "
          f"back to back, CUDA events) " + ", ".join(
              f"{name} ({count} rows of {P}) {fmt_ms(call_device_ms(fn, 20))}; "
              f"{cuda_ms(fn, 20):.4f} ms" for name, (fn, count, P) in calls.items()))
    del bins, gh, sets
    torch.cuda.empty_cache()
    for params, label in ((WAVE_PARAMS, "wave"), (TRAIN_PARAMS, "serial")):
        global_timer.reset()
        global_timer.enabled = True
        lt.train(dict(params), train_set, num_boost_round=2)
        global_timer.enabled = False
        scopes = sorted(global_timer.totals.items(), key=lambda kv: -kv[1])
        print(f"[{card}] {checkout}: {label} train, 2 rounds, scopes (host s): " + ", ".join(
            f"{k} {v:.3f} ({global_timer.counts[k]})" for k, v in scopes))
        profile_round(lt, params, train_set, f"[{card}] {checkout}:", label)
    return 0


def wave_rounds_of(checkout: str, seed: int, reps: int = 3) -> int:
    """Phase 8's training (the wave learner, WAVE_PARAMS, TRAIN_ROUNDS
    rounds on phase 8's rows with its valid set, the host timer on) with
    the package in another checkout, `reps` times: each run's s/iteration
    (its first round left out) and the wave pool's bytes, one JSON line a
    run. Two checkouts are compared in one call, alternating:
    ``--wave-rounds-of A``, ``--wave-rounds-of B``, then B, then A."""
    sys.path.insert(0, os.path.abspath(checkout))
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.utils.timer import global_timer

    check(os.path.dirname(os.path.abspath(lt.__file__)).startswith(os.path.abspath(checkout)),
          f"imported {lt.__file__}, not the package in {checkout}")
    card = card_line()
    X, y = higgs_rows(seed + 5, TRAIN_ROWS)
    Xv, yv = higgs_rows(seed + 6, VALID_ROWS)
    train_set = lt.Dataset(X, label=y, params={"max_bin": TRAIN_PARAMS["max_bin"]}).construct()
    for rep in range(reps):
        stamps = []
        global_timer.reset()
        global_timer.enabled = True
        t = time.perf_counter()
        bst = lt.train(dict(WAVE_PARAMS), train_set, num_boost_round=TRAIN_ROUNDS,
                       valid_sets=[train_set.create_valid(Xv, label=yv)], valid_names=["valid"],
                       callbacks=[lambda env: stamps.append(time.perf_counter())])
        torch.cuda.synchronize()
        global_timer.enabled = False
        per_iter = np.diff([t] + stamps)
        learner = bst._gbdt.tree_learner
        check(type(learner).__name__ == "DeviceTreeLearner" or DEVICE != "cuda",
              f"phase 8's training grew its trees with {type(learner).__name__}")
        buf = getattr(learner, "_buffers", None)
        pool = [] if buf is None else [buf.pool, getattr(buf, "pool_flags", None)]
        print(json.dumps({"card": card, "checkout": checkout, "rep": rep,
                          "learner": type(learner).__name__,
                          "s_per_iter": float(np.mean(per_iter[1:])),
                          "first_s": float(per_iter[0]),
                          "pool_dtype": [str(t.dtype) for t in pool if t is not None],
                          "pool_bytes": sum(t.nbytes for t in pool if t is not None),
                          "trees_sha": hashlib.sha256(
                              trees_of(bst.model_to_string()).encode()).hexdigest()[:16]}),
              flush=True)
        del bst
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-of", metavar="DIR",
                    help="time the leaf histogram and profile one round of each learner "
                         "of the package in checkout DIR, and exit")
    ap.add_argument("--wave-rounds-of", metavar="DIR",
                    help="time phase 8's training with the package in checkout DIR (s/"
                         "iteration, the wave pool's bytes), three runs, and exit")
    ap.add_argument("--gang-worker", metavar="DIR",
                    help="run as one rank of phase 21's gang, writing to DIR (started by "
                         "phase 21 itself)")
    ap.add_argument("--elastic-worker", metavar="DIR",
                    help="run as one rank of phase 22's shrinking gang, writing to DIR "
                         "(started by phase 22 itself)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    # ---------------------------------------------------------------- device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.profile_of:
        return profile_other(args.profile_of, args.seed)
    if args.wave_rounds_of:
        return wave_rounds_of(args.wave_rounds_of, args.seed)
    if args.gang_worker:
        return gang_worker(args.gang_worker, args.seed)
    if args.elastic_worker:
        return elastic_worker(args.elastic_worker, args.seed)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import Booster
    from lightgbm_tpu_torch.models.synthetic import make_rows, random_model
    from lightgbm_tpu_torch.ops import (compact_cuda, cuda_build, hist_cuda, partition_cuda,
                                        predict_cuda, quantize_cuda, scan_cuda, wave_cuda)
    from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner
    from lightgbm_tpu_torch.ops.predict import (_predict_raw_fused,
                                                _traverse_leaves, pack_ensemble)
    from lightgbm_tpu_torch.serving import PredictionService, serve, wire

    global CARD_KIND
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    CARD_KIND = kind  # the bounds use this card's rates, or fail for a card not in the table
    count = torch.cuda.device_count()
    card = card_line()
    tag = f"[{card}]"
    print(f"device: {kind} x{count}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    # the host sources (the text parser, the C API) build with g++ beside nvcc
    host_built = {}

    def build_host():
        from lightgbm_tpu_torch import capi, native

        t = time.perf_counter()
        host_built["parser"] = native.get_parser().__file__
        host_built["capi"] = str(capi.library_path())
        host_built["seconds"] = time.perf_counter() - t

    host_thread = threading.Thread(target=build_host)
    host_thread.start()
    builds = cuda_build.build_all([predict_cuda.LIB, hist_cuda.LIB, scan_cuda.LIB,
                                   compact_cuda.LIB, compact_cuda.WAVE_LIB,
                                   partition_cuda.LIB, wave_cuda.LIB, quantize_cuda.LIB,
                                   cuda_build.STREAM_LIB], force=True)
    host_thread.join()
    check("capi" in host_built, "build: g++ did not build the parser and the C API")
    print(f"build: {len(builds)} sources in parallel in "
          f"{time.perf_counter() - t0:.2f} s; the card's opt-in shared memory a block "
          f"{perfmodel.shared_memory_per_block(dev)} bytes; g++ built "
          f"{os.path.relpath(host_built['parser'])} and "
          f"{os.path.relpath(host_built['capi'])} in {host_built['seconds']:.2f} s")
    for info in builds:
        print(f"  {os.path.relpath(str(info['source']))}: {info['seconds']:.2f} s")
        for line in str(info["ptxas"]).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("    " + line.strip())

    # ---------------------------------------------------------------- models
    t0 = time.perf_counter()
    rng = np.random.RandomState(args.seed)
    higgs = random_model(rng, **HIGGS)
    multi = random_model(rng, 12, 40, 31, num_class=3, cat_features=(3, 7),
                         objective="multiclass num_class:3")
    stumps = random_model(rng, 8, 60, 15, stump_every=3, objective="regression")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    paths = {}
    for name, model, cats in (("higgs", higgs, ()), ("multiclass_cat", multi, (3, 7)),
                              ("stumps", stumps, ())):
        path = os.path.join(tmp.name, f"{name}.txt")
        Booster(model_str=model.to_string()).save_model(path)
        paths[name] = (path, model, cats)
    depth = [t.max_depth for t in higgs.trees]
    print(f"models: built in {time.perf_counter() - t0:.1f} s; HIGGS profile "
          f"{len(higgs.trees)} trees x {HIGGS['num_leaves']} leaves, depth "
          f"mean {np.mean(depth):.2f} max {max(depth)}")

    # --------------------------------------------------- kernels vs plain
    # both plans of the traversal: the sample takes the all-trees plan, the
    # serving batch sizes the split plan (trees across blocks, then a sum)
    err = {"predict_forest_raw": 0.0, "predict_forest_leaf": 0.0}
    for name, (path, model, cats) in paths.items():
        C = model.num_tree_per_iteration
        packed = pack_ensemble(Booster(model_file=path)._gbdt.models, device=dev)
        X_all = torch.from_numpy(make_rows(np.random.RandomState(args.seed + 1),
                                           SAMPLE_ROWS, model.max_feature_idx + 1,
                                           cats)).to(dev)
        for rows in (SAMPLE_ROWS,) + SERVE_BATCHES:
            X = X_all[:rows].contiguous()
            before = dict(predict_cuda.launches)
            leaf = predict_cuda.forest_leaf_indices(packed, X)
            raw = predict_cuda.forest_raw(packed, X, C)
            raw2 = predict_cuda.forest_raw(packed, X, C)
            torch.cuda.synchronize()
            check(predict_cuda.launches["predict_forest_raw"]
                  == before["predict_forest_raw"] + 2, f"{name}: raw launch count")
            check(predict_cuda.launches["predict_forest_leaf"]
                  == before["predict_forest_leaf"] + 1, f"{name}: leaf launch count")
            ref_leaf = _traverse_leaves(packed, X)
            ref_raw = _predict_raw_fused(packed, X, C)
            check(torch.equal(leaf, ref_leaf), f"{name} at {rows} rows: leaf indices differ")
            check(torch.equal(raw, raw2), f"{name} at {rows} rows: two launches differ")
            check(torch.equal(raw, ref_raw),
                  f"{name} at {rows} rows: raw scores not bit-equal to the plain version")
            check(bool(torch.isfinite(raw).all()), f"{name}: non-finite scores")
            delta = (raw.double() - ref_raw.double()).abs()
            err["predict_forest_raw"] = max(err["predict_forest_raw"], float(delta.max()))
            err["predict_forest_leaf"] = max(
                err["predict_forest_leaf"],
                float((leaf.long() - ref_leaf.long()).abs().max()))
        plans = {rows: predict_cuda.forest_plan(rows, packed.num_trees, X_all.shape[1],
                                                packed.records.shape[1]).split
                 for rows in (SAMPLE_ROWS,) + SERVE_BATCHES}
        print(f"kernels: {name}: {packed.num_trees} trees, C={C}, at "
              + ", ".join(f"{r} rows ({'split' if sp else 'all-trees'} plan)"
                          for r, sp in plans.items())
              + ": leaf indices equal, raw scores bit-equal to the plain version, two "
              "launches bit-equal")
        del ref_leaf, ref_raw, X_all
    torch.cuda.empty_cache()

    # timings at the main path's shapes: the streamed chunk for the raw
    # kernel, the pred_leaf slice for the leaf kernel
    booster = Booster(model_file=paths["higgs"][0])
    packed = booster._gbdt._packed()
    F = HIGGS["n_features"]
    chunk = 1 << 18
    xs = [torch.from_numpy(make_rows(np.random.RandomState(args.seed + 2 + i),
                                     chunk, F)).to(dev) for i in range(4)]
    # the kernel reads the packed node records and the categorical bitsets
    table_bytes = sum(t.numel() * t.element_size() for t in (packed.records, packed.cat_table))
    visits = float(leaf_depths(higgs.trees, dev).reshape(-1)[
        (torch.arange(packed.num_trees, device=dev)[None, :]
         * packed.leaf_value.shape[1]
         + predict_cuda.forest_leaf_indices(packed, xs[0]).long())].sum())
    # four inputs in turn (117 MB in all, past the 50 MB L2): each launch
    # reads its X from device memory, as a freshly uploaded chunk would be
    rotation = itertools.cycle(xs)
    ms_raw = cuda_ms(lambda: predict_cuda.forest_raw(packed, next(rotation), 1), 20)
    plain_raw = cuda_ms(lambda: _predict_raw_fused(packed, xs[0], 1), 2)
    check(torch.equal(predict_cuda.forest_raw(packed, xs[0], 1),
                      _predict_raw_fused(packed, xs[0], 1)),
          f"predict_forest_raw at {chunk}x{F}: differs from the plain version")
    for rows in SERVE_BATCHES:
        x = xs[2][:rows].contiguous()
        check(torch.equal(predict_cuda.forest_raw(packed, x, 1), _predict_raw_fused(packed, x, 1)),
              f"predict_forest_raw at {rows}x{F}: differs from the plain version")
    T = packed.num_trees
    cost_raw = perfmodel.traversal_raw(chunk, F, T, table_bytes, visits)
    # the serving batcher's shapes: one request, a few coalesced, a full batch
    ms_batches = {rows: cuda_ms(lambda x=xs[2][:rows].contiguous(): predict_cuda.forest_raw(
        packed, x, 1), 20) for rows in SERVE_BATCHES}
    # device time of a serving batch's kernels (the walk, and the sum of the
    # split plan) apart from the call's host work
    dev_batches = {rows: device_busy_share(lambda x=xs[2][:rows].contiguous(): [
        predict_cuda.forest_raw(packed, x, 1) for _ in range(5)]) for rows in SERVE_BATCHES}
    x_leaf = xs[1][:SAMPLE_ROWS].contiguous()
    ms_leaf = cuda_ms(lambda: predict_cuda.forest_leaf_indices(packed, x_leaf), 20)
    plain_leaf = cuda_ms(lambda: _traverse_leaves(packed, x_leaf), 2)
    # the same data profile over a quarter of the rows: a quarter of the visits
    cost_leaf = perfmodel.traversal_leaf(SAMPLE_ROWS, F, T, table_bytes,
                                         visits * SAMPLE_ROWS / chunk)
    torch.cuda.empty_cache()

    # the accumulate mode (prediction early stopping's block): ES_FREQ trees
    # added onto running sums, on the streamed chunk and at serving sizes
    es_slice = packed.tree_slice(0, ES_FREQ)
    acc_init = torch.from_numpy(np.random.RandomState(args.seed + 20).normal(
        size=(chunk, 1)).astype(np.float32)).to(dev)
    err_acc = 0.0
    for rows in (chunk,) + SERVE_BATCHES:
        x, init = xs[3][:rows].contiguous(), acc_init[:rows].contiguous()
        got = predict_cuda.forest_raw(es_slice, x, 1, out=init.clone(), accumulate=True)
        want = _predict_raw_fused(es_slice, x, 1, init)
        check(torch.equal(got, want), f"predict_forest_raw_acc at {rows}x{F}: differs from "
                                      "the plain version")
        err_acc = max(err_acc, float((got.double() - want.double()).abs().max()))
    acc_buf = acc_init.clone()
    ms_acc = cuda_ms(lambda: predict_cuda.forest_raw(es_slice, next(rotation), 1, out=acc_buf,
                                                     accumulate=True), 20)
    plain_acc = cuda_ms(lambda: _predict_raw_fused(es_slice, xs[0], 1, acc_init), 2)
    depth_acc = leaf_depths(higgs.trees[:ES_FREQ], dev)
    visits_acc = float(depth_acc.reshape(-1)[
        (torch.arange(ES_FREQ, device=dev)[None, :] * depth_acc.shape[1]
         + predict_cuda.forest_leaf_indices(es_slice, xs[0]).long())].sum())
    es_table_bytes = sum(t.numel() * t.element_size() for t in (es_slice.records,))
    bound_acc, by_acc = bound(perfmodel.traversal_accumulate(chunk, F, ES_FREQ,
                                                             es_table_bytes, visits_acc))
    print(f"{tag} predict_forest_raw_acc {chunk}x{F}, {ES_FREQ} trees added onto running "
          f"sums: kernel {ms_acc:.4f} ms, plain {plain_acc:.2f} ms, bound {bound_acc:.4f} ms "
          f"({by_acc}); bit-equal to the plain version there and at "
          + ", ".join(str(r) for r in SERVE_BATCHES) + " rows")
    del acc_buf, acc_init

    bound_raw, by_raw = bound(cost_raw)
    bound_leaf, by_leaf = bound(cost_leaf)
    print(f"{tag} predict_forest_raw {chunk}x{F}, {T} trees: kernel "
          f"{ms_raw:.4f} ms, plain {plain_raw:.2f} ms, bound {bound_raw:.4f} ms "
          f"({by_raw}); mean nodes visited per (row, tree) {visits / chunk / T:.3f}")
    print(f"{tag} predict_forest_raw at serving batch rows: " + ", ".join(
        f"{rows}: {ms:.4f} ms" for rows, ms in ms_batches.items()))
    for rows, busy in dev_batches.items():
        print(f"{tag}   {rows} rows, device time a call (torch.profiler, 5 calls): "
              + ("not measured (the profiler saw no device time)" if busy is None else
                 f"{busy[0] / 5 * 1e3:.4f} ms; kernels over the 5 calls: {busy[2]}"))
    print(f"{tag} predict_forest_leaf {SAMPLE_ROWS}x{F}, {T} trees: kernel "
          f"{ms_leaf:.4f} ms, plain {plain_leaf:.2f} ms, bound {bound_leaf:.4f} ms "
          f"({by_leaf})")

    # ------------------------- kernels of the training path vs plain
    t0 = time.perf_counter()
    X_train, y_train = higgs_rows(args.seed + 5, TRAIN_ROWS)
    X_valid, y_valid = higgs_rows(args.seed + 6, VALID_ROWS)
    train_set = lt.Dataset(X_train, label=y_train,
                           params={"max_bin": TRAIN_PARAMS["max_bin"]}).construct()
    core = train_set._handle
    num_bins = int(core.group_bin_counts().max())
    bins_d = torch.from_numpy(core.bins).to(dev)
    print(f"train data: {TRAIN_ROWS} x {core.num_total_features} rows binned into "
          f"{core.num_groups} groups of <= {num_bins} bins ({core.bins.dtype}) in "
          f"{time.perf_counter() - t0:.1f} s; positives {y_train.mean():.3f}")
    err_hist, ms_hist, bound_hist, (gh_d, idx_d) = check_histogram(
        dev, bins_d, TRAIN_ROWS, num_bins, args.seed + 7)
    print(f"kernels: histogram {core.num_groups}x{TRAIN_ROWS}x{num_bins} at the root, a "
          f"{LEAF_ROWS}-row and a {SMALL_LEAF_ROWS}-row leaf: bit-equal to the plain "
          f"fixed-point emulation, exact on snapped gradients and in the integer mode, max "
          f"|d| {err_hist:.3g} otherwise (within the float32 summation bound), two launches "
          f"bit-equal")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, rows in (("root", TRAIN_ROWS), ("leaf", LEAF_ROWS), ("small", SMALL_LEAF_ROWS),
                       ("leaf_contiguous", LEAF_ROWS)):
        gb, blocks = hist_cuda.rows_launch_shape(rows, core.num_groups, num_bins, 3, False,
                                                 n_sms)
        what = {"root": "root", "leaf": "leaf", "small": "small leaf",
                "leaf_contiguous": "leaf of consecutive rows"}[name]
        print(f"{tag} histogram {what}, {rows} rows: kernel "
              f"{fmt_ms(ms_hist[name + '_device'])} device (torch.profiler), "
              f"{fmt_ms(ms_hist[name + '_events'])} of device events a call (zeroing, "
              f"kernel, conversion), {ms_hist[name]:.4f} ms a call back to back; plain "
              f"{ms_hist['plain_' + name]:.3f} ms, bound {bound_hist[name][0]:.4f} ms "
              f"({bound_hist[name][1]}); launch {blocks} x {-(-core.num_groups // gb)} "
              f"blocks of {hist_cuda.THREADS} threads, {gb} groups each, "
              f"{hist_cuda.rows_smem_bytes(gb, num_bins, 3, False)} bytes of dynamic shared "
              f"memory a block")
    print(f"{tag} histogram root through the identity row set: plain "
          f"{ms_hist['plain_root_identity']:.3f} ms")
    print(f"{tag} histogram root, the library call (index_add_ over the flat bin index, "
          f"in no fixed order): {ms_hist['library_root']:.4f} ms a call")
    err_scan, ms_scan, bound_scan, F_scan, B_scan = check_split_scan(
        dev, core, bins_d, num_bins, gh_d, idx_d)
    print(f"kernels: split scan {F_scan}x{B_scan} on the root and a leaf, with and "
          f"without a feature mask: records equal to the CPU plain version, gain "
          f"max |d| {err_scan:.3g}")
    warps, smem = scan_cuda.launch_shape(F_scan, B_scan)
    print(f"  split kernel launch: a block of {warps} warps a leaf (a warp a feature), "
          f"{smem} bytes of dynamic shared memory a block")
    print(f"{tag} split scan {F_scan}x{B_scan}: kernel {fmt_ms(ms_scan.get('kernel_device'))} "
          f"device (torch.profiler), {ms_scan['kernel']:.4f} ms a call back to back, "
          f"plain {ms_scan['plain']:.3f} ms, bound {bound_scan[0]:.6f} ms "
          f"({bound_scan[1]})")
    err_rag, ms_rag, bound_rag, wave_hist, root_hist = check_wave_histogram(
        dev, bins_d, TRAIN_ROWS, num_bins, args.seed + 8)
    print(f"kernels: ragged histogram {core.num_groups}x{TRAIN_ROWS}x{num_bins}, the root "
          f"and {WAVE_K} ranges over about half the rows, each also with every row in bin "
          f"0: exact on snapped gradients and in the integer mode, max |d| {err_rag:.3g} "
          f"otherwise (within the float32 summation bound; bit-equal to the plain "
          f"fixed-point emulation), two launches bit-equal; histogram_slots on "
          f"{SAMPLE_ROWS} rows x {SLOT_SLOTS} slots exact")
    gb_rag, blocks_rag = hist_cuda.ragged_launch_shape(
        core.num_groups, num_bins, 3, False, torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    print(f"  ragged histogram launch: {blocks_rag} x {-(-core.num_groups // gb_rag)} "
          f"persistent blocks of {hist_cuda.THREADS} threads, {gb_rag} groups each, "
          f"{hist_cuda.RAGGED_PLAN_BYTES + gb_rag * num_bins * 7 * 4} bytes of dynamic "
          f"shared memory a block")
    for name, what in (("root", f"root {TRAIN_ROWS} rows"),
                       ("wave", f"{WAVE_K} ranges, about half the rows"),
                       ("dominant_root", f"root {TRAIN_ROWS} rows, every row in bin 0"),
                       ("dominant_wave", f"{WAVE_K} ranges, every row in bin 0"),
                       ("slots", f"histogram_slots {SAMPLE_ROWS} rows x {SLOT_SLOTS} slots")):
        scaling = (f" (with the exponents computed in the call: "
                   f"{ms_rag['scaling_' + name]:.4f} ms)" if "scaling_" + name in ms_rag else "")
        print(f"{tag} ragged histogram {what}: kernel {ms_rag[name]:.4f} ms{scaling}, plain "
              f"{ms_rag['plain_' + name]:.3f} ms, bound {bound_rag[name][0]:.4f} ms "
              f"({bound_rag[name][1]})")
    print(f"{tag} ragged histogram {WAVE_K} ranges, the library call (index_add_ over the "
          f"flat (bin, slot) index, in no fixed order): {ms_rag['library_wave']:.4f} ms a call")
    ms_cmp, bound_cmp = check_compaction(dev, bins_d, TRAIN_ROWS, args.seed + 9)
    print(f"kernels: compaction {core.num_groups}x{TRAIN_ROWS} + [{TRAIN_ROWS}, 5] payload, "
          f"{WAVE_K} ranges: bit-equal to the CPU plain version, two launches bit-equal")
    print(f"{tag} compaction: kernel {ms_cmp['kernel']:.4f} ms, plain {ms_cmp['plain']:.3f} "
          f"ms, index_copy_ {ms_cmp['library']:.4f} ms, bound {bound_cmp[0]:.4f} ms "
          f"({bound_cmp[1]})")
    ms_bscan, bound_bscan, shape_bscan = check_batched_scan(dev, core, num_bins, wave_hist,
                                                            root_hist)
    print(f"kernels: batched split scan {list(shape_bscan)}: records bit-equal to the CPU "
          f"plain version, gains included")
    print(f"{tag} batched split scan {list(shape_bscan)}: kernel "
          f"{fmt_ms(ms_bscan.get('kernel_device'))} device (torch.profiler), "
          f"{ms_bscan['kernel']:.4f} ms a call back to back, plain {ms_bscan['plain']:.3f} ms, "
          f"bound {bound_bscan[0]:.6f} ms ({bound_bscan[1]})")
    err_find, same_find, ms_find, bound_find, (F_find, B_find) = check_find_split(
        dev, core, bins_d, num_bins, gh_d, idx_d, wave_hist, root_hist, args.seed + 10)
    print(f"kernels: find_best_split {F_find}x{B_find} on the root, a leaf and a wave's "
          f"{2 * WAVE_K} children, with and without a feature mask, and on one and six "
          f"leaves of an EFB-bundled dataset: records equal to the CPU plain version, gain "
          f"max |d| {err_find:.3g} ({same_find[0]} of {same_find[1]} records bit-equal)")
    print(f"{tag} find_best_split one leaf: kernel {fmt_ms(ms_find['one_device'])} device "
          f"(torch.profiler), {ms_find['one']:.4f} ms a call back to back, plain "
          f"{ms_find['plain_one']:.3f} ms, bound {bound_find['one'][0]:.6f} ms "
          f"({bound_find['one'][1]}); {2 * WAVE_K} leaves: kernel "
          f"{fmt_ms(ms_find['batch_device'])} device, {ms_find['batch']:.4f} ms back to back, "
          f"plain {ms_find['plain_batch']:.3f} ms, bound {bound_find['batch'][0]:.6f} ms "
          f"({bound_find['batch'][1]})")
    print(f"{tag} find_best_split as the learners call it, against the parent's sequence "
          f"(gather, EFB fix, per-feature launch, argmax; the serial one also uploads its "
          f"totals): one leaf device {ms_find['one']:.4f} vs {ms_find['parent_one']:.4f} ms, "
          f"host {ms_find['one_host']:.4f} vs {ms_find['parent_one_host']:.4f} ms a call; "
          f"{2 * WAVE_K} leaves device {ms_find['batch']:.4f} vs {ms_find['parent_batch']:.4f} "
          f"ms, host {ms_find['batch_host']:.4f} vs {ms_find['parent_batch_host']:.4f} ms")
    del bins_d, wave_hist, root_hist, gh_d, idx_d
    torch.cuda.empty_cache()
    kept = record_wave_inputs(lt, train_set, WAVE_PARAMS)
    ms_part, bound_part, (n_part, g_part, k_part, moved, relabeled) = check_partition(
        dev, kept, args.seed + 11)
    ms_step, bound_step, (L_step, K_step, committed) = check_wave_step(dev, kept)
    del kept
    torch.cuda.empty_cache()
    print(f"kernels: wave partition {g_part}x{n_part} + [{n_part}, 5] payload, a real wave's "
          f"{k_part} ranges ({moved['wave']} rows left), the same with random sides "
          f"({moved['random_sides']} left), a bagged initial partition ({moved['bagged']} "
          f"rows in the bag): every output equal to the CPU plain version, two launches "
          f"equal; relabel of a real commit ({relabeled} rows) equal")
    passes = ms_part["passes"]
    print(f"{tag} wave partition: {ms_part['partition']:.4f} ms a call (decide "
          + ", ".join(f"{k.split('_')[0]} {passes.get(k, float('nan')):.4f}"
                      for k in ("decide_kernel", "scan_kernel", "scatter_kernel")).replace(
                          "decide ", "", 1)
          + f" ms, torch.profiler), plain {ms_part['plain']:.3f} ms, index_copy_ "
          f"{ms_part['library']:.4f} ms, bound {bound_part['partition'][0]:.4f} ms "
          f"(bytes; decide {bound_part['decide'][0]:.4f}, scatter "
          f"{bound_part['scatter'][0]:.4f}); relabel {ms_part['relabel']:.4f} ms, plain "
          f"{ms_part['relabel_plain']:.3f} ms, bound {bound_part['relabel'][0]:.6f} ms")
    print(f"{tag} wave partition and relabel as the learner calls them, against the "
          f"parent's sequence (per-row glue, forward map, compaction kernel, slot vector, "
          f"relabel): device {ms_part['this_tree']:.4f} vs {ms_part['parent']:.4f} ms, host "
          f"{ms_part['this_tree_host']:.4f} vs {ms_part['parent_host']:.4f} ms a call")

    print(f"kernels: wave selection and replay on the first, a middle and the last live "
          f"wave of a real tree (L = {L_step}, K = {K_step}; "
          + ", ".join(f"{k} {v} committed" for k, v in committed.items())
          + "): the table, the state after the replay (records, depths, ranges, split-log "
          "bits, scalars, done word) and the commit table equal to the CPU plain version, "
          "two launches equal")
    print(f"{tag} wave_select: kernel {fmt_ms(ms_step['select'])} device (torch.profiler), "
          f"{ms_step['select_events']:.4f} ms a call back to back, plain "
          f"{ms_step['select_plain']:.3f} ms, bound {bound_step['select'][0]:.6f} ms "
          f"({bound_step['select'][1]}); wave_replay (middle wave, {committed['middle']} "
          f"commits): kernel {fmt_ms(ms_step['replay'])} device, plain "
          f"{ms_step['replay_plain']:.3f} ms, bound {bound_step['replay'][0]:.6f} ms "
          f"({bound_step['replay'][1]})")

    kept = record_serial_splits(lt, train_set, TRAIN_PARAMS)
    ms_rp, bound_rp, shapes_rp = check_row_partition(dev, kept)
    del kept
    torch.cuda.empty_cache()
    print("kernels: row partition (decide, scatter) on three real splits of a serial round ("
          + ", ".join(f"{name}: {c} rows of {P} positions, {nl} left"
                      for name, (c, P, nl) in shapes_rp.items())
          + "): both children and the left count equal to the CPU plain version, two "
          "launches equal, RowPartition.split's children equal to the parent's sequence's")
    for name, t in ms_rp.items():
        passes = t["passes"]
        print(f"{tag} row partition {name} ({shapes_rp[name][0]} rows): decide "
              f"{fmt_ms(passes.get('row_decide_kernel'))}, scatter "
              f"{fmt_ms(passes.get('row_scatter_kernel'))} (torch.profiler), plain "
              f"{t['plain']:.3f} ms, bound decide {bound_rp[name]['decide'][0]:.5f}, scatter "
              f"{bound_rp[name]['scatter'][0]:.5f} ms (bytes)")
        print(f"{tag} row partition {name} as the learner calls it (RowPartition.split), "
              f"against the parent's sequence (decision ops, stable argsort, sync, children's "
              f"buffers): device {fmt_ms(t['device'])} vs {fmt_ms(t['parent_device'])} a "
              f"call, {t['ops']} vs {t['parent_ops']} device operations a call; host "
              f"{t['host']:.4f} vs {t['parent_host']:.4f} ms a call")

    # ------------------------------- the card trains as the CPU does
    exact = {}
    for where, extra in (("card", {}), ("cpu", {"device_type": "cpu"})):
        t = time.perf_counter()
        bst = lt.train({**TRAIN_PARAMS, "objective": snapped_logloss, **extra},
                       lt.Dataset(X_train[:EXACT_ROWS], label=y_train[:EXACT_ROWS]),
                       num_boost_round=EXACT_ROUNDS)
        exact[where] = (bst.model_to_string(), time.perf_counter() - t,
                        [tr.num_leaves for tr in bst._gbdt.models])
    check(exact["card"][0] == exact["cpu"][0],
          "exact: the card's model text differs from the CPU's on snapped gradients")
    print(f"exact: {EXACT_ROWS} rows, {EXACT_ROUNDS} rounds, snapped gradients: "
          f"card and CPU model texts byte-equal ({len(exact['card'][0])} bytes; "
          f"leaves {exact['card'][2]}; card {exact['card'][1]:.1f} s, CPU "
          f"{exact['cpu'][1]:.1f} s)")
    # the wave learner: lt.train on the card against a CPU GBDT whose learner
    # is the port's DeviceTreeLearner (the CPU's factory picks the serial one)
    X_exact, y_exact = X_train[:EXACT_ROWS], y_train[:EXACT_ROWS]
    for bagging in ({}, {"bagging_fraction": 0.8, "bagging_freq": 1}):
        t = time.perf_counter()
        card_bst = lt.train({**WAVE_PARAMS, "objective": snapped_logloss, **bagging},
                            lt.Dataset(X_exact, label=y_exact), num_boost_round=EXACT_ROUNDS)
        t_card = time.perf_counter() - t
        check(isinstance(card_bst._gbdt.tree_learner, DeviceTreeLearner),
              "exact (wave): the card did not train through the wave learner")
        t = time.perf_counter()
        host_set = lt.Dataset(X_exact, label=y_exact)
        host = lt.Booster({**WAVE_PARAMS, **bagging, "objective": "none",
                           "device_type": "cpu", "num_iterations": EXACT_ROUNDS}, host_set)
        host._gbdt.tree_learner = DeviceTreeLearner(host._gbdt.config, host_set._handle,
                                                    torch.device("cpu"))
        for _ in range(EXACT_ROUNDS):
            host.update(fobj=snapped_logloss)
        t_host = time.perf_counter() - t
        text = card_bst.model_to_string()
        check(text == host.model_to_string(),
              f"exact (wave{', bagged' if bagging else ''}): the card's model text differs "
              "from the CPU wave learner's on snapped gradients")
        print(f"exact (wave{', bagging 0.8' if bagging else ''}): {EXACT_ROWS} rows, "
              f"{EXACT_ROUNDS} rounds, snapped gradients: card and CPU wave-learner model "
              f"texts byte-equal ({len(text)} bytes; leaves "
              f"{[tr.num_leaves for tr in card_bst._gbdt.models]}; card {t_card:.1f} s, "
              f"CPU {t_host:.1f} s)")

    # ------------------------------------------- main path: the booster
    predict_cuda.reset_launches()
    X_main = make_rows(np.random.RandomState(args.seed + 3), MAIN_ROWS, F)
    booster.predict(X_main)  # warm-up
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        pred = booster.predict(X_main)
        walls.append(time.perf_counter() - t)
    check(pred.shape == (MAIN_ROWS,) and bool(np.isfinite(pred).all())
          and bool(((pred > 0) & (pred < 1)).all()),
          "booster: predictions are not finite probabilities of shape [N]")
    # the streamed raw scores against the CPU Booster on both sides of every
    # chunk boundary, read from the streamed result itself
    host = Booster(model_file=paths["higgs"][0], params={"device_type": "cpu"})
    streamed = booster.predict(X_main, raw_score=True)
    edge = 512
    for b in range(0, MAIN_ROWS + 1, chunk):
        lo, hi = max(0, b - edge), min(MAIN_ROWS, b + edge)
        check(bool(np.array_equal(streamed[lo:hi],
                                  host.predict(X_main[lo:hi], raw_score=True))),
              f"booster: streamed raw scores in rows [{lo}, {hi}) differ "
              "from the CPU Booster's")
    n_ref = 4096
    check(bool(np.array_equal(booster.predict(X_main[:n_ref], pred_leaf=True),
                              host.predict(X_main[:n_ref], pred_leaf=True))),
          "booster: card leaf indices differ from the CPU Booster's")
    wall = min(walls)
    print(f"{tag} booster: predict {MAIN_ROWS} rows in {wall * 1e3:.1f} ms "
          f"(best of 3; {MAIN_ROWS / wall:,.0f} rows/s), streamed in "
          f"{MAIN_ROWS // chunk} chunks; raw kernel alone {ms_raw * (MAIN_ROWS // chunk):.1f} ms")
    # prediction early stopping (binary margin 2 |score|, every ES_FREQ
    # iterations): the active rows of each block through the accumulate mode
    from lightgbm_tpu_torch.utils.timer import global_timer

    es_kw = {"pred_early_stop": True, "pred_early_stop_freq": ES_FREQ}
    es_walls = []
    for _ in range(3):
        before = global_timer.counters.get("predict_early_stop_row_trees", 0)
        t = time.perf_counter()
        pred_es = booster.predict(X_main, raw_score=True, pred_early_stop_margin=ES_MARGIN,
                                  **es_kw)
        es_walls.append(time.perf_counter() - t)
        walked = global_timer.counters["predict_early_stop_row_trees"] - before
    stopped = float(np.mean(pred_es != streamed))
    check(bool(np.array_equal(pred_es[:ES_CPU_ROWS], host.predict(
        X_main[:ES_CPU_ROWS], raw_score=True, pred_early_stop_margin=ES_MARGIN, **es_kw))),
        "early stop: the card's early-stopped scores differ from the CPU's")
    check(bool(np.array_equal(booster.predict(X_main, raw_score=True,
                                              pred_early_stop_margin=float("inf"), **es_kw),
                              streamed)),
          "early stop: an infinite margin does not give the full prediction bit for bit")
    check(0.0 < stopped < 1.0, f"early stop: {stopped:.3f} of the rows stopped")
    es_wall = min(es_walls)
    print(f"{tag} booster: predict {MAIN_ROWS} rows with early stopping (margin {ES_MARGIN:g} "
          f"on 2 |score|, every {ES_FREQ} iterations) in {es_wall * 1e3:.1f} ms (best of 3; "
          f"{MAIN_ROWS / es_wall:,.0f} rows/s, {wall / es_wall:.2f}x the full predict's "
          f"rows/s); {stopped:.1%} of the rows stopped before the last tree, "
          f"{walked / MAIN_ROWS:.1f} of {packed.num_trees} trees walked a row on average; "
          f"the first {ES_CPU_ROWS} rows bit-equal to the CPU Booster's early stop, an "
          f"infinite margin bit-equal to the full prediction")
    del host

    # ------------------------------------------- main path: serving
    svc = PredictionService(max_batch_rows=4096, min_bucket=64,
                            batch_window_s=0.001)
    server, server_thread = serve(svc, port=0)
    base = f"http://127.0.0.1:{server.port}"
    try:
        req = urllib.request.Request(
            base + "/models", data=json.dumps(
                {"name": "higgs", "path": paths["higgs"][0]}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            check(resp.status == 200, "serving: model upload refused")
        launches_before = predict_cuda.launches["predict_forest_raw"]
        batches_before = svc.batcher.stats()["batches"]
        X_serve = make_rows(np.random.RandomState(args.seed + 4),
                            SERVE_REQUESTS * SERVE_ROWS, F)
        answers = [None] * SERVE_REQUESTS
        failures = []
        latencies = []

        def client(worker):
            for i in range(worker, SERVE_REQUESTS, SERVE_THREADS):
                rows = X_serve[i * SERVE_ROWS:(i + 1) * SERVE_ROWS]
                raw = i % 4 == 0
                t = time.perf_counter()
                if i % 2:
                    body = wire.encode_request("higgs", rows, raw)
                    ctype = wire.CONTENT_TYPE
                else:
                    body = json.dumps({"model": "higgs", "raw_score": raw, "rows": [
                        [None if np.isnan(v) else float(v) for v in r]
                        for r in rows]}).encode()
                    ctype = "application/json"
                r = urllib.request.Request(base + "/predict", data=body,
                                           headers={"Content-Type": ctype},
                                           method="POST")
                try:
                    with urllib.request.urlopen(r, timeout=120) as resp:
                        payload = resp.read()
                except Exception as exc:  # noqa: BLE001 - reported below
                    failures.append(f"request {i}: {exc!r}")
                    continue
                latencies.append(time.perf_counter() - t)
                preds = (wire.decode_response(payload)[0] if i % 2 else
                         np.asarray(json.loads(payload)["predictions"],
                                    dtype=np.float32))
                answers[i] = (preds, raw)

        threads = [threading.Thread(target=client, args=(w,))
                   for w in range(SERVE_THREADS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        serve_wall = time.perf_counter() - t
        check(not any(th.is_alive() for th in threads), "serving: clients hung")
        check(not failures, "serving: " + "; ".join(failures[:5]))
        stats = svc.stats()
        batches = stats["batcher"]["batches"] - batches_before
        grew = predict_cuda.launches["predict_forest_raw"] - launches_before
        check(grew >= batches, f"serving: {grew} kernel launches for {batches} batches")
        for i, (preds, raw) in enumerate(answers):
            want = booster.predict(X_serve[i * SERVE_ROWS:(i + 1) * SERVE_ROWS],
                                   raw_score=raw)
            check(bool(np.array_equal(preds, want)),
                  f"serving: request {i} differs from Booster.predict")
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        check(health["status"] == "ok", f"serving: /healthz says {health}")
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        server_thread.join(timeout=10)
    lat = sorted(latencies)
    print(f"{tag} serving: {SERVE_REQUESTS} requests x {SERVE_ROWS} rows from "
          f"{SERVE_THREADS} threads in {serve_wall:.3f} s "
          f"({SERVE_REQUESTS * SERVE_ROWS / serve_wall:,.0f} rows/s); client "
          f"p50 {lat[len(lat) // 2] * 1e3:.2f} ms p99 "
          f"{lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3:.2f} ms; "
          f"{batches} batches, {grew} kernel launches")
    for stage, q in stats["stages"].items():
        print(f"{tag}   stage {stage}: p50 {q['p50_ms']} ms p99 {q['p99_ms']} ms "
              f"(n={q['count']})")
    serve_launches = dict(predict_cuda.launches)
    for name, n in serve_launches.items():
        check(n > 0, f"serving path: kernel {name} never launched")
    check(global_timer.counters.get("serve_dispatch_failures", 0) == 0
          and global_timer.counters.get("serve_breaker_shed", 0) == 0
          and stats["batcher"]["device_failures"] == 0
          and stats["batcher"]["breaker_shed"] == 0,
          "serving: a dispatch failed or a request was shed")
    print(f"serving path launches: {serve_launches}")
    tmp.cleanup()
    del X_main, streamed
    torch.cuda.empty_cache()

    # ------------------------------- main path: training, wave learner
    libs = (predict_cuda, hist_cuda, scan_cuda, compact_cuda.LIB, compact_cuda.WAVE_LIB,
            partition_cuda.LIB, wave_cuda.LIB, quantize_cuda)
    valid = (X_valid, y_valid)
    wave = drive_training(lt, libs, WAVE_PARAMS, train_set, valid, TRAIN_ROUNDS,
                          ("histogram_slots_ragged_image", "histogram_image_to_float", "partition_decide", "partition_scan",
                           "partition_scatter", "relabel_rows", "find_best_split",
                           "find_best_split_batched", "wave_select", "wave_replay",
                           "tree_loop_cond", "predict_forest_raw"), tag, "wave")
    check(isinstance(wave["learner"], DeviceTreeLearner),
          "train (wave): lt.train did not grow its trees with the wave learner")
    # phase 21 holds its gang's models to this text (later phases roll the
    # booster back and refit it)
    PHASE_MODELS["wave"] = wave["booster"].model_to_string()
    if args.seed == 0:
        check(all(abs(a - r) <= 0.002 for a, r in zip(wave["auc"], WAVE_AUC_SEED0)),
              f"train (wave): train / valid AUC {wave['auc']} not within 0.002 of "
              f"{WAVE_AUC_SEED0}")
    # the root histograms N rows, and a wave only the smaller children of
    # disjoint leaves, at most N/2 rows: a tree's bound by design (the
    # O(N * waves) form of a full-row wave histogram would pass it)
    rows = np.asarray(wave["hist_rows"], dtype=np.float64)
    design = TRAIN_ROWS * (1 + wave["waves"] / 2)
    check(bool((rows <= design).all()),
          f"train (wave): a tree histogrammed more than N * (1 + waves / 2) rows: "
          f"{wave['hist_rows']} with {[int(w) for w in wave['waves']]} waves")
    c = wave["counters"]
    print(f"{tag} train (wave): per tree {c['device_waves'] / TRAIN_ROUNDS:.1f} waves "
          f"({[int(w) for w in wave['waves']]}), {c['wave_splits_committed'] / TRAIN_ROUNDS:.1f} "
          f"splits "
          f"committed of {c['wave_splits_speculated'] / TRAIN_ROUNDS:.1f} speculated; rows "
          f"histogrammed per tree (N = {TRAIN_ROWS}) "
          + ", ".join(f"{r / TRAIN_ROWS:.2f}N" for r in rows)
          + f" (mean {rows.mean() / TRAIN_ROWS:.2f}N; bound N * (1 + waves / 2) "
          f"{design.min() / TRAIN_ROWS:.1f}N-{design.max() / TRAIN_ROWS:.1f}N; "
          f"{int((rows <= 4 * TRAIN_ROWS).sum())} of {TRAIN_ROUNDS} trees at most 4N); "
          f"wave width at the end {c.get('wave_k')}")

    check_booster_surface(lt, wave["booster"], tag)

    # ------------------------------- training, serial learner
    serial = drive_training(lt, libs, TRAIN_PARAMS, train_set, valid, SERIAL_ROUNDS,
                            ("histogram", "find_best_split", "row_partition_decide",
                             "row_partition_scatter", "predict_forest_raw"), tag, "serial")
    PHASE_MODELS["serial"] = serial["booster"].model_to_string()
    if args.seed == 0:
        check(all(abs(a - r) <= 0.002 for a, r in zip(serial["auc"], SERIAL_AUC_SEED0)),
              f"train (serial): train / valid AUC {serial['auc']} not within 0.002 of "
              f"{SERIAL_AUC_SEED0}")
    print(f"training path launches per learner: wave {wave['launches']}; serial "
          f"{serial['launches']}")
    # the tree graph's loop condition, against the host's loop on the card
    ms_loop, bound_loop, loop_passes = check_tree_loop(wave["learner"])
    print(f"{tag} kernels: tree_loop_cond: the last tree grown again by its tree graph "
          f"({loop_passes} passes) and by the host's loop on the same inputs: split log, "
          f"scalars and passes equal; the kernel {fmt_ms(ms_loop['kernel'])} of device time "
          f"a launch (torch.profiler), the plain condition (one read of the done word on "
          f"the host) {ms_loop['plain']:.4f} ms, bound {bound_loop[0]:.7f} ms "
          f"({bound_loop[1]})")
    torch.cuda.empty_cache()

    # ------------------------------- multiclass, both learners
    mc_launches = drive_multiclass(lt, libs, args.seed, tag)
    check(global_timer.counters.get("serve_dispatch_failures", 0) == 0
          and global_timer.counters.get("serve_breaker_shed", 0) == 0,
          "multiclass serving: a dispatch failed or a request was shed")
    for name in ("histogram_slots_ragged_image", "histogram_image_to_float", "partition_decide", "partition_scan",
                 "partition_scatter", "relabel_rows", "find_best_split",
                 "find_best_split_batched", "wave_select", "wave_replay", "tree_loop_cond",
                 "histogram", "row_partition_decide", "row_partition_scatter",
                 "predict_forest_raw"):
        check(mc_launches[name] > 0, f"multiclass path: kernel {name} never launched")
    torch.cuda.empty_cache()

    # ------------------------------- the async pipeline
    async_launches, _ = drive_async(lt, libs, train_set, tag)
    for name in ("histogram_slots_ragged_image", "histogram_image_to_float", "partition_decide", "partition_scan",
                 "partition_scatter", "relabel_rows", "find_best_split",
                 "find_best_split_batched", "wave_select", "wave_replay", "tree_loop_cond"):
        check(async_launches[name] > 0, f"async path: kernel {name} never launched")
    torch.cuda.empty_cache()

    # ------------------------------- quantized-gradient training
    q_launches, q_times = drive_quantized(lt, libs, train_set, valid, X_train, y_train,
                                          {"wave": wave, "serial": serial}, args.seed, tag)
    for name in ("quantize_reduce", "quantize", "histogram_slots_ragged_i32",
                 "histogram_i32", "find_best_split_int", "find_best_split_batched_int"):
        check(q_launches[name] > 0, f"quantized path: kernel {name} never launched")
    torch.cuda.empty_cache()

    # ------------------------------- GOSS, both learners
    goss_launches, _ = drive_goss(lt, libs, train_set, valid, X_train, y_train, tag)
    torch.cuda.empty_cache()

    # ------------------------------- categorical features, serial learner
    cat_launches, _ = drive_categorical(lt, libs, args.seed, tag)
    torch.cuda.empty_cache()

    # ------------------------------- constraints, CEGB, linear trees
    lane_launches, lanes = drive_constraints(lt, libs, train_set, valid, X_train, y_train,
                                             wave["booster"], tag)
    torch.cuda.empty_cache()

    # ------------------------------- DART, random forests, the life cycle
    life_launches, _ = drive_lifecycle(lt, libs, train_set, valid, X_train, y_train,
                                       wave["booster"], args.seed, tag)
    torch.cuda.empty_cache()

    # ------------------------------- learning to rank, cross entropy
    rank_launches, _ = drive_ranking(lt, libs, train_set, valid, args.seed, tag)
    torch.cuda.empty_cache()

    # ------------------------------- observe and serve
    check(global_timer.counters.get("serve_dispatch_failures", 0) == 0
          and global_timer.counters.get("serve_breaker_shed", 0) == 0,
          "a dispatch failed or a request was shed before phase 18")
    obs_launches, _ = drive_observe(lt, libs, train_set, higgs, multi, args.seed, tag)
    torch.cuda.empty_cache()

    # ------------------------------- the façades
    facade_launches, _ = drive_facades(lt, libs, X_train, y_train, X_valid, y_valid,
                                       args.seed, tag)
    torch.cuda.empty_cache()

    # ------------------------------- single-card streaming
    # (phase 18 fails and sheds requests on purpose: phase 20 adds none)
    shed_before = (global_timer.counters.get("serve_dispatch_failures", 0),
                   global_timer.counters.get("serve_breaker_shed", 0))
    stream_paths, carry_entries = drive_stream(lt, libs, X_train, y_train, train_set, serial,
                                               args.seed, tag)
    check((global_timer.counters.get("serve_dispatch_failures", 0),
           global_timer.counters.get("serve_breaker_shed", 0)) == shed_before,
          "phase 20: a dispatch failed or a request was shed")
    torch.cuda.empty_cache()

    # ------------------------------- phase 21: the distributed learners
    gang_launches, gang_ranks = drive_distributed(lt, wave, serial, X_train, y_train,
                                                  args.seed, tag)
    gang_launches = collections.defaultdict(int, gang_launches)

    # ------------------------------- phase 22: the gang's failure handling
    elastic_launches = drive_elastic(lt, gang_ranks, args.seed, tag)
    paths = (wave["launches"], serial["launches"], mc_launches, async_launches, q_launches,
             goss_launches, cat_launches, lane_launches, life_launches, rank_launches,
             obs_launches, facade_launches, *stream_paths.values(), gang_launches,
             elastic_launches)

    def launches(name):
        return serve_launches.get(name, 0) + sum(p[name] for p in paths)

    kernels = [
        {"name": "predict_forest_raw", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/predict_forest.cu",
         "replaces": "lightgbm_tpu/ops/predict_pallas.py:80",
         "launches": launches("predict_forest_raw"),
         "max_abs_err": err["predict_forest_raw"], "ms": ms_raw,
         "plain_ms": plain_raw, "bound_ms": bound_raw, "bound_by": by_raw,
         "library_ms": None},
        # the raw mode adding onto running sums: prediction early stopping's
        # block of ES_FREQ trees over the active rows
        {"name": "predict_forest_raw_acc", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/predict_forest.cu",
         "replaces": "lightgbm_tpu/ops/predict_pallas.py:80",
         "launches": launches("predict_forest_raw_acc"),
         "max_abs_err": err_acc, "ms": ms_acc, "plain_ms": plain_acc, "bound_ms": bound_acc,
         "bound_by": by_acc, "library_ms": None},
        {"name": "predict_forest_leaf", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/predict_forest.cu",
         "replaces": "lightgbm_tpu/ops/predict_pallas.py:41",
         "launches": launches("predict_forest_leaf"),
         "max_abs_err": err["predict_forest_leaf"], "ms": ms_leaf,
         "plain_ms": plain_leaf, "bound_ms": bound_leaf, "bound_by": by_leaf,
         "library_ms": None},
        {"name": "histogram", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/histogram.cu",
         "replaces": "lightgbm_tpu/ops/hist_pallas.py:132",
         "launches": launches("histogram"),
         "max_abs_err": err_hist, "ms": device_or_events(ms_hist, "root"),
         "plain_ms": ms_hist["plain_root"], "bound_ms": bound_hist["root"][0],
         "bound_by": bound_hist["root"][1], "library_ms": ms_hist["library_root"]},
        {"name": "split_scan", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/split_find.cu",
         "replaces": "lightgbm_tpu/ops/scan_pallas.py:235",
         "launches": launches("split_scan"),
         "max_abs_err": err_scan, "ms": device_or_events(ms_scan, "kernel"),
         "plain_ms": ms_scan["plain"], "bound_ms": bound_scan[0],
         "bound_by": bound_scan[1], "library_ms": None},
        {"name": "split_scan_batched", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/split_find.cu",
         "replaces": "lightgbm_tpu/ops/scan_pallas.py:235",
         "launches": launches("split_scan_batched"),
         "max_abs_err": 0.0, "ms": device_or_events(ms_bscan, "kernel"),
         "plain_ms": ms_bscan["plain"], "bound_ms": bound_bscan[0],
         "bound_by": bound_bscan[1], "library_ms": None},
        # the float mode converting in its own launch: since phase 21 came the
        # float wave paths take the image mode and the conversion kernel
        # (their rows below), so no main path launches it
        {"name": "histogram_slots_ragged", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/histogram.cu",
         "replaces": "lightgbm_tpu/ops/hist_pallas.py:350",
         "launches": launches("histogram_slots_ragged"),
         "max_abs_err": err_rag, "ms": ms_rag["wave"],
         "plain_ms": ms_rag["plain_wave"], "bound_ms": bound_rag["wave"][0],
         "bound_by": bound_rag["wave"][1], "library_ms": ms_rag["library_wave"]},
        # the same kernel over every row; nothing in either package's main
        # paths calls it, so it launches on none of them
        {"name": "histogram_slots", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/histogram.cu",
         "replaces": "lightgbm_tpu/ops/hist_pallas.py:229",
         "launches": 0, "max_abs_err": 0.0, "ms": ms_rag["slots"],
         "plain_ms": ms_rag["plain_slots"], "bound_ms": bound_rag["slots"][0],
         "bound_by": bound_rag["slots"][1], "library_ms": ms_rag["library_slots"]},
        # phase 21: row 2's kernel leaving its image unconverted (the sums the
        # gang's ranks add, and the single-card wave's exact pool), and the
        # conversion kernel, image -> float32 (every float histogram's last
        # step; the leaf histogram's image mode is row 5's: the host-driven
        # data-parallel learner's)
        {"name": "histogram_slots_ragged_image", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/histogram.cu",
         "replaces": "lightgbm_tpu/ops/hist_pallas.py:350",
         "launches": launches("histogram_slots_ragged_image"), "max_abs_err": 0.0,
         "ms": ms_rag["image_wave"], "plain_ms": ms_rag["plain_image_wave"],
         "bound_ms": bound_rag["image_wave"][0], "bound_by": bound_rag["image_wave"][1],
         "library_ms": None},
        {"name": "histogram_image_to_float", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/histogram.cu",
         "replaces": "lightgbm_tpu/ops/hist_pallas.py:350",
         "launches": launches("histogram_image_to_float"), "max_abs_err": 0.0,
         "ms": ms_rag["convert"], "plain_ms": ms_rag["plain_convert"],
         "bound_ms": bound_rag["convert"][0], "bound_by": bound_rag["convert"][1],
         "library_ms": None},
        {"name": "histogram_image", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/histogram.cu",
         "replaces": "lightgbm_tpu/ops/hist_pallas.py:132",
         "launches": launches("histogram_image"), "max_abs_err": 0.0,
         "ms": ms_rag["image_rows"], "plain_ms": ms_rag["plain_image_rows"],
         "bound_ms": bound_rag["image_rows"][0], "bound_by": bound_rag["image_rows"][1],
         "library_ms": None},
        {"name": "compact_rows", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/compact.cu",
         "replaces": "lightgbm_tpu/ops/compact_pallas.py:313",
         "launches": launches("compact_rows"),
         "max_abs_err": 0.0, "ms": ms_cmp["kernel"],
         "plain_ms": ms_cmp["plain"], "bound_ms": bound_cmp[0],
         "bound_by": bound_cmp[1], "library_ms": ms_cmp["library"]},
        # the split kernel's find form: group histogram -> each leaf's record
        {"name": "find_best_split", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/split_find.cu",
         "replaces": "lightgbm_tpu/ops/scan_pallas.py:235",
         "launches": launches("find_best_split"),
         "max_abs_err": err_find, "ms": device_or_events(ms_find, "one"),
         "plain_ms": ms_find["plain_one"], "bound_ms": bound_find["one"][0],
         "bound_by": bound_find["one"][1], "library_ms": None},
        {"name": "find_best_split_batched", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/split_find.cu",
         "replaces": "lightgbm_tpu/ops/scan_pallas.py:235",
         "launches": launches("find_best_split_batched"),
         "max_abs_err": err_find, "ms": device_or_events(ms_find, "batch"),
         "plain_ms": ms_find["plain_batch"], "bound_ms": bound_find["batch"][0],
         "bound_by": bound_find["batch"][1], "library_ms": None},
    ]
    # the wave partition's three passes (the plain time is the whole
    # partition's, one function) and the commit's relabel
    for name, key, library in (("partition_decide", "decide", None),
                               ("partition_scan", "scan", None),
                               ("partition_scatter", "scatter", ms_part["library"])):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "lightgbm_tpu_torch/csrc/wave_partition.cu",
             "replaces": "lightgbm_tpu/ops/compact_pallas.py:313",
             "launches": launches(name), "max_abs_err": 0.0,
             "ms": ms_part["passes"].get(key + "_kernel", ms_part["partition"]),
             "plain_ms": ms_part["plain"], "bound_ms": bound_part[key][0],
             "bound_by": bound_part[key][1], "library_ms": library})
    # the serial learner's row partition: glue on the leaf histogram's path
    # (row 5 of PERF.md's table), timed at the root split; the plain time is
    # the whole partition's, one function
    for name, key in (("row_partition_decide", "row_decide_kernel"),
                      ("row_partition_scatter", "row_scatter_kernel")):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "lightgbm_tpu_torch/csrc/row_partition.cu",
             "replaces": "lightgbm_tpu/ops/hist_pallas.py:132",
             "launches": launches(name), "max_abs_err": 0.0,
             "ms": ms_rp["root"]["passes"].get(key, ms_rp["root"]["device"]),
             "plain_ms": ms_rp["root"]["plain"],
             "bound_ms": bound_rp["root"][name.split("_")[-1]][0],
             "bound_by": bound_rp["root"][name.split("_")[-1]][1],
             "library_ms": ms_rp["root"]["library"]})
    kernels.append(
        {"name": "relabel_rows", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/wave_partition.cu",
         "replaces": "lightgbm_tpu/ops/compact_pallas.py:313",
         "launches": launches("relabel_rows"), "max_abs_err": 0.0,
         "ms": ms_part["relabel"], "plain_ms": ms_part["relabel_plain"],
         "bound_ms": bound_part["relabel"][0], "bound_by": bound_part["relabel"][1],
         "library_ms": None})
    # the wave's selection and replay: glue of the wave learner folded into
    # kernels (the JAX grower computes it in XLA, no TPU kernel), on the
    # path of rows 2-4's kernels
    for name, key in (("wave_select", "select"), ("wave_replay", "replay")):
        kernels.append(
            {"name": name, "route": "cuda", "source": "lightgbm_tpu_torch/csrc/wave_step.cu",
             "replaces": "lightgbm_tpu/treelearner/device.py:575",
             "launches": launches(name), "max_abs_err": 0.0,
             "ms": ms_step[key] if ms_step[key] is not None else ms_step.get(key + "_events"),
             "plain_ms": ms_step[key + "_plain"], "bound_ms": bound_step[key][0],
             "bound_by": bound_step[key][1], "library_ms": None})
    kernels.append(
        {"name": "tree_loop_cond", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/wave_step.cu",
         "replaces": "lightgbm_tpu/treelearner/device.py:838",
         "launches": launches("tree_loop_cond"), "max_abs_err": 0.0,
         "ms": ms_loop["kernel"], "plain_ms": ms_loop["plain"], "bound_ms": bound_loop[0],
         "bound_by": bound_loop[1], "library_ms": None})
    # quantized training: the discretizer (glue the JAX package computes in
    # XLA) and the integer modes of rows 2, 4 and 5's kernels
    (t_quant, b_quant), (t_modes, b_modes) = q_times["quantize"], q_times["modes"]
    for name in ("quantize_reduce", "quantize"):
        kernels.append(
            {"name": name, "route": "cuda", "source": "lightgbm_tpu_torch/csrc/quantize.cu",
             "replaces": "lightgbm_tpu/ops/quantize.py:45",
             "launches": launches(name), "max_abs_err": 0.0,
             "ms": t_quant.get(name + "_kernel", t_quant["kernel"]),
             "plain_ms": t_quant["plain"], "bound_ms": b_quant[name][0],
             "bound_by": b_quant[name][1], "library_ms": None})
    for name, key, source, replaces in (
            ("histogram_i32", "rows", "histogram.cu", "lightgbm_tpu/ops/hist_pallas.py:132"),
            ("histogram_slots_ragged_i32", "ragged", "histogram.cu",
             "lightgbm_tpu/ops/hist_pallas.py:350"),
            ("find_best_split_int", "one", "split_find.cu",
             "lightgbm_tpu/ops/scan_pallas.py:235"),
            ("find_best_split_batched_int", "batch", "split_find.cu",
             "lightgbm_tpu/ops/scan_pallas.py:235")):
        kernels.append(
            {"name": name, "route": "cuda", "source": "lightgbm_tpu_torch/csrc/" + source,
             "replaces": replaces, "launches": launches(name), "max_abs_err": 0.0,
             "ms": device_or_events({"k": t_modes[key + "_events"],
                                     "k_device": t_modes[key]}, "k"),
             "plain_ms": t_modes["plain_" + key], "bound_ms": b_modes[key][0],
             "bound_by": b_modes[key][1], "library_ms": None})
    # phase 15: the split kernel's constrained mode, and the linear score
    # (the traversal's leaf mode and the linear epilogue) on rows 4 and 1
    (t_con, b_con), (t_lin, b_lin) = lanes["scan"], lanes["linear_score"]
    kernels.append(
        {"name": "find_best_split_constrained", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/split_find.cu",
         "replaces": "lightgbm_tpu/ops/scan_pallas.py:235",
         "launches": launches("find_best_split_constrained"), "max_abs_err": 0.0,
         "ms": device_or_events({"k": t_con["constrained"],
                                 "k_device": t_con["constrained_device"]}, "k"),
         "plain_ms": t_con["plain"], "bound_ms": b_con[0], "bound_by": b_con[1],
         "library_ms": None})
    kernels.append(
        {"name": "predict_forest_leaf_linear", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/predict_forest.cu",
         "replaces": "lightgbm_tpu/ops/predict_pallas.py:41",
         "launches": lanes["linear_leaf_launches"], "max_abs_err": 0.0,
         "ms": t_lin["ms"], "plain_ms": t_lin["plain"], "bound_ms": b_lin[0],
         "bound_by": b_lin[1], "library_ms": None})
    # phase 20: row 5's kernel carried across the blocks of a streamed plane;
    # its launches are the streamed runs' (float, and integer), phase 22's
    # gang-sharded ones (each rank's carry left open) among them
    for entry in carry_entries:
        entry["launches"] += elastic_launches.get(entry["name"], 0)
    kernels.extend(carry_entries)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
