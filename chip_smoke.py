#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --mesh`` runs the process mesh's phases alone
(6h-6j and parity_mesh with their references) on every visible card: a
world that fits the cards gives each rank a card of its own (NCCL).

Phases (any failure exits non-zero and prints no result line):

1. build     — compile every kernel from ``src/repro_torch/csrc`` with
                ``nvcc`` (one process per source, all started together) and
                load them.
2. kernels   — call each kernel's wrapper on the card at the shapes the
                full-width step gives it (the exact encode bit-equal to its
                plain version, to a second launch and to a launch with
                other splits and pass size, and with NaN, +-inf and
                out-of-range elements planted; the decode with and
                without its first-digit histogram and the top-k select at
                both buckets, with their launch geometry, and the encode
                also at the CLI's default sketch width; the others at
                bucket 0) plus small odd cases and a scores-regime case
                whose heavy set far outnumbers k, hold it against its plain
                PyTorch version, and time kernel, plain version, library
                yardstick and bound; the recovery's old route (decode +
                ``topk_lower_index``) against its new one (decode with
                histogram + select), and one recovery under
                ``torch.cuda.set_sync_debug_mode("error")``. The TS encode
                at both buckets and the CLI's default width, with the plan's
                kernel and (where that is the one-pass kernel) the R-pass
                kernel; the TS route's recovery at both buckets (the row
                transpose, then the TS-map scores kernel with its histogram
                reading it, then the select) against its plain version and
                its old route (``ts.decode`` + ``heavymix(estimates=)``),
                once under the sync check; the transpose and the TS-map
                scores also at the CLI's default width (n_r reaches W).
                NaN: bucket 1's sketch with NaN planted, through the decode,
                the scores and the TS-map scores kernels (bits equal to
                plain, NaN at the same coordinates) and the select (the
                reference's order, NaN first). The select with its slabs
                forced to overflow, in every CTA and in some, on bucket 0's
                est, on the TS scores (all heavy keys tied at 1e30) and on
                the NaN keys: equal to ``topk_lower_index``, the device
                counter equal to the CTAs over capacity.
3. train     — the main path: three gs-SGD steps of qwen3-4b at its
                published widths (depth cut to 2 layers), P=2 workers,
                buckets=2, psum, AdamW, SketchSpec(rows=5, width=None,
                k=None). Both buckets are past 2^22 coordinates, so the
                recovery runs the decode kernel (with its histogram) and
                the select, not the scores kernel; the encode (its
                accumulate and its finish, each a launch counted on its
                own), the decode and the select launch once per recovery:
                12 times each.
4. profile   — one more full-width step under ``torch.profiler``: device
                time per span (loss_and_grad / encode / allreduce / recover
                / optimizer; each device event counted once, in the span
                that holds its launch) and the device's idle share. Not
                counted.
4b. train_traced — the driver's loop (``launch.train.drive``, as ``--trace
                --json`` runs it) at the same cell, from a RunSpec whose d
                is the 2-layer d: three steps untraced, then the same three
                steps with the tracer and the trace@2 recorder (losses
                bit-equal). The trace validates; one probe span (the second
                step's inputs on a copy of the state, output discarded) and
                a step span a step (step 0 warmup); the probe's phases
                backward, encode, comm, recover, optimizer all > 0, a span
                a bucket; the trace@2 document has a record a step,
                ``predicted`` without ``error``, ``recovery_error_probe``
                (its encode and scores-route recovery launched on the card)
                and provenance naming the card. Prints the probe's phases
                beside ``profile``'s spans, the traced steps against the
                untraced, the copy's bytes and the peak; the launches are
                the path's (3 steps + the probe).
4c. train_watched — the same cell with the drift watchdog forced hot
                (warmup 1, delta -1, threshold 0, budget 4): every detection
                reaches a decision, an applied re-plan clears the 1% gain
                bar, and the rebuilt step (the re-plan's exchange at the
                cell's widths) runs at least two steps with finite losses
                and launches what its geometry implies.
5. train_ts  — three steps of the same cell with gs-SGD's TS-sketch encoder
                (``compressor_kw`` ``encoder="ts"``): the TS encode kernel,
                and the recovery through the TS-map scores kernel and the
                select (once per recovery: 12 times); then one more step
                under the profiler, as in 4 (not counted).
6. train_interleave — the same full-width cell at buckets=4 with the
                chunked backward and the fused encode (bwd_chunks=2,
                fuse_encode=True): the partial encodes timed at the
                fragment sizes the cell gives them against the whole-bucket
                encode; three steps, counted (sketch_encode 14 times a step:
                7 fragments x 2 workers; sketch_encode_finish once a bucket
                and step, for both workers; the decode for buckets 0-2, the
                scores kernel for bucket 3, the select for each; no plain
                version called); one more step with each fused sketch held
                against the whole-bucket encode of the same u; one whose
                worker-0 packed gradient of each bucket runs the route's
                kernels bit-equal to plain, timed at these buckets-4
                shapes (interleave_shapes); one profiled step
                (profile_interleave: split, idle share, peak memory); then
                three steps of the same cell with
                bwd_chunks=None from the same seed (train_bucketed4): the
                first losses equal, the later ones within
                INTERLEAVE_LOSS_RTOL, and after the three steps the same
                selected coordinates (EF zero pattern) and the params within
                INTERLEAVE_PARAM_RTOL / _ATOL; one profiled step of it
                (profile_bucketed4). The fragments merged and each fused
                sketch are bit-equal to the whole-bucket encode (the encode
                is exact), and the finish kernel that converts the merged
                exact sketch is timed (its own row). Each bucket's row also
                times the zeroing of one exact accumulator, which every
                partial encode pays.
6b. train_minicpm — minicpm-2b at its published widths (2 layers, tied
                embeddings), P=2, buckets=2, batch 8, seq 64, microbatch 2,
                clip 1.0, AdamW under wsd (lr 0, TRAIN_LR, 0.55 TRAIN_LR at
                steps 0-2), HEAVYMIX's faithful fill: three counted steps
                (sketch_encode, sketch_encode_finish, heavymix_scores with
                its filler operand and topk_select 12 times each, the
                decode never, no plain
                version called); step 0's microbatched loss against the
                full-batch loss and the applied gradient's norm against
                min(grad_norm, clip), within MINICPM_RTOL; a profiled step
                (profile_minicpm); the filler scores kernel at the cell's
                shapes, bit-equal to plain.
6c. train_moe — granite-moe-3b-a800m at its published widths (d_model
                1,536, 24/8 heads, 40 experts top-8 of d_ff 512, vocab
                49,155 padded to 49,280, tied embeddings), 32 -> 4 layers,
                under the main path's exchange (P=2, buckets=2, batch 8,
                seq 64, AdamW, psum, R = 5): d = 478,606,848 in buckets
                (277,022,208, 201,584,640), both past 2^22, so three
                counted steps launch the encode, its finish, the decode and
                the select 12 times each and the scores kernel never; the
                capacity and each step's dropped share of the (token,
                choice) pairs (an untimed no-grad forward before each
                step); one profiled step (profile_moe); then one more step
                whose worker-0 packed gradient of each bucket is run
                through the path's kernels (the encode and its finish, the
                decode, the select) and held bit-equal to their plain
                versions (route checks).
6d. train_hybrid — zamba2-2.7b at its published widths (d_model 2,560,
                32 heads, d_ff 10,240, ssm_state 64, vocab 32,000), 54 ->
                12 layers (two cycles of six Mamba2 blocks and the shared
                attention block): d = 663,336,448; three counted steps as
                in 6c and one profiled step (profile_hybrid); then three
                steps at buckets=4, bwd_chunks=2 (one cycle a chunk),
                fuse_encode (train_hybrid_interleave) against three at
                bwd_chunks=None from the same seed (train_hybrid_bucketed4),
                held as in 6: the first losses equal, the later ones within
                INTERLEAVE_LOSS_RTOL, the same selected coordinates and the
                params within INTERLEAVE_PARAM_RTOL / _ATOL. The route
                checks of 6c after the profiled step and after the
                interleave (there on each fused sketch too, against the
                plain encode; bucket 3's 30,720 coordinates go the scores
                route); the interleave's decode and scores launches as
                each bucket's size and k route it.
6e. train_elastic — the train_minicpm cell's step (minicpm-2b widths, 2
                layers, d = 405,220,864, buckets 2, microbatch 2, clip, wsd,
                the faithful fill) on the Alg. 1 tree, global batch
                ELASTIC_BATCH: two steps at P = 4; worker 2 stops beating
                and the heartbeat monitor (an explicit clock) reports it;
                ``replan`` to generation 1 (lr_scale printed); the
                survivors' state rows carried leaf by leaf
                (``runtime.carry_survivors``), the P = 4 state freed; a
                step built fresh at P = 3 (the tree parks the odd rank)
                runs two steps, then one in which
                ``DeadlinePolicy`` (fed those steps' times, then one 30x
                outlier) drops worker 1, and one with every worker. Each
                step: a finite loss and bit-equal replicas. The drop step's
                exchange held (``checked_drop``): the update on each
                bucket's selection the live sum x P/live, the dropped
                worker's EF its error-corrected gradient bit for bit.
                Counted: encode, finish, scores (with the filler) and
                select 40 times each, the decode never, no plain version;
                the route checks of 6c on the last step's worker-0
                gradient; step seconds at P = 4 and 3, peak memory.
6f. train_tp — qwen3-4b at its published widths, 2 layers, tp = 2 x
                data = 2 (the model axis a rank dimension of one graph):
                d_local 295,410,432 a rank and worker in buckets
                (194,478,080, 100,932,352); three counted gs-SGD steps
                under the main path's exchange, one exchange a model rank
                over the two workers: the encode, its finish, the decode
                and the select 24 times each, no plain version; route
                checks (timed) on rank 0's worker-0 gradient of a fourth
                step; then the dense exchange at tp = 2 x data = 2 and at
                tp = 1 x data = 2 from the same global params and
                batches, three steps each: losses within TP_DENSE_RTOL.
6g. train_fsdp — yi-9b at its published widths, 2 layers (d =
                870,338,560), fsdp with pod = 2 x data = 2: each worker
                stores 1/2 of every segment (params, AdamW moments, EF);
                a pod's shards are gathered once a step, and gs-SGD runs
                over the pods, once per data shard (buckets 262,144,000
                and 173,025,280 of a shard): three counted steps (24
                launches each, as 6f), peak memory, route checks (timed);
                then one step from a fresh state whose EF (the gradient
                with the selection zeroed) holds every worker's cycles_s
                shard against the sum over its pod of the workers' full
                gradients, sliced (FSDP_SCATTER_RTOL).
6g'. train_tp_interleave, train_fsdp_interleave — the 6f and 6g cells at
                buckets 4 with the chunked backward (2 chunks: one cycle
                a chunk) and the fused interleave, one backward serving
                every exchange group (a model rank; in fsdp a data
                shard): the partial encodes at the cells' fragment
                shapes bit-equal to the whole-bucket encode and timed;
                three counted steps (a partial encode per fragment and
                (rank, worker): 84; a finish per bucket and group: 24;
                the select 48; the decode 36 and the scores kernel 12,
                the last bucket being under 2^22); one step with every
                group's fused sketch held against the whole-bucket
                encode; one whose rank-0 worker-0 gradient runs the
                route's kernels bit-equal to plain, timed at the cells'
                buckets-4 shapes (shard_shapes); one profiled
                (profile_*_interleave); then the same cell at buckets 4
                without chunks (train_*_bucketed4), held as 6 holds
                train_interleave: first losses equal, the later within
                INTERLEAVE_LOSS_RTOL, the same selections, params within
                INTERLEAVE_PARAM_*; one profiled step of it
                (profile_*_bucketed4).
6h. train_mesh — the process mesh (``launch/mesh.py``): the train cell
                (qwen3-4b widths, 2 layers, buckets 2, psum, AdamW, the
                same seed and batches) with one worker a process, 2
                processes spawned on the one card (gloo: every collective
                copies its CUDA tensors through pinned host memory, in
                ``stage/*`` spans). Each process: three counted steps (the
                encode, its finish, the decode and the select 6 times, no
                plain version), its peak, the wire counter over the
                counted steps and one traced step's ``allreduce/b{i}`` and
                ``recover/b{i}`` spans with the staging inside them. Held
                bit for bit against ``train``: losses, the final state's
                fingerprints (bit digests of every params segment and EF
                bucket) and every step's selections.
6i. train_mesh_tree — minicpm-2b's cell (the train_elastic cell's step)
                on the Alg. 1 tree at P = 4 processes, against the
                simulated tree step from the same state and batches (run
                first in the parent, freed before the spawn); the scores
                route (with the filler) 6 times a process. Held bit for
                bit, as train_mesh: losses, every step's selections and
                the final state's fingerprints (the second round's 4-way
                sum is an ordered all-reduce, ``core.pgroup``, in the
                simulation's worker order; the clip's norm adds each
                worker's row as a process does).
6j. train_mesh_tp — the train_tp cell on 4 processes (tp = 2 x data = 2).
                Its witness runs first in the parent: train_tp's
                simulated step with the rank-stacked GEMMs, attention and
                norm gains run one rank at a time in a process's layout
                (``per_rank_kernels``), held against train_tp within the
                WITNESS_* bounds (the card rounds the batched ranks
                otherwise; PERF.md). Each process's losses, selections
                and final state are held bit for bit against the
                witness's. Then train_mesh_tp_interleave: the same cell
                with 2 backward chunks and the fused interleave (buckets
                2), against its own witness (the simulated interleave
                under per_rank_kernels; its recoveries position by
                position over the ranks), bit for bit, each process
                launching the interleave's counts (18 / 6 / 6 / 6).
7. parity    — two steps of examples/specs/qwen3_smoke.json on the card
                (kernels) and on the CPU (plain versions) from the same
                params and batches: losses and selected coordinates agree.
                Its buckets are below 2^22: the scores kernel's path (with
                its histogram, then the select). The same for the smoke
                configs of yi-9b, minicpm-2b and starcoder2-3b.
7a. parity_elastic — examples/fault_tolerant_training.py's scenario at
                the smoke config (P = 5 on the tree, worker 3 fails,
                ``replan`` and the survivors' rows at P = 4, a
                ``DeadlinePolicy`` drop, a step with all; k 4096, W 8192,
                ``LMStream(global_batch=20)``) on the card and on the CPU
                port: the selected coordinates equal every step, losses
                within PARITY_LOSS_RTOL, replica divergence 0 on both.
7b. parity_families — the same for the smoke configs of granite-moe,
                qwen3-moe, rwkv6, zamba2, llama-3.2-vision and musicgen;
                llama-3.2-vision once more with seeded ``cross_kv`` patch
                embeddings in its batches, and qwen3-moe once more with its
                override row's SGD with momentum and bf16 EF, passed in.
7c. train_cnn — the paper's experiment at full size (bench/cnn_dist.py):
                ResNet-20 (d = 272,282) and VGG-16 (d = 14,724,042), P = 4,
                global batch 32, gs-SGD at time_breakdown.paper_geometry's
                (k, W) ((1,089, 1,024) and (58,896, 32,768)), R = 5, SGD
                with momentum at lr 0.02, cuDNN deterministic and TF32 off:
                five counted steps each (the encode, its finish and the
                select once a worker and step; ResNet-20 the scores kernel
                and never the decode, VGG-16 the reverse; no plain version
                called); a second run with the same loss bits; five steps
                with cuDNN nondeterministic and its autotuner (the cost of
                the deterministic mode); one more step whose worker-0
                gradient runs through the cell's kernels, bit-equal to
                plain and timed at its shapes (``cnn_shapes`` in the kernels
                line); the CPU port's steps from the same params and
                batches (ResNet-20 all five, VGG-16 the first): losses
                within PARITY_LOSS_RTOL, and the first step's selection
                equal but for near-ties (CNN_TIE_RTOL).
7d. paper_table2 — ``bench.throughput.main`` on the card (Table II at full
                size): each method's t_compu, t_compr, t_commu (Eq. 1 at
                1 GbE), images/s measured and modelled, g/k and g/s; no
                ratio asserted.
7f. parity_tp — card against the CPU port at the sharded layouts' smoke
                configs, three steps each from the same params and batches:
                the nine archs of tests/test_tp.py at tp = 2 (dense),
                qwen3-4b at tp = 2 x data = 2 and yi-9b in fsdp at pod = 2
                x data = 2 with gs-SGD (scores route, 24 launches each):
                losses within TP_PARITY_RTOL, selections equal.
7g. parity_mesh — the CPU tests' smoke mesh runs (tests/test_torch_mesh.py)
                with each process on the card against the CPU port's
                simulated run: the reference test's dense (2, 2, 2) case
                (8 processes), gs-SGD psum and tree at P = 4 and yi-9b's
                fsdp at pod = 2 x data = 2 (4 processes; the scores route
                6 times a process), losses within TP_PARITY_RTOL and
                selections equal; serving at tp = 2 (qwen3-4b smoke, 4
                processes on a (1, 2, 2) mesh): each rank's logits shard
                within SERVE_PARITY_ATOL, its ids equal.
7e. paper_figs — ``bench.convergence.main`` and ``bench.k_sensitivity.main``
                (Figs. 2-3, 6-7) for 10 steps on the card: finite losses.
8. baselines — every compressor of the registry, two smoke-spec steps on the
                card and on the CPU from the same params and batches.
9. cli       — ``python -m repro_torch.launch.train --spec
                examples/specs/qwen3_smoke.json`` on the card, then the same
                with ``--buckets 4 --bwd-chunks 2 --fuse-encode``; then four
                steps with a checkpoint every step and ``--kill-at 2``,
                ``--resume`` to step 4, and four steps straight: the final
                losses and the step-4 checkpoints' tensors bit-equal.
10. cli_tune — ``train --trace --json`` on the card at the smoke spec and
                two more ``--json`` captures (buckets 1; buckets 1 at width
                1,024), ``python -m repro_torch.launch.tune --spec SPEC
                --calibrate`` on the three trace@2 files ``--out PLAN``,
                then ``train --auto-tune PLAN`` and ``train`` with
                ``plan.train_argv()``: loss histories bit-equal.
10b. cli_simulate — ``python -m repro_torch.launch.simulate`` (host only):
                P = 1,024, buckets 8, ``--fault-trace
                examples/traces/fail_rejoin.json`` on ``--engine batched``
                and ``loop`` (the ``--out`` files equal, the ``--json``
                curves a step each), and a ``--watch --congest`` run that
                re-plans, its ``--trace`` validated; the simulator's own
                wall seconds printed as host time.
11. serve     — qwen3-4b at its published widths and all 36 layers (f32,
                4,022,468,096 parameters) through ``ServeEngine`` with the
                paged cache: 8 slots, block 16, max_len 256, 12 seeded
                prompts of 16-192 tokens, 64 new tokens each. A cold and a
                steady run (tok/s, TTFT and per-token wall p50/p95/p99,
                peak memory); a lockstep against ``ContiguousKVCache``
                (the same emissions every step, the gathered KV bit-equal
                on every valid position of every active slot, the state
                on every slot); each request alone in an engine of its own
                (continuous batching's tokens equal); prefill/decode
                consistency (tokens equal unless the prefill's top-2 logit
                margin is within SERVE_TIE_ATOL); one decode step with 8
                active slots under the profiler (profile_serve); a
                ``ReplicaSet`` of 2 with one killed after 3 rounds against
                one replica (the same tokens, re-planned once, replays).
                No kernel of the sketch path may launch (counts zeroed
                before, read after: all 0).
11b. serve_families — the same checks (without the profile and the
                replicas) at published widths for zamba2-2.7b (Mamba2
                state + the shared block's KV), rwkv6-7b (state only) and
                granite-moe-3b-a800m (MoE decode); the depth each runs at
                is in SERVE_CELLS.
11c. serve_parity — the ten smoke configs' ``prefill_fn`` (logits within
                SERVE_PARITY_ATOL) and two ``decode_fn`` steps (scalar,
                then per-row ``kv_len``: ids equal unless the CPU's top-2
                margin is within SERVE_TIE_ATOL), card against the CPU
                port from the same params, the vlm with ``cross_kv``; the
                engine for the nine non-vlm ones: the same completions.
11d. serve_load, cli_serve — ``python -m repro_torch.bench.serve_load``
                on the card (all four checks), ``python -m
                repro_torch.launch.serve --smoke`` (the demo) and ``--smoke
                --load-test`` on the card; JSON into a temporary directory.
11e. serve_tp — qwen3-4b at its published widths, all 36 layers, through
                ``make_serve_fns`` at tp = 1 and tp = 2 from the same global
                params: 4 prompts of 32 tokens, 16 decode steps fed tp =
                1's tokens; the prefill logits within SERVE_TP_ATOL, the
                ids equal but for near-ties, the ranks' equal; then bf16
                with the exact and the fp8 wire: every fp8 psum within its
                rounding bound, the agreement printed, and at the
                reference test's smoke cell at least FP8_AGREEMENT.

12. dryrun_train, dryrun_fsdp, dryrun_serve — ``launch.dryrun.run_cell``
                on the card (DRYRUN_CELLS): one rank of the production
                mesh on a fake world, at its local shapes. dryrun_train:
                qwen3-4b x train_4k x single (one rank of 256: tp 16, all
                36 layers, seq 4,096, b_loc 16 in slices of 4, k 65,536,
                R 5, W 2^17, bf16, remat); dryrun_fsdp: yi-9b x train_4k x
                multi (512 ranks, gs-SGD over the pod axis); dryrun_serve:
                qwen3-4b x prefill_32k and x decode_32k x single. Each
                cell's record (launch/dryrun.py's JSON) on one line; held:
                a peak above the arguments, FLOPs, a train cell's measured
                step launching the encode, its finish, the decode and the
                select once each and no plain version, its exchange's
                all-reduces the summed sketch and the k values; a serve
                cell no sketch kernel; every cell's float outputs finite
                (``outputs_finite``). dryrun_train's encode input (the
                warm-up step's u) then runs the route's kernels against
                plain at the cell's shapes, timed (``dryrun_shapes``).
13. long_context — torch's sum over a leading dim against the left fold
                the simulated sums now use (printed); at qwen3-4b's
                widths and seq 4,096: the chunked
                attention (4 KV chunks) against the one-pass (one chunk of
                4,096) in f32 within LONG_ATTN_ATOL; the loss and every
                segment gradient of LONG_LAYERS cycles with the remat on
                and off bit-equal, each one's peak; the train cell with
                the remat off (train_noremat) against train (on, the
                default): losses bit-equal, step seconds and peaks.
14. roofline  — ``bench.roofline.main`` for both meshes fed the dry-run
                phases' records (build/dryrun_torch/): every row finite,
                the dry-run's cells joined with their peaks; dryrun_train's
                row beside its record (analytic against executed FLOPs, the
                step bound against the measured step); ``measure_encode`` on
                the card at ROOFLINE_ENCODES (d 2^22 and train's bucket-0
                d, W 2^14): whole and fused (4 offset fragments into one
                exact sketch, one finish) bit-equal, and at 2^22 bit-equal
                to ``sketch_encode_plain``; GB/s and the share of 3.35 TB/s.
15. perf_iterations — ``bench.perf_iterations.main`` on the host: the
                three climbs over the H100-priced roofline, printed.
16. overlap_audit — ``bench.overlap_audit`` of build/train_traced_trace.json,
                of traced 3-step runs of train_interleave's and
                train_tp_interleave's cells (buckets 4, 2 backward chunks,
                fused encode) through ``launch.train.drive`` (counted: 3
                steps and the probe), and of a jitter-free simulator
                trace, which must pass ``check`` at OVERLAP_TOLERANCE;
                each phase delta, the realization ratio and the audit's
                measured-stage schedule printed, and for both interleave
                traces the same recurrence with the step's own plan
                readiness (``plan_schedule``): what a second stream
                could hide.
17. bench_host — ``bench.drift_audit``, ``sim_sweep``, ``sim_scale`` and
                ``tune_sweep`` with ``--fast`` on the host (JSON under
                build/bench_torch/); a nonzero exit or a failed assertion
                fails.
18. examples  — the four ``repro_torch.examples`` on the card, each counted:
                quickstart (16 of 16 planted coordinates, replica
                divergence 0), fault_tolerant_training (P = 5 -> 4, the
                drop step, replicas equal), serve_batched (every request
                finishes, no sketch kernel), train_lm_e2e (30 steps, then
                ``--resume`` to 40 from its checkpoint under build/,
                starting at 30, finite losses).

Every path that launches kernels (train, train_traced, train_watched,
train_ts, train_interleave, train_minicpm, train_elastic, train_moe,
train_hybrid and its interleave, train_tp, train_fsdp, their
interleaves, train_mesh, train_mesh_tree, train_mesh_tp and its
interleave, parity, parity_elastic, parity_families,
parity_tp, parity_mesh, train_cnn, dryrun_train, dryrun_fsdp,
train_noremat, measure_encode, overlap_audit's interleave run and each
example) runs with every
launch counter set to 0 just before and read just after; each kernel of
the path must have launched, and the JSON line reports those counts (a
mesh phase's summed over its processes, each zeroed in its process). The
serve phases run no kernel of the sketch path: their counts, summed
(``launches_serve``; ``launches_serve_tp`` for serve_tp,
``launches_dryrun_serve``, ``launches_long_context``), must be 0. The
dry-run's counts are its measured step's (``launches_dryrun_train``,
``launches_dryrun_fsdp``), the kernels at its shapes under
``dryrun_shapes``. Phases 14-18's: ``launches_measure_encode``,
``launches_overlap_interleave``, ``launches_overlap_tp_interleave``,
``launches_example_<name>``. The sharded interleaves': ``launches_train_tp_interleave``,
``launches_train_fsdp_interleave``; 6j's interleave:
``launches_train_mesh_tp_interleave``. The
kernels at the sharded cells' bucket shapes are under ``shard_shapes``.
The
select's slab-overflow counter is zeroed before each path too and read
after it (a host sync, outside the path).

The last lines are the card's name and power limit (nvidia-smi), one JSON
object with every kernel's numbers (bucket 0's; a kernel timed at several
shapes lists each under ``shapes``), and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet), at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12   # f32 outside the tensor cores

# Full-width cell of the main path.
TRAIN_P, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 8, 64, 3, 1e-3

# Tolerances.
ENCODE_REL_TOL = 1e-4   # |kernel - plain| / max|S|: the TS encoder adds in
#                         another order (its kernel's fixed per-bucket
#                         order); n*eps*sum|x|/max|S| stays below. The exact
#                         encoder (integer limb sums) is held bit-equal to
#                         plain, with this bound checked beside it
PARITY_LOSS_RTOL = 1e-3  # card vs CPU: f32 matmuls and sketch sums in
#                          another order, then AdamW (the CPU port matches
#                          the JAX package at 1e-4)
INTERLEAVE_LOSS_RTOL = 1e-5  # interleaved (fused) vs bucketed step on the
#                          card, after the first step (whose losses are
#                          equal: the same forward). The fused sketch is
#                          within ENCODE_REL_TOL * max|S| of the whole-bucket
#                          encode, so the runs' estimates differ by at most
#                          2e-4 * max|S|, and only coordinates in that band
#                          of the k-th key can change places in the
#                          selection; the rest is the same ops on the same
#                          values (the selected coordinates' exact values are
#                          fetched). A swap moves one param by one AdamW step
#                          (about lr) and the loss by about lr * |g_i|, g_i
#                          near the k-th key: well below 1e-5 of a loss near
#                          12. The selection and the params are compared
#                          directly too (INTERLEAVE_PARAM_*)
INTERLEAVE_PARAM_RTOL, INTERLEAVE_PARAM_ATOL = 1e-5, 1e-6  # params after the
#                          counted steps, as tests/test_torch_fused_encode.py
#                          holds fused against unfused; a swapped coordinate
#                          moves its param by about lr, far beyond atol
INTERLEAVE_BUCKETS, INTERLEAVE_CHUNKS = 4, 2

# The train_minicpm cell: minicpm-2b at its published widths, 40 -> 2
# layers, microbatch 2 (two slices a worker), the global-norm clip at 1.0,
# AdamW under wsd(TRAIN_LR, warmup=1, stable=0, decay=2), HEAVYMIX's
# faithful fill (filler drawn from a generator seeded 0).
MINICPM_LAYERS, MINICPM_MICROBATCH, MINICPM_CLIP = 2, 2, 1.0
MINICPM_RTOL = 1e-5  # step 0's microbatched loss (the mean of two slices'
#                      losses) against the full-batch loss of the same
#                      params, and the applied gradient's norm against
#                      min(grad_norm, clip): f32 sums in another grouping,
#                      a few ulp of values near 12 and near the norm
NEW_SMOKE_ARCHS = ("yi-9b", "minicpm-2b", "starcoder2-3b")

# The model zoo's other families at their published widths: granite-moe-
# 3b-a800m cut from 32 to 4 layers and zamba2-2.7b from 54 to 12 (two
# cycles of six Mamba2 blocks and the shared block), each under the main
# path's exchange; zamba2 also at buckets 4 with the chunked backward
# (one cycle a chunk) and the fused encode. d as tests/test_torch_families.py
# pins them.
MOE_LAYERS, MOE_D = 4, 478_606_848
MOE_BUCKETS = (277_022_208, 201_584_640)
HYBRID_LAYERS, HYBRID_D, HYBRID_CHUNKS = 12, 663_336_448, 2
FAMILY_SMOKE_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b",
                      "rwkv6-7b", "zamba2-2.7b", "llama-3.2-vision-11b",
                      "musicgen-large")

# The paper's experiment (train_cnn): ResNet-20 and VGG-16 at full size,
# P = 4, global batch 32, gs-SGD at time_breakdown.paper_geometry's (k, W),
# R = 5, SGD with momentum 0.9 at lr 0.02 (bench/cnn_dist.py). d as
# tests/test_torch_paper_bench.py pins them; VGG-16's d is past 2^22 and
# 4k (the decode route), ResNet-20's is not (the scores route). The CPU
# side runs ResNet-20's steps in full and VGG-16's first step (its plain
# encode and decode take ~8 s a worker on a CPU).
CNN_P, CNN_BATCH, CNN_STEPS, CNN_LR, CNN_FIG_STEPS = 4, 32, 5, 0.02, 10
CNN_CELLS = (("resnet20", 272_282, False, CNN_STEPS),
             ("vgg16", 14_724_042, True, 1))
CNN_TIE_RTOL = 1e-3  # a coordinate the card and the CPU select differently
#                      must score within this of the k-th score (or its
#                      est^2 of the heavy threshold) in the card's recovery:
#                      the two f32 backwards round their convolutions in
#                      another order, and a pre-activation within rounding
#                      of 0 moves a few gradients by up to ~2e-3
#                      (tests/test_torch_cnn_dist.py)

# Tensor parallelism and fsdp storage (the reference's nested-vmap layouts,
# the model axis a rank dimension of one graph). train_tp: qwen3-4b at its
# published widths, 2 layers, tp = 2 x data = 2, d a (rank, worker) and its
# buckets; train_fsdp: yi-9b at its published widths, 2 layers, fsdp with
# pod = 2 x data = 2, d of the whole model and a worker's shard's buckets.
TP, TP_DATA, TP_D = 2, 2, 295_410_432
TP_BUCKETS = (194_478_080, 100_932_352)
TP_DENSE_RTOL = 5e-4   # dense tp = 2 against tp = 1, 3 steps (tests/test_tp.py)
FSDP_POD, FSDP_DATA, FSDP_D = 2, 2, 870_338_560
FSDP_BUCKETS = (262_144_000, 173_025_280)
FSDP_SCATTER_RTOL = 1e-6  # the step's reduce-scattered shard against the pod
#                           sum of the workers' full gradients, sliced: the
#                           same products, summed in the same order
TP_PARITY_RTOL = 1e-5  # card against the CPU port, sharded smoke configs:
#                        f32 (TF32 off), sums in another order, 3 steps
TP_PARITY_KW = dict(k=2048, rows=5, width=4096)   # as the CPU tests' cells
# serve_tp: qwen3-4b at its published widths, all 36 layers, tp = 2, 4
# prompts of 32 tokens, 16 decode steps fed the tp = 1 run's greedy tokens
SERVE_TP_B, SERVE_TP_LEN, SERVE_TP_STEPS = 4, 32, 16
SERVE_TP_ATOL = 1e-3   # f32 prefill logits, tp = 2 against tp = 1: the row-
#                        parallel sums split in two halves at each of 73
#                        psums; the decode ids equal unless tp = 1's top-2
#                        margin is within SERVE_TIE_ATOL
FP8_AGREEMENT = 0.75   # greedy tokens, fp8 wire against the exact wire:
#                        tests/test_perf_opts.py's bound, held at its own
#                        cell (qwen3-4b smoke, tp = 2, 4 prompts, one decode
#                        step) with bf16 activations, so the fp8 path is on
#                        (in f32 it is off, as in the reference). At 36
#                        full-width layers of an untrained model the greedy
#                        agreement is measured and printed, not bounded: a
#                        152k vocab's top-2 margins (~0.2) sit within the
#                        wire's accumulated error, and the reference's own
#                        agreement falls with depth: at 12 smoke layers
#                        tests/test_torch_tp.py holds the port's fp8 tokens,
#                        logits and agreement to the reference's, which
#                        cannot run here (PERF.md, Open questions)
FP8_ULP, FP8_SUB = 2.0 ** -4, 2.0 ** -10  # e4m3fn: a normal value's rounding
#                        error <= 2^-4 relative, a subnormal's <= 2^-10 of the
#                        448 scale; the bf16 cast of the sum adds 2^-8


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(torch, fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------------------


def build_phase(torch):
    from repro_torch.kernels import (build, heavymix_topk, sketch_decode,
                                     sketch_encode, topk_select, ts_encode)
    names = ("sketch_encode", "heavymix_scores", "sketch_decode",
             "ts_encode", "topk_select")
    t0 = time.time()
    logs = build.build_all(names)
    for mod in (sketch_encode, heavymix_topk, sketch_decode, ts_encode,
                topk_select):
        mod._lib()
    log(f"[build] {len(names)} kernels built and loaded in "
        f"{time.time() - t0:.1f} s (nvcc {build.nvcc_path()})")
    for name, text in logs.items():
        for line in (text or "cached build\n").splitlines():
            if ("registers" in line or "spill" in line
                    or line == "cached build"):
                log(f"[build] {name}: {line.strip()}")


def main_exchange():
    """The main path's exchange: gs-SGD, 2 buckets, psum, R = 5, k and W
    derived from d."""
    from repro_torch.api import ExchangeSpec, SketchSpec
    return ExchangeSpec(compressor="gs-sgd", buckets=2, overlap=True,
                        allreduce_mode="psum",
                        sketch=SketchSpec(rows=5, width=None, k=None))


def full_width_step(torch, device, buckets=2, bwd_chunks=None,
                    fuse_encode=False, exchange=None, cfg=None, ma=None,
                    remat=True):
    """The main path's train step (no state allocated yet); with other
    ``buckets`` / ``bwd_chunks`` / ``fuse_encode``, or a whole ``exchange``
    spec (a re-plan's), the same cell with that exchange schedule; with
    ``cfg``, that arch's cell under the same exchange, P, optimizer and
    lr; with ``ma`` (a process mesh's), on that mesh; ``remat``: the
    model's cycle remat (on, the default, or off)."""
    from repro_torch.configs.qwen3_4b import CONFIG
    from repro_torch.core.gs_sgd import MeshAxes, make_train_step
    from repro_torch.optim import make as make_opt
    cfg = cfg or dataclasses.replace(CONFIG, n_layers=2)
    opt = make_opt("adamw", lr=TRAIN_LR)
    spec = exchange or dataclasses.replace(
        main_exchange(), buckets=buckets, bwd_chunks=bwd_chunks,
        fuse_encode=fuse_encode)
    ma = ma or MeshAxes(tp=1, data=TRAIN_P, tp_axis=None)
    ts = make_train_step(cfg, ma, opt, spec=spec, dtype=torch.float32,
                         device=device, remat=remat)
    return cfg, opt, ts


def _row(name, source, replaces, err, ms, plain_ms, bound, library_ms):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def _index_add_ms(torch, device, R, W, d, ids_vals):
    """Library yardstick of an encode: one ``index_add_`` over the flat
    (R*W) table, bucket ids and signed values precomputed (not timed).
    ``ids_vals(lo, hi)`` gives the (R, hi-lo) bucket ids and values.
    Returns (ms, the table it computed)."""
    flat_idx = torch.empty((R, d), dtype=torch.int64, device=device)
    flat_val = torch.empty((R, d), dtype=torch.float32, device=device)
    rows_off = (torch.arange(R, device=device) * W)[:, None]
    step = 1 << 24
    for lo in range(0, d, step):
        hi = min(d, lo + step)
        b, v = ids_vals(lo, hi)
        flat_idx[:, lo:hi] = b + rows_off
        flat_val[:, lo:hi] = v
    flat_idx, flat_val = flat_idx.reshape(-1), flat_val.reshape(-1)
    out = torch.zeros(R * W, dtype=torch.float32, device=device)

    def call():
        out.zero_()
        out.index_add_(0, flat_idx, flat_val)

    ms = time_ms(torch, call, reps=3)
    del flat_idx, flat_val
    torch.cuda.empty_cache()
    return ms, out.view(R, W)


def _shapes_row(name, source, replaces, shapes):
    """A kernel's row timed at several shapes: the first's (bucket 0's)
    numbers at the top level, every shape's under ``shapes``."""
    s0 = shapes[0]
    row = _row(name, source, replaces, s0["max_abs_err"], s0["ms"],
               s0["plain_ms"], (s0["bound_ms"], s0["bound_by"]),
               s0["library_ms"])
    row["shapes"] = shapes
    return row


def encode_checks(torch, device, gen, buckets) -> tuple[dict, list]:
    """sketch_encode: small odd cases, then every bucket of the main path
    (``buckets``: (cfg, g) each), then bucket 0's g at the CLI's default
    width (few tiles, so several accumulating CTAs a tile): bit-equal to
    plain (and within ENCODE_REL_TOL * max|S|), a second launch bit-equal
    to the first, a launch with other splits and pass size bit-equal;
    non-finite and out-of-range elements planted at known coordinates.
    Returns its row and the kernel's sketch of each main-path bucket."""
    from repro_torch.api import SketchSpec
    from repro_torch.core import count_sketch as cs
    from repro_torch.kernels.sketch_encode import (encode_plan, sketch_encode,
                                                   sketch_encode_plain)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for rows, width, off in ((3, 300, 4099), (64, 1 << 12, 2**32 - 700),
                                 (1, 1, 0)):
            c = cs.SketchConfig(rows=rows, width=width, seed=5)
            x = torch.randn(1537, generator=gen, device=device).to(dt)
            got = sketch_encode(c, x, index_offset=off)
            want = sketch_encode_plain(c, x, off)
            err = float((got - want).abs().max())
            lim = ENCODE_REL_TOL * float(want.abs().max())
            log(f"[kernels] sketch_encode small d=1537 R={rows} W={c.width} "
                f"off={off} {dt}: bit-equal to plain "
                f"{_bits_equal(torch, got, want)} (max_abs_err {err:.3g}, "
                f"limit {lim:.3g})")
            if not (_bits_equal(torch, got, want) and err <= lim):
                fail(f"sketch_encode small {dt} R={rows} W={c.width} is not "
                     f"bit-equal to plain: {err}")
    encode_special_checks(torch, device, gen)
    cfg0, g0 = buckets[0]
    cases = [(f"bucket {b}", cfg, g) for b, (cfg, g) in enumerate(buckets)]
    cases.append(("CLI default width at bucket 0's d", cs.SketchConfig(
        rows=cfg0.rows, width=SketchSpec().width, seed=cfg0.seed), g0))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes, sketches = [], []
    for what, cfg, g in cases:
        d, R, W = g.shape[0], cfg.rows, cfg.width
        plan = encode_plan(R, cfg.log2_width, d, sms)
        log(f"[kernels] sketch_encode plan at {what} (d={d}, R={R}, W={W}): "
            f"{plan.ntiles} tiles of 2^13 cells, {plan.splits} accumulating "
            f"CTA(s) a tile; binning CTAs of {plan.block} elements "
            f"({plan.bin_smem} bytes of shared memory), {plan.nblocks} a "
            f"pass; passes of {plan.chunk} elements: {-(-d // plan.chunk)}, "
            f"scratch {plan.scratch_bytes} bytes")
        sk = sketch_encode(cfg, g)
        sk_p = sketch_encode_plain(cfg, g)
        err = float((sk - sk_p).abs().max())
        lim = ENCODE_REL_TOL * float(sk_p.abs().max())
        other = encode_plan(R, cfg.log2_width, d, sms,
                            splits=max(1, plan.splits // 2 + 3),
                            chunk=max(plan.block, plan.chunk // 3
                                      // plan.block * plan.block))
        same = {"plain": _bits_equal(torch, sk, sk_p),
                "second launch": _bits_equal(torch, sk,
                                             sketch_encode(cfg, g)),
                f"splits {other.splits}, passes of {other.chunk}":
                    _bits_equal(torch, sk, sketch_encode(cfg, g,
                                                         plan=other))}
        log(f"[kernels] sketch_encode {what} d={d}: bit-equal to {same}; "
            f"max_abs_err {err:.4g} (limit {lim:.4g} = {ENCODE_REL_TOL} * "
            "max|S|)")
        if not (all(same.values()) and err <= lim):
            fail(f"sketch_encode at {what} is not bit-equal: {same}, "
                 f"max_abs_err {err}")
        del sk_p
        ms = time_ms(torch, lambda: sketch_encode(cfg, g), reps=10)
        plain_ms = time_ms(torch, lambda: sketch_encode_plain(cfg, g), reps=2)

        def ids_vals(lo, hi):
            bk, sg = cs.hash_buckets(cfg, torch.arange(lo, hi, device=device))
            return bk, sg * g[lo:hi]

        lib_ms, lib_out = _index_add_ms(torch, device, R, W, d, ids_vals)
        log(f"[kernels] index_add_ yardstick vs kernel at {what}: "
            f"max_abs_err {float((lib_out - sk).abs().max()):.4g}")
        del lib_out
        bound = bound_ms(d * g.element_size() + R * W * 4, d * R * 7.0)
        shapes.append({"shape": what, "d": d, "rows": R, "width": W,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound[0], "bound_by": bound[1],
                       "library_ms": lib_ms})
        if len(sketches) < len(buckets):
            sketches.append(sk)
    return _shapes_row("sketch_encode", "src/repro_torch/csrc/sketch_encode.cu",
                       "src/repro/kernels/sketch_encode.py:87",
                       shapes), sketches


def encode_special_checks(torch, device, gen):
    """NaN, +inf, -inf, an element of 3e9 and one of -2^31 planted at known
    coordinates of a 100,000-element g (R = 5, W = 1024): the kernel's
    sketch bit-equal to plain; each planted element's cells NaN or inf by
    the encode's rules (NaN, or both infinities: NaN; one infinity: it;
    |v| >= 2^31: NaN)."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.kernels.sketch_encode import (sketch_encode,
                                                   sketch_encode_plain)
    cfg = cs.SketchConfig(rows=5, width=1024, seed=3)
    g = torch.randn(100_000, generator=gen, device=device).mul_(1e-3)
    plants = {10: float("nan"), 20: float("inf"), 30: -float("inf"),
              40: 3e9, 50: -2.0**31}
    for j, v in plants.items():
        g[j] = v
    got, want = sketch_encode(cfg, g), sketch_encode_plain(cfg, g)
    if not _bits_equal(torch, got, want):
        fail("sketch_encode with non-finite elements is not bit-equal to "
             "plain")
    bk, sg = cs.hash_buckets(cfg, torch.tensor(list(plants), device=device))
    cells: dict = {}
    for n, v in enumerate(plants.values()):
        for r in range(cfg.rows):
            cells.setdefault((r, int(bk[r, n])), []).append(float(sg[r, n]) * v)
    for (r, w), vals in cells.items():
        pos = any(x == math.inf for x in vals)
        neg = any(x == -math.inf for x in vals)
        nan = any(math.isnan(x) for x in vals) or (pos and neg)
        want = ("nan" if nan else "+inf" if pos else "-inf" if neg
                else "nan")  # otherwise only |v| >= 2^31: NaN
        cell = float(got[r, w])
        have = ("nan" if math.isnan(cell) else "+inf" if cell == math.inf
                else "-inf" if cell == -math.inf else "finite")
        if have != want:
            fail(f"sketch_encode: cell ({r}, {w}) of planted {vals} is "
                 f"{cell}, want {want}")
    log(f"[kernels] sketch_encode with NaN, +inf, -inf, 3e9, -2^31 planted: "
        f"bit-equal to plain; {int(torch.isnan(got).sum())} NaN and "
        f"{int(torch.isinf(got).sum())} inf cells where the rules put them")


def _spiky(torch, gen, device, n, n_spikes):
    """A gradient-like vector: small noise and ``n_spikes`` large entries."""
    g = torch.randn(n, generator=gen, device=device).mul_(1e-3)
    spikes = torch.randint(0, n, (n_spikes,), generator=gen, device=device)
    g[spikes] = torch.randn(spikes.numel(), generator=gen, device=device)
    return g


def check_select(torch, what, key, k, hist):
    """topk_select of ``key`` (with the kernel's first-digit histogram)
    against ``topk_lower_index(|key|, k)``: idx equal as returned, values
    bit-equal. Returns the largest value difference (0)."""
    from repro_torch.core.heavymix import topk_lower_index
    from repro_torch.kernels.topk_select import topk_select
    v, i = topk_select(key, k, hist)
    v_o, i_o = topk_lower_index(key.abs(), k)
    if not torch.equal(i, i_o):
        fail(f"topk_select at {what} (k={k}) selects other indices than "
             f"topk_lower_index: {int((i != i_o).sum())} of {k} differ")
    if not torch.equal(v.view(torch.int32), v_o.view(torch.int32)):
        fail(f"topk_select at {what}: values not bit-equal")
    return float((v - v_o).abs().max())


def check_scores_hist(torch, what, c, s, thr, n, filler=None):
    """heavymix_scores with its histogram (and the faithful fill's
    ``filler``, where given): scores and est bit-equal to plain, histogram
    equal to the plain one of the same scores. Returns (scores, est, hist,
    max |est - plain est|)."""
    from repro_torch.kernels.heavymix_topk import (heavymix_scores_hist,
                                                   heavymix_scores_plain)
    from repro_torch.kernels.topk_select import radix_hist_plain
    sc, est, hist = heavymix_scores_hist(c, s, thr, n, filler)
    sc_p, est_p = heavymix_scores_plain(c, s, thr, n, filler)
    est_err = float((est - est_p).abs().max())
    if not (torch.equal(est, est_p) and torch.equal(sc, sc_p)):
        fail(f"heavymix_scores at {what} (d={n}, R={c.rows}, W={c.width}) "
             f"disagrees: max est err {est_err}")
    if not torch.equal(hist, radix_hist_plain(sc_p)):
        fail(f"heavymix_scores' histogram at {what} differs from the plain "
             "histogram of the same scores")
    return sc, est, hist, est_err


def smoke_scores_checks(torch, device, gen):
    """heavymix_scores at the shapes its own path (parity, cli: the smoke
    spec, every bucket below 2^22) gives it, each bucket with its own k
    and threshold, then a scores-regime case whose heavy set outnumbers k
    many times over (all those keys tie at 1e30): est, scores and the
    fused histogram equal to plain, the select's idx and values equal to
    ``topk_lower_index``'s, and the recovery's indices equal to the plain
    HEAVYMIX's."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.sketch_encode import sketch_encode_plain
    from repro_torch.launch import train as ttrain
    comp = ttrain.build(smoke_spec(), device)[3].compressor
    cases = [(f"smoke bucket {i}", part.sketch, part.k, n) for i, (part, n)
             in enumerate(zip(comp.parts, comp.spec.sizes))]
    cases.append(("heavy set >> k", cs.SketchConfig(rows=5, width=1024,
                                                    seed=9), 2048,
                  (1 << 22) - 1))
    for what, c, k, n in cases:
        s = sketch_encode_plain(c, _spiky(torch, gen, device, n, k // 4))
        thr = cs.l2sq_estimate(s) / k
        sc, est, hist, _ = check_scores_hist(torch, what, c, s, thr, n)
        n_heavy = int((sc >= 1e30).sum())
        if what.startswith("heavy") and not n_heavy > 10 * k:
            fail(f"{what}: only {n_heavy} heavy coordinates for k={k}")
        check_select(torch, what, sc, k, hist)
        idx = ops.heavymix_recover(c, s, k, n)[0]
        if not torch.equal(idx, ref.heavymix_recover(c, s, k, n)[0]):
            fail(f"heavymix_recover at {what} selects other coordinates "
                 "than the plain HEAVYMIX")
        log(f"[kernels] {what} d={n} R={c.rows} W={c.width} k={k} "
            f"({n_heavy} heavy): scores, est and histogram equal to plain; "
            "select idx and values equal to topk_lower_index's; recovered "
            "idx equal")


def _decode_library_ms(torch, device, cfg, sk, d):
    """Library yardstick of the decode: gather + sign + median over rows,
    bucket ids and signs precomputed (not timed); R is odd here, so
    torch.median's lower middle is the median. Returns (ms, its est)."""
    from repro_torch.core import count_sketch as cs
    R = cfg.rows
    ids = torch.empty((R, d), dtype=torch.int64, device=device)
    sgn = torch.empty((R, d), dtype=torch.float32, device=device)
    for lo in range(0, d, 1 << 24):
        hi = min(d, lo + (1 << 24))
        ids[:, lo:hi], sgn[:, lo:hi] = cs.hash_buckets(
            cfg, torch.arange(lo, hi, device=device))
    lib = {}

    def lib_call():
        lib["est"] = torch.median(torch.gather(sk, 1, ids).mul_(sgn),
                                  dim=0).values

    ms = time_ms(torch, lib_call, reps=2)
    del ids, sgn
    torch.cuda.empty_cache()
    return ms, lib["est"]


def scores_decode_checks(torch, device, gen, buckets) -> list[dict]:
    """heavymix_scores, sketch_decode and topk_select: small cases
    (offsets, R = 1, 4, 5, 29, widths below 512), the smoke spec's buckets
    and a heavy-set case (the scores kernel's path), then every bucket of
    the main path (``buckets``: (cfg, sketch, d, k) each): outputs
    bit-equal to plain, fused histograms equal to plain, the select equal
    to ``topk_lower_index``; the recovery's indices at bucket 0 against
    the plain HEAVYMIX, once under ``set_sync_debug_mode("error")``;
    times."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.heavymix import topk_lower_index
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.heavymix_topk import (heavymix_scores_hist,
                                                   heavymix_scores_plain)
    from repro_torch.kernels.sketch_decode import (sketch_decode,
                                                   sketch_decode_hist,
                                                   sketch_decode_plain)
    from repro_torch.kernels.sketch_encode import sketch_encode_plain
    from repro_torch.kernels.topk_select import (radix_hist_plain,
                                                 slab_overflows, topk_select,
                                                 topk_select_plain)
    for rows, n, width, off in ((1, 3000, 512, 0), (4, 3000, 300, 4099),
                                (5, 3001, 512, 4099), (29, 5000, 200, 17)):
        c = cs.SketchConfig(rows=rows, width=width, seed=rows)
        x = torch.randn(n, generator=gen, device=device)
        s = sketch_encode_plain(c, x)
        thr = cs.l2sq_estimate(s) / 40
        check_scores_hist(torch, f"small R={rows}", c, s, thr, n)
        e = sketch_decode(c, s, n, index_offset=off)
        if not torch.equal(e, sketch_decode_plain(c, s, n, off)):
            fail(f"sketch_decode small R={rows} W={c.width} off={off} "
                 "disagrees with its plain version")
        log(f"[kernels] small R={rows} W={c.width} d={n}: scores and est "
            f"bit-equal, histogram equal; decode at offset {off} bit-equal")
    smoke_scores_checks(torch, device, gen)

    cfg, sk, d, k = buckets[0]
    R, W = cfg.rows, cfg.width
    thr = cs.l2sq_estimate(sk) / k
    sc, est, _, hm_err = check_scores_hist(torch, f"bucket 0's d={d}", cfg,
                                           sk, thr, d)
    del sc, est
    # the main path's selection (ops.heavymix_recover: the decode kernel
    # with its histogram and the select at this d) against the port's plain
    # chunked HEAVYMIX, then once more with any host sync an error
    idx = ops.heavymix_recover(cfg, sk, k, d)[0]
    idx_p = ref.heavymix_recover(cfg, sk, k, d)[0]
    if not torch.equal(idx, idx_p):
        fail("heavymix_recover selects other coordinates than the plain "
             f"HEAVYMIX: {int((idx != idx_p).sum())} of k={k} differ")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx_s = ops.heavymix_recover(cfg, sk, k, d)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not torch.equal(idx_s, idx_p):
        fail("heavymix_recover under set_sync_debug_mode differs")
    log(f"[kernels] d={d}: heavymix_scores est, scores and histogram equal "
        "to plain; recovered idx equal to the plain HEAVYMIX; a recovery "
        "under set_sync_debug_mode('error') raised nothing")
    del idx, idx_p, idx_s
    hm_ms = time_ms(torch, lambda: heavymix_scores_hist(cfg, sk, thr, d),
                    reps=10)
    hm_plain_ms = time_ms(
        torch, lambda: heavymix_scores_plain(cfg, sk, thr, d), reps=2)
    log(f"[kernels] heavymix_scores (with its histogram) at d={d}: "
        f"{hm_ms:.3f} ms, max est err {hm_err}")
    ops_per = R * 6.0 + R * (R - 1)   # hashes + compare-exchanges
    hm_row = _row("heavymix_scores", "src/repro_torch/csrc/heavymix_scores.cu",
                  "src/repro/kernels/heavymix_topk.py:91", hm_err, hm_ms,
                  hm_plain_ms, bound_ms(R * W * 4 + 4 + 2 * d * 4 + 2048 * 4,
                                        d * (ops_per + 4)), None)

    dec_shapes, sel_shapes = [], []
    for b, (cfg, sk, d, k) in enumerate(buckets):
        R, W = cfg.rows, cfg.width
        sms = torch.cuda.get_device_properties(sk.device).multi_processor_count
        log(f"[kernels] sketch_decode plan at bucket {b} (d={d}, R={R}, "
            f"W={W}): one thread a coordinate, grid-stride, 256 threads, "
            f"{min(-(-d // 256), sms * 16)} CTAs")
        est, hist = sketch_decode_hist(cfg, sk, d)
        dec_p = sketch_decode_plain(cfg, sk, d)
        dec_err = float((est - dec_p).abs().max())
        if not torch.equal(est, dec_p):
            fail(f"sketch_decode not bit-equal at bucket {b} (d={d}): max "
                 f"err {dec_err}")
        if not torch.equal(hist, radix_hist_plain(dec_p)):
            fail(f"sketch_decode's histogram at bucket {b} differs from the "
                 "plain histogram of the same est")
        del dec_p
        log(f"[kernels] sketch_decode bucket {b} d={d}: est bit-equal, "
            f"histogram equal to plain ({int((hist > 0).sum())} of 2048 bins "
            "used)")
        sel_err = check_select(torch, f"bucket {b}", est, k, hist)
        log(f"[kernels] topk_select bucket {b} d={d} k={k}: idx equal to "
            "topk_lower_index's, values bit-equal")
        dech_ms = time_ms(torch, lambda: sketch_decode_hist(cfg, sk, d),
                          reps=10)
        dec_plain_ms = time_ms(torch, lambda: sketch_decode_plain(cfg, sk, d),
                               reps=2)
        slab_overflows(est.device, reset=True)
        sel_ms = time_ms(torch, lambda: topk_select(est, k, hist), reps=10)
        sel_over = slab_overflows(est.device, reset=True) / 11
        if b == 0:
            select_overflow_checks(torch, [(f"est of bucket {b}", est, k,
                                            hist)])
        sel_plain_ms = time_ms(
            torch, lambda: topk_select_plain(est, k, hist), reps=2)
        topk_ms = time_ms(torch, lambda: topk_lower_index(est.abs(), k),
                          reps=3)
        key = est.abs()
        lib_topk_ms = time_ms(torch, lambda: torch.topk(key, k, sorted=False),
                              reps=3)
        del key

        def old_route():
            e = sketch_decode(cfg, sk, d)
            return topk_lower_index(e.abs(), k)

        def new_route():
            e, h = sketch_decode_hist(cfg, sk, d)
            return topk_select(e, k, h)

        old_ms = time_ms(torch, old_route, reps=3)
        new_ms = time_ms(torch, new_route, reps=3)
        log(f"[kernels] bucket {b} (d={d}, k={k}): decode with histogram "
            f"{dech_ms:.3f} ms; select {sel_ms:.3f} ms ({sel_over:g} slab "
            "overflows a call); "
            f"topk_lower_index of |est| {topk_ms:.3f} ms; torch.topk "
            f"(sorted=False) {lib_topk_ms:.3f} ms; old route (decode + "
            f"topk_lower_index) {old_ms:.3f} ms, new route (decode with "
            f"histogram + select) {new_ms:.3f} ms")
        lib_ms, lib_est = _decode_library_ms(torch, device, cfg, sk, d)
        log(f"[kernels] gather+median yardstick equal to the decode kernel "
            f"at bucket {b}: {torch.equal(lib_est, est)}")
        del est, hist, lib_est
        torch.cuda.empty_cache()
        bound = bound_ms(R * W * 4 + d * 4 + 2048 * 4, d * ops_per)
        dec_shapes.append({"shape": f"bucket {b}", "d": d, "rows": R,
                           "width": W, "max_abs_err": dec_err, "ms": dech_ms,
                           "plain_ms": dec_plain_ms, "bound_ms": bound[0],
                           "bound_by": bound[1], "library_ms": lib_ms})
        # read the keys and the histogram once, write k int64 indices and
        # k f32 values; one compare a key per digit pass
        bound = bound_ms(d * 4 + 2048 * 4 + k * 12, d * 3.0)
        sel_shapes.append({"shape": f"bucket {b}", "d": d, "k": k,
                           "max_abs_err": sel_err, "ms": sel_ms,
                           "plain_ms": sel_plain_ms, "bound_ms": bound[0],
                           "bound_by": bound[1], "library_ms": lib_topk_ms,
                           "slab_overflows_a_call": sel_over,
                           "topk_lower_index_ms": topk_ms,
                           "old_route_ms": old_ms, "new_route_ms": new_ms})
    return [hm_row,
            _shapes_row("sketch_decode",
                        "src/repro_torch/csrc/sketch_decode.cu",
                        "src/repro/kernels/sketch_decode.py:85", dec_shapes),
            _shapes_row("topk_select", "src/repro_torch/csrc/topk_select.cu",
                        "jax.lax.top_k, src/repro/core/heavymix.py:65,88,93",
                        sel_shapes)]


def ts_checks(torch, device, gen, buckets) -> tuple[dict, list]:
    """ts_encode: small cases (f32/bf16/f16; rows with n_r > W; geometries
    that take the one-pass kernel, each also through the R-pass kernel),
    then every bucket of the main path (``buckets``: (cfg, g) each; bucket 0
    also in bf16) and bucket 0's g at the CLI's default width: held to the
    plain version at ENCODE_REL_TOL * max|S| and bit-equal between two
    launches (fixed order, no atomics), for the plan's kernel and, where
    the plan picks the one-pass kernel, the R-pass kernel too. Returns its
    row and the TS sketch of each main-path bucket."""
    from repro_torch.api import SketchSpec
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.ts_sketch import TSketchConfig, buckets_at, signs_at
    from repro_torch.kernels.ts_encode import (onepass_plan, rows_plan,
                                               ts_encode, ts_encode_plain,
                                               ts_encode_plan)
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def check(c, x, what, plan=None):
        got = ts_encode(c, x, plan)
        want = ts_encode_plain(c, x)
        err = float((got - want).abs().max())
        lim = ENCODE_REL_TOL * float(want.abs().max())
        kernel = (plan or ts_encode_plan(c, sms)).kernel
        if not err <= lim:
            fail(f"ts_encode ({kernel}) {what} disagrees: {err} > {lim}")
        if not torch.equal(got, ts_encode(c, x, plan)):
            fail(f"ts_encode ({kernel}) {what} differs between two launches")
        log(f"[kernels] ts_encode ({kernel} kernel) {what}: max_abs_err "
            f"{err:.4g} (limit {lim:.4g}); two launches bit-equal")
        return got, err

    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for n, rows, width in ((100_000, 5, 512), (70_000, 5, 16),
                               (1537, 1, 300), (3_000_001, 5, 1 << 16),
                               (600_001, 3, 1 << 14)):
            c = TSketchConfig(d=n, rows=rows, width=width, seed=5)
            x = torch.randn(n, generator=gen, device=device).to(dt)
            what = f"small d={n} R={rows} W={c.width} {dt}"
            check(c, x, what)
            one = onepass_plan(c)
            if one is not None:
                check(c, x, what, one if ts_encode_plan(c, sms).kernel ==
                      "rows" else rows_plan(c))
    cfg0, g0 = buckets[0]
    cases = [(f"bucket {b}", cfg, g) for b, (cfg, g) in enumerate(buckets)]
    cases.append(("CLI default width at bucket 0's d", cs.SketchConfig(
        rows=cfg0.rows, width=SketchSpec().width, seed=cfg0.seed), g0))
    shapes, sketches = [], []
    for what, cfg, g in cases:
        d = g.shape[0]
        tcfg = TSketchConfig(d=d, rows=cfg.rows, width=cfg.width,
                             seed=cfg.seed)
        R, W = tcfg.rows, tcfg.width
        plan = ts_encode_plan(tcfg, sms)
        log(f"[kernels] ts_encode plan at {what} (d={d}, R={R}, W={W}, "
            f"d_pad={tcfg.d_pad}, n_r={[1 << (tcfg.bits - a) for a in tcfg.log_m]}"
            f"): {plan}")
        if what == "bucket 0":
            check(tcfg, g.to(torch.bfloat16), f"{what} d={d} bf16")
        got, err = check(tcfg, g, f"{what} d={d} f32")
        shape = {"shape": what, "d": d, "rows": R, "width": W,
                 "kernel": plan.kernel, "ctas": plan.ctas,
                 "threads": plan.threads}
        ms = time_ms(torch, lambda: ts_encode(tcfg, g), reps=10)
        if plan.kernel == "onepass":
            # the R-pass kernel at the same shape, timed between two runs
            # of the plan's kernel
            rp = rows_plan(tcfg)
            check(tcfg, g, f"{what} d={d} f32", rp)
            shape["rows_kernel_ms"] = time_ms(
                torch, lambda: ts_encode(tcfg, g, rp), reps=10)
            shape["ms_runs"] = [ms, time_ms(torch, lambda: ts_encode(tcfg, g),
                                            reps=10)]
            ms = sum(shape["ms_runs"]) / 2
        plain_ms = time_ms(torch, lambda: ts_encode_plain(tcfg, g), reps=2)

        def ids_vals(lo, hi):
            i = torch.arange(lo, hi, device=device)
            return buckets_at(tcfg, i), signs_at(tcfg, i) * g[lo:hi]

        lib_ms, lib_out = _index_add_ms(torch, device, R, W, d, ids_vals)
        log(f"[kernels] index_add_ yardstick vs ts kernel at {what}: "
            f"max_abs_err {float((lib_out - got).abs().max()):.4g}")
        del lib_out
        # per (row, element): bucket map (add, and, and, shift, shift, or,
        # and), sign (mul, add, shift), sign-apply and add
        bound = bound_ms(d * g.element_size() + R * W * 4, d * R * 12.0)
        shape.update({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound[0], "bound_by": bound[1],
                      "library_ms": lib_ms})
        log(f"[kernels] ts_encode {what}: {plan.kernel} kernel {ms:.3f} ms"
            + (f", R-pass kernel {shape['rows_kernel_ms']:.3f} ms"
               if "rows_kernel_ms" in shape else "")
            + f"; bound {bound[0]:.4f} ms")
        shapes.append(shape)
        sketches.append((tcfg, got))
    return _shapes_row("ts_encode", "src/repro_torch/csrc/ts_encode.cu",
                       "src/repro/kernels/ts_encode.py:73", shapes), sketches


def ts_transpose_check(torch, what, tcfg, sk):
    """ts_transpose against its plain version (equal); returns its
    transposed sketch."""
    from repro_torch.kernels.heavymix_topk import (ts_transpose,
                                                   ts_transpose_plain)
    st = ts_transpose(tcfg, sk)
    if not torch.equal(st, ts_transpose_plain(tcfg, sk)):
        fail(f"ts_transpose at {what} (R={tcfg.rows}, W={tcfg.width}) "
             "differs from its plain version")
    return st


def ts_recover_checks(torch, buckets, wide) -> list[dict]:
    """The TS route's recovery at every bucket of the main path
    (``buckets``: (TS config, TS sketch, d, k) each, the sketch from the
    spiky g, whose heavy set far outnumbers k): the row-transposed sketch
    equal to the plain transpose, the TS-map scores and est (read through
    it) bit-equal to their plain version (``ts.decode`` and the
    reference's boost), the fused histogram equal to the plain one, and
    ``ops.ts_heavymix_recover``'s idx equal to the plain route's
    (``ts.decode`` + ``heavymix(estimates=)``), once under
    ``set_sync_debug_mode("error")``; times of the transpose, the kernel,
    the select and both routes. ``wide``: (TS config, sketch, d, k) at the
    CLI's default width, where n_r reaches W: the transpose and the scores
    held to plain there too. Returns the rows of heavymix_scores_ts and
    ts_transpose."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.core import heavymix as hm
    from repro_torch.core import ts_sketch as tsk
    from repro_torch.kernels import ops
    from repro_torch.kernels.heavymix_topk import (heavymix_scores_ts_hist,
                                                   heavymix_scores_ts_plain,
                                                   ts_transpose,
                                                   ts_transpose_plain)
    from repro_torch.kernels.topk_select import (radix_hist_plain,
                                                 slab_overflows, topk_select)
    shapes, tr_shapes = [], []
    for b, (tcfg, sk, d, k) in enumerate(buckets + [wide]):
        what = f"bucket {b}" if b < len(buckets) else "CLI default width"
        R, W = tcfg.rows, tcfg.width
        ccfg = cs.SketchConfig(rows=R, width=W, seed=tcfg.seed)
        ts_transpose_check(torch, what, tcfg, sk)
        tr_ms = time_ms(torch, lambda: ts_transpose(tcfg, sk), reps=10)
        tr_plain_ms = time_ms(torch, lambda: ts_transpose_plain(tcfg, sk),
                              reps=2)
        tr_bound = bound_ms(2 * R * W * 4, 0.0)
        log(f"[kernels] ts_transpose {what} (R={R}, W={W}, n_r="
            f"{[1 << (tcfg.bits - a) for a in tcfg.log_m]}): equal to plain; "
            f"{tr_ms:.4f} ms (plain {tr_plain_ms:.3f} ms, bound "
            f"{tr_bound[0]:.4f} ms)")
        tr_shapes.append({"shape": what, "rows": R, "width": W,
                          "max_abs_err": 0.0, "ms": tr_ms,
                          "plain_ms": tr_plain_ms, "bound_ms": tr_bound[0],
                          "bound_by": tr_bound[1], "library_ms": None})
        thr = cs.l2sq_estimate(sk) / k
        sc, est, hist = heavymix_scores_ts_hist(tcfg, sk, thr, d)
        sc_p, est_p = heavymix_scores_ts_plain(tcfg, sk, thr, d)
        err = float((est - est_p).abs().max())
        if not (torch.equal(est, est_p) and torch.equal(sc, sc_p)):
            fail(f"heavymix_scores_ts at {what} (d={d}, W={W}) disagrees "
                 f"with its plain version: max est err {err}")
        if not torch.equal(hist, radix_hist_plain(sc_p)):
            fail(f"heavymix_scores_ts' histogram at {what} differs from "
                 "the plain histogram of the same scores")
        n_heavy = int((sc >= 1e30).sum())
        del sc_p, est_p
        if b == len(buckets):
            log(f"[kernels] heavymix_scores_ts at {what} (d={d}, W={W}): "
                "est and scores bit-equal to plain, histogram equal")
            del sc, est, hist
            continue
        if not n_heavy > 2 * k:
            fail(f"TS recovery at bucket {b}: only {n_heavy} heavy "
                 f"coordinates for k={k}")
        idx = ops.ts_heavymix_recover(tcfg, sk, k, d)[0]

        def old_route():
            e = tsk.decode(tcfg, sk, d)
            return hm.heavymix(ccfg, sk, k, d, estimates=e)[0]

        idx_p = old_route()
        if not torch.equal(idx, idx_p):
            fail(f"ts_heavymix_recover at bucket {b} selects other "
                 f"coordinates than ts.decode + heavymix(estimates=): "
                 f"{int((idx != idx_p).sum())} of k={k} differ")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            idx_s = ops.ts_heavymix_recover(tcfg, sk, k, d)[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not torch.equal(idx_s, idx_p):
            fail("ts_heavymix_recover under set_sync_debug_mode differs")
        del idx, idx_p, idx_s
        log(f"[kernels] TS recovery bucket {b} d={d} k={k} ({n_heavy} "
            "heavy): scores and est bit-equal to plain, histogram equal; "
            "idx equal to ts.decode + heavymix(estimates=); a recovery under "
            "set_sync_debug_mode('error') raised nothing")
        ms = time_ms(torch, lambda: heavymix_scores_ts_hist(tcfg, sk, thr, d),
                     reps=10)
        plain_ms = time_ms(
            torch, lambda: heavymix_scores_ts_plain(tcfg, sk, thr, d), reps=2)
        slab_overflows(sk.device, reset=True)
        sel_ms = time_ms(torch, lambda: topk_select(sc, k, hist), reps=10)
        sel_over = slab_overflows(sk.device, reset=True) / 11
        if b == 0:
            select_overflow_checks(torch, [(
                f"the TS scores of bucket {b} ({n_heavy} tied at 1e30)", sc,
                k, hist)])
        new_ms = time_ms(torch, lambda: ops.ts_heavymix_recover(tcfg, sk, k, d),
                         reps=3)
        old_ms = time_ms(torch, old_route, reps=2)
        del sc, est, hist
        torch.cuda.empty_cache()
        # per coordinate and row: the transposed TS map (add, and, shift,
        # compare, shift, and, or) and sign (mul, add, and, negate); the
        # median's compare-exchanges; the boost and the histogram key
        ops_per = R * 11.0 + R * (R - 1) + 4
        bound = bound_ms(R * W * 4 + 4 + 2 * d * 4 + 2048 * 4, d * ops_per)
        log(f"[kernels] TS recovery bucket {b}: heavymix_scores_ts with its "
            f"histogram {ms:.3f} ms (the transpose {tr_ms:.4f} ms, launched "
            f"by it; plain {plain_ms:.1f} ms, bound {bound[0]:.4f} ms); "
            f"select {sel_ms:.3f} ms ({sel_over:g} slab overflows a call); "
            f"new route (ts_heavymix_recover) {new_ms:.3f} ms, old route "
            f"(ts.decode + heavymix(estimates=)) {old_ms:.3f} ms")
        shapes.append({"shape": what, "d": d, "rows": R, "width": W,
                       "k": k, "n_heavy": n_heavy, "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                       "bound_by": bound[1], "library_ms": None,
                       "transpose_ms": tr_ms,
                       "transpose_bound_ms": tr_bound[0],
                       "select_ms": sel_ms,
                       "select_slab_overflows_a_call": sel_over,
                       "new_route_ms": new_ms, "old_route_ms": old_ms})
    return [_shapes_row("heavymix_scores_ts",
                        "src/repro_torch/csrc/heavymix_scores.cu",
                        "src/repro/kernels/heavymix_topk.py:91", shapes),
            _shapes_row("ts_transpose",
                        "src/repro_torch/csrc/heavymix_scores.cu",
                        "src/repro/kernels/heavymix_topk.py:91 (the TS-map "
                        "instance's layout; the reference's ts.decode, "
                        "src/repro/core/ts_sketch.py:150, has no Pallas "
                        "kernel)", tr_shapes)]


def select_overflow_checks(torch, cases):
    """The select with slabs forced to overflow: for each (what, keys, k,
    hist) of ``cases``, at capacity 0 (every segment with keys in the first
    digit's bin reads them from x) and at a capacity between the CTAs'
    fewest and most such keys in a segment (some CTAs overflow), idx equal
    to ``topk_lower_index``'s and values with the same bits (NaN at the
    same places), and the device counter equal to the CTAs with a segment
    over its slots (every CTA where the bin outnumbers all the slots: then
    the slabs are off)."""
    from repro_torch.core.heavymix import topk_lower_index
    from repro_torch.kernels.topk_select import (RADIX_SHIFT, key_bits,
                                                 select_plan, slab_overflows,
                                                 topk_select)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    segments = 8   # a CTA's segments, one a warp (csrc/topk_select.cu)
    for what, x, k, hist in cases:
        n = x.shape[0]
        grid, chunk = select_plan(n, sms)
        counts, rest = hist.tolist(), k
        b1 = len(counts) - 1
        while rest > counts[b1]:   # the first digit's bin of the k-th key
            rest -= counts[b1]
            b1 -= 1
        inb = (key_bits(x) >> RADIX_SHIFT) == b1
        per = torch.zeros(grid * chunk, dtype=torch.int32, device=x.device)
        per[:n] = inb.to(torch.int32)
        most = per.view(grid, segments, chunk // segments).sum(2).amax(1)
        lo, hi = int(most.min()), int(most.max())
        caps = [0] + ([(lo + hi) // 8 * 4 * segments] if hi - lo >= 8
                      else [])
        v_o, i_o = topk_lower_index(x.abs(), k)
        for cap in caps:
            slab_overflows(x.device, reset=True)
            v, i = topk_select(x, k, hist, capacity=cap)
            got = slab_overflows(x.device, reset=True)
            # the slabs are off where the bin outnumbers all their slots:
            # then every CTA reads its keys in x
            off = counts[b1] > grid * cap
            want = grid if off else int((most > cap // segments).sum())
            if not (torch.equal(i, i_o) and _same_values(torch, v, v_o)):
                fail(f"topk_select at {what} with slab capacity {cap} "
                     "differs from topk_lower_index")
            if got != want:
                fail(f"topk_select at {what}, capacity {cap}: {got} CTAs "
                     f"overflowed, {want} hold a segment over its slots")
            log(f"[kernels] topk_select at {what} (n={n}, k={k}) with slab "
                f"capacity {cap} ({cap // segments} a segment): {got} of "
                f"{grid} CTAs overflowed (the most bin keys in a CTA's "
                f"segment: {lo}..{hi}); idx equal to topk_lower_index's, "
                "values bit-equal")


def _plant_nan(torch, sk, seed):
    """A copy of sketch ``sk`` with NaN in 12 cells of row 0 and 12 of row
    2 (one of them -NaN)."""
    s = sk.clone()
    gen = torch.Generator(device=s.device).manual_seed(seed)
    cols = torch.randint(0, s.shape[1], (2, 12), generator=gen,
                         device=s.device)
    s[0, cols[0]] = float("nan")
    s[2, cols[1]] = float("nan")
    s[2, cols[1, 0]] = -float("nan")
    return s


def _bits_equal(torch, a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _same_values(torch, a, b) -> bool:
    """NaN at the same places and the other values bit-equal (torch.abs on
    the card writes NaN as 0x7FFFFFFF; the select returns |x|'s own bits)."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and _bits_equal(torch, a[~nan], b[~nan]))


def nan_checks(torch, cfg, sk, d, k):
    """A NaN among a coordinate's R values makes its estimate NaN, as
    ``jnp.median``. On a copy of a main-path bucket's sketch with NaN
    planted: the decode, the scores and the TS-map scores kernels give the
    plain version's bits (NaN at the same coordinates) and its histogram;
    the select of each one's keys gives ``topk_lower_index``'s indices and
    values, the reference's ``jax.lax.top_k`` order (NaN first, by
    index)."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.heavymix import topk_lower_index
    from repro_torch.core.ts_sketch import TSketchConfig
    from repro_torch.kernels.heavymix_topk import (heavymix_scores_hist,
                                                   heavymix_scores_plain,
                                                   heavymix_scores_ts_hist,
                                                   heavymix_scores_ts_plain)
    from repro_torch.kernels.sketch_decode import (sketch_decode_hist,
                                                   sketch_decode_plain)
    from repro_torch.kernels.topk_select import radix_hist_plain, topk_select
    s = _plant_nan(torch, sk, 3)
    thr = cs.l2sq_estimate(s) / k
    tcfg = TSketchConfig(d=d, rows=cfg.rows, width=cfg.width, seed=cfg.seed)
    runs = (("sketch_decode", lambda: sketch_decode_hist(cfg, s, d),
             lambda: (sketch_decode_plain(cfg, s, d),)),
            ("heavymix_scores", lambda: heavymix_scores_hist(cfg, s, thr, d),
             lambda: heavymix_scores_plain(cfg, s, thr, d)),
            ("heavymix_scores_ts",
             lambda: heavymix_scores_ts_hist(tcfg, s, thr, d),
             lambda: heavymix_scores_ts_plain(tcfg, s, thr, d)))
    for name, kernel, plain in runs:
        got = kernel()
        want = plain()
        for a, b in zip(got[:-1], want):
            if not _bits_equal(torch, a, b):
                fail(f"{name} on a sketch with NaN (d={d}) is not bit-equal "
                     f"to plain: NaN at {int(torch.isnan(a).sum())} against "
                     f"{int(torch.isnan(b).sum())} coordinates")
        key, hist = got[0], got[-1]
        if not torch.equal(hist, radix_hist_plain(want[0])):
            fail(f"{name}'s histogram on a sketch with NaN differs from plain")
        n_nan = int(torch.isnan(want[0]).sum())
        if not 0 < n_nan < k:
            fail(f"{name}: {n_nan} NaN keys, want between 0 and k={k}")
        v, i = topk_select(key, k, hist)
        v_o, i_o = topk_lower_index(want[0].abs(), k)
        if not (torch.equal(i, i_o) and _same_values(torch, v, v_o)):
            fail(f"topk_select of {name}'s keys with NaN differs from "
                 "topk_lower_index")
        nan_idx = torch.nonzero(torch.isnan(want[0])).reshape(-1)
        if not (bool(torch.isnan(v[:n_nan]).all())
                and torch.equal(i[:n_nan], nan_idx)):
            fail(f"topk_select of {name}'s keys does not rank the NaN keys "
                 "first, by index")
        log(f"[kernels] NaN: {name} at d={d} R={cfg.rows} W={cfg.width}: "
            f"{n_nan} NaN estimates, bits equal to plain, histogram equal; "
            f"the select (k={k}) equal to topk_lower_index, NaN first")
        if name == "sketch_decode":
            select_overflow_checks(torch, [
                (f"{name}'s keys with NaN", key, kk, hist)
                for kk in (n_nan, k)])
        del got, want, key, hist, v, i, v_o, i_o
    del s


def kernels_phase(torch, device, ts) -> list[dict]:
    """Every kernel at the full-width step's shapes (the encodes, the
    decode, the TS transpose, the TS-map scores and the select at both
    buckets; the select also with its slabs forced to overflow), and small
    cases."""
    gen = torch.Generator(device=device).manual_seed(1)
    parts, sizes = ts.compressor.parts, ts.compressor.spec.sizes
    for b, (part, d) in enumerate(zip(parts, sizes)):
        log(f"[kernels] main-path shapes, bucket {b}: d={d} "
            f"R={part.sketch.rows} W={part.sketch.width} k={part.k}")
    gs = [_spiky(torch, gen, device, d, part.k // 4)
          for part, d in zip(parts, sizes)]
    enc, sks = encode_checks(
        torch, device, gen, [(p.sketch, g) for p, g in zip(parts, gs)])
    out = [enc] + scores_decode_checks(
        torch, device, gen, [(p.sketch, sk, d, p.k) for p, sk, d in
                             zip(parts, sks, sizes)])
    nan_checks(torch, parts[1].sketch, sks[1], sizes[1], parts[1].k)
    del sks
    ts_row, ts_sks = ts_checks(torch, device, gen,
                               [(p.sketch, g) for p, g in zip(parts, gs)])
    del gs
    torch.cuda.empty_cache()
    cases = [(tcfg, sk, d, p.k) for (tcfg, sk), d, p in
             zip(ts_sks, sizes, parts)]
    wide_cfg, wide_sk = ts_sks[len(parts)]
    out += [ts_row] + ts_recover_checks(
        torch, cases, (wide_cfg, wide_sk, sizes[0], parts[0].k))
    del ts_sks, cases, wide_sk
    for kr in out:
        log("[kernels] " + json.dumps({key: kr[key] for key in (
            "name", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")}))
    return out


def check_launches(tag, counts, launched, not_launched=()):
    for name in launched:
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the {tag} path")
    for name in not_launched:
        if counts.get(name, 0) != 0:
            fail(f"kernel {name} launched {counts[name]} times on the {tag} "
                 "path, which should not run it")


def train_phase(torch, cfg, opt, ts, tag="train", between=None) -> dict:
    """Three full-width steps; counts set to 0 just before, read after.
    Returns the state, the stream, the counts, the step seconds, the losses,
    the peak device memory and the select's CTAs whose slab overflowed
    (the device counter, zeroed before the steps and read after them).
    ``between(state, global batch)``: called before each step with the
    state and batch that step gets, outside the step's timing."""
    from repro_torch.data import LMStream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.kernels.topk_select import slab_overflows
    from repro_torch.launch.train import train_loop
    state = ts.init_state(opt, torch.Generator(device=ts.device)
                          .manual_seed(0))
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    sizes = ts.compressor.spec.sizes
    log(f"[{tag}] {ts.fs.cfg.name} widths, {cfg.n_layers} layers: d={ts.d_local} "
        f"buckets {list(sizes)} bwd_chunks {ts.bwd_chunks} fuse_encode "
        f"{ts.fuse_encode} "
        f"(k, W) {[(c.k, c.sketch.width) for c in ts.compressor.parts]} "
        f"encoder {ts.compressor.parts[0].encoder} "
        f"P={ts.nworkers} batch {TRAIN_BATCH} seq {TRAIN_SEQ}")
    def before(step, st, *_):
        if between is not None and step < TRAIN_STEPS:
            between(st, stream.global_batch_at(step, ts.device))

    before(0, state)
    slab_overflows(ts.device, reset=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    state, hist, times = train_loop(
        ts, state, lambda s: stream.global_batch_at(s, ts.device),
        range(TRAIN_STEPS), log_every=1, last=TRAIN_STEPS - 1,
        after_step=lambda s, st, _: before(s + 1, st))
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    overflows = slab_overflows(ts.device, reset=True)
    for s, (loss, t) in enumerate(zip(hist, times)):
        log(f"[{tag}] step {s}: loss {loss!r}  step_s {t:.4f}")
    log(f"[{tag}] max_memory_allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB); launches {counts}; select CTAs whose "
        f"slab overflowed: {overflows} over {counts.get('topk_select', 0)} "
        "selects")
    if not all(math.isfinite(x) for x in hist):
        fail(f"non-finite loss on the {tag} path: {hist}")
    return {"state": state, "stream": stream, "counts": counts,
            "times": times, "losses": hist, "peak": peak,
            "slab_overflows": overflows}


def full_width_ts_step(torch, device, ts, opt):
    """The full-width cell with gs-SGD's TS-sketch encoder: the main path's
    resolved geometry and buckets, ``encoder="ts"`` through
    ``compressor_kw`` (the spec has no encoder field, as in the
    reference)."""
    from repro_torch.core.gs_sgd import make_train_step
    base = ts.compressor.base
    kw = dict(k=base.k, rows=base.sketch.rows, width=base.sketch.width,
              seed=base.sketch.seed, allreduce_mode=base.allreduce_mode,
              wire_dtype=base.wire_dtype, encoder="ts")
    return make_train_step(ts.fs.cfg, ts.ma, opt, compressor_name="gs-sgd",
                           compressor_kw=kw, buckets=ts.n_buckets,
                           overlap=ts.overlap, dtype=torch.float32,
                           device=device)


PHASES = ("loss_and_grad", "forward", "backward", "encode", "allreduce",
          "recover", "exchange", "optimizer")


def span_split(events) -> dict:
    """Device time per span from a Chrome trace's events, each device event
    (kernel, memcpy, memset) counted once: it goes to the innermost span
    whose host time range holds its launch, the runtime or driver call with
    the same correlation id, whatever thread made that call (the backward
    launches from autograd's device thread inside ``loss_and_grad``; the
    hand kernels launch through ctypes and link the same way). A device
    event with no such call counts as unlinked."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"].split("/")[0])
                   for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].split("/")[0] in PHASES)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    us = {p: 0.0 for p in PHASES}
    outside = unlinked = busy = 0.0
    by_kernel: dict[str, float] = {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        dur = float(e["dur"])
        busy += dur
        by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + dur
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        inner = [sp for sp in spans if t is not None and sp[0] <= t < sp[1]]
        if t is None:
            unlinked += dur
        elif inner:
            us[max(inner)[2]] += dur   # latest start: the innermost
        else:
            outside += dur
    return {"device_busy_ms": busy / 1e3,
            "span_device_ms": {p: v / 1e3 for p, v in us.items()},
            "outside_spans_ms": outside / 1e3,
            "unlinked_ms": unlinked / 1e3,
            "by_kernel_ms": {k: v / 1e3 for k, v in by_kernel.items()}}


def profile_phase(torch, ts, state, stream, tag="profile"):
    """One more step under torch.profiler: device time per span. Returns
    the state and the split (wall, busy, spans, idle share, peak)."""
    from repro_torch.launch.train import shard_batch
    batch = shard_batch(stream.global_batch_at(TRAIN_STEPS, ts.device),
                        ts.nworkers)

    def step():
        st, m = ts.fn(state, batch)
        float(m["loss"])
        return st

    return profile_call(torch, tag, step)


def profile_call(torch, tag, fn):
    """``fn()`` once under torch.profiler: device time per span (``PHASES``;
    a path without spans has all of it outside them), the idle share, the
    peak memory and the largest kernels. Returns (fn's result, the
    split)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        result = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    path = os.path.join(ROOT, "build", f"{tag}_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    split = span_split(trace["traceEvents"] if isinstance(trace, dict)
                       else trace)
    by_kernel = split.pop("by_kernel_ms")
    wall_ms, busy_ms = wall * 1e3, split["device_busy_ms"]
    parts_ms = (sum(split["span_device_ms"].values())
                + split["outside_spans_ms"] + split["unlinked_ms"])
    if abs(parts_ms - busy_ms) > 1e-6 * max(busy_ms, 1.0):
        fail(f"{tag}: spans add up to {parts_ms} ms of {busy_ms} ms busy")
    out = {"step_wall_ms": wall_ms, **split,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"[{tag}] " + json.dumps(out))
    log(f"[{tag}] spans + outside + unlinked = {parts_ms:.3f} ms = device "
        "busy (each device event counted once)")
    log(f"[{tag}] recover span {split['span_device_ms']['recover']:.3f} ms "
        f"of {busy_ms:.3f} ms busy; step wall {wall_ms:.3f} ms")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:16]
    for name, ms in top:
        log(f"[{tag}] kernel {ms:10.3f} ms  {name[:110]}")
    if busy_ms <= 0:
        log(f"[{tag}] the profiler saw no device time: not measured")
    return result, out


def fragment_encode_checks(torch, device, ts, tag="train_interleave"
                           ) -> tuple[list[dict], dict]:
    """The fused encode's launches at the fragment sizes the interleaved
    cell gives them: each fragment of each bucket added at its offset into
    an exact sketch of its own, the partials summed (as integers) and
    finished (the merge): bit-equal to the plain whole-bucket encode and to
    the kernel's, and within ENCODE_REL_TOL * max|S|; times of each partial
    encode, of the merge and of the whole-bucket encode. Returns the rows
    and the finish kernel's row (timed at bucket 0: both workers' exact
    sketches, as the merge finishes them)."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.kernels.sketch_encode import (sketch_encode,
                                                   sketch_encode_finish,
                                                   sketch_encode_finish_plain,
                                                   sketch_encode_into,
                                                   sketch_encode_plain)
    gen = torch.Generator(device=device).manual_seed(2)
    rows, finish_row = [], None
    for b, (part, d, fr) in enumerate(zip(ts.compressor.parts,
                                          ts.compressor.spec.sizes,
                                          ts.plan.fragments())):
        cfg, R, W = part.sketch, part.sketch.rows, part.sketch.width
        g = _spiky(torch, gen, device, d, max(1, part.k // 4))
        want = sketch_encode_plain(cfg, g)
        lim = ENCODE_REL_TOL * float(want.abs().max())

        def partial(o, n):
            acc = cs.exact_zeros(cfg, device=device)
            return sketch_encode_into(cfg, g[o:o + n], acc, index_offset=o)

        parts = [partial(o, n) for o, n in fr]

        def merge():
            out = parts[-1]
            for p in parts[-2::-1]:
                out = out + p
            return sketch_encode_finish(out)

        merged = merge()
        err = float((merged - want).abs().max())
        same = (_bits_equal(torch, merged, want)
                and _bits_equal(torch, merged, sketch_encode(cfg, g)))
        if not (same and err <= lim):
            fail(f"the partial encodes of bucket {b} merged are not "
                 f"bit-equal to the whole-bucket encode (max_abs_err {err}, "
                 f"limit {lim})")
        del want, merged
        frag_ms = [time_ms(torch, lambda o=o, n=n: partial(o, n), reps=10)
                   for o, n in fr]
        whole_ms = time_ms(torch, lambda: sketch_encode(cfg, g), reps=10)
        merge_ms = time_ms(torch, merge, reps=10)
        zero_ms = time_ms(torch, lambda: cs.exact_zeros(cfg, device=device),
                          reps=10)
        bounds = [bound_ms(n * 4 + R * W * 4, n * R * 7.0)[0] for _, n in fr]
        row = {"bucket": b, "d": d, "rows": R, "width": W,
               "fragments": [{"offset": o, "n": n, "ms": ms, "bound_ms": bd}
                             for (o, n), ms, bd in zip(fr, frag_ms, bounds)],
               "partials_ms": sum(frag_ms), "merge_ms": merge_ms,
               "exact_zeros_ms": zero_ms,
               "whole_ms": whole_ms,
               "whole_bound_ms": bound_ms(d * 4 + R * W * 4, d * R * 7.0)[0],
               "max_abs_err": err, "bit_equal": same}
        log(f"[{tag}] encode bucket {b} (d={d}, R={R}, W={W}): "
            f"{len(fr)} partial(s) {[round(x, 4) for x in frag_ms]} ms = "
            f"{sum(frag_ms):.4f} ms + merge (integer sum and finish) "
            f"{merge_ms:.4f} ms, whole-bucket encode {whole_ms:.4f} ms; "
            f"zeroing one exact accumulator {zero_ms:.4f} ms; "
            f"merged partials bit-equal to the whole-bucket encode "
            f"(max_abs_err {err:.4g}, limit {lim:.4g})")
        rows.append(row)
        if b == 0:
            both = cs.exact_zeros(cfg, (ts.nworkers,), device=device)
            for p in range(ts.nworkers):
                sketch_encode_into(cfg, g, both.worker(p))
            fin, fin_p = sketch_encode_finish(both), \
                sketch_encode_finish_plain(both)
            if not _bits_equal(torch, fin, fin_p):
                fail("sketch_encode_finish is not bit-equal to plain")
            ms = time_ms(torch, lambda: sketch_encode_finish(both), reps=10)
            plain_ms = time_ms(
                torch, lambda: sketch_encode_finish_plain(both), reps=2)
            cells = ts.nworkers * R * W
            finish_row = _row(
                "sketch_encode_finish", "src/repro_torch/csrc/sketch_encode.cu",
                "src/repro/kernels/sketch_encode.py:87",
                float((fin - fin_p).abs().max()), ms, plain_ms,
                bound_ms(cells * (24 + 4 + 4), cells * 12.0), None)
            log(f"[{tag}] sketch_encode_finish of {ts.nworkers} x "
                f"({R}, {W}) exact sketches: {ms:.4f} ms, bit-equal to plain "
                f"({plain_ms:.3f} ms)")
            del both, fin, fin_p
        del g, parts
        torch.cuda.empty_cache()
    return rows, finish_row


class plain_calls:
    """Counts the calls of every kernel's plain version while it is open
    (the wrappers call them by their module's global name)."""

    NAMES = {"sketch_encode": ("sketch_encode_plain",
                               "sketch_encode_into_plain",
                               "sketch_encode_finish_plain"),
             "sketch_decode": ("sketch_decode_plain", "radix_hist_plain"),
             "heavymix_topk": ("heavymix_scores_plain",
                               "heavymix_scores_ts_plain",
                               "ts_transpose_plain", "radix_hist_plain"),
             "topk_select": ("topk_select_plain",),
             "ts_encode": ("ts_encode_plain",)}

    def __enter__(self):
        import importlib
        self.counts, self.saved = {}, []
        for mod_name, names in self.NAMES.items():
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            for name in names:
                f = getattr(mod, name)

                def counted(*a, _f=f, _n=name, **kw):
                    self.counts[_n] = self.counts.get(_n, 0) + 1
                    return _f(*a, **kw)

                setattr(mod, name, counted)
                self.saved.append((mod, name, f))
        return self.counts

    def __exit__(self, *exc):
        for mod, name, f in self.saved:
            setattr(mod, name, f)


def fused_sketch_check(torch, ts, state, stream, tag="train_interleave"):
    """One more interleaved step (not counted) in which every bucket's
    merged sketch (each exchange group's, on the sharded layouts) is held
    against the whole-bucket encode of the same u
    (``GsSGD.stage_encode_merge``, wrapped for this step only): bit-equal,
    and within ENCODE_REL_TOL * max|S|."""
    from repro_torch.core import compression as comp
    from repro_torch.launch.train import shard_batch
    orig = comp.GsSGD.stage_encode_merge
    sizes = list(ts.compressor.spec.sizes)
    index = {id(c): b for b, c in enumerate(ts.compressor.parts)}
    seen = {}

    def checked(self, pieces):
        u, sk = orig(self, pieces)
        whole = self._encode_workers(u)
        err = float((sk.to(torch.float32) - whole).abs().max())
        lim = ENCODE_REL_TOL * float(whole.abs().max())
        same = _bits_equal(torch, sk.to(torch.float32).contiguous(), whole)
        seen.setdefault(index[id(self)], []).append(
            (len(pieces), err, lim, same))
        return u, sk

    comp.GsSGD.stage_encode_merge = checked
    try:
        batch = shard_batch(stream.global_batch_at(TRAIN_STEPS + 1, ts.device),
                            ts.nworkers)
        state, m = ts.fn(state, batch)
        float(m["loss"])
    finally:
        comp.GsSGD.stage_encode_merge = orig
    groups = max(1, len(ts.comp_groups))
    if sorted(seen) != list(range(len(sizes))) or any(
            len(v) != groups for v in seen.values()):
        fail(f"the fused merge ran for buckets {sorted(seen)} "
             f"({[len(v) for v in seen.values()]} times), not each bucket "
             f"once for each of {groups} exchange group(s)")
    for b, runs in sorted(seen.items()):
        n = runs[0][0]
        err, lim = max(r[1] for r in runs), min(r[2] for r in runs)
        same = all(r[3] for r in runs)
        log(f"[{tag}] fused sketch bucket {b} ({n} fragment(s), "
            f"{len(runs)} exchange group(s)): bit-equal to the whole-bucket "
            f"encode of the same u: {same}; max_abs_err {err:.4g} (limit "
            f"{lim:.4g} = {ENCODE_REL_TOL} * max|S|)")
        if not err <= lim:
            fail(f"fused sketch of bucket {b} differs from the whole-bucket "
                 f"encode: {err} > {lim}")
        if not same:
            fail(f"fused sketch of bucket {b} is not bit-equal to the "
                 "whole-bucket encode")
    return state


def _ef_leaves(ef) -> list:
    """An EF state's tensors: a bucket each, or (sharded layouts) each
    exchange group's buckets in group order."""
    if isinstance(ef, (tuple, list)):
        return [t for e in ef for t in _ef_leaves(e)]
    return [ef]


def _snapshot(state) -> dict:
    """The params' first row (worker 0's; model rank 0's workers on the
    sharded layouts) and every worker's EF zero pattern (the last step's
    selected coordinates), copied to the host."""
    return {"params": {k: v[0].cpu() for k, v in state["params"].items()},
            "selected": [(e == 0).cpu() for e in _ef_leaves(state["ef"])]}


def compare_snapshots(got, want, tag="train_interleave") -> None:
    """The interleaved run's params and selection against the bucketed
    run's after the same counted steps: the selected coordinates equal,
    the params within INTERLEAVE_PARAM_RTOL / _ATOL."""
    n_sel = sum(int(s.sum()) for s in want["selected"])
    sel_diff = sum(int((a != b).sum())
                   for a, b in zip(got["selected"], want["selected"]))
    bad, worst = 0, 0.0
    for k, b in want["params"].items():
        diff = (got["params"][k] - b).abs()
        bad += int((diff > INTERLEAVE_PARAM_ATOL
                    + INTERLEAVE_PARAM_RTOL * b.abs()).sum())
        worst = max(worst, float(diff.max()))
    log(f"[{tag}] after {TRAIN_STEPS} steps: selected "
        f"coordinates {n_sel} (EF zero pattern), {sel_diff} differ; params "
        f"max_abs_diff {worst:.4g}, {bad} beyond rtol "
        f"{INTERLEAVE_PARAM_RTOL} / atol {INTERLEAVE_PARAM_ATOL}")
    if sel_diff:
        fail(f"the interleaved run selected other coordinates than the "
             f"bucketed run: {sel_diff} of {n_sel} differ")
    if bad:
        fail(f"the interleaved run's params differ from the bucketed run's "
             f"at {bad} coordinates (max {worst})")


def interleave_phase(torch, device, tag, build) -> dict:
    """A cell at buckets 4 with the chunked backward and the fused
    interleave (``tag``; ``build(exchange)`` gives the cell's (cfg, opt,
    step)): the partial encodes at the cell's fragment shapes bit-equal
    to the whole-bucket encode and timed; three counted steps
    (``check_interleave_launches``: a partial encode per fragment and
    (rank, worker), a finish per bucket and exchange group); one more
    step with every fused sketch (every group's) held against the
    whole-bucket encode; one whose worker-0 packed gradient of each
    bucket runs the route's kernels bit-equal to plain, timed at the
    cell's buckets-4 shapes; one profiled (``profile_`` + the tag without
    ``train_``); then three steps of the same cell at buckets 4 without
    chunks from the same seed (the tag's ``interleave`` read
    ``bucketed4``): the first losses equal, the later within
    INTERLEAVE_LOSS_RTOL, the same selections, the params within
    INTERLEAVE_PARAM_*; one profiled step of it (module docstring,
    phases 6 and 6g')."""
    cfg, opt, ts = build(interleave_exchange())
    if not (ts.interleave and ts.bwd_chunks == INTERLEAVE_CHUNKS):
        fail(f"{tag}: the step does not run the interleave (interleave "
             f"{ts.interleave}, bwd_chunks {ts.bwd_chunks})")
    frags = ts.plan.fragments()
    log(f"[{tag}] d_local {ts.d_local}; plan: sizes {list(ts.plan.sizes)}, "
        f"readiness {list(ts.plan.readiness)}, order {list(ts.plan.order)}, "
        f"chunks {list(ts.plan.chunks)}; fragments {frags} "
        f"({sum(len(f) for f in frags)} a worker); exchange groups "
        f"{[(r, list(range(*sl.indices(ts.nworkers)))) for r, sl in ts.comp_groups]}")
    frag_rows, finish_row = fragment_encode_checks(torch, device, ts, tag=tag)
    with plain_calls() as plain:
        run = train_phase(torch, cfg, opt, ts, tag=tag)
    counts = run["counts"]
    check_interleave_launches(tag, ts, counts, plain)
    snap = _snapshot(run["state"])
    state = fused_sketch_check(torch, ts, run.pop("state"), run["stream"],
                               tag=tag)
    state, got = capture_step(torch, ts, state, run["stream"])
    state, prof = profile_phase(torch, ts, state, run["stream"],
                                tag="profile_" + tag[len("train_"):])
    del state
    torch.cuda.empty_cache()
    shapes = route_checks(torch, tag, ts.compressor.parts, got, timed=True)
    del ts, got
    torch.cuda.empty_cache()
    base_tag = tag.replace("interleave", "bucketed4")
    _, _, ts_b = build(dataclasses.replace(main_exchange(),
                                           buckets=INTERLEAVE_BUCKETS))
    base = train_phase(torch, cfg, opt, ts_b, tag=base_tag)
    compare_snapshots(snap, _snapshot(base["state"]), tag=tag)
    del snap
    state, prof_b = profile_phase(torch, ts_b, base.pop("state"),
                                  base["stream"],
                                  tag="profile_" + base_tag[len("train_"):])
    del state, ts_b
    torch.cuda.empty_cache()
    check_interleaved_losses(tag, run, base)
    return {"counts": counts, "fragments": frag_rows,
            "finish_row": finish_row, "shapes": shapes,
            "times": run["times"], "peak": run["peak"], "profile": prof,
            "base_times": base["times"], "base_peak": base["peak"],
            "base_profile": prof_b}


def train_interleave_phase(torch, device) -> dict:
    """The main path's cell through ``interleave_phase``."""
    return interleave_phase(
        torch, device, "train_interleave",
        lambda ex: full_width_step(torch, device, exchange=ex))


def decode_route(part, d: int) -> bool:
    """Does ``ops.heavymix_recover`` take the decode route for a bucket of
    ``d`` coordinates under compressor ``part``? (d > 2^22 and d > 4k,
    greedy fill; else the scores kernel.)"""
    from repro_torch.core.heavymix import _CHUNK
    return not part.faithful_heavymix and d > _CHUNK and d > 4 * part.k


def check_interleave_launches(tag, ts, counts, plain,
                              one_process=False) -> int:
    """The fused interleave's launch counts: a partial encode per fragment
    and (model rank, worker), one finish per bucket and exchange group
    (each merge finishes the group's workers' sketches), a select per
    recovery, and the decode or the scores kernel per recovery as each
    bucket's size and k route it (``decode_route``); no plain version.
    ``one_process``: one process of a mesh (one rank, one worker, one
    group), ``ts`` its simulated step. Returns the fragments a worker."""
    n_frags = sum(len(f) for f in ts.plan.fragments())
    n_dec = sum(decode_route(c, d) for c, d in zip(ts.compressor.parts,
                                                    ts.compressor.spec.sizes))
    pairs = 1 if one_process else ts.ma.tp * ts.nworkers
    groups = 1 if one_process else max(1, len(ts.comp_groups))
    per = pairs * TRAIN_STEPS
    want = {"sketch_encode": n_frags * per,
            "sketch_encode_finish": ts.n_buckets * groups * TRAIN_STEPS,
            "topk_select": ts.n_buckets * per,
            "sketch_decode": n_dec * per,
            "heavymix_scores": (ts.n_buckets - n_dec) * per}
    for name, n in want.items():
        if counts.get(name, 0) != n:
            fail(f"{name} launched {counts.get(name, 0)} times on the {tag} "
                 f"path, not {n}")
    check_launches(tag, counts, (), ("ts_encode", "heavymix_scores_ts",
                                     "ts_transpose"))
    if plain:
        fail(f"plain versions called on the {tag} path: {plain}")
    log(f"[{tag}] sketch_encode launches {want['sketch_encode']} = "
        f"{n_frags} fragments x {pairs} (model rank, worker) pair(s) x "
        f"{TRAIN_STEPS} steps; finish {ts.n_buckets} buckets x {groups} "
        f"exchange group(s) x {TRAIN_STEPS}; {n_dec} bucket(s) on the "
        "decode route, "
        f"{ts.n_buckets - n_dec} on the scores route ({want}); no plain "
        "version called")
    return n_frags


def check_interleaved_losses(tag, run, base) -> None:
    """The interleaved run's losses against the bucketed run's from the
    same seed: the first equal (the same forward), the later ones within
    INTERLEAVE_LOSS_RTOL."""
    li, lb = run["losses"], base["losses"]
    log(f"[{tag}] losses interleaved {li} / bucketed {lb}; "
        f"steps after the first {run['times'][1:]} / {base['times'][1:]} s; "
        f"peak memory {run['peak']} / {base['peak']} bytes "
        f"({(run['peak'] - base['peak']) / 2**30:+.3f} GiB)")
    if li[0] != lb[0]:
        fail(f"the first interleaved loss {li[0]!r} differs from the "
             f"bucketed step's {lb[0]!r}")
    if not _close(lb[1:], li[1:], INTERLEAVE_LOSS_RTOL):
        fail(f"interleaved losses {li} differ from the bucketed step's {lb} "
             f"beyond rtol {INTERLEAVE_LOSS_RTOL}")
    log(f"[{tag}] first losses equal; later ones within rtol "
        f"{INTERLEAVE_LOSS_RTOL} (largest relative difference "
        f"{max(abs(a - b) / abs(b) for a, b in zip(li, lb)):.3g})")


def minicpm_step(torch, device, p=TRAIN_P, allreduce_mode="psum",
                 record=True, ma=None):
    """The train_minicpm cell's step (no state allocated yet): minicpm-2b
    at its published widths, MINICPM_LAYERS layers, P = ``p`` (TRAIN_P),
    buckets = 2, ``allreduce_mode`` (psum), SketchSpec(rows=5, width=None,
    k=None) resolved at its d, microbatch MINICPM_MICROBATCH, clip
    MINICPM_CLIP, the faithful fill; AdamW under wsd(TRAIN_LR, warmup=1,
    stable=0, decay=2), with ``record`` its apply wrapped to record the
    squared norm of each worker's applied gradient at step 0; ``ma``: a
    process mesh's axes (P = its data axis) in place of the simulated P.
    Returns (cfg, opt, ts, schedule, the recorded norms by step)."""
    from repro_torch.api import ExchangeSpec, SketchSpec
    from repro_torch.configs.minicpm_2b import CONFIG
    from repro_torch.core.gs_sgd import MeshAxes, make_train_step
    from repro_torch.optim import make as make_opt
    from repro_torch.optim import wsd
    cfg = dataclasses.replace(CONFIG, n_layers=MINICPM_LAYERS)
    sched = wsd(TRAIN_LR, warmup=1, stable=0, decay=2)
    base = make_opt("adamw", lr=sched)
    applied: dict[int, torch.Tensor] = {}

    def apply(p, g, state, step):
        if step == 0:  # the checked step only: the f64 sum costs ~10 ms
            sq = torch.sum(g.double() ** 2, dim=tuple(range(1, g.dim())))
            applied[step] = applied.get(step, 0) + sq
        return base.apply(p, g, state, step)

    opt = dataclasses.replace(base, apply=apply) if record else base
    spec = ExchangeSpec(compressor="gs-sgd", buckets=2, overlap=True,
                        allreduce_mode=allreduce_mode,
                        sketch=SketchSpec(rows=5, width=None, k=None))
    ma = ma or MeshAxes(tp=1, data=p, tp_axis=None)
    d = make_train_step(cfg, ma, opt, spec=spec, device=device).d_local
    kw = dict(spec.compressor_kw(d), faithful_heavymix=True)
    ts = make_train_step(cfg, ma, opt, compressor_name="gs-sgd",
                         compressor_kw=kw, buckets=2, overlap=True,
                         microbatch=MINICPM_MICROBATCH,
                         clip_norm=MINICPM_CLIP, dtype=torch.float32,
                         device=device)
    return cfg, opt, ts, sched, applied


def minicpm_filler_checks(torch, device, ts) -> list[dict]:
    """heavymix_scores with the faithful fill's filler at the cell's bucket
    shapes: scores and est bit-equal to plain, the histogram equal to the
    plain one; times of the kernel and of the plain version."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.heavymix import draw_filler
    from repro_torch.kernels.heavymix_topk import (heavymix_scores_hist,
                                                   heavymix_scores_plain)
    from repro_torch.kernels.sketch_encode import sketch_encode
    from repro_torch.kernels.topk_select import radix_hist_plain
    gen = torch.Generator(device=device).manual_seed(5)
    shapes = []
    for b, (part, d) in enumerate(zip(ts.compressor.parts,
                                      ts.compressor.spec.sizes)):
        cfg, k = part.sketch, part.k
        sk = sketch_encode(cfg, _spiky(torch, gen, device, d, k // 4))
        thr = cs.l2sq_estimate(sk) / k
        fill = draw_filler(d, device)
        sc, est, hist = heavymix_scores_hist(cfg, sk, thr, d, fill)
        sc_p, est_p = heavymix_scores_plain(cfg, sk, thr, d, fill)
        if not (_bits_equal(torch, sc, sc_p) and _bits_equal(torch, est,
                                                             est_p)):
            fail(f"heavymix_scores with the filler at minicpm bucket {b} is "
                 "not bit-equal to plain")
        if not torch.equal(hist, radix_hist_plain(sc_p)):
            fail(f"heavymix_scores' histogram with the filler at minicpm "
                 f"bucket {b} differs from plain")
        n_heavy = int((sc >= 1e30).sum())
        del sc, est, hist, sc_p, est_p
        ms = time_ms(torch, lambda: heavymix_scores_hist(cfg, sk, thr, d,
                                                         fill), reps=10)
        plain_ms = time_ms(torch, lambda: heavymix_scores_plain(
            cfg, sk, thr, d, fill), reps=2)
        R, W = cfg.rows, cfg.width
        bound = bound_ms(R * W * 4 + 4 + 3 * d * 4 + 2048 * 4,
                         d * (R * 6.0 + R * (R - 1) + 4))
        log(f"[train_minicpm] heavymix_scores with the filler at bucket {b} "
            f"(d={d}, R={R}, W={W}, k={k}, {n_heavy} heavy): bit-equal to "
            f"plain, histogram equal; {ms:.3f} ms (plain {plain_ms:.1f} ms)")
        shapes.append({"shape": f"train_minicpm bucket {b}, faithful filler",
                       "d": d, "rows": R, "width": W, "max_abs_err": 0.0,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                       "bound_by": bound[1], "library_ms": None})
        del sk, fill
        torch.cuda.empty_cache()
    return shapes


def train_minicpm_phase(torch, device) -> dict:
    """minicpm-2b at its published widths with microbatch, clip, wsd and
    the faithful fill (see MINICPM_*): three counted steps (sketch_encode,
    heavymix_scores with its filler and topk_select once per bucket and
    worker each, the decode never, no plain version called); step 0's
    microbatched loss against the full-batch loss of the same params (lr
    is 0 at step 0, so they do not move) and the applied gradient's norm
    against min(grad_norm, clip); one profiled step; the filler scores
    kernel at the cell's shapes. Returns the counts and those shapes."""
    from repro_torch.models import model as mdl
    from repro_torch.models.flatten import SEG_NAMES
    cfg, opt, ts, sched, applied = minicpm_step(torch, device)
    lrs = [float(sched(s)) for s in range(TRAIN_STEPS)]
    log(f"[train_minicpm] minicpm-2b widths (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"tied embeddings {cfg.tie_embeddings}), {cfg.n_layers} layers; "
        f"microbatch {MINICPM_MICROBATCH}, clip {MINICPM_CLIP}, faithful "
        f"fill; wsd lr at steps 0-{TRAIN_STEPS - 1}: {lrs}")
    first = {}
    fn = ts.fn

    def step_fn(state, batch):
        """The counted step; after step 0 (lr 0: the params did not move)
        the full-batch loss of each worker's params, with no microbatch."""
        new, m = fn(state, batch)
        if not first:
            with torch.no_grad():
                first["full"] = [float(mdl.loss_fn(
                    cfg, ts.fs, {k: new["params"][k][p] for k in SEG_NAMES},
                    {k: batch[k][p] for k in ("tokens", "labels")},
                    dtype=torch.float32)) for p in range(ts.nworkers)]
            first["m"] = m
        return new, m

    with plain_calls() as plain:
        run = train_phase(torch, cfg, opt, dataclasses.replace(ts, fn=step_fn),
                          tag="train_minicpm")
    counts = run["counts"]
    recoveries = ts.nworkers * ts.n_buckets * TRAIN_STEPS
    for name in ("sketch_encode", "sketch_encode_finish", "heavymix_scores",
                 "topk_select"):
        if counts.get(name) != recoveries:
            fail(f"{name} launched {counts.get(name)} times on the "
                 f"train_minicpm path, not {recoveries} (once a bucket, "
                 "worker and step)")
    check_launches("train_minicpm", counts, (),
                   ("sketch_decode", "ts_encode", "heavymix_scores_ts",
                    "ts_transpose"))
    if plain:
        fail(f"plain versions called on the train_minicpm path: {plain}")
    log(f"[train_minicpm] launches {counts}: each of sketch_encode, "
        f"sketch_encode_finish, heavymix_scores (with the filler) and "
        f"topk_select {recoveries} = "
        f"{ts.nworkers} workers x {ts.n_buckets} buckets x {TRAIN_STEPS} "
        "steps; sketch_decode 0; no plain version called")
    m, full = first["m"], first["full"]
    micro = [float(x) for x in m["worker_loss"]]
    gnorm = m["grad_norm"].double().cpu()
    want = torch.clamp(MINICPM_CLIP / gnorm, max=1.0) * gnorm
    got = applied[0].sqrt().cpu()
    log(f"[train_minicpm] step 0: microbatched worker losses {micro}, the "
        f"full-batch losses of the same params {full}; grad_norm "
        f"{gnorm.tolist()}, applied gradient's norm {got.tolist()} (clip "
        f"{MINICPM_CLIP}: {'active' if bool((gnorm > MINICPM_CLIP).all()) else 'inactive'})")
    if not _close(full, micro, MINICPM_RTOL):
        fail(f"step 0's microbatched losses {micro} differ from the full-batch "
             f"losses {full} beyond rtol {MINICPM_RTOL}")
    if not bool(torch.allclose(got, want, rtol=MINICPM_RTOL, atol=0.0)):
        fail(f"the applied gradient's norm {got.tolist()} is not "
             f"min(grad_norm, clip) = {want.tolist()}")
    state, prof = profile_phase(torch, ts, run.pop("state"), run["stream"],
                                tag="profile_minicpm")
    del state, first, m
    torch.cuda.empty_cache()
    shapes = minicpm_filler_checks(torch, device, ts)
    return {"counts": counts, "filler_shapes": shapes, "losses":
            run["losses"], "times": run["times"], "peak": run["peak"],
            "profile": prof}


# ---------------------------------------------------------------------------
# Fault-tolerant training: train_elastic, parity_elastic, cli_simulate
# ---------------------------------------------------------------------------

# train_elastic: the train_minicpm cell on the Alg. 1 tree at P = 4, then
# P = 3 after a heartbeat-detected failure of worker ELASTIC_FAILED. The
# global batch divides by 4 and 3 into local batches the microbatch (2)
# divides: 6 rows a worker at P = 4, 8 at P = 3. Heartbeats ride an
# explicit clock (ELASTIC_HB_PERIOD simulated seconds a step, timeout
# ELASTIC_HB_TIMEOUT): no phase sleeps.
ELASTIC_P, ELASTIC_FAILED, ELASTIC_BATCH = 4, 2, 24
ELASTIC_HB_PERIOD, ELASTIC_HB_TIMEOUT = 10.0, 5.0
ELASTIC_OUTLIER = 30.0   # the straggler's step time over its peers'
ELASTIC_DROP_FRAC = 0.34  # DeadlinePolicy's cap; the default 0.25 floors
#                          to no drop at all at P = 3
ELASTIC_SUM_RTOL = 1e-4  # a selected coordinate's applied update against
#                          the live workers' exact sum x P/live, beyond the
#                          f32 rounding of that sum (4 eps x sum of |terms|)
# parity_elastic: examples/fault_tolerant_training.py's scenario
ELASTIC_SMOKE_KW = dict(k=4096, rows=5, width=8192, allreduce_mode="tree")
ELASTIC_SMOKE_LR, ELASTIC_SMOKE_BATCH, ELASTIC_SMOKE_SEQ = 2e-3, 20, 32


def replicas_equal(torch, params) -> bool:
    return all(torch.equal(v, v[:1].expand_as(v)) for v in params.values())


class checked_drop:
    """While open, every ``exchange_bucketed`` call with an ``include``
    mask is held, at the shapes it runs at, as tests/test_runtime.py holds
    the reference's: each bucket's update on its selected coordinates is
    the live workers' sum of the error-corrected gradient u = ef + g times
    P/live (within ELASTIC_SUM_RTOL, or the f32 rounding of the sum), the
    same on every worker; the dropped workers' new EF is their u bit for
    bit; the live workers' new EF is 0 on the selection. Records what it
    checked in ``self.seen``."""

    def __init__(self, torch):
        self.torch, self.seen = torch, []

    def __enter__(self):
        from repro_torch.core import gs_sgd
        self.mod, self.orig = gs_sgd, gs_sgd.exchange_bucketed
        gs_sgd.exchange_bucketed = self.wrapped
        return self

    def __exit__(self, *exc):
        self.mod.exchange_bucketed = self.orig

    def wrapped(self, bc, ef_state, g_flat, *, nworkers, overlap=True,
                include=None):
        out = self.orig(bc, ef_state, g_flat, nworkers=nworkers,
                        overlap=overlap, include=include)
        if include is not None:
            self.check(bc, ef_state, g_flat, include, *out[:2])
        return out

    def check(self, bc, ef_state, g_flat, include, upd, ef_new):
        torch = self.torch
        inc = include > 0
        live = torch.nonzero(inc).flatten()
        dropped = torch.nonzero(~inc).flatten().tolist()
        nworkers = inc.numel()
        scale = nworkers / live.numel()
        if not all(torch.equal(upd[w], upd[0]) for w in range(nworkers)):
            fail("train_elastic: the workers apply different updates at the "
                 "drop step")
        eps = float(torch.finfo(torch.float32).eps)
        for b, (o, n) in enumerate(zip(bc.spec.offsets, bc.spec.sizes)):
            u = ef_state[b] + g_flat[:, o:o + n]
            for w in dropped:
                if not torch.equal(ef_new[b][w], u[w]):
                    fail(f"train_elastic: dropped worker {w}'s EF in bucket "
                         f"{b} is not its error-corrected gradient")
            got = upd[0, o:o + n]
            sel = torch.nonzero(got).flatten()
            terms = u.index_select(1, sel).index_select(0, live).double()
            want = terms.sum(0) * scale
            slack = 4 * eps * terms.abs().sum(0) * scale
            err = (got[sel].double() - want).abs()
            bad = int((err > ELASTIC_SUM_RTOL * want.abs() + slack).sum())
            if bad or not sel.numel():
                fail(f"train_elastic bucket {b}: {bad} of {sel.numel()} "
                     "selected coordinates are not the live sum x P/live")
            for w in live.tolist():
                if bool((ef_new[b][w].index_select(0, sel) != 0).any()):
                    fail(f"train_elastic: live worker {w}'s EF in bucket {b} "
                         "is not 0 on the selection")
            rel = float((err / want.abs().clamp(min=1e-30)).max())
            self.seen.append({"bucket": b, "d": n, "selected": sel.numel(),
                              "dropped": dropped, "scale": scale,
                              "max_rel_err": rel})
            del u, terms, want, slack, err, got, sel


def train_elastic_phase(torch, device) -> dict:
    """The train_minicpm cell (minicpm-2b widths, MINICPM_LAYERS layers,
    buckets 2, microbatch, clip, wsd, the faithful fill) on the Alg. 1
    tree: two steps at P = ELASTIC_P; worker ELASTIC_FAILED stops beating
    and the heartbeat monitor (explicit clock) reports it; ``replan`` to
    generation 1; the survivors' state rows carried leaf by leaf and the
    P = 4 state freed; a step built fresh at P = 3 runs two steps, one in
    which ``DeadlinePolicy`` drops a worker (the exchange held by
    ``checked_drop``), and one with every worker. Every step: a finite
    loss and bit-equal replicas. Counted: the whole run (encode, finish,
    scores with the filler, select once a bucket, worker and step; the
    decode never; no plain version). Then worker 0's packed gradient of
    the last step through the kernels, bit-equal to plain."""
    from repro_torch.data import LMStream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.train import shard_batch
    from repro_torch.runtime import (DeadlinePolicy, HeartbeatMonitor,
                                     carry_survivors, initial_plan, replan)
    cfg, opt, ts, _, _ = minicpm_step(torch, device, p=ELASTIC_P,
                                      allreduce_mode="tree", record=False)
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=ELASTIC_BATCH, seed=0)
    plan = initial_plan(ELASTIC_P)
    log(f"[train_elastic] minicpm-2b widths, {cfg.n_layers} layers: d = "
        f"{ts.d_local}, buckets {list(ts.compressor.spec.sizes)}, "
        f"allreduce tree ({len(plan.schedule)} reduce rounds at P = "
        f"{ELASTIC_P}), microbatch {MINICPM_MICROBATCH}, clip "
        f"{MINICPM_CLIP}, wsd, faithful fill; global batch {ELASTIC_BATCH}"
        f", seq {TRAIN_SEQ}")
    clock = [0.0]
    hb = HeartbeatMonitor(range(ELASTIC_P), clock=lambda: clock[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = ts.init_state(opt, torch.Generator(device=device).manual_seed(0))
    losses, times, steps = [], {ELASTIC_P: [], ELASTIC_P - 1: []}, []

    def run(ts, state, s, include=None):
        batch = shard_batch(stream.global_batch_at(s, device), ts.nworkers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = ts.fn(state, batch, include)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times[ts.nworkers].append(dt)
        losses.append(loss)
        same = replicas_equal(torch, state["params"])
        log(f"[train_elastic] step {s} (P = {ts.nworkers}"
            f"{'' if include is None else ', include ' + str(include.tolist())}"
            f"): loss {loss!r}  step_s {dt:.4f}; replicas bit-equal: {same}")
        if not math.isfinite(loss) or not same:
            fail(f"train_elastic step {s}: loss {loss}, replicas equal {same}")
        steps.append(s)
        return state, m

    with plain_calls() as plain:
        LAUNCHES.clear()
        for s in range(2):
            state, _ = run(ts, state, s)
            clock[0] += ELASTIC_HB_PERIOD
            for w in plan.survivor_ids:
                if not (w == ELASTIC_FAILED and s >= 1):
                    hb.beat(w)
        peak4 = torch.cuda.max_memory_allocated()
        failed = hb.dead(ELASTIC_HB_TIMEOUT)
        if failed != {ELASTIC_FAILED}:
            fail(f"train_elastic: the heartbeat monitor reported {failed}, "
                 f"not {{{ELASTIC_FAILED}}}")
        for w in failed:
            hb.remove(w)
        old, plan = plan, replan(plan, failed)
        log(f"[train_elastic] heartbeat: worker(s) {sorted(failed)} silent "
            f"past {ELASTIC_HB_TIMEOUT} s (explicit clock at {clock[0]}); "
            f"replan -> generation {plan.generation}, survivors "
            f"{plan.survivor_ids}, P = {plan.n_workers}, lr_scale "
            f"{plan.lr_scale!r}, {len(plan.schedule)} tree rounds "
            f"{plan.schedule}")
        t0 = time.perf_counter()
        state = carry_survivors(state, [old.rank_of(w)
                                        for w in plan.survivor_ids])
        del ts
        torch.cuda.synchronize()
        carry_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        _, _, ts3, _, _ = minicpm_step(torch, device, p=plan.n_workers,
                                       allreduce_mode="tree", record=False)
        log(f"[train_elastic] survivors' state carried leaf by leaf in "
            f"{carry_s:.3f} s; {held} bytes ({held / 2**30:.2f} GiB) "
            "allocated after the P = 4 state was freed")
        pol = DeadlinePolicy(factor=3.0, max_drop_frac=ELASTIC_DROP_FRAC)
        for s in range(2, 4):
            state, _ = run(ts3, state, s)
            pol.observe([times[3][-1]] * 3)
        durs = [times[3][-1]] * 3
        durs[1] *= ELASTIC_OUTLIER
        mask = pol.mask(durs)
        log(f"[train_elastic] DeadlinePolicy(factor 3, max_drop_frac "
            f"{ELASTIC_DROP_FRAC}) on step durations {durs}: include "
            f"{mask.tolist()}")
        if mask.tolist() != [True, False, True]:
            fail(f"train_elastic: the policy's mask is {mask.tolist()}")
        include = torch.tensor(mask, dtype=torch.float32, device=device)
        with checked_drop(torch) as drop:
            state, _ = run(ts3, state, 4, include)
        if len(drop.seen) != ts3.n_buckets:
            fail(f"train_elastic: the drop step's exchange was checked for "
                 f"{len(drop.seen)} buckets, not {ts3.n_buckets}")
        for c in drop.seen:
            log(f"[train_elastic] drop step, bucket {c['bucket']} (d = "
                f"{c['d']}): {c['selected']} selected coordinates are the "
                f"live workers' sum x {c['scale']!r} (largest relative "
                f"difference {c['max_rel_err']:.3g}); dropped worker(s) "
                f"{c['dropped']} keep their error-corrected gradient in the "
                "EF, bit for bit; the live workers' EF 0 on the selection")
        with captured_buckets(ts3.compressor.parts) as got:
            state, _ = run(ts3, state, 5)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    recoveries = ts3.n_buckets * (ELASTIC_P * 2 + 3 * 4)
    for name in ("sketch_encode", "sketch_encode_finish", "heavymix_scores",
                 "topk_select"):
        if counts.get(name) != recoveries:
            fail(f"{name} launched {counts.get(name)} times on the "
                 f"train_elastic path, not {recoveries} (once a bucket, "
                 "worker and step)")
    check_launches("train_elastic", counts, (),
                   ("sketch_decode", "ts_encode", "heavymix_scores_ts",
                    "ts_transpose"))
    if plain:
        fail(f"plain versions called on the train_elastic path: {plain}")
    log(f"[train_elastic] launches {counts}: encode, finish, scores (with "
        f"the filler) and select {recoveries} each = 2 buckets x (4 workers "
        "x 2 steps + 3 x 4); no plain version called")
    log(f"[train_elastic] peak memory {peak4} bytes ({peak4 / 2**30:.2f} "
        f"GiB) through the P = 4 steps, {peak} ({peak / 2**30:.2f} GiB) "
        f"over the phase; step_s at P = 4 {times[4]}, at P = 3 {times[3]} "
        f"({card_line()})")
    del state
    torch.cuda.empty_cache()
    route_checks(torch, "train_elastic", ts3.compressor.parts, got)
    return {"counts": counts, "times": times, "losses": losses,
            "peak": peak, "peak_p4": peak4, "drop": drop.seen}


def elastic_scenario(torch, device):
    """examples/fault_tolerant_training.py's three phases at the smoke
    config through the port on ``device`` (params from a CPU generator
    seeded 0, the same on either device): P = 5 on
    the tree (steps 0-3), ``replan`` after worker 3 fails, the survivors'
    rows and a fresh P = 4 step (steps 4-6), ``DeadlinePolicy`` drops
    worker 1 (30x slower) at step 7, step 8 includes all. Returns the
    losses, each step's EF zero pattern (on the CPU), the final replica
    divergence and, on the card, the launch counts of the run."""
    from repro_torch.configs import SMOKES
    from repro_torch.core.gs_sgd import MeshAxes, make_state, make_train_step
    from repro_torch.data import LMStream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.train import shard_batch
    from repro_torch.models.flatten import init_flat_params
    from repro_torch.optim import make as make_opt
    from repro_torch.runtime import (DeadlinePolicy, carry_survivors,
                                     initial_plan, replan)
    cfg = SMOKES["qwen3-4b"]
    opt = make_opt("adamw", lr=ELASTIC_SMOKE_LR)

    def build(p):
        return make_train_step(cfg, MeshAxes(tp=1, data=p, tp_axis=None), opt,
                               compressor_name="gs-sgd",
                               compressor_kw=ELASTIC_SMOKE_KW, remat=False,
                               dtype=torch.float32, device=device)

    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=ELASTIC_SMOKE_SEQ,
                      global_batch=ELASTIC_SMOKE_BATCH, seed=0)
    ts = build(5)
    params = init_flat_params(cfg, torch.Generator().manual_seed(0), 1,
                              ts.fs)
    state = make_state({k: v.to(device) for k, v in params.items()}, opt,
                       ts.compressor, ts.d_local, 5)
    losses, zeros = [], []
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        LAUNCHES.clear()

    def step(ts, state, s, include):
        batch = shard_batch(stream.global_batch_at(s, device), ts.nworkers)
        state, m = ts.fn(state, batch, include.to(device))
        losses.append(float(m["loss"]))
        ef = state["ef"] if isinstance(state["ef"], tuple) else (state["ef"],)
        zeros.append([(e == 0).cpu() for e in ef])
        return state

    for s in range(4):
        state = step(ts, state, s, torch.ones(5))
    old = initial_plan(5)
    plan = replan(old, failed={3})
    state = carry_survivors(state, [old.rank_of(w) for w in
                                    plan.survivor_ids])
    ts = build(plan.n_workers)
    for s in range(4, 7):
        state = step(ts, state, s, torch.ones(4))
    pol = DeadlinePolicy(factor=3.0)
    pol.observe([1.0, 1.0, 1.0, 1.0])
    mask = torch.tensor(pol.mask([1.0, 30.0, 1.0, 1.0]), dtype=torch.float32)
    state = step(ts, state, 7, mask)
    state = step(ts, state, 8, torch.ones(4))
    counts = {}
    if on_card:
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
    div = max(float((v - v[:1]).abs().max()) for v in state["params"].values())
    return {"losses": losses, "zeros": zeros, "divergence": div,
            "mask": mask.tolist(), "plan": plan, "counts": counts}


def parity_elastic_phase(torch, card="cuda") -> dict:
    """``elastic_scenario`` on the card and on the CPU port from the same
    params: the selected coordinates (every worker's EF zero pattern)
    equal on every step, the losses within PARITY_LOSS_RTOL, the replica
    divergence 0 on both; the scores route's kernels launched on the card
    (the smoke buckets are below 2^22)."""
    cpu = elastic_scenario(torch, "cpu")
    with plain_calls() as plain:
        gpu = elastic_scenario(torch, card)
    counts = gpu["counts"]
    log(f"[parity_elastic] plan {gpu['plan'].survivor_ids} generation "
        f"{gpu['plan'].generation} lr_scale {gpu['plan'].lr_scale!r}; "
        f"drop mask {gpu['mask']}; losses cpu {cpu['losses']} card "
        f"{gpu['losses']}; replica divergence cpu {cpu['divergence']} card "
        f"{gpu['divergence']}; card launches {counts}")
    if not _close(cpu["losses"], gpu["losses"], PARITY_LOSS_RTOL):
        fail("parity_elastic: card and CPU losses differ")
    for s, (a, b) in enumerate(zip(cpu["zeros"], gpu["zeros"])):
        for i, (x, y) in enumerate(zip(a, b)):
            if not torch.equal(x, y):
                fail(f"parity_elastic: selected coordinates differ at step "
                     f"{s} bucket {i}")
    if cpu["divergence"] != 0.0 or gpu["divergence"] != 0.0:
        fail("parity_elastic: the replicas diverged")
    if card != "cpu":
        if plain:
            fail(f"plain versions called on the parity_elastic card path: "
                 f"{plain}")
        check_launches("parity_elastic", counts,
                       ("sketch_encode", "sketch_encode_finish",
                        "heavymix_scores", "topk_select"),
                       ("sketch_decode", "ts_encode", "heavymix_scores_ts",
                        "ts_transpose"))
    log(f"[parity_elastic] {len(cpu['losses'])} steps: losses within rtol "
        f"{PARITY_LOSS_RTOL}, selected coordinates equal every step, replica "
        "divergence 0 on both")
    return counts


def cli_simulate_phase() -> None:
    """``python -m repro_torch.launch.simulate`` (host only: it runs
    nothing on a device): README's fail_rejoin run at P = 1,024, buckets 8
    on ``--engine batched`` and ``--engine loop`` (their ``--out`` files
    equal, ``--json`` curves a step each); a ``--watch --congest`` run
    that re-plans, with ``--trace`` validated by ``obs.trace.validate``.
    Prints the simulator's own wall seconds, host time."""
    from repro_torch.obs import trace as obtrace
    out_dir = os.path.join(ROOT, "build", "cli_simulate")
    os.makedirs(out_dir, exist_ok=True)
    path = {n: os.path.join(out_dir, n) for n in (
        "batched.json", "loop.json", "curves.json", "watch.json",
        "trace.json")}
    base = ["--p", "1024", "--method", "gs-sgd", "--buckets", "8",
            "--fault-trace", os.path.join("examples", "traces",
                                          "fail_rejoin.json")]
    walls = {}
    for engine in ("batched", "loop"):
        extra = ["--json", path["curves.json"]] if engine == "batched" else []
        lines = run_cli("repro_torch.launch.simulate",
                        base + ["--engine", engine, "--out",
                                path[f"{engine}.json"], *extra],
                        tag="cli_simulate")
        walls[engine] = next(ln for ln in lines if "host wall" in ln)
    with open(path["batched.json"], "rb") as f, \
            open(path["loop.json"], "rb") as g:
        if f.read() != g.read():
            fail("cli_simulate: the batched and loop engines' --out files "
                 "differ")
    with open(path["curves.json"]) as f:
        curves = json.load(f)
    with open(path["batched.json"]) as f:
        res = json.load(f)
    if (len(curves["curves"]) != res["totals"]["steps"]
            or set(curves) < {"model", "curves", "checks"}
            or [r["p"] for r in res["replans"]] != [1023]):
        fail(f"cli_simulate: unexpected result {res['totals']} "
             f"{res['replans']}")
    lines = run_cli("repro_torch.launch.simulate",
                    ["--p", "8", "--d", "1000000", "--steps", "20",
                     "--compute-jitter", "0", "--watch", "--congest", "8:6",
                     "--out", path["watch.json"], "--trace",
                     path["trace.json"]], tag="cli_simulate")
    walls["watch"] = next(ln for ln in lines if "host wall" in ln)
    if not any(ln.startswith("watchdog: re-planned") for ln in lines):
        fail("cli_simulate: the watched congested run did not re-plan")
    with open(path["trace.json"]) as f:
        doc = json.load(f)
    n_spans = obtrace.validate(doc)
    if doc["source"] != "sim" or not n_spans:
        fail("cli_simulate: the --trace document is not a sim trace")
    log(f"[cli_simulate] batched and loop --out files equal "
        f"({res['totals']['steps']} steps, replans "
        f"{[(r['step'], r['p']) for r in res['replans']]}); the watched "
        f"run re-planned; its trace validates ({n_spans} spans); the "
        "simulator's own wall time, host clock (a model's timeline, no "
        "device time):")
    for k, ln in walls.items():
        log(f"[cli_simulate]   {k}: {ln}")


def check_route(tag, counts, plain, recoveries, decode=True) -> None:
    """A path whose recoveries all take one route: the encode, its finish,
    the select and the route's kernel (``sketch_decode``, or with
    ``decode=False`` ``heavymix_scores``) ``recoveries`` times each (once a
    bucket, worker and step); the other route's kernel, the TS kernels and
    the plain versions never."""
    route, other = (("sketch_decode", "heavymix_scores") if decode
                    else ("heavymix_scores", "sketch_decode"))
    for name in ("sketch_encode", "sketch_encode_finish", route,
                 "topk_select"):
        if counts.get(name) != recoveries:
            fail(f"{name} launched {counts.get(name)} times on the {tag} "
                 f"path, not {recoveries} (once a bucket, worker and step)")
    check_launches(tag, counts, (), (other, "heavymix_scores_ts",
                                     "ts_transpose", "ts_encode"))
    if plain:
        fail(f"plain versions called on the {tag} path: {plain}")
    log(f"[{tag}] launches {counts}: encode, finish, {route} and select "
        f"{recoveries} each (buckets x workers x steps); no plain version "
        "called")


def family_cell(torch, device, cfg, want_d, **kw):
    """``cfg`` under the main path's exchange (``full_width_step``), its d
    checked against the value the tests pin."""
    cfg, opt, ts = full_width_step(torch, device, cfg=cfg, **kw)
    if ts.d_local != want_d:
        fail(f"{cfg.name} at {cfg.n_layers} layers: d = {ts.d_local}, "
             f"not {want_d}")
    return cfg, opt, ts


class recorded_drops:
    """While open, ``models.moe.dispatch`` (which ``moe_block`` calls by its
    module's global name) also appends, per call, a (2,) device tensor:
    the kept (token, choice) pairs and all of them. Only the untimed
    forwards of ``drop_share`` run under it."""

    def __enter__(self):
        import torch

        from repro_torch.models import moe
        self.mod, self.f, drops = moe, moe.dispatch, []

        def counted(eidx, ne, cap, _f=self.f):
            dests, keeps = _f(eidx, ne, cap)
            kept = torch.stack([k.sum() for k in keeps]).sum()
            drops.append(torch.stack([kept,
                                      torch.full_like(kept, eidx.numel())]))
            return dests, keeps

        moe.dispatch = counted
        return drops

    def __exit__(self, *exc):
        self.mod.dispatch = self.f


def drop_share(torch, cfg, ts, state, gb) -> float:
    """The dropped share of the (token, choice) pairs in the forward that
    the next step runs: every worker's params on its shard of global batch
    ``gb``, one no-grad ``loss_fn`` each under ``recorded_drops`` (the
    routing is the step's: the same f32 forward)."""
    from repro_torch.launch.train import shard_batch
    from repro_torch.models import model as mdl
    from repro_torch.models.flatten import SEG_NAMES
    batch = shard_batch(gb, ts.nworkers)
    with torch.no_grad(), recorded_drops() as drops:
        for p in range(ts.nworkers):
            mdl.loss_fn(cfg, ts.fs, {k: state["params"][k][p]
                                     for k in SEG_NAMES},
                        {k: v[p] for k, v in batch.items()},
                        dtype=torch.float32)
    kept, total = (int(v) for v in torch.stack(drops).sum(0))
    return 1.0 - kept / total


class captured_buckets:
    """While open, ``GsSGD.stage_encode`` and ``stage_encode_merge`` (the
    fused interleave's) also keep, once per bucket (one compressor of
    ``parts``), a copy of worker 0's packed vector u (the EF plus its
    gradient: the encode's input) and of the f32 sketch the step made of
    it. Returns the dict bucket -> (u, sketch)."""

    def __init__(self, parts):
        self.index = {id(c): b for b, c in enumerate(parts)}

    def __enter__(self):
        from repro_torch.core import compression as comp
        self.cls, got = comp.GsSGD, {}
        self.saved = {n: getattr(self.cls, n)
                      for n in ("stage_encode", "stage_encode_merge")}

        def wrap(f):
            def kept(part, *a, **kw):
                u, sk = f(part, *a, **kw)
                got.setdefault(self.index[id(part)],
                               (u[0].clone(), sk[0].float().clone()))
                return u, sk
            return kept

        for n, f in self.saved.items():
            setattr(self.cls, n, wrap(f))
        return got

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.cls, n, f)


def capture_step(torch, ts, state, stream):
    """One more step (not counted, not timed) under ``captured_buckets``.
    Returns the state and worker 0's (u, sketch) of each bucket."""
    from repro_torch.launch.train import shard_batch
    batch = shard_batch(stream.global_batch_at(TRAIN_STEPS + 1, ts.device),
                        ts.nworkers)
    with captured_buckets(ts.compressor.parts) as got:
        state, m = ts.fn(state, batch)
        float(m["loss"])
    if sorted(got) != list(range(ts.n_buckets)):
        fail(f"captured the encode of buckets {sorted(got)} only")
    return state, got


def route_checks(torch, tag, parts, got, timed=False) -> dict:
    """The path's kernels at the path's own shapes, on worker 0's packed
    vector u of each bucket (``capture_step``; bucket b's compressor is
    ``parts[b]``): the sketch the step made and ``sketch_encode`` (the
    accumulate and its finish) of u bit-equal to ``sketch_encode_plain``;
    on that sketch the bucket's route kernel (``sketch_decode`` with its
    histogram, or ``heavymix_scores`` with its histogram, as
    ``decode_route`` says) bit-equal to its plain version and the
    histogram equal to the plain one; ``topk_select`` of those keys equal
    to ``topk_select_plain``, indices and value bits. ``timed``: also
    time each kernel, its plain version and its library call at these
    shapes; returns kernel name -> [shape row, a bucket]."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.heavymix import draw_filler
    from repro_torch.kernels.heavymix_topk import (heavymix_scores_hist,
                                                   heavymix_scores_plain)
    from repro_torch.kernels.sketch_decode import (sketch_decode_hist,
                                                   sketch_decode_plain)
    from repro_torch.kernels.sketch_encode import (sketch_encode,
                                                   sketch_encode_plain)
    from repro_torch.kernels.topk_select import (radix_hist_plain,
                                                 topk_select,
                                                 topk_select_plain)
    rows: dict = {}
    for b in range(len(parts)):
        u, sk_step = got.pop(b)
        part = parts[b]
        cfg, k, d = part.sketch, part.k, u.shape[0]
        R, W = cfg.rows, cfg.width
        sk = sketch_encode(cfg, u)
        sk_p = sketch_encode_plain(cfg, u)
        same = {"step's sketch": _bits_equal(torch, sk_step, sk_p),
                "sketch_encode": _bits_equal(torch, sk, sk_p)}
        if not all(same.values()):
            fail(f"{tag} bucket {b} (d={d}, R={R}, W={W}): the encode is not "
                 f"bit-equal to plain: {same}")
        del sk_p, sk_step
        shape = f"{tag} bucket {b} (d={d}, R={R}, W={W}, k={k})"
        if timed:
            def ids_vals(lo, hi):
                bk, sg = cs.hash_buckets(cfg, torch.arange(lo, hi,
                                                           device=u.device))
                return bk, sg * u[lo:hi]

            rows.setdefault("sketch_encode", []).append(_timed_shape(
                torch, shape, lambda: sketch_encode(cfg, u),
                lambda: sketch_encode_plain(cfg, u),
                _index_add_ms(torch, u.device, R, W, d, ids_vals)[0],
                bound_ms(d * 4 + R * W * 4, d * R * 7.0)))
        ops_per = R * 6.0 + R * (R - 1)   # hashes + compare-exchanges
        if decode_route(part, d):
            route = "sketch_decode"
            key, hist = sketch_decode_hist(cfg, sk, d)
            key_p = sketch_decode_plain(cfg, sk, d)
            if not torch.equal(key, key_p):
                fail(f"{tag} bucket {b} (d={d}): sketch_decode is not "
                     f"bit-equal to plain ({int((key != key_p).sum())} "
                     "coordinates differ)")
            if not torch.equal(hist, radix_hist_plain(key_p)):
                fail(f"{tag} bucket {b} (d={d}): sketch_decode's histogram "
                     "differs from the plain one")
            del key_p
            if timed:
                rows.setdefault(route, []).append(_timed_shape(
                    torch, shape, lambda: sketch_decode_hist(cfg, sk, d),
                    lambda: sketch_decode_plain(cfg, sk, d),
                    _decode_library_ms(torch, u.device, cfg, sk, d)[0],
                    bound_ms(R * W * 4 + d * 4 + 2048 * 4, d * ops_per)))
        else:   # scores, est and histogram held against plain inside
            route = "heavymix_scores"
            thr = cs.l2sq_estimate(sk) / k
            fill = (draw_filler(d, u.device) if part.faithful_heavymix
                    else None)
            key, est, hist, _ = check_scores_hist(
                torch, f"{tag} bucket {b}", cfg, sk, thr, d, fill)
            del est, fill
            if timed:
                rows.setdefault(route, []).append(_timed_shape(
                    torch, shape, lambda: heavymix_scores_hist(cfg, sk, thr,
                                                               d),
                    lambda: heavymix_scores_plain(cfg, sk, thr, d), None,
                    bound_ms(R * W * 4 + 4 + 2 * d * 4 + 2048 * 4,
                             d * (ops_per + 4))))
        v, i = topk_select(key, k, hist)
        v_p, i_p = topk_select_plain(key, k, hist)
        if not (torch.equal(i, i_p)
                and torch.equal(v.view(torch.int32), v_p.view(torch.int32))):
            fail(f"{tag} bucket {b} (d={d}, k={k}): topk_select differs from "
                 f"plain ({int((i != i_p).sum())} of {k} indices)")
        if timed:
            rows.setdefault("topk_select", []).append(_timed_shape(
                torch, shape, lambda: topk_select(key, k, hist),
                lambda: topk_select_plain(key, k, hist),
                time_ms(torch, lambda: torch.topk(key, k, sorted=False),
                        reps=3),
                bound_ms(d * 4 + 2048 * 4 + k * 12, d * 3.0)))
        log(f"[{tag}] bucket {b} (d={d}, R={R}, W={W}, d*R={d * R}, k={k}), "
            f"worker 0's packed gradient: the step's sketch and "
            f"sketch_encode bit-equal to plain; {route} and its histogram "
            "equal to plain; topk_select equal to plain (indices, value "
            "bits)")
        del key, hist, v, i, v_p, i_p, sk, u
        torch.cuda.empty_cache()
    return rows


def _timed_shape(torch, shape, call, plain, library_ms, bound) -> dict:
    """A kernel's numbers at one shape (bit-equal to plain: checked by
    the caller)."""
    return {"shape": shape, "max_abs_err": 0.0,
            "ms": time_ms(torch, call, reps=10),
            "plain_ms": time_ms(torch, plain, reps=2),
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms}


def train_moe_phase(torch, device) -> dict:
    """granite-moe-3b-a800m at its published widths, MOE_LAYERS layers:
    three counted steps on the decode route, the capacity and each step's
    dropped share of the (token, choice) pairs, one profiled step."""
    from repro_torch.configs.granite_moe_3b_a800m import CONFIG
    from repro_torch.models import moe
    from repro_torch.models.common import padded_vocab
    cfg, opt, ts = family_cell(
        torch, device, dataclasses.replace(CONFIG, n_layers=MOE_LAYERS),
        MOE_D)
    if tuple(ts.compressor.spec.sizes) != MOE_BUCKETS:
        fail(f"train_moe buckets {ts.compressor.spec.sizes}, not "
             f"{MOE_BUCKETS}")
    T = TRAIN_BATCH // TRAIN_P * TRAIN_SEQ
    cap = moe.expert_capacity(cfg, T)
    log(f"[train_moe] granite-moe-3b-a800m widths (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.n_experts} experts "
        f"top-{cfg.experts_per_tok}, expert d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} padded to {padded_vocab(cfg, 1)}, tied "
        f"{cfg.tie_embeddings}), {cfg.n_layers} layers; capacity C = {cap} "
        f"for {T} tokens a worker and layer (mean load "
        f"{T * cfg.experts_per_tok / cfg.n_experts:.1f})")
    shares = []
    with plain_calls() as plain:
        run = train_phase(torch, cfg, opt, ts, tag="train_moe",
                          between=lambda st, gb: shares.append(
                              drop_share(torch, cfg, ts, st, gb)))
    check_route("train_moe", run["counts"], plain,
                ts.nworkers * ts.n_buckets * TRAIN_STEPS)
    log(f"[train_moe] dropped share of the (token, choice) pairs per step "
        f"({cfg.n_layers} MoE blocks x {ts.nworkers} workers a step, "
        f"capacity {cap}; each from an untimed no-grad forward of the "
        f"step's params and batch): {shares}")
    state, prof = profile_phase(torch, ts, run.pop("state"), run["stream"],
                                tag="profile_moe")
    state, got = capture_step(torch, ts, state, run["stream"])
    del state
    torch.cuda.empty_cache()
    route_checks(torch, "train_moe", ts.compressor.parts, got)
    del ts
    torch.cuda.empty_cache()
    return {**run, "profile": prof, "capacity": cap, "drop_shares": shares}


def train_hybrid_phase(torch, device) -> dict:
    """zamba2-2.7b at its published widths, HYBRID_LAYERS layers (two
    cycles of six Mamba2 blocks and the shared block): three counted steps
    on the decode route and one profiled step; then three steps at
    buckets=4 with the chunked backward (one cycle a chunk) and the fused
    encode against three steps at bwd_chunks=None from the same seed,
    held as ``train_interleave`` holds the main cell."""
    from repro_torch.configs.zamba2_2_7b import CONFIG
    hcfg = dataclasses.replace(CONFIG, n_layers=HYBRID_LAYERS)
    cfg, opt, ts = family_cell(torch, device, hcfg, HYBRID_D)
    log(f"[train_hybrid] zamba2-2.7b widths (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, ssm_state {cfg.ssm_state}, "
        f"vocab {cfg.vocab_size}), {cfg.n_layers} Mamba2 layers in "
        f"{cfg.n_cycles} cycles, each closed by the shared block")
    with plain_calls() as plain:
        run = train_phase(torch, cfg, opt, ts, tag="train_hybrid")
    check_route("train_hybrid", run["counts"], plain,
                ts.nworkers * ts.n_buckets * TRAIN_STEPS)
    state, prof = profile_phase(torch, ts, run.pop("state"), run["stream"],
                                tag="profile_hybrid")
    state, got = capture_step(torch, ts, state, run["stream"])
    del state
    torch.cuda.empty_cache()
    route_checks(torch, "train_hybrid", ts.compressor.parts, got)
    del ts
    torch.cuda.empty_cache()
    _, _, ts_i = family_cell(torch, device, hcfg, HYBRID_D,
                             buckets=INTERLEAVE_BUCKETS,
                             bwd_chunks=HYBRID_CHUNKS, fuse_encode=True)
    log(f"[train_hybrid_interleave] plan: sizes {list(ts_i.plan.sizes)}, "
        f"readiness {list(ts_i.plan.readiness)}, chunks "
        f"{list(ts_i.plan.chunks)}; fragments {ts_i.plan.fragments()}")
    with plain_calls() as plain:
        inter = train_phase(torch, cfg, opt, ts_i,
                            tag="train_hybrid_interleave")
    check_interleave_launches("train_hybrid_interleave", ts_i,
                              inter["counts"], plain)
    state = inter.pop("state")
    snap = _snapshot(state)
    state, got = capture_step(torch, ts_i, state, inter["stream"])
    del state
    torch.cuda.empty_cache()
    route_checks(torch, "train_hybrid_interleave", ts_i.compressor.parts,
                 got)
    del ts_i
    torch.cuda.empty_cache()
    _, _, ts_b = family_cell(torch, device, hcfg, HYBRID_D,
                             buckets=INTERLEAVE_BUCKETS)
    base = train_phase(torch, cfg, opt, ts_b, tag="train_hybrid_bucketed4")
    compare_snapshots(snap, _snapshot(base.pop("state")), tag="train_hybrid")
    del snap, ts_b
    torch.cuda.empty_cache()
    check_interleaved_losses("train_hybrid", inter, base)
    return {**run, "profile": prof, "interleave_counts": inter["counts"],
            "interleave": {k: inter[k] for k in ("losses", "times", "peak")},
            "bucketed4": {k: base[k] for k in ("losses", "times", "peak")}}


class kept_recoveries:
    """While open, ``GsSGD.stage_reduce`` and ``_SketchBased._recover``
    also keep worker 0's copy of each summed sketch and of the indices
    HEAVYMIX selects from it: {"sums": [...], "idx": [...]}, in call
    order."""

    def __enter__(self):
        from repro_torch.core import compression as comp
        kept = {"sums": [], "idx": []}
        self.saved = [(comp.GsSGD, "stage_reduce", comp.GsSGD.stage_reduce),
                      (comp._SketchBased, "_recover",
                       comp._SketchBased._recover)]

        def reduce(part, *a, _f=self.saved[0][2], **kw):
            sk_sum, scale = _f(part, *a, **kw)
            kept["sums"].append(sk_sum[0].clone())
            return sk_sum, scale

        def recover(part, *a, _f=self.saved[1][2], **kw):
            upd, idx = _f(part, *a, **kw)
            kept["idx"].append(idx[0].clone())
            return upd, idx

        comp.GsSGD.stage_reduce, comp._SketchBased._recover = reduce, recover
        return kept

    def __exit__(self, *exc):
        for cls, name, f in self.saved:
            setattr(cls, name, f)


def cnn_steps(torch, model, part, device, steps):
    """``steps`` steps of the paper's step (``cnn_dist.make_step``) from
    seed 0's params (drawn on the CPU, so every device starts equal) and
    ``ImageStream`` seed 0. Returns (step fn, state, losses, host seconds
    a step)."""
    from repro_torch.bench import cnn_dist
    params = cnn_dist.init_params(model, "cpu")
    step, state, _, _ = cnn_dist.make_step(
        model, part, CNN_P, lr=CNN_LR, device=device,
        params={k: {j: v.to(device) for j, v in blk.items()}
                for k, blk in params.items()})
    losses, times = [], []
    for i in range(steps):
        b = cnn_batch(i, device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, (loss, _) = step(state, *b)
        losses.append(float(loss))   # a device sync
        times.append(time.perf_counter() - t0)
    return step, state, losses, times


def unexplained_swaps(torch, part, sk_sum, d, coords, decode) -> list:
    """The coordinates of ``coords`` that a near-tie does not explain in
    the recovery from ``sk_sum``: |score - k-th score| and |est^2 - l2^2/k|
    both above CNN_TIE_RTOL of their reference (the decode route ranks
    |est| alone)."""
    from repro_torch.core import count_sketch as cs
    if not coords:
        return []
    est = cs.decode(part.sketch, sk_sum.cpu(), d)
    thr = float(cs.l2sq_estimate(sk_sum.cpu())) / part.k
    score = est.abs() if decode else torch.where(
        est * est >= thr, est.abs() + 1e30, est.abs())
    kth = float(torch.topk(score, part.k).values[-1])
    return [i for i in coords
            if abs(float(score[i]) - kth) > CNN_TIE_RTOL * kth
            and abs(float(est[i]) ** 2 - thr) > CNN_TIE_RTOL * thr]


def train_cnn_phase(torch, device) -> dict:
    """The paper's experiment at full size, each model: CNN_STEPS counted
    steps on the route its d gives it, a second run with the same bits,
    the cost of cuDNN's deterministic mode, the route checks (timed) on
    worker 0's gradient of one more step, and the CPU port's steps from the
    same params and batches (losses, the first step's selection); one
    profiled step."""
    from repro_torch.bench import cnn_dist
    from repro_torch.bench.time_breakdown import paper_geometry
    from repro_torch.core.count_sketch import l2sq_estimate as cs_l2sq
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.kernels.sketch_decode import sketch_decode
    out = {}
    for model, want_d, decode, cpu_steps in CNN_CELLS:
        tag = f"train_cnn_{model}"
        d = sum(x.numel() for blk in cnn_dist.init_params(model, "cpu")
                .values() for x in blk.values())
        if d != want_d:
            fail(f"{model}: d = {d}, not {want_d}")
        k, width = paper_geometry(d)
        part = cnn_dist.make_compressor("gs-sgd", k=k, rows=5, width=width)
        log(f"[{tag}] full size, d={d}, P={CNN_P}, global batch "
            f"{CNN_BATCH}, gs-SGD k={k} R=5 W={width}, SGD momentum 0.9 "
            f"lr {CNN_LR}; route {'decode' if decode else 'scores'}")
        with plain_calls() as plain, kept_recoveries() as kept:
            torch.cuda.synchronize()
            LAUNCHES.clear()
            step, state, losses, times = cnn_steps(torch, model, part,
                                                   device, CNN_STEPS)
            counts = dict(LAUNCHES)
        check_route(tag, counts, plain, CNN_P * CNN_STEPS, decode=decode)
        if not all(math.isfinite(x) for x in losses):
            fail(f"non-finite loss on the {tag} path: {losses}")
        again = cnn_steps(torch, model, part, device, CNN_STEPS)[2]
        if again != losses:
            fail(f"{tag}: a second run's losses {again} are not the first's "
                 f"{losses} (cuDNN deterministic)")
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
        try:
            fast = cnn_steps(torch, model, part, device, CNN_STEPS)[3]
        finally:
            cnn_dist.prepare_device(device)
        ms = sorted(t * 1e3 for t in times[1:])
        fast_ms = sorted(t * 1e3 for t in fast[1:])
        log(f"[{tag}] losses {losses}; the same bits in a second run; step "
            f"ms after the first {ms} (median {ms[len(ms) // 2]:.3f}); "
            f"cuDNN nondeterministic with its autotuner: {fast_ms} (median "
            f"{fast_ms[len(fast_ms) // 2]:.3f})")
        prof = profile_call(torch, f"profile_cnn_{model}", lambda: float(
            step(state, *cnn_batch(CNN_STEPS, device))[1][0]))[1]
        with captured_buckets([part]) as got:
            step(state, *cnn_batch(CNN_STEPS + 1, device))
        del state
        shapes = route_checks(torch, tag, [part], got, timed=True)
        with kept_recoveries() as kept_cpu:
            cpu_losses = cnn_steps(torch, model, part, torch.device("cpu"),
                                   cpu_steps)[2]
        if not _close(losses[:cpu_steps], cpu_losses, PARITY_LOSS_RTOL):
            fail(f"{tag}: card losses {losses[:cpu_steps]}, CPU {cpu_losses}")
        swaps = sorted(set(kept["idx"][0].tolist())
                       ^ set(kept_cpu["idx"][0].tolist()))
        bad = unexplained_swaps(torch, part, kept["sums"][0], d, swaps,
                                decode)
        sk0 = kept["sums"][0]
        est = sketch_decode(part.sketch, sk0, d)
        heavy = int((est * est >= cs_l2sq(sk0) / k).sum())
        del est
        if bad or len(swaps) > part.k // 100:
            fail(f"{tag}: the first step selects {len(swaps)} coordinates "
                 f"differently on the card and the CPU; not near-ties: {bad}")
        log(f"[{tag}] card vs CPU: losses within rtol {PARITY_LOSS_RTOL} "
            f"over {cpu_steps} step(s) (CPU {cpu_losses}); the first step's "
            f"heavy set {heavy} (k={k}); its selection: {len(swaps)} "
            f"coordinates differ, each a "
            f"near-tie (within {CNN_TIE_RTOL} of the k-th score or the "
            "heavy threshold)")
        out[model] = {"counts": counts, "shapes": shapes, "losses": losses,
                      "step_ms": ms, "nondeterministic_step_ms": fast_ms,
                      "profile": prof}
        del step, part
        torch.cuda.empty_cache()
    return out


def cnn_batch(i, device):
    """Step i's global batch of ``ImageStream`` seed 0, split over the
    CNN cell's workers: (images (P, b, 32, 32, 3), labels (P, b))."""
    from repro_torch.data import ImageStream
    b = ImageStream(global_batch=CNN_BATCH, seed=0).global_batch_at(i, device)
    per = CNN_BATCH // CNN_P
    return (b["images"].reshape(CNN_P, per, 32, 32, 3),
            b["labels"].reshape(CNN_P, per))


def paper_table2_phase(torch, device) -> dict:
    """Table II on the card: ``bench.throughput.main`` at full size. Prints
    each method's t_compu, t_compr and t_commu (Eq. 1 at 1 GbE), images/s
    measured and modelled, and g/k, g/s; asserts no ratio."""
    from repro_torch.bench import throughput
    res = throughput.main(device=device)
    for model in ("resnet20", "vgg16"):
        per = res[model]
        for m in throughput.METHODS:
            r = per[m]
            log(f"[paper_table2] {model} {m}: d={r['d']} k={r['k']} "
                f"W={r['width']} t_compu {r['t_compu'] * 1e3:.4f} ms "
                f"t_compr {r['t_compr'] * 1e3:.4f} ms t_commu "
                f"{r['t_commu'] * 1e3:.4f} ms (Eq. 1, 1 GbE: {r['rounds']} "
                f"rounds, {r['bytes']:.0f} B); images/s measured "
                f"{r['img_per_s']:.2f}, modelled {r['img_per_s_accel']:.2f}")
        log(f"[paper_table2] {model}: g/k measured "
            f"{per['speedup_vs_gtopk_img_per_s']:.4f}x modelled "
            f"{per['speedup_vs_gtopk_img_per_s_accel']:.4f}x; g/s measured "
            f"{per['speedup_vs_sketched_img_per_s']:.4f}x modelled "
            f"{per['speedup_vs_sketched_img_per_s_accel']:.4f}x (paper: g/k "
            "1.3-3.1x, g/s 1.1-1.2x)")
    return res


def paper_figs_phase(torch, device) -> None:
    """Figs. 2-3 and 6-7 on the card: ``bench.convergence.main`` and
    ``bench.k_sensitivity.main`` for CNN_FIG_STEPS steps; finite losses."""
    from repro_torch.bench import convergence, k_sensitivity
    conv = convergence.main(steps=CNN_FIG_STEPS, device=device)
    ks = k_sensitivity.main(steps=CNN_FIG_STEPS, device=device)
    finals = {f"{m} {meth}": r["losses"][-1] for m in ("resnet20", "vgg16")
              for meth, r in conv[m].items()}
    finals.update({f"resnet20 gs-sgd k={k}": r["losses"][-1]
                   for k, r in ks.items()})
    bad = {n: v for n, v in finals.items() if not math.isfinite(v)}
    if bad:
        fail(f"paper_figs: non-finite final losses {bad}")
    log(f"[paper_figs] final losses after {CNN_FIG_STEPS} steps: {finals}")


def cross_batch(torch, cfg, spec, step):
    """The vlm's stub frontend: seeded (batch, n_cross_tokens, d_model)
    patch embeddings for ``step``, the same on either device."""
    import numpy as np
    rs = np.random.RandomState(1000 * spec.seed + step)
    return torch.from_numpy(rs.randn(spec.batch, cfg.n_cross_tokens,
                                     cfg.d_model).astype(np.float32))


def card_cpu_runs(torch, build, steps, card="cuda"):
    """``steps`` steps of the cell ``build(device)`` -> (train step, state,
    ``batch_at(step)``: the step's worker-sharded batch) on the CPU and on
    ``card``. Returns ((losses, EF states) on the CPU, the same on the
    card) and the card run's launch counts (set to 0 just before it, read
    just after) with the select's CTAs whose slab overflowed."""
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.kernels.topk_select import slab_overflows
    results, counts = [], {}
    for dev in ("cpu", card):
        ts, state, batch_at = build(dev)
        losses, efs = [], []
        on_card = len(results) == 1
        if on_card:
            slab_overflows(ts.device, reset=True)
            torch.cuda.synchronize()
            LAUNCHES.clear()
        for step in range(steps):
            state, m = ts.fn(state, batch_at(step))
            losses.append(float(m["loss"]))
            efs.append(state["ef"])
        if on_card:
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            counts["slab_overflows"] = slab_overflows(ts.device, reset=True)
        results.append((losses, efs))
    return results, counts


def smoke_runs(torch, spec, steps=2, card="cuda", ef_dtype=None,
               cross_kv=False):
    """``card_cpu_runs`` of ``spec`` (through ``launch.train.build``) from
    the same params and batches. ``ef_dtype``: the EF's storage dtype
    (``make_state``); ``cross_kv``: the batches carry the vlm's seeded
    patch embeddings (``cross_batch``)."""
    from repro_torch.core.gs_sgd import make_state
    from repro_torch.data import LMStream
    from repro_torch.launch import train as ttrain
    from repro_torch.models.flatten import init_flat_params
    params_cpu = {}

    def build(dev):
        cfg, opt, _, ts = ttrain.build(spec, dev)
        if not params_cpu:
            params_cpu.update(init_flat_params(
                cfg, torch.Generator().manual_seed(spec.seed), 1, ts.fs))
        state = make_state({k: v.to(ts.device) for k, v in
                            params_cpu.items()}, opt, ts.compressor,
                           ts.d_local, ts.nworkers,
                           ef_dtype=ef_dtype or torch.float32)
        stream = LMStream(vocab_size=cfg.vocab_size, seq_len=spec.seq,
                          global_batch=spec.batch, seed=spec.seed)

        def batch_at(step):
            gb = stream.global_batch_at(step, dev)
            if cross_kv:
                gb["cross_kv"] = cross_batch(torch, cfg, spec, step).to(dev)
            return ttrain.shard_batch(gb, ts.nworkers)
        return ts, state, batch_at
    return card_cpu_runs(torch, build, steps, card)


def _close(a, b, rtol):
    return all(abs(x - y) <= rtol * abs(x) for x, y in zip(a, b))


def smoke_spec():
    from repro_torch.api import RunSpec
    return RunSpec.load(os.path.join(ROOT, "examples", "specs",
                                     "qwen3_smoke.json"))


def parity_phase(torch, card="cuda") -> dict:
    """The smoke spec (gs-SGD), two steps, card against CPU from the same
    inputs; its buckets are below 2^22, so the scores kernel runs."""
    results, counts = smoke_runs(torch, smoke_spec(), card=card)
    hold_parity(torch, "parity", "qwen3-4b", results, counts)
    check_launches("parity", counts, (), ("sketch_decode", "ts_encode",
                                          "heavymix_scores_ts",
                                          "ts_transpose"))
    log("[parity] losses within rtol "
        f"{PARITY_LOSS_RTOL}; selected coordinates equal every step")
    return counts


SCORES_ROUTE = ("sketch_encode", "sketch_encode_finish", "heavymix_scores",
                "topk_select")


def hold_parity(torch, tag, label, results, counts, rtol=PARITY_LOSS_RTOL,
                launched=SCORES_ROUTE) -> float:
    """Card against CPU: losses within ``rtol``, the selected coordinates
    (the EF zero pattern of every exchange group and bucket) equal every
    step, the EF in the same dtype, and the ``launched`` kernels run (the
    scores route's). Returns the losses' largest relative difference."""
    from repro_torch.ckpt.checkpoint import flatten
    (lc, ec), (lg, eg) = results
    rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    log(f"[{tag}] {label} smoke losses cpu {lc} cuda {lg} (max rel "
        f"{rel:.3e}); card launches {counts}")
    if not _close(lc, lg, rtol):
        fail(f"{label}: card and CPU losses differ: {lc} vs {lg}")
    for s, (a, b) in enumerate(zip(ec, eg)):
        xs, ys = (
            [x for x in flatten(e)[0] if isinstance(x, torch.Tensor)]
            for e in (a, b))
        if len(xs) != len(ys):
            fail(f"{label}: {len(ys)} EF tensors on the card, {len(xs)} on "
                 "the CPU")
        for i, (x, y) in enumerate(zip(xs, ys)):
            if x.dtype != y.dtype:
                fail(f"{label}: EF dtype {y.dtype} on the card, {x.dtype} "
                     "on the CPU")
            if not torch.equal(x == 0, (y == 0).cpu()):
                fail(f"{label}: selected coordinates differ at step {s} "
                     f"bucket {i}")
    check_launches(f"{tag} {label}", counts, launched)
    return rel


def parity_configs_phase(torch, card="cuda") -> dict:
    """Two steps of each new dense smoke config (the smoke spec with the
    arch replaced), card against CPU from the same params and batches:
    losses within PARITY_LOSS_RTOL, selected coordinates equal."""
    counts = {}
    for arch in NEW_SMOKE_ARCHS:
        spec = dataclasses.replace(smoke_spec(), arch=arch)
        results, c = smoke_runs(torch, spec, card=card)
        hold_parity(torch, "parity", arch, results, c)
        counts[arch] = c
    log(f"[parity] {', '.join(NEW_SMOKE_ARCHS)}: losses within rtol "
        f"{PARITY_LOSS_RTOL}; selected coordinates equal every step")
    return counts


def parity_families_phase(torch, card="cuda") -> dict:
    """Two steps of each other family's smoke config (the smoke spec with
    the arch replaced), card against CPU as ``parity_configs_phase``
    holds the dense ones; the vlm once more with ``cross_kv`` in its
    batches, and qwen3-moe once more under its override row's optimizer
    and EF dtype (SGD with momentum, a bf16 EF), passed in: the row is
    keyed by the full config's name. Returns the summed card launches."""
    runs = [(arch, arch, {}) for arch in FAMILY_SMOKE_ARCHS]
    runs += [("llama-3.2-vision-11b", "llama-3.2-vision-11b + cross_kv",
              {"cross_kv": True}),
             ("qwen3-moe-235b-a22b", "qwen3-moe-235b-a22b + sgdm, bf16 EF",
              {"optimizer": "sgdm", "ef_dtype": torch.bfloat16})]
    total: dict = {}
    for arch, label, kw in runs:
        spec = dataclasses.replace(smoke_spec(), arch=arch,
                                   optimizer=kw.get("optimizer"))
        results, c = smoke_runs(torch, spec, card=card,
                                ef_dtype=kw.get("ef_dtype"),
                                cross_kv=kw.get("cross_kv", False))
        hold_parity(torch, "parity_families", label, results, c)
        if kw.get("ef_dtype") is not None and results[1][1][-1][0].dtype \
                != kw["ef_dtype"]:
            fail(f"{label}: the EF is {results[1][1][-1][0].dtype} after "
                 "the steps")
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    log(f"[parity_families] {len(runs)} runs: losses within rtol "
        f"{PARITY_LOSS_RTOL}; selected coordinates equal every step")
    return total


def baselines_phase(torch, card="cuda"):
    """Every compressor of the registry: two smoke-spec steps on the card
    and on the CPU, losses within PARITY_LOSS_RTOL."""
    from repro_torch.core.compression import REGISTRY
    base = smoke_spec()
    for name in sorted(REGISTRY):
        spec = dataclasses.replace(base, exchange=dataclasses.replace(
            base.exchange, compressor=name))
        t0 = time.time()
        results, counts = smoke_runs(torch, spec, card=card)
        (lc, _), (lg, _) = results
        log(f"[baselines] {name}: losses cpu {lc} cuda {lg}; card launches "
            f"{counts} ({time.time() - t0:.1f} s)")
        if not all(math.isfinite(x) for x in lc + lg):
            fail(f"{name}: non-finite loss")
        if not _close(lc, lg, PARITY_LOSS_RTOL):
            fail(f"{name}: card and CPU losses differ: {lc} vs {lg}")
    log(f"[baselines] {len(REGISTRY)} compressors: card and CPU losses "
        f"within rtol {PARITY_LOSS_RTOL}")


def _ckpt_files(d, step):
    path = os.path.join(d, f"step_{step}")
    return {f: os.path.join(path, f) for f in sorted(os.listdir(path))
            if f.endswith(".npy")}


def cli_resume_phase():
    """The train CLI on the card, smoke spec, four steps: once with
    checkpoints every step and a simulated crash after step 2, then
    ``--resume`` to step 4; once straight to step 4. The final losses (the
    JSON floats) and every tensor of the two step-4 checkpoints must be
    bit-equal."""
    import numpy as np
    base = os.path.join(ROOT, "build", "cli_ckpt")
    if os.path.isdir(base):
        import shutil
        shutil.rmtree(base)
    d_res, d_str = os.path.join(base, "resumed"), os.path.join(base, "straight")
    common = ("--steps", "4", "--ckpt-every", "1")
    cli_phase((*common, "--ckpt-dir", d_res, "--kill-at", "2"),
              final=False)
    resumed = cli_phase((*common, "--ckpt-dir", d_res, "--resume"))
    straight = cli_phase((*common, "--ckpt-dir", d_str))
    a, b = _ckpt_files(d_res, 4), _ckpt_files(d_str, 4)
    same = list(a) == list(b) and all(
        np.array_equal(np.load(a[f]), np.load(b[f])) for f in a)
    log(f"[cli] resumed final_loss {resumed['final_loss']!r}, straight "
        f"{straight['final_loss']!r}; step-4 checkpoints ({len(a)} tensors) "
        f"bit-equal: {same}")
    if resumed["final_loss"] != straight["final_loss"] or not same:
        fail("the resumed CLI run differs from the straight one")


def cli_phase(extra=(), final=True):
    lines = run_cli("repro_torch.launch.train",
                    ["--spec", os.path.join("examples", "specs",
                                            "qwen3_smoke.json"), *extra],
                    tag="cli")
    if not final:
        return None
    last = json.loads(lines[-1])
    if not math.isfinite(last["final_loss"]):
        fail(f"the train CLI gave a non-finite loss: {last}")
    return last

# ---------------------------------------------------------------------------
# The driver's observability and re-planning loop: train_traced,
# train_watched, cli_tune
# ---------------------------------------------------------------------------

WATCH_STEPS = 6   # re-plan at step 2 (warmup 1, forced hot), rebuilt steps
#                   3-5 (3 tagged warmup, 4 the new baseline, 5 may decide)
TRACED_PHASES = ("backward", "encode", "comm", "recover", "optimizer")


def cell_spec(ts, exchange, steps=TRAIN_STEPS, **kw):
    """The RunSpec of a full-width cell: qwen3-4b with ``d`` set to the
    2-layer d (the CLI cannot build qwen3-4b at 2 layers), so the
    simulator, the tuner and the watchdog price the cell that runs."""
    from repro_torch.api import ClusterSpec, RunSpec
    return RunSpec(arch="qwen3-4b", d=ts.d_local, steps=steps,
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, seed=0,
                   exchange=exchange, cluster=ClusterSpec(p=ts.nworkers),
                   **kw)


def _on_card(ts) -> bool:
    return ts.device.type == "cuda"


def drive_cell(torch, ts, opt, spec, steps, state=None, **kw):
    """``launch.train.drive`` over steps ``steps`` of the cell's stream
    (seed 0), from a fresh state (seed 0) unless ``state`` is given."""
    from repro_torch.data import LMStream
    from repro_torch.launch.train import drive
    if state is None:
        state = ts.init_state(opt, torch.Generator(device=ts.device)
                              .manual_seed(0))
    stream = LMStream(vocab_size=ts.fs.cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    steps = list(steps)
    return drive(spec, ts, state,
                 lambda s: stream.global_batch_at(s, ts.device), steps,
                 log_every=1, last=steps[-1], **kw)


def step_launches(ts) -> dict:
    """The launches one step of ``ts`` makes on the card: per (model
    rank, worker) and bucket an encode, its finish (once a bucket and
    exchange group for a fused merge, which finishes the group's workers'
    sketches), the decode past the reference's chunked threshold (d >
    2^22 and d > 4k) or the scores kernel below it, and the select."""
    import collections

    from repro_torch.core.heavymix import _CHUNK
    want = collections.Counter()
    p = ts.ma.tp * ts.nworkers
    groups = max(1, len(ts.comp_groups))
    sizes = ts.compressor.spec.sizes
    frags = ts.plan.fragments() if ts.fuse_encode else None
    for i, (c, d) in enumerate(zip(ts.compressor.parts, sizes)):
        if frags is not None:
            want["sketch_encode"] += p * len(frags[i])
            want["sketch_encode_finish"] += groups
        else:
            want["sketch_encode"] += p
            want["sketch_encode_finish"] += p
        route = ("sketch_decode" if d > _CHUNK and d > 4 * c.k
                 else "heavymix_scores")
        want[route] += p
        want["topk_select"] += p
    return dict(want)


def _diff(after: dict, before: dict) -> dict:
    out = {k: v - before.get(k, 0) for k, v in after.items()}
    return {k: v for k, v in out.items() if v}


def train_traced_phase(torch, ts, opt, exchange, profiled=None,
                       train_peak=None) -> dict:
    """The main cell, three steps untraced, then the same three steps with
    the tracer and the trace@2 recorder (``launch.train.drive``, as
    ``--trace --json`` runs it): losses bit-equal; the trace valid, one
    probe span, a step span a step (step 0 warmup), every phase > 0, a span
    a bucket; the trace@2 document complete. ``profiled``: the ``profile``
    phase's split, printed beside the probe's phases."""
    from repro_torch import obs
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.train import Trace2Recorder, state_bytes
    from repro_torch.obs import trace as obtrace
    tag = "train_traced"
    spec = cell_spec(ts, exchange)
    LAUNCHES.clear()
    plain = drive_cell(torch, ts, opt, spec, range(TRAIN_STEPS))
    plain_counts = dict(LAUNCHES)
    del plain["state"]
    if _on_card(ts):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tracer = obs.Tracer()
    prov = obs.provenance(spec, ts.device)
    rec = Trace2Recorder(spec, ts, prov)
    LAUNCHES.clear()
    traced = drive_cell(torch, ts, opt, spec, range(TRAIN_STEPS),
                        tracer=tracer, recorder=rec)
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if _on_card(ts) else None
    state_b = state_bytes(traced.pop("state"))
    if _on_card(ts):
        torch.cuda.empty_cache()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    doc2 = rec.document(ts.fs.cfg.name)
    probe_s = time.perf_counter() - t0
    probe_counts = dict(LAUNCHES)
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    doc = tracer.save(os.path.join(out_dir, f"{tag}_trace.json"), spec=spec,
                      provenance=prov, source="train")
    obs.dump(doc2, os.path.join(out_dir, f"{tag}_trace2.json"))

    lp, lt = plain["history"], traced["history"]
    log(f"[{tag}] losses untraced {lp} / traced {lt}")
    if lp != lt:
        fail(f"traced losses {lt} differ from the untraced run's {lp}")
    if not all(math.isfinite(x) for x in lt):
        fail(f"non-finite loss on the {tag} path: {lt}")
    n_spans = obtrace.validate(doc)
    probes = obtrace.spans(doc, cat="probe")
    steps = obtrace.spans(doc, cat="step")
    warm = {s["args"]["step"]: s["args"]["warmup"] for s in steps}
    totals = obtrace.phase_totals(doc)
    per_bucket = {cat: obtrace.bucket_durations(doc, cat, prefix)
                  for cat, prefix in (("encode", "encode/b"),
                                      ("comm", "allreduce/b"),
                                      ("recover", "recover/b"))}
    if len(probes) != 1 or len(steps) != TRAIN_STEPS:
        fail(f"{tag}: {len(probes)} probe spans and {len(steps)} step spans")
    if warm != {s: s == 0 for s in range(TRAIN_STEPS)}:
        fail(f"{tag}: warmup tags {warm}")
    missing = [ph for ph in TRACED_PHASES if not totals.get(ph, 0.0) > 0]
    if missing:
        fail(f"{tag}: no time in the probe's phases {missing}: {totals}")
    for cat, durs in per_bucket.items():
        if len(durs) != ts.n_buckets:
            fail(f"{tag}: {len(durs)} {cat} bucket spans, not "
                 f"{ts.n_buckets}")
    pred, gauges = doc2["predicted"], doc2["metrics"]["gauges"]
    if "error" in pred or "step_time" not in pred:
        fail(f"{tag}: the trace@2 predicted block is {pred}")
    if "recovery_error_probe" not in gauges:
        fail(f"{tag}: the trace@2 document has no recovery_error_probe")
    if len(doc2["records"]) != TRAIN_STEPS:
        fail(f"{tag}: {len(doc2['records'])} trace@2 records")
    pv = doc2["provenance"]
    if _on_card(ts) and (pv["backend"] != "cuda" or pv["device_kind"]
                         != torch.cuda.get_device_name(0)):
        fail(f"{tag}: provenance does not name the card: {pv}")
    launched = ("sketch_encode", "sketch_encode_finish", "sketch_decode",
                "topk_select")
    check_launches(tag, counts, launched,
                   ("heavymix_scores", "heavymix_scores_ts", "ts_transpose",
                    "ts_encode"))
    per_step = step_launches(ts)
    for name, cnt in per_step.items():
        if plain_counts.get(name, 0) != cnt * TRAIN_STEPS:
            fail(f"{name} launched {plain_counts.get(name, 0)} times on the "
                 f"untraced {tag} run, not {cnt * TRAIN_STEPS}")
        if counts.get(name, 0) != cnt * (TRAIN_STEPS + 1):
            fail(f"{name} launched {counts.get(name, 0)} times on the "
                 f"traced {tag} run, not {cnt * (TRAIN_STEPS + 1)} "
                 f"({TRAIN_STEPS} steps and the probe)")
    check_launches(f"{tag} recovery probe", probe_counts,
                   ("sketch_encode", "sketch_encode_finish",
                    "heavymix_scores", "topk_select"),
                   ("sketch_decode",))

    probe = traced["probe"]
    phase_ms = {ph: totals.get(ph, 0.0) * 1e3 for ph in
                ("forward",) + TRACED_PHASES}
    log(f"[{tag}] trace: {n_spans} spans valid; probe at step "
        f"{probe['step']} {probes[0]['dur'] * 1e3:.3f} ms; probe phases "
        f"(host clock, a device sync at each span's end) "
        + json.dumps({k: round(v, 3) for k, v in phase_ms.items()}))
    log(f"[{tag}] probe per bucket (ms): " + json.dumps(
        {cat: [round(x * 1e3, 3) for x in durs]
         for cat, durs in per_bucket.items()}))
    if profiled is not None:
        log(f"[{tag}] beside the profile phase's device time per span "
            f"(ms): " + json.dumps({k: round(v, 3) for k, v in
                                    profiled["span_device_ms"].items()
                                    if v}))
    tp, tt = plain["times"], traced["times"]
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    log(f"[{tag}] step seconds untraced {tp} / traced {tt}; after the "
        f"first: {mean(tp[1:]):.4f} / {mean(tt[1:]):.4f} s "
        f"({(mean(tt[1:]) / mean(tp[1:]) - 1) * 100:+.2f}%)")
    log(f"[{tag}] probe's state copy {probe['copy_bytes']} bytes "
        f"({probe['copy_bytes'] / 2**30:.2f} GiB, the state is {state_b} "
        f"bytes); probe step {probe['seconds']:.4f} s; peak "
        f"{peak} bytes"
        + (f" ({peak / 2**30:.2f} GiB; train's {train_peak / 2**30:.2f} "
           "GiB)" if peak is not None and train_peak else ""))
    log(f"[{tag}] trace@2: predicted {json.dumps(pred)}; "
        f"recovery_error_probe {gauges['recovery_error_probe']!r} "
        f"({probe_s:.3f} s, launches {probe_counts}); t_step "
        f"{[r['t_step'] for r in doc2['records']]}; provenance "
        f"{pv['backend']} {pv['device_kind']} x {pv['device_count']}")
    log(f"[{tag}] launches untraced {plain_counts} / traced {counts} "
        f"(= {TRAIN_STEPS} steps + the probe)")
    return {"counts": counts, "phase_ms": phase_ms, "times": tt,
            "plain_times": tp, "copy_bytes": probe["copy_bytes"],
            "peak": peak}


def train_watched_phase(torch, ts, opt, exchange, make_step) -> dict:
    """The main cell with the drift watchdog forced hot (warmup 1, delta
    -1, threshold 0, budget 4, as the reference's test arms it): every
    detection reaches a decision, an applied re-plan clears the 1% gain
    bar, and the rebuilt step (``make_step(exchange)``, the re-plan's
    exchange at the cell's widths) runs at least two steps with finite
    losses and launches what its geometry implies."""
    from repro_torch.api import WatchSpec
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.tune.watch import Watchdog
    tag = "train_watched"
    spec = cell_spec(ts, exchange, steps=WATCH_STEPS,
                     watch=WatchSpec(enabled=True, warmup=1, delta=-1.0,
                                     threshold=0.0, replan_budget=4))
    wd = Watchdog(spec)
    snaps: dict[int, dict] = {}

    def after(step, state, loss):
        snaps[step] = dict(LAUNCHES)
        return False

    def rebuild(new_spec):
        t = make_step(new_spec.exchange)
        log(f"[{tag}] rebuilt the step: buckets {list(t.compressor.spec.sizes)}"
            f", bwd_chunks {t.bwd_chunks}, (k, W) "
            f"{[(c.k, c.sketch.width) for c in t.compressor.parts]}")
        return t

    LAUNCHES.clear()
    out = drive_cell(torch, ts, opt, spec, range(WATCH_STEPS), watchdog=wd,
                     rebuild=rebuild, after_step=after)
    hist, times = list(out["history"]), list(out["times"])
    for e in wd.log:
        log(f"[{tag}] " + json.dumps({k: e[k] for k in (
            "kind", "step", "phase", "choice", "predicted", "current",
            "gain", "direction", "rel") if k in e}))
    kinds = [e["kind"] for e in wd.log]
    if "drift.detected" not in kinds:
        fail(f"{tag}: the forced-hot watchdog detected nothing")
    if len(kinds) != 2 * kinds.count("drift.detected"):
        fail(f"{tag}: a detection reached no decision: {kinds}")
    for e in wd.log:
        if e["kind"] == "watch.replan" and not e["gain"] >= 0.01:
            fail(f"{tag}: a re-plan under the 1% gain bar: {e}")
    replans = out["replans"]
    if replans:
        rp = replans[-1]
        last, new_ts = rp["step"], out["ts"]
        ran = WATCH_STEPS - 1 - last
        if ran < 2:   # a re-plan at the last steps: run the rebuilt step on
            more = drive_cell(torch, new_ts, opt, out["spec"],
                              range(WATCH_STEPS, WATCH_STEPS + 2 - ran),
                              state=out["state"], after_step=after)
            hist += more["history"]
            times += more["times"]
            ran = 2
            del more
        counts = _diff(dict(LAUNCHES), snaps[last])
        want = {k: v * ran for k, v in step_launches(new_ts).items()}
        log(f"[{tag}] re-planned at step {last} (error feedback "
            f"{'kept' if rp['ef_kept'] else 'reset'}); the rebuilt step ran "
            f"{ran} steps: launches {counts}, its geometry implies {want}")
        if counts != want:
            fail(f"{tag}: the rebuilt step launched {counts}, not {want}")
        log(f"[{tag}] choice {rp['choice']}: predicted step "
            f"{rp['predicted'] * 1e3:.3f} ms against the current spec's "
            f"{rp['current'] * 1e3:.3f} ms (gain {rp['gain']:.2%}); measured "
            f"step {times[last]:.4f} s before, "
            f"{times[last + 2:]} s after (the first rebuilt step is warm-up)")
    else:
        log(f"[{tag}] every decision kept the plan; step seconds {times}")
    del out
    if not all(math.isfinite(x) for x in hist):
        fail(f"non-finite loss on the {tag} path: {hist}")
    log(f"[{tag}] losses {hist}")
    return {"log": wd.log, "replans": replans, "losses": hist,
            "times": times}


def run_cli(module, args, tag="cli_tune") -> list[str]:
    """``python -m module args`` from the repository root; its last output
    lines logged, a non-zero exit a failure. Returns its output lines."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", module, *args]
    log(f"[{tag}] {' '.join(cmd[1:])}")
    t0 = time.time()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    for line in lines[-3:]:
        log(f"[{tag}] {line}")
    if r.returncode != 0:
        log(r.stderr[-4000:])
        fail(f"{module} exited {r.returncode}")
    log(f"[{tag}] ran in {time.time() - t0:.1f} s")
    return lines


def cli_tune_phase(device_args=()):
    """The smoke spec through the CLIs: ``train --trace --json`` on the
    card, two more ``--json`` captures at other bucket counts and widths
    (so the Eq. 1 fit is identifiable: rounds and bytes must both vary),
    ``repro_torch.launch.tune --calibrate`` on the three trace@2 files, then
    ``train --auto-tune PLAN`` and ``train`` with ``plan.train_argv()``:
    their loss histories (the trace@2 records' losses) bit-equal."""
    import shutil

    from repro_torch.obs import trace as obtrace
    from repro_torch.tune import TunePlan
    base = os.path.join(ROOT, "build", "cli_tune")
    if os.path.isdir(base):
        shutil.rmtree(base)
    os.makedirs(base)
    path = lambda name: os.path.join(base, name)  # noqa: E731
    spec = os.path.join("examples", "specs", "qwen3_smoke.json")
    train = "repro_torch.launch.train"
    common = ["--spec", spec, "--steps", "3", *device_args]
    run_cli(train, [*common, "--trace", path("trace.json"),
                    "--json", path("steps_b2.json")])
    run_cli(train, [*common, "--buckets", "1", "--json", path("steps_b1.json")])
    run_cli(train, [*common, "--buckets", "1", "--width", "1024",
                    "--json", path("steps_b1_w1024.json")])
    run_cli("repro_torch.launch.tune",
            ["--spec", spec, "--calibrate", path("steps_b2.json"),
             path("steps_b1.json"), path("steps_b1_w1024.json"),
             "--out", path("plan.json"), *device_args])
    plan = TunePlan.load(path("plan.json"))
    run_cli(train, [*common, "--auto-tune", path("plan.json"),
                    "--json", path("auto.json")])
    run_cli(train, [*common, *plan.train_argv(), "--json",
                    path("manual.json")])
    doc = obtrace.load(path("trace.json"))
    n = obtrace.validate(doc)
    totals = obtrace.phase_totals(doc)
    if len(obtrace.spans(doc, cat="probe")) != 1 or any(
            not totals.get(ph, 0) > 0 for ph in TRACED_PHASES):
        fail(f"cli_tune: the CLI's trace lacks its probe or a phase: "
             f"{totals}")
    with open(path("steps_b2.json")) as f:
        t2 = json.load(f)
    if "error" in t2["predicted"] or "recovery_error_probe" not in \
            t2["metrics"]["gauges"]:
        fail(f"cli_tune: the CLI's trace@2 document is incomplete: "
             f"{t2['predicted']} {t2['metrics']['gauges']}")
    losses = {}
    for name in ("auto", "manual"):
        with open(path(f"{name}.json")) as f:
            losses[name] = [r["loss"] for r in json.load(f)["records"]]
    log(f"[cli_tune] trace {n} spans valid, probe phases (ms) "
        + json.dumps({k: round(v * 1e3, 3) for k, v in totals.items()}))
    log(f"[cli_tune] plan {plan.summary()}; calibrated alpha "
        f"{plan.spec.cluster.link_alpha!r} beta {plan.spec.cluster.link_beta!r}"
        f" t_compute {plan.spec.cluster.compute_mean!r}; train flags "
        f"{' '.join(plan.train_argv())}")
    log(f"[cli_tune] losses --auto-tune {losses['auto']} / manual flags "
        f"{losses['manual']}")
    if losses["auto"] != losses["manual"] or not losses["auto"]:
        fail("cli_tune: --auto-tune and the plan's manual flags differ")
    return {"plan": plan.choice.label(), "losses": losses["auto"]}


# ---------------------------------------------------------------------------
# Serving: serve, serve_families, serve_parity, serve_load, cli_serve
# ---------------------------------------------------------------------------

SERVE_SLOTS, SERVE_BLOCK, SERVE_MAX_LEN = 8, 16, 256
# (tag, arch, layers (None: all), requests, prompt lengths lo-hi, gen)
SERVE_CELLS = (
    ("serve", "qwen3-4b", None, 12, 16, 192, 64),
    ("serve_zamba2", "zamba2-2.7b", 12, 10, 16, 192, 32),
    ("serve_rwkv6", "rwkv6-7b", 8, 10, 16, 192, 32),
    ("serve_granite", "granite-moe-3b-a800m", 4, 10, 16, 192, 32),
)
SERVE_REPLICA_REQUESTS, SERVE_REPLICA_GEN = 6, 16
SERVE_TIE_ATOL = 1e-3  # a greedy token may differ between two computations
#                        of the same logits (prefill against decode; the
#                        card against the CPU) only where the top two
#                        logits are within this: f32 sums in another order
#                        move logits near 1 by ~1e-6
SERVE_PARITY_ATOL = 1e-4  # smoke logits card vs CPU (f32, TF32 off)


def serve_spec(arch, slots, block, max_len, prompt_hi, gen):
    from repro_torch.api import RunSpec, ServeSpec
    spec = RunSpec(arch=arch, serve=ServeSpec(
        batch=slots, block_size=block, max_len=max_len,
        prompt_len=prompt_hi, gen=gen))
    spec.validate()
    return spec


def serve_requests(vocab, n, lo, hi, gen, seed=7):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(i, tuple(int(x) for x in rng.integers(
        1, vocab, int(rng.integers(lo, hi + 1)))), gen) for i in range(n)]


def top2_margin(torch, logits):
    v = torch.topk(logits.float(), 2, dim=-1).values
    return (v[..., 0] - v[..., 1]).cpu()


def check_near_ties(tag, what, got, want, margin):
    """Greedy ids equal, or differing only where the reference logits'
    top-2 margin is within SERVE_TIE_ATOL. Returns the near-tie count."""
    diff = (got.cpu() != want.cpu()).nonzero().flatten().tolist()
    bad = [i for i in diff if float(margin[i]) > SERVE_TIE_ATOL]
    if bad:
        fail(f"{tag}: {what} differ at rows {bad} (top-2 margins "
             f"{[float(margin[i]) for i in bad]})")
    return len(diff)


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_cell(torch, device, cfg, tag, n_req, lo, hi, gen, *,
               slots=SERVE_SLOTS, block=SERVE_BLOCK, max_len=SERVE_MAX_LEN,
               profile=False, replicas=False) -> dict:
    """One architecture through the serving engine on ``device``; see the
    module docstring (phase 11). Returns the measured numbers."""
    import numpy as np
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.flatten import init_flat_params, make_flat_spec
    from repro_torch.serve import ReplicaSet, Request, ServeEngine
    from repro_torch.serve.loadtest import _latency_report
    from repro_torch.serve.scheduler import serve_fns
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t_phase = time.time()
    fs = make_flat_spec(cfg, 1)
    segs = init_flat_params(cfg, torch.Generator(device=device).manual_seed(
        0), 1, fs, device=device)
    n_params = fs.total
    spec = serve_spec(cfg.name, slots, block, max_len, hi, gen)
    reqs = serve_requests(cfg.vocab_size, n_req, lo, hi, gen)
    fns = serve_fns(cfg, fs)

    def engine(paged=True, subset=None):
        sp = dataclasses.replace(spec, serve=dataclasses.replace(
            spec.serve, paged=paged))
        eng = ServeEngine(cfg, fs, segs, sp, fns=fns)
        for rid, prompt, max_new in (reqs if subset is None else subset):
            eng.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
        return eng

    def timed(eng):
        _sync(torch, device)
        t0 = time.perf_counter()
        comps = eng.run()
        _sync(torch, device)
        return comps, time.perf_counter() - t0

    cold_eng = engine()
    cold, t_cold = timed(cold_eng)
    steady_eng = engine()
    steady, t_steady = timed(steady_eng)
    toks = {c.rid: c.tokens for c in steady}
    if {c.rid: c.tokens for c in cold} != toks:
        fail(f"{tag}: the cold and steady runs emitted different tokens")
    if any(c.finish != "length" or len(c.tokens) != gen for c in steady):
        fail(f"{tag}: a request did not run to its length: "
             f"{[(c.rid, c.finish, len(c.tokens)) for c in steady]}")
    n_tok = sum(len(t) for t in toks.values())
    rep = _latency_report(steady_eng, steady)
    first: dict = {}
    for rid, _tok, _tv, tw in steady_eng.emissions:
        first.setdefault(rid, tw)
    ttft = sorted(first.values())
    q = lambda v, p: v[min(len(v) - 1, int(math.ceil(p * len(v))) - 1)]  # noqa: E731
    out = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "requests": n_req, "tokens": n_tok,
           "decode_steps": steady_eng.n_steps,
           "tok_per_s_steady": n_tok / t_steady,
           "tok_per_s_cold": n_tok / t_cold,
           "steady_s": t_steady, "cold_s": t_cold,
           "ttft_wall_s": {p: q(ttft, v) for p, v in
                           (("p50", .5), ("p95", .95), ("p99", .99))},
           "per_token_wall_s": {k: rep["per_token_wall"][k]
                                for k in ("p50", "p95", "p99")},
           "num_blocks": steady_eng.cache.num_blocks}
    del cold_eng, steady_eng
    log(f"[{tag}] {cfg.name} {cfg.n_layers} layers, {n_params:,} params: "
        f"{n_tok} tokens, steady {out['tok_per_s_steady']:.1f} tok/s "
        f"({t_steady:.3f} s), cold {out['tok_per_s_cold']:.1f} tok/s "
        f"({t_cold:.3f} s); TTFT wall {out['ttft_wall_s']}; per-token wall "
        f"{out['per_token_wall_s']}; {out['decode_steps']} decode steps")

    # the paged cache in lockstep with the contiguous one
    ep, ec = engine(True), engine(False)
    steps = checked = 0
    while ep.pending() or ec.pending():
        if ep.step() != ec.step():
            fail(f"{tag}: paged and contiguous emissions differ at step "
                 f"{steps}")
        steps += 1
        kvp, stp = M.split_cache(ep.cache.gather())
        kvc, stc = M.split_cache(ec.cache.gather())
        for i, sl in enumerate(ep.slots):
            if sl is None:
                continue
            for (path, a), (_, b) in zip(tree_leaves(kvp), tree_leaves(kvc)):
                if not torch.equal(a[:, :, i, :sl.pos], b[:, :, i, :sl.pos]):
                    fail(f"{tag}: paged KV {path} of slot {i} differs from "
                         f"the contiguous cache at step {steps}")
                checked += 1
        for (path, a), (_, b) in zip(tree_leaves(stp), tree_leaves(stc)):
            if not torch.equal(a, b):
                fail(f"{tag}: recurrent state {path} differs at step {steps}")
        del kvp, stp, kvc, stc
    if {c.rid: c.tokens for c in ep.run()} != toks or \
            {c.rid: c.tokens for c in ec.run()} != toks:
        fail(f"{tag}: the lockstep runs' tokens differ from the steady run")
    del ep, ec
    log(f"[{tag}] paged == contiguous: {steps} lockstep steps, the same "
        f"emissions, {checked} (slot, KV leaf) valid regions bit-equal")

    # continuous batching against one request at a time
    for rid, prompt, max_new in reqs:
        solo = engine(subset=[(rid, prompt, max_new)])
        [c] = solo.run()
        if c.tokens != toks[rid]:
            fail(f"{tag}: request {rid} alone emitted other tokens than in "
                 "the continuous batch")
    log(f"[{tag}] continuous batching == sequential for all {n_req} "
        "requests")

    # prefill/decode consistency (tests/test_models_smoke.py's check). An
    # MoE prefill drops (token, choice) pairs past the expert capacity, so
    # a prefill over S tokens and a decode of the S-th differ by design
    # where a drop hits; its rows run one at a time with S = 8 <= the
    # capacity floor of 8 (a token picks an expert at most once), so no
    # pair can be dropped
    moe = bool(cfg.n_experts)
    B, S, T = 4, (8 if moe else 12), 32
    rs = np.random.RandomState(11)
    tk = torch.from_numpy(rs.randint(1, cfg.vocab_size, (B, S))).to(device)
    ties = 0
    for rows in ([slice(i, i + 1) for i in range(B)] if moe
                 else [slice(0, B)]):
        t, b = tk[rows], tk[rows].shape[0]
        lg, _ = M.prefill_fn(cfg, fs, segs, {"tokens": t},
                             M.init_cache(cfg, b, T, torch.float32, device))
        _, cache = M.prefill_fn(cfg, fs, segs, {"tokens": t[:, :S - 1]},
                                M.init_cache(cfg, b, T, torch.float32,
                                             device))
        got, cache = M.decode_fn(cfg, fs, segs, t[:, S - 1:], S - 1, cache)
        ties += check_near_ties(tag, "prefill and decode tokens", got,
                                torch.argmax(lg, -1), top2_margin(torch, lg))
        got2, _ = M.decode_fn(cfg, fs, segs, got[:, None].long(), S, cache)
        if got2.shape != (b,) or not torch.isfinite(lg).all():
            fail(f"{tag}: decode after the consistency step failed")
        del cache
    log(f"[{tag}] prefill/decode consistency on {B} rows of {S} tokens"
        f"{' (one row a prefill)' if moe else ''}: equal ({ties} near-ties "
        f"within {SERVE_TIE_ATOL})")

    if profile:
        eng = engine(subset=reqs[:slots])
        eng.step()
        eng.step()
        if eng.active() != slots:
            fail(f"{tag}: {eng.active()} of {slots} slots active")
        _, out["profile"] = profile_call(torch, f"profile_{tag}", eng.step)
        del eng

    if replicas:
        rgen = min(SERVE_REPLICA_GEN, gen)
        sub = [(rid, prompt, rgen) for rid, prompt, _ in
               reqs[:SERVE_REPLICA_REQUESTS]]
        one = ReplicaSet([engine(subset=[])])
        two = ReplicaSet([engine(subset=[]) for _ in range(2)],
                         heartbeat_timeout=1.5)
        for rset in (one, two):
            for rid, prompt, max_new in sub:
                rset.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
        for _ in range(3):
            two.step_round()
        two.kill(1)
        want = {c.rid: c.tokens for c in one.run()}
        got_c = two.run()
        if {c.rid: c.tokens for c in got_c} != want:
            fail(f"{tag}: the failed-over replica set emitted other tokens")
        if any(want[rid] != toks[rid][:rgen] for rid in want):
            fail(f"{tag}: the replicas' tokens are not the steady run's "
                 "prefix")
        if two.plan.generation != 1 or 1 in two.live() or \
                not any(c.replays for c in got_c):
            fail(f"{tag}: no failover happened ({two.plan}, replays "
                 f"{[c.replays for c in got_c]})")
        log(f"[serve_replica] 2 replicas, replica 1 killed after 3 rounds: "
            f"{len(got_c)} requests replayed identically (replays "
            f"{[c.replays for c in got_c]}, generation "
            f"{two.plan.generation})")
        del one, two

    if on_card:
        _sync(torch, device)
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        out["card"] = card_line()
        log(f"[{tag}] peak memory {out['peak_bytes'] / 2 ** 30:.2f} GiB on "
            f"{out['card']}")
    del segs
    out["phase_s"] = time.time() - t_phase
    return out


def serve_phases(torch, device) -> dict:
    """Phases 11 and 11b: every SERVE_CELLS row at its published widths.
    Returns the launch counts of the whole run (which must be 0) and each
    cell's numbers."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.dispatch import LAUNCHES
    cells = {}
    _sync(torch, device)
    LAUNCHES.clear()
    for tag, arch, layers, n_req, lo, hi, gen in SERVE_CELLS:
        cfg = ARCHS[arch]
        if layers is not None and layers != cfg.n_layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        first = tag == "serve"
        cells[tag] = serve_cell(torch, device, cfg, tag, n_req, lo, hi, gen,
                                profile=first, replicas=first)
        log(f"[{tag}] phase took {cells[tag]['phase_s']:.1f} s")
    _sync(torch, device)
    counts = dict(LAUNCHES)
    if any(counts.values()):
        fail(f"the serve path launched sketch kernels: {counts}")
    log(f"[serve] launches on the serve path: {counts} (none)")
    log("[serve] cells " + json.dumps(cells))
    return counts


def serve_parity_phase(torch, card="cuda") -> dict:
    """Phase 11c. Returns the card's launch counts (which must be 0)."""
    import numpy as np
    from repro_torch.configs import SMOKES
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_map
    from repro_torch.models.flatten import init_flat_params, make_flat_spec
    from repro_torch.models.layers import lm_logits
    from repro_torch.serve import Request, ServeEngine
    card = torch.device(card)
    cpu = torch.device("cpu")

    def decode_logits(cfg, fs, segs, tok, kl, cache, ck):
        """decode_fn's logits (its ids are their argmax) on a copy of the
        cache: the recurrent state advances in place."""
        cache = tree_map(lambda a: a.clone(), cache)
        B, S = tok.shape
        kl = torch.as_tensor(kl, device=tok.device)
        pos = (kl[:, None] if kl.ndim else kl).expand(B, S)
        with torch.no_grad():
            hid, _, top = M._backbone(cfg, fs, segs, tok, pos, torch.float32,
                                      ck, "decode", cache, kl)
            return lm_logits(hid, M._head_w(cfg, top), cfg)[:, 0]

    _sync(torch, card)
    LAUNCHES.clear()
    worst, ties, engines = 0.0, 0, 0
    for arch, cfg in SMOKES.items():
        fs = make_flat_spec(cfg, 1)
        segs = init_flat_params(cfg, torch.Generator().manual_seed(0), 1, fs)
        rs = np.random.RandomState(3)
        B, S, T = 2, 7, 16
        tokens = torch.from_numpy(rs.randint(1, cfg.vocab_size, (B, S)))
        ck = (torch.from_numpy(rs.randn(B, cfg.n_cross_tokens, cfg.d_model)
                               .astype(np.float32))
              if cfg.family == "vlm" else None)
        res = {}
        for key, dev in (("cpu", cpu), ("card", card)):
            sg = {k: v.to(dev) for k, v in segs.items()}
            ckd = None if ck is None else ck.to(dev)
            batch = {"tokens": tokens.to(dev)}
            if ckd is not None:
                batch["cross_kv"] = ckd
            lg, cache = M.prefill_fn(cfg, fs, sg, batch, M.init_cache(
                cfg, B, T, torch.float32, dev))
            res[key] = {"prefill": lg.cpu(), "steps": []}
            tok = torch.argmax(res["cpu"]["prefill"], -1)[:, None]
            for step, kl in enumerate((S, torch.tensor([S + 1, S + 1]))):
                if step:
                    tok = res["cpu"]["steps"][0][0][:, None].long()
                kld = kl.to(dev) if torch.is_tensor(kl) else kl
                dl = decode_logits(cfg, fs, sg, tok.to(dev), kld, cache, ckd)
                ids, cache = M.decode_fn(cfg, fs, sg, tok.to(dev), kld,
                                         cache, cross_kv=ckd)
                if not torch.equal(ids.long(), torch.argmax(dl, -1)):
                    fail(f"serve_parity {arch}: decode_fn's ids are not the "
                         f"argmax of its logits on {dev.type}")
                res[key]["steps"].append((ids.cpu(), dl.cpu()))
        err = float((res["cpu"]["prefill"] - res["card"]["prefill"]).abs()
                    .max())
        worst = max(worst, err)
        if err > SERVE_PARITY_ATOL:
            fail(f"serve_parity {arch}: prefill logits differ by {err}")
        for (ic, lc), (ig, _) in zip(res["cpu"]["steps"],
                                     res["card"]["steps"]):
            ties += check_near_ties(f"serve_parity {arch}", "decode ids",
                                    ig, ic, top2_margin(torch, lc))
        if cfg.family != "vlm":
            spec = serve_spec(arch, 3, 4, 16, 8, 4)
            spec = dataclasses.replace(spec, smoke=True)
            reqs = serve_requests(cfg.vocab_size, 6, 1, 7, 4, seed=1)
            comps = []
            for dev in (cpu, card):
                eng = ServeEngine(cfg, fs, {k: v.to(dev) for k, v in
                                            segs.items()}, spec)
                for rid, prompt, max_new in reqs:
                    eng.submit(Request(rid=rid, prompt=prompt,
                                       max_new=max_new))
                comps.append([dataclasses.asdict(c) for c in eng.run()])
            if comps[0] != comps[1]:
                fail(f"serve_parity {arch}: the card's engine completions "
                     "differ from the CPU's")
            engines += 1
    _sync(torch, card)
    counts = dict(LAUNCHES)
    if any(counts.values()):
        fail(f"serve_parity launched sketch kernels: {counts}")
    log(f"[serve_parity] {len(SMOKES)} smoke configs: prefill logits within "
        f"{worst:.3g} (atol {SERVE_PARITY_ATOL}), two decode steps' ids "
        f"equal ({ties} near-ties within {SERVE_TIE_ATOL}); {engines} "
        "engines' completions equal, card against CPU")
    return counts


def cli_serve_phase(device_args=()):
    """Phase 11d: the load-test audit and the serve CLI on the card
    (``device_args`` ("--device", "cpu") rehearses it on the CPU)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        bench = os.path.join(tmp, "BENCH_serve.json")
        run_cli("repro_torch.bench.serve_load",
                ["--out", bench, *device_args], tag="serve_load")
        with open(bench) as f:
            doc = json.load(f)
        if not all(doc["checks"].values()) or \
                doc["provenance"]["backend"] != (device_args[-1]
                                                 if device_args else "cuda"):
            fail(f"serve_load: checks {doc['checks']}, backend "
                 f"{doc['provenance']['backend']}")
        w = doc["wall"]
        log(f"[serve_load] checks {doc['checks']}; wall steady "
            f"{w['tok_per_s_steady']:.1f} tok/s, cold "
            f"{w['tok_per_s_cold']:.1f} tok/s")
        lines = run_cli("repro_torch.launch.serve",
                        ["--smoke", *device_args], tag="cli_serve")
        if not any("steady" in ln and "cold" in ln for ln in lines):
            fail("the serve demo printed no steady/cold tok/s line")
        path = os.path.join(tmp, "serve.json")
        run_cli("repro_torch.launch.serve",
                ["--smoke", "--load-test", "--json", path, *device_args],
                tag="cli_serve")
        with open(path) as f:
            rep = json.load(f)
        if not (rep["tokens_match_static"]
                and rep["continuous"]["dropped"] == 0
                and rep["speedup_vs_static"] > 1.0
                and rep["provenance"]["backend"] == doc["provenance"][
                    "backend"]):
            fail("the serve CLI's load test failed its checks: tokens "
                 f"match {rep['tokens_match_static']}, speedup "
                 f"{rep['speedup_vs_static']}")
        log(f"[cli_serve] load test: speedup vs static "
            f"{rep['speedup_vs_static']:.3f}, tokens match static")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Tensor parallelism (tp > 1) and fsdp storage with the pod axis
# ---------------------------------------------------------------------------


def sharded_step(torch, device, cfg, ma, dp_mode="dp", kw=None):
    """A step of ``cfg`` on mesh ``ma`` in ``dp_mode``: the main path's
    exchange (``kw=None``), or the legacy exchange kwargs ``kw``
    (``{"compressor_name": None}`` is the dense psum). AdamW at TRAIN_LR,
    f32."""
    from repro_torch.core.gs_sgd import make_train_step
    from repro_torch.optim import make as make_opt
    opt = make_opt("adamw", lr=TRAIN_LR)
    ex = {"spec": main_exchange()} if kw is None else kw
    return opt, make_train_step(cfg, ma, opt, dp_mode=dp_mode,
                                dtype=torch.float32, device=device, **ex)


def check_cell(tag, ts, want_d, want_buckets) -> None:
    if ts.d_local != want_d or tuple(ts.compressor.spec.sizes) != \
            want_buckets:
        fail(f"{tag}: d_local {ts.d_local}, buckets "
             f"{ts.compressor.spec.sizes}; not {want_d}, {want_buckets}")
    log(f"[{tag}] exchange groups (model rank, workers): "
        f"{[(r, list(range(*sl.indices(ts.nworkers)))) for r, sl in ts.comp_groups]}")


def dense_tp_check(torch, device, cfg) -> dict:
    """The dense exchange (psum) at tp = TP x data = TP_DATA and at tp = 1 x
    data = TP_DATA, three steps each from the same global params (padded
    alike at both degrees) and batches: losses within TP_DENSE_RTOL."""
    from repro_torch.core.gs_sgd import MeshAxes
    from repro_torch.data import LMStream
    from repro_torch.launch.train import shard_batch
    from repro_torch.models.common import init_params
    from repro_torch.models.flatten import shard_segs
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    glob = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                       TP, device=device)
    out = {}
    for tp in (TP, 1):
        ma = MeshAxes(tp=tp, data=TP_DATA, tp_axis="model" if tp > 1
                      else None)
        opt, ts = sharded_step(torch, device, cfg, ma,
                               kw={"compressor_name": None})
        params = (shard_segs(cfg, glob, tp, ts.fs)[1] if tp > 1
                  else ts.fs.flatten(glob))
        state = ts.state_from(params, opt)
        del params
        hist, times = [], []
        for s in range(TRAIN_STEPS):
            batch = shard_batch(stream.global_batch_at(s, device),
                                ts.nworkers)
            torch.cuda.synchronize()
            t0 = time.time()
            state, m = ts.fn(state, batch)
            hist.append(float(m["loss"]))
            times.append(time.time() - t0)
        out[tp] = {"losses": hist, "times": times}
        log(f"[train_tp] dense, tp = {tp} x data = {TP_DATA}: losses {hist} "
            f"step_s {[round(t, 4) for t in times]}")
        del state, ts
        torch.cuda.empty_cache()
    del glob
    torch.cuda.empty_cache()
    for s, (a, b) in enumerate(zip(out[TP]["losses"], out[1]["losses"])):
        if abs(a - b) > TP_DENSE_RTOL * max(1.0, abs(b)):
            fail(f"train_tp dense step {s}: tp = {TP} loss {a!r}, tp = 1 "
                 f"{b!r}, beyond rtol {TP_DENSE_RTOL}")
    log(f"[train_tp] dense tp = {TP} against tp = 1: losses within rtol "
        f"{TP_DENSE_RTOL} (max rel "
        f"{max(abs(a - b) / abs(b) for a, b in zip(out[TP]['losses'], out[1]['losses'])):.3e})")
    return out


def train_tp_phase(torch, device) -> dict:
    """qwen3-4b at its published widths, 2 layers, tp = TP x data =
    TP_DATA: three counted gs-SGD steps (one exchange a model rank; every
    bucket past 2^22: the decode route), the kernels at a rank's bucket
    shapes bit-equal to plain (route checks on rank 0's worker 0), then
    the dense exchange against tp = 1."""
    from repro_torch.configs.qwen3_4b import CONFIG
    from repro_torch.core.gs_sgd import MeshAxes
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    opt, ts = sharded_step(torch, device, cfg, MeshAxes(tp=TP, data=TP_DATA))
    check_cell("train_tp", ts, TP_D, TP_BUCKETS)
    with plain_calls() as plain, kept_recoveries() as kept:
        run = train_phase(torch, cfg, opt, ts, tag="train_tp")
    check_route("train_tp", run["counts"], plain,
                TP * TP_DATA * ts.n_buckets * TRAIN_STEPS)
    run["mesh_ref"] = mesh_ref(torch, ts, run, kept)
    del kept
    state, got = capture_step(torch, ts, run.pop("state"), run["stream"])
    del state
    torch.cuda.empty_cache()
    shapes = route_checks(torch, "train_tp", ts.compressor.parts, got,
                          timed=True)
    del ts
    torch.cuda.empty_cache()
    return {**run, "dense": dense_tp_check(torch, device, cfg),
            "shapes": shapes}


def fsdp_scatter_check(torch, cfg, opt, ts, stream) -> None:
    """One gs-SGD step from a fresh state: each worker's EF is then its
    packed gradient with the selected coordinates zeroed, so its
    ``cycles_s`` shard must be the sum over the worker's pod of every
    worker's full ``cycles_s`` gradient (its own rows, on the pod's
    shards concatenated), sliced to the worker's shard."""
    from repro_torch.launch.train import shard_batch
    from repro_torch.models import model as mdl
    from repro_torch.models.flatten import SEG_NAMES, packed_offsets
    from repro_torch.core.gs_sgd import local_seg_shapes
    P, D = ts.nworkers, FSDP_DATA
    state = ts.init_state(opt, torch.Generator(device=ts.device)
                          .manual_seed(0))
    batch = shard_batch(stream.global_batch_at(0, ts.device), P)
    shapes = local_seg_shapes(ts.fs, ts.ma, "fsdp")
    m = shapes["cycles_s"][-1]
    want = torch.empty((P,) + shapes["cycles_s"], device=ts.device)
    for a in range(0, P, D):
        full = {k: torch.cat([state["params"][k][w] for w in range(a, a + D)],
                             dim=-1) for k in SEG_NAMES}
        full["cycles_s"].requires_grad_()
        total = None
        for w in range(a, a + D):
            with torch.enable_grad():
                g, = torch.autograd.grad(
                    mdl.loss_fn(cfg, ts.fs, full,
                                {k: v[w] for k, v in batch.items()}),
                    [full["cycles_s"]])
            total = g if total is None else total + g
        for j in range(D):
            want[a + j] = total[..., j * m:(j + 1) * m]
        del full, total, g
    state, _ = ts.fn(state, batch)
    off = packed_offsets(shapes)["cycles_s"]
    n = math.prod(shapes["cycles_s"])
    worst, kept_n, exact = 0.0, 0, True
    for gi, (_, sl) in enumerate(ts.comp_groups):
        ef = torch.cat(list(state["ef"][gi]), dim=-1)[:, off:off + n]
        w_sl = want[sl].reshape(ef.shape)
        kept = ef != 0
        kept_n += int(kept.sum())
        diff = (ef[kept] - w_sl[kept]).abs()
        exact = exact and bool((diff == 0).all())
        worst = max(worst, float((diff / w_sl[kept].abs().clamp(
            min=1e-30)).max()))
    del state, want
    torch.cuda.empty_cache()
    if worst > FSDP_SCATTER_RTOL:
        fail(f"train_fsdp: the reduce-scattered cycles_s shard is off the "
             f"pod sum by {worst:.3e} (relative)")
    log(f"[train_fsdp] reduce-scatter: every worker's cycles_s shard "
        f"({n} coordinates; {kept_n} not selected, compared) equals the "
        f"sum over its pod of the workers' full gradients, sliced: max rel "
        f"{worst:.3e}, bit-equal {exact}")


def train_fsdp_phase(torch, device) -> dict:
    """yi-9b at its published widths, 2 layers, fsdp with pod = FSDP_POD x
    data = FSDP_DATA: three counted gs-SGD steps over the pod axis (one
    exchange a data shard; the decode route), route checks at a shard's
    bucket shapes, then the reduce-scatter check."""
    from repro_torch.configs.yi_9b import CONFIG
    from repro_torch.core.gs_sgd import MeshAxes
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    ma = MeshAxes(tp=1, data=FSDP_DATA, pod=FSDP_POD, tp_axis=None,
                  pod_axis="pod")
    opt, ts = sharded_step(torch, device, cfg, ma, dp_mode="fsdp")
    if ts.fs.total != FSDP_D:
        fail(f"train_fsdp: d {ts.fs.total}, not {FSDP_D}")
    check_cell("train_fsdp", ts, FSDP_D // FSDP_DATA, FSDP_BUCKETS)
    with plain_calls() as plain:
        run = train_phase(torch, cfg, opt, ts, tag="train_fsdp")
    check_route("train_fsdp", run["counts"], plain,
                ts.nworkers * ts.n_buckets * TRAIN_STEPS)
    state, got = capture_step(torch, ts, run.pop("state"), run["stream"])
    del state
    torch.cuda.empty_cache()
    shapes = route_checks(torch, "train_fsdp", ts.compressor.parts, got,
                          timed=True)
    fsdp_scatter_check(torch, cfg, opt, ts, run["stream"])
    del ts
    torch.cuda.empty_cache()
    return {**run, "shapes": shapes}


def interleave_exchange(buckets=INTERLEAVE_BUCKETS):
    """The main path's exchange at ``buckets`` with the chunked backward
    (INTERLEAVE_CHUNKS) and the fused encode."""
    return dataclasses.replace(main_exchange(), buckets=buckets,
                               bwd_chunks=INTERLEAVE_CHUNKS,
                               fuse_encode=True)


def sharded_build(torch, device, cfg, ma, dp_mode="dp"):
    """The ``build`` that ``interleave_phase`` takes, for a sharded cell."""
    def build(exchange):
        return (cfg,) + sharded_step(torch, device, cfg, ma, dp_mode,
                                     kw={"spec": exchange})
    return build


def train_tp_interleave_phase(torch, device) -> dict:
    """train_tp's cell (qwen3-4b widths, 2 layers, tp = TP x data =
    TP_DATA) through ``interleave_phase``."""
    from repro_torch.configs.qwen3_4b import CONFIG
    from repro_torch.core.gs_sgd import MeshAxes
    return interleave_phase(
        torch, device, "train_tp_interleave",
        sharded_build(torch, device, dataclasses.replace(CONFIG, n_layers=2),
                      MeshAxes(tp=TP, data=TP_DATA)))


def train_fsdp_interleave_phase(torch, device) -> dict:
    """train_fsdp's cell (yi-9b widths, 2 layers, fsdp at pod = FSDP_POD
    x data = FSDP_DATA) through ``interleave_phase``."""
    from repro_torch.configs.yi_9b import CONFIG
    from repro_torch.core.gs_sgd import MeshAxes
    return interleave_phase(
        torch, device, "train_fsdp_interleave",
        sharded_build(torch, device, dataclasses.replace(CONFIG, n_layers=2),
                      MeshAxes(tp=1, data=FSDP_DATA, pod=FSDP_POD,
                               tp_axis=None, pod_axis="pod"), "fsdp"))


def sharded_cell(torch, cfg, ma, dp_mode, kw, dev, opt_kw=None):
    """The smoke cell of ``cfg`` on mesh ``ma`` (simulated, or a process
    mesh's) on ``dev``: (train step, state, ``batch_at(step)``). Params
    drawn on the CPU (rank-stacked by ``shard_segs`` at tp > 1), batches
    of 2 rows a worker, seq 16; AdamW at TRAIN_LR (or ``opt_kw``), f32."""
    from repro_torch.core.gs_sgd import make_train_step
    from repro_torch.data import LMStream
    from repro_torch.models.common import init_params
    from repro_torch.models.flatten import make_flat_spec, shard_segs
    from repro_torch.optim import make as make_opt
    glob = init_params(cfg, torch.Generator().manual_seed(0), ma.tp)
    params = (shard_segs(cfg, glob, ma.tp)[1] if ma.tp > 1
              else make_flat_spec(cfg, 1).flatten(glob))
    opt = make_opt(**(opt_kw or {"name": "adamw", "lr": TRAIN_LR}))
    ts = make_train_step(cfg, ma, opt, dp_mode=dp_mode,
                         dtype=torch.float32, device=dev, **kw)
    state = ts.state_from({k: v.to(dev) for k, v in params.items()}, opt)
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=16,
                      global_batch=2 * ma.dp_size, seed=0)
    return ts, state, lambda s: ts.shard(stream.global_batch_at(s, dev))


def sharded_runs(torch, cfg, ma, dp_mode, kw, card="cuda", steps=3):
    """``card_cpu_runs`` of ``sharded_cell`` from the same params and
    batches on the CPU and on ``card``."""
    return card_cpu_runs(
        torch, lambda dev: sharded_cell(torch, cfg, ma, dp_mode, kw, dev),
        steps, card)


def parity_tp_phase(torch, card="cuda") -> dict:
    """Card against the CPU port at the sharded layouts' smoke configs
    (``hold_parity`` at TP_PARITY_RTOL): the nine archs of
    tests/test_tp.py at tp = 2 (dense, 3 steps, no kernel launched),
    qwen3-4b at tp = 2 x data = 2 and yi-9b in fsdp at pod = 2 x data = 2
    with gs-SGD (TP_PARITY_KW, 2 buckets; the scores route, a recovery a
    worker, model rank, bucket and step). Returns the gs-SGD runs' summed
    card launches."""
    from repro_torch.configs import SMOKES
    from repro_torch.core.gs_sgd import MeshAxes
    archs = ("qwen3-4b", "starcoder2-3b", "yi-9b", "minicpm-2b",
             "musicgen-large", "rwkv6-7b", "zamba2-2.7b",
             "qwen3-moe-235b-a22b", "llama-3.2-vision-11b")
    gs = dict(compressor_name="gs-sgd", compressor_kw=TP_PARITY_KW,
              buckets=2)
    runs = [(a, f"{a} tp=2 dense", MeshAxes(tp=2, data=1, data_axis=None),
             "dp", {"compressor_name": None}) for a in archs]
    runs += [("qwen3-4b", "qwen3-4b tp=2 x data=2 gs-SGD",
              MeshAxes(tp=2, data=2), "dp", gs),
             ("yi-9b", "yi-9b fsdp pod=2 x data=2 gs-SGD",
              MeshAxes(tp=1, data=2, pod=2, tp_axis=None, pod_axis="pod"),
              "fsdp", gs)]
    total: dict = {}
    worst = 0.0
    for arch, label, ma, mode, kw in runs:
        results, c = sharded_runs(torch, SMOKES[arch], ma, mode, kw,
                                  card=card)
        dense = kw is not gs
        worst = max(worst, hold_parity(torch, "parity_tp", label, results, c,
                                       rtol=TP_PARITY_RTOL,
                                       launched=() if dense else SCORES_ROUTE))
        if dense:
            if any(v for k, v in c.items() if k != "slab_overflows"):
                fail(f"parity_tp {label}: the dense run launched {c}")
            continue
        check_route(f"parity_tp {label}", c, {}, ma.dp_size * ma.tp * 2 * 3,
                    decode=False)
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    log(f"[parity_tp] {len(runs)} runs: losses within rtol {TP_PARITY_RTOL} "
        f"(max {worst:.3e}); selections equal every step")
    return total


class fp8_wire_check:
    """While open, every fp8 ``ShardCtx.psum_tp`` is held against the exact
    f32 sum of its ranks' shards: the error must stay within the wire's
    rounding bound, sum_r (FP8_ULP |x_r| + FP8_SUB amax_r / 448) plus the
    output cast's 2^-8 |sum| (and 2^-22 |x_r| for the f32 scaling),
    element by element. Returns {"calls",
    "worst"} (the largest error over its bound)."""

    def __enter__(self):
        import torch

        from repro_torch.models.common import ShardCtx
        self.cls, self.orig = ShardCtx, ShardCtx.psum_tp
        stats = {"calls": 0, "worst": 0.0}

        def checked(ctx, x, _f=self.orig):
            y = _f(ctx, x)
            if ctx.ranked and ctx.comm_dtype is not None \
                    and x.dtype != torch.float32:
                xf = x.to(torch.float32)
                amax = xf.abs().amax(dim=tuple(range(1, x.ndim)),
                                     keepdim=True)
                exact = xf.sum(0)
                bound = (((FP8_ULP + 2.0 ** -22) * xf.abs()
                          + FP8_SUB * amax / 448.0).sum(0)
                         + 2.0 ** -8 * exact.abs())   # + the f32 scaling
                ratio = float(((y[0].to(torch.float32) - exact).abs()
                               / bound.clamp(min=1e-30)).max())
                stats["calls"] += 1
                stats["worst"] = max(stats["worst"], ratio)
            return y

        self.cls.psum_tp = checked
        return stats

    def __exit__(self, *exc):
        self.cls.psum_tp = self.orig


def fp8_smoke_agreement(torch, device) -> float:
    """tests/test_perf_opts.py's cell on the card: qwen3-4b's smoke config
    at tp = 2, 4 prompts of 11 tokens, one decode step, bf16 activations;
    the fp8 wire's greedy tokens against the exact wire's."""
    from repro_torch.configs import SMOKES
    from repro_torch.core.gs_sgd import MeshAxes, make_serve_fns
    from repro_torch.models import model as mdl
    from repro_torch.models.common import init_params
    from repro_torch.models.flatten import shard_segs
    cfg = SMOKES["qwen3-4b"]
    _, segs = shard_segs(cfg, init_params(cfg, torch.Generator().manual_seed(
        0), TP), TP)
    segs = {k: v.to(device) for k, v in segs.items()}
    toks = torch.randint(0, cfg.vocab_size, (4, 12), generator=torch.Generator(
        ).manual_seed(1)).to(device)
    ma = MeshAxes(tp=TP, data=1, data_axis=None)
    ids = []
    for cd in (None, torch.float8_e4m3fn):
        pre, dec = make_serve_fns(cfg, ma, dtype=torch.bfloat16,
                                  comm_dtype=cd)
        cache = mdl.init_cache(cfg, 4, 16, torch.float32, device=device,
                               ctx=ma.ctx(torch.bfloat16, cd))
        _, cache = pre(segs, {"tokens": toks[:, :11]}, cache)
        ids.append(dec(segs, toks[:, 11:], 11, cache)[0][0])
    return float((ids[0] == ids[1]).float().mean())


def serve_tp_phase(torch, device) -> dict:
    """qwen3-4b at its published widths, all 36 layers (f32), through
    ``make_serve_fns`` at tp = 1 and tp = TP from the same global params:
    SERVE_TP_B prompts of SERVE_TP_LEN tokens, then SERVE_TP_STEPS decode
    steps fed tp = 1's greedy tokens. The prefill logits within
    SERVE_TP_ATOL, the decode ids equal but for near-ties, every rank's
    equal; then tp = TP in bf16 with the exact and the fp8 wire
    (``comm_dtype=torch.float8_e4m3fn``): every fp8 psum within its
    rounding bound (``fp8_wire_check``), the greedy agreement printed, and
    at tests/test_perf_opts.py's cell at least FP8_AGREEMENT (see its
    note). No sketch kernel launches."""
    from repro_torch.configs.qwen3_4b import CONFIG as cfg
    from repro_torch.core.gs_sgd import MeshAxes, make_serve_fns
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models import model as mdl
    from repro_torch.models.common import init_params
    from repro_torch.models.flatten import make_flat_spec, shard_segs
    glob = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                       TP, device=device)
    _, segs2 = shard_segs(cfg, glob, TP)
    segs1 = make_flat_spec(cfg, 1).flatten(glob)
    del glob
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_TP_B, SERVE_TP_LEN),
                            generator=gen, device=device)
    T = SERVE_TP_LEN + SERVE_TP_STEPS
    LAUNCHES.clear()
    out = {}

    def run(tag, tp, params, dtype, comm_dtype=None, feed=None):
        ma = MeshAxes(tp=tp, data=1, tp_axis="model" if tp > 1 else None,
                      data_axis=None)
        pre, dec = make_serve_fns(cfg, ma, dtype=dtype, comm_dtype=comm_dtype)
        cache = mdl.init_cache(cfg, SERVE_TP_B, T, dtype, device=device,
                               ctx=ma.ctx(dtype, comm_dtype))
        _sync(torch, device)
        t0 = time.time()
        logits, cache = pre(params, {"tokens": prompts}, cache)
        _sync(torch, device)
        t_pre = time.time() - t0
        tok = (logits if tp == 1 else logits.permute(1, 0, 2).reshape(
            SERVE_TP_B, -1)).argmax(-1).to(torch.int32)
        ids, inputs, times = [], [], []
        for t in range(SERVE_TP_STEPS):
            inputs.append(feed[t] if feed is not None else tok)
            x = inputs[-1][:, None]
            t0 = time.time()
            tok, cache = dec(params, x, SERVE_TP_LEN + t, cache)
            _sync(torch, device)
            times.append(time.time() - t0)
            if tp > 1:
                if not torch.equal(tok[0], tok[1:].amin(0)) or not \
                        torch.equal(tok[0], tok[1:].amax(0)):
                    fail(f"serve_tp {tag}: the ranks' ids differ at step {t}")
                tok = tok[0]
            ids.append(tok)
        log(f"[serve_tp] {tag}: prefill {SERVE_TP_B} x {SERVE_TP_LEN} tokens "
            f"{t_pre * 1e3:.1f} ms, decode step ms p50 "
            f"{sorted(times)[len(times) // 2] * 1e3:.1f} (min "
            f"{min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f})")
        out[tag] = {"prefill_ms": t_pre * 1e3,
                    "decode_ms": [t * 1e3 for t in times]}
        del cache
        return logits, ids, inputs

    logits1, ids1, in1 = run("tp=1 f32", 1, segs1, torch.float32)
    logits2, ids2, _ = run(f"tp={TP} f32", TP, segs2, torch.float32,
                           feed=in1)
    full2 = logits2.permute(1, 0, 2).reshape(logits1.shape)
    err = float((full2 - logits1).abs().max())
    if err > SERVE_TP_ATOL:
        fail(f"serve_tp: prefill logits tp = {TP} against tp = 1 differ by "
             f"{err:.3e} > {SERVE_TP_ATOL}")
    ties = check_near_ties("serve_tp", "prefill greedy ids",
                           full2.argmax(-1), logits1.argmax(-1),
                           top2_margin(torch, logits1))
    mism = sum(int((a != b).sum()) for a, b in zip(ids2, ids1))
    if mism:
        # a decode id that differs must sit on a near-tie of tp = 1's logits
        seq = torch.cat([prompts] + [i[:, None] for i in in1], dim=1)
        pre1, _ = make_serve_fns(cfg, MeshAxes(tp=1, data=1, tp_axis=None,
                                               data_axis=None),
                                 dtype=torch.float32)
        for t, (a, b) in enumerate(zip(ids2, ids1)):
            if torch.equal(a, b):
                continue
            cache = mdl.init_cache(cfg, SERVE_TP_B, T, torch.float32,
                                   device=device)
            lg, _ = pre1(segs1, {"tokens": seq[:, :SERVE_TP_LEN + t + 1]},
                         cache)
            ties += check_near_ties("serve_tp", f"decode step {t} ids", a,
                                    b, top2_margin(torch, lg))
    log(f"[serve_tp] tp = {TP} against tp = 1, {cfg.n_layers} layers f32: prefill "
        f"logits max abs diff {err:.3e} (<= {SERVE_TP_ATOL}); "
        f"{SERVE_TP_STEPS} decode steps x {SERVE_TP_B}: {mism} ids differ "
        f"({ties} near-ties within {SERVE_TIE_ATOL}); the ranks' ids equal")
    del segs1, logits1, logits2, full2
    torch.cuda.empty_cache()
    _, exact, in_exact = run(f"tp={TP} bf16 exact wire", TP, segs2,
                             torch.bfloat16)
    with fp8_wire_check() as wire:
        _, fp8, _ = run(f"tp={TP} bf16 fp8 wire", TP, segs2, torch.bfloat16,
                        comm_dtype=torch.float8_e4m3fn, feed=in_exact)
    if not wire["calls"] or wire["worst"] > 1.0:
        fail(f"serve_tp: an fp8 psum is off its exact sum beyond the "
             f"wire's rounding bound ({wire})")
    per_step = [float((a == b).float().mean()) for a, b in zip(fp8, exact)]
    agree = sum(per_step) / len(per_step)
    smoke = fp8_smoke_agreement(torch, device)
    if smoke < FP8_AGREEMENT:
        fail(f"serve_tp: fp8 wire greedy agreement {smoke:.3f} < "
             f"{FP8_AGREEMENT} at tests/test_perf_opts.py's cell")
    log(f"[serve_tp] fp8 wire (bf16, tp = {TP}): {wire['calls']} fp8 psums, "
        f"each within its rounding bound (worst {wire['worst']:.3f} of it); "
        f"greedy agreement with the exact wire at {cfg.n_layers} layers "
        f"{agree:.4f} over {SERVE_TP_STEPS} x {SERVE_TP_B} tokens (per step "
        f"{[round(a, 2) for a in per_step]}); at the smoke cell {smoke:.2f} "
        f"(>= {FP8_AGREEMENT})")
    counts = dict(LAUNCHES)
    if any(counts.values()):
        fail(f"serve_tp launched sketch kernels: {counts}")
    del segs2
    torch.cuda.empty_cache()
    return {"counts": counts, "times": out, "logits_err": err,
            "fp8_agreement": agree, "fp8_smoke_agreement": smoke,
            "fp8_wire": wire}



# ---------------------------------------------------------------------------
# The process mesh: one model rank and one worker a process
# ---------------------------------------------------------------------------

MESH_AXES = ("pod", "data", "model")
MESH_RTOL = 1e-6   # train_mesh_tp's witness against train_tp: the
#                    losses every step and the sampled state values within
#                    this relative bound (plus this absolute one)
# train_mesh_tp's witness (the train_tp cell with the rank-stacked kernels
# run one rank at a time, bit-equal to the mesh) against train_tp, whose
# kernels batch the ranks and so round otherwise; bounds stated from the
# H100's readings (PERF.md §6: at most 1,908 of 2,363,282 selected
# coordinates, 665 of 393,216 samples, 6.137e-4), each 5-12 times
# above them, while a wrong gradient or slice would move most selections
# and every sample
WITNESS_SEL_FRAC = 0.01     # coordinates selected in one run only, a step
WITNESS_STATE_FRAC = 0.01   # sampled state values beyond MESH_RTOL
WITNESS_STATE_ATOL = 3e-3   # TRAIN_STEPS AdamW steps of at most TRAIN_LR
MESH_SAMPLE = 65_536   # coordinates a tensor's fingerprint keeps
MESH_TIMEOUT_S = 600   # a collective that waits longer fails the phase


def fingerprint(torch, x) -> dict:
    """A tensor's bits in a few numbers: a weighted sum of its bit
    patterns (any flipped bit changes it), the same of its zero pattern
    (an EF's selected coordinates) and their count, and MESH_SAMPLE values
    at seeded positions (host copies)."""
    x = x.detach().contiguous().reshape(-1)
    bits = x.view(torch.int32 if x.element_size() == 4 else torch.int16)
    h = hz = nz = 0
    for a in range(0, x.numel(), 1 << 24):
        b = min(x.numel(), a + (1 << 24))
        w = (torch.arange(a, b, device=x.device, dtype=torch.int64)
             * 2654435761) % 2147483647 + 1
        h += int((bits[a:b].to(torch.int64) * w).sum())
        z = (x[a:b] == 0).to(torch.int64)
        hz += int((z * w).sum())
        nz += int(z.sum())
    gen = torch.Generator(device=x.device).manual_seed(1)
    idx = torch.randint(0, x.numel(), (MESH_SAMPLE,), generator=gen,
                        device=x.device)
    return {"n": x.numel(), "bits": h % 2 ** 64, "zeros": hz % 2 ** 64,
            "n_zero": nz, "sample": x[idx].float().cpu()}


def state_rows(ts, state, r: int, w: int) -> dict:
    """Model rank ``r``'s, worker ``w``'s params and EF buckets (on a
    process mesh the process's own: r = w = 0)."""
    ma = ts.ma
    rows = {k: v[r, w] if ma.tp > 1 else v[w]
            for k, v in state["params"].items()}
    ef, i = state["ef"], w
    if ts.comp_groups:
        g, i = ((0, 0) if ma.mesh is not None else (r, w)
                if ts.dp_mode == "dp" else
                (r * ma.data + w % ma.data, w // ma.data))
        ef = ef[g]
    for b, e in enumerate(ef if isinstance(ef, tuple) else (ef,)):
        rows[f"ef{b}"] = e[i]
    return rows


def state_prints(torch, ts, state) -> dict:
    """{(model rank, worker): {tensor: fingerprint}} of every rank and
    worker a simulated state holds (the process's own on a mesh)."""
    if ts.ma.mesh is not None:
        pm = ts.ma.mesh
        keys = [((pm.coord("model"), pm.worker()), (0, 0))]
    else:
        keys = [((r, w), (r, w)) for r in range(ts.ma.tp)
                for w in range(ts.nworkers)]
    return {key: {k: fingerprint(torch, v) for k, v in
                  state_rows(ts, state, *at).items()} for key, at in keys}


def compare_prints(tag, got: dict, want: dict) -> dict:
    """One process's fingerprints against the simulated rank's and
    worker's. Returns how many tensors are bit-equal, of how many, and
    over the others' samples the largest absolute difference and how many
    of how many sampled values differ by more than MESH_RTOL relative
    (and absolute)."""
    out = {"same": 0, "n": len(got), "max_abs": 0.0, "beyond": 0,
           "sampled": 0}
    for name, g in got.items():
        w = want[name]
        if g["n"] != w["n"]:
            fail(f"{tag} {name}: {g['n']} coordinates, the simulation "
                 f"{w['n']}")
        if g["bits"] == w["bits"]:
            out["same"] += 1
            continue
        d = (g["sample"] - w["sample"]).abs()
        out["max_abs"] = max(out["max_abs"], float(d.max()))
        out["beyond"] += int((d > MESH_RTOL * (1 + w["sample"].abs()))
                             .sum())
        out["sampled"] += d.numel()
    return out


def mesh_setup(torch, shape):
    """A spawned rank's mesh: TF32 off, as the parent; returns (the
    ProcessMesh, its MeshAxes, the rank's device)."""
    from repro_torch.launch.mesh import make_mesh, mesh_axes_of
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pm = make_mesh(shape, MESH_AXES)
    return pm, mesh_axes_of(pm), torch.device("cuda",
                                              torch.cuda.current_device())


def staged_spans(torch, ts, state, stream) -> dict:
    """One more step under a tracer: each ``allreduce/b{i}`` and
    ``recover/b{i}`` span's seconds and the ``stage/*`` copies' seconds
    inside it (the host staging of gloo's collectives)."""
    from repro_torch.obs.trace import Tracer
    tr = Tracer()
    with tr.activate():
        _, m = ts.fn(state, ts.shard(stream.global_batch_at(
            TRAIN_STEPS + 1, ts.device)))
        float(m["loss"])
    ev = [e for e in tr.events if e["ph"] == "X"]
    out = {}
    for e in ev:
        if e["name"].startswith(("allreduce/b", "recover/b")):
            inner = sum(s["dur"] for s in ev if s["name"].startswith(
                "stage/") and e["ts"] <= s["ts"]
                and s["ts"] + s["dur"] <= e["ts"] + e["dur"])
            out[e["name"]] = (e["dur"], inner)
    return out


def _mesh_cell(torch, cell, ma, device):
    """(cfg, opt, ts) of a mesh phase's cell on the axes ``ma``."""
    if cell == "train_mesh":
        return full_width_step(torch, device, ma=ma)
    if cell == "train_mesh_tree":
        return minicpm_step(torch, device, allreduce_mode="tree",
                            record=False, ma=ma)[:3]
    from repro_torch.configs.qwen3_4b import CONFIG
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    kw = ({"spec": interleave_exchange(2)}
          if cell == "train_mesh_tp_interleave" else None)
    return (cfg,) + sharded_step(torch, device, cfg, ma, kw=kw)


def mesh_train_body(rank, cell, shape):
    """A spawned rank of a mesh train phase: the cell's three counted
    steps (``train_phase``: counts zeroed before, read after, this
    process's peak) with every plain version counted, the state's
    fingerprints, the wire counter (``core.pgroup.WIRE``) over the
    counted steps, and one traced step's staged spans. ``cell``: one
    cell, or a tuple of cells run in turn on the one mesh (a list of
    results)."""
    import torch
    pm, ma, device = mesh_setup(torch, shape)
    if isinstance(cell, tuple):
        out = []
        for c in cell:
            out.append(_mesh_train_cell(torch, rank, c, pm, ma, device))
            torch.cuda.empty_cache()
        return out
    return _mesh_train_cell(torch, rank, cell, pm, ma, device)


def _mesh_train_cell(torch, rank, cell, pm, ma, device):
    from repro_torch.core import pgroup
    cfg, opt, ts = _mesh_cell(torch, cell, ma, device)
    before = dict(pgroup.WIRE)
    with plain_calls() as plain, kept_recoveries() as kept:
        run = train_phase(torch, cfg, opt, ts, tag=f"{cell} rank {rank}")
    wire = {k: v - before[k] for k, v in pgroup.WIRE.items()}
    kept = kept_host(kept)
    prints = state_prints(torch, ts, run["state"])
    spans = staged_spans(torch, ts, run["state"], run["stream"])
    return {"rank": rank, "coords": dict(pm.coords), "backend": pm.backend,
            "worker": pm.worker(), "losses": run["losses"], "times": run["times"],
            "peak": run["peak"], "counts": run["counts"],
            "plain": dict(plain), "prints": prints, "wire": wire,
            "spans": spans, "d_local": ts.d_local, "kept": kept,
            "buckets": list(ts.compressor.spec.sizes)}


def mesh_ref(torch, ts, run: dict, kept: dict) -> dict:
    """What a mesh phase holds its ranks to, from a simulated run of the
    cell (``train_phase``'s, under ``kept_recoveries``): its losses, every
    rank's and worker's fingerprints, the last step's kept recoveries of
    every model rank, the compressor's parts."""
    return {"losses": run["losses"],
            "prints": state_prints(torch, ts, run["state"]),
            "kept": kept_host(kept),
            "parts": ts.compressor.parts}


def kept_host(kept: dict) -> dict:
    """What ``kept_recoveries`` kept (every recovery's summed sketch and
    selected indices, in call order), on the host."""
    return {k: [t.cpu() for t in v] for k, v in kept.items()}


def selection_diffs(torch, got: dict, want: dict, nb: int, rank: int,
                    tp: int, interleaved: bool = False) -> list:
    """Each counted step's count of coordinates that one run selects and
    the other does not, over its ``nb`` buckets: ``got`` a run's kept
    recoveries of model rank ``rank`` (a process's: its buckets a step;
    or a simulation's, ``rank`` < 0: every model rank's buckets a step),
    ``want`` a simulation's of ``tp`` ranks: rank by rank, or with
    ``interleaved`` (one backward serving every rank's exchange) the
    ranks' recoveries of each position in turn."""
    per = nb if rank >= 0 else tp * nb
    steps = len(got["idx"]) // per
    if len(want["idx"]) != steps * tp * nb:
        fail(f"{len(got['idx'])} recoveries kept, the simulation "
             f"{len(want['idx'])}")
    out = []
    for s in range(steps):
        n = 0
        for r in ([rank] if rank >= 0 else range(tp)):
            for b in range(nb):
                a = got["idx"][s * per + (0 if rank >= 0 else r * nb) + b]
                w = want["idx"][(s * nb + b) * tp + r if interleaved
                                else (s * tp + r) * nb + b]
                n += int((~torch.isin(a, w)).sum()
                         + (~torch.isin(w, a)).sum())
        out.append(n)
    return out


def spawn_ranks(torch, body, world, *args) -> tuple[list, float]:
    """``body(rank, *args)`` in ``world`` processes sharing the card
    (``launch.mesh.spawn``: gloo, each collective staged through pinned
    host memory); the parent's cached blocks freed first. Returns the
    ranks' results and the wall seconds."""
    from repro_torch.launch.mesh import spawn, transport
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.time()
    log(f"[mesh] spawning {world} ranks on {torch.cuda.device_count()} "
        f"card(s): transport {transport(world, world)}")
    out = spawn(body, world, *args, device_type="cuda",
                timeout_s=MESH_TIMEOUT_S)
    return out, time.time() - t0


def hold_mesh_run(torch, tag, results, ref: dict, recoveries,
                  decode=True, exact=True, launches=None,
                  interleaved=False) -> dict:
    """Each rank of a mesh train phase against the one-process run ``ref``
    (``mesh_ref``): its route's kernels ``recoveries`` times in each
    process and no plain version called (or ``launches(who, counts,
    plain)`` checks them); every step's selections equal;
    ``exact``: the losses and every tensor of the final state bit-equal;
    else the first loss bit-equal, every loss within MESH_RTOL relative
    and no sampled value of the final state beyond MESH_RTOL (relative
    and absolute). Returns the launches summed over the processes."""
    total: dict = {}
    tp = max(r for r, _ in ref["prints"]) + 1
    for res in results:
        key = (res["coords"]["model"], res["worker"])
        who = f"{tag} rank {res['rank']} {res['coords']}"
        if launches is not None:
            launches(who, res["counts"], res["plain"])
        else:
            check_route(who, res["counts"], res["plain"], recoveries,
                        decode=decode)
        got, want = res["losses"], ref["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if (got != want if exact else got[0] != want[0] or rel > MESH_RTOL):
            fail(f"{who}: losses {got} against {want} (rel {rel:.3e})")
        sel = selection_diffs(torch, res["kept"], ref["kept"],
                              len(res["buckets"]), key[0], tp, interleaved)
        if any(sel):
            fail(f"{who}: coordinates selected in one run only, by step: "
                 f"{sel}")
        st = compare_prints(who, res["prints"][key], ref["prints"][key])
        if (st["same"] != st["n"] if exact else st["beyond"]):
            fail(f"{who}: final state {st['same']} of {st['n']} tensors "
                 f"bit-equal, the others' samples max abs diff "
                 f"{st['max_abs']:.3e}, {st['beyond']} of {st['sampled']} "
                 f"beyond {MESH_RTOL}")
        spans = " ".join(f"{k} {v[0] * 1e3:.2f} ms (staged "
                         f"{v[1] * 1e3:.2f})"
                         for k, v in sorted(res["spans"].items()))
        wire = res["wire"]
        log(f"[{tag}] rank {res['rank']} {res['coords']} ({res['backend']})"
            f": losses {got} bit-equal: {got == want} (max rel {rel:.3e}); "
            f"selections equal every step; final state: {st['same']} of "
            f"{st['n']} tensors bit-equal, the others' samples max abs diff "
            f"{st['max_abs']:.3e}, {st['beyond']} of {st['sampled']} beyond "
            f"{MESH_RTOL}; step_s {[round(t, 4) for t in res['times']]}; "
            f"peak {res['peak']} bytes ({res['peak'] / 2**30:.2f} GiB); "
            f"wire over the counted steps {wire['calls']} collectives, "
            f"{wire['bytes']} payload bytes; traced step: {spans}")
        for k, v in res["counts"].items():
            total[k] = total.get(k, 0) + v
    return total


def train_mesh_phase(torch, ref: dict) -> dict:
    """The ``train`` cell on 2 processes (data = 2): losses, params, EF and
    every step's selections bit-equal to ``train``'s (``ref``: its
    losses, fingerprints, kept recoveries; every sum is two-way)."""
    shape = (1, TRAIN_P, 1)
    results, wall = spawn_ranks(torch, mesh_train_body, TRAIN_P,
                                "train_mesh", shape)
    counts = hold_mesh_run(torch, "train_mesh", results, ref,
                           2 * TRAIN_STEPS)
    log(f"[train_mesh] {TRAIN_P} processes, d {results[0]['d_local']} in "
        f"buckets {results[0]['buckets']}; spawn to results {wall:.1f} s")
    return {"counts": counts, "results": results}


def train_mesh_tree_phase(torch, device) -> dict:
    """minicpm-2b's cell on the Alg. 1 tree at P = 4 processes against the
    simulated tree step from the same state and batches (run first here,
    its fingerprints kept, freed before the spawn): bit for bit (losses,
    selections, the final state)."""
    p = ELASTIC_P
    cfg, opt, ts, _, _ = minicpm_step(torch, device, p=p,
                                      allreduce_mode="tree", record=False)
    with kept_recoveries() as kept:
        run = train_phase(torch, cfg, opt, ts, tag="train_mesh_tree sim")
    ref = mesh_ref(torch, ts, run, kept)
    del run, ts, kept
    results, wall = spawn_ranks(torch, mesh_train_body, p,
                                "train_mesh_tree", (1, p, 1))
    counts = hold_mesh_run(torch, "train_mesh_tree", results, ref,
                           2 * TRAIN_STEPS, decode=False)
    log(f"[train_mesh_tree] {p} processes on the tree; spawn to results "
        f"{wall:.1f} s")
    return {"counts": counts, "results": results}


def hold_witness(torch, wit: dict, ref: dict) -> dict:
    """train_mesh_tp's witness (``per_rank_kernels``) against ``train_tp``
    (``ref``): the same arithmetic rounded per rank, so the losses within
    MESH_RTOL every step, each step's coordinates selected in one run only
    at most WITNESS_SEL_FRAC of the coordinates selected, and the final
    state of every model rank and worker at most WITNESS_STATE_FRAC of its
    sampled values beyond MESH_RTOL and none beyond WITNESS_STATE_ATOL."""
    got, want = wit["losses"], ref["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    tp = max(r for r, _ in ref["prints"]) + 1
    n_sel = tp * sum(p.k for p in ref["parts"])
    sel = selection_diffs(torch, wit["kept"], ref["kept"], len(ref["parts"]),
                          -1, tp)
    states = {key: compare_prints("train_mesh_tp witness", wit["prints"][key],
                                  ref["prints"][key])
              for key in ref["prints"]}
    log(f"[train_mesh_tp] witness (per-rank kernels, one process) against "
        f"train_tp: losses {got} / {want} (max rel {rel:.3e}); coordinates "
        f"selected in one run only by step {sel} of {n_sel}; final state by "
        f"(model rank, worker): " + "; ".join(
            f"{k}: {v['same']} of {v['n']} bit-equal, max abs "
            f"{v['max_abs']:.3e}, {v['beyond']} of {v['sampled']} beyond "
            f"{MESH_RTOL}" for k, v in sorted(states.items())))
    if rel > MESH_RTOL:
        fail(f"train_mesh_tp witness: losses {got} against train_tp's "
             f"{want} (rel {rel:.3e})")
    if max(sel) > WITNESS_SEL_FRAC * n_sel:
        fail(f"train_mesh_tp witness: {max(sel)} coordinates selected in "
             f"one run only, beyond {WITNESS_SEL_FRAC} of {n_sel}")
    for key, st in states.items():
        if (st["beyond"] > WITNESS_STATE_FRAC * max(st["sampled"], 1)
                or st["max_abs"] > WITNESS_STATE_ATOL):
            fail(f"train_mesh_tp witness {key}: final state max abs diff "
                 f"{st['max_abs']:.3e} (bound {WITNESS_STATE_ATOL}), "
                 f"{st['beyond']} of {st['sampled']} samples beyond "
                 f"{MESH_RTOL} (bound {WITNESS_STATE_FRAC})")
    return {"rel": rel, "sel": sel, "n_sel": n_sel, "states": states}


def train_mesh_tp_phase(torch, device, ref: dict) -> dict:
    """The ``train_tp`` cell on 4 processes (tp = 2 x data = 2), held bit
    for bit (losses, every step's selections, the final state) against
    its witness: ``train_tp``'s simulated step in one process with the
    rank-stacked kernels run one rank at a time (``per_rank_kernels``;
    run first, freed before the spawn), which is held against
    ``train_tp`` (``ref``) by ``hold_witness``. Then the same cell with
    the chunked backward and the fused interleave (buckets 2,
    INTERLEAVE_CHUNKS chunks: ``train_mesh_tp_interleave``), held bit for
    bit against its own witness (the simulated interleave under
    ``per_rank_kernels``), each process's launches the interleave's."""
    from repro_torch.configs.qwen3_4b import CONFIG
    from repro_torch.core.gs_sgd import MeshAxes
    from repro_torch.launch.mesh import per_rank_kernels
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    cells = {"train_mesh_tp": None,
             "train_mesh_tp_interleave": {"spec": interleave_exchange(2)}}
    out = {}
    for cell, kw in cells.items():
        opt, ts = sharded_step(torch, device, cfg,
                               MeshAxes(tp=TP, data=TP_DATA), kw=kw)
        with per_rank_kernels(TP), kept_recoveries() as kept:
            run = train_phase(torch, cfg, opt, ts, tag=f"{cell} witness")
        wit = mesh_ref(torch, ts, run, kept)
        del run, kept
        if kw is None:
            witness = hold_witness(torch, wit, ref)
            launches = None
        else:
            same = all(wit["prints"][key][t]["bits"]
                       == out["train_mesh_tp"]["wit"]["prints"][key][t]["bits"]
                       for key in wit["prints"] for t in wit["prints"][key])
            log(f"[{cell}] witness: losses {wit['losses']}; final state "
                f"bit-equal to train_mesh_tp's witness (no chunks): {same}")
            launches = (lambda who, c, p, ts=ts: check_interleave_launches(
                who, ts, c, p, one_process=True))
        out[cell] = {"wit": wit, "launches": launches}
        del ts
        torch.cuda.empty_cache()
    # both cells in one world, one after the other in each process
    results, wall = spawn_ranks(torch, mesh_train_body, TP * TP_DATA,
                                tuple(cells), (1, TP_DATA, TP))
    for i, (cell, kw) in enumerate(cells.items()):
        res = [r[i] for r in results]
        out[cell].update(results=res, counts=hold_mesh_run(
            torch, cell, res, out[cell]["wit"], 2 * TRAIN_STEPS,
            launches=out[cell]["launches"], interleaved=kw is not None))
    log(f"[train_mesh_tp] {TP * TP_DATA} processes, both cells; spawn to "
        f"results {wall:.1f} s")
    return {"counts": out["train_mesh_tp"]["counts"],
            "results": out["train_mesh_tp"]["results"],
            "interleave_counts": out["train_mesh_tp_interleave"]["counts"],
            "interleave_results": out["train_mesh_tp_interleave"]["results"],
            "witness": witness}


# parity_mesh: the CPU tests' smoke mesh runs (tests/test_torch_mesh.py),
# each process on the card against the CPU port's simulated run.
PARITY_MESH_CASES = {
    8: (("dense (2, 2, 2) sgdm", "qwen3-4b", (2, 2, 2), "dp",
         {"compressor_name": None},
         {"name": "sgdm", "lr": 5e-2, "momentum": 0.9}),),
    4: (("gs-SGD psum P = 4", "qwen3-4b", (1, 4, 1), "dp",
         dict(compressor_name="gs-sgd", compressor_kw=TP_PARITY_KW,
              buckets=2), None),
        ("gs-SGD tree P = 4", "qwen3-4b", (1, 4, 1), "dp",
         dict(compressor_name="gs-sgd", compressor_kw=dict(
             TP_PARITY_KW, allreduce_mode="tree"), buckets=2), None),
        ("fsdp pod = 2 x data = 2 gs-SGD", "yi-9b", (2, 2, 1), "fsdp",
         dict(compressor_name="gs-sgd", compressor_kw=TP_PARITY_KW,
              buckets=2), None)),
}
PARITY_SERVE_SHAPE = (1, 2, 2)   # serve at tp = 2 (both data workers serve)


def _sim_axes(shape):
    from repro_torch.core.gs_sgd import MeshAxes
    pod, data, tp = shape
    return MeshAxes(tp=tp, data=data, pod=pod, tp_axis="model",
                    data_axis="data", pod_axis="pod")


def _serve_smoke(torch, ma, dev, rank_of=None):
    """qwen3-4b smoke at tp = 2 through ``make_serve_fns``: prefill of 2
    prompts of 8 tokens, 2 decode steps; (logits, [ids]) of the held
    ranks (``rank_of``: the process's model rank on a mesh)."""
    from repro_torch.configs import SMOKES
    from repro_torch.core.gs_sgd import make_serve_fns
    from repro_torch.models import model as mdl
    from repro_torch.models.common import init_params
    from repro_torch.models.flatten import shard_segs
    cfg = SMOKES["qwen3-4b"]
    segs = shard_segs(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                       2), 2)[1]
    if rank_of is not None:
        segs = {k: v[rank_of:rank_of + 1] for k, v in segs.items()}
    segs = {k: v.to(dev) for k, v in segs.items()}
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    feed = [torch.randint(0, cfg.vocab_size, (2, 1), generator=gen)
            for _ in range(2)]
    pre, dec = make_serve_fns(cfg, ma, dtype=torch.float32)
    cache = mdl.init_cache(cfg, 2, 16, torch.float32, device=dev,
                           ctx=ma.ctx(torch.float32))
    logits, cache = pre(segs, {"tokens": toks.to(dev)}, cache)
    ids, kv = [], 8
    for t in feed:
        tok, cache = dec(segs, t.to(dev), kv, cache)
        ids.append(tok.cpu())
        kv += 1
    return logits.cpu(), ids


def parity_mesh_body(rank, world):
    """A spawned rank of parity_mesh: every case of its world (3 steps
    each, this process's losses and EF zero patterns, launches and plain
    calls), and in the 4-process world the serve case."""
    import torch
    from repro_torch.configs import SMOKES
    from repro_torch.kernels.dispatch import LAUNCHES
    out = []
    for label, arch, shape, mode, kw, opt_kw in PARITY_MESH_CASES[world]:
        pm, ma, dev = mesh_setup(torch, shape)
        ts, state, batch_at = sharded_cell(torch, SMOKES[arch], ma, mode,
                                           kw, dev, opt_kw)
        losses, sel = [], []
        with plain_calls() as plain:
            torch.cuda.synchronize()
            LAUNCHES.clear()
            for s in range(3):
                state, m = ts.fn(state, batch_at(s))
                losses.append(float(m["loss"]))
                sel.append({k: (v == 0).cpu() for k, v in state_rows(
                    ts, state, 0, 0).items() if k.startswith("ef")})
            torch.cuda.synchronize()
        out.append({"label": label, "coords": dict(pm.coords),
                    "worker": pm.worker(), "losses": losses, "sel": sel,
                    "counts": dict(LAUNCHES), "plain": dict(plain)})
    if world == 4:
        from repro_torch.core import pgroup
        pm, ma, dev = mesh_setup(torch, PARITY_SERVE_SHAPE)
        logits, ids = _serve_smoke(torch, ma, dev, pm.coord("model"))
        # the fp8 wire's payload crosses as its bytes
        ax = pm.axis("model")
        fp8 = pgroup.all_gather(torch.full((4,), rank + 0.5, device=dev)
                                .to(torch.float8_e4m3fn), ax)
        out.append({"label": "serve tp = 2", "coords": dict(pm.coords),
                    "logits": logits, "ids": ids, "fp8": fp8.float().cpu(),
                    "fp8_want": [r + 0.5 for r in ax.ranks]})
    return out


def parity_mesh_phase(torch) -> dict:
    """The CPU tests' smoke mesh runs, each process on the card against
    the CPU port's simulated run from the same params and batches: losses
    within TP_PARITY_RTOL and the rank's and worker's selections equal;
    serve at tp = 2: each rank's logits shard within SERVE_PARITY_ATOL,
    its ids equal. Returns the launches summed over processes and
    cases."""
    from repro_torch.configs import SMOKES
    total: dict = {}
    for world, cases in PARITY_MESH_CASES.items():
        results, wall = spawn_ranks(torch, parity_mesh_body, world, world)
        for i, (label, arch, shape, mode, kw, opt_kw) in enumerate(cases):
            ma = _sim_axes(shape)
            ts, state, batch_at = sharded_cell(torch, SMOKES[arch], ma, mode,
                                               kw, "cpu", opt_kw)
            losses, sels = [], []
            keys = [(r, w) for r in range(ma.tp) for w in range(ma.dp_size)]
            for s in range(3):
                state, m = ts.fn(state, batch_at(s))
                losses.append(float(m["loss"]))
                sels.append({key: {k: v == 0 for k, v in state_rows(
                    ts, state, *key).items() if k.startswith("ef")}
                    for key in keys})
            dense = kw.get("compressor_name") is None
            worst = 0.0
            for res in (rr[i] for rr in results):
                key = (res["coords"]["model"], res["worker"])
                who = f"parity_mesh {label} rank {res['coords']}"
                if not _close(losses, res["losses"], TP_PARITY_RTOL):
                    fail(f"{who}: card losses {res['losses']}, CPU "
                         f"{losses}")
                worst = max(worst, max(abs(a - b) / abs(a) for a, b in
                                       zip(losses, res["losses"])))
                for s, (got, want) in enumerate(zip(res["sel"], sels)):
                    for k, v in got.items():
                        if not torch.equal(v, want[key][k]):
                            fail(f"{who}: selected coordinates differ at "
                                 f"step {s} {k}")
                if res["plain"]:
                    fail(f"{who}: plain versions called {res['plain']}")
                if dense:
                    if any(res["counts"].values()):
                        fail(f"{who}: the dense run launched "
                             f"{res['counts']}")
                else:
                    check_route(who, res["counts"], {}, 2 * 3, decode=False)
                for k, v in res["counts"].items():
                    total[k] = total.get(k, 0) + v
            log(f"[parity_mesh] {label}: {world} processes, losses cpu "
                f"{losses}, card within rtol {TP_PARITY_RTOL} (max "
                f"{worst:.3e}); selections equal every step; spawn to "
                f"results {wall:.1f} s")
        if world == 4:
            logits, ids = _serve_smoke(torch, _sim_axes(PARITY_SERVE_SHAPE),
                                       "cpu")
            for res in (rr[-1] for rr in results):
                r = res["coords"]["model"]
                err = float((res["logits"][0] - logits[r]).abs().max())
                if err > SERVE_PARITY_ATOL:
                    fail(f"parity_mesh serve rank {res['coords']}: logits "
                         f"differ by {err}")
                for a, b in zip(res["ids"], ids):
                    if not torch.equal(a[0], b[r]):
                        fail(f"parity_mesh serve rank {res['coords']}: ids "
                             f"{a[0].tolist()} against {b[r].tolist()}")
                want = torch.tensor(res["fp8_want"])[:, None].expand(-1, 4)
                if not torch.equal(res["fp8"], want):
                    fail(f"parity_mesh rank {res['coords']}: fp8 all-gather "
                         f"{res['fp8'].tolist()}, not {want.tolist()}")
                log(f"[parity_mesh] serve tp = 2 rank {res['coords']}: "
                    f"logits within {err:.3e} (atol {SERVE_PARITY_ATOL}), "
                    "ids equal; the fp8 all-gather over 'model' exact")
    return total


# ---------------------------------------------------------------------------
# The dry-run at a production rank's shapes, and the long context
# ---------------------------------------------------------------------------

# (phase, arch, shape, mesh): one rank of the 256-rank ('single') or
# 512-rank ('multi') production mesh (launch/dryrun.py)
DRYRUN_CELLS = (("dryrun_train", "qwen3-4b", "train_4k", "single"),
                ("dryrun_fsdp", "yi-9b", "train_4k", "multi"),
                ("dryrun_serve", "qwen3-4b", "prefill_32k", "single"),
                ("dryrun_serve", "qwen3-4b", "decode_32k", "single"))
# The exchange's group of a train cell: the dp axes in 'dp', the pod in
# 'fsdp' (core/gs_sgd.py)
DRYRUN_EXCHANGE = {("dp", "single"): "data", ("dp", "multi"): "pod+data",
                   ("fsdp", "multi"): "pod"}
LONG_SEQ = 4_096
LONG_LAYERS = 4         # the remat's two groups of two cycles
LONG_ATTN_ATOL = 1e-6   # the chunked attention (4 KV chunks) against the
#                         one-pass (one chunk) in f32 at S = T = LONG_SEQ,
#                         stated before the first reading (the reference
#                         measured 2.9e-7 at S = T = 2,304)


class last_encode:
    """While open, ``GsSGD.stage_encode`` also keeps, from its first call
    only, a host copy of worker 0's packed vector u (the encode's input)
    and of the f32 sketch the step made of it, and the compressor: a
    dry-run's warm-up step, so the measured step's memory and time are
    untouched. Returns the dict {"part", "u", "sk"}."""

    def __enter__(self):
        from repro_torch.core import compression as comp
        self.cls, got = comp.GsSGD, {}
        self.saved = self.cls.stage_encode

        def kept(part, *a, **kw):
            u, sk = self.saved(part, *a, **kw)
            if not got:
                got.update(part=part, u=u[0].cpu(), sk=sk[0].float().cpu())
            return u, sk

        self.cls.stage_encode = kept
        return got

    def __exit__(self, *exc):
        self.cls.stage_encode = self.saved


def dryrun_phases(torch) -> dict:
    """dryrun_train, dryrun_fsdp, dryrun_serve (DRYRUN_CELLS): each cell
    through ``launch.dryrun.run_cell`` on the card (its JSON under
    build/dryrun_torch/ and on one line here). Returns phase -> {"counts"
    (the measured steps' launches, summed), "records", "shapes" (the
    kernels timed at dryrun_train's shapes)}."""
    from repro_torch.launch import dryrun
    out: dict = {}
    out_dir = os.path.join(ROOT, "build", "dryrun_torch")
    for tag, arch, shape, mesh in DRYRUN_CELLS:
        t0 = time.time()
        torch.cuda.empty_cache()
        with plain_calls() as plain, last_encode() as enc:
            r = dryrun.run_cell(arch, shape, mesh, device="cuda",
                                out_dir=out_dir)
        log(f"[{tag}] {json.dumps(r)}")
        mem, counts = r["memory"], r["launches"]
        if not (r["status"] == "ok" and mem["peak_bytes"]
                > mem["argument_bytes"] and r["cost"]["flops"] > 0
                and r["outputs_finite"]):
            fail(f"{tag} {arch} x {shape} x {mesh}: status {r['status']}, "
                 f"peak {mem['peak_bytes']} against arguments "
                 f"{mem['argument_bytes']}, flops {r['cost']['flops']}, "
                 f"outputs finite {r['outputs_finite']}")
        slot = out.setdefault(tag, {"counts": {}, "records": [],
                                    "shapes": {}})
        slot["records"].append(r)
        for k, v in counts.items():
            slot["counts"][k] = slot["counts"].get(k, 0) + v
        if shape == "train_4k":
            check_route(tag, counts, plain, 1)
            part = enc["part"]
            want = part.sketch.rows * part.sketch.width * 4 + part.k * 4
            ex = r["collectives"]["per_axis"][
                DRYRUN_EXCHANGE[(r["dp_mode"], mesh)]]["all-reduce"]
            if (ex["count"], ex["result_bytes"]) != (2, want):
                fail(f"{tag}: the exchange's all-reduces {ex} are not the "
                     f"summed sketch and the k values ({want} bytes)")
            if tag == "dryrun_train":
                got = {0: (enc["u"].cuda(), enc["sk"].cuda())}
                slot["shapes"] = route_checks(torch, tag, [part], got,
                                              timed=True)
        elif counts or plain:
            fail(f"{tag}: the serve step launched {counts} and called "
                 f"{plain}: no kernel of the sketch path may run")
        del enc
        peak = mem["peak_bytes"] / 2**30
        log(f"[{tag}] {arch} x {shape} x {mesh}: step "
            f"{r['step_seconds']:.4f} s, loss {r['loss']!r}, outputs "
            f"finite, peak {peak:.2f} GiB, arguments "
            f"{mem['argument_bytes'] / 2**30:.2f} GiB, flops "
            f"{r['cost']['flops']:.4e}, wire "
            f"{r['collectives']['total_wire_bytes'] / 2**30:.2f} GiB "
            f"(counted as executed); cell took {time.time() - t0:.1f} s")
    return out


def long_context_phase(torch, device, train_run: dict) -> dict:
    """long_context (the docstring's phase 13); ``train_run``: the train
    phase's losses, step seconds and peak."""
    from repro_torch.configs.qwen3_4b import CONFIG
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models import layers, model as mdl
    from repro_torch.models.flatten import make_flat_spec
    LAUNCHES.clear()
    gen = torch.Generator(device).manual_seed(0)
    B, S, hd = 1, LONG_SEQ, CONFIG.hd
    q = torch.randn((B, S, CONFIG.n_heads, hd), generator=gen, device=device)
    k = torch.randn((B, S, CONFIG.n_kv_heads, hd), generator=gen,
                    device=device)
    v = torch.randn((B, S, CONFIG.n_kv_heads, hd), generator=gen,
                    device=device)
    pos = torch.arange(S, device=device)[None]
    chunked = layers.blockwise_attention(q, k, v, causal=True, q_pos=pos,
                                         kv_pos=pos)
    one = layers.blockwise_attention(q, k, v, causal=True, q_pos=pos,
                                     kv_pos=pos, chunk=S)
    err = float((chunked - one).abs().max())
    if not err <= LONG_ATTN_ATOL:
        fail(f"long_context: the chunked attention at S = T = {S} is "
             f"{err:.3e} from the one-pass (bound {LONG_ATTN_ATOL})")
    log(f"[long_context] attention at S = T = {S}, {CONFIG.n_heads}/"
        f"{CONFIG.n_kv_heads} heads, f32: chunked ({S // 1024} KV chunks) "
        f"against one chunk max abs {err:.3e} (bound {LONG_ATTN_ATOL})")
    del q, k, v, chunked, one
    from repro_torch.core import pgroup
    moved = {}
    for p in (2, 3, 4, 16):
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn((p, 1 << 20), generator=gen, device=device)
                 * 1e3).to(dt)
            moved[f"{p} {str(dt)[6:]}"] = int((x.sum(0)
                                              != pgroup.fold_sum(x)).sum())
    log(f"[long_context] torch's sum(0) against the left fold "
        f"(pgroup.fold_sum) on the card, coordinates of 2^20 that differ, "
        f"by rows and dtype: {moved}")
    del x
    cfg = dataclasses.replace(CONFIG, n_layers=LONG_LAYERS)
    fs = make_flat_spec(cfg, 1)
    segs = {n: torch.randn(sh, generator=gen, device=device).mul_(0.02)
            for n, sh in fs.seg_shapes().items()}
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=device)
    runs = {}
    for remat in (True, False):
        use = {n: t.detach().clone().requires_grad_()
               for n, t in segs.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        loss = mdl.loss_fn(cfg, fs, use, {"tokens": toks, "labels": toks},
                           dtype=torch.bfloat16, remat=remat)
        loss.backward()
        torch.cuda.synchronize()
        runs[remat] = (loss.detach(), {n: t.grad for n, t in use.items()},
                       torch.cuda.max_memory_allocated() - base,
                       time.time() - t0)
        del use, loss
    (l1, g1, p1, t1), (l0, g0, p0, t0_) = runs[True], runs[False]
    same = {n: torch.equal(g1[n], g0[n]) for n in g1}
    log(f"[long_context] qwen3-4b widths, {LONG_LAYERS} layers, seq {S}, "
        f"bf16: loss remat on {float(l1)!r} off {float(l0)!r}, bit-equal "
        f"{torch.equal(l1, l0)}; segment gradients bit-equal {same}; peak "
        f"above the inputs on {p1 / 2**30:.2f} GiB, off {p0 / 2**30:.2f} "
        f"GiB; seconds on {t1:.3f} off {t0_:.3f} (first calls)")
    if not (torch.equal(l1, l0) and all(same.values())):
        fail("long_context: the remat changed the loss or a gradient")
    del runs, segs, g1, g0
    torch.cuda.empty_cache()
    counts = dict(LAUNCHES)
    if counts:
        fail(f"long_context launched sketch kernels: {counts}")
    cfg2, opt, ts = full_width_step(torch, device, remat=False)
    with plain_calls() as plain:
        run = train_phase(torch, cfg2, opt, ts, tag="train_noremat")
    check_route("train_noremat", run["counts"], plain,
                TRAIN_P * ts.n_buckets * TRAIN_STEPS)
    if run["losses"] != train_run["losses"]:
        fail(f"train_noremat: losses {run['losses']} differ from train's "
             f"{train_run['losses']} (remat on)")
    steady = [[round(t, 4) for t in r["times"][1:]] for r in (train_run,
                                                               run)]
    log(f"[long_context] train (remat on) against train_noremat: losses "
        f"bit-equal; steady step_s on {steady[0]} off {steady[1]}; peak on "
        f"{train_run['peak'] / 2**30:.2f} GiB off "
        f"{run['peak'] / 2**30:.2f} GiB")
    del run, ts
    torch.cuda.empty_cache()
    return {"counts": counts}


# Phases 14-18: the roofline scripts, the audits, the host
# benches and the examples (the docstring's phases 14-18).
ROOFLINE_ENCODES = ((1 << 22, 5, 1 << 14),      # measure_encode's default
                    (388_956_160, 5, 1 << 14))  # train's bucket 0 d
OVERLAP_SIM_ARGV = ("--p", "4", "--d", "1000000", "--method", "gs-sgd",
                    "--buckets", "4", "--bwd-chunks", "2", "--steps", "4",
                    "--compute-jitter", "0")
OVERLAP_TOLERANCE = 0.5
LM_E2E_STEPS = (30, 40)     # train_lm_e2e: 30 steps, then resumed to 40


def quiet(fn, path):
    """``fn()`` with its standard output written to ``path``, not the log
    (a bench's full table); returns (fn's result, the text)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(buf.getvalue())
    return out, buf.getvalue()


def roofline_phase(torch, device, dry: dict) -> dict:
    """roofline (the docstring's phase 14): ``bench.roofline.main`` for
    both meshes fed the dry-run phases' records (build/dryrun_torch/),
    every row finite and the dry-run's cells joined with their peaks;
    dryrun_train's row beside its record; ``measure_encode`` on the card
    at ROOFLINE_ENCODES, whole and fused bit-equal (and equal to the plain
    encode at the first size), counted. Returns {"counts"}."""
    from repro_torch.bench import roofline
    from repro_torch.core.count_sketch import SketchConfig
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.kernels.sketch_encode import sketch_encode_plain
    dry_dir = os.path.join(ROOT, "build", "dryrun_torch")
    out_dir = os.path.join(ROOT, "build", "roofline_torch")
    rows = {}
    for mesh in ("single", "multi"):
        got, _ = quiet(lambda: roofline.main(
            ["--mesh", mesh, "--dryrun-dir", dry_dir, "--out-dir",
             out_dir]), os.path.join(out_dir, f"{mesh}.txt"))
        bad = roofline.check_rows(got)
        if len(got) != 32 or bad:
            fail(f"roofline {mesh}: {len(got)} rows; {bad}")
        rows.update({(r["arch"], r["shape"], mesh): r for r in got})
    for tag, arch, shape, mesh in DRYRUN_CELLS:
        r = rows.get((arch, shape, mesh))
        if r is None or r["peak_bytes_dev"] is None or not r["dryrun_flops"]:
            fail(f"roofline: {tag}'s cell {arch} x {shape} x {mesh} has no "
                 f"row joined with its dry-run record: {r}")
        log(f"[roofline] {arch} x {shape} x {mesh}: compute "
            f"{r['t_compute_s']:.4f} s, memory {r['t_memory_s']:.4f} s, "
            f"collective {r['t_collective_s']:.4f} s ({r['dominant']}); "
            f"bound {r['step_time_bound_s']:.4f} s, roofline_fraction "
            f"{r['roofline_fraction']:.4f}; peak "
            f"{r['peak_bytes_dev'] / 2**30:.2f} GiB")
    r = rows[("qwen3-4b", "train_4k", "single")]
    rec = dry["dryrun_train"]["records"][0]
    log(f"[roofline] dryrun_train beside its record: FLOPs analytic "
        f"{r['flops']:.4e} against executed {rec['cost']['flops']:.4e} "
        f"(executed / analytic {rec['cost']['flops'] / r['flops']:.3f}); "
        f"HBM bytes {r['hbm_bytes']:.4e}, wire bytes model "
        f"{r['coll_bytes_model']:.4e} data {r['coll_bytes_data']:.4e}; step "
        f"bound {r['step_time_bound_s']:.4f} s ({r['dominant']}) against "
        f"the measured step {rec['step_seconds']:.4f} s (the device alone, "
        "a fake world's collectives); the compute term "
        f"{r['t_compute_s']:.4f} s is "
        f"{r['t_compute_s'] / rec['step_seconds'] * 100:.2f}% of it")
    LAUNCHES.clear()
    for i, (d, rows_, width) in enumerate(ROOFLINE_ENCODES):
        m = roofline.measure_encode(d=d, rows=rows_, width=width,
                                    device=device)
        whole, fused = m.pop("sketches")
        if not m["bit_equal"]:
            fail(f"roofline: measure_encode at d {d}: whole and fused "
                 "sketches differ")
        if i == 0:
            gen = torch.Generator(device).manual_seed(0)
            g = torch.randn((d,), generator=gen, device=device)
            plain = sketch_encode_plain(
                SketchConfig(rows=rows_, width=width, seed=0), g)
            if not (_bits_equal(torch, whole, plain)
                    and _bits_equal(torch, fused, plain)):
                fail(f"roofline: measure_encode at d {d} is not bit-equal "
                     "to sketch_encode_plain")
            del g, plain
        log(f"[roofline] measure_encode d {d:,}, R {rows_}, W {width:,}: "
            f"whole {m['encode_s'] * 1e3:.3f} ms = "
            f"{m['measured_Bps'] / 1e9:.2f} GB/s "
            f"({m['hbm_fraction'] * 100:.2f}% of 3.35 TB/s), fused "
            f"({m['fragments']} fragments + one finish) "
            f"{m['fused_encode_s'] * 1e3:.3f} ms = "
            f"{m['fused_measured_Bps'] / 1e9:.2f} GB/s "
            f"({m['fused_hbm_fraction'] * 100:.2f}%); bit-equal"
            + (" to each other and to plain" if i == 0 else ""))
        del whole, fused
    counts = dict(LAUNCHES)
    check_launches("roofline measure_encode", counts,
                   ("sketch_encode", "sketch_encode_finish"),
                   ("sketch_decode", "heavymix_scores", "topk_select"))
    return {"counts": counts}


def perf_iterations_phase() -> None:
    """perf_iterations (phase 15): ``bench.perf_iterations.main`` on the
    host, its three climbs printed."""
    from repro_torch.bench import perf_iterations
    out = perf_iterations.main(["--out", os.path.join(ROOT, "build",
                                                      "bench_torch")])
    if len(out) != 4:
        fail(f"perf_iterations: {len(out)} climbs")


def traced_interleave(torch, device, tag, ts, opt, exchange, path):
    """A traced 3-step run of an interleave cell through
    ``launch.train.drive`` (the probe included), counted; its trace
    saved to ``path``. Returns the launch counts."""
    from repro_torch import obs
    from repro_torch.kernels.dispatch import LAUNCHES
    spec = cell_spec(ts, exchange)
    tracer = obs.Tracer()
    with plain_calls() as plain:
        LAUNCHES.clear()
        run = drive_cell(torch, ts, opt, spec, range(TRAIN_STEPS),
                         tracer=tracer)
        counts = dict(LAUNCHES)
    del run["state"]
    tracer.save(path, spec=spec, provenance=obs.provenance(spec, device),
                source="train")
    if plain:
        fail(f"overlap_audit: plain versions called on the card: {plain}")
    for name, cnt in step_launches(ts).items():
        if counts.get(name, 0) != cnt * (TRAIN_STEPS + 1):
            fail(f"overlap_audit {tag}: {name} launched "
                 f"{counts.get(name, 0)} times, not "
                 f"{cnt * (TRAIN_STEPS + 1)} ({TRAIN_STEPS} steps and the "
                 "probe)")
    log(f"[overlap_audit] {tag} traced: losses {run['history']}, "
        f"steps {[round(t, 4) for t in run['times']]} s; launches {counts}")
    return counts


def plan_schedule(path, ts) -> dict:
    """The readiness recurrence (``compression.interleaved_schedule_time``)
    on a traced interleave's own stage times per probe (each bucket's
    encode spans, fused partials included, and all-reduce spans, every
    exchange group's summed), each bucket ready when the step's plan
    says (``ts.plan.readiness``, event e at (e + 1) / K of the backward;
    the top's event with the last chunk): what a second stream could
    hide of it. ``bench.overlap_audit``'s own schedule takes the
    simulator's readiness model of a flat d instead."""
    from repro_torch.core import compression as comp
    from repro_torch.obs import trace as obtrace
    from repro_torch.sim import replay
    doc = obtrace.load(path)
    n = max(1, len(obtrace.spans(doc, cat="probe")))
    t_enc = [t / n for t in obtrace.bucket_durations(doc, "encode",
                                                     "encode/b")]
    t_comm = [t / n for t in obtrace.bucket_durations(doc, "comm",
                                                      "allreduce/b")]
    t_bwd = obtrace.phase_totals(doc).get("backward", 0.0) / n
    k = len(ts.plan.chunks)
    ev_t = replay.event_times(t_bwd, k)
    ready = [ev_t[min(e, k - 1)] for e in ts.plan.readiness]
    serial, pipelined, exposed, _ = comp.interleaved_schedule_time(
        t_enc, t_comm, ready, t_backward=t_bwd)
    return {"t_backward": t_bwd, "t_encode": t_enc, "t_comm": t_comm,
            "readiness": list(ts.plan.readiness), "serial": serial,
            "pipelined": pipelined, "exposed": exposed,
            "hideable": serial - pipelined,
            "hideable_frac": (serial - pipelined) / serial if serial else None}


def overlap_audit_phase(torch, device) -> dict:
    """overlap_audit (phase 16): ``bench.overlap_audit`` of the
    train_traced phase's trace, of traced 3-step runs of
    train_interleave's cell (buckets 4, 2 backward chunks, fused encode)
    and of train_tp_interleave's (the same exchange at tp = 2 x data = 2)
    through ``launch.train.drive``, counted, and of a jitter-free
    simulator trace, which must pass ``check`` at OVERLAP_TOLERANCE.
    Returns {"counts", "counts_tp"}."""
    from repro_torch.bench import overlap_audit
    from repro_torch.configs.qwen3_4b import CONFIG
    from repro_torch.core.gs_sgd import MeshAxes
    from repro_torch.launch.simulate import main as simulate
    build = os.path.join(ROOT, "build")
    paths = [os.path.join(build, "train_traced_trace.json"),
             os.path.join(build, "overlap_interleave_trace.json"),
             os.path.join(build, "overlap_tp_interleave_trace.json"),
             os.path.join(build, "overlap_sim_trace.json")]
    exchange = interleave_exchange()
    _, opt, ts = full_width_step(torch, device, exchange=exchange)
    counts = traced_interleave(torch, device, "interleave cell", ts, opt,
                               exchange, paths[1])
    sched = {"interleave": plan_schedule(paths[1], ts)}
    del ts
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    opt, ts = sharded_step(torch, device, cfg, MeshAxes(tp=TP, data=TP_DATA),
                           kw={"spec": exchange})
    counts_tp = traced_interleave(torch, device, "train_tp_interleave cell",
                                  ts, opt, exchange, paths[2])
    sched["tp_interleave"] = plan_schedule(paths[2], ts)
    del ts
    for tag, sc in sched.items():
        log(f"[overlap_audit] {tag}: the plan's readiness "
            f"{sc['readiness']} on the probe's stage times (backward "
            f"{sc['t_backward'] * 1e3:.2f} ms; encode "
            f"{[round(t * 1e3, 2) for t in sc['t_encode']]} ms; all-reduce "
            f"{[round(t * 1e3, 3) for t in sc['t_comm']]} ms): serial "
            f"{sc['serial'] * 1e3:.2f} ms, pipelined "
            f"{sc['pipelined'] * 1e3:.2f} ms; a second stream could hide "
            f"{sc['hideable'] * 1e3:.2f} ms ({sc['hideable_frac']:.1%})")
    torch.cuda.empty_cache()
    quiet(lambda: simulate(list(OVERLAP_SIM_ARGV) + ["--trace", paths[3]]),
          os.path.join(build, "overlap_sim.txt"))
    try:
        res = overlap_audit.main(paths + [
            "--tolerance", str(OVERLAP_TOLERANCE), "--out",
            os.path.join(build, "bench_torch", "BENCH_obs.json")])
    except SystemExit as e:
        fail(f"overlap_audit: the simulator trace failed its check ({e})")
    audits = res["audits"]
    if [a["source"] for a in audits] != ["train", "train", "train", "sim"]:
        fail(f"overlap_audit: sources {[a['source'] for a in audits]}")
    for a in audits:
        name = os.path.basename(a["trace"])
        log(f"[overlap_audit] {name}: phase deltas (measured - predicted, "
            "s a step unit) " + json.dumps(
                {ph: round(d["delta"], 6) for ph, d in
                 a["phase_deltas"].items()})
            + f"; realization ratio {a['realization_ratio']!r}; measured "
            f"step {a['measured']['step_time']!r} s, scheduled "
            f"{a['scheduled_step']!r}, serial {a['serial_step']!r}; "
            "measured-stage schedule " + json.dumps(
                {k: v for k, v in (a["measured_schedule"] or {}).items()
                 if k in ("t_backward", "serial", "pipelined", "saving",
                          "saving_frac")}))
    return {"counts": counts, "counts_tp": counts_tp, "schedules": sched}


def bench_host_phase() -> None:
    """bench_host (phase 17): ``bench.drift_audit``, ``sim_sweep``,
    ``sim_scale`` and ``tune_sweep`` with ``--fast`` on the host (their
    JSON under build/bench_torch/); a nonzero exit or a failed assertion
    fails."""
    from repro_torch.bench import drift_audit, sim_scale, sim_sweep, \
        tune_sweep
    out = os.path.join(ROOT, "build", "bench_torch")
    benches = (
        ("drift_audit", lambda: drift_audit.main(
            ["--fast", "--out", os.path.join(out, "BENCH_drift.json")])),
        ("sim_sweep", lambda: sim_sweep.main(["--fast", "--out", out])),
        ("sim_scale", lambda: sim_scale.main(["--fast", "--out", out])),
        ("tune_sweep", lambda: tune_sweep.main(["--fast", "--out", out])))
    secs = {}
    for name, fn in benches:
        t0 = time.time()
        try:
            rc = fn()
        except AssertionError as e:
            fail(f"bench_host: {name} failed its assertion: {e}")
        if isinstance(rc, int) and rc != 0:
            fail(f"bench_host: {name} exited {rc}")
        secs[name] = time.time() - t0
    log(f"[bench_host] all passed; host seconds "
        + json.dumps({k: round(v, 2) for k, v in secs.items()}))


def examples_phase(torch, device) -> dict:
    """examples (phase 18): the four ``repro_torch.examples`` on the card,
    each counted on its own: quickstart (16 of 16 planted coordinates
    recovered, replica divergence 0), fault_tolerant_training (P = 5 -> 4,
    the drop step, replicas equal), serve_batched (every request
    finishes; no sketch kernel), train_lm_e2e (LM_E2E_STEPS: a run, then
    a --resume from its checkpoint under build/ that starts where it
    stopped; finite losses). Returns {"counts": example -> launches}."""
    import shutil

    from repro_torch.examples import (fault_tolerant_training, quickstart,
                                      serve_batched, train_lm_e2e)
    from repro_torch.kernels.dispatch import LAUNCHES
    ckpt = os.path.join(ROOT, "build", "lm_e2e_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    first, last = LM_E2E_STEPS
    scores = ("sketch_encode", "sketch_encode_finish", "heavymix_scores",
              "topk_select")
    decode = ("sketch_encode", "sketch_encode_finish", "sketch_decode",
              "topk_select")
    dev = ["--device", str(device)]
    runs = (
        ("quickstart", lambda: quickstart.main(dev), scores),
        ("fault_tolerant_training",
         lambda: fault_tolerant_training.main(dev), scores),
        ("serve_batched", lambda: serve_batched.main(dev), ()),
        ("train_lm_e2e", lambda: [
            train_lm_e2e.main(dev + ["--steps", str(first), "--ckpt-dir",
                                     ckpt]),
            train_lm_e2e.main(dev + ["--steps", str(last), "--resume",
                                     "--ckpt-dir", ckpt])], decode))
    counts, outs = {}, {}
    for name, fn, route in runs:
        t0 = time.time()
        with plain_calls() as plain:
            _sync(torch, device)
            LAUNCHES.clear()
            outs[name] = fn()
            _sync(torch, device)
            counts[name] = dict(LAUNCHES)
        if plain:
            fail(f"examples: {name} called plain versions on the card: "
                 f"{plain}")
        if route:
            check_launches(f"examples {name}", counts[name], route)
        elif counts[name]:
            fail(f"examples: {name} launched {counts[name]}")
        log(f"[examples] {name}: {time.time() - t0:.1f} s, launches "
            f"{counts[name]}")
    q = outs["quickstart"]
    if (q["sketch"]["recovered"], q["sketch"]["k"]) != (16, 16) or \
            q["train"]["divergence"] != 0.0:
        fail(f"examples: quickstart recovered {q['sketch']['recovered']} "
             f"of 16, divergence {q['train']['divergence']}")
    ft = outs["fault_tolerant_training"]
    if ((ft["p_before"], ft["p_after"]) != (5, 4)
            or ft["mask"] != [True, False, True, True]
            or len(ft["losses"]) != 9 or ft["divergence"] != 0.0):
        fail(f"examples: fault_tolerant_training {ft}")
    sb = outs["serve_batched"]
    if sb["completed"] != sb["requests"] or \
            sb["free_blocks"] != sb["num_blocks"] - 1:
        fail(f"examples: serve_batched finished {sb['completed']} of "
             f"{sb['requests']} requests")
    a, b = outs["train_lm_e2e"]
    losses = list(a["losses"].values()) + list(b["losses"].values())
    if (a["start"] != 0 or b["start"] != first or sorted(b["losses"])
            != list(range(first, last))
            or not all(math.isfinite(x) for x in losses)):
        fail(f"examples: train_lm_e2e starts {a['start']} / {b['start']}, "
             f"losses {losses}")
    log(f"[examples] quickstart: 16/16 recovered, est[0] "
        f"{q['sketch']['est0']:.4f}, divergence 0; fault_tolerant: P 5 -> "
        f"4, mask {ft['mask']}, losses {[round(x, 4) for x in ft['losses']]}"
        f", divergence 0; serve_batched: {sb['completed']} of "
        f"{sb['requests']} requests, {sb['tokens']} tokens, steady "
        f"{sb['tok_per_s']:.1f} tok/s (host clock); train_lm_e2e: "
        f"{a['params']:,} params, step 0 loss {a['losses'][0]:.4f}, step "
        f"{first - 1} {a['losses'][first - 1]:.4f}, resumed at "
        f"{b['start']}, step {last - 1} {b['losses'][last - 1]:.4f}; "
        f"train seconds {a['train_s']:.2f} + {b['train_s']:.2f}, with the "
        f"checkpoints {a['seconds']:.2f} + {b['seconds']:.2f}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"counts": counts}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.time()
    log(f"[card] {card_line()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    build_phase(torch)
    cfg, opt, ts = full_width_step(torch, device)
    t0 = time.time()
    kernels = kernels_phase(torch, device, ts)
    torch.cuda.empty_cache()
    log(f"[kernels] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    with kept_recoveries() as kept:
        run = train_phase(torch, cfg, opt, ts)
    state, stream, counts = run["state"], run["stream"], run["counts"]
    train_peak = run["peak"]
    train_ref = mesh_ref(torch, ts, run, kept)
    train_run = {k: run[k] for k in ("losses", "times", "peak")}
    del run, kept
    check_launches("train", counts, ("sketch_encode", "sketch_encode_finish",
                                     "sketch_decode", "topk_select"),
                   ("heavymix_scores", "heavymix_scores_ts", "ts_transpose",
                    "ts_encode"))
    recoveries = TRAIN_P * ts.n_buckets * TRAIN_STEPS
    for name in ("topk_select", "sketch_encode", "sketch_encode_finish"):
        if counts[name] != recoveries:
            fail(f"{name} launched {counts[name]} times on the train path, "
                 f"not once per recovery ({recoveries})")
    log(f"[train] topk_select launches {counts['topk_select']} = "
        f"{TRAIN_P} workers x {ts.n_buckets} buckets x {TRAIN_STEPS} steps")
    log(f"[train] phase took {time.time() - t0:.1f} s")
    state, profiled = profile_phase(torch, ts, state, stream)
    del state
    torch.cuda.empty_cache()
    t0 = time.time()
    traced = train_traced_phase(torch, ts, opt, main_exchange(),
                                profiled=profiled, train_peak=train_peak)
    log(f"[train_traced] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    train_watched_phase(
        torch, ts, opt, main_exchange(),
        lambda ex: full_width_step(torch, device, exchange=ex)[2])
    log(f"[train_watched] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    ts_step = full_width_ts_step(torch, device, ts, opt)
    run = train_phase(torch, cfg, opt, ts_step, tag="train_ts")
    state, stream, ts_counts = run["state"], run["stream"], run["counts"]
    del run
    check_launches("train_ts", ts_counts, ("ts_encode", "ts_transpose",
                                           "heavymix_scores_ts",
                                           "topk_select"),
                   ("sketch_encode", "sketch_encode_finish", "sketch_decode",
                    "heavymix_scores"))
    if ts_counts["topk_select"] != recoveries:
        fail(f"topk_select launched {ts_counts['topk_select']} times on the "
             f"train_ts path, not once per recovery ({recoveries})")
    log(f"[train_ts] topk_select launches {ts_counts['topk_select']} = "
        f"{TRAIN_P} workers x {ts_step.n_buckets} buckets x {TRAIN_STEPS} "
        "steps")
    log(f"[train_ts] phase took {time.time() - t0:.1f} s")
    state, _ = profile_phase(torch, ts_step, state, stream,
                             tag="profile_ts")
    del state, ts_step, ts
    torch.cuda.empty_cache()
    t0 = time.time()
    inter = train_interleave_phase(torch, device)
    log(f"[train_interleave] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    mini = train_minicpm_phase(torch, device)
    log(f"[train_minicpm] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    moe_run = train_moe_phase(torch, device)
    log(f"[train_moe] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    hybrid = train_hybrid_phase(torch, device)
    log(f"[train_hybrid] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    elastic = train_elastic_phase(torch, device)
    log(f"[train_elastic] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    tp_run = train_tp_phase(torch, device)
    log(f"[train_tp] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    fsdp_run = train_fsdp_phase(torch, device)
    log(f"[train_fsdp] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    tp_inter = train_tp_interleave_phase(torch, device)
    log(f"[train_tp_interleave] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    fsdp_inter = train_fsdp_interleave_phase(torch, device)
    log(f"[train_fsdp_interleave] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    mesh_run = train_mesh_phase(torch, train_ref)
    log(f"[train_mesh] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    mesh_tree = train_mesh_tree_phase(torch, device)
    log(f"[train_mesh_tree] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    mesh_tp = train_mesh_tp_phase(torch, device, tp_run["mesh_ref"])
    log(f"[train_mesh_tp] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    parity_counts = parity_phase(torch)
    parity_configs_phase(torch)
    log(f"[parity] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    parity_elastic = parity_elastic_phase(torch)
    log(f"[parity_elastic] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    families = parity_families_phase(torch)
    log(f"[parity_families] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    parity_tp = parity_tp_phase(torch)
    log(f"[parity_tp] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    parity_mesh = parity_mesh_phase(torch)
    log(f"[parity_mesh] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    cnn = train_cnn_phase(torch, device)
    log(f"[train_cnn] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    paper_table2_phase(torch, device)
    log(f"[paper_table2] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    paper_figs_phase(torch, device)
    log(f"[paper_figs] phase took {time.time() - t0:.1f} s")
    kernels.append(inter["finish_row"])
    launches = {"sketch_encode": counts, "sketch_decode": counts,
                "topk_select": counts, "ts_encode": ts_counts,
                "heavymix_scores_ts": ts_counts, "ts_transpose": ts_counts,
                "heavymix_scores": mini["counts"],
                "sketch_encode_finish": counts}
    for kr in kernels:
        kr["launches"] = launches[kr["name"]].get(kr["name"], 0)
        kr["launches_interleave"] = inter["counts"].get(kr["name"], 0)
        kr["launches_minicpm"] = mini["counts"].get(kr["name"], 0)
        kr["launches_parity"] = parity_counts.get(kr["name"], 0)
        kr["launches_traced"] = traced["counts"].get(kr["name"], 0)
        kr["launches_moe"] = moe_run["counts"].get(kr["name"], 0)
        kr["launches_hybrid"] = hybrid["counts"].get(kr["name"], 0)
        kr["launches_hybrid_interleave"] = hybrid["interleave_counts"].get(
            kr["name"], 0)
        kr["launches_parity_families"] = families.get(kr["name"], 0)
        kr["launches_elastic"] = elastic["counts"].get(kr["name"], 0)
        kr["launches_parity_elastic"] = parity_elastic.get(kr["name"], 0)
        kr["launches_train_tp"] = tp_run["counts"].get(kr["name"], 0)
        kr["launches_train_fsdp"] = fsdp_run["counts"].get(kr["name"], 0)
        kr["launches_parity_tp"] = parity_tp.get(kr["name"], 0)
        kr["launches_train_tp_interleave"] = tp_inter["counts"].get(
            kr["name"], 0)
        kr["launches_train_fsdp_interleave"] = fsdp_inter["counts"].get(
            kr["name"], 0)
        kr["launches_train_mesh_tp_interleave"] = \
            mesh_tp["interleave_counts"].get(kr["name"], 0)
        # the process mesh's phases: summed over their processes
        kr["launches_train_mesh"] = mesh_run["counts"].get(kr["name"], 0)
        kr["launches_train_mesh_tree"] = mesh_tree["counts"].get(
            kr["name"], 0)
        kr["launches_train_mesh_tp"] = mesh_tp["counts"].get(kr["name"], 0)
        kr["launches_parity_mesh"] = parity_mesh.get(kr["name"], 0)
        kr["shard_shapes"] = (tp_run["shapes"].get(kr["name"], [])
                              + fsdp_run["shapes"].get(kr["name"], [])
                              + tp_inter["shapes"].get(kr["name"], [])
                              + fsdp_inter["shapes"].get(kr["name"], []))
        for model, run in cnn.items():
            kr[f"launches_cnn_{model}"] = run["counts"].get(kr["name"], 0)
            kr.setdefault("cnn_shapes", []).extend(
                run["shapes"].get(kr["name"], []))
        kr["interleave_shapes"] = inter["shapes"].get(kr["name"], [])
        if kr["name"] == "sketch_encode":
            kr["interleave_fragments"] = inter["fragments"]
            kr["tp_interleave_fragments"] = tp_inter["fragments"]
            kr["fsdp_interleave_fragments"] = fsdp_inter["fragments"]
        if kr["name"] == "heavymix_scores":  # the main path's shapes first
            old = {k: kr[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}
            old["shape"] = "bucket 0's d of train, greedy (parity's variant)"
            kr["shapes"] = mini["filler_shapes"] + [old]
            kr.update({k: mini["filler_shapes"][0][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
    t0 = time.time()
    baselines_phase(torch)
    log(f"[baselines] phase took {time.time() - t0:.1f} s")
    cli_phase()
    cli_phase(("--buckets", "4", "--bwd-chunks", "2", "--fuse-encode"))
    cli_resume_phase()
    t0 = time.time()
    cli_tune_phase()
    log(f"[cli_tune] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    cli_simulate_phase()
    log(f"[cli_simulate] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    serve_counts = serve_phases(torch, device)
    t0 = time.time()
    for k, v in serve_parity_phase(torch).items():
        serve_counts[k] = serve_counts.get(k, 0) + v
    log(f"[serve_parity] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    serve_tp = serve_tp_phase(torch, device)
    log(f"[serve_tp] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    cli_serve_phase()
    log(f"[serve_load, cli_serve] phases took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    dry = dryrun_phases(torch)
    log(f"[dryrun] phases took {time.time() - t0:.1f} s")
    t0 = time.time()
    long_ctx = long_context_phase(torch, device, train_run)
    log(f"[long_context] phase took {time.time() - t0:.1f} s")
    t_new = t0 = time.time()
    roof = roofline_phase(torch, device, dry)
    torch.cuda.empty_cache()
    log(f"[roofline] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    perf_iterations_phase()
    log(f"[perf_iterations] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    overlap = overlap_audit_phase(torch, device)
    torch.cuda.empty_cache()
    log(f"[overlap_audit] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    bench_host_phase()
    log(f"[bench_host] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    examples = examples_phase(torch, device)
    log(f"[examples] phase took {time.time() - t0:.1f} s")
    log(f"[roofline .. examples] the five phases took "
        f"{time.time() - t_new:.1f} s")
    for kr in kernels:
        kr["launches_measure_encode"] = roof["counts"].get(kr["name"], 0)
        kr["launches_overlap_interleave"] = overlap["counts"].get(
            kr["name"], 0)
        kr["launches_overlap_tp_interleave"] = overlap["counts_tp"].get(
            kr["name"], 0)
        for name, c in examples["counts"].items():
            kr[f"launches_example_{name}"] = c.get(kr["name"], 0)
        kr["launches_serve"] = serve_counts.get(kr["name"], 0)
        kr["launches_serve_tp"] = serve_tp["counts"].get(kr["name"], 0)
        for tag in ("dryrun_train", "dryrun_fsdp", "dryrun_serve"):
            kr[f"launches_{tag}"] = dry[tag]["counts"].get(kr["name"], 0)
        kr["launches_long_context"] = long_ctx["counts"].get(kr["name"], 0)
        kr["dryrun_shapes"] = dry["dryrun_train"]["shapes"].get(
            kr["name"], [])
    if any(dry["dryrun_serve"]["counts"].values()):
        fail(f"dryrun_serve launched {dry['dryrun_serve']['counts']}")
    log(f"[done] in {time.time() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_mesh() -> int:
    """``chip_smoke.py --mesh``: the process mesh's phases alone, each with
    its one-process reference (train for train_mesh, the simulated tree
    step, train_tp's three steps and the witness for train_mesh_tp) and
    parity_mesh, held as in the whole run. A world that fits the visible
    cards gives each rank its own card and NCCL (``launch.mesh``); on one
    card every world shares it over gloo. Every phase runs: the failures
    are printed at the end, and any exits non-zero."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)
    from repro_torch.configs.qwen3_4b import CONFIG
    from repro_torch.core.gs_sgd import MeshAxes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.time()
    log(f"[card] {card_line()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    build_phase(torch)
    failures = []

    def attempt(name, phase):
        t0 = time.time()
        try:
            phase()
        except SystemExit as e:
            failures.append(str(e))
            log(f"[{name}] {e}")
        log(f"[{name}] phase took {time.time() - t0:.1f} s")

    def ref_of(cfg, opt, ts, tag):
        with kept_recoveries() as kept:
            run = train_phase(torch, cfg, opt, ts, tag=tag)
        ref = mesh_ref(torch, ts, run, kept)
        del run, kept
        return ref

    train_ref = ref_of(*full_width_step(torch, device), "train")
    torch.cuda.empty_cache()
    attempt("train_mesh", lambda: train_mesh_phase(torch, train_ref))
    attempt("train_mesh_tree", lambda: train_mesh_tree_phase(torch, device))
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    tp_ref = ref_of(cfg, *sharded_step(torch, device, cfg, MeshAxes(
        tp=TP, data=TP_DATA)), "train_tp")
    torch.cuda.empty_cache()
    attempt("train_mesh_tp",
            lambda: train_mesh_tp_phase(torch, device, tp_ref))
    attempt("parity_mesh", lambda: parity_mesh_phase(torch))
    log(f"[done] in {time.time() - t_start:.1f} s")
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main_mesh() if sys.argv[1:] == ["--mesh"] else main())
