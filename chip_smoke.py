#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (kmeans_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout.  It builds the port's CUDA kernels from
``kmeans_tpu_torch/csrc/lloyd.cu`` and runs nineteen phases and a final
report, exiting non-zero if any fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` for sm_90a, with its seconds, register report, and the
   registers and spills of each variant of the Hopper core (bf16 and its
   f32 route);
3. each kernel against its plain PyTorch version on the card: ragged n,
   d in {2, 100, 2048}, k in {3, 1000}, float32 and bfloat16, zero-weight
   rows, a −1 sentinel ``prev``, out-of-range labels, and exact ties; each
   case's scoring core asserted against the rule; the Hopper core (bf16,
   d % 8 == 0; f32, d % 4 == 0) also at d in {8, 200} (bf16), {4, 300}
   (f32) and k in {3, 257, 1000}: K1's labels and min_d2, K2's labels and
   raw scores, K4's labels, sb, slb, n_recomputed and dense_tiles (need
   fractions 0, about 10% and 100%) and K5's labels, raw and normed min
   and second-min (k_tile in {128, 384, 1024}) equal to ``score_block``'s
   bit for bit in bf16 and to SCORE_RTOL on the f32 route (six bf16
   passes against IEEE f32 FMA), two launches of each equal bit for bit,
   duplicate centroids at the core's slice edges (255 | 256; 127 | 128 on
   the f32 route's 128-column sub-slices) and, for K4 and K5, at a
   sub-slice edge inside a range and at range edges, in both dtypes; the
   f32 route's worst score error against an f64 product over the f32
   cases, within SCORE_RTOL and (d + 2)·2⁻²⁴ of ||x||² + ||c||²;
   the Hamerly kernel (K4) at need fractions 0, about 10% and 100%, and
   with every row needed against the delta kernel (K2), bit for bit; the
   k-tiled pair at 128-column slices (K5's labels, raw scores and
   second-min against K2's and K4's bit for bit, K6's single and dual
   folds with −1 sentinels and a skewed bucket, two K6 launches bit for
   bit), and ties on either side of a slice edge; the fold core (K6 single
   and dual, K3, K1's fold) at d in {64, 100, 300, 2048, 4104}, k in
   {1, 3, 7, 1000}, f32 and bf16, every row on one label: equal bit for
   bit to ``fold_core_plain``, to a second launch and to each other; K2's
   and K4's delta (the fold core's dual fold over the changed rows) in
   every case equal bit for bit to ``fold_core_plain`` over
   ``delta_fold_weights``, and a second launch of each equal to the first
   in every output; the
   sharded TP body's hooks at TP_HOOK_CASES (the Hopper core in bf16 and
   on its f32 route, and ``score_block``): K1 and K5 in raw-score mode on
   two k-slices with ``valid_cols`` masking the last columns, the two
   slices resolved into one card's K1 labels but ties, and K3 and K6 with
   the resolved scores and relative labels, each against its plain
   version;
4. the slice at full width, at n = 1,280,000, d = 2048, k = 1000 in bf16:
   the main path in three runs, each with the launch counts set to 0 just
   before it and read just after -- ``fit_lloyd(update="delta")`` (20
   sweeps, so the refresh at sweep 16 and the final view run), the public
   delta sweep's refresh branch (``delta_pass(force_full=True)``) and the
   default entry point ``KMeans(compute_dtype="bfloat16")`` with
   ``update="auto"`` (48 sweeps, so the yinyang probe at sweep 16 and its
   judgment at sweep 32 run), run twice: the same centroids, labels,
   sweeps and counters bit for bit; 20 hand-driven ``hamerly_pass`` and 20
   ``yinyang_pass`` sweeps, each held against K1 at the same centroids
   (every label that differs must be a tie); then each kernel at that
   shape against its plain version, its time beside its bound, the plain
   version's and a library call's (K4's also on ``score_block``), K1's
   time split into scoring and the fold with ||x||², the SM clock and
   power under K2, K5 + K6 forced tiled there, one steady sweep of each
   flavour, and the time of k-means++ there; then imagenet-delta-f32, the
   same shape in f32 on the core's f32 route: ``fit_lloyd(update=
   "delta")`` (F32_SWEEPS sweeps) and F32_HAMERLY_SWEEPS hand-driven
   ``hamerly_pass`` sweeps, each run's counts set to 0 before it and read
   after, labels held against K1 and the plain route, then K1, K2 and K4
   held against their plain versions and timed beside both bounds (six
   bf16 passes, f32 FMA), ``torch.mm`` + ``argmin`` with TF32 off and
   ``score_block``, and the route's score error against f64 on sampled
   rows; then K2 in f32 on the route and on ``score_block`` at the glove
   shape (n = 400,000, k = 1000) over d in F32_WIDTHS;
5. whole ``KMeans(compute_dtype="bfloat16")`` fits with k-means++ at the
   ``glove`` shape, ``update="delta"`` and the default ``"auto"`` (the
   adaptive loop: n >= 16384), each held against a plain-backend fit,
   with the counts set to 0 before each fit and read after (K1 and K2
   must launch, and K4 on the adaptive loop); and a small bf16 fit with
   fractional weights, which the weights veto sends on the plain route on
   the card under ``backend="auto"``, held against the CPU and run twice
   on the card, bit for bit, then seeded with k-means|| in bf16 under the
   same weights, twice, bit for bit; and the tied-outlier fit
   (``empty="farthest"``, n = 200,000, d = 64, 128 outliers at ±8·e_i,
   all tied in min_d2): twice on the kernels and once on the plain
   backend, each reseeding onto the lowest-index tied outliers (as
   ``lax.top_k`` picks them), the two card fits equal bit for bit;
6. the ``codebook`` shape, n = 1,280,000, d = 2048, k = 65536 in bf16, where
   the planner tiles: its decision for every kind there and at the headline
   and glove shapes, then the main path in three runs, counts set to 0
   before each and read after -- ``KMeans(update="delta", max_iter=4,
   tol=-1)`` (the refresh, three delta sweeps and the final view: K5 and K6
   only), ``delta_pass(force_full=True)`` and three hand-driven
   ``hamerly_pass`` sweeps, each held against K5's full scoring; the fit's
   labels against the plain route's; then K5 and K6 beside their bounds,
   plain versions and library calls, K5 with the second-min and on
   ``score_block`` (bit for bit against each other), and the same sweeps
   untiled (K1, K2);
7. K6's device time split by kernel (a ``torch.profiler`` trace of
   ordinary calls) on seeded inputs at the full width: the single fold at
   k = 1000 and at k = 65536, and the dual fold at k = 65536 with 2% of
   the rows changed (the full run prints it after phase 17);
8. serving, run after phase 6: the assignment engine
   (``kmeans_tpu_torch.serve.assign.AssignEngine``) on the card serves
   phase 4's delta-fit centroids (imagenet-serve, k = 1000: the default
   closure-pruned route, then the dense route on K5) and phase 6's
   (codebook-serve, k = 65536: the default int8 quant route, then the
   dense route), each run SERVE_SECONDS of SERVE_CLIENTS closed-loop
   clients (64 and 512 points a request, query rows the centroids plus
   unit noise) with a permuted generation published half-way and the
   launch counts set to 0 before and read after; every response is held
   against K5's labels of its own generation (a differing label must be a
   tie within SCORE_RTOL), the routes against each other, no request may
   fail or wait past the default ``assign_timeout_s``, the batcher must
   coalesce, and K5 must launch once a dense batch and once for each
   pruned or quant batch whose certificate failures it rescores; then K5
   in f32 (the core's f32 route) at the serving batch shapes against its
   plain version, both bounds and ``torch.mm`` + ``argmin`` with TF32 off,
   beside its other column range and ``score_block``, with each one's
   score error against f64;
9. the accelerated and minibatch fits, run after phase 8, each run with
   the launch counts set to 0 before it and read after: imagenet-accel
   (``bench.py --accel``'s hard instances at the headline width, bf16,
   seeds ACCEL_SEEDS: plain ``fit_lloyd``, beta, Anderson and
   ``fit_minibatch(schedule="nested")`` from one k-means++ start each,
   each after a warm-up; K1 in every arm, K2 in the Anderson and nested
   arms, the medians of their inertia within ``bench.py``'s one-sided
   gates of plain's; on seed 0, K2 with and without row norms and
   ``anderson_step`` behind queued work, which fails on a host sync, and
   beta and Anderson for ACCEL_CHECK_ITERS sweeps on ``backend="cuda"``
   and ``"plain"`` with equal outcome sequences),
   cifar10-minibatch (f32; the fit, the early-stopping fit and
   ``partial_fit`` calls, the fit's seconds split into seeding, steps and
   the final sweep, cuda and plain centroids equal bit for bit) and
   imagenet-minibatch (bf16; the same split, ``batch_stats`` beside K1 on
   one gathered batch, a step checked for host syncs);
10. the model over HTTP (imagenet-http): ``python -m
   kmeans_tpu_torch.cli serve --model-dir D`` on phase 4's centroids,
   binary, distances and JSON runs of 48 keep-alive clients in a client
   process, a publish and a reload half-way, then the dense route; every
   response held to K5's labels of its generation, ``/metrics`` to the
   client's counts, ``/api/trace`` to one lane per connection;
11. the serving fleet (imagenet-fleet): the same model and pool, 48
   keep-alive clients split over two client processes, FLEET_SECONDS a
   run: fleets of FLEET_SIZES workers on the default route (``cli serve
   --workers N --fleet-obs-port P`` for N > 1), 4 on the dense route,
   each run publishing a generation that the supervisor
   pushes to its workers half-way; every response held to K5's labels
   of its generation, no 503, no drop, no unplanned exit, the aggregated
   ``/metrics`` to the clients' counts with the fit's families under a
   ``worker`` label, the merged ``/api/trace`` strict JSON with every
   worker's lanes, a clean drain; QPS, p50 / p99, each worker's boot and
   first response, the card's memory and busy share, the span split;
   K5's launches counted from the workers' traces and held to their
   engine counters; then the kill drill (``fleet.heartbeat:kill@2``:
   the RTO beside the reference's gate, only in-flight requests lost)
   and a rolling replace with no failed request, at 2 workers, with SSE
   subscribers on both workers through it (each stream ended by its
   worker's drain) and through the fleet's drain after it;
12. the step-paced runner and ``cli train``, each run's launch counts set
   to 0 before it and read after: in process on phase 4's bf16 data and
   c0, ``LloydRunner(update="delta")`` for RUNNER_ITERS iterations with a
   callback and telemetry, held to ``fit_lloyd(update="delta")`` from the
   same c0 (iterations equal, inertia within FIT_INERTIA_RTOL; K1 and K2
   only), its ms a sweep beside the fused fit's in this call, then
   ``update="yinyang"`` (K4; the last sweep's labels against K1 at the
   centroids it scored, any difference a tie) and ``accel="anderson"``
   (its outcome totals); at ``codebook`` on phase 6's data,
   ``update="delta"`` for CODEBOOK_SWEEPS iterations (K5 and K6 only) held
   to phase 6's fit; then ``python -m kmeans_tpu_torch.cli train --config
   imagenet --model lloyd`` in subprocesses (``chip_smoke.py --train-cli
   SPEC`` runs the module as ``-m`` does and records its launch counts):
   an f32 runner for CLI_ITERS iterations with progress, checkpoints,
   telemetry, a span trace and the export, all checked; the preemption
   drill (SIGTERM once a progress line reports iteration DRILL_AT: exit 3,
   a "resume with" line, a checkpoint at that step, then ``--resume`` to
   iteration CLI_ITERS within FIT_INERTIA_RTOL of the uninterrupted run);
   the same shape in bf16 compute (``score_block``); the fused adaptive fit;
   and ``train --config cifar10`` (minibatch), each with its wall time;
13. the board and the trimmed family, each run's launch counts set to 0
   before it and read after: trimmed-headline (``fit_trimmed(
   trim_fraction=TRIM_FRACTION)`` on phase 4's bf16 data and c0 for
   TRIM_ITERS iterations: K1 only; the mask is K1's min_d2 at the final
   centroids ranked with the lowest-index tie-break, the labels -1 exactly
   there, the counts sum to n - m, the inertia the inliers' min_d2 within
   SUMS_RTOL, the final inertia within FIT_INERTIA_RTOL of the plain
   backend's fit on the card; ms an iteration beside K1 alone and the trim
   split into selection, gather and fold with CUDA events),
   trimmed-codebook (phase 6's data, ``n_trim`` TRIM_CODEBOOK_M,
   TRIM_CODEBOOK_ITERS iterations and the final view, the depth cut: K5
   and K6 only, labels against K5's, ties apart), trimmed-cli (``cli train
   --config imagenet --model trimmed`` in a child process: its result
   line, the export's unassigned outliers, its launches; board-http's
   first server boots meanwhile), then board-http:
   ``cli serve --persist-dir D`` in a child process (``chip_smoke.py
   --board-cli SPEC`` runs ``cli.main`` and writes its launch counts and
   its ``stop()`` time): the fixture and ``autoAssign`` with and without
   outliers, the ``train`` op (``lloyd`` at n = 100,000, d = 2, k = 3: an
   SSE event an iteration with the live centroids; the request cap, d =
   80, k = 100, merged to the board; ``trimmed``), BOARD_MUTATORS mutating
   clients and BOARD_SUBSCRIBERS SSE subscribers in one room for
   BOARD_SECONDS (mutations/s, the delay from a mutate's response to each
   subscriber's event, no 503), kill -9 and a restart on D (each room's
   ``/api/state`` as before the kill), a ``Last-Event-ID`` reconnect that
   replays the missed ``train`` events, and SIGINT with SSE subscribers
   and assign clients attached (``stop()`` well under ``fleet_drain_s``,
   no accepted request unanswered); the board server's K5 launches (the
   stop drill's model) and K6 launches (the train op's trimmed fits at d =
   2) are printed and on no row of phase 18;
14. out-of-core streaming and continuous clustering, each run's launch
   counts set to 0 before it and read after: imagenet-stream (the
   headline's 1.28M x 2048 f32 rows in host memory, ``fit_minibatch_stream``
   for STREAM_STEPS steps of STREAM_BATCH from a fixed init, in f32 and in
   bf16 compute with bf16 transfer: every batch through the native gather,
   the card's peak memory under STREAM_PEAK_BYTES above its level before,
   the centroids equal bit for bit to the same batches through
   ``batch_update`` on card-resident copies, the final pass's labels the
   plain backend's but ties and its inertia within SUMS_RTOL; steps/s, a
   step's split, the SMs' idle share, the producer's stalls, the final
   pass and the core K1 took), cifar10-stream-cli (``cli train --stream``
   on a cifar10-shaped ``.npy`` in child processes, beside
   imagenet-continuous: the result line, the
   SIGTERM drill at step STREAM_DRILL_AT and its resume, bit for bit the
   uninterrupted run's centroids) and imagenet-continuous (``cli
   continuous`` with CONT_ARGV in a child process, ``chip_smoke.py
   --continuous-cli SPEC``, which times the pipeline's pieces: an initial,
   a drift and a scheduled refit and a compaction; the kill drills at the
   second refit's site and at the second publish's swap, each resumed,
   with its RTO, the same generations and triggers and the final
   generation's centroids, as each process published them, within
   CONT_RESUME_TOL of the undisturbed run's, whose every generation a
   second undisturbed run, the serve run, gives bit for bit); then ``cli serve
   --model-dir D`` beside a second run, CONT_CLIENTS keep-alive clients, a
   reload after each generation line, every response held to K5's labels
   of its generation, no 503 and no drop);
15. the data-parallel engine (``kmeans_tpu_torch.parallel``), each run's
   launch counts set to 0 before it and read after, on every rank:
   imagenet-dp1-nccl (``fit_lloyd_sharded(update="delta")`` on an NCCL mesh
   of one in this process, MESH_SWEEPS sweeps on phase 4's data and c0,
   held to ``fit_lloyd`` from the same c0 -- labels but ties, centroids
   within SUMS_RTOL, inertia within FIT_INERTIA_RTOL -- both timed here);
   then a gloo mesh of two ranks sharing the card (``chip_smoke.py
   --mesh-rank SPEC``): the three collectives on card tensors through
   gloo, each result checked, then imagenet-dp2-gloo (``update`` matmul,
   delta, hamerly and yinyang, each under ``comm="allreduce"`` and
   ``"scatter"``, held to the single-device fit of its flavour by
   inertia, by ties at each run's centroids and by its last sweep, one
   card's classic pass bit for bit; each sweep
   split into the local pass, the merge and the update by host clock and
   CUDA events, and the collectives' payload beside
   ``_sweep_collective_bytes``), codebook-dp2-gloo (k = 65536 on phase 6's
   data, MESH_CODEBOOK_SWEEPS delta sweeps, K5 and K6 on each rank,
   scatter against allreduce and the single-device fit) and
   cifar10-dp2-minibatch (``fit_minibatch_sharded`` for MB_STEPS steps of
   MB_BATCH, its centroids against a replay of both ranks' draws on one
   device, steps/s beside the single-device fit's); then train-mesh (``cli
   train --mesh N`` for lloyd and minibatch in child processes, N the card
   count, or ``--mesh 2 --device cpu`` at a small shape on a
   one-card host, against ``--mesh 1``);
16. the rest of the sharded engine, each run's launch counts set to 0
   before it and read after, on every rank and child, no number of it a
   scaling number (one card): imagenet-accel-dp1-nccl (phase 4's data and
   c0, ``fit_lloyd_accelerated_sharded`` with β and with Anderson to
   convergence on an NCCL mesh of one, each held to the single-device fit
   from the same c0: sweeps equal, centroids within SUMS_RTOL, inertia
   within FIT_INERTIA_RTOL; timed beside it); imagenet-elastic-dp1-nccl
   (ELASTIC_SWEEPS sweeps at ``ckpt_every`` ELASTIC_EVERY, matmul and
   delta, uninterrupted here, then cut by SIGTERM at the second boundary
   and resumed, each in a child process, ``chip_smoke.py --elastic-rank
   SPEC``: matmul and delta bit for bit;
   the seconds a bundle and the restart); TP×FP on four gloo ranks at
   TPFP_SHAPE (held, not timed; the cut children, this world and
   train-mesh's CPU processes start with the phase, beside the in-process
   runs); after the cut a gloo world of two ranks sharing
   the card (``chip_smoke.py --sharded-rank SPEC``): the MIN all-reduce
   on card tensors, trimmed-dp2-gloo (``fit_trimmed_sharded``,
   m = TRIM_M, TRIM_ITERS iterations: K1 and K6 on each rank, its mask
   one card's top m at its centroids exactly, held to ``fit_trimmed``),
   elastic-dp2-gloo (the card-cut matmul bundle resumed on two ranks),
   imagenet-tp2-gloo and imagenet-fp2-gloo (TP_SWEEPS classic sweeps on
   meshes (1, 2) with model = 2 and (1, 1, 2) with feature = 2, K1's
   launches with ``valid_cols`` counted, each sweep split into its pass,
   MIN resolve, fold, merge and update, held to the single-device fit),
   imagenet-stream-dp2-gloo (phase 14's stream for SHARDED_STREAM_STEPS
   steps, each rank gathering half of each batch; steps/s, a rank's step
   split, the centroids a one-device replay of both halves bit for bit),
   codebook-dp2-gloo's peak card memory a rank after C4 and
   codebook-tp2-gloo (TP_CODEBOOK_SWEEPS classic sweeps at k = 65536, K5
   and K6 with ``valid_cols``, the final labels one card's K5 pass but
   ties); and train-mesh (``cli train --mesh 2 --device cpu`` for
   accelerated, trimmed, ``--stream`` and ``--ckpt-dir`` with a cut and a
   resume, against ``--mesh 1`` and the uninterrupted run);
17. the Lloyd-based families and model selection, each run's launch
   counts set to 0 before it and read after: glove-spherical (``glove``'s
   shape, n = 400,000, d = 300, k = 1000, SPHERE_SWEEPS sweeps from a
   fixed unit-norm init, in f32 on K1's f32 route and in bf16 on
   ``score_block``: K1 alone, SPHERE_SWEEPS + 1 launches, each held to the
   same fit on ``backend="plain"`` on the card: labels but ties,
   centroids within SUMS_RTOL, every norm within 1e-6 of 1; ms a pass;
   sweep_k's sampled silhouette on the f32 fit's labels, the one-hot
   product twice, bit for bit, and against f64), glove-bisecting (f32,
   k = BISECT_K: seconds, splits, launches, counts summing to n, the
   inertia an f64 recomputation's within FIT_INERTIA_RTOL; at BISECT_HOLD_K, on rows of as many blobs, the
   plain backend's split sequence and inertia, the card's busy share
   under ``torch.profiler``; a bf16
   run, whose inner fits the weights veto sends to the plain route, with
   ``fit_plan``'s "why" and only the assigns' K1 launched, twice: the
   same split sequence, centroids and labels bit for bit),
   spherical-dp1-nccl (``fit_spherical_sharded`` on an NCCL mesh of one
   against ``fit_spherical``: bit for bit, an all-reduce a sweep, the
   time ratio), imagenet-spherical (the headline's bf16 data on the
   Hopper core, SPHERE_SWEEPS sweeps: the card's peak memory of the fit
   and of the chunked normalization beside the whole-array f32 one, whose
   bits it keeps), glove-xmeans and glove-gmeans (f32, AUTOK_BLOBS
   generating blobs, k_max AUTOK_K_MAX: the discovered k, rounds, seconds
   and launches, each held to the plain backend on the first
   AUTOK_HOLD_ROWS rows: the same k, inertia within FIT_INERTIA_RTOL),
   mnist-sweep (``cli sweep`` on an mnist-shaped ``.npy`` in child
   processes, ``chip_smoke.py --sweep-cli SPEC``, by silhouette and by
   the gap statistic: seconds a row, each silhouette row's scores
   recomputed in f64 on the card, both suggesting 10), then a gloo world
   of two ranks sharing the card (``chip_smoke.py --families-rank SPEC``:
   spherical on FP, mesh (1, 1, 2), and bisecting on DP at k =
   FAM_GLOO_BISECT_K on rows of as many blobs, each held to one card's
   fit) beside train-mesh
   (``cli train --mesh 2 --device cpu`` for spherical, bisecting, xmeans
   and gmeans against ``--mesh 1``);
18. the soft, balanced and projected families (no kernel of their own:
   their products are ``torch.matmul``, their passes plain PyTorch, as
   the reference's are XLA code), each from a fixed init: imagenet-gmm
   (``fit_gmm`` at n = 1,280,000, d = 2048, k = 1000, diag, bf16,
   GMM_ITERS EM iterations: ms an iteration, one pass's products and
   other kernels under ``torch.profiler``, the peak memory, every pass's
   log-likelihood rising but for its f32 rounding and the last against an
   f64 recomputation on the card; ``gmm_sample`` twice from one seed, bit
   for bit), mnist-gmm (diag, spherical and tied in
   f32, each held to the port's CPU fit; the tied fit's Cholesky factor
   and solves timed), glove-fuzzy (f32 and bf16, FUZZY_ITERS iterations;
   one pass's sums, soft counts and J against f64 on the card; the first
   FUZZY_HOLD_ROWS rows against the CPU fit), mnist-balanced
   (``BalancedKMeans`` with 200 Sinkhorn sweeps a step: the column masses
   at the capacities, the hard counts near n/k, then ``predict`` on K1),
   gmm-dp1-nccl and fuzzy-dp1-nccl (the sharded fits on an NCCL mesh of
   one, bit for bit one card's), glove-balanced-dp1-nccl
   (``fit_balanced_sharded`` at n·k = 4e8, past the single-device gate,
   BAL_ITERS outer iterations: ms a Sinkhorn sweep against its bound, the
   peak memory and two all-reduces a sweep; held at BAL_HOLD_ROWS rows
   and BAL_HOLD_ITERS outer iterations to ``fit_balanced``),
   cifar10-pca-cli (``cli train --pca 256 --whiten
   --k 100`` in a child process, its Lloyd fit's K1 and K2 counted; the
   moment product and eigh timed, the components held to the CPU's up to
   sign), cifar10-gmm-stream (the streamed GMM at the CLI's defaults in
   process: steps a second and the card's idle share; ``cli train
   --stream --model gmm`` in a child process with a SIGTERM drill, its
   directory resumed here and ending on the uninterrupted run bit for
   bit), mnist-sweep-bic (``cli sweep
   --model gmm --criterion bic`` in a child process, every row's BIC
   against f64), a gloo world of two ranks sharing the card
   (``chip_smoke.py --soft-rank SPEC``: gmm, fuzzy, balanced and
   ``pca_fit_sharded`` on DP, each held to one card's) and train-mesh
   (``cli train --mesh 2 --device cpu`` for fuzzy, gmm and balanced
   against ``--mesh 1``);
19. the pairwise families (no kernel of their own: the medoid cost
   sweep, the kernel-mass sweep and the Nyström tiles are ``torch.matmul``
   and plain PyTorch, as the reference's are XLA code; K1 and K2 from
   their assignments and Lloyd fits): mnist-kmedoids (``fit_kmedoids`` at
   n = 60,000, d = 784, k = 10 from fixed indices, at most PAIRWISE_ITERS
   iterations: ms an iteration, the cost sweep alone against its bound,
   the peak memory; the port's CPU fit on the first PAIRWISE_HOLD_ROWS
   rows gives the same medoids, two clusters' medoids cost the least of
   their members in f64 on the card; ``KMedoids.predict`` on K1),
   mnist-kernel (rbf at γ = 1/d from k-means++ and K1: a mass pass
   against its bound, the objective pass by pass never rising past its
   f32 rounding, ``kernel_assign`` with the cached T reproducing the
   training labels, the linear kernel's objective against Lloyd's f64
   inertia of its partition), rings-spectral (``make_rings`` at n = 1e6:
   the embedding's stages timed, ``fit_spectral`` on K1 and K2, ARI above
   0.99, unit rows), glove-spectral (n = 400,000, d = 300, k = 100: the
   projector of sampled rows against an f64 recomputation on the card),
   glove-nystrom (``nystrom_features(m=1024)``, then a k = 1000 Lloyd fit
   on K1's f32 route and K2), kmedoids-, kernel- and spectral-dp1-nccl
   (bit for bit one card's; no ring shift at world size 1), a gloo world
   of two ranks sharing the card (``chip_smoke.py --pairwise-rank SPEC``:
   the two ring passes and the sharded embedding, each held to one
   card's; the ring shifts staged through host memory) beside a probe
   world that sends a card tensor over gloo directly, pairwise-cli (``cli
   train --model spectral --input rings.npy --out board.json`` in a child
   process), train-mesh (``cli train --mesh 2 --device cpu`` for the
   three against ``--mesh 1``) and the board's ``train`` op for kmedoids
   and kernel at the cap's n = 20,000;
20. a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
   line.  A kernel has a row for each compute dtype its main-path runs
   score in: bf16 (phases 4, 6, 9, 12's in-process and bf16 runs, 13's
   in-process trimmed runs, 14's bf16 stream and 17's bf16 runs) and f32
   (the route's K1, K2 and K4 from imagenet-delta-f32, phase 12's f32 CLI
   runs, phase 13's trimmed CLI run, K1 from phase 9's cifar10 runs,
   phase 14's f32 runs and phase 17's, 18's and 19's f32 runs, with the
   board server's
   f32 K1 and K2 launches on ``score_block`` at d <= 80; K5 from each
   served model's runs), each row's launches counted in its own runs and
   its times taken at its own shape.

``python3 chip_smoke.py --fold-split`` runs phases 1 and 7 only (the
kernels build at their first call), so it also splits an older tree's K6.
``python3 chip_smoke.py --f32-bench`` runs phase 1 and
:func:`phase_f32_bench` only (the f32-compute kernels at the serving and
headline shapes beside the library), so a copy of this script run in an
older checkout times that tree's f32 route in the same call;
``--delta-bench`` runs phase 1 and :func:`phase_delta_bench` only (K2, K4
and the fits they run in, the fold core's share of each, their peak
memory and whether two launches agree), for the same use;
``--fold-bench`` runs phase 1 and :func:`phase_fold_bench` only (the plain
route's weighted fold in each deterministic form beside ``index_add_``,
one weighted sweep at the headline and phase 5's weighted fit), for the
same use; ``--select-bench`` runs phase 1 and :func:`phase_select_bench`
only (the farthest reseed's selection at the headline and glove shapes
and an ``empty="farthest"`` fit at glove's), for the same use.
``python3 chip_smoke.py --accel`` runs phases 1 and 9 only (the kernels
build at their first call); ``--serve-http`` and ``--fleet`` run phases 1
and 10, and 1 and 11, on ``make_blobs`` centres; ``--runner`` runs phases
1, 2 and 12 (it makes phase 6's fit itself); ``--board`` runs phases 1
and 13 (the kernels build at their first call); ``--stream`` runs phases
1, 2 and 14; ``--mesh`` runs phases 1, 2 and 15; ``--sharded`` runs
phases 1, 2 and 16; ``--families`` runs phases 1, 2 and 17; ``--soft``
runs phases 1, 2 and 18; ``--pairwise`` runs phases 1, 2 and 19.

The bounds use the H100 SXM data-sheet peaks: 3.35 TB/s of memory, 989
TFLOP/s bf16 on the tensor cores and 67 TFLOP/s f32 outside them; an f32
row states both the f32 route's bound (six bf16 passes at 989 TFLOP/s)
and the f32 FMA bound.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

HEADLINE = dict(n=1_280_000, d=2048, k=1000)
CODEBOOK = dict(n=1_280_000, d=2048, k=65536)
CIFAR10 = dict(n=50_000, d=3072, k=100)
MEM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
#: Tolerances of the kernel-vs-plain checks.  The kernel and the plain
#: version sum the same f32 products in another order, so their labels may
#: differ on a row whose two best scores tie to within that order: each
#: one's chosen score may exceed the f64 minimum by this fraction of
#: ||x_cd||² + ||c||² (which bounds |csq − 2x·c|), and no more.
SCORE_RTOL = 1e-5
#: Sums: f32 sums of the same terms, in another order on the card (the fold
#: core's buckets in row order, against the plain versions' ``index_add_``).
SUMS_RTOL = 1e-4
#: Phase 5: final inertia of the kernel fit vs the plain-backend fit.  Both
#: start from the same k-means++ draw; rows whose two best bf16 scores tie
#: to within the accumulation order may move, nothing else.
FIT_INERTIA_RTOL = 1e-4
SOURCE = "kmeans_tpu_torch/csrc/lloyd.cu"
REPLACES = {
    "lloyd_pass_cuda": "kmeans_tpu/ops/pallas_lloyd.py:458",
    "lloyd_delta_cuda": "kmeans_tpu/ops/pallas_lloyd.py:677",
    "accumulate_cuda": "kmeans_tpu/ops/pallas_lloyd.py:1583",
    "lloyd_hamerly_cuda": "kmeans_tpu/ops/pallas_lloyd.py:1058",
    "tiled_argmin_cuda": "kmeans_tpu/ops/pallas_lloyd.py:1388",
    "tiled_fold_cuda": "kmeans_tpu/ops/pallas_lloyd.py:1484",
}
#: Hand-driven sweeps of each pruned flavour in the soundness check.
SOUND_SWEEPS = 20
#: Sweeps of the default-entry-point fit: the yinyang probe at sweep 16 and
#: its judgment at sweep 32 both run.
AUTO_SWEEPS = 48
#: The codebook fit's sweeps (the refresh and three delta sweeps) and the
#: hand-driven tiled Hamerly sweeps there.
CODEBOOK_SWEEPS = 4
CODEBOOK_HAMERLY_SWEEPS = 3


class SmokeFailure(RuntimeError):
    pass


def _check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def _sync():
    import torch

    torch.cuda.synchronize()


def _time_auto(fn):
    """CUDA-event milliseconds of ``fn()`` and its output: one timed launch
    when it takes a second or more, else the median of 3 more after it."""
    import torch

    _sync()
    times = []
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if times[0] >= 1000.0:
            break
    return (times[0] if len(times) == 1 else statistics.median(times[1:]),
            out)


def _time_ms(fn, reps):
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` runs after
    one warm-up run."""
    import torch

    fn()
    _sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 1-2
# ---------------------------------------------------------------------------

def phase_device():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = out.stdout.strip().splitlines()[0]
    print(card)
    return card


#: The Hopper core's variants as ptxas names them (the mangled
#: ``core_score_kernel<GATHER, SECOND>`` and, on the f32 route,
#: ``core32_score_kernel<GATHER, SECOND>``), and what runs each.
CORE_VARIANTS = {
    "core_score_kernelILb0ELb0E": "dense (K1, K2, K5)",
    "core_score_kernelILb0ELb1E": "dense with second-min (K5 for Hamerly)",
    "core_score_kernelILb1ELb1E": "gathered with second-min (K4)",
    "core32_score_kernelILb0ELb0E": "f32 dense (K1, K2, K5)",
    "core32_score_kernelILb0ELb1E":
        "f32 dense with second-min (K5 for Hamerly)",
    "core32_score_kernelILb1ELb1E": "f32 gathered with second-min (K4)",
}


def phase_build():
    from kmeans_tpu_torch.ops import _build

    info = _build.build()
    print(f"build: {info['seconds']:.1f} s (built now: {info['built']}) "
          f"-> {info['path']}")
    lines = info["ptxas"].splitlines()
    regs = [int(w.split()[0]) for line in lines
            for w in line.split("Used ")[1:] if "registers" in w]
    spills = [line.strip() for line in lines
              if "spill" in line and " 0 bytes spill stores" not in line]
    if regs:
        print(f"  ptxas: {len(regs)} kernels, at most {max(regs)} registers "
              f"a thread, {len(spills)} with spills")
    # Each core variant: the registers ptxas allocates a thread at launch
    # (setmaxnreg then moves them from the producer warpgroup to the
    # consumers) and its spills.
    name = None
    fold_regs, fold_spills = [], 0
    for line in lines:
        if "Compiling entry function" in line or "Function properties for" in line:
            name = line.split("'")[1] if "'" in line else line.split()[-1]
        variant = next((v for key, v in CORE_VARIANTS.items()
                        if name and key in name), None)
        if variant and ("spill" in line or "Used" in line):
            print(f"  core {variant}: {line.strip()}")
        if name and "fold_kernel" in name:
            fold_regs += [int(w.split()[0]) for w in line.split("Used ")[1:]
                          if "registers" in w]
            fold_spills += ("spill" in line
                            and " 0 bytes spill stores" not in line)
    if fold_regs:
        print(f"  fold core: {len(fold_regs)} fold_kernel variants, "
              f"{min(fold_regs)}-{max(fold_regs)} registers a thread, "
              f"{fold_spills} with spills")


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def _scores64(x, c, cd):
    """f64 scores ``||c||² + x_cd·(−2·c_cd)ᵀ`` and their scale
    ``||x_cd||² + ||c_cd||²``, which bounds the magnitude of the terms the
    f32 accumulation sums."""
    from kmeans_tpu_torch.ops.distance import sq_norms

    xc = x.to(cd).double()
    cc = c.to(cd).double()
    csq = sq_norms(c).double()
    s = csq + xc @ (-2.0 * cc).T
    scale = (xc * xc).sum(1)[:, None] + (cc * cc).sum(1)[None, :]
    return s, scale


def _near_min(name, s, scale, labels):
    """Each row's score at ``labels`` is within SCORE_RTOL of the row's
    scale above the row's f64 minimum.  Returns the chosen f64 scores and
    that tolerance per row."""
    lab = labels.long()
    _check(bool((lab >= 0).all() and (lab < s.shape[1]).all()),
           f"{name}: label out of range")
    chosen = s.gather(1, lab[:, None])[:, 0]
    tol = SCORE_RTOL * scale.gather(1, lab[:, None])[:, 0]
    gap = chosen - s.min(dim=1).values
    _check(bool((gap <= tol).all()),
           f"{name}: {int((gap > tol).sum())} rows chose a score above the "
           f"minimum by more than {SCORE_RTOL} of the row scale")
    return chosen, tol


def _check_labels(name, x, c, cd, labels, plain_labels, ties=False):
    """Kernel labels against the plain version's: they agree except on rows
    whose two choices both score within SCORE_RTOL of the f64 minimum (a
    tie to within the f32 accumulation order); with ``ties`` (every odd
    centroid a copy of the even one before it) every label is even, the
    lowest index of its exact tie.  Returns ``(f64 score at the kernel's
    label per row, its tolerance, rows where the labels differ)``."""
    if ties:
        _check(bool((labels % 2 == 0).all()),
               f"{name}: an exact tie went to the higher index")
    s, scale = _scores64(x, c, cd)
    chosen, tol = _near_min(name, s, scale, labels)
    _near_min(f"{name} (plain)", s, scale, plain_labels)
    return chosen, tol, int((labels != plain_labels).sum())


def _check_labels_rows(name, x, c, cd, labels, plain_labels):
    """:func:`_check_labels` for a large n: only the rows where the kernel
    and the plain version disagree are scored in f64, 1024 at a time."""
    rows = (labels != plain_labels).nonzero()[:, 0]
    for part in rows.split(1024):
        s, scale = _scores64(x[part], c, cd)
        _near_min(name, s, scale, labels[part])
        _near_min(f"{name} (plain)", s, scale, plain_labels[part])
    return int(rows.numel())


def _close(name, got, want, rtol=SUMS_RTOL):
    import torch

    atol = rtol * float(want.abs().max().clamp_min(1e-30))
    err = float((got - want).abs().max()) if got.numel() else 0.0
    _check(bool(torch.allclose(got, want, rtol=rtol, atol=atol)),
           f"{name}: max abs error {err} beyond rtol={rtol}, atol={atol}")
    return err


def _within(name, got, want, tol):
    """Per-row scores (or min_d2) that may differ only by the f32
    accumulation order of the score: ``|got − want| <= tol`` row by row,
    ``tol`` being SCORE_RTOL of each row's ``||x_cd||² + ||c||²``."""
    err = (got.double() - want.double()).abs()
    worst = float(err.max()) if err.numel() else 0.0
    _check(bool((err <= tol).all()),
           f"{name}: {int((err > tol).sum())} rows differ by more than "
           f"{SCORE_RTOL} of their row scale (max abs error {worst})")
    return worst


def _row_scale(x, c, cd, labels):
    """SCORE_RTOL·(||x_cd||² + ||c_cd[label]||²) per row, without an f32
    copy of x."""
    import torch

    from kmeans_tpu_torch.ops.distance import sq_norms

    x_sq = torch.cat([sq_norms(x[s:s + 65536].to(cd))
                      for s in range(0, x.shape[0], 65536)])
    return SCORE_RTOL * (x_sq + sq_norms(c.to(cd))[labels.long()])


def _case_inputs(gen, n, d, k, x_dtype, ties):
    import torch

    dev = "cuda"
    x = torch.randn(n, d, generator=gen, device=dev) * 2.0
    c = x[torch.randperm(n, generator=gen, device=dev)[:k]].clone()
    c += 0.3 * torch.randn(k, d, generator=gen, device=dev)
    if ties:
        # Exact duplicate centroids, and rows that sit on them: every
        # duplicate pair ties exactly, and the lower index must win.
        c[1::2] = c[0::2][: c[1::2].shape[0]]
        x[: k // 2] = c[0::2][: k // 2]
    w = (torch.rand(n, generator=gen, device=dev) > 0.2).float()
    prev = torch.randint(-1, k, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    return x.to(x_dtype).contiguous(), c, w, prev


def _second64(s, labels):
    """f64 least score over the columns other than ``labels``, and the
    column it sits at."""
    import torch

    masked = s.scatter(1, labels.long()[:, None], torch.inf)
    best = masked.min(dim=1)
    return best.values, best.indices


def _check_delta_fold(what, x, cd, w, prev, k, out, again, at):
    """K2's or K4's outputs ``out``, their delta at ``out[at]`` and
    ``out[at + 1]``: equal bit for bit to ``fold_core_plain`` over
    ``delta_fold_weights`` at their labels (the fold core's dual fold, in
    its order op by op), and a second launch ``again`` equal to ``out`` in
    every output."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    model = K.fold_core_plain(x, K.delta_fold_weights(out[0], prev, w),
                              out[0], prev, k, compute_dtype=cd)
    _check(all(torch.equal(a, b) for a, b in zip(out, again)),
           f"{what}: two launches differ")
    _check(bool(torch.equal(out[at], model[0])
                and torch.equal(out[at + 1], model[1])),
           f"{what}: the delta differs from fold_core_plain's order")


def _check_hamerly(name, x, c, cd, w, prev, gen, ties, k2):
    """K4 against its plain version at need fractions 0, about 10% and
    100% (−1 sentinels always needed).  Needed rows: labels near the f64
    minimum, sb within the score tolerance of the f64 score at the label,
    slb of the f64 least score over the other columns; other rows: prev,
    sb_in and slb_in passed through bit for bit; the signed fold against
    the plain fold at the kernel's labels; the counts exact; the delta
    ``fold_core_plain``'s bit for bit and a second launch the first in
    every output.  With every row needed, labels and sb equal K2's labels
    and raw scores bit for bit (``k2``).  Returns the rows labelled differently from the plain
    version."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    n, k = x.shape[0], c.shape[0]
    s, scale = _scores64(x, c, cd)
    sb_in = torch.randn(n, generator=gen, device="cuda") * 100
    slb_in = torch.randn(n, generator=gen, device="cuda") * 100
    moved = 0
    for frac in (0.0, 0.1, 1.0):
        p = prev.clamp_min(0) if frac == 0.0 else prev
        need = ((torch.rand(n, generator=gen, device="cuda") < frac)
                | (p < 0))
        what = f"K4 need={frac:.0%} {name}"
        args = (x, c, p, need, sb_in, slb_in)
        out = K.lloyd_hamerly_cuda(*args, weights=w, compute_dtype=cd)
        again = K.lloyd_hamerly_cuda(*args, weights=w, compute_dtype=cd)
        _sync()
        lab, sb, slb, dsums, dcounts, n_rec, dense = out
        _check_delta_fold(what, x, cd, w, p, k, out, again, 3)
        plain = K.lloyd_hamerly_plain(x, c, p, need, sb_in, slb_in,
                                      weights=w, compute_dtype=cd)
        keep = ~need
        _check(bool(torch.equal(lab[keep], p[keep])
                    and torch.equal(sb[keep], sb_in[keep])
                    and torch.equal(slb[keep], slb_in[keep])),
               f"{what}: rows not needed were not passed through")
        if bool(need.any()):
            if ties:
                _check(bool((lab[need] % 2 == 0).all()),
                       f"{what}: an exact tie went to the higher index")
            sn, scn = s[need], scale[need]
            chosen, tol = _near_min(what, sn, scn, lab[need])
            _near_min(f"{what} (plain)", sn, scn, plain[0][need])
            _within(f"{what} sb", sb[need], chosen, tol)
            second, col = _second64(sn, lab[need])
            _within(f"{what} slb", slb[need], second,
                    SCORE_RTOL * scn.gather(1, col[:, None])[:, 0])
            moved = max(moved, int((lab != plain[0]).sum()))
        changed = need & (lab != p) & (w > 0)
        add = K.accumulate_plain(x, torch.where(changed, lab, -1), k,
                                 weights=w, compute_dtype=cd)
        sub = K.accumulate_plain(x, torch.where(changed, p, -1), k,
                                 weights=w, compute_dtype=cd)
        _close(f"{what} dsums", dsums, add[0] - sub[0])
        _check(bool(torch.equal(dcounts, add[1] - sub[1])),
               f"{what} dcounts")
        _check(int(n_rec) == int(need.sum()) == int(plain[5]),
               f"{what} n_recomputed")
        _check(int(dense) == int(K._dense_tiles(need, K.HAMERLY_SLOTS))
               == int(plain[6]), f"{what} dense_tiles")
        if frac == 1.0:
            _check(bool(torch.equal(lab, k2[0]) and torch.equal(sb, k2[1])),
                   f"{what}: labels or sb differ from K2's raw scores")
    return moved


def _check_tiled(name, x, c, cd, w, prev, ties, k_tile=128):
    """K5 and K6 against their plain versions at ``k_tile``-wide slices.
    K5: labels near the f64 minimum (the lower index of an exact tie), raw
    scores and second-min within the score tolerance, and labels, raw
    scores, normed min and second-min equal to K2's, K1's and K4's bit for
    bit (the same score loop).  K6: the single fold at K5's labels with half
    the rows moved to one label and some to −1, and the dual fold against
    ``prev``: sums within SUMS_RTOL of the plain version's, counts exact,
    and a second launch equal bit for bit.  Returns the rows labelled
    differently from the plain version."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    n, k = x.shape[0], c.shape[0]
    what = f"K5 k_tile={k_tile} {name}"
    neg2c, csq = K._score_operands(c, cd)
    lab, raw, sec = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                        raw_scores=True, with_second=True)
    normed = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile)[1]
    k1 = K.lloyd_pass_cuda(x, c, compute_dtype=cd, with_update=False)
    k2 = K.lloyd_delta_cuda(x, c, prev, compute_dtype=cd, with_mind=False)
    ones = torch.ones(n, dtype=torch.bool, device="cuda")
    zeros = torch.zeros(n, device="cuda")
    k4 = K.lloyd_hamerly_cuda(x, c, prev, ones, zeros, zeros,
                              compute_dtype=cd)
    _sync()
    plain = K.tiled_argmin_plain(x, neg2c, csq, k_tile=k_tile,
                                 raw_scores=True, with_second=True)
    chosen, tol, moved = _check_labels(what, x, c, cd, lab, plain[0], ties)
    _within(f"{what} raw", raw, chosen, tol)
    s, scale = _scores64(x, c, cd)
    second, col = _second64(s, lab)
    _within(f"{what} second", sec, second,
            SCORE_RTOL * scale.gather(1, col[:, None])[:, 0])
    _check(bool(torch.equal(lab, k2[0]) and torch.equal(raw, k2[1])
                and torch.equal(normed, k1[1]) and torch.equal(sec, k4[2])),
           f"{what}: labels, scores or second-min differ from K1/K2/K4's")
    lab3 = lab.clone()
    lab3[::2] = k // 2
    lab3[1::7] = -1
    for lab2 in (None, prev):
        fold = f"K6 {'dual' if lab2 is not None else 'single'} {name}"
        got = K.tiled_fold_cuda(x, w, lab3, lab2, k, compute_dtype=cd)
        again = K.tiled_fold_cuda(x, w, lab3, lab2, k, compute_dtype=cd)
        _sync()
        want = K.tiled_fold_plain(x, w, lab3, lab2, k, compute_dtype=cd,
                                  k_tile=k_tile)
        _check(bool(torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1])),
               f"{fold}: two launches differ")
        _close(f"{fold} sums", got[0], want[0])
        _check(bool(torch.equal(got[1], want[1])), f"{fold} counts")
    return moved


def _straddling_tie_cases(gen):
    """Duplicate centroids at columns 127 and 128, on either side of a
    128-column slice edge, and rows that sit on them: K5 must give 127."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    for xd, cd in ((torch.float32, torch.float32),
                   (torch.bfloat16, torch.bfloat16)):
        x, c, w, prev = _case_inputs(gen, 2053, 2048, 256, xd, False)
        c[128] = c[127]
        x[:64] = c[127].to(xd)
        name = f"n=2053 d=2048 k=256 x={str(xd)[6:]} tie at the slice edge"
        _check_tiled(name, x, c, cd, w, prev, False)
        lab = K.tiled_argmin_cuda(x, *K._score_operands(c, cd), k_tile=128)[0]
        _check(bool((lab[:64] == 127).all()),
               f"K5 {name}: the tie did not go to column 127")
        print(f"  ok {name}")


class _ForcedScoreBlock:
    """Within it, K1, K2, K4 and K5 score every input with ``score_block``
    (the parent's f32 route): the wrappers read
    ``cuda_lloyd.scoring_core`` at each call."""

    def __enter__(self):
        from kmeans_tpu_torch.ops import cuda_lloyd as K

        self._rule = K.scoring_core
        K.scoring_core = lambda *args: "score_block"

    def __exit__(self, *exc):
        from kmeans_tpu_torch.ops import cuda_lloyd as K

        K.scoring_core = self._rule


#: Worst relative score error against the f64 product, (error / (||x||² +
#: ||c||²), d, case), of the f32 route over phase 3's f32 cases.
F32_ERRORS = []


def _f32_score_error(x, c, lab, raw):
    """max |raw − f64 score at lab| / (||x||² + ||c[lab]||²) over rows."""
    s, scale = _scores64(x, c, x.dtype)
    at = lab.long()[:, None]
    return float(((raw.double() - s.gather(1, at)[:, 0]).abs()
                  / scale.gather(1, at)[:, 0]).max())


def _record_f32_errors(name, x, c, prev):
    """K2's raw scores on the f32 route against the f64 product, into
    F32_ERRORS."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    lab, raw = K.lloyd_delta_cuda(x, c, prev, compute_dtype=torch.float32,
                                  with_mind=False)[:2]
    _sync()
    F32_ERRORS.append((_f32_score_error(x, c, lab, raw), x.shape[1], name))


def _check_k1_repeats(name, x, c, cd, w, k1):
    """A second K1 launch equals the first ``k1`` bit for bit, sums and
    counts included (the fold core)."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    again = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=cd)
    _sync()
    _check(all(torch.equal(a, b) for a, b in zip(k1[:4], again[:4])),
           f"K1 {name}: two launches differ")


def _check_cores_agree(name, x, c, cd, w, prev, k1, k2):
    """On an input the Hopper core takes: K1's labels and min_d2 and K2's
    labels and raw scores (``k1``, ``k2``) against ``score_block``'s on the
    same input -- in bf16 bit for bit; on the f32 route (six bf16 passes
    against IEEE f32 FMA) labels equal except near-ties within SCORE_RTOL
    and scores within SCORE_RTOL of the row scale."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    with _ForcedScoreBlock():
        sb1 = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=cd)
        sb2 = K.lloyd_delta_cuda(x, c, prev, weights=w, compute_dtype=cd,
                                 with_mind=False)
    _sync()
    if cd == torch.bfloat16:
        _check(torch.equal(k1[0], sb1[0]) and torch.equal(k1[1], sb1[1]),
               f"K1 {name}: the Hopper core's labels or min_d2 differ from "
               "score_block's")
        _check(torch.equal(k2[0], sb2[0]) and torch.equal(k2[1], sb2[1]),
               f"K2 {name}: the Hopper core's labels or raw scores differ "
               "from score_block's")
        return
    chosen, tol, _ = _check_labels(f"K2 {name} vs score_block", x, c, cd,
                                   k2[0], sb2[0])
    same = k2[0] == sb2[0]
    _within(f"K2 {name} raw scores vs score_block", k2[1][same],
            sb2[1][same], tol[same])
    _check(torch.equal(k1[0], k2[0]), f"K1 {name}: labels differ from K2's "
           "on the core")


def _check_core_k4_k5(name, x, c, cd, w, prev, gen):
    """On an input the Hopper core takes: K4 at need fractions 0, about 10%
    and 100% (−1 sentinels needed) and K5 at k_tile 128, 384 and 1024,
    with the second-min, against ``score_block``'s on the same input --
    K4's labels, sb, slb, n_recomputed and dense_tiles, K5's labels, raw
    min, second-min and normed min: bit for bit in bf16; on the f32 route
    n_recomputed, dense_tiles and the labels of rows that are no near-tie
    equal, the scores within SCORE_RTOL of the row scale -- and two
    launches of each equal bit for bit in every output, K4's delta sums
    and counts included."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    n = x.shape[0]
    exact = cd == torch.bfloat16
    s64, scale = _scores64(x, c, cd)

    def agree(what, got, ref, kinds, rows=None):
        """``got`` against ``ref`` entry by entry, over ``rows`` (a mask;
        all rows when None) where the f32 route compares to a tolerance:
        labels near the f64 minimum, scores of rows whose labels agree
        within SCORE_RTOL of the row's largest scale."""
        for g, e, kind in zip(got, ref, kinds):
            if kind is None:
                continue
            if exact or kind in ("n_recomputed", "dense_tiles"):
                _check(torch.equal(g, e), f"{what}: the core's {kind} "
                       "differ from score_block's")
                continue
            r = torch.ones(n, dtype=torch.bool, device="cuda") \
                if rows is None else rows
            _check(torch.equal(g[~r], e[~r]),
                   f"{what}: rows not scored differ in {kind}")
            if kind == "labels":
                _near_min(what, s64[r], scale[r], g[r])
                continue
            keep = got[0][r] == ref[0][r]
            tol = SCORE_RTOL * scale[r].max(dim=1).values
            _within(f"{what} {kind}", g[r][keep], e[r][keep], tol[keep])

    sb_in = torch.randn(n, generator=gen, device="cuda")
    k4_out = ("labels", "sb", "slb", None, None, "n_recomputed", "dense_tiles")
    for frac in (0.0, 0.1, 1.0):
        p = prev.clamp_min(0) if frac == 0.0 else prev
        need = ((torch.rand(n, generator=gen, device="cuda") < frac)
                | (p < 0))
        args = (x, c, p, need, sb_in, sb_in + 1)
        with _ForcedScoreBlock():
            ref = K.lloyd_hamerly_cuda(*args, weights=w, compute_dtype=cd)
        first = K.lloyd_hamerly_cuda(*args, weights=w, compute_dtype=cd)
        again = K.lloyd_hamerly_cuda(*args, weights=w, compute_dtype=cd)
        _sync()
        what = f"K4 need={frac:.0%} {name}"
        _check(all(torch.equal(a, b) for a, b in zip(first, again)),
               f"{what}: two launches differ")
        agree(what, first, ref, k4_out, need)
    neg2c, csq = K._score_operands(c, cd)

    def k5(k_tile):
        return (*K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                     raw_scores=True, with_second=True),
                K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile)[1])

    for k_tile in (128, 384, 1024):
        with _ForcedScoreBlock():
            ref = k5(k_tile)
        first, again = k5(k_tile), k5(k_tile)
        _sync()
        what = f"K5 k_tile={k_tile} {name}"
        _check(all(torch.equal(a, b) for a, b in zip(first, again)),
               f"{what}: two launches differ")
        agree(what, first, ref, ("labels", "raw min", "second-min",
                                 "normed min"))


def _core_range_edge_ties(gen, cd):
    """Duplicate centroids on either side of the core's sub-slice edges
    inside a range (255 | 256 at k_tile 384 and 1024, 511 | 512 at 1024;
    on the f32 route's 128-column sub-slices also 127 | 128 inside 384 and
    1024) and of range edges (127 | 128 at k_tile 128, 383 | 384 at 128
    and 384, 1023 | 1024 at 128 and 1024), at k = 1100, and rows that sit
    on them: K4 with every row needed and K5 at each k_tile give the lower
    index with second-min == min, and the core agrees with score_block
    (bit for bit in bf16)."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    x, c, w, prev = _case_inputs(gen, 2053, 2048, 1100, cd, False)
    pairs = ((127, 128), (255, 256), (383, 384), (511, 512), (1023, 1024))
    for i, (lo, hi) in enumerate(pairs):
        c[hi] = c[lo]
        x[16 * i:16 * (i + 1)] = c[lo].to(cd)
    name = (f"n=2053 d=2048 k=1100 x={str(cd)[6:]} ties at sub-slice and "
            "range edges")
    _check(K.scoring_core(x, cd, c.to(cd)) == "wgmma",
           f"{name}: not on the Hopper core")
    _check_core_k4_k5(name, x, c, cd, w, prev, gen)
    n = x.shape[0]
    ones = torch.ones(n, dtype=torch.bool, device="cuda")
    zeros = torch.zeros(n, device="cuda")
    k4 = K.lloyd_hamerly_cuda(x, c, prev, ones, zeros, zeros,
                              compute_dtype=cd)
    outs = [("K4", k4[:3])]
    neg2c, csq = K._score_operands(c, cd)
    for k_tile in (128, 384, 1024):
        outs.append((f"K5 k_tile={k_tile}",
                     K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                         raw_scores=True, with_second=True)))
    _sync()
    for what, (lab, best, second) in outs:
        for i, (lo, hi) in enumerate(pairs):
            rows = slice(16 * i, 16 * (i + 1))
            _check(bool((lab[rows] == lo).all()),
                   f"{what} {name}: the tie at {lo} | {hi} did not go to {lo}")
            _check(torch.equal(second[rows], best[rows]),
                   f"{what} {name}: second-min != min on the tie at {lo}")
    print(f"  ok {name} (core wgmma)")


def _slice_edge_core_ties(gen, cd):
    """Duplicate centroids on either side of the core's slice edge (255 |
    256; on the f32 route also its 128-column sub-slice edge 127 | 128),
    and rows that sit on them: K1 and K2 must give the lower index.  k =
    257 leaves the last slice one column; k = 1000 is the headline's
    width."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    pairs = ((255, 256),) if cd == torch.bfloat16 else ((127, 128),
                                                        (255, 256))
    for k in (257, 1000):
        x, c, w, prev = _case_inputs(gen, 2053, 2048, k, cd, False)
        for i, (lo, hi) in enumerate(pairs):
            c[hi] = c[lo]
            x[64 * i:64 * (i + 1)] = c[lo].to(cd)
        name = (f"n=2053 d=2048 k={k} x={str(cd)[6:]} ties at the core's "
                "slice edges")
        _check(K.scoring_core(x, cd, c.to(cd)) == "wgmma",
               f"{name}: not on the Hopper core")
        k1 = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=cd)
        k2 = K.lloyd_delta_cuda(x, c, prev, weights=w, compute_dtype=cd,
                                with_mind=False)
        _sync()
        for i, (lo, _) in enumerate(pairs):
            rows = slice(64 * i, 64 * (i + 1))
            _check(bool((k1[0][rows] == lo).all()
                        and (k2[0][rows] == lo).all()),
                   f"{name}: the tie did not go to column {lo}")
        _check_labels(f"K1 {name}", x, c, cd, k1[0],
                      K.lloyd_pass_plain(x, c, compute_dtype=cd)[0])
        _check_k1_repeats(name, x, c, cd, w, k1)
        _check_cores_agree(name, x, c, cd, w, prev, k1, k2)
        print(f"  ok {name} (core wgmma)")


#: The fold core's cases: (n, d, k, x dtype, compute dtype, every row on
#: one label).  d = 300 takes the column-strided loads, d = 4104 three
#: 2048-column spans, k = 1 one bucket.
FOLD_CORE_CASES = (
    (2053, 2048, 1000, "bfloat16", "bfloat16", False),
    (2053, 2048, 1000, "bfloat16", "bfloat16", True),
    (2053, 300, 1000, "bfloat16", "bfloat16", False),
    (2053, 100, 1000, "float32", "float32", False),
    (2053, 100, 3, "float32", "bfloat16", False),
    (1031, 4104, 7, "bfloat16", "bfloat16", False),
    (1031, 64, 1, "bfloat16", "bfloat16", False),
)


def _fold_core_cases(gen):
    """K6's single and dual folds, K3 and K1's fold on the fold core, with
    labels outside [0, k), zero weights and (dual) rows with equal labels:
    each equal bit for bit to ``fold_core_plain`` (the core's order, op by
    op) and to a second launch; K3's and K1's sums and counts equal to K6's
    single fold's at the same labels bit for bit; each within SUMS_RTOL of
    its plain version, counts exact, K3's min_d2 within rtol 1e-5 and
    K1's within 1e-5 of ||x||² of its own raw score plus the plain
    ||x||² (the raw score is the scoring core's, which the fold does not
    touch)."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    for n, d, k, xd, cdn, one_label in FOLD_CORE_CASES:
        xd, cd = getattr(torch, xd), getattr(torch, cdn)
        x, c, w, prev = _case_inputs(gen, n, d, k, xd, False)
        lab = torch.randint(-2, k + 2, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        if one_label:
            lab[3:] = k // 2
        lab2 = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.3,
                           lab, prev)
        scores = torch.randn(n, generator=gen, device="cuda")
        name = (f"n={n} d={d} k={k} x={str(xd)[6:]} cd={cdn}"
                f"{' one label' if one_label else ''}")
        outs = {}
        for mode, l2 in (("single", None), ("dual", lab2)):
            what = f"fold core K6 {mode} {name}"
            got = K.tiled_fold_cuda(x, w, lab, l2, k, compute_dtype=cd)
            again = K.tiled_fold_cuda(x, w, lab, l2, k, compute_dtype=cd)
            _sync()
            model = K.fold_core_plain(x, w, lab, l2, k, compute_dtype=cd)
            plain = K.tiled_fold_plain(x, w, lab, l2, k, compute_dtype=cd)
            _check(all(torch.equal(g, a) for g, a in zip(got, again)),
                   f"{what}: two launches differ")
            _check(all(torch.equal(g, m) for g, m in zip(got, model)),
                   f"{what}: differs from fold_core_plain's order")
            _close(f"{what} sums", got[0], plain[0])
            _check(bool(torch.equal(got[1], plain[1])), f"{what} counts")
            outs[mode] = got
        what = f"fold core K3 {name}"
        k3 = K.accumulate_cuda(x, lab, k, scores=scores, weights=w,
                               compute_dtype=cd)
        k3b = K.accumulate_cuda(x, lab, k, scores=scores, weights=w,
                                compute_dtype=cd)
        _sync()
        plain = K.accumulate_plain(x, lab, k, scores=scores, weights=w,
                                   compute_dtype=cd)
        _check(all(torch.equal(a, b) for a, b in zip(k3, k3b)),
               f"{what}: two launches differ")
        _check(bool(torch.equal(k3[0], outs["single"][0])
                    and torch.equal(k3[1], outs["single"][1])),
               f"{what}: sums or counts differ from K6's single fold")
        _close(f"{what} min_d2", k3[2], plain[2], rtol=1e-5)
        what = f"fold core K1 {name}"
        k1 = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=cd)
        at = K.tiled_fold_cuda(x, w, k1[0], None, k, compute_dtype=cd)
        _sync()
        _check(bool(torch.equal(k1[2], at[0]) and torch.equal(k1[3], at[1])),
               f"{what}: sums or counts differ from K6's single fold at its "
               "labels")
        raw = K.lloyd_pass_cuda(x, c, compute_dtype=cd, with_update=False,
                                raw_scores=True)[1]
        sq = x.float().pow(2).sum(1)
        _within(f"{what} min_d2", k1[1], (raw + sq).clamp_min(0), 1e-5 * sq)
        print(f"  ok {what}: K6 single and dual, K3 and K1 equal "
              "fold_core_plain and each other bit for bit")


#: The TP hooks' cases (d, x dtype, compute dtype): the Hopper core in
#: bf16 (d % 8 == 0), its f32 route (d % 4 == 0) and ``score_block``.
TP_HOOK_CASES = ((2048, "bf16", "bf16"), (300, "f32", "f32"),
                 (100, "f32", "bf16"))


def _tp_hook_cases(gen):
    """The sharded TP body's kernel hooks on the card, each held against
    its plain version: two model ranks' slices of 500 of k = 1000 columns,
    k_real = 997 (the last three columns of the second slice masked by
    ``valid_cols``); K1 in raw-score mode on each slice, untiled and on the
    tiled route (K5 at 128-column slices); the two slices resolved as the
    two MIN all-reduces resolve them (the value, then the lowest index),
    which must give one card's K1 labels over the 997 columns but ties;
    then K3 with the resolved scores and each slice's relative labels
    (rows won by the other slice fall outside ``[0, 500)`` and drop),
    untiled and on K6 (``k_tile``).  Returns the number of cases."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    n, k, k_loc, k_real = 2053, 1000, 500, 997
    n_cases = 0
    for d, xd, cd in TP_HOOK_CASES:
        xd, cd = dt[xd], dt[cd]
        x, c, w, _ = _case_inputs(gen, n, d, k, xd, False)
        core = K.scoring_core(x, cd, c.to(cd))
        head = f"n={n} d={d} x={str(xd)[6:]} cd={str(cd)[6:]} core {core}"
        labs, raws = [], []
        for m in range(2):
            cl = c[m * k_loc:(m + 1) * k_loc]
            valid = (m * k_loc + torch.arange(k_loc, device="cuda")) < k_real
            live = int(valid.sum())
            for k_tile in (None, 128):
                name = (f"K1 valid_cols raw_scores {head} slice {m} "
                        f"k_tile {k_tile}")
                kw = dict(valid_cols=valid, with_update=False,
                          raw_scores=True, compute_dtype=cd, k_tile=k_tile)
                lab, raw, _, _, _ = K.lloyd_pass_cuda(x, cl, **kw)
                _sync()
                plab, praw, _, _, _ = K.lloyd_pass_plain(x, cl, **kw)
                _check(int(lab.max()) < live,
                       f"{name}: a masked column won")
                chosen, tol, _ = _check_labels(name, x, cl[:live], cd, lab,
                                               plab)
                _within(f"{name} raw scores", raw, chosen, tol)
                _within(f"{name} raw scores (plain)", praw, chosen, tol)
                n_cases += 1
                if k_tile is None:
                    labs.append(lab)
                    raws.append(raw)
        g = torch.minimum(raws[0], raws[1])
        cand = [torch.where(raws[m] == g, labs[m] + m * k_loc, k)
                for m in range(2)]
        lab_g = torch.minimum(cand[0], cand[1]).to(torch.int32)
        one = K.lloyd_pass_cuda(x, c[:k_real], with_update=False,
                                compute_dtype=cd)[0]
        _sync()
        _check_labels(f"TP resolve {head}", x, c[:k_real], cd, lab_g, one)
        for m in range(2):
            rel = lab_g - m * k_loc
            for k_tile in (None, 128):
                name = f"K3 given scores {head} slice {m} k_tile {k_tile}"
                kw = dict(scores=g, weights=w, compute_dtype=cd,
                          k_tile=k_tile)
                s3, c3, m3 = K.accumulate_cuda(x, rel, k_loc, **kw)
                _sync()
                ps3, pc3, pm3 = K.accumulate_plain(x, rel, k_loc, **kw)
                _close(f"{name} sums", s3, ps3)
                _check(bool(torch.equal(c3, pc3)), f"{name} counts")
                _close(f"{name} min_d2", m3, pm3, rtol=1e-5)
                n_cases += 1
        print(f"  ok TP hooks {head}: K1 / K5 with valid_cols in raw-score "
              "mode and K3 / K6 with given scores against their plain "
              "versions, the resolved labels one card's K1 labels but ties")
    return n_cases


def phase_kernels():
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.plan import core_takes

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [(n, d, k, xd, cd, False)
             for d in (2, 100, 2048) for k in (3, 1000)
             for (xd, cd) in ((f32, f32), (bf16, bf16), (f32, bf16))
             for n in (2053,)]
    cases += [(1531, 64, 10, f32, f32, True), (1531, 64, 10, bf16, bf16, True),
              (2053, 2048, 1000, bf16, bf16, True),
              (2053, 2048, 1000, f32, f32, True)]
    # The Hopper core's ragged shapes: n % 128 != 0; d a multiple of 8 (4
    # in f32, whose −2C pieces pad to 8) but not of 64; k = 257 (a last
    # slice of one column), k = 3 (one ragged slice).
    cases += [(2053, d, k, bf16, bf16, False)
              for d in (8, 200) for k in (3, 257, 1000)]
    cases += [(2053, d, k, f32, f32, False)
              for d in (4, 300) for k in (3, 257, 1000)]
    cases += [(2053, 2048, 257, bf16, bf16, False),
              (2053, 2048, 257, f32, f32, False)]
    cores = {}
    for n, d, k, xd, cd, ties in cases:
        x, c, w, prev = _case_inputs(gen, n, d, k, xd, ties)
        core = K.scoring_core(x, cd, c.to(cd))
        cores[core] = cores.get(core, 0) + 1
        _check(core == ("wgmma" if core_takes("classic", d, xd.itemsize,
                                              cd.itemsize)
                        else "score_block"),
               f"n={n} d={d} k={k} x={xd} cd={cd}: scoring core {core} "
               "against the rule")
        name = (f"n={n} d={d} k={k} x={str(xd)[6:]} cd={str(cd)[6:]}"
                f"{' ties' if ties else ''}")
        xf = x.float()
        # K1
        lab, mind, sums, counts, _ = k1 = K.lloyd_pass_cuda(
            x, c, weights=w, compute_dtype=cd)
        _sync()
        plain = K.lloyd_pass_plain(x, c, weights=w, compute_dtype=cd)
        chosen, tol, moved = _check_labels(f"K1 {name}", x, c, cd, lab,
                                           plain[0], ties)
        row_sq = (xf.double() ** 2).sum(1)
        _within(f"K1 min_d2 {name}", mind, (chosen + row_sq).clamp_min(0),
                tol)
        ps, pc, _ = K.accumulate_plain(x, lab, k, weights=w, compute_dtype=cd)
        _close(f"K1 sums {name}", sums, ps)
        _check(bool(torch.equal(counts, pc)), f"K1 counts {name}")
        lab0, _, s0, c0, _ = K.lloyd_pass_cuda(x, c, compute_dtype=cd,
                                               with_update=False)
        _sync()
        _check(bool(torch.equal(lab0, lab)) and not s0.any()
               and not c0.any(), f"K1 with_update=False {name}")
        # K2, with_mind both ways; prev holds −1 sentinels.
        for with_mind in (True, False):
            kw = dict(weights=w, compute_dtype=cd, with_mind=with_mind)
            out = K.lloyd_delta_cuda(x, c, prev, **kw)
            again = K.lloyd_delta_cuda(x, c, prev, **kw)
            _sync()
            lab2, mind2, dsums, dcounts, _, n_ch, dense = out
            k2 = (lab2, mind2)
            _check_delta_fold(f"K2 {name}", x, cd, w, prev, k, out, again, 2)
            plain2 = K.lloyd_delta_plain(x, c, prev, weights=w,
                                         compute_dtype=cd,
                                         with_mind=with_mind)
            chosen2, tol2, moved2 = _check_labels(f"K2 {name}", x, c, cd,
                                                  lab2, plain2[0], ties)
            moved = max(moved, moved2)
            want_mind = (chosen2 + row_sq).clamp_min(0) if with_mind \
                else chosen2
            _within(f"K2 min_d2 {name}", mind2, want_mind, tol2)
            changed = (lab2 != prev) & (w > 0)
            _check(int(n_ch) == int(changed.sum()), f"K2 n_changed {name}")
            _check(int(dense) == int(K._dense_tiles(changed)),
                   f"K2 dense_tiles {name}")
            add = K.accumulate_plain(
                x, torch.where(changed, lab2, -1), k, weights=w,
                compute_dtype=cd)
            sub = K.accumulate_plain(
                x, torch.where(changed, prev, -1), k, weights=w,
                compute_dtype=cd)
            _close(f"K2 dsums {name}", dsums, add[0] - sub[0])
            _check(bool(torch.equal(dcounts, add[1] - sub[1])),
                   f"K2 dcounts {name}")
        _check_k1_repeats(name, x, c, cd, w, k1)
        if core == "wgmma":
            _check_cores_agree(name, x, c, cd, w, prev, k1, k2)
            _check_core_k4_k5(name, x, c, cd, w, prev, gen)
            if cd == f32:
                _record_f32_errors(name, x, c, prev)
        # K3 with out-of-range labels and scores.
        lab3 = torch.randint(-2, k + 3, (n,), generator=gen, device="cuda",
                             dtype=torch.int32)
        scores = torch.randn(n, generator=gen, device="cuda")
        s3, c3, m3 = K.accumulate_cuda(x, lab3, k, scores=scores, weights=w,
                                       compute_dtype=cd)
        _sync()
        ps3, pc3, pm3 = K.accumulate_plain(x, lab3, k, scores=scores,
                                           weights=w, compute_dtype=cd)
        _close(f"K3 sums {name}", s3, ps3)
        _check(bool(torch.equal(c3, pc3)), f"K3 counts {name}")
        _close(f"K3 min_d2 {name}", m3, pm3, rtol=1e-5)
        # K4 at three need fractions; k2 holds K2's with_mind=False run.
        moved = max(moved, _check_hamerly(name, x, c, cd, w, prev, gen,
                                          ties, k2))
        # K5 and K6 at 128-column slices: k = 1000 leaves a ragged last
        # slice of 104 columns, k = 3 one ragged slice.
        moved = max(moved, _check_tiled(name, x, c, cd, w, prev, ties))
        print(f"  ok {name}, core {core} ({moved} rows labelled differently "
              "from the plain version, each a tie within the tolerance)")
    _straddling_tie_cases(gen)
    for cd in (bf16, f32):
        _slice_edge_core_ties(gen, cd)
        _core_range_edge_ties(gen, cd)
    _fold_core_cases(gen)
    n_tp = _tp_hook_cases(gen)
    print(f"scoring cores over the cases: {cores}; the Hopper core's labels, "
          "min_d2, raw scores, sb, slb and second-min (K1, K2, K4, K5 at "
          "k_tile 128, 384, 1024) equal score_block's bit for bit in bf16 "
          "and to SCORE_RTOL on the f32 route, K4's and K5's equal K1's and "
          "K2's bit for bit, and two launches of K1, K2, K4 and K5 equal each "
          "other bit for bit, K2's and K4's delta fold_core_plain's")
    _f32_error_summary()
    print(f"kernels vs plain: "
          f"{len(cases) + 8 + len(FOLD_CORE_CASES) + n_tp} cases agree "
          "(score rtol "
          f"{SCORE_RTOL}, sums rtol {SUMS_RTOL}, counts exact; K5 equal to "
          "K1, K2 and K4 bit for bit; K2's, K4's and K6's sums equal to "
          "themselves and fold_core_plain bit for bit)")


def _gamma(d):
    """The f32 accumulation bound of a score at width d, relative to
    ||x||² + ||c||²: γ = (d + 2)·2⁻²⁴ -- the d products and the epilogue's
    two adds (the corrections into x1c1, then csq) -- the bound
    HAMERLY_MARGIN_REL covers (γ_d ≈ d·2⁻²⁴ in ``ops/hamerly.py``)."""
    return (d + 2) * 2.0 ** -24


def _f32_error_summary():
    """The worst f32-route error over phase 3's f32 cases; it must stay
    within SCORE_RTOL and :func:`_gamma` of the row scale."""
    errs = F32_ERRORS
    worst = max(errs)
    print(f"f32 route: worst |score − f64| / (||x||² + ||c||²) over "
          f"{len(errs)} cases {worst[0]:.3e} (d={worst[1]}: {worst[2]}); "
          "per d: " + ", ".join(
              f"d={d} {max(e for e, dd, _ in errs if dd == d):.3e}"
              for d in sorted({dd for _, dd, _ in errs})))
    for rel, d, name in errs:
        _check(rel <= min(SCORE_RTOL, _gamma(d)),
               f"f32 route {name}: score error {rel:.3e} of the row scale "
               f"beyond min(SCORE_RTOL, γ = {_gamma(d):.3e})")


# ---------------------------------------------------------------------------
# Phase 4: the slice at full width
# ---------------------------------------------------------------------------

def _bound_ms(bytes_moved, tensor_ops=0.0, f32_ops=0.0):
    """(least ms for the work, "bytes" | "operations")."""
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    t_ops = max(tensor_ops / BF16_TENSOR_OPS_PER_S, f32_ops / F32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _kernel_row(name, launches, ms, plain_ms, library_ms, err, bytes_moved,
                tensor_ops, f32_ops, what=""):
    """One entry of the ``{"kernels": [...]}`` line, printed as it is
    made; ``library_ms`` may be None.  ``what`` names the row's compute
    (and shape) where the wrapper ``name`` has more than one row."""
    bound, by = _bound_ms(bytes_moved, tensor_ops, f32_ops)
    lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
    label = f"{name} ({what})" if what else name
    print(f"{label}: {launches} launches, {ms:.3f} ms (bound {bound:.3f} ms "
          f"by {by}), plain {plain_ms:.3f} ms, library {lib}, max abs err "
          f"vs plain {err:.3e}")
    return {"name": label, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


def phase_headline():
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.update import apply_update

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=bf16)
    gen = torch.Generator(device="cuda").manual_seed(1)
    c0 = random_init(gen, x, k)
    _sync()
    print(f"headline data: n={n} d={d} k={k} bf16, "
          f"{time.perf_counter() - t0:.2f} s to make")
    core = K.scoring_core(x, bf16, c0.to(bf16))
    print(f"scoring core of K1 and K2 at the headline shape: {core}")
    _check(core == "wgmma", "the headline shape does not take the Hopper core")

    # The main path, in three runs, each with the counts set to 0 just
    # before it and read just after: the delta fit (K1 and K2 only), the
    # public delta sweep's refresh branch (K2, then K3) and the default
    # entry point (the adaptive loop: K1, K2 and K4).
    torch.cuda.reset_peak_memory_stats()
    cfg = kt.KMeansConfig(k=k, update="delta", compute_dtype="bfloat16")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state = kt.fit_lloyd(x, k, config=cfg, init=c0, max_iter=20, tol=-1.0)
    _sync()
    fit_s = time.perf_counter() - t0
    fit_launches = K.launch_counts()
    K.reset_launch_counts()
    refresh = kt.delta_pass(x, state.centroids, state.labels,
                            torch.zeros(k, d, device="cuda"),
                            torch.zeros(k, device="cuda"),
                            compute_dtype="bfloat16", force_full=True)
    _sync()
    refresh_launches = K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_iter = int(state.n_iter)
    print(f"fit_lloyd(update='delta', max_iter=20, tol=-1): {n_iter} sweeps "
          f"+ final view in {fit_s:.3f} s = {n_iter / fit_s:.3f} iter/s "
          f"(final view included); inertia {float(state.inertia):.6e}")
    print(f"launches in fit_lloyd: {fit_launches}")
    print(f"launches in delta_pass(force_full=True): {refresh_launches}")
    print(f"peak device memory: {peak_gb:.3f} GB")
    _check(fit_launches["lloyd_pass_cuda"] >= 3,
           "K1 launched fewer than 3 times in the fit")
    _check(fit_launches["lloyd_delta_cuda"] >= 17,
           "K2 launched fewer than 17 times in the fit")
    _check(fit_launches["accumulate_cuda"] == 0,
           "the fit's sweeps launched K3")
    _check(refresh_launches["accumulate_cuda"] >= 1
           and refresh_launches["lloyd_delta_cuda"] >= 1,
           "delta_pass(force_full=True) did not launch K2 and K3")
    _check(not any(fit_launches[t] or refresh_launches[t]
                   for t in ("tiled_argmin_cuda", "tiled_fold_cuda")),
           "the headline shape planned untiled, but K5 or K6 launched")
    _check(n_iter == 20 and bool(torch.isfinite(state.centroids).all())
           and bool(torch.isfinite(state.inertia)),
           "headline fit: wrong sweep count or non-finite result")
    _check(int(refresh[3].sum()) == n
           and bool(torch.isfinite(refresh[2]).all()),
           "delta_pass(force_full=True): counts do not sum to n")
    auto_launches = _auto_fit(x, c0)
    launches = {name: fit_launches[name] + refresh_launches[name]
                + auto_launches[name] for name in fit_launches}
    states, rno = _soundness(x, c0)

    # Steady-state inputs of one more sweep, for the per-kernel timings.
    lab, _, sums, counts, _ = K.lloyd_pass_cuda(x, state.centroids,
                                                compute_dtype=bf16)
    c1 = apply_update(state.centroids, sums, counts)
    w = torch.ones(n, device="cuda")
    kernels = []

    def record(name, *args):
        kernels.append(_kernel_row(name, launches[name], *args))

    xb, x_row, cb = n * d * 2, n * 4, k * d * 2 + k * 4
    dist_ops = 2.0 * n * d * k
    library_ms = _time_ms(
        lambda: torch.matmul(x, c1.to(bf16).T).argmin(dim=1), 3)

    # K1 at the headline shape: labels and min_d2 against the plain sweep,
    # sums against the plain fold at the kernel's labels.
    got = K.lloyd_pass_cuda(x, c1, compute_dtype=bf16)
    plain = K.lloyd_pass_plain(x, c1, compute_dtype=bf16)
    moved = _check_labels_rows("K1 headline", x, c1, bf16, got[0], plain[0])
    same = got[0] == plain[0]
    want = K.accumulate_plain(x, got[0], k, compute_dtype=bf16)
    err = max(_close("K1 headline sums", got[2], want[0]),
              _within("K1 headline min_d2", got[1][same], plain[1][same],
                      _row_scale(x, c1, bf16, got[0])[same]))
    print(f"K1 headline: {moved} rows labelled differently from the plain "
          "version, each a tie within the tolerance")
    record("lloyd_pass_cuda",
           _time_ms(lambda: K.lloyd_pass_cuda(x, c1, compute_dtype=bf16), 5),
           _time_ms(lambda: K.lloyd_pass_plain(x, c1, compute_dtype=bf16), 2),
           library_ms, err, xb + x_row + cb + 2 * x_row + k * d * 4 + k * 4,
           dist_ops, 4.0 * n * d)

    # K2 from the previous sweep's labels (this run's churn).
    got = K.lloyd_delta_cuda(x, c1, lab, compute_dtype=bf16, with_mind=False)
    plain = K.lloyd_delta_plain(x, c1, lab, compute_dtype=bf16,
                                with_mind=False)
    moved = _check_labels_rows("K2 headline", x, c1, bf16, got[0], plain[0])
    same = got[0] == plain[0]
    changed = got[0] != lab
    n_changed = int(got[5])
    add = K.accumulate_plain(x, torch.where(changed, got[0], -1), k,
                             compute_dtype=bf16)
    sub = K.accumulate_plain(x, torch.where(changed, lab, -1), k,
                             compute_dtype=bf16)
    err = max(_close("K2 headline dsums", got[2], add[0] - sub[0]),
              _within("K2 headline raw scores", got[1][same], plain[1][same],
                      _row_scale(x, c1, bf16, got[0])[same]))
    print(f"K2 headline churn: {n_changed} of {n} rows changed, "
          f"dense_tiles {int(got[6])}; {moved} rows labelled differently "
          "from the plain version, each a tie within the tolerance")
    record("lloyd_delta_cuda",
           _time_ms(lambda: K.lloyd_delta_cuda(x, c1, lab, compute_dtype=bf16,
                                               with_mind=False), 5),
           _time_ms(lambda: K.lloyd_delta_plain(x, c1, lab, compute_dtype=bf16,
                                                with_mind=False), 2),
           library_ms, err,
           xb + 2 * x_row + cb + 2 * x_row + k * d * 4 + k * 4,
           dist_ops, 4.0 * n_changed * d)
    _core_breakdown(x, c1, lab, kernels[0]["ms"], kernels[1]["ms"], dist_ops)

    # K3 with the sweep's labels.
    got = K.accumulate_cuda(x, lab, k, weights=w, compute_dtype=bf16)
    want = K.accumulate_plain(x, lab, k, weights=w, compute_dtype=bf16)
    err = max(_close("K3 headline sums", got[0], want[0]),
              _close("K3 headline min_d2", got[2], want[2], rtol=1e-5))
    lab_long = lab.long()
    record("accumulate_cuda",
           _time_ms(lambda: K.accumulate_cuda(x, lab, k, weights=w,
                                              compute_dtype=bf16), 5),
           _time_ms(lambda: K.accumulate_plain(x, lab, k, weights=w,
                                               compute_dtype=bf16), 2),
           _time_ms(lambda: torch.zeros(k, d, dtype=bf16, device="cuda")
                    .index_add_(0, lab_long, x), 3),
           err, xb + 3 * x_row + k * d * 4 + k * 4, 0.0, 4.0 * n * d)

    _forced_tiled(x, c1, lab, kernels[0]["ms"], kernels[1]["ms"])
    _hamerly_timings(x, states, rno, record)
    _flavour_sweeps(x, states, rno)

    t0 = time.perf_counter()
    seeds = kt.kmeans_plus_plus(gen, x, k, compute_dtype="bfloat16")
    _sync()
    print(f"kmeans_plus_plus at the headline shape: "
          f"{time.perf_counter() - t0:.3f} s")
    _check(bool(torch.isfinite(seeds).all()), "k-means++ seeds not finite")
    return kernels, launches, state.centroids.float().cpu().numpy()


def _clock_under(fn, seconds=3.0):
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi`` samples
    every 100 ms while ``fn`` runs back to back, the first second of samples
    left out; None where it reports none."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            _sync()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    rows = []
    for line in out.splitlines()[10:]:
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    if not rows:
        return None, None
    return (statistics.median(r[0] for r in rows),
            statistics.median(r[1] for r in rows))


def _core_breakdown(x, c, prev, k1_ms, k2_ms, dist_ops):
    """K1's time split by what it does at the headline shape (scoring + the
    raw slice merge, + the fold core's fold with ||x||²), both kernels'
    product rate, and
    the SM clock and power under K2, with the tensor cores' bf16 peak at
    that clock (4096 operations a clock on each SM)."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    bf16 = torch.bfloat16
    raw_ms = _time_ms(lambda: K.lloyd_pass_cuda(
        x, c, compute_dtype=bf16, with_update=False, raw_scores=True), 5)
    norm_ms = _time_ms(lambda: K.lloyd_pass_cuda(
        x, c, compute_dtype=bf16, with_update=False), 5)
    print(f"K1 {k1_ms:.3f} ms = scoring and raw merge {raw_ms:.3f} + the "
          f"fold core's fold with ||x||² {k1_ms - raw_ms:.3f} (without the "
          f"fold the merge reads x for ||x||²: {norm_ms - raw_ms:.3f}); "
          f"product "
          f"rate K1 {dist_ops / k1_ms / 1e9:.1f}, K2 "
          f"{dist_ops / k2_ms / 1e9:.1f}, scoring alone "
          f"{dist_ops / raw_ms / 1e9:.1f} TFLOP/s")
    clock, power = _clock_under(lambda: K.lloyd_delta_cuda(
        x, c, prev, compute_dtype=bf16, with_mind=False))
    if clock is None:
        print("SM clock under K2: not reported by nvidia-smi")
        return
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    peak = sms * 4096 * clock * 1e6 / 1e12
    print(f"SM clock under K2: {clock:.0f} MHz, power {power:.1f} W; the "
          f"tensor cores' bf16 peak at that clock {peak:.1f} TFLOP/s, K2 at "
          f"{dist_ops / k2_ms / 1e9 / peak:.1%} of it")


def _forced_tiled(x, c, prev, k1_ms, k2_ms):
    """The tiled route forced at the headline shape, where the planner keeps
    it untiled: K5 + K6 against K1 (the classic sweep) and K2 (the delta
    sweep from ``prev``), at the planner's widest slice (all 1000 columns
    in one) and at 128-column slices.  K5 must give K2's labels and raw
    scores bit for bit."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.plan import max_k_tile

    n, d = x.shape
    k = c.shape[0]
    bf16 = torch.bfloat16
    neg2c, csq = K._score_operands(c, bf16)
    k2 = K.lloyd_delta_cuda(x, c, prev, compute_dtype=bf16, with_mind=False)
    for k_tile in (max_k_tile("classic", d, k), 128):
        lab, raw = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                       raw_scores=True)
        _check(bool(torch.equal(lab, k2[0]) and torch.equal(raw, k2[1])),
               f"K5 k_tile={k_tile} headline: differs from K2")
        wch = (lab != prev).float()
        normed_ms = _time_ms(lambda: K.tiled_argmin_cuda(
            x, neg2c, csq, k_tile=k_tile), 5)
        raw_ms = _time_ms(lambda: K.tiled_argmin_cuda(
            x, neg2c, csq, k_tile=k_tile, raw_scores=True), 5)
        single_ms = _time_ms(lambda: K.tiled_fold_cuda(
            x, None, lab, None, k, compute_dtype=bf16), 5)
        dual_ms = _time_ms(lambda: K.tiled_fold_cuda(
            x, wch, lab, prev, k, compute_dtype=bf16), 5)
        print(f"forced tiled at the headline shape, k_tile={k_tile} "
              f"({-(-k // k_tile)} slices; a sweep's bound "
              f"{_bound_ms(n * d * 2, 2.0 * n * d * k)[0]:.3f} ms): classic "
              f"K5 {normed_ms:.3f} + K6 "
              f"single {single_ms:.3f} = {normed_ms + single_ms:.3f} ms "
              f"against K1 {k1_ms:.3f} ms; delta K5 raw {raw_ms:.3f} + K6 "
              f"dual {dual_ms:.3f} ({int(wch.sum())} changed rows) = "
              f"{raw_ms + dual_ms:.3f} ms against K2 {k2_ms:.3f} ms")


def _auto_fit(x, c0):
    """The default entry point at full width: ``KMeans`` with
    ``update="auto"`` from the fixed init, AUTO_SWEEPS sweeps.  Period 0 is
    delta, the first judgment (sweep 16) promotes yinyang, and the second
    (sweep 32) keeps it or demotes it: ``diag_["final_flavor"]`` says which,
    and the launch counts must agree.  Then the same fit again, which must
    give the same centroids, labels, sweeps and counters bit for bit.
    Returns the launch counts."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.delta import DELTA_REFRESH

    k = c0.shape[0]
    plan = kt.fit_plan(x, k, config=kt.KMeansConfig(
        k=k, compute_dtype="bfloat16"))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    km = kt.KMeans(n_clusters=k, compute_dtype="bfloat16", init=c0,
                   max_iter=AUTO_SWEEPS, tol=-1.0).fit(x)
    _sync()
    seconds = time.perf_counter() - t0
    launches = K.launch_counts()
    dg = km.diag_
    periods = ["delta", "yinyang", "yinyang" if dg["final_flavor"] == 1
               else "delta"]
    n_yin = periods.count("yinyang")
    print(f"fit_plan (update='auto'): {plan}")
    print(f"KMeans(compute_dtype='bfloat16', update='auto', "
          f"max_iter={AUTO_SWEEPS}, tol=-1): {km.n_iter_} sweeps + final "
          f"view in {seconds:.3f} s = {km.n_iter_ / seconds:.3f} iter/s "
          f"(final view, row norms and group formation included); inertia "
          f"{km.inertia_:.6e}")
    print(f"  diag: {dg}")
    print(f"  recompute fraction over the fit: "
          f"{dg['recompute_rows'] / dg['rows_seen']:.4f}; flavour of each "
          f"{DELTA_REFRESH}-sweep period: {periods}")
    print(f"  launches: {launches}")
    print(f"  peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    _check(km.n_iter_ == AUTO_SWEEPS and _finite(km.cluster_centers_)
           and math.isfinite(km.inertia_),
           "auto fit: wrong sweep count or non-finite result")
    _check(plan["adaptive"], "fit_plan does not report the adaptive loop")
    _check(launches["lloyd_hamerly_cuda"] >= 1,
           "the default fit never launched the Hamerly kernel")
    _check(launches["lloyd_hamerly_cuda"] == DELTA_REFRESH * n_yin
           and launches["lloyd_delta_cuda"]
           == (DELTA_REFRESH - 1) * (3 - n_yin)
           and launches["lloyd_pass_cuda"] == (3 - n_yin) + 1
           and launches["accumulate_cuda"] == 0,
           f"auto fit: launches {launches} disagree with periods {periods}")
    # The same fit again in this process: the difference is what the first
    # fit spent once (library kernels loaded and planned at first use).
    t0 = time.perf_counter()
    again = kt.KMeans(n_clusters=k, compute_dtype="bfloat16", init=c0,
                      max_iter=AUTO_SWEEPS, tol=-1.0).fit(x)
    _sync()
    seconds = time.perf_counter() - t0
    print(f"  the same fit again: {seconds:.3f} s = "
          f"{again.n_iter_ / seconds:.3f} iter/s; recompute_rows "
          f"{again.diag_['recompute_rows']:.0f}, final_flavor "
          f"{again.diag_['final_flavor']:.0f}")
    _check(bool(torch.equal(again.cluster_centers_, km.cluster_centers_)
                and torch.equal(again.labels_, km.labels_))
           and again.n_iter_ == km.n_iter_ and again.diag_ == dg,
           f"auto fit: the same fit again differs (diag {again.diag_})")
    print("  the same fit again: centroids, labels, sweeps and diag equal "
          "the first fit's bit for bit")
    return launches


def _finite(t):
    import torch

    return bool(torch.isfinite(t).all())


def _soundness(x, c0):
    """SOUND_SWEEPS hand-driven ``hamerly_pass`` sweeps, then as many
    ``yinyang_pass`` sweeps, from the fixed init (refresh at sweep 0 and
    16).  After each, K1 at the same centroids: every label that differs
    from K1's must be a tie within SCORE_RTOL.  Returns each flavour's
    state entering the next sweep, and the row norms."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.delta import DELTA_REFRESH
    from kmeans_tpu_torch.ops.hamerly import hamerly_pass, row_norms
    from kmeans_tpu_torch.ops.update import apply_update
    from kmeans_tpu_torch.ops.yinyang import centroid_groups, yinyang_pass

    n = x.shape[0]
    k, d = c0.shape
    bf16 = torch.bfloat16
    rno = row_norms(x, compute_dtype=bf16)
    group_np, t = centroid_groups(c0.cpu().numpy())
    group_of = torch.from_numpy(group_np).cuda()
    states = {}
    for flavour in ("hamerly", "yinyang"):
        torch.cuda.reset_peak_memory_stats()
        c = c0.clone()
        lab = torch.full((n,), -1, dtype=torch.int32, device="cuda")
        sb = torch.zeros(n, device="cuda")
        lower = torch.zeros((n,) if flavour == "hamerly" else (n, t),
                            device="cuda")
        c_cd, csq = c0.to(bf16), torch.zeros(k, device="cuda")
        recs, diffs = [], []
        for i in range(SOUND_SWEEPS):
            if i % DELTA_REFRESH == 0:
                lab = torch.full_like(lab, -1)
                sums = torch.zeros(k, d, device="cuda")
                counts = torch.zeros(k, device="cuda")
            args = (x, c, lab, sums, counts, sb, lower, c_cd, csq, rno)
            if flavour == "hamerly":
                out = hamerly_pass(*args, compute_dtype="bfloat16")
            else:
                out = yinyang_pass(*args, group_of, compute_dtype="bfloat16")
            lab, sums, counts, sb, lower, c_cd, csq, n_rec = out[:8]
            ref = K.lloyd_pass_cuda(x, c, compute_dtype=bf16,
                                    with_update=False)[0]
            diffs.append(_check_labels_rows(f"{flavour} sweep {i}", x, c,
                                            bf16, lab, ref))
            recs.append(int(n_rec))
            c = apply_update(c, sums, counts)
        print(f"{flavour} ({SOUND_SWEEPS} sweeps{f', t={t}' if flavour == 'yinyang' else ''}): "
              f"rows recomputed per sweep {recs}")
        print(f"  recompute fraction per sweep "
              f"{[round(r / n, 4) for r in recs]}")
        print(f"  rows labelled differently from K1 per sweep {diffs} "
              f"(each a tie within {SCORE_RTOL}); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        states[flavour] = (c, lab, sums, counts, sb, lower, c_cd, csq)
    states["group_of"] = group_of
    return states, rno


def _hamerly_timings(x, states, rno, record):
    """K4 at the hamerly state entering sweep SOUND_SWEEPS (the fit's
    steady state), with every row needed, and with about 10% needed: its
    time beside the bound (2·n_rec·d·k), the plain version's, the library
    yardstick's (``torch.mm`` of the gathered rows, then the two least
    scores with ``topk``) and ``score_block``'s, whose labels, sb and slb
    must equal the core's bit for bit.  The steady case is checked against
    the plain version and recorded."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.hamerly import hamerly_bounds

    n, d = x.shape
    bf16 = torch.bfloat16
    c, lab, _, _, sb, slb, c_cd, csq = states["hamerly"]
    k = c.shape[0]
    sb2, slb2, need_steady, _, _ = hamerly_bounds(c, lab, sb, slb, c_cd, csq,
                                                  rno, bf16)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = {"steady": need_steady,
             "100%": torch.ones(n, dtype=torch.bool, device="cuda"),
             "10%": torch.rand(n, generator=gen, device="cuda") < 0.1}
    cb = c.to(bf16)
    for what, need in cases.items():
        n_rec = int(need.sum())
        rows = need.nonzero()[:, 0]

        def kernel():
            return K.lloyd_hamerly_cuda(x, c, lab, need, sb2, slb2,
                                        compute_dtype=bf16)

        def plain():
            return K.lloyd_hamerly_plain(x, c, lab, need, sb2, slb2,
                                         compute_dtype=bf16)

        ms = _time_ms(kernel, 5)
        plain_ms = _time_ms(plain, 1)
        library_ms = _time_ms(
            lambda: torch.mm(x[rows], cb.T, out_dtype=torch.float32).topk(
                2, dim=1, largest=False), 3)
        with _ForcedScoreBlock():
            sb_ms = _time_ms(kernel, 3)
            ref = kernel()
        got = kernel()
        _check(all(torch.equal(got[i], ref[i]) for i in (0, 1, 2, 5, 6)),
               f"K4 at need {what}: the core's labels, sb or slb differ from "
               "score_block's")
        del ref
        n_changed = int(((got[0] != lab) & need).sum())
        bytes_moved = (n_rec * d * 2 + n * (4 + 1 + 4 + 4 + 4) + k * d * 2
                       + k * 4 + n * 12 + k * d * 4 + k * 4)
        bound, by = _bound_ms(bytes_moved, 2.0 * n_rec * d * k,
                              4.0 * n_changed * d)
        print(f"K4 at need {what}: {n_rec} of {n} rows "
              f"({n_rec / n:.4f}), {n_changed} changed: {ms:.3f} ms (bound "
              f"{bound:.3f} ms by {by}), plain {plain_ms:.3f} ms, library "
              f"{library_ms:.3f} ms, on score_block {sb_ms:.3f} ms (bit for "
              "bit equal)")
        if what != "steady":
            continue
        want = plain()
        moved = _check_labels_rows("K4 headline", x, c, bf16, got[0],
                                   want[0])
        same = (got[0] == want[0]) & need
        changed = (got[0] != lab) & need
        add = K.accumulate_plain(x, torch.where(changed, got[0], -1), k,
                                 compute_dtype=bf16)
        sub = K.accumulate_plain(x, torch.where(changed, lab, -1), k,
                                 compute_dtype=bf16)
        err = max(_close("K4 headline dsums", got[3], add[0] - sub[0]),
                  _within("K4 headline sb", got[1][same], want[1][same],
                          _row_scale(x, c, bf16, got[0])[same]))
        _check(bool(torch.equal(got[1][~need], sb2[~need])
                    and torch.equal(got[2][~need], slb2[~need])
                    and torch.equal(got[0][~need], lab[~need])),
               "K4 headline: rows not needed were not passed through")
        _check(int(got[5]) == n_rec, "K4 headline n_recomputed")
        print(f"K4 headline: {moved} rows labelled differently from the "
              "plain version, each a tie within the tolerance")
        record("lloyd_hamerly_cuda", ms, plain_ms, library_ms, err,
               bytes_moved, 2.0 * n_rec * d * k, 4.0 * n_changed * d)


def _flavour_sweeps(x, states, rno):
    """One steady sweep of each flavour, from the states entering sweep
    SOUND_SWEEPS: delta (K2, from the hamerly state's labels and sums),
    hamerly (bounds and K4) and yinyang (bounds, K4 and the glb refresh);
    then a yinyang refresh sweep (−1 labels: every row scored) and the
    pruned fits' set-up (row norms, centroid groups)."""
    import torch

    from kmeans_tpu_torch.ops.delta import delta_pass
    from kmeans_tpu_torch.ops.hamerly import hamerly_pass, row_norms
    from kmeans_tpu_torch.ops.yinyang import centroid_groups, yinyang_pass

    c, lab, sums, counts, sb, slb, c_cd, csq = states["hamerly"]
    ms = {
        "delta": _time_ms(lambda: delta_pass(
            x, c, lab, sums, counts, compute_dtype="bfloat16",
            with_mind=False), 3),
        "hamerly": _time_ms(lambda: hamerly_pass(
            x, c, lab, sums, counts, sb, slb, c_cd, csq, rno,
            compute_dtype="bfloat16"), 3),
    }
    c, lab, sums, counts, sb, glb, c_cd, csq = states["yinyang"]
    ms["yinyang"] = _time_ms(lambda: yinyang_pass(
        x, c, lab, sums, counts, sb, glb, c_cd, csq, rno, states["group_of"],
        compute_dtype="bfloat16"), 3)
    print("one steady sweep (CUDA events, median of 3): "
          + ", ".join(f"{name} {t:.3f} ms" for name, t in ms.items()))
    sentinel = torch.full_like(lab, -1)
    refresh_ms = _time_ms(lambda: yinyang_pass(
        x, c, sentinel, torch.zeros_like(sums), torch.zeros_like(counts), sb,
        glb, c_cd, csq, rno, states["group_of"], compute_dtype="bfloat16"), 3)
    norms_ms = _time_ms(lambda: row_norms(x, compute_dtype=torch.bfloat16), 3)
    t0 = time.perf_counter()
    centroid_groups(c.cpu().numpy())
    groups_s = time.perf_counter() - t0
    print(f"yinyang refresh sweep {refresh_ms:.3f} ms; row_norms "
          f"{norms_ms:.3f} ms; centroid_groups (host, numpy) "
          f"{1e3 * groups_s:.3f} ms")


# ---------------------------------------------------------------------------
# Phase 4, f32: imagenet-delta-f32 on the core's f32 route
# ---------------------------------------------------------------------------

#: Sweeps of the f32 headline delta fit (the refresh at sweep 16 and the
#: final view run), and the hand-driven Hamerly sweeps after it (a refresh,
#: then steady sweeps).
F32_SWEEPS = 20
F32_HAMERLY_SWEEPS = 4
#: Rows of the f32 error sample against the f64 product.
F32_ERROR_ROWS = 4096
#: Widths at which K2 in f32 is timed on the core's f32 route and on
#: ``score_block``, at the glove shape's n and k: the narrowest the rule
#: admits, the 32-feature stage's multiples, glove's d = 300 (d % 8 == 4,
#: −2C's pieces padded to 304 columns) between its neighbours, and wider.
F32_WIDTHS = (4, 8, 16, 32, 64, 128, 296, 300, 304, 512)


def _f32_bounds(n, d, k):
    """(the f32 route's bound: six bf16 passes at 989 TFLOP/s, the FFMA
    bound any f32 kernel is held to: one f32 product at 67 TFLOP/s), ms."""
    ops = 2.0 * n * d * k
    return 1e3 * 6 * ops / BF16_TENSOR_OPS_PER_S, 1e3 * ops / F32_OPS_PER_S


def _f32_library(x, neg2c, csq, chunk=None):
    """``torch.mm`` + ``argmin`` in full f32 (TF32 off), the library
    yardstick of the f32 scoring kernels; ``chunk`` rows at a time."""
    import torch

    from kmeans_tpu_torch.ops.distance import full_f32

    def run():
        with full_f32():
            if chunk is None:
                return torch.mm(x, neg2c.T).add_(csq).argmin(dim=1)
            return torch.cat([torch.mm(x[s:s + chunk], neg2c.T).add_(csq)
                              .argmin(dim=1)
                              for s in range(0, x.shape[0], chunk)])
    return run


def _f32_sweep_times(x, c, prev, need, reps=5):
    """CUDA-event ms of K1 (with its fold), K2 (raw, from ``prev``) and K4
    (the rows of ``need``) in f32 at ``x``'s shape, of their plain
    versions (one timed run each), of ``torch.mm`` + ``argmin`` with TF32
    off; with the scoring core."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    f32 = torch.float32
    n = x.shape[0]
    zeros = torch.zeros(n, device="cuda")
    neg2c, csq = K._score_operands(c, f32)
    out = {"core": K.scoring_core(x, f32, neg2c)}

    def k2():
        return K.lloyd_delta_cuda(x, c, prev, compute_dtype=f32,
                                  with_mind=False)

    out["K1"] = _time_ms(lambda: K.lloyd_pass_cuda(x, c, compute_dtype=f32),
                         reps)
    out["K2"] = _time_ms(k2, reps)
    out["K4"] = _time_ms(lambda: K.lloyd_hamerly_cuda(
        x, c, prev, need, zeros, zeros, compute_dtype=f32), reps)
    out["K1 plain"] = _time_ms(lambda: K.lloyd_pass_plain(
        x, c, compute_dtype=f32), 1)
    out["K2 plain"] = _time_ms(lambda: K.lloyd_delta_plain(
        x, c, prev, compute_dtype=f32, with_mind=False), 1)
    out["K4 plain"] = _time_ms(lambda: K.lloyd_hamerly_plain(
        x, c, prev, need, zeros, zeros, compute_dtype=f32), 1)
    out["library"] = _time_ms(_f32_library(x, neg2c, csq, 262144), 3)
    return out


def _print_f32_times(what, times, n, d, k, n_need):
    route, ffma = _f32_bounds(n, d, k)
    route4, ffma4 = _f32_bounds(n_need, d, k)
    print(f"{what} f32 (core {times['core']}): K1 {times['K1']:.3f} ms, K2 "
          f"{times['K2']:.3f} ms, K4 at {n_need} needed rows {times['K4']:.3f} ms (bounds "
          f"{route4:.3f}, {ffma4:.3f} ms); plain "
          f"K1 {times['K1 plain']:.3f}, K2 {times['K2 plain']:.3f}, K4 "
          f"{times['K4 plain']:.3f} ms; "
          f"torch.mm+argmin (TF32 off) {times['library']:.3f} ms; bounds "
          f"{route:.3f} ms (six bf16 passes at 989 TFLOP/s), {ffma:.3f} ms "
          f"(f32 FMA at 67 TFLOP/s); K2 at "
          f"{2.0 * n * d * k / times['K2'] / 1e9:.1f} TFLOP/s of f32 "
          "product")


def _f32_row_errors(name, x, c, prev, rows=F32_ERROR_ROWS):
    """K2's raw scores on ``rows`` sampled rows against the f64 product at
    each row's label, relative to ||x||² + ||c||²: printed, and on the f32
    route held to SCORE_RTOL and :func:`_gamma`.  Returns the error."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(17)
    pick = torch.randperm(x.shape[0], generator=gen, device="cuda")[:rows]
    xs, ps = x[pick].contiguous(), prev[pick].contiguous()
    core = K.scoring_core(xs, f32, c)
    lab, raw = K.lloyd_delta_cuda(xs, c, ps, compute_dtype=f32,
                                  with_mind=False)[:2]
    _sync()
    err = _f32_score_error(xs, c, lab, raw)
    d = x.shape[1]
    print(f"{name} f32 score error against f64 on {rows} rows (core "
          f"{core}): {err:.3e} of ||x||² + ||c||² (SCORE_RTOL {SCORE_RTOL}, "
          f"γ {_gamma(d):.3e})")
    if core == "wgmma":
        _check(err <= min(SCORE_RTOL, _gamma(d)),
               f"{name}: f32 score error {err:.3e} beyond min(SCORE_RTOL, γ)")
    return err


def phase_headline_f32():
    """imagenet-delta-f32: n = 1,280,000, d = 2048, k = 1000, f32
    ``make_blobs`` on the card and a fixed init, computed in f32 (the
    default for f32 data) on the core's f32 route: the main path in two
    runs, each with the counts set to 0 just before and read just after --
    ``fit_lloyd(update="delta")`` (F32_SWEEPS sweeps: K1 and K2) and
    F32_HAMERLY_SWEEPS hand-driven ``hamerly_pass`` sweeps (K4) -- each
    held against K1, and the fit's labels against the plain route's; then
    K1, K2 and K4 against their plain versions, timed beside their bounds,
    the library and ``score_block``, and the route's score error against
    f64; then :func:`_f32_widths`.  Nothing is cut but the sweep depth.
    Returns the three kernels' ``kernels`` rows, with the runs' launches."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.hamerly import (hamerly_bounds, hamerly_pass,
                                              row_norms)
    from kmeans_tpu_torch.ops.update import apply_update

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    f32 = torch.float32
    t0 = time.perf_counter()
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=f32)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(1), x, k)
    _sync()
    print(f"imagenet-delta-f32 data: n={n} d={d} k={k} f32, "
          f"{time.perf_counter() - t0:.2f} s to make")
    core = K.scoring_core(x, f32, c0)
    print(f"scoring core of K1, K2 and K4 at the headline shape in f32: "
          f"{core}")
    _check(core == "wgmma", "f32 at the headline shape is not on the core")
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    cfg = kt.KMeansConfig(k=k, update="delta")
    t0 = time.perf_counter()
    state, counts = _counted_run(lambda: kt.fit_lloyd(
        x, k, config=cfg, init=c0, max_iter=F32_SWEEPS, tol=-1.0))
    fit_s = time.perf_counter() - t0
    _add_counts(launches, counts)
    print(f"f32 fit_lloyd(update='delta', max_iter={F32_SWEEPS}, tol=-1): "
          f"{int(state.n_iter)} sweeps + final view in {fit_s:.3f} s = "
          f"{int(state.n_iter) / fit_s:.3f} iter/s; inertia "
          f"{float(state.inertia):.6e}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches "
          f"{counts}")
    _check(counts["lloyd_pass_cuda"] >= 3
           and counts["lloyd_delta_cuda"] >= F32_SWEEPS - 3
           and not counts["tiled_argmin_cuda"] and not counts["tiled_fold_cuda"],
           f"f32 fit: launches {counts}")
    _check(int(state.n_iter) == F32_SWEEPS and _finite(state.centroids)
           and bool(torch.isfinite(state.inertia)),
           "f32 fit: wrong sweep count or non-finite result")
    c = state.centroids
    lab1 = K.lloyd_pass_cuda(x, c, compute_dtype=f32, with_update=False)[0]
    plain = K.lloyd_pass_plain(x, c, compute_dtype=f32, with_update=False)
    moved = _check_labels_rows("f32 fit vs plain", x, c, f32, lab1, plain[0])
    print(f"  K1 at the fit's centroids against the plain f32 route: "
          f"{moved} rows differ, each a tie within {SCORE_RTOL}")
    del plain

    # Hand-driven Hamerly sweeps from the fit's centroids: a refresh (every
    # row needed), then steady sweeps, each held against K1.
    rno = row_norms(x, compute_dtype=f32)
    hc = c.clone()
    lab = torch.full((n,), -1, dtype=torch.int32, device="cuda")
    sb = torch.zeros(n, device="cuda")
    slb = torch.zeros(n, device="cuda")
    c_cd, csq = hc.clone(), torch.zeros(k, device="cuda")
    sums, hcounts = torch.zeros(k, d, device="cuda"), torch.zeros(
        k, device="cuda")
    recs, diffs = [], []
    for i in range(F32_HAMERLY_SWEEPS):
        out, counts = _counted_run(lambda: hamerly_pass(
            x, hc, lab, sums, hcounts, sb, slb, c_cd, csq, rno,
            compute_dtype="float32"))
        _add_counts(launches, counts)
        _check(counts["lloyd_hamerly_cuda"] == 1,
               f"f32 hamerly sweep {i}: launches {counts}")
        lab, sums, hcounts, sb, slb, c_cd, csq, n_rec = out[:8]
        ref = K.lloyd_pass_cuda(x, hc, compute_dtype=f32,
                                with_update=False)[0]
        diffs.append(_check_labels_rows(f"f32 hamerly sweep {i}", x, hc, f32,
                                        lab, ref))
        recs.append(int(n_rec))
        hc = apply_update(hc, sums, hcounts)
    print(f"f32 hamerly ({F32_HAMERLY_SWEEPS} sweeps): rows recomputed "
          f"{recs}; rows labelled differently from K1 {diffs} (each a tie "
          f"within {SCORE_RTOL})")
    print(f"imagenet-delta-f32 main path launches: {launches}")

    # Timings at the steady state: K2 from one more sweep's labels at the
    # next centroids (this run's churn), K4 at the Hamerly sweeps' steady
    # need.
    _, _, need, _, _ = hamerly_bounds(hc, lab, sb, slb, c_cd, csq, rno, f32)
    del rno, sb, slb, sums
    prev, _, sums1, counts1, _ = K.lloyd_pass_cuda(x, c, compute_dtype=f32)
    c = apply_update(c, sums1, counts1)
    times = _f32_sweep_times(x, c, prev, need)
    _print_f32_times("imagenet-delta-f32", times, n, d, k, int(need.sum()))
    with _ForcedScoreBlock():
        sb_ms = _time_ms(lambda: K.lloyd_delta_cuda(
            x, c, prev, compute_dtype=f32, with_mind=False), 2)
    print(f"imagenet-delta-f32 K2 on score_block (the parent's f32 route): "
          f"{sb_ms:.3f} ms")
    rows = _f32_kernel_rows(x, c, prev, need, times, launches)
    _f32_row_errors("imagenet-delta-f32", x, c, prev)
    del x, c, prev, need
    _f32_widths()
    return rows


def _f32_widths(n=400_000, k=1000, reps=5):
    """K2 in f32 at n rows and k centroids over d in F32_WIDTHS: the
    scoring core the rule picks, K2's CUDA-event ms there and on
    ``score_block`` (labels equal but for near-ties within SCORE_RTOL), and
    the route's share of the f32 product it computes (a stage of 32
    features: ⌈d/32⌉·32 of them).  Seeded Gaussian data, centroids drawn
    from the rows, ``prev`` the labels at centroids one small step away."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(29)
    for d in F32_WIDTHS:
        x = torch.randn(n, d, generator=gen, device="cuda")
        c = x[torch.randperm(n, generator=gen, device="cuda")[:k]].clone()
        prev = K.lloyd_pass_cuda(x, c, compute_dtype=f32,
                                 with_update=False)[0]
        c += 0.05 * torch.randn(k, d, generator=gen, device="cuda")
        core = K.scoring_core(x, f32, c)

        def k2():
            return K.lloyd_delta_cuda(x, c, prev, compute_dtype=f32,
                                      with_mind=False)

        ms = _time_ms(k2, reps)
        lab = k2()[0]
        with _ForcedScoreBlock():
            sb_ms = _time_ms(k2, reps)
            lab_sb = k2()[0]
        moved = _check_labels_rows(f"K2 f32 d={d}", x, c, f32, lab, lab_sb)
        print(f"f32 width n={n} d={d} k={k}: K2 on {core} {ms:.3f} ms, on "
              f"score_block {sb_ms:.3f} ms (x{sb_ms / ms:.2f}); the route "
              f"computes {d / (-(-d // 32) * 32):.3f} useful of its "
              f"products; {moved} labels differ (ties)")
        del x, c, prev


def _f32_kernel_rows(x, c, prev, need, times, launches):
    """The ``kernels`` rows of K1, K2 and K4 on the f32 route at the
    headline shape: each against its plain version (labels up to ties,
    scores within SCORE_RTOL of the row scale, sums within SUMS_RTOL),
    with ``times`` from :func:`_f32_sweep_times`, the launches of
    imagenet-delta-f32's runs and the route's bound: ``x`` read once in
    f32, −2C's three bf16 pieces, six bf16 products on the tensor cores.
    K4's library call is ``torch.mm`` of the needed rows with TF32 off,
    then the two least scores with ``topk``."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.distance import full_f32

    f32 = torch.float32
    n, d = x.shape
    k = c.shape[0]
    zeros = torch.zeros(n, device="cuda")
    neg2c, csq = K._score_operands(c, f32)
    xb, x_row = n * d * 4, n * 4
    cb = 3 * k * (-(-d // 8) * 8) * 2 + k * 4
    fold = k * d * 4 + k * 4
    dist_ops = 2.0 * n * d * k
    rows = []

    def dsums_err(name, got_lab, dsums, mask):
        changed = (got_lab != prev) & mask
        add = K.accumulate_plain(x, torch.where(changed, got_lab, -1), k,
                                 compute_dtype=f32)
        sub = K.accumulate_plain(x, torch.where(changed, prev, -1), k,
                                 compute_dtype=f32)
        return _close(name, dsums, add[0] - sub[0]), int(changed.sum())

    got = K.lloyd_pass_cuda(x, c, compute_dtype=f32)
    plain = K.lloyd_pass_plain(x, c, compute_dtype=f32)
    _check_labels_rows("K1 f32 headline", x, c, f32, got[0], plain[0])
    same = got[0] == plain[0]
    want = K.accumulate_plain(x, got[0], k, compute_dtype=f32)
    err = max(_close("K1 f32 headline sums", got[2], want[0]),
              _within("K1 f32 headline min_d2", got[1][same], plain[1][same],
                      _row_scale(x, c, f32, got[0])[same]))
    del got, plain, want
    rows.append(_kernel_row(
        "lloyd_pass_cuda", launches.get("lloyd_pass_cuda", 0), times["K1"],
        times["K1 plain"], times["library"], err,
        xb + x_row + cb + 2 * x_row + fold, 6 * dist_ops, 4.0 * n * d,
        "f32 route"))

    got = K.lloyd_delta_cuda(x, c, prev, compute_dtype=f32, with_mind=False)
    plain = K.lloyd_delta_plain(x, c, prev, compute_dtype=f32,
                                with_mind=False)
    moved = _check_labels_rows("K2 f32 headline", x, c, f32, got[0],
                               plain[0])
    same = got[0] == plain[0]
    all_rows = torch.ones(n, dtype=torch.bool, device="cuda")
    sums_err, n_changed = dsums_err("K2 f32 headline dsums", got[0], got[2],
                                    all_rows)
    err = max(sums_err, _within("K2 f32 headline raw scores", got[1][same],
                                plain[1][same],
                                _row_scale(x, c, f32, got[0])[same]))
    print(f"K2 f32 headline: {n_changed} of {n} rows changed; {moved} rows "
          f"labelled differently from the plain version (ties)")
    del got, plain
    rows.append(_kernel_row(
        "lloyd_delta_cuda", launches.get("lloyd_delta_cuda", 0), times["K2"],
        times["K2 plain"], times["library"], err,
        xb + 2 * x_row + cb + 2 * x_row + fold, 6 * dist_ops,
        4.0 * n_changed * d, "f32 route"))

    got = K.lloyd_hamerly_cuda(x, c, prev, need, zeros, zeros,
                               compute_dtype=f32)
    plain = K.lloyd_hamerly_plain(x, c, prev, need, zeros, zeros,
                                  compute_dtype=f32)
    _check_labels_rows("K4 f32 headline", x[need], c, f32, got[0][need],
                       plain[0][need])
    same = (got[0] == plain[0]) & need
    sums_err, n_changed = dsums_err("K4 f32 headline dsums", got[0], got[3],
                                    need)
    err = max(sums_err, _within("K4 f32 headline sb", got[1][same],
                                plain[1][same],
                                _row_scale(x, c, f32, got[0])[same]))
    _check(bool(torch.equal(got[0][~need], prev[~need])),
           "K4 f32 headline: a row not needed changed its label")
    del got, plain
    picked = need.nonzero()[:, 0]
    n_rec = int(picked.numel())

    def library():
        with full_f32():
            return torch.mm(x[picked], neg2c.T).add_(csq).topk(
                2, dim=1, largest=False)

    rows.append(_kernel_row(
        "lloyd_hamerly_cuda", launches.get("lloyd_hamerly_cuda", 0),
        times["K4"], times["K4 plain"], _time_ms(library, 3), err,
        n_rec * d * 4 + n * (4 + 1 + 4 + 4 + 4) + cb + n * 12 + fold,
        6 * 2.0 * n_rec * d * k, 4.0 * n_changed * d, "f32 route"))
    return rows


def phase_f32_bench():
    """The f32-compute kernels of the tree this script runs in, so that two
    commits can be compared in one call (copy this script over an older
    checkout's and run each with ``--f32-bench``, in turns): K5 (raw
    scores, as the serving engine calls it) at the serving batch shapes --
    1536 and 3072 x 1000 (a mean and a full imagenet-serve batch) and
    8192 x 65536 at d = 2048, at the engine's column range and at 128 and
    256 columns for the first two --, the imagenet-delta-f32 fit (phase
    4's data, init and depth, twice), and K1, K2
    and K4 (13.4% of the rows needed, the headline's steady Hamerly
    share) at the headline shape, each beside ``torch.mm`` + ``argmin``
    with TF32 off and both bounds, and the route's score error against f64
    on sampled rows; then K2 at the glove shape over d in F32_WIDTHS on
    the tree's f32 rule and on ``score_block``.
    Blob data from a seed, f32.  Written against the APIs every tree since
    the serving engine has."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.serve.assign import dense_k_tile

    from kmeans_tpu_torch.models.init import random_init

    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(23)
    d = HEADLINE["d"]
    for rows, k, reps in ((1536, HEADLINE["k"], 50),
                          (3072, HEADLINE["k"], 50),
                          (8192, CODEBOOK["k"], 10)):
        c = torch.randn(k, d, generator=gen, device="cuda") * 4
        x = (c[torch.randint(0, k, (rows,), generator=gen, device="cuda")]
             + torch.randn(rows, d, generator=gen, device="cuda"))
        neg2c, csq = (c * -2).contiguous(), (c * c).sum(dim=1).contiguous()
        core = K.scoring_core(x, f32, neg2c)
        kw = {}
        if hasattr(K, "neg2c_pieces") and core == "wgmma":
            kw["neg2c_pieces"] = K.neg2c_pieces(neg2c)
        tiles = [dense_k_tile(k, d)] + ([128, 256] if k < 4096 else [])
        times = {}
        for k_tile in dict.fromkeys(tiles):
            times[k_tile] = _time_ms(lambda: K.tiled_argmin_cuda(
                x, neg2c, csq, k_tile=k_tile, raw_scores=True, **kw), reps)
        lib = _time_ms(_f32_library(x, neg2c, csq), reps)
        route, ffma = _f32_bounds(rows, d, k)
        print(f"f32-bench K5 {rows} x {k} x {d} (core {core}): "
              + ", ".join(f"k_tile {kt_} {ms:.3f} ms"
                          for kt_, ms in times.items())
              + f"; torch.mm+argmin (TF32 off) {lib:.3f} ms; bounds "
              f"{route:.3f} ms (six passes), {ffma:.3f} ms (f32 FMA)")
        prev = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=tiles[0],
                                   raw_scores=True)[0]
        _f32_row_errors(f"f32-bench {rows} x {k}", x, c, prev, rows=512)
        del x, c, neg2c, csq, kw
    n, k = HEADLINE["n"], HEADLINE["k"]
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=f32)
    # The imagenet-delta-f32 fit: the same data and init as phase 4's.
    c0 = random_init(torch.Generator(device="cuda").manual_seed(1), x, k)
    cfg = kt.KMeansConfig(k=k, update="delta")
    for run in ("first", "again"):
        _sync()
        t0 = time.perf_counter()
        state = kt.fit_lloyd(x, k, config=cfg, init=c0, max_iter=F32_SWEEPS,
                             tol=-1.0)
        _sync()
        fit_s = time.perf_counter() - t0
        print(f"f32-bench imagenet-delta-f32 fit ({run}): "
              f"{int(state.n_iter)} sweeps + final view in {fit_s:.3f} s = "
              f"{int(state.n_iter) / fit_s:.3f} iter/s; inertia "
              f"{float(state.inertia):.6e}")
    del state
    c = x[torch.randperm(n, generator=gen, device="cuda")[:k]].clone()
    prev = K.lloyd_pass_cuda(x, c, compute_dtype=f32, with_update=False)[0]
    c += 0.05 * torch.randn(k, d, generator=gen, device="cuda")
    need = torch.rand(n, generator=gen, device="cuda") < 0.134
    times = _f32_sweep_times(x, c, prev, need)
    _print_f32_times("f32-bench headline", times, n, d, k, int(need.sum()))
    _f32_row_errors("f32-bench headline", x, c, prev)
    del x, c, prev, need
    _f32_widths()


#: ``--delta-bench``: the timed runs of each kernel (the median is kept).
DELTA_BENCH_REPS = 9


def _delta_bench_kernel(what, fn, at, x, prev, cd):
    """K2 or K4 (``fn``, its delta at ``at`` and ``at + 1``) at ``x``'s
    shape from the labels ``prev``: the median ms, the device time of one
    call split into the fold core's kernels (``sort_*``, ``fold_*``) and
    the rest (:func:`_device_split`), the card's peak memory of one call
    above the level before it, whether a second launch gives the same
    delta bit for bit, and in a tree whose K2 and K4 fold on the fold
    core, K6's dual fold over the call's changed rows alone (the fold the
    kernel runs, with its own scratch and host calls)."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    ms = _time_ms(fn, DELTA_BENCH_REPS)
    split = _device_split(fn, 3)
    fold = sum(t for name, _, t in split if name.startswith(("sort_",
                                                             "fold_")))
    rest = sum(t for _, _, t in split) - fold
    _sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    first = fn()
    _sync()
    peak = torch.cuda.max_memory_allocated() - base
    again = fn()
    _sync()
    same = bool(torch.equal(first[at], again[at])
                and torch.equal(first[at + 1], again[at + 1]))
    line = (f"delta-bench {what}: {ms:.3f} ms (median of {DELTA_BENCH_REPS});"
            f" device time a call {rest:.3f} ms outside the fold core, "
            f"{fold:.3f} ms in it; {int((first[0] != prev).sum())} rows "
            f"changed; peak "
            f"{peak / 1e6:.1f} MB above the level before; two launches' "
            f"delta bit for bit: {same}")
    if hasattr(K, "delta_fold_weights"):
        n, k = x.shape[0], first[at].shape[0]
        fold_w = K.delta_fold_weights(first[0], prev,
                                      torch.ones(n, device="cuda"))
        fold_ms = _time_ms(lambda: K.tiled_fold_cuda(
            x, fold_w, first[0], prev, k, compute_dtype=cd),
            DELTA_BENCH_REPS)
        line += f"; the dual fold alone {fold_ms:.3f} ms"
    print(line, flush=True)


def phase_delta_bench():
    """K2, K4 and the fits they run in, for the tree this script runs in,
    so that two commits can be compared in one call (copy this script over
    an older checkout's and run each with ``--delta-bench``, in turns): at
    the headline shape in bf16 (phase 4's data and init), the
    imagenet-delta fit (20 sweeps) and imagenet-auto (``KMeans``,
    AUTO_SWEEPS sweeps) on the host clock, three times each after a first
    run; then K2
    at phase 4's inputs (one sweep past the delta fit) and K4 at the
    Hamerly state after SOUND_SWEEPS hand-driven sweeps (its steady need),
    as :func:`_delta_bench_kernel` times them; then K2 and K4 in f32 at
    ``--f32-bench``'s headline inputs (13.4% of the rows needed).  Written
    against the APIs every tree since the f32 route has."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.delta import DELTA_REFRESH
    from kmeans_tpu_torch.ops.hamerly import (hamerly_bounds, hamerly_pass,
                                              row_norms)
    from kmeans_tpu_torch.ops.update import apply_update

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    bf16, f32 = torch.bfloat16, torch.float32
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=bf16)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(1), x, k)
    cfg = kt.KMeansConfig(k=k, update="delta", compute_dtype="bfloat16")
    fits = {"imagenet-delta": lambda: kt.fit_lloyd(
                x, k, config=cfg, init=c0, max_iter=20, tol=-1.0),
            "imagenet-auto": lambda: kt.KMeans(
                n_clusters=k, compute_dtype="bfloat16", init=c0,
                max_iter=AUTO_SWEEPS, tol=-1.0).fit(x).state}
    states = {}
    for name, fit in fits.items():
        fit()                                   # first use: loads, plans
        secs = []
        for _ in range(3):
            _sync()
            t0 = time.perf_counter()
            states[name] = fit()
            _sync()
            secs.append(time.perf_counter() - t0)
        print(f"delta-bench {name}: {int(states[name].n_iter)} sweeps + "
              f"final view in {', '.join(f'{t:.3f}' for t in secs)} s "
              f"(median {statistics.median(secs):.3f}); inertia "
              f"{float(states[name].inertia):.6e}", flush=True)
    # Phase 4's K2 inputs: one more sweep from the delta fit's centroids.
    c = states["imagenet-delta"].centroids
    del states
    lab, _, sums, counts, _ = K.lloyd_pass_cuda(x, c, compute_dtype=bf16)
    c1 = apply_update(c, sums, counts)
    _delta_bench_kernel("headline bf16 K2", lambda: K.lloyd_delta_cuda(
        x, c1, lab, compute_dtype=bf16, with_mind=False), 2, x, lab, bf16)
    # The Hamerly state entering sweep SOUND_SWEEPS, as phase 4 drives it.
    rno = row_norms(x, compute_dtype=bf16)
    c = c0.clone()
    sb, slb = torch.zeros(n, device="cuda"), torch.zeros(n, device="cuda")
    c_cd, csq = c0.to(bf16), torch.zeros(k, device="cuda")
    for i in range(SOUND_SWEEPS):
        if i % DELTA_REFRESH == 0:
            h_lab = torch.full((n,), -1, dtype=torch.int32, device="cuda")
            sums = torch.zeros(k, d, device="cuda")
            counts = torch.zeros(k, device="cuda")
        out = hamerly_pass(x, c, h_lab, sums, counts, sb, slb, c_cd, csq, rno,
                           compute_dtype="bfloat16")
        h_lab, sums, counts, sb, slb, c_cd, csq = out[:7]
        c = apply_update(c, sums, counts)
    sb2, slb2, need = hamerly_bounds(c, h_lab, sb, slb, c_cd, csq, rno,
                                     bf16)[:3]
    _delta_bench_kernel(
        f"headline bf16 K4 (need {float(need.float().mean()):.4f})",
        lambda: K.lloyd_hamerly_cuda(x, c, h_lab, need, sb2, slb2,
                                     compute_dtype=bf16), 3, x, h_lab, bf16)
    del x, rno, sums, counts, sb, slb, sb2, slb2
    gen = torch.Generator(device="cuda").manual_seed(23)
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=f32)
    c = x[torch.randperm(n, generator=gen, device="cuda")[:k]].clone()
    prev = K.lloyd_pass_cuda(x, c, compute_dtype=f32, with_update=False)[0]
    c += 0.05 * torch.randn(k, d, generator=gen, device="cuda")
    need = torch.rand(n, generator=gen, device="cuda") < 0.134
    zeros = torch.zeros(n, device="cuda")
    _delta_bench_kernel("headline f32 K2", lambda: K.lloyd_delta_cuda(
        x, c, prev, compute_dtype=f32, with_mind=False), 2, x, prev, f32)
    _delta_bench_kernel("headline f32 K4 (need 0.134)",
                        lambda: K.lloyd_hamerly_cuda(
                            x, c, prev, need, zeros, zeros,
                            compute_dtype=f32), 3, x, prev, f32)


#: ``--fold-bench``: timed runs of each fold form and of the weighted
#: sweep and fit (the median is kept, after one warm-up run).
FOLD_BENCH_REPS = 3


def _fold_forms(x, labels, w, k, chunk=4096):
    """The plain route's fold at these inputs -- ``sums[l] += w·float(x)``,
    ``counts[l] += w`` over the rows -- in each form ``--fold-bench``
    times, as closures returning ``(sums, counts)``: ``index_add_`` (float
    atomics: the order varies from run to run), ``index_put_(accumulate=
    True)`` (sort-based: each output row summed in row order), the fold
    core's order (``fold_core_plain``) and a one-hot product in IEEE f32
    (``full_f32``; counts the one-hot matrix's column sums), each over
    row chunks folded in turn."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.distance import full_f32

    n, d = x.shape

    def scatter(add, rows=chunk):
        def run():
            sums = torch.zeros(k, d, device=x.device)
            counts = torch.zeros(k, device=x.device)
            for lo in range(0, n, rows):
                lab, wr = labels[lo:lo + rows].long(), w[lo:lo + rows]
                add(sums, lab, x[lo:lo + rows].float() * wr[:, None])
                add(counts, lab, wr)
            return sums, counts
        return run

    def put(t, i, v):
        t.index_put_((i,), v, accumulate=True)

    def onehot(rows):
        def run():
            sums = torch.zeros(k, d, device=x.device)
            counts = torch.zeros(k, device=x.device)
            with full_f32():
                for lo in range(0, n, rows):
                    hot = torch.nn.functional.one_hot(
                        labels[lo:lo + rows].long(), k).float()
                    hot *= w[lo:lo + rows, None]
                    sums += hot.T @ x[lo:lo + rows].float()
                    counts += hot.sum(dim=0)
            return sums, counts
        return run

    return {
        "index_add_": scatter(lambda t, i, v: t.index_add_(0, i, v)),
        "index_put_(accumulate=True)": scatter(put),
        "index_put_(accumulate=True), 32768-row chunks": scatter(put, 32768),
        "fold_core_plain order": lambda: K.fold_core_plain(
            x, w, labels, None, k, compute_dtype=torch.float32),
        f"one-hot f32, {chunk}-row chunks": onehot(chunk),
        "one-hot f32, 32768-row chunks": onehot(32768),
    }


def phase_fold_bench():
    """The plain route's weighted fold on the card, for the tree this
    script runs in (copy it over an older checkout's to compare two
    commits in one call, in turns): at the headline shape (phase 4's bf16
    data, K1's labels at its c0, weights uniform in [0.25, 1.25)), each
    form of :func:`_fold_forms` twice (bit for bit or not) and against an
    f64 fold, with its CUDA-event time; one weighted sweep through
    ``lloyd_pass(update="segment")`` (the weights veto's plain route);
    and phase 5's fractional-weights fit (n = 20,000, d = 64, k = 16, 20
    sweeps) on the host clock."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    x, c0 = _headline_data()
    n, d, k = x.shape[0], x.shape[1], c0.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(21)
    w = torch.rand(n, generator=gen, device="cuda") + 0.25
    labels = K.lloyd_pass_cuda(x, c0, compute_dtype=torch.bfloat16,
                               with_update=False)[0]
    want = torch.zeros(k, d, dtype=torch.float64, device="cuda")
    for lo in range(0, n, 32768):
        hot = torch.nn.functional.one_hot(labels[lo:lo + 32768].long(),
                                          k).double()
        want += (hot * w[lo:lo + 32768, None].double()).T @ x[
            lo:lo + 32768].double()
    scale = float(want.abs().max())
    for name, fn in _fold_forms(x, labels, w, k).items():
        (s1, c1), (s2, c2) = fn(), fn()
        _sync()
        same = ("equal bit for bit" if torch.equal(s1, s2)
                and torch.equal(c1, c2) else
                f"differ, sums by up to {float((s1 - s2).abs().max())!r}")
        err = float((s1.double() - want).abs().max()) / scale
        ms = _time_ms(fn, FOLD_BENCH_REPS)
        print(f"fold-bench headline fold ({n} x {d} bf16 rows, k={k}, "
              f"fractional weights) {name}: {ms:.3f} ms; two runs {same}; "
              f"max |sums - f64| / max |f64| {err:.3e}", flush=True)
        del s1, s2, c1, c2
    del want
    # By k at the glove shape: the sorted sum sums each segment's rows in
    # sequence, the one-hot product costs 2·n·k·d.
    ng, dg = 400_000, 300
    xg = torch.randn(ng, dg, generator=gen, device="cuda")
    wg = torch.rand(ng, generator=gen, device="cuda") + 0.25
    for kk in (2, 8, 32, 128, 256, 1000):
        lab = torch.randint(0, kk, (ng,), generator=gen, device="cuda")
        forms = _fold_forms(xg, lab, wg, kk)
        put, hot = (_time_ms(forms[name], FOLD_BENCH_REPS) for name in (
            "index_put_(accumulate=True), 32768-row chunks",
            "one-hot f32, 32768-row chunks"))
        print(f"fold-bench glove-shape fold ({ng} x {dg} f32 rows, "
              f"fractional weights) k={kk}: index_put_ {put:.3f} ms, "
              f"one-hot {hot:.3f} ms (32768-row chunks)", flush=True)
    del xg, wg, lab, forms

    def sweep():
        return kt.lloyd_pass(x, c0, weights=w, compute_dtype="bfloat16",
                             update="segment")
    K.reset_launch_counts()
    got, again = sweep(), sweep()
    _sync()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    _check(not any(K.launch_counts().values()),
           f"fold-bench: the weighted sweep launched {K.launch_counts()}")
    print(f"fold-bench headline weighted bf16 sweep (lloyd_pass, "
          f"update='segment', the plain route): "
          f"{_time_ms(sweep, FOLD_BENCH_REPS):.3f} ms; two sweeps "
          f"{'equal bit for bit' if same else 'differ'}", flush=True)
    del x, c0, w, labels, got, again
    torch.cuda.empty_cache()

    fn = _fractional_fit_inputs()[0]
    fits, secs = [fn() for _ in range(2)], []
    for _ in range(FOLD_BENCH_REPS):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        secs.append(time.perf_counter() - t0)
    a, b = fits
    same = (torch.equal(a.cluster_centers_, b.cluster_centers_)
            and torch.equal(a.labels_, b.labels_))
    print(f"fold-bench phase 5 fractional-weights bf16 fit (n=20000, d=64, "
          f"k=16, 20 sweeps): {', '.join(f'{t:.4f}' for t in secs)} s "
          f"(median {statistics.median(secs):.4f}); two fits "
          f"{'equal bit for bit' if same else 'differ'}", flush=True)


#: ``--select-bench``: timed runs of each selection (the median is kept),
#: and of the fit after a warm-up one.
SELECT_BENCH_REPS = 20
SELECT_FIT_REPS = 3


def phase_select_bench():
    """The selections by value on the card, for the tree this script runs
    in (copy it over an older checkout's to compare two commits in one
    call, in turns), each a CUDA-event median: ``torch.topk`` (the
    parent's reseed), a stable descending sort of the order keys (the
    parent's trim) and the tree's ``ops.select.top_stable`` where it has
    one, at m = k = 1000 (the reseed) and m = n / 20 (a 5% trim), and the
    tree's whole ``reseed_empty_farthest`` with ten empty slots, at the
    headline (phase 4's bf16 data, K1's min_d2 at its c0) and at glove's
    shape (phase 5's data, K1's min_d2 at its first k rows); then the bf16
    ``KMeans(empty="farthest")`` fit at glove's shape (k-means++ from
    seed 0) on the host clock."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.trimmed import order_keys
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.update import reseed_empty_farthest

    try:
        from kmeans_tpu_torch.ops.select import top_stable
    except ImportError:
        top_stable = None
    bf16 = torch.bfloat16
    for shape in ("headline", "glove"):
        if shape == "headline":
            x, c0 = _headline_data()
        else:
            x = kt.make_blobs(5, 400_000, 300, 1000)[0]
            c0 = x[:1000].float()
        n, k = x.shape[0], c0.shape[0]
        min_d2 = K.lloyd_pass_cuda(x, c0, compute_dtype=bf16,
                                   with_update=False)[1]
        counts = torch.ones(k, device="cuda")
        counts[::100] = 0.0
        for m in (k, n // 20):
            forms = {
                "torch.topk": lambda: torch.topk(min_d2, m),
                "stable sort of the order keys": lambda: torch.sort(
                    order_keys(min_d2), descending=True,
                    stable=True).indices[:m]}
            if top_stable is not None:
                forms["top_stable"] = lambda: top_stable(min_d2, m)
            for name, fn in forms.items():
                ms = _time_ms(fn, SELECT_BENCH_REPS)
                print(f"select-bench {shape} (n={n}) m={m} {name}: "
                      f"{ms:.4f} ms", flush=True)
        ms = _time_ms(lambda: reseed_empty_farthest(c0, counts, x, min_d2),
                      SELECT_BENCH_REPS)
        print(f"select-bench {shape} (n={n}, k={k}) reseed_empty_farthest: "
              f"{ms:.4f} ms", flush=True)
        del x, c0, min_d2
        torch.cuda.empty_cache()

    x = kt.make_blobs(5, 400_000, 300, 1000)[0]

    def fit():
        return kt.KMeans(n_clusters=1000, empty="farthest",
                         compute_dtype="bfloat16", seed=0).fit(x)
    fit()
    secs, sweeps = [], []
    for _ in range(SELECT_FIT_REPS):
        _sync()
        t0 = time.perf_counter()
        km = fit()
        _sync()
        secs.append(time.perf_counter() - t0)
        sweeps.append(km.n_iter_)
    print(f"select-bench glove-shape bf16 KMeans(empty='farthest') fit "
          f"(n=400000, d=300, k=1000): {', '.join(f'{t:.4f}' for t in secs)}"
          f" s (median {statistics.median(secs):.4f}), {sweeps} sweeps, "
          f"inertia {km.inertia_!r}", flush=True)


# ---------------------------------------------------------------------------
# Phase 5: whole fits against the plain backend
# ---------------------------------------------------------------------------

def phase_whole_fit():
    import kmeans_tpu_torch as kt

    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.cuda_lloyd import scoring_core

    n, d, k = 400_000, 300, 1000
    x, _, _ = kt.make_blobs(5, n, d, k)
    core = scoring_core(x.to(torch.bfloat16), torch.bfloat16)
    print(f"scoring core of K1 and K2 at the glove shape (d = {d}): {core}")
    _check(core == "score_block", "the glove shape took the Hopper core")
    # The kernels each fit must launch: K1 and K2 on the delta loop, and
    # K4 too on the adaptive loop's yinyang periods.
    expect = {"delta": ("lloyd_pass_cuda", "lloyd_delta_cuda"),
              "auto": ("lloyd_pass_cuda", "lloyd_delta_cuda",
                       "lloyd_hamerly_cuda")}
    for update in ("delta", "auto"):
        fits = {}
        for backend in ("auto", "plain"):
            K.reset_launch_counts()
            t0 = time.perf_counter()
            km = kt.KMeans(n_clusters=k, update=update,
                           compute_dtype="bfloat16", seed=0, backend=backend)
            km.fit(x)
            _sync()
            counts = K.launch_counts()
            fits[backend] = km
            print(f"KMeans glove shape update={update} backend={backend}: "
                  f"{km.n_iter_} sweeps, converged "
                  f"{bool(km.state.converged)}, inertia {km.inertia_:.6e}, "
                  f"{time.perf_counter() - t0:.3f} s; diag {km.diag_}; "
                  f"launches {counts}")
            if backend == "auto":
                missing = [name for name in expect[update]
                           if not counts.get(name)]
                _check(not missing, f"whole fit update={update} "
                       f"backend=auto launched none of {missing}")
            else:
                _check(not any(counts.values()), f"whole fit update="
                       f"{update} backend=plain launched kernels: {counts}")
        a, b = fits["auto"].inertia_, fits["plain"].inertia_
        _check(abs(a - b) <= FIT_INERTIA_RTOL * abs(b),
               f"whole fit update={update}: kernel inertia {a} vs plain {b} "
               f"beyond rtol {FIT_INERTIA_RTOL}")
        _check(_finite(fits["auto"].cluster_centers_),
               f"whole fit update={update}: non-finite centroids")
    _fractional_weights_fit()
    _tied_outlier_fit()


def _fractional_fit_inputs():
    """Phase 5's fractional-weights problem on the card: ``(fit, x, w)``,
    ``fit(dev)`` the bf16 ``KMeans`` fit of x under weights w on ``dev``
    (default: the card) from centres near the blobs'."""
    import torch

    import kmeans_tpu_torch as kt

    n, d, k = 20_000, 64, 16
    x, _, centres = kt.make_blobs(4, n, d, k)
    gen = torch.Generator(device="cuda").manual_seed(4)
    w = torch.rand(n, generator=gen, device="cuda") + 0.25
    # Started near the blob centres, both fits find the same partition:
    # no label is left to a tie within the two devices' summation orders.
    c0 = centres + 0.1 * torch.randn(k, d, generator=gen, device="cuda")

    def fit(dev="cuda"):
        return kt.KMeans(n_clusters=k, compute_dtype="bfloat16",
                         init=c0.to(dev), max_iter=20, tol=-1.0,
                         device=dev).fit(x.to(dev), weights=w.to(dev))
    return fit, x, w


def _fractional_weights_fit():
    """``KMeans(compute_dtype="bfloat16").fit`` with fractional weights on
    the card: the kernel plan's weights veto refuses it (the reference's
    exactness policy: bf16 would round the weights in its fold), so
    ``backend="auto"`` takes the plain route on the card, as the
    reference's ``"auto"`` takes XLA, with the ``"segment"`` update, and
    ``fit_plan`` says why; no kernel launches, the fit agrees with the
    same fit on the CPU, and a second fit on the card equals the first
    bit for bit.  Both start from the same centres: k-means++ draws from
    each device's own generator, so the two fits would start apart and
    could settle in different partitions.  Then the same data seeded with
    k-means|| in bf16 under the weights (its candidates' weights and its
    refine fit on the plain route), twice, bit for bit."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.plan import WEIGHTS_VETO

    fit, x, w = _fractional_fit_inputs()
    n, d = x.shape
    k = 16
    plan = kt.fit_plan(x, k, config=kt.KMeansConfig(
        k=k, compute_dtype="bfloat16"), weights=w)
    _check(plan["backend"] == "plain" and plan["update"] == "segment"
           and plan["why"] == WEIGHTS_VETO,
           f"fractional weights in bf16 on the card: plan {plan}")
    fits = {}
    for dev in ("cuda", "cpu"):
        K.reset_launch_counts()
        km = fit(dev)
        _sync()
        fits[dev] = (km, K.launch_counts())
    (card, counts), (cpu, _) = fits["cuda"], fits["cpu"]
    _check(not any(counts.values()),
           f"the plain route on the card launched kernels: {counts}")
    a, b = card.inertia_, cpu.inertia_
    moved = int((card.labels_.cpu() != cpu.labels_).sum())
    _check(abs(a - b) <= FIT_INERTIA_RTOL * abs(b) and _finite(
        card.cluster_centers_), f"fractional-weights fit: card inertia {a} "
           f"vs CPU {b} beyond rtol {FIT_INERTIA_RTOL}")
    again = fit()
    _check(torch.equal(again.cluster_centers_, card.cluster_centers_)
           and torch.equal(again.labels_, card.labels_)
           and again.inertia_ == card.inertia_,
           "fractional-weights fit: a second fit on the card differs")
    print(f"KMeans(compute_dtype='bfloat16') with fractional weights, n={n} "
          f"d={d} k={k}: plan {plan['backend']} / {plan['update']}, no "
          f"kernel launched; inertia {a:.6e} on the card, {b:.6e} on the "
          f"CPU; {moved} labels differ; a second card fit equal bit for "
          "bit")

    def seeded():
        return kt.KMeans(n_clusters=k, init="k-means||", seed=4,
                         compute_dtype="bfloat16", max_iter=20,
                         tol=-1.0).fit(x, weights=w)
    first, second = seeded(), seeded()
    _check(torch.equal(first.cluster_centers_, second.cluster_centers_)
           and torch.equal(first.labels_, second.labels_),
           "k-means|| in bf16 under fractional weights: two fits differ")
    _check(_finite(first.cluster_centers_), "k-means|| fit: non-finite")
    print(f"KMeans(init='k-means||', compute_dtype='bfloat16') with "
          f"fractional weights: inertia {first.inertia_:.6e}, two fits "
          "equal bit for bit")


#: Phase 5's tied-outlier fit: blob rows at the origin, then 2·d outliers
#: at +8·e_i and -8·e_i (in that order), every one at min_d2 64 exactly
#: from a centroid at the origin.
TIED_N, TIED_D = 200_000, 64


def _tied_outlier_inputs():
    """``(x, c0)`` of the tied-outlier fit, made on the card: c0 is one
    centroid at the origin and three at 1e3, so the first sweep empties
    three clusters and the farthest reseed picks among the tied
    outliers."""
    import torch

    d = TIED_D
    gen = torch.Generator(device="cuda").manual_seed(13)
    blob = 0.1 * torch.randn(TIED_N - 2 * d, d, generator=gen,
                             device="cuda")
    eye = 8 * torch.eye(d, device="cuda")
    x = torch.cat([blob, eye, -eye])
    c0 = torch.full((4, d), 1e3, device="cuda")
    c0[0] = 0.0
    return x, c0


def _tied_outlier_fit():
    """``KMeans(empty="farthest")`` on rows whose worst fits tie (ROADMAP
    C13), twice on the kernels and once on ``backend="plain"``: each fit
    reseeds its three empty clusters onto the three lowest-index outliers
    (``lax.top_k``'s order; ``torch.topk`` fixes none, and the card's
    differs from the CPU's), the kernel fits launch K1 and K2 and equal
    each other bit for bit, the plain fit launches nothing and gives the
    same labels."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    x, c0 = _tied_outlier_inputs()
    first = TIED_N - 2 * TIED_D
    want = x[first:first + 3]
    fits = []
    for backend in ("auto", "auto", "plain"):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        km = kt.KMeans(n_clusters=4, init=c0, empty="farthest",
                       backend=backend).fit(x)
        _sync()
        secs = time.perf_counter() - t0
        counts = K.launch_counts()
        fits.append(km)
        picked = [int(i) for i in torch.cdist(
            km.cluster_centers_[1:], x[first:]).argmin(dim=1)]
        print(f"tied-outlier fit (n={TIED_N}, d={TIED_D}, k=4, "
              f"empty='farthest') backend={backend}: {km.n_iter_} sweeps, "
              f"inertia {km.inertia_!r}, {secs:.3f} s; reseeded onto "
              f"outliers {picked}; launches {counts}")
        _check(torch.equal(km.cluster_centers_[1:], want),
               f"tied-outlier fit backend={backend}: reseeded onto outliers "
               f"{picked}, not the lowest-index [0, 1, 2]")
        if backend == "auto":
            _check(counts.get("lloyd_pass_cuda") and counts.get(
                "lloyd_delta_cuda"), f"tied-outlier fit: launches {counts}")
        else:
            _check(not any(counts.values()),
                   f"tied-outlier fit backend=plain launched {counts}")
    a, b, plain = fits
    _check(torch.equal(a.cluster_centers_, b.cluster_centers_)
           and torch.equal(a.labels_, b.labels_)
           and a.inertia_ == b.inertia_,
           "tied-outlier fit: two fits on the card differ")
    _check(torch.equal(a.labels_, plain.labels_)
           and a.n_iter_ == plain.n_iter_,
           "tied-outlier fit: the kernels' labels differ from the plain "
           "backend's")
    print("tied-outlier fit: two card fits equal bit for bit, the plain "
          "backend's labels and sweeps equal")


# ---------------------------------------------------------------------------
# Phase 6: the codebook shape, where the planner tiles
# ---------------------------------------------------------------------------

def _plans():
    """The planner's decision for every kind at the headline, glove and
    codebook shapes (bf16, then f32), on this card's budget; in f32 the
    scoring core at each shape (the core's f32 route: d % 4 == 0)."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops import plan as P

    budget = P.card_budget()
    print(f"planner budget: {budget.l2_bytes} B of L2 (3/4), "
          f"{budget.smem_per_block} B of shared memory a block "
          f"({budget.source})")
    shapes = {"headline": (HEADLINE["d"], HEADLINE["k"]), "glove": (300, 1000),
              "codebook": (CODEBOOK["d"], CODEBOOK["k"])}
    for name, (d, k) in shapes.items():
        for kind in P.KINDS:
            plan = P.kernel_plan(kind, d, k, budget=budget)
            print(f"  plan {name} {kind}: {plan.mode}, k_tile {plan.k_tile}: "
                  f"{plan.why}")
            want = "tiled" if name == "codebook" else "untiled"
            _check(plan.mode == want, f"plan {name} {kind}: {plan.mode}, "
                   f"not {want}")
    for name, (d, k) in shapes.items():
        x = torch.empty(2, d, device="cuda")
        core = K.scoring_core(x, torch.float32, torch.empty(3, d,
                                                            device="cuda"))
        plans = {kind: P.kernel_plan(kind, d, k, x_itemsize=4,
                                     cd_itemsize=4, budget=budget)
                 for kind in P.CORE_KINDS}
        print(f"  plan {name} in f32 (core {core}): " + "; ".join(
            f"{kind} {p.mode}, k_tile {p.k_tile}" for kind, p in
            plans.items()))
        want = "tiled" if name == "codebook" else "untiled"
        _check(core == "wgmma" and all(p.mode == want
                                       for p in plans.values()),
               f"plan {name} in f32: core {core}, plans {plans}")


def _counted_run(fn):
    """``(fn(), launch counts of that run)``: counts set to 0 just before
    and read just after."""
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    K.reset_launch_counts()
    out = fn()
    _sync()
    return out, K.launch_counts()


def _add_counts(total, counts):
    for name, v in counts.items():
        total[name] = total.get(name, 0) + v


def _k5_variants(x, neg2c, csq, k_tile, lab5, raw5, k5_ms, dist_ops):
    """K5 at the codebook shape beside the main path's launch (``k5_ms``,
    raw scores): with the second-min (the tiled Hamerly sweep's call) and
    on ``score_block``, each with labels and raw min equal bit for bit."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    def k5(**kw):
        return K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                   raw_scores=True, **kw)

    second_ms, got2 = _time_auto(lambda: k5(with_second=True))
    with _ForcedScoreBlock():
        sb_ms, got3 = _time_auto(k5)
    for what, out in (("with_second", got2), ("score_block", got3)):
        _check(bool(torch.equal(out[0], lab5) and torch.equal(out[1], raw5)),
               f"K5 codebook {what}: labels or raw min differ")
    print(f"K5 codebook raw {k5_ms:.3f} ms ({dist_ops / k5_ms / 1e9:.1f} "
          f"TFLOP/s); with the second-min {second_ms:.3f} ms; on score_block "
          f"{sb_ms:.3f} ms; labels and raw min bit for bit equal")


def phase_codebook(headline_launches):
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.hamerly import hamerly_pass, row_norms
    from kmeans_tpu_torch.ops.update import apply_update

    n, d, k = CODEBOOK["n"], CODEBOOK["d"], CODEBOOK["k"]
    bf16 = torch.bfloat16
    t_phase = time.perf_counter()
    _plans()
    t0 = time.perf_counter()
    x, _, _ = kt.make_blobs(11, n, d, k, dtype=bf16)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(2), x, k)
    _sync()
    print(f"codebook data: n={n} d={d} k={k} bf16 ({k} generator blobs, "
          f"init {k} random rows), {time.perf_counter() - t0:.2f} s to make")
    plan = kt.fit_plan(x, k, config=kt.KMeansConfig(
        k=k, update="delta", compute_dtype="bfloat16"))
    print(f"fit_plan (update='delta'): {plan}")
    _check(plan["mode"] == "tiled" and plan["k_tile"] % 128 == 0,
           "the codebook delta fit is not planned tiled")
    k_tile = plan["k_tile"]
    launches = {}

    # The main path, in three runs.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    km, counts = _counted_run(lambda: kt.KMeans(
        n_clusters=k, update="delta", compute_dtype="bfloat16", init=c0,
        max_iter=CODEBOOK_SWEEPS, tol=-1.0).fit(x))
    fit_s = time.perf_counter() - t0
    _add_counts(launches, counts)
    c = km.cluster_centers_
    print(f"KMeans(update='delta', max_iter={CODEBOOK_SWEEPS}, tol=-1): "
          f"{km.n_iter_} sweeps + final view in {fit_s:.3f} s = "
          f"{km.n_iter_ / fit_s:.4f} iter/s (final view included); inertia "
          f"{km.inertia_:.6e}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    print(f"  launches: {counts}")
    _check(counts["tiled_argmin_cuda"] == CODEBOOK_SWEEPS + 1
           and counts["tiled_fold_cuda"] == CODEBOOK_SWEEPS + 1
           and sum(counts.values()) == 2 * (CODEBOOK_SWEEPS + 1),
           "the codebook fit launched other kernels than K5 and K6")
    _check(km.n_iter_ == CODEBOOK_SWEEPS and _finite(c)
           and math.isfinite(km.inertia_),
           "codebook fit: wrong sweep count or non-finite result")
    t0 = time.perf_counter()
    plain = K.lloyd_pass_plain(x, c, compute_dtype=bf16, with_update=False)
    _sync()
    plain_s = time.perf_counter() - t0
    moved = _check_labels_rows("codebook fit", x, c, bf16, km.labels_,
                               plain[0])
    print(f"  labels against the plain route at the final centroids: {moved} "
          f"rows differ, each a tie within {SCORE_RTOL} (plain sweep "
          f"{plain_s:.3f} s)")

    zeros_s = torch.zeros(k, d, device="cuda")
    zeros_c = torch.zeros(k, device="cuda")
    refresh, counts = _counted_run(lambda: kt.delta_pass(
        x, c, km.labels_, zeros_s, zeros_c, compute_dtype="bfloat16",
        force_full=True))
    _add_counts(launches, counts)
    print(f"delta_pass(force_full=True): {int(refresh[5])} rows changed; "
          f"launches {counts}")
    _check(counts["tiled_argmin_cuda"] == 1 and counts["tiled_fold_cuda"] == 2
           and sum(counts.values()) == 3,
           "delta_pass(force_full=True) did not run K5 and K6 only")
    _check(int(refresh[3].sum()) == n and _finite(refresh[2]),
           "delta_pass(force_full=True): counts do not sum to n")

    rno = row_norms(x, compute_dtype=bf16)
    hc = c0.clone()
    lab = torch.full((n,), -1, dtype=torch.int32, device="cuda")
    sb = torch.zeros(n, device="cuda")
    slb = torch.zeros(n, device="cuda")
    c_cd, csq = c0.to(bf16), torch.zeros(k, device="cuda")
    sums, hcounts = zeros_s, zeros_c
    recs, diffs = [], []
    for i in range(CODEBOOK_HAMERLY_SWEEPS):
        out, counts = _counted_run(lambda: hamerly_pass(
            x, hc, lab, sums, hcounts, sb, slb, c_cd, csq, rno,
            compute_dtype="bfloat16"))
        _add_counts(launches, counts)
        _check(counts["tiled_argmin_cuda"] == 1
               and counts["tiled_fold_cuda"] == 1
               and sum(counts.values()) == 2,
               f"tiled hamerly sweep {i}: launches {counts}")
        lab, sums, hcounts, sb, slb, c_cd, csq, n_rec = out
        full = K.tiled_argmin_cuda(x, *K._score_operands(hc, bf16),
                                   k_tile=k_tile, raw_scores=True)[0]
        diffs.append(_check_labels_rows(f"tiled hamerly sweep {i}", x, hc,
                                        bf16, lab, full))
        recs.append(int(n_rec))
        hc = apply_update(hc, sums, hcounts)
    print(f"hamerly on the tiled route ({CODEBOOK_HAMERLY_SWEEPS} sweeps): "
          f"rows needed per sweep {recs}; rows labelled differently from K5's "
          f"full scoring {diffs} (each a tie within {SCORE_RTOL})")
    print(f"codebook main path launches: {launches}")
    del rno, sb, slb, lab, sums

    # Timings at the state after the refresh: K5 and K6 against their
    # plain versions and library calls, then the same sweeps untiled.
    c1 = apply_update(c, refresh[2], refresh[3])
    prev = refresh[0]
    neg2c, csq = K._score_operands(c1, bf16)
    total = {name: headline_launches.get(name, 0) + launches.get(name, 0)
             for name in launches}
    rows = []
    xb, x_row = n * d * 2, n * 4
    dist_ops = 2.0 * n * d * k
    k5_ms, (lab5, raw5) = _time_auto(lambda: K.tiled_argmin_cuda(
        x, neg2c, csq, k_tile=k_tile, raw_scores=True))
    plain_ms, plain5 = _time_auto(lambda: K.tiled_argmin_plain(
        x, neg2c, csq, k_tile=k_tile, raw_scores=True))
    moved = _check_labels_rows("K5 codebook", x, c1, bf16, lab5, plain5[0])
    same = lab5 == plain5[0]
    err = _within("K5 codebook raw scores", raw5[same], plain5[1][same],
                  _row_scale(x, c1, bf16, lab5)[same])
    del plain5

    def library_argmin():
        out = torch.empty(n, dtype=torch.float32, device="cuda")
        idx = torch.empty(n, dtype=torch.int64, device="cuda")
        for s in range(0, n, 16384):
            part = torch.mm(x[s:s + 16384], neg2c.T, out_dtype=torch.float32)
            torch.min(part.add_(csq), dim=1, out=(out[s:s + 16384],
                                                  idx[s:s + 16384]))
        return out, idx

    library_ms, _ = _time_auto(library_argmin)
    print(f"K5 codebook (k_tile={k_tile}, {-(-k // k_tile)} slices): {moved} "
          "rows labelled differently from the plain version, each a tie "
          "within the tolerance")
    rows.append(_kernel_row(
        "tiled_argmin_cuda", total["tiled_argmin_cuda"], k5_ms, plain_ms,
        library_ms, err, xb + k * d * 2 + k * 4 + 2 * x_row, dist_ops, 0.0))
    _k5_variants(x, neg2c, csq, k_tile, lab5, raw5, k5_ms, dist_ops)

    # K6: the full single fold at K5's labels, then the dual fold at this
    # sweep's churn.
    got, again = (K.tiled_fold_cuda(x, None, lab5, None, k, compute_dtype=bf16)
                  for _ in range(2))
    _check(bool(torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                              again[1])),
           "K6 codebook: two launches differ")
    del again
    k6_ms, _ = _time_auto(lambda: K.tiled_fold_cuda(
        x, None, lab5, None, k, compute_dtype=bf16))
    k6_plain_ms, want = _time_auto(lambda: K.tiled_fold_plain(
        x, None, lab5, None, k, compute_dtype=bf16, k_tile=k_tile))
    err = _close("K6 codebook sums", got[0], want[0])
    _check(bool(torch.equal(got[1], want[1])), "K6 codebook counts")
    del got, want
    xf = x.float()
    lab_long = lab5.long()
    k6_lib_ms, _ = _time_auto(lambda: torch.zeros(k, d, device="cuda")
                              .index_add_(0, lab_long, xf))
    rows.append(_kernel_row(
        "tiled_fold_cuda", total["tiled_fold_cuda"], k6_ms, k6_plain_ms,
        k6_lib_ms, err, xb + 2 * x_row + k * d * 4 + k * 4, 0.0,
        2.0 * n * d))
    changed = lab5 != prev
    n_changed = int(changed.sum())
    wch = changed.float()
    dual_ms, got = _time_auto(lambda: K.tiled_fold_cuda(
        x, wch, lab5, prev, k, compute_dtype=bf16))
    dual_plain_ms, want = _time_auto(lambda: K.tiled_fold_plain(
        x, wch, lab5, prev, k, compute_dtype=bf16, k_tile=k_tile))
    _close("K6 codebook dual sums", got[0], want[0])
    _check(bool(torch.equal(got[1], want[1])), "K6 codebook dual counts")
    rows_ch = changed.nonzero()[:, 0]
    dual_lib_ms, _ = _time_auto(lambda: torch.zeros(k, d, device="cuda")
                                .index_add_(0, lab_long[rows_ch], xf[rows_ch])
                                .index_add_(0, prev[rows_ch].long(),
                                            xf[rows_ch], alpha=-1.0))
    bound, by = _bound_ms(n_changed * d * 2 + 3 * x_row + k * d * 4 + k * 4,
                          0.0, 4.0 * n_changed * d)
    print(f"K6 dual at this sweep's churn ({n_changed} of {n} rows changed): "
          f"{dual_ms:.3f} ms (bound {bound:.3f} ms by {by}), plain "
          f"{dual_plain_ms:.3f} ms, library (two index_add_ of the changed "
          f"f32 rows) {dual_lib_ms:.3f} ms")
    del got, want, xf, lab_long

    # The same sweeps untiled: K1 and K2 at the codebook shape.
    k1_ms, k1 = _time_auto(lambda: K.lloyd_pass_cuda(x, c1,
                                                     compute_dtype=bf16))
    _check(bool(torch.equal(k1[0], lab5)), "K1 codebook labels differ from "
           "K5's")
    del k1
    k2_ms, k2 = _time_auto(lambda: K.lloyd_delta_cuda(
        x, c1, prev, compute_dtype=bf16, with_mind=False))
    _check(bool(torch.equal(k2[0], lab5) and torch.equal(k2[1], raw5)),
           "K2 codebook labels or raw scores differ from K5's")
    del k2
    k5n_ms, _ = _time_auto(lambda: K.tiled_argmin_cuda(
        x, neg2c, csq, k_tile=k_tile))
    bound = _bound_ms(xb, dist_ops)[0]
    print(f"codebook classic sweep (bound {bound:.3f} ms): untiled K1 "
          f"{k1_ms:.3f} ms; tiled K5 {k5n_ms:.3f} + K6 {k6_ms:.3f} = "
          f"{k5n_ms + k6_ms:.3f} ms")
    print(f"codebook delta sweep (bound {bound:.3f} ms): untiled K2 "
          f"{k2_ms:.3f} ms; tiled K5 raw {k5_ms:.3f} + K6 dual "
          f"{dual_ms:.3f} = {k5_ms + dual_ms:.3f} ms")
    print(f"codebook phase: {time.perf_counter() - t_phase:.1f} s")
    return rows, launches, c.float().cpu().numpy()


# ---------------------------------------------------------------------------
# Phase 7: K6's launches one by one
# ---------------------------------------------------------------------------

#: The dual fold's share of changed rows in the split: a steady sweep's
#: churn at the codebook shape is a few percent of the rows.
SPLIT_CHURN = 0.02
#: K6 calls in each profile of the split.
SPLIT_REPS = 5
#: Idle seconds at each end of a profile's recording: kineto drops a
#: device record whose span, mapped onto the host's clock, falls outside
#: the recording's window, and a call that starts or ends right at the
#: window's edge can lose its launches that way.
SPLIT_EDGE_S = 0.1


def _kernel_name(name):
    """A profiled kernel's name without ``void``, the anonymous namespace
    and its argument list (a memset or a copy keeps its name)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i in range(len(name) - 1, 0, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] if name[i] == "(" and name[i - 1] != " " else name
    return name


def _device_split(fn, reps):
    """``fn()`` run ``reps`` times under ``torch.profiler`` (CUPTI) after
    one warm-up run: ``[(kernel name, launches a call, ms a call)]`` in the
    order the kernels first ran, memsets and copies included.  The
    profiler's own warm-up step takes one more call, whose records are
    dropped: tracing starts with it, so no measured call loses the
    launches that ran while CUPTI was being enabled.  The recording opens
    and closes SPLIT_EDGE_S away from the first and the last measured
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    _sync()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps,
                                   repeat=1)) as prof:
        fn()
        _sync()
        prof.step()
        time.sleep(SPLIT_EDGE_S)
        for rep in range(reps):
            fn()
            _sync()
            if rep == reps - 1:
                time.sleep(SPLIT_EDGE_S)
            prof.step()
    split = {}
    for evt in sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start):
        name = _kernel_name(evt.name)
        launches, us = split.get(name, (0, 0.0))
        split[name] = (launches + 1,
                       us + evt.time_range.end - evt.time_range.start)
    _check(split, "the profiler recorded no device time")
    return [(name, launches / reps, us / 1e3 / reps)
            for name, (launches, us) in split.items()]


def phase_fold_split():
    """K6's device time split by kernel on seeded inputs at the full width
    (x: n = 1,280,000, d = 2048, bf16, standard normal): (a) the single
    fold at k = 1000 (K1's fold and K3's workload), (b) the single fold at
    k = 65536, (c) the dual fold at k = 65536 with SPLIT_CHURN of the rows
    changed (w = 1 on them, 0 elsewhere).  Each kernel's time is its
    CUPTI duration in a ``torch.profiler`` trace of SPLIT_REPS ordinary
    ``tiled_fold_cuda`` calls; the whole call and the scratch set-up
    (``_fold_scratch``) alone are timed with CUDA events.  Written against
    ``tiled_fold_cuda`` and ``_fold_scratch`` only, so that it also splits
    an older tree's K6."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    n, d = CODEBOOK["n"], CODEBOOK["d"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(n, d, generator=gen, device="cuda", dtype=torch.bfloat16)
    cases = []
    for case, k, dual in (("a", HEADLINE["k"], False),
                          ("b", CODEBOOK["k"], False),
                          ("c", CODEBOOK["k"], True)):
        lab = torch.randint(0, k, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        w, lab2 = None, None
        if dual:
            changed = torch.rand(n, generator=gen, device="cuda") < SPLIT_CHURN
            step = torch.randint(1, k, (n,), generator=gen, device="cuda",
                                 dtype=torch.int32)
            lab2 = torch.where(changed, (lab + step) % k, lab)
            w = changed.float()
        cases.append((case, k, dual, lab, lab2, w))
    for case, k, dual, lab, lab2, w in cases:
        def call():
            return K.tiled_fold_cuda(x, w, lab, lab2, k,
                                     compute_dtype=torch.bfloat16)

        whole = _time_ms(call, 5)
        scratch_ms = _time_ms(lambda: K._fold_scratch(x, k, dual), 5)
        split = _device_split(call, SPLIT_REPS)
        what = (f"K6 split ({case}) {'dual' if dual else 'single'} fold, "
                f"n={n} d={d} k={k}"
                + (f", {int(w.sum())} rows changed" if dual else ""))
        print(f"{what}: whole K6 {whole:.3f} ms (CUDA events), scratch "
              f"set-up {scratch_ms:.3f} ms; profile of {SPLIT_REPS} calls: "
              f"{sum(c for _, c, _ in split):g} launches and "
              f"{sum(t for _, _, t in split):.3f} ms of device time a call")
        for name, launches, ms in split:
            print(f"  {name}: {launches:g} a call, {ms:.3f} ms a call")
        torn = [name for name, launches, _ in split
                if launches != int(launches)]
        _check(not torn,
               f"the profile of K6 at k={k} lost records: {', '.join(torn)} "
               f"ran a number of times that is not a multiple of the "
               f"{SPLIT_REPS} calls")
        passes = getattr(K, "fold_sort_passes", None)
        hists = sum(launches for name, launches, _ in split
                    if name.startswith("sort_hist_kernel"))
        _check(passes is None or hists == passes(k),
               f"K6 at k={k} made {hists} radix passes a call, not "
               f"fold_sort_passes' {passes and passes(k)}")


# ---------------------------------------------------------------------------
# Phase 8: serving the fitted models through the assignment engine
# ---------------------------------------------------------------------------

#: Closed-loop client threads and seconds of load a run (tools/loadgen.py
#: --bench's shape); the new generation is published half-way.
SERVE_CLIENTS = 48
SERVE_SECONDS = 3.0
#: Query rows each model's requests draw slices from, made once a model
#: (its centroids plus unit noise) and labelled by K5 per generation.
SERVE_POOL = 16384
#: The longest a run waits past SERVE_SECONDS for a response from the new
#: generation (its prepared model is built on the dispatcher, as in the
#: reference: at k = 65536 tens of seconds).
SERVE_SWAP_WAIT_S = 240.0


def _serve_load(eng, registry, pool, points, new_centroids):
    """SERVE_CLIENTS closed-loop clients submitting ``points``-row slices
    of ``pool`` for SERVE_SECONDS, the registry publishing
    ``new_centroids`` as generation 2 half-way; the load runs on until a
    response from generation 2 arrives.  Returns ``(responses, errors,
    seconds, publish_s, publish_to_first_s)``; a response is ``(first row,
    labels, generation, latency s, completion s)``, times from the start
    of the load."""
    import threading

    rows = pool.shape[0]
    slots = rows // points
    responses, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()
    counter = iter(range(10 ** 12))
    first_new = []

    def client():
        while not stop.is_set():
            with lock:
                i = next(counter)
            lo = (i % slots) * points
            t0 = time.perf_counter()
            try:
                labels, gen = eng.submit(pool[lo:lo + points])
            except Exception as e:      # a dropped request fails the run
                with lock:
                    errors.append(repr(e))
                continue
            t1 = time.perf_counter()
            with lock:
                responses.append((lo, labels, gen.generation, t1 - t0,
                                  t1 - t_start))
                if gen.generation == 2 and not first_new:
                    first_new.append(t1)

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(SERVE_CLIENTS)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(SERVE_SECONDS / 2)
    t_pub = time.perf_counter()
    registry.publish(new_centroids, generation=2)
    deadline = t_pub + SERVE_SWAP_WAIT_S
    while (time.perf_counter() < t_start + SERVE_SECONDS or not first_new) \
            and time.perf_counter() < deadline and not errors:
        time.sleep(0.01)
    stop.set()
    for t in threads:
        t.join(timeout=60.0)
    seconds = time.perf_counter() - t_start
    _check(not any(t.is_alive() for t in threads), "a serving client hung")
    return (responses, errors, seconds, t_pub - t_start,
            (first_new[0] - t_pub) if first_new else None)


def _percentiles(seconds):
    """(p50, p99, max) in ms of a list of latencies in seconds."""
    lat = sorted(seconds) or [float("nan")]
    return (1e3 * lat[len(lat) // 2],
            1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            1e3 * lat[-1])


def _pool_labels(pool_t, centroids, k_tile):
    """K5's labels (f32, raw scores) of every pool row against
    ``centroids``: what every response of that generation must equal."""
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    c = centroids.cuda()
    return K.tiled_argmin_cuda(pool_t, (c * -2).contiguous(),
                               (c * c).sum(dim=1).contiguous(),
                               k_tile=k_tile, raw_scores=True)[0]


def _serve_run(name, route, card, centroids, pool, points, perm, cfg_kw):
    """One engine run of phase 8: the prepared model's build timed, then
    the load with its counts set to 0 before and read after, each response
    held against K5's labels of its own generation."""
    import dataclasses

    import numpy as np
    import torch

    from kmeans_tpu_torch.config import ServeConfig
    from kmeans_tpu_torch.continuous.registry import ModelRegistry
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.serve.assign import AssignEngine

    registry = ModelRegistry()
    gen1 = registry.publish(centroids, generation=1)
    cfg = dataclasses.replace(ServeConfig(), **cfg_kw)
    eng = AssignEngine(registry.current, cfg)
    try:
        t0 = time.perf_counter()
        prep = eng._prepared(gen1)
        t_tables = time.perf_counter() - t0
        qmode = eng._quant_mode(prep, points)
        kind = "quant" if qmode else "pruned" if prep.pruned else "dense"
        t0 = time.perf_counter()
        if qmode:
            prep.quant_tier(qmode)
        t_tier = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.submit(pool[:points])
        t_first = time.perf_counter() - t0
        print(f"serve {name} {route} ({card}): prepared model "
              f"{t_tables:.3f} s (closure tables: {prep.pruned}, G={prep.g_n}"
              f", m={prep.m}), {qmode or 'no'} quant tier {t_tier:.3f} s, "
              f"first request (device tensors, first batch) {t_first:.3f} s")
        _check(kind == route.split()[0],
               f"serve {name}: the engine took the {kind} route, not {route}")
        K.reset_launch_counts()
        before = eng.stats()
        responses, errors, seconds, pub_s, swap_s = _serve_load(
            eng, registry, pool, points, centroids[perm])
        counts = K.launch_counts()
        after = eng.stats()
    finally:
        eng.stop()
    st = {key: after[key] - before[key] for key in (
        "batches", "requests", "rows", "fallback_rows", "quant_batches",
        "quant_rescore_rows")}
    gens = {r[2] for r in responses}
    n_req, n_pts = len(responses), len(responses) * points
    p50, p99, top = _percentiles([r[3] for r in responses])
    early = [r[3] for r in responses if r[4] <= pub_s]
    e50, e99, _ = _percentiles(early)
    print(f"serve {name} {route} ({card}): {n_req} requests in "
          f"{seconds:.3f} s = {n_req / seconds:.1f} QPS, "
          f"{n_pts / seconds:.0f} points/s; p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms, max {top:.3f} ms; before the publish "
          f"({pub_s:.3f} s): {len(early)} requests = "
          f"{len(early) / pub_s:.1f} QPS, {len(early) * points / pub_s:.0f} "
          f"points/s, p50 {e50:.3f} ms, p99 {e99:.3f} ms; {st['batches']} "
          f"batches, mean {st['rows'] / max(st['batches'], 1):.1f} rows; "
          f"fallback rows {st['fallback_rows']}, quant batches "
          f"{st['quant_batches']}, quant rescore rows "
          f"{st['quant_rescore_rows']}; publish to first generation-2 "
          f"response {swap_s if swap_s is None else round(swap_s, 3)} s; "
          f"launches {counts}")
    _check(not errors, f"serve {name} {route}: {len(errors)} requests "
           f"failed, first {errors[:1]}")
    _check(st["requests"] == n_req and gens == {1, 2},
           f"serve {name} {route}: responses {n_req} vs engine requests "
           f"{st['requests']}, generations {sorted(gens)}")
    _check(st["batches"] < st["requests"],
           f"serve {name} {route}: the batcher did not coalesce")
    # Under the default request timeout every request must be answered,
    # the publish's rebuild on the dispatcher included.
    limit_s = ServeConfig().assign_timeout_s
    _check(top <= 1e3 * limit_s,
           f"serve {name} {route}: the slowest request took {top:.3f} ms, "
           f"past the default assign_timeout_s of {limit_s} s")
    # K5: once a dense batch; once for each pruned or quant batch with
    # certificate failures, which it rescores on the card.
    k5 = counts["tiled_argmin_cuda"]
    rescored = st["fallback_rows"] + st["quant_rescore_rows"]
    _check(sum(counts.values()) == k5 and (
        k5 == st["batches"] if kind == "dense"
        else (rescored > 0) <= k5 <= min(st["batches"], rescored)),
           f"serve {name} {route}: launches {counts}, K5 expected one a "
           f"dense batch, one a batch with rescored rows")
    summary = {"qps": n_req / seconds, "points_s": n_pts / seconds,
               "p50": p50, "p99": p99}
    return responses, counts, prep, summary


def _check_responses(name, route, responses, pool_t, labels, gen_c, points):
    """Every response against K5's labels of its own generation; a label
    that differs must be a near-tie within SCORE_RTOL.  Returns the
    per-generation labels of every answered pool row (-1 unanswered)."""
    import numpy as np
    import torch

    answered = {g: np.full(pool_t.shape[0], -1, np.int64) for g in labels}
    moved = 0
    for lo, got, g, *_ in responses:
        answered[g][lo:lo + points] = got
    for g, lab in answered.items():
        seen = lab >= 0
        want = labels[g].cpu().numpy()
        diff = np.flatnonzero(seen & (lab != want))
        moved += diff.size
        if diff.size:
            rows = torch.from_numpy(diff).cuda()
            _check_labels_rows(
                f"serve {name} {route} generation {g}", pool_t[rows],
                gen_c[g].cuda(), torch.float32,
                torch.from_numpy(lab[diff]).cuda(), labels[g][rows])
    print(f"serve {name} {route}: {len(responses)} responses checked "
          f"against K5 of their own generation, {moved} rows differ (each "
          "a tie within the tolerance)")
    return answered


def _route_scan_ms(name, route, card, prep, x):
    """The device scan of a pruned or quant run at a serving batch of
    ``x``'s rows, on the run's first generation: CUDA-event ms and its f32
    product's rate."""
    from kmeans_tpu_torch.ops.hamerly import closure_assign_device
    from kmeans_tpu_torch.quant import quant_assign_device
    from kmeans_tpu_torch.serve.assign import pruned_m_tile, quant_k_tile

    rows, d = x.shape
    if route == "pruned":
        m_tile = pruned_m_tile(rows, d, prep.m)
        ms, _ = _time_auto(lambda: closure_assign_device(
            x, *prep.pruned_dev(), m_tile=m_tile, margin_rel=1e-3))
        ops, what = 2.0 * rows * (prep.g_n + prep.m) * d, (
            f"closure_assign_device (G={prep.g_n}, m={prep.m}, "
            f"m_tile={m_tile})")
    elif route == "quant":
        tier = prep.quant_tier("int8")
        k_tile = quant_k_tile(rows, prep.k)
        ms, _ = _time_auto(lambda: quant_assign_device(
            x, *tier.device(x.device), "int8", k_tile=k_tile))
        ops, what = 2.0 * rows * prep.k * d, (
            f"quant_assign_device (int8, k_tile={k_tile})")
    else:
        return
    print(f"serve {name} {route} scan ({card}): {what} at n={rows}: "
          f"{ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s of f32 product)")


def _k5_serving(name, card, pool_t, centroids, rows, k_tile, launches):
    """K5 in f32 at a serving batch shape on the core's f32 route, called
    as the engine calls it (−2C's pieces held): against its plain version,
    both bounds and ``torch.mm`` + ``argmin`` with TF32 off; beside it, in
    the same call, its other column range (bit for bit) and
    ``score_block`` (the parent's f32 route: labels equal but for near-ties
    within SCORE_RTOL); the score error of each against f64 on 512 rows.
    Returns its ``kernels`` row, with ``launches`` (the model's serving
    runs') and the route's bound."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    f32 = torch.float32
    x = pool_t[:rows].contiguous()
    c = centroids.cuda()
    k, d = c.shape
    neg2c, csq = (c * -2).contiguous(), (c * c).sum(dim=1).contiguous()
    _check(K.scoring_core(x, f32, neg2c) == "wgmma",
           "K5 in f32 did not take the Hopper core")
    pieces = K.neg2c_pieces(neg2c)

    def k5(k_tile=k_tile):
        return K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                   raw_scores=True, neg2c_pieces=pieces)

    ms, (lab, raw) = _time_auto(k5)
    plain_ms, (plab, praw) = _time_auto(lambda: K.tiled_argmin_plain(
        x, neg2c, csq, k_tile=k_tile, raw_scores=True))
    moved = _check_labels_rows(f"K5 f32 {name}", x, c, f32, lab, plab)
    same = lab == plab
    err = _within(f"K5 f32 {name} raw scores", raw[same], praw[same],
                  _row_scale(x, c, f32, lab)[same])
    lib_ms, _ = _time_auto(_f32_library(x, neg2c, csq))
    # The other column range beside the route's: 128 where the planner
    # tiles, 256 where it does not.
    other = 128 if k_tile > 128 else 256
    other_ms, out = _time_auto(lambda: k5(other))
    _check(bool(torch.equal(out[0], lab) and torch.equal(out[1], raw)),
           f"K5 f32 {name}: k_tile={other} differs from k_tile={k_tile}")
    with _ForcedScoreBlock():
        sb_ms, (lab_sb, raw_sb) = _time_auto(k5)
    _check_labels_rows(f"K5 f32 {name} vs score_block", x, c, f32, lab,
                       lab_sb)
    sample = slice(0, 512)
    errs = [_f32_score_error(x[sample], c, lb[sample], rw[sample])
            for lb, rw in ((lab, raw), (lab_sb, raw_sb))]
    _check(errs[0] <= min(SCORE_RTOL, _gamma(d)),
           f"K5 f32 {name}: score error {errs[0]:.3e} beyond min("
           "SCORE_RTOL, γ)")
    ops = 2.0 * rows * k * d
    route_b, ffma_b = _f32_bounds(rows, d, k)
    print(f"K5 f32 {name} serving batch ({card}): n={rows} d={d} k={k} "
          f"k_tile={k_tile}: {ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s of "
          f"f32 product; bounds {route_b:.3f} ms six bf16 passes, "
          f"{ffma_b:.3f} ms f32 FMA), plain {plain_ms:.3f} ms, "
          f"torch.mm+argmin (TF32 off) {lib_ms:.3f} ms; {moved} labels "
          f"differ from the plain version (ties), max abs err {err:.3e}; at "
          f"k_tile={other} {other_ms:.3f} ms, bit for bit equal; "
          f"score_block {sb_ms:.3f} ms; score error against f64 on 512 "
          f"rows: route {errs[0]:.3e}, score_block {errs[1]:.3e}")
    return _kernel_row(
        "tiled_argmin_cuda", launches, ms, plain_ms, lib_ms, err,
        rows * d * 4 + pieces.numel() * 2 + k * 4 + rows * 8, 6 * ops, 0.0,
        f"f32 route, {name} batch of {rows}")


def _serve_models(imagenet_c, codebook_c):
    """Phase 8's models: ``(name, centroids, points a request, [(route,
    ServeConfig fields)], seed)``.  The codebook model's requests carry
    512 points, so coalesced batches clear ``assign_quant_min_rows``.  Its
    quant run lets a request wait up to 300 s, so that a publish stall past
    the default timeout (the new generation's prepared model is built on
    the dispatcher mid-load) is measured and then fails the run's check
    rather than the requests."""
    dense = ("dense", {"assign_prune_min_k": 0})
    return [("imagenet-serve", imagenet_c, 64, [("pruned", {}), dense], 21),
            ("codebook-serve", codebook_c, 512,
             [("quant", {"assign_timeout_s": 300.0}), dense], 22)]


def phase_serve(card, models):
    """The assignment engine on the card, serving the two fitted models:
    imagenet-serve (the headline delta fit's centroids, k = 1000: the
    default pruned route, then the dense route on K5) and codebook-serve
    (the codebook fit's, k = 65536: the default int8 quant route, then the
    dense route).  Returns K5's ``kernels`` row for each model, with the
    launches of that model's runs, and ``{(model, route): {"qps",
    "points_s", "p50", "p99"}}`` of each run."""
    import numpy as np
    import torch

    from kmeans_tpu_torch.serve.assign import dense_k_tile

    total, rows, summaries = {}, [], {}
    t_phase = time.perf_counter()
    for name, centroids, points, routes, seed in models:
        model_counts = {}
        k, d = centroids.shape
        rng = np.random.default_rng(seed)
        pool = centroids[rng.integers(0, k, size=SERVE_POOL)]
        pool += rng.standard_normal(pool.shape, dtype=np.float32)
        perm = rng.permutation(k)
        gen_c = {1: torch.from_numpy(centroids),
                 2: torch.from_numpy(centroids[perm])}
        pool_t = torch.from_numpy(pool).cuda()
        k_tile = dense_k_tile(k, d)
        labels = {g: _pool_labels(pool_t, c, k_tile)
                  for g, c in gen_c.items()}
        _sync()
        answered = {}
        batch = min(SERVE_CLIENTS * points, 8192)
        for route, cfg_kw in routes:
            responses, counts, prep, summaries[name, route] = _serve_run(
                name, route, card, centroids, pool, points, perm, cfg_kw)
            _add_counts(model_counts, counts)
            _route_scan_ms(name, route, card, prep, pool_t[:batch])
            del prep
            answered[route] = _check_responses(name, route, responses,
                                               pool_t, labels, gen_c,
                                               points)
        first, *rest = answered
        for route in rest:
            moved = seen = 0
            for g in (1, 2):
                a, b = answered[first][g], answered[route][g]
                both = (a >= 0) & (b >= 0)
                seen += int(both.sum())
                diff = torch.from_numpy(np.flatnonzero(both & (a != b)))
                moved += _check_labels_rows(
                    f"serve {name} {first} vs {route} generation {g}",
                    pool_t[diff.cuda()], gen_c[g].cuda(), torch.float32,
                    torch.from_numpy(a[diff.numpy()]).cuda(),
                    torch.from_numpy(b[diff.numpy()]).cuda())
            print(f"serve {name}: the {first} and {route} routes label "
                  f"{moved} of the {seen} rows both answered differently "
                  f"(each a tie within {SCORE_RTOL})")
        rows.append(_k5_serving(name, card, pool_t, gen_c[1], batch, k_tile,
                                model_counts.get("tiled_argmin_cuda", 0)))
        _add_counts(total, model_counts)
        del pool_t, labels
    print(f"serving phase: {time.perf_counter() - t_phase:.1f} s; serving "
          f"launches {total}")
    return rows, summaries


# ---------------------------------------------------------------------------
# Phase 9: the accelerated and minibatch fits
# ---------------------------------------------------------------------------

#: imagenet-accel: ``bench.py --accel``'s hard instance at the headline
#: width (``bench.py:_make_data`` with k_gen = k, its cluster_std and a
#: latent r = 48 geometry), seeded once with k-means++ on the first
#: ACCEL_SEED_ROWS rows, every arm run to ACCEL_TOL_REL × the mean
#: per-feature variance of those rows.
ACCEL_STD = 3.5
ACCEL_LATENT_R = 48
#: ``bench.py --accel``'s instance seeds: data from ``seed``, the start
#: from ``seed + 1``.
ACCEL_SEEDS = (0, 1, 2)
ACCEL_SEED_ROWS = 65536
ACCEL_TOL_REL = 1e-4
ACCEL_MAX_ITER = 500
ACCEL_CHUNK = 65536
#: Sweeps of the cuda-against-plain runs of each accelerated arm.
ACCEL_CHECK_ITERS = 6
#: ``bench.py``'s --accel gates on final inertia against plain Lloyd's
#: (``GATE_ACCEL_REL_INERTIA``, ``GATE_NESTED_REL_INERTIA``), one-sided,
#: on the median over the instances.
GATE_ANDERSON_REL = 1e-3
GATE_NESTED_REL = 1e-2
#: The minibatch runs: BASELINE.json's configs 4 (cifar10) and 5
#: (imagenet, on one card), sklearn's default max_no_improvement.
MB_BATCH = 8192
MB_STEPS = 200
MB_NO_IMPROVEMENT = 10
MB_PARTIAL_FITS = 10


def _accel_data(n, d, k_gen, seed=0, tile=32768):
    """``bench.py:_make_data``'s latent recipe in bf16 on the card, tile by
    tile (no f32 (n, d) tensor): centres and the (r, d) projection from
    ``numpy.random.default_rng(seed)``, each tile's labels and latent noise
    from a ``torch.Generator`` seeded with ``seed``."""
    import numpy as np
    import torch

    from kmeans_tpu_torch.ops.distance import full_f32

    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(ACCEL_LATENT_R, d)).astype(np.float32)
    proj /= np.linalg.norm(proj, axis=1, keepdims=True)
    centres = (rng.normal(size=(k_gen, ACCEL_LATENT_R)).astype(np.float32)
               * 3) @ proj
    centres = torch.from_numpy(centres).cuda()
    proj = torch.from_numpy(proj).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.empty(n, d, dtype=torch.bfloat16, device="cuda")
    for s in range(0, n, tile):
        e = min(n, s + tile)
        lab = torch.randint(0, k_gen, (e - s,), generator=gen, device="cuda")
        z = torch.randn(e - s, ACCEL_LATENT_R, generator=gen, device="cuda")
        with full_f32():
            noise = z @ proj
        x[s:e] = (centres[lab] + ACCEL_STD * noise).to(torch.bfloat16)
    return x


def _timed_run(warm, fn):
    """``warm()`` (a short call at the same shapes), then ``fn()`` with the
    launch counts set to 0 just before and read just after: ``(out, host
    seconds around the synchronised call, launches)``."""
    warm()
    _sync()
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0, K.launch_counts()


def _accel_instance(seed, card, check):
    """One instance of imagenet-accel (data and start from ``seed``): the
    four arms from one k-means++ start, plain ``fit_lloyd``
    (``update="auto"``), beta, Anderson and the nested ladder with its
    full-batch finish, each after a warm-up at the same shapes; with
    ``check``, the Anderson cost split and each accelerated arm for
    ACCEL_CHECK_ITERS sweeps on ``backend="cuda"`` and ``"plain"``.
    Returns ``({arm: inertia relative to plain's}, launches)``."""
    import dataclasses

    import torch

    import kmeans_tpu_torch as kt

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    t0 = time.perf_counter()
    x = _accel_data(n, d, k, seed=seed)
    sub = x[:ACCEL_SEED_ROWS]
    tol = ACCEL_TOL_REL * float(sub.float().var(dim=0, unbiased=False)
                                .mean())
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    c0 = kt.kmeans_plus_plus(gen, sub, k, compute_dtype="bfloat16")
    _sync()
    name = f"imagenet-accel seed {seed}"
    print(f"{name} data: n={n} d={d} k={k} bf16, std {ACCEL_STD}, latent r "
          f"{ACCEL_LATENT_R}; k-means++ on {ACCEL_SEED_ROWS} rows; tol "
          f"{tol:.6e}; {time.perf_counter() - t0:.2f} s to make")
    cfg = kt.KMeansConfig(k=k, compute_dtype="bfloat16",
                          max_iter=ACCEL_MAX_ITER, chunk_size=ACCEL_CHUNK)
    warm_cfg = dataclasses.replace(cfg, max_iter=2)
    total = {}

    def fit(config, accel=None):
        if accel is None:
            return kt.fit_lloyd(x, k, init=c0, tol=tol, config=config)
        return kt.fit_lloyd_accelerated(x, k, init=c0, tol=tol,
                                        config=config, accel=accel,
                                        diag=True)

    def nested(config):
        return kt.fit_minibatch(x, k, init=c0, tol=tol, config=config,
                                schedule="nested", return_ladder=True)

    arms, rel = {}, {}
    for arm, run in (("plain", lambda c: (fit(c), None)),
                     ("beta", lambda c: fit(c, "beta")),
                     ("anderson", lambda c: fit(c, "anderson")),
                     ("nested", nested)):
        (state, extra), secs, counts = _timed_run(lambda: run(warm_cfg),
                                                  lambda: run(cfg))
        _add_counts(total, counts)
        arms[arm] = state
        inertia = float(state.inertia)
        line = (f"{name} {arm}: {int(state.n_iter)} iterations, converged "
                f"{bool(state.converged)}, {secs:.3f} s, inertia "
                f"{inertia:.6e}")
        if arm != "plain":
            plain = float(arms["plain"].inertia)
            rel[arm] = (inertia - plain) / plain
            line += f" ({rel[arm]:+.3e} of plain's)"
        if arm in ("beta", "anderson"):
            line += (f"; outcomes accepted {extra['accepted']}, rejected "
                     f"{extra['rejected']}, fallback {extra['fallback']}")
        if arm == "nested":
            ladder = sum(it for _, it in extra)
            full = int(state.n_iter) - ladder
            epochs = sum(b * it for b, it in extra) / n + full
            line += (f"; rungs {extra}, full-batch iterations {full}, "
                     f"epochs {epochs:.3f}")
        print(f"{line}; launches {counts} ({card})")
        _check(_finite(state.centroids) and math.isfinite(inertia),
               f"{name} {arm}: non-finite result")
        _check(counts["lloyd_pass_cuda"] >= 1,
               f"{name} {arm}: K1 did not launch")
        if arm in ("anderson", "nested"):
            _check(counts["lloyd_delta_cuda"] >= 1,
                   f"{name} {arm}: K2 did not launch")
    if not check:
        return rel, total
    _anderson_costs(x, arms["plain"].centroids, card)
    del arms
    for accel in ("beta", "anderson"):
        runs = {}
        for backend in ("cuda", "plain"):
            short = dataclasses.replace(cfg, backend=backend,
                                        max_iter=ACCEL_CHECK_ITERS)
            runs[backend] = kt.fit_lloyd_accelerated(
                x, k, init=c0, tol=-1.0, config=short, accel=accel,
                diag=True)
        (a, da), (b, db) = runs["cuda"], runs["plain"]
        fa, fb = float(a.inertia), float(b.inertia)
        print(f"{name} {accel}, {ACCEL_CHECK_ITERS} sweeps: outcomes cuda "
              f"{da['outcomes']}, plain {db['outcomes']}; inertia cuda "
              f"{fa:.6e}, plain {fb:.6e}")
        _check(da["outcomes"] == db["outcomes"],
               f"{name} {accel}: the cuda and plain runs took different "
               "outcome sequences")
        _check(abs(fa - fb) <= FIT_INERTIA_RTOL * abs(fb),
               f"{name} {accel}: cuda inertia {fa} vs plain {fb} beyond "
               f"rtol {FIT_INERTIA_RTOL}")
    return rel, total


def _imagenet_accel(card):
    """``bench.py --accel``'s protocol at the headline width: one instance
    per seed in ACCEL_SEEDS, and its quality gates judged as
    ``bench.py:accel_gates`` judges them, on the median over the instances
    of each arm's inertia relative to plain's: one instance's trajectory
    is chaotic, so a change in the sums' last bits (another summation
    order, another arm's step) can send a fit to another basin.  Returns
    the launches."""
    total, rels = {}, []
    for seed in ACCEL_SEEDS:
        rel, counts = _accel_instance(seed, card, check=seed == 0)
        rels.append(rel)
        _add_counts(total, counts)
    for arm, gate in (("anderson", GATE_ANDERSON_REL),
                      ("nested", GATE_NESTED_REL)):
        each = [r[arm] for r in rels]
        med = statistics.median(each)
        print(f"imagenet-accel {arm}: inertia relative to plain's "
              f"{', '.join(f'{v:+.3e}' for v in each)}, median {med:+.3e} "
              f"(gate {gate})")
        _check(med <= gate, f"imagenet-accel {arm}: the median final "
               f"inertia {med:+.3e} above plain Lloyd's is past the gate "
               f"{gate}")
    return total


def _behind_queue(name, fn, reps=4):
    """``fn()`` enqueued behind ≈ 0.1 s of device work (five 8192² f32
    products), ``reps`` times: a call that reads nothing back returns long
    before that queue drains, and fails the check otherwise; and since the
    host has enqueued all of ``fn`` by the time the device reaches the
    event before it, two events around the call time its device work
    alone.  Returns ``(host ms, queued ms, median device ms after the
    first)``."""
    import torch

    big = torch.ones(8192, 8192, device="cuda")
    device_ms = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        for _ in range(5):
            big @ big
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host_ms = 1e3 * (time.perf_counter() - t1)
        _sync()
        queued_ms = 1e3 * (time.perf_counter() - t0)
        device_ms.append(start.elapsed_time(end))
        _check(host_ms < 0.5 * queued_ms,
               f"{name} waited for the device: a host sync in it")
    return host_ms, queued_ms, statistics.median(device_ms[1:])


def _anderson_costs(x, c, card):
    """What an Anderson sweep adds to K2 at the headline shape, by CUDA
    events: K2 with the row norms (the objective the safeguard reads every
    sweep) and without (the plain delta loop's sweep), and one
    ``anderson_step`` on full m = 5 rings of k·d floats with ``tol`` and
    ``reg`` as the loop passes them (0-d tensors on the card), behind a
    queue (:func:`_behind_queue`)."""
    import torch

    from kmeans_tpu_torch.ops import anderson as A
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    lab = K.lloyd_pass_cuda(x, c, compute_dtype=bf16)[0]
    c1 = c + 0.01 * torch.randn(c.shape, generator=gen, device="cuda")
    k2 = {mind: _time_ms(lambda: K.lloyd_delta_cuda(
        x, c1, lab, compute_dtype=bf16, with_mind=mind), 5)
        for mind in (False, True)}
    tol = torch.tensor(1e-12, device="cuda")
    reg = torch.tensor(1e-8, device="cuda")
    st = A.anderson_state(c, *A.anderson_reset(5, c.numel())[:2])
    f = torch.tensor(1e9, device="cuda")
    cur = c
    for _ in range(6):
        tc = cur + 0.01 * torch.randn(c.shape, generator=gen, device="cuda")
        f = f * 0.99
        cur, st, _ = A.anderson_step(cur, tc, f, ((tc - cur) ** 2).sum(),
                                     st, tol=tol, reg=reg)
    tc = cur + 0.01 * torch.randn(c.shape, generator=gen, device="cuda")
    sh = ((tc - cur) ** 2).sum()
    host_ms, queued_ms, device_ms = _behind_queue(
        "anderson_step", lambda: A.anderson_step(cur, tc, f * 0.99, sh, st,
                                                 tol=tol, reg=reg))
    print(f"imagenet-accel Anderson costs: K2 {k2[False]:.3f} ms without "
          f"the row norms, {k2[True]:.3f} ms with; anderson_step (m = 5, "
          f"k·d = {c.numel()}) device {device_ms:.3f} ms, host "
          f"{host_ms:.3f} ms behind {queued_ms:.1f} ms of queued work "
          f"({card})")


def _minibatch_split(name, x, est_kw, card):
    """One ``MiniBatchKMeans.fit`` after a warm-up fit at the same shapes
    (two steps), and its seconds split: the fit's seeding replayed on its
    own draws (the subsample, then k-means++ on it), the steps from there
    (``fit_minibatch`` from the replayed centroids with the generator where
    the seeding left it, which must give the fit's centroids bit for bit)
    less the final sweep, timed alone.  Returns ``(estimator,
    launches)``."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import init_centroids

    n = x.shape[0]
    k = est_kw["n_clusters"]
    cd = est_kw.get("compute_dtype")
    est, secs, counts = _timed_run(
        lambda: kt.MiniBatchKMeans(**dict(est_kw, steps=2)).fit(x),
        lambda: kt.MiniBatchKMeans(**est_kw).fit(x))
    steps = int(est.state.n_iter)
    gen = torch.Generator(device="cuda").manual_seed(est_kw.get("seed", 0))
    t0 = time.perf_counter()
    sub = min(n, max(4 * k * 16, 65536))
    xs = x[torch.randperm(n, generator=gen, device="cuda")[:sub]] \
        if sub < n else x
    c_seed = init_centroids(gen, xs, k, compute_dtype=cd)
    _sync()
    seed_s = time.perf_counter() - t0
    del xs
    cfg = kt.KMeansConfig(k=k, compute_dtype=cd, batch_size=MB_BATCH,
                          steps=MB_STEPS, seed=est_kw.get("seed", 0),
                          backend=est_kw.get("backend", "auto"))
    t0 = time.perf_counter()
    rest = kt.fit_minibatch(x, k, generator=gen, config=cfg, init=c_seed,
                            tol=est_kw.get("tol"),
                            max_no_improvement=est_kw.get(
                                "max_no_improvement"))
    _sync()
    rest_s = time.perf_counter() - t0
    _check(torch.equal(rest.centroids, est.cluster_centers_),
           f"{name}: the seeding replayed and the steps from there do not "
           "give the fit's centroids")
    t0 = time.perf_counter()
    kt.lloyd_pass(x, rest.centroids, compute_dtype=cd)
    _sync()
    final_s = time.perf_counter() - t0
    step_s = rest_s - final_s
    print(f"{name}: {steps} steps, converged {bool(est.state.converged)}, "
          f"{secs:.3f} s; split: seeding {seed_s:.3f} + steps {step_s:.3f} "
          f"({1e3 * step_s / steps:.3f} ms a step, {steps / step_s:.1f} "
          f"steps/s) + final sweep {final_s:.3f}; inertia "
          f"{est.inertia_:.6e}; launches {counts} ({card})")
    _check(_finite(est.cluster_centers_) and math.isfinite(est.inertia_),
           f"{name}: non-finite result")
    _check(counts["lloyd_pass_cuda"] >= 1, f"{name}: K1 did not launch")
    return est, counts


def _cifar10_minibatch(card):
    """BASELINE config 4: the fit, the fit with early stopping, and
    MB_PARTIAL_FITS partial_fit calls; the fit on ``backend="cuda"`` against
    ``"plain"``.  Returns the f32 route's launches."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops.cuda_lloyd import scoring_core

    n, d, k = CIFAR10["n"], CIFAR10["d"], CIFAR10["k"]
    x, _, _ = kt.make_blobs(0, n, d, k)
    f32 = torch.float32
    core = scoring_core(x, f32, x[:k])
    print(f"cifar10-minibatch: n={n} d={d} k={k} f32 ({x.numel() * 4 / 1e6:.0f}"
          f" MB), scoring core {core}")
    _check(core == "wgmma", "cifar10 does not take the core's f32 route")
    kw = dict(n_clusters=k, batch_size=MB_BATCH, steps=MB_STEPS, seed=0)
    total = {}
    est, counts = _minibatch_split("cifar10-minibatch fit", x,
                                   dict(kw, backend="cuda"), card)
    _add_counts(total, counts)
    tol = ACCEL_TOL_REL * float(x.var(dim=0, unbiased=False).mean())
    early, counts = _minibatch_split(
        f"cifar10-minibatch fit, tol {tol:.6e}, max_no_improvement "
        f"{MB_NO_IMPROVEMENT}", x,
        dict(kw, tol=tol, max_no_improvement=MB_NO_IMPROVEMENT), card)
    _add_counts(total, counts)
    stream = kt.MiniBatchKMeans(**kw)
    rows = n // MB_PARTIAL_FITS
    stream.partial_fit(x[:rows])              # seeds; the warm-up
    _sync()
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    K.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(MB_PARTIAL_FITS):
        stream.partial_fit(x[i * rows:(i + 1) * rows])
    _sync()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    _add_counts(total, counts)
    print(f"cifar10-minibatch partial_fit: {MB_PARTIAL_FITS} calls of {rows} "
          f"rows in {secs:.3f} s ({1e3 * secs / MB_PARTIAL_FITS:.3f} ms a "
          f"call), batch inertia {stream.inertia_:.6e}; launches {counts}")
    _check(counts["lloyd_pass_cuda"] == MB_PARTIAL_FITS,
           "cifar10-minibatch partial_fit: K1 did not launch once a call")
    _check(_finite(stream.cluster_centers_), "partial_fit: non-finite")
    plain = kt.MiniBatchKMeans(**kw, backend="plain").fit(x)
    _check(torch.equal(est.cluster_centers_, plain.cluster_centers_),
           "cifar10-minibatch: the cuda and plain fits' centroids differ: "
           "the steps are the same code on the same draws")
    moved = _check_labels_rows("cifar10-minibatch final labels", x,
                               est.cluster_centers_, f32, est.labels_,
                               plain.labels_)
    print(f"cifar10-minibatch: cuda and plain fits' centroids equal bit for "
          f"bit; {moved} final labels differ, each a tie within "
          f"{SCORE_RTOL}")
    return total


def _imagenet_minibatch(card):
    """BASELINE config 5 on one card, and one step's ``batch_stats`` beside
    K1 on the same gathered rows.  Returns the launches."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.minibatch import batch_stats, batch_update
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    bf16 = torch.bfloat16
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=bf16)
    kw = dict(n_clusters=k, batch_size=MB_BATCH, steps=MB_STEPS,
              compute_dtype="bfloat16")
    est, counts = _minibatch_split("imagenet-minibatch fit", x, kw, card)
    gen = torch.Generator(device="cuda").manual_seed(2)
    xb = x[torch.randint(0, n, (MB_BATCH,), generator=gen, device="cuda")]
    c = est.cluster_centers_
    stats_ms = _time_ms(lambda: batch_stats(c, xb, compute_dtype=bf16), 10)
    k1_ms = _time_ms(lambda: K.lloyd_pass_cuda(xb, c, compute_dtype=bf16),
                     10)
    n_seen = est.state.counts
    host_ms, queued_ms, step_ms = _behind_queue(
        "a minibatch step", lambda: batch_update(
            c, n_seen, x[torch.randint(0, n, (MB_BATCH,), generator=gen,
                                       device="cuda")],
            compute_dtype=bf16))
    print(f"imagenet-minibatch step at {MB_BATCH} gathered rows: batch_stats "
          f"{stats_ms:.3f} ms, K1 (lloyd_pass_cuda) {k1_ms:.3f} ms; a whole "
          f"step (draw, gather, batch_update) device {step_ms:.3f} ms, host "
          f"{host_ms:.3f} ms behind {queued_ms:.1f} ms of queued work "
          f"({card})")
    return counts


def phase_accel_minibatch(card):
    """Phase 9: imagenet-accel, cifar10-minibatch and imagenet-minibatch.
    Returns ``{"bf16": launches, "f32": launches}`` for the kernels line."""
    t_phase = time.perf_counter()
    bf16 = _imagenet_accel(card)
    f32 = _cifar10_minibatch(card)
    _add_counts(bf16, _imagenet_minibatch(card))
    print(f"accelerated and minibatch phase: "
          f"{time.perf_counter() - t_phase:.1f} s; launches bf16 {bf16}, "
          f"f32 {f32}")
    return {"bf16": bf16, "f32": f32}


# ---------------------------------------------------------------------------
# Phase 10: the model over HTTP (imagenet-http)
# ---------------------------------------------------------------------------

#: Closed-loop clients, points a request and seconds of a run, as phase 8's
#: imagenet-serve runs.  The clients run in a process of their own (this
#: script with --http-client, standard library and numpy only), so their
#: interpreter lock is not charged to the server.
HTTP_CLIENTS = 48
HTTP_POINTS = 64
HTTP_SECONDS = 3.0
#: Distinct bodies the JSON run cycles through (a 64 x 2048 request is
#: about 2.7 MB of JSON text), encoded once by the client before it starts.
HTTP_JSON_SLOTS = 32
#: The longest one HTTP call of a run may take.
HTTP_CALL_S = 60.0
#: Frame headers of the binary wire protocol
#: (``kmeans_tpu_torch.serve.assign``), for the client, which imports
#: nothing of the port: magic, version, dtype, flags, n, d | n, k, gen.
_HTTP_POINTS_HEADER = "<4sBBHII"
_HTTP_LABELS_HEADER = "<4sBBHIIQ"


def _http_client(spec) -> int:
    """One run's load, in its own process: ``spec["clients"]`` threads,
    each on a keep-alive connection of its own, post ``spec["points"]``-row
    slices of the pool (binary frames, with the distances flag, or JSON)
    for ``spec["seconds"]`` and on until a response from generation
    ``spec["new_gen"]`` arrives (None: no wait) and, with
    ``spec["until_file"]``, until that file exists.  Options: ``fresh``, a
    new connection for every request (the fleet drills' clients), ``pace``
    seconds between a client's requests, ``tno_base`` added to the client
    numbers in the trace ids (a second client process of one run),
    ``retry_resets``: a request whose connection fails before any byte of
    a response is sent once more on a new connection, and the failed
    attempt's trace id is kept (``retried``).  Prints READY once the
    threads run; writes every response to ``spec["out"]`` (npz)."""
    import http.client
    import itertools
    import os
    import struct
    import threading

    import numpy as np

    pool = np.load(spec["pool"])
    points, mode = spec["points"], spec["mode"]
    n_pool, d = pool.shape
    slots = n_pool // points
    if mode == "json":
        slots = min(slots, HTTP_JSON_SLOTS)
        bodies = [json.dumps({"points": pool[i * points:(i + 1) * points]
                              .tolist()}).encode() for i in range(slots)]
        ctype = "application/json"
    else:
        header = struct.pack(_HTTP_POINTS_HEADER, b"KMPT", 1, 1,
                             1 if mode == "distances" else 0, points, d)
        ctype = "application/x-kmeans-points"
    lab_size = struct.calcsize(_HTTP_LABELS_HEADER)
    fresh, pace = spec.get("fresh", False), spec.get("pace", 0.0)
    tno_base = spec.get("tno_base", 0)
    retry = spec.get("retry_resets", False)
    retried = []
    lock = threading.Lock()
    counter = itertools.count()
    stop, seen_new = threading.Event(), threading.Event()
    rows, labels, dists, errors = [], [], [], []

    def client(tno):
        conn, conn_no, again = None, 0, None
        while not stop.is_set():
            if conn is None:
                conn = http.client.HTTPConnection(
                    spec["host"], spec["port"], timeout=HTTP_CALL_S)
                trace = (f"{spec['run']:04x}{tno_base + tno:04x}"
                         f"{conn_no:08x}")
                conn_no += 1
            is_retry, slot = again is not None, again
            again = None
            if not is_retry:
                with lock:
                    slot = next(counter) % slots
            lo = slot * points
            body = (bodies[slot] if mode == "json"
                    else header + pool[lo:lo + points].tobytes())
            t0 = time.perf_counter()
            try:
                conn.request("POST", "/api/assign", body=body, headers={
                    "Content-Type": ctype, "X-Trace-Id": trace})
                r = conn.getresponse()
                payload = r.read()
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                conn = None
                with lock:
                    if retry and not is_retry:
                        retried.append(trace)
                        again = slot
                    else:
                        errors.append(repr(e))
                continue
            t1 = time.perf_counter()
            gen, lab, dist = -1, np.full(points, -1, np.int32), None
            if r.status == 200 and mode == "json":
                obj = json.loads(payload)
                gen, lab = obj["generation"], np.asarray(obj["labels"],
                                                         np.int32)
            elif r.status == 200:
                _, _, _, flags, n, _, gen = struct.unpack_from(
                    _HTTP_LABELS_HEADER, payload)
                lab = np.frombuffer(payload, "<i4", n, lab_size)
                if flags & 1:
                    dist = np.frombuffer(payload, "<f4", n,
                                         lab_size + 4 * n)
            with lock:
                rows.append((lo, r.status, gen, t1 - t0, t1 - t_start,
                             tno_base + tno))
                labels.append(lab)
                if mode == "distances":
                    dists.append(dist if dist is not None
                                 else np.full(points, np.nan, np.float32))
            if gen == spec["new_gen"]:
                seen_new.set()
            if r.will_close or fresh:
                conn.close()
                conn = None
            if pace:
                stop.wait(pace)
        if conn is not None:
            conn.close()
        if again is not None:
            with lock:
                errors.append("a reset request was not retried before the "
                              "run stopped")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(spec["clients"])]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    print("READY", flush=True)
    time.sleep(max(0.0, t_start + spec["seconds"] - time.perf_counter()))
    if spec["new_gen"] is not None:
        seen_new.wait(spec["swap_wait"])
    deadline = time.perf_counter() + spec["swap_wait"]
    while spec.get("until_file") and not os.path.exists(
            spec["until_file"]) and time.perf_counter() < deadline:
        time.sleep(0.02)
    stop.set()
    for t in threads:
        t.join(timeout=2 * HTTP_CALL_S)
    seconds = time.perf_counter() - t_start
    with lock:
        table = np.array(rows, np.float64).reshape(-1, 6)
        np.savez(spec["out"], table=table, seconds=seconds,
                 labels=np.stack(labels) if labels else np.zeros((0, points)),
                 dists=(np.stack(dists) if dists
                        else np.zeros((0, points), np.float32)),
                 errors=np.array(errors, dtype=str),
                 retried=np.array(retried, dtype=str),
                 hung=sum(t.is_alive() for t in threads))
    return 0


def _http_get(base, path, data=None, ctype="application/json"):
    """``(status, body bytes)`` of one request to the server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_CALL_S) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _scrape(base):
    """``{(name, sorted labels): value}`` of the server's ``/metrics``."""
    from kmeans_tpu_torch.obs.registry import parse_exposition

    st, body = _http_get(base, "/metrics")
    _check(st == 200, f"/metrics answered {st}")
    return {(smp.name, tuple(sorted(smp.labels))): smp.value
            for fam in parse_exposition(body.decode()).values()
            for smp in fam.samples}


def _metric(before, after, name, **labels):
    key = (name, tuple(sorted(labels.items())))
    return after.get(key, 0.0) - before.get(key, 0.0)


def _strict_trace(base):
    """``/api/trace`` at ``base``, parsed strictly: a NaN or an Infinity
    fails the run."""
    def strict(token):
        raise SmokeFailure(f"/api/trace holds {token}: not strict JSON")

    st, body = _http_get(base, "/api/trace")
    _check(st == 200, f"/api/trace answered {st}")
    return json.loads(body.decode(), parse_constant=strict)


def _run_spans(doc, prefix):
    """The completed spans of a trace document whose trace id starts with
    the run's ``prefix``; each must sit on a lane (pid, tid) that has a
    thread_name row."""
    names = {(e["pid"], e["tid"]): e["args"]["name"]
             for e in doc["traceEvents"] if e.get("name") == "thread_name"}
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"
             and str(e["args"].get("trace_id", "")).startswith(prefix)]
    _check(all((e["pid"], e["tid"]) in names for e in spans),
           "trace: a span's lane has no thread_name row")
    return spans


def _trace_spans(base, prefix):
    """This run's completed spans from ``/api/trace``."""
    return _run_spans(_strict_trace(base), prefix)


def _span_split(name, spans, prev_tids):
    """The lanes and the time split of one run's spans: every connection
    (one trace id, one handler thread) has exactly one lane (pid, tid),
    no two connections share one, and none is a lane of the previous
    run's handler threads (which ended).  Returns the run's lanes and a
    line of means: decode (request span start to its ``assign.queue``
    span), the engine (``assign.queue``: queue, batch and kernel), encode
    (after it to the request span's end), and per batch ``assign.stage``
    and ``assign.kernel``."""
    reqs = [e for e in spans if e["name"] == "POST /api/assign"]
    lanes = {}
    for e in reqs:
        lanes.setdefault(e["args"]["trace_id"], set()).add(
            (e["pid"], e["tid"]))
    tids = set().union(*lanes.values()) if lanes else set()
    _check(bool(lanes) and all(len(t) == 1 for t in lanes.values())
           and len(tids) == len(lanes) and not tids & prev_tids,
           f"{name}: /api/trace lanes: {len(lanes)} connections on "
           f"{len(tids)} tids, {len(tids & prev_tids)} shared with the "
           f"previous run")
    queue = {(e["pid"], e["args"]["parent_id"]): e for e in spans
             if e["name"] == "assign.queue"}
    split = []
    for r in reqs:
        q = queue.get((r["pid"], r["args"]["span_id"]))
        if q is not None:
            split.append((q["ts"] - r["ts"], q["dur"],
                          r["ts"] + r["dur"] - q["ts"] - q["dur"], r["dur"]))

    def mean_ms(values):
        return 1e-3 * statistics.fmean(values) if values else float("nan")

    per_batch = {n: [e["dur"] for e in spans if e["name"] == n]
                 for n in ("assign.batch", "assign.stage", "assign.kernel")}
    rows = [e["args"]["rows"] for e in spans if e["name"] == "assign.batch"]
    line = (f"{len(lanes)} connections on {len(tids)} handler lanes; "
            f"span split over {len(split)} requests (means): decode "
            f"{mean_ms([s[0] for s in split]):.3f} ms, engine (assign.queue)"
            f" {mean_ms([s[1] for s in split]):.3f} ms, encode "
            f"{mean_ms([s[2] for s in split]):.3f} ms, request span "
            f"{mean_ms([s[3] for s in split]):.3f} ms; over "
            f"{len(per_batch['assign.batch'])} batches of "
            f"{statistics.fmean(rows) if rows else float('nan'):.1f} rows: "
            f"assign.batch {mean_ms(per_batch['assign.batch']):.3f} ms, "
            f"assign.stage {mean_ms(per_batch['assign.stage']):.3f} ms, "
            f"assign.kernel {mean_ms(per_batch['assign.kernel']):.3f} ms")
    return tids, line


def _check_http_responses(name, table, got, ctx):
    """Every response's labels against K5's labels of its own generation
    (odd generations serve the model, even ones its permutation); a label
    that differs must be a near-tie within SCORE_RTOL."""
    import numpy as np
    import torch

    idx = table[:, 0].astype(np.int64)[:, None] + np.arange(HTTP_POINTS)
    moved = 0
    for g in sorted({int(v) for v in table[:, 2]}):
        sel = np.flatnonzero(table[:, 2] == g)
        want = ctx["labels"][g % 2].cpu().numpy()[idx[sel]].ravel()
        mine = got[sel].ravel()
        diff = np.flatnonzero(mine != want)
        if diff.size:
            rows = torch.from_numpy(idx[sel].ravel()[diff]).cuda()
            moved += _check_labels_rows(
                f"{name} generation {g}", ctx["pool_t"][rows],
                ctx["gen_c"][g % 2].cuda(), torch.float32,
                torch.from_numpy(mine[diff]).cuda(),
                torch.from_numpy(want[diff]).cuda())
    print(f"{name}: every one of {len(table)} responses checked against "
          f"K5 of its own generation, {moved} rows differ (each a tie "
          "within the tolerance)")


def _check_distances(name, data, ctx):
    """Each returned distance against f64: ``|dist² − ||x − c||²|`` within
    1e-5 of ``||x||² + ||c||²``, c the centroid the response labelled."""
    import numpy as np
    import torch

    table, pool_t = data["table"], ctx["pool_t"]
    worst = 0.0
    for g in sorted({int(v) for v in table[:, 2]}):
        sel = np.flatnonzero(table[:, 2] == g)
        c = ctx["gen_c"][g % 2].cuda().double()
        for part in np.array_split(sel, max(1, sel.size // 512)):
            lo = table[part, 0].astype(np.int64)
            idx = torch.from_numpy((lo[:, None] + np.arange(
                data["labels"].shape[1])[None, :]).ravel()).cuda()
            lab = torch.from_numpy(data["labels"][part].ravel()).cuda().long()
            x = pool_t[idx].double()
            cc = c[lab]
            d2 = ((x - cc) ** 2).sum(1)
            scale = (x * x).sum(1) + (cc * cc).sum(1)
            got = torch.from_numpy(data["dists"][part].ravel()).cuda()
            err = ((got.double() ** 2 - d2).abs() / scale)
            worst = max(worst, float(err.max()))
    _check(worst <= 1e-5, f"{name}: a distance is {worst:.3e} of "
           "||x||² + ||c||² off f64, beyond 1e-5")
    return worst


def _http_run(ctx, name, base, mode, run, gen_to, route):
    """One run of phase 10 against the server at ``base``: the client
    process, a publish of generation ``gen_to`` from a registry that first
    loads the directory's latest, and ``POST /api/model/reload`` half-way;
    every response held to K5's labels of its generation, the metrics'
    counts to the client's, the launches to the batches.  Returns the
    run's summary and K5's launches."""
    import urllib.parse

    import numpy as np

    from kmeans_tpu_torch.continuous.registry import ModelRegistry
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    gen_from = gen_to - 1
    url = urllib.parse.urlparse(base)
    out = f"{ctx['dir']}/run{run}.npz"
    spec = {"host": url.hostname, "port": url.port, "pool": ctx["pool_path"],
            "out": out, "points": HTTP_POINTS, "clients": HTTP_CLIENTS,
            "seconds": HTTP_SECONDS, "swap_wait": SERVE_SWAP_WAIT_S,
            "mode": mode, "run": run, "new_gen": gen_to}
    before = _scrape(base)
    K.reset_launch_counts()
    proc = subprocess.Popen(
        [sys.executable, __file__, "--http-client", json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = proc.stdout.readline().strip()
        _check(ready == "READY", f"{name}: the client did not start: "
               f"{ready!r} {proc.stderr.read()[-2000:] if ready == '' else ''}")
        time.sleep(HTTP_SECONDS / 2)
        t_pub = time.perf_counter()
        other = ModelRegistry(path=ctx["model_dir"])
        other.load_latest()
        _check(other.generation == gen_from,
               f"{name}: the directory holds generation "
               f"{other.generation}, not {gen_from}")
        other.publish(ctx["centroids"][gen_to % 2], generation=gen_to,
                      trigger="drift")
        st, body = _http_get(base, "/api/model/reload", b"{}")
        _check(st == 200 and json.loads(body) == {"generation": gen_to},
               f"{name}: reload answered {st} {body[:200]!r}")
        t_reload = time.perf_counter() - t_pub
        _, err = proc.communicate(
            timeout=HTTP_SECONDS + SERVE_SWAP_WAIT_S + 4 * HTTP_CALL_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    _check(proc.returncode == 0, f"{name}: the client failed: {err[-2000:]}")
    counts = K.launch_counts()
    after = _scrape(base)
    data = dict(np.load(out))
    table, seconds = data["table"], float(data["seconds"])
    status = table[:, 1].astype(int)
    n_req = len(table)
    n_503 = int((status == 503).sum())
    gens = {int(g) for g in table[status == 200, 2]}
    _check(not data["errors"].size and not int(data["hung"])
           and n_req and (status == 200).all(),
           f"{name}: {n_req} responses, {int((status != 200).sum())} not "
           f"200 ({n_503} 503s), {data['errors'].size} connection errors "
           f"{data['errors'][:1]}, {int(data['hung'])} clients hung")
    _check(gens == {gen_from, gen_to},
           f"{name}: generations {sorted(gens)}, not {gen_from} and {gen_to}")
    _check_http_responses(f"{name} {mode}", table, data["labels"], ctx)
    dist_err = (_check_distances(f"{name} {mode}", data, ctx)
                if mode == "distances" else None)
    # The server's own counts against the client's.
    fmt = "json" if mode == "json" else "binary"
    seen = {
        "POST /api/assign 200": _metric(
            before, after, "kmeans_tpu_http_requests_total", method="POST",
            route="/api/assign", status="200"),
        "wire " + fmt: _metric(before, after,
                               "kmeans_tpu_assign_wire_requests_total",
                               format=fmt),
        "reload 200": _metric(
            before, after, "kmeans_tpu_http_requests_total", method="POST",
            route="/api/model/reload", status="200"),
    }
    _check(seen == {"POST /api/assign 200": n_req, "wire " + fmt: n_req,
                    "reload 200": 1},
           f"{name}: /metrics counted {seen}, the client {n_req} requests "
           "and one reload")
    batches = {kind: _metric(before, after, "kmeans_tpu_assign_batches_total",
                             kernel=kind)
               for kind in ("dense", "pruned", "quant")}
    fallback = _metric(before, after,
                       "kmeans_tpu_assign_pruned_fallback_rows_total")
    k5 = counts["tiled_argmin_cuda"]
    n_batches = int(sum(batches.values()))
    _check(batches[route] == n_batches > 0 and sum(counts.values()) == k5
           and (k5 == n_batches if route == "dense"
                else (fallback > 0) <= k5 <= min(n_batches, fallback)),
           f"{name}: batches {batches}, fallback rows {fallback}, launches "
           f"{counts}: K5 expected once a dense batch, once a batch with "
           "rescored rows")
    tids, split = _span_split(f"{name} {mode}",
                              _trace_spans(base, f"{run:04x}"),
                              ctx["prev_tids"])
    ctx["prev_tids"] = tids
    lat = table[:, 3].tolist()
    p50, p99, top = _percentiles(lat)
    new = table[table[:, 2] == gen_to]
    summary = {"qps": n_req / seconds, "points_s": n_req * HTTP_POINTS
               / seconds, "p50": p50, "p99": p99}
    print(f"http {name} {mode} ({ctx['card']}): {n_req} requests in "
          f"{seconds:.3f} s = {summary['qps']:.1f} QPS, "
          f"{summary['points_s']:.0f} points/s; p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms, max {top:.3f} ms; 503s {n_503}; {n_batches} "
          f"{route} batches, fallback rows {int(fallback)}; K5 launches {k5};"
          f" publish and reload {t_reload:.3f} s, first generation-{gen_to}"
          f" response at {float(new[:, 4].min()):.3f} s of the run"
          + ("" if dist_err is None else
             f"; distances' worst error {dist_err:.3e} of ||x||²+||c||²"))
    print(f"http {name} {mode}: {split}")
    return summary, k5


def _http_context(card, centroids, tmp):
    """The model directory (generation 1 published through the port's
    registry), the query pool (phase 8's: the centroids plus unit noise)
    written for the client, and K5's labels of every pool row for both
    of the run's models: odd generations serve ``centroids``, even ones
    a permutation of them."""
    import numpy as np
    import torch

    from kmeans_tpu_torch.continuous.registry import ModelRegistry
    from kmeans_tpu_torch.serve.assign import dense_k_tile

    k, d = centroids.shape
    rng = np.random.default_rng(21)
    pool = centroids[rng.integers(0, k, size=SERVE_POOL)]
    pool += rng.standard_normal(pool.shape, dtype=np.float32)
    perm = rng.permutation(k)
    models = (centroids[perm], centroids)          # [generation % 2]
    model_dir = f"{tmp}/model"
    ModelRegistry(path=model_dir).publish(models[1], generation=1,
                                          trigger="initial")
    pool_path = f"{tmp}/pool.npy"
    np.save(pool_path, pool)
    pool_t = torch.from_numpy(pool).cuda()
    gen_c = [torch.from_numpy(np.ascontiguousarray(m)) for m in models]
    k_tile = dense_k_tile(k, d)
    labels = [_pool_labels(pool_t, c, k_tile) for c in gen_c]
    _sync()
    return {"card": card, "dir": tmp, "model_dir": model_dir,
            "pool_path": pool_path, "pool_t": pool_t, "centroids": models,
            "gen_c": gen_c, "labels": labels, "prev_tids": set()}


def _http_cli_runs(ctx, port, result):
    """The orchestrator of the command-line server's runs (on a thread;
    the server has the main thread): wait for /readyz, warm each wire
    format once, run binary, binary with distances and JSON, check
    /readyz, then stop the server as Ctrl-C does."""
    import _thread

    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 300
        while True:
            try:
                st, _ = _http_get(base, "/readyz")
                break
            except OSError:
                _check(time.monotonic() < deadline,
                       "the command-line server never answered /readyz")
                time.sleep(0.2)
        _check(st == 200, f"/readyz answered {st} at boot")
        for mode, run, gen in (("binary", 1, 2), ("distances", 2, 3),
                               ("json", 3, 4)):
            result[mode] = _http_run(ctx, "imagenet-http cli", base, mode,
                                     run, gen, "pruned")
        st, body = _http_get(base, "/readyz")
        _check(st == 200 and json.loads(body)["model"] == 4,
               f"/readyz after the runs: {st} {body[:200]!r}")
    except BaseException as e:         # handed to the main thread
        result["error"] = e
    finally:
        _thread.interrupt_main()


def phase_http(card, centroids, serve_summaries, summaries=None):
    """Phase 10, imagenet-http: ``python -m kmeans_tpu_torch.cli serve
    --model-dir D`` (its ``main``, on this process's main thread, stopped
    by a simulated Ctrl-C) serves ``centroids`` on 127.0.0.1 under the
    default ``ServeConfig`` (the pruned route): binary, binary with
    distances and JSON runs; then a ``KMeansServer`` with
    ``assign_prune_min_k=0`` over the same directory (the dense route on
    K5, which the command line has no flag for): a binary run.  Each run's
    numbers are printed beside phase 8's for the same route, and each run's
    summary goes into ``summaries`` by mode.  Returns K5's launches over the
    phase."""
    import signal
    import socket
    import tempfile
    import threading

    from kmeans_tpu_torch import cli
    from kmeans_tpu_torch.config import ServeConfig
    from kmeans_tpu_torch.serve.server import KMeansServer

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_http_") as tmp:
        ctx = _http_context(card, centroids, tmp)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        result = {}
        orch = threading.Thread(target=_http_cli_runs,
                                args=(ctx, port, result), daemon=True)
        # The command line stops on KeyboardInterrupt; make sure SIGINT
        # raises it even where this process inherited it ignored.
        prior = signal.signal(signal.SIGINT, signal.default_int_handler)
        orch.start()
        try:
            rc = cli.main(["serve", "--model-dir", ctx["model_dir"],
                           "--host", "127.0.0.1", "--port", str(port)])
        except KeyboardInterrupt:
            rc = 0
        finally:
            orch.join(timeout=60)
            signal.signal(signal.SIGINT, prior)
        if "error" in result:
            raise result["error"]
        _check(rc == 0 and not orch.is_alive() and len(result) == 3,
               f"the command-line server exited {rc} with runs "
               f"{sorted(result)}")
        server = KMeansServer(ServeConfig(
            host="127.0.0.1", port=0, model_dir=ctx["model_dir"],
            assign_prune_min_k=0))
        httpd = server.start()
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            _check(_http_get(base, "/readyz")[0] == 200,
                   "the dense server is not ready")
            result["dense"] = _http_run(ctx, "imagenet-http dense", base,
                                        "binary", 4, 5, "dense")
        finally:
            server.stop()
    launches = 0
    for mode, route in (("binary", "pruned"), ("distances", "pruned"),
                        ("json", "pruned"), ("dense", "dense")):
        summary, k5 = result[mode]
        launches += k5
        if summaries is not None:
            summaries[mode] = summary
        inproc = serve_summaries.get(("imagenet-serve", route))
        beside = ("phase 8 not run" if inproc is None else
                  f"phase 8 in process: {inproc['qps']:.1f} QPS, "
                  f"{inproc['points_s']:.0f} points/s, p50 "
                  f"{inproc['p50']:.3f} ms, p99 {inproc['p99']:.3f} ms")
        print(f"imagenet-http {mode} ({route} route, {card}): "
              f"{summary['qps']:.1f} QPS, {summary['points_s']:.0f} "
              f"points/s, p50 {summary['p50']:.3f} ms, p99 "
              f"{summary['p99']:.3f} ms; {beside}")
    print(f"http phase: {time.perf_counter() - t_phase:.1f} s; K5 launches "
          f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 11: the serving fleet on the card (imagenet-fleet)
# ---------------------------------------------------------------------------

#: Worker counts of the pruned-route runs (``cli serve --workers N``), of
#: the dense run (the embedding API) and of the drills.  Depth cut (PR 19):
#: the pruned route at 4 workers alone, 1, 2 and 4 before (the embedding
#: API still runs the dense fleet and both drills, at 4 and 2 workers),
#: and no single-process run before them (phase 10 drives ``cli serve``).
FLEET_SIZES = (4,)
FLEET_DENSE_WORKERS = 4
FLEET_DRILL_WORKERS = 2
#: A fleet run's client window.  Depth cut (PR 19): 1.5 s, phase 10's
#: HTTP_SECONDS (3.0 s) before.
FLEET_SECONDS = 1.5
#: Client processes a run's HTTP_CLIENTS keep-alive clients are split over.
FLEET_CLIENT_PROCS = 2
#: The drills' clients: a fresh connection a request, paced, as the
#: reference's slow drills (tests/test_fleet.py) send them.
FLEET_DRILL_CLIENTS = 8
FLEET_DRILL_PACE_S = 0.02
#: The longest a fleet may take to boot, drain or recover.
FLEET_WAIT_S = 120.0
#: Fresh-connection requests a fleet answers before a run's clock starts,
#: per worker: the kernel spreads them over the listeners, so each worker
#: has paid its first request (timed from the trace) before the load.
FLEET_WARM_PER_WORKER = 8
#: The reference's recovery gate for the kill drill (the soak gate that
#: tests/test_fleet.py's drill cites), printed beside the measured RTO.
FLEET_REF_RTO_S = 2.0
#: nvidia-smi's utilization.gpu sampling period during a run.
FLEET_UTIL_PERIOD_S = 0.1
#: SSE subscribers the rolling drill keeps on its workers (more are
#: opened until they sit on every worker), in one room.
FLEET_SSE_SUBS = 8


def _final_workers(sup):
    """Each slot's last worker once the fleet has stopped: ``{"kind":
    "final", "slot", "pid", "returncode", "drained"}`` (its FLEET_DRAINED
    line read before its pipe closed)."""
    out = []
    for slot, h in sorted(sup._workers.items()):
        deadline = time.monotonic() + 10.0
        while not h.eof and time.monotonic() < deadline:
            time.sleep(0.01)
        out.append({"kind": "final", "slot": slot, "pid": h.proc.pid,
                    "returncode": h.proc.poll(), "drained": h.drained})
    return out


def _fleet_cli(spec) -> int:
    """``chip_smoke.py --fleet-cli SPEC``: ``kmeans_tpu_torch.cli.main(
    spec["argv"])`` in this process, with each event of its fleet
    supervisor appended to ``spec["events"]`` as a JSON line (monotonic
    clock, which every process of the machine shares) and, once it
    returns, each slot's final worker (:func:`_final_workers`), so the
    smoke reads a command-line fleet as it reads an embedded one."""
    import threading

    from kmeans_tpu_torch import cli
    from kmeans_tpu_torch.serve import fleet

    log = open(spec["events"], "a", encoding="utf-8")
    lock = threading.Lock()
    record, start = fleet.FleetSupervisor._event, fleet.FleetSupervisor.start
    sups = []

    def write(ev):
        with lock:
            log.write(json.dumps(ev) + "\n")
            log.flush()

    def _event(self, kind, slot=None, **detail):
        record(self, kind, slot, **detail)
        with self._events_lock:
            write(self.events[-1])

    def _start(self):
        sups.append(self)
        start(self)

    fleet.FleetSupervisor._event = _event
    fleet.FleetSupervisor.start = _start
    rc = cli.main(spec["argv"])
    for sup in sups:
        for ev in _final_workers(sup):
            write(ev)
    return rc


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class _FleetUnderTest:
    """A server the phase drives: ``cli serve`` in a process of its own
    (``--fleet-cli``; SIGTERM drains it) or an embedded
    ``FleetSupervisor``.  Both give their supervisor's events."""

    def __init__(self, name, tmp, argv=None, sup=None):
        self.name, self.sup, self.proc = name, sup, None
        self.events_path = f"{tmp}/{name}.events"
        self.err_path = f"{tmp}/{name}.stderr"
        if sup is not None:
            sup.start()
            return
        spec = {"argv": argv, "events": self.events_path}
        with open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, __file__, "--fleet-cli", json.dumps(spec)],
                stdout=subprocess.DEVNULL, stderr=err)

    def events(self, kind=None):
        if self.sup is not None:
            with self.sup._events_lock:
                evs = list(self.sup.events) + getattr(self, "final", [])
        else:
            try:
                with open(self.events_path, encoding="utf-8") as f:
                    evs = [json.loads(ln) for ln in f if ln.endswith("\n")]
            except FileNotFoundError:
                evs = []
        return [e for e in evs if kind is None or e["kind"] == kind]

    def check_alive(self):
        _check(self.proc is None or self.proc.poll() is None,
               f"{self.name}: the server exited {self.proc.poll() if self.proc else ''}:"
               f" {self.stderr()[-2000:]}")

    def stderr(self):
        if self.proc is None:
            return ""
        with open(self.err_path, encoding="utf-8", errors="replace") as f:
            return f.read()

    def stop(self):
        """Drain and stop: ``(clean, exit code, stderr)``."""
        if self.sup is not None:
            clean = self.sup.stop(graceful=True)
            self.final = _final_workers(self.sup)
            return clean, 0 if clean else 1, ""
        import signal

        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=FLEET_WAIT_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            rc = "killed after a drain timeout"
        return rc == 0, rc, self.stderr()

    def kill(self):
        if self.sup is not None:
            self.sup.stop(graceful=False)
        elif self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _fleet_ready(fleet, n, base):
    """Until every slot's first worker sent READY (``n`` > 0) and the
    shared port answers ``/readyz`` 200.  Returns ``{slot:
    spawn-to-ready seconds}``."""
    deadline = time.monotonic() + FLEET_WAIT_S
    while True:
        fleet.check_alive()
        ready = {e["slot"]: e for e in fleet.events("ready")}
        if len(ready) >= n:
            try:
                if _http_get(base, "/readyz")[0] == 200:
                    break
            except OSError:
                pass
        _check(time.monotonic() < deadline,
               f"{fleet.name}: not ready in {FLEET_WAIT_S} s: "
               f"{fleet.events()[-6:]}")
        time.sleep(0.05)
    spawned = {e["slot"]: e for e in fleet.events("spawn")
               if e["incarnation"] == 1}
    return {slot: ready[slot]["ts"] - spawned[slot]["ts"]
            for slot in sorted(ready)}


def _fleet_warm(ctx, base, n):
    """FLEET_WARM_PER_WORKER fresh-connection requests a worker, each
    answered 200 (trace ids ``ffff...``, outside every run's prefix)."""
    from kmeans_tpu_torch.serve import assign as A

    frame = A.encode_points(ctx["pool_t"][:HTTP_POINTS].cpu().numpy())
    for i in range(FLEET_WARM_PER_WORKER * max(n, 1)):
        st, _ = _http_get(base, "/api/assign", frame,
                          A.WIRE_POINTS_CONTENT_TYPE)
        _check(st == 200, f"warm-up request {i} answered {st}")


def _gpu_sampler():
    """Sample ``utilization.gpu`` every FLEET_UTIL_PERIOD_S on a thread;
    returns the function that stops it and gives the samples (%)."""
    import threading

    samples, stop = [], threading.Event()

    def loop():
        while not stop.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=utilization.gpu",
                     "--format=csv,noheader,nounits"],
                    capture_output=True, text=True, timeout=10).stdout
            except (OSError, subprocess.SubprocessError):
                return                  # no samples: printed as nan
            try:
                samples.append(float(out.split()[0]))
            except (IndexError, ValueError):
                pass
            stop.wait(FLEET_UTIL_PERIOD_S)

    t = threading.Thread(target=loop, daemon=True)
    t.start()

    def finish():
        stop.set()
        t.join(timeout=15)
        return samples

    return finish


def _card_memory():
    """``(card MiB in use, [(pid, MiB) of each compute process])`` from
    nvidia-smi.  In a container the pids may be the host's (or all 1), so
    a worker's share is also read as the rise of the card's total."""
    def query(*args):
        return subprocess.run(["nvidia-smi", *args,
                               "--format=csv,noheader,nounits"],
                              capture_output=True, text=True,
                              timeout=10).stdout

    total = float(query("--query-gpu=memory.used").split()[0])
    apps = []
    for line in query("--query-compute-apps=pid,used_memory").splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps.append((int(parts[0]), float(parts[1])))
    return total, apps


def _fleet_load(ctx, port, run, gen_to, *, procs, clients, fresh=False,
                pace=0.0, until_file=None, seconds=FLEET_SECONDS,
                retry_resets=False):
    """Start ``procs`` client processes sharing ``clients`` threads;
    returns them with their output paths, once each printed READY."""
    started = []
    per = clients // procs
    for i in range(procs):
        out = f"{ctx['dir']}/run{run:x}-{i}.npz"
        spec = {"host": "127.0.0.1", "port": port,
                "pool": ctx["pool_path"], "out": out,
                "points": HTTP_POINTS, "clients": per, "seconds": seconds,
                "swap_wait": SERVE_SWAP_WAIT_S, "mode": "binary",
                "run": run, "new_gen": gen_to, "tno_base": i * per,
                "fresh": fresh, "pace": pace, "until_file": until_file,
                "retry_resets": retry_resets}
        proc = subprocess.Popen(
            [sys.executable, __file__, "--http-client", json.dumps(spec)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        started.append((proc, out))
    for proc, _ in started:
        ready = proc.stdout.readline().strip()
        _check(ready == "READY", f"a client did not start: {ready!r}")
    return started


def _fleet_collect(name, started):
    """Wait for the client processes; their responses merged: ``(table,
    labels, errors, hung, seconds, retried)``."""
    import numpy as np

    tables, labels, errors, hung, seconds = [], [], [], 0, 0.0
    retried = []
    for proc, out in started:
        try:
            _, err = proc.communicate(
                timeout=FLEET_SECONDS + 2 * SERVE_SWAP_WAIT_S
                + 4 * HTTP_CALL_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        _check(proc.returncode == 0,
               f"{name}: a client failed: {err[-2000:]}")
        data = np.load(out)
        tables.append(data["table"])
        labels.append(data["labels"])
        errors += list(data["errors"])
        retried += [str(t) for t in data["retried"]]
        hung += int(data["hung"])
        seconds = max(seconds, float(data["seconds"]))
    return (np.concatenate(tables), np.concatenate(labels), errors, hung,
            seconds, retried)


def _k5_of_trace(doc):
    """K5's launches in a fleet's merged trace: each dense batch's
    ``assign.kernel`` span and each ``assign.rescore`` span (a pruned
    batch whose certificate failures K5 rescored)."""
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    dense = sum(1 for e in spans if e["name"] == "assign.kernel"
                and e["args"].get("kernel") == "dense")
    rescored = sum(1 for e in spans if e["name"] == "assign.rescore")
    return dense, rescored


def _first_responses(doc, names):
    """``{lane name: ms}``: the server-side time of each worker's first
    ``POST /api/assign`` (its CUDA context, the library's load and the
    prepared model's build included)."""
    first = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e["name"] == "POST /api/assign":
            if e["pid"] not in first or e["ts"] < first[e["pid"]]["ts"]:
                first[e["pid"]] = e
    return {names.get(pid, f"pid {pid}"): 1e-3 * e["dur"]
            for pid, e in sorted(first.items())}


def _fleet_run(ctx, name, fleet, n, route, run, gen_to, port, obs_port,
               trace_dir):
    """One run of phase 11 against ``fleet`` (``n`` workers): boot,
    warm-up, the two client processes, a publish half-way (the
    supervisor pushes RELOAD), the card's memory and busy share, then
    the checks: K5's labels of each response's generation, no 503, no
    drop, no unplanned exit, the (aggregated) ``/metrics`` against the
    client's counts and C2's families under a ``worker`` label, the
    (merged) trace strict JSON with every worker pid's lanes, a clean
    drain with exit 0; K5's launches from the workers' trace, held to the
    engine counters.  Returns the run's summary."""
    import numpy as np

    from kmeans_tpu_torch.continuous.registry import ModelRegistry
    from kmeans_tpu_torch.obs.fleetview import merge_spool
    from kmeans_tpu_torch.obs.registry import parse_exposition

    base = f"http://127.0.0.1:{port}"
    mbase = f"http://127.0.0.1:{obs_port}"
    gen_from = gen_to - 1
    boot = _fleet_ready(fleet, n, base)
    mem_before = _card_memory()[0]     # no worker has touched the card
    _fleet_warm(ctx, base, n)
    before = _scrape(mbase)
    started = _fleet_load(ctx, port, run, gen_to, procs=FLEET_CLIENT_PROCS,
                          clients=HTTP_CLIENTS)
    sampler = _gpu_sampler()
    time.sleep(FLEET_SECONDS / 2)
    other = ModelRegistry(path=ctx["model_dir"])
    other.load_latest()
    _check(other.generation == gen_from,
           f"{name}: the directory holds generation {other.generation}, "
           f"not {gen_from}")
    other.publish(ctx["centroids"][gen_to % 2], generation=gen_to,
                  trigger="drift")
    mem = _card_memory()
    table, got, errors, hung, seconds, _ = _fleet_collect(name, started)
    util = sampler()
    after = _scrape(mbase)
    status = table[:, 1].astype(int)
    n_req = len(table)
    gens = {int(g) for g in table[status == 200, 2]}
    _check(not errors and not hung and n_req and (status == 200).all(),
           f"{name}: {n_req} responses, {int((status != 200).sum())} not "
           f"200 ({int((status == 503).sum())} 503s), {len(errors)} "
           f"connection errors {errors[:1]}, {hung} clients hung")
    _check(gens == {gen_from, gen_to},
           f"{name}: generations {sorted(gens)}, not {gen_from} and {gen_to}")
    _check_http_responses(name, table, got, ctx)
    seen = {
        "POST /api/assign 200": _metric(
            before, after, "kmeans_tpu_http_requests_total", method="POST",
            route="/api/assign", status="200"),
        "wire binary": _metric(before, after,
                               "kmeans_tpu_assign_wire_requests_total",
                               format="binary"),
    }
    _check(seen == {"POST /api/assign 200": n_req, "wire binary": n_req},
           f"{name}: /metrics counted {seen}, the clients {n_req}")
    text = _http_get(mbase, "/metrics")[1].decode()
    families = parse_exposition(text)
    fit_fams = ("kmeans_tpu_sweep_recompute_rows_total",
                "kmeans_tpu_sweep_group_filter_fraction",
                "kmeans_tpu_accel_steps_total")
    _check(all(f in families for f in fit_fams),
           f"{name}: /metrics lacks {[f for f in fit_fams if f not in families]}")
    lanes = [str(i) for i in range(n)]
    for fam in fit_fams[1:]:
        have = {s.label_dict().get("worker") for s in families[fam].samples}
        _check(set(lanes) <= have,
               f"{name}: {fam} has lanes {sorted(map(str, have))}, not "
               f"every worker's {lanes}")
    restarts = families["kmeans_tpu_fleet_restarts_total"].samples
    _check(all(s.value == 0 for s in restarts),
           f"{name}: the supervisor counted restarts")
    # The (merged) trace over HTTP: strict JSON, every worker's lanes.
    time.sleep(0.6)                   # one spool flush period
    doc = _strict_trace(mbase)
    spans = _run_spans(doc, f"{run:04x}")
    pids = {e["pid"] for e in spans if e["name"] == "POST /api/assign"}
    spawns = {e["pid"]: e["slot"] for e in fleet.events("spawn")}
    if n:
        procs = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("name") == "process_name"}
        _check(len(pids) == n and all(
            procs.get(p) == f"worker {spawns.get(p)}" for p in pids),
            f"{name}: /api/trace has request lanes of pids {sorted(pids)} "
            f"named {[procs.get(p) for p in pids]}, not {n} workers'")
    clean, rc, err = fleet.stop()
    _check(clean and rc == 0 and "Traceback" not in err
           and "CUDA error" not in err,
           f"{name}: the server stopped with {rc}: {err[-2000:]}")
    # No unplanned exit: every exit the monitor saw was a drained one,
    # and each slot's worker drained and exited 0.
    exits, final = fleet.events("exit"), fleet.events("final")
    _check(all(e["drained"] and e["returncode"] == 0 for e in exits)
           and not fleet.events("sigkill") and len(final) == n
           and all(e["drained"] and e["returncode"] == 0 for e in final),
           f"{name}: exits {exits}, final workers {final}, sigkills "
           f"{fleet.events('sigkill')}")
    # The complete trace from the spool, after the drain flushed it.
    full = merge_spool(trace_dir, {p: f"worker {s}"
                                   for p, s in spawns.items()})
    dense, rescored = _k5_of_trace(full)
    batches = {kind: after.get(("kmeans_tpu_assign_batches_total",
                                (("kernel", kind),)), 0.0)
               for kind in ("dense", "pruned")}
    fallback = after.get(("kmeans_tpu_assign_pruned_fallback_rows_total",
                          ()), 0.0)
    _check(dense == batches["dense"]
           and (fallback > 0) <= rescored
           <= min(batches["pruned"], fallback)
           and batches[route] > 0,
           f"{name}: the trace has {dense} dense kernels and {rescored} "
           f"rescores; /metrics {batches} batches, {fallback} fallback rows")
    tids, split = _span_split(name, _run_spans(full, f"{run:04x}"), set())
    lat = table[:, 3].tolist()
    p50, p99, top = _percentiles(lat)
    new = table[table[:, 2] == gen_to]
    first = _first_responses(full, {p: f"worker {s}"
                                    for p, s in spawns.items()})
    summary = {"qps": n_req / seconds, "points_s": n_req * HTTP_POINTS
               / seconds, "p50": p50, "p99": p99, "k5": dense + rescored,
               "boot": boot, "first": first}
    busy = statistics.fmean(util) if util else float("nan")
    worker_mem = (f"the card's {mem[0]:.0f} MiB in use, "
                  f"{mem[0] - mem_before:.0f} more than at READY "
                  f"({(mem[0] - mem_before) / max(n, 1):.0f} a worker); "
                  f"compute processes (pid, MiB) {mem[1]}")
    print(f"fleet {name} ({ctx['card']}): {n_req} requests in "
          f"{seconds:.3f} s = {summary['qps']:.1f} QPS, "
          f"{summary['points_s']:.0f} points/s; p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms, max {top:.3f} ms; 503s 0; "
          f"{int(sum(batches.values()))} batches ({batches}), fallback rows "
          f"{int(fallback)}; K5 launches {dense + rescored} ({dense} dense "
          f"+ {rescored} rescores, from the workers' trace); first "
          f"generation-{gen_to} response at {float(new[:, 4].min()):.3f} s "
          "of the run")
    print(f"fleet {name}: spawn-to-ready s "
          f"{ {f'worker {k}': round(v, 3) for k, v in boot.items()} }; "
          f"first response ms (server side) "
          f"{ {k: round(v, 3) for k, v in first.items()} }; card memory: "
          f"{worker_mem}; card busy {busy:.1f}% over {len(util)} "
          f"samples of utilization.gpu")
    print(f"fleet {name}: {split}")
    return summary


class _SseWatch:
    """SSE subscribers of one room on a fleet's shared port, each read to
    its end on a thread of its own, which records when (the supervisor's
    clock, ``time.monotonic()``) and how (the server's close, or an
    error) the stream ended.  Opens FLEET_SSE_SUBS, and more (up to four
    times as many) until they sit on two or more workers: a worker's room
    counts its own subscribers, so with the subscribers opened one by one
    the largest ``peers`` of their hellos is one less than the most on
    one worker, and the rest are on others."""

    def __init__(self, base, room):
        import threading

        self.ends = []                  # (monotonic time, closed cleanly)
        self._lock = threading.Lock()
        self.threads = []
        seen = set()                    # the peer counts the hellos gave
        while len(self.threads) < FLEET_SSE_SUBS or (
                len(self.threads) == max(seen) + 1
                and len(self.threads) < 4 * FLEET_SSE_SUBS):
            sock, buf = _sse_open(base, room)
            hello, _ = _sse_events(sock, buf,
                                   lambda e: e["type"] == "hello")
            seen.add(hello[-1][1]["peers"])
            t = threading.Thread(target=self._read, args=(sock,),
                                 daemon=True)
            t.start()
            self.threads.append(t)
        _check(len(self.threads) > max(seen) + 1,
               f"SSE on the fleet: all {len(self.threads)} subscribers on "
               "one worker")

    def _read(self, sock):
        sock.settimeout(FLEET_WAIT_S)
        clean = False
        try:
            while sock.recv(65536):
                pass
            clean = True
        except OSError:
            pass
        finally:
            sock.close()
        with self._lock:
            self.ends.append((time.monotonic(), clean))

    def wait(self, timeout):
        """The ``(time, clean)`` ends, once every stream ended or after
        ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        for t in self.threads:
            t.join(max(0.0, deadline - time.monotonic()))
        with self._lock:
            return list(self.ends)


def _fleet_drill(ctx, name, run, kill):
    """A drill at FLEET_DRILL_WORKERS workers on the embedding API, under
    FLEET_DRILL_CLIENTS paced fresh-connection clients: the kill drill
    (``fleet.heartbeat:kill@2`` in slot 0's first incarnation; prints the
    RTO, its exit to its replacement's ``ready``, beside the reference's
    gate, and counts the failed requests, which may only be the ones in
    flight: one a client) or the rolling replace (``rolling_replace()``,
    what SIGHUP runs: no request may fail).  In the rolling replace a
    connection reset before any byte of a response is sent once more on a
    new connection: such an attempt may only be one no worker accepted (a
    connection queued on a listener as it closes is reset by the kernel),
    so its trace id must be on no request span of the workers' spool, and
    every predecessor must drain with no accepted request unanswered.
    The rolling drill's workers keep rooms in a ``persist_dir``, as ``cli
    serve`` gives them, and SSE subscribers (:class:`_SseWatch`) sit on
    both workers through the replace, each stream ended by its worker's
    drain; then more on both successors through the fleet's drain (what
    SIGTERM runs), which must end in under half of ``fleet_drain_s``.
    Every answered request is held to K5's labels.  Returns ``(summary
    line, K5 launches seen in the trace)``."""
    from kmeans_tpu_torch.config import ServeConfig
    from kmeans_tpu_torch.obs.fleetview import merge_spool
    from kmeans_tpu_torch.serve.fleet import FleetSupervisor

    port = _free_port()
    trace_dir = f"{ctx['dir']}/trace-{name}"
    env = ({0: {"KMEANS_TPU_FAULTS": "fleet.heartbeat:kill@2"}} if kill
           else None)
    base = f"http://127.0.0.1:{port}"
    sup = FleetSupervisor(ServeConfig(
        host="127.0.0.1", port=port, model_dir=ctx["model_dir"],
        trace_dir=trace_dir, fleet_obs_port=None,
        persist_dir=None if kill else f"{ctx['dir']}/rooms-{run:x}"),
        workers=FLEET_DRILL_WORKERS, worker_env=env)
    drain_s = float(sup.config.fleet_drain_s)
    fleet = _FleetUnderTest(name, ctx["dir"], sup=sup)
    until = f"{ctx['dir']}/{name}.stop"
    started = []
    try:
        _fleet_ready(fleet, FLEET_DRILL_WORKERS, base)
        started = _fleet_load(ctx, port, run, None, procs=1,
                              clients=FLEET_DRILL_CLIENTS, fresh=True,
                              pace=FLEET_DRILL_PACE_S, until_file=until,
                              seconds=1.0, retry_resets=not kill)
        if kill:
            deadline = time.monotonic() + FLEET_WAIT_S
            while True:
                died = [e for e in fleet.events("exit") if e["slot"] == 0]
                back = [e for e in fleet.events("ready")
                        if died and e["slot"] == 0
                        and e["ts"] > died[0]["ts"]]
                if back:
                    break
                _check(time.monotonic() < deadline,
                       f"{name}: slot 0 did not die and come back: "
                       f"{fleet.events()[-8:]}")
                time.sleep(0.02)
            time.sleep(1.0)            # the replacement serves under load
        else:
            watch = _SseWatch(base, "FLT")
            time.sleep(1.0)
            sup.rolling_replace()
            time.sleep(1.0)
        open(until, "w").close()
        table, got, errors, hung, seconds, retried = _fleet_collect(
            name, started)
        started = []
        status = table[:, 1].astype(int)
        ok = status == 200
        failed = len(errors) + int((~ok).sum())
        _check(not hung and ok.any(), f"{name}: {hung} clients hung")
        _check_http_responses(name, table[ok], got[ok], ctx)
        st, _ = _http_get(base, "/api/model")
        _check(st == 200, f"{name}: the fleet does not answer after it")
        if not kill:
            rolled_ends, n_subs = watch.wait(2 * drain_s), len(watch.threads)
            watch = _SseWatch(base, "FLT")
        t0 = time.monotonic()
        clean, _, _ = fleet.stop()
        stop_s = time.monotonic() - t0
        if not kill:
            final_ends, n_final = watch.wait(2 * drain_s), len(watch.threads)
    finally:
        for proc, _ in started:
            proc.kill()
            proc.communicate()
        fleet.kill()
    spool = merge_spool(trace_dir)
    dense, rescored = _k5_of_trace(spool)
    sigkills = fleet.events("sigkill")
    exits = fleet.events("exit")
    if kill:
        died = [e for e in exits if e["slot"] == 0][0]
        back = [e for e in fleet.events("ready")
                if e["slot"] == 0 and e["ts"] > died["ts"]][0]
        rto = back["ts"] - died["ts"]
        _check(died["returncode"] == 137 and died["incarnation"] == 1
               and not died["drained"],
               f"{name}: slot 0's first exit was {died}")
        _check(failed <= FLEET_DRILL_CLIENTS and clean,
               f"{name}: {failed} failed requests ({errors[:3]}), more "
               f"than the {FLEET_DRILL_CLIENTS} a kill can catch in "
               "flight")
        line = (f"kill drill: RTO {rto:.3f} s (slot 0 exit 137 to its "
                f"replacement's ready; the reference's gate "
                f"{FLEET_REF_RTO_S:.1f} s), {failed} failed requests of "
                f"{len(table) + len(errors)} ({errors[:3]}), "
                f"{int(ok.sum())} answered in {seconds:.3f} s")
    else:
        rolled_ts = {e["slot"]: e["ts"] for e in fleet.events("rolled")}
        rolled = set(rolled_ts)
        drained = fleet.events("drained")
        served = {e["args"].get("trace_id") for e in spool["traceEvents"]
                  if e.get("name") == "POST /api/assign"}
        _check(failed == 0 and clean and rolled == {0, 1}
               and not sigkills and all(e["drained"] for e in exits)
               and all(e["unanswered"] == 0 for e in drained)
               and not served & set(retried),
               f"{name}: {failed} failed requests ({errors[:3]}), rolled "
               f"{sorted(rolled)}, sigkills {sigkills}, drains {drained}, "
               f"reset attempts a worker answered "
               f"{sorted(served & set(retried))}")
        # Slot 1's predecessor drains only once slot 0's has exited and
        # slot 1's successor is ready: a stream that ended before slot 1
        # rolled was on slot 0's predecessor.
        ended = [sum(rolled_ts[0] <= t < rolled_ts[1]
                     for t, _ in rolled_ends),
                 sum(t >= rolled_ts[1] for t, _ in rolled_ends)]
        _check(sum(ended) == n_subs and all(c for _, c in rolled_ends)
               and min(ended) > 0 and len(final_ends) == n_final
               and all(c for _, c in final_ends) and stop_s < drain_s / 2,
               f"{name}: SSE streams through the rolling replace "
               f"{rolled_ends} (rolled {rolled_ts}), through the fleet's "
               f"drain {final_ends}, its stop {stop_s:.3f} s")
        line = (f"rolling replace: both slots rolled, 0 failed requests "
                f"of {len(table)}, no SIGKILL, every predecessor drained "
                f"with no accepted request unanswered, {len(retried)} "
                f"connections reset before any worker accepted them "
                f"(sent again), in {seconds:.3f} s of load; SSE: "
                f"{n_subs} subscribers through it ({ended[0]} and "
                f"{ended[1]} closed by the two predecessors' drains), then "
                f"{n_final} on the successors through the fleet's drain "
                f"(what SIGTERM runs): its stop {stop_s:.3f} s "
                f"(fleet_drain_s {drain_s}), every stream closed by the "
                f"server, 0 accepted requests unanswered")
    print(f"fleet {name} ({ctx['card']}): {line}; K5 launches in the "
          f"trace {dense + rescored}")
    return line, dense + rescored


def phase_fleet(card, centroids, http_summaries):
    """Phase 11, imagenet-fleet: imagenet-http's model and pool, 48
    keep-alive clients split over two client processes, binary frames of
    64 points, FLEET_SECONDS a run (the two client processes separate the
    client's interpreter lock from the servers').  N workers for N in
    FLEET_SIZES on the default (pruned) route: ``cli serve --workers N
    --fleet-obs-port P`` for N > 1, and the embedding API for one worker
    (the command line serves ``--workers 1`` in-process, as the
    reference's does), then FLEET_DENSE_WORKERS workers on the dense route
    (the embedding API: ``assign_prune_min_k=0`` has no flag), each
    publishing a generation half-way; then the kill drill and the rolling
    replace at FLEET_DRILL_WORKERS.  (Until PR 19 a single ``cli serve``
    process ran first under the same clients; phase 10 drives that
    command in process.)  Returns K5's launches over the phase (the
    workers' traces)."""
    import tempfile

    from kmeans_tpu_torch.config import ServeConfig
    from kmeans_tpu_torch.serve.fleet import FleetSupervisor

    t_phase = time.perf_counter()
    launches, rows = 0, []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        ctx = _http_context(card, centroids, tmp)
        gen, run = 1, 0x11
        runs = [(f"{n} workers", n, "pruned") for n in FLEET_SIZES]
        runs += [(f"{FLEET_DENSE_WORKERS} workers dense",
                  FLEET_DENSE_WORKERS, "dense")]
        for label, n, route in runs:
            port, obs_port = _free_port(), _free_port()
            trace_dir = f"{tmp}/trace-{run:x}"
            argv = ["serve", "--model-dir", ctx["model_dir"], "--host",
                    "127.0.0.1", "--port", str(port), "--trace-dir",
                    trace_dir]
            name = f"imagenet-fleet {label}"
            if route == "dense" or n == 1:
                # The embedding API: the command line runs one worker
                # in-process (as the reference's does) and has no flag
                # for the dense route.
                extra = {"assign_prune_min_k": 0} if route == "dense" else {}
                fleet = _FleetUnderTest(
                    f"run{run:x}", tmp, sup=FleetSupervisor(ServeConfig(
                        host="127.0.0.1", port=port,
                        model_dir=ctx["model_dir"], trace_dir=trace_dir,
                        fleet_obs_port=obs_port, **extra), workers=n))
            else:
                fleet = _FleetUnderTest(
                    f"run{run:x}", tmp, argv=argv + [
                        "--workers", str(n), "--fleet-obs-port",
                        str(obs_port)])
            try:
                summary = _fleet_run(ctx, name, fleet, n, route, run,
                                     gen + 1, port, obs_port, trace_dir)
            finally:
                fleet.kill()
            gen, run = gen + 1, run + 1
            launches += summary["k5"]
            rows.append((label, route, summary))
        drills = []
        for name, kill in (("kill", True), ("rolling", False)):
            line, k5 = _fleet_drill(ctx, f"imagenet-fleet {name}", run,
                                    kill)
            drills.append(line)
            launches += k5
            run += 1
    one = http_summaries.get("binary")
    print("imagenet-fleet, binary, 48 clients in "
          f"{FLEET_CLIENT_PROCS} processes ({card}); phase 10 (one client "
          "process, one server): "
          + (f"{one['qps']:.1f} QPS, p50 {one['p50']:.3f} ms, p99 "
             f"{one['p99']:.3f} ms" if one else "not run"))
    for label, route, summary in rows:
        print(f"imagenet-fleet {label} ({route} route, {card}): "
              f"{summary['qps']:.1f} QPS, {summary['points_s']:.0f} "
              f"points/s, p50 {summary['p50']:.3f} ms, p99 "
              f"{summary['p99']:.3f} ms; K5 launches {summary['k5']}")
    for line in drills:
        print(f"imagenet-fleet {line}")
    print(f"fleet phase: {time.perf_counter() - t_phase:.1f} s; K5 launches "
          f"{launches} (the workers' traces: dense batches' assign.kernel "
          "and assign.rescore spans)")
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the step-paced runner and ``cli train``
# ---------------------------------------------------------------------------

#: Iterations of each in-process runner at the headline, and of the CLI's
#: headline runs; the iteration at or after which the drill sends SIGTERM.
RUNNER_ITERS = 20
CLI_ITERS = 40
CLI_CHECKPOINT_EVERY = 5
DRILL_AT = 8
#: Seconds any one ``cli train`` process may take, build and data included.
CLI_TIMEOUT_S = 300


def _train_cli(spec) -> int:
    """``chip_smoke.py --train-cli SPEC``: ``python -m kmeans_tpu_torch.cli``
    with ``spec["argv"]``, run as ``-m`` runs it (:mod:`runpy`), the launch
    counts set to 0 before it and written to ``spec["counts"]`` (JSON)
    after it, whatever its exit code."""
    import runpy

    from kmeans_tpu_torch.native import loader as NL
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    K.reset_launch_counts()
    sys.argv = ["kmeans_tpu_torch.cli"] + spec["argv"]
    try:
        runpy.run_module("kmeans_tpu_torch.cli", run_name="__main__",
                         alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    finally:
        with open(spec["counts"], "w", encoding="utf-8") as f:
            json.dump(K.launch_counts(), f)
        if spec.get("gathers"):
            with open(spec["gathers"], "w", encoding="utf-8") as f:
                json.dump(NL.gather_counts(), f)
    return rc


class _CliRun:
    """One ``cli train`` process (:func:`_train_cli`): its stderr read line
    by line (``on_line`` may send it a signal), its result line, exit code,
    launch counts and wall time."""

    def __init__(self, tmp, name, argv, on_line=None, gathers=None):
        import os
        import threading

        self.name = name
        counts = f"{tmp}/{name}.counts.json"
        out_path = f"{tmp}/{name}.out"
        root = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        with open(out_path, "w", encoding="utf-8") as out:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--train-cli",
                 json.dumps({"argv": argv, "counts": counts,
                             "gathers": gathers})],
                cwd=root, stdout=out, stderr=subprocess.PIPE, text=True)
            self.err = []
            self.signal_at = None
            # A process that hangs without a line is killed at the limit.
            watchdog = threading.Timer(CLI_TIMEOUT_S, proc.kill)
            watchdog.start()
            try:
                for line in proc.stderr:
                    self.err.append(line.rstrip("\n"))
                    if on_line is not None and self.signal_at is None \
                            and on_line(self, line, proc):
                        self.signal_at = time.perf_counter()
                self.rc = proc.wait(timeout=60)
            finally:
                watchdog.cancel()
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        self.seconds = time.perf_counter() - t0
        self.exit_s = (None if self.signal_at is None
                       else time.perf_counter() - self.signal_at)
        self.stdout = open(out_path, encoding="utf-8").read()
        self.counts = json.load(open(counts, encoding="utf-8"))
        self.gathers = (json.load(open(gathers, encoding="utf-8"))
                        if gathers else None)
        self.progress = [json.loads(ln) for ln in self.err
                         if ln.startswith('{"event": "iter"')]
        self.result = None
        lines = self.stdout.strip().splitlines()
        if self.rc == 0 and lines:
            self.result = json.loads(lines[-1])

    def need(self, rc=0):
        _check(self.rc == rc,
               f"{self.name}: exit code {self.rc} (wanted {rc}); stderr "
               f"tail {self.err[-6:]}")
        return self

    def iter_ms(self):
        """Median milliseconds of the progress lines' iterations past the
        first two (each sweep function's first call)."""
        sec = [e["seconds"] for e in self.progress[2:]]
        return 1e3 * statistics.median(sec) if sec else float("nan")

    def line(self, extra=""):
        res = self.result or {}
        return (f"{self.name}: exit {self.rc}, {self.seconds:.3f} s of wall "
                f"time (process, CUDA context, data, k-means++, fit); fit "
                f"{res.get('wall_s', float('nan'))} s, n_iter "
                f"{res.get('n_iter')}, inertia {res.get('inertia')}; "
                f"launches {self.counts}{extra}")


def _runner_headline(card):
    """In-process runners on phase 4's bf16 data and c0: ``update="delta"``
    held to ``fit_lloyd``, then yinyang and Anderson.  Returns the bf16
    launch counts of the runner runs."""
    import io

    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    bf16 = torch.bfloat16
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=bf16)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(1), x, k)
    cfg = kt.KMeansConfig(k=k, update="delta", compute_dtype="bfloat16")
    # A warm-up through K1 and K2, so no timed run loads the library.
    kt.fit_lloyd(x, k, config=cfg, init=c0, max_iter=2, tol=-1.0)
    _sync()
    t0 = time.perf_counter()
    fused = kt.fit_lloyd(x, k, config=cfg, init=c0, max_iter=RUNNER_ITERS,
                         tol=-1.0)
    _sync()
    fused_s = time.perf_counter() - t0
    launches = {}

    def run(name, config, accel=None, seen=None):
        runner = kt.LloydRunner(x, k, config=config, accel=accel)
        runner.init(c0)
        infos, buf = [], io.StringIO()

        def callback(info):
            infos.append(info)
            if seen is not None and info.iteration == RUNNER_ITERS - 1:
                seen["c"] = runner.centroids.clone()

        t0 = time.perf_counter()
        state, counts = _counted_run(lambda: runner.run(
            max_iter=RUNNER_ITERS, tol=-1.0, callback=callback,
            telemetry=kt.obs.TelemetryWriter(buf)))
        wall = time.perf_counter() - t0
        _add_counts(launches, counts)
        events = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        iters = [e for e in events if e["event"] == "iter"]
        _check(len(infos) == len(iters) == int(state.n_iter) == RUNNER_ITERS
               and _finite(state.centroids)
               and math.isfinite(float(state.inertia)),
               f"{name}: {len(infos)} iterations or a non-finite result")
        steady = [i.seconds for i in infos[1:] if i.iteration % 16 != 1]
        print(f"{name} ({card}): {RUNNER_ITERS} iterations + finalize in "
              f"{wall:.3f} s = {1e3 * wall / (RUNNER_ITERS + 1):.3f} ms a "
              f"sweep; steady iteration (median, host sync included) "
              f"{1e3 * statistics.median(steady):.3f} ms; first iteration "
              f"{1e3 * infos[0].seconds:.3f} ms ({iters[0]['phase']}); "
              f"final inertia {float(state.inertia):.6e}; launches {counts}")
        return runner, state, counts, iters, wall

    _, delta, counts, _, wall = run("runner delta", cfg)
    fused_ms = 1e3 * fused_s / (RUNNER_ITERS + 1)
    print(f"runner delta against fit_lloyd(update='delta', init=c0, "
          f"max_iter={RUNNER_ITERS}, tol=-1) in this call ({card}): fused "
          f"{fused_s:.3f} s = {fused_ms:.3f} ms a sweep (final view "
          f"included), runner {1e3 * wall / (RUNNER_ITERS + 1):.3f} ms a "
          f"sweep: {wall / fused_s:.3f}x, the price of a callback, a "
          "telemetry event and two host reads an iteration")
    _check(counts["lloyd_pass_cuda"] == 3 and counts["lloyd_delta_cuda"]
           == RUNNER_ITERS - 2 and sum(counts.values()) == RUNNER_ITERS + 1,
           f"runner delta: launches {counts}, wanted K1 3 (iterations 1 "
           f"and 17, finalize) and K2 {RUNNER_ITERS - 2}")
    _check(int(delta.n_iter) == int(fused.n_iter) == RUNNER_ITERS,
           "runner delta: iterations differ from the fused fit's")
    rel = abs(float(delta.inertia) - float(fused.inertia)) / float(
        fused.inertia)
    _check(rel <= FIT_INERTIA_RTOL,
           f"runner delta: inertia {float(delta.inertia)} against the "
           f"fused fit's {float(fused.inertia)} (rel {rel:.3e})")
    print(f"  runner delta inertia against the fused fit's: rel "
          f"{rel:.3e} (<= {FIT_INERTIA_RTOL})")

    seen = {}
    runner, yy, counts, iters, _ = run(
        "runner yinyang", kt.KMeansConfig(k=k, update="yinyang",
                                          compute_dtype="bfloat16"),
        seen=seen)
    _check(counts["lloyd_hamerly_cuda"] == RUNNER_ITERS
           and counts["lloyd_pass_cuda"] == 1
           and sum(counts.values()) == RUNNER_ITERS + 1,
           f"runner yinyang: launches {counts}, wanted K4 {RUNNER_ITERS} "
           "and K1 once (finalize)")
    fracs = [e["recompute_fraction"] for e in iters]
    print(f"  recompute fraction per iteration: "
          f"{[round(f, 4) for f in fracs]}")
    last = runner._dstate[0]
    k1 = K.lloyd_pass_cuda(x, seen["c"], compute_dtype=bf16,
                           with_update=False)[0]
    moved = _check_labels_rows("runner yinyang", x, seen["c"], bf16, last,
                               k1)
    rel = abs(float(yy.inertia) - float(delta.inertia)) / float(
        delta.inertia)
    _check(rel <= FIT_INERTIA_RTOL,
           f"runner yinyang: inertia {float(yy.inertia)} against the delta "
           f"runner's {float(delta.inertia)}")
    print(f"  last yinyang sweep against K1 at the centroids it scored: "
          f"{moved} labels differ, each a tie within {SCORE_RTOL}; final "
          f"inertia against the delta runner's: rel {rel:.3e}")

    _, acc, counts, iters, _ = run("runner anderson", cfg, accel="anderson")
    totals = {o: sum(e["accel"] == o for e in iters)
              for o in ("accepted", "rejected", "fallback")}
    _check(sum(totals.values()) == RUNNER_ITERS,
           f"runner anderson: outcomes {totals}")
    print(f"  anderson outcomes {totals}; final inertia against the delta "
          f"runner's: {float(acc.inertia) / float(delta.inertia):.6f}x")
    return launches


def _runner_codebook(card, codebook_c):
    """The runner at ``codebook`` on phase 6's data and c0 (K5 and K6
    only), held to phase 6's fit (``codebook_c``; made here when phase 6
    did not run).  Returns its bf16 launch counts."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init

    n, d, k = CODEBOOK["n"], CODEBOOK["d"], CODEBOOK["k"]
    x, _, _ = kt.make_blobs(11, n, d, k, dtype=torch.bfloat16)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(2), x, k)
    if codebook_c is None:
        codebook_c = kt.KMeans(
            n_clusters=k, update="delta", compute_dtype="bfloat16", init=c0,
            max_iter=CODEBOOK_SWEEPS, tol=-1.0).fit(x).cluster_centers_
    want = torch.as_tensor(codebook_c, device="cuda")
    runner = kt.LloydRunner(x, k, config=kt.KMeansConfig(
        k=k, update="delta", compute_dtype="bfloat16"))
    runner.init(c0)
    infos = []
    t0 = time.perf_counter()
    state, counts = _counted_run(lambda: runner.run(
        max_iter=CODEBOOK_SWEEPS, tol=-1.0, callback=infos.append))
    wall = time.perf_counter() - t0
    _check(counts["tiled_argmin_cuda"] == CODEBOOK_SWEEPS + 1
           and counts["tiled_fold_cuda"] == CODEBOOK_SWEEPS + 1
           and sum(counts.values()) == 2 * (CODEBOOK_SWEEPS + 1),
           f"runner codebook: launches {counts}, wanted K5 and K6 only")
    err = _close("runner codebook centroids against phase 6's fit",
                 state.centroids, want)
    print(f"runner codebook ({card}): {CODEBOOK_SWEEPS} iterations + "
          f"finalize in {wall:.3f} s; per iteration "
          f"{[round(1e3 * i.seconds, 3) for i in infos]} ms; centroids "
          f"against phase 6's fit: max abs error {err:.3e}; inertia "
          f"{float(state.inertia):.6e}; launches {counts}")
    return counts


def _cli_runs(card, tmp):
    """The headline CLI runs (f32 runner, the drill and its resume, bf16,
    the fused adaptive fit) and the cifar10 minibatch fit.  Returns
    ``(bf16 counts, f32 counts)``."""
    import signal

    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.utils.checkpoint import latest_step

    d = HEADLINE["d"]
    probe = torch.zeros(8, d, device="cuda")
    print(f"scoring core of the CLI's headline runs: f32 data in f32 "
          f"compute {K.scoring_core(probe, torch.float32, probe)}, in bf16 "
          f"compute {K.scoring_core(probe, torch.bfloat16, probe.bfloat16())}"
          " (ROADMAP B6)")
    base = ["train", "--config", "imagenet", "--model", "lloyd",
            "--max-iter", str(CLI_ITERS), "--tol", "-1"]
    f32, bf16 = {}, {}
    t_cli = time.perf_counter()

    d1, tel, trace, out = (f"{tmp}/d1", f"{tmp}/run.jsonl",
                           f"{tmp}/trace.json", f"{tmp}/board.json")
    d2 = f"{tmp}/d2"
    runs = {}

    def sigterm(run, line, proc):
        if line.startswith('{"event": "iter"') and \
                json.loads(line)["iteration"] >= DRILL_AT:
            proc.send_signal(signal.SIGTERM)
            return True
        return False

    def f32_chain():
        runs["run1"] = _CliRun(tmp, "cli f32 runner", base + [
            "--dtype", "float32", "--progress", "--checkpoint", d1,
            "--checkpoint-every", str(CLI_CHECKPOINT_EVERY), "--telemetry",
            tel, "--trace", trace, "--out", out]).need()
        runs["drill"] = _CliRun(tmp, "cli drill", base + [
            "--dtype", "float32", "--progress", "--checkpoint", d2],
            on_line=sigterm).need(3)
        # The drill's checkpoint step, read before the resume, which keeps
        # saving into the same directory.
        step = runs["step"] = latest_step(d2)
        _check(step is not None and DRILL_AT <= step < CLI_ITERS,
               f"cli drill: checkpoint at {step}")
        runs["resumed"] = _CliRun(tmp, "cli resume", base[:-4] + [
            "--max-iter", str(CLI_ITERS - step), "--tol", "-1", "--dtype",
            "float32", "--resume", d2]).need()

    def other_chain():
        runs["run3"] = _CliRun(tmp, "cli bf16 runner", base + [
            "--dtype", "bfloat16", "--progress"]).need()
        runs["fused"] = _CliRun(tmp, "cli fused", [
            "train", "--config", "imagenet", "--model", "lloyd",
            "--max-iter", "20", "--tol", "-1"]).need()
        runs["mb"] = _CliRun(tmp, "cli cifar10",
                             ["train", "--config", "cifar10"]).need()

    # The two chains at once (each run's per-iteration times are its
    # process's beside the other chain's, not the card's alone).
    _at_once(f32_chain, other_chain)
    run1, drill, resumed = runs["run1"], runs["drill"], runs["resumed"]
    run3, fused, mb = runs["run3"], runs["fused"], runs["mb"]

    _add_counts(f32, run1.counts)
    events = [json.loads(ln) for ln in open(tel, encoding="utf-8")]
    iters = [e for e in events if e["event"] == "iter"]
    _check(events[0]["event"] == "run_start"
           and events[-1]["event"] == "run_done"
           and [e["iteration"] for e in iters] == list(range(1, CLI_ITERS + 1))
           and all(e["device"] == "cuda" for e in iters),
           f"cli f32 runner: telemetry {[e['event'] for e in events][:4]}")
    doc = json.loads(open(trace, encoding="utf-8").read())
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    names = [e["name"] for e in spans]
    saves = CLI_ITERS // CLI_CHECKPOINT_EVERY
    _check(names.count("lloyd.run") == 1
           and names.count("iteration") == CLI_ITERS
           and names.count("checkpoint_save") == saves,
           f"cli f32 runner: trace spans lloyd.run "
           f"{names.count('lloyd.run')}, iteration "
           f"{names.count('iteration')}, checkpoint_save "
           f"{names.count('checkpoint_save')}")
    board = json.loads(open(out, encoding="utf-8").read())
    _check(sorted(board) == ["cards", "centroids", "meta"]
           and len(board["cards"]) == 500 and latest_step(d1) == CLI_ITERS,
           "cli f32 runner: the export or the last checkpoint is wrong")
    _check(run1.counts["lloyd_pass_cuda"] == 4
           and run1.counts["lloyd_delta_cuda"] == CLI_ITERS - 3,
           f"cli f32 runner: launches {run1.counts}")
    print(run1.line(f"; steady iteration {run1.iter_ms():.3f} ms; "
                    f"{len(iters)} iter events, {len(spans)} spans "
                    f"({saves} checkpoint_save), {len(board['cards'])} "
                    "cards exported"))

    _add_counts(f32, drill.counts)
    step = runs["step"]
    _check(f"resume with: --resume {d2}" in drill.err
           and any(f"at iteration {step};" in ln for ln in drill.err),
           f"cli drill: no resumable exit at the signal: {drill.err[-3:]}")
    _add_counts(f32, resumed.counts)
    rel = abs(resumed.result["inertia"] - run1.result["inertia"]) / \
        run1.result["inertia"]
    _check(resumed.result["n_iter"] == CLI_ITERS and rel <= FIT_INERTIA_RTOL,
           f"cli resume: n_iter {resumed.result['n_iter']}, inertia rel "
           f"{rel:.3e} against the uninterrupted run")
    print(drill.line(f"; SIGTERM at iteration >= {DRILL_AT}, checkpoint at "
                     f"step {step}, {drill.exit_s:.3f} s from the signal to "
                     "the exit"))
    print(resumed.line(f"; resumed at {step}, finished at iteration "
                       f"{resumed.result['n_iter']}, inertia rel {rel:.3e} "
                       "against the uninterrupted run"))

    _add_counts(bf16, run3.counts)
    print(run3.line(f"; steady iteration {run3.iter_ms():.3f} ms on "
                    f"score_block (f32 run: {run1.iter_ms():.3f} ms on the "
                    "f32 route)"))

    _add_counts(f32, fused.counts)
    _check(fused.counts["lloyd_pass_cuda"] >= 2
           and fused.counts["lloyd_delta_cuda"] >= 1
           and fused.counts["lloyd_hamerly_cuda"] >= 1,
           f"cli fused: the adaptive loop launched {fused.counts}")
    print(fused.line(" (the adaptive update='auto' loop, f32)"))

    _add_counts(f32, mb.counts)
    _check(mb.result["mode"] == "minibatch" and mb.result["n_iter"] == 200
           and mb.counts["lloyd_pass_cuda"] >= 1,
           f"cli cifar10: {mb.result}, launches {mb.counts}")
    print(mb.line(" (minibatch, f32)"))
    print(f"cli runs: {time.perf_counter() - t_cli:.1f} s (the f32 runner, "
          "drill and resume beside the bf16, fused and cifar10 runs)")
    return bf16, f32


def phase_runner(card, codebook_c):
    """Phase 12: the step-paced runner in process (headline delta, yinyang
    and Anderson; ``codebook`` delta) and ``cli train`` in subprocesses.
    Returns ``{"bf16": counts, "f32": counts}``."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    bf16 = _runner_headline(card)
    torch.cuda.empty_cache()
    _add_counts(bf16, _runner_codebook(card, codebook_c))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        cli_bf16, f32 = _cli_runs(card, tmp)
    _add_counts(bf16, cli_bf16)
    print(f"runner and cli phase: {time.perf_counter() - t_phase:.1f} s; "
          f"launches bf16 {bf16}, f32 {f32}")
    return {"bf16": bf16, "f32": f32}


# ---------------------------------------------------------------------------
# Phase 13: the board and the trimmed family
# ---------------------------------------------------------------------------

TRIM_FRACTION = 0.05
#: m at the headline: TRIM_FRACTION of its rows.
TRIM_M = 64_000
TRIM_ITERS = 20
#: trimmed-codebook: the depth is cut to 2 iterations and the final view.
TRIM_CODEBOOK_ITERS = 2
TRIM_CODEBOOK_M = TRIM_M
BOARD_MUTATORS = 16
BOARD_SUBSCRIBERS = 32
BOARD_SECONDS = 3.0
#: Seconds the board server may take to answer /healthz after its spawn.
BOARD_BOOT_S = 120.0
#: The assign model of the board server's stop drill: k rows of width d.
BOARD_MODEL = dict(k=8, d=16)


def _trim_split(x, labels, min_d2, m, k):
    """CUDA-event ms of the trim's parts at one sweep's output: the
    selection (the stable sort of the (n,) keys), the gather of the m rows,
    the fold of those rows on K6, and the whole correction."""
    from kmeans_tpu_torch.models.trimmed import trim_select, trim_subtract
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    vals, idx = trim_select(min_d2, None, m)
    xg = x[idx]
    lt = labels[idx]
    select_ms = _time_ms(lambda: trim_select(min_d2, None, m), 5)
    gather_ms = _time_ms(lambda: x[idx], 5)
    fold_ms = _time_ms(lambda: K.tiled_fold_cuda(xg, None, lt, None, k), 5)
    whole_ms = _time_ms(lambda: trim_subtract(x, labels, idx, None, vals, k,
                                              backend="cuda"), 5)
    return select_ms, gather_ms, fold_ms, whole_ms


def _trimmed_headline(card):
    """trimmed-headline: ``fit_trimmed(trim_fraction=0.05)`` on phase 4's
    bf16 data and c0 for TRIM_ITERS iterations (K1 only), held to K1 at the
    final centroids and to the same fit on the plain backend.  Returns its
    launch counts."""
    import numpy as np
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init
    from kmeans_tpu_torch.models.trimmed import resolve_n_trim
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    bf16 = torch.bfloat16
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=bf16)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(1), x, k)
    m = resolve_n_trim(n, trim_fraction=TRIM_FRACTION, n_trim=None)
    _check(m == TRIM_M, f"trimmed-headline: m = {m}, not {TRIM_M}")
    cfg = kt.KMeansConfig(k=k, compute_dtype="bfloat16")

    def fit(config=cfg, iters=TRIM_ITERS):
        return kt.fit_trimmed(x, k, trim_fraction=TRIM_FRACTION,
                              config=config, init=c0, max_iter=iters,
                              tol=-1.0)

    fit(iters=1)                  # the warm-up: library, sort, gather
    _sync()
    t0 = time.perf_counter()
    state, counts = _counted_run(fit)
    wall = time.perf_counter() - t0
    _check(counts["lloyd_pass_cuda"] == TRIM_ITERS + 1
           and counts["tiled_fold_cuda"] == TRIM_ITERS + 1
           and sum(counts.values()) == 2 * (TRIM_ITERS + 1),
           f"trimmed-headline: launches {counts}, wanted K1 and K6 "
           f"{TRIM_ITERS + 1} times each (a sweep and the correction's "
           "fold an iteration and in the final view)")
    c = state.centroids
    lab1, mind1 = K.lloyd_pass_cuda(x, c, compute_dtype=bf16,
                                    with_update=False)[:2]
    mind_np = mind1.cpu().numpy()
    want_mask = np.zeros(n, bool)
    want_mask[np.argsort(-mind_np, kind="stable")[:m]] = True
    mask = state.outlier_mask.cpu().numpy()
    labels = state.labels
    _check(bool((mask == want_mask).all()),
           f"trimmed-headline: {int((mask != want_mask).sum())} rows of the "
           "mask differ from K1's min_d2 ranked with the lowest-index "
           "tie-break")
    _check(bool(((labels == -1).cpu().numpy() == mask).all())
           and bool((labels[~state.outlier_mask] ==
                     lab1[~state.outlier_mask]).all()),
           "trimmed-headline: the labels are not -1 exactly on the mask "
           "and K1's elsewhere")
    total = float(state.counts.double().sum())
    _check(total == n - m,
           f"trimmed-headline: counts sum to {total}, not n - m = {n - m}")
    want_inertia = float(mind1.double()[~state.outlier_mask].sum())
    rel_i = abs(float(state.inertia) - want_inertia) / want_inertia
    _check(rel_i <= SUMS_RTOL,
           f"trimmed-headline: inertia {float(state.inertia)} against the "
           f"inliers' summed min_d2 {want_inertia} (rel {rel_i:.3e})")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plain, plain_counts = _counted_run(lambda: fit(
        kt.KMeansConfig(k=k, compute_dtype="bfloat16", backend="plain")))
    plain_s = time.perf_counter() - t0
    _check(sum(plain_counts.values()) == 0,
           f"trimmed-headline plain: launched {plain_counts}")
    rel = abs(float(state.inertia) - float(plain.inertia)) / float(
        plain.inertia)
    _check(rel <= FIT_INERTIA_RTOL,
           f"trimmed-headline: final inertia {float(state.inertia)} against "
           f"the plain backend's {float(plain.inertia)} (rel {rel:.3e})")
    del plain
    k1_ms = _time_ms(lambda: K.lloyd_pass_cuda(x, c, compute_dtype=bf16), 5)
    select_ms, gather_ms, fold_ms, whole_ms = _trim_split(
        x, lab1, mind1, m, k)
    it_ms = 1e3 * wall / (TRIM_ITERS + 1)
    print(f"trimmed-headline ({card}): fit_trimmed(trim_fraction="
          f"{TRIM_FRACTION}, m={m}) n={n} d={d} k={k} bf16, {TRIM_ITERS} "
          f"iterations + final view in {wall:.3f} s = {it_ms:.3f} ms an "
          f"iteration against K1 alone {k1_ms:.3f} ms at the final "
          f"centroids; the trim {whole_ms:.3f} ms (selection, a stable sort "
          f"of {n} keys, {select_ms:.3f}; gather of {m} x {d} bf16 rows "
          f"{gather_ms:.3f}; fold on K6 {fold_ms:.3f}); launches {counts}")
    print(f"  held: the mask is K1's min_d2 ranked with the lowest-index "
          f"tie-break; labels -1 exactly there and K1's elsewhere; counts "
          f"sum to n - m = {n - m}; inertia against the inliers' min_d2 rel "
          f"{rel_i:.3e} (<= {SUMS_RTOL}); against the plain backend's fit "
          f"({plain_s:.3f} s) rel {rel:.3e} (<= {FIT_INERTIA_RTOL})")
    return counts


def _trimmed_codebook(card):
    """trimmed-codebook: phase 6's data and c0 (k = 65536), n_trim =
    TRIM_CODEBOOK_M, TRIM_CODEBOOK_ITERS iterations and the final view (the
    depth cut); K5 and K6 only; labels against K5's at the final
    centroids, ties apart.  Returns its launch counts."""
    import numpy as np
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.plan import shape_plan

    n, d, k = CODEBOOK["n"], CODEBOOK["d"], CODEBOOK["k"]
    bf16 = torch.bfloat16
    x, _, _ = kt.make_blobs(11, n, d, k, dtype=bf16)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(2), x, k)
    cfg = kt.KMeansConfig(k=k, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    state, counts = _counted_run(lambda: kt.fit_trimmed(
        x, k, n_trim=TRIM_CODEBOOK_M, config=cfg, init=c0,
        max_iter=TRIM_CODEBOOK_ITERS, tol=-1.0))
    wall = time.perf_counter() - t0
    sweeps = TRIM_CODEBOOK_ITERS + 1
    _check(counts["tiled_argmin_cuda"] == sweeps
           and counts["tiled_fold_cuda"] == 2 * sweeps
           and sum(counts.values()) == 3 * sweeps,
           f"trimmed-codebook: launches {counts}, wanted K5 and K6 only "
           "(K6 also for each iteration's correction)")
    c = state.centroids
    k_tile = shape_plan("classic", x, k, compute_dtype=bf16).k_tile
    lab5, min5 = K.tiled_argmin_cuda(x, *K._score_operands(c, bf16),
                                     k_tile=k_tile)
    # The inliers' labels against K5's (an outlier's -1 stands in as K5's).
    got = torch.where(state.outlier_mask, lab5, state.labels)
    moved = _check_labels_rows("trimmed-codebook", x, c, bf16, got, lab5)
    mind_np = min5.cpu().numpy()
    want_mask = np.zeros(n, bool)
    want_mask[np.argsort(-mind_np, kind="stable")[:TRIM_CODEBOOK_M]] = True
    _check(bool((state.outlier_mask.cpu().numpy() == want_mask).all()),
           "trimmed-codebook: the mask is not K5's min_d2's top m")
    _check(float(state.counts.double().sum()) == n - TRIM_CODEBOOK_M,
           "trimmed-codebook: counts do not sum to n - m")
    print(f"trimmed-codebook ({card}): fit_trimmed(n_trim="
          f"{TRIM_CODEBOOK_M}) n={n} d={d} k={k} bf16 (k_tile {k_tile}), "
          f"{TRIM_CODEBOOK_ITERS} iterations + final view (depth cut) in "
          f"{wall:.3f} s = {1e3 * wall / sweeps:.3f} ms an iteration; "
          f"labels against K5's at the final centroids: {moved} differ, "
          f"each a tie within {SCORE_RTOL}; the mask is K5's top m; "
          f"launches {counts}")
    return counts


def _trimmed_cli(card, tmp):
    """trimmed-cli: ``cli train --config imagenet --model trimmed`` in a
    child process (f32 data, the core's f32 route).  Returns its launch
    counts."""
    out = f"{tmp}/trimmed.json"
    run = _CliRun(tmp, "cli trimmed", [
        "train", "--config", "imagenet", "--model", "trimmed",
        "--trim-fraction", str(TRIM_FRACTION), "--max-iter",
        str(TRIM_ITERS), "--tol", "-1", "--out", out]).need()
    res = run.result
    board = json.loads(open(out, encoding="utf-8").read())
    unassigned = [c for c in board["cards"] if c["assignedTo"] is None]
    _check(res["mode"] == "trimmed" and res["n_iter"] == TRIM_ITERS
           and res["n"] == HEADLINE["n"] and math.isfinite(res["inertia"])
           and len(board["cards"]) == 500
           and all(f"pos:{c['id']}" not in board["meta"]
                   for c in unassigned),
           f"cli trimmed: result {res}, {len(unassigned)} unassigned")
    _check(run.counts["lloyd_pass_cuda"] == TRIM_ITERS + 1
           and run.counts["tiled_fold_cuda"] == TRIM_ITERS + 1
           and sum(run.counts.values()) == 2 * (TRIM_ITERS + 1),
           f"cli trimmed: launches {run.counts}")
    print(run.line(f"; the export: {len(board['cards'])} cards, "
                   f"{len(unassigned)} unassigned (outliers), "
                   f"{len(board['centroids'])} zones (f32, the f32 route)"))
    return run.counts


def _board_cli(spec) -> int:
    """``chip_smoke.py --board-cli SPEC``: ``kmeans_tpu_torch.cli.main(
    spec["argv"])`` (``cli serve``) in this process, its launch counts
    written to ``spec["counts"]`` every 0.1 s and at its exit (a kill -9
    leaves the last write), and its server's ``stop()`` seconds and
    ``drain_unanswered`` to ``spec["stop"]``."""
    import os
    import threading

    from kmeans_tpu_torch import cli
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.serve import server

    def dump():
        tmp = f"{spec['counts']}.{threading.get_ident()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(K.launch_counts(), f)
        os.replace(tmp, spec["counts"])

    done = threading.Event()

    def loop():
        while not done.wait(0.1):
            dump()

    stop = server.KMeansServer.stop

    def timed_stop(self):
        t0 = time.perf_counter()
        stop(self)
        with open(spec["stop"], "w", encoding="utf-8") as f:
            json.dump({"stop_s": time.perf_counter() - t0,
                       "drain_unanswered": self.drain_unanswered}, f)

    server.KMeansServer.stop = timed_stop
    K.reset_launch_counts()
    dumper = threading.Thread(target=loop, daemon=True)
    dumper.start()
    try:
        return cli.main(spec["argv"])
    finally:
        done.set()
        dumper.join()
        dump()


class _BoardServer:
    """``cli serve`` in a process of its own (``--board-cli``)."""

    def __init__(self, tmp, name, argv, port):
        self.name = name
        self.base = f"http://127.0.0.1:{port}"
        self.spec = {"argv": argv, "counts": f"{tmp}/{name}.counts.json",
                     "stop": f"{tmp}/{name}.stop.json"}
        self.err_path = f"{tmp}/{name}.stderr"
        self.boot_s = None
        self._t0 = time.perf_counter()
        with open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, __file__, "--board-cli",
                 json.dumps(self.spec)], stdout=subprocess.DEVNULL,
                stderr=err)

    def ready(self):
        """Wait for ``/healthz``; ``boot_s`` is the spawn to its first
        200."""
        deadline = time.monotonic() + BOARD_BOOT_S
        while self.boot_s is None:
            _check(self.proc.poll() is None,
                   f"{self.name}: exited {self.proc.poll()}: "
                   f"{open(self.err_path).read()[-2000:]}")
            try:
                if _http_get(self.base, "/healthz")[0] == 200:
                    self.boot_s = time.perf_counter() - self._t0
                    break
            except OSError:
                pass
            _check(time.monotonic() < deadline, f"{self.name}: no /healthz")
            time.sleep(0.05)
        return self

    def counts(self):
        with open(self.spec["counts"], encoding="utf-8") as f:
            return json.load(f)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def _sse_open(base, room, last_event_id=None):
    """A raw-socket SSE subscription: ``(socket, buffer)`` past the
    headers."""
    import socket

    host, port = base.replace("http://", "").split(":")
    sock = socket.create_connection((host, int(port)), timeout=HTTP_CALL_S)
    extra = ("" if last_event_id is None
             else f"Last-Event-ID: {last_event_id}\r\n")
    sock.sendall(f"GET /api/events?room={room} HTTP/1.1\r\nHost: {host}\r\n"
                 f"{extra}\r\n".encode())
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        _check(bool(chunk), f"SSE {room}: closed before its headers")
        buf += chunk
    return sock, buf.split(b"\r\n\r\n", 1)[1]


def _sse_events(sock, buf, until):
    """Read ``(id, event)`` pairs until ``until(event)``; returns them and
    the rest of the buffer."""
    out = []
    while True:
        while b"\n\n" not in buf:
            chunk = sock.recv(65536)
            _check(bool(chunk), "SSE stream closed early")
            buf += chunk
        frame, buf = buf.split(b"\n\n", 1)
        lines = frame.decode().split("\n")
        data = [ln[6:] for ln in lines if ln.startswith("data: ")]
        if not data:
            continue
        ids = [int(ln[4:]) for ln in lines if ln.startswith("id: ")]
        ev = json.loads(data[0])
        out.append((ids[0] if ids else None, ev))
        if until(ev):
            return out, buf


def _board_mutate(base, room, op, args=None):
    st, body = _http_get(base, f"/api/mutate?room={room}",
                         json.dumps({"op": op, "args": args or {}}).encode())
    return st, json.loads(body)


def _board_state(base, room):
    st, body = _http_get(base, f"/api/state?room={room}")
    _check(st == 200, f"/api/state?room={room} answered {st}")
    return json.loads(body)


def _board_train(base, room, args):
    """A train op with a subscriber attached: ``(wall s, the train events,
    train_done)``; a train_error fails the run."""
    sock, buf = _sse_open(base, room)
    try:
        _sse_events(sock, buf, lambda e: e["type"] == "hello")
        t0 = time.perf_counter()
        st, out = _board_mutate(base, room, "train", args)
        _check(st == 200 and out.get("started"), f"train {args}: {st} {out}")
        evs, _ = _sse_events(sock, buf, lambda e: e["type"] in (
            "train_done", "train_error"))
        wall = time.perf_counter() - t0
    finally:
        sock.close()
    done = evs[-1][1]
    _check(done["type"] == "train_done", f"train {args}: {done}")
    return wall, [e for _, e in evs if e["type"] == "train"], done


def _board_ops(card, base):
    """The fixture, autoAssign with and without outliers, and the train op
    (lloyd with live centroids, the request cap merged to the board, the
    trimmed family)."""
    fix = "FIX"
    t0 = time.perf_counter()
    _check(_board_mutate(base, fix, "populate")[0] == 200, "populate")
    for name in ("A", "B", "C"):
        _check(_board_mutate(base, fix, "addCentroid", {"name": name})[0]
               == 200, "addCentroid")
    st, out = _board_mutate(base, fix, "autoAssign", {"seed": 0})
    _check(st == 200, f"autoAssign: {st} {out}")
    plain = _board_state(base, fix)
    _check(plain["unassigned"] == 0,
           f"autoAssign left {plain['unassigned']} cards unassigned")
    st, out = _board_mutate(base, fix, "autoAssign",
                            {"seed": 0, "outliers": 2})
    _check(st == 200, f"autoAssign outliers=2: {st} {out}")
    trimmed = _board_state(base, fix)
    left = sorted(c["id"] for c in trimmed["cards"]
                  if c["assignedTo"] is None)
    _check(len(left) == 2, f"autoAssign outliers=2 left {left} unassigned")
    auto_s = time.perf_counter() - t0
    print(f"board autoAssign ({card}): the fixture (12 cards, 3 zones) "
          f"assigned in full, then outliers=2 left {left} unassigned (the "
          f"designated outliers are seed:t10 and seed:t11: "
          f"{'both' if left == ['seed:t10', 'seed:t11'] else 'not both'} "
          f"of them); {auto_s:.3f} s for the ops and both fits")

    wall, iters, done = _board_train(base, "TRN", {
        "n": 100_000, "d": 2, "k": 3, "max_iter": 30})
    inert = [e["inertia"] for e in iters]
    _check([e["iteration"] for e in iters] == list(range(1, done["n_iter"]
                                                         + 1))
           and all(len(e["centroids"]) == 3 and all(
               0.0 <= v <= 1.0 for p in e["centroids"] for v in p)
               for e in iters)
           and all(b <= a * (1 + 1e-6) for a, b in zip(inert, inert[1:])),
           f"train lloyd: {len(iters)} events for {done['n_iter']} "
           "iterations, or live centroids out of [0, 1], or a rising "
           "inertia")
    board = _board_state(base, "TRN")
    _check(len(board["cards"]) == 2000 and len(board["centroids"]) == 3
           and board["unassigned"] == 0, "train lloyd: the board")
    print(f"board train lloyd ({card}): n=100000 d=2 k=3, {done['n_iter']} "
          f"iterations, {len(iters)} SSE train events each with 3 live "
          f"centroids in [0, 1], inertia non-increasing "
          f"{inert[0]:.6e} -> {inert[-1]:.6e}; {wall:.3f} s from the request "
          "to train_done; the board: 2000 cards, 3 zones")

    wall, iters, done = _board_train(base, "CAP", {
        "n": 100_000, "d": 80, "k": 100, "max_iter": 30})
    board = _board_state(base, "CAP")
    _check(done["k"] == 100 and 1 <= len(board["centroids"]) <= 3
           and len(board["cards"]) == 2000,
           f"train at the cap: {done}, {len(board['centroids'])} zones")
    print(f"board train at the request cap ({card}): n=100000 d=80 k=100 "
          f"lloyd, {done['n_iter']} iterations, k={done['k']} merged "
          f"to {len(board['centroids'])} zones; {wall:.3f} s")

    wall, iters, done = _board_train(base, "TRM", {
        "n": 100_000, "d": 2, "k": 3, "max_iter": 30, "model": "trimmed"})
    board = _board_state(base, "TRM")
    _check(0 < board["unassigned"] < 2000 and len(board["centroids"]) == 3,
           f"train trimmed: {board['unassigned']} unassigned")
    print(f"board train trimmed ({card}): n=100000 d=2 k=3, "
          f"{done['n_iter']} iterations, {board['unassigned']} of the 2000 "
          f"board cards unassigned (5% trimmed); {wall:.3f} s")


def _board_load(card, base):
    """BOARD_MUTATORS clients adding cards and BOARD_SUBSCRIBERS SSE
    subscribers in one room for BOARD_SECONDS: mutations/s, the delay from
    a mutate's response to each subscriber's change event (the version of
    the i-th card added is the room's version before the run plus i), the
    events each subscriber missed (a full queue drops) and the 503s."""
    import http.client
    import threading

    room = "LOAD"
    v0 = _board_state(base, room)["version"]
    host, port = base.replace("http://", "").split(":")
    stop = threading.Event()
    responses, errors = {}, []
    seen = [dict() for _ in range(BOARD_SUBSCRIBERS)]
    socks = []
    for _ in range(BOARD_SUBSCRIBERS):
        sock, buf = _sse_open(base, room)
        _sse_events(sock, buf, lambda e: e["type"] == "hello")
        socks.append((sock, buf))

    def subscriber(i):
        sock, buf = socks[i]
        sock.settimeout(0.2)
        while True:
            while b"\n\n" not in buf:
                try:
                    chunk = sock.recv(65536)
                except OSError:
                    if stop.is_set():
                        return
                    continue
                if not chunk:
                    return
                buf += chunk
            frame, buf = buf.split(b"\n\n", 1)
            now = time.perf_counter()
            for ln in frame.decode().split("\n"):
                if ln.startswith("data: "):
                    ev = json.loads(ln[6:])
                    if ev.get("type") == "change":
                        seen[i][ev["version"]] = now

    def mutator(j):
        conn = http.client.HTTPConnection(host, int(port),
                                          timeout=HTTP_CALL_S)
        i = 0
        try:
            while not stop.is_set():
                title = f"m{j}-{i}"
                conn.request("POST", f"/api/mutate?room={room}",
                             json.dumps({"op": "addCard",
                                         "args": {"title": title}}),
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                r.read()
                now = time.perf_counter()
                if r.status != 200:
                    errors.append(r.status)
                responses[title] = now
                i += 1
        finally:
            conn.close()

    readers = [threading.Thread(target=subscriber, args=(i,), daemon=True)
               for i in range(BOARD_SUBSCRIBERS)]
    writers = [threading.Thread(target=mutator, args=(j,), daemon=True)
               for j in range(BOARD_MUTATORS)]
    for t in readers + writers:
        t.start()
    t0 = time.perf_counter()
    time.sleep(BOARD_SECONDS)
    stop.set()
    for t in writers:
        t.join(HTTP_CALL_S)
    wall = time.perf_counter() - t0
    time.sleep(0.5)               # the last events reach the subscribers
    for t in readers:
        t.join(HTTP_CALL_S)
    for sock, _ in socks:
        sock.close()
    state = _board_state(base, room)
    added = [c["title"] for c in state["cards"]
             if c["title"] in responses]
    # One more change: its write lets the server see the closed streams.
    _board_mutate(base, room, "setMode", {"mode": "playtest"})
    deadline = time.monotonic() + HTTP_CALL_S
    while _board_state(base, room)["peers"] > 0:
        _check(time.monotonic() < deadline, "board load: streams linger")
        time.sleep(0.05)
    _check(len(added) == len(responses) and not errors,
           f"board load: {len(errors)} errors ({sorted(set(errors))}), "
           f"{len(added)} cards for {len(responses)} responses")
    _check(state["version"] == v0 + len(added),
           "board load: the version is not one a mutation")
    delays, missed = [], 0
    for got in seen:
        for i, title in enumerate(added):
            t_ev = got.get(v0 + 1 + i)
            if t_ev is None:
                missed += 1
            else:
                delays.append(t_ev - responses[title])
    p50, p99, _ = _percentiles(delays)
    print(f"board load ({card}): {BOARD_MUTATORS} mutating clients "
          f"(keep-alive, addCard) and {BOARD_SUBSCRIBERS} SSE subscribers "
          f"in one room for {wall:.3f} s: {len(added)} mutations = "
          f"{len(added) / wall:.1f} mutations/s, 0 errors (no 503); the "
          f"change event reached each subscriber p50 {p50:.3f} ms / "
          f"p99 {p99:.3f} ms after the mutate's response (negative: "
          f"before it), {len(delays)} deliveries, {missed} missed (a "
          f"subscriber queue full)")
    return len(added) / wall


def _board_stop_drill(card, srv, model_c, trace_dir):
    """SIGINT with SSE subscribers attached and assign clients running:
    the stop time, drain_unanswered and the clients' answers.  Each
    request carries its own ``X-Trace-Id``: a request the client saw reset
    must be on no span of the server's spool (the server never read it:
    the listener's close, or the interrupt between an accept and its
    handler), and every answered one on one."""
    import http.client
    import signal
    import threading

    import numpy as np

    subs = []
    for _ in range(4):
        sock, buf = _sse_open(srv.base, "STOP")
        _sse_events(sock, buf, lambda e: e["type"] == "hello")
        subs.append(sock)
    host, port = srv.base.replace("http://", "").split(":")
    rng = np.random.default_rng(0)
    pts = (model_c[rng.integers(0, len(model_c), 64)]
           + 0.01 * rng.normal(size=(64, model_c.shape[1]))).astype(
        np.float32)
    body = json.dumps({"points": pts.tolist()})
    want = np.argmin(((pts[:, None, :] - model_c[None]) ** 2).sum(-1), 1)
    tally = {"ok": 0, "wrong": 0, "503": 0, "other": 0, "refused": 0,
             "reset": 0, "timeout": 0}
    ids = {key: [] for key in tally}
    failed = {}               # trace id -> (exception, wall start, end)
    lock = threading.Lock()
    stopped = threading.Event()
    seq = iter(range(1 << 40))

    def client():
        while not stopped.is_set():
            with lock:
                tid = f"b0a2d{next(seq):011x}"
            # A connect the exiting server never completes fails in 5 s.
            conn = http.client.HTTPConnection(host, int(port), timeout=5)
            t_start = time.time()
            try:
                conn.request("POST", "/api/assign", body,
                             {"Content-Type": "application/json",
                              "X-Trace-Id": tid})
                r = conn.getresponse()
                out = r.read()
                key = ("ok" if r.status == 200 else "503" if r.status == 503
                       else "other")
                if key == "ok" and json.loads(out)["labels"] != \
                        want.tolist():
                    key = "wrong"
            except ConnectionRefusedError:
                key = "refused"
            except (ConnectionResetError, http.client.RemoteDisconnected,
                    BrokenPipeError) as e:
                key = "reset"
                failed[tid] = (repr(e), t_start, time.time())
            except TimeoutError as e:
                key = "timeout"
                failed[tid] = (repr(e), t_start, time.time())
            finally:
                conn.close()
            with lock:
                tally[key] += 1
                ids[key].append(tid)
            if key in ("refused", "reset", "timeout"):
                time.sleep(0.01)

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    t0 = time.perf_counter()
    t_signal = time.time()
    srv.proc.send_signal(signal.SIGINT)
    rc = srv.proc.wait(timeout=60)
    exit_s = time.perf_counter() - t0
    time.sleep(0.2)
    stopped.set()
    for t in threads:
        t.join(60)
    closed = 0
    for sock in subs:
        sock.settimeout(5.0)
        try:
            while sock.recv(65536):
                pass
            closed += 1
        except OSError:
            pass
        sock.close()
    rec = json.load(open(srv.spec["stop"], encoding="utf-8"))
    from kmeans_tpu_torch.obs.fleetview import read_spool_events

    spans = {e["args"].get("trace_id"): e
             for evs in read_spool_events(trace_dir).values() for e in evs
             if e.get("name") == "POST /api/assign"}
    served = set(spans)
    lost = sorted(set(ids["reset"] + ids["refused"] + ids["timeout"])
                  & served)
    detail = [(tid, failed.get(tid), round(failed[tid][1] - t_signal, 4)
               if tid in failed else None, spans[tid]["ts"] / 1e6
               - t_signal, spans[tid]["dur"]) for tid in lost]
    drain_s = 5.0                  # ServeConfig.fleet_drain_s
    _check(rc == 0 and rec["drain_unanswered"] == 0
           and rec["stop_s"] < drain_s / 2 and closed == len(subs)
           and tally["503"] == 0 and tally["other"] == 0
           and tally["wrong"] == 0 and tally["ok"] > 0
           and set(ids["ok"]) <= served and not lost,
           f"board stop: exit {rc}, {rec}, {closed} streams closed, "
           f"clients {tally}, failed requests the server served (id, "
           f"error, start and span start after the signal in s, span "
           f"µs): {detail}, answered ids on no span: "
           f"{len(set(ids['ok']) - served)}")
    print(f"board stop ({card}): SIGINT with {len(subs)} SSE subscribers "
          f"and 4 assign clients attached: stop() {rec['stop_s']:.3f} s "
          f"(fleet_drain_s {drain_s}), exit code {rc} {exit_s:.3f} s after "
          f"the signal, {rec['drain_unanswered']} accepted requests "
          f"unanswered, every stream closed; the clients: {tally['ok']} "
          f"answered with the right labels, 0 503, {tally['refused']} "
          f"refused after the close, {tally['reset']} reset and "
          f"{tally['timeout']} timed out connecting, each before the "
          f"server read it (its trace id on no span); no request the "
          f"server read was lost")


def _board_spawn(tmp):
    """Publish the stop drill's assign model and spawn board-http's first
    server (``cli serve --persist-dir D --port P``), not waiting for it:
    it boots while trimmed-cli runs.  Returns ``(server, argv, port,
    model centroids, trace directory)``."""
    import numpy as np

    from kmeans_tpu_torch.continuous.registry import ModelRegistry

    rooms, model_dir, trace_dir = (f"{tmp}/rooms", f"{tmp}/model",
                                   f"{tmp}/trace")
    rng = np.random.default_rng(7)
    model_c = (rng.normal(size=(BOARD_MODEL["k"], BOARD_MODEL["d"])) * 10
               ).astype(np.float32)
    ModelRegistry(path=model_dir).publish(model_c)
    port = _free_port()
    argv = ["serve", "--persist-dir", rooms, "--port", str(port),
            "--model-dir", model_dir, "--trace-dir", trace_dir]
    return (_BoardServer(tmp, "board-a", argv, port), argv, port, model_c,
            trace_dir)


def _board_http(card, tmp, spawned):
    """board-http: the server of :func:`_board_spawn` on the card: the
    ops and the train op, the load, kill -9 and the revival, the
    Last-Event-ID replay, the stop drill.  Returns the launch counts of
    both server processes."""
    a, argv, port, model_c, trace_dir = spawned
    t_phase = time.perf_counter()
    try:
        a.ready()
        print(f"board server ({card}): cli serve --persist-dir up "
              f"{a.boot_s:.3f} s after its spawn (process, CUDA context, "
              f"library load; it booted while trimmed-cli ran)")
        _board_ops(card, a.base)
        _board_load(card, a.base)
        before = {room: _board_state(a.base, room)
                  for room in ("FIX", "TRN", "CAP", "TRM", "LOAD")}
        # Past the debounce of the last mutation: every room is on disk.
        time.sleep(0.5 + 1.0)
        counts_a = a.counts()
    finally:
        a.kill()
    t0 = time.perf_counter()
    b = _BoardServer(tmp, "board-b", argv, port)
    try:
        b.ready()
        for room, want in before.items():
            got = _board_state(b.base, room)
            got.pop("version")
            want.pop("version")
            _check(got == want, f"board revival: /api/state?room={room} "
                   "differs from before the kill")
        print(f"board kill -9 ({card}): the restarted server answered in "
              f"{time.perf_counter() - t0:.3f} s and served the 5 rooms' "
              "/api/state as before the kill (the document version counts "
              "anew in the new process)")
        sock, buf = _sse_open(b.base, "RPLY")
        _sse_events(sock, buf, lambda e: e["type"] == "hello")
        st, out = _board_mutate(b.base, "RPLY", "train", {
            "n": 100_000, "d": 2, "k": 30, "max_iter": 30})
        _check(st == 200, f"train for the replay: {st} {out}")
        first, _ = _sse_events(sock, buf, lambda e: e["type"] == "train"
                               and e["iteration"] >= 2)
        last_id = first[-1][0]
        sock.close()
        time.sleep(0.5)
        sock, buf = _sse_open(b.base, "RPLY", last_event_id=last_id)
        rest, _ = _sse_events(sock, buf, lambda e: e["type"] in (
            "train_done", "train_error"))
        sock.close()
        ids = [i for i, _ in rest if i is not None]
        its = [e["iteration"] for _, e in first + rest
               if e["type"] == "train"]
        done = rest[-1][1]
        _check(done["type"] == "train_done"
               and ids == list(range(last_id + 1, last_id + 1 + len(ids)))
               and its == list(range(1, done["n_iter"] + 1)),
               f"Last-Event-ID replay: ids {ids[:5]}.., iterations {its}")
        print(f"board Last-Event-ID ({card}): a subscriber dropped after "
              f"event {last_id} (iteration 2) and reconnected 0.5 s later "
              f"with Last-Event-ID: {len(ids)} events replayed in order, "
              f"every iteration 1..{done['n_iter']} and train_done received")
        _board_stop_drill(card, b, model_c, trace_dir)
        counts_b = b.counts()
    finally:
        b.kill()
    counts = {}
    _add_counts(counts, counts_a)
    _add_counts(counts, counts_b)
    _check(counts["lloyd_pass_cuda"] > 0 and counts["lloyd_delta_cuda"] > 0,
           f"board: the server processes launched {counts}")
    print(f"board-http: {time.perf_counter() - t_phase:.1f} s; launches "
          f"(both server processes; f32 data, score_block at these widths) "
          f"{counts}")
    return counts


def _k6_f32_row(launches):
    """The kernels-line row of K6 folding f32 rows, the trimmed fit's
    correction on f32 data (TRIM_M rows of the headline's width into k =
    1000): time beside its plain version, its byte bound and
    ``index_add_``, with ``launches`` from trimmed-cli's run (f32 data at
    the headline, m = TRIM_M)."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    m, d, k = TRIM_M, HEADLINE["d"], HEADLINE["k"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    xt = torch.randn(m, d, generator=gen, device="cuda")
    lt = torch.randint(0, k, (m,), generator=gen, device="cuda",
                       dtype=torch.int32)
    sums, counts = K.tiled_fold_cuda(xt, None, lt, None, k)
    want_s, want_c = K.tiled_fold_plain(xt, None, lt, None, k)
    err = _close("K6 f32 (trimmed correction) against its plain version",
                 sums, want_s)
    _check(bool(torch.equal(counts, want_c)), "K6 f32: counts differ")
    ms = _time_ms(lambda: K.tiled_fold_cuda(xt, None, lt, None, k), 10)
    plain_ms = _time_ms(lambda: K.tiled_fold_plain(xt, None, lt, None, k), 3)
    lab64 = lt.long()

    def library():
        return (torch.zeros(k, d, device="cuda").index_add_(0, lab64, xt),
                torch.zeros(k, device="cuda").index_add_(
                    0, lab64, torch.ones(m, device="cuda")))

    library_ms = _time_ms(library, 10)
    moved = m * d * 4 + m * 4 + k * d * 4 + k * 4
    return _kernel_row("tiled_fold_cuda", launches, ms, plain_ms, library_ms,
                       err, moved, 0.0, m * d, what="f32, trimmed correction")


def phase_board(card):
    """Phase 13: trimmed-headline, trimmed-codebook and trimmed-cli, then
    board-http.  Returns ``({"bf16": counts, "f32": counts}, rows)``: the
    in-process trimmed runs compute in bf16; the CLI's trimmed run (the f32
    route) and the board server's fits (f32 compute on ``score_block``) in
    f32.  The CLI's K6 launches (the correction's fold of f32 rows) make a
    row of their own (:func:`_k6_f32_row`); the board server's K5 and K6
    launches, at shapes no row times, are printed and on no row."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    bf16, f32 = {}, {}
    _add_counts(bf16, _trimmed_headline(card))
    torch.cuda.empty_cache()
    _add_counts(bf16, _trimmed_codebook(card))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_board_") as tmp:
        spawned = _board_spawn(tmp)
        try:
            cli_counts = _trimmed_cli(card, tmp)
            board = _board_http(card, tmp, spawned)
        finally:
            spawned[0].kill()
    # On no row: the board server's K5 launches serve the stop drill's
    # assign model, and its K6 launches fold the train op's trimmed fits
    # at d = 2, k = 3, a shape the f32 K6 row does not time.
    apart = ("tiled_argmin_cuda", "tiled_fold_cuda")
    _add_counts(f32, {n: v for n, v in cli_counts.items()
                      if n != "tiled_fold_cuda"})
    _add_counts(f32, {n: v for n, v in board.items() if n not in apart})
    rows = [_k6_f32_row(cli_counts["tiled_fold_cuda"])]
    print(f"board phase: {time.perf_counter() - t_phase:.1f} s; launches "
          f"bf16 {bf16}, f32 {f32}; on no row, the board server's K5 "
          f"launches (the stop drill's d={BOARD_MODEL['d']} model) "
          f"{board.get('tiled_argmin_cuda', 0)} and K6 launches (the "
          f"train op's trimmed fits, d=2 k=3) "
          f"{board.get('tiled_fold_cuda', 0)}")
    return {"bf16": bf16, "f32": f32}, rows


# ---------------------------------------------------------------------------
# Phase 14: out-of-core streaming and continuous clustering
# ---------------------------------------------------------------------------

#: imagenet-stream: the headline's rows on the host (README's
#: ``fit_minibatch_stream(data, 1000, steps=500, batch_size=8192)``).
#: Depth cut (PR 19): 200 steps, 500 before; the drill at step 100, 250
#: before.
STREAM_STEPS = 200
STREAM_BATCH = 8192
#: The most card memory a streamed fit may add above what the process held
#: before it: the prefetch queue and its copies in flight (at most
#: ``prefetch_depth + 2`` batches of 64 MiB in f32), the centroids and the
#: update's temporaries (about 130 MiB), and a final-pass chunk (8192 rows)
#: with K1's scratch.  About a twentieth of the 10.5 GB the fit streams.
STREAM_PEAK_BYTES = 512 << 20
#: cifar10-stream-cli: SIGTERM once the telemetry reports this step.
STREAM_DRILL_AT = 100
#: imagenet-continuous: the reference's defaults but for these.
#: The reference's default drift (6.0) is sized for its default d = 8: at d
#: = 2048 it moves the per-point inertia by 36 over a noise floor of about
#: 737 (2048 · 0.6²), under the detectors' thresholds; 64 moves it by 4096.
#: Depth cut (PR 19): 24 batches with the drift at batch 12, 48 and 24
#: before.  Fewer would end the run before its first scheduled refit
#: (``--refit-every`` 10 batches after the drift's refits), which the
#: phase checks for.
CONT_BATCHES = 24
CONT_DRIFT_AT = 12
CONT_ARGV = ["continuous", "--k", "1000", "--d", "2048", "--batch-n", "8192",
             "--batches", str(CONT_BATCHES), "--drift-at", str(CONT_DRIFT_AT),
             "--drift", "64"]
#: Keep-alive clients and points a request of the continuous -> serve run.
CONT_CLIENTS = 8
CONT_POOL = 4096
#: The longest a child process of this phase may take.
CONT_TIMEOUT_S = 300
#: A resumed run's final generation against the undisturbed run's: its
#: centroids within this rtol and atol, the reference's own
#: ``test_pipeline_resume_replays_identically``.  Two undisturbed runs (the
#: serve run is the second) must give every generation bit for bit, and
#: the schedule (generations, triggers, batches) must be exact.
CONT_RESUME_TOL = 1e-5


def _stream_fit_run(name, x_np, c0, cd, transfer):
    """One imagenet-stream fit on the card, counted and timed: the fit
    (its steps' wall time: the first step's start to the card's idle after
    the last; the final pass's seconds and K1 launches), the card's peak
    memory above its level before, the native gathers and the producer's
    stalls.  Returns ``(state, info)``."""
    import torch

    from kmeans_tpu_torch.config import KMeansConfig
    from kmeans_tpu_torch.data import stream as DS
    from kmeans_tpu_torch.models import minibatch as MB
    from kmeans_tpu_torch.models import streaming as S
    from kmeans_tpu_torch.native import loader as NL
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    k = c0.shape[0]
    cfg = KMeansConfig(k=k, steps=STREAM_STEPS, batch_size=STREAM_BATCH,
                       compute_dtype=cd, seed=0)
    marks = {}
    real_update, real_assign = MB.batch_update, S.assign_stream

    def update(*a, **kw):
        marks.setdefault("t_first", time.perf_counter())
        return real_update(*a, **kw)

    def final_pass(*a, **kw):
        _sync()                       # the steps' device work ends here
        marks["t_steps"] = time.perf_counter()
        before = K.launch_counts()
        out = real_assign(*a, **kw)
        marks["final_s"] = time.perf_counter() - marks["t_steps"]
        after = K.launch_counts()
        marks["final_k1"] = (after["lloyd_pass_cuda"]
                             - before["lloyd_pass_cuda"])
        return out

    _sync()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stalls0 = DS._PREFETCH_STALLS_TOTAL.value()
    NL.reset_gather_counts()
    K.reset_launch_counts()
    MB.batch_update, S.assign_stream = update, final_pass
    try:
        t0 = time.perf_counter()
        state = S.fit_minibatch_stream(
            x_np, k, config=cfg, init=c0, transfer_dtype=transfer,
            device="cuda")
        _sync()
        wall = time.perf_counter() - t0
    finally:
        MB.batch_update, S.assign_stream = real_update, real_assign
    counts = K.launch_counts()
    gathers = NL.gather_counts()
    peak = torch.cuda.max_memory_allocated() - base
    info = {"name": name, "counts": counts, "gathers": gathers,
            "peak": peak, "wall": wall,
            "steps_s": marks["t_steps"] - marks["t_first"],
            "final_s": marks["final_s"], "final_k1": marks["final_k1"],
            "stalls": DS._PREFETCH_STALLS_TOTAL.value() - stalls0}
    _check(gathers == {"native": STREAM_STEPS, "numpy": 0},
           f"{name}: gathers {gathers}: every batch must take the native "
           "gather")
    _check(int(state.n_iter) == STREAM_STEPS and set(counts) and
           counts["lloyd_pass_cuda"] == marks["final_k1"] > 0
           and sum(counts.values()) == counts["lloyd_pass_cuda"],
           f"{name}: n_iter {int(state.n_iter)}, launches {counts} (K1 in "
           f"the final pass: {marks['final_k1']})")
    _check(peak < STREAM_PEAK_BYTES,
           f"{name}: the card's peak rose {peak} bytes, beyond the bound "
           f"{STREAM_PEAK_BYTES}")
    return state, info


def _stream_replay(x_np, c0, cd, to_bf16):
    """The fit's batches again, one at a time with a sync each: the native
    gather into a pinned buffer (host clock), its copy to the card and
    ``batch_update`` on the card-resident batch (CUDA events).  Returns
    ``(centroids, n_seen, median gather ms, median copy ms, median update
    ms, summed update ms)``."""
    import torch

    from kmeans_tpu_torch.data.stream import PinnedRing, sample_batches
    from kmeans_tpu_torch.models.minibatch import batch_update

    n, d = x_np.shape
    k = c0.shape[0]
    ring = PinnedRing(1, STREAM_BATCH, d,
                      torch.bfloat16 if to_bf16 else torch.float32)
    c = torch.from_numpy(c0).cuda()
    n_seen = torch.zeros(k, dtype=torch.float32, device="cuda")
    batches = sample_batches(x_np, STREAM_BATCH, STREAM_STEPS, seed=0,
                             to_bf16=to_bf16, ring=ring)
    g_ms, c_ms, u_ms = [], [], []
    for _ in range(STREAM_STEPS):
        t0 = time.perf_counter()
        buf = next(batches)
        g_ms.append(1e3 * (time.perf_counter() - t0))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        xb = buf.to("cuda", non_blocking=True)
        ev[1].record()
        ring.copied(ev[1])
        c, n_seen, _, _ = batch_update(c, n_seen, xb, compute_dtype=cd)
        ev[2].record()
        ev[2].synchronize()
        c_ms.append(ev[0].elapsed_time(ev[1]))
        u_ms.append(ev[1].elapsed_time(ev[2]))
    med = statistics.median
    return c, n_seen, med(g_ms), med(c_ms), med(u_ms), sum(u_ms)


def _imagenet_stream(card):
    """imagenet-stream: the headline's 1.28M x 2048 f32 rows in host
    memory, 500 steps of 8192 from a fixed init, in f32 (full-width
    transfer) and in bf16 compute (bf16 transfer, fused in the gather).
    Returns ``{"bf16": counts, "f32": counts}``."""
    import numpy as np
    import torch

    from kmeans_tpu_torch.data.synthetic import make_blobs
    from kmeans_tpu_torch.models import streaming as S
    from kmeans_tpu_torch.native import native_available
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    _check(native_available(), "imagenet-stream: the native gather does "
           "not build on this host")
    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    t0 = time.perf_counter()
    x_t = make_blobs(14, n, d, k, device="cuda")[0]
    x_np = x_t.cpu().numpy()
    del x_t
    torch.cuda.empty_cache()
    print(f"imagenet-stream: {n} x {d} f32 rows ({x_np.nbytes / 1e9:.2f} GB)"
          f" made on the card and copied to host memory in "
          f"{time.perf_counter() - t0:.1f} s")
    c0 = np.ascontiguousarray(x_np[::n // k][:k])
    probe = torch.zeros(8, d, device="cuda")
    launches = {"bf16": {}, "f32": {}}
    for cd, transfer, key in ((None, None, "f32"),
                              ("bfloat16", "auto", "bf16")):
        name = f"imagenet-stream {key}"
        core = K.scoring_core(
            probe, torch.float32 if cd is None else torch.bfloat16,
            probe if cd is None else probe.bfloat16())
        state, info = _stream_fit_run(name, x_np, c0, cd, transfer)
        _add_counts(launches[key], info["counts"])
        to_bf16 = transfer == "auto"
        c_r, n_r, g_ms, cp_ms, u_ms, u_sum = _stream_replay(
            x_np, c0, cd, to_bf16)
        _check(torch.equal(c_r, state.centroids),
               f"{name}: the streamed centroids differ from the replay on "
               f"card-resident batches (max abs "
               f"{float((c_r - state.centroids).abs().max())})")
        t1 = time.perf_counter()
        lab_p, inertia_p = S.assign_stream(
            x_np, state.centroids, chunk_size=8192, compute_dtype=cd,
            backend="plain", device="cuda")
        plain_s = time.perf_counter() - t1
        lab = state.labels.cpu()
        lab_pt = torch.from_numpy(lab_p)
        rows = (lab != lab_pt).nonzero()[:, 0]
        moved = 0
        if rows.numel():
            xs = torch.from_numpy(x_np[rows.numpy()]).cuda()
            moved = _check_labels_rows(
                f"{name} final pass", xs, state.centroids,
                torch.float32 if cd is None else torch.bfloat16,
                lab[rows].cuda(), lab_pt[rows].cuda())
        rel = abs(float(state.inertia) - inertia_p) / inertia_p
        _check(rel <= SUMS_RTOL,
               f"{name}: final-pass inertia {float(state.inertia)} against "
               f"the plain backend's {inertia_p} (rel {rel:.3e})")
        steps_per_s = STREAM_STEPS / info["steps_s"]
        idle = 1.0 - (u_sum / 1e3) / info["steps_s"]
        print(f"{name} ({card}): {STREAM_STEPS} steps of {STREAM_BATCH} in "
              f"{info['steps_s']:.3f} s = {steps_per_s:.1f} steps/s "
              f"(transfer {'bf16' if to_bf16 else 'f32'}); a step alone "
              f"(the replay, one sync a step): native gather {g_ms:.3f} ms "
              f"(host clock), copy to the card {cp_ms:.3f} ms and "
              f"batch_update {u_ms:.3f} ms (CUDA events); the SMs' idle "
              f"share over the streamed steps {idle:.3f} (1 - the replay's "
              f"summed batch_update time / the steps' wall time); producer "
              f"stalls {info['stalls']:.0f}; final pass {info['final_s']:.3f}"
              f" s with {info['final_k1']} K1 launches on {core} (plain "
              f"backend {plain_s:.3f} s), labels equal but {moved} rows "
              f"(ties), inertia rel {rel:.3e}; peak card memory +"
              f"{info['peak'] / 2**20:.1f} MiB (bound "
              f"{STREAM_PEAK_BYTES / 2**20:.0f} MiB); gathers "
              f"{info['gathers']}; fit wall {info['wall']:.3f} s; centroids "
              "equal to the replay's bit for bit")
        del state
        torch.cuda.empty_cache()
    return launches


def _cifar10_stream_cli(card, tmp):
    """cifar10-stream-cli: a cifar10-shaped f32 ``.npy`` streamed by ``cli
    train --stream`` in child processes: the uninterrupted run, the
    SIGTERM drill and its resume, whose centroids must equal the
    uninterrupted run's bit for bit.  Returns the f32 launch counts."""
    import threading

    import numpy as np
    import torch

    from kmeans_tpu_torch.data.synthetic import make_blobs
    from kmeans_tpu_torch.utils.checkpoint import (latest_step,
                                                   load_array_checkpoint)

    n, d, k = CIFAR10["n"], CIFAR10["d"], CIFAR10["k"]
    path = f"{tmp}/cifar10.npy"
    np.save(path, make_blobs(15, n, d, k, device="cuda")[0].cpu().numpy())
    torch.cuda.empty_cache()
    base = ["train", "--stream", "--input", path, "--k", str(k), "--steps",
            str(STREAM_STEPS), "--batch-size", str(STREAM_BATCH)]
    d0, d1 = f"{tmp}/s0", f"{tmp}/s1"
    runs = {}

    def go(key, *args, **kw):
        runs[key] = _CliRun(tmp, *args, **kw)

    def sigterm(run, line, proc):
        import signal

        if not line.startswith("{"):
            return False
        try:
            ev = json.loads(line)
        except ValueError:
            return False
        if ev.get("event") == "iter" and ev["iteration"] >= STREAM_DRILL_AT:
            proc.send_signal(signal.SIGTERM)
            return True
        return False

    threads = [
        threading.Thread(target=go, args=(
            "full", "stream cli", base + ["--checkpoint", d0]),
            kwargs={"gathers": f"{tmp}/full.gathers.json"}),
        threading.Thread(target=go, args=(
            "drill", "stream cli drill",
            base + ["--checkpoint", d1, "--telemetry", "/dev/stderr"]),
            kwargs={"on_line": sigterm,
                    "gathers": f"{tmp}/drill.gathers.json"}),
    ]
    t_all = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    full = runs["full"].need()
    drill = runs["drill"].need(3)
    res = full.result
    _check(res["mode"] == "minibatch" and res.get("stream") is True
           and res["n_iter"] == STREAM_STEPS and res["n"] == n
           and full.counts["lloyd_pass_cuda"] >= 1
           and full.gathers["numpy"] == 0
           and full.gathers["native"] == STREAM_STEPS,
           f"stream cli: {res}, launches {full.counts}, gathers "
           f"{full.gathers}")
    step = latest_step(d1)
    _check(f"resume with: --resume {d1}" in drill.err and step is not None
           and any(f"at step {step}/{STREAM_STEPS}" in ln
                   for ln in drill.err)
           and STREAM_DRILL_AT <= step < STREAM_STEPS,
           f"stream cli drill: no resumable exit at the signal: "
           f"{drill.err[-3:]}")
    resumed = _CliRun(tmp, "stream cli resume", base + ["--resume", d1],
                      gathers=f"{tmp}/resume.gathers.json").need()
    a0, _ = load_array_checkpoint(d0)
    a1, _ = load_array_checkpoint(d1)
    _check(resumed.result["n_iter"] == STREAM_STEPS
           and np.array_equal(a0["centroids"], a1["centroids"])
           and np.array_equal(a0["counts"], a1["counts"])
           and resumed.result["inertia"] == res["inertia"]
           and resumed.gathers["native"] == STREAM_STEPS - step,
           f"stream cli resume: n_iter {resumed.result['n_iter']}, "
           f"centroids max abs diff "
           f"{float(np.abs(a0['centroids'] - a1['centroids']).max())}, "
           f"inertia {resumed.result['inertia']} vs {res['inertia']}, "
           f"gathers {resumed.gathers}")
    f32 = {}
    for run in (full, drill, resumed):
        _add_counts(f32, run.counts)
    print(full.line(f"; native gathers {full.gathers['native']}"))
    print(drill.line(f"; SIGTERM at step >= {STREAM_DRILL_AT}, checkpoint "
                     f"at step {step}, {drill.exit_s:.3f} s from the signal "
                     "to the exit"))
    print(resumed.line(f"; resumed at {step}, centroids and counts equal "
                       "to the uninterrupted run's bit for bit, inertia "
                       "equal"))
    print(f"cifar10-stream-cli ({card}): {time.perf_counter() - t_all:.1f} s"
          " (the uninterrupted run and the drill at once, then the resume; "
          "beside imagenet-continuous)")
    return f32


def _continuous_cli(spec) -> int:
    """``chip_smoke.py --continuous-cli SPEC``: ``python -m
    kmeans_tpu_torch.cli`` with ``spec["argv"]`` as :func:`_train_cli`
    runs it, the pipeline's pieces timed on the host clock (synthesis,
    batch inertia, push with any compaction, refit with its publish),
    written to ``spec["counts"]`` with the launch counts after it (a
    killed run writes nothing), and each published generation's centroids,
    as the registry holds them, to ``<counts>.gen<G>.npy`` at its
    publish."""
    import runpy

    import numpy as np

    from kmeans_tpu_torch.continuous import pipeline as P
    from kmeans_tpu_torch.continuous import registry as R
    from kmeans_tpu_torch.continuous import window as W
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    split = {"synthesis": 0.0, "inertia": 0.0, "push": 0.0, "refit": 0.0}
    refits = []
    windows = []

    def timed(cls, attr, key):
        fn = getattr(cls, attr)

        def wrapper(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **kw)
            finally:
                dt = time.perf_counter() - t0
                split[key] += dt
                if key == "refit":
                    refits.append([a[0], dt])
                if key == "push":
                    windows.append([self.n_points, self.compactions])

        setattr(cls, attr, wrapper)

    publish = R.ModelRegistry.publish

    def published(self, *a, **kw):
        gen = publish(self, *a, **kw)
        np.save(f"{spec['counts']}.gen{gen.generation}.npy", gen.centroids)
        return gen

    R.ModelRegistry.publish = published
    timed(P.ContinuousPipeline, "_next_batch", "synthesis")
    timed(P.ContinuousPipeline, "_batch_inertia", "inertia")
    timed(W.SlidingWindow, "push", "push")
    timed(P.ContinuousPipeline, "_refit", "refit")
    K.reset_launch_counts()
    sys.argv = ["kmeans_tpu_torch.cli"] + spec["argv"]
    try:
        runpy.run_module("kmeans_tpu_torch.cli", run_name="__main__",
                         alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    finally:
        with open(spec["counts"], "w", encoding="utf-8") as f:
            json.dump({"launches": K.launch_counts(), "split": split,
                       "refits": refits, "windows": windows}, f)
    return rc


class _ContRun:
    """One ``cli continuous`` process (:func:`_continuous_cli`) on its own
    thread: its stdout's JSON lines as they come (``on_line`` sees each),
    its exit code, the times of its exit and of its ``resumed`` line, and
    what it wrote at exit."""

    def __init__(self, tmp, name, argv, env=None, on_line=None,
                 model_dir=None):
        import os
        import threading

        self.name, self.lines, self.rc = name, [], None
        #: {generation: centroids}, read from ``model_dir`` as each
        #: ``generation`` line arrives (and the generation a ``resumed``
        #: line names).
        self.model_dir, self.centroids = model_dir, {}
        self.t_exit = self.t_resumed = None
        self._counts = f"{tmp}/{name}.json"
        self._err = f"{tmp}/{name}.err"
        full_env = dict(os.environ, **(env or {}))
        root = os.path.dirname(os.path.abspath(__file__))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--continuous-cli",
             json.dumps({"argv": argv, "counts": self._counts})],
            cwd=root, env=full_env, stdout=subprocess.PIPE,
            stderr=open(self._err, "w", encoding="utf-8"), text=True)
        self._on_line = on_line
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if ev.get("event") == "resumed":
                self.t_resumed = time.perf_counter()
            if self.model_dir and ev.get("event") in ("resumed",
                                                       "generation"):
                g = ev["generation"]
                self.centroids[g] = _gen_centroids(self.model_dir, g)
            self.lines.append(ev)
            if self._on_line is not None:
                self._on_line(ev)
        self.rc = self.proc.wait()
        self.t_exit = time.perf_counter()

    def wait(self, rc=0):
        import threading

        watchdog = threading.Timer(CONT_TIMEOUT_S, self.proc.kill)
        watchdog.start()
        try:
            self._thread.join()
        finally:
            watchdog.cancel()
        err = open(self._err, encoding="utf-8").read()
        _check(self.rc == rc, f"{self.name}: exit code {self.rc} (wanted "
               f"{rc}); stderr tail {err[-1500:]!r}")
        self.seconds = self.t_exit - self.t0
        self.data = (json.load(open(self._counts, encoding="utf-8"))
                     if rc == 0 else None)
        import glob

        import numpy as np

        #: {generation: centroids} as this process published them.
        self.published = {
            int(p.rsplit(".gen", 1)[1][:-4]): np.load(p)
            for p in glob.glob(f"{glob.escape(self._counts)}.gen*.npy")}
        return self

    def gens(self):
        return [(e["generation"], e["trigger"], e["batch"])
                for e in self.lines if e["event"] == "generation"]

    def done(self):
        (d,) = [e for e in self.lines if e["event"] == "done"]
        return d


def _gen_centroids(model_dir, g):
    """Generation ``g``'s centroids, from ``model_dir`` or its step-tagged
    sibling (a later publish may be renaming one into the other)."""
    import numpy as np

    for _ in range(100):
        for src in (model_dir, f"{model_dir}.step-{g:08d}"):
            try:
                with open(f"{src}/meta.json", encoding="utf-8") as f:
                    if int(json.load(f)["step"]) != g:
                        continue
                with np.load(f"{src}/arrays.npz") as z:
                    return z["centroids"]
            except (OSError, ValueError, KeyError):
                continue
        time.sleep(0.02)
    raise SmokeFailure(f"generation {g} never appeared in {model_dir}")


def _cont_inertia(c_np, x_eval):
    """Inertia of ``x_eval`` at centroids ``c_np`` (on the card, f64 sums
    of K1's min_d2)."""
    import torch

    from kmeans_tpu_torch.ops.distance import assign

    _, mind = assign(x_eval, torch.from_numpy(c_np).cuda(), device="cuda")
    return float(mind.double().sum())


def _cont_serve(card, tmp, pool_np):
    """The continuous -> serve composition: ``cli serve --model-dir D``
    beside a second continuous run on D (retention kept for every
    generation), CONT_CLIENTS keep-alive binary clients, ``POST
    /api/model/reload`` after each generation line; every response held
    to K5's labels of its generation, no 503, no drop."""
    import os
    import signal

    import numpy as np
    import torch

    from kmeans_tpu_torch.serve.assign import dense_k_tile

    model_dir = f"{tmp}/serve_model"
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    pool_path = f"{tmp}/cont_pool.npy"
    np.save(pool_path, pool_np)
    reloads, first = [], []
    state = {"server": None}

    def on_gen(ev):
        if ev["event"] != "generation":
            return
        if state["server"] is None:
            first.append(ev)
            return
        st, body = _http_get(base, "/api/model/reload", b"{}")
        reloads.append((ev["generation"], st, json.loads(body)))

    cont = _ContRun(tmp, "continuous serve run",
                    CONT_ARGV + ["--model-dir", model_dir,
                                 "--checkpoint-keep", str(CONT_BATCHES)],
                    on_line=on_gen, model_dir=model_dir)
    deadline = time.monotonic() + CONT_TIMEOUT_S
    while not first:
        _check(time.monotonic() < deadline and cont.proc.poll() is None,
               "continuous serve run: no first generation")
        time.sleep(0.05)
    counts = f"{tmp}/serve.counts.json"
    srv_err_path = f"{tmp}/serve.err"
    srv = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-cli",
         json.dumps({"argv": ["serve", "--model-dir", model_dir, "--port",
                              str(port), "--persist-dir", ""],
                     "counts": counts})],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.DEVNULL,
        stderr=open(srv_err_path, "w", encoding="utf-8"))
    client = None
    try:
        while True:
            try:
                st, _ = _http_get(base, "/readyz")
                if st == 200:
                    break
            except OSError:
                pass
            _check(time.monotonic() < deadline and srv.poll() is None,
                   "continuous serve: the server never became ready")
            time.sleep(0.2)
        state["server"] = True
        until = f"{tmp}/cont_done"
        spec = {"host": "127.0.0.1", "port": port, "pool": pool_path,
                "out": f"{tmp}/cont_serve.npz", "points": HTTP_POINTS,
                "clients": CONT_CLIENTS, "seconds": 0.0,
                "swap_wait": CONT_TIMEOUT_S, "mode": "binary", "run": 14,
                "new_gen": None, "until_file": until}
        client = subprocess.Popen(
            [sys.executable, __file__, "--http-client", json.dumps(spec)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        _check(client.stdout.readline().strip() == "READY",
               "continuous serve: the client did not start")
        cont.wait()
        # One more reload after the run, so the last generation serves.
        st, body = _http_get(base, "/api/model/reload", b"{}")
        reloads.append((cont.done()["generation"], st, json.loads(body)))
        time.sleep(0.5)
        open(until, "w").close()
        _, cerr = client.communicate(timeout=4 * HTTP_CALL_S)
        _check(client.returncode == 0,
               f"continuous serve: the client failed: {cerr[-2000:]}")
    finally:
        for proc in (client, srv):
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGINT)
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    srv_err = open(srv_err_path, encoding="utf-8").read()
    _check(srv.returncode == 0, f"continuous serve: the server exited "
           f"{srv.returncode}: {srv_err[-1500:]}")
    data = dict(np.load(spec["out"]))
    table = data["table"]
    status = table[:, 1].astype(int)
    _check(not data["errors"].size and not int(data["hung"]) and len(table)
           and (status == 200).all(),
           f"continuous serve: {len(table)} responses, "
           f"{int((status != 200).sum())} not 200 "
           f"({int((status == 503).sum())} 503s), {data['errors'].size} "
           f"connection errors")
    _check(all(st == 200 for _, st, _ in reloads),
           f"continuous serve: reloads {reloads}")
    pool_t = torch.from_numpy(pool_np).cuda()
    k_tile = dense_k_tile(1000, pool_np.shape[1])
    idx = table[:, 0].astype(np.int64)[:, None] + np.arange(HTTP_POINTS)
    moved, gens = 0, sorted({int(v) for v in table[:, 2]})
    for g in gens:
        step_dir = f"{model_dir}.step-{g:08d}"
        src = step_dir if os.path.isdir(step_dir) else model_dir
        c_np = np.load(f"{src}/arrays.npz")["centroids"]
        meta = json.load(open(f"{src}/meta.json", encoding="utf-8"))
        _check(int(meta["step"]) == g,
               f"continuous serve: generation {g} is not on disk")
        c = torch.from_numpy(c_np).cuda()
        want = _pool_labels(pool_t, c, k_tile).cpu().numpy()
        sel = np.flatnonzero(table[:, 2] == g)
        mine = data["labels"][sel].ravel()
        exp = want[idx[sel]].ravel()
        diff = np.flatnonzero(mine != exp)
        if diff.size:
            rows = torch.from_numpy(idx[sel].ravel()[diff]).cuda()
            moved += _check_labels_rows(
                f"continuous serve generation {g}", pool_t[rows], c,
                torch.float32, torch.from_numpy(mine[diff]).cuda(),
                torch.from_numpy(exp[diff]).cuda())
    seconds = float(data["seconds"])
    lat = table[:, 3].tolist()
    p50, p99, top = _percentiles(lat)
    srv_counts = json.load(open(counts, encoding="utf-8"))
    print(f"continuous -> serve ({card}): {len(table)} responses in "
          f"{seconds:.3f} s ({len(table) / seconds:.1f} QPS, "
          f"{CONT_CLIENTS} keep-alive clients, {HTTP_POINTS} points each), "
          f"p50 {p50:.3f} ms, p99 {p99:.3f} ms, max {top:.3f} ms; "
          f"generations served {gens} (reloads {len(reloads)}), every "
          f"response held to K5 of its generation ({moved} rows differ, "
          f"each a tie), no 503 and no drop; the server's launches "
          f"{srv_counts}; the run's generations {cont.gens()}")
    return cont


def _imagenet_continuous(card, tmp):
    """imagenet-continuous: ``cli continuous`` at k = 1000, d = 2048, batch
    8192, CONT_BATCHES batches, a drift of 64 at batch CONT_DRIFT_AT, the
    reference's other defaults, in a child process; at once with it, the
    kill drills (a kill at the second refit's site and at the second
    publish's swap, each followed by ``--resume``) and the continuous ->
    serve composition.
    Returns the f32 launch counts."""
    import threading

    import numpy as np
    import torch

    from kmeans_tpu_torch.continuous import drift_batch

    t_all = time.perf_counter()
    runs = {}
    drills = (("refit", "continuous.refit:kill@2"),
              ("swap", "registry.swap:kill@2"))

    def drill(key, faults_spec):
        d = f"{tmp}/cont_{key}"
        killed = _ContRun(tmp, f"continuous kill {key}",
                          CONT_ARGV + ["--model-dir", d],
                          env={"KMEANS_TPU_FAULTS": faults_spec}).wait(137)
        resumed = _ContRun(tmp, f"continuous resume {key}",
                           CONT_ARGV + ["--model-dir", d, "--resume"],
                           model_dir=d)
        resumed.wait()
        runs[key] = (killed, resumed, d)

    rng = np.random.default_rng(5)
    pool = drift_batch(CONT_BATCHES - 1, n=CONT_POOL, d=2048, k=1000,
                       drift_at=CONT_DRIFT_AT, drift=64.0, seed=0)
    pool += 0.1 * rng.standard_normal(pool.shape, dtype=np.float32)

    def serve():
        runs["serve"] = _cont_serve(card, tmp, pool)

    full_dir = f"{tmp}/cont_full"
    full = _ContRun(tmp, "continuous", CONT_ARGV + ["--model-dir", full_dir],
                    model_dir=full_dir)
    threads = [threading.Thread(target=drill, args=a) for a in drills]
    threads.append(threading.Thread(target=serve))
    for t in threads:
        t.start()
    full.wait()
    for t in threads:
        t.join()
    _check(len(runs) == len(drills) + 1, "imagenet-continuous: a drill or "
           "the serve run failed (see its exit above)")
    replica = runs.pop("serve")
    gens = full.gens()
    triggers = [t for _, t, _ in gens]
    done = full.done()
    comps = full.data["windows"][-1][1] if full.data["windows"] else 0
    _check({"initial", "drift", "scheduled"} <= set(triggers) and comps >= 1
           and done["batches"] == CONT_BATCHES,
           f"imagenet-continuous: triggers {triggers}, compactions {comps},"
           f" done {done}")
    x_eval = torch.from_numpy(drift_batch(
        CONT_BATCHES - 1, n=8192, d=2048, k=1000, drift_at=CONT_DRIFT_AT,
        drift=64.0)).cuda()

    def rel(a, g):
        """Generation g's inertia on x_eval: run a's against the
        undisturbed run's, relative (as published; a resumed run's first
        generation as read from its model directory)."""
        want = _cont_inertia(full.published[g], x_eval)
        got = a.published.get(g, a.centroids[g])
        return abs(_cont_inertia(got, x_eval) - want) / want

    launches = dict(full.data["launches"])
    _check(replica.gens() == gens,
           f"continuous serve run: generations {replica.gens()}, the "
           f"undisturbed run's {gens}")
    differ = {g: float(np.abs(full.published[g].astype(np.float64)
                              - replica.published[g]).max())
              for g in sorted(full.published)
              if not np.array_equal(replica.published[g], full.published[g])}
    on_disk = {name: [g for g in sorted(run.centroids)
                      if not np.array_equal(run.centroids[g],
                                            run.published[g])]
               for name, run in (("undisturbed", full), ("serve", replica))}
    print(f"continuous runs: generations whose copy read from the model "
          f"directory at their line differs from the published one "
          f"{on_disk}", flush=True)
    _check(not differ and sorted(replica.published) == sorted(full.published),
           f"continuous serve run: generations (largest difference) "
           f"{differ} differ from the undisturbed run's")
    print(f"continuous serve run against the undisturbed run (two runs of "
          f"one stream): the same generations and triggers, the centroids "
          f"of all {len(full.published)} generations bit for bit")
    failed = []
    for key, (killed, resumed, d) in runs.items():
        res = [e for e in resumed.lines if e["event"] == "resumed"][0]
        rd = resumed.done()
        g0 = res["generation"]
        want = [g for g in gens if g[0] > g0]
        _check(rd["generation"] == done["generation"]
               and rd["batches"] == done["batches"]
               and resumed.gens() == want
               and set(killed.gens()) <= set(gens),
               f"continuous {key} drill: resumed at generation {g0}, done "
               f"{rd}, generations {resumed.gens()} (undisturbed {want})")
        rels = {g: rel(resumed, g) for g in sorted(resumed.centroids)}
        got_c = resumed.published[rd["generation"]]
        want_c = full.published[rd["generation"]]
        err = float(np.abs(got_c.astype(np.float64) - want_c).max())
        if not np.allclose(got_c, want_c, rtol=CONT_RESUME_TOL,
                           atol=CONT_RESUME_TOL):
            failed.append(key)
        rto = resumed.t_resumed - killed.t_exit
        _add_counts(launches, resumed.data["launches"])
        print(f"continuous {key} drill ({card}): killed at the second "
              f"{'refit' if key == 'refit' else 'publish'} (exit 137 after "
              f"{killed.seconds:.3f} s, generations {killed.gens()}); "
              f"resumed at generation {g0}, batch {res['batch_idx']}; RTO "
              f"{rto:.3f} s from the kill to the resumed line; ended at "
              f"generation {rd['generation']} after {rd['batches']} batches "
              f"as the undisturbed run; its final centroids' largest "
              f"difference from the undisturbed run's {err:.3e} (bit for "
              f"bit: {np.array_equal(got_c, want_c)}); inertia rel to the "
              f"undisturbed run by generation "
              f"{ {g: float(f'{r:.3e}') for g, r in rels.items()} }")
    _check(not failed, f"continuous drills {failed}: the final generation's "
           f"centroids are beyond rtol / atol {CONT_RESUME_TOL} of the "
           "undisturbed run's")
    sp = full.data["split"]
    by_trigger = {}
    for trig, sec in full.data["refits"]:
        by_trigger.setdefault(trig, []).append(round(sec, 3))
    rate = CONT_BATCHES / sum(sp.values())
    print(f"imagenet-continuous ({card}): {CONT_BATCHES} batches in "
          f"{full.seconds:.3f} s of process ({rate:.2f} batches/s over "
          f"the pipeline's own time, four pipelines, a server and "
          f"cifar10-stream-cli's processes at once); a batch's split: "
          f"synthesis "
          f"{1e3 * sp['synthesis'] / CONT_BATCHES:.1f} ms, batch inertia "
          f"{1e3 * sp['inertia'] / CONT_BATCHES:.1f} ms, push/compact "
          f"{1e3 * sp['push'] / CONT_BATCHES:.1f} ms, refit "
          f"{1e3 * sp['refit'] / CONT_BATCHES:.1f} ms; refit seconds by "
          f"trigger {by_trigger}; generations {gens}; compactions {comps}; "
          f"launches {full.data['launches']}")
    _add_counts(launches, replica.data["launches"])
    print(f"imagenet-continuous: {time.perf_counter() - t_all:.1f} s in all")
    return launches


def phase_stream(card):
    """Phase 14: imagenet-stream in process, then cifar10-stream-cli and
    imagenet-continuous at once, in child processes.  Returns ``{"bf16":
    counts, "f32": counts}``."""
    import tempfile
    import threading

    t_phase = time.perf_counter()
    launches = _imagenet_stream(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
        cli = {}

        def stream_cli():
            try:
                cli["counts"] = _cifar10_stream_cli(card, tmp)
            except BaseException as e:       # re-raised below
                cli["error"] = e

        t = threading.Thread(target=stream_cli)
        t.start()
        try:
            _add_counts(launches["f32"], _imagenet_continuous(card, tmp))
        finally:
            t.join()
        if "error" in cli:
            raise cli["error"]
        _add_counts(launches["f32"], cli["counts"])
    print(f"stream and continuous phase: {time.perf_counter() - t_phase:.1f}"
          f" s; launches bf16 {launches['bf16']}, f32 {launches['f32']}")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: the data-parallel engine
# ---------------------------------------------------------------------------

#: Sweeps of each imagenet-dp run: the delta refresh at sweep 16 runs.
MESH_SWEEPS = 20
#: codebook-dp2-gloo's depth cut: the refresh sweep and one delta sweep.
MESH_CODEBOOK_SWEEPS = 2
#: The update flavours and merges of imagenet-dp2-gloo.
MESH_UPDATES = ("matmul", "delta", "hamerly", "yinyang")
MESH_COMMS = ("allreduce", "scatter")
#: Seconds the two-rank world of phase 15 may take, data and fits included.
MESH_TIMEOUT_S = 600
#: train-mesh's small shape for ``--mesh 2 --device cpu`` on one card.
MESH_CLI_SMALL = ["--n", "4000", "--d", "16", "--k", "8"]


def _mesh_fit(mesh, x, k, c0, update, comm, sweeps):
    """One timed ``fit_lloyd_sharded`` on ``mesh``: the launch counts and
    the mesh's collective counters set to 0 just before it and read just
    after, each sweep split by host clock and CUDA events.  Returns
    ``(state, seconds, launches, stats, split)``."""
    import torch

    from kmeans_tpu_torch.config import KMeansConfig
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.parallel import fit_lloyd_sharded
    from kmeans_tpu_torch.parallel.engine import sweep_split

    cfg = KMeansConfig(k=k, update=update, comm=comm,
                       compute_dtype="bfloat16")
    mesh.barrier()
    _sync()
    K.reset_launch_counts()
    mesh.reset_stats()
    t0 = time.perf_counter()
    with sweep_split(mesh) as sp:
        state = fit_lloyd_sharded(x, k, mesh=mesh, config=cfg, init=c0,
                                  max_iter=sweeps, tol=-1.0)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (state, secs, K.launch_counts(),
            {op: list(v) for op, v in mesh.stats.items()}, sp.summary())


def _single_fit(x, k, c0, update, sweeps):
    """The single-device fit of ``update`` from ``c0``: ``(state, seconds,
    launches)``."""
    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    cfg = kt.KMeansConfig(k=k, update=update, compute_dtype="bfloat16")
    _sync()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state = kt.fit_lloyd(x, k, config=cfg, init=c0, max_iter=sweeps,
                         tol=-1.0)
    _sync()
    return state, time.perf_counter() - t0, K.launch_counts()


def _check_labels_pair(name, x, c_a, lab_a, c_b, lab_b, cd):
    """Two fits' final labels, each at its own centroids: they agree but on
    rows where each label is within SCORE_RTOL of its own run's f64
    minimum and the other run's label scores within SCORE_RTOL plus the
    two runs' centroid difference (the f64 change of those two scores from
    ``c_b`` to ``c_a``) of the minimum at ``c_a``: a tie to within the
    rounding by which the runs' centroids differ.  Returns ``(rows that
    differ, the largest such score change)``."""
    rows = (lab_a != lab_b).nonzero()[:, 0]
    worst = 0.0
    for part in rows.split(1024):
        if not part.numel():
            continue
        s_a, scale_a = _scores64(x[part], c_a, cd)
        s_b, scale_b = _scores64(x[part], c_b, cd)
        _near_min(name, s_a, scale_a, lab_a[part])
        _near_min(f"{name} (other run)", s_b, scale_b, lab_b[part])
        la = lab_a[part].long()[:, None]
        lb = lab_b[part].long()[:, None]
        drift = ((s_a.gather(1, la) - s_b.gather(1, la)).abs()
                 + (s_a.gather(1, lb) - s_b.gather(1, lb)).abs())[:, 0]
        gap = s_a.gather(1, lb)[:, 0] - s_a.min(dim=1).values
        tol = SCORE_RTOL * scale_a.gather(1, lb)[:, 0] + drift
        _check(bool((gap <= tol).all()),
               f"{name}: {int((gap > tol).sum())} rows labelled apart "
               "beyond a tie within the runs' centroid difference")
        worst = max(worst, float(drift.max()))
    return int(rows.numel()), worst


def _hold_to_single(name, x, got, want, cd, same_centroids=False):
    """A sharded fit against the single-device fit of its flavour from the
    same c0.  The trajectory: the same sweeps, each run's labels a
    near-tie argmin at its own centroids wherever they differ
    (:func:`_check_labels_pair`), the inertia within FIT_INERTIA_RTOL and,
    with ``same_centroids``, the centroids within SUMS_RTOL.  A sharded
    merge sums each cluster's rows in another order than one card's fold
    core, so two runs' centroids differ at f32 rounding from the first
    sweep on; a row that ties to within that rounding may then take the
    other label and move both its clusters' means by ≈ 1/count of a row,
    so only a run that sums in one place holds the centroids to SUMS_RTOL.
    The last sweep exactly: one card's classic pass at the sharded fit's
    final centroids gives its labels and counts bit for bit and its
    inertia within SUMS_RTOL.  Returns ``(rows moved, centroid error,
    relative inertia difference)``."""
    import kmeans_tpu_torch as kt

    _check(int(got.n_iter) == int(want.n_iter),
           f"{name}: {int(got.n_iter)} sweeps against {int(want.n_iter)}")
    _check(_finite(got.centroids) and math.isfinite(float(got.inertia)),
           f"{name}: non-finite result")
    moved, _ = _check_labels_pair(name, x, got.centroids, got.labels,
                                  want.centroids, want.labels, cd)
    err = float((got.centroids - want.centroids).abs().max())
    if same_centroids:
        _close(f"{name} centroids", got.centroids, want.centroids)
    rel = abs(float(got.inertia) - float(want.inertia)) / float(want.inertia)
    _check(rel <= FIT_INERTIA_RTOL,
           f"{name}: inertia {float(got.inertia)!r} against "
           f"{float(want.inertia)!r} (relative {rel:.3e})")
    labels, _, _, counts, inertia = kt.lloyd_pass(
        x, got.centroids, compute_dtype=cd, device=x.device)
    _check(_equal(labels, got.labels) and _equal(counts, got.counts),
           f"{name}: the final labels or counts are not one card's classic "
           "pass at the same centroids")
    _close(f"{name} final inertia", got.inertia, inertia)
    return moved, err, rel


def _equal(a, b):
    import torch

    return bool(torch.equal(a, b))


def _split_line(split):
    """Median milliseconds of each part of a run's sweeps: host clock and
    CUDA events."""
    parts = {}
    for sweep in split:
        for name, (host, dev) in sweep.items():
            parts.setdefault(name, []).append((host, dev))
    return ", ".join(
        f"{name} {statistics.median(h for h, _ in v):.3f} host / "
        f"{statistics.median(d for _, d in v):.3f} device ms"
        for name, v in parts.items())


def _gloo_probe(mesh):
    """The mesh's three collectives on card tensors over gloo, called as
    the engine calls them (no staging through the host): the sum, the
    reduce-scattered block and the rank-ordered gather must be right.
    Returns the torch and CUDA versions they ran on."""
    import torch

    t = torch.full((4, 3), float(mesh.rank + 1), device=mesh.device)
    want_sum = float(sum(range(1, mesh.size + 1)))
    _check(float(mesh.all_reduce(t.clone())[0, 0]) == want_sum,
           "gloo all_reduce on the card: wrong sum")
    got = mesh.reduce_scatter(torch.cat([t] * mesh.size))
    _check(got.is_cuda and tuple(got.shape) == (4, 3)
           and bool((got == want_sum).all()),
           "gloo reduce_scatter on the card: wrong block")
    got = mesh.all_gather(t[:1])
    _check(got.is_cuda and [float(v) for v in got[:, 0]]
           == [float(r + 1) for r in range(mesh.size)],
           "gloo all_gather on the card: wrong order")
    return f"torch {torch.__version__}, CUDA {torch.version.cuda}"


def _mesh_rank(spec) -> int:
    """``chip_smoke.py --mesh-rank SPEC``: one rank of phase 15's two-rank
    gloo world on the one card (``WORLD_SIZE`` / ``RANK`` / ``MASTER_*``
    from the parent).  Runs imagenet-dp2-gloo, codebook-dp2-gloo and
    cifar10-dp2-minibatch; rank 0 also runs the single-device fits and
    holds each sharded run to its counterpart.  Writes the rank's launches,
    times, collective counters and splits to ``spec["out"] % rank``."""
    import torch.distributed as dist

    from kmeans_tpu_torch.parallel import make_mesh

    mesh = make_mesh((2, 1), ("data", "model"),
                     devices=["cuda:0", "cuda:0"], backend="gloo")
    out = {"rank": mesh.rank, "runs": {}}
    try:
        out["probe"] = _gloo_probe(mesh)
        _mesh_rank_headline(mesh, out)
        _mesh_rank_codebook(mesh, out)
        _mesh_rank_minibatch(mesh, out)
    finally:
        with open(spec["out"] % mesh.rank, "w", encoding="utf-8") as f:
            json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _mesh_rank_headline(mesh, out):
    """imagenet-dp2-gloo on one rank."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    bf16 = torch.bfloat16
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=bf16)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(1), x, k)
    singles = {}
    if mesh.rank == 0:
        for update in MESH_UPDATES:
            singles[update] = _single_fit(x, k, c0, update, MESH_SWEEPS)
            st, secs, launches = singles[update]
            out["runs"][f"single {update}"] = {
                "seconds": secs, "launches": launches}
            print(f"imagenet-dp2-gloo: single-device {update} fit, "
                  f"{MESH_SWEEPS} sweeps + final view, {secs:.3f} s "
                  f"({1e3 * secs / MESH_SWEEPS:.3f} ms a sweep), inertia "
                  f"{float(st.inertia):.6e}, launches {launches}",
                  flush=True)
    # A warm-up: the rank's first call of each sweep function loads the
    # kernel library; its launches count on no row.
    for update in MESH_UPDATES:
        _mesh_fit(mesh, x, k, c0, update, "allreduce", 1)
    for update in MESH_UPDATES:
        for comm in MESH_COMMS:
            name = f"imagenet-dp2-gloo {update} {comm}"
            st, secs, launches, stats, split = _mesh_fit(
                mesh, x, k, c0, update, comm, MESH_SWEEPS)
            out["runs"][name] = {"seconds": secs, "launches": launches,
                                 "stats": stats, "split": split}
            need = {"matmul": "lloyd_pass_cuda", "delta": "lloyd_delta_cuda",
                    "hamerly": "lloyd_hamerly_cuda",
                    "yinyang": "lloyd_hamerly_cuda"}[update]
            _check(launches[need] >= 1 and launches["lloyd_pass_cuda"] >= 1,
                   f"{name}: rank {mesh.rank} launched {launches}")
            if mesh.rank == 0:
                moved, err, rel = _hold_to_single(name, x, st,
                                                  singles[update][0], bf16)
                print(f"{name}: {secs:.3f} s ({1e3 * secs / MESH_SWEEPS:.3f}"
                      f" ms a sweep, two ranks sharing the card's SMs, "
                      f"merges through gloo on the host: not a scaling "
                      f"number); against the single-device fit: {moved} "
                      f"labels moved (ties at each run's centroids), "
                      f"centroids max abs diff {err:.3e}, inertia rel "
                      f"{rel:.3e}; the final pass one card's at the same "
                      f"centroids; launches {launches}", flush=True)
    del x


def _mesh_rank_codebook(mesh, out):
    """codebook-dp2-gloo on one rank: K5 and K6 on each rank's rows."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init

    n, d, k = CODEBOOK["n"], CODEBOOK["d"], CODEBOOK["k"]
    bf16 = torch.bfloat16
    x, _, _ = kt.make_blobs(11, n, d, k, dtype=bf16)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(2), x, k)
    torch.cuda.reset_peak_memory_stats()
    single = None
    if mesh.rank == 0:
        single, secs, launches = _single_fit(x, k, c0, "delta",
                                             MESH_CODEBOOK_SWEEPS)
        out["runs"]["single codebook delta"] = {"seconds": secs,
                                                "launches": launches}
        print(f"codebook-dp2-gloo: single-device delta fit, "
              f"{MESH_CODEBOOK_SWEEPS} sweeps + final view, {secs:.3f} s, "
              f"launches {launches}", flush=True)
    states = {}
    for comm in MESH_COMMS:
        name = f"codebook-dp2-gloo delta {comm}"
        st, secs, launches, stats, split = _mesh_fit(
            mesh, x, k, c0, "delta", comm, MESH_CODEBOOK_SWEEPS)
        out["runs"][name] = {"seconds": secs, "launches": launches,
                             "stats": stats, "split": split}
        _check(launches["tiled_argmin_cuda"] >= 1
               and launches["tiled_fold_cuda"] >= 1
               and not launches["lloyd_pass_cuda"]
               and not launches["lloyd_delta_cuda"],
               f"{name}: rank {mesh.rank} did not tile: {launches}")
        states[comm] = st
        if mesh.rank == 0:
            moved, err, rel = _hold_to_single(name, x, st, single, bf16)
            print(f"{name}: {secs:.3f} s; against the single-device fit: "
                  f"{moved} labels moved (ties), centroids max abs diff "
                  f"{err:.3e}, inertia rel {rel:.3e}; launches {launches}",
                  flush=True)
    out["codebook_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if mesh.rank == 0:
        a, s = states["allreduce"], states["scatter"]
        moved, _ = _check_labels_pair(
            "codebook-dp2-gloo scatter vs allreduce", x, s.centroids,
            s.labels, a.centroids, a.labels, bf16)
        err = float((s.centroids - a.centroids).abs().max())
        print(f"codebook-dp2-gloo: scatter against allreduce: {moved} labels "
              f"moved (ties), centroids max abs diff {err:.3e}", flush=True)
    del x


def _mesh_rank_minibatch(mesh, out):
    """cifar10-dp2-minibatch on one rank (BASELINE config 5's engine at
    cifar10's shape); rank 0 replays both ranks' draws on one device."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.minibatch import (apply_batch_stats,
                                                   batch_stats)
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.parallel import engine as E
    from kmeans_tpu_torch.parallel import fit_minibatch_sharded, sharded_assign

    n, d, k = CIFAR10["n"], CIFAR10["d"], CIFAR10["k"]
    x, _, _ = kt.make_blobs(0, n, d, k)
    c0 = kt.kmeans_plus_plus(torch.Generator(device="cuda").manual_seed(3),
                             x, k)
    cfg = kt.KMeansConfig(k=k, batch_size=MB_BATCH, steps=MB_STEPS, seed=0)
    fit_minibatch_sharded(x, k, mesh=mesh, config=cfg, init=c0, steps=2)
    mesh.barrier()
    _sync()
    K.reset_launch_counts()
    mesh.reset_stats()
    t0 = time.perf_counter()
    st = fit_minibatch_sharded(x, k, mesh=mesh, config=cfg, init=c0)
    _sync()
    secs = time.perf_counter() - t0
    launches = K.launch_counts()
    stats = {op: list(v) for op, v in mesh.stats.items()}
    mesh.barrier()
    t0 = time.perf_counter()
    sharded_assign(x, st.centroids, mesh=mesh)
    _sync()
    final_s = time.perf_counter() - t0
    out["runs"]["cifar10-dp2-minibatch"] = {
        "seconds": secs, "final_s": final_s, "launches": launches,
        "stats": stats}
    _check(launches["lloyd_pass_cuda"] >= 1,
           f"cifar10-dp2-minibatch: rank {mesh.rank} launched no K1")
    if mesh.rank != 0:
        return
    # The replay: both ranks' index sets, their stats summed, the update.
    dp = mesh.size
    n_loc = -(-n // dp)
    b_loc = MB_BATCH // dp
    seed = E.minibatch_loop_seed(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    gens = [E.minibatch_rank_generator(seed, r, "cuda") for r in range(dp)]
    shard = [E._minibatch_shard(n, n_loc, dp, r) for r in range(dp)]
    c = c0.clone()
    n_seen = torch.zeros(k, device="cuda")
    for _ in range(MB_STEPS):
        bc = bs = None
        for r in range(dp):
            n_valid, s_i = shard[r]
            idx = torch.randint(0, max(n_valid, 1), (b_loc,),
                                generator=gens[r], device="cuda")
            c_r, s_r, _ = batch_stats(c, x[r * n_loc + idx],
                                      compute_dtype=None, row_weight=s_i)
            bc = c_r if bc is None else bc + c_r
            bs = s_r if bs is None else bs + s_r
        c, n_seen, _ = apply_batch_stats(c, n_seen, bc, bs)
    err = _close("cifar10-dp2-minibatch against its replay", st.centroids, c)
    single_cfg = kt.KMeansConfig(k=k, batch_size=MB_BATCH, steps=MB_STEPS,
                                 seed=0)
    kt.fit_minibatch(x, k, config=single_cfg, init=c0, steps=2)
    _sync()
    t0 = time.perf_counter()
    one = kt.fit_minibatch(x, k, config=single_cfg, init=c0)
    _sync()
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kt.lloyd_pass(x, one.centroids)
    _sync()
    one_final = time.perf_counter() - t0
    steps_s = MB_STEPS / max(secs - final_s, 1e-9)
    one_steps_s = MB_STEPS / max(one_s - one_final, 1e-9)
    print(f"cifar10-dp2-minibatch: {MB_STEPS} steps of {MB_BATCH} "
          f"({b_loc} a rank) in {secs:.3f} s with the final sharded "
          f"assignment ({final_s:.3f} s): {steps_s:.1f} steps/s, against "
          f"the single-device fit's {one_steps_s:.1f} steps/s ({one_s:.3f} "
          f"s, final sweep {one_final:.3f} s) on the same card, two ranks "
          f"sharing it; centroids against the replay of both ranks' draws "
          f"on one device: max abs err {err:.3e}; inertia "
          f"{float(st.inertia):.6e} (single-device {float(one.inertia):.6e})"
          f"; all-reduces {stats['all_reduce']}; launches {launches}",
          flush=True)


def _mesh_world(card, tmp):
    """Spawn phase 15's two-rank gloo world on the one card and wait for it
    (a rank that fails stops the other).  Returns each rank's record."""
    import os

    from kmeans_tpu_torch.parallel.mesh import free_port

    spec = {"out": f"{tmp}/mesh-rank%d.json"}
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE="2",
               PYTHONUNBUFFERED="1")
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank",
         json.dumps(spec)], cwd=root,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    _check(rcs == [0, 0], f"phase 15's gloo world: rank exit codes {rcs}")
    return [json.load(open(spec["out"] % r, encoding="utf-8"))
            for r in range(2)]


def _mesh_cli(card, tmp):
    """train-mesh: ``cli train --mesh N`` for lloyd and minibatch in child
    processes, N the host's card count where it is 2 or more; on one card,
    ``--mesh 2 --device cpu`` at a small shape (the launcher, the result
    line and ``--out``), against ``--mesh 1``."""
    import os

    import torch

    n_cards = torch.cuda.device_count()
    root = os.path.dirname(os.path.abspath(__file__))
    if n_cards >= 2:
        base = ["train", "--config", "imagenet", "--mesh", str(n_cards)]
        runs = {"lloyd": base + ["--model", "lloyd"],
                "minibatch": base + ["--model", "minibatch"]}
        single = None
    else:
        print(f"train-mesh: cli train --config imagenet --mesh N needs two "
              f"or more cards, and this host has {n_cards} ({card}); "
              f"running --mesh 2 --device cpu at {' '.join(MESH_CLI_SMALL)} "
              "instead (the launcher, the result line and --out, not speed)")
        base = ["train", *MESH_CLI_SMALL, "--device", "cpu", "--seed", "3"]
        runs = {"lloyd": base + ["--mesh", "2", "--comm", "scatter"],
                "minibatch": base + ["--mesh", "2", "--model", "minibatch",
                                     "--steps", "50", "--batch-size", "512"]}
        single = {"lloyd": base, "minibatch": base + [
            "--model", "minibatch", "--steps", "50", "--batch-size", "512"]}
    # Every run at once: they share no state, and on one card they are
    # CPU processes.
    procs = {}
    t0 = time.perf_counter()
    for model, argv in runs.items():
        procs[model] = subprocess.Popen(
            [sys.executable, "-m", "kmeans_tpu_torch.cli", *argv, "--out",
             f"{tmp}/train-mesh-{model}.json"], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        if single is not None:
            procs[model, 1] = subprocess.Popen(
                [sys.executable, "-m", "kmeans_tpu_torch.cli",
                 *single[model]], cwd=root, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    outs = {}
    try:
        for key, proc in procs.items():
            outs[key] = proc.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs = time.perf_counter() - t0
    for key, proc in procs.items():
        _check(proc.returncode == 0,
               f"train-mesh {key}: exit {proc.returncode}, stderr "
               f"{outs[key][1].strip().splitlines()[-6:]}")
    for model, argv in runs.items():
        lines = outs[model][0].strip().splitlines()
        _check(len(lines) == 1, f"train-mesh {model}: {len(lines)} result "
               "lines (rank 0 alone prints one)")
        res = json.loads(lines[0])
        doc = json.load(open(f"{tmp}/train-mesh-{model}.json",
                             encoding="utf-8"))
        _check(res["mode"] == model and res["mesh"] == int(argv[
            argv.index("--mesh") + 1]) and math.isfinite(res["inertia"])
               and isinstance(doc, dict),
               f"train-mesh {model}: result {res}")
        line = f"train-mesh {model}: {' '.join(argv)}: {res}"
        if single is not None:
            ref = json.loads(outs[model, 1][0].strip().splitlines()[-1])
            same = ("n", "d", "k", "n_iter", "mode")
            _check({f: res[f] for f in same} == {f: ref[f] for f in same},
                   f"train-mesh {model}: {res} against --mesh 1 {ref}")
            if model == "lloyd":
                _check(abs(res["inertia"] - ref["inertia"])
                       <= FIT_INERTIA_RTOL * ref["inertia"],
                       f"train-mesh lloyd: inertia {res['inertia']} against "
                       f"--mesh 1 {ref['inertia']}")
            line += f"; --mesh 1: {ref}"
        print(line)
    print(f"train-mesh: {len(procs)} processes at once, {secs:.1f} s")


def phase_mesh(card):
    """Phase 15: the data-parallel engine (see the module docstring):
    imagenet-dp1-nccl in this process, then imagenet-dp2-gloo,
    codebook-dp2-gloo and cifar10-dp2-minibatch in a two-rank gloo world
    on the card, then train-mesh.  Returns the runs' launches by compute:
    ``{"bf16": {...}, "f32": {...}}``."""
    import tempfile

    import torch
    import torch.distributed as dist

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init
    from kmeans_tpu_torch.parallel import make_mesh
    from kmeans_tpu_torch.parallel.engine import _sweep_collective_bytes

    t_all = time.perf_counter()
    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    bf16 = torch.bfloat16
    totals = {"bf16": {}, "f32": {}}

    def add(compute, launches):
        for name, v in launches.items():
            totals[compute][name] = totals[compute].get(name, 0) + v

    # imagenet-dp1-nccl: the engine on an NCCL mesh of one, held to the
    # single-device delta fit, both timed in this call.
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=bf16)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(1), x, k)
    mesh = make_mesh((1, 1), ("data", "model"))
    _check(mesh.backend == "nccl",
           f"imagenet-dp1-nccl: {mesh}")
    _mesh_fit(mesh, x, k, c0, "delta", "auto", 1)
    _single_fit(x, k, c0, "delta", 1)
    want, one_s, one_l = _single_fit(x, k, c0, "delta", MESH_SWEEPS)
    got, secs, launches, stats, split = _mesh_fit(mesh, x, k, c0, "delta",
                                                  "auto", MESH_SWEEPS)
    add("bf16", one_l)
    add("bf16", launches)
    moved, err, rel = _hold_to_single("imagenet-dp1-nccl", x, got, want,
                                      bf16, same_centroids=True)
    _check(launches["lloyd_delta_cuda"] >= MESH_SWEEPS
           and launches["accumulate_cuda"] >= 2
           and launches["lloyd_pass_cuda"] >= 1,
           f"imagenet-dp1-nccl: launches {launches}")
    _check(stats["all_reduce"][0] >= MESH_SWEEPS,
           f"imagenet-dp1-nccl: NCCL collectives {stats}, not one "
           f"all-reduce a sweep")
    print(f"imagenet-dp1-nccl ({card}): fit_lloyd_sharded(update='delta', "
          f"comm='auto') on an NCCL mesh of one, {MESH_SWEEPS} sweeps + "
          f"final view, {secs:.3f} s against fit_lloyd's {one_s:.3f} s "
          f"(engine/fit {secs / one_s:.3f}); {moved} labels moved (ties), "
          f"centroids max abs err {err:.3e}, inertia rel {rel:.3e}; "
          f"launches {launches} (fit_lloyd: {one_l}); collectives "
          f"{stats}; a sweep: {_split_line(split)}")
    del x, want, got
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        ranks = _mesh_world(card, tmp)
        print(f"gloo on the card ({card}): all_reduce, reduce_scatter and "
              f"all_gather take card tensors and give the right values "
              f"({ranks[0]['probe']}); no collective is staged by hand")
        for name in ranks[0]["runs"]:
            recs = [r["runs"].get(name) for r in ranks]
            for rec in recs:
                if rec is not None:
                    add("f32" if name.startswith("cifar10") else "bf16",
                        rec["launches"])
            if "split" not in recs[0]:
                continue
            flavour = name.split()[0]
            kk = CODEBOOK["k"] if flavour.startswith("codebook") else k
            comm = name.split()[-1]
            sweeps = (MESH_CODEBOOK_SWEEPS if flavour.startswith("codebook")
                      else MESH_SWEEPS)
            for r, rec in enumerate(recs):
                moved_b = sum(v[1] for op, v in rec["stats"].items())
                ring = _sweep_collective_bytes(comm, dp=2, k=kk, d=d)
                print(f"{name} rank {r}: a sweep: "
                      f"{_split_line(rec['split'])}; collectives "
                      f"{rec['stats']} ({moved_b / sweeps / 1e6:.3f} MB of "
                      f"payload a sweep with the final pass spread over "
                      f"the sweeps; ring model {ring / 1e6:.3f} MB a device "
                      f"a sweep)")
        print(f"codebook-dp2-gloo: each rank's peak card memory from its "
              f"data on (this phase hands the fit the full x on the card "
              f"and keeps it; since C4 the block is a copy of the rank's "
              f"rows beside it; rank 0 also ran the single-device fit): "
              f"{[round(r['codebook_peak_gb'], 3) for r in ranks]} GB")
        mb = [r["runs"]["cifar10-dp2-minibatch"] for r in ranks]
        print(f"cifar10-dp2-minibatch ranks: seconds "
              f"{[round(m['seconds'], 3) for m in mb]}, launches "
              f"{[m['launches'] for m in mb]}")
        _mesh_cli(card, tmp)
    print(f"phase 15 ({card}): {time.perf_counter() - t_all:.1f} s; "
          f"launches {totals}")
    return totals


# ---------------------------------------------------------------------------
# Phase 16: the rest of the sharded engine
# ---------------------------------------------------------------------------

#: imagenet-accel-dp1-nccl: both extrapolations to convergence (default
#: tol), at most this many sweeps.
SHARDED_ACCEL_MAX_ITER = 100
#: The elastic drills: sweeps, bundle cadence (the cut comes at the second
#: boundary, sweep 8) and the fault that cuts them.
ELASTIC_SWEEPS = 20
ELASTIC_EVERY = 4
ELASTIC_FAULT = "engine.sweep_merge:sigterm@2"
#: imagenet-stream-dp2-gloo: phase 14's stream cut to this many steps.
SHARDED_STREAM_STEPS = 200
#: imagenet-tp2-gloo / -fp2-gloo: classic sweeps; codebook-tp2-gloo's cut.
TP_SWEEPS = 20
TP_CODEBOOK_SWEEPS = 2
#: TP×FP on four gloo ranks: a small shape, held, not timed.
TPFP_SHAPE = dict(n=100_000, d=256, k=200)
TPFP_SWEEPS = 10
#: Seconds a world or a child of this phase may take.
SHARDED_TIMEOUT_S = 420
#: codebook-dp2-gloo's peak card memory a rank before C4's repair (the
#: lowest of phase 15's readings, 10.1–10.7 GB, NVIDIA H100 80GB HBM3 at
#: 700.00 W: each rank kept the full x) and the least drop the repair must
#: show (a rank's 2.62 GB half of x no longer held twice).
CODEBOOK_PEAK_BEFORE_C4_GB = 10.1
C4_MIN_DROP_GB = 2.5
#: train-mesh's small shape for phase 16's ``cli train --mesh 2 --device
#: cpu`` runs.
SHARDED_CLI_SMALL = ["--n", "4000", "--d", "16", "--k", "8", "--seed", "3",
                     "--device", "cpu"]


def _state_record(st):
    """A state's tensors on the host, for a file another process reads."""
    return {"centroids": st.centroids.cpu(), "labels": st.labels.cpu(),
            "inertia": float(st.inertia), "n_iter": int(st.n_iter),
            "counts": st.counts.cpu()}


def _headline_data():
    """Phase 4's bf16 data and c0, made on the card from their seeds."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=torch.bfloat16)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(1), x, k)
    return x, c0


def _sharded_accel(card, mesh, x, c0):
    """imagenet-accel-dp1-nccl: β and Anderson to convergence on an NCCL
    mesh of one, each held to the single-device ``fit_lloyd_accelerated``
    from the same c0 (dense sweeps both): iterations equal, centroids
    within SUMS_RTOL, inertia within FIT_INERTIA_RTOL; each timed beside
    it after a warm-up.  Returns the runs' launches."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.parallel import fit_lloyd_accelerated_sharded

    k = c0.shape[0]
    cfg = kt.KMeansConfig(k=k, update="matmul", compute_dtype="bfloat16",
                          max_iter=SHARDED_ACCEL_MAX_ITER)
    total = {}
    for accel in ("beta", "anderson"):
        runs = {}
        for name, fit in (("one card", lambda n_it: kt.fit_lloyd_accelerated(
                x, k, config=cfg, init=c0, accel=accel, max_iter=n_it)),
                          ("mesh", lambda n_it: fit_lloyd_accelerated_sharded(
                x, k, mesh=mesh, config=cfg, init=c0, accel=accel,
                max_iter=n_it))):
            fit(2)                                  # warm-up
            _sync()
            K.reset_launch_counts()
            mesh.reset_stats()
            t0 = time.perf_counter()
            st = fit(SHARDED_ACCEL_MAX_ITER)
            _sync()
            runs[name] = (st, time.perf_counter() - t0, K.launch_counts(),
                          mesh.stats["all_reduce"][0])
            _add_counts(total, runs[name][2])
        (one, one_s, _, _), (got, secs, launches, n_ar) = (runs["one card"],
                                                          runs["mesh"])
        tag = f"imagenet-accel-dp1-nccl {accel}"
        _check(int(got.n_iter) == int(one.n_iter),
               f"{tag}: {int(got.n_iter)} sweeps against one card's "
               f"{int(one.n_iter)}")
        err = _close(f"{tag} centroids", got.centroids, one.centroids)
        rel = abs(float(got.inertia) - float(one.inertia)) / float(
            one.inertia)
        _check(rel <= FIT_INERTIA_RTOL and _finite(got.centroids),
               f"{tag}: inertia {float(got.inertia)!r} against "
               f"{float(one.inertia)!r}")
        _check(launches["lloyd_pass_cuda"] >= int(got.n_iter),
               f"{tag}: launches {launches}")
        _check(n_ar >= int(got.n_iter),
               f"{tag}: {n_ar} NCCL all-reduces in {int(got.n_iter)} sweeps")
        print(f"{tag} ({card}): fit_lloyd_accelerated_sharded(accel="
              f"{accel!r}) on an NCCL mesh of one, {int(got.n_iter)} sweeps "
              f"(converged {bool(got.converged)}) in {secs:.3f} s against "
              f"fit_lloyd_accelerated's {int(one.n_iter)} in {one_s:.3f} s "
              f"(mesh/one card {secs / one_s:.3f}); centroids max abs err "
              f"{err:.3e}, inertia rel {rel:.3e}; launches {launches}; "
              f"NCCL all-reduces {n_ar}", flush=True)
    torch.cuda.empty_cache()
    return total


def _elastic_fit(mesh, x, c0, update, ck, resume=False):
    """One elastic ``fit_lloyd_sharded`` of the drills: ELASTIC_SWEEPS
    sweeps of ``update``, bundles every ELASTIC_EVERY into ``ck``."""
    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.parallel import fit_lloyd_sharded

    cfg = kt.KMeansConfig(k=c0.shape[0], update=update,
                          compute_dtype="bfloat16")
    return fit_lloyd_sharded(x, c0.shape[0], mesh=mesh, config=cfg, init=c0,
                             max_iter=ELASTIC_SWEEPS, tol=-1.0, ckpt_dir=ck,
                             ckpt_every=ELASTIC_EVERY, resume=resume)


def _elastic_rank(spec) -> int:
    """``chip_smoke.py --elastic-rank SPEC``: one elastic fit on an NCCL
    mesh of one in a child process (phase 4's data and c0 made here from
    their seeds), cut by ``KMEANS_TPU_FAULTS`` when the parent sets it, or
    resumed (``spec["resume"]``).  Writes its state (``spec["state"]``,
    ``torch.save``), the wall-clock time just before the fit, its seconds,
    launches and bundle seconds (``kmeans_tpu_engine_ckpt_seconds``) or
    the sweep it was preempted at to ``spec["out"]``."""
    import torch
    import torch.distributed as dist

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.parallel import engine as E
    from kmeans_tpu_torch.parallel import make_mesh
    from kmeans_tpu_torch.utils.preempt import Preempted

    x, c0 = _headline_data()
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {}
    K.reset_launch_counts()
    out["t_fit"] = time.time()
    try:
        st = _elastic_fit(mesh, x, c0, spec["update"], spec["ckpt"],
                          resume=spec["resume"])
        torch.cuda.synchronize()
        torch.save(_state_record(st), spec["state"])
    except Preempted as e:
        out["preempted"] = e.step
    out["seconds"] = time.time() - out["t_fit"]
    out["launches"] = K.launch_counts()
    out["bundles"], out["bundle_s"], _ = E._ENGINE_CKPT_SECONDS.snapshot()
    with open(spec["out"], "w", encoding="utf-8") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _spawn_children(specs, env=None):
    """Start ``chip_smoke.py --elastic-rank`` children at once and wait for
    them (each killed at SHARDED_TIMEOUT_S).  Returns ``[(record, spawn
    time, exit time)]`` in order."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for spec in specs:
        t_spawn = time.time()
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--elastic-rank",
             json.dumps(spec)], cwd=root,
            env=dict(os.environ, **(env or {}), PYTHONUNBUFFERED="1")),
            t_spawn))
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    exits = [None] * len(procs)
    try:
        while any(t is None for t in exits) and time.monotonic() < deadline:
            for i, (p, _) in enumerate(procs):
                if exits[i] is None and p.poll() is not None:
                    exits[i] = time.time()
            time.sleep(0.05)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    out = []
    for (p, t_spawn), t_exit, spec in zip(procs, exits, specs):
        _check(p.returncode == 0, f"elastic child {spec['name']}: exit "
               f"{p.returncode}")
        with open(spec["out"], encoding="utf-8") as f:
            out.append((json.load(f), t_spawn, t_exit))
    return out


def _elastic_whole(card, mesh, x, c0, tmp):
    """imagenet-elastic-dp1-nccl's uninterrupted runs (matmul and delta),
    in this process.  Returns ``(launches, {update: state file})``."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.parallel import engine as E
    from kmeans_tpu_torch.utils.checkpoint import latest_step

    total = {}
    whole = {}
    for update in ("matmul", "delta"):
        _elastic_fit(mesh, x, c0, update, f"{tmp}/elastic-warm-{update}")
        _sync()
        K.reset_launch_counts()
        mesh.reset_stats()
        n0, s0, _ = E._ENGINE_CKPT_SECONDS.snapshot()
        t0 = time.perf_counter()
        st = _elastic_fit(mesh, x, c0, update, f"{tmp}/elastic-{update}")
        _sync()
        secs = time.perf_counter() - t0
        n_ar = mesh.stats["all_reduce"][0]
        n1, s1, _ = E._ENGINE_CKPT_SECONDS.snapshot()
        launches = K.launch_counts()
        _add_counts(total, launches)
        whole[update] = f"{tmp}/elastic-{update}.pt"
        torch.save(_state_record(st), whole[update])
        _check(int(st.n_iter) == ELASTIC_SWEEPS and n1 - n0 == 5
               and n_ar >= ELASTIC_SWEEPS,
               f"imagenet-elastic-dp1-nccl {update}: {int(st.n_iter)} "
               f"sweeps, {n1 - n0} bundles, {n_ar} NCCL all-reduces")
        print(f"imagenet-elastic-dp1-nccl {update} ({card}): "
              f"{ELASTIC_SWEEPS} sweeps at ckpt_every={ELASTIC_EVERY} in "
              f"{secs:.3f} s, {n1 - n0} bundles at "
              f"{1e3 * (s1 - s0) / (n1 - n0):.2f} ms each (the pull of "
              f"the global centroids and the verified save); launches "
              f"{launches}; NCCL all-reduces {n_ar}", flush=True)
    return total, whole


def _elastic_cuts(tmp):
    """imagenet-elastic-dp1-nccl's cut runs: two children at once, each
    SIGTERMed by the fault at its second boundary.  Returns ``(launches,
    specs, records)``."""
    from kmeans_tpu_torch.utils.checkpoint import latest_step

    total = {}
    specs = [dict(name=f"cut {u}", update=u, resume=False,
                  ckpt=f"{tmp}/elastic-cut-{u}", state=f"{tmp}/cut-{u}.pt",
                  out=f"{tmp}/cut-{u}.json") for u in ("matmul", "delta")]
    cuts = _spawn_children(specs, env={"KMEANS_TPU_FAULTS": ELASTIC_FAULT})
    for spec, (rec, _, _) in zip(specs, cuts):
        _check(rec.get("preempted") == 2 * ELASTIC_EVERY
               and latest_step(spec["ckpt"]) == 2 * ELASTIC_EVERY,
               f"imagenet-elastic {spec['name']}: {rec}")
        _add_counts(total, rec["launches"])
    import shutil

    # The bundle the two-rank gloo mesh resumes, before the resume here
    # writes over it.
    shutil.copytree(f"{tmp}/elastic-cut-matmul", f"{tmp}/elastic-gloo")
    return total, specs, cuts


def _elastic_resumes(card, tmp, specs, cuts, whole):
    """imagenet-elastic-dp1-nccl's resumes, two children at once, each held
    to the uninterrupted run bit for bit.  Returns the launches."""
    import torch

    total = {}
    rspecs = [dict(spec, name=f"resume {spec['update']}", resume=True,
                   state=f"{tmp}/resumed-{spec['update']}.pt",
                   out=f"{tmp}/resumed-{spec['update']}.json")
              for spec in specs]
    resumed = _spawn_children(rspecs)
    for spec, (rec, t_spawn, _), (cut, _, t_exit) in zip(rspecs, resumed,
                                                         cuts):
        update = spec["update"]
        _add_counts(total, rec["launches"])
        got = torch.load(spec["state"])
        want = torch.load(whole[update])
        _check(got["n_iter"] == ELASTIC_SWEEPS,
               f"imagenet-elastic resume {update}: {got['n_iter']} sweeps")
        _check(torch.equal(got["centroids"], want["centroids"])
               and torch.equal(got["labels"], want["labels"])
               and got["inertia"] == want["inertia"],
               f"imagenet-elastic {update}: the cut and resumed run is not "
               "the uninterrupted one bit for bit")
        print(f"imagenet-elastic-dp1-nccl {update} drill ({card}): SIGTERM "
              f"at the second boundary, exit at sweep {cut['preempted']} "
              f"after {cut['bundles']} bundles ({1e3 * cut['bundle_s'] / max(cut['bundles'], 1):.2f} "
              f"ms each); the restart: {rec['t_fit'] - t_spawn:.2f} s from "
              f"its spawn to the resumed fit's call (process, card context, "
              f"data regenerated), {t_spawn - t_exit:.2f} s after the cut's "
              f"exit; the resumed {ELASTIC_SWEEPS - cut['preempted']} sweeps "
              f"{rec['seconds']:.3f} s; bit for bit the uninterrupted run",
              flush=True)
    return total


def _gloo_probe16(mesh):
    """Phase 16's collectives on card tensors over gloo: the MIN
    all-reduce of int32 and of f32."""
    import torch

    t = torch.tensor([10 - mesh.rank, 3 + mesh.rank], dtype=torch.int32,
                     device=mesh.device)
    got = mesh.all_reduce(t, op="min")
    _check(got.is_cuda and got.tolist() == [10 - (mesh.size - 1), 3],
           f"gloo MIN all_reduce of int32 on the card: {got.tolist()}")
    f = torch.tensor([float(mesh.rank) - 0.5], device=mesh.device)
    _check(float(mesh.all_reduce(f, op="min")[0]) == -0.5,
           "gloo MIN all_reduce of f32 on the card")


def _masked_counts(K):
    """K1's and K5's launches with ``valid_cols`` (the TP hook) since the
    last reset, as the module's launch sites count them."""
    m = K.launch_counts(masked=True)
    return {"K1": m["lloyd_pass_cuda"], "K5": m["tiled_argmin_cuda"]}


def _sharded_run(mesh, name, out, fn):
    """One timed run on ``mesh``: counts and collectives set to 0 just
    before, read just after, its sweeps split.  Returns the state."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.parallel.engine import sweep_split

    mesh.barrier()
    _sync()
    K.reset_launch_counts()
    mesh.reset_stats()
    t0 = time.perf_counter()
    with sweep_split(mesh) as sp:
        st = fn()
        torch.cuda.synchronize()
    out["runs"][name] = {"seconds": time.perf_counter() - t0,
                         "launches": K.launch_counts(),
                         "valid_cols": _masked_counts(K),
                         "stats": {op: list(v)
                                   for op, v in mesh.stats.items()},
                         "split": sp.summary()}
    return st


def _sharded_rank(spec) -> int:
    """``chip_smoke.py --sharded-rank SPEC``: one rank of phase 16's gloo
    world on the one card (``spec["world"]`` ranks; 4: the TP×FP check).
    Writes the rank's record to ``spec["out"] % rank``."""
    import torch.distributed as dist

    from kmeans_tpu_torch.parallel import make_mesh

    world = spec["world"]
    mesh = make_mesh((world, 1), ("data", "model"),
                     devices=["cuda:0"] * world, backend="gloo")
    out = {"rank": mesh.rank, "runs": {}}
    try:
        _gloo_probe16(mesh)
        if mesh.rank == 0:
            print(f"gloo on the card, {world} ranks: the MIN all-reduce of "
                  "int32 and f32 takes card tensors and gives the right "
                  "values", flush=True)
        if world == 4:
            _sharded_rank_tpfp(out)
        else:
            x, c0 = _headline_data()
            x_host = x.cpu()
            if mesh.rank != 0:
                del x
                x = None
            _sharded_rank_trimmed(mesh, out, x, x_host, c0)
            _sharded_rank_elastic(mesh, out, x, x_host, c0, spec)
            _sharded_rank_tp_fp(out, x, x_host, c0)
            del x, x_host
            _sharded_rank_stream(mesh, out)
            _sharded_rank_codebook(out, mesh)
    finally:
        with open(spec["out"] % mesh.rank, "w", encoding="utf-8") as f:
            json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _sharded_rank_trimmed(mesh, out, x, x_host, c0):
    """trimmed-dp2-gloo on one rank; rank 0 holds it to ``fit_trimmed``
    and to one card's top-m at the sharded fit's centroids."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.trimmed import trim_select
    from kmeans_tpu_torch.parallel import fit_trimmed_sharded

    k = c0.shape[0]
    cfg = kt.KMeansConfig(k=k, compute_dtype="bfloat16")

    def fit(n_it):
        return fit_trimmed_sharded(x_host, k, mesh=mesh, n_trim=TRIM_M,
                                   config=cfg, init=c0, max_iter=n_it,
                                   tol=-1.0)

    fit(1)
    st = _sharded_run(mesh, "trimmed-dp2-gloo", out,
                      lambda: fit(TRIM_ITERS))
    launches = out["runs"]["trimmed-dp2-gloo"]["launches"]
    _check(launches["lloyd_pass_cuda"] >= TRIM_ITERS
           and launches["tiled_fold_cuda"] >= TRIM_ITERS,
           f"trimmed-dp2-gloo: rank {mesh.rank} launched {launches}")
    if mesh.rank != 0:
        return
    _sync()
    t0 = time.perf_counter()
    one = kt.fit_trimmed(x, k, n_trim=TRIM_M, config=cfg, init=c0,
                         max_iter=TRIM_ITERS, tol=-1.0)
    _sync()
    one_s = time.perf_counter() - t0
    # The selection exactly: one card's K1 min_d2 at the sharded fit's
    # centroids, its top m by the same order, is the sharded mask.
    _, min_d2, _, _, _ = kt.lloyd_pass(x, st.centroids,
                                       compute_dtype="bfloat16")
    _, idx = trim_select(min_d2, None, TRIM_M)
    mask = torch.zeros(x.shape[0], dtype=torch.bool, device="cuda")
    mask[idx] = True
    _check(torch.equal(mask, st.outlier_mask),
           "trimmed-dp2-gloo: the mask is not one card's top m at the "
           "sharded centroids")
    differ = int((st.outlier_mask != one.outlier_mask).sum())
    tau = float(min_d2[idx[-1]])
    near = float((min_d2[st.outlier_mask != one.outlier_mask]
                  - tau).abs().max()) if differ else 0.0
    rel = abs(float(st.inertia) - float(one.inertia)) / float(one.inertia)
    _check(rel <= FIT_INERTIA_RTOL and differ <= TRIM_M // 100,
           f"trimmed-dp2-gloo: inertia rel {rel:.3e}, {differ} rows "
           "trimmed apart from fit_trimmed")
    run = out["runs"]["trimmed-dp2-gloo"]
    print(f"trimmed-dp2-gloo: m = {TRIM_M}, {TRIM_ITERS} iterations on two "
          f"ranks sharing the card in {run['seconds']:.3f} s "
          f"({1e3 * run['seconds'] / TRIM_ITERS:.3f} ms an iteration; "
          f"fit_trimmed on one card {one_s:.3f} s); the mask one card's "
          f"top m at the sharded centroids exactly; against fit_trimmed "
          f"{differ} rows trimmed apart, within {near:.3e} of tau "
          f"{tau:.6e} at the sharded centroids, inertia rel {rel:.3e}; "
          f"launches {launches}", flush=True)


def _sharded_rank_elastic(mesh, out, x, x_host, c0, spec):
    """The card-cut matmul bundle (sweep 8 of one rank's NCCL fit) resumed
    on this two-rank gloo mesh; rank 0 holds it to the uninterrupted
    run: labels but ties, inertia within FIT_INERTIA_RTOL."""
    import torch

    st = _sharded_run(mesh, "elastic-dp2-gloo resume", out,
                      lambda: _elastic_fit(mesh, x_host, c0, "matmul",
                                           spec["elastic_ck"], resume=True))
    if mesh.rank != 0:
        return
    want = torch.load(spec["elastic_whole"])
    _check(int(st.n_iter) == ELASTIC_SWEEPS,
           f"elastic-dp2-gloo: {int(st.n_iter)} sweeps")
    rel = abs(float(st.inertia) - want["inertia"]) / want["inertia"]
    _check(rel <= FIT_INERTIA_RTOL,
           f"elastic-dp2-gloo: inertia rel {rel:.3e}")
    moved, _ = _check_labels_pair(
        "elastic-dp2-gloo", x, st.centroids, st.labels,
        want["centroids"].cuda(), want["labels"].cuda(), torch.bfloat16)
    print(f"elastic-dp2-gloo: the bundle cut on an NCCL mesh of one at "
          f"sweep {2 * ELASTIC_EVERY}, resumed on two gloo ranks: "
          f"{int(st.n_iter)} sweeps, {moved} labels moved against the "
          f"uninterrupted run (ties), inertia rel {rel:.3e}; "
          f"{out['runs']['elastic-dp2-gloo resume']['seconds']:.3f} s",
          flush=True)


def _tp_line(name, run):
    vc = run["valid_cols"]
    return (f"{name}: {run['seconds']:.3f} s; K1 launches with valid_cols "
            f"{vc['K1']}, K5 {vc['K5']}; a sweep: {_split_line(run['split'])}"
            f"; collectives {run['stats']}")


def _sharded_rank_tp_fp(out, x, x_host, c0):
    """imagenet-tp2-gloo (mesh (1, 2), model = 2) and imagenet-fp2-gloo
    (mesh (1, 1, 2), feature = 2): TP_SWEEPS classic sweeps each; rank 0
    holds them to the single-device classic fit."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.parallel import fit_lloyd_sharded, make_mesh

    k = c0.shape[0]
    cfg = kt.KMeansConfig(k=k, update="matmul", compute_dtype="bfloat16")
    dev = ["cuda:0", "cuda:0"]
    meshes = {
        "imagenet-tp2-gloo": (make_mesh((1, 2), ("data", "model"),
                                        devices=dev, backend="gloo"),
                              dict(model_axis="model")),
        "imagenet-fp2-gloo": (make_mesh((1, 1, 2),
                                        ("data", "model", "feature"),
                                        devices=dev, backend="gloo"),
                              dict(feature_axis="feature")),
    }
    one = None
    if x is not None:
        _sync()
        t0 = time.perf_counter()
        one = kt.fit_lloyd(x, k, config=cfg, init=c0, max_iter=TP_SWEEPS,
                           tol=-1.0)
        _sync()
        out["one_s"] = time.perf_counter() - t0
    for name, (mesh, axes) in meshes.items():
        st = _sharded_run(mesh, name, out, lambda: fit_lloyd_sharded(
            x_host, k, mesh=mesh, config=cfg, init=c0, max_iter=TP_SWEEPS,
            tol=-1.0, **axes))
        run = out["runs"][name]
        need = "K1" if "tp2" in name else None
        _check(run["launches"]["lloyd_pass_cuda"] >= 1
               and (need is None or run["valid_cols"][need] >= TP_SWEEPS),
               f"{name}: rank {mesh.rank} launched {run['launches']}, "
               f"valid_cols {run['valid_cols']}")
        if one is not None:
            moved, err, rel = _hold_to_single(name, x, st, one,
                                              torch.bfloat16)
            print(f"{_tp_line(name, run)}; against the single-device "
                  f"classic fit ({out['one_s']:.3f} s): {moved} labels "
                  f"moved (ties), centroids max abs diff {err:.3e}, inertia "
                  f"rel {rel:.3e}; launches {run['launches']}", flush=True)
        del st
        torch.cuda.empty_cache()


def _sharded_rank_stream(mesh, out):
    """imagenet-stream-dp2-gloo on one rank: phase 14's f32 rows in this
    rank's host memory, SHARDED_STREAM_STEPS steps of STREAM_BATCH, each
    rank gathering its half of every step's sorted indices; rank 0 replays
    both halves on one device (the centroids bit for bit) and times a
    step's split on its half."""
    import numpy as np
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.data.stream import PinnedRing, sample_batches
    from kmeans_tpu_torch.data.synthetic import make_blobs
    from kmeans_tpu_torch.models import streaming as S
    from kmeans_tpu_torch.models.minibatch import (apply_batch_stats,
                                                   batch_stats)
    from kmeans_tpu_torch.native import loader as NL

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    x_t = make_blobs(14, n, d, k, device="cuda")[0]
    x_np = x_t.cpu().numpy()
    del x_t
    torch.cuda.empty_cache()
    c0 = np.ascontiguousarray(x_np[::n // k][:k])
    cfg = kt.KMeansConfig(k=k, steps=SHARDED_STREAM_STEPS,
                          batch_size=STREAM_BATCH, seed=0)
    marks = {}
    real_final = S._sharded_final

    def final(*a, **kw):
        _sync()
        marks["t_steps"] = time.perf_counter()
        return real_final(*a, **kw)

    NL.reset_gather_counts()
    S._sharded_final = final
    try:
        mesh.barrier()
        t0 = time.perf_counter()
        st = _sharded_run(mesh, "imagenet-stream-dp2-gloo", out,
                          lambda: S.fit_minibatch_stream(
                              x_np, k, config=cfg, init=c0, mesh=mesh))
    finally:
        S._sharded_final = real_final
    run = out["runs"]["imagenet-stream-dp2-gloo"]
    run["steps_s"] = marks["t_steps"] - t0
    run["gathers"] = NL.gather_counts()
    _check(run["gathers"] == {"native": SHARDED_STREAM_STEPS, "numpy": 0},
           f"imagenet-stream-dp2-gloo: gathers {run['gathers']}")
    if mesh.rank != 0:
        return
    half = STREAM_BATCH // mesh.size
    ring = PinnedRing(1, half, d, torch.float32)
    parts = [sample_batches(x_np, STREAM_BATCH, SHARDED_STREAM_STEPS, seed=0,
                            part=(r, mesh.size),
                            ring=ring if r == 0 else None)
             for r in range(mesh.size)]
    c = torch.from_numpy(c0).cuda()
    n_seen = torch.zeros(k, device="cuda")
    g_ms, c_ms, u_ms = [], [], []
    for _ in range(SHARDED_STREAM_STEPS):
        t1 = time.perf_counter()
        buf = next(parts[0])
        g_ms.append(1e3 * (time.perf_counter() - t1))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        xb = buf.to("cuda", non_blocking=True)
        ev[1].record()
        ring.copied(ev[1])
        bc, bs, _ = batch_stats(c, xb, compute_dtype=None)
        ev[2].record()
        ev[2].synchronize()
        c_ms.append(ev[0].elapsed_time(ev[1]))
        u_ms.append(ev[1].elapsed_time(ev[2]))
        for p in parts[1:]:
            c_r, s_r, _ = batch_stats(c, next(p).cuda(), compute_dtype=None)
            bc, bs = bc + c_r, bs + s_r
        c, n_seen, _ = apply_batch_stats(c, n_seen, bc, bs)
    _check(torch.equal(c, st.centroids),
           f"imagenet-stream-dp2-gloo: the centroids differ from the replay "
           f"of both ranks' halves (max abs "
           f"{float((c - st.centroids).abs().max())})")
    _check(st.labels.shape[0] == n and _finite(st.centroids)
           and math.isfinite(float(st.inertia)),
           "imagenet-stream-dp2-gloo: the final pass")
    med = statistics.median
    print(f"imagenet-stream-dp2-gloo: {SHARDED_STREAM_STEPS} steps of "
          f"{STREAM_BATCH} ({half} rows gathered a rank) in "
          f"{run['steps_s']:.3f} s = "
          f"{SHARDED_STREAM_STEPS / run['steps_s']:.1f} steps/s (phase 14, "
          f"one rank: 76.8-189.2), two ranks sharing the card; a rank's "
          f"step alone: native gather of its half {med(g_ms):.3f} ms (host "
          f"clock), copy {med(c_ms):.3f} ms and batch_stats "
          f"{med(u_ms):.3f} ms (CUDA events); the centroids the replay of "
          f"both halves bit for bit; all-reduces "
          f"{run['stats']['all_reduce']}; launches {run['launches']}",
          flush=True)


def _sharded_rank_codebook(out, mesh):
    """codebook-dp2-gloo's memory line after C4 (the data moved to the
    host before the fit: each rank places its own 640,000 rows), then
    codebook-tp2-gloo: TP_CODEBOOK_SWEEPS classic sweeps at k = 65536 over
    two model ranks (32,768 columns each, K5 / K6 with valid_cols)."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init
    from kmeans_tpu_torch.parallel import fit_lloyd_sharded, make_mesh

    n, d, k = CODEBOOK["n"], CODEBOOK["d"], CODEBOOK["k"]
    x, _, _ = kt.make_blobs(11, n, d, k, dtype=torch.bfloat16)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(2), x, k)
    x_host = x.cpu()
    del x
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = kt.KMeansConfig(k=k, update="delta", comm="allreduce",
                          compute_dtype="bfloat16")
    st = _sharded_run(mesh, "codebook-dp2-gloo delta allreduce", out,
                      lambda: fit_lloyd_sharded(
                          x_host, k, mesh=mesh, config=cfg, init=c0,
                          max_iter=MESH_CODEBOOK_SWEEPS, tol=-1.0))
    out["codebook_peak_gb"] = peak = torch.cuda.max_memory_allocated() / 1e9
    _check(peak <= CODEBOOK_PEAK_BEFORE_C4_GB - C4_MIN_DROP_GB,
           f"codebook-dp2-gloo: rank {mesh.rank}'s peak card memory "
           f"{peak:.3f} GB, not {C4_MIN_DROP_GB} GB below phase 15's "
           f"{CODEBOOK_PEAK_BEFORE_C4_GB} GB before C4's repair")
    del st
    torch.cuda.empty_cache()
    tp = make_mesh((1, 2), ("data", "model"), devices=["cuda:0", "cuda:0"],
                   backend="gloo")
    cfg = kt.KMeansConfig(k=k, update="matmul", compute_dtype="bfloat16")
    st = _sharded_run(tp, "codebook-tp2-gloo", out,
                      lambda: fit_lloyd_sharded(
                          x_host, k, mesh=tp, config=cfg, init=c0,
                          max_iter=TP_CODEBOOK_SWEEPS, tol=-1.0,
                          model_axis="model"))
    run = out["runs"]["codebook-tp2-gloo"]
    launches = run["launches"]
    _check(launches["tiled_argmin_cuda"] >= TP_CODEBOOK_SWEEPS
           and launches["tiled_fold_cuda"] >= TP_CODEBOOK_SWEEPS
           and run["valid_cols"]["K5"] >= TP_CODEBOOK_SWEEPS
           and not launches["lloyd_pass_cuda"],
           f"codebook-tp2-gloo: rank {tp.rank} launched {launches}, "
           f"valid_cols {run['valid_cols']}")
    if tp.rank != 0:
        return
    # The last sweep exactly: one card's classic pass (K5) at the TP fit's
    # centroids gives its labels but ties.
    x = x_host.cuda()
    labels = kt.lloyd_pass(x, st.centroids, compute_dtype="bfloat16",
                           with_update=False)[0]
    _sync()
    moved = _check_labels_rows("codebook-tp2-gloo last sweep", x,
                               st.centroids, torch.bfloat16, st.labels,
                               labels)
    print(f"{_tp_line('codebook-tp2-gloo', run)}; the final labels one "
          f"card's pass at the same centroids but {moved} rows (ties); "
          f"launches {launches}", flush=True)


def _sharded_rank_tpfp(out):
    """TP×FP on a mesh (1, 2, 2) of four gloo ranks at TPFP_SHAPE: held to
    the single-device classic fit (rank 0), not timed."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init
    from kmeans_tpu_torch.parallel import fit_lloyd_sharded, make_mesh

    n, d, k = TPFP_SHAPE["n"], TPFP_SHAPE["d"], TPFP_SHAPE["k"]
    x, _, _ = kt.make_blobs(5, n, d, k, dtype=torch.bfloat16)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(5), x, k)
    mesh = make_mesh((1, 2, 2), ("data", "model", "feature"),
                     devices=["cuda:0"] * 4, backend="gloo")
    cfg = kt.KMeansConfig(k=k, update="matmul", compute_dtype="bfloat16")
    st = _sharded_run(mesh, "tpfp-4-gloo", out, lambda: fit_lloyd_sharded(
        x.cpu(), k, mesh=mesh, config=cfg, init=c0, max_iter=TPFP_SWEEPS,
        tol=-1.0, model_axis="model", feature_axis="feature"))
    run = out["runs"]["tpfp-4-gloo"]
    _check(run["valid_cols"]["K1"] >= TPFP_SWEEPS,
           f"tpfp-4-gloo: rank {mesh.rank}: {run}")
    if mesh.rank == 0:
        one = kt.fit_lloyd(x, k, config=cfg, init=c0, max_iter=TPFP_SWEEPS,
                           tol=-1.0)
        moved, err, rel = _hold_to_single("tpfp-4-gloo", x, st, one,
                                          torch.bfloat16)
        print(f"tpfp-4-gloo: a (1, 2, 2) mesh of four gloo ranks at n = "
              f"{n}, d = {d}, k = {k}, {TPFP_SWEEPS} classic sweeps: "
              f"{moved} labels moved against the single-device fit (ties), "
              f"centroids max abs diff {err:.3e}, inertia rel {rel:.3e}; "
              f"K1 launches with valid_cols {run['valid_cols']['K1']} "
              f"(rank 0)", flush=True)


def _sharded_world(world, tmp, extra=None):
    """Spawn a gloo world of ``world`` ranks on the one card
    (``--sharded-rank``) and wait for it; a rank that fails stops the
    rest.  Returns each rank's record."""
    import os

    from kmeans_tpu_torch.parallel.mesh import free_port

    spec = dict(extra or {}, world=world,
                out=f"{tmp}/sharded-{world}-rank%d.json")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               PYTHONUNBUFFERED="1")
    env.pop("KMEANS_TPU_FAULTS", None)
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-rank",
         json.dumps(spec)], cwd=root,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(world)]
    return procs, spec


def _wait_world(name, procs, spec):
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    _check(all(rc == 0 for rc in rcs), f"{name}: rank exit codes {rcs}")
    out = []
    for r in range(len(procs)):
        with open(spec["out"] % r, encoding="utf-8") as f:
            out.append(json.load(f))
    return out


def _sharded_cli(tmp):
    """train-mesh (phase 16): ``cli train --mesh 2 --device cpu`` for
    accelerated, trimmed, ``--stream`` and ``--ckpt-dir`` with a cut and a
    resume, each against its ``--mesh 1`` run (the elastic one against the
    uninterrupted elastic run), all in CPU processes.  Returns the
    processes' records."""
    import os

    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    npy = f"{tmp}/train-mesh-x.npy"
    rng = np.random.default_rng(3)
    centres = rng.uniform(-10, 10, size=(8, 16))
    np.save(npy, (centres[rng.integers(0, 8, 6000)]
                  + 0.5 * rng.normal(size=(6000, 16))).astype(np.float32))
    base = ["train", *SHARDED_CLI_SMALL]
    stream = ["train", "--stream", "--input", npy, "--k", "8", "--steps",
              "40", "--batch-size", "512", "--seed", "3", "--device", "cpu"]
    elastic = base + ["--update", "matmul", "--tol", "-1", "--max-iter",
                      "12", "--ckpt-every", "4", "--mesh", "2"]
    ck = f"{tmp}/train-mesh-ck"
    runs = {
        "accelerated": base + ["--model", "accelerated", "--mesh", "2"],
        "accelerated 1": base + ["--model", "accelerated"],
        "trimmed": base + ["--model", "trimmed", "--mesh", "2"],
        "trimmed 1": base + ["--model", "trimmed"],
        "stream": stream + ["--mesh", "2"],
        "stream 1": stream,
        "elastic": elastic + ["--ckpt-dir", f"{tmp}/train-mesh-whole"],
        "elastic cut": elastic + ["--ckpt-dir", ck],
    }

    def start(argv, env=None):
        return subprocess.Popen(
            [sys.executable, "-m", "kmeans_tpu_torch.cli", *argv], cwd=root,
            env=dict(os.environ, **(env or {})), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    t0 = time.perf_counter()
    procs = {name: start(argv, {"KMEANS_TPU_FAULTS": ELASTIC_FAULT}
                         if name == "elastic cut" else None)
             for name, argv in runs.items()}
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=CLI_TIMEOUT_S) + (
                p.returncode,)
        p = start(elastic + ["--ckpt-dir", ck, "--resume", ck])
        outs["elastic resumed"] = p.communicate(timeout=CLI_TIMEOUT_S) + (
            p.returncode,)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    return outs, secs


def _check_sharded_cli(outs, secs):
    def result(name):
        out, err, rc = outs[name]
        _check(rc == 0, f"train-mesh {name}: exit {rc}, stderr "
               f"{err.strip().splitlines()[-4:]}")
        lines = out.strip().splitlines()
        _check(len(lines) == 1, f"train-mesh {name}: {len(lines)} result "
               "lines (rank 0 alone prints one)")
        return json.loads(lines[0])

    for model in ("accelerated", "trimmed", "stream"):
        two, one = result(model), result(f"{model} 1")
        same = ("n", "d", "k", "n_iter", "mode")
        _check({f: two[f] for f in same} == {f: one[f] for f in same}
               and two["mesh"] == 2
               and abs(two["inertia"] - one["inertia"])
               <= FIT_INERTIA_RTOL * one["inertia"],
               f"train-mesh {model}: {two} against --mesh 1 {one}")
        print(f"train-mesh {model}: --mesh 2 {two}; --mesh 1 {one}")
    _, err, rc = outs["elastic cut"]
    _check(rc == 3 and "--resume" in err,
           f"train-mesh elastic cut: exit {rc}, {err.strip()[-300:]}")
    whole, resumed = result("elastic"), result("elastic resumed")
    _check(resumed["n_iter"] == whole["n_iter"]
           and resumed["inertia"] == whole["inertia"],
           f"train-mesh elastic: resumed {resumed} against {whole}")
    print(f"train-mesh elastic: --ckpt-dir cut at sweep 8 (exit 3), "
          f"--resume to {resumed['n_iter']} sweeps: {resumed}, the "
          f"uninterrupted run's inertia exactly; every run: {secs:.1f} s")


def phase_sharded(card):
    """Phase 16: the rest of the sharded engine (see the module
    docstring).  Returns the runs' launches by compute: ``{"bf16": {...},
    "f32": {...}}``; no number of it is a scaling number (one card)."""
    import shutil
    import tempfile
    import threading

    import torch
    import torch.distributed as dist

    from kmeans_tpu_torch.parallel import make_mesh

    t_all = time.perf_counter()
    totals = {"bf16": {}, "f32": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    cli = cut_thread = None
    procs4, procs, cut_box = [], [], {}

    def cut():
        try:
            cut_box["done"] = _elastic_cuts(tmp)
        except BaseException as e:  # allow-silent-except: re-raised below
            cut_box["error"] = e

    try:
        # What needs nothing of this process starts first (since PR 19):
        # train-mesh's CPU processes, the drill's two cut children and the
        # four-rank world, beside the in-process runs (their times share
        # the host with them; the mesh/one-card ratios are taken in one
        # call on both sides).
        cli_out = {}
        cli = threading.Thread(
            target=lambda: cli_out.update(zip(("outs", "secs"),
                                              _sharded_cli(tmp))))
        cli.start()
        cut_thread = threading.Thread(target=cut)
        cut_thread.start()
        procs4, spec4 = _sharded_world(4, tmp)
        x, c0 = _headline_data()
        mesh = make_mesh((1, 1), ("data", "model"))
        _check(mesh.backend == "nccl", f"phase 16: {mesh}")
        _add_counts(totals["bf16"], _sharded_accel(card, mesh, x, c0))
        launches, whole = _elastic_whole(card, mesh, x, c0, tmp)
        _add_counts(totals["bf16"], launches)
        dist.destroy_process_group()
        cut_thread.join()
        if "error" in cut_box:
            raise cut_box["error"]
        launches, specs, cuts = cut_box["done"]
        _add_counts(totals["bf16"], launches)
        # The two-rank world resumes the cut bundle: it starts after the
        # cut, beside the resumes.
        procs, spec = _sharded_world(2, tmp, dict(
            elastic_ck=f"{tmp}/elastic-gloo",
            elastic_whole=whole["matmul"]))
        _add_counts(totals["bf16"],
                    _elastic_resumes(card, tmp, specs, cuts, whole))
        del x, c0
        torch.cuda.empty_cache()
        ranks4 = _wait_world("tpfp-4-gloo", procs4, spec4)
        ranks = _wait_world("phase 16's gloo world", procs, spec)
        for rank in ranks + ranks4:
            for name, rec in rank["runs"].items():
                _add_counts(totals["f32" if "stream" in name else "bf16"],
                            rec["launches"])
        for name in ranks[0]["runs"]:
            for r, rank in enumerate(ranks):
                rec = rank["runs"][name]
                split = (f"a sweep: {_split_line(rec['split'])}; "
                         if rec["split"] else "")
                print(f"{name} rank {r}: {rec['seconds']:.3f} s; {split}"
                      f"collectives {rec['stats']}; launches "
                      f"{rec['launches']}")
        print(f"codebook-dp2-gloo after C4 ({card}): each rank's peak card "
              f"memory from its data on (its own 640,000 rows placed from "
              f"host memory; phase 15 kept the full x on each rank: "
              f"10.1-10.7 GB): "
              f"{[round(r['codebook_peak_gb'], 3) for r in ranks]} GB")
        cli.join(timeout=CLI_TIMEOUT_S)
        _check("outs" in cli_out, "train-mesh: the CLI runs did not end")
        _check_sharded_cli(cli_out["outs"], cli_out["secs"])
    finally:
        # On a failure too: the worlds end, and the children and the CPU
        # processes before the phase does.
        for p in procs4 + procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for thread in (cut_thread, cli):
            if thread is not None:
                thread.join(timeout=CLI_TIMEOUT_S)
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_all
    print(f"phase 16 ({card}): {secs:.1f} s (two and four ranks share one "
          f"card: no number here is a scaling number); launches {totals}")
    return totals


# ---------------------------------------------------------------------------
# Phase 17: the Lloyd-based families and model selection
# ---------------------------------------------------------------------------

#: BASELINE.json's glove config (the spherical family's), and mnist's.
GLOVE = dict(n=400_000, d=300, k=1000)
MNIST = dict(n=60_000, d=784, k=10)
#: Sweeps of each spherical fit (tol -1: every one runs): 21 K1 passes.
SPHERE_SWEEPS = 20
#: glove-bisecting's k and the k of its hold against the plain backend.
BISECT_K = 1000
BISECT_HOLD_K = 32
#: glove-xmeans / -gmeans: the generating blobs, k_max, and the rows their
#: hold against the plain backend runs on.  k_max is cut from 1000 to fit
#: the phase's time: at 1000 x-means took 56.9 s to find the 256 blobs and
#: g-means ran to k_max in 27.5 s (it splits blobs of ≈ 5 rows a
#: dimension: the 2-means axis makes their projection non-normal), and
#: their holds 114 s more (NVIDIA H100 80GB HBM3, 700.00 W).
AUTOK_BLOBS = 256
AUTOK_K_MAX = 64
AUTOK_HOLD_ROWS = 50_000
#: mnist-sweep: ``cli sweep``'s range and seeding, and the blobs' spread.
#: k-means++ misses one of ten blobs in d = 784 about one late draw in
#: five at unit spread (a blob's own D² is 2·d·σ², ≈ 1568, against ≈ 5e4
#: between blobs), and a sweep then suggests 9; k-means|| oversamples.
SWEEP_RANGE = ["--k-min", "2", "--k-max", "16", "--init", "k-means||"]
SWEEP_STD = 0.5
#: Tolerances of the sweep rows' recomputation in f64: the port scores in
#: f32 from the expanded product ‖x‖² − 2x·y + ‖y‖², which rounds at
#: ‖x‖²'s scale (≈ 2.6e4 at mnist's width) against distances of ≈ 20.
#: Davies–Bouldin divides by centroid distances taken the same way (the
#: reference's f32 Gram): two centroids of one blob (k above 10) are close,
#: so its bound adds 4·2⁻²⁴·(‖cᵢ‖² + ‖cⱼ‖²) / ‖cᵢ − cⱼ‖², the largest over
#: the row's centroid pairs.
SWEEP_SIL_ATOL = 1e-4
SWEEP_DISPERSION_RTOL = 1e-4
#: The gap statistic overshoots the 10 blobs at this width: splitting one
#: Gaussian blob of 6,000 rows in 784 dims cuts its SSE by ≈ (2/π)·1.85/784
#: (the sample covariance's top eigenvalue, inflated by d/n), 1.5e-4 of
#: W at k = 10, more than a split of the uniform reference set cuts its W
#: (≈ (3/4)/784/10 = 9.6e-5), so Gap(11) > Gap(10) + s on Gaussian blobs
#: (the card's run suggested 11).  It must not undershoot.
SWEEP_GAP_OVER = 2
#: The gloo world's bisecting k (31 splits, each an engine fit and assign).
FAM_GLOO_BISECT_K = 32
#: train-mesh: ``cli train`` at a small shape, ``--mesh 2 --device cpu``.
FAMILIES_CLI_SMALL = ["--n", "4000", "--d", "16", "--seed", "3",
                      "--device", "cpu"]


def _glove(seed, k_gen):
    """glove-shaped f32 blobs on the card and their generating centres."""
    import kmeans_tpu_torch as kt

    x, _, centres = kt.make_blobs(seed, GLOVE["n"], GLOVE["d"], k_gen)
    return x, centres


def _sphere_c0(centres, seed):
    """The fixed unit-norm init: each generating centre moved by a tenth of
    a unit normal, normalized (near the blobs, so no label of the fits is
    left to a tie between the devices' summation orders)."""
    import torch

    from kmeans_tpu_torch.models.spherical import normalize_rows

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return normalize_rows(centres + 0.1 * torch.randn(
        centres.shape, generator=gen, device="cuda"))


def _unit_norms(name, c):
    err = float((c.double().norm(dim=1) - 1.0).abs().max())
    _check(err <= 1e-6, f"{name}: a centroid's norm is off 1 by {err}")
    return err


def _timed_fit(fn):
    """``(state, CUDA-event ms, launches)`` of one fit, the counts set to 0
    just before and read just after."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    _sync()
    K.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    st = fn()
    end.record()
    end.synchronize()
    return st, start.elapsed_time(end), K.launch_counts()


def _only(name, counts, want):
    """The run launched exactly ``want`` (name -> count) and nothing
    else."""
    got = {k: v for k, v in counts.items() if v}
    _check(got == want, f"{name}: launches {got}, wanted {want}")


def _glove_spherical(card, x, centres, totals):
    """glove-spherical in f32 (K1's f32 route) and bf16 (``score_block``):
    SPHERE_SWEEPS sweeps from a fixed unit-norm init, held to the same fit
    on ``backend="plain"`` on the card."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.spherical import normalize_rows
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    k = GLOVE["k"]
    c0 = _sphere_c0(centres, 21)
    for cd, compute, core in (("float32", "f32", "wgmma"),
                              ("bfloat16", "bf16", "score_block")):
        dt = getattr(torch, cd)
        norm_ms, xn = _time_auto(lambda: normalize_rows(x, dtype=dt))
        # One pass first, outside the counts: the route's first call.
        kt.lloyd_pass(xn, c0, compute_dtype=dt, device="cuda")
        got_core = (K.scoring_core(xn, dt, torch.empty(3, GLOVE["d"],
                                                       device="cuda"))
                    if cd == "float32" else K.scoring_core(xn, dt))
        _check(got_core == core, f"glove-spherical {cd}: K1 on {got_core}")
        fits = {}
        for backend in ("auto", "plain"):
            cfg = kt.KMeansConfig(k=k, compute_dtype=cd, backend=backend)
            fits[backend] = _timed_fit(lambda: kt.fit_spherical(
                x, k, init=c0, config=cfg, tol=-1.0,
                max_iter=SPHERE_SWEEPS))
        (st, ms, counts), (pst, pms, pcounts) = fits["auto"], fits["plain"]
        _only(f"glove-spherical {cd}", counts,
              {"lloyd_pass_cuda": SPHERE_SWEEPS + 1})
        _only(f"glove-spherical {cd} plain", pcounts, {})
        _add_counts(totals[compute], counts)
        _check(int(st.n_iter) == int(pst.n_iter) == SPHERE_SWEEPS,
               f"glove-spherical {cd}: sweeps {int(st.n_iter)}, plain "
               f"{int(pst.n_iter)}")
        moved, _ = _check_labels_pair(f"glove-spherical {cd}", xn,
                                      st.centroids, st.labels,
                                      pst.centroids, pst.labels, dt)
        err = _close(f"glove-spherical {cd} centroids", st.centroids,
                     pst.centroids)
        norm_err = _unit_norms(f"glove-spherical {cd}", st.centroids)
        if cd == "float32":
            _silhouette_forms(card, xn, st.labels, k)
        del xn
        passes = SPHERE_SWEEPS + 1
        print(f"glove-spherical {cd} ({card}): n={GLOVE['n']} d="
              f"{GLOVE['d']} k={k}, {SPHERE_SWEEPS} sweeps, K1 on "
              f"{got_core}: {ms:.3f} ms in all, {(ms - norm_ms) / passes:.3f}"
              f" ms a pass ({passes} passes) after the {norm_ms:.3f} ms "
              f"normalization; plain {pms:.3f} ms; launches {counts}; "
              f"{moved} labels differ from the plain fit (ties), centroids "
              f"within {err:.3e}, norms within {norm_err:.1e} of 1; inertia "
              f"{float(st.inertia):.6e} / plain {float(pst.inertia):.6e}")


#: sweep_k's silhouette sample and chunk.
SIL_SAMPLE = 10_000
SIL_CHUNK = 4096


def _silhouette_forms(card, x, labels, k):
    """sweep_k's silhouette at glove (SIL_SAMPLE rows against every row,
    k = 1000): the port's one-hot product of each distance tile (2·m·n·k
    flops, IEEE f32, as the reference forms it), twice on one sample,
    equal bit for bit, and against the same sample's silhouette in f64."""
    import torch

    from kmeans_tpu_torch import metrics as M

    gen = torch.Generator(device="cuda").manual_seed(5)
    idx = M.sample_rows(gen, x.shape[0], SIL_SAMPLE, x.device)
    valid = torch.ones(x.shape[0], dtype=torch.bool, device="cuda")

    def score():
        return M._silhouette_samples(x[idx], labels[idx], x, labels, valid,
                                     k=k, chunk_size=SIL_CHUNK,
                                     compute_dtype=None).mean()

    s_ms, s = _time_auto(score)
    again = score()
    _check(torch.equal(s, again), f"silhouette at glove: two scores "
           f"{float(s)!r} and {float(again)!r}")
    want = _silhouette64(x, labels, idx, k)
    rel = abs(float(s) - want) / max(abs(want), 1e-30)
    _check(rel <= SCORE_RTOL, f"silhouette at glove: {float(s)} against "
           f"f64 {want}")
    print(f"silhouette at glove ({card}): {SIL_SAMPLE} sampled rows against "
          f"{x.shape[0]}, k={k}, chunks of {SIL_CHUNK}: the one-hot product "
          f"(IEEE f32) {s_ms:.3f} ms; {float(s):.6f}, a second call equal "
          f"bit for bit; f64 {want:.6f} (within {rel:.1e})")


def _imagenet_spherical(card, totals):
    """imagenet-spherical: the headline bf16 data on the Hopper core,
    SPHERE_SWEEPS sweeps; the card's peak memory of the chunked
    normalization beside the whole-array f32 one it replaces."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.spherical import normalize_rows

    x, c0 = _headline_data()
    n, k = HEADLINE["n"], HEADLINE["k"]
    _sync()

    def peak(fn):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        _sync()
        return out, (torch.cuda.max_memory_allocated() - base) / 1e9

    def whole():
        xf = x.float()
        return (xf / (xf * xf).sum(-1, keepdim=True).sqrt().clamp_min(
            1e-12)).to(torch.bfloat16)

    want, whole_gb = peak(whole)
    got, chunk_gb = peak(lambda: normalize_rows(x, dtype=torch.bfloat16))
    # One pass first, outside the counts: the route's first call.
    kt.lloyd_pass(got, c0.float(), compute_dtype=torch.bfloat16,
                  device="cuda")
    _check(_equal(got, want), "imagenet-spherical: the chunked "
           "normalization's bits differ from the whole-array one's")
    del got, want
    torch.cuda.empty_cache()
    cfg = kt.KMeansConfig(k=k, compute_dtype="bfloat16")
    (st, ms, counts), fit_gb = peak(lambda: _timed_fit(
        lambda: kt.fit_spherical(x, k, init=c0, config=cfg, tol=-1.0,
                                 max_iter=SPHERE_SWEEPS)))
    _only("imagenet-spherical", counts, {"lloyd_pass_cuda": SPHERE_SWEEPS + 1})
    _add_counts(totals["bf16"], counts)
    _check(_finite(st.centroids) and math.isfinite(float(st.inertia))
           and int(st.counts.sum()) == n, "imagenet-spherical: result")
    norm_err = _unit_norms("imagenet-spherical", st.centroids)
    print(f"imagenet-spherical bf16 ({card}): n={n} d={HEADLINE['d']} k={k}, "
          f"{SPHERE_SWEEPS} sweeps: {ms:.3f} ms in all, "
          f"{ms / (SPHERE_SWEEPS + 1):.3f} ms a pass with the normalization "
          f"(K1 yardstick 10.459 ms); launches {counts}; norms within "
          f"{norm_err:.1e} of 1; peak card memory above x (5.24 GB): the "
          f"fit {fit_gb:.3f} GB, the chunked normalization alone "
          f"{chunk_gb:.3f} GB, the whole-array f32 one it replaces "
          f"{whole_gb:.3f} GB")
    del x, c0, st
    torch.cuda.empty_cache()


def _busy_share(fn):
    """``(fn(), wall seconds, the share of the wall time the card ran
    kernels)`` under ``torch.profiler`` (CUPTI): the sum of the device
    records over the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        _sync()
        wall = time.perf_counter() - t0
    busy = sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6
    _check(busy > 0, "the profiler recorded no device time")
    return out, wall, busy / wall


def _split_members():
    """Wrap ``kmeans_tpu_torch.models.bisecting.fit_lloyd`` to record each
    inner fit's member count (its weights' support): the split sequence.
    Returns ``(records, undo)``."""
    import kmeans_tpu_torch.models.bisecting as B

    real = B.fit_lloyd
    seen = []

    def fit_lloyd(x, k, **kw):
        w = kw.get("weights")
        seen.append(int((w > 0).sum()) if w is not None else -1)
        return real(x, k, **kw)

    B.fit_lloyd = fit_lloyd

    def undo():
        B.fit_lloyd = real
    return seen, undo


def _inertia64(x, labels, c):
    """Σ ‖x − c[label]‖² in f64, a block of rows at a time."""
    total = 0.0
    for lo in range(0, x.shape[0], 65536):
        diff = x[lo:lo + 65536].double() - c[labels[lo:lo + 65536].long()
                                             ].double()
        total += float((diff * diff).sum())
    return total


def _glove_bisecting(card, x, totals):
    """glove-bisecting in f32: BISECT_K leaves (each split a masked 2-means
    over all the rows and an assign), its invariants; then at
    BISECT_HOLD_K the kernels against ``backend="plain"`` from the same
    generator (the same split sequence), under the profiler for the host's
    share; then one bf16 run, which the weights veto sends to the plain
    route."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops.plan import WEIGHTS_VETO

    n = x.shape[0]
    cfg = kt.KMeansConfig(k=BISECT_K, seed=0)
    t0 = time.perf_counter()
    st, counts = _counted_run(lambda: kt.fit_bisecting(x, BISECT_K,
                                                       config=cfg))
    secs = time.perf_counter() - t0
    _add_counts(totals["f32"], counts)
    for kname in ("lloyd_pass_cuda", "lloyd_delta_cuda"):
        _check(counts.get(kname, 0) > 0,
               f"glove-bisecting: {kname} never launched: {counts}")
    splits = int(st.n_iter)
    _check(abs(float(st.counts.sum()) - n) < 0.5,
           f"glove-bisecting: counts sum to {float(st.counts.sum())}")
    want = _inertia64(x, st.labels, st.centroids)
    rel = abs(float(st.inertia) - want) / want
    _check(rel <= FIT_INERTIA_RTOL, f"glove-bisecting: inertia "
           f"{float(st.inertia)!r} against f64 {want!r} ({rel:.3e})")
    print(f"glove-bisecting f32 ({card}): n={n} d={x.shape[1]} "
          f"k={BISECT_K}: {splits} splits in {secs:.3f} s "
          f"({1e3 * secs / max(splits, 1):.3f} ms a split); launches "
          f"{counts}; counts sum to n, inertia within {rel:.2e} of f64")

    # The hold runs on glove-shaped rows of BISECT_HOLD_K blobs: each split
    # then parts whole blobs, so no row's side is left to a tie.  (A 2-means
    # of many blobs can cut through one, and the routes' f32 orders then
    # walk to different local optima: the k = 1000 data's first split did.)
    xh, _ = _glove(5, BISECT_HOLD_K)
    runs = {}
    for backend in ("auto", "plain"):
        seen, undo = _split_members()
        hcfg = kt.KMeansConfig(k=BISECT_HOLD_K, seed=0, backend=backend)

        def run():
            return _counted_run(lambda: kt.fit_bisecting(
                xh, BISECT_HOLD_K, config=hcfg))
        try:
            # Only the kernels' run is profiled: the plain route's many
            # small launches would swamp the trace.
            if backend == "auto":
                (hst, hcounts), wall, busy = _busy_share(run)
            else:
                t0 = time.perf_counter()
                hst, hcounts = run()
                wall, busy = time.perf_counter() - t0, float("nan")
        finally:
            undo()
        runs[backend] = (hst, hcounts, wall, busy, seen)
    (a, ac, aw, ab, aseen), (p, pc, pw, pb, pseen) = (runs["auto"],
                                                      runs["plain"])
    _add_counts(totals["f32"], ac)
    _only("glove-bisecting hold plain", pc, {})
    _check(aseen == pseen, f"glove-bisecting k={BISECT_HOLD_K}: split "
           f"member counts {aseen[:8]}... against plain {pseen[:8]}...")
    rel = abs(float(a.inertia) - float(p.inertia)) / float(p.inertia)
    _check(rel <= FIT_INERTIA_RTOL, f"glove-bisecting k={BISECT_HOLD_K}: "
           f"inertia {float(a.inertia)!r} against plain {float(p.inertia)!r}")
    moved = int((a.labels != p.labels).sum())
    del xh
    print(f"glove-bisecting k={BISECT_HOLD_K} ({card}; {BISECT_HOLD_K} "
          f"generating blobs): {int(a.n_iter)} "
          f"splits, the plain backend's split sequence ({len(aseen)} inner "
          f"fits, member counts equal); {aw:.3f} s under the profiler, the "
          f"card busy {ab:.3f} of it (host share {1 - ab:.3f}); plain "
          f"{pw:.3f} s; launches {ac}; inertia within {rel:.2e}, {moved} "
          "labels differ")

    # bf16: the inner fits' 0/1 masks are weights the fit is not told are
    # binary, so the reference's exactness policy refuses the kernels.
    xs = x[:20_000].to(torch.bfloat16)
    bcfg = kt.KMeansConfig(k=8, seed=0, compute_dtype="bfloat16")
    mask = (torch.arange(xs.shape[0], device="cuda") % 2).float()
    plan = kt.fit_plan(xs, 2, config=kt.KMeansConfig(
        k=2, compute_dtype="bfloat16", empty="keep"), weights=mask)
    _check(plan["backend"] == "plain" and plan["why"] == WEIGHTS_VETO,
           f"bf16 bisecting's inner fit: plan {plan}")
    runs = []
    for _ in range(2):
        seen, undo = _split_members()
        try:
            runs.append(_counted_run(lambda: kt.fit_bisecting(
                xs, 8, config=bcfg)) + (seen,))
        finally:
            undo()
    (bst, bcounts, bseen), (again, _, aseen) = runs
    # Only the assigns (no weights) run a kernel: K1, once a split and
    # once for the root.  The repeat's launches join no row.
    _only("bf16 bisecting", bcounts,
          {"lloyd_pass_cuda": int(bst.n_iter) + 1})
    _add_counts(totals["bf16"], bcounts)
    _check(bseen == aseen and torch.equal(bst.centroids, again.centroids)
           and torch.equal(bst.labels, again.labels),
           f"bf16 bisecting: a second run differs (split member counts "
           f"{bseen} against {aseen})")
    print(f"bf16 bisecting (n={xs.shape[0]}, k=8): the inner fits' plan "
          f"{plan['backend']} / {plan['update']} ({plan['why']}): no inner "
          f"fit launched a kernel; the assigns' K1 {bcounts}; a second run "
          "the same split sequence, centroids and labels bit for bit")


def _glove_autok(card, totals):
    """glove-xmeans and glove-gmeans in f32 on AUTOK_BLOBS generating blobs
    (k_min 1, k_max AUTOK_K_MAX), each held to ``backend="plain"`` on the
    first AUTOK_HOLD_ROWS rows from the same generator."""
    import torch

    import kmeans_tpu_torch as kt

    x, _ = _glove(8, AUTOK_BLOBS)
    for family in ("xmeans", "gmeans"):
        fit = getattr(kt, f"fit_{family}")
        cfg = kt.KMeansConfig(k=1, seed=0)
        t0 = time.perf_counter()
        st, counts = _counted_run(lambda: fit(x, AUTOK_K_MAX, config=cfg))
        secs = time.perf_counter() - t0
        _add_counts(totals["f32"], counts)
        _check(counts.get("lloyd_pass_cuda", 0) > 0
               and counts.get("lloyd_delta_cuda", 0) > 0,
               f"glove-{family}: launches {counts}")
        k_found = int(st.centroids.shape[0])
        _check(_finite(st.centroids) and int(st.counts.sum()) == x.shape[0],
               f"glove-{family}: result")
        held = {}
        for backend in ("auto", "plain"):
            hcfg = kt.KMeansConfig(k=1, seed=0, backend=backend)
            held[backend] = _counted_run(lambda: fit(
                x[:AUTOK_HOLD_ROWS], AUTOK_K_MAX, config=hcfg))
        (a, ac), (p, pc) = held["auto"], held["plain"]
        _add_counts(totals["f32"], ac)
        _only(f"glove-{family} hold plain", pc, {})
        ka, kp = int(a.centroids.shape[0]), int(p.centroids.shape[0])
        rel = abs(float(a.inertia) - float(p.inertia)) / float(p.inertia)
        _check(ka == kp and rel <= FIT_INERTIA_RTOL,
               f"glove-{family} on {AUTOK_HOLD_ROWS} rows: k {ka} against "
               f"plain {kp}, inertia {float(a.inertia)!r} against "
               f"{float(p.inertia)!r}")
        print(f"glove-{family} f32 ({card}): n={x.shape[0]}, {AUTOK_BLOBS} "
              f"generating blobs, k_max={AUTOK_K_MAX}: k={k_found} in "
              f"{int(st.n_iter)} rounds (converged {bool(st.converged)}), "
              f"{secs:.3f} s; launches {counts}; on the first "
              f"{AUTOK_HOLD_ROWS} rows k={ka} as the plain backend's, "
              f"inertia within {rel:.2e}")
    del x
    torch.cuda.empty_cache()


def _sweep_cli(spec) -> int:
    """``chip_smoke.py --sweep-cli SPEC``: ``cli.main(["sweep", ...])``
    with the launch counts set to 0 before it and written to
    ``spec["counts"]`` after it, every fit's labels and centroids and every
    silhouette sample written to ``spec["dump"]`` (torch.save), and each
    row's seconds (from its fit's start to the next's) in the dump."""
    import torch

    import kmeans_tpu_torch.models as models
    from kmeans_tpu_torch import cli
    from kmeans_tpu_torch import metrics as M
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    fits, samples, starts, gmms = [], [], [], []
    real_fit, real_sample = models.fit_lloyd, M.sample_rows
    real_gmm = models.fit_gmm

    def fit_lloyd(x, k, **kw):
        starts.append(time.perf_counter())
        st = real_fit(x, k, **kw)
        fits.append((st.labels.cpu(), st.centroids.cpu()))
        return st

    def fit_gmm(x, k, **kw):
        starts.append(time.perf_counter())
        st = real_gmm(x, k, **kw)
        gmms.append((st.means.cpu(), st.covariances.cpu(),
                     st.mix_weights.cpu()))
        return st

    def sample_rows(*a, **kw):
        idx = real_sample(*a, **kw)
        samples.append(idx.cpu())
        return idx

    models.fit_lloyd, M.sample_rows = fit_lloyd, sample_rows
    models.fit_gmm = fit_gmm
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = cli.main(spec["argv"])
    finally:
        ends = starts[1:] + [time.perf_counter()]
        with open(spec["counts"], "w", encoding="utf-8") as f:
            json.dump(K.launch_counts(), f)
        torch.save({"fits": fits, "samples": samples, "gmm": gmms,
                    "seconds": [e - s for s, e in zip(starts, ends)],
                    "total": time.perf_counter() - t0}, spec["dump"])
    return rc or 0


def _silhouette64(x, labels, idx, k):
    """The sampled silhouette of ``idx`` against every row, in f64."""
    import torch

    x64 = x.double()
    lab = labels.long()
    xe = x64[idx.long()]
    own = lab[idx.long()]
    counts = torch.bincount(lab, minlength=k).double()
    sums = torch.zeros(xe.shape[0], k, dtype=torch.float64, device="cuda")
    xe_sq = (xe * xe).sum(1)
    for lo in range(0, x64.shape[0], 4096):
        xb = x64[lo:lo + 4096]
        d2 = (xe_sq[:, None] - 2.0 * xe @ xb.T
              + (xb * xb).sum(1)[None, :]).clamp_min(0.0)
        sums.index_add_(1, lab[lo:lo + 4096], d2.sqrt())
    rows = torch.arange(xe.shape[0], device="cuda")
    a = sums[rows, own] / (counts[own] - 1.0).clamp_min(1.0)
    other = torch.where(counts[None, :] > 0,
                        sums / counts.clamp_min(1.0)[None, :], torch.inf)
    b = torch.where(own[:, None] == torch.arange(k, device="cuda"),
                    torch.inf, other).amin(1)
    s = (b - a) / torch.maximum(a, b).clamp_min(1e-30)
    return float(torch.where(counts[own] <= 1.0, 0.0, s).mean())


def _dispersion64(x, labels, c):
    """(Davies–Bouldin, Calinski–Harabasz) at centroids ``c`` in f64."""
    import torch

    x64, c64, lab = x.double(), c.double(), labels.long()
    k = c64.shape[0]
    counts = torch.bincount(lab, minlength=k).double()
    dist = torch.zeros(k, dtype=torch.float64, device="cuda").index_add_(
        0, lab, (x64 - c64[lab]).norm(dim=1))
    nz = counts > 0
    s = torch.where(nz, dist / counts.clamp_min(1.0), 0.0)
    cd = torch.cdist(c64, c64)
    ratio = (s[:, None] + s[None, :]) / torch.where(cd > 0, cd, torch.inf)
    both = nz[:, None] & nz[None, :] & ~torch.eye(k, dtype=torch.bool,
                                                  device="cuda")
    db = float((torch.where(both, ratio, -torch.inf).amax(1).clamp_min(0.0)
                * nz).sum() / nz.sum())
    wss = float(((x64 - c64[lab]) ** 2).sum())
    mean = x64.mean(0)
    bss = float((counts * ((c64 - mean) ** 2).sum(1)).sum())
    k_eff = max(int(nz.sum()), 2)
    ch = (bss / max(k_eff - 1, 1)) / max(wss / max(x64.shape[0] - k_eff, 1),
                                         1e-30)
    return db, ch


def _mnist_sweep(card, tmp, totals):
    """mnist-sweep: ``cli sweep`` in child processes on an mnist-shaped
    ``.npy`` (MNIST's shape, its 10 generating blobs), SWEEP_RANGE, once
    by silhouette and once by the gap statistic (3 reference sets): each
    silhouette row's score (on the child's own sample), DB and CH
    recomputed in f64 on the card from its fit's labels and centroids, and
    each gap row's log W from its data fit's in f64 (within SCORE_RTOL of
    the rows' ‖x‖² + ‖c‖², over W).  The silhouette
    suggests 10; the gap statistic 10 or more (see SWEEP_GAP_OVER)."""
    import os

    import numpy as np
    import torch

    import kmeans_tpu_torch as kt

    x, _, _ = kt.make_blobs(17, MNIST["n"], MNIST["d"], MNIST["k"],
                            cluster_std=SWEEP_STD)
    npy = f"{tmp}/mnist.npy"
    np.save(npy, x.cpu().numpy())
    root = os.path.dirname(os.path.abspath(__file__))
    for crit, extra in (("silhouette", []), ("gap", ["--gap-refs", "3"])):
        spec = {"argv": ["sweep", "--input", npy, *SWEEP_RANGE,
                         "--criterion", crit, *extra],
                "counts": f"{tmp}/sweep-{crit}.counts.json",
                "dump": f"{tmp}/sweep-{crit}.pt"}
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--sweep-cli",
             json.dumps(spec)], cwd=root, capture_output=True, text=True,
            timeout=CLI_TIMEOUT_S)
        secs = time.perf_counter() - t0
        _check(out.returncode == 0, f"mnist-sweep {crit}: exit "
               f"{out.returncode}, stderr {out.stderr[-2000:]}")
        lines = [json.loads(ln) for ln in out.stdout.strip().splitlines()]
        rows, last = lines[:-1], lines[-1]
        counts = json.load(open(spec["counts"], encoding="utf-8"))
        dump = torch.load(spec["dump"])
        _add_counts(totals["f32"], counts)
        _check(counts.get("lloyd_pass_cuda", 0) > 0,
               f"mnist-sweep {crit}: launches {counts}")
        least = MNIST["k"]
        most = MNIST["k"] + (SWEEP_GAP_OVER if crit == "gap" else 0)
        _check(list(last) == ["suggested_k"]
               and least <= last["suggested_k"] <= most,
               f"mnist-sweep {crit}: suggested {last}")
        worst, worst_tol = [0.0, 0.0, 0.0], 0.0
        if crit == "silhouette":
            # No sample where the rows are no more than the sample size:
            # the silhouette then runs over every row.
            samples = dump["samples"] or [
                torch.arange(x.shape[0])] * len(rows)
            _check(len(dump["fits"]) == len(rows) == len(samples),
                   f"mnist-sweep: {len(dump['fits'])} fits, "
                   f"{len(samples)} samples, {len(rows)} rows")
            for row, (lab, c), idx in zip(rows, dump["fits"], samples):
                lab, c = lab.cuda(), c.cuda()
                sil = _silhouette64(x, lab, idx.cuda(), row["k"])
                db, ch = _dispersion64(x, lab, c)
                c64 = c.double()
                csq = (c64 * c64).sum(1)
                cd2 = torch.cdist(c64, c64) ** 2
                off = ~torch.eye(c64.shape[0], dtype=torch.bool,
                                 device="cuda")
                db_tol = SWEEP_DISPERSION_RTOL + float(
                    (4 * 2.0 ** -24 * (csq[:, None] + csq[None, :])
                     / cd2.clamp_min(1e-30))[off].max())
                errs = (abs(row["silhouette"] - sil),
                        abs(row["davies_bouldin"] - db) / abs(db),
                        abs(row["calinski_harabasz"] - ch) / abs(ch))
                _check(errs[0] <= SWEEP_SIL_ATOL and errs[1] <= db_tol
                       and errs[2] <= SWEEP_DISPERSION_RTOL,
                       f"mnist-sweep k={row['k']}: silhouette "
                       f"{row['silhouette']} vs f64 {sil}, DB "
                       f"{row['davies_bouldin']} vs {db}, CH "
                       f"{row['calinski_harabasz']} vs {ch}")
                worst = [max(w, e) for w, e in zip(worst, errs)]
                worst_tol = max(worst_tol, db_tol)
        if crit == "gap":
            # gap_statistic fits the data, then each reference set, for
            # each k in turn: every (1 + refs)-th fit is a data fit.
            stride = 1 + int(extra[1])
            data_fits = dump["fits"][::stride]
            _check(len(data_fits) == len(rows),
                   f"mnist-sweep gap: {len(dump['fits'])} fits for "
                   f"{len(rows)} rows")
            for row, (lab, c) in zip(rows, data_fits):
                # Each row's score may be off SCORE_RTOL of ‖x‖² + ‖c‖²
                # (the f32 route's bound, phase 3), far above its own
                # ‖x − c‖² here: W within their sum, log W within that
                # over W.
                lab, c = lab.cuda(), c.cuda()
                w64 = _inertia64(x, lab, c)
                scale = float(((x.double() ** 2).sum(1) + (
                    c.double() ** 2).sum(1)[lab.long()]).sum())
                err = abs(math.log(w64) - row["log_w"])
                tol = SCORE_RTOL * scale / w64
                _check(err <= tol, f"mnist-sweep gap k={row['k']}: log W "
                       f"{row['log_w']} against f64 {math.log(w64)} "
                       f"(bound {tol:.2e})")
                worst[0] = max(worst[0], err)
                worst_tol = max(worst_tol, tol)
        per_row = dump["total"] / max(len(rows), 1)
        print(f"mnist-sweep --criterion {crit} ({card}): n={MNIST['n']} "
              f"d={MNIST['d']}, k {SWEEP_RANGE[1]}..{SWEEP_RANGE[3]}, "
              f"{SWEEP_RANGE[5]}: "
              f"{secs:.3f} s of process, {dump['total']:.3f} s in "
              f"cli.main, {per_row:.3f} s a row; suggested_k "
              f"{last['suggested_k']}; launches {counts}"
              + (f"; log W within {worst[0]:.2e} of f64 on the card "
                 f"(bound at most {worst_tol:.2e})"
                 if crit == "gap" else
                 f"; against f64 on the card: silhouette within "
                 f"{worst[0]:.2e}, DB {worst[1]:.2e} relative (bound at "
                 f"most {worst_tol:.2e}), CH {worst[2]:.2e} relative"))
    del x


def _spherical_dp1(card, x, centres, totals):
    """spherical-dp1-nccl: ``fit_spherical_sharded`` (the dense sweep) on
    an NCCL mesh of one against ``fit_spherical`` from the same init: the
    same K1 sweeps and one all-reduce a sweep, so bit for bit."""
    import torch.distributed as dist

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.parallel import fit_spherical_sharded, make_mesh

    k = GLOVE["k"]
    c0 = _sphere_c0(centres, 22)
    mesh = make_mesh((1, 1), ("data", "model"))
    _check(mesh.backend == "nccl", f"spherical-dp1: {mesh}")
    cfg = kt.KMeansConfig(k=k, update="matmul")
    try:
        # A sweep of each first, outside the counts: NCCL makes its
        # communicator at the first collective.
        for fn in (kt.fit_spherical, lambda *a, **kw: fit_spherical_sharded(
                *a, mesh=mesh, **kw)):
            fn(x, k, init=c0, config=cfg, tol=-1.0, max_iter=1)
        one = _timed_fit(lambda: kt.fit_spherical(
            x, k, init=c0, config=cfg, tol=-1.0, max_iter=SPHERE_SWEEPS))
        mesh.reset_stats()
        dp1 = _timed_fit(lambda: fit_spherical_sharded(
            x, k, mesh=mesh, init=c0, config=cfg, tol=-1.0,
            max_iter=SPHERE_SWEEPS))
        stats = {op: list(v) for op, v in mesh.stats.items()}
    finally:
        dist.destroy_process_group()
    (a, a_ms, a_counts), (b, b_ms, b_counts) = one, dp1
    _add_counts(totals["f32"], a_counts)
    _add_counts(totals["f32"], b_counts)
    _check(a_counts == b_counts, f"spherical-dp1: launches {b_counts} "
           f"against one card's {a_counts}")
    _check(_equal(a.labels, b.labels) and _equal(a.centroids, b.centroids)
           and _equal(a.counts, b.counts),
           "spherical-dp1: not bit for bit one card's fit")
    reduces = stats.get("all_reduce", [0])[0]
    _check(reduces >= SPHERE_SWEEPS, f"spherical-dp1: collectives {stats}")
    print(f"spherical-dp1-nccl ({card}): {SPHERE_SWEEPS} sweeps at glove: "
          f"{b_ms:.3f} ms against fit_spherical's {a_ms:.3f} ms "
          f"({b_ms / a_ms:.3f}x); bit for bit; launches {b_counts}; "
          f"collectives {stats}")


def _families_rank(spec) -> int:
    """``chip_smoke.py --families-rank SPEC``: one of two gloo ranks on the
    one card: spherical on FP (mesh (1, 1, 2), feature = 2) and bisecting
    on DP (mesh (2, 1)) at glove, each held by rank 0 to one card's fit.
    Writes the rank's record to ``spec["out"] % rank``."""
    import torch
    import torch.distributed as dist

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.parallel import fit_spherical_sharded, make_mesh

    fp = make_mesh((1, 1, 2), ("data", "model", "feature"),
                   devices=["cuda:0"] * 2, backend="gloo")
    dpm = make_mesh((2, 1), ("data", "model"), devices=["cuda:0"] * 2,
                    backend="gloo")
    out = {"rank": fp.rank, "runs": {}}
    try:
        x, centres = _glove(3, GLOVE["k"])
        # Bisecting runs on rows of as many blobs as leaves, as its hold in
        # the process does (each split parts whole blobs).
        xb, _ = _glove(5, FAM_GLOO_BISECT_K)
        c0 = _sphere_c0(centres, 23)
        k = GLOVE["k"]
        cfg = kt.KMeansConfig(k=k, update="matmul")
        runs = {
            "spherical-fp2-gloo": lambda: fit_spherical_sharded(
                x, k, mesh=fp, init=c0, config=cfg, tol=-1.0,
                max_iter=SPHERE_SWEEPS, feature_axis="feature"),
            "bisecting-dp2-gloo": lambda: kt.fit_bisecting(
                xb, FAM_GLOO_BISECT_K, mesh=dpm,
                config=kt.KMeansConfig(k=FAM_GLOO_BISECT_K, seed=0)),
        }
        for name, fn in runs.items():
            dpm.barrier()
            _sync()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            st = fn()
            _sync()
            out["runs"][name] = {"seconds": time.perf_counter() - t0,
                                 "launches": K.launch_counts()}
            if fp.rank == 0:
                if name.startswith("spherical"):
                    want = kt.fit_spherical(x, k, init=c0, config=cfg,
                                            tol=-1.0, max_iter=SPHERE_SWEEPS)
                    from kmeans_tpu_torch.models.spherical import \
                        normalize_rows
                    moved, _ = _check_labels_pair(
                        name, normalize_rows(x), st.centroids, st.labels,
                        want.centroids, want.labels, torch.float32)
                    _unit_norms(name, st.centroids)
                else:
                    want = kt.fit_bisecting(xb, FAM_GLOO_BISECT_K,
                                            config=kt.KMeansConfig(
                                                k=FAM_GLOO_BISECT_K, seed=0))
                    moved = int((st.labels != want.labels).sum())
                    _check(moved <= 1e-4 * xb.shape[0],
                           f"{name}: {moved} labels differ from one card's")
                _check(int(st.n_iter) == int(want.n_iter),
                       f"{name}: {int(st.n_iter)} against one card's "
                       f"{int(want.n_iter)}")
                rel = abs(float(st.inertia) - float(want.inertia)) / float(
                    want.inertia)
                _check(rel <= FIT_INERTIA_RTOL, f"{name}: inertia "
                       f"{float(st.inertia)!r} against one card's "
                       f"{float(want.inertia)!r}")
                out["runs"][name].update(moved=moved, rel=rel,
                                         n_iter=int(st.n_iter))
    finally:
        with open(spec["out"] % fp.rank, "w", encoding="utf-8") as f:
            json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _families_world(tmp):
    """Spawn phase 17's gloo world of two ranks on the one card."""
    import os

    from kmeans_tpu_torch.parallel.mesh import free_port

    spec = {"out": f"{tmp}/families-rank%d.json"}
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE="2",
               PYTHONUNBUFFERED="1")
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--families-rank",
         json.dumps(spec)], cwd=root,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    return procs, spec


def _families_cli(tmp):
    """train-mesh (phase 17): ``cli train --mesh 2 --device cpu`` for
    spherical, bisecting, xmeans and gmeans against ``--mesh 1``, in CPU
    processes.  Returns ``{name: (stdout, stderr, rc)}`` and seconds."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    for family, k in (("spherical", "8"), ("bisecting", "8"),
                      ("xmeans", "16"), ("gmeans", "16")):
        base = ["train", *FAMILIES_CLI_SMALL, "--model", family, "--k", k]
        runs[family] = base + ["--mesh", "2"]
        runs[f"{family} 1"] = base
    t0 = time.perf_counter()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "kmeans_tpu_torch.cli", *argv], cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in runs.items()}
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=CLI_TIMEOUT_S) + (
                p.returncode,)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, time.perf_counter() - t0


def _check_families_cli(outs, secs):
    for family in ("spherical", "bisecting", "xmeans", "gmeans"):
        res = {}
        for name in (family, f"{family} 1"):
            out, err, rc = outs[name]
            _check(rc == 0, f"train-mesh {name}: exit {rc}, stderr "
                   f"{err[-1500:]}")
            res[name] = json.loads(out.strip().splitlines()[-1])
        two, one = res[family], res[f"{family} 1"]
        same = ("n", "d", "k", "n_iter", "mode", "converged")
        _check({f: two[f] for f in same} == {f: one[f] for f in same}
               and two["mesh"] == 2
               and abs(two["inertia"] - one["inertia"])
               <= 1e-5 * abs(one["inertia"]),
               f"train-mesh {family}: {two} against {one}")
        print(f"train-mesh {family} (--mesh 2 --device cpu): k={two['k']}, "
              f"n_iter {two['n_iter']}, inertia {two['inertia']} against "
              f"--mesh 1's {one['inertia']}")
    print(f"train-mesh (phase 17): {secs:.1f} s for the eight CPU runs")


def phase_families(card):
    """Phase 17: the Lloyd-based families and model selection (see the
    module docstring).  Returns the runs' launches by compute:
    ``{"bf16": {...}, "f32": {...}}``."""
    import shutil
    import tempfile
    import threading

    import torch

    t_all = time.perf_counter()
    totals = {"bf16": {}, "f32": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_families_")
    def mark(what):
        print(f"  [phase 17: {what} done at {time.perf_counter() - t_all:.1f}"
              " s]", flush=True)

    try:
        x, centres = _glove(0, GLOVE["k"])
        _glove_spherical(card, x, centres, totals)
        mark("glove-spherical")
        _glove_bisecting(card, x, totals)
        mark("glove-bisecting")
        _spherical_dp1(card, x, centres, totals)
        mark("spherical-dp1-nccl")
        del x, centres
        torch.cuda.empty_cache()
        _imagenet_spherical(card, totals)
        mark("imagenet-spherical")
        _glove_autok(card, totals)
        mark("glove-xmeans, glove-gmeans")
        # The child processes overlap: train-mesh's CPU processes and the
        # gloo world (whose seconds are no scaling numbers) beside
        # mnist-sweep's (whose seconds a row are the process's, not the
        # card's alone).
        cli_out = {}
        cli = threading.Thread(target=lambda: cli_out.update(
            zip(("outs", "secs"), _families_cli(tmp))))
        cli.start()
        procs, spec = _families_world(tmp)
        _or_stop(procs, lambda: _mnist_sweep(card, tmp, totals))
        mark("mnist-sweep")
        ranks = _wait_world("phase 17's gloo world", procs, spec)
        for rank in ranks:
            for rec in rank["runs"].values():
                _add_counts(totals["f32"], rec["launches"])
        for name, rec in ranks[0]["runs"].items():
            secs = [r["runs"][name]["seconds"] for r in ranks]
            print(f"{name} ({card}; two ranks share the card, not a "
                  f"scaling number): {rec['n_iter']} "
                  f"{'sweeps' if 'spherical' in name else 'splits'} as one "
                  f"card's, {rec['moved']} labels differ (ties), inertia "
                  f"within {rec['rel']:.2e}; {[round(s, 3) for s in secs]} "
                  f"s a rank; launches a rank "
                  f"{[r['runs'][name]['launches'] for r in ranks]}")
        cli.join(timeout=CLI_TIMEOUT_S)
        _check("outs" in cli_out, "train-mesh: the CLI runs did not end")
        _check_families_cli(cli_out["outs"], cli_out["secs"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_all
    print(f"phase 17 ({card}): {secs:.1f} s; launches {totals}")
    return totals


# ---------------------------------------------------------------------------
# Phase 18: the soft, balanced and projected families
# ---------------------------------------------------------------------------

#: imagenet-gmm: EM iterations at the headline (tol 0) and the rows of a
#: tile (the config's ``chunk_size``: 64 tiles a pass).
GMM_ITERS = 10
GMM_CHUNK = 20_000
#: mnist-gmm: EM iterations of each covariance type, in f32.
MNIST_GMM_ITERS = 20
#: mnist-gmm's hold to the CPU fit: the total log-likelihood, and a row
#: labelled apart must be a near-tie there, its two log-densities within
#: this share of their size (two fits whose parameters agree to their f32
#: sums' order).
MNIST_GMM_LL_RTOL = 1e-5
GMM_TIE_RTOL = 1e-5
#: glove-fuzzy: iterations (tol -1: every one runs), and the rows and
#: iterations of its hold against the CPU fit (the CPU's f32 products at
#: k = 1000 take about 0.5 s a pass there).
FUZZY_ITERS = 20
FUZZY_HOLD_ROWS = 50_000
FUZZY_HOLD_ITERS = 5
#: Its one-pass hold in f64: the sums, soft counts and J to this share of
#: their largest entry (memberships from f32 expanded distances, which
#: round at ‖x‖² + ‖c‖²).
FUZZY_F64_RTOL = 1e-4
#: mnist-balanced: the hard counts' band around n/k, and the outer
#: iterations' cap.
BAL_COUNT_BAND = 0.05
BAL_MNIST_ITERS = 30
#: glove-balanced-dp1-nccl: outer iterations (tol -1), cut from the
#: default 100 to fit the phase; the rows of its hold against fit_balanced
#: (the most under its 1.5e8-element gate at k = 1000) and the hold's
#: outer iterations (each fit's final view adds one more plan); the sweeps
#: of the per-sweep probe.
BAL_ITERS = 3
BAL_HOLD_ROWS = 150_000
BAL_HOLD_ITERS = 1
BAL_PROBE_SWEEPS = 20
#: A balanced row labelled apart from the single-device fit must be a
#: near-tie of d² − g there: within this share of ‖x‖² + ‖c‖².
BAL_TIE_RTOL = 1e-4
#: cifar10-pca-cli: the projection; the covariance's perturbation by the
#: f32 sums' order, PCA_PERTURB of the largest eigenvalue (the card runs
#: measured 5.8e-7 of it between the card's and the CPU's eigenvalues);
#: a component is held up to sign to PCA_COMP_ATOL where that perturbation
#: over its eigengap (Davis–Kahan's bound on its turn) is within it, and
#: the eigenvalues to PCA_VAR_RTOL of the largest (an eigenvalue moves by
#: at most the perturbation: Weyl).
PCA_M = 256
PCA_PERTURB = 2.0 ** -18
PCA_COMP_ATOL = 1e-3
PCA_VAR_RTOL = 1e-4
#: cifar10-gmm-stream: the streamed mixture's k and the SIGTERM drill's
#: step (``cli train --stream``'s defaults: 200 steps of 8192 rows).
GMM_STREAM_K = 100
GMM_STREAM_STEPS = 200
GMM_STREAM_DRILL_AT = 100
#: mnist-sweep-bic: its suggestion must lie in this band (the blobs: 10).
BIC_BAND = (10, 12)
#: train-mesh: ``cli train`` at a small shape, ``--mesh 2 --device cpu``
#: (balanced's 200 Sinkhorn sweeps are two gloo all-reduces each: three
#: passes).
SOFT_CLI_SMALL = ["--n", "4000", "--d", "16", "--seed", "3", "--device",
                  "cpu", "--max-iter", "2"]


def _near_c0(centres, seed, scale=0.1):
    """A fixed init near the generating centres (so no fit of the phase
    is left to a seeding draw)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return centres.float() + scale * torch.randn(
        centres.shape, generator=gen, device="cuda")


def _mnist():
    """mnist-shaped f32 blobs on the card (phase 17's, SWEEP_STD) and
    their generating centres."""
    import kmeans_tpu_torch as kt

    x, _, centres = kt.make_blobs(17, MNIST["n"], MNIST["d"], MNIST["k"],
                                  cluster_std=SWEEP_STD)
    return x, centres


def _gmm_ll64(x, params, cd, chunk=8192):
    """The diag mixture's total log-likelihood recomputed in f64 on the
    card from ``params``, with the fit's own ``cd``-rounded operands (x,
    x² and the terms rounded as the E-step rounds them), so only the f32
    accumulation differs; and ``scale``, Σ over rows of the largest
    |const| + |x·lin| + ½|x²·inv_var|, which that accumulation rounds
    at."""
    import torch

    from kmeans_tpu_torch.models.gmm import _logp_terms

    quad, lin, const = _logp_terms(params, "diag")
    q, l, c = quad.to(cd).double(), lin.to(cd).double(), const.double()
    ll = scale = 0.0
    for lo in range(0, x.shape[0], chunk):
        xb = x[lo:lo + chunk]
        xf = xb.float()
        cross = xb.to(cd).double() @ l.T
        quad_t = (xf * xf).to(cd).double() @ q.T
        logp = c[None, :] + cross - 0.5 * quad_t
        ll += float(torch.logsumexp(logp, dim=1).sum())
        scale += float((c.abs()[None, :] + cross.abs()
                        + 0.5 * quad_t.abs()).amax(dim=1).sum())
    return ll, scale


def _gmm_params(st):
    import torch

    from kmeans_tpu_torch.models.gmm import GMMParams

    return GMMParams(st.means, st.covariances,
                     torch.log(st.mix_weights.clamp_min(1e-37)))


def _record_ll():
    """Wrap ``gmm_scan_tiles`` to keep every card pass's total
    log-likelihood (no sync; the CPU holds' passes, on their thread, are
    not kept).  Returns ``(lls, undo)``."""
    import kmeans_tpu_torch.models.gmm as G

    real = G.gmm_scan_tiles
    lls = []

    def scan(x, *a, **kw):
        out = real(x, *a, **kw)
        if x.is_cuda:
            lls.append(out[3])
        return out

    G.gmm_scan_tiles = scan

    def undo():
        G.gmm_scan_tiles = real
    return lls, undo


def _products_split(fn):
    """``fn()`` under ``torch.profiler``: the ms of its product kernels
    (cuBLAS's and CUTLASS's gemm) and of everything else on the card."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    gemm = re.compile(r"gemm|nvjet|xmma|cutlass", re.I)
    prod = other = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        if gemm.search(e.name):
            prod += us
        else:
            other += us
    _check(prod > 0 and other > 0, "the profiler recorded no products")
    return prod / 1e3, other / 1e3


def _imagenet_gmm(card, totals):
    """imagenet-gmm: fit_gmm at the headline (phase 4's bf16 data; diag,
    bf16 compute, from an init near the generating centres), GMM_ITERS EM
    iterations (tol −1: every one runs, as tol 0 does unless a pass repeats
    its predecessor's log-likelihood to the bit): ms an iteration, the
    products' and the elementwise passes' shares of one pass, the peak
    memory; every pass's log-likelihood must not fall by more than its f32
    rounding, and the final one must agree with an f64 recomputation from
    the final parameters."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.gmm import gmm_sample, gmm_scan_tiles

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    # Near the centres every component starts on its blob: from random
    # rows (phase 4's c0) several start in one blob, and in bf16 compute
    # the ones left with a few rows collapse to ``reg_covar``, where the
    # bf16-rounded x·lin and x²·inv_var terms (|x|·|lin| ≈ 1e11) swamp
    # the log-density (the first card run: the log-likelihood jumped from
    # −1.6e9 to +7.8e9 and back).
    x, _, centres = kt.make_blobs(0, n, d, k, dtype=torch.bfloat16)
    c0 = _near_c0(centres, 30)
    del centres
    cfg = kt.KMeansConfig(k=k, compute_dtype="bfloat16",
                          chunk_size=GMM_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    lls, undo = _record_ll()
    try:
        st, ms, counts = _timed_fit(lambda: kt.fit_gmm(
            x, k, init=c0, config=cfg, tol=-1.0, max_iter=GMM_ITERS))
    finally:
        undo()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    _only("imagenet-gmm", counts, {})
    _add_counts(totals["bf16"], counts)
    _check(int(st.n_iter) == GMM_ITERS and len(lls) == GMM_ITERS + 1,
           f"imagenet-gmm: {int(st.n_iter)} iterations, {len(lls)} passes")
    ll = [float(v) for v in lls]
    tiles = -(-n // GMM_CHUNK)
    # Each pass sums every row's f32 log-density into its tile's total and
    # the tiles in order: (tiles + log2 of a tile's rows) f32 steps of the
    # rows' absolute sum, which is |ll| (every log-density is negative at
    # d = 2048).
    fall_tol = (tiles + math.log2(GMM_CHUNK)) * 2.0 ** -24 * max(
        abs(v) for v in ll)
    falls = [a - b for a, b in zip(ll, ll[1:])]
    _check(all(f <= fall_tol for f in falls),
           f"imagenet-gmm: the log-likelihood fell by {max(falls):.6e} "
           f"(bound {fall_tol:.6e}): {ll}")
    ll64, scale = _gmm_ll64(x, _gmm_params(st), torch.bfloat16)
    err = abs(float(st.log_likelihood) - ll64)
    ll_tol = 2.0 ** -24 * (d + tiles + math.log2(GMM_CHUNK)) * scale
    _check(err <= ll_tol, f"imagenet-gmm: log-likelihood "
           f"{float(st.log_likelihood)!r} against f64 {ll64!r} (bound "
           f"{ll_tol:.3e})")
    _check(bool(torch.isfinite(st.means).all()
                and torch.isfinite(st.covariances).all()
                and (st.covariances > 0).all()),
           "imagenet-gmm: a parameter is not finite")
    prod_ms, other_ms = _products_split(lambda: gmm_scan_tiles(
        x, None, _gmm_params(st), chunk_size=GMM_CHUNK,
        compute_dtype=torch.bfloat16, with_labels=False))
    flop = 8.0 * n * d * k
    print(f"imagenet-gmm ({card}): n={n} d={d} k={k} diag, bf16 compute, "
          f"{GMM_ITERS} EM iterations: {ms:.3f} ms in all, "
          f"{ms / (GMM_ITERS + 1):.3f} ms a pass ({GMM_ITERS} EM passes "
          f"and the labelling pass); one EM pass under the profiler: "
          f"products {prod_ms:.3f} ms (8·n·d·k = {flop:.3e} FLOP: "
          f"{flop / prod_ms / 1e9:.1f} TFLOP/s; bound "
          f"{flop / 989e12 * 1e3:.3f} ms at 989 TFLOP/s), other kernels "
          f"{other_ms:.3f} ms; peak "
          f"{peak:.3f} GB above the data; log-likelihood {ll[0]:.6e} -> "
          f"{float(st.log_likelihood):.6e}, largest fall "
          f"{max(falls):.3e} (bound {fall_tol:.3e}); against f64 on the "
          f"card {err:.3e} (bound {ll_tol:.3e}); launches {counts}")
    # gmm_sample draws its components from an int64 CDF: one seed, the
    # same rows on every call.
    draws = [gmm_sample(torch.Generator(device="cuda").manual_seed(18),
                        _gmm_params(st), 200_000) for _ in range(2)]
    _check(all(torch.equal(a, b) for a, b in zip(*draws)),
           "imagenet-gmm: two gmm_sample calls from one seed differ")
    print("imagenet-gmm: gmm_sample of 200000 rows twice from one seed: "
          "equal bit for bit")
    del x, st, draws
    torch.cuda.empty_cache()


def _gmm_near_ties(name, x, params, cov, lab_a, lab_b):
    """Rows labelled apart by two GMM fits must be near-ties of the
    log-densities at ``params`` (f64): within GMM_TIE_RTOL of their
    size."""
    import torch

    from kmeans_tpu_torch.models.gmm import _logp_terms

    rows = (lab_a != lab_b).nonzero()[:, 0]
    if not rows.numel():
        return 0
    p64 = type(params)(*(t.double() for t in params))
    quad, lin, const = _logp_terms(p64, cov)
    xr = x[rows].double()
    if cov == "tied":
        z = xr @ quad.T
        q = (z * z).sum(1)[:, None]
    else:
        q = (xr * xr) @ quad.T
    logp = const[None, :] + xr @ lin.T - 0.5 * q
    a = logp.gather(1, lab_a[rows].long()[:, None])[:, 0]
    b = logp.gather(1, lab_b[rows].long()[:, None])[:, 0]
    tol = GMM_TIE_RTOL * torch.maximum(a.abs(), b.abs())
    _check(bool(((a - b).abs() <= tol).all()),
           f"{name}: {int(((a - b).abs() > tol).sum())} rows labelled apart"
           " beyond a near-tie")
    return int(rows.numel())


def _mnist_gmm(card, x, centres, cpu_fits):
    """mnist-gmm: fit_gmm at mnist's shape in f32 for each covariance
    type, MNIST_GMM_ITERS iterations, held to the port's CPU fit from the
    same init (``cpu_fits``, run beside the card's work); the tied fit's
    Cholesky factor and triangular solve timed."""
    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.gmm import _logp_terms

    k = MNIST["k"]
    c0 = _near_c0(centres, 31)
    cfg = kt.KMeansConfig(k=k, compute_dtype="float32")
    for cov in ("diag", "spherical", "tied"):
        st, ms, counts = _timed_fit(lambda: kt.fit_gmm(
            x, k, covariance_type=cov, init=c0, config=cfg, tol=-1.0,
            max_iter=MNIST_GMM_ITERS))
        _only(f"mnist-gmm {cov}", counts, {})
        cpu = cpu_fits(f"gmm {cov}")
        ll_c, ll_g = float(cpu.log_likelihood), float(st.log_likelihood)
        _check(int(st.n_iter) == int(cpu.n_iter)
               and abs(ll_g - ll_c) <= MNIST_GMM_LL_RTOL * abs(ll_c),
               f"mnist-gmm {cov}: n_iter {int(st.n_iter)} / CPU "
               f"{int(cpu.n_iter)}, log-likelihood {ll_g!r} / CPU {ll_c!r}")
        moved = _gmm_near_ties(f"mnist-gmm {cov}", x, _gmm_params(st), cov,
                               st.labels, cpu.labels.cuda())
        extra = ""
        if cov == "tied":
            params = _gmm_params(st)
            chol_ms, _ = _time_auto(lambda: _logp_terms(params, "tied"))
            extra = (f"; Cholesky factor and triangular solves of the "
                     f"({MNIST['d']}, {MNIST['d']}) covariance "
                     f"{chol_ms:.3f} ms a pass")
        print(f"mnist-gmm {cov} ({card}): n={MNIST['n']} d={MNIST['d']} "
              f"k={k} f32, {int(st.n_iter)} iterations: {ms / 1e3:.3f} s "
              f"a fit; log-likelihood {ll_g:.6e}, CPU {ll_c:.6e} (rtol "
              f"{abs(ll_g - ll_c) / abs(ll_c):.2e}); {moved} labels differ"
              f" from the CPU fit (near-ties){extra}")


def _fcm64(x, c, m, chunk=8192):
    """One fuzzy pass in f64 on the card at centroids ``c``: (sums,
    counts, J), memberships from the f64 expanded distances."""
    import torch

    from kmeans_tpu_torch.models.fuzzy import _memberships_tile

    c64 = c.double()
    csq = (c64 * c64).sum(1)
    k, d = c.shape
    sums = torch.zeros((k, d), dtype=torch.float64, device="cuda")
    counts = torch.zeros(k, dtype=torch.float64, device="cuda")
    obj = 0.0
    for lo in range(0, x.shape[0], chunk):
        xb = x[lo:lo + chunk].double()
        d2 = ((xb * xb).sum(1)[:, None] - 2.0 * xb @ c64.T
              + csq[None, :]).clamp_min(0.0)
        um = _memberships_tile(d2, 1.0 / (m - 1.0)) ** m
        obj += float((um * d2).sum())
        sums += um.T @ xb
        counts += um.sum(0)
    return sums, counts, obj


def _glove_fuzzy(card, cpu_fits):
    """glove-fuzzy: fit_fuzzy at glove (k = 1000, m = 2), FUZZY_ITERS
    iterations in f32 and in bf16 from one init; one f32 pass held to f64
    on the card; the f32 fit on the first FUZZY_HOLD_ROWS rows held to the
    port's CPU fit (``cpu_fits``)."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.fuzzy import fcm_scan_tiles

    x, centres = _glove(0, GLOVE["k"])
    k = GLOVE["k"]
    c0 = _near_c0(centres, 32)
    out = {}
    for cd in ("float32", "bfloat16"):
        cfg = kt.KMeansConfig(k=k, compute_dtype=cd)
        st, ms, counts = _timed_fit(lambda: kt.fit_fuzzy(
            x, k, init=c0, config=cfg, tol=-1.0, max_iter=FUZZY_ITERS))
        _only(f"glove-fuzzy {cd}", counts, {})
        _check(int(st.n_iter) == FUZZY_ITERS
               and bool(torch.isfinite(st.centroids).all()),
               f"glove-fuzzy {cd}: {int(st.n_iter)} iterations")
        out[cd] = (st, ms)
    st, ms = out["float32"]
    sums, cnt, obj, _ = fcm_scan_tiles(x, None, st.centroids, m=2.0,
                                       chunk_size=4096,
                                       compute_dtype=torch.float32,
                                       with_labels=False)
    s64, c64, o64 = _fcm64(x, st.centroids, 2.0)
    errs = (float((sums.double() - s64).abs().max() / s64.abs().max()),
            float((cnt.double() - c64).abs().max() / c64.abs().max()),
            abs(float(obj) - o64) / abs(o64))
    _check(max(errs) <= FUZZY_F64_RTOL,
           f"glove-fuzzy: one pass against f64: sums {errs[0]:.2e}, "
           f"counts {errs[1]:.2e}, J {errs[2]:.2e} (bound {FUZZY_F64_RTOL})")
    # The hold on the first rows, against the CPU fit from the same init.
    xh = x[:FUZZY_HOLD_ROWS]
    hold = kt.fit_fuzzy(xh, k, init=c0, tol=-1.0, max_iter=FUZZY_HOLD_ITERS,
                        config=kt.KMeansConfig(k=k, compute_dtype="float32"))
    cpu = cpu_fits("fuzzy")
    moved, _ = _check_labels_pair("glove-fuzzy hold", xh, hold.centroids,
                                  hold.labels, cpu.centroids.cuda(),
                                  cpu.labels.cuda(), torch.float32)
    c_err = _close("glove-fuzzy hold centroids", hold.centroids,
                   cpu.centroids.cuda())
    j_rel = abs(float(hold.objective) - float(cpu.objective)) / abs(
        float(cpu.objective))
    _check(j_rel <= SUMS_RTOL, f"glove-fuzzy hold: J {float(hold.objective)}"
           f" against the CPU's {float(cpu.objective)}")
    passes = FUZZY_ITERS + 1
    print(f"glove-fuzzy ({card}): n={GLOVE['n']} d={GLOVE['d']} k={k} "
          f"m=2, {FUZZY_ITERS} iterations: f32 {ms:.3f} ms "
          f"({ms / passes:.3f} ms a pass), bf16 {out['bfloat16'][1]:.3f} ms "
          f"({out['bfloat16'][1] / passes:.3f} ms a pass); one f32 pass "
          f"against f64 on the card: sums {errs[0]:.2e}, soft counts "
          f"{errs[1]:.2e}, J {errs[2]:.2e} (bound {FUZZY_F64_RTOL}); on the"
          f" first {FUZZY_HOLD_ROWS} rows, {FUZZY_HOLD_ITERS} iterations, "
          f"against the CPU fit: {moved} labels differ (ties), centroids "
          f"within {c_err:.2e}, J within {j_rel:.2e}")
    del x, out, st, hold
    torch.cuda.empty_cache()


def _mnist_balanced(card, x, centres, totals):
    """mnist-balanced: ``BalancedKMeans`` at mnist's shape (200 Sinkhorn
    sweeps a step): the column masses are the capacities, the hard counts
    within BAL_COUNT_BAND of n/k; then ``predict`` on the card (K1)."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.distance import assign

    n, k = MNIST["n"], MNIST["k"]
    c0 = _near_c0(centres, 33)
    est = kt.BalancedKMeans(n_clusters=k, init=c0, max_iter=BAL_MNIST_ITERS)
    torch.cuda.reset_peak_memory_stats()
    _, ms, counts = _timed_fit(lambda: est.fit(x))
    _only("mnist-balanced fit", counts, {})
    st = est.state
    masses = st.col_masses.double()
    rel = float(((masses - 1.0 / k).abs() * k).max())
    _check(rel <= 1e-4, f"mnist-balanced: column masses {masses.tolist()}")
    band = float(((st.counts.double() - n / k).abs() / (n / k)).max())
    _check(band <= BAL_COUNT_BAND,
           f"mnist-balanced: hard counts {st.counts.tolist()} beyond "
           f"{BAL_COUNT_BAND} of n/k")
    _sync()
    K.reset_launch_counts()
    labels = est.predict(x)
    _sync()
    pcounts = K.launch_counts()
    _check(pcounts.get("lloyd_pass_cuda", 0) >= 1,
           f"mnist-balanced predict: launches {pcounts}")
    _add_counts(totals["f32"], pcounts)
    plain, _ = assign(x, st.centroids, backend="plain")
    moved, _ = _check_labels_pair("mnist-balanced predict", x, st.centroids,
                                  labels, st.centroids, plain,
                                  torch.float32)
    print(f"mnist-balanced ({card}): n={n} d={MNIST['d']} k={k}, 200 "
          f"sweeps a step, {int(st.n_iter)} steps: {ms / 1e3:.3f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; column masses"
          f" within {rel:.2e} of the capacities, hard counts within "
          f"{band:.2%} of n/k ({st.counts.int().tolist()}); predict on "
          f"K1: launches {pcounts}, {moved} labels differ from the plain "
          "assignment (ties)")


def _balanced_ties(name, x, c, lab_a, lab_b, g):
    """Balanced labels apart must be near-ties of d² − g at ``c``."""
    import torch

    rows = (lab_a != lab_b).nonzero()[:, 0]
    if not rows.numel():
        return 0
    xr = x[rows].double()
    c64 = c.double()
    scale = (xr * xr).sum(1)[:, None] + (c64 * c64).sum(1)[None, :]
    s = scale - 2.0 * xr @ c64.T - g.double()[None, :]
    a = s.gather(1, lab_a[rows].long()[:, None])[:, 0]
    b = s.gather(1, lab_b[rows].long()[:, None])[:, 0]
    tol = BAL_TIE_RTOL * torch.maximum(
        scale.gather(1, lab_a[rows].long()[:, None])[:, 0],
        scale.gather(1, lab_b[rows].long()[:, None])[:, 0])
    _check(bool(((a - b).abs() <= tol).all()),
           f"{name}: {int(((a - b).abs() > tol).sum())} rows labelled apart"
           " beyond a near-tie of d² − g")
    return int(rows.numel())


def _glove_balanced_dp1(card, mesh):
    """glove-balanced-dp1-nccl: fit_balanced_sharded at glove (n·k =
    4e8, past the single-device gate) on an NCCL mesh of one, BAL_ITERS
    outer iterations: ms a Sinkhorn sweep against its bound, the peak
    memory, the all-reduces a sweep; held at BAL_HOLD_ROWS rows to
    fit_balanced."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.balanced import (log_row_masses,
                                                  resolve_capacities,
                                                  sinkhorn_potentials)
    from kmeans_tpu_torch.ops.distance import pairwise_sq_dists
    from kmeans_tpu_torch.parallel import fit_balanced_sharded

    x, centres = _glove(1, GLOVE["k"])
    n, k = GLOVE["n"], GLOVE["k"]
    c0 = _near_c0(centres, 34)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mesh.reset_stats()
    st, ms, counts = _timed_fit(lambda: fit_balanced_sharded(
        x, k, mesh=mesh, init=c0, tol=-1.0, max_iter=BAL_ITERS))
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    reduces = mesh.stats["all_reduce"][0]
    passes = BAL_ITERS + 1
    per_sweep = (reduces - 1 - passes) / (passes * 200)
    _only("glove-balanced-dp1", counts, {})
    _check(int(st.n_iter) == BAL_ITERS and per_sweep == 2,
           f"glove-balanced-dp1: {int(st.n_iter)} iterations, all-reduces "
           f"{reduces}")
    _check(float(((st.col_masses.double() - 1.0 / k).abs() * k).max())
           <= 1e-3, "glove-balanced-dp1: column masses off the capacities")
    # BAL_PROBE_SWEEPS sweeps on the mesh at the final centroids' d².
    log_a = log_row_masses(None, n, "cuda")
    cap = resolve_capacities(k, None, "cuda")
    buf = torch.empty((n, k), device="cuda")
    eps = 0.5 * float(pairwise_sq_dists(x, c0).amin(1).mean())
    d2 = pairwise_sq_dists(x, st.centroids)
    t_probe, _ = _time_auto(lambda: sinkhorn_potentials(
        d2, log_a, torch.log(cap), epsilon=eps, sweeps=BAL_PROBE_SWEEPS,
        buf=buf, mesh=mesh))
    sweep_ms = t_probe / BAL_PROBE_SWEEPS
    bound_ms = 2 * n * k * 4 / MEM_BYTES_PER_S * 1e3
    del buf, d2
    # The hold under the gate: the sharded and the single-device fits of
    # the first BAL_HOLD_ROWS rows, from one init.
    xh = x[:BAL_HOLD_ROWS]
    a = fit_balanced_sharded(xh, k, mesh=mesh, init=c0, tol=-1.0,
                             max_iter=BAL_HOLD_ITERS)
    b = kt.fit_balanced(xh, k, init=c0, tol=-1.0, max_iter=BAL_HOLD_ITERS)
    c_err = _close("glove-balanced hold centroids", a.centroids, b.centroids)
    d2 = pairwise_sq_dists(xh, b.centroids)
    eps_h = 0.5 * float(pairwise_sq_dists(xh, c0).amin(1).mean())
    _, g = sinkhorn_potentials(d2, log_row_masses(None, BAL_HOLD_ROWS,
                                                  "cuda"),
                               torch.log(cap), epsilon=eps_h, sweeps=200)
    del d2
    moved = _balanced_ties("glove-balanced hold", xh, b.centroids, a.labels,
                           b.labels, g)
    print(f"glove-balanced-dp1-nccl ({card}): n={n} d={GLOVE['d']} k={k} "
          f"(n·k = {n * k:.1e}), {BAL_ITERS} outer iterations of 200 "
          f"sweeps (cut from 100): {ms / 1e3:.3f} s; a Sinkhorn sweep "
          f"{sweep_ms:.3f} ms against its bound {bound_ms:.3f} ms (two "
          f"reads of the {n * k * 4 / 1e9:.2f} GB plan at 3.35 TB/s); peak "
          f"{peak:.3f} GB above the data; {reduces} all-reduces, "
          f"{per_sweep:g} a sweep; at n={BAL_HOLD_ROWS}, "
          f"{BAL_HOLD_ITERS} outer iteration, against fit_balanced: "
          f"centroids within {c_err:.2e}, {moved} labels differ (near-ties "
          "of d² − g)")
    del x, st, a, b
    torch.cuda.empty_cache()


def _soft_dp1(card, mesh, x, centres):
    """gmm-dp1-nccl and fuzzy-dp1-nccl at mnist's shape: the sharded fit
    on an NCCL mesh of one against the single-device fit, bit for bit."""
    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.parallel import fit_fuzzy_sharded, fit_gmm_sharded

    k = MNIST["k"]
    c0 = _near_c0(centres, 35)
    cfg = kt.KMeansConfig(k=k)
    runs = {
        "gmm": (lambda: kt.fit_gmm(x, k, init=c0, config=cfg, tol=-1.0,
                                   max_iter=MNIST_GMM_ITERS),
                lambda: fit_gmm_sharded(x, k, mesh=mesh, init=c0, config=cfg,
                                        tol=-1.0, max_iter=MNIST_GMM_ITERS)),
        "fuzzy": (lambda: kt.fit_fuzzy(x, k, init=c0, config=cfg, tol=-1.0,
                                       max_iter=FUZZY_ITERS),
                  lambda: fit_fuzzy_sharded(x, k, mesh=mesh, init=c0,
                                            config=cfg, tol=-1.0,
                                            max_iter=FUZZY_ITERS)),
    }
    # One sharded fit first, outside the timing: NCCL makes its
    # communicator at the first collective.
    fit_fuzzy_sharded(x, k, mesh=mesh, init=c0, config=cfg, max_iter=1)
    for name, (one_fn, dp1_fn) in runs.items():
        (a, a_ms, _), (b, b_ms, _) = _timed_fit(one_fn), _timed_fit(dp1_fn)
        for field in a._fields:
            _check(_equal(getattr(a, field), getattr(b, field)),
                   f"{name}-dp1: {field} not bit for bit one card's")
        print(f"{name}-dp1-nccl ({card}): mnist shape, {int(a.n_iter)} "
              f"iterations: {b_ms:.3f} ms against one card's {a_ms:.3f} ms "
              f"({b_ms / a_ms:.3f}x); bit for bit")


def _pca_parts(card, x):
    """The PCA fit's two parts on the card at cifar10: the moment product
    (IEEE f32) and eigh, timed; returns the card's state."""
    import torch

    from kmeans_tpu_torch.data.preprocess import (_finish, _moments,
                                                  _top_eigs)
    from kmeans_tpu_torch.ops.distance import full_f32

    mom_ms, (s, ss, mu0) = _time_auto(lambda: _moments(x, 8192,
                                                       torch.float32))
    cov = ss / x.shape[0]
    with full_f32():
        eig_ms, _ = _time_auto(lambda: _top_eigs(cov, PCA_M))
    n, d = x.shape
    print(f"cifar10-pca ({card}): n={n} d={d}: the moment product "
          f"{mom_ms:.3f} ms (2·n·d² = {2 * n * d * d:.3e} FLOP, "
          f"{2 * n * d * d / mom_ms / 1e9:.1f} TFLOP/s in IEEE f32), eigh of"
          f" the ({d}, {d}) covariance {eig_ms:.3f} ms")
    return _finish(s, ss, mu0, n, PCA_M, True)


def _pca_hold(name, got, want):
    """Components up to sign where PCA_PERTURB of the largest eigenvalue
    over their eigengap is within PCA_COMP_ATOL, and every eigenvalue.
    Returns ``(held, worst component error, worst eigenvalue error)``."""
    import torch

    ev = want.explained_variance.double().cpu()
    # The gap below the last component is to one not fitted: never held.
    prev = torch.cat([ev[:1] * 0 + float("inf"), ev[:-1] - ev[1:]])
    nxt = torch.cat([ev[:-1] - ev[1:], ev[-1:] * 0])
    held = torch.minimum(prev, nxt) * PCA_COMP_ATOL >= PCA_PERTURB * ev.max()
    gc, wc = got.components.double().cpu(), want.components.double().cpu()
    sign = torch.sign((gc * wc).sum(1))
    err = (gc * sign[:, None] - wc).abs().amax(1)
    _check(bool((err[held] <= PCA_COMP_ATOL).all()),
           f"{name}: components {int((err[held] > PCA_COMP_ATOL).sum())}"
           " apart beyond their tolerance")
    var_rel = float((got.explained_variance.double().cpu() - ev).abs().max()
                    / ev.max())
    _check(var_rel <= PCA_VAR_RTOL,
           f"{name}: explained variances within {var_rel:.2e}")
    _check(bool(held.any()), f"{name}: no component's eigengap holds it")
    return int(held.sum()), float(err[held].max()), var_rel


def _cifar10_pca(card, tmp, path, got, cpu_fits, totals):
    """cifar10-pca-cli: ``cli train --input cifar10.npy --pca 256
    --whiten --k 100`` in a child process (the Lloyd fit's K1 and K2
    launches counted); ``got``, the card's fit (:func:`_pca_parts`), held
    to the port's CPU pca_fit up to sign."""
    run = _CliRun(tmp, "cifar10-pca-cli", [
        "train", "--input", path, "--pca", str(PCA_M), "--whiten", "--k",
        str(CIFAR10["k"])]).need()
    res = run.result
    _check(res["d"] == PCA_M and res["mode"] == "lloyd"
           and run.counts.get("lloyd_pass_cuda", 0) >= 1,
           f"cifar10-pca-cli: {res}, launches {run.counts}")
    _add_counts(totals["f32"], run.counts)
    held, worst, var_rel = _pca_hold("cifar10-pca", got, cpu_fits("pca"))
    print(run.line(f"; d after --pca: {res['d']}; K1 launches "
                   f"{run.counts.get('lloyd_pass_cuda', 0)}, K2 "
                   f"{run.counts.get('lloyd_delta_cuda', 0)}"))
    print(f"cifar10-pca ({card}) against the CPU's pca_fit: {held} of "
          f"{PCA_M} components held up to sign (those whose eigengap turns "
          f"them by at most {PCA_COMP_ATOL}), within {worst:.2e};"
          f" explained variances within {var_rel:.2e} of the largest (bound "
          f"{PCA_VAR_RTOL})")


def _cifar10_gmm_stream(card, tmp, path):
    """cifar10-gmm-stream: the streamed GMM at ``cli train --stream --model
    gmm``'s defaults in this process (checkpointing into ``tmp/g0`` at the
    end), under the profiler for steps a second and the card's idle
    share."""
    import numpy as np

    from kmeans_tpu_torch.models.gmm_stream import fit_gmm_stream

    data = np.load(path, mmap_mode="r")
    k = GMM_STREAM_K
    st, wall, busy = _busy_share(lambda: fit_gmm_stream(
        data, k, steps=GMM_STREAM_STEPS, final_pass=False,
        checkpoint_path=f"{tmp}/g0"))
    print(f"cifar10-gmm-stream ({card}): n={CIFAR10['n']} d={CIFAR10['d']}"
          f" k={k}, {GMM_STREAM_STEPS} steps of 8192 rows in process: "
          f"{wall:.3f} s, {GMM_STREAM_STEPS / wall:.1f} steps/s, the card "
          f"busy {busy:.1%} of the wall time (idle {1 - busy:.1%}); "
          f"n_iter {int(st.n_iter)}")


def _gmm_stream_drill(card, tmp, path):
    """cifar10-gmm-stream's CLI: ``cli train --stream --model gmm`` in a
    child process with a SIGTERM drill, then the library's resume of its
    directory in this process, which must end on
    :func:`_cifar10_gmm_stream`'s parameters and statistics bit for bit
    (the CLI's seeding draws what that process drew)."""
    import numpy as np

    from kmeans_tpu_torch.models.gmm_stream import fit_gmm_stream
    from kmeans_tpu_torch.utils.checkpoint import (latest_step,
                                                   load_array_checkpoint)

    d0, d1 = f"{tmp}/g0", f"{tmp}/g1"
    base = ["train", "--stream", "--model", "gmm", "--input", path, "--k",
            str(GMM_STREAM_K)]

    def sigterm(run, line, proc):
        import signal

        if not line.startswith("{"):
            return False
        try:
            ev = json.loads(line)
        except ValueError:
            return False
        if ev.get("event") == "iter" and \
                ev["iteration"] >= GMM_STREAM_DRILL_AT:
            proc.send_signal(signal.SIGTERM)
            return True
        return False

    drill = _CliRun(tmp, "gmm stream cli drill",
                    base + ["--checkpoint", d1, "--telemetry", "/dev/stderr"],
                    on_line=sigterm).need(3)
    step = latest_step(d1)
    _check(step is not None
           and GMM_STREAM_DRILL_AT <= step < GMM_STREAM_STEPS
           and f"resume with: --resume {d1}" in drill.err,
           f"gmm stream cli drill: checkpoint at {step}, stderr "
           f"{drill.err[-3:]}")
    t0 = time.perf_counter()
    st = fit_gmm_stream(np.load(path, mmap_mode="r"), GMM_STREAM_K,
                        checkpoint_path=d1, resume=True, final_pass=False)
    secs = time.perf_counter() - t0
    a0, m0 = load_array_checkpoint(d0)
    a1, m1 = load_array_checkpoint(d1)
    same = sorted(a0) == sorted(a1) and all(
        np.array_equal(a0[f], a1[f]) for f in a0)
    _check(same and m0["step"] == m1["step"] == GMM_STREAM_STEPS
           and int(st.n_iter) == GMM_STREAM_STEPS,
           f"gmm stream resume: n_iter {int(st.n_iter)}; arrays equal to "
           f"the uninterrupted run's: {same}")
    print(drill.line(f"; SIGTERM at step >= {GMM_STREAM_DRILL_AT}, "
                     f"checkpoint at step {step}"))
    print(f"gmm stream resume ({card}): the drill's directory resumed at "
          f"step {step} in {secs:.3f} s; parameters and statistics equal to "
          "the uninterrupted run's bit for bit")


def _mnist_sweep_bic(card, tmp, x, totals):
    """mnist-sweep-bic: ``cli sweep --model gmm --criterion bic`` in a
    child process (SWEEP_RANGE's k-means|| seeding) on phase 17's
    mnist-shaped ``.npy``: seconds a row, each row's BIC against an f64
    recomputation from its fit's parameters on the card."""
    import os

    import numpy as np
    import torch

    from kmeans_tpu_torch.models.gmm import GMMParams

    npy = f"{tmp}/mnist.npy"
    np.save(npy, x.cpu().numpy())
    spec = {"argv": ["sweep", "--input", npy, *SWEEP_RANGE, "--model",
                     "gmm", "--criterion", "bic"],
            "counts": f"{tmp}/sweep-bic.counts.json",
            "dump": f"{tmp}/sweep-bic.pt"}
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--sweep-cli",
         json.dumps(spec)], cwd=root, capture_output=True, text=True,
        timeout=CLI_TIMEOUT_S)
    secs = time.perf_counter() - t0
    _check(out.returncode == 0, f"mnist-sweep-bic: exit {out.returncode}, "
           f"stderr {out.stderr[-2000:]}")
    lines = [json.loads(ln) for ln in out.stdout.strip().splitlines()]
    rows, last = lines[:-1], lines[-1]
    counts = json.load(open(spec["counts"], encoding="utf-8"))
    dump = torch.load(spec["dump"])
    _add_counts(totals["f32"], counts)
    _check(counts.get("lloyd_pass_cuda", 0) > 0
           and len(dump["gmm"]) == len(rows),
           f"mnist-sweep-bic: launches {counts}, {len(dump['gmm'])} fits")
    n, d = x.shape
    worst = worst_tol = 0.0
    for row, (means, cov, weights) in zip(rows, dump["gmm"]):
        params = GMMParams(means.cuda(), cov.cuda(),
                           torch.log(weights.cuda().clamp_min(1e-37)))
        ll64, scale = _gmm_ll64(x, params, torch.float32)
        p = 2 * row["k"] * d + (row["k"] - 1)
        bic64 = -2.0 * ll64 + p * math.log(n)
        tol = 2 * 2.0 ** -24 * (d + 64) * scale
        err = abs(row["bic"] - bic64)
        _check(err <= tol, f"mnist-sweep-bic k={row['k']}: BIC "
               f"{row['bic']} against f64 {bic64} (bound {tol:.3e})")
        worst, worst_tol = max(worst, err), max(worst_tol, tol)
    _check(list(last) == ["suggested_k"]
           and BIC_BAND[0] <= last["suggested_k"] <= BIC_BAND[1],
           f"mnist-sweep-bic: suggested {last}")
    print(f"mnist-sweep-bic ({card}): n={n} d={d}, k "
          f"{SWEEP_RANGE[1]}..{SWEEP_RANGE[3]}, {SWEEP_RANGE[5]}: "
          f"{secs:.3f} s of process, {dump['total']:.3f} s in cli.main, "
          f"{dump['total'] / max(len(rows), 1):.3f} s a row; suggested_k "
          f"{last['suggested_k']} (band {BIC_BAND}); BIC within "
          f"{worst:.3e} of f64 on the card (bound at most {worst_tol:.3e});"
          f" launches {counts}")


def _soft_rank(spec) -> int:
    """``chip_smoke.py --soft-rank SPEC``: one of two gloo ranks on the one
    card running gmm, fuzzy and balanced on DP and pca_fit_sharded at
    mnist's shape, each held by rank 0 to one card's fit.  Writes the
    rank's record to ``spec["out"] % rank``."""
    import torch.distributed as dist

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch import parallel
    from kmeans_tpu_torch.data.preprocess import pca_fit
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    mesh = parallel.make_mesh((2, 1), ("data", "model"),
                              devices=["cuda:0"] * 2, backend="gloo")
    out = {"rank": mesh.rank, "runs": {}}
    try:
        x, centres = _mnist()
        k = MNIST["k"]
        c0 = _near_c0(centres, 36)
        cfg = kt.KMeansConfig(k=k)
        its = dict(tol=-1.0, max_iter=10)     # every iteration runs
        runs = {
            "gmm-dp2-gloo": (
                lambda: parallel.fit_gmm_sharded(x, k, mesh=mesh, init=c0,
                                                 config=cfg, **its),
                lambda: kt.fit_gmm(x, k, init=c0, config=cfg, **its)),
            "fuzzy-dp2-gloo": (
                lambda: parallel.fit_fuzzy_sharded(x, k, mesh=mesh, init=c0,
                                                   config=cfg, **its),
                lambda: kt.fit_fuzzy(x, k, init=c0, config=cfg, **its)),
            "balanced-dp2-gloo": (
                lambda: parallel.fit_balanced_sharded(
                    x, k, mesh=mesh, init=c0, config=cfg, tol=-1.0,
                    max_iter=3),
                lambda: kt.fit_balanced(x, k, init=c0, config=cfg, tol=-1.0,
                                        max_iter=3)),
            "pca-dp2-gloo": (
                lambda: parallel.pca_fit_sharded(x, 32, mesh=mesh),
                lambda: pca_fit(x, 32)),
        }
        for name, (fn, one) in runs.items():
            mesh.barrier()
            _sync()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            st = fn()
            _sync()
            rec = out["runs"][name] = {"seconds": time.perf_counter() - t0,
                                       "launches": K.launch_counts()}
            if mesh.rank:
                continue
            want = one()
            if name.startswith("pca"):
                held, worst, _ = _pca_hold(name, st, want)
                rec.update(moved=0, detail=f"{held} components within "
                           f"{worst:.2e}")
                continue
            if name.startswith("balanced"):
                _close(f"{name} centroids", st.centroids, want.centroids)
                moved = int((st.labels != want.labels).sum())
                _check(moved <= 1e-4 * x.shape[0],
                       f"{name}: {moved} labels differ from one card's")
            else:
                field = "means" if name.startswith("gmm") else "centroids"
                _close(f"{name} {field}", getattr(st, field),
                       getattr(want, field))
                moved = int((st.labels != want.labels).sum())
                _check(moved == 0 and int(st.n_iter) == int(want.n_iter),
                       f"{name}: {moved} labels differ, {int(st.n_iter)} "
                       f"iterations against {int(want.n_iter)}")
            rec.update(moved=moved, detail=f"{int(st.n_iter)} iterations")
    finally:
        with open(spec["out"] % mesh.rank, "w", encoding="utf-8") as f:
            json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _soft_world(tmp):
    """Spawn phase 18's gloo world of two ranks on the one card."""
    import os

    from kmeans_tpu_torch.parallel.mesh import free_port

    spec = {"out": f"{tmp}/soft-rank%d.json"}
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE="2",
               PYTHONUNBUFFERED="1")
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--soft-rank",
         json.dumps(spec)], cwd=root,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    return procs, spec


def _soft_cli(tmp):
    """train-mesh (phase 18): ``cli train --mesh 2 --device cpu`` for
    fuzzy, gmm and balanced against ``--mesh 1``, in CPU processes.
    Returns ``{name: (stdout, stderr, rc)}`` and seconds."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    for family in ("fuzzy", "gmm", "balanced"):
        base = ["train", *SOFT_CLI_SMALL, "--model", family, "--k", "8"]
        runs[family] = base + ["--mesh", "2"]
        runs[f"{family} 1"] = base
    t0 = time.perf_counter()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "kmeans_tpu_torch.cli", *argv], cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in runs.items()}
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=CLI_TIMEOUT_S) + (
                p.returncode,)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, time.perf_counter() - t0


def _check_soft_cli(outs, secs):
    for family in ("fuzzy", "gmm", "balanced"):
        res = {}
        for name in (family, f"{family} 1"):
            out, err, rc = outs[name]
            _check(rc == 0, f"train-mesh {name}: exit {rc}, stderr "
                   f"{err[-1500:]}")
            res[name] = json.loads(out.strip().splitlines()[-1])
        two, one = res[family], res[f"{family} 1"]
        same = ("n", "d", "k", "n_iter", "mode", "converged")
        _check({f: two[f] for f in same} == {f: one[f] for f in same}
               and two["mesh"] == 2
               and abs(two["inertia"] - one["inertia"])
               <= 1e-4 * abs(one["inertia"]),
               f"train-mesh {family}: {two} against {one}")
        print(f"train-mesh {family} (--mesh 2 --device cpu): k={two['k']}, "
              f"n_iter {two['n_iter']}, objective {two['inertia']} against "
              f"--mesh 1's {one['inertia']}")
    print(f"train-mesh (phase 18): {secs:.1f} s for the six CPU runs")


def _cpu_holds(x_mnist, c_mnist, x_glove, c_glove, x_cifar):
    """The port's CPU fits the card's runs are held to, run on a thread
    beside them: ``(start(), get(name))``."""
    import threading

    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.data.preprocess import pca_fit

    jobs = {}
    k = MNIST["k"]
    # In the order the card's runs ask for them.
    jobs["fuzzy"] = lambda: kt.fit_fuzzy(
        x_glove, GLOVE["k"], init=c_glove, tol=-1.0,
        max_iter=FUZZY_HOLD_ITERS, device="cpu",
        config=kt.KMeansConfig(k=GLOVE["k"], compute_dtype="float32"))
    for cov in ("diag", "spherical", "tied"):
        jobs[f"gmm {cov}"] = (lambda cov=cov: kt.fit_gmm(
            x_mnist, k, covariance_type=cov, init=c_mnist, tol=-1.0,
            max_iter=MNIST_GMM_ITERS, device="cpu",
            config=kt.KMeansConfig(k=k, compute_dtype="float32")))
    jobs["pca"] = lambda: pca_fit(x_cifar, PCA_M, whiten=True, device="cpu")
    done, errors = {}, {}

    def run():
        torch.set_num_threads(4)
        for name, fn in jobs.items():
            try:
                done[name] = fn()
            except Exception as e:  # allow-silent-except: re-raised by get() on the main thread
                errors[name] = e
    thread = threading.Thread(target=run)
    thread.start()

    def get(name):
        while name not in done and name not in errors:
            _check(thread.is_alive() or name in done or name in errors,
                   f"the CPU hold {name} never ran")
            time.sleep(0.05)
        if name in errors:
            raise SmokeFailure(f"the CPU hold {name}: {errors[name]!r}")
        return done[name]
    return get, thread


def _or_stop(procs, fn):
    """``fn()``; if it fails, the processes ``procs`` (a gloo world started
    beside it) are killed before the failure goes on."""
    try:
        fn()
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        raise


def _at_once(*fns):
    """Run each of ``fns`` on a thread of its own and wait for all; the
    first failure is raised once every one has ended."""
    import threading

    errors = []

    def run(fn):
        try:
            fn()
        except BaseException as e:  # allow-silent-except: re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(fn,)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def phase_soft(card):
    """Phase 18: the soft, balanced and projected families (see the module
    docstring).  Returns the runs' launches by compute: ``{"bf16": {...},
    "f32": {...}}``."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch
    import torch.distributed as dist

    from kmeans_tpu_torch.data.synthetic import make_blobs
    from kmeans_tpu_torch.parallel import make_mesh

    t_all = time.perf_counter()
    totals = {"bf16": {}, "f32": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_soft_")
    cli = cpu_thread = None

    def mark(what):
        print(f"  [phase 18: {what} done at {time.perf_counter() - t_all:.1f}"
              " s]", flush=True)

    try:
        # The CPU holds' inputs, made on the card and copied off; their
        # fits run on a thread beside the card's work.
        x_m, centres_m = _mnist()
        c_m = _near_c0(centres_m, 31)
        xg, centres_g = _glove(0, GLOVE["k"])
        c_g = _near_c0(centres_g, 32)
        path = f"{tmp}/cifar10.npy"
        x_c = make_blobs(15, CIFAR10["n"], CIFAR10["d"], CIFAR10["k"],
                         device="cuda")[0]
        x_c_host = x_c.cpu().numpy()
        np.save(path, x_c_host)
        cpu_fits, cpu_thread = _cpu_holds(x_m.cpu(), c_m.cpu(),
                              xg[:FUZZY_HOLD_ROWS].cpu(), c_g.cpu(),
                              torch.from_numpy(x_c_host))
        del xg, centres_g
        # train-mesh's CPU processes run beside everything.
        cli_out = {}
        cli = threading.Thread(target=lambda: cli_out.update(
            zip(("outs", "secs"), _soft_cli(tmp))))
        cli.start()
        _imagenet_gmm(card, totals)
        mark("imagenet-gmm")
        _glove_fuzzy(card, cpu_fits)
        mark("glove-fuzzy")
        _mnist_balanced(card, x_m, centres_m, totals)
        mark("mnist-balanced")
        mesh = make_mesh((1, 1), ("data", "model"))
        _check(mesh.backend == "nccl", f"phase 18's mesh of one: {mesh}")
        try:
            _soft_dp1(card, mesh, x_m, centres_m)
            mark("gmm-dp1-nccl, fuzzy-dp1-nccl")
            _glove_balanced_dp1(card, mesh)
            mark("glove-balanced-dp1-nccl")
        finally:
            dist.destroy_process_group()
        # After the runs above, which the CPU holds' thread runs beside.
        _mnist_gmm(card, x_m, centres_m, cpu_fits)
        mark("mnist-gmm")
        got_pca = _pca_parts(card, x_c)
        del x_c
        torch.cuda.empty_cache()
        _cifar10_gmm_stream(card, tmp, path)
        mark("cifar10-pca, cifar10-gmm-stream in process")
        # The child processes at once (their seconds are no measurements
        # of the card): the --pca fit, the stream's drill and resume, the
        # BIC sweep and the gloo world.
        procs, spec = _soft_world(tmp)
        _or_stop(procs, lambda: _at_once(
            lambda: _cifar10_pca(card, tmp, path, got_pca, cpu_fits, totals),
            lambda: _gmm_stream_drill(card, tmp, path),
            lambda: _mnist_sweep_bic(card, tmp, x_m, totals)))
        ranks = _wait_world("phase 18's gloo world", procs, spec)
        for rank in ranks:
            for rec in rank["runs"].values():
                _add_counts(totals["f32"], rec["launches"])
        for name, rec in ranks[0]["runs"].items():
            secs = [r["runs"][name]["seconds"] for r in ranks]
            print(f"{name} ({card}; two ranks share the card, not a "
                  f"scaling number): held to one card's fit ({rec['detail']}"
                  f", {rec['moved']} labels differ); "
                  f"{[round(s, 3) for s in secs]} s a rank; launches a rank "
                  f"{[r['runs'][name]['launches'] for r in ranks]}")
        cli.join(timeout=CLI_TIMEOUT_S)
        _check("outs" in cli_out, "train-mesh: the CLI runs did not end")
        _check_soft_cli(cli_out["outs"], cli_out["secs"])
    finally:
        # On a failure too: the CPU processes and the CPU fits end before
        # the phase does.
        for thread in (cli, cpu_thread):
            if thread is not None:
                thread.join(timeout=CLI_TIMEOUT_S)
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_all
    print(f"phase 18 ({card}): {secs:.1f} s; launches {totals}")
    return totals


# ---------------------------------------------------------------------------
# Phase 19: the pairwise families
# ---------------------------------------------------------------------------

#: mnist-kmedoids / mnist-kernel: iterations (cut from the reference's
#: default 100; both reach their fixed point sooner on these blobs), the
#: rows of the k-medoids hold on the CPU, and ``predict``'s rows.
PAIRWISE_ITERS = 10
PAIRWISE_HOLD_ROWS = 6000
PAIRWISE_PREDICT_ROWS = 8192
#: The card's medoid against the least f64 cost of its cluster's members,
#: relative: each f32 cost sums about 6,000 distances, each from the
#: expanded ‖x‖² − 2x·y + ‖y‖² rounded at ‖x‖²'s scale (about 2.6e4
#: against squared distances of about 400 here), so two members whose f64
#: costs are closer than this are a tie to f32.
KMEDOIDS_COST_RTOL = 1e-5
#: rings-spectral: ``make_rings`` with this many rows a ring, its γ.
RINGS_N_PER = 500_000
RINGS_GAMMA = 2.0
#: glove-spectral's k (its blobs: as many) and the rows of its f64 hold.
GLOVE_SPECTRAL_K = 100
SPECTRAL_HOLD_ROWS = 4096
#: glove-nystrom: landmarks, the Lloyd fit's k and its sweeps (tol -1).
NYSTROM_M = 1024
NYSTROM_K = 1000
NYSTROM_SWEEPS = 10
#: The dp1-nccl runs' rows for k-medoids and kernel k-means, and the gloo
#: world's rows.
PAIRWISE_DP_N = 20_000
PAIRWISE_GLOO_N = 8_000
#: train-mesh: ``cli train`` at a small shape, ``--mesh 2 --device cpu``.
PAIRWISE_CLI_SMALL = ["--n", "1500", "--d", "8", "--k", "4", "--seed", "3",
                      "--device", "cpu", "--max-iter", "10"]
#: The board's train op at the k-medoids / kernel cap's largest n.
BOARD_PAIRWISE = dict(n=20_000, d=2, k=3, max_iter=10, seed=3)


def _events_ms(fn):
    """``(result, ms)`` of ``fn()`` between two CUDA events."""
    import torch

    _sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _peak_above(fn):
    """``(result, GB)``: the card's peak allocation during ``fn()`` above
    what was allocated before it."""
    import torch

    _sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    _sync()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def _first_of_each(labels, k, rows=None):
    """The first row of each generating blob (among the first ``rows``):
    the fits' fixed starting medoids."""
    import numpy as np

    lab = labels.cpu().numpy()[:rows]
    return np.array([int(np.flatnonzero(lab == b)[0]) for b in range(k)],
                    np.int32)


def _medoid_costs64(x, members_of, cand):
    """f64 costs, on the card, of each row in ``cand`` as the medoid of the
    rows ``members_of`` (euclidean, unit weights)."""
    import torch

    xm = x[members_of].double()
    out = []
    for lo in range(0, len(cand), 512):
        xc = x[cand[lo:lo + 512]].double()
        out.append(torch.cdist(xc, xm).sum(dim=1))
    return torch.cat(out)


def _mnist_kmedoids(card, x, lab, totals):
    """mnist-kmedoids: ``fit_kmedoids`` at n = 60,000, d = 784, k = 10 from
    the first row of each blob, PAIRWISE_ITERS iterations at most: ms an
    iteration, the cost sweep's share, the peak memory; held, for two
    clusters, to the least f64 cost of their members; then
    ``KMedoids.predict`` (K1)."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models import medoids as M
    from kmeans_tpu_torch.ops.distance import sq_norms

    k = MNIST["k"]
    idx0 = _first_of_each(lab, k)
    cfg = kt.KMeansConfig(k=k)
    # A warm-up iteration pays the process's first products and the
    # tiles' allocations (about 1.8 s in the first card run) before the
    # clock.
    kt.fit_kmedoids(x, k, init=idx0, config=cfg, max_iter=1)
    (st, fit_ms, launches), peak = _peak_above(lambda: _timed_fit(
        lambda: kt.fit_kmedoids(x, k, init=idx0, config=cfg,
                                max_iter=PAIRWISE_ITERS)))
    _add_counts(totals["f32"], launches)
    its = int(st.n_iter)
    _check(bool(st.converged), f"mnist-kmedoids: not converged in {its}")
    # The cost sweep alone, at the fit's labels (one iteration's O(n²)).
    w = torch.ones(x.shape[0], device=x.device)
    x_sq = sq_norms(x)
    kw = dict(metric="euclidean", chunk_size=cfg.chunk_size,
              cd=torch.float32)
    _, sweep_ms = _events_ms(lambda: M._cost_rows(
        x, x_sq, st.labels, x, x_sq, st.labels, w, **kw))
    n, d = x.shape
    flop = 2.0 * n * n * d
    bound = max(flop / F32_OPS_PER_S, 8.0 * n * n / MEM_BYTES_PER_S) * 1e3
    # Two clusters' medoids against the least f64 cost of their members.
    worst = 0.0
    for c in (0, 1):
        members = torch.nonzero(st.labels == c)[:, 0]
        costs = _medoid_costs64(x, members, members)
        chosen = int(st.medoid_indices[c])
        mine = float(costs[(members == chosen).nonzero()[0, 0]])
        least = float(costs.min())
        rel = (mine - least) / least
        worst = max(worst, rel)
        _check(rel <= KMEDOIDS_COST_RTOL,
               f"mnist-kmedoids cluster {c}: medoid {chosen} costs {mine} "
               f"in f64, the least member {least}")
    est = kt.KMedoids(n_clusters=k)
    est.state = st
    (pred, _, pred_launches) = _timed_fit(
        lambda: est.predict(x[:PAIRWISE_PREDICT_ROWS]))
    _add_counts(totals["f32"], pred_launches)
    _check(pred_launches["lloyd_pass_cuda"] >= 1 and bool(torch.equal(
        pred, st.labels[:PAIRWISE_PREDICT_ROWS])),
           f"mnist-kmedoids predict: {pred_launches}")
    print(f"mnist-kmedoids ({card}): n={n} d={d} k={k} f32, {its} "
          f"iterations (converged) in {fit_ms:.1f} ms = {fit_ms / its:.1f} "
          f"ms an iteration (the final assignment included); the cost "
          f"sweep alone {sweep_ms:.1f} ms ({sweep_ms / (fit_ms / its):.0%} "
          f"of an iteration; bound {bound:.1f} ms: 2·n²·d = {flop:.3g} FLOP "
          f"at 67 TFLOP/s, or one f32 write and read of the n² tile); peak "
          f"{peak:.3f} GB above the data; launches {launches}; two "
          f"clusters' medoids within {worst:.2e} of their least f64 member "
          f"cost (bound {KMEDOIDS_COST_RTOL:g}); predict of "
          f"{PAIRWISE_PREDICT_ROWS} rows: the training labels, launches "
          f"{pred_launches}", flush=True)


def _kmedoids_hold(card, x, lab, cpu_hold):
    """mnist-kmedoids' hold on its first PAIRWISE_HOLD_ROWS rows: the
    card's fit against the port's CPU fit (run on a thread beside the
    phase's untimed work)."""
    import torch

    import kmeans_tpu_torch as kt

    k = MNIST["k"]
    cfg = kt.KMeansConfig(k=k)
    h = PAIRWISE_HOLD_ROWS
    idx_h = _first_of_each(lab, k, rows=h)
    card_h = kt.fit_kmedoids(x[:h], k, init=idx_h, config=cfg,
                             max_iter=PAIRWISE_ITERS)
    cpu_h = cpu_hold("kmedoids")
    _check(bool(torch.equal(card_h.medoid_indices.cpu(),
                            cpu_h.medoid_indices))
           and abs(float(card_h.inertia) - float(cpu_h.inertia))
           <= 1e-5 * float(cpu_h.inertia),
           f"mnist-kmedoids hold: card {card_h.medoid_indices.tolist()} "
           f"{float(card_h.inertia)}, CPU {cpu_h.medoid_indices.tolist()} "
           f"{float(cpu_h.inertia)}")
    print(f"mnist-kmedoids hold ({card}): the first {h} rows, the same "
          f"medoid indices as the port's CPU fit, inertia "
          f"{float(card_h.inertia):.6e} against {float(cpu_h.inertia):.6e}")


def _objective_steps(x, labels0, k, cfg):
    """The kernel fit's passes one at a time: ``(objectives at L0..Lt,
    labels, ms a mass pass)``, each objective at the labels it is
    evaluated at (two mass passes a step)."""
    import torch

    from kmeans_tpu_torch.models import kernel as KK

    w = torch.ones(x.shape[0], device=x.device)
    kw = dict(k=k, chunk_size=cfg.chunk_size, compute_dtype=None,
              kernel="rbf", gamma=1.0 / x.shape[1], degree=3, coef0=1.0)
    st0 = KK._kernel_loop(x, labels0, w, max_iter=0, **kw)
    objs, labels, total_ms, passes = [float(st0.objective)], labels0, 0.0, 0
    for _ in range(PAIRWISE_ITERS):
        st, ms = _events_ms(lambda: KK._kernel_loop(x, labels, w,
                                                    max_iter=1, **kw))
        total_ms += ms
        passes += 2
        objs.append(float(st.objective))
        done = bool(torch.equal(st.labels, labels))
        labels = st.labels
        if done:
            break
    return objs, labels, total_ms / passes


def _mnist_kernel(card, x, totals):
    """mnist-kernel: rbf at γ = 1/d from k-means++ and one assignment (K1),
    PAIRWISE_ITERS iterations at most; the objective pass by pass, the
    linear kernel's objective against Lloyd's f64 inertia of its
    partition, and ``kernel_assign`` with the cached T on 8,192 training
    rows."""
    import math

    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.data.synthetic import generator_for
    from kmeans_tpu_torch.models import kernel as KK

    k = MNIST["k"]
    n, d = x.shape
    cfg = kt.KMeansConfig(k=k, seed=5)
    (st, fit_ms, launches), peak = _peak_above(lambda: _timed_fit(
        lambda: kt.fit_kernel_kmeans(x, k, kernel="rbf", config=cfg,
                                     max_iter=PAIRWISE_ITERS)))
    _add_counts(totals["f32"], launches)
    _check(launches["lloyd_pass_cuda"] >= 1,
           f"mnist-kernel: the seeding's assignment ran no K1: {launches}")
    its = int(st.n_iter)
    # The same fit a pass at a time from the same seeded start.
    lab0 = KK._resolve_labels0(x, k, generator_for(cfg.seed, x.device), cfg,
                               None, None)
    objs, lab_steps, pass_ms = _objective_steps(x, lab0, k, cfg)
    diag_sum = float(n)                        # Σ w·K_ii for rbf
    rise_bound = 1e-6 * diag_sum
    rises = [b - a for a, b in zip(objs, objs[1:])]
    _check(max(rises) <= rise_bound and bool(torch.equal(lab_steps,
                                                         st.labels)),
           f"mnist-kernel: objective {objs}, rises {rises} (bound "
           f"{rise_bound}); the stepped labels equal the fit's: "
           f"{bool(torch.equal(lab_steps, st.labels))}")
    flop = 2.0 * n * n * d + 2.0 * n * n * k
    bound = max(flop / F32_OPS_PER_S, 8.0 * n * n / MEM_BYTES_PER_S) * 1e3
    # kernel_assign with the cached T on training rows.
    m = PAIRWISE_PREDICT_ROWS
    (pred, assign_ms, _) = _timed_fit(lambda: kt.models.kernel_assign(
        x[:m], x, st.labels, k=k, within_mass=st.within_mass))
    moved = int((pred != st.labels[:m]).sum())
    _check(moved == 0 or not bool(st.converged),
           f"mnist-kernel kernel_assign: {moved} of {m} training rows moved")
    # The linear kernel: its objective is Lloyd's inertia of its partition.
    lin = kt.fit_kernel_kmeans(x, k, kernel="linear", config=cfg,
                               max_iter=3)
    lab = lin.labels.long()
    xd = x.double()
    sums = torch.zeros(k, d, dtype=torch.float64, device=x.device)
    sums.index_add_(0, lab, xd)
    cnt = torch.bincount(lab, minlength=k).double()
    means = sums / cnt.clamp_min(1)[:, None]
    inertia64 = float(((xd - means[lab]) ** 2).sum())
    sq_total = float((xd * xd).sum())
    lin_bound = 4 * math.log2(n) * 2.0 ** -24 * sq_total
    gap = abs(float(lin.objective) - inertia64)
    _check(gap <= lin_bound, f"mnist-kernel linear: objective "
           f"{float(lin.objective)} against f64 inertia {inertia64}")
    del xd, sums
    ended = "converged" if bool(st.converged) else "stopped"
    print(f"mnist-kernel ({card}): rbf γ=1/{d}, n={n} k={k} f32 from "
          f"k-means++ and K1, {its} iterations ({ended}) "
          f"in {fit_ms:.1f} ms, the seeding included; a mass pass "
          f"{pass_ms:.1f} ms (bound {bound:.1f} ms: 2·n²·(d + k) = "
          f"{flop:.3g} FLOP at 67 TFLOP/s, or one f32 write and read of "
          f"the n² tile); peak {peak:.3f} GB above the data; launches "
          f"{launches}; the objective pass by pass "
          f"{[round(o, 3) for o in objs]}, "
          f"largest rise {max(rises):.3e} (bound {rise_bound:g}: 1e-6 of "
          f"Σ K_ii, the f32 sums' scale); kernel_assign of {m} training "
          f"rows with the cached T: {moved} moved, {assign_ms:.1f} ms; "
          f"linear kernel: objective {float(lin.objective):.6e} against "
          f"Lloyd's f64 inertia of its partition {inertia64:.6e} (|diff| "
          f"{gap:.3e}, bound {lin_bound:.3e}: 4·log₂n·2⁻²⁴·Σ‖x‖²)",
          flush=True)


def _rings_spectral(card, totals, tmp):
    """rings-spectral: ``make_rings`` at RINGS_N_PER rows a ring, the
    embedding split into its stages, then ``fit_spectral`` (K1, K2): its
    seconds and launches; ARI > 0.99 and unit rows.  Returns the rings
    (saved for the CLI run) and the fit."""
    import numpy as np
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.metrics import adjusted_rand_index
    from kmeans_tpu_torch.models import spectral as S

    x, y = kt.data.make_rings(41, RINGS_N_PER)
    np.save(f"{tmp}/rings.npy", x.cpu().numpy())
    n = x.shape[0]
    cfg = kt.KMeansConfig(k=2, seed=1)
    # The embedding's stages, timed on its own row math.
    gen, _ = S.fit_generator(None, cfg, x.device)
    ops = S.landmark_ops(x[S.draw_landmarks(n, 2, None, gen, x.device)],
                         gamma=RINGS_GAMMA, degree=3, coef0=1.0, reg=1e-4)
    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    _sync()
    mark("start")
    S.embed_rows(x, torch.ones(n, device=x.device), ops, k=2,
                 gamma=RINGS_GAMMA, cd=torch.float32, chunk_size=4096,
                 mark=mark)
    events[-1][1].synchronize()
    split = {name: events[i][1].elapsed_time(ev)
             for i, (name, ev) in enumerate(events[1:])}
    st, fit_ms, launches = _timed_fit(lambda: kt.fit_spectral(
        x, 2, gamma=RINGS_GAMMA, config=cfg))
    _add_counts(totals["f32"], launches)
    ari = float(adjusted_rand_index(y, st.labels))
    norms = torch.linalg.norm(st.embedding, dim=1)
    norm_err = float((norms - 1.0).abs().max())
    _check(ari > 0.99 and norm_err <= 1e-6
           and launches["lloyd_pass_cuda"] >= 1,
           f"rings-spectral: ARI {ari}, row norms within {norm_err}, "
           f"launches {launches}")
    print(f"rings-spectral ({card}): n={n} d=2 k=2 γ={RINGS_GAMMA}, 256 "
          f"landmarks: the embedding's stages {split} ms (C tiles, "
          f"degrees, Gram, eigh, U); fit_spectral {fit_ms:.1f} ms in all "
          f"({int(st.n_iter)} Lloyd sweeps on the embedding); launches "
          f"{launches}; ARI against the rings {ari:.6f} (> 0.99), row "
          f"norms within {norm_err:.1e} of 1", flush=True)
    return x, y, st


def _spectral64(x, landmarks, k, gamma, rows, reg=1e-4, chunk=16384):
    """The embedding of ``rows`` recomputed in f64 on the card from the
    same landmarks (every row of x enters the degrees and the Gram), and
    the Gram's eigenvalues."""
    import torch

    lf = landmarks.double()
    l_sq = (lf * lf).sum(1)
    w = torch.exp(-gamma * (l_sq[:, None] - 2 * lf @ lf.T
                            + l_sq[None, :]).clamp_min(0))
    w = 0.5 * (w + w.T)
    s, u = torch.linalg.eigh(w)
    cut = reg * s.max()
    inv_s = torch.where(s > cut, 1.0 / torch.maximum(s, cut), 0.0)
    w_inv = (u * inv_s) @ u.T
    w_inv_sqrt = (u * torch.sqrt(inv_s)) @ u.T
    n = x.shape[0]
    C = torch.empty(n, lf.shape[0], dtype=torch.float64, device=x.device)
    for lo in range(0, n, chunk):
        xb = x[lo:lo + chunk].double()
        xs = (xb * xb).sum(1)
        C[lo:lo + chunk] = torch.exp(-gamma * (
            xs[:, None] - 2 * xb @ lf.T + l_sq[None, :]).clamp_min(0))
    deg = (C @ (w_inv @ C.sum(0))).clamp_min(1e-12)
    Z = (C / torch.sqrt(deg)[:, None]) @ w_inv_sqrt
    del C
    g = Z.T @ Z
    g = 0.5 * (g + g.T)
    s_g, v_g = torch.linalg.eigh(g)
    m = g.shape[0]
    top = torch.arange(m - 1, m - k - 1, -1, device=x.device)
    U = (Z[rows] @ v_g[:, top]) / torch.sqrt(s_g[top].clamp_min(1e-12))
    U = U / torch.linalg.norm(U, dim=1, keepdim=True)
    return U, torch.flip(s_g, (0,))


def _glove_spectral(card, xg, lab_g, totals):
    """glove-spectral at full width: ``spectral_embedding`` of n = 400,000,
    d = 300 rows of GLOVE_SPECTRAL_K blobs to k = GLOVE_SPECTRAL_K, from
    256 landmarks (2–3 rows of each blob), then ``fit_lloyd`` on the
    (n, k) embedding (K1's f32 route, K2, K4 if the adaptive loop
    probes); the projector of SPECTRAL_HOLD_ROWS sampled rows against an
    f64 recomputation on the card, within the Davis–Kahan bound of the
    f64 eigengap."""
    import numpy as np
    import torch

    import kmeans_tpu_torch as kt

    k = GLOVE_SPECTRAL_K
    n, d = xg.shape
    lab = lab_g.cpu().numpy()
    per = np.full(k, 256 // k)
    per[:256 % k] += 1
    lm_idx = np.concatenate([np.flatnonzero(lab == b)[:per[b]]
                             for b in range(k)])
    landmarks = xg[torch.from_numpy(lm_idx).cuda()]
    emb, emb_ms, _ = _timed_fit(lambda: kt.models.spectral_embedding(
        xg, k, landmarks=landmarks))
    st, fit_ms, launches = _timed_fit(lambda: kt.fit_lloyd(
        emb, k, config=kt.KMeansConfig(k=k, seed=2)))
    _add_counts(totals["f32"], launches)
    _check(launches["lloyd_pass_cuda"] >= 1,
           f"glove-spectral: the Lloyd fit ran no K1: {launches}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = torch.randperm(n, generator=gen, device="cuda")[
        :SPECTRAL_HOLD_ROWS]
    u64, s64 = _spectral64(xg, landmarks, k, 1.0 / d, rows)
    p32 = emb[rows].double() @ emb[rows].double().T
    err = float((p32 - u64 @ u64.T).abs().max())
    gap = float(s64[k - 1] - s64[k])
    dk = 64 * 2.0 ** -24 * float(s64[0]) / max(gap, 1e-30)
    tol = max(dk, 1e-4)
    _check(err <= tol, f"glove-spectral: projector error {err:.3e} "
           f"(Davis–Kahan bound {dk:.3e}, eigengap {gap:.3e})")
    print(f"glove-spectral ({card}): n={n} d={d} k={k} f32, 256 landmarks "
          f"(2–3 rows of each of the {k} blobs: a uniform draw leaves about "
          f"eight blobs without one, whose rows embed as rounding noise): "
          f"the embedding {emb_ms:.1f} ms, fit_lloyd on it "
          f"{int(st.n_iter)} sweeps in {fit_ms:.1f} ms; launches "
          f"{launches}; the projector of {SPECTRAL_HOLD_ROWS} rows against "
          f"f64 on the card within {err:.3e} (bound {tol:.3e}: "
          f"64·2⁻²⁴·s₁ over the eigengap s_k − s_(k+1) = {gap:.4e}, or "
          f"1e-4)", flush=True)


def _glove_nystrom(card, xg, totals):
    """glove-nystrom: ``nystrom_features`` with NYSTROM_M landmarks (the
    default draw) on glove's rows, then ``fit_lloyd`` at k = NYSTROM_K
    for NYSTROM_SWEEPS sweeps on K1's f32 route and K2."""
    import torch

    import kmeans_tpu_torch as kt

    gen = torch.Generator(device="cuda").manual_seed(4)
    z, feat_ms, _ = _timed_fit(lambda: kt.models.nystrom_features(
        xg, NYSTROM_M, generator=gen))
    n = z.shape[0]
    c0 = z[torch.arange(0, n, n // NYSTROM_K, device="cuda")[:NYSTROM_K]]
    st, fit_ms, launches = _timed_fit(lambda: kt.fit_lloyd(
        z, NYSTROM_K, init=c0, tol=-1.0, max_iter=NYSTROM_SWEEPS))
    _add_counts(totals["f32"], launches)
    _check(int(st.n_iter) == NYSTROM_SWEEPS
           and launches["lloyd_pass_cuda"] >= 1
           and bool(torch.isfinite(st.inertia)),
           f"glove-nystrom: {int(st.n_iter)} sweeps, launches {launches}")
    flop = 2.0 * n * NYSTROM_M * GLOVE["d"]
    print(f"glove-nystrom ({card}): nystrom_features(m={NYSTROM_M}) of "
          f"{n} x {GLOVE['d']} rows in {feat_ms:.1f} ms (the kernel tiles "
          f"{flop:.3g} FLOP, the transform's product as many again at m = "
          f"{NYSTROM_M}); fit_lloyd at k={NYSTROM_K} on the {n} x "
          f"{NYSTROM_M} features, {NYSTROM_SWEEPS} sweeps in {fit_ms:.1f} "
          f"ms = {fit_ms / NYSTROM_SWEEPS:.2f} ms a sweep; launches "
          f"{launches}", flush=True)


def _pairwise_dp1(card, mesh, x20, x_rings):
    """kmedoids-, kernel- and spectral-dp1-nccl: each sharded fit on an
    NCCL mesh of one against its single-device fit: bit for bit, the time
    ratio and the mesh's traffic."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch import parallel

    k = MNIST["k"]
    cfg = kt.KMeansConfig(k=k, seed=7)
    runs = {
        "kmedoids-dp1-nccl": (
            lambda: parallel.fit_kmedoids_sharded(
                x20, k, mesh=mesh, config=cfg, max_iter=PAIRWISE_ITERS),
            lambda: kt.fit_kmedoids(x20, k, config=cfg,
                                    max_iter=PAIRWISE_ITERS)),
        "kernel-dp1-nccl": (
            lambda: parallel.fit_kernel_kmeans_sharded(
                x20, k, mesh=mesh, config=cfg, max_iter=PAIRWISE_ITERS),
            lambda: kt.fit_kernel_kmeans(x20, k, config=cfg,
                                         max_iter=PAIRWISE_ITERS)),
        "spectral-dp1-nccl": (
            lambda: kt.fit_spectral(x_rings, 2, gamma=RINGS_GAMMA,
                                    config=kt.KMeansConfig(k=2, seed=1),
                                    mesh=mesh),
            lambda: kt.fit_spectral(x_rings, 2, gamma=RINGS_GAMMA,
                                    config=kt.KMeansConfig(k=2, seed=1))),
    }
    for name, (sharded, one) in runs.items():
        sharded()                            # NCCL's communicator, warm
        mesh.reset_stats()
        got, ms_mesh, _ = _timed_fit(sharded)
        stats = {op: list(v) for op, v in mesh.stats.items()}
        want, ms_one, _ = _timed_fit(one)
        its = max(int(got.n_iter), 1)
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, want)
                   if isinstance(a, torch.Tensor))
        _check(same, f"{name}: not the single-device fit bit for bit")
        _check(stats["ring_shift"][0] == 0,
               f"{name}: {stats['ring_shift']} ring shifts at world size 1")
        print(f"{name} ({card}): bit for bit; {ms_mesh:.1f} ms against one "
              f"card's {ms_one:.1f} ms (mesh/one card "
              f"{ms_mesh / ms_one:.3f}); {int(got.n_iter)} iterations, "
              f"all-reduces {stats['all_reduce'][0]} "
              f"({stats['all_reduce'][0] / its:.1f} an iteration), ring "
              f"shifts {stats['ring_shift'][0]} (NCCL at world size 1 "
              f"never shifts)", flush=True)


def _pairwise_rank(spec) -> int:
    """``chip_smoke.py --pairwise-rank SPEC``: one of two gloo ranks on the
    one card: k-medoids and kernel k-means on a ring of two and
    ``spectral_embedding_sharded`` at n = PAIRWISE_GLOO_N, each held by
    rank 0 to one card's fit.  With ``spec["probe"]`` it only sends a
    card tensor to the other rank over gloo directly and records what
    arrived."""
    import torch
    import torch.distributed as dist

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch import parallel
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    mesh = parallel.make_mesh((2, 1), ("data", "model"),
                              devices=["cuda:0"] * 2, backend="gloo")
    out = {"rank": mesh.rank, "runs": {}}
    try:
        if spec.get("probe"):
            t = torch.arange(16, dtype=torch.float32, device="cuda")
            try:
                if mesh.rank == 0:
                    dist.send(t + 1.0, dst=1)
                    out["probe"] = {"sent": True}
                else:
                    got = torch.zeros_like(t)
                    dist.recv(got, src=0)
                    torch.cuda.synchronize()
                    out["probe"] = {"equal": bool(torch.equal(got, t + 1.0))}
            except Exception as e:  # allow-silent-except: the finding
                # (gloo refusing a card tensor) is the probe's record.
                out["probe"] = {"error": f"{type(e).__name__}: {e}"}
            return 0
        n, k = PAIRWISE_GLOO_N, MNIST["k"]
        x, lab, _ = kt.make_blobs(23, n, MNIST["d"], k,
                                  cluster_std=SWEEP_STD)
        idx0 = _first_of_each(lab, k)
        cfg = kt.KMeansConfig(k=k, seed=9)
        its = dict(max_iter=PAIRWISE_ITERS)
        runs = {
            "kmedoids-dp2-gloo": (
                lambda: parallel.fit_kmedoids_sharded(
                    x, k, mesh=mesh, init=idx0, config=cfg, **its),
                lambda: kt.fit_kmedoids(x, k, init=idx0, config=cfg, **its)),
            "kernel-dp2-gloo": (
                lambda: parallel.fit_kernel_kmeans_sharded(
                    x, k, mesh=mesh, config=cfg, **its),
                lambda: kt.fit_kernel_kmeans(x, k, config=cfg, **its)),
            "spectral-dp2-gloo": (
                lambda: parallel.spectral_embedding_sharded(
                    x, k, mesh=mesh, generator=torch.Generator(
                        device="cuda").manual_seed(11)),
                lambda: kt.models.spectral_embedding(
                    x, k, generator=torch.Generator(
                        device="cuda").manual_seed(11))),
        }
        for name, (fn, one) in runs.items():
            mesh.barrier()
            _sync()
            mesh.reset_stats()
            K.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            st = fn()
            _sync()
            rec = out["runs"][name] = {
                "seconds": time.perf_counter() - t0,
                "launches": K.launch_counts(),
                "stats": {op: list(v) for op, v in mesh.stats.items()},
                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                "iters": (int(st.n_iter) if hasattr(st, "n_iter") else 1)}
            if mesh.rank:
                continue
            want = one()
            if name.startswith("spectral"):
                s = torch.randperm(n, generator=torch.Generator(
                    device="cuda").manual_seed(1), device="cuda")[:2048]
                err = float((st[s] @ st[s].T - want[s] @ want[s].T).abs()
                            .max())
                _check(err <= 1e-4, f"{name}: projector error {err}")
                rec["detail"] = (f"the projector of 2048 rows within "
                                 f"{err:.2e} of one card's")
            elif name.startswith("kmedoids"):
                diff = int((st.medoid_indices != want.medoid_indices).sum())
                _check(diff == 0, f"{name}: {diff} medoids differ from one "
                       f"card's: {st.medoid_indices.tolist()} / "
                       f"{want.medoid_indices.tolist()}")
                rec["detail"] = (f"the same {k} medoids, inertia "
                                 f"{float(st.inertia):.6e} against "
                                 f"{float(want.inertia):.6e}")
            else:
                moved = int((st.labels != want.labels).sum())
                _check(moved <= 1e-3 * n and int(st.n_iter) ==
                       int(want.n_iter),
                       f"{name}: {moved} labels moved, "
                       f"{int(st.n_iter)} iterations against "
                       f"{int(want.n_iter)}")
                rec["detail"] = (f"{moved} labels moved (near-ties of the "
                                 f"ring's f32 sum order), objective "
                                 f"{float(st.objective):.6e} against "
                                 f"{float(want.objective):.6e}")
    finally:
        with open(spec["out"] % mesh.rank, "w", encoding="utf-8") as f:
            json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _pairwise_world(tmp, probe=False):
    """Spawn phase 19's gloo world of two ranks on the one card."""
    import os

    from kmeans_tpu_torch.parallel.mesh import free_port

    tag = "probe" if probe else "rank"
    spec = {"out": f"{tmp}/pairwise-{tag}%d.json", "probe": probe}
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE="2",
               PYTHONUNBUFFERED="1")
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--pairwise-rank",
         json.dumps(spec)], cwd=root,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    return procs, spec


def _pairwise_probe(procs, spec):
    """gloo's send / receive of a card tensor: what the probe world found
    (a rank that crashed or hung is a finding too, not a failure of the
    phase: the ring stages through host memory on gloo either way)."""
    deadline = time.monotonic() + 60
    while any(p.poll() is None for p in procs) \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    rcs = [p.returncode for p in procs]
    found = []
    for r in range(2):
        try:
            with open(spec["out"] % r, encoding="utf-8") as f:
                found.append(json.load(f).get("probe"))
        except (OSError, ValueError) as e:
            found.append({"error": f"no record ({type(e).__name__})"})
    return f"exit codes {rcs}; the sender {found[0]}, the receiver {found[1]}"


def _pairwise_cli(tmp):
    """train-mesh (phase 19): ``cli train --mesh 2 --device cpu`` for
    kmedoids, kernel and spectral against ``--mesh 1``, in CPU processes.
    Returns ``{name: (stdout, stderr, rc)}`` and seconds."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    for family in ("kmedoids", "kernel", "spectral"):
        base = ["train", *PAIRWISE_CLI_SMALL, "--model", family]
        runs[family] = base + ["--mesh", "2"]
        runs[f"{family} 1"] = base
    t0 = time.perf_counter()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "kmeans_tpu_torch.cli", *argv], cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in runs.items()}
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=CLI_TIMEOUT_S) + (
                p.returncode,)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, time.perf_counter() - t0


def _check_pairwise_cli(outs, secs):
    for family in ("kmedoids", "kernel", "spectral"):
        res = {}
        for name in (family, f"{family} 1"):
            out, err, rc = outs[name]
            _check(rc == 0, f"train-mesh {name}: exit {rc}, stderr "
                   f"{err[-1500:]}")
            res[name] = json.loads(out.strip().splitlines()[-1])
        two, one = res[family], res[f"{family} 1"]
        same = ("n", "d", "k", "n_iter", "mode", "converged")
        # Spectral's embedding-space inertia is near 0 on separated blobs,
        # where the all-reduces' order moves it in absolute terms.
        atol = 1e-4 if family == "spectral" else 0.0
        _check({f: two[f] for f in same} == {f: one[f] for f in same}
               and two["mesh"] == 2
               and abs(two["inertia"] - one["inertia"])
               <= 1e-5 * abs(one["inertia"]) + atol,
               f"train-mesh {family}: {two} against {one}")
        print(f"train-mesh {family} (--mesh 2 --device cpu): n_iter "
              f"{two['n_iter']}, objective {two['inertia']} against "
              f"--mesh 1's {one['inertia']}")
    print(f"train-mesh (phase 19): {secs:.1f} s for the six CPU runs")


def _pairwise_board(card):
    """The board's train op for kmedoids and kernel at the cap's largest n
    (BOARD_PAIRWISE), on the card: the reference's answer to the request
    (started, with n, d, k), then ``train_done`` with the fitted k."""
    from kmeans_tpu_torch.config import ServeConfig
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.serve.server import KMeansServer

    srv = KMeansServer(ServeConfig(port=0, host="127.0.0.1", tracing=False,
                                   persist_dir=None), device="cuda")
    base = f"http://127.0.0.1:{srv.start().server_address[1]}"
    counts = {}
    try:
        for model in ("kmedoids", "kernel"):
            K.reset_launch_counts()
            args = dict(BOARD_PAIRWISE, model=model)
            wall, evs, done = _board_train(base, f"PW{model[:2].upper()}",
                                           args)
            _add_counts(counts, K.launch_counts())
            _check(done["model"] == model and done["k"] == args["k"]
                   and [e.get("iteration") for e in evs] == [0],
                   f"board train {model}: {done}")
            print(f"board train {model} ({card}): n={args['n']} d=2 k=3, "
                  f"{done['n_iter']} iterations, objective "
                  f"{done['inertia']:.6e}; {wall:.3f} s from the request to "
                  f"train_done", flush=True)
    finally:
        srv.stop()
    return counts


def _cpu_kmedoids_hold(x_hold, idx):
    """The CPU fit mnist-kmedoids' hold is held to, on a thread beside the
    card's work: ``(thread, get)``."""
    import threading

    import kmeans_tpu_torch as kt

    box = {}

    def run():
        try:
            box["kmedoids"] = kt.fit_kmedoids(
                x_hold, MNIST["k"], init=idx,
                config=kt.KMeansConfig(k=MNIST["k"]),
                max_iter=PAIRWISE_ITERS, device="cpu")
        except BaseException as e:  # allow-silent-except: re-raised by get
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()

    def get(name):
        thread.join()
        if "error" in box:
            raise box["error"]
        return box[name]

    return thread, get


def phase_pairwise(card):
    """Phase 19: the pairwise families (see the module docstring).
    Returns the runs' launches by compute: ``{"bf16": {...}, "f32":
    {...}}``."""
    import os
    import shutil
    import tempfile
    import threading

    import torch
    import torch.distributed as dist

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.parallel import make_mesh

    t_all = time.perf_counter()
    totals = {"bf16": {}, "f32": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pairwise_")
    cli = cpu_thread = cli_thread = None
    procs, probe = [], []

    def mark(what):
        print(f"  [phase 19: {what} done at {time.perf_counter() - t_all:.1f}"
              " s]", flush=True)

    try:
        # The timed runs first, with no other process of the phase on the
        # card or the host's cores.
        x, lab, _ = kt.make_blobs(17, MNIST["n"], MNIST["d"], MNIST["k"],
                                  cluster_std=SWEEP_STD)
        _mnist_kmedoids(card, x, lab, totals)
        mark("mnist-kmedoids")
        _mnist_kernel(card, x, totals)
        mark("mnist-kernel")
        x_rings, _, _ = _rings_spectral(card, totals, tmp)
        mark("rings-spectral")
        mesh = make_mesh((1, 1), ("data", "model"))
        _check(mesh.backend == "nccl", f"phase 19's mesh of one: {mesh}")
        try:
            _pairwise_dp1(card, mesh, x[:PAIRWISE_DP_N].contiguous(),
                          x_rings)
        finally:
            dist.destroy_process_group()
        mark("kmedoids-, kernel-, spectral-dp1-nccl")
        del x_rings
        xg, lab_g, _ = kt.make_blobs(0, GLOVE["n"], GLOVE["d"],
                                     GLOVE_SPECTRAL_K)
        _glove_spectral(card, xg, lab_g, totals)
        mark("glove-spectral")
        _glove_nystrom(card, xg, totals)
        del xg, lab_g
        torch.cuda.empty_cache()
        mark("glove-nystrom")
        _add_counts(totals["f32"], _pairwise_board(card))
        mark("the board's train ops")
        # Then the untimed work at once: the CPU processes, the gloo
        # worlds, the CLI's child process and the CPU hold.
        h = PAIRWISE_HOLD_ROWS
        cpu_thread, cpu_hold = _cpu_kmedoids_hold(
            x[:h].cpu(), _first_of_each(lab, MNIST["k"], rows=h))
        cli_out = {}
        cli = threading.Thread(target=lambda: cli_out.update(
            zip(("outs", "secs"), _pairwise_cli(tmp))))
        cli.start()
        probe = _pairwise_world(tmp, probe=True)
        procs, spec = _pairwise_world(tmp)
        spec_cli = {}
        cli_thread = threading.Thread(target=lambda: spec_cli.update(
            run=_CliRun(tmp, "pairwise-cli spectral", [
                "train", "--model", "spectral", "--k", "2", "--input",
                f"{tmp}/rings.npy", "--out", f"{tmp}/board.json"])))
        cli_thread.start()
        _or_stop(procs, lambda: _kmedoids_hold(card, x, lab, cpu_hold))
        del x
        cli_thread.join(timeout=CLI_TIMEOUT_S)
        run = spec_cli.get("run")
        _check(run is not None, "pairwise-cli: the spectral run did not end")
        run.need(0)
        _add_counts(totals["f32"], run.counts)
        _check(run.result["mode"] == "spectral" and run.result["k"] == 2
               and os.path.getsize(f"{tmp}/board.json") > 0,
               f"pairwise-cli: {run.result}")
        print(run.line(f"; wrote the board "
                       f"({os.path.getsize(tmp + '/board.json')} bytes)"))
        ranks = _wait_world("phase 19's gloo world", procs, spec)
        for rank in ranks:
            for rec in rank["runs"].values():
                _add_counts(totals["f32"], rec["launches"])
        for name, rec in ranks[0]["runs"].items():
            shifts = [r["runs"][name]["stats"]["ring_shift"][0]
                      for r in ranks]
            staged = [r["runs"][name]["stats"]["ring_stage"][0]
                      for r in ranks]
            its = max(rec["iters"], 1)
            print(f"{name} ({card}; two ranks share the card, not a scaling "
                  f"number): held to one card's fit ({rec['detail']}); "
                  f"{[round(r['runs'][name]['seconds'], 3) for r in ranks]} "
                  f"s a rank; ring shifts {shifts} "
                  f"({shifts[0] / its:.1f} an iteration), staged through "
                  f"pinned host memory on gloo {staged}; a rank's peak "
                  f"{[round(r['runs'][name]['peak_gb'], 3) for r in ranks]} "
                  f"GB; all-reduces "
                  f"{rec['stats']['all_reduce'][0]}", flush=True)
        print(f"gloo send / receive of a card tensor (a probe world of two "
              f"ranks): {_pairwise_probe(*probe)}")
        cli.join(timeout=CLI_TIMEOUT_S)
        _check("outs" in cli_out, "train-mesh: the CLI runs did not end")
        _check_pairwise_cli(cli_out["outs"], cli_out["secs"])
        cpu_thread.join()
    finally:
        for p in procs + list(probe[0] if probe else []):
            if p.poll() is None:
                p.kill()
            p.wait()
        for thread in (cli, cpu_thread, cli_thread):
            if thread is not None:
                thread.join(timeout=CLI_TIMEOUT_S)
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_all
    print(f"phase 19 ({card}): {secs:.1f} s; launches {totals}")
    return totals


def main() -> int:
    if sys.argv[1:2] == ["--http-client"]:
        return _http_client(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--fleet-cli"]:
        return _fleet_cli(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--train-cli"]:
        return _train_cli(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--board-cli"]:
        return _board_cli(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--continuous-cli"]:
        return _continuous_cli(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-rank"]:
        return _mesh_rank(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--elastic-rank"]:
        return _elastic_rank(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--sharded-rank"]:
        return _sharded_rank(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--families-rank"]:
        return _families_rank(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--sweep-cli"]:
        return _sweep_cli(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--soft-rank"]:
        return _soft_rank(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--pairwise-rank"]:
        return _pairwise_rank(json.loads(sys.argv[2]))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = phase_device()
    if sys.argv[1:] == ["--fold-split"]:
        phase_fold_split()
        return 0
    if sys.argv[1:] == ["--f32-bench"]:
        phase_f32_bench()
        return 0
    if sys.argv[1:] == ["--delta-bench"]:
        phase_delta_bench()
        return 0
    if sys.argv[1:] == ["--fold-bench"]:
        phase_fold_bench()
        return 0
    if sys.argv[1:] == ["--select-bench"]:
        phase_select_bench()
        return 0
    if sys.argv[1:] == ["--accel"]:
        phase_accel_minibatch(card)
        return 0
    if sys.argv[1:] == ["--serve-http"]:
        from kmeans_tpu_torch.data.synthetic import make_blobs

        centres = make_blobs(0, 1, HEADLINE["d"], HEADLINE["k"])[2]
        phase_http(card, centres.cpu().numpy(), {})
        return 0
    if sys.argv[1:] == ["--runner"]:
        phase_build()
        phase_runner(card, None)
        return 0
    if sys.argv[1:] == ["--board"]:
        phase_board(card)
        return 0
    if sys.argv[1:] == ["--stream"]:
        phase_build()
        phase_stream(card)
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
        return 0
    if sys.argv[1:] == ["--mesh"]:
        phase_build()
        phase_mesh(card)
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
        return 0
    if sys.argv[1:] == ["--sharded"]:
        phase_build()
        phase_sharded(card)
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
        return 0
    if sys.argv[1:] == ["--families"]:
        phase_build()
        phase_families(card)
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
        return 0
    if sys.argv[1:] == ["--soft"]:
        phase_build()
        phase_soft(card)
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
        return 0
    if sys.argv[1:] == ["--pairwise"]:
        phase_build()
        phase_pairwise(card)
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
        return 0
    if sys.argv[1:] == ["--fleet"]:
        from kmeans_tpu_torch.data.synthetic import make_blobs

        centres = make_blobs(0, 1, HEADLINE["d"], HEADLINE["k"])[2]
        phase_fleet(card, centres.cpu().numpy(), {})
        return 0
    phase_build()
    phase_kernels()
    kernels, headline_launches, imagenet_c = phase_headline()
    f32_rows = phase_headline_f32()
    phase_whole_fit()
    tiled, codebook_launches, codebook_c = phase_codebook(headline_launches)
    for row in kernels:
        row["launches"] += codebook_launches.get(row["name"], 0)
    kernels += tiled + f32_rows
    serve_rows, serve_summaries = phase_serve(
        card, _serve_models(imagenet_c, codebook_c))
    accel = phase_accel_minibatch(card)
    for row in kernels:
        # Phase 9's launches join the bf16 rows and the f32 route's rows.
        name, _, what = row["name"].partition(" ")
        compute = {"": "bf16", "(f32 route)": "f32"}.get(what)
        if compute:
            row["launches"] += accel[compute].get(name, 0)
    http_summaries = {}
    http_launches = phase_http(card, imagenet_c, serve_summaries,
                               http_summaries)
    fleet_launches = phase_fleet(card, imagenet_c, http_summaries)
    # Phases 10 and 11 serve the imagenet-serve model: their K5 launches
    # join that model's row.
    (row,) = [r for r in serve_rows if "imagenet-serve" in r["name"]]
    print(f"{row['name']} launches: phase 8 {row['launches']} and phase 10 "
          f"{http_launches} (the wrapper's counter in this process), phase "
          f"11 {fleet_launches} (the fleet workers' traces: one "
          "assign.kernel span a dense batch, one assign.rescore span a "
          "rescored pruned batch, held to their engine counters)")
    row["launches"] += http_launches + fleet_launches
    runner = phase_runner(card, codebook_c)
    for row in kernels:
        # Phase 12's launches join the bf16 rows and the f32 route's rows,
        # as phase 9's do.
        name, _, what = row["name"].partition(" ")
        compute = {"": "bf16", "(f32 route)": "f32"}.get(what)
        if compute:
            row["launches"] += runner[compute].get(name, 0)
    board, board_rows = phase_board(card)
    for row in kernels:
        # Phase 13's launches join the bf16 rows and the f32 rows, as
        # phase 12's do.
        name, _, what = row["name"].partition(" ")
        compute = {"": "bf16", "(f32 route)": "f32"}.get(what)
        if compute:
            row["launches"] += board[compute].get(name, 0)
    stream = phase_stream(card)
    for row in kernels:
        # Phase 14's launches (K1 of the final passes, the batch inertia,
        # the coresets and the refits; K2 of the refits) join the bf16 rows
        # and the f32 route's rows, as phase 13's do.
        name, _, what = row["name"].partition(" ")
        compute = {"": "bf16", "(f32 route)": "f32"}.get(what)
        if compute:
            row["launches"] += stream[compute].get(name, 0)
    mesh = phase_mesh(card)
    sharded = phase_sharded(card)
    families = phase_families(card)
    # Phase 7's split before phase 18, whose profiles of thousands of
    # small kernels precede it otherwise (the proof smoke that ran it
    # after them lost records of its own short kernels).
    phase_fold_split()
    soft = phase_soft(card)
    pairwise = phase_pairwise(card)
    names = {row["name"] for row in kernels}
    for row in kernels:
        # Phases 15's to 19's launches (every rank's, every child's, and
        # the single-device fits they are held to) join the bf16 rows and
        # the f32 route's rows, as phase 14's do; phase 17's to 19's f32
        # launches of a kernel with no f32 row (K3, the sharded delta
        # loop's refresh) join its one row.
        name, _, what = row["name"].partition(" ")
        compute = {"": "bf16", "(f32 route)": "f32"}.get(what)
        if compute:
            row["launches"] += sum(
                phase[compute].get(name, 0)
                for phase in (mesh, sharded, families, soft, pairwise))
        if not what and f"{name} (f32 route)" not in names:
            row["launches"] += sum(phase["f32"].get(name, 0)
                                   for phase in (families, soft, pairwise))
    kernels += board_rows + serve_rows
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
