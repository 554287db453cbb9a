#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vqvaehmm_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare OLD NEW
    python3 chip_smoke.py --kernel-times DIR
    python3 chip_smoke.py --scan-clocks

Run from the root of a checkout, on a machine with one CUDA card.  It
imports nothing of JAX.  With --compare it times the serving forward
(kernel A), the fused training step (kernel C), the encoder (kernel 8),
the HMM evidence (kernel 11), the one-kernel decode (kernel 10) and the
Viterbi decode (kernel B), `quantize_st` forward and backward on a VQ
loss at (64, 200) and (8, 200) (the quantizer, kernel 9) and
`DeviceEpochSampler.epoch` at the VQ configuration (kernel D) of two
checkouts of the port in turns (OLD, NEW, NEW, OLD, each built and run in
a process of its own: two versions are compared only on one card within
one run) and prints the four JSON lines, the ratio of the device-busy
times, device operations a call where given, and, for kernel C's float32
mode at its three shapes and kernels 8, 11, 10 and B (Viterbi) at
(64, 200), (1, 200), (460, 20) and (1, 2327), whether the two checkouts'
outputs on fixed seeded inputs agree bit for bit (a SHA-256 of the
output bytes); for kernel C's bfloat16 mode at its three shapes, how far
the new checkout's outputs are from the old one's (two designs sum in
other orders) and whether each repeats bit for bit; a checkout without
git history is enough
(`git archive <commit> | tar -x -C OLD`).  --kernel-times DIR is one such process; where the
checkout's evidence wrapper takes a forced tile and split, it also times
every (tile, split) of kernel 11 at those shapes.  --scan-clocks builds
the kernels again into build/scan_clocks with kernels B and 10
instrumented (thread 0 of block 0 reads the SM's clock after each phase of
the scan) and prints the cycles of each phase at B = 1 over T and at the
bulk shapes.  Without arguments it
runs these phases, each printing one line, any failure
exiting non-zero before a result is printed:

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles every csrc/*.cu kernel from the checkout.
3. kernel A (fused serving forward) against its plain PyTorch version on
   the card, with the published weights: B in {1, 8, 64}, T in
   {37, 200, 512}, scalar and per-sequence valid_to, non-zero tails;
   max-abs error <= 1e-5 on q and <= 1e-4 on mu and logvar (both float32,
   different summation orders).  Row i of a B=8 call must be bit-equal to
   the same row computed alone, and the kernel at each of its tile
   widths (16, 32, 64) bit-equal to the others on the same inputs, also
   at widths whose 2C rows of output exceed every hidden width.
4. kernel B (Viterbi, the segmented max-plus scan of maxplus_scan.cuh)
   at (B, T) in {(1, 200), (64, 200), (1, 2327), (460, 20)}, K=3, ragged
   lengths, and log_A given per sequence, per step and stationary: states
   and score bit-equal to its plain version (the segmented scan in plain
   PyTorch, on the CPU) and to a second call; against the sequential
   decode the score within 1e-4 absolute or 32 float32 roundings of it
   (the scan reassociates the sums at segment boundaries), the states
   equal or a path scoring within that of the optimum; a row of a batch
   bit-equal to the row alone.
5. serving: the published checkpoint behind the stdlib HTTP server on the
   card; /health, /infer in all four modes, /predict, and a wrong-shape
   request that must get a 400.  Every response is held against the same
   request computed by the plain path on the CPU in this process (mu,
   logvar <= 1e-4; mean-field q and /predict <= 1e-5; smoothed and
   filtered probabilities <= 1e-4, since the HMM recursions carry the two
   devices' rounding of the evidence over T steps; Viterbi states equal,
   or a path whose score under the CPU's evidence is within 1e-4 of the
   CPU optimum where two paths tie).  The launch counters of the serving
   forward, the Viterbi kernel and the evidence kernel are reset before
   this phase and must be non-zero after it.
6. times: each kernel and its plain version with CUDA events, median of 5
   windows with [min, max], and as device-busy time a call on the
   profiler, with the kernel's share of its bound: kernel A at (64, 200),
   (1, 200), (1, 37) and (8, 512), kernel B at (64, 200), (1, 200),
   (460, 20) and (1, 2327).
7. kernel C (fused loss and all 18 gradients) against its plain version
   (compute_loss plus autograd) on the card: the published weights at
   (B, T) in {(64, 200), (8, 200)} with ragged lengths, a case with every
   length <= 150 (valid_to < T), u in both layouts, beta in {0.1, 1.0};
   and the probe shape (B=256, T=512, C=16, K=8, hidden 256/128,
   trans_hidden 256) with fresh weights from a seed.  The loss within
   1e-5 relative, each gradient within 1e-4 * max|plain| max-abs (both
   float32, different summation orders); a second call bit-equal to the
   first; one launch a call.
8. kernel D (window gather) against its plain version and the host
   collate at B=64, T=200 on a pool of ragged synthetic sequences, with
   windows at the start and the end of a sequence, ln = min_len and
   ln = T: exactly equal; an epoch of 15 such batches in one launch of
   `gather_epoch`, and in 5 chunks of 3 batches, a launch each, equal to
   its plain version, its chunks and the host collate.
9. training through TrainPipeline with the published configuration on
   the card (4 epochs of 15 steps, save_freq 2): the log shows
   `input_pipeline=device fused=True`; kernel C launches once a step and
   kernel D once an epoch (counts reset just before the run); every
   epoch loss is finite;
   the same pipeline on the CPU (plain versions, the same index stream)
   gives per-epoch losses within 1e-4 relative; a run stopped by SIGTERM
   after epoch 2 and resumed ends bit-equal to the uninterrupted run; the
   trained .npz serves a mean-field request through the port's
   InferenceModel on the card, matching the CPU within 1e-4.
10. times: kernels C and D and their plain versions (kernel C's plain
   version is the forward plus the autograd backward; kernel C at
   (64, 200), (8, 200) and the probe shape in its float32 and its
   bfloat16 mode (phase 29), back to back and as device-busy time a call
   with its share of the bound; kernel D a batch
   and an epoch of 15), and the
   pipeline's training goodput in seqs/s from the log timestamps of the
   steady epochs (2-4).
11. profile: an 8-epoch TrainPipeline run without periodic checkpoints,
   its last epoch traced with torch.profiler on the card alone: the
   goodput of the untraced steady epochs (3-7), the profiler's overhead
   on the host, the device's busy share of the traced epoch's wall and
   (inferred) of an untraced step's, and the device time a step of
   kernel C (and of each of its five kernels), kernel D and the rest
   (clip, Adam).

12. kernel 8 (fused encoder) against its plain version with the published
   weights at (B, T) in {(1, 37), (8, 200), (64, 200), (460, 20),
   (1, 2327)}, valid_to None, scalar and per-sequence, non-zero tails:
   logits within 1e-5 max-abs (both float32, different summation orders);
   a row of a batched call bit-equal to the row alone; each tile width the
   plan can choose (16, 32, 64) bit-equal to the others and within 1e-5
   of the plain version at five shapes, with the published weights and at
   widths where H2 exceeds H1.
13. kernel 11 (HMM evidence) against its plain version at (64, 200) with
   ragged lengths, (1, 2327), (1, 200) and (460, 20), u in both layouts:
   log_obs and log_A within 1e-5 max-abs; batched rows bit-equal to solo
   rows, split and not; each (tile, split) bit-equal to the others and
   within 1e-5 of the plain version at five shapes with a live valid_to
   bound, with the published weights (HP above H1) and at widths where H2
   or K * K exceed the other hidden widths.
14. kernel 10 (one-kernel decode: kernel 11's evidence on persistent
   blocks of a cooperative launch, kernel B's segmented scan) at (64,
   200), (8, 200), (1, 2327), (460, 20) and (1, 200): states bit-equal to
   kernel 11 feeding kernel B and to a second call; against its plain
   version equal, or the path's score under the plain evidence within
   1e-4 absolute of the optimum's, or 32 float32 roundings of that score,
   where two paths tie; the path frozen past each length.
15. bulk scoring at full width with the quality checkpoint and the
   committed Improved head: features from the fixture panel through
   data/market.py; `evaluate`; `Backtester.run(rebalance_freq=5)` with the
   head and with equal weights; `WalkForwardBacktest.run` (252/63/126,
   no retraining); `RegimeBacktest.run` with the argmax decode, the
   one-kernel decode and the model's two-stage decode.  Each is held
   against the same call with device="cpu" in this process: the MSE
   within 1e-5 relative, the weight schedule within 1e-5, every metric
   within 1e-4 relative (the ledger is float64 on the host in both), the
   decoded panel equal or explained by a score tie.  The launch counters
   of kernels 8, 10, 11 and B are reset before the entry points are
   called and read just after them; nothing else launches a kernel in
   between (the decoded panels are recorded inside the closures the entry
   points call), and the counts must be exactly what those calls imply:
   kernel 8 once a Backtester.run that trades and once an argmax decode
   of the panel, kernels 10, 11 and B once each.  After the counts are read, kernel
   8 is also held against its plain version on the backtest's own stack
   of windows with the quality weights.
16. times: the three kernels, kernel B on kernel 11's evidence, and
   their plain versions at (64, 200), (460, 20), (1, 2327) and (1, 200),
   back to back with CUDA events (which holds the host's launch rate for
   a kernel of a few tens of microseconds) and as device-busy time a call
   on the profiler, kernels B and 10 with their share of the bound; the
   wall time of one `Backtester.run`, split into its parts, and of one
   whole-panel decode three ways.

17. kernel 9 (nearest code of the VQ family) against its plain version
   with the committed VQ archive's encoder and codebook: the latents of
   the fixture panel's windows, and random latents at (B, T) in {(1, 37),
   (64, 200), (460, 20), (1, 2327)}, each in the model's (B, D, T) layout
   and flat, a codebook with a duplicated row, and a random (M, D) =
   (64, 32) codebook.  The indices equal, or at each mismatch the two
   codes' float64 scores within 1e-4 or 32 float32 roundings of the score;
   z_q bit-equal to codebook[idx]; a second call bit-equal; a duplicated
   row never chosen over its lower twin.  The quantizer's forward and
   backward kernels on the same cases, each with a ragged bool mask, all
   masked and no mask, in both layouts: idx as above, z_q_st bit-equal to
   the plain version's where the codes agree, the losses within 1e-5
   relative, dz_e bit-equal to `quantize_st_backward_reference`,
   dcodebook within 1e-5 of the sum of its terms' magnitudes (another
   order of summation), a second call of each bit-equal.
18. VQ training through TrainPipeline with artifacts/config_vq.json on the
   card (the synthetic pool, 4 epochs of 15 steps, save_freq 2, the EM fit
   cut to 20 iterations): the quantizer's forward and backward kernels
   launch once a step each, kernel 9's nearest code once a panel pass,
   kernel D once an epoch (counts reset just before, exact); every
   epoch loss finite and within 1e-4 relative of the same run with
   device="cpu", or the first step at which a code parts the two runs
   shown to be a near-tie; a run stopped by SIGTERM after epoch 2 and
   resumed ends bit-equal to the uninterrupted run (parameters, history,
   the archive's vq_* and hmm_* arrays); the archive loads back.
19. VQ serving: artifacts/checkpoints_vq/vq_stack.npz behind the stdlib
   server on the card; /health, /infer in smoothed, filtered, viterbi and
   mean_field (served as smoothed), /predict, a wrong-shape 400; each
   answer held against the same request with device="cpu" in this process
   (codes equal or a near-tie, probabilities and weights <= 1e-4, states
   equal or a score tie); kernel 9 launches exactly once a request and
   kernel B once a viterbi request.
20. times: kernel 9 and its plain version at the four shapes, back to back
   and as device-busy time; the quantizer's two kernels and their plain
   versions at (64, 200) and (8, 200), and `quantize_st` forward and
   backward end to end with its device operations a call; a VQ training
   step's wall, its device time by part and its device operations, from a
   profiler trace of one steady epoch; the same step with
   its convolutions through cuDNN, deterministic and default, and whether
   two runs from one seed repeat; the EM fit's wall.

21. micro-batching: the published checkpoint behind
   `serve(batch=True, max_batch=16, max_wait_ms=2, warmup_lengths=(37, 200,
   512))` on the card.  A burst of 64 mean-field requests from 16 threads,
   T mixed over {37, 200, 512} in length order: fewer dispatches than
   requests (the same requests interleaved by length coalesce little, and
   their dispatches are printed), each row
   bit-equal to the same request served solo by the same model on the
   card and within 1e-5 (q) and 1e-4 (mu, logvar) of the CPU, kernel A's
   launches (counts reset just before) exactly the dispatches plus the 64
   solo calls; p50, p99 and requests a second over HTTP of a solo and the
   batched server under the same bursts; with max_queue=4 a burst gets at
   least one 503 carrying Retry-After: 1.
22. streaming: a 200-frame /stream session of the fixture panel's
   features on the batched server: every settled column within 1e-5 of
   the card's batch filtered_posterior of the whole stream (the gap is
   printed, and whether it is bit-equal) and within 1e-4 of the CPU; peeks
   within 1e-5 of the truncated batch; finish settles the last two
   frames; a carry_state session moved to a second server after 100
   frames continues bit for bit; kernel 11's launches exactly the steps
   run, settled plus peeked; the p50 of a frame in process and over HTTP.
23. hot reload and the CLI: a config on the published `.npz` behind a
   batched server with VQHMM_ENABLE_RELOAD and a token; rewritten to the
   quality checkpoint (same widths) and POSTed to /admin/reload while 8
   threads send requests: none fails, and the answers afterwards equal
   the quality model's solo answers on the card; a wrong token gets 403,
   a failed reload 500 with the old model serving on; memory_allocated
   after five more reloads and gc within 1 MiB of the first's;
   `serve.cli.main` (the `python -m vqvaehmm_tpu_torch.serve.cli` entry
   point) with --device cuda on the published checkpoint: one launch of
   kernel 8, the report within 1e-5 of --device cpu.

24. heads and walk-forward retraining at full width
   (`vqvaehmm_tpu_torch/recipe.py`, the quality checkpoint, the Improved
   head at K=3, 10 assets, hidden 64, windows of 100 every 20 days): the
   data and head stages with the card and with the CPU in this process;
   the frozen posteriors of the head batches within 1e-5 of the CPU's;
   kernel 8 launched exactly once a batch by the head stage (counts reset
   just before it); its 100-epoch loss history within 1e-4 relative of a
   CPU run started from the card's posteriors and the same initial head;
   a second card run bit-equal, and its portfolio_head.npz loading back
   bit for bit.  The backtest stage on both devices from the card's head
   (metrics within 1e-4 relative), then the walk-forward stage (252/63/126,
   a retrain of 20 epochs a window): every window's metrics within 1e-4
   relative of the CPU's, and kernel 8's launches exactly one a retrain,
   one a window, one for the argmax decode and one a per-regime backtest
   that trades, kernel 11 twice (the Viterbi decode and the crash-cost
   smoothed posterior), kernel B once.  train_portfolio,
   train_portfolio_optimizer and train_delta_hedger (pointwise and LSTM)
   for 5 epochs on the recipe's batches, card against the CPU from the
   card's posteriors, within 1e-4 relative.  The wall time of each stage
   on each device.
25. Monte Carlo: the recipe's stage on the card and on the CPU; its
   panel decode kernel 11 once and kernel B once (counts reset just
   before the stage), the states equal to the CPU's or a score tie;
   regime_statistics on them; 1000 x 252 paths with the trained head on
   each device from the same draws (a seeded CPU generator): final values
   within 1e-4 relative, every analyze_monte_carlo statistic within 1e-4
   absolute; the same seed twice on the card bit-equal; the simulation's
   wall ms on each device.

26. the GMM stack on the fixture panel's returns (2327 days, 10 assets):
   `train_improved_system(returns, n_regimes=3, num_epochs=100,
   patience=20)` as scripts/backtest.py calls it, with the temporal chain,
   on the card twice and on the CPU.  The card's EM against the CPU's from
   the same seeded restarts: every restart's final log-likelihood within
   1e-5 relative, and the kept restart's responsibilities within 1e-4
   max-abs, its labels equal (where the devices keep two restarts whose
   likelihoods tie, the card's restart refitted alone on both); the head
   stage on the CPU from the card's detector: the history within 1e-5
   relative, the same stopping epoch; whether the second card run is
   bit-equal.  The archive loads back bit for bit; the chain's smoothed and
   filtered marginals on the card within 1e-4 of the CPU's; the --stack
   gmm report on the card within 1e-4 of the CPU's, and `python -m
   vqvaehmm_tpu_torch.serve.cli --stack gmm --device cuda` in a
   subprocess exits 0 with the same regime.  The wall ms of the EM fit and
   of the head stage on each device.
27. a seed ensemble of artifacts/config_published.json through
   TrainPipeline with training.ensemble_seeds [0, 1, 2, 3], 4 epochs of
   15 steps on the device pipeline: kernel C launched exactly members x
   steps and kernel D once an epoch (counts reset just before); members 0
   and 3 bit-equal, parameters and history, to solo train_model runs on
   the card from the same initial states over the same epochs; the same
   configuration on the CPU: the same best seed and metadata keys, losses
   within 1e-5 relative.  For n in {1, 2, 4, 8} members, a steady epoch's
   wall ms, member-seqs a second and device-busy ms off a profiler trace.
28. host-fed TrainPipeline (6 epochs) with prefetched epochs and with the
   synchronous loop: bit-equal, with the wall ms of a steady epoch of
   each; training.profile_dir writes a Chrome trace naming kernel C.
29. the throughput configuration (compute_dtype bfloat16, matmul_precision
   default; bench.py's headline, the "throughput" variant of
   scripts/throughput_quality_ab.py).  Kernel C's bfloat16-operand mode
   (its products on the tensor cores, csrc/tile_mma.cuh) against its
   plain version at (64, 200), (8, 200) ragged and the probe shape, and at
   BF16_WIDTH_CASES (a last tile of one step at each tile width, T = 1,
   hidden 16/8 with K=2, H2 > H1, K=16, widths not multiples of 16): loss
   and the 18 gradients within BF16_LOSS_TOL and BF16_GRAD_TOL, at the
   first three the float32 mode's gradients at least 10x the latter away,
   a second call and the float32 mode's outputs bit-equal; at
   BF16_ORDER_CASES (short batches of the probe's widths and of K=16),
   where any two float32 orders of the sums part by about BF16_GRAD_TOL
   or more, on ORDER_INPUTS inputs each: the loss within its bar, a
   second call bit-equal, and the gradients' error at most the larger of
   BF16_GRAD_TOL and ORDER_MULT times the plain versions' own spread on
   the same inputs, at the worst input and at the median (its times
   and its five kernels' device split are phase 10's; phase 2 prints the
   HMMA instructions of each kernel's SASS and fails where a bfloat16
   product kernel has none or a float32 kernel has any).  TrainPipeline on
   artifacts/config_published.json in that configuration (fused auto,
   the device input pipeline), 4 epochs of 15 steps: kernel C exactly 60
   launches, all in the bfloat16 mode, kernel D 4; losses finite and
   falling once beta is 1; the CPU (the kernel's plain version) within
   BF16_TRAIN_TOL; a SIGTERM resume bit-equal.  The trained archive
   served over HTTP: /infer in four modes and /predict against the CPU
   within BF16_SERVE_TOL, kernels A, 8 and 11 no launch, kernel B one a
   viterbi request.  A 2-member ensemble: kernel C members x steps.
   A steady epoch of that configuration traced as phase 11 traces the
   float32 one, with kernel C's five kernels' device ms a step.
   vae_hmm_elbo_train_seqs_per_sec_per_chip as bench.py measures it
   (B=64, T=200, the median of 5 windows of the saturated marginal,
   utils/benchmarking.py) in float32 and bfloat16, with the device-busy
   ms a step: a record, not a claim.

30. the whole published recipe: `recipe.main(["--stage", s, "--device",
   d, "--outdir", tmp, "--checkpoint-dir", tmp/checkpoints_quality])` for
   each of its ten stages in turn, at the published epochs (train 150,
   quality 40, vq 40), on the card and then on this machine's CPU, each
   stage's downstream reading the quality checkpoint its own run wrote
   (as --stage all does).  The launch counters are reset before each
   stage on the card and read after it, and every kernel's count must be
   exactly what the code implies for this run (`_recipe_expected`):
   kernels C and D in train and quality, 8, 11 and B in quality, the
   quantizer both ways, the nearest code, D and B in vq, A in eval, 8, 11
   and B downstream as phases 24-25 count them, nothing else.  Every
   file the JAX recipe writes exists; both training runs' losses are
   finite and fall once beta is 1; on the CPU with the plain versions on
   the card's index stream (TrainPipeline with the device sampler), the
   published run's first RECIPE_MATCH_EPOCHS epochs and the quality run's
   first within RECIPE_TOL relative (floor 1) of the card's; the quality
   run's epochs 2 to RECIPE_MATCH_EPOCHS, each trained on the CPU from
   the card's checkpoint before it, printed beside how far the CPU's own
   epoch moves from that state with its weights nudged by RECIPE_NUDGE
   (at lr 1e-3 the run is chaotic: one rounding moves an epoch by up to
   some 1e-4, so no bar of 1e-5 holds there), and the free runs of all
   40 epochs; quality_fixture.json and vq_quality_fixture.json printed
   beside the committed JAX artifacts of the same name (a record, not a
   check); RECIPE_REPORT.md names the card and no TPU; each stage's wall
   seconds on both devices.
31. the rest of the downstream zoo on the card against the CPU, on the
   kernel-8 posteriors (one launch) of the fixture windows: the six
   heads of models/portfolio.py and the five models of models/regime.py
   at the recipe's widths, forward in eval() mode and one Adam step in
   train() mode (the output, loss and gradients within ZOO_TOL, the step
   where |g| >= 1e-6); OnlinePortfolioOptimizer over 20 updates,
   WalkForwardTrainer.run over 3 windows and MetaPortfolioOptimizer's
   meta steps on the hierarchical head and on the LSTM head (whose meta
   step runs with cuDNN off: whether cuDNN's LSTM takes a double backward
   is printed), within ZOO_RUN_TOL; calibrate_regime_thresholds with
   posterior_fn = VAEHMM.posterior, one kernel-8 launch, the thresholds
   within 1e-5 of the CPU's; the Gradio demo with no head checkpoint
   (make_infer_fn) allocating by the seeded TransformerPortfolioOptimizer,
   one kernel-8 launch a click.
32. data-parallel kernel C, in this process at the published shape (B=64,
   T=200, the published weights): kernel C's global-normalisation mode
   (the TPU kernel's axis_name mode, `norm=`) called on each half of a
   batch whose second half's longest row is DP_SHORT steps shorter than
   the first's, the two losses and flat gradients summed, against one
   whole-batch call: the loss within DP_LOSS_TOL relative and each
   gradient within DP_GRAD_TOL of that tensor's largest magnitude, in
   float32 and (against BF16_LOSS_TOL, BF16_GRAD_TOL) in the bfloat16
   mode; each half against its plain version in the same mode (phase 7's
   and phase 29's bars); the sentinel call (norm None) bit-equal to the
   call given the batch's own norm (the parent's outputs are held bit for
   bit by --compare); the halves run with their own valid_to printed,
   how far they part.
33. data-parallel training, the published configuration, 4 epochs.  (a)
   A world of one over NCCL on the card: TrainPipeline(use_mesh=True)
   bit-equal to the same run without a mesh, epoch losses and final
   parameters; kernel C once a step, D once an epoch.  (b) A world of two
   gloo processes sharing the card (NCCL takes one card a rank), each
   launching kernels C and D on its half of every batch: epoch losses
   within DP_EPOCH_TOL relative of (a), the ranks' final parameters
   bit-equal; a run stopped by SIGTERM to rank 0 after epoch 2 (both
   ranks stop) and resumed on one rank within DP_RESUME_TOL of the
   uninterrupted run; a 4-seed ensemble over the two ranks bit-equal,
   member by member, to train_ensemble in this process; sharded
   infer_forward bit-equal to the unsharded call (one kernel-A launch a
   rank); forward_sharded at (2, 2 x 1000, 3) within DP_HMM_TOL of
   ops/hmm.forward, relative (floor 1: log_alpha reaches some 3000 there,
   where a float32 rounding is 2.4e-4).  The launches of kernels C, D and
   A a rank, a step's wall and device-busy ms a rank, and the all-reduce's
   time inside a step timed with it (between two synchronisations, the
   wait for the peer included) and its share of that step are printed
   (the share is a record, not a check).  (c) The ensemble head's 2-D
   (data x model) layout on four gloo processes sharing the card, a 2 x 2
   grid (parallel/dryrun.py::ensemble_2d_check, the JAX dry run's case:
   4 heads, K=3, 8 assets, hidden 16): each rank's rows within 1e-6 of
   the one-process forward, the weights summing to 1 within 1e-4, the
   ranks of a grid row equal.
34. the studies and the reference CLIs: the ten entry points of
   vqvaehmm_tpu_torch/scripts through main(argv) on the card at one seed
   and 2 epochs (STUDY_RUNS), the counts set to 0 just before each and
   read just after: exit 0, a JSON of finite numbers naming the card,
   each kernel's launches exactly as _study_expected derives them from
   the epochs and steps; the A/B's float32 arm's first-epoch loss within
   STUDY_TOL of the same run on the CPU.

The line before the last is a JSON summary of the kernels, each with the
least time the card could take for the same work (`bound_ms`: the larger
of its operations over 67 TFLOP/s of fp32, or for kernel C's bfloat16
mode over 989 TFLOP/s of dense bf16 on the tensor cores, and its input
and output bytes over 3.35 TB/s, from this run's shapes, and for kernel
D from the lengths of the windows it timed), kernel C's bfloat16 mode an
entry of its own (`fused_train_bf16`, with phase 29's launches, times
and headline), and the launches of phases 21-25
(`batched_launches`, `stream_launches`, `cli_launches`, and for the
recipe `head_launches` and `walkforward_launches` of kernel 8 and
`mc_launches` of kernels 11 and B), the ensemble's launches of phase 27
(`ensemble_c_launches`, `ensemble_d_launches`) and, on kernel C's entry,
the ensemble's epoch times, the host-fed epoch times of phase 28 and the
GMM stack's wall times of phase 26 (`gmm_*`), on every kernel phase
30's launches a recipe stage (`recipe_launches`), and on kernel C's
entries phase 32's gaps (`global_norm`) and on kernels C, D and A phase
33's launches a rank (`dp_launches`) and kernel C's step times there
(`dp_step`), and on every kernel phase 34's launches an entry point
(`study_launches`); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "artifacts", "config_published.json")
CHECKPOINT = os.path.join(ROOT, "artifacts", "checkpoints_published",
                          "vae_hmm_trained.npz")
QUALITY_CONFIG = os.path.join(ROOT, "artifacts", "config_quality.json")
QUALITY_CHECKPOINT = os.path.join(ROOT, "artifacts", "checkpoints_quality",
                                  "vae_hmm_trained.npz")
HEAD_CHECKPOINT = os.path.join(ROOT, "artifacts", "portfolio_head.npz")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "market_fixture.csv")
VQ_CONFIG = os.path.join(ROOT, "artifacts", "config_vq.json")
VQ_ARCHIVE = os.path.join(ROOT, "artifacts", "checkpoints_vq",
                          "vq_stack.npz")
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, dense bf16 on
# the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def load_published(torch, device, config=CONFIG, checkpoint=CHECKPOINT):
    from vqvaehmm_tpu_torch.core.config import load_config
    from vqvaehmm_tpu_torch.data.checkpoint import (load_params_npz,
                                                    params_from_numpy)
    from vqvaehmm_tpu_torch.models.vae_hmm import VAEHMM

    model = VAEHMM(load_config(config).model, device=device)
    model.load_state_dict(params_from_numpy(load_params_npz(checkpoint)))
    return model.eval()


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FLOPS):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak for their type (fp32 unless given) and the
    bytes over the memory rate."""
    t_ops, t_bytes = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def token_flops(cfg):
    """FLOPs a time step of the encoder, the prior MLP and the decoder."""
    C, H1, H2, K, D = (cfg.input_dim, cfg.hidden_dim, cfg.hidden_dim2,
                       cfg.K, cfg.hidden_dim)
    enc = 2 * (3 * C * H1 + 3 * H1 * H2 + H2 * K)
    prior = 2 * (cfg.u_dim * cfg.trans_hidden + cfg.trans_hidden * K * K)
    dec = 2 * (K * D + 3 * D * D + 3 * D * D + D * 2 * C)
    return enc, prior, dec


def weight_bytes(*modules) -> int:
    return sum(4 * p.numel() for m in modules for p in m.parameters())


def kernel_bounds(model, B, T, vq=(8, 16)):
    """bound_ms and bound_by of every kernel but kernel D (gather_bound) at
    (B, T) with the published widths (vq: the VQ family's codes and code
    width): each input read once, each output written once."""
    cfg = model.cfg
    C, U, K = cfg.input_dim, cfg.u_dim, cfg.K
    enc, prior, dec = token_flops(cfg)
    N = B * T
    w_enc = weight_bytes(model.encoder)
    w_pri = weight_bytes(model.prior_module)
    w_all = weight_bytes(model)
    return {
        # x -> mu, logvar, q
        "fused_infer": bound_ms(N * (enc + K + dec),
                                4 * N * (3 * C + K) + 4 * B + w_all - w_pri),
        # log_A, log_obs, lengths, log_pi -> states, score
        "viterbi": bound_ms(B * (T - 1) * (2 * K * K + K),
                            4 * N * (K * K + K + 1) + 8 * B + 4 * K),
        # forward, and a backward of twice its operations; x, u, lengths
        # and the weights -> the loss and one gradient a weight
        "fused_train": bound_ms(3 * N * (enc + prior + dec),
                                4 * N * (C + U) + 4 * B + 2 * w_all + 4),
        # the same work with every product's operands in bfloat16: the
        # tensor cores' dense bf16 rate
        "fused_train_bf16": bound_ms(3 * N * (enc + prior + dec),
                                     4 * N * (C + U) + 4 * B + 2 * w_all + 4,
                                     PEAK_BF16_FLOPS),
        # x, valid_to -> logits
        "fused_encode": bound_ms(N * enc, 4 * N * (C + K) + 4 * B + w_enc),
        # x, u -> log_obs, log_A
        "fused_evidence": bound_ms(
            N * (enc + prior + 4 * (K + K * K)),
            4 * N * (C + U + K + K * K) + 4 * B + w_enc + w_pri),
        # x, u, lengths -> states
        "fused_decode": bound_ms(
            N * (enc + prior + 4 * (K + K * K)) + B * (T - 1) * (2 * K * K
                                                                 + K),
            4 * N * (C + U + 1) + 8 * B + w_enc + w_pri),
        # z, codebook -> z_q, idx
        "vq_nearest": bound_ms(2 * N * vq[0] * vq[1],
                               4 * (2 * N * vq[1] + N + vq[0] * vq[1])),
        # z_e, a bool mask, codebook -> z_q_st, idx, the losses
        "quantize_forward": bound_ms(
            2 * N * vq[0] * vq[1] + 5 * N * vq[1],
            4 * (2 * N * vq[1] + N + vq[0] * vq[1] + 2) + N),
        # g, z_e, idx, a bool mask, codebook, three scalars -> dz_e,
        # dcodebook
        "quantize_backward": bound_ms(
            6 * N * vq[1],
            4 * (3 * N * vq[1] + N + 2 * vq[0] * vq[1] + 3) + N),
    }


def gather_bound(C, U, T, ln):
    """bound_ms and bound_by of kernel D for the windows of this run's
    lengths ln (any shape, a window each): the triples read, each window's
    ln steps of the pool read and its T steps written (zeros past ln)."""
    W = ln.size
    return bound_ms(0, 3 * 4 * W + 4 * (C + U) * (W * T + int(ln.sum())))


def kernel_resources(build_log: str, names):
    """'name: N registers, S bytes smem, spills' of each named kernel, from
    what ptxas printed (nvcc -Xptxas -v)."""
    import re

    lines = build_log.splitlines()
    out = []
    for name in names:
        at = next((i for i, line in enumerate(lines)
                   if "Compiling entry function" in line and name in line),
                  None)
        if at is None:
            fail(f"ptxas printed nothing for {name}")
        text = " ".join(lines[at:at + 4])
        regs = re.search(r"Used (\d+) registers", text)
        smem = re.search(r"(\d+) bytes smem", text)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", text)
        out.append(f"{name}: {regs.group(1) if regs else '?'} registers, "
                   f"{smem.group(1) if smem else 0} bytes smem, spills "
                   f"{spill.group(1) if spill else '?'}/"
                   f"{spill.group(2) if spill else '?'} bytes")
    return out


# kernel C's five kernels in each mode, as the build names them
TRAIN_KERNELS = {
    "float32": ("train_pack_kernel", "train_forward_kernel",
                "train_backward_kernel", "train_weight_grad_kernel",
                "train_reduce_kernel"),
    "bfloat16": ("train_pack_bf16_kernel", "train_forward_bf16_kernel",
                 "train_backward_bf16_kernel",
                 "train_weight_grad_bf16_kernel", "train_reduce_kernel")}
# the bfloat16 mode's kernels that compute products
BF16_PRODUCT_KERNELS = TRAIN_KERNELS["bfloat16"][1:4]


def phase_kernel_a(torch, np, model):
    from vqvaehmm_tpu_torch.ops.fused_infer import fused_forward

    dev = model.device
    C = model.cfg.input_dim
    tol = {"mu": 1e-4, "logvar": 1e-4, "q": 1e-5}
    worst = {k: 0.0 for k in tol}
    rng = np.random.default_rng(0)
    n0 = fused_forward.launches
    for B in (1, 8, 64):
        for T in (37, 200, 512):
            x = torch.from_numpy(
                rng.normal(size=(B, C, T)).astype(np.float32)).to(dev)
            lens = rng.integers(1, T + 1, size=B)
            lens[0] = T
            for vt in (T - T // 5, torch.from_numpy(
                    lens.astype(np.int32)).to(dev)):
                got = fused_forward(model, x, valid_to=vt, use_kernel=True)
                want = fused_forward(model, x, valid_to=vt,
                                     use_kernel=False)
                torch.cuda.synchronize()
                for name, g, w in zip(tol, got, want):
                    if not torch.isfinite(g).all():
                        fail(f"kernel A {name} not finite at B={B} T={T}")
                    err = max_abs(g, w)
                    worst[name] = max(worst[name], err)
                    if err > tol[name]:
                        fail(f"kernel A {name} max-abs error {err:.3e} > "
                             f"{tol[name]:.0e} at B={B} T={T}")
    if fused_forward.launches - n0 != 18:
        fail(f"kernel A launched {fused_forward.launches - n0} times for "
             "18 cases")
    say("kernel A", "max-abs error vs plain over 18 cases: "
        + ", ".join(f"{k} {v:.3e} (tol {tol[k]:.0e})"
                    for k, v in worst.items()))

    # a row of a batch is bit-equal to the same row computed alone
    B, T = 8, 200
    x = torch.from_numpy(rng.normal(size=(B, C, T)).astype(np.float32)
                         ).to(dev)
    vt = torch.tensor([200, 150, 37, 199, 1, 120, 64, 200],
                      dtype=torch.int32, device=dev)
    batched = fused_forward(model, x, valid_to=vt, use_kernel=True)
    for i in range(B):
        solo = fused_forward(model, x[i:i + 1], valid_to=vt[i:i + 1],
                             use_kernel=True)
        for name, g, s in zip(("mu", "logvar", "q"), batched, solo):
            if not torch.equal(g[i:i + 1], s):
                fail(f"kernel A row {i} {name}: batched != solo")
    say("kernel A", f"batched rows bit-equal to solo rows (B={B}, T={T}, "
        "per-sequence valid_to)")

    # every tile width computes the same bits (the wrapper's own launch
    # function; these launches are not counted)
    from vqvaehmm_tpu_torch.ops import fused_infer

    from vqvaehmm_tpu_torch.core.config import ModelConfig
    from vqvaehmm_tpu_torch.models.vae_hmm import VAEHMM

    # with more (mu, logvar) rows than any hidden width, those 2C rows are
    # the widest thing a block holds: fresh weights from a seed
    wide = [VAEHMM(ModelConfig(u_dim=4, trans_hidden=8, **kw), device=dev,
                   generator=torch.Generator().manual_seed(11)).eval()
            for kw in (dict(input_dim=40, hidden_dim=64, K=3, hidden_dim2=32),
                       dict(input_dim=5, hidden_dim=8, K=3, hidden_dim2=8))]
    n0 = fused_forward.launches
    for m in [model] + wide:
        C, K = m.cfg.input_dim, m.cfg.K
        for B, T in ((3, 200), (2, 37), (1, 1), (2, 130)):
            x = torch.from_numpy(rng.normal(size=(B, C, T)).astype(
                np.float32)).to(dev)
            vt = torch.from_numpy(rng.integers(1, T + 1, size=B).astype(
                np.int32)).to(dev)
            outs = []
            for tile in fused_infer.TILES:
                out = tuple(torch.empty((B, c, T), device=dev)
                            for c in (C, C, K))
                fused_infer._launch(m, x, vt, tile, out)
                outs.append(out)
            torch.cuda.synchronize()
            want = fused_forward(m, x, valid_to=vt, use_kernel=False)
            at = (f"B={B} T={T} C={C} hidden={m.cfg.hidden_dim}/"
                  f"{m.cfg.hidden_dim2}")
            for tile, out in zip(fused_infer.TILES, outs):
                for name, g, first, w in zip(tol, out, outs[0], want):
                    if not torch.equal(g, first):
                        fail(f"kernel A {name} at tile {tile} differs from "
                             f"tile {fused_infer.TILES[0]} at {at}")
                    if max_abs(g, w) > tol[name]:
                        fail(f"kernel A {name} at tile {tile}: max-abs error "
                             f"{max_abs(g, w):.3e} at {at}")
    if fused_forward.launches != n0:
        fail("the tile-width check changed kernel A's launch count")
    say("kernel A", f"tile widths {fused_infer.TILES} bit-equal to each "
        "other and within tolerance of the plain version at 4 shapes, "
        "ragged last tiles and T=1 among them, with the published weights "
        "and at C=40 hidden 64/32 and C=5 hidden 8/8 (2C rows of output "
        "above every hidden width)")
    return max(worst.values())


def viterbi_inputs(torch, np, rng, B, T, K, dev, a_shape):
    log_pi = torch.log_softmax(torch.from_numpy(
        rng.normal(size=K).astype(np.float32)), 0).to(dev)
    log_A = torch.log_softmax(torch.from_numpy(
        rng.normal(size=a_shape + (K, K)).astype(np.float32)), -1).to(dev)
    log_obs = torch.from_numpy(
        rng.normal(size=(B, T, K)).astype(np.float32) * 2.0).to(dev)
    lens = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    lens[0] = T - 7
    return log_pi, log_A, log_obs, torch.from_numpy(lens).to(dev)


def phase_kernel_b(torch, np, dev):
    from vqvaehmm_tpu_torch.ops.fused_viterbi import (
        viterbi_fused, viterbi_segmented_reference)

    rng = np.random.default_rng(1)
    K = 3
    worst, ties = 0.0, 0
    n0 = viterbi_fused.launches
    cases = [(1, 200, "B,T"), (64, 200, "B,T"), (1, 2327, "B,T"),
             (460, 20, "B,T"), (64, 200, "T"), (64, 200, "stationary")]
    for B, T, kind in cases:
        a_shape = {"B,T": (B, T), "T": (T,), "stationary": ()}[kind]
        args = viterbi_inputs(torch, np, rng, B, T, K, dev, a_shape)
        got = viterbi_fused(*args, use_kernel=True)
        again = viterbi_fused(*args, use_kernel=True)
        want = viterbi_fused(*args, use_kernel=False)
        torch.cuda.synchronize()
        what = f"B={B} T={T} log_A {kind}"
        seg = viterbi_segmented_reference(*(a.cpu() for a in args))
        if not (torch.equal(got.states.cpu(), seg.states)
                and torch.equal(got.score.cpu(), seg.score)):
            fail(f"kernel B differs from its plain version (the segmented "
                 f"scan) at {int((got.states.cpu() != seg.states).sum())} "
                 f"steps or in its score at {what}")
        if not (torch.equal(again.states, got.states)
                and torch.equal(again.score, got.score)):
            fail(f"kernel B: a second call gave other bits at {what}")
        # against the sequential decode: the score to float roundings, the
        # states equal or tied
        tol = torch.clamp(TIE_ULPS * torch.finfo(torch.float32).eps
                          * want.score.double().abs(), min=TIE_ATOL)
        excess = float(((got.score.double() - want.score.double()).abs()
                        / tol).max())
        worst = max(worst, max_abs(got.score, want.score))
        evidence = (args[0], args[1].expand(B, T, K, K), args[2])
        gap, tie_excess = _tie_gap(torch, evidence, got.states, want.states,
                                   args[3])
        ties += int((got.states != want.states).any(dim=1).sum())
        if max(excess, tie_excess) > 1.0:
            fail(f"kernel B against the sequential decode at {what}: score "
                 f"{excess:.2f} and path {tie_excess:.2f} times the "
                 f"tolerance of a tie ({TIE_ATOL:g} or {TIE_ULPS} float32 "
                 "roundings of the score)")
    if viterbi_fused.launches - n0 != 2 * len(cases):
        fail(f"kernel B launched {viterbi_fused.launches - n0} times for "
             f"{2 * len(cases)} calls")
    # a row of a batch is bit-equal to the row alone (not counted)
    args = viterbi_inputs(torch, np, rng, 64, 200, K, dev, (64, 200))
    batched = viterbi_fused(*args, use_kernel=True)
    for i in (0, 1, 31, 63):
        solo = viterbi_fused(args[0], args[1][i:i + 1], args[2][i:i + 1],
                             args[3][i:i + 1], use_kernel=True)
        if not (torch.equal(batched.states[i:i + 1], solo.states)
                and torch.equal(batched.score[i:i + 1], solo.score)):
            fail(f"kernel B row {i} of B=64 T=200: batched != solo")
    say("kernel B", f"bit-equal to its plain version (the segmented scan) "
        f"and to a second call in {len(cases)} cases; against the "
        f"sequential decode the scores within the tie tolerance (max-abs "
        f"{worst:.3e}) and {ties} rows' paths tied within it; batched rows "
        "bit-equal to solo rows")
    return worst


def _request(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        body = json.loads(resp.read())
        return resp.status, body, time.perf_counter() - t0


def _path_score(torch, log_pi, log_A, log_obs, states):
    """log p(z, x) of a path under one sequence's evidence (T steps)."""
    s = states.long()
    score = log_pi[s[0]] + log_obs[0, s[0]]
    for t in range(1, len(s)):
        score = score + log_A[t, s[t - 1], s[t]] + log_obs[t, s[t]]
    return float(score)


def phase_serve(torch, np):
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence
    from vqvaehmm_tpu_torch.ops.fused_infer import fused_forward
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused
    from vqvaehmm_tpu_torch.serve.app import InferenceModel
    from vqvaehmm_tpu_torch.serve.httpd import serve

    with open(CONFIG) as f:
        model_section = json.load(f)["model"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    cfg_path = os.path.join(tmp, "inference_config.json")
    with open(cfg_path, "w") as f:
        json.dump({"model": model_section, "checkpoint_path": CHECKPOINT},
                  f)
    os.environ["VQHMM_REQUIRE_CHECKPOINT"] = "1"

    cpu = InferenceModel(cfg_path, device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = serve(cfg_path, host="127.0.0.1", port=port, background=True,
                  device="cuda")
    url = f"http://127.0.0.1:{port}"
    try:
        if not httpd.vqhmm_model.checkpoint_loaded:
            fail("the server did not load the published checkpoint")
        rng = np.random.default_rng(2)
        C, U = model_section["input_dim"], model_section["u_dim"]
        reqs = []
        for T in (37, 200, 512, 1500):
            reqs.append(("/infer", "mean_field", T))
        reqs += [("/infer", "viterbi", 200), ("/infer", "viterbi", 1500),
                 ("/infer", "smoothed", 200), ("/infer", "filtered", 200),
                 ("/predict", "predict", 200)]
        payloads = []
        for path, mode, T in reqs:
            p = {"x": rng.normal(size=(C, T)).astype(np.float32).tolist()}
            if mode in ("viterbi", "smoothed", "filtered"):
                p["u"] = rng.normal(size=(U, T)).astype(np.float32).tolist()
                p["mode"] = mode
            payloads.append(p)

        fused_forward.launches = 0
        viterbi_fused.launches = 0
        fused_evidence.launches = 0
        status, body, _ = _request(url + "/health")
        if status != 200 or body != {"status": "ok"}:
            fail(f"/health answered {status} {body}")
        responses, lat = [], {}
        for (path, mode, T), p in zip(reqs, payloads):
            times = []
            for _ in range(5):
                status, body, dt = _request(url + path, p)
                if status != 200:
                    fail(f"{path} {mode} T={T} answered {status}")
                times.append(dt)
            responses.append(body)
            lat.setdefault(mode, []).extend(times)
        try:
            _request(url + "/infer", {"x": [[1.0, 2.0]]})
            fail("a request with the wrong C was not refused")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                fail(f"a request with the wrong C got {e.code}, not 400")
        launches = {"fused_infer": fused_forward.launches,
                    "viterbi": viterbi_fused.launches,
                    "fused_evidence": fused_evidence.launches}
        for name, n in launches.items():
            if n == 0:
                fail(f"the serving phase never launched the {name} kernel")
    finally:
        httpd.shutdown()
        httpd.server_close()
        shutil.rmtree(tmp, ignore_errors=True)

    # the same requests through the plain path on the CPU
    worst = {}
    for (path, mode, T), p, got in zip(reqs, payloads, responses):
        if path == "/predict":
            want = cpu.predict(p["x"])
            checks = {"weights": 1e-5, "regime_probs": 1e-5}
        else:
            want = cpu.infer(p["x"], u=p.get("u"), mode=mode)
            checks = {"mu": 1e-4, "logvar": 1e-4,
                      "regime_probs": 1e-5 if mode in ("mean_field",
                                                       "viterbi") else 1e-4}
        for key, tol in checks.items():
            g, w = np.asarray(got[key]), np.asarray(want[key])
            if g.shape != w.shape or not np.isfinite(g).all():
                fail(f"{path} {mode} T={T} {key}: shape {g.shape} vs "
                     f"{w.shape} or non-finite")
            err = float(np.abs(g - w).max())
            worst[f"{mode}.{key}"] = max(worst.get(f"{mode}.{key}", 0.0),
                                         err)
            if err > tol:
                fail(f"{path} {mode} T={T} {key} differs from the CPU plain "
                     f"path by {err:.3e} > {tol:.0e}")
        if mode == "viterbi":
            g, w = np.asarray(got["states"]), np.asarray(want["states"])
            if g.shape != (T,):
                fail(f"viterbi T={T}: states shape {g.shape}")
            if not np.array_equal(g, w):
                # ties: the GPU path must score as well as the CPU optimum
                m = cpu.model
                x = torch.tensor(p["x"])[None]
                u = torch.tensor(p["u"])[None]
                with torch.inference_mode():
                    log_pi, log_A = m.prior(u)
                    log_obs = m._hmm_evidence(x, torch.tensor([T]))
                sg = _path_score(torch, log_pi, log_A[0], log_obs[0],
                                 torch.from_numpy(g))
                sw = _path_score(torch, log_pi, log_A[0], log_obs[0],
                                 torch.from_numpy(w))
                if abs(sg - sw) > 1e-4 * max(1.0, abs(sw)):
                    fail(f"viterbi T={T}: states differ at "
                         f"{int((g != w).sum())} steps and the served path "
                         f"scores {sg} vs the CPU optimum {sw}")
                say("serve", f"viterbi T={T}: {int((g != w).sum())} steps "
                    f"differ on a tie (scores {sg} vs {sw})")
    say("serve", "published checkpoint served on the card matches the CPU "
        "plain path: " + ", ".join(f"{k} {v:.2e}"
                                   for k, v in sorted(worst.items())))
    say("serve", f"kernel launches while serving: {launches}; p50 latency "
        "ms: " + ", ".join(f"{m} {statistics.median(v) * 1e3:.3f}"
                           for m, v in lat.items()))
    return launches


def _time(torch, fn, iters=50, windows=5):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return statistics.median(out), min(out), max(out)


A_SHAPES = ((64, 200), (1, 200), (1, 37), (8, 512))


def phase_times(torch, np, model):
    from vqvaehmm_tpu_torch.ops import fused_infer
    from vqvaehmm_tpu_torch.ops.fused_infer import fused_forward
    from vqvaehmm_tpu_torch.ops.fused_viterbi import (viterbi_fused,
                                                      viterbi_plan)

    dev = model.device
    cfg = model.cfg
    rng = np.random.default_rng(3)
    res = {}
    with torch.inference_mode():
        for B, T in A_SHAPES:
            x = torch.from_numpy(rng.normal(size=(B, cfg.input_dim, T))
                                 .astype(np.float32)).to(dev)
            for use in (False, True):
                fn = lambda: fused_forward(model, x, valid_to=T,  # noqa: E731
                                           use_kernel=use)
                res[("fused_infer", B, T, use)] = _time(torch, fn) + (
                    _device_ms(torch, fn, 10 if use else 3),)
        for B, T in BULK_SHAPES:
            args = viterbi_inputs(torch, np, rng, B, T, cfg.K, dev, (B, T))
            for use in (False, True):
                fn = lambda: viterbi_fused(*args, use_kernel=use)  # noqa
                res[("viterbi", B, T, use)] = _time(
                    torch, fn, iters=50 if use else 1) + (
                    _device_ms(torch, fn, 10 if use else 1),)
    for (name, B, T, use), (med, lo, hi, dev_ms) in res.items():
        line = (f"{name} {'kernel' if use else 'plain '} B={B} T={T}: "
                f"{med:.4f} ms [{lo:.4f}, {hi:.4f}] back to back; device "
                f"busy {_ms(dev_ms)} a call (profiler)")
        if name == "viterbi" and use:
            bound = kernel_bounds(model, B, T)[name][0]
            plan = viterbi_plan(B, T, cfg.K, False,
                                torch.cuda.get_device_properties(
                                    0).multi_processor_count)
            line += (f", bound {bound:.3e} ms"
                     + ("" if dev_ms is None else
                        f" ({100 * bound / dev_ms:.2f}% of it)")
                     + f"; {plan.blocks} blocks of {plan.threads} threads, "
                     f"{plan.lanes} a sequence, {plan.smem} bytes of shared "
                     "memory")
        if name == "fused_infer":
            if use:
                bound = kernel_bounds(model, B, T)[name][0]
                plan = fused_infer.launch_plan(
                    B, T, cfg.input_dim, cfg.hidden_dim, cfg.hidden_dim2,
                    cfg.K, cfg.hidden_dim, torch.cuda.get_device_properties(
                        0).multi_processor_count)
                line += (f", bound {bound:.5f} ms"
                         + ("" if dev_ms is None else
                            f" ({100 * bound / dev_ms:.1f}% of it)")
                         + f"; tile {plan.tile}, {plan.blocks} blocks, "
                         f"{plan.smem} bytes of shared memory")
        say("times", line)
    return res


PROBE = dict(input_dim=16, hidden_dim=256, K=8, hidden_dim2=128, u_dim=4,
             trans_hidden=256)


def train_inputs(torch, np, rng, B, T, C, U, dev, short=None, btu=False):
    x = torch.from_numpy(rng.normal(size=(B, C, T)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(B, U, T)).astype(np.float32))
    if btu:
        u = u.transpose(1, 2).contiguous()
    lens = rng.integers(T // 3, T + 1, size=B).astype(np.int32)
    lens[0] = T
    if short is not None:
        lens = np.minimum(lens, short)
    return x.to(dev), u.to(dev), torch.from_numpy(lens).to(dev)


def probe_model(torch, dev):
    from vqvaehmm_tpu_torch.core.config import ModelConfig
    from vqvaehmm_tpu_torch.models.vae_hmm import VAEHMM

    return VAEHMM(ModelConfig(**PROBE), device=dev,
                  generator=torch.Generator().manual_seed(7))


def phase_kernel_c(torch, np, model):
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads

    dev = model.device
    rng = np.random.default_rng(4)
    probe = probe_model(torch, dev)
    cases = [(model, 64, 200, 1.0, None, False),
             (model, 8, 200, 0.1, None, False),
             (model, 64, 200, 0.1, 150, False),
             (model, 8, 200, 1.0, 150, True),
             (probe, 256, 512, 1.0, None, False)]
    worst, worst_loss = 0.0, 0.0
    n0 = fused_loss_and_grads.launches
    for m, B, T, beta, short, btu in cases:
        cfg = m.cfg
        x, u, lens = train_inputs(torch, np, rng, B, T, cfg.input_dim,
                                  cfg.u_dim, dev, short, btu)
        loss, grads = fused_loss_and_grads(m, x, u, lens, beta,
                                           use_kernel=True)
        loss2, grads2 = fused_loss_and_grads(m, x, u, lens, beta,
                                             use_kernel=True)
        want_loss, want = fused_loss_and_grads(m, x, u, lens, beta,
                                               use_kernel=False)
        torch.cuda.synchronize()
        what = f"B={B} T={T} beta={beta} short={short} btu={btu}"
        if not torch.isfinite(loss) or not all(
                torch.isfinite(g).all() for g in grads.values()):
            fail(f"kernel C gave a non-finite loss or gradient at {what}")
        rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
        worst_loss = max(worst_loss, rel)
        if rel > 1e-5:
            fail(f"kernel C loss {float(loss)} vs plain {float(want_loss)}"
                 f" (relative {rel:.3e} > 1e-5) at {what}")
        for name, w in want.items():
            err = max_abs(grads[name], w)
            bound = 1e-4 * float(w.abs().max())
            worst = max(worst, err)
            if err > bound:
                fail(f"kernel C gradient {name} max-abs error {err:.3e} > "
                     f"{bound:.3e} at {what}")
        if not torch.equal(loss, loss2) or not all(
                torch.equal(grads[n], grads2[n]) for n in grads):
            fail(f"kernel C is not bit-equal across two calls at {what}")
    if fused_loss_and_grads.launches - n0 != 2 * len(cases):
        fail(f"kernel C launched {fused_loss_and_grads.launches - n0} "
             f"times for {2 * len(cases)} calls")
    say("kernel C", f"{len(cases)} cases: loss within {worst_loss:.3e} "
        f"relative (tol 1e-5), gradients within 1e-4 * max|plain| "
        f"(largest max-abs error {worst:.3e}), second call bit-equal")
    return worst


def synthetic_pool(np, rng, C, U):
    from vqvaehmm_tpu_torch.data.synthetic import synthetic_sequences

    xs, us, _ = synthetic_sequences(12, 400, C, U, 3, seed=5)
    lens = rng.integers(200, 401, size=12)
    return ([x[:, :n] for x, n in zip(xs, lens)],
            [u[:, :n] for u, n in zip(us, lens)], lens)


def gather_case(np, rng, lens, B, T, min_len):
    si = rng.integers(0, len(lens), size=B)
    ln = rng.integers(min_len, T + 1, size=B)
    ln[:8] = min_len
    ln[8:16] = T
    st = rng.integers(0, lens[si] - ln + 1)
    st[::4] = 0                                   # windows at the start
    st[1::4] = (lens[si] - ln)[1::4]              # windows at the end
    return [a.astype(np.int32) for a in (si, st, ln)]


def phase_kernel_d(torch, np, dev):
    from vqvaehmm_tpu_torch.data.dataset import collate_fn
    from vqvaehmm_tpu_torch.ops import gather
    from vqvaehmm_tpu_torch.ops.gather import (build_pools, gather_epoch,
                                               gather_epoch_chunks,
                                               gather_windows,
                                               validate_triples)

    rng = np.random.default_rng(6)
    xs, us, lens = synthetic_pool(np, rng, 5, 4)
    px, pu = (torch.from_numpy(a).to(dev) for a in build_pools(xs, us))
    B, T = 64, 200
    worst = 0.0
    n0 = gather_epoch.launches
    for _ in range(4):
        trip = gather_case(np, rng, lens, B, T, 20)
        validate_triples(*trip, lens, T)
        idx = [torch.from_numpy(a).to(dev) for a in trip]
        got = gather_windows(px, pu, *idx, T, use_kernel=True)
        want = gather_windows(px, pu, *idx, T, use_kernel=False)
        torch.cuda.synchronize()
        si, st, ln = trip
        host = collate_fn([(xs[i][:, s:s + n], us[i][:, s:s + n], n)
                           for i, s, n in zip(si, st, ln)], pad_to=T)
        for name, g, w, h in zip(("x", "u"), got, want, host):
            worst = max(worst, max_abs(g, w))
            if not torch.equal(g, w) or not np.array_equal(g.cpu().numpy(),
                                                           h):
                fail(f"kernel D {name} differs from its plain version or "
                     "the host collate")
    if gather_epoch.launches - n0 != 4:
        fail(f"kernel D launched {gather_epoch.launches - n0} times for 4 "
             "calls")
    say("kernel D", "4 batches at B=64, T=200 equal to the plain version "
        "and the host collate bit for bit")

    # an epoch of 15 batches in one launch, and in chunks of 3 batches
    trips = [gather_case(np, rng, lens, B, T, 20) for _ in range(15)]
    trip = [np.stack(a) for a in zip(*trips)]
    validate_triples(*trip, lens, T)
    idx = [torch.from_numpy(a).to(dev) for a in trip]
    n0 = gather_epoch.launches
    got = gather_epoch(px, pu, *idx, T, use_kernel=True)
    torch.cuda.synchronize()
    if gather_epoch.launches - n0 != 1:
        fail(f"the epoch gather launched {gather_epoch.launches - n0} times")
    want = gather_epoch(px, pu, *idx, T, use_kernel=False)
    default = gather.EPOCH_CHUNK_BYTES
    gather.EPOCH_CHUNK_BYTES = 3 * 4 * B * 9 * T         # 3 batches a chunk
    try:
        chunks = list(gather_epoch_chunks(px, pu, *idx, T))
    finally:
        gather.EPOCH_CHUNK_BYTES = default
    torch.cuda.synchronize()
    if gather_epoch.launches - n0 != 6 or len(chunks) != 5:
        fail(f"the epoch gather in chunks of 3 batches launched "
             f"{gather_epoch.launches - n0 - 1} times for 15 batches")
    for k, name in ((0, "x"), (1, "u")):
        joined = torch.cat([c[1 + k] for c in chunks])
        worst = max(worst, max_abs(got[k], want[k]))
        if not torch.equal(got[k], want[k]) or not torch.equal(joined,
                                                                got[k]):
            fail(f"the epoch gather's {name} differs from its plain version "
                 "or from its chunks")
    for i, (si, st, ln) in enumerate(trips):
        host = collate_fn([(xs[j][:, s:s + n], us[j][:, s:s + n], n)
                           for j, s, n in zip(si, st, ln)], pad_to=T)
        if not np.array_equal(got[0][i].cpu().numpy(), host[0]) or \
                not np.array_equal(got[1][i].cpu().numpy(), host[1]):
            fail(f"the epoch gather's batch {i} differs from the host "
                 "collate")
    say("kernel D", "an epoch of 15 batches at B=64, T=200 in one launch "
        "(and in 5 chunks of 3 batches, a launch each) equal to its plain "
        "version and the host collate bit for bit")
    return worst


def _pipeline_cfg(ckpt_dir, **training):
    from vqvaehmm_tpu_torch.core.config import apply_overrides, load_config

    over = [f"training.checkpoint_dir={ckpt_dir}", "training.num_epochs=4",
            "training.save_freq=2"]
    over += [f"training.{k}={json.dumps(v)}" for k, v in training.items()]
    return apply_overrides(load_config(CONFIG), over)


def phase_train(torch, np):
    from vqvaehmm_tpu_torch.data.checkpoint import load_metadata
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads
    from vqvaehmm_tpu_torch.ops.gather import gather_epoch
    from vqvaehmm_tpu_torch.serve.app import InferenceModel
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # the main path: the published configuration on the card
        logs = []

        def log(msg):
            logs.append((time.perf_counter(), msg))

        cfg = _pipeline_cfg(os.path.join(tmp, "gpu"))
        pipe = TrainPipeline(cfg, device="cuda")
        fused_loss_and_grads.launches = 0
        gather_epoch.launches = 0
        state = pipe.train(log_fn=log)
        torch.cuda.synchronize()
        launches = {"fused_train": fused_loss_and_grads.launches,
                    "gather": gather_epoch.launches}
        t = cfg.training
        steps = t.num_epochs * (cfg.data.samples_per_epoch // t.batch_size)
        if not any(m.startswith("input_pipeline=device fused=True")
                   for _, m in logs):
            fail("the training log does not show input_pipeline=device "
                 f"fused=True: {[m for _, m in logs]}")
        # a step is one launch of kernel C; an epoch (one chunk at this
        # configuration) one of kernel D
        expected = {"fused_train": steps, "gather": t.num_epochs}
        if launches != expected:
            fail(f"training launched {launches} in {steps} steps of "
                 f"{t.num_epochs} epochs, not {expected}")
        if state.step != steps:
            fail(f"training made {state.step} updates, not {steps}")
        gpu_hist = pipe.history
        if len(gpu_hist) != t.num_epochs or not np.isfinite(gpu_hist).all():
            fail(f"epoch losses {gpu_hist}")
        stamps = [ts for ts, m in logs if m.startswith("Epoch ")]
        seqs = t.batch_size * (cfg.data.samples_per_epoch // t.batch_size)
        goodput = (len(stamps) - 1) * seqs / (stamps[-1] - stamps[0])
        say("train", f"TrainPipeline on the card: {steps} steps, kernel "
            f"launches {launches}, epoch losses {gpu_hist}")

        # the same pipeline on the CPU: plain versions, same index stream
        cpu = TrainPipeline(_pipeline_cfg(os.path.join(tmp, "cpu"),
                                          input_pipeline="device"),
                            device="cpu")
        cpu.train(log_fn=None)
        rel = max(abs(a - b) / abs(b) for a, b in zip(gpu_hist, cpu.history))
        if rel > 1e-4:
            fail(f"card epoch losses {gpu_hist} vs CPU {cpu.history}: "
                 f"relative {rel:.3e} > 1e-4")
        say("train", f"CPU plain run: epoch losses {cpu.history}, largest "
            f"relative difference {rel:.3e} (tol 1e-4)")

        # exact resume: SIGTERM after epoch 2, then a rerun
        rcfg = _pipeline_cfg(os.path.join(tmp, "resume"))

        def preempt_at_2(msg):
            if msg.startswith("Epoch 2/"):
                os.kill(os.getpid(), signal.SIGTERM)

        first = TrainPipeline(rcfg, device="cuda")
        part = first.train(log_fn=preempt_at_2)
        meta = load_metadata(os.path.join(tmp, "resume", "vae_hmm_periodic"))
        if not first.preempted or part.step != steps // 2 or \
                not meta or not meta.get("preempted"):
            fail(f"SIGTERM did not stop training at epoch 2 (step "
                 f"{part.step}, metadata {meta})")
        second = TrainPipeline(rcfg, device="cuda")
        resumed = second.train(log_fn=None)
        if second.preempted or resumed.step != steps:
            fail(f"the resumed run ended at step {resumed.step}")
        ref = state.model.state_dict()
        for name, v in resumed.model.state_dict().items():
            if not torch.equal(v, ref[name]):
                fail(f"resumed run differs from the uninterrupted run at "
                     f"{name}")
        say("train", "SIGTERM at epoch 2 and resume: final parameters "
            "bit-equal to the uninterrupted run")

        # serve what the card trained
        with open(CONFIG) as f:
            model_section = json.load(f)["model"]
        cfg_path = os.path.join(tmp, "inference_config.json")
        with open(cfg_path, "w") as f:
            json.dump({"model": model_section, "checkpoint_path":
                       os.path.join(tmp, "gpu", "vae_hmm_trained.npz")}, f)
        served = InferenceModel(cfg_path, device="cuda")
        if not served.checkpoint_loaded:
            fail("InferenceModel did not load the trained .npz")
        x = np.random.default_rng(8).normal(size=(5, 200)).astype(
            np.float32).tolist()
        got, want = served.infer(x), InferenceModel(cfg_path,
                                                    device="cpu").infer(x)
        for key in ("mu", "logvar", "regime_probs"):
            g, w = np.asarray(got[key]), np.asarray(want[key])
            if g.shape != w.shape or not np.isfinite(g).all() or \
                    float(np.abs(g - w).max()) > 1e-4:
                fail(f"served {key} of the trained model: shape {g.shape} "
                     f"or values differ from the CPU by more than 1e-4")
        say("train", "the trained .npz serves a mean-field request on the "
            "card, equal to the CPU within 1e-4")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, goodput


C_SHAPES = ((64, 200), (8, 200), (256, 512))      # the last: the probe


def phase_train_times(torch, np, model):
    from vqvaehmm_tpu_torch.ops import fused_train
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads
    from vqvaehmm_tpu_torch.ops.gather import (build_pools, gather_epoch,
                                               gather_windows)

    dev = model.device
    rng = np.random.default_rng(9)
    res, splits = {}, {}
    probe = probe_model(torch, dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, T in C_SHAPES:
        m, iters = (probe, 2) if (B, T) == C_SHAPES[-1] else (model, 20)
        x, u, lens = train_inputs(torch, np, rng, B, T, m.cfg.input_dim,
                                  m.cfg.u_dim, dev)
        # kernel C in its float32 mode and, for the throughput
        # configuration (phase 29), in its bfloat16 mode on the same inputs
        for name, mm in (("fused_train", m),
                         ("fused_train_bf16", _bf16_model(torch, m))):
            for use in (False, True):
                fn = lambda: fused_loss_and_grads(  # noqa: E731
                    mm, x, u, lens, 1.0, use_kernel=use)
                res[(name, B, T, use)] = _time(
                    torch, fn, iters=iters) + (_device_ms(torch, fn, 3),)
            bound = kernel_bounds(m, B, T)[name][0]
            dev_ms = res[(name, B, T, True)][3]
            say("times", f"{name} B={B} T={T}: bound {bound:.5f} ms"
                + ("" if dev_ms is None else
                   f" ({100 * bound / dev_ms:.2f}% of the device time)")
                + f"; {fused_train.train_plan(mm.cfg, B, T, sms)}")
            split = _kernel_split(torch, lambda: fused_loss_and_grads(
                mm, x, u, lens, 1.0, use_kernel=True), TRAIN_KERNELS[
                    "bfloat16" if name.endswith("bf16") else "float32"],
                calls=iters)
            splits[(name, B, T)] = split
            say("times", f"{name} B={B} T={T}: device ms a call by kernel: "
                + ", ".join(f"{k} {_ms(v)}" for k, v in split.items()))
    xs, us, lens = synthetic_pool(np, rng, 5, 4)
    px, pu = (torch.from_numpy(a).to(dev) for a in build_pools(xs, us))
    trip = gather_case(np, rng, lens, 64, 200, 20)
    idx = [torch.from_numpy(a).to(dev) for a in trip]
    for use in (False, True):
        res[("gather", 64, 200, use)] = _time(
            torch, lambda: gather_windows(px, pu, *idx, 200,
                                          use_kernel=use)) + (None,)
    # an epoch of the published configuration: 15 batches of 64
    etrip = [np.stack(a) for a in zip(
        *(gather_case(np, rng, lens, 64, 200, 20) for _ in range(15)))]
    eidx = [torch.from_numpy(a).to(dev) for a in etrip]
    for use in (False, True):
        fn = lambda: gather_epoch(px, pu, *eidx, 200,  # noqa: E731
                                  use_kernel=use)
        res[("gather_epoch", 64, 200, use)] = _time(torch, fn) + (
            _device_ms(torch, fn),)
    # kernel D's bounds for these triples
    C, U = xs[0].shape[0], us[0].shape[0]
    bounds = {"gather": gather_bound(C, U, 200, trip[2]),
              "gather_epoch": gather_bound(C, U, 200, etrip[2])}
    for (name, B, T, use), (med, lo, hi, dev_ms) in res.items():
        say("times", f"{name} {'kernel' if use else 'plain '} "
            f"{'S=15 ' if name == 'gather_epoch' else ''}B={B} "
            f"T={T}: {med:.4f} ms [{lo:.4f}, {hi:.4f}] back to back"
            + ("" if name == "gather" else
               f"; device busy {_ms(dev_ms)} a call (profiler)")
            + (f"; bound {bounds[name][0]:.6f} ms for these triples' "
               f"lengths, {100 * bounds[name][0] / dev_ms:.1f}% of it"
               if name == "gather_epoch" and use and dev_ms else ""))
    return res, bounds, splits


def _kernel_split(torch, fn, names, calls=3):
    """Device-busy ms a call of fn() of each named kernel, off one
    profiler trace of `calls` calls (None for a kernel the trace does not
    hold once a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    found = {name: [] for name in names}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = next((n for n in names if n in e.name), None)
        if name is not None:
            found[name].append((e.time_range.start, e.time_range.end))
    return {name: (_busy_us(ivs) / 1e3 / calls if len(ivs) == calls
                   else None) for name, ivs in found.items()}


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def phase_train_profile(torch, np, dtype="float32"):
    """Goodput of steady epochs without checkpoints, and where the time of
    one steady epoch of the pipeline goes on the card, for the published
    configuration in float32 or (phase 29) in the throughput
    configuration: (goodput, device ms a step of each of kernel C's five
    kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from vqvaehmm_tpu_torch.data.device_sampler import DeviceEpochSampler
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    # CUPTI's set-up, outside the traced epoch
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    # the last epoch (8) is traced on the card alone (no host ops are
    # recorded), from just after the profiler starts to its log line;
    # epochs 3-7 are the untraced steady epochs.  Unlike them, epoch 8
    # draws no next epoch.
    prof = profile(activities=[ProfilerActivity.CUDA])
    stamps, begin = [], []

    def log(msg):
        if not msg.startswith("Epoch "):
            return
        stamps.append(time.perf_counter())
        if msg.startswith("Epoch 7/"):
            prof.start()
            begin.append(time.perf_counter())
        elif msg.startswith("Epoch 8/"):
            prof.stop()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        cfg = (_bf16_cfg if dtype == "bfloat16" else _pipeline_cfg)(
            tmp, num_epochs=8, save_freq=0)
        pipe = TrainPipeline(cfg, device="cuda")
        pipe.train(log_fn=log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t = cfg.training
    B, steps = t.batch_size, cfg.data.samples_per_epoch // t.batch_size
    # gaps[k]: the wall of epoch k + 2, between two log lines
    gaps = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    untraced = gaps[1:6]                                 # epochs 3-7
    steady = len(untraced) * steps * B / (sum(untraced) / 1e3)
    traced = 1e3 * (stamps[7] - begin[0]) / steps
    plain_step = statistics.median(untraced) / steps
    say("profile", f"TrainPipeline ({dtype}), save_freq 0, 8 epochs: ms between "
        f"epoch log lines {[round(g, 3) for g in gaps]}; goodput of the "
        f"untraced epochs 3-7: {steady:.1f} seqs/s")

    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    cats = {"kernel C": [], "kernel D": [], "other (clip, Adam, sums)": []}
    parts = {name: [] for name in TRAIN_KERNELS[dtype]}
    for e in ops:
        part = next((p for p in parts if p in e.name), None)
        key = ("kernel C" if part else "kernel D"
               if "gather_kernel" in e.name else "other (clip, Adam, sums)")
        cats[key].append((e.time_range.start, e.time_range.end))
        if part:
            parts[part].append((e.time_range.start, e.time_range.end))
    if any(len(ivs) != steps for ivs in parts.values()):
        say("profile", "the traced epoch does not hold one launch a step of "
            "each of kernel C's kernels: "
            f"{ {p: len(v) for p, v in parts.items()} }")
    busy = _busy_us(iv for ivs in cats.values() for iv in ivs) / 1e3 / steps
    if busy <= 0.0:
        fail("the profiler saw no device time in the traced epoch")
    # the device time a step does not depend on the host, so its share
    # of an untraced step's wall is inferred from the trace
    say("profile", f"traced epoch 8: {traced:.4f} ms a step against "
        f"{plain_step:.4f} ms a step untraced (profiler overhead "
        f"{traced / plain_step:.3f}x); device busy {busy:.4f} ms a step: "
        f"{100 * busy / traced:.2f}% of the traced wall, "
        f"{100 * busy / plain_step:.2f}% of an untraced step (inferred)")
    for key, ivs in list(cats.items()) + list(parts.items()):
        say("profile", f"  device {key}: {_busy_us(ivs) / 1e3 / steps:.4f} "
            f"ms a step, {len(ivs)} ops in {steps} steps")
    # None for a kernel whose launches the trace did not hold one a step
    # (a lost event would understate its time), as _kernel_split gives it
    split = {name: (_busy_us(ivs) / 1e3 / steps if len(ivs) == steps
                    else None) for name, ivs in parts.items()}

    sampler = DeviceEpochSampler(pipe.load_data(), "cuda")
    t0 = time.perf_counter()
    triples = sampler.sample_indices_fast(B)
    t1 = time.perf_counter()
    sampler.upload(*triples)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    say("profile", f"drawing an epoch's index triples {1e3 * (t1 - t0):.3f}"
        f" ms, uploading them {1e3 * (t2 - t1):.3f} ms (idle card)")
    return steady, split


def _randn(torch, np, rng, shape, dev):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)


def _seeded_model(torch, dev, seed, **widths):
    """A VAE-HMM of the given widths with fresh weights from a seed."""
    from vqvaehmm_tpu_torch.core.config import ModelConfig
    from vqvaehmm_tpu_torch.models.vae_hmm import VAEHMM

    cfg = dict(input_dim=5, hidden_dim=64, K=3, hidden_dim2=32, u_dim=4,
               trans_hidden=128)
    cfg.update(widths)
    return VAEHMM(ModelConfig(**cfg), device=dev,
                  generator=torch.Generator().manual_seed(seed)).eval()


# widths at which one stage's output is wider than the others: H2 above
# H1; HP and K * K above both hidden widths
ENC_WIDTHS = (dict(hidden_dim=8, hidden_dim2=32, K=5),
              dict(hidden_dim=16, hidden_dim2=8, K=8, trans_hidden=256))


def phase_kernel_8(torch, np, model):
    from vqvaehmm_tpu_torch.ops import fused_encoder
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    dev = model.device
    C = model.cfg.input_dim
    rng = np.random.default_rng(12)
    worst, cases = 0.0, 0
    n0 = fused_encode.launches
    for B, T in ((1, 37), (8, 200), (64, 200), (460, 20), (1, 2327)):
        x = _randn(torch, np, rng, (B, C, T), dev)     # non-zero tails
        lens = rng.integers(1, T + 1, size=B)
        lens[0] = T
        for vt in (None, T - T // 5,
                   torch.from_numpy(lens.astype(np.int32)).to(dev)):
            got = fused_encode(model, x, valid_to=vt, use_kernel=True)
            want = fused_encode(model, x, valid_to=vt, use_kernel=False)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"kernel 8 logits {tuple(got.shape)} not finite or "
                     f"misshapen at B={B} T={T}")
            err = max_abs(got, want)
            worst, cases = max(worst, err), cases + 1
            if err > 1e-5:
                fail(f"kernel 8 logits max-abs error {err:.3e} > 1e-5 at "
                     f"B={B} T={T}")
    if fused_encode.launches - n0 != cases:
        fail(f"kernel 8 launched {fused_encode.launches - n0} times for "
             f"{cases} cases")
    B, T = 8, 200
    x = _randn(torch, np, rng, (B, C, T), dev)
    vt = torch.tensor([200, 150, 37, 199, 1, 120, 64, 200],
                      dtype=torch.int32, device=dev)
    batched = fused_encode(model, x, valid_to=vt, use_kernel=True)
    for i in range(B):
        solo = fused_encode(model, x[i:i + 1], valid_to=vt[i:i + 1],
                            use_kernel=True)
        if not torch.equal(batched[i:i + 1], solo):
            fail(f"kernel 8 row {i}: batched != solo")
    say("kernel 8", f"logits max-abs error vs plain over {cases} cases: "
        f"{worst:.3e} (tol 1e-5); batched rows bit-equal to solo rows "
        f"(B={B}, T={T}, per-sequence valid_to)")

    # every tile width the plan can choose computes the same bits (the
    # wrapper's own launch function; these launches are not counted), also
    # where H2 is wider than H1
    n0 = fused_encode.launches
    models = [model] + [_seeded_model(torch, dev, 12, **w)
                        for w in ENC_WIDTHS]
    tiled = 0
    for m in models:
        K = m.cfg.K
        for B, T in ((3, 200), (2, 37), (1, 1), (460, 20), (1, 130)):
            x = _randn(torch, np, rng, (B, C, T), dev)
            vt = torch.from_numpy(rng.integers(1, T + 1, size=B).astype(
                np.int32)).to(dev)
            outs = []
            for tile in fused_encoder.TILES:
                out = torch.empty((B, K, T), device=dev)
                fused_encoder._launch(m, x, vt, tile, out)
                outs.append(out)
            torch.cuda.synchronize()
            want = fused_encode(m, x, valid_to=vt, use_kernel=False)
            at = (f"B={B} T={T} hidden={m.cfg.hidden_dim}/"
                  f"{m.cfg.hidden_dim2} K={K}")
            for tile, out in zip(fused_encoder.TILES, outs):
                if not torch.equal(out, outs[0]):
                    fail(f"kernel 8 at tile {tile} differs from tile "
                         f"{fused_encoder.TILES[0]} at {at}")
                if max_abs(out, want) > 1e-5:
                    fail(f"kernel 8 at tile {tile}: max-abs error "
                         f"{max_abs(out, want):.3e} at {at}")
            tiled += 1
    if fused_encode.launches != n0:
        fail("the tile-width check changed kernel 8's launch count")
    say("kernel 8", f"tile widths {fused_encoder.TILES} bit-equal to each "
        f"other and within 1e-5 of the plain version in {tiled} cases "
        "(ragged last tiles and T=1 among them), with the published weights "
        "and at hidden 8/32 K=5 (H2 above H1) and 16/8 K=8")
    return worst


def decode_inputs(torch, np, rng, model, B, T, ragged, btu):
    """(x, u, lengths or None) on the model's device; x is non-zero past
    the lengths."""
    cfg = model.cfg
    x, u, lens = train_inputs(torch, np, rng, B, T, cfg.input_dim,
                              cfg.u_dim, model.device, None, btu)
    return x, u, (lens if ragged else None)


def phase_kernel_11(torch, np, model):
    from vqvaehmm_tpu_torch.ops import fused_decode, fused_encoder
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence

    rng = np.random.default_rng(13)
    worst = 0.0
    cases = [(64, 200, True, False), (64, 200, True, True),
             (1, 2327, False, False), (1, 2327, False, True),
             (1, 200, True, False), (460, 20, False, True)]
    n0 = fused_evidence.launches
    for B, T, ragged, btu in cases:
        x, u, lens = decode_inputs(torch, np, rng, model, B, T, ragged, btu)
        got = fused_evidence(model, x, u, lens, use_kernel=True)
        want = fused_evidence(model, x, u, lens, use_kernel=False)
        torch.cuda.synchronize()
        for name, g, w in zip(("log_pi", "log_A", "log_obs"), got, want):
            if g.shape != w.shape or not g.is_contiguous() or \
                    not torch.isfinite(g).all():
                fail(f"kernel 11 {name} {tuple(g.shape)} misshapen, strided "
                     f"or not finite at B={B} T={T}")
            err = max_abs(g, w)
            worst = max(worst, err)
            if err > 1e-5:
                fail(f"kernel 11 {name} max-abs error {err:.3e} > 1e-5 at "
                     f"B={B} T={T} btu={btu}")
    if fused_evidence.launches - n0 != len(cases):
        fail(f"kernel 11 launched {fused_evidence.launches - n0} times for "
             f"{len(cases)} cases")
    say("kernel 11", f"log_obs and log_A max-abs error vs plain over "
        f"{len(cases)} cases: {worst:.3e} (tol 1e-5)")

    # a row of a batch is bit-equal to the row alone (no lengths: the
    # encoder's bound max(lengths) is the batch's), split and not
    for B, T in ((8, 200), (160, 64)):
        x, u, _ = decode_inputs(torch, np, rng, model, B, T, False, False)
        _, log_A, log_obs = fused_evidence(model, x, u, use_kernel=True)
        for i in range(B) if B <= 8 else (0, 1, B - 1):
            _, a, o = fused_evidence(model, x[i:i + 1], u[i:i + 1],
                                     use_kernel=True)
            if not (torch.equal(log_A[i:i + 1], a)
                    and torch.equal(log_obs[i:i + 1], o)):
                fail(f"kernel 11 row {i} of B={B} T={T}: batched != solo")
    say("kernel 11", "batched rows bit-equal to solo rows (B=8, T=200 and "
        "B=160, T=64)")

    # every tile width the plan can choose, split and not, computes the
    # same bits (not counted), also where HP, K * K or H2 exceed the other
    # hidden widths
    n0 = fused_evidence.launches
    models = [model] + [_seeded_model(torch, model.device, 13, **w)
                        for w in ENC_WIDTHS]
    tiled = 0
    for m in models:
        K = m.cfg.K
        for B, T, btu in ((3, 200, False), (2, 37, True), (1, 1, False),
                          (64, 20, True), (1, 130, False)):
            x, u, lens = decode_inputs(torch, np, rng, m, B, T, True, btu)
            lens = lens.clamp(max=max(1, T - 3))     # a live bound
            outs = []
            for tile in fused_encoder.TILES:
                for split in (False, True):
                    out = (torch.empty((B, T, K), device=m.device),
                           torch.empty((B, T, K, K), device=m.device))
                    fused_decode._launch_evidence(m, x, u, lens, tile,
                                                  split, out)
                    outs.append(((tile, split), out))
            torch.cuda.synchronize()
            _, want_A, want_obs = fused_evidence(m, x, u, lens,
                                                 use_kernel=False)
            at = (f"B={B} T={T} hidden={m.cfg.hidden_dim}/"
                  f"{m.cfg.hidden_dim2} K={K} HP={m.cfg.trans_hidden}")
            for how, (o, a) in outs:
                if not (torch.equal(o, outs[0][1][0])
                        and torch.equal(a, outs[0][1][1])):
                    fail(f"kernel 11 at (tile, split) {how} differs from "
                         f"{outs[0][0]} at {at}")
                err = max(max_abs(o, want_obs), max_abs(a, want_A))
                if err > 1e-5:
                    fail(f"kernel 11 at (tile, split) {how}: max-abs error "
                         f"{err:.3e} at {at}")
            tiled += 1
    if fused_evidence.launches != n0:
        fail("the tile-width check changed kernel 11's launch count")
    say("kernel 11", f"tile widths {fused_encoder.TILES}, split and not, "
        f"bit-equal to each other and within 1e-5 of the plain version in "
        f"{tiled} cases, with the published weights (HP 128 above H1 64) "
        "and at hidden 8/32 K=5 and 16/8 K=8 HP 256 (K * K 64)")
    return worst


# two decodes of one evidence may part where two paths tie to float32
# rounding: their scores then agree to 1e-4 absolute or 32 float32 roundings
# of the score, the larger (about 1e-2 at T=2327, well under the cost of
# one wrong state)
TIE_ATOL, TIE_ULPS = 1e-4, 32


def _tie_gap(torch, evidence, got, want, lens):
    """(largest absolute gap, largest gap over its tolerance) between the
    scores of two decoded batches under one evidence, over the rows whose
    valid steps differ."""
    log_pi, log_A, log_obs = (a.double().cpu() for a in evidence)
    gap, excess = 0.0, 0.0
    for b in range(got.shape[0]):
        L = got.shape[1] if lens is None else int(lens[b])
        g, w = got[b, :L].cpu(), want[b, :L].cpu()
        if torch.equal(g, w):
            continue
        sg = _path_score(torch, log_pi, log_A[b, :L], log_obs[b, :L], g)
        sw = _path_score(torch, log_pi, log_A[b, :L], log_obs[b, :L], w)
        tol = max(TIE_ATOL, TIE_ULPS * torch.finfo(torch.float32).eps
                  * abs(sw))
        gap = max(gap, abs(sg - sw))
        excess = max(excess, abs(sg - sw) / tol)
    return gap, excess


def phase_kernel_10(torch, np, model):
    from vqvaehmm_tpu_torch.ops.fused_decode import (decode_plan,
                                                     fused_evidence,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused

    rng = np.random.default_rng(14)
    cases = [(64, 200, True, False), (8, 200, True, True),
             (1, 2327, False, False), (460, 20, True, True),
             (1, 200, True, False)]
    worst, ties = 0.0, 0
    n0 = fused_viterbi_states.launches
    plans = []
    for B, T, ragged, btu in cases:
        x, u, lens = decode_inputs(torch, np, rng, model, B, T, ragged, btu)
        got = fused_viterbi_states(model, x, u, lens, use_kernel=True)
        again = fused_viterbi_states(model, x, u, lens, use_kernel=True)
        plain = fused_viterbi_states(model, x, u, lens, use_kernel=False)
        ev = fused_evidence(model, x, u, lens, use_kernel=True)
        staged = viterbi_fused(*ev, lens, use_kernel=True).states
        torch.cuda.synchronize()
        what = f"B={B} T={T} btu={btu}"
        if got.dtype != torch.int32 or tuple(got.shape) != (B, T) or \
                int(got.min()) < 0 or int(got.max()) >= model.cfg.K:
            fail(f"kernel 10 states misshapen or out of range at {what}")
        # the evidence of kernel 11 and the scan of kernel B: their bits
        if not torch.equal(got, staged):
            fail(f"kernel 10 differs from kernel 11 -> kernel B at "
                 f"{int((got != staged).sum())} steps at {what}")
        if not torch.equal(again, got):
            fail(f"kernel 10: a second call gave other states at {what}")
        if not torch.equal(got, plain):
            plain_ev = fused_evidence(model, x, u, lens, use_kernel=False)
            gap, excess = _tie_gap(torch, plain_ev, got, plain, lens)
            worst, ties = max(worst, gap), ties + 1
            if excess > 1.0:
                fail(f"kernel 10 differs from its plain version at "
                     f"{int((got != plain).sum())} steps and scores "
                     f"{gap:.3e} apart, {excess:.1f} times the tolerance "
                     f"of a tie, at {what}")
        if lens is not None:
            for b in range(B):
                L = int(lens[b])
                if not bool((got[b, L:] == got[b, L - 1]).all()):
                    fail(f"kernel 10 path not frozen past length {L} in "
                         f"row {b} at {what}")
        p = decode_plan(model, B, T, x.device)
        plans.append(f"({B}, {T}): tile {p.tile}, {p.grid} blocks of "
                     f"{p.threads}, {p.ntb} tile(s) a block, {p.smem} bytes")
    if fused_viterbi_states.launches - n0 != 2 * len(cases):
        fail(f"kernel 10 launched {fused_viterbi_states.launches - n0} "
             f"times for {2 * len(cases)} calls")
    say("kernel 10", f"{len(cases)} cases: states bit-equal to kernel 11 -> "
        f"kernel B and to a second call; against the plain version equal "
        f"except {ties} cases tied within {worst:.3e} of score (tol "
        f"{TIE_ATOL:g} or {TIE_ULPS} float32 roundings of the score); tails "
        "frozen; plans " + "; ".join(plans))
    return worst


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _metrics_gap(got, want) -> float:
    """Largest relative difference over BacktestResult.metrics."""
    if got.metrics.keys() != want.metrics.keys():
        fail(f"metrics {sorted(got.metrics)} vs {sorted(want.metrics)}")
    return max(_rel(got.metrics[k], v) for k, v in want.metrics.items())


def bulk_stack(torch, device):
    """The quality model and the Improved head on `device`, as closures
    for the backtester."""
    from vqvaehmm_tpu_torch.data.checkpoint import load_improved_head
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_viterbi_states

    model = load_published(torch, torch.device(device), QUALITY_CONFIG,
                           QUALITY_CHECKPOINT)
    head = load_improved_head(HEAD_CHECKPOINT, device=device)

    def posterior_fn(x):
        with torch.inference_mode():
            return model.posterior(x)

    def model_fn(q):
        with torch.inference_mode():
            return head(q)

    def equal_fn(q):
        n = head.cfg.n_assets
        return torch.full((q.shape[0], n), 1.0 / n, device=q.device)

    def one_kernel_decode(x, u):
        with torch.inference_mode():
            return fused_viterbi_states(model, x, u)

    def two_stage_decode(x, u):
        with torch.inference_mode():
            return model.viterbi_decode(x, u)

    return dict(model=model, head=head, posterior_fn=posterior_fn,
                model_fn=model_fn, equal_fn=equal_fn,
                decoders={"one_kernel": one_kernel_decode,
                          "two_stage": two_stage_decode})


def _recording(fn, log):
    """fn, appending each of its results to `log`."""
    def wrapped(*args):
        out = fn(*args)
        log.append(out)
        return out
    return wrapped


def phase_bulk(torch, np):
    from vqvaehmm_tpu_torch.backtest import (Backtester, RegimeBacktest,
                                             WalkForwardBacktest)
    from vqvaehmm_tpu_torch.data import market
    from vqvaehmm_tpu_torch.eval.evaluate import evaluate
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused

    t0 = time.perf_counter()
    prices, regime, _ = market.load_fixture_frames(FIXTURE)
    x, u, ret, aligned = market.prepare_sequences(prices, regime)
    xs, us = market.create_sequences(x, u)
    recipe_ms = 1e3 * (time.perf_counter() - t0)
    seqs = (np.transpose(xs, (0, 2, 1)).astype(np.float32),
            np.transpose(us, (0, 2, 1)).astype(np.float32))
    data, u_data = np.transpose(x)[None], np.transpose(u)[None]
    panel = (data, aligned.values, ret.values)
    T = data.shape[2]
    say("bulk", f"fixture panel through data/market.py in {recipe_ms:.1f} ms:"
        f" {T} days, {aligned.values.shape[1]} assets, {len(seqs[0])} "
        "sequences of 100")

    gpu, cpu = bulk_stack(torch, "cuda"), bulk_stack(torch, "cpu")
    kw = dict(initial_capital=100000.0, tx_cost=0.001, slippage=0.0005)
    bt = {"cuda": Backtester(device="cuda", **kw),
          "cpu": Backtester(device="cpu", **kw)}
    worst = {}
    fused_encode.launches = 0
    fused_evidence.launches = 0
    fused_viterbi_states.launches = 0
    viterbi_fused.launches = 0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bulk_")
    try:
        mse = {d: evaluate(QUALITY_CONFIG, QUALITY_CHECKPOINT, seqs,
                           output=os.path.join(tmp, d, "eval_results.txt"),
                           log_fn=None, device=d) for d in ("cuda", "cpu")}
        with open(os.path.join(tmp, "cuda", "eval_results.txt")) as f:
            written = f.read()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not np.isfinite(mse["cuda"]) or \
            written != f"Mean Recon MSE: {mse['cuda']}\n":
        fail(f"evaluate wrote {written!r} for an MSE of {mse['cuda']}")
    worst["evaluate MSE"] = _rel(mse["cuda"], mse["cpu"])
    if worst["evaluate MSE"] > 1e-5:
        fail(f"evaluate: MSE {mse['cuda']} on the card vs {mse['cpu']} on "
             "the CPU (> 1e-5 relative)")

    # Backtester.run with the head and with equal weights
    runs = 0                  # Backtester.run calls on the card that trade
    results = {}
    for name in ("model_fn", "equal_fn"):
        got, want = (bt[d].run(s[name], s["posterior_fn"], *panel,
                               rebalance_freq=5)
                     for d, s in (("cuda", gpu), ("cpu", cpu)))
        if len(got.equity_curve) != T or \
                not np.isfinite(got.equity_curve).all() or \
                not got.positions.any():
            fail(f"Backtester.run({name}): equity curve of "
                 f"{len(got.equity_curve)} steps, not finite or never "
                 "invested")
        worst[f"backtest {name}"] = _metrics_gap(got, want)
        results[name] = got
        runs += 1
    # walk-forward, no retraining
    wf = {d: WalkForwardBacktest(train_window=252, test_window=63,
                                 retrain_freq=126, backtester=bt[d]).run(
              s["model_fn"], s["posterior_fn"], lambda window: None, *panel)
          for d, s in (("cuda", gpu), ("cpu", cpu))}
    if len(wf["cuda"]) != len(wf["cpu"]) or not wf["cuda"]:
        fail(f"walk-forward windows: {len(wf['cuda'])} vs {len(wf['cpu'])}")
    worst["walk-forward"] = max(_metrics_gap(g, w)
                                for g, w in zip(wf["cuda"], wf["cpu"]))
    runs += len(wf["cuda"])       # each window trades from its warm-up
    # per-regime breakdown, three decodes.  The decoded panel is taken
    # from inside the closure RegimeBacktest.run calls, so that the window
    # of the launch counts holds the entry points' launches alone.
    counts, panel_decodes = {}, 0
    modes = [("argmax", {})] + [
        (name, dict(decode="viterbi", u=u_data)) for name in gpu["decoders"]]
    for name, extra in modes:
        regimes, per = {}, {}
        for d, s in (("cuda", gpu), ("cpu", cpu)):
            seen = []
            if name == "argmax":
                post = _recording(s["posterior_fn"], seen)
                call = dict(extra)
            else:
                post = s["posterior_fn"]
                call = dict(extra, decode_fn=_recording(s["decoders"][name],
                                                        seen))
            per[d] = RegimeBacktest(bt[d]).run(
                s["model_fn"], post, *panel, K=s["model"].cfg.K, **call)
            # the first result is the whole panel's
            if not seen or seen[0].shape[0] != 1 or seen[0].shape[-1] != T:
                fail(f"RegimeBacktest {name} on {d}: the run did not decode "
                     "the panel through the function it was given")
            if name == "argmax":
                regimes[d] = seen[0].argmax(dim=1)[0].cpu()
            else:
                if len(seen) != 1:
                    fail(f"RegimeBacktest {name} on {d}: decode_fn called "
                         f"{len(seen)} times")
                regimes[d] = seen[0][0].cpu()
        counts[name] = np.bincount(regimes["cuda"].numpy(),
                                   minlength=3).tolist()
        panel_decodes += name == "argmax"
        # a regime is backtested from 20 days on, and trades (one stack of
        # windows through posterior_fn) from 22 on
        runs += sum(1 for k in per["cuda"] if counts[name][k] > 21)
        if torch.equal(regimes["cuda"], regimes["cpu"]):
            if per["cuda"].keys() != per["cpu"].keys() or not per["cuda"]:
                fail(f"RegimeBacktest {name}: regimes {sorted(per['cuda'])} "
                     f"vs {sorted(per['cpu'])}")
            worst[f"regimes {name}"] = max(
                _metrics_gap(per["cuda"][k], per["cpu"][k])
                for k in per["cuda"])
        elif name == "argmax":
            fail(f"argmax regimes differ at "
                 f"{int((regimes['cuda'] != regimes['cpu']).sum())} steps")
        else:
            with torch.inference_mode():
                ev = fused_evidence(cpu["model"], torch.from_numpy(
                    data.astype(np.float32)), torch.from_numpy(
                    u_data.astype(np.float32)))
            gap, excess = _tie_gap(torch, ev, regimes["cuda"][None],
                                   regimes["cpu"][None], None)
            if excess > 1.0:
                fail(f"RegimeBacktest {name}: the card's path scores "
                     f"{gap:.3e} from the CPU's, {excess:.1f} times the "
                     "tolerance of a tie")
            say("bulk", f"regimes {name}: "
                f"{int((regimes['cuda'] != regimes['cpu']).sum())} steps "
                f"differ on a score tie ({gap:.3e} of score)")
    # the entry points are done: read the counts before anything else
    # touches a kernel
    launches = {"fused_encode": fused_encode.launches,
                "fused_evidence": fused_evidence.launches,
                "fused_decode": fused_viterbi_states.launches,
                "viterbi": viterbi_fused.launches}
    expected = {"fused_encode": runs + panel_decodes, "fused_evidence": 1,
                "fused_decode": 1, "viterbi": 1}
    if launches != expected:
        fail(f"the bulk path launched {launches}; its {runs} trading "
             f"Backtester.run calls, {panel_decodes} argmax decode of the "
             f"panel, one one-kernel decode and one two-stage decode imply "
             f"{expected}")
    for key, gap in worst.items():
        if key != "evaluate MSE" and gap > 1e-4:
            fail(f"{key}: a metric differs by {gap:.3e} relative from the "
                 "CPU's (> 1e-4)")

    # outside the counted window: the weight schedule against the CPU's,
    # and kernel 8 against its plain version on the schedule's own stack
    # of windows with the quality weights
    stacks = []

    def stack_posterior(x):
        stacks.append(x)
        return gpu["posterior_fn"](x)

    sched = {"cuda": bt["cuda"]._weight_schedule(
                 gpu["model_fn"], stack_posterior, data, T, 5),
             "cpu": bt["cpu"]._weight_schedule(
                 cpu["model_fn"], cpu["posterior_fn"], data, T, 5)}
    if not np.array_equal(sched["cuda"][0], sched["cpu"][0]):
        fail("the rebalance steps differ between the card and the CPU")
    worst["weights"] = float(np.abs(sched["cuda"][1] - sched["cpu"][1]).max())
    if worst["weights"] > 1e-5:
        fail(f"head weights differ by {worst['weights']:.3e} > 1e-5")
    windows = len(sched["cuda"][0])
    with torch.inference_mode():
        xw = stacks[0]
        err = max_abs(fused_encode(gpu["model"], xw, use_kernel=True),
                      fused_encode(gpu["model"], xw, use_kernel=False))
    if tuple(xw.shape) != (windows, gpu["model"].cfg.input_dim, 20) or \
            not xw.is_cuda:
        fail(f"the backtest's stack of windows is {tuple(xw.shape)} on "
             f"{xw.device}")
    worst["kernel 8 against plain on the stack"] = err
    if err > 1e-5:
        fail(f"kernel 8 logits on the backtest's {tuple(xw.shape)} stack "
             f"with the quality weights: max-abs error {err:.3e} > 1e-5")
    m = results["model_fn"].metrics
    say("bulk", f"evaluate MSE {mse['cuda']:.6g}; Backtester.run over "
        f"{windows} windows: total return {m['total_return']:.4f}, Sharpe "
        f"{m['sharpe_ratio']:.4f} (equal weight "
        f"{results['equal_fn'].metrics['sharpe_ratio']:.4f}); "
        f"{len(wf['cuda'])} walk-forward windows; regime counts {counts}")
    say("bulk", "card against CPU, largest difference: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f"; kernel launches {launches}")
    return launches, dict(panel=panel, data=data, u_data=u_data, gpu=gpu,
                          bt=bt["cuda"], windows=windows)


def _wall(torch, fn, repeats=5):
    """Host-clock ms of fn() ending in a synchronise: median, min, max."""
    out = []
    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    out = out[1:]                                        # the first warms up
    return statistics.median(out), min(out), max(out)


def _device_trace(torch, fn, calls=10, kernels=None):
    """(device-busy ms a call of fn(), device operations a call), from a
    torch.profiler trace of the card alone: the union of its kernels'
    intervals over `calls` calls, and their count.  Unlike a back-to-back
    event time, the busy time does not contain the host's launch rate.
    Late in a run the profiler was seen to keep 9 of the 10 events of ten
    one-kernel calls, an event lost from the middle of the trace, which
    read a tenth low.  So a trace with fewer events than calls is taken
    again, twice; then the time is None and printed as not measured (the
    CUDA-event time beside it stands).  kernels: the kernels fn launches a
    call, where its wrapper counts them; the time a call is then the mean
    of the kernels the trace holds times that count, which a lost event
    does not bias."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ops = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        busy = _busy_us(ops)
        if kernels is not None and ops and len(ops) <= calls * kernels:
            return busy / 1e3 / len(ops) * kernels, len(ops) / calls
        if busy > 0.0 and len(ops) >= calls:
            return busy / 1e3 / calls, len(ops) / calls
        say("times", f"a profiler trace of {calls} calls held "
            f"{len(ops)} device events, fewer than the calls (attempt "
            f"{attempt + 1} of 3)")
    return None, None


def _device_ms(torch, fn, calls=10, kernels=None):
    """Device-busy ms a call of fn() (see _device_trace)."""
    return _device_trace(torch, fn, calls, kernels)[0]


def _ms(value) -> str:
    return "not measured" if value is None else f"{value:.4f} ms"


def phase_bulk_times(torch, np, model, bulk):
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused

    rng = np.random.default_rng(16)
    res = {}
    with torch.inference_mode():
        for B, T in ((64, 200), (460, 20), (1, 2327), (1, 200)):
            x, u, _ = decode_inputs(torch, np, rng, model, B, T, False,
                                    False)
            slow = 2 if T > 1000 else 10
            for use in (False, True):
                for name, fn, iters in (
                        ("fused_encode", lambda: fused_encode(
                            model, x, use_kernel=use), 50),
                        ("fused_evidence", lambda: fused_evidence(
                            model, x, u, use_kernel=use), 50),
                        ("fused_decode", lambda: fused_viterbi_states(
                            model, x, u, use_kernel=use),
                         20 if use else slow)):
                    res[(name, B, T, use)] = _time(torch, fn, iters=iters) \
                        + (_device_ms(torch, fn, 10 if use else 3),)
            fn = lambda: model.viterbi_decode(x, u)          # noqa: E731
            res[("two_stage", B, T, True)] = _time(torch, fn, iters=20) \
                + (_device_ms(torch, fn),)
            # kernel B on kernel 11's evidence: the two-stage decode's second
            # launch
            ev = fused_evidence(model, x, u)
            for use in (False, True):
                fn = lambda: viterbi_fused(*ev, use_kernel=use)  # noqa: E731
                res[("viterbi", B, T, use)] = _time(
                    torch, fn, iters=50 if use else 1) + (
                    _device_ms(torch, fn, 10 if use else 1),)
    for (name, B, T, use), (med, lo, hi, dev_ms) in res.items():
        line = (f"{name} {'kernel' if use else 'plain '} B={B} T={T}: "
                f"{med:.4f} ms [{lo:.4f}, {hi:.4f}] back to back; device "
                f"busy {_ms(dev_ms)} a call (profiler)")
        if use and name in ("viterbi", "fused_decode") and dev_ms:
            bound = kernel_bounds(model, B, T)[name][0]
            line += f", bound {bound:.3e} ms ({100 * bound / dev_ms:.2f}%)"
        say("times", line)

    # one Backtester.run on the card, and its parts
    gpu, bt, panel = bulk["gpu"], bulk["bt"], bulk["panel"]
    run = _wall(torch, lambda: bt.run(gpu["model_fn"], gpu["posterior_fn"],
                                      *panel, rebalance_freq=5))
    parts = {"posterior_fn": [], "model_fn": []}

    def timed(name):
        def fn(a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gpu[name](a)
            torch.cuda.synchronize()
            parts[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return fn

    sched = _wall(torch, lambda: bt._weight_schedule(
        timed("model_fn"), timed("posterior_fn"), bulk["data"],
        bulk["data"].shape[2], 5))
    post = statistics.median(parts["posterior_fn"][1:])
    head = statistics.median(parts["model_fn"][1:])
    say("times", f"Backtester.run on the card ({bulk['windows']} windows of "
        f"20, {bulk['data'].shape[2]} days): {run[0]:.2f} ms [{run[1]:.2f}, "
        f"{run[2]:.2f}] of wall; the weight schedule {sched[0]:.2f} ms "
        f"(posterior_fn {post:.3f} ms, model_fn {head:.3f} ms, stacking, "
        f"upload and download the rest); the float64 ledger loop and the "
        f"metrics {run[0] - sched[0]:.2f} ms (by difference)")
    # one whole-panel decode three ways, host clock
    xd, ud = bt._tensor(bulk["data"]), bt._tensor(bulk["u_data"])
    m = gpu["model"]
    with torch.inference_mode():
        panel_ms = {
            "kernel 10": _wall(torch, lambda: fused_viterbi_states(m, xd, ud)),
            "kernel 11 + kernel B": _wall(torch,
                                          lambda: m.viterbi_decode(xd, ud)),
            "plain": _wall(torch, lambda: fused_viterbi_states(
                m, xd, ud, use_kernel=False), repeats=3)}
    say("times", f"whole-panel decode (B=1, T={xd.shape[2]}), wall ms: "
        + ", ".join(f"{k} {v[0]:.3f} [{v[1]:.3f}, {v[2]:.3f}]"
                    for k, v in panel_ms.items()))
    res["backtest_run_ms"] = run
    return res


def gather_library_ms(torch, np, S=1):
    """One advanced-indexing call over the two pools joined along the
    channels, for S batches of the same triples as the gather's timing (it
    does not zero the steps past each length)."""
    from vqvaehmm_tpu_torch.ops.gather import build_pools

    rng = np.random.default_rng(9)
    xs, us, lens = synthetic_pool(np, rng, 5, 4)
    pool = torch.cat([torch.from_numpy(a) for a in build_pools(xs, us)],
                     dim=1).cuda()
    si, st, _ = (torch.from_numpy(np.concatenate(a)).cuda().long()
                 for a in zip(*(gather_case(np, rng, lens, 64, 200, 20)
                                for _ in range(S))))
    ch = torch.arange(pool.shape[1], device="cuda")
    pos = (st[:, None] + torch.arange(200, device="cuda")[None, :]).clamp(
        max=pool.shape[2] - 1)
    return _time(torch, lambda: pool[si[:, None, None], ch[None, :, None],
                                     pos[:, None, :]])[0]


def _code_ties(torch, z, cb, got, want):
    """(tokens whose two indices differ, largest gap of the two codes'
    float64 scores over its tolerance) for tokens z (N, D): two
    nearest-code searches may part only where the scores tie to float32
    rounding."""
    got, want = got.reshape(-1).long().cpu(), want.reshape(-1).long().cpu()
    bad = got != want
    if not bool(bad.any()):
        return 0, 0.0
    zf, cbf = z.reshape(-1, z.shape[-1]).double().cpu()[bad], cb.double().cpu()
    s = zf @ cbf.T - 0.5 * (cbf * cbf).sum(-1)
    a, b = s.gather(1, got[bad][:, None]), s.gather(1, want[bad][:, None])
    tol = torch.clamp(TIE_ULPS * torch.finfo(torch.float32).eps * b.abs(),
                      min=TIE_ATOL)
    return int(bad.sum()), float(((a - b).abs() / tol).max())


def vq_panel_windows(np, max_len=200):
    """The fixture panel's features as full-coverage windows (N, 5, 200)."""
    from vqvaehmm_tpu_torch.data import market
    from vqvaehmm_tpu_torch.train.vq_pipeline import panel_windows

    prices, regime, _ = market.load_fixture_frames(FIXTURE)
    x, _, _, _ = market.prepare_sequences(prices, regime)
    return panel_windows([np.transpose(x).astype(np.float32)], max_len)


VQ_SHAPES = ((1, 37), (64, 200), (460, 20), (1, 2327))
# the quantizer's shapes: a training step of config_vq.json, a small batch
QUANT_SHAPES = ((64, 200), (8, 200))


def quantize_step(torch, np, B, T, use_kernel=None, seed=0):
    """fn() -> quantize_st forward and .backward() of a VQ loss on seeded
    (B, 16, T) latents of a (8, 16) codebook with a ragged mask, through the
    package on sys.path (public entry points only, so that the parent's
    package runs it too), and the tensors whose bytes old and new must
    share (idx, z_q_st)."""
    from vqvaehmm_tpu_torch.ops.vq import quantize_st

    rng = np.random.default_rng(seed + B * 1009 + T)
    dev = torch.device("cuda")
    z = _randn(torch, np, rng, (B, 16, T), dev).requires_grad_()
    cb = (0.5 * _randn(torch, np, rng, (8, 16), dev)).requires_grad_()
    g = _randn(torch, np, rng, (B, 16, T), dev)
    lens = torch.from_numpy(rng.integers(T // 3, T + 1, size=B)).to(dev)
    mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
    out = []

    def fn():
        z.grad = cb.grad = None
        r = quantize_st(z, cb, 0.25, use_kernel=use_kernel, mask=mask,
                        channels_first=True)
        ((r.quantized * g).sum() + r.commitment_loss
         + r.codebook_loss).backward()
        out[:] = [r.indices, r.quantized.detach()]

    fn()
    return fn, out


def phase_kernel_9(torch, np, stack):
    from vqvaehmm_tpu_torch.ops.vq import (quantize_st_fused_backward,
                                           quantize_st_fused_forward,
                                           vq_nearest, vq_nearest_reference)

    model = stack.model
    dev = model.device
    cb = model.codebook.detach()
    M, D = cb.shape
    rng = np.random.default_rng(17)
    xw, _ = vq_panel_windows(np)
    with torch.no_grad():
        z_panel = model.encode(torch.from_numpy(xw).to(dev))
    scale = float(z_panel.std())
    cb_dup = cb.clone()
    cb_dup[5] = cb_dup[2]
    cb_wide = _randn(torch, np, rng, (64, 32), dev) * 0.5
    cases = [("panel latents", z_panel, cb),
             ("panel latents, row 5 = row 2", z_panel, cb_dup),
             ("random (64, 32) codebook",
              _randn(torch, np, rng, (64, 32, 200), dev), cb_wide)]
    cases += [(f"random B={B} T={T}",
               _randn(torch, np, rng, (B, D, T), dev) * scale, cb)
              for B, T in VQ_SHAPES]
    worst, mismatches, calls = 0.0, 0, 0
    n0 = vq_nearest.launches
    for what, z, book in cases:
        flat = z.transpose(1, 2).contiguous()                # (B, T, D)
        _, want = vq_nearest_reference(z, book, channels_first=True)
        for layout, arg, cf in (("(B, D, T)", z, True), ("flat", flat,
                                                         False)):
            zq, idx = vq_nearest(arg, book, channels_first=cf,
                                 use_kernel=True)
            zq2, idx2 = vq_nearest(arg, book, channels_first=cf,
                                   use_kernel=True)
            torch.cuda.synchronize()
            calls += 2
            tag = f"{what}, {layout}"
            if idx.dtype != torch.int32 or idx.shape != want.shape or \
                    int(idx.min()) < 0 or int(idx.max()) >= book.shape[0]:
                fail(f"kernel 9 indices misshapen or out of range ({tag})")
            n, excess = _code_ties(torch, flat, book, idx, want)
            mismatches += n
            if excess > 1.0:
                fail(f"kernel 9 differs from plain at {n} tokens, the two "
                     f"codes' scores {excess:.1f} times the tolerance of a "
                     f"tie apart ({tag})")
            rows = book[idx.long()]
            if not torch.equal(zq, rows.transpose(1, 2) if cf else rows):
                fail(f"kernel 9 z_q is not codebook[idx] bit for bit "
                     f"({tag})")
            worst = max(worst, max_abs(zq, rows.transpose(1, 2) if cf
                                       else rows))
            if not torch.equal(idx, idx2) or not torch.equal(zq, zq2):
                fail(f"kernel 9 is not bit-equal across two calls ({tag})")
            if book is cb_dup and bool((idx == 5).any()):
                fail(f"kernel 9 chose the duplicated row 5 over row 2 "
                     f"({tag})")
    if vq_nearest.launches - n0 != calls:
        fail(f"kernel 9 launched {vq_nearest.launches - n0} times for "
             f"{calls} calls")
    say("kernel 9", f"{len(cases)} cases in both layouts: indices equal to "
        f"plain except {mismatches} near-ties (tol {TIE_ATOL:g} or "
        f"{TIE_ULPS} float32 roundings of the score), z_q bit-equal to "
        "codebook[idx], second call bit-equal, the lower of two equal rows "
        "chosen")

    # the straight-through quantizer's forward and backward kernels, each
    # case with a ragged bool mask, all masked, and none
    _, lw = vq_panel_windows(np)
    panel_mask = torch.arange(z_panel.shape[2], device=dev)[None, :] \
        < torch.from_numpy(lw).to(dev)[:, None]
    errs = {"forward": 0.0, "backward": 0.0}
    n0 = (quantize_st_fused_forward.launches,
          quantize_st_fused_backward.launches)
    qcalls, mismatches = 0, 0
    for what, z, book in cases:
        B, _, T = z.shape
        lens = torch.from_numpy(rng.integers(0, T + 1, size=B)).to(dev)
        lens[0] = T
        ragged = (panel_mask if z is z_panel else
                  torch.arange(T, device=dev)[None, :] < lens[:, None])
        g = _randn(torch, np, rng, tuple(z.shape), dev)
        for mname, mask in (("ragged mask", ragged),
                            ("all masked", torch.zeros_like(ragged)),
                            ("no mask", None)):
            for layout, cf in (("(B, D, T)", True), ("flat", False)):
                tag = f"{what}, {mname}, {layout}"
                e, n = _quantize_case(torch, z, book, g, mask, cf, tag)
                qcalls += 2
                mismatches += n
                for k in errs:
                    errs[k] = max(errs[k], e[k])
    got = (quantize_st_fused_forward.launches - n0[0],
           quantize_st_fused_backward.launches - n0[1])
    if got != (qcalls, qcalls):
        fail(f"the quantizer launched {got} (forward, backward) for "
             f"{qcalls} calls of each")
    say("kernel 9", f"the quantizer, {len(cases)} cases x 3 masks x 2 "
        f"layouts: idx equal to plain except {mismatches} near-ties, z_q_st "
        "bit-equal to the plain version's where the codes agree and to "
        "z + (codebook[idx] - z) everywhere, denom bit-equal, losses within "
        f"1e-5 relative (largest absolute error {errs['forward']:.3e}), "
        "dz_e bit-equal to quantize_st_backward_reference, dcodebook within "
        "1e-5 of the sum of its terms' magnitudes (largest absolute error "
        f"{errs['backward']:.3e}), a second call of each bit-equal")
    return worst, errs


def _quantize_case(torch, z, book, g, mask, cf, tag):
    """The quantizer's forward and backward kernels against their plain
    versions on (B, D, T) latents z, in the model's layout (cf) or flat:
    ({forward: largest loss error, backward: largest dcodebook error},
    tokens whose code differs at a near-tie)."""
    from vqvaehmm_tpu_torch.ops.vq import (
        quantize_st_backward_reference, quantize_st_forward_reference,
        quantize_st_fused_backward, quantize_st_fused_forward)

    M, D = book.shape
    flat = z.transpose(1, 2).contiguous()                    # (B, T, D)
    zin, gin = (z, g) if cf else (flat, g.transpose(1, 2))
    gc, gk = (torch.tensor(v, device=z.device) for v in (0.7, 1.3))
    fwd = quantize_st_fused_forward(zin, book, 0.25, mask, cf)
    fwd2 = quantize_st_fused_forward(zin, book, 0.25, mask, cf)
    ref = quantize_st_forward_reference(zin, book, 0.25, mask, cf)
    zst, idx, denom = fwd[0], fwd[1], fwd[4]
    bwd = quantize_st_fused_backward(gin, gc, gk, zin, book, idx, mask,
                                     denom, 0.25, cf)
    bwd2 = quantize_st_fused_backward(gin, gc, gk, zin, book, idx, mask,
                                      denom, 0.25, cf)
    want = quantize_st_backward_reference(gin, gc, gk, zin, book, idx, mask,
                                          denom, 0.25, cf)
    torch.cuda.synchronize()
    if idx.dtype != torch.int32 or idx.shape != ref[1].shape:
        fail(f"quantizer indices misshapen ({tag})")
    n, excess = _code_ties(torch, flat, book, idx, ref[1])
    if excess > 1.0:
        fail(f"quantizer indices differ from plain at {n} tokens, "
             f"{excess:.1f} times the tolerance of a tie ({tag})")
    rows = book[idx.long()]
    zq = rows.transpose(1, 2) if cf else rows
    same = (idx == ref[1]).unsqueeze(1 if cf else -1).expand_as(zst)
    if not torch.equal(zst, zin + (zq - zin)) or \
            not torch.equal(zst[same], ref[0][same]):
        fail(f"quantizer z_q_st not bit-equal to the plain version ({tag})")
    if not torch.equal(denom, ref[4]):
        fail(f"quantizer denominator {denom} vs plain {ref[4]} ({tag})")
    loss_err = 0.0
    for got, exp in zip(fwd[2:4], ref[2:4]):
        loss_err = max(loss_err, max_abs(got, exp))
        if abs(float(got) - float(exp)) > 1e-5 * abs(float(exp)):
            fail(f"quantizer loss {float(got)} vs plain {float(exp)} "
                 f"({tag})")
    if not torch.equal(bwd[0], want[0]):
        fail(f"quantizer dz_e not bit-equal to "
             f"quantize_st_backward_reference ({tag})")
    v = flat - rows
    if mask is not None:
        v = v * mask[..., None]
    onehot = torch.nn.functional.one_hot(idx.reshape(-1).long(), M).float()
    scale = onehot.T @ v.reshape(-1, D).abs() * (2 * 1.3 / denom).abs()
    if not bool(((bwd[1] - want[1]).abs() <= 1e-5 * scale + 1e-30).all()):
        fail(f"quantizer dcodebook beyond 1e-5 of its terms' magnitudes "
             f"({tag}): {max_abs(bwd[1], want[1]):.3e}")
    for a, b in zip(fwd + bwd, fwd2 + bwd2):
        if not torch.equal(a, b):
            fail(f"the quantizer is not bit-equal across two calls ({tag})")
    return {"forward": loss_err, "backward": max_abs(bwd[1], want[1])}, n


VQ_EM_ITERS = 20       # of config_vq.json's 50, in the training phases


def _vq_cfg(ckpt_dir, *extra, **training):
    from vqvaehmm_tpu_torch.core.config import apply_overrides, load_config

    over = [f"training.checkpoint_dir={ckpt_dir}", "training.num_epochs=4",
            "training.save_freq=2", f"vq.hmm_iters={VQ_EM_ITERS}", *extra]
    over += [f"training.{k}={json.dumps(v)}" for k, v in training.items()]
    return apply_overrides(load_config(VQ_CONFIG), over)


def _first_code_flip(torch, np, cfg, devices=("cuda", "cpu")):
    """Train the two devices' models in lockstep, from one seed on one
    index stream and with the restarts train_vq_stack would make, until a
    step's codes differ.  Returns (epoch, step, tokens that differ, the
    largest gap of the two codes' scores over the tolerance of a tie), or
    None if no code parts them."""
    from vqvaehmm_tpu_torch.data.device_sampler import DeviceEpochSampler
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline
    from vqvaehmm_tpu_torch.train.vq_pipeline import (
        _sample_valid_positions, make_code_reinit, make_vq_model,
        make_vq_optimizer)

    t, v = cfg.training, cfg.vq
    dataset = TrainPipeline(cfg, device="cpu").load_data()
    rng = np.random.default_rng(t.seed + 1)
    side = []
    for d in devices:
        model = make_vq_model(cfg, device=d, generator=torch.Generator()
                              .manual_seed(t.seed))
        side.append((model, make_vq_optimizer(
            model, t.learning_rate, t.gradient_clip,
            float(v.codebook_lr_scale)), DeviceEpochSampler(dataset, d),
            make_code_reinit(model)))
    nb = len(dataset) // t.batch_size
    for ep in range(t.num_epochs):
        triples = side[0][2].sample_indices_fast(t.batch_size, nb)
        up = [s[2].upload(*triples) for s in side]
        counts = torch.zeros(v.num_codes, dtype=torch.int64)
        for i in range(nb):
            xs = [s[2].gather(*(a[i] for a in u))[0]
                  for s, u in zip(side, up)]
            if ep == 0 and i == 0 and v.data_init:
                rows, ts = _sample_valid_positions(rng, triples[2][0],
                                                   v.num_codes)
                for s, x in zip(side, xs):
                    s[3](x, rows, ts, np.ones(v.num_codes, bool))
            if i == 0:
                first = xs
            parts = [s[0].compute_loss(x, u[2][i])
                     for s, x, u in zip(side, xs, up)]
            codes = [s[0].codes(x) for s, x in zip(side, xs)]
            if not torch.equal(codes[0].cpu(), codes[1].cpu()):
                with torch.no_grad():
                    z = side[1][0].encode(xs[1]).transpose(1, 2)
                valid = (torch.arange(z.shape[1])[None, :]
                         < up[1][2][i].cpu()[:, None])
                n, excess = _code_ties(
                    torch, z[valid.to(z.device)], side[1][0].codebook
                    .detach(), codes[0].cpu()[valid], codes[1].cpu()[valid])
                return ep + 1, i + 1, n, excess
            for s, p in zip(side, parts):
                s[1].zero_grad(set_to_none=True)
                p.total.backward()
                s[1].update()
            counts += parts[0].counts.cpu()
        if v.dead_code_reinit and ep < t.num_epochs - 1:
            c = counts.numpy()
            dead = c < max(1.0, v.dead_code_min_usage * c.sum() / v.num_codes)
            if dead.any():
                rows, ts = _sample_valid_positions(rng, triples[2][0],
                                                   v.num_codes)
                for s, x in zip(side, first):
                    s[3](x, rows, ts, dead)
    return None


def _npz(np, path):
    with np.load(path) as z:
        return {k: z[k].copy() for k in z.files}


def phase_vq_train(torch, np):
    from vqvaehmm_tpu_torch.data.checkpoint import load_metadata
    from vqvaehmm_tpu_torch.ops.gather import gather_epoch
    from vqvaehmm_tpu_torch.ops.vq import (quantize_st_fused_backward,
                                           quantize_st_fused_forward,
                                           vq_nearest)
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline
    from vqvaehmm_tpu_torch.train.vq_pipeline import VQStack

    tmp = tempfile.mkdtemp(prefix="chip_smoke_vq_")
    try:
        logs = []
        cfg = _vq_cfg(os.path.join(tmp, "gpu"))
        t = cfg.training
        per_epoch = cfg.data.samples_per_epoch // t.batch_size
        pipe = TrainPipeline(cfg, device="cuda")
        vq_nearest.launches = 0
        quantize_st_fused_forward.launches = 0
        quantize_st_fused_backward.launches = 0
        gather_epoch.launches = 0
        state = pipe.train(log_fn=lambda m: logs.append(
            (time.perf_counter(), m)))
        torch.cuda.synchronize()
        launches = {"vq_nearest": vq_nearest.launches,
                    "quantize_forward": quantize_st_fused_forward.launches,
                    "quantize_backward": quantize_st_fused_backward.launches,
                    "gather": gather_epoch.launches}
        # a step is one forward and one backward of the quantizer; an
        # epoch one gather; the panel is encoded once after training and
        # once more after a polish epoch
        polish = sum(m.startswith("Polish epoch") for _, m in logs)
        epochs = t.num_epochs + polish
        steps = per_epoch * epochs
        expected = {"vq_nearest": 1 + polish, "quantize_forward": steps,
                    "quantize_backward": steps, "gather": epochs}
        if launches != expected or state.step != steps:
            fail(f"VQ training launched {launches} and made {state.step} "
                 f"updates; {t.num_epochs} epochs and {polish} polish "
                 f"epochs of {per_epoch} steps imply {expected}")
        gpu_hist = pipe.history
        if len(gpu_hist) != t.num_epochs + polish or \
                not np.isfinite(gpu_hist).all():
            fail(f"VQ epoch losses {gpu_hist}")
        stamps = [ts for ts, m in logs if m.startswith("Epoch ")]
        goodput = (len(stamps) - 1) * per_epoch * t.batch_size \
            / (stamps[-1] - stamps[0])
        say("vq train", f"TrainPipeline(config_vq.json) on the card: "
            f"{steps} steps, kernel launches {launches}, epoch losses "
            f"{gpu_hist}; EM cut to {VQ_EM_ITERS} of its 50 "
            f"iterations: {[m for _, m in logs if 'EM' in m]}")

        # the same pipeline on the CPU: plain versions, same index stream
        cpu = TrainPipeline(_vq_cfg(os.path.join(tmp, "cpu"),
                                    input_pipeline="device"), device="cpu")
        cpu.train(log_fn=None)
        rel = [abs(a - b) / abs(b) for a, b in zip(gpu_hist, cpu.history)]
        if len(cpu.history) != len(gpu_hist) or max(rel) > 1e-4:
            flip = _first_code_flip(torch, np, cfg)
            if flip is None or flip[3] > 1.0:
                fail(f"card VQ epoch losses {gpu_hist} vs CPU {cpu.history} "
                     f"(relative {rel}) and no near-tie explains it: first "
                     f"code flip (epoch, step, tokens, gap over tolerance) "
                     f"= {flip}")
            say("vq train", f"card and CPU epoch losses part (relative "
                f"{rel}) after a code flip at epoch {flip[0]} step "
                f"{flip[1]}: {flip[2]} tokens whose two codes' scores tie "
                f"within {flip[3]:.3f} of the tolerance")
        else:
            say("vq train", f"CPU plain run: epoch losses {cpu.history}, "
                f"largest relative difference {max(rel):.3e} (tol 1e-4)")

        # exact resume: SIGTERM after epoch 2, then a rerun
        rcfg = _vq_cfg(os.path.join(tmp, "resume"))

        def preempt_at_2(msg):
            if msg.startswith("Epoch 2/"):
                os.kill(os.getpid(), signal.SIGTERM)

        first = TrainPipeline(rcfg, device="cuda")
        part = first.train(log_fn=preempt_at_2)
        meta = load_metadata(os.path.join(tmp, "resume", "vq_periodic"))
        if not first.preempted or part.step != 2 * per_epoch or not meta \
                or not meta.get("preempted") or os.path.exists(
                    os.path.join(tmp, "resume", "vq_stack.npz")):
            fail(f"SIGTERM did not stop VQ training at epoch 2 (step "
                 f"{part.step}, metadata {meta})")
        second = TrainPipeline(rcfg, device="cuda")
        resumed = second.train(log_fn=None)
        if second.preempted or resumed.step != steps or \
                second.history != gpu_hist:
            fail(f"the resumed VQ run ended at step {resumed.step} with "
                 f"losses {second.history} vs {gpu_hist}")
        ref = state.model.state_dict()
        for name, val in resumed.model.state_dict().items():
            if not torch.equal(val, ref[name]):
                fail(f"resumed VQ run differs from the uninterrupted run "
                     f"at {name}")
        a = _npz(np, os.path.join(tmp, "gpu", "vq_stack.npz"))
        b = _npz(np, os.path.join(tmp, "resume", "vq_stack.npz"))
        for k in a:
            if k.startswith(("vq_", "hmm_")) and not np.array_equal(a[k],
                                                                    b[k]):
                fail(f"resumed VQ archive differs at {k}")
        say("vq train", "SIGTERM at epoch 2 and resume: parameters, "
            "history and the archive's vq_* and hmm_* arrays bit-equal to "
            "the uninterrupted run")

        # the archive loads back and decodes as the trained model does
        stack = VQStack.load(os.path.join(tmp, "gpu", "vq_stack.npz"),
                             device="cuda")
        x = _randn(torch, np, np.random.default_rng(18), (4, 5, 200), "cuda")
        g = stack.regime_marginals(x)
        if not torch.equal(stack.codes(x), state.model.codes(x)) or \
                tuple(g.shape) != (4, 200, cfg.model.K) or \
                not torch.isfinite(g).all() or stack.usage is None:
            fail("the archive the card wrote does not load back to the "
                 "trained model")
        say("vq train", f"vq_stack.npz loads back: codes equal to the "
            f"trained model's, usage {stack.usage}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, goodput


def phase_vq_serve(torch, np):
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused
    from vqvaehmm_tpu_torch.ops.vq import vq_nearest
    from vqvaehmm_tpu_torch.serve.httpd import serve
    from vqvaehmm_tpu_torch.serve.vq import VQInferenceModel

    with open(VQ_CONFIG) as f:
        raw = json.load(f)
    raw["checkpoint_path"] = VQ_ARCHIVE
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vq_serve_")
    cfg_path = os.path.join(tmp, "inference_config.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    os.environ["VQHMM_REQUIRE_CHECKPOINT"] = "1"
    cpu = VQInferenceModel(cfg_path, device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = serve(cfg_path, host="127.0.0.1", port=port, background=True,
                  device="cuda")
    url = f"http://127.0.0.1:{port}"
    reps = 5
    try:
        served = httpd.vqhmm_model            # get_model's handle
        if not isinstance(served._inner, VQInferenceModel) or \
                not served.checkpoint_loaded:
            fail("the server did not load the VQ archive")
        rng = np.random.default_rng(19)
        C = raw["model"]["input_dim"]
        reqs = [("/infer", "smoothed", 37), ("/infer", "smoothed", 200),
                ("/infer", "filtered", 200), ("/infer", "mean_field", 200),
                ("/infer", "viterbi", 200), ("/infer", "viterbi", 1500),
                ("/infer", None, 512), ("/predict", "predict", 200)]
        payloads = []
        for path, mode, T in reqs:
            p = {"x": rng.normal(size=(C, T)).astype(np.float32).tolist()}
            if path == "/infer" and mode is not None:
                p["mode"] = mode
            payloads.append(p)
        vq_nearest.launches = 0
        viterbi_fused.launches = 0
        status, body, _ = _request(url + "/health")
        if status != 200 or body != {"status": "ok"}:
            fail(f"/health answered {status} {body}")
        responses, lat = [], {}
        for (path, mode, T), p in zip(reqs, payloads):
            times = []
            for _ in range(reps):
                status, body, dt = _request(url + path, p)
                if status != 200:
                    fail(f"VQ {path} {mode} T={T} answered {status}")
                times.append(dt)
            responses.append(body)
            lat.setdefault(f"{mode or 'default'} T={T}", []).extend(times)
        try:
            _request(url + "/infer", {"x": [[1.0, 2.0]]})
            fail("a VQ request with the wrong C was not refused")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                fail(f"a VQ request with the wrong C got {e.code}, not 400")
        launches = {"vq_nearest": vq_nearest.launches,
                    "viterbi": viterbi_fused.launches}
        expected = {"vq_nearest": reps * len(reqs), "viterbi": reps * sum(
            mode == "viterbi" for _, mode, _ in reqs)}
        if launches != expected:
            fail(f"VQ serving launched {launches}; {reps} x {len(reqs)} "
                 f"requests imply {expected}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        shutil.rmtree(tmp, ignore_errors=True)

    worst, ties = {}, 0
    hmm, model = cpu.stack.hmm, cpu.stack.model
    for (path, mode, T), p, got in zip(reqs, payloads, responses):
        if path == "/predict":
            want = cpu.predict(p["x"])
            checks = ("weights", "regime_probs")
        else:
            want = cpu.infer(p["x"], mode=mode or "mean_field")
            served_mode = mode if mode in ("filtered", "viterbi") \
                else "smoothed"
            if got.get("mode") != served_mode or set(got) != set(want):
                fail(f"VQ /infer {mode} T={T}: keys {sorted(got)} mode "
                     f"{got.get('mode')!r}")
            checks = () if mode == "viterbi" else ("regime_probs",)
            if got["codes"] != want["codes"]:
                xp, _ = cpu._padded(p["x"])
                with torch.no_grad():
                    z = model.encode(xp)[0, :, :T].T
                n, excess = _code_ties(
                    torch, z, model.codebook.detach(),
                    torch.tensor(got["codes"]), torch.tensor(want["codes"]))
                if excess > 1.0:
                    fail(f"VQ /infer {mode} T={T}: {n} codes differ from "
                         f"the CPU's, {excess:.1f} times the tolerance of "
                         "a tie")
                say("vq serve", f"{mode} T={T}: {n} codes differ on a "
                    "near-tie; probabilities not compared")
                ties += n
                continue
        for key in checks:
            g, w = np.asarray(got[key]), np.asarray(want[key])
            if g.shape != w.shape or not np.isfinite(g).all():
                fail(f"VQ {path} {mode} T={T} {key}: shape {g.shape} vs "
                     f"{w.shape} or non-finite")
            err = float(np.abs(g - w).max())
            name = f"{mode or 'default'}.{key}"
            worst[name] = max(worst.get(name, 0.0), err)
            if err > 1e-4:
                fail(f"VQ {path} {mode} T={T} {key} differs from the CPU "
                     f"by {err:.3e} > 1e-4")
        if mode == "viterbi" and got["states"] != want["states"]:
            codes = torch.tensor(want["codes"])[None]
            ev = (hmm.log_pi, hmm.log_A.expand(1, T, hmm.K, hmm.K),
                  cpu.stack.log_obs(codes))
            gap, excess = _tie_gap(
                torch, ev, torch.tensor(got["states"])[None],
                torch.tensor(want["states"])[None], None)
            if excess > 1.0:
                fail(f"VQ viterbi T={T}: the served path scores {gap:.3e} "
                     f"from the CPU's, {excess:.1f} times the tolerance of "
                     "a tie")
            say("vq serve", f"viterbi T={T}: states differ on a score tie "
                f"({gap:.3e})")
    say("vq serve", "the VQ archive served on the card matches the CPU: "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
        + f"; codes equal except {ties} near-ties; states equal or tied")
    say("vq serve", f"kernel launches while serving: {launches}; p50 "
        "latency ms: " + ", ".join(
            f"{m} {statistics.median(v) * 1e3:.3f}" for m, v in lat.items()))
    return launches


def _vq_step_three_ways(torch, np, cfg):
    """A VQ training step at the configuration's widths with its
    convolutions three ways: as matrix products (what the model runs),
    and through cuDNN with and without torch.backends.cudnn.deterministic.
    For each: wall and device-busy ms a step over epochs of 15 steps, and
    whether two runs of 30 steps from one seed give the same losses."""
    from vqvaehmm_tpu_torch.ops import nn as ops
    from vqvaehmm_tpu_torch.train.vq_pipeline import (make_vq_epoch_step,
                                                      make_vq_model,
                                                      make_vq_optimizer)

    rng = np.random.default_rng(21)
    t = cfg.training
    shape = (15, t.batch_size, cfg.model.input_dim, cfg.data.max_len)
    xs = _randn(torch, np, rng, shape, "cuda")
    lens = torch.from_numpy(rng.integers(
        cfg.data.min_len, cfg.data.max_len + 1, size=shape[:2]).astype(
            np.int32)).to("cuda")

    def run(epochs):
        model = make_vq_model(cfg, device="cuda", generator=torch.Generator()
                              .manual_seed(0))
        step = make_vq_epoch_step(model, make_vq_optimizer(
            model, t.learning_rate, t.gradient_clip))
        return step, [float(step(xs, lens)[0]) for _ in range(epochs)]

    shipped = ops.conv1d_same_matmul
    try:
        for name, conv, det in (
                ("matrix products (the model's)", shipped, False),
                ("cuDNN, cudnn.deterministic", ops.conv1d_same, True),
                ("cuDNN, default", ops.conv1d_same, False)):
            ops.conv1d_same_matmul = conv
            torch.backends.cudnn.deterministic = det
            _, first = run(2)
            step, second = run(2)
            wall = _wall(torch, lambda: float(step(xs, lens)[0]), repeats=3)
            dev_ms = _device_ms(torch, lambda: step(xs, lens), calls=1)
            say("times", f"VQ step, convolutions as {name}: "
                f"{wall[0] / 15:.4f} ms [{wall[1] / 15:.4f}, "
                f"{wall[2] / 15:.4f}] of wall a step, device busy "
                f"{_ms(None if dev_ms is None else dev_ms / 15)} a step; "
                f"two runs of 30 steps from one seed "
                f"{'equal' if first == second else 'DIFFER'}: {first} "
                f"{second}")
            if conv is shipped and first != second:
                fail("VQ training on the card is not repeatable from one "
                     f"seed: {first} vs {second}")
    finally:
        ops.conv1d_same_matmul = shipped
        torch.backends.cudnn.deterministic = False


def phase_vq_times(torch, np, stack):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from vqvaehmm_tpu_torch.models.hmm import fit_categorical_em
    from vqvaehmm_tpu_torch.ops.vq import (
        quantize_st_backward_reference, quantize_st_forward_reference,
        quantize_st_fused_backward, quantize_st_fused_forward, vq_nearest,
        vq_nearest_reference)
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline
    from vqvaehmm_tpu_torch.train.vq_pipeline import panel_windows

    model = stack.model
    dev = model.device
    cb = model.codebook.detach()
    rng = np.random.default_rng(20)
    res = {}
    for B, T in VQ_SHAPES:
        z = _randn(torch, np, rng, (B, cb.shape[1], T), dev)
        for use, fn in ((False, lambda: vq_nearest_reference(
                z, cb, channels_first=True)), (True, lambda: vq_nearest(
                    z, cb, channels_first=True, use_kernel=True))):
            res[(B, T, use)] = _time(torch, fn) + (_device_ms(
                torch, fn, kernels=1 if use else None),)
    for (B, T, use), (med, lo, hi, dev_ms) in res.items():
        say("times", f"vq_nearest {'kernel' if use else 'plain '} B={B} "
            f"T={T}: {med:.4f} ms [{lo:.4f}, {hi:.4f}] back to back; "
            f"device busy {_ms(dev_ms)} a call (profiler)")

    # the quantizer's two kernels and their plain versions, then
    # quantize_st forward and backward end to end, kernels against autograd
    for B, T in QUANT_SHAPES:
        z = _randn(torch, np, rng, (B, cb.shape[1], T), dev)
        g = _randn(torch, np, rng, (B, cb.shape[1], T), dev)
        gc, gk = torch.ones(2, device=dev).unbind()
        mask = torch.arange(T, device=dev)[None, :] < torch.from_numpy(
            rng.integers(T // 3, T + 1, size=B)).to(dev)[:, None]
        fwd = quantize_st_fused_forward(z, cb, 0.25, mask, True)
        for name, args, fns in (
                ("quantize_forward", (z, cb, 0.25, mask, True),
                 (quantize_st_forward_reference, quantize_st_fused_forward)),
                ("quantize_backward", (g, gc, gk, z, cb, fwd[1], mask,
                                       fwd[4], 0.25, True),
                 (quantize_st_backward_reference,
                  quantize_st_fused_backward))):
            for use, f in zip((False, True), fns):
                call = lambda: f(*args)  # noqa: E731
                res[(name, B, T, use)] = _time(torch, call) + (
                    _device_ms(torch, call, kernels=1 if use else None),)
        for use in (False, True):
            step, _ = quantize_step(torch, np, B, T, use_kernel=use)
            res[("quantize_st", B, T, use)] = _time(torch, step) + \
                _device_trace(torch, step)
    bounds = kernel_bounds(load_published(torch, dev), 64, 200)
    for key, val in res.items():
        if len(key) != 4:
            continue
        name, B, T, use = key
        line = (f"{name} {'kernel' if use else 'plain '} B={B} T={T}: "
                f"{val[0]:.4f} ms [{val[1]:.4f}, {val[2]:.4f}] back to back;"
                f" device busy {_ms(val[3])} a call (profiler)")
        if name == "quantize_st" and val[4] is not None:
            line += (f", {val[4]:.1f} device ops a call (the forward, the "
                     "loss's mul, sum and adds, and their backward)")
        elif use and (B, T) == (64, 200) and val[3]:
            b = bounds[name][0]
            line += f"; bound {b:.6f} ms, {100 * b / val[3]:.1f}% of it"
        say("times", line)

    # a steady epoch of VQ training on the card, traced on the card alone
    prof = profile(activities=[ProfilerActivity.CUDA])
    stamps, begin = [], []

    def log(msg):
        if not msg.startswith("Epoch "):
            return
        stamps.append(time.perf_counter())
        if msg.startswith("Epoch 5/"):
            prof.start()
            begin.append(time.perf_counter())
        elif msg.startswith("Epoch 6/"):
            prof.stop()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_vq_profile_")
    try:
        cfg = _vq_cfg(tmp, "vq.hmm_iters=2", num_epochs=6, save_freq=0)
        pipe = TrainPipeline(cfg, device="cuda")
        pipe.train(log_fn=log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t = cfg.training
    steps = cfg.data.samples_per_epoch // t.batch_size
    gaps = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    untraced = gaps[1:4]                                 # epochs 3-5
    steady = len(untraced) * steps * t.batch_size / (sum(untraced) / 1e3)
    plain_step = statistics.median(untraced) / steps
    traced = 1e3 * (stamps[5] - begin[0]) / steps
    parts = {"kernel 9, the quantizer's forward": ("vq_quantize_forward",),
             "kernel 9, the quantizer's backward": ("vq_quantize_backward",),
             "kernel 9, nearest code alone": ("vq_nearest",),
             "kernel D (once an epoch)": ("gather_kernel",),
             "matrix products (convolutions, one-hot)": (
                 "gemm", "gemv", "xmma", "cutlass", "cublas"),
             "Adam": ("multi_tensor", "adam", "foreach")}
    rest = "other (shifted copies, ReLU, loss, masks)"
    cats = {k: [] for k in list(parts) + [rest]}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        name = e.name.lower()
        key = next((k for k, pats in parts.items()
                    if any(p in name for p in pats)), rest)
        cats[key].append((e.time_range.start, e.time_range.end))
    busy = _busy_us(iv for ivs in cats.values() for iv in ivs) / 1e3 / steps
    if busy <= 0.0:
        fail("the profiler saw no device time in the traced VQ epoch")
    total_ops = sum(len(ivs) for ivs in cats.values())
    say("times", f"VQ TrainPipeline, save_freq 0, 6 epochs: ms between "
        f"epoch log lines {[round(g, 3) for g in gaps]}; goodput of the "
        f"untraced epochs 3-5: {steady:.1f} seqs/s, {plain_step:.4f} ms a "
        f"step; traced epoch 6: {traced:.4f} ms a step; device busy "
        f"{busy:.4f} ms a step, {100 * busy / plain_step:.2f}% of an "
        f"untraced step (inferred); {total_ops / steps:.1f} device ops a "
        f"step ({total_ops} in {steps} steps and the epoch's gather)")
    for key, ivs in cats.items():
        say("times", f"  device {key}: {_busy_us(ivs) / 1e3 / steps:.4f} ms "
            f"a step, {len(ivs)} ops in {steps} steps")

    _vq_step_three_ways(torch, np, cfg)

    # the EM fit at the configuration's depth on the synthetic pool's panel
    v = cfg.vq
    xw, lw = panel_windows(pipe.load_data().x_seqs, cfg.data.max_len)
    codes = stack.codes(torch.from_numpy(xw).to(dev))
    lens = torch.from_numpy(lw).to(dev)
    em = _wall(torch, lambda: fit_categorical_em(
        codes, K=cfg.model.K, V=v.num_codes, n_iters=50, seed=0,
        lengths=lens, n_init=v.hmm_restarts, sticky=v.hmm_sticky),
        repeats=3)
    say("times", f"fit_categorical_em on the card ({tuple(codes.shape)} "
        f"codes, {v.hmm_restarts} restarts folded into the batch, 50 "
        f"iterations): {em[0]:.1f} ms [{em[1]:.1f}, {em[2]:.1f}] of wall, "
        f"{em[0] / 50:.2f} ms an iteration (median of 3)")
    return res


# the shapes of kernels 8 and 11 on the main paths: a batch of requests,
# one exact-mode request, the bulk scorer's windows, the whole panel
BULK_SHAPES = ((64, 200), (1, 200), (460, 20), (1, 2327))



# ---------------------------------------------------------------------------
# Phases 21-23: the rest of the serving surface
# ---------------------------------------------------------------------------


def _serving_config(tmp, name, checkpoint=CHECKPOINT):
    """A config of the published widths whose checkpoint is `checkpoint`,
    written to tmp/name; its path."""
    with open(CONFIG) as f:
        model_section = json.load(f)["model"]
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        json.dump({"model": model_section, "checkpoint_path": checkpoint}, f)
    return path


def _burst(url, payloads, threads=16):
    """POST every payload to url from `threads` threads at once: (status,
    body, headers, seconds) a payload in order, and the burst's wall
    seconds.  Errors are returned, not raised."""
    import concurrent.futures

    def one(p):
        req = urllib.request.Request(
            url, data=json.dumps(p).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return (resp.status, json.loads(resp.read()),
                        dict(resp.headers), time.perf_counter() - t0)
        except urllib.error.HTTPError as e:
            return (e.code, json.loads(e.read()), dict(e.headers),
                    time.perf_counter() - t0)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=threads) as ex:
        out = list(ex.map(one, payloads))
    return out, time.perf_counter() - t0


def _pcts(seconds):
    ms = sorted(1e3 * s for s in seconds)
    return (statistics.median(ms),
            ms[min(len(ms) - 1, int(round(0.99 * (len(ms) - 1))))])


def _serve_bg(serve, cfg_path, dev, **kw):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = serve(cfg_path, host="127.0.0.1", port=port, background=True,
                  device=dev, **kw)
    return httpd, f"http://127.0.0.1:{port}"


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


def phase_batching(torch, np, tmp, dev="cuda"):
    """21. the published checkpoint behind the micro-batched server."""
    from vqvaehmm_tpu_torch.ops.fused_infer import fused_forward
    from vqvaehmm_tpu_torch.serve.app import InferenceModel
    from vqvaehmm_tpu_torch.serve.httpd import serve

    cfg_batched = _serving_config(tmp, "batched.json")
    cfg_solo = _serving_config(tmp, "solo.json")
    cpu = InferenceModel(cfg_solo, device="cpu")
    t0 = time.perf_counter()
    httpd, url = _serve_bg(serve, cfg_batched, dev, batch=True, max_batch=16,
                           max_wait_ms=2.0, warmup_lengths=(37, 200, 512))
    start_s = time.perf_counter() - t0
    solo_httpd, solo_url = _serve_bg(serve, cfg_solo, dev,
                                     warmup_lengths=())
    handle = httpd.vqhmm_model
    try:
        if not (handle.is_batching and handle.checkpoint_loaded):
            fail("the batched server did not load the published checkpoint")
        rng = np.random.default_rng(21)
        C = handle.cfg.model.input_dim
        # in length order: a bucket's requests arrive together, as a
        # client scoring a panel by length sends them (the interleaved
        # bursts below coalesce little; their dispatches are printed)
        Ts = sorted((37, 200, 512)[i % 3] for i in range(64))
        payloads = [{"x": rng.normal(size=(C, T)).astype(np.float32)
                     .tolist()} for T in Ts]
        fused_forward.launches = 0
        d0 = handle.dispatches
        got, _ = _burst(url + "/infer", payloads)
        dispatches = handle.dispatches - d0
        inner = handle._inner._inner          # the model behind the batcher
        solo = [inner.infer(p["x"]) for p in payloads]
        launches = fused_forward.launches
        bad = [r[0] for r in got if r[0] != 200]
        if bad:
            fail(f"the batched burst answered {bad}")
        if not dispatches < len(payloads):
            fail(f"{len(payloads)} requests took {dispatches} dispatches")
        if launches != dispatches + len(payloads):
            fail(f"kernel A launched {launches} times for {dispatches} "
                 f"dispatches and {len(payloads)} solo calls")
        worst = {"mu": 0.0, "logvar": 0.0, "regime_probs": 0.0}
        for (status, body, _, _), s, p in zip(got, solo, payloads):
            if body != s:
                fail(f"a batched row (T={len(p['x'][0])}) differs from the "
                     "same request served solo on the card")
            want = cpu.infer(p["x"])
            for key in worst:
                err = float(np.abs(np.asarray(body[key])
                                   - np.asarray(want[key])).max())
                worst[key] = max(worst[key], err)
        if worst["regime_probs"] > 1e-5 or worst["mu"] > 1e-4 \
                or worst["logvar"] > 1e-4:
            fail(f"batched answers differ from the CPU by {worst}")
        say("batching", f"64 mean-field requests (22 at T=37, 21 at 200, "
            f"21 at 512, in that order) from 16 threads: {dispatches} "
            f"dispatches (max_batch 16, linger 2 ms), "
            f"every row bit-equal to the request served solo on the card; "
            f"kernel A launched {launches} = {dispatches} dispatches + 64 "
            f"solo calls; against the CPU: q {worst['regime_probs']:.2e}, "
            f"mu {worst['mu']:.2e}, logvar {worst['logvar']:.2e}; server "
            f"start with warmup {start_s:.1f} s")

        # the same 64 requests, lengths interleaved (37, 200, 512, 37, ...)
        by_T = [[p for p, t in zip(payloads, Ts) if t == T]
                 for T in (37, 200, 512)]
        mixed = [p for row in itertools.zip_longest(*by_T) for p in row
                 if p is not None]
        times = {}
        for name, u in (("solo", solo_url), ("batched", url)):
            _burst(u + "/infer", mixed)                       # warm
            lat, wall, d0 = [], 0.0, handle.dispatches
            for _ in range(3):
                res, w = _burst(u + "/infer", mixed)
                if any(r[0] != 200 for r in res):
                    fail(f"the {name} timing burst had failures")
                lat += [r[3] for r in res]
                wall += w
            times[name] = (*_pcts(lat), len(lat) / wall)
        mixed_dispatches = handle.dispatches - d0
        say("batching", "over HTTP, 3 bursts of the 64 requests interleaved "
            "by length from 16 threads: " + "; ".join(
                f"{n} p50 {v[0]:.3f} ms, p99 {v[1]:.3f} ms, {v[2]:.1f} "
                "req/s" for n, v in times.items())
            + f"; the batched server took {mixed_dispatches} dispatches for "
            "192 requests")

        handle.configure_batching(max_batch=16, max_wait_ms=50.0,
                                  warmup_lengths=(), max_queue=4)
        res, _ = _burst(url + "/infer", payloads)
        shed = [r for r in res if r[0] == 503]
        if not shed or any(r[2].get("Retry-After") != "1" for r in shed):
            fail(f"max_queue=4 shed {len(shed)} requests of 64, or without "
                 "Retry-After")
        if any(r[0] not in (200, 503) for r in res):
            fail(f"the shedding burst answered {[r[0] for r in res]}")
        say("batching", f"max_queue=4: {len(shed)} of 64 answered 503 with "
            "Retry-After: 1, the rest 200")
        handle.configure_batching(max_batch=16, max_wait_ms=2.0,
                                  warmup_lengths=(), max_queue=None)
    finally:
        _stop(solo_httpd)
    return dict(launches=launches, dispatches=dispatches, times=times,
                mixed_dispatches=mixed_dispatches, httpd=httpd, url=url)


def phase_streaming(torch, np, tmp, served, dev="cuda"):
    """22. a 200-frame /stream session from the fixture panel."""
    from vqvaehmm_tpu_torch.data import market
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence
    from vqvaehmm_tpu_torch.serve.app import InferenceModel
    from vqvaehmm_tpu_torch.serve.httpd import serve

    prices, regime, _ = market.load_fixture_frames(FIXTURE)
    x_all, u_all, _, _ = market.prepare_sequences(prices, regime)
    T = 200
    x = np.ascontiguousarray(x_all[:T].T, dtype=np.float32)    # (C, T)
    u = np.ascontiguousarray(u_all[:T].T, dtype=np.float32)    # (U, T)
    url, handle = served["url"], served["httpd"].vqhmm_model
    cpu = InferenceModel(_serving_config(tmp, "stream_cpu.json"),
                         device="cpu")

    def frame(t, **kw):
        return {"x_t": x[:, t].tolist(), "u_t": u[:, t].tolist(), **kw}

    settled, peeks, lat = {}, {}, []
    fused_evidence.launches = 0
    for t in range(T):
        status, out, dt = _request(url + "/stream", dict(
            frame(t), session="main", finish=t == T - 1))
        if status != 200:
            fail(f"/stream frame {t} answered {status}")
        lat.append(dt)
        settled.update({d["t"]: d["regime_probs"] for d in out["settled"]})
        if t < T - 1:
            if out["t_peek"] != t:
                fail(f"/stream frame {t}: t_peek {out['t_peek']}")
            peeks[t] = out["peek"]
    launches = fused_evidence.launches
    # T - 2 settled while streaming, peeks of 1 step after frame 1 and 2
    # after frames 2 .. T-1, 2 settled at finish
    expected = (T - 2) + 1 + 2 * (T - 2) + 2
    if launches != expected:
        fail(f"kernel 11 launched {launches} times for a {T}-frame session "
             f"({expected} steps: settled plus peeked)")
    if sorted(settled) != list(range(T)):
        fail(f"/stream settled {len(settled)} columns of {T}")
    got = np.asarray([settled[t] for t in range(T)]).T            # (K, T)

    def batch(model, device, n):
        with torch.inference_mode():
            return model.filtered_posterior(
                torch.from_numpy(x[None, :, :n]).to(device),
                torch.from_numpy(u[None, :, :n]).to(device),
                torch.tensor([n], device=device))[0].cpu().numpy()

    card = batch(handle.model, handle.device, T)
    gap = float(np.abs(got - card).max())
    if gap > 1e-5:
        fail(f"streamed columns differ from the card's batch filtered "
             f"posterior by {gap:.3e} > 1e-5")
    cpu_gap = float(np.abs(got - batch(cpu.model, "cpu", T)).max())
    if cpu_gap > 1e-4:
        fail(f"streamed columns differ from the CPU by {cpu_gap:.3e}")
    peek_gap = max(float(np.abs(np.asarray(peeks[n - 1])
                                - batch(handle.model, handle.device,
                                        n)[:, n - 1]).max())
                   for n in (1, 2, 3, 100, T - 1))
    if peek_gap > 1e-5:
        fail(f"/stream peeks differ from the truncated batch by {peek_gap}")

    # carried state: frames 0-99 on this server, 100-199 on a second one
    second, url2 = _serve_bg(serve, _serving_config(tmp, "second.json"), dev,
                             warmup_lengths=())
    try:
        state, moved = None, {}
        for t in range(T):
            status, out, _ = _request(
                (url if t < 100 else url2) + "/stream",
                dict(frame(t), session="carried", carry_state=True,
                     state=state, finish=t == T - 1))
            if status != 200 or (t >= 100 and not out["resumed"]):
                fail(f"carried /stream frame {t}: {status}, "
                     f"resumed {out.get('resumed')}")
            state = out.get("state")
            moved.update({d["t"]: d["regime_probs"] for d in out["settled"]})
        if moved != settled:
            fail("a session carried to a second server did not continue bit "
                 "for bit")
    finally:
        _stop(second)

    in_process = []
    for t in range(T):
        t0 = time.perf_counter()
        handle.stream("timed", x_t=x[:, t].tolist(), u_t=u[:, t].tolist(),
                      finish=t == T - 1)
        in_process.append(time.perf_counter() - t0)
    say("streaming", f"{T} frames of the fixture panel over /stream: "
        f"settled columns against the card's batch filtered posterior "
        f"max gap {gap:.3e} ({'bit-equal' if gap == 0 else 'not bit-equal'})"
        f", against the CPU {cpu_gap:.3e}; peeks against the truncated batch "
        f"{peek_gap:.3e}; a state carried to a second server continued bit "
        f"for bit; kernel 11 launched {launches} = {expected} steps; a frame "
        f"p50 {_pcts(in_process)[0]:.3f} ms in process, "
        f"{_pcts(lat)[0]:.3f} ms over HTTP")
    return dict(launches=launches, gap=gap, cpu_gap=cpu_gap,
                p50_ms=_pcts(in_process)[0], http_p50_ms=_pcts(lat)[0])


def phase_reload_cli(torch, np, tmp, dev="cuda"):
    """23. hot reload under load, and the CLI report."""
    import gc
    import threading

    from vqvaehmm_tpu_torch.data import market
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode
    from vqvaehmm_tpu_torch.serve import cli
    from vqvaehmm_tpu_torch.serve.app import InferenceModel
    from vqvaehmm_tpu_torch.serve.httpd import serve

    cfg = _serving_config(tmp, "reload.json")
    os.environ["VQHMM_REQUIRE_CHECKPOINT"] = "1"     # a missing one fails
    os.environ["VQHMM_ENABLE_RELOAD"] = "1"
    os.environ["VQHMM_RELOAD_TOKEN"] = "chip-smoke"
    token = {"X-Reload-Token": "chip-smoke"}
    httpd, url = _serve_bg(serve, cfg, dev, batch=True, max_batch=16,
                           max_wait_ms=2.0, warmup_lengths=(200,))
    handle = httpd.vqhmm_model
    quality = InferenceModel(_serving_config(tmp, "quality.json",
                                             QUALITY_CHECKPOINT), device=dev)
    rng = np.random.default_rng(23)
    C = handle.cfg.model.input_dim
    xs = [rng.normal(size=(C, 200)).astype(np.float32).tolist()
          for _ in range(8)]

    def post(path, payload, headers=None):
        req = urllib.request.Request(
            url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        before = [post("/infer", {"x": x})[1] for x in xs]
        stop, statuses = threading.Event(), []

        def load():
            i = 0
            while not stop.is_set():
                statuses.append(post("/infer", {"x": xs[i % 8]})[0])
                i += 1

        workers = [threading.Thread(target=load) for _ in range(8)]
        for w in workers:
            w.start()
        time.sleep(0.3)
        _serving_config(tmp, "reload.json", QUALITY_CHECKPOINT)
        t0 = time.perf_counter()
        status, info = post("/admin/reload", {}, token)
        reload_s = time.perf_counter() - t0
        time.sleep(0.3)
        stop.set()
        for w in workers:
            w.join(timeout=60)
        if status != 200 or not info.get("batching"):
            fail(f"/admin/reload answered {status} {info}")
        if any(w.is_alive() for w in workers) or set(statuses) != {200}:
            fail(f"requests during the reload answered {sorted(set(statuses))}")
        after = [post("/infer", {"x": x})[1] for x in xs]
        if after != [quality.infer(x) for x in xs] or after == before:
            fail("after the reload the server does not answer as the "
                 "quality model served solo")
        if post("/admin/reload", {}, {"X-Reload-Token": "wrong"})[0] != 403:
            fail("a reload with a wrong token was not refused")
        _serving_config(tmp, "reload.json", os.path.join(tmp, "missing.npz"))
        status, _ = post("/admin/reload", {}, token)
        if status != 500 or [post("/infer", {"x": x})[1]
                             for x in xs[:2]] != after[:2]:
            fail(f"a failed reload answered {status} or stopped the old "
                 "model serving")
        say("reload", f"{len(statuses)} requests from 8 threads through a "
            f"reload to the quality checkpoint ({reload_s:.2f} s, batcher "
            "rebuilt and warmed): all 200; answers afterwards equal the "
            "quality model's solo answers on the card; a failed reload "
            "(500) left it serving")

        mem = []
        for i in range(5):
            _serving_config(tmp, "reload.json", (CHECKPOINT,
                                                 QUALITY_CHECKPOINT)[i % 2])
            if post("/admin/reload", {}, token)[0] != 200:
                fail(f"reload {i + 1} of 5 failed")
            post("/infer", {"x": xs[i]})
            _request(url + "/stream", {"session": "r", "x_t": [0.1] * C,
                                       "u_t": [0.0] * handle.cfg.model.u_dim})
            gc.collect()
            torch.cuda.synchronize()
            mem.append(torch.cuda.memory_allocated())
        if abs(mem[-1] - mem[0]) > 1 << 20:
            fail(f"device memory after reloads grew {mem} bytes")
        say("reload", f"memory_allocated after each of five more reloads "
            f"and gc: {mem} bytes")
    finally:
        _stop(httpd)
        handle.close()
        os.environ.pop("VQHMM_ENABLE_RELOAD", None)
        os.environ.pop("VQHMM_RELOAD_TOKEN", None)

    prices, regime, _ = market.load_fixture_frames(FIXTURE)
    x_all, _, _, _ = market.prepare_sequences(prices, regime)
    np.save(os.path.join(tmp, "x.npy"),
            np.ascontiguousarray(x_all[:200].T[None], dtype=np.float32))
    argv = ["--config", CONFIG, "--checkpoint", CHECKPOINT, "--data",
            os.path.join(tmp, "x.npy")]
    fused_encode.launches = 0
    got = cli.main(argv + ["--device", dev])
    launches = fused_encode.launches
    want = cli.main(argv + ["--device", "cpu"])
    if launches != 1:
        fail(f"the CLI launched kernel 8 {launches} times, not once")
    gap = max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
              for k in ("regime_probs", "last_allocations"))
    gap = max(gap, max(abs(a - b) for a, b in zip(
        got["allocation"].values(), want["allocation"].values())))
    if gap > 1e-5 or got["current_regime"] != want["current_regime"]:
        fail(f"the CLI report on the card differs from the CPU by {gap}")
    say("cli", f"serve.cli on the published checkpoint and 200 days of the "
        f"fixture panel: kernel 8 launched {launches}, the report within "
        f"{gap:.2e} of the CPU")
    return dict(cli_launches=launches, cli_gap=gap, memory=mem,
                reload_s=reload_s)


class _FixedPosterior:
    """A VAE stand-in whose posterior is a given list of q, one a batch in
    order: a CPU run of a head trainer then starts from the card's
    posteriors, so only the head's arithmetic differs."""

    def __init__(self, qs, device):
        self.device = device
        self._qs = iter(qs)

    def posterior(self, x):
        return next(self._qs).to(x.device)


def _timed(torch, fn, *args):
    """(fn(*args), wall seconds), the card synchronised at both ends; what
    fn prints (the recipe's stages report as they go) is dropped."""
    import contextlib
    import io

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _history_gap(got, want) -> float:
    """Largest relative difference between two loss histories."""
    if len(got) != len(want) or not len(want):
        fail(f"histories of {len(got)} and {len(want)} epochs")
    return max(_rel(g, w) for g, w in zip(got, want))


def _trainer_gaps(torch, np, recipe, heads, out, qs, dev):
    """train_portfolio, train_portfolio_optimizer and train_delta_hedger
    (pointwise and LSTM) for 5 epochs on the recipe's batches, on the card
    and on the CPU from the card's posteriors: the largest relative
    difference of each history, and kernel 8's launches on the card."""
    from vqvaehmm_tpu_torch.models.hedging import (LSTMDeltaHedger,
                                                   RegimeDeltaHedger)
    from vqvaehmm_tpu_torch.models.portfolio import HeadConfig
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    model = recipe.load_trained(dev)
    batches, rets = recipe.head_batches(out)
    rng = np.random.default_rng(24)
    futures = [rng.normal(0, 0.01, size=(x.shape[0], x.shape[2] - 1, 5))
               .astype(np.float32) for x, _, _ in batches]
    cfg = HeadConfig(K=3, n_assets=5, hidden_dim=64)
    cases = {
        "train_portfolio": (lambda d: recipe.initial_head(d), rets, {}),
        "train_portfolio_optimizer": (lambda d: recipe.initial_head(d),
                                      rets, {}),
        "train_delta_hedger": (lambda d: RegimeDeltaHedger(
            cfg, device=d, generator=torch.Generator().manual_seed(3)),
            futures, {}),
        "train_delta_hedger (LSTM)": (lambda d: LSTMDeltaHedger(
            cfg, device=d, generator=torch.Generator().manual_seed(4)),
            futures, {"is_lstm": True}),
    }
    gaps, launches = {}, 0
    for name, (make, targets, kw) in cases.items():
        fn = getattr(heads, name.split(" ")[0])
        before = fused_encode.launches
        got = fn(make(dev), model, batches, targets, num_epochs=5, lr=1e-3,
                 log_fn=None, **kw)
        launches += fused_encode.launches - before
        want = fn(make(torch.device("cpu")),
                  _FixedPosterior(qs, torch.device("cpu")), batches, targets,
                  num_epochs=5, lr=1e-3, log_fn=None, **kw)
        gaps[name] = _history_gap(got.history, want.history)
    return gaps, launches, len(batches)


def phase_heads(torch, np, tmp):
    """24. the recipe's data, head, backtest and walk-forward stages on
    the card and on the CPU."""
    import vqvaehmm_tpu_torch.train.heads as heads
    from vqvaehmm_tpu_torch import recipe
    from vqvaehmm_tpu_torch.data.checkpoint import load_improved_head
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    out = {d: os.path.join(tmp, d) for d in ("cuda", "cpu", "cuda_again")}
    walls = {}

    def cli(stage, d):
        """`python -m vqvaehmm_tpu_torch.recipe --stage S --device D`."""
        rc = recipe.main(["--stage", stage, "--outdir", out[d],
                          "--device", d])
        if rc != 0:
            fail(f"the recipe's {stage} stage on {d} exited {rc}")

    def history(d):
        with open(os.path.join(out[d], "head_history.json")) as f:
            return json.load(f)["loss"]

    for d in ("cuda", "cpu"):
        _, walls[("data", d)] = _timed(torch, cli, "data", d)
    batches, rets = recipe.head_batches(out["cuda"])
    if recipe.head_batches(out["cpu"])[0][0][0].tobytes() != \
            batches[0][0].tobytes():
        fail("the data stage wrote different windows on the two runs")

    # the frozen posteriors, card against CPU (outside the counted window)
    qs = heads.frozen_posteriors(recipe.load_trained(dev), batches)
    q_cpu = heads.frozen_posteriors(recipe.load_trained(cpu), batches)
    post_err = max(max_abs(a.cpu(), b) for a, b in zip(qs, q_cpu))
    if post_err > 1e-5:
        fail(f"head posteriors: card against CPU {post_err:.3e} > 1e-5")

    # the head stage: kernel 8 once a batch, counted over the stage alone
    fused_encode.launches = 0
    _, walls[("head", "cuda")] = _timed(torch, cli, "head", "cuda")
    head_launches = fused_encode.launches
    if head_launches != len(batches):
        fail(f"the head stage launched kernel 8 {head_launches} times for "
             f"{len(batches)} batches (once a batch, not once an epoch)")
    _, walls[("head", "cpu")] = _timed(torch, cli, "head", "cpu")
    hist = history("cuda")
    if len(hist) != recipe.HEAD_EPOCHS or not np.isfinite(hist).all():
        fail(f"head history {hist[:3]}... of {len(hist)} epochs")
    fixed, wall_fixed = _timed(
        torch, lambda: heads.train_portfolio_fused(
            recipe.initial_head(cpu), _FixedPosterior(qs, cpu), batches,
            rets, num_epochs=recipe.HEAD_EPOCHS, lr=recipe.HEAD_LR))
    gap = _history_gap(hist, fixed.history)
    own_gap = _history_gap(hist, history("cpu"))
    if gap > 1e-4:
        fail(f"head history: card against the CPU from the card's "
             f"posteriors {gap:.3e} relative > 1e-4")
    # the recipe run again on the card: the same bits, and the written
    # head loads back as the trained one
    _, walls[("data", "cuda_again")] = _timed(torch, recipe.stage_data,
                                              out["cuda_again"])
    res, walls[("head", "cuda_again")] = _timed(
        torch, recipe.stage_head, out["cuda_again"], dev)
    if res.history != hist:
        fail("a second card run of the head stage gave another history")
    path = os.path.join(out["cuda"], "portfolio_head.npz")
    with np.load(path) as a, np.load(os.path.join(out["cuda_again"],
                                                   "portfolio_head.npz")) as b:
        if sorted(a.files) != sorted(b.files) or any(
                a[k].tobytes() != b[k].tobytes() for k in a.files):
            fail("the two card runs wrote different portfolio_head.npz")
    loaded = load_improved_head(path, device=dev).state_dict()
    if loaded.keys() != res.params.keys() or any(
            not torch.equal(v, res.params[k]) for k, v in loaded.items()):
        fail("portfolio_head.npz does not load back bit for bit")
    say("heads", f"data stage {walls[('data', 'cuda')]:.3f} s / "
        f"{walls[('data', 'cpu')]:.3f} s (card run / CPU run); posteriors of "
        f"{len(batches)} batches of 16 x 100, card against CPU "
        f"{post_err:.3e}; head stage ({recipe.HEAD_EPOCHS} epochs, "
        f"{recipe.HEAD_EPOCHS * len(batches)} updates) "
        f"{walls[('head', 'cuda')]:.3f} s on the card, "
        f"{walls[('head', 'cpu')]:.3f} s on the CPU; loss "
        f"{hist[0]:.6f} -> {hist[-1]:.6f}; history against "
        f"the CPU from the card's posteriors {gap:.3e} relative "
        f"({wall_fixed:.3f} s), from its own {own_gap:.3e}; a second card "
        f"run bit-equal; portfolio_head.npz loads back bit for bit; kernel "
        f"8 launched {head_launches} times")

    # the CPU's later stages start from the card's head
    shutil.copyfile(path, os.path.join(out["cpu"], "portfolio_head.npz"))
    bt = {}
    for d, device in (("cuda", dev), ("cpu", cpu)):
        bt[d], walls[("backtest", d)] = _timed(
            torch, recipe.stage_backtest, out[d], device)
    _, walls[("backtest", "cuda_again")] = _timed(
        torch, recipe.stage_backtest, out["cuda_again"], dev)
    bt_gap = max(_rel(bt["cuda"][s][k], v) for s in bt["cpu"]
                 for k, v in bt["cpu"][s].items())
    if bt_gap > 1e-4:
        fail(f"backtest stage: a metric differs by {bt_gap:.3e} relative")

    # the walk-forward stage, its windows recorded and its retrains counted
    windows, retrains = {}, {}
    real_wf, real_fit = recipe.walk_forward, recipe.train_portfolio_fused
    stage = {}
    try:
        for d, device in (("cuda", dev), ("cpu", cpu)):
            def record(*args, _d=d):
                windows[_d] = real_wf(*args)
                return windows[_d]

            def fit(*args, _d=d, **kw):
                retrains[_d] = retrains.get(_d, 0) + 1
                return real_fit(*args, **kw)

            recipe.walk_forward, recipe.train_portfolio_fused = record, fit
            if d == "cuda":
                for f in (fused_encode, fused_evidence, fused_viterbi_states,
                          viterbi_fused):
                    f.launches = 0
            stage[d], walls[("walkforward", d)] = _timed(
                torch, recipe.stage_walkforward, out[d], device)
            if d == "cuda":
                wf_launches = {"fused_encode": fused_encode.launches,
                               "fused_evidence": fused_evidence.launches,
                               "fused_decode": fused_viterbi_states.launches,
                               "viterbi": viterbi_fused.launches}
    finally:
        recipe.walk_forward, recipe.train_portfolio_fused = real_wf, real_fit
    _, walls[("walkforward", "cuda_again")] = _timed(
        torch, recipe.stage_walkforward, out["cuda_again"], dev)
    n_win = len(windows["cuda"])
    if n_win != len(windows["cpu"]) or not n_win or \
            retrains.get("cuda") != n_win:
        fail(f"walk-forward: {n_win} windows on the card, "
             f"{len(windows['cpu'])} on the CPU, {retrains} retrains")
    wf_gap = max(_metrics_gap(g, w) for g, w in zip(windows["cuda"],
                                                     windows["cpu"]))
    if wf_gap > 1e-4:
        fail(f"walk-forward windows: a metric differs by {wf_gap:.3e} "
             "relative between the card and the CPU (> 1e-4)")
    # kernel 8: one a retrain, one a window (each trades from its warm-up),
    # one for the argmax decode of the panel, and one a per-regime
    # backtest that trades (a regime of more than 21 days); kernel 11 for
    # the Viterbi decode and the crash-cost block's smoothed posterior
    per_regime = sum(r["n_periods"] > 21
                     for mode in stage["cuda"]["per_regime"].values()
                     for r in mode.values())
    expected = {"fused_encode": retrains["cuda"] + n_win + 1 + per_regime,
                "fused_evidence": 2, "fused_decode": 0, "viterbi": 1}
    if wf_launches != expected:
        fail(f"the walk-forward stage launched {wf_launches}; its "
             f"{retrains['cuda']} retrains, {n_win} windows, one argmax "
             f"decode, {per_regime} per-regime backtests, a Viterbi decode "
             f"and a smoothed posterior imply {expected}")
    gaps, trainer_launches, n_batches = _trainer_gaps(
        torch, np, recipe, heads, out["cuda"], qs, dev)
    if trainer_launches != len(gaps) * n_batches:
        fail(f"the four trainer runs launched kernel 8 {trainer_launches} "
             f"times for {n_batches} batches each")
    worst = max(gaps.values())
    if worst > 1e-4:
        fail(f"5-epoch trainers, card against CPU: {gaps} (> 1e-4)")

    # where a head update's time goes: epochs of the head stage's updates
    # (one update a batch) traced on the card, and timed
    def epoch():
        heads.train_portfolio_fused(
            recipe.initial_head(dev), _FixedPosterior(qs, dev), batches,
            rets, num_epochs=1, lr=recipe.HEAD_LR)

    busy, ops = _device_trace(torch, epoch, calls=3)
    wall = _wall(torch, epoch)
    n = len(batches)
    update = {"wall_ms": wall[0] / n, "device_ms": None if busy is None
              else busy / n, "device_ops": None if ops is None else ops / n}
    m = stage["cuda"]["walk_forward"]
    say("heads", f"backtest stage {walls[('backtest', 'cuda')]:.3f} s / "
        f"{walls[('backtest', 'cpu')]:.3f} s, metrics against the CPU "
        f"{bt_gap:.3e}; walk-forward stage "
        f"{walls[('walkforward', 'cuda')]:.3f} s / "
        f"{walls[('walkforward', 'cpu')]:.3f} s: {n_win} windows, "
        f"{retrains['cuda']} retrains of {recipe.WF_EPOCHS} epochs, chained "
        f"return {m['chained_total_return']}, mean Sharpe "
        f"{m['mean_window_sharpe']}; window metrics against the CPU "
        f"{wf_gap:.3e} relative; launches {wf_launches}")
    say("heads", f"a head update on the card (an epoch of {n} traced): "
        f"{update['wall_ms']:.3f} ms of wall [{wall[1] / n:.3f}, "
        f"{wall[2] / n:.3f}], device time {_ms(update['device_ms'])}, "
        + ("device ops not measured" if ops is None else
           f"{update['device_ops']:.1f} device ops")
        + ("" if busy is None else
           f"; the card busy {100 * busy / wall[0]:.1f}% of it"))
    say("heads", "5 epochs on the recipe's batches, card against the CPU "
        "from the card's posteriors: " + ", ".join(
            f"{k} {v:.3e}" for k, v in gaps.items())
        + f"; kernel 8 {trainer_launches} launches for {len(gaps)} runs of "
        f"{n_batches} batches")
    return {"head_launches": head_launches,
            "walkforward_launches": wf_launches["fused_encode"],
            "walls": walls, "out": out, "update": update}


def phase_montecarlo(torch, np, heads_out):
    """25. the recipe's Monte Carlo stage on the card and on the CPU."""
    import warnings

    from vqvaehmm_tpu_torch import recipe
    from vqvaehmm_tpu_torch.backtest import montecarlo
    from vqvaehmm_tpu_torch.data.checkpoint import load_improved_head
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    out, walls = heads_out["out"], heads_out["walls"]
    seen, real_stats = {}, montecarlo.regime_statistics
    stage, warned = {}, {}
    try:
        for d, device in (("cuda", dev), ("cpu", cpu)):
            def record(rets, regimes, K, _d=d):
                seen[_d] = (rets, regimes)
                return real_stats(rets, regimes, K)

            montecarlo.regime_statistics = record
            if d == "cuda":
                for f in (fused_encode, fused_evidence, fused_viterbi_states,
                          viterbi_fused):
                    f.launches = 0
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                stage[d], walls[("montecarlo", d)] = _timed(
                    torch, recipe.stage_montecarlo, out[d], device)
            warned[d] = [str(w.message) for w in caught]
            if d == "cuda":
                mc_launches = {"fused_encode": fused_encode.launches,
                               "fused_evidence": fused_evidence.launches,
                               "fused_decode": fused_viterbi_states.launches,
                               "viterbi": viterbi_fused.launches}
    finally:
        montecarlo.regime_statistics = real_stats
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # printed by the first run
        _, walls[("montecarlo", "cuda_again")] = _timed(
            torch, recipe.stage_montecarlo, out["cuda_again"], dev)
    expected = {"fused_encode": 0, "fused_evidence": 1, "fused_decode": 0,
                "viterbi": 1}
    if mc_launches != expected:
        fail(f"the Monte Carlo stage launched {mc_launches}; its one "
             f"two-stage decode of the panel implies {expected}")
    rets, regimes = seen["cuda"]
    states = {d: torch.as_tensor(seen[d][1])[None] for d in seen}
    differ = int((states["cuda"] != states["cpu"]).sum())
    if differ:
        model = recipe.load_trained(cpu)
        data, u_data, _, _ = recipe._panel(out["cpu"])
        with torch.inference_mode():
            ev = fused_evidence(model, torch.from_numpy(data.astype(
                np.float32)), torch.from_numpy(u_data.astype(np.float32)))
        gap, excess = _tie_gap(torch, ev, states["cuda"], states["cpu"],
                               None)
        if excess > 1.0:
            fail(f"panel decode: the card's path scores {gap:.3e} from the "
                 f"CPU's, {excess:.1f} times the tolerance of a tie")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the stage printed them
        means, covs = montecarlo.regime_statistics(rets, regimes, K=3)

    # the simulation alone, on each device from the same draws
    sims, sim_ms = {}, {}
    for d, device in (("cuda", dev), ("cpu", cpu)):
        head = load_improved_head(os.path.join(out["cuda"],
                                               "portfolio_head.npz"), device)
        sims[d], wall = _timed(
            torch, lambda: montecarlo.monte_carlo_simulation(
                lambda oh: head(oh[None])[0], means, covs,
                torch.Generator().manual_seed(recipe.MC_SEED),
                n_sim=recipe.MC_PATHS, n_days=recipe.MC_DAYS, device=device))
        sim_ms[d] = 1e3 * wall
    head = load_improved_head(os.path.join(out["cuda"], "portfolio_head.npz"),
                              dev)

    def simulate():
        return montecarlo.monte_carlo_simulation(
            lambda oh: head(oh[None])[0], means, covs,
            torch.Generator().manual_seed(recipe.MC_SEED),
            n_sim=recipe.MC_PATHS, n_days=recipe.MC_DAYS, device=dev)

    sim_busy, sim_ops = _device_trace(torch, simulate, calls=2)
    sim_wall = _wall(torch, simulate)
    fin = {d: sims[d]["final_values"].cpu().double() for d in sims}
    fin_gap = float(((fin["cuda"] - fin["cpu"]).abs()
                     / fin["cpu"].abs().clamp_min(1e-12)).max())
    stats = {d: montecarlo.analyze_monte_carlo(sims[d]) for d in sims}
    stat_gap = max(abs(stats["cuda"][k] - v) for k, v in stats["cpu"].items())
    if fin_gap > 1e-4 or stat_gap > 1e-4:
        fail(f"Monte Carlo on the same draws: final values {fin_gap:.3e} "
             f"relative, statistics {stat_gap:.3e} absolute (> 1e-4)")
    staged = stage["cuda"][0]
    for key in ("final_values", "daily_returns"):
        if not torch.equal(staged[key], sims["cuda"][key]):
            fail(f"Monte Carlo from the same seed twice on the card: {key} "
                 "not bit-equal")
    if tuple(staged["daily_returns"].shape) != (recipe.MC_PATHS,
                                                 recipe.MC_DAYS) or \
            not torch.isfinite(staged["daily_returns"]).all():
        fail(f"daily returns {tuple(staged['daily_returns'].shape)}")
    s = stage["cuda"][1]
    counts = np.bincount(np.asarray(regimes), minlength=3).tolist()
    say("montecarlo", f"panel Viterbi decode: regime days {counts}, "
        f"{differ} steps differ from the CPU's (a score tie where any); "
        f"{recipe.MC_PATHS} x {recipe.MC_DAYS} paths: the simulation "
        f"{sim_ms['cuda']:.1f} ms on the card, {sim_ms['cpu']:.1f} ms on "
        f"the CPU (first calls); again on the card {sim_wall[0]:.1f} ms "
        f"[{sim_wall[1]:.1f}, {sim_wall[2]:.1f}], "
        f"device time {_ms(sim_busy)}, "
        + ("device ops not measured" if sim_ops is None else
           f"{sim_ops:.0f} device ops") + "; "
        f"final values against the CPU {fin_gap:.3e} relative, "
        f"statistics {stat_gap:.3e} absolute; the stage twice from one "
        f"seed bit-equal; stage {walls[('montecarlo', 'cuda')]:.3f} s / "
        f"{walls[('montecarlo', 'cpu')]:.3f} s; mean return "
        f"{s['mean_return']:.4f}, P(profit) {s['prob_profit']:.4f}, "
        f"expected Sharpe {s['expected_sharpe']:.4f}; launches {mc_launches}"
        f"; the card's warnings: {warned['cuda'] or 'none'}")
    say("montecarlo", "recipe stage wall seconds, card (first run, second "
        "run) / CPU: " + "; ".join(
            f"{st} {walls[(st, 'cuda')]:.3f}, "
            f"{walls[(st, 'cuda_again')]:.3f} / {walls[(st, 'cpu')]:.3f}"
            for st in recipe.STAGES if (st, "cuda_again") in walls))
    return mc_launches


# Phases 26-28: the GMM stack, seed ensembles, prefetch and profiling

def _same_state(torch, a, b) -> bool:
    """Two state_dicts bit-equal."""
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _gmm_fit_gap(torch, np, card, cpu, feats, dev):
    """(responsibility gap, likelihood gap, note) of two fits of one
    restart set on the card and on the CPU.  Where the two devices keep
    different restarts, those restarts' likelihoods must tie within 1e-5
    relative, and the restart the card kept is refitted alone on both."""
    from vqvaehmm_tpu_torch.models.gmm import GaussianMixture

    g_card, g_cpu = card.gmm, cpu.gmm
    rel = float(np.max(np.abs(g_card.lls_ - g_cpu.lls_)
                       / np.abs(g_cpu.lls_)))
    if rel > 1e-5:
        fail(f"the restarts' final log-likelihoods on the card "
             f"{g_card.lls_} against the CPU's {g_cpu.lls_}: relative "
             f"{rel:.3e} > 1e-5")
    b_card, b_cpu = int(np.argmax(g_card.lls_)), int(np.argmax(g_cpu.lls_))
    note = f"both keep restart {b_card}"
    if b_card != b_cpu:
        note = (f"the card keeps restart {b_card}, the CPU {b_cpu}, whose "
                "likelihoods tie; compared on the card's restart refitted "
                "alone")
        x = card._norm(feats)
        init = g_card._init_params(g_card._data(x))
        one = [a[b_card:b_card + 1] for a in init]
        g_card = GaussianMixture(3, n_init=1, device=dev).fit(x, init=one)
        g_cpu = GaussianMixture(3, n_init=1, device="cpu").fit(
            x, init=[a.cpu() for a in one])
        x_card, x_cpu = x, x
    else:
        x_card, x_cpu = card._norm(feats), cpu._norm(feats)
    p_card, p_cpu = g_card.predict_proba(x_card), g_cpu.predict_proba(x_cpu)
    gap = float(np.abs(p_card - p_cpu).max())
    ll_gap = _rel(g_card.log_likelihood_, g_cpu.log_likelihood_)
    if gap > 1e-4 or ll_gap > 1e-5 or not np.array_equal(
            p_card.argmax(-1), p_cpu.argmax(-1)):
        fail(f"the GMM on the card against the CPU: responsibilities "
             f"{gap:.3e} (tol 1e-4), log-likelihood {ll_gap:.3e} relative "
             f"(tol 1e-5), labels equal: "
             f"{np.array_equal(p_card.argmax(-1), p_cpu.argmax(-1))}")
    return gap, ll_gap, note


def phase_gmm(torch, np, tmp):
    """26. the GMM stack on the fixture panel, card against the CPU."""
    from vqvaehmm_tpu_torch.data import market
    from vqvaehmm_tpu_torch.models.gmm import (SimpleRegimeDetector,
                                               prepare_regime_features)
    from vqvaehmm_tpu_torch.serve import cli
    from vqvaehmm_tpu_torch.train.gmm_pipeline import (load_improved_system,
                                                       train_improved_system)

    prices, regime, _ = market.load_fixture_frames(FIXTURE)
    returns = np.asarray(market.prepare_sequences(prices, regime)[2].values,
                         np.float32)
    kw = dict(n_regimes=3, num_epochs=100, patience=20, log_fn=None)
    feats = prepare_regime_features(returns)
    cuda = torch.device("cuda")

    # the entry point as scripts/backtest.py calls it, with the chain
    def run(**more):
        return _timed(torch, lambda: train_improved_system(returns, **kw,
                                                           **more))

    card, card_s = run(temporal=True, device=cuda)
    again, again_s = run(temporal=True, device=cuda)
    cpu, cpu_s = run(temporal=True, device="cpu")
    repeat = (again.history == card.history
              and _same_state(torch, again.optimizer.state_dict(),
                              card.optimizer.state_dict())
              and all(torch.equal(a, b) for a, b in zip(
                  (*again.detector.gmm.params, *again.chain),
                  (*card.detector.gmm.params, *card.chain))))
    say("gmm", f"train_improved_system on the fixture panel ({returns.shape[0]}"
        f" days x {returns.shape[1]} assets, 13 features, 10 restarts of "
        f"100 EM steps, 100 head epochs at most, the 40-step chain): "
        f"{card_s:.3f} s on the card ({again_s:.3f} s the second run), "
        f"{cpu_s:.3f} s on the CPU; the second card run bit-equal "
        f"(detector, head, history, chain): {repeat}")

    # the EM: the card's from the CPU's inits (the same Generator draws)
    gap, ll_gap, note = _gmm_fit_gap(torch, np, card.detector, cpu.detector,
                                     feats, cuda)
    em = {}
    for name, dev in (("card", cuda), ("cpu", "cpu")):
        _, em[name] = _timed(torch, SimpleRegimeDetector(3, device=dev).fit,
                             feats)
    say("gmm", f"EM card against CPU: responsibilities {gap:.3e} max-abs "
        f"(tol 1e-4), labels equal, log-likelihood {ll_gap:.3e} relative "
        f"(tol 1e-5), {note}; the fit {1e3 * em['card']:.1f} ms on the "
        f"card, {1e3 * em['cpu']:.1f} ms on the CPU (warm)")

    # the head stage from the same probabilities: the card's detector
    path = os.path.join(tmp, "gmm_system.npz")
    card.save(path)
    det_cpu = load_improved_system(path, device="cpu").detector
    head = {}
    solo, head["card"] = run(detector=card.detector, device=cuda)
    ref, head["cpu"] = run(detector=det_cpu, device="cpu")
    if solo.history != card.history:
        fail("the head stage alone differs from the whole run's on the card")
    hgap = _history_gap(solo.history, ref.history)
    if hgap > 1e-5:
        fail(f"the head stage's history on the card against the CPU from "
             f"the same probabilities: {hgap:.3e} relative > 1e-5")
    say("gmm", f"head stage from the card's probabilities: {len(ref.history)}"
        f" epochs on both devices, history {hgap:.3e} relative (tol 1e-5), "
        f"loss {ref.history[0]:.6f} -> {ref.history[-1]:.6f}; "
        f"{1e3 * head['card']:.1f} ms on the card, "
        f"{1e3 * head['cpu']:.1f} ms on the CPU (features and probabilities"
        " included); the chain, by difference from the whole run, "
        f"{card_s - em['card'] - head['card']:.3f} s on the card, "
        f"{cpu_s - em['cpu'] - head['cpu']:.3f} s on the CPU (inferred)")

    # the archive round trip, and the chain's marginals against the CPU
    back = load_improved_system(path, device=cuda)
    on_cpu = load_improved_system(path, device="cpu")
    mgap, marg = 0.0, {}
    for mode in ("smoothed", "filtered"):
        got, marg[mode] = _timed(torch, back.regime_marginals, feats, mode)
        if not np.array_equal(got, card.regime_marginals(feats, mode)):
            fail(f"the archive's {mode} marginals on the card are not "
                 "bit-equal to the trained system's")
        mgap = max(mgap, float(np.abs(
            got - on_cpu.regime_marginals(feats, mode)).max()))
    if mgap > 1e-4:
        fail(f"the chain's marginals on the card against the CPU: {mgap:.3e}"
             " > 1e-4")
    got = cli.main(["--stack", "gmm", "--checkpoint", path, "--device",
                    "cuda"])
    want = cli.main(["--stack", "gmm", "--checkpoint", path, "--device",
                     "cpu"])
    rgap = max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
               for k in ("regime_probs", "last_allocations"))
    if rgap > 1e-4 or got["current_regime"] != want["current_regime"]:
        fail(f"the gmm report on the card differs from the CPU's by {rgap}")
    proc = subprocess.run(
        [sys.executable, "-m", "vqvaehmm_tpu_torch.serve.cli", "--stack",
         "gmm", "--checkpoint", path, "--device", "cuda"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    line = f"Current regime: {got['current_regime']} "
    if proc.returncode != 0 or line not in proc.stdout:
        fail(f"python -m vqvaehmm_tpu_torch.serve.cli --stack gmm exited "
             f"{proc.returncode}: {proc.stdout[-500:]} {proc.stderr[-2000:]}")
    say("gmm", f"the archive loads back bit for bit; the chain's smoothed "
        f"and filtered marginals on the card against the CPU {mgap:.3e} "
        f"(tol 1e-4), {1e3 * marg['smoothed']:.1f} and "
        f"{1e3 * marg['filtered']:.1f} ms on the card (the plain forward-"
        f"backward loops at T={feats.shape[0]}); the --stack gmm report "
        f"on the card within {rgap:.2e} of the CPU's, and the CLI in a "
        f"subprocess on the card exits 0 with regime "
        f"{got['current_regime']}")
    return {"gmm_train_s": card_s, "gmm_train_cpu_s": cpu_s,
            "gmm_em_ms": 1e3 * em["card"], "gmm_em_cpu_ms": 1e3 * em["cpu"],
            "gmm_head_ms": 1e3 * head["card"],
            "gmm_head_cpu_ms": 1e3 * head["cpu"],
            "gmm_smoothed_ms": 1e3 * marg["smoothed"],
            "gmm_repeat_bit_equal": repeat}


ENSEMBLE_SEEDS = [0, 1, 2, 3]


def phase_ensemble(torch, np, tmp):
    """27. a seed ensemble of the published configuration through
    TrainPipeline on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from vqvaehmm_tpu_torch.data.checkpoint import load_metadata
    from vqvaehmm_tpu_torch.data.device_sampler import DeviceEpochSampler
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads
    from vqvaehmm_tpu_torch.ops.gather import gather_epoch
    from vqvaehmm_tpu_torch.train.ensemble import (init_ensemble_state,
                                                   make_ensemble_epoch_step,
                                                   train_ensemble)
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline
    from vqvaehmm_tpu_torch.train.trainer import train_model

    cfg = _pipeline_cfg(os.path.join(tmp, "gpu"),
                        ensemble_seeds=ENSEMBLE_SEEDS)
    t = cfg.training
    steps = cfg.data.samples_per_epoch // t.batch_size
    pipe = TrainPipeline(cfg, device="cuda")
    fused_loss_and_grads.launches = 0
    gather_epoch.launches = 0
    best_state = pipe.train(log_fn=None)
    torch.cuda.synchronize()
    launches = {"fused_train": fused_loss_and_grads.launches,
                "gather": gather_epoch.launches}
    expected = {"fused_train": len(ENSEMBLE_SEEDS) * t.num_epochs * steps,
                "gather": t.num_epochs}
    if launches != expected:
        fail(f"the ensemble launched {launches}, not {expected} "
             f"({len(ENSEMBLE_SEEDS)} members, {t.num_epochs} epochs of "
             f"{steps} steps)")
    meta = load_metadata(os.path.join(tmp, "gpu", "vae_hmm_trained"))

    # the members again, through train_ensemble as the pipeline calls it,
    # each against a solo run from its initial state over the same epochs
    template = pipe.build_model()
    kw = dict(num_epochs=t.num_epochs, lr=t.learning_rate,
              batch_size=t.batch_size, gradient_clip=t.gradient_clip,
              device_data=True, fused=True, device="cuda", log_fn=None)
    states, hist, best = train_ensemble(template, pipe.load_data(),
                                        ENSEMBLE_SEEDS, **kw)
    if hist[best].tolist() != pipe.history or not _same_state(
            torch, states[best].model.state_dict(),
            best_state.model.state_dict()):
        fail("train_ensemble run again differs from the pipeline's run")
    for i in (0, len(ENSEMBLE_SEEDS) - 1):
        solo = init_ensemble_state(template, [ENSEMBLE_SEEDS[i]],
                                   t.learning_rate, t.gradient_clip,
                                   "cuda")[0]
        state, solo_hist = train_model(solo.model, pipe.load_data(),
                                       state=solo, **kw)
        if hist[i].tolist() != [np.float32(h) for h in solo_hist] or \
                not _same_state(torch, states[i].model.state_dict(),
                                state.model.state_dict()):
            fail(f"ensemble member {i} is not bit-equal to its solo run")
    say("ensemble", f"TrainPipeline, published configuration, "
        f"ensemble_seeds {ENSEMBLE_SEEDS}, {t.num_epochs} epochs of {steps}"
        f" steps on the device pipeline: launches {launches} (kernel C "
        f"members x steps, kernel D once an epoch); best seed "
        f"{meta['best_seed']}, final losses {meta['per_member_final_loss']};"
        f" members 0 and {len(ENSEMBLE_SEEDS) - 1} bit-equal to their solo "
        "runs, parameters and history")

    cpu = TrainPipeline(_pipeline_cfg(os.path.join(tmp, "cpu"),
                                      ensemble_seeds=ENSEMBLE_SEEDS,
                                      input_pipeline="device"),
                        device="cpu")
    cpu_state = cpu.train(log_fn=None)
    cpu_meta = load_metadata(os.path.join(tmp, "cpu", "vae_hmm_trained"))
    if sorted(cpu_meta) != sorted(meta) or \
            cpu_meta["best_seed"] != meta["best_seed"]:
        fail(f"metadata on the card {meta} against the CPU {cpu_meta}")
    lgap = max(_history_gap(meta["per_member_final_loss"],
                            cpu_meta["per_member_final_loss"]),
               _history_gap(pipe.history, cpu.history))
    pgap = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        best_state.model.state_dict().values(),
        cpu_state.model.state_dict().values()))
    if lgap > 1e-5:
        fail(f"ensemble losses on the card against the CPU: {lgap:.3e} "
             "relative > 1e-5")
    say("ensemble", f"the CPU run of the same configuration: the same best "
        f"seed and metadata keys, losses within {lgap:.3e} relative (tol "
        f"1e-5), the best member's parameters within {pgap:.3e}")

    # a steady epoch for n members: wall, member-seqs a second, device
    sampler = DeviceEpochSampler(pipe.load_data(), "cuda")
    with profile(activities=[ProfilerActivity.CUDA]):     # CUPTI set-up
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    timing = {}
    for n in (1, 2, 4, 8):
        members = init_ensemble_state(template, list(range(n)),
                                      t.learning_rate, t.gradient_clip,
                                      "cuda")
        step = make_ensemble_epoch_step(members, fused=True)

        def epoch():
            return step(*sampler.epoch(t.batch_size, steps,
                                       exact_stream=False), 1.0)

        wall = _wall(torch, epoch, repeats=5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            epoch()
            torch.cuda.synchronize()
        ops = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        busy = _busy_us(ops) / 1e3
        timing[n] = dict(wall_ms=wall[0], wall_min=wall[1],
                         wall_max=wall[2], device_ms=busy, ops=len(ops),
                         seqs_s=n * steps * t.batch_size / (wall[0] / 1e3))
        say("ensemble", f"n={n}: a steady epoch ({steps} steps of B="
            f"{t.batch_size} for each member) {wall[0]:.3f} ms of wall "
            f"[{wall[1]:.3f}, {wall[2]:.3f}], {timing[n]['seqs_s']:.1f} "
            f"member-seqs/s; device busy {busy:.4f} ms in {len(ops)} device "
            f"ops ({100 * busy / wall[0]:.1f}% of the wall)")
    return launches, timing


def _synchronous_epochs(torch):
    """prefetch_epochs' contract without the thread: epochs assembled when
    asked for, uploaded synchronously."""
    from vqvaehmm_tpu_torch.data.dataset import epoch_arrays

    def epochs(dataset, batch_size, num_epochs, num_batches=None,
               buffer_size=2, device="cuda"):
        for _ in range(num_epochs):
            yield tuple(torch.from_numpy(a).to(device) for a in
                        epoch_arrays(dataset, batch_size, num_batches))
    return epochs


def phase_prefetch_profile(torch, np, tmp):
    """28. host-fed training with and without prefetched epochs, and
    training.profile_dir."""
    from vqvaehmm_tpu_torch.train import pipeline

    walls, runs = {}, {}
    real = pipeline.prefetch_epochs
    for name in ("prefetched", "synchronous"):
        stamps = []

        def log(msg):
            if msg.startswith("Epoch "):
                stamps.append(time.perf_counter())

        pipeline.prefetch_epochs = (real if name == "prefetched"
                                    else _synchronous_epochs(torch))
        try:
            pipe = pipeline.TrainPipeline(_pipeline_cfg(
                os.path.join(tmp, name), input_pipeline="host", save_freq=0,
                num_epochs=6), device="cuda")
            state = pipe.train(log_fn=log)
        finally:
            pipeline.prefetch_epochs = real
        runs[name] = (pipe.history, state.model.state_dict())
        gaps = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        walls[name] = statistics.median(gaps[1:])
    equal = runs["prefetched"][0] == runs["synchronous"][0] and _same_state(
        torch, runs["prefetched"][1], runs["synchronous"][1])
    if not equal:
        fail("host-fed training with prefetched epochs is not bit-equal to "
             "the synchronous loop")
    say("prefetch", f"host-fed TrainPipeline, published configuration, 6 "
        f"epochs: bit-equal with and without prefetch; a steady epoch "
        f"(median of epochs 3-6) {walls['prefetched']:.1f} ms prefetched, "
        f"{walls['synchronous']:.1f} ms synchronous")

    trace_dir = os.path.join(tmp, "trace")
    pipeline.TrainPipeline(_pipeline_cfg(
        os.path.join(tmp, "prof"), save_freq=0, profile_dir=trace_dir),
        device="cuda").train(log_fn=None)
    path = os.path.join(trace_dir, "trace.json")
    with open(path) as f:
        text = f.read()
    names = [k for k in ("train_forward_kernel", "train_backward_kernel",
                         "gather_kernel") if k in text]
    if "train_forward_kernel" not in names:
        fail(f"the training.profile_dir trace {path} does not name kernel "
             f"C ({len(text)} bytes; found {names})")
    say("prefetch", f"training.profile_dir wrote {len(text)} bytes of "
        f"Chrome trace for epoch 2; it names {names}")
    return walls


# ---------------------------------------------------------------------------
# 29. the throughput configuration: compute_dtype "bfloat16" with
# matmul_precision "default" (bench.py's headline, the "throughput" variant
# of scripts/throughput_quality_ab.py)
# ---------------------------------------------------------------------------

BF16_MODEL = {"compute_dtype": "bfloat16", "matmul_precision": "default"}
# kernel C's bfloat16 mode against its plain version on the card: the
# loss's relative error, and a gradient's max-abs error as a share of its
# leaf's largest entry.  A float32 sum in another order can move an
# activation across a bfloat16 rounding boundary, by 2^-8 of it, so the
# bars are looser than the float32 mode's 1e-5 and 1e-4: measured 1.9e-5
# and 2.5e-4 at most (NVIDIA H100 80GB HBM3, 700 W), and the float32
# mode's gradients 1.4e-2 to 3.3e-2 away, over 10x the bar.
BF16_LOSS_TOL, BF16_GRAD_TOL = 1e-4, 5e-4
# the throughput configuration's epoch losses on the card against the CPU
# (the kernel's plain version there), relative: measured 8.8e-7
BF16_TRAIN_TOL = 1e-5
# a bfloat16 model's served outputs on the card against the CPU, as a
# share of each value's magnitude (at least 1): one bfloat16 rounding
# (measured 4.9e-4); a Viterbi path's steps that may differ at near-ties
BF16_SERVE_TOL, BF16_VITERBI_FLIPS = 2 ** -8, 0.01


def _bf16_model(torch, model):
    """A copy of `model` in the throughput configuration (the same
    parameters, compute_dtype bfloat16)."""
    import dataclasses

    from vqvaehmm_tpu_torch.models.vae_hmm import VAEHMM

    m = VAEHMM(dataclasses.replace(model.cfg, **BF16_MODEL),
               device=model.device)
    m.load_state_dict(model.state_dict())
    return m


def _bf16_cfg(ckpt_dir, **training):
    """artifacts/config_published.json in the throughput configuration
    (the "throughput" variant of scripts/throughput_quality_ab.py: the
    kernel where it runs, the device input pipeline), 4 epochs."""
    from vqvaehmm_tpu_torch.core.config import apply_overrides

    cfg = _pipeline_cfg(ckpt_dir, **{"fused": "auto",
                                     "input_pipeline": "device", **training})
    return apply_overrides(cfg, [f"model.{k}={json.dumps(v)}"
                                 for k, v in BF16_MODEL.items()])


# kernel C's bfloat16 mode at the float32 mode's tile edges and widths
# (tests/test_torch_cuda.py::test_fused_train_tile_edges_and_widths) and
# more, (B, T, short, widths) on _seeded_model: a last tile of one step at
# each tile width; T = 1; hidden 16/8 with K=2 and trans_hidden 20, (mu,
# logvar) the widest rows; H2 > H1, K=16, and C, 2C and HP that are not
# multiples of 16 (its short batch is in BF16_ORDER_CASES)
K16_WIDTHS = dict(input_dim=7, hidden_dim=24, hidden_dim2=40, K=16,
                  trans_hidden=36)
BF16_WIDTH_CASES = (
    (2, 17, 13, {}), (20, 33, 25, {}), (70, 129, 97, {}), (1, 1, None, {}),
    (3, 40, 30, dict(input_dim=12, hidden_dim=16, hidden_dim2=8, K=2,
                     trans_hidden=20)),
    (32, 50, 40, K16_WIDTHS))
# Short batches, (B, T, short, widths), where a single activation that one
# float32 order of the sums rounds to the other bfloat16 moves a gradient
# by about BF16_GRAD_TOL of its leaf's largest entry or more: the probe's
# widths on 2 x 37 steps and K=16 on 4 x 50.  There the bar does not tell
# a fault from another order: the CPU's plain versions and the card's
# (cuBLAS) part by more than BF16_GRAD_TOL on some inputs, and the kernel
# lies among them (_bf16_order_case prints both).  So each case runs on
# ORDER_INPUTS inputs, its gradients held to the larger of BF16_GRAD_TOL
# and ORDER_MULT times the plain versions' spread on the same inputs (the
# CPU reference's and the tiled version's distance to the card's plain
# version), at the worst input and at the median.
BF16_ORDER_CASES = ((2, 37, 28, PROBE), (4, 50, 40, K16_WIDTHS))
ORDER_INPUTS, ORDER_MULT = 6, 2.0


def _bf16_case(torch, np, m32, x, u, lens, beta, what):
    """Kernel C's bfloat16 mode on a copy of m32 against its plain version
    on the card: (loss error relative, largest gradient error as a share of
    its leaf's largest entry, largest max-abs error, the gradients of the
    float32 mode); fails where a bar is missed, a second call is not
    bit-equal, or the float32 mode's outputs move across the calls."""
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads

    m = _bf16_model(torch, m32)
    first32 = fused_loss_and_grads(m32, x, u, lens, beta, use_kernel=True)
    loss, grads = fused_loss_and_grads(m, x, u, lens, beta, use_kernel=True)
    loss2, grads2 = fused_loss_and_grads(m, x, u, lens, beta,
                                         use_kernel=True)
    want_loss, want = fused_loss_and_grads(m, x, u, lens, beta,
                                           use_kernel=False)
    again32 = fused_loss_and_grads(m32, x, u, lens, beta, use_kernel=True)
    torch.cuda.synchronize()
    if not torch.isfinite(loss) or not all(
            torch.isfinite(g).all() for g in grads.values()):
        fail(f"kernel C (bf16) gave a non-finite loss or gradient at {what}")
    rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    if rel > BF16_LOSS_TOL:
        fail(f"kernel C (bf16) loss {float(loss)} vs plain "
             f"{float(want_loss)} (relative {rel:.3e} > {BF16_LOSS_TOL}) at "
             f"{what}")
    share = worst_abs = 0.0
    for name, w in want.items():
        scale = float(w.abs().max())
        err = max_abs(grads[name], w)
        worst_abs = max(worst_abs, err)
        share = max(share, err / scale if scale > 0 else 0.0)
        if err > BF16_GRAD_TOL * scale:
            fail(f"kernel C (bf16) gradient {name} max-abs error {err:.3e} "
                 f"> {BF16_GRAD_TOL} x {scale:.3e} at {what}")
    if not torch.equal(loss, loss2) or not all(
            torch.equal(grads[n], grads2[n]) for n in grads):
        fail(f"kernel C (bf16) is not bit-equal across two calls at {what}")
    if not torch.equal(first32[0], again32[0]) or not all(
            torch.equal(first32[1][n], again32[1][n]) for n in grads):
        fail(f"kernel C's float32 outputs changed after bf16 calls at "
             f"{what}")
    return rel, share, worst_abs, first32[1], grads, want


def phase_kernel_c_bf16(torch, np, model):
    """29a. kernel C's bfloat16 mode (the tensor-core kernels) against its
    plain version at the published widths (64, 200) and (8, 200) ragged
    and at the probe shape, the float32 mode far from it there; at
    BF16_WIDTH_CASES; a second call and the float32 mode's outputs
    bit-equal throughout; then BF16_ORDER_CASES (_bf16_order_case)."""
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads

    dev = model.device
    rng = np.random.default_rng(29)
    probe = probe_model(torch, dev)
    (B0, T0), (B1, T1), (B2, T2) = C_SHAPES
    cases = [(model, B0, T0, 1.0, None), (model, B1, T1, 0.5, 3 * T1 // 4),
             (probe, B2, T2, 1.0, None)]
    cases += [(_seeded_model(torch, dev, 6, **widths), B, T, 0.5, short)
              for B, T, short, widths in BF16_WIDTH_CASES]
    worst_abs = worst_rel = worst_loss = 0.0
    n0 = (fused_loss_and_grads.launches, fused_loss_and_grads.bf16_launches)
    for at, (m32, B, T, beta, short) in enumerate(cases):
        c = m32.cfg
        x, u, lens = train_inputs(torch, np, rng, B, T, c.input_dim,
                                  c.u_dim, dev, short)
        what = (f"B={B} T={T} beta={beta} short={short} widths C={c.input_dim}"
                f" H1={c.hidden_dim} H2={c.hidden_dim2} K={c.K} "
                f"HP={c.trans_hidden}")
        rel, share, err, g32, grads, want = _bf16_case(
            torch, np, m32, x, u, lens, beta, what)
        worst_loss = max(worst_loss, rel)
        worst_rel = max(worst_rel, share)
        worst_abs = max(worst_abs, err)
        gap32 = max(max_abs(g32[n], grads[n]) / float(want[n].abs().max())
                    for n in want if float(want[n].abs().max()) > 0)
        if at < 3 and gap32 < 10 * BF16_GRAD_TOL:
            fail(f"kernel C's float32 gradients are within {gap32:.3e} of "
                 f"its bfloat16 ones at {what}: under 10x the tolerance "
                 f"{BF16_GRAD_TOL}, the test cannot tell the modes apart")
        say("kernel C bf16", f"{what}: loss {rel:.3e} relative, gradients "
            f"within {share:.3e} of a leaf's largest entry (tol "
            f"{BF16_GRAD_TOL}); the float32 mode {gap32:.3e} away; second "
            f"call and the float32 outputs bit-equal")
    orders = [_bf16_order_case(torch, np, rng, dev, *case)
              for case in BF16_ORDER_CASES]
    got = (fused_loss_and_grads.launches - n0[0],
           fused_loss_and_grads.bf16_launches - n0[1])
    want = (4 * len(cases), 2 * len(cases))
    want = tuple(w + len(BF16_ORDER_CASES) * (ORDER_INPUTS + 1)
                 for w in want)
    if got != want:
        fail(f"kernel C launched {got} (all, bf16) for {want[0]} calls, "
             f"{want[1]} of them bf16")
    return worst_abs, worst_rel, worst_loss, orders


def _bf16_order_case(torch, np, rng, dev, B, T, short, widths):
    """One of BF16_ORDER_CASES on ORDER_INPUTS inputs from rng: kernel C's
    bfloat16 mode against its plain version on the card, beside the plain
    versions' own spread on the same inputs (the CPU's compute_loss and
    autograd, and its tiled version, each against the card's plain
    version); fails where the loss misses BF16_LOSS_TOL, a gradient is not
    finite, a second call is not bit-equal, or the kernel's largest
    gradient error, at the worst input or at the median, exceeds the
    larger of BF16_GRAD_TOL and ORDER_MULT times the spread's."""
    from vqvaehmm_tpu_torch.ops.fused_train import (
        fused_loss_and_grads, fused_loss_and_grads_reference,
        fused_loss_and_grads_tiled)

    m = _bf16_model(torch, _seeded_model(torch, dev, 6, **widths))
    cpu = _bf16_model(torch, _seeded_model(torch, "cpu", 6, **widths))
    c = m.cfg
    what = (f"B={B} T={T} short={short} widths C={c.input_dim} "
            f"H1={c.hidden_dim} H2={c.hidden_dim2} K={c.K} "
            f"HP={c.trans_hidden}")

    def share(got, want):
        return max(max_abs(got[n].cpu(), w.cpu()) / float(w.abs().max())
                   for n, w in want.items() if float(w.abs().max()) > 0)

    kern, spread, loss_rel = [], [], 0.0
    for at in range(ORDER_INPUTS):
        x, u, lens = train_inputs(torch, np, rng, B, T, c.input_dim, c.u_dim,
                                  dev, short)
        loss, grads = fused_loss_and_grads(m, x, u, lens, 0.5,
                                           use_kernel=True)
        if at == 0:
            loss2, grads2 = fused_loss_and_grads(m, x, u, lens, 0.5,
                                                 use_kernel=True)
            if not torch.equal(loss, loss2) or not all(
                    torch.equal(grads[n], grads2[n]) for n in grads):
                fail(f"kernel C (bf16) is not bit-equal across two calls "
                     f"at {what}")
        want_loss, want = fused_loss_and_grads(m, x, u, lens, 0.5,
                                               use_kernel=False)
        args = (cpu, x.cpu(), u.cpu(), lens.cpu(), 0.5)
        _, ref = fused_loss_and_grads_reference(*args)
        _, tiled = fused_loss_and_grads_tiled(*args, 16, splits=1)
        torch.cuda.synchronize()
        if not torch.isfinite(loss) or not all(
                torch.isfinite(g).all() for g in grads.values()):
            fail(f"kernel C (bf16) gave a non-finite loss or gradient at "
                 f"{what}")
        rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
        if rel > BF16_LOSS_TOL:
            fail(f"kernel C (bf16) loss {float(loss)} vs plain "
                 f"{float(want_loss)} (relative {rel:.3e} > "
                 f"{BF16_LOSS_TOL}) at {what}, input {at}")
        loss_rel = max(loss_rel, rel)
        kern.append(share(grads, want))
        spread.append(max(share(ref, want), share(tiled, want)))
    res = {"B": B, "T": T, "K": c.K, "hidden": c.hidden_dim,
           "loss_rel_err": loss_rel, "grad_share_err": kern,
           "plain_spread": spread}
    for stat, pick in (("worst", max), ("median", statistics.median)):
        k, p = pick(kern), pick(spread)
        bar = max(BF16_GRAD_TOL, ORDER_MULT * p)
        if k > bar:
            fail(f"kernel C (bf16) gradients {k:.3e} of a leaf's largest "
                 f"entry at the {stat} of {ORDER_INPUTS} inputs, over "
                 f"{bar:.3e} (the larger of {BF16_GRAD_TOL} and "
                 f"{ORDER_MULT} x the plain versions' spread {p:.3e}) at "
                 f"{what}")
    over = sum(k > BF16_GRAD_TOL for k in kern)
    say("kernel C bf16", f"{what}, {ORDER_INPUTS} inputs: loss within "
        f"{loss_rel:.3e} relative; gradients {[f'{k:.2e}' for k in kern]} "
        f"of a leaf's largest entry (worst {max(kern):.3e}, median "
        f"{statistics.median(kern):.3e}, {over} over {BF16_GRAD_TOL}); the "
        f"plain versions' spread {[f'{p:.2e}' for p in spread]} (worst "
        f"{max(spread):.3e}, median {statistics.median(spread):.3e}, "
        f"{sum(p > BF16_GRAD_TOL for p in spread)} over); within "
        f"max({BF16_GRAD_TOL}, {ORDER_MULT} x the spread); second call "
        f"bit-equal")
    return res


def phase_throughput_train(torch, np, tmp):
    """29b. TrainPipeline in the throughput configuration on the card:
    launches, losses, the card against the CPU, a SIGTERM resume."""
    from vqvaehmm_tpu_torch.data.checkpoint import load_metadata
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads
    from vqvaehmm_tpu_torch.ops.gather import gather_epoch
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    logs = []
    cfg = _bf16_cfg(os.path.join(tmp, "gpu"))
    pipe = TrainPipeline(cfg, device="cuda")
    fused_loss_and_grads.launches = 0
    fused_loss_and_grads.bf16_launches = 0
    gather_epoch.launches = 0
    state = pipe.train(log_fn=logs.append)
    torch.cuda.synchronize()
    launches = {"fused_train": fused_loss_and_grads.launches,
                "fused_train_bf16": fused_loss_and_grads.bf16_launches,
                "gather": gather_epoch.launches}
    t = cfg.training
    steps = t.num_epochs * (cfg.data.samples_per_epoch // t.batch_size)
    if not any(m.startswith("input_pipeline=device fused=True")
               for m in logs):
        fail(f"the throughput configuration's log does not show "
             f"input_pipeline=device fused=True: {logs}")
    expected = {"fused_train": steps, "fused_train_bf16": steps,
                "gather": t.num_epochs}
    if launches != expected or state.step != steps:
        fail(f"the throughput configuration launched {launches} in "
             f"{state.step} updates, not {expected} in {steps}")
    hist = pipe.history
    if len(hist) != t.num_epochs or not np.isfinite(hist).all() \
            or not hist[-1] < hist[1]:
        fail(f"throughput configuration epoch losses {hist}: not finite "
             "or not falling once beta is 1 (epochs 2-4)")
    if any(p.dtype != torch.float32 for p in state.model.parameters()):
        fail("the bfloat16 model's parameters are not float32")
    say("throughput", f"TrainPipeline (compute_dtype bfloat16, "
        f"matmul_precision default, fused auto, device input pipeline) on "
        f"the card: {steps} steps, launches {launches}, epoch losses {hist}")

    cpu = TrainPipeline(_bf16_cfg(os.path.join(tmp, "cpu"), fused=True),
                        device="cpu")
    cpu.train(log_fn=None)
    rel = max(abs(a - b) / abs(b) for a, b in zip(hist, cpu.history))
    if rel > BF16_TRAIN_TOL:
        fail(f"throughput configuration: card epoch losses {hist} vs CPU "
             f"{cpu.history}: relative {rel:.3e} > {BF16_TRAIN_TOL}")
    say("throughput", f"the CPU (kernel C's plain bfloat16 version): epoch "
        f"losses {cpu.history}, largest relative difference {rel:.3e} "
        f"(tol {BF16_TRAIN_TOL})")

    rcfg = _bf16_cfg(os.path.join(tmp, "resume"))

    def preempt_at_2(msg):
        if msg.startswith("Epoch 2/"):
            os.kill(os.getpid(), signal.SIGTERM)

    first = TrainPipeline(rcfg, device="cuda")
    part = first.train(log_fn=preempt_at_2)
    meta = load_metadata(os.path.join(tmp, "resume", "vae_hmm_periodic"))
    if not first.preempted or part.step != steps // 2 or not meta \
            or not meta.get("preempted"):
        fail(f"throughput configuration: SIGTERM did not stop training at "
             f"epoch 2 (step {part.step}, metadata {meta})")
    resumed = TrainPipeline(rcfg, device="cuda").train(log_fn=None)
    if resumed.step != steps or not _same_state(
            torch, resumed.model.state_dict(), state.model.state_dict()):
        fail("throughput configuration: the resumed run differs from the "
             "uninterrupted run")
    say("throughput", "SIGTERM at epoch 2 and resume: final parameters "
        "bit-equal to the uninterrupted run")
    return launches, os.path.join(tmp, "gpu", "vae_hmm_trained.npz"), rel


def phase_throughput_serve(torch, np, tmp, npz):
    """29c. the trained bfloat16 archive served over HTTP on the card:
    /infer in four modes and /predict against the CPU; kernels A, 8 and 11
    launch no time, kernel B once a viterbi request."""
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode
    from vqvaehmm_tpu_torch.ops.fused_infer import fused_forward
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused
    from vqvaehmm_tpu_torch.serve.app import InferenceModel
    from vqvaehmm_tpu_torch.serve.httpd import serve

    with open(CONFIG) as f:
        model_section = {**json.load(f)["model"], **BF16_MODEL}
    cfg_path = os.path.join(tmp, "bf16_inference_config.json")
    with open(cfg_path, "w") as f:
        json.dump({"model": model_section, "checkpoint_path": npz}, f)
    cpu = InferenceModel(cfg_path, device="cpu")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    httpd = serve(cfg_path, host="127.0.0.1", port=port, background=True,
                  device="cuda")
    url = f"http://127.0.0.1:{port}"
    rng = np.random.default_rng(31)
    C, U = model_section["input_dim"], model_section["u_dim"]
    reqs = [("/infer", "mean_field", 37), ("/infer", "mean_field", 200),
            ("/infer", "smoothed", 200), ("/infer", "filtered", 200),
            ("/infer", "viterbi", 200), ("/infer", "viterbi", 1500),
            ("/predict", "predict", 200)]
    worst, flips, steps, walls = 0.0, 0, 0, []
    try:
        if not httpd.vqhmm_model.checkpoint_loaded or \
                httpd.vqhmm_model.model.compute_dtype != torch.bfloat16:
            fail("the bfloat16 server did not load the trained archive")
        counters = (fused_forward, fused_encode, fused_evidence,
                    viterbi_fused)
        for c in counters:
            c.launches = 0
        for path, mode, T in reqs:
            x = rng.normal(size=(C, T)).astype(np.float32).tolist()
            u = rng.normal(size=(U, T)).astype(np.float32).tolist()
            payload = {"x": x}
            if mode in ("smoothed", "filtered", "viterbi"):
                payload.update(u=u, mode=mode)
            t0 = time.perf_counter()
            status, got, _ = _request(url + path, payload)
            walls.append((mode, T, 1e3 * (time.perf_counter() - t0)))
            if status != 200:
                fail(f"bfloat16 {path} {mode} T={T}: HTTP {status} {got}")
            want = cpu.predict(x) if mode == "predict" else \
                cpu.infer(x, u=u, mode=mode)
            for key in want:
                if key in ("mode", "states"):
                    continue
                g, w = np.asarray(got[key]), np.asarray(want[key])
                if g.shape != w.shape or not np.isfinite(g).all():
                    fail(f"bfloat16 {mode} {key}: shape {g.shape} or "
                         "non-finite values")
                share = float(np.max(np.abs(g - w)
                                     / np.maximum(np.abs(w), 1.0)))
                worst = max(worst, share)
                if share > BF16_SERVE_TOL:
                    fail(f"bfloat16 {mode} T={T} {key}: card vs CPU "
                         f"{share:.3e} of the value > {BF16_SERVE_TOL}")
            if mode == "viterbi":
                flips += int(np.sum(np.asarray(got["states"])
                                    != np.asarray(want["states"])))
                steps += T
        launched = {c.__name__: c.launches for c in counters}
    finally:
        _stop(httpd)
    if flips > BF16_VITERBI_FLIPS * steps:
        fail(f"bfloat16 viterbi: {flips} of {steps} steps differ between "
             f"the card and the CPU (more than {BF16_VITERBI_FLIPS:.0%})")
    n_vit = sum(mode == "viterbi" for _, mode, _ in reqs)
    if launched != {"fused_forward": 0, "fused_encode": 0,
                    "fused_evidence": 0, "viterbi_fused": n_vit}:
        fail(f"serving the bfloat16 model launched {launched}: kernels A, "
             f"8 and 11 none, kernel B {n_vit}")
    say("throughput", f"the trained bfloat16 archive served over HTTP on "
        f"the card: {len(reqs)} requests, launches {launched}; card vs CPU "
        f"within {worst:.3e} of each value (tol {BF16_SERVE_TOL}), "
        f"{flips} of {steps} Viterbi steps differ; request ms "
        + ", ".join(f"{m} T={T} {w:.3f}" for m, T, w in walls))
    return launched, worst, flips


def phase_throughput_ensemble(torch, np, tmp):
    """29d. a 2-member ensemble of the throughput configuration: kernel C
    (bfloat16 mode) members x steps, kernel D once an epoch."""
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads
    from vqvaehmm_tpu_torch.ops.gather import gather_epoch
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    cfg = _bf16_cfg(os.path.join(tmp, "ensemble"), ensemble_seeds=[0, 1])
    t = cfg.training
    steps = t.num_epochs * (cfg.data.samples_per_epoch // t.batch_size)
    pipe = TrainPipeline(cfg, device="cuda")
    fused_loss_and_grads.launches = 0
    fused_loss_and_grads.bf16_launches = 0
    gather_epoch.launches = 0
    pipe.train(log_fn=None)
    torch.cuda.synchronize()
    launches = {"fused_train": fused_loss_and_grads.launches,
                "fused_train_bf16": fused_loss_and_grads.bf16_launches,
                "gather": gather_epoch.launches}
    expected = {"fused_train": 2 * steps, "fused_train_bf16": 2 * steps,
                "gather": t.num_epochs}
    if launches != expected or not np.isfinite(pipe.history).all():
        fail(f"the bfloat16 ensemble launched {launches}, not {expected}, "
             f"or its best history {pipe.history} is not finite")
    say("throughput", f"a 2-member bfloat16 ensemble, {t.num_epochs} epochs: "
        f"launches {launches}; best member's losses {pipe.history}")
    return launches


def phase_headline(torch, np, B=64, T=200, windows=5):
    """29e. vae_hmm_elbo_train_seqs_per_sec_per_chip as bench.py measures
    it (B=64, T=200, steady fused steps on one batch, the median of 5
    windows with [min, max]), here the saturated repeat-in-call marginal
    of utils/benchmarking.py on CUDA events, float32 and bfloat16 in one
    call, with the device-busy ms a step off a profiler trace.  A record,
    not a claim."""
    from vqvaehmm_tpu_torch.train.trainer import make_optimizer, train_step
    from vqvaehmm_tpu_torch.utils.benchmarking import (
        saturated_marginal_windows)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(B, 5, T)).astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.normal(size=(B, 4, T)).astype(np.float32)).to(dev)
    ln = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    ln[0] = T
    lens = torch.from_numpy(ln).to(dev)
    out = {}
    for tag in ("float32", "bfloat16"):
        m = load_published(torch, dev)
        if tag == "bfloat16":
            m = _bf16_model(torch, m)
        m.train()
        opt = make_optimizer(m, 1e-5, 1.0)

        def make_repeat(R, m=m, opt=opt):
            def run():
                for _ in range(R):
                    train_step(m, opt, x, u, lens, 1.0, fused=True)
            return run

        med, lo, hi, R = saturated_marginal_windows(
            make_repeat, est_us=1500.0, floor_ms=50.0, windows=windows,
            trials=3)
        busy, ops = _device_trace(torch, make_repeat(1), calls=20)
        out[tag] = {"seqs_per_s": B * 1e6 / med,
                    "seqs_per_s_min": B * 1e6 / hi,
                    "seqs_per_s_max": B * 1e6 / lo,
                    "step_us": med, "R": R, "device_ms": busy,
                    "device_ops": ops}
        say("headline", f"vae_hmm_elbo_train_seqs_per_sec_per_chip, {tag}: "
            f"{out[tag]['seqs_per_s']:.1f} seqs/s "
            f"[{out[tag]['seqs_per_s_min']:.1f}, "
            f"{out[tag]['seqs_per_s_max']:.1f}] at B={B} T={T} (a step "
            f"{med:.2f} us, median of {windows} windows [{lo:.2f}, "
            f"{hi:.2f}], R={R}); device "
            f"busy {_ms(busy)} a step in "
            f"{'not measured' if ops is None else f'{ops:.1f}'} device ops")
    return out


# ---------------------------------------------------------------------------
# Phases 30-31: the whole published recipe, and the rest of the zoo
# ---------------------------------------------------------------------------

# every file scripts/full_recipe.py writes under its outdir (the PNGs only
# where matplotlib is present)
RECIPE_FILES = (
    "data/x_sequences.npy", "data/u_sequences.npy", "data/z_windows.npy",
    "data/x_panel.npy", "data/u_panel.npy", "data/z_panel.npy",
    "data/returns.csv", "data/prices.csv",
    "config_published.json", "config_quality.json", "config_vq.json",
    "checkpoints_published/vae_hmm.pt",
    "checkpoints_published/vae_hmm_trained.npz",
    "checkpoints_quality/vae_hmm.pt",
    "checkpoints_quality/vae_hmm_trained.npz",
    "checkpoints_vq/vq_stack.npz",
    "train_history_published.json", "train_history_quality.json",
    "quality_fixture.json", "quality_fixture_published.json",
    "vq_quality_fixture.json", "eval_results_published.txt",
    "eval_results_quality.txt", "portfolio_head.npz", "head_history.json",
    "backtest_metrics.json", "walkforward_metrics.json",
    "monte_carlo_stats.json", "stage_log.json", "RECIPE_REPORT.md")
RECIPE_PLOTS = ("loss_curve_published.png", "loss_curve_quality.png",
                "backtest_results.png", "monte_carlo_results.png")
RECIPE_MATCH_EPOCHS = 4     # the quality run's epochs held to the CPU's
RECIPE_TOL = 1e-5           # relative, floor 1 (the losses cross zero)
RECIPE_NUDGE = 1e-7         # relative, about one float32 rounding
ZOO_TOL = 1e-5
ZOO_RUN_TOL = 1e-4          # 20 online updates, 3 walk-forward windows


def launch_counters():
    """name (the kernels line's) -> the wrapper whose `.launches` counts
    that kernel's launches."""
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode
    from vqvaehmm_tpu_torch.ops.fused_infer import fused_forward
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused
    from vqvaehmm_tpu_torch.ops.gather import gather_epoch
    from vqvaehmm_tpu_torch.ops.vq import (quantize_st_fused_backward,
                                           quantize_st_fused_forward,
                                           vq_nearest)

    return {"fused_infer": fused_forward, "viterbi": viterbi_fused,
            "fused_train": fused_loss_and_grads, "gather": gather_epoch,
            "fused_encode": fused_encode, "fused_evidence": fused_evidence,
            "fused_decode": fused_viterbi_states, "vq_nearest": vq_nearest,
            "quantize_forward": quantize_st_fused_forward,
            "quantize_backward": quantize_st_fused_backward}


def _quiet(fn, *args):
    """fn(*args) with its output kept back; on a failure its last 4000
    characters are printed before the error goes on."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args)
    except BaseException:
        print(buf.getvalue()[-4000:], flush=True)
        raise


def _recipe_expected(np, recipe, out, counters):
    """Each stage's launches of each kernel as the code implies them for
    this run: a training step is one kernel-C launch and an epoch one
    kernel-D launch; the quality stage's decodes are one kernel-8 launch
    (the mean-field posterior), and for each of the two checkpoints one
    kernel-11 launch for the smoothed posterior and one each of kernels 11
    and B for the Viterbi path; a VQ step is one quantizer launch each
    way, an epoch (polish epochs included) one gather, and the nearest
    code runs once a panel pass of the trainer (one, and one more a
    polish epoch) and once for each of the stage's codes, smoothed and
    Viterbi decodes, which last is one kernel-B launch; the eval stage is
    one kernel-A launch a batch of 32, 4 batches a checkpoint; the
    downstream stages as phases 24-25 count them."""
    from vqvaehmm_tpu_torch.train.vq_pipeline import VQStack

    def steps(cfg):
        return cfg.training.num_epochs * (cfg.data.samples_per_epoch
                                          // cfg.training.batch_size)

    pub, qual = recipe.recipe_config(out), recipe.recipe_config(out, True)
    vq = recipe.vq_config(out)
    hist = VQStack.load(os.path.join(out, "checkpoints_vq", "vq_stack.npz"),
                        device="cpu").history
    polish = len(hist) - vq.training.num_epochs
    vq_steps = len(hist) * (vq.data.samples_per_epoch
                            // vq.training.batch_size)
    with open(os.path.join(out, "walkforward_metrics.json")) as f:
        wf = json.load(f)
    n_win = wf["walk_forward"]["n_windows"]
    per_regime = sum(r["n_periods"] > 21 for mode in wf["per_regime"].values()
                     for r in mode.values())
    zero = {**dict.fromkeys(counters, 0), "fused_train_bf16": 0}
    exp = {
        "data": {},
        "train": {"fused_train": steps(pub),
                  "gather": pub.training.num_epochs},
        "quality": {"fused_train": steps(qual),
                    "gather": qual.training.num_epochs, "fused_encode": 1,
                    "fused_evidence": 4, "viterbi": 2},
        "vq": {"quantize_forward": vq_steps, "quantize_backward": vq_steps,
               "gather": len(hist), "vq_nearest": 1 + polish + 3,
               "viterbi": 1},
        "eval": {"fused_infer": 2 * 4},
        "head": {"fused_encode": len(recipe.head_batches(out)[0])},
        "backtest": {"fused_encode": 2},
        "walkforward": {"fused_encode": 2 * n_win + 1 + per_regime,
                        "fused_evidence": 2, "viterbi": 1},
        "montecarlo": {"fused_evidence": 1, "viterbi": 1},
        "report": {},
    }
    return {s: {**zero, **e} for s, e in exp.items()}, polish


class _StopAfter(Exception):
    """Raised by a TrainPipeline log_fn to end a run at an epoch."""


def _recipe_epochs(torch, np, recipe, out, tmp, epochs):
    """The recipe's first `epochs` epochs on the CPU with the plain
    versions on the card's index stream (TrainPipeline with the device
    sampler), from its configurations on the data in `out`:
    - the published run, free from the seed's draw;
    - the quality run epoch by epoch: the card trains `epochs` epochs with
      a checkpoint after each, the CPU then each epoch once from the
      card's state before it, and from epoch 2 on once more from that
      state with every weight times (1 + RECIPE_NUDGE * N(0, 1)), about
      one float32 rounding: how far one rounding carries in that epoch.
    Returns (the published CPU losses, the card's quality losses, the
    CPU's, the nudged CPU's with None for epoch 1)."""
    from dataclasses import replace

    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    def cfg(name, quality=True, **training):
        c = recipe.recipe_config(out, quality=quality)
        return replace(c, training=replace(
            c.training, checkpoint_dir=os.path.join(tmp, name),
            input_pipeline="device", **training))

    def run(pipe, last, on_log=None):
        """pipe.train to the end of epoch `last`; its epoch losses."""
        def log(msg):
            if on_log:
                on_log(msg)
            if msg.startswith(f"Epoch {last}/"):
                raise _StopAfter
        try:
            _quiet(pipe.train, log)
        except _StopAfter:
            pass
        return pipe.history

    published = run(TrainPipeline(cfg("published_cpu", quality=False),
                                  device="cpu"), epochs)
    card_dir = os.path.join(tmp, "epochs_card")

    def keep(msg):
        # at "Epoch k" the periodic checkpoint still holds epoch k - 1
        if msg.startswith("Epoch ") and not msg.startswith("Epoch 1/"):
            k = int(msg.split()[1].split("/")[0]) - 1
            for ext in (".pt", ".meta.json"):
                shutil.copyfile(
                    os.path.join(card_dir, "vae_hmm_periodic" + ext),
                    os.path.join(tmp, f"epoch_{k}{ext}"))

    card = run(TrainPipeline(cfg("epochs_card", save_freq=1), device="cuda"),
               epochs, keep)

    def from_card(e, nudge):
        """The CPU's epoch e + 1 from the card's state after epoch e."""
        pipe = TrainPipeline(cfg(f"epochs_cpu_{e}_{nudge}"), device="cpu")
        if e:
            dst = os.path.join(pipe.cfg.training.checkpoint_dir,
                               "vae_hmm_periodic")
            os.makedirs(os.path.dirname(dst))
            shutil.copyfile(os.path.join(tmp, f"epoch_{e}.meta.json"),
                            dst + ".meta.json")
            blob = torch.load(os.path.join(tmp, f"epoch_{e}.pt"),
                              map_location="cpu", weights_only=True)
            g = torch.Generator().manual_seed(0)
            for k, v in blob["model"].items():
                blob["model"][k] = v * (1 + nudge * torch.randn(
                    v.shape, generator=g))
            torch.save(blob, dst + ".pt")
        return run(pipe, e + 1)[0]

    cpu = [from_card(e, 0.0) for e in range(epochs)]
    nudged = [None] + [from_card(e, RECIPE_NUDGE) for e in range(1, epochs)]
    return published, card, cpu, nudged


def phase_recipe(torch, np, tmp, kind):
    """30. the whole published recipe through its entry point, stage by
    stage, on the card and then on the CPU."""
    from importlib.util import find_spec

    from dataclasses import replace

    from vqvaehmm_tpu_torch import recipe
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline
    from vqvaehmm_tpu_torch.train.trainer import beta_schedule

    counters = launch_counters()
    out = {d: os.path.join(tmp, d) for d in ("cuda", "cpu")}
    walls, launches = {}, {}
    for d in ("cuda", "cpu"):
        for s in recipe.STAGES:
            argv = ["--stage", s, "--device", d, "--outdir", out[d],
                    "--checkpoint-dir",
                    os.path.join(out[d], "checkpoints_quality")]
            for f in counters.values():
                f.launches = 0
            bf16 = counters["fused_train"]
            bf16.bf16_launches = 0
            rc, walls[(s, d)] = _timed(torch, _quiet, recipe.main, argv)
            if d == "cuda":
                launches[s] = {k: f.launches for k, f in counters.items()}
                launches[s]["fused_train_bf16"] = bf16.bf16_launches
            if rc != 0:
                fail(f"the recipe's {s} stage on {d} exited {rc}")
    expected, polish = _recipe_expected(np, recipe, out["cuda"], counters)
    for s in recipe.STAGES:
        if launches[s] != expected[s]:
            fail(f"the recipe's {s} stage launched {launches[s]}; the code "
                 f"implies {expected[s]}")
    wanted = RECIPE_FILES + (RECIPE_PLOTS if find_spec("matplotlib")
                             else ())
    missing = [f for f in wanted
               if not os.path.exists(os.path.join(out["cuda"], f))]
    if missing:
        fail(f"the recipe on the card did not write {missing}")
    say("recipe", f"python -m vqvaehmm_tpu_torch.recipe, ten stages on the "
        f"card and on this machine's CPU, wall s (card / CPU): " + ", ".join(
            f"{s} {walls[(s, 'cuda')]:.3f} / {walls[(s, 'cpu')]:.3f}"
            for s in recipe.STAGES)
        + f"; total {sum(walls[(s, 'cuda')] for s in recipe.STAGES):.3f} / "
        f"{sum(walls[(s, 'cpu')] for s in recipe.STAGES):.3f}")
    say("recipe", "launches a stage on the card, exact as the code implies "
        f"them (VQ polish epochs {polish}): " + "; ".join(
            f"{s} " + ", ".join(f"{k} {v}" for k, v in launches[s].items()
                                if v) for s in recipe.STAGES
            if any(launches[s].values())))

    def hist(d, tag):
        with open(os.path.join(out[d], f"train_history_{tag}.json")) as f:
            return json.load(f)["loss"]

    falls = {}
    for tag in ("published", "quality"):
        h = hist("cuda", tag)
        first = next(e for e in range(len(h))
                     if beta_schedule(e, len(h)) >= 1.0)
        if not np.isfinite(h).all() or not h[-1] < h[first]:
            fail(f"{tag} training on the card: losses {h[:3]}... "
                 f"{h[-3:]}, not finite or not falling from epoch "
                 f"{first + 1} (beta 1) on")
        falls[tag] = (first + 1, h[first], h[-1])
    # the CPU with the plain versions on the card's index stream: the
    # published run's first epochs (lr 1e-5) free, the quality run's
    # (lr 1e-3) epoch by epoch from the card's state, since at lr 1e-3 one
    # rounding of the weights moves an epoch by up to some 1e-4 (the
    # nudged runs): a record from epoch 2 on, not a check
    p_cpu, e_card, e_cpu, e_nudged = _recipe_epochs(
        torch, np, recipe, out["cuda"], os.path.join(tmp, "epochs"),
        RECIPE_MATCH_EPOCHS)

    def rel(got, want):
        return [abs(a - b) / max(abs(b), 1.0) for a, b in zip(got, want)]

    p_gaps = rel(hist("cuda", "published")[:RECIPE_MATCH_EPOCHS], p_cpu)
    e_gaps = rel(e_card, e_cpu)
    spread = rel(e_nudged[1:], e_cpu[1:])
    if len(p_gaps) != RECIPE_MATCH_EPOCHS or max(p_gaps) > RECIPE_TOL or \
            e_gaps[0] > RECIPE_TOL:
        fail(f"card against CPU: the published run's first "
             f"{RECIPE_MATCH_EPOCHS} epochs {p_gaps}, the quality run's "
             f"first {e_gaps[0]:.3e} (bar {RECIPE_TOL})")
    # the same quality run free on the CPU, on the card's index stream
    # (the device sampler's; the CPU recipe run above samples on the host)
    qcfg = recipe.recipe_config(out["cpu"], quality=True)
    qcfg = replace(qcfg, training=replace(
        qcfg.training, input_pipeline="device",
        checkpoint_dir=os.path.join(tmp, "cpu_device_stream")))
    same = TrainPipeline(qcfg, device="cpu")
    _quiet(same.train)
    card, cpu = hist("cuda", "quality"), same.history
    if card[:RECIPE_MATCH_EPOCHS] != e_card:
        fail(f"the quality run's epochs {card[:RECIPE_MATCH_EPOCHS]} on the "
             f"card are not those of its rerun {e_card}")
    gaps = rel(card, cpu)
    with open(os.path.join(out["cuda"], "RECIPE_REPORT.md")) as f:
        report = f.read()
    if kind not in report or "TPU" in report:
        fail("RECIPE_REPORT.md does not name the card or names a TPU")
    say("recipe", f"every file the JAX recipe writes is there "
        f"({len(wanted)}); the losses finite and falling from beta 1: "
        + ", ".join(f"{t} epoch {e} {a:.4f} -> {b:.4f}"
                    for t, (e, a, b) in falls.items())
        + f"; card against CPU, relative (floor 1; bar {RECIPE_TOL:g}): "
        f"the published run's epochs 1-{RECIPE_MATCH_EPOCHS} "
        + ", ".join(f"{g:.3e}" for g in p_gaps)
        + f"; the quality run's epoch 1 {e_gaps[0]:.3e}, and epochs 2-"
        f"{RECIPE_MATCH_EPOCHS} each from the card's state before it (a "
        f"record) " + ", ".join(f"{g:.3e}" for g in e_gaps[1:])
        + f", where the CPU's own epoch from weights nudged by "
        f"{RECIPE_NUDGE:g} moves " + ", ".join(f"{g:.3e}" for g in spread)
        + "; free quality runs on the same "
        f"index stream (a record: the run is chaotic), card against CPU "
        + ", ".join(f"{g:.3e}" for g in gaps[:RECIPE_MATCH_EPOCHS])
        + f" in epochs 1-{RECIPE_MATCH_EPOCHS}, {max(gaps):.3e} at most of "
        f"{len(gaps)}, final loss {card[-1]:.6f} / {cpu[-1]:.6f}; "
        f"RECIPE_REPORT.md names {kind!r} and no TPU")
    for name in ("quality_fixture.json", "vq_quality_fixture.json"):
        rows = []
        for where in (out["cuda"], out["cpu"], os.path.join(ROOT,
                                                           "artifacts")):
            with open(os.path.join(where, name)) as f:
                rows.append(json.load(f))
        say("recipe", f"{name} (a record, not a check): card {rows[0]}; "
            f"CPU {rows[1]}; committed JAX artifact {rows[2]}")
    return launches, walls


def _zoo_cases(torch, np, K, A, H):
    """name -> make(device): the six heads and five regime models at the
    recipe's widths (K=3, 10 assets, hidden 64), each drawn from a
    Generator seeded by its index, so both devices get the same weights."""
    from vqvaehmm_tpu_torch.models import portfolio as P
    from vqvaehmm_tpu_torch.models import regime as R

    cfg = P.HeadConfig(K=K, n_assets=A, hidden_dim=H)
    heads = ("AttentionPortfolioOptimizer", "TransformerPortfolioOptimizer",
             "BayesianPortfolioOptimizer", "EnsemblePortfolioOptimizer",
             "HierarchicalPortfolioOptimizer", "RegimeLSTMOptimizer")
    regime = {"RegimeChangeDetector": (K, H),
              "ForwardTransitionPredictor": (K, 5, H),
              "RegimePersistenceModel": (K, 32),
              "TemperatureScaling": None,
              "RegimeFactorModel": (K, A)}

    def make(name, i):
        def build(d):
            g = torch.Generator().manual_seed(300 + i)
            if name in heads:
                return getattr(P, name)(cfg, device=d, generator=g)
            if regime[name] is None:
                return R.TemperatureScaling(device=d)
            return getattr(R, name)(*regime[name], device=d, generator=g)
        return build

    return {n: make(n, i) for i, n in enumerate(heads + tuple(regime))}


def phase_zoo(torch, np, tmp, dev="cuda"):
    """31. the rest of the downstream zoo on the card against the CPU, on
    kernel-8 posteriors of the fixture windows."""
    from vqvaehmm_tpu_torch import recipe
    from vqvaehmm_tpu_torch.calibration import calibrate_regime_thresholds
    from vqvaehmm_tpu_torch.losses.portfolio import sharpe_loss
    from vqvaehmm_tpu_torch.models.portfolio import (
        HeadConfig, HierarchicalPortfolioOptimizer, RegimeLSTMOptimizer,
        TransformerPortfolioOptimizer)
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode
    from vqvaehmm_tpu_torch.serve.app import get_model
    from vqvaehmm_tpu_torch.serve.gradio_app import (make_infer_fn,
                                                     parse_market_text)
    from vqvaehmm_tpu_torch.train.strategies import (
        MetaPortfolioOptimizer, OnlinePortfolioOptimizer, WalkForwardTrainer)
    from vqvaehmm_tpu_torch.train.trainer import ClippedAdam

    dev, cpu = torch.device(dev), torch.device("cpu")
    pair = (("card", dev), ("cpu", cpu))
    out = os.path.join(tmp, "zoo")
    _quiet(recipe.stage_data, out)
    x = np.load(os.path.join(out, "data", "x_sequences.npy"))
    z = np.load(os.path.join(out, "data", "z_windows.npy"))
    model = recipe.load_trained(dev)
    fused_encode.launches = 0
    with torch.inference_mode():
        q_card = model.posterior(torch.from_numpy(x).to(dev))
    if fused_encode.launches != 1:
        fail(f"the zoo's posteriors launched kernel 8 "
             f"{fused_encode.launches} times, not once")
    q = q_card.cpu().clone()                      # (N, K, T), both devices
    N, K, T = q.shape
    A, H = 10, 64
    rng = np.random.default_rng(31)
    rets = torch.from_numpy(rng.normal(5e-4, 0.01, size=(N, 20, A))
                            .astype(np.float32))
    A_mat = torch.from_numpy(rng.dirichlet(np.ones(K), size=K)
                             .astype(np.float32))
    labels = torch.from_numpy(z[:, -1].astype(np.int64))
    eps = torch.randn((10, N, H), generator=torch.Generator().manual_seed(7))

    def run(name, m, d):
        """(the model's output, a scalar loss of it) on device d."""
        qd = q.to(d)
        if name == "RegimePersistenceModel":
            y = m(qd, A_mat.to(d))
        elif name == "TemperatureScaling":
            y = m(torch.log(qd[:, :, -1]))
            return y, torch.nn.functional.cross_entropy(y, labels.to(d))
        elif name == "RegimeFactorModel":
            y = m.get_covariance(qd)
        elif name == "BayesianPortfolioOptimizer":
            y = m(qd, eps=eps.to(d))
        else:
            y = m(qd)
        if y.shape == (N, A) and y.dtype == torch.float32:
            return y, sharpe_loss(y, rets.to(d))
        return y, (y * y).mean()

    gaps, step_gaps = {}, {}
    for name, make in _zoo_cases(torch, np, K, A, H).items():
        res = {}
        for key, d in pair:
            m = make(d).eval()
            with torch.no_grad():
                y_eval = run(name, m, d)[0]
            m.train()
            opt = ClippedAdam(m.parameters(), 1e-3)
            y, loss = run(name, m, d)
            loss.backward()
            grads = {k: torch.zeros_like(p).cpu() if p.grad is None
                     else p.grad.detach().cpu().clone()
                     for k, p in m.named_parameters()}
            opt.update()
            res[key] = (y_eval.detach().cpu(), float(loss.detach()), grads,
                           {k: p.detach().cpu()
                            for k, p in m.named_parameters()})
        (yc, lc, gc, pc), (yh, lh, gh, ph) = res["card"], res["cpu"]
        gap = max([max_abs(yc, yh), abs(lc - lh) / max(abs(lh), 1.0)]
                  + [max_abs(gc[k], gh[k]) for k in gh])
        # Adam's first step is lr * g / (|g| + 1e-8): where a gradient is
        # rounding noise (one that is zero in exact arithmetic, as that of
        # attention's key bias) its sign is the noise's, so the step is
        # held only where |g| >= 1e-6 and its largest gap printed
        step = max(float(((pc[k] - ph[k]).abs() * (gh[k].abs() >= 1e-6))
                         .max()) for k in ph)
        if not torch.isfinite(yc).all() or max(gap, step) > ZOO_TOL:
            fail(f"{name} on the card against the CPU: output, loss and "
                 f"gradients {gap:.3e}, the Adam step {step:.3e} "
                 f"(bar {ZOO_TOL})")
        gaps[name] = gap
        step_gaps[name] = max(max_abs(pc[k], ph[k]) for k in ph)

    cfg = HeadConfig(K=K, n_assets=A, hidden_dim=H)

    def head(d, cls=HierarchicalPortfolioOptimizer, seed=41):
        return cls(cfg, device=d, generator=torch.Generator()
                   .manual_seed(seed)).eval()

    def same(a, b):
        return max(max_abs(p.detach().cpu(), r.detach().cpu())
                   for p, r in zip(a.parameters(), b.parameters()))

    qs = q[:, :, -1].contiguous()
    runs = {}
    # 20 online updates
    hd = {k: head(d) for k, d in pair}
    opts = {k: OnlinePortfolioOptimizer(m, lr=1e-3) for k, m in hd.items()}
    losses = {k: [o.update(qs[i::20], rets[i::20]) for i in range(20)]
              for k, o in opts.items()}
    runs["online"] = max([same(hd["card"], hd["cpu"])]
                         + [abs(a - b) / max(abs(b), 1.0) for a, b in
                            zip(losses["card"], losses["cpu"])])
    # three walk-forward windows
    hd = {k: head(d, seed=42) for k, d in pair}
    wf = {k: WalkForwardTrainer(m, sharpe_loss, train_window=48,
                                test_window=16, retrain_freq=16).run(
              (qs, rets), n_periods=3) for k, m in hd.items()}
    runs["walk_forward"] = max([same(hd["card"], hd["cpu"])] + [
        abs(g[k] - w[k]) / max(abs(w[k]), 1.0)
        for g, w in zip(wf["card"], wf["cpu"]) for k in w])
    # MAML on an MLP head: adapt, and two second-order meta steps
    tasks = [((qs[i:i + 16], rets[i:i + 16]),
              (qs[i + 16:i + 32], rets[i + 16:i + 32])) for i in (0, 40)]
    hd = {k: head(d, seed=43) for k, d in pair}
    meta = {k: MetaPortfolioOptimizer(m, inner_lr=0.05, outer_lr=0.01,
                                      n_inner=3) for k, m in hd.items()}
    ml = {k: [mo.meta_update(tasks, sharpe_loss) for _ in range(2)]
          for k, mo in meta.items()}
    runs["maml"] = max([same(hd["card"], hd["cpu"])] + [
        abs(a - b) / max(abs(b), 1.0) for a, b in zip(ml["card"],
                                                      ml["cpu"])])
    # the LSTM head: cuDNN's RNN backward is not differentiable; the meta
    # step on the card runs torch's own CUDA LSTM cell instead
    lstm = head(dev, RegimeLSTMOptimizer, 44).train()
    try:
        with torch.backends.cudnn.flags(enabled=True):
            loss = sharpe_loss(lstm(q[:16].to(dev)), rets[:16].to(dev))
            g = torch.autograd.grad(loss, list(lstm.parameters()),
                                    create_graph=True)
            torch.autograd.grad(sum(gi.sum() for gi in g),
                                list(lstm.parameters()))
        cudnn_double = "cuDNN's LSTM took a double backward"
    except RuntimeError as e:
        cudnn_double = f"cuDNN's LSTM refuses a double backward ({e})"[:200]
    hd = {k: head(d, RegimeLSTMOptimizer, 45) for k, d in pair}
    seq_tasks = [((q[i:i + 16], rets[i:i + 16]),
                  (q[i + 16:i + 32], rets[i + 16:i + 32])) for i in (0, 40)]
    ml = {k: MetaPortfolioOptimizer(m, inner_lr=0.05, outer_lr=0.01,
                                    n_inner=2).meta_update(seq_tasks,
                                                           sharpe_loss)
          for k, m in hd.items()}
    runs["maml_lstm"] = max(same(hd["card"], hd["cpu"]),
                            abs(ml["card"] - ml["cpu"])
                            / max(abs(ml["cpu"]), 1.0))
    for k, v in runs.items():
        if not np.isfinite(v) or v > ZOO_RUN_TOL:
            fail(f"the strategies on the card against the CPU: {runs} "
                 f"({k} > {ZOO_RUN_TOL})")

    # calibrate_regime_thresholds on kernel 8
    true = np.array([np.bincount(r, minlength=K).argmax() for r in z])
    fused_encode.launches = 0
    with torch.inference_mode():
        th_card = calibrate_regime_thresholds(
            model.posterior, torch.from_numpy(x).to(dev), true, K)
    cal_launches = fused_encode.launches
    with torch.inference_mode():
        th_cpu = calibrate_regime_thresholds(
            recipe.load_trained(cpu).posterior, torch.from_numpy(x), true, K)
    th_gap = max(abs(th_card[k] - th_cpu[k]) for k in th_cpu)
    if cal_launches != 1 or sorted(th_card) != sorted(th_cpu) or \
            th_gap > 1e-5:
        fail(f"calibrate_regime_thresholds: kernel 8 {cal_launches} "
             f"launches, thresholds {th_card} against the CPU's {th_cpu}")

    # the Gradio demo with no head checkpoint builds the transformer head
    cfg_path = _serving_config(tmp, "gradio.json")
    get_model.cache_clear()
    try:
        infer = make_infer_fn(cfg_path, device=dev)
        text = "\n".join(" ".join(f"{v:.4f}" for v in row)
                         for row in x[0][:, :40])
        fused_encode.launches = 0
        _, _, alloc = infer(text)
        demo_launches = fused_encode.launches
        want = TransformerPortfolioOptimizer(
            HeadConfig(K=3, n_assets=10, hidden_dim=64), device=dev,
            generator=torch.Generator().manual_seed(0)).eval()
        m = get_model(cfg_path, dev)
        with torch.inference_mode():
            w = want(m.model.posterior(torch.from_numpy(
                parse_market_text(text)).to(dev)))[0].cpu().numpy()
        if list(alloc.values()) != [f"{v * 100:.2f}%" for v in w] or \
                demo_launches != 1:
            fail(f"the Gradio demo's allocation {alloc} is not the seeded "
                 f"transformer head's {w} ({demo_launches} kernel-8 "
                 "launches)")
    finally:
        get_model.cache_clear()
    say("zoo", f"kernel-8 posteriors of {N} fixture windows (T={T}); the "
        f"six heads and five regime models, card against CPU (bar "
        f"{ZOO_TOL:g}), output, loss and gradients / the parameters after "
        f"one Adam step at lr 1e-3 (all of them): " + ", ".join(
            f"{k} {v:.3e} / {step_gaps[k]:.3e}" for k, v in gaps.items()))
    say("zoo", f"strategies, card against CPU (bar {ZOO_RUN_TOL:g}): "
        f"20 online updates {runs['online']:.3e}, walk-forward 3 windows "
        f"{runs['walk_forward']:.3e}, MAML on the hierarchical head 2 meta "
        f"steps {runs['maml']:.3e}, on the LSTM head (cuDNN off for the "
        f"meta step) {runs['maml_lstm']:.3e}; {cudnn_double}")
    say("zoo", f"calibrate_regime_thresholds(VAEHMM.posterior): kernel 8 "
        f"{cal_launches} launch, thresholds {th_card} against the CPU's "
        f"{th_cpu} ({th_gap:.3e}); the Gradio demo with no head checkpoint "
        f"serves the seeded TransformerPortfolioOptimizer's allocation "
        f"({demo_launches} kernel-8 launch)")
    return {"heads": gaps, "strategies": runs, "cudnn_double": cudnn_double,
            "calibrate_launches": cal_launches}


# phase 32's bars (float32; the bfloat16 mode is held to BF16_LOSS_TOL and
# BF16_GRAD_TOL) and its short half; phase 33's
DP_LOSS_TOL, DP_GRAD_TOL, DP_SHORT = 1e-5, 1e-5, 150
DP_EPOCH_TOL, DP_RESUME_TOL, DP_HMM_TOL = 1e-4, 1e-5, 1e-4   # HMM: relative
DP_STEPS = 10


def phase_kernel_c_dp(torch, np, model):
    """32. kernel C's global-normalisation mode on two halves against one
    whole-batch call (the module docstring); returns {mode: gaps}."""
    from vqvaehmm_tpu_torch.ops.fused_train import (
        PARAM_NAMES, fused_loss_and_flat_grads, global_norm, split_grads)

    dev = model.device
    B, T = C_SHAPES[0]
    x, u, lens = train_inputs(torch, np, np.random.default_rng(32), B, T,
                              model.cfg.input_dim, model.cfg.u_dim, dev)
    lens[B // 2:] = lens[B // 2:].clamp(max=T - DP_SHORT)
    halves = (slice(0, B // 2), slice(B // 2, B))
    norm = global_norm(lens, T)
    if int(lens[halves[1]].max()) >= norm[0]:
        fail(f"phase 32's second half reaches the global valid_to {norm}")
    out = {}
    for mode, m, loss_tol, grad_tol, plain_tol in (
            ("float32", model, DP_LOSS_TOL, DP_GRAD_TOL, (1e-5, 1e-4)),
            ("bfloat16", _bf16_model(torch, model), BF16_LOSS_TOL,
             BF16_GRAD_TOL, (BF16_LOSS_TOL, BF16_GRAD_TOL))):
        def call(rows, nm, use_kernel=True):
            return fused_loss_and_flat_grads(m, x[rows], u[rows], lens[rows],
                                             0.7, use_kernel=use_kernel,
                                             norm=nm)

        whole_loss, whole = call(slice(None), None)
        own_loss, own = call(slice(None), norm)
        parts = [call(h, norm) for h in halves]
        local = [call(h, (int(lens[h].max()), *norm[1:])) for h in halves]
        plain = [call(h, norm, use_kernel=False) for h in halves]
        torch.cuda.synchronize()
        if not (torch.equal(whole_loss, own_loss) and torch.equal(whole, own)):
            fail(f"kernel C ({mode}) given the batch's own norm is not "
                 "bit-equal to its sentinel call")
        params = dict(m.named_parameters())
        want = split_grads(params, whole)

        def gaps(loss, flat, ref_loss, ref):
            rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
            got = split_grads(params, flat)
            share = max(max_abs(got[n], ref[n]) / float(ref[n].abs().max())
                        for n in PARAM_NAMES if float(ref[n].abs().max()))
            return rel, share

        rel, share = gaps(parts[0][0] + parts[1][0], parts[0][1] + parts[1][1],
                          whole_loss, want)
        if rel > loss_tol or share > grad_tol:
            fail(f"kernel C ({mode}): two half-batch calls summed part from "
                 f"the whole batch by {rel:.3e} relative in the loss (tol "
                 f"{loss_tol}) and {share:.3e} of a gradient's largest "
                 f"magnitude (tol {grad_tol})")
        worst_plain = (0.0, 0.0)
        for (kl, kf), (pl, pf) in zip(parts, plain):
            pg = gaps(kl, kf, pl, split_grads(params, pf))
            worst_plain = tuple(map(max, worst_plain, pg))
            if pg[0] > plain_tol[0] or pg[1] > plain_tol[1]:
                fail(f"kernel C ({mode}) in the global-normalisation mode "
                     f"parts from its plain version by {pg} (tol "
                     f"{plain_tol})")
        _, local_share = gaps(local[0][0] + local[1][0],
                              local[0][1] + local[1][1], whole_loss, want)
        out[mode] = {"sum_loss_rel": rel, "sum_grad_share": share,
                     "plain_loss_rel": worst_plain[0],
                     "plain_grad_share": worst_plain[1],
                     "local_valid_to_grad_share": local_share}
        say("kernel C dp", f"{mode}: two halves (longest rows {T} and "
            f"{int(lens[halves[1]].max())}) with the global norm {norm} "
            f"summed: loss {rel:.3e} relative (tol {loss_tol}), gradients "
            f"within {share:.3e} of a tensor's largest magnitude (tol "
            f"{grad_tol}); against the plain version {worst_plain[0]:.3e} /"
            f" {worst_plain[1]:.3e}; the sentinel call bit-equal to the "
            f"batch's own norm; each half's own valid_to parts by "
            f"{local_share:.3e}")
    return out


def _rel_gap(got, want) -> float:
    """max |got - want| / max(1, |want|): log_alpha grows to some 1.5
    nats a step, so at T = 2000 one float32 rounding of it is above 1e-4
    absolute."""
    return float(((got.double() - want.double()).abs()
                  / want.double().abs().clamp(min=1.0)).max())


def _np_params(model):
    return {n: p.detach().cpu().numpy().copy()
            for n, p in model.named_parameters()}


def _busy_ms(torch, fn, calls):
    """Device-busy ms a call of fn() off one profiler trace of `calls`
    calls (one pass: a rank of a world retraces nothing alone, which
    would leave its peer in a collective)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [(e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    return _busy_us(ops) / 1e3 / calls if ops else None


def dp_rank(mesh, tmp, dev):
    """Phase 33(b) on one rank of a world of two sharing the card: the
    checks' raw results, to be held against each other and the one-process
    runs by phase_dp_train."""
    import torch
    import torch.distributed as dist

    import numpy as np
    from vqvaehmm_tpu_torch.ops import hmm as hmm_ops
    from vqvaehmm_tpu_torch.ops.fused_infer import fused_forward
    from vqvaehmm_tpu_torch.ops.fused_train import (PARAM_NAMES,
                                                    fused_loss_and_grads,
                                                    global_norm)
    from vqvaehmm_tpu_torch.ops.gather import gather_epoch
    from vqvaehmm_tpu_torch.parallel import create_mesh, forward_sharded
    from vqvaehmm_tpu_torch.train.ensemble import train_ensemble
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline
    from vqvaehmm_tpu_torch.train.trainer import make_optimizer, train_step

    sync = torch.cuda.synchronize if mesh.device.type == "cuda" \
        else (lambda: None)
    out = {}
    # the uninterrupted run
    cfg = _pipeline_cfg(os.path.join(tmp, "dp_whole"))
    fused_loss_and_grads.launches = gather_epoch.launches = 0
    pipe = TrainPipeline(cfg, use_mesh=True, device=dev)
    state = pipe.train(log_fn=None)
    sync()
    out["launches"] = {"fused_train": fused_loss_and_grads.launches,
                       "gather": gather_epoch.launches}
    out["history"], out["params"] = pipe.history, _np_params(state.model)

    # SIGTERM to rank 0 after epoch 2, then a resume on rank 0 alone
    scfg = _pipeline_cfg(os.path.join(tmp, "dp_stopped"))

    def preempt_at_2(msg):                 # only rank 0 logs
        if msg.startswith("Epoch 2/"):
            os.kill(os.getpid(), signal.SIGTERM)

    stopped = TrainPipeline(scfg, use_mesh=True, device=dev)
    stopped.train(log_fn=preempt_at_2)
    out["stopped"] = (stopped.preempted, len(stopped.history))
    solo_group = dist.new_group([0])
    if mesh.rank == 0:
        resumed = TrainPipeline(scfg, use_mesh=True, device=dev,
                                group=solo_group)
        rstate = resumed.train(log_fn=None)
        out["resumed"] = (resumed.mesh.size, resumed.history,
                          _np_params(rstate.model))

    # the members over the ranks
    ecfg = _pipeline_cfg(os.path.join(tmp, "dp_ensemble"))
    epipe = TrainPipeline(ecfg, device=dev)
    t = ecfg.training
    fused_loss_and_grads.launches = gather_epoch.launches = 0
    states, hist, best = train_ensemble(
        epipe.build_model(), epipe.load_data(), ENSEMBLE_SEEDS,
        num_epochs=t.num_epochs, lr=t.learning_rate,
        batch_size=t.batch_size, gradient_clip=t.gradient_clip,
        device=dev, mesh=mesh, log_fn=None)
    sync()
    out["ensemble"] = (hist, best, [_np_params(s.model) for s in states],
                       {"fused_train": fused_loss_and_grads.launches,
                        "gather": gather_epoch.launches})

    # bulk inference over the ranks: one kernel-A launch a rank
    model = load_published(torch, mesh.device)
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.normal(size=(64, 5, 200)).astype(np.float32)
                         ).to(mesh.device)
    vt = torch.from_numpy(rng.integers(50, 201, size=64).astype(np.int32)
                          ).to(mesh.device)
    with torch.inference_mode():
        fused_forward.launches = 0
        got = model.infer_forward(x, valid_to=vt, mesh=mesh)
        sync()
        a_launches = fused_forward.launches
        want = model.infer_forward(x, valid_to=vt)
        sync()
    out["infer"] = (a_launches, all(torch.equal(g, w)
                                    for g, w in zip(got, want)),
                    max(max_abs(g, w) for g, w in zip(got, want)))

    # the HMM forward with T over the ranks
    K, steps = 3, 2 * 1000
    log_pi = torch.log(torch.from_numpy(rng.dirichlet(np.ones(K)).astype(
        np.float32))).to(mesh.device)
    log_A = torch.log(torch.from_numpy(rng.dirichlet(
        np.ones(K), size=(2, steps, K)).astype(np.float32))).to(mesh.device)
    log_obs = torch.from_numpy(rng.normal(size=(2, steps, K)).astype(
        np.float32)).to(mesh.device)
    sp = forward_sharded(log_pi, log_A, log_obs, mesh)
    ref = hmm_ops.forward(log_pi, log_A, log_obs)
    out["hmm"] = max(_rel_gap(sp.log_alpha,
                              ref.log_alpha[:, mesh.rows(steps)]),
                     _rel_gap(sp.log_likelihood, ref.log_likelihood))

    # a step's wall and device time on this rank, and the all-reduce's
    # share of the step, read inside the step
    model = epipe.build_model()
    opt = make_optimizer(model, t.learning_rate, t.gradient_clip)
    B, T = t.batch_size, cfg.data.max_len
    xs, us, ls = train_inputs(torch, np, np.random.default_rng(34), B, T,
                              model.cfg.input_dim, model.cfg.u_dim,
                              mesh.device)
    norm, rows = global_norm(ls, T), mesh.rows(B)
    xs, us, ls = xs[rows].contiguous(), us[rows].contiguous(), ls[rows]
    in_step = []

    class TimedMesh(type(mesh)):
        """The mesh with its all-reduce timed on the host between two
        synchronisations: the step's own all-reduce, the wait for the
        peer rank included."""

        def all_reduce_(self, t, op=dist.ReduceOp.SUM):
            sync()
            t0 = time.perf_counter()
            super().all_reduce_(t, op)
            sync()
            in_step.append(time.perf_counter() - t0)
            return t

    timed = TimedMesh(mesh.group, mesh.rank, mesh.size, mesh.device,
                      mesh.axis_name)

    def step(on=mesh):
        train_step(model, opt, xs, us, ls, 1.0, True, on, norm)

    def steps_wall(on=mesh):
        for _ in range(DP_STEPS):
            step(on)

    def ms_a_call(fn):
        """Host-clock ms a call of DP_STEPS calls ending in a synchronise,
        after one warm-up window (the same calls on every rank)."""
        fn()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return 1e3 * (time.perf_counter() - t0) / DP_STEPS

    step_ms = ms_a_call(steps_wall)
    timed_step_ms = ms_a_call(lambda: steps_wall(timed))
    reduce_ms = 1e3 * sum(in_step[-DP_STEPS:]) / DP_STEPS
    device_ms = _busy_ms(torch, step, DP_STEPS) \
        if mesh.device.type == "cuda" else None
    out["step"] = {"step_ms": step_ms, "device_ms": device_ms,
                   "timed_step_ms": timed_step_ms,
                   "all_reduce_ms": reduce_ms,
                   "all_reduce_share": reduce_ms / timed_step_ms,
                   "params": len(PARAM_NAMES)}
    return out


def phase_dp_train(torch, np, tmp, dev="cuda", backend="nccl"):
    """33. data-parallel training (the module docstring): (a) a world of
    one over `backend` in this process, (b) two gloo processes on `dev`.
    Returns the kernels line's dp_launches and dp_step."""
    import datetime

    import torch.distributed as dist
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads
    from vqvaehmm_tpu_torch.ops.gather import gather_epoch
    from vqvaehmm_tpu_torch.parallel.dryrun import run_world
    from vqvaehmm_tpu_torch.train.ensemble import train_ensemble
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    card = torch.device(dev, 0) if dev == "cuda" else torch.device(dev)
    cfg = _pipeline_cfg(os.path.join(tmp, "solo"))
    t = cfg.training
    steps = t.num_epochs * (cfg.data.samples_per_epoch // t.batch_size)
    solo = TrainPipeline(cfg, device=card)
    sstate = solo.train(log_fn=None)

    # (a) a world of one
    if card.type == "cuda":
        torch.cuda.set_device(card)
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(tmp, "store_one"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=300))
    try:
        fused_loss_and_grads.launches = gather_epoch.launches = 0
        one = TrainPipeline(_pipeline_cfg(os.path.join(tmp, "one")),
                            use_mesh=True, device=card)
        ostate = one.train(log_fn=None)
        if card.type == "cuda":
            torch.cuda.synchronize()
        one_launches = {"fused_train": fused_loss_and_grads.launches,
                        "gather": gather_epoch.launches}
    finally:
        dist.destroy_process_group()
    want = {"fused_train": steps, "gather": t.num_epochs}
    if one_launches != want:
        fail(f"the world of one launched {one_launches}, not {want}")
    if one.history != solo.history or not all(
            torch.equal(p, q) for p, q in zip(ostate.model.parameters(),
                                              sstate.model.parameters())):
        fail(f"TrainPipeline(use_mesh=True) over a world of one "
             f"({backend}) is not bit-equal to the run without a mesh: "
             f"{one.history} vs {solo.history}")
    say("dp train", f"(a) a world of one over {backend}: epoch losses and "
        f"final parameters bit-equal to the run without a mesh; launches "
        f"{one_launches}")

    # (b) two gloo processes sharing the card
    ecfg = _pipeline_cfg(os.path.join(tmp, "ensemble"))
    epipe = TrainPipeline(ecfg, device=card)
    _, ehist, _ = ens = train_ensemble(
        epipe.build_model(), epipe.load_data(), ENSEMBLE_SEEDS,
        num_epochs=t.num_epochs, lr=t.learning_rate,
        batch_size=t.batch_size, gradient_clip=t.gradient_clip,
        device=card, log_fn=None)
    t0 = time.perf_counter()
    ranks = run_world(2, dp_rank, (tmp, str(card)), device=str(card))
    wall = time.perf_counter() - t0
    r0, r1 = ranks
    half = {"fused_train": steps, "gather": t.num_epochs}
    for r, res in enumerate(ranks):
        if res["launches"] != half:
            fail(f"rank {r} launched {res['launches']}, not {half}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(res["history"],
                                                      one.history))
        if len(res["history"]) != t.num_epochs or rel > DP_EPOCH_TOL:
            fail(f"rank {r}'s epoch losses {res['history']} part from the "
                 f"world of one's {one.history} by {rel:.3e} relative (tol "
                 f"{DP_EPOCH_TOL})")
        if res["stopped"] != (True, 2):
            fail(f"rank {r} after SIGTERM to rank 0 at epoch 2: preempted "
                 f"and epochs {res['stopped']}")
        if res["infer"][:2] != (1, True):
            fail(f"rank {r}'s sharded infer_forward: kernel-A launches, "
                 f"bit-equal, gap {res['infer']}")
        if res["hmm"] > DP_HMM_TOL:
            fail(f"rank {r}'s forward_sharded parts from ops/hmm.forward by "
                 f"{res['hmm']:.3e} (tol {DP_HMM_TOL})")
        hist, best, members, elaunch = res["ensemble"]
        if not np.array_equal(hist, ehist) or best != ens[2] or not all(
                np.array_equal(m[n], p.detach().cpu().numpy())
                for m, s in zip(members, ens[0])
                for n, p in s.model.named_parameters()):
            fail(f"rank {r}'s 4-seed ensemble over two ranks is not "
                 "bit-equal to train_ensemble in one process")
        want_e = {"fused_train": 2 * steps, "gather": t.num_epochs}
        if elaunch != want_e:
            fail(f"rank {r}'s ensemble launched {elaunch}, not {want_e}")
    if not all(np.array_equal(r0["params"][n], r1["params"][n])
               for n in r0["params"]):
        fail("the two ranks' final parameters differ")
    size, rhist, rparams = r0["resumed"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(rhist, r0["history"][2:]))
    gap = max(float(np.abs(rparams[n] - r0["params"][n]).max())
              for n in rparams)
    if size != 1 or len(rhist) != 2 or rel > DP_RESUME_TOL \
            or gap > DP_RESUME_TOL:
        fail(f"the run resumed on {size} rank(s) parts from the "
             f"uninterrupted run by {rel:.3e} in the losses and {gap:.3e} in "
             f"the parameters (tol {DP_RESUME_TOL})")
    dp_launches = {f"rank{r}": {**res["launches"],
                                "fused_infer": res["infer"][0],
                                "ensemble": res["ensemble"][3]}
                   for r, res in enumerate(ranks)}
    dp_step = {f"rank{r}": res["step"] for r, res in enumerate(ranks)}
    say("dp train", f"(b) two gloo ranks on {card} ({wall:.1f} s): epoch "
        f"losses {r0['history']} within {DP_EPOCH_TOL} of the world of "
        f"one, the ranks' parameters bit-equal; SIGTERM at epoch 2 stopped "
        f"both, the resume on one rank within {max(rel, gap):.3e}; the "
        f"4-seed ensemble bit-equal to one process; sharded inference "
        f"bit-equal; forward_sharded within "
        f"{max(r0['hmm'], r1['hmm']):.3e}; launches a rank {dp_launches}")
    for r, st in dp_step.items():
        say("dp train", f"{r}: a step {st['step_ms']:.4f} ms of wall, "
            f"{_ms(st['device_ms'])} of device time; inside a step timed "
            f"with its all-reduce ({st['timed_step_ms']:.4f} ms), the "
            f"all-reduce of the flat gradients {st['all_reduce_ms']:.4f} ms"
            f", {100 * st['all_reduce_share']:.1f}% of that step (gloo "
            "through the host, the wait for the peer included: a record)")
    return dp_launches, dp_step


def phase_ensemble_2d(torch, np, dev="cuda"):
    """33(c). the ensemble head's 2-D (data x model) layout on four gloo
    ranks sharing `dev` (parallel/dryrun.py::ensemble_2d_check, the JAX
    dry run's case): each rank's rows within 1e-6 of the one-process
    forward on the card, the weights summing to 1 within 1e-4, the two
    ranks of a grid row equal.  Returns the largest gaps."""
    from vqvaehmm_tpu_torch.parallel.dryrun import (DRYRUN_BARS,
                                                    ensemble_2d_case,
                                                    ensemble_2d_check,
                                                    run_world)

    card = torch.device(dev, 0) if dev == "cuda" else torch.device(dev)
    case = ensemble_2d_case(8, np.random.default_rng(0))
    t0 = time.perf_counter()
    ranks = run_world(4, ensemble_2d_check, (case,), device=str(card))
    wall = time.perf_counter() - t0
    gaps = {k: max(g[k] for g, _ in ranks) for k in ranks[0][0]}
    for k, v in gaps.items():
        if not v <= DRYRUN_BARS[k]:
            fail(f"the 2-D ensemble head's {k} {v:.3e} is over its bar "
                 f"{DRYRUN_BARS[k]}")
    for r in range(4):
        if not np.array_equal(ranks[r][1], ranks[r ^ 1][1]):
            fail(f"ranks {r} and {r ^ 1} of one grid row hold different "
                 "weights")
    from vqvaehmm_tpu_torch.models.portfolio import (
        EnsemblePortfolioOptimizer, HeadConfig)

    ens = EnsemblePortfolioOptimizer(
        HeadConfig(**case["head"]), n_models=case["n_models"],
        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        cpu = ens(torch.from_numpy(case["q"])).numpy()
    cpu_gap = max(max_abs(torch.from_numpy(rows), torch.from_numpy(
        cpu[(r // 2) * 4:(r // 2 + 1) * 4])) for r, (_, rows)
        in enumerate(ranks))
    say("dp train", f"(c) the ensemble head on a 2 x 2 (data x model) grid "
        f"of four gloo ranks on {card} ({wall:.1f} s): rows within "
        f"{gaps['ensemble_2d']:.3e} of the one-process forward there, "
        f"weights summing to 1 within {gaps['ensemble_2d_sum']:.3e}, "
        f"{cpu_gap:.3e} from the CPU's forward (a record)")
    return {**gaps, "cpu_gap": cpu_gap}


# ---------------------------------------------------------------------------
# Phase 34: the studies and the reference CLIs (vqvaehmm_tpu_torch/scripts)
# ---------------------------------------------------------------------------

# the float32 arm's first epoch on the card against the CPU, relative
# (floor 1), as phase 30 holds the quality run's
STUDY_TOL = 1e-5
# each entry point through main(argv) at one seed and 2 epochs: (module,
# arguments, the JSON it writes)
STUDY_RUNS = (
    ("throughput_quality_ab", ["--seeds", "42", "--epochs", "2"],
     "throughput_quality_ab.json"),
    ("vq_sweep", ["--stage", "seeds", "--seeds", "42", "--epochs", "2"],
     "vq_sweep.json"),
    ("crash_regime", ["--seeds", "42", "--epochs", "2"],
     "crash_regime.json"),
    ("fixture_model_compare", [], "fixture_model_compare.json"),
    ("quality_eval", ["--epochs", "2"], "quality_eval.json"),
    ("vq_quality", ["--epochs", "2"], "vq_quality.json"),
    ("quality_sweep", ["--epochs", "2"], "quality_sweep.json"),
    ("ensemble_eval", ["--seeds", "1", "--epochs", "2"],
     "ensemble_eval.json"),
    ("train", ["--synthetic", "--epochs", "2", "--port-epochs", "2"],
     "train_summary.json"),
    ("backtest", ["--synthetic", "--n-sim", "100", "--n-days", "20"],
     "backtest_summary.json"),
)
# the EM fits' iterations in this phase: the code-HMM's (VQConfig's 50 in
# vq_sweep, vq_quality.EM_ITERS 50) and fixture_model_compare.EM_ITERS (40)
STUDY_VQ_EM_ITERS = 5
STUDY_FIXTURE_EM_ITERS = 2


def _finite_numbers(obj, path="") -> list:
    """The paths of the numbers in a JSON value that are not finite."""
    import math

    if isinstance(obj, dict):
        return [p for k, v in obj.items()
                for p in _finite_numbers(v, f"{path}.{k}")]
    if isinstance(obj, list):
        return [p for i, v in enumerate(obj)
                for p in _finite_numbers(v, f"{path}[{i}]")]
    if isinstance(obj, float) and not math.isfinite(obj):
        return [path]
    return []


def _study_expected(name, vq_epochs) -> dict:
    """Each kernel's launches of one STUDY_RUNS entry as the code implies
    them: a training step one kernel-C launch (the bfloat16 arm's counted
    in both fused_train and fused_train_bf16, as the wrapper counts them)
    and an epoch one kernel-D launch, at 15 steps an epoch of the recipe's
    1000 samples in 64, 8 of the synthetic studies' 256 in 32 and 4 of
    the ensemble's 128 in 32; a mean-field posterior one kernel-8 launch,
    a smoothed posterior one kernel-11 launch, a Viterbi path one each of
    kernels 11 and B (a code-HMM's or a chain's: one of B), the serving
    forward one of A; a VQ step one quantizer launch each way, a VQ epoch
    (polish epochs included) one gather, a panel pass, a code lookup, one
    nearest-code launch.  vq_epochs: the epochs each VQ training of the
    run took, in order."""
    e = {}

    def add(**kw):
        for k, v in kw.items():
            e[k] = e.get(k, 0) + v

    if name == "throughput_quality_ab":
        # two arms of 2 x 15 steps, each scored: smoothed and Viterbi
        add(fused_train=60, fused_train_bf16=30, gather=4,
            fused_evidence=4, viterbi=2)
    elif name == "vq_sweep":
        # two points: their training (the trainer's panel passes: one,
        # and one more a polish epoch) and their score (the codes of the
        # smoothed and the Viterbi decode); then the joint finetune of
        # the default point: its score, and two outer iterations of two
        # lookups, 10 steps and a score
        for ep in vq_epochs:
            add(quantize_forward=15 * ep, quantize_backward=15 * ep,
                gather=ep, vq_nearest=1 + (ep - 2) + 2, viterbi=1)
        add(vq_nearest=2 + 2 * 4, viterbi=1 + 2,
            quantize_forward=20, quantize_backward=20)
    elif name == "crash_regime":
        # four arms (current, two pools, K=5) of 2 x 15 steps, each scored
        # by its three decodes; the reference's model runs no kernel
        add(fused_train=120, gather=8, fused_encode=4, fused_evidence=8,
            viterbi=4)
    elif name == "fixture_model_compare":
        # the chain on every day and held out, the Gaussian HMM
        add(viterbi=3)
    elif name == "quality_eval":
        add(fused_train=16, gather=2, fused_encode=1, fused_evidence=2,
            viterbi=1, fused_infer=1)
    elif name == "vq_quality":
        # 2 full-batch steps; the codes twice (usage, the fit); the path
        add(quantize_forward=2, quantize_backward=2, vq_nearest=2,
            viterbi=1)
    elif name == "quality_sweep":
        add(fused_train=9 * 16, gather=9 * 2, fused_encode=9,
            fused_evidence=9 * 2, viterbi=9)
    elif name == "ensemble_eval":
        add(fused_train=8, gather=2, fused_encode=1)
    elif name == "train":
        # 2 x 15 steps; the head's 8 batches of frozen posteriors
        add(fused_train=30, gather=2, fused_encode=8)
    return e


def phase_studies(torch, np, tmp, dev="cuda"):
    """34. the ten entry points of vqvaehmm_tpu_torch/scripts through their
    main(argv) on the card (STUDY_RUNS), each with the launch counts set
    to 0 just before it and read just after: exit 0, a JSON of finite
    numbers naming the card, each kernel's launches as _study_expected;
    the float32 arm's first-epoch loss against the same run on the CPU
    within STUDY_TOL.  Returns {entry: {kernel: launches}}."""
    import dataclasses
    import importlib

    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads
    from vqvaehmm_tpu_torch.scripts import fixture_model_compare
    from vqvaehmm_tpu_torch.scripts import throughput_quality_ab as ab
    from vqvaehmm_tpu_torch.scripts import vq_quality, vq_sweep

    counters = launch_counters()
    out = os.path.join(tmp, "studies")
    vq_epochs, real_vq = [], vq_sweep.train_vq_stack
    real_cfg = vq_sweep.base_config
    real_em = (vq_quality.EM_ITERS, fixture_model_compare.EM_ITERS)

    def recording_vq(*a, **k):
        stack, state, pre = real_vq(*a, **k)
        vq_epochs.append(len(stack.history))
        return stack, state, pre

    def cut_em(*a, **k):
        cfg = real_cfg(*a, **k)
        return dataclasses.replace(cfg, vq=dataclasses.replace(
            cfg.vq, hmm_iters=STUDY_VQ_EM_ITERS))

    vq_sweep.train_vq_stack = recording_vq
    vq_sweep.base_config = cut_em
    vq_quality.EM_ITERS = STUDY_VQ_EM_ITERS
    fixture_model_compare.EM_ITERS = STUDY_FIXTURE_EM_ITERS
    launches, walls = {}, {}
    try:
        for name, argv, fname in STUDY_RUNS:
            mod = importlib.import_module(f"vqvaehmm_tpu_torch.scripts.{name}")
            if name == "throughput_quality_ab":
                # the recipe's data stage, outside the counted run
                _quiet(mod.load_windows, out)
            vq_epochs.clear()
            for c in counters.values():
                c.launches = 0
            fused_loss_and_grads.bf16_launches = 0
            t0 = time.perf_counter()
            rc = _quiet(mod.main, ["--device", dev, "--outdir", out, *argv])
            if dev == "cuda":
                torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            got = {k: c.launches for k, c in counters.items()}
            got["fused_train_bf16"] = fused_loss_and_grads.bf16_launches
            launches[name] = got
            if rc != 0:
                fail(f"{name}.main exited {rc}")
            with open(os.path.join(out, fname)) as f:
                res = json.load(f)
            bad = _finite_numbers(res)
            if bad:
                fail(f"{name} wrote numbers that are not finite: {bad[:5]}")
            if dev == "cuda" and \
                    res.get("device") != torch.cuda.get_device_name(0):
                fail(f"{name}'s JSON names the device {res.get('device')}")
            want = {k: 0 for k in got}
            want.update(_study_expected(name, list(vq_epochs)))
            if got != want:
                fail(f"{name} launched {got}, predicted {want}")
    finally:
        vq_sweep.train_vq_stack = real_vq
        vq_sweep.base_config = real_cfg
        vq_quality.EM_ITERS, fixture_model_compare.EM_ITERS = real_em
    with open(os.path.join(out, "throughput_quality_ab.json")) as f:
        card_first = json.load(f)["parity"]["per_seed"][0]["train_history"][0]
    mo, to = ab.VARIANTS["parity"]
    _, cpu_hist, _ = _quiet(ab.run_variant, out, "parity", 42, mo, to, 2,
                            torch.device("cpu"))
    rel = abs(card_first - cpu_hist[0]) / max(1.0, abs(cpu_hist[0]))
    if rel > STUDY_TOL:
        fail(f"the A/B's float32 arm: first epoch {card_first} on the card, "
             f"{cpu_hist[0]} on the CPU ({rel:.3e} relative, tol "
             f"{STUDY_TOL})")
    say("studies", f"ten entry points on the card in "
        f"{sum(walls.values()):.1f} s ("
        + ", ".join(f"{n} {w:.1f}" for n, w in walls.items())
        + f"); launches as predicted: "
        + "; ".join(f"{n} {{" + ", ".join(f"{k} {v}" for k, v in
                                           sorted(l.items()) if v) + "}"
                    for n, l in launches.items())
        + f"; the float32 arm's first epoch {card_first:.6f} within "
        f"{rel:.3e} of the CPU's")
    return launches


def _sha(torch, *tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def kernel_times(torch, np, root: str) -> dict:
    """Kernel A at A_SHAPES, kernel C at C_SHAPES and kernels 8, 11, 10
    and B at BULK_SHAPES with the package of the checkout at `root` (its
    kernels built there): back-to-back CUDA-event ms and device-busy ms a
    call, the published weights (fresh weights from a seed at the probe
    shape); for C (its float32 mode), 8, 11, 10 and B also a SHA-256 of
    the output bytes from fixed seeded inputs.
    Where the checkout's wrappers take a forced tile (and split), every
    tile of kernel 8 and (tile, split) of kernel 11 is timed at each bulk
    shape too."""
    sys.path.insert(0, root)
    from vqvaehmm_tpu_torch.ops import fused_decode, fused_encoder
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode
    from vqvaehmm_tpu_torch.ops.fused_infer import fused_forward
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused

    dev = torch.device("cuda")
    model = load_published(torch, dev)
    probe = probe_model(torch, dev)
    rng = np.random.default_rng(0)
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    with torch.inference_mode():
        for B, T in A_SHAPES:
            x = torch.from_numpy(rng.normal(
                size=(B, model.cfg.input_dim, T)).astype(np.float32)).to(dev)
            fn = lambda: fused_forward(model, x, valid_to=T,  # noqa: E731
                                       use_kernel=True)
            out[f"A {B}x{T}"] = {"events_ms": _time(torch, fn)[0],
                                 "device_ms": _device_ms(torch, fn)}
    for B, T in C_SHAPES:
        m, iters = (probe, 2) if (B, T) == C_SHAPES[-1] else (model, 20)
        x, u, lens = train_inputs(torch, np, rng, B, T, m.cfg.input_dim,
                                  m.cfg.u_dim, dev)
        fn = lambda: fused_loss_and_grads(m, x, u, lens, 1.0,  # noqa: E731
                                          use_kernel=True)
        loss, grads = fn()
        out[f"C {B}x{T}"] = {"events_ms": _time(torch, fn, iters=iters)[0],
                             "device_ms": _device_ms(torch, fn, 3),
                             "sha256": _sha(torch, loss, *grads.values())}
        # the bfloat16 mode on the same inputs; its outputs are kept in the
        # checkout's build directory, for compare_checkouts to hold the two
        # checkouts' apart
        mm = _bf16_model(torch, m)
        fn = lambda: fused_loss_and_grads(mm, x, u, lens, 1.0,  # noqa: E731
                                          use_kernel=True)
        loss, grads = fn()
        path = os.path.join(root, "build", f"kernel_c_bf16_{B}x{T}.pt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"loss": loss.cpu(),
                    **{n: g.cpu() for n, g in grads.items()}}, path)
        out[f"C bf16 {B}x{T}"] = {
            "events_ms": _time(torch, fn, iters=iters)[0],
            "device_ms": _device_ms(torch, fn, 3),
            "sha256": _sha(torch, loss, *grads.values()), "outputs": path}
    forced = hasattr(fused_decode, "_launch_evidence")
    with torch.inference_mode():
        for B, T in BULK_SHAPES:
            g = np.random.default_rng(B * 10007 + T)
            x, u, lens = train_inputs(torch, np, g, B, T,
                                      model.cfg.input_dim, model.cfg.u_dim,
                                      dev, short=max(1, T - 3))
            vargs = viterbi_inputs(torch, np, g, B, T, model.cfg.K, dev,
                                   (B, T))
            for key, fn in (
                    (f"8 {B}x{T}", lambda: fused_encode(
                        model, x, valid_to=lens, use_kernel=True)),
                    (f"11 {B}x{T}", lambda: fused_evidence(
                        model, x, u, lens, use_kernel=True)),
                    (f"10 {B}x{T}", lambda: fused_viterbi_states(
                        model, x, u, lens, use_kernel=True)),
                    (f"B {B}x{T}", lambda: viterbi_fused(
                        *vargs, use_kernel=True))):
                res = fn()
                out[key] = {"events_ms": _time(torch, fn)[0],
                            "device_ms": _device_ms(torch, fn),
                            "sha256": _sha(torch, *(
                                res if isinstance(res, tuple) else (res,)))}
            if not forced:
                continue
            plan = fused_decode.evidence_plan(
                model.cfg, B, T, torch.cuda.get_device_properties(
                    0).multi_processor_count)
            out[f"11 {B}x{T}"]["plan"] = [plan.tile, plan.blocks,
                                          plan.split]
            out[f"8 {B}x{T}"]["plan"] = list(fused_encoder.encode_plan(
                model.cfg, B, T, torch.cuda.get_device_properties(
                    0).multi_processor_count)[:2])
            K = model.cfg.K
            lg = torch.empty((B, K, T), device=dev)
            ev = (torch.empty((B, T, K), device=dev),
                  torch.empty((B, T, K, K), device=dev))
            for tile in fused_encoder.TILES:
                fn = lambda: fused_encoder._launch(  # noqa: E731
                    model, x, lens, tile, lg)
                out[f"8 {B}x{T} tile {tile}"] = _device_ms(torch, fn)
                for split in (False, True):
                    fn = lambda: fused_decode._launch_evidence(  # noqa: E731
                        model, x, u, lens, tile, split, ev)
                    out[f"11 {B}x{T} tile {tile} split {int(split)}"] = \
                        _device_ms(torch, fn)
    # the VQ quantizer forward and backward, and the VQ configuration's
    # epoch gather, through entry points the parent has too
    for B, T in QUANT_SHAPES:
        fn, res = quantize_step(torch, np, B, T)
        ms, ops = _device_trace(torch, fn)
        out[f"quantize {B}x{T}"] = {"events_ms": _time(torch, fn)[0],
                                    "device_ms": ms, "launches": ops,
                                    "sha256": _sha(torch, *res)}
    from vqvaehmm_tpu_torch.data.device_sampler import DeviceEpochSampler
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    tmp = tempfile.mkdtemp(prefix="chip_smoke_epoch_")
    try:
        cfg = _vq_cfg(tmp)
        sampler = DeviceEpochSampler(TrainPipeline(cfg, device="cpu")
                                     .load_data(), dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t = cfg.training
    nb = cfg.data.samples_per_epoch // t.batch_size
    fn = lambda: sampler.epoch(t.batch_size, nb,  # noqa: E731
                               exact_stream=False)
    ms, ops = _device_trace(torch, fn)
    out[f"epoch gather {nb}x{t.batch_size}"] = {
        "events_ms": _time(torch, fn)[0], "device_ms": ms, "launches": ops}
    # a VQ training step (make_vq_epoch_step over an epoch of nb steps on
    # seeded batches): host-clock wall, device-busy ms and device ops a step
    from vqvaehmm_tpu_torch.train.vq_pipeline import (make_vq_epoch_step,
                                                      make_vq_model,
                                                      make_vq_optimizer)

    g = np.random.default_rng(21)
    shape = (nb, t.batch_size, cfg.model.input_dim, cfg.data.max_len)
    xs = _randn(torch, np, g, shape, dev)
    lens = torch.from_numpy(g.integers(
        cfg.data.min_len, cfg.data.max_len + 1, size=shape[:2]).astype(
            np.int32)).to(dev)
    model = make_vq_model(cfg, device=dev,
                          generator=torch.Generator().manual_seed(0))
    step = make_vq_epoch_step(model, make_vq_optimizer(
        model, t.learning_rate, t.gradient_clip))
    fn = lambda: step(xs, lens)  # noqa: E731
    ms, ops = _device_trace(torch, fn, calls=2)
    wall = _wall(torch, fn)[0] / nb
    out[f"vq step {t.batch_size}x{cfg.data.max_len}"] = {
        "events_ms": wall, "wall_ms": wall,
        "device_ms": None if ms is None else ms / nb,
        "launches": None if ops is None else ops / nb}
    return out


def compare_checkouts(old: str, new: str) -> int:
    """kernel_times of two checkouts in the order old, new, new, old, each
    in a process of its own on the same card, the ratio of the medians of
    the device-busy times, and whether kernels 8 and 11 of the two give the
    same output bytes."""
    runs = []
    for root in (old, new, new, old):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--kernel-times", root], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, flush=True)
            return proc.returncode or 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    for key in [k for k in runs[0] if isinstance(runs[0][k], dict)]:
        o = [runs[0][key]["device_ms"], runs[3][key]["device_ms"]]
        n = [runs[1][key]["device_ms"], runs[2][key]["device_ms"]]
        line = f"{key}: device ms old {o} new {n}"
        if None not in o + n:
            line += f": {statistics.median(o) / statistics.median(n):.2f}x"
        if "wall_ms" in runs[0][key]:
            line += ("; wall ms a step old "
                     f"{[runs[i][key]['wall_ms'] for i in (0, 3)]} new "
                     f"{[runs[i][key]['wall_ms'] for i in (1, 2)]}")
        if "launches" in runs[0][key]:
            line += ("; device ops a call old "
                     f"{[runs[i][key]['launches'] for i in (0, 3)]} new "
                     f"{[runs[i][key]['launches'] for i in (1, 2)]}")
        if "outputs" in runs[0][key]:
            # two designs of the bfloat16 mode: how far apart their outputs
            # are (the loss relative, a gradient as a share of its leaf's
            # largest entry), each checkout bit-equal across its two runs
            import torch

            a, b = (torch.load(runs[i][key]["outputs"]) for i in (0, 1))
            loss_rel = abs(float(a["loss"]) - float(b["loss"])) / abs(
                float(a["loss"]))
            share = max(float((a[n] - b[n]).abs().max())
                        / max(float(a[n].abs().max()), 1e-30)
                        for n in a if n != "loss")
            repeat = (runs[0][key]["sha256"] == runs[3][key]["sha256"]
                      and runs[1][key]["sha256"] == runs[2][key]["sha256"])
            line += (f"; new outputs from old: loss {loss_rel:.3e} "
                     f"relative, gradients within {share:.3e} of a leaf's "
                     f"largest entry; each checkout's two runs "
                     + ("bit-equal" if repeat else "DIFFER"))
        elif "sha256" in runs[0][key]:
            same = len({r[key]["sha256"] for r in runs}) == 1
            line += ("; outputs bit-equal" if same else
                     "; OUTPUTS DIFFER: " + ", ".join(
                         r[key]["sha256"][:16] for r in runs))
        print(line, flush=True)
    return 0


# the scan kernels' sources, the barrier each phase of the instrumented
# copy ends at, and its clocks' symbol (see scan_clocks)
_CLOCKED = (("viterbi.cu", "viterbi_kernel(", "__syncthreads();", 2,
             "scan_clk_b"),
            ("fused_decode.cu", "fused_decode_kernel(const float",
             "grid.sync();", 1, "scan_clk_10"))


def _clocked_source(text, marker, barrier, first, sym):
    """The kernel at `marker` with thread 0 of block 0 reading clock64()
    after each of its barriers from the `first`-th on, and at its end: the
    cycles of each phase go to the device array `sym`."""
    out, seen, inside = [], 0, False
    for line in text.split("\n"):
        inside = inside or marker in line
        out.append(line)
        if inside and line.strip().startswith("extern __shared__"):
            out.append("  long long acc_[8] = {0}; long long last_ = "
                       "clock64(); const bool rec_ = blockIdx.x == 0 && "
                       "threadIdx.x == 0;")
        elif inside and line.strip().startswith(barrier) \
                and 0 <= seen + 1 - first < 7:
            seen += 1
            out.append(f"  if (rec_) {{ long long now_ = clock64(); "
                       f"acc_[{seen - first}] += now_ - last_; last_ = now_; }}")
        elif inside and line.strip().startswith(barrier):
            seen += 1
        elif inside and line.startswith("}"):
            out[-1:] = ["  __syncthreads();",
                        "  if (rec_) { acc_[7] = clock64() - last_; "
                        f"for (int k = 0; k < 8; ++k) {sym}[k] = acc_[k]; }}",
                        "}"]
            inside = False
    text = "\n".join(out).replace(
        "namespace {\n", f"__device__ long long {sym}[8];\nnamespace {{\n", 1)
    return text + (f'\nextern "C" int read_{sym}(long long* out) {{ return '
                   f'(int)cudaMemcpyFromSymbol(out, {sym}, 64); }}\n')


def scan_clocks(torch, np) -> int:
    """Where the time of kernels B and 10 goes: the library built again into
    build/scan_clocks with the two scan kernels instrumented (thread 0 of
    block 0 reads the SM's clock after each phase's barrier), then the
    cycles of each phase at B = 1 over T and at the bulk shapes, with the
    device-busy time a call of the uninstrumented kernel B beside them."""
    import ctypes

    from vqvaehmm_tpu_torch.ops import _build
    from vqvaehmm_tpu_torch.ops.fused_decode import (decode_plan,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_viterbi import (viterbi_fused,
                                                      viterbi_plan)

    dev = torch.device("cuda")
    plain_lib = _build.library()
    out_dir = os.path.join(ROOT, "build", "scan_clocks")
    os.makedirs(out_dir, exist_ok=True)
    objs, procs = [], []
    for src in _build.sources():
        path = str(src)
        for name, marker, barrier, first, sym in _CLOCKED:
            if src.name == name:
                path = os.path.join(out_dir, name)
                with open(path, "w") as f:
                    f.write(_clocked_source(src.read_text(), marker, barrier,
                                            first, sym))
        objs.append(os.path.join(out_dir, src.name + ".o"))
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-c", path, "-o", objs[-1]], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            fail(f"the instrumented build failed:\n{log[-3000:]}")
    lib_path = os.path.join(out_dir, "libscan_clocks.so")
    subprocess.run([_build._nvcc(), "-shared", "-o", lib_path, *objs],
                   check=True)
    lib = _build.bind(ctypes.CDLL(lib_path))
    for _, _, _, _, sym in _CLOCKED:
        getattr(lib, f"read_{sym}").argtypes = [ctypes.c_void_p]
    model = load_published(torch, dev)
    rng = np.random.default_rng(5)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    shapes = [(1, 40), (1, 200), (1, 600), (1, 1200), (1, 2327), (1, 4654),
              (64, 200), (460, 20)]
    with torch.inference_mode():
        for B, T in shapes:
            args = viterbi_inputs(torch, np, rng, B, T, model.cfg.K, dev,
                                  (B, T))
            _build._lib = plain_lib
            busy = _device_ms(torch, lambda: viterbi_fused(*args))
            _build._lib = lib
            x, u, _ = decode_inputs(torch, np, rng, model, B, T, False, False)
            for name, fn, sym, what in (
                    ("B", lambda: viterbi_fused(*args), "scan_clk_b",
                     "stage, (a), (b), (c), the final state, (d) and (e)"),
                    ("10", lambda: fused_viterbi_states(model, x, u),
                     "scan_clk_10", "evidence and (a), (b), (c), (d), (e)")):
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                clk = (ctypes.c_longlong * 8)()
                getattr(lib, f"read_{sym}")(clk)
                n = 5 if name == "B" else 4
                plan = (viterbi_plan(B, T, model.cfg.K, False) if name == "B"
                        else decode_plan(model, B, T, dev))
                say("scan clocks", f"kernel {name} B={B} T={T}: cycles of "
                    f"{what}: {list(clk)[:n] + [clk[7]]}; {plan}"
                    + (f"; uninstrumented, device busy {_ms(busy)} a call"
                       if name == "B" else ""))
    _build._lib = plain_lib
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this script "
              "drives the CUDA port and needs a GPU", flush=True)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "vqvaehmm_tpu_torch")) or \
            not all(os.path.exists(f) for f in (
                CHECKPOINT, QUALITY_CHECKPOINT, HEAD_CHECKPOINT, FIXTURE,
                VQ_CONFIG, VQ_ARCHIVE)):
        print("FAIL: run chip_smoke.py from a checkout of the repository "
              "(vqvaehmm_tpu_torch/, the checkpoints and the fixture panel)",
              flush=True)
        return 2
    import numpy as np

    if sys.argv[1:2] == ["--kernel-times"] and len(sys.argv) == 3:
        print(json.dumps(kernel_times(torch, np,
                                      os.path.abspath(sys.argv[2]))),
              flush=True)
        return 0
    if sys.argv[1:2] == ["--compare"] and len(sys.argv) == 4:
        return compare_checkouts(*map(os.path.abspath, sys.argv[2:]))
    if sys.argv[1:] == ["--scan-clocks"]:
        sys.path.insert(0, ROOT)
        return scan_clocks(torch, np)
    if sys.argv[1:]:
        print("usage: chip_smoke.py [--kernel-times DIR | --compare OLD NEW "
              "| --scan-clocks]", flush=True)
        return 2
    sys.path.insert(0, ROOT)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    # 2. build
    from vqvaehmm_tpu_torch.ops import _build

    lib = _build.library()
    say("build", f"{', '.join(os.path.relpath(s, ROOT) for s in _build.sources())} "
        f"-> {os.path.relpath(lib._name, ROOT)} in {_build.build_seconds:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("build", line.strip())

    say("build", "registers, static shared memory and spills of the "
        "kernels on tile_fma.cuh (the serving forward's, the training "
        "step's, the encoder's and the evidence's): "
        + "; ".join(kernel_resources(_build.build_log, (
            "fused_infer_kernel", "infer_pack_kernel", "train_pack_kernel",
            "train_forward_kernel", "train_backward_kernel",
            "train_weight_grad_kernel", "train_reduce_kernel",
            "fused_encoder_kernel", "encoder_pack_kernel",
            "fused_evidence_kernel"))))
    say("build", "registers, static shared memory and spills of kernel C's "
        "bfloat16 mode on tile_mma.cuh: " + "; ".join(kernel_resources(
            _build.build_log, TRAIN_KERNELS["bfloat16"][:4])))
    hmma = _build.sass_counts([n for kernels in TRAIN_KERNELS.values()
                               for n in kernels])
    say("build", "HMMA instructions in the SASS of kernel C's kernels: "
        + "; ".join(f"{n} {c}" for n, c in sorted(hmma.items())))
    for name in BF16_PRODUCT_KERNELS:
        if hmma[name] == 0:
            fail(f"{name} issues no tensor-core instruction (HMMA)")
    for name in TRAIN_KERNELS["float32"]:
        if hmma[name]:
            fail(f"{name} issues {hmma[name]} HMMA instructions; the "
                 f"float32 mode's contract is full float32")
    say("build", "the scan kernels at K = 3 (Viterbi, one-kernel decode): "
        + "; ".join(kernel_resources(_build.build_log, (
            "viterbi_kernelILi3E", "fused_decode_kernelILi3E"))))

    dev = torch.device("cuda")
    model = load_published(torch, dev)
    # 3, 4: kernels against their plain versions
    with torch.inference_mode():
        err_a = phase_kernel_a(torch, np, model)
        err_b = phase_kernel_b(torch, np, dev)
    # 5. serving
    launches = phase_serve(torch, np)
    # 6. times
    times = phase_times(torch, np, model)
    # 7, 8: the training kernels against their plain versions
    err_c = phase_kernel_c(torch, np, load_published(torch, dev))
    err_d = phase_kernel_d(torch, np, dev)
    # 9. training
    train_launches, goodput = phase_train(torch, np)
    # 10. times
    ttimes, gbounds, tsplits = phase_train_times(torch, np, model)
    say("times", f"training goodput (TrainPipeline, published configuration,"
        f" epochs 2-4): {goodput:.1f} seqs/s")
    # 11. where a training step's time goes
    phase_train_profile(torch, np)
    # 12-14: the bulk-scoring kernels against their plain versions
    with torch.inference_mode():
        err_8 = phase_kernel_8(torch, np, model)
        err_11 = phase_kernel_11(torch, np, model)
        err_10 = phase_kernel_10(torch, np, model)
    # 15. bulk scoring
    bulk_launches, bulk = phase_bulk(torch, np)
    # 16. times
    btimes = phase_bulk_times(torch, np, model, bulk)
    # 17. kernel 9 against its plain version
    from vqvaehmm_tpu_torch.train.vq_pipeline import VQStack

    vq_stack = VQStack.load(VQ_ARCHIVE, device="cuda")
    err_9, err_q = phase_kernel_9(torch, np, vq_stack)
    # 18, 19: the VQ family trained and served
    vq_train_launches, vq_goodput = phase_vq_train(torch, np)
    vq_serve_launches = phase_vq_serve(torch, np)
    # 20. times
    vtimes = phase_vq_times(torch, np, vq_stack)
    say("times", f"VQ training goodput (TrainPipeline, config_vq.json, "
        f"save_freq 2, epochs 2-4): {vq_goodput:.1f} seqs/s")
    # 21-23: micro-batching, streaming, hot reload and the CLI
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    try:
        served = phase_batching(torch, np, tmp)
        try:
            streamed = phase_streaming(torch, np, tmp, served)
        finally:
            _stop(served["httpd"])
            served["httpd"].vqhmm_model.close()
        reloaded = phase_reload_cli(torch, np, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # 24, 25: the recipe's downstream stages
    tmp = tempfile.mkdtemp(prefix="chip_smoke_recipe_")
    try:
        recipe_out = phase_heads(torch, np, tmp)
        mc_launches = phase_montecarlo(torch, np, recipe_out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # 26-28: the GMM stack, seed ensembles, prefetch and profiling
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gmm_ensemble_")
    try:
        gmm = phase_gmm(torch, np, tmp)
        ens_launches, ens_timing = phase_ensemble(torch, np, tmp)
        prefetch_walls = phase_prefetch_profile(torch, np, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # 29. the throughput configuration (bfloat16)
    err_c16 = phase_kernel_c_bf16(torch, np, load_published(torch, dev))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_throughput_")
    try:
        c16_launches, c16_npz, c16_train_rel = phase_throughput_train(
            torch, np, tmp)
        c16_serve, c16_serve_err, c16_flips = phase_throughput_serve(
            torch, np, tmp, c16_npz)
        c16_ens = phase_throughput_ensemble(torch, np, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # where a steady epoch of the throughput configuration goes on the card
    _, c16_split = phase_train_profile(torch, np, "bfloat16")
    headline = phase_headline(torch, np)
    # 30, 31: the whole published recipe, and the rest of the zoo
    tmp = tempfile.mkdtemp(prefix="chip_smoke_full_recipe_")
    try:
        recipe_launches, _ = phase_recipe(torch, np, tmp, kind)
        zoo = phase_zoo(torch, np, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # 32, 33: data parallelism
    dp_gaps = phase_kernel_c_dp(torch, np, load_published(torch, dev))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        dp_launches, dp_step = phase_dp_train(torch, np, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_ensemble_2d(torch, np)
    # 34. the studies and the reference CLIs
    tmp = tempfile.mkdtemp(prefix="chip_smoke_studies_")
    try:
        study_launches = phase_studies(torch, np, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bounds = kernel_bounds(model, 64, 200)

    kernels = [
        {"name": "fused_infer", "route": "cuda",
         "source": "vqvaehmm_tpu_torch/csrc/fused_infer.cu",
         "replaces": "vqvaehmm_tpu/ops/pallas_infer.py:45",
         "launches": launches["fused_infer"], "max_abs_err": err_a,
         "ms": times[("fused_infer", 64, 200, True)][0],
         "plain_ms": times[("fused_infer", 64, 200, False)][0],
         "bound_ms": bounds["fused_infer"][0],
         "bound_by": bounds["fused_infer"][1], "library_ms": None,
         "shape": "B=64 T=200"},
        {"name": "viterbi", "route": "cuda",
         "source": "vqvaehmm_tpu_torch/csrc/viterbi.cu",
         "replaces": "vqvaehmm_tpu/ops/pallas_hmm.py:103",
         "also_replaces": ["vqvaehmm_tpu/ops/pallas_hmm.py:274",
                           "vqvaehmm_tpu/ops/pallas_hmm.py:333"],
         "launches": launches["viterbi"], "max_abs_err": err_b,
         "ms": times[("viterbi", 64, 200, True)][0],
         "plain_ms": times[("viterbi", 64, 200, False)][0],
         "bound_ms": bounds["viterbi"][0],
         "bound_by": bounds["viterbi"][1], "library_ms": None,
         "shape": "B=64 T=200",
         "device_ms": times[("viterbi", 64, 200, True)][3],
         "plain_device_ms": times[("viterbi", 64, 200, False)][3],
         "bulk_launches": bulk_launches["viterbi"]},
        {"name": "fused_train", "route": "cuda",
         "source": "vqvaehmm_tpu_torch/csrc/fused_train.cu",
         "replaces": "vqvaehmm_tpu/ops/pallas_train.py:82",
         "launches": train_launches["fused_train"], "max_abs_err": err_c,
         "ms": ttimes[("fused_train", 64, 200, True)][0],
         "plain_ms": ttimes[("fused_train", 64, 200, False)][0],
         "bound_ms": bounds["fused_train"][0],
         "bound_by": bounds["fused_train"][1], "library_ms": None,
         "shape": "B=64 T=200",
         "probe_ms": ttimes[("fused_train", 256, 512, True)][0],
         "probe_plain_ms": ttimes[("fused_train", 256, 512, False)][0],
         "probe_bound_ms": kernel_bounds(
             probe_model(torch, dev), 256, 512)["fused_train"][0]},
        {"name": "gather", "route": "cuda",
         "source": "vqvaehmm_tpu_torch/csrc/gather.cu",
         "replaces": "vqvaehmm_tpu/ops/pallas_gather.py:140",
         "also_replaces": ["vqvaehmm_tpu/ops/pallas_gather.py:150"],
         "launches": train_launches["gather"], "max_abs_err": err_d,
         "ms": ttimes[("gather_epoch", 64, 200, True)][0],
         "plain_ms": ttimes[("gather_epoch", 64, 200, False)][0],
         "bound_ms": gbounds["gather_epoch"][0],
         "bound_by": gbounds["gather_epoch"][1],
         "library_ms": gather_library_ms(torch, np, S=15),
         "shape": "an epoch, S=15 B=64 T=200",
         "device_ms": ttimes[("gather_epoch", 64, 200, True)][3],
         "plain_device_ms": ttimes[("gather_epoch", 64, 200, False)][3],
         "batch_ms": ttimes[("gather", 64, 200, True)][0],
         "batch_plain_ms": ttimes[("gather", 64, 200, False)][0],
         "batch_bound_ms": gbounds["gather"][0],
         "batch_library_ms": gather_library_ms(torch, np)},
    ]
    for name, source, line, err in (
            ("fused_encode", "fused_encoder.cu", "pallas_encoder.py:32",
             err_8),
            ("fused_evidence", "fused_decode.cu", "pallas_decode.py:225",
             err_11),
            ("fused_decode", "fused_decode.cu", "pallas_decode.py:104",
             err_10)):
        entry = {"name": name, "route": "cuda",
                 "source": f"vqvaehmm_tpu_torch/csrc/{source}",
                 "replaces": f"vqvaehmm_tpu/ops/{line}",
                 "launches": bulk_launches[name], "max_abs_err": err,
                 "ms": btimes[(name, 64, 200, True)][0],
                 "plain_ms": btimes[(name, 64, 200, False)][0],
                 "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                 "library_ms": None, "shape": "B=64 T=200"}
        entry["device_ms"] = btimes[(name, 64, 200, True)][3]
        entry["plain_device_ms"] = btimes[(name, 64, 200, False)][3]
        for B, T in ((460, 20), (1, 2327), (1, 200)):
            entry[f"ms_{B}x{T}"] = btimes[(name, B, T, True)][0]
            entry[f"plain_ms_{B}x{T}"] = btimes[(name, B, T, False)][0]
            entry[f"device_ms_{B}x{T}"] = btimes[(name, B, T, True)][3]
            entry[f"bound_ms_{B}x{T}"] = kernel_bounds(model, B, T)[name][0]
        if name in launches:
            entry["serve_launches"] = launches[name]
        kernels.append(entry)
    entry = {"name": "vq_nearest", "route": "cuda",
             "source": "vqvaehmm_tpu_torch/csrc/vq.cu",
             "replaces": "vqvaehmm_tpu/ops/vq.py:60",
             "launches": vq_train_launches["vq_nearest"],
             "max_abs_err": err_9,
             "ms": vtimes[(64, 200, True)][0],
             "plain_ms": vtimes[(64, 200, False)][0],
             "bound_ms": bounds["vq_nearest"][0],
             "bound_by": bounds["vq_nearest"][1], "library_ms": None,
             "shape": "B=64 T=200 M=8 D=16",
             "device_ms": vtimes[(64, 200, True)][3],
             "plain_device_ms": vtimes[(64, 200, False)][3],
             "serve_launches": vq_serve_launches["vq_nearest"]}
    for B, T in VQ_SHAPES:
        if (B, T) != (64, 200):
            entry[f"ms_{B}x{T}"] = vtimes[(B, T, True)][0]
            entry[f"plain_ms_{B}x{T}"] = vtimes[(B, T, False)][0]
            entry[f"device_ms_{B}x{T}"] = vtimes[(B, T, True)][3]
            entry[f"bound_ms_{B}x{T}"] = kernel_bounds(
                model, B, T)["vq_nearest"][0]
    kernels.append(entry)
    for name in ("quantize_forward", "quantize_backward"):
        entry = {"name": name, "route": "cuda",
                 "source": "vqvaehmm_tpu_torch/csrc/vq.cu",
                 "replaces": "vqvaehmm_tpu/ops/vq.py:60",
                 "launches": vq_train_launches[name],
                 "max_abs_err": err_q[name.split("_")[1]],
                 "ms": vtimes[(name, 64, 200, True)][0],
                 "plain_ms": vtimes[(name, 64, 200, False)][0],
                 "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                 "library_ms": None, "shape": "B=64 T=200 M=8 D=16",
                 "device_ms": vtimes[(name, 64, 200, True)][3],
                 "plain_device_ms": vtimes[(name, 64, 200, False)][3],
                 "ms_8x200": vtimes[(name, 8, 200, True)][0],
                 "device_ms_8x200": vtimes[(name, 8, 200, True)][3],
                 "bound_ms_8x200": kernel_bounds(model, 8, 200)[name][0]}
        kernels.append(entry)
    for k, res, shapes in ((kernels[0], times, A_SHAPES),
                           (kernels[2], ttimes, C_SHAPES)):
        k["device_ms"] = res[(k["name"], 64, 200, True)][3]
        k["plain_device_ms"] = res[(k["name"], 64, 200, False)][3]
        for B, T in shapes[1:]:
            k[f"ms_{B}x{T}"] = res[(k["name"], B, T, True)][0]
            k[f"device_ms_{B}x{T}"] = res[(k["name"], B, T, True)][3]
            k[f"plain_device_ms_{B}x{T}"] = res[(k["name"], B, T, False)][3]
            if k["name"] == "fused_infer":
                k[f"bound_ms_{B}x{T}"] = kernel_bounds(model, B, T)[
                    "fused_infer"][0]
    kernels[2]["bound_ms_8x200"] = kernel_bounds(model, 8, 200)[
        "fused_train"][0]
    for B, T in BULK_SHAPES[1:]:
        k = kernels[1]
        k[f"ms_{B}x{T}"] = times[("viterbi", B, T, True)][0]
        k[f"plain_ms_{B}x{T}"] = times[("viterbi", B, T, False)][0]
        k[f"device_ms_{B}x{T}"] = times[("viterbi", B, T, True)][3]
        k[f"bound_ms_{B}x{T}"] = kernel_bounds(model, B, T)["viterbi"][0]
    for k in kernels:
        # the VQ family's and the serving surface's paths through the
        # kernels of earlier slices
        if k["name"] == "gather":
            k["vq_train_launches"] = vq_train_launches["gather"]
            k["ensemble_d_launches"] = ens_launches["gather"]
        elif k["name"] == "viterbi":
            k["vq_serve_launches"] = vq_serve_launches["viterbi"]
            k["mc_launches"] = mc_launches["viterbi"]
        elif k["name"] == "fused_infer":
            k["batched_launches"] = served["launches"]
            k["batched_dispatches"] = served["dispatches"]
        elif k["name"] == "fused_evidence":
            k["stream_launches"] = streamed["launches"]
            k["mc_launches"] = mc_launches["fused_evidence"]
        elif k["name"] == "fused_train":
            # the ensemble's epochs (phase 27), the host-fed epochs
            # (phase 28) and the GMM stack's wall times (phase 26, no
            # hand-written kernel on its path)
            k["ensemble_c_launches"] = ens_launches["fused_train"]
            for n, row in ens_timing.items():
                k[f"ensemble_epoch_ms_n{n}"] = row["wall_ms"]
                k[f"ensemble_device_ms_n{n}"] = row["device_ms"]
            k["host_fed_epoch_ms"] = prefetch_walls["prefetched"]
            k["host_fed_sync_epoch_ms"] = prefetch_walls["synchronous"]
            k.update(gmm)
        elif k["name"] == "fused_encode":
            k["cli_launches"] = reloaded["cli_launches"]
            k["head_launches"] = recipe_out["head_launches"]
            k["walkforward_launches"] = recipe_out["walkforward_launches"]
    probe_bounds = kernel_bounds(probe_model(torch, dev), 256, 512)
    entry = {"name": "fused_train_bf16", "route": "cuda",
             "source": "vqvaehmm_tpu_torch/csrc/fused_train.cu",
             "replaces": "vqvaehmm_tpu/ops/pallas_train.py:82",
             "mode": "bf16_matmuls: both operands of every product rounded "
                     "to bfloat16, float32 sums",
             "launches": c16_launches["fused_train_bf16"],
             "max_abs_err": err_c16[0], "max_grad_share_err": err_c16[1],
             "max_loss_rel_err": err_c16[2],
             "short_batches": err_c16[3],
             "ms": ttimes[("fused_train_bf16", 64, 200, True)][0],
             "plain_ms": ttimes[("fused_train_bf16", 64, 200, False)][0],
             "bound_ms": bounds["fused_train_bf16"][0],
             "bound_by": bounds["fused_train_bf16"][1],
             "fp32_bound_ms": bounds["fused_train"][0],
             "library_ms": None, "shape": "B=64 T=200",
             "device_ms": ttimes[("fused_train_bf16", 64, 200, True)][3],
             "plain_device_ms": ttimes[("fused_train_bf16", 64, 200,
                                        False)][3],
             "gather_launches": c16_launches["gather"],
             "ensemble_c_launches": c16_ens["fused_train_bf16"],
             "ensemble_d_launches": c16_ens["gather"],
             "serve_launches": c16_serve,
             "serve_max_share_err": c16_serve_err,
             "serve_viterbi_steps_differing": c16_flips,
             "train_loss_rel_err": c16_train_rel,
             "headline": headline,
             "hmma": {n: hmma[n] for n in TRAIN_KERNELS["bfloat16"]},
             "epoch_device_ms_by_kernel": c16_split,
             "device_ms_by_kernel": tsplits[("fused_train_bf16", 64, 200)]}
    for B, T in C_SHAPES[1:]:
        key = "probe" if (B, T) == C_SHAPES[-1] else f"{B}x{T}"
        entry[f"ms_{key}"] = ttimes[("fused_train_bf16", B, T, True)][0]
        entry[f"device_ms_{key}"] = ttimes[("fused_train_bf16", B, T,
                                            True)][3]
        entry[f"plain_device_ms_{key}"] = ttimes[("fused_train_bf16", B, T,
                                                  False)][3]
        b = probe_bounds if key == "probe" else kernel_bounds(model, B, T)
        entry[f"bound_ms_{key}"] = b["fused_train_bf16"][0]
        entry[f"fp32_bound_ms_{key}"] = b["fused_train"][0]
        entry[f"device_ms_by_kernel_{key}"] = tsplits[("fused_train_bf16",
                                                      B, T)]
    kernels.append(entry)
    for k in kernels:
        # phase 30: each stage's launches of the kernel in the recipe run
        k["recipe_launches"] = {s: n[k["name"]]
                                for s, n in recipe_launches.items()}
        if k["name"] == "fused_encode":
            k["zoo_calibrate_launches"] = zoo["calibrate_launches"]
        # phases 32, 33: the global-normalisation mode and its launches a
        # rank of the two-rank world
        if k["name"] in ("fused_train", "fused_train_bf16"):
            k["global_norm"] = dp_gaps["float32" if k["name"] == "fused_train"
                                       else "bfloat16"]
        if k["name"] == "fused_train":
            k["dp_step"] = dp_step
        if k["name"] in ("fused_train", "gather", "fused_infer"):
            k["dp_launches"] = {r: n[k["name"]]
                                for r, n in dp_launches.items()}
        # phase 34: each study's and reference CLI's launches
        k["study_launches"] = {e: n[k["name"]]
                               for e, n in study_launches.items()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
