#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``ate_replication_causalml_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around it; it
imports nothing of JAX. Phases, each printing one JSON line:

1. device  — the card, and ``nvidia-smi``'s name and power limit line;
2. build   — compiles every kernel library of ``csrc/`` with nvcc (sm_90a)
   and records each device function's registers and spill bytes from
   ptxas; fails if ``hist_dense``, ``partition_accumulate``,
   ``partition_accumulate_packed`` or ``leaf_sums_kernel`` (any K) spills;
3. kernels — each kernel's wrapper on card tensors at the shapes the
   DR-RF, causal forest and DML paths give it, held against its plain
   PyTorch version: ``torch.equal`` on integer weights, on route, lookup
   and pack, 64·eps·Σ|w| per (tree, channel) on float weights, and two
   launches ``torch.equal`` to each other; with CUDA-event times of the
   kernel, the plain version and a one-call PyTorch yardstick, and the
   least time the card could take (``bound_ms``), and ``factor`` = kernel
   ms / yardstick ms. ``ms`` is device time (a CUDA graph of 10 calls
   replayed, ``device_ms``); ``call_ms`` one call timed from the host,
   launch gaps included (the method of PRs 1–3). Dense, partition and the packed pass
   (``partition+pack``) are timed at every width and must give the same
   bits, K=2 integer and K=5 float; the packed rows report their slots
   and node groups per block, the partition rows their row ranges per
   cluster, features per block and ``cudaOccupancyMaxActiveClusters``,
   and the partition passes' first step (``hist.partition_sort``: the
   sort and the gather into perm order) is held ``torch.equal`` to its
   plain version at every width. The fused row passes of ``ops/tree.py``:
   ``route_advance`` at every grow width (with and without a mask, and
   the last level), ``traverse`` at the causal predict chunk and at DML's
   forest apply (leaf ids and payload), ``leaf_record`` at a classifier
   chunk, each ``torch.equal`` to its plain version, two launches equal,
   and timed beside the PyTorch sequence it replaces (``replaced_ms``,
   one replayed graph of the old route and lookup kernels and the
   elementwise ops around them). The coordinate-descent kernel
   (``ops/lasso.py::cd_path``, ``csrc/lasso.cu``) at the shapes
   the LASSO and balancing rows give it, its inputs captured from the rows' own
   ``cv_glmnet`` calls: within ``CD_PATH_BOUND`` of its plain version,
   two launches equal, bounded by the recurrence's floor (``bound_ms``)
   with the chain of the whole-dot-product order beside it
   (``order_chain_ms``). The histograms' bf16 form
   (``hist_backend="pallas_bf16"``: weights rounded to bfloat16, float32
   sums) at dense K=2 integer M=16 and 128 (bit for bit the float32
   form), the regressor's float K=2 partition M=64 and packed (the DML
   fold) M=128, and the causal K=5 float channels dense M=8, partition
   M=32 (bit for bit the dense bf16 form) and packed M=32, each held to
   its plain version (the same rounding) and timed beside the
   ``scatter_add_`` of the rounded weights. The leaf sums
   (``node_sums`` K=2 integer at 512 leaves, ``node_sums_shared`` K=5
   float at 256, ``csrc/leaf_sums.cu``) ``torch.equal`` to the dense
   route they replace (``bin_histogram_*(codes0, ids, w, n_bins=1,
   mode="dense")``; and the regressor's float K=2 weights), timed beside
   it (``replaced_ms``).
   ``pack_words`` beside its yardstick, the JAX package's own form of
   the step: one ``torch.matmul`` of the float32 codes by the pack
   matrix. The launch floor: a one-element PyTorch op in the same
   graph-replay harness, beside ``pack_words``;
4. path    — the notebook's "Doubly Robust with Random Forest PS" row at
   its configuration (120k-row synthetic pool, 50k-row sample, bias
   injection to 11,016 rows; 2,500 trees of depth 9; sandwich and
   1,000-replicate bootstrap SE), with launch counts read around it and
   τ held to its recorded value (``DR_TAU``); each path's counts of the
   row kernels are held to the counts derived from its configuration
   (``ROW_LAUNCHES``);
5. parity  — the same path at 32 trees on the card and on the CPU: split
   tables, leaves and OOB votes equal, τ within a stated bound;
6. path_cf — the notebook's "Causal Forest(GRF)" row through
   ``causal_forest_report`` at the sweep's configuration (2,000 causal
   trees of depth 8, 500 nuisance trees of depth 9, the sweep's key),
   with stage times and launch counts read around it and the ATE and SE
   held to their recorded values (``CF_ATE``, ``CF_SE``);
6b. path_serve — the CATE serving daemon (``serving/``) on the causal
   row's forest (fit again with path_cf's key): ``save_fitted`` into
   ``build/chip_smoke_serve/``, ``CateServer(ServeConfig(...)).startup()``
   on the card (buckets 1,8,64,256, a 2 ms window, depth 64: one CUDA
   graph a bucket), ``SERVE_REQUESTS`` requests of real covariate rows
   (sizes cycling through ``SERVE_SIZES``) from ``SERVE_PRODUCERS``
   threads through ``submit``, ``SERVE_SEQUENTIAL`` one at a time (the
   per-bucket latency), ``SERVE_WIRE`` through the port's client over
   ``serve_socket``, a burst past the admission depth (typed
   ``overloaded`` rejects) and a ``SERVE_CHAOS`` run (the planned
   faults, degraded mode, verified reloads); every served row bit for
   bit the offline ``predict_cate(forest, x, oob=False)`` on the card,
   ``traverse`` held to its plain version at the serving shapes and
   launched ``traverse_per_replay`` times a replay (warm-up, warm and
   every batch), no kernel build and no graph capture after warm
   (``stop()`` asserts it); prints the startup phases, p50/p99 latency
   per bucket, rows/s, the close reasons and the card's name and power
   limit;
6c. path_serve_lifecycle — path_serve's fitted checkpoint behind the
   daemon at path_serve's defaults with the admin endpoint and the trace
   on, ``tenant_b`` a second fleet model on the same file: startup's
   ``index`` phase (``leaf_index_rows`` 11,016); ``LIFECYCLE_SECONDS`` of
   seeded open-loop load (``loadgen``, ``LIFECYCLE_RATE_HZ``, path_serve's
   sizes) while ``retrain_supervisor(...).run_once()`` refits the causal
   row's forest with another key on its own stream, publishes, verifies,
   prebuilds the leaf index and swaps; ``LIFECYCLE_POST_SECONDS`` more
   load on the new version; a wire ``rotate`` to a corrupt copy
   (``refused``); ``/readyz`` and ``/healthz`` polled over HTTP; the
   ``dump`` op; ``tenant_b`` retired (``retired_model``); ``stop()``.
   Every reply bit for bit its named version's offline ``predict_cate``
   on the card, 0 builds and captures, the fit's launches path_cf's fit's,
   ``traverse`` held to its plain version (ids mode) and to 63 × (warm-up,
   warm, batches, 3 leaf-index builds), the dumped ``serving_report.json``
   and ``stat_health.json`` recomputed byte for byte; prints the startup
   phases, the fit, verify, prebuild and swap seconds, p50/p99 per bucket
   before the fit, inside the retrain window and after the swap, offered
   and achieved rates, rejects, launches, the phase's wall, the slowest
   replies and the host's garbage collections over 5 ms, each timed
   from the swap;
6d. path_serve_fleet — the serving router (``serving/router.py``) in
   this process over three daemon subprocesses (``python -m
   ate_replication_causalml_torch.serving``: b0, b1, b2, path_serve's
   checkpoint as ``default``, ``m2`` and ``m3``, path_serve's defaults,
   the kernels phase_build built, ``ATE_TPU_CHAOS`` popped), with a
   ``FLEET_PROBE_S`` probe and ``FLEET_FAILOVER`` failover hops;
   ``FLEET_REQUESTS`` seeded requests (``loadgen``, ``FLEET_RATE_HZ``,
   path_serve's sizes, three models) through the router's socket on
   ``FLEET_CLIENTS`` client connections paced by the schedule;
   ``FleetSupervisor.rotate_all`` of ``default`` to path_serve_lifecycle's
   retrained checkpoint at request ``FLEET_ROTATE_AT``; the victim that
   ``FLEET_CHAOS``'s ``daemon_kill_plan`` names SIGKILLed at
   ``FLEET_KILL_AT`` and recorded; ``dump_fleet``; the survivors shut down
   over the wire. Every reply ok and bit for bit the offline
   ``predict_cate`` on the card of the version its header names,
   ``default`` v2 served and ``m2`` / ``m3`` v2 never, every rotation
   ``rotated`` at version 2 with 0 builds and captures after its swap and
   at least two backends in rotation, the victim evicted within two probe
   intervals and the probe timeout and out of rotation in the manifest,
   ``fleet_report.json`` with no router orphan and a consistent
   reconciliation, the merged artifacts recomputed byte for byte, the
   router's ``/readyz`` 200 over HTTP, ``traverse`` held to its plain
   version at the serving shapes and launched on every daemon (from each
   daemon's ``stats``); prints each daemon's startup, the rotation's
   steps, kill to eviction, the failover and path counters, the clients'
   ``connection_lost`` resubmits, the router's e2e p50/p99 per bucket and
   the fleet report's residual gap a backend. Its files go under
   ``build/chip_smoke_fleet/``;
7. parity_cf — the same row at 32 causal and 32 nuisance trees on the
   card and on the CPU, held to stated bounds (split agreement, leaf
   statistics, τ̂ and its variance, the ATE and its SE);
8. path_cf_packed — the causal row again under the packed-code policy
   (``ATE_TPU_PREDICT_PACK=1``: its partition levels take the packed
   pass): the ATE and SE bit for bit those of path_cf, and the 32-tree
   forest of parity_cf grown again under the policy ``torch.equal`` to it;
9. path_dml — the notebook's "Double Machine Learning" row through
   ``double_ml`` at the sweep's configuration (2,000 trees of depth 9 per
   nuisance forest, the sweep's key, ``crossfit="r"``, ``se_mode="r"``)
   under ``ATE_TPU_PREDICT_PACK=1``, with stage times and launch counts,
   τ and SE held to their recorded values (``DML_TAU``, ``DML_SE``);
10. parity_dml — the DML row at 32 trees three ways: packed on the card,
   unpacked on the card, and on the CPU: forests and vote fractions
   ``torch.equal``, τ and SE bit for bit between the card runs and
   within ``TAU_BOUND`` of the CPU's;
10b. path_leaf_index — ``predict_cate``'s ``leaf_index`` and ``row_chunk``
   options on parity_cf's 32-tree card forest: ``compute_leaf_index``
   (``traverse``, leaf ids) and ``predict_cate(leaf_index=…)`` (the lookup
   kernel), with and without a ``row_chunk``, bit for bit the plain call;
11. path_ipw — the Direct Method, Propensity_Weighting,
   Propensity_Regression and "Doubly Robust with logistic regression PS"
   rows on the card (no kernel of their own), with τ, SE and the
   card-vs-CPU differences;
11b. path_lasso — the four LASSO rows (Propensity_Weighting_LASSOPS,
   Single-equation LASSO, Usual LASSO, Belloni et.al) at the sweep's
   configuration on the card and on the CPU port: fold ids held to the
   JAX package's digests, every ``cv_glmnet``'s selected indices to the
   JAX package's, τ and SE to the JAX package's values within stated
   bounds, card against CPU within the same bounds, stage walls and the
   CD kernel's launches (one per gaussian CV, Belloni's two in one, and
   one per IRLS iteration of the binomial one);
11c. path_balance — the residual_balancing row at the sweep's configuration
   (its key, 12,000 ADMM iterations) on the card and on the CPU port: each
   arm's rows, ADMM iterations, worst residual, QP and CV walls and
   cd_path launches (one an arm); fold ids and index_min held to the JAX
   package's (``BALANCE_FOLDS``, ``BALANCE_INDEX``), τ and SE to
   ``BALANCE_JAX`` and card to CPU within ``BALANCE_BOUND``;
11d. path_sweep — the whole notebook through ``pipeline.run_sweep`` at
   ``SweepConfig()`` on the card (its default device), with the
   sequential scheduler, under
   ``ATE_TPU_PREDICT_PACK=1``: every row held to the pin its phase holds
   (the oracle and naive rows to path's, DR-RF to ``SWEEP_DR_TAU``, the
   causal and DML rows bit for bit, the LASSO rows to ``LASSO_JAX``, the
   IPW rows to path_ipw's CPU rows, residual_balancing to
   ``BALANCE_JAX``), each row's wall, the kernels' launches
   (``launches_by_path["sweep"]``, row kernels to ``ROW_LAUNCHES``),
   report.json and REPORT.md parsed; then the same call again on the same
   directory: all 14 records resumed, 0 computed, 0 launches, the same
   rows;
11e. path_sweep_concurrent — the same sweep with the default scheduler
   (the concurrent engine, its default worker count, one CUDA stream a
   worker) into a fresh directory: every record bit for bit path_sweep's,
   every kernel's launches equal, ``results.jsonl``'s lines (seconds
   aside) in the same order, the pins of path_sweep held; then a
   sequential rerun on this directory and a concurrent one on
   path_sweep's, each resuming all 14 records with 0 computed and 0
   launches. Prints both walls, the worker count, each node's start and
   end offsets (the engine's spans), the overlap (the rows' and nuisances'
   seconds over the wall) and the prefetch lane's outcome. Both sweeps'
   telemetry files (``metrics.json``, ``events.jsonl``, ``metrics.prom``,
   ``trace.json``, ``overlap_report.json``) are read with plain json and
   checked (a ``sweep_stage`` span a record with the report's status,
   ``sweep_stage_total`` equal to the rows computed, each lane's busy time
   within the wall, the critical path done by the last commit,
   ``device_memory_bytes`` recorded), and their ``overlap_report.json``
   printed: the critical path, each lane's busy and wait, the sampler's
   samples and period, beside the walls;
11f. path_sweep_chaos — path_sweep's directory copied without the
   journal lines of two light rows (``CHAOS_ROWS``), swept under
   ``ATE_TPU_CHAOS=CHAOS_SPEC`` (one stage fault, one torn append): one
   failed row, the injections the spec predicts, every other record
   resumed; then a clean sweep: the torn line counted, both rows
   recomputed bit for bit path_sweep's, with their share of the launches;
11g. path_scenario_matrix — the Monte-Carlo scenario matrix
   (``scenarios/``) at the stock grid: 4 ``STOCK_DGPS`` × 6 estimators,
   the 4 ``needs_tall`` columns of ``sparse_highdim`` skipped (20
   columns), ``SCENARIO_REPS`` replicates in width-``SCENARIO_WIDTH``
   blocks, seed 0, into ``build/chip_smoke_scenarios/``: aggregate mode on
   the default (concurrent) engine; a rerun (0 computed, 0 launches, 0
   builds); an extension to ``SCENARIO_EXT_REPS`` (one new block a
   vmapped column, 16 new cells an aipw_rf column, 0 builds); rows mode
   and aggregate mode on the sequential engine at the extended count; the
   scalar replay of the first ``SCENARIO_REPLAY_REPS``. Every streaming state equals
   ``fold_rows`` of the rows run and the sequential run's bit for bit
   (all 18 sums); batched against scalar replay exact for naive and
   within ``MAX_VMAP_COLLAPSE_ULP`` elsewhere; calibration coverage
   within 3 MC standard errors of 95%; every run's launches equal
   ``scenario_launches`` (the aipw_rf cells' hist_dense K=2, node_sums,
   route_advance and leaf_record; one cd_path a lasso block); one block
   of each ``SCENARIO_CPU_COLUMNS`` recomputed on the CPU port: draws
   ``torch.equal``, estimates within ``SCENARIO_CPU_BOUND`` (the lasso
   column's within ``CD_PATH_BOUND`` on W's scale); each lasso column's
   one ``cd_path`` launch of a block (352 fits, p = 5 or 385) held within
   ``CD_PATH_BOUND`` of ``cd_path_plain`` on the card at its own inputs.
   Prints the walls, per-column seconds and the launches;
11h. path_frontier — ``run_frontier(FRONTIER_SPEC)`` (the micro search;
   ``default_frontier_spec(0)`` put the script over its time) into
   ``build/chip_smoke_frontier/``, then again: the atlas byte for byte, no
   journaled probe computed again (only the failures' fresh
   confirmations), 0 launches; the known corner among the failures,
   shrunk to both knobs; the first failure's ``--repro`` line through the
   port's CLI in a subprocess prints ``failing``;
11i. path_chaos_campaign — the chaos campaign (``resilience/campaign.py``,
   ``resilience/invariants.py``) on the card, into
   ``build/chip_smoke_campaign/``: the default plan ``run_campaign(root_seed=7,
   n_episodes=4, scale="micro")`` (sweep, matrix, serving, rotation, each
   against its fault-free reference) held to the committed
   ``CHAOS_CAMPAIGN.json`` (its 4 specs and workloads, all green,
   invariant checks pass 20 / skip 16 / fail 0), the sweep episodes'
   kernels launched, each held to its plain version on the inputs the
   plan gave it (``kernel_taps``: the first call at each distinct shape,
   checked after the counts are read) and ``traverse`` on the serving
   forest at 4 rows and 1, 0 builds in every serving window; one ``fleet``
   episode (three daemon processes on the card, a ``daemon:`` SIGKILL, a
   rolling rotation) with ``fleet_failover`` passing; the planted
   ``tamper:journal`` matrix episode (``TAMPER_SEED`` / ``TAMPER_ATOMS``)
   detected, shrunk to the tamper atom alone, and its repro line, run as a
   subprocess, exiting 1 with ``bit_identity`` failing again and no
   traceback. Prints each episode's wall, the references', the fleet's,
   the shrink's probes and wall (from each run's ``campaign_walls.json``),
   the kernel checks and the launches;
11j. path_multi_gpu — the multi-GPU layer (``parallel/``: one rank a
   card on ``torch.distributed``) on this one card, into
   ``build/chip_smoke_multi_gpu/``. The kernels are built here first; the
   ranks only load them (``ATE_TPU_KERNELS_PREBUILT``); the two worlds run at
   once (their ranks are launch-bound). (a)
   ``dryrun_multigpu(1, "nccl", "cuda", sweep=False)``: a one-rank NCCL
   group runs the dry run's legs at its own shapes (data-sharded IRLS,
   the boot-sharded bootstrap, the tree-sharded forest and causal
   forest, the fold-sharded CV; its ``run_sweep(use_mesh=True)`` leg at
   MICRO is (b)'s, which runs that sweep and resumes it). (b) two ranks
   sharing the card under gloo, at the notebook's widths: DR-RF's
   ``MG_DR_TREES`` (500) trees of depth 9 tree-sharded; the causal
   forest (``MG_CF_TREES``, 400, of depth 8, 500 nuisance trees) and its
   row-sharded leaf index (both cut from the rows' 2,500 and 2,000 to make
   room for later phases; the gates hold at any count); the LASSO-PS
   ``cv_glmnet`` (10 folds, 100 λs) fold-sharded; the AIPW bootstrap
   boot-sharded; the two IRLS fits in float64 data-sharded;
   ``run_sweep(use_mesh=True)`` at MICRO on the concurrent engine, then
   resumed on the sequential one; the scenario matrix with ``shard=True``
   (calibration at n = 64 × naive, 8 replicates). Gates: each forest
   (and the leaf index) equal by sha256 to the one-process grow, on the
   card, of the ranks' key slices; the CV's ``index_min``, ``index_1se``
   and ``cvm`` equal to the unsharded CV; the taus equal to the
   one-process draws from ``fold_in(key, r)``; each IRLS fit within the
   derived |Δβ| ≤ 2κγ_n|β|/(1 − κγ_n) of the one-process fit, in as many
   iterations; the sweep's rows in order, finite, equal on both ranks,
   rank 0's journal lines alone, the resumed run 0 computed with the same
   rows; the sharded matrix at max_ulp 0; ``hist``, ``hist_shared``,
   ``route_advance``, ``leaf_record``, ``traverse`` and ``cd_path``
   launched in the ranks, and every call tapped in (a) and in (b)'s
   rank 0 (rank 1 runs the same program on its own keys) held to its plain
   version in its rank after the counts are read; the phase within
   ``MULTI_GPU_BUDGET_S``. The launches of (a) and both ranks of (b)
   are ``launches_by_path["multi_gpu"]``;
11k. path_matmul_growers — the JAX package's matmul backends
   (``hist_backend`` "xla" and "onehot", ``row_backend="matmul"``) at the
   notebook's widths (11,016 × 21, 64 bins), ``MATMUL_TREES`` trees (cut
   from 2,500 / 500 / 2,000) of depth 9, the causal forest of depth 8
   through ``fit_causal_forest`` (64 nuisance trees of depth 9), each
   beside the kernel grower ("auto") on the same key. The port grows and
   predicts them on its kernels: the classifier and the regressor (on a
   seeded continuous target, x0 plus a standard normal) are the
   streaming grower's forests, every field ``torch.equal``; the causal
   forest is the direct-ρ grower, equal under both names, its nuisances
   equal to "auto"'s, its split agreement with the streaming grower's ≥
   ``MATMUL_SPLIT_AGREEMENT`` (the whole table, the JAX package's
   measure; live nodes printed) and its CATE gap (mean |Δ| / mean |·|)
   below ``MATMUL_CATE_GAP``; ``predict_cate(row_backend="matmul")``
   ``torch.equal`` to the default with ``oob`` True and False. Every
   kernel of ``MATMUL_KERNELS`` launched in those fits and predicts, and
   each tapped call held to its plain version after the counts are read.
   Prints each wall beside the kernel grower's, and the split agreement
   of the CPU port's first ``MATMUL_CPU_TREES`` trees with the card's
   (same backend and key; classifier gated at 1.0);
11k'. path_pallas_backends — the JAX package's explicit Pallas names at
   the same widths and tree counts: the classifier, the regressor and the
   causal fit (its nuisance regressors included) under "pallas", each bit
   for bit path_matmul_growers' "auto" fit, and under "pallas_bf16" (the
   split search's histograms in their bf16 form: weights rounded to
   bfloat16, float32 sums), whose classifier is bit for bit "auto"; the
   bf16 regressor and causal fit again under the packed policy, bit for
   bit the unpacked ones; every bf16 kernel form (``BF16_KERNELS``)
   launched and each tapped call held to its plain version (the same
   rounding) after the counts are read; "pallas_interpret" (the plain
   CPU versions) refused for card tensors by the classifier, the causal
   fit and ``predict_cate``. Prints the walls, the bf16 regressor's and
   causal forest's split agreement with "auto", the bf16 CATE gap and
   the ATE and SE of "auto", "pallas" and "pallas_bf16", none gated;
11l. path_rbridge — the port's reticulate bridge on the card: the
   notebook's ``df_mod`` as a dict of Python float lists, every function
   the R shim calls (doubly_robust at ``RBRIDGE_DR_TREES`` trees,
   double_ml at ``RBRIDGE_DML_TREES``, causal_forest at
   ``RBRIDGE_CF_TREES``), the counts read after the bridge's calls; then
   each row (and propensity vector) equal bit for bit to the direct port
   call with the same keys; the kernels the DR-RF and causal rows launch
   tapped (``kernel_taps``) and held to their plain versions at those
   inputs; ``run_notebook_sweep(quick=True)`` at ``RBRIDGE_SWEEP`` (the
   MICRO sweep's overrides as R floats) under
   ``ATE_TPU_SWEEP_SEQUENTIAL=1``: its configuration the MICRO sweep's
   (``micro_sweep_config()``), its rows the oracle and one a method, in order,
   each finite (path_sweep holds ``run_sweep``'s rows themselves);
11m. path_native — the native host library (``native/``): its build's
   seconds and ``native_status()``; a CSV of the synthetic 120,000-row
   pool in the GGL schema's raw columns with ``NATIVE_PLANTED`` NA and
   blank cells (``build/chip_smoke_native/``): ``load_raw_csv`` through
   the C++ reader equal to the NumPy reader, NaN-aware and bit for bit,
   each reader's wall; ``sample_n_rows(120,000, 50,000)`` from the C++
   RNG equal to the Python one for both ``sample_kind``s;
   ``prepare_dataset(load_raw_csv(csv))`` → ``inject_bias`` on the card
   equal to the in-memory path on the same cells;
11n. path_static — the port's static analysis held to the card:
   (a) ``scripts/torch_check_static.sh`` from a fresh cache (exit code,
   the rule count, findings — 0 — and suppressions by rule, from the
   warm JSON report); (b) under ``torch.cuda.set_sync_debug_mode("warn")``
   a 16-tree depth-9 classifier forest and a 16-tree causal-forest group
   at the notebook's widths, one ``predict_cate`` and ``STATIC_REPLAYS``
   warmed replays at buckets 1 and 256, each synchronizing call recorded
   at its nearest frame in the package (``sync_sites``, file:line with
   counts): every site inside the hot-path table (``analysis/torchast.py::
   HOT_PATH`` and what TGL003 reaches from it) must be a TGL003 finding,
   suppressed in the tree with its reason; the rest are printed; (c) after
   every earlier path, the TF32 pins still hold (both ``allow_tf32``
   False, float32 matmul precision ``"highest"``). The lint runs in a
   subprocess beside (b), and the phase's launches count like a path's;
11o. path_public_surface — the JAX package's public import surface on
   the port: every name of the package's, ``estimators``',
   ``observability``'s and ``serving``'s ``__all__`` resolved, no jax
   loaded; then the DR-RF row's propensity forest (``DR_TREES`` trees of
   depth 9 at the notebook's widths, its key) fit again, and
   ``lower_predict_forest`` warmed at the full panel and at a
   ``PUBLIC_BUCKET``-row bucket: ``PUBLIC_CALLS`` calls each on host
   queries, every reply bit for bit the eager ``predict_forest`` on the
   card, one ``traverse`` launch a replay, one capture and no build after
   the warm-up, each call's syncs only the query's copy in and the reply's
   read (TGL003 sites of ``WarmGraph._host``), a query of another shape
   refused; the fit's and the predicts' kernels tapped and held to their
   plain versions after the counts are read. Prints the fit, eager, warm,
   capture and per-call walls and each replay's device time;
11p. path_1m — the JAX system's 1M-row configuration
   (``scripts/torch_stage_time_1m.py``, imported) at full width and cut
   depth: ``make``'s panel at ``PATH_1M_ROWS`` × 21 (64 bins), the six
   stages with ``PATH_1M_NUISANCE_TREES``-tree regressors of depth 9 and a
   ``PATH_1M_TREES``-tree causal forest of depth 8, the leaf index, the OOB
   predict with variance through it and without it, and the Poisson AIPW on
   ``make_panel`` with ``PATH_1M_BOOT`` replicates through "auto" (its chunk
   rule: 125 a chunk). Gates: (a) every kernel launch tapped and held to its
   plain version at the path's inputs, the launches equal to those derived
   from the configuration (``path_1m_launches``); (b) the cached predict
   equal to the routed one bit for bit, the card's Poisson counts of a
   (2, 1M) draw equal to the CPU port's, both panels equal to the CPU
   port's draws (a subprocess started after the build draws them on two
   cores beside the earlier phases); (c) |ATE −
   1.5| ≤ ``PATH_1M_ATE_BOUND`` and the bootstrap SE within
   ``PATH_1M_SE_REL`` of the plug-in SE; (d) each stage's wall, peak
   device memory and launches printed; (e) the phase within
   ``PATH_1M_BUDGET_S``. Also prints each pure kernel's device ms at the
   path's inputs (``device_ms_1m``, after the taps are held);
12. stages  — each partition row's device time by kernel (``stage_ms``:
   the sort, the gather, the accumulate pass and any second pass, from
   ``torch.profiler``) and the device activities of one ADMM iteration,
   late: a process that has run the profiler
   launches kernels more slowly afterwards;
13. path_xprof — ``ATE_TPU_XPROF`` at the MICRO sweep's configuration
   (``micro_sweep_config()``), last: a sweep, then its directory without
   ``XPROF_ROWS``' journal lines swept again under the whole-run
   ``torch.profiler`` capture with the default scheduler: the knob forces
   the sequential sweep, the Chrome trace holds each recomputed row's
   ``record_function`` range and launches of ``XPROF_KERNELS``, the rows
   equal the first sweep's.

Then the kernel summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. Details go to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import hashlib
import importlib
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import warnings
import zlib

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Imported after the path is set; in a directory without the package
# this fails, and the script exits non-zero with no result.
from ate_replication_causalml_torch import observability as obs  # noqa: E402
from ate_replication_causalml_torch import pipeline  # noqa: E402
from ate_replication_causalml_torch.data.pipeline import PrepConfig, inject_bias, prepare_dataset  # noqa: E402
from ate_replication_causalml_torch.data.synthetic import make_ggl_like  # noqa: E402
from ate_replication_causalml_torch.estimators.aipw import (  # noqa: E402
    doubly_robust,
    doubly_robust_glm,
    outcome_model_mu,
)
from ate_replication_causalml_torch.estimators import balance  # noqa: E402
from ate_replication_causalml_torch.estimators import lasso_est  # noqa: E402
from ate_replication_causalml_torch.estimators.causal_forest_est import causal_forest_report  # noqa: E402
from ate_replication_causalml_torch.estimators import dml  # noqa: E402
from ate_replication_causalml_torch.estimators.ipw import (  # noqa: E402
    logistic_propensity,
    prop_score_ols,
    prop_score_weight,
)
from ate_replication_causalml_torch.estimators.naive import naive_ate  # noqa: E402
from ate_replication_causalml_torch.estimators.ols import ate_condmean_ols  # noqa: E402
from ate_replication_causalml_torch.kernels import build  # noqa: E402
from ate_replication_causalml_torch.models import causal_forest as cf  # noqa: E402
from ate_replication_causalml_torch.models import forest as fo  # noqa: E402
from ate_replication_causalml_torch.ops import hist, lasso, pack, qp, tree  # noqa: E402
from ate_replication_causalml_torch.ops import random as rnd  # noqa: E402
from ate_replication_causalml_torch.ops.bootstrap import _poisson1_counts  # noqa: E402
from ate_replication_causalml_torch.ops.linalg import alias_filter  # noqa: E402
from ate_replication_causalml_torch.observability import serving_report as sreport  # noqa: E402
from ate_replication_causalml_torch.observability.export import (  # noqa: E402
    atomic_write_json,
    atomic_write_text,
)
from ate_replication_causalml_torch.observability import stathealth  # noqa: E402
from ate_replication_causalml_torch.resilience import chaos  # noqa: E402
from ate_replication_causalml_torch import scenarios as sc  # noqa: E402
from ate_replication_causalml_torch.scenarios import frontier as fr  # noqa: E402
from ate_replication_causalml_torch.scenarios.batched import compile_event_count  # noqa: E402
from ate_replication_causalml_torch.serving import loadgen  # noqa: E402
from ate_replication_causalml_torch.serving.client import CateClient  # noqa: E402
from ate_replication_causalml_torch.serving.coalescer import BucketPlan  # noqa: E402
from ate_replication_causalml_torch.serving.daemon import (  # noqa: E402
    CateServer,
    RejectedRequest,
    ServeConfig,
    serve_socket,
)
from ate_replication_causalml_torch.utils.checkpoint import load_fitted, save_fitted  # noqa: E402

# The estimators package exports the function belloni under its module's name.
bel = importlib.import_module("ate_replication_causalml_torch.estimators.belloni")

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # non-tensor-core float32; integer compares counted at it too

# The notebook row's configuration (SweepConfig defaults).
POOL_ROWS, POOL_SEED, TRUE_ATE = 120_000, 0, 0.095
DR_TREES, DEPTH, N_BINS, N_BOOT = 2_500, 9, 64, 1_000
PARITY_TREES = 32
BIG_ROWS = 1_000_000  # bench.py's forest rows
# Card vs CPU, τ and sandwich SE: the f32 IRLS and AIPW sums reassociate.
# Observed on an H100 80GB HBM3 at 700 W: |Δτ| 2.46e-7, |Δse| 1.9e-9.
TAU_BOUND = 1e-6
# The DR-RF row's τ as first recorded on the card (the atomic histogram
# kernel): integer histogram weights are exact in any order, so the
# ordered kernels must give it bit for bit.
DR_TAU = 0.0028399527072906494
# The "Causal Forest(GRF)" row (SweepConfig: cf_trees, cf_nuisance_trees,
# forest_depth for the nuisances; grow_causal_forest's depth 8, 64 bins,
# ci_group_size 2, min_node 5, sample_fraction 0.5, honesty on).
CF_TREES, CF_DEPTH, CF_NUISANCE_TREES = 2_000, 8, 500
CF_PARITY_TREES = 32
# Float histogram sums: the kernel adds each cell's rows in ascending
# order per row range, the plain version (index_add_, float atomics on
# the card) in its own order: |Δ| ≤ FLOAT_ULPS·eps·Σ|w| per (tree,
# channel). Observed on an H100 80GB HBM3 at 700 W: at most 8.6·eps·Σ|w|
# (K=5 shared, M=1, the w̃² channel, where a binary covariate puts about
# a quarter of the rows in one cell).
FLOAT_ULPS = 64
EPS32 = float(np.finfo(np.float32).eps)
# Card vs CPU port, causal row at 32 trees (see phase_parity_cf).
# Observed on an H100 80GB HBM3 at 700 W: split agreement 0.99277, leaf
# statistics on agreeing paths 3.5e-6 relative, τ̂ 0.117 and variance
# 0.040 relative at the worst row, |ΔATE| 3.1e-4, |ΔSE| 1.7e-5.
CF_SPLIT_AGREEMENT = 0.97
CF_LEAF_REL = 2e-5
CF_TAU_BOUND = 0.5
CF_TAU_MEAN_BOUND = 0.01
CF_ATE_BOUND = 2e-3
CF_SE_BOUND = 1e-4
# The causal row's ATE as first recorded on the card with the ordered
# kernels; every kernel and reduction on its path runs in a fixed order,
# so it must hold bit for bit, under the packed policy too.
CF_ATE = 0.10669395327568054
CF_SE = 0.014757290482521057
# The "Double Machine Learning" row (SweepConfig: dml_trees, forest_depth).
DML_TREES = 2_000
DML_PARITY_TREES = 32
# The DML row's τ and SE as first recorded on the card (packed policy):
# integer histogram weights and fixed-order reductions, so bit for bit.
DML_TAU = 0.07885216176509857
DML_SE = 0.010522110387682915
# Direct Method and the propensity rows, card vs CPU port: f32 IRLS and
# normal equations in another summation order, amplified by 1/(p(1−p)).
# Observed on an H100 80GB HBM3 at 700 W: |Δτ| at most 6.0e-7
# (Propensity_Regression), |Δse| at most 3.7e-9.
IPW_BOUND = 5e-6
# The LASSO rows as the JAX package computes them on the CPU at this
# configuration (float32; ``JAX_PLATFORMS=cpu python scripts/torch_parity.py
# --rows lasso``, its "jax" side): fold ids (sha256 of the int64 ids, first
# 16 hex digits) and (index_min, index_1se) of each cv_glmnet, τ and SE.
LASSO_FOLDS = {"ps_lasso": "87afa6469388dd4d", "seq_lasso": "b35183f89db90569",
               "usual_lasso": "19317ecdbe296609", "belloni_xw": "da74d1dde33fa74b",
               "belloni_xy": "65104c64398d10f7"}
LASSO_INDEX = {"ps_lasso": (35, 17), "seq_lasso": (47, 25), "usual_lasso": (46, 27),
               "belloni_xw": (41, 30), "belloni_xy": (35, 23)}
LASSO_JAX = {"Propensity_Weighting_LASSOPS": (-0.005371916573494673, 0.01176401600241661),
             "Single-equation LASSO": (0.08433466404676437, math.nan),
             "Usual LASSO": (0.044370125979185104, math.nan),
             "Belloni et.al": (0.10991007089614868, 0.01186330895870924)}
# |Δτ| and |ΔSE| against LASSO_JAX, and card against CPU port. The
# coordinate descent stops once max_j G_jj·Δβ_j² < 1e-7, so two runs whose
# dot products round differently can stop a sweep apart: path coefficients
# then differ by up to ~sqrt(1e-7)·ys/xs (the CPU port against the JAX
# package: 6.3e-6 on the two p = 22 paths, 6.8e-5 on the binomial one).
# The outcome rows read W's coefficient (|Δτ| 3.9e-6 seen); LASSOPS
# carries the binomial path through 1/(p(1−p)) (1.2e-5 seen); Belloni's τ
# is an OLS on the selected support, held equal, so only the f32 OLS
# remains (5.2e-7 seen).
LASSO_BOUND = {"Propensity_Weighting_LASSOPS": 1e-4, "Single-equation LASSO": 5e-5,
               "Usual LASSO": 5e-5, "Belloni et.al": 1e-5}
# The residual_balancing row (SweepConfig.balance_iters ADMM iterations)
# as the JAX package computes it on the CPU at this configuration
# (float32 frame, float64 ADMM; ``JAX_PLATFORMS=cpu python
# scripts/torch_parity.py --rows balance``, its "jax" side): each arm's fold
# ids (digest as LASSO_FOLDS) and index_min, τ and SE. The JAX package's
# ADMM stops the treated arm (2,077 rows) at 729 iterations, the control
# arm (8,939 rows) at 284.
BALANCE_ITERS = 12_000
BALANCE_FOLDS = {"treated": "d8d0cda7590799bb", "control": "973ba1d3fb4f0653"}
BALANCE_INDEX = {"treated": 37, "control": 44}
BALANCE_JAX = (0.10578039288520813, 0.013546153903007507)
# |Δτ| and |ΔSE| against BALANCE_JAX, and card against CPU port. γ is the
# float64 ADMM iterate, which stops at the first iteration with both
# residuals under 1e-7 (the treated arm 5e-12 under it), so a stop an
# iteration apart moves γ by about the tolerance; the target is a float32
# mean summed in another order (37 ulps, 1.1e-8 here); and the arm's
# elastic net comes from coordinate descent that stops a sweep apart
# (LASSO_BOUND's reason: path coefficients up to ~6e-6 apart). μ = target·β
# + γ·resid is first-order insensitive to β where γ balances X, so the
# bound is LASSO_BOUND's order. Seen: the CPU port against the JAX package
# |Δτ| 2.7e-7, |ΔSE| 0.
BALANCE_BOUND = 5e-5
# The sweep's "Doubly Robust with Random Forest PS" row: its forest's key
# is the sweep's fold_in(key(0), crc32("dr_rf_prop")), not DR_TAU's
# key(12325); τ as first recorded on the card (integer histogram weights
# and fixed-order reductions, so bit for bit).
SWEEP_DR_TAU = 0.04571865499019623
# The sweep's output directories (the results journal, report.json,
# REPORT.md): path_sweep's sequential run and path_sweep_concurrent's.
SWEEP_OUT = os.path.join(REPO, "build", "chip_smoke_sweep")
SWEEP_CONC_OUT = os.path.join(REPO, "build", "chip_smoke_sweep_concurrent")
SWEEP_CHAOS_OUT = os.path.join(REPO, "build", "chip_smoke_sweep_chaos")
XPROF_OUT = os.path.join(REPO, "build", "chip_smoke_xprof")
# The telemetry files run_sweep(outdir=...) writes beside report.json.
TELEMETRY = ("metrics.json", "events.jsonl", "metrics.prom", "trace.json", "overlap_report.json")
# path_sweep_chaos: two light rows dropped from path_sweep's journal, the
# second made to fail and the first's append torn. Their share of the
# launches: one cd_path each (the path_lasso phase's per-row counts).
CHAOS_ROWS = ("Single-equation LASSO", "Usual LASSO")
CHAOS_SPEC = "stage:fail=Usual LASSO;fs:torn_write"
CHAOS_ROWS_LAUNCHES = {"cd_path": 2}
# path_xprof: the rows recomputed under the whole-run profiler at
# SweepConfig().quick(), kept small: the quick balancing row's ADMM takes
# 2,623 iterations of ~1,220 kernels (CPU port count), too many events
# for one Chrome trace.
XPROF_ROWS = ("Direct Method", "Doubly Robust with Random Forest PS")
XPROF_KERNELS = ("route_advance_kernel", "hist_dense")
# The CD kernel against its plain version at the rows' inputs (threshold
# 1e-7): a standardized coefficient's last move is below sqrt(1e-7/G_jj)
# ≈ 3.2e-4 (G_jj ≈ 1), so two runs that stop a sweep apart differ by about
# that; 3× for the geometric tail of the following λs' warm starts.
CD_PATH_BOUND = 1e-3
# Belloni's path is compared with the plain version on two windows of
# λs only (the plain version is ~12 launches per coordinate update at p =
# 462): the first λs, where almost every coefficient is 0, and λs 50–59,
# warm-started from the kernel's λ 49, where the 138-column support forms.
CD_PLAIN_WINDOWS = ((0, 10), (50, 60))
# The CD kernel's floor (csrc/lasso.cu): each update depends on the one
# before, and the recurrence itself needs 11 dependent steps an update at
# any p: the fused multiply-add of the newest coordinate's term, c_j − s,
# + G_jj·β_j, the soft threshold's subtract and max, copysign, and a
# division of at least 5. Each is taken at the float32 pipe's 4-cycle
# dependent-issue latency, at the card's maximum SM clock (nvidia-smi
# clocks.max.sm), times the longest fit's updates.
RECURRENCE_STEPS = 11
CHAIN_CYCLES_PER_STEP = 4
# The chain of the order that keeps G_j·β whole on it (the kernel's first
# form), printed beside it as ``order_chain_ms``:
# G_j·β summed whole on the chain, ceil(p/32) fused multiply-adds, a
# 5-step butterfly of a shuffle and an add (10), and the scalar update
# with β_j's store and load across the warp barrier (12).
CHAIN_FIXED_STEPS = 10 + 12

# path_serve: the daemon at its defaults (buckets 1,8,64,256, a 2 ms window,
# depth 64) on path_cf's forest; request sizes cycle so every bucket
# serves; 4 producer threads, then requests one at a time (each rides its
# own bucket: the per-bucket latency), the port's client over a socket,
# one burst past the admission depth, one chaos run of SERVE_CHAOS.
SERVE_BUCKETS = "1,8,64,256"
SERVE_SIZES = (1, 3, 8, 17, 64, 100, 256)
SERVE_REQUESTS, SERVE_PRODUCERS, SERVE_SEQUENTIAL = 504, 4, 56
SERVE_WIRE, SERVE_CHAOS_REQUESTS = 24, 40
SERVE_CHAOS = "serve:p=0.25,seed=11"
SERVE_CKPT = os.path.join(REPO, "build", "chip_smoke_serve", "forest.npz")
# path_serve_lifecycle: path_serve's daemon and checkpoint (with a second
# fleet model on the same checkpoint), seeded open-loop load at
# LIFECYCLE_RATE_HZ for LIFECYCLE_SECONDS over path_serve's request sizes,
# a retrain started LIFECYCLE_RETRAIN_AFTER_S into it, then
# LIFECYCLE_POST_SECONDS more of the same load once the swap is done. The
# load outlasts a retrain slowed by it (24-30 s on the H100, the fit 20-27
# of them), and the seconds before the fit and after the swap are equal,
# so the latency outside the retrain has a sample of the same order as
# inside it.
LIFECYCLE_SEED = 2024
LIFECYCLE_RATE_HZ = 100.0
LIFECYCLE_SECONDS = 42.0
LIFECYCLE_POST_SECONDS = 8.0
LIFECYCLE_RETRAIN_AFTER_S = 8.0
LIFECYCLE_OUT = os.path.join(REPO, "build", "chip_smoke_lifecycle")
# path_serve_fleet: three daemon subprocesses on path_serve's checkpoint
# (m2 and m3 fleet models on the same file) behind the router in this
# process; FLEET_REQUESTS seeded requests at FLEET_RATE_HZ over path_serve's
# sizes and three models, sent through the router's socket on
# FLEET_CLIENTS connections; rotate_all to path_serve_lifecycle's retrained
# checkpoint at FLEET_ROTATE_AT, FLEET_CHAOS's victim SIGKILLed at
# FLEET_KILL_AT. Seed 0 draws b2, the ring owner of "default" and "m3", so
# the kill lands on traffic.
FLEET_NAMES = ("b0", "b1", "b2")
FLEET_SEED = 1414
FLEET_REQUESTS, FLEET_RATE_HZ, FLEET_CLIENTS = 2400, 100.0, 4
FLEET_ROTATE_AT, FLEET_KILL_AT = 1200, 1800
FLEET_CHAOS = "daemon:kill=1,seed=0"
FLEET_PROBE_S, FLEET_FAILOVER = 0.05, 2
FLEET_MODELS = ("default", "m2", "m3")
FLEET_OUT = os.path.join(REPO, "build", "chip_smoke_fleet")

# path_scenario_matrix: the stock grid (4 DGPs x 6 estimators, the 4
# needs_tall columns of sparse_highdim skipped: 20 columns), 32
# replicates (one width-32 block), extended to 48 (a second, half-full
# block: the streaming blocks [0, 32) and [32, 48) are fold_rows' own
# segments at width 32); the scalar replay over the first
# SCENARIO_REPLAY_REPS replicates of the vmapped columns (all cut for the
# script's time on a slow host, PERF.md §4: the extension still adds one
# block a column, and the replay reaches every vmapped column); one
# block of each SCENARIO_CPU_COLUMNS recomputed on the CPU port, its
# estimates within SCENARIO_CPU_BOUND·(1 + |card|) of the card's (float32
# GLM sums in the devices' orders; the draws are torch.equal). A lasso
# column's estimate is W's coefficient, its standardized value ·ys/xs_W:
# the CPU's plain coordinate descent against the card's kernel is held
# within CD_PATH_BOUND·ys/xs_W, the kernel's own bound on that scale.
# Every lasso column's one block (its one cd_path launch of 352 fits, each
# lane's own Grams, p = 5 or 385) is also held to cd_path_plain on the
# card at those inputs, as cd_rows holds the rows' launches (p = 385 on
# CD_PLAIN_WINDOWS, p = 5 on the whole path).
SCENARIO_ESTIMATORS = ("naive", "ols", "ipw_logit", "aipw_logit", "lasso", "aipw_rf")
SCENARIO_REPS = 32
SCENARIO_EXT_REPS = 48
SCENARIO_WIDTH = 32
SCENARIO_REPLAY_REPS = 8
SCENARIO_CPU_COLUMNS = ("hetero_confounded:aipw_logit", "calibration:aipw_rf",
                        "calibration:lasso")
SCENARIO_CPU_BOUND = 1e-5
SCENARIO_OUT = os.path.join(REPO, "build", "chip_smoke_scenarios")
# path_frontier: the micro search (the overlap × confounding corners for
# ipw_logit, n = 96, 16 → 48 replicates). default_frontier_spec(0), the
# committed atlas's search, takes 78-88 s and its resume 21-25 s on an H100
# (PERF.md), which puts this script over its time budget.
FRONTIER_SPEC = fr.micro_frontier_spec(0)
FRONTIER_OUT = os.path.join(REPO, "build", "chip_smoke_frontier")

# path_chaos_campaign: the committed record of the JAX package's default
# campaign, and the JAX tests' planted tamper episode.
CAMPAIGN_RECORD = os.path.join(REPO, "CHAOS_CAMPAIGN.json")
CAMPAIGN_OUT = os.path.join(REPO, "build", "chip_smoke_campaign")
TAMPER_SEED = 17
TAMPER_ATOMS = (("fs", "fs:torn_write,times=1"), ("stage", "stage:fail=naive#b0,times=1"),
                ("tamper", "tamper:journal,times=1"))
# The default plan's kernels: the sweep episodes' (MICRO: depth 4; the
# partition pass from the crossover width on) and the predicts' traverse.
CAMPAIGN_KERNELS = ("hist", "hist_shared", "hist_partition", "hist_partition_shared",
                    "node_sums", "node_sums_shared", "route_advance", "traverse", "leaf_record",
                    "cd_path")

RECORD: dict = {}
T_START = time.perf_counter()
# Rows of the path phases that the sweep's rows are held to.
ROWS: dict = {}


def emit(obj: dict) -> None:
    """Print a phase's line, stamped with the seconds since the script
    started (``at_s``: a phase's wall is the step from the line before)."""
    obj["at_s"] = time.perf_counter() - T_START
    print(json.dumps(obj), flush=True)
    RECORD.setdefault("lines", []).append(obj)


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of one call, after one warm-up call."""
    fn()
    sync()
    pairs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    sync()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def capture(fn, calls: int) -> torch.cuda.CUDAGraph:
    """``calls`` calls of ``fn`` captured in one CUDA graph (after a warm-up
    call on the current and on a side stream), replayed once."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    sync()
    return graph


def device_ms(fn, calls: int = 10, reps: int = 10) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph,
    replayed ``reps`` times between two events, so no host launch gap
    enters (``time_ms`` times one call from the host, gaps included)."""
    graph = capture(fn, calls)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    sync()
    return a.elapsed_time(b) / (calls * reps)


# Device functions a histogram call launches, in match order (a name may
# contain an earlier one).
STAGES = ("partition_accumulate_packed", "partition_accumulate", "partition_rows",
          "partition_gather", "hist_reduce", "hist_dense")


# (partition row, its call): profiled by phase_stages, after the paths,
# because a process that has run torch.profiler launches kernels more
# slowly afterwards, and the paths' walls would show it.
SPLITS: list = []


def stage_ms(fn, calls: int = 10) -> dict:
    """Device ms per call of each kernel one call of ``fn`` launches, by
    device function (``STAGES``; anything else as "other"): device
    activities from ``torch.profiler`` over one replay of a CUDA graph of
    ``calls`` calls ("source": "graph"), or over ``calls`` calls launched
    one by one where the trace shows no kernel of the graph ("eager")."""
    graph = capture(fn, calls)

    def profiled(run) -> dict:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            sync()
        us: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = next((st for st in STAGES if st in e.name), "other")
                us[name] = us.get(name, 0.0) + e.time_range.elapsed_us()
        return us

    us, source = profiled(graph.replay), "graph"
    if not any(st in us for st in STAGES):
        us, source = profiled(lambda: [fn() for _ in range(calls)]), "eager"
    return {"source": source, **{k: v / 1e3 / calls for k, v in sorted(us.items())}}


def timed(row: dict, run, lib, calls: int = 10) -> dict:
    """The device times of a kernel call and its yardstick, and their
    ratio ``factor``; ``call_ms`` and ``call_library_ms`` are one call's
    host-side event times (the method of PRs 1–3's tables)."""
    ms, library_ms = device_ms(run, calls), device_ms(lib, calls)
    row.update(ms=ms, library_ms=library_ms, factor=ms / library_ms)
    return row


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


COUNTERS = {  # kernel name -> (wrapper, its counter for that kernel)
    "hist": (hist.bin_histogram_batched, "launches"),
    "hist_partition": (hist.bin_histogram_batched, "partition_launches"),
    "hist_shared": (hist.bin_histogram_shared, "launches"),
    "hist_partition_shared": (hist.bin_histogram_shared, "partition_launches"),
    "node_sums": (hist.node_sums, "launches"),
    "node_sums_shared": (hist.node_sums_shared, "launches"),
    "route": (tree.route_bits, "launches"),
    "lookup": (tree.table_lookup, "launches"),
    "hist_partition_packed": (hist.bin_histogram_batched, "packed_launches"),
    "hist_partition_shared_packed": (hist.bin_histogram_shared, "packed_launches"),
    "pack_codes": (pack.pack_codes, "launches"),
    "route_advance": (tree.route_advance, "launches"),
    "traverse": (tree.traverse, "launches"),
    "leaf_record": (tree.leaf_record, "launches"),
    "cd_path": (lasso.cd_path, "launches"),
    # The bf16 form of the histogram kernels (hist_backend="pallas_bf16"):
    # its launches count on the wrapper's counters above too.
    "hist_bf16": (hist.bin_histogram_batched, "bf16_launches"),
    "hist_partition_bf16": (hist.bin_histogram_batched, "bf16_partition_launches"),
    "hist_partition_packed_bf16": (hist.bin_histogram_batched, "bf16_packed_launches"),
    "hist_shared_bf16": (hist.bin_histogram_shared, "bf16_launches"),
    "hist_partition_shared_bf16": (hist.bin_histogram_shared, "bf16_partition_launches"),
    "hist_partition_shared_packed_bf16": (hist.bin_histogram_shared, "bf16_packed_launches"),
}

# Launches of the row kernels each path must make, from its configuration
# (16-tree chunks; 2,000 causal trees in 125 chunks of 8 two-tree groups;
# predict_cate in 32-tree chunks):
#   route_advance: one per level of every chunk — DR-RF 157 chunks x 9;
#     causal 2 x 32 nuisance chunks x 9 + 125 x 8; DML 4 x 125 x 9;
#   leaf_record: one per classifier/regressor chunk — 157; 64; 500;
#   traverse: one per predict_cate chunk (63) and per forest_apply (4).
# The per-level route and the lookup kernels are off these paths (0);
# the lookup kernel serves predict_cate(leaf_index=...) (path_leaf_index:
# the leaf ids once, then the row_chunk and the two index calls).
ROW_LAUNCHES = {
    "dr_rf": {"route_advance": 1413, "traverse": 0, "leaf_record": 157, "route": 0, "lookup": 0},
    "causal_forest": {"route_advance": 1576, "traverse": 63, "leaf_record": 64, "route": 0,
                      "lookup": 0},
    "dml": {"route_advance": 4500, "traverse": 4, "leaf_record": 500, "route": 0, "lookup": 0},
    # path_leaf_index: one 32-tree chunk, every row in one launch (the
    # leaf ids and a row_chunk call: traverse; two calls through the ids).
    "leaf_index": {"route_advance": 0, "traverse": 2, "leaf_record": 0, "route": 0, "lookup": 2},
}
ROW_LAUNCHES["causal_forest_packed"] = ROW_LAUNCHES["causal_forest"]
# The sweep runs the DR-RF, causal and DML forests once each.
ROW_LAUNCHES["sweep"] = {k: sum(ROW_LAUNCHES[p][k] for p in ("dr_rf", "causal_forest", "dml"))
                         for k in ROW_LAUNCHES["dr_rf"]}
# cd_path launches of the LASSO rows (LASSOPS 160 IRLS iterations, one
# each for Single-equation, Usual and Belloni) and of residual_balancing
# (one an arm).
CD_LAUNCHES = {"lasso": 163, "balance": 2}


def scenario_launches(rf_cells: int, lasso_blocks: int) -> dict:
    """Every kernel's launches in a scenario-matrix run, from its
    configuration: an aipw_rf cell grows one 16-tree chunk of depth 4 (4
    dense K=2 histograms at widths 1, 1, 2 and 4, 4 route_advance, one
    node_sums, one leaf_record; OOB votes from the recorded leaves, no
    traverse); a lasso block is one cd_path launch of its 32 lanes' 352
    fits. Nothing else launches a kernel."""
    want = {k: 0 for k in COUNTERS}
    want.update(hist=4 * rf_cells, route_advance=4 * rf_cells, node_sums=rf_cells,
                leaf_record=rf_cells, cd_path=lasso_blocks)
    return want


PACKED_KERNELS = ("hist_partition_packed", "hist_partition_shared_packed", "pack_codes")
# The bf16 forms, launched only under hist_backend="pallas_bf16"
# (path_pallas_backends).
BF16_KERNELS = tuple(k for k in COUNTERS if k.endswith("_bf16"))
# The JAX package's per-level route and lookup kernels, which the paths
# no longer call (ROW_LAUNCHES holds them at 0 there).
OLD_ROW_KERNELS = ("route", "lookup")
# The LASSO rows' kernel, off the forest paths.
LASSO_KERNELS = ("cd_path",)
UNPACKED_KERNELS = tuple(k for k in COUNTERS
                         if k not in PACKED_KERNELS + OLD_ROW_KERNELS + LASSO_KERNELS
                         + BF16_KERNELS)


def reset_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def require_launched(counts: dict, names, path: str) -> None:
    missing = [k for k in names if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: {missing} ({counts})")


def require_row_launches(counts: dict, path: str) -> None:
    """The row kernels' counts on ``path`` equal ROW_LAUNCHES[path]."""
    want = ROW_LAUNCHES[path]
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"row kernel launches on the {path} path: {got}, derived {want}")


@contextlib.contextmanager
def env(name: str, value: str):
    """``name=value`` in the environment for the block, restored after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def packed_policy():
    """``ATE_TPU_PREDICT_PACK=1`` for the block; the old value restored in
    a finally (an exception in the block propagates)."""
    return env(pack.ENV_PACK, "1")


def require_unpacked(counts: dict, path: str) -> None:
    """The default policy ("auto" packing resolves to unpacked) launches
    no packed kernel."""
    if any(counts[k] for k in PACKED_KERNELS):
        raise AssertionError(f"packed kernels launched on the {path} path under the default "
                             f"policy: {counts}")


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return name, smi


# Device functions of csrc/, as ptxas names them (mangled); K is the
# template argument of the histogram kernels.
DEVICE_FUNCTIONS = ("partition_accumulate_packed", "partition_accumulate", "partition_rows",
                    "partition_gather", "hist_dense", "hist_reduce", "pack_words", "route_kernel",
                    "lookup_kernel", "route_advance_kernel", "traverse_kernel", "leaf_record_kernel",
                    "cd_path_kernel", "cd_path_small_kernel", "leaf_sums_kernel")
# Kernels that must not spill (every instantiation).
NO_SPILL = ("hist_dense", "partition_accumulate_packed", "partition_accumulate", "leaf_sums_kernel")


def ptxas_functions(log: str) -> dict:
    """``nvcc -Xptxas -v`` → {"name<K>": {registers, stack, spill_bytes}}
    ("name<K,bf16>" for a histogram kernel's bf16 form)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            mangled = ln.split("'")[1] if "'" in ln else ln.rsplit(" ", 1)[-1]
            base = next((b for b in DEVICE_FUNCTIONS if b in mangled), mangled)
            if base + "ILi" in mangled:
                k, rest = mangled.split(base + "ILi", 1)[1].split("E", 1)
                if rest.startswith("Lb1"):  # the histograms' bf16 form: <K, true>
                    k += ",bf16"
            else:     # other template arguments, as mangled (cd_path_kernel<float, true, 1>: fLb1ELi1E)
                k = mangled.split(base + "I", 1)[1].split("Ev", 1)[0] if base + "I" in mangled else None
            name = f"{base}<{k}>" if k else base
            out.setdefault(name, {})
        elif name and "spill stores" in ln:
            nums = [int(x) for x in ln.replace(",", " ").split() if x.isdigit()]
            out[name].update(stack=nums[0], spill_bytes=nums[1] + nums[2])
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used", 1)[1].split()[0])
    return out


def phase_build() -> dict:
    t0 = time.perf_counter()
    built = build.build_all()
    functions = {}
    for b in {b.library: b for b in built.values()}.values():
        functions.update(ptxas_functions(b.ptxas))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": max(b.seconds for b in built.values()), "functions": functions})
    spilled = {f: v for f, v in functions.items()
               if f.split("<")[0] in NO_SPILL and v.get("spill_bytes", 0)}
    missing = [b for b in NO_SPILL if not any(f.startswith(b + "<") for f in functions)]
    if spilled or missing:
        raise AssertionError(f"ptxas spills {spilled}, or no instantiation of {missing}")
    return functions


def notebook_frames(device: str):
    """The notebook's data: synthetic pool → prepare_dataset → inject_bias."""
    cfg = PrepConfig()
    raw = make_ggl_like(POOL_ROWS, seed=POOL_SEED, true_ate=TRUE_ATE)
    frame = prepare_dataset(raw, cfg, device=device)
    frame_mod, _ = inject_bias(frame, cfg)
    return frame, frame_mod


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max().item() if got.shape == want.shape else math.inf
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max |Δ| {diff})")
    return 0.0


def kernel_cases(codes: torch.Tensor, rng: np.random.Generator, t: int = 16):
    """Inputs at the DR-RF path's shapes: T=16 trees of a chunk, Poisson
    counts and counts·w weights, node ids with the grower's −1 rows."""
    dev = codes.device
    n = codes.shape[0]
    keys = rnd.split(rnd.key(7, device=dev), t)
    counts = _poisson1_counts(keys, (n,))
    wv = torch.as_tensor((rng.random(n) < 0.3).astype(np.float32), device=dev)
    weights = torch.stack([counts, counts * wv], dim=1).contiguous()

    def ids(m: int) -> torch.Tensor:
        a = rng.integers(-1, m, size=(t, n)).astype(np.int32)
        return torch.as_tensor(a, device=dev)

    return weights, ids


def moment_channels(n: int, rng: np.random.Generator, dev) -> torch.Tensor:
    """The causal path's five float channels [1, w̃, ỹ, w̃², w̃ỹ], (5, n),
    with residual-like w̃ ∈ (−0.5, 0.5) and ỹ ∈ (−1, 1)."""
    wt = (rng.random(n) - 0.5).astype(np.float32)
    yt = (rng.random(n) * 2 - 1).astype(np.float32)
    return torch.as_tensor(np.stack([np.ones(n, np.float32), wt, yt, wt * wt, wt * yt]), device=dev)


def check_float(name: str, got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> tuple[float, float]:
    """|got − want| ≤ FLOAT_ULPS·eps·scale everywhere; returns (max |Δ|,
    max |Δ| / bound)."""
    diff = (got.double() - want.double()).abs()
    lim = FLOAT_ULPS * EPS32 * scale.double()
    ratio = float((diff / lim.clamp(min=1e-300)).max())
    if not bool((diff <= lim).all()):
        raise AssertionError(f"{name}: kernel outside {FLOAT_ULPS}·eps·Σ|w| of its plain version "
                             f"(max |Δ| {float(diff.max())}, {ratio:.3g} of the bound)")
    return float(diff.max()), ratio


def check_bf16_form(name: str, got: torch.Tensor, weights: torch.Tensor, form) -> None:
    """The bf16 form ``got`` against the float32 form ``form(w)`` of the
    same kernel: bit for bit the float32 form on the rounded weights (the
    kernel rounds each weight once as it loads it and adds in the same
    order), and, where the rounding moves a weight, not the float32 form
    on ``weights`` themselves, which is what a bf16 kernel that skipped
    the rounding would give. The plain version's bound alone cannot see
    that: the rounding moves a cell by far less than 64·eps·Σ|w| of its
    (tree, channel)."""
    rounded = hist.round_bf16(weights)
    check_equal(f"{name}: the float32 form on the rounded weights", got, form(rounded))
    if not torch.equal(rounded, weights) and torch.equal(got, form(weights)):
        raise AssertionError(f"{name}: equal to the float32 form on unrounded weights")


def hist_library(codes, ids, weights, m):
    """One ``scatter_add_`` over precomputed flat (tree, channel, node,
    feature, bin) indices: the one-call yardstick (index construction
    not timed). ``weights`` (T, K, n) or (K, n) shared."""
    n, p = codes.shape
    t = ids.shape[0]
    w = weights if weights.ndim == 3 else weights.expand(t, *weights.shape)
    k = w.shape[1]
    dev = codes.device
    valid = (ids >= 0) & (ids < m)
    cell = (((torch.arange(t, device=dev)[:, None, None, None] * k
              + torch.arange(k, device=dev)[None, :, None, None]) * m
             + ids.long()[:, None, :, None]) * p
            + torch.arange(p, device=dev)) * N_BINS + codes.long()[None, None]
    sel = valid[:, None, :, None].expand(t, k, n, p)
    flat_idx = cell[sel]
    flat_val = w[:, :, :, None].expand(t, k, n, p)[sel]
    size = t * k * m * p * N_BINS
    return lambda: torch.zeros(size, device=dev).scatter_add_(0, flat_idx, flat_val).view(t, k, m, p, N_BINS)


def measure_hist(codes, weights, ids, m, mode="dense", shared=False, reps=20, bf16=False):
    """One histogram case: the kernel against its plain version (exact
    for integer weights, within FLOAT_ULPS·eps·Σ|w| for float ones), two
    launches bitwise equal, times and bound. ``bf16``: the bf16 form, its
    plain version the same rounding and its yardstick the ``scatter_add_``
    of the rounded weights (rounded outside the timed call)."""
    n, p = codes.shape
    t = ids.shape[0]
    k = weights.shape[-2]
    wrapper = hist.bin_histogram_shared if shared else hist.bin_histogram_batched
    run = lambda: wrapper(codes, ids, weights, max_nodes=m, n_bins=N_BINS, mode=mode, bf16=bf16)
    plain = lambda: hist.bin_histogram_batched_plain(codes, ids, weights, m, N_BINS, bf16)
    got, again = run(), run()
    want = plain()
    addends = hist.round_bf16(weights) if bf16 else weights
    integer = bool(torch.equal(weights, weights.round()))
    name = (f"hist{'_shared' if shared else ''}{' bf16' if bf16 else ''} {mode} M={m} T={t} "
            f"K={k} n={n}")
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    if bf16:
        check_bf16_form(name, got, weights, lambda w: wrapper(codes, ids, w, max_nodes=m,
                                                              n_bins=N_BINS, mode=mode))
    lib = hist_library(codes, ids, addends, m)
    if integer:
        err, ratio = check_equal(name, got, want), 0.0
        check_equal(f"{name} scatter_add_", lib(), want)
    else:
        scale = addends.abs().sum(dim=-1)
        scale = (scale if scale.ndim == 2 else scale[None])[:, :, None, None, None]
        err, ratio = check_float(name, got, want, scale)
        check_float(f"{name} scatter_add_", lib(), want, scale)
    n_valid = int(((ids >= 0) & (ids < m)).sum())
    nbytes = 4 * (codes.numel() + ids.numel() + weights.numel() + got.numel())
    b_ms, b_by = bound(nbytes, n_valid * p * k)
    row = {"M": m, "n": n, "T": t, "K": k, "mode": mode, "weights": "integer" if integer else "float",
           "bf16": bf16, "max_abs_err": err, "err_over_bound": ratio, "call_ms": time_ms(run, reps),
           "call_library_ms": time_ms(lib, reps), "plain_ms": time_ms(plain, max(3, reps // 4)),
           "bound_ms": b_ms, "bound_by": b_by, "out": got}
    return timed(row, run, lib, 2 if n > 100_000 else 10)


def measure_packed(codes, weights, ids, m, shared, reps=20, bf16=False):
    """One case of the packed pass: ``torch.equal`` to the unpacked
    partition kernel on the same inputs, two launches equal, against the
    plain version (exact for integer weights, FLOAT_ULPS·eps·Σ|w| for
    float ones); times of both kernels, the plain version and the
    ``scatter_add_`` yardstick; the bound counts the packed words, ids,
    weights and output bytes (each once). ``bf16`` as in ``measure_hist``."""
    n, p = codes.shape
    t = ids.shape[0]
    k = weights.shape[-2]
    wrapper = hist.bin_histogram_shared if shared else hist.bin_histogram_batched
    words = pack.pack_codes(codes)
    run = lambda: wrapper(codes, ids, weights, max_nodes=m, n_bins=N_BINS, mode="partition+pack",
                          packed=words, bf16=bf16)
    unpacked = lambda: wrapper(codes, ids, weights, max_nodes=m, n_bins=N_BINS, mode="partition",
                               bf16=bf16)
    plain = lambda: hist.bin_histogram_packed_plain(codes, ids, weights, m, N_BINS, words, bf16)
    got, again, ref = run(), run(), unpacked()
    addends = hist.round_bf16(weights) if bf16 else weights
    name = (f"hist{'_shared' if shared else ''}{' bf16' if bf16 else ''} partition+pack M={m} "
            f"T={t} K={k} n={n}")
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    if not torch.equal(got, ref):
        raise AssertionError(f"{name}: not bitwise equal to the unpacked partition kernel")
    if bf16:
        check_bf16_form(name, got, weights, lambda w: wrapper(
            codes, ids, w, max_nodes=m, n_bins=N_BINS, mode="partition+pack", packed=words))
    want = plain()
    integer = bool(torch.equal(weights, weights.round()))
    lib = hist_library(codes, ids, addends, m)
    if integer:
        err, ratio = check_equal(name, got, want), 0.0
    else:
        scale = addends.abs().sum(dim=-1)
        scale = (scale if scale.ndim == 2 else scale[None])[:, :, None, None, None]
        err, ratio = check_float(name, got, want, scale)
    n_valid = int(((ids >= 0) & (ids < m)).sum())
    b_ms, b_by = bound(4 * (words.numel() + ids.numel() + weights.numel() + got.numel()),
                       n_valid * p * k)
    row = {"M": m, "n": n, "T": t, "K": k, "mode": "partition+pack",
           "weights": "integer" if integer else "float", "bf16": bf16,
           "slots_per_block": hist.packed_slots(k, m, N_BINS),
           "node_groups": hist.packed_node_groups(k, m, N_BINS), "equal_to_unpacked": True,
           "max_abs_err": err, "err_over_bound": ratio, "call_ms": time_ms(run, reps),
           "call_library_ms": time_ms(lib, reps), "call_unpacked_ms": time_ms(unpacked, reps),
           "unpacked_ms": device_ms(unpacked), "plain_ms": time_ms(plain, max(3, reps // 4)),
           "bound_ms": b_ms, "bound_by": b_by, "perm_bytes": 4 * t * n}
    return timed(row, run, lib)


def pack_matrix(p: int, dev) -> torch.Tensor:
    """The JAX package's pack matrix (``hist_pallas.py:433``): (p, ceil(p/3))
    float32, column f // 3 of row f holding 128^(f % 3)."""
    f = torch.arange(p, device=dev)
    mat = torch.zeros((p, pack.packed_width(p)), dtype=torch.float32, device=dev)
    mat[f, f // pack.PACK_SLOTS] = (float(pack.PACK_RADIX) ** (f % pack.PACK_SLOTS)).float()
    return mat


def pack_row(codes, reps=20):
    """The pack kernel against its plain version at the path's codes; its
    yardstick is the JAX package's own form of the step (``hist_pallas.py:441``),
    one ``torch.matmul`` of the float32 codes (made outside the timed call)
    by the pack matrix, whose exact integer result must equal the words."""
    words = pack.pack_codes(codes)
    err = check_equal("pack_codes", words, pack.pack_codes_plain(codes))
    if not torch.equal(pack.unpack_codes(words, codes.shape[1]), codes):
        raise AssertionError("pack_codes: the words do not unpack to the codes")
    codes_f, mat = codes.float(), pack_matrix(codes.shape[1], codes.device)
    lib = lambda: torch.matmul(codes_f, mat)
    check_equal("pack_codes (matmul yardstick)", lib().to(torch.int32), words)
    b_ms, b_by = bound(4 * (codes.numel() + words.numel()), codes.numel())
    row = {"n": codes.shape[0], "p": codes.shape[1], "max_abs_err": err,
           "call_ms": time_ms(lambda: pack.pack_codes(codes), reps),
           "plain_ms": time_ms(lambda: pack.pack_codes_plain(codes), reps),
           "bound_ms": b_ms, "bound_by": b_by}
    return timed(row, lambda: pack.pack_codes(codes), lib)


def node_sums_library(ids, weights, leaves):
    """One ``scatter_add_`` over precomputed flat (tree, channel, leaf)
    indices, viewed as (T, M, K): the leaf sums' one-call yardstick (index
    construction not timed). ``weights`` (T, K, n) or (K, n) shared."""
    t = ids.shape[0]
    w = weights if weights.ndim == 3 else weights.expand(t, *weights.shape)
    k = w.shape[1]
    dev = ids.device
    valid = (ids >= 0) & (ids < leaves)
    seg = ((torch.arange(t, device=dev)[:, None, None] * k
            + torch.arange(k, device=dev)[None, :, None]) * leaves + ids.long()[:, None, :])
    sel = valid[:, None, :].expand_as(seg)
    seg_idx, seg_val = seg[sel], w[sel]
    return lambda: torch.zeros(t * k * leaves, device=dev).scatter_add_(0, seg_idx, seg_val).view(
        t, k, leaves).transpose(1, 2)


def node_sums_dense(ids, weights, leaves):
    """The route the leaf-sum kernel replaced, as a call: the degenerate
    histogram (one all-zero codes column, one bin) on the dense kernel,
    viewed as (T, M, K). Its launches count on the histogram wrappers."""
    codes0 = torch.zeros((ids.shape[1], 1), dtype=torch.int32, device=ids.device)
    wrapper = hist.bin_histogram_shared if weights.ndim == 2 else hist.bin_histogram_batched
    return lambda: wrapper(codes0, ids, weights, max_nodes=leaves, n_bins=1,
                           mode="dense")[:, :, :, 0, 0].transpose(1, 2)


def check_dense_route(name, got, ids, weights, leaves) -> None:
    """The leaf-sum kernel's bits are the dense route's, for any weights."""
    if not torch.equal(got, node_sums_dense(ids, weights, leaves)()):
        raise AssertionError(f"{name}: not bitwise equal to the dense route")


def node_sums_row(ids, weights, leaves, shared, reps=20):
    """The leaf-sum kernel at one path shape: two launches equal,
    ``torch.equal`` to the dense route it replaced, against its plain
    version (exact for integer weights, FLOAT_ULPS·eps·Σ|w| for float
    ones) and the ``scatter_add_`` yardstick; device times of the kernel,
    the dense route (``replaced_ms``) and the yardstick."""
    t = ids.shape[0]
    wrapper = hist.node_sums_shared if shared else hist.node_sums
    run = lambda: wrapper(ids, weights, leaves)
    plain = lambda: hist.node_sums_plain(ids, weights, leaves)
    got, again = run(), run()
    want = plain()
    name = f"node_sums{'_shared' if shared else ''} M={leaves}"
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    check_dense_route(name, got, ids, weights, leaves)
    k = weights.shape[-2]
    lib = node_sums_library(ids, weights, leaves)
    if shared:
        scale = weights.abs().sum(dim=1)[None, None, :]
        err, ratio = check_float(name, got, want, scale)
        check_float(f"{name} scatter_add_", lib(), want, scale)
    else:
        err, ratio = check_equal(name, got, want), 0.0
        check_equal(f"{name} scatter_add_", lib(), got)
    n_valid = int(((ids >= 0) & (ids < leaves)).sum())
    b_ms, b_by = bound(4 * (ids.numel() + weights.numel() + got.numel()), n_valid * k)
    plan = hist.leaf_sums_plan(ids.shape[1], t, k, leaves)
    row = {"M": leaves, "n": ids.shape[1], "T": t, "K": k, "max_abs_err": err,
           "err_over_bound": ratio, "equal_to_dense": True, "plan": plan,
           "call_ms": time_ms(run, reps), "call_library_ms": time_ms(lib, reps),
           "plain_ms": time_ms(plain, 5),
           "replaced_ms": device_ms(node_sums_dense(ids, weights, leaves)),
           "bound_ms": b_ms, "bound_by": b_by}
    return timed(row, run, lib)


def check_sort(ids, weights, m, n_parts) -> None:
    """The partition passes' first step, ``hist.partition_sort`` (the sort
    into perm and seg, and the gather of each position's node and weights
    into perm order), ``torch.equal`` to ``partition_sort_plain`` on every
    position it writes. Its kernels are timed within the partition rows
    (``stage_ms``: ``partition_rows``, ``partition_gather``)."""
    got = hist.partition_sort(ids, m, n_parts, weights)
    want = hist.partition_sort_plain(ids, m, n_parts, weights)
    written = want[0] >= 0
    name = f"partition_sort M={m} K={weights.shape[-2]}"
    check_equal(f"{name} seg", got[1], want[1])
    check_equal(f"{name} perm", got[0][written], want[0][written])
    check_equal(f"{name} node_sorted", got[2][written], want[2][written])
    check_equal(f"{name} w_sorted", got[3].transpose(1, 2)[written],
                want[3].transpose(1, 2)[written])


# Grow widths of a depth-9 tree: route_advance's and route's rows.
WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def check_same(name: str, pairs) -> None:
    """``torch.equal`` on every (got, want) pair."""
    for i, (got, want) in enumerate(pairs):
        check_equal(f"{name} [{i}]", got, want)


def advance_rows(codes, rng, t: int = 16) -> list:
    """``route_advance`` at every grow width, unmasked (classifier levels)
    and masked (causal levels), and the two last levels (width 256
    unmasked, 128 masked): the ids and both advanced streams against the
    plain version and between two launches; device times of the kernel
    and of the sequence it replaces (route, ``node_int * 2 + bit``,
    ``node_rev + bit * M``, the next level's ``where``, the mask's
    ``where``). Timed on a frozen table (every row reads its code and
    goes left), so repeated in-place calls keep every id in range: the
    same bytes as a real level."""
    dev = codes.device
    n, p = codes.shape
    mask = torch.as_tensor(rng.random((t, n)) < 0.5, device=dev)
    cases = [(m, msk, False) for m in WIDTHS for msk in (None, mask)]
    cases += [(256, None, True), (128, mask, True)]
    rows = []
    for m, msk, last in cases:
        ni0 = torch.as_tensor(rng.integers(0, m, size=(t, n)).astype(np.int32), device=dev)
        nr0 = torch.as_tensor(rng.integers(0, m, size=(t, n)).astype(np.int32), device=dev)
        feat = torch.as_tensor(rng.integers(0, p, size=(t, m)).astype(np.int32), device=dev)
        thr = torch.as_tensor(rng.integers(0, N_BINS, size=(t, m)).astype(np.int32), device=dev)
        outs = []
        for fn in (tree.route_advance, tree.route_advance, tree.route_advance_plain):
            ni, nr = ni0.clone(), nr0.clone()
            outs.append((fn(codes, ni, nr, feat, thr, msk, last), ni, nr))
        name = f"route_advance M={m} mask={msk is not None} last={last}"
        check_same(name + " (two launches)", zip(outs[0], outs[1]))
        err = check_same(name, zip(outs[0], outs[2])) or 0.0
        frozen = torch.full_like(thr, N_BINS - 1)
        ti, tr = ni0.clone(), nr0.clone()

        def replaced(m=m, msk=msk, last=last):
            bit = tree.route_bits(codes, tr, feat, frozen)
            ni2 = ti * 2 + bit
            nr2 = tr + bit * m
            ids = ni2 if last else torch.where(ni2 % 2 == 0, nr2, -1)
            return (ids if msk is None else torch.where(msk, ids, -1)), ni2, nr2

        run = lambda: tree.route_advance(codes, ti, tr, feat, frozen, msk, last)
        plain = lambda: tree.route_advance_plain(codes, ti, tr, feat, frozen, msk, last)
        nbytes = 4 * codes.numel() + 8 * feat.numel() + 20 * t * n + (t * n if msk is not None else 0)
        b_ms, b_by = bound(nbytes, t * n)
        ms = device_ms(run)
        rows.append({"M": m, "n": n, "T": t, "mask": msk is not None, "last": last,
                     "max_abs_err": err, "ms": ms, "call_ms": time_ms(run, 20),
                     "plain_ms": time_ms(plain, 20), "replaced_ms": device_ms(replaced),
                     "library_ms": None, "factor": None, "bound_ms": b_ms, "bound_by": b_by})
    return rows


def traverse_rows(codes, rng) -> list:
    """``traverse`` at the causal predict chunk (32 trees of depth 8, the
    5-channel payload, and the leaf ids) and at DML's forest apply (2,000
    trees of depth 9, the leaf value, and the leaf ids), against the plain
    version and between two launches, with the device time of the
    sequence it replaces (a route launch, the slice copies and
    ``node * 2 + bit`` per level, then the transposed payload's copy and
    a lookup launch)."""
    dev = codes.device
    n, p = codes.shape
    rows = []
    for t, depth, k in ((32, CF_DEPTH, 5), (32, CF_DEPTH, None), (DML_TREES, DEPTH, 1),
                        (DML_TREES, DEPTH, None)):
        width = 1 << (depth - 1)
        feat = torch.as_tensor(rng.integers(0, p, size=(t, depth, width)).astype(np.int32), device=dev)
        thr = torch.as_tensor(rng.integers(0, N_BINS, size=(t, depth, width)).astype(np.int32),
                              device=dev)
        table = None if k is None else torch.as_tensor(
            rng.random((t, 1 << depth, k)).astype(np.float32), device=dev)
        run = lambda: tree.traverse(codes, feat, thr, table)
        plain = lambda: tree.traverse_plain(codes, feat, thr, table)

        def replaced(t=t, depth=depth, feat=feat, thr=thr, table=table):
            node = torch.zeros((t, n), dtype=torch.int32, device=dev)
            for level in range(depth):
                m = 1 << level
                node = node * 2 + tree.route_bits(codes, node, feat[:, level, :m].contiguous(),
                                                  thr[:, level, :m].contiguous())
            return node if table is None else tree.table_lookup(table.transpose(1, 2).contiguous(),
                                                                node)

        got, again = run(), run()
        name = f"traverse T={t} depth={depth} K={k}"
        check_equal(name + " (two launches)", got, again)
        err = check_equal(name, got, plain())
        check_equal(name + " (replaced sequence)", got, replaced())
        # The split tables' live nodes only: level a reads its first 2^a.
        nbytes = (4 * (got.numel() + codes.numel() + (0 if table is None else table.numel()))
                  + 8 * t * ((1 << depth) - 1))
        b_ms, b_by = bound(nbytes, t * n * depth)
        calls = 2 if t > 100 else 10
        rows.append({"T": t, "n": n, "depth": depth, "K": k, "output": "payload" if k else "leaf ids",
                     "max_abs_err": err,
                     "ms": device_ms(run, calls), "call_ms": time_ms(run, 10),
                     "plain_ms": time_ms(plain, 5), "replaced_ms": device_ms(replaced, calls),
                     "library_ms": None, "factor": None, "bound_ms": b_ms, "bound_by": b_by})
        del got, again
    return rows


def leaf_record_rows(weights, ids, t: int = 16) -> list:
    """``leaf_record`` at a classifier chunk (16 trees, 512 leaves, the
    leaf sums as node_sums returns them on the card), binary (base 0) and
    continuous (base = the tree's mean) targets: both outputs
    ``torch.equal`` to the plain version and to the grower's old
    sequence (the leaf values in PyTorch's CUDA ops: the division
    IEEE-rounded on both sides), two launches equal; device times of the
    kernel and that sequence."""
    leaves = 1 << DEPTH
    node = ids(leaves)
    ls = hist.node_sums(node, weights, leaves)
    dev = node.device
    mu = torch.rand(t, device=dev, generator=torch.Generator(dev).manual_seed(3))
    rows = []
    for center in (0.0, 1.0):
        base = center * mu

        def replaced(base=base):
            leaf_c, leaf_y = ls[..., 0], ls[..., 1]
            lv = torch.where(leaf_c > 0, base[:, None] + leaf_y / torch.clamp(leaf_c, min=1e-12),
                             mu[:, None])
            return lv, tree.table_lookup(lv[:, None, :].contiguous(), node)[:, 0]

        run = lambda: tree.leaf_record(ls, base, mu, node)
        plain = lambda: tree.leaf_record_plain(ls, base, mu, node)
        name = f"leaf_record center={center}"
        got = run()
        check_same(name + " (two launches)", zip(got, run()))
        err = check_same(name, zip(got, plain())) or 0.0
        check_same(name + " (replaced sequence)", zip(got, replaced()))
        nbytes = 4 * (ls.numel() + 2 * t + 2 * node.numel() + t * leaves)
        b_ms, b_by = bound(nbytes, 2 * t * leaves)
        rows.append({"T": t, "L": leaves, "n": node.shape[1], "center": center,
                     "empty_leaves": int((ls[..., 0] == 0).sum()), "max_abs_err": err,
                     "ms": device_ms(run), "call_ms": time_ms(run, 20), "plain_ms": time_ms(plain, 20),
                     "replaced_ms": device_ms(replaced), "library_ms": None, "factor": None,
                     "bound_ms": b_ms, "bound_by": b_by})
    return rows


def strip(row: dict) -> dict:
    return {k: v for k, v in row.items() if k != "out"}


def phase_kernels(frame_mod) -> dict:
    rng = np.random.default_rng(2024)
    x = frame_mod.x
    codes = fo.binarize(x, fo.quantile_bins(x, N_BINS))
    n, p = codes.shape
    weights, ids = kernel_cases(codes, rng)
    words = pack.pack_codes(codes)
    t = weights.shape[0]
    summary = {}

    def both_modes(w, m, shared):
        """Dense, partition and the packed pass on one input, bitwise equal
        to each other. All three are timed at every width (the path takes
        partition from the crossover up), so that a later PR can re-derive
        the crossover."""
        lid = ids(m)
        d = measure_hist(codes, w, lid, m, shared=shared)
        q = measure_hist(codes, w, lid, m, mode="partition", shared=shared)
        wrapper = hist.bin_histogram_shared if shared else hist.bin_histogram_batched
        run = lambda: wrapper(codes, lid, w, max_nodes=m, n_bins=N_BINS, mode="partition+pack",
                              packed=words)
        packed, again = run(), run()
        q["equal_to_dense"] = bool(torch.equal(q["out"], d["out"]))
        q["packed_equal_to_dense"] = bool(torch.equal(packed, d["out"]) and torch.equal(again, packed))
        if not (q["equal_to_dense"] and q["packed_equal_to_dense"]):
            raise AssertionError(f"M={m} K={w.shape[-2]}: partition or packed not bitwise equal "
                                 f"to dense ({q['equal_to_dense']}, {q['packed_equal_to_dense']})")
        q["packed_ms"] = device_ms(run)
        q["packed_factor"] = q["packed_ms"] / q["library_ms"]
        # The unpacked pass's geometry (one feature per block), its first
        # step against the plain version, and where its device time goes.
        n_parts = hist._n_parts(n, t, p)
        check_sort(lid, w, m, n_parts)
        q.update(ranges=n_parts, cluster=hist.partition_cluster_ranges(n_parts),
                 features_per_block=1, sort_equal_to_plain=True,
                 max_active_clusters=hist.partition_max_active_clusters(
                     n, t, w.shape[-2], m, p, N_BINS))
        # Its stage split is profiled after the paths (phase_stages).
        row = strip(q)
        SPLITS.append((row, lambda: wrapper(codes, lid, w, max_nodes=m, n_bins=N_BINS,
                                            mode="partition")))
        return strip(d), row

    # Per-tree weights, K=2 integer (classifier and nuisance levels).
    hist_rows, part_rows = map(list, zip(*(both_modes(weights, m, False)
                                           for m in (1, 2, 4, 8, 16, 32, 64, 128))))
    # bench.py's forest row count: one million rows, at the deepest width.
    big_codes = torch.as_tensor(rng.integers(0, N_BINS, size=(BIG_ROWS, p)).astype(np.int32), device=x.device)
    big_w, big_ids = kernel_cases(big_codes, rng)
    hist_rows.append(strip(measure_hist(big_codes, big_w, big_ids(128), 128, reps=5)))
    del big_codes, big_w
    # The float path of the per-tree kernel (a continuous target's
    # centered counts·y), at the deepest width.
    yc = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=x.device)
    wf = torch.stack([weights[:, 0], weights[:, 0] * yc], dim=1).contiguous()
    float_row = strip(measure_hist(codes, wf, ids(128), 128))
    # The T = 1 case (the single-tree _hist_kernel) at the deepest width.
    t1_ids = ids(128)[:1].contiguous()
    t1_row = strip(measure_hist(codes, weights[:1].contiguous(), t1_ids, 128))
    emit({"phase": "kernels", "kernel": "hist", "rows": hist_rows, "float": float_row, "t1": t1_row})
    emit({"phase": "kernels", "kernel": "hist_partition", "rows": part_rows})
    summary["hist"] = hist_rows[4]             # M=16: the deepest dense width under "auto" (K=2)
    summary["hist_partition"] = part_rows[7]   # M=128
    summary["hist_t1"] = t1_row

    # Shared weights, K=5 float (the causal levels), widths 1–64, and 128.
    mom = moment_channels(n, rng, x.device)
    sh_rows, shp_rows = map(list, zip(*(both_modes(mom, m, True)
                                        for m in (1, 2, 4, 8, 16, 32, 64, 128))))
    emit({"phase": "kernels", "kernel": "hist_shared", "rows": sh_rows})
    emit({"phase": "kernels", "kernel": "hist_partition_shared", "rows": shp_rows})
    summary["hist_shared"] = sh_rows[3]             # M=8: the deepest dense width under "auto" (K=5)
    summary["hist_partition_shared"] = shp_rows[6]  # M=64

    # The packed pass: K=2 integer at the DML path's shape (one fold of
    # 5,508 rows, T=16) at its partition widths; K=5 float shared at the
    # causal path's (11,016 rows), M=16–64 on the path and M=128.
    fold = codes[: n // 2].contiguous()
    fold_w, fold_ids = kernel_cases(fold, rng)
    pk_rows = [measure_packed(fold, fold_w, fold_ids(m), m, False) for m in (32, 64, 128)]
    pks_rows = [measure_packed(codes, mom, ids(m), m, True) for m in (16, 32, 64, 128)]
    emit({"phase": "kernels", "kernel": "hist_partition_packed", "rows": pk_rows})
    emit({"phase": "kernels", "kernel": "hist_partition_shared_packed", "rows": pks_rows})
    summary["hist_partition_packed"] = pk_rows[2]         # M=128
    summary["hist_partition_shared_packed"] = pks_rows[2]  # M=64, the causal path's deepest

    # The bf16 form (hist_backend="pallas_bf16"): dense K=2 integer at M=16
    # and 128, bit for bit the float32 form there; the regressor's float
    # K=2 levels on the partition kernel (M=64) and the packed pass (the
    # DML fold, M=128); the causal K=5 float channels dense (M=8),
    # partition (M=32, bitwise the dense bf16 form) and packed (M=32).
    bf16_rows: dict = {"hist_bf16": []}
    for m in (16, 128):
        lid = ids(m)
        row = measure_hist(codes, weights, lid, m, bf16=True)
        check_equal(f"hist bf16 M={m}: the float32 form on integer weights", row["out"],
                    hist.bin_histogram_batched(codes, lid, weights, max_nodes=m, n_bins=N_BINS))
        bf16_rows["hist_bf16"].append(strip(row))
    bf16_rows["hist_partition_bf16"] = [strip(measure_hist(codes, wf, ids(64), 64,
                                                           mode="partition", bf16=True))]
    bf16_rows["hist_partition_packed_bf16"] = [measure_packed(fold, fold_w, fold_ids(128), 128,
                                                              False, bf16=True)]
    bf16_rows["hist_shared_bf16"] = [strip(measure_hist(codes, mom, ids(8), 8, shared=True,
                                                        bf16=True))]
    lid = ids(32)
    row = measure_hist(codes, mom, lid, 32, mode="partition", shared=True, bf16=True)
    check_equal("hist_shared bf16 M=32: partition = dense", row["out"],
                hist.bin_histogram_shared(codes, lid, mom, max_nodes=32, n_bins=N_BINS, bf16=True))
    bf16_rows["hist_partition_shared_bf16"] = [strip(row)]
    bf16_rows["hist_partition_shared_packed_bf16"] = [measure_packed(codes, mom, lid, 32, True,
                                                                     bf16=True)]
    for name, rows in bf16_rows.items():
        emit({"phase": "kernels", "kernel": name, "rows": rows})
        summary[name] = rows[0]
    summary["pack_codes"] = pack_row(fold)
    # The launch floor: a one-element PyTorch op in the same harness.
    one = torch.zeros(1, device=x.device)
    summary["pack_codes"]["launch_floor_ms"] = device_ms(lambda: one.add_(1.0))
    emit({"phase": "kernels", "kernel": "pack_codes", "rows": [summary["pack_codes"]]})
    emit({"phase": "kernels", "kernel": "launch_floor", "op": "one.add_(1.0), one float32",
          "device_ms": summary["pack_codes"]["launch_floor_ms"],
          "pack_words_ms": summary["pack_codes"]["ms"]})

    # Leaf sums: 512 leaves, K=2 integer (DR-RF); 256 leaves, K=5 float (causal).
    summary["node_sums"] = node_sums_row(ids(1 << DEPTH), weights, 1 << DEPTH, shared=False)
    summary["node_sums_shared"] = node_sums_row(ids(1 << CF_DEPTH), mom, 1 << CF_DEPTH, shared=True)
    # A regressor's float leaf sums (counts, counts·y): the dense route's bits too.
    lid = ids(1 << DEPTH)
    check_dense_route("node_sums float K=2", hist.node_sums(lid, wf, 1 << DEPTH), lid, wf,
                      1 << DEPTH)
    emit({"phase": "kernels", "kernel": "node_sums", "rows": [summary["node_sums"]]})
    emit({"phase": "kernels", "kernel": "node_sums_shared", "rows": [summary["node_sums_shared"]]})

    # route: every level width of a depth-9 tree.
    route_rows = []
    for m in WIDTHS:
        rid = ids(m)
        feat = torch.as_tensor(rng.integers(0, p, size=(t, m)).astype(np.int32), device=x.device)
        thr = torch.as_tensor(rng.integers(0, N_BINS, size=(t, m)).astype(np.int32), device=x.device)
        got = tree.route_bits(codes, rid, feat, thr)
        err = check_equal(f"route M={m}", got, tree.route_bits_plain(codes, rid, feat, thr))
        b_ms, b_by = bound(4 * (codes.numel() + rid.numel() + feat.numel() + thr.numel() + got.numel()),
                           rid.numel())
        route_rows.append({
            "M": m, "n": n, "T": t, "max_abs_err": err,
            "ms": device_ms(lambda: tree.route_bits(codes, rid, feat, thr)),
            "call_ms": time_ms(lambda: tree.route_bits(codes, rid, feat, thr), 20),
            "plain_ms": time_ms(lambda: tree.route_bits_plain(codes, rid, feat, thr), 20),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
    emit({"phase": "kernels", "kernel": "route", "rows": route_rows})
    summary["route"] = route_rows[-1]

    # lookup: the 512-leaf training-row value recording (K = 1) and the
    # causal leaf payload (K = 5, 256 leaves, 32 trees of a predict chunk).
    lookup_rows = []
    for tt_, kk, leaves in ((t, 1, 1 << DEPTH), (32, 5, 1 << CF_DEPTH)):
        table = torch.as_tensor(rng.random((tt_, kk, leaves)).astype(np.float32), device=x.device)
        lid = torch.as_tensor(rng.integers(-1, leaves, size=(tt_, n)).astype(np.int32), device=x.device)
        got = tree.table_lookup(table, lid)
        err = check_equal("lookup", got, tree.table_lookup_plain(table, lid))
        gidx = lid.long().clamp(0, leaves - 1)[:, None, :].expand(tt_, kk, n)
        b_ms, b_by = bound(4 * (table.numel() + lid.numel() + got.numel()), got.numel())
        row = {"M": leaves, "n": n, "T": tt_, "K": kk, "max_abs_err": err,
               "call_ms": time_ms(lambda: tree.table_lookup(table, lid), 20),
               "plain_ms": time_ms(lambda: tree.table_lookup_plain(table, lid), 20),
               "bound_ms": b_ms, "bound_by": b_by}
        lookup_rows.append(timed(row, lambda: tree.table_lookup(table, lid),
                                 lambda: torch.gather(table, 2, gidx)))
    emit({"phase": "kernels", "kernel": "lookup", "rows": lookup_rows})
    summary["lookup"] = lookup_rows[0]

    # The fused row passes.
    adv = advance_rows(codes, rng)
    emit({"phase": "kernels", "kernel": "route_advance", "rows": adv})
    summary["route_advance"] = adv[-4]          # M=256, unmasked: the classifier's deepest level
    trav = traverse_rows(codes, rng)
    emit({"phase": "kernels", "kernel": "traverse", "rows": trav})
    summary["traverse"] = trav[0]               # the causal predict chunk's payload
    rec = leaf_record_rows(weights, ids)
    emit({"phase": "kernels", "kernel": "leaf_record", "rows": rec})
    summary["leaf_record"] = rec[0]

    cd = cd_rows(frame_mod)
    emit({"phase": "kernels", "kernel": "cd_path", "rows": cd})
    summary["cd_path"] = cd[0]                  # Usual LASSO's path: plain timed on it whole
    return summary


class _Recorder:
    """Stands in for ``lasso.cd_path``: records each call's inputs and
    calls the wrapper; its ``launches`` is the wrapper's own counter (the
    wrapper counts through the module name it is looked up by)."""

    def __init__(self, fn):
        self.fn, self.seen = fn, []

    def __call__(self, *a, **k):
        self.seen.append((a, k))
        return self.fn(*a, **k)

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.fn.launches = value


@contextlib.contextmanager
def cd_capture():
    """Record the inputs of every ``lasso.cd_path`` call made in the block
    (``ops/lasso.py`` looks the name up at each call)."""
    fn = lasso.cd_path
    lasso.cd_path = _Recorder(fn)
    try:
        yield lasso.cd_path.seen
    finally:
        lasso.cd_path = fn


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0])


def event_ms(fn):
    """``fn()`` once between two CUDA events → (its result, ms)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    a.record()
    out = fn()
    b.record()
    sync()
    return out, a.elapsed_time(b)


def cd_inputs(frame_mod) -> list:
    """The CD kernel's inputs at the shapes the LASSO and balancing rows
    give it, captured from the rows' own CV calls: Usual LASSO's path (11
    fits, p = 22, 100 λs), Belloni's two CV-LASSOs in one batch (22 fits,
    p = 462, 100 λs), the binomial LASSO's first IRLS iteration (11 fits,
    p = 21, one λ) and residual_balancing's two arms (11 fits each, p =
    21, α = 0.9, 100 λs). Each: (name, cd_path's arguments, the row's
    cd_path calls)."""
    dev = frame_mod.device.type
    x = frame_mod.x
    keys = list(rnd.split(sweep_key("belloni", dev)).unbind(dim=-2))
    cases = [("usual", lasso_est._xw_design(frame_mod), [frame_mod.y], "gaussian",
              dict(foldids=[lasso.default_foldid(sweep_key("usual_lasso", dev), frame_mod.n)])),
             ("belloni", bel.interaction_expand(x), [frame_mod.w, frame_mod.y], "gaussian",
              dict(keys=keys)),
             ("ps_irls_1", x, [frame_mod.w], "binomial",
              dict(foldids=[lasso.default_foldid(sweep_key("ps_lasso", dev), frame_mod.n)]))]
    # residual_balancing's elastic nets (α = 0.9), one an arm, on their keys.
    k0, k1 = rnd.split(sweep_key("balance", dev)).unbind(dim=-2)
    treated = frame_mod.w > 0.5
    for arm, rows, k in (("balance_treated", treated, k1), ("balance_control", ~treated, k0)):
        cases.append((arm, x[rows], [frame_mod.y[rows]], "gaussian", dict(alpha=0.9, keys=[k])))
    out = []
    for name, xx, ys, family, kw in cases:
        with cd_capture() as seen:
            lasso.cv_glmnet_many(xx, ys, family, **kw)
        out.append((name, seen[0][0], len(seen)))
    return out


def cd_plain_windows(name: str, args, betas, sweeps, windows, timed: bool) -> list:
    """``cd_path``'s coefficients ``betas`` (and ``sweeps``) from the
    inputs ``args`` held within CD_PATH_BOUND of ``cd_path_plain`` on each
    window (lo, hi) of λs, a window after the first warm-started from the
    kernel's coefficients at the λ before it. ``timed``: one CUDA-event
    time of the plain version a window (else a median of one call after a
    warm-up)."""
    gram, xty, pf, lams, beta0, alpha, thresh = args
    out = []
    for lo, hi in windows:
        start = beta0 if lo == 0 else betas[:, lo - 1].contiguous()
        plams = lams[:, lo:hi].contiguous()
        plain = lambda: lasso.cd_path_plain(gram, xty, pf, plams, start, alpha, thresh)
        if timed:
            (want, want_sweeps), plain_ms = event_ms(plain)
        else:
            (want, want_sweeps), plain_ms = plain(), time_ms(plain, 1)
        err = float((betas[:, lo:hi] - want).abs().max())
        if not err <= CD_PATH_BOUND:
            raise AssertionError(f"cd_path {name} λs {lo}–{hi - 1}: kernel {err} from its "
                                 f"plain version (bound {CD_PATH_BOUND})")
        out.append({"lambdas": [lo, hi], "max_abs_err": err, "plain_ms": plain_ms,
                    "sweeps_equal_to_plain": float((sweeps[:, lo:hi] == want_sweeps)
                                                   .double().mean())})
    return out


def cd_rows(frame_mod) -> list:
    """The CD kernel at the shapes of ``cd_inputs``. Each: two
    launches equal; within CD_PATH_BOUND of the plain version (Belloni's
    on the windows CD_PLAIN_WINDOWS, each warm-started from the kernel's
    coefficients at the λ before it); device times of the kernel and of
    the plain version (host-timed, on the same λs). ``bound_ms`` is the
    recurrence's floor: the longest fit's sweeps × p updates at
    RECURRENCE_STEPS steps of CHAIN_CYCLES_PER_STEP cycles each, the same
    at every p. Beside it ``order_chain_ms``, the floor of the order that
    keeps G_j·β whole on the chain (CHAIN_FIXED_STEPS + ceil(p/32) steps an
    update), and ``rate_bound_ms``: bytes (the Gram systems, c, pf and λs
    read once, the coefficients and sweep counts written once) or
    operations (this run's sweeps × p × (2p + 10) float operations at the
    peak rate), whichever is larger."""
    clock = sm_clock_mhz()
    rows = []
    for name, (gram, xty, pf, lams, beta0, alpha, thresh), calls in cd_inputs(frame_mod):
        run = lambda: lasso.cd_path(gram, xty, pf, lams, beta0, alpha, thresh)
        betas, sweeps = run()
        again, sweeps2 = run()
        check_equal(f"cd_path {name} (two launches)", again, betas)
        check_equal(f"cd_path {name} sweeps (two launches)", sweeps2, sweeps)
        big = name == "belloni"
        n_fits, p, _ = gram.shape
        n_lam = lams.shape[1]
        windows = cd_plain_windows(name, (gram, xty, pf, lams, beta0, alpha, thresh), betas,
                                   sweeps, CD_PLAIN_WINDOWS if big else ((0, n_lam),), big)
        nbytes = 4 * (n_fits * p * p + 2 * n_fits * p + n_fits * n_lam
                      + n_fits * n_lam * p + n_fits * n_lam)
        rate_ms, rate_by = bound(nbytes, int(sweeps.sum()) * p * (2 * p + 10))
        chain = int(sweeps.sum(dim=1).max()) * p
        cycles = CHAIN_CYCLES_PER_STEP * RECURRENCE_STEPS
        chain_ms = chain * cycles / (clock * 1e3)
        order_cycles = CHAIN_CYCLES_PER_STEP * (CHAIN_FIXED_STEPS + -(-p // 32))
        ms = device_ms(run, 1 if big else 10, 3 if big else 10)
        rows.append({"case": name, "B": n_fits, "p": p, "L": n_lam, "dtype": str(gram.dtype),
                     "staged_gram": p * p * 4 + 4 * 4 * ((p + 3) // 4 * 4) <= 200 * 1024,
                     "delay": lasso.cd_delay(),
                     "calls_in_row": calls, "sweeps_total": int(sweeps.sum()),
                     "sweeps_max": int(sweeps.max()), "chain_updates": chain,
                     "max_abs_err": max(w["max_abs_err"] for w in windows),
                     "plain_windows": windows,
                     "ms": ms, "ns_per_chain_update": ms * 1e6 / chain,
                     "call_ms": time_ms(run, 3 if big else 10),
                     "plain_ms": windows[0]["plain_ms"], "library_ms": None, "factor": None,
                     "bound_ms": max(chain_ms, rate_ms),
                     # The chain is one of dependent operations.
                     "bound_by": "operations" if chain_ms >= rate_ms else rate_by,
                     "bound_kind": "chain" if chain_ms >= rate_ms else rate_by,
                     "chain_cycles_per_update": cycles, "sm_clock_mhz": clock,
                     "order_chain_ms": chain * order_cycles / (clock * 1e3),
                     "order_chain_cycles_per_update": order_cycles,
                     "rate_bound_ms": rate_ms, "rate_bound_by": rate_by})
    return rows


def phase_path(frame, frame_mod) -> dict:
    stages = {}
    t0 = time.perf_counter()
    oracle = naive_ate(frame, method="oracle")
    naive = naive_ate(frame_mod)
    sync()
    stages["naive_s"] = time.perf_counter() - t0

    reset_counts()
    t0 = time.perf_counter()
    p_rf = fo.rf_oob_propensity(frame_mod, key=rnd.key(12325, device="cuda"),
                                n_trees=DR_TREES, depth=DEPTH)
    sync()
    stages["forest_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mu = outcome_model_mu(frame_mod)
    sync()
    stages["outcome_glm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dr = doubly_robust(frame_mod, lambda f: p_rf, mu=mu)
    stages["aipw_sandwich_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dr_boot = doubly_robust(frame_mod, lambda f: p_rf, bootstrap_se=True, n_boot=N_BOOT,
                            key=rnd.key(0, device="cuda"), mu=mu)
    stages["aipw_bootstrap_s"] = time.perf_counter() - t0
    counts = read_counts()

    if tuple(frame_mod.x.shape) != (11_016, 21):
        raise AssertionError(f"biased frame is {tuple(frame_mod.x.shape)}, expected (11016, 21)")
    if p_rf.shape != (frame_mod.n,) or not bool(torch.isfinite(p_rf).all()):
        raise AssertionError("propensity is not a finite (n,) vector")
    for r in (oracle, naive, dr, dr_boot):
        if not (math.isfinite(r.ate) and math.isfinite(r.se) and r.se > 0):
            raise AssertionError(f"{r.method}: non-finite estimate or SE ({r})")
    require_launched(counts, ("hist", "hist_partition", "node_sums", "route_advance",
                              "leaf_record"), "DR-RF")
    require_unpacked(counts, "DR-RF")
    require_row_launches(counts, "dr_rf")
    if dr.ate != DR_TAU:
        raise AssertionError(f"DR-RF τ moved: {dr.ate!r}, recorded {DR_TAU!r}")
    ROWS.update(oracle=oracle, naive=naive)
    out = {"phase": "path", "rows": frame_mod.n, "trees": DR_TREES, "depth": DEPTH,
           "oracle": [oracle.ate, oracle.se], "naive": [naive.ate, naive.se],
           "dr_rf_sandwich": [dr.ate, dr.se], "dr_rf_bootstrap": [dr_boot.ate, dr_boot.se],
           "propensity_range": [float(p_rf.min()), float(p_rf.max())],
           "stages": stages, "launches": counts}
    emit(out)
    return counts


def phase_parity(frame_mod) -> None:
    key = rnd.key(12325, device="cuda")
    card = fo.fit_forest_classifier(frame_mod.x, frame_mod.w, key, n_trees=PARITY_TREES, depth=DEPTH)
    cpu_frame = frame_mod.to("cpu")
    host = fo.fit_forest_classifier(cpu_frame.x, cpu_frame.w, key.cpu(), n_trees=PARITY_TREES, depth=DEPTH)
    for f in ("split_feat", "split_bin", "leaf_value", "counts", "train_leaf", "bin_edges", "train_fp"):
        if not torch.equal(getattr(card, f).cpu(), getattr(host, f)):
            raise AssertionError(f"card and CPU forests differ in {f}")
    v_card = fo.predict_forest(card, frame_mod.x, oob=True).vote
    v_host = fo.predict_forest(host, cpu_frame.x, oob=True).vote
    if not torch.equal(v_card.cpu(), v_host):
        raise AssertionError("card and CPU OOB votes differ")
    r_card = doubly_robust(frame_mod, lambda f: v_card)
    r_host = doubly_robust(cpu_frame, lambda f: v_host)
    d_tau, d_se = abs(r_card.ate - r_host.ate), abs(r_card.se - r_host.se)
    if not (d_tau <= TAU_BOUND and d_se <= TAU_BOUND):
        raise AssertionError(f"card vs CPU DR: |Δτ| {d_tau}, |Δse| {d_se} > {TAU_BOUND}")
    emit({"phase": "parity", "trees": PARITY_TREES, "forest_equal": True, "votes_equal": True,
          "tau_card": r_card.ate, "tau_cpu": r_host.ate, "abs_dtau": d_tau, "abs_dse": d_se,
          "bound": TAU_BOUND})


def sweep_key(name: str, device: str) -> torch.Tensor:
    """The sweep's per-stage key: fold_in(key(0), crc32(name))
    (``ate_replication_causalml_tpu/pipeline.py:586-589``)."""
    return rnd.fold_in(rnd.key(0, device=device), zlib.crc32(name.encode()))


def phase_path_cf(frame_mod) -> tuple[dict, dict]:
    """The "Causal Forest(GRF)" row through its entry point."""
    stages: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    rep = causal_forest_report(frame_mod, key=sweep_key("causal_forest", "cuda"), n_trees=CF_TREES,
                               depth=CF_DEPTH, nuisance_trees=CF_NUISANCE_TREES,
                               nuisance_depth=DEPTH, stage_times=stages)
    sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    r = rep.result
    for label, v in (("ATE", r.ate), ("SE", r.se), ("incorrect ATE", rep.incorrect_ate),
                     ("incorrect SE", rep.incorrect_se)):
        if not math.isfinite(v):
            raise AssertionError(f"causal forest {label} is not finite: {v}")
    if not r.se > 0:
        raise AssertionError(f"causal forest SE is not positive: {r.se}")
    require_launched(counts, UNPACKED_KERNELS, "causal forest")
    require_unpacked(counts, "causal forest")
    require_row_launches(counts, "causal_forest")
    out = {"phase": "path_cf", "method": r.method, "rows": frame_mod.n, "trees": CF_TREES,
           "depth": CF_DEPTH, "nuisance_trees": CF_NUISANCE_TREES, "nuisance_depth": DEPTH,
           "ate": r.ate, "se": r.se, "ci": [r.lower_ci, r.upper_ci],
           "incorrect_ate": rep.incorrect_ate, "incorrect_se": rep.incorrect_se,
           "stages": stages, "wall_s": wall, "launches": counts}
    emit(out)
    if (r.ate, r.se) != (CF_ATE, CF_SE):
        raise AssertionError(f"causal ATE/SE moved: {r.ate!r}/{r.se!r}, recorded "
                             f"{CF_ATE!r}/{CF_SE!r}")
    return counts, out


def serve_submit(server, rid: str, x, on_fault=None):
    """submit(), retried on the typed retryable rejects as a client does."""
    for _ in range(2000):
        try:
            return server.submit(rid, x)
        except RejectedRequest as rej:
            if rej.code == "serve_fault" and on_fault is not None:
                on_fault(rid)
            elif rej.code not in ("overloaded", "degraded", "serve_fault"):
                raise
            time.sleep(rej.retry_after_s or 0.002)
    raise AssertionError(f"path_serve: no progress on {rid}")


def phase_path_serve(frame_mod, smi: str) -> dict:
    """The CATE serving daemon on the causal row's forest: save_fitted,
    CateServer(...).startup() on the card, requests from producer
    threads through submit() and from the port's client over
    serve_socket, then stop(), which holds the window to no kernel build
    and no graph capture. Every served row is held bit for bit to
    offline ``predict_cate(forest, x, oob=False)`` on the card."""
    fitted = cf.fit_causal_forest(frame_mod, key=sweep_key("causal_forest", "cuda"),
                                  n_trees=CF_TREES, depth=CF_DEPTH,
                                  nuisance_trees=CF_NUISANCE_TREES, nuisance_depth=DEPTH)
    forest = fitted.forest
    shutil.rmtree(os.path.dirname(SERVE_CKPT), ignore_errors=True)
    t0 = time.perf_counter()
    save_fitted(SERVE_CKPT, fitted)
    save_s = time.perf_counter() - t0
    # Real covariate rows of the frame, new data to the forest (oob=False).
    x_all = frame_mod.x.float().cpu().numpy()
    n_req = SERVE_REQUESTS + SERVE_SEQUENTIAL + SERVE_WIRE
    xs, off = [], 0
    for i in range(n_req):
        m = SERVE_SIZES[i % len(SERVE_SIZES)]
        if off + m > x_all.shape[0]:
            off = 0
        xs.append(np.ascontiguousarray(x_all[off:off + m]))
        off += m
    ref = cf.predict_cate(forest, torch.as_tensor(np.concatenate(xs), device="cuda"), oob=False)
    ref_c, ref_v = ref.cate.cpu().numpy(), ref.variance.cpu().numpy()
    starts = np.cumsum([0] + [x.shape[0] for x in xs])
    # The kernel at this path's shapes against its plain version (a
    # 32-tree chunk, the largest and the smallest bucket), uncounted.
    for rows in (256, 1):
        codes = fo.binarize(torch.as_tensor(x_all[:rows], device="cuda"), forest.bin_edges)
        args = (codes, forest.split_feat[:32].contiguous(), forest.split_bin[:32].contiguous(),
                forest.leaf_stats[:32].contiguous())
        if not torch.equal(tree.traverse(*args), tree.traverse_plain(*args)):
            raise AssertionError(f"path_serve: traverse differs from its plain version at "
                                 f"{rows} rows")
    fails: list[str] = []

    def check(label: str, i: int, got) -> None:
        c, v = got
        a, b = starts[i], starts[i + 1]
        if not (np.array_equal(c, ref_c[a:b]) and np.array_equal(v, ref_v[a:b])):
            fails.append(f"{label} request {i} differs from offline predict_cate")

    batches0 = sum((obs.REGISTRY.peek("serving_batches_total") or {}).values())
    reset_counts()
    t0 = time.perf_counter()
    server = CateServer(ServeConfig(checkpoint=SERVE_CKPT, buckets=BucketPlan.parse(SERVE_BUCKETS),
                                    window_s=0.002, max_depth=64, device="cuda"))
    phases = server.startup()
    startup_wall = time.perf_counter() - t0
    warm_traverse = tree.traverse.launches
    per_replay = server._predicts[next(iter(server._predicts))].traverse_per_replay
    # Producers: SERVE_PRODUCERS threads, each its share of the requests.
    done: dict[int, object] = {}
    errors: list[str] = []

    def producer(k: int) -> None:
        try:
            mine = [(i, serve_submit(server, f"r{i}", xs[i]))
                    for i in range(k, SERVE_REQUESTS, SERVE_PRODUCERS)]
            for i, req in mine:
                if not req.wait(60) or req.error is not None:
                    errors.append(f"r{i}: {req.error}")
                done[i] = req
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(f"producer {k}: {type(e).__name__}: {e}")

    # The port's client over a socket, concurrently.
    bound: list[int] = []
    sock_thread = threading.Thread(target=serve_socket, args=(server, "127.0.0.1", 0),
                                   kwargs={"on_bound": bound.append}, daemon=True)
    sock_thread.start()
    t_wait = time.monotonic()
    while not bound and time.monotonic() - t_wait < 30:
        time.sleep(0.01)
    wire_lat = []
    t0 = time.perf_counter()
    threads = [threading.Thread(target=producer, args=(k,)) for k in range(SERVE_PRODUCERS)]
    for t in threads:
        t.start()
    with CateClient.connect("127.0.0.1", bound[0]) as client:
        if client.ping()["state"] != "serving":
            fails.append("ping: not serving")
        for j in range(SERVE_WIRE):
            i = SERVE_REQUESTS + SERVE_SEQUENTIAL + j
            t1 = time.perf_counter()
            got = client.predict(xs[i], request_id=f"w{i}")
            wire_lat.append(time.perf_counter() - t1)
            check("wire", i, got)
        for t in threads:
            t.join()
        serve_wall = time.perf_counter() - t0
        wire_stats = client.stats()
    if errors:
        raise AssertionError("path_serve: " + "; ".join(errors[:5]))
    for i, req in done.items():
        check("submit", i, req.result)
    served_rows = sum(x.shape[0] for x in xs[:SERVE_REQUESTS]) + sum(
        x.shape[0] for x in xs[SERVE_REQUESTS + SERVE_SEQUENTIAL:])
    loaded: dict[int, list] = {}
    for req in done.values():
        loaded.setdefault(req.batch_bucket, []).append(req.resolved_mono - req.enqueued_mono)
    lat: dict[int, list] = {}
    for i in range(SERVE_REQUESTS, SERVE_REQUESTS + SERVE_SEQUENTIAL):
        req = serve_submit(server, f"s{i}", xs[i])
        if not req.wait(60) or req.error is not None:
            fails.append(f"s{i}: {req.error}")
            continue
        check("sequential", i, req.result)
        lat.setdefault(req.batch_bucket, []).append(req.resolved_mono - req.enqueued_mono)
    # A burst past the admission depth: typed rejects, never a queue.
    burst_codes: dict[str, int] = {}
    burst = []
    for i in range(4 * 64):
        try:
            burst.append(server.submit(f"b{i}", xs[6]))
        except RejectedRequest as rej:
            burst_codes[rej.code] = burst_codes.get(rej.code, 0) + 1
    for req in burst:
        if not req.wait(60) or req.error is not None:
            fails.append(f"burst request {req.request_id}: {req.error}")
        else:
            check("burst", 6, req.result)
    if not burst_codes.get("overloaded"):
        fails.append(f"burst past depth 64 drew no overloaded reject: {burst_codes}")
    # Chaos: a seeded serve: fault set, degraded mode, verified reload.
    faulted: list[str] = []
    ids = [f"c{i}" for i in range(SERVE_CHAOS_REQUESTS)]
    t1 = time.perf_counter()
    with chaos.override(SERVE_CHAOS):
        for i, rid in enumerate(ids):
            req = serve_submit(server, rid, xs[i], on_fault=faulted.append)
            if not req.wait(60) or req.error is not None:
                fails.append(f"chaos request {rid}: {req.error}")
            else:
                check("chaos", i, req.result)
    chaos_s = time.perf_counter() - t1
    expected = [rid for rid in ids if chaos._unit(11, "serve", rid) < 0.25]
    if faulted != expected or not expected:
        fails.append(f"chaos faulted {faulted}, planned {expected}")
    if server.lifecycle.state != "serving" or server.lifecycle.reload_count < 1:
        fails.append(f"chaos: state {server.lifecycle.state}, "
                     f"reloads {server.lifecycle.reload_count}")
    window = server.builds_in_window()
    stats = server.stats()
    server.stop()
    sock_thread.join(10)
    counts = read_counts()
    batches = sum((obs.REGISTRY.peek("serving_batches_total") or {}).values()) - batches0
    n_warm = len(server.config.buckets.sizes)
    # The checkpoint is fitted: startup's index phase builds its
    # training panel's leaf indices (one traverse a 32-tree chunk).
    if counts["traverse"] != per_replay * (2 * n_warm + batches + 1):
        fails.append(f"traverse launches {counts['traverse']}, want {per_replay} x "
                     f"({2 * n_warm} warm-up and warm + {batches} batches + 1 leaf index)")
    if any(window.values()):
        fails.append(f"builds in the serving window: {window}")
    require_launched(counts, ("traverse",), "serve")
    others = {k: v for k, v in counts.items() if k != "traverse" and v}
    if others:
        fails.append(f"kernels other than traverse launched: {others}")
    used = {int(k.split("=")[1]) for k, v in (obs.REGISTRY.peek("serving_batches_total") or {}
                                              ).items() if v and k}
    if used != set(BucketPlan.parse(SERVE_BUCKETS).sizes) or set(lat) != used:
        fails.append(f"buckets used {sorted(used)}, one at a time {sorted(lat)}")
    pct = lambda v, q: float(np.percentile(np.asarray(v) * 1e3, q))
    out = {"phase": "path_serve", "nvidia_smi": smi, "trees": CF_TREES, "depth": CF_DEPTH,
           "features": int(x_all.shape[1]), "buckets": SERVE_BUCKETS,
           "checkpoint_mb": os.path.getsize(SERVE_CKPT) / 2**20, "save_s": save_s,
           "startup_s": phases, "startup_wall_s": startup_wall,
           "requests": {"submit": SERVE_REQUESTS, "sequential": SERVE_SEQUENTIAL,
                        "wire": SERVE_WIRE, "burst": len(burst), "chaos": SERVE_CHAOS_REQUESTS},
           "rows": served_rows, "serve_wall_s": serve_wall, "rows_per_s": served_rows / serve_wall,
           "latency_ms": {str(b): {"count": len(v), "p50": pct(v, 50), "p99": pct(v, 99)}
                          for b, v in sorted(lat.items())},
           "loaded_latency_ms": {str(b): {"count": len(v), "p50": pct(v, 50), "p99": pct(v, 99)}
                                 for b, v in sorted(loaded.items())},
           "wire_latency_ms": {"p50": pct(wire_lat, 50), "p99": pct(wire_lat, 99)},
           "batches": batches, "traverse_per_replay": per_replay,
           "warm_traverse": warm_traverse, "builds_in_window": window,
           "close_reasons": stats["close_reasons"], "burst_rejects": burst_codes,
           "chaos": {"faulted": len(faulted), "reloads": server.lifecycle.reload_count,
                     "seconds": chaos_s},
           "wire_stats_compile_events": wire_stats["compile_events_in_window"],
           "launches": counts}
    emit(out)
    if fails:
        raise AssertionError("path_serve: " + "; ".join(fails[:8]))
    return counts


def http_status(port: int, path: str) -> int:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def span_bounds(records: list, name: str) -> tuple[float, float] | None:
    """(start, end) monotonic seconds of the last ``name`` record."""
    recs = [r for r in records if r["name"] == name]
    return (recs[-1]["start_mono_s"], recs[-1]["end_mono_s"]) if recs else None


def phase_path_serve_lifecycle(frame_mod, smi: str, cf_counts: dict) -> dict:
    """The serving plane's model lifecycle on the card: path_serve's
    fitted checkpoint behind the daemon at path_serve's defaults with the
    admin endpoint and the trace on, a second fleet model (``tenant_b``)
    on the same checkpoint; startup's index phase; seeded open-loop load
    (``loadgen.run_inprocess``) while the retrain supervisor fits the
    causal row's forest again with another key on its own stream,
    publishes, verifies, prebuilds the leaf index and swaps; an operator
    rotation over the wire to a corrupt copy (refused); ``/readyz`` and
    ``/healthz`` polled over HTTP throughout; the ``dump`` op; tenant_b
    retired; ``stop()``. Gates: every reply bit for bit the offline
    ``predict_cate`` of the version it names, 0 builds and captures, the
    fit's launches those of path_cf's fit, the dump's reports recomputed
    byte for byte, probes 200 throughout."""
    from ate_replication_causalml_torch.serving.retrain import RetrainConfig

    shutil.rmtree(LIFECYCLE_OUT, ignore_errors=True)
    publish = os.path.join(LIFECYCLE_OUT, "publish")
    os.makedirs(publish)
    v1 = load_fitted(SERVE_CKPT, device="cuda")
    n_panel = int(v1.x.shape[0])
    # The kernel at this path's shapes: the leaf-index build's ids mode on
    # the panel (a 32-tree chunk) against its plain version, uncounted.
    codes = fo.binarize(v1.x, v1.forest.bin_edges)
    args = (codes, v1.forest.split_feat[:32].contiguous(), v1.forest.split_bin[:32].contiguous())
    if not torch.equal(tree.traverse(*args), tree.traverse_plain(*args)):
        raise AssertionError("path_serve_lifecycle: traverse (ids) differs from its plain version")
    schedule = loadgen.build_schedule(LIFECYCLE_SEED, int(LIFECYCLE_RATE_HZ * LIFECYCLE_SECONDS),
                                      rate_hz=LIFECYCLE_RATE_HZ,
                                      mix=",".join(str(m) for m in SERVE_SIZES))
    queries = loadgen.build_queries(LIFECYCLE_SEED, schedule, int(v1.x.shape[1]))
    post_schedule = loadgen.build_schedule(
        LIFECYCLE_SEED + 1, int(LIFECYCLE_RATE_HZ * LIFECYCLE_POST_SECONDS),
        rate_hz=LIFECYCLE_RATE_HZ, mix=",".join(str(m) for m in SERVE_SIZES), id_prefix="p")
    post_queries = loadgen.build_queries(LIFECYCLE_SEED + 1, post_schedule, int(v1.x.shape[1]))
    fails: list[str] = []
    # The host's garbage collections over the phase (monotonic start, ms,
    # generation), beside the slowest replies: what stalls the dispatcher.
    gc_runs: list[tuple[float, float, int]] = []
    gc_t: list[float] = [0.0]

    def on_gc(stage: str, info: dict) -> None:
        if stage == "start":
            gc_t[0] = time.monotonic()
        else:
            gc_runs.append((gc_t[0], (time.monotonic() - gc_t[0]) * 1e3, info["generation"]))

    gc.callbacks.append(on_gc)
    reset_counts()
    batches0 = sum((obs.REGISTRY.peek("serving_batches_total") or {}).values())
    t0 = time.perf_counter()
    server = CateServer(ServeConfig(checkpoint=SERVE_CKPT, buckets=BucketPlan.parse(SERVE_BUCKETS),
                                    window_s=0.002, max_depth=64, admin_port=0,
                                    fleet=(("tenant_b", SERVE_CKPT),), device="cuda"))
    phases = server.startup()
    startup_wall = time.perf_counter() - t0
    per_replay = server._predicts[next(iter(server._predicts))].traverse_per_replay
    rows_before = {m: server.stats()["fleet"][m]["leaf_index_rows"] for m in ("default", "tenant_b")}
    if set(phases) != {"load", "aot", "warm", "index"} or any(
            r != n_panel for r in rows_before.values()):
        fails.append(f"startup phases {sorted(phases)}, leaf_index_rows {rows_before}")
    admin = server.stats()["admin_port"]
    probes: list[tuple[int, int]] = []
    stop_probes = threading.Event()

    def poll() -> None:
        while not stop_probes.is_set():
            probes.append((http_status(admin, "/readyz"), http_status(admin, "/healthz")))
            stop_probes.wait(0.05)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    replies: list = []
    record: dict = {}
    load_errors: list[str] = []

    def run_load() -> None:
        try:
            record.update(loadgen.run_inprocess(server, schedule, queries, replies=replies,
                                                timeout_s=120.0))
        except Exception as e:  # noqa: BLE001 — reported and failed below
            load_errors.append(f"{type(e).__name__}: {e}")

    load = threading.Thread(target=run_load, name="loadgen")
    load_t0 = time.monotonic()
    load.start()
    time.sleep(LIFECYCLE_RETRAIN_AFTER_S)
    fit_times: list[float] = []
    fitted: list = []

    def fit_fn():
        t = time.monotonic()
        out = cf.fit_causal_forest(frame_mod, key=sweep_key("causal_forest_retrain", "cuda"),
                                   n_trees=CF_TREES, depth=CF_DEPTH,
                                   nuisance_trees=CF_NUISANCE_TREES, nuisance_depth=DEPTH)
        fit_times.extend((t, time.monotonic()))
        fitted.append(out)
        return out

    retrain_t0 = time.monotonic()
    outcome = server.retrain_supervisor("default", fit_fn, publish,
                                        config=RetrainConfig(max_attempts=1)).run_once()
    retrain_t1 = time.monotonic()
    window_after_swap = server.builds_in_window()
    load.join(LIFECYCLE_SECONDS + 180)
    if load_errors or load.is_alive():
        raise AssertionError(f"path_serve_lifecycle: load failed: {load_errors}")
    if outcome.status != "rotated":
        raise AssertionError(f"path_serve_lifecycle: retrain {outcome}")
    records = [r for r in obs.EVENTS.records() if r.get("start_mono_s", 0.0) >= load_t0 - 1.0]
    rotation = span_bounds(records, "serving_rotation")
    prebuild = span_bounds(records, "serving_leaf_index_prebuild")
    swap_mono = max(r["start_mono_s"] for r in records if r["name"] == "serving_model_rotated")
    v2 = load_fitted(outcome.checkpoint, device="cuda")
    # The retrained checkpoint is path_serve_fleet's rotation candidate.
    ROWS["serve_v2"] = outcome.checkpoint
    post_replies: list = []
    post_record = loadgen.run_inprocess(server, post_schedule, post_queries,
                                        replies=post_replies, timeout_s=120.0)
    # An operator rotation over the wire to a corrupt copy: refused.
    corrupt = os.path.join(LIFECYCLE_OUT, "corrupt.npz")
    with open(outcome.checkpoint, "rb") as f:
        raw = f.read()
    # graftlint: disable=JGL005 — writes a deliberately truncated copy: the corrupt candidate the rotation must refuse
    with open(corrupt, "wb") as f:
        f.write(raw[: len(raw) * 3 // 5])
    bound: list[int] = []
    sock_thread = threading.Thread(target=serve_socket, args=(server, "127.0.0.1", 0),
                                   kwargs={"on_bound": bound.append}, daemon=True)
    sock_thread.start()
    t_wait = time.monotonic()
    while not bound and time.monotonic() - t_wait < 30:
        time.sleep(0.01)
    dump_dir = os.path.join(LIFECYCLE_OUT, "dump")
    wire: list = []
    with CateClient.connect("127.0.0.1", bound[0]) as client:
        refused = client.rotate(corrupt)
        for i in range(4):
            c, v, header = client.predict_full(queries[i], request_id=f"post{i}")
            wire.append((i, c, v, header))
        b_before = server.serve_request("tenant_b_0", queries[5], model="tenant_b")
        retired = client.retire("tenant_b")
        try:
            server.serve_one("tenant_b_1", queries[5], model="tenant_b")
            retired_code = None
        except RejectedRequest as rej:
            retired_code = rej.code
        paths = client.dump(dump_dir)
        stats = client.stats()
    stop_probes.set()
    poller.join(10)
    window = server.builds_in_window()
    server.stop()
    gc.callbacks.remove(on_gc)
    sock_thread.join(10)
    counts = read_counts()
    batches = sum((obs.REGISTRY.peek("serving_batches_total") or {}).values()) - batches0
    if refused != "refused":
        fails.append(f"corrupt candidate: {refused}")
    if retired is not True or retired_code != "retired_model":
        fails.append(f"retire: {retired}, tenant_b after it {retired_code}")
    # Every reply bit for bit its version's offline predict on the card.
    forests = {1: v1.forest, 2: v2.forest}
    items = [(r.request_id, r.result, r.model_version, r) for r in replies + post_replies]
    by_id = {s.request_id: q for s, q in zip(schedule + post_schedule, queries + post_queries)}
    xs = [by_id[rid] for rid, *_ in items] + [queries[i] for i, *_ in wire] + [queries[5]]
    cat = torch.as_tensor(np.concatenate(xs), device="cuda")
    refs = {v: cf.predict_cate(f, cat, oob=False) for v, f in forests.items()}
    refs = {v: (o.cate.cpu().numpy(), o.variance.cpu().numpy()) for v, o in refs.items()}
    starts = np.cumsum([0] + [x.shape[0] for x in xs])
    got = [(res, ver) for _, res, ver, _ in items]
    got += [((c, v), h["model_version"]) for _, c, v, h in wire]
    got += [(b_before.result, b_before.model_version)]
    for k, ((c, v), ver) in enumerate(got):
        a, b = starts[k], starts[k + 1]
        if ver not in refs or not (np.array_equal(c, refs[ver][0][a:b])
                                   and np.array_equal(v, refs[ver][1][a:b])):
            fails.append(f"reply {k} (version {ver}) differs from its version's offline predict")
    if any(h["model_version"] != 2 for *_, h in wire):
        fails.append("wire replies after the refused rotation not on version 2")
    late = [r for *_, r in items if r.enqueued_mono > swap_mono and r.model_version != 2]
    early = [r for *_, r in items if r.resolved_mono < swap_mono and r.model_version != 1]
    if late or early or not post_replies:
        fails.append(f"{len(late)} replies enqueued after the swap not on v2, {len(early)} "
                     f"resolved before it not on v1, {len(post_replies)} after it")
    if any(window_after_swap.values()) or any(window.values()):
        fails.append(f"builds in the window: after the swap {window_after_swap}, end {window}")
    if not probes or any(p != (200, 200) for p in probes):
        fails.append(f"admin probes not all 200: {sorted(set(probes))} of {len(probes)}")
    rows_after = stats["fleet"]["default"]["leaf_index_rows"]
    if rows_after != n_panel:
        fails.append(f"leaf_index_rows after the swap {rows_after}")
    names = {os.path.basename(p) for p in paths}
    want_names = {"metrics.json", "events.jsonl", "metrics.prom", "trace.json",
                  "serving_report.json", "slo_report.json", "stat_health.json"}
    if names != want_names:
        fails.append(f"dump wrote {sorted(names)}")
    else:
        with open(os.path.join(dump_dir, "trace.json")) as f:
            trace = json.load(f)
        with open(os.path.join(dump_dir, "metrics.json")) as f:
            metrics = json.load(f)
        with open(os.path.join(dump_dir, "serving_report.json"), "rb") as f:
            dumped = f.read()
        if (json.dumps(sreport.serving_report(trace, metrics), indent=1) + "\n").encode() != dumped:
            fails.append("serving_report.json does not recompute from trace.json")
        with open(os.path.join(dump_dir, "stat_health.json"), "rb") as f:
            sh = f.read()
        again = stathealth.stat_health_report(json.loads(sh)["state"])
        if (json.dumps(again, indent=1) + "\n").encode() != sh:
            fails.append("stat_health.json does not recompute from its state")
    # Launches: the fit's kernels those of path_cf's fit (its predict's
    # traverse taken out); traverse: warm-up and warm, the batches, three
    # leaf-index builds (two at startup, the prebuild).
    fit_want = dict(cf_counts, traverse=cf_counts["traverse"]
                    - ROW_LAUNCHES["causal_forest"]["traverse"])
    n_warm = len(server.config.buckets.sizes)
    trav_want = per_replay * (2 * n_warm + batches + 3) + fit_want["traverse"]
    fit_got = {k: v for k, v in counts.items() if k != "traverse"}
    if fit_got != {k: v for k, v in fit_want.items() if k != "traverse"}:
        fails.append(f"retrain fit launches {fit_got}, path_cf's fit {fit_want}")
    if counts["traverse"] != trav_want:
        fails.append(f"traverse launches {counts['traverse']}, want {trav_want} ({per_replay} x "
                     f"({2 * n_warm} + {batches} batches + 3 leaf-index builds))")
    # Latency by bucket before the fit, inside the retrain (fit start to
    # the swap) and after it; "outside" pools before and after.
    retrain_lo, retrain_hi = fit_times[0], rotation[1]
    lat: dict = {"before": {}, "inside": {}, "after": {}, "outside": {}}
    for *_, r in items:
        t = r.enqueued_mono
        side = "before" if t < retrain_lo else "inside" if t <= retrain_hi else "after"
        for key in (side, "outside") if side != "inside" else (side,):
            lat[key].setdefault(r.batch_bucket, []).append(r.resolved_mono - r.enqueued_mono)
    pct = lambda v, q: float(np.percentile(np.asarray(v) * 1e3, q))
    slowest = sorted((r for *_, r in items), key=lambda r: r.enqueued_mono - r.resolved_mono)[:8]
    out = {"phase": "path_serve_lifecycle", "nvidia_smi": smi, "trees": CF_TREES,
           "depth": CF_DEPTH, "panel_rows": n_panel, "startup_s": phases,
           "startup_wall_s": startup_wall, "leaf_index_rows": [rows_before, rows_after],
           "retrain": {"status": outcome.status, "attempts": outcome.attempts,
                       "checkpoint": os.path.basename(outcome.checkpoint),
                       "fit_s": fit_times[1] - fit_times[0],
                       "run_s": retrain_t1 - retrain_t0,
                       "verify_s": prebuild[0] - rotation[0],
                       "prebuild_s": prebuild[1] - prebuild[0],
                       "swap_s": rotation[1] - prebuild[1]},
           "load": record, "post_swap_load": post_record, "rate_hz": LIFECYCLE_RATE_HZ,
           "batches": batches,
           "latency_ms": {side: {str(b): {"count": len(v), "p50": pct(v, 50), "p99": pct(v, 99)}
                                 for b, v in sorted(d.items())} for side, d in lat.items()},
           "rejects": {"retried": record.get("reject_retries"), "corrupt_rotation": refused,
                       "retired": retired_code},
           "close_reasons": stats["close_reasons"], "probes": len(probes),
           "builds_in_window": window, "stat_health_rows": stats["stat_health"]["models"][
               "default"]["rows"], "launches": counts, "phase_s": time.perf_counter() - t0,
           # Seconds from the swap (negative: before it).
           "slowest": [{"at_s": r.enqueued_mono - swap_mono, "ms": (r.resolved_mono - r.enqueued_mono)
                        * 1e3, "bucket": r.batch_bucket, "version": r.model_version}
                       for r in slowest],
           "gc": {"runs": len(gc_runs), "ms": sum(ms for _, ms, _ in gc_runs),
                  "over_5ms": [{"at_s": t - swap_mono, "ms": ms, "generation": g}
                               for t, ms, g in gc_runs if ms > 5.0]}}
    emit(out)
    if fails:
        raise AssertionError("path_serve_lifecycle: " + "; ".join(fails[:8]))
    return counts


class FleetDaemon:
    """One daemon subprocess of path_serve_fleet: ``python -m
    ate_replication_causalml_torch.serving`` on ephemeral wire and admin
    ports, fault-free (``ATE_TPU_CHAOS`` popped), its stderr copied to
    ``<name>.log`` and read for the bound ports."""

    def __init__(self, name: str, checkpoint: str, log_dir: str):
        import re

        self.name = name
        self.port = self.admin_port = None
        self._ready = threading.Event()
        env = dict(os.environ)
        env.pop("ATE_TPU_CHAOS", None)
        fleet = ",".join(f"{m}={checkpoint}" for m in FLEET_MODELS[1:])
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ate_replication_causalml_torch.serving",
             "--checkpoint", checkpoint, "--port", "0", "--admin-port", "0",
             "--buckets", SERVE_BUCKETS, "--window-ms", "2", "--fleet", fleet],
            cwd=REPO, env=env, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        self.ready_s = None
        self.log_path = os.path.join(log_dir, f"{name}.log")
        pat = {"port": re.compile(r"^# serving on \S+:(\d+)"),
               "admin_port": re.compile(r"^# admin endpoint on \S+:(\d+)")}

        def read() -> None:
            # graftlint: disable=JGL005 — a live log streamed line by line from the daemon's stderr
            with open(self.log_path, "w") as log:
                for line in self.proc.stderr:
                    log.write(line)
                    log.flush()
                    for key, rx in pat.items():
                        m = rx.match(line)
                        if m:
                            setattr(self, key, int(m.group(1)))
                    if self.port and self.admin_port and not self._ready.is_set():
                        self.ready_s = time.perf_counter() - self.t0
                        self._ready.set()
            self._ready.set()

        self._reader = threading.Thread(target=read, name=f"fleet-log-{name}", daemon=True)
        self._reader.start()

    def wait_ready(self, timeout: float) -> None:
        if not self._ready.wait(timeout) or self.port is None or self.admin_port is None:
            with open(self.log_path) as f:
                tail = f.read()[-2000:]
            raise AssertionError(f"path_serve_fleet: daemon {self.name} did not come up "
                                 f"(exit {self.proc.poll()}): {tail}")

    def varz(self) -> dict:
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{self.admin_port}/varz",
                                    timeout=10) as r:
            return json.load(r)

    def stop(self, timeout: float = 30.0) -> int | None:
        """Wait for the process to exit (a shutdown op was sent); kill it
        past ``timeout``. Returns its exit code."""
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)
        self._reader.join(10)
        return self.proc.returncode


def varz_total(varz: dict, family: str) -> float:
    return float(sum(s["value"] for s in varz.get(family) or []))


def phase_path_serve_fleet(smi: str) -> dict:
    """The serving router over three daemon subprocesses on the card:
    path_serve's fitted checkpoint served as ``default``, ``m2`` and ``m3``
    by ``b0``, ``b1`` and ``b2`` (buckets 1,8,64,256, a 2 ms window; the
    kernels phase_build built), the router in this process
    (``FLEET_PROBE_S`` probes, ``FLEET_FAILOVER`` hops) behind its own
    socket and admin endpoint; FLEET_REQUESTS seeded requests on
    FLEET_CLIENTS client connections paced by the schedule;
    ``rotate_all`` of ``default`` to path_serve_lifecycle's retrained
    checkpoint at request FLEET_ROTATE_AT; the victim ``FLEET_CHAOS`` draws
    SIGKILLed at FLEET_KILL_AT; ``dump_fleet``; the survivors shut down
    over the wire. Gates: every reply ok and bit for bit the offline
    ``predict_cate`` on the card of the version its header names,
    ``default`` v2 served and ``m2`` / ``m3`` v2 never, every rotation
    ``rotated`` at version 2 with no build or capture after its swap and
    two backends in rotation throughout, the victim evicted within two
    probe intervals and the probe timeout and marked out of rotation in
    the manifest, no router orphan and a consistent reconciliation, the
    merged artifacts recomputing byte for byte, the router's ``/readyz``
    200, ``traverse`` launched on every daemon."""
    from ate_replication_causalml_torch.observability import fleet_report as freport
    from ate_replication_causalml_torch.serving import router as rt
    from ate_replication_causalml_torch.serving.admin import AdminServer

    shutil.rmtree(FLEET_OUT, ignore_errors=True)
    os.makedirs(FLEET_OUT)
    v2_path = os.path.join(FLEET_OUT, "forest-v2.npz")
    shutil.copyfile(ROWS["serve_v2"], v2_path)
    fits = {1: load_fitted(SERVE_CKPT, device="cuda"), 2: load_fitted(v2_path, device="cuda")}
    features = int(fits[1].x.shape[1])
    schedule = loadgen.build_schedule(FLEET_SEED, FLEET_REQUESTS, rate_hz=FLEET_RATE_HZ,
                                      mix=",".join(str(m) for m in SERVE_SIZES),
                                      models=FLEET_MODELS)
    queries = loadgen.build_queries(FLEET_SEED, schedule, features)
    starts = np.cumsum([0] + [q.shape[0] for q in queries])
    # Offline references on the card, before any daemon starts.
    cat = torch.as_tensor(np.concatenate(queries), device="cuda")
    refs = {}
    for ver, fit in fits.items():
        out = cf.predict_cate(fit.forest, cat, oob=False)
        refs[ver] = (out.cate.cpu().numpy(), out.variance.cpu().numpy())
    # The daemons' kernel at this path's shapes (a 32-tree chunk of each
    # version, the largest and the smallest bucket) against its plain
    # version, uncounted.
    for ver, fit in fits.items():
        f = fit.forest
        for rows in (256, 1):
            codes = fo.binarize(cat[:rows], f.bin_edges)
            args = (codes, f.split_feat[:32].contiguous(), f.split_bin[:32].contiguous(),
                    f.leaf_stats[:32].contiguous())
            if not torch.equal(tree.traverse(*args), tree.traverse_plain(*args)):
                raise AssertionError(f"path_serve_fleet: traverse differs from its plain "
                                     f"version at {rows} rows (v{ver})")
    del cat, fits, f, codes, args
    torch.cuda.empty_cache()
    buckets = BucketPlan.parse(SERVE_BUCKETS).sizes
    fails: list[str] = []
    reset_counts()
    t_phase = time.perf_counter()
    daemons = {name: FleetDaemon(name, SERVE_CKPT, FLEET_OUT) for name in FLEET_NAMES}
    router = admin = serve_thread = None
    clients: list = []
    try:
        for d in daemons.values():
            d.wait_ready(300)
        specs = tuple(rt.BackendSpec(n, "127.0.0.1", d.port, d.admin_port)
                      for n, d in daemons.items())
        path_before = dict(obs.REGISTRY.peek("router_request_path_total") or {})
        router = rt.RouterServer(rt.RouterConfig(backends=specs, probe_interval_s=FLEET_PROBE_S,
                                                 failover_hops=FLEET_FAILOVER))
        router.start()
        if router.in_rotation() != FLEET_NAMES:
            raise AssertionError(f"path_serve_fleet: in rotation {router.in_rotation()}")
        admin = AdminServer(router, handler=rt.handle_router_admin_path,
                            thread_name="router-admin")
        admin_port = admin.start(0)
        stats0 = {n: router.call_backend(n, {"op": "stats"})[0]["stats"] for n in FLEET_NAMES}
        # Each daemon's kernel libraries: nvcc runs and libraries found built.
        varz0 = {n: daemons[n].varz() for n in FLEET_NAMES}
        bound: list[int] = []
        serve_thread = threading.Thread(target=rt.serve_socket, args=(router,),
                                        kwargs={"port": 0, "on_bound": bound.append},
                                        daemon=True, name="fleet-router")
        serve_thread.start()
        t_wait = time.monotonic()
        while not bound and time.monotonic() - t_wait < 30:
            time.sleep(0.01)
        clients = [CateClient.connect("127.0.0.1", bound[0], timeout=120.0)
                   for _ in range(FLEET_CLIENTS)]
        replies: list = [None] * FLEET_REQUESTS
        errors: list[str] = []
        lock = threading.Lock()
        cursor = [0]
        reached = {FLEET_ROTATE_AT: threading.Event(), FLEET_KILL_AT: threading.Event()}
        t_load = time.monotonic()

        def worker(client) -> None:
            while True:
                with lock:
                    i = cursor[0]
                    if i >= FLEET_REQUESTS:
                        return
                    cursor[0] = i + 1
                for at, evt in reached.items():
                    if i >= at:
                        evt.set()
                sched = schedule[i]
                delay = t_load + sched.t_s - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                try:
                    replies[i] = client.predict_full(queries[i], request_id=sched.request_id,
                                                     model=sched.model, max_retries=32)
                except Exception as e:  # noqa: BLE001 — every reply must be ok
                    with lock:
                        errors.append(f"{sched.request_id}: {type(e).__name__}: {e}")

        steps: dict = {}
        control: dict = {}

        def controller() -> None:
            try:
                reached[FLEET_ROTATE_AT].wait()
                control["rotate_at"] = cursor[0]
                t = time.perf_counter()
                control["rotation"] = rt.FleetSupervisor(router).rotate_all(
                    v2_path, model="default", timeout_s=120.0,
                    on_step=lambda b, k, sec: steps.setdefault(b, {}).__setitem__(k, sec))
                control["rotate_all_s"] = time.perf_counter() - t
                reached[FLEET_KILL_AT].wait()
                control["kill_at"] = cursor[0]
                control["pre_kill"] = {n: router.call_backend(n, {"op": "stats"})[0]["stats"]
                                       for n in FLEET_NAMES}
                inj = chaos.ChaosInjector(chaos.parse_chaos(FLEET_CHAOS))
                (victim,) = inj.daemon_kill_plan(FLEET_NAMES)
                t_kill = time.monotonic()
                daemons[victim].proc.kill()
                inj.record_daemon_kill(victim)
                while victim in router.in_rotation() and time.monotonic() - t_kill < 30:
                    time.sleep(0.001)
                control["evict_s"] = time.monotonic() - t_kill
                control["victim"] = victim
                control["victim_breaker"] = router.stats()["backends"][victim]["breaker"]
                daemons[victim].proc.wait(30)
            except Exception as e:  # noqa: BLE001 — reported and failed below
                control["error"] = f"{type(e).__name__}: {e}"

        threads = [threading.Thread(target=worker, args=(c,), name=f"fleet-client-{k}")
                   for k, c in enumerate(clients)]
        ctl = threading.Thread(target=controller, name="fleet-control")
        ctl.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        load_s = time.monotonic() - t_load
        for evt in reached.values():
            evt.set()
        ctl.join(300)
        if "error" in control or ctl.is_alive():
            raise AssertionError(f"path_serve_fleet: control {control.get('error', 'hung')}")
        victim = control["victim"]
        survivors = tuple(n for n in FLEET_NAMES if n != victim)
        if errors or any(r is None for r in replies):
            fails.append(f"{len(errors)} failed replies, {replies.count(None)} missing: "
                         f"{errors[:3]}")
        # Every reply bit for bit its version's offline predict.
        served = set()
        for i, rep in enumerate(replies):
            if rep is None:
                continue
            c, v, header = rep
            ver, model = header.get("model_version"), header.get("model")
            served.add((model, ver))
            a, b = starts[i], starts[i + 1]
            if not header.get("ok") or model != schedule[i].model or ver not in refs or not (
                    np.array_equal(c, refs[ver][0][a:b]) and np.array_equal(v, refs[ver][1][a:b])):
                fails.append(f"reply {schedule[i].request_id} ({model} v{ver}) differs from its "
                             "version's offline predict")
        if ("default", 2) not in served or ("m2", 2) in served or ("m3", 2) in served:
            fails.append(f"(model, version) served: {sorted(served)}")
        rot = control["rotation"]
        if (set(rot["statuses"].values()) != {"rotated"} or rot["versions"] != {
                n: 2 for n in FLEET_NAMES} or rot["post_swap_compiles"] != {
                n: 0 for n in FLEET_NAMES} or rot["zero_downtime"] is not True
                or rot["min_in_rotation"] < 2):
            fails.append(f"rotate_all {rot}")
        evict_bound = 2 * FLEET_PROBE_S + router.config.probe_timeout_s
        if control["evict_s"] > evict_bound:
            fails.append(f"victim {victim} evicted after {control['evict_s']:.3f} s "
                         f"> {evict_bound} s")
        dump_dir = os.path.join(FLEET_OUT, "dump")
        t = time.perf_counter()
        manifest = router.dump_fleet(dump_dir)
        dump_s = time.perf_counter() - t
        if manifest["backends"][victim]["in_rotation"] is not False or not all(
                manifest["backends"][n]["dumped"] for n in survivors):
            fails.append(f"manifest backends {manifest['backends']}")
        names = (freport.FLEET_TRACE_BASENAME, freport.FLEET_REPORT_BASENAME,
                 freport.FLEET_STAT_HEALTH_BASENAME)
        written = {}
        for n in names:
            with open(os.path.join(dump_dir, n), "rb") as f:
                written[n] = f.read()
        report = json.loads(written[freport.FLEET_REPORT_BASENAME])
        freport.write_fleet_artifacts(dump_dir)
        for n in names:
            with open(os.path.join(dump_dir, n), "rb") as f:
                if f.read() != written[n]:
                    fails.append(f"{n} does not recompute byte for byte")
        if report["requests"]["orphan_router"] != 0 or not report["reconciliation"]["consistent"]:
            fails.append(f"fleet report requests {report['requests']}, reconciliation "
                         f"{report['reconciliation']}")
        readyz = http_status(admin_port, "/readyz")
        if readyz != 200:
            fails.append(f"router /readyz {readyz}")
        final = {n: router.call_backend(n, {"op": "stats"})[0]["stats"] for n in survivors}
        varz = {n: daemons[n].varz() for n in survivors}
        launches = {n: final[n]["kernel_launches"] if n in final
                    else control["pre_kill"][n]["kernel_launches"] for n in FLEET_NAMES}
        per_replay = -(-CF_TREES // 32)
        # A survivor's traverse: warm-up and warm a bucket, its batches, a
        # leaf-index build a model at startup and the rotation's prebuild.
        derived = {n: per_replay * (2 * len(buckets) + int(varz_total(
            varz[n], "serving_batches_total")) + len(FLEET_MODELS) + 1) for n in survivors}
        if any(launches[n]["traverse"] <= 0 for n in FLEET_NAMES) or any(
                launches[n]["traverse"] != derived[n] for n in survivors):
            fails.append(f"traverse launches {launches}, the survivors' derived {derived}")
        # The router's e2e by bucket, from its spans of this run.
        rows_of = {s.request_id: s.rows for s in schedule}
        e2e: dict = {}
        for r in obs.EVENTS.records():
            if r["name"] == "router_request" and r["attrs"].get("request_id") in rows_of:
                rows = rows_of[r["attrs"]["request_id"]]
                e2e.setdefault(min(b for b in buckets if b >= rows), []).append(
                    r["attrs"]["e2e_s"])
        pct = lambda v, q: float(np.percentile(np.asarray(v) * 1e3, q))
        paths = {k: v - path_before.get(k, 0)
                 for k, v in (obs.REGISTRY.peek("router_request_path_total") or {}).items()
                 if v - path_before.get(k, 0)}
        resubmitted = sum(c.retry_counts.get("connection_lost", 0) for c in clients)
        shutdown = {}
        for n in survivors:
            shutdown[n] = router.call_backend(n, {"op": "shutdown"})[0].get("ok")
        exits = {n: daemons[n].stop() for n in survivors}
        if not all(shutdown.values()) or any(exits.values()):
            fails.append(f"survivors' shutdown {shutdown}, exit codes {exits}")
        counts = read_counts()
        for n in FLEET_NAMES:
            for k, v in launches[n].items():
                counts[k] += v
        out = {"phase": "path_serve_fleet", "nvidia_smi": smi, "trees": CF_TREES,
               "depth": CF_DEPTH, "buckets": SERVE_BUCKETS, "models": list(FLEET_MODELS),
               "requests": FLEET_REQUESTS, "rate_hz": FLEET_RATE_HZ, "clients": FLEET_CLIENTS,
               "startup_s": {n: {"ready_wall_s": daemons[n].ready_s,
                                 **stats0[n]["startup_seconds"]} for n in FLEET_NAMES},
               "nvcc_builds": {n: varz_total(varz0[n], "compile_cache_misses_total")
                               for n in FLEET_NAMES},
               "libraries_loaded": {n: varz_total(varz0[n], "compile_cache_hits_total")
                                    for n in FLEET_NAMES},
               "load_s": load_s, "rotate_at": control["rotate_at"],
               "kill_at": control["kill_at"], "rotation": rot, "rotation_steps_s": steps,
               "rotate_all_s": control["rotate_all_s"], "victim": victim,
               "kill_to_evict_s": control["evict_s"], "evict_bound_s": evict_bound,
               "victim_breaker": control["victim_breaker"],
               "router_failover_total": router.failover_total(),
               "router_request_path_total": paths,
               "router_requests": router.request_counts(),
               "connection_lost_resubmits": resubmitted,
               "client_retries": [c.retry_counts for c in clients],
               "e2e_ms": {str(b): {"count": len(v), "p50": pct(v, 50), "p99": pct(v, 99)}
                          for b, v in sorted(e2e.items())},
               "residual_gap_s": report["residual_gap"],
               "fleet_requests": report["requests"],
               "reconciliation": report["reconciliation"],
               "served_versions": sorted([m, v] for m, v in served),
               "traverse_launches": {n: launches[n]["traverse"] for n in FLEET_NAMES},
               "traverse_per_replay": per_replay, "traverse_derived": derived,
               "batches": {n: varz_total(varz[n], "serving_batches_total") for n in survivors},
               "router_readyz": readyz, "dump_s": dump_s, "launches": counts,
               "phase_s": time.perf_counter() - t_phase}
        emit(out)
    finally:
        for c in clients:
            c.close()
        if router is not None:
            router.stop()
        if serve_thread is not None:
            serve_thread.join(10)
        if admin is not None:
            admin.stop()
        for d in daemons.values():
            if d.proc.poll() is None:
                d.proc.kill()
            d.stop(10)
    if fails:
        raise AssertionError("path_serve_fleet: " + "; ".join(fails[:8]))
    return counts


def path_agrees(f1, b1, f2, b2) -> np.ndarray:
    """(T, 2^D) mask of the leaves whose every split on the path agrees."""
    n_trees, depth, _ = f1.shape
    differs = (f1 != f2) | (b1 != b2)
    leaf = np.arange(1 << depth)
    ok = np.ones((n_trees, 1 << depth), bool)
    for a in range(depth):
        ok &= ~differs[:, a, leaf >> (depth - a)]
    return ok


def phase_parity_cf(frame_mod) -> cf.FittedCausalForest:
    """The causal row at 32 causal and 32 nuisance trees on the card and
    on the CPU (plain versions). The nuisance forests are integer-weight
    forests (y, w ∈ {0, 1}), equal field for field; their OOB means sum
    over trees in another order, so ŷ, ŵ and with them the residuals
    differ by ulps, and the float histograms add in another order: a
    split can flip at a float tie, which moves whole rows. Held: the
    half-samples exact, the split agreement, τ̂ and its variance, the
    ATE and its SE; and predict_cate of one forest on both devices to
    1e-6·(1 + |τ̂|) (route and lookup are exact, the reductions f32)."""
    key = sweep_key("causal_forest", "cuda")
    kw = dict(n_trees=CF_PARITY_TREES, depth=CF_DEPTH, nuisance_trees=CF_PARITY_TREES,
              nuisance_depth=DEPTH)
    card = cf.fit_causal_forest(frame_mod, key=key, **kw)
    cpu_frame = frame_mod.to("cpu")
    host = cf.fit_causal_forest(cpu_frame, key=key.cpu(), **kw)
    fc, fh = card.forest, host.forest
    if not torch.equal(fc.in_sample.cpu(), fh.in_sample):
        raise AssertionError("card and CPU half-samples differ")
    f1, b1 = fc.split_feat.cpu().numpy(), fc.split_bin.cpu().numpy()
    f2, b2 = fh.split_feat.numpy(), fh.split_bin.numpy()
    live = np.zeros(f1.shape, bool)
    for lv in range(f1.shape[1]):
        live[:, lv, : 1 << lv] = True
    agreement = float(np.mean(((f1 == f2) & (b1 == b2))[live]))
    ok = path_agrees(f1, b1, f2, b2)
    s1, s2 = fc.leaf_stats.cpu().numpy(), fh.leaf_stats.numpy()
    counts_equal = bool(np.array_equal(s1[..., 0][ok], s2[..., 0][ok]))
    leaf_rel = float(np.max(np.abs(s1 - s2)[ok] / (1 + np.abs(s2)[ok]))) if ok.any() else 0.0
    pc, ph = cf.predict_cate(fc, frame_mod.x), cf.predict_cate(fh, cpu_frame.x)
    tau_h, var_h = ph.cate.numpy(), ph.variance.numpy()
    rel_tau = np.abs(pc.cate.cpu().numpy() - tau_h) / (1 + np.abs(tau_h))
    d_tau, d_tau_mean = float(rel_tau.max()), float(rel_tau.mean())
    d_var = float(np.max(np.abs(pc.variance.cpu().numpy() - var_h) / (1 + np.abs(var_h))))
    # One forest (the CPU's) predicted on the card: isolates predict_cate.
    moved = cf.CausalForest(*(getattr(fh, f).cuda() for f in
                              ("split_feat", "split_bin", "leaf_stats", "in_sample", "bin_edges")))
    px = cf.predict_cate(moved, frame_mod.x)
    d_tau_same = float(np.max(np.abs(px.cate.cpu().numpy() - tau_h) / (1 + np.abs(tau_h))))
    ec, eh = cf.average_treatment_effect(card, pc), cf.average_treatment_effect(host, ph)
    d_ate, d_se = abs(float(ec.estimate) - float(eh.estimate)), abs(float(ec.std_err) - float(eh.std_err))
    out = {"phase": "parity_cf", "trees": CF_PARITY_TREES, "nuisance_trees": CF_PARITY_TREES,
           "y_hat_max_abs_diff": float((card.y_hat.cpu() - host.y_hat).abs().max()),
           "w_hat_max_abs_diff": float((card.w_hat.cpu() - host.w_hat).abs().max()),
           "split_agreement": agreement, "leaves_on_agreeing_paths": int(ok.sum()),
           "leaf_counts_equal": counts_equal, "leaf_stats_max_rel_diff": leaf_rel,
           "tau_max_rel_diff": d_tau, "tau_mean_rel_diff": d_tau_mean,
           "variance_max_rel_diff": d_var,
           "same_forest_tau_max_rel_diff": d_tau_same,
           "ate_card": float(ec.estimate), "ate_cpu": float(eh.estimate), "abs_date": d_ate,
           "se_card": float(ec.std_err), "se_cpu": float(eh.std_err), "abs_dse": d_se,
           "bounds": {"split_agreement": CF_SPLIT_AGREEMENT, "leaf_rel": CF_LEAF_REL,
                      "tau_rel": CF_TAU_BOUND, "tau_mean_rel": CF_TAU_MEAN_BOUND,
                      "ate": CF_ATE_BOUND, "se": CF_SE_BOUND, "same_forest_tau_rel": 1e-6}}
    emit(out)
    fails = []
    if not counts_equal:
        fails.append("leaf counts differ on agreeing paths")
    if agreement < CF_SPLIT_AGREEMENT:
        fails.append(f"split agreement {agreement} < {CF_SPLIT_AGREEMENT}")
    if not leaf_rel <= CF_LEAF_REL:
        fails.append(f"leaf statistics differ by {leaf_rel} > {CF_LEAF_REL}·(1 + |·|)")
    if not (d_tau <= CF_TAU_BOUND and d_var <= CF_TAU_BOUND and d_tau_mean <= CF_TAU_MEAN_BOUND):
        fails.append(f"τ̂/variance differ by {d_tau}/{d_var} (mean {d_tau_mean}) > "
                     f"{CF_TAU_BOUND} ({CF_TAU_MEAN_BOUND})·(1 + |·|)")
    if not d_tau_same <= 1e-6:
        fails.append(f"predict_cate of one forest differs by {d_tau_same} > 1e-6·(1 + |τ̂|)")
    if not (d_ate <= CF_ATE_BOUND and d_se <= CF_SE_BOUND):
        fails.append(f"ATE/SE differ by {d_ate}/{d_se} > {CF_ATE_BOUND}/{CF_SE_BOUND}")
    if fails:
        raise AssertionError("card vs CPU causal forest: " + "; ".join(fails))
    return card


def phase_path_cf_packed(frame_mod, cf_out: dict, card_32) -> dict:
    """The causal row under the packed-code policy: its partition levels
    (widths 16–64 at K=5, and 32–128 of the nuisance forests) take the
    packed pass, which adds every cell's rows in the unpacked order, so
    the ATE and SE are path_cf's bit for bit; and the 32-tree forest of
    parity_cf, grown again under the policy, is ``torch.equal`` to it."""
    stages: dict = {}
    with packed_policy():
        reset_counts()
        t0 = time.perf_counter()
        rep = causal_forest_report(frame_mod, key=sweep_key("causal_forest", "cuda"),
                                   n_trees=CF_TREES, depth=CF_DEPTH,
                                   nuisance_trees=CF_NUISANCE_TREES, nuisance_depth=DEPTH,
                                   stage_times=stages)
        sync()
        wall = time.perf_counter() - t0
        counts = read_counts()
        again = cf.fit_causal_forest(frame_mod, key=sweep_key("causal_forest", "cuda"),
                                     n_trees=CF_PARITY_TREES, depth=CF_DEPTH,
                                     nuisance_trees=CF_PARITY_TREES, nuisance_depth=DEPTH)
    r = rep.result
    equal_32 = all(torch.equal(getattr(again.forest, f), getattr(card_32.forest, f))
                   for f in ("split_feat", "split_bin", "leaf_stats", "in_sample", "bin_edges"))
    equal_32 = equal_32 and torch.equal(again.y_hat, card_32.y_hat) and torch.equal(
        again.w_hat, card_32.w_hat)
    emit({"phase": "path_cf_packed", "policy": f"{pack.ENV_PACK}=1", "ate": r.ate, "se": r.se,
          "ate_unpacked": cf_out["ate"], "se_unpacked": cf_out["se"],
          "incorrect_ate": rep.incorrect_ate, "forest_32_equal_to_unpacked": equal_32,
          "stages": stages, "wall_s": wall, "launches": counts})
    if (r.ate, r.se, rep.incorrect_ate, rep.incorrect_se) != (
            cf_out["ate"], cf_out["se"], cf_out["incorrect_ate"], cf_out["incorrect_se"]):
        raise AssertionError(f"packed causal row differs from the unpacked one: {r} vs {cf_out}")
    if not equal_32:
        raise AssertionError("the 32-tree causal forest under the packed policy differs from "
                             "the unpacked card forest")
    if counts["hist_partition"] or counts["hist_partition_shared"]:
        raise AssertionError(f"unpacked partition launches under the packed policy: {counts}")
    require_launched(counts, ("hist", "hist_shared", "node_sums", "node_sums_shared",
                              "route_advance", "traverse", "leaf_record", "hist_partition_packed",
                              "hist_partition_shared_packed", "pack_codes"), "packed causal forest")
    require_row_launches(counts, "causal_forest_packed")
    return counts


@contextlib.contextmanager
def dml_capture():
    """Record the forests and vote fractions ``double_ml`` computes (its
    ``_fit_nuisance_forest`` and ``_rf_vote``), in call order."""
    seen = {"forests": [], "votes": []}
    fit, vote = dml._fit_nuisance_forest, dml._rf_vote

    def fit_rec(*a, **k):
        seen["forests"].append(fit(*a, **k))
        return seen["forests"][-1]

    def vote_rec(*a, **k):
        seen["votes"].append(vote(*a, **k))
        return seen["votes"][-1]

    dml._fit_nuisance_forest, dml._rf_vote = fit_rec, vote_rec
    try:
        yield seen
    finally:
        dml._fit_nuisance_forest, dml._rf_vote = fit, vote


def phase_path_dml(frame_mod) -> dict:
    """The "Double Machine Learning" row at the sweep's configuration
    under the packed-code policy."""
    stages: dict = {}
    with packed_policy():
        reset_counts()
        t0 = time.perf_counter()
        r = dml.double_ml(frame_mod, n_trees=DML_TREES, depth=DEPTH, key=sweep_key("dml", "cuda"),
                          crossfit="r", se_mode="r", stage_times=stages)
        sync()
        wall = time.perf_counter() - t0
        counts = read_counts()
    if not (math.isfinite(r.ate) and math.isfinite(r.se) and r.se > 0):
        raise AssertionError(f"DML: non-finite estimate or SE ({r})")
    emit({"phase": "path_dml", "method": r.method, "policy": f"{pack.ENV_PACK}=1",
          "rows": frame_mod.n, "fold_rows": frame_mod.n // 2, "trees": DML_TREES, "depth": DEPTH,
          "crossfit": "r", "se_mode": "r", "ate": r.ate, "se": r.se, "ci": [r.lower_ci, r.upper_ci],
          "stages": stages, "wall_s": wall, "launches": counts})
    if counts["hist_partition"]:
        raise AssertionError(f"unpacked partition launches under the packed policy: {counts}")
    require_launched(counts, ("hist", "hist_partition_packed", "node_sums", "route_advance",
                              "traverse", "leaf_record", "pack_codes"), "DML")
    require_row_launches(counts, "dml")
    if (r.ate, r.se) != (DML_TAU, DML_SE):
        raise AssertionError(f"DML τ/SE moved: {r.ate!r}/{r.se!r}, recorded {DML_TAU!r}/{DML_SE!r}")
    return counts


def phase_parity_dml(frame_mod) -> None:
    """The DML row at 32 trees: packed and unpacked on the card, and on
    the CPU port. Integer histogram weights make every forest exact."""
    kw = dict(n_trees=DML_PARITY_TREES, depth=DEPTH, key=sweep_key("dml", "cuda"))
    with dml_capture() as packed_run, packed_policy():
        r_pk = dml.double_ml(frame_mod, **kw)
    with dml_capture() as card_run:
        r_card = dml.double_ml(frame_mod, **kw)
    with dml_capture() as cpu_run:
        r_cpu = dml.double_ml(frame_mod, device="cpu", **kw)
    fields = ("split_feat", "split_bin", "leaf_value", "counts", "bin_edges", "train_leaf")

    def same(a, b) -> bool:
        return (len(a["forests"]) == len(b["forests"]) == len(a["votes"]) == len(b["votes"]) == 4
                and all(torch.equal(getattr(fa, f).cpu(), getattr(fb, f).cpu())
                        for fa, fb in zip(a["forests"], b["forests"]) for f in fields)
                and all(torch.equal(va.cpu(), vb.cpu()) for va, vb in zip(a["votes"], b["votes"])))

    packed_equal, cpu_equal = same(packed_run, card_run), same(card_run, cpu_run)
    d_tau, d_se = abs(r_card.ate - r_cpu.ate), abs(r_card.se - r_cpu.se)
    emit({"phase": "parity_dml", "trees": DML_PARITY_TREES,
          "packed_vs_unpacked_forests_and_votes_equal": packed_equal,
          "card_vs_cpu_forests_and_votes_equal": cpu_equal,
          "tau_packed": r_pk.ate, "tau_card": r_card.ate, "tau_cpu": r_cpu.ate,
          "se_packed": r_pk.se, "se_card": r_card.se, "se_cpu": r_cpu.se,
          "abs_dtau_card_cpu": d_tau, "abs_dse_card_cpu": d_se, "bound": TAU_BOUND})
    if not packed_equal or (r_pk.ate, r_pk.se) != (r_card.ate, r_card.se):
        raise AssertionError("DML: packed and unpacked card runs differ")
    if not cpu_equal:
        raise AssertionError("DML: card and CPU forests or vote fractions differ")
    if not (d_tau <= TAU_BOUND and d_se <= TAU_BOUND):
        raise AssertionError(f"DML card vs CPU: |Δτ| {d_tau}, |Δse| {d_se} > {TAU_BOUND}")


def phase_path_leaf_index(card_32) -> dict:
    """``predict_cate``'s ``leaf_index`` and ``row_chunk`` options on
    parity_cf's 32-tree card forest: ``compute_leaf_index`` (one traverse
    launch, leaf ids), ``predict_cate`` through the index (one lookup
    launch), and both again with ``row_chunk=4096`` (taken, no blocking);
    each bit for bit the plain call's τ̂ and variance."""
    forest, x = card_32.forest, card_32.x
    whole = cf.predict_cate(forest, x)
    reset_counts()
    li = cf.compute_leaf_index(forest, x)
    runs = {"leaf_index": cf.predict_cate(forest, x, leaf_index=li),
            "row_chunk": cf.predict_cate(forest, x, row_chunk=4096),
            "leaf_index_row_chunk": cf.predict_cate(forest, x, row_chunk=4096, leaf_index=li)}
    sync()
    counts = read_counts()
    equal = {k: bool(torch.equal(r.cate, whole.cate) and torch.equal(r.variance, whole.variance))
             for k, r in runs.items()}
    emit({"phase": "path_leaf_index", "trees": forest.n_trees, "rows": x.shape[0],
          "leaf_index_dtype": str(li.dtype), "equal_to_plain_call": equal, "launches": counts})
    if not all(equal.values()):
        raise AssertionError(f"predict_cate options change the bits: {equal}")
    require_row_launches(counts, "leaf_index")
    return counts


def admm_activities(frame_mod) -> dict:
    """Device activities (kernels, copies, sets) of one ADMM iteration of
    the treated arm's float64 solve, from ``torch.profiler``: c(n) the
    activities of a solve capped at n iterations (the cap's freeze point
    is n // 2), so c(2) − c(1) is an iteration that adapts ρ and c(3) −
    c(2) one that does not."""
    x = frame_mod.x[frame_mod.w > 0.5]
    target = torch.mean(frame_mod.x, dim=0)

    def count(iters: int) -> tuple[dict, dict]:
        qp.balance_qp_x64(x, target, max_iters=iters)
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            qp.balance_qp_x64(x, target, max_iters=iters)
            sync()
        kinds, names = {"kernel": 0, "memcpy": 0, "memset": 0}, {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                low = e.name.lower()
                kinds["memcpy" if "memcpy" in low else "memset" if "memset" in low else "kernel"] += 1
                names[e.name[:80]] = names.get(e.name[:80], 0) + 1
        return kinds, names

    (c1, _), (c2, n2), (c3, n3) = (count(n) for n in (1, 2, 3))
    frozen_names = {k: n3.get(k, 0) - n2.get(k, 0) for k in n3}
    return {"adapting": {k: c2[k] - c1[k] for k in c1}, "frozen": {k: c3[k] - c2[k] for k in c1},
            "set_up_and_polish": {k: c1[k] - (c3[k] - c2[k]) for k in c1},
            "frozen_by_name": dict(sorted(((k, v) for k, v in frozen_names.items() if v),
                                          key=lambda kv: -kv[1]))}


def phase_stages(frame_mod) -> None:
    """The partition rows' stage split (``stage_ms``) and the ADMM
    iteration's device activities, last, so that the profiler runs after
    every path's wall time was taken."""
    rows = []
    for row, run in SPLITS:
        row["stage_ms"] = stage_ms(run)
        rows.append({k: row[k] for k in ("M", "K", "weights", "ranges", "cluster", "stage_ms")})
    emit({"phase": "stages", "kernel": "hist_partition", "rows": rows,
          "admm_iteration_activities": admm_activities(frame_mod)})


def phase_path_ipw(frame_mod) -> None:
    """The Direct Method, the two propensity rows and DR-GLM (its own
    logistic propensity and outcome model, sandwich SE) on the card, and
    the same rows from the CPU port."""
    stages = {}

    def rows(frame, times):
        t0 = time.perf_counter()
        direct = ate_condmean_ols(frame)
        times["direct_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        p = logistic_propensity(frame.x, frame.w)
        if frame.device.type == "cuda":
            sync()
        times["logistic_propensity_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = [direct, prop_score_weight(frame, p), prop_score_ols(frame, p)]
        times["weighting_rows_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out.append(doubly_robust_glm(frame))
        times["dr_glm_s"] = time.perf_counter() - t0
        return out

    card = rows(frame_mod, stages)
    host = rows(frame_mod.to("cpu"), {})
    diffs = {c.method: [abs(c.ate - h.ate), abs(c.se - h.se)] for c, h in zip(card, host)}
    emit({"phase": "path_ipw", "rows": frame_mod.n,
          "results": {r.method: [r.ate, r.se] for r in card}, "stages": stages,
          "card_vs_cpu_abs_diff": diffs, "bound": IPW_BOUND})
    for r in card:
        if not (math.isfinite(r.ate) and math.isfinite(r.se) and r.se > 0):
            raise AssertionError(f"{r.method}: non-finite estimate or SE ({r})")
    bad = {m: d for m, d in diffs.items() if max(d) > IPW_BOUND}
    if bad:
        raise AssertionError(f"card vs CPU beyond {IPW_BOUND}: {bad}")
    ROWS["ipw_cpu"] = {h.method: h for h in host}


@contextlib.contextmanager
def cv_capture():
    """Record every ``cv_glmnet`` result the LASSO estimators compute, in
    call order."""
    seen = []
    # Belloni fits its two CV-LASSOs in one cv_glmnet_many call (a list).
    fits = {(lasso_est, "cv_glmnet"): lasso_est.cv_glmnet, (bel, "cv_glmnet_many"): bel.cv_glmnet_many}

    def wrap(fit):
        def rec(*a, **k):
            out = fit(*a, **k)
            seen.extend(out if isinstance(out, list) else [out])
            return out
        return rec

    for (m, name), fit in fits.items():
        setattr(m, name, wrap(fit))
    try:
        yield seen
    finally:
        for (m, name), fit in fits.items():
            setattr(m, name, fit)


def fold_digest(foldid: torch.Tensor) -> str:
    """sha256 of the fold ids as little-endian int64, first 16 hex digits."""
    return hashlib.sha256(foldid.cpu().numpy().astype("<i8").tobytes()).hexdigest()[:16]


def belloni_support(cv_xw, cv_xy) -> list:
    """Belloni's selected columns under compat="r" from its two fits."""
    lam = cv_xw.lambda_min
    c_xw = bel._interp_coef_at(cv_xw.path.lambdas, cv_xw.path.coefs, lam)
    c_xy = bel._interp_coef_at(cv_xy.path.lambdas, cv_xy.path.coefs, lam)
    return torch.nonzero((c_xw > 0) | (c_xy > 0))[:, 0].tolist()


def lasso_rows(frame, times: dict, launches: dict) -> tuple[list, list, dict]:
    """The four LASSO rows as the sweep runs them (``pipeline.py:863-877,
    931-945, 956-958``): fold ids from the sweep's keys, the LASSO
    propensity into the IPW row, Belloni on its key. Returns the results,
    the five cv_glmnet results and the fold ids."""
    dev = frame.device.type
    folds = {k: lasso.default_foldid(sweep_key(k, dev), frame.n)
             for k in ("ps_lasso", "seq_lasso", "usual_lasso")}
    kxw, kxy = rnd.split(sweep_key("belloni", dev)).unbind(dim=-2)
    folds["belloni_xw"] = lasso.default_foldid(kxw, frame.n)
    folds["belloni_xy"] = lasso.default_foldid(kxy, frame.n)
    stages = (("lasso_ps", lambda: prop_score_weight(
                  frame, lasso_est.prop_score_lasso(frame, folds["ps_lasso"]),
                  method="Propensity_Weighting_LASSOPS")),
              ("seq_lasso", lambda: lasso_est.ate_condmean_lasso(frame, folds["seq_lasso"])),
              ("usual_lasso", lambda: lasso_est.ate_lasso(frame, folds["usual_lasso"])),
              ("belloni", lambda: bel.belloni(frame, key=sweep_key("belloni", dev))))
    out = []
    kernel = COUNTERS["cd_path"][0]     # the wrapper itself, under the capture
    with cv_capture() as cvs, cd_capture() as calls:
        for name, fn in stages:
            before, n_calls = kernel.launches, len(calls)
            t0 = time.perf_counter()
            out.append(fn())
            if dev == "cuda":
                sync()
            times[f"{name}_s"] = time.perf_counter() - t0
            launches[name] = {"launches": kernel.launches - before,
                              "cd_path_calls": len(calls) - n_calls}
    return out, list(cvs), folds


def phase_path_lasso(frame_mod) -> dict:
    """The four LASSO rows on the card (launch counts read around them) and
    on the CPU port, held to the JAX package's fold ids, selected indices,
    τ and SE (LASSO_FOLDS, LASSO_INDEX, LASSO_JAX within LASSO_BOUND) and
    to each other within LASSO_BOUND, Belloni's support equal."""
    stages, per_row = {}, {}
    reset_counts()
    card, card_cv, card_folds = lasso_rows(frame_mod, stages, per_row)
    counts = read_counts()
    cpu_stages, cpu_calls = {}, {}
    host, host_cv, host_folds = lasso_rows(frame_mod.to("cpu"), cpu_stages, cpu_calls)
    names = list(LASSO_INDEX)
    index = {"card": {k: [int(c.index_min), int(c.index_1se)] for k, c in zip(names, card_cv)},
             "cpu": {k: [int(c.index_min), int(c.index_1se)] for k, c in zip(names, host_cv)}}
    digests = {"card": {k: fold_digest(v) for k, v in card_folds.items()},
               "cpu": {k: fold_digest(v) for k, v in host_folds.items()}}
    support = {"card": belloni_support(*card_cv[3:]), "cpu": belloni_support(*host_cv[3:])}
    # Belloni's host step: R's aliasing rule on the selected columns
    # (float64 Gram–Schmidt in numpy), timed again on its own.
    cols = bel.interaction_expand(frame_mod.x)[:, support["card"]]
    t0 = time.perf_counter()
    alias_filter(cols, with_intercept=True)
    stages["belloni_alias_filter_s"] = time.perf_counter() - t0
    results = {r.method: {"card": [r.ate, r.se], "cpu": [h.ate, h.se], "jax": list(LASSO_JAX[r.method]),
                          "abs_diff_card_jax": [abs(r.ate - LASSO_JAX[r.method][0]),
                                                abs(r.se - LASSO_JAX[r.method][1])],
                          "abs_diff_card_cpu": [abs(r.ate - h.ate), abs(r.se - h.se)],
                          "bound": LASSO_BOUND[r.method]}
               for r, h in zip(card, host)}
    # The point-only rows have no SE (NaN): written as null.
    printable = {m: {k: [None if isinstance(v, float) and math.isnan(v) else v for v in vals]
                     if isinstance(vals, list) else vals for k, vals in r.items()}
                 for m, r in results.items()}
    emit({"phase": "path_lasso", "rows": frame_mod.n, "results": printable, "index": index,
          "fold_digests": digests, "belloni_support_size": len(support["card"]),
          "belloni_support_equal": support["card"] == support["cpu"], "stages": stages,
          "cpu_stages": cpu_stages, "launches_by_row": per_row, "cpu_cd_path_calls": cpu_calls,
          "launches": counts})
    fails = []
    for dev, got in digests.items():
        if got != LASSO_FOLDS:
            fails.append(f"{dev} fold ids {got} differ from the JAX package's {LASSO_FOLDS}")
    for dev, got in index.items():
        if got != {k: list(v) for k, v in LASSO_INDEX.items()}:
            fails.append(f"{dev} selected indices {got}, the JAX package's {LASSO_INDEX}")
    if support["card"] != support["cpu"]:
        fails.append(f"Belloni support differs: card {support['card']}, cpu {support['cpu']}")
    for method, r in results.items():
        lim = LASSO_BOUND[method]
        for what, (da, ds) in (("JAX", r["abs_diff_card_jax"]), ("CPU", r["abs_diff_card_cpu"])):
            if not (da <= lim and (math.isnan(r["jax"][1]) or ds <= lim)):
                fails.append(f"{method}: card vs {what} |Δτ| {da}, |ΔSE| {ds} > {lim}")
        if not math.isfinite(r["card"][0]):
            fails.append(f"{method}: τ is not finite")
    gaussian = {"seq_lasso": 1, "usual_lasso": 1, "belloni": 1}
    for row, c in per_row.items():
        if c["launches"] != c["cd_path_calls"] or (row in gaussian and c["launches"] != gaussian[row]):
            fails.append(f"{row}: {c['launches']} cd_path launches for {c['cd_path_calls']} calls")
    require_launched(counts, LASSO_KERNELS, "LASSO")
    if any(counts[k] for k in COUNTERS if k not in LASSO_KERNELS):
        fails.append(f"forest kernels launched on the LASSO path: {counts}")
    if fails:
        raise AssertionError("path_lasso: " + "; ".join(fails))
    return counts


@contextlib.contextmanager
def balance_capture(dev: str):
    """Record, per arm in call order, what ``residual_balance_ate`` computes:
    the QP's rows, ADMM iterations, worst residual and wall; the elastic
    net's fold-id digest, index_min, wall and cd_path launches."""
    qps, cvs = [], []
    solve, fit = balance.approx_balance_sol, balance.cv_glmnet

    def qp_rec(x, target, **k):
        t0 = time.perf_counter()
        out = solve(x, target, **k)
        if dev == "cuda":
            sync()
        qps.append({"rows": x.shape[0], "admm_iters": out[2], "worst_resid": float(out[1]),
                    "qp_s": time.perf_counter() - t0})
        return out

    def cv_rec(x, y, **k):
        before, t0 = lasso.cd_path.launches, time.perf_counter()
        out = fit(x, y, **k)
        if dev == "cuda":
            sync()
        cvs.append({"index_min": int(out.index_min), "cv_s": time.perf_counter() - t0,
                    "cd_path_launches": lasso.cd_path.launches - before,
                    "fold_digest": fold_digest(lasso.default_foldid(k["key"], x.shape[0]))})
        return out

    balance.approx_balance_sol, balance.cv_glmnet = qp_rec, cv_rec
    try:
        yield qps, cvs
    finally:
        balance.approx_balance_sol, balance.cv_glmnet = solve, fit


def balance_row(frame) -> tuple:
    """The residual_balancing row as the sweep runs it (its key, its
    budget) → (result, {arm: its QP and CV record}, wall seconds)."""
    dev = frame.device.type
    with balance_capture(dev) as (qps, cvs):
        t0 = time.perf_counter()
        r = balance.residual_balance_ate(frame, key=sweep_key("balance", dev),
                                         max_iters=BALANCE_ITERS)
        wall = time.perf_counter() - t0
    arms = {arm: {**qps[i], **cvs[i]} for i, arm in enumerate(("treated", "control"))}
    for a in arms.values():
        a["ms_per_admm_iter"] = a["qp_s"] * 1e3 / max(a["admm_iters"], 1)
    return r, arms, wall


def phase_path_balance(frame_mod) -> dict:
    """The residual_balancing row at the notebook's configuration on the
    card (launch counts read around it) and on the CPU port: each arm's
    fold ids and index_min held to the JAX package's (BALANCE_FOLDS,
    BALANCE_INDEX), τ and SE to BALANCE_JAX and to each other within
    BALANCE_BOUND, one cd_path launch an arm and no other kernel."""
    reset_counts()
    card, card_arms, wall = balance_row(frame_mod)
    counts = read_counts()
    host, host_arms, host_wall = balance_row(frame_mod.to("cpu"))
    diffs = {"card_jax": [abs(card.ate - BALANCE_JAX[0]), abs(card.se - BALANCE_JAX[1])],
             "cpu_jax": [abs(host.ate - BALANCE_JAX[0]), abs(host.se - BALANCE_JAX[1])],
             "card_cpu": [abs(card.ate - host.ate), abs(card.se - host.se)]}
    emit({"phase": "path_balance", "rows": frame_mod.n, "max_iters": BALANCE_ITERS,
          "card": [card.ate, card.se], "cpu": [host.ate, host.se], "jax": list(BALANCE_JAX),
          "abs_diff": diffs, "bound": BALANCE_BOUND, "arms": card_arms, "cpu_arms": host_arms,
          "admm_iters_equal_card_cpu": all(card_arms[a]["admm_iters"] == host_arms[a]["admm_iters"]
                                           for a in card_arms),
          "wall_s": wall, "cpu_wall_s": host_wall, "launches": counts})
    fails = []
    for dev, arms in (("card", card_arms), ("cpu", host_arms)):
        got = {a: v["fold_digest"] for a, v in arms.items()}
        if got != BALANCE_FOLDS:
            fails.append(f"{dev} fold ids {got}, the JAX package's {BALANCE_FOLDS}")
        got = {a: v["index_min"] for a, v in arms.items()}
        if got != BALANCE_INDEX:
            fails.append(f"{dev} index_min {got}, the JAX package's {BALANCE_INDEX}")
        if any(v["worst_resid"] > 1e-7 or v["admm_iters"] >= BALANCE_ITERS for v in arms.values()):
            fails.append(f"{dev}: an arm's ADMM did not reach the tolerance ({arms})")
    fails += [f"{k} |Δτ|, |ΔSE| {d} > {BALANCE_BOUND}" for k, d in diffs.items()
              if max(d) > BALANCE_BOUND]
    if not (math.isfinite(card.ate) and card.se > 0):
        fails.append(f"non-finite estimate or SE ({card})")
    if counts["cd_path"] != CD_LAUNCHES["balance"] or any(
            v["cd_path_launches"] != 1 for v in card_arms.values()):
        fails.append(f"cd_path launches {counts['cd_path']}, one an arm expected")
    if any(counts[k] for k in COUNTERS if k not in LASSO_KERNELS):
        fails.append(f"forest kernels launched on the balancing path: {counts}")
    if fails:
        raise AssertionError("path_balance: " + "; ".join(fails))
    ROWS["balance_arms"] = card_arms
    return counts


def same_row(a, b) -> bool:
    """Two result rows equal, NaN equal to NaN (the point-only rows' SE)."""
    return pipeline._jsonsafe(a.to_dict()) == pipeline._jsonsafe(b.to_dict())


def sweep_checks(rep) -> list:
    """Each of the sweep's rows against the pin its own phase holds."""
    rows = {r.method: r for r in rep.results}
    fails = []
    for label, want in (("oracle", ROWS["oracle"]), ("naive", ROWS["naive"])):
        got = rep.oracle if label == "oracle" else rows["naive"]
        if (got.ate, got.se) != (want.ate, want.se):
            fails.append(f"{label} {got.ate!r}/{got.se!r}, path phase {want.ate!r}/{want.se!r}")
    dr = rows["Doubly Robust with Random Forest PS"]
    if dr.ate != SWEEP_DR_TAU:
        fails.append(f"DR-RF τ {dr.ate!r}, recorded {SWEEP_DR_TAU!r}")
    cf_row = rows["Causal Forest(GRF)"]
    if (cf_row.ate, cf_row.se) != (CF_ATE, CF_SE):
        fails.append(f"causal ATE/SE {cf_row.ate!r}/{cf_row.se!r}, recorded {CF_ATE!r}/{CF_SE!r}")
    d = rows["Double Machine Learning"]
    if (d.ate, d.se) != (DML_TAU, DML_SE):
        fails.append(f"DML τ/SE {d.ate!r}/{d.se!r}, recorded {DML_TAU!r}/{DML_SE!r}")
    for method, (tau, se) in LASSO_JAX.items():
        r, lim = rows[method], LASSO_BOUND[method]
        if not (abs(r.ate - tau) <= lim and (math.isnan(se) or abs(r.se - se) <= lim)):
            fails.append(f"{method} {r.ate!r}/{r.se!r}, the JAX package's {tau}/{se} (bound {lim})")
    for method, h in ROWS["ipw_cpu"].items():
        r = rows[method]
        if max(abs(r.ate - h.ate), abs(r.se - h.se)) > IPW_BOUND:
            fails.append(f"{method} {r.ate!r}/{r.se!r}, CPU port {h.ate!r}/{h.se!r}")
    b = rows["residual_balancing"]
    if max(abs(b.ate - BALANCE_JAX[0]), abs(b.se - BALANCE_JAX[1])) > BALANCE_BOUND:
        fails.append(f"residual_balancing {b.ate!r}/{b.se!r}, the JAX package's {BALANCE_JAX}")
    for r in [rep.oracle, *rep.results]:
        if r.status != "ok" or not math.isfinite(r.ate):
            why = rep.failures.get(r.method, {}).get("error", "")
            fails.append(f"{r.method}: status {r.status}, τ {r.ate}" + (f" ({why})" if why else ""))
    return fails


def telemetry(out: str, rep, wall: float) -> tuple[dict, list]:
    """Read the five telemetry files of a sweep into ``out`` with plain
    json (the port's own formats, no other parser) and check them: one
    ``sweep_stage`` span a record with the report's status,
    ``sweep_stage_total`` summing to the rows computed, each lane busy at
    most the wall, the critical path done by the last commit (in the
    sequential sweep: ending at the last row), ``device_memory_bytes``
    recorded. Returns the summary the phases print (critical path, each
    lane's busy and wait, the sampler's samples and period, the wall) and
    the failures."""
    fails = [f"{out}: {f} missing" for f in TELEMETRY if not os.path.exists(os.path.join(out, f))]
    if fails:
        return {}, fails
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(out, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f.read().splitlines()[1:]]
    with open(os.path.join(out, "trace.json")) as f:
        other = json.load(f)["otherData"]
    with open(os.path.join(out, "overlap_report.json")) as f:
        overlap = json.load(f)
    # The phases read the telemetry of sweeps that computed every row.
    want = {r.method: "failed" if r.method in rep.failures else "computed"
            for r in [rep.oracle, *rep.results]}
    stages = {r["attrs"]["method"]: r["status"] for r in events if r["name"] == "sweep_stage"}
    if stages != want:
        fails.append(f"sweep_stage spans {stages}, the report's {want}")
    computed = sum(v for k, v in metrics["counters"]["sweep_stage_total"].items()
                   if "status=computed" in k)
    if computed != rep.computed:
        fails.append(f"sweep_stage_total computed {computed}, the report's {rep.computed}")
    busy = {t: v["busy_s"] for t, v in overlap["tracks"].items()}
    if any(b > overlap["wall_s"] + 1e-6 for b in busy.values()):
        fails.append(f"lane busy {busy} over the wall {overlap['wall_s']}")
    commits = sorted((r for r in events if r["name"] == "commit"), key=lambda r: r["end_mono_s"])
    path = overlap["critical_path"]
    tail_end = path[-1]["start_s"] + path[-1]["dur_s"] if path else 0.0
    last_commit = commits[-1]["end_mono_s"] - other["mono_origin_s"] if commits else 0.0
    if not path or tail_end > last_commit + 1e-3:
        fails.append(f"critical path ends at {tail_end} s, the last commit at {last_commit} s")
    if overlap["workers"] == 1 and path and path[-1]["name"] != commits[-1]["attrs"]["stage"]:
        fails.append(f"sequential critical path ends at {path[-1]['name']}")
    if not metrics["gauges"].get("device_memory_bytes"):
        fails.append("no device_memory_bytes gauge")
    summary = {"wall_s": wall, "run_sweep_s": overlap["wall_s"], "workers": overlap["workers"],
               "critical_path": [[e["name"], e["dur_s"], e["wait_s"]] for e in path],
               "critical_path_s": overlap["critical_path_s"],
               "overlap_efficiency": overlap["overlap_efficiency"],
               "lanes": {t: {"busy_s": v["busy_s"], "wait_s": v["wait_s"], "nodes": v["nodes"]}
                         for t, v in overlap["tracks"].items()},
               "committer_busy_s": overlap["serialization"]["committer"]["busy_s"],
               "sampler": {"samples": other.get("sampler_ticks"),
                           "period_s": other.get("sampler_interval_s")},
               "device_memory_peak_bytes": max(
                   (v for k, v in metrics["gauges"].get("device_memory_bytes", {}).items()
                    if "allocated_bytes.all.peak" in k), default=None)}
    return summary, fails


def phase_path_sweep() -> dict:
    """The notebook sweep through its entry point, ``pipeline.run_sweep``,
    at the full configuration (``SweepConfig()``) on the card, the default
    device, with the DML row's packed-code policy (``ATE_TPU_PREDICT_PACK=1``
    for the whole run: integer histogram weights and the causal pass give
    the bits of the unpacked policy); every row held to its phase's pin;
    report.json and REPORT.md parsed; then the same call again on the same
    directory: every record resumed, nothing computed, no kernel launched,
    the same rows. The first run's telemetry files are read and checked
    (:func:`telemetry`), and its critical path, lanes and sampler printed."""
    shutil.rmtree(SWEEP_OUT, ignore_errors=True)
    config = pipeline.SweepConfig()
    logs, logs2 = [], []
    obs.REGISTRY.reset()
    obs.EVENTS.clear()
    with packed_policy():
        reset_counts()
        t0 = time.perf_counter()
        rep = pipeline.run_sweep(config, outdir=SWEEP_OUT, plots=False, log=logs.append,
                                 scheduler="sequential")
        wall = time.perf_counter() - t0
        counts = read_counts()
        tele, fails = telemetry(SWEEP_OUT, rep, wall)
        reset_counts()
        t0 = time.perf_counter()
        again = pipeline.run_sweep(config, outdir=SWEEP_OUT, plots=False, log=logs2.append,
                                   scheduler="sequential")
        wall2 = time.perf_counter() - t0
        counts2 = read_counts()
    with open(os.path.join(SWEEP_OUT, "report.json")) as f:
        doc = json.load(f)
    with open(os.path.join(SWEEP_OUT, "REPORT.md")) as f:
        md = f.read()
    n_rows = len(pipeline.SWEEP_METHODS) + 1
    ROWS["sweep"] = {"report": rep, "wall_s": wall, "counts": counts, "telemetry": tele}
    emit({"phase": "path_sweep", "scheduler": "sequential", "config": "SweepConfig()",
          "policy": f"{pack.ENV_PACK}=1", "overlap": overlap(rep, wall),
          "rows_biased": rep.n_biased, "n_dropped": rep.n_dropped,
          "results": {r.method: [r.ate, None if math.isnan(r.se) else r.se]
                      for r in [rep.oracle, *rep.results]},
          "incorrect_cf": [rep.incorrect_cf_ate, rep.incorrect_cf_se],
          "seconds": rep.timings_s, "wall_s": wall, "computed": rep.computed,
          "launches": counts, "telemetry": tele,
          "resume": {"wall_s": wall2, "computed": again.computed, "resumed": again.resumed,
                     "launches": counts2}})
    fails += sweep_checks(rep)
    if [r["method"] for r in doc["results"]] != list(pipeline.SWEEP_METHODS):
        fails.append(f"report.json rows {[r['method'] for r in doc['results']]}")
    missing = [m for m in pipeline.SWEEP_METHODS if f"| {m} | {rep.results[m].ate:.4f} |" not in md]
    if missing or f"## [1] {rep.n_dropped}" not in md:
        fails.append(f"REPORT.md lacks rows {missing} or the drop count")
    if rep.computed != n_rows or (again.computed, again.resumed) != (0, n_rows):
        fails.append(f"computed {rep.computed}; the rerun computed {again.computed}, resumed "
                     f"{again.resumed} of {n_rows}")
    if sum("[resume]" in ln for ln in logs2) != n_rows:
        fails.append("the rerun did not log every row as resumed")
    if any(counts2.values()):
        fails.append(f"the resumed run launched kernels: {counts2}")
    if not (same_row(again.oracle, rep.oracle)
            and all(same_row(a, b) for a, b in zip(again.results, rep.results))):
        fails.append("the resumed rows differ from the computed ones")
    unpacked = ("hist_partition", "hist_partition_shared")
    if any(counts[k] for k in unpacked):
        fails.append(f"unpacked partition launches under the packed policy: {counts}")
    try:
        require_launched(counts, [k for k in COUNTERS
                                  if k not in unpacked + OLD_ROW_KERNELS + BF16_KERNELS], "sweep")
        require_row_launches(counts, "sweep")
    except AssertionError as e:
        fails.append(str(e))
    if counts["cd_path"] != sum(CD_LAUNCHES.values()):
        fails.append(f"cd_path launches {counts['cd_path']}, derived {sum(CD_LAUNCHES.values())}")
    if fails:
        raise AssertionError("path_sweep: " + "; ".join(fails))
    return counts


def overlap(rep, wall: float) -> float:
    """The sum of the rows' and shared nuisances' seconds over the sweep's
    wall: up to 1 for one row at a time, more where rows overlapped."""
    return sum(rep.timings_s.values()) / wall


def journal(out: str) -> list:
    """``results.jsonl``'s records with their wall seconds taken out."""
    with open(os.path.join(out, "results.jsonl")) as f:
        return [{k: v for k, v in json.loads(ln).items() if k != "seconds"} for ln in f]


def rerun(config, out: str, **kw) -> dict:
    """The sweep again on ``out``: its wall, counts and launches."""
    reset_counts()
    t0 = time.perf_counter()
    rep = pipeline.run_sweep(config, outdir=out, plots=False, log=lambda s: None, **kw)
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "computed": rep.computed, "resumed": rep.resumed,
            "launches": read_counts(), "report": rep}


def phase_path_sweep_concurrent() -> dict:
    """The notebook sweep through ``pipeline.run_sweep`` with the default
    scheduler (the concurrent engine at its default worker count, one CUDA
    stream a worker) at ``SweepConfig()`` under ``ATE_TPU_PREDICT_PACK=1``,
    into a fresh directory: every record bit for bit path_sweep's
    sequential row from this call, the launches of every kernel equal,
    the journal's lines (seconds aside) in the same order, every pin of
    ``sweep_checks``; then a sequential rerun on this directory and a
    concurrent rerun on path_sweep's: all 14 resumed, 0 computed, 0
    launches. Prints both sweeps' walls and overlap (the rows' and
    nuisances' seconds over the wall), the worker count, each node's start
    and end offsets from the engine's spans, the prefetch lane's outcome,
    and both sweeps' telemetry summaries (critical path, each lane's busy
    and wait, the sampler's samples), this sweep's files checked as
    path_sweep's are."""
    seq = ROWS["sweep"]
    shutil.rmtree(SWEEP_CONC_OUT, ignore_errors=True)
    config = pipeline.SweepConfig()
    obs.REGISTRY.reset()
    obs.EVENTS.clear()
    with packed_policy():
        reset_counts()
        start = time.monotonic()
        t0 = time.perf_counter()
        rep = pipeline.run_sweep(config, outdir=SWEEP_CONC_OUT, plots=False, log=lambda s: None)
        wall = time.perf_counter() - t0
        counts = read_counts()
        records, snap = obs.EVENTS.records(), obs.REGISTRY.snapshot()
        tele, fails = telemetry(SWEEP_CONC_OUT, rep, wall)
        same_journal = journal(SWEEP_CONC_OUT) == journal(SWEEP_OUT)
        seq_again = rerun(config, SWEEP_CONC_OUT, scheduler="sequential")
        conc_again = rerun(config, SWEEP_OUT)
    nodes = sorted(({"node": r["attrs"]["node"], "kind": r["attrs"]["kind"],
                     "worker": r["attrs"]["worker"], "start_s": r["start_mono_s"] - start,
                     "end_s": r["end_mono_s"] - start}
                    for r in records if r["name"] == "scheduler_node"),
                   key=lambda n: n["start_s"])
    workers = snap["gauges"].get("scheduler_workers", {}).get("")
    n_rows = len(pipeline.SWEEP_METHODS) + 1
    emit({"phase": "path_sweep_concurrent", "config": "SweepConfig()",
          "policy": f"{pack.ENV_PACK}=1", "workers": workers,
          "wall_s": wall, "sequential_wall_s": seq["wall_s"],
          "overlap": overlap(rep, wall), "sequential_overlap": overlap(seq["report"], seq["wall_s"]),
          "seconds": rep.timings_s, "nodes": nodes,
          "prefetch": {"outcomes": snap["counters"].get("scheduler_prefetch_total", {}),
                       "seconds": snap["histograms"].get("scheduler_prefetch_seconds", {})},
          "cache": snap["counters"].get("nuisance_cache_requests_total", {}),
          "launches": counts, "computed": rep.computed, "telemetry": tele,
          "sequential_telemetry": seq["telemetry"],
          "sequential_rerun": {k: v for k, v in seq_again.items() if k != "report"},
          "concurrent_rerun_of_sequential": {k: v for k, v in conc_again.items()
                                             if k != "report"}})
    seq_rep = seq["report"]
    pairs = [("oracle", rep.oracle, seq_rep.oracle)] + [
        (a.method, a, b) for a, b in zip(rep.results, seq_rep.results)]
    fails += [f"{m}: {a.ate!r}/{a.se!r}, sequential {b.ate!r}/{b.se!r}"
              for m, a, b in pairs if not same_row(a, b)]
    if counts != seq["counts"]:
        fails.append(f"launches {counts}, sequential {seq['counts']}")
    if not same_journal:
        fails.append("results.jsonl differs from the sequential sweep's (seconds aside)")
    fails += sweep_checks(rep)
    if rep.computed != n_rows or not workers or workers < 2:
        fails.append(f"computed {rep.computed} of {n_rows} on {workers} workers")
    for label, again in (("sequential rerun", seq_again), ("concurrent rerun", conc_again)):
        if (again["computed"], again["resumed"]) != (0, n_rows) or any(again["launches"].values()):
            fails.append(f"{label}: computed {again['computed']}, resumed {again['resumed']}, "
                         f"launches {again['launches']}")
        r = again["report"]
        if not (same_row(r.oracle, rep.oracle)
                and all(same_row(a, b) for a, b in zip(r.results, rep.results))):
            fails.append(f"{label}: the resumed rows differ")
    if fails:
        raise AssertionError("path_sweep_concurrent: " + "; ".join(fails))
    return counts


def scenario_spec(n_reps: int, rows: bool = False) -> "sc.MatrixSpec":
    return sc.MatrixSpec(dgps=tuple(sc.STOCK_DGPS.values()), estimators=SCENARIO_ESTIMATORS,
                         n_reps=n_reps, batch_width=SCENARIO_WIDTH, seed=0, rows=rows)


def scenario_run(spec, out: str | None, **kw) -> dict:
    """One ``run_matrix`` on the card with the launch counts read around
    it and its compile events (kernel builds and graph captures)."""
    reset_counts()
    t0 = time.perf_counter()
    rep = sc.run_matrix(spec, outdir=out, log=lambda s: None, **kw)
    wall = time.perf_counter() - t0
    errors = []
    with open(os.path.join(out, "cells.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("status") == "failed":
                errors.append(f"{rec['method']}: {rec['error'][:500]}")
    return {"report": rep, "wall_s": wall, "launches": read_counts(),
            "computed": rep.n_computed, "resumed": rep.n_resumed, "failed": rep.n_failed,
            "blocks": rep.n_blocks, "compile_events": rep.compile_events_delta,
            "errors": errors}


def scenario_block_args(column: str, dev: str):
    """The spec, estimator, root key and cell ids of ``column``'s first
    width-32 block (reps 0-31) on ``dev``."""
    dgp_name, est_name = column.split(":")
    ids = sc.pad_ids(dgp_name, tuple(range(SCENARIO_WIDTH)), SCENARIO_WIDTH)
    return (sc.STOCK_DGPS[dgp_name], sc.SCENARIO_ESTIMATORS[est_name],
            rnd.key(0, device=dev), ids)


def scenario_cd_block(column: str) -> dict:
    """``column``'s (a lasso column's) first block on the card with its one
    ``cd_path`` launch's inputs recorded, then the kernel at those inputs
    held to ``cd_path_plain`` on the card (``cd_plain_windows``):
    CD_PLAIN_WINDOWS where p is Belloni's order, the whole path at p = 5."""
    spec, est, root, ids = scenario_block_args(column, "cuda")
    with cd_capture() as seen:
        sc.column_executable(spec, est, SCENARIO_WIDTH)(root, ids)
    if len(seen) != 1:
        raise AssertionError(f"{column}: {len(seen)} cd_path calls in a block, want 1")
    args = seen[0][0]
    gram, lams = args[0], args[3]
    betas, sweeps = lasso.cd_path(*args)
    n_fits, p, _ = gram.shape
    big = p > 32
    windows = cd_plain_windows(column, args, betas, sweeps,
                               CD_PLAIN_WINDOWS if big else ((0, lams.shape[1]),), big)
    return {"column": column, "fits": n_fits, "p": p, "L": lams.shape[1],
            "sweeps_max": int(sweeps.max()),
            "max_abs_err": max(w["max_abs_err"] for w in windows), "plain_windows": windows}


def scenario_cpu_block(column: str) -> dict:
    """One width-32 block of ``column`` (reps 0-31) on the card and on the
    CPU port in this process: the draws ``torch.equal``, the estimates'
    largest |Δ| over (1 + |card|) within SCENARIO_CPU_BOUND; a lasso
    column's estimates within CD_PATH_BOUND·ys/xs_W a lane (its SE is NaN
    on both)."""
    out: dict = {}
    for dev in ("cuda", "cpu"):
        spec, est, root, ids = scenario_block_args(column, dev)
        keys = rnd.fold_in(root, torch.as_tensor(ids.astype(np.int64), device=dev))
        draws = sc.generate(spec, keys)
        t0 = time.perf_counter()
        if est.vmapped:
            ate, se, _ = sc.column_executable(spec, est, SCENARIO_WIDTH)(root, ids)
        else:
            run = sc.cell_fn(spec, est)
            ate, se = (torch.stack(t) for t in zip(*(run(root, int(c))[:2] for c in ids)))
        out[dev] = (draws, ate.cpu(), se.cpu(), time.perf_counter() - t0)
    (card, ate_g, se_g, sec_g), (cpu, ate_c, se_c, sec_c) = out["cuda"], out["cpu"]
    if est.name == "lasso":
        _, w, y, _ = cpu
        scale = y.std(dim=-1, unbiased=False) / w.std(dim=-1, unbiased=False)
        err = float(((ate_c - ate_g).abs() / scale).max())
        bound, within = CD_PATH_BOUND, bool(torch.isnan(se_c).all() and torch.isnan(se_g).all())
    else:
        err = max(float(((a - b).abs() / (1 + b.abs())).max())
                  for a, b in ((ate_c, ate_g), (se_c, se_g)))
        bound, within = SCENARIO_CPU_BOUND, True
    return {"column": column, "draws_equal": [bool(torch.equal(a.cpu(), b)) for a, b in zip(card, cpu)],
            "max_err": err, "bound": bound, "within": within and err <= bound,
            "card_s": sec_g, "cpu_s": sec_c}


def phase_path_scenario_matrix(smi: str) -> dict:
    """The Monte-Carlo scenario matrix (``scenarios/``) on the card at the
    stock grid: aggregate mode on the default engine; a rerun (0
    computed, 0 launches, 0 builds); an extension to
    ``SCENARIO_EXT_REPS`` (one new block a vmapped column, 16 new cells an
    aipw_rf column, 0 builds); rows mode and aggregate mode on the
    sequential engine at the extended count; the scalar replay. Gates: every streaming state equals
    ``fold_rows`` of the rows run bit for bit and the sequential run's;
    batched against scalar replay exact for naive and within
    ``MAX_VMAP_COLLAPSE_ULP`` elsewhere; calibration coverage within 3 MC
    standard errors of 95%; every run's launches equal
    ``scenario_launches``; one block of each ``SCENARIO_CPU_COLUMNS`` on
    the CPU port: draws ``torch.equal``, estimates within
    ``SCENARIO_CPU_BOUND`` (a lasso column's within CD_PATH_BOUND·ys/xs_W);
    every lasso column's first block's ``cd_path`` launch held within
    CD_PATH_BOUND of its plain version on the card at that launch's
    inputs (``scenario_cd_block``). Prints the walls, per-column seconds
    and the launches."""
    shutil.rmtree(SCENARIO_OUT, ignore_errors=True)
    agg_out = os.path.join(SCENARIO_OUT, "aggregate")
    spec = scenario_spec(SCENARIO_REPS)
    ext = scenario_spec(SCENARIO_EXT_REPS)
    plans, skipped = sc.plan_columns(spec)
    rf_cols = sum(p.estimator == "aipw_rf" for p in plans)
    lasso_cols = sum(p.estimator == "lasso" for p in plans)
    blocks = -(-SCENARIO_REPS // SCENARIO_WIDTH)
    ext_blocks = -(-SCENARIO_EXT_REPS // SCENARIO_WIDTH)
    runs = {"aggregate": scenario_run(spec, agg_out)}
    runs["rerun"] = scenario_run(spec, agg_out)
    runs["extend"] = scenario_run(ext, agg_out)
    runs["rows"] = scenario_run(scenario_spec(SCENARIO_EXT_REPS, rows=True),
                                os.path.join(SCENARIO_OUT, "rows"), scheduler="sequential")
    runs["sequential"] = scenario_run(ext, os.path.join(SCENARIO_OUT, "sequential"),
                                      scheduler="sequential")
    want = {
        "aggregate": scenario_launches(rf_cols * SCENARIO_REPS, lasso_cols * blocks),
        "rerun": scenario_launches(0, 0),
        "extend": scenario_launches(rf_cols * (SCENARIO_EXT_REPS - SCENARIO_REPS),
                                    lasso_cols * (ext_blocks - blocks)),
        "rows": scenario_launches(rf_cols * SCENARIO_EXT_REPS, lasso_cols * ext_blocks),
    }
    want["sequential"] = want["rows"]
    t0 = time.perf_counter()
    replay = sc.run_scalar_replay(scenario_spec(SCENARIO_REPLAY_REPS, rows=True),
                                  log=lambda s: None)
    replay_s = time.perf_counter() - t0
    cpu_blocks = [scenario_cpu_block(c) for c in SCENARIO_CPU_COLUMNS]
    cd_blocks = [scenario_cd_block(p.name) for p in plans if p.estimator == "lasso"]

    fails = []
    n_cols = len(plans)
    if (n_cols, len(skipped)) != (20, 4):
        fails.append(f"{n_cols} columns, {len(skipped)} skipped")
    for name, r in runs.items():
        if r["launches"] != want[name]:
            fails.append(f"{name}: launches {r['launches']}, derived {want[name]}")
        if r["failed"]:
            fails.append(f"{name}: {r['failed']} failed cells: {r['errors'][:3]}")
        if name != "aggregate" and r["compile_events"]:
            fails.append(f"{name}: {r['compile_events']} kernel builds or graph captures")
    if (runs["rerun"]["computed"], runs["rerun"]["blocks"]) != (0, 0):
        fails.append(f"rerun computed {runs['rerun']['computed']}")
    ext_rep = runs["extend"]["report"]
    new_cells = n_cols * (SCENARIO_EXT_REPS - SCENARIO_REPS)
    if (ext_rep.n_computed, ext_rep.n_blocks) != (new_cells, n_cols):
        fails.append(f"extend computed {ext_rep.n_computed} cells in {ext_rep.n_blocks} blocks, "
                     f"want {new_cells} in {n_cols}")
    rows_rep = runs["rows"]["report"]
    by_col: dict = {}
    for r in rows_rep.cells:
        by_col.setdefault(r["column"], []).append(r)
    seq_states = runs["sequential"]["report"].states
    for col, rows in by_col.items():
        rows.sort(key=lambda r: r["rep"])
        ref = sc.fold_rows([(r["ate"], r["se"], r["tau_true"]) for r in rows], SCENARIO_WIDTH)
        if ext_rep.states[col].stats != ref.stats:
            fails.append(f"{col}: streaming state differs from fold_rows of the rows run")
        if seq_states[col].stats != ext_rep.states[col].stats:
            fails.append(f"{col}: the sequential engine's state differs")
    if set(by_col) != set(ext_rep.states):
        fails.append("rows and streaming columns differ")
    head = [r for r in rows_rep.cells if r["rep"] < SCENARIO_REPLAY_REPS
            and sc.SCENARIO_ESTIMATORS[r["estimator"]].vmapped]
    cmp = sc.compare_cells(head, replay.cells)
    if cmp["missing"] or len(replay.cells) != len(head):
        fails.append(f"replay cells missing: {cmp['missing'][:4]}")
    for col, ulp in cmp["columns"].items():
        est = sc.SCENARIO_ESTIMATORS[col.split(":")[1]]
        if ulp > (0.0 if est.vmap_collapse_exact else sc.MAX_VMAP_COLLAPSE_ULP):
            fails.append(f"{col}: batched vs scalar {ulp} ulps")
    coverage = {}
    for col, agg in ext_rep.columns.items():
        if col.startswith("calibration:") and agg["coverage"] is not None:
            coverage[col] = agg["coverage"]
            if abs(agg["coverage"] - 0.95) > 3.0 * agg["coverage_mc_se"]:
                fails.append(f"{col}: coverage {agg['coverage']} outside 3 MC-SE of 0.95")
    if len(coverage) != 5:
        fails.append(f"calibration coverage checked on {sorted(coverage)}")
    for b in cpu_blocks:
        if not all(b["draws_equal"]) or not b["within"]:
            fails.append(f"{b['column']} on the CPU port: draws equal {b['draws_equal']}, "
                         f"error {b['max_err']} (bound {b['bound']})")
    col_s: dict = {}
    for r in rows_rep.cells:
        col_s[r["column"]] = col_s.get(r["column"], 0.0) + r["seconds"]
    emit({"phase": "path_scenario_matrix", "nvidia_smi": smi, "columns": n_cols,
          "skipped": skipped, "reps": SCENARIO_REPS, "extended_reps": SCENARIO_EXT_REPS,
          "width": SCENARIO_WIDTH,
          "runs": {k: {f: v[f] for f in ("wall_s", "computed", "resumed", "failed", "blocks",
                                         "compile_events", "launches", "errors")}
                   for k, v in runs.items()},
          "workers": pipeline._resolve_scheduler(None, None, lambda s: None),
          "replay": {"reps": SCENARIO_REPLAY_REPS, "wall_s": replay_s, "cells": len(replay.cells),
                     "max_ulp": cmp["max_ulp"], "exact_columns": cmp["exact_columns"],
                     "ulp_by_column": cmp["columns"]},
          "rows_column_s": col_s, "calibration_coverage": coverage, "cpu_blocks": cpu_blocks,
          "cd_blocks": cd_blocks,
          "columns_summary": {c: {k: a[k] for k in ("n_cells", "coverage", "bias", "rmse")}
                              for c, a in ext_rep.columns.items()}})
    if fails:
        raise AssertionError("path_scenario_matrix: " + "; ".join(fails))
    return runs["aggregate"]["launches"]


def frontier_computed() -> float:
    snap = obs.REGISTRY.peek("scenario_frontier_probes_total") or {}
    return sum(v for k, v in snap.items() if "status=computed" in k)


def phase_path_frontier(smi: str) -> dict:
    """``run_frontier(FRONTIER_SPEC)`` on the card into ``FRONTIER_OUT``,
    then again on the same directory: the atlas byte for byte, no
    journaled probe block computed again (only each failure's fresh
    confirmation, as in the JAX package), 0 launches and builds; the first
    failure's ``--repro`` line through the port's CLI in a subprocess must
    print ``failing``, and the failures must be the micro search's known
    corner, shrunk to both knobs."""
    shutil.rmtree(FRONTIER_OUT, ignore_errors=True)
    spec = FRONTIER_SPEC
    atlas_path = os.path.join(FRONTIER_OUT, "FAILURE_ATLAS.json")
    reset_counts()
    c0, b0 = frontier_computed(), compile_event_count()
    t0 = time.perf_counter()
    atlas = fr.run_frontier(spec, outdir=FRONTIER_OUT, log=lambda s: None)
    wall = time.perf_counter() - t0
    counts = read_counts()
    first_computed = frontier_computed() - c0
    with open(atlas_path, "rb") as f:
        first = f.read()
    c1 = frontier_computed()
    t0 = time.perf_counter()
    again = fr.run_frontier(spec, outdir=FRONTIER_OUT, log=lambda s: None)
    resume_wall = time.perf_counter() - t0
    resume_counts = read_counts()
    resume_computed = frontier_computed() - c1
    builds = compile_event_count() - b0
    with open(atlas_path, "rb") as f:
        second = f.read()
    confirm_blocks = sum(-(-f["reps"] // spec.width()) for f in atlas["failures"])
    fails = []
    if first != second or again != atlas:
        fails.append("the resumed atlas differs")
    if resume_computed != confirm_blocks:
        fails.append(f"resume computed {resume_computed} probe blocks, "
                     f"the confirmations are {confirm_blocks}")
    if any(counts.values()) or any(resume_counts.values()) or builds:
        fails.append(f"launches {counts} / {resume_counts}, builds {builds}")
    if not atlas["failures"]:
        fails.append("no failure found")
    repro = {}
    if atlas["failures"]:
        line = atlas["failures"][0]["repro"].split()
        cmd = [sys.executable, "-m", line[2]] + [a.strip("'") for a in line[3:]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=REPO))
        repro = {"cmd": " ".join(line), "rc": proc.returncode, "s": time.perf_counter() - t0}
        if proc.returncode == 0:
            repro["verdict"] = json.loads(proc.stdout.strip().splitlines()[-1])
        if repro.get("verdict", {}).get("verdict") != "failing":
            fails.append(f"repro: {repro} {proc.stderr[-2000:]}")
    corner = {"confounding": 6.0, "overlap": 0.02}
    if not any(x["knobs"] == x["minimal_knobs"] == corner for x in atlas["failures"]):
        fails.append(f"the known corner {corner} is not among the failures")
    key = lambda a: [(x["estimator"], x["knobs"], x["minimal_knobs"]) for x in a["failures"]]
    emit({"phase": "path_frontier", "nvidia_smi": smi, "wall_s": wall,
          "resume_wall_s": resume_wall, "probes": atlas["probes"],
          "computed_blocks": first_computed, "resume_computed_blocks": resume_computed,
          "confirm_blocks": confirm_blocks, "launches": counts, "builds": builds,
          "failures": key(atlas), "coverage": [x["coverage"] for x in atlas["failures"]],
          "repro": repro})
    if fails:
        raise AssertionError("path_frontier: " + "; ".join(fails))
    return counts


# The names the growers, the predict paths and the LASSO path look the
# kernels' wrappers up by, where path_chaos_campaign's taps stand in.
TAP_SITES = ((fo, ("bin_histogram_batched", "node_sums", "route_advance", "leaf_record",
                   "traverse")),
             (cf, ("bin_histogram_batched", "bin_histogram_shared", "node_sums_shared",
                   "traverse", "table_lookup")),
             (lasso, ("cd_path",)))


def _shape_key(v):
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), str(v.dtype), v.device.type)
    return v


class _Tap:
    """Stands in for a kernel's wrapper ``fn`` where the path looks it up:
    calls it, after keeping a copy of the inputs (before the call:
    ``route_advance`` advances its ids in place) of the first call at each
    distinct shape and scalar arguments, none taken during a graph
    capture. Attributes read and write through to ``fn``: a wrapper that
    counts through the name it is looked up by (``lasso.cd_path``) counts
    on itself."""

    def __init__(self, name, fn, seen: dict, lock):
        import inspect

        object.__setattr__(self, "_tap", (name, fn, inspect.signature(fn), seen, lock))

    def __getattr__(self, attr):
        return getattr(self._tap[1], attr)

    def __setattr__(self, attr, value):
        setattr(self._tap[1], attr, value)

    def __call__(self, *a, **k):
        name, fn, sig, seen, lock = self._tap
        if not torch.cuda.is_current_stream_capturing():
            bound = sig.bind(*a, **k)
            bound.apply_defaults()
            key = (name,) + tuple((n, _shape_key(v)) for n, v in bound.arguments.items())
            with lock:
                new = key not in seen
                if new:
                    seen[key] = None
            if new:
                seen[key] = (name, {n: v.clone() if isinstance(v, torch.Tensor) else v
                                    for n, v in bound.arguments.items()})
        return fn(*a, **k)


@contextlib.contextmanager
def kernel_taps():
    """Within the block, each wrapper of TAP_SITES is called through a
    ``_Tap``. Yields ``{key: (wrapper name, bound arguments)}``. The taps
    launch nothing of their own, so the counts stay the path's."""
    seen: dict = {}
    lock = threading.Lock()
    saved = []
    try:
        for mod, names in TAP_SITES:
            for name in names:
                fn = getattr(mod, name)
                saved.append((mod, name, fn))
                setattr(mod, name, _Tap(name, fn, seen, lock))
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def hist_kernel_name(wrapper: str, mode: str, bf16: bool = False) -> str:
    name = "hist_partition" if mode.startswith("partition") else "hist"
    return name + ("_shared" if wrapper.endswith("shared") else "") + (
        "_packed" if mode.endswith("pack") else "") + ("_bf16" if bf16 else "")


def check_tapped(name: str, b: dict) -> tuple[str, float]:
    """One tapped call's inputs: the kernel launched twice (bitwise equal)
    and held to its plain version with the tolerance its phase row uses
    (the leaf sums also ``torch.equal`` to the dense route they replaced):
    histograms and leaf sums exact for integer weights, within
    FLOAT_ULPS·eps·Σ|w| for float ones; the row kernels ``torch.equal``;
    ``cd_path`` within CD_PATH_BOUND on CD_PLAIN_WINDOWS (the whole path
    at p ≤ 32), warm-started as in ``cd_plain_windows``. Returns (kernel,
    max |Δ|)."""
    if name.startswith("bin_histogram"):
        bf16 = b["bf16"]
        kernel = hist_kernel_name(name, b["mode"], bf16)
        run = lambda: getattr(hist, name)(b["codes"], b["ids"], b["weights"],
                                          max_nodes=b["max_nodes"], n_bins=b["n_bins"],
                                          mode=b["mode"], packed=b["packed"], bf16=bf16)
        got = run()
        check_equal(f"{kernel} (two launches)", run(), got)
        if bf16:
            check_bf16_form(kernel, got, b["weights"], lambda w: getattr(hist, name)(
                b["codes"], b["ids"], w, max_nodes=b["max_nodes"], n_bins=b["n_bins"],
                mode=b["mode"], packed=b["packed"]))
        args = (b["codes"], b["ids"], b["weights"], b["max_nodes"], b["n_bins"])
        want = (hist.bin_histogram_packed_plain(*args, b["packed"], bf16)
                if b["mode"].endswith("pack") else hist.bin_histogram_batched_plain(*args, bf16))
        w = b["weights"]
        if torch.equal(w, w.round()):
            return kernel, check_equal(kernel, got, want)
        scale = (hist.round_bf16(w) if bf16 else w).abs().sum(dim=-1)
        scale = (scale if scale.ndim == 2 else scale[None])[:, :, None, None, None]
        return kernel, check_float(kernel, got, want, scale)[0]
    if name.startswith("node_sums"):
        run = lambda: getattr(hist, name)(b["ids"], b["weights"], b["num_nodes"])
        got = run()
        check_equal(f"{name} (two launches)", run(), got)
        check_dense_route(name, got, b["ids"], b["weights"], b["num_nodes"])
        want = hist.node_sums_plain(b["ids"], b["weights"], b["num_nodes"])
        w = b["weights"]
        if torch.equal(w, w.round()):
            return name, check_equal(name, got, want)
        scale = w.abs().sum(dim=-1)
        scale = (scale if scale.ndim == 2 else scale[None])[:, None, :]
        return name, check_float(name, got, want, scale)[0]
    if name == "route_advance":
        outs = []
        for fn in (tree.route_advance, tree.route_advance, tree.route_advance_plain):
            ni, nr = b["node_int"].clone(), b["node_rev"].clone()
            outs.append((fn(b["codes"], ni, nr, b["best_feat"], b["best_bin"], b["mask"],
                            b["last"]), ni, nr))
        check_same(f"{name} (two launches)", zip(outs[0], outs[1]))
        check_same(name, zip(outs[0], outs[2]))
        return name, 0.0
    if name == "leaf_record":
        args = (b["leaf_sums"], b["base"], b["mu"], b["node"])
        got = tree.leaf_record(*args)
        check_same(f"{name} (two launches)", zip(got, tree.leaf_record(*args)))
        check_same(name, zip(got, tree.leaf_record_plain(*args)))
        return name, 0.0
    if name == "traverse":
        args = (b["codes"], b["split_feat"], b["split_bin"], b["table"])
        got = tree.traverse(*args)
        check_equal(f"{name} (two launches)", tree.traverse(*args), got)
        return name, check_equal(name, got, tree.traverse_plain(*args))
    if name == "table_lookup":
        got = tree.table_lookup(b["table"], b["ids"])
        check_equal("lookup (two launches)", tree.table_lookup(b["table"], b["ids"]), got)
        return "lookup", check_equal("lookup", got, tree.table_lookup_plain(b["table"], b["ids"]))
    if name == "cd_path":
        betas, sweeps = lasso.cd_path(**b)
        again, sweeps2 = lasso.cd_path(**b)
        check_equal(f"{name} (two launches)", again, betas)
        check_equal(f"{name} sweeps (two launches)", sweeps2, sweeps)
        n_lam = b["lambdas"].shape[1]
        windows = (((0, n_lam),) if b["gram"].shape[1] <= 32 else
                   tuple((lo, min(hi, n_lam)) for lo, hi in CD_PLAIN_WINDOWS if lo < n_lam))
        err = 0.0
        for lo, hi in windows:
            start = b["beta0"] if lo == 0 else betas[:, lo - 1].contiguous()
            want, _ = lasso.cd_path_plain(**dict(b, lambdas=b["lambdas"][:, lo:hi].contiguous(),
                                                 beta0=start))
            e = float((betas[:, lo:hi] - want).abs().max())
            if not e <= CD_PATH_BOUND:
                raise AssertionError(f"cd_path B={b['gram'].shape[0]} p={b['gram'].shape[1]} "
                                     f"λs {lo}–{hi - 1}: kernel {e} from its plain version "
                                     f"(bound {CD_PATH_BOUND})")
            err = max(err, e)
        return name, err
    raise AssertionError(f"no check for tapped wrapper {name}")


def check_taps(seen: dict) -> dict:
    """Every tapped call held to its plain version: per kernel, the cases
    held and the largest |Δ|."""
    sync()
    out: dict = {}
    for name, b in seen.values():
        kernel, err = check_tapped(name, b)
        row = out.setdefault(kernel, {"cases": 0, "max_abs_err": 0.0})
        row["cases"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)
    sync()
    return out


def check_serving_traverse(seed: int) -> dict:
    """``traverse`` held to ``traverse_plain`` on the campaign's serving
    forest (8 trees of depth 3, 4 features, drawn as the serving workload
    draws it for ``seed``) at the bucket's 4 rows and at 1 row."""
    from ate_replication_causalml_torch.resilience import campaign as cp

    forest = cp._synthetic_serving_forest(np.random.default_rng(seed))
    x = torch.as_tensor(np.random.default_rng(seed).normal(size=(4, 4)).astype(np.float32),
                        device="cuda")
    args = [t.cuda() for t in (forest.split_feat, forest.split_bin, forest.leaf_stats)]
    for rows in (4, 1):
        codes = fo.binarize(x[:rows].contiguous(), forest.bin_edges.cuda())
        got = tree.traverse(codes, *args)
        check_equal(f"traverse serving forest {rows} rows (two launches)",
                    tree.traverse(codes, *args), got)
        check_equal(f"traverse serving forest {rows} rows", got,
                    tree.traverse_plain(codes, *args))
    return {"cases": 2, "max_abs_err": 0.0}


def verdict_counts(report: dict) -> dict:
    counts = {"pass": 0, "skip": 0, "fail": 0}
    for ep in report["episodes"]:
        for v in ep["invariants"]:
            counts[v["verdict"]] += 1
    return counts


def phase_path_chaos_campaign(smi: str) -> dict:
    """The chaos campaign on the card (docstring, 11i). Returns the kernel
    launches of the default plan's run."""
    from ate_replication_causalml_torch.resilience import campaign as cp

    shutil.rmtree(CAMPAIGN_OUT, ignore_errors=True)
    with open(CAMPAIGN_RECORD) as f:
        record = json.load(f)
    fails = []
    quiet = lambda msg: None
    t_phase = time.perf_counter()
    # The default plan: sweep, matrix, serving, rotation, the kernels'
    # inputs tapped; the counts read before any kernel is held to its
    # plain version on them.
    default_out = os.path.join(CAMPAIGN_OUT, "default")
    with kernel_taps() as seen:
        reset_counts()
        t0 = time.perf_counter()
        report = cp.run_campaign(default_out, root_seed=record["root_seed"],
                                 n_episodes=record["n_episodes"], scale=record["scale"],
                                 log=quiet, device="cuda")
        default_wall = time.perf_counter() - t0
        counts = read_counts()
    t0 = time.perf_counter()
    checks = check_taps(seen)
    serving_seed = next(e["seed"] for e in report["episodes"] if e["workload"] == "serving")
    checks["traverse (serving forest)"] = check_serving_traverse(serving_seed)
    check_s = time.perf_counter() - t0
    with open(os.path.join(default_out, "campaign_walls.json")) as f:
        walls = json.load(f)
    got = [(e["workload"], e["spec"], e["status"]) for e in report["episodes"]]
    want = [(e["workload"], e["spec"], "green") for e in record["episodes"]]
    if got != want:
        fails.append(f"default plan {got} != the record's {want}")
    verdicts = verdict_counts(report)
    if verdicts != record["invariant_checks"] or not record["all_green"] or report["violations"]:
        fails.append(f"invariant checks {verdicts} (record {record['invariant_checks']}), "
                     f"violations {report['violations']}")
    try:
        require_launched(counts, CAMPAIGN_KERNELS, "chaos_campaign")
    except AssertionError as e:
        fails.append(str(e))
    unchecked = [k for k in CAMPAIGN_KERNELS if k not in checks]
    if unchecked:
        fails.append(f"kernels never held to their plain version at this path's inputs: "
                     f"{unchecked}")
    windows = {}
    for d in sorted(os.listdir(default_out)):
        path = os.path.join(default_out, d, "campaign_summary.json")
        if os.path.exists(path):
            with open(path) as f:
                summary = json.load(f)
            if "serving" in summary:
                windows[d] = summary["serving"]["compile_events_in_window"]
    if len(windows) != 4 or any(windows.values()):
        fails.append(f"serving windows' builds {windows}")
    # One fleet episode: three daemon processes, a SIGKILL, a rotation.
    fleet_out = os.path.join(CAMPAIGN_OUT, "fleet")
    t0 = time.perf_counter()
    fleet = cp.run_campaign(fleet_out, root_seed=record["root_seed"], n_episodes=1,
                            workloads=("fleet",), scale=record["scale"], log=quiet,
                            device="cuda")
    fleet_wall = time.perf_counter() - t0
    with open(os.path.join(fleet_out, "campaign_walls.json")) as f:
        fleet_walls = json.load(f)
    fv = {v["invariant"]: v for v in fleet["episodes"][0]["invariants"]}
    if fleet["violations"] or fv["fleet_failover"]["verdict"] != "pass":
        fails.append(f"fleet episode: {fleet['episodes'][0]['invariants']}")
    # The planted tamper: detected, shrunk, its repro failing again.
    tamper_out = os.path.join(CAMPAIGN_OUT, "tamper")
    t0 = time.perf_counter()
    tamper = cp.run_campaign(tamper_out, root_seed=5,
                             episodes=[cp.Episode(0, "matrix", TAMPER_SEED, TAMPER_ATOMS)],
                             scale="micro", log=quiet, device="cuda")
    tamper_wall = time.perf_counter() - t0
    with open(os.path.join(tamper_out, "campaign_walls.json")) as f:
        tamper_walls = json.load(f)
    tv = {v["invariant"]: v["verdict"] for v in tamper["episodes"][0]["invariants"]}
    shrink = tamper["shrink"][0] if tamper["shrink"] else {}
    if (tamper["violations"] != [0] or tv["bit_identity"] != "fail"
            or tv["journal_integrity"] != "pass" or tv["degraded_where_faulted"] != "pass"):
        fails.append(f"tamper not detected as planted: {tv}")
    if shrink.get("minimal_atoms") != [{"scope": "tamper", "spec": "tamper:journal,times=1"}] \
            or shrink.get("confirmed") is not True:
        fails.append(f"tamper shrink: {shrink}")
    repro = {}
    if shrink:
        import shlex

        words = shlex.split(shrink["repro"])
        name, _, value = words[0].partition("=")
        cmd = [sys.executable] + words[2:]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=REPO, **{name: value}))
        repro = {"cmd": shrink["repro"], "rc": proc.returncode, "s": time.perf_counter() - t0,
                 "stdout": proc.stdout.strip().splitlines()[-1:]}
        # Exit 1 with the verdict line: a crash also exits 1.
        if (proc.returncode != 1 or "REPRO RE-FAILS: ['bit_identity']" not in proc.stdout
                or "Traceback" in proc.stderr):
            fails.append(f"repro exit {proc.returncode}, not 1 with bit_identity failing "
                         f"again: {proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    emit({"phase": "path_chaos_campaign", "nvidia_smi": smi,
          "wall_s": time.perf_counter() - t_phase, "default_wall_s": default_wall,
          "episodes": [[e["workload"], e["status"], w]
                       for e, w in zip(report["episodes"], walls["episode_wall_s"])],
          "reference_wall_s": walls["reference_wall_s"],
          "invariant_checks": verdicts, "serving_window_builds": windows,
          "kernel_checks": checks, "kernel_checks_s": check_s,
          "fleet": {"wall_s": fleet_wall, "spec": fleet["episodes"][0]["spec"],
                    "reference_wall_s": fleet_walls["reference_wall_s"],
                    "episode_wall_s": fleet_walls["episode_wall_s"],
                    "killed": fv["fleet_failover"]["data"].get("killed"),
                    "status": fleet["episodes"][0]["status"]},
          "tamper": {"wall_s": tamper_wall, "probes": shrink.get("n_probe_runs"),
                     "shrink_s": tamper_walls["shrink_wall_s"],
                     "minimal": shrink.get("minimal_atoms"), "repro": repro},
          "launches": counts})
    if fails:
        raise AssertionError("path_chaos_campaign: " + "; ".join(fails))
    return counts


# path_multi_gpu: the multi-GPU layer (parallel/) on this one card.
MULTI_GPU_OUT = os.path.join(REPO, "build", "chip_smoke_multi_gpu")
MULTI_GPU_KERNELS = ("hist", "hist_shared", "route_advance", "leaf_record", "traverse",
                     "cd_path")
MULTI_GPU_BUDGET_S = 150.0
MULTI_GPU_RANKS = 2
#: (b)'s forests: the rows' 2,500 and 2,000 trees cut to make room for
#: later phases (PERF.md §4); the sharded-equals-one-process gates hold at
#: any tree count.
MG_DR_TREES, MG_CF_TREES = 500, 400
MG_DR_KEY, MG_CF_KEY, MG_FOLD_KEY, MG_BOOT_KEY = 12325, 12345, 31, 7
FOREST_FIELDS = ("split_feat", "split_bin", "leaf_value", "counts", "train_leaf")
CAUSAL_FIELDS = ("split_feat", "split_bin", "leaf_stats", "in_sample")


def digest(tensors) -> str:
    """sha256 over the bytes of each tensor in turn (equal digests: equal bits)."""
    h = hashlib.sha256()
    for t in tensors:
        a = t.detach().cpu().contiguous()
        h.update(str((tuple(a.shape), str(a.dtype))).encode())
        h.update(a.numpy().tobytes())
    return h.hexdigest()


def interleave(parts: list, n_disp: int, keep: int) -> torch.Tensor:
    """Ranks' (n_disp·per, ...) blocks in the sharded fits' dispatch-major order."""
    a = torch.stack(parts)
    per = a.shape[1] // n_disp
    return a.reshape(len(parts), n_disp, per, *a.shape[2:]).transpose(0, 1).reshape(
        -1, *a.shape[2:])[:keep]


def _mg_tapped(legs) -> dict:
    """(a) in its one rank: the dry run's legs with the kernels' inputs
    tapped, the counts read, then every tapped call held to its plain
    version."""
    reset_counts()
    with kernel_taps() as seen:
        t0 = time.perf_counter()
        summary = legs()
        sync()
        wall = time.perf_counter() - t0
        counts = read_counts()
    t0 = time.perf_counter()
    checks = check_taps(seen)
    return {"summary": summary, "counts": counts, "checks": checks, "legs_s": wall,
            "checks_s": time.perf_counter() - t0}


def _mg_notebook_legs(out: dict, walls: dict) -> None:
    """(b)'s legs at the notebook's widths in this rank (every rank runs
    them); results into ``out``, walls into ``walls``."""
    from ate_replication_causalml_torch.estimators.aipw import clip_propensity
    from ate_replication_causalml_torch.ops.bootstrap import aipw_bootstrap_se_sharded
    from ate_replication_causalml_torch.ops.glm import logistic_glm_sharded
    from ate_replication_causalml_torch.ops.linalg import add_intercept
    from ate_replication_causalml_torch.parallel import shardio
    from ate_replication_causalml_torch.parallel.dryrun import micro_sweep_config
    from ate_replication_causalml_torch.parallel.mesh import (BOOT_AXIS, DATA_AXIS, FOLD_AXIS,
                                                              TREE_AXIS, make_mesh, use_mesh)

    def timed(name, fn):
        t0 = time.perf_counter()
        value = fn()
        sync()
        walls[name] = time.perf_counter() - t0
        return value

    _, frame_mod = notebook_frames("cuda")
    x, w, y = frame_mod.x, frame_mod.w, frame_mod.y
    tree_mesh, fold_mesh = make_mesh((TREE_AXIS,)), make_mesh((FOLD_AXIS,))
    boot_mesh, data_mesh = make_mesh((BOOT_AXIS,)), make_mesh((DATA_AXIS,))
    dev = x.device
    forest = timed("dr_rf_forest", lambda: fo.fit_forest_sharded(
        x, w, rnd.key(MG_DR_KEY, device=dev), tree_mesh, n_trees=MG_DR_TREES, depth=DEPTH))
    vote = fo.predict_forest(forest, x, oob=True).vote
    out["dr_rf"] = {"digest": digest(getattr(forest, f) for f in FOREST_FIELDS),
                    "n_trees": forest.n_trees, "vote": vote.cpu().numpy()}
    fit = timed("causal_fit", lambda: cf.fit_causal_forest(
        frame_mod, key=rnd.key(MG_CF_KEY, device=dev), n_trees=MG_CF_TREES, depth=CF_DEPTH,
        nuisance_trees=CF_NUISANCE_TREES, mesh=tree_mesh))
    li = timed("leaf_index", lambda: cf.compute_leaf_index_sharded(fit.forest, x,
                                                                    mesh=data_mesh))
    out["causal"] = {"digest": digest(getattr(fit.forest, f) for f in CAUSAL_FIELDS),
                     "y_hat": fit.y_hat.cpu().numpy(), "w_hat": fit.w_hat.cpu().numpy(),
                     "leaf_index": hashlib.sha256(np.ascontiguousarray(li).tobytes()).hexdigest(),
                     "leaf_dtype": str(li.dtype)}
    foldid = lasso.default_foldid(rnd.key(MG_FOLD_KEY, device=dev), frame_mod.n)
    with use_mesh(fold_mesh):
        cv = timed("lasso_ps_cv", lambda: lasso.cv_glmnet(x, w, "binomial", foldid=foldid,
                                                          fold_axis=FOLD_AXIS))
    out["cv"] = {"index_min": int(cv.index_min), "index_1se": int(cv.index_1se),
                 "cvm": cv.cvm.cpu().numpy()}
    mu0, mu1 = outcome_model_mu(frame_mod)
    p_rf = clip_propensity(vote)   # as doubly_robust takes the RF propensity
    with use_mesh(boot_mesh):
        se, taus = timed("bootstrap", lambda: aipw_bootstrap_se_sharded(
            w, y, p_rf, mu0, mu1, key=rnd.key(MG_BOOT_KEY, device=dev), n_boot=N_BOOT,
            return_taus=True))
    out["boot"] = {"se": float(se), "taus": taus.cpu().numpy(), "p": p_rf.cpu().numpy(),
                   "mu0": mu0.cpu().numpy(), "mu1": mu1.cpu().numpy()}
    # data: the two IRLS fits in float64 over rows sharded on 'data'.
    x64, w64, y64 = (t.to(torch.float64) for t in (x, w, y))
    rows = shardio.commit((x64, w64, y64), shardio.row_sharding(data_mesh, frame_mod.n),
                          artifact="multi_gpu_glm")
    xl, wl, yl = (r.local for r in rows)
    base = add_intercept(xl)
    glms = timed("data_glm", lambda: (
        logistic_glm_sharded(torch.cat([base, wl[:, None]], dim=1), yl, data_mesh),
        logistic_glm_sharded(base, wl, data_mesh)))
    out["glm"] = {name: {"coef": g.coef.cpu().numpy(), "n_iter": g.n_iter}
                  for name, g in zip(("outcome", "propensity"), glms)}
    # run_sweep(use_mesh=True) at MICRO on the concurrent engine (the mesh
    # lane's ordered collectives), then resumed on the sequential one. A
    # sequential first run was cut for the script's time (PERF.md).
    cfg = micro_sweep_config()
    sweeps = {}
    for name, sub, sched in (("conc", "sweep_conc", None), ("rerun", "sweep_conc", "sequential")):
        logs: list = []
        rep = timed(f"sweep_{name}", lambda: pipeline.run_sweep(
            cfg, outdir=os.path.join(MULTI_GPU_OUT, sub), plots=False, log=logs.append,
            scheduler=sched))
        sweeps[name] = {"rows": [(r.method, r.ate, r.lower_ci, r.upper_ci, r.se, r.status)
                                 for r in rep.results.rows],
                        "computed": rep.computed, "mesh": [s for s in logs
                                                           if s.startswith("mesh:")]}
    out["sweep"] = sweeps
    # the scenario matrix, sharded against unsharded
    dgp = dataclasses.replace(sc.STOCK_DGPS["calibration"], n=64, name="shardcal")
    specs = [sc.MatrixSpec(dgps=(dgp,), estimators=("naive",), n_reps=8, batch_width=8,
                           shard=shard, rows=True) for shard in (False, True)]
    reps = [timed(f"matrix_{i}", lambda s=s: sc.run_matrix(s, scheduler="sequential",
                                                          log=lambda m: None))
            for i, s in enumerate(specs)]
    out["matrix"] = sc.compare_cells(reps[0].cells, reps[1].cells)


def _mg_notebook_rank() -> dict:
    """(b) in each of the two ranks sharing the card: the legs, the counts
    read; in rank 0 the kernels' inputs tapped and the tapped calls
    checked (rank 1 runs the same program on its own keys)."""
    out: dict = {}
    walls: dict = {}
    reset_counts()
    taps = kernel_taps() if torch.distributed.get_rank() == 0 else contextlib.nullcontext({})
    with taps as seen:
        t0 = time.perf_counter()
        _mg_notebook_legs(out, walls)
        walls["legs"] = time.perf_counter() - t0
        out["counts"] = read_counts()
    t0 = time.perf_counter()
    out["checks"] = check_taps(seen)
    walls["checks"] = time.perf_counter() - t0
    out["walls"] = walls
    out["staged_bytes"] = obs.REGISTRY.peek("collective_host_staging_bytes_total") or {}
    return out


def _mg_references(ranks: list, fails: list) -> dict:
    """The one-process counterparts, on this card, of (b)'s sharded legs,
    and the gates that compare them. Returns the comparison record."""
    from ate_replication_causalml_torch.models.plan import sharded_causal_plan
    from ate_replication_causalml_torch.ops.bootstrap import aipw_bootstrap_taus_chunked
    from ate_replication_causalml_torch.ops.glm import logistic_glm
    from ate_replication_causalml_torch.ops.hist import resolve_hist_mode_packed
    from ate_replication_causalml_torch.ops.linalg import add_intercept

    a = MULTI_GPU_RANKS
    r0 = ranks[0]
    rec: dict = {}
    _, frame_mod = notebook_frames("cuda")
    x, w, y = frame_mod.x, frame_mod.w, frame_mod.y
    n, p = x.shape
    mode = resolve_hist_mode_packed(None, N_BINS)
    codes = fo.binarize(x, fo.quantile_bins(x, N_BINS))
    for r in ranks[1:]:
        for leg in ("dr_rf", "causal"):
            if r[leg]["digest"] != r0[leg]["digest"]:
                fails.append(f"{leg}: the ranks' forests differ")
    # DR-RF: the one-process grow of the ranks' key slices.
    chunk, cpd, n_disp = fo.sharded_fit_plan(n, DEPTH, -(-MG_DR_TREES // a), p=p)
    key = rnd.key(MG_DR_KEY, device="cuda")
    parts = [fo._grow_from_keys(fo.sharded_tree_keys(key, n_disp, a, chunk * cpd, r), codes, w,
                                depth=DEPTH, mtry=int(np.sqrt(p)), n_bins=N_BINS, hist_mode=mode,
                                tree_chunk=fo.DEFAULT_TREE_CHUNK, pool="reference")
             for r in range(a)]
    ref = [interleave([q[j] for q in parts], n_disp, MG_DR_TREES) for j in range(5)]
    rec["dr_rf"] = {"plan": [chunk, cpd, n_disp], "equal": digest(ref) == r0["dr_rf"]["digest"]}
    if not rec["dr_rf"]["equal"]:
        fails.append("DR-RF: the two-rank forest is not the one-process grow of its keys")
    del parts, ref
    # The causal grow on the ranks' residuals, and its leaf index.
    wt = w - torch.as_tensor(r0["causal"]["w_hat"], device="cuda")
    yt = y - torch.as_tensor(r0["causal"]["y_hat"], device="cuda")
    kc = rnd.split(rnd.key(MG_CF_KEY, device="cuda"), 3)[2]
    groups = MG_CF_TREES // 2
    chunk, cpd, n_disp = sharded_causal_plan(n, CF_DEPTH, -(-groups // a), 2, p, N_BINS, mode)
    parts = [cf._grow_from_group_keys(
        fo.sharded_tree_keys(kc, n_disp, a, chunk * cpd, r), codes, wt, yt, mtry=None,
        depth=CF_DEPTH, n_bins=N_BINS, min_node=5, sample_fraction=0.5, k=2, honesty=True,
        group_chunk=cf.DEFAULT_GROUP_CHUNK, hist_mode=mode, pool="reference")
        for r in range(a)]
    ref = [interleave([q[j] for q in parts], n_disp, MG_CF_TREES) for j in range(4)]
    forest = cf.CausalForest(*ref, bin_edges=fo.quantile_bins(x, N_BINS), ci_group_size=2)
    li = cf.compute_leaf_index(forest, x).cpu().numpy()
    rec["causal"] = {"plan": [chunk, cpd, n_disp], "equal": digest(ref) == r0["causal"]["digest"],
                     "leaf_index_equal": (hashlib.sha256(li.tobytes()).hexdigest()
                                          == r0["causal"]["leaf_index"]
                                          and str(li.dtype) == r0["causal"]["leaf_dtype"])}
    if not (rec["causal"]["equal"] and rec["causal"]["leaf_index_equal"]):
        fails.append(f"causal forest: not the one-process grow of its group keys ({rec['causal']})")
    del parts, ref, forest
    # fold: the unsharded CV, bit for bit.
    foldid = lasso.default_foldid(rnd.key(MG_FOLD_KEY, device="cuda"), n)
    cv = lasso.cv_glmnet(x, w, "binomial", foldid=foldid)
    rec["cv"] = {"index_min": int(cv.index_min), "index_1se": int(cv.index_1se),
                 "cvm_equal": all(np.array_equal(r["cv"]["cvm"], cv.cvm.cpu().numpy())
                                  for r in ranks)}
    if not (rec["cv"]["cvm_equal"] and all(
            (r["cv"]["index_min"], r["cv"]["index_1se"]) == (rec["cv"]["index_min"],
                                                             rec["cv"]["index_1se"])
            for r in ranks)):
        fails.append(f"fold-sharded CV is not the unsharded CV: {rec['cv']}")
    # boot: the one-process draws from fold_in(key, r), concatenated.
    t = lambda v: torch.as_tensor(v, device="cuda")
    per = N_BOOT // a
    bkey = rnd.key(MG_BOOT_KEY, device="cuda")
    taus = torch.cat([aipw_bootstrap_taus_chunked(
        w, y, t(r0["boot"]["p"]), t(r0["boot"]["mu0"]), t(r0["boot"]["mu1"]),
        key=rnd.fold_in(bkey, r), n_boot=per, chunk=per) for r in range(a)]).cpu().numpy()
    rec["boot"] = {"taus_equal": all(np.array_equal(r["boot"]["taus"], taus) for r in ranks),
                   "se": r0["boot"]["se"]}
    if not (rec["boot"]["taus_equal"] and math.isfinite(rec["boot"]["se"])
            and rec["boot"]["se"] > 0):
        fails.append(f"bootstrap: taus not the one-process draws from fold_in(key, r), or "
                     f"SE {rec['boot']['se']}")
    # data: each float64 IRLS fit against the one-process fit, within
    # |Δβ| ≤ 2κγ_n|β| / (1 − κγ_n): the two fits' normal equations differ
    # only in the order of their n-term sums, each off by at most γ_n =
    # n·eps / (1 − n·eps) relative, and a relative perturbation δ of A
    # and b moves the solve by at most 2κδ / (1 − κδ) (κ = cond₂(X'WX)).
    x64, w64, y64 = (v.to(torch.float64) for v in (x, w, y))
    base = add_intercept(x64)
    eps = float(np.finfo(np.float64).eps)
    gamma = n * eps / (1 - n * eps)
    rec["glm"] = {}
    for name, design, target in (("outcome", torch.cat([base, w64[:, None]], dim=1), y64),
                                 ("propensity", base, w64)):
        one = logistic_glm(design, target)
        mu = one.fitted
        xtwx = (design * (mu * (1 - mu)).clamp(min=1e-10)[:, None]).T @ design
        kappa = float(torch.linalg.cond(xtwx))
        coef = one.coef.cpu().numpy()
        bound = 2 * kappa * gamma * float(np.linalg.norm(coef)) / (1 - kappa * gamma)
        errs = [float(np.linalg.norm(r["glm"][name]["coef"] - coef)) for r in ranks]
        iters = [r["glm"][name]["n_iter"] for r in ranks]
        rec["glm"][name] = {"max_abs_err": max(errs), "bound": bound, "kappa": kappa,
                            "n_iter": one.n_iter, "rank_iters": iters}
        if not (max(errs) <= bound and all(i == one.n_iter for i in iters)):
            fails.append(f"data-axis {name} fit: |Δβ| {max(errs)} > {bound}, or iterations "
                         f"{iters} != {one.n_iter}")
    return rec


def phase_path_multi_gpu(smi: str) -> dict:
    """The multi-GPU layer on this card (docstring, 11j). Returns the
    kernel launches of the ranks' runs, summed."""
    from ate_replication_causalml_torch.parallel.dryrun import dryrun_multigpu
    from ate_replication_causalml_torch.parallel.spawn import run_ranks
    from ate_replication_causalml_torch.pipeline import SWEEP_METHODS

    shutil.rmtree(MULTI_GPU_OUT, ignore_errors=True)
    os.makedirs(MULTI_GPU_OUT)
    fails: list = []
    t_phase = time.perf_counter()
    build.build_all()   # the ranks only load the libraries built here
    # (a) one rank, NCCL: every leg of the dry run at its own shapes but
    # the MICRO sweep, which (b) runs over its mesh; (b) two
    # ranks on the card under gloo, at the notebook's widths. The two
    # worlds run at once: their ranks are launch-bound and leave the card
    # mostly idle.
    worlds: dict = {}

    def world(name, fn):
        t0 = time.perf_counter()
        try:
            worlds[name] = (fn(), time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 — re-raised below, on this thread
            worlds[name] = (e, time.perf_counter() - t0)

    threads = [threading.Thread(target=world, args=("a", lambda: dryrun_multigpu(
                   1, "nccl", "cuda", timeout=300, around=_mg_tapped,
                   scratch=MULTI_GPU_OUT, sweep=False)[0])),
               threading.Thread(target=world, args=("b", lambda: run_ranks(
                   _mg_notebook_rank, MULTI_GPU_RANKS, backend="gloo", device="cuda",
                   timeout=300, scratch=MULTI_GPU_OUT)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for value, _ in worlds.values():
        if isinstance(value, BaseException):
            raise value
    (one, a_wall), (ranks, b_wall) = worlds["a"], worlds["b"]
    t0 = time.perf_counter()
    rec = _mg_references(ranks, fails)
    ref_wall = time.perf_counter() - t0
    for i, r in enumerate(ranks):
        conc, rerun = (r["sweep"][k] for k in ("conc", "rerun"))
        if [row[0] for row in conc["rows"]] != list(SWEEP_METHODS) or not all(
                math.isfinite(row[1]) for row in conc["rows"]):
            fails.append(f"rank {i}: sweep rows {conc['rows']}")
        if repr(r["sweep"]) != repr(ranks[0]["sweep"]):
            fails.append(f"rank {i}: sweep differs from rank 0's")
        if rerun["computed"] != 0 or repr(rerun["rows"]) != repr(conc["rows"]) or conc["mesh"] != [
                f"mesh: {MULTI_GPU_RANKS} devices — tree + fold axes active"]:
            fails.append(f"rank {i}: rerun computed {rerun['computed']} or its rows differ, "
                         f"mesh {conc['mesh']}")
        if r["matrix"]["missing"] or r["matrix"]["max_ulp"] != 0.0:
            fails.append(f"rank {i}: sharded matrix {r['matrix']}")
    for sub in ("sweep_conc",):
        with open(os.path.join(MULTI_GPU_OUT, sub, "results.jsonl")) as f:
            methods = [json.loads(line)["method"] for line in f if line.strip()]
        if methods.count("__config__") != 1 or len(methods) != len(SWEEP_METHODS) + 2:
            fails.append(f"{sub}: journal lines {methods}: not rank 0's alone")
    counts = {k: one["counts"][k] + sum(r["counts"][k] for r in ranks) for k in COUNTERS}
    try:
        require_launched(counts, MULTI_GPU_KERNELS, "multi_gpu")
    except AssertionError as e:
        fails.append(str(e))
    checks = [one["checks"]] + [r["checks"] for r in ranks]
    unchecked = [k for k in MULTI_GPU_KERNELS if not any(k in c for c in checks)]
    if unchecked:
        fails.append(f"kernels never held to their plain version at this path's inputs: "
                     f"{unchecked}")
    wall = time.perf_counter() - t_phase
    if wall > MULTI_GPU_BUDGET_S:
        fails.append(f"the phase took {wall:.1f} s, over its {MULTI_GPU_BUDGET_S} s budget")
    emit({"phase": "path_multi_gpu", "nvidia_smi": smi, "wall_s": wall,
          "one_rank_nccl": {"wall_s": a_wall, "legs_s": one["legs_s"],
                            "checks_s": one["checks_s"], "summary": {
                                k: v for k, v in one["summary"].items() if k != "sweep"},
                            "checks": one["checks"], "launches": one["counts"]},
          "two_ranks_gloo": {"wall_s": b_wall, "walls": [r["walls"] for r in ranks],
                             "checks": [r["checks"] for r in ranks],
                             "launches": [r["counts"] for r in ranks],
                             "staged_bytes": [r["staged_bytes"] for r in ranks],
                             "lasso_ps": ranks[0]["cv"]["index_min"],
                             "boot_se": ranks[0]["boot"]["se"],
                             "sweep_rows": ranks[0]["sweep"]["conc"]["rows"]},
          "references": rec, "references_s": ref_wall, "launches": counts})
    if fails:
        raise AssertionError("path_multi_gpu: " + "; ".join(fails))
    return counts


# path_matmul_growers: the JAX package's matmul backends ("xla", "onehot";
# row_backend "matmul") at the notebook's widths, grown and predicted on the
# kernels: the classifier and regressor on the streaming grower, the causal
# forest on the direct-ρ grower. Tree counts are cut to MATMUL_TREES (the
# notebook's 2,500 / 500 / 2,000); the CPU port grows the first
# MATMUL_CPU_TREES of each forest for the card-CPU split agreement.
MATMUL_TREES = 64
MATMUL_CPU_TREES = 8
MATMUL_SEED = 1818
MATMUL_SPLIT_AGREEMENT = 0.95
MATMUL_CATE_GAP = 0.05
MATMUL_BACKENDS = ("xla", "onehot")
MATMUL_KERNELS = ("hist", "hist_partition", "node_sums", "node_sums_shared", "route_advance",
                  "leaf_record", "traverse")
FOREST_EQUAL = ("split_feat", "split_bin", "leaf_value", "counts", "train_leaf")


def split_agreement(a, b, trees: int | None = None) -> dict:
    """Fraction of equal (feature, bin) cells over the whole split table
    (the JAX package's measure, padded cells included) and over the live
    nodes only; ``trees`` compares the first trees only."""
    fa, ba = a.split_feat[:trees].cpu(), a.split_bin[:trees].cpu()
    fb, bb = b.split_feat[:trees].cpu(), b.split_bin[:trees].cpu()
    same = (fa == fb) & (ba == bb)
    live = torch.zeros_like(same)
    for lv in range(same.shape[1]):
        live[:, lv, : 1 << lv] = True
    return {"table": float(same.float().mean()), "live": float(same[live].float().mean())}


def mean_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """mean |got − ref| / mean |ref| (``tests/test_hist_pallas.py``'s CATE gap)."""
    return float((got - ref).abs().mean() / (ref.abs().mean() + 1e-6))


def timed_fit(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def phase_path_matmul_growers(frame_mod, smi: str) -> tuple[dict, dict, dict]:
    """The JAX package's matmul backends on the card (docstring, 11k).
    Returns the kernel launches of their fits and predicts, the three
    "auto" fits and the fit of each kind by backend name."""
    x, w, y = frame_mod.x, frame_mod.w, frame_mod.y
    n = x.shape[0]
    rng = np.random.default_rng(MATMUL_SEED)
    ycont = (x[:, 0] + torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                                       device="cuda")).contiguous()
    key = rnd.key(MATMUL_SEED, device="cuda")
    fails: list = []
    walls: dict = {}
    out: dict = {"phase": "path_matmul_growers", "nvidia_smi": smi, "rows": n, "p": x.shape[1],
                 "n_bins": N_BINS, "trees": MATMUL_TREES, "depth": DEPTH, "cf_depth": CF_DEPTH,
                 "reduced": {"trees": f"{MATMUL_TREES} (notebook: {DR_TREES} classifier, "
                             f"{CF_NUISANCE_TREES} regressor, {CF_TREES} causal)",
                             "cpu_trees": MATMUL_CPU_TREES}}
    t_phase = time.perf_counter()
    fit = {"classifier": lambda b, **kw: fo.fit_forest_classifier(
               x, w, key, n_trees=MATMUL_TREES, depth=DEPTH, hist_backend=b, **kw),
           "regressor": lambda b, **kw: fo.fit_forest_regressor(
               x, ycont, key, n_trees=MATMUL_TREES, depth=DEPTH, hist_backend=b, **kw),
           "causal": lambda b, **kw: cf.fit_causal_forest(
               frame_mod, key, MATMUL_TREES, CF_DEPTH, MATMUL_TREES, DEPTH, b, **kw)}
    kernel = {}
    for kind in fit:
        kernel[kind], walls[f"{kind}:auto"] = timed_fit(lambda: fit[kind]("auto"))
    reset_counts()
    got = {}
    preds = {}
    with kernel_taps() as seen:
        for kind in fit:
            for b in MATMUL_BACKENDS:
                got[kind, b], walls[f"{kind}:{b}"] = timed_fit(lambda: fit[kind](b))
        for b in MATMUL_BACKENDS:
            for oob in (True, False):
                preds[b, oob] = cf.predict_cate(got["causal", b].forest, x, oob=oob,
                                                row_backend="matmul")
        sync()
        counts = read_counts()
    t0 = time.perf_counter()
    held = check_taps(seen)
    taps_s = time.perf_counter() - t0
    try:
        require_launched(counts, MATMUL_KERNELS, "matmul_growers")
    except AssertionError as e:
        fails.append(str(e))
    unheld = [k for k in MATMUL_KERNELS if k not in held]
    if unheld:
        fails.append(f"never held to their plain versions: {unheld}")
    checks: dict = {}
    for b in MATMUL_BACKENDS:
        # The classifier and regressor: the streaming grower's forest.
        for kind in ("classifier", "regressor"):
            mine, ref = got[kind, b], kernel[kind]
            unequal = [f for f in FOREST_EQUAL
                       if not torch.equal(getattr(mine, f), getattr(ref, f))]
            if unequal:
                fails.append(f"{kind} {b}: {unequal} differ from the kernel grower's")
            checks[f"{kind}:{b}"] = {"equal_fields": [f for f in FOREST_EQUAL
                                                      if f not in unequal]}
        fit_b, fit_ref = got["causal", b], kernel["causal"]
        same_nuisance = (torch.equal(fit_b.y_hat, fit_ref.y_hat)
                         and torch.equal(fit_b.w_hat, fit_ref.w_hat))
        agree = split_agreement(fit_b.forest, fit_ref.forest)
        cate = cf.predict_cate(fit_b.forest, x, oob=False).cate
        gap = mean_gap(cate, cf.predict_cate(fit_ref.forest, x, oob=False).cate)
        eff = cf.average_treatment_effect(fit_b)
        checks[f"causal:{b}"] = {"agreement": agree, "cate_gap": gap,
                                 "nuisance_equal": same_nuisance,
                                 "ate": float(eff.estimate), "se": float(eff.std_err)}
        if not (same_nuisance and agree["table"] >= MATMUL_SPLIT_AGREEMENT
                and gap < MATMUL_CATE_GAP):
            fails.append(f"causal {b}: {checks[f'causal:{b}']}")
        for oob in (True, False):
            stream = cf.predict_cate(fit_b.forest, x, oob=oob)
            if not (torch.equal(preds[b, oob].cate, stream.cate)
                    and torch.equal(preds[b, oob].variance, stream.variance)):
                fails.append(f"predict_cate matmul != kernels ({b} forest, oob={oob})")
        checks[f"predict:{b}"] = "matmul == kernels, oob True and False"
    # One direct-ρ grower under both names (the JAX package's two modes).
    one = [f for f in ("split_feat", "split_bin", "leaf_stats", "in_sample")
           if not torch.equal(getattr(got["causal", "xla"].forest, f),
                              getattr(got["causal", "onehot"].forest, f))]
    if one:
        fails.append(f"causal xla and onehot differ in {one}")
    eff = cf.average_treatment_effect(kernel["causal"])
    checks["causal:auto"] = {"ate": float(eff.estimate), "se": float(eff.std_err)}
    # The CPU port with the same backend and key: the first trees.
    cpu: dict = {}
    xc, wc, yc = x.cpu(), w.cpu(), ycont.cpu()
    keyc = key.cpu()
    t0 = time.perf_counter()
    for b in MATMUL_BACKENDS:
        for kind, (yy, fitter) in {"classifier": (wc, fo.fit_forest_classifier),
                                   "regressor": (yc, fo.fit_forest_regressor)}.items():
            host = fitter(xc, yy, keyc, n_trees=MATMUL_CPU_TREES, depth=DEPTH, hist_backend=b)
            cpu[f"{kind}:{b}"] = split_agreement(host, got[kind, b], MATMUL_CPU_TREES)
        fit_b = got["causal", b]
        kc = rnd.split(keyc, 3)[2]
        host = cf.grow_causal_forest(xc, (fit_b.w - fit_b.w_hat).cpu(),
                                     (fit_b.y - fit_b.y_hat).cpu(), kc,
                                     n_trees=MATMUL_CPU_TREES, depth=CF_DEPTH, hist_backend=b)
        cpu[f"causal:{b}"] = split_agreement(host, fit_b.forest, MATMUL_CPU_TREES)
    cpu_wall = time.perf_counter() - t0
    if not all(cpu[f"classifier:{b}"]["table"] == 1.0 for b in MATMUL_BACKENDS):
        fails.append(f"the CPU port's classifier differs from the card's: {cpu}")
    out.update(walls_s=walls, checks=checks, cpu_agreement=cpu, cpu_s=cpu_wall,
               kernels_held=held, taps_s=taps_s, launches=counts,
               wall_s=time.perf_counter() - t_phase)
    emit(out)
    if fails:
        raise AssertionError("path_matmul_growers: " + "; ".join(fails))
    return counts, kernel, fit


# path_pallas_backends: the JAX package's explicit Pallas names at the
# notebook's widths, through the entry points: the classifier, the
# nuisance regressor and the honest causal forest (its own regressors
# included) under "pallas" (the kernels: bit for bit path_matmul_growers'
# "auto" fits) and "pallas_bf16" (the split search's histograms in their
# bf16 form: the classifier bit for bit "auto"), the bf16 regressor and
# causal fit again under the packed policy (bit for bit the unpacked
# ones: dense == partition == packed holds in the bf16 form), and
# "pallas_interpret" refused on the card. Tree counts as
# path_matmul_growers' (MATMUL_TREES).
PALLAS_NAMES = ("pallas", "pallas_bf16")


def phase_path_pallas_backends(frame_mod, smi: str, auto: dict, fit: dict) -> dict:
    """Returns the kernel launches of the fits under the Pallas names."""
    x = frame_mod.x
    fails: list = []
    walls: dict = {}
    t_phase = time.perf_counter()
    got: dict = {}
    reset_counts()
    for kind in fit:
        got[kind, "pallas"], walls[f"{kind}:pallas"] = timed_fit(lambda: fit[kind]("pallas"))
    with kernel_taps() as seen:
        for kind in fit:
            got[kind, "pallas_bf16"], walls[f"{kind}:pallas_bf16"] = timed_fit(
                lambda: fit[kind]("pallas_bf16"))
        with packed_policy():
            for kind in ("regressor", "causal"):
                got[kind, "packed"], walls[f"{kind}:pallas_bf16+pack"] = timed_fit(
                    lambda: fit[kind]("pallas_bf16"))
        sync()
        counts = read_counts()
    t0 = time.perf_counter()
    held = check_taps(seen)
    taps_s = time.perf_counter() - t0
    try:
        require_launched(counts, BF16_KERNELS, "pallas_backends")
    except AssertionError as e:
        fails.append(str(e))
    unheld = [k for k in BF16_KERNELS if k not in held]
    if unheld:
        fails.append(f"never held to their plain versions: {unheld}")

    def forest_of(v):
        return v.forest if isinstance(v, cf.FittedCausalForest) else v

    def unequal(a, b) -> list:
        fa, fb = forest_of(a), forest_of(b)
        fields = CAUSAL_FIELDS if isinstance(fa, cf.CausalForest) else FOREST_EQUAL
        diff = [f for f in fields if not torch.equal(getattr(fa, f), getattr(fb, f))]
        if isinstance(a, cf.FittedCausalForest):
            diff += [f for f in ("y_hat", "w_hat") if not torch.equal(getattr(a, f), getattr(b, f))]
        return diff

    checks: dict = {}
    for kind in fit:
        diff = unequal(got[kind, "pallas"], auto[kind])
        checks[f"{kind}:pallas"] = {"unequal_to_auto": diff}
        if diff:
            fails.append(f"{kind} pallas: {diff} differ from the auto fit")
    diff = unequal(got["classifier", "pallas_bf16"], auto["classifier"])
    if diff:
        fails.append(f"classifier pallas_bf16: {diff} differ from the auto fit")
    checks["classifier:pallas_bf16"] = {"unequal_to_auto": diff}
    for kind in ("regressor", "causal"):
        diff = unequal(got[kind, "packed"], got[kind, "pallas_bf16"])
        if diff:
            fails.append(f"{kind} pallas_bf16: the packed policy's fit differs in {diff}")
        checks[f"{kind}:pallas_bf16"] = {
            "agreement": split_agreement(forest_of(got[kind, "pallas_bf16"]),
                                         forest_of(auto[kind])),
            "packed_unequal": diff}
    bf16_fit, auto_fit = got["causal", "pallas_bf16"], auto["causal"]
    cate = cf.predict_cate(bf16_fit.forest, x, oob=False).cate
    checks["causal:pallas_bf16"]["cate_gap"] = mean_gap(
        cate, cf.predict_cate(auto_fit.forest, x, oob=False).cate)
    checks["causal:pallas_bf16"]["nuisance_equal"] = (
        torch.equal(bf16_fit.y_hat, auto_fit.y_hat) and torch.equal(bf16_fit.w_hat, auto_fit.w_hat))
    ate = {}
    for name, f in (("auto", auto_fit), ("pallas", got["causal", "pallas"]),
                    ("pallas_bf16", bf16_fit)):
        eff = cf.average_treatment_effect(f)
        ate[name] = {"ate": float(eff.estimate), "se": float(eff.std_err)}
    # "pallas_interpret" names the plain CPU versions: refused on the card.
    refused = {}
    for what, call in (
            ("fit_forest_classifier", lambda: fit["classifier"]("pallas_interpret")),
            ("fit_causal_forest", lambda: fit["causal"]("pallas_interpret")),
            ("predict_cate", lambda: cf.predict_cate(auto_fit.forest, x,
                                                     row_backend="pallas_interpret"))):
        try:
            call()
            refused[what] = False
        except ValueError as e:
            refused[what] = "'pallas' or 'auto'" in str(e)
    if not all(refused.values()):
        fails.append(f"pallas_interpret not refused on the card: {refused}")
    emit({"phase": "path_pallas_backends", "nvidia_smi": smi, "rows": x.shape[0],
          "p": x.shape[1], "n_bins": N_BINS, "trees": MATMUL_TREES, "depth": DEPTH,
          "cf_depth": CF_DEPTH,
          "reduced": {"trees": f"{MATMUL_TREES} (notebook: {DR_TREES} classifier, "
                      f"{CF_NUISANCE_TREES} regressor, {CF_TREES} causal)"},
          "walls_s": walls, "checks": checks, "ate": ate, "refused_on_card": refused,
          "kernels_held": held, "taps_s": taps_s, "launches": counts,
          "wall_s": time.perf_counter() - t_phase})
    if fails:
        raise AssertionError("path_pallas_backends: " + "; ".join(fails))
    return counts


# path_rbridge: every function the R shim calls, through the port's bridge
# on the card, with df_mod marshalled as reticulate sends it. Tree counts
# are cut (the notebook's 2,500 / 2,000 / 2,000).
RBRIDGE_DR_TREES = 64
RBRIDGE_DML_TREES = 64
RBRIDGE_CF_TREES = 128
# run_notebook_sweep(quick=True) at the MICRO sweep's overrides
# (tests/test_pipeline_driver.py).
RBRIDGE_SWEEP = dict(n_obs=1200, seed=1991, overrides=dict(
    synthetic_pool=3000.0, dr_trees=16.0, dml_trees=16.0, cf_trees=16.0, cf_nuisance_trees=16.0,
    forest_depth=4.0, balance_iters=600.0))
RBRIDGE_KERNELS = ("hist", "hist_partition", "hist_shared", "hist_partition_shared", "node_sums",
                   "node_sums_shared", "route_advance", "leaf_record", "traverse", "cd_path")


def same_bridge_row(a: dict, b: dict) -> bool:
    """Two bridge rows equal bit for bit (NaN equal to NaN)."""
    if a.keys() != b.keys():
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, float) and isinstance(y, float):
            if not (x == y or (math.isnan(x) and math.isnan(y))):
                return False
        elif x != y:
            return False
    return True


def phase_path_rbridge(frame_mod, smi: str) -> dict:
    """The reticulate bridge on the card (docstring, 11l). Returns the
    kernel launches of the bridge's calls alone: the direct port calls
    they are held to run after the counts are read."""
    from ate_replication_causalml_torch import rbridge
    from ate_replication_causalml_torch.parallel.dryrun import micro_sweep_config

    names = list(frame_mod.schema.covariates)
    host = frame_mod.x.double().cpu().numpy()
    cols = {c: [float(v) for v in host[:, j]] for j, c in enumerate(names)}
    cols["W"] = [float(v) for v in frame_mod.w.double().cpu().numpy()]
    cols["Y"] = [float(v) for v in frame_mod.y.double().cpu().numpy()]
    key = lambda s: rnd.key(s, device="cuda")
    fails: list = []
    walls: dict = {}
    calls: list = []
    t_phase = time.perf_counter()

    def bridged(name, call, direct):
        """The bridge's result, timed; ``direct``, the port call it must
        equal, is kept for after the counts are read."""
        sync()
        t0 = time.perf_counter()
        got = call()
        sync()
        walls[name] = time.perf_counter() - t0
        calls.append((name, got, direct))
        return got

    reset_counts()
    with kernel_taps() as seen:
        dr = bridged("doubly_robust",
                     lambda: rbridge.doubly_robust(cols, num_trees=RBRIDGE_DR_TREES),
                     lambda: doubly_robust(frame_mod, propensity_fn=lambda f: fo.rf_oob_propensity(
                         f, key(12325), n_trees=RBRIDGE_DR_TREES), key=key(12326)))
        cfr = bridged("causal_forest",
                      lambda: rbridge.causal_forest(cols, num_trees=RBRIDGE_CF_TREES),
                      lambda: {**rbridge._row((rep := causal_forest_report(
                          frame_mod, key=key(12345), n_trees=RBRIDGE_CF_TREES)).result),
                          "incorrect_ate": rep.incorrect_ate, "incorrect_se": rep.incorrect_se})
    rows = {"doubly_robust": dr, "causal_forest": cfr}
    rows["naive"] = bridged("naive_ate", lambda: rbridge.naive_ate(cols),
                            lambda: naive_ate(frame_mod))
    rows["ols"] = bridged("ate_condmean_ols", lambda: rbridge.ate_condmean_ols(cols),
                          lambda: ate_condmean_ols(frame_mod))
    p_log = bridged("logistic_propensity", lambda: rbridge.logistic_propensity(cols),
                    lambda: logistic_propensity(frame_mod.x, frame_mod.w))
    p_list = [float(v) for v in p_log]
    p_t = torch.as_tensor(np.asarray(p_list))
    rows["psw"] = bridged("prop_score_weight", lambda: rbridge.prop_score_weight(cols, p_list),
                          lambda: prop_score_weight(frame_mod, p_t))
    rows["psols"] = bridged("prop_score_ols", lambda: rbridge.prop_score_ols(cols, p_list),
                            lambda: prop_score_ols(frame_mod, p_t))
    rows["condmean_lasso"] = bridged("ate_condmean_lasso", lambda: rbridge.ate_condmean_lasso(cols),
                                     lambda: lasso_est.ate_condmean_lasso(frame_mod))
    rows["lasso"] = bridged("ate_lasso", lambda: rbridge.ate_lasso(cols),
                            lambda: lasso_est.ate_lasso(frame_mod))
    bridged("prop_score_lasso", lambda: rbridge.prop_score_lasso(cols),
            lambda: lasso_est.prop_score_lasso(frame_mod))
    rows["glm"] = bridged("doubly_robust_glm", lambda: rbridge.doubly_robust_glm(cols),
                          lambda: doubly_robust_glm(frame_mod, key=key(0)))
    rows["belloni"] = bridged("belloni", lambda: rbridge.belloni(cols),
                              lambda: bel.belloni(frame_mod))
    rows["dml"] = bridged("double_ml", lambda: rbridge.double_ml(cols, num_trees=RBRIDGE_DML_TREES),
                          lambda: dml.double_ml(frame_mod, n_trees=RBRIDGE_DML_TREES, key=key(123),
                                                device="cuda"))
    rows["balance"] = bridged("residual_balance_ATE", lambda: rbridge.residual_balance_ATE(cols),
                              lambda: balance.residual_balance_ate(frame_mod, key=key(0)))
    sync()
    counts = read_counts()
    t0 = time.perf_counter()
    for name, got, direct in calls:
        want = direct()
        if isinstance(got, dict):
            ok = same_bridge_row(got, want if isinstance(want, dict) else rbridge._row(want))
        else:
            ok = np.array_equal(got, np.asarray(want.cpu().numpy(), np.float64))
        if not ok:
            fails.append(f"{name}: bridge {got if isinstance(got, dict) else '(vector)'} "
                         f"!= direct")
    direct_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    held = check_taps(seen)
    taps_s = time.perf_counter() - t0
    unheld = [k for k in RBRIDGE_KERNELS if k != "cd_path" and k not in held]
    if unheld:
        fails.append(f"never held to their plain versions on the DR-RF and causal rows: {unheld}")
    try:
        require_launched(counts, RBRIDGE_KERNELS, "rbridge")
    except AssertionError as e:
        fails.append(str(e))
    # The notebook driver on the sequential engine (the concurrent one
    # gives the same rows bit for bit, path_sweep_concurrent): its
    # configuration is the MICRO sweep's, and its rows are the oracle and
    # the sweep's methods, finite. run_sweep's rows themselves are
    # path_sweep's.
    cfg = rbridge._sweep_config(quick=True, **RBRIDGE_SWEEP)
    if cfg != micro_sweep_config():
        fails.append(f"run_notebook_sweep's configuration {cfg} is not the MICRO sweep's")
    with env("ATE_TPU_SWEEP_SEQUENTIAL", "1"):
        sync()
        t0 = time.perf_counter()
        sweep_rows = rbridge.run_notebook_sweep(quick=True, **RBRIDGE_SWEEP)
        walls["run_notebook_sweep"] = time.perf_counter() - t0
    methods = [r["Method"] for r in sweep_rows]
    if methods != ["oracle", *pipeline.SWEEP_METHODS] or not all(
            math.isfinite(r["ATE"]) for r in sweep_rows):
        fails.append(f"run_notebook_sweep's rows: {sweep_rows}")
    emit({"phase": "path_rbridge", "nvidia_smi": smi, "rows": frame_mod.n,
          "reduced": {"doubly_robust_trees": RBRIDGE_DR_TREES, "double_ml_trees": RBRIDGE_DML_TREES,
                      "causal_forest_trees": RBRIDGE_CF_TREES,
                      "run_notebook_sweep": RBRIDGE_SWEEP},
          "results": rows, "sweep_methods": methods, "walls_s": walls, "direct_s": direct_s,
          "kernels_held": held, "taps_s": taps_s, "launches": counts,
          "wall_s": time.perf_counter() - t_phase})
    if fails:
        raise AssertionError("path_rbridge: " + "; ".join(fails))
    return counts


# path_native: the native host library on the card machine, on a CSV of
# the synthetic pool at the notebook's size with NA and blank cells.
NATIVE_OUT = os.path.join(REPO, "build", "chip_smoke_native")
NATIVE_PLANTED = 600
# Sentinels the CSV writer turns into "NA" and blank cells.
_NA, _BLANK = 1e308, -1e308


def phase_path_native(smi: str) -> None:
    """The native host library (docstring, 11m)."""
    from ate_replication_causalml_torch import native
    from ate_replication_causalml_torch.data import pipeline as dp
    from ate_replication_causalml_torch.data.schema import GGL_SCHEMA
    from ate_replication_causalml_torch.utils.rrandom import RCompatRNG

    fails: list = []
    walls: dict = {}
    t0 = time.perf_counter()
    lib = native.load_library(rebuild=True)
    walls["build"] = time.perf_counter() - t0
    status = native.native_status()
    if lib is None:
        raise AssertionError(f"path_native: the native library did not build: {status}")
    shutil.rmtree(NATIVE_OUT, ignore_errors=True)
    os.makedirs(NATIVE_OUT)
    raw = make_ggl_like(POOL_ROWS, seed=POOL_SEED, true_ate=TRUE_ATE)
    cols = list(GGL_SCHEMA.all_columns)
    mat = np.stack([np.asarray(raw[c], np.float64) for c in cols], axis=1)
    rng = np.random.default_rng(POOL_SEED)
    r_idx = rng.integers(0, mat.shape[0], NATIVE_PLANTED)
    c_idx = rng.integers(0, mat.shape[1], NATIVE_PLANTED)
    mat[r_idx, c_idx] = np.where(np.arange(NATIVE_PLANTED) % 2 == 0, _NA, _BLANK)
    path = os.path.join(NATIVE_OUT, "pool.csv")
    t0 = time.perf_counter()
    buf = io.StringIO()
    np.savetxt(buf, mat, fmt="%.17g", delimiter=",", header=",".join(cols), comments="")
    cell = lambda v: r"(?<=[,\n])" + re.escape(v) + r"(?=[,\n])"
    text = re.sub(cell("1e+308"), "NA", re.sub(cell("-1e+308"), "", "\n" + buf.getvalue()))[1:]
    atomic_write_text(path, text)
    walls["write_csv"] = time.perf_counter() - t0
    mat[r_idx, c_idx] = np.nan
    planted = {c: mat[:, j] for j, c in enumerate(cols)}
    t0 = time.perf_counter()
    nat = dp.load_raw_csv(path)
    walls["read_native"] = time.perf_counter() - t0
    native_available = native.native_available
    native.native_available = lambda: False
    try:
        t0 = time.perf_counter()
        py = dp.load_raw_csv(path)
        walls["read_numpy"] = time.perf_counter() - t0
    finally:
        native.native_available = native_available
    if sorted(nat) != sorted(py) or not all(
            np.array_equal(nat[c], py[c], equal_nan=True) for c in nat):
        fails.append("read_csv_native differs from the NumPy reader")
    if not all(np.array_equal(nat[c], planted[c], equal_nan=True) for c in cols):
        fails.append("the CSV did not read back as written")
    rng_checks = {}
    size = min(PrepConfig().n_obs, POOL_ROWS)   # the notebook's 50,000 of 120,000
    for kind in ("rounding", "rejection"):
        t0 = time.perf_counter()
        a = native.NativeRCompatRNG(1991, kind).sample_n_rows(POOL_ROWS, size)
        t1 = time.perf_counter()
        b = RCompatRNG(1991, kind).sample_n_rows(POOL_ROWS, size)
        t2 = time.perf_counter()
        rng_checks[kind] = {"equal": bool(np.array_equal(a, b)), "native_s": t1 - t0,
                            "python_s": t2 - t1}
        if not rng_checks[kind]["equal"]:
            fails.append(f"native sample_n_rows ({kind}) != Python")
    cfg = PrepConfig()
    t0 = time.perf_counter()
    csv_frame, csv_drop = inject_bias(prepare_dataset(dp.load_raw_csv(path), cfg, device="cuda"),
                                      cfg)
    walls["csv_to_frame"] = time.perf_counter() - t0
    mem_frame, mem_drop = inject_bias(prepare_dataset(planted, cfg, device="cuda"), cfg)
    if not (np.array_equal(csv_drop, mem_drop) and torch.equal(csv_frame.x, mem_frame.x)
            and torch.equal(csv_frame.w, mem_frame.w) and torch.equal(csv_frame.y, mem_frame.y)):
        fails.append("the CSV path's frame differs from the in-memory path's")
    emit({"phase": "path_native", "nvidia_smi": smi, "native_status": status,
          "csv_rows": mat.shape[0], "csv_cols": mat.shape[1], "planted_na_blank": NATIVE_PLANTED,
          "csv_bytes": os.path.getsize(path), "frame_rows": csv_frame.n,
          "dropped": int(len(csv_drop)), "rng": rng_checks, "walls_s": walls})
    if fails:
        raise AssertionError("path_native: " + "; ".join(fails))


STATIC_TREES, STATIC_REPLAYS, STATIC_BUCKETS = 16, 50, (1, 256)
PKG_DIR = os.path.join(REPO, "ate_replication_causalml_torch")
SYNC_WARNING = "synchronizing CUDA operation"


@contextlib.contextmanager
def sync_sites(sites: dict):
    """``torch.cuda.set_sync_debug_mode("warn")`` for the block: each
    synchronizing call adds one to ``sites[file:line]`` of its nearest
    frame inside the port's package (``<outside>`` when none is)."""
    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return
        f, where = sys._getframe(1), "<outside>"
        while f is not None:
            if f.f_code.co_filename.startswith(PKG_DIR + os.sep):
                rel = os.path.relpath(f.f_code.co_filename, REPO).replace(os.sep, "/")
                where = f"{rel}:{f.f_lineno}"
                break
            f = f.f_back
        sites[where] = sites.get(where, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")


def static_sections(frame_mod) -> tuple[dict, dict]:
    """The hot sections under the sync report: a 16-tree depth-9
    classifier forest, a 16-tree causal-forest group, one
    ``predict_cate`` and ``STATIC_REPLAYS`` warmed replays a bucket.
    Returns ``(sites by section, walls)``."""
    by_section: dict = {}
    walls: dict = {}
    x, w = frame_mod.x, frame_mod.w
    key = rnd.key(19, device="cuda")
    wt = (w - w.mean()).contiguous()
    yt = (frame_mod.y - frame_mod.y.mean()).contiguous()
    host_x = x.cpu().numpy()
    sync()
    sections = (
        ("classifier", lambda: fo.fit_forest_classifier(x, w, key, n_trees=STATIC_TREES,
                                                        depth=DEPTH)),
        ("causal_group", lambda: cf.grow_causal_forest(x, wt, yt, key, n_trees=STATIC_TREES,
                                                       depth=CF_DEPTH)),
    )
    out: dict = {}
    for name, fn in sections:
        sites: dict = {}
        t0 = time.perf_counter()
        with sync_sites(sites):
            out[name] = fn()
        sync()
        walls[name] = time.perf_counter() - t0
        by_section[name] = sites
    forest = out["causal_group"]
    sites = {}
    t0 = time.perf_counter()
    with sync_sites(sites):
        cf.predict_cate(forest, x)
    sync()
    walls["predict_cate"] = time.perf_counter() - t0
    by_section["predict_cate"] = sites
    for b in STATIC_BUCKETS:
        warm = cf.lower_predict_cate(forest, b)
        sites = {}
        t0 = time.perf_counter()
        with sync_sites(sites):
            for i in range(STATIC_REPLAYS):
                start = (i * b) % (host_x.shape[0] - b + 1)
                warm(forest, host_x[start:start + b])
        sync()
        walls[f"replay_{b}"] = time.perf_counter() - t0
        by_section[f"replay_{b}"] = sites
    return by_section, walls


STATIC_OUT = os.path.join(REPO, "build", "chip_smoke_static")
STATIC_BUDGET_S = 20.0
STATIC_LINT_PATHS = ("ate_replication_causalml_torch", "chip_smoke.py")
STATIC_KERNELS = ("hist", "hist_partition", "node_sums", "route_advance", "leaf_record",
                  "traverse")


def phase_path_static(frame_mod, smi: str) -> dict:
    """The port's static analysis against the card (docstring, 11n)."""
    from ate_replication_causalml_torch.analysis.rules import classify_sync_sites

    t_start = time.perf_counter()
    shutil.rmtree(STATIC_OUT, ignore_errors=True)
    os.makedirs(STATIC_OUT)
    cache = os.path.join(STATIC_OUT, "cache")
    env_ = dict(os.environ, PYTHON=sys.executable, TORCH_GRAFTLINT_CACHE=cache)
    # (a) the gate, cold, in a subprocess beside (b).
    gate = subprocess.Popen(["bash", os.path.join(REPO, "scripts", "torch_check_static.sh")],
                            cwd=REPO, env=env_, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    # (b) the hot sections under the card's sync report.
    reset_counts()
    by_section, walls = static_sections(frame_mod)
    counts = read_counts()
    try:
        gate_out, _ = gate.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        gate.kill()
        gate.communicate()
        raise AssertionError("path_static: the gate did not finish in 300 s") from None
    walls["gate"] = time.perf_counter() - t_start
    scripts_ = sorted(os.path.join("scripts", f) for f in os.listdir(os.path.join(REPO, "scripts"))
                      if f.startswith("torch_") and f.endswith(".py"))
    report = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_graftlint.py"), *STATIC_LINT_PATHS,
         *scripts_, "--format", "json", "--cache", cache],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    lint = json.loads(report.stdout)
    suppressed: dict = {}
    for f in lint["suppressed"]:
        suppressed[f["rule"]] = suppressed.get(f["rule"], 0) + 1
    sites: dict = {}
    for section in by_section.values():
        for site, n in section.items():
            sites[site] = sites.get(site, 0) + n
    classified = classify_sync_sites(REPO, sites)
    # (c) the float32 pins, after every earlier path.
    tf32 = {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}
    wall = time.perf_counter() - t_start
    out = {"phase": "path_static", "nvidia_smi": smi,
           "gate": {"rc": gate.returncode, "ok": "check_static(torch): OK" in gate_out,
                    "rules": len(lint["rules"]), "files": lint["files"],
                    "findings": len(lint["findings"]), "suppressed_by_rule": suppressed},
           "sync_sites": by_section, "hot_sites": classified["hot"],
           "other_sites": classified["other"], "missed": classified["missed"],
           "tf32": tf32, "walls_s": walls, "wall_s": wall, "budget_s": STATIC_BUDGET_S,
           "launches": counts}
    emit(out)
    fails = []
    if gate.returncode != 0 or lint["findings"] or report.returncode != 0:
        fails.append(f"the gate failed (rc {gate.returncode}):\n{gate_out[-3000:]}")
    if classified["missed"]:
        fails.append(f"hot-path sync sites TGL003 does not flag: {classified['missed']}")
    if tf32 != {"matmul_allow_tf32": False, "cudnn_allow_tf32": False,
                "float32_matmul_precision": "highest"}:
        fails.append(f"the TF32 pins moved: {tf32}")
    if wall > STATIC_BUDGET_S:
        fails.append(f"the phase took {wall:.1f} s, over its {STATIC_BUDGET_S} s budget")
    if fails:
        raise AssertionError("path_static: " + "; ".join(fails))
    require_launched(counts, STATIC_KERNELS, "static")
    return counts


# path_public_surface: every name of the JAX package's public import
# surface (the package's, estimators', observability's and serving's
# __all__) resolved from the port, then the DR-RF row's propensity forest
# (its key, trees and depth) behind lower_predict_forest at the full
# panel and at one serving bucket: PUBLIC_CALLS calls each on host
# queries (the panel and its reverse; PUBLIC_BUCKET-row windows), every
# reply bit for bit the eager predict_forest on the card.
PUBLIC_MODULES = ("ate_replication_causalml_torch", "ate_replication_causalml_torch.estimators",
                  "ate_replication_causalml_torch.observability",
                  "ate_replication_causalml_torch.serving")
PUBLIC_BUCKET = 256
PUBLIC_WINDOWS = 4
PUBLIC_CALLS = 24
PUBLIC_KERNELS = ("hist", "hist_partition", "node_sums", "route_advance", "leaf_record",
                  "traverse")


def family_total(name: str, **labels) -> float:
    """The sum of one metric family's samples whose labels include
    ``labels`` (0 when the family was never created)."""
    return sum(v for lab, v in (obs.peek_labeled(name) or [])
               if all(lab.get(k) == want for k, want in labels.items()))


def phase_path_public_surface(frame_mod, smi: str) -> dict:
    """The JAX package's public surface on the port and the classifier
    forest's warmed predict (docstring, 11o)."""
    from ate_replication_causalml_torch.analysis.rules import classify_sync_sites

    t_start = time.perf_counter()
    exported = {}
    for name in PUBLIC_MODULES:
        mod = importlib.import_module(name)
        # Each name resolved: a missing one raises, a lazy one loads here.
        exported[name] = len([getattr(mod, n) for n in mod.__all__])
    leaked = [m for m in ("jax", "jaxlib", "ate_replication_causalml_tpu") if m in sys.modules]
    x, n = frame_mod.x, frame_mod.n
    host_x = x.cpu().numpy()
    windows = [host_x[s:s + PUBLIC_BUCKET]
               for s in np.linspace(0, n - PUBLIC_BUCKET, PUBLIC_WINDOWS).astype(int)]
    plan = {n: [host_x, np.ascontiguousarray(host_x[::-1])], PUBLIC_BUCKET: windows}
    sync()
    walls: dict = {}
    batches: dict = {}
    fails: list = []
    reset_counts()
    with kernel_taps() as seen:
        t0 = time.perf_counter()
        forest = fo.fit_forest_classifier(x, frame_mod.w, rnd.key(12325, device="cuda"),
                                          n_trees=DR_TREES, depth=DEPTH)
        sync()
        walls["fit"] = time.perf_counter() - t0
        warms = {}
        for batch, queries in plan.items():
            t0 = time.perf_counter()
            eager = [fo.predict_forest(forest, torch.as_tensor(q, device="cuda")) for q in queries]
            want = [(e.prob.cpu().numpy(), e.vote.cpu().numpy()) for e in eager]
            eager_s = (time.perf_counter() - t0) / len(queries)
            builds = family_total("kernel_builds_total")
            captures = family_total("graph_captures_total", kind="predict_forest")
            t0 = time.perf_counter()
            warm = fo.lower_predict_forest(forest, batch)
            sync()
            warm_s = time.perf_counter() - t0
            sites: dict = {}
            call_s, equal = [], True
            with sync_sites(sites):
                for i in range(PUBLIC_CALLS):
                    t0 = time.perf_counter()
                    got = warm(forest, queries[i % len(queries)])
                    call_s.append(time.perf_counter() - t0)
                    prob, vote = want[i % len(queries)]
                    equal &= bool(np.array_equal(got.prob, prob) and np.array_equal(got.vote, vote))
            classified = classify_sync_sites(REPO, sites)
            warms[batch] = warm
            batches[batch] = {
                "eager_s": eager_s, "warm_s": warm_s, "capture_s": warm.capture_s,
                "call_ms": {"p50": float(np.median(call_s)) * 1e3,
                            "max": float(np.max(call_s)) * 1e3},
                "calls": PUBLIC_CALLS, "queries": len(queries), "equal": equal,
                "traverse_per_replay": warm.traverse_per_replay,
                "captures": family_total("graph_captures_total", kind="predict_forest") - captures,
                "builds": family_total("kernel_builds_total") - builds,
                "sync_sites": sites, "sync_missed": classified["missed"],
                "sync_other": sorted(classified["other"])}
            if not equal:
                fails.append(f"batch {batch}: a reply differs from predict_forest")
            if warm.traverse_per_replay != 1 or batches[batch]["captures"] != 1:
                fails.append(f"batch {batch}: {warm.traverse_per_replay} traverse launches a "
                             f"replay, {batches[batch]['captures']} captures (1 and 1)")
            if batches[batch]["builds"]:
                fails.append(f"batch {batch}: kernels built after the warm-up")
            # A call's syncs: the query's copy in and the reply's read, each a
            # TGL003 site of WarmGraph._host; the replay itself adds none.
            if (classified["missed"] or classified["other"]
                    or sum(sites.values()) != 2 * PUBLIC_CALLS):
                fails.append(f"batch {batch}: sync sites {sites}, missed {classified['missed']}")
            try:
                warm(forest, queries[0][:-1])
                fails.append(f"batch {batch}: a query of {batch - 1} rows was served")
            except ValueError:
                pass
    counts = read_counts()
    # Device time of the replay alone (after the counts: timing launches
    # are no part of the path).
    for batch, warm in warms.items():
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(10):
            warm.graph.replay()
        b.record()
        sync()
        batches[batch]["replay_device_ms"] = a.elapsed_time(b) / 10
    t0 = time.perf_counter()
    taps = check_taps(seen)
    walls["taps"] = time.perf_counter() - t0
    want_rows = {"route_advance": ROW_LAUNCHES["dr_rf"]["route_advance"],
                 "leaf_record": ROW_LAUNCHES["dr_rf"]["leaf_record"],
                 "traverse": sum(len(q) + 1 + PUBLIC_CALLS for q in plan.values()),
                 "route": 0, "lookup": 0}
    got_rows = {k: counts[k] for k in want_rows}
    if got_rows != want_rows:
        fails.append(f"row kernel launches {got_rows}, derived {want_rows}")
    if leaked:
        fails.append(f"the public surface loaded {leaked}")
    missing = [k for k in ("leaf_record", "traverse") if k not in taps]
    if missing:
        fails.append(f"no tapped call of {missing}")
    emit({"phase": "path_public_surface", "nvidia_smi": smi, "exported": exported,
          "rows": n, "trees": DR_TREES, "depth": DEPTH,
          "batches": {str(k): v for k, v in batches.items()}, "kernels_held": taps,
          "walls_s": walls, "wall_s": time.perf_counter() - t_start, "launches": counts})
    if fails:
        raise AssertionError("path_public_surface: " + "; ".join(fails))
    require_launched(counts, PUBLIC_KERNELS, "public surface")
    require_unpacked(counts, "public surface")
    return counts


# path_1m: bench.py's 1M-row configuration at full width (1M rows x 21
# features, 64 bins) and cut depth: 32-tree nuisance regressors (depth 9),
# a 64-tree causal forest (depth 8), 1,000 Poisson replicates.
PATH_1M_ROWS = 1_000_000
PATH_1M_NUISANCE_TREES = 32
PATH_1M_TREES = 64
PATH_1M_BOOT = 1_000
# |ATE - 1.5| (the panel's truth, E[1 + 1[x0 > 0]]): the ATE's SE at 1M
# rows is ~0.001, so 0.05 catches gross faults only (a wrong sign, a
# residual off by its nuisance, a forest that never split).
PATH_1M_ATE_BOUND = 0.05
# The bootstrap SE against the plug-in SE of the same combination: a
# Poisson replicate is the count-weighted mean of est1 + est2 (every term
# finite here), whose SD is that plug-in SE to first order; an SD from
# 1,000 replicates carries a Monte Carlo error of about 1/sqrt(2 * 999) =
# 2.2%, so 10% is about 4.5 of those.
PATH_1M_SE_REL = 0.10
PATH_1M_BUDGET_S = 60.0
PATH_1M_CPU_PANELS = os.path.join(REPO, "build", "chip_smoke_1m_cpu_panels.pt")
PATH_1M_CPU_THREADS = 2
PATH_1M_KERNELS = ("hist", "hist_partition", "hist_shared", "hist_partition_shared",
                   "node_sums", "node_sums_shared", "route_advance", "leaf_record", "traverse",
                   "lookup")


def stage_time_script():
    """``scripts/torch_stage_time_1m.py`` as a module (the panels and the
    six stages live there, not in the package)."""
    path = os.path.join(REPO, "scripts", "torch_stage_time_1m.py")
    spec = importlib.util.spec_from_file_location("torch_stage_time_1m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def path_1m_launches() -> dict:
    """The kernels' launches of path_1m, from its configuration: each
    regressor 2 chunks of 16 trees and 9 levels, K=2 (the DR-RF split:
    widths 1, 1, 2, 4, 8, 16 dense, 32, 64, 128 partition), a node_sums
    and a leaf_record a chunk; the causal forest 4 chunks of 8 two-tree
    groups and 8 levels, K=5 (the causal split: widths 1, 1, 2, 4, 8
    dense, 16, 32, 64 partition), a node_sums_shared a chunk; traverse
    one a 32-tree predict chunk: the AIPW stage's predict, the leaf index
    and the routed predict (2 each); lookup 2 (the cached predict)."""
    reg = 2 * -(-PATH_1M_NUISANCE_TREES // fo.DEFAULT_TREE_CHUNK)
    grp = -(-PATH_1M_TREES // 2)
    causal = -(-grp // cf.DEFAULT_GROUP_CHUNK)
    pred = -(-PATH_1M_TREES // 32)
    want = {k: 0 for k in COUNTERS}
    want.update(hist=6 * reg, hist_partition=3 * reg, node_sums=reg, leaf_record=reg,
                hist_shared=5 * causal, hist_partition_shared=3 * causal,
                node_sums_shared=causal, route_advance=9 * reg + 8 * causal,
                traverse=3 * pred, lookup=pred)
    return want


def start_cpu_panels() -> subprocess.Popen:
    """A subprocess that draws both of path_1m's panels on the CPU port
    into PATH_1M_CPU_PANELS. ``main`` starts it right after the build, on
    PATH_1M_CPU_THREADS of the host's cores, so the CPU draw (~25 s on
    eight cores) runs beside the card's phases and is done when path_1m
    reads it."""
    if os.path.exists(PATH_1M_CPU_PANELS):
        os.remove(PATH_1M_CPU_PANELS)
    os.makedirs(os.path.dirname(PATH_1M_CPU_PANELS), exist_ok=True)
    code = "\n".join([
        "import importlib.util, sys, torch",
        f"sys.path.insert(0, {REPO!r})",
        f"torch.set_num_threads({PATH_1M_CPU_THREADS})",
        "spec = importlib.util.spec_from_file_location('s', "
        f"{os.path.join(REPO, 'scripts', 'torch_stage_time_1m.py')!r})",
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)",
        f"torch.save(m.draw_panels({PATH_1M_ROWS}, 'cpu'), {PATH_1M_CPU_PANELS!r})",
    ])
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    # A failure before path_1m must not leave the draw running.
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def tapped_call(name: str, b: dict):
    """(kernel, a zero-argument call of it at a tapped call's inputs) for
    timing; (None, None) for ``route_advance``, which advances its ids in
    place, and ``cd_path``."""
    if name.startswith("bin_histogram"):
        return hist_kernel_name(name, b["mode"], b["bf16"]), lambda: getattr(hist, name)(
            b["codes"], b["ids"], b["weights"], max_nodes=b["max_nodes"], n_bins=b["n_bins"],
            mode=b["mode"], packed=b["packed"], bf16=b["bf16"])
    if name.startswith("node_sums"):
        return name, lambda: getattr(hist, name)(b["ids"], b["weights"], b["num_nodes"])
    if name == "leaf_record":
        return name, lambda: tree.leaf_record(b["leaf_sums"], b["base"], b["mu"], b["node"])
    if name == "traverse":
        return name, lambda: tree.traverse(b["codes"], b["split_feat"], b["split_bin"],
                                           b["table"])
    if name == "table_lookup":
        return "lookup", lambda: tree.table_lookup(b["table"], b["ids"])
    return None, None


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return sum(_nbytes(t) for t in v) if isinstance(v, (tuple, list)) else 0


def time_taps(seen: dict) -> dict:
    """Device ms of each tapped call of a pure kernel at its inputs (a
    graph of 3 calls replayed 3 times), with the shapes that tell the
    cases apart and the bytes bound: every input tensor read once and
    the output written once over the card's memory rate; the leaf sums
    also with their ``scatter_add_`` yardstick (``library_ms``) and the
    dense route they replaced (``replaced_ms``)."""
    out: dict = {}
    for name, b in seen.values():
        kernel, fn = tapped_call(name, b)
        if fn is None:
            continue
        case = {k: (list(v.shape) if isinstance(v, torch.Tensor) else v) for k, v in b.items()
                if k in ("ids", "weights", "max_nodes", "num_nodes", "mode", "split_feat", "table")}
        nbytes = sum(_nbytes(v) for v in b.values()) + _nbytes(fn())
        bound_ms, bound_by = bound(nbytes, 0)
        row = {**case, "ms": device_ms(fn, calls=3, reps=3), "bound_ms": bound_ms,
               "bound_by": bound_by}
        if name.startswith("node_sums"):  # the yardstick and the replaced dense route
            args = (b["ids"], b["weights"], b["num_nodes"])
            row.update(library_ms=device_ms(node_sums_library(*args), calls=3, reps=3),
                       replaced_ms=device_ms(node_sums_dense(*args), calls=3, reps=3))
        out.setdefault(kernel, []).append(row)
    return out


def phase_path_1m(smi: str, cpu: subprocess.Popen) -> dict:
    """bench.py's 1M-row configuration at cut depth (docstring, 11p).
    ``cpu``: the CPU panels' subprocess (``start_cpu_panels``)."""
    st = stage_time_script()
    t_start = time.perf_counter()
    want = path_1m_launches()
    dev = torch.device("cuda")
    fails: list = []
    sync()
    reset_counts()
    with kernel_taps() as seen:
        frame = st.make(PATH_1M_ROWS, dev)
        fitted, rec = st.run(frame, PATH_1M_TREES, 1, "path_1m",
                             nuisance_trees=PATH_1M_NUISANCE_TREES)
        pst = st.Stages(dev)
        li = pst.run("leaf_index", lambda: cf.compute_leaf_index(fitted.forest, fitted.x))
        cached = pst.run("predict_cached", lambda: cf.predict_cate(
            fitted.forest, fitted.x, oob=True, leaf_index=li))
        routed = pst.run("predict_routed", lambda: cf.predict_cate(fitted.forest, fitted.x,
                                                                   oob=True))
        panel = pst.run("panel", lambda: st.make_panel(rnd.key(0, device=dev), PATH_1M_ROWS))
        tau, boot_se, plugin_se = pst.run("aipw", lambda: st.aipw_bootstrap(
            *panel, rnd.key(1, device=dev), n_boot=PATH_1M_BOOT, chunk=None))
    counts = read_counts()
    stages = {**rec["stages"], **pst.rows()}
    walls = {"path": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    taps = check_taps(seen)
    walls["taps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    device_ms_1m = time_taps(seen)
    walls["kernel_timing"] = time.perf_counter() - t0
    del seen
    # (b) exact checks.
    exact = {"cached_equals_routed": bool(torch.equal(cached.cate, routed.cate)
                                          and torch.equal(cached.variance, routed.variance))}
    ck = rnd.split(rnd.key(3, device=dev), 2)[1]
    shape = (2, PATH_1M_ROWS)
    exact["poisson_counts_equal_cpu"] = bool(torch.equal(_poisson1_counts(ck, shape).cpu(),
                                                         _poisson1_counts(ck.cpu(), shape)))
    t0 = time.perf_counter()
    try:
        cpu_out, _ = cpu.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        cpu.kill()
        cpu.communicate()
        raise AssertionError("path_1m: the CPU panels did not finish in 300 s") from None
    walls["cpu_panels_wait"] = time.perf_counter() - t0
    if cpu.returncode:
        raise AssertionError(f"path_1m: the CPU panels failed: {cpu_out[-2000:]}")
    card = {"x": frame.x, "panel_w": panel[1], "panel_y": panel[2], "make_w": frame.w,
            "make_y": frame.y}
    if not torch.equal(panel[0], frame.x):
        fails.append("the two panels' covariates differ on the card")
    differing = st.panel_differences(card, torch.load(PATH_1M_CPU_PANELS))
    os.remove(PATH_1M_CPU_PANELS)
    exact["panel_rows_differing"] = differing
    for k, v in exact.items():
        if v is False or (isinstance(v, dict) and any(v.values())):
            fails.append(f"{k}: {v}")
    # (c) sanity bounds.
    ate, se = rec["ate"], rec["se"]
    n = PATH_1M_ROWS
    sane = {"ate": ate, "se": se, "ate_bound": PATH_1M_ATE_BOUND,
            "tau": float(tau), "boot_se": float(boot_se), "plugin_se": float(plugin_se),
            "se_rel_gap": abs(float(boot_se) / float(plugin_se) - 1.0),
            "mean_cate": float(cached.cate.sum()) / n,
            "mean_var": float(cached.variance.sum()) / n,
            "li_dtype": str(li.dtype)}
    if not (math.isfinite(ate) and abs(ate - st.TRUE_ATE) <= PATH_1M_ATE_BOUND and se > 0):
        fails.append(f"ATE {ate} (SE {se}) not within {PATH_1M_ATE_BOUND} of {st.TRUE_ATE}")
    if not sane["se_rel_gap"] <= PATH_1M_SE_REL:
        fails.append(f"bootstrap SE {sane['boot_se']} vs plug-in {sane['plugin_se']}: "
                     f"{sane['se_rel_gap']:.4f} over {PATH_1M_SE_REL}")
    if not (torch.isfinite(cached.cate).all() and (cached.variance >= 0).all()):
        fails.append("the predict is not finite, or a variance is negative")
    # (a) launches and taps.
    if counts != want:
        fails.append(f"launches {counts}, derived {want}")
    missing = [k for k in PATH_1M_KERNELS if k not in taps]
    if missing:
        fails.append(f"no tapped call of {missing}")
    wall = time.perf_counter() - t_start
    walls["phase"] = wall
    if wall > PATH_1M_BUDGET_S:
        fails.append(f"the phase took {wall:.1f} s, over its {PATH_1M_BUDGET_S} s budget")
    emit({"phase": "path_1m", "nvidia_smi": smi, "rows": n, "p": st.P,
          "nuisance_trees": PATH_1M_NUISANCE_TREES, "trees": PATH_1M_TREES,
          "boot": PATH_1M_BOOT, "stages": stages, "exact": exact, "sanity": sane,
          "kernels_held": taps, "device_ms_1m": device_ms_1m, "launches": counts,
          "derived": want, "walls_s": walls,
          "wall_s": wall, "budget_s": PATH_1M_BUDGET_S})
    del fitted, frame, li, cached, routed, panel
    gc.collect()
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError("path_1m: " + "; ".join(fails))
    return counts


def drop_rows(src: str, out: str, methods) -> None:
    """A copy of the sweep directory ``src`` whose journal lacks the lines
    of ``methods``."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src, out)
    path = os.path.join(out, "results.jsonl")
    with open(path) as f:
        lines = [ln for ln in f if json.loads(ln)["method"] not in methods]
    atomic_write_text(path, "".join(lines))


def injections(out: str) -> list:
    with open(os.path.join(out, "events.jsonl")) as f:
        recs = [json.loads(ln) for ln in f.read().splitlines()[1:]]
    return [[r["attrs"]["scope"], r["attrs"]["site"]] for r in recs if r["name"] == "chaos_inject"]


def phase_path_sweep_chaos() -> None:
    """Fault injection at the full configuration, cheaply: path_sweep's
    directory copied with the journal lines of two light rows
    (``CHAOS_ROWS``) dropped, then the default (concurrent) sweep under
    ``ATE_TPU_CHAOS=CHAOS_SPEC`` with ``fail_policy="degrade"``: one
    failed row (the one the spec names), the other's journal append torn,
    every other record resumed; then a clean sequential sweep on the same
    directory: the torn line counted, the two rows recomputed bit for bit
    path_sweep's, with exactly their share of the launches
    (``CHAOS_ROWS_LAUNCHES``)."""
    seq = ROWS["sweep"]["report"]
    want = {r.method: r for r in [seq.oracle, *seq.results]}
    drop_rows(SWEEP_OUT, SWEEP_CHAOS_OUT, CHAOS_ROWS)
    config = pipeline.SweepConfig()
    obs.REGISTRY.reset()
    obs.EVENTS.clear()
    with packed_policy():
        with env("ATE_TPU_CHAOS", CHAOS_SPEC):
            faulty = rerun(config, SWEEP_CHAOS_OUT)
        injected = injections(SWEEP_CHAOS_OUT)
        obs.REGISTRY.reset()
        obs.EVENTS.clear()
        clean = rerun(config, SWEEP_CHAOS_OUT, scheduler="sequential")
    with open(os.path.join(SWEEP_CHAOS_OUT, "metrics.json")) as f:
        torn = json.load(f)["counters"]["checkpoint_torn_lines_total"]
    n_rows = len(pipeline.SWEEP_METHODS) + 1
    frep, crep = faulty["report"], clean["report"]
    emit({"phase": "path_sweep_chaos", "config": "SweepConfig()", "spec": CHAOS_SPEC,
          "rows": list(CHAOS_ROWS), "policy": f"{pack.ENV_PACK}=1",
          "faulty": {"wall_s": faulty["wall_s"], "computed": faulty["computed"],
                     "resumed": faulty["resumed"], "failures": frep.failures,
                     "injections": injected, "launches": faulty["launches"]},
          "resume": {"wall_s": clean["wall_s"], "computed": clean["computed"],
                     "resumed": clean["resumed"], "torn_lines": torn,
                     "launches": clean["launches"]}})
    fails = []
    if set(frep.failures) != {"Usual LASSO"} or (faulty["computed"], faulty["resumed"]) != (
            2, n_rows - 2):
        fails.append(f"chaos run: failures {list(frep.failures)}, computed {faulty['computed']}, "
                     f"resumed {faulty['resumed']}")
    # The two injections come from two workers: the stage fault when Usual
    # LASSO starts, the torn append when Single-equation LASSO commits. The
    # engine orders commits, not these events, and the two land within about
    # a millisecond of each other (folds:usual_lasso's fit ~11 ms against
    # folds:seq_lasso's and Single-equation's ~8 + 3 ms), so either order.
    if sorted(injected) != sorted([["stage", "Usual LASSO"],
                                   ["fs", os.path.join(SWEEP_CHAOS_OUT, "results.jsonl")]]):
        fails.append(f"injections {injected}")
    if torn.get("") != 1.0 or (clean["computed"], clean["resumed"]) != (2, n_rows - 2):
        fails.append(f"resume: torn lines {torn}, computed {clean['computed']}, "
                     f"resumed {clean['resumed']}")
    for label, rep in (("chaos run", frep), ("resume", crep)):
        fails += [f"{label}: {r.method} {r.ate!r}/{r.se!r}, path_sweep's "
                  f"{want[r.method].ate!r}/{want[r.method].se!r}"
                  for r in [rep.oracle, *rep.results]
                  if r.method not in rep.failures and not same_row(r, want[r.method])]
    share = {k: v for k, v in clean["launches"].items() if v}
    if share != CHAOS_ROWS_LAUNCHES:
        fails.append(f"resume launches {share}, the rows' share {CHAOS_ROWS_LAUNCHES}")
    half = {k: v for k, v in faulty["launches"].items() if v}
    if half != {"cd_path": 1}:
        fails.append(f"chaos run launches {half}: only the computed row's one cd_path expected")
    if fails:
        raise AssertionError("path_sweep_chaos: " + "; ".join(fails))


def phase_path_xprof() -> None:
    """``ATE_TPU_XPROF`` on the card at the MICRO sweep's configuration
    (``micro_sweep_config()``; ``SweepConfig().quick()`` before, cut for
    the script's time), last (a process that has run the profiler
    launches more slowly): a sweep without the profiler, then a copy of
    its directory with the journal lines of ``XPROF_ROWS`` dropped, rerun
    with the default scheduler and the whole-run capture. The knob must
    force the sequential sweep; the Chrome trace must hold each
    recomputed row's ``record_function`` range and launches of the port's
    kernels (``XPROF_KERNELS``); the rows must equal the sweep's without
    the profiler."""
    from ate_replication_causalml_torch.parallel.dryrun import micro_sweep_config

    config = micro_sweep_config()
    plain_out = XPROF_OUT + "_plain"
    shutil.rmtree(plain_out, ignore_errors=True)
    plain = rerun(config, plain_out, scheduler="sequential")
    drop_rows(plain_out, XPROF_OUT, XPROF_ROWS)
    prof_dir = os.path.join(XPROF_OUT, "xprof")
    logs = []
    with env("ATE_TPU_XPROF", prof_dir):
        t0 = time.perf_counter()
        rep = pipeline.run_sweep(config, outdir=XPROF_OUT, plots=False, log=logs.append)
        wall = time.perf_counter() - t0
    path = os.path.join(prof_dir, "run_sweep.trace.json")
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    ranges = [obs.sanitize_label(m) for m in XPROF_ROWS]
    kernels = {k: sum(k in n for n in names) for k in XPROF_KERNELS}
    forced = any("forcing the sequential sweep" in ln for ln in logs)
    emit({"phase": "path_xprof", "config": "micro_sweep_config()", "rows": list(XPROF_ROWS),
          "plain_wall_s": plain["wall_s"], "wall_s": wall, "forced_sequential": forced,
          "trace_bytes": os.path.getsize(path), "trace_events": len(names),
          "ranges": {r: r in names for r in ranges}, "kernel_events": kernels})
    fails = []
    if not forced or any("concurrent sweep" in ln for ln in logs):
        fails.append("ATE_TPU_XPROF did not force the sequential sweep")
    if rep.computed != len(XPROF_ROWS) or not all(r in names for r in ranges):
        fails.append(f"computed {rep.computed}; ranges in the trace {[r in names for r in ranges]}")
    if not any(kernels.values()):
        fails.append(f"no launch of {XPROF_KERNELS} in the trace")
    pr = plain["report"]
    fails += [f"{a.method}: {a.ate!r}/{a.se!r}, without the profiler {b.ate!r}/{b.se!r}"
              for a, b in zip([rep.oracle, *rep.results], [pr.oracle, *pr.results])
              if not same_row(a, b)]
    if fails:
        raise AssertionError("path_xprof: " + "; ".join(fails))


_HIST = "ate_replication_causalml_torch/csrc/hist.cu"
_LEAF = "ate_replication_causalml_torch/csrc/leaf_sums.cu"
_PART = "ate_replication_causalml_torch/csrc/hist_partition.cu"
_TPU = "ate_replication_causalml_tpu/ops/"
_ROUTE = "ate_replication_causalml_torch/csrc/route.cu"
_LOOKUP = "ate_replication_causalml_torch/csrc/lookup.cu"
SOURCES = {  # kernel -> (source, the TPU kernel it replaces, its device function)
    "hist": (_HIST, _TPU + "hist_pallas.py:243", "hist_dense"),
    "hist_partition": (_PART, _TPU + "hist_pallas.py:335", "partition_accumulate"),
    "hist_shared": (_HIST, _TPU + "hist_pallas.py:782", "hist_dense"),
    "hist_partition_shared": (_PART, _TPU + "hist_pallas.py:335", "partition_accumulate"),
    # The JAX package's node sums (a constant feature through the batched
    # kernels), on the card a kernel of their own.
    "node_sums": (_LEAF, _TPU + "hist_pallas.py:1329", "leaf_sums_kernel"),
    "node_sums_shared": (_LEAF, _TPU + "hist_pallas.py:1356", "leaf_sums_kernel"),
    "route": (_ROUTE, _TPU + "tree_pallas.py:198", "route_kernel"),
    "lookup": (_LOOKUP, _TPU + "tree_pallas.py:67", "lookup_kernel"),
    # The fused passes: the route kernel with the grower's id updates; the
    # route kernel at every level with the lookup kernel; the lookup
    # kernel with the grower's leaf values.
    "route_advance": (_ROUTE, _TPU + "tree_pallas.py:198", "route_advance_kernel"),
    "traverse": (_LOOKUP, _TPU + "tree_pallas.py:198", "traverse_kernel"),
    "leaf_record": (_LOOKUP, _TPU + "tree_pallas.py:67", "leaf_record_kernel"),
    # The pack=True branch of _hist_kernel_batched_partition (:415-445, :463-484).
    "hist_partition_packed": (_PART, _TPU + "hist_pallas.py:463", "partition_accumulate_packed"),
    "hist_partition_shared_packed": (_PART, _TPU + "hist_pallas.py:463",
                                     "partition_accumulate_packed"),
    # Its in-kernel pack matmul.
    "pack_codes": (_PART, _TPU + "hist_pallas.py:441", "pack_words"),
    # The bf16 form of each (hist_backend="pallas_bf16"): the Pallas calls
    # with in_dtype=jnp.bfloat16 of the batched (:755) and shared (:842)
    # entries.
    "hist_bf16": (_HIST, _TPU + "hist_pallas.py:755", "hist_dense"),
    "hist_partition_bf16": (_PART, _TPU + "hist_pallas.py:755", "partition_accumulate"),
    "hist_partition_packed_bf16": (_PART, _TPU + "hist_pallas.py:755",
                                   "partition_accumulate_packed"),
    "hist_shared_bf16": (_HIST, _TPU + "hist_pallas.py:842", "hist_dense"),
    "hist_partition_shared_bf16": (_PART, _TPU + "hist_pallas.py:842", "partition_accumulate"),
    "hist_partition_shared_packed_bf16": (_PART, _TPU + "hist_pallas.py:842",
                                          "partition_accumulate_packed"),
    # Not a TPU kernel: the XLA program of the coordinate descent
    # (_cd_sweeps under the λ scan and the fold vmap).
    "cd_path": ("ate_replication_causalml_torch/csrc/lasso.cu", _TPU + "lasso.py:95",
                "cd_path_kernel"),
}


# The CD kernel's recurrence bound beside the whole-dot-product order's
# chain and its byte-or-operation bound.
CHAIN_KEYS = ("bound_kind", "rate_bound_ms", "rate_bound_by", "chain_updates",
              "ns_per_chain_update", "chain_cycles_per_update", "sm_clock_mhz",
              "order_chain_ms", "delay")


def main() -> int:
    name, smi = phase_device()
    functions = phase_build()
    cpu_panels = start_cpu_panels()
    frame, frame_mod = notebook_frames("cuda")
    timing = phase_kernels(frame_mod)
    by_path = {"dr_rf": phase_path(frame, frame_mod)}
    phase_parity(frame_mod)
    by_path["causal_forest"], cf_out = phase_path_cf(frame_mod)
    by_path["path_serve"] = phase_path_serve(frame_mod, smi)
    by_path["serve_lifecycle"] = phase_path_serve_lifecycle(frame_mod, smi, by_path["causal_forest"])
    by_path["serve_fleet"] = phase_path_serve_fleet(smi)
    card_32 = phase_parity_cf(frame_mod)
    by_path["leaf_index"] = phase_path_leaf_index(card_32)
    by_path["causal_forest_packed"] = phase_path_cf_packed(frame_mod, cf_out, card_32)
    by_path["dml"] = phase_path_dml(frame_mod)
    phase_parity_dml(frame_mod)
    phase_path_ipw(frame_mod)
    by_path["lasso"] = phase_path_lasso(frame_mod)
    by_path["balance"] = phase_path_balance(frame_mod)
    by_path["sweep"] = phase_path_sweep()
    by_path["sweep_concurrent"] = phase_path_sweep_concurrent()
    phase_path_sweep_chaos()
    by_path["scenario_matrix"] = phase_path_scenario_matrix(smi)
    by_path["frontier"] = phase_path_frontier(smi)
    by_path["chaos_campaign"] = phase_path_chaos_campaign(smi)
    by_path["multi_gpu"] = phase_path_multi_gpu(smi)
    by_path["matmul_growers"], auto_fits, fitters = phase_path_matmul_growers(frame_mod, smi)
    by_path["pallas_backends"] = phase_path_pallas_backends(frame_mod, smi, auto_fits, fitters)
    by_path["rbridge"] = phase_path_rbridge(frame_mod, smi)
    phase_path_native(smi)
    by_path["static"] = phase_path_static(frame_mod, smi)
    by_path["public_surface"] = phase_path_public_surface(frame_mod, smi)
    by_path["path_1m"] = phase_path_1m(smi, cpu_panels)
    phase_stages(frame_mod)
    phase_path_xprof()
    kernels = []
    for k, (src, rep, device_fn) in SOURCES.items():
        row = timing[k]
        ptxas = [v for f, v in functions.items() if f.split("<")[0] == device_fn]
        kernels.append({"name": k, "route": "cuda", "source": src, "replaces": rep,
                        "launches": sum(c[k] for c in by_path.values()),
                        "launches_by_path": {p: c[k] for p, c in by_path.items()},
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "factor": row.get("factor"), "call_ms": row.get("call_ms"),
                        "replaced_ms": row.get("replaced_ms"),
                        "launch_floor_ms": row.get("launch_floor_ms"),
                        **{c: row[c] for c in CHAIN_KEYS if c in row},
                        "registers": max((v.get("registers", 0) for v in ptxas), default=None),
                        "spill_bytes": max((v.get("spill_bytes", 0) for v in ptxas), default=None)})
    out_dir = os.path.join(REPO, "build")
    os.makedirs(out_dir, exist_ok=True)
    RECORD["kernels"] = kernels
    RECORD["nvidia_smi"] = smi
    atomic_write_json(os.path.join(out_dir, "chip_smoke.json"), RECORD)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
