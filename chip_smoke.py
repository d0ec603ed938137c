#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100 here).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  — the card's name and power limit as nvidia-smi reports them;
               TF32 off for matmuls and convolutions, and bfloat16 GEMMs
               reduced in float32 (fp32 like the reference).
  2. build   — nvcc builds the five kernel libraries of
               `src/repro_torch/csrc/` (seven kernels: acq.cu holds the
               float and the mixed fused EI, trsv.cu L X = I and the
               general solve), one process per source, all started
               together.
 2a. acq_plans — the fused EI's tiles and plan table (`acq_plan_checks`):
               every compiled tile of csrc/acq.cu (R = 4, 8, 16) in both
               forms at the main paths' r = 64 (S = 1) and the engines'
               r = 48 (S = 16), held to the plain version (`held_ei`,
               TOL_EI), each S = 16 lane torch.equal to its one-study
               launch; the committed `acq_plans.json`'s sha256 of acq.cu
               that of the source and each entry's plan reproducing its
               digests (a stale table fails the run: run `tune_acq`
               again); each entry's own plan held to the plain version
               on 6 seeded states beside the heuristic's; the race's held
               count of every candidate beside the one-slice candidate of
               its R, which no k-split may fall below; each key's tabled
               and heuristic plans with the race's device ms.
               Every path below runs through `AcqPlanRecorder`: a line
               `{"phase": <path>, "part": "acq plans"}` gives its fused-EI
               launches by plan key and study count, and those that
               missed the table, which must be 0.
  3. kernels — each kernel against its plain PyTorch version on the card,
               on the same inputs at the main path's shapes (the factor and
               the solve also as the lag refit's batch of 18 grid
               candidates, and the fused EI on raw as well as standardized
               Levy values; the mixed gram and the mixed fused EI on the
               mixed workload's space), with the tolerance stated; times
               from CUDA events (median of 20) for the kernel, the plain
               version and, where one PyTorch call computes the same
               function, that call (timed only, never used by the port).
               The Cholesky also on a matrix that is not positive definite,
               ragged n = 1000, a batch of 3 at n = 97 and n = 1, and
               ptxas's registers and shared memory.  L X = I (the main
               path's solve, `tri_inverse_cuda`) on every one of those
               factors and on n = 1024 and the lag refit's batch: bit for
               bit the general kernel `trsv_cuda(L, I)` and held to the
               plain version; a digest of X's bits (-0 read as +0) for the
               single and the batched call, and ptxas's report for trsv.
               Both fused-EI forms also at ragged n = 1000, at n = 4096 and
               on a batch of 3 studies (held to the plain version, two
               calls torch.equal, the launch plan, ptxas's report for every
               instantiation); the mixed form's accuracy spread over
               seeds (informational); L X = I at n = 6144 through
               `trsv.tri_inverse`, past the L X = I kernel's limit, on the
               general kernel, within TOL_TRSV_RESID.  The general solve
               (`trsv_cuda`, C entry `repro_trsv`; `general_solves`) at
               r = 1 forward and transposed at n = 1024 and 4096, ragged
               n = 1000 at r = 1, a batch of 3 studies at r = 1, r = 64
               (the posterior's L^{-1} K*), B = I at n = 1024, on the lag
               refit's 18 factors and at n = 6144, and L^T Q = G at r = n
               (L X = I's VJP, n = 1024): each held to the plain
               version (or twice its float64 error), two calls torch.equal,
               CUDA-event ms beside the plain version's,
               `torch.linalg.solve_triangular`'s (timed only) and the
               bound; digests of the forward shapes cross-checked against
               `trsv_digests` (imported by path with PYTHONPATH of an
               unpacked parent's `src`, it prints the parent's digests:
               the A/B of Q's bits), and both regimes side by side at
               n = 1024 and 4096 (`regimes_by_r`, bitwise equal).  Both grams
               (`gram_checks`) at the 1024^2 Gram, the 1024 x 1 column,
               the lag refit's batch of 18 masked Grams over one state in
               one launch (Levy-5d and the mixed workload, n = 960), a
               batch of 3 studies with distinct x, n (1024, 500, 1) and
               parameters, and ragged n = 1000 against m = 7 and itself at
               d = 1 and 33: each held to its plain version, each batch
               torch.equal to its single launches, each symmetric build to
               its transpose, each masked build exactly K padded by the
               identity; digests of the Gram, the column and the batch
               cross-checked against `gram_digests` (the loop of single
               builds, through entry points the parent tree also has:
               imported by path with PYTHONPATH of an unpacked parent's
               `src`, it prints the parent's digests for an A/B of K's
               bits); times beside the bound, the plain version and, for
               the batch, `grid_grams`' loop of 18 (`gram_loop_ms` times
               that loop alone, on either tree).
  4. main    — `run_bo` on Levy-5d at full width (n_max = 1024, 64 restarts
               x 25 ascent steps, 960 seed points, 48 rounds, lag 32).  Every
               launch counter is set to 0 just before and read just after;
               each kernel must have run the number of times the path
               implies (`expected_counts`: 51 grams, 3 factors, 3 L X = I,
               1248 fused EI, no general solve).  Suggestions in bounds, best value finite, at least
               one suggestion with a positive EI (the count of those with
               EI 0 is printed), and the final factor and inverse
               consistent with the Gram.
  5. mixed   — `run_bo(desc=...)` on the repository's mixed workload (the
               space and objective of benchmarks/bench_mixed.py: Levy over
               two floats and an Int, plus a 3-way Categorical offset;
               encoded width 6) at the same full width, with its own exact
               launch counts (the float Matérn gram and float EI 0), every
               suggestion on the feasible lattice, and a recorded ascent
               showing which coordinates the gradient steps move.
  6. append  — the paper's Alg. 3 by triangular solve (Fig. 5's pair) on
               the Levy-5d state at n_max = 1024: `ops.padded_cholesky` at
               n = 896, 128 rows one at a time through
               `core/cholesky.lazy_append_block` (one general solve a row),
               then `gp.dense_posterior` on all 1024 points at 64 query
               points.  Launches exactly: general solve 131 (128 appends,
               3 posterior solves), Cholesky 2, the rest 0 (L X = I
               included).  The final factor is held to the refactor of the
               whole padded Gram and to the same appends through the plain
               solve, the posterior to the plain versions and to
               `gp.posterior` on the lazy state; the line prints one
               append's ms beside one refactor's (`padded_cholesky` and
               `padded_tri_inverse` at n = 1024).
  7. engine  — the stacked `StudyEngine` (`hpo/engine.py`) at full width,
               twice: 16 Levy-5d studies, and 8 studies of the mixed
               workload beside 8 Levy-6d studies (one slot swapped to the
               other layout halfway by `reset_slot` + `set_desc`).  n_max
               = 1024, 48 restarts x 20 steps, lag 32; study s prefilled
               through `absorb_round` to 960 - 8 s points, then 32
               `advance` rounds with every study flagged.  Counters set to
               0 before the prefill and read after the last round; each
               round exactly 21 fused EI and one column gram (plus two
               masked grams, factors and L X = I a due lag event), the
               general solve 0; every mixed suggestion on its lattice.
               Then (uncounted): the mixed kernels with (16, 6) per-study
               masks held to their plain versions and each lane bit for
               bit to a launch under its own masks (`stacked_mask_checks`),
               one round against the single-study path on every lane
               (`lane_parity`, with the 16 single-study steps timed beside
               the batched round, the count of lanes that left for
               another basin, at most a quarter; and `ei_at_seeds`: every
               lane's fused EI and gradient at its restart seeds from the
               S = 16 launch torch.equal to an S = 1 launch on the same
               operands, the two launch plans with the same k-split; and
               the batched suggest's hoisted operands, A = li^T li, the
               active mask and the shift, computed lane by lane
               (`acquisition.hoist`), torch.equal to each lane's own
               single-study hoist; `bits` names the lanes whose
               suggestion, append or ascent differ from the single-study
               path's bits), one round with half the studies unflagged
               (their every bit kept) and one round under
               `torch.cuda.set_sync_debug_mode("error")`.
 7a. pool    — the port's `StudyPool` (`hpo/pool.py`) over the engine
               phases' studies (phases `pool` and `pool_mixed`), a pool
               and its twin, n_max = 1024, lag 32, 48 x 20, seed 0, a
               checkpoint directory written only by explicit calls.  Each
               prefilled through one `absorb_many` of every study's points
               shuffled (study s to 960 - 8 s), then 32 `advance_round`
               rounds telling the last round's suggestions in a shuffled
               order, each held to the engine phase's launches; the twin
               runs the same rounds as `advance_round_begin` + `finish()`
               (one begin without a lag event under
               `set_sync_debug_mode("error")`), with every suggestion and,
               at the end, every leaf of every lane torch.equal.
               `advance_round` ms beside the engine phase's `advance` ms.
 7b. mesh    — the (study x restart) mesh (`hpo/mesh.py`): first the
               restart shard's launch of each fused-EI form (R = 48 split
               2 and 4 ways with `plan_rows=48`, at S = 16 and 1, on the
               engine phases' states): held to the plain version, its rows
               the unsharded launch's bits (digests), launches exact, and
               its ms beside the unsharded launch's.  Then `StudyPool`s at
               "none", "2x1", "1x2" and "2x2" on `["cuda:0"] * k`, float
               and mixed, each from a copy of its engine phase's state,
               through one suggest round and absorbing `advance_round`s
               past the first lag event: every suggestion and every leaf
               bit for bit "none"'s, launches exact (21 fused EI a cell
               and one column gram a study shard a round), and each spec's
               `advance_round` ms beside the card's name and power limit.
  8. profile — four more rounds of each path under torch.profiler: device
               busy share and device time by kernel; then one Cholesky
               call at n = 1024 and one on the lag refit's batch, each of
               which must be one device kernel (beside the wrapper's copy
               and the scratch memset), with the launch plan; one L X = I
               call of each shape, each exactly one device kernel; one
               lag event on the Levy-5d state by device time per kernel,
               with the gram's device ms, the event's device kernels, its
               span and busy time; the lag refit's batch of 18 masked
               Grams, the refactor's masked Gram and the append's column
               of each form, each exactly one device kernel; one
               call of each fused-EI form, each exactly one device
               kernel, whose device ms go beside its event ms; one call of
               the general solve at each of its shapes, each exactly one
               device kernel; one more round of each engine by device
               time per kernel, with its busy share; both fused-EI forms
               at S = 16 and S = 1 (r = 48, n = 1024) by device time and
               events a launch, beside the plain version and the bound
               (`ei_engine_times`); each table key's tabled and heuristic
               plans by device ms at S = 1 and 16 (`acq_plan_times`); one
               more `advance_round` of each pool
               (busy share, device time by kernel; the twin then replays
               it); then, at the start of each neural phase,
               one nb_suggest (busy share) and the device kernels of one
               refit step (`profile_neural`); last, one ask_q(8) of each
               engine by device time per kernel (just before its fantasy
               phase).
               Nothing is profiled before the paths' timings are taken.
 8a. neural — the neural-basis tier (`promote_slot`, `nb_*`) on each
               engine the engine phases leave (phases `neural` and
               `neural_mixed`, after the profile checks and before the
               fantasy phases, which keep the escalated slot unflagged):
               the fullest slot (the mixed workload's layout in the mixed
               engine) filled to n_max with real tells, an ask_q(1) that
               must raise StudySaturatedError and leave the lane
               torch.equal, the promotion (ledger 1024, cap 2048,
               `NeuralConfig()`, params from a seeded generator), then 40
               rounds of one `advance` of the GP slots (the escalated
               slot's flag off; exactly the engine phase's launches) and
               one `nb_suggest` + `nb_absorb` (no hand kernel; the 32nd
               absorb refits).  Held: the frozen GP lane torch.equal to
               its copy from before the promotion; the card's state (chol,
               w_y, w_c, s2, the posterior at 64 probes) within twice the
               worst error of four CPU float32 replays (each GEMM summed
               in 1, 2, 4 and 8 chunks) against a CPU float64 replay of
               the same absorbs, or within the head's float32
               perturbation bound (`held_f64_rule`), and the same replay
               on the card with every GEMM operand rounded to TF32 outside
               that rule (the negative control); nb_ask_q(8) +
               nb_rollback, nb_grow at n == cap and the JSON round trip
               bit for bit.  Host-clock times (median of 3): nb_suggest at
               n = 1024 and 4096 beside the GP's routed suggest at 1024,
               nb_absorb, nb_refit at 1024 and 4096, promote_slot,
               nb_ask_q(8), nb_refantasize(7).
  9. fantasy — the q-fantasy protocol (`ask_q`, `truncate_slot`,
               `refantasize`) on each engine the engine phases leave
               (phases `fantasy` and `fantasy_mixed`, last: run before the
               profile checks, they left torch.profiler recording nothing
               in a later session), against a twin engine loaded from its
               `study_state` snapshots: every engine call held to its exact
               launches (`fantasy_counts`: 21 fused EI and two grams a
               suggestion of an ask, one gram with the pessimistic liar,
               two a replay, none a truncate); an ask_q(8) rolled back
               alone, the pessimistic liar, an ask past capacity
               (GPCapacityError) and an ask_q(8) under
               `set_sync_debug_mode("error")`, each leaving every lane
               torch.equal to the twin's; then 4 advance rounds with every
               study flagged, slots 4 and 12 rolled back before each and
               replayed after, their tells pending points out of order, a
               foreign tell, a release and one more ask_q(2), and a drain:
               every leaf of every lane then torch.equal to the twin's,
               alpha included.  Each ask's points distinct and on the
               slot's lattice.  Uncounted: the path's gram shapes (m = 1,
               8, 9, 31, 32 against n_max = 1024) held to the plain
               version and, at the slot's own params, to the expansion's
               float32 bound (`expansion_bound`), and host-clock times
               (median of 3): ask_q at q = 1, 8, 32 beside q times one
               routed suggest, truncate_slot, refantasize at p = 7 and 31.
 10. pool protocol — last, on each pool pair (`pool_protocol`): ask_q(8)
               on slots 4 and 12 (launches held), the tells out of order,
               a foreign tell, a release and a drain through
               `absorb_many`, against the twin, which takes the same real
               tells, never fantasizes and burns the asks' draws: every
               leaf of every lane torch.equal, alpha included; then a
               `checkpoint()` with slot 4's ask_q(8) out (the manifest's
               names the reference's, in order), a fresh pool's
               `restore()` (every leaf torch.equal to the twin's, the
               ledgers the pool's), one more identical `advance_round` on
               both (suggestions and leaves equal), and slot 7 through
               `export_study` / `import_study` bit for bit; host-clock ms
               of the checkpoint (with its bytes) and the restore.  The
               float pair adds a `TrialScheduler` on one Levy-5d study
               prefilled to 960 through `absorb_many`, then `run(objective,
               budget=16)` with parallel 4: no seed trial, every suggest
               exactly 21 fused EI, every absorb one column gram plus a
               due lag event's; its suggest and absorb ms.
 11. gateway — last (`gateway_path`): the float pool's 16 studies exported
               and written as `_evict` writes them, adopted
               (`require_snapshot=True`) by gateways of 16 slots at the
               pool phases' configuration beside 8 fresh studies: 24
               logical studies, no prefill of its own.  (1) A scripted
               trace (16 rounds of 5 asks, every third round's first a
               q = 4 ask, tells two rounds later) on A (`tick_begin`,
               pipelined) and B (`tick()`): every `advance_round_begin`
               and `ask_q` held to its launches (`begin_counts`,
               `fantasy_counts`) and every tick to their sum; streams,
               registries, summaries and every lane equal; A overlapped
               (printed: ticks where round t+1's event was still pending
               after `finish(t)`).  (2) One `_tick_stage` under
               `set_sync_debug_mode("error")`.  (3) One study evicted and
               restored on demand, its leaves and next suggestion those
               of B, where it stayed.  (4) `checkpoint()` restored by a
               fresh gateway: registry and lanes equal, one more tick
               equal.  (5) 24 asyncio clients (6 asks; q = 4 for clients
               4 and 12; client 0 on until promoted past n_max, then 4
               more) on a pipelined, then on a serial gateway (D, E:
               one run of each): suggestions in the unit cube, every tell
               absorbed; suggestions a second,
               ticks, coalesce width, p50 / p95 tick ms, evictions and
               restores, and the eviction, restore and checkpoint ms.
 12. federation — after the gateway (`federation_path`), over its 24
               logical studies: A, a `FederatedGateway` of 2 shards of 8
               slots in this process, B, its 16-slot single-pool twin, and
               C, a `TransportFederation` of 2 shard worker processes on
               the same card (heartbeats every 0.5 s, the reference's 1.0 s
               deadline and 3 misses).  A and C are seeded through the
               federation's recovery path: each study's snapshot in its
               ring shard's store, a registry epoch with fallback records,
               then `restore()` / `start()`.  (1) The scripted trace on A
               and B (each round's tells absorbed by a tick of their own
               before its asks), every pool call of every shard and every
               tick held to its launches, one study migrated and
               `rebalance()` mid-trace: every suggestion, state digest,
               ledger, n_obs / best_value and lifetime counter of A bit for
               bit B's.  (2) A's `checkpoint()` (ms, bytes), a round told
               but not committed, `kill_shard(0)`, a survivor's round,
               `revive_shard(0)`: committed observations kept, the lost
               round re-derived bit for bit, nothing replayed.  (3) C: the
               trace over RPC with the same migration (streams, moves,
               n_obs / best_value A's, each resident study's digest over
               RPC A's), then a SIGKILL of worker 0 and its revival under
               the same law by C's warm standby worker (`revive_s`, the
               revived worker's start stages in `revive_start`); each
               worker's spawn-to-endpoint seconds and slowest ping.
               (4) The 24 asyncio clients on A, then on C, each fresh
               from the records (one run of each: the phase's depth cut
               to keep the script in its time):
               suggestions a second, p50 / p95 tick ms by shard, beside
               the gateway phase's.  `federation` counts A's own
               launches (B's taken out, after the trace's launches are
               held to A's and B's pool calls); `federation_workers`,
               C's workers', which each worker writes as it exits (the
               SIGKILLed lifetime writes none).
 13. lm      — the language-model trainer (`lm_path`): tiny-lm's full
               config (4 layers, d_model 256, 8 / 4 heads, d_ff 1024, vocab
               4096) at examples/train_e2e.py's batch 8 x 256, 20 AdamW
               steps through `repro_torch.launch.train.run` with
               checkpoints at 10 and 20, then a second run from a copy of
               the step-10 checkpoint to 20.  Held: the first step's loss
               to the same loss on the CPU from the card's parameters and
               batch converted by tree path (TOL_LM_FIRST), a falling loss,
               the resumed losses to the uninterrupted run's
               (TOL_LM_RESUME; `bitwise` printed), no hand-written kernel
               launched.  Printed: the parameter count, the losses, median
               step ms after the first step, tokens a second, peak memory.
 14. nn_hpo  — benchmarks/bench_nn_hpo.py's objective at tiny-lm's full
               width (`nn_hpo_path`): each trial 25 SGD-momentum steps at
               8 x 64 with the trial's lr / weight decay / momentum as 0-d
               tensors, eval accuracy on a held-out step, under the port's
               `run_bo` over RESNET_SPACE's unit cube (lazy, 4 seeds,
               budget 12).  Held: accuracies finite in [0, 1], suggestions
               in the cube, the Matérn gram, the Cholesky and the fused EI
               launched.  Printed: mean trial s beside mean GP (absorb) s
               and suggest s, their shares, the best accuracy and its
               trajectory.
 15. lm_moe  — the routed feed-forward at full width (`wide_lm_path`):
               granite-moe-3b-a800m (d_model 1536, 24 / 8 heads, 40 experts
               in 48-row tables, top 8, d_ff 512, vocab 49155 padded to
               49408), depth cut to 2 layers (`wide_config`, listed as
               `reduced`), 10 AdamW steps at 8 x 256 through
               `training/steps.py`, bfloat16 activations over float32
               masters.  Held: the first loss to the same loss on the CPU
               from the card's parameters and batch converted by tree path
               (TOL_WIDE_FIRST), a falling loss, a finite aux, no hand-
               written kernel launched.  Printed: the parameter count, the
               losses and aux, the share of layer 0's (token, choice)
               routing decisions that differ between card and CPU, median
               step ms after the first, tokens a second, the trainer's own
               peak memory.  Then `launch.train.run` on qwen3-moe-30b-a3b's
               reduced config, 10 steps checkpointed at 5, and a run from a
               copy of the step-5 checkpoint: its losses bit for bit.
 16. lm_mla  — minicpm3-4b's multi-head latent attention at full width
               (d_model 2560, 40 heads, q_lora 768, kv_lora 256, nope / rope
               / v 64 / 32 / 64, d_ff 6400, vocab 73448 padded to 73472),
               2 layers, held and printed as lm_moe (no routing, no
               launcher run).
Then `recurrence` (`recurrence_check`): the chunked scans against their
per-token recurrences on the card in float32 at the full widths, one
sequence of 512 steps in chunks of 256: zamba2's SSD (64 heads of 64,
state 64, one group) from an initial state, and xlstm's mLSTM (4 heads of
512); outputs and final states held to TOL_RECURRENCE.  Then the
recurrent and encoder families at full width, each held and printed as
lm_mla (`wide_lm_path`, 10 AdamW steps at batch 8, bfloat16 over float32
masters; the CPU checks the loss of the batch's first sequence, beside
the card's loss of the same sequence):
 17. lm_frames — hubert-xlarge (d_model 1280, 16 heads, d_ff 5120,
               bidirectional, frames projected by `frame_proj` with
               sinusoidal positions, vocab 504 padded to 512), 2 of 48
               layers, 8 x 256 frames.
 18. lm_mamba  — zamba2-1.2b (d_model 2048, d_inner 4096, 64 SSD heads of
               64, state 64, chunk 256, the shared attention block of 32
               heads and d_ff 8192), 12 of 38 layers (the shared block
               fires after layers 5 and 11), 8 x 512 tokens (two chunks).
 19. lm_mlstm  — xlstm-1.3b (d_model 2048, 4 heads of 512, pf 1.0, chunk
               256, vocab 50304), 2 of 48 layers, 8 x 512 tokens.
 20. lm_serve  — the serving path at full width (`lm_serve_path`,
               SERVE_PARTS): gemma3-4b at 6 of 34 layers (5 local of
               window 1024, 1 global; batch 2, prompt 1024, 1024 float32
               decode steps, 64 timed bfloat16), granite-moe-3b-a800m and
               minicpm3-4b at 2 layers, zamba2-1.2b at 12, xlstm-1.3b at 2
               (batch 8, prompt 512, 32 steps), float32 masters from
               `init_params`, MoE dropless (`dropless`).  (a) float32:
               prefill, then
               teacher-forced decode steps, each logit row held to the
               card's full forward at its position and the cache after
               the steps to a prefill over all the tokens (TOL_SERVE; the
               recurrent states TOL_RECURRENCE, the mLSTM's C and n up to
               e^m); a token whose routing differs between the two forms
               is named and its row held only before it.  (b) the
               config's own dtype, timed: prefill ms, decode ms (median
               after 2 warm-up steps), tokens a second, cache bytes, peak
               memory above the base, the argmax agreement with the same
               dtype's forward, every logit finite, and the weight bytes a
               step reads beside their time at the memory rate; one more
               step under `set_sync_debug_mode("error")`.  No hand-written
               kernel launched.
 21. launch    — the launch layer (`launch_path`): which collectives gloo
               takes on CUDA tensors of two ranks on one card
               (`gloo_probe`); (a) qwen3-moe-30b-a3b at full width, 2 of
               48 layers, float32 activations, 3 SGD-momentum steps at
               8 x 256 on one device; (b) the same steps on two rank
               processes on cuda:0 (a 1x2 mesh, gloo,
               `mesh.shared_card_collectives`, 64 experts a rank) through
               the sharded step: the expert-parallel count above 0 on
               each rank, losses within 1e-2 and parameters within 2e-2
               of (a)'s; (c) `torch.distributed.run` of the launcher at
               1x2 on qwen3's reduced config, 10 steps checkpointed at 5,
               resumed at 1x2 (the printed losses equal) and at 1x1
               (within 1e-2 relative).  No hand-written kernel launched.
 22. examples  — the port's examples (`examples_path`, EXAMPLE_RUNS), each
               `main(argv)` in process on the card at the JAX example's
               documented sizes: quickstart (lazy, naive, lag 32),
               hpo_service with the categorical tenant and its resume,
               parallel_hpo with faults and its resume, serve (12 studies
               on 4 slots, q 4, a resume), serve_cluster with shard 0
               killed and revived (at its defaults, and at 0.3 s with
               trials of 0.05 s, while every client serves), train_e2e
               (100m preset 50 steps, resumed to 60; granite-3-2b reduced 20 steps).  Each run
               starts from PyTorch's default precision settings and must
               leave the reference's (the example set them), and is held
               to its contract (`example_contract`); the six TPU kernels'
               counterparts must launch across the in-process runs, and
               none of their fused-EI launches may miss the plan table
               (the phase runs through `AcqPlanRecorder`, as the paths
               do).  serve_cluster's line carries its workers' start
               stages (`worker_starts`; the revived shard's worker is the
               standby, `standby_s`), the kill-to-reconciled seconds
               (`revive_s`) and each client's failover retries, at most
               the reference's 50.  One line a run with its seconds and
               totals.
Then one AdamW step each of the lm phase, of lm_moe's and of lm_mamba's
profiled (`lm_step_profile`: device kernels, span, busy, host ms, device
ms by kind of kernel and the top 15 kernels), and one decode step each of
lm_serve's gemma3 and zamba2 (`serve_step_profile`).  Then the
`{"kernels": [...]}` line (seven kernels: L X = I and the general solve,
two C entries of `csrc/trsv.cu`, count apart; launches per path: main,
mixed, append, engine, engine_mixed, pool, pool_mixed, neural,
neural_mixed, fantasy, fantasy_mixed, gateway, federation,
federation_workers, lm, nn_hpo, lm_moe, lm_mla, lm_frames, lm_mamba,
lm_mlstm, lm_serve, launch, examples), the nvidia-smi line and, last,
`{"ok": true, "device": {...}}`.  Any failure raises and exits non-zero;
without CUDA, or without the repository beside it, the script fails
before printing a result.

    python3 chip_smoke.py --digests [SRC]

prints only the digests of the grams', the fused EI's (shared masks) and
L X = I's bits, and the fused EI's times at S = 16 and 1 (r = 48), built
from the `repro_torch` under SRC (this checkout's `src` by default): run it
on an unpacked parent's `src` and on this one for an A/B (with
`REPRO_ACQ_AUTOTUNE=off` this tree's fused EI takes the heuristic plan).

    python3 chip_smoke.py --acq-keys KEYS.json

runs the whole script, writing every path's fused-EI launches by plan
key and study count to KEYS.json after each path, with table misses
printed, not fatal, and the table's digests unchecked: the recording run
whose traffic `python -m repro_torch.kernels.tune_acq --keys KEYS.json`
races on.  Run it under `REPRO_ACQ_AUTOTUNE=off`, so that the recorded
traffic does not depend on the table it replaces.
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import hashlib
import inspect
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Peak rates for the least times: H100 SXM fp32 outside the tensor cores and
# HBM3 bandwidth, NVIDIA's data sheet, at the full 700 W limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
REPS = 20

DIM = 5
MIXED_DIM = 6             # x1, x2, k, then the one-hot branch block
N_MAX = 1024
N_SEED = 960
ITERATIONS = 48
LAG = 32
RHO0, SIGMA2, NOISE2 = 0.25, 1.0, 1e-6
GRID_RHO = (0.05, 0.1, 0.2, 0.4, 0.8, 1.6)     # gp.refit_params' grid
GRID_SIGMA2 = (0.25, 1.0, 4.0)
APPEND_ROWS = 128         # the append phase: factor at n_max - 128, then
APPEND_QUERIES = 64       # absorb 128 rows and query the posterior at 64
TRSV_SEED = 18            # inputs of the general solve's shapes
# The mixed workload's objective (benchmarks/bench_mixed.py:36-62): -Levy
# over (x1, x2, k) plus an offset per branch; optimum at k = 1, branch b.
BRANCH_OFFSET = {"a": -4.0, "b": 0.0, "c": -2.0}

# Tolerances against the plain version on the same inputs.
TOL_MATERN = dict(rtol=1e-5, atol=1e-6)    # elementwise, K <= sigma2 = 1
TOL_CHOL_RECON = 1e-5     # ||L L^T - K||_max / ||K||_max
TOL_CHOL_PLAIN = 1e-4     # max |L - L_plain| / max |L_plain|
TOL_TRSV_RESID = 1e-4     # ||L X - I||_max; 1.7e-6 measured on an H100
TOL_TRSV_PLAIN = 1e-4     # max |X - X_plain| / max |X_plain|
TOL_EI = dict(rtol=1e-4, atol=1e-5)        # tests/test_fused_acq.py:65,
#                                            see held_to_plain
TOL_POSTERIOR = dict(rtol=1e-4, atol=1e-5)  # mean and variance, O(1) values
# The lag refit's batch holds Grams that float32 cannot factor accurately
# (long length scales, noise 1e-6): there each batched factor and solve
# must be as good as the plain version's (within twice its residual) or
# within the tolerance above, and each must equal its own single launch.


STARTED = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries `at_s`, the script's seconds
    so far when it was printed (where the run's time goes)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - STARTED}
    print(json.dumps(obj), flush=True)


def precision_flags() -> dict:
    """The three settings `gp.reference_precision` sets, as they stand."""
    return {
        "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul.allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}


def reset_counts() -> None:
    """Set every launch counter to 0 (the mixed fused EI and the general
    solve count apart)."""
    from repro_torch.kernels import KERNEL_MODULES, acq, trsv
    for mod in KERNEL_MODULES:
        mod.LAUNCHES = 0
    acq.LAUNCHES_MIXED = 0
    trsv.LAUNCHES_GENERAL = 0


def read_counts() -> dict:
    """Launches by C entry: `trsv` is L X = I, `trsv_general` the general
    solve."""
    from repro_torch.kernels import KERNEL_MODULES, acq, trsv
    counts = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
              for mod in KERNEL_MODULES}
    counts["acq_mixed"] = acq.LAUNCHES_MIXED
    counts["trsv_general"] = trsv.LAUNCHES_GENERAL
    return counts


def spd(rng: np.random.Generator, size: int, batch=()) -> np.ndarray:
    """Well-conditioned SPD matrices, float32 (tests/_torch_port.py:40)."""
    a = rng.standard_normal((*batch, size, size)).astype(np.float32)
    eye = np.eye(size, dtype=np.float32)
    return (a @ np.swapaxes(a, -1, -2) / size + 2.0 * eye).astype(np.float32)


def non_pd_matrix() -> np.ndarray:
    """The 48 x 48 matrix of tests/test_torch_kernels.py:123 that is not
    positive definite: an exact zero pivot at 31 and a negative one at 32."""
    rng = np.random.default_rng(5)
    k = np.zeros((48, 48), np.float32)
    k[:30, :30] = spd(rng, 30)
    k[30:32, 30:32] = [[4.0, 2.0], [2.0, 1.0]]
    k[32, 32] = -1.0
    k[33:, 33:] = spd(rng, 15)
    return k


def mixed_space():
    """The mixed workload's search space (benchmarks/bench_mixed.py:45)."""
    from repro_torch.hpo.space import Categorical, Dim, Int, SearchSpace
    return SearchSpace((
        Dim("x1", -10.0, 10.0),
        Dim("x2", -10.0, 10.0),
        Int("k", -3, 3),                       # third Levy coordinate
        Categorical("branch", ("a", "b", "c")),
    ))


def mixed_objective(space):
    """The mixed workload's objective on encoded unit vectors (n, 6): each
    row decoded with `to_hparams`, then -Levy(x1, x2, k) + the branch's
    offset (benchmarks/bench_mixed.py:55)."""
    from repro_torch.core.levy import neg_levy

    def objective(u: np.ndarray) -> np.ndarray:
        hps = [space.to_hparams(row) for row in np.atleast_2d(u)]
        x = torch.tensor([[hp["x1"], hp["x2"], float(hp["k"])] for hp in hps],
                         dtype=torch.float32)
        off = np.asarray([BRANCH_OFFSET[hp["branch"]] for hp in hps])
        return (neg_levy(x).numpy() + off).astype(np.float32)

    return objective


def median_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
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


def device_split(fn) -> dict:
    """One call of `fn` under torch.profiler: each device kernel, copy and
    memset by name with its count and device ms, the span from the first
    start to the last end, and the idle ms inside that span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # Now and then a session records no device activity at all; the call is
    # profiled again then (up to 3 sessions), never judged on an empty trace.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events() if e.device_type == DeviceType.CUDA)
        if spans:
            break
    if not spans:
        names = sorted({e.name for e in prof.events()})
        raise AssertionError(f"torch.profiler recorded no device activity in "
                             f"3 sessions ({len(prof.events())} host events: "
                             f"{names[:8]})")
    by_name, busy, reach = {}, 0.0, spans[0][0]
    for start, end, name in spans:
        count, us = by_name.get(name, (0, 0.0))
        by_name[name] = (count + 1, us + end - start)
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    span = reach - spans[0][0]
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "idle_ms": (span - busy) / 1e3,
            "by_name": [{"name": k[:80], "count": c, "ms": us / 1e3}
                        for k, (c, us) in sorted(by_name.items(),
                                                 key=lambda kv: -kv[1][1])]}


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time in ms for the work: max of flops / fp32 peak and bytes /
    memory rate (each input read once, each output written once)."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def held_to_plain(got, plain, exact, tol) -> tuple[bool, dict]:
    """A kernel's result against its plain version at the stated tolerance.
    Where float32 itself misses that tolerance against a float64 evaluation
    of the same function (an ill-conditioned input: a sum whose terms
    cancel), the kernel must instead be within twice the plain version's
    own float64 error."""
    ok = bool(torch.allclose(got, plain, **tol))
    f32_ok = bool(torch.allclose(plain.double(), exact, **tol))
    err_kernel, err_plain = max_abs(got.double(), exact), max_abs(plain.double(), exact)
    if not ok and not f32_ok:
        ok = err_kernel <= 2.0 * err_plain
    return ok, {"max_abs_err": max_abs(got, plain), "within_tol": ok,
                "float32_meets_tol": f32_ok, "kernel_err_vs_f64": err_kernel,
                "plain_err_vs_f64": err_plain}


def rel_err(a, b):
    """max |a - b| / max |b| over the last two axes (per matrix)."""
    return (a - b).abs().amax((-2, -1)) / b.abs().amax((-2, -1))


def held_as_batch(name, got, singles, resid, plain_resid, tol) -> dict:
    """A batched launch against the same matrices launched one at a time
    (the same arithmetic: bitwise equal), and each matrix's residual
    against the plain version's: within `tol`, or within twice the plain
    version's own residual where float32 cannot meet `tol`."""
    axis_err = max_abs(got, singles)
    good = resid <= torch.clamp(2.0 * plain_resid, min=tol)
    if axis_err != 0.0 or not bool(good.all()):
        raise AssertionError(f"{name} batched: batch-axis err {axis_err}, "
                             f"resid {resid.tolist()}, plain {plain_resid.tolist()}")
    return {"batch_axis_err": axis_err, "resid_max": float(resid.max()),
            "plain_resid_max": float(plain_resid.max()),
            "resid": [float(v) for v in resid],
            "plain_resid": [float(v) for v in plain_resid],
            "matrices_within_tol": int((resid <= tol).sum())}


def compact(batched: dict) -> dict:
    """A batched check's numbers without its per-matrix lists."""
    return {k: v for k, v in batched.items() if not isinstance(v, list)}


def held_inverse(tag, l) -> dict:
    """X = L^{-1} from `tri_inverse_cuda` against the general kernel at
    B = I (the same arithmetic: bitwise equal) and against the plain
    version: residual |L X - I| within the tolerance and X within the
    plain tolerance, or, where float32 itself misses them (a clamped
    pivot), within twice the plain version's own residual and float64
    error."""
    from repro_torch.kernels import ref, trsv
    eye = torch.eye(l.shape[-1], device=l.device).expand_as(l).contiguous()
    got, general = trsv.tri_inverse_cuda(l), trsv.trsv_cuda(l, eye)
    plain = ref.tri_inverse(l)
    exact = ref.tri_inverse(l.double())
    torch.cuda.synchronize()
    resid = (l @ got - eye).abs().amax((-2, -1))
    plain_resid = (l @ plain - eye).abs().amax((-2, -1))
    rel, plain_rel = rel_err(got, plain), rel_err(plain.double(), exact)
    line = {"equal_to_general": bool(torch.equal(got, general)),
            "finite": bool(torch.isfinite(got).all()),
            "resid_max": float(resid.max()),
            "plain_resid_max": float(plain_resid.max()),
            "rel_err_vs_plain": float(rel.max()),
            "plain_rel_err_vs_f64": float(plain_rel.max()),
            "rel_err_vs_f64": float(rel_err(got.double(), exact).max())}
    resid_ok = resid <= torch.clamp(2.0 * plain_resid, min=TOL_TRSV_RESID)
    rel_ok = (rel <= TOL_TRSV_PLAIN) | ((plain_rel > TOL_TRSV_PLAIN) & (
        rel_err(got.double(), exact) <= 2.0 * plain_rel))
    if not (line["equal_to_general"] and line["finite"] and bool(resid_ok.all())
            and bool(rel_ok.all())):
        raise AssertionError(f"tri_inverse {tag}: {line}")
    return line


def digest(x) -> str:
    """sha256 of X's bits with -0 read as +0 (the skipped terms of L X = I
    may change only the sign of a zero)."""
    return hashlib.sha256(torch.where(x == 0, 0.0, x).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def inverse_digests(dev) -> dict:
    """`ops.padded_tri_inverse` on the kernels phase's factors (the same
    draws from a generator seeded 0: the Matérn phase's points, then the
    Levy-5d state), single and as the lag refit's batch, as digests.  Uses
    only entry points the parent tree also has, so the same call on an
    unpacked parent shows whether X's bits moved."""
    from repro_torch.kernels import chol, ops
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.rand((N_MAX, DIM), generator=gen, device=dev)
    st, kern = levy_state(dev, gen)
    l_fac = chol.cholesky_cuda(ops.masked_gram(st.x_buf, st.n, kern, st.params))
    l_grid = chol.cholesky_cuda(grid_grams(st, kern))
    return {"single": digest(ops.padded_tri_inverse(l_fac)),
            "batch": digest(ops.padded_tri_inverse(l_grid))}


def grid_grams(st, kern):
    """The lag refit's batch (`gp._lml_grid`): the padded Gram of `st` under
    each of the 18 grid candidates, (18, n_max, n_max)."""
    from repro_torch.core.kernels import KernelParams
    from repro_torch.kernels import ops
    dev = st.x_buf.device
    return torch.stack([
        ops.masked_gram(st.x_buf, st.n, kern, KernelParams(
            sigma2=torch.tensor(s2, device=dev),
            rho=torch.tensor(rho, device=dev), noise2=st.params.noise2))
        for rho in GRID_RHO for s2 in GRID_SIGMA2])


def gram_forms(dev) -> dict:
    """The gram checks' inputs, one entry per form, each from its own
    generator: the kernels phase's (1024, 5) points (seed 0, its first
    draw) and the Levy-5d state drawn next, or the mixed workload's
    (1024, 6) lattice points and its state (seed 6); the column is row 7
    (Matérn: shifted by 0.01); the initial parameters.  Each entry holds
    the tagged kernel function, the CUDA wrapper, its masked form and the
    plain version, the last three with the (d,) masks bound for mixed."""
    from repro_torch.core.descriptor import project_units
    from repro_torch.core.kernels import KernelParams, matern52
    from repro_torch.kernels import matern, mixed, ref
    params = KernelParams(sigma2=SIGMA2, rho=RHO0, noise2=NOISE2).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.rand((N_MAX, DIM), generator=gen, device=dev)
    st, _ = levy_state(dev, gen)
    forms = {"matern52_gram": dict(
        x=x, col=x[7:8] + 0.01, state=st, kern=matern52, params=params,
        cuda=matern.matern52_gram_cuda,
        masked=lambda *a: matern.masked_gram_cuda(*a),
        plain=ref.matern52_gram, masks=lambda d: ())}
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    desc = mixed_space().descriptor().to(dev)
    xm = project_units(torch.rand((N_MAX, MIXED_DIM), generator=gen,
                                  device=dev), desc)
    mst, mkern, _ = mixed_state(dev, gen)

    def mixed_masks(d):
        """(d,) masks for a ragged width: the space's own at d = 6, else
        the first two thirds continuous and the rest categorical."""
        if d == MIXED_DIM:
            return desc.cont_mask, desc.cat_mask
        cont = (torch.arange(d, device=dev) < max(1, 2 * d // 3)).float()
        return cont, 1.0 - cont

    cm, km = desc.cont_mask, desc.cat_mask
    forms["mixed_gram"] = dict(
        x=xm, col=xm[7:8], state=mst, kern=mkern, params=params,
        cuda=lambda a, b, s2, rho, *mk: mixed.mixed_gram_cuda(
            a, b, s2, rho, *(mk or (cm, km))),
        masked=lambda a, n, s2, rho, nz, *mk: mixed.masked_gram_cuda(
            a, n, s2, rho, nz, *(mk or (cm, km))),
        plain=lambda a, b, s2, rho, *mk: ref.mixed_gram(
            a, b, s2, rho, *(mk or (cm, km))),
        masks=mixed_masks)
    return forms


def gram_digests(dev) -> dict:
    """Digests of each gram's bits on `gram_forms`' inputs: the 1024^2 Gram
    and the column through `ops.kernel_gram`, and the lag refit's 18
    padded Grams through `ops.masked_gram` in a loop (`grid_grams`).  Uses
    only entry points the parent tree also has, so the same call on an
    unpacked parent shows whether K's bits moved."""
    from repro_torch.kernels import ops
    out = {}
    for name, f in gram_forms(dev).items():
        out[name] = {
            "gram": digest(ops.kernel_gram(f["kern"], f["x"], f["x"], f["params"])),
            "column": digest(ops.kernel_gram(f["kern"], f["x"], f["col"], f["params"])),
            "lag_batch": digest(grid_grams(f["state"], f["kern"]))}
    return out



def ei_digests(dev) -> dict:
    """Digests of both fused-EI forms' bits (ei, then grad) on refactored
    standardized states (a generator seeded 16: the Levy-5d state, then
    the mixed workload's, each with 64 candidates; the mixed form under
    the space's (d,) masks), one study and the same study stacked three
    times, and whether each lane of the three is the single launch's bits
    (the kernels phase requires it).  Uses only entry points the parent
    tree also has, so the same call on an unpacked parent shows whether
    the shared-mask bits moved."""
    from repro_torch.core import gp
    from repro_torch.core.descriptor import project_units
    from repro_torch.kernels import acq
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    desc = mixed_space().descriptor().to(dev)
    st, kern = levy_state(dev, gen)
    fargs = ei_args(gp.refactor(st, kern),
                    torch.rand((64, DIM), generator=gen, device=dev))
    mst, mkern, _ = mixed_state(dev, gen)
    margs = ei_args(gp.refactor(mst, mkern), project_units(
        torch.rand((64, MIXED_DIM), generator=gen, device=dev), desc))
    out = {}
    for tag, launch, args in (
            ("float", acq.fused_ei_grad_cuda, fargs),
            ("mixed", lambda *a: acq.fused_ei_grad_mixed_cuda(
                *a, desc.cont_mask, desc.cat_mask), margs)):
        three = [torch.stack([torch.as_tensor(a, device=dev)] * 3)
                 for a in args]
        outs = {}
        for key, a in ((tag, args), (f"{tag} x3", three)):
            outs[key] = launch(*a)
            out[key] = digest(torch.cat([v.reshape(-1) for v in outs[key]]))
        # Each lane of the batch of 3 against the single launch: bit for
        # bit where the k-split does not depend on the batch.
        out[f"{tag} x3 lanes equal"] = all(
            torch.equal(b[i], a) for a, b in zip(outs[tag], outs[f"{tag} x3"])
            for i in range(3))
    return out


def ei_engine_times(dev) -> dict:
    """Both fused-EI forms at the engine's shapes, r = 48 candidates against
    n = 1024: S = 16 studies (the refactored standardized states of
    `ei_digests` stacked 16 times; the mixed form with (16, d) masks, as
    the mixed engine launches it) and S = 1 (a routed suggest or an ask's
    ascent, (d,) masks): the device ms of one launch (torch.profiler), the
    CUDA-event ms (median of 20), the plain version's ms, the bound and
    the plan.  Uses only entry points the parent tree has, so the same
    call on an unpacked parent times the parent's plan on the same card."""
    from repro_torch.core import gp
    from repro_torch.core.descriptor import project_units
    from repro_torch.kernels import acq
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    desc = mixed_space().descriptor().to(dev)
    st, kern = levy_state(dev, gen)
    fargs = ei_args(gp.refactor(st, kern),
                    torch.rand((48, DIM), generator=gen, device=dev))
    mst, mkern, _ = mixed_state(dev, gen)
    margs = ei_args(gp.refactor(mst, mkern), project_units(
        torch.rand((48, MIXED_DIM), generator=gen, device=dev), desc))
    out = {}
    for s in (ENGINE_STUDIES, 1):
        cm, km = (m.expand(s, MIXED_DIM).contiguous() if s > 1 else m
                  for m in (desc.cont_mask, desc.cat_mask))
        for tag, launch, args in (
                ("float", acq.fused_ei_grad_cuda, fargs),
                ("mixed", lambda *a: acq.fused_ei_grad_mixed_cuda(*a, cm, km),
                 margs)):
            batch = ([torch.stack([torch.as_tensor(a, device=dev)] * s)
                      .contiguous() for a in args] if s > 1 else list(args))
            d = args[0].shape[-1]
            r, n = 48, N_MAX
            split = device_split(lambda: launch(*batch))
            # The plan the call takes (a parent tree without plan tables
            # takes launch_plan's).
            plan = getattr(acq, "call_plan", acq.launch_plan)(
                s, r, n, d, tag == "mixed")
            b_ms, b_by = ei_bound(s, r, n, d, tag == "mixed")
            out[f"{tag} S={s}"] = {
                "device_ms": split["busy_ms"],
                "event_ms": median_ms(lambda: launch(*batch)),
                "plain_ms": median_ms(lambda: plain_ei(
                    batch, *((cm, km) if tag == "mixed" else ()))),
                "bound_ms": b_ms, "bound_by": b_by, "slices": plan.slices,
                "tiles_per_slice": plan.tiles_per_slice,
                "grid": list(plan.grid)}
    return out


def grid_params(dev):
    """The lag refit's 18 candidates as (G,) device vectors, in
    `gp.refit_params`' order."""
    rr, ss = torch.meshgrid(torch.tensor(GRID_RHO, device=dev),
                            torch.tensor(GRID_SIGMA2, device=dev), indexing="ij")
    return ss.reshape(-1), rr.reshape(-1)


def lag_batch(st, kern, s2, rho):
    """The lag refit's 18 padded Grams as `gp._lml_grid` builds them: one
    `ops.masked_gram` on the expanded `x_buf` with the (G,) parameters of
    `grid_params`."""
    from repro_torch.core.kernels import KernelParams
    from repro_torch.kernels import ops
    return ops.masked_gram(st.x_buf.expand(s2.shape[0], *st.x_buf.shape), st.n,
                           kern, KernelParams(s2, rho, st.params.noise2))


def gram_loop_ms(dev) -> dict:
    """CUDA-event median of `grid_grams` (18 `ops.masked_gram` calls and a
    stack) on each form's state.  Uses only entry points the parent tree
    also has: on an unpacked parent it times the parent's way of building
    the lag refit's Grams."""
    return {name: median_ms(lambda: grid_grams(f["state"], f["kern"]))
            for name, f in gram_forms(dev).items()}


def held_padded(tag, got, k, n, noise2) -> None:
    """A masked build against the unmasked build k of the same kernel:
    exactly K inside the active block, K_ii + noise2 on its diagonal (one
    float32 add) and the identity outside it (`ref.pad_identity` of k)."""
    from repro_torch.kernels import ref
    want = ref.pad_identity(k, n, noise2)
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{tag}: {bad} entries differ from K padded by "
                             f"the identity")


def gram_checks(dev, digests: dict) -> tuple[dict, dict]:
    """Phase 3, both grams beyond the main-path shapes of `check_kernels`:
    the 1024^2 Gram and the column of `gram_forms`, the lag refit's batch
    of 18 masked Grams over one state (one launch, `lag_batch`), a batch
    of 3 studies with distinct x, n (1024, 500, 1) and parameters, and
    ragged n = 1000 against m = 7 and itself at d = 1 and d = 33.  Each is
    held to its plain version at TOL_MATERN or, by `held_ei`'s reading of
    `held_to_plain`'s float64 rule, within twice the plain version's
    float64 error (float32 itself misses TOL_MATERN at rho = 0.05 and
    sigma2 = 4 in the lag batch, and the cross term rounds apart from
    cuBLAS's on the mixed workload's points);
    each batch is torch.equal to
    its single launches; each symmetric build to its transpose; each
    masked build is exactly K padded by the identity.  Digests of the
    1024^2 Gram, the column and the batch must be `digests`' (the loop of
    single builds).  Times: CUDA-event medians of 20, the bound, the plain
    version and, for the lag batch, `grid_grams`' loop of 18.  Returns
    (line, the batch's numbers per kernel for the kernels line)."""
    from repro_torch.kernels import _build, matern, ref
    out, batched = {}, {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    for name, f in gram_forms(dev).items():
        cuda, masked, plain = f["cuda"], f["masked"], f["plain"]
        x, d, p = f["x"], f["x"].shape[-1], f["params"]
        s2, rho = p.sigma2, p.rho
        line, found = {}, {}

        def held(tag, got, want, sym=False) -> dict:
            """`got` against want(float32), the plain version, by
            `held_to_plain` (float64: want(float64)), with `held_ei`'s
            reading of its float64 rule (also where the plain version
            meets the tolerance and the kernel, closer to float64, is
            outside it); a symmetric build must also equal its transpose."""
            ok, res = held_to_plain(got, want(torch.float32),
                                    want(torch.float64), TOL_MATERN)
            ok = ok or res["kernel_err_vs_f64"] <= 2.0 * res["plain_err_vs_f64"]
            if sym and not torch.equal(got, got.transpose(-1, -2)):
                ok = False
            if not ok:
                raise AssertionError(f"{name} {tag}: {res}, symmetric {sym}")
            return res

        def wide(dt, *ts):
            return [t.to(dt) for t in ts]

        k = cuda(x, x, s2, rho)
        col = cuda(x, f["col"], s2, rho)
        found["gram"], found["column"] = digest(k), digest(col)
        n = x.shape[0]
        for tag, got, y in (("1024x1024", k, x), ("1024x1", col, f["col"])):
            m = y.shape[0]
            b_ms, b_by = bound(n * m * (2 * d + 15), 4 * (n * d + m * d + n * m))
            line[tag] = dict(
                **held(tag, got, lambda dt: plain(*wide(dt, x, y, s2, rho)),
                       y is x),
                ms=median_ms(lambda: cuda(x, y, s2, rho)),
                plain_ms=median_ms(lambda: plain(x, y, s2, rho)),
                bound_ms=b_ms, bound_by=b_by,
                plan=dataclasses.asdict(matern.launch_plan(n, m, d, 1, y is x, True)))

        # The lag refit's batch: 18 candidates on one state, one launch.
        st, kern = f["state"], f["kern"]
        s2g, rhog = grid_params(dev)
        g, nm = s2g.shape[0], st.n_max
        xe = st.x_buf.expand(g, nm, d)
        got = lag_batch(st, kern, s2g, rhog)
        singles = grid_grams(st, kern)
        if not torch.equal(got, singles):
            raise AssertionError(f"{name} lag batch: not equal to 18 single builds")
        found["lag_batch"] = digest(got)
        k_all = cuda(xe, xe, s2g, rhog)
        held_padded(f"{name} lag batch", got, k_all, st.n, st.params.noise2)
        b_ms, b_by = bound(nm * nm * (2 * d + 15 * g), 4 * (nm * d + g * nm * nm))
        lag = dict(shape=f"{g} x ({nm},{d}), n = {st.n}, shared x",
                   **held("lag batch", got, lambda dt: ref.pad_identity(
                       plain(*wide(dt, xe, xe, s2g, rhog)), st.n,
                       st.params.noise2.to(dt)), True),
                   ms=median_ms(lambda: lag_batch(st, kern, s2g, rhog)),
                   plain_ms=median_ms(lambda: ref.pad_identity(
                       plain(xe, xe, s2g, rhog), st.n, st.params.noise2)),
                   loop_of_18_ms=median_ms(lambda: grid_grams(st, kern)),
                   bound_ms=b_ms, bound_by=b_by,
                   plan=dataclasses.asdict(matern.launch_plan(nm, nm, d, g, True, True)))
        line["lag batch"] = lag
        batched[name] = lag

        # Three studies with distinct x, n and parameters.
        x3 = torch.rand((3, nm, d), generator=gen, device=dev)
        if name == "mixed_gram":
            from repro_torch.core.descriptor import project_units
            x3 = project_units(x3.reshape(-1, d), mixed_space().descriptor().to(dev)
                               ).reshape(3, nm, d)
        n3 = torch.tensor([nm, 500, 1], dtype=torch.int32, device=dev)
        s3 = torch.tensor([0.25, 1.0, 4.0], device=dev)
        r3 = torch.tensor([0.1, 0.25, 0.8], device=dev)
        z3 = torch.tensor([1e-6, 1e-4, 1e-2], device=dev)
        got = masked(x3, n3, s3, r3, z3)
        singles = torch.stack([masked(x3[i], int(n3[i]), s3[i], r3[i], z3[i])
                               for i in range(3)])
        if not torch.equal(got, singles):
            raise AssertionError(f"{name} 3 studies: not equal to single launches")
        held_padded(f"{name} 3 studies", got, cuda(x3, x3, s3, r3), n3, z3)
        b_ms, b_by = bound(3 * nm * nm * (2 * d + 15), 4 * 3 * (nm * d + nm * nm))
        line["3 studies"] = dict(
            n=[int(v) for v in n3],
            **held("3 studies", got, lambda dt: ref.pad_identity(
                plain(*wide(dt, x3, x3, s3, r3)), n3, z3.to(dt)), True),
            ms=median_ms(lambda: masked(x3, n3, s3, r3, z3)),
            plain_ms=median_ms(lambda: ref.pad_identity(plain(x3, x3, s3, r3),
                                                        n3, z3)),
            bound_ms=b_ms, bound_by=b_by,
            plan=dataclasses.asdict(matern.launch_plan(nm, nm, d, 3, True, False)))
        # Ragged shapes: n = 1000 against m = 7 and against itself.
        for dr in (1, 33):
            mk = f["masks"](dr)
            xr = torch.rand((1000, dr), generator=gen, device=dev)
            yr = torch.rand((7, dr), generator=gen, device=dev)
            for tag, y in ((f"1000x7, d={dr}", yr), (f"1000x1000, d={dr}", xr)):
                line[tag] = held(tag, cuda(xr, y, s2, rho, *mk), lambda dt: plain(
                    *wide(dt, xr, y, s2, rho, *mk)), y is xr)
        if found != digests[name]:
            raise AssertionError(f"{name} digests: {found} here, {digests[name]} "
                                 f"through ops.kernel_gram / ops.masked_gram")
        line["digest"] = found
        out[name] = line
    ptxas = {src: [ln.strip() for ln in _build.BUILD_LOG.get(src, "").splitlines()
                   if "Used" in ln or "spill" in ln]
             for src in ("matern", "mixed")}
    return ({"phase": "kernels", "kernel": "gram shapes", "tol": TOL_MATERN,
             **out, "ptxas": ptxas}, batched)


def ei_args(st, xc):
    """The fused EI kernel's operands for candidates xc on state st, as the
    ascent hoists them."""
    amask = (torch.arange(st.n_max, device=xc.device) < st.n).float()
    a_buf = st.li_buf.T @ st.li_buf
    ymean = torch.sum(torch.where(amask > 0, st.y_buf, 0.0)) / st.n
    shift = ymean - torch.max(torch.where(amask > 0, st.y_buf, -torch.inf)) - 0.01
    return (xc, st.x_buf, amask, st.alpha, a_buf, st.params.sigma2,
            st.params.rho, shift)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def levy_state(dev, gen, standardize: bool = True, n_max: int | None = None,
               n_seed: int | None = None):
    """The main path's refactor input: 960 uniform unit-box points (the
    normalized Levy-5d seeds) in an n_max = 1024 buffer, and their state
    (other sizes for the fused EI's extra shapes).  Standardized values
    keep EI away from its tail; the main path itself runs on the raw
    values."""
    from repro_torch.core import gp
    from repro_torch.core.kernels import matern52
    from repro_torch.core.levy import levy_bounds, neg_levy
    n_max, n_seed = n_max or N_MAX, n_seed or N_SEED
    u = torch.rand((n_seed, DIM), generator=gen, device=dev)
    lo, hi = (t.to(dev) for t in levy_bounds(DIM))
    y = neg_levy(lo + u * (hi - lo))
    if standardize:
        y = (y - y.mean()) / y.std()
    st = gp.init_state(gp.GPConfig(n_max=n_max, dim=DIM, noise2=NOISE2,
                                   rho0=RHO0, device=str(dev)))
    st.x_buf[:n_seed] = u
    st.y_buf[:n_seed] = y
    return dataclasses.replace(st, n=n_seed), matern52


def mixed_state(dev, gen, standardize: bool = True, n_max: int | None = None,
                n_seed: int | None = None):
    """A mixed-space refactor input: 960 points of the mixed workload's
    space, drawn uniform and projected onto its lattice, in an n_max = 1024
    buffer (other sizes for the fused EI's extra shapes), and their state
    under the mixed kernel."""
    from repro_torch.core import gp
    from repro_torch.core.descriptor import project_units
    n_max, n_seed = n_max or N_MAX, n_seed or N_SEED
    space = mixed_space()
    desc = space.descriptor().to(dev)
    u = project_units(torch.rand((n_seed, MIXED_DIM), generator=gen,
                                 device=dev), desc)
    y = torch.as_tensor(mixed_objective(space)(u.cpu().numpy()), device=dev)
    if standardize:
        y = (y - y.mean()) / y.std()
    cfg = gp.GPConfig(n_max=n_max, dim=MIXED_DIM, noise2=NOISE2, rho0=RHO0,
                      desc=desc, device=str(dev))
    st = gp.init_state(cfg)
    st.x_buf[:n_seed] = u
    st.y_buf[:n_seed] = y
    return dataclasses.replace(st, n=n_seed), cfg.kernel_fn, desc


def check_kernels(dev, gen) -> list[dict]:
    """Phase 3: each kernel against its plain version at main-path shapes."""
    from repro_torch.core import gp
    from repro_torch.core.descriptor import project_units
    from repro_torch.kernels import _build, acq, chol, matern, mixed, ops, ref, trsv
    rows = []
    eye = torch.eye(N_MAX, device=dev)

    # --- 1. Matérn gram: the refactor's (1024, 5)^2 and the append column.
    s2 = torch.tensor(SIGMA2, device=dev)
    rho = torch.tensor(RHO0, device=dev)
    x = torch.rand((N_MAX, DIM), generator=gen, device=dev)
    shapes = {}
    for tag, y in (("1024x1024", x), ("1024x1", x[7:8] + 0.01)):
        got = matern.matern52_gram_cuda(x, y, s2, rho)
        want = ref.matern52_gram(x, y, s2, rho)
        torch.cuda.synchronize()
        err = max_abs(got, want)
        if not torch.allclose(got, want, **TOL_MATERN):
            raise AssertionError(f"matern {tag}: max abs err {err}")
        n, m = x.shape[0], y.shape[0]
        b_ms, b_by = bound(n * m * (2 * DIM + 15), 4 * (n * DIM + m * DIM + n * m))
        shapes[tag] = dict(
            max_abs_err=err, ms=median_ms(lambda: matern.matern52_gram_cuda(x, y, s2, rho)),
            plain_ms=median_ms(lambda: ref.matern52_gram(x, y, s2, rho)),
            bound_ms=b_ms, bound_by=b_by)
    emit({"phase": "kernels", "kernel": "matern52_gram", "tol": TOL_MATERN,
          "shapes": shapes})
    rows.append(dict(name="matern52_gram", shape="(1024,5)x(1024,5)",
                     **shapes["1024x1024"], library_ms=None))

    # --- 2. Cholesky of the identity-padded Levy-5d Gram (960 active).
    st, kern = levy_state(dev, gen)
    k_pad = ops.masked_gram(st.x_buf, st.n, kern, st.params)
    l_k = chol.cholesky_cuda(k_pad)
    l_p = ref.cholesky(k_pad)
    torch.cuda.synchronize()
    recon = float(rel_err(l_k @ l_k.T, k_pad))
    rel = float(rel_err(l_k, l_p))
    if not (torch.isfinite(l_k).all() and recon <= TOL_CHOL_RECON
            and rel <= TOL_CHOL_PLAIN):
        raise AssertionError(f"cholesky: recon {recon}, rel err vs plain {rel}")
    n = N_MAX
    b_ms, b_by = bound(n ** 3 / 3, 4 * 2 * n * n)
    ms = median_ms(lambda: chol.cholesky_cuda(k_pad))
    plain_ms = median_ms(lambda: ref.cholesky(k_pad))
    lib_ms = median_ms(lambda: torch.linalg.cholesky(k_pad))
    # The lag refit's batch: the Gram under each of the 18 grid candidates.
    k_grid = grid_grams(st, kern)
    g = k_grid.shape[0]
    l_grid = chol.cholesky_cuda(k_grid)
    l_grid_p = ref.cholesky(k_grid)
    batched = held_as_batch(
        "cholesky", l_grid, torch.stack([chol.cholesky_cuda(k) for k in k_grid]),
        rel_err(l_grid @ l_grid.mT, k_grid), rel_err(l_grid_p @ l_grid_p.mT, k_grid),
        TOL_CHOL_RECON)
    gb_ms, gb_by = bound(g * n ** 3 / 3, g * 4 * 2 * n * n)
    batched.update(
        shape=f"({g},{n},{n})", max_abs_err=max_abs(l_grid, l_grid_p),
        ms=median_ms(lambda: chol.cholesky_cuda(k_grid)),
        plain_ms=median_ms(lambda: ref.cholesky(k_grid)),
        library_ms=median_ms(lambda: torch.linalg.cholesky_ex(k_grid)),
        bound_ms=gb_ms, bound_by=gb_by)
    # Ragged and degenerate shapes against the plain version on the card.
    edges, factors = {}, {}
    cases = {"non-PD 48": torch.from_numpy(non_pd_matrix()),
             f"n={n - 24}": k_pad[:n - 24, :n - 24],
             "3 x n=97": torch.from_numpy(spd(np.random.default_rng(97), 97, (3,))),
             "n=1": torch.tensor([[4.0]])}
    for tag, kk in cases.items():
        kk = kk.to(dev).contiguous()
        got, want = chol.cholesky_cuda(kk), ref.cholesky(kk)
        torch.cuda.synchronize()
        edge = {"rel_err_vs_plain": float(rel_err(got, want).max()),
                "finite": bool(torch.isfinite(got).all()),
                "upper_zero": bool((torch.triu(got, 1) == 0).all())}
        ok = edge["finite"] and edge["upper_zero"] and edge["rel_err_vs_plain"] <= TOL_CHOL_PLAIN
        if tag == "non-PD 48":    # the clamp: sqrt(1e-12) at the zero pivot
            edge["l_31_31"] = float(got[31, 31])
            ok = ok and got[31, 31] == want[31, 31] and abs(edge["l_31_31"] - 1e-6) <= 1e-12
        else:
            edge["recon_rel"] = float(rel_err(got @ got.mT, kk).max())
            ok = ok and edge["recon_rel"] <= TOL_CHOL_RECON
        if not ok:
            raise AssertionError(f"cholesky {tag}: {edge}")
        edges[tag] = edge
        factors[tag] = got
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("chol", "").splitlines()
             if "Used" in ln or "spill" in ln]
    emit({"phase": "kernels", "kernel": "cholesky", "n": n, "recon_rel": recon,
          "tol_recon": TOL_CHOL_RECON, "rel_err_vs_plain": rel,
          "tol_plain": TOL_CHOL_PLAIN, "max_abs_err": max_abs(l_k, l_p),
          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "batched": batched, "edges": edges, "ptxas": ptxas})
    rows.append(dict(name="cholesky", shape="(1024,1024)",
                     max_abs_err=max_abs(l_k, l_p), ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     batched=compact(batched)))

    # --- 3. trsv.  L X = I, the main path's solve, on its own kernel
    # (tri_inverse_cuda) on every factor above: bit for bit the general
    # kernel at B = I, and held to the plain version.  The general kernel
    # also both ways and on a vector right-hand side.
    l_fac = l_k
    detail = {}
    for trans in (False, True):
        x_k = trsv.trsv_cuda(l_fac, eye, trans=trans)
        x_p = ref.trsv(l_fac, eye, trans=trans)
        torch.cuda.synchronize()
        op = l_fac.T if trans else l_fac
        resid = float((op @ x_k - eye).abs().max())
        rel = float(rel_err(x_k, x_p))
        if not (resid <= TOL_TRSV_RESID and rel <= TOL_TRSV_PLAIN):
            raise AssertionError(f"trsv trans={trans}: resid {resid}, rel {rel}")
        detail[f"general trans={trans}"] = dict(
            resid=resid, rel_err_vs_plain=rel, max_abs_err=max_abs(x_k, x_p))
    vec = torch.randn((N_MAX, 1), generator=gen, device=dev)
    for trans in (False, True):
        q_k = trsv.trsv_cuda(l_fac, vec, trans=trans)
        q_p = ref.trsv(l_fac, vec, trans=trans)
        torch.cuda.synchronize()
        rel = float(rel_err(q_k, q_p))
        if rel > TOL_TRSV_PLAIN:
            raise AssertionError(f"trsv vector trans={trans}: rel {rel}")
        detail[f"vector trans={trans}"] = dict(rel_err_vs_plain=rel)
    inverses = {tag: held_inverse(tag, lf) for tag, lf in
                {f"n={n}": l_fac, f"{g} x n={n}": l_grid, **factors}.items()}
    x_k = trsv.tri_inverse_cuda(l_fac)
    x_p = ref.tri_inverse(l_fac)
    # L X = I needs n^3 / 3 flops (column c of X is zero above row c) and
    # reads L's lower half and writes X.
    b_ms, b_by = bound(n ** 3 / 3, 4 * (n * (n + 1) / 2 + n * n))
    ms = median_ms(lambda: trsv.tri_inverse_cuda(l_fac))
    general_ms = median_ms(lambda: trsv.trsv_cuda(l_fac, eye))
    plain_ms = median_ms(lambda: ref.tri_inverse(l_fac))
    lib_ms = median_ms(lambda: torch.linalg.solve_triangular(l_fac, eye, upper=False))
    # The general solve at r = 1: n (n + 1) / 2 FMAs; L's lower half, b and
    # q once.
    vec_ms = median_ms(lambda: trsv.trsv_cuda(l_fac, vec))
    vec_b_ms, vec_b_by = bound(float(n) * (n + 1), 4 * (n * (n + 1) / 2 + 2 * n))
    # The lag refit's batch: L X = I on each of the 18 grid factors.  The
    # identity is built here for the general kernel and the library call.
    eye_g = eye.expand(g, n, n).contiguous()
    x_grid = trsv.tri_inverse_cuda(l_grid)
    x_grid_p = ref.tri_inverse(l_grid)
    batched = held_as_batch(
        "tri_inverse", x_grid,
        torch.stack([trsv.tri_inverse_cuda(lg) for lg in l_grid]),
        (l_grid @ x_grid - eye).abs().amax((-2, -1)),
        (l_grid @ x_grid_p - eye).abs().amax((-2, -1)), TOL_TRSV_RESID)
    gb_ms, gb_by = bound(g * n ** 3 / 3, g * 4 * (n * (n + 1) / 2 + n * n))
    batched.update(
        shape=f"L X = I, ({g},{n},{n})", max_abs_err=max_abs(x_grid, x_grid_p),
        ms=median_ms(lambda: trsv.tri_inverse_cuda(l_grid)),
        general_ms=median_ms(lambda: trsv.trsv_cuda(l_grid, eye_g)),
        plain_ms=median_ms(lambda: ref.tri_inverse(l_grid)),
        library_ms=median_ms(
            lambda: torch.linalg.solve_triangular(l_grid, eye_g, upper=False)),
        bound_ms=gb_ms, bound_by=gb_by)
    # The same factors rebuilt from the seed and inverted through the main
    # path's entry point give the same bits.
    digests = inverse_digests(dev)
    if digests != {"single": digest(x_k), "batch": digest(x_grid)}:
        raise AssertionError(f"tri_inverse digests: {digests} through "
                             f"ops.padded_tri_inverse, {digest(x_k)} / "
                             f"{digest(x_grid)} here")
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("trsv", "").splitlines()
             if "Used" in ln or "spill" in ln]
    general = general_solves(dev)
    emit({"phase": "kernels", "kernel": "trsv general", **general})
    emit({"phase": "kernels", "kernel": "trsv", "tol_resid": TOL_TRSV_RESID,
          "tol_plain": TOL_TRSV_PLAIN, **detail, "inverses": inverses,
          "digest": digests,
          "ms": ms, "general_ms": general_ms, "plain_ms": plain_ms,
          "library_ms": lib_ms, "vector_ms": vec_ms,
          "vector_bound_ms": vec_b_ms, "vector_bound_by": vec_b_by,
          "batched": batched, "ptxas": ptxas})
    rows.append(dict(name="trsv", shape="L X = I, (1024,1024)",
                     max_abs_err=max_abs(x_k, x_p), ms=ms, general_ms=general_ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms, batched=compact(batched)))
    # The general solve's row: the append's shape, r = 1 at n = 1024, with
    # every shape of `trsv_cases` beside it.
    append_shape = general["shapes"][GENERAL_ROW_SHAPE]
    rows.append(dict(name="trsv_general", shape=f"L q = b, {GENERAL_ROW_SHAPE}",
                     **{k: append_shape[k] for k in
                        ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms")},
                     general={tag: {k: v for k, v in line.items()
                                    if k in GENERAL_KEYS}
                              for tag, line in general["shapes"].items()},
                     digest=general["digest"]))

    # --- 4. Fused EI at r = 64, n = 1024, d = 5 on the refactored state, on
    # standardized values and on the raw Levy values the main path sees.
    xc = torch.rand((64, DIM), generator=gen, device=dev)
    raw, _ = levy_state(dev, gen, standardize=False)
    scales = {}
    for scale, state in (("standardized", st), ("raw", raw)):
        args = ei_args(gp.refactor(state, kern), xc)
        ei_k, g_k = acq.fused_ei_grad_cuda(*args)
        ei_p, g_p = acq.ei_grad_torch(*args)
        ei_d, g_d = acq.ei_grad_torch(*(a.double() for a in args))
        torch.cuda.synchronize()
        held = {name: held_to_plain(k, p, d, TOL_EI) for name, k, p, d in
                (("ei", ei_k, ei_p, ei_d), ("grad", g_k, g_p, g_d))}
        if not all(ok for ok, _ in held.values()):
            raise AssertionError(f"fused EI ({scale}): {held}")
        scales[scale] = dict(
            max_abs_err=max(max_abs(ei_k, ei_p), max_abs(g_k, g_p)),
            ei_max=float(ei_p.abs().max()), grad_max=float(g_p.abs().max()),
            rows_ei_positive=int((ei_k > 0).sum()),
            plain_rows_ei_positive=int((ei_p > 0).sum()),
            rows_grad_zero=int((g_k.abs().sum(-1) == 0).sum()),
            **{k: v for name, (_, d) in held.items()
               for k, v in ((f"{name}_{key}", val) for key, val in d.items())})
        if scale == "standardized":
            ms = median_ms(lambda: acq.fused_ei_grad_cuda(*args))
            plain_ms = median_ms(lambda: acq.ei_grad_torch(*args))
    r = xc.shape[0]
    b_ms, b_by = bound(r * (2.0 * n * n + n * (4 * DIM + 40)),
                       4 * (r * DIM + n * DIM + 2 * n + n * n + r + r * DIM))
    emit({"phase": "kernels", "kernel": "fused_ei_grad", "tol": TOL_EI,
          **scales, "ms": ms, "plain_ms": plain_ms})
    rows.append(dict(name="fused_ei_grad", shape="r=64, n=1024, d=5",
                     max_abs_err=max(v["max_abs_err"] for v in scales.values()),
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None))

    # --- 5. Mixed gram on the mixed workload's space (d = 6: x1, x2, k and
    # the 3-way one-hot): the refactor's (1024, 6)^2 and the append column.
    d6 = MIXED_DIM
    desc = mixed_space().descriptor().to(dev)
    cm, km = desc.cont_mask, desc.cat_mask
    xm = project_units(torch.rand((N_MAX, d6), generator=gen, device=dev), desc)
    shapes = {}
    for tag, y in (("1024x1024", xm), ("1024x1", xm[7:8])):
        got = mixed.mixed_gram_cuda(xm, y, s2, rho, cm, km)
        want = ref.mixed_gram(xm, y, s2, rho, cm, km)
        torch.cuda.synchronize()
        err = max_abs(got, want)
        if not torch.allclose(got, want, **TOL_MATERN):
            raise AssertionError(f"mixed gram {tag}: max abs err {err}")
        n, m = xm.shape[0], y.shape[0]
        b_ms, b_by = bound(n * m * (4 * d6 + 20),
                           4 * (n * d6 + m * d6 + 2 * d6 + n * m))
        shapes[tag] = dict(
            max_abs_err=err,
            ms=median_ms(lambda: mixed.mixed_gram_cuda(xm, y, s2, rho, cm, km)),
            plain_ms=median_ms(lambda: ref.mixed_gram(xm, y, s2, rho, cm, km)),
            bound_ms=b_ms, bound_by=b_by)
    emit({"phase": "kernels", "kernel": "mixed_gram", "tol": TOL_MATERN,
          "shapes": shapes})
    rows.append(dict(name="mixed_gram", shape="(1024,6)x(1024,6)",
                     **shapes["1024x1024"], library_ms=None))

    # --- 6. Mixed fused EI at r = 64, n = 1024, d = 6 on a refactored
    # mixed-space state, on standardized and on raw objective values, at
    # candidates on the lattice (where the ascent evaluates it).  The plain
    # version takes the split rows, as the reference's does; the kernel
    # splits them as it loads them.
    def mixed_plain(a):
        return plain_ei(a, cm, km)

    from repro_torch.core.kernels import KernelParams
    xc = project_units(torch.rand((64, d6), generator=gen, device=dev), desc)
    refit = KernelParams(sigma2=4.0, rho=0.05, noise2=NOISE2).to(dev)
    scales = {}
    # The initial length scale on standardized and on raw values, and the
    # standardized values under the parameters the main path's lag refit
    # picks (a better conditioned Gram).
    for scale, standardize, params in (("standardized", True, None),
                                       ("raw", False, None),
                                       ("standardized, refit params", True,
                                        refit)):
        state, mkern, _ = mixed_state(dev, gen, standardize=standardize)
        args = ei_args(gp.refactor(state, mkern, params), xc)
        ei_k, g_k = acq.fused_ei_grad_mixed_cuda(*args, cm, km)
        ei_p, g_p = mixed_plain(args)
        ei_d, g_d = mixed_plain([a.double() for a in args])
        torch.cuda.synchronize()
        held = {name: held_to_plain(k, p, d, TOL_EI) for name, k, p, d in
                (("ei", ei_k, ei_p, ei_d), ("grad", g_k, g_p, g_d))}
        if not all(ok for ok, _ in held.values()):
            raise AssertionError(f"mixed fused EI ({scale}): {held}")
        cat_grad = float((g_k * km).abs().max())
        if cat_grad != 0.0:
            raise AssertionError(f"mixed fused EI ({scale}): gradient "
                                 f"{cat_grad} on a categorical coordinate")
        scales[scale] = dict(
            max_abs_err=max(max_abs(ei_k, ei_p), max_abs(g_k, g_p)),
            ei_max=float(ei_p.abs().max()), grad_max=float(g_p.abs().max()),
            rows_ei_positive=int((ei_k > 0).sum()),
            plain_rows_ei_positive=int((ei_p > 0).sum()),
            rows_grad_zero=int((g_k.abs().sum(-1) == 0).sum()),
            **{k: v for name, (_, d) in held.items()
               for k, v in ((f"{name}_{key}", val) for key, val in d.items())})
        if scale == "standardized":
            ms = median_ms(lambda: acq.fused_ei_grad_mixed_cuda(*args, cm, km))
            plain_ms = median_ms(lambda: mixed_plain(args))
    r, n = xc.shape[0], N_MAX
    b_ms, b_by = bound(r * (2.0 * n * n + n * (8 * d6 + 45)),
                       4 * (r * d6 + n * d6 + 2 * d6 + 2 * n + n * n + r
                            + r * d6))
    emit({"phase": "kernels", "kernel": "fused_ei_grad_mixed", "tol": TOL_EI,
          **scales, "ms": ms, "plain_ms": plain_ms})
    rows.append(dict(name="fused_ei_grad_mixed", shape="r=64, n=1024, d=6",
                     max_abs_err=max(v["max_abs_err"] for v in scales.values()),
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None))
    return rows


GENERAL_KEYS = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err", "regime")
GENERAL_ROW_SHAPE = "r=1, n=1024"      # the general solve's row: the append's


def beyond_limit_factor(dev, n: int):
    """A well-conditioned lower factor of size n from the port's Cholesky,
    seeded by n (the L X = I check past the L X = I kernel's limit)."""
    from repro_torch.kernels import chol
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    a = torch.randn((n, n), generator=gen, device=dev) / n ** 0.5
    return chol.cholesky_cuda(a @ a.T + 2.0 * torch.eye(n, device=dev))


def trsv_cases(dev) -> dict:
    """The general solve's shapes, tag -> (L, B, trans): r = 1 both ways at
    n = 1024 (the Levy-5d refactor factor) and 4096, ragged n = 1000, three
    studies at r = 1 (three of the lag refit's factors), L^{-1} K* at 64
    query points (the posterior's), B = I on one and on the lag refit's
    18 factors, and L^T Q = G at r = n (the backward solve of L X = I's
    VJP, the wide regime's caller).  Built from a generator seeded
    TRSV_SEED through entry points the parent tree also has."""
    from repro_torch.kernels import chol, ops
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRSV_SEED)
    st, kern = levy_state(dev, gen)
    l_fac = chol.cholesky_cuda(ops.masked_gram(st.x_buf, st.n, kern, st.params))
    l_grid = chol.cholesky_cuda(grid_grams(st, kern))
    l_big = beyond_limit_factor(dev, 4096)
    n = N_MAX
    vec = torch.randn((n, 1), generator=gen, device=dev)
    vec_big = torch.randn((l_big.shape[-1], 1), generator=gen, device=dev)
    vecs = torch.randn((3, n, 1), generator=gen, device=dev)
    xq = torch.rand((APPEND_QUERIES, DIM), generator=gen, device=dev)
    g_vjp = torch.randn((n, n), generator=gen, device=dev)
    active = torch.arange(n, device=dev)[:, None] < st.n
    k_star = torch.where(active, ops.kernel_gram(kern, st.x_buf, xq, st.params), 0.0)
    eye = torch.eye(n, device=dev)
    return {
        "r=1, n=1024": (l_fac, vec, False),
        "r=1, n=1024, trans": (l_fac, vec, True),
        "r=1, n=4096": (l_big, vec_big, False),
        "r=1, n=4096, trans": (l_big, vec_big, True),
        "r=1, n=1000": (l_fac[:1000, :1000].contiguous(), vec[:1000].contiguous(), False),
        "3 x r=1, n=1024": (l_grid[:3].contiguous(), vecs, False),
        "r=64, n=1024 (K*)": (l_fac, k_star, False),
        "B=I, n=1024": (l_fac, eye, False),
        f"{l_grid.shape[0]} x B=I, n=1024": (l_grid, eye.expand_as(l_grid).contiguous(), False),
        "r=n, n=1024, trans (VJP)": (l_fac, g_vjp, True),
    }


def trsv_digests(dev) -> dict:
    """Digests of Q through `trsv.trsv_cuda` for every forward shape of
    `trsv_cases` and for B = I at n = 6144.  Uses only entry points the
    parent tree also has: imported by path with PYTHONPATH of an unpacked
    parent's `src`, it prints the parent's digests (the A/B of Q's bits)."""
    from repro_torch.kernels import trsv
    out = {tag: digest(trsv.trsv_cuda(l, b)) for tag, (l, b, trans)
           in trsv_cases(dev).items() if not trans}
    l = beyond_limit_factor(dev, 6144)
    out["B=I, n=6144"] = digest(trsv.trsv_cuda(l, torch.eye(l.shape[-1], device=dev)))
    return out


def general_times(dev) -> dict:
    """CUDA-event ms (median of 20) and device ms of one call (profiler)
    of `trsv.trsv_cuda` at each of `trsv_cases`' shapes and at B = I,
    n = 6144.  Uses only entry points the parent tree also has, so the
    same call on an unpacked parent times the earlier kernel at the same
    shapes (the A/B of the general solve's times)."""
    from repro_torch.kernels import trsv
    cases = trsv_cases(dev)
    l = beyond_limit_factor(dev, 6144)
    cases["B=I, n=6144"] = (l, torch.eye(l.shape[-1], device=dev), False)
    return {tag: {"ms": median_ms(lambda: trsv.trsv_cuda(l, b, trans=trans)),
                  "device_ms": device_split(
                      lambda: trsv.trsv_cuda(l, b, trans=trans))["busy_ms"]}
            for tag, (l, b, trans) in cases.items()}


@contextlib.contextmanager
def regime(name: str, r: int):
    """Move `trsv.NARROW_MAX_R` so that a B of r columns takes the regime
    `name`, and put it back."""
    from repro_torch.kernels import trsv
    saved = trsv.NARROW_MAX_R
    trsv.NARROW_MAX_R = r if name == "narrow" else r - 1
    try:
        yield
    finally:
        trsv.NARROW_MAX_R = saved


def solve_bound(l, b) -> tuple[float, str]:
    """Least time of L Q = B: at r = 1, n (n + 1) / 2 FMAs; for B = I the
    n^3 / 3 flops of L X = I; else n^2 r flops; L's lower half, B and Q
    read or written once; times the batch."""
    n, r = l.shape[-1], b.shape[-1]
    batch = l[..., 0, 0].numel()
    eye = r == n and bool(torch.equal(b, torch.eye(n, device=b.device).expand_as(b)))
    flops = n ** 3 / 3 if eye else float(n) * (n + 1) if r == 1 else float(n) * n * r
    return bound(batch * flops, batch * 4 * (n * (n + 1) / 2 + 2 * n * r))


def general_solves(dev) -> dict:
    """The general solve (`trsv.trsv_cuda`, C entry `repro_trsv`) at each
    of `trsv_cases`' shapes: held to the plain version (`ref.trsv`, or
    within twice its float64 error where float32 itself misses
    TOL_TRSV_PLAIN), two calls bitwise equal, CUDA-event ms (median of
    20) beside the plain version's, `torch.linalg.solve_triangular`'s
    (timed only) and the bound; digests of the forward shapes, cross-checked
    against `trsv_digests`; both regimes at r = 8 to 1024 at n = 1024 and
    at r = 64 and 512 at n = 4096 (bitwise equal, timed), by moving
    `trsv.NARROW_MAX_R`, for where they cross."""
    from repro_torch.kernels import ref, trsv
    shapes, digests = {}, {}
    cases = trsv_cases(dev)
    for tag, (l, b, trans) in cases.items():
        got = trsv.trsv_cuda(l, b, trans=trans)
        again = trsv.trsv_cuda(l, b, trans=trans)
        plain = ref.trsv(l, b, trans=trans)
        exact = ref.trsv(l.double(), b.double(), trans=trans)
        torch.cuda.synchronize()
        rel, plain_rel = rel_err(got, plain), rel_err(plain.double(), exact)
        kernel_rel = rel_err(got.double(), exact)
        ok = bool(((rel <= TOL_TRSV_PLAIN) | (kernel_rel <= 2.0 * plain_rel)).all())
        line = {"regime": trsv.launch_plan(l.shape[-1], b.shape[-1],
                                           l[..., 0, 0].numel(), trans).regime,
                "rel_err_vs_plain": float(rel.max()),
                "rel_err_vs_f64": float(kernel_rel.max()),
                "plain_rel_err_vs_f64": float(plain_rel.max()),
                "max_abs_err": max_abs(got, plain),
                "repeat_equal": bool(torch.equal(got, again)),
                "finite": bool(torch.isfinite(got).all())}
        if not (ok and line["repeat_equal"] and line["finite"]):
            raise AssertionError(f"trsv {tag}: {line}")
        lower = l if not trans else l.mT
        b_ms, b_by = solve_bound(l, b)
        line.update(
            ms=median_ms(lambda: trsv.trsv_cuda(l, b, trans=trans)),
            plain_ms=median_ms(lambda: ref.trsv(l, b, trans=trans)),
            library_ms=median_ms(lambda: torch.linalg.solve_triangular(
                lower, b, upper=trans)),
            bound_ms=b_ms, bound_by=b_by)
        shapes[tag] = line
        if not trans:
            digests[tag] = digest(got)
    # Where the regimes cross: a dense B of r columns at n = 1024 and 4096
    # in each regime by events (`trsv.NARROW_MAX_R` is set from this); L Q = B
    # keeps the same bits in both.
    factors = {N_MAX: cases["r=1, n=1024"][0], 4096: cases["r=1, n=4096"][0]}
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRSV_SEED)
    crossover = {}
    for nn, r in ((N_MAX, 8), (N_MAX, 64), (N_MAX, 512), (N_MAX, 1024),
                  (4096, 64), (4096, 512)):
        l_n = factors[nn]
        b = torch.randn((l_n.shape[-1], r), generator=gen, device=dev)
        picked = trsv.launch_plan(l_n.shape[-1], r, 1).regime
        got, ms_by = {}, {}
        for reg in trsv.REGIMES:
            with regime(reg, r):
                got[reg] = trsv.trsv_cuda(l_n, b)
                ms_by[f"{reg}_ms"] = median_ms(lambda: trsv.trsv_cuda(l_n, b))
        if not torch.equal(got["narrow"], got["wide"]):
            raise AssertionError(f"trsv n={nn} r={r}: the regimes' bits differ")
        crossover[f"n={nn}, r={r}"] = {"picked": picked, **ms_by}
    # B = I past the L X = I kernel's limit: `tri_inverse_beyond_limit`.
    rebuilt = trsv_digests(dev)
    if {k: v for k, v in rebuilt.items() if k in digests} != digests:
        raise AssertionError(f"trsv digests: {rebuilt} through trsv_digests, "
                             f"{digests} here")
    return {"tol_plain": TOL_TRSV_PLAIN, "shapes": shapes, "digest": rebuilt,
            "regimes_by_r": crossover}


def acq_ptxas() -> dict:
    """ptxas's registers, spills and shared memory for every instantiation
    of csrc/acq.cu, by tile rows and form."""
    import re
    from repro_torch.kernels import _build
    out, name = {}, None
    for ln in _build.BUILD_LOG.get("acq", "").splitlines():
        m = re.search(r"fused_ei_grad_kernelILi(\d+)ELb([01])E", ln)
        if m:
            name = f"R={m.group(1)} {'mixed' if m.group(2) == '1' else 'float'}"
        elif name and ("Used" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


def held_ei(tag, launch, plain, args, cat_mask=None) -> dict:
    """A fused-EI form against its plain version, twice on the same inputs
    (the two results must be torch.equal), and, for the mixed form, a
    gradient of exactly 0 on the categorical coordinates.  Each output must
    be within TOL_EI of the plain version or, where it is not, no further
    from a float64 evaluation than twice the plain version's own error:
    `held_to_plain`'s float64 rule, applied also where the plain version
    meets TOL_EI against float64 while the kernel, closer to float64, is
    outside TOL_EI of the plain version (a cancelling gradient sum)."""
    ei_k, g_k = launch(args)
    ei_k2, g_k2 = launch(args)
    ei_p, g_p = plain(args)
    ei_d, g_d = plain([a.double() for a in args])
    torch.cuda.synchronize()
    held = {}
    for name, k, p, d in (("ei", ei_k, ei_p, ei_d), ("grad", g_k, g_p, g_d)):
        ok, line = held_to_plain(k, p, d, TOL_EI)
        held[name] = (ok or line["kernel_err_vs_f64"]
                      <= 2.0 * line["plain_err_vs_f64"], line)
    same = bool(torch.equal(ei_k, ei_k2) and torch.equal(g_k, g_k2))
    cat_grad = 0.0 if cat_mask is None else float((g_k * cat_mask).abs().max())
    if not (all(ok for ok, _ in held.values()) and same and cat_grad == 0.0):
        raise AssertionError(f"fused EI {tag}: repeat equal {same}, "
                             f"categorical grad {cat_grad}, {held}")
    return {"repeat_equal": same, "rows_ei_positive": int((ei_k > 0).sum()),
            **{f"{name}_{key}": val for name, (_, d) in held.items()
               for key, val in d.items()
               if key in ("max_abs_err", "within_tol", "kernel_err_vs_f64",
                          "plain_err_vs_f64")}}


def ei_shapes(dev) -> dict:
    """Phase 3, after the main-path checks (own generator, so their draws
    are unchanged): both fused-EI forms at ragged n = 1000, at n = 4096 and
    on a batch of 3 studies at n = 1024, each held to its plain version by
    `held_ei`, with the launch plan of each; ptxas's report for every
    instantiation.  States: standardized Levy-5d values (float form);
    standardized mixed-workload values under the initial parameters, and
    at n = 4096, where float32 cannot factor that Gram (the plain version
    gives NaN too), under the parameters the main path's lag refit picks
    (mixed form)."""
    from repro_torch.core import gp
    from repro_torch.core.descriptor import project_units
    from repro_torch.core.kernels import KernelParams
    from repro_torch.kernels import acq
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    desc = mixed_space().descriptor().to(dev)
    cm, km = desc.cont_mask, desc.cat_mask
    refit = KernelParams(sigma2=4.0, rho=0.05, noise2=NOISE2).to(dev)

    def float_args(n_max, n_seed):
        st, kern = levy_state(dev, gen, n_max=n_max, n_seed=n_seed)
        xc = torch.rand((64, DIM), generator=gen, device=dev)
        return ei_args(gp.refactor(st, kern), xc)

    def mixed_args(n_max, n_seed):
        st, mkern, _ = mixed_state(dev, gen, n_max=n_max, n_seed=n_seed)
        xc = project_units(torch.rand((64, MIXED_DIM), generator=gen,
                                      device=dev), desc)
        return ei_args(gp.refactor(st, mkern, refit if n_max > N_MAX else None),
                       xc)

    def stack(cases):
        return [torch.stack([torch.as_tensor(a[i], device=dev) for a in cases])
                for i in range(len(cases[0]))]

    def mixed_plain(a):
        return plain_ei(a, cm, km)

    forms = {
        "float": (float_args, lambda a: acq.fused_ei_grad_cuda(*a),
                  lambda a: acq.ei_grad_torch(*a), None),
        "mixed": (mixed_args,
                  lambda a: acq.fused_ei_grad_mixed_cuda(*a, cm, km),
                  mixed_plain, km),
    }
    out = {}
    for form, (make, launch, plain, cat) in forms.items():
        cases = {"n=1000": make(1000, 936), "n=4096": make(4096, 4000),
                 "3 x n=1024": stack([make(N_MAX, N_SEED) for _ in range(3)])}
        for tag, args in cases.items():
            lead = args[1].shape[:-2]
            plan = acq.call_plan(math.prod(lead), args[0].shape[-2],
                                 args[1].shape[-2], args[0].shape[-1],
                                 form == "mixed")
            out[f"{form} {tag}"] = dict(held_ei(f"{form} {tag}", launch, plain,
                                               args, cat),
                                        plan=dataclasses.asdict(plan))
    return {"phase": "kernels", "kernel": "fused_ei_grad shapes", "tol": TOL_EI,
            **out, "ptxas": acq_ptxas()}


def ei_accuracy_spread(dev, seeds=range(1, 7)) -> dict:
    """Informational (raises nothing): the mixed form on mixed-workload
    states of the checks' kinds, standardized, at n = 1000 and 1024, under
    the initial parameters and under the lag refit's (sigma2 4, rho 0.05),
    one state per seed; for each, the kernel's float64 error over the
    plain version's, for EI and gradient, and whether `held_to_plain`
    holds.  Uses only entry points the parent tree also has, so the same
    call on an unpacked parent shows the parent kernel's spread."""
    from repro_torch.core import gp
    from repro_torch.core.descriptor import project_units
    from repro_torch.core.kernels import KernelParams
    from repro_torch.kernels import acq
    desc = mixed_space().descriptor().to(dev)
    cm, km = desc.cont_mask, desc.cat_mask
    refit = KernelParams(sigma2=4.0, rho=0.05, noise2=NOISE2).to(dev)
    out = {}
    for kind, params in (("initial", None), ("refit", refit)):
        rows = []
        for seed in seeds:
            for n_max, n_seed in ((1000, 936), (N_MAX, N_SEED)):
                gen = torch.Generator(device=dev)
                gen.manual_seed(seed)
                st, mkern, _ = mixed_state(dev, gen, n_max=n_max, n_seed=n_seed)
                xc = project_units(torch.rand((64, MIXED_DIM), generator=gen,
                                              device=dev), desc)
                args = ei_args(gp.refactor(st, mkern, params), xc)
                got = acq.fused_ei_grad_mixed_cuda(*args, cm, km)
                sp = acq.split_rows(args[0], args[1], cm, km)
                plain = acq.ei_grad_torch(*sp[:2], *args[2:], xk=sp[2], xbk=sp[3])
                wide = [a.double() for a in args]
                sp = acq.split_rows(wide[0], wide[1], cm, km)
                exact = acq.ei_grad_torch(*sp[:2], *wide[2:], xk=sp[2], xbk=sp[3])
                torch.cuda.synchronize()
                row = {"seed": seed, "n": n_max}
                for name, k, p, d in zip(("ei", "grad"), got, plain, exact):
                    ok, line = held_to_plain(k, p, d, TOL_EI)
                    row[f"{name}_ratio"] = (line["kernel_err_vs_f64"]
                                            / max(line["plain_err_vs_f64"], 1e-30))
                    row[f"{name}_held"] = ok
                rows.append(row)
        ratios = sorted(max(r["ei_ratio"], r["grad_ratio"]) for r in rows)
        out[kind] = {"held": sum(r["ei_held"] and r["grad_held"] for r in rows),
                     "of": len(rows), "worst_ratio_median": ratios[len(ratios) // 2],
                     "worst_ratio_max": ratios[-1], "cases": rows}
    return out


def tri_inverse_beyond_limit(dev, n: int = 6144) -> dict:
    """L X = I past the L X = I kernel's shared-memory limit (`trsv.MAX_N`),
    through `trsv.tri_inverse` on the card: it must take the general kernel
    (`trsv.inverse_entry`, counted in `trsv.LAUNCHES_GENERAL`), launch
    once, hold ||L X - I||_max (in float64)
    within TOL_TRSV_RESID, and hold X to the plain version (TOL_TRSV_PLAIN,
    or twice its float64 error).  L is the port's Cholesky factor of a
    well-conditioned SPD matrix (`beyond_limit_factor`).  Timed by CUDA
    events beside the plain version, `solve_triangular` and the bound."""
    from repro_torch.kernels import ref, trsv
    l = beyond_limit_factor(dev, n)
    eye = torch.eye(n, device=dev)
    before = trsv.LAUNCHES_GENERAL
    t0 = time.perf_counter()
    x = trsv.tri_inverse(l)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = trsv.LAUNCHES_GENERAL - before
    resid = float((l.double() @ x.double() - eye.double()).abs().max())
    plain = ref.tri_inverse(l)
    exact = ref.tri_inverse(l.double())
    rel, plain_rel = float(rel_err(x, plain)), float(rel_err(plain.double(), exact))
    kernel_rel = float(rel_err(x.double(), exact))
    b_ms, b_by = bound(n ** 3 / 3, 4 * (n * (n + 1) / 2 + n * n))
    line = {"n": n, "max_n_of_tri_inverse_kernel": trsv.MAX_N,
            "route": trsv.inverse_entry(n),
            "regime": trsv.launch_plan(n, n, 1).regime,
            "launches": launches, "resid": resid,
            "tol_resid": TOL_TRSV_RESID, "finite": bool(torch.isfinite(x).all()),
            "rel_err_vs_plain": rel, "rel_err_vs_f64": kernel_rel,
            "plain_rel_err_vs_f64": plain_rel, "max_abs_err": max_abs(x, plain),
            "digest": digest(x), "seconds": seconds,
            "ms": median_ms(lambda: trsv.tri_inverse(l)),
            "plain_ms": median_ms(lambda: ref.tri_inverse(l), reps=5),
            "library_ms": median_ms(
                lambda: torch.linalg.solve_triangular(l, eye, upper=False)),
            "bound_ms": b_ms, "bound_by": b_by}
    if not (line["route"] == "trsv" and launches == 1 and line["finite"]
            and resid <= TOL_TRSV_RESID
            and (rel <= TOL_TRSV_PLAIN or kernel_rel <= 2.0 * plain_rel)):
        raise AssertionError(f"tri_inverse n={n}: {line}")
    return {"phase": "kernels", "kernel": "trsv beyond the L X = I limit", **line}


# The fused EI's shapes that the acq_plans phase holds every compiled tile
# at: (candidates, width, form, studies): the main paths' r = 64 at S = 1,
# the engines' r = 48 at S = 16.
ACQ_CHECK_SHAPES = ((64, DIM, "float", 1), (64, MIXED_DIM, "mixed", 1),
                    (48, DIM, "float", 16), (48, MIXED_DIM, "mixed", 16))


class AcqPlanRecorder:
    """The fused-EI launches of each path that looked their plan up, by
    (plan_rows, n, d, form, studies) (`acq.KEY_LAUNCHES`), and how many
    missed the plan table (`acq.MISSES`).  `run` drives a path and emits
    its line: the misses must be 0.  With `record` (a path: `--acq-keys`,
    the run whose traffic `tune_acq` races on) a miss is printed, not
    fatal, and the launches are written to `record` after each path."""

    def __init__(self, record: str | None):
        self.record, self.by_path = record, {}

    def run(self, name: str, fn, *args):
        """`fn(*args)` as path `name`; returns its result."""
        from repro_torch.kernels import acq
        misses, launches = acq.MISSES, collections.Counter(acq.KEY_LAUNCHES)
        t0 = time.perf_counter()
        out = fn(*args)
        self.note(name, acq.MISSES - misses, acq.KEY_LAUNCHES - launches,
                  time.perf_counter() - t0)
        return out

    def note(self, name: str, misses: int, launches,
             seconds: float | None = None) -> None:
        """Add `misses` and `launches` (a Counter by key and studies) to
        path `name`, emit its line (with the path's wall `seconds` when
        given), write the record and, outside a recording run, fail on a
        miss."""
        entry = self.by_path.setdefault(
            name, {"launches": collections.Counter(), "misses": 0})
        entry["launches"].update(launches)
        entry["misses"] += misses
        emit({"phase": name, "part": "acq plans", "seconds": seconds,
              "fused_ei_misses": entry["misses"],
              "keys": sorted({k[:4] for k in entry["launches"]}),
              "launches": [[*k, c] for k, c in
                           sorted(entry["launches"].items())]})
        if self.record:
            every = collections.Counter()
            for e in self.by_path.values():
                every.update(e["launches"])
            with open(self.record, "w") as f:
                json.dump({"paths": {k: [[*key, c] for key, c in
                                         sorted(e["launches"].items())]
                                     for k, e in self.by_path.items()},
                           "keys": sorted({k[:4] for k in every}),
                           "launches": [[*k, c] for k, c in
                                        sorted(every.items())]}, f, indent=1)
        elif entry["misses"]:
            raise AssertionError(
                f"{name}: {entry['misses']} fused-EI launches missed the plan "
                f"table (keys {sorted({k[:4] for k in entry['launches']})}): "
                f"run `chip_smoke.py --acq-keys` and `tune_acq` again")

    def misses(self) -> dict:
        return {k: e["misses"] for k, e in self.by_path.items()}


def acq_plan_checks(dev, record: bool) -> dict:
    """Phase acq_plans, before the paths: every compiled tile of
    `csrc/acq.cu` (R = 4, 8, 16) in both forms at `ACQ_CHECK_SHAPES` on
    `tune_acq.key_inputs` (distinct seeded studies), held to the plain
    version (`held_ei`, TOL_EI) at one k-slice, and at S = 16 each lane
    torch.equal to its one-study launch at one k-slice, at the
    heuristic's and at the shape's tabled split.  Then the committed table
    (`acq.PLANS_PATH`): each entry's own plan and the heuristic's held
    state by state to the plain version on `tune_acq.HELD_STATES` seeded
    states of its key (`tune_acq.held_states`), where the tabled plan
    must hold as many as the heuristic's (the race admits no other); the
    states are printed, and a tile is held on every state at one k-slice
    above.  The race's held count of every candidate stands beside the
    one-slice candidate of its R (`held_by_candidate`: [held, one
    slice]): the kernel sums U over the k-slices before any column sum,
    so no k-split may hold fewer.  Then the table's sha256 of `acq.cu`
    that of the source, and each entry's plan reproducing its digests on
    the card (`tune_acq.entry_digests`; a recording run skips these four,
    as the table is about to be raced again).  Prints each key's tabled
    and heuristic plans with the device ms the race measured (this run's
    own come in the profile phase, `acq_plan_times`)."""
    from repro_torch.kernels import acq, tune_acq
    t0 = time.perf_counter()
    held, lanes = {}, {}
    for r, d, form, s in ACQ_CHECK_SHAPES:
        mixed = form == "mixed"
        args = tune_acq.key_inputs(r, N_MAX, d, mixed, s)
        one = args if s > 1 else tune_acq.lane(args, 0)
        ops_, masks = (one[:-2], one[-2:]) if mixed else (one, [])
        cat = None if not mixed else (masks[1][:, None, :] if s > 1
                                      else masks[1])
        k_tiles = -(-N_MAX // acq.TK)
        heur = acq.heuristic_config(r, N_MAX).tiles_per_slice
        tabled = acq._table().get((r, N_MAX, d, mixed))
        for rows in acq.COMPILED_ROWS:
            cfg = acq.AcqTileConfig(rows, k_tiles, True)
            tag = f"{form} S={s} r={r} R={rows}"
            held[tag] = held_ei(
                tag, lambda a, c=cfg: tune_acq.launch([*a, *masks], mixed, c),
                lambda a: plain_ei(a, *masks), ops_, cat)
            splits = {k_tiles, heur}
            if tabled is not None and tabled.rows == rows:
                splits.add(tabled.tiles_per_slice)
            for tps in (splits if s > 1 else ()):
                cfg = acq.AcqTileConfig(rows, tps, True)
                ei, grad = tune_acq.launch(args, mixed, cfg)
                unequal = []
                for i in range(s):
                    e1, g1 = tune_acq.launch(tune_acq.lane(args, i), mixed, cfg)
                    if not (torch.equal(ei[i], e1) and torch.equal(grad[i], g1)):
                        unequal.append(i)
                lanes[f"{tag} slices={-(-k_tiles // tps)}"] = unequal
                if unequal:
                    raise AssertionError(f"acq_plans {tag}, {tps} k-tiles a "
                                         f"slice: lanes {unequal} differ from "
                                         f"their S = 1 launches")
    table = json.loads(acq.PLANS_PATH.read_text())
    sha = tune_acq.source_sha256()
    plans = []
    for e in table["entries"]:
        # (.get: a recording run may read a table of an older layout)
        line = {k: e.get(k) for k in ("plan_rows", "n", "d", "form", "rows",
                                      "tiles_per_slice", "slices", "ms",
                                      "cost_ms", "launches")}
        line["heuristic"] = {k: v for k, v in e["heuristic"].items()
                             if k in ("rows", "slices", "cost_ms")
                             or k in e["ms"]}
        h = e["heuristic"]
        on_tabled, on_heuristic = tune_acq.held_states(
            (e["plan_rows"], e["n"], e["d"], e["form"]),
            [acq.AcqTileConfig(e["rows"], e["tiles_per_slice"], True),
             acq.AcqTileConfig(h["rows"], h["tiles_per_slice"], True)],
            tune_acq.HELD_STATES, table["seed"])
        line["states"] = {"tabled": on_tabled, "heuristic": on_heuristic}
        if not record and (sum(on_tabled["held"])
                           < sum(on_heuristic["held"])):
            raise AssertionError(f"acq_plans: the tabled plan holds fewer "
                                 f"seeded states than the heuristic's: {line}")
        # The race's held counts: each candidate beside the one-slice
        # candidate of its R, which a k-split must not fall below.
        one = {c["rows"]: c["held"] for c in e["candidates"]
               if c["slices"] == 1}
        line["held_by_candidate"] = {
            f"R{c['rows']} x {c['slices']}": [c["held"], one[c["rows"]]]
            for c in e["candidates"]}
        short = {k: v for k, v in line["held_by_candidate"].items()
                 if v[0] < v[1]}
        if not record and short:
            raise AssertionError(f"acq_plans: at {line['plan_rows']} "
                                 f"{line['n']} {line['d']} {line['form']} a "
                                 f"k-split holds fewer seeded states than "
                                 f"one slice of its R ([held, one slice]): "
                                 f"{short}")
        if not record:
            got = tune_acq.entry_digests(e, table["studies"], table["seed"])
            line["digest_reproduced"] = got == e["digest"]
            if got != e["digest"]:
                raise AssertionError(
                    f"acq_plans: {line} gives digests {got}, the table "
                    f"{e['digest']}: the table is stale, run tune_acq again")
        plans.append(line)
    if not record and table["acq_cu_sha256"] != sha:
        raise AssertionError(f"acq_plans: the table was raced on acq.cu "
                             f"{table['acq_cu_sha256']}, the source is {sha}: "
                             f"run tune_acq again")
    return {"phase": "acq_plans", "recording": record,
            "compiled_rows": list(acq.COMPILED_ROWS), "tol": TOL_EI,
            "held": held, "lanes_unequal": lanes,
            "table": {k: table.get(k) for k in ("card", "device", "torch",
                                                "cuda", "acq_cu_sha256")},
            "source_sha256": sha, "plans": plans,
            "seconds": time.perf_counter() - t0}


def acq_plan_times(dev) -> dict:
    """Profile phase: each table key's tabled and heuristic plans by device
    ms (torch.profiler, median of REPS launches, the two in turns) at
    S = 1 and S = the table's studies, on the key's inputs, beside the
    times the race recorded, the plain version's CUDA-event ms and the
    bound (`ei_bound`) at both S."""
    from repro_torch.kernels import acq, tune_acq
    table = json.loads(acq.PLANS_PATH.read_text())
    out = {}
    for e in table["entries"]:
        key = (e["plan_rows"], e["n"], e["d"], e["form"])
        mixed, heur, s = e["form"] == "mixed", e["heuristic"], table["studies"]
        tabled, heuristic = tune_acq.plan_times(
            key, [acq.AcqTileConfig(e["rows"], e["tiles_per_slice"], True),
                  acq.AcqTileConfig(heur["rows"], heur["tiles_per_slice"],
                                    False)],
            (1, s), REPS, table["seed"])
        many = tune_acq.key_inputs(*key[:3], mixed, s, table["seed"])
        plain, bounds = {}, {}
        for studies, args in ((1, tune_acq.lane(many, 0)), (s, many)):
            ops_, masks = (args[:-2], args[-2:]) if mixed else (args, [])
            plain[f"s{studies}_ms"] = median_ms(lambda: plain_ei(ops_, *masks))
            bounds[f"s{studies}"] = ei_bound(studies, *key[:3], mixed)
        out[" ".join(map(str, key))] = {
            "tabled": {"rows": e["rows"], "slices": e["slices"], **tabled},
            "heuristic": {"rows": heur["rows"], "slices": heur["slices"],
                          **heuristic},
            "race": {"tabled": e["ms"],
                     "heuristic": {k: v for k, v in heur.items()
                                   if k.endswith("_ms")}},
            "plain": plain, "bound_ms": bounds}
    return out


def expected_counts(acq_cfg, gram: str, ei: str) -> dict:
    """Launches a full-width run must make: one refactor at the seed points;
    each lag event scores the 18 grid candidates as one batch (the 18
    padded Grams in one launch of the masked gram, one factor, one solve),
    then refactors under the winner (one masked gram); each round's append
    builds one column; each suggest is 25 ascent steps and one final
    evaluation.  The other path's gram and EI kernels and the general
    solve stay at 0."""
    lag_events = ITERATIONS // LAG
    counts = {"matern": 0, "mixed": 0, "acq": 0, "acq_mixed": 0,
              "trsv": 1 + 2 * lag_events, "trsv_general": 0,
              "chol": 1 + 2 * lag_events}
    counts[gram] = 1 + 2 * lag_events + ITERATIONS
    counts[ei] = ITERATIONS * (acq_cfg.ascent_steps + 1)
    return counts


def drive(name: str, dev, run, expected: dict, kernel):
    """Run one path with every counter set to 0 just before and read just
    after; check the counts, the suggestions' EI, the best value and the
    final factor, and emit the path's line.  Returns (counts, state, hist,
    line)."""
    from repro_torch.kernels import ops
    reset_counts()
    t0 = time.perf_counter()
    state, hist = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    if launches != expected:
        raise AssertionError(f"{name}: launches {launches}, expected {expected}")
    # EI of each suggestion: 0 means every restart ended where EI (and so
    # its gradient) is 0 in float32, and the pick fell to the first restart.
    # On raw Levy values that is common (PERF.md); an ascent that never had
    # any signal is a failure.
    zero_ei = [v == 0.0 for v in hist.acq_values]
    if all(zero_ei):
        raise AssertionError(f"{name}: all {ITERATIONS} suggestions had EI 0")
    if not np.isfinite(hist.best_y[-1]) or state.n != N_SEED + ITERATIONS:
        raise AssertionError(f"{name}: best_y {hist.best_y[-1]}, n {state.n}")
    k_pad = ops.masked_gram(state.x_buf, state.n, kernel, state.params)
    recon = float((state.l_buf @ state.l_buf.T - k_pad).abs().max()
                  / k_pad.abs().max())
    inv_err = float((state.li_buf @ state.l_buf
                     - torch.eye(N_MAX, device=dev)).abs().max())
    if not (np.isfinite(recon) and np.isfinite(inv_err)):
        raise AssertionError(f"{name}: factor health: recon {recon}, "
                             f"inverse {inv_err}")
    line = {"phase": name, "n_final": state.n, "launches": launches,
            "seconds": seconds, "best_y": hist.best_y[-1],
            "suggest_ms_mean": 1e3 * float(np.mean(hist.acq_seconds)),
            "absorb_ms_mean": 1e3 * float(np.mean(hist.gp_seconds)),
            "absorb_ms_max": 1e3 * float(np.max(hist.gp_seconds)),
            "clamp_count": int(state.clamp_count),
            "suggestions_with_zero_ei": sum(zero_ei),
            "of_them_before_the_lag_refit": sum(zero_ei[:LAG]),
            "ei_of_suggestions": {"min": float(np.min(hist.acq_values)),
                                  "median": float(np.median(hist.acq_values)),
                                  "max": float(np.max(hist.acq_values))},
            "factor_recon_rel": recon, "inverse_err": inv_err,
            "sigma2": float(state.params.sigma2),
            "rho": float(state.params.rho)}
    return launches, state, hist, line


def main_path(dev):
    """Phase 4: the port's run_bo on Levy-5d at full width.  Returns the
    launch counts, a driver of the same configuration with the objective,
    the final state and the history."""
    from repro_torch.core import BayesOpt, BOConfig, run_bo
    from repro_torch.core.acquisition import AcqConfig
    from repro_torch.core.levy import levy_bounds, neg_levy
    lo, hi = levy_bounds(DIM)
    acq_cfg = AcqConfig()
    opt = BayesOpt(BOConfig(dim=DIM, n_max=N_MAX, lag=LAG, acq=acq_cfg),
                   lo, hi)

    def objective(x):
        return neg_levy(x).numpy()

    launches, state, hist, line = drive(
        "main", dev, lambda: run_bo(
            objective, lo, hi, ITERATIONS, dim=DIM, lag=LAG, n_seed=N_SEED,
            n_max=N_MAX, acq=acq_cfg, device="cuda"),
        expected_counts(acq_cfg, "matern", "acq"), opt.kernel)
    xs = np.asarray(hist.xs[N_SEED:])
    if not (np.all(xs >= -10.0) and np.all(xs <= 10.0)):
        raise AssertionError("a suggestion left the box")
    emit(line)
    return launches, (opt, objective), state, hist


def mixed_path(dev):
    """Phase 5: `run_bo(desc=...)` on the mixed workload at full width, on
    the encoded unit cube (lo = 0, hi = 1).  Returns as `main_path`."""
    from repro_torch.core import BayesOpt, BOConfig, gp, run_bo
    from repro_torch.core.acquisition import AcqConfig
    space = mixed_space()
    objective = mixed_objective(space)
    acq_cfg = AcqConfig()
    lo, hi = np.zeros(space.dim), np.ones(space.dim)
    desc = space.descriptor()
    opt = BayesOpt(BOConfig(dim=space.dim, n_max=N_MAX, lag=LAG, acq=acq_cfg,
                            desc=desc), lo, hi)
    launches, state, hist, line = drive(
        "mixed", dev, lambda: run_bo(
            objective, lo, hi, ITERATIONS, dim=space.dim, lag=LAG,
            n_seed=N_SEED, n_max=N_MAX, desc=desc, acq=acq_cfg,
            device="cuda"),
        expected_counts(acq_cfg, "mixed", "acq_mixed"), opt.kernel)
    xs = np.asarray(hist.xs)
    off = int((space.project(xs) != xs).any(axis=1).sum())
    if off:
        raise AssertionError(f"mixed: {off} points off the feasible lattice")
    best = space.to_hparams(xs[int(np.argmax(hist.ys))])
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    standardized, _, _ = mixed_state(dev, gen)
    line.update(points_off_lattice=off, best_hparams=best, ascent={
        "final_state": record_ascent(opt, state, space),
        "standardized_state": record_ascent(
            opt, gp.refactor(standardized, opt.kernel), space)})
    emit(line)
    return launches, (opt, objective), state, hist


def append_counts() -> dict:
    """Launches the append phase must make: the factor at n_max - 128 and
    the posterior's factor, one general solve a row, three posterior
    solves (z, alpha, L^{-1} K*); no L X = I; no gram (its Grams are built
    before the counters are set to 0, and `dense_posterior` calls the
    kernel function)."""
    return {"matern": 0, "mixed": 0, "acq": 0, "acq_mixed": 0,
            "chol": 2, "trsv": 0, "trsv_general": APPEND_ROWS + 3}


def plain_appends(l_buf, p_block, c_block, n0: int):
    """`core/cholesky.lazy_append_block` with the plain solve, in l_buf's
    dtype."""
    from repro_torch.kernels import ops, ref
    for i in range(p_block.shape[0]):
        q = ref.trsv(l_buf, p_block[i].to(l_buf.dtype)[:, None])[:, 0]
        d = torch.sqrt(torch.clamp(c_block[i].to(l_buf.dtype) - q @ q,
                                   min=ops.CLAMP_EPS))
        l_buf = ops.write_append_row(l_buf, q, d, n0 + i)
    return l_buf


def plain_posterior(x, y, xq, kern, params, dtype):
    """`gp.dense_posterior` with the plain factor and solves, in dtype."""
    from repro_torch.core.kernels import KernelParams
    from repro_torch.kernels import ref
    x, y, xq = x.to(dtype), y.to(dtype), xq.to(dtype)
    p = KernelParams(*(torch.as_tensor(v, dtype=dtype, device=x.device)
                       for v in (params.sigma2, params.rho, params.noise2)))
    k = kern(x, x, p) + p.noise2 * torch.eye(x.shape[0], dtype=dtype, device=x.device)
    l = ref.cholesky(k)
    resid = y - torch.mean(y)
    k_star = kern(x, xq, p)
    alpha = ref.trsv(l, ref.trsv(l, resid[:, None]), trans=True)[:, 0]
    v = ref.trsv(l, k_star)
    var = torch.clamp(torch.diagonal(kern(xq, xq, p)) - torch.sum(v * v, dim=0),
                      min=1e-12)
    return k_star.T @ alpha + torch.mean(y), var


def append_path(dev):
    """The append phase: the paper's Alg. 3 by triangular solve, which
    `benchmarks/bench_cholesky.py` times against a refactor (Fig. 5), on the
    Levy-5d state at n_max = 1024.  Factor the padded Gram of the first 896
    points (`ops.padded_cholesky`), absorb the other 128 one row at a time
    (`core/cholesky.lazy_append_block`: one general solve a row), then the
    exact-GP posterior on all 1024 at 64 query points (`gp.dense_posterior`:
    a factor and three solves).  Every counter is set to 0 just before and
    read just after; then the final factor is held to `ops.padded_cholesky`
    of the whole padded Gram and to the same appends through the plain
    solve, the posterior to the plain versions and to `gp.posterior` on the
    lazy state, and the per-append ms printed beside one refactor's
    (`padded_cholesky` and `padded_tri_inverse` at n = 1024)."""
    from repro_torch.core import cholesky as chol_core
    from repro_torch.core import gp
    from repro_torch.kernels import ops, trsv
    gen = torch.Generator(device=dev)
    gen.manual_seed(APPEND_ROWS)
    st, kern = levy_state(dev, gen, n_seed=N_MAX)
    n0 = N_MAX - APPEND_ROWS
    k_full = ops.masked_gram(st.x_buf, N_MAX, kern, st.params)
    k0 = ops.masked_gram(st.x_buf, n0, kern, st.params)
    idx = torch.arange(N_MAX, device=dev)
    p_block = torch.stack([torch.where(idx < n0 + i, k_full[:, n0 + i], 0.0)
                           for i in range(APPEND_ROWS)])
    c_block = torch.diagonal(k_full)[n0:].contiguous()
    xq = torch.rand((APPEND_QUERIES, DIM), generator=gen, device=dev)
    x, y = st.x_buf, st.y_buf
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    l0 = ops.padded_cholesky(k0)
    l_app = chol_core.lazy_append_block(l0, p_block, c_block, n0, n_max=N_MAX)
    mean, var = gp.dense_posterior(x, y, xq, kern, st.params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    if launches != append_counts():
        raise AssertionError(f"append: launches {launches}, expected {append_counts()}")

    # The factor: against the refactor of the whole padded Gram, and against
    # the same appends through the plain solve (float32 and float64).
    l_full = ops.padded_cholesky(k_full)
    l_plain = plain_appends(l0, p_block, c_block, n0)
    l_f64 = plain_appends(l0.double(), p_block, c_block, n0)
    recon = float(rel_err(l_app @ l_app.T, k_full))
    plain_recon = float(rel_err(l_plain @ l_plain.T, k_full))
    rel, plain_rel = float(rel_err(l_app, l_plain)), float(rel_err(l_plain.double(), l_f64))
    kernel_rel = float(rel_err(l_app.double(), l_f64))
    factor = {"recon_rel": recon, "plain_recon_rel": plain_recon,
              "refactor_recon_rel": float(rel_err(l_full @ l_full.T, k_full)),
              "rel_err_vs_refactor": float(rel_err(l_app, l_full)),
              "rel_err_vs_plain": rel, "rel_err_vs_f64": kernel_rel,
              "plain_rel_err_vs_f64": plain_rel,
              "finite": bool(torch.isfinite(l_app).all()),
              "upper_zero": bool((torch.triu(l_app, 1) == 0).all())}
    if not (factor["finite"] and factor["upper_zero"]
            and recon <= max(TOL_CHOL_RECON, 2.0 * plain_recon)
            and (rel <= TOL_CHOL_PLAIN or kernel_rel <= 2.0 * plain_rel)):
        raise AssertionError(f"append factor: {factor}")

    # The posterior: against the plain versions and the lazy state's.
    mean_p, var_p = plain_posterior(x, y, xq, kern, st.params, torch.float32)
    mean_d, var_d = plain_posterior(x, y, xq, kern, st.params, torch.float64)
    full = dataclasses.replace(st, n=N_MAX)
    mean_l, var_l = gp.posterior(gp.refactor(full, kern), kern, xq)
    posterior = {"finite": bool(torch.isfinite(mean).all() and torch.isfinite(var).all())}
    ok = posterior["finite"]
    for name, got, plain, lazy, exact in (("mean", mean, mean_p, mean_l, mean_d),
                                          ("var", var, var_p, var_l, var_d)):
        held_p, d_p = held_to_plain(got, plain, exact, TOL_POSTERIOR)
        held_l, d_l = held_to_plain(got, lazy, exact, TOL_POSTERIOR)
        posterior[name] = {"vs_plain": d_p, "vs_lazy": d_l}
        ok = ok and held_p and held_l
    if not ok:
        raise AssertionError(f"append posterior: {posterior}")

    # Fig. 5's pair on this card: one append (the solve and the row write)
    # against one refactor at n = 1024.
    append_ms = median_ms(lambda: chol_core.lazy_append_block(
        l0, p_block, c_block, n0, n_max=N_MAX), reps=5) / APPEND_ROWS
    solve_ms = median_ms(lambda: trsv.trsv(l_app, p_block[-1]))    # the last row's
    refactor_ms = median_ms(lambda: ops.padded_tri_inverse(ops.padded_cholesky(k_full)))
    line = {"phase": "append", "n_factored": n0, "rows_appended": APPEND_ROWS,
            "n_final": N_MAX, "queries": APPEND_QUERIES, "launches": launches,
            "seconds": seconds, "factor": factor, "posterior": posterior,
            "append_ms": append_ms, "append_solve_ms": solve_ms,
            "refactor_ms": refactor_ms, "refactor_over_append": refactor_ms / append_ms}
    emit(line)
    return launches


# --- the engine phases: the stacked StudyEngine at full width ---------------

ENGINE_STUDIES = 16       # studies stacked in one engine
ENGINE_ROUNDS = 32        # serving rounds with every study flagged
ENGINE_SPREAD = 8         # study s is prefilled to N_SEED - 8 s points
TOL_LANE_SUGGEST = 1e-3   # a batched suggestion against the single-study
# path on the same lane and seeds, in unit coordinates: the fused EI sums a
# lane as a single launch does (`ei_at_seeds` holds that bit for bit), but
# the hoisted operands (A, f_best, the mean) and the absorbed rows come from
# batched reductions and products, so the two ascents agree to their
# round-off, not bit for bit.  On an ill-conditioned
# posterior (raw values, rho 0.05) the round-off can send an ascent to
# another basin; such a lane's value must then be the single-study EI at
# the batched lane's own point, and at most a quarter of the lanes may
# diverge (a fault in the batched path would move them all)
TOL_LANE_FACTOR = 1e-4    # max |a - b| / max |b|, l_buf (O(1) entries)
TOL_LANE_INVERSE = 1e-3   # the same for li_buf and alpha, which carry
# K's conditioning (noise 1e-5 on raw Levy values, n about 1000)


@dataclasses.dataclass
class EngineStudy:
    """One study of an engine phase: its layout, its objective on unit
    rows (k, d) and the lattice its suggestions must lie on."""
    tag: str
    space: object             # a SearchSpace; all-continuous studies too
    objective: object


def levy_unit(dim: int):
    """Levy-dim on [-10, 10]^dim read from unit rows, as the main path maps
    it (raw values)."""
    from repro_torch.core.levy import levy_bounds, neg_levy
    lo, hi = levy_bounds(dim)

    def objective(u: np.ndarray) -> np.ndarray:
        x = lo + torch.as_tensor(u, dtype=torch.float32) * (hi - lo)
        return neg_levy(x).numpy().astype(np.float32)

    return objective


def engine_studies(mixed: bool) -> list[EngineStudy]:
    """The float engine: 16 Levy-5d studies.  The mixed engine: 8 studies
    of the mixed workload (`mixed_space`, width 6) and 8 Levy-6d studies on
    the same width, all-continuous."""
    from repro_torch.hpo.space import Dim, SearchSpace
    def unit_box(d):
        return SearchSpace(tuple(Dim(f"u{i}", 0.0, 1.0) for i in range(d)))
    if not mixed:
        return [EngineStudy("levy5", unit_box(DIM), levy_unit(DIM))
                for _ in range(ENGINE_STUDIES)]
    space = mixed_space()
    half = ENGINE_STUDIES // 2
    return ([EngineStudy("mixed", space, mixed_objective(space))] * half
            + [EngineStudy("levy6", unit_box(MIXED_DIM), levy_unit(MIXED_DIM))]
            * (ENGINE_STUDIES - half))


def engine_counts(mixed: bool, appends: int, refits: int,
                  suggests: int, steps: int) -> dict:
    """Launches of an engine run: one column gram per absorb round or
    advance with a flag (`appends`); per lag refit one masked gram, one
    factor and one L X = I on the grid of 18, then one of each for the
    refactor; per batched suggest `steps` + 1 fused-EI launches for all
    studies; the other form's kernels and the general solve 0."""
    gram, ei = ("mixed", "acq_mixed") if mixed else ("matern", "acq")
    counts = {"matern": 0, "mixed": 0, "acq": 0, "acq_mixed": 0,
              "trsv": 2 * refits, "trsv_general": 0, "chol": 2 * refits}
    counts[gram] = appends + 2 * refits
    counts[ei] = suggests * (steps + 1)
    return counts


def lag_due(eng, flags) -> int:
    """Lag refits the engine's policy makes after absorbing `flags` (its
    host mirrors; lag > 0)."""
    return sum(1 for s in np.flatnonzero(flags)
               if eng.since_refit(s) + 1 >= eng.cfg.lag)


def diff_counts(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def stacked_engine_args(eng, cand):
    """The fused EI's operands for an engine's stacked state, as its batched
    suggest hoists them (`acquisition.hoist`, lane by lane)."""
    from repro_torch.core import acquisition as acq_mod
    st = eng.state
    amask, a_buf, shift = acq_mod.hoist(st, eng.cfg.acq, eng._n_host)
    return (cand, st.x_buf, amask, st.alpha, a_buf, st.params.sigma2,
            st.params.rho, shift)


def plain_ei(args, cont_mask=None, cat_mask=None):
    """The fused EI's plain version on `ei_args`-style operands, in the
    mixed form when the masks are given (the rows split first)."""
    from repro_torch.kernels import acq
    if cont_mask is None:
        return acq.ei_grad_torch(*args)
    xcc, xbc, xk, xbk = acq.split_rows(args[0], args[1], cont_mask, cat_mask)
    return acq.ei_grad_torch(xcc, xbc, *args[2:], xk=xk, xbk=xbk)


def stacked_mask_checks(eng, gen) -> dict:
    """The two mixed kernels with per-study (S, d) masks at the mixed
    engine's shapes (16 studies, two type layouts, n = 1024, ragged n,
    d = 6, r = 48): the append's column, the masked Gram a refactor builds
    (and its unmasked build: the masked one must be exactly that padded by
    the identity) and the fused EI, each held to its plain version, each
    lane torch.equal to a launch with that lane's (d,) masks (the grams:
    a single launch; the EI: the same batch under the lane's masks, whose
    plan is the batch's), and identical rows torch.equal to (d,) masks.
    Run after the engine phase's counts were read."""
    from repro_torch.core.descriptor import project_units
    from repro_torch.kernels import acq, mixed, ref
    st, desc = eng.state, eng.desc
    cm, km = desc.cont_mask, desc.cat_mask
    n_studies, n_max, d = st.x_buf.shape
    p = st.params
    x, cols = st.x_buf, st.x_buf[:, 7:8].contiguous()
    same_cm = cm[:1].expand(n_studies, d).contiguous()
    same_km = km[:1].expand(n_studies, d).contiguous()
    out = {}

    def lanes_equal(got, single) -> bool:
        return all(torch.equal(got[s], single(s)) for s in range(n_studies))

    # The append's column (the engine's one gram launch a round).
    got = mixed.mixed_gram_cuda(x, cols, p.sigma2, p.rho, cm, km)
    plain = ref.mixed_gram(x, cols, p.sigma2, p.rho, cm, km)
    exact = ref.mixed_gram(x.double(), cols.double(), p.sigma2.double(),
                           p.rho.double(), cm.double(), km.double())
    ok, line = held_to_plain(got, plain, exact, TOL_MATERN)
    lanes = lanes_equal(got, lambda s: mixed.mixed_gram_cuda(
        x[s], cols[s], p.sigma2[s], p.rho[s], cm[s], km[s]))
    shared = torch.equal(
        mixed.mixed_gram_cuda(x, cols, p.sigma2, p.rho, same_cm, same_km),
        mixed.mixed_gram_cuda(x, cols, p.sigma2, p.rho, cm[0], km[0]))
    b_ms, b_by = bound(n_studies * n_max * (4 * d + 20),
                       4 * n_studies * (n_max * d + d + 2 * d + n_max))
    out["column"] = dict(line, lanes_equal=lanes, shared_rows_equal=shared,
                         ms=median_ms(lambda: mixed.mixed_gram_cuda(
                             x, cols, p.sigma2, p.rho, cm, km)),
                         plain_ms=median_ms(lambda: ref.mixed_gram(
                             x, cols, p.sigma2, p.rho, cm, km)),
                         bound_ms=b_ms, bound_by=b_by)
    if not (ok and lanes and shared):
        raise AssertionError(f"stacked masks, column: {out['column']}")

    # The masked Gram (a refactor's input, per-study n), and the unmasked
    # build it must pad exactly.
    got = mixed.masked_gram_cuda(x, st.n, p.sigma2, p.rho, p.noise2, cm, km)
    k = mixed.mixed_gram_cuda(x, x, p.sigma2, p.rho, cm, km)
    held_padded("stacked masked mixed gram", got, k, st.n, p.noise2)
    plain = ref.pad_identity(ref.mixed_gram(x, x, p.sigma2, p.rho, cm, km),
                             st.n, p.noise2)
    exact = ref.pad_identity(ref.mixed_gram(
        x.double(), x.double(), p.sigma2.double(), p.rho.double(),
        cm.double(), km.double()), st.n, p.noise2.double())
    ok, line = held_to_plain(got, plain, exact, TOL_MATERN)
    lanes = lanes_equal(got, lambda s: mixed.masked_gram_cuda(
        x[s], int(st.n[s]), p.sigma2[s], p.rho[s], p.noise2[s], cm[s], km[s]))
    shared = torch.equal(
        mixed.masked_gram_cuda(x, st.n, p.sigma2, p.rho, p.noise2, same_cm,
                               same_km),
        mixed.masked_gram_cuda(x, st.n, p.sigma2, p.rho, p.noise2, cm[0],
                               km[0]))
    b_ms, b_by = bound(n_studies * n_max * n_max * (4 * d + 20) / 2,
                       4 * n_studies * (n_max * d + 2 * d + n_max * n_max))
    out["masked"] = dict(line, lanes_equal=lanes, shared_rows_equal=shared,
                         ms=median_ms(lambda: mixed.masked_gram_cuda(
                             x, st.n, p.sigma2, p.rho, p.noise2, cm, km)),
                         plain_ms=median_ms(lambda: ref.pad_identity(
                             ref.mixed_gram(x, x, p.sigma2, p.rho, cm, km),
                             st.n, p.noise2), reps=5),
                         bound_ms=b_ms, bound_by=b_by)
    del got, k, plain, exact
    if not (ok and lanes and shared):
        raise AssertionError(f"stacked masks, masked gram: {out['masked']}")

    # The fused EI at the batched suggest's shapes.
    r = eng.cfg.acq.restarts
    cand = project_units(torch.rand((n_studies, r, d), generator=gen,
                                    device=x.device), desc)
    args = stacked_engine_args(eng, cand)

    def mixed_plain(a):
        return plain_ei(a, cm, km)

    line = held_ei("stacked masks", lambda a: acq.fused_ei_grad_mixed_cuda(
        *a, cm, km), mixed_plain, args, km[:, None, :])
    ei, grad = acq.fused_ei_grad_mixed_cuda(*args, cm, km)
    lanes = True
    for s in range(n_studies):
        e1, g1 = acq.fused_ei_grad_mixed_cuda(*args, cm[s], km[s])
        lanes = lanes and torch.equal(ei[s], e1[s]) and torch.equal(grad[s],
                                                                    g1[s])
    shared = all(torch.equal(a, b) for a, b in zip(
        acq.fused_ei_grad_mixed_cuda(*args, same_cm, same_km),
        acq.fused_ei_grad_mixed_cuda(*args, cm[0], km[0])))
    b_ms, b_by = bound(n_studies * r * (2.0 * n_max * n_max
                                        + n_max * (8 * d + 45)),
                       4 * n_studies * (r * d + n_max * d + 2 * d
                                        + 2 * n_max + n_max * n_max + r
                                        + r * d))
    out["fused_ei"] = dict(line, lanes_equal=lanes, shared_rows_equal=shared,
                           max_abs_err=max(line["ei_max_abs_err"],
                                           line["grad_max_abs_err"]),
                           ms=median_ms(lambda: acq.fused_ei_grad_mixed_cuda(
                               *args, cm, km)),
                           plain_ms=median_ms(lambda: mixed_plain(args)),
                           bound_ms=b_ms, bound_by=b_by,
                           plan=dataclasses.asdict(acq.call_plan(
                               n_studies, r, n_max, d, True)))
    if not (lanes and shared):
        raise AssertionError(f"stacked masks, fused EI: {out['fused_ei']}")
    line = {"phase": "kernels", "kernel": "per-study masks",
            "shape": f"S={n_studies}, n={n_max}, d={d}, r={r}",
            "n": [int(v) for v in st.n.cpu()], "tol": TOL_MATERN,
            "tol_ei": TOL_EI, **out}
    emit(line)
    return out


def lane_parity(eng, studies, units, gen) -> dict:
    """One advance with every study flagged and explicit seeds, against the
    existing single-study path on each lane's snapshot (`study_state`)
    with the same observation and seeds: `gp.append` then
    `optimize_acquisition`, one study after another.  Holds each lane's
    suggestion, l_buf, li_buf and alpha to the single-study path's and
    times both ways (host clock around `torch.cuda.synchronize()`): the
    batched round against 16 single-study appends and suggests.  `bits`
    lists the lanes whose suggestion, leaves (the append) or ascent (the
    single-study suggest on the batched lane's own state) are not bit for
    bit the single-study path's."""
    from repro_torch.core import acquisition as acq_mod
    from repro_torch.core import gp
    from repro_torch.core.descriptor import index_descriptor
    from repro_torch.core.kernels import KERNELS, make_mixed_kernel
    n_studies, dim = eng.n_studies, eng.dim
    flags = np.ones(n_studies, bool)
    if lag_due(eng, flags):
        raise AssertionError("lane parity: a lag event is due this round")
    xs = units[:, 0].cpu().numpy()
    ys = np.array([st.objective(xs[s:s + 1])[0]
                   for s, st in enumerate(studies)], np.float32)
    snaps = [eng.study_state(s) for s in range(n_studies)]
    seeds = torch.rand((n_studies, eng.cfg.acq.restarts, dim), generator=gen,
                       device=units.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_u, got_v = eng.advance(flags, xs, ys, seeds=seeds)
    torch.cuda.synchronize()
    batched_ms = 1e3 * (time.perf_counter() - t0)

    def kernel_of(s):
        if eng.desc is None:
            return KERNELS[eng.cfg.kernel]
        return make_mixed_kernel(eng.desc.cont_mask[s], eng.desc.cat_mask[s])

    lo = torch.zeros(dim, device=units.device)
    hi = torch.ones(dim, device=units.device)
    xs_dev = torch.as_tensor(xs, device=units.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    singles = []
    for s in range(n_studies):
        kern = kernel_of(s)
        st = gp.append(snaps[s], kern, xs_dev[s], float(ys[s]))
        u, v = acq_mod.optimize_acquisition(
            st, kern, lo, hi, eng.cfg.acq, seeds=seeds[s],
            desc=None if eng.desc is None else index_descriptor(eng.desc, s))
        singles.append((st, u, v))
    torch.cuda.synchronize()
    sequential_ms = 1e3 * (time.perf_counter() - t0)
    worst = {"suggest": 0.0, "l_buf": 0.0, "li_buf": 0.0, "alpha": 0.0}
    diverged = []
    for s, (st, u, v) in enumerate(singles):
        lane = eng.study_state(s)
        dev_u = float((got_u[s] - u).abs().max())
        if dev_u > TOL_LANE_SUGGEST:
            # Another basin: the batched value must be the single-study EI
            # at the batched point (held to it as `held_to_plain` holds a
            # kernel, with its float64 rule).
            args = ei_args(st, got_u[s])
            at_point, _ = acq_mod.ei_value_and_grad(
                st, kernel_of(s), got_u[s], eng.cfg.acq)
            cm = km = None
            if eng.desc is not None:
                cm, km = eng.desc.cont_mask[s], eng.desc.cat_mask[s]
            exact, _ = plain_ei([a.double() for a in args], cm, km)
            ok, held = held_to_plain(got_v[s], at_point, exact, TOL_EI)
            diverged.append({"lane": s, "dev": dev_u,
                             "ei_batched": float(got_v[s, 0]),
                             "ei_single": float(v[0]),
                             "ei_single_at_batched_point": float(at_point[0]),
                             "held": ok})
            if not ok:
                raise AssertionError(f"lane {s}: suggestion off by {dev_u}, "
                                     f"its value not the single-study EI "
                                     f"there: {diverged[-1]}, {held}")
        else:
            worst["suggest"] = max(worst["suggest"], dev_u)
        for leaf in ("l_buf", "li_buf", "alpha"):
            a, b = getattr(lane, leaf), getattr(st, leaf)
            worst[leaf] = max(worst[leaf], float((a - b).abs().max()
                                                 / b.abs().max()))
        if (lane.n, lane.since_refit) != (st.n, st.since_refit):
            raise AssertionError(f"lane {s}: counters {lane.n} vs {st.n}")
    # Where a lane is not bit for bit the single-study step, which half
    # differs: the append (the lane's leaves against `gp.append`'s), or the
    # ascent (the single-study suggest on the batched lane's own state).
    bits = {"suggest_unequal_lanes": [], "append_unequal_lanes": [],
            "ascent_unequal_lanes": []}
    for s, (st, u, _) in enumerate(singles):
        lane = eng.study_state(s)
        if not torch.equal(got_u[s], u):
            bits["suggest_unequal_lanes"].append(s)
        if not all(torch.equal(getattr(lane, k), getattr(st, k))
                   for k in ("x_buf", "y_buf", "l_buf", "li_buf", "alpha")):
            bits["append_unequal_lanes"].append(s)
        own_u, _ = acq_mod.optimize_acquisition(
            lane, kernel_of(s), lo, hi, eng.cfg.acq, seeds=seeds[s],
            desc=None if eng.desc is None else index_descriptor(eng.desc, s))
        if not torch.equal(got_u[s], own_u):
            bits["ascent_unequal_lanes"].append(s)
    at_seeds = ei_at_seeds(eng, seeds)
    if not (worst["l_buf"] <= TOL_LANE_FACTOR
            and worst["li_buf"] <= TOL_LANE_INVERSE
            and worst["alpha"] <= TOL_LANE_INVERSE
            and len(diverged) <= n_studies // 4):
        raise AssertionError(f"lane parity: {worst}, diverged {diverged}")
    return {"max_dev": worst, "diverged_lanes": len(diverged),
            "diverged": diverged, "bits": bits, "at_seeds": at_seeds, "tol": {
                "suggest": TOL_LANE_SUGGEST, "l_buf": TOL_LANE_FACTOR,
                "li_buf_alpha": TOL_LANE_INVERSE},
            "batched_round_ms": batched_ms,
            "sequential_ms": sequential_ms,
            "sequential_over_batched": sequential_ms / batched_ms}, got_u


def ei_at_seeds(eng, seeds) -> dict:
    """Every lane's fused EI value and gradient at its restart seeds
    (projected onto its lattice, as the ascent starts): one launch over all
    S lanes of the engine's state, against one launch on that lane alone
    with the same operands (the lane's rows of the stacked ones).  The two
    must be torch.equal, with the same k-split in their `acq.call_plan`
    (slices and k-tiles a slice): a lane of the batch is summed in the
    single launch's order.  Also held: the lane's own hoist
    (`_make_eval_batch` on the lane's views, as the single-study path
    computes A, f_best and the mean) gives the same bits as the batched
    suggest's operands (`own_hoist_unequal_lanes` empty)."""
    from repro_torch.core import acquisition as acq_mod
    from repro_torch.core.descriptor import project_units
    from repro_torch.kernels import acq
    st, cfg = eng.state, eng.cfg.acq
    x0 = seeds if eng.desc is None else project_units(seeds, eng.desc)
    args = stacked_engine_args(eng, x0)
    masks = () if eng.desc is None else (eng.desc.cont_mask, eng.desc.cat_mask)
    launch = acq.fused_ei_grad_cuda if not masks else \
        acq.fused_ei_grad_mixed_cuda
    v_all, g_all = launch(*args, *masks)
    r, d, mixed = x0.shape[1], eng.dim, eng.desc is not None
    plans = {b: acq.call_plan(b, r, st.n_max, d, mixed)
             for b in (1, eng.n_studies)}
    same_split = all((p.rows, p.slices, p.tiles_per_slice)
                     == (plans[1].rows, plans[1].slices,
                         plans[1].tiles_per_slice)
                     for p in plans.values())
    lanes, unequal, own_unequal = {}, [], []
    for s in range(eng.n_studies):
        v1, g1 = launch(*(a[s] for a in args), *(m[s] for m in masks))
        equal = bool(torch.equal(v_all[s], v1) and torch.equal(g_all[s], g1))
        own = acq_mod._make_eval_batch(eng._lane(s), eng._kernel_for(s), cfg,
                                       True)
        vo, go = own(x0[s])
        own_equal = bool(torch.equal(v_all[s], vo) and torch.equal(g_all[s], go))
        if not equal:
            unequal.append(s)
        if not own_equal:
            own_unequal.append(s)
            lanes[s] = {"own_hoist_ei_max_abs_diff": max_abs(v_all[s], vo),
                        "own_hoist_grad_max_abs_diff": max_abs(g_all[s], go)}
    out = {"lanes_equal_to_single_launch": not unequal,
           "unequal_lanes": unequal, "same_k_split": same_split,
           "plan_s1": {"rows": plans[1].rows, "slices": plans[1].slices,
                       "tiles_per_slice": plans[1].tiles_per_slice,
                       "grid": list(plans[1].grid)},
           f"plan_s{eng.n_studies}": {
               "rows": plans[eng.n_studies].rows,
               "slices": plans[eng.n_studies].slices,
               "tiles_per_slice": plans[eng.n_studies].tiles_per_slice,
               "grid": list(plans[eng.n_studies].grid)},
           "own_hoist_unequal_lanes": own_unequal, "own_hoist": lanes}
    if unequal or not same_split or own_unequal:
        raise AssertionError(f"fused EI at the seeds: lanes {unequal} of the "
                             f"S = {eng.n_studies} launch differ from their "
                             f"single launches, lanes {own_unequal} from "
                             f"their own hoist: {out}")
    return out


def hoist_times(eng) -> dict:
    """The batched suggest's hoist on the engine's state, by CUDA events
    (median of 20) and host clock: lane by lane (`acquisition.hoist`, the
    suggest's own) beside the batched form it replaced (one (S, n_max,
    n_max) GEMM and (S, n_max) reductions over the device counts)."""
    from repro_torch.core import acquisition as acq_mod
    from repro_torch.core import gp
    st, cfg = eng.state, eng.cfg.acq

    def lanes():
        acq_mod.hoist(st, cfg, eng._n_host)

    def batched():
        gp._active_mask(st).to(st.x_buf.dtype)
        st.li_buf.transpose(-1, -2) @ st.li_buf
        gp._ymean(st) - acq_mod._f_best(st) - cfg.xi

    return {"lane_by_lane_ms": median_ms(lanes),
            "batched_form_ms": median_ms(batched),
            "lane_by_lane_host_ms": host_ms(lanes),
            "batched_form_host_ms": host_ms(batched)}


def batched_forms(dev) -> dict:
    """Informational: which batched forms of the engine's per-lane work
    are, lane by lane, bit for bit the single-study calls on this card
    (random data at the engine's shapes, S = 16, n_max = 1024): the
    self-covariance (Matérn and mixed, d = 5 and 6), the masked mean's
    sum, the append's products (q = L^-1 p, q.q, q^T L^-1) and the hoist's
    A = L^-T L^-1.  Lists the lanes that differ; why the engine runs
    these lane by lane."""
    from repro_torch.core.kernels import KernelParams, make_mixed_kernel
    from repro_torch.core.kernels import matern52
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    n_studies, n = ENGINE_STUDIES, N_MAX
    out = {}

    def differ(name, batched, single):
        out[name] = [s for s in range(n_studies)
                     if not torch.equal(batched[s], single(s))]

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    for d in (DIM, MIXED_DIM):
        xs = rand(n_studies, d)
        p = KernelParams(rand(n_studies) + 0.5, rand(n_studies) * 0.5 + 0.05,
                         torch.full((n_studies,), 1e-5, device=dev))

        def lane(s):
            return KernelParams(p.sigma2[s], p.rho[s], p.noise2[s])

        cm = (rand(n_studies, d) > 0.4).float()
        for tag, kern, one in (
                ("matern", matern52, lambda s: matern52),
                ("mixed", make_mixed_kernel(cm, 1.0 - cm),
                 lambda s: make_mixed_kernel(cm[s], 1.0 - cm[s]))):
            differ(f"self-covariance {tag} d={d}",
                   kern(xs[:, None, :], xs[:, None, :], p)[:, 0, 0],
                   lambda s: one(s)(xs[s][None], xs[s][None], lane(s))[0, 0])
    li = torch.tril(torch.randn((n_studies, n, n), generator=gen,
                                device=dev)) * 0.1
    v = torch.randn((n_studies, n), generator=gen, device=dev)
    q = (li @ v[..., None])[..., 0]
    differ("masked mean's sum", torch.sum(v, dim=-1),
           lambda s: torch.sum(v[s], dim=-1))
    differ("q = L^-1 p", q, lambda s: li[s] @ v[s])
    differ("q.q", torch.sum(q * q, dim=-1), lambda s: q[s] @ q[s])
    differ("q^T L^-1", (q[:, None, :] @ li)[:, 0, :], lambda s: q[s] @ li[s])
    differ("A = L^-T L^-1", li.transpose(-1, -2) @ li,
           lambda s: li[s].transpose(-1, -2) @ li[s])
    return out


def unflagged_round(eng, studies, units) -> dict:
    """One advance with the odd studies unflagged: every leaf of an
    unflagged lane must stay torch.equal, its counters unchanged."""
    from repro_torch.core import gp
    flags = np.arange(eng.n_studies) % 2 == 0
    xs = units[:, 0].cpu().numpy()
    ys = np.array([st.objective(xs[s:s + 1])[0]
                   for s, st in enumerate(studies)], np.float32)
    before = [eng.study_state(s) for s in range(eng.n_studies)]
    units, _ = eng.advance(flags, xs, ys)
    changed = []
    for s in np.flatnonzero(~flags):
        after = eng.study_state(s)
        same = all(torch.equal(a, b) for a, b in zip(
            gp._leaves(after), gp._leaves(before[s])))
        if not (same and after.n == before[s].n
                and after.since_refit == before[s].since_refit):
            changed.append(int(s))
    grown = all(eng.n(s) == before[s].n + 1 for s in np.flatnonzero(flags))
    if changed or not grown:
        raise AssertionError(f"unflagged lanes changed: {changed}; "
                             f"flagged grown {grown}")
    return {"unflagged": int((~flags).sum()), "unflagged_equal": True}, units


def sync_free_round(eng, studies, units):
    """One advance with every study flagged and no lag event due, under
    `torch.cuda.set_sync_debug_mode("error")`: a device read on the path
    (an .item(), a boolean-mask index, a blocking copy) raises."""
    flags = np.ones(eng.n_studies, bool)
    if lag_due(eng, flags):
        raise AssertionError("sync-free round: a lag event is due")
    xs = units[:, 0].cpu().numpy()
    ys = np.array([st.objective(xs[s:s + 1])[0]
                   for s, st in enumerate(studies)], np.float32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        units, _ = eng.advance(flags, xs, ys)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return units


def engine_path(dev, mixed: bool):
    """Phases engine and engine_mixed: the port's `StudyEngine` at full
    width (n_max = 1024, 16 studies, SchedulerConfig's acquisition: 48
    restarts x 20 steps, lag 32, top_t 1).  Study s is prefilled through
    `absorb_round` to 960 - 8 s points of its own (so lag events fall in
    different rounds and the append sees ragged n), then 32 `advance`
    rounds run with every study flagged, each absorbing the last round's
    suggestions.  The mixed engine stacks 8 studies of the mixed workload
    and 8 Levy-6d studies, and halfway swaps slot 15 to the mixed layout
    (`reset_slot` + `set_desc`, as a gateway takes a new tenant).  Every
    counter is set to 0 before the prefill and read after the last round;
    each round's launches must be exactly 21 fused EI, one column gram,
    and per lag event of a flagged study two masked grams, two factors and
    two L X = I (the grid of 18, then the refactor), the general solve 0.
    Every mixed suggestion must lie on its study's lattice.  Returns the
    counts, the engine, its studies, its last suggestions and its line."""
    from repro_torch.hpo.engine import StudyEngine
    from repro_torch.hpo.pool import SchedulerConfig
    name = "engine_mixed" if mixed else "engine"
    studies = engine_studies(mixed)
    dim = studies[0].space.dim
    cfg = SchedulerConfig(n_max=N_MAX, lag=LAG)
    steps = cfg.acq.ascent_steps
    eng = StudyEngine(dim, cfg, ENGINE_STUDIES,
                      [st.space.descriptor() for st in studies]
                      if mixed else None)
    sizes = [N_SEED - ENGINE_SPREAD * s for s in range(ENGINE_STUDIES)]
    points = [st.space.sample(np.random.default_rng(100 + s), sizes[s])
              for s, st in enumerate(studies)]
    values = [st.objective(p) for st, p in zip(studies, points)]
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    prefill_refits = 0
    for r in range(max(sizes)):
        flags = np.array([r < k for k in sizes])
        pick = [min(r, k - 1) for k in sizes]
        xs = np.stack([p[i] for p, i in zip(points, pick)])
        ys = np.array([v[i] for v, i in zip(values, pick)], np.float32)
        prefill_refits += lag_due(eng, flags)
        eng.absorb_round(flags, xs, ys)
    eng.sync()
    prefill_s = time.perf_counter() - t0
    counts = read_counts()
    want = engine_counts(mixed, max(sizes), prefill_refits, 0, steps)
    if counts != want:
        raise AssertionError(f"{name} prefill: launches {counts}, "
                             f"expected {want}")
    if [eng.n(s) for s in range(ENGINE_STUDIES)] != sizes:
        raise AssertionError(f"{name}: prefill n "
                             f"{[eng.n(s) for s in range(ENGINE_STUDIES)]}")

    units, _ = eng.suggest_all()
    flags = np.ones(ENGINE_STUDIES, bool)
    rng = np.random.default_rng(7)
    round_ms, round_due, off, swapped = [], [], 0, None
    for r in range(ENGINE_ROUNDS):
        xs = units[:, 0].cpu().numpy()
        off += sum(int((st.space.project(xs[s]) != xs[s]).any())
                   for s, st in enumerate(studies))
        if mixed and r == ENGINE_ROUNDS // 2:
            # A new tenant in slot 15, with the other layout: the slot is
            # blanked, its descriptor row written; its first observation
            # is a point of its own lattice.
            swapped = ENGINE_STUDIES - 1
            studies[swapped] = studies[0]
            eng.reset_slot(swapped)
            eng.set_desc(swapped, studies[swapped].space.descriptor())
            xs[swapped] = studies[swapped].space.sample(rng, 1)[0]
        ys = np.array([st.objective(xs[s:s + 1])[0]
                       for s, st in enumerate(studies)], np.float32)
        due = lag_due(eng, flags)
        before = read_counts()
        t0 = time.perf_counter()
        units, vals = eng.advance(flags, xs, ys)
        torch.cuda.synchronize()
        round_ms.append(1e3 * (time.perf_counter() - t0))
        got = diff_counts(read_counts(), before)
        want = engine_counts(mixed, 1, due, 1, steps)
        if got != want:
            raise AssertionError(f"{name} round {r}: launches {got}, "
                                 f"expected {want}")
        round_due.append(due)
    totals = read_counts()
    refits = sum(round_due)
    xs = units[:, 0].cpu().numpy()
    off += sum(int((st.space.project(xs[s]) != xs[s]).any())
               for s, st in enumerate(studies))
    if off:
        raise AssertionError(f"{name}: {off} suggestions off their lattice")
    want = engine_counts(mixed, max(sizes) + ENGINE_ROUNDS,
                         prefill_refits + refits, 1 + ENGINE_ROUNDS, steps)
    if totals != want:
        raise AssertionError(f"{name}: launches {totals}, expected {want}")
    vals = vals.cpu()
    if not (torch.isfinite(units).all() and torch.isfinite(vals).all()):
        raise AssertionError(f"{name}: non-finite suggestions")
    calm = [ms for ms, due in zip(round_ms, round_due) if not due]
    line = {"phase": name, "studies": ENGINE_STUDIES, "n_max": N_MAX,
            "dim": dim, "layouts": [st.tag for st in studies],
            "n_prefill": [sizes[0], sizes[-1]], "prefill_seconds": prefill_s,
            "prefill_refits": prefill_refits, "rounds": ENGINE_ROUNDS,
            "round_refits": refits, "launches": totals,
            "per_round_launches": engine_counts(mixed, 1, 0, 1, steps),
            "swapped_slot": swapped, "points_off_lattice": off,
            "n_final": [eng.n(s) for s in range(ENGINE_STUDIES)],
            "clamp_counts": eng.clamp_counts().tolist(),
            "ei_zero_last_round": int((vals == 0).sum()),
            "advance_ms": {"median": statistics.median(calm),
                           "mean": statistics.fmean(calm),
                           "min": min(calm), "max": max(calm),
                           "rounds_without_lag_event": len(calm),
                           "by_round": round_ms, "lag_events_by_round":
                           round_due}}
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    if mixed:
        line["stacked_masks"] = stacked_mask_checks(eng, gen)
    line["lane_parity"], units = lane_parity(eng, studies, units, gen)
    line["hoist"] = hoist_times(eng)
    more, units = unflagged_round(eng, studies, units)
    line.update(more)
    units = sync_free_round(eng, studies, units)
    line["sync_free_round"] = "no device sync under set_sync_debug_mode('error')"
    emit(line)
    return totals, eng, studies, units, line


def profile_engine(name, eng, studies, units) -> None:
    """Phase 8: one more advance round of an engine (every study flagged,
    no lag event due) under torch.profiler: device busy and idle time by
    kernel, beside the host clock of the same round."""
    flags = np.ones(eng.n_studies, bool)
    state = {"units": units}

    def round_():
        if lag_due(eng, flags):
            raise AssertionError(f"{name} profile: a lag event is due")
        xs = state["units"][:, 0].cpu().numpy()
        ys = np.array([st.objective(xs[s:s + 1])[0]
                       for s, st in enumerate(studies)], np.float32)
        state["units"], _ = eng.advance(flags, xs, ys)

    split = device_split(round_)
    t0 = time.perf_counter()
    round_()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    emit({"phase": "profile", "path": name, "round_wall_ms": wall,
          "device_span_ms": split["span_ms"], "device_busy_ms": split["busy_ms"],
          "device_idle_ms": split["idle_ms"],
          "device_busy_share": split["busy_ms"] / wall,
          "by_kernel": split["by_name"][:12]})


# --- the fantasy phases: the q-fantasy protocol on both engines -------------

FANTASY_SLOTS = (4, 12)   # slots that serve q-asks: in the mixed engine slot
# 4 holds the mixed workload and slot 12 Levy-6d
FANTASY_ROUNDS = 4        # advance rounds of the twin script
FANTASY_ASK = 8           # the q of the script's asks
FANTASY_TIMED_Q = (1, 8, 32)   # ask widths timed
FANTASY_TIMED_P = (7, 31)      # refantasize widths timed
FANTASY_GRAM_M = (1, 8, 9, 31, 32)   # gram widths held to the plain version
TIMING_REPS = 3


def fantasy_counts(mixed: bool, steps: int, asked: int = 0, replays: int = 0,
                   liar: str = "mean") -> dict:
    """Launches of fantasy calls: each suggestion of an ask is `steps` + 1
    fused-EI launches, then one gram for the liar's posterior (the mean
    liar only) and one for the fantasy row's column block; a refantasize
    is those two grams for all its points; a truncate launches nothing."""
    counts = engine_counts(mixed, 0, 0, 0, steps)
    gram, ei = ("mixed", "acq_mixed") if mixed else ("matern", "acq")
    per = 2 if liar == "mean" else 1
    counts[gram] = per * (asked + replays)
    counts[ei] = asked * (steps + 1)
    return counts


def add_counts(total: dict, more: dict) -> dict:
    return {k: total[k] + more[k] for k in total}


def lanes_equal(a, b) -> list[int]:
    """Slots of engines a and b whose leaves or counters differ."""
    from repro_torch.core import gp
    out = []
    for s in range(a.n_studies):
        sa, sb = a.study_state(s), b.study_state(s)
        same = all(torch.equal(u, v) for u, v in zip(gp._leaves(sa),
                                                      gp._leaves(sb)))
        if not (same and (sa.n, sa.since_refit) == (sb.n, sb.since_refit)
                and int(a.state.n[s]) == int(b.state.n[s])):
            out.append(s)
    return out


def twin_engine(eng):
    """A second engine with eng's configuration, each slot loaded from
    eng's `study_state` snapshot (and, mixed, its descriptor row): bit for
    bit eng's state, no second prefill."""
    from repro_torch.core.descriptor import index_descriptor
    from repro_torch.hpo.engine import StudyEngine
    descs = None
    if eng.desc is not None:
        descs = [index_descriptor(eng.desc, s) for s in range(eng.n_studies)]
    twin = StudyEngine(eng.dim, eng.cfg, eng.n_studies, descs)
    for s in range(eng.n_studies):
        twin.load_slot(s, eng.study_state(s))
    if lanes_equal(eng, twin):
        raise AssertionError("twin engine: loaded lanes differ")
    return twin


class FantasySlot:
    """The pool's fantasy bookkeeping for one slot (pending points in
    append order; the rollback before a real append, the replay after),
    with each engine call held to its exact launches."""

    def __init__(self, run, eng, study: int, space, mixed: bool):
        self.run, self.eng, self.study = run, eng, study
        self.space, self.mixed, self.points = space, mixed, []

    def ask(self, q: int, sync_free: bool = False) -> torch.Tensor:
        """ask_q(q); `sync_free` runs it under set_sync_debug_mode("error"),
        so a device read on its path raises."""
        def call():
            if not sync_free:
                return self.eng.ask_q(self.study, q)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return self.eng.ask_q(self.study, q)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        steps = self.eng.cfg.acq.ascent_steps
        units, vals = self.run(call, fantasy_counts(self.mixed, steps,
                                                    asked=q))
        check_asked(units, vals, self.space)
        self.points.extend(units.cpu().numpy())
        return units

    def rollback(self) -> None:
        if self.points:
            n_real = self.eng.n(self.study) - len(self.points)
            self.run(lambda: self.eng.truncate_slot(self.study, n_real),
                     fantasy_counts(self.mixed, 0))

    def replay(self) -> None:
        if self.points:
            self.run(lambda: self.eng.refantasize(self.study,
                                                  np.stack(self.points)),
                     fantasy_counts(self.mixed, 0, replays=1))

    def take(self, i: int) -> np.ndarray:
        return self.points.pop(i % len(self.points))


def check_asked(units, vals, space) -> None:
    """One ask's points: finite, pairwise distinct, on the slot's lattice."""
    u = units.cpu().numpy()
    if not (np.isfinite(u).all() and torch.isfinite(vals).all()):
        raise AssertionError("ask_q: non-finite points or values")
    if len({tuple(row) for row in u.tolist()}) != u.shape[0]:
        raise AssertionError(f"ask_q: {u.shape[0]} points not distinct")
    if not np.array_equal(space.project(u), u):
        raise AssertionError("ask_q: points off the slot's lattice")


def expansion_bound(x, y, params, exact, cont_mask=None, cat_mask=None):
    """Elementwise bound of the float32 error of a Matérn (or mixed) gram
    built by the expansion |x|^2 + |y|^2 - 2 x.y, as both the kernel and
    the plain version build it: the squared distance carries at most
    gamma (|x| + |y|)^2 of round-off, gamma = (d + 2) 2^-24, which moves K
    by |dK/dsq| = sigma2 5 / (6 rho^2) (1 + z) e^-z (twice that, for the
    slope between the exact and the rounded distance), the categorical
    factor by K / (2 rho) times its own; plus 16 ulps of sigma2 for the
    epilogue.  `exact` is K in float64."""
    u = 2.0 ** -24
    gamma = (x.shape[-1] + 2) * u
    x, y = x.double(), y.double()
    s2, rho = params.sigma2.double(), params.rho.double()
    cm = 1.0 if cont_mask is None else cont_mask.double()
    xc, yc = x * cm, y * cm
    sq = torch.cdist(xc, yc) ** 2
    z = math.sqrt(5.0) * torch.sqrt(sq) / rho
    size = (xc.norm(dim=-1)[:, None] + yc.norm(dim=-1)[None, :]) ** 2
    out = 2.0 * s2 * 5.0 / (6.0 * rho * rho) * (1.0 + z) * torch.exp(-z) \
        * gamma * size + 16.0 * u * s2
    if cat_mask is not None:
        km = cat_mask.double()
        sizek = ((x * km).norm(dim=-1)[:, None]
                 + (y * km).norm(dim=-1)[None, :]) ** 2
        out = out + exact.abs() / (2.0 * rho) * gamma * sizek
    return out


def fantasy_gram_shapes(eng, study: int) -> dict:
    """The gram launches of the fantasy path at n_max = 1024: a point
    buffer against m = 1 (an ask's step), 8, 9 (past the column layout),
    31 and 32 (replays) points, through `ops.kernel_gram`, twice: on the
    kernels phase's inputs (`gram_forms`: sigma2 1, rho 0.25), held to the
    plain version at TOL_MATERN (or `held_to_plain`'s float64 rule); and
    on the slot's own points and refit params, where rho can be 0.05 and
    the expansion's round-off is amplified 400-fold, each element of the
    kernel and of the plain version within `expansion_bound` of float64."""
    from repro_torch.core.descriptor import project_units
    from repro_torch.kernels import matern, ops
    form = gram_forms(eng.device)["mixed_gram" if eng.mixed
                                  else "matern52_gram"]
    st, kern = eng.study_state(study), eng._kernel_for(study)
    masks = ((kern.cont_mask, kern.cat_mask) if eng.mixed else ())
    p = st.params
    p64 = type(p)(p.sigma2.double(), p.rho.double(), p.noise2.double())
    gen = torch.Generator(device=st.device)
    gen.manual_seed(21)
    out = {}
    for m in FANTASY_GRAM_M:
        y = torch.rand((m, eng.dim), generator=gen, device=st.device)
        if eng.mixed:
            y = project_units(y, eng._desc_for(study))
        x, fp = form["x"], form["params"]
        got = ops.kernel_gram(form["kern"], x, y, fp)
        ok, res = held_to_plain(
            got, form["plain"](x, y, fp.sigma2, fp.rho),
            form["plain"](x.double(), y.double(), fp.sigma2.double(),
                          fp.rho.double()), TOL_MATERN)
        ok = ok or res["kernel_err_vs_f64"] <= 2.0 * res["plain_err_vs_f64"]
        got = ops.kernel_gram(kern, st.x_buf, y, p)
        plain = kern(st.x_buf, y, p)
        exact = kern(st.x_buf.double(), y.double(), p64)
        room = expansion_bound(st.x_buf, y, p, exact, *masks)
        over = {name: float(((v.double() - exact).abs() / room).max())
                for name, v in (("kernel", got), ("plain", plain))}
        if not ok or max(over.values()) > 1.0:
            raise AssertionError(f"fantasy gram m = {m}: {res}, "
                                 f"error over bound {over}")
        d, nm = eng.dim, st.n_max
        b_ms, b_by = (bound(nm * m * (4 * d + 20), 4 * (nm * d + m * d + 2 * d
                                                         + nm * m))
                      if eng.mixed else
                      bound(nm * m * (2 * d + 15), 4 * (nm * d + m * d + nm * m)))
        out[f"{st.n_max}x{m}"] = dict(
            **res, layout=matern.launch_plan(st.n_max, m, eng.dim, 1, False,
                                             False).layout,
            ms=median_ms(lambda: ops.kernel_gram(kern, st.x_buf, y, p)),
            plain_ms=median_ms(lambda: kern(st.x_buf, y, p)),
            bound_ms=b_ms, bound_by=b_by,
            slot_params={"sigma2": float(p.sigma2), "rho": float(p.rho)},
            slot_max_abs_err=max_abs(got, plain),
            slot_err_over_bound=over)
    return out


def host_ms(fn, reps: int = TIMING_REPS, after=None) -> float:
    """Median host-clock ms of `fn` (ended by `torch.cuda.synchronize()`),
    `after` run untimed between repeats."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        if after is not None:
            after()
    return statistics.median(times)


def fantasy_times(eng, study: int) -> dict:
    """Informational: ask_q at q = 1, 8, 32 (each rolled back after)
    beside q routed suggests on the same slot, one truncate_slot after an
    ask_q(8), and refantasize at p = 7 and 31."""
    n_real = eng.n(study)

    def back():
        eng.truncate_slot(study, n_real)

    suggest_ms = host_ms(lambda: eng.suggest(study))
    asks = {}
    for q in FANTASY_TIMED_Q:
        ms = host_ms(lambda: eng.ask_q(study, q), after=back)
        asks[str(q)] = {"ask_q_ms": ms, "per_suggestion_ms": ms / q,
                        "q_routed_suggests_ms": q * suggest_ms}
    truncs = []
    for _ in range(TIMING_REPS):
        eng.ask_q(study, FANTASY_ASK)
        truncs.append(host_ms(back, reps=1))
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(22)
    points = torch.rand((max(FANTASY_TIMED_P), eng.dim), generator=gen,
                        device=eng.device)
    if eng.desc is not None:
        from repro_torch.core.descriptor import project_units
        points = project_units(points, eng._desc_for(study))
    replays = {str(p): host_ms(lambda: eng.refantasize(study, points[:p]),
                               after=back) for p in FANTASY_TIMED_P}
    if eng.n(study) != n_real:
        raise AssertionError("fantasy times: the slot was not rolled back")
    return {"routed_suggest_ms": suggest_ms, "ask_q": asks,
            "truncate_slot_ms": statistics.median(truncs),
            "refantasize_ms": replays}


def profile_fantasy(name, eng, study: int) -> None:
    """One ask_q(8) (rolled back after) under torch.profiler, device busy
    time by kernel beside its host clock; run just before the fantasy
    phase of its engine, after every other profile check."""
    n_real = eng.n(study)

    def back():
        eng.truncate_slot(study, n_real)

    split = device_split(lambda: (eng.ask_q(study, FANTASY_ASK), back()))
    wall = host_ms(lambda: eng.ask_q(study, FANTASY_ASK), reps=1, after=back)
    emit({"phase": "profile", "path": name, "call": f"ask_q({FANTASY_ASK})",
          "wall_ms": wall, "device_span_ms": split["span_ms"],
          "device_busy_ms": split["busy_ms"],
          "device_busy_share": split["busy_ms"] / wall,
          "by_kernel": split["by_name"][:8]})


def fantasy_path(dev, eng, studies, mixed: bool):
    """Phases fantasy and fantasy_mixed, on the engine an engine phase left
    (n_max = 1024, 16 studies, 48 restarts x 20 steps) and a twin loaded
    from its snapshots.  Counted (counters set to 0 first; each call of
    the fantasy engine held to its exact launches, `fantasy_counts` /
    `engine_counts`; the twin's calls counted apart): an ask_q(8) rolled
    back alone (every lane then equal to the twin's), the same with the
    pessimistic liar, an ask_q past capacity (GPCapacityError, every lane
    equal), an ask_q(8) under set_sync_debug_mode("error"), then the twin
    script: 4 advance rounds with every study flagged, the fantasy slots
    rolled back before each and their survivors replayed after, each
    slot's tell one of its pending points out of order (one round a
    foreign point), a release and one more ask_q(2) mid-way, and a drain
    of every survivor through routed absorbs; the twin takes the same
    real tells and no fantasies, and every leaf of every lane must end
    torch.equal to its.  Uncounted: the path's gram shapes against the
    plain version and the times.  Returns (counts, line)."""
    from repro_torch.core import gp
    name = "fantasy_mixed" if mixed else "fantasy"
    steps = eng.cfg.acq.ascent_steps
    t0 = time.perf_counter()
    twin = twin_engine(eng)
    zero = fantasy_counts(mixed, 0)
    a_total, b_total = dict(zero), dict(zero)

    def run(fn, want, total=None):
        total = a_total if total is None else total
        before = read_counts()
        out = fn()
        got = diff_counts(read_counts(), before)
        if got != want:
            raise AssertionError(f"{name}: launches {got}, expected {want}")
        total.update(add_counts(total, got))
        return out

    reset_counts()
    slot, other = (FantasySlot(run, eng, s, studies[s].space, mixed)
                   for s in FANTASY_SLOTS)
    # 1-2. The rollback alone: ask_q(8), truncate_slot, every lane equal.
    slot.ask(FANTASY_ASK)
    slot.rollback()
    slot.points.clear()
    if lanes_equal(eng, twin):
        raise AssertionError(f"{name}: rollback alone: lanes "
                             f"{lanes_equal(eng, twin)} differ")
    cfg = eng.cfg
    eng.cfg = dataclasses.replace(cfg, fantasy=gp.FantasyConfig("pessimistic"))
    run(lambda: eng.ask_q(slot.study, 2),
        fantasy_counts(mixed, steps, asked=2, liar="pessimistic"))
    run(lambda: eng.truncate_slot(slot.study, twin.n(slot.study)), zero)
    eng.cfg = cfg
    # 5. Capacity: the fullest slot cannot take an ask past n_max.
    gp_tier = np.array([eng.tier(s) == 0 for s in range(eng.n_studies)])
    full = int(np.argmax([eng.n(s) if gp_tier[s] else -1
                          for s in range(eng.n_studies)]))
    try:
        run(lambda: eng.ask_q(full, N_MAX - eng.n(full) + 1), zero)
    except gp.GPCapacityError:
        pass
    else:
        raise AssertionError(f"{name}: ask_q past capacity did not raise")
    if lanes_equal(eng, twin):
        raise AssertionError(f"{name}: rollbacks left lanes "
                             f"{lanes_equal(eng, twin)} different")
    # 4. One ask under the sync check: no device read on the path.
    other.ask(FANTASY_ASK, sync_free=True)
    slot.ask(FANTASY_ASK)
    # 3. The twin script (a slot escalated by the neural phase keeps its
    # flag off: its GP lane is frozen).
    flags = gp_tier
    units, _ = run(eng.suggest_all, engine_counts(mixed, 0, 0, 1, steps))
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    rng = np.random.default_rng(24)
    foreign, released = 0, 0
    for r in range(FANTASY_ROUNDS):
        xs = units[:, 0].cpu().numpy()
        for fs in (slot, other):
            fs.rollback()
            if r == 2 and fs is slot:
                xs[fs.study] = fs.space.sample(rng, 1)[0]      # foreign
                foreign += 1
            else:
                xs[fs.study] = fs.take(2 * r + 1)              # out of order
        ys = np.array([st.objective(xs[s:s + 1])[0]
                       for s, st in enumerate(studies)], np.float32)
        seeds = torch.rand((eng.n_studies, cfg.acq.restarts, eng.dim),
                           generator=gen, device=dev)
        due = lag_due(eng, flags)
        want = engine_counts(mixed, 1, due, 1, steps)
        units, _ = run(lambda: eng.advance(flags, xs, ys, seeds=seeds), want)
        run(lambda: twin.advance(flags, xs, ys, seeds=seeds), want, b_total)
        for fs in (slot, other):
            fs.replay()
        if r == 1:
            slot.rollback()
            slot.take(0)                                       # release
            released += 1
            slot.replay()
            slot.ask(2)
    for fs in (slot, other):
        while fs.points:
            fs.rollback()
            x = fs.take(len(fs.points) // 2)
            y = float(studies[fs.study].objective(x[None])[0])
            due = lag_due(eng, np.arange(eng.n_studies) == fs.study)
            want = engine_counts(mixed, 1, due, 0, steps)
            run(lambda: eng.absorb(fs.study, x, y), want)
            run(lambda: twin.absorb(fs.study, x, y), want, b_total)
            fs.replay()
    eng.sync()
    counted = read_counts()
    if counted != add_counts(a_total, b_total):
        raise AssertionError(f"{name}: counters {counted}, calls "
                             f"{a_total} + twin {b_total}")
    differ = lanes_equal(eng, twin)
    if differ:
        raise AssertionError(f"{name}: after the drain lanes {differ} differ "
                             f"from the never-fantasized twin")
    gram, ei = ("mixed", "acq_mixed") if mixed else ("matern", "acq")
    if not (a_total[gram] and a_total[ei]):
        raise AssertionError(f"{name}: the path launched {a_total}")
    line = {"phase": name, "slots": list(FANTASY_SLOTS),
            "n_real": [eng.n(s) for s in FANTASY_SLOTS],
            "rounds": FANTASY_ROUNDS, "foreign_tells": foreign,
            "releases": released, "launches": a_total,
            "twin_launches": b_total,
            "lanes_equal_to_twin": "every leaf of every lane, alpha included",
            "gram_shapes": fantasy_gram_shapes(eng, slot.study),
            "nvidia_smi": nvidia_smi_line(),
            "times": fantasy_times(eng, slot.study)}
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    return a_total, line


# --- the neural phases: the escalation tier on both engines -----------------

NEURAL_ROUNDS = 40        # GP advances beside escalated suggest + absorb
NEURAL_PROBES = 64        # posterior probe points held to float64
NEURAL_BIG_N = 4096       # the second ledger of the flat-in-n suggest
NEURAL_ASK = 8            # nb_ask_q's q
NEURAL_REPLAY = 7         # nb_refantasize's p
NEURAL_PROFILE_STEPS = 10  # refit steps profiled for the kernels a step
NEURAL_KEEP = 32          # rows a GP slot flagged in the neural rounds keeps
# free for the fantasy phase after them; a fuller slot's flag is off
U32 = 2.0 ** -24


NEURAL_ORDERS = (1, 2, 4, 8)   # chunks of each GEMM's contraction in the
# CPU float32 replays that `held_f64_rule` takes the worst of


class ContractionOrder(TorchDispatchMode):
    """Every `mm` / `mv` of the ops run under it summed in `chunks`
    contiguous pieces of its contraction, the partial products added in
    order: a float32 evaluation as exact as the plain one, with its own
    round-off.  Autograd's backward GEMMs pass through it too."""

    def __init__(self, chunks: int):
        super().__init__()
        self.chunks = chunks

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if func in (aten.mm.default, aten.mv.default) and self.chunks > 1:
            a, b = args
            k = a.shape[1]
            if k >= self.chunks:
                out = None
                for idx in torch.arange(k).chunk(self.chunks):
                    lo, hi = int(idx[0]), int(idx[-1]) + 1
                    part = func(a[:, lo:hi], b[lo:hi])
                    out = part if out is None else out + part
                return out
        return func(*args, **(kwargs or {}))


class Tf32Operands(TorchDispatchMode):
    """The negative control of `held_f64_rule`: every float32 operand of
    an `mm` / `mv` rounded to TF32's 10 mantissa bits (to nearest, ties to
    even) before the product, as a TF32 tensor-core GEMM reads it."""

    @staticmethod
    def round_tf32(t: torch.Tensor) -> torch.Tensor:
        if t.dtype != torch.float32:
            return t
        bits = t.contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if func in (aten.mm.default, aten.mv.default):
            args = tuple(self.round_tf32(a) for a in args)
        return func(*args, **(kwargs or {}))


def neural_replay(start, absorbs, ncfg, dtype, device="cpu", mode=None):
    """The escalated slot replayed in `dtype` on `device` from the same
    inputs: the promotion (its ledger and params, one refit) and every
    absorb as `nb_absorb` runs it (growth when full, `nb_append`, a refit
    when `refit_every` appends have gathered); under the dispatch `mode`
    when one is given (`ContractionOrder`, `Tf32Operands`)."""
    from repro_torch.core import neural_basis as nb
    xs, ys, logcs, params = (
        a.to(device) if isinstance(a, torch.Tensor)
        else {k: v.to(device) for k, v in a.items()} for a in start)
    n0, d = xs.shape
    cap = nb.nb_capacity(n0, ncfg)
    st = nb.nb_init(d, cap, ncfg, params=params, device=device)
    st = nb._replace(st, x_buf=torch.cat([xs, xs.new_zeros(cap - n0, d)]),
                     y_buf=torch.cat([ys, ys.new_zeros(cap - n0)]),
                     c_buf=torch.cat([logcs, logcs.new_zeros(cap - n0)]),
                     n=torch.tensor(n0, dtype=torch.int32, device=device))
    st = nb._replace(st, **{k: getattr(st, k).to(dtype) for k in nb.FIELDS
                            if k not in nb.COUNTERS})
    with mode if mode is not None else contextlib.nullcontext():
        st = nb.nb_refit(st, ncfg)
        for x, y, logc in absorbs:
            if int(st.n) == st.cap:
                st = nb.nb_grow(st)
            st = nb.nb_append(st, x.to(device, dtype), y, logc, ncfg)
            if int(st.since_refit) >= ncfg.refit_every:
                st = nb.nb_refit(st, ncfg)
    return st


def cpu32_replays(start, absorbs, ncfg) -> list:
    """The CPU float32 replays `held_f64_rule` reads: one for each
    contraction order of NEURAL_ORDERS (1 is the plain replay, which
    runs outside the dispatch mode: the same products, without the
    mode's Python call on every op)."""
    return [neural_replay(start, absorbs, ncfg, torch.float32,
                          mode=ContractionOrder(c) if c > 1 else None)
            for c in NEURAL_ORDERS]


def held_f64_rule(card, cpu32s, exact, kappa) -> dict:
    """A float32 value (the card's) against the CPU float64 replay: within
    twice the worst error there of the CPU float32 replays `cpu32s`, which
    differ only in the order their GEMMs sum (`ContractionOrder`), or, for
    a value that carries the head's conditioning, within the float32
    perturbation bound 2 kappa(A) 2^-24 max|exact| (A = ptp + noise2 I of
    the float64 run: an ulp of float32 in ptp moves the head's factor and
    weights by about kappa 2^-24 of their size).  The refit's 400 Adam
    steps amplify round-off: CPU replays of one trajectory that differ
    only in summation order land 3.7 to 40 times apart from float64, so
    one replay's error is one draw, and the rule takes the worst of
    several (PERF.md, PR 35)."""
    card = card.double().cpu()
    err = float((card - exact).abs().max())
    errs = [float((c.double() - exact).abs().max()) for c in cpu32s]
    room = 2.0 * kappa * U32 * float(exact.abs().max())
    by = ("2x" if err <= 2.0 * max(errs) else
          "kappa bound" if err <= room else None)
    return {"card_err": err, "cpu32_errs": errs, "bound": room,
            "held_by": by}


def held_neural_state(card, cpu32s, exact, probes, ncfg) -> dict:
    """`held_f64_rule` on chol, w_y, w_c, s2 and the posterior's mean and
    variance at `probes` (on the card's device), kappa of the float64
    run's head."""
    from repro_torch.core import neural_basis as nb
    a64 = exact.ptp + ncfg.noise2 * torch.eye(exact.ptp.shape[0],
                                              dtype=torch.float64)
    kappa = float(torch.linalg.cond(a64))
    held = {k: held_f64_rule(getattr(card, k), [getattr(c, k) for c in
                                                cpu32s], getattr(exact, k),
                             kappa)
            for k in ("chol", "w_y", "w_c", "s2")}
    post = [nb.nb_posterior(c, probes.cpu()) for c in cpu32s]
    for i, (tag, a, c) in enumerate(zip(
            ("mean", "var"), nb.nb_posterior(card, probes.to(card.device)),
            nb.nb_posterior(exact, probes.cpu().double()))):
        held[f"posterior_{tag}"] = held_f64_rule(a, [p[i] for p in post], c,
                                                 kappa)
    return {"kappa": kappa, "held": held}


def profile_neural(name, eng, slot: int) -> dict:
    """One nb_suggest of the escalated slot under torch.profiler (device
    busy share of its host clock), and the device kernels of one refit
    step: a refit of NEURAL_PROFILE_STEPS steps less one of 0 (the head's
    rebuild alone), on the slot's state."""
    from repro_torch.core import neural_basis as nb
    st = eng.nb_state(slot)
    split = device_split(lambda: eng.nb_suggest(slot))
    wall = host_ms(lambda: eng.nb_suggest(slot), reps=1)
    refit = {k: device_split(lambda: nb.nb_refit(st, dataclasses.replace(
        eng.neural, refit_steps=k))) for k in (0, NEURAL_PROFILE_STEPS)}

    def kernels(split_):
        return sum(e["count"] for e in split_["by_name"])
    per_step = (kernels(refit[NEURAL_PROFILE_STEPS]) - kernels(refit[0])) \
        / NEURAL_PROFILE_STEPS
    busy = (refit[NEURAL_PROFILE_STEPS]["busy_ms"] - refit[0]["busy_ms"]) \
        / NEURAL_PROFILE_STEPS
    line = {"phase": "profile", "path": name, "call": "nb_suggest",
            "wall_ms": wall, "device_busy_ms": split["busy_ms"],
            "device_busy_share": split["busy_ms"] / wall,
            "device_kernels": sum(e["count"] for e in split["by_name"]),
            "by_kernel": split["by_name"][:8],
            "refit_kernels_per_step": per_step,
            "refit_device_busy_ms_per_step": busy,
            "refit_step_by_kernel":
                refit[NEURAL_PROFILE_STEPS]["by_name"][:12]}
    emit(line)
    return line


def neural_path(dev, eng, studies, mixed: bool):
    """Phases neural and neural_mixed: the neural-basis tier on the engine
    an engine phase left (16 studies, n_max = 1024, 48 restarts x 20
    steps, `NeuralConfig()`).  The fullest slot (of the mixed workload's
    layout in the mixed engine) is filled to n_max with real tells (costs
    1..3); an ask_q(1) must raise StudySaturatedError and leave its lane
    equal.  It is promoted with params from a seeded generator (ledger
    1024, cap 2048), profiled (`profile_neural`), then 40 rounds each run
    one `advance` of the GP slots (flagged: those with room for the rounds
    and NEURAL_KEEP rows more; the escalated slot's flag 0), held to
    exactly the engine phase's launches, and one `nb_suggest` + `nb_absorb`
    on the escalated slot, which launch no hand kernel; the 32nd absorb
    refits.  Held after the rounds: the frozen GP lane torch.equal to its
    copy from before the promotion; the card's state within the float64
    rule (`held_f64_rule`) of the same absorbs replayed on the CPU (chol,
    w_y, w_c, s2, the posterior at 64 probe points), and the card's replay
    with TF32-rounded GEMM operands (`Tf32Operands`) outside it, on a line
    of its own; nb_ask_q(8) then
    nb_rollback every leaf torch.equal to the snapshot; nb_refantasize at
    p = 7 (rolled back too); nb_grow at n == cap bitwise and zero-padded;
    nb_to_json / nb_from_json bitwise; and no hand kernel launched by any
    of them.  Host-clock times (median of 3).  Returns (counts, line)."""
    from repro_torch.core import gp
    from repro_torch.core import neural_basis as nb
    from repro_torch.core.descriptor import project_units
    name = "neural_mixed" if mixed else "neural"
    t_start = time.perf_counter()
    cfg, ncfg = eng.cfg, eng.neural
    steps, d = cfg.acq.ascent_steps, eng.dim
    slot = max((s for s in range(eng.n_studies) if eng.tier(s) == 0
                and (not mixed or studies[s].tag == "mixed")), key=eng.n)
    space, objective = studies[slot].space, studies[slot].objective
    rng = np.random.default_rng(40)

    # 1. Fill the slot to n_max with real tells, then saturate.
    while eng.n(slot) < N_MAX:
        x = space.sample(rng, 1)[0]
        eng.absorb(slot, x, float(objective(x[None])[0]),
                   cost=float(1.0 + 2.0 * rng.uniform()))
    eng.sync()
    lane = eng.study_state(slot)
    gp_suggest_ms = host_ms(lambda: eng.suggest(slot))
    try:
        eng.ask_q(slot, 1)
    except gp.StudySaturatedError:
        pass
    else:
        raise AssertionError(f"{name}: ask_q on a full slot did not raise")
    if not all(torch.equal(a, b) for a, b in zip(
            gp._leaves(eng.study_state(slot)), gp._leaves(lane))):
        raise AssertionError(f"{name}: the saturated ask changed the lane")

    # 2. Promote (median of 3, each from the same ledger, costs and params).
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    init = nb.nb_init(d, ncfg.cap0, ncfg, generator=gen, device=dev)
    params = {k: getattr(init, k) for k in nb.PARAMS}
    costs = eng.cost_row(slot)

    def promote():
        if eng.tier(slot):
            eng.clear_nb_slot(slot)
            eng.set_cost_row(slot, costs)
        eng.promote_slot(slot, params=params)

    promote_ms = host_ms(promote)
    start = (lane.x_buf[:N_MAX].cpu(), lane.y_buf[:N_MAX].cpu(),
             torch.from_numpy(np.log(np.maximum(costs[:N_MAX], 1e-12))),
             {k: v.cpu() for k, v in params.items()})
    promoted = eng.nb_state(slot)
    if (eng.nb_n(slot), promoted.cap) != (N_MAX, nb.nb_capacity(N_MAX, ncfg)):
        raise AssertionError(f"{name}: promoted {eng.nb_n(slot)} rows, "
                             f"cap {promoted.cap}")
    suggest_ms = {str(N_MAX): host_ms(lambda: eng.nb_suggest(slot))}
    profile = profile_neural(name, eng, slot)

    # 3. The rounds: the GP slots with room for them (and NEURAL_KEEP rows
    # more) flagged, the escalated slot not.
    flags = np.array([eng.tier(s) == 0
                      and eng.n(s) + NEURAL_ROUNDS + NEURAL_KEEP <= N_MAX
                      for s in range(eng.n_studies)])
    if not flags.any():
        raise AssertionError(f"{name}: no GP slot has room for the rounds")
    units, _ = eng.suggest_all()
    absorbs, nb_suggest_times, absorb_times, refits = [], [], [], []
    reset_counts()
    for r in range(NEURAL_ROUNDS):
        xs = units[:, 0].cpu().numpy()
        ys = np.array([st.objective(xs[s:s + 1])[0]
                       for s, st in enumerate(studies)], np.float32)
        due = lag_due(eng, flags)
        before = read_counts()
        units, _ = eng.advance(flags, xs, ys)
        got = diff_counts(read_counts(), before)
        want = engine_counts(mixed, 1, due, 1, steps)
        if got != want:
            raise AssertionError(f"{name} round {r}: launches {got}, "
                                 f"expected {want}")
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, v = eng.nb_suggest(slot)
        torch.cuda.synchronize()
        nb_suggest_times.append(1e3 * (time.perf_counter() - t0))
        x = u[0].cpu().numpy()
        if not (np.isfinite(x).all() and torch.isfinite(v).all()
                and (x >= 0).all() and (x <= 1).all()
                and np.array_equal(space.project(x[None])[0], x)):
            raise AssertionError(f"{name} round {r}: suggestion {x}, {v}")
        y = float(objective(x[None])[0])
        c = float(1.0 + 2.0 * rng.uniform())
        t0 = time.perf_counter()
        eng.nb_absorb(slot, x, y, cost=c)
        torch.cuda.synchronize()
        absorb_times.append(1e3 * (time.perf_counter() - t0))
        refits.append(eng._nb_sr[slot] == 0)
        absorbs.append((torch.from_numpy(x.copy()), y,
                        float(np.float32(np.log(max(c, 1e-12))))))
        got = diff_counts(read_counts(), before)
        if any(got.values()):
            raise AssertionError(f"{name} round {r}: nb_suggest + nb_absorb "
                                 f"launched {got}")
    counts = read_counts()
    if [i + 1 for i, f in enumerate(refits) if f] != [ncfg.refit_every]:
        raise AssertionError(f"{name}: refits after absorbs "
                             f"{[i + 1 for i, f in enumerate(refits) if f]}")
    if not all(torch.equal(a, b) for a, b in zip(
            gp._leaves(eng.study_state(slot)), gp._leaves(lane))):
        raise AssertionError(f"{name}: the frozen GP lane changed")

    # 4. The card's state against the CPU replays.
    card = eng.nb_state(slot)
    exact = neural_replay(start, absorbs, ncfg, torch.float64)
    cpu32s = cpu32_replays(start, absorbs, ncfg)
    cpu32 = cpu32s[0]
    for k in ("x_buf", "y_buf", "c_buf", "n", "since_refit"):
        if not torch.equal(getattr(card, k).cpu(), getattr(cpu32, k)):
            raise AssertionError(f"{name}: ledger {k} differs from the replay")
    probes = torch.rand((NEURAL_PROBES, d), generator=gen, device=dev)
    if mixed:
        probes = project_units(probes, eng._desc_for(slot))
    rule = held_neural_state(card, cpu32s, exact, probes, ncfg)
    kappa, held = rule["kappa"], rule["held"]
    params_ratio = {k: float((getattr(card, k).double().cpu()
                              - getattr(exact, k)).abs().max())
                    / max(float((getattr(cpu32, k).double()
                                 - getattr(exact, k)).abs().max()), 1e-300)
                    for k in nb.PARAMS}
    if not all(h["held_by"] for h in held.values()):
        raise AssertionError(f"{name}: state against float64: {held}")
    # The negative control: the same replay on the card with every GEMM
    # operand rounded to TF32 must leave the rule, wherever the rule can
    # reject anything: where the head's kappa bound lies below the values'
    # own size (the float engine's kappa is about 1e5; the mixed engine's
    # one-hot features give about 7e7, and a bound 8x the values).
    perturbed = neural_replay(start, absorbs, ncfg, torch.float32,
                              device=dev, mode=Tf32Operands())
    control = held_neural_state(perturbed, cpu32s, exact, probes, ncfg)
    control = {k: h["card_err"] for k, h in control["held"].items()
               if not h["held_by"]}
    decisive = 2.0 * kappa * U32 < 1.0
    emit({"phase": name, "part": "f64 rule negative control",
          "perturbation": "GEMM operands rounded to TF32",
          "kappa_head": kappa, "required": decisive,
          "failed_rule": control})
    if decisive and not control:
        raise AssertionError(f"{name}: the TF32-perturbed replay holds the "
                             f"float64 rule")

    # 5. nb_ask_q(8), then nb_rollback: every leaf as it was.
    snap = {k: getattr(card, k).clone() for k in nb.FIELDS}
    n_real = eng.nb_n(slot)

    def as_before() -> bool:
        st = eng.nb_state(slot)
        return eng.nb_n(slot) == n_real and all(
            torch.equal(getattr(st, k), v) for k, v in snap.items())

    asked, vals = eng.nb_ask_q(slot, NEURAL_ASK)
    a = asked.cpu().numpy()
    if not (np.isfinite(a).all() and torch.isfinite(vals).all()
            and (a >= 0).all() and (a <= 1).all()
            and np.array_equal(space.project(a), a)):
        raise AssertionError(f"{name}: nb_ask_q points {a}, values {vals}")
    if eng.nb_n(slot) != n_real + NEURAL_ASK:
        raise AssertionError(f"{name}: nb_ask_q rows {eng.nb_n(slot)}")
    eng.nb_rollback(slot)
    if not as_before():
        raise AssertionError(f"{name}: nb_rollback is not the snapshot")
    back = lambda: eng.nb_rollback(slot)  # noqa: E731
    ask_ms = host_ms(lambda: eng.nb_ask_q(slot, NEURAL_ASK), after=back)
    eng.nb_refantasize(slot, asked[:NEURAL_REPLAY])
    if eng.nb_n(slot) != n_real + NEURAL_REPLAY:
        raise AssertionError(f"{name}: nb_refantasize rows {eng.nb_n(slot)}")
    eng.nb_rollback(slot)
    refantasize_ms = host_ms(
        lambda: eng.nb_refantasize(slot, asked[:NEURAL_REPLAY]), after=back)
    if not as_before():
        raise AssertionError(f"{name}: rollback after the replay")

    # 6. Growth at n == cap, the JSON round trip, the flat-in-n times.
    full = nb.nb_from_data(lane.x_buf, lane.y_buf,
                           np.zeros(N_MAX, np.float32), ncfg, cap=N_MAX,
                           params=params, device=dev)
    grown = nb.nb_grow(full, ncfg)
    kept = all(getattr(grown, k) is getattr(full, k) for k in nb.FIELDS
               if k not in ("x_buf", "y_buf", "c_buf"))
    padded = all(torch.equal(getattr(grown, k)[:N_MAX], getattr(full, k))
                 and not getattr(grown, k)[N_MAX:].any()
                 for k in ("x_buf", "y_buf", "c_buf"))
    if not (kept and padded and grown.cap == 2 * N_MAX):
        raise AssertionError(f"{name}: nb_grow kept {kept}, padded {padded}")
    again = nb.nb_from_json(nb.nb_to_json(card), device=dev)
    if not all(torch.equal(getattr(again, k), getattr(card, k))
               for k in nb.FIELDS):
        raise AssertionError(f"{name}: the JSON round trip changed a leaf")
    big_x = space.sample(rng, NEURAL_BIG_N)
    big = nb.nb_from_data(big_x, objective(big_x),
                          np.zeros(NEURAL_BIG_N, np.float32), ncfg,
                          params=params, device=dev)
    desc = eng._desc_for(slot)
    suggest_ms[str(NEURAL_BIG_N)] = host_ms(
        lambda: nb.nb_suggest(big, desc, acq=cfg.acq, generator=gen))
    refit_ms = {str(N_MAX): host_ms(lambda: nb.nb_refit(promoted, ncfg)),
                str(NEURAL_BIG_N): host_ms(lambda: nb.nb_refit(big, ncfg))}
    if read_counts() != counts:
        raise AssertionError(f"{name}: the nb_* calls launched "
                             f"{diff_counts(read_counts(), counts)}")
    calm = [ms for ms, f in zip(absorb_times, refits) if not f]
    line = {"phase": name, "slot": slot, "layout": studies[slot].tag,
            "neural": dataclasses.asdict(ncfg), "rounds": NEURAL_ROUNDS,
            "ledger": [N_MAX, eng.nb_n(slot)], "cap": card.cap,
            "launches": counts,
            "per_round_launches": engine_counts(mixed, 1, 0, 1, steps),
            "flagged_gp_slots": int(flags.sum()), "nb_launches": 0, "frozen_lane_equal": True,
            "kappa_head": kappa, "held_f64": held,
            "params_err_over_cpu32": params_ratio,
            "ask_distinct_points": len({tuple(r) for r in a.tolist()}),
            "rollback_equal": True, "grow_bitwise": True,
            "json_bitwise": True, "nvidia_smi": nvidia_smi_line(),
            "times_ms": {
                "nb_suggest": suggest_ms,
                "nb_suggest_rounds_median": statistics.median(
                    nb_suggest_times),
                "gp_routed_suggest": {str(N_MAX): gp_suggest_ms},
                "nb_absorb_no_refit": statistics.median(calm),
                "nb_absorb_with_refit": [ms for ms, f in zip(absorb_times,
                                                             refits) if f],
                "nb_refit": refit_ms, "promote_slot": promote_ms,
                f"nb_ask_q({NEURAL_ASK})": ask_ms,
                f"nb_refantasize({NEURAL_REPLAY})": refantasize_ms},
            "profile": {k: profile[k] for k in (
                "device_busy_share", "device_kernels",
                "refit_kernels_per_step", "refit_device_busy_ms_per_step")}}
    line["seconds"] = time.perf_counter() - t_start
    emit(line)
    return counts, line


# --- the pool phases: StudyPool and TrialScheduler at full width ------------

POOL_ROUNDS = 32          # advance_round rounds, every study told
POOL_ASK = 8              # the q of the pool's asks (slots FANTASY_SLOTS)
POOL_EXPORT_SLOT = 7      # the slot round-tripped through export / import
SCHED_BUDGET = 16         # TrialScheduler.run's budget after its prefill
SCHED_PARALLEL = 4


class PoolPair:
    """A StudyPool (a) and its twin (b), built alike and fed the same
    events: a serves through `advance_round`, b through
    `advance_round_begin` + `finish()`; every round's suggestions must be
    equal.  `log` keeps the rounds a ran alone (the profile), which
    `catch_up` replays on b."""

    def __init__(self, name, dev, studies, ckpt_dir):
        from repro_torch.hpo.pool import SchedulerConfig, StudyPool
        self.name, self.dev, self.studies = name, dev, studies
        self.mixed = name.endswith("mixed")
        self.spaces = [st.space for st in studies]
        self.cfg = SchedulerConfig(n_max=N_MAX, lag=LAG, seed=0,
                                   ckpt_dir=ckpt_dir, ckpt_every=10 ** 9)
        self.a = StudyPool(self.spaces, self.cfg, device=dev)
        self.b = StudyPool(self.spaces,
                           dataclasses.replace(self.cfg, ckpt_dir=None),
                           device=dev)
        self.log = []

    def fresh(self):
        from repro_torch.hpo.pool import StudyPool
        return StudyPool(self.spaces, self.cfg, device=self.dev)

    def values(self, out) -> dict:
        """Each study's objective at its first suggestion of `out`."""
        return {s: float(self.studies[s].objective(trs[0].unit[None])[0])
                for s, trs in out.items()}

    def events(self, out, order, vals):
        return [(s, out[s][0], vals[s]) for s in order]

    def step(self, pool, out, order, vals, staged=False, check=None):
        """One round of `pool` telling `out`'s first trials in `order`;
        launches held to the engine phase's when `check` is given."""
        flags = np.ones(pool.n_studies, bool)
        due = lag_due(pool.engine, flags)
        before = read_counts()
        ev = self.events(out, order, vals)
        t0 = time.perf_counter()
        if staged:
            pending = pool.advance_round_begin(ev)
            new = pending.finish()
        else:
            new = pool.advance_round(ev)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if check is not None:
            got = diff_counts(read_counts(), before)
            want = engine_counts(self.mixed, 1, due, 1, check)
            if got != want:
                raise AssertionError(f"{self.name}: round launches {got}, "
                                     f"expected {want}")
        if any(tr.status != "done" for _, tr, _ in ev):
            raise AssertionError(f"{self.name}: told trials not done")
        return new, ms, due

    def catch_up(self, out_b):
        """Replay on b the rounds a ran alone; suggestions equal a's."""
        for order, vals, units in self.log:
            out_b, _, _ = self.step(self.b, out_b, order, vals, staged=True)
            pool_units_equal(self.name, units, out_b)
        self.log = []
        return out_b


def pool_units_equal(name, a, b) -> None:
    """Two rounds' suggestions ({study: [trial]} or {study: units}),
    bit for bit."""
    for s in a:
        ua = a[s] if isinstance(a[s], np.ndarray) else a[s][0].unit
        if not np.array_equal(ua, b[s][0].unit):
            raise AssertionError(f"{name}: study {s} suggestion differs "
                                 f"from its twin's")


def pool_lanes_equal(name, a, b, what) -> None:
    bad = lanes_equal(a.engine, b.engine)
    if bad:
        raise AssertionError(f"{name}: lanes {bad} differ from the twin's "
                             f"({what})")


def pool_prefill(pool, studies, sizes) -> None:
    """Study s's `sizes[s]` points of its own, every event of all studies
    shuffled into one `absorb_many` (one masked round a point of the
    fullest study)."""
    events = []
    for s, st in enumerate(studies):
        pts = st.space.sample(np.random.default_rng(100 + s), sizes[s])
        for p, v in zip(pts, st.objective(pts)):
            events.append((s, pool._make_trial(s, p), float(v)))
    order = np.random.default_rng(200).permutation(len(events))
    pool.absorb_many([events[i] for i in order])


def pool_path(dev, mixed: bool, engine_line: dict):
    """Phases pool and pool_mixed: the port's `StudyPool` over the engine
    phase's 16 studies (n_max = 1024, lag 32, 48 restarts x 20 steps),
    with a twin.  Counts set to 0 before the prefill and read after the
    last round: each pool prefilled through one `absorb_many` of every
    study's points, shuffled (study s to 960 - 8 s), exactly the engine's
    launches (one column gram a masked round, two masked grams, factors and
    L X = I a lag event); then 32 `advance_round` rounds, each telling the
    last round's suggestions in a shuffled order and held to the engine
    phase's launches (21 fused EI, one column gram, plus a due lag
    event's); the twin runs the same rounds as `advance_round_begin` +
    `finish()`, one begin without a lag event under
    `set_sync_debug_mode("error")`, and its suggestions and every leaf of
    every lane must be the pool's.  Returns (counts, pair, line)."""
    import tempfile
    name = "pool_mixed" if mixed else "pool"
    studies = engine_studies(mixed)
    sizes = [N_SEED - ENGINE_SPREAD * s for s in range(ENGINE_STUDIES)]
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_pool_")
    pair = PoolPair(name, dev, studies, ckpt_dir)
    steps = pair.cfg.acq.ascent_steps
    refits = sum(k // LAG for k in sizes)
    want = engine_counts(mixed, max(sizes), refits, 0, steps)
    torch.cuda.synchronize()
    reset_counts()
    prefill_s = []
    for pool in (pair.a, pair.b):
        before = read_counts()
        t0 = time.perf_counter()
        pool_prefill(pool, studies, sizes)
        pool.engine.sync()
        prefill_s.append(time.perf_counter() - t0)
        got = diff_counts(read_counts(), before)
        if got != want:
            raise AssertionError(f"{name} prefill: launches {got}, "
                                 f"expected {want}")
        if [pool.engine.n(s) for s in range(ENGINE_STUDIES)] != sizes:
            raise AssertionError(f"{name}: prefill n")
    before = read_counts()
    out_a, out_b = pair.a.suggest_all(), pair.b.suggest_all()
    got = diff_counts(read_counts(), before)
    if got != engine_counts(mixed, 0, 0, 2, steps):
        raise AssertionError(f"{name}: suggest_all launches {got}")
    pool_units_equal(name, out_a, out_b)
    rng = np.random.default_rng(9)
    round_ms, round_due, sync_free_round = [], [], None
    for r in range(POOL_ROUNDS):
        order = [int(s) for s in rng.permutation(ENGINE_STUDIES)]
        vals = pair.values(out_a)
        out_a, ms, due = pair.step(pair.a, out_a, order, vals, check=steps)
        round_ms.append(ms)
        round_due.append(due)
        due_b = lag_due(pair.b.engine, np.ones(ENGINE_STUDIES, bool))
        if sync_free_round is None and r > 0 and not due_b:
            sync_free_round = r
            ev = pair.events(out_b, order, vals)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending = pair.b.advance_round_begin(ev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            out_b = pending.finish()
        else:
            out_b, _, _ = pair.step(pair.b, out_b, order, vals, staged=True,
                                    check=steps)
        pool_units_equal(name, out_a, out_b)
    counts = read_counts()
    pool_lanes_equal(name, pair.a, pair.b, "after the rounds")
    if sync_free_round is None:
        raise AssertionError(f"{name}: no round without a lag event")
    units = np.stack([out_a[s][0].unit for s in range(ENGINE_STUDIES)])
    off = sum(int((st.space.project(units[s]) != units[s]).any())
              for s, st in enumerate(studies))
    if off or not np.isfinite(units).all():
        raise AssertionError(f"{name}: {off} suggestions off the lattice")
    calm = [ms for ms, due in zip(round_ms, round_due) if not due]
    pair.out = (out_a, out_b)
    line = {"phase": name, "studies": ENGINE_STUDIES, "n_max": N_MAX,
            "layouts": [st.tag for st in studies],
            "n_prefill": [sizes[0], sizes[-1]],
            "prefill_seconds": prefill_s, "rounds": POOL_ROUNDS,
            "round_refits": sum(round_due), "launches": counts,
            "per_round_launches": engine_counts(mixed, 1, 0, 1, steps),
            "twin_begin_finish_equal": True,
            "sync_free_begin_round": sync_free_round,
            "n_final": [pair.a.engine.n(s) for s in range(ENGINE_STUDIES)],
            "advance_round_ms": {
                "median": statistics.median(calm),
                "mean": statistics.fmean(calm), "min": min(calm),
                "max": max(calm), "rounds_without_lag_event": len(calm),
                "by_round": round_ms, "lag_events_by_round": round_due},
            "engine_advance_ms_median": engine_line["advance_ms"]["median"]}
    emit(line)
    return counts, pair, line


# --- the mesh phase: the (study x restart) mesh on logical devices ---------

MESH_SPECS = ("none", "2x1", "1x2", "2x2")
MESH_SPLITS = (2, 4)      # the restart shard's launch: R = 48 split 2, 4 ways
MESH_MIN_ROUNDS = 3       # absorbing rounds at least (more to a lag event)


def mesh_devices(spec: str) -> list[str]:
    """A spec's logical devices, all on the one card."""
    from repro_torch.hpo import mesh as mesh_mod
    parsed = mesh_mod.parse_spec(spec)
    return ["cuda:0"] * (1 if parsed is None else parsed[0] * parsed[1])


def ei_bound(s: int, r: int, n: int, d: int, mixed: bool):
    """The least time of one fused-EI launch on s studies of r candidates
    against n rows of width d (`bound`)."""
    if mixed:
        return bound(s * r * (2.0 * n * n + n * (8 * d + 45)),
                     4 * s * (r * d + n * d + 2 * d + 2 * n + n * n + r
                              + r * d))
    return bound(s * r * (2.0 * n * n + n * (4 * d + 40)),
                 4 * s * (r * d + n * d + 2 * n + n * n + r + r * d))


def restart_shard_checks(eng, gen) -> dict:
    """The restart shard's launch form of the fused EI (`plan_rows=R`) on
    an engine phase's state (the engine's operands, `stacked_engine_args`):
    R = 48 candidates split 2 and 4 ways, at S = 16 and at S = 1 (lane 0).
    Shard 0 is held to the plain version (`held_ei`, TOL_EI); every shard's
    ei and gradient, concatenated in shard order, must be the unsharded
    launch's bits (torch.equal, and their digests); launches counted
    exactly.  Then, uncounted, the CUDA-event ms of shard 0 and of the k
    shards in order beside the unsharded launch's, shard 0's device ms
    (torch.profiler), its plain version's ms and its bound."""
    from repro_torch.core.descriptor import project_units
    from repro_torch.kernels import acq
    mixed, d, r_full = eng.mixed, eng.dim, eng.cfg.acq.restarts
    key = "acq_mixed" if mixed else "acq"
    cand = torch.rand((ENGINE_STUDIES, r_full, d), generator=gen,
                      device=eng.device)
    if mixed:
        cand = project_units(cand, eng.desc)
    args = stacked_engine_args(eng, cand)
    masks = (eng.desc.cont_mask, eng.desc.cat_mask) if mixed else ()

    def launch(a, m, plan_rows=None):
        if mixed:
            return acq.fused_ei_grad_mixed_cuda(*a, *m, plan_rows=plan_rows)
        return acq.fused_ei_grad_cuda(*a, plan_rows=plan_rows)

    out = {}
    for s in (ENGINE_STUDIES, 1):
        a = list(args) if s > 1 else [v[0] for v in args]
        m = masks if s > 1 else tuple(v[0] for v in masks)
        cat = None if not mixed else (m[1][:, None, :] if s > 1 else m[1])

        def rows(k, j):
            r = r_full // k
            return [a[0][..., j * r:(j + 1) * r, :].contiguous(), *a[1:]]

        reset_counts()
        full = launch(a, m)
        want = digest(torch.cat([full[0].reshape(-1), full[1].reshape(-1)]))
        for k in MESH_SPLITS:
            parts = [launch(rows(k, j), m, r_full) for j in range(k)]
            ei = torch.cat([p[0] for p in parts], dim=-1)
            grad = torch.cat([p[1] for p in parts], dim=-2)
            got = digest(torch.cat([ei.reshape(-1), grad.reshape(-1)]))
            equal = bool(torch.equal(ei, full[0])
                         and torch.equal(grad, full[1]))
            held = held_ei(f"restart shard {key} S={s} 1/{k}",
                           lambda x: launch(x, m, r_full),
                           lambda x: plain_ei(x, *m), rows(k, 0), cat)
            if not equal or got != want:
                raise AssertionError(f"restart shard {key} S={s} split {k}: "
                                     f"digest {got}, unsharded {want}")
            plan = acq.call_plan(s, r_full // k, N_MAX, d, mixed, r_full)
            out[f"S={s} 1/{k}"] = {"digest": got, "unsharded_digest": want,
                                   "rows_equal": equal, "rows": plan.rows,
                                   "slices": plan.slices,
                                   "tiles_per_slice": plan.tiles_per_slice,
                                   "grid": list(plan.grid), **held}
        counts = read_counts()
        n_want = 1 + sum(k + 2 for k in MESH_SPLITS)
        if counts[key] != n_want or sum(counts.values()) != n_want:
            raise AssertionError(f"restart shard {key} S={s}: launches "
                                 f"{counts}, expected {n_want} {key}")
        out[f"S={s} launches"] = n_want
        out[f"S={s} unsharded_ms"] = median_ms(lambda: launch(a, m))
        for k in MESH_SPLITS:
            x0 = rows(k, 0)
            b_ms, b_by = ei_bound(s, r_full // k, N_MAX, d, mixed)
            out[f"S={s} 1/{k}"].update({
                "shape": f"{s} x (r = {r_full // k} of {r_full}, n = "
                         f"{N_MAX}, d = {d})",
                "ms": median_ms(lambda: launch(x0, m, r_full)),
                "all_shards_ms": median_ms(lambda: [
                    launch(rows(k, j), m, r_full) for j in range(k)]),
                "device_ms": device_split(
                    lambda: launch(x0, m, r_full))["busy_ms"],
                "plain_ms": median_ms(lambda: plain_ei(x0, *m)),
                "bound_ms": b_ms, "bound_by": b_by})
    return out


def mesh_path(dev, engines) -> tuple[dict, dict]:
    """Phase mesh: `StudyPool`s at mesh "none", "2x1", "1x2" and "2x2" on
    `["cuda:0"] * k`, float and mixed, over the engine phases' 16 studies
    (n_max = 1024, lag 32, 48 restarts x 20 steps): each pool starts from
    a copy of its engine's state as the engine phase left it (prefilled
    to 960 - 8 s, then served), written through `engine.state`, which
    splits it onto the shards; then one suggest round and absorbing
    `advance_round`s up to and past the first lag event.  Every round's
    suggestions and every leaf of the state must be mesh "none"'s, bit for
    bit.  Counters set to 0 before each kind's rounds and read after:
    a round of an S x R spec launches the fused EI 21 times on each of its
    S x R cells and one column gram on each study shard, plus a due lag
    event's masked grams, factors and L X = I.  First, uncounted in the
    path, the restart shard's launch form (`restart_shard_checks`).
    Prints each spec's `advance_round` ms beside the card's name and power
    limit.  Returns (counts, line)."""
    from repro_torch.core import gp as gp_mod
    from repro_torch.hpo.pool import SchedulerConfig, StudyPool
    t_start = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    line = {"phase": "mesh", "nvidia_smi": nvidia_smi_line(),
            "specs": list(MESH_SPECS), "devices": {
                spec: mesh_devices(spec) for spec in MESH_SPECS}}
    total, shards = None, {}
    for name in ("engine", "engine_mixed"):
        _, eng, studies, _, _ = engines[name]
        mixed = eng.mixed
        shards[name] = restart_shard_checks(eng, gen)
        cfg = SchedulerConfig(n_max=N_MAX, lag=LAG, seed=0)
        steps = cfg.acq.ascent_steps
        pools = {}
        for spec in MESH_SPECS:
            pool = StudyPool([st.space for st in studies],
                             dataclasses.replace(cfg, mesh=spec), device=dev,
                             devices=mesh_devices(spec))
            pool.engine.state = gp_mod.place(eng.state, eng.device)
            pools[spec] = pool
        base = pools["none"]
        sr = max(base.engine.since_refit(s) for s in range(ENGINE_STUDIES))
        rounds = max(MESH_MIN_ROUNDS, LAG - sr)
        torch.cuda.synchronize()
        reset_counts()
        outs = {spec: pool.advance_round([]) for spec, pool in pools.items()}
        ms = {spec: [] for spec in MESH_SPECS}
        dues = []
        for r in range(rounds + 1):
            for spec, pool in pools.items():
                pool_units_equal(f"mesh {name} {spec} round {r}",
                                 outs["none"], outs[spec])
                if spec != "none":
                    a, b = pool.engine.state, base.engine.state
                    bad = [k for k, u, v in zip(
                        ("x_buf", "y_buf", "l_buf", "li_buf", "alpha",
                         "clamp_count", "sigma2", "rho", "noise2"),
                        gp_mod._leaves(a), gp_mod._leaves(b))
                        if not torch.equal(u, v)]
                    if bad or not (torch.equal(a.n, b.n) and torch.equal(
                            a.since_refit, b.since_refit)):
                        raise AssertionError(f"mesh {name} {spec} round {r}:"
                                             f" leaves {bad} differ")
            if r == rounds:
                break
            vals = {s: float(studies[s].objective(
                outs["none"][s][0].unit[None])[0])
                for s in range(ENGINE_STUDIES)}
            dues.append(lag_due(base.engine, np.ones(ENGINE_STUDIES, bool)))
            for spec, pool in pools.items():
                ev = [(s, outs[spec][s][0], vals[s])
                      for s in range(ENGINE_STUDIES)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[spec] = pool.advance_round(ev)
                torch.cuda.synchronize()
                ms[spec].append(1e3 * (time.perf_counter() - t0))
        counts = read_counts()
        want = None
        for spec, pool in pools.items():
            m = pool.engine.mesh
            cells = (1, 1) if m is None else (m.study_shards,
                                              m.restart_shards)
            one = engine_counts(mixed, cells[0] * rounds, sum(dues),
                                cells[0] * cells[1] * (rounds + 1), steps)
            want = one if want is None else add_counts(want, one)
        if counts != want:
            raise AssertionError(f"mesh {name}: launches {counts}, "
                                 f"expected {want}")
        if not any(dues):
            raise AssertionError(f"mesh {name}: no lag event in {rounds} "
                                 f"rounds")
        total = counts if total is None else add_counts(total, counts)
        line[name] = {
            "rounds": rounds + 1, "lag_events_by_round": dues,
            "launches": counts, "bit_for_bit": True,
            "shard_lanes": {spec: [sh.state.x_buf.shape[0] for sh in
                                   pool.engine._shards]
                            for spec, pool in pools.items()},
            "one_copy_per_card": all(
                rep is sh.state for pool in pools.values()
                for sh in pool.engine._shards for rep in sh.replicas),
            "advance_round_ms": {spec: {
                "median_without_lag_event": statistics.median(
                    [t for t, due in zip(v, dues) if not due]),
                "by_round": v} for spec, v in ms.items()},
            "restart_shard": shards[name]}
        lanes = line[name]["shard_lanes"]
        if lanes != {"none": [16], "2x1": [8, 8], "1x2": [16],
                     "2x2": [8, 8]}:
            raise AssertionError(f"mesh {name}: shard lanes {lanes}")
        del pools, base
    line["seconds"] = time.perf_counter() - t_start
    emit(line)
    return total, line


def profile_pool(pair) -> None:
    """Profile phase: one more `advance_round` of the pool under
    torch.profiler (busy share, device ms by kernel), then the twin
    replays the rounds."""
    state = {"out": pair.out[0]}

    def round_():
        order = list(range(ENGINE_STUDIES))
        vals = pair.values(state["out"])
        state["out"], _, _ = pair.step(pair.a, state["out"], order, vals)
        pair.log.append((order, vals, {s: trs[0].unit for s, trs in
                                       state["out"].items()}))

    split = device_split(round_)
    t0 = time.perf_counter()
    round_()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    pair.out = (state["out"], pair.catch_up(pair.out[1]))
    pool_lanes_equal(pair.name, pair.a, pair.b, "after the profile")
    emit({"phase": "profile", "path": pair.name, "round_wall_ms": wall,
          "device_span_ms": split["span_ms"],
          "device_busy_ms": split["busy_ms"],
          "device_idle_ms": split["idle_ms"],
          "device_busy_share": split["busy_ms"] / wall,
          "by_kernel": split["by_name"][:12]})


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def pool_protocol(pair) -> dict:
    """The pool's fantasies, checkpoint and slot export on a pair the pool
    phase left (run last).  Pool a asks `ask_q(8)` on slots 4 and 12
    (launches held to `fantasy_counts`); the tells come out of order, with
    a foreign tell and a release, then a drain through `absorb_many`; b
    takes the same real tells, never fantasizes and burns the asks' draws
    (`_draw_q`), and every leaf of every lane must end torch.equal, alpha
    included.  With slot 4's ask_q(8) out, a `checkpoint()`: the manifest
    names the reference's leaves in order, a fresh pool `restore()`s every
    leaf torch.equal to b's and a's ledgers, and one more identical
    `advance_round` on the restored pool and on b gives equal suggestions
    and leaves.  One slot round-trips `export_study` / `import_study` bit
    for bit.  Host-clock ms of the checkpoint (and its bytes) and of the
    restore."""
    import shutil
    from repro_torch import convert
    from repro_torch.hpo.pool import Trial
    name, a, b, mixed = pair.name, pair.a, pair.b, pair.mixed
    rng = np.random.default_rng(31)

    def value(s, unit):
        return float(pair.studies[s].objective(np.asarray(unit)[None])[0])

    def foreign(unit):
        return Trial(10_000, np.asarray(unit, np.float32), {})

    def tell(s, tr, v=None):
        v = value(s, tr.unit) if v is None else v
        a.absorb(s, tr, v)
        b.absorb(s, foreign(tr.unit), v)

    asked = {}
    for s in FANTASY_SLOTS:
        before = read_counts()
        asked[s] = a.ask_q(s, POOL_ASK)
        got = diff_counts(read_counts(), before)
        if got != fantasy_counts(mixed, a.cfg.acq.ascent_steps,
                                 asked=POOL_ASK):
            raise AssertionError(f"{name}: ask_q launches {got}")
        b._draw_q(s, POOL_ASK)
        units = np.stack([t.unit for t in asked[s]])
        if not np.array_equal(pair.studies[s].space.project(units), units):
            raise AssertionError(f"{name}: asked points off the lattice")
    s4, s12 = FANTASY_SLOTS
    for s, i in ((s4, 5), (s12, 7), (s4, 2), (s12, 0)):
        tell(s, asked[s][i])
    extra = pair.studies[s4].space.sample(rng, 1)[0]
    tell(s4, foreign(extra))
    if a.release_fantasies(s12, [asked[s12][3].unit]) != 1:
        raise AssertionError(f"{name}: release")
    left = [(s, tr) for s in FANTASY_SLOTS for i, tr in enumerate(asked[s])
            if not (s == s4 and i in (5, 2)) and not (s == s12 and i in
                                                      (7, 0, 3))]
    order = rng.permutation(len(left))
    ev_a = [(s, tr, value(s, tr.unit)) for s, tr in (left[i] for i in order)]
    a.absorb_many(ev_a)
    b.absorb_many([(s, foreign(tr.unit), v) for s, tr, v in ev_a])
    if any(a.fantasy_active(s) for s in FANTASY_SLOTS):
        raise AssertionError(f"{name}: fantasy rows left after the drain")
    pool_lanes_equal(name, a, b, "after the fantasy script")

    # The checkpoint with slot 4's ask out, and the restore.
    pending = a.ask_q(s4, POOL_ASK)
    b._draw_q(s4, POOL_ASK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = a.checkpoint()
    ckpt_ms = 1e3 * (time.perf_counter() - t0)
    if a.fantasy_active(s4) != POOL_ASK:
        raise AssertionError(f"{name}: checkpoint dropped the live fantasies")
    with open(os.path.join(path, "manifest.json")) as f:
        names = json.load(f)["names"]
    if names != list(convert.POOL_KEYS):
        raise AssertionError(f"{name}: manifest names {names}")
    c = pair.fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not c.restore():
        raise AssertionError(f"{name}: nothing restored")
    c.engine.sync()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    pool_lanes_equal(name, c, b, "restored against the twin's real state")
    if any(c.history(s) != a.history(s) for s in range(c.n_studies)):
        raise AssertionError(f"{name}: restored ledgers differ")
    units = {s: trs[0].unit for s, trs in pair.out[1].items()}
    vals = {s: value(s, u) for s, u in units.items()}
    out_c = c.advance_round([(s, foreign(u), vals[s]) for s, u in
                             units.items()])
    out_b = b.advance_round([(s, foreign(u), vals[s]) for s, u in
                             units.items()])
    pool_units_equal(name, out_c, out_b)
    pool_lanes_equal(name, c, b, "one round after the restore")

    # One slot's export and import.
    slot = POOL_EXPORT_SLOT
    snap = c.engine.study_state(slot)
    gen = c.studies[slot].gen.get_state().clone()
    hist = c.history(slot)
    exp = c.export_study(slot)
    c.reset_study(slot, space=pair.studies[slot].space)
    c.import_study(slot, exp["tree"], exp["meta"],
                   space=pair.studies[slot].space)
    back = c.engine.study_state(slot)
    from repro_torch.core import gp
    same = all(torch.equal(u, v) for u, v in zip(gp._leaves(back),
                                                  gp._leaves(snap)))
    if not (same and (back.n, back.since_refit) == (snap.n, snap.since_refit)
            and torch.equal(c.studies[slot].gen.get_state(), gen)
            and c.history(slot) == hist):
        raise AssertionError(f"{name}: export / import not bit for bit")
    a.release_fantasies(s4, [t.unit for t in pending])
    nbytes = dir_bytes(path)
    shutil.rmtree(pair.cfg.ckpt_dir, ignore_errors=True)
    return {"fantasy_twin_equal": True, "checkpoint_ms": ckpt_ms,
            "checkpoint_bytes": nbytes, "restore_ms": restore_ms,
            "manifest_names": names, "restored_equal": True,
            "round_after_restore_equal": True,
            "export_import_slot": slot, "export_import_equal": True}


def scheduler_path(dev) -> dict:
    """The float pool phase's scheduler: a `TrialScheduler` on one Levy-5d
    study (n_max = 1024, lag 32, parallel 4), prefilled to 960 points
    through `absorb_many`, then `run(objective, budget=16)`: a resumed
    run, so no seed trial; every suggest exactly 21 fused EI and nothing
    else, every absorb one column gram plus a due lag event's launches.
    Host-clock ms of a suggest and an absorb (medians)."""
    from repro_torch.hpo.pool import SchedulerConfig
    from repro_torch.hpo.scheduler import TrialScheduler
    study = engine_studies(False)[0]
    sched = TrialScheduler(study.space, SchedulerConfig(
        n_max=N_MAX, lag=LAG, seed=0, parallel=SCHED_PARALLEL), device=dev)
    pool = sched.pool
    pool_prefill(pool, [study], [N_SEED])
    pool.engine.sync()
    suggest, absorb = pool.suggest, pool.absorb
    times = {"suggest": [], "absorb": []}

    def counted(kind, fn, want_fn):
        def wrapped(*args, **kw):
            want = want_fn()
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[kind].append(1e3 * (time.perf_counter() - t0))
            got = diff_counts(read_counts(), before)
            if got != want:
                raise AssertionError(f"scheduler {kind}: launches {got}, "
                                     f"expected {want}")
            return out
        return wrapped

    pool.suggest = counted("suggest", suggest,
                           lambda: engine_counts(False, 0, 0, 1, 20))
    pool.absorb = counted("absorb", absorb, lambda: engine_counts(
        False, 1, lag_due(pool.engine, np.ones(1, bool)), 0, 20))

    def objective(hp):
        u = np.array([hp[f"u{i}"] for i in range(DIM)], np.float32)
        return float(study.objective(u[None])[0])

    t0 = time.perf_counter()
    best = sched.run(objective, budget=SCHED_BUDGET)
    run_s = time.perf_counter() - t0
    pool.suggest, pool.absorb = suggest, absorb
    done = [t for t in sched.trials if t.status == "done"]
    if not (pool.engine.n(0) == N_SEED + SCHED_BUDGET
            and len(done) == N_SEED + SCHED_BUDGET
            and len(times["suggest"]) == SCHED_BUDGET and best is not None):
        raise AssertionError(f"scheduler: n {pool.engine.n(0)}, done "
                             f"{len(done)}, suggests {len(times['suggest'])}")
    return {"n": pool.engine.n(0), "budget": SCHED_BUDGET,
            "parallel": SCHED_PARALLEL, "run_seconds": run_s,
            "suggests": len(times["suggest"]),
            "suggest_ms_median": statistics.median(times["suggest"]),
            "absorb_ms_median": statistics.median(times["absorb"]),
            "best": best.value,
            "per_suggest_launches": engine_counts(False, 0, 0, 1, 20)}


GATEWAY = dict(slots=16, max_inflight=8)   # every gateway of the phase
GATEWAY_FRESH = 8          # fresh studies beside the 16 adopted ones
GATEWAY_ROUNDS = 16        # rounds of the scripted twin
GATEWAY_ASKS = 5           # asks a round (3 x 5 <= 16 slots: none defers)
GATEWAY_Q = 4              # the q of every third round's q-ask
GATEWAY_WINDOW = 6         # rounds before the asking window moves on
GATEWAY_SHIFT = 8          # studies the window moves by
CLIENT_ASKS = 6            # suggestions each asyncio client asks for
CLIENT_Q_SIDS = (4, 12)    # clients that ask with q = GATEWAY_Q
CLIENT_LATENCY = 0.002     # examples/serve.py's simulated training, seconds
TIER_ASKS = 4              # client 0's asks after its promotion


def gateway_records(pool, studies, dirs, shard_of=None) -> list[dict]:
    """The pool's 16 studies as the gateway's eviction store holds them:
    each `export_study`, written to every directory of `dirs` (or, given
    `shard_of`, to `dirs[shard_of(study)]` alone) as `_evict` writes it
    (`save_study` version 1, key study%06d, metadata handle / sid /
    n_obs), and the registry records a gateway adopts."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.hpo.space import space_to_dicts
    records = []
    for s in range(pool.n_studies):
        snap = pool.export_study(s)
        key, n_obs = f"study{s:06d}", pool.engine.n(s)
        for d in (dirs if shard_of is None else [dirs[shard_of(s)]]):
            ckpt.save_study(d, key, 1, snap["tree"], metadata={
                "handle": json.dumps(snap["meta"]), "sid": s,
                "n_obs": n_obs})
        best = pool.best(s)
        records.append({"sid": s, "name": f"study{s}", "seed": s,
                        "dims": space_to_dicts(studies[s].space),
                        "n_obs": n_obs,
                        "best_value": None if best is None else best.value,
                        "version": 1, "evicted_ever": True, "tier": 0,
                        "key": key})
    return records


def gateway_from(dev, template, ckpt_dir, records=(), pipeline=True):
    """A gateway at the pool phases' configuration; given `records` (their
    snapshots already in `ckpt_dir`), it adopts them and creates 8 fresh
    studies: 24 logical studies on 16 slots."""
    from repro_torch.hpo import GatewayConfig, SchedulerConfig, StudyGateway
    cfg = SchedulerConfig(n_max=N_MAX, lag=LAG, seed=0, ckpt_dir=ckpt_dir,
                          ckpt_every=10 ** 9)
    gw = StudyGateway(template, cfg,
                      GatewayConfig(pipeline=pipeline, **GATEWAY),
                      device=dev)
    for rec in records:
        gw.adopt_study(rec, require_snapshot=True)
    for _ in range(GATEWAY_FRESH if records else 0):
        gw.create_study()
    return gw


def begin_counts(pool, events, studies) -> dict:
    """Launches of `pool.advance_round_begin(events, studies=studies)`
    from the host mirrors before it: an absorb round a GP-tier event of
    the study told most (the advance's column and the overflow's masked
    rounds), per study floor((since_refit + its events) / lag) lag events,
    one suggest where the round suggests (21 fused EI), and two grams a
    fantasy row replayed after the round."""
    eng = pool.engine
    ids = list(range(pool.n_studies)) if studies is None else list(studies)
    nb = {s for s in range(pool.n_studies) if eng.tier(s)}
    told: dict[int, list] = {}
    for s, tr, _ in events:
        told.setdefault(s, []).append(tr.unit)
    gp_told = {s: len(u) for s, u in told.items() if s not in nb}
    refits = sum((eng.since_refit(s) + k) // eng.cfg.lag
                 for s, k in gp_told.items())
    replays = 0
    for s, units in told.items():
        pend = list(pool._fantasies[s])
        for u in units:
            hit = next((i for i, p in enumerate(pend)
                        if np.array_equal(p, u)), None)
            if hit is not None:
                del pend[hit]
        if s not in nb:
            replays += len(pend)
    if not events:
        suggests = int(any(s not in nb and eng.n(s) > 0 for s in ids))
    else:
        suggests = int(bool(ids))
    counts = engine_counts(False, max(gp_told.values(), default=0), refits,
                           suggests, pool.cfg.acq.ascent_steps)
    counts["matern"] += 2 * replays
    return counts


class CountedGateway:
    """A gateway whose pool's `advance_round_begin` and `ask_q` are held
    to their launches call by call (`begin_counts`, `fantasy_counts`), and
    whose ticks are held to the sum of their calls'."""

    def __init__(self, name, gw):
        self.name, self.gw = name, gw
        self.want = {k: 0 for k in read_counts()}
        pool = gw.pool
        begin, ask_q = pool.advance_round_begin, pool.ask_q
        steps = pool.cfg.acq.ascent_steps

        def counted_begin(events, t=1, studies=None):
            return self.call("advance_round_begin", lambda: begin_counts(
                pool, events, studies), lambda: begin(events, t=t,
                                                      studies=studies))

        def counted_ask_q(study_id, q):
            def want():
                if pool.engine.tier(study_id) or \
                        pool.engine.n(study_id) == 0:
                    return engine_counts(False, 0, 0, 0, steps)
                return fantasy_counts(False, steps, asked=q)
            return self.call("ask_q", want, lambda: ask_q(study_id, q))

        pool.advance_round_begin = counted_begin
        pool.ask_q = counted_ask_q

    def call(self, what, want_fn, fn):
        want = want_fn()
        before = read_counts()
        out = fn()
        got = diff_counts(read_counts(), before)
        if got != want:
            raise AssertionError(f"gateway {self.name}: {what} launches "
                                 f"{got}, expected {want}")
        self.want = add_counts(self.want, want)
        return out

    def tick(self, step):
        """One tick (`tick` or `tick_begin`), its launches the sum of its
        pool calls'."""
        before, want = read_counts(), dict(self.want)
        out = step()
        got = diff_counts(read_counts(), before)
        if got != diff_counts(self.want, want):
            raise AssertionError(f"gateway {self.name}: tick launches {got}")
        return out


def gateway_enqueue(gw, loop, sid, q=1):
    """White-box ask (tests/test_gateway.py's `_enq`): a future resolved
    when a tick serves it."""
    fut = loop.create_future()
    gw._studies[sid].pending_asks += q
    gw._asks.append((sid, fut, q))
    return fut


def trace_askers(r: int, n_logical: int) -> list[int]:
    """The scripted trace's askers at round r: a window of 3 x 5 studies
    asked in turn (each set asked every third round, its tells in by
    then), moved on by 8 studies every 6 rounds, so over 16 rounds it
    rotates through all 24 studies."""
    base = GATEWAY_SHIFT * (r // GATEWAY_WINDOW) + GATEWAY_ASKS * (r % 3)
    return [(base + i) % n_logical for i in range(GATEWAY_ASKS)]


def pending_event(gw):
    """The CUDA event of the staged tick's round, if any."""
    p = gw._pending
    if p is None:
        return None
    rnd = p.round
    for x in (rnd._units, rnd._clamps, *rnd._nb_units.values()):
        if hasattr(x, "ready"):
            return x.ready
    return None


def gateway_values(objective, trials) -> list[float]:
    return [float(v) for v in objective(np.stack([t.unit for t in trials]))]


async def gateway_twin(a, b, objective) -> dict:
    """Step 1: the scripted trace on A (`tick_begin`, pipelined) and B
    (`tick()`), both counted: a trial asked at round r is told at round
    r + 2 (by enqueue round, in both); every third round's first asker
    asks q = 4; then A flushes and both tick until every tell is in.
    Returns the streams and A's overlap counts."""
    loop = asyncio.get_running_loop()
    n_logical = len(a.gw.study_ids())
    streams = {k: {s: [] for s in a.gw.study_ids()} for k in "ab"}
    inflight, to_tell = [], []
    overlapped = pending_after_finish = 0

    def collect():
        for item in inflight[:]:
            r0, s, fa, fb = item
            if fa.done() and fb.done():
                ta, tb = (f.result() for f in (fa, fb))
                ta = ta if isinstance(ta, list) else [ta]
                tb = tb if isinstance(tb, list) else [tb]
                for k, trs in (("a", ta), ("b", tb)):
                    streams[k][s] += [t.unit.tobytes() for t in trs]
                to_tell.append((r0 + 2, s, ta, tb))
                inflight.remove(item)

    def tell(due):
        for item in [x for x in to_tell if x[0] <= due]:
            _, s, ta, tb = item
            vals = gateway_values(objective, ta)
            for gw, trs in ((a.gw, ta), (b.gw, tb)):
                for t, v in zip(trs, vals):
                    gw.tell(s, t, v)
            to_tell.remove(item)

    for r in range(GATEWAY_ROUNDS):
        tell(r)
        for i, s in enumerate(trace_askers(r, n_logical)):
            q = GATEWAY_Q if (r % 3 == 2 and i == 0) else 1
            inflight.append((r, s, gateway_enqueue(a.gw, loop, s, q),
                             gateway_enqueue(b.gw, loop, s, q)))
        a.tick(a.gw.tick_begin)
        if a.gw._pending is not None:
            overlapped += 1
            ev = pending_event(a.gw)
            pending_after_finish += int(ev is not None and not ev.query())
        b.tick(b.gw.tick)
        collect()
    a.tick(a.gw.tick_flush)
    while True:
        collect()
        tell(10 ** 9)
        if not (inflight or a.gw._tells or a.gw._asks or b.gw._tells
                or b.gw._asks):
            break
        a.tick(a.gw.tick)
        b.tick(b.gw.tick)
    if streams["a"] != streams["b"]:
        raise AssertionError("gateway: pipelined and serial suggestion "
                             "streams differ")
    if not overlapped:
        raise AssertionError("gateway: the pipelined run never overlapped")
    return {"overlapped_ticks": overlapped,
            "next_round_pending_after_finish": pending_after_finish,
            "suggestions": sum(len(v) for v in streams["a"].values())}


def gateways_equal(name, a, b) -> None:
    """Registries, summary counts and every lane of two gateways."""
    for s in a.study_ids():
        if a.registry_record(s) != b.registry_record(s) or \
                a._studies[s].slot != b._studies[s].slot:
            raise AssertionError(f"gateway {name}: study {s}'s registry")
    sa, sb = a.summary(), b.summary()
    for k in ("ticks", "asks_served", "absorbed", "evictions", "restores",
              "fantasy_rollbacks", "q_width_hist", "fantasy_active"):
        if sa[k] != sb[k]:
            raise AssertionError(f"gateway {name}: summary {k} {sa[k]} "
                                 f"against {sb[k]}")
    pool_lanes_equal(f"gateway {name}", a.pool, b.pool, name)


def resident_calm(gw, count: int) -> list[int]:
    """`count` resident idle studies whose next absorb is no lag event."""
    out = [s for s in gw._owner if s is not None
           and gw._evictable(gw._studies[s])
           and gw.pool.engine.since_refit(gw._studies[s].slot) + 1 < LAG]
    if len(out) < count:
        raise AssertionError(f"gateway: {len(out)} calm resident studies")
    return out[:count]


def serve_once(gws, sids, objective, loop, stage=None):
    """One ask of each of `sids` on every gateway of `gws` (a tick each),
    then the tells and one more ask each; the second tick of the first
    gateway through `stage` where given.  Returns the second asks'
    trials per gateway."""
    first = []
    for gw in gws:
        futs = [gateway_enqueue(gw, loop, s) for s in sids]
        gw.tick()
        first.append([f.result() for f in futs])
    out = []
    for k, (gw, trials) in enumerate(zip(gws, first)):
        vals = gateway_values(objective, trials)
        for s, t, v in zip(sids, trials, vals):
            gw.tell(s, t, v)
        futs = [gateway_enqueue(gw, loop, s) for s in sids]
        if k == 0 and stage is not None:
            stage(gw)
        else:
            gw.tick()
        out.append([f.result() for f in futs])
    for gw, trials in zip(gws, out):
        vals = gateway_values(objective, trials)
        for s, t, v in zip(sids, trials, vals):
            gw.tell(s, t, v)
        gw.tick()
    return out


def same_trials(name, runs) -> None:
    ref = [t.unit.tobytes() for t in runs[0]]
    for other in runs[1:]:
        if [t.unit.tobytes() for t in other] != ref:
            raise AssertionError(f"gateway {name}: suggestions differ")


async def settled(x):
    """`x`, awaited where it is awaitable: the in-process gateways answer
    `study_info`, `tell` and `summary` at once, a `TransportFederation`
    by a coroutine."""
    return await x if inspect.isawaitable(x) else x


async def gateway_client(gw, sid, objective, asks, q, tier_asks, stats):
    """examples/serve.py's client: ask (q wide while the budget allows),
    train for a few ms, tell; client 0 (`tier_asks`) runs on until its
    study is promoted past n_max, then asks `tier_asks` more times.  `gw`
    is a gateway or a federation of either kind."""
    latency = CLIENT_LATENCY * (1.0 + 0.5 * ((sid + 1) % 3))
    done = after = 0
    while True:
        if tier_asks:
            if (await settled(gw.study_info(sid)))["tier"]:
                if after == tier_asks:
                    break
                after += 1
        elif done >= asks:
            break
        width = min(q, asks - done) if not tier_asks else 1
        got = await gw.ask(sid, q=width)
        trials = got if isinstance(got, list) else [got]
        units = np.stack([t.unit for t in trials])
        if not (np.isfinite(units).all() and (units >= 0).all()
                and (units <= 1).all()):
            raise AssertionError(f"gateway: study {sid} suggested outside "
                                 "the unit cube")
        await asyncio.sleep(latency)
        for t, v in zip(trials, gateway_values(objective, trials)):
            await settled(gw.tell(sid, t, v))
        done += len(trials)
        stats["tells"][sid] = stats["tells"].get(sid, 0) + len(trials)
    await gw.drain()


async def gateway_clients(gw, objective) -> dict:
    """Step 5: 24 asyncio clients on one gateway, timed."""
    sids = gw.study_ids()
    n0 = {s: gw.study_info(s)["n_obs"] for s in sids}
    stats = {"tells": {}}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    await asyncio.gather(*(gateway_client(
        gw, s, objective, CLIENT_ASKS,
        GATEWAY_Q if s in CLIENT_Q_SIDS else 1,
        TIER_ASKS if s == 0 else 0, stats) for s in sids))
    await gw.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summ = gw.summary()
    await gw.aclose()
    tells = stats["tells"]
    if gw.study_info(0)["tier"] != 1 or summ["escalated"] != 1:
        raise AssertionError("gateway: client 0's study was not promoted")
    for s in sids:
        if gw.study_info(s)["n_obs"] != n0[s] + tells.get(s, 0):
            raise AssertionError(f"gateway: study {s} absorbed "
                                 f"{gw.study_info(s)['n_obs'] - n0[s]} of "
                                 f"{tells.get(s, 0)} tells")
    if gw.dead_tells or summ["absorbed"] != sum(tells.values()):
        raise AssertionError("gateway: tells not absorbed")
    return {"pipeline": gw.gw.pipeline, "seconds": wall,
            "suggestions": summ["asks_served"],
            "suggestions_per_s": summ["asks_served"] / wall,
            "ticks": summ["ticks"],
            "mean_coalesce_width": summ["mean_coalesce_width"],
            "p50_tick_ms": summ["p50_tick_ms"],
            "p95_tick_ms": summ["p95_tick_ms"],
            "evictions": summ["evictions"], "restores": summ["restores"],
            "q_width_hist": summ["q_width_hist"],
            "client0_asks": tells[0], "client0_n_obs": gw.study_info(0)[
                "n_obs"]}


def gateway_path(dev, pair, pool_line) -> dict:
    """Phase gateway: the port's `StudyGateway` at the pool phases'
    configuration (16 slots, n_max 1024, lag 32, 48 x 20, max_inflight 8)
    over the float pool's 16 studies, exported and written as eviction
    snapshots, adopted (`require_snapshot`) beside 8 fresh studies: 24
    logical studies on 16 slots, no prefill of its own.  Counts set to 0
    before step 1 and read after step 5.  (1) the scripted twin, A
    pipelined (`tick_begin`) and B serial (`tick()`): every pool call and
    tick held to its launches, streams, registries, summaries and every
    lane equal, A overlapped; (2) one `_tick_stage` of A under
    `set_sync_debug_mode("error")`; (3) one study of A evicted and
    restored on demand, then its leaves and next suggestion against B,
    where it stayed; (4) A's `checkpoint()` restored by a fresh gateway,
    registry and lanes equal, one more tick equal; (5) 24 asyncio clients
    on D (pipelined), then on E (serial), one run of each, client 0
    promoted past n_max each time."""
    import shutil
    import tempfile
    start = time.perf_counter()
    studies, objective = pair.studies, pair.studies[0].objective
    dirs = {k: tempfile.mkdtemp(prefix=f"chip_smoke_gw{k}_") for k in "ab"}
    t0 = time.perf_counter()
    records = gateway_records(pair.a, studies, dirs.values())
    setup_s = time.perf_counter() - t0
    template = studies[0].space
    torch.cuda.synchronize()
    reset_counts()
    line = {"phase": "gateway", "slots": GATEWAY["slots"],
            "logical_studies": len(records) + GATEWAY_FRESH, "n_max": N_MAX,
            "n_adopted": [r["n_obs"] for r in records],
            "records_seconds": setup_s}
    a = CountedGateway("A", gateway_from(dev, template, dirs["a"], records))
    b = CountedGateway("B", gateway_from(dev, template, dirs["b"], records))
    t0 = time.perf_counter()
    line["twin"] = asyncio.run(gateway_twin(a, b, objective))
    line["twin"]["seconds"] = time.perf_counter() - t0
    line["twin"]["launches"] = a.want
    gateways_equal("twin", a.gw, b.gw)

    async def steps_2_to_4():
        loop = asyncio.get_running_loop()
        # (2) one stage under the sync check: resident askers, no lag event
        staged_sids = resident_calm(a.gw, 3)

        def stage(gw):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                staged = gw._tick_stage()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            gw._tick_finish(staged)
        same_trials("sync-free stage", serve_once(
            [a.gw, b.gw], staged_sids, objective, loop, stage=stage))
        gateways_equal("after the sync-free stage", a.gw, b.gw)
        # (3) an eviction and a restore on demand, against B
        sid = resident_calm(a.gw, 1)[0]
        log = a.gw._studies[sid]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.gw._free.append(a.gw._evict(log))
        evict_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        slot = a.gw._ensure_resident(sid)
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        if slot != b.gw._studies[sid].slot:
            raise AssertionError("gateway: the restored study moved slot")
        pool_lanes_equal("gateway eviction", a.gw.pool, b.gw.pool,
                         "evicted and restored")
        same_trials("eviction", serve_once([a.gw, b.gw], [sid], objective,
                                           loop))
        pool_lanes_equal("gateway eviction", a.gw.pool, b.gw.pool,
                         "one tick after")
        # (4) the whole gateway's checkpoint, restored by a fresh one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = a.gw.checkpoint()
        ckpt_ms = 1e3 * (time.perf_counter() - t0)
        c = gateway_from(dev, template, dirs["a"])
        t0 = time.perf_counter()
        if not c.restore():
            raise AssertionError("gateway: nothing restored")
        torch.cuda.synchronize()
        ckpt_restore_ms = 1e3 * (time.perf_counter() - t0)
        gateways_equal("restored", a.gw, c)
        sids = resident_calm(a.gw, 3)
        same_trials("restored", serve_once([a.gw, c], sids, objective,
                                           loop))
        gateways_equal("one tick after the restore", a.gw, c)
        return {"sync_free_stage_studies": staged_sids,
                "evicted_study": sid, "evict_ms": evict_ms,
                "restore_on_demand_ms": restore_ms,
                "checkpoint_ms": ckpt_ms,
                "checkpoint_bytes": dir_bytes(path),
                "checkpoint_restore_ms": ckpt_restore_ms}
    line.update(asyncio.run(steps_2_to_4()))
    del a, b
    # D, then E: each gateway fresh from the records in a store of its
    # own, one run of each mode on one card (the phase's depth cut to keep
    # the script in its time)
    runs = []
    for k, pipeline in enumerate((True, False)):
        d = tempfile.mkdtemp(prefix=f"chip_smoke_gw{k}_")
        dirs[f"client{k}"] = d
        gateway_records(pair.a, studies, [d])
        gw = gateway_from(dev, template, d, records, pipeline)
        runs.append(asyncio.run(gateway_clients(gw, objective)))
    line["clients"] = runs
    line["clients_median"] = {
        mode: {k: statistics.median(r[k] for r in runs
                                    if r["pipeline"] == pipeline)
               for k in ("suggestions_per_s", "p50_tick_ms", "p95_tick_ms",
                         "seconds")}
        for mode, pipeline in (("pipelined", True), ("serial", False))}
    counts = read_counts()
    line["launches"] = counts
    line["pool_advance_round_ms_median"] = \
        pool_line["advance_round_ms"]["median"]
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    line["seconds"] = time.perf_counter() - start
    emit(line)
    return counts, line


FED_SHARDS = 2             # shards of the federation phase
FED = dict(GATEWAY, slots=GATEWAY["slots"] // FED_SHARDS)   # 8 slots a shard
FED_MIGRATE_ROUND = 7      # the trace's round after whose tick a study moves
FED_HEARTBEAT_S = 0.5      # C's ping period (the deadline and miss limit are
# the reference's defaults: 1.0 s, 3 misses)
FED_LOST = 2               # studies a shard serves in the round a kill loses


def federation_cfg(root):
    from repro_torch.hpo import SchedulerConfig
    return SchedulerConfig(n_max=N_MAX, lag=LAG, seed=0, ckpt_dir=root,
                           ckpt_every=10 ** 9)


def federation_root(pool, studies, root) -> list[dict]:
    """Seed a federation root as its recovery path reads it: each of the
    pool's 16 studies written (`gateway_records`) into its ring shard's
    store, then a registry epoch (`FederationBase._save_epoch`) placing
    the 24 sids on their ring shards with a fallback record for each
    adopted study.  A federation's `restore()` (or a transport's
    `start()`) then re-adopts the 16 and creates the 8 fresh ones."""
    from repro_torch.hpo import (FederationBase, FederationConfig,
                                 GatewayConfig)
    base = FederationBase(studies[0].space, federation_cfg(root),
                          GatewayConfig(**FED),
                          FederationConfig(n_shards=FED_SHARDS))
    records = gateway_records(pool, studies, [base.shard_dir(i) for i in
                                              range(FED_SHARDS)],
                              shard_of=base.route)
    base._next_sid = len(records) + GATEWAY_FRESH
    base._placement = {s: base.route(s) for s in range(base._next_sid)}
    base._save_epoch({r["sid"]: dict(r, shard=base.route(r["sid"]))
                      for r in records})
    return records


def federation_from(dev, template, root, records):
    """Federation A at the gateway phase's configuration, 2 shards of 8
    slots, restored from a seeded root: every adopted study holds its
    record's observations."""
    from repro_torch.hpo import (FederatedGateway, FederationConfig,
                                 GatewayConfig)
    fed = FederatedGateway(template, federation_cfg(root),
                           GatewayConfig(**FED),
                           FederationConfig(n_shards=FED_SHARDS), device=dev)
    if not fed.restore():
        raise AssertionError("federation: nothing restored")
    adopted_as_recorded([fed.study_info(r["sid"])["n_obs"] for r in records],
                        records)
    return fed


def adopted_as_recorded(n_obs: list, records) -> None:
    """The adopted studies hold their records' observations (a snapshot
    the recovery path did not find would leave a fresh study)."""
    if n_obs != [r["n_obs"] for r in records]:
        raise AssertionError(f"federation: adopted n_obs {n_obs}")


class CountedFederation:
    """Federation A with every shard's pool calls held to their launches
    (`CountedGateway`, rewrapped when `revive_shard` builds a shard anew),
    and every `tick()` to the sum of its shards' calls."""

    def __init__(self, name, fed):
        self.name, self.fed, self.counted = name, fed, []
        self.wrap()

    def wrap(self):
        known = {id(c.gw) for c in self.counted}
        for i, gw in enumerate(self.fed.shards):
            if gw is not None and id(gw) not in known:
                self.counted.append(CountedGateway(f"{self.name}{i}", gw))

    @property
    def want(self) -> dict:
        total = {k: 0 for k in read_counts()}
        for c in self.counted:
            total = add_counts(total, c.want)
        return total

    def tick(self) -> int:
        before, want = read_counts(), self.want
        out = self.fed.tick()
        got = diff_counts(read_counts(), before)
        if got != diff_counts(self.want, want):
            raise AssertionError(f"federation {self.name}: tick launches "
                                 f"{got}")
        return out


def shard_gw(fed, sid):
    return fed.shards[fed.shard_of(sid)]


def trace_moves(fed, r: int) -> dict:
    """After round r's ticks: the lowest resident quiescent study of the
    fuller shard that asks again later in the trace moves to the other
    shard, then `rebalance()`; both timed."""
    later = {s for t in range(r + 1, GATEWAY_ROUNDS)
             for s in trace_askers(t, len(fed.study_ids()))}
    src = max(range(FED_SHARDS), key=lambda i: (sum(
        1 for s in fed.study_ids() if fed.shard_of(s) == i), -i))
    sid = min(s for s in fed.study_ids() if s in later
              and fed.shard_of(s) == src and fed.study_info(s)["resident"]
              and shard_gw(fed, s).is_quiescent(s))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fed.migrate_study(sid, 1 - src)
    migrate_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    moves = fed.rebalance()
    torch.cuda.synchronize()
    return {"sid": sid, "src": src, "dst": 1 - src, "migrate_ms": migrate_ms,
            "rebalance": moves,
            "rebalance_ms": 1e3 * (time.perf_counter() - t0),
            "placement": [sum(1 for s in fed.study_ids()
                              if fed.shard_of(s) == i)
                          for i in range(FED_SHARDS)]}


async def federation_twin(a, b, objective) -> dict:
    """Step 1: the gateway phase's scripted trace on A (`tick()` of every
    shard) and its single-pool twin B (`tick()`), both counted, the same
    event order: a trial asked at round r is told at r + 2; every third
    round's first asker asks q = 4; each round's tells are absorbed by a
    tick of their own before its asks are served (a shard of 8 slots then
    holds at most the last round's askers and this round's, and no ask
    defers); after round FED_MIGRATE_ROUND A moves one study and
    rebalances.  Every suggestion bit for bit B's.  Returns A's streams
    (unit bytes) and the moves."""
    loop = asyncio.get_running_loop()
    fed = a.fed
    sids = fed.study_ids()
    streams = {k: {s: [] for s in sids} for k in "ab"}
    inflight, to_tell, moves = [], [], {}

    def collect():
        for item in inflight[:]:
            r0, s, fa, fb = item
            if not (fa.done() and fb.done()):
                raise AssertionError(f"federation: study {s}'s ask of "
                                     f"round {r0} deferred")
            if fa.done():
                ta, tb = (f.result() for f in (fa, fb))
                ta = ta if isinstance(ta, list) else [ta]
                tb = tb if isinstance(tb, list) else [tb]
                for k, trs in (("a", ta), ("b", tb)):
                    streams[k][s] += [t.unit.tobytes() for t in trs]
                to_tell.append((r0 + 2, s, ta, tb))
                inflight.remove(item)

    def tell(due):
        for item in [x for x in to_tell if x[0] <= due]:
            _, s, ta, tb = item
            vals = gateway_values(objective, ta)
            for t, v in zip(ta, vals):
                fed.tell(s, t, v)
            for t, v in zip(tb, vals):
                b.gw.tell(s, t, v)
            to_tell.remove(item)

    for r in range(GATEWAY_ROUNDS):
        tell(r)
        a.tick()
        b.tick(b.gw.tick)
        for i, s in enumerate(trace_askers(r, len(sids))):
            q = GATEWAY_Q if (r % 3 == 2 and i == 0) else 1
            inflight.append((r, s, gateway_enqueue(shard_gw(fed, s), loop,
                                                   s, q),
                             gateway_enqueue(b.gw, loop, s, q)))
        a.tick()
        b.tick(b.gw.tick)
        collect()
        if r == FED_MIGRATE_ROUND:
            moves = trace_moves(fed, r)
    tell(10 ** 9)
    a.tick()
    b.tick(b.gw.tick)
    if b.gw._tells or b.gw._asks or any(gw._tells or gw._asks
                                        for gw in fed.shards):
        raise AssertionError("federation: the trace left work queued")
    if streams["a"] != streams["b"]:
        bad = [s for s in sids if streams["a"][s] != streams["b"][s]]
        raise AssertionError(f"federation: studies {bad} suggested other "
                             "points than the single pool")
    moves["suggested_after_move"] = sum(
        1 for r in range(FED_MIGRATE_ROUND + 1, GATEWAY_ROUNDS)
        if moves["sid"] in trace_askers(r, len(sids)))
    return {"streams": streams["a"], "moves": moves}


LEDGER_KEYS = ("trial_id", "unit", "value", "status", "error", "cost")


def study_views(gw, sids) -> dict:
    """Each study of `gw` made resident in turn: its `study_state_digest`,
    its ledger's stable fields and its registry's n_obs / best_value."""
    from repro_torch.hpo.transport import study_state_digest
    out = {}
    for s in sids:
        slot = gw._ensure_resident(s)
        info = gw.study_info(s)
        out[s] = {"digest": study_state_digest(gw.pool, slot),
                  "ledger": [tuple(str(t[k]) for k in LEDGER_KEYS)
                             for t in gw.pool.history(slot)],
                  "n_obs": info["n_obs"], "best_value": info["best_value"]}
    return out


LIFETIME_KEYS = ("asks_served", "absorbed", "fantasy_rollbacks",
                 "q_width_hist", "fantasy_active", "escalated", "saturated")


def views_equal(name, a, b, keys=("digest", "ledger", "n_obs",
                                  "best_value")) -> None:
    for s in a:
        for k in keys:
            if a[s][k] != b[s][k]:
                raise AssertionError(f"federation {name}: study {s}'s {k}")


def fed_checkpoint(fed) -> dict:
    """A's `checkpoint()`: ms, and bytes of what it wrote (the registry
    epoch and each shard's pool snapshot)."""
    from repro_torch import checkpoint as ckpt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch = fed.checkpoint()
    ms = 1e3 * (time.perf_counter() - t0)
    paths = [os.path.join(fed._fed_dir, f"step_{epoch:09d}")] + [
        os.path.join(fed.shard_dir(i),
                     f"step_{ckpt.latest_step(fed.shard_dir(i)):09d}")
        for i in range(FED_SHARDS)]
    return {"epoch": epoch, "ms": ms,
            "bytes": sum(dir_bytes(p) for p in paths)}


def calm_by_shard(fed, count: int) -> dict:
    """`count` resident idle studies of each shard whose next absorb is no
    lag event."""
    return {i: resident_calm(gw, count) for i, gw in enumerate(fed.shards)}


async def federation_recovery(a, objective, streams) -> dict:
    """Step 2 after the twin: A's `checkpoint()` (ms, bytes); one round on
    two calm studies of each shard, told and absorbed but not committed;
    `kill_shard(0)`; the survivor serves a round; `revive_shard(0)`.
    Shard 0's studies are back at the epoch, shard 1's kept both rounds,
    and shard 0's next suggestions are the lost round's, bit for bit, and
    none of their earlier ones."""
    loop = asyncio.get_running_loop()
    fed = a.fed
    line = {"checkpoint": fed_checkpoint(fed)}
    calm = calm_by_shard(fed, FED_LOST)
    n0 = {s: fed.study_info(s)["n_obs"] for ss in calm.values() for s in ss}

    def one_round(sids):
        futs = {s: gateway_enqueue(shard_gw(fed, s), loop, s) for s in sids}
        a.tick()
        trials = {s: f.result() for s, f in futs.items()}
        for s, t in trials.items():
            fed.tell(s, t, gateway_values(objective, [t])[0])
        a.tick()
        return {s: t.unit.tobytes() for s, t in trials.items()}

    lost = one_round(calm[0] + calm[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fed.kill_shard(0)
    survivor = one_round(calm[1])
    t1 = time.perf_counter()
    fed.revive_shard(0)
    torch.cuda.synchronize()
    line["revive_ms"] = 1e3 * (time.perf_counter() - t1)
    line["kill_to_revived_ms"] = 1e3 * (time.perf_counter() - t0)
    a.wrap()
    for s, n in n0.items():
        want = n if fed.shard_of(s) == 0 else n + 2
        if fed.study_info(s)["n_obs"] != want:
            raise AssertionError(f"federation: study {s} has "
                                 f"{fed.study_info(s)['n_obs']} "
                                 f"observations after the revive, not {want}")
    again = one_round(calm[0])
    for s, u in again.items():
        if u != lost[s]:
            raise AssertionError(f"federation: study {s}'s lost round did "
                                 "not re-derive bit for bit")
        if u in streams[s]:
            raise AssertionError(f"federation: study {s} replayed a "
                                 "pre-crash suggestion")
    line.update(killed_studies=calm[0], survivor_studies=calm[1],
                survivor_served_while_down=len(survivor))
    return line


COUNTED_WORKER = '''\
"""`python -m repro_torch.hpo.shard_worker ARGS` run as `{script} -m
repro_torch.hpo.shard_worker ARGS`, which also writes the worker's kernel
launches, its fused-EI launches that missed the plan table and the plan
keys it read to <ckpt-dir>/launches-<pid>.json when it exits (a worker
that is SIGKILLed writes none, nor does a standby never given a store)."""
import json
import os
import sys

args = sys.argv[1:]
if args[:2] != ["-m", "repro_torch.hpo.shard_worker"]:
    raise SystemExit(f"not a shard worker command: {{args}}")
argv = args[2:]
from repro_torch.hpo import transport  # noqa: E402

served = []         # the store it served: from --ckpt-dir or an assignment
serve = transport._worker_main


async def counted_main(ckpt_dir, *rest):
    served.append(ckpt_dir)
    return await serve(ckpt_dir, *rest)
transport._worker_main = counted_main

try:
    rc = transport.main(argv)
finally:
    from repro_torch.kernels import KERNEL_MODULES, acq, trsv
    counts = {{m.__name__.rsplit(".", 1)[1]: m.LAUNCHES
              for m in KERNEL_MODULES}}
    counts["acq_mixed"] = acq.LAUNCHES_MIXED
    counts["trsv_general"] = trsv.LAUNCHES_GENERAL
    counts["acq_misses"] = acq.MISSES
    counts["acq_launches"] = [[*k, c] for k, c in
                              sorted(acq.KEY_LAUNCHES.items())]
    for d in served:
        with open(os.path.join(d, f"launches-{{os.getpid()}}.json"),
                  "w") as f:
            json.dump(counts, f)
sys.exit(rc)
'''


def counted_worker() -> str:
    """The interpreter C's `TransportConfig.python` names: a script beside
    the kernel libraries (`build/`) whose first line runs this Python, and
    which runs the shard worker's `main` as `-m` would, then writes the
    worker's launch counts into its shard directory (`worker_launches`)."""
    from repro_torch.kernels import _build
    path = _build.BUILD_DIR.parent / "counted_shard_worker.py"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(f"#!{sys.executable}\n"
                    + COUNTED_WORKER.format(script=path.name))
    path.chmod(0o755)
    return str(path)


def worker_launches(c) -> dict:
    """The launch counts that C's workers wrote as they exited, by shard
    (one entry a worker lifetime that ended in a shutdown), their sum, and
    the workers' fused-EI table misses and launches by plan key and
    studies (`acq_misses`, `acq_launches`: [plan_rows, n, d, form,
    studies, launches] rows)."""
    import glob
    total = {k: 0 for k in read_counts()}
    by_shard, misses, keys = {}, 0, collections.Counter()
    for i in range(FED_SHARDS):
        by_shard[i] = []
        for path in sorted(glob.glob(os.path.join(c.shard_dir(i),
                                                  "launches-*.json"))):
            with open(path) as f:
                counts = json.load(f)
            misses += counts.pop("acq_misses")
            keys.update({tuple(k[:-1]): k[-1]
                         for k in counts.pop("acq_launches")})
            by_shard[i].append(counts)
            total = add_counts(total, counts)
    return {"by_shard": by_shard, "total": total, "acq_misses": misses,
            "acq_launches": [[*k, c] for k, c in sorted(keys.items())]}


def timed_transport(dev, template, root):
    """Federation C: a `TransportFederation` of 2 spawned shard workers on
    `dev` (each spawned through `counted_worker`), heartbeats on (period
    FED_HEARTBEAT_S, the reference's deadline and miss limit), timing each
    worker's spawn to its endpoint and each ping's reply, and recording
    why a shard was marked dead."""
    from repro_torch.hpo import (FederationConfig, GatewayConfig,
                                 TransportConfig, TransportFederation)
    python = counted_worker()

    class Timed(TransportFederation):
        def __init__(self):
            super().__init__(template, federation_cfg(root),
                             GatewayConfig(**FED),
                             FederationConfig(n_shards=FED_SHARDS),
                             TransportConfig(heartbeat_s=FED_HEARTBEAT_S,
                                             python=python),
                             device=dev)
            self.spawn_s = {i: [] for i in range(FED_SHARDS)}
            self.ping_ms = {i: [] for i in range(FED_SHARDS)}
            self.dead = []

        async def _spawn_shard(self, i, standby=False):
            t0 = time.perf_counter()
            client = await super()._spawn_shard(i, standby)
            self.spawn_s[i].append(time.perf_counter() - t0)
            call = client.call

            async def timed_call(op, _timeout=None, **args):
                t = time.perf_counter()
                try:
                    return await call(op, _timeout=_timeout, **args)
                finally:
                    if op == "ping":
                        self.ping_ms[i].append(
                            1e3 * (time.perf_counter() - t))
            client.call = timed_call
            return client

        def _mark_dead(self, i, reason):
            self.dead.append(reason)
            super()._mark_dead(i, reason)

        def report(self) -> dict:
            return {"spawn_to_endpoint_s": self.spawn_s,
                    "pings": {i: len(v) for i, v in self.ping_ms.items()},
                    "slowest_ping_ms": {i: max(v, default=None)
                                        for i, v in self.ping_ms.items()},
                    "marked_dead": self.dead}

        def healthy(self, killed=()) -> None:
            bad = [r for r in self.dead if not any(
                r == f"shard {i} killed" for i in killed)]
            if bad:
                raise AssertionError(f"federation C: heartbeats marked a "
                                     f"live shard dead: {bad}; "
                                     f"{self.report()}")
    return Timed()


async def close_transport(c) -> None:
    """Shut C's workers and its standby down and wait for every one to
    exit; kill any that does not."""
    children = [p for p in [*c.procs, c.standby] if p is not None]
    try:
        await asyncio.wait_for(c.aclose(), 60)
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p is not None for p in [*c.procs, c.standby]):
        raise AssertionError("federation C: a worker outlived aclose()")


async def rpc_trace(c, objective, moved_sid) -> dict:
    """Step 1's trace through C's RPC surface: each round's due tells and
    a drain, then its asks gathered (each worker's ticker coalesces them)
    and a drain; after round FED_MIGRATE_ROUND, A's moved study moves and
    C rebalances.  The same per-study event order as A's trace."""
    sids = c.study_ids()
    streams = {s: [] for s in sids}
    to_tell, moves = [], {}
    for r in range(GATEWAY_ROUNDS):
        for item in [x for x in to_tell if x[0] <= r]:
            _, s, trials = item
            for t, v in zip(trials, gateway_values(objective, trials)):
                await c.tell(s, t, v)
            to_tell.remove(item)
        await c.drain()
        askers = trace_askers(r, len(sids))
        got = await asyncio.gather(*(c.ask(
            s, GATEWAY_Q if (r % 3 == 2 and i == 0) else 1)
            for i, s in enumerate(askers)))
        for s, res in zip(askers, got):
            trials = res if isinstance(res, list) else [res]
            streams[s] += [t.unit.tobytes() for t in trials]
            to_tell.append((r + 2, s, trials))
        await c.drain()
        if r == FED_MIGRATE_ROUND:
            src = c.shard_of(moved_sid)
            t0 = time.perf_counter()
            await c.migrate_study(moved_sid, 1 - src)
            moves = {"sid": moved_sid, "src": src,
                     "migrate_ms": 1e3 * (time.perf_counter() - t0)}
            moves["rebalance"] = await c.rebalance()
    for _, s, trials in to_tell:
        for t, v in zip(trials, gateway_values(objective, trials)):
            await c.tell(s, t, v)
    await c.drain()
    return {"streams": streams, "moves": moves}


async def transport_steps(dev, template, root, records, objective, twin,
                          views) -> dict:
    """Step 3: C seeded like A (`start()` loads the registry epoch and
    reconciles each worker), the trace over RPC: streams, moves and
    n_obs / best_value as A's, each resident study's `state_digest` over
    RPC A's; then `checkpoint()`, one round on two studies of each shard,
    SIGKILL of worker 0, a survivor's round, `revive_shard(0)`: shard 0
    back at the epoch, its next suggestions the lost round's."""
    c = timed_transport(dev, template, root)
    try:
        t0 = time.perf_counter()
        if not await c.start():
            raise AssertionError("federation C: no registry epoch loaded")
        line = {"start_s": time.perf_counter() - t0}
        adopted_as_recorded([(await c.study_info(r["sid"]))["n_obs"]
                             for r in records], records)
        t0 = time.perf_counter()
        trace = await rpc_trace(c, objective, twin["moves"]["sid"])
        line["trace_s"] = time.perf_counter() - t0
        if trace["streams"] != twin["streams"]:
            raise AssertionError("federation C: suggestions differ from A's")
        if trace["moves"]["rebalance"] != twin["moves"]["rebalance"]:
            raise AssertionError(f"federation C: rebalance moved "
                                 f"{trace['moves']['rebalance']}, A "
                                 f"{twin['moves']['rebalance']}")
        line["moves"] = trace["moves"]
        compared = 0
        for s in c.study_ids():
            info = await c.study_info(s)
            for k in ("n_obs", "best_value"):
                if info[k] != views[s][k]:
                    raise AssertionError(f"federation C: study {s}'s {k}")
            dig = await c._client_for(s).call("state_digest", sid=s)
            if dig is not None:
                compared += 1
                if dig != views[s]["digest"]:
                    raise AssertionError(f"federation C: study {s}'s state "
                                         "digest differs from A's")
        if compared < FED["slots"]:
            raise AssertionError(f"federation C: {compared} resident "
                                 "studies to compare")
        line["digests_equal"] = compared
        # the SIGKILL: one round told but not committed, then worker 0
        await c.checkpoint()
        by_shard = {i: [s for s in c.study_ids() if c.shard_of(s) == i]
                    [:FED_LOST] for i in range(FED_SHARDS)}
        n0 = {s: (await c.study_info(s))["n_obs"]
              for ss in by_shard.values() for s in ss}

        async def one_round(sids):
            trials = await asyncio.gather(*(c.ask(s) for s in sids))
            for s, t in zip(sids, trials):
                await c.tell(s, t, gateway_values(objective, [t])[0])
            await c.drain()
            return {s: t.unit.tobytes() for s, t in zip(sids, trials)}
        lost = await one_round(by_shard[0] + by_shard[1])
        standby_pid = c.standby.pid
        c.kill_shard(0)
        if c.procs[0].poll() != -signal.SIGKILL:
            raise AssertionError("federation C: worker 0 not killed")
        await one_round(by_shard[1])
        t0 = time.perf_counter()
        await c.revive_shard(0)
        line["revive_s"] = time.perf_counter() - t0
        line["revive_start"] = c.worker_starts[-1]
        if c.procs[0].pid != standby_pid or "standby_s" not in \
                line["revive_start"]:
            raise AssertionError("federation C: shard 0 was not revived "
                                 "in the standby worker")
        for s, n in n0.items():
            want = n if c.shard_of(s) == 0 else n + 2
            got = (await c.study_info(s))["n_obs"]
            if got != want:
                raise AssertionError(f"federation C: study {s} has {got} "
                                     f"observations after the revive, not "
                                     f"{want}")
        again = await one_round(by_shard[0])
        for s, u in again.items():
            if u != lost[s] or u in trace["streams"][s]:
                raise AssertionError(f"federation C: study {s}'s round "
                                     "after the revive")
        line["killed_studies"] = by_shard[0]
        c.healthy(killed=(0,))
        line.update(c.report())
    finally:
        await close_transport(c)
    line["launches"] = worker_launches(c)
    return line


async def federation_clients(fed, objective) -> dict:
    """Step 4: the gateway phase's 24 asyncio clients on a federation (A
    in process, C over RPC), timed from the first ask to the drain."""
    sids = fed.study_ids()
    n0 = {s: (await settled(fed.study_info(s)))["n_obs"] for s in sids}
    stats = {"tells": {}}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    await asyncio.gather(*(gateway_client(
        fed, s, objective, CLIENT_ASKS,
        GATEWAY_Q if s in CLIENT_Q_SIDS else 1,
        TIER_ASKS if s == 0 else 0, stats) for s in sids))
    await fed.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summ = await settled(fed.summary())
    tells = stats["tells"]
    info = {s: await settled(fed.study_info(s)) for s in sids}
    if info[0]["tier"] != 1 or summ["escalated"] != 1:
        raise AssertionError("federation: client 0's study was not promoted")
    for s in sids:
        if info[s]["n_obs"] != n0[s] + tells.get(s, 0):
            raise AssertionError(f"federation: study {s} absorbed "
                                 f"{info[s]['n_obs'] - n0[s]} of "
                                 f"{tells.get(s, 0)} tells")
    if summ["absorbed"] != sum(tells.values()) or any(
            gw.dead_tells for gw in getattr(fed, "shards", ())):
        raise AssertionError("federation: tells not absorbed")
    shards = summ["per_shard"]
    return {"seconds": wall, "suggestions": summ["asks_served"],
            "suggestions_per_s": summ["asks_served"] / wall,
            "ticks": summ["ticks"],
            "p50_tick_ms": {i: s["p50_tick_ms"] for i, s in shards.items()},
            "p95_tick_ms": {i: s["p95_tick_ms"] for i, s in shards.items()},
            "mean_coalesce_width": {i: s["mean_coalesce_width"]
                                    for i, s in shards.items()},
            "evictions": summ["evictions"], "restores": summ["restores"],
            "q_width_hist": summ["q_width_hist"],
            "client0_asks": tells[0], "client0_n_obs": info[0]["n_obs"]}


async def transport_clients(dev, template, root, objective) -> dict:
    c = timed_transport(dev, template, root)
    try:
        t0 = time.perf_counter()
        if not await c.start():
            raise AssertionError("federation C: no registry epoch loaded")
        start_s = time.perf_counter() - t0
        run = await federation_clients(c, objective)
        c.healthy()
        run.update(start_s=start_s, **c.report())
    finally:
        await close_transport(c)
    run["launches"] = worker_launches(c)
    return run


def require_launches(what, counts) -> None:
    """The federation phase's gate: each kernel of the float path launched
    at least once in `what`'s own run."""
    for k in ("matern", "acq", "chol", "trsv"):
        if not counts[k]:
            raise AssertionError(f"federation: no {k} launch on {what}")


def federation_path(dev, pair, gateway_line) -> tuple[dict, dict]:
    """Phase federation: the port's `FederatedGateway` (A: 2 shards of the
    gateway phase's gateway, 8 slots each, in this process) beside a
    16-slot `StudyGateway` (B, its single-pool twin) and a
    `TransportFederation` (C: 2 shard worker processes on the same card),
    all over the gateway phase's 24 logical studies, seeded through the
    federation's recovery path (`federation_root`: snapshots in each
    study's ring shard, a registry epoch, `restore()` / `start()`).
    Counts set to 0 after B is built and before A is, read after step 4;
    B's launches (its pool calls in the trace, held to the trace's
    launches beside A's, and its views) are taken out, so the counts are
    A's own: its build, trace, recovery and client runs.  C's workers
    count in their own processes and write their counts as they exit
    (`counted_worker`); the SIGKILLed worker's lifetime is not counted.
    (1) The scripted trace on A and B, every pool call and tick counted,
    one study moved and a rebalance mid-trace: suggestions, state
    digests, ledgers, n_obs / best_value and lifetime counters A's = B's;
    (2) A's checkpoint (ms, bytes), an uncommitted round, kill_shard(0)
    and revive_shard(0): the recovery law; (3) C: the trace over RPC,
    equal to A's (digests over RPC), then a SIGKILL of worker 0 and its
    revival; (4) 24 asyncio clients on A, then on C (one run of each),
    each fresh from the records: suggestions a second and tick ms by
    shard, beside the gateway phase's.  Returns A's launches, the sum of
    C's workers' and the workers' (fused-EI table misses, plan keys)."""
    import shutil
    import tempfile
    start = time.perf_counter()
    studies, objective = pair.studies, pair.studies[0].objective
    template = studies[0].space
    roots = {k: tempfile.mkdtemp(prefix=f"chip_smoke_fed{k}_")
             for k in ("a", "b", "c")}
    try:
        t0 = time.perf_counter()
        records = federation_root(pair.a, studies, roots["a"])
        gateway_records(pair.a, studies, [roots["b"]])
        federation_root(pair.a, studies, roots["c"])
        line = {"phase": "federation", "shards": FED_SHARDS,
                "slots_per_shard": FED["slots"],
                "logical_studies": len(records) + GATEWAY_FRESH,
                "n_max": N_MAX, "records_seconds": time.perf_counter() - t0}
        b = CountedGateway("B", gateway_from(dev, template, roots["b"],
                                             records))
        torch.cuda.synchronize()
        reset_counts()
        a = CountedFederation("A", federation_from(dev, template,
                                                   roots["a"], records))
        built = read_counts()
        line["placement"] = [sum(1 for s in a.fed.study_ids()
                                 if a.fed.shard_of(s) == i)
                             for i in range(FED_SHARDS)]
        t0 = time.perf_counter()
        twin = asyncio.run(federation_twin(a, b, objective))
        in_trace = diff_counts(read_counts(), built)
        if in_trace != add_counts(a.want, b.want):
            raise AssertionError(f"federation: the trace launched {in_trace}"
                                 f", A's pool calls {a.want} and B's "
                                 f"{b.want}")
        line["twin"] = {"seconds": time.perf_counter() - t0,
                        "suggestions": sum(len(v) for v in
                                           twin["streams"].values()),
                        "moves": twin["moves"], "launches": a.want,
                        "launches_b": b.want}
        sids = a.fed.study_ids()
        t0 = time.perf_counter()
        views = study_views_fed(a.fed, sids)
        before = read_counts()
        views_b = study_views(b.gw, sids)
        b_share = add_counts(b.want, diff_counts(read_counts(), before))
        views_equal("A against B", views, views_b)
        line["twin"]["views_seconds"] = time.perf_counter() - t0
        sa, sb = a.fed.summary(), b.gw.summary()
        for k in LIFETIME_KEYS:
            if sa[k] != sb[k]:
                raise AssertionError(f"federation: summary {k} {sa[k]} "
                                     f"against B's {sb[k]}")
        line["twin"]["summary"] = {k: sa[k] for k in LIFETIME_KEYS}
        del b
        line["recovery"] = asyncio.run(federation_recovery(
            a, objective, twin["streams"]))
        asyncio.run(a.fed.aclose())
        del a
        line["transport"] = asyncio.run(transport_steps(
            dev, template, roots["c"], records, objective, twin, views))
        workers = line["transport"]["launches"]["total"]
        worker_acq = [line["transport"]["launches"]]
        runs = []
        for k, kind in enumerate(("A", "C")):
            root = tempfile.mkdtemp(prefix=f"chip_smoke_fed{k}_")
            roots[f"client{k}"] = root
            federation_root(pair.a, studies, root)
            if kind == "A":
                fed = federation_from(dev, template, root, records)

                async def run_a():
                    try:
                        return await federation_clients(fed, objective)
                    finally:
                        await fed.aclose()
                run = asyncio.run(run_a())
                del fed
            else:
                run = asyncio.run(transport_clients(dev, template, root,
                                                    objective))
                workers = add_counts(workers, run["launches"]["total"])
                worker_acq.append(run["launches"])
            runs.append(dict(kind=kind, **run))
        line["clients"] = runs
        line["clients_median"] = {
            kind: {k: statistics.median(r[k] for r in runs
                                        if r["kind"] == kind)
                   for k in ("suggestions_per_s", "seconds")}
            for kind in ("A", "C")}
        line["gateway_clients_median"] = gateway_line["clients_median"]
        counts = diff_counts(read_counts(), b_share)
        line["launches"] = counts
        line["launches_b"] = b_share
        line["worker_launches"] = workers
        line["worker_acq_misses"] = sum(w["acq_misses"] for w in worker_acq)
        worker_keys = collections.Counter()
        for w in worker_acq:
            worker_keys.update({tuple(k[:-1]): k[-1]
                                for k in w["acq_launches"]})
        line["worker_acq_launches"] = [[*k, c] for k, c in
                                       sorted(worker_keys.items())]
    finally:
        for d in roots.values():
            shutil.rmtree(d, ignore_errors=True)
    line["seconds"] = time.perf_counter() - start
    emit(line)
    require_launches("A", counts)
    require_launches("C's workers", workers)
    return counts, workers, (line["worker_acq_misses"], worker_keys)


def study_views_fed(fed, sids) -> dict:
    """`study_views` of a federation, each study on its shard."""
    return {s: study_views(shard_gw(fed, s), [s])[s] for s in sids}


def trsv_launches(dev) -> dict:
    """Phase 8: one call of the general solve at each of `trsv_cases`'
    shapes and at B = I, n = 6144, under torch.profiler: each must be
    exactly one device kernel (`trsv_kernel`, no copy, no fill); its
    device ms."""
    from repro_torch.kernels import trsv
    cases = trsv_cases(dev)
    l = beyond_limit_factor(dev, 6144)
    cases["B=I, n=6144"] = (l, torch.eye(l.shape[-1], device=dev), False)
    out = {}
    for tag, (l, b, trans) in cases.items():
        split = device_split(lambda: trsv.trsv_cuda(l, b, trans=trans))
        names = [(e["name"], e["count"]) for e in split["by_name"]]
        if len(names) != 1 or names[0][1] != 1 or "trsv_kernel" not in names[0][0]:
            raise AssertionError(f"trsv {tag}: device activity {split['by_name']}")
        out[tag] = {"device_ms": split["busy_ms"], "kernel": names[0][0],
                    "plan": dataclasses.asdict(trsv.launch_plan(
                        l.shape[-1], b.shape[-1], l[..., 0, 0].numel(), trans))}
    emit({"phase": "profile", "kernel": "trsv general", "launch": out})
    return out


def record_ascent(opt, state, space) -> dict:
    """One more suggest on a mixed-space state (run after the counts were
    read) with every ascent iterate recorded: how many of the 64 restarts
    moved off their projected seed on the int, the one-hot and the float
    coordinates.  With lr * width = 0.05 below half the int's lattice step
    (1/12), the int snaps back to its seed value every step, and the
    one-hot block has no gradient.  Where EI underflows at every seed
    (raw values), nothing moves at all, so a standardized state shows the
    floats moving beside the ints that do not."""
    from repro_torch.core import acquisition as acq_mod
    from repro_torch.core.descriptor import project_units
    iterates = []
    eval_batch = acq_mod._make_eval_batch(state, opt.kernel, opt.cfg.acq,
                                          True)

    def recording(x):
        iterates.append(x.clone())
        return eval_batch(x)

    acq_mod.ascend_acquisition(
        recording, opt._unit_lo, opt._unit_hi, opt.cfg.acq,
        generator=opt.generator,
        project=lambda u: project_units(u, opt.desc))
    first, last = iterates[0], iterates[-1]
    moved = (first != last).cpu()
    desc = space.descriptor()
    return {"restarts": int(first.shape[0]),
            "int_moved": int(moved[:, desc.levels > 0].any(1).sum()),
            "onehot_moved": int(moved[:, desc.cat_mask > 0].any(1).sum()),
            "float_moved": int(moved[:, (desc.cont_mask > 0)
                                     & (desc.levels == 0)].any(1).sum())}


def cholesky_launches(dev) -> None:
    """Phase 8: the factor of the main path's refactor input and of the lag
    refit's batch, one call each under torch.profiler, must each be one
    device kernel (beside the wrapper's copy and the memset of the barrier
    counters); prints the launch plan.  Runs after the paths, since a
    profiling session leaves host overhead on later launches."""
    from repro_torch.kernels import chol, ops
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st, kern = levy_state(dev, gen)
    k_pad = ops.masked_gram(st.x_buf, st.n, kern, st.params)
    k_grid = grid_grams(st, kern)
    resident = chol.resident_ctas(dev)
    launch = {}
    for tag, kk in ((f"n={N_MAX}", k_pad), (f"{k_grid.shape[0]} x n={N_MAX}", k_grid)):
        split = device_split(lambda: chol.cholesky_cuda(kk))
        kernels = [e for e in split["by_name"]
                   if not e["name"].startswith(("Memcpy", "Memset"))]
        if len(kernels) != 1 or kernels[0]["count"] != 1 or "chol" not in kernels[0]["name"]:
            raise AssertionError(f"cholesky {tag}: device activity {split['by_name']}")
        groups, ctas = chol.launch_plan(kk[..., 0, 0].numel(), resident)
        launch[tag] = dict(groups=groups, ctas_per_group=ctas, **split)
    emit({"phase": "profile", "kernel": "cholesky", "resident_ctas": resident,
          "launch": launch})


def tri_inverse_launches(dev) -> None:
    """Phase 8: L X = I on the main path's refactor factor and on the lag
    refit's batch, one call each under torch.profiler, must each be one
    device kernel and nothing else (no identity built or copied); then
    one lag event by device time (`lag_event_split`)."""
    from repro_torch.kernels import chol, ops, trsv
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st, kern = levy_state(dev, gen)
    l_fac = chol.cholesky_cuda(ops.masked_gram(st.x_buf, st.n, kern, st.params))
    l_grid = chol.cholesky_cuda(grid_grams(st, kern))
    launch = {}
    for tag, lf in ((f"n={N_MAX}", l_fac), (f"{l_grid.shape[0]} x n={N_MAX}", l_grid)):
        split = device_split(lambda: trsv.tri_inverse_cuda(lf))
        names = [(e["name"], e["count"]) for e in split["by_name"]]
        if len(names) != 1 or names[0][1] != 1 or "tri_inverse" not in names[0][0]:
            raise AssertionError(f"tri_inverse {tag}: device activity {split['by_name']}")
        launch[tag] = split
    emit({"phase": "profile", "kernel": "trsv", "launch": launch,
          "lag_event": lag_event_split(dev)})


def ei_launches(dev) -> dict:
    """Phase 8: one call of each fused-EI form at r = 64, n = 1024 (the
    standardized states of the kernels phase's kind) under torch.profiler
    must be exactly one device kernel and nothing else: no copy, no memset
    (the scratch is kept across calls); its device ms, with the plan."""
    from repro_torch.core import gp
    from repro_torch.core.descriptor import project_units
    from repro_torch.kernels import acq
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st, kern = levy_state(dev, gen)
    fargs = ei_args(gp.refactor(st, kern),
                    torch.rand((64, DIM), generator=gen, device=dev))
    mst, mkern, desc = mixed_state(dev, gen)
    margs = ei_args(gp.refactor(mst, mkern), project_units(
        torch.rand((64, MIXED_DIM), generator=gen, device=dev), desc))
    out = {}
    for form, fn, args in (
            ("fused_ei_grad", lambda: acq.fused_ei_grad_cuda(*fargs), fargs),
            ("fused_ei_grad_mixed", lambda: acq.fused_ei_grad_mixed_cuda(
                *margs, desc.cont_mask, desc.cat_mask), margs)):
        split = device_split(fn)
        names = [(e["name"], e["count"]) for e in split["by_name"]]
        if len(names) != 1 or names[0][1] != 1 or "fused_ei" not in names[0][0]:
            raise AssertionError(f"{form}: device activity {split['by_name']}")
        plan = acq.call_plan(1, 64, N_MAX, args[0].shape[-1],
                             form.endswith("mixed"))
        out[form] = {"device_ms": split["busy_ms"], "kernel": names[0][0],
                     "plan": dataclasses.asdict(plan)}
    emit({"phase": "profile", "kernel": "fused_ei_grad", "launch": out})
    return out


def lag_event_split(dev) -> dict:
    """One lag event (`gp.refit_params`, then `gp.refactor`) on the Levy-5d
    refactor input under torch.profiler: device ms by kernel, so the
    solve's and the gram's shares of the lag round are read from device
    time, not from the host clock, with the number of device kernels the
    event ran.  Uses only entry points the parent tree also has."""
    from repro_torch.core import gp
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st, kern = levy_state(dev, gen)
    lag = device_split(lambda: gp.refactor(st, kern, gp.refit_params(st, kern)))
    solve_ms = sum(e["ms"] for e in lag["by_name"]
                   if "tri_inverse" in e["name"] or "trsv" in e["name"])
    gram_ms = sum(e["ms"] for e in lag["by_name"] if "gram" in e["name"])
    return {"n": st.n, "solve_ms": solve_ms,
            "solve_share_of_busy": solve_ms / lag["busy_ms"],
            "gram_ms": gram_ms,
            "gram_launches": sum(e["count"] for e in lag["by_name"]
                                 if "gram" in e["name"]),
            "device_kernels": sum(e["count"] for e in lag["by_name"]
                                  if not e["name"].startswith(("Memcpy", "Memset"))),
            "device_activities": sum(e["count"] for e in lag["by_name"]),
            "span_ms": lag["span_ms"], "busy_ms": lag["busy_ms"],
            "idle_ms": lag["idle_ms"], "by_name": lag["by_name"][:10]}


def gram_launches(dev) -> dict:
    """Phase 8: one call of each form under torch.profiler for the 1024^2
    Gram of the kernels phase, the lag refit's batch of 18 masked Grams
    (`lag_batch`), the refactor's single masked Gram and the append's
    column; each must be exactly one device kernel and nothing else (no
    copy, no fill, no stack); its device ms, with the plan."""
    from repro_torch.kernels import matern
    out = {}
    s2, rho = grid_params(dev)
    for name, f in gram_forms(dev).items():
        st, kern, p = f["state"], f["kern"], f["params"]
        col = st.x_buf[7:8] + 0.01
        calls = {
            "gram": (lambda: f["cuda"](f["x"], f["x"], p.sigma2, p.rho), 1,
                     st.n_max),
            "lag batch": (lambda: lag_batch(st, kern, s2, rho), 18, st.n_max),
            "masked single": (lambda: f["masked"](st.x_buf, st.n, p.sigma2, p.rho,
                                                  p.noise2), 1, st.n_max),
            "column": (lambda: f["cuda"](st.x_buf, col, p.sigma2, p.rho), 1, 1)}
        for tag, (fn, batch, m) in calls.items():
            split = device_split(fn)
            names = [(e["name"], e["count"]) for e in split["by_name"]]
            if len(names) != 1 or names[0][1] != 1 or "gram" not in names[0][0]:
                raise AssertionError(f"{name} {tag}: device activity {split['by_name']}")
            out[f"{name} {tag}"] = {
                "device_ms": split["busy_ms"], "kernel": names[0][0],
                "plan": dataclasses.asdict(matern.launch_plan(
                    st.n_max, m, st.dim, batch, m > 1, True))}
    emit({"phase": "profile", "kernel": "gram", "launch": out})
    return out


def profile_steps(name, driver, state, hist, steps: int = 4) -> None:
    """Phase 8: a few more BO rounds of a path (continuing its state) under
    torch.profiler: wall time, device busy time and its share, and the
    device time by kernel.  Runs after the launch counts were read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    opt, objective = driver
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = opt.step(state, objective, hist)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_kernel[e.key] = (us / 1e3, e.count)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "profile", "path": name, "steps": steps,
          "wall_ms": 1e3 * wall, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / (1e3 * wall),
          "suggest_ms": [1e3 * t for t in hist.acq_seconds[-steps:]],
          "absorb_ms": [1e3 * t for t in hist.gp_seconds[-steps:]],
          "top_kernels": [{"name": k[:80], "ms": ms, "count": c}
                          for k, (ms, c) in top]})


# ---------------------------------------------------------------------------
# The language-model side: the trainer (phase `lm`) and an NN-HPO run that
# tunes it (phase `nn_hpo`).  Neither path reaches a hand-written kernel of
# the model; the NN-HPO run reaches the GP's through `run_bo`.
# ---------------------------------------------------------------------------

LM_ARCH = "tiny-lm"       # full CONFIG: 4 layers, d_model 256, 8 / 4 heads
LM_STEPS = 20             # AdamW steps of the uninterrupted run
LM_CKPT = 10              # the step the resumed run starts from
LM_BATCH, LM_SEQ = 8, 256  # examples/train_e2e.py's batch and sequence
LM_LR, LM_WARMUP = 1e-3, 2
LM_SEED = 0
TOL_LM_FIRST = 1e-4       # |loss_card - loss_cpu| / loss_cpu, first step
TOL_LM_RESUME = 1e-4      # resumed losses against the uninterrupted run's,
#                           relative: the same state and batches, so only
#                           the card's atomics (the embedding's backward)
#                           may move a bit
NN_BUDGET = 12            # benchmarks/bench_nn_hpo.py:21-80 at full width:
NN_SEED_POINTS = 4        # run_bo(lazy, n_seed 4, n_max budget + 12) over
NN_STEPS = 25             # RESNET_SPACE's unit cube; each trial 25 SGD-
NN_BATCH, NN_SEQ = 8, 64  # momentum steps at 8 x 64, eval accuracy on a
NN_EVAL_STEP = 10_000     # held-out step


def lm_args(ckpt_dir: str, device: str):
    from repro_torch.launch import train
    return train.parse_args([
        "--arch", LM_ARCH, "--steps", str(LM_STEPS), "--seq-len", str(LM_SEQ),
        "--global-batch", str(LM_BATCH), "--lr", str(LM_LR),
        "--warmup", str(LM_WARMUP), "--ckpt-dir", ckpt_dir,
        "--ckpt-every", str(LM_CKPT), "--log-every", "1",
        "--seed", str(LM_SEED), "--device", device])


def lm_first_step_on_cpu(dev) -> dict:
    """The first step's loss on the CPU from the card's parameters and batch
    (converted by tree path), beside the card's own eval of the same."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_tokens
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.common import count_params
    cfg = get_config(LM_ARCH)
    params, _ = init_params(cfg, LM_SEED, device=dev)
    batch = synth_tokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=LM_SEQ,
                                    global_batch=LM_BATCH, seed=LM_SEED), 0,
                         device=dev)
    cpu = torch.device("cpu")
    cpu_params = convert.lm_params_from_numpy(
        convert.lm_params_to_numpy(params), device=cpu)
    with torch.no_grad():
        card, _ = lm_loss(params, cfg, batch)
        host, _ = lm_loss(cpu_params, cfg, {k: v.to(cpu)
                                            for k, v in batch.items()})
    return {"card": float(card), "cpu": float(host),
            "n_params": count_params(params),
            "n_params_config": cfg.n_params()}


def lm_path(dev) -> tuple[dict, dict]:
    """Phase `lm`: tiny-lm's full config through `launch.train.run` on the
    card, 20 AdamW steps checkpointed at 10 and 20, then a second run from
    a copy of the step-10 checkpoint to 20.  Held: the first step's loss to
    the CPU's on the same converted parameters and batch, a falling loss,
    the resumed losses to the uninterrupted run's, no hand-written kernel
    launched.  Returns (launches, line)."""
    import shutil
    import tempfile
    from repro_torch.launch import train
    first = lm_first_step_on_cpu(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as root:
        whole, resumed = os.path.join(root, "a"), os.path.join(root, "b")
        reset_counts()
        # The reset lowers the peak only to what earlier phases still hold:
        # the trainer's own peak is the rise above that base.
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        a = train.run(lm_args(whole, dev.type))
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        step_dir = f"step_{LM_CKPT:09d}"
        shutil.copytree(os.path.join(whole, step_dir),
                        os.path.join(resumed, step_dir))
        b = train.run(lm_args(resumed, dev.type))
        launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"lm: hand-written kernels launched: {launches}")
    losses = a["losses"]
    if a["steps"] != list(range(LM_STEPS)) or not np.all(np.isfinite(losses)):
        raise AssertionError(f"lm: steps {a['steps']}, losses {losses}")
    first_rel = abs(losses[0] - first["cpu"]) / abs(first["cpu"])
    if first_rel > TOL_LM_FIRST:
        raise AssertionError(f"lm: first loss {losses[0]} on the card, "
                             f"{first['cpu']} on the CPU")
    falls = (losses[-1] < losses[0]
             and np.mean(losses[-5:]) < np.mean(losses[:5]))
    if not falls:
        raise AssertionError(f"lm: the loss does not fall: {losses}")
    if b["start"] != LM_CKPT or b["steps"] != list(range(LM_CKPT, LM_STEPS)):
        raise AssertionError(f"lm: resumed at {b['start']}, steps {b['steps']}")
    resume_rel = max(abs(x - y) / abs(y)
                     for x, y in zip(b["losses"], losses[LM_CKPT:]))
    if resume_rel > TOL_LM_RESUME:
        raise AssertionError(f"lm: resumed losses {b['losses']} against "
                             f"{losses[LM_CKPT:]}")
    step_s = np.diff(a["seconds"])
    median_ms = 1e3 * float(np.median(step_s))
    line = {"phase": "lm", "nvidia_smi": nvidia_smi_line(),
            "config": {"arch": LM_ARCH, "batch": LM_BATCH, "seq": LM_SEQ,
                       "steps": LM_STEPS, "optimizer": "adamw", "lr": LM_LR,
                       "warmup": LM_WARMUP},
            "n_params": first["n_params"],
            "n_params_config": first["n_params_config"],
            "first_loss": {"card": losses[0], "cpu": first["cpu"],
                           "card_eval": first["card"], "rel": first_rel,
                           "tol": TOL_LM_FIRST},
            "losses": losses, "loss_falls": bool(falls),
            "resume": {"from": LM_CKPT, "losses": b["losses"],
                       "uninterrupted": losses[LM_CKPT:],
                       "max_rel": resume_rel, "tol": TOL_LM_RESUME,
                       "bitwise": b["losses"] == losses[LM_CKPT:]},
            "first_step_ms": 1e3 * a["seconds"][0],
            "median_step_ms": median_ms,
            "step_ms": {"min": 1e3 * float(step_s.min()),
                        "max": 1e3 * float(step_s.max())},
            "tokens_per_s": LM_BATCH * LM_SEQ / (median_ms / 1e3),
            "peak_memory_bytes": peak, "memory_base_bytes": base,
            "seconds": seconds,
            "launches": launches}
    emit(line)
    return launches, line


# Device kernels of a step by kind, from their (truncated) names, first
# match wins: the GEMMs; the MoE's dispatch, combine and routing (indexing,
# scatters, sorts); copies and casts; reductions; other elementwise ops.
STEP_KINDS = (("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
              ("index_scatter_sort", ("index", "scatter", "gather", "sort",
                                      "radix")),
              ("copy_cast", ("copy", "memcpy", "memset")),
              ("reduce", ("reduce",)),
              ("elementwise", ("",)))


def step_kinds(by_name) -> dict:
    """`device_split`'s kernels summed by STEP_KINDS: {kind: [count, ms]}."""
    out = {kind: [0, 0.0] for kind, _ in STEP_KINDS}
    for k in by_name:
        name = k["name"].lower()
        kind = next(kind for kind, keys in STEP_KINDS
                    if any(key in name for key in keys))
        out[kind][0] += k["count"]
        out[kind][1] += k["ms"]
    return out


def lm_step_profile(dev, cfg=None, seq: int | None = None) -> dict:
    """One AdamW step of the `lm` phase's configuration (or `cfg`, at `seq`
    tokens a sequence, LM_SEQ by default) under
    torch.profiler (after every timed phase: a profiling session leaves
    host overhead on later launches): its device kernels, span, busy and
    idle time, beside the step's host time; then the step's AdamW update
    alone (`apply_updates` on the same state and one step's gradients)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_tokens
    from repro_torch.optim import OptimizerConfig, apply_updates
    from repro_torch.training import (init_train_state, make_loss_fn,
                                      make_train_step, value_and_grad)
    cfg = cfg or get_config(LM_ARCH)
    opt_cfg = OptimizerConfig(lr=LM_LR, warmup_steps=LM_WARMUP,
                              total_steps=LM_STEPS)
    params, opt_state, _ = init_train_state(cfg, opt_cfg, LM_SEED, device=dev)
    batch = synth_tokens(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=seq or LM_SEQ,
                                    global_batch=LM_BATCH, seed=LM_SEED), 0,
                         device=dev)
    step = make_train_step(cfg, opt_cfg)

    def one():
        step(params, opt_state, batch)

    split = device_split(one)
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    _, grads = value_and_grad(make_loss_fn(cfg), params, batch)
    opt = device_split(lambda: apply_updates(opt_cfg, params, grads,
                                             opt_state))
    del grads
    return {"nvidia_smi": nvidia_smi_line(), "host_ms": host_ms,
            "span_ms": split["span_ms"], "busy_ms": split["busy_ms"],
            "idle_ms": split["idle_ms"],
            "device_kernels": sum(k["count"] for k in split["by_name"]),
            "by_kind": step_kinds(split["by_name"]),
            "optimizer": {"span_ms": opt["span_ms"], "busy_ms": opt["busy_ms"],
                          "device_kernels": sum(k["count"]
                                                for k in opt["by_name"]),
                          "by_kind": step_kinds(opt["by_name"])},
            "top": split["by_name"][:15]}


def nn_objective(dev):
    """bench_nn_hpo's objective (benchmarks/bench_nn_hpo.py:21-80) on the
    port at tiny-lm's full width: each trial trains from the same seeded
    init for NN_STEPS SGD-momentum steps at the trial's lr / weight decay /
    momentum, which enter as 0-d tensors so every trial runs one code path
    (`examples.nn_objective.train_trial`), and returns the eval accuracy
    on a held-out step."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.examples.nn_objective import KNOBS, train_trial
    from repro_torch.hpo.space import RESNET_SPACE
    from repro_torch.models import init_params
    cfg = get_config(LM_ARCH)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=NN_SEQ,
                      global_batch=NN_BATCH, seed=7)
    params0, _ = init_params(cfg, 1, device=dev)
    eval_batch = next(DataIterator(dcfg, start_step=NN_EVAL_STEP, device=dev))
    it = DataIterator(dcfg, device=dev)
    batches = [next(it) for _ in range(NN_STEPS)]

    def objective(units: np.ndarray) -> np.ndarray:
        outs = []
        for u in np.atleast_2d(units):
            hp = RESNET_SPACE.to_hparams(u)
            knobs = [torch.tensor(hp[k], dtype=torch.float32, device=dev)
                     for k in KNOBS]
            outs.append(train_trial(cfg, params0, batches, eval_batch,
                                    knobs)["accuracy"])
        return np.asarray(outs)

    return objective


def nn_hpo_path(dev) -> tuple[dict, dict]:
    """Phase `nn_hpo`: the port's `run_bo` (lazy) tunes the trainer's
    SGD-momentum knobs.  Held: every accuracy finite in [0, 1], every
    suggestion in the unit cube, the Matérn gram, the Cholesky and the
    fused EI launched.  Returns (launches, line)."""
    from repro_torch.core import run_bo
    from repro_torch.hpo.space import RESNET_SPACE
    objective = nn_objective(dev)
    dim = RESNET_SPACE.dim
    reset_counts()
    t0 = time.perf_counter()
    state, hist = run_bo(objective, np.zeros(dim), np.ones(dim), NN_BUDGET,
                         dim=dim, mode="lazy", n_seed=NN_SEED_POINTS,
                         n_max=NN_BUDGET + 12, seed=0, device=dev.type)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    ys, xs = np.asarray(hist.ys), np.asarray(hist.xs)
    if len(ys) != NN_SEED_POINTS + NN_BUDGET or state.n != len(ys):
        raise AssertionError(f"nn_hpo: {len(ys)} trials, n {state.n}")
    if not (np.all(np.isfinite(ys)) and np.all((ys >= 0) & (ys <= 1))):
        raise AssertionError(f"nn_hpo: accuracies {ys.tolist()}")
    if not (np.all(xs >= 0.0) and np.all(xs <= 1.0)):
        raise AssertionError("nn_hpo: a suggestion left the unit cube")
    missing = [k for k in ("matern", "chol", "acq") if not launches[k]]
    if missing:
        raise AssertionError(f"nn_hpo: no launch of {missing}: {launches}")
    train_s = float(np.mean(hist.obj_seconds))
    gp_s = float(np.mean(hist.gp_seconds))
    acq_s = float(np.mean(hist.acq_seconds))
    traj, best = [], -np.inf
    for i, y in enumerate(hist.ys):
        if y > best:
            best = y
            traj.append([i, y])
    best_x, best_y = hist.best()
    line = {"phase": "nn_hpo", "nvidia_smi": nvidia_smi_line(),
            "config": {"arch": LM_ARCH, "steps": NN_STEPS, "batch": NN_BATCH,
                       "seq": NN_SEQ, "budget": NN_BUDGET,
                       "n_seed": NN_SEED_POINTS, "mode": "lazy"},
            "trial_s_mean": train_s, "gp_s_mean": gp_s,
            "suggest_s_mean": acq_s,
            "gp_share": gp_s / (train_s + gp_s),
            "gp_and_suggest_share": (gp_s + acq_s) / (train_s + gp_s + acq_s),
            "best_accuracy": best_y,
            "best_hparams": {k: float(v) for k, v in
                             RESNET_SPACE.to_hparams(best_x).items()},
            "trajectory": traj, "accuracies": ys.tolist(),
            "seconds": seconds, "launches": launches}
    emit(line)
    return launches, line


# ---------------------------------------------------------------------------
# The LM side's routed and latent-attention blocks at full width (phases
# `lm_moe`, `lm_mla`): granite-moe-3b-a800m and minicpm3-4b, depth cut to
# WIDE_LAYERS, 10 AdamW steps each through `training/steps.py`, bfloat16
# activations over float32 master weights.  Then (lm_moe) the launcher on
# qwen3-moe-30b-a3b's reduced config, checkpointed and resumed.  No hand-
# written kernel is on either path.
# ---------------------------------------------------------------------------

WIDE_LAYERS = 2           # depth cut: full width, 2 of 32 / 62 layers
WIDE_STEPS = 10
WIDE_BATCH, WIDE_SEQ = LM_BATCH, LM_SEQ   # 8 x 256: capacity 64 (granite)
WIDE_LR, WIDE_WARMUP = 1e-3, 2
WIDE_SEED = 0
TOL_WIDE_FIRST = 1e-3     # |loss_card - loss_cpu| / loss_cpu, first step.
#   The same bfloat16 function on both devices (every op rounds to
#   bfloat16, products accumulate in float32 on both), so only the order of
#   a product's sums differs; it moves a logit by an ulp at most, and the
#   loss averages 2048 tokens.  A flipped routing decision changes one
#   token's expert output.  1e-3 is the CPU parity tests' bfloat16 loss
#   tolerance for the same models (tests/test_torch_lm_model.py, BF16).
MOE_LAUNCH_ARCH = "qwen3-moe-30b-a3b"     # --reduced through the launcher
MOE_LAUNCH_STEPS, MOE_LAUNCH_CKPT = 10, 5
# The recurrent and encoder families at full width (phases `lm_frames`,
# `lm_mamba`, `lm_mlstm`): (phase, arch, depth, sequence), batch WIDE_BATCH.
# zamba2 at 12 of 38 layers fires its shared block twice (after layers 5
# and 11); 512 steps are two chunks of 256, so the carry between chunks
# runs on the card.
RECURRENT_PHASES = (("lm_frames", "hubert-xlarge", 2, 256),
                    ("lm_mamba", "zamba2-1.2b", 12, 512),
                    ("lm_mlstm", "xlstm-1.3b", 2, 512))
RECURRENT_CPU_ROWS = 1    # sequences of the batch whose loss the CPU checks
RECURRENCE_STEPS, RECURRENCE_CHUNK = 512, 256
TOL_RECURRENCE = 1e-4     # max |chunked - recurrent| / max |recurrent|,
#   float32 on the card at the full widths (outputs, and the final states;
#   the mLSTM's up to its stabilizer's gauge, C e^m).  The two forms sum in
#   other orders: on the CPU at these shapes 8e-6 (SSD outputs), 1.2e-5
#   (SSD state) and 5e-6 (mLSTM outputs).  tests/test_models.py holds the
#   reference's pair to 2e-4 elementwise.


def launch_config():
    """LAUNCH_ARCH at full width, WIDE_LAYERS layers, float32
    activations."""
    return dataclasses.replace(wide_config(LAUNCH_ARCH), dtype="float32")


def wide_config(arch: str, layers: int = WIDE_LAYERS):
    """`arch`'s full CONFIG with its depth cut to `layers`."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), num_layers=layers)


def first_layer_experts(params, cfg, tokens):
    """Layer 0's top-k experts of every (token, choice): the embedding, the
    attention sublayer, the norm and the router, as `forward` runs them."""
    from repro_torch.models.common import cast_tree, rms_norm, tree_map
    from repro_torch.models.model import attn_block_forward, layer_windows
    from repro_torch.models.moe import router_top_k
    act = cfg.activation_dtype
    lp = cast_tree(tree_map(lambda a: a[0], params["blocks"]), act)
    x = params["embed"].to(act)[tokens.long()]
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x, _ = attn_block_forward(lp, cfg, x, layer_windows(cfg)[0], positions)
    xn = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return router_top_k(xn, lp["moe"]["router"], cfg.top_k)[2]


def moe_launcher_args(ckpt_dir: str, device: str):
    from repro_torch.launch import train
    return train.parse_args([
        "--arch", MOE_LAUNCH_ARCH, "--reduced",
        "--steps", str(MOE_LAUNCH_STEPS), "--seq-len", str(WIDE_SEQ),
        "--global-batch", str(WIDE_BATCH), "--lr", str(WIDE_LR),
        "--warmup", str(WIDE_WARMUP), "--ckpt-dir", ckpt_dir,
        "--ckpt-every", str(MOE_LAUNCH_CKPT), "--log-every", "1",
        "--seed", str(WIDE_SEED), "--device", device])


def moe_launcher_resume(dev) -> dict:
    """The launcher on MOE_LAUNCH_ARCH's reduced config: 10 steps
    checkpointed at 5, then a run from a copy of the step-5 checkpoint,
    whose losses must equal the uninterrupted run's bit for bit."""
    import shutil
    import tempfile
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as root:
        whole, resumed = os.path.join(root, "a"), os.path.join(root, "b")
        a = train.run(moe_launcher_args(whole, dev.type))
        step_dir = f"step_{MOE_LAUNCH_CKPT:09d}"
        shutil.copytree(os.path.join(whole, step_dir),
                        os.path.join(resumed, step_dir))
        b = train.run(moe_launcher_args(resumed, dev.type))
    if a["steps"] != list(range(MOE_LAUNCH_STEPS)) \
            or not np.all(np.isfinite(a["losses"])):
        raise AssertionError(f"lm_moe launcher: steps {a['steps']}, "
                             f"losses {a['losses']}")
    if b["start"] != MOE_LAUNCH_CKPT \
            or b["steps"] != list(range(MOE_LAUNCH_CKPT, MOE_LAUNCH_STEPS)):
        raise AssertionError(f"lm_moe launcher: resumed at {b['start']}, "
                             f"steps {b['steps']}")
    bitwise = b["losses"] == a["losses"][MOE_LAUNCH_CKPT:]
    if not bitwise:
        raise AssertionError(f"lm_moe launcher: resumed losses {b['losses']} "
                             f"against {a['losses'][MOE_LAUNCH_CKPT:]}")
    return {"arch": MOE_LAUNCH_ARCH, "reduced": True,
            "steps": MOE_LAUNCH_STEPS, "losses": a["losses"],
            "resume": {"from": MOE_LAUNCH_CKPT, "losses": b["losses"],
                       "bitwise": bitwise}}


def wide_lm_path(dev, phase: str, arch: str, layers: int = WIDE_LAYERS,
                 seq: int = WIDE_SEQ,
                 cpu_rows: int | None = None) -> tuple[dict, dict]:
    """Phases `lm_moe` / `lm_mla` (and `lm_frames`, `lm_mamba`,
    `lm_mlstm`): `arch` at full width and `layers` layers, WIDE_STEPS AdamW
    steps at WIDE_BATCH x `seq` on the card.  Held: the first loss to the
    same loss on the CPU from the card's parameters and batch converted by
    tree path (TOL_WIDE_FIRST; with `cpu_rows`, the loss of the batch's
    first `cpu_rows` sequences on both), a falling loss, a finite aux, no
    hand-written kernel launched.  Printed: the parameter count, the
    losses, the share of layer 0's (token, choice) routing decisions that
    differ between card and CPU (MoE), median step ms after the first,
    tokens a second and the trainer's own peak memory above its base.
    Returns (launches, line)."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_tokens
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.common import count_params
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.training import make_train_step
    cfg = wide_config(arch, layers)
    cpu = torch.device("cpu")
    batch = synth_tokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=WIDE_BATCH, seed=WIDE_SEED,
                                    frontend=cfg.frontend,
                                    d_model=cfg.d_model), 0, device=dev)
    checked = batch if cpu_rows is None else {k: v[:cpu_rows]
                                              for k, v in batch.items()}
    cpu_batch = {k: v.to(cpu) for k, v in checked.items()}
    reset_counts()
    # The reset lowers the peak only to what earlier phases still hold: the
    # trainer's own peak is the rise above that base.
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, _ = init_params(cfg, WIDE_SEED, device=dev)
    init_s = time.perf_counter() - t0
    n_params = count_params(params)
    cpu_params = convert.lm_params_from_numpy(
        convert.lm_params_to_numpy(params), device=cpu)
    t0 = time.perf_counter()
    with torch.no_grad():
        card_eval, _ = lm_loss(params, cfg, batch)
        card_checked = card_eval if cpu_rows is None \
            else lm_loss(params, cfg, checked)[0]
        cpu_loss, cpu_metrics = lm_loss(cpu_params, cfg, cpu_batch)
        routing = None
        if cfg.is_moe:
            on_card = first_layer_experts(params, cfg, batch["inputs"]).cpu()
            on_cpu = first_layer_experts(cpu_params, cfg,
                                         cpu_batch["inputs"])
            routing = {"decisions": on_cpu.numel(),
                       "differ": int((on_card != on_cpu).sum()),
                       "share": float((on_card != on_cpu).float().mean())}
    cpu_s = time.perf_counter() - t0
    del cpu_params
    opt_cfg = OptimizerConfig(lr=WIDE_LR, warmup_steps=WIDE_WARMUP,
                              total_steps=WIDE_STEPS)
    opt_state = init_opt_state(opt_cfg, params)
    step = make_train_step(cfg, opt_cfg)
    losses, auxes, step_s = [], [], []
    for _ in range(WIDE_STEPS):
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        auxes.append(float(metrics["aux"]))
    peak = torch.cuda.max_memory_allocated() - base
    del params, opt_state, step
    torch.cuda.empty_cache()
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(auxes))):
        raise AssertionError(f"{phase}: losses {losses}, aux {auxes}")
    # The first step's loss is the whole batch's; with `cpu_rows`, the card
    # holds the checked sequences' loss against the CPU's.
    card_first = losses[0] if cpu_rows is None else float(card_checked)
    first_rel = abs(card_first - float(cpu_loss)) / abs(float(cpu_loss))
    if first_rel > TOL_WIDE_FIRST:
        raise AssertionError(f"{phase}: first loss {card_first} on the card, "
                             f"{float(cpu_loss)} on the CPU")
    falls = (losses[-1] < losses[0]
             and np.mean(losses[-3:]) < np.mean(losses[:3]))
    if not falls:
        raise AssertionError(f"{phase}: the loss does not fall: {losses}")
    median_ms = 1e3 * float(np.median(step_s[1:]))
    line = {"phase": phase, "nvidia_smi": nvidia_smi_line(),
            "config": {"arch": arch, "num_layers": cfg.num_layers,
                       "reduced": {"num_layers": [cfg.num_layers,
                                                  get_config(arch).num_layers]},
                       "d_model": cfg.d_model, "batch": WIDE_BATCH,
                       "seq": seq, "steps": WIDE_STEPS,
                       "cpu_rows": cpu_rows or WIDE_BATCH,
                       "optimizer": "adamw", "lr": WIDE_LR,
                       "warmup": WIDE_WARMUP, "dtype": cfg.dtype,
                       "param_dtype": cfg.param_dtype},
            "n_params": n_params, "n_params_config": cfg.n_params(),
            "init_s": init_s, "cpu_check_s": cpu_s,
            "first_loss": {"card": card_first, "cpu": float(cpu_loss),
                           "card_step": losses[0],
                           "card_eval": float(card_eval), "rel": first_rel,
                           "tol": TOL_WIDE_FIRST},
            "losses": losses, "aux": auxes, "loss_falls": bool(falls),
            "routing_layer0": routing,
            "first_step_ms": 1e3 * step_s[0], "median_step_ms": median_ms,
            "step_ms": {"min": 1e3 * min(step_s[1:]),
                        "max": 1e3 * max(step_s[1:])},
            "tokens_per_s": WIDE_BATCH * seq / (median_ms / 1e3),
            "peak_memory_bytes": peak, "memory_base_bytes": base}
    if cfg.is_moe:
        line["launcher"] = moe_launcher_resume(dev)
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"{phase}: hand-written kernels launched: "
                             f"{launches}")
    line["launches"] = launches
    emit(line)
    return launches, line


def recurrence_check(dev) -> dict:
    """The chunked scans against their per-token recurrences on the card, in
    float32, at the full configs' widths: zamba2's SSD (64 heads of 64,
    state 64, one group) with an initial state, and xlstm's mLSTM (4 heads
    of 512), one sequence of RECURRENCE_STEPS steps in chunks of
    RECURRENCE_CHUNK.  Held to TOL_RECURRENCE: the outputs and the final
    states (the mLSTM's up to its stabilizer's gauge)."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import ssm, xlstm
    gen = torch.Generator(device=dev)
    gen.manual_seed(WIDE_SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    zcfg, xcfg = get_config("zamba2-1.2b"), get_config("xlstm-1.3b")
    steps = RECURRENCE_STEPS
    h = zcfg.ssm_expand * zcfg.d_model // zcfg.ssm_head_dim
    p, n, g = zcfg.ssm_head_dim, zcfg.ssm_state, zcfg.ssm_groups
    x, dt = randn(1, steps, h, p), F.softplus(randn(1, steps, h))
    a = -torch.exp(0.5 * randn(h))
    bm, cm = 0.3 * randn(1, steps, g, n), 0.3 * randn(1, steps, g, n)
    h0 = 0.1 * randn(1, h, p, n)
    t0 = time.perf_counter()
    y_chunk, s_chunk = ssm.ssd_chunked(x, dt, a, bm, cm,
                                       chunk=RECURRENCE_CHUNK, h0=h0,
                                       return_final_state=True)
    y_rec, s_rec = ssm.ssd_recurrent_ref(x, dt, a, bm, cm, h0=h0)
    torch.cuda.synchronize()
    ssd_s = time.perf_counter() - t0
    ssd = {"shape": {"heads": h, "head_dim": p, "state": n, "groups": g,
                     "steps": steps, "chunk": RECURRENCE_CHUNK, "h0": True},
           "y_rel": rel(y_chunk, y_rec), "state_rel": rel(s_chunk, s_rec),
           "seconds": ssd_s}
    hm = xcfg.mlstm_heads
    dh = int(xcfg.mlstm_pf * xcfg.d_model) // hm
    q, v = randn(1, steps, hm, dh), randn(1, steps, hm, dh)
    k = randn(1, steps, hm, dh) / dh ** 0.5
    logi, logf = randn(1, steps, hm), F.logsigmoid(randn(1, steps, hm) + 3.0)
    t0 = time.perf_counter()
    y_chunk, (c1, _, m1) = xlstm.mlstm_chunked(
        q, k, v, logi, logf, chunk=RECURRENCE_CHUNK, return_final_state=True)
    y_rec, (c2, _, m2) = xlstm.mlstm_recurrent_ref(q, k, v, logi, logf)
    torch.cuda.synchronize()
    mlstm = {"shape": {"heads": hm, "head_dim": dh, "steps": steps,
                       "chunk": RECURRENCE_CHUNK},
             "y_rel": rel(y_chunk, y_rec),
             "state_rel": rel(c1 * torch.exp(m1)[..., None, None],
                              c2 * torch.exp(m2)[..., None, None]),
             "seconds": time.perf_counter() - t0}
    line = {"phase": "recurrence", "nvidia_smi": nvidia_smi_line(),
            "dtype": "float32", "tol": TOL_RECURRENCE, "ssd": ssd,
            "mlstm": mlstm}
    worst = max(ssd["y_rel"], ssd["state_rel"], mlstm["y_rel"],
                mlstm["state_rel"])
    if not worst <= TOL_RECURRENCE:
        raise AssertionError(f"recurrence: chunked against recurrent "
                             f"{worst} > {TOL_RECURRENCE}: {line}")
    return line


# ---------------------------------------------------------------------------
# Phase `lm_serve`: the serving path (`init_cache`, `prefill`, `decode_step`)
# of five families at full width, depth the only cut.  No hand-written
# kernel is on it: no function of the reference's serving path reaches
# `pl.pallas_call`.
# ---------------------------------------------------------------------------

# (part, arch, layers, batch, prompt P, float32 decode steps, bfloat16 timed
# decode steps).  gemma3 at 6 of 34 layers is the least depth with both a
# local (window 1024) and a global layer; P = 1024 prefills within the
# window, every decode step is past it, and its forward over P + 1024 =
# 2048 takes the banded path, which needs a multiple of 1024 tokens.
# granite-moe, minicpm3, zamba2 and xlstm at the wide phases' depths:
# zamba2's decode carries on across two SSD chunks and two shared-KV slots
# (after layers 5 and 11), xlstm's from two mLSTM chunks.
SERVE_PARTS = (("gemma3", "gemma3-4b", 6, 2, 1024, 1024, 64),
               ("granite_moe", "granite-moe-3b-a800m", 2, 8, 512, 32, 32),
               ("minicpm3", "minicpm3-4b", 2, 8, 512, 32, 32),
               ("zamba2", "zamba2-1.2b", 12, 8, 512, 32, 32),
               ("xlstm", "xlstm-1.3b", 2, 8, 512, 32, 32))
SERVE_WARMUP = 2          # bfloat16 decode steps before the timed ones
SERVE_SEED = 0
SERVE_PROFILED = ("gemma3", "zamba2")   # one decode step each, profiled
TOL_SERVE = 1e-4          # max |decode - forward| / max |forward| of the
#   float32 logits (the prefill's at P - 1, each step's at its position),
#   and of the K/V and MLA latents of the cache after the steps against a
#   prefill over all P + K tokens: tests/test_models.py:55-83's 1e-4
#   (atol and rtol), made relative.  The recurrent states are held to
#   TOL_RECURRENCE (the mLSTM's up to its stabilizer's gauge, C e^m).


def dropless(cfg):
    """`cfg` with each expert's capacity a whole row (capacity factor E /
    top_k), so no token is dropped whatever the routing; unchanged without
    experts.  A decode step never drops (capacity 1 at one token a row),
    and a dropped token changes the hidden state it leaves, so the forward
    a decode step is held to must not drop either.  The reference test's
    4.0 is dropless at the reduced configs, but gives granite-moe's 40
    experts at top 8 0.8 of a row: in this phase's first call, one row's
    hot expert took more than that in layer 0, and the forward over 544
    tokens (capacity 440) kept tokens the prefill over 512 (capacity 416)
    dropped."""
    if not cfg.is_moe:
        return cfg
    return dataclasses.replace(cfg,
                               capacity_factor=cfg.num_experts / cfg.top_k)


@contextlib.contextmanager
def routing_log():
    """Record each `moe.router_top_k` call's expert choices (sorted per
    token) while active: one (B, S, k) tensor per MoE layer a forward."""
    from repro_torch.models import moe
    orig, log = moe.router_top_k, []

    def record(*args, **kwargs):
        out = orig(*args, **kwargs)
        log.append(out[2].sort(dim=-1).values)
        return out

    moe.router_top_k = record
    try:
        yield log
    finally:
        moe.router_top_k = orig


def routing_flips(full: list, served: list, layers: int) -> list:
    """(row, position, layer) of every token whose top-k experts differ
    between the full forward (`full`: one (B, P + K, k) per layer) and the
    served path (`served`: the prefill's (B, P, k) per layer, then each
    decode step's (B, 1, k) per layer)."""
    flips = []
    for layer in range(len(full)):
        mine = torch.cat(served[layer::layers], dim=1)
        differ = (mine != full[layer]).any(dim=-1).nonzero().tolist()
        flips += [{"row": r, "position": p, "layer": layer}
                  for r, p in differ]
    return flips


def serve_cache_errors(got: dict, want: dict, rows) -> dict:
    """Each cache leaf of `got` against `want`'s over the batch `rows`,
    relative to `want`'s largest entry there (batch axis 1 in every leaf);
    the mLSTM's c and n scaled by e^m first (the stabilizer's gauge)."""
    from repro_torch.checkpoint.store import _flatten_with_paths

    def leaves(cache):
        tree = {k: v for k, v in cache.items() if k != "pos"}
        if "mlstm" in tree:
            st = dict(tree["mlstm"])
            em = torch.exp(st.pop("m"))
            tree["mlstm"] = {"conv": st["conv"],
                             "c_e^m": st["c"] * em[..., None, None],
                             "n_e^m": st["n"] * em[..., None]}
        names, vals, _ = _flatten_with_paths(tree)
        return dict(zip(names, vals))

    a, b = leaves(got), leaves(want)
    return {k: float((a[k][:, rows].float() - b[k][:, rows].float()).abs()
                     .max() / b[k][:, rows].float().abs().max().clamp_min(
                         1e-30)) for k in b}


def serve_float32(params, cfg, toks, prompt: int, steps: int) -> dict:
    """Run (a), float32 activations (MoE dropless, `dropless`): prefill
    `prompt` tokens and `steps` teacher-forced decode steps, each logit row
    held to the card's full forward over prompt + steps at its position,
    and the cache after the steps to a prefill over all of them.  A token
    whose routing differs between the two forms (a near tie) is named, and
    its row is held only before it."""
    from repro_torch.models import (decode_step, forward,
                                    logits_from_hidden, prefill)
    b, total = toks.shape[0], prompt + steps
    with torch.no_grad(), routing_log() as log:
        x, _, _ = forward(params, cfg, toks[:, :total])
        full = list(log)
        log.clear()
        errs = torch.zeros((b, steps + 1), device=toks.device)
        scale = torch.zeros((steps + 1,), device=toks.device)

        def hold(j, got):
            ref = logits_from_hidden(params, cfg,
                                     x[:, prompt - 1 + j:prompt + j])
            errs[:, j] = (got - ref).abs().amax(dim=(1, 2))
            scale[j] = ref.abs().amax()

        logits, cache = prefill(params, cfg, toks[:, :prompt], total)
        hold(0, logits)
        for i in range(prompt, total):
            logits, cache = decode_step(params, cfg, cache,
                                        toks[:, i:i + 1])
            hold(i - prompt + 1, logits)
        served = list(log)
        log.clear()
        _, whole = prefill(params, cfg, toks[:, :total], total)
    flips = routing_flips(full, served, cfg.num_layers)
    first = {r: total for r in range(b)}
    for f in flips:
        first[f["row"]] = min(first[f["row"]], f["position"])
    held = torch.tensor([[prompt - 1 + j < first[r] for j in range(steps + 1)]
                         for r in range(b)], device=toks.device)
    rows = [r for r in range(b) if first[r] == total]
    if not rows or not bool(held.any()):
        raise AssertionError(f"lm_serve: every row has a routing flip: "
                             f"{flips[:8]}")
    rel = float(errs[held].max() / scale.max())
    prefill_rel = float(errs[:, 0][held[:, 0]].max() / scale[0]) \
        if bool(held[:, 0].any()) else None
    return {"logits_rel": rel, "prefill_rel": prefill_rel,
            "logits_scale": float(scale.max()), "held_positions":
            int(held.sum()), "routing_flips": flips[:16],
            "routing_flip_count": len(flips),
            "cache_rows": rows,
            "cache_rel": serve_cache_errors(cache, whole, rows)}


def serve_bfloat16(params, cfg, toks, prompt: int, steps: int) -> dict:
    """Run (b), the config's own dtype as served (MoE dropless, as run
    (a)): a prefill of `prompt` tokens (after one untimed prefill),
    SERVE_WARMUP + `steps` decode steps, each timed on the host clock
    around a synchronize, then one more under
    `torch.cuda.set_sync_debug_mode("error")`: a device read in a step (an
    .item(), a boolean-mask index, a blocking copy) raises.  Printed:
    prefill ms, the median step ms of the `steps` after the warm-up,
    tokens a second, the cache's bytes, the peak memory above the base
    (the weights and earlier parts' leftovers), every logit finite, and
    the share of positions whose argmax over the real vocabulary agrees
    with the same dtype's full forward."""
    from repro_torch.models import (decode_step, forward,
                                    logits_from_hidden, prefill)
    from repro_torch.models.common import tree_leaves
    b = toks.shape[0]
    total = prompt + SERVE_WARMUP + steps
    max_len = total + 1                 # room for the sync-free step
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        prefill(params, cfg, toks[:, :prompt], max_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, toks[:, :prompt], max_len)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        picks, finite = [logits[:, 0, :cfg.vocab_size].argmax(-1)], \
            [torch.isfinite(logits).all()]
        step_ms = []
        for i in range(prompt, total):
            t0 = time.perf_counter()
            logits, cache = decode_step(params, cfg, cache,
                                        toks[:, i:i + 1])
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            picks.append(logits[:, 0, :cfg.vocab_size].argmax(-1))
            finite.append(torch.isfinite(logits).all())
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode_step(params, cfg, cache, toks[:, total - 1:total])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        cache_bytes = sum(v.numel() * v.element_size()
                          for v in tree_leaves(cache)
                          if isinstance(v, torch.Tensor))
        x, _, _ = forward(params, cfg, toks)
        want = [logits_from_hidden(params, cfg, x[:, p:p + 1])
                [:, 0, :cfg.vocab_size].argmax(-1)
                for p in range(prompt - 1, total)]
    agree = torch.stack(picks) == torch.stack(want)
    median = float(np.median(step_ms[SERVE_WARMUP:]))
    return {"prefill_ms": prefill_ms,
            "decode_ms": {"median": median,
                          "min": min(step_ms[SERVE_WARMUP:]),
                          "max": max(step_ms[SERVE_WARMUP:]),
                          "warmup": step_ms[:SERVE_WARMUP]},
            "decode_tokens_per_s": b * 1e3 / median,
            "cache_bytes": cache_bytes, "cache_max_len": max_len,
            "sync_free_step": True,
            "peak_above_base_bytes": peak, "memory_base_bytes": base,
            "argmax_agree": float(agree.float().mean()),
            "argmax_positions": int(agree.numel()),
            "finite": bool(torch.stack(finite).all())}


def step_weight_bytes(params, cfg, batch: int) -> int:
    """Bytes of the float32 masters one decode step must read: every leaf
    once, but the embedding's `batch` gathered rows only (unless tied: then
    the head reads the whole table) and the expert tables' rows of real
    experts only (the padded ones never receive a token)."""
    from repro_torch.models.common import tree_leaves
    total = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    if "embed" in params and not cfg.tie_embeddings:
        emb = params["embed"]
        total -= (emb.shape[0] - batch) * emb.shape[1] * emb.element_size()
    for name in ("wi", "wg", "wo") if cfg.is_moe else ():
        table = params["blocks"]["moe"][name]        # (L, E_pad, ., .)
        unused = table.shape[1] - cfg.num_experts
        total -= table[:, :unused].numel() * table.element_size()
    return total


def lm_serve_path(dev) -> tuple[dict, dict, dict]:
    """Phase `lm_serve`: each of SERVE_PARTS at full width and its cut
    depth, float32 masters from `init_params` on the card, run twice, MoE
    dropless (`dropless`): (a) in float32, held to the card's own full
    forward and to a prefill over all the tokens (`serve_float32`); (b) in
    the config's own dtype, timed (`serve_bfloat16`), beside the weight
    bytes a step reads and the time they take at the memory rate.  Each
    part's weights are freed before the next, but those of SERVE_PROFILED,
    which the step profiles after the timed phases read.  Returns
    (launches, line, {part: (params, config, tokens, prompt)} of
    SERVE_PROFILED)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.common import count_params
    t_phase = time.perf_counter()
    reset_counts()
    parts, kept = {}, {}
    for part, arch, layers, batch, prompt, steps_a, steps_b in SERVE_PARTS:
        own = dropless(wide_config(arch, layers))
        cfg_a = dataclasses.replace(own, dtype="float32")
        t0 = time.perf_counter()
        params, _ = init_params(own, SERVE_SEED, device=dev)
        init_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev)
        gen.manual_seed(SERVE_SEED)
        total = prompt + max(steps_a, SERVE_WARMUP + steps_b)
        toks = torch.randint(0, own.vocab_size, (batch, total),
                             generator=gen, device=dev)
        t0 = time.perf_counter()
        run_a = serve_float32(params, cfg_a, toks, prompt, steps_a)
        run_a["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_b = serve_bfloat16(params, own, toks, prompt, steps_b)
        run_b["seconds"] = time.perf_counter() - t0
        weight_bytes = step_weight_bytes(params, own, batch)
        run_b["weight_bytes"] = weight_bytes
        run_b["weight_bound_ms"] = 1e3 * weight_bytes / PEAK_BYTES_PER_S
        worst_kv = max((v for k, v in run_a["cache_rel"].items()
                        if not k.startswith(("mamba/", "mlstm/"))),
                       default=0.0)
        worst_state = max((v for k, v in run_a["cache_rel"].items()
                           if k.startswith(("mamba/", "mlstm/"))),
                          default=0.0)
        parts[part] = {
            "arch": arch, "layers": [own.num_layers,
                                     get_config(arch).num_layers],
            "batch": batch, "prompt": prompt,
            "capacity_factor": own.capacity_factor if own.is_moe else None,
            "decode_steps": {"float32": steps_a,
                             own.dtype: SERVE_WARMUP + steps_b},
            "n_params": count_params(params), "init_s": init_s,
            "float32": run_a, own.dtype: run_b}
        if not (run_a["logits_rel"] <= TOL_SERVE
                and worst_kv <= TOL_SERVE
                and worst_state <= TOL_RECURRENCE):
            raise AssertionError(f"lm_serve {part}: float32 serving against "
                                 f"the forward: {run_a}")
        if not run_b["finite"]:
            raise AssertionError(f"lm_serve {part}: non-finite logits in "
                                 f"{own.dtype}")
        if part in SERVE_PROFILED:
            kept[part] = (params, own, toks, prompt)
        del params
        torch.cuda.empty_cache()
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"lm_serve: hand-written kernels launched: "
                             f"{launches}")
    line = {"phase": "lm_serve", "nvidia_smi": nvidia_smi_line(),
            "tol": {"logits_kv": TOL_SERVE, "states": TOL_RECURRENCE},
            "warmup_steps": SERVE_WARMUP, "seed": SERVE_SEED,
            "parts": parts, "launches": launches,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    return launches, line, kept


def serve_step_profile(part: str, params, cfg, toks, prompt: int) -> dict:
    """One decode step of a kept part under torch.profiler (after every
    timed phase): device kernels, span, busy and idle ms, by kind, top 10,
    from a fresh prefill with room for the profiled steps."""
    from repro_torch.models import decode_step, prefill
    with torch.no_grad():
        _, cache = prefill(params, cfg, toks[:, :prompt], prompt + 8)
        tok = toks[:, prompt:prompt + 1]
        split = device_split(lambda: decode_step(params, cfg, cache, tok))
    return {"part": f"lm_serve {part} decode step",
            "nvidia_smi": nvidia_smi_line(), "span_ms": split["span_ms"],
            "busy_ms": split["busy_ms"], "idle_ms": split["idle_ms"],
            "device_kernels": sum(k["count"] for k in split["by_name"]),
            "by_kind": step_kinds(split["by_name"]),
            "top": split["by_name"][:10]}


# ---------------------------------------------------------------------------
# Phase `launch`: the launch layer (launch/{mesh,sharding}.py, the sharded
# step, the MoE's expert-parallel path, launch/train.py --mesh-shape) on
# ranks that share the one card over gloo.
# ---------------------------------------------------------------------------

LAUNCH_ARCH = "qwen3-moe-30b-a3b"   # full width: d_model 2048, 128 experts
LAUNCH_STEPS = 3          # SGD-momentum steps, one device and 1x2 alike.
#   SGD-momentum, not AdamW: AdamW's two moments, and the pure update's old
#   and new copies of all three, took 69 GB on one device and 31 GB on
#   each rank (PR 34 calls 10-11), which left the 1x2 ranks no room on the
#   card beside the earlier phases' tensors.
LAUNCH_OPT = dict(name="sgdm", lr=WIDE_LR, momentum=0.9,
                  warmup_steps=WIDE_WARMUP, total_steps=LAUNCH_STEPS)
LAUNCH_RANKS = 2          # a 1x2 (data 1, model 2) mesh: 64 experts a rank
LAUNCH_SEED = 0
TOL_LAUNCH_LOSS = 1e-2    # |loss_1x2 - loss_1| a step, tests/test_launch.py:86
TOL_LAUNCH_PARAMS = 2e-2  # max |param_1x2 - param_1|, tests/test_launch.py:87
#   The reference's own bounds for its sharded step against one device.
#   Both runs take float32 activations (the config's widths, its
#   float32 masters): in bfloat16 the mesh's other order of sums flips
#   routing decisions, and AdamW's first updates (near sign steps) carry
#   the flips into every later step (PR 34 call 9: 1.67e-2 at step 3).
LAUNCH_RESUME_STEPS, LAUNCH_RESUME_CKPT = 10, 5
TOL_LAUNCH_RESUME_1X1 = 1e-2   # |loss_1x1 - loss_1x2| / loss_1x2 a step.
#   The reduced config runs in bfloat16 and routes each token to 2 of 8
#   experts: the first resumed step, from one state on one batch, already
#   flips routing decisions between the two meshes' sums (1.75e-2 in a loss
#   of 5.67 in the CPU rehearsal).  The reference's 1e-2 loss bound for a
#   sharded step, taken relative to the loss.

GLOO_PROBE = '''
import datetime, os, sys, torch, torch.distributed as dist
import torch.distributed._functional_collectives as fc
case, rank, store = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=60))
x = torch.arange(8, dtype=torch.float32, device="cuda") + rank
if case == "torch.distributed":
    sys.path.insert(0, sys.argv[4])
    from repro_torch.launch.mesh import gloo_collectives
    print("PROBE", gloo_collectives("cuda:0"), flush=True)
else:
    group = dist.group.WORLD
    y = {"all_gather_into_tensor": lambda: fc.all_gather_tensor(x, 0, group),
         "reduce_scatter_tensor": lambda: fc.reduce_scatter_tensor(
             x, "sum", 0, group),
         "all_reduce": lambda: fc.all_reduce(x, "sum", group)}[case]()
    y = fc.wait_tensor(y)
    torch.cuda.synchronize()
    print("PROBE", y.tolist(), flush=True)
dist.destroy_process_group()
'''


def gloo_probe(src: str) -> dict:
    """Which collectives gloo takes on CUDA tensors of two ranks on one
    card: the three from `torch.distributed` (`mesh.gloo_collectives`),
    and each functional one, the form DTensor calls, in its own pair of
    processes (a refusal may take the process down): "ok", or the exit
    code."""
    import tempfile
    cases = ("torch.distributed", "all_gather_into_tensor",
             "reduce_scatter_tensor", "all_reduce")
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_probe_") as root:
        running = {case: [subprocess.Popen(
            [sys.executable, "-c", GLOO_PROBE, case, str(r),
             os.path.join(root, case), src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
            for case in cases}
        for case, procs in running.items():
            results = []
            for p in procs:
                try:
                    text, _ = p.communicate(timeout=120)
                except subprocess.TimeoutExpired:
                    p.kill()
                    text, _ = p.communicate()
                said = [ln[6:] for ln in text.splitlines()
                        if ln.startswith("PROBE ")]
                results.append(said[0] if p.returncode == 0 and said
                               else f"exit {p.returncode}")
            out[case] = results[0] if case == "torch.distributed" else (
                "ok" if all(not r.startswith("exit") for r in results)
                else results)
    return out


def launch_rank(rank: int, world: int, store: str, src: str, out_dir: str,
                inbox, ready, device_type: str = "cuda") -> None:
    """Phase `launch` (b), one rank of the 1x2 mesh on cuda:0.  From
    `inbox`: (start, want), the one-device run's initial and final
    parameters shared from the parent's card; `start` placed by the rules
    (its shards copied), then `ready` told, so that the parent frees it;
    on "go" from `inbox`, LAUNCH_STEPS SGD-momentum steps through the sharded
    step on the same batches, then each local shard against the matching
    shard of `want`.  Writes rank<r>.json into `out_dir`.  (`device_type` "cpu" rehearses it on
    the CPU.)"""
    sys.path.insert(0, src)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.data import DataConfig, synth_tokens
    from repro_torch.core.gp import resolve_device
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding, train
    from repro_torch.models import init_params, moe
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.training import make_train_step
    on_card = device_type == "cuda"
    if on_card:
        resolve_device(device_type)     # fp32 like the reference
        torch.cuda.set_device(0)
    dev = torch.device(device_type, 0) if on_card else torch.device("cpu")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    if on_card:
        mesh_mod.shared_card_collectives()
    mesh = mesh_mod.make_mesh((1, world), ("data", "model"),
                              device_type=device_type)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = launch_config()
    rules = sharding.rules_for(LAUNCH_ARCH, mesh)
    t0 = time.perf_counter()
    _, specs = init_params(dataclasses.replace(cfg, d_model=8, d_ff=8,
                                               vocab_size=8, num_heads=2,
                                               num_kv_heads=2), 0,
                           device="cpu")
    start, want = inbox.get()
    params = sharding.distribute(start, specs, mesh, rules)
    del start
    ready.put(rank)
    if inbox.get() != "go":
        raise RuntimeError("launch (b): no go from the parent")
    init_s = time.perf_counter() - t0
    opt_cfg = OptimizerConfig(**LAUNCH_OPT)
    opt_state = init_opt_state(opt_cfg, params)
    raw = make_train_step(cfg, opt_cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=WIDE_SEQ,
                      global_batch=WIDE_BATCH, seed=LAUNCH_SEED)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i in range(LAUNCH_STEPS):
        batch = {k: distribute_tensor(
            v, mesh, sharding.placements(("data",) + (None,) * (v.ndim - 1),
                                         mesh, v.shape), src_data_rank=None)
            for k, v in synth_tokens(data, i, device=dev).items()}
        sync()
        t0 = time.perf_counter()
        with sharding.use_rules(mesh, rules), implicit_replication():
            params, opt_state, metrics = raw(params, opt_state, batch)
        loss = float(metrics["loss"].full_tensor())
        sync()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    diff = 0.0
    for p, w in zip(tree_leaves(params), tree_leaves(want)):
        ref = distribute_tensor(w, mesh, p.placements, src_data_rank=None)
        diff = max(diff, float((p.to_local().float()
                                - ref.to_local().float()).abs().max()))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "losses": losses, "init_s": init_s,
                   "step_ms": [1e3 * s for s in step_s],
                   "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                         if on_card else None),
                   "ep_calls": moe.EP_CALLS, "max_param_diff": diff,
                   "placements": {"embed": str(params["embed"].placements),
                                  "moe/wi": str(params["blocks"]["moe"][
                                      "wi"].placements)}}, f)
    dist.barrier()
    dist.destroy_process_group()


def launcher_losses(text: str) -> dict:
    got = {}
    for line in text.splitlines():
        if line.startswith("[train] step="):
            step, loss = line.split()[1:3]
            got[int(step.split("=")[1])] = float(loss.split("=")[1])
    return got


def launcher_runs(dev, src: str) -> dict:
    """Phase `launch` (c): `torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train --mesh-shape 1x2` on MOE_LAUNCH_ARCH's reduced
    config for 10 steps checkpointed at 5, then from a copy of the step-5
    checkpoint at 1x2 (the printed losses equal) and at 1x1 in this
    process (within TOL_LAUNCH_RESUME_1X1)."""
    import shutil
    import tempfile
    from repro_torch.launch import train

    def args(ckpt_dir):
        return ["--arch", MOE_LAUNCH_ARCH, "--reduced", "--steps",
                str(LAUNCH_RESUME_STEPS), "--seq-len", str(WIDE_SEQ),
                "--global-batch", str(WIDE_BATCH), "--lr", str(WIDE_LR),
                "--warmup", str(WIDE_WARMUP), "--ckpt-dir", ckpt_dir,
                "--ckpt-every", str(LAUNCH_RESUME_CKPT), "--log-every", "1",
                "--seed", str(WIDE_SEED), "--device", dev.type]

    def distributed(ckpt_dir):
        """The launcher's ranks, started; `finish` waits for them."""
        env = dict(os.environ, PYTHONPATH=src)
        return time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(LAUNCH_RANKS), "-m",
             "repro_torch.launch.train", "--mesh-shape",
             f"1x{LAUNCH_RANKS}", *args(ckpt_dir)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)

    def finish(started):
        t0, proc = started
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"launch (c): the launcher failed:\n"
                                 f"{out[-3000:]}{err[-3000:]}")
        return launcher_losses(out), time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as root:
        whole, b, c = (os.path.join(root, k) for k in "abc")
        losses, seconds = finish(distributed(whole))
        step_dir = f"step_{LAUNCH_RESUME_CKPT:09d}"
        for d in (b, c):
            shutil.copytree(os.path.join(whole, step_dir),
                            os.path.join(d, step_dir))
        running = distributed(b)        # the 1x1 resume meanwhile, here
        one = train.run(train.parse_args(args(c)))
        resumed, resumed_s = finish(running)
    if sorted(losses) != list(range(LAUNCH_RESUME_STEPS)) \
            or not np.all(np.isfinite(list(losses.values()))):
        raise AssertionError(f"launch (c): losses {losses}")
    tail = {s: losses[s] for s in range(LAUNCH_RESUME_CKPT,
                                        LAUNCH_RESUME_STEPS)}
    if resumed != tail:
        raise AssertionError(f"launch (c): the 1x2 resume printed {resumed}, "
                             f"the uninterrupted run {tail}")
    one_rel = max(abs(x - tail[s]) / abs(tail[s])
                  for s, x in zip(one["steps"], one["losses"]))
    if one["start"] != LAUNCH_RESUME_CKPT or one_rel > TOL_LAUNCH_RESUME_1X1:
        raise AssertionError(f"launch (c): the 1x1 resume from "
                             f"{one['start']}: {one['losses']} against "
                             f"{tail}")
    return {"arch": MOE_LAUNCH_ARCH, "reduced": True,
            "mesh": f"1x{LAUNCH_RANKS}", "steps": LAUNCH_RESUME_STEPS,
            "losses_printed": [losses[s] for s in sorted(losses)],
            "seconds": seconds,
            "resume_1x2": {"from": LAUNCH_RESUME_CKPT,
                           "losses_printed": [resumed[s]
                                              for s in sorted(resumed)],
                           "equal_to_uninterrupted": True,
                           "seconds": resumed_s},
            "resume_1x1": {"from": one["start"], "losses": one["losses"],
                           "max_rel_diff": one_rel,
                           "tol": TOL_LAUNCH_RESUME_1X1}}


def launch_path(dev) -> tuple[dict, dict]:
    """Phase `launch`, after lm_serve and before the profiles: the gloo
    probe, then (a) qwen3-moe-30b-a3b at full width and WIDE_LAYERS layers,
    LAUNCH_STEPS SGD-momentum steps at WIDE_BATCH x WIDE_SEQ on one
    device; (b)
    the same steps on LAUNCH_RANKS rank processes on cuda:0 (a 1x2 mesh,
    gloo, `mesh.shared_card_collectives`) through the sharded step, (a)'s
    initial and final parameters shared from this card: the
    expert-parallel count above 0 on every rank, each step's loss within
    TOL_LAUNCH_LOSS of (a)'s, the final parameters within
    TOL_LAUNCH_PARAMS; (c) the launcher (`launcher_runs`).  No
    hand-written kernel launched in this process.  Returns (launches,
    line)."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_tokens
    from repro_torch.models import init_params
    from repro_torch.models.common import count_params
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.training import make_train_step
    t_phase = time.perf_counter()
    src = os.path.dirname(os.path.abspath(
        sys.modules["repro_torch"].__file__)).rsplit(os.sep, 1)[0]
    reset_counts()
    probe = gloo_probe(src)
    cfg = launch_config()
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=WIDE_SEQ,
                      global_batch=WIDE_BATCH, seed=LAUNCH_SEED)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    start, _ = init_params(cfg, LAUNCH_SEED, device=dev)
    init_s = time.perf_counter() - t0
    opt_cfg = OptimizerConfig(**LAUNCH_OPT)
    params, opt_state = start, init_opt_state(opt_cfg, start)
    step = make_train_step(cfg, opt_cfg)
    losses, step_s = [], []
    for i in range(LAUNCH_STEPS):
        batch = synth_tokens(data, i, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    one = {"losses": losses, "step_ms": [1e3 * s for s in step_s],
           "peak_memory_bytes": torch.cuda.max_memory_allocated() - base,
           "n_params": count_params(start), "init_s": init_s}
    # The initial and final parameters stay on the card, shared with the
    # ranks; the initial ones until the ranks have copied their shards.
    del opt_state, step, metrics, batch
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as root:
        t0 = time.perf_counter()
        inboxes, ready = [ctx.Queue() for _ in range(LAUNCH_RANKS)], \
            ctx.Queue()
        procs = [ctx.Process(target=launch_rank, args=(
            r, LAUNCH_RANKS, os.path.join(root, "store"), src, root,
            inboxes[r], ready)) for r in range(LAUNCH_RANKS)]
        for p in procs:
            p.start()
        for box in inboxes:
            box.put((start, params))
        # Each rank has copied its shards of `start`: free it here.
        got = sorted(ready.get(timeout=600) for _ in range(LAUNCH_RANKS))
        if got != list(range(LAUNCH_RANKS)):
            raise AssertionError(f"launch (b): ranks ready {got}")
        del start
        torch.cuda.empty_cache()
        for box in inboxes:
            box.put("go")
        for p in procs:
            p.join(timeout=900)
        codes = [p.exitcode for p in procs]
        if any(p.is_alive() for p in procs):
            for p in procs:
                p.kill()
            raise AssertionError("launch (b): a rank did not finish")
        if codes != [0] * LAUNCH_RANKS:
            raise AssertionError(f"launch (b): rank exit codes {codes}")
        ranks = []
        for r in range(LAUNCH_RANKS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        ranks_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    sharded = ranks[0]["losses"]
    loss_diff = max(abs(a - b) for a, b in zip(sharded, losses))
    param_diff = max(r["max_param_diff"] for r in ranks)
    if not all(r["ep_calls"] > 0 for r in ranks):
        raise AssertionError(f"launch (b): expert-parallel calls "
                             f"{[r['ep_calls'] for r in ranks]}")
    if not all(r["losses"] == sharded for r in ranks):
        raise AssertionError(f"launch (b): the ranks' losses differ: "
                             f"{[r['losses'] for r in ranks]}")
    if loss_diff > TOL_LAUNCH_LOSS or param_diff > TOL_LAUNCH_PARAMS:
        raise AssertionError(f"launch (b): losses {sharded} against one "
                             f"device's {losses}, parameters {param_diff}")
    launcher = launcher_runs(dev, src)
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"launch: hand-written kernels launched: "
                             f"{launches}")
    line = {"phase": "launch", "nvidia_smi": nvidia_smi_line(),
            "gloo_probe": probe,
            "config": {"arch": LAUNCH_ARCH, "num_layers": cfg.num_layers,
                       "reduced": {"num_layers": [
                           cfg.num_layers, get_config(LAUNCH_ARCH).num_layers]},
                       "d_model": cfg.d_model, "experts": cfg.num_experts,
                       "top_k": cfg.top_k, "vocab": cfg.vocab_size,
                       "batch": WIDE_BATCH, "seq": WIDE_SEQ,
                       "steps": LAUNCH_STEPS, "optimizer": LAUNCH_OPT,
                       "dtype": cfg.dtype},
            "one_device": one,
            "mesh_1x2": {"ranks": LAUNCH_RANKS, "backend": "gloo",
                         "losses": sharded, "max_loss_diff": loss_diff,
                         "tol_loss": TOL_LAUNCH_LOSS,
                         "max_param_diff": param_diff,
                         "tol_params": TOL_LAUNCH_PARAMS,
                         "ep_calls": [r["ep_calls"] for r in ranks],
                         "peak_memory_bytes": [r["peak_memory_bytes"]
                                               for r in ranks],
                         "step_ms": [r["step_ms"] for r in ranks],
                         "placements": ranks[0]["placements"],
                         "init_s": [r["init_s"] for r in ranks],
                         "seconds": ranks_s},
            "launcher": launcher, "launches": launches,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    return launches, line


# --- the examples phase: the port's entry points as a user starts them ----

TORCH_DEFAULT_PRECISION = {   # PyTorch's defaults of `precision_flags`
    "matmul.allow_tf32": False, "cudnn.allow_tf32": True,
    "matmul.allow_bf16_reduced_precision_reduction": True}
REFERENCE_PRECISION = {k: False for k in TORCH_DEFAULT_PRECISION}
# (example, run, options) in order; {a} .. {e} are checkpoint directories
# of the phase (a second run on one resumes the first)
EXAMPLE_RUNS = (
    ("quickstart", "lazy", []),
    ("quickstart", "naive", ["--mode", "naive"]),
    ("quickstart", "lag32", ["--lag", "32"]),
    ("hpo_service", "first", ["--categorical-tenant", "--ckpt-dir", "{a}"]),
    ("hpo_service", "resumed", ["--categorical-tenant", "--ckpt-dir", "{a}"]),
    ("parallel_hpo", "first", ["--faults", "--ckpt-dir", "{b}"]),
    ("parallel_hpo", "resumed", ["--faults", "--ckpt-dir", "{b}"]),
    ("serve", "first", ["--ckpt-dir", "{c}"]),
    ("serve", "q4", ["--q", "4"]),
    ("serve", "resumed", ["--ckpt-dir", "{c}"]),
    ("serve_cluster", "kill", ["--kill"]),
    # the kill while every client still serves (6 trials of 0.05-0.1 s
    # and their asks outlast 0.3 s): the options of the CPU test
    ("serve_cluster", "kill mid-serve", ["--kill", "--latency", "0.05",
                                         "--kill-after", "0.3"]),
    ("train_e2e", "100m", ["--preset", "100m", "--steps", "50",
                           "--ckpt-dir", "{d}"]),
    ("train_e2e", "100m resumed", ["--preset", "100m", "--steps", "60",
                                   "--ckpt-dir", "{d}"]),
    ("train_e2e", "granite-3-2b", ["--arch", "granite-3-2b", "--reduced",
                                   "--steps", "20", "--ckpt-dir", "{e}"]),
)
# The examples' defaults the contracts read (their argparse defaults).
EX_QUICK_RUNS = 120 + 5           # --iterations + --seeds
EX_TENANTS, EX_TENANT_BUDGET = 8, 12           # hpo_service
EX_HPO_BUDGET = 16                             # parallel_hpo
EX_SERVE_STUDIES, EX_SERVE_BUDGET = 12, 8      # serve
EX_CLUSTER_STUDIES, EX_CLUSTER_BUDGET = 8, 6   # serve_cluster
EX_CLUSTER_RETRIES = 50       # the JAX example's failover budget a client


def example_contract(name: str, run: str, got: dict, runs: dict,
                     device_type: str = "cuda") -> None:
    """One example run's totals against the example's own contract at
    its options (`runs`: the earlier runs of the phase by (name, run)),
    its state on a device of `device_type`."""
    def need(ok, what):
        if not ok:
            raise AssertionError(f"examples: {name} {run}: {what}")

    if name == "quickstart":
        traj = list(got["best_after"].values())
        need(got["evals"] == EX_QUICK_RUNS, f"evals {got['evals']}")
        need(traj == sorted(traj) and got["best"] == traj[-1] <= 0.0
             and math.isfinite(got["best"]), f"best {traj}")
        need(got["device"].startswith(device_type), got["device"])
    elif name == "hpo_service":
        full = EX_TENANTS * EX_TENANT_BUDGET
        ns = {k: t["n"] for k, t in got["tenants"].items()}
        need(set(ns.values()) == {EX_TENANT_BUDGET}, f"tenants {ns}")
        need(got["absorbed"] == full and got["failures"] == 0,
             f"absorbed {got['absorbed']}, failures {got['failures']}")
        need(got["device"].startswith(device_type), got["device"])
        need(got["tenants"][f"tenant{EX_TENANTS - 1}"]["choice"] is not None,
             "no named choice for the categorical tenant")
        if run == "first":
            need(got["suggested"] == full and got["resumed"] is None,
                 f"served {got['suggested']}")
        else:
            need(got["suggested"] == 0 and got["resumed"] == ns,
                 f"served {got['suggested']}, resumed {got['resumed']}")
    elif name == "parallel_hpo":
        need(got["device"].startswith(device_type), got["device"])
        need(0.0 <= got["best"] <= 1.0, f"best accuracy {got['best']}")
        if run == "first":
            need(got["absorbed"] == EX_HPO_BUDGET and got["resumed"] is None
                 and got["failed"] == got["injected"] > 0,
                 f"absorbed {got['absorbed']}, failed {got['failed']} of "
                 f"{got['injected']} injected")
        else:
            first = runs[(name, "first")]
            need(got["resumed"] == first["absorbed"]
                 and got["absorbed"] == 2 * EX_HPO_BUDGET
                 and got["failed"] == first["injected"] + got["injected"],
                 f"resumed {got['resumed']}, absorbed {got['absorbed']}, "
                 f"failed {got['failed']}")
    elif name == "serve":
        done = 2 if run == "resumed" else 1
        full = EX_SERVE_STUDIES * EX_SERVE_BUDGET
        ns = {k: t["n"] for k, t in got["tenants"].items()}
        need(got["served"] == got["told"] == full
             and got["absorbed"] == done * full, f"served {got['served']}, "
             f"told {got['told']}, absorbed {got['absorbed']}")
        need(set(ns.values()) == {done * EX_SERVE_BUDGET}, f"tenants {ns}")
        need(got["evictions"] > 0, "no eviction with 12 studies on 4 slots")
        need(got["device"].startswith(device_type), got["device"])
        if run == "q4":
            need(got["fantasy_active"] == 0
                 and set(got["q_width_hist"]) == {"4"},
                 f"fantasies {got['fantasy_active']}, "
                 f"q widths {got['q_width_hist']}")
        if run == "resumed":
            need(got["resumed"] == {k: EX_SERVE_BUDGET for k in ns},
                 f"resumed {got['resumed']}")
    elif name == "serve_cluster":
        budget = EX_CLUSTER_BUDGET
        need(got["kill"] is not None and got["kill"]["revived"],
             f"kill {got['kill']}")
        need(len(got["tenants"]) == EX_CLUSTER_STUDIES
             and got["served"] == EX_CLUSTER_STUDIES * budget,
             f"served {got['served']}")
        for k, t in got["tenants"].items():
            # only the killed shard's uncommitted round may be lost
            lo = budget - 1 if t["shard"] == 0 else budget
            need(lo <= t["n"] <= budget, f"{k}: n {t['n']} on {t['shard']}")
        # the reference's budget (examples/serve_cluster.py:69-70), and the
        # revived shard served by the standby
        retries = got["client_retries"]
        need(len(retries) == EX_CLUSTER_STUDIES and max(retries.values())
             <= EX_CLUSTER_RETRIES, f"retries {retries}")
        starts = got["worker_starts"]
        need([w["shard"] for w in starts] == [0, 1, 0]
             and "standby_s" in starts[-1]
             and not any("standby_s" in w for w in starts[:-1]),
             f"worker starts {starts}")
    elif name == "train_e2e":
        losses = got["losses"]
        need(all(math.isfinite(x) for x in losses)
             and got["final_loss"] == losses[-1], f"losses {losses}")
        if run == "100m resumed":
            first = runs[(name, "100m")]
            need(got["start"] == 50 and got["steps"][0] == 50,
                 f"resumed at {got['start']}, steps {got['steps']}")
            need(got["final_loss"] < first["losses"][0],
                 f"final {got['final_loss']} against {first['losses'][0]}")
        else:
            need(got["start"] == 0 and got["final_loss"] < losses[0],
                 f"start {got['start']}, losses {losses}")


def examples_path(dev) -> tuple[dict, dict]:
    """Phase examples: each example of `repro_torch.examples` called
    in process as `main(argv + ["--device", "cuda"])` (`dev`) at the sizes its
    JAX counterpart documents (EXAMPLE_RUNS), each resume on the
    checkpoint directory of the run before it.  Before each run the three
    precision settings go back to PyTorch's defaults; after it they must
    be the reference's, set by the example itself (`gp.resolve_device`).
    Held: each run's totals against its contract (`example_contract`),
    the run's tensors on the card (its peak memory), and, by the launch
    counters of the in-process runs, each of the six kernels of the TPU
    table launched at least once across the phase (serve_cluster's run in
    its worker processes, which this process cannot count).  One line a
    run (seconds, totals, launches, the card), then the phase's line.
    Returns (launches, line)."""
    import importlib
    import tempfile
    from repro_torch.kernels import acq
    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    totals = {k: 0 for k in read_counts()}
    runs, by_example = {}, {}
    misses = acq.MISSES
    with tempfile.TemporaryDirectory() as root:
        dirs = {k: os.path.join(root, k) for k in "abcde"}
        for name, run, options in EXAMPLE_RUNS:
            argv = [o.format(**dirs) for o in options] + ["--device",
                                                           dev.type]
            module = importlib.import_module(f"repro_torch.examples.{name}")
            for key, value in TORCH_DEFAULT_PRECISION.items():
                attr = (torch.backends.cudnn if key.startswith("cudnn")
                        else torch.backends.cuda.matmul)
                setattr(attr, key.split(".", 1)[1], value)
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            got = module.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated() - base
            if precision_flags() != REFERENCE_PRECISION:
                raise AssertionError(f"examples: {name} {run} left the "
                                     f"precision at {precision_flags()}")
            if name != "serve_cluster" and peak <= 0:
                raise AssertionError(f"examples: {name} {run} allocated "
                                     f"nothing on the card")
            example_contract(name, run, got, runs, dev.type)
            runs[(name, run)] = got
            for k, v in counts.items():
                totals[k] += v
            mine = by_example.setdefault(name, {k: 0 for k in counts})
            for k, v in counts.items():
                mine[k] += v
            failover = {} if name != "serve_cluster" else {
                "revive_s": got["kill"]["revive_s"],
                "revive_start": got["worker_starts"][-1],
                "client_retries": got["client_retries"]}
            emit({"phase": "examples", "example": name, "run": run,
                  "argv": argv, "seconds": seconds,
                  "peak_memory_bytes": peak, "launches": counts,
                  **failover, "totals": got, "nvidia_smi": smi})
    # The six TPU kernels: the general solve is trsv.cu's too.
    six = {"matern": totals["matern"], "chol": totals["chol"],
           "trsv": totals["trsv"] + totals["trsv_general"],
           "acq": totals["acq"], "acq_mixed": totals["acq_mixed"],
           "mixed": totals["mixed"]}
    missing = sorted(k for k, v in six.items() if not v)
    if missing:
        raise AssertionError(f"examples: no launch of {missing} across the "
                             f"phase: {by_example}")
    line = {"phase": "examples", "part": "summary", "launches": totals,
            "launches_by_example": by_example,
            "fused_ei_table_misses": acq.MISSES - misses,
            "precision": precision_flags(), "nvidia_smi": smi,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    return totals, line


SOURCES = {
    "matern52_gram": ("matern", "src/repro_torch/csrc/matern.cu",
                      "src/repro/kernels/matern.py:29"),
    "cholesky": ("chol", "src/repro_torch/csrc/chol.cu",
                 "src/repro/kernels/chol.py:65"),
    "trsv": ("trsv", "src/repro_torch/csrc/trsv.cu",
             "src/repro/kernels/trsv.py:60"),
    "trsv_general": ("trsv_general", "src/repro_torch/csrc/trsv.cu",
                     "src/repro/kernels/trsv.py:60"),
    "fused_ei_grad": ("acq", "src/repro_torch/csrc/acq.cu",
                      "src/repro/kernels/acq.py:141"),
    "mixed_gram": ("mixed", "src/repro_torch/csrc/mixed.cu",
                   "src/repro/kernels/mixed.py:33"),
    "fused_ei_grad_mixed": ("acq_mixed", "src/repro_torch/csrc/acq.cu",
                            "src/repro/kernels/acq.py:151"),
}


def digests_only(dev, src: str) -> int:
    """`chip_smoke.py --digests [SRC]`: build the kernels of the
    `repro_torch` under SRC (this checkout's `src` by default; an unpacked
    parent's for an A/B) and print the digests of `gram_digests`,
    `ei_digests` and `inverse_digests`, and the fused EI's times at the
    engine's shapes (`ei_engine_times`), which use only entry points older
    trees have."""
    import repro_torch
    from repro_torch.kernels import _build
    _build.build()
    emit({"phase": "digests", "src": src, "package": repro_torch.__file__,
          "nvidia_smi": nvidia_smi_line(), "gram": gram_digests(dev),
          "ei": ei_digests(dev), "inverse": inverse_digests(dev),
          "ei_engine": ei_engine_times(dev)})
    return 0


def child_bytecode_cache() -> str:
    """Let the Python processes this run starts (shard workers, rank and
    launcher processes) share compiled bytecode under `build/pycache` of
    the checkout, and write there what this process imports from now on.
    A host that sets PYTHONDONTWRITEBYTECODE and ships no bytecode makes
    every such process compile torch anew: 8.4-12.1 s a process on the
    H100 hosts measured, most of a shard worker's start.  The first child
    to import a module writes its bytecode; the later ones read it."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = path
    sys.dont_write_bytecode, sys.pycache_prefix = False, path
    return path


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    pycache = child_bytecode_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, "src")
    record = None
    if argv[:1] == ["--digests"]:
        src = os.path.abspath(argv[1]) if len(argv) > 1 else src
    elif argv[:1] == ["--acq-keys"] and len(argv) == 2:
        record, argv = os.path.abspath(argv[1]), []
    elif argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import _build

    from repro_torch.core.gp import resolve_device
    dev = resolve_device("cuda")    # fp32 like the reference
    if argv:
        return digests_only(dev, src)
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "pycache_prefix": pycache,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "precision": precision_flags()})

    seconds = _build.build()
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "Used" in ln]
             for k, v in _build.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})
    emit(acq_plan_checks(dev, record is not None))
    recorder = AcqPlanRecorder(record)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = check_kernels(dev, gen)
    emit(ei_shapes(dev))
    emit({"phase": "kernels", "kernel": "fused_ei_grad_mixed accuracy spread",
          **ei_accuracy_spread(dev)})
    beyond = tri_inverse_beyond_limit(dev)
    emit(beyond)
    trsv_row = next(row for row in rows if row["name"] == "trsv_general")
    if beyond["digest"] != trsv_row["digest"]["B=I, n=6144"]:
        raise AssertionError(f"trsv B=I n=6144 digest {beyond['digest']} through "
                             f"trsv.tri_inverse, {trsv_row['digest']} through trsv_digests")
    trsv_row["general"]["B=I, n=6144"] = {k: beyond[k] for k in GENERAL_KEYS
                                          if k in beyond}
    digests = gram_digests(dev)
    line, gram_batched = gram_checks(dev, digests)
    emit(line)
    ei_bits = ei_digests(dev)
    emit({"phase": "kernels", "kernel": "fused_ei_grad digests", **ei_bits})
    if not (ei_bits["float x3 lanes equal"] and ei_bits["mixed x3 lanes equal"]):
        raise AssertionError(f"fused EI: a lane of the batch of 3 differs from "
                             f"its single launch: {ei_bits}")
    for row in rows:
        if row["name"] in gram_batched:
            row["batched"] = gram_batched[row["name"]]
    # Every path runs through the recorder: the fused-EI plan keys it reads
    # and its launches that missed the plan table (which must be none).
    paths = {"main": recorder.run("main", main_path, dev),
            "mixed": recorder.run("mixed", mixed_path, dev)}
    launches_by_path = {name: p[0] for name, p in paths.items()}
    launches_by_path["append"] = recorder.run("append", append_path, dev)
    engines = {name: recorder.run(name, engine_path, dev, mixed)
               for name, mixed in (("engine", False), ("engine_mixed", True))}
    for name, (counts, *_) in engines.items():
        launches_by_path[name] = counts
    emit({"phase": "engine", "part": "batched forms unequal lanes",
          **batched_forms(dev)})
    # The pool phases: the rounds here, the profile with the others, the
    # fantasies, checkpoint and scheduler last.
    pools, pool_lines = {}, {}
    for name, mixed in (("pool", False), ("pool_mixed", True)):
        engine_line = engines["engine_mixed" if mixed else "engine"][-1]
        launches_by_path[name], pools[name], pool_lines[name] = recorder.run(
            name, pool_path, dev, mixed, engine_line)
    # The mesh phase: pools on logical devices of the one card, from the
    # engines' states, before anything else serves those engines.
    launches_by_path["mesh"], mesh_line = recorder.run("mesh", mesh_path,
                                                       dev, engines)
    for row in rows:
        kind = {"fused_ei_grad": "engine",
                "fused_ei_grad_mixed": "engine_mixed"}.get(row["name"])
        if kind:
            row["restart_shard"] = mesh_line[kind]["restart_shard"]
    stacked = engines["engine_mixed"][-1]["stacked_masks"]
    for row in rows:
        keys = {"mixed_gram": ("column", "masked"),
                "fused_ei_grad_mixed": ("fused_ei",)}.get(row["name"], ())
        if keys:
            row["stacked_masks"] = {k: {f: stacked[k][f] for f in (
                "max_abs_err", "lanes_equal", "shared_rows_equal", "ms",
                "plain_ms", "bound_ms")} for k in keys}
    for name, (_, driver, state, hist) in paths.items():
        profile_steps(name, driver, state, hist)
    for name, (_, eng, studies, units, _) in engines.items():
        profile_engine(name, eng, studies, units)
    for pair in pools.values():
        profile_pool(pair)
    cholesky_launches(dev)
    tri_inverse_launches(dev)
    for tag, line in trsv_launches(dev).items():
        trsv_row["general"][tag]["device_ms"] = line["device_ms"]
    trsv_row["device_ms"] = trsv_row["general"][GENERAL_ROW_SHAPE]["device_ms"]
    trsv_row["host_gap_ms"] = trsv_row["ms"] - trsv_row["device_ms"]
    gram_device = gram_launches(dev)
    ei_device = ei_launches(dev)
    emit({"phase": "profile", "kernel": "fused_ei_grad at r=48, n=1024",
          **ei_engine_times(dev)})
    emit({"phase": "profile", "kernel": "fused_ei_grad plans",
          "nvidia_smi": smi, **acq_plan_times(dev)})
    # The neural phases run after every profile check and before the
    # fantasy phases, each profiling its tier first (`profile_neural`);
    # they leave one slot of each engine escalated, which the fantasy
    # phases keep unflagged.
    for name, (_, eng, studies, _, _) in engines.items():
        neural = "neural_mixed" if eng.mixed else "neural"
        launches_by_path[neural], _ = recorder.run(
            neural, neural_path, dev, eng, studies, eng.mixed)
    # The fantasy phases run last: with them before the profile checks,
    # torch.profiler recorded no device activity in tri_inverse_launches
    # in two runs (PERF.md, PR 21).
    for name, (_, eng, studies, _, _) in engines.items():
        fantasy = "fantasy_mixed" if eng.mixed else "fantasy"
        profile_fantasy(fantasy, eng, FANTASY_SLOTS[0])
        launches_by_path[fantasy], _ = recorder.run(
            fantasy, fantasy_path, dev, eng, studies, eng.mixed)
    for name, pair in pools.items():
        line = {"phase": name, "part": "protocol",
                **recorder.run(f"{name} protocol", pool_protocol, pair)}
        if name == "pool":
            line["scheduler"] = recorder.run("scheduler", scheduler_path, dev)
        emit(line)
    # The gateway last: it serves q-asks, and it starts from the studies
    # the float pool's protocol left.
    launches_by_path["gateway"], gateway_line = recorder.run(
        "gateway", gateway_path, dev, pools["pool"], pool_lines["pool"])
    # The federation after it, over the same studies: two shards of the
    # gateway phase's gateway in one process, its single-pool twin, and
    # two shard worker processes on the same card.
    (launches_by_path["federation"], launches_by_path["federation_workers"],
     (worker_misses, worker_launches)) = recorder.run(
        "federation", federation_path, dev, pools["pool"], gateway_line)
    recorder.note("federation_workers", worker_misses, worker_launches)
    # The language-model side last: the trainer, then an NN-HPO run that
    # tunes it through run_bo.
    launches_by_path["lm"], _ = recorder.run("lm", lm_path, dev)
    launches_by_path["nn_hpo"], _ = recorder.run("nn_hpo", nn_hpo_path, dev)
    # The routed and the latent-attention blocks at full width, before the
    # step profile (a profiling session slows later host launches).
    launches_by_path["lm_moe"], _ = recorder.run(
        "lm_moe", wide_lm_path, dev, "lm_moe", "granite-moe-3b-a800m")
    launches_by_path["lm_mla"], _ = recorder.run(
        "lm_mla", wide_lm_path, dev, "lm_mla", "minicpm3-4b")
    # The recurrent and encoder families: the chunked scans against their
    # recurrences at full width, then hubert, zamba2 and xlstm trained.
    emit(recurrence_check(dev))
    for phase, arch, layers, seq in RECURRENT_PHASES:
        launches_by_path[phase], _ = recorder.run(
            phase, lambda *a: wide_lm_path(*a, cpu_rows=RECURRENT_CPU_ROWS),
            dev, phase, arch, layers, seq)
    # The serving path at full width, before the profiles.
    launches_by_path["lm_serve"], _, served = recorder.run(
        "lm_serve", lm_serve_path, dev)
    # The launch layer: the sharded step on two ranks of the one card.
    launches_by_path["launch"], _ = recorder.run("launch", launch_path, dev)
    # The examples as a user starts them, before the profiles.
    launches_by_path["examples"], _ = recorder.run("examples", examples_path,
                                                   dev)
    emit({"phase": "profile", "part": "lm step", **lm_step_profile(dev)})
    emit({"phase": "profile", "part": "lm_moe step",
          **lm_step_profile(dev, wide_config("granite-moe-3b-a800m"))})
    _, arch, layers, seq = RECURRENT_PHASES[1]
    emit({"phase": "profile", "part": "lm_mamba step",
          **lm_step_profile(dev, wide_config(arch, layers), seq)})
    for part in SERVE_PROFILED:
        emit({"phase": "profile", **serve_step_profile(part,
                                                       *served.pop(part))})
    # Device time beside the event time from the kernels phase (the gram's
    # from its 1024^2 call): the difference is the wrapper's host work
    # while the card idles.
    device = {**{k: v["device_ms"] for k, v in ei_device.items()},
              **{k: gram_device[f"{k} gram"]["device_ms"]
                 for k in ("matern52_gram", "mixed_gram")}}
    for row in rows:
        if row["name"] in device:
            row["device_ms"] = device[row["name"]]
            row["host_gap_ms"] = row["ms"] - row["device_ms"]

    kernels = []
    for row in rows:
        mod, source, replaces = SOURCES[row["name"]]
        by_path = {name: counts[mod] for name, counts in launches_by_path.items()}
        if mod in ("acq", "acq_mixed"):
            row["table_misses_by_path"] = recorder.misses()
        kernels.append(dict(name=row["name"], route="cuda", source=source,
                            replaces=replaces, launches=sum(by_path.values()),
                            launches_by_path=by_path,
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"],
                            library_ms=row["library_ms"], shape=row["shape"],
                            **{k: row[k] for k in ("general_ms", "batched", "general",
                                                   "device_ms", "host_gap_ms",
                                                   "stacked_masks",
                                                   "restart_shard",
                                                   "table_misses_by_path")
                               if k in row}))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
